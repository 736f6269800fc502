"""Tests that need an NVIDIA GPU (marker ``gpu``; they skip elsewhere).

Run on a GPU host with ``TPUCLIP_TEST_GPU=1 python -m pytest tests/ -m gpu``
(chip_smoke.py does, as its first phase). They check what only the card can
show: the Triton int8 scan as compiled for it, the platform policy the GPU
gets, and the default index path end to end.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("q_count", [1, 16, 64])
def test_triton_int8_scan_compiled_matches_xla(q_count):
    """The compiled Triton kernel is bit-equal to the XLA scan (int32
    accumulation is exact)."""
    from tpuclip.ops.topk_int8 import _int8_scores_xla, int8_scores_triton

    rng = np.random.default_rng(q_count)
    n, d = 1 << 16, 1152
    m = jnp.asarray(rng.integers(-127, 128, (n, d), dtype=np.int8))
    scales = jnp.asarray(rng.random(n, dtype=np.float32))
    q = jnp.asarray(rng.integers(-127, 128, (q_count, d), dtype=np.int8))
    nv = jnp.asarray(n - 5, jnp.int32)
    got = jax.jit(int8_scores_triton)(q, m, scales, nv)
    want = jax.jit(_int8_scores_xla)(q, m, scales, nv)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_gpu_platform_policy():
    from tpuclip import platform

    assert platform.platform_of() == "gpu"
    assert platform.compute_dtype() == jnp.bfloat16
    assert platform.default_precision() == "int8"
    assert platform.int8_scan_route() == "triton"
    assert platform.free_bytes() > 0


def test_f32_scan_is_not_tf32():
    """topk_xla over an f32 matrix scores at full f32 precision on the GPU
    (TF32 would leave ~1e-3 errors on unit vectors)."""
    from tpuclip.ops.topk import topk_xla

    rng = np.random.default_rng(1)
    m = rng.standard_normal((4096, 1152)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = m[:3] + 0.01 * rng.standard_normal((3, 1152)).astype(np.float32)
    s, i = topk_xla(jnp.asarray(q), jnp.asarray(m.T), 10)
    exact = q.astype(np.float64) @ m.T.astype(np.float64)
    got = np.take_along_axis(exact, np.asarray(i), axis=1)
    np.testing.assert_allclose(np.asarray(s), got, rtol=0, atol=1e-5)


def test_device_index_default_path_on_gpu(tmp_path):
    """DeviceIndex's GPU defaults (int8 scan + fused device rescore over
    bf16 rows) return the top-k of the exact dots of the bf16-rounded
    operands, rows and scores, within f32 summation error."""
    import sqlite3

    from chip_smoke import SCORE_TOL_SUM, bf16_reference, check_topk, round_to_bf16
    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    rng = np.random.default_rng(2)
    n, d, k = 5000, 1152, 20
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    store = MetadataStore(str(tmp_path / "g.db"), embedding_dim=d)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    store.commit_with_retry(
        conn.cursor(), conn,
        [(f"/d/img_{i:08d}.jpg", float(i), f"h{i}", vecs[i]) for i in range(n)],
        save_full_embeddings=True,
    )
    conn.close()
    idx = DeviceIndex(store)
    q = vecs[:4] + 0.05 * rng.standard_normal((4, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    res = idx.search_batch(q, k)
    assert idx.precision == "int8" and idx._rows_device is not None
    assert idx.can_fuse_text_search(k, None)
    _, stored = idx.cache.load(refresh=False)  # the values the device holds
    ref = bf16_reference(q, round_to_bf16(stored))
    got = check_topk(
        [[int(p.rsplit("_", 1)[1].split(".")[0]) for p, _ in rows] for rows in res],
        [[sc for _, sc in rows] for rows in res],
        ref, k, 2 * SCORE_TOL_SUM, SCORE_TOL_SUM,
    )
    assert got["ok"], got

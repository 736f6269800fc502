"""Mesh-sharded IVF (parallel/sharded_ivf.py) on the 8-device CPU mesh.

Contracts under test:
- probe-everything (nprobe = K) must EQUAL the exact scan, scores and
  indices, under the (score desc, idx asc) tie contract — including exact
  duplicate rows;
- returned scores are exact full-precision dots for every returned row;
- recall at modest nprobe on clustered data;
- cluster/overflow axes that do not divide the mesh size still work
  (padding slots must never surface).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpuclip.index.ivf import build_ivf
from tpuclip.parallel import make_mesh
from tpuclip.parallel.sharded_ivf import shard_ivf, sharded_ivf_search


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
    return make_mesh(model_parallelism=1)


def _clustered(n, d, modes, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((modes, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, modes, n)] + 0.07 * rng.standard_normal(
        (n, d)
    ).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), centers


def _oracle(x, q, k):
    """Exact (score desc, idx asc) top-k on host."""
    exact = q @ x.T
    order = np.stack(
        [np.lexsort((np.arange(len(x)), -exact[r]))[:k] for r in range(len(q))]
    )
    scores = np.take_along_axis(exact, order, axis=1)
    return scores, order


def test_probe_all_equals_exact_scan_with_duplicates(mesh8):
    n, d, k = 1536, 64, 10
    x, centers = _clustered(n, d, modes=12, seed=1)
    # plant exact duplicates (byte copies) to stress the tie contract
    x[100:113] = x[99]
    x[700:705] = x[699]
    rng = np.random.default_rng(2)
    q = centers[rng.integers(0, 12, 5)] + 0.02 * rng.standard_normal((5, d)).astype(
        np.float32
    )
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # make one query hit the duplicate group dead-on
    q[0] = x[99]

    index = build_ivf(x, k_clusters=24, nprobe=4, seed=0)
    sharded = shard_ivf(index, jnp.asarray(x), mesh8)
    s, i = sharded_ivf_search(sharded, q, k, nprobe=24)  # probe EVERYTHING
    s, i = np.asarray(s), np.asarray(i)

    ref_s, ref_i = _oracle(x, q, k)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-6)


def test_returned_scores_are_exact_dots(mesh8):
    n, d, k = 1024, 48, 8
    x, centers = _clustered(n, d, modes=10, seed=3)
    rng = np.random.default_rng(4)
    q = centers[rng.integers(0, 10, 4)] + 0.05 * rng.standard_normal((4, d)).astype(
        np.float32
    )
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    index = build_ivf(x, k_clusters=20, nprobe=4, seed=0)
    sharded = shard_ivf(index, jnp.asarray(x), mesh8)
    s, i = sharded_ivf_search(sharded, q, k)
    s, i = np.asarray(s), np.asarray(i)
    exact = q @ x.T
    for r in range(len(q)):
        np.testing.assert_allclose(
            s[r], exact[r][i[r]], rtol=2e-5, atol=2e-6
        )


def test_recall_on_clustered_data(mesh8):
    n, d, k = 4096, 64, 20
    x, centers = _clustered(n, d, modes=32, seed=5)
    rng = np.random.default_rng(6)
    q = centers[rng.integers(0, 32, 8)] + 0.05 * rng.standard_normal((8, d)).astype(
        np.float32
    )
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    index = build_ivf(x, k_clusters=64, nprobe=16, seed=0)
    sharded = shard_ivf(index, jnp.asarray(x), mesh8)
    s, i = sharded_ivf_search(sharded, q, k)
    i = np.asarray(i)
    _, ref_i = _oracle(x, q, k)
    recall = np.mean(
        [len(set(i[r]) & set(ref_i[r])) / k for r in range(len(q))]
    )
    assert recall >= 0.9, f"recall {recall}"


def test_uneven_cluster_and_overflow_axes(mesh8):
    """K=10 clusters and a small overflow pad don't divide 8 devices; the
    padding must stay invisible (no -1 row ids, no zero-vector hits)."""
    n, d, k = 520, 32, 6
    x, centers = _clustered(n, d, modes=6, seed=7)
    rng = np.random.default_rng(8)
    q = centers[rng.integers(0, 6, 3)].astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    index = build_ivf(x, k_clusters=10, nprobe=10, capacity_factor=1.05, seed=0)
    sharded = shard_ivf(index, jnp.asarray(x), mesh8)
    s, i = sharded_ivf_search(sharded, q, k, nprobe=10)
    s, i = np.asarray(s), np.asarray(i)
    assert (i >= 0).all() and (i < n).all()
    ref_s, ref_i = _oracle(x, q, k)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-6)


def test_boundary_shard_cluster_alignment(mesh8):
    """Regression (review r3): with K=11 clusters padded to 16 over 8
    devices, the boundary shard's centroid slice misaligned against its
    bucket slice (centroids were not padded alongside), so cluster 10 was
    unsearchable at any nprobe below full coverage — per-query recall 0.0
    for queries in that cluster. nprobe=8 gives p_local=1 < kk_local=2, so
    probe selection actually depends on the centroid/bucket mapping here
    (unlike the probe-everything tests)."""
    n, d, k = 2200, 48, 8
    modes = 11
    x, centers = _clustered(n, d, modes=modes, seed=13)
    index = build_ivf(x, k_clusters=modes, nprobe=8, seed=0)
    sharded = shard_ivf(index, jnp.asarray(x), mesh8)
    # one query per k-means centroid: every cluster must be reachable
    q = np.array(index.centroids, np.float32, copy=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _, i = sharded_ivf_search(sharded, q, k, nprobe=8)
    i = np.asarray(i)
    _, ref_i = _oracle(x, q, k)
    for r in range(modes):
        recall = len(set(i[r]) & set(ref_i[r])) / k
        assert recall >= 0.9, f"cluster {r}: recall {recall}"


def test_device_index_mesh_ivf_mode(mesh8, tmp_path, monkeypatch):
    """DeviceIndex(mesh=...) with TPUCLIP_SEARCH_MODE=ivf serves through the
    sharded IVF: high recall, exact scores, search == search_batch."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "ivf")
    n, d, k = 2048, 64, 10
    vecs, centers = _clustered(n, d, modes=16, seed=11)
    store = MetadataStore(str(tmp_path / "sivf.db"), embedding_dim=d)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    store.commit_with_retry(
        conn.cursor(), conn,
        [(f"/d/{i}.jpg", float(i), "h", vecs[i]) for i in range(n)],
        save_full_embeddings=True,
    )
    conn.close()

    idx = DeviceIndex(store, precision="int8", mesh=mesh8, matrix_dtype=jnp.float32)
    idx.refresh()
    assert idx._ivf_sharded is not None, "mesh IVF should have been built"
    rng = np.random.default_rng(12)
    qs = centers[rng.integers(0, 16, 4)] + 0.04 * rng.standard_normal(
        (4, d)
    ).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    exact = vecs @ qs.T
    batched = idx.search_batch(qs, k)
    for q in range(4):
        single = idx.search(qs[q], k)
        assert [p for p, _ in single] == [p for p, _ in batched[q]]
        true = set(np.argsort(-exact[:, q])[:k].tolist())
        got = {int(p.rsplit("/", 1)[1].split(".")[0]) for p, _ in single}
        assert len(true & got) / k >= 0.9
        for p, s in single:
            row = int(p.rsplit("/", 1)[1].split(".")[0])
            np.testing.assert_allclose(s, exact[row, q], rtol=2e-5, atol=2e-6)


def test_bf16_rows_match_flat_rescore_contract(mesh8):
    """With bf16 embedded rows the rescore must reproduce the flat fused
    path's scores (bit-rounded query) for the rows both return."""
    from tpuclip.ops.topk_int8 import pad_rows, quantize_rows, topk_int8_rerank_fused

    n, d, k = 768, 64, 8
    x, centers = _clustered(n, d, modes=8, seed=9)
    rng = np.random.default_rng(10)
    q = centers[rng.integers(0, 8, 3)] + 0.03 * rng.standard_normal((3, d)).astype(
        np.float32
    )
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    index = build_ivf(x, k_clusters=12, nprobe=12, seed=0)
    rows_bf16 = jnp.asarray(x, jnp.bfloat16)
    sharded = shard_ivf(index, rows_bf16, mesh8)
    s_ivf, i_ivf = sharded_ivf_search(sharded, q, k, nprobe=12)

    padded, nv = pad_rows(x, tile_n=256)
    mq, scales = quantize_rows(padded)
    s_flat, i_flat = topk_int8_rerank_fused(
        jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales), rows_bf16, k,
        n_valid=jnp.asarray(nv, jnp.int32),
    )
    np.testing.assert_array_equal(np.asarray(i_ivf), np.asarray(i_flat))
    np.testing.assert_allclose(
        np.asarray(s_ivf), np.asarray(s_flat), rtol=1e-6, atol=0
    )

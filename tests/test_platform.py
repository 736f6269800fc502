"""tpuclip.platform: the one module that decides by device — policy per
platform, refusal of unknown devices, and capacity gates sized from the
device's own memory statistics (stub devices stand in for the GPU)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpuclip import platform


class StubDevice:
    def __init__(self, platform="gpu", kind="NVIDIA H100 80GB HBM3", stats=None):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


CPU = StubDevice("cpu", "cpu")
GPU = StubDevice(stats={"bytes_limit": 64 * 10**9, "bytes_in_use": 0})


@pytest.mark.parametrize(
    "device,decision,expected",
    [
        (CPU, platform.compute_dtype, jnp.float32),
        (GPU, platform.compute_dtype, jnp.bfloat16),
        (CPU, platform.matrix_dtype, jnp.float32),
        (GPU, platform.matrix_dtype, jnp.bfloat16),
        (CPU, platform.default_precision, "bf16"),
        (GPU, platform.default_precision, "int8"),
        (CPU, platform.device_rerank_default, False),
        (GPU, platform.device_rerank_default, True),
        (CPU, platform.int8_scan_route, "xla"),
        (GPU, platform.int8_scan_route, "triton"),
    ],
    ids=lambda x: getattr(x, "platform", getattr(x, "__name__", str(x))),
)
def test_policy_per_platform(device, decision, expected):
    assert decision(device) == expected


@pytest.mark.parametrize(
    "device",
    [StubDevice("gpu", "Tesla T4"), StubDevice("neuron", "Trainium")],
    ids=["unknown-gpu-kind", "unknown-platform"],
)
def test_unknown_device_is_an_error(device):
    with pytest.raises(RuntimeError):
        platform.platform_of(device)


@pytest.mark.parametrize(
    "stats,nbytes,fits",
    [
        (None, 10**15, True),  # no statistics (the CPU): nothing is gated
        ({"bytes_limit": 80 * 10**9, "bytes_in_use": 0}, 70 * 10**9, True),
        ({"bytes_limit": 80 * 10**9, "bytes_in_use": 0}, 71 * 10**9, False),
        ({"bytes_limit": 80 * 10**9, "bytes_in_use": 40 * 10**9}, 31 * 10**9, False),
    ],
    ids=["no-stats", "under-margin", "over-margin", "in-use-counts"],
)
def test_fits_keeps_the_workspace_margin(stats, nbytes, fits):
    """free = limit - in_use - limit/8 (WORKSPACE_FRACTION)."""
    assert platform.fits(nbytes, StubDevice(stats=stats)) is fits


def test_free_bytes_reads_memory_stats():
    assert platform.free_bytes(GPU) == 64 * 10**9 - 8 * 10**9
    assert platform.free_bytes(CPU) is None


def _store(tmp_path, d=64):
    from tpuclip.index.store import MetadataStore

    store = MetadataStore(str(tmp_path / "g.db"), embedding_dim=d)
    store.init_schema(verbose=False)
    return store


@pytest.mark.parametrize(
    "limit_gb,flat_fits,rerank",
    [(64, True, True), (2, True, False), (1, False, False)],
    ids=["roomy", "flat-only", "neither"],
)
def test_device_index_gates_follow_device_memory(tmp_path, monkeypatch, limit_gb,
                                                 flat_fits, rerank):
    """A 1M x 1152 index: the int8 flat matrix is 1.15 GB, int8 plus the
    bf16 rescore copy 3.5 GB; the gates compare them with the device's
    free memory (limit minus the 1/8 margin)."""
    from tpuclip.index.search import DeviceIndex

    monkeypatch.delenv("TPUCLIP_INDEX_HBM_GB", raising=False)
    monkeypatch.delenv("TPUCLIP_DEVICE_RERANK_MAX_GB", raising=False)
    monkeypatch.delenv("TPUCLIP_DEVICE_RERANK", raising=False)
    dev = StubDevice(stats={"bytes_limit": limit_gb * 10**9, "bytes_in_use": 0})
    idx = DeviceIndex(_store(tmp_path, d=1152), device=dev)
    assert idx.precision == "int8" and idx.matrix_dtype == jnp.bfloat16
    assert idx._flat_matrix_fits(1_000_000) is flat_fits
    assert idx._want_device_rerank(1_000_000) is rerank


def test_score_rows_per_pass_from_free_memory(monkeypatch):
    import tpuclip.ops.topk_int8 as ti

    monkeypatch.setattr(ti.platform, "free_bytes", lambda device=None: None)
    assert ti.score_rows_per_pass(10**6) >= 1 << 20
    monkeypatch.setattr(ti.platform, "free_bytes", lambda device=None: 10 * 10**9)
    assert ti.score_rows_per_pass(10**7) == 10 * 10**9 // (10**7 * ti._SELECT_BYTES_PER_SCORE)
    monkeypatch.setattr(ti.platform, "free_bytes", lambda device=None: 1)
    assert ti.score_rows_per_pass(10**7) == 1


def test_fused_search_scores_in_passes_when_memory_is_short(monkeypatch):
    """The capacity gate splits the query block into passes; results are
    the same as one pass."""
    import tpuclip.ops.topk_int8 as ti

    rng = np.random.default_rng(0)
    rows = rng.standard_normal((900, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    padded, nv = ti.pad_rows(rows)
    mq, scales = ti.quantize_rows(padded)
    q = jnp.asarray(rng.standard_normal((5, 64)).astype(np.float32))
    args = (q, jnp.asarray(mq), jnp.asarray(scales), jnp.asarray(rows), 7)
    s1, i1 = ti.topk_int8_rerank_fused(*args, n_valid=jnp.asarray(nv, jnp.int32))
    monkeypatch.setattr(ti, "score_rows_per_pass", lambda n: 2)
    ti.topk_int8_rerank_fused.clear_cache()
    try:
        s2, i2 = ti.topk_int8_rerank_fused(*args, n_valid=jnp.asarray(nv, jnp.int32))
    finally:
        ti.topk_int8_rerank_fused.clear_cache()
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))

"""Test environment: force CPU with a virtual 8-device mesh.

Multi-device logic (sharded search, DP inference, training step) runs on
``xla_force_host_platform_device_count=8`` CPU devices — the idiomatic JAX
substitute for a fake backend (SURVEY.md §4.5). Must be set before jax import.

Tests that need an NVIDIA GPU carry the ``gpu`` marker. They skip unless a
GPU is present, decided in the ``_gpu_marker`` fixture (never at import: the
xdist workers must all collect the same tests). On a GPU host run them with
``TPUCLIP_TEST_GPU=1 python -m pytest tests/ -m gpu``; that variable leaves
the platform to JAX instead of pinning the CPU.
"""

import os

_PIN_CPU = os.environ.get("TPUCLIP_TEST_GPU") != "1"

if _PIN_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("TPUCLIP_QUIET", "1")
os.environ.setdefault("TPUCLIP_INIT", "random")

import jax  # noqa: E402

if _PIN_CPU:
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests where the first device is not a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py on the card)")


@pytest.fixture()
def tmp_home(tmp_path, monkeypatch):
    """Point all default output paths at a temp dir."""
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path))
    return tmp_path


def assert_topk_oracle(got_idx, want_idx, got_scores=None, want_scores=None):
    """Top-k oracle assertion: exact index equality and tight scores (the
    suite's f32 matmuls are IEEE on the CPU)."""
    import numpy as np

    np.testing.assert_array_equal(np.asarray(got_idx), np.asarray(want_idx))
    if got_scores is not None:
        np.testing.assert_allclose(
            np.asarray(got_scores), np.asarray(want_scores), rtol=1e-5, atol=1e-5
        )

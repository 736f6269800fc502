"""Compile-cache placement: $JAX_COMPILATION_CACHE_DIR when set, else the
fixed <checkout>/.jax_cache — never a per-run TPUCLIP_HOME, whose path would
change the cache key every run."""

from pathlib import Path

import pytest

from tpuclip.utils import compile_cache

CHECKOUT = Path(compile_cache.__file__).resolve().parents[2]


@pytest.mark.parametrize(
    "env,home,expected",
    [
        ("/srv/jax-cache", None, "/srv/jax-cache"),
        (None, None, str(CHECKOUT / ".jax_cache")),
        (None, "HOME_TMP", str(CHECKOUT / ".jax_cache")),
    ],
    ids=["env-set", "env-unset", "env-unset-tpuclip-home"],
)
def test_cache_dir(monkeypatch, tmp_path, env, home, expected):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    if home is None:
        monkeypatch.delenv("TPUCLIP_HOME", raising=False)
    else:
        monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    assert compile_cache.cache_dir() == expected


def test_checkout_holds_the_package():
    assert (CHECKOUT / "tpuclip" / "utils" / "compile_cache.py").exists()

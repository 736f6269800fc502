"""Shortlist methods for the fused int8 path (ops/topk_int8.py).

The scan emits raw f32 scores and the shortlist is built from them:
"exact" (lax.top_k, the default), "approx" (approx_max_k) or "verified"
(approx_max_k + count-proof + host fallback). On CPU (and on the GPU)
approx_max_k reduces to exact top_k, so every method must agree exactly;
the verify/fallback logic is exercised directly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpuclip.ops import topk_int8 as ti


def _index(n=1500, d=96, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rowsd = jnp.asarray(rows, dtype)
    n_pad = -(-n // 512) * 512
    mt, sc = ti.derive_int8_matrix_device(rowsd, n_pad)
    return rows, rowsd, mt, sc, jnp.asarray(n, jnp.int32)


METHODS = ["verified", "approx", "exact"]


@pytest.mark.parametrize("method", METHODS)
def test_methods_match_extract(method):
    rows, rowsd, mt, sc, nv = _index()
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.standard_normal((1, 96)).astype(np.float32))
    s0, i0 = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 12, n_valid=nv
    )
    out = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 12, n_valid=nv,
        shortlist_method=method,
    )
    if method == "verified":
        s1, i1, ok = out
        assert bool(np.asarray(ok))  # CPU approx_max_k is exact
    else:
        s1, i1 = out
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1), rtol=0, atol=0)


@pytest.mark.parametrize("method", METHODS)
def test_batch_agreement(method):
    rows, rowsd, mt, sc, nv = _index(n=2100, d=64, seed=3)
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.standard_normal((5, 64)).astype(np.float32))
    s0, i0 = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 7, n_valid=nv
    )
    out = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 7, n_valid=nv,
        shortlist_method=method,
    )
    s1, i1 = out[:2]
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


@pytest.mark.parametrize("method", METHODS)
def test_tie_contract_lowest_indices(method):
    """Exact duplicates beyond the shortlist depth: (score desc, idx asc)
    demands the LOWEST row indices; verified/exact must honor it or fall
    back (on CPU the shortlist is exact, so no fallback fires)."""
    n, d, dup = 3000, 64, 300
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    # Plant the duplicates AFTER the global normalize so all 301 rows are
    # byte-identical: copying the pre-normalized vector leaves row 11 one
    # extra division away from the dups (~1 ulp), which is enough to break
    # the tie on a backend's scale fold — and is not the contract
    # under test.
    dup_idx = np.arange(17, 17 + dup * 9, 9)
    winner = rows[11]
    rows[dup_idx] = winner
    rowsd = jnp.asarray(rows)
    n_pad = -(-n // 512) * 512
    mt, sc = ti.derive_int8_matrix_device(rowsd, n_pad)
    q = jnp.asarray(winner[None, :], jnp.float32)
    out = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 20, n_valid=jnp.asarray(n, jnp.int32), shortlist_method=method,
    )
    got = np.sort(np.asarray(out[1])[0])
    expect = np.sort(np.sort(np.concatenate([[11], dup_idx]))[:20])
    np.testing.assert_array_equal(got, expect)


def test_verified_shortlist_detects_planted_miss():
    """The count-proof itself: corrupt a shortlist by dropping a top
    element and the verifier must say not-ok; the intact one must pass."""
    rng = np.random.default_rng(6)
    scores = jnp.asarray(rng.standard_normal((1, 4096)).astype(np.float32))
    s, cand, ok = ti._verified_shortlist(scores, 64, 32, 0.95)
    assert bool(np.asarray(ok))
    # Corrupted shortlist: replace the true argmax with a mid-rank element,
    # then the "no miss above t" count must differ.
    order = np.argsort(-np.asarray(scores)[0])
    fake = order[np.r_[1:64, 100]]  # drop the argmax, pad with rank-100
    s_fake = jnp.asarray(np.asarray(scores)[0][fake][None, :])
    t = s_fake[:, 31][:, None]
    above = jnp.sum(scores > t, axis=1)
    above_s = jnp.sum(s_fake > t, axis=1)
    assert int(above[0]) != int(above_s[0])


def test_auto_wrapper_fallback_path(monkeypatch):
    """Force the verified program to report a miss: the auto wrapper must
    recover via the RESIDENT-SCORES fallback (exact top_k over the score
    matrix the fused program already materialized — no second scan)
    and still return the exact results."""
    rows, rowsd, mt, sc, nv = _index(n=1700, d=80, seed=7)
    rng = np.random.default_rng(8)
    q = jnp.asarray(rng.standard_normal((1, 80)).astype(np.float32))
    s0, i0 = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 9, n_valid=nv
    )
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")

    real_fused = ti.topk_int8_rerank_fused
    real_from_scores = ti.topk_exact_from_scores
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs.get("shortlist_method"))
        out = real_fused(*args, **kwargs)
        if kwargs.get("shortlist_method") == "verified":
            return out[0], out[1], jnp.asarray(False), out[3]  # forge a miss
        return out

    def spy_from_scores(*args, **kwargs):
        calls.append("from_scores")
        return real_from_scores(*args, **kwargs)

    monkeypatch.setattr(ti, "topk_int8_rerank_fused", spy)
    monkeypatch.setattr(ti, "topk_exact_from_scores", spy_from_scores)
    stats = {}
    s1, i1 = ti.topk_int8_rerank_fused_auto(
        q, mt, sc, rowsd, 9, n_valid=nv, stats=stats
    )
    assert calls == ["verified", "from_scores"]
    assert stats == {"verified_queries": 1, "shortlist_fallbacks": 1}
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1))


def test_topk_exact_from_scores_matches_fused():
    """The resident-scores fallback program alone == the default fused
    path, given the verified program's kept score matrix."""
    rows, rowsd, mt, sc, nv = _index(n=2300, d=72, seed=21)
    rng = np.random.default_rng(22)
    q = jnp.asarray(rng.standard_normal((1, 72)).astype(np.float32))
    k = 13
    s0, i0 = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, k, n_valid=nv
    )
    s, i, ok, scores_res = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, k, n_valid=nv,
        shortlist_method="verified", keep_scores=True,
    )
    assert scores_res.shape == (1, mt.shape[0])
    n = scores_res.shape[1]
    m = min(max(512, 4 * min(k, n)), n)
    s1, i1 = ti.topk_exact_from_scores(scores_res, q, rowsd, k, m)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(
        np.asarray(s0), np.asarray(s1), rtol=0, atol=0
    )


def test_keep_scores_masks_invalid_rows():
    """Rows past n_valid must be -inf in the kept score matrix so the
    fallback's exact top_k can never resurrect a pad column."""
    rows, rowsd, mt, sc, nv = _index(n=600, d=48, seed=23)  # pad to 1024
    rng = np.random.default_rng(24)
    q = jnp.asarray(rng.standard_normal((1, 48)).astype(np.float32))
    _, _, _, scores_res = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 10, n_valid=nv,
        shortlist_method="verified", keep_scores=True,
    )
    arr = np.asarray(scores_res)
    assert np.all(np.isneginf(arr[:, 600:]))
    assert np.all(np.isfinite(arr[:, :600]))
    # fallback over a shortlist deeper than n_valid: pad rows never return
    s1, i1 = ti.topk_exact_from_scores(scores_res, q, rowsd, 10, 1024)
    assert np.all(np.asarray(i1) < 600)


def test_env_override_forces_method(monkeypatch):
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    assert ti.resolve_shortlist_method() == "verified"
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "approx")
    assert ti.resolve_shortlist_method() == "approx"
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "extract")  # a removed method
    with pytest.raises(ValueError):
        ti.resolve_shortlist_method()
    monkeypatch.delenv("TPUCLIP_SHORTLIST")
    assert ti.resolve_shortlist_method() == "exact"
    assert ti.resolve_shortlist_method() == "exact"


@pytest.mark.parametrize("n,k", [(3, 5), (511, 20), (513, 128)])
def test_edge_shapes(n, k):
    """k >= n, sub-tile n, and just-past-pad boundaries."""
    rows, rowsd, mt, sc, nv = _index(n=n, d=32, seed=n)
    rng = np.random.default_rng(9)
    q = jnp.asarray(rng.standard_normal((1, 32)).astype(np.float32))
    s0, i0 = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, k, n_valid=nv
    )
    s1, i1, ok = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, k, n_valid=nv,
        shortlist_method="verified",
    )
    assert bool(np.asarray(ok))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_bf16_rows_verified_matches_extract():
    rows, rowsd, mt, sc, nv = _index(n=2048, d=64, seed=12, dtype=jnp.bfloat16)
    rng = np.random.default_rng(13)
    q = jnp.asarray(rng.standard_normal((1, 64)).astype(np.float32))
    s0, i0 = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 15, n_valid=nv
    )
    s1, i1, ok = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 15, n_valid=nv,
        shortlist_method="verified",
    )
    assert bool(np.asarray(ok))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1), rtol=0, atol=0)


@pytest.mark.parametrize("recall", [0.9, 0.999])
def test_shortlist_recall_static_arg(recall):
    """`shortlist_recall` (the approx_max_k recall target, a static arg)
    must retrace per value and leave CPU results exact regardless of target
    (CPU approx_max_k reduces to exact top_k)."""
    rows, rowsd, mt, sc, nv = _index(n=1300, d=64, seed=9)
    rng = np.random.default_rng(10)
    q = jnp.asarray(rng.standard_normal((1, 64)).astype(np.float32))
    s0, i0 = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 9, n_valid=nv
    )
    s1, i1, ok = ti.topk_int8_rerank_fused(
        q, mt, sc, rowsd, 9, n_valid=nv,
        shortlist_method="verified", shortlist_recall=recall,
    )
    assert bool(np.asarray(ok))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1), rtol=0, atol=0)

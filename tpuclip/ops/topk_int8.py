"""int8 quantized fused search.

The full scan is bound by device-memory bandwidth (the matrix is read once
per query), so halving bytes halves its time: vectors quantize to symmetric
per-vector int8 (unit-norm rows → scales are near-uniform), the scan
computes exact int32 dots, and scores rescale in f32. Combined with the
fused exact rescore (:func:`topk_int8_rerank_fused`) this is the DEFAULT
search path on the GPU (``platform.default_precision``): returned scores are
the full-precision rows' exact dots; `TPUCLIP_SEARCH_PRECISION=bf16`
restores the plain full scan.

**Layout**: the int8 matrix is ROW-major, (N, D), pre-padded with zero rows
to a multiple of :data:`INT8_TILE_N` and masked past ``n_valid`` — the same
layout as the full-precision rescore rows. Both operands of the int8 product
are then contiguous along D, the layout the GPU's int8 tensor-core products
take without a transpose. Ordering: (score desc, idx asc).

**Scan kernel**: :func:`int8_scores` writes the scaled, masked f32 (Q, N)
scores once. On the GPU it is :func:`int8_scores_triton`, a Pallas kernel
compiled through Triton; elsewhere :func:`_int8_scores_xla`. Both accumulate
in int32, so their scores are bit-identical.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpuclip import platform

_NEG_INF = float("-inf")


def round_f32_to_bf16_bits(x: jnp.ndarray) -> jnp.ndarray:
    """Round float32 to the nearest bfloat16 value, returned AS float32,
    via integer bit manipulation (round-half-to-even).

    ``x.astype(bf16).astype(f32)`` is NOT equivalent under jit: XLA's
    excess-precision rule elides a downcast that only feeds an upcast (or a
    dot's internal f32 upcast), silently substituting the unrounded input.
    That holds on every XLA backend, the GPU included. When a computation
    must use exactly the bf16-rounded value — e.g. the fused-rerank rescore
    reproducing the bf16 scan's scores — the rounding has to be expressed as
    integer arithmetic XLA cannot fold away. Finite inputs only (queries
    here are finite by construction)."""
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    lsb = (u >> 16) & jnp.uint32(1)
    u = u + jnp.uint32(0x7FFF) + lsb
    u = u & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


# Row padding multiple of the int8 matrix: a multiple of every Triton
# block_n, so any padded matrix takes the kernel.
INT8_TILE_N = 1024


def pad_rows(rows: np.ndarray, tile_n: int = INT8_TILE_N) -> Tuple[np.ndarray, int]:
    """Host-side: pad (N, D) with zero rows to a tile multiple. Returns
    (padded, n_valid); done once at upload so queries never copy."""
    n = rows.shape[0]
    rem = (-n) % tile_n
    if rem:
        rows = np.concatenate([rows, np.zeros((rem,) + rows.shape[1:], rows.dtype)])
    return rows, n


def quantize_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) float → (int8 (N, D), scales (N,) float32), symmetric per row."""
    m = np.asarray(rows, np.float32)
    scales = np.abs(m).max(axis=1) / 127.0
    scales = np.where(scales == 0, 1.0, scales).astype(np.float32)
    q = np.clip(np.rint(m / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales


def quantize_query(q: np.ndarray) -> Tuple[np.ndarray, float]:
    q = np.asarray(q, np.float32)
    scale = float(np.abs(q).max() / 127.0) or 1.0
    qi = np.clip(np.rint(q / scale), -127, 127).astype(np.int8)
    return qi, scale


@functools.partial(jax.jit, static_argnames=("n_pad",))
def derive_int8_matrix_device(
    rows: jnp.ndarray, n_pad: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Derive the int8 scan matrix + per-vector scales ON DEVICE from the
    resident full-precision rows copy: (N, D) bf16/f32 rows →
    ((n_pad, D) int8, (n_pad,) f32 scales), zero/one padding past N.

    When the device-rerank copy is resident anyway (the production int8
    configuration), this replaces the host-side ``quantize_rows`` + second
    upload: the host would otherwise pay several numpy passes over the f32
    matrix plus one more transfer. The int8 values come from the
    storage-dtype rows rather than the fp32 originals — a
    sub-quantization-step difference that only perturbs shortlist
    selection; exact scores still come from the fused rescore.
    """
    n, d = rows.shape
    mf = rows.astype(jnp.float32)
    scales = jnp.max(jnp.abs(mf), axis=1) / 127.0          # (N,) per-vector
    scales = jnp.where(scales == 0, 1.0, scales)
    q = jnp.clip(jnp.round(mf / scales[:, None]), -127, 127).astype(jnp.int8)
    q_p = jnp.zeros((n_pad, d), jnp.int8).at[:n].set(q)
    scales_p = jnp.ones((n_pad,), jnp.float32).at[:n].set(scales)
    return q_p, scales_p


def quantize_queries_device(q_f32: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """On-device per-row symmetric int8 quantization: (Q, D) f32 →
    ((Q, D) int8, (Q, 1) f32 scales). The scale is a positive per-row factor
    — rank-invariant — so shortlist-only callers may drop it."""
    qs = jnp.max(jnp.abs(q_f32), axis=1, keepdims=True) / 127.0
    qs = jnp.where(qs == 0, 1.0, qs)
    qi = jnp.clip(jnp.round(q_f32 / qs), -127, 127).astype(jnp.int8)
    return qi, qs


# Triton tiles, chosen by a sweep on an H100 at 1M x 1152, Q in {1, 16, 64}
# (PERF.md). block_q is the padded query count up to 64; Triton's dot needs
# at least 16 rows, so Q pads to 16.
_BLOCK_N = 64
_BLOCK_K = 128
_NUM_WARPS = 4
_NUM_STAGES = 4
_MAX_BLOCK_Q = 64


def _int8_scores_kernel(q_ref, m_ref, s_ref, nv_ref, o_ref, *, block_q, block_n, block_k):
    """One (block_q, block_n) score tile: the int8 product accumulates in
    int32 over D in block_k steps, then the row scales and the n_valid mask
    apply and the f32 tile is written once."""
    qi = pl.program_id(0)
    ni = pl.program_id(1)
    rows = pl.ds(ni * block_n, block_n)

    def body(kk, acc):
        cols = pl.ds(kk * block_k, block_k)
        q = q_ref[pl.ds(qi * block_q, block_q), cols]
        m = m_ref[rows, cols]
        return acc + pl.dot(q, m, trans_b=True)

    acc = jax.lax.fori_loop(
        0, q_ref.shape[1] // block_k, body,
        jnp.zeros((block_q, block_n), jnp.int32),
    )
    scores = acc.astype(jnp.float32) * s_ref[rows][None, :]
    col = ni * block_n + jnp.arange(block_n)
    o_ref[pl.ds(qi * block_q, block_q), rows] = jnp.where(
        col[None, :] < nv_ref[0], scores, _NEG_INF
    )


def _triton_block_k(d: int) -> Optional[int]:
    """Largest power-of-two K step (16..``_BLOCK_K``) dividing ``d``."""
    bk = _BLOCK_K
    while bk >= 16:
        if d % bk == 0:
            return bk
        bk //= 2
    return None


def triton_scan_fits(n: int, d: int, block_n: int = _BLOCK_N) -> bool:
    """Whether the Triton kernel takes an (n, d) int8 matrix: n a multiple
    of ``block_n`` (``INT8_TILE_N`` padding guarantees it) and d a multiple
    of 16."""
    return n > 0 and n % block_n == 0 and _triton_block_k(d) is not None


def int8_scores_triton(
    q_int8: jnp.ndarray,
    matrix_int8: jnp.ndarray,
    scales: jnp.ndarray,
    n_valid: jnp.ndarray,
    block_n: int = _BLOCK_N,
    interpret: bool = False,
) -> jnp.ndarray:
    """(Q, D) int8 queries × (N, D) int8 rows → (Q, N) f32 scaled scores,
    -inf past ``n_valid``; the Pallas kernel compiled through Triton
    (``interpret`` runs it on the CPU, for tests)."""
    q_count, d = q_int8.shape
    n = matrix_int8.shape[0]
    if not triton_scan_fits(n, d, block_n):
        raise ValueError(f"Triton int8 scan needs N % {block_n} == 0 and D % 16 == 0, got {(n, d)}")
    block_k = _triton_block_k(d)
    block_q = min(_MAX_BLOCK_Q, max(16, 1 << (q_count - 1).bit_length()))
    qp = -(-q_count // block_q) * block_q
    if qp > q_count:
        q_int8 = jnp.pad(q_int8, ((0, qp - q_count), (0, 0)))
    kernel = functools.partial(
        _int8_scores_kernel, block_q=block_q, block_n=block_n, block_k=block_k
    )
    out = pl.pallas_call(
        kernel,
        grid=(qp // block_q, n // block_n),
        out_shape=jax.ShapeDtypeStruct((qp, n), jnp.float32),
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="int8_scores",
    )(q_int8, matrix_int8, scales, jnp.reshape(jnp.asarray(n_valid, jnp.int32), (1,)))
    return out[:q_count]


def _int8_scores_xla(q_int8, matrix_int8, scales, n_valid):
    """Plain XLA reference of :func:`int8_scores_triton` (the CPU route)."""
    acc = jax.lax.dot_general(
        q_int8, matrix_int8,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    scores = acc.astype(jnp.float32) * scales[None, :]
    col = jax.lax.broadcasted_iota(jnp.int32, (1, matrix_int8.shape[0]), 1)
    return jnp.where(col < n_valid, scores, _NEG_INF)


def int8_scores(q_int8, matrix_int8, scales, n_valid):
    """The int8 scan: (Q, N) f32 scaled scores, -inf past ``n_valid``.
    Routed by ``platform.int8_scan_route`` alone (decided while tracing):
    the Triton kernel refuses a matrix not padded to ``INT8_TILE_N``."""
    if platform.int8_scan_route() == "triton":
        return int8_scores_triton(q_int8, matrix_int8, scales, n_valid)
    return _int8_scores_xla(q_int8, matrix_int8, scales, n_valid)


def _verified_shortlist(
    scores: jnp.ndarray, m: int, verify_depth: int, recall_target: float
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Approx top-``m`` over materialized scores + a PROVEN-content flag.

    ``lax.approx_max_k`` may silently drop mid-rank candidates on backends
    where it is approximate. A count verify proves (or disproves) shortlist
    sufficiency without assuming anything about the reduction: with t = the
    J-th shortlist score (J = ``verify_depth``), per query

        ok ⟺ |{scores > t}| == |{shortlist > t}|      (no miss above t)
             ∧ |{scores == t}| == |{shortlist == t}|  (no tie straddles t)

    — four cheap reductions over the already-materialized score matrix.
    ``ok`` (scalar, all-queries) is RETURNED for a host-side decision, not
    branched on in-program, so the exact fallback
    (:func:`topk_exact_from_scores`) runs only when a proof fails.

    Guarantee when ok: the candidate set contains the TRUE int8-score
    top-J exactly — ties included — plus up to m-J opportunistic extras.
    """
    s_a, cand_a = jax.lax.approx_max_k(scores, m, recall_target=recall_target)
    cand_a = cand_a.astype(jnp.int32)
    j = min(verify_depth, m)
    t = s_a[:, j - 1][:, None]
    above = jnp.sum(scores > t, axis=1)
    above_s = jnp.sum(s_a > t, axis=1)
    eq = jnp.sum(scores == t, axis=1)
    eq_s = jnp.sum(s_a == t, axis=1)
    ok = jnp.all(((above == above_s) & (eq == eq_s)) | jnp.isneginf(t[:, 0]))
    return s_a, cand_a, ok


# Shortlist construction for the fused path ("auto" resolves in
# resolve_shortlist_method): "exact" = scores + lax.top_k (the default);
# "approx" = scores + lax.approx_max_k; "verified" = approx + a count proof
# with a host-side fallback over the resident score matrix. On the GPU
# approx_max_k lowers to the same full radix sort as top_k (PERF.md), so
# "approx" and "verified" only differ from "exact" on backends whose
# approx_max_k really is approximate.
_SHORTLIST_RECALL = float(os.environ.get("TPUCLIP_SHORTLIST_RECALL", "0.95"))
_SHORTLIST_METHODS = ("exact", "approx", "verified")


def resolve_shortlist_method() -> str:
    """Default policy ("exact"), overridable via TPUCLIP_SHORTLIST."""
    env = os.environ.get("TPUCLIP_SHORTLIST", "auto")
    if env == "auto":
        return "exact"
    if env not in _SHORTLIST_METHODS:
        raise ValueError(
            f"TPUCLIP_SHORTLIST={env!r}; expected auto or one of {_SHORTLIST_METHODS}"
        )
    return env


# Bytes of device memory the shortlist selection takes per (query, row)
# score: the f32 score, and for lax.top_k on the GPU a cub radix sort over
# (score, index) pairs — the sorted copies plus the sort's scratch, 8 bytes
# each, and the int32 index iota (compiled HLO on an H100, PERF.md).
_SELECT_BYTES_PER_SCORE = 24


def score_rows_per_pass(n: int) -> int:
    """Capacity gate for the (Q, N) score matrix and its selection: how
    many query rows one pass may score so the transient fits the device's
    free memory (``platform.fits``'s margin). Unbounded where the device
    reports no memory statistics. Evaluated while tracing."""
    free = platform.free_bytes()
    if free is None:
        return 1 << 30
    return max(1, free // max(1, n * _SELECT_BYTES_PER_SCORE))


@functools.partial(jax.jit, static_argnames=("k",))
def topk_int8_scan(
    q_int8, matrix_int8, scales, q_scale, k, n_valid=None, mask=None
):
    """int8 scan + ``lax.top_k`` (masked searches and the non-fused paths);
    (score desc, idx asc) order, scores rescaled by ``q_scale``."""
    n = matrix_int8.shape[0]
    k_eff = min(k, n) if n > 0 else 0
    if k_eff == 0:
        return (
            jnp.zeros((q_int8.shape[0], 0), jnp.float32),
            jnp.zeros((q_int8.shape[0], 0), jnp.int32),
        )
    if n_valid is None:
        n_valid = jnp.asarray(n, jnp.int32)
    scores = int8_scores(q_int8, matrix_int8, scales, n_valid)
    if mask is not None:
        scores = scores + mask[None, :]
    top_s, top_i = jax.lax.top_k(scores, k_eff)
    order = jnp.lexsort((top_i, -top_s), axis=-1)
    return (
        jnp.take_along_axis(top_s, order, axis=1) * q_scale,
        jnp.take_along_axis(top_i, order, axis=1).astype(jnp.int32),
    )


def _shortlist(scores, m, k_eff, method, shortlist_recall):
    """(top scores, candidate rows, proof flag or None) for one score block."""
    if method == "exact":
        top_s, cand = jax.lax.top_k(scores, m)
        return top_s, cand.astype(jnp.int32), None
    if method == "approx":
        top_s, cand = jax.lax.approx_max_k(scores, m)
        return top_s, cand.astype(jnp.int32), None
    return _verified_shortlist(
        scores, m, verify_depth=min(m, max(64, 4 * k_eff)),
        recall_target=(
            _SHORTLIST_RECALL if shortlist_recall is None else shortlist_recall
        ),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "shortlist", "shortlist_method", "shortlist_recall", "keep_scores",
    ),
)
def topk_int8_rerank_fused(
    q_f32: jnp.ndarray,          # (Q, D) float32 queries (unquantized)
    matrix_int8: jnp.ndarray,    # (N, D) int8, pre-padded to a tile multiple
    scales: jnp.ndarray,         # (N,) float32 per-vector scales
    rows_full: jnp.ndarray,      # (N_rows, D) bf16/f32 row-major full-precision copy
    k: int,
    shortlist: int = 512,
    n_valid: Optional[jnp.ndarray] = None,
    shortlist_method: Optional[str] = None,
    shortlist_recall: Optional[float] = None,
    keep_scores: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ONE device program: int8 scan -> top-``shortlist`` selection -> gather
    the shortlisted rows from the resident full-precision matrix -> exact
    rescore -> final (score desc, idx asc) top-k.

    The int8 matrix is the only full scan (half the bytes of the bf16
    matrix), and exactness comes from rescoring the shortlist against
    ``rows_full`` on device (a few MB of gathers) instead of a host-memmap
    re-rank (index/search.py:_exact_rerank). Scores returned are
    bit-identical to the full bf16 scan's for any candidate both paths
    return.

    ``shortlist_method`` (None = "exact", see resolve_shortlist_method):
    "exact" selects with ``lax.top_k``; "approx" with ``lax.approx_max_k``;
    "verified" adds :func:`_verified_shortlist`'s proof flag as a third
    output for the caller's host-side fallback, and with ``keep_scores`` the
    (Q, N) score matrix as a fourth. The score matrix is scored
    :func:`score_rows_per_pass` query rows at a time.

    Recall contract: a true top-k item is returned iff it survives the int8
    shortlist. With unit-norm vectors int8 quantization perturbs cosine
    scores by ~1e-3, so at depth max(512, 4k) the miss probability is
    negligible (property-tested in tests/test_topk_int8.py).
    """
    q_count, d = q_f32.shape
    n = matrix_int8.shape[0]
    method = shortlist_method or "exact"
    if n_valid is None:
        n_valid = jnp.asarray(n, jnp.int32)
    k_eff = min(k, n) if n > 0 else 0
    if k_eff == 0:
        empty = (
            jnp.zeros((q_count, 0), jnp.float32),
            jnp.zeros((q_count, 0), jnp.int32),
        )
        if method == "verified":
            empty += (jnp.asarray(True),)
            if keep_scores:
                empty += (jnp.zeros((q_count, 0), jnp.float32),)
        return empty

    # Shortlist selection skips the (rank-invariant) query scale; exact
    # scores come from the rescore anyway.
    qi, _ = quantize_queries_device(q_f32)
    m = min(max(shortlist, 4 * k_eff), n)
    per_pass = score_rows_per_pass(n)
    tops, cands, oks, kept = [], [], [], []
    for lo in range(0, q_count, per_pass):
        scores = int8_scores(qi[lo:lo + per_pass], matrix_int8, scales, n_valid)
        top_s, cand, ok = _shortlist(scores, m, k_eff, method, shortlist_recall)
        tops.append(top_s)
        cands.append(cand)
        if ok is not None:
            oks.append(ok)
        if keep_scores:
            kept.append(scores)
    top_s = jnp.concatenate(tops) if len(tops) > 1 else tops[0]
    cand = jnp.concatenate(cands) if len(cands) > 1 else cands[0]

    out = _rescore_select(cand, jnp.isneginf(top_s), q_f32, rows_full, k_eff)
    if method == "verified":
        # Three-tuple return for the host-side fallback decision.
        ok = jnp.all(jnp.stack(oks))
        if keep_scores:
            # The already-materialized (Q, N) int8 score matrix stays on
            # device so a proof failure needs only an exact top_k over it +
            # rescore (topk_exact_from_scores) — NOT a second full scan.
            return out + (ok, jnp.concatenate(kept) if len(kept) > 1 else kept[0])
        return out + (ok,)
    return out


def _rescore_select(cand, cand_invalid, q_f32, rows_full, k_eff):
    """Shared fused-path tail: exact rescore of a candidate shortlist +
    final (score desc, idx asc) top-``k_eff``.

    Exact rescore: gather candidate rows and dot with f32 accumulation.
    To return the SAME scores the bf16 scan computes, the query must be
    rounded to the storage dtype first — and that rounding must be done
    with integer bit ops (round_f32_to_bf16_bits): under jit, XLA's
    excess-precision rule elides an `astype(bf16)` that feeds the dot's
    internal f32 upcast and substitutes the UNROUNDED query (a ~3e-3 score
    divergence from the bf16 scan, enough to drop true top-k items near the
    cutoff). With the query genuinely rounded, products of bf16-rounded
    inputs are exact in f32, so scores match the scan's up to f32 summation
    order (~1e-6).

    Precision: bf16-rounded operands have 8 significant bits, which TF32's
    11 hold exactly, so the default-precision dot (TF32 on the GPU) is exact
    for bf16 rows. f32 rows are scored at HIGHEST precision.
    """
    n_rows = rows_full.shape[0]
    safe = jnp.clip(cand, 0, n_rows - 1)
    if rows_full.dtype == jnp.bfloat16:
        qr = round_f32_to_bf16_bits(q_f32.astype(jnp.float32))
        precision = None
    else:
        qr = q_f32.astype(jnp.float32)
        precision = jax.lax.Precision.HIGHEST
    gathered = rows_full[safe].astype(jnp.float32)  # (Q, M, D)
    exact = jnp.einsum(
        "qmd,qd->qm", gathered, qr, preferred_element_type=jnp.float32,
        precision=precision,
    )
    invalid = (cand < 0) | (cand >= n_rows) | cand_invalid
    exact = jnp.where(invalid, _NEG_INF, exact)
    sort_rows = jnp.where(invalid, jnp.iinfo(jnp.int32).max, cand)
    order = jnp.lexsort((sort_rows, -exact), axis=-1)[:, :k_eff]
    return (
        jnp.take_along_axis(exact, order, axis=1),
        jnp.take_along_axis(sort_rows, order, axis=1),
    )


def fallback_shortlist_depth(k: int, n: int, shortlist: int = 512) -> int:
    """Shortlist depth for the proof-miss fallback over the resident score
    matrix — ONE definition shared by topk_int8_rerank_fused_auto and
    DeviceIndex._run_fused, so the two 'identical' fallback paths cannot
    drift apart if the formula is ever tuned."""
    return min(max(shortlist, 4 * min(k, n)), n)


@functools.partial(jax.jit, static_argnames=("k", "m"))
def topk_exact_from_scores(scores, q_f32, rows_full, k, m):
    """Exact top-``k`` from an already-materialized int8 score matrix.

    The cheap proof-failure fallback for the verified shortlist: instead
    of re-running the scan (or, on the fused text path, the whole text
    tower again), run ``lax.top_k`` over the (Q, N) scores the verified
    program kept resident (``keep_scores=True``), then the shared
    exact-rescore tail. The exact top-``m`` of the int8 scores is the
    STRONGEST possible int8 shortlist, so results carry the same contract:
    every true top-k item that survives int8 quantization is returned, ties
    (score desc, idx asc).
    """
    k_eff = min(k, scores.shape[1])
    top_s, cand = jax.lax.top_k(scores, m)
    return _rescore_select(
        cand.astype(jnp.int32), jnp.isneginf(top_s), q_f32, rows_full, k_eff
    )


def topk_int8_rerank_fused_auto(
    q_f32,
    matrix_int8,
    scales,
    rows_full,
    k: int,
    shortlist: int = 512,
    n_valid=None,
    stats: Optional[dict] = None,
):
    """Host-level fused search under the shortlist policy
    (resolve_shortlist_method): the "verified" program's proof flag is
    checked on the host, and a proof miss runs an exact ``lax.top_k`` over
    the score matrix that program kept RESIDENT on device
    (topk_exact_from_scores) — no second scan, no re-quantization.
    ``stats`` counts verified queries and fallbacks (serve /stats).
    """
    method = resolve_shortlist_method()
    if method == "verified":
        s, i, ok, scores_res = topk_int8_rerank_fused(
            q_f32, matrix_int8, scales, rows_full, k, shortlist=shortlist,
            n_valid=n_valid, shortlist_method="verified", keep_scores=True,
        )
        if stats is not None:
            stats["verified_queries"] = stats.get("verified_queries", 0) + 1
        if bool(np.asarray(ok)):
            return s, i
        if stats is not None:
            stats["shortlist_fallbacks"] = stats.get("shortlist_fallbacks", 0) + 1
        # ok can only be False when the scores path actually ran, so the
        # resident matrix is always non-empty here.
        n = scores_res.shape[1]
        m = fallback_shortlist_depth(k, n, shortlist)
        return topk_exact_from_scores(scores_res, q_f32, rows_full, k, m)
    return topk_int8_rerank_fused(
        q_f32, matrix_int8, scales, rows_full, k, shortlist=shortlist,
        n_valid=n_valid, shortlist_method=method,
    )


def _fused_embedding_tail(out, emb, shortlist_method, keep_scores):
    """Shared extra-output contract of the tower-fused wrappers: with
    ``keep_scores`` on the verified program, the (fp32) query embedding
    follows the resident score matrix so a proof miss never re-runs the
    tower. One place, three wrappers — a drifted copy would produce a
    wrong-arity unpack in DeviceIndex._run_fused."""
    if keep_scores and shortlist_method == "verified":
        return out + (emb.astype(jnp.float32),)
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "k", "compute_dtype", "shortlist",
        "shortlist_method", "keep_scores",
    ),
)
def text_topk_fused(
    params,
    ids: jnp.ndarray,            # (B, 64) int token ids (prompted + padded)
    attn_mask: jnp.ndarray,      # (B, 64) attention mask
    matrix_int8: jnp.ndarray,    # (N, D) int8
    scales: jnp.ndarray,         # (N,) f32
    rows_full: jnp.ndarray,      # (N_rows, D) storage-dtype full copy
    config,
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    shortlist: int = 512,
    compute_dtype=jnp.float32,
    shortlist_method: Optional[str] = None,
    keep_scores: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Token ids → text tower → int8 scan → exact rescore → top-k, ONE
    device program. The embedding never returns to the host — the serving
    text-query path pays a single host↔device round trip (the reference
    pays one per stage: tokenize→embed→SQL scan, image_database.py:509-543,
    :1564). Results identical to embed-then-search by construction.

    ``shortlist_method="verified"`` adds the proof flag as a third output
    (see :func:`topk_int8_rerank_fused`); with ``keep_scores=True`` the
    resident (Q, N) score matrix AND the text embedding follow as fourth
    and fifth outputs so a proof failure costs only
    :func:`topk_exact_from_scores` — neither the text tower nor the scan
    re-runs (both stay on device; no host transfer on the happy path)."""
    from tpuclip.models.siglip import get_text_features

    emb = get_text_features(
        params, ids, config, compute_dtype=compute_dtype, attention_mask=attn_mask
    )
    out = topk_int8_rerank_fused(
        emb, matrix_int8, scales, rows_full, k,
        shortlist=shortlist, n_valid=n_valid,
        shortlist_method=shortlist_method, keep_scores=keep_scores,
    )
    return _fused_embedding_tail(out, emb, shortlist_method, keep_scores)


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "k", "compute_dtype", "shortlist",
        "shortlist_method", "keep_scores",
    ),
)
def image_topk_fused(
    params,
    pixels: jnp.ndarray,         # (B, S, S, 3) uint8 NHWC (query resolution)
    matrix_int8: jnp.ndarray,    # (N, D) int8
    scales: jnp.ndarray,         # (N,) f32
    rows_full: jnp.ndarray,      # (N_rows, D) storage-dtype full copy
    config,
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    shortlist: int = 512,
    compute_dtype=jnp.float32,
    shortlist_method: Optional[str] = None,
    keep_scores: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """uint8 pixels → vision tower → int8 scan → exact rescore → top-k, ONE
    device program — the image-query analog of :func:`text_topk_fused`.

    The reference's image query runs tower inference and the SQL vector
    scan as separate stages with a host round trip of the embedding in
    between (image_database.py:443-507 then :1564); here the embedding
    stays on device. Results identical to embed-then-search by
    construction. Same ``shortlist_method="verified"`` / ``keep_scores``
    extra-output contract as :func:`text_topk_fused` (fifth output is the
    image embedding, so a proof miss re-runs neither the vision tower nor
    the scan — just :func:`topk_exact_from_scores`)."""
    from tpuclip.models.siglip import get_image_features

    emb = get_image_features(params, pixels, config, compute_dtype=compute_dtype)
    out = topk_int8_rerank_fused(
        emb, matrix_int8, scales, rows_full, k,
        shortlist=shortlist, n_valid=n_valid,
        shortlist_method=shortlist_method, keep_scores=keep_scores,
    )
    return _fused_embedding_tail(out, emb, shortlist_method, keep_scores)


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "k", "compute_dtype", "shortlist",
        "shortlist_method", "keep_scores",
    ),
)
def naflex_image_topk_fused(
    params,
    patches: jnp.ndarray,        # (B, L, P*P*C) uint8 patchified pixels
    pixel_mask: jnp.ndarray,     # (B, L) valid-patch mask
    spatial_shapes: jnp.ndarray,  # (B, 2) patch grids
    matrix_int8: jnp.ndarray,    # (N, D) int8
    scales: jnp.ndarray,         # (N,) f32
    rows_full: jnp.ndarray,      # (N_rows, D) storage-dtype full copy
    config,
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    shortlist: int = 512,
    compute_dtype=jnp.float32,
    shortlist_method: Optional[str] = None,
    keep_scores: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`image_topk_fused` for the NaFlex (variable-aspect) family:
    uint8 patches + mask + grid → NaFlex vision tower → int8 scan → exact
    rescore → top-k, ONE device program. Same extra-output contract."""
    from tpuclip.models.naflex import get_image_features_naflex

    emb = get_image_features_naflex(
        params, patches, pixel_mask, spatial_shapes, config,
        compute_dtype=compute_dtype,
    )
    out = topk_int8_rerank_fused(
        emb, matrix_int8, scales, rows_full, k,
        shortlist=shortlist, n_valid=n_valid,
        shortlist_method=shortlist_method, keep_scores=keep_scores,
    )
    return _fused_embedding_tail(out, emb, shortlist_method, keep_scores)


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "k", "compute_dtype", "shortlist",
        "shortlist_method", "keep_scores",
    ),
)
def mixed_topk_fused(
    params,
    ids: jnp.ndarray,            # (Tb, 64) token ids (prompted + padded rows)
    attn_mask: jnp.ndarray,      # (Tb, 64) attention mask (pad rows all-zero)
    pixels: jnp.ndarray,         # (Ib, S, S, 3) uint8 NHWC (pad rows zero)
    matrix_int8: jnp.ndarray,    # (N, D) int8
    scales: jnp.ndarray,         # (N,) f32
    rows_full: jnp.ndarray,      # (N_rows, D) storage-dtype full copy
    config,
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    shortlist: int = 512,
    compute_dtype=jnp.float32,
    shortlist_method: Optional[str] = None,
    keep_scores: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mixed text+image query block: text tower + vision tower + ONE int8
    scan over the concatenated (texts-first) query block, exact rescore,
    top-k — one device program.

    Why: the scan's cost is ~flat in the query count (it is a
    bandwidth-bound read of the matrix), so a mixed serve window that runs
    the text group and the image group as separate passes pays that read
    twice. Row layout of every output: texts
    occupy rows [0, Tb), images rows [Tb, Tb+Ib); the caller slices the
    real (unpadded) entries out of each span. Same
    ``shortlist_method="verified"`` / ``keep_scores`` extra-output
    contract as :func:`text_topk_fused` (fifth output is the concatenated
    query embedding block)."""
    from tpuclip.models.siglip import get_image_features, get_text_features

    emb_t = get_text_features(
        params, ids, config, compute_dtype=compute_dtype, attention_mask=attn_mask
    )
    emb_v = get_image_features(params, pixels, config, compute_dtype=compute_dtype)
    emb = jnp.concatenate([emb_t, emb_v], axis=0)
    out = topk_int8_rerank_fused(
        emb, matrix_int8, scales, rows_full, k,
        shortlist=shortlist, n_valid=n_valid,
        shortlist_method=shortlist_method, keep_scores=keep_scores,
    )
    return _fused_embedding_tail(out, emb, shortlist_method, keep_scores)


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "k", "compute_dtype", "shortlist",
        "shortlist_method", "keep_scores",
    ),
)
def mixed_naflex_topk_fused(
    params,
    ids: jnp.ndarray,            # (Tb, 64) token ids (prompted + padded rows)
    attn_mask: jnp.ndarray,      # (Tb, 64) attention mask (pad rows all-zero)
    patches: jnp.ndarray,        # (Ib, L, P*P*C) uint8 patchified pixels
    pixel_mask: jnp.ndarray,     # (Ib, L) valid-patch mask
    spatial_shapes: jnp.ndarray,  # (Ib, 2) patch grids
    matrix_int8: jnp.ndarray,    # (N, D) int8
    scales: jnp.ndarray,         # (N,) f32
    rows_full: jnp.ndarray,      # (N_rows, D) storage-dtype full copy
    config,
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    shortlist: int = 512,
    compute_dtype=jnp.float32,
    shortlist_method: Optional[str] = None,
    keep_scores: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`mixed_topk_fused` for the NaFlex (variable-aspect) family:
    text tower + NaFlex vision tower + ONE shared int8 scan + exact
    rescore, one device program. Same texts-first row layout and
    extra-output contract."""
    from tpuclip.models.naflex import get_image_features_naflex
    from tpuclip.models.siglip import get_text_features

    emb_t = get_text_features(
        params, ids, config, compute_dtype=compute_dtype, attention_mask=attn_mask
    )
    emb_v = get_image_features_naflex(
        params, patches, pixel_mask, spatial_shapes, config,
        compute_dtype=compute_dtype,
    )
    emb = jnp.concatenate([emb_t, emb_v], axis=0)
    out = topk_int8_rerank_fused(
        emb, matrix_int8, scales, rows_full, k,
        shortlist=shortlist, n_valid=n_valid,
        shortlist_method=shortlist_method, keep_scores=keep_scores,
    )
    return _fused_embedding_tail(out, emb, shortlist_method, keep_scores)


@functools.partial(jax.jit, static_argnames=("k",))
def topk_int8_batch(q_f32, matrix_int8, scales, k, n_valid=None, mask=None):
    """Batched int8 scan with ON-DEVICE per-row query quantization.

    One compiled program does quantize + int8 scan + top-k + scale fold —
    the serve micro-batcher calls this per request group, so no host numpy
    runs per request."""
    qi, qs = quantize_queries_device(q_f32)
    s, i = topk_int8_scan(
        qi, matrix_int8, scales, jnp.asarray(1.0, jnp.float32), k,
        n_valid=n_valid, mask=mask,
    )
    return s * qs, i

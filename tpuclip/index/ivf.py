"""IVF (inverted-file) approximate search — a static-shape bucketed design.

Beyond-reference capability: the reference scans every vector per query
(sqlite-vec brute force, image_database.py:1564-1574); tpuclip's exact scan
already does that at device-memory bandwidth. IVF trades a little recall
for a ~10-30x smaller scan. Its time on the GPU is not measured yet.

Shape decisions (everything static under jit):
- **Spherical k-means on device**: assignment is one (M, D) x (D, K)
  matmul per iteration; updates are segment-sums.
- **Balanced buckets, not ragged lists**: classic IVF keeps variable-length
  posting lists — dynamic shapes XLA can't tile. Here every cluster gets a
  fixed capacity C (cap x mean size); rows beyond capacity spill to one
  **overflow block that every query scans**, so bucketing never silently
  drops a row. Layout: (K, D, C) int8 blocks, feature-major within the
  block so the probe is one plain matmul.
- **Probe = gather + one matmul**: top-P centroid buckets gather to a
  (P, D, C) block, scored as a single (1, D) x (D, P*C) int8 matmul; the
  overflow block appends. Scores rescale by per-row int8 scales; the final
  candidates are EXACTLY rescored against the resident full-precision rows
  (same contract as ops/topk_int8.topk_int8_rerank_fused), so returned
  scores are identical to the exact path's for every row returned — only
  recall (which rows are considered) is approximate.

Recall is a function of nprobe/K and data clusteredness; the serving
default (K ~= sqrt(N)*2, nprobe 32) measures >=0.95 top-20 recall on
clustered embeddings (tests/test_ivf.py). Opt-in via
TPUCLIP_SEARCH_MODE=ivf (DeviceIndex wires it when precision=int8 and the
device-rerank copy is resident).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuclip.ops.topk_int8 import quantize_queries_device, round_f32_to_bf16_bits

_NEG_INF = float("-inf")


# =============================================================================
# Spherical k-means (device)
# =============================================================================


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def _kmeans_device(sample: jnp.ndarray, init_idx: jnp.ndarray, k: int, iters: int):
    """Spherical k-means: unit-norm rows, cosine assignment, renormalized
    mean updates. Empty clusters keep their previous centroid."""
    x = sample  # (M, D) f32, unit rows
    cent = x[init_idx]  # (k, D)

    def step(_, cent):
        scores = x @ cent.T  # (M, k)
        assign = jnp.argmax(scores, axis=1)
        one_hot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # (M, k)
        sums = one_hot.T @ x  # (k, D)
        counts = jnp.sum(one_hot, axis=0)[:, None]  # (k, 1)
        norms = jnp.linalg.norm(sums, axis=1, keepdims=True)
        new = jnp.where((counts > 0) & (norms > 1e-12), sums / jnp.maximum(norms, 1e-12), cent)
        return new

    return jax.lax.fori_loop(0, iters, step, cent)


def train_centroids(
    vectors: np.ndarray, k: int, iters: int = 12, sample: int = 131_072, seed: int = 0
) -> np.ndarray:
    """(N, D) f32 host rows → (k, D) f32 unit centroids."""
    rng = np.random.default_rng(seed)
    n = len(vectors)
    take = min(n, sample)
    idx = rng.choice(n, size=take, replace=False) if take < n else np.arange(n)
    x = np.asarray(vectors[np.sort(idx)], np.float32)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    init = rng.choice(take, size=k, replace=False)
    cent = _kmeans_device(jnp.asarray(x), jnp.asarray(np.sort(init)), k, iters)
    return np.asarray(cent, np.float32)


# =============================================================================
# Index build (host layout, device-resident blocks)
# =============================================================================


class IVFIndex(NamedTuple):
    centroids: jnp.ndarray      # (K, D) f32 unit
    buckets: jnp.ndarray        # (K, D, C) int8, feature-major blocks
    bucket_scales: jnp.ndarray  # (K, C) f32 per-row scales (0 for empty slots)
    bucket_rows: jnp.ndarray    # (K, C) int32 global row ids (-1 empty)
    over_t: jnp.ndarray         # (D, O) int8 overflow block (always scanned)
    over_scales: jnp.ndarray    # (O,) f32
    over_rows: jnp.ndarray      # (O,) int32 (-1 padding)
    nprobe: int


def build_ivf(
    vectors: np.ndarray,
    k_clusters: Optional[int] = None,
    capacity_factor: float = 1.5,
    nprobe: int = 32,
    iters: int = 12,
    seed: int = 0,
    centroids: Optional[np.ndarray] = None,
) -> IVFIndex:
    """Cluster (N, D) f32 rows into balanced fixed-capacity buckets.

    Capacity C = ceil(N/K * capacity_factor) rounded up to a lane multiple;
    rows whose cluster is full spill to the always-scanned overflow block —
    no row is ever unreachable.

    ``centroids``: pass a previous build's (K, D) centroids to skip the
    k-means retrain — the incremental-refresh path (rows appended, the
    distribution barely moved) reassigns against them in one device pass,
    mirroring build_ivf_device's reuse contract.
    """
    n, d = vectors.shape
    if centroids is not None:
        k_clusters = int(centroids.shape[0])
    if k_clusters is None:
        # ~2*sqrt(N), power-of-two-ish, at least 8, at most N//8
        k_clusters = int(max(8, min(2 * int(np.sqrt(n)), n // 8 or 8)))
    k_clusters = max(1, min(k_clusters, n))
    nprobe = max(1, min(nprobe, k_clusters))

    if centroids is not None:
        cent = np.asarray(centroids, np.float32)
    else:
        cent = train_centroids(vectors, k_clusters, iters=iters, seed=seed)
    x = np.asarray(vectors, np.float32)

    # Assign every row on device (a 1M x 1152 @ 1152 x 2048 matmul is tens
    # of seconds of host numpy but one quick device program), chunked so
    # arbitrary N reuses one compiled program.
    @functools.partial(jax.jit, static_argnames=())
    def _assign_chunk(xc, cent_t):
        return jnp.argmax(xc @ cent_t, axis=1).astype(jnp.int32)

    assign = np.empty(n, np.int64)
    chunk = 262_144
    cent_dev = jnp.asarray(cent.T)
    for s in range(0, n, chunk):
        xc = x[s : s + chunk]
        if len(xc) < chunk:
            xc = np.pad(xc, ((0, chunk - len(xc)), (0, 0)))
        out = np.asarray(_assign_chunk(jnp.asarray(xc), cent_dev))
        assign[s : s + chunk] = out[: min(chunk, n - s)]

    cap = int(-(-(n / k_clusters * capacity_factor) // 1))
    cap = max(8, -(-cap // 8) * 8)  # a multiple of 8 rows

    # Per-vector symmetric int8 quantization (same scheme as the flat index)
    scales_all = np.abs(x).max(axis=1) / 127.0
    scales_all = np.where(scales_all == 0, 1.0, scales_all).astype(np.float32)
    q_all = np.clip(
        np.rint(x / scales_all[:, None]), -127, 127
    ).astype(np.int8)

    # Vectorized balanced fill: rows sorted by cluster; position-in-cluster
    # via cumulative counts; positions beyond capacity spill to overflow.
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    counts = np.bincount(sorted_assign, minlength=k_clusters)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n, dtype=np.int64) - starts[sorted_assign]
    in_bucket = pos < cap

    buckets = np.zeros((k_clusters, d, cap), np.int8)
    bucket_scales = np.zeros((k_clusters, cap), np.float32)
    bucket_rows = np.full((k_clusters, cap), -1, np.int32)
    bc, bp, br = sorted_assign[in_bucket], pos[in_bucket], order[in_bucket]
    buckets[bc, :, bp] = q_all[br]
    bucket_scales[bc, bp] = scales_all[br]
    bucket_rows[bc, bp] = br.astype(np.int32)

    ov = order[~in_bucket]
    o = len(ov)
    o_pad = max(8, -(-max(o, 1) // 128) * 128)
    over_t = np.zeros((d, o_pad), np.int8)
    over_scales = np.zeros(o_pad, np.float32)
    over_rows = np.full(o_pad, -1, np.int32)
    if o:
        over_t[:, :o] = q_all[ov].T
        over_scales[:o] = scales_all[ov]
        over_rows[:o] = ov.astype(np.int32)

    return IVFIndex(
        centroids=jnp.asarray(cent),
        buckets=jnp.asarray(buckets),
        bucket_scales=jnp.asarray(bucket_scales),
        bucket_rows=jnp.asarray(bucket_rows),
        over_t=jnp.asarray(over_t),
        over_scales=jnp.asarray(over_scales),
        over_rows=jnp.asarray(over_rows),
        nprobe=int(nprobe),
    )


# =============================================================================
# Device-side build (from the resident full-precision rows)
# =============================================================================


@functools.partial(
    jax.jit, static_argnames=("k_clusters", "iters", "sample_cap", "cap")
)
def _ivf_train_assign(rows_full, key, k_clusters, iters, sample_cap, cap):
    """Phase 1 on device: k-means train + full assignment + spill count.

    Returns (centroids (K, D) f32, assign (N,) int32, spill () int32). The
    spill count crosses to the host (one scalar fetch) so phase 2 can size
    the overflow block exactly — the balanced-bucket contract ("no row is
    ever unreachable", see build_ivf) needs an exact, not bounded, capacity.
    """
    n, d = rows_full.shape
    stride = max(1, -(-n // sample_cap))
    sample = rows_full[::stride][:sample_cap].astype(jnp.float32)
    sample = sample / jnp.maximum(
        jnp.linalg.norm(sample, axis=1, keepdims=True), 1e-12
    )
    init_idx = jax.random.permutation(key, sample.shape[0])[:k_clusters]
    cent = _kmeans_device(sample, init_idx, k_clusters, iters)

    # Full assignment, chunked via lax.scan so the (chunk, K) score block is
    # the only transient (a monolithic (N, K) f32 at 1M x 2048 is 8 GB).
    chunk = min(131_072, n)
    n_pad = -(-n // chunk) * chunk
    xp = jnp.pad(rows_full, ((0, n_pad - n), (0, 0))).reshape(-1, chunk, d)
    cent_t = cent.T

    def body(_, xc):
        scores = xc.astype(jnp.float32) @ cent_t
        return None, jnp.argmax(scores, axis=1).astype(jnp.int32)

    _, assign = jax.lax.scan(body, None, xp)
    assign = assign.reshape(-1)[:n]
    counts = jnp.bincount(assign, length=k_clusters)
    spill = jnp.sum(jnp.maximum(counts - cap, 0)).astype(jnp.int32)
    return cent, assign, spill


@functools.partial(jax.jit, static_argnames=("chunk", "cap"))
def _ivf_assign_device(rows_full, cent, chunk: int, cap: int):
    """Assignment-only pass against given centroids: chunked argmax + spill
    count. Module-level jit so the incremental-refresh path (centroid
    reuse) hits the compile cache instead of re-tracing a fresh closure on
    every refresh under the serving lock (review r3)."""
    n, d = rows_full.shape
    n_pad = -(-n // chunk) * chunk
    xp = jnp.pad(rows_full, ((0, n_pad - n), (0, 0))).reshape(-1, chunk, d)
    cent_t = cent.T

    def body(_, xc):
        return None, jnp.argmax(
            xc.astype(jnp.float32) @ cent_t, axis=1
        ).astype(jnp.int32)

    _, assign = jax.lax.scan(body, None, xp)
    assign = assign.reshape(-1)[:n]
    counts = jnp.bincount(assign, length=cent.shape[0])
    spill = jnp.sum(jnp.maximum(counts - cap, 0)).astype(jnp.int32)
    return assign, spill


@functools.partial(jax.jit, static_argnames=("k_clusters", "cap", "o_pad"))
def _ivf_fill_device(rows_full, assign, k_clusters, cap, o_pad):
    """Phase 2 on device: quantize + balanced scatter into fixed blocks.

    Same layout/contract as the host fill in build_ivf: rows sorted by
    cluster, position-in-cluster < cap goes to its bucket slot, the rest to
    the overflow block in sorted order. Scatters use a trash slot (index one
    past the real block) so shapes stay static under jit.
    """
    n, d = rows_full.shape

    # Per-row symmetric int8 quantization, chunked (a monolithic f32 copy of
    # the rows is 4 N D bytes of HBM transient).
    chunk = min(131_072, n)
    n_pad = -(-n // chunk) * chunk
    xp = jnp.pad(rows_full, ((0, n_pad - n), (0, 0))).reshape(-1, chunk, d)

    def qbody(_, xc):
        xf = xc.astype(jnp.float32)
        s = jnp.max(jnp.abs(xf), axis=1) / 127.0
        s = jnp.where(s == 0, 1.0, s)
        q = jnp.clip(jnp.round(xf / s[:, None]), -127, 127).astype(jnp.int8)
        return None, (q, s)

    _, (q_all, scales) = jax.lax.scan(qbody, None, xp)
    q_all = q_all.reshape(-1, d)[:n]
    scales = scales.reshape(-1)[:n].astype(jnp.float32)

    order = jnp.argsort(assign)  # jax sort is stable
    sorted_assign = assign[order]
    counts = jnp.bincount(assign, length=k_clusters)
    starts = (jnp.cumsum(counts) - counts).astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32) - starts[sorted_assign]
    in_bucket = pos < cap
    trash = k_clusters * cap
    slot = jnp.where(in_bucket, sorted_assign * cap + pos, trash)

    q_sorted = q_all[order]
    scales_sorted = scales[order]
    rows_sorted = order.astype(jnp.int32)

    buckets_flat = jnp.zeros((trash + 1, d), jnp.int8).at[slot].set(q_sorted)
    bscales = jnp.zeros((trash + 1,), jnp.float32).at[slot].set(scales_sorted)
    brows = jnp.full((trash + 1,), -1, jnp.int32).at[slot].set(rows_sorted)
    buckets = buckets_flat[:-1].reshape(k_clusters, cap, d).transpose(0, 2, 1)

    ov_rank = jnp.cumsum((~in_bucket).astype(jnp.int32)) - 1
    oslot = jnp.where(in_bucket, o_pad, jnp.minimum(ov_rank, o_pad))
    over_flat = jnp.zeros((o_pad + 1, d), jnp.int8).at[oslot].set(q_sorted)
    over_scales = jnp.zeros((o_pad + 1,), jnp.float32).at[oslot].set(scales_sorted)
    over_rows = jnp.full((o_pad + 1,), -1, jnp.int32).at[oslot].set(rows_sorted)

    return (
        buckets,
        bscales[:-1].reshape(k_clusters, cap),
        brows[:-1].reshape(k_clusters, cap),
        over_flat[:-1].T,
        over_scales[:-1],
        over_rows[:-1],
    )


def build_ivf_device(
    rows_full: jnp.ndarray,
    k_clusters: Optional[int] = None,
    capacity_factor: float = 1.5,
    nprobe: int = 32,
    iters: int = 12,
    seed: int = 0,
    centroids: Optional[jnp.ndarray] = None,
) -> IVFIndex:
    """Build an IVFIndex entirely on device from the resident (N, D) rows.

    Functionally equivalent to :func:`build_ivf` but never touches host
    numpy: k-means, assignment, quantization, and the balanced scatter all
    run as jitted programs, so a refresh on a 1M-row index takes seconds of
    device time instead of minutes of host bandwidth. The only host sync is
    one scalar (the spill count) that sizes the overflow block exactly.

    ``centroids``: pass a previous build's centroids to skip retraining —
    the incremental-refresh path (rows were appended, distribution barely
    moved) reassigns against the old centroids in one pass.
    """
    n, d = rows_full.shape
    if k_clusters is None:
        k_clusters = int(max(8, min(2 * int(np.sqrt(n)), n // 8 or 8)))
    k_clusters = max(1, min(k_clusters, n))
    nprobe = max(1, min(nprobe, k_clusters))
    cap = int(-(-(n / k_clusters * capacity_factor) // 1))
    cap = max(8, -(-cap // 8) * 8)

    if centroids is not None and centroids.shape == (k_clusters, d):
        cent = jnp.asarray(centroids, jnp.float32)
        # assignment-only pass against the provided centroids (seeding
        # k-means with them would retrain)
        assign, spill = _ivf_assign_device(
            rows_full, cent, chunk=min(131_072, n), cap=cap
        )
    else:
        cent, assign, spill = _ivf_train_assign(
            rows_full,
            jax.random.PRNGKey(seed),
            k_clusters,
            iters,
            min(131_072, n),
            cap,
        )
    o_pad = max(128, -(-int(spill) // 128) * 128)  # host sync: one scalar

    buckets, bucket_scales, bucket_rows, over_t, over_scales, over_rows = (
        _ivf_fill_device(rows_full, assign, k_clusters, cap, o_pad)
    )
    return IVFIndex(
        centroids=cent,
        buckets=buckets,
        bucket_scales=bucket_scales,
        bucket_rows=bucket_rows,
        over_t=over_t,
        over_scales=over_scales,
        over_rows=over_rows,
        nprobe=int(nprobe),
    )


# =============================================================================
# Search (one device program)
# =============================================================================


@functools.partial(jax.jit, static_argnames=("k", "nprobe"))
def ivf_topk_rerank(
    q_f32: jnp.ndarray,          # (Q, D) f32 queries
    centroids: jnp.ndarray,      # (K, D)
    buckets: jnp.ndarray,        # (K, D, C) int8
    bucket_scales: jnp.ndarray,  # (K, C)
    bucket_rows: jnp.ndarray,    # (K, C) int32
    over_t: jnp.ndarray,         # (D, O) int8
    over_scales: jnp.ndarray,    # (O,)
    over_rows: jnp.ndarray,      # (O,) int32
    rows_full: jnp.ndarray,      # (N_rows, D) storage-dtype full copy
    k: int,
    nprobe: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Probe top-``nprobe`` buckets + overflow, int8-score the gathered
    blocks, exact-rescore the candidates against ``rows_full``. Returned
    scores are identical to the exact int8+rescore path's for every row
    returned (same rescore construction, bit-level query rounding)."""
    q_count, d = q_f32.shape
    kk, _, cap = buckets.shape
    n_rows = rows_full.shape[0]

    qi, _ = quantize_queries_device(q_f32)

    # 1. probe: centroid scores (tiny matmul)
    cscores = q_f32 @ centroids.T  # (Q, K)
    _, probe = jax.lax.top_k(cscores, min(nprobe, kk))  # (Q, P)

    # 2. gather probed blocks and score. vmap over queries: each gathers its
    #    own (P, D, C) slab; scored as int8 dot with f32 scale fold.
    def score_one(qi_row, probe_row):
        slab = buckets[probe_row]            # (P, D, C) int8
        sc = bucket_scales[probe_row]        # (P, C)
        rid = bucket_rows[probe_row]         # (P, C)
        slab_t = jnp.transpose(slab, (1, 0, 2)).reshape(d, -1)  # (D, P*C)
        acc = jax.lax.dot_general(
            qi_row[None, :], slab_t,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # (1, P*C) int8 dot, exact int32 accumulation
        s = acc[0].astype(jnp.float32) * sc.reshape(-1)
        return s, rid.reshape(-1)

    bucket_s, bucket_r = jax.vmap(score_one)(qi, probe)  # (Q, P*C)

    # 3. overflow block (shared across queries)
    over_acc = jax.lax.dot_general(
        qi, over_t,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * over_scales[None, :]  # (Q, O)
    over_r = jnp.broadcast_to(over_rows[None, :], (q_count, over_rows.shape[0]))

    cand_s = jnp.concatenate([bucket_s, over_acc], axis=1)
    cand_r = jnp.concatenate([bucket_r, over_r], axis=1)
    cand_s = jnp.where(cand_r < 0, _NEG_INF, cand_s)

    # 4. shortlist then exact rescore (same construction as
    #    topk_int8_rerank_fused: bit-rounded query, f32 dot)
    m = min(max(4 * k, 64), cand_s.shape[1])
    top_s, pos = jax.lax.top_k(cand_s, m)
    cand = jnp.take_along_axis(cand_r, pos, axis=1)
    safe = jnp.clip(cand, 0, n_rows - 1)
    if rows_full.dtype == jnp.bfloat16:
        qr = round_f32_to_bf16_bits(q_f32.astype(jnp.float32))
    else:
        qr = q_f32.astype(jnp.float32)
    gathered = rows_full[safe].astype(jnp.float32)
    # Exact for bf16 rows at default precision (TF32 holds bf16 values);
    # f32 rows need HIGHEST (ops/topk_int8._rescore_select).
    precision = None if rows_full.dtype == jnp.bfloat16 else jax.lax.Precision.HIGHEST
    exact = jnp.einsum("qmd,qd->qm", gathered, qr, preferred_element_type=jnp.float32,
                       precision=precision)
    invalid = (cand < 0) | (cand >= n_rows) | jnp.isneginf(top_s)
    exact = jnp.where(invalid, _NEG_INF, exact)
    sort_rows = jnp.where(invalid, jnp.iinfo(jnp.int32).max, cand)
    k_eff = min(k, m)
    order = jnp.lexsort((sort_rows, -exact), axis=-1)[:, :k_eff]
    return (
        jnp.take_along_axis(exact, order, axis=1),
        jnp.take_along_axis(sort_rows, order, axis=1),
    )


def ivf_search(index: IVFIndex, rows_full, q_f32, k: int):
    """Convenience wrapper binding an IVFIndex's arrays."""
    return ivf_topk_rerank(
        jnp.asarray(q_f32), index.centroids, index.buckets,
        index.bucket_scales, index.bucket_rows, index.over_t,
        index.over_scales, index.over_rows, rows_full, k, index.nprobe,
    )

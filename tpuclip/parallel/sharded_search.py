"""Mesh-sharded brute-force search.

The embedding rows are sharded across the ``data`` axis; each device
computes a local fused matmul+top-k over its shard, the (ndev × k) candidate
sets ride one small ``all_gather`` (NCCL between GPUs, which are joined all to
all), and every device reduces them to the global top-k. Communication is
O(ndev·Q·k), independent of N — the scan itself never crosses devices.

This replaces "scale" for the reference's single-host sqlite-vec scan
(image_database.py:1567): the index's rows split evenly over the devices.

Layouts: the float matrix is feature-major (D, N), column-sharded; the int8
matrix, its scales, the full-precision rescore rows and the packed binary
words are row-major, row-sharded.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuclip.parallel.mesh import DATA_AXIS
from tpuclip.ops.topk import topk_xla
from tpuclip.ops.topk_int8 import (
    quantize_queries_device,
    round_f32_to_bf16_bits,
    topk_int8_scan,
)


def shard_matrix(matrix_t: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Place the feature-major (D, N) matrix column-sharded over the data
    axis. N must divide evenly; callers pad zero columns and mask via
    n_valid."""
    return jax.device_put(matrix_t, NamedSharding(mesh, P(None, DATA_AXIS)))


def pad_for_mesh(matrix_t, mesh: Mesh):
    """Pad columns to a multiple of the data-axis size; returns
    (padded, n_valid)."""
    import numpy as np

    ndev = mesh.shape[DATA_AXIS]
    n = matrix_t.shape[1]
    rem = (-n) % ndev
    if rem:
        matrix_t = np.concatenate(
            [matrix_t, np.zeros(matrix_t.shape[:1] + (rem,), matrix_t.dtype)], axis=1
        )
    return matrix_t, n


def _pad_local_candidates(s, i, k_eff, sentinel_score):
    """Pad a shard's local top-k to k_eff columns: when k exceeds the
    per-shard row count the local kernels return fewer candidates, and the
    cross-shard merge reshape expects exactly k_eff per shard."""
    pad = k_eff - s.shape[1]
    if pad > 0:
        s = jnp.pad(s, ((0, 0), (0, pad)), constant_values=sentinel_score)
        i = jnp.pad(i, ((0, 0), (0, pad)), constant_values=jnp.iinfo(jnp.int32).max)
    return s, i


def _merge_shard_candidates(s, gi, ndev, k_eff, sentinel_score=-jnp.inf):
    """Shared cross-shard candidate merge (runs inside shard_map): pad local
    (Q, <=k_eff) candidates, all_gather over the data axis, and reduce the
    (ndev*k_eff) pool to the global top-k with (score desc, idx asc)
    ordering. Used by the float, int8, and int8+rerank impls."""
    s, gi = _pad_local_candidates(s, gi, k_eff, sentinel_score)
    s_all = jax.lax.all_gather(s, DATA_AXIS)
    i_all = jax.lax.all_gather(gi, DATA_AXIS)
    q_count = s.shape[0]
    s_flat = jnp.transpose(s_all, (1, 0, 2)).reshape(q_count, ndev * k_eff)
    i_flat = jnp.transpose(i_all, (1, 0, 2)).reshape(q_count, ndev * k_eff)
    top_s, pos = jax.lax.top_k(s_flat, k_eff)
    top_i = jnp.take_along_axis(i_flat, pos, axis=1)
    order = jnp.lexsort((top_i, -top_s), axis=-1)
    return (
        jnp.take_along_axis(top_s, order, axis=1),
        jnp.take_along_axis(top_i, order, axis=1),
    )


@functools.partial(jax.jit, static_argnames=("k", "mesh", "has_mask"))
def _sharded_topk_impl(
    queries: jnp.ndarray,
    matrix_t: jnp.ndarray,
    k: int,
    mesh: Mesh,
    n_valid: jnp.ndarray,
    mask: jnp.ndarray,
    has_mask: bool,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    n_total = matrix_t.shape[1]
    ndev = mesh.shape[DATA_AXIS]
    shard_cols = n_total // ndev
    k_eff = min(k, n_total)

    def local(q, m_shard, n_valid, mask_shard):
        my = jax.lax.axis_index(DATA_AXIS)
        base = my * shard_cols
        local_mask = mask_shard[0] if has_mask else None
        # n_valid must reach the scan shard-locally: zero-padded columns
        # score exactly 0 and would otherwise evict real negative-scoring
        # rows from the local top-k BEFORE the post-hoc gi < n_valid mask
        # runs (same failure mode fixed in _sharded_int8_rerank_impl).
        local_nv = jnp.clip(n_valid - base, 0, shard_cols)
        s, i = topk_xla(q, m_shard, k_eff, mask=local_mask, n_valid=local_nv)
        # mask local candidates that fall past the valid column count
        gi = i + base
        s = jnp.where(gi < n_valid, s, -jnp.inf)
        return _merge_shard_candidates(s, gi, ndev, k_eff)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(None, DATA_AXIS), P(), P(None, DATA_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )(queries, matrix_t, n_valid.astype(jnp.int32), mask)


def sharded_topk(
    queries: jnp.ndarray,
    matrix_t: jnp.ndarray,
    k: int,
    mesh: Mesh,
    n_valid: jnp.ndarray,
    mask=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Distributed top-k. queries (Q, D) replicated; matrix_t (D, N)
    column-sharded over ``data``; optional additive ``mask`` (N,) (folder
    filters), sharded alongside the matrix.

    Returns (scores, global_idx) each (Q, k), identical to a single-device
    scan over the unsharded matrix.
    """
    has_mask = mask is not None
    if mask is None:
        mask = jnp.zeros((1, matrix_t.shape[1]), jnp.float32)
    else:
        mask = jnp.reshape(mask, (1, -1)).astype(jnp.float32)
    return _sharded_topk_impl(queries, matrix_t, k, mesh, n_valid, mask, has_mask)


@functools.partial(jax.jit, static_argnames=("k", "mesh", "has_mask"))
def _sharded_topk_int8_impl(
    q_int8, matrix_int8, scales, q_scale, k, mesh, n_valid, mask, has_mask
):
    n_total = matrix_int8.shape[0]
    ndev = mesh.shape[DATA_AXIS]
    shard_rows = n_total // ndev
    k_eff = min(k, n_total)

    def local(q, m_shard, sc_shard, qs, n_valid, mask_shard):
        my = jax.lax.axis_index(DATA_AXIS)
        base = my * shard_rows
        local_mask = mask_shard[0] if has_mask else None
        # Shard-local n_valid: zero-padded rows score exactly 0 (their int8
        # row is all zeros) and would otherwise evict real negative-scoring
        # rows from the local top-k BEFORE the post-hoc gi < n_valid mask
        # runs (same fix as _sharded_int8_rerank_impl).
        local_nv = jnp.clip(n_valid - base, 0, shard_rows)
        s, i = topk_int8_scan(
            q, m_shard, sc_shard[0], qs, k_eff, n_valid=local_nv, mask=local_mask
        )
        gi = i + base
        s = jnp.where(gi < n_valid, s, -jnp.inf)
        return _merge_shard_candidates(s, gi, ndev, k_eff)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, None), P(None, DATA_AXIS), P(), P(), P(None, DATA_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )(q_int8, matrix_int8, scales, q_scale, n_valid.astype(jnp.int32), mask)


def sharded_topk_int8(
    q_int8, matrix_int8, scales, q_scale, k, mesh, n_valid, mask=None
):
    """Distributed int8 top-k: the (N, D) int8 matrix and its per-row
    scales row-sharded over ``data``; same candidate-merge as the float
    path. Pair with DeviceIndex's exact host re-rank for fp32-exact
    results."""
    has_mask = mask is not None
    if mask is None:
        mask = jnp.zeros((1, matrix_int8.shape[0]), jnp.float32)
    else:
        mask = jnp.reshape(mask, (1, -1)).astype(jnp.float32)
    scales2d = jnp.reshape(scales, (1, -1))
    return _sharded_topk_int8_impl(
        q_int8, matrix_int8, scales2d, q_scale, k, mesh, n_valid, mask, has_mask
    )


@functools.partial(jax.jit, static_argnames=("k", "shortlist", "mesh"))
def _sharded_int8_rerank_impl(
    q_f32, matrix_int8, scales, rows_full, k, shortlist, mesh, n_valid
):
    n_total = matrix_int8.shape[0]
    ndev = mesh.shape[DATA_AXIS]
    shard_rows = n_total // ndev
    k_eff = min(k, n_total)
    # Shortlist must cover the requested k within each shard (callers gate
    # k; direct API users with large k still get a covering depth).
    m_local = min(max(shortlist, k_eff), shard_rows)

    def local(q, m_shard, sc_shard, rows_shard, n_valid):
        my = jax.lax.axis_index(DATA_AXIS)
        base = my * shard_rows
        # Shortlist scan skips the (rank-invariant) query scale; the rescore
        # below produces the exact returned scores. n_valid must reach the
        # scan shard-locally: zero-padded rows score exactly 0 and would
        # otherwise evict real negative-scoring rows from the shortlist
        # BEFORE the invalid mask runs.
        qi, _ = quantize_queries_device(q)
        local_nv = jnp.clip(n_valid - base, 0, shard_rows)
        s, i = topk_int8_scan(
            qi, m_shard, sc_shard[0], jnp.asarray(1.0, jnp.float32), m_local,
            n_valid=local_nv,
        )
        # Exact rescore against the LOCAL full-precision rows: indices are
        # shard-local, so no cross-shard gather — each device touches only
        # its own shortlist (a few hundred KB). The bit-level query rounding
        # is load-bearing: XLA's excess-precision rule elides astype(bf16)
        # into the dot, diverging from the bf16 scan's scores (see
        # ops/topk_int8._rescore_select, which also states why the default
        # precision is exact for bf16 rows and f32 rows need HIGHEST).
        safe = jnp.clip(i, 0, shard_rows - 1)
        if rows_shard.dtype == jnp.bfloat16:
            qr = round_f32_to_bf16_bits(q.astype(jnp.float32))
            precision = None
        else:
            qr = q.astype(jnp.float32)
            precision = jax.lax.Precision.HIGHEST
        gathered = rows_shard[safe].astype(jnp.float32)
        exact = jnp.einsum(
            "qmd,qd->qm", gathered, qr, preferred_element_type=jnp.float32,
            precision=precision,
        )
        gi = i + base
        invalid = jnp.isneginf(s) | (gi >= n_valid)
        exact = jnp.where(invalid, -jnp.inf, exact)
        gi = jnp.where(invalid, jnp.iinfo(jnp.int32).max, gi)
        # Per-shard exact top-k, then the usual O(ndev*Q*k) candidate merge:
        # the global exact top-k is the merge of per-shard exact top-ks.
        top_s, pos = jax.lax.top_k(exact, min(k_eff, m_local))
        top_i = jnp.take_along_axis(gi, pos, axis=1)
        return _merge_shard_candidates(top_s, top_i, ndev, k_eff)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),
            P(DATA_AXIS, None),
            P(None, DATA_AXIS),
            P(DATA_AXIS, None),
            P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )(q_f32, matrix_int8, scales, rows_full, n_valid.astype(jnp.int32))


def sharded_topk_int8_rerank(
    q_f32, matrix_int8, scales, rows_full, k, mesh, n_valid, shortlist=512
):
    """Distributed fused int8 scan + exact rescore (mesh analog of
    ops/topk_int8.topk_int8_rerank_fused): the (N_padded, D) int8 matrix,
    its scales and the full-precision ``rows_full`` (N_padded, D) all
    row-sharded over ``data`` (same padding), queries replicated. Each shard rescores its own
    int8 shortlist against its local rows, takes an exact per-shard top-k,
    and one all_gather merges candidates — scores returned are exact
    full-precision dots, identical ordering to the single-device fused path.
    """
    scales2d = jnp.reshape(scales, (1, -1))
    return _sharded_int8_rerank_impl(
        q_f32, matrix_int8, scales2d, rows_full, k, shortlist, mesh, n_valid
    )


@functools.partial(jax.jit, static_argnames=("k", "mesh", "has_mask"))
def _sharded_binary_topk_impl(query_words, matrix_words, k, mesh, n_valid, mask, has_mask):
    n_total = matrix_words.shape[0]
    ndev = mesh.shape[DATA_AXIS]
    shard_rows = n_total // ndev
    k_eff = min(k, n_total)
    sentinel = jnp.iinfo(jnp.int32).min

    from tpuclip.ops.hamming import binary_topk_packed

    def local(q, w_shard, n_valid, mask_shard):
        my = jax.lax.axis_index(DATA_AXIS)
        base = my * shard_rows
        local_mask = mask_shard[0] if has_mask else None
        s, i = binary_topk_packed(q, w_shard, k_eff, mask=local_mask)
        gi = i + base
        s = jnp.where(gi < n_valid, s, sentinel)
        s, gi = _pad_local_candidates(s, gi, k_eff, sentinel)
        s_all = jax.lax.all_gather(s, DATA_AXIS)
        i_all = jax.lax.all_gather(gi, DATA_AXIS)
        q_count = q.shape[0]
        s_flat = jnp.transpose(s_all, (1, 0, 2)).reshape(q_count, ndev * k_eff)
        i_flat = jnp.transpose(i_all, (1, 0, 2)).reshape(q_count, ndev * k_eff)
        # Integer popcount scores tie heavily across shards — exact
        # (score desc, idx asc) merge shared with the tiled kernel.
        from tpuclip.ops.hamming import _merge_int_candidates

        return _merge_int_candidates(s_flat, i_flat, k_eff)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, None), P(), P(None, DATA_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )(query_words, matrix_words, n_valid.astype(jnp.int32), mask)


def sharded_binary_topk(query_words, matrix_words, k, mesh, n_valid, mask=None):
    """Distributed packed-binary top-k: (N, W) uint32 words ROW-sharded over
    ``data`` (the packed layout is row-major, unlike the feature-major float
    matrix); local AND+popcount scan per shard, O(ndev*Q*k) candidate merge.
    Integer-exact parity with the single-device binary fallback
    (image_database.py:1591-1629 semantics): padded/masked rows score as
    int32 min and are dropped by callers."""
    has_mask = mask is not None
    if mask is None:
        mask = jnp.zeros((1, matrix_words.shape[0]), jnp.float32)
    else:
        mask = jnp.reshape(mask, (1, -1)).astype(jnp.float32)
    return _sharded_binary_topk_impl(
        query_words, matrix_words, k, mesh, n_valid, mask, has_mask
    )


class ShardedIndex:
    """Convenience wrapper: host (N, D) matrix → mesh-resident sharded index
    (stored feature-major)."""

    def __init__(self, matrix, mesh: Mesh, dtype=jnp.bfloat16):
        import numpy as np

        padded, n = pad_for_mesh(np.ascontiguousarray(np.asarray(matrix).T), mesh)
        self.mesh = mesh
        self.n_valid = jnp.asarray(n, jnp.int32)
        self.matrix = shard_matrix(jnp.asarray(padded, dtype=dtype), mesh)

    def search(self, queries, k: int, mask=None):
        q = jnp.asarray(queries, self.matrix.dtype)
        return sharded_topk(q, self.matrix, k, self.mesh, self.n_valid, mask=mask)

"""Mesh-sharded IVF approximate search.

The flat bf16, int8, int8+rerank, and packed-binary indexes are
mesh-sharded in parallel/sharded_search.py; this module shards the IVF
structures (index/ivf.py) over the ``data`` axis by CLUSTER — the natural
decomposition, because every per-cluster array is already a fixed-capacity
block with static shapes:

- ``centroids`` stay REPLICATED (K x D f32 is ~9 MB at K=2048 — tiny), so
  probing needs no communication.
- ``buckets``/``bucket_scales``/``bucket_rows`` shard over their leading
  cluster axis: each device owns K/ndev whole buckets.
- ``bucket_rows_full`` — NEW: a storage-dtype copy of each bucket row's
  full-precision vector, embedded in bucket layout (K, C, D) and sharded
  alongside. IVF bucket rows are scattered over the global row space, so a
  shard-local exact rescore needs shard-local full vectors; embedding them
  costs capacity_factor x the flat row copy but keeps the rescore gather
  on-device (the cross-device alternative — an all-to-all row fetch per
  query — would put the gathers on the interconnect's critical path).
- the overflow block splits by column across devices; every query scans
  its local slice (the "no row unreachable" contract survives sharding).

Probe semantics under sharding: each shard probes its local top-P buckets
with P = ceil(nprobe / ndev), so >= nprobe buckets are probed in total and
per-device work is the single-device cost / ndev. This is deliberately NOT
"global top-nprobe": selecting a data-dependent number of buckets per
shard would need dynamic shapes (ragged gathers) that XLA cannot tile. The
forced per-shard spread probes a superset-sized, slightly different bucket
set; with nprobe >= ndev it measures equal-or-better recall (every probed
region gets covered; no shard can starve). With nprobe = K (probe
everything) the result is EXACTLY the fused exact scan's — tested.

Communication: ONE all_gather of (ndev, Q, k) exact-rescored candidates —
identical merge contract to parallel/sharded_search.py.

Reference scale note: the reference scans every vector per query on one
host (image_database.py:1564-1574); here the int8 buckets take ~1.7 KB per
row at the default capacity factor, split over the devices, and the probe
cost is independent of N.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuclip.index.ivf import IVFIndex
from tpuclip.ops.topk_int8 import quantize_queries_device, round_f32_to_bf16_bits
from tpuclip.parallel.mesh import DATA_AXIS
from tpuclip.parallel.sharded_search import _merge_shard_candidates

_NEG_INF = float("-inf")


class ShardedIVF(NamedTuple):
    """IVFIndex resharded for a mesh, with embedded full-precision rows."""

    centroids: jnp.ndarray         # (K, D) f32, replicated
    buckets: jnp.ndarray           # (K, D, C) int8, cluster-sharded
    bucket_scales: jnp.ndarray     # (K, C) f32, cluster-sharded
    bucket_rows: jnp.ndarray       # (K, C) int32 global ids, cluster-sharded
    bucket_rows_full: jnp.ndarray  # (K, C, D) storage dtype, cluster-sharded
    over_t: jnp.ndarray            # (D, O) int8, column-sharded
    over_scales: jnp.ndarray       # (O,) f32, sharded
    over_rows: jnp.ndarray         # (O,) int32, sharded
    over_rows_full: jnp.ndarray    # (O, D) storage dtype, row-sharded
    nprobe: int
    mesh: Mesh
    n_rows: int
    k_real: int  # clusters before mesh padding; padded probe lanes mask out


def _pad_axis(x: np.ndarray, axis: int, mult: int, fill=0):
    rem = (-x.shape[axis]) % mult
    if not rem:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, constant_values=fill)


def shard_ivf(index: IVFIndex, rows_full: jnp.ndarray, mesh: Mesh) -> ShardedIVF:
    """Reshard a built IVFIndex onto ``mesh`` and embed full-precision rows.

    The build itself (k-means, assignment, balanced fill) runs wherever
    ``build_ivf``/``build_ivf_device`` ran; this placement step pads the
    cluster and overflow axes to the mesh size, gathers each bucket slot's
    full vector out of ``rows_full``, and device_puts every array with its
    sharding. Empty (padding) slots carry zero vectors and row id -1 —
    scored to -inf at query time like the single-device path.
    """
    ndev = mesh.shape[DATA_AXIS]
    # Centroids MUST pad in lockstep with the cluster axis: a shorter
    # centroid array misaligns the boundary shard's dynamic_slice (JAX
    # clamps the out-of-range start), mapping centroid i's score to bucket
    # i+pad and making whole real clusters unsearchable whenever K % ndev
    # != 0 (review r3 finding, reproduced: recall 0.0 for the boundary
    # cluster at K=11 on 8 devices). Padding centroids are additionally
    # masked to -inf at probe time (k_real below) so they never consume a
    # probe slot a real bucket could use.
    cent = _pad_axis(np.asarray(index.centroids, np.float32), 0, ndev)
    buckets = _pad_axis(np.asarray(index.buckets), 0, ndev)
    bscales = _pad_axis(np.asarray(index.bucket_scales), 0, ndev)
    brows = _pad_axis(np.asarray(index.bucket_rows), 0, ndev, fill=-1)
    over_t = _pad_axis(np.asarray(index.over_t), 1, ndev)
    over_scales = _pad_axis(np.asarray(index.over_scales), 0, ndev)
    over_rows = _pad_axis(np.asarray(index.over_rows), 0, ndev, fill=-1)

    rows_host = np.asarray(rows_full)
    n_rows, d = rows_host.shape
    safe_b = np.clip(brows, 0, n_rows - 1)
    bfull = np.where(
        (brows >= 0)[:, :, None], rows_host[safe_b], np.zeros((), rows_host.dtype)
    )  # (K, C, D)
    safe_o = np.clip(over_rows, 0, n_rows - 1)
    ofull = np.where(
        (over_rows >= 0)[:, None], rows_host[safe_o], np.zeros((), rows_host.dtype)
    )  # (O, D)

    def put(x, spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

    return ShardedIVF(
        centroids=put(cent, P()),
        buckets=put(buckets, P(DATA_AXIS)),
        bucket_scales=put(bscales, P(DATA_AXIS)),
        bucket_rows=put(brows, P(DATA_AXIS)),
        bucket_rows_full=put(bfull, P(DATA_AXIS)),
        over_t=put(over_t, P(None, DATA_AXIS)),
        over_scales=put(over_scales, P(DATA_AXIS)),
        over_rows=put(over_rows, P(DATA_AXIS)),
        over_rows_full=put(ofull, P(DATA_AXIS)),
        nprobe=int(index.nprobe),
        mesh=mesh,
        n_rows=int(n_rows),
        k_real=int(index.centroids.shape[0]),
    )


@functools.partial(
    jax.jit, static_argnames=("k", "nprobe", "mesh", "n_rows", "k_real")
)
def _sharded_ivf_impl(
    q_f32,
    centroids,
    buckets,
    bucket_scales,
    bucket_rows,
    bucket_rows_full,
    over_t,
    over_scales,
    over_rows,
    over_rows_full,
    k: int,
    nprobe: int,
    mesh: Mesh,
    n_rows: int,
    k_real: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    ndev = mesh.shape[DATA_AXIS]
    kk_total = buckets.shape[0]
    kk_local = kk_total // ndev
    p_local = max(1, min(-(-nprobe // ndev), kk_local))
    k_eff = min(k, n_rows)

    def local(q, cent, bks, bsc, brw, bfl, ovt, ovs, ovr, ofl):
        my = jax.lax.axis_index(DATA_AXIS)
        d = q.shape[1]
        q_count = q.shape[0]
        cap = bks.shape[2]
        qi, _ = quantize_queries_device(q)

        # 1. probe MY clusters: local slice of the replicated (padded)
        #    centroids; padding clusters (global id >= k_real) score -inf so
        #    every probe slot goes to a real bucket when one exists.
        cent_local = jax.lax.dynamic_slice_in_dim(cent, my * kk_local, kk_local, 0)
        cscores = q @ cent_local.T  # (Q, K_local)
        cid = my * kk_local + jax.lax.broadcasted_iota(
            jnp.int32, cscores.shape, 1
        )
        cscores = jnp.where(cid < k_real, cscores, _NEG_INF)
        _, probe = jax.lax.top_k(cscores, p_local)  # (Q, P)

        # 2. score gathered local buckets (int8 dot, exact int32 acc).
        def score_one(qi_row, probe_row):
            slab = bks[probe_row]                 # (P, D, C) int8
            sc = bsc[probe_row]                   # (P, C)
            rid = brw[probe_row]                  # (P, C)
            slab_t = jnp.transpose(slab, (1, 0, 2)).reshape(d, -1)
            acc = jax.lax.dot_general(
                qi_row[None, :], slab_t,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            return acc[0].astype(jnp.float32) * sc.reshape(-1), rid.reshape(-1)

        bucket_s, bucket_r = jax.vmap(score_one)(qi, probe)  # (Q, P*C)

        # 3. MY slice of the overflow block.
        over_acc = jax.lax.dot_general(
            qi, ovt,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32) * ovs[None, :]
        over_r = jnp.broadcast_to(ovr[None, :], (q_count, ovr.shape[0]))

        cand_s = jnp.concatenate([bucket_s, over_acc], axis=1)
        cand_r = jnp.concatenate([bucket_r, over_r], axis=1)
        cand_s = jnp.where(cand_r < 0, _NEG_INF, cand_s)

        # 4. shortlist, then exact rescore against the EMBEDDED local rows
        #    (no cross-device row fetch; same bit-rounded-query contract as
        #    ops/topk_int8.topk_int8_rerank_fused).
        m = min(max(4 * k_eff, 64), cand_s.shape[1])
        top_s, pos = jax.lax.top_k(cand_s, m)
        cand = jnp.take_along_axis(cand_r, pos, axis=1)  # global row ids

        def gather_exact_one(probe_row, pos_row):
            slab_full = bfl[probe_row].reshape(-1, d)        # (P*C, D)
            all_full = jnp.concatenate([slab_full, ofl], axis=0)
            return all_full[pos_row]                          # (m, D)

        gathered = jax.vmap(gather_exact_one)(probe, pos).astype(jnp.float32)
        # Exact for bf16 rows at default precision (TF32 holds bf16
        # values); f32 rows need HIGHEST (ops/topk_int8._rescore_select).
        if bfl.dtype == jnp.bfloat16:
            qr = round_f32_to_bf16_bits(q.astype(jnp.float32))
            precision = None
        else:
            qr = q.astype(jnp.float32)
            precision = jax.lax.Precision.HIGHEST
        exact = jnp.einsum(
            "qmd,qd->qm", gathered, qr, preferred_element_type=jnp.float32,
            precision=precision,
        )
        invalid = (cand < 0) | (cand >= n_rows) | jnp.isneginf(top_s)
        exact = jnp.where(invalid, _NEG_INF, exact)
        gi = jnp.where(invalid, jnp.iinfo(jnp.int32).max, cand)

        # 5. per-shard exact top-k with the (score desc, idx asc) contract,
        #    then the standard O(ndev*Q*k) merge.
        order = jnp.lexsort((gi, -exact), axis=-1)[:, : min(k_eff, m)]
        top_es = jnp.take_along_axis(exact, order, axis=1)
        top_ei = jnp.take_along_axis(gi, order, axis=1)
        return _merge_shard_candidates(top_es, top_ei, ndev, k_eff)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),              # queries replicated
            P(),              # centroids replicated
            P(DATA_AXIS),     # buckets
            P(DATA_AXIS),     # bucket_scales
            P(DATA_AXIS),     # bucket_rows
            P(DATA_AXIS),     # bucket_rows_full
            P(None, DATA_AXIS),  # over_t
            P(DATA_AXIS),     # over_scales
            P(DATA_AXIS),     # over_rows
            P(DATA_AXIS),     # over_rows_full
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )(
        q_f32, centroids, buckets, bucket_scales, bucket_rows,
        bucket_rows_full, over_t, over_scales, over_rows, over_rows_full,
    )


def sharded_ivf_search(
    index: ShardedIVF, q_f32, k: int, nprobe: int | None = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k over a mesh-sharded IVF index.

    Each shard probes its local top-ceil(nprobe/ndev) buckets plus its
    overflow slice, exact-rescores its candidates against the embedded
    full-precision rows, and one all_gather merges (Q, k) per shard into
    the global (score desc, idx asc) top-k. Returned scores are exact
    full-precision dots — identical values to the flat exact path for
    every row returned.
    """
    return _sharded_ivf_impl(
        jnp.asarray(q_f32, jnp.float32),
        index.centroids, index.buckets, index.bucket_scales,
        index.bucket_rows, index.bucket_rows_full, index.over_t,
        index.over_scales, index.over_rows, index.over_rows_full,
        k, int(nprobe if nprobe is not None else index.nprobe),
        index.mesh, index.n_rows, index.k_real,
    )

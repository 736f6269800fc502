"""Matmul + top-k over a device-resident embedding matrix.

The device replacement for sqlite-vec's brute-force
``vec_distance_cosine ... ORDER BY distance LIMIT k`` scan
(image_database.py:1564-1574).

**Layout**: the float matrix is stored TRANSPOSED, (D, N) — "feature-major",
pre-padded with zero columns (:func:`pad_matrix_t`) and masked past
``n_valid``. :func:`topk_xla` materializes the (Q, N) scores and selects with
``jax.lax.top_k``.

Ordering semantics: descending score; ties resolve to the lowest index first,
matching a stable ``ORDER BY distance ASC`` scan.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

DEFAULT_TILE_N = 2048
_NEG_INF = float("-inf")


@functools.partial(jax.jit, static_argnames=("k",))
def topk_xla(
    queries: jnp.ndarray,
    matrix_t: jnp.ndarray,
    k: int,
    mask: Optional[jnp.ndarray] = None,
    n_valid: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference/general path: full score materialization + lax.top_k.

    ``matrix_t``: (D, N) transposed matrix. ``mask``: optional (N,) float32
    additive mask (0 or -inf) for folder filtering (image_database.py:
    1513-1529 semantics, applied pre-top-k). ``n_valid`` masks zero-padded
    tail columns (see :func:`pad_matrix_t`).
    """
    n = matrix_t.shape[1]
    k_eff = min(k, n) if n > 0 else 0
    if k_eff == 0:
        return (
            jnp.zeros((queries.shape[0], 0), jnp.float32),
            jnp.zeros((queries.shape[0], 0), jnp.int32),
        )
    # An f32 matrix is scored in full f32 (a GPU would otherwise run the
    # product in TF32, ~3 decimal digits); a bf16 matrix is exact in bf16.
    scores = jnp.dot(
        queries.astype(matrix_t.dtype), matrix_t,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if mask is not None:
        scores = scores + mask[None, :]
    if n_valid is not None:
        col = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
        scores = jnp.where(col < n_valid, scores, _NEG_INF)
    top_scores, top_idx = jax.lax.top_k(scores, k_eff)
    order = jnp.lexsort((top_idx, -top_scores), axis=-1)
    return (
        jnp.take_along_axis(top_scores, order, axis=1),
        jnp.take_along_axis(top_idx, order, axis=1).astype(jnp.int32),
    )


def pad_matrix_t(matrix_t, tile_n: int = DEFAULT_TILE_N):
    """Host-side: pad (D, N) with zero columns to a tile multiple.

    Returns (padded, n_valid). Doing this once at upload time keeps the
    per-query path copy-free.
    """
    import numpy as np

    d, n = matrix_t.shape
    rem = (-n) % tile_n
    if rem:
        matrix_t = np.concatenate(
            [matrix_t, np.zeros((d, rem), matrix_t.dtype)], axis=1
        )
    return matrix_t, n


# The public search entry point: every platform scores through XLA.
cosine_topk = topk_xla

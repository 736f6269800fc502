"""Binary-embedding scoring on device.

The reference's binary fallback fetches every BLOB into Python and computes
``np.dot(query_bits, cand_bits)`` per row (image_database.py:1616-1625). The
binary "score" is the count of positions where both sign bits are 1,
normalized by the dimension (NOT true Hamming similarity — kept for parity).

Device form: sign bits stay packed 32 to a uint32 word (1 bit/dim); the
score for all N rows is AND + popcount + sum, exact integer math. Top-k
reuses the same ordering machinery as the float path.

Also provides packed-uint8 Hamming distance (XOR+popcount) used by the
duplicate filter when comparing pairs on host.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("k",))
def binary_topk(
    query_bits: jnp.ndarray,
    matrix_bits_t: jnp.ndarray,
    k: int,
    mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unpacked path: query_bits (Q, D) int8 {0,1}; matrix_bits_t (D, N) int8
    {0,1} (feature-major). One int8 matmul, exact int32 accumulation.

    Returns (matches (Q,k) int32, idx (Q,k) int32), descending, ties to the
    lowest index. matches/D is the reference's similarity score
    (image_database.py:1621-1624). Prefer :func:`binary_topk_packed` for
    device residency (16x less HBM).
    """
    n = matrix_bits_t.shape[1]
    k_eff = min(k, n) if n > 0 else 0
    if k_eff == 0:
        q = query_bits.shape[0]
        return jnp.zeros((q, 0), jnp.int32), jnp.zeros((q, 0), jnp.int32)
    scores = jnp.dot(
        query_bits.astype(jnp.int8), matrix_bits_t.astype(jnp.int8),
        preferred_element_type=jnp.int32,
    )
    if mask is not None:
        scores = jnp.where(mask[None, :] < 0, jnp.iinfo(jnp.int32).min, scores)
    top_scores, top_idx = jax.lax.top_k(scores, k_eff)
    return _merge_int_candidates(top_scores, top_idx.astype(jnp.int32), k_eff)


@functools.partial(jax.jit, static_argnames=("k",))
def binary_topk_packed(
    query_words: jnp.ndarray,
    matrix_words: jnp.ndarray,
    k: int,
    mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Packed path: query_words (Q, W) uint32/int32 packed bits;
    matrix_words (N, W) — 1 bit/dimension in HBM (144 B/row at 1152-d,
    vs 1152 B unpacked). matches = popcount(q & row) per row, exactly the
    reference's binary dot (image_database.py:1621); ``bitwise_count``
    does the counting. Same ordering semantics as the other kernels.
    """
    n = matrix_words.shape[0]
    k_eff = min(k, n) if n > 0 else 0
    if k_eff == 0:
        q = query_words.shape[0]
        return jnp.zeros((q, 0), jnp.int32), jnp.zeros((q, 0), jnp.int32)
    anded = jnp.bitwise_and(query_words[:, None, :], matrix_words[None, :, :])
    scores = jnp.sum(jnp.bitwise_count(anded).astype(jnp.int32), axis=-1)  # (Q, N)
    if mask is not None:
        scores = jnp.where(mask[None, :] < 0, jnp.iinfo(jnp.int32).min, scores)
    top_scores, top_idx = jax.lax.top_k(scores, k_eff)
    return _merge_int_candidates(top_scores, top_idx.astype(jnp.int32), k_eff)


def _merge_int_candidates(scores, idx, k_eff):
    """Exact merge for INTEGER-scored candidates: popcount scores tie
    heavily, and ``lax.top_k`` breaks ties by candidate position (shard
    order), not original index — a full (score desc, idx asc) sort of the
    small candidate buffer is required for reference-exact ordering."""
    # Clamp the INT32_MIN sentinel before negating (its negation wraps back
    # to INT32_MIN and would sort FIRST); real popcount scores are >= 0.
    sort_scores = jnp.maximum(scores, -1)
    order = jnp.lexsort((idx, -sort_scores), axis=-1)[:, :k_eff]
    return (
        jnp.take_along_axis(scores, order, axis=1),
        jnp.take_along_axis(idx, order, axis=1),
    )


def pack_bits_to_words(bits01: np.ndarray) -> np.ndarray:
    """(N, D) uint8 {0,1} → (N, ceil(D/32)) uint32 words (np.packbits order,
    zero-padded). Queries and matrices must both come through here so the
    bit order cancels in AND+popcount."""
    packed = np.packbits(np.atleast_2d(bits01).astype(np.uint8), axis=-1)
    pad = (-packed.shape[-1]) % 4
    if pad:
        packed = np.pad(packed, ((0, 0), (0, pad)))
    return packed.view(np.uint32)


# Bit weight of dimension j within a 32-bit word: np.packbits packs MSB-first
# within each byte, and the little-endian uint32 view makes byte b contribute
# at bit offset 8*b — so dim j lands at bit 8*(j//8) + (7 - j%8).
_WORD_BIT_WEIGHTS = np.array(
    [1 << (8 * (j // 8) + (7 - j % 8)) for j in range(32)], dtype=np.uint32
)


def pack_bits_to_words_device(bits01: jnp.ndarray) -> jnp.ndarray:
    """Device-side :func:`pack_bits_to_words`: (N, D) {0,1} ints →
    (N, ceil(D/32)) uint32, bit-identical to the host packer (verified in
    tests), so device-packed matrices interoperate with host-packed queries.
    Used when the sign bits already live on device (e.g. derived from a
    resident embedding matrix): on device the packing is one fused
    multiply-reduce instead of a host numpy pass over every row."""
    n, d = bits01.shape
    pad = (-d) % 32
    if pad:
        bits01 = jnp.pad(bits01, ((0, 0), (0, pad)))
    grouped = bits01.reshape(n, (d + pad) // 32, 32).astype(jnp.uint32)
    weights = jnp.asarray(_WORD_BIT_WEIGHTS)
    return jnp.sum(grouped * weights[None, None, :], axis=-1, dtype=jnp.uint32)


_POPCOUNT_TABLE = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def hamming_distance_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise-free Hamming distance between packed uint8 bit rows.

    a (..., W), b (..., W) → (...,) int32 distances. Host-side numpy (the
    duplicate filter compares only the k result rows); a native C++ popcount
    path exists in tpuclip.native for large batches.
    """
    x = np.bitwise_xor(a, b)
    return _POPCOUNT_TABLE[x].sum(axis=-1).astype(np.int32)


def hamming_matrix_packed(rows: np.ndarray) -> np.ndarray:
    """All-pairs Hamming distances for packed uint8 rows (n, W) → (n, n)."""
    x = np.bitwise_xor(rows[:, None, :], rows[None, :, :])
    return _POPCOUNT_TABLE[x].sum(axis=-1).astype(np.int32)


def pack_bits(bits01: np.ndarray) -> np.ndarray:
    """(N, D) uint8 {0,1} → (N, D//8) packed uint8 (np.packbits bit order)."""
    return np.packbits(bits01.astype(np.uint8), axis=-1)


def sign_bits(embedding: np.ndarray) -> np.ndarray:
    """Reference sign quantization: (e >= 0) (image_database.py:1189)."""
    return (np.asarray(embedding) >= 0).astype(np.uint8)

"""Top-k tests: matmul+top-k and packed-binary top-k vs numpy oracles
(SURVEY.md §4.2)."""

import numpy as np
import pytest

import jax

from conftest import assert_topk_oracle
import jax.numpy as jnp

from tpuclip.ops.topk import cosine_topk, pad_matrix_t, topk_xla


def _oracle(queries, matrix, k, mask=None):
    scores = queries.astype(np.float64) @ matrix.astype(np.float64).T
    if mask is not None:
        scores = scores + mask[None, :]
    k = min(k, matrix.shape[0])
    out_s = np.zeros((queries.shape[0], k), np.float64)
    out_i = np.zeros((queries.shape[0], k), np.int64)
    for q in range(queries.shape[0]):
        # sort by (-score, idx): descending score, ties to lowest index
        order = np.lexsort((np.arange(scores.shape[1]), -scores[q]))[:k]
        out_s[q] = scores[q][order]
        out_i[q] = order
    return out_s, out_i


@pytest.mark.parametrize("n,k", [(100, 10), (1000, 20), (5000, 7)])
def test_topk_xla_matches_oracle(n, k):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 64)).astype(np.float32)
    m = rng.standard_normal((n, 64)).astype(np.float32)
    s, i = topk_xla(jnp.asarray(q), jnp.asarray(m.T), k)
    es, ei = _oracle(q, m, k)
    assert_topk_oracle(i, ei, s, es)


def test_topk_xla_with_mask():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 32)).astype(np.float32)
    m = rng.standard_normal((500, 32)).astype(np.float32)
    mask = np.where(rng.random(500) < 0.5, 0.0, -np.inf).astype(np.float32)
    s, i = topk_xla(jnp.asarray(q), jnp.asarray(m.T), 15, mask=jnp.asarray(mask))
    es, ei = _oracle(q, m, 15, mask)
    np.testing.assert_array_equal(np.asarray(i), ei)


@pytest.mark.parametrize("n,k,qn", [(512, 10, 1), (2048, 20, 3), (3000, 5, 8), (700, 13, 2)])
def test_cosine_topk_padded_matrix_matches_oracle(n, k, qn):
    """The resident layout: (D, N) zero-padded to a tile multiple, masked
    past n_valid — padding columns (score 0) must never evict real
    negative-scoring rows, ragged N included."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((qn, 128)).astype(np.float32)
    m = rng.standard_normal((n, 128)).astype(np.float32)
    mt, nv = pad_matrix_t(np.ascontiguousarray(m.T), tile_n=512)
    s, i = cosine_topk(jnp.asarray(q), jnp.asarray(mt), k, n_valid=jnp.asarray(nv, jnp.int32))
    es, ei = _oracle(q, m, k)
    assert_topk_oracle(i, ei, s, es)


def test_cosine_topk_duplicate_scores_tiebreak():
    """Duplicate vectors must resolve ties to the lowest index, like a stable
    ORDER BY scan (image_database.py:1572)."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((4, 64)).astype(np.float32)
    m = np.tile(base, (64, 1))  # 256 rows, every score appears 64 times
    q = base[:1]
    s, i = cosine_topk(jnp.asarray(q), jnp.asarray(m.T), 8)
    es, ei = _oracle(q, m, 8)
    np.testing.assert_array_equal(np.asarray(i), ei)


def test_k_larger_than_n():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 16)).astype(np.float32)
    m = rng.standard_normal((5, 16)).astype(np.float32)
    s, i = cosine_topk(jnp.asarray(q), jnp.asarray(m.T), 10)
    assert s.shape == (1, 5)
    es, ei = _oracle(q, m, 10)
    np.testing.assert_array_equal(np.asarray(i), ei)


def test_empty_matrix():
    q = np.zeros((1, 16), np.float32)
    m = np.zeros((0, 16), np.float32)
    s, i = cosine_topk(jnp.asarray(q), jnp.asarray(m.T), 10)
    assert s.shape == (1, 0) and i.shape == (1, 0)


# ---------------------------------------------------------------------------
# Packed-binary top-k (row layout, (N, W) uint32 words)
# ---------------------------------------------------------------------------


def _binary_oracle(words, qwords, k, mask=None):
    """Integer-exact popcount(q & row) top-k, ties to the lowest index."""
    bits = np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), axis=1
    ).astype(np.int32)
    qbits = np.unpackbits(
        np.ascontiguousarray(qwords).view(np.uint8), axis=1
    ).astype(np.int32)
    scores = qbits @ bits.T
    out_s, out_i = [], []
    for row in scores:
        valid = np.arange(len(row)) if mask is None else np.nonzero(mask == 0)[0]
        order = valid[np.lexsort((valid, -row[valid]))][:k]
        out_s.append(row[order])
        out_i.append(order)
    return np.asarray(out_s), np.asarray(out_i)


def test_binary_topk_packed_matches_oracle():
    from tpuclip.ops.hamming import binary_topk_packed, pack_bits_to_words

    rng = np.random.default_rng(31)
    n, d, k = 5000, 1152, 20
    bits = (rng.standard_normal((n, d)) >= 0).astype(np.uint8)
    qbits = (rng.standard_normal((3, d)) >= 0).astype(np.uint8)
    words = pack_bits_to_words(bits)
    qwords = pack_bits_to_words(qbits)
    got_s, got_i = binary_topk_packed(jnp.asarray(qwords), jnp.asarray(words), k)
    ref_s, ref_i = _binary_oracle(words, qwords, k)
    np.testing.assert_array_equal(np.asarray(got_s), ref_s)
    np.testing.assert_array_equal(np.asarray(got_i), ref_i)


def test_binary_topk_packed_masked_matches_oracle():
    from tpuclip.ops.hamming import binary_topk_packed, pack_bits_to_words

    rng = np.random.default_rng(33)
    n, d, k = 777, 128, 9
    bits = (rng.standard_normal((n, d)) >= 0).astype(np.uint8)
    qbits = (rng.standard_normal((2, d)) >= 0).astype(np.uint8)
    words = pack_bits_to_words(bits)
    qwords = pack_bits_to_words(qbits)
    mask = np.where(np.arange(n) % 3 == 0, -np.inf, 0.0).astype(np.float32)
    got_s, got_i = binary_topk_packed(
        jnp.asarray(qwords), jnp.asarray(words), k, mask=jnp.asarray(mask)
    )
    ref_s, ref_i = _binary_oracle(words, qwords, k, mask)
    np.testing.assert_array_equal(np.asarray(got_s), ref_s)
    np.testing.assert_array_equal(np.asarray(got_i), ref_i)


def test_binary_topk_masked_rows_sort_last():
    """Regression (review r3): when the folder mask leaves fewer unmasked
    rows than k, the INT32_MIN sentinel's negation wrapped in lexsort and
    ranked masked rows FIRST — prefix-truncating consumers returned masked
    rows above real matches. Sentinels must sort last in every binary path."""
    from tpuclip.ops.hamming import binary_topk, binary_topk_packed, pack_bits_to_words

    rng = np.random.default_rng(44)
    n, d, k = 40, 64, 8
    bits = (rng.standard_normal((n, d)) >= 0).astype(np.uint8)
    qbits = (rng.standard_normal((1, d)) >= 0).astype(np.uint8)
    # mask all but 3 rows: k=8 > 3 unmasked -> 5 sentinel slots in top_k
    keep = {4, 17, 29}
    mask = np.asarray(
        [0.0 if i in keep else -np.inf for i in range(n)], np.float32
    )
    sentinel = np.iinfo(np.int32).min

    s, i = binary_topk(
        jnp.asarray(qbits.astype(np.int8)),
        jnp.asarray(bits.T.copy().astype(np.int8)),
        k, mask=jnp.asarray(mask),
    )
    s, i = np.asarray(s)[0], np.asarray(i)[0]
    assert set(i[:3].tolist()) == keep, f"real rows must lead: {i}"
    assert (s[:3] > sentinel).all() and (s[3:] == sentinel).all()

    words = pack_bits_to_words(bits)
    qwords = pack_bits_to_words(qbits)
    s, i = binary_topk_packed(
        jnp.asarray(qwords), jnp.asarray(words), k, mask=jnp.asarray(mask)
    )
    s, i = np.asarray(s)[0], np.asarray(i)[0]
    assert set(i[:3].tolist()) == keep
    assert (s[3:] == sentinel).all()


def test_binary_topk_packed_tie_ordering():
    """Popcount scores tie constantly — ties must go to the lowest index."""
    from tpuclip.ops.hamming import binary_topk_packed

    # Every row identical -> every score ties; expect indices 0..k-1.
    words = np.tile(np.array([[0xFFFFFFFF]], np.uint32), (300, 4))
    qwords = np.array([[0xFFFFFFFF] * 4], np.uint32)
    s, i = binary_topk_packed(jnp.asarray(qwords), jnp.asarray(words), 7)
    np.testing.assert_array_equal(np.asarray(i)[0], np.arange(7))
    np.testing.assert_array_equal(np.asarray(s)[0], np.full(7, 128))


@pytest.mark.parametrize("n", [5000, 2048, 2049])
def test_binary_topk_packed_single_query_matches_oracle(n):
    """The single-query case (the cascade prefilter's), ragged N included."""
    from tpuclip.ops.hamming import binary_topk_packed, pack_bits_to_words

    rng = np.random.default_rng(37)
    bits = (rng.standard_normal((n, 256)) >= 0).astype(np.uint8)
    qbits = (rng.standard_normal((1, 256)) >= 0).astype(np.uint8)
    words = pack_bits_to_words(bits)
    qwords = pack_bits_to_words(qbits)
    got_s, got_i = binary_topk_packed(jnp.asarray(qwords), jnp.asarray(words), 20)
    ref_s, ref_i = _binary_oracle(words, qwords, 20)
    np.testing.assert_array_equal(np.asarray(got_s), ref_s)
    np.testing.assert_array_equal(np.asarray(got_i), ref_i)


def test_pack_bits_to_words_device_matches_host():
    """Device packing must be bit-identical to the host packer — matrices
    packed on device are scored against host-packed queries."""
    import jax.numpy as jnp

    from tpuclip.ops.hamming import pack_bits_to_words, pack_bits_to_words_device

    rng = np.random.default_rng(7)
    for n, d in [(17, 70), (5, 1152), (1, 32), (3, 31)]:
        bits = rng.integers(0, 2, (n, d), dtype=np.uint8)
        host = pack_bits_to_words(bits)
        dev = np.asarray(pack_bits_to_words_device(jnp.asarray(bits)))
        np.testing.assert_array_equal(host, dev)

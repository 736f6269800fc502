"""Multi-chip logic on an 8-device virtual CPU mesh (SURVEY.md §4.5):
sharded search parity with single-device, DP inference, TP param sharding,
and the contrastive train step."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tpuclip.models import get_config, init_params
from tpuclip.models.siglip import get_image_features
from tpuclip.ops.topk import topk_xla
from tpuclip.parallel import make_mesh, param_shardings, shard_params
from tpuclip.parallel.mesh import DATA_AXIS, MODEL_AXIS
from tpuclip.parallel.sharded_search import ShardedIndex
from tpuclip.parallel.training import (
    init_train_state,
    make_optimizer,
    make_train_step,
    sigmoid_contrastive_loss,
)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
    return make_mesh(model_parallelism=1)


@pytest.fixture(scope="module")
def mesh4x2():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
    return make_mesh(model_parallelism=2)


def test_sharded_search_matches_single_device(mesh8):
    rng = np.random.default_rng(0)
    n, d, k = 10_000, 64, 17
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((3, d)).astype(np.float32)

    idx = ShardedIndex(matrix, mesh8, dtype=jnp.float32)
    s_sh, i_sh = idx.search(queries, k)

    s_ref, i_ref = topk_xla(jnp.asarray(queries), jnp.asarray(matrix.T), k)
    np.testing.assert_array_equal(np.asarray(i_sh), np.asarray(i_ref))
    np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_ref), rtol=1e-5, atol=1e-5)


def test_sharded_search_negative_scores_survive_padding(mesh8):
    """Regression (review r3): the sharded XLA scans did not pass a
    shard-local n_valid, so zero-padded columns (score exactly 0) evicted
    real NEGATIVE-scoring rows from the per-shard top-k before the post-hoc
    global mask ran — searches silently returned -inf placeholders instead
    of k real rows. Both the float and int8 local paths must return every
    real row when all similarities are negative."""
    from tpuclip.ops.topk_int8 import quantize_rows, quantize_query
    from tpuclip.parallel.sharded_search import (
        pad_for_mesh,
        shard_matrix,
        sharded_topk,
        sharded_topk_int8,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpuclip.parallel.mesh import DATA_AXIS

    rng = np.random.default_rng(9)
    n, d, k = 10, 32, 5
    query = rng.standard_normal((1, d)).astype(np.float32)
    query /= np.linalg.norm(query)
    # rows anti-aligned with the query: every true score is negative
    matrix = -np.abs(rng.standard_normal((n, 1))).astype(np.float32) * query
    matrix += 0.01 * rng.standard_normal((n, d)).astype(np.float32)

    mt = np.ascontiguousarray(matrix.T)
    rem = (-n) % 512  # large zero pad in every shard
    mt = np.concatenate([mt, np.zeros((d, rem), np.float32)], axis=1)
    mt, n_valid = pad_for_mesh(mt, mesh8)
    dev_matrix = shard_matrix(jnp.asarray(mt), mesh8)
    nv = jnp.asarray(n, jnp.int32)

    s, i = sharded_topk(jnp.asarray(query), dev_matrix, k, mesh8, nv)
    s = np.asarray(s)[0]
    assert np.isfinite(s).all(), f"padding evicted real rows: {s}"
    assert (s < 0).all()

    mq, scales = quantize_rows(mt.T)
    mq_dev = jax.device_put(
        jnp.asarray(mq), NamedSharding(mesh8, P(DATA_AXIS, None))
    )
    sc_dev = jax.device_put(
        jnp.asarray(scales), NamedSharding(mesh8, P(DATA_AXIS))
    )
    qi, qs = quantize_query(query)
    s8, i8 = sharded_topk_int8(
        jnp.asarray(qi), mq_dev, sc_dev, jnp.asarray(qs, jnp.float32), k,
        mesh8, nv,
    )
    s8 = np.asarray(s8)[0]
    assert np.isfinite(s8).all(), f"padding evicted real rows (int8): {s8}"
    assert (s8 < 0).all()


def test_sharded_search_ragged_padded_matches_single_device(mesh8):
    """A ragged index padded to a large per-shard multiple (the padding tail
    lands in the last shard) must match the single-device scan exactly."""
    from tpuclip.parallel.sharded_search import shard_matrix, sharded_topk

    rng = np.random.default_rng(5)
    n, d, k = 4100, 128, 11
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((2, d)).astype(np.float32)

    ndev = 8
    mt = np.ascontiguousarray(matrix.T)
    rem = (-mt.shape[1]) % (512 * ndev)
    mt_padded = np.concatenate([mt, np.zeros((d, rem), np.float32)], axis=1)
    dev_matrix = shard_matrix(jnp.asarray(mt_padded), mesh8)
    nv = jnp.asarray(n, jnp.int32)

    s_p, i_p = sharded_topk(jnp.asarray(queries), dev_matrix, k, mesh8, nv)
    s_ref, i_ref = topk_xla(jnp.asarray(queries), jnp.asarray(matrix.T), k)
    np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_ref))


def test_sharded_search_ragged_rows(mesh8):
    """Row count not divisible by the mesh: zero-padding must not leak."""
    rng = np.random.default_rng(1)
    n, d, k = 1003, 32, 10
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((1, d)).astype(np.float32)
    idx = ShardedIndex(matrix, mesh8, dtype=jnp.float32)
    s_sh, i_sh = idx.search(queries, k)
    s_ref, i_ref = topk_xla(jnp.asarray(queries), jnp.asarray(matrix.T), k)
    np.testing.assert_array_equal(np.asarray(i_sh), np.asarray(i_ref))
    assert np.asarray(i_sh).max() < n


def test_dp_inference_matches_single(mesh8):
    cfg = get_config("tpuclip/test-tiny")
    params = init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(2)
    batch = rng.integers(0, 256, size=(16, 56, 56, 3), dtype=np.uint8)

    single = np.asarray(get_image_features(params, jnp.asarray(batch), cfg))

    sharded_batch = jax.device_put(
        jnp.asarray(batch), NamedSharding(mesh8, P(DATA_AXIS, None, None, None))
    )
    dp = np.asarray(get_image_features(params, sharded_batch, cfg))
    np.testing.assert_allclose(dp, single, rtol=1e-4, atol=1e-5)


def test_tp_param_sharding_preserves_forward(mesh4x2):
    """TP-sharded params (heads/MLP over 'model') must not change outputs."""
    cfg = get_config("tpuclip/test-tiny")
    params = init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)
    batch = rng.integers(0, 256, size=(8, 56, 56, 3), dtype=np.uint8)
    base = np.asarray(get_image_features(params, jnp.asarray(batch), cfg))

    sharded = shard_params(params, mesh4x2)
    # verify something actually sharded over 'model'
    fc1 = sharded["vision"]["encoder"]["fc1_kernel"]
    assert MODEL_AXIS in str(fc1.sharding.spec)
    out = np.asarray(get_image_features(sharded, jnp.asarray(batch), cfg))
    np.testing.assert_allclose(out, base, rtol=1e-4, atol=1e-5)


def test_train_step_runs_and_decreases_loss(mesh8):
    cfg = get_config("tpuclip/test-tiny")
    params = init_params(jax.random.PRNGKey(0), cfg)
    sharded = shard_params(params, mesh8)
    opt = make_optimizer(learning_rate=1e-3)
    state = init_train_state(sharded, opt)
    step = make_train_step(cfg, opt, mesh=mesh8, compute_dtype=jnp.float32)

    rng = np.random.default_rng(4)
    images = jnp.asarray(rng.integers(0, 256, size=(16, 56, 56, 3), dtype=np.uint8))
    ids = jnp.asarray(rng.integers(0, 512, size=(16, 64)))

    first_loss = float(
        sigmoid_contrastive_loss(params, images, ids, cfg, jnp.float32)
    )
    losses = []
    for _ in range(5):
        state, loss = step(state, images, ids)
        losses.append(float(loss))
    assert losses[0] == pytest.approx(first_loss, rel=1e-3)
    assert losses[-1] < losses[0]  # memorizing one batch must reduce loss
    assert int(state.step) == 5


def test_train_step_adafactor_decreases_loss():
    """The factored optimizer (single-chip SO400M recipe: AdamW's fp32
    moment trees exceed one 16 GB chip — scripts/probe_train_compile.py)
    must train: memorizing one batch reduces the loss."""
    cfg = get_config("tpuclip/test-tiny")
    params = init_params(jax.random.PRNGKey(1), cfg)
    opt = make_optimizer(learning_rate=1e-3, factored=True)
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt, compute_dtype=jnp.float32)

    rng = np.random.default_rng(5)
    images = jnp.asarray(rng.integers(0, 256, size=(8, 56, 56, 3), dtype=np.uint8))
    ids = jnp.asarray(rng.integers(0, 512, size=(8, 64)))
    losses = []
    for _ in range(6):
        state, loss = step(state, images, ids)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert int(state.step) == 6
    # Factored state must undercut AdamW's two dense fp32 moment trees
    # (2x param bytes). Adafactor keeps no first moment and factors dims
    # >= 128, so even on this tiny model (where small matrices keep a
    # dense second moment) total state stays well under the AdamW cost.
    param_bytes = sum(p.size * 4 for p in jax.tree_util.tree_leaves(params))
    opt_bytes = sum(
        leaf.size * leaf.dtype.itemsize
        for leaf in jax.tree_util.tree_leaves(state.opt_state)
        if hasattr(leaf, "size")
    )
    assert opt_bytes < 1.5 * param_bytes, (opt_bytes, param_bytes)


def test_mesh_sharded_device_index(mesh8, tmp_path):
    """End-to-end: DeviceIndex(mesh=...) serves identical results to the
    single-device index, including folder filters."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    rng = np.random.default_rng(7)
    store = MetadataStore(str(tmp_path / "m.db"), embedding_dim=64)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    cur = conn.cursor()
    vecs = rng.standard_normal((300, 64)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    batch = [
        (f"/data/{'a' if i % 2 else 'b'}/img{i}.jpg", 1.0 * i, f"h{i}", vecs[i])
        for i in range(300)
    ]
    store.commit_with_retry(cur, conn, batch, save_full_embeddings=True)
    conn.close()

    q = rng.standard_normal(64).astype(np.float32)
    single = DeviceIndex(store).search(q, 9)
    sharded = DeviceIndex(store, mesh=mesh8, matrix_dtype=jnp.float32).search(q, 9)
    assert [p for p, _ in sharded] == [p for p, _ in single]

    f_single = DeviceIndex(store).search(q, 9, filter_folders=["/data/a"])
    f_sharded = DeviceIndex(store, mesh=mesh8, matrix_dtype=jnp.float32).search(
        q, 9, filter_folders=["/data/a"]
    )
    assert [p for p, _ in f_sharded] == [p for p, _ in f_single]
    assert all("/data/a/" in p for p, _ in f_sharded)


def test_mesh_sharded_int8_index(mesh8, tmp_path):
    """Sharded int8 + exact rerank must match the fp32 brute-force order."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    rng = np.random.default_rng(8)
    n, d, k = 500, 64, 9
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    store = MetadataStore(str(tmp_path / "i8.db"), embedding_dim=d)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    store.commit_with_retry(
        conn.cursor(), conn,
        [(f"/d/{i}.jpg", float(i), "h", vecs[i]) for i in range(n)],
        save_full_embeddings=True,
    )
    conn.close()

    idx = DeviceIndex(store, mesh=mesh8, precision="int8")
    q = rng.standard_normal(d).astype(np.float32)
    got = idx.search(q, k)
    scores = vecs @ q
    order = np.lexsort((np.arange(n), -scores))[:k]
    assert [p for p, _ in got] == [f"/d/{i}.jpg" for i in order]


def test_param_shardings_cover_tree(mesh4x2):
    cfg = get_config("tpuclip/test-tiny")
    params = init_params(jax.random.PRNGKey(0), cfg)
    specs = param_shardings(params, mesh4x2)
    assert jax.tree.structure(specs) == jax.tree.structure(params)


def test_sharded_binary_topk_matches_single_device(mesh8):
    """Row-sharded packed-binary scan == single-device scan, ragged rows and
    folder masks included (VERDICT r1 item 4: binary-only DBs must search
    identically on 1 and 8 devices)."""
    from tpuclip.ops.hamming import binary_topk_packed, pack_bits_to_words
    from tpuclip.parallel.sharded_search import sharded_binary_topk

    rng = np.random.default_rng(11)
    n, d, k = 301, 128, 9  # ragged: 301 % 8 != 0
    bits = (rng.standard_normal((n, d)) >= 0).astype(np.uint8)
    qbits = (rng.standard_normal((2, d)) >= 0).astype(np.uint8)
    words = pack_bits_to_words(bits)
    qwords = pack_bits_to_words(qbits)

    ref_s, ref_i = binary_topk_packed(jnp.asarray(qwords), jnp.asarray(words), k)

    ndev = 8
    row_pad = (-n) % ndev
    padded = np.pad(words, ((0, row_pad), (0, 0)))
    got_s, got_i = sharded_binary_topk(
        jnp.asarray(qwords), jnp.asarray(padded), k, mesh8,
        jnp.asarray(n, jnp.int32),
    )
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(ref_s))
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))

    # masked variant: exclude even rows
    mask = np.where(np.arange(padded.shape[0]) % 2 == 0, -np.inf, 0.0).astype(np.float32)
    ref_ms, ref_mi = binary_topk_packed(
        jnp.asarray(qwords), jnp.asarray(words), k, mask=jnp.asarray(mask[:n])
    )
    got_ms, got_mi = sharded_binary_topk(
        jnp.asarray(qwords), jnp.asarray(padded), k, mesh8,
        jnp.asarray(n, jnp.int32), mask=jnp.asarray(mask),
    )
    np.testing.assert_array_equal(np.asarray(got_ms), np.asarray(ref_ms))
    np.testing.assert_array_equal(np.asarray(got_mi), np.asarray(ref_mi))


def test_mesh_sharded_binary_index(mesh8, tmp_path):
    """Binary-only DB through DeviceIndex(mesh=...) == single-device results,
    folder filters included."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    rng = np.random.default_rng(13)
    store = MetadataStore(str(tmp_path / "b.db"), embedding_dim=64)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    cur = conn.cursor()
    vecs = rng.standard_normal((205, 64)).astype(np.float32)
    batch = [
        (f"/data/{'a' if i % 2 else 'b'}/img{i}.jpg", 1.0 * i, f"h{i}", vecs[i])
        for i in range(205)
    ]
    store.commit_with_retry(cur, conn, batch, save_full_embeddings=False)
    conn.close()

    q = rng.standard_normal(64).astype(np.float32)
    single = DeviceIndex(store).search(q, 7)
    sharded_idx = DeviceIndex(store, mesh=mesh8)
    sharded = sharded_idx.search(q, 7)
    assert single and [p for p, _ in sharded] == [p for p, _ in single]
    assert [s for _, s in sharded] == [s for _, s in single]
    assert sharded_idx.num_full == 0 and sharded_idx.num_binary == 205

    f_single = DeviceIndex(store).search(q, 7, filter_folders=["/data/a"])
    f_sharded = sharded_idx.search(q, 7, filter_folders=["/data/a"])
    assert [p for p, _ in f_sharded] == [p for p, _ in f_single]
    assert all("/data/a/" in p for p, _ in f_sharded)


def test_sharded_binary_topk_tie_ordering(mesh8):
    """Popcount ties straddling shard boundaries must resolve to the lowest
    global index, exactly like the single-device scan."""
    from tpuclip.ops.hamming import binary_topk_packed, pack_bits_to_words
    from tpuclip.parallel.sharded_search import sharded_binary_topk

    rng = np.random.default_rng(17)
    n = 256
    # Low-cardinality bit rows -> massive score ties across all shards.
    bits = np.tile(rng.integers(0, 2, (4, 64), dtype=np.uint8), (n // 4, 1))
    qbits = rng.integers(0, 2, (1, 64), dtype=np.uint8)
    words = pack_bits_to_words(bits)
    qwords = pack_bits_to_words(qbits)
    ref_s, ref_i = binary_topk_packed(jnp.asarray(qwords), jnp.asarray(words), 16)
    got_s, got_i = sharded_binary_topk(
        jnp.asarray(qwords), jnp.asarray(words), 16, mesh8, jnp.asarray(n, jnp.int32)
    )
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(ref_s))
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))


def test_dp_naflex_inference_matches_single(mesh8):
    """NaFlex batches (patches + masks + spatial shapes) DP-shard over the
    data axis like fixed-res pixel batches."""
    from tpuclip.models.naflex import get_image_features_naflex

    cfg = get_config("tpuclip/test-tiny-naflex")
    params = init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(4)
    b, L = 16, cfg.vision.max_num_patches
    patches = rng.integers(0, 256, size=(b, L, cfg.vision.patch_size**2 * 3), dtype=np.uint8)
    masks = np.ones((b, L), np.int32)
    shapes = np.empty((b, 2), np.int32)
    for i in range(b):  # mixed aspect grids, h*w <= L, padded tails masked
        h = int(rng.integers(1, 9))
        w = min(L // h, int(rng.integers(1, 9)))
        shapes[i] = (h, w)
        masks[i, h * w :] = 0
        masks[i, 0] = 1

    single = np.asarray(
        get_image_features_naflex(
            params, jnp.asarray(patches), jnp.asarray(masks), jnp.asarray(shapes), cfg
        )
    )
    sh = lambda spec: NamedSharding(mesh8, spec)
    dp = np.asarray(
        get_image_features_naflex(
            params,
            jax.device_put(jnp.asarray(patches), sh(P(DATA_AXIS, None, None))),
            jax.device_put(jnp.asarray(masks), sh(P(DATA_AXIS, None))),
            jax.device_put(jnp.asarray(shapes), sh(P(DATA_AXIS, None))),
            cfg,
        )
    )
    np.testing.assert_allclose(dp, single, rtol=1e-4, atol=1e-5)


def test_sharded_topk_k_exceeds_shard_rows(mesh8):
    """k larger than the per-shard row count must not crash the merge
    (review r2 finding): every path pads local candidates to k."""
    from tpuclip.ops.hamming import binary_topk_packed, pack_bits_to_words
    from tpuclip.ops.topk import topk_xla
    from tpuclip.ops.topk_int8 import quantize_query, quantize_rows, topk_int8_scan
    from tpuclip.parallel.sharded_search import (
        sharded_binary_topk,
        sharded_topk,
        sharded_topk_int8,
    )

    rng = np.random.default_rng(23)
    n, d, k = 24, 32, 50  # 3 rows/shard on 8 devices; k >> shard rows

    # float
    m = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((1, d)).astype(np.float32)
    mt = np.ascontiguousarray(m.T)
    ref_s, ref_i = topk_xla(jnp.asarray(q), jnp.asarray(mt), k)
    got_s, got_i = sharded_topk(
        jnp.asarray(q), jnp.asarray(mt), k, mesh8, jnp.asarray(n, jnp.int32)
    )
    valid = np.isfinite(np.asarray(got_s)[0])
    np.testing.assert_array_equal(np.asarray(got_i)[0][valid], np.asarray(ref_i)[0][: valid.sum()])

    # int8
    mq, scales = quantize_rows(mt.T)
    qi, qs = quantize_query(q)
    ref_s8, ref_i8 = topk_int8_scan(
        jnp.asarray(qi), jnp.asarray(mq), jnp.asarray(scales), jnp.asarray(qs, jnp.float32), k
    )
    got_s8, got_i8 = sharded_topk_int8(
        jnp.asarray(qi), jnp.asarray(mq), jnp.asarray(scales),
        jnp.asarray(qs, jnp.float32), k, mesh8, jnp.asarray(n, jnp.int32),
    )
    valid8 = np.isfinite(np.asarray(got_s8)[0])
    np.testing.assert_array_equal(
        np.asarray(got_i8)[0][valid8], np.asarray(ref_i8)[0][: valid8.sum()]
    )

    # binary
    bits = rng.integers(0, 2, (n, 64), dtype=np.uint8)
    words = pack_bits_to_words(bits)
    qw = pack_bits_to_words(rng.integers(0, 2, (1, 64), dtype=np.uint8))
    ref_bs, ref_bi = binary_topk_packed(jnp.asarray(qw), jnp.asarray(words), k)
    got_bs, got_bi = sharded_binary_topk(
        jnp.asarray(qw), jnp.asarray(words), k, mesh8, jnp.asarray(n, jnp.int32)
    )
    validb = np.asarray(got_bs)[0] > np.iinfo(np.int32).min
    np.testing.assert_array_equal(
        np.asarray(got_bi)[0][validb], np.asarray(ref_bi)[0][: validb.sum()]
    )
    np.testing.assert_array_equal(np.asarray(got_bs)[0][validb], np.asarray(ref_bs)[0][: validb.sum()])


def test_sharded_int8_rerank_matches_full_precision(mesh8):
    """sharded_topk_int8_rerank == unsharded full-precision scan, exactly
    (indices AND scores): each shard rescores its int8 shortlist against its
    local full-precision rows before the candidate merge."""
    from tpuclip.ops.topk_int8 import quantize_rows
    from tpuclip.parallel.sharded_search import sharded_topk_int8_rerank

    rng = np.random.default_rng(11)
    n, d, k = 4096, 64, 20
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    mt = np.ascontiguousarray(rows.T)
    mq, scales = quantize_rows(mt.T)
    q = rng.standard_normal((3, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    ref_s, ref_i = topk_xla(jnp.asarray(q), jnp.asarray(mt), k)
    got_s, got_i = sharded_topk_int8_rerank(
        jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales),
        jnp.asarray(rows), k, mesh8, jnp.asarray(n, jnp.int32),
    )
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(ref_s), rtol=1e-6)


def test_sharded_int8_rerank_ragged_and_k_exceeds_shard(mesh8):
    """Padded rows must not leak and k > shard_rows must not crash."""
    from tpuclip.ops.topk import pad_matrix_t
    from tpuclip.ops.topk_int8 import quantize_rows
    from tpuclip.parallel.sharded_search import sharded_topk_int8_rerank

    rng = np.random.default_rng(12)
    n, d, k = 37, 32, 50
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    mt, nv = pad_matrix_t(np.ascontiguousarray(rows.T), tile_n=8)
    mq, scales = quantize_rows(mt.T)
    rows_pad = np.pad(rows, ((0, mt.shape[1] - n), (0, 0)))
    q = rng.standard_normal((1, d)).astype(np.float32)

    got_s, got_i = sharded_topk_int8_rerank(
        jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales),
        jnp.asarray(rows_pad), k, mesh8, jnp.asarray(nv, jnp.int32),
    )
    got_s, got_i = np.asarray(got_s)[0], np.asarray(got_i)[0]
    valid = np.isfinite(got_s)
    assert valid.sum() == n  # every real row, nothing from padding
    exact = rows @ q[0]
    order = np.lexsort((np.arange(n), -exact))
    np.testing.assert_array_equal(got_i[valid], order[: valid.sum()])
    np.testing.assert_allclose(got_s[valid], exact[order], rtol=1e-6)


def test_mesh_sharded_int8_device_rerank_index(mesh8, tmp_path, monkeypatch):
    """DeviceIndex(mesh, int8) with device rerank forced ON: single and
    batched searches return the exact full-precision ordering through the
    distributed fused program."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    rng = np.random.default_rng(13)
    n, d, k = 500, 64, 9
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    store = MetadataStore(str(tmp_path / "i8r.db"), embedding_dim=d)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    store.commit_with_retry(
        conn.cursor(), conn,
        [(f"/d/{i}.jpg", float(i), "h", vecs[i]) for i in range(n)],
        save_full_embeddings=True,
    )
    conn.close()

    idx = DeviceIndex(store, mesh=mesh8, precision="int8", matrix_dtype=jnp.float32)
    qs = rng.standard_normal((3, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    idx.search(qs[0], k)
    assert idx._rows_device is not None, "sharded rerank copy must be resident"
    batched = idx.search_batch(qs, k)
    for row in range(3):
        single = idx.search(qs[row], k)
        scores = vecs @ qs[row]
        order = np.lexsort((np.arange(n), -scores))[:k]
        expected = [f"/d/{i}.jpg" for i in order]
        assert [p for p, _ in single] == expected
        assert [p for p, _ in batched[row]] == expected
        np.testing.assert_allclose(
            [s for _, s in single], scores[order], rtol=1e-5, atol=1e-6
        )


def test_sharded_int8_rerank_all_negative_scores_with_padding(mesh8):
    """Zero-padded columns score exactly 0 in the int8 scan; when every real
    score is negative they must NOT evict real rows from the per-shard
    shortlist (review finding: the scan needs the shard-local n_valid, not
    just the post-hoc invalid mask)."""
    from tpuclip.ops.topk import pad_matrix_t
    from tpuclip.ops.topk_int8 import quantize_rows
    from tpuclip.parallel.sharded_search import sharded_topk_int8_rerank

    rng = np.random.default_rng(21)
    n, d, k = 100, 32, 10
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows += 3.0  # all-positive components
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = -np.abs(rng.standard_normal((1, d)).astype(np.float32))  # scores < 0
    # Plant the GLOBAL BEST row (score closest to zero) in the shard that
    # holds the padded columns: padded width 112 over 8 devices = 14
    # cols/shard, so row 99 shares shard 7 with the 12 pad columns. A
    # shortlist of 8 < 12 means score-0 pads saturate that shard's
    # shortlist unless the scan masks them via n_valid.
    j = int(np.argmin(np.abs(q[0])))
    best = np.zeros(d, np.float32)
    best[j] = 1.0
    rows[99] = best
    mt, nv = pad_matrix_t(np.ascontiguousarray(rows.T), tile_n=16)
    mq, scales = quantize_rows(mt.T)
    rows_pad = np.pad(rows, ((0, mt.shape[1] - n), (0, 0)))
    assert mt.shape[1] == 112 and mt.shape[1] > n
    exact = rows @ q[0]
    assert np.argmax(exact) == 99, "test setup: row 99 must be the global best"

    got_s, got_i = sharded_topk_int8_rerank(
        jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales),
        jnp.asarray(rows_pad), k, mesh8, jnp.asarray(nv, jnp.int32),
        shortlist=8,  # shallow shortlist: padding eviction would be visible
    )
    got_s, got_i = np.asarray(got_s)[0], np.asarray(got_i)[0]
    assert np.all(np.isfinite(got_s)), "padded columns leaked into top-k"
    assert got_i.max() < n
    assert got_i[0] == 99, "global best row evicted by pad columns"
    np.testing.assert_allclose(got_s[0], exact[99], rtol=1e-6)


def test_sharded_int8_rerank_shape_boundary_fuzz(mesh8):
    """Mesh analog of the single-device boundary fuzz: valid-row counts that
    leave some shards mostly padding (n < ndev, n % ndev != 0, one row);
    every case must return exactly the fp32 oracle's top-k. Padding eviction
    and per-shard merge bugs (found in round-3 sweeps) live exactly here."""
    import random

    from tpuclip.ops.topk import pad_matrix_t
    from tpuclip.ops.topk_int8 import quantize_rows
    from tpuclip.parallel.sharded_search import sharded_topk_int8_rerank

    ndev = mesh8.shape[DATA_AXIS]
    rng_py = random.Random(23)
    rng = np.random.default_rng(23)
    d = 64
    for trial in range(6):
        n = rng_py.choice([1, ndev - 1, ndev, ndev + 1, 100, 1000, 2047])
        k = rng_py.choice([1, 5, min(32, n), n])
        rows = rng.standard_normal((n, d)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        mt, nv = pad_matrix_t(np.ascontiguousarray(rows.T), tile_n=2048 * ndev)
        q8, scales = quantize_rows(mt.T)
        matrix = jax.device_put(
            jnp.asarray(q8), NamedSharding(mesh8, P(DATA_AXIS, None))
        )
        scales_d = jax.device_put(
            jnp.asarray(scales), NamedSharding(mesh8, P(DATA_AXIS))
        )
        rows_pad = np.pad(rows, ((0, mt.shape[1] - n), (0, 0)))
        rows_d = jax.device_put(
            jnp.asarray(rows_pad), NamedSharding(mesh8, P(DATA_AXIS, None))
        )
        queries = rng.standard_normal((2, d)).astype(np.float32)
        scores, ridx = sharded_topk_int8_rerank(
            jnp.asarray(queries), matrix, scales_d, rows_d, min(k, 128),
            mesh8, jnp.asarray(nv, jnp.int32),
        )
        scores, ridx = np.asarray(scores), np.asarray(ridx)
        exact = queries @ rows.T
        k_eff = min(min(k, 128), n)
        for qi in range(2):
            want = np.lexsort((np.arange(n), -exact[qi]))[:k_eff]
            got = ridx[qi][ridx[qi] < n][:k_eff]
            assert list(got) == list(want), (trial, n, k, qi, got, want)
            np.testing.assert_allclose(
                scores[qi][: len(want)], exact[qi][want], rtol=1e-5, atol=1e-6
            )


def test_sharded_binary_topk_masked_matches_single_device(mesh8):
    """Exact mesh binary top-k over row-sharded packed words (the mesh
    cascade's resident form) == single-device scan, ragged rows and folder
    masks included."""
    from tpuclip.ops.hamming import binary_topk_packed, pack_bits_to_words
    from tpuclip.parallel.sharded_search import sharded_binary_topk

    rng = np.random.default_rng(13)
    n, d, k = 301, 128, 9
    bits = (rng.standard_normal((n, d)) >= 0).astype(np.uint8)
    qbits = (rng.standard_normal((2, d)) >= 0).astype(np.uint8)
    words = pack_bits_to_words(bits)
    qwords = pack_bits_to_words(qbits)
    padded = np.pad(words, ((0, (-n) % 8), (0, 0)))
    nv = jnp.asarray(n, jnp.int32)

    ref_s, ref_i = binary_topk_packed(jnp.asarray(qwords), jnp.asarray(words), k)
    s, i = sharded_binary_topk(jnp.asarray(qwords), jnp.asarray(padded), k, mesh8, nv)
    np.testing.assert_array_equal(np.asarray(s), np.asarray(ref_s))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))

    # folder mask over the global padded width
    mask = np.zeros((padded.shape[0],), np.float32)
    mask[::2] = -np.inf
    ref_ms, ref_mi = binary_topk_packed(
        jnp.asarray(qwords), jnp.asarray(words), k,
        mask=jnp.asarray(mask[:n]),
    )
    ms, mi = sharded_binary_topk(
        jnp.asarray(qwords), jnp.asarray(padded), k, mesh8, nv,
        mask=jnp.asarray(mask),
    )
    np.testing.assert_array_equal(np.asarray(ms), np.asarray(ref_ms))
    np.testing.assert_array_equal(np.asarray(mi), np.asarray(ref_mi))


def test_sharded_binary_full_depth_matches_single_device(mesh8):
    """The mesh cascade prefilter at full depth returns exactly the valid
    rows with exact scores, in (score desc, idx asc) order — parity with
    the single-device scan."""
    from tpuclip.ops.hamming import binary_topk_packed, pack_bits_to_words
    from tpuclip.parallel.sharded_search import sharded_binary_topk

    rng = np.random.default_rng(14)
    n, d = 300, 128
    bits = (rng.standard_normal((n, d)) >= 0).astype(np.uint8)
    qwords = pack_bits_to_words(
        (rng.standard_normal((1, d)) >= 0).astype(np.uint8)
    )
    words = pack_bits_to_words(bits)
    padded = np.pad(words, ((0, (-n) % 8), (0, 0)))

    m = n  # full depth: exact content guaranteed
    s, i = sharded_binary_topk(
        jnp.asarray(qwords), jnp.asarray(padded), m, mesh8,
        jnp.asarray(n, jnp.int32),
    )
    ref_s, ref_i = binary_topk_packed(jnp.asarray(qwords), jnp.asarray(words), m)
    np.testing.assert_array_equal(np.asarray(s), np.asarray(ref_s))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))


def test_mesh_cascade_device_index(mesh8, tmp_path, monkeypatch):
    """DeviceIndex(mesh=...) in cascade mode: no flat matrix resident
    (per-device memory = packed bits only), results identical to the exact
    single-device search at full depth, folder filters included."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    rng = np.random.default_rng(15)
    n, d, k = 300, 64, 9
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    store = MetadataStore(str(tmp_path / "mc.db"), embedding_dim=d)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    store.commit_with_retry(
        conn.cursor(), conn,
        [
            (f"/data/{'a' if i % 2 else 'b'}/img{i}.jpg", float(i), f"h{i}", vecs[i])
            for i in range(n)
        ],
        save_full_embeddings=True,
    )
    conn.close()

    exact = DeviceIndex(store)
    q = rng.standard_normal(d).astype(np.float32)

    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", str(n))
    casc = DeviceIndex(store, mesh=mesh8)
    casc.refresh()
    assert casc._cascade and casc._matrix is None
    got = casc.search(q, k)
    want = exact.search(q, k)
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose(
        [s for _, s in got], [s for _, s in want], rtol=1e-5
    )
    # folder filter rides the masked sharded exact prefilter
    fg = casc.search(q, k, filter_folders=["/data/a"])
    fw = exact.search(q, k, filter_folders=["/data/a"])
    assert [p for p, _ in fg] == [p for p, _ in fw]
    assert all("/data/a/" in p for p, _ in fg)

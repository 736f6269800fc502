"""int8 quantized search: score accuracy and top-k recall vs exact fp32."""

import numpy as np
import pytest

import jax.numpy as jnp

from conftest import assert_topk_oracle  # noqa: E402
from tpuclip.ops.topk import topk_xla
from tpuclip.ops.topk_int8 import (
    pad_rows,
    quantize_query,
    quantize_rows,
    topk_int8_scan,
)


def _unit_rows(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _assert_paths_scores(got, expected_paths, expected_scores):
    """fp32-exact ordering and scores (the suite's f32 is IEEE on CPU)."""
    assert [p for p, _ in got] == expected_paths
    np.testing.assert_allclose(
        [s for _, s in got], expected_scores, rtol=1e-5, atol=1e-6
    )


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    matrix = _unit_rows(rng, 20_000, 128)
    queries = _unit_rows(rng, 8, 128)
    return matrix, queries


def test_int8_scores_close_to_exact(data):
    matrix, queries = data
    mq, scales = quantize_rows(matrix)
    qi, qs = quantize_query(queries[0:1])
    s, i = topk_int8_scan(
        jnp.asarray(qi), jnp.asarray(mq), jnp.asarray(scales), jnp.asarray(qs), 10
    )
    exact = matrix @ queries[0]
    approx = np.asarray(s[0])
    got = exact[np.asarray(i[0])]
    np.testing.assert_allclose(approx, got, atol=0.01)  # quantization error bound


def test_int8_topk_recall(data):
    """recall@20 of the int8 scan vs the exact scan must be ~1."""
    matrix, queries = data
    mt = matrix.T.copy()
    mq, scales = quantize_rows(matrix)
    hits = total = 0
    for q in queries:
        _, exact_i = topk_xla(jnp.asarray(q[None]), jnp.asarray(mt), 20)
        qi, qs = quantize_query(q[None])
        _, int8_i = topk_int8_scan(
            jnp.asarray(qi), jnp.asarray(mq), jnp.asarray(scales), jnp.asarray(qs), 20
        )
        hits += len(set(np.asarray(exact_i[0])) & set(np.asarray(int8_i[0])))
        total += 20
    assert hits / total >= 0.95, f"recall@20 = {hits / total}"


def _int8_oracle(qi, mq, scales, n_valid):
    """numpy int32 product, f32 scale fold, -inf past n_valid."""
    acc = qi.astype(np.int32) @ mq.astype(np.int32).T
    scores = acc.astype(np.float32) * scales[None, :]
    scores[:, n_valid:] = -np.inf
    return scores


@pytest.mark.parametrize("q_count", [1, 3, 16, 64])
@pytest.mark.parametrize(
    "n,n_valid",
    [(1024, 1024), (1000, 1000), (2048, 1500)],
    ids=["tile-multiple", "ragged", "n_valid-lt-n"],
)
def test_int8_triton_scan_matches_xla_and_oracle(q_count, n, n_valid):
    """The Triton int8 scan (interpret mode) is bit-equal to the XLA scan
    and to a numpy int32 oracle: int32 accumulation is exact, the scale
    fold is one f32 multiply. Ragged N pads to the tile like the index
    does; the wrapper pads Q to its block and slices it back."""
    from tpuclip.ops.topk_int8 import _int8_scores_xla, int8_scores_triton

    rng = np.random.default_rng(q_count * 7 + n)
    rows = _unit_rows(rng, n, 96)
    padded, nv = pad_rows(rows)
    nv = min(nv, n_valid)
    mq, scales = quantize_rows(padded)
    qi = rng.integers(-127, 128, (q_count, 96), dtype=np.int8)
    nv_arr = jnp.asarray(nv, jnp.int32)
    got = np.asarray(int8_scores_triton(
        jnp.asarray(qi), jnp.asarray(mq), jnp.asarray(scales), nv_arr,
        interpret=True,
    ))
    xla = np.asarray(_int8_scores_xla(
        jnp.asarray(qi), jnp.asarray(mq), jnp.asarray(scales), nv_arr
    ))
    assert got.shape == (q_count, padded.shape[0])
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, _int8_oracle(qi, mq, scales, nv))


def test_int8_scan_route_and_shape_gate(monkeypatch):
    """int8_scores routes on the platform alone: the Triton route always
    takes the kernel, the XLA route never does. The Triton wrapper refuses a
    shape it cannot tile (N not a block multiple, D not a multiple of 16)
    instead of falling back, so a mis-padded matrix fails loudly."""
    import tpuclip.ops.topk_int8 as ti

    assert ti.triton_scan_fits(1024, 1152) and ti.triton_scan_fits(64, 64)
    assert not ti.triton_scan_fits(1000, 1152)  # ragged N
    assert not ti.triton_scan_fits(1024, 100)   # D not a multiple of 16
    assert not ti.triton_scan_fits(0, 64)
    assert ti._triton_block_k(1152) == 128 and ti._triton_block_k(96) == 32
    q = jnp.zeros((2, 64), jnp.int8)
    with pytest.raises(ValueError):
        ti.int8_scores_triton(q, jnp.zeros((1000, 64), jnp.int8), jnp.ones(1000), 10)
    monkeypatch.setattr(ti.platform, "int8_scan_route", lambda device=None: "triton")
    with pytest.raises(ValueError):  # ragged under the Triton route: no fallback
        ti.int8_scores(q, jnp.zeros((1000, 64), jnp.int8), jnp.ones(1000), 10)
    calls = []
    real_triton = ti.int8_scores_triton
    monkeypatch.setattr(
        ti, "int8_scores_triton",
        lambda *a, **kw: calls.append("triton") or real_triton(*a, interpret=True),
    )
    ti.int8_scores(q, jnp.zeros((1024, 64), jnp.int8), jnp.ones(1024), 10)
    monkeypatch.setattr(ti.platform, "int8_scan_route", lambda device=None: "xla")
    ti.int8_scores(q, jnp.zeros((1000, 64), jnp.int8), jnp.ones(1000), 10)
    assert calls == ["triton"]


def test_binary_topk_packed_matches_unpacked():
    """Packed popcount path must equal the int8-matmul path exactly."""
    import jax.numpy as jnp

    from tpuclip.ops.hamming import binary_topk, binary_topk_packed, pack_bits_to_words

    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (3000, 1152), dtype=np.uint8)
    qbits = rng.integers(0, 2, (2, 1152), dtype=np.uint8)
    s1, i1 = binary_topk(jnp.asarray(qbits.astype(np.int8)), jnp.asarray(bits.T.astype(np.int8)), 15)
    s2, i2 = binary_topk_packed(
        jnp.asarray(pack_bits_to_words(qbits)), jnp.asarray(pack_bits_to_words(bits)), 15
    )
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))


def test_int8_rerank_exact_vs_fp32_oracle(tmp_path, monkeypatch):
    """DeviceIndex int8 mode with HOST re-ranking must return exactly the
    fp32 brute-force ordering — on every backend: the int8 shortlist is
    integer-exact on every backend, and the rerank is host fp32 numpy (device
    rerank is pinned off so this path, not the fused one, is under test)."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "0")
    rng = np.random.default_rng(11)
    n, d, k = 5000, 64, 10
    vecs = _unit_rows(rng, n, d)
    store = MetadataStore(str(tmp_path / "r.db"), embedding_dim=d)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    cur = conn.cursor()
    store.commit_with_retry(
        cur, conn,
        [(f"/d/{i}.jpg", float(i), "h", vecs[i]) for i in range(n)],
        save_full_embeddings=True,
    )
    conn.close()

    idx = DeviceIndex(store, precision="int8")
    assert idx.rerank
    for qi in range(5):
        q = _unit_rows(rng, 1, d)[0]
        got = idx.search(q, k)
        scores = vecs @ q
        order = np.lexsort((np.arange(n), -scores))[:k]
        expected_paths = [f"/d/{i}.jpg" for i in order]
        assert [p for p, _ in got] == expected_paths
        np.testing.assert_allclose(
            [s for _, s in got], scores[order], rtol=1e-5, atol=1e-5
        )


def test_fused_rerank_matches_full_precision_oracle(data):
    """topk_int8_rerank_fused == the full-precision scan: the shortlist
    comes from int8 but every returned score is rescored against the
    resident full-precision rows — for each shortlist method."""
    from tpuclip.ops.topk_int8 import topk_int8_rerank_fused

    matrix, queries = data
    n, d, k = 8000, 128, 20
    rows = matrix[:n]
    padded, nv = pad_rows(rows)
    mq, scales = quantize_rows(padded)
    nv_arr = jnp.asarray(nv, jnp.int32)
    ref_s, ref_i = topk_xla(
        jnp.asarray(queries[:3]), jnp.asarray(rows.T.copy()), k
    )

    for method in ("exact", "approx"):
        s, i = topk_int8_rerank_fused(
            jnp.asarray(queries[:3]), jnp.asarray(mq), jnp.asarray(scales),
            jnp.asarray(rows), k, shortlist=256, n_valid=nv_arr,
            shortlist_method=method,
        )
        assert_topk_oracle(i, ref_i, s, ref_s)


def test_fused_rerank_wide_query_batch_matches_oracle(data):
    """q=64 (the serve micro-batcher's max) through one fused program must
    match the unpadded oracle row for row."""
    from tpuclip.ops.topk_int8 import INT8_TILE_N, topk_int8_rerank_fused

    matrix, _ = data
    n, d, k, q_count = INT8_TILE_N, 96, 5, 64
    rng = np.random.default_rng(21)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = rng.standard_normal((q_count, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    padded, nv = pad_rows(rows, tile_n=INT8_TILE_N)
    mq, scales = quantize_rows(padded)
    s, i = topk_int8_rerank_fused(
        jnp.asarray(queries), jnp.asarray(mq), jnp.asarray(scales),
        jnp.asarray(rows), k, n_valid=jnp.asarray(nv, jnp.int32),
    )
    exact = queries @ rows.T
    for r in range(q_count):
        order = np.lexsort((np.arange(n), -exact[r]))[:k]
        np.testing.assert_array_equal(np.asarray(i)[r], order)


def test_fused_rerank_small_index_edge():
    """n smaller than the shortlist and k > n: no sentinel leakage."""
    from tpuclip.ops.topk_int8 import topk_int8_rerank_fused

    rng = np.random.default_rng(3)
    rows = _unit_rows(rng, 37, 64)
    padded, nv = pad_rows(rows, tile_n=256)
    mq, scales = quantize_rows(padded)
    q = _unit_rows(rng, 1, 64)
    s, i = topk_int8_rerank_fused(
        jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales), jnp.asarray(rows),
        10, shortlist=512, n_valid=jnp.asarray(nv, jnp.int32),
    )
    exact = rows @ q[0]
    order = np.lexsort((np.arange(len(rows)), -exact))[:10]
    assert_topk_oracle(i[0], order, s[0], exact[order])


def test_device_index_fused_rerank_matches_oracle(tmp_path, monkeypatch):
    """DeviceIndex with device-side rerank forced ON: single and batched
    searches return the full-precision ordering through the fused program
    (the path GPU serving takes)."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    rng = np.random.default_rng(17)
    n, d, k = 3000, 64, 10
    vecs = _unit_rows(rng, n, d)
    store = MetadataStore(str(tmp_path / "f.db"), embedding_dim=d)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    cur = conn.cursor()
    store.commit_with_retry(
        cur, conn,
        [(f"/d/{i}.jpg", float(i), "h", vecs[i]) for i in range(n)],
        save_full_embeddings=True,
    )
    conn.close()

    idx = DeviceIndex(store, precision="int8")
    qs = _unit_rows(rng, 3, d)
    idx.search(qs[0], k)
    assert idx._rows_device is not None, "device rerank copy must be resident"
    batched = idx.search_batch(qs, k)
    for row in range(3):
        single = idx.search(qs[row], k)
        scores = vecs @ qs[row]
        order = np.lexsort((np.arange(n), -scores))[:k]
        expected = [f"/d/{i}.jpg" for i in order]
        # single and batched ride the same device program: always identical
        assert [p for p, _ in batched[row]] == [p for p, _ in single]
        _assert_paths_scores(single, expected, scores[order])


def test_topk_int8_batch_device_quant_matches_host_quant():
    """topk_int8_batch (on-device per-row quantization) == the host-side
    quantize-then-scan it replaced."""
    import jax.numpy as jnp

    from tpuclip.ops.topk_int8 import INT8_TILE_N, topk_int8_batch

    rng = np.random.default_rng(21)
    m = rng.standard_normal((3000, 128)).astype(np.float32)
    padded, nv = pad_rows(m, tile_n=INT8_TILE_N)
    mq, scales = quantize_rows(padded)
    q = rng.standard_normal((5, 128)).astype(np.float32)
    q[3] = 0.0  # zero query exercises the zero-scale guard

    got_s, got_i = topk_int8_batch(
        jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales), 9,
        n_valid=jnp.asarray(nv, jnp.int32),
    )

    qs = np.abs(q).max(axis=1, keepdims=True) / 127.0
    qs = np.where(qs == 0, 1.0, qs)
    qi = np.clip(np.rint(q / qs), -127, 127).astype(np.int8)
    ref_s, ref_i = topk_int8_scan(
        jnp.asarray(qi), jnp.asarray(mq), jnp.asarray(scales),
        jnp.asarray(1.0, jnp.float32), 9, n_valid=jnp.asarray(nv, jnp.int32),
    )
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(ref_s) * qs, rtol=1e-6)


def test_search_batch_int8_reranks_like_single(tmp_path, monkeypatch):
    """search_batch in int8 mode must apply the same exact fp32 re-rank as
    the single-query path (review r2 finding: the serve micro-batcher rides
    search_batch, which previously skipped the rerank). Host-rerank path
    pinned (device rerank off) so the fp32 ordering is exact on every
    backend."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "0")
    rng = np.random.default_rng(29)
    dim = 64
    store = MetadataStore(str(tmp_path / "r.db"), embedding_dim=dim)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    cur = conn.cursor()
    vecs = rng.standard_normal((400, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    batch = [(f"/d/img{i}.jpg", 1.0 * i, f"h{i}", vecs[i]) for i in range(400)]
    store.commit_with_retry(cur, conn, batch, save_full_embeddings=True)
    conn.close()

    idx = DeviceIndex(store, precision="int8")
    qs = rng.standard_normal((3, dim)).astype(np.float32)
    batched = idx.search_batch(qs, 10)
    for row in range(3):
        single = idx.search(qs[row], 10)
        assert [p for p, _ in batched[row]] == [p for p, _ in single]
        np.testing.assert_allclose(
            [s for _, s in batched[row]], [s for _, s in single], rtol=1e-6
        )
        # and the exact rerank means fp32 brute-force ordering
        exact = vecs @ qs[row]
        want = np.argsort(-exact, kind="stable")[:10]
        assert [p for p, _ in batched[row]] == [f"/d/img{i}.jpg" for i in want]


def test_round_f32_to_bf16_bits_matches_ml_dtypes():
    """The integer-bit bf16 rounding == numpy/ml_dtypes round-half-even,
    including negatives, subnormal-ish smalls, and exact-tie mantissas."""
    import ml_dtypes

    from tpuclip.ops.topk_int8 import round_f32_to_bf16_bits

    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        rng.standard_normal(256).astype(np.float32) * 1e-20,
        rng.standard_normal(256).astype(np.float32) * 1e20,
        np.asarray([0.0, -0.0, 1.0, -1.0], np.float32),
        # exact halfway mantissas exercise round-half-to-even
        np.asarray([1.00390625, 1.01171875, -1.00390625], np.float32),
    ])
    got = np.asarray(round_f32_to_bf16_bits(jnp.asarray(x)))
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_engine_search_texts_fused_matches_two_stage(tmp_path, monkeypatch):
    """engine.search_texts through the fused tokenize→tower→scan→rescore
    program returns the same ranked results as embed_texts + search_batch
    (and as the per-query search path)."""
    from tpuclip.engine import ImageDatabase

    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    from PIL import Image

    root = tmp_path / "imgs"
    root.mkdir()
    rng = np.random.default_rng(31)
    for i in range(12):
        arr = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img_{i}.jpg")
    eng = ImageDatabase(
        db_path=str(tmp_path / "t.db"),
        model_cache_dir=str(tmp_path / "models"),
        model_name="tpuclip/test-tiny",
        inference_batch_size=4,
    )
    eng.scan_directory(str(root), batch_size=10)

    texts = ["a red car", "blue sky", "a red car"]
    k = 5
    assert eng.index.can_fuse_text_search(k, None)
    fused = eng.search_texts(texts, k)
    vecs = eng.embed_texts(texts)
    two_stage = eng.index.search_batch(vecs, k)
    assert len(fused) == 3
    for f_row, t_row in zip(fused, two_stage):
        assert [p for p, _ in f_row] == [p for p, _ in t_row]
        np.testing.assert_allclose(
            [s for _, s in f_row], [s for _, s in t_row], rtol=1e-5, atol=1e-6
        )
    # folder-filter fallback path returns the same shape of results
    filtered = eng.search_texts(texts[:1], k, filter_folders=[str(root)])
    assert [p for p, _ in filtered[0]] == [p for p, _ in fused[0]]


def test_search_texts_fused_resident_scores_fallback(tmp_path, monkeypatch):
    """A forged proof failure on the fused text path must recover via the
    resident-scores fallback (exact top_k over the kept score matrix with
    the kept embedding — no tower or scan re-run) with identical results."""
    from tpuclip.engine import ImageDatabase
    from tpuclip.ops import topk_int8 as ti

    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    from PIL import Image

    root = tmp_path / "imgs"
    root.mkdir()
    rng = np.random.default_rng(37)
    for i in range(10):
        arr = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img_{i}.jpg")
    eng = ImageDatabase(
        db_path=str(tmp_path / "t.db"),
        model_cache_dir=str(tmp_path / "models"),
        model_name="tpuclip/test-tiny",
        inference_batch_size=4,
    )
    eng.scan_directory(str(root), batch_size=10)
    k = 4
    assert eng.index.can_fuse_text_search(k, None)
    expected = eng.search_texts(["a red car"], k)

    real = ti.text_topk_fused
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs.get("shortlist_method"))
        out = real(*args, **kwargs)
        if kwargs.get("shortlist_method") == "verified":
            return out[0], out[1], jnp.asarray(False), out[3], out[4]
        return out

    monkeypatch.setattr(ti, "text_topk_fused", spy)
    got = eng.search_texts(["a red car"], k)
    assert calls == ["verified"]  # fallback did NOT re-run the fused program
    assert eng.index.shortlist_stats["shortlist_fallbacks"] == 1
    assert [p for p, _ in got[0]] == [p for p, _ in expected[0]]
    np.testing.assert_allclose(
        [s for _, s in got[0]], [s for _, s in expected[0]], rtol=1e-6
    )


def _tiny_image_db(tmp_path, monkeypatch, seed=31, n_images=12):
    from tpuclip.engine import ImageDatabase
    from PIL import Image

    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    root = tmp_path / "imgs"
    root.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        arr = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img_{i}.jpg")
    eng = ImageDatabase(
        db_path=str(tmp_path / "t.db"),
        model_cache_dir=str(tmp_path / "models"),
        model_name="tpuclip/test-tiny",
        inference_batch_size=4,
    )
    eng.scan_directory(str(root), batch_size=n_images)
    return eng, root


def test_engine_search_image_fused_matches_two_stage(tmp_path, monkeypatch):
    """A plain image query through the fused pixels→vision-tower→scan→
    rescore program (engine.search via search_image_pil) returns the same
    ranked results as the two-stage embed + index.search path."""
    from tpuclip.io.decode import load_image

    eng, root = _tiny_image_db(tmp_path, monkeypatch, seed=41)
    query_path = str(root / "img_3.jpg")
    k = 5
    assert eng.index.can_fuse_image_search(k, None)
    fused = eng.search(query_path, k=k, is_image_path=True, show_duplicates=True)
    emb = eng._get_image_embedding(query_path)
    two_stage = eng.index.search(emb, k)
    assert [p for p, _ in fused] == [p for p, _ in two_stage]
    np.testing.assert_allclose(
        [s for _, s in fused], [s for _, s in two_stage], rtol=1e-5, atol=1e-6
    )
    # the queried image itself must rank first with ~unit similarity
    assert fused[0][0] == query_path

    # bytes-level serving entry: same results from the raw file bytes
    got = eng.search_image_bytes(
        (root / "img_3.jpg").read_bytes(), k, show_duplicates=True
    )
    assert [p for p, _ in got] == [p for p, _ in fused]
    # undecodable bytes → None (serve maps this to HTTP 400)
    assert eng.search_image_bytes(b"not an image", k) is None

    # folder-filtered queries keep the two-stage path, same results
    img = load_image(query_path)
    filtered = eng.search_image_pil(img, k, filter_folders=[str(root)])
    assert [p for p, _ in filtered] == [p for p, _ in fused]


def test_naflex_search_image_fused_matches_two_stage(tmp_path, monkeypatch):
    """The NaFlex family fuses image queries through its own tower entry
    (naflex_image_topk_fused): same ranked results as embed + search."""
    from tpuclip.engine import ImageDatabase
    from tpuclip.io.decode import load_image
    from PIL import Image

    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    root = tmp_path / "imgs"
    root.mkdir()
    rng = np.random.default_rng(47)
    for i in range(8):
        # varied aspect ratios exercise the NaFlex patchify path
        h, w = rng.integers(32, 80, 2)
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img_{i}.jpg")
    eng = ImageDatabase(
        db_path=str(tmp_path / "t.db"),
        model_cache_dir=str(tmp_path / "models"),
        model_name="tpuclip/test-tiny-naflex",
        inference_batch_size=4,
    )
    assert eng.is_naflex
    eng.scan_directory(str(root), batch_size=8)
    k = 4
    img = load_image(str(root / "img_2.jpg"))
    assert eng.index.can_fuse_image_search(k, None)
    fused = eng.search_image_pil(img, k)
    emb = eng._embed_pil(img)
    two_stage = eng.index.search(emb, k)
    assert [p for p, _ in fused] == [p for p, _ in two_stage]
    np.testing.assert_allclose(
        [s for _, s in fused], [s for _, s in two_stage], rtol=1e-5, atol=1e-6
    )
    assert fused[0][0] == str(root / "img_2.jpg")


def test_search_image_fused_resident_scores_fallback(tmp_path, monkeypatch):
    """A forged proof failure on the fused image path must recover via the
    resident-scores fallback (exact top_k over the kept score matrix with
    the kept embedding — no vision tower or scan re-run) with identical
    results."""
    from tpuclip.io.decode import load_image
    from tpuclip.ops import topk_int8 as ti

    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    eng, root = _tiny_image_db(tmp_path, monkeypatch, seed=43, n_images=10)
    k = 4
    img = load_image(str(root / "img_2.jpg"))
    assert eng.index.can_fuse_image_search(k, None)
    expected = eng.search_image_pil(img, k)

    real = ti.image_topk_fused
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs.get("shortlist_method"))
        out = real(*args, **kwargs)
        if kwargs.get("shortlist_method") == "verified":
            return out[0], out[1], jnp.asarray(False), out[3], out[4]
        return out

    monkeypatch.setattr(ti, "image_topk_fused", spy)
    got = eng.search_image_pil(img, k)
    assert calls == ["verified"]  # fallback did NOT re-run the fused program
    assert eng.index.shortlist_stats["shortlist_fallbacks"] == 1
    assert [p for p, _ in got] == [p for p, _ in expected]
    np.testing.assert_allclose(
        [s for _, s in got], [s for _, s in expected], rtol=1e-6
    )


def test_derive_int8_matrix_device_matches_host_quantize():
    """Device-side derivation from f32 rows == host quantize_rows on the
    same values: int8 entries bit-exact (same per-vector scale rule, same
    half-to-even rounding), scales within 1 ulp (XLA lowers /127 as a
    reciprocal multiply), pad rows zero int8 / scale 1.0."""
    from tpuclip.ops.topk_int8 import derive_int8_matrix_device

    rng = np.random.default_rng(23)
    rows = _unit_rows(rng, 1000, 96)
    n_pad = 1536
    q_dev, s_dev = derive_int8_matrix_device(jnp.asarray(rows), n_pad)
    padded, _ = pad_rows(rows, tile_n=n_pad)
    q_host, s_host = quantize_rows(padded)
    np.testing.assert_array_equal(np.asarray(q_dev), q_host)
    np.testing.assert_allclose(np.asarray(s_dev), s_host, rtol=1e-6)
    assert np.all(np.asarray(q_dev)[1000:] == 0)
    assert np.all(np.asarray(s_dev)[1000:] == 1.0)


def test_fused_rerank_shape_boundary_fuzz():
    """Randomized boundary fuzz: valid-row counts straddling tile, 8-row,
    128-row, and shortlist boundaries; k from 1 to the index size.
    Each case must return EXACTLY the fp32 oracle's top-k (the fused path's
    rescore is exact) — tile-edge bugs show up as dropped or phantom rows."""
    import random

    from tpuclip.ops.topk_int8 import INT8_TILE_N, topk_int8_rerank_fused

    rng_py = random.Random(17)
    rng = np.random.default_rng(17)
    d = 64
    boundary_ns = [1, 2, 7, 8, 9, 127, 128, 129, 255, 511, 513]
    for trial in range(10):
        n = rng_py.choice(boundary_ns + [rng_py.randrange(1, 700)])
        k = rng_py.choice([1, 2, 5, min(64, n), n, n + 3])
        rows = rng.standard_normal((n, d)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        padded, nv = pad_rows(rows, tile_n=INT8_TILE_N)
        q8, scales = quantize_rows(padded)
        queries = rng.standard_normal((2, d)).astype(np.float32)
        scores, ridx = topk_int8_rerank_fused(
            jnp.asarray(queries), jnp.asarray(q8), jnp.asarray(scales),
            jnp.asarray(rows), min(k, 128),
            n_valid=jnp.asarray(nv, jnp.int32),
        )
        scores, ridx = np.asarray(scores), np.asarray(ridx)
        exact = queries @ rows.T
        k_eff = min(min(k, 128), n)
        for qi in range(2):
            want = np.lexsort((np.arange(n), -exact[qi]))[:k_eff]
            got = ridx[qi][ridx[qi] < n][:k_eff]
            assert list(got) == list(want), (trial, n, k, qi)
            np.testing.assert_allclose(
                scores[qi][: len(want)], exact[qi][want], rtol=1e-5, atol=1e-6
            )


def test_engine_search_mixed_fused_matches_separate_paths(tmp_path, monkeypatch):
    """The mixed text+image fused program (both towers + ONE shared scan,
    r4) must return exactly what the separate fused passes return, for
    every text and every image, across bucket-padded shapes (3 texts →
    bucket 4; 2 images → bucket 2)."""

    from tpuclip.io.decode import load_image

    eng, root = _tiny_image_db(tmp_path, monkeypatch, seed=51)
    k = 5
    assert eng.index.can_fuse_text_search(k, None)
    texts = ["a red car", "blue sky", "green field"]
    img_paths = [str(root / "img_1.jpg"), str(root / "img_4.jpg")]
    imgs = [load_image(p) for p in img_paths]

    t_res, i_res = eng._search_mixed_fused(texts, imgs, k)
    assert len(t_res) == len(texts) and len(i_res) == len(imgs)

    def assert_results_match(got, exp):
        # bit-exact paths + tight scores (the suite's f32 is IEEE on CPU)
        assert [p for p, _ in got] == [p for p, _ in exp]
        np.testing.assert_allclose(
            [s for _, s in got], [s for _, s in exp], rtol=1e-5, atol=1e-6
        )

    exp_t = eng._search_texts_fused(texts, k)
    for got, exp in zip(t_res, exp_t):
        assert_results_match(got, exp)
    for path, img, got in zip(img_paths, imgs, i_res):
        assert_results_match(got, eng._search_image_fused(img, k))
        assert got[0][0] == path  # the image finds itself first

    # proof-miss fallback on the mixed program: forge ok=False, results
    # must recover via the resident-scores path unchanged
    from tpuclip.ops import topk_int8 as ti

    real = ti.mixed_topk_fused
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs.get("shortlist_method"))
        out = real(*args, **kwargs)
        if kwargs.get("shortlist_method") == "verified":
            return out[0], out[1], jnp.asarray(False), out[3], out[4]
        return out

    monkeypatch.setattr(ti, "mixed_topk_fused", spy)
    before = eng.index.shortlist_stats["shortlist_fallbacks"]
    t2, i2 = eng._search_mixed_fused(texts, imgs, k)
    if calls == ["verified"]:  # CPU resolves to a non-verified method
        assert eng.index.shortlist_stats["shortlist_fallbacks"] == before + 1
    for got, exp in zip(t2 + i2, t_res + i_res):
        assert [p for p, _ in got] == [p for p, _ in exp]


def test_naflex_mixed_fused_matches_separate_paths(tmp_path, monkeypatch):
    """The NaFlex variant of the mixed program (text tower + NaFlex vision
    tower + one shared scan) matches the separate fused passes, across
    bucket padding and varied aspect ratios."""
    from PIL import Image

    from tpuclip.engine import ImageDatabase
    from tpuclip.io.decode import load_image

    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    root = tmp_path / "imgs"
    root.mkdir()
    rng = np.random.default_rng(57)
    for i in range(8):
        h, w = rng.integers(32, 80, 2)
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img_{i}.jpg")
    eng = ImageDatabase(
        db_path=str(tmp_path / "t.db"),
        model_cache_dir=str(tmp_path / "models"),
        model_name="tpuclip/test-tiny-naflex",
        inference_batch_size=4,
    )
    assert eng.is_naflex
    eng.scan_directory(str(root), batch_size=8)
    k = 4
    assert eng.index.can_fuse_text_search(k, None)
    texts = ["a red car", "blue sky", "green field"]  # bucket 4
    img_paths = [str(root / "img_2.jpg"), str(root / "img_5.jpg")]  # bucket 2
    imgs = [load_image(p) for p in img_paths]

    t_res, i_res = eng._search_mixed_fused(texts, imgs, k)
    assert len(t_res) == 3 and len(i_res) == 2

    def assert_results_match(got, exp):
        # same exactness policy as the fixed-res mixed test
        assert [p for p, _ in got] == [p for p, _ in exp]
        np.testing.assert_allclose(
            [s for _, s in got], [s for _, s in exp], rtol=1e-5, atol=1e-6
        )

    exp_t = eng._search_texts_fused(texts, k)
    for got, exp in zip(t_res, exp_t):
        assert_results_match(got, exp)
    for path, img, got in zip(img_paths, imgs, i_res):
        assert_results_match(got, eng._search_image_fused(img, k))
        assert got[0][0] == path

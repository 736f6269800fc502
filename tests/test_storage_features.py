"""fp16 vector blobs and thumbnail GC (ROADMAP storage items, VERDICT r1 #9)."""

import sqlite3

import numpy as np
import pytest

from tpuclip.index.search import DeviceIndex
from tpuclip.index.store import MetadataStore
from tpuclip.io.thumbnails import Thumbnailer, referenced_hashes_for_dbs

DIM = 64


def _commit(store, vecs, prefix="/data"):
    conn = sqlite3.connect(store.db_path)
    cur = conn.cursor()
    batch = [
        (f"{prefix}/img{i}.jpg", 1.0 * i, f"hash{i}", vecs[i]) for i in range(len(vecs))
    ]
    store.commit_with_retry(cur, conn, batch, save_full_embeddings=True)
    conn.close()


@pytest.fixture()
def vecs():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((120, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_fp16_blobs_halve_storage_and_roundtrip(tmp_path, vecs):
    s32 = MetadataStore(str(tmp_path / "f32.db"), embedding_dim=DIM)
    s32.init_schema(verbose=False)
    _commit(s32, vecs)
    s16 = MetadataStore(str(tmp_path / "f16.db"), embedding_dim=DIM, vector_dtype="fp16")
    s16.init_schema(verbose=False)
    _commit(s16, vecs)

    blob32 = sqlite3.connect(s32.db_path).execute("SELECT vector FROM embeddings LIMIT 1").fetchone()[0]
    blob16 = sqlite3.connect(s16.db_path).execute("SELECT vector FROM embeddings LIMIT 1").fetchone()[0]
    assert len(blob32) == DIM * 4 and len(blob16) == DIM * 2

    for ids, out in s16.iter_embeddings():
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, vecs[ids - 1], atol=2e-3)


def test_fp16_search_matches_fp32_ordering(tmp_path, vecs):
    rng = np.random.default_rng(4)
    s32 = MetadataStore(str(tmp_path / "a.db"), embedding_dim=DIM)
    s32.init_schema(verbose=False)
    _commit(s32, vecs)
    s16 = MetadataStore(str(tmp_path / "b.db"), embedding_dim=DIM, vector_dtype="fp16")
    s16.init_schema(verbose=False)
    _commit(s16, vecs)
    q = rng.standard_normal(DIM).astype(np.float32)
    r32 = DeviceIndex(s32).search(q, 10)
    r16 = DeviceIndex(s16).search(q, 10)
    assert [p for p, _ in r16] == [p for p, _ in r32]
    # fp16 rounding keeps scores within half-precision tolerance
    np.testing.assert_allclose([s for _, s in r16], [s for _, s in r32], atol=2e-3)


def test_mixed_dtype_db_reads_back(tmp_path, vecs):
    """A DB scanned partly in fp32 and partly in fp16 (resumed with a
    different setting) must still read every row."""
    store = MetadataStore(str(tmp_path / "m.db"), embedding_dim=DIM)
    store.init_schema(verbose=False)
    _commit(store, vecs[:60], prefix="/a")
    store.vector_dtype = "fp16"
    _commit(store, vecs[60:], prefix="/b")
    got = np.concatenate([v for _, v in store.iter_embeddings()])
    assert got.shape == (120, DIM)
    np.testing.assert_allclose(got, vecs, atol=2e-3)


def test_thumbnail_gc(tmp_path, vecs):
    store = MetadataStore(str(tmp_path / "g.db"), embedding_dim=DIM)
    store.init_schema(verbose=False)
    _commit(store, vecs[:5])

    tdir = tmp_path / "thumbs"
    tdir.mkdir()
    referenced = referenced_hashes_for_dbs([store.db_path])
    assert referenced == {f"hash{i}" for i in range(5)}
    for h in ["hash0", "hash1", "orphan_a", "orphan_b"]:
        (tdir / f"{h}.jpg").write_bytes(b"x" * 100)
    (tdir / "notathumb.png").write_bytes(b"y")  # non-jpg is left alone

    t = Thumbnailer(str(tdir))
    removed, reclaimed = t.gc_orphans(referenced, dry_run=True)
    assert (removed, reclaimed) == (2, 200)
    assert (tdir / "orphan_a.jpg").exists()  # dry-run deletes nothing

    removed, reclaimed = t.gc_orphans(referenced)
    assert (removed, reclaimed) == (2, 200)
    assert not (tdir / "orphan_a.jpg").exists()
    assert (tdir / "hash0.jpg").exists() and (tdir / "notathumb.png").exists()


def test_gc_cli(tmp_path, vecs, monkeypatch, capsys):
    import os

    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path))
    monkeypatch.delenv("TPUCLIP_QUIET", raising=False)
    from tpuclip.cli import main as cli_main
    from tpuclip.config import default_paths

    paths = default_paths()
    os.makedirs(paths.db_dir, exist_ok=True)
    store = MetadataStore(os.path.join(paths.db_dir, "x.db"), embedding_dim=DIM)
    store.init_schema(verbose=False)
    _commit(store, vecs[:3])
    os.makedirs(paths.thumbnails_dir, exist_ok=True)
    for h in ["hash0", "gone"]:
        with open(os.path.join(paths.thumbnails_dir, f"{h}.jpg"), "wb") as f:
            f.write(b"z" * 50)
    cli_main(["gc"])
    out = capsys.readouterr().out
    assert "Removed 1" in out
    assert not os.path.exists(os.path.join(paths.thumbnails_dir, "gone.jpg"))
    assert os.path.exists(os.path.join(paths.thumbnails_dir, "hash0.jpg"))


def test_int8_blobs_quarter_storage_and_roundtrip(tmp_path, vecs):
    s32 = MetadataStore(str(tmp_path / "q32.db"), embedding_dim=DIM)
    s32.init_schema(verbose=False)
    _commit(s32, vecs)
    s8 = MetadataStore(str(tmp_path / "q8.db"), embedding_dim=DIM, vector_dtype="int8")
    s8.init_schema(verbose=False)
    _commit(s8, vecs)

    blob8 = sqlite3.connect(s8.db_path).execute(
        "SELECT vector FROM embeddings LIMIT 1"
    ).fetchone()[0]
    assert len(blob8) == DIM + 4

    for ids, out in s8.iter_embeddings():
        assert out.dtype == np.float32
        # dequantized values stay within one quantization step of the source
        step = np.abs(vecs[ids - 1]).max(axis=1, keepdims=True) / 127.0
        assert (np.abs(out - vecs[ids - 1]) <= step * 0.5 + 1e-7).all()


def test_int8_storage_requantizes_bit_identically(tmp_path, vecs):
    """The load-time int8 derivation over an int8-stored DB must reproduce
    the EXACT same int8 matrix + scales as over an fp32-stored DB — int8
    storage then cannot change any int8-scan search result."""
    from tpuclip.ops.topk_int8 import quantize_rows

    s8 = MetadataStore(str(tmp_path / "rq.db"), embedding_dim=DIM, vector_dtype="int8")
    s8.init_schema(verbose=False)
    _commit(s8, vecs)
    (ids, dequant), = list(s8.iter_embeddings())

    q_from_fp32, scales_from_fp32 = quantize_rows(vecs)
    q_from_int8, scales_from_int8 = quantize_rows(dequant)
    np.testing.assert_array_equal(q_from_int8, q_from_fp32)
    np.testing.assert_allclose(scales_from_int8, scales_from_fp32, rtol=1e-6)


def test_int8_zero_vector_roundtrip(tmp_path):
    s8 = MetadataStore(str(tmp_path / "z.db"), embedding_dim=DIM, vector_dtype="int8")
    s8.init_schema(verbose=False)
    z = np.zeros((2, DIM), np.float32)
    z[1, 0] = 1.0
    _commit(s8, z)
    (ids, out), = list(s8.iter_embeddings())
    np.testing.assert_array_equal(out, z[ids - 1])


def test_int8_search_ordering_close_to_fp32(tmp_path, vecs):
    rng = np.random.default_rng(9)
    s32 = MetadataStore(str(tmp_path / "o32.db"), embedding_dim=DIM)
    s32.init_schema(verbose=False)
    _commit(s32, vecs)
    s8 = MetadataStore(str(tmp_path / "o8.db"), embedding_dim=DIM, vector_dtype="int8")
    s8.init_schema(verbose=False)
    _commit(s8, vecs)
    q = rng.standard_normal(DIM).astype(np.float32)
    r32 = DeviceIndex(s32).search(q, 10)
    r8 = DeviceIndex(s8).search(q, 10)
    # int8 quantization of 64-dim unit vectors: expect near-total overlap
    assert len(set(p for p, _ in r8) & set(p for p, _ in r32)) >= 9
    np.testing.assert_allclose(
        sorted(s for _, s in r8), sorted(s for _, s in r32), atol=2e-2
    )


def test_mixed_int8_fp32_db_reads_back(tmp_path, vecs):
    """A DB scanned partly fp32 and partly int8 (resumed with a different
    flag) must read back per-row."""
    store = MetadataStore(str(tmp_path / "mix8.db"), embedding_dim=DIM)
    store.init_schema(verbose=False)
    _commit(store, vecs[:60], prefix="/a")
    store.vector_dtype = "int8"
    _commit(store, vecs[60:], prefix="/b")
    got = np.concatenate([v for _, v in store.iter_embeddings()])
    assert got.shape == (120, DIM)
    np.testing.assert_allclose(got[:60], vecs[:60], atol=1e-7)
    step = np.abs(vecs[60:]).max(axis=1, keepdims=True) / 127.0
    assert (np.abs(got[60:] - vecs[60:]) <= step * 0.5 + 1e-7).all()


def test_int8_dim4_guard():
    with pytest.raises(ValueError):
        MetadataStore("unused.db", embedding_dim=4, vector_dtype="int8")


def test_merge_mixed_dtype_shards(tmp_path, vecs):
    """A merge of an fp32 shard and an int8 shard must produce a searchable
    destination: blobs copy verbatim and readers detect dtype per row."""
    from tpuclip.pipelines.merge import merge_databases

    s32 = MetadataStore(str(tmp_path / "sh32.db"), embedding_dim=DIM)
    s32.init_schema(verbose=False)
    _commit(s32, vecs[:50], prefix="/a")
    s8 = MetadataStore(str(tmp_path / "sh8.db"), embedding_dim=DIM, vector_dtype="int8")
    s8.init_schema(verbose=False)
    _commit(s8, vecs[50:], prefix="/b")

    dst = str(tmp_path / "merged.db")
    merge_databases(dst, [s32.db_path, s8.db_path], embedding_dim=DIM)
    merged = MetadataStore(dst, embedding_dim=DIM)
    got = np.concatenate([v for _, v in merged.iter_embeddings()])
    assert got.shape == (120, DIM)
    # search over the merged DB returns sane top-1 (its own vector)
    r = DeviceIndex(merged).search(vecs[0], 1)
    assert r[0][0] == "/a/img0.jpg"
    # _commit renumbers per shard: vecs[60] landed as the int8 shard's img10
    r = DeviceIndex(merged).search(vecs[60], 1)
    assert r[0][0] == "/b/img10.jpg"


def test_dim4_fp16_blobs_decode_as_fp16():
    """At dim 4 the int8 blob length (d+4) collides with fp16 (2d); int8
    WRITING is blocked for that dim, so decode must prefer fp16 (existing
    tiny fp16 DBs would otherwise misdecode as int8 garbage)."""
    store = MetadataStore("unused.db", embedding_dim=4, vector_dtype="fp16")
    vec = np.array([0.5, -0.25, 1.0, -1.0], np.float32)
    blob = vec.astype(np.float16).tobytes()
    assert len(blob) == 8 == 4 + 4  # the colliding length
    out = store._decode_vector_rows([blob])
    np.testing.assert_allclose(out[0], vec, atol=1e-3)

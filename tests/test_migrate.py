"""Migration of reference-built DBs (sqlite-vec vec0) into tpuclip layout.

The fixture writer reproduces sqlite-vec's vec0 shadow-table format
(<name>_chunks / _rowids / _vector_chunks00, LSB-first validity bitmaps,
float32 vector chunks) exactly as a reference scan would leave it on disk
(image_database.py:290-294 creates the table, :1153-1181 inserts, :308-314
and :1177-1181 maintain the image_embeddings rowid map), so the parser in
tpuclip/index/migrate.py is tested against the real on-disk layout without
needing the sqlite-vec extension installed.
"""

import sqlite3
import struct

import numpy as np
import pytest


from tpuclip.index.migrate import (
    detect_vec0,
    iter_vec0_vectors,
    migrate_reference_db,
    vec0_dim,
)


def _make_reference_db(
    path,
    vecs: np.ndarray,
    chunk_size: int = 8,
    with_ddl_entry: bool = True,
    deleted_rowids=(),
    start_image_id: int = 1,
):
    """Write a DB exactly as the reference + sqlite-vec leave it on disk.

    vec0 rowids are 1..n in insert order; image i maps to image_id
    start_image_id+i with path /ref/img_<i>.jpg.
    """
    n, d = vecs.shape
    deleted = set(deleted_rowids)
    conn = sqlite3.connect(path)
    cur = conn.cursor()
    # Reference-created tables (image_database.py:275-331)
    cur.execute(
        """CREATE TABLE images (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            file_path TEXT UNIQUE NOT NULL,
            last_modified REAL NOT NULL,
            file_hash TEXT,
            created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP)"""
    )
    cur.execute(
        """CREATE TABLE image_embeddings (
            rowid INTEGER PRIMARY KEY,
            image_id INTEGER,
            FOREIGN KEY (image_id) REFERENCES images(id))"""
    )
    cur.execute(
        """CREATE TABLE binary_embeddings (
            rowid INTEGER PRIMARY KEY AUTOINCREMENT,
            image_id INTEGER UNIQUE NOT NULL,
            embedding BLOB NOT NULL,
            FOREIGN KEY (image_id) REFERENCES images(id))"""
    )
    # sqlite-vec shadow tables (vec0 layout, v0.1.x)
    cur.execute(
        """CREATE TABLE vec0_chunks (
            chunk_id INTEGER PRIMARY KEY AUTOINCREMENT,
            size INTEGER NOT NULL,
            validity BLOB NOT NULL,
            rowids BLOB NOT NULL)"""
    )
    cur.execute(
        """CREATE TABLE vec0_rowids (
            rowid INTEGER PRIMARY KEY AUTOINCREMENT,
            id, chunk_id INTEGER, chunk_offset INTEGER)"""
    )
    cur.execute(
        """CREATE TABLE vec0_vector_chunks00 (
            rowid INTEGER PRIMARY KEY AUTOINCREMENT,
            vectors BLOB NOT NULL)"""
    )
    for i in range(n):
        image_id = start_image_id + i
        cur.execute(
            "INSERT INTO images (id, file_path, last_modified, file_hash) "
            "VALUES (?, ?, ?, ?)",
            (image_id, f"/ref/img_{i}.jpg", 1000.0 + i, f"hash{i}"),
        )
        cur.execute(
            "INSERT INTO binary_embeddings (image_id, embedding) VALUES (?, ?)",
            (image_id, (vecs[i] >= 0).astype(np.uint8).tobytes()),
        )
        vec_rowid = i + 1
        if vec_rowid not in deleted:
            cur.execute(
                "INSERT INTO image_embeddings (rowid, image_id) VALUES (?, ?)",
                (vec_rowid, image_id),
            )
    # chunked vector storage
    n_chunks = -(-n // chunk_size)
    for c in range(n_chunks):
        lo, hi = c * chunk_size, min((c + 1) * chunk_size, n)
        validity = bytearray(-(-chunk_size // 8))
        rowids = bytearray(chunk_size * 8)
        block = np.zeros((chunk_size, vecs.shape[1]), np.float32)
        for off in range(hi - lo):
            vec_rowid = lo + off + 1
            if vec_rowid in deleted:
                continue
            validity[off >> 3] |= 1 << (off & 7)
            struct.pack_into("<q", rowids, off * 8, vec_rowid)
            block[off] = vecs[lo + off]
            cur.execute(
                "INSERT INTO vec0_rowids (rowid, id, chunk_id, chunk_offset) "
                "VALUES (?, NULL, ?, ?)",
                (vec_rowid, c + 1, off),
            )
        cur.execute(
            "INSERT INTO vec0_chunks (chunk_id, size, validity, rowids) "
            "VALUES (?, ?, ?, ?)",
            (c + 1, chunk_size, bytes(validity), bytes(rowids)),
        )
        cur.execute(
            "INSERT INTO vec0_vector_chunks00 (rowid, vectors) VALUES (?, ?)",
            (c + 1, block.tobytes()),
        )
    conn.commit()
    if with_ddl_entry:
        # The CREATE VIRTUAL TABLE entry sqlite-vec records in sqlite_master
        # (carries the declared dimension our parser reads first).
        cur.execute("PRAGMA writable_schema=ON")
        cur.execute(
            "INSERT INTO sqlite_master (type, name, tbl_name, rootpage, sql) "
            "VALUES ('table', 'vec0', 'vec0', 0, ?)",
            (f"CREATE VIRTUAL TABLE vec0 USING vec0(embedding float[{d}])",),
        )
        cur.execute("PRAGMA writable_schema=OFF")
        conn.commit()
    conn.close()


@pytest.fixture()
def ref_vecs():
    rng = np.random.default_rng(50)
    v = rng.standard_normal((19, 64)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_detect_and_dim(tmp_path, ref_vecs):
    db = str(tmp_path / "ref.db")
    _make_reference_db(db, ref_vecs)
    conn = sqlite3.connect(db)
    assert detect_vec0(conn)
    assert vec0_dim(conn) == 64
    conn.close()


def test_dim_inference_without_ddl_entry(tmp_path, ref_vecs):
    db = str(tmp_path / "ref.db")
    _make_reference_db(db, ref_vecs, with_ddl_entry=False)
    conn = sqlite3.connect(db)
    assert vec0_dim(conn) == 64
    conn.close()


def test_iter_vectors_exact(tmp_path, ref_vecs):
    """Every live vector comes back bit-exact, across partial chunks."""
    db = str(tmp_path / "ref.db")
    _make_reference_db(db, ref_vecs, chunk_size=8)
    conn = sqlite3.connect(db)
    got = dict(iter_vec0_vectors(conn))
    conn.close()
    assert sorted(got) == list(range(1, 20))
    for i in range(19):
        np.testing.assert_array_equal(got[i + 1], ref_vecs[i])


def test_migrate_then_search_identical(tmp_path, ref_vecs):
    """A migrated reference DB returns the same full-precision top-k tpuclip
    computes on natively-scanned embeddings (the VERDICT interop contract)."""
    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    db = str(tmp_path / "ref.db")
    _make_reference_db(db, ref_vecs)
    report = migrate_reference_db(db, verbose=False)
    assert report.migrated == 19 and report.dim == 64

    store = MetadataStore(db, embedding_dim=64)
    idx = DeviceIndex(store)
    rng = np.random.default_rng(51)
    q = rng.standard_normal(64).astype(np.float32)
    q /= np.linalg.norm(q)
    results = idx.search(q, k=5)
    assert len(results) == 5
    exact = ref_vecs @ q
    order = np.lexsort((np.arange(19), -exact))[:5]
    expect = [f"/ref/img_{i}.jpg" for i in order]
    assert [p for p, _ in results] == expect
    for (_, s), i in zip(results, order):
        np.testing.assert_allclose(s, exact[i], rtol=1e-5, atol=1e-6)


def test_migrate_idempotent(tmp_path, ref_vecs):
    db = str(tmp_path / "ref.db")
    _make_reference_db(db, ref_vecs)
    first = migrate_reference_db(db, verbose=False)
    second = migrate_reference_db(db, verbose=False)
    assert first.migrated == 19
    assert second.migrated == 0 and second.skipped_existing == 19


def test_migrate_skips_deleted_rows(tmp_path, ref_vecs):
    db = str(tmp_path / "ref.db")
    _make_reference_db(db, ref_vecs, deleted_rowids={3, 11})
    report = migrate_reference_db(db, verbose=False)
    assert report.migrated == 17
    conn = sqlite3.connect(db)
    ids = {r[0] for r in conn.execute("SELECT image_id FROM embeddings")}
    conn.close()
    assert 1 + 2 not in ids and 1 + 10 not in ids  # image_id = rowid offset


def test_migrate_dry_run_writes_nothing(tmp_path, ref_vecs):
    db = str(tmp_path / "ref.db")
    _make_reference_db(db, ref_vecs)
    report = migrate_reference_db(db, dry_run=True, verbose=False)
    assert report.migrated == 19
    conn = sqlite3.connect(db)
    row = conn.execute(
        "SELECT 1 FROM sqlite_master WHERE name = 'embeddings'"
    ).fetchone()
    conn.close()
    assert row is None


def test_migrate_rejects_non_vec0_db(tmp_path):
    db = str(tmp_path / "plain.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE images (id INTEGER PRIMARY KEY, file_path TEXT)")
    conn.commit()
    conn.close()
    with pytest.raises(ValueError, match="nothing to migrate"):
        migrate_reference_db(db, verbose=False)


def test_migrate_empty_vec0_db_leaves_schema_untouched(tmp_path):
    """Regression (review r3): a freshly-created reference DB (shadow
    tables present, zero vectors, no DDL entry) must fail BEFORE any write
    — the old code stamped meta embedding_dim=0 and created the embeddings
    table, permanently corrupting the DB for later correct migrations
    (INSERT OR IGNORE never fixes the meta row)."""
    db = str(tmp_path / "fresh.db")
    vecs = np.zeros((0, 4), np.float32)
    _make_reference_db(db, vecs, with_ddl_entry=False)
    with pytest.raises(ValueError, match="dimension"):
        migrate_reference_db(db, verbose=False)
    conn = sqlite3.connect(db)
    tables = {
        r[0]
        for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table'"
        ).fetchall()
    }
    conn.close()
    assert "embeddings" not in tables and "meta" not in tables


def test_cli_migrate(tmp_path, ref_vecs, capsys):
    from tpuclip.cli import main

    db = str(tmp_path / "ref.db")
    _make_reference_db(db, ref_vecs)
    main(["migrate", "--db", db])
    conn = sqlite3.connect(db)
    count = conn.execute("SELECT COUNT(*) FROM embeddings").fetchone()[0]
    conn.close()
    assert count == 19

"""Binary-cascade search mode (TPUCLIP_SEARCH_MODE=cascade): packed-binary
device prefilter + exact host rescore, with NO flat device matrix — the
single-chip mode for indexes whose int8+full copies exceed the HBM budget
(~1.4 GB vs ~13 GB at 10M x 1152)."""

import sqlite3

import numpy as np
import pytest


from tpuclip.index.search import DeviceIndex
from tpuclip.index.store import MetadataStore

DIM = 64


def _build_db(tmp_path, vecs, name="c.db"):
    store = MetadataStore(str(tmp_path / name), embedding_dim=DIM)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    cur = conn.cursor()
    batch = [(f"/img/{i:04d}.jpg", float(i), f"h{i}", vecs[i]) for i in range(len(vecs))]
    store.commit_with_retry(cur, conn, batch, save_full_embeddings=True)
    conn.close()
    return store


@pytest.fixture()
def vecs():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((400, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_cascade_full_depth_equals_exact(tmp_path, vecs, monkeypatch):
    """With depth = N the prefilter passes every row, so results must be
    IDENTICAL to the exact scan (same rescore ordering contract)."""
    store = _build_db(tmp_path, vecs)
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", str(len(vecs)))
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    casc = DeviceIndex(store)
    monkeypatch.delenv("TPUCLIP_SEARCH_MODE")
    monkeypatch.delenv("TPUCLIP_CASCADE_DEPTH")
    exact = DeviceIndex(store)

    rng = np.random.default_rng(9)
    for _ in range(3):
        q = rng.standard_normal(DIM).astype(np.float32)
        got = casc.search(q, 10)
        want = exact.search(q, 10)
        assert [p for p, _ in got] == [p for p, _ in want]
        np.testing.assert_allclose(
            [s for _, s in got], [s for _, s in want], rtol=1e-5
        )
    # the mode's point: no flat device matrix was ever uploaded
    assert casc._matrix is None and casc._cascade


def test_cascade_partial_depth_recall(tmp_path, monkeypatch):
    """A shortlist genuinely SMALLER than the index (depth 100 over 1500
    rows) must still recall most of the true top-10 — this is the real
    prefilter at work, not the degenerate full-depth case (at N=400 the
    512 default depth covers every row and recall is trivially 1)."""
    rng = np.random.default_rng(5)
    big = rng.standard_normal((1500, DIM)).astype(np.float32)
    big /= np.linalg.norm(big, axis=1, keepdims=True)
    store = _build_db(tmp_path, big, name="big.db")
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", "100")
    casc = DeviceIndex(store)
    monkeypatch.delenv("TPUCLIP_SEARCH_MODE")
    monkeypatch.delenv("TPUCLIP_CASCADE_DEPTH")
    exact = DeviceIndex(store)
    rng = np.random.default_rng(3)
    overlaps = []
    for _ in range(8):
        q = rng.standard_normal(DIM).astype(np.float32)
        got = {p for p, _ in casc.search(q, 10)}
        want = {p for p, _ in exact.search(q, 10)}
        overlaps.append(len(got & want) / 10)
    assert np.mean(overlaps) >= 0.6, overlaps
    # and a malformed depth must not take down the query path
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", "2k")
    bad = DeviceIndex(store)
    assert len(bad.search(rng.standard_normal(DIM).astype(np.float32), 5)) == 5


def test_cascade_batch_matches_single(tmp_path, vecs, monkeypatch):
    store = _build_db(tmp_path, vecs)
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", str(len(vecs)))
    casc = DeviceIndex(store)
    rng = np.random.default_rng(1)
    queries = rng.standard_normal((3, DIM)).astype(np.float32)
    batched = casc.search_batch(queries, 5)
    for qi in range(3):
        single = casc.search(queries[qi], 5)
        assert [p for p, _ in batched[qi]] == [p for p, _ in single]


def test_cascade_folder_filter(tmp_path, vecs, monkeypatch):
    store = _build_db(tmp_path, vecs)
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", str(len(vecs)))
    casc = DeviceIndex(store)
    q = vecs[7]
    results = casc.search(q, 5, filter_folders=["/img"])
    assert results[0][0] == "/img/0007.jpg"
    none = casc.search(q, 5, filter_folders=["/elsewhere"])
    assert none == []


def test_cascade_falls_back_when_binary_misaligned(tmp_path, vecs, monkeypatch):
    """An extra binary-only row breaks alignment; the index must fall back
    to the exact scan (flat matrix built) rather than mis-map rows."""
    store = _build_db(tmp_path, vecs)
    conn = sqlite3.connect(store.db_path)
    conn.execute(
        "INSERT INTO images (file_path, last_modified, file_hash) VALUES (?, ?, ?)",
        ("/img/extra.jpg", 0.0, "hx"),
    )
    extra_id = conn.execute(
        "SELECT id FROM images WHERE file_path = '/img/extra.jpg'"
    ).fetchone()[0]
    conn.execute(
        "INSERT INTO binary_embeddings (image_id, embedding) VALUES (?, ?)",
        (extra_id, np.ones(DIM, np.uint8).tobytes()),
    )
    conn.commit()
    conn.close()
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    casc = DeviceIndex(store)
    got = casc.search(vecs[3], 3)
    assert got[0][0] == "/img/0003.jpg"
    assert not casc._cascade and casc._matrix is not None


def test_search_mode_cli_flag(tmp_path, vecs, monkeypatch, capsys):
    """`search --mode cascade` selects the mode through the engine env."""
    import os

    from tpuclip.cli import main

    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TPUCLIP_INIT", "random")
    # setenv (not delenv) so monkeypatch restores the ORIGINAL state at
    # teardown even though main() itself mutates os.environ — delenv on an
    # absent var registers nothing and the mutation would leak into every
    # later test in the process.
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "exact")
    store = _build_db(tmp_path, vecs[:50], name="cli.db")
    # tiny model keeps this fast; dims differ from the DB's so skip actual
    # search execution — the flag wiring is what's under test
    main([
        "search", "a thing", "--db", store.db_path, "--no-session", "-k", "2",
        "--mode", "cascade", "--model", "tpuclip/test-tiny",
    ])
    assert os.environ.get("TPUCLIP_SEARCH_MODE") == "cascade"

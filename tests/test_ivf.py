"""IVF bucketed approximate search (tpuclip/index/ivf.py).

Covers: build invariants (every row reachable exactly once), exact-score
contract (returned scores == brute force for returned rows), recall on
clustered data, overflow handling, nprobe=K degenerating to exact search,
and the DeviceIndex wiring.
"""

import numpy as np
import pytest

import jax.numpy as jnp


from tpuclip.index.ivf import build_ivf, ivf_search


def _clustered(rng, n, d, n_clusters=32, spread=0.05):
    """Mixture of gaussians on the sphere — realistic embedding structure
    (spread is per-dim noise std; at 0.05/d=64 the noise norm is ~0.4 of
    the center norm, i.e. clearly clustered, like real CLIP embeddings)."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, n_clusters, n)
    x = centers[which] + spread * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def clustered_data():
    rng = np.random.default_rng(41)
    rows = _clustered(rng, 8000, 64)
    queries = _clustered(rng, 8, 64)
    return rows, queries


def test_build_every_row_reachable_once(clustered_data):
    rows, _ = clustered_data
    idx = build_ivf(rows, k_clusters=64, nprobe=8)
    seen = np.asarray(idx.bucket_rows).reshape(-1)
    seen = seen[seen >= 0].tolist() + [
        r for r in np.asarray(idx.over_rows).tolist() if r >= 0
    ]
    assert sorted(seen) == list(range(len(rows)))


def test_ivf_scores_are_exact_for_returned_rows(clustered_data):
    rows, queries = clustered_data
    idx = build_ivf(rows, k_clusters=64, nprobe=16)
    rows_dev = jnp.asarray(rows)
    s, i = ivf_search(idx, rows_dev, queries, k=10)
    s, i = np.asarray(s), np.asarray(i)
    exact = queries @ rows.T  # (Q, N)
    for q in range(len(queries)):
        np.testing.assert_allclose(
            s[q], exact[q][i[q]], rtol=1e-5, atol=1e-6
        )
        # descending, ties by idx
        assert all(s[q][a] >= s[q][a + 1] - 1e-7 for a in range(len(s[q]) - 1))


def test_ivf_recall_on_clustered_data(clustered_data):
    # 64 buckets over 8k rows probes 24/64 = 37% here; at production scale
    # (K ~= 2*sqrt(N)) the same nprobe probes ~2% of 1M rows — this small
    # fixture is the HARDER regime for recall, not the easier one.
    rows, queries = clustered_data
    idx = build_ivf(rows, k_clusters=64, nprobe=24)
    rows_dev = jnp.asarray(rows)
    k = 20
    _, i = ivf_search(idx, rows_dev, queries, k=k)
    i = np.asarray(i)
    exact = queries @ rows.T
    recalls = []
    for q in range(len(queries)):
        true = set(np.argsort(-exact[q])[:k].tolist())
        recalls.append(len(true & set(i[q].tolist())) / k)
    assert np.mean(recalls) >= 0.95, f"mean recall {np.mean(recalls)}"


def test_nprobe_all_is_exact(clustered_data):
    """Probing every bucket must return the exact brute-force top-k
    (bucketing+overflow covers all rows; rescore restores exact order)."""
    rows, queries = clustered_data
    idx = build_ivf(rows, k_clusters=32, nprobe=32)
    rows_dev = jnp.asarray(rows)
    k = 15
    s, i = ivf_search(idx, rows_dev, queries, k=k)
    s, i = np.asarray(s), np.asarray(i)
    exact = queries @ rows.T
    for q in range(len(queries)):
        order = np.lexsort((np.arange(len(rows)), -exact[q]))[:k]
        np.testing.assert_array_equal(i[q], order)
        np.testing.assert_allclose(s[q], exact[q][order], rtol=1e-5, atol=1e-6)


def test_overflow_rows_always_scanned():
    """Tiny capacity forces heavy overflow; overflowed best row must still
    be found because the overflow block is always scanned."""
    rng = np.random.default_rng(43)
    d = 32
    # 200 near-identical rows -> one giant cluster, most spill to overflow
    base = rng.standard_normal(d).astype(np.float32)
    rows = base[None, :] + 0.01 * rng.standard_normal((200, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    idx = build_ivf(rows, k_clusters=16, capacity_factor=1.0, nprobe=2)
    assert int((np.asarray(idx.over_rows) >= 0).sum()) > 0, "setup: need overflow"
    q = rows[123:124] + 0.001
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s, i = ivf_search(idx, jnp.asarray(rows), q, k=5)
    exact = rows @ q[0]
    assert int(np.asarray(i)[0, 0]) == int(np.argmax(exact))


def test_small_index_edge():
    """n < capacity, k > n: no sentinel leakage, exact results."""
    rng = np.random.default_rng(44)
    rows = rng.standard_normal((13, 16)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    idx = build_ivf(rows, k_clusters=4, nprobe=4)
    q = rng.standard_normal((1, 16)).astype(np.float32)
    s, i = ivf_search(idx, jnp.asarray(rows), q, k=20)
    s, i = np.asarray(s)[0], np.asarray(i)[0]
    valid = np.isfinite(s)
    assert valid.sum() == 13
    exact = rows @ q[0]
    order = np.lexsort((np.arange(13), -exact))
    np.testing.assert_array_equal(i[valid], order)


def test_device_index_ivf_mode(tmp_path, monkeypatch):
    """DeviceIndex with TPUCLIP_SEARCH_MODE=ivf returns high-recall results
    with exact scores through the standard search API."""
    import sqlite3

    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "ivf")
    rng = np.random.default_rng(45)
    n, d, k = 3000, 64, 10
    vecs = _clustered(rng, n, d)
    store = MetadataStore(str(tmp_path / "ivf.db"), embedding_dim=d)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    store.commit_with_retry(
        conn.cursor(), conn,
        [(f"/d/{i}.jpg", float(i), "h", vecs[i]) for i in range(n)],
        save_full_embeddings=True,
    )
    conn.close()

    idx = DeviceIndex(store, precision="int8")
    qs = _clustered(rng, 4, d)
    exact = vecs @ qs.T
    batched = idx.search_batch(qs, k)
    for q in range(4):
        single = idx.search(qs[q], k)
        assert [p for p, _ in single] == [p for p, _ in batched[q]]
        true = set(np.argsort(-exact[:, q])[:k].tolist())
        got = {int(p.rsplit("/", 1)[1].split(".")[0]) for p, _ in single}
        assert len(true & got) / k >= 0.9
        # scores exact for returned rows (device rescore rounds the query
        # to the bf16 storage dtype — ~1e-3 vs the fp64-ish numpy oracle)
        tol = 1e-5
        for p, s in single:
            row = int(p.rsplit("/", 1)[1].split(".")[0])
            np.testing.assert_allclose(s, exact[row, q], rtol=tol, atol=tol)

    # folder filters fall back to the exact masked path
    f = idx.search(qs[0], k, filter_folders=["/d"])
    assert len(f) == k


# =============================================================================
# Device-side build (build_ivf_device)
# =============================================================================


def test_device_build_every_row_reachable_once(clustered_data):
    from tpuclip.index.ivf import build_ivf_device

    rows, _ = clustered_data
    idx = build_ivf_device(jnp.asarray(rows), k_clusters=64, nprobe=8)
    seen = np.asarray(idx.bucket_rows).reshape(-1)
    seen = seen[seen >= 0].tolist() + [
        r for r in np.asarray(idx.over_rows).tolist() if r >= 0
    ]
    assert sorted(seen) == list(range(len(rows)))


def test_device_build_nprobe_all_is_exact(clustered_data):
    from tpuclip.index.ivf import build_ivf_device

    rows, queries = clustered_data
    idx = build_ivf_device(jnp.asarray(rows), k_clusters=32, nprobe=32)
    rows_dev = jnp.asarray(rows)
    k = 15
    s, i = ivf_search(idx, rows_dev, queries, k=k)
    s, i = np.asarray(s), np.asarray(i)
    exact = queries @ rows.T
    for q in range(len(queries)):
        order = np.lexsort((np.arange(len(rows)), -exact[q]))[:k]
        np.testing.assert_array_equal(i[q], order)
        np.testing.assert_allclose(s[q], exact[q][order], rtol=1e-5, atol=1e-6)


def test_device_build_recall_matches_host_build(clustered_data):
    from tpuclip.index.ivf import build_ivf_device

    rows, queries = clustered_data
    k = 20
    exact = queries @ rows.T
    recalls = {}
    for name, idx in (
        ("host", build_ivf(rows, k_clusters=64, nprobe=24)),
        ("device", build_ivf_device(jnp.asarray(rows), k_clusters=64, nprobe=24)),
    ):
        _, i = ivf_search(idx, jnp.asarray(rows), queries, k=k)
        i = np.asarray(i)
        rs = []
        for q in range(len(queries)):
            true = set(np.argsort(-exact[q])[:k].tolist())
            rs.append(len(true & set(i[q].tolist())) / k)
        recalls[name] = float(np.mean(rs))
    assert recalls["device"] >= 0.95, recalls
    assert abs(recalls["device"] - recalls["host"]) < 0.06, recalls


def test_device_build_overflow_exact_sizing():
    """Tiny capacity forces heavy spill; the device build must size the
    overflow block to hold every spilled row (exact, not bounded)."""
    from tpuclip.index.ivf import build_ivf_device

    rng = np.random.default_rng(46)
    d = 32
    # One dominant cluster forces spill; 0.05 spread keeps the per-row
    # cosine gaps above int8 quantization noise (0.01 makes the winner a
    # coin flip for any int8-shortlisted method).
    base = rng.standard_normal(d).astype(np.float32)
    rows = base[None, :] + 0.05 * rng.standard_normal((300, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    idx = build_ivf_device(
        jnp.asarray(rows), k_clusters=16, capacity_factor=1.0, nprobe=2
    )
    over = np.asarray(idx.over_rows)
    assert int((over >= 0).sum()) > 0
    seen = np.asarray(idx.bucket_rows).reshape(-1)
    seen = seen[seen >= 0].tolist() + over[over >= 0].tolist()
    assert sorted(seen) == list(range(len(rows)))
    q = rows[123:124] + 0.001
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s, i = ivf_search(idx, jnp.asarray(rows), q, k=5)
    exact = rows @ q[0]
    assert int(np.asarray(i)[0, 0]) == int(np.argmax(exact))


def test_device_build_centroid_reuse_assign_only(clustered_data):
    """Passing previous centroids skips retraining (incremental refresh):
    same centroids out, every row still reachable, recall holds."""
    from tpuclip.index.ivf import build_ivf_device

    rows, queries = clustered_data
    first = build_ivf_device(jnp.asarray(rows), k_clusters=64, nprobe=24)
    # grow the index by 10% and rebuild reusing the old centroids
    rng = np.random.default_rng(47)
    extra = _clustered(rng, 800, rows.shape[1])
    grown = np.concatenate([rows, extra])
    second = build_ivf_device(
        jnp.asarray(grown), k_clusters=64, nprobe=24, centroids=first.centroids
    )
    np.testing.assert_array_equal(
        np.asarray(first.centroids), np.asarray(second.centroids)
    )
    seen = np.asarray(second.bucket_rows).reshape(-1)
    seen = seen[seen >= 0].tolist() + [
        r for r in np.asarray(second.over_rows).tolist() if r >= 0
    ]
    assert sorted(seen) == list(range(len(grown)))
    k = 20
    exact = queries @ grown.T
    _, i = ivf_search(second, jnp.asarray(grown), queries, k=k)
    i = np.asarray(i)
    rs = []
    for q in range(len(queries)):
        true = set(np.argsort(-exact[q])[:k].tolist())
        rs.append(len(true & set(i[q].tolist())) / k)
    assert np.mean(rs) >= 0.9, np.mean(rs)

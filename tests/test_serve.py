"""HTTP serving mode: health/stats/search endpoints against a live server."""

import json
import urllib.error
import urllib.request

import pytest
from PIL import Image

from tpuclip.engine import ImageDatabase
from tpuclip.serve import SearchServer


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    home = tmp_path_factory.mktemp("serve")
    imgs = home / "imgs"
    imgs.mkdir()
    for name, c in [("red.jpg", (220, 30, 30)), ("green.png", (30, 200, 30)), ("blue.webp", (40, 40, 230))]:
        Image.new("RGB", (64, 64), c).save(imgs / name)
    eng = ImageDatabase(
        db_path=str(home / "s.db"),
        model_cache_dir=str(home / "models"),
        model_name="tpuclip/test-tiny",
        inference_batch_size=4,
    )
    eng.scan_directory(str(imgs), inference_batch_size=4)
    return eng


@pytest.fixture(scope="module")
def server(engine):
    srv = SearchServer(engine, host="127.0.0.1", port=0)  # ephemeral port
    srv.start_background()
    yield srv
    srv.shutdown()


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=10) as r:
        return r.status, json.loads(r.read())


def _post(srv, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(server):
    status, body = _get(server, "/health")
    assert status == 200 and body["status"] == "ok"


def test_stats(server):
    status, body = _get(server, "/stats")
    assert status == 200
    assert body["images"] == 3
    assert body["full_embeddings"] == 3
    assert body["embedding_dim"] == 64
    # verified-shortlist health counters are always exported (zeros unless
    # TPUCLIP_SHORTLIST=verified)
    assert isinstance(body["verified_queries"], int)
    assert isinstance(body["shortlist_fallbacks"], int)


def test_search_endpoint(server):
    status, body = _post(server, "/search", {"query": "a red square", "k": 2})
    assert status == 200
    assert len(body["results"]) == 2
    sims = [r["similarity"] for r in body["results"]]
    assert sims == sorted(sims, reverse=True)
    assert all("path" in r for r in body["results"])


def test_search_minilanguage(server):
    status, body = _post(server, "/search", {"query": "red + blue - green", "k": 3})
    assert status == 200
    assert len(body["results"]) == 3


def test_bad_requests(server):
    status, body = _post(server, "/search", {"k": 5})
    assert status == 400 and "query" in body["error"]
    status, _ = _post(server, "/nope", {"query": "x"})
    assert status == 404
    # non-search mini-language lines are rejected
    status, body = _post(server, "/search", {"query": "k:20"})
    assert status == 400


def test_malformed_json(server):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/search",
        data=b"{not json",
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            status = r.status
    except urllib.error.HTTPError as e:
        status = e.code
    assert status == 400


def test_embed_endpoint(server):
    status, body = _post(server, "/embed", {"texts": ["red", "blue"]})
    assert status == 200
    assert body["dim"] == 64
    import numpy as np

    e = np.array(body["text_embeddings"])
    assert e.shape == (2, 64)
    np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, rtol=1e-4)
    status, body = _post(server, "/embed", {})
    assert status == 400


def test_search_batch_endpoint(server):
    status, body = _post(server, "/search_batch", {"queries": ["red", "green", "blue"], "k": 2})
    assert status == 200
    assert len(body["results"]) == 3
    assert all(len(r) == 2 for r in body["results"])
    status, _ = _post(server, "/search_batch", {"queries": "notalist"})
    assert status == 400
    status, _ = _post(server, "/search_batch", {})
    assert status == 400


def test_search_batch_images(server, engine):
    """images_b64 in /search_batch: one vision pass for the group; each
    uploaded DB image ranks itself first; undecodable slots return null;
    text and image queries mix in one request."""
    import base64
    import sqlite3

    conn = sqlite3.connect(engine.db_path)
    paths = [r[0] for r in conn.execute(
        "SELECT file_path FROM images ORDER BY id LIMIT 2"
    ).fetchall()]
    conn.close()
    b64s = []
    for p in paths:
        with open(p, "rb") as f:
            b64s.append(base64.b64encode(f.read()).decode())
    b64s.append(base64.b64encode(b"junk, not an image").decode())

    status, body = _post(
        server, "/search_batch",
        {"queries": ["red"], "images_b64": b64s, "k": 2},
    )
    assert status == 200
    assert len(body["results"]) == 1 and len(body["results"][0]) == 2
    img_rows = body["image_results"]
    assert len(img_rows) == 3
    for p, rs in zip(paths, img_rows[:2]):
        assert rs[0]["path"] == p
        # bf16 batch-bucket divergence between query and indexed embeddings
        assert rs[0]["similarity"] == pytest.approx(1.0, abs=5e-3)
    assert img_rows[2] is None  # undecodable slot


def test_stats_metrics_counters(server):
    _post(server, "/search", {"query": "metric probe", "k": 1})
    status, body = _get(server, "/stats")
    assert status == 200
    assert body["requests"] >= 1
    assert body["searches"] >= 1
    assert "search_p50_ms" in body



def test_concurrent_searches_micro_batch(engine):
    """N concurrent plain-text queries must collapse into ~1 device pass and
    return the same results as sequential requests (VERDICT r1 item 5)."""
    import threading

    srv = SearchServer(engine, host="127.0.0.1", port=0, batch_window_ms=100)
    srv.start_background()
    try:
        queries = ["a red square", "a green square", "a blue square", "a red square"]
        # Sequential baseline (each its own batch — window only opens on
        # arrival, so lone requests return immediately after the window).
        baseline = {}
        for q in set(queries):
            status, body = _post(srv, "/search", {"query": q, "k": 3})
            assert status == 200
            baseline[q] = body["results"]
        passes_before = srv.batcher.device_passes

        results = [None] * len(queries)
        errors = []

        def fire(i, q):
            try:
                status, body = _post(srv, "/search", {"query": q, "k": 3})
                assert status == 200, body
                results[i] = body["results"]
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        # Barrier-release all threads at once so they land in one window.
        barrier = threading.Barrier(len(queries))

        def worker(i, q):
            barrier.wait()
            fire(i, q)

        threads = [threading.Thread(target=worker, args=(i, q)) for i, q in enumerate(queries)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        for q, r in zip(queries, results):
            # Paths must match; scores compare with a small tolerance — on
            # bf16 backends the text tower compiles per batch-size bucket and
            # low bits differ between the batched and sequential programs.
            assert [x["path"] for x in r] == [x["path"] for x in baseline[q]]
            import numpy as np

            np.testing.assert_allclose(
                [x["similarity"] for x in r],
                [x["similarity"] for x in baseline[q]],
                atol=5e-3,
            )
        # 4 concurrent requests, same (k, folders) -> one search_batch pass.
        passes = srv.batcher.device_passes - passes_before
        assert passes <= 2, f"expected micro-batching, got {passes} device passes"
        st = srv.batcher.stats()
        assert st["batched_requests"] >= len(queries)
    finally:
        srv.shutdown()


def test_sigterm_graceful_shutdown(engine, tmp_path):
    """`tpuclip serve` must drain and exit 0 on SIGTERM (the orchestrator
    stop signal), not die mid-request with a nonzero status."""
    import os
    import signal
    import subprocess
    import sys
    import time
    import urllib.request

    env = dict(os.environ)
    env.update({
        "PYTHONPATH": os.path.dirname(os.path.dirname(__file__)),
        "JAX_PLATFORMS": "cpu",
        "TPUCLIP_MODEL": "tpuclip/test-tiny",
        "TPUCLIP_HOME": str(tmp_path),
        "TPUCLIP_QUIET": "0",
    })
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuclip.cli", "serve",
         "--db", engine.db_path, "--port", "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        port = None
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "Serving on http://" in line:
                port = int(line.split(":")[-1].split()[0].strip("/"))
                break
        assert port, "server never reported ready"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=10) as r:
            assert r.status == 200
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        assert rc == 0, f"exit code {rc}"
    finally:
        if proc.poll() is None:
            proc.kill()


def test_api_fuzz_no_500(server):
    """Adversarial request bodies must map to 4xx (or succeed), never to an
    unhandled 500: wrong types, negative/huge k, null fields, deep nesting,
    unicode, and type confusion on every POST endpoint."""
    import random

    rng = random.Random(11)
    values = [
        None, True, False, 0, -5, 3.7, 1e18, "", "x", "a" * 500,
        "\x00\uffff\U0001f600", [], {}, [None], [[1, 2]], {"q": 1},
        ["red", None, 7], {"deep": {"deeper": [1, {"a": None}]}},
    ]
    fields = [
        "query", "queries", "image_b64", "images_b64", "image", "labels",
        "k", "folders", "negative", "negative_weight", "query2", "weights",
        "show_duplicates", "texts", "images",
    ]
    endpoints = ["/search", "/search_batch", "/classify", "/embed"]
    for trial in range(60):
        body = {
            rng.choice(fields): rng.choice(values)
            for _ in range(rng.randint(1, 4))
        }
        ep = rng.choice(endpoints)
        status, resp = _post(server, ep, body)
        assert status in (200, 400, 404), (
            f"{ep} {body!r} -> {status}: {resp}"
        )


def test_concurrent_image_uploads_micro_batch(engine):
    """N concurrent image_b64 uploads must collapse into ~1 batched
    vision-tower pass + 1 scan, each returning its own image first (decode
    happens on the handler threads; the batcher only sees PIL images)."""
    import base64
    import sqlite3
    import threading

    conn = sqlite3.connect(engine.db_path)
    paths = [r[0] for r in conn.execute(
        "SELECT file_path FROM images ORDER BY id"
    ).fetchall()]
    conn.close()
    payloads = []
    for p in paths + paths:  # 6 uploads over 3 distinct images
        with open(p, "rb") as f:
            payloads.append((p, base64.b64encode(f.read()).decode()))

    srv = SearchServer(engine, host="127.0.0.1", port=0, batch_window_ms=100)
    srv.start_background()
    try:
        # warm the vision/search programs so the burst lands in one window
        _post(srv, "/search", {"image_b64": payloads[0][1], "k": 2})
        passes_before = srv.batcher.device_passes

        results = [None] * len(payloads)
        errors = []
        barrier = threading.Barrier(len(payloads))

        def worker(i, b64):
            barrier.wait()
            try:
                status, body = _post(
                    srv, "/search", {"image_b64": b64, "k": 2}
                )
                assert status == 200, body
                results[i] = body["results"]
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [
            threading.Thread(target=worker, args=(i, b64))
            for i, (_, b64) in enumerate(payloads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        for (p, _), r in zip(payloads, results):
            assert r[0]["path"] == p
            assert r[0]["similarity"] == pytest.approx(1.0, abs=5e-3)
        passes = srv.batcher.device_passes - passes_before
        assert passes <= 3, f"expected image micro-batching, got {passes} passes"
        st = srv.batcher.stats()
        assert st["batched_requests"] >= len(payloads)
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def fused_server(tmp_path_factory):
    """Server whose index takes the fused tokenize→tower→scan device path
    (int8 precision + device rerank forced on)."""
    import os

    home = tmp_path_factory.mktemp("serve_fused")
    imgs = home / "imgs"
    imgs.mkdir()
    for name, c in [("red.jpg", (220, 30, 30)), ("green.png", (30, 200, 30)), ("blue.webp", (40, 40, 230))]:
        Image.new("RGB", (64, 64), c).save(imgs / name)
    old = {
        k: os.environ.get(k)
        for k in ("TPUCLIP_SEARCH_PRECISION", "TPUCLIP_DEVICE_RERANK")
    }
    os.environ["TPUCLIP_SEARCH_PRECISION"] = "int8"
    os.environ["TPUCLIP_DEVICE_RERANK"] = "1"
    try:
        eng = ImageDatabase(
            db_path=str(home / "f.db"),
            model_cache_dir=str(home / "models"),
            model_name="tpuclip/test-tiny",
            inference_batch_size=4,
        )
        eng.scan_directory(str(imgs), inference_batch_size=4)
        srv = SearchServer(eng, host="127.0.0.1", port=0)
        srv.start_background()
        yield srv
        srv.shutdown()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_fused_text_path_serves_and_matches(fused_server):
    """Queries through the micro-batcher's fused branch rank identically to
    the engine's two-stage embed+search."""
    assert fused_server.batcher.engine.index.can_fuse_text_search(2, None)
    status, body = _post(fused_server, "/search", {"query": "a red square", "k": 2})
    assert status == 200 and len(body["results"]) == 2
    vec = fused_server.batcher.engine.embed_texts(["a red square"])
    two_stage = fused_server.batcher.engine.index.search_batch(vec, 2)[0]
    assert [r["path"] for r in body["results"]] == [p for p, _ in two_stage]


def test_fused_concurrent_requests(fused_server):
    """Concurrent fused-path queries all succeed and batch."""
    import threading

    results = [None] * 6
    def hit(i):
        q = ["red thing", "green thing", "blue thing"][i % 3]
        results[i] = _post(fused_server, "/search", {"query": q, "k": 2})

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(status == 200 and len(body["results"]) == 2 for status, body in results)


def test_image_b64_search(server, engine):
    """Uploading the exact bytes of an indexed image must rank that image
    first (its own embedding is the query)."""
    import base64
    import sqlite3

    conn = sqlite3.connect(engine.db_path)
    a_path = conn.execute(
        "SELECT file_path FROM images ORDER BY id LIMIT 1"
    ).fetchone()[0]
    conn.close()
    with open(a_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()

    status, body = _post(server, "/search", {"image_b64": b64, "k": 3})
    assert status == 200
    assert body["results"][0]["path"] == a_path
    # 5e-3: on bf16 backends the query embeds at batch 1 and the indexed
    # row at the scan batch bucket — different compiled programs, low bits
    # differ (same tolerance rationale as the micro-batch test).
    assert body["results"][0]["similarity"] == pytest.approx(1.0, abs=5e-3)

    # both query and image_b64 → 400
    status, body = _post(server, "/search", {"image_b64": b64, "query": "x"})
    assert status == 400

    # garbage base64 → 400
    status, body = _post(server, "/search", {"image_b64": "!!!not-base64!!!"})
    assert status == 400

    # valid base64, not an image → 400
    import base64 as b64mod

    status, body = _post(
        server, "/search", {"image_b64": b64mod.b64encode(b"hello").decode()}
    )
    assert status == 400


def test_classify_endpoint(server, engine):
    """POST /classify: per-label probabilities from the resident engine,
    sorted by sigmoid descending, matching the library head exactly."""
    import base64
    import sqlite3

    from tpuclip.io.decode import load_image
    from tpuclip.pipelines.classify import classify_pil

    conn = sqlite3.connect(engine.db_path)
    a_path = conn.execute(
        "SELECT file_path FROM images ORDER BY id LIMIT 1"
    ).fetchone()[0]
    conn.close()
    labels = ["a red square", "a green square", "a blue square"]
    with open(a_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()

    status, body = _post(server, "/classify", {"image_b64": b64, "labels": labels})
    assert status == 200
    got = [(r["label"], r["prob"], r["rel"]) for r in body["labels"]]
    assert sorted(l for l, _, _ in got) == sorted(labels)
    probs = [p for _, p, _ in got]
    assert probs == sorted(probs, reverse=True)
    assert all(0.0 <= p <= 1.0 for p in probs)
    rels = [r for _, _, r in got]
    assert sum(rels) == pytest.approx(1.0, abs=1e-4)
    want = classify_pil(engine, load_image(a_path), labels)
    assert [l for l, _, _ in got] == [l for l, _, _ in want]
    for (_, p, r), (_, wp, wr) in zip(got, want):
        assert p == pytest.approx(wp, abs=1e-5)
        assert r == pytest.approx(wr, abs=1e-5)

    # server-local path variant agrees
    status, body2 = _post(server, "/classify", {"image": a_path, "labels": labels})
    assert status == 200 and body2 == body

    # bad requests
    assert _post(server, "/classify", {"labels": labels})[0] == 400  # no image
    assert _post(server, "/classify", {"image": a_path})[0] == 400  # no labels
    assert _post(
        server, "/classify", {"image": a_path, "image_b64": b64, "labels": labels}
    )[0] == 400  # both sources
    assert _post(
        server, "/classify", {"image_b64": "!!!", "labels": labels}
    )[0] == 400  # bad base64
    status, body2 = _post(
        server, "/classify", {"image": a_path, "labels": ["x"] * 10_000}
    )
    assert status == 400 and "too many labels" in body2["error"]


def test_embed_images_b64(server, engine):
    import base64
    import sqlite3

    conn = sqlite3.connect(engine.db_path)
    a_path = conn.execute(
        "SELECT file_path FROM images ORDER BY id LIMIT 1"
    ).fetchone()[0]
    conn.close()
    with open(a_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    status, body = _post(
        server, "/embed", {"images_b64": [b64, base64.b64encode(b"junk").decode()]}
    )
    assert status == 200
    embs = body["image_b64_embeddings"]
    assert len(embs) == 2
    assert embs[1] is None  # undecodable slot maps to None
    import numpy as np

    v = np.asarray(embs[0], np.float32)
    assert v.shape == (body["dim"],)
    assert abs(np.linalg.norm(v) - 1.0) < 1e-3
    # must equal the path-based embedding of the same file
    status, body2 = _post(server, "/embed", {"images": [a_path]})
    np.testing.assert_allclose(
        v, np.asarray(body2["image_embeddings"][0], np.float32), atol=1e-5
    )


def test_embed_rejects_non_list_fields(server):
    """A bare string would iterate per character (one embed attempt per
    char); the endpoint must reject non-list fields outright."""
    for payload in (
        {"texts": "a red car"},
        {"images": "/some/path.jpg"},
        {"images_b64": "QUJD"},
    ):
        status, body = _post(server, "/embed", payload)
        assert status == 400, payload


def test_serve_in_cascade_mode(engine, monkeypatch):
    """End-to-end serving with TPUCLIP_SEARCH_MODE=cascade: /search works,
    /stats reports the active mode, and no flat device matrix is resident."""
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", "64")
    from tpuclip.index.search import DeviceIndex

    # fresh index picks the mode up from the env
    old_index = engine.index
    engine.index = DeviceIndex(engine.store, device=engine.device)
    srv = SearchServer(engine, host="127.0.0.1", port=0)
    srv.start_background()
    try:
        status, body = _post(srv, "/search", {"query": "a red square", "k": 2})
        assert status == 200 and len(body["results"]) == 2
        status, body = _get(srv, "/stats")
        assert body["search_mode"] == "cascade"
        assert body["cascade_active"] is True
        assert engine.index._matrix is None
    finally:
        srv.shutdown()
        engine.index = old_index


def test_fused_mixed_window_combines_scan(fused_server):
    """A window holding BOTH text queries and image uploads takes the
    combined mixed program (both towers + ONE shared scan, r4): every
    request gets its own correct result, the upload ranks itself first,
    and the group resolves in one device pass."""
    import base64
    import sqlite3
    import threading

    eng = fused_server.batcher.engine
    assert eng.index.can_fuse_text_search(2, None)
    conn = sqlite3.connect(eng.db_path)
    img_path = conn.execute(
        "SELECT file_path FROM images ORDER BY id LIMIT 1"
    ).fetchone()[0]
    conn.close()
    with open(img_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()

    # warm both program shapes so the burst lands in one window
    _post(fused_server, "/search", {"query": "warm", "k": 2})
    _post(fused_server, "/search", {"image_b64": b64, "k": 2})

    payloads = [
        {"query": "a red square", "k": 2},
        {"query": "something green", "k": 2},
        {"image_b64": b64, "k": 2},
        {"image_b64": b64, "k": 2},
    ]
    results = [None] * len(payloads)
    errors = []
    barrier = threading.Barrier(len(payloads))

    def worker(i):
        barrier.wait()
        try:
            status, body = _post(fused_server, "/search", payloads[i])
            assert status == 200, body
            results[i] = body["results"]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    passes_before = fused_server.batcher.device_passes
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors

    # text results match the two-stage oracle
    vec = eng.embed_texts(["a red square"])
    oracle = eng.index.search_batch(vec, 2)[0]
    assert [r["path"] for r in results[0]] == [p for p, _ in oracle]
    # uploads find themselves
    for r in (results[2], results[3]):
        assert r[0]["path"] == img_path
        assert r[0]["similarity"] == pytest.approx(1.0, abs=5e-3)
    # the whole burst resolved in few device passes (mixed windows take 1;
    # allow slack for requests split across windows under thread jitter)
    assert fused_server.batcher.device_passes - passes_before <= 3


def test_sustained_mixed_load_and_batcher_instrumentation(engine):
    """The r5 serve-load surface (VERDICT r4 item 3): sustained concurrent
    mixed load through real HTTP must complete error-free (c=24 exceeds
    the old socketserver backlog of 5 that reset connections), and the
    micro-batcher must account for it: window histogram, window count,
    lock-wait and process time all populated and consistent."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    from serve_load import make_test_image_b64, run_load

    srv = SearchServer(engine, host="127.0.0.1", port=0)
    srv.start_background()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        b0 = srv.batcher.stats()
        r = run_load(base, duration_s=3.0, concurrency=24, k=3,
                     image_b64=make_test_image_b64(48))
        assert r["error_count"] == 0, r["errors"]
        assert r["requests"] > 0 and r["qps_queries"] >= r["qps_requests"]
        assert r["counts"]["text"] > 0 and r["counts"]["image"] > 0
        assert r["counts"]["batch"] > 0
        b1 = srv.batcher.stats()
        windows = b1["windows"] - b0["windows"]
        assert windows > 0
        # Every batched request is accounted to exactly one window size.
        hist_delta = sum(
            v - b0["window_size_hist"].get(k, 0)
            for k, v in b1["window_size_hist"].items()
        )
        assert hist_delta == windows
        assert b1["process_s"] > b0["process_s"]
        assert b1["lock_wait_s"] >= b0["lock_wait_s"]
        assert b1["device_passes"] > b0["device_passes"]
    finally:
        srv.shutdown()


def test_warm_programs_handles_nonfused_index(engine):
    """warm_programs (the `serve --warm` routine) must no-op gracefully
    when the index is not fused-eligible (CPU backend) and return the
    call count otherwise — it is also the serve-load bench's warm step."""
    from tpuclip.serve import warm_programs

    n = warm_programs(engine, k=3)
    if engine.index.can_fuse_text_search(3, None):
        # Complete matrix: 4 text + 1 image + 16 mixed per method (x2),
        # plus 3 batch shapes.
        assert n == 2 * (4 + 1 + 16) + 3
    else:
        assert n == 0

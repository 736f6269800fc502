"""Sustained concurrent load generator for the tpuclip HTTP server.

Kernel timings measure the device, not the server loop — window
formation, handler threads, the engine lock and the fallback policy only
show under sustained mixed load. This generator runs N concurrent clients
for a fixed duration with a mixed workload (plain-text /search, image_b64
/search, /search_batch), all through real HTTP, and reports qps,
per-endpoint counts, errors and wall percentiles. It is closed-loop: each
client sends its next request when the previous one returns.

Reusable: bench.py imports run_load(); standalone CLI drives any running
server:

    python scripts/serve_load.py --url http://127.0.0.1:8000 \
        --duration 30 --concurrency 16
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
import urllib.request

# Workload mix per 20-request cycle (deterministic, no RNG needed):
# 14 plain text : 3 image_b64 : 3 batch-of-4  ≈ 70/15/15.
_CYCLE = ("text",) * 14 + ("image",) * 3 + ("batch",) * 3

_QUERY_POOL = (
    "a red car", "sunset over mountains", "a cat sleeping", "blueprint",
    "portrait photo", "abstract painting", "city at night", "forest path",
    "a red car",  # repeats exercise the text-dedup path in the batcher
    "food on a table", "snowy landscape", "a cat sleeping",
)


def make_test_image_b64(size: int = 96) -> str:
    """Small deterministic JPEG for the image_b64 share (pure PIL)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(7)
    arr = (rng.random((size, size, 3)) * 255).astype("uint8")
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _post(url: str, payload: dict, timeout: float):
    body = json.dumps(payload).encode("utf-8")
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def run_load(
    base_url: str,
    duration_s: float,
    concurrency: int,
    k: int = 20,
    image_b64: str = None,
    timeout: float = 120.0,
) -> dict:
    """Drive the server with `concurrency` clients for `duration_s`.

    Returns {qps_requests, qps_queries, counts, errors, wall_p50_ms,
    wall_p99_ms, duration_s, concurrency}. qps_queries counts each
    batch-of-4 as 4 (the serving-throughput unit the kernel ceilings are
    stated in); qps_requests counts HTTP round trips.
    """
    if image_b64 is None:
        image_b64 = make_test_image_b64()
    deadline = time.perf_counter() + duration_s
    lock = threading.Lock()
    walls: list = []
    counts = {"text": 0, "image": 0, "batch": 0}
    errors: list = []  # capped SAMPLE of error messages
    error_total = [0]  # unbounded failure count (len(errors) saturates at
    queries_done = [0]  # the sample cap and would hide degradation)

    def client(cid: int) -> None:
        i = cid  # offset so clients interleave endpoint kinds
        while time.perf_counter() < deadline:
            kind = _CYCLE[i % len(_CYCLE)]
            q = _QUERY_POOL[i % len(_QUERY_POOL)]
            i += 1
            try:
                t0 = time.perf_counter()
                if kind == "text":
                    _post(f"{base_url}/search", {"query": q, "k": k}, timeout)
                    nq = 1
                elif kind == "image":
                    _post(
                        f"{base_url}/search",
                        {"image_b64": image_b64, "k": k}, timeout,
                    )
                    nq = 1
                else:
                    qs = [_QUERY_POOL[(i + j) % len(_QUERY_POOL)] for j in range(4)]
                    _post(
                        f"{base_url}/search_batch",
                        {"queries": qs, "k": k}, timeout,
                    )
                    nq = 4
                wall = time.perf_counter() - t0
                with lock:
                    walls.append(wall)
                    counts[kind] += 1
                    queries_done[0] += nq
            except Exception as e:  # noqa: BLE001 - recorded, load continues
                with lock:
                    error_total[0] += 1
                    if len(errors) < 10:
                        errors.append(f"{kind}: {type(e).__name__}: {e}"[:120])

    t_start = time.perf_counter()
    threads = [
        threading.Thread(target=client, args=(c,), daemon=True)
        for c in range(concurrency)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + timeout)
    elapsed = time.perf_counter() - t_start

    import numpy as np

    walls_ms = np.asarray(walls) * 1000 if walls else np.zeros(1)
    return {
        "duration_s": round(elapsed, 2),
        "concurrency": concurrency,
        "requests": len(walls),
        "qps_requests": round(len(walls) / elapsed, 1),
        "qps_queries": round(queries_done[0] / elapsed, 1),
        "counts": counts,
        "error_count": error_total[0],
        "errors": errors[:5],
        "wall_p50_ms": round(float(np.percentile(walls_ms, 50)), 1),
        "wall_p99_ms": round(float(np.percentile(walls_ms, 99)), 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default="http://127.0.0.1:8000")
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("-k", type=int, default=20)
    args = ap.parse_args()
    out = run_load(args.url, args.duration, args.concurrency, k=args.k)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()

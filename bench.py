"""Benchmark on one NVIDIA GPU: ALWAYS prints ONE JSON line, even on a kill.

Primary metric: p50 top-20 query latency over 1M 1152-d vectors through the
production default search path — ``DeviceIndex`` in int8 mode with the fused
device rescore (``platform.default_precision`` on the GPU). Every other field
is a sub-bench of the same process: the bf16 flat scan, batch throughput,
binary and cascade search, fused text and image queries, the SO400M image
tower, the end-to-end scan of a JPEG tree, the train step and the HTTP
server under load.

Every result names the device it ran on (platform, device_kind, count, and
the card's name and power limit from nvidia-smi). There is no CPU fallback:
without a GPU the run fails. Times are host-clock medians around work that
ends in ``jax.block_until_ready``; compilation is warmed first and reported
apart. Data is generated from fixed seeds.

Emission contract: the full dict goes to ``bench_full.json`` (gitignored);
stdout carries only a compact summary line, re-printed after every
sub-bench, so a kill at any moment leaves the richest-so-far record as the
last line. A watchdog flushes it when the budget runs out.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import threading
import time

import numpy as np

_T0 = time.perf_counter()
_REPO = os.path.dirname(os.path.abspath(__file__))
BUDGET_S = float(os.environ.get("TPUCLIP_BENCH_BUDGET_S", 900))
# The watchdog fires this long after the budget: between-bench checks keep
# the happy path under budget; the grace covers one bench started near it.
WATCHDOG_GRACE_S = 90.0

RESULT = {
    "metric": "p50 top-20 query latency over 1M x 1152 vectors (1 GPU)",
    "value": None,
    "unit": "ms",
    "vs_baseline": None,
}
# RLock: the SIGTERM handler runs ON the main thread and calls _emit — with
# a plain Lock, a signal landing while the main thread is already inside
# _emit would deadlock the very flush the handler exists to guarantee.
_EMIT_LOCK = threading.RLock()
_EMITTED = False
_DONE = threading.Event()

_FULL_RECORD_PATH = os.path.join(_REPO, "bench_full.json")
# The four-key contract first (never dropped), then the per-mode numbers in
# priority order — the tail of this tuple is shed first if the line ever
# approaches the cap.
_SUMMARY_KEYS = (
    "metric", "value", "unit", "vs_baseline",
    "headline_p99_ms", "platform", "device_kind", "device_count", "gpu",
    "bf16_scan_p50_ms", "batch16_qps", "batch64_qps",
    "text_query_fused_ms", "image_query_fused_ms",
    "binary_p50_ms", "cascade_p50_ms",
    "indexing_images_per_sec", "end_to_end_images_per_sec",
    "train_images_per_sec", "served_load_qps",
    "stage", "elapsed_s", "partial", "terminated_by", "watchdog_flush",
    "error",
)
_SUMMARY_MAX_CHARS = 1500  # well under a ~2000-char stdout tail


def _dbg(msg: str) -> None:
    """Progress trace on STDERR (stdout carries only JSON lines)."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _shed_to_cap(summary):
    """Serialize ``summary`` under _SUMMARY_MAX_CHARS, shedding
    lowest-priority keys as needed; the four contract keys AND the
    full-record pointer are never dropped. Returns the line, or None if it
    cannot round-trip as JSON. Mutates ``summary``."""
    line = json.dumps(summary)
    while len(line) > _SUMMARY_MAX_CHARS:
        for k in reversed(list(summary)):
            if k not in ("metric", "value", "unit", "vs_baseline", "full_record"):
                del summary[k]
                break
        else:
            break
        line = json.dumps(summary)
    try:
        json.loads(line)  # self-check: the line must round-trip
    except ValueError:
        return None
    return line


def _emit(final: bool = True):
    """Flush the cumulative result: full dict to the full-record file,
    compact summary as ONE short JSON line on stdout. The final/flush call
    wins the lock once and marks emission done."""
    global _EMITTED
    with _EMIT_LOCK:
        if _EMITTED:
            return
        RESULT["elapsed_s"] = round(time.perf_counter() - _T0, 1)
        # The benches mutate RESULT from the main thread without the lock,
        # so a dump from the watchdog thread can catch the dict
        # mid-mutation; retry instead of letting the flush die on it.
        for _ in range(1000):
            try:
                full = json.dumps(RESULT)
                summary = {k: RESULT[k] for k in _SUMMARY_KEYS if k in RESULT}
                break
            except RuntimeError:
                continue
        else:
            return  # un-dumpable right now; a later flush will retry
        summary["full_record"] = os.path.basename(_FULL_RECORD_PATH)
        line = _shed_to_cap(summary)
        if line is None:
            return  # never print a malformed line; a later flush retries
        try:
            tmp = _FULL_RECORD_PATH + ".tmp"
            with open(tmp, "w") as f:
                f.write(full + "\n")
            os.replace(tmp, _FULL_RECORD_PATH)
        except OSError as e:
            # Disk trouble must not block the stdout record; the mutated
            # summary goes back through the same cap/round-trip path.
            summary["full_record"] = f"unwritable: {e}"[:80]
            line = _shed_to_cap(summary)
            if line is None:
                return
        print(line, flush=True)
        if final:
            _EMITTED = True


def _flush_and_exit(signum, _frame):
    with _EMIT_LOCK:  # mutations race json.dumps(RESULT) otherwise
        RESULT["partial"] = True
        RESULT["terminated_by"] = signal.Signals(signum).name
    _emit()
    os._exit(1)


def _remaining() -> float:
    return BUDGET_S - (time.perf_counter() - _T0)


def _watchdog():
    while not _DONE.wait(2.0):
        if _remaining() < -WATCHDOG_GRACE_S:
            with _EMIT_LOCK:
                RESULT["partial"] = True
                RESULT["watchdog_flush"] = True
            _emit()
            os._exit(1)


# =============================================================================
# Device identity and timing
# =============================================================================


def device_record(jax) -> dict:
    """What the numbers were measured on. Raises unless the first device is
    a GPU that tpuclip.platform knows: a CPU number is never recorded under
    a device metric."""
    from tpuclip import platform
    from tpuclip.utils.gpu_info import query_name_power

    d = jax.devices()[0]
    if platform.platform_of(d) != "gpu":
        raise RuntimeError(f"bench.py measures a GPU; found {d.platform!r}")
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "gpu": query_name_power()[0],
        "jax_version": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def time_ms(jax, fn, *args, reps: int = 50, warm: int = 2):
    """(p50, p99) milliseconds of ``fn(*args)`` on the host clock, each
    call ending in ``block_until_ready``; ``warm`` untimed calls first."""
    for _ in range(warm):
        jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append((time.perf_counter() - t) * 1e3)
    return float(np.percentile(walls, 50)), float(np.percentile(walls, 99))


# =============================================================================
# Sub-benches
# =============================================================================

_STATE = {}


def _index(jax, n, d=1152):
    """A 1M-row synthetic DB and its DeviceIndex in the GPU default mode
    (int8 + fused device rescore), built once and shared."""
    if "index" in _STATE:
        return _STATE["index"]
    sys.path.insert(0, _REPO)
    from scripts.synthetic import build_synthetic_db
    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore

    tmp = tempfile.mkdtemp(prefix="tpuclip_bench_")
    db = os.path.join(tmp, "bench.db")
    os.environ["TPUCLIP_HOME"] = os.path.join(tmp, "home")
    _dbg(f"building a {n}-row synthetic DB")
    build_synthetic_db(db, n, d, seed=0)
    store = MetadataStore(db, embedding_dim=d)
    idx = DeviceIndex(store)
    t = time.perf_counter()
    idx.refresh()
    RESULT["index_load_s"] = round(time.perf_counter() - t, 2)
    _STATE.update(index=idx, tmp=tmp, store=store)
    return idx


def bench_search(jax, n):
    """Single-query and batch latency through DeviceIndex (the serving
    entry point), default int8 mode, then the bf16 flat scan."""
    from tpuclip.index.search import DeviceIndex

    idx = _index(jax, n)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((64, idx.store.embedding_dim)).astype(np.float32)
    p50, p99 = time_ms(jax, lambda: idx.search(q[0], 20), reps=100)
    RESULT["value"] = round(p50, 3)
    RESULT["headline_p99_ms"] = round(p99, 3)
    RESULT["precision"] = idx.precision
    for b in (16, 64):
        p50_b, _ = time_ms(jax, lambda b=b: idx.search_batch(q[:b], 20), reps=30)
        RESULT[f"batch{b}_p50_ms"] = round(p50_b, 3)
        RESULT[f"batch{b}_qps"] = round(b / (p50_b / 1e3), 1)
    flat = DeviceIndex(idx.store, precision="bf16")
    flat.refresh()
    RESULT["bf16_scan_p50_ms"] = round(time_ms(jax, lambda: flat.search(q[0], 20))[0], 3)
    del flat


def bench_binary_cascade(jax, n):
    from tpuclip.index.search import DeviceIndex

    idx = _index(jax, n)
    q = np.random.default_rng(2).standard_normal(idx.store.embedding_dim).astype(np.float32)
    # A zero flat-matrix cap serves from the packed binary index (the
    # reference's binary fallback tier).
    os.environ["TPUCLIP_INDEX_HBM_GB"] = "0"
    try:
        binary = DeviceIndex(idx.store)
        binary.refresh()
        RESULT["binary_p50_ms"] = round(time_ms(jax, lambda: binary.search(q, 20))[0], 3)
    finally:
        os.environ.pop("TPUCLIP_INDEX_HBM_GB", None)
    os.environ["TPUCLIP_SEARCH_MODE"] = "cascade"
    try:
        casc = DeviceIndex(idx.store)
        casc.refresh()
        RESULT["cascade_p50_ms"] = round(time_ms(jax, lambda: casc.search(q, 20))[0], 3)
    finally:
        os.environ.pop("TPUCLIP_SEARCH_MODE", None)


def _engine(jax):
    """An SO400M ImageDatabase (random weights) over the bench DB."""
    if "engine" in _STATE:
        return _STATE["engine"]
    from tpuclip.engine import ImageDatabase

    os.environ.setdefault("TPUCLIP_INIT", "random")
    os.environ["TPUCLIP_QUIET"] = "1"
    idx = _STATE["index"]
    eng = ImageDatabase(db_path=idx.store.db_path, inference_batch_size=64)
    eng.index = idx
    _STATE["engine"] = eng
    return eng


def bench_fused_queries(jax, n):
    """Text and image queries as one device program each (tower + scan +
    rescore), through the engine's fused paths."""
    _index(jax, n)
    eng = _engine(jax)
    assert eng.index.can_fuse_text_search(20, None)
    RESULT["text_query_fused_ms"] = round(
        time_ms(jax, lambda: eng._search_texts_fused(["a red car"], 20), reps=30)[0], 3)
    px = np.random.default_rng(3).integers(0, 256, (224, 224, 3), dtype=np.uint8)
    from PIL import Image

    img = Image.fromarray(px)
    RESULT["image_query_fused_ms"] = round(
        time_ms(jax, lambda: eng._search_image_fused(img, 20), reps=30)[0], 3)


def bench_indexing(jax):
    """SO400M image-tower forward throughput at the scan batch (64)."""
    import jax.numpy as jnp

    from tpuclip.models.configs import get_config
    from tpuclip.models.siglip import get_image_features, init_params

    cfg = get_config("google/siglip2-so400m-patch14-224")
    params = jax.jit(lambda k: init_params(k, cfg, dtype=jnp.bfloat16))(jax.random.PRNGKey(0))
    px = jnp.asarray(np.random.default_rng(4).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8))
    p50, _ = time_ms(jax, lambda: get_image_features(params, px, cfg, compute_dtype=jnp.bfloat16), reps=20)
    RESULT["indexing_images_per_sec"] = round(64 / (p50 / 1e3), 1)


def bench_e2e_scan(jax):
    """The scan CLI path over a synthetic 1024x768 JPEG tree into a fresh DB."""
    sys.path.insert(0, _REPO)
    from scripts.synthetic import make_jpeg_tree
    from tpuclip.engine import ImageDatabase

    tmp = tempfile.mkdtemp(prefix="tpuclip_bench_e2e_")
    n = 1024
    root = make_jpeg_tree(os.path.join(tmp, "imgs"), n)
    eng = ImageDatabase(db_path=os.path.join(tmp, "e2e.db"), inference_batch_size=64)
    warm = make_jpeg_tree(os.path.join(tmp, "warm"), 128, seed=8)
    eng.scan_directory(warm, batch_size=256)
    t = time.perf_counter()
    eng.scan_directory(root, batch_size=256)
    RESULT["end_to_end_images_per_sec"] = round(n / (time.perf_counter() - t), 1)


def bench_train(jax):
    """SO400M contrastive train step at batch 32 (random weights)."""
    import jax.numpy as jnp

    from tpuclip.models.configs import get_config
    from tpuclip.models.siglip import init_params
    from tpuclip.parallel.training import init_train_state, make_optimizer, make_train_step

    cfg = get_config("google/siglip2-so400m-patch14-224")
    params = jax.jit(lambda k: init_params(k, cfg))(jax.random.PRNGKey(0))
    opt = make_optimizer(learning_rate=1e-5)
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt, compute_dtype=jnp.bfloat16)
    rng = np.random.default_rng(5)
    px = jnp.asarray(rng.integers(0, 256, (32, 224, 224, 3), dtype=np.uint8))
    ids = jnp.asarray(rng.integers(1, cfg.text.vocab_size, (32, cfg.text.max_length)), jnp.int32)
    box = [state]

    def one():
        box[0], loss = step(box[0], px, ids)
        return loss

    p50, _ = time_ms(jax, one, reps=5)
    RESULT["train_images_per_sec"] = round(32 / (p50 / 1e3), 1)


def bench_served_load(jax, n):
    """The HTTP server, in this process, over the bench DB at c=16 for 10 s
    with the serve_load mix (70% text, 15% image upload, 15% batch of 4)."""
    sys.path.insert(0, _REPO)
    from scripts.serve_load import make_test_image_b64, run_load
    from tpuclip.serve import SearchServer, warm_programs

    _index(jax, n)
    eng = _engine(jax)
    warm_programs(eng, k=20)
    server = SearchServer(eng, port=0)
    server.start_background()
    try:
        base = f"http://{server.host}:{server.port}"
        img = make_test_image_b64()
        run_load(base, 3.0, 16, image_b64=img)
        r = run_load(base, 10.0, 16, image_b64=img)
        RESULT["served_load_qps"] = r["qps_queries"]
        RESULT["served_load_c16"] = r
    finally:
        server.shutdown()


def main():
    signal.signal(signal.SIGTERM, _flush_and_exit)
    signal.signal(signal.SIGINT, _flush_and_exit)
    threading.Thread(target=_watchdog, daemon=True).start()
    RESULT["stage"] = "device"
    _emit(final=False)
    import jax

    from tpuclip.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    try:
        RESULT.update(device_record(jax))
    except RuntimeError as e:
        RESULT["error"] = str(e)[:200]
        _emit()
        sys.exit(1)
    RESULT["stage"] = "measuring"
    n = 1_000_000
    RESULT["n_vectors"] = n
    timings = RESULT.setdefault("bench_seconds", {})
    for name, est_s, fn in (
        ("search", 120, lambda: bench_search(jax, n)),
        ("binary_cascade", 30, lambda: bench_binary_cascade(jax, n)),
        ("fused_queries", 90, lambda: bench_fused_queries(jax, n)),
        ("indexing", 60, lambda: bench_indexing(jax)),
        ("served_load", 150, lambda: bench_served_load(jax, n)),
        ("e2e_scan", 120, lambda: bench_e2e_scan(jax)),
        ("train", 120, lambda: bench_train(jax)),
    ):
        if _remaining() < est_s:
            RESULT[f"{name}_skipped_for_budget"] = True
            continue
        t0 = time.perf_counter()
        _dbg(f"{name}: start")
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - recorded; later benches run
            RESULT[f"{name}_error"] = f"{type(e).__name__}: {e}"[:200]
            _dbg(f"{name}: ERROR {e}")
        timings[name] = round(time.perf_counter() - t0, 1)
        _emit(final=False)
    RESULT["stage"] = "done"
    failed = [k for k in RESULT if k.endswith("_error")]
    _DONE.set()
    _emit()
    sys.exit(1 if failed or RESULT["value"] is None else 0)


if __name__ == "__main__":
    main()

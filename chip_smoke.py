"""GPU smoke run: scan → index → search → serve → train on one NVIDIA GPU.

Drives tpuclip's main path once through the entry points a user calls
(``ImageDatabase``, ``DeviceIndex``, the ``scan``/``search`` CLI, the HTTP
server, the trainer) at the full width of google/siglip2-so400m-patch14-224
with random weights from a seed, over a 1M-row index of seeded 1152-d unit
vectors. Every phase compares what comes out with a plain reference (fp32
towers at highest precision, numpy exact top-k, the XLA int8 scan) and
prints one JSON line with its numbers and the card's name and power limit.
A failed phase fails the run. The last line of stdout is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Usage (one process; it is the only JAX process on the card while it runs):

    python chip_smoke.py            # one GPU, phases 0-7
    python chip_smoke.py --multi    # four GPUs: DP train step + sharded index

Without an NVIDIA GPU it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List, Sequence

import numpy as np

from tpuclip.utils.gpu_info import query_name_power

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = "google/siglip2-so400m-patch14-224"
K = 20
N_ROWS = 1_000_000
# Rows of the --multi sharded index. Four times N_ROWS was the aim; the
# seeded 1M-row DB build alone takes minutes on the four-card host.
N_ROWS_MULTI = 1_000_000
D = 1152

# Score tolerance of the device searches that score bf16 operands (the
# int8 scan's exact rescore, the bf16 flat scan). They multiply the
# bf16-rounded query by the bf16-rounded rows: each product is exact in f32
# (8 + 8 significant bits), so a device score differs from the exact dot of
# the ROUNDED operands only by f32 summation over D terms,
# |err| <= D * 2^-24 * sum_i |q_i r_i| <= D * 2^-24 for unit vectors
# (6.9e-5). The reference is that dot (bf16_reference); each returned score
# must lie within this of it, and each returned row must be a top-k row of
# the reference within twice it (tie_aware_topk_ok). An int8 scan without
# the rescore errs by ~1e-3 and fails both.
SCORE_TOL_SUM = D * 2.0 ** -24
# Paths that rescore in host f32 (cascade, the masked host rerank) differ
# from the f32 reference only by summation order.
SCORE_TOL_F32 = 1e-5
# A served query's embedding comes from a tower program of another batch
# shape than /embed's (bf16 numerics differ at cos ~ 1 - 3e-5). That moves a
# row's score by |delta_e . r| ~ |delta_e| / sqrt(D), ~1e-3 at the phase's
# own embedding bound (cos >= 0.9999); a result sent to the wrong request
# is off by ~0.1.
SERVE_DRIFT_MAX = 2.0 ** -8
# One DP train step (SGD, lr 1, so the update IS the gradient) on all cards
# vs one card, both in f32 at highest matmul precision: only summation order
# differs (relative ~1e-6). A gradient not averaged over the shards is off
# by (ndev - 1), a step on one shard's batch by O(1).
DP_GRAD_TOL = 1e-3
DP_LOSS_TOL = 1e-5


# ---------------------------------------------------------------------------
# Helpers (no JAX here: the module is imported by CPU tests)
# ---------------------------------------------------------------------------


def last_line(platform: str, kind: str, count: int) -> str:
    """The run's final stdout line."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def require_gpu(platform: str) -> None:
    """Refuse any platform but the GPU: a CPU run says nothing about the card."""
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU, JAX found {platform!r}")


def tie_aware_topk_ok(returned: Sequence[int], exact_scores: np.ndarray, k: int,
                      tol: float) -> Dict:
    """Check a returned top-``k`` against exact scores, allowing ties.

    ``returned``: row ids in returned order. ``exact_scores``: the exact
    score of every candidate row. Passes when ``k`` distinct valid rows came
    back and each one's exact score is >= the exact k-th best minus
    ``tol`` — so near-ties inside the tolerance may swap, anything else is a
    miss. Also reports recall against the exact top-k set."""
    exact_scores = np.asarray(exact_scores)
    kk = min(k, len(exact_scores))
    order = np.argsort(-exact_scores, kind="stable")[:kk]
    kth = float(exact_scores[order[-1]])
    rows = np.asarray(list(returned), np.int64)
    ok = len(rows) == kk and len(set(rows.tolist())) == kk
    worst = 0.0
    if len(rows):
        valid = (rows >= 0) & (rows < len(exact_scores))
        ok = ok and bool(valid.all())
        rows = rows[valid]
        if len(rows):
            worst = float(kth - exact_scores[rows].min())
            ok = ok and worst <= tol
    recall = len(set(rows.tolist()) & set(order.tolist())) / max(1, kk)
    return {"ok": bool(ok), "shortfall": worst, "recall": recall}


def round_to_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    returned as float32: numpy's twin of the device's
    ``round_f32_to_bf16_bits``. Finite inputs only."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def bf16_reference(queries: np.ndarray, rows_bf16: np.ndarray) -> np.ndarray:
    """(Q, N) dots of the bf16-rounded queries with rows already rounded by
    :func:`round_to_bf16`: the scores a bf16 device search computes, up to
    f32 summation order."""
    return round_to_bf16(queries) @ rows_bf16.T


def check_topk(rows: Sequence[Sequence[int]], scores: Sequence[Sequence[float]],
               ref: np.ndarray, k: int, row_tol: float,
               score_tol: float = None) -> Dict:
    """Per-query :func:`tie_aware_topk_ok` of the returned ``rows`` against
    the reference scores ``ref`` (Q, N), and, with ``score_tol``, each
    returned score against its row's reference score."""
    checks, score_err = [], 0.0
    for qi, (r, sc) in enumerate(zip(rows, scores)):
        r = np.asarray(r, np.int64)
        checks.append(tie_aware_topk_ok(r, ref[qi], k, row_tol))
        valid = (r >= 0) & (r < ref.shape[1])
        if valid.any():
            err = np.abs(np.asarray(sc, np.float64)[valid] - ref[qi][r[valid]])
            score_err = max(score_err, float(err.max()))
    ok = all(c["ok"] for c in checks)
    if score_tol is not None:
        ok = ok and score_err <= score_tol
    return {"ok": bool(ok), "shortfall": max(c["shortfall"] for c in checks),
            "recall": float(np.mean([c["recall"] for c in checks])),
            "score_err": score_err}


def parse_cli_results(text: str) -> List[tuple]:
    """``(path, similarity)`` pairs from the search CLI's result lines
    (``"  0.1234: /path"``)."""
    out = []
    for line in text.splitlines():
        m = re.match(r"^\s+(-?\d+\.\d{4}): (.+)$", line)
        if m:
            out.append((m.group(2), float(m.group(1))))
    return out


class Smoke:
    """Phase bookkeeping: each phase prints one JSON line."""

    def __init__(self, gpu_line: str):
        self.gpu = gpu_line
        self._t = time.time()

    def emit(self, phase: str, ok: bool, **numbers) -> None:
        now = time.time()
        line = {"phase": phase, "ok": bool(ok), **numbers,
                "phase_s": round(now - self._t, 1), "gpu": self.gpu}
        self._t = now
        print(json.dumps(line, default=_json_default), flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: phase {phase!r} failed")


def _json_default(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def _row_of(path: str) -> int:
    """Row index of a synthetic DB path (``.../img_00001234.jpg``)."""
    return int(path.rsplit("_", 1)[1].split(".")[0])


def _median_ms(jax, fn, reps: int = 40) -> float:
    jax.block_until_ready(fn())
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append((time.perf_counter() - t) * 1e3)
    return float(np.median(walls))


# ---------------------------------------------------------------------------
# Phases (one GPU)
# ---------------------------------------------------------------------------


def phase_gpu_tests(s: Smoke) -> None:
    """pytest -m gpu as a child, before this process imports JAX."""
    env = dict(os.environ, TPUCLIP_TEST_GPU="1")
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-8000:] + proc.stderr[-4000:])
    s.emit("gpu-tests", proc.returncode == 0, rc=proc.returncode,
           summary=tail[0], seconds=round(time.time() - t, 1))


def phase_device(s: Smoke, jax) -> None:
    d = jax.devices()[0]
    require_gpu(d.platform)
    s.emit("device", True, platform=d.platform, kind=d.device_kind,
           count=len(jax.devices()), jax=jax.__version__,
           xla_flags=os.environ.get("XLA_FLAGS", ""),
           bytes_limit=(d.memory_stats() or {}).get("bytes_limit"))


def _cos_rows(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


def phase_towers(s: Smoke, jax, engine, rng):
    """bf16 towers through the engine vs the fp32 forward at highest
    precision; returns (image embeddings, text embeddings, pixels, prompts)."""
    import jax.numpy as jnp

    from tpuclip.models.loader import load_model
    from tpuclip.models.siglip import get_image_features, get_text_features

    size = engine.config.vision.image_size
    px = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
    prompts = ["a red car", "a dog on a beach", "mountains at sunset",
               "a bowl of fruit", "a city street at night", "a cat asleep",
               "a sailing boat", "a forest path"]
    cfg = engine.config
    # Compile time and memory of the batch-64 image program and the
    # batch-8 text program the engine runs.
    px64 = np.zeros((64, size, size, 3), np.uint8)
    ids, mask = engine._tokenize_bucketed(prompts)
    t = time.time()
    img_prog = get_image_features.lower(
        engine.params, jnp.asarray(px64), cfg, compute_dtype=engine.compute_dtype
    ).compile()
    img_compile = time.time() - t
    t = time.time()
    txt_prog = get_text_features.lower(
        engine.params, jnp.asarray(ids), cfg, compute_dtype=engine.compute_dtype,
        attention_mask=jnp.asarray(mask),
    ).compile()
    txt_compile = time.time() - t
    img_emb = engine.embed_images_uint8(px)
    txt_emb = engine.embed_texts(prompts)
    _, p32 = load_model(MODEL, None, allow_random=True)
    with jax.default_matmul_precision("highest"):
        ref_img = np.asarray(get_image_features(p32, jnp.asarray(px), cfg, compute_dtype=jnp.float32))
        ref_txt = np.asarray(get_text_features(
            p32, jnp.asarray(ids), cfg, compute_dtype=jnp.float32,
            attention_mask=jnp.asarray(mask),
        ))[: len(prompts)]
    del p32
    ci, ct = _cos_rows(img_emb, ref_img), _cos_rows(txt_emb, ref_txt)
    s.emit("towers", bool(ci.min() >= 0.999 and ct.min() >= 0.999),
           compute_dtype=str(jnp.dtype(engine.compute_dtype)),
           image_cos_min=float(ci.min()), text_cos_min=float(ct.min()),
           cos_bound=0.999,
           image_compile_s=round(img_compile, 2), text_compile_s=round(txt_compile, 2),
           image_memory=str(img_prog.memory_analysis()),
           text_memory=str(txt_prog.memory_analysis()))
    return img_emb, txt_emb, px, prompts


def phase_kernel(s: Smoke, jax, rng) -> None:
    """Triton int8 scan vs the XLA scan at 1M x 1152; large bf16 matmul and
    device copy rates for scale."""
    import jax.numpy as jnp

    from tpuclip.ops.topk_int8 import _int8_scores_xla, int8_scores_triton

    n = 1 << 20
    m = jnp.asarray(rng.integers(-127, 128, (n, D), dtype=np.int8))
    scales = jnp.asarray(rng.random(n, dtype=np.float32) * 0.01)
    nv = jnp.asarray(n - 77, jnp.int32)
    tri = jax.jit(int8_scores_triton)
    xla = jax.jit(_int8_scores_xla)
    out, ok = {}, True
    for q_count in (1, 16, 64):
        q = jnp.asarray(rng.integers(-127, 128, (q_count, D), dtype=np.int8))
        equal = bool(jnp.array_equal(tri(q, m, scales, nv), xla(q, m, scales, nv)))
        ok = ok and equal
        out[f"q{q_count}"] = {
            "bit_equal": equal,
            "triton_ms": round(_median_ms(jax, lambda: tri(q, m, scales, nv)), 4),
            "xla_ms": round(_median_ms(jax, lambda: xla(q, m, scales, nv)), 4),
        }
    del m
    a = jnp.ones((8192, 8192), jnp.bfloat16)
    mm = jax.jit(lambda x: x @ x)
    t_mm = _median_ms(jax, lambda: mm(a), reps=20)
    big = jnp.ones((1 << 30,), jnp.float32)
    cp = jax.jit(lambda x: x + 1)
    t_cp = _median_ms(jax, lambda: cp(big), reps=20)
    del big
    s.emit("kernel", ok, rows=n, dim=D, reps=40, **out,
           bf16_matmul_tflops=round(2 * 8192 ** 3 / (t_mm * 1e-3) / 1e12, 1),
           copy_gb_per_s=round(2 * 4 * (1 << 30) / (t_cp * 1e-3) / 1e9, 1))


def _check(results, ref, k, row_tol, score_tol=None) -> Dict:
    """:func:`check_topk` of per-query [(path, score)] results."""
    return check_topk([[_row_of(p) for p, _ in res] for res in results],
                      [[sc for _, sc in res] for res in results],
                      ref, k, row_tol, score_tol)


def _check_bf16(results, ref_bf16, k) -> Dict:
    """A bf16-scoring search against the bf16-operand reference."""
    return _check(results, ref_bf16, k, 2 * SCORE_TOL_SUM, SCORE_TOL_SUM)


def phase_index(s: Smoke, jax, engine, stored, queries) -> Dict:
    """Every search mode over the 1M-row DB vs numpy exact top-20."""
    import jax.numpy as jnp

    from tpuclip.index.search import DeviceIndex
    from tpuclip.ops.hamming import pack_bits_to_words
    from tpuclip.ops.topk_int8 import topk_int8_batch

    store = engine.store
    exact = queries @ stored.T  # (Q, N) f32 reference
    rows_bf16 = round_to_bf16(stored)
    ref_bf16 = bf16_reference(queries, rows_bf16)
    out, ok = {}, True

    idx = engine.index
    t = time.time()
    idx.refresh()
    load_s = time.time() - t
    fused = idx.precision == "int8" and idx._rows_device is not None
    int8_res = idx.search_batch(queries, K)
    c = _check_bf16(int8_res, ref_bf16, K)
    vs_f32 = _check(int8_res, exact, K, 1.0)
    single = idx.search(queries[0], K)
    same_single = [p for p, _ in single] == [p for p, _ in int8_res[0]]
    # Control: the int8 scan alone, without the exact rescore, must fail
    # the same check, or the check cannot tell the two apart.
    cs, cr = topk_int8_batch(jnp.asarray(queries), idx._matrix, idx._scales, K,
                             n_valid=idx._n_valid)
    control = check_topk(np.asarray(cr), np.asarray(cs), ref_bf16, K,
                         2 * SCORE_TOL_SUM, SCORE_TOL_SUM)
    out["int8_rescore"] = {**c, "fused": fused, "single_equals_batch": same_single,
                           "shortfall_vs_f32": vs_f32["shortfall"],
                           "recall_vs_f32": vs_f32["recall"],
                           "control_int8_only": {"ok": control["ok"],
                                                 "score_err": control["score_err"],
                                                 "recall": control["recall"]},
                           "single_ms": round(_median_ms(jax, lambda: idx.search(queries[0], K), 30), 3),
                           "load_s": round(load_s, 1)}
    ok = (ok and c["ok"] and not control["ok"] and fused and same_single
          and idx.can_fuse_text_search(K, None))

    flat = DeviceIndex(store, precision="bf16")
    res = flat.search_batch(queries, K)
    c = _check_bf16(res, ref_bf16, K)
    out["bf16"] = c
    ok = ok and c["ok"]
    del flat

    # Binary: a flat matrix that does not fit serves from the packed sign
    # bits — the reference's binary fallback, integer-exact.
    os.environ["TPUCLIP_INDEX_HBM_GB"] = "0"
    try:
        binary = DeviceIndex(store)
        bits = np.unpackbits(pack_bits_to_words((stored >= 0).astype(np.uint8)).view(np.uint8), axis=1)
        qbits = np.unpackbits(pack_bits_to_words((queries[:4] >= 0).astype(np.uint8)).view(np.uint8), axis=1)
        matches = qbits.astype(np.int32) @ bits.astype(np.int32).T
        del bits
        bres = [binary.search(q, K) for q in queries[:4]]
        good = all(
            tie_aware_topk_ok([_row_of(p) for p, _ in r], matches[i], K, 0)["ok"]
            and all(abs(sc * stored.shape[1] - matches[i][_row_of(p)]) < 1e-3 for p, sc in r)
            for i, r in enumerate(bres)
        )
        out["binary"] = {"ok": good, "served_from_binary": binary._matrix is None}
        ok = ok and good and binary._matrix is None
        del binary, matches
    finally:
        os.environ.pop("TPUCLIP_INDEX_HBM_GB", None)

    os.environ["TPUCLIP_SEARCH_MODE"] = "cascade"
    try:
        os.environ["TPUCLIP_CASCADE_DEPTH"] = str(len(stored))
        casc = DeviceIndex(store)
        res = [casc.search(q, K) for q in queries[:2]]
        c = _check(res, exact, K, SCORE_TOL_F32, SCORE_TOL_F32)
        out["cascade_full_depth"] = {**c, "queries": 2}
        ok = ok and c["ok"] and casc._cascade
        os.environ.pop("TPUCLIP_CASCADE_DEPTH")
        casc = DeviceIndex(store)
        res = casc.search_batch(queries, K)
        # Default depth: the sign-bit shortlist is approximate, so recall
        # is reported; every returned score must still be the row's exact
        # f32 dot.
        c = _check(res, exact, K, 1.0, SCORE_TOL_F32)
        out["cascade_default_depth"] = {"ok": c["ok"], "score_err": c["score_err"],
                                        "recall": c["recall"],
                                        "depth": casc._cascade_depth(K)}
        ok = ok and c["ok"]
        del casc
    finally:
        os.environ.pop("TPUCLIP_SEARCH_MODE", None)
        os.environ.pop("TPUCLIP_CASCADE_DEPTH", None)

    os.environ["TPUCLIP_SEARCH_MODE"] = "ivf"
    try:
        ivf = DeviceIndex(store)
        ivf.refresh()
        k_clusters = int(ivf._ivf.centroids.shape[0])
        ivf._ivf = ivf._ivf._replace(nprobe=k_clusters)
        # One query at a time: probing every bucket gathers the whole
        # bucketed int8 matrix per query.
        res = [ivf.search(q, K) for q in queries[:8]]
        same = all([p for p, _ in a] == [p for p, _ in b] and
                   np.allclose([x for _, x in a], [x for _, x in b], rtol=0, atol=1e-6)
                   for a, b in zip(res, int8_res))
        out["ivf_all_buckets"] = {"ok": same, "buckets": k_clusters, "queries": 8}
        ok = ok and same
        del ivf
    finally:
        os.environ.pop("TPUCLIP_SEARCH_MODE", None)

    folder = "/synthetic/f1"
    res = idx.search_batch(queries, K, filter_folders=[folder])
    in_folder = np.arange(len(stored)) % 2 == 1
    masked = np.where(in_folder[None, :], exact, -np.inf)
    c = _check(res, masked, K, SCORE_TOL_F32, SCORE_TOL_F32)
    good = c["ok"] and all(f"{folder}/" in p for r in res for p, _ in r)
    out["folder_filter"] = {**c, "ok": good}
    ok = ok and good
    s.emit("index", ok, rows=len(stored), queries=len(queries), k=K,
           tol_score_bf16=SCORE_TOL_SUM, tol_f32=SCORE_TOL_F32, **out)
    return {"rows_bf16": rows_bf16}


class _GpuProcessWatch:
    """Polls nvidia-smi's compute-process list while a phase runs."""

    def __init__(self):
        self.max_procs = 0
        self.samples = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.5):
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=10,
                ).stdout
            except (OSError, subprocess.SubprocessError):
                continue
            self.samples += 1
            self.max_procs = max(self.max_procs, len([x for x in out.split() if x.strip()]))

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=15)


def _run_cli(argv: List[str]) -> str:
    """Run the tpuclip CLI in this process; returns what it printed."""
    from tpuclip.cli import main as cli_main

    buf = io.StringIO()
    quiet = os.environ.pop("TPUCLIP_QUIET", None)
    try:
        with contextlib.redirect_stdout(buf):
            try:
                cli_main(argv)
            except SystemExit as e:
                if e.code not in (None, 0):
                    raise RuntimeError(f"CLI {argv[0]} exited {e.code}") from e
    finally:
        if quiet is not None:
            os.environ["TPUCLIP_QUIET"] = quiet
    return buf.getvalue()


def phase_scan(s: Smoke, jax, engine, tmp: str) -> str:
    """scan a seeded JPEG tree through the CLI, then four CLI searches
    checked against DeviceIndex + numpy over the scanned rows."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        s.emit("scan", False, pillow=False)
    sys.path.insert(0, REPO)
    from scripts.synthetic import make_jpeg_tree
    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore
    from tpuclip.pipelines.search import build_query_vector

    root = make_jpeg_tree(os.path.join(tmp, "jpegs"), 512, seed=11, width=640, height=480)
    for dp, _, fns in os.walk(root):
        for fn in fns:
            if fn.endswith(".jpg"):
                with open(os.path.join(dp, fn[:-4] + ".txt"), "w") as f:
                    f.write(f"a photo from {os.path.basename(dp)}")
    db = os.path.join(tmp, "scan.db")
    t = time.time()
    with _GpuProcessWatch() as watch:
        _run_cli(["scan", root, "--db", db, "--model", MODEL,
                  "--inference-batch-size", "64", "--decode-procs", "2"])
    scan_s = time.time() - t
    store = MetadataStore(db, embedding_dim=engine.embedding_dim)
    n_scanned = store.count_images()
    index = DeviceIndex(store)
    index.refresh()
    ids, vecs = index.cache.load(refresh=False)
    paths = store.fetch_paths_for_ids(ids)
    row_of_path = {paths[int(i)]: r for r, i in enumerate(ids)}
    some = sorted(row_of_path)[:3]
    queries = [
        (["a photo of a dog"], dict(query="a photo of a dog")),
        ([some[0], "--image"], dict(query=some[0], is_image_path=True)),
        (["a red car", "--query2", some[1], "--image2"],
         dict(query="a red car", query2=some[1], is_image_path2=True)),
        (["a red car", "--negative", "a blue sky"],
         dict(query="a red car", negative_query="a blue sky")),
    ]
    rows_bf16 = round_to_bf16(vecs)
    ok, checks = n_scanned == 512, []
    for argv, kw in queries:
        text = _run_cli(["search", *argv, "--db", db, "--model", MODEL,
                         "--no-session", "-k", "10",
                         "--show-duplicates", "--output", os.path.join(tmp, "r.html")])
        got = parse_cli_results(text)
        # A plain image query runs the fused tower + scan program, whose
        # embedding may drift from the standalone tower's (SERVE_DRIFT_MAX);
        # the others search build_query_vector's own vector. The CLI prints
        # four decimals.
        fused = kw.get("is_image_path", False)
        qv = build_query_vector(engine, kw.pop("query"), **kw)
        ref = bf16_reference(np.asarray(qv, np.float32)[None], rows_bf16)
        tol = SERVE_DRIFT_MAX if fused else 5e-5 + SCORE_TOL_SUM
        c = check_topk([[row_of_path[p] for p, _ in got]], [[sc for _, sc in got]],
                       ref, 10, 2 * tol, tol)
        checks.append({**c, "fused": fused})
        ok = ok and c["ok"]
    s.emit("scan", ok and watch.max_procs <= 1, pillow=True, images=n_scanned,
           scan_s=round(scan_s, 1), images_per_s=round(512 / scan_s, 1),
           decode_procs=2, gpu_processes_max=watch.max_procs,
           gpu_process_samples=watch.samples, searches=checks)
    return root


def _post(url: str, payload: dict, timeout: float = 600.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serve(s: Smoke, jax, engine, prompts, px, txt_emb, img_emb, ref) -> None:
    """The HTTP server in this process, warmed like ``serve --warm``, under
    concurrent text / image / batch / embed / health requests. Each served
    result is compared with ``DeviceIndex.search_batch`` on the server's own
    /embed embedding of that query: equal row order is counted, and every
    served row and score must agree with that embedding's bf16 reference
    within SERVE_DRIFT_MAX (the fused programs compute their embedding in
    another program than /embed's)."""
    from PIL import Image

    from tpuclip.serve import SearchServer, warm_programs

    compiles = [0]

    def count(event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles[0] += 1

    jax.monitoring.register_event_duration_secs_listener(count)
    engine.index.refresh()
    engine.search_texts(["warmup"], 10)
    warmed = warm_programs(engine, k=K)
    server = SearchServer(engine, port=0)
    server.start_background()
    base = f"http://{server.host}:{server.port}"
    try:
        _post(base + "/search", {"query": prompts[0], "k": K, "show_duplicates": True})
        compiles_before = compiles[0]
        b0 = server.batcher.stats()

        def png(i):
            buf = io.BytesIO()
            Image.fromarray(px[i]).save(buf, format="PNG")
            return base64.b64encode(buf.getvalue()).decode()

        jobs = {}
        for i in range(4):
            jobs[f"text{i}"] = ("/search", {"query": prompts[i], "k": K, "show_duplicates": True})
        for i in range(2):
            jobs[f"image{i}"] = ("/search", {"image_b64": png(i), "k": K, "show_duplicates": True})
        jobs["batch"] = ("/search_batch", {"queries": prompts[4:8], "k": K})
        jobs["embed"] = ("/embed", {"texts": prompts[:2]})
        replies, errors = {}, []

        def call(name, ep, payload):
            try:
                replies[name] = _post(base + ep, payload)
            except Exception as e:  # noqa: BLE001 - recorded as a failure
                errors.append(f"{name}: {e}")

        threads = [threading.Thread(target=call, args=(n, *job)) for n, job in jobs.items()]
        for t in threads:
            t.start()
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        for t in threads:
            t.join(timeout=600)
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        compiles_after = compiles[0]
        # The server's own embeddings of the same queries, for the direct
        # index reference (these /embed shapes may compile once more).
        e_txt = np.concatenate([
            np.asarray(_post(base + "/embed", {"texts": prompts[lo:lo + 4]})["text_embeddings"],
                       np.float32)
            for lo in (0, 4)
        ])
        e_img = np.asarray(_post(base + "/embed", {"images_b64": [png(0), png(1)]})
                           ["image_b64_embeddings"], np.float32)
    finally:
        server.shutdown()
    b1 = stats
    # Served results in the order text0-3, image0-1, batch (prompts 4-7),
    # each with the /embed embedding of its query.
    served = ([replies[f"text{i}"]["results"] for i in range(4)]
              + [replies[f"image{i}"]["results"] for i in range(2)]
              + list(replies["batch"]["results"]))
    emb = np.concatenate([e_txt[:4], e_img, e_txt[4:8]])
    direct = engine.index.search_batch(emb, K)
    ref_bf16 = bf16_reference(emb, ref["rows_bf16"])
    direct_check = _check_bf16(direct, ref_bf16, K)
    per, valid, identical = [], True, 0
    for i, res in enumerate(served):
        paths = [r["path"] for r in res]
        c = check_topk([[_row_of(p) for p in paths]], [[r["similarity"] for r in res]],
                       ref_bf16[i:i + 1], K, 2 * SERVE_DRIFT_MAX, SERVE_DRIFT_MAX)
        same = paths == [p for p, _ in direct[i]]
        gaps = np.diff([sc for _, sc in direct[i]])
        identical += same
        valid = valid and c["ok"]
        per.append({"identical": same, "drift": c["score_err"],
                    "min_adjacent_gap": float(-gaps.max()) if len(gaps) else None})
    txt_cos = float(_cos_rows(e_txt, txt_emb).min())
    img_cos = float(_cos_rows(e_img, img_emb[:2]).min())
    concurrent_cos = float(_cos_rows(
        np.asarray(replies["embed"]["text_embeddings"], np.float32), txt_emb[:2]).min())
    embed_cos = min(txt_cos, img_cos, concurrent_cos)
    passes = b1["device_passes"] - b0["device_passes"]
    ok = (not errors and valid and direct_check["ok"] and health.get("status") == "ok"
          and embed_cos >= 0.9999 and passes > 0
          and compiles_after == compiles_before)
    s.emit("serve", ok, rows=engine.index.num_full, programs_warmed=warmed,
           requests=len(jobs) + 1, errors=errors, results_valid=valid,
           identical_to_direct=f"{identical}/{len(served)}", results=per,
           drift_tol=SERVE_DRIFT_MAX, direct_vs_reference=direct_check,
           embed_cos_min=embed_cos, device_passes=passes,
           windows=b1["windows"] - b0["windows"],
           mixed_windows=b1.get("mixed_windows"),
           compiles_after_warm=compiles_after - compiles_before)


def phase_train(s: Smoke, jax, data_dir: str, tmp: str) -> None:
    """Three trainer steps at SO400M width, batch 32."""
    from tpuclip.pipelines.train import train

    t = time.time()
    losses = train(data_dir, MODEL, None, os.path.join(tmp, "train_out"),
                   steps=3, batch_size=32, log_every=1)
    ok = len(losses) == 3 and bool(np.all(np.isfinite(losses)))
    s.emit("train", ok, steps=len(losses), losses=[float(x) for x in losses],
           seconds=round(time.time() - t, 1))


def run_single(s: Smoke) -> str:
    phase_gpu_tests(s)
    os.environ["JAX_PLATFORMS"] = "cuda"
    import jax

    phase_device(s, jax)
    from tpuclip.engine import ImageDatabase

    tmp = tempfile.mkdtemp(prefix="tpuclip_smoke_")
    os.environ["TPUCLIP_HOME"] = os.path.join(tmp, "home")
    os.environ["TPUCLIP_INIT"] = "random"
    os.environ["TPUCLIP_QUIET"] = "1"
    sys.path.insert(0, REPO)
    from scripts.synthetic import build_synthetic_db, unit_vectors

    rng = np.random.default_rng(0)
    db = os.path.join(tmp, "index.db")
    engine = ImageDatabase(db_path=db, model_name=MODEL, inference_batch_size=64)
    img_emb, txt_emb, px, prompts = phase_towers(s, jax, engine, rng)
    phase_kernel(s, jax, rng)
    dim = engine.embedding_dim
    stored = build_synthetic_db(db, N_ROWS, dim, seed=1, folders=2)
    queries = np.concatenate([unit_vectors(rng, 16, dim), txt_emb, img_emb]).astype(np.float32)
    ref = phase_index(s, jax, engine, stored, queries)
    del stored
    jpegs = phase_scan(s, jax, engine, tmp)
    phase_serve(s, jax, engine, prompts, px, txt_emb, img_emb, ref)
    engine.index = None
    del engine, ref
    phase_train(s, jax, jpegs, tmp)
    d = jax.devices()[0]
    return last_line(d.platform, d.device_kind, len(jax.devices()))


# ---------------------------------------------------------------------------
# Four GPUs
# ---------------------------------------------------------------------------


def _build_db(db: str, n_rows: int, seed: int):
    from scripts.synthetic import build_synthetic_db

    t = time.time()
    stored = build_synthetic_db(db, n_rows, D, seed=seed)
    return stored, time.time() - t


def phase_dp_step(s: Smoke, jax, ndev: int, rng) -> None:
    """One DP train step on all cards vs the same batch on one card.

    SGD at learning rate 1 makes the parameter update the gradient itself,
    so the comparison carries the gradient's size and direction; f32 at
    highest matmul precision leaves summation order as the only difference
    (DP_GRAD_TOL)."""
    import jax.numpy as jnp
    import optax

    from tpuclip.models.configs import get_config
    from tpuclip.models.siglip import init_params
    from tpuclip.parallel.mesh import make_mesh
    from tpuclip.parallel.sharding import shard_params
    from tpuclip.parallel.training import init_train_state, make_train_step

    cfg = get_config(MODEL)
    batch = 8 * ndev
    size = cfg.vision.image_size
    px = jnp.asarray(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8))
    ids = jnp.asarray(rng.integers(1, cfg.text.vocab_size, (batch, cfg.text.max_length)), jnp.int32)
    init = jax.jit(lambda key: init_params(key, cfg))
    p0 = jax.device_get(init(jax.random.PRNGKey(0)))
    grads, losses = {}, {}
    with jax.default_matmul_precision("highest"):
        for label, mesh in (("one", None), ("all", make_mesh())):
            params = init(jax.random.PRNGKey(0))
            if mesh is not None:
                params = shard_params(params, mesh)
            opt = optax.sgd(1.0)
            step = make_train_step(cfg, opt, mesh=mesh, compute_dtype=jnp.float32)
            state, loss = step(init_train_state(params, opt), px, ids)
            p1 = jax.device_get(state.params)
            del state, params
            losses[label] = float(loss)
            grads[label] = jax.tree_util.tree_map(
                lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64), p0, p1)
    sq = lambda t: sum(float(np.sum(np.square(x))) for x in jax.tree_util.tree_leaves(t))
    g_norm = sq(grads["one"]) ** 0.5
    d_norm = sq(jax.tree_util.tree_map(np.subtract, grads["one"], grads["all"])) ** 0.5
    grad_rel = d_norm / max(g_norm, 1e-30)
    loss_rel = abs(losses["one"] - losses["all"]) / max(1.0, abs(losses["one"]))
    s.emit("dp-train-step", bool(grad_rel <= DP_GRAD_TOL and loss_rel <= DP_LOSS_TOL),
           devices=ndev, batch=batch, loss_one=losses["one"], loss_all=losses["all"],
           loss_rel=loss_rel, loss_tol=DP_LOSS_TOL, grad_norm=g_norm,
           grad_rel_diff=grad_rel, grad_tol=DP_GRAD_TOL)


def phase_sharded_index(s: Smoke, jax, ndev: int, db: str, stored, build_s: float,
                        rng) -> None:
    """Sharded DeviceIndex (int8 + device rescore, bf16, mesh cascade) vs
    numpy, with the single-card phase's references and tolerances."""
    from tpuclip.index.search import DeviceIndex
    from tpuclip.index.store import MetadataStore
    from scripts.synthetic import unit_vectors
    from tpuclip.parallel.mesh import make_mesh

    queries = unit_vectors(rng, 16, D)
    exact = queries @ stored.T
    ref_bf16 = bf16_reference(queries, round_to_bf16(stored))
    store = MetadataStore(db, embedding_dim=D)
    mesh = make_mesh()
    out, ok = {"rows": len(stored), "db_build_s": round(build_s, 1)}, True
    for name, precision, mode in (
        ("int8_rescore", "int8", None),
        ("bf16", "bf16", None),
        ("cascade", None, "cascade"),
    ):
        if mode:
            os.environ["TPUCLIP_SEARCH_MODE"] = mode
        try:
            idx = DeviceIndex(store, precision=precision, mesh=mesh)
            t = time.time()
            idx.refresh()
            load_s = time.time() - t
            res = idx.search_batch(queries, K)
            if mode == "cascade":
                # Default depth: the sign-bit shortlist is approximate, so
                # recall is reported; every returned score must still be
                # the row's exact f32 dot.
                c = _check(res, exact, K, 1.0, SCORE_TOL_F32)
                good = idx._cascade and c["ok"]
            else:
                c = _check_bf16(res, ref_bf16, K)
                good = c["ok"]
            out[name] = {**c, "ok": good, "load_s": round(load_s, 1),
                         "sharded": idx.mesh is not None,
                         "device_rescore": idx._rows_device is not None}
            ok = ok and good
            del idx
        finally:
            os.environ.pop("TPUCLIP_SEARCH_MODE", None)
    s.emit("sharded-index", ok, devices=ndev, k=K, tol_score_bf16=SCORE_TOL_SUM,
           tol_f32=SCORE_TOL_F32, **out)


def run_multi(s: Smoke) -> str:
    """One DP train step on all cards vs one, and the sharded DeviceIndex
    over N_ROWS_MULTI rows vs numpy. The seeded DB builds on a host thread
    while the train step compiles and runs."""
    from concurrent.futures import ThreadPoolExecutor

    os.environ["JAX_PLATFORMS"] = "cuda"
    import jax

    phase_device(s, jax)
    ndev = len(jax.devices())
    if ndev < 2:
        s.emit("multi", False, devices=ndev)
    tmp = tempfile.mkdtemp(prefix="tpuclip_smoke_multi_")
    os.environ["TPUCLIP_HOME"] = os.path.join(tmp, "home")
    os.environ["TPUCLIP_QUIET"] = "1"
    sys.path.insert(0, REPO)
    db = os.path.join(tmp, "multi.db")
    rng = np.random.default_rng(3)
    with ThreadPoolExecutor(max_workers=1) as pool:
        built = pool.submit(_build_db, db, N_ROWS_MULTI, 2)
        phase_dp_step(s, jax, ndev, rng)
        stored, build_s = built.result()
    phase_sharded_index(s, jax, ndev, db, stored, build_s, rng)
    return last_line(jax.devices()[0].platform, jax.devices()[0].device_kind, ndev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GPU smoke run of tpuclip's main path.")
    ap.add_argument("--multi", action="store_true",
                    help="four-GPU run: sharded index + DP train step only")
    args = ap.parse_args(argv)
    gpus = query_name_power()  # fails fast where there is no NVIDIA GPU
    s = Smoke(gpus[0])
    print(json.dumps({"gpus": gpus}), flush=True)
    if args.multi:
        line = run_multi(s)
    else:
        line = run_single(s)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

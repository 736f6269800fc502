"""chip_smoke.py's helpers, on the CPU: the exact last line, refusal of a
non-GPU platform, the nvidia-smi line parser, and the tie-aware top-k
comparator the search phases are judged by."""

import json

import numpy as np
import pytest

import chip_smoke
from tpuclip.utils import gpu_info


def test_last_line_is_exactly_the_contract():
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(line)["device"]["count"] == 1


@pytest.mark.parametrize("platform", ["cpu", "rocm", "METAL"])
def test_refuses_non_gpu_platforms(platform):
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(platform)


def test_accepts_the_gpu():
    chip_smoke.require_gpu("gpu")


@pytest.mark.parametrize(
    "line,name,watts",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
        ("NVIDIA H200, 600.00 W", "NVIDIA H200", 600.0),
    ],
)
def test_nvidia_smi_line_parser(line, name, watts):
    assert gpu_info.parse_name_power(line) == (name, watts)


@pytest.mark.parametrize("line", ["", "NVIDIA H100", "NVIDIA H100, [N/A]", ", 700 W"])
def test_nvidia_smi_parser_rejects_other_shapes(line):
    with pytest.raises(ValueError):
        gpu_info.parse_name_power(line)


def test_query_fails_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(gpu_info, "NVIDIA_SMI_QUERY", ["/nonexistent/nvidia-smi"])
    with pytest.raises(RuntimeError):
        gpu_info.query_name_power()


def _scores():
    """Rows 0-9 are the top-10; row 10 trails row 9 by 1e-4 (a planted
    near-tie at the k=10 cut); rows 11-100 are far below."""
    return np.concatenate(
        [np.linspace(1.0, 0.6, 9), [0.5, 0.5 - 1e-4], np.linspace(0.3, 0.0, 90)]
    )


@pytest.mark.parametrize(
    "returned,tol,ok",
    [
        (list(range(10)), 0.0, True),                   # the exact top-10
        (list(range(9)) + [10], 1e-3, True),             # near-tie swap inside tol
        (list(range(9)) + [10], 1e-5, False),            # ... outside tol
        (list(range(9)) + [50], 1e-3, False),            # a real miss
        (list(range(9)) + [8], 1e-3, False),             # duplicate row
        (list(range(9)), 1e-3, False),                   # one short
        (list(range(9)) + [500], 1e-3, False),           # out-of-range row
    ],
    ids=["exact", "tie-in-tol", "tie-out-tol", "miss", "dup", "short", "oob"],
)
def test_tie_aware_topk(returned, tol, ok):
    got = chip_smoke.tie_aware_topk_ok(returned, _scores(), 10, tol)
    assert got["ok"] is ok


def test_parse_cli_results():
    text = "Found 2 results:\n  0.1234: /a/b.jpg\n  -0.0100: /c d/e.jpg\nResults saved"
    assert chip_smoke.parse_cli_results(text) == [("/a/b.jpg", 0.1234), ("/c d/e.jpg", -0.01)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_to_bf16_matches_ml_dtypes(seed):
    """Round-to-nearest-even on the bit pattern equals a real bf16 cast,
    ties and subnormals included."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-8, 8, 4096),
        np.array([0.0, -0.0, 1.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1e-40], np.float32),
    ]).astype(np.float32)
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(chip_smoke.round_to_bf16(x), want)


def _int8_round_trip(x):
    """Symmetric per-row int8 quantization, dequantized (the int8 scan's
    view of the operands)."""
    scale = np.abs(x).max(axis=1, keepdims=True) / 127.0
    return np.clip(np.rint(x / scale), -127, 127) * scale


@pytest.mark.parametrize("mode,ok", [("rescored", True), ("int8-only", False),
                                     ("misrouted", False)])
def test_check_topk_separates_rescore_from_int8_only(mode, ok):
    """At the real width (D = 1152) the bf16-operand check passes a search
    that rescored its shortlist with bf16 operands, and fails the int8 scan
    alone and a result handed to another query."""
    rng = np.random.default_rng(5)
    d, n, k = chip_smoke.D, 4000, 20
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = rng.standard_normal((3, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows_bf16 = chip_smoke.round_to_bf16(rows)
    ref = chip_smoke.bf16_reference(q, rows_bf16)
    if mode == "int8-only":
        scores = (_int8_round_trip(q) @ _int8_round_trip(rows).T).astype(np.float32)
    else:
        # f32 summation in another order than the reference's
        scores = np.einsum("qd,nd->qn", chip_smoke.round_to_bf16(q)[:, ::-1],
                           rows_bf16[:, ::-1]).astype(np.float32)
    top = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    got_scores = np.take_along_axis(scores, top, axis=1)
    if mode == "misrouted":
        top, got_scores = top[::-1], got_scores[::-1]
    got = chip_smoke.check_topk(top, got_scores, ref, k,
                                2 * chip_smoke.SCORE_TOL_SUM, chip_smoke.SCORE_TOL_SUM)
    assert got["ok"] is ok
    if mode == "rescored":
        assert got["score_err"] < chip_smoke.SCORE_TOL_SUM / 10


def test_check_topk_without_score_tolerance_checks_rows_only():
    ref = _scores()[None]
    got = chip_smoke.check_topk([list(range(10))], [[9.0] * 10], ref, 10, 0.0)
    assert got["ok"] and got["score_err"] > 1.0

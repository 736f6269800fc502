"""Regression tests for bench.py's result-emission contract.

The contract: stdout carries ONLY a compact summary line (hard cap well
under a ~2000-char tail window, round-trip-checked), re-printed as results
land, and the full enriched dict goes to bench_full.json on disk.
"""

import importlib.util
import io
import contextlib
import json
import os
import sys

import pytest


@pytest.fixture()
def benchmod(tmp_path, monkeypatch):
    """Import bench.py as a module with its full-record path redirected."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "benchmod_under_test", os.path.join(repo, "bench.py")
    )
    m = importlib.util.module_from_spec(spec)
    sys.modules["benchmod_under_test"] = m
    try:
        spec.loader.exec_module(m)
        m._FULL_RECORD_PATH = str(tmp_path / "bench_full.json")
        yield m
    finally:
        sys.modules.pop("benchmod_under_test", None)


def _capture_emit(m, final=False):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m._emit(final=final)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, "emission must be exactly one stdout line"
    return lines[0]


def test_summary_line_fits_driver_tail_even_when_enriched(benchmod):
    m = benchmod
    # Heavy enrichment: dozens of keys incl. long prose fields.
    m.RESULT.update({f"prose_field_{i}": "x" * 150 for i in range(40)})
    m.RESULT.update(
        {
            "value": 1.62,
            "vs_baseline": 6.17,
            "bf16_scan_p50_ms": 1.824,
            "headline_p99_ms": 2.5,
            "indexing_images_per_sec": 704.8,
            "end_to_end_images_per_sec": 124.4,
            "platform": "gpu",
        }
    )
    line = _capture_emit(m)
    assert len(line) < 1800, "summary line must stay under the driver tail"
    d = json.loads(line)
    # The driver contract quartet must be present and first-class.
    assert d["metric"].startswith("p50")
    assert d["value"] == 1.62
    assert d["unit"] == "ms"
    assert d["vs_baseline"] == 6.17
    assert d["headline_p99_ms"] == 2.5
    # Prose never leaks onto stdout.
    assert "prose_field_0" not in d
    # The full enriched dict lands on disk, referenced from the line.
    assert d["full_record"] == "bench_full.json"
    full = json.load(open(m._FULL_RECORD_PATH))
    assert full["prose_field_0"] == "x" * 150
    assert full["value"] == 1.62


def test_summary_sheds_tail_keys_but_never_the_contract_quartet(benchmod):
    m = benchmod
    # Force pathological growth INSIDE summary keys (e.g. a giant error
    # string) so the shedding loop must engage.
    m.RESULT.update(
        {
            "value": 2.0,
            "vs_baseline": 5.0,
            "error": "E" * 5000,
            "platform": "gpu",
        }
    )
    line = _capture_emit(m)
    d = json.loads(line)
    assert len(line) <= m._SUMMARY_MAX_CHARS + 200
    for k in ("metric", "value", "unit", "vs_baseline"):
        assert k in d


def test_progressive_emission_keeps_last_line_current(benchmod):
    m = benchmod
    m.RESULT["value"] = 3.0
    first = json.loads(_capture_emit(m))
    m.RESULT["value"] = 1.5
    m.RESULT["indexing_images_per_sec"] = 700.0
    second = json.loads(_capture_emit(m))
    assert first["value"] == 3.0
    assert second["value"] == 1.5
    assert second["indexing_images_per_sec"] == 700.0
    # final=True marks done; later calls are no-ops
    _capture_emit(m, final=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m._emit(final=True)
    assert buf.getvalue() == ""


def test_unwritable_full_record_does_not_block_stdout(benchmod, tmp_path):
    m = benchmod
    m._FULL_RECORD_PATH = str(tmp_path / "no_such_dir" / "bench_full.json")
    m.RESULT["value"] = 1.0
    line = _capture_emit(m)
    d = json.loads(line)
    assert d["value"] == 1.0
    assert d["full_record"].startswith("unwritable:")


def test_unwritable_path_still_respects_cap(benchmod, tmp_path):
    # The unwritable branch must go through the same shed/round-trip path.
    m = benchmod
    m._FULL_RECORD_PATH = str(tmp_path / "no_such_dir" / "bench_full.json")
    m.RESULT.update({"value": 1.0, "error": "E" * 5000, "platform": "gpu"})
    line = _capture_emit(m)
    d = json.loads(line)
    assert len(line) <= m._SUMMARY_MAX_CHARS + 200
    assert d["value"] == 1.0


# ---------------------------------------------------------------------------
# Device identity and timing: a bench number always names its device, and a
# run without a GPU fails instead of recording CPU numbers.
# ---------------------------------------------------------------------------


def test_device_record_refuses_the_cpu(benchmod):
    import jax

    with pytest.raises(RuntimeError, match="GPU"):
        benchmod.device_record(jax)


def test_time_ms_warms_then_times_every_call(benchmod):
    import jax

    calls = []

    def fn():
        calls.append(1)
        return jax.numpy.zeros(())

    p50, p99 = benchmod.time_ms(jax, fn, reps=7, warm=3)
    assert len(calls) == 10
    assert 0 <= p50 <= p99

"""bench.py's output contract and its measurement helpers.

A reader that keeps only the last ~2000 chars of bench.py's stdout parses
the last complete JSON line in that window; a line that is too long, or no
line at all, loses the headline number.  These tests pin the invariant:
every result line bench.py can emit fits the tail window with margin, worst
case included.  They also check the device-peak table and the reduction of
a profiler trace to per-iteration metrics on a small synthetic trace.

Reference surface: nuts-rs benches/sample.rs:190-198 (the criterion configs
the grid mirrors).
"""

import io
import json
import sys
import os

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def _full_row(name, with_error=None, skipped=None):
    """A config row with EVERY field run_config can produce, sized at
    wide values."""
    if skipped is not None:
        return {"config": name, "skipped": skipped}
    if with_error is not None:
        return {"config": name, "error": with_error}
    row = {
        "config": name,
        "kernel": "mclmc",
        "num_chains": 1024, "dim": 1000, "num_draws": 400,
        "grad_evals_per_sec": 1610766.3,
        "end_to_end_evals_per_sec": 1250423.7,
        "device_kernel_evals_per_sec": 27904590.7,
        "draws_per_sec": 265423.3, "ess_per_sec": 1232574.5,
        "tune_seconds": 140.73, "sample_seconds": 163.77,
        "sample_seconds_all_attempts": [265.24, 163.77],
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "flops_per_eval": 404400.0,
        "device_tflops": 32.1234, "fp32_peak_share": 0.4931,
        "fp32_peak_tflops": 67.0,
        "native_anchor_evals_per_sec_1core": 2959118.6,
        "vs_native_anchor": 51.626, "anchor_source": "measured",
        "posterior_mean_abs_error": 0.0004,
        "d2h_bandwidth_mbps": 17.3,
        "kernel_rate_error": "E" * 400,
    }
    return row


def _worst_grid():
    """Worst realistic grid: headline + 6 side configs, every row maximal,
    long errors everywhere."""
    return [
        _full_row("normal_d10_thin_quick"),
        _full_row("normal_d10"),
        _full_row("mclmc_d10"),
        _full_row("logreg_d100"),
        _full_row("logreg_big",
                  with_error="XlaRuntimeError: " + "RESOURCE_EXHAUSTED " * 40),
        _full_row("normal_d1000"),
        _full_row("extra_config", skipped="budget"),
    ]


def test_final_line_fits_tail_window_worst_case(capsys):
    grid = _worst_grid()
    head = grid[0]
    bench._emit_result(bench._result(1250423.7, head, grid))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line) < bench._MAX_LINE, len(line)
    # And the window margin: a 2000-char tail must contain the WHOLE line.
    assert bench._MAX_LINE <= 2000 - 400  # 400 chars of margin for newline drift
    # The headline value is present and parseable from the line itself.
    parsed = json.loads(line)
    assert parsed["value"] == head["device_kernel_evals_per_sec"]
    assert parsed["unit"] == "grad_evals/s"
    assert "vs_baseline" in parsed
    # The worst REALISTIC grid must fit without the shrink path: every
    # config keeps its kernel + rates in the artifact line.
    assert "truncated" not in parsed["detail"]
    assert all("kernel" in c or "skipped" in c or "error" in c
               for c in parsed["detail"]["configs"])


def test_compact_config_caps_error_strings():
    row = bench._compact_config({"config": "x", "error": "E" * 1000})
    assert len(row["error"]) <= 80
    row = bench._compact_config(_full_row("y"))
    assert row["kernel"] == "mclmc" and row["fp32_share"] == 0.4931
    # NaN/inf rates are dropped rather than serialized as non-JSON tokens.
    row = bench._compact_config(
        {"config": "z", "kernel": "sync",
         "device_kernel_evals_per_sec": float("nan"),
         "end_to_end_evals_per_sec": float("inf")})
    assert "device" not in row and "e2e" not in row


def test_emit_result_never_prints_overlong_line(monkeypatch, capsys):
    # Pathological: 50 config rows. _emit_result must shrink, not overflow.
    grid = [_full_row(f"cfg_{i:02d}") for i in range(50)]
    result = bench._result(1.0, grid[0], grid)
    bench._emit_result(result)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(out) < bench._MAX_LINE
    parsed = json.loads(out)  # complete, parseable
    assert "value" in parsed


def test_simulated_driver_tail_parses():
    """Simulate a tail reader: capture stdout, take the last 2000
    characters, parse the last complete line."""
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        # A realistic emission sequence: boot line, provisional, final.
        bench._emit({"metric": "gradient_evals_per_sec_per_chip",
                     "value": 0.0, "unit": "grad_evals/s",
                     "vs_baseline": 0.0, "detail": {"provisional": "boot"}})
        grid = _worst_grid()
        bench._emit_result(bench._result(2.0, grid[0], grid[:1],
                                         provisional=True))
        bench._emit_result(bench._result(2.0, grid[0], grid))
    finally:
        sys.stdout = old
    tail = buf.getvalue()[-2000:]
    lines = [ln for ln in tail.splitlines() if ln.strip()]
    # Last complete line: the final one ends with \n so it's complete.
    last = lines[-1]
    parsed = json.loads(last)
    assert parsed["value"] == grid[0]["device_kernel_evals_per_sec"]
    assert parsed["detail"]["headline_config"] == "normal_d10_thin_quick"
    # Every grid config is represented in the artifact line.
    names = {c["config"] for c in parsed["detail"]["configs"]}
    assert names == {c["config"] for c in grid}


def test_watchdog_reprints_last_line_when_main_wedged():
    # A main thread stuck in an uninterruptible C call never runs the
    # SIGALRM handler; the watchdog THREAD re-prints the last emitted line
    # at budget + grace and exits 0 so stdout ends with a complete
    # parseable line.
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import os, sys, time
        os.environ["BENCH_BUDGET_S"] = "2"
        os.environ["JAX_PLATFORMS"] = "cpu"
        sys.path.insert(0, %r)
        import jax; jax.config.update("jax_platforms", "cpu")
        import bench
        bench._emit_result({"metric": "gradient_evals_per_sec_per_chip",
                            "value": 123.0, "unit": "grad_evals/s",
                            "vs_baseline": 1.0, "detail": {"configs": []}})
        bench._start_watchdog(grace=1.0)
        time.sleep(60)
    """) % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=45)
    assert out.returncode == 0, (out.returncode, out.stderr[-500:])
    lines = [l for l in out.stdout.strip().splitlines() if l.strip()]
    assert json.loads(lines[-1])["value"] == 123.0


@pytest.mark.parametrize("kind,fp32", [
    ("NVIDIA H100 80GB HBM3", 67.0),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_device_peaks_known_or_error(kind, fp32):
    if fp32 is None:
        with pytest.raises(ValueError, match="no published peaks"):
            bench._device_peaks(kind)
    else:
        assert bench._device_peaks(kind)["fp32_tflops"] == fp32


def test_reduce_device_trace_synthetic(tmp_path):
    """Two overlapping events and one after a 2 us gap on a GPU stream line
    (plus an XLA Ops line that must not count): busy 4 us of a 6 us span,
    over 2 while-loop iterations."""
    from jax.profiler import ProfileData

    txt = """
    planes {
      name: "/device:GPU:0"
      lines {
        name: "Stream #13(Compute)"
        timestamp_ns: 1000
        events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 }
        events { metadata_id: 2 offset_ps: 1000000 duration_ps: 2000000 }
        events { metadata_id: 1 offset_ps: 5000000 duration_ps: 1000000 }
      }
      lines {
        name: "XLA Ops"
        timestamp_ns: 1000
        events { metadata_id: 1 offset_ps: 0 duration_ps: 9000000 }
      }
      event_metadata { key: 1 value { id: 1 name: "loop_fusion" } }
      event_metadata { key: 2 value { id: 2 name: "MEMCPYDtoH" } }
    }
    """
    path = tmp_path / "t.xplane.pb"
    path.write_bytes(ProfileData.text_proto_to_serialized_xspace(txt))
    out = bench.reduce_device_trace(str(path), iterations=2, wall_ns=8000)
    assert out["device_events"] == 3
    assert out["device_busy_s"] == pytest.approx(4e-6)
    assert out["device_span_s"] == pytest.approx(6e-6)
    assert out["device_span_idle_share"] == pytest.approx(1 / 3)
    assert out["wall_idle_share"] == pytest.approx(0.5)
    assert out["device_us_per_iteration"] == pytest.approx(2.0)
    assert out["gap_us_per_iteration"] == pytest.approx(1.0)
    assert out["memcpy_events_per_iteration"] == pytest.approx(0.5)

"""Benchmark: gradient-evals/sec/chip and ESS/sec for batched NUTS sampling.

Prints one flushed JSON line per milestone; the LAST line is the result.
The headline line lands as soon as the headline config completes, then a
final enriched line replaces it when/if the whole grid finishes.  A
wall-clock budget (env BENCH_BUDGET_S, default 1200 s) skips remaining side
configs as {"config": ..., "skipped": "budget"} instead of overrunning.

Runs on a GPU only: `python bench.py` refuses any other device.  Every row
names the engine it timed and the device it ran on.

Configs mirror the reference's criterion harness plus BASELINE.json:
  normal_d10_thin — sample_1000_10 (reference benches/sample.rs:190-193)
                  scaled to many vmapped chains, with the device->host
                  payload knobs on (stats thinned on device + f16 draws).
  normal_d10    — same config with full stats.
  mclmc_d10     — the same target on MCLMC.
  normal_d1000  — sample_1000_1000 (benches/sample.rs:195-198), large-d axis
  logreg_d100   — 100-d logistic regression (n=1000)
  logreg_big    — 100-d logistic regression (n=131072), matmul-bound

The headline `value` is the DEVICE-level kernel rate (one dispatch,
block_until_ready, no host streaming); the end-to-end rate ships in
`detail`.

`python bench.py --trace DIR` instead profiles one steady posterior chunk
of normal_d10 (1024 chains, sync kernel) and reduces the trace to device
time per while-loop iteration, the gap between iterations and the device
idle share.

vs_baseline: the reference publishes no numbers and no Rust toolchain exists
here, so each config's baseline is the native C++ single-core NUTS anchor
(nuts_rs_tpu/native/nuts_anchor.cpp — same algorithm, optimized, -O3
-march=native) built and timed on THIS machine at bench time (after the
headline line is already safe; the early line uses the recorded fallback
measurement).  vs_baseline = device_throughput / single_core_native_throughput;
multiply the denominator by the core count a reference deployment would use
(one core per chain, e.g. 6) for a fleet-level comparison.
"""

import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

_ANSI = re.compile(r"\x1b\[[0-9;]*m")

# Wall-clock budget: all skipping decisions key off this.
_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1200"))
_T0 = time.monotonic()


def _left():
    return _BUDGET_S - (time.monotonic() - _T0)


def _emit(result):
    """One flushed JSON line NOW — survives a later kill."""
    print(json.dumps(result), flush=True)


# A reader that keeps only the last ~2000 characters of stdout must still
# find the last complete line.  Every RESULT line must therefore fit that
# window with room to spare; full per-config
# detail goes to BENCH_DETAIL.json on disk plus per-config stdout lines that
# are themselves compact.
_MAX_LINE = 1500
_DETAIL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "BENCH_DETAIL.json")


def _emit_result(result):
    """Emit a result line that is GUARANTEED to fit the tail window.

    Asserts the invariant (tested in tests/test_bench_line.py) and, as a
    last-resort belt-and-braces path, shrinks the config list to bare
    name+device pairs rather than ever printing an overlong line."""
    compact = dict(separators=(",", ":"))
    line = json.dumps(result, **compact)
    if len(line) >= _MAX_LINE:
        detail = result.get("detail", {})
        detail["configs"] = [
            {"config": c.get("config"),
             "device": c.get("device", c.get("skipped", c.get("error", "?")))}
            for c in detail.get("configs", [])]
        detail["truncated"] = True
        line = json.dumps(result, **compact)
    if len(line) >= _MAX_LINE:  # still over: keep headline, drop the grid
        result.get("detail", {})["configs"] = "see BENCH_DETAIL.json"
        line = json.dumps(result, **compact)
    assert len(line) < _MAX_LINE, len(line)
    global _LAST_LINE
    _LAST_LINE = line
    print(line, flush=True)


def _compact_config(cfg, cap=80):
    """Compact one config row for result lines: headline numbers only, error
    strings hard-capped at `cap` chars.  The full row ships in
    BENCH_DETAIL.json (written after every config) instead."""
    out = {"config": cfg.get("config")}
    if "skipped" in cfg:
        out["skipped"] = str(cfg["skipped"])[:cap]
        return out
    if "error" in cfg:
        out["error"] = str(cfg["error"])[:cap]
        return out
    if cfg.get("kernel"):
        out["kernel"] = cfg["kernel"]
    for src, dst in (("device_kernel_evals_per_sec", "device"),
                     ("end_to_end_evals_per_sec", "e2e"),
                     ("fp32_peak_share", "fp32_share"),
                     ("vs_native_anchor", "vs_anchor")):
        v = cfg.get(src)
        if isinstance(v, (int, float)) and np.isfinite(v):
            out[dst] = v
    return out


def _write_detail(payload):
    """Full (unabridged) bench detail to disk; the stdout lines carry only
    the compact summary."""
    try:
        with open(_DETAIL_PATH, "w") as f:
            json.dump(payload, f, indent=1)
    except Exception:
        pass


_LAST_LINE = None
_WATCHDOG_CANCEL = threading.Event()


def _start_watchdog(grace=90.0):
    """Hard line-of-last-resort for wedged main threads.

    SIGALRM only interrupts the main thread BETWEEN bytecodes; a main
    thread stuck inside an uninterruptible C call never runs the Python
    signal handler, so the per-config caps never fire.  A daemon THREAD is
    not blocked by that: at budget + grace it re-prints the last emitted
    result line (every _emit_result stores it) and _exit(0)s, so stdout
    always ends with a complete, parseable line."""
    def _run():
        while not _WATCHDOG_CANCEL.is_set():
            left = (_T0 + _BUDGET_S + grace) - time.monotonic()
            if left <= 0:
                break
            _WATCHDOG_CANCEL.wait(min(left, 5.0))
        if _WATCHDOG_CANCEL.is_set():
            return
        if _LAST_LINE is not None:
            print(_LAST_LINE, flush=True)
        sys.stdout.flush()
        os._exit(0)

    t = threading.Thread(target=_run, daemon=True, name="bench-watchdog")
    t.start()
    return t


class _ConfigTimeout(BaseException):
    # BaseException on purpose: the alarm fires inside run_next_chunk,
    # where the sampler's auto-recovery path catches `Exception` — a
    # wall-clock cap is not a device fault, and must not trigger a runner
    # rebuild + retry that blows past the cap.  Caught explicitly at the
    # three _deadline call sites.
    pass


@contextlib.contextmanager
def _deadline(seconds):
    """Hard per-config wall-clock cap via SIGALRM: a pre-launch budget gate
    alone lets a slow config overrun the budget.  The alarm interrupts
    block_until_ready on the main thread; the failed config is recorded as an
    error row and the grid moves on."""
    if seconds <= 0:
        raise _ConfigTimeout("no budget left")

    def _handler(signum, frame):
        raise _ConfigTimeout(f"config exceeded its {seconds:.0f}s share "
                             "of the wall-clock budget")

    old = signal.signal(signal.SIGALRM, _handler)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


def _short_err(e, cap=400):
    """One short, JSON-safe line for an exception: prefer the salient XLA
    message over multi-kilobyte device-log reprs (a full repr makes the
    single JSON line unparseable)."""
    s = _ANSI.sub("", str(e))
    for pat in ("RESOURCE_EXHAUSTED", "INVALID_ARGUMENT", "INTERNAL"):
        i = s.find(pat)
        if i >= 0:
            line = s[i:].splitlines()[0]
            return f"{type(e).__name__}: {line}"[:cap]
    first = s.splitlines()[0] if s else ""
    return f"{type(e).__name__}: {first}"[:cap]

_HERE = os.path.dirname(os.path.abspath(__file__))
_ANCHOR_SRC = os.path.join(_HERE, "nuts_rs_tpu", "native", "nuts_anchor.cpp")
# Build outputs stay inside the checkout (listed in .gitignore).
_BUILD_DIR = os.path.join(_HERE, ".build")
_ANCHOR_BIN = os.path.join(_BUILD_DIR, "nuts_anchor")

# Fallbacks when g++ is unavailable or the budget is too tight to run the
# anchor (values measured on the dev container's CPU, 2026-08; keys are
# (dim, maxdepth, logreg_n)).
_ANCHOR_FALLBACK = {
    (10, 10, 0): 2.57e6,
    (1000, 10, 0): 4.6e4,
    (100, 10, 1000): 4.7e3,
    # n=1000 measurement scaled by data size (the dense mat-vec dominates);
    # also covers an anchor-run timeout at this n.
    (100, 10, 131072): 36.0,
}

# Published peaks per device_kind, for roofline shares.  The energy-critical
# matmuls run at Precision.HIGHEST (Model.logp_and_grad), which on these
# cards is FP32 outside the tensor cores, so the matmul-bound GLM configs
# are measured against the FP32 rate; elementwise-bound configs report
# FLOP/s only.  Source: NVIDIA H100 SXM data sheet (dense, 700 W limit).
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_tflops": 67.0, "hbm_tb_per_s": 3.35},
}


def _device_peaks(kind):
    """Peaks of ``kind``; an unknown device is an error, not a default."""
    try:
        return _DEVICE_PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device {kind!r}; add it "
                         "to bench._DEVICE_PEAKS with its source") from None


def _flops_per_eval(name, dim, logreg_n=0):
    """Approximate FLOPs per gradient evaluation per chain (for the
    detail.tflops / detail.mfu report; reference harness has no analog).
    logreg: logits = X q and grad = X^T r are 2*n*d MACs each -> 4*n*d
    FLOPs (2 FLOPs/MAC) + O(n + d) elementwise.  iid-normal: the grad is
    elementwise (~2d) and the leapfrog adds ~4d axpy FLOPs."""
    if logreg_n:
        return 4.0 * logreg_n * dim + 4.0 * (logreg_n + dim)
    return 6.0 * dim


def _d2h_bandwidth_mbps():
    """Measured device->host link bandwidth (one ~16 MB transfer), so the
    end-to-end numbers are interpretable across hosts."""
    try:
        x = jnp.ones((4 * 1024 * 1024,), jnp.float32) + 1.0  # avoid constants
        jax.block_until_ready(x)
        t0 = time.monotonic()
        np.asarray(x)
        dt = time.monotonic() - t0
        return round(16.0 / max(dt, 1e-9), 1)
    except Exception:
        return None


_ANCHOR_LAST_SOURCE = "fallback"
# Anchor measurements persist across bench runs (same machine, same binary):
# re-measuring a steady-state single-core rate every run costs minutes (the
# d=1000 anchor alone can eat its full 300 s cap).
_ANCHOR_RATES_PATH = os.path.join(_BUILD_DIR, "anchor_rates.json")


def _anchor_rates_load():
    try:
        with open(_ANCHOR_RATES_PATH) as f:
            return {tuple(json.loads(k)): v for k, v in json.load(f).items()}
    except Exception:
        return {}


def _anchor_rates_store(rates):
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(_ANCHOR_RATES_PATH, "w") as f:
            json.dump({json.dumps(list(k)): v for k, v in rates.items()}, f)
    except Exception:
        pass


def native_anchor_rate(dim, num_tune, num_draws, maxdepth, logreg_n=0):
    """Build (once, cached across runs by mtime) and run the native C++
    single-core anchor; returns grad-evals/s, or the recorded fallback if
    the toolchain is missing or the budget is too tight.  Measurements
    persist to disk (the rate is steady-state; once per machine is enough).
    Sets _ANCHOR_LAST_SOURCE to "measured"/"fallback" for the report."""
    global _ANCHOR_LAST_SOURCE
    _ANCHOR_LAST_SOURCE = "fallback"
    key = (dim, maxdepth, logreg_n)
    stored = _anchor_rates_load()
    if key in stored:
        _ANCHOR_LAST_SOURCE = "measured"
        return stored[key]
    if _left() < 90:  # the headline line is already out; don't overrun
        return _ANCHOR_FALLBACK.get(key, float("nan"))
    try:
        if (not os.path.exists(_ANCHOR_BIN)
                or os.path.getmtime(_ANCHOR_BIN) < os.path.getmtime(_ANCHOR_SRC)):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", _ANCHOR_SRC,
                 "-o", _ANCHOR_BIN], check=True, capture_output=True,
                timeout=min(120, max(30, _left() / 4)))
        out = subprocess.run(
            [_ANCHOR_BIN, str(dim), str(num_tune), str(num_draws),
             str(maxdepth), "42", str(logreg_n)],
            check=True, capture_output=True,
            timeout=min(150, max(60, _left() / 3)))
        rate = float(json.loads(out.stdout)["grad_evals_per_sec"])
        _ANCHOR_LAST_SOURCE = "measured"
        stored[key] = rate
        _anchor_rates_store(stored)
        return rate
    except Exception:
        return _ANCHOR_FALLBACK.get(key, float("nan"))


def _make_model(name):
    from nuts_rs_tpu.models import gaussian

    if name == "normal_d10":
        return gaussian.normal_logp(10, mu=3.0), 3.0
    if name == "normal_d1000":
        return gaussian.normal_logp(1000, mu=3.0), 3.0
    if name == "logreg_d100":
        return gaussian.logistic_regression(n_data=1000, dim=100, seed=0), None
    if name == "logreg_big":
        # 131072x100 design matrix (52 MB): larger than the card's 50 MB
        # L2, so every gradient streams it from device memory.
        return gaussian.logistic_regression(
            n_data=131072, dim=100, seed=0), None
    if name == "mclmc_d10":
        return gaussian.normal_logp(10, mu=3.0), 3.0
    raise ValueError(name)


def run_config(name, num_chains=1024, num_tune=300, num_draws=700,
               maxdepth=10, attempts=2, kernel=None, sampler_kw=None,
               with_anchor=True):
    import nuts_rs_tpu as nt

    base_name = name.removesuffix("_thin")
    model, true_mean = _make_model(base_name)
    logreg_n = (1000 if base_name == "logreg_d100"
                else 131072 if base_name == "logreg_big" else 0)
    if name == "mclmc_d10":
        # Unadjusted microcanonical sampler (the reference's experimental
        # MCLMC) on the XLA scan engine.
        kernel = "mclmc"
        settings = nt.DiagMclmcSettings(
            num_tune=num_tune, num_draws=num_draws, num_chains=num_chains,
            seed=0)
    else:
        kernel = kernel or "sync"
        settings = nt.DiagNutsSettings(
            num_tune=num_tune, num_draws=num_draws, num_chains=num_chains,
            maxdepth=maxdepth, seed=0, posterior_kernel=kernel)

    # Take the best of `attempts` full passes, criterion-style — dropped to
    # one pass when over half the wall budget is spent.
    if time.monotonic() - _T0 > _BUDGET_S / 2:
        attempts = 1
    t_tune = None
    t_samples = []
    trace = None
    for _ in range(max(1, attempts)):
        # One chunk per phase: a chunk is ONE host dispatch, so large chunks
        # amortize dispatch and let the pipelined transfers overlap.
        sampler = nt.Sampler(model, settings, dtype=jnp.float32,
                             chunk_size=max(num_tune, num_draws),
                             **(sampler_kw or {}))
        t0 = time.monotonic()
        # Run until the tuning draws are exhausted so t_tune/t_sample split
        # at the real phase boundary.
        while sampler._next_draw < settings.num_tune:
            sampler.run_next_chunk()
        t_tune = time.monotonic() - t0 if t_tune is None else min(
            t_tune, time.monotonic() - t0)

        t0 = time.monotonic()
        while not sampler.finished:
            sampler.run_next_chunk()
        t_samples.append(time.monotonic() - t0)
        trace = sampler.trace.finalize()
    t_sample = min(t_samples)
    draws = trace.posterior["position"]  # [C, K, d]
    if draws.dtype == np.float16:  # f16 numpy reductions accumulate in f16
        draws = draws.astype(np.float32)
    n_steps = trace.sample_stats["n_steps"].astype(np.int64)
    grad_evals = int(n_steps.sum())
    grad_evals_per_sec = grad_evals / t_sample
    # End-to-end rate includes warmup work and warmup wall-clock.  With
    # store_warmup=False (the thin configs) the warmup stats are never
    # stored, so the warmup leapfrog count comes from the host accounting
    # planes instead (ChainProgress.total_num_steps covers both phases).
    warm_steps = trace.warmup_sample_stats.get("n_steps")
    if warm_steps is not None and warm_steps.size:
        tune_evals = int(warm_steps.astype(np.int64).sum())
    else:
        total_steps = sum(p.total_num_steps for p in sampler.progress)
        tune_evals = max(0, int(total_steps) - grad_evals)
    e2e_evals_per_sec = (grad_evals + tune_evals) / (t_sample + t_tune)

    # Bulk ESS (rank-normalized Geyer estimator) on the first coordinate.
    from nuts_rs_tpu.diagnostics import ess_bulk

    ess_total = float(ess_bulk(draws[..., 0]))
    ess_per_sec = ess_total / t_sample

    # Device-level kernel rate: re-launch the final posterior chunk with the
    # adapted state and only block_until_ready — no device->host streaming.
    # Measured so both the kernel and the end-to-end rate are on record.
    kernel_rate = float("nan")
    kernel_rate_error = None
    try:
        from nuts_rs_tpu.sampler import _schedule_chunk

        lo = settings.num_tune
        # Up to a 700-draw probe, so the fixed dispatch cost of a runner
        # call is amortized.
        hi = min(lo + min(700, num_draws), num_tune + num_draws)
        runner = jax.jit(next(
            r for s_, e_, r in sampler._phase_runners if s_ <= lo < e_))
        # extra_flags adds runner-specific per-draw flags (e.g. MCLMC's
        # 'resample'); raw schedule rows alone KeyError in those runners.
        kflags = settings.extra_flags(
            _schedule_chunk(sampler.schedule, lo, hi), lo, hi)
        kstate, kstats = runner(sampler.state, kflags)   # compile + warm
        jax.block_until_ready(kstats)
        # Chain the warm call's OUTPUT state into the timed call, so the
        # timed request is never identical to a finished one.
        t0 = time.monotonic()
        _, kstats = runner(kstate, kflags)
        jax.block_until_ready(kstats)
        dt = time.monotonic() - t0
        kernel_rate = float(np.asarray(kstats["n_steps"]).sum()) / dt
    except Exception as e:
        kernel_rate_error = _short_err(e)

    detail = {
        "config": name,
        "kernel": kernel,
        "num_chains": num_chains,
        "dim": model.dim,
        "num_draws": num_draws,
        "grad_evals_per_sec": round(grad_evals_per_sec, 1),
        "end_to_end_evals_per_sec": round(e2e_evals_per_sec, 1),
        "device_kernel_evals_per_sec": round(kernel_rate, 1),
        "draws_per_sec": round(num_draws * num_chains / t_sample, 1),
        "ess_per_sec": round(ess_per_sec, 1),
        "tune_seconds": round(t_tune, 2),
        "sample_seconds": round(t_sample, 2),
        "sample_seconds_all_attempts": [round(t, 2) for t in t_samples],
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    # FLOPs accounting: device-level TFLOP/s and — for the matmul-bound GLM
    # configs — the share of the card's published FP32 peak.
    fpe = _flops_per_eval(base_name, model.dim, logreg_n)
    detail["flops_per_eval"] = round(fpe, 1)
    if np.isfinite(kernel_rate):
        dev_tflops = kernel_rate * fpe / 1e12
        detail["device_tflops"] = round(dev_tflops, 4)
        if logreg_n:
            peak = _device_peaks(detail["device_kind"])["fp32_tflops"]
            detail["fp32_peak_share"] = round(dev_tflops / peak, 4)
            detail["fp32_peak_tflops"] = peak
    if with_anchor:
        if base_name == "logreg_big":
            # Anchor at n=131072 single-core: dominated by the dense
            # 131072x100 mat-vec per eval — a handful of draws measures the
            # steady rate.
            anchor = native_anchor_rate(model.dim, 3, 3, maxdepth,
                                        logreg_n=131072)
        elif model.dim >= 500 or logreg_n >= 1000:
            # Expensive single-core regimes: the rate is steady once
            # adaptation settles; 150+150 draws measures it without eating
            # the budget (a 1000+1000 d=1000 anchor runs past its 300 s
            # cap).
            anchor = native_anchor_rate(model.dim, 150, 150, maxdepth,
                                        logreg_n=logreg_n)
        else:
            anchor = native_anchor_rate(model.dim, 1000, 1000, maxdepth,
                                        logreg_n=logreg_n)
        detail["native_anchor_evals_per_sec_1core"] = round(anchor, 1)
        detail["vs_native_anchor"] = round(grad_evals_per_sec / anchor, 3)
        detail["anchor_source"] = _ANCHOR_LAST_SOURCE
    if kernel_rate_error is not None:
        detail["kernel_rate_error"] = kernel_rate_error
    if true_mean is not None:
        detail["posterior_mean_abs_error"] = round(
            abs(float(draws.mean()) - true_mean), 4)
    return grad_evals_per_sec, detail


def _micro_result(rows, partial=False):
    out = {"metric": "microbench", "value": len(rows), "unit": "kernels",
           "vs_baseline": 1.0,
           "detail": {"micro": rows,
                      "platform": jax.devices()[0].platform}}
    if partial:
        out["detail"]["skipped"] = "budget"
    return out


def run_micro():
    """Kernel-level microbenchmarks (reference: benches/sample.rs:126-188
    times multiply/axpy/scalar_prods at d in {4,16,17,100,4567}).  Each
    kernel is repeated inside one dispatch (lax.fori_loop with a carried
    data dependency) at TWO loop lengths; per-call COMPUTE is the slope
    (t_long - t_short) / (REPS_LONG - REPS_SHORT), which cancels the fixed
    dispatch overhead entirely.  Per-dispatch latency is reported
    alongside."""
    from jax import lax

    C, REPS_S, REPS_L = 1024, 256, 16384
    rows = []
    for d in (4, 16, 100, 1000, 4567):
        if _left() < 60:
            _emit(_micro_result(rows, partial=True))
            return _micro_result(rows, partial=True)
        key = jax.random.key(0)
        ks = jax.random.split(key, 6)
        p, pg, m, mg, v, stds = (jax.random.normal(k, (C, d), jnp.float32)
                                 for k in ks)
        step = jnp.full((C, 1), 0.1, jnp.float32)
        U = jax.random.normal(ks[0], (d, min(8, d)), jnp.float32) * 0.1

        # Each body maps a carry tuple -> same-shaped carry tuple with a
        # real data dependency so XLA cannot hoist or dead-code the loop.
        def leapfrog_body(_, c):
            q, g, vv = c
            v1 = vv + (step / 2.0) * g
            q1 = q + step * v1
            g1 = -q1  # iid-normal gradient: pure elementwise cost
            v2 = v1 + (step / 2.0) * g1
            return (q1, g1, v2)

        def uturn_body(_, c):
            # the 3 scalar products of the U-turn criterion (reference
            # benches/sample.rs scalar_prods3), batched over chains; results
            # feed back at epsilon scale to keep the dependency chain.
            a, b, cc, dd = c
            s1 = jnp.sum((a + b) * cc, axis=-1)
            s2 = jnp.sum((a + b) * dd, axis=-1)
            s3 = jnp.sum(cc * dd, axis=-1)
            return (a + 1e-30 * s1[:, None], b + 1e-30 * s2[:, None],
                    cc + 1e-30 * s3[:, None], dd)

        def lowrank_body(_, c):
            # low-rank affine F(x) = x + U(U^T x) — the matmul-bound op; the
            # 0.1-scaled U keeps the iterated map's spectral radius ~1.
            (x,) = c
            return (x + (x @ U) @ U.T,)

        for name, body, args in (
                ("leapfrog", leapfrog_body, (p, pg, v)),
                ("uturn_scalar_prods3", uturn_body, (p, pg, m, mg)),
                ("lowrank_apply", lowrank_body, (p,))):
            try:
                fn_s = jax.jit(lambda a, body=body:
                               lax.fori_loop(0, REPS_S, body, a))
                fn_l = jax.jit(lambda a, body=body:
                               lax.fori_loop(0, REPS_L, body, a))
                out = fn_s(args)
                jax.block_until_ready(out)
                out_l = fn_l(args)
                jax.block_until_ready(out_l)

                def timed(fn, a):
                    # Chain the output back in (see run_config); best of 3
                    # per length.
                    best = float("inf")
                    for _ in range(3):
                        t0 = time.monotonic()
                        a = fn(a)
                        jax.block_until_ready(a)
                        best = min(best, time.monotonic() - t0)
                    return best, a

                dt_s, out = timed(fn_s, out)
                dt_l, out_l = timed(fn_l, out_l)
                usec_compute = (dt_l - dt_s) / (REPS_L - REPS_S) * 1e6
                rows.append({
                    "kernel": name, "dim": d, "chains": C,
                    "reps": [REPS_S, REPS_L],
                    "usec_per_call_compute": round(usec_compute, 3),
                    "usec_per_dispatch": round(dt_s * 1e6, 2),
                    "chain_calls_per_sec": round(
                        C / max(usec_compute / 1e6, 1e-12), 1),
                })
            except Exception as e:
                rows.append({"kernel": name, "dim": d,
                             "error": _short_err(e)})
    return _micro_result(rows)


def _result(head_rate, head, grid, provisional=False):
    # The headline VALUE is the device-level kernel rate; the end-to-end
    # rate (and the measured link bandwidth) stays in detail.  Falls back
    # to the end-to-end rate when the kernel-rate probe failed.
    #
    # The returned dict is COMPACT by construction — per-config rows go
    # through _compact_config, full rows go to BENCH_DETAIL.json via
    # _write_detail at the call sites — so the line fits a 2000-char stdout
    # tail window (asserted in _emit_result).
    dev = head.get("device_kernel_evals_per_sec")
    value = dev if dev is not None and np.isfinite(dev) else head_rate
    anchor = head.get("native_anchor_evals_per_sec_1core")
    vs = (round(value / anchor, 3) if anchor and np.isfinite(anchor)
          else head.get("vs_native_anchor", 0.0))
    detail = {"configs": [_compact_config(c) for c in grid],
              "headline_config": head.get("config"),
              "headline_value_is": "device_kernel_evals_per_sec",
              # The head row's true end-to-end rate (head_rate — run_config's
              # return value — is the sample-phase grad rate and ships as
              # grad_evals_per_sec in BENCH_DETAIL.json).
              "end_to_end_evals_per_sec": head.get(
                  "end_to_end_evals_per_sec", round(head_rate, 1)),
              "budget_s": _BUDGET_S,
              "elapsed_s": round(time.monotonic() - _T0, 1),
              "full_detail": "BENCH_DETAIL.json"}
    if head.get("d2h_bandwidth_mbps") is not None:
        detail["d2h_bandwidth_mbps"] = head["d2h_bandwidth_mbps"]
    out = {
        "metric": "gradient_evals_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "grad_evals/s",
        "vs_baseline": vs,
        "detail": detail,
    }
    if provisional:
        out["detail"]["provisional"] = "headline only; grid follows"
    return out


def run_bench():
    # ---- 0. boot line: SOMETHING parseable exists from second one ------
    # A kill before the first config completes must still leave a
    # parseable last line.
    t0 = time.monotonic()
    try:
        jax.block_until_ready(jnp.zeros(8) + 1.0)
        probe_s = round(time.monotonic() - t0, 2)
    except Exception as e:
        probe_s = _short_err(e)
    _emit({"metric": "gradient_evals_per_sec_per_chip", "value": 0.0,
           "unit": "grad_evals/s", "vs_baseline": 0.0,
           "detail": {"provisional": "boot — no config has completed yet",
                      "platform": jax.devices()[0].platform,
                      "device_probe_s": probe_s, "budget_s": _BUDGET_S}})

    # ---- 0b. quick headline: smallest run that still measures the engine
    # end-to-end (256 chains, 100+200 draws); its line is strictly better
    # than the boot line.
    # store_warmup=False: warmup draws/stats never cross the D2H link (the
    # reference's criterion bench stores nothing at all, so thin configs
    # dropping warmup storage is still strictly more end-to-end work than
    # benches/sample.rs measures); warmup leapfrog counts come from the
    # host accounting planes (see run_config).
    thin_kw = dict(keep_stats=(), draw_dtype=jnp.float16,
                   store_warmup=False)
    fb_anchor = _ANCHOR_FALLBACK[(10, 10, 0)]
    try:
        q_rate, q_head = run_config(
            "normal_d10_thin", num_chains=256, num_tune=100, num_draws=200,
            attempts=1, sampler_kw=thin_kw, with_anchor=False)
        q_head["config"] = "normal_d10_thin_quick"
        q_head["native_anchor_evals_per_sec_1core"] = round(fb_anchor, 1)
        q_head["vs_native_anchor"] = round(q_rate / fb_anchor, 3)
        q_head["anchor_source"] = "fallback"
        q_head["provisional"] = ("quick 256-chain probe config — the full "
                                 "1024-chain headline follows")
        _write_detail({"configs": [q_head]})
        _emit_result(_result(q_rate, q_head, [q_head], provisional=True))
    except Exception:
        pass

    # ---- 1. headline: normal_d10_thin (transfer knobs on) --------------
    # Pass 1 emits a provisional line the moment it lands; pass 2 (cheap:
    # the runner cache keeps the traced executables) makes it best-of-2.

    def finish_head(rate, h):
        h["native_anchor_evals_per_sec_1core"] = round(fb_anchor, 1)
        h["vs_native_anchor"] = round(rate / fb_anchor, 3)
        h["anchor_source"] = "fallback"
        return h

    head_rate, head = run_config("normal_d10_thin", sampler_kw=thin_kw,
                                 attempts=1, with_anchor=False)
    head = finish_head(head_rate, head)
    _write_detail({"configs": [head]})
    _emit_result(_result(head_rate, head, [head], provisional=True))
    if _left() > 180:
        try:
            with _deadline(min(180, _left() - 60)):
                r2, h2 = run_config("normal_d10_thin", sampler_kw=thin_kw,
                                    attempts=1, with_anchor=False)
            if r2 > head_rate:
                head_rate, head = r2, finish_head(r2, h2)
        except (_ConfigTimeout, Exception):
            pass
    bw = _d2h_bandwidth_mbps()
    if bw is not None:
        head["d2h_bandwidth_mbps"] = bw
    _emit_result(_result(head_rate, head, [head], provisional=True))

    # ---- 2. real anchor (cached binary; budget-guarded) ----------------
    anchor = native_anchor_rate(10, 1000, 1000, 10)
    if np.isfinite(anchor) and anchor > 0:
        head["native_anchor_evals_per_sec_1core"] = round(anchor, 1)
        head["vs_native_anchor"] = round(head_rate / anchor, 3)
        head["anchor_source"] = _ANCHOR_LAST_SOURCE
    _emit_result(_result(head_rate, head, [head]))

    # ---- 3. side configs, budget-gated AND per-config capped -------------
    # Order is cheap-to-valuable: mclmc + full-stats d10 are fast; logreg
    # configs carry the matmul story (logreg_big is the only matmul-bound
    # config, so it runs BEFORE normal_d1000); normal_d1000 runs thinned
    # (f16 draws + no optional stats) so its number measures the device,
    # not the device->host transfer.
    grid = [head]
    thin = dict(sampler_kw=thin_kw)
    side = [
        # attempts=1: its runners come warm from the headline via the
        # cross-instance runner cache (keep_stats filters host-side,
        # so the jitted runners are identical), and the saved time
        # feeds the expensive d=1000 tail config's SIGALRM cap
        ("normal_d10", dict(attempts=1, num_tune=300, num_draws=700)),
        # 700 draws (matching normal_d10), thin transfer knobs
        ("mclmc_d10", dict(num_tune=300, num_draws=700, **thin)),
        ("logreg_d100", dict(num_tune=300, num_draws=400, **thin)),
        ("logreg_big", dict(num_chains=256, attempts=1, num_tune=300,
                            num_draws=400, **thin)),
        # d=1000 sized to fit the budget TAIL even with cold compile caches:
        # 512 chains x 200+300 (300-draw device probe)
        ("normal_d1000", dict(num_chains=512, num_tune=200, num_draws=300,
                              attempts=1, **thin)),
    ]
    # Each config gets a hard SIGALRM cap sized from the remaining budget so
    # elapsed_s <= budget_s holds even when one config runs 3x slower than
    # expected; 45 s is reserved for the final emit + detail write.
    n_pending = len(side)
    for name, kw in side:
        if _left() < 90:
            grid.append({"config": name, "skipped": "budget"})
            n_pending -= 1
            continue
        cap = max(60.0, (_left() - 45.0) / max(1, n_pending))
        n_pending -= 1
        try:
            with _deadline(min(cap, _left() - 30.0)):
                grid.append(run_config(name, **kw)[1])
        except (_ConfigTimeout, Exception) as e:
            # a failing/overrunning side config must not kill the bench
            grid.append({"config": name, "error": _short_err(e, cap=80)})
        # Keep the artifact current after every config: the last complete
        # line wins, so a kill between configs still records everything
        # finished so far.
        _write_detail({"configs": grid, "budget_s": _BUDGET_S,
                       "elapsed_s": round(time.monotonic() - _T0, 1)})
        _emit_result(_result(head_rate, head, grid))

    # ---- 4. spend leftover budget on extra headline passes --------------
    # Unused budget buys extra best-of-N samples of the headline number;
    # runners come from the cross-instance cache.
    for _ in range(3):
        if _left() < 150:
            break
        try:
            with _deadline(min(120.0, _left() - 30.0)):
                r_new, h_new = run_config("normal_d10_thin",
                                          sampler_kw=thin_kw, attempts=1,
                                          with_anchor=False)
        except (_ConfigTimeout, Exception):
            break
        if r_new > head_rate:
            # keep the measured-anchor fields from the section-2 pass (the
            # fallback-anchor finish_head would overwrite provenance)
            for k in ("native_anchor_evals_per_sec_1core", "anchor_source"):
                if k in head:
                    h_new[k] = head[k]
            a = h_new.get("native_anchor_evals_per_sec_1core")
            if a:
                h_new["vs_native_anchor"] = round(r_new / a, 3)
            head_rate, head = r_new, h_new
            grid[0] = head
            _write_detail({"configs": grid, "budget_s": _BUDGET_S,
                           "elapsed_s": round(time.monotonic() - _T0, 1)})
            _emit_result(_result(head_rate, head, grid))
    return _result(head_rate, head, grid)


def _union_ns(intervals):
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for st, en in sorted(intervals):
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    return total + (0 if cur_e is None else cur_e - cur_s)


def reduce_device_trace(xplane_path, iterations, wall_ns=None,
                        plane_prefix="/device:GPU:0"):
    """Device busy time, idle share and per-while-iteration figures from one
    ``jax.profiler`` trace.

    Busy is the union of the event intervals on the device plane's stream
    lines (kernels and copies); the span runs from the first event's start
    to the last event's end.  ``iterations`` is the number of while-loop
    iterations the traced work ran, so busy / iterations is the device time
    per iteration and (span - busy) / iterations the gap between them.
    """
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    plane = next(p for p in pd.planes if p.name.startswith(plane_prefix))
    intervals, names, lines = [], {}, {}
    for line in plane.lines:
        if not line.name.startswith("Stream"):
            continue
        evs = list(line.events)
        lines[line.name] = len(evs)
        for ev in evs:
            intervals.append((ev.start_ns, ev.end_ns))
            names[ev.name] = names.get(ev.name, 0) + 1
    busy = _union_ns(intervals)
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    copies = sum(n for k, n in names.items() if "memcpy" in k.lower())
    out = {
        "device_events": len(intervals),
        "device_busy_s": busy / 1e9,
        "device_span_s": span / 1e9,
        "device_span_idle_share": 1.0 - busy / span,
        "while_iterations": iterations,
        "device_us_per_iteration": busy / 1e3 / iterations,
        "gap_us_per_iteration": (span - busy) / 1e3 / iterations,
        "events_per_iteration": len(intervals) / iterations,
        "memcpy_events_per_iteration": copies / iterations,
        "stream_lines": lines,
        "top_events": sorted(names.items(), key=lambda kv: -kv[1])[:12],
    }
    if wall_ns is not None:
        out["wall_idle_share"] = 1.0 - busy / wall_ns
    return out


def run_trace(out_dir):
    """Trace one steady posterior chunk of normal_d10 (1024 chains, sync
    kernel, 100 draws) and reduce it with :func:`reduce_device_trace`.

    The profiler slows the host, so the trace's own gap between iterations
    is an upper figure.  The remaining posterior chunks run untraced in the
    same process; their wall time per iteration less the traced device time
    per iteration is the gap a user sees (it includes each chunk's
    device→host transfer and storage)."""
    import glob

    import nuts_rs_tpu as nt

    model, _ = _make_model("normal_d10")
    settings = nt.DiagNutsSettings(num_tune=300, num_draws=700,
                                   num_chains=1024, seed=0)
    sampler = nt.Sampler(model, settings, dtype=jnp.float32, chunk_size=100)

    def iterations_of(stats):
        # The vmapped while loop runs each draw to its longest chain: one
        # iteration per leapfrog of that chain.
        return int(np.asarray(stats["n_steps"]).max(axis=0).sum())

    # Warm: every tuning chunk and the first posterior chunk, so the traced
    # chunk compiles nothing.
    while sampler._next_draw < settings.num_tune + 100:
        sampler.run_next_chunk()
    t0 = time.monotonic_ns()
    with jax.profiler.trace(out_dir):
        _, stats, _ = sampler.run_next_chunk()
    wall = time.monotonic_ns() - t0
    iterations = iterations_of(stats)
    untraced_ns, untraced_iterations = 0, 0
    while sampler._next_draw < settings.num_tune + settings.num_draws:
        t0 = time.monotonic_ns()
        _, s, _ = sampler.run_next_chunk()
        untraced_ns += time.monotonic_ns() - t0
        untraced_iterations += iterations_of(s)
    path = sorted(glob.glob(os.path.join(
        out_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    out = reduce_device_trace(path, iterations, wall_ns=wall)
    untraced_us = untraced_ns / 1e3 / untraced_iterations
    return {"metric": "sync_kernel_trace", "config": "normal_d10",
            "chains": settings.num_chains, "draws": 100,
            "device_kind": jax.devices()[0].device_kind,
            "chunk_wall_s": wall / 1e9,
            "leapfrogs": int(np.asarray(stats["n_steps"]).sum()),
            **out,
            "untraced_chunks_wall_s": untraced_ns / 1e9,
            "untraced_iterations": untraced_iterations,
            "untraced_us_per_iteration": untraced_us,
            "untraced_gap_us_per_iteration":
                untraced_us - out["device_us_per_iteration"],
            "untraced_wall_over_busy":
                untraced_us / out["device_us_per_iteration"]}


def run_mesh():
    """Weak-scaling harness over a chains-axis device mesh: fixed chains PER
    DEVICE, mesh grown over the available devices (BASELINE.json target:
    weak-scaling >= 90%)."""
    import nuts_rs_tpu as nt

    model, _ = _make_model("normal_d10")
    per_dev = 256
    n_total = len(jax.devices())
    rows = []
    base = None
    n = 1
    while n <= n_total:
        C = per_dev * n
        settings = nt.DiagNutsSettings(num_tune=300, num_draws=400,
                                       num_chains=C, seed=0)
        mesh = nt.make_mesh(n)
        t_best, evals = None, 0
        for _ in range(2):
            s = nt.Sampler(model, settings, dtype=jnp.float32,
                           chunk_size=400, mesh=mesh)
            t0 = time.monotonic()
            t = s.run()
            dt = time.monotonic() - t0
            evals = int(np.asarray(
                t.sample_stats["n_steps"]).astype(np.int64).sum())
            t_best = dt if t_best is None else min(t_best, dt)
        rate = evals / t_best
        if base is None:
            base = rate
        rows.append({"devices": n, "chains": C,
                     "evals_per_sec": round(rate, 1),
                     "weak_scaling_efficiency": round(rate / (base * n), 3)})
        _emit({"metric": "mesh_weak_scaling", "value": rows[-1][
            "weak_scaling_efficiency"], "unit": "efficiency",
            "vs_baseline": 1.0,
            "detail": {"rows": rows, "chains_per_device": per_dev,
                       "platform": jax.devices()[0].platform}})
        n *= 2
    return {"metric": "mesh_weak_scaling", "value": rows[-1][
        "weak_scaling_efficiency"], "unit": "efficiency",
        "vs_baseline": 1.0,
        "detail": {"rows": rows, "chains_per_device": per_dev,
                   "platform": jax.devices()[0].platform}}


if __name__ == "__main__":
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX found "
                 f"{jax.devices()[0].platform!r}")
    from chip_smoke import setup_compile_cache

    setup_compile_cache(jax)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    if "--trace" in sys.argv:
        _emit(run_trace(sys.argv[sys.argv.index("--trace") + 1]))
        sys.exit(0)
    try:
        if "--mesh" in sys.argv:
            result = run_mesh()
        elif "--micro" in sys.argv:
            result = run_micro()
        else:
            _start_watchdog()
            result = run_bench()
            _WATCHDOG_CANCEL.set()
    except Exception as e:
        # Readers parse the last JSON line; emit one no matter what.
        result = {"metric": "gradient_evals_per_sec_per_chip", "value": 0.0,
                  "unit": "grad_evals/s", "vs_baseline": 0.0,
                  "detail": {"error": _short_err(e, cap=200)}}
    # The plain `python bench.py` path goes through the length-asserted
    # emitter; --mesh/--micro are developer modes whose rows live outside
    # the tail-window contract.
    if result.get("metric") == "gradient_evals_per_sec_per_chip":
        _emit_result(result)
    else:
        _emit(result)

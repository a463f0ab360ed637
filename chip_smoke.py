"""On-card smoke test: the sampler's main path, through ``nt.sample`` /
``nt.Sampler``, at full width on one GPU, checked against plain references.

    python chip_smoke.py           # one card: phases 0-4
    python chip_smoke.py --four    # four cards: the chain- and dim-sharded
                                   # paths and the one-card runs they are
                                   # compared with, nothing else

Phases (one card):

0. device   — refuses anything but a GPU; prints ``device_kind``, the device
              count and ``nvidia-smi``'s name and power limit.
1. normal_d10  — 10-d iid N(3, 1), 1024 chains, 300 tune + 700 draws, f32,
                 default (sync) NUTS engine.
2. async_d10   — phase 1 on ``posterior_kernel="async"``.
3. mclmc_d10   — phase 1's target on MCLMC.
4. logreg_big  — logistic regression, n=131072, d=100, 256 chains: the
                 model's log density and gradient against numpy f64, and the
                 posterior against a numpy f64 Laplace approximation.

Each phase prints one JSON line with its checks (value, limit, ok), wall and
compile seconds and the device's peak bytes in use.  The last line is
``{"ok": true, "device": {...}}``, printed only when every check passed;
any failure exits non-zero without it.  All JAX work runs in this one
process; ``nvidia-smi`` runs as a child that stays off JAX.

The persistent compile cache goes where ``JAX_COMPILATION_CACHE_DIR`` says,
or to ``.jax_cache`` beside this file when that is unset.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


def compile_cache_dir(environ=os.environ):
    """The compile-cache directory this program sets in code, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads it itself)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(REPO / ".jax_cache")


def setup_compile_cache(jax) -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    return jax.config.jax_compilation_cache_dir


def last_line(device_kind: str, count: int) -> str:
    """The final stdout line, printed only when every check passed."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": count}})


def nvidia_smi_line() -> str:
    """``name, power.limit`` of every card, from a child process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Checks: each returns {"value", "limit", "ok"}.
# ---------------------------------------------------------------------------


def _check(value, limit, ok):
    return {"value": float(value), "limit": limit, "ok": bool(ok)}


def mcse_check(mean, sd, ess, target, k=5.0):
    """Worst coordinate's |mean - target| in units of its Monte-Carlo
    standard error sd / sqrt(ESS_bulk); passes at most ``k``."""
    mcse = np.asarray(sd, np.float64) / np.sqrt(np.asarray(ess, np.float64))
    z = np.abs(np.asarray(mean, np.float64) - target) / mcse
    worst = float(np.max(z))
    return _check(worst, k, np.isfinite(worst) and worst <= k)


def rel_check(values, target, tol):
    """Worst relative deviation of ``values`` from ``target``."""
    dev = float(np.max(np.abs(np.asarray(values, np.float64) / target - 1.0)))
    return _check(dev, tol, np.isfinite(dev) and dev <= tol)


def range_check(value, lo, hi):
    value = float(value)
    return _check(value, [lo, hi], lo <= value <= hi)


def max_check(value, limit):
    value = float(value)
    return _check(value, limit, value <= limit)


def normal_checks(trace, mu, var_tol, nt, accept=True):
    """Moments of an iid N(mu, 1) posterior (and, for NUTS, 0 divergences
    and a mean acceptance in [0.6, 0.95])."""
    s = nt.summary(trace)
    checks = {
        "mean_within_mcse": mcse_check(s["mean"], s["std"], s["ess_bulk"], mu),
        "variance_rel_err": rel_check(np.square(s["std"]), 1.0, var_tol),
        "divergences": max_check(
            np.asarray(trace.sample_stats["diverging"]).sum(), 0),
    }
    if accept:
        checks["mean_tree_accept"] = range_check(
            np.asarray(trace.sample_stats["mean_tree_accept"],
                       np.float64).mean(), 0.6, 0.95)
    return checks


def logreg_logp_grad_np(x, y, q):
    """Plain f64 log density and gradient of ``logistic_regression``."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    q = np.asarray(q, np.float64)
    logits = x @ q
    logp = np.sum(y * logits - np.logaddexp(0.0, logits)) - 0.5 * q @ q
    p = 1.0 / (1.0 + np.exp(-logits))
    return logp, x.T @ (y - p) - q


def laplace_reference(x, y, iters=100, tol=1e-10):
    """Newton's method to the MAP of ``logistic_regression`` in f64; returns
    the MAP and the covariance (X^T W X + I)^-1 there."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    w = np.zeros(x.shape[1])
    for _ in range(iters):
        _, g = logreg_logp_grad_np(x, y, w)
        p = 1.0 / (1.0 + np.exp(-(x @ w)))
        h = (x * (p * (1.0 - p))[:, None]).T @ x + np.eye(x.shape[1])
        step = np.linalg.solve(h, g)
        w = w + step
        if np.max(np.abs(step)) < tol:
            break
    p = 1.0 / (1.0 + np.exp(-(x @ w)))
    h = (x * (p * (1.0 - p))[:, None]).T @ x + np.eye(x.shape[1])
    return w, np.linalg.inv(h)


def grad_rel_err(g, g_ref):
    """Normwise relative error per position, worst over positions."""
    g = np.asarray(g, np.float64)
    g_ref = np.asarray(g_ref, np.float64)
    return float(np.max(np.linalg.norm(g - g_ref, axis=-1)
                        / np.linalg.norm(g_ref, axis=-1)))


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, from its own
    monitoring events."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self, jax):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def run_sampler(nt, clock, model, settings, chunk_size=100, **kw):
    """Sample chunk by chunk; returns the trace and wall/compile seconds of
    the tuning and posterior chunks (``chunk_size`` divides ``num_tune``,
    so no chunk mixes the two)."""
    sampler = nt.Sampler(model, settings, chunk_size=chunk_size, **kw)
    secs = {"tune_s": 0.0, "tune_compile_s": 0.0,
            "sample_s": 0.0, "sample_compile_s": 0.0}
    while not sampler.finished:
        c0, t0 = clock.total, time.monotonic()
        _, _, tuning = sampler.run_next_chunk()
        part = "tune" if np.all(tuning) else "sample"
        secs[f"{part}_s"] += time.monotonic() - t0
        secs[f"{part}_compile_s"] += clock.total - c0
    return sampler.trace.finalize(), secs


def peak_bytes(jax):
    return [d.memory_stats()["peak_bytes_in_use"] for d in jax.local_devices()]


def cache_bytes(path):
    p = Path(path)
    return sum(f.stat().st_size for f in p.rglob("*") if f.is_file())


def emit(record) -> bool:
    print(json.dumps(record), flush=True)
    return all(c["ok"] for c in record.get("checks", {}).values())


def phase_normal(nt, jax, clock, name, num_chains=1024, **settings_kw):
    from nuts_rs_tpu.models import gaussian

    settings = nt.DiagNutsSettings(num_tune=300, num_draws=700,
                                   num_chains=num_chains, seed=0,
                                   **settings_kw)
    trace, secs = run_sampler(nt, clock, gaussian.normal_logp(10, mu=3.0),
                              settings)
    return {"phase": name, "engine": settings._posterior_kernel,
            "checks": normal_checks(trace, 3.0, 0.05, nt), **secs,
            "peak_bytes_in_use": peak_bytes(jax)}


def phase_mclmc(nt, jax, clock, num_chains=1024):
    from nuts_rs_tpu.models import gaussian

    settings = nt.DiagMclmcSettings(num_tune=300, num_draws=700,
                                    num_chains=num_chains, seed=0)
    trace, secs = run_sampler(nt, clock, gaussian.normal_logp(10, mu=3.0),
                              settings)
    # MCLMC has no Metropolis correction: its variance carries step-size
    # bias, hence 10%.
    return {"phase": "mclmc_d10", "engine": "mclmc",
            "checks": normal_checks(trace, 3.0, 0.10, nt, accept=False),
            **secs, "peak_bytes_in_use": peak_bytes(jax)}


def phase_logreg(nt, jax, clock, cache_dir, n_data=131072, dim=100,
                 num_chains=256, num_tune=300, num_draws=400):
    import jax.numpy as jnp

    from nuts_rs_tpu.models import gaussian

    model = gaussian.logistic_regression(n_data=n_data, dim=dim, seed=0)
    x, y = gaussian.logistic_regression_data(n_data, dim, 0)
    w_map, cov = laplace_reference(x, y)
    sd_lap = np.sqrt(np.diag(cov))

    # (a) log density and gradient at 8 positions around the MAP.
    rng = np.random.default_rng(1)
    qs = w_map + rng.normal(size=(8, dim)) * 5.0 * sd_lap
    ref = [logreg_logp_grad_np(x, y, q) for q in qs]
    g_ref = np.stack([g for _, g in ref])
    lp_ref = np.array([lp for lp, _ in ref])
    q_dev = jnp.asarray(qs, jnp.float32)
    lp, g = jax.jit(jax.vmap(model.logp_and_grad))(q_dev)
    # The same gradient without Model.logp_and_grad's precision scope:
    # the default f32 matmul precision (TF32 on this card).
    _, g_plain = jax.jit(jax.vmap(jax.value_and_grad(model.logp_fn)))(q_dev)
    checks = {
        "grad_rel_err": max_check(grad_rel_err(g, g_ref), 1e-4),
    }
    info = {
        "grad_rel_err_default_precision": grad_rel_err(g_plain, g_ref),
        "logp_rel_err": float(np.max(np.abs(np.asarray(lp, np.float64)
                                            - lp_ref) / np.abs(lp_ref))),
    }

    # (b) the posterior against the Laplace approximation.
    settings = nt.DiagNutsSettings(num_tune=num_tune, num_draws=num_draws,
                                   num_chains=num_chains, seed=0)
    trace, secs = run_sampler(nt, clock, model, settings)
    s = nt.summary(trace)
    checks["mean_offset_in_laplace_sd"] = max_check(
        np.max(np.abs(s["mean"] - w_map) / sd_lap), 0.1)
    checks["sd_ratio_rel_err"] = rel_check(s["std"] / sd_lap, 1.0, 0.1)
    checks["divergences"] = max_check(
        np.asarray(trace.sample_stats["diverging"]).sum(), 0)
    return {"phase": "logreg_big", "engine": settings._posterior_kernel,
            "checks": checks, **info, **secs,
            "peak_bytes_in_use": peak_bytes(jax),
            "compile_cache_bytes": cache_bytes(cache_dir)}


def phase_chain_sharded(nt, jax, clock, per_card=1024):
    """4096 chains sharded over 4 cards with pooled adaptation, against
    the same settings at 1024 chains on one card."""
    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(10, mu=3.0)
    runs = {}
    for name, chains, mesh in (("one_card", per_card, None),
                               ("four_cards", 4 * per_card,
                                nt.make_mesh(4))):
        settings = nt.DiagNutsSettings(num_tune=300, num_draws=700,
                                       num_chains=chains, seed=0,
                                       cross_chain_adaptation=True)
        trace, secs = run_sampler(nt, clock, model, settings, mesh=mesh)
        runs[name] = (trace, secs)
    checks = {}
    for name, (trace, _) in runs.items():
        for k, c in normal_checks(trace, 3.0, 0.05, nt).items():
            checks[f"{name}.{k}"] = c
    bar = np.asarray(runs["four_cards"][0].sample_stats["step_size_bar"])
    last = bar[:, -1]
    checks["four_cards.pooled_step_size_bar"] = max_check(
        np.max(np.abs(last / last[0] - 1.0)), 1e-6)
    s1, s4 = (nt.summary(runs[n][0]) for n in ("one_card", "four_cards"))
    se = np.sqrt(np.square(s1["std"]) / s1["ess_bulk"]
                 + np.square(s4["std"]) / s4["ess_bulk"])
    checks["means_agree_in_mcse"] = max_check(
        np.max(np.abs(s1["mean"] - s4["mean"]) / se), 5.0)
    return {"phase": "chain_sharded_normal_d10", "checks": checks,
            **{f"{n}.{k}": v for n, (_, secs) in runs.items()
               for k, v in secs.items()},
            "peak_bytes_in_use": peak_bytes(jax)}


def dim_sharded_checks(x, mu, nt, ess_dims=32):
    """Analytic N(mu, 1) moments of a large-d posterior ``x`` [chain, draw,
    dim], averaged over coordinates: the averaged mean within 5 standard
    errors and the averaged variance within 10% (unadjusted sampler).  The
    coordinates are iid, so the ESS of the first ``ess_dims`` stands in for
    all (the per-coordinate estimator is a host loop)."""
    x = np.asarray(x, np.float64)
    d = x.shape[-1]
    var = x.var(axis=(0, 1))
    ess = float(np.mean(nt.ess_bulk(x[..., :ess_dims])))
    se = np.sqrt(np.mean(var) / ess / d)
    return float(np.mean(var)), {
        "avg_mean_in_se": max_check(abs(x.mean() - mu) / se, 5.0),
        "avg_variance_rel_err": rel_check(np.mean(var), 1.0, 0.10),
        "finite": max_check(np.sum(~np.isfinite(x)), 0),
    }


def phase_dim_sharded(nt, jax, clock, dim=10_000, num_chains=64):
    """MCLMC on a 10^4-d N(3, 1) with the parameter axis sharded over 4
    cards, against the same run on one card."""
    from nuts_rs_tpu.models import gaussian
    from nuts_rs_tpu.parallel.mesh import make_mesh_2d

    model = gaussian.normal_logp(dim, mu=3.0)
    settings = nt.DiagMclmcSettings(num_tune=300, num_draws=500,
                                    num_chains=num_chains, seed=0,
                                    cross_chain_adaptation=True)
    checks, out, var = {}, {}, {}
    for name, mesh in (("one_card", None), ("four_cards", make_mesh_2d(1, 4))):
        trace, secs = run_sampler(nt, clock, model, settings, mesh=mesh)
        var[name], c = dim_sharded_checks(trace.posterior["position"], 3.0,
                                          nt)
        checks.update({f"{name}.{k}": v for k, v in c.items()})
        out.update({f"{name}.{k}": v for k, v in secs.items()})
        del trace
    checks["variances_agree"] = rel_check(var["four_cards"], var["one_card"],
                                          0.05)
    return {"phase": "dim_sharded_mclmc_d1e4", "checks": checks, **out,
            "peak_bytes_in_use": peak_bytes(jax)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card paths")
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    count = len(jax.devices())
    need = 4 if args.four else 1
    if count < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {count}",
              file=sys.stderr)
        return 2
    cache_dir = setup_compile_cache(jax)
    clock = CompileClock(jax)
    import nuts_rs_tpu as nt

    emit({"phase": "device", "device_kind": dev.device_kind,
          "device_count": count, "nvidia_smi": nvidia_smi_line(),
          "jax": jax.__version__, "compile_cache": cache_dir})
    if args.four:
        phases = [lambda: phase_chain_sharded(nt, jax, clock),
                  lambda: phase_dim_sharded(nt, jax, clock)]
    else:
        phases = [lambda: phase_normal(nt, jax, clock, "normal_d10"),
                  lambda: phase_normal(nt, jax, clock, "async_d10",
                                       posterior_kernel="async"),
                  lambda: phase_mclmc(nt, jax, clock),
                  lambda: phase_logreg(nt, jax, clock, cache_dir)]
    ok = True
    for phase in phases:
        ok = emit(phase()) and ok
    if not ok:
        print("chip_smoke: a check failed", file=sys.stderr)
        return 1
    print(last_line(dev.device_kind, count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Quantify the documented schedule deviation on a divergence-heavy target.

The reference advances warmup windows by the per-chain count of GOOD
(non-divergent) draws (src/adapt_strategy.rs:121-222); this framework
advances by draw index (adapt/schedule.py, documented deviation)
while per-chain is_good masks still gate which samples enter the estimators
and the mass-matrix update keeps a per-chain `count >= 3` guard.  These
tests pin what that deviation is allowed to cost: on a target where a large
fraction of warmup draws diverge, adaptation must still produce finite,
positive transforms, a sane step size, and a correct posterior.
"""

import numpy as np

import nuts_rs_tpu as nt
from nuts_rs_tpu.models import gaussian


def _run(max_energy_error, seed=0):
    model = gaussian.funnel(6)
    settings = nt.DiagNutsSettings(
        num_tune=400, num_draws=400, num_chains=8, seed=seed,
        max_energy_error=max_energy_error, store_mass_matrix=True)
    sampler = nt.Sampler(model, settings, chunk_size=200, fail_after=None)
    trace = sampler.run()
    return sampler, trace


def test_divergence_heavy_warmup_still_adapts():
    # Strict energy threshold: the funnel's neck makes a large fraction of
    # warmup trees divergent, so per-chain good-draw counts lag draw counts
    # badly — the regime where the schedule deviation bites hardest.
    sampler, trace = _run(max_energy_error=3.0)
    wdiv = trace.warmup_sample_stats["diverging"]
    assert wdiv.mean() > 0.05, "target not divergence-heavy; test is vacuous"

    # (1) the adapted transform stayed valid on every chain
    mm = trace.sample_stats["mass_matrix_inv"]  # [C, K, d]
    assert np.isfinite(mm).all()
    assert (mm > 0).all()
    # (2) step size converged to something sane (not collapsed/exploded)
    step = trace.sample_stats["step_size"]
    assert np.isfinite(step).all()
    assert (step > 1e-6).all() and (step < 10.0).all()
    # (3) the log-scale marginal (funnel v ~ N(0, 3^2), coordinate 0) is
    # still recovered within loose MC error despite the divergences
    v = trace.posterior["position"][..., 0].astype(np.float64)
    assert abs(v.mean()) < 1.0
    assert 1.5 < v.std() < 4.5


def test_schedule_deviation_baseline_comparison():
    """On an easy target (few divergences) the deviation is a no-op by
    construction; on the hard target above, the final step size must stay
    within an order of magnitude of the easy-threshold run — i.e. mistimed
    windows may blur adaptation, not destroy it."""
    _, hard = _run(max_energy_error=3.0)
    _, easy = _run(max_energy_error=1000.0)
    s_hard = float(np.median(hard.sample_stats["step_size"]))
    s_easy = float(np.median(easy.sample_stats["step_size"]))
    assert s_hard > s_easy / 30.0
    assert s_hard < s_easy * 30.0

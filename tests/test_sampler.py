"""End-to-end sampler tests against analytic targets.

Mirrors the reference's smoke and posterior-moment oracles:
* NUTS reaches mean 30 within 5 after 200 draws (adapt_strategy.rs:352-435)
* BASELINE config 1: 10-d N(3, 1), posterior moments within MC error
  (README.md:40-87, tests/sample_normal.rs)
"""

import numpy as np
import pytest

from nuts_rs_tpu import DiagNutsSettings, sample
from nuts_rs_tpu.models import gaussian


def test_smoke_reaches_mean_30():
    model = gaussian.normal_logp(10, mu=30.0)
    settings = DiagNutsSettings(num_tune=100, num_draws=100, num_chains=1,
                                seed=42)
    trace = sample(model, settings, chunk_size=64)
    last = trace.posterior["position"][0, -1]
    assert np.all(np.abs(last - 30.0) < 5.0), last
    assert not trace.sample_stats["diverging"].any()


def test_posterior_moments_normal():
    model = gaussian.normal_logp(10, mu=3.0)
    settings = DiagNutsSettings(num_tune=400, num_draws=1000, num_chains=4,
                                seed=1)
    trace = sample(model, settings, chunk_size=200)
    draws = trace.posterior["position"]  # [chain, draw, dim]
    assert draws.shape == (4, 1000, 10)
    mean = draws.mean(axis=(0, 1))
    std = draws.std(axis=(0, 1))
    # MC error of the mean with ~4000 (correlated) draws is < 0.1
    np.testing.assert_allclose(mean, 3.0, atol=0.15)
    np.testing.assert_allclose(std, 1.0, atol=0.15)
    # post-warmup step size should have adapted to a sensible range
    assert 0.3 < trace.sample_stats["step_size"].mean() < 2.5
    # acceptance should be near the 0.8 target
    acc = trace.sample_stats["mean_tree_accept"].mean()
    assert 0.6 < acc < 0.99


def test_posterior_moments_dense_covariance():
    """mv_normal (dense-covariance fixture, nuts-rs src/transform/mod.rs:39):
    the diagonal mass matrix must still recover correct marginal moments on a
    correlated target."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(4, 4))
    cov = a @ a.T + 4.0 * np.eye(4)
    model = gaussian.mv_normal(cov)
    settings = DiagNutsSettings(num_tune=400, num_draws=1000, num_chains=8,
                                seed=2)
    trace = sample(model, settings, chunk_size=200)
    draws = np.asarray(trace.posterior["position"])
    flat = draws.reshape(-1, 4)
    np.testing.assert_allclose(flat.mean(axis=0), 0.0, atol=0.2)
    np.testing.assert_allclose(flat.std(axis=0), np.sqrt(np.diag(cov)),
                               rtol=0.12)
    # off-diagonal structure survives sampling: sample cov tracks the truth
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.9)


def test_stats_schema():
    model = gaussian.normal_logp(5, mu=0.0)
    settings = DiagNutsSettings(
        num_tune=60, num_draws=40, num_chains=2, seed=3,
        store_gradient=True, store_unconstrained=True, store_divergences=True)
    trace = sample(model, settings, chunk_size=50)
    ss = trace.sample_stats
    for name in ["depth", "maxdepth_reached", "diverging", "n_steps",
                 "step_size", "step_size_bar", "mean_tree_accept",
                 "mean_tree_accept_sym", "max_energy_error", "logp", "energy",
                 "energy_error", "index_in_trajectory", "fisher_distance",
                 "transformation_index", "tuning", "gradient",
                 "unconstrained_draw", "divergence_start"]:
        assert name in ss, name
    assert ss["depth"].shape == (2, 40)
    assert ss["gradient"].shape == (2, 40, 5)
    assert not ss["tuning"].any()
    assert trace.warmup_sample_stats["tuning"].all()
    # transformation updates were compacted into events
    assert len(trace.transformation_updates) == 2
    assert len(trace.transformation_updates[0]["draw"]) > 1


def test_expand_fn():
    model = gaussian.eight_schools()
    settings = DiagNutsSettings(num_tune=200, num_draws=100, num_chains=2,
                                seed=5)
    trace = sample(model, settings, chunk_size=100)
    assert trace.posterior["theta"].shape == (2, 100, 8)
    assert trace.posterior["mu"].shape == (2, 100)
    assert np.isfinite(trace.posterior["tau"]).all()


def test_seed_reproducibility():
    model = gaussian.normal_logp(4, mu=1.0)
    settings = DiagNutsSettings(num_tune=50, num_draws=50, num_chains=2, seed=7)
    t1 = sample(model, settings, chunk_size=25)
    t2 = sample(model, settings, chunk_size=100)  # chunking must not matter
    np.testing.assert_array_equal(t1.posterior["position"],
                                  t2.posterior["position"])


def test_chains_differ():
    model = gaussian.normal_logp(4, mu=1.0)
    settings = DiagNutsSettings(num_tune=50, num_draws=50, num_chains=3, seed=7)
    t = sample(model, settings)
    d = t.posterior["position"]
    assert not np.allclose(d[0], d[1])
    assert not np.allclose(d[1], d[2])


def test_checkpoint_resume(tmp_path):
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g

    model = g.normal_logp(4, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=40, num_draws=40, num_chains=2,
                                   seed=11)
    # uninterrupted run
    full = nt.sample(model, settings, chunk_size=20)

    # interrupted at draw 40, checkpointed, resumed in a fresh sampler
    s1 = nt.Sampler(model, settings, chunk_size=20)
    s1.run_next_chunk()
    s1.run_next_chunk()
    ckpt = str(tmp_path / "state.npz")
    s1.checkpoint(ckpt)

    s2 = nt.Sampler(model, settings, chunk_size=20)
    s2.restore(ckpt)
    assert s2._next_draw == 40
    while not s2.finished:
        s2.run_next_chunk()
    resumed = s2.trace.finalize()

    # resumed posterior must be bit-identical to the uninterrupted run
    np.testing.assert_array_equal(resumed.posterior["position"],
                                  full.posterior["position"])


def test_async_posterior_kernel():
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g

    model = g.normal_logp(6, mu=2.0)
    base = dict(num_tune=200, num_draws=600, num_chains=4, seed=13)
    tr_async = sample(model, DiagNutsSettings(async_posterior=True, **base),
                      chunk_size=250)
    tr_sync = sample(model, DiagNutsSettings(async_posterior=False, **base),
                     chunk_size=250)
    da, ds = tr_async.posterior["position"], tr_sync.posterior["position"]
    assert da.shape == ds.shape
    # different PRNG consumption, same distribution
    np.testing.assert_allclose(da.mean(), ds.mean(), atol=0.1)
    np.testing.assert_allclose(da.std(), ds.std(), atol=0.1)
    ssa = tr_async.sample_stats
    assert abs(ssa["mean_tree_accept"].mean()
               - tr_sync.sample_stats["mean_tree_accept"].mean()) < 0.05
    assert not ssa["diverging"].any()
    # chunk invariance holds for the async path too
    tr_async2 = sample(model, DiagNutsSettings(async_posterior=True, **base),
                       chunk_size=800)
    np.testing.assert_array_equal(da, tr_async2.posterior["position"])


def test_exact_normal_kinetic_energy():
    # Geodesic (ExactNormal) integrator end-to-end; exact for the whitened
    # standard-normal target, so acceptance should be essentially 1.
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g

    model = g.normal_logp(8, mu=3.0)
    settings = DiagNutsSettings(
        num_tune=150, num_draws=300, num_chains=2, seed=21,
        kinetic_energy=nt.KineticKind.EXACT_NORMAL)
    trace = sample(model, settings, chunk_size=150)
    d = trace.posterior["position"]
    np.testing.assert_allclose(d.mean(), 3.0, atol=0.1)
    np.testing.assert_allclose(d.std(), 1.0, atol=0.12)
    # once the mass matrix converges, the geodesic flow is near-exact
    acc = trace.sample_stats["mean_tree_accept"]
    assert acc.mean() > 0.9
    assert not trace.sample_stats["diverging"].any()


def test_posterior_kernels_agree_statistically():
    # sync / async posterior engines must produce the same posterior on a
    # correlated target (different RNG streams, same distribution).
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g

    model = g.correlated_normal(6, rank1_scale=0.5)
    base = dict(num_tune=200, num_draws=500, num_chains=8, seed=29)
    results = {}
    for kernel in ("sync", "async"):
        tr = sample(model, DiagNutsSettings(posterior_kernel=kernel, **base),
                    chunk_size=700)
        d = tr.posterior["position"]
        results[kernel] = (d.mean(), d.std(),
                          tr.sample_stats["mean_tree_accept"].mean())
    for kernel, (m, s, a) in results.items():
        assert abs(m) < 0.08, (kernel, m)
        # marginal std of Sigma = I + 0.5*ones*ones^T is sqrt(1.5)
        assert abs(s - np.sqrt(1.5)) < 0.1, (kernel, s)
        assert 0.6 < a <= 1.0, (kernel, a)


def test_pause_resume_api():
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g

    model = g.normal_logp(3, 0.0)
    s = DiagNutsSettings(num_tune=20, num_draws=20, num_chains=2, seed=31)
    sam = nt.Sampler(model, s, chunk_size=10)
    sam.run_next_chunk()
    sam.pause()
    with pytest.raises(RuntimeError):
        sam.run()
    sam.resume()
    trace = sam.run()
    assert trace.posterior["position"].shape == (2, 20, 3)


def test_mesh_public_api():
    # Public mesh execution: Sampler(..., mesh=) shards chains over the
    # 8-device mesh with cross-chain pooled adaptation.
    import jax
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g
    from nuts_rs_tpu.parallel.mesh import make_mesh

    model = g.normal_logp(5, mu=2.0)
    settings = DiagNutsSettings(num_tune=150, num_draws=150, num_chains=16,
                                seed=11, cross_chain_adaptation=True)
    tr = sample(model, settings, mesh=make_mesh(8), chunk_size=100)
    d = tr.posterior["position"]
    assert d.shape == (16, 150, 5)
    assert abs(d.mean() - 2.0) < 0.15
    assert not tr.sample_stats["diverging"].any()
    # cross-chain pooling: one shared adapted step size across all chains
    # (per-draw step_size additionally carries per-chain +-10% jitter)
    ss_last = tr.sample_stats["step_size_bar"][:, -1]
    np.testing.assert_allclose(ss_last, np.broadcast_to(ss_last[0], ss_last.shape),
                               rtol=1e-6)

    # num_chains not divisible by mesh size -> named error
    bad = DiagNutsSettings(num_tune=10, num_draws=10, num_chains=3, seed=0)
    with pytest.raises(ValueError, match="multiple"):
        nt.Sampler(model, bad, mesh=make_mesh(8))

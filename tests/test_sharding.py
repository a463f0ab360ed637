"""Multi-device mesh tests on the virtual 8-device CPU mesh.

Validates the multi-device parallelism component (SURVEY.md §2.12): chains
sharded over a ``Mesh`` axis with ``shard_map``, cross-chain adaptation
statistics pooled with ``psum`` over the mesh axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import nuts_rs_tpu as nt
from nuts_rs_tpu.adapt.mass_matrix import RunningVariance, add_sample, new_running_variance
from nuts_rs_tpu.models import gaussian
from nuts_rs_tpu.parallel.collectives import merge_running_variance
from nuts_rs_tpu.parallel.mesh import (
    CHAIN_AXIS,
    chain_specs,
    make_mesh,
    shard_chain_state,
)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_merge_running_variance_local():
    # Pooled estimator must match a single estimator fed all samples.
    rng = np.random.default_rng(0)
    d, c, n = 4, 6, 30
    data = rng.normal(size=(c, n, d))

    per_chain = jax.vmap(lambda _: new_running_variance(d, jnp.float64))(
        jnp.arange(c))
    for i in range(n):
        per_chain = jax.vmap(add_sample)(per_chain, jnp.asarray(data[:, i]))

    pooled = merge_running_variance(per_chain)
    # reference: all samples in one estimator (order differs; mean matches
    # exactly, var_sum approximately — the reference estimator is
    # order-dependent, the parallel merge is the standard exact one)
    np.testing.assert_allclose(np.asarray(pooled.count),
                               np.full(c, c * n), atol=0)
    np.testing.assert_allclose(
        np.asarray(pooled.mean[0]), data.reshape(-1, d).mean(axis=0),
        atol=1e-12)
    # variance close to the empirical variance (the reference's running
    # estimator is biased slightly high — it accumulates squared deviations
    # from the running mean, cpu_math.rs:605-631 — so allow generous slack)
    var = np.asarray(pooled.var_sum[0]) / (c * n - 1)
    np.testing.assert_allclose(var, data.reshape(-1, d).var(axis=0, ddof=1),
                               rtol=0.35)


def test_merge_running_variance_psum():
    # Pooling under shard_map over the mesh must equal local pooling.
    from jax import shard_map

    rng = np.random.default_rng(1)
    d, c = 3, 16
    mesh = make_mesh(8)
    counts = jnp.asarray(rng.integers(5, 20, size=c).astype(np.float64))
    means = jnp.asarray(rng.normal(size=(c, d)))
    var_sums = jnp.asarray(rng.uniform(1, 2, size=(c, d)))
    rv = RunningVariance(mean=means, var_sum=var_sums, count=counts)

    local = merge_running_variance(rv)

    def f(rv):
        return merge_running_variance(rv, axis_name=CHAIN_AXIS)

    spec = RunningVariance(mean=P(CHAIN_AXIS), var_sum=P(CHAIN_AXIS),
                           count=P(CHAIN_AXIS))
    # NamedTuples are tuple subclasses: in_specs needs explicit 1-arg nesting.
    sharded = shard_map(f, mesh=mesh, in_specs=(spec,), out_specs=spec)(rv)

    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                atol=1e-10),
        local, sharded)


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_sharded_sampling_matches_unsharded_shapes():
    # Full warmup+sampling with the chain state sharded over the mesh: must
    # run end to end and produce the same shapes/diagnostics as unsharded.
    from jax import shard_map

    from nuts_rs_tpu.chain import DiagStrategy, init_chain_state, make_draw_step
    from nuts_rs_tpu.sampler import _schedule_chunk, _schedule_for

    mesh = make_mesh(8)
    model = gaussian.normal_logp(6, mu=2.0)
    settings = nt.DiagNutsSettings(num_tune=40, num_draws=24, num_chains=16,
                                   seed=0)
    config = settings.chain_config()
    strategy = DiagStrategy(config, cross_chain=True, axis_name=CHAIN_AXIS)
    sched = _schedule_for(settings)

    state = init_chain_state(jax.random.key(0), model, strategy, config,
                             16, 40, jnp.float64)
    state = jax.tree.map(lambda x: jnp.array(x, copy=True), state)
    state = shard_chain_state(state, mesh)

    step = make_draw_step(model, strategy, config)
    flags = _schedule_chunk(sched, 0, 64)
    specs = chain_specs(state)

    def run(state, flags):
        return jax.lax.scan(step, state, flags)

    sharded_run = shard_map(
        run, mesh=mesh, in_specs=(specs, P()),
        out_specs=(specs, P(None, CHAIN_AXIS)), check_vma=False)
    final, stats = jax.jit(sharded_run)(state, flags)

    assert stats["position"].shape == (64, 16, 6)
    draws = np.asarray(stats["position"][40:])
    assert abs(draws.mean() - 2.0) < 0.3
    # early warmup may diverge; post-warmup draws must not
    assert not np.asarray(stats["diverging"][40:]).any()
    # cross-chain pooling: after warmup all chains share one mass matrix
    stds = np.asarray(final.transform.stds)
    np.testing.assert_allclose(stds, np.broadcast_to(stds[0], stds.shape),
                               rtol=1e-6)


def test_cross_chain_adaptation_setting():
    # cross_chain_adaptation=True through the public API: all chains share
    # one mass matrix and one adapted step size after warmup.
    model = gaussian.normal_logp(5, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=150, num_draws=100, num_chains=8,
                                   seed=2, cross_chain_adaptation=True)
    trace = nt.sample(model, settings, chunk_size=250)
    d = trace.posterior["position"]
    assert abs(d.mean() - 1.0) < 0.1
    bars = trace.sample_stats["step_size_bar"][:, -1]
    np.testing.assert_allclose(bars, bars[0], rtol=1e-6)


def test_mclmc_cross_chain_adaptation_on_mesh():
    # BASELINE config 5's "psum'd adaptation": MCLMC with chains sharded
    # over the mesh and the diag mass-matrix estimators pooled across
    # chains/devices.  MCLMC's step size stays fixed (reference semantics);
    # the pooled geometry must be identical on every chain after warmup.
    mesh = make_mesh(8)
    model = gaussian.normal_logp(64, mu=1.0)
    settings = nt.DiagMclmcSettings(
        num_tune=200, num_draws=200, num_chains=8, seed=4,
        cross_chain_adaptation=True, store_mass_matrix=True)
    trace = nt.sample(model, settings, mesh=mesh, chunk_size=400)
    pos = np.asarray(trace.posterior["position"])
    flat = pos.reshape(-1, 64)
    assert abs(flat.mean() - 1.0) < 0.1
    assert abs(flat.std() - 1.0) < 0.15
    # pooled mass matrix: every chain carries the same stds on the last draw
    mm = np.asarray(trace.sample_stats["mass_matrix_inv"])[:, -1]
    np.testing.assert_allclose(mm, np.broadcast_to(mm[0], mm.shape),
                               rtol=1e-6)

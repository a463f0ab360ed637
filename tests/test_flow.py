"""Flow (learned transform) adaptation tests.

Covers the JAX-native replacement of nuts-rs ``ExternalTransformation`` +
``ExternalTransformAdaptation`` (src/transform/external.rs,
src/external_adapt_strategy.rs) and the built-in flows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nuts_rs_tpu as nt
from nuts_rs_tpu.flows.coupling import (
    CouplingFlowConfig,
    coupling_flow,
    diag_affine_flow,
)
from nuts_rs_tpu.models import gaussian
from nuts_rs_tpu.models.model import Model
from nuts_rs_tpu.transform.ops import FlowOps, FlowTransform


def _perturb_nets(params, scale, seed):
    # Perturb only the coupling nets; masks must stay binary.
    key = jax.random.key(seed)
    layers = []
    for layer in params["layers"]:
        key, k = jax.random.split(key)
        net = jax.tree.map(
            lambda x: x + scale * jax.random.normal(k, x.shape, x.dtype),
            layer["net"])
        layers.append({"mask": layer["mask"], "net": net})
    return {**params, "layers": layers}


def test_coupling_flow_inverse_consistency():
    spec = coupling_flow(CouplingFlowConfig(num_layers=3, hidden=8))
    key = jax.random.key(0)
    d = 6
    q0 = jax.random.normal(key, (d,), jnp.float64)
    params = spec.init(key, d, q0, -q0)
    z = jax.random.normal(jax.random.key(1), (d,), jnp.float64)
    q, ld_f = spec.forward(params, z)
    z2, ld_i = spec.inverse(params, q)
    np.testing.assert_allclose(np.asarray(z2), np.asarray(z), atol=1e-10)
    np.testing.assert_allclose(float(ld_f), float(ld_i), atol=1e-10)


def test_coupling_flow_logdet_matches_jacobian():
    spec = coupling_flow(CouplingFlowConfig(num_layers=2, hidden=8))
    d = 4
    key = jax.random.key(2)
    q0 = jax.random.normal(key, (d,), jnp.float64)
    params = spec.init(key, d, q0, -q0)
    params = _perturb_nets(params, 0.1, 3)
    z = jax.random.normal(jax.random.key(4), (d,), jnp.float64)
    q, ld = spec.forward(params, z)
    jac = jax.jacobian(lambda zz: spec.forward(params, zz)[0])(z)
    _, expected = np.linalg.slogdet(np.asarray(jac))
    np.testing.assert_allclose(float(ld), expected, atol=1e-9)


def test_flow_ops_gradient():
    # zg must be the gradient of logp(F(z)) + logdet(z) wrt z.
    spec = coupling_flow(CouplingFlowConfig(num_layers=2, hidden=8))
    ops = FlowOps(spec)
    d = 4
    key = jax.random.key(5)
    q0 = jax.random.normal(key, (d,), jnp.float64)
    params = spec.init(key, d, q0, -q0)
    params = _perturb_nets(params, 0.05, 6)
    t = FlowTransform(params=params, id=jnp.int32(0))

    def lg(q):
        lp = -0.5 * jnp.sum((q - 1.0) ** 2) - 0.1 * jnp.sum(q ** 4)
        return lp, jax.grad(lambda qq: -0.5 * jnp.sum((qq - 1.0) ** 2)
                            - 0.1 * jnp.sum(qq ** 4))(q)

    z = jax.random.normal(jax.random.key(7), (d,), jnp.float64)
    q, logp, g, zg, logdet = ops.eval_from_z(t, z, lg)

    def transformed_logp(zz):
        qq, ld = spec.forward(params, zz)
        return lg(qq)[0] + ld

    expected = jax.grad(transformed_logp)(z)
    np.testing.assert_allclose(np.asarray(zg), np.asarray(expected), atol=1e-9)


def test_diag_affine_flow_sampling():
    # Shifted/scaled Gaussian through the affine flow path end-to-end.
    model = gaussian.normal_logp(5, mu=3.0)
    settings = nt.FlowNutsSettings(
        num_tune=200, num_draws=300, num_chains=2, seed=0,
        flow_spec=diag_affine_flow())
    trace = nt.sample(model, settings, chunk_size=100)
    draws = trace.posterior["position"]
    assert abs(draws.mean() - 3.0) < 0.15
    assert abs(draws.std() - 1.0) < 0.2
    assert not trace.sample_stats["diverging"].any()


def test_coupling_flow_sampling_funnel():
    # Smoke: coupling flow on a small funnel; must run, stay finite, and keep
    # divergences low after the flow adapts.
    model = gaussian.funnel(4)
    settings = nt.FlowNutsSettings(
        num_tune=300, num_draws=200, num_chains=1, seed=1,
        flow_spec=coupling_flow(CouplingFlowConfig(
            num_layers=2, hidden=16, train_steps=100)))
    trace = nt.sample(model, settings, chunk_size=150)
    draws = trace.posterior["position"]
    assert np.isfinite(draws).all()
    v = draws[..., 0]
    assert abs(v.mean()) < 1.5
    # flow actually refit during warmup
    ids = trace.warmup_sample_stats["transformation_index"]
    assert ids.max() > 0


def test_flow_orbit_collection_sampling():
    # use_orbit_for_training (external_adapt_strategy.rs:21,35): the window
    # is fed every leapfrog point, not one point per draw.  The flow must
    # still adapt and sample correctly, and the window must fill much faster
    # than the draw count.
    from nuts_rs_tpu.adapt.flow import FlowAdaptSettings

    model = gaussian.normal_logp(4, mu=3.0)
    settings = nt.FlowNutsSettings(
        num_tune=200, num_draws=200, num_chains=2, seed=0,
        maxdepth=6,
        flow_spec=diag_affine_flow(),
        flow=FlowAdaptSettings(use_orbit_for_training=True,
                               window_capacity=4096))
    sampler = nt.Sampler(model, settings, chunk_size=100)
    while not sampler.finished:
        sampler.run_next_chunk()
    trace = sampler.trace.finalize()
    draws = trace.posterior["position"]
    assert abs(draws.mean() - 3.0) < 0.15
    assert not trace.sample_stats["diverging"].any()
    # Orbit mode collected ~n_steps points per warmup draw (>> 200 draws).
    counts = np.asarray(sampler.state.extra.count)
    n_warmup_steps = trace.warmup_sample_stats["n_steps"].sum(axis=1)
    assert (counts > 400).all()
    assert (counts <= n_warmup_steps).all()


def test_flow_async_posterior_chunk_invariance():
    # The draw-asynchronous kernel restarts trajectories with resync=False
    # (carried z/zg/logdet); with a flow transform this is the path where a
    # stale or round-tripped cache would corrupt energies.  The posterior
    # must be chunk-invariant bit-for-bit and match the flow sync path's
    # moments.
    model = gaussian.normal_logp(5, mu=3.0)
    base = dict(num_tune=200, num_draws=300, num_chains=2, seed=0,
                flow_spec=diag_affine_flow())
    tr_a = nt.sample(model, nt.FlowNutsSettings(posterior_kernel="async",
                                                **base), chunk_size=100)
    tr_b = nt.sample(model, nt.FlowNutsSettings(posterior_kernel="async",
                                                **base), chunk_size=250)
    np.testing.assert_array_equal(tr_a.posterior["position"],
                                  tr_b.posterior["position"])
    d = np.asarray(tr_a.posterior["position"])
    assert abs(d.mean() - 3.0) < 0.15
    assert abs(d.std() - 1.0) < 0.2
    assert np.isfinite(np.asarray(tr_a.sample_stats["energy"])).all()

"""Posterior engines and flow refits under a chain mesh, on the virtual
8-device CPU mesh.

Chains shard over the mesh ``chains`` axis with ``shard_map``; each device
runs the same engine on its shard.  These tests check that composition
end to end:

* the draw-asynchronous kernel under a mesh (threefry keys shard naturally);
* MCLMC's phase runners under a mesh;
* pooled flow refits under a mesh train one shared flow.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import nuts_rs_tpu as nt
from nuts_rs_tpu.models import gaussian
from nuts_rs_tpu.parallel.mesh import make_mesh

MU = 3.0


@pytest.mark.parametrize("kernel", ["async"])
def test_mesh_fused_kernels_posterior(kernel):
    settings = nt.DiagNutsSettings(num_tune=220, num_draws=300,
                                   num_chains=16, seed=5,
                                   posterior_kernel=kernel)
    trace = nt.Sampler(gaussian.normal_logp(3, MU), settings,
                       mesh=make_mesh(), dtype=jnp.float32,
                       chunk_size=128).run()
    pos = np.asarray(trace.posterior["position"])  # [chains, draws, d]
    assert pos.shape[0] == 16
    se = 1.0 / np.sqrt(pos.shape[0] * pos.shape[1] / 10.0)
    np.testing.assert_allclose(pos.mean(), MU, atol=5 * se + 0.05)
    np.testing.assert_allclose(pos.std(), 1.0, atol=0.1)
    # every chain moved and no chain is stuck
    assert (np.abs(np.diff(pos[:, :, 0], axis=1)).sum(axis=1) > 0).all()


def test_mesh_mclmc_posterior():
    # MCLMC's phase runners are sync scans; they must compose with the mesh
    # like the NUTS engines do.
    trace = nt.sample(gaussian.normal_logp(4, MU),
                      nt.DiagMclmcSettings(num_tune=300, num_draws=400,
                                           num_chains=16, seed=0),
                      mesh=make_mesh())
    pos = np.asarray(trace.posterior["position"])
    assert abs(pos.mean() - MU) < 0.25


def test_mesh_pooled_flow_trains_one_shared_flow():
    # Pooled flow refits under a mesh must all-gather the training windows
    # and share one key, so every device holds the SAME flow (adapt/flow.py
    # gathers over the chains axis; without it each device would train its
    # own "shared" flow on 1/N of the windows).  Statistical check: the
    # meshed run must match the unmeshed pooled run.
    from nuts_rs_tpu.flows import diag_affine_flow

    model = gaussian.normal_logp(4, MU)

    def run(mesh):
        settings = nt.FlowNutsSettings(
            num_tune=200, num_draws=300, num_chains=8, seed=3,
            flow_spec=diag_affine_flow())
        return nt.sample(model, settings, mesh=mesh, chunk_size=100)

    t_mesh = run(make_mesh())
    t_flat = run(None)
    a = np.asarray(t_mesh.posterior["position"])
    b = np.asarray(t_flat.posterior["position"])
    assert abs(a.mean() - MU) < 0.15
    assert abs(a.mean() - b.mean()) < 0.12
    assert abs(a.std() - b.std()) < 0.15
    # the shared transform advances identically on every chain
    ti = np.asarray(t_mesh.sample_stats["transformation_index"])
    assert (ti == ti[:1]).all(), "chains disagree on the transformation id"

"""Posterior-engine selection and the data-heavy model's numerics.

* ``posterior_kernel`` accepts only the engines that exist and names them
  when it refuses one;
* an engine that fails raises — nothing falls back to another engine;
* ``Model.logp_and_grad`` traces its matmuls at ``Precision.HIGHEST`` (on
  GPUs the default f32 matmul is TF32);
* ``logistic_regression`` at the benchmark's full width agrees with a plain
  numpy f64 log density and gradient;
* one test runs the default engine on the card (marked ``gpu``).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nuts_rs_tpu as nt
from nuts_rs_tpu.models import gaussian

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("make,kernel,accepted", [
    (nt.DiagNutsSettings, "pallas", "'sync', 'async'"),
    (nt.DiagMclmcSettings, "pallas", "'sync'"),
    (nt.DiagMclmcSettings, "async", "'sync'"),
])
def test_posterior_kernel_rejects_unknown_engine(make, kernel, accepted):
    settings = make(num_tune=10, num_draws=10, num_chains=2,
                    posterior_kernel=kernel)
    with pytest.raises(ValueError, match=f"accepted values: {accepted}"):
        nt.Sampler(gaussian.normal_logp(3), settings)


@pytest.mark.parametrize("store", ["store_gradient", "store_divergences"])
def test_async_engine_with_extra_store_raises(store):
    """The draw-async kernel emits no per-leapfrog extras: asking for both
    raises and names the store, instead of running the sync kernel."""
    settings = nt.DiagNutsSettings(num_tune=10, num_draws=10, num_chains=2,
                                   posterior_kernel="async", **{store: True})
    with pytest.raises(ValueError, match=store):
        nt.Sampler(gaussian.normal_logp(3), settings)


def test_failing_async_engine_raises(monkeypatch):
    """A posterior engine that fails propagates its error: the sampler
    neither warns nor reruns the chunk on the sync kernel."""
    import warnings

    import nuts_rs_tpu.chain as chain

    def broken_runner(*args, **kwargs):
        def runner(state, flags):
            raise RuntimeError("engine failed (injected)")
        return runner

    monkeypatch.setattr(chain, "make_async_posterior_runner", broken_runner)
    settings = nt.DiagNutsSettings(num_tune=10, num_draws=10, num_chains=2,
                                   posterior_kernel="async")
    sampler = nt.Sampler(gaussian.normal_logp(3), settings, chunk_size=10)
    sampler.run_next_chunk()  # warmup: the sync scan
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="injected"):
            sampler.run_next_chunk()


def test_logp_and_grad_matmuls_at_highest_precision():
    model = gaussian.logistic_regression(n_data=64, dim=5, seed=0)
    jaxpr = jax.make_jaxpr(model.logp_and_grad)(jnp.zeros(5, jnp.float32))
    dots = [e for e in jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2  # the forward matvec and its transpose
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,
                                         jax.lax.Precision.HIGHEST)


def test_logistic_regression_matches_numpy_f64_full_width():
    """The benchmark's logreg_big width (n=131072, d=100) in f64 against a
    plain numpy evaluation of the same density."""
    n, d = 131072, 100
    model = gaussian.logistic_regression(n_data=n, dim=d, seed=0)
    x, y = gaussian.logistic_regression_data(n, d, 0)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    rng = np.random.default_rng(0)
    for q in rng.normal(0.0, 0.2, size=(3, d)):
        lp, g = jax.jit(model.logp_and_grad)(jnp.asarray(q, jnp.float64))
        logits = x64 @ q
        lp_ref = (np.sum(y64 * logits - np.logaddexp(0.0, logits))
                  - 0.5 * q @ q)
        g_ref = x64.T @ (y64 - 1.0 / (1.0 + np.exp(-logits))) - q
        np.testing.assert_allclose(float(lp), lp_ref, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(g), g_ref, rtol=1e-10,
                                   atol=1e-9)


@pytest.mark.gpu
def test_default_engine_runs_on_gpu(gpu_env):
    """The sync engine samples a small N(3, 1) on the card (child process,
    so this CPU-pinned test process never opens the card)."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import jax
        import numpy as np
        import nuts_rs_tpu as nt
        from nuts_rs_tpu.models import gaussian
        assert jax.devices()[0].platform == "gpu", jax.devices()
        tr = nt.sample(gaussian.normal_logp(4, mu=3.0), nt.DiagNutsSettings(
            num_tune=200, num_draws=300, num_chains=64, seed=0))
        x = np.asarray(tr.posterior["position"])
        assert abs(x.mean() - 3.0) < 0.05, x.mean()
        assert not np.asarray(tr.sample_stats["diverging"]).any()
        print("gpu-ok")
    """) % (str(REPO),)
    out = subprocess.run([sys.executable, "-c", code], env=gpu_env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("gpu-ok")

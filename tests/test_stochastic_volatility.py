"""Stochastic volatility model (models/stochastic_volatility.py): the
realistic non-centered hierarchical benchmark family.  Ground truth is the
generating parameters of the synthetic returns."""

import numpy as np

import nuts_rs_tpu as nt
from nuts_rs_tpu.models.stochastic_volatility import (
    generate_returns,
    stochastic_volatility,
)


def test_recovers_generating_parameters():
    model = stochastic_volatility(T=200, seed=3)
    settings = nt.DiagNutsSettings(num_tune=400, num_draws=400, num_chains=4,
                                   seed=0)
    trace = nt.sample(model, settings, chunk_size=200)

    sigma = np.asarray(trace.posterior["sigma"])
    nu = np.asarray(trace.posterior["nu"])
    vol = np.asarray(trace.posterior["volatility"])
    # generating values: sigma=0.1, nu=8; nu is weakly identified at T=200,
    # so only sanity-bound it.
    assert 0.03 < sigma.mean() < 0.3, sigma.mean()
    assert 2.0 < np.median(nu) < 60.0, np.median(nu)
    assert vol.shape == (4, 400, 200)
    assert np.isfinite(vol).all() and (vol > 0).all()
    # posterior volatility path tracks the true path (correlation, not
    # pointwise: the path is latent under t-noise)
    true_vol = np.exp(0.1 * np.cumsum(
        np.random.default_rng(3).normal(size=200)) / 2.0)
    est = vol.mean(axis=(0, 1))
    corr = np.corrcoef(np.log(est), np.log(true_vol))[0, 1]
    assert corr > 0.5, corr
    # convergence on the global scale parameter
    from nuts_rs_tpu.diagnostics import split_rhat

    rh = split_rhat(np.log(sigma)[..., None])
    assert np.nanmax(rh) < 1.1, rh
    div = np.asarray(trace.sample_stats["diverging"])
    assert div.mean() < 0.05, div.mean()


def test_zarr_roundtrip_with_time_coord(tmp_path):
    # dims/coords flow through to the Zarr trace (volatility gets a real
    # time dimension, xarray-style).
    from nuts_rs_tpu.storage.zarr import ZarrConfig
    from nuts_rs_tpu.storage.zarr_format import read_array

    model = stochastic_volatility(T=50, seed=1)
    settings = nt.DiagNutsSettings(num_tune=100, num_draws=80, num_chains=2,
                                   seed=0)
    import os

    path = str(tmp_path / "sv.zarr")
    nt.sample(model, settings, storage=ZarrConfig(path=path), chunk_size=90)
    vol = read_array(os.path.join(path, "posterior", "volatility"))
    assert vol.shape == (2, 80, 50)
    time = read_array(os.path.join(path, "posterior", "time"))
    np.testing.assert_array_equal(time, np.arange(50))

"""Stochastic volatility: a realistic non-centered hierarchical model.

The flagship benchmark model of the nutpie/PyMC stack (the reference engine
itself ships only analytic test densities), here as a native
``nuts_rs_tpu.Model``: Student-t returns over a latent random-walk
log-volatility, T + 2 unconstrained parameters, deterministic volatility
path stored with an xarray ``time`` dimension.

Run (CPU or GPU):

    python examples/stochastic_volatility.py
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import numpy as np

import nuts_rs_tpu as nt
from nuts_rs_tpu.models.stochastic_volatility import stochastic_volatility


def main():
    model = stochastic_volatility(T=500, seed=0)   # synthetic returns
    settings = nt.DiagNutsSettings(num_tune=400, num_draws=400,
                                   num_chains=4, seed=1)
    trace = nt.sample(model, settings, chunk_size=200)

    sigma = np.asarray(trace.posterior["sigma"])
    nu = np.asarray(trace.posterior["nu"])
    vol = np.asarray(trace.posterior["volatility"])
    print("sigma (true 0.1):", round(float(sigma.mean()), 4))
    print("nu median (true 8):", round(float(np.median(nu)), 1))
    print("volatility path:", vol.shape, "mean", round(float(vol.mean()), 3))
    print("divergences:",
          f"{float(np.asarray(trace.sample_stats['diverging']).mean()):.2%}")
    for var in ("sigma", "nu"):
        s = nt.summary(trace, var=var)
        print(f"{var}: rhat {float(np.max(s['rhat'])):.4f} "
              f"ess_bulk {float(np.min(s['ess_bulk'])):.0f}")


if __name__ == "__main__":
    main()

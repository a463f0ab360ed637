"""Hierarchical (radon-style) model family: oracle recovery.

The partial-pooling regression the nutpie/PyMC stack benchmarks; synthetic
ground truth mu_a=1.5, sigma_a=0.3, beta=-0.7, sigma=0.8
(models/hierarchical.py::generate_radon).
"""

import numpy as np

import nuts_rs_tpu as nt
from nuts_rs_tpu.models.hierarchical import radon


def test_radon_parameter_recovery():
    model = radon(J=24, n_per=12, seed=0)
    trace = nt.sample(model, nt.DiagNutsSettings(
        num_tune=400, num_draws=600, num_chains=4, seed=0))
    post = trace.posterior
    assert abs(np.asarray(post["mu_a"]).mean() - 1.5) < 0.25
    assert abs(np.asarray(post["beta"]).mean() + 0.7) < 0.2
    assert abs(np.asarray(post["sigma"]).mean() - 0.8) < 0.15
    # group effects carry dims/coords into storage
    assert np.asarray(post["a"]).shape[-1] == 24
    assert not np.asarray(trace.sample_stats["diverging"]).any()

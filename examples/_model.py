"""Shared example model: a small correlated multivariate normal.

Mirror of the model used by every reference example
(nuts-rs ``examples/*.rs``: an MV-normal logp + parallel sampler +
progress polling + backend-specific readback).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import numpy as np
import jax.numpy as jnp

import nuts_rs_tpu as nt


def make_model(dim: int = 5) -> nt.Model:
    rng = np.random.default_rng(0)
    a = rng.normal(size=(dim, dim))
    cov = a @ a.T + dim * np.eye(dim)
    prec = np.linalg.inv(cov)

    def logp(q):
        return -0.5 * q @ jnp.asarray(prec, q.dtype) @ q

    return nt.Model(logp_fn=logp, dim=dim, name=f"mvnormal_{dim}d")


def make_settings(**kw) -> "nt.DiagNutsSettings":
    defaults = dict(num_tune=200, num_draws=300, num_chains=4, seed=0)
    defaults.update(kw)
    return nt.DiagNutsSettings(**defaults)


def print_progress(progress):
    """Rate-limited progress callback (reference: ProgressCallback,
    src/sampler.rs:1262-1265)."""
    done = sum(p.finished_draws for p in progress)
    total = sum(p.total_draws for p in progress)
    divs = sum(p.divergences for p in progress)
    print(f"  progress: {done}/{total} draws, {divs} divergences")

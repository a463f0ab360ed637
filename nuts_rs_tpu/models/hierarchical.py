"""Hierarchical partial-pooling regression (the "radon" model family).

The classic multilevel model the nutpie/PyMC stack benchmarks alongside
stochastic volatility (Gelman & Hill's radon dataset): per-group intercepts
partially pooled through a learned group-level distribution.  The reference
engine ships only analytic densities (``src/math/cpu_math.rs:885``); this
family is part of the model zoo a user switching from that stack expects.

Generative model over observations ``y_i`` in groups ``g_i`` with a
covariate ``x_i``:

    mu_a    ~ N(0, 10)                     group-level mean
    sigma_a ~ HalfNormal(1)                group-level spread
    beta    ~ N(0, 10)                     covariate slope
    sigma   ~ HalfNormal(1)                observation noise
    a_j     = mu_a + sigma_a * z_j,  z_j ~ N(0, 1)   (non-centered)
    y_i     ~ N(a_{g_i} + beta * x_i, sigma)

Unconstrained vector ``q = [mu_a, beta, log_sigma, log_sigma_a, z_1..J]``
(dim = J + 4); the HalfNormal priors contribute the usual ``+ log s``
log-Jacobians.

The group effect is evaluated with a gather (``a[groups]``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .model import Model

# Python float (weak type): a np.float64 scalar would promote the whole
# f32 in-kernel logp to f64 under jax_enable_x64.
_HALF_LOG_2PI = float(0.5 * np.log(2.0 * np.pi))


def generate_radon(J: int = 85, n_per: int = 12, seed: int = 0):
    """Synthetic radon-style data with known ground truth
    (mu_a=1.5, sigma_a=0.3, beta=-0.7, sigma=0.8)."""
    rng = np.random.default_rng(seed)
    groups = np.repeat(np.arange(J), n_per)
    x = rng.binomial(1, 0.5, size=groups.shape[0]).astype(np.float64)
    a = 1.5 + 0.3 * rng.normal(size=J)
    y = a[groups] - 0.7 * x + 0.8 * rng.normal(size=groups.shape[0])
    return y, x, groups


def radon(y: np.ndarray | None = None, x: np.ndarray | None = None,
          groups: np.ndarray | None = None, J: int = 85, n_per: int = 12,
          seed: int = 0) -> Model:
    """Build the hierarchical model; with ``y=None`` uses synthetic data
    from :func:`generate_radon`."""
    if y is None:
        if x is not None or groups is not None:
            raise ValueError("radon: pass all of (y, x, groups) or none")
        y, x, groups = generate_radon(J=J, n_per=n_per, seed=seed)
    elif x is None or groups is None:
        raise ValueError("radon: pass all of (y, x, groups) or none")
    y = np.asarray(y, np.float64)
    x = np.asarray(x, np.float64)
    groups = np.asarray(groups, np.int64)
    J = int(groups.max()) + 1
    N = y.shape[0]
    dim = J + 4

    def _logp_parts(q, a_obs, yv):
        mu_a, beta, log_sigma, log_sigma_a = q[0], q[1], q[2], q[3]
        z = q[4:]
        sigma = jnp.exp(log_sigma)
        sigma_a = jnp.exp(log_sigma_a)
        lp = -0.5 * (mu_a / 10.0) ** 2 - 0.5 * (beta / 10.0) ** 2
        # HalfNormal(1) on sigma, sigma_a + log-Jacobians of exp
        lp += -0.5 * sigma ** 2 + log_sigma
        lp += -0.5 * sigma_a ** 2 + log_sigma_a
        lp += -0.5 * jnp.sum(z * z)
        resid = a_obs - yv
        n = resid.shape[0]
        lp += (-0.5 * jnp.sum((resid / sigma) ** 2)
               - n * (log_sigma + _HALF_LOG_2PI))
        return lp

    def logp(q):
        mu_a, log_sigma_a = q[0], q[3]
        z = q[4:]
        a = mu_a + jnp.exp(log_sigma_a) * z
        a_obs = a[jnp.asarray(groups)] + q[1] * jnp.asarray(x, q.dtype)
        return _logp_parts(q, a_obs, jnp.asarray(y, q.dtype))

    def expand(key, q):
        mu_a, log_sigma_a = q[0], q[3]
        return {
            "mu_a": mu_a,
            "beta": q[1],
            "sigma": jnp.exp(q[2]),
            "sigma_a": jnp.exp(log_sigma_a),
            "a": mu_a + jnp.exp(log_sigma_a) * q[4:],
        }

    return Model(
        logp_fn=logp,
        dim=dim,
        expand_fn=expand,
        dims={"a": ("group",)},
        coords={"group": np.arange(J)},
        name=f"radon_J{J}",
    )

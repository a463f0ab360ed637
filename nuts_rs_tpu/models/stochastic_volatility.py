"""Stochastic volatility: the ecosystem's flagship realistic benchmark.

The non-centered Student-t stochastic-volatility model that nutpie (the
reference's Python frontend) uses as its headline PyMC benchmark; the
reference engine itself ships only analytic test densities
(``src/math/cpu_math.rs:885``), so this model family is an extension that a
user switching from the nutpie stack expects to find.

Generative model over ``T`` daily returns ``r_t``:

    sigma ~ Exponential(lam_sigma)            volatility-of-volatility
    nu    ~ Exponential(lam_nu)               Student-t tail weight
    h_t   = sigma * cumsum(eps), eps_t ~ N(0, 1)   latent log-volatility
                                                  (non-centered random walk)
    r_t   ~ StudentT(nu, 0, exp(h_t / 2))

Unconstrained vector ``q = [log_sigma, log_nu, eps_1..T]`` (dim = T + 2);
the Exponential priors pick up the usual ``+ log x`` log-Jacobian terms.
Deterministics (``expand_fn``): the volatility path ``exp(h/2)`` with an
xarray ``time`` dimension, plus scalar ``sigma`` and ``nu``.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax.scipy.special import gammaln

from .model import Model


def generate_returns(T: int = 1000, sigma: float = 0.1, nu: float = 8.0,
                     seed: int = 0) -> np.ndarray:
    """Synthetic daily returns drawn from the generative model."""
    rng = np.random.default_rng(seed)
    h = sigma * np.cumsum(rng.normal(size=T))
    scale = np.exp(h / 2.0)
    return (rng.standard_t(nu, size=T) * scale).astype(np.float64)


def _student_t_logpdf(x, nu, scale):
    z = x / scale
    return (gammaln((nu + 1.0) / 2.0) - gammaln(nu / 2.0)
            - 0.5 * jnp.log(nu * jnp.pi) - jnp.log(scale)
            - (nu + 1.0) / 2.0 * jnp.log1p(z * z / nu))


def stochastic_volatility(returns: np.ndarray | None = None, T: int = 1000,
                          lam_sigma: float = 10.0, lam_nu: float = 0.1,
                          seed: int = 0) -> Model:
    """Build the model; with ``returns=None`` uses synthetic data of length
    ``T`` from :func:`generate_returns` (known ground truth)."""
    if returns is None:
        returns = generate_returns(T, seed=seed)
    r = np.asarray(returns, np.float64)
    T = r.shape[0]
    dim = T + 2

    def logp(q):
        rr = jnp.asarray(r, q.dtype)
        log_sigma, log_nu, eps = q[0], q[1], q[2:]
        sigma = jnp.exp(log_sigma)
        nu = jnp.exp(log_nu)
        # Exponential priors on the constrained scale + log-Jacobians.
        lp = -lam_sigma * sigma + log_sigma
        lp += -lam_nu * nu + log_nu
        # Non-centered random-walk innovations.
        lp += -0.5 * jnp.sum(eps * eps)
        # Student-t observation model.
        h = sigma * jnp.cumsum(eps)
        lp += jnp.sum(_student_t_logpdf(rr, nu, jnp.exp(h / 2.0)))
        return lp

    def expand(key, q):
        log_sigma, log_nu, eps = q[0], q[1], q[2:]
        sigma = jnp.exp(log_sigma)
        h = sigma * jnp.cumsum(eps)
        return {
            "sigma": sigma,
            "nu": jnp.exp(log_nu),
            "volatility": jnp.exp(h / 2.0),
        }

    return Model(
        logp_fn=logp,
        dim=dim,
        expand_fn=expand,
        dims={"volatility": ("time",)},
        coords={"time": np.arange(T)},
        name=f"stochastic_volatility_{T}",
    )

"""Analytic test models.

Mirrors the reference's fixtures: ``NormalLogp`` (nuts-rs
``src/math/test_logps.rs:9-102``), the rank-1 correlated Gaussian
``CorrelatedNormalLogp`` (``tests/sample_normal.rs:29-108``), plus the standard
hierarchical benchmarks (Neal's funnel, eight schools) and a logistic
regression used by the BASELINE configs.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..parallel.axis import dsum
from .model import Model


def normal_logp(dim: int, mu: float = 3.0) -> Model:
    """iid Normal(mu, 1) in every coordinate; nuts-rs src/math/test_logps.rs:9."""

    def logp(q):
        # dsum: global over the (possibly dim-sharded) parameter axis.
        return -0.5 * dsum(jnp.square(q - mu))

    return Model(logp_fn=logp, dim=dim, name=f"normal_{dim}d",
                 dim_shardable=True)


def mv_normal(cov: np.ndarray) -> Model:
    """Multivariate normal with dense covariance (nuts-rs src/transform/mod.rs:39)."""
    cov = np.asarray(cov, dtype=np.float64)
    prec = np.linalg.inv(cov)
    dim = cov.shape[0]

    def logp(q):
        p = jnp.asarray(prec, q.dtype)
        return -0.5 * q @ p @ q

    return Model(logp_fn=logp, dim=dim, name=f"mvnormal_{dim}d")


def correlated_normal_rank1(dim: int, scale: float = 1.5, eig: float = 1000.0) -> Model:
    """Rank-1 correlated Gaussian via Woodbury precision.

    Mirrors ``CorrelatedNormalLogp`` (nuts-rs ``tests/sample_normal.rs:29-108``):
    covariance ``diag(s)^1/2 (I + (eig-1) u u^T) diag(s)^1/2`` with a single
    inflated eigendirection, used by the low-rank exact-whitening test.
    """
    rng = np.random.default_rng(42)
    u = rng.normal(size=dim)
    u /= np.linalg.norm(u)
    stds = np.full(dim, scale)

    # Precision = D^-1/2 (I + (1/eig - 1) u u^T) D^-1/2 by Woodbury.
    coef = 1.0 / eig - 1.0

    def logp(q):
        uu = jnp.asarray(u, q.dtype)
        s = jnp.asarray(stds, q.dtype)
        y = q / jnp.sqrt(s)
        proj = uu @ y
        return -0.5 * (y @ y + coef * proj * proj)

    return Model(logp_fn=logp, dim=dim, name=f"corr_normal_{dim}d")


def correlated_normal(dim: int, rank1_scale: float = 0.5) -> Model:
    """Correlated normal with covariance I + rank1_scale * ones ones^T.

    Mirror of ``CorrelatedNormalLogp`` (nuts-rs tests/sample_normal.rs:21-107):
    by Woodbury the precision is I - c * ones ones^T with
    c = rank1_scale / (1 + rank1_scale * dim).
    """
    c = rank1_scale / (1.0 + rank1_scale * dim)

    def logp(q):
        # -0.5 q^T(I - c 11^T)q written as two INDEPENDENT dsum reductions
        # whose results combine on the replicated side.  The nested form
        # dsum(q * (q - c*dsum(q))) is wrong under dim sharding: the
        # local-gradient psum trick (parallel/axis._psum_local_grad) cuts
        # the cross-shard chain-rule path through the inner dsum, dropping
        # the -c*s term from remote shards' gradients.  Squaring the
        # replicated psum output keeps d(s^2)/dq_i = 2s exact on every
        # shard.
        s = dsum(q)
        return -0.5 * dsum(q * q) + 0.5 * c * s * s

    return Model(logp_fn=logp, dim=dim, name=f"corr_normal_{dim}d",
                 dim_shardable=True)


def funnel(dim: int = 10) -> Model:
    """Neal's funnel: v ~ N(0, 3), x_i | v ~ N(0, exp(v/2))."""

    def logp(q):
        v, x = q[0], q[1:]
        lp_v = -0.5 * (v / 3.0) ** 2
        lp_x = -0.5 * jnp.sum(jnp.square(x) * jnp.exp(-v)) - 0.5 * (dim - 1) * v
        return lp_v + lp_x

    return Model(logp_fn=logp, dim=dim, name=f"funnel_{dim}d")


def eight_schools() -> Model:
    """Non-centered eight schools; q = [mu, log_tau, theta_tilde x 8]."""
    # Host (numpy) constants: model data captured in jit closures must live
    # on the host so re-tracing after a device restart (Sampler auto_recover)
    # re-uploads it instead of reading a dead device buffer.
    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

    def logp(q):
        mu, log_tau, tt = q[0], q[1], q[2:]
        tau = jnp.exp(log_tau)
        theta = mu + tau * tt
        lp = -0.5 * (mu / 5.0) ** 2
        lp += -0.5 * (log_tau / 5.0) ** 2
        lp += -0.5 * jnp.sum(tt * tt)
        lp += jnp.sum(-0.5 * jnp.square((jnp.asarray(y, q.dtype) - theta) / jnp.asarray(sigma, q.dtype)))
        return lp

    def expand(key, q):
        mu, log_tau, tt = q[0], q[1], q[2:]
        theta = mu + jnp.exp(log_tau) * tt
        return {"mu": mu, "tau": jnp.exp(log_tau), "theta": theta}

    return Model(
        logp_fn=logp,
        dim=10,
        expand_fn=expand,
        dims={"theta": ["school"]},
        coords={"school": np.arange(8)},
        name="eight_schools",
    )


def logistic_regression_data(n_data: int = 1000, dim: int = 100,
                             seed: int = 0):
    """Synthetic design matrix ``x`` [n_data, dim] and 0/1 labels ``y``
    (f32 numpy) behind :func:`logistic_regression`."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_data, dim)).astype(np.float32)
    w_true = rng.normal(size=dim).astype(np.float32) / np.sqrt(dim)
    p = 1.0 / (1.0 + np.exp(-(x @ w_true)))
    y = (rng.uniform(size=n_data) < p).astype(np.float32)
    return x, y


def logistic_regression(n_data: int = 1000, dim: int = 100, seed: int = 0) -> Model:
    """Bayesian logistic regression with standard-normal prior on weights."""
    x, y = logistic_regression_data(n_data, dim, seed)

    def logp(q):
        xx = jnp.asarray(x, q.dtype)
        yy = jnp.asarray(y, q.dtype)
        logits = xx @ q
        # log-likelihood of Bernoulli(sigmoid(logits)); under vmap over
        # chains the matvecs become [n, d]·[d, C] matmuls.
        ll = jnp.sum(yy * logits - jnp.logaddexp(0.0, logits))
        return ll - 0.5 * jnp.sum(q * q)

    return Model(logp_fn=logp, dim=dim, name=f"logreg_{dim}d")

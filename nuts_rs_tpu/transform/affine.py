"""Affine (diagonal + optional low-rank) coordinate transformations.

JAX equivalent of the reference's ``Transformation`` trait and its two
affine implementations (nuts-rs ``src/transform/transformation.rs:12-71``,
``src/transform/diagonal.rs``, ``src/transform/low_rank.rs``).

The sampler runs Hamiltonian dynamics in the *transformed* (whitened) space z;
the transform maps between z and the user's parameter space q:

  diagonal:   q = sigma * z + mean,              z = (q - mean) / sigma
  low-rank:   q = sigma * (L(z; U, sqrt(lam)) + mu_lr) + mean
              z = L((q - mean)/sigma - mu_lr; U, 1/sqrt(lam))
  where       L(r; U, w) = r + U ((w - 1) * (U^T r))

``grad`` maps covariantly: zg = J_F^T g, i.e. zg = L(sigma * g; U, sqrt(lam)).

The low-rank factors are stored padded to a static rank ``r``; padded columns
carry eigenvalue 1 so they are exact no-ops (lam - 1 = 0), which makes masking
free.  A transform with ``vecs is None`` is purely diagonal.

log|det J_{F^-1}| = sum(log(1/sigma)) - 1/2 sum(log lam)
(nuts-rs ``src/transform/low_rank.rs:95-110``).

All functions are single-chain; batching is via ``jax.vmap``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..parallel.axis import dfinish, dsum


class AffineTransform(NamedTuple):
    mean: jax.Array        # [d]
    stds: jax.Array        # [d]  sigma
    inv_stds: jax.Array    # [d]  1/sigma
    logdet: jax.Array      # []   log|det J_{F^-1}|
    id: jax.Array          # []   i32 version counter (bumped on every update)
    # Low-rank extension; None for pure diagonal transforms.
    vecs: Optional[jax.Array] = None          # [d, r] orthonormal columns U
    vals_sqrt: Optional[jax.Array] = None     # [r]    lam^{1/2}
    vals_sqrt_inv: Optional[jax.Array] = None  # [r]   lam^{-1/2}
    mu_lr: Optional[jax.Array] = None         # [d]    inner translation


def identity_transform(dim: int, dtype, rank: int | None = None) -> AffineTransform:
    t = AffineTransform(
        mean=jnp.zeros(dim, dtype),
        stds=jnp.ones(dim, dtype),
        inv_stds=jnp.ones(dim, dtype),
        logdet=jnp.zeros((), dtype),
        id=jnp.asarray(-1, jnp.int32),
    )
    if rank is not None:
        t = t._replace(
            vecs=jnp.zeros((dim, rank), dtype),
            vals_sqrt=jnp.ones(rank, dtype),
            vals_sqrt_inv=jnp.ones(rank, dtype),
            mu_lr=jnp.zeros(dim, dtype),
        )
    return t


def _lowrank_apply(vecs, vals, rhs):
    """(I + U (diag(vals) - I) U^T) rhs — two skinny matmuls (MXU-friendly).

    Mirrors ``Math::apply_lowrank_transform`` (nuts-rs src/math/math.rs:131).
    """
    # Full-f32 MXU passes: bf16 default passes here produce noisy energies
    # and spurious divergences (these matvecs run twice per leapfrog).
    with jax.default_matmul_precision("highest"):
        # Under dim sharding U is row-sharded: the projection U^T rhs
        # contracts over dim (psum); the back-projection is row-local.
        proj = dfinish(vecs.T @ rhs)
        return rhs + vecs @ ((vals - 1.0) * proj)


def to_transformed(t: AffineTransform, q: jax.Array) -> jax.Array:
    """q -> z (nuts-rs ``compute_transformed_position``, low_rank.rs:326-348)."""
    z = (q - t.mean) * t.inv_stds
    if t.vecs is not None:
        z = z - t.mu_lr
        z = _lowrank_apply(t.vecs, t.vals_sqrt_inv, z)
    return z


def to_untransformed(t: AffineTransform, z: jax.Array) -> jax.Array:
    """z -> q (nuts-rs ``compute_untransformed_position``, low_rank.rs:350-377)."""
    if t.vecs is not None:
        q = _lowrank_apply(t.vecs, t.vals_sqrt, z)
        q = (q + t.mu_lr) * t.stds
    else:
        q = z * t.stds
    return q + t.mean


def grad_to_transformed(t: AffineTransform, g: jax.Array) -> jax.Array:
    """g -> zg = J_F^T g (nuts-rs ``compute_transformed_gradient``, low_rank.rs:379-398)."""
    zg = g * t.stds
    if t.vecs is not None:
        zg = _lowrank_apply(t.vecs, t.vals_sqrt, zg)
    return zg


def diag_logdet(inv_stds: jax.Array) -> jax.Array:
    return dsum(jnp.log(inv_stds))


def set_diag(t: AffineTransform, stds: jax.Array, mean: jax.Array,
             changed=True) -> AffineTransform:
    """Replace the diagonal part (nuts-rs ``DiagMassMatrix::set_transform``).

    ``changed`` may be a traced boolean mask; when False the old values are
    kept (used for per-chain "not enough samples yet" gating).
    """
    stds = jnp.where(changed, stds, t.stds)
    mean = jnp.where(changed, mean, t.mean)
    inv_stds = 1.0 / stds
    logdet = diag_logdet(inv_stds)
    if t.vecs is not None:
        logdet = logdet - 0.5 * jnp.sum(jnp.log(jnp.square(t.vals_sqrt)))
    return t._replace(
        mean=mean,
        stds=stds,
        inv_stds=inv_stds,
        logdet=logdet,
        id=t.id + jnp.asarray(changed, jnp.int32),
    )


def set_low_rank(t: AffineTransform, stds, mean, vals, vecs, mu_lr,
                 changed=True) -> AffineTransform:
    """Replace the full transform (nuts-rs ``LowRankMassMatrix::update``,
    low_rank.rs:164-190).  ``vals`` are the filtered eigenvalues padded with
    1.0 (no-op directions); ``changed`` may be a traced per-chain bool.

    log|det J_{F^-1}| = sum(log 1/sigma) - 1/2 sum(log lam)
    """
    stds = jnp.where(changed, stds, t.stds)
    mean = jnp.where(changed, mean, t.mean)
    vals = jnp.where(changed, vals, jnp.square(t.vals_sqrt))
    vecs = jnp.where(changed, vecs, t.vecs)
    mu_lr = jnp.where(changed, mu_lr, t.mu_lr)
    inv_stds = 1.0 / stds
    logdet = diag_logdet(inv_stds) - 0.5 * jnp.sum(jnp.log(vals))
    return t._replace(
        mean=mean,
        stds=stds,
        inv_stds=inv_stds,
        logdet=logdet,
        vecs=vecs,
        vals_sqrt=jnp.sqrt(vals),
        vals_sqrt_inv=1.0 / jnp.sqrt(vals),
        mu_lr=mu_lr,
        id=t.id + jnp.asarray(changed, jnp.int32),
    )


def init_diag_from_grad(t: AffineTransform, q: jax.Array, g: jax.Array,
                        fill_invalid: float = 1.0,
                        clamp=(1e-20, 1e20)) -> AffineTransform:
    """sigma^2 = 1/|g| initial guess (nuts-rs ``update_diag_grad``, diagonal.rs:133-154)."""
    var = 1.0 / jnp.clip(jnp.abs(g), clamp[0], clamp[1])
    var = jnp.where(jnp.isfinite(var), var, fill_invalid)
    stds = jnp.sqrt(var)
    mean = q + var * g
    return set_diag(t, stds, mean)

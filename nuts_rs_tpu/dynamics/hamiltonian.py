"""Leapfrog integrators, turning criterion, and trajectory initialization.

Batched redesign of ``TransformedHamiltonian``
(nuts-rs ``src/dynamics/transformed_hamiltonian.rs:409-827``).  Three kinetic
energy kinds (``src/dynamics/transformed_hamiltonian.rs:27-50``):

* ``EUCLIDEAN``      velocity Verlet:  half-kick, drift, half-kick
* ``EXACT_NORMAL``   geodesic integrator exact for a standard-normal potential
* ``MICROCANONICAL`` isokinetic ESH dynamics (momentum on the unit sphere)

Everything is a pure function over :class:`Point` pytrees; one leapfrog is one
fused XLA computation containing the user's logp gradient.  Recoverable logp
errors surface as NaN energies and are caught by the divergence check.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..parallel.axis import dsum, fold_dim_shard, global_dim
from ..transform.affine import AffineTransform
from ..transform.ops import AFFINE_OPS
from .point import Point


class KineticKind(enum.Enum):
    EUCLIDEAN = "euclidean"
    EXACT_NORMAL = "exact_normal"
    MICROCANONICAL = "microcanonical"


LogpGradFn = Callable[[jax.Array], tuple[jax.Array, jax.Array]]


def _esh_momentum_update(zg, v, step):
    """One ESH momentum half-step; returns (v_new, delta_ke).

    Formula documented at nuts-rs ``src/math/math.rs:188-204`` and implemented
    at ``src/math/cpu_math.rs:505-551`` (Steeg & Gallagher 2021, arXiv:2111.02434):

        g_hat = g/|g|; alpha = v . g_hat; delta = step |g| / (n-1); zeta = e^-delta
        v_raw = g_hat (1-zeta)(1+zeta+alpha(1-zeta)) + 2 zeta v
        dKE   = (delta - ln2 + log1p(alpha + (1-alpha) zeta^2)) (n-1)
    """
    n = global_dim(zg.shape[-1])
    grad_norm = jnp.sqrt(dsum(zg * zg))
    g_hat = zg / grad_norm
    alpha = dsum(v * g_hat)
    dims_m1 = jnp.asarray(n - 1, zg.dtype)
    delta = step * grad_norm / dims_m1
    zeta = jnp.exp(-delta)
    coeff_g = (1.0 - zeta) * (1.0 + zeta + alpha * (1.0 - zeta))
    v_raw = coeff_g * g_hat + 2.0 * zeta * v
    v_new = v_raw / jnp.sqrt(dsum(v_raw * v_raw))
    dke = (delta - jnp.log(2.0) + jnp.log1p(alpha + (1.0 - alpha) * zeta * zeta)) * dims_m1
    return v_new, dke


class LeapfrogResult(NamedTuple):
    point: Point
    diverging: jax.Array     # [] bool
    energy_error: jax.Array  # [] E_new - energy_baseline


def leapfrog(
    pt: Point,
    direction: jax.Array,
    step_size: jax.Array,
    transform,
    logp_grad_fn: LogpGradFn,
    kind: KineticKind,
    energy_baseline: jax.Array,
    max_energy_error: float | jax.Array,
    step_size_factor: jax.Array | float = 1.0,
    ops=AFFINE_OPS,
) -> LeapfrogResult:
    """One leapfrog step (nuts-rs ``transformed_hamiltonian.rs:524-615``).

    ``direction`` is +1/-1; ``step_size_factor`` supports MCLMC's dynamic
    halving.  Divergence criterion: Euclidean/ExactNormal use
    ``err > max_energy_error``; Microcanonical uses ``|err| >= max``; non-finite
    energies always diverge (``transformed_hamiltonian.rs:590-610``).
    """
    dtype = pt.z.dtype
    eps = jnp.asarray(direction, dtype) * step_size * step_size_factor
    n = global_dim(pt.z.shape[-1])
    sqrt_n = jnp.sqrt(jnp.asarray(n, dtype))

    ke = pt.ke
    # --- first velocity half-step ---
    if kind is KineticKind.EUCLIDEAN:
        v1 = pt.v + (eps / 2.0) * pt.zg
        z1 = pt.z + eps * v1
    elif kind is KineticKind.EXACT_NORMAL:
        # std_norm_grad_flow: v' = v + eps (q + g)   (util.rs:650)
        v1 = pt.v + (eps / 2.0) * (pt.z + pt.zg)
        # std_norm_flow: q' = q cos e + v sin e; v' = -q sin e + v cos e (util.rs:507-511)
        z1 = pt.z * jnp.cos(eps) + v1 * jnp.sin(eps)
        v1 = -pt.z * jnp.sin(eps) + v1 * jnp.cos(eps)
    elif kind is KineticKind.MICROCANONICAL:
        v1, dke1 = _esh_momentum_update(pt.zg, pt.v, sqrt_n * eps / 2.0)
        ke = ke + dke1
        z1 = pt.z + eps * sqrt_n * v1
    else:  # pragma: no cover
        raise ValueError(kind)

    # --- evaluate log density at the new position (the hot call) ---
    q1, logp1, g1, zg1, logdet1 = ops.eval_from_z(transform, z1, logp_grad_fn)

    # --- second velocity half-step ---
    if kind is KineticKind.EUCLIDEAN:
        v2 = v1 + (eps / 2.0) * zg1
        ke = 0.5 * dsum(v2 * v2)
    elif kind is KineticKind.EXACT_NORMAL:
        v2 = v1 + (eps / 2.0) * (z1 + zg1)
        ke = 0.5 * dsum(v2 * v2)
    else:
        v2, dke2 = _esh_momentum_update(zg1, v1, sqrt_n * eps / 2.0)
        ke = ke + dke2

    new_pt = Point(
        q=q1,
        g=g1,
        z=z1,
        zg=zg1,
        v=v2,
        logp=logp1,
        logdet=jnp.asarray(logdet1, dtype),
        ke=ke,
        idx=pt.idx + jnp.asarray(direction, jnp.int32),
    )

    energy_error = new_pt.energy - energy_baseline
    if kind is KineticKind.MICROCANONICAL:
        bad = jnp.abs(energy_error) >= max_energy_error
    else:
        bad = energy_error > max_energy_error
    diverging = bad | ~jnp.isfinite(energy_error)
    return LeapfrogResult(new_pt, diverging, energy_error)


def is_turning(z1, v1, i1, z2, v2, i2):
    """U-turn criterion between two trajectory states.

    Mirrors nuts-rs ``transformed_hamiltonian.rs:617-638``: order the states by
    index in trajectory, then with dz = z_end - z_start the trajectory is
    turning if dz . v_start < 0 or dz . v_end < 0 (computed as one fused pass,
    the reference's ``scalar_prods3``).
    """
    swap = i1 > i2
    z_lo = jnp.where(swap, z2, z1)
    v_lo = jnp.where(swap, v2, v1)
    z_hi = jnp.where(swap, z1, z2)
    v_hi = jnp.where(swap, v1, v2)
    dz = z_hi - z_lo
    turn1 = dsum(dz * v_lo)
    turn2 = dsum(dz * v_hi)
    return (turn1 < 0.0) | (turn2 < 0.0)


def sample_momentum(key, dim, dtype, kind: KineticKind):
    """Fresh Gaussian momentum; unit-sphere normalized for Microcanonical.

    (nuts-rs ``transformed_hamiltonian.rs:696-704``)
    """
    v = jax.random.normal(fold_dim_shard(key), (dim,), dtype)
    if kind is KineticKind.MICROCANONICAL:
        v = v / jnp.sqrt(dsum(v * v))
    return v


def init_point_from_q(q, transform, logp_grad_fn: LogpGradFn,
                      dtype=None, ops=AFFINE_OPS) -> Point:
    """Build a full point from an untransformed position.

    (nuts-rs ``init_from_untransformed_position``, transformed_hamiltonian.rs:264-280)
    """
    dtype = dtype or q.dtype
    logp, g = logp_grad_fn(q)
    z, zg, logdet = ops.eval_from_q(transform, q, g, logp_grad_fn)
    return Point(
        q=q, g=g, z=z, zg=zg,
        v=jnp.zeros_like(q),
        logp=logp,
        logdet=jnp.asarray(logdet, dtype),
        ke=jnp.zeros((), dtype),
        idx=jnp.zeros((), jnp.int32),
    )


def initialize_trajectory(key, pt: Point, transform,
                          kind: KineticKind, resample_velocity=True,
                          ops=AFFINE_OPS, logp_grad_fn=None,
                          resync=True) -> Point:
    """Refresh momentum and re-sync the transform cache before a draw.

    (nuts-rs ``initialize_trajectory``, transformed_hamiltonian.rs:687-736).
    The z/zg/logdet resync is done unconditionally by default — it is cheap
    and idempotent for affine transforms, so no transform-id staleness
    tracking is needed on device.  Callers that KNOW the transform is frozen
    and ``pt`` already carries a consistent (z, zg, logdet) — e.g. the
    draw-asynchronous posterior kernel restarting from the previous draw —
    pass ``resync=False`` to skip the re-evaluation (for flow transforms the
    resync costs an inverse plus a forward-vjp per call).
    """
    dtype = pt.q.dtype
    dim = pt.q.shape[-1]
    v = sample_momentum(key, dim, dtype, kind) if resample_velocity else pt.v
    if resync:
        z, zg, logdet = ops.eval_from_q(transform, pt.q, pt.g, logp_grad_fn)
    else:
        z, zg, logdet = pt.z, pt.zg, pt.logdet
    if kind is KineticKind.MICROCANONICAL:
        ke = jnp.zeros((), dtype)
    else:
        ke = 0.5 * dsum(v * v)
    return pt._replace(
        v=v, z=z, zg=zg,
        logdet=jnp.asarray(logdet, dtype),
        ke=ke,
        idx=jnp.zeros((), jnp.int32),
    )


def partial_momentum_refresh(pt: Point, noise, step_size, factor,
                             decoherence_length, kind: KineticKind) -> Point:
    """MCLMC Ornstein-Uhlenbeck partial momentum refresh.

    (nuts-rs ``transformed_hamiltonian.rs:777-826``)
    Microcanonical: nu = sqrt(expm1(2 h / L) / n); v <- normalize(v + nu z).
    Euclidean/ExactNormal: alpha = exp(-h/L); v <- alpha v + sqrt(1-alpha^2) z.
    """
    dtype = pt.v.dtype
    half_step = step_size * factor / 2.0
    if kind is KineticKind.MICROCANONICAL:
        n = jnp.asarray(global_dim(pt.v.shape[-1]), dtype)
        nu = jnp.sqrt(jnp.expm1(2.0 * half_step / decoherence_length) / n)
        v = pt.v + nu * noise
        v = v / jnp.sqrt(dsum(v * v))
        return pt._replace(v=v)
    alpha = jnp.exp(-half_step / decoherence_length)
    beta = jnp.sqrt(1.0 - alpha * alpha)
    v = alpha * pt.v + beta * noise
    return pt._replace(v=v, ke=0.5 * dsum(v * v))

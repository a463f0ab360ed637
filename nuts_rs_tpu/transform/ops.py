"""Static dispatch between affine and flow coordinate transforms.

The sampler kernels are generic over the transformation (nuts-rs
``Transformation`` trait, src/transform/transformation.rs:12-71).  The
transform *state* is a pytree (an :class:`AffineTransform` or a
:class:`FlowTransform` holding learned parameters); the *operations* are
static Python objects chosen at trace time:

* ``AFFINE_OPS`` — diagonal / low-rank affine maps with constant logdet.
* ``FlowOps(spec)`` — user (or built-in) normalizing flow: forward/inverse
  are arbitrary JAX functions, the transformed gradient is the Jacobian
  transpose obtained from ``jax.vjp`` of the forward map, and logdet is
  position dependent (nuts-rs ``ExternalTransformation``,
  src/transform/external.rs:10-104, where these hooks dispatch to user code).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from .affine import (
    AffineTransform,
    grad_to_transformed,
    to_transformed,
    to_untransformed,
)


class FlowTransform(NamedTuple):
    """Flow transform state: learned parameters + version counter."""

    params: Any
    id: jax.Array  # [] i32, bumped on every refit


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    """User flow contract (the JAX-native ``Math`` flow hooks,
    nuts-rs src/math/math.rs:262-313).

    ``forward(params, z) -> (q, logdet)`` maps the standard-normal space to
    the parameter space; ``logdet`` is **log|det dq/dz|**, the FORWARD
    Jacobian log-determinant (``inverse`` returns the same quantity at the
    given q).  That sign makes E = KE - (logp + logdet) target the correct
    pushforward pi_z(z) = pi(F(z)) |det dF/dz|; supplying the negated
    (inverse-Jacobian) value samples the wrong distribution with no error
    raised.  The built-in flows follow this convention
    (flows/coupling.py:17-19, unit-tested against autodiff Jacobians).

    ``init(key, dim, q0, g0) -> params``; ``update(key, params, draws,
    grads, logps, mask) -> params`` refits from collected warmup draws.
    ``inverse(params, q) -> (z, logdet)`` is required (used to enter the
    transformed space).
    """

    forward: Callable[[Any, jax.Array], tuple[jax.Array, jax.Array]]
    inverse: Callable[[Any, jax.Array], tuple[jax.Array, jax.Array]]
    init: Callable[..., Any]
    update: Callable[..., Any]


class AffineOps:
    """Operations for :class:`AffineTransform` states."""

    is_flow = False

    def eval_from_z(self, t: AffineTransform, z, logp_grad_fn):
        """z -> (q, logp, g, zg, logdet); the leapfrog hot call."""
        q = to_untransformed(t, z)
        logp, g = logp_grad_fn(q)
        zg = grad_to_transformed(t, g)
        return q, logp, g, zg, t.logdet

    def eval_from_q(self, t: AffineTransform, q, g, logp_grad_fn):
        """(q, g) -> (z, zg, logdet): re-sync caches after a transform update
        (nuts-rs ``inv_transform_normalize``)."""
        z = to_transformed(t, q)
        zg = grad_to_transformed(t, g)
        return z, zg, t.logdet


class FlowOps:
    """Operations for :class:`FlowTransform` states."""

    is_flow = True

    def __init__(self, spec: FlowSpec):
        self.spec = spec

    def eval_from_z(self, t: FlowTransform, z, logp_grad_fn):
        # Full-f32 matmuls: the flow maps feed the energy directly.
        with jax.default_matmul_precision("highest"):
            (q, logdet), vjp = jax.vjp(
                lambda zz: self.spec.forward(t.params, zz), z)
            logp, g = logp_grad_fn(q)
            # zg = (dq/dz)^T g + d(logdet)/dz: the gradient of the
            # transformed log density logp(F(z)) + logdet(z) wrt z.
            zg = vjp((g, jnp.ones_like(logdet)))[0]
        return q, logp, g, zg, logdet

    def eval_from_q(self, t: FlowTransform, q, g, logp_grad_fn):
        with jax.default_matmul_precision("highest"):
            z, logdet = self.spec.inverse(t.params, q)
            # Recompute zg by differentiating through the forward map at z.
            (_, _), vjp = jax.vjp(
                lambda zz: self.spec.forward(t.params, zz), z)
            zg = vjp((g, jnp.ones_like(logdet)))[0]
        return z, zg, logdet


AFFINE_OPS = AffineOps()

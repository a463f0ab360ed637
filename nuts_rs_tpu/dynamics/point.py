"""Phase-space point as an immutable pytree.

Replaces the reference's refcounted ``StatePool``/``State`` objects
(nuts-rs ``src/dynamics/state.rs:23-124``) and ``TransformedPoint``
(``src/dynamics/transformed_hamiltonian.rs:56-77``).  Here there is no
pooling: XLA donates and reuses buffers; a point is just a NamedTuple of
arrays with a leading chains axis added by ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Point(NamedTuple):
    q: jax.Array       # [d] untransformed position
    g: jax.Array       # [d] untransformed gradient (of logp wrt q)
    z: jax.Array       # [d] transformed position
    zg: jax.Array      # [d] transformed gradient
    v: jax.Array       # [d] velocity
    logp: jax.Array    # []
    logdet: jax.Array  # []
    ke: jax.Array      # [] kinetic energy (Euclidean/ExactNormal: 0.5|v|^2;
    #                       Microcanonical: accumulated delta-KE along trajectory)
    idx: jax.Array     # [] i32 signed index in trajectory

    @property
    def energy(self) -> jax.Array:
        """E = KE - (logp + logdet); nuts-rs transformed_hamiltonian.rs:349-351."""
        return self.ke - (self.logp + self.logdet)


def point_where(cond, a: Point, b: Point) -> Point:
    """Elementwise select between two points on a scalar (or broadcast) bool."""
    return jax.tree.map(lambda x, y: jnp.where(cond, x, y), a, b)

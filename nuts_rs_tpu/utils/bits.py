"""Small integer bit-twiddling helpers used by the iterative NUTS tree.

The reference implementation (nuts-rs ``src/nuts.rs:108-170``) builds its
trajectory tree recursively.  Our batched formulation replaces the recursion with a
flat loop over leapfrog steps; the implicit binary-tree structure is recovered
from the *leaf index* within the current doubling via trailing-zero counts:

* a leaf ``i`` opens a new subtree span at every level ``j <= tz(i)``
* a leaf ``i`` is the midpoint of exactly one span, at level ``tz(i + 1) + 1``
* spans at levels ``1..=tz(i + 1)`` are completed when leaf ``i`` is added
"""

import jax
import jax.numpy as jnp


def trailing_zeros(x, cap):
    """Count trailing zero bits of ``x`` (int32), returning ``cap`` for x == 0."""
    x = jnp.asarray(x, jnp.int32)
    lowbit = jnp.bitwise_and(x, -x)
    tz = 31 - jax.lax.clz(lowbit)
    return jnp.where(x == 0, jnp.int32(cap), tz)

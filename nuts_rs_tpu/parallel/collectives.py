"""Cross-chain statistics pooling over the device mesh.

The reference has NO distributed backend — its only parallelism is one rayon
thread per chain with strictly per-chain adaptation (SURVEY.md §2.12,
nuts-rs ``src/sampler.rs:1286-1326``).  This module is the
component that replaces it: chains live on a ``Mesh`` axis, and adaptation
statistics can optionally be POOLED across every chain on every chip with
XLA collectives (``psum``), which sharpens mass-matrix estimates
early in warmup when each chain has seen only a few draws.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..adapt.mass_matrix import RunningVariance


def merge_running_variance(rv: RunningVariance, axis_name: str | None = None
                           ) -> RunningVariance:
    """Combine per-chain running-variance states into one pooled state.

    Merges over the local chains axis (axis 0) and, when ``axis_name`` is
    given (inside ``shard_map``), additionally over the mesh axis via psum.
    Uses the standard parallel-Welford merge: the pooled mean is the
    count-weighted mean, and within-chain var_sums are augmented with the
    between-chain term n_i (m_i - m)^2.

    Returns a pooled state broadcast back to the local chains axis.
    """
    counts = rv.count  # [C]
    c = counts.shape[0]

    def total(x):
        s = jnp.sum(x, axis=0)
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name)
        return s

    n = total(counts)
    n_safe = jnp.maximum(n, 1.0)
    mean = total(counts[:, None] * rv.mean) / n_safe
    between = counts[:, None] * jnp.square(rv.mean - mean[None, :])
    var_sum = total(rv.var_sum + between)

    def bcast(x):
        return jnp.broadcast_to(x, (c,) + x.shape)

    return RunningVariance(mean=bcast(mean), var_sum=bcast(var_sum),
                           count=jnp.broadcast_to(n, (c,)))

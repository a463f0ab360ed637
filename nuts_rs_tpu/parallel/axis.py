"""Parameter-axis ("dim") sharding context for the fused sampler kernels.

The second distribution axis of this framework (SURVEY.md §5 "long-context
analog"; the reference's corresponding scale axis is its SIMD kernels benched
to d=4567, nuts-rs ``benches/sample.rs:126``): for huge-d models the
parameter dimension of every state vector (q, g, z, zg, v, the checkpoint
stacks, the mass matrix) is sharded over a mesh axis named ``"dim"``, and
every contraction over the parameter axis — the U-turn dots, kinetic-energy
norms, logdet sums, low-rank ``U^T rhs`` projections, and the model's own
log-density reduction — becomes a device-local partial reduction followed by
one ``lax.psum`` over that axis.

Mechanics: the kernels are written against :func:`dsum` / :func:`dfinish` /
:func:`global_dim` / :func:`fold_dim_shard` instead of raw ``jnp.sum`` at
exactly the contraction sites.  Outside a sharded trace these helpers are
identities over local ops (zero overhead — the branch is resolved at trace
time).  The sampler enters :func:`dim_axis_ctx` while tracing the body of a
``shard_map`` whose mesh carries a ``"dim"`` axis, which switches every helper
to its collective form.  Because the context is consulted at *trace* time and
tracing happens inside the wrapped body, `jax.jit`'s deferred tracing is
handled correctly.

Consistency argument: all tree decisions (selection uniforms, direction draws,
turning/divergence booleans) depend only on scalars that are either computed
from replicated inputs or produced by ``psum`` — which returns the same value
on every participant — so every dim-shard takes identical control-flow
decisions without extra communication.  The only per-shard randomness is
momentum/noise sampling, where the chain key is folded with
``lax.axis_index("dim")`` so shards draw independent slices of the global
Gaussian.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import jax
import jax.numpy as jnp

DIM_AXIS = "dim"

_stack: list[str] = []


@contextlib.contextmanager
def dim_axis_ctx(name: str = DIM_AXIS):
    """Activate dim-axis collectives while tracing a shard_map body."""
    _stack.append(name)
    try:
        yield
    finally:
        _stack.pop()


def current_dim_axis() -> Optional[str]:
    return _stack[-1] if _stack else None


def _psum_local_grad(local, name):
    """psum in the primal whose derivative is the LOCAL derivative.

    ``lax.psum`` transposes to ``psum``: differentiating a replicated
    function of ``psum(local)`` yields an extra psum over the (replicated)
    cotangent, i.e. the true gradient times the axis size (verified:
    grad of -0.5 psum(|x|^2) over 2 shards returns -2x).  Routing the
    differentiable path through ``local`` only — the collective correction
    rides ``stop_gradient`` — gives both the global primal and the correct
    shard-local gradient, so ``jax.value_and_grad`` through a dim-sharded
    model logp works unmodified.
    """
    return local + jax.lax.stop_gradient(jax.lax.psum(local, name) - local)


def dsum(x, axis=None):
    """Sum that is global over the (possibly sharded) parameter axis.

    ``axis`` follows ``jnp.sum``; the reduction over the mesh axis is a psum.
    """
    s = jnp.sum(x, axis=axis)
    name = current_dim_axis()
    if name is not None:
        s = _psum_local_grad(s, name)
    return s


def dfinish(partial):
    """Complete a contraction already reduced locally (e.g. a matmul whose
    contracting dimension was the sharded parameter axis)."""
    name = current_dim_axis()
    if name is not None:
        partial = _psum_local_grad(partial, name)
    return partial


def dall(x):
    """Global ``all`` over the sharded parameter axis."""
    ok = jnp.all(x)
    name = current_dim_axis()
    if name is not None:
        ok = jax.lax.psum(ok.astype(jnp.int32), name) == jax.lax.psum(
            jnp.int32(1), name)
    return ok


def global_dim(n_local: int):
    """Global parameter count from a local block size (static)."""
    name = current_dim_axis()
    if name is not None:
        return n_local * jax.lax.psum(1, name)
    return n_local


def fold_dim_shard(key):
    """Derive a per-shard PRNG key so shards sample independent momentum
    slices (the dim-axis analog of the per-chain ``set_stream``)."""
    name = current_dim_axis()
    if name is not None:
        return jax.random.fold_in(key, jax.lax.axis_index(name))
    return key

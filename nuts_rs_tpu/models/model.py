"""User-facing model contract.

JAX replacement for the reference's ``CpuLogpFunc``/``Model`` traits
(nuts-rs ``src/math/cpu_math.rs:885-970``, ``src/model.rs:18-37``).

Instead of a stateful object with an explicit gradient output buffer, a model
here is a pure, JAX-traceable scalar log-density function.  Gradients come from
``jax.value_and_grad``; recoverable logp errors (nuts-rs ``LogpError``,
``src/math/math.rs:9-13``) are represented by NaN/-inf values which the sampler
treats as divergences — there are no exceptions on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Model:
    """A target distribution defined by an unnormalized log density.

    Parameters
    ----------
    logp_fn:
        ``logp_fn(q: f[dim]) -> f[]`` — JAX-traceable unnormalized log density
        over the unconstrained parameter vector.
    dim:
        Number of unconstrained parameters.
    expand_fn:
        Optional ``expand_fn(key, q) -> dict[str, array]`` computing
        posterior-expansion / deterministic quantities stored in the trace
        (mirror of ``Math::expand_vector``, nuts-rs ``src/math/math.rs:63``).
    init_position_fn:
        Optional ``init_position_fn(key) -> f[dim]``; defaults to U(-2, 2)
        per coordinate (the nutpie convention).
    dims / coords:
        xarray-style dimension names / coordinate arrays for expanded
        variables (mirror of ``HasDims``, nuts-storable ``src/lib.rs:94-99``).
    """

    logp_fn: Callable[[jax.Array], jax.Array]
    dim: int
    expand_fn: Optional[Callable[[jax.Array, jax.Array], Mapping[str, jax.Array]]] = None
    init_position_fn: Optional[Callable[[jax.Array], jax.Array]] = None
    dims: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    coords: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    name: str = "model"
    # Optional HOST-side expansion: ``expand_host_fn(positions[C, k, d]) ->
    # dict[str, np.ndarray[C, k, ...]]`` runs per chunk on numpy arrays and
    # may return ANY numpy dtype — including fixed-length strings ("<U...")
    # and datetime64/timedelta64 — covering the reference's non-numeric
    # trace Values (nuts-storable Value::Strings/DateTime64/TimeDelta64,
    # nuts-storable/src/lib.rs:5-92) that a jitted ``expand_fn`` cannot
    # produce.  A TWO-argument ``expand_host_fn(positions, first_draw)``
    # also receives the chunk's first global draw index (warmup draws
    # included), so draw-indexed outputs stay invariant to the sampler's
    # internal chunk_size.  Stored alongside expand_fn outputs in every
    # backend (Zarr maps them to "<U{n}" / "<M8[ns]" arrays).
    #
    # Schema-reflection caveat: backends that declare the trace schema
    # upfront (Zarr) probe this fn ONCE at Sampler construction with a
    # single all-zeros position block (positions=[C, 1, d] zeros,
    # first_draw=0) to learn output names/dtypes — the fn should be free of
    # per-call side effects (don't append to external buffers or write
    # files inside it); raising on the probe is fine (the fn is then just
    # not reflected and its arrays materialize on first write).
    expand_host_fn: Optional[Callable] = None
    # True when ``logp_fn`` is written against ``parallel.axis.dsum``/
    # ``dfinish`` so it computes the GLOBAL log density when traced inside a
    # dim-sharded ``shard_map`` (each shard sees its local parameter block).
    # ``dsum`` keeps the differentiable path shard-local (raw psum would
    # scale gradients by the axis size — see axis._psum_local_grad), so
    # ``jax.value_and_grad`` through it yields the correct local gradient
    # block.  Models without this flag are rejected by dim-sharded execution.
    dim_shardable: bool = False

    def logp_and_grad(self, q: jax.Array):
        """Return ``(logp, grad)`` at ``q``.

        Mirrors ``Math::logp_array`` (nuts-rs ``src/math/math.rs:46``): one
        fused value-and-gradient evaluation; this is the hot call of the whole
        sampler (see SURVEY.md §3.2).

        Traced under full-f32 matmul precision: by default XLA may run f32
        matmuls in reduced precision (TF32 on NVIDIA GPUs, ~10 mantissa
        bits), which corrupts Hamiltonian energies for matmul-heavy
        densities (biased logistic-regression posteriors).  Scoped here —
        tree bookkeeping keeps the backend default.
        """
        with jax.default_matmul_precision("highest"):
            logp, grad = jax.value_and_grad(self.logp_fn)(q)
        return logp, grad

    def init_position(self, key: jax.Array, dtype=None) -> jax.Array:
        if self.init_position_fn is not None:
            q = self.init_position_fn(key)
        else:
            q = jax.random.uniform(key, (self.dim,), minval=-2.0, maxval=2.0)
        if dtype is not None:
            q = q.astype(dtype)
        return q

    def expand(self, key: jax.Array, q: jax.Array) -> Mapping[str, jax.Array]:
        if self.expand_fn is None:
            return {}
        return dict(self.expand_fn(key, q))

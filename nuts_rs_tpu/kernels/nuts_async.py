"""Draw-asynchronous NUTS: each chain starts its next draw immediately.

The per-draw ``scan`` + nested ``while_loop`` formulation runs all chains in
lock-step to the LONGEST trajectory of every draw, so with 1k+ vmapped chains
most lanes idle (mean tree depth ~2-3 vs maxdepth-sized stragglers).  This kernel instead runs ONE ``lax.while_loop``
over leapfrog steps in which a chain that finishes its trajectory emits the
draw and immediately begins the next one.  Total iterations become
``max_chain(total leapfrogs over K draws)``, which concentrates around the
mean by the law of large numbers — the straggler waste vanishes for K >> 1.

Used for the posterior phase (frozen transform, step-size jitter only);
warmup keeps the draw-synchronous path because cross-chain adaptation
schedules are per-draw-index.  Draw-for-draw results follow the same
distribution as the synchronous kernel but consume the PRNG stream
differently, so they are reproducible per seed but not bit-identical to it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dynamics.hamiltonian import initialize_trajectory
from ..dynamics.point import Point
from ..parallel.axis import dsum
from ..transform.ops import AFFINE_OPS
from .nuts import (
    NutsOptions,
    _extract_info,
    _init_tree_carry,
    _tree_body,
    _tree_finished,
)


class AsyncOut(NamedTuple):
    """Per-draw outputs, written at each chain's own pace ([K, ...])."""

    position: jax.Array        # [K, d]
    depth: jax.Array           # [K] i32
    maxdepth_reached: jax.Array  # [K] bool
    diverging: jax.Array       # [K] bool
    n_steps: jax.Array         # [K] i32
    sum_accept: jax.Array      # [K]
    sum_accept_sym: jax.Array  # [K]
    max_energy_error: jax.Array  # [K]
    logp: jax.Array            # [K]
    energy: jax.Array          # [K]
    energy_error: jax.Array    # [K]
    idx_in_trajectory: jax.Array  # [K] i32
    fisher_distance: jax.Array  # [K]
    step_size: jax.Array       # [K]


class _AsyncCarry(NamedTuple):
    tree: object               # _Carry
    key: jax.Array             # per-chain key for draw-level randomness
    draw_count: jax.Array      # [] i32 completed draws
    out: AsyncOut


def _empty_out(K, dim, dtype):
    # K+1 rows: row K is a trash slot written by not-yet-finished iterations,
    # so every scatter index is in bounds.  (OOB mode="drop" scatters inside
    # a while_loop have lost updates on some XLA backends once any lane's
    # index went OOB — observed as silently missing draws.)
    K = K + 1
    f = lambda: jnp.zeros(K, dtype)
    i = lambda: jnp.zeros(K, jnp.int32)
    b = lambda: jnp.zeros(K, bool)
    return AsyncOut(
        position=jnp.zeros((K, dim), dtype),
        depth=i(), maxdepth_reached=b(), diverging=b(), n_steps=i(),
        sum_accept=f(), sum_accept_sym=f(), max_energy_error=f(),
        logp=f(), energy=f(), energy_error=f(), idx_in_trajectory=i(),
        fisher_distance=f(), step_size=f(),
    )


def nuts_run_async(
    key: jax.Array,
    init_pt: Point,
    transform,
    step_size: jax.Array,
    step_size_bar: jax.Array,
    num_draws: int,
    logp_grad_fn,
    opts: NutsOptions,
    jitter: float | None,
    draw_offset: jax.Array | int = 0,
    jitter_first=False,
    resync_first=True,
    ops=AFFINE_OPS,
) -> tuple[Point, AsyncOut]:
    """Run ``num_draws`` NUTS draws for one chain (vmap for batches).

    ``step_size`` is used for the first draw (set by the warmup tail);
    subsequent draws use ``step_size_bar`` with uniform jitter, replicating
    the post-tuning ``update_stepsize(use_best_guess=True)`` of the
    reference (adapt_strategy.rs:133-138).

    Per-draw randomness derives from ``fold_in(key, draw_offset + n)`` so
    results are invariant to how draws are chunked across launches.

    ``resync_first`` controls whether the first draw re-evaluates
    (z, zg, logdet) from ``init_pt.q``.  It must be True (possibly as a
    traced bool) exactly at the phase start — the warmup tail may have
    switched the transform after producing ``init_pt``, leaving its cache
    stale — and False on continuation launches, where ``init_pt`` is the
    previous launch's tree point: resyncing there would round-trip z→q→z
    and break bit-exact chunk invariance (in-kernel restarts carry z).
    """
    # Orbit buffers are only consumed by warmup flow training; AsyncOut never
    # emits them, so carrying [2^maxdepth, d] dead writes through the
    # while-loop would be pure HBM traffic.
    if opts.collect_orbit:
        import dataclasses

        opts = dataclasses.replace(opts, collect_orbit=False)
    K = num_draws
    dim = init_pt.q.shape[-1]
    dtype = init_pt.q.dtype
    # A tree can be "born finished" (maxdepth_dyn == 0) only when
    # target_integration_time <= step_size (or maxdepth == 0): nuts-rs then
    # performs zero doublings (nuts.rs:300-320) and the sync kernel emits the
    # initial point with n_steps == 0.  Guard statically so the common case
    # pays no extra select.
    may_born_finished = (opts.target_integration_time is not None
                         or opts.maxdepth == 0)

    def draw_keys(n):
        kd = jax.random.fold_in(key, jnp.asarray(draw_offset) + n)
        return jax.random.split(kd, 4)  # momentum, direction, jitter, tree

    k_mom, k_dir, k_jit0, k_tree = draw_keys(jnp.int32(0))
    # The very first posterior draw uses the warmup-set step; on continuation
    # launches (jitter_first) the first draw takes its own jittered step so
    # results are invariant to chunking.
    step0 = step_size
    if jitter is not None:
        jittered0 = step_size_bar * jax.random.uniform(
            k_jit0, dtype=dtype, minval=1.0 - jitter, maxval=1.0 + jitter)
        step0 = jnp.where(jnp.asarray(jitter_first), jittered0, step_size)
    pt0 = initialize_trajectory(k_mom, init_pt, transform, opts.kind,
                                ops=ops, logp_grad_fn=logp_grad_fn,
                                resync=False)
    if resync_first is not False:
        z, zg, logdet = ops.eval_from_q(transform, init_pt.q, init_pt.g,
                                        logp_grad_fn)
        r = jnp.asarray(resync_first)
        pt0 = pt0._replace(
            z=jnp.where(r, z, pt0.z),
            zg=jnp.where(r, zg, pt0.zg),
            logdet=jnp.where(r, jnp.asarray(logdet, dtype), pt0.logdet))
    tree = _init_tree_carry(k_tree, pt0, step0, opts,
                            jax.random.uniform(k_dir, dtype=dtype))
    carry = _AsyncCarry(tree=tree, key=key,
                        draw_count=jnp.int32(0),
                        out=_empty_out(K, dim, dtype))

    def cond(c: _AsyncCarry):
        return c.draw_count < K

    def body(c: _AsyncCarry) -> _AsyncCarry:
        stepped = _tree_body(c.tree, transform, logp_grad_fn, opts, ops)
        if may_born_finished:
            # Match the sync while_loop, whose cond runs BEFORE each body: a
            # born-finished tree takes no leapfrog and emits its initial
            # point (n_steps == 0).
            pre_done = _tree_finished(c.tree)
            tree = jax.tree.map(
                lambda old, new: jnp.where(pre_done, old, new),
                c.tree, stepped)
        else:
            tree = stepped
        finished = _tree_finished(tree)

        draw, info = _extract_info(tree)
        # unfinished iterations write to the in-bounds trash row K
        slot = jnp.where(finished, c.draw_count, jnp.int32(K))
        o = c.out
        fisher = dsum(jnp.square(draw.z + draw.zg))
        # The [d]-row write uses a one-hot select: windowed scatters inside a
        # vmapped while_loop have silently dropped a large fraction of
        # updates on some XLA backends (all-zero rows); 1-element scatters on
        # the scalar outputs behave correctly.
        row_mask = (jnp.arange(o.position.shape[0], dtype=jnp.int32)
                    == slot)[:, None]
        out = AsyncOut(
            position=jnp.where(row_mask, draw.q[None, :], o.position),
            depth=o.depth.at[slot].set(info.depth),
            maxdepth_reached=o.maxdepth_reached.at[slot].set(
                info.reached_maxdepth),
            diverging=o.diverging.at[slot].set(info.diverging),
            n_steps=o.n_steps.at[slot].set(info.n_steps),
            sum_accept=o.sum_accept.at[slot].set(info.sum_accept),
            sum_accept_sym=o.sum_accept_sym.at[slot].set(info.sum_accept_sym),
            max_energy_error=o.max_energy_error.at[slot].set(
                info.max_energy_error),
            logp=o.logp.at[slot].set(draw.logp),
            energy=o.energy.at[slot].set(info.energy),
            energy_error=o.energy_error.at[slot].set(info.energy_error),
            idx_in_trajectory=o.idx_in_trajectory.at[slot].set(
                info.idx_in_trajectory),
            fisher_distance=o.fisher_distance.at[slot].set(fisher),
            step_size=o.step_size.at[slot].set(tree.step_size),
        )

        # --- start the next draw where finished ---
        k_mom, k_dir, k_jit, k_tree = draw_keys(c.draw_count + 1)
        new_step = step_size_bar
        if jitter is not None:
            factor = jax.random.uniform(k_jit, dtype=dtype,
                                        minval=1.0 - jitter,
                                        maxval=1.0 + jitter)
            new_step = new_step * factor
        # The transform is frozen in the posterior phase and `draw` already
        # carries a consistent (z, zg, logdet) from the tree it came out of,
        # so skip the resync: with a flow transform it would cost an inverse
        # plus a forward-vjp on EVERY leapfrog iteration (the result is
        # discarded on all non-finishing ones).
        pt_next = initialize_trajectory(k_mom, draw, transform, opts.kind,
                                        ops=ops, logp_grad_fn=logp_grad_fn,
                                        resync=False)
        fresh = _init_tree_carry(k_tree, pt_next, new_step, opts,
                                 jax.random.uniform(k_dir, dtype=dtype))
        tree = jax.tree.map(
            lambda f, t: jnp.where(finished, f, t), fresh, tree)

        return _AsyncCarry(
            tree=tree,
            key=c.key,
            draw_count=c.draw_count + jnp.asarray(finished, jnp.int32),
            out=out,
        )

    final = jax.lax.while_loop(cond, body, carry)
    last_pt = final.tree.draw_main
    out = jax.tree.map(lambda x: x[:K], final.out)  # trim the trash row
    return last_pt, out

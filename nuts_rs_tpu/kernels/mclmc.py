"""Unadjusted Microcanonical Langevin Monte Carlo (MCLMC) kernel.

Batched reformulation of nuts-rs ``src/mclmc.rs`` (Robnik, De Luca,
Silverstein & Seljak 2023, experimental in the reference too): per draw,
``num_steps = round(subsample_freq * L / eps)`` leapfrog steps interleaved
with isokinetic (or Gaussian OU) partial momentum refreshes, with the
reference's **tree-structured dynamic step-size retry**: on divergence halve
the step factor and require 2 successful sub-steps before doubling back, to a
maximum of 10 halvings, tracked in an explicit fixed-depth stack array
(``src/mclmc.rs:242,274-359``).

Single chain; vmap over the chains axis.  The Euclidean -> Microcanonical
trajectory switch of ``EuclideanEarlyThenMicrocanonical`` happens at a
host-known draw index, so the sampler compiles one kernel per phase.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dynamics.hamiltonian import (
    KineticKind,
    LogpGradFn,
    initialize_trajectory,
    leapfrog,
    partial_momentum_refresh,
    sample_momentum,
)
from ..dynamics.point import Point, point_where
from ..parallel.axis import dsum, fold_dim_shard
from ..transform.affine import AffineTransform
from ..transform.ops import AFFINE_OPS
from .nuts import DivergenceInfo, _empty_div_info

MAX_HALVINGS = 10


@dataclasses.dataclass(frozen=True)
class MclmcOptions:
    """Static per-run options (nuts-rs ``MclmcSettings``, sampler.rs:268-318)."""

    momentum_decoherence_length: float = 3.0
    subsample_frequency: float = 1.0
    dynamic_step_size: bool = True
    max_energy_error: float = 1000.0
    kind: KineticKind = KineticKind.MICROCANONICAL
    store_divergences: bool = False


class MclmcInfo(NamedTuple):
    """Per-draw diagnostics (nuts-rs ``MclmcInfo``, mclmc.rs:75-87)."""

    energy_change: jax.Array
    diverging: jax.Array
    num_steps: jax.Array
    average_step_size: jax.Array
    log_weight: jax.Array
    divergence: DivergenceInfo
    # fed to the mass-matrix adaptation collector
    is_good_for_adapt: jax.Array
    draw_q: jax.Array
    draw_g: jax.Array
    draw_logp: jax.Array


class _Carry(NamedTuple):
    key: jax.Array
    pt: Point
    noise: jax.Array
    remaining: jax.Array       # i32
    factor: jax.Array          # f step-size multiplier (power of 2)
    stack: jax.Array           # [MAX_HALVINGS] i32 saved `remaining` values
    stack_size: jax.Array      # i32
    steps: jax.Array           # i32 leapfrogs taken
    time: jax.Array            # f integrated time
    diverged: jax.Array
    div_info: DivergenceInfo


def mclmc_draw(
    key: jax.Array,
    init_pt: Point,
    transform: AffineTransform,
    step_size: jax.Array,
    logp_grad_fn: LogpGradFn,
    opts: MclmcOptions,
    resample_velocity,
    ops=AFFINE_OPS,
) -> tuple[Point, MclmcInfo]:
    """One MCLMC draw (nuts-rs ``mclmc_kernel``, src/mclmc.rs:212-409)."""
    dim = init_pt.q.shape[-1]
    dtype = init_pt.q.dtype
    kind = opts.kind
    ell = opts.momentum_decoherence_length

    key, k_mom, k_noise0 = jax.random.split(key, 3)

    # initialize_trajectory with optional velocity resample (traced flag).
    pt_resampled = initialize_trajectory(k_mom, init_pt, transform, kind,
                                         resample_velocity=True,
                                         ops=ops, logp_grad_fn=logp_grad_fn)
    pt_kept = initialize_trajectory(k_mom, init_pt, transform, kind,
                                    resample_velocity=False,
                                    ops=ops, logp_grad_fn=logp_grad_fn)
    pt0 = point_where(resample_velocity, pt_resampled, pt_kept)
    initial_energy = pt0.energy

    num_base_steps = jnp.clip(
        jnp.round(opts.subsample_frequency * ell / step_size), 1.0, 1e6
    ).astype(jnp.int32)
    max_err_base = opts.max_energy_error / num_base_steps.astype(dtype)

    carry = _Carry(
        key=key,
        pt=pt0,
        noise=jax.random.normal(fold_dim_shard(k_noise0), (dim,), dtype),
        remaining=num_base_steps,
        factor=jnp.ones((), dtype),
        stack=jnp.zeros(MAX_HALVINGS, jnp.int32),
        stack_size=jnp.zeros((), jnp.int32),
        steps=jnp.zeros((), jnp.int32),
        time=jnp.zeros((), dtype),
        diverged=jnp.asarray(False),
        div_info=_empty_div_info(dim, dtype,
                                 store_momentum=opts.store_divergences),
    )

    max_halvings = MAX_HALVINGS if opts.dynamic_step_size else 0

    def cond(c: _Carry):
        return (c.remaining > 0) & ~c.diverged

    def body(c: _Carry) -> _Carry:
        key, k_n1, k_n2 = jax.random.split(c.key, 3)

        pt = partial_momentum_refresh(c.pt, c.noise, step_size, c.factor,
                                      ell, kind)
        # Per-step divergence baseline: post-refresh energy, so energy_error
        # measures only this single step's integration error (mclmc.rs:292-298).
        step_baseline = pt.energy
        res = leapfrog(pt, jnp.int32(1), step_size, transform, logp_grad_fn,
                       kind, step_baseline, max_err_base * c.factor,
                       step_size_factor=c.factor, ops=ops)

        # ---- success branch values ----
        noise1 = jax.random.normal(fold_dim_shard(k_n1), (dim,), dtype)
        next_pt = partial_momentum_refresh(res.point, noise1, step_size,
                                           c.factor, ell, kind)
        noise2 = jax.random.normal(fold_dim_shard(k_n2), (dim,), dtype)
        remaining_ok = c.remaining - 1
        steps_ok = c.steps + 1
        time_ok = c.time + c.factor * step_size

        # Unwind the halving stack while remaining == 0 (mclmc.rs:326-333);
        # bounded by the stack depth.
        def unwind(_, s):
            rem, factor, stack, size = s
            do = (rem == 0) & (size > 0)
            top = stack[jnp.maximum(size - 1, 0)]
            rem = jnp.where(do, top - 1, rem)
            factor = jnp.where(do, factor * 2.0, factor)
            size = jnp.where(do, size - 1, size)
            return rem, factor, stack, size

        rem_u, factor_u, stack_u, size_u = jax.lax.fori_loop(
            0, MAX_HALVINGS, unwind,
            (remaining_ok, c.factor, c.stack, c.stack_size))

        # ---- divergence branch values (mclmc.rs:335-354) ----
        give_up = c.stack_size >= max_halvings
        factor_div = c.factor * 0.5
        stack_div = c.stack.at[jnp.minimum(c.stack_size, MAX_HALVINGS - 1)
                               ].set(c.remaining)
        size_div = c.stack_size + 1
        # Retry from the pre-refresh point (the refresh built a new local
        # `pt`, so c.pt IS the pre-refresh state — unlike the reference,
        # which mutates in place and must restore the momentum,
        # mclmc.rs:282,348); the old noise is reused for the retry.
        pt_div = c.pt

        div = res.diverging
        # Reason codes mirror kernels/nuts.py (DIV_REASON_*): non-finite
        # logp/grad distinguished from the energy-threshold divergence.
        nan_logp = ~jnp.isfinite(res.point.logp)
        nan_grad = ~jnp.isfinite(dsum(res.point.zg))
        reason = jnp.where(
            div, jnp.where(nan_logp, jnp.int32(2),
                           jnp.where(nan_grad, jnp.int32(3), jnp.int32(1))),
            jnp.int32(0))
        store_mom = c.div_info.start_momentum.shape[0] > 0
        div_info = DivergenceInfo(
            start_location=pt.q,
            start_gradient=pt.g,
            start_momentum=pt.v if store_mom else c.div_info.start_momentum,
            end_location=res.point.q,
            end_momentum=(res.point.v if store_mom
                          else c.div_info.end_momentum),
            energy_error=res.energy_error,
            start_idx=pt.idx,
            end_idx=res.point.idx,
            reason=reason,
        )
        div_info = jax.tree.map(
            lambda new, old: jnp.where(div & give_up, new, old),
            div_info, c.div_info)

        return _Carry(
            key=key,
            pt=point_where(div, pt_div, next_pt),
            noise=jnp.where(div, c.noise, noise2),
            remaining=jnp.where(div, jnp.where(give_up, jnp.int32(0),
                                               jnp.int32(2)), rem_u),
            factor=jnp.where(div, jnp.where(give_up, c.factor, factor_div),
                             factor_u),
            stack=jnp.where(div & ~give_up, stack_div, stack_u),
            stack_size=jnp.where(div, jnp.where(give_up, c.stack_size,
                                                size_div), size_u),
            steps=jnp.where(div, c.steps, steps_ok),
            time=jnp.where(div, c.time, time_ok),
            diverged=c.diverged | (div & give_up),
            div_info=div_info,
        )

    final = jax.lax.while_loop(cond, body, carry)

    # On divergence: stay at the pre-trajectory position but fully resample
    # the momentum (mclmc.rs:361-384).
    key_res = jax.random.fold_in(final.key, 1)
    pt_fail = initialize_trajectory(key_res, init_pt, transform, kind,
                                    resample_velocity=True,
                                    ops=ops, logp_grad_fn=logp_grad_fn)
    out_pt = point_where(final.diverged, pt_fail, final.pt)

    # Energy change of the trajectory end (also stored on divergence:
    # the reference reports the diverged trajectory's energy, mclmc.rs:441).
    energy_change = final.pt.energy - initial_energy

    steps_f = jnp.maximum(final.steps, 1).astype(dtype)
    info = MclmcInfo(
        energy_change=energy_change,
        diverging=final.diverged,
        num_steps=final.steps,
        average_step_size=final.time / steps_f,
        # nuts-rs stores energy_change as the log weight (mclmc.rs:441-442).
        log_weight=energy_change,
        divergence=final.div_info,
        # DrawGradCollector semantics: the collector sees the trajectory END
        # (even on divergence, mclmc.rs:382/394).
        is_good_for_adapt=jnp.where(final.diverged,
                                    jnp.abs(final.pt.idx) > 4,
                                    final.pt.idx != 0),
        draw_q=final.pt.q,
        draw_g=final.pt.g,
        draw_logp=final.pt.logp,
    )
    return out_pt, info

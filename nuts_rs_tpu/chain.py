"""Chain driver: warmup + sampling as one jitted scan over draws.

Batched replacement for ``NutsChain`` and the ``AdaptStrategy`` wiring
(nuts-rs ``src/chain.rs:44-213``, ``src/adapt_strategy.rs:71-238``).

The chains axis is explicit (leading dim C) rather than object-per-chain; the
per-draw NUTS kernel is vmapped over it, while adaptation updates execute as
batched tensor ops gated on *scalar* schedule flags (precomputed host-side,
see ``adapt/schedule.py``) so that expensive refits run under real
``lax.cond`` instead of per-chain selects.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .adapt import mass_matrix as mm
from .adapt import step_size as ss
from .adapt.schedule import AdaptSchedule, WindowParams
from .dynamics.hamiltonian import init_point_from_q
from .dynamics.point import Point
from .kernels.nuts import NutsOptions, nuts_draw
from .parallel.axis import dsum
from .transform.affine import AffineTransform, identity_transform, init_diag_from_grad
from .transform.ops import AFFINE_OPS


class ChainState(NamedTuple):
    """All per-chain device state; every leaf has a leading chains axis."""

    pt: Point                      # current draw (position, gradient, caches)
    transform: AffineTransform     # mass matrix / coordinate transform
    diag_adapt: mm.DiagAdaptState  # fg/bg variance estimators
    step: ss.StepSizeState         # step-size adaptation state
    keys: jax.Array                # [C] per-chain PRNG keys
    draw_idx: jax.Array            # [] global draw counter
    extra: Any = None              # strategy-specific extra state (low-rank window, ...)
    window: Any = None             # WindowState when window_by_good_draws


class WindowState(NamedTuple):
    """Per-chain ``GlobalStrategy`` counters for the good-draw window mode
    (nuts-rs ``src/adapt_strategy.rs:71-98``); the good-draw counts themselves
    are the estimator counts in ``DiagAdaptState``."""

    current_window: jax.Array  # [C] float current_window_size
    last_update: jax.Array     # [C] i32 draw index of the last mass update
    has_initial: jax.Array     # [C] bool has_initial_mass_matrix


def _select_chains(mask, a, b):
    """Per-chain tree select: ``mask`` is [C]; leaves have leading axis C."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - 1))
        return jnp.where(m, x, y)
    return jax.tree.map(sel, a, b)


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static configuration shared by all chains."""

    nuts: NutsOptions
    step_size: ss.StepSizeSettings
    use_grad_based_estimate: bool = True
    # Pool the per-draw acceptance statistic across all chains (and across the
    # mesh axis under shard_map) before the dual-averaging update, so every
    # chain shares one step size driven by C-times more information.
    cross_chain_step_size: bool = False
    axis_name: Optional[str] = None
    # Non-None switches the warmup to per-chain good-draw window advancement
    # (reference semantics, adapt_strategy.rs:121-216); diag strategy only.
    window_params: Optional[WindowParams] = None
    store_gradient: bool = False
    store_unconstrained: bool = False
    store_transformed: bool = False
    store_divergences: bool = False
    store_mass_matrix: bool = False
    # Low-rank MatrixStats emission (nuts-rs LowRankSettings.store_mass_matrix,
    # src/transform/low_rank.rs:195,236): eigenvalues + count per update event.
    store_mass_matrix_eigs: bool = False


class DiagStrategy:
    """Diagonal mass-matrix adaptation (nuts-rs ``DiagAdaptStrategy``).

    With ``cross_chain=True`` the foreground estimators are pooled across all
    chains (and, under ``shard_map`` with ``axis_name`` set, across the device
    mesh via psum) before each mass-matrix update — an extension the
    reference cannot express (SURVEY.md §2.12).
    """

    needs_extra_state = False
    ops = AFFINE_OPS

    def __init__(self, config: ChainConfig, cross_chain: bool = False,
                 axis_name: Optional[str] = None):
        self.config = config
        self.cross_chain = cross_chain
        self.axis_name = axis_name

    def init_extra(self, dim, num_tune, dtype, num_chains):
        return None

    def make_transform(self, dim, dtype):
        return identity_transform(dim, dtype)

    def init_mass_matrix(self, state: ChainState) -> ChainState:
        """Feed the init point into the estimators and set sigma^2 = 1/|g|.

        (nuts-rs ``transform/adapt/diagonal.rs:209-231``)
        """
        da = jax.vmap(mm.update_estimators, in_axes=(0, 0, 0, None))(
            state.diag_adapt, state.pt.q, state.pt.g, True)
        transform = jax.vmap(init_diag_from_grad)(state.transform, state.pt.q,
                                                  state.pt.g)
        return state._replace(diag_adapt=da, transform=transform)

    def update_estimators(self, state: ChainState, draw_q, draw_g, is_good,
                          logp=None, energy_error=None):
        da = jax.vmap(mm.update_estimators)(state.diag_adapt, draw_q, draw_g,
                                            is_good)
        return state._replace(diag_adapt=da)

    def switch(self, state: ChainState) -> ChainState:
        return state._replace(diag_adapt=jax.vmap(mm.switch)(state.diag_adapt))

    def adapt_update_masked(self, state: ChainState, mask) -> ChainState:
        """Per-chain gated mass-matrix update for the good-draw window mode:
        chains where ``mask`` is False keep their transform untouched."""
        ugb = self.config.use_grad_based_estimate
        transform = jax.vmap(
            lambda s, t, m: mm.adapt_diag(s, t, use_grad_based_estimate=ugb,
                                          update_mask=m)
        )(state.diag_adapt, state.transform, mask)
        return state._replace(transform=transform)

    def adapt_update(self, state: ChainState) -> ChainState:
        adapt = state.diag_adapt
        if self.cross_chain:
            from .parallel.collectives import merge_running_variance

            adapt = mm.DiagAdaptState(
                draw=merge_running_variance(adapt.draw, self.axis_name),
                grad=merge_running_variance(adapt.grad, self.axis_name),
                draw_bg=adapt.draw_bg,
                grad_bg=adapt.grad_bg,
            )
        transform = jax.vmap(
            partial(mm.adapt_diag,
                    use_grad_based_estimate=self.config.use_grad_based_estimate)
        )(adapt, state.transform)
        return state._replace(transform=transform)


def _mean0(x, n):
    return x / jnp.maximum(n.astype(x.dtype), 1.0)


def _maybe_pool_steps(found, config: ChainConfig):
    """Cross-chain step sharing: replace per-chain init-search results with
    their geometric mean so pooled dual averaging keeps every chain on one
    identical step size."""
    if not config.cross_chain_step_size:
        return found
    pooled = jnp.mean(jnp.log(found))
    if config.axis_name is not None:
        pooled = jax.lax.pmean(pooled, config.axis_name)
    return jnp.broadcast_to(jnp.exp(pooled), found.shape)


def make_draw_step(model, strategy, config: ChainConfig):
    """Build the scan body: one draw + adaptation for all chains.

    The returned function has signature ``(state, flags) -> (state, stats)``
    where ``flags`` is one row of the precomputed :class:`AdaptSchedule`.
    """

    logp_grad = model.logp_and_grad
    sset = config.step_size
    ops = getattr(strategy, "ops", AFFINE_OPS)

    def draw_step(state: ChainState, flags):
        keys = jax.vmap(jax.random.split, in_axes=(0, None))(state.keys, 3)
        k_draw, k_jitter, k_next = keys[:, 0], keys[:, 1], keys[:, 2]

        draw_pt, info = jax.vmap(
            lambda k, pt, t, ss_: nuts_draw(k, pt, t, ss_, logp_grad,
                                            config.nuts, ops=ops)
        )(k_draw, state.pt, state.transform, state.step.step_size)

        state = state._replace(pt=draw_pt, keys=k_next)

        # --- step-size statistics from this draw's collector ---
        n = info.n_steps
        mean_acc = _mean0(info.sum_accept, n)
        sym_acc = _mean0(info.sum_accept_sym, n)

        # --- mass-matrix window (scalar-flag gated; adapt_strategy.rs:140-216) ---
        if getattr(strategy, "use_orbit", False):
            # Flow orbit mode: train on every leapfrog point of the draw
            # (external_adapt_strategy.rs:93-128).
            update = lambda s: strategy.update_estimators_orbit(s, info)
        else:
            update = lambda s: strategy.update_estimators(
                s, draw_pt.q, draw_pt.g, info.is_good_for_adapt,
                logp=draw_pt.logp, energy_error=info.energy_error)
        reinit_mask = None
        if config.window_params is None:
            state = jax.lax.cond(flags["update_estimators"], update,
                                 lambda s: s, state)
            state = jax.lax.cond(flags["do_switch"], strategy.switch,
                                 lambda s: s, state)
            state = jax.lax.cond(flags["do_update"], strategy.adapt_update,
                                 lambda s: s, state)
            use_late = flags["use_late_estimator"]
        else:
            # --- good-draw window mode: per-chain GlobalStrategy::adapt
            # (adapt_strategy.rs:121-216) on device.  bg/fg good-draw counts
            # ARE the estimator counts; the other per-chain counters live in
            # state.window.  With zero divergences this takes the same
            # decisions as the precomputed schedule on every draw.
            wp = config.window_params
            draw = state.draw_idx
            w = state.window
            in_win = flags["is_tuning"] & (draw < wp.final_step_size_window)
            is_early = draw < wp.early_end
            # Early->main transition: never shrink below the accumulated
            # background count (adapt_strategy.rs:144-150) — seeded from the
            # count BEFORE this draw's estimator update, like the reference.
            cw = jnp.where(draw == wp.early_end,
                           jnp.maximum(w.current_window,
                                       state.diag_adapt.draw_bg.count),
                           w.current_window)
            state = jax.lax.cond(in_win, update, lambda s: s, state)
            da = state.diag_adapt
            cdt = da.draw_bg.count.dtype
            bg_count = da.draw_bg.count
            early_freq = jnp.asarray(wp.early_switch_freq, cdt)
            switch_freq = jnp.where(is_early, early_freq, cw)
            could_switch = bg_count >= switch_freq
            # round-half-away-from-zero like Rust's f64::round.
            next_window = jnp.where(
                is_early, early_freq,
                jnp.maximum(cw + 1.0, jnp.floor(cw * wp.growth + 0.5)))
            is_late = ((next_window + draw.astype(cdt))
                       > wp.final_step_size_window)
            switch_mask = could_switch & (~is_late) & in_win
            # Gate the vmapped work on any-chain-active (like the reinit
            # cond below): posterior draws and most warmup draws have
            # all-False masks, and the selects alone would re-run the full
            # O(C*d) switch/update every draw.
            da = jax.lax.cond(
                jnp.any(switch_mask),
                lambda d: _select_chains(switch_mask,
                                         jax.vmap(mm.switch)(d), d),
                lambda d: d, da)
            cw = jnp.where(switch_mask & (~is_early), next_window, cw)
            state = state._replace(diag_adapt=da)
            update_mask = (switch_mask
                           | ((draw - w.last_update) >= wp.update_freq))
            update_mask = update_mask & in_win
            enough = da.draw.count >= 3.0
            state = jax.lax.cond(
                jnp.any(update_mask),
                lambda s: strategy.adapt_update_masked(s, update_mask),
                lambda s: s, state)
            did_change = update_mask & enough
            state = state._replace(window=WindowState(
                current_window=cw,
                last_update=jnp.where(did_change, draw, w.last_update),
                has_initial=w.has_initial & (~did_change)))
            reinit_mask = did_change & w.has_initial
            use_late = is_late | (~in_win)

        # --- dual averaging advance (early: plain mean; late: symmetric) ---
        accept_stat = jnp.where(use_late, sym_acc, mean_acc)
        if config.cross_chain_step_size:
            pooled = jnp.mean(accept_stat)
            if config.axis_name is not None:
                pooled = jax.lax.pmean(pooled, config.axis_name)
            accept_stat = jnp.broadcast_to(pooled, accept_stat.shape)
        step_new = jax.vmap(partial(ss.advance, settings=sset))(
            state.step, accept_stat)
        step_state = jax.tree.map(
            lambda new, old: jnp.where(flags["advance_da"], new, old),
            step_new, state.step)

        # --- step size for the next draw ---
        def with_reinit(stp):
            # First mass-matrix change: re-run the coarse init search from the
            # current position with the new transform (adapt_strategy.rs:207-212).
            found = jax.vmap(
                partial(ss.init_search, logp_grad_fn=logp_grad, settings=sset,
                        kind=config.nuts.kind, ops=ops)
            )(k_jitter, draw_pt.q, state.transform)
            found = _maybe_pool_steps(found, config)
            return jax.vmap(ss.reset_from_found_step)(stp, found)

        def without_reinit(stp):
            return jax.vmap(
                lambda k, s, ubg: ss.apply_jitter(k, s, sset, ubg),
                in_axes=(0, 0, None),
            )(k_jitter, stp, flags["use_best_guess"])

        if reinit_mask is None:
            step_state = jax.lax.cond(flags["reinit_step_size"], with_reinit,
                                      without_reinit, step_state)
        else:
            # Per-chain first-mass-matrix-change: chains whose mask is set
            # get the init search (reset overwrites their DA state, so the
            # reference's skip-update_stepsize-on-this-draw is implicit);
            # the cond skips the search entirely on draws where no chain
            # reinits.
            def mixed(stp):
                return _select_chains(reinit_mask, with_reinit(stp),
                                      without_reinit(stp))

            step_state = jax.lax.cond(jnp.any(reinit_mask), mixed,
                                      without_reinit, step_state)
        state = state._replace(step=step_state,
                               draw_idx=state.draw_idx + 1)

        # --- per-draw stats record (dense; host compacts sparse events) ---
        stats = {
            "position": draw_pt.q,
            "depth": info.depth,
            "maxdepth_reached": info.reached_maxdepth,
            "diverging": info.diverging,
            "n_steps": info.n_steps,
            "step_size": state.step.step_size,
            "step_size_bar": jax.vmap(
                partial(ss.step_size_bar, settings=sset))(state.step),
            "mean_tree_accept": mean_acc,
            "mean_tree_accept_sym": sym_acc,
            "max_energy_error": info.max_energy_error,
            "logp": draw_pt.logp,
            "energy": info.energy,
            "energy_error": info.energy_error,
            "index_in_trajectory": info.idx_in_trajectory,
            "fisher_distance": jax.vmap(
                lambda z, zg: dsum(jnp.square(z + zg)))(draw_pt.z, draw_pt.zg),
            "transformation_index": state.transform.id,
            "tuning": jnp.broadcast_to(flags["is_tuning"], info.depth.shape),
        }
        if config.store_gradient:
            stats["gradient"] = draw_pt.g
        if config.store_unconstrained:
            stats["unconstrained_draw"] = draw_pt.q
        if config.store_transformed:
            stats["transformed_position"] = draw_pt.z
            stats["transformed_gradient"] = draw_pt.zg
        if config.store_divergences:
            stats["divergence_start"] = info.divergence.start_location
            stats["divergence_start_gradient"] = info.divergence.start_gradient
            stats["divergence_start_momentum"] = info.divergence.start_momentum
            stats["divergence_end"] = info.divergence.end_location
            stats["divergence_momentum"] = info.divergence.end_momentum
            stats["divergence_energy_error"] = info.divergence.energy_error
            # i32 message-analog of the reference's logp_function_error /
            # divergence message (hamiltonian.rs:26-55): 0 none, 1 energy,
            # 2 non-finite logp, 3 non-finite gradient.
            stats["divergence_reason"] = info.divergence.reason
        if config.store_mass_matrix:
            stats["mass_matrix_inv"] = state.transform.stds
            stats["transformation_mu"] = state.transform.mean
        if config.store_mass_matrix_eigs and state.transform.vecs is not None:
            # MatrixStats (low_rank.rs:210-222): padded directions carry
            # lam == 1 exactly, so the count of selected eigendirections is
            # the number of entries differing from 1.
            vals = jnp.square(state.transform.vals_sqrt)
            stats["mass_matrix_eigvals"] = vals
            stats["num_eigenvalues"] = jnp.sum(
                (vals != 1.0).astype(jnp.int32), axis=-1)

        return state, stats

    return draw_step


def init_chain_state(
    key,
    model,
    strategy,
    config: ChainConfig,
    num_chains: int,
    num_tune: int,
    dtype,
    init_positions: Optional[jax.Array] = None,
    init_retries: int = 500,
) -> ChainState:
    """Set up all chains: init positions, mass-matrix init, step-size search.

    Mirrors ``NutsChain::set_position`` + ``GlobalStrategy::init``
    (nuts-rs ``src/chain.rs:137-149``, ``src/adapt_strategy.rs:100-119``) and
    the init-position retry loop of ``src/sampler.rs:1133-1143``.
    """
    dim = model.dim
    key, k_init = jax.random.split(key)
    chain_keys = jax.random.split(key, num_chains)

    def find_position(k):
        def try_one(carry):
            k, _, _ = carry
            k, k_pos = jax.random.split(k)
            q = model.init_position(k_pos, dtype)
            logp, g = model.logp_and_grad(q)
            ok = jnp.isfinite(logp) & jnp.all(jnp.isfinite(g))
            return k, q, ok

        def cond(carry_it):
            (k, q, ok), it = carry_it
            return (~ok) & (it < init_retries)

        def body(carry_it):
            carry, it = carry_it
            return try_one(carry), it + 1

        carry = try_one((k, jnp.zeros(dim, dtype), jnp.asarray(False)))
        (k, q, ok), _ = jax.lax.while_loop(cond, body, (carry, 0))
        return q

    if init_positions is None:
        init_keys = jax.random.split(k_init, num_chains)
        q0 = jax.vmap(find_position)(init_keys)
    else:
        q0 = jnp.asarray(init_positions, dtype)

    def broadcast_chains(tree):
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (num_chains,) + jnp.shape(x)), tree)

    ops = getattr(strategy, "ops", AFFINE_OPS)
    transform = broadcast_chains(strategy.make_transform(dim, dtype))
    pt = jax.vmap(partial(init_point_from_q, logp_grad_fn=model.logp_and_grad,
                          ops=ops))(q0, transform)

    state = ChainState(
        pt=pt,
        transform=transform,
        diag_adapt=broadcast_chains(mm.new_diag_adapt_state(dim, dtype)),
        step=broadcast_chains(
            ss.new_step_size_state(config.step_size.initial_step, dtype)),
        keys=chain_keys,
        draw_idx=jnp.zeros((), jnp.int32),
        extra=strategy.init_extra(dim, num_tune, dtype, num_chains),
        window=(None if config.window_params is None else WindowState(
            current_window=jnp.full((num_chains,),
                                    config.window_params.init_window, dtype),
            last_update=jnp.zeros((num_chains,), jnp.int32),
            has_initial=jnp.ones((num_chains,), bool),
        )),
    )

    # Mass-matrix init from the first gradient, then the step-size search.
    state = strategy.init_mass_matrix(state)
    # Resync caches after transform change.
    pt = jax.vmap(partial(init_point_from_q, logp_grad_fn=model.logp_and_grad,
                          ops=ops))(state.pt.q, state.transform)
    state = state._replace(pt=pt)

    search_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(state.keys)
    found = jax.vmap(
        partial(ss.init_search, logp_grad_fn=model.logp_and_grad,
                settings=config.step_size, kind=config.nuts.kind, ops=ops)
    )(search_keys, state.pt.q, state.transform)
    found = _maybe_pool_steps(found, config)
    step = jax.vmap(ss.reset_from_found_step)(state.step, found)
    return state._replace(step=step)


def make_mclmc_draw_step(model, strategy, config: ChainConfig, mopts):
    """Scan body for the MCLMC sampler (nuts-rs ``MclmcChain::draw``,
    src/mclmc.rs:487-546): one mclmc_draw per chain + the shared adaptation
    machinery.  ``flags`` rows additionally carry ``resample_velocity``."""
    from .kernels.mclmc import mclmc_draw

    logp_grad = model.logp_and_grad
    sset = config.step_size
    ops = getattr(strategy, "ops", AFFINE_OPS)

    def draw_step(state: ChainState, flags):
        keys = jax.vmap(jax.random.split, in_axes=(0, None))(state.keys, 3)
        k_draw, k_jitter, k_next = keys[:, 0], keys[:, 1], keys[:, 2]

        draw_pt, info = jax.vmap(
            lambda k, pt, t, ss_: mclmc_draw(
                k, pt, t, ss_, logp_grad, mopts,
                flags["resample_velocity"], ops=ops)
        )(k_draw, state.pt, state.transform, state.step.step_size)

        state = state._replace(pt=draw_pt, keys=k_next)

        # --- adaptation: collector sees the trajectory end ---
        state = jax.lax.cond(
            flags["update_estimators"],
            lambda s: strategy.update_estimators(
                s, info.draw_q, info.draw_g, info.is_good_for_adapt,
                logp=info.draw_logp, energy_error=info.energy_change),
            lambda s: s, state)
        state = jax.lax.cond(flags["do_switch"], strategy.switch,
                             lambda s: s, state)
        state = jax.lax.cond(flags["do_update"], strategy.adapt_update,
                             lambda s: s, state)

        # Step size: jittered fixed value each draw (reference MCLMC presets
        # use StepSizeAdaptMethod::Fixed with the default 10% jitter).
        step_state = jax.vmap(
            lambda k, s, ubg: ss.apply_jitter(k, s, sset, ubg),
            in_axes=(0, 0, None),
        )(k_jitter, state.step, flags["use_best_guess"])
        state = state._replace(step=step_state, draw_idx=state.draw_idx + 1)

        stats = {
            "position": draw_pt.q,
            "diverging": info.diverging,
            "n_steps": info.num_steps,
            "energy_change": info.energy_change,
            "log_weight": info.log_weight,
            "average_step_size": info.average_step_size,
            "step_size": state.step.step_size,
            "logp": draw_pt.logp,
            "energy": draw_pt.energy,
            "fisher_distance": jax.vmap(
                lambda z, zg: dsum(jnp.square(z + zg)))(draw_pt.z, draw_pt.zg),
            "transformation_index": state.transform.id,
            "tuning": jnp.broadcast_to(flags["is_tuning"],
                                       info.diverging.shape),
        }
        if config.store_gradient:
            stats["gradient"] = draw_pt.g
        if config.store_unconstrained:
            stats["unconstrained_draw"] = draw_pt.q
        if config.store_divergences:
            stats["divergence_start"] = info.divergence.start_location
            stats["divergence_start_gradient"] = info.divergence.start_gradient
            stats["divergence_start_momentum"] = info.divergence.start_momentum
            stats["divergence_end"] = info.divergence.end_location
            stats["divergence_momentum"] = info.divergence.end_momentum
            stats["divergence_energy_error"] = info.divergence.energy_error
            # i32 message-analog of the reference's logp_function_error /
            # divergence message (hamiltonian.rs:26-55): 0 none, 1 energy,
            # 2 non-finite logp, 3 non-finite gradient.
            stats["divergence_reason"] = info.divergence.reason
        if config.store_mass_matrix:
            stats["mass_matrix_inv"] = state.transform.stds
            stats["transformation_mu"] = state.transform.mean
        return state, stats

    return draw_step


def make_async_posterior_runner(model, strategy, config: ChainConfig,
                                phase_start: int = 0):
    """Posterior-phase runner on the draw-asynchronous kernel.

    Signature matches the scan-based runners: ``(state, flags) -> (state,
    stats)`` with ``stats[name]`` shaped [k, C, ...].  Only usable when the
    transform is frozen and no per-leapfrog extras (gradients, divergence
    dumps, mass-matrix stats) are requested.
    """
    from .kernels.nuts_async import nuts_run_async

    logp_grad = model.logp_and_grad
    sset = config.step_size
    ops = getattr(strategy, "ops", AFFINE_OPS)

    def runner(state: ChainState, flags):
        k = flags["is_tuning"].shape[0]
        bars = jax.vmap(partial(ss.step_size_bar, settings=sset))(state.step)

        # Chunk-invariant RNG: per-draw keys are fold_in(chain_key,
        # global_draw_index); state.keys stays fixed across async chunks.
        jitter_first = state.draw_idx != phase_start
        last_pt, out = jax.vmap(
            lambda key, pt, t, step, bar: nuts_run_async(
                key, pt, t, step, bar, k, logp_grad, config.nuts,
                sset.jitter, draw_offset=state.draw_idx,
                jitter_first=jitter_first,
                resync_first=jnp.logical_not(jitter_first), ops=ops)
        )(state.keys, state.pt, state.transform, state.step.step_size, bars)

        state = state._replace(
            pt=last_pt,
            step=state.step._replace(step_size=out.step_size[:, -1]),
            draw_idx=state.draw_idx + k,
        )

        def t(x):  # [C, k, ...] -> [k, C, ...]
            return jnp.moveaxis(x, 0, 1)

        n = jnp.maximum(out.n_steps.astype(out.sum_accept.dtype), 1.0)
        stats = {
            "position": t(out.position),
            "depth": t(out.depth),
            "maxdepth_reached": t(out.maxdepth_reached),
            "diverging": t(out.diverging),
            "n_steps": t(out.n_steps),
            "step_size": t(out.step_size),
            "step_size_bar": jnp.broadcast_to(bars[None, :], (k,) + bars.shape),
            "mean_tree_accept": t(out.sum_accept / n),
            "mean_tree_accept_sym": t(out.sum_accept_sym / n),
            "max_energy_error": t(out.max_energy_error),
            "logp": t(out.logp),
            "energy": t(out.energy),
            "energy_error": t(out.energy_error),
            "index_in_trajectory": t(out.idx_in_trajectory),
            "fisher_distance": t(out.fisher_distance),
            "transformation_index": jnp.broadcast_to(
                state.transform.id[None, :], (k,) + state.transform.id.shape),
            "tuning": jnp.zeros((k,) + out.diverging.shape[:1], bool),
        }
        return state, stats

    return runner

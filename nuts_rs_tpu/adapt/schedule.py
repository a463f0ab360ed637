"""Warmup window schedule, precomputed per draw index.

Replaces the draw-by-draw control flow of nuts-rs ``GlobalStrategy``
(``src/adapt_strategy.rs:24-238``) with host-side precomputation: the switch /
update / estimator-phase decisions depend only on the draw index (plus static
options), so the whole schedule is materialized as flag arrays passed into the
device ``lax.scan`` as per-draw inputs.  Expensive operations (mass-matrix
refits, the step-size re-init search) then gate on *scalar* flags — real
``lax.cond`` branches on device, no vmap->select blowup across chains.

Deviation (documented): the reference advances windows by the count
of *good* (non-divergent) draws per chain; by default we advance by draw
index, assuming all draws are good.  Per-chain masks still control which
samples enter the estimators, so only the switch *timing* differs, and only
for chains that diverge during warmup.

Reference-semantics mode: ``AdaptScheduleOptions.window_by_good_draws=True``
moves the switch/update decisions onto the device, driven by each chain's own
good-draw counters (the estimator counts, which only grow on good draws) —
exactly ``GlobalStrategy::adapt`` (src/adapt_strategy.rs:121-216) per chain.
The static draw-index quantities it needs are packaged as :class:`WindowParams`
and the per-chain counters live in ``chain.WindowState``.  With zero
divergences the two modes take identical decisions on every draw.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AdaptScheduleOptions:
    """nuts-rs ``EuclideanAdaptOptions`` (``src/adapt_strategy.rs:41-69``)."""

    early_window: float = 0.3
    step_size_window: float = 0.15
    mass_matrix_switch_freq: int = 80
    early_mass_matrix_switch_freq: int = 10
    mass_matrix_update_freq: int = 1
    mass_matrix_window_growth: float = 1.5
    # Reference-semantics warmup: advance fg/bg windows by each chain's own
    # count of good (non-divergent) draws, computed on device, instead of the
    # host-precomputed draw-index schedule (src/adapt_strategy.rs:121-216).
    window_by_good_draws: bool = False


@dataclasses.dataclass(frozen=True)
class WindowParams:
    """Static draw-index quantities for the on-device window logic.

    These are the pieces of ``GlobalStrategy::adapt`` that depend only on the
    draw index and options, precomputed host-side; the per-chain counters
    (background count, current window size, last update, has-initial flag)
    live on device in ``chain.WindowState``.
    """

    early_end: int                 # early_window * num_tune
    final_step_size_window: int    # num_tune - step_size_window * num_tune
    num_tune: int
    early_switch_freq: int         # early_mass_matrix_switch_freq
    init_window: int               # mass_matrix_switch_freq
    update_freq: int               # mass_matrix_update_freq
    growth: float                  # mass_matrix_window_growth


def build_window_params(num_tune: int,
                        opts: AdaptScheduleOptions) -> WindowParams:
    return WindowParams(
        early_end=int(opts.early_window * num_tune),
        final_step_size_window=(
            num_tune - int(opts.step_size_window * num_tune)),
        num_tune=num_tune,
        early_switch_freq=opts.early_mass_matrix_switch_freq,
        init_window=opts.mass_matrix_switch_freq,
        update_freq=opts.mass_matrix_update_freq,
        growth=opts.mass_matrix_window_growth,
    )


class AdaptSchedule(NamedTuple):
    """Per-draw flag arrays over ``num_tune + num_draws`` steps."""

    is_tuning: np.ndarray        # bool: draw < num_tune
    update_estimators: np.ndarray  # bool: feed mass-matrix estimators this draw
    do_switch: np.ndarray        # bool: fg/bg window swap before the update
    do_update: np.ndarray        # bool: recompute the mass matrix
    use_late_estimator: np.ndarray  # bool: dual-avg uses symmetric accept mean
    reinit_step_size: np.ndarray  # bool: re-run the step-size init search
    use_best_guess: np.ndarray   # bool: update_stepsize(use_best_guess=...)
    advance_da: np.ndarray       # bool: advance dual averaging this draw


def build_schedule(num_tune: int, num_draws: int,
                   opts: AdaptScheduleOptions) -> AdaptSchedule:
    """Simulate ``GlobalStrategy::adapt`` (adapt_strategy.rs:121-222) by draw index."""
    total = num_tune + num_draws
    early_end = int(opts.early_window * num_tune)
    step_size_window = int(opts.step_size_window * num_tune)
    final_step_size_window = num_tune - step_size_window

    is_tuning = np.zeros(total, bool)
    update_estimators = np.zeros(total, bool)
    do_switch = np.zeros(total, bool)
    do_update = np.zeros(total, bool)
    use_late = np.zeros(total, bool)
    reinit = np.zeros(total, bool)
    use_best = np.zeros(total, bool)
    advance_da = np.zeros(total, bool)

    # Counter state of the simulated strategy (all-good-draws assumption).
    bg_count = 1      # init() feeds one sample into fg and bg
    fg_count = 1
    current_window = opts.mass_matrix_switch_freq
    last_update = 0
    has_initial_mass_matrix = True

    for draw in range(total):
        if draw >= num_tune:
            use_best[draw] = True
            continue
        is_tuning[draw] = True

        if draw < final_step_size_window:
            is_early = draw < early_end
            if (not is_early) and draw == early_end:
                current_window = max(current_window, bg_count)
            switch_freq = (opts.early_mass_matrix_switch_freq if is_early
                           else current_window)

            update_estimators[draw] = True
            bg_count += 1
            fg_count += 1

            could_switch = bg_count >= switch_freq
            if is_early:
                next_window = opts.early_mass_matrix_switch_freq
            else:
                # floor(x + 0.5) = Rust f64::round (half away from zero) —
                # NOT Python round() (banker's): at e.g. switch_freq=31 the
                # grown window hits 46.5, where the reference (and the
                # device good-draw mode) round to 47, Python to 46.
                next_window = max(
                    current_window + 1,
                    int(np.floor(
                        current_window * opts.mass_matrix_window_growth
                        + 0.5)))
            is_late = next_window + draw > final_step_size_window

            force_update = False
            if could_switch and not is_late:
                do_switch[draw] = True
                fg_count = bg_count
                bg_count = 0
                force_update = True
                if not is_early:
                    current_window = next_window

            did_change = False
            if force_update or (draw - last_update >= opts.mass_matrix_update_freq):
                if fg_count >= 3:
                    do_update[draw] = True
                    did_change = True
            if did_change:
                last_update = draw

            use_late[draw] = is_late
            advance_da[draw] = True

            if did_change and has_initial_mass_matrix:
                # The reference also skips update_stepsize on this draw
                # (adapt_strategy.rs:207-212); here reset_from_found_step
                # fully overwrites the dual-averaging state, so no separate
                # skip flag is needed.
                has_initial_mass_matrix = False
                reinit[draw] = True
        else:
            use_late[draw] = True
            advance_da[draw] = True
            use_best[draw] = draw == num_tune - 1

    return AdaptSchedule(
        is_tuning=is_tuning,
        update_estimators=update_estimators,
        do_switch=do_switch,
        do_update=do_update,
        use_late_estimator=use_late,
        reinit_step_size=reinit,
        use_best_guess=use_best,
        advance_da=advance_da,
    )

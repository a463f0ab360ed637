"""Iterative No-U-Turn trajectory builder.

Batched reformulation of the recursive doubling tree in nuts-rs
``src/nuts.rs:60-388``.  The recursion becomes ONE ``lax.while_loop`` whose
body performs a single leapfrog step plus O(maxdepth) masked bookkeeping, so
the whole draw is a single fused device computation that can be vmapped over
thousands of chains.

Tree-structure recovery
-----------------------
Within the current doubling, leaves are numbered ``0..2^depth-1`` in creation
order.  The implicit binary tree is recovered with trailing-zero counts
(``tz``):

* leaf ``i`` is the LEFT end (creation order) of every span at levels
  ``j <= tz(i)`` (with ``tz(0) := maxdepth``).  We store its (z, v, idx) in
  the *left stack* at row ``min(tz(i), maxdepth)`` — a single row write —
  and recover the left end of a completed span ``[s, s+2^j-1]`` from row
  ``min(tz(s), maxdepth)``.
* leaf ``i`` is the midpoint (last leaf of the first half) of exactly one
  span, at level ``tz(i+1) + 1``; stored in the *mid stack* at that row.
* when leaf ``i`` is added, spans at levels ``1..=tz(i+1)`` complete and
  their U-turn checks run.

U-turn check set (exact nuts-rs semantics, ``src/nuts.rs:148-161``): for a
completed span at level ``j`` merging halves A (older) and B (newer), check
(A.first, B.last) always, and for ``j >= 2`` also (A.last, B.last) and
(A.first, B.first).  Expressed in creation order these pairs are identical for
forward and backward doublings because the turning criterion internally orders
by trajectory index, so the flat loop is direction-agnostic.

Draw selection: progressive multinomial within the new subtree (distribution-
ally identical to nuts-rs's pairwise merges, ``src/nuts.rs:172-207``), then the
biased main-tree acceptance ``p = exp(logw_subtree - logw_main)`` of
``src/nuts.rs:191-202``.  When the top-level U-turn check fires, the merge
STILL happens before termination (matching ``extend``'s unconditional
``merge_into``); a turning detected *inside* an unfinished subtree discards it
without merging.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..dynamics.hamiltonian import (
    KineticKind,
    LogpGradFn,
    initialize_trajectory,
    leapfrog,
)
from ..dynamics.point import Point, point_where
from ..transform.ops import AFFINE_OPS
from ..parallel.axis import dfinish, dsum
from ..utils.bits import trailing_zeros


@dataclasses.dataclass(frozen=True)
class NutsOptions:
    """Static draw options (nuts-rs ``src/nuts.rs:257-279``)."""

    maxdepth: int = 10
    mindepth: int = 0
    check_turning: bool = True
    max_energy_error: float = 1000.0
    extra_doublings: int = 0
    target_integration_time: Optional[float] = None
    kind: KineticKind = KineticKind.EUCLIDEAN
    store_divergences: bool = False
    # Collect every leapfrog point (position, gradient, logp, energy error)
    # into a fixed [2^maxdepth] buffer for flow training — the reference's
    # ``use_orbit_for_training`` (external_adapt_strategy.rs:93-128).  Off by
    # default: the buffers cost HBM bandwidth in the hot loop.
    collect_orbit: bool = False


# DivergenceInfo.reason codes — the fixed-shape analog of the reference's
# ``logp_function_error`` / divergence message strings
# (src/dynamics/hamiltonian.rs:26-55): 0 = no divergence, 1 = energy error
# exceeded max_energy_error, 2 = non-finite logp at the new point,
# 3 = non-finite gradient at the new point.
DIV_REASON_NONE = 0
DIV_REASON_ENERGY = 1
DIV_REASON_NAN_LOGP = 2
DIV_REASON_NAN_GRAD = 3


class DivergenceInfo(NamedTuple):
    """Fixed-shape divergence forensics (nuts-rs ``src/dynamics/hamiltonian.rs:26-55``).

    ``start_momentum``/``end_momentum`` mirror the reference's
    ``start_momentum``/``end_momentum`` fields; they are captured only when
    ``NutsOptions.store_divergences`` is set (shape [0] otherwise — the two
    extra [d] buffers cost loop-carry bandwidth).  ``reason`` is the i32
    message-analog (see DIV_REASON_*), always captured.
    """

    start_location: jax.Array  # [d]
    start_gradient: jax.Array  # [d]
    start_momentum: jax.Array  # [d] ([0] unless store_divergences)
    end_location: jax.Array    # [d]
    end_momentum: jax.Array    # [d] ([0] unless store_divergences)
    energy_error: jax.Array    # []
    start_idx: jax.Array       # [] i32
    end_idx: jax.Array         # [] i32
    reason: jax.Array          # [] i32 (DIV_REASON_*)


class NutsInfo(NamedTuple):
    """Per-draw diagnostics: SampleInfo + collector outputs.

    Replaces the reference's ``Collector`` callback plumbing
    (``src/nuts.rs:31-42``, ``src/stepsize/dual_avg.rs:112-166``,
    ``src/transform/adapt/diagonal.rs:57-84``): statistics are accumulated
    in-register during the device loop and returned as part of the result.
    """

    depth: jax.Array             # [] i32
    reached_maxdepth: jax.Array  # [] bool
    diverging: jax.Array         # [] bool
    turning: jax.Array           # [] bool
    n_steps: jax.Array           # [] i32 number of leapfrogs (incl. divergent)
    sum_accept: jax.Array        # [] sum of per-leapfrog accept probs
    sum_accept_sym: jax.Array    # [] sum of symmetric accept probs
    max_energy_error: jax.Array  # [] signed, -inf after a divergence
    energy: jax.Array            # [] energy of the selected draw
    energy_error: jax.Array      # [] draw energy - initial energy
    initial_energy: jax.Array    # []
    idx_in_trajectory: jax.Array  # [] i32 of the selected draw
    is_good_for_adapt: jax.Array  # [] bool (DrawGradCollector.is_good)
    divergence: DivergenceInfo
    # Orbit buffers (opts.collect_orbit; capacity 1 otherwise): one row per
    # leapfrog in creation order; rows >= min(n_steps, cap) are invalid.
    orbit_q: jax.Array           # [cap, d]
    orbit_g: jax.Array           # [cap, d]
    orbit_logp: jax.Array        # [cap]
    orbit_err: jax.Array         # [cap] point energy - initial energy


class _Carry(NamedTuple):
    key: jax.Array
    step_size: jax.Array      # step size for this draw
    initial_energy: jax.Array
    mindepth_dyn: jax.Array   # i32
    maxdepth_dyn: jax.Array   # i32
    depth: jax.Array          # i32 current main-tree depth
    leaf: jax.Array           # i32 leaf index within current subtree
    direction: jax.Array      # i32 +-1
    check_this: jax.Array     # bool: turning checks active for this doubling
    p_minus: Point
    p_plus: Point
    p_edge: Point             # moving end of the current subtree
    draw_main: Point
    logw_main: jax.Array
    draw_sub: Point
    logw_sub: jax.Array
    left_z: jax.Array         # [D+1, d]
    left_v: jax.Array
    mid_z: jax.Array
    mid_v: jax.Array
    b_left: jax.Array         # [D+1] cached z.v per left-stack row
    b_mid: jax.Array          # [D+1] cached z.v per mid-stack row
    done: jax.Array
    diverging: jax.Array
    turning: jax.Array
    extra_mode: jax.Array
    extras_left: jax.Array
    n_steps: jax.Array
    sum_accept: jax.Array
    sum_accept_sym: jax.Array
    max_energy_error: jax.Array
    div_info: DivergenceInfo
    orbit_q: jax.Array
    orbit_g: jax.Array
    orbit_logp: jax.Array
    orbit_err: jax.Array


def _empty_div_info(dim, dtype, store_momentum=False):
    nan = jnp.full(dim, jnp.nan, dtype)
    mom = nan if store_momentum else jnp.zeros(0, dtype)
    return DivergenceInfo(
        start_location=nan,
        start_gradient=nan,
        start_momentum=mom,
        end_location=nan,
        end_momentum=mom,
        energy_error=jnp.asarray(jnp.nan, dtype),
        start_idx=jnp.zeros((), jnp.int32),
        end_idx=jnp.zeros((), jnp.int32),
        reason=jnp.zeros((), jnp.int32),
    )


def _dyn_depths(opts: NutsOptions, step_size):
    """target_integration_time -> dynamic (mindepth, maxdepth); nuts.rs:300-320."""
    D = opts.maxdepth
    if opts.target_integration_time is not None:
        max_steps = jnp.ceil(opts.target_integration_time / step_size)
        log2_steps = jnp.log2(jnp.maximum(max_steps, 1.0))
        mindepth_dyn = jnp.maximum(
            jnp.floor(log2_steps).astype(jnp.int32), jnp.int32(opts.mindepth))
        maxdepth_dyn = jnp.minimum(
            jnp.maximum(jnp.ceil(log2_steps).astype(jnp.int32), mindepth_dyn),
            jnp.int32(D))
    else:
        mindepth_dyn = jnp.int32(opts.mindepth)
        maxdepth_dyn = jnp.int32(D)
    return mindepth_dyn, maxdepth_dyn


def _init_tree_carry(key, pt0, step_size, opts: NutsOptions, rand_dir):
    """Fresh per-draw tree state from an initialized (momentum-refreshed) point."""
    D = opts.maxdepth
    dim = pt0.q.shape[-1]
    dtype = pt0.q.dtype
    mindepth_dyn, maxdepth_dyn = _dyn_depths(opts, step_size)
    dir0 = jnp.where(rand_dir < 0.5, jnp.int32(1), jnp.int32(-1))
    z_stack = jnp.zeros((D + 1, dim), dtype)
    return _Carry(
        key=key,
        step_size=step_size,
        initial_energy=pt0.energy,
        mindepth_dyn=mindepth_dyn,
        maxdepth_dyn=maxdepth_dyn,
        depth=jnp.int32(0),
        leaf=jnp.int32(0),
        direction=dir0,
        check_this=jnp.asarray(opts.check_turning) & (jnp.int32(0) >= mindepth_dyn),
        p_minus=pt0, p_plus=pt0, p_edge=pt0,
        draw_main=pt0, logw_main=jnp.zeros((), dtype),
        draw_sub=pt0, logw_sub=jnp.full((), -jnp.inf, dtype),
        left_z=z_stack, left_v=z_stack,
        mid_z=z_stack, mid_v=z_stack,
        b_left=jnp.zeros(D + 1, dtype), b_mid=jnp.zeros(D + 1, dtype),
        done=jnp.asarray(False),
        diverging=jnp.asarray(False),
        turning=jnp.asarray(False),
        extra_mode=jnp.asarray(False),
        extras_left=jnp.int32(opts.extra_doublings),
        n_steps=jnp.int32(0),
        sum_accept=jnp.zeros((), dtype),
        sum_accept_sym=jnp.zeros((), dtype),
        max_energy_error=jnp.zeros((), dtype),
        div_info=_empty_div_info(dim, dtype,
                                 store_momentum=opts.store_divergences),
        orbit_q=jnp.zeros((_orbit_cap(opts), dim), dtype),
        orbit_g=jnp.zeros((_orbit_cap(opts), dim), dtype),
        orbit_logp=jnp.zeros(_orbit_cap(opts), dtype),
        orbit_err=jnp.zeros(_orbit_cap(opts), dtype),
    )


def _orbit_cap(opts: NutsOptions) -> int:
    return (1 << opts.maxdepth) if opts.collect_orbit else 1


def _tree_finished(c: _Carry):
    return c.done | (~c.extra_mode & (c.depth >= c.maxdepth_dyn))


def _tree_body(c: _Carry, transform, logp_grad_fn, opts: NutsOptions,
               ops) -> _Carry:
    """One leapfrog + all tree bookkeeping (the shared hot loop body)."""
    D = opts.maxdepth
    dtype = c.p_edge.q.dtype
    initial_energy = c.initial_energy

    # One threefry call per iteration: 3 uniforms cover the within-subtree
    # selection, the top-level biased acceptance, and the next direction.
    key, k_r = jax.random.split(c.key)
    rand3 = jax.random.uniform(k_r, (3,), dtype=dtype)

    res = leapfrog(
        c.p_edge, c.direction, c.step_size, transform, logp_grad_fn,
        opts.kind, initial_energy, opts.max_energy_error, ops=ops,
    )
    new_pt, diverged = res.point, res.diverging

    # --- acceptance statistics (AcceptanceRateCollector, dual_avg.rs:130-158) ---
    diff = initial_energy - new_pt.energy
    acc = jnp.exp(jnp.minimum(diff, 0.0))
    acc_sym = 2.0 * acc / (1.0 + jnp.exp(diff))
    sum_accept = c.sum_accept + jnp.where(diverged, 0.0, acc)
    sum_accept_sym = c.sum_accept_sym + jnp.where(diverged, 0.0, acc_sym)
    n_steps = c.n_steps + 1
    max_err = jnp.where(
        diverged,
        -jnp.inf,
        jnp.where(jnp.abs(diff) > jnp.abs(c.max_energy_error), diff,
                  c.max_energy_error),
    )

    # Reason classification (the reference's logp_function_error / message,
    # hamiltonian.rs:26-55): non-finite logp and gradient are distinguished
    # from a plain energy-threshold divergence.
    nan_logp = ~jnp.isfinite(new_pt.logp)
    nan_grad = ~jnp.isfinite(dsum(new_pt.zg))
    reason = jnp.where(
        diverged,
        jnp.where(nan_logp, jnp.int32(DIV_REASON_NAN_LOGP),
                  jnp.where(nan_grad, jnp.int32(DIV_REASON_NAN_GRAD),
                            jnp.int32(DIV_REASON_ENERGY))),
        jnp.int32(DIV_REASON_NONE))
    store_mom = c.div_info.start_momentum.shape[0] > 0
    div_info = DivergenceInfo(
        start_location=c.p_edge.q,
        start_gradient=c.p_edge.g,
        start_momentum=(c.p_edge.v if store_mom
                        else c.div_info.start_momentum),
        end_location=new_pt.q,
        end_momentum=new_pt.v if store_mom else c.div_info.end_momentum,
        energy_error=res.energy_error,
        start_idx=c.p_edge.idx,
        end_idx=new_pt.idx,
        reason=reason,
    )
    div_info = jax.tree.map(
        lambda new, old: jnp.where(diverged, new, old), div_info, c.div_info)

    # --- orbit collection (flow training; external_adapt_strategy.rs:93-128).
    # In-bounds dynamic_update_slice row writes (the in-bounds scatter form —
    # the same pattern as the checkpoint stacks below).
    if opts.collect_orbit:
        cap = _orbit_cap(opts)
        row = jnp.minimum(c.n_steps, cap - 1)
        orbit_q = jax.lax.dynamic_update_slice(
            c.orbit_q, new_pt.q[None, :], (row, jnp.int32(0)))
        orbit_g = jax.lax.dynamic_update_slice(
            c.orbit_g, new_pt.g[None, :], (row, jnp.int32(0)))
        orbit_logp = c.orbit_logp.at[row].set(new_pt.logp)
        orbit_err = c.orbit_err.at[row].set(new_pt.energy - initial_energy)
    else:
        orbit_q, orbit_g = c.orbit_q, c.orbit_g
        orbit_logp, orbit_err = c.orbit_logp, c.orbit_err

    # --- progressive multinomial within the subtree ---
    logw_leaf = -res.energy_error
    is_first = c.leaf == 0
    logw_sub = jnp.where(is_first, logw_leaf,
                         jnp.logaddexp(c.logw_sub, logw_leaf))
    take_leaf = is_first | (jnp.log(rand3[0]) < logw_leaf - logw_sub)
    draw_sub = point_where(take_leaf, new_pt, c.draw_sub)

    # --- stack writes ---
    tz_leaf = trailing_zeros(c.leaf, cap=D)
    row_left = jnp.minimum(tz_leaf, D)
    d1 = dsum(new_pt.z * new_pt.v)
    left_z = c.left_z.at[row_left].set(new_pt.z)
    left_v = c.left_v.at[row_left].set(new_pt.v)
    b_left = c.b_left.at[row_left].set(d1)
    tz_next = trailing_zeros(c.leaf + 1, cap=D)
    row_mid = jnp.minimum(tz_next + 1, D)  # level this leaf is midpoint of
    mid_z = c.mid_z.at[row_mid].set(new_pt.z)
    mid_v = c.mid_v.at[row_mid].set(new_pt.v)
    b_mid = c.b_mid.at[row_mid].set(d1)

    # --- U-turn checks, matvec form -----------------------------------------
    # Two facts shape this:
    # (1) trajectory-index ordering is not needed — within a doubling every
    #     state was created along ``direction``, so the reference's sorted
    #     criterion (transformed_hamiltonian.rs:617-638) reduces, for states
    #     (old, new) in creation order, to
    #       turning = (dir*(z_new-z_old).v_old < 0) | (dir*(z_new-z_old).v_new < 0)
    # (2) traced-index gathers of whole [d] rows are avoided, so every
    #     check is decomposed into inner products available from four
    #     [D+1,d]@[d] matvecs against the stacks, one small [D+1,d]@[d,D+1]
    #     gram matrix, cached per-row z.v scalars, and one-hot *scalar*
    #     selections — no [D, d] gathered intermediates at all.
    dir_f = c.direction.astype(dtype)

    j_levels = jnp.arange(1, D + 1, dtype=jnp.int32)           # [D]
    s_vec = c.leaf + 1 - (jnp.int32(1) << j_levels)            # A left ends
    rows_a = jnp.minimum(trailing_zeros(s_vec, cap=D), D)
    s2_vec = c.leaf + 1 - (jnp.int32(1) << (j_levels - 1))     # B left ends
    rows_b = jnp.minimum(trailing_zeros(s2_vec, cap=D), D)
    oh_a = jax.nn.one_hot(rows_a, D + 1, dtype=dtype)          # [D, D+1]
    oh_b = jax.nn.one_hot(rows_b, D + 1, dtype=dtype)

    # Contractions over the parameter axis; under dim sharding each is a
    # local matmul completed by one psum over the "dim" mesh axis.
    av_left = dfinish(left_v @ new_pt.z)     # [D+1]  rows' v . z_new
    cz_left = dfinish(left_z @ new_pt.v)     # [D+1]  rows' z . v_new
    av_mid = dfinish(mid_v @ new_pt.z)
    cz_mid = dfinish(mid_z @ new_pt.v)
    gram = dfinish(left_z @ left_v.T)        # [D+1, D+1]  G[i, j] = z_i . v_j

    a_av = oh_a @ av_left
    a_b = oh_a @ b_left
    a_cz = oh_a @ cz_left
    b_b = oh_b @ b_left
    g_ba = jnp.sum((oh_b @ gram) * oh_a, axis=1)   # z_b . v_a
    g_ab = jnp.sum((oh_a @ gram) * oh_b, axis=1)   # z_a . v_b

    # (A.first, new): dz.v_a and dz.v_new with dz = dir*(z_new - z_a)
    t1 = (dir_f * (a_av - a_b) < 0) | (dir_f * (d1 - a_cz) < 0)
    # (midpoint_j, new): mid row for level j is exactly row j (static slice)
    t2 = ((dir_f * (av_mid[1:] - b_mid[1:]) < 0)
          | (dir_f * (d1 - cz_mid[1:]) < 0))
    # (A.first, B.first): B's left end is created after A's
    t3 = (dir_f * (g_ba - a_b) < 0) | (dir_f * (b_b - g_ab) < 0)

    active = j_levels <= tz_next
    level_turn = t1 | ((j_levels >= 2) & (t2 | t3))
    turning_int = jnp.any(active & level_turn) & c.check_this

    subtree_complete = (c.leaf + 1) == (jnp.int32(1) << c.depth)

    # --- top-level merge checks (nuts.rs:143-161 at the outermost call) ---
    # far_end/near_end are the trajectory endpoints opposite/along the current
    # direction; B0 (the subtree's first leaf) is left-stack row D.
    fwd = c.direction > 0
    far_z = jnp.where(fwd, c.p_minus.z, c.p_plus.z)
    far_v = jnp.where(fwd, c.p_minus.v, c.p_plus.v)
    near_z = jnp.where(fwd, c.p_plus.z, c.p_minus.z)
    near_v = jnp.where(fwd, c.p_plus.v, c.p_minus.v)
    far_zv = dsum(far_z * far_v)
    t_outer = ((dir_f * (dsum(new_pt.z * far_v) - far_zv) < 0)
               | (dir_f * (d1 - dsum(far_z * new_pt.v)) < 0))
    near_zv = dsum(near_z * near_v)
    t_near = ((dir_f * (dsum(new_pt.z * near_v) - near_zv) < 0)
              | (dir_f * (d1 - dsum(near_z * new_pt.v)) < 0))
    t_b0 = ((dir_f * (dsum(left_z[D] * far_v) - far_zv) < 0)
            | (dir_f * (b_left[D] - dsum(far_z * left_v[D])) < 0))
    turning_top = c.check_this & (
        t_outer | ((c.depth > 0) & (t_near | t_b0)))

    # --- biased progressive sampling at the top level (nuts.rs:191-202) ---
    take_sub = (logw_sub >= c.logw_main) | (
        jnp.log(rand3[1]) < logw_sub - c.logw_main)

    do_merge = subtree_complete & ~diverged & ~turning_int
    merge_take = do_merge & take_sub
    draw_main = point_where(merge_take, draw_sub, c.draw_main)
    logw_main = jnp.where(do_merge,
                          jnp.logaddexp(c.logw_main, logw_sub), c.logw_main)
    p_plus = point_where(do_merge & (c.direction > 0), new_pt, c.p_plus)
    p_minus = point_where(do_merge & (c.direction < 0), new_pt, c.p_minus)

    depth = c.depth + jnp.asarray(do_merge, jnp.int32)
    # Extra doublings (nuts.rs:350-370): after ANY top-level Turning result
    # — whether from the across-trees check (merged) or from a turning
    # inside the unfinished subtree (discarded, no merge) — keep doubling
    # with checks off for opts.extra_doublings rounds.
    turned_now = turning_int | (do_merge & turning_top)
    enter_extra = turned_now & (jnp.int32(opts.extra_doublings) > 0)
    extras_left = jnp.where(
        c.extra_mode & do_merge, c.extras_left - 1, c.extras_left)
    extra_mode = c.extra_mode | enter_extra

    done = (c.done | diverged
            | (turned_now & ~enter_extra)
            | (c.extra_mode & do_merge & (extras_left <= 0)))
    turning = c.turning | turned_now
    diverging = c.diverging | diverged

    # --- next-iteration bookkeeping ---
    new_doubling = do_merge | turning_int
    leaf = jnp.where(new_doubling, jnp.int32(0), c.leaf + 1)
    new_dir = jnp.where(rand3[2] < 0.5, jnp.int32(1), jnp.int32(-1))
    direction = jnp.where(new_doubling, new_dir, c.direction)
    check_next = (jnp.asarray(opts.check_turning)
                  & (depth >= c.mindepth_dyn)
                  & ~extra_mode)
    check_this = jnp.where(new_doubling, check_next, c.check_this)
    # After a completed doubling the next leapfrog starts from the
    # endpoint in the freshly sampled direction.
    edge_after_merge = point_where(new_dir > 0, p_plus, p_minus)
    p_edge = point_where(new_doubling, edge_after_merge, new_pt)

    return c._replace(
        key=key, depth=depth, leaf=leaf, direction=direction,
        check_this=check_this,
        p_minus=p_minus, p_plus=p_plus, p_edge=p_edge,
        draw_main=draw_main, logw_main=logw_main,
        draw_sub=draw_sub, logw_sub=logw_sub,
        left_z=left_z, left_v=left_v,
        mid_z=mid_z, mid_v=mid_v,
        b_left=b_left, b_mid=b_mid,
        done=done, diverging=diverging, turning=turning,
        extra_mode=extra_mode, extras_left=extras_left,
        n_steps=n_steps, sum_accept=sum_accept,
        sum_accept_sym=sum_accept_sym, max_energy_error=max_err,
        div_info=div_info,
        orbit_q=orbit_q, orbit_g=orbit_g,
        orbit_logp=orbit_logp, orbit_err=orbit_err,
    )


def _extract_info(final: _Carry) -> tuple[Point, NutsInfo]:
    reached_max = (~final.done) & (final.depth >= final.maxdepth_dyn)
    draw = final.draw_main
    info = NutsInfo(
        depth=final.depth,
        reached_maxdepth=reached_max,
        diverging=final.diverging,
        turning=final.turning,
        n_steps=final.n_steps,
        sum_accept=final.sum_accept,
        sum_accept_sym=final.sum_accept_sym,
        max_energy_error=final.max_energy_error,
        energy=draw.energy,
        energy_error=draw.energy - final.initial_energy,
        initial_energy=final.initial_energy,
        idx_in_trajectory=draw.idx,
        # DrawGradCollector.is_good (transform/adapt/diagonal.rs:73-84)
        is_good_for_adapt=jnp.where(
            final.diverging, jnp.abs(draw.idx) > 4, draw.idx != 0),
        divergence=final.div_info,
        orbit_q=final.orbit_q,
        orbit_g=final.orbit_g,
        orbit_logp=final.orbit_logp,
        orbit_err=final.orbit_err,
    )
    return draw, info


def nuts_draw(
    key: jax.Array,
    init_pt: Point,
    transform,
    step_size: jax.Array,
    logp_grad_fn: LogpGradFn,
    opts: NutsOptions,
    ops=AFFINE_OPS,
) -> tuple[Point, NutsInfo]:
    """Run one NUTS draw from ``init_pt`` (single chain; vmap for batches).

    Mirrors ``nuts::draw`` (nuts-rs ``src/nuts.rs:281-388``): momentum refresh,
    repeated doubling until maxdepth / U-turn / divergence, and collector
    bookkeeping, all in one ``lax.while_loop``.
    """
    dtype = init_pt.q.dtype
    key, key_mom, key_dir = jax.random.split(key, 3)
    pt0 = initialize_trajectory(key_mom, init_pt, transform, opts.kind,
                                ops=ops, logp_grad_fn=logp_grad_fn)
    carry = _init_tree_carry(
        key, pt0, step_size, opts,
        jax.random.uniform(key_dir, dtype=dtype))

    final = jax.lax.while_loop(
        lambda c: ~_tree_finished(c),
        lambda c: _tree_body(c, transform, logp_grad_fn, opts, ops),
        carry)
    return _extract_info(final)

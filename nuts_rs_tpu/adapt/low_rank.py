"""Low-rank mass-matrix estimation from a window of draws and gradients.

Batched rework of nuts-rs ``src/transform/adapt/low_rank.rs``: the
reference's ``VecDeque`` window becomes a fixed-capacity per-chain buffer with
absolute write positions and a validity mask; the estimation pipeline
(per-dim rescale -> thin SVD of draws & grads -> QR of the joint subspace ->
regularized covariances -> SPD geometric mean -> eigendecomposition ->
eigenvalue cutoff filter) runs as batched ``jnp.linalg`` ops over all chains
at host-scheduled draw indices.

Masking equivalences (exact, not approximate):
* zero-padded sample columns contribute nothing to the Gram matrices the
  reference builds (it never normalizes by the count, ``low_rank.rs:205-235``),
  so masked slots are identical to absent slots;
* data-free subspace directions get eigenvalue exactly 1 after the
  ``gamma``-regularization and are removed by the cutoff filter (keep only
  ``lam > cutoff`` or ``lam < 1/cutoff``, ``low_rank.rs:93-99``);
* the fixed-rank transform pads unselected eigendirections with ``lam = 1``,
  which makes them algebraic no-ops (see ``transform/affine.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

import dataclasses
from functools import partial
from typing import Optional

from ..transform.affine import (
    AffineTransform,
    identity_transform,
    init_diag_from_grad,
    set_low_rank,
)


@dataclasses.dataclass(frozen=True)
class LowRankSettings:
    """nuts-rs ``LowRankSettings`` (src/transform/low_rank.rs:193-208) plus
    the static rank cap and window capacity that fixed shapes need."""

    gamma: float = 1e-5
    eigval_cutoff: float = 2.0
    store_mass_matrix: bool = False
    max_rank: Optional[int] = None      # static transform rank; default d
    window_capacity: Optional[int] = None  # default num_tune


class LowRankWindow(NamedTuple):
    """Per-chain draw/grad window (leading chains axis added by the caller)."""

    draws: jax.Array     # [cap, d]
    grads: jax.Array     # [cap, d]
    write_pos: jax.Array  # [] i32: total accepted samples (absolute)
    start: jax.Array      # [] i32: first sample of the foreground window
    bg_start: jax.Array   # [] i32: first sample of the background window


def new_window(cap: int, dim: int, dtype) -> LowRankWindow:
    return LowRankWindow(
        draws=jnp.zeros((cap, dim), dtype),
        grads=jnp.zeros((cap, dim), dtype),
        write_pos=jnp.zeros((), jnp.int32),
        start=jnp.zeros((), jnp.int32),
        bg_start=jnp.zeros((), jnp.int32),
    )


def push(w: LowRankWindow, draw, grad, include) -> LowRankWindow:
    """Append one (draw, grad) pair when ``include`` (and capacity remains)."""
    cap = w.draws.shape[0]
    ok = include & (w.write_pos < cap)
    slot = jnp.minimum(w.write_pos, cap - 1)
    sel = jnp.asarray(ok, w.draws.dtype)
    draws = jax.lax.dynamic_update_slice(
        w.draws, (sel * draw + (1 - sel) * w.draws[slot])[None, :],
        (slot, jnp.int32(0)))
    grads = jax.lax.dynamic_update_slice(
        w.grads, (sel * grad + (1 - sel) * w.grads[slot])[None, :],
        (slot, jnp.int32(0)))
    return w._replace(draws=draws, grads=grads,
                      write_pos=w.write_pos + jnp.asarray(ok, jnp.int32))


def switch(w: LowRankWindow) -> LowRankWindow:
    """Foreground <- everything since last switch (low_rank.rs:315-322)."""
    return w._replace(start=w.bg_start, bg_start=w.write_pos)


def foreground_count(w: LowRankWindow):
    return w.write_pos - w.start


def background_count(w: LowRankWindow):
    return w.write_pos - w.bg_start


def _spd_mean(cov_draws, cov_grads):
    """SPD geometric mean of cov_draws and cov_grads^-1... specifically the
    matrix C with C cov_grads C = cov_draws (nuts-rs ``spd_mean``,
    low_rank.rs:237-262), via two symmetric eigendecompositions."""
    eg_vals, eg_vecs = jnp.linalg.eigh(cov_grads)
    sqrt_g = (eg_vecs * jnp.sqrt(eg_vals)[None, :]) @ eg_vecs.T
    inv_sqrt_g = (eg_vecs * (1.0 / jnp.sqrt(eg_vals))[None, :]) @ eg_vecs.T
    m = sqrt_g @ cov_draws @ sqrt_g
    m_vals, m_vecs = jnp.linalg.eigh(m)
    # No clamping: a numerically negative eigenvalue yields NaN here, which
    # poisons the result and makes the caller skip the update — the same
    # behavior as faer's sqrt of a negative eigenvalue in the reference.
    m_sqrt = (m_vecs * jnp.sqrt(m_vals)[None, :]) @ m_vecs.T
    return inv_sqrt_g @ m_sqrt @ inv_sqrt_g


def compute_update(
    w: LowRankWindow,
    transform: AffineTransform,
    gamma: float,
    eigval_cutoff: float,
) -> AffineTransform:
    """One full low-rank refit from the foreground window (single chain).

    Mirrors ``LowRankMassMatrixStrategy::compute_update``
    (low_rank.rs:73-124) with fixed shapes; invalid results (non-finite, or
    fewer than 3 window samples) leave the transform unchanged.
    """
    with jax.default_matmul_precision("highest"):
        return _compute_update_impl(w, transform, gamma, eigval_cutoff)


def _window_moments(w: LowRankWindow):
    """Masked first/second moments + rescaled, centered window and its Gram
    matrices (steps 1-2a of ``compute_update``, low_rank.rs:144-203)."""
    cap, d = w.draws.shape
    dtype = w.draws.dtype
    idx = jnp.arange(cap, dtype=jnp.int32)
    mask = (idx >= w.start) & (idx < w.write_pos)
    mf = mask.astype(dtype)[:, None]          # [cap, 1]
    n = jnp.sum(mf)

    draws = w.draws * mf
    grads = w.grads * mf

    # --- Step 1: per-dim rescale (low_rank.rs:144-203) ---
    ns = jnp.maximum(n, 1.0)
    draw_mean = jnp.sum(draws, axis=0) / ns
    grad_mean = jnp.sum(grads, axis=0) / ns
    draw_var = jnp.sum(jnp.square(draws - draw_mean[None, :]) * mf, axis=0) / ns
    grad_var = jnp.sum(jnp.square(grads - grad_mean[None, :]) * mf, axis=0) / ns
    sigma = jnp.sqrt(jnp.sqrt(draw_var / grad_var))
    mu = draw_mean + sigma * sigma * grad_mean

    x = (w.draws - mu[None, :]) / sigma[None, :] * mf   # rescaled draws
    g = w.grads * sigma[None, :] * mf                    # rescaled grads

    # Means of the rescaled values, then center (masked slots back to zero).
    x_mean = jnp.sum(x, axis=0) / ns
    g_mean = jnp.sum(g, axis=0) / ns
    x = (x - x_mean[None, :]) * mf
    g = (g - g_mean[None, :]) * mf

    # Gram matrices over the sample axis.  The per-sample SVD/QR pipeline of
    # an earlier version cost O(d * cap) iterative SVD work per refit; the
    # [d, d] Grams carry the same column space and sample covariance
    # (x.T x = U S^2 U^T), so one MXU matmul + a d x d eigh replaces the
    # [d, cap] SVD — the cap-sized axis now only ever appears inside matmuls.
    gram_x = x.T @ x
    gram_g = g.T @ g
    return dict(n=n, sigma=sigma, mu=mu, x_mean=x_mean, g_mean=g_mean,
                gram_x=gram_x, gram_g=gram_g)


def _refit_from_moments(m, transform, gamma, eigval_cutoff):
    """Steps 2b-5 of ``compute_update`` from (pooled or per-chain) moments."""
    d = m["sigma"].shape[0]
    dtype = m["sigma"].dtype
    sigma, mu = m["sigma"], m["mu"]
    x_mean, g_mean = m["x_mean"], m["g_mean"]
    gram_x, gram_g = m["gram_x"], m["gram_g"]

    # --- Step 2: joint subspace (low_rank.rs:80-87).  eigh of the Grams
    # yields the left singular vectors of the sample matrices; QR of the
    # concatenation orthonormalizes the joint span. ---
    _, u_draws = jnp.linalg.eigh(gram_x)                        # [d, d]
    _, u_grads = jnp.linalg.eigh(gram_g)
    subspace = jnp.concatenate([u_draws, u_grads], axis=1)      # [d, 2d]
    basis, _ = jnp.linalg.qr(subspace)                          # [d, d]
    r0 = basis.shape[1]

    # --- Step 3: regularized covariances + SPD mean (low_rank.rs:205-262);
    # x_proj x_proj^T == basis^T gram_x basis, no [r0, cap] intermediate. ---
    eye = jnp.eye(r0, dtype=dtype)
    cov_draws = basis.T @ gram_x @ basis / gamma + eye
    cov_grads = basis.T @ gram_g @ basis / gamma + eye
    mean_mat = _spd_mean(cov_draws, cov_grads)
    vals, vecs = jnp.linalg.eigh(mean_mat)                      # [r0], [r0, r0]

    # --- Step 4: eigenvalue cutoff filter with lam=1 padding ---
    selected = (vals > eigval_cutoff) | (vals < 1.0 / eigval_cutoff)
    vals_f = jnp.where(selected, vals, 1.0)
    vecs_full = basis @ vecs                                    # [d, r0]

    # --- Step 5: inner translation mu_lr (low_rank.rs:112-123) ---
    b = vecs_full @ ((vals_f - 1.0) * (vecs_full.T @ g_mean))
    mu_lr = x_mean + g_mean + b

    # Pad/truncate to the transform's static rank.
    r_static = transform.vecs.shape[1]
    if r0 < r_static:
        pad = r_static - r0
        vecs_full = jnp.concatenate(
            [vecs_full, jnp.zeros((d, pad), dtype)], axis=1)
        vals_f = jnp.concatenate([vals_f, jnp.ones(pad, dtype)])
    elif r0 > r_static:
        # Keep the most informative directions (largest |log lam|).
        order = jnp.argsort(-jnp.abs(jnp.log(vals_f)))[:r_static]
        vecs_full = vecs_full[:, order]
        vals_f = vals_f[order]

    finite = (jnp.all(jnp.isfinite(sigma)) & jnp.all(jnp.isfinite(mu))
              & jnp.all(jnp.isfinite(vals_f)) & jnp.all(jnp.isfinite(vecs_full))
              & jnp.all(jnp.isfinite(mu_lr)))
    # Degenerate windows (fewer samples than informative directions) can
    # produce non-positive eigenvalue estimates; skip those updates entirely.
    positive = jnp.all(vals_f > 0.0) & jnp.all(sigma > 0.0)
    changed = finite & positive & (m["n"] >= 3)

    return set_low_rank(transform, sigma, mu, vals_f, vecs_full, mu_lr,
                        changed=changed)


def _compute_update_impl(w, transform, gamma, eigval_cutoff):
    # Full-f32 matmuls throughout: bf16 default passes in the eigh/QR/Gram
    # pipeline produce a noisy whitening transform, measured as a 9.4%
    # post-warmup divergence rate on the 100-d low-rank config (0% with
    # full-f32 estimation).
    return _refit_from_moments(_window_moments(w), transform, gamma,
                               eigval_cutoff)


def pooled_compute_update(windows, transforms, gamma, eigval_cutoff,
                          axis_name=None):
    """Cross-chain pooled low-rank refit (no reference counterpart — the
    analog of the diag path's ``merge_running_variance`` pooling).

    All chains' windows act as one big sample set: moments and Gram matrices
    sum over the local chain axis (and the mesh ``chains`` axis via psum when
    ``axis_name`` is set), then ONE d x d eigendecomposition pipeline runs
    instead of one per chain, and every chain receives the shared transform.
    At C chains this cuts the refit's eigh/QR work by C while estimating from
    C x more samples.
    """
    with jax.default_matmul_precision("highest"):
        c = windows.draws.shape[0]
        moments = jax.vmap(_window_moments)(windows)

        def total(v):
            s = jnp.sum(v, axis=0)
            if axis_name is not None:
                s = jax.lax.psum(s, axis_name)
            return s

        n = total(moments["n"])
        ns = jnp.maximum(n, 1.0)
        # Count-weighted pooled moments; Grams are plain sums.  The pooled
        # sigma/mu rescale must be recomputed from pooled variances, so undo
        # the per-chain rescale by re-deriving from raw windows.
        idx = jnp.arange(windows.draws.shape[1], dtype=jnp.int32)
        mask = ((idx[None, :] >= windows.start[:, None])
                & (idx[None, :] < windows.write_pos[:, None]))
        mf = mask.astype(windows.draws.dtype)[..., None]   # [C, cap, 1]
        draw_sum = total(jnp.sum(windows.draws * mf, axis=1))
        grad_sum = total(jnp.sum(windows.grads * mf, axis=1))
        draw_mean = draw_sum / ns
        grad_mean = grad_sum / ns
        draw_var = total(jnp.sum(
            jnp.square(windows.draws - draw_mean[None, None, :]) * mf,
            axis=1)) / ns
        grad_var = total(jnp.sum(
            jnp.square(windows.grads - grad_mean[None, None, :]) * mf,
            axis=1)) / ns
        sigma = jnp.sqrt(jnp.sqrt(draw_var / grad_var))
        mu = draw_mean + sigma * sigma * grad_mean

        x = (windows.draws - mu[None, None, :]) / sigma[None, None, :] * mf
        g = windows.grads * sigma[None, None, :] * mf
        x_mean = total(jnp.sum(x, axis=1)) / ns
        g_mean = total(jnp.sum(g, axis=1)) / ns
        x = (x - x_mean[None, None, :]) * mf
        g = (g - g_mean[None, None, :]) * mf
        def mesh_sum(v):  # the einsum already sums the local chain axis
            return jax.lax.psum(v, axis_name) if axis_name is not None else v

        gram_x = mesh_sum(jnp.einsum("cki,ckj->ij", x, x))
        gram_g = mesh_sum(jnp.einsum("cki,ckj->ij", g, g))

        pooled = dict(n=n, sigma=sigma, mu=mu, x_mean=x_mean, g_mean=g_mean,
                      gram_x=gram_x, gram_g=gram_g)
        t0 = jax.tree.map(lambda v: v[0], transforms)
        t_new = _refit_from_moments(pooled, t0, gamma, eigval_cutoff)
        return jax.tree.map(
            lambda v: jnp.broadcast_to(v, (c,) + v.shape), t_new)


class LowRankStrategy:
    """Low-rank mass-matrix adaptation (nuts-rs ``LowRankMassMatrixStrategy``).

    Same protocol as ``chain.DiagStrategy``; the extra per-chain state is the
    draw/grad window.  Heavy refits (batched SVD/QR/eigh over all chains) run
    only at host-scheduled draw indices under a scalar ``lax.cond``.
    """

    ops = None  # set below to AFFINE_OPS (import-order safe)

    def __init__(self, config, settings):
        self.config = config
        self.lr: LowRankSettings = getattr(settings, "low_rank", LowRankSettings())
        self._num_tune = getattr(settings, "num_tune", 400)
        # Optional cross-chain pooled refits (the low-rank analog of the
        # diag path's merge_running_variance; beyond the reference).
        self.cross_chain = getattr(settings, "cross_chain_adaptation", False)
        self.axis_name = getattr(settings, "mesh_axis_name", None)

    def _rank(self, dim):
        return min(self.lr.max_rank or dim, dim)

    def make_transform(self, dim, dtype):
        return identity_transform(dim, dtype, rank=self._rank(dim))

    def init_extra(self, dim, num_tune, dtype, num_chains):
        cap = self.lr.window_capacity or num_tune
        w = new_window(cap, dim, dtype)
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (num_chains,) + x.shape), w)

    def init_mass_matrix(self, state):
        """add_draw(init) + diag-from-grad init (low_rank.rs:280-297)."""
        window = jax.vmap(push, in_axes=(0, 0, 0, None))(
            state.extra, state.pt.q, state.pt.g, True)
        transform = jax.vmap(init_diag_from_grad)(state.transform, state.pt.q,
                                                  state.pt.g)
        return state._replace(extra=window, transform=transform)

    def update_estimators(self, state, draw_q, draw_g, is_good,
                          logp=None, energy_error=None):
        window = jax.vmap(push)(state.extra, draw_q, draw_g, is_good)
        return state._replace(extra=window)

    def switch(self, state):
        return state._replace(extra=jax.vmap(switch)(state.extra))

    def adapt_update(self, state):
        if self.cross_chain:
            transform = pooled_compute_update(
                state.extra, state.transform, gamma=self.lr.gamma,
                eigval_cutoff=self.lr.eigval_cutoff,
                axis_name=self.axis_name)
        else:
            transform = jax.vmap(
                partial(compute_update, gamma=self.lr.gamma,
                        eigval_cutoff=self.lr.eigval_cutoff)
            )(state.extra, state.transform)
        return state._replace(transform=transform)


from ..transform.ops import AFFINE_OPS as _AFFINE_OPS  # noqa: E402

LowRankStrategy.ops = _AFFINE_OPS

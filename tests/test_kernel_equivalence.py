"""Deterministic tree-decision equivalence of the NUTS device kernel.

The device kernel (``kernels/nuts.py``'s while-loop) makes its tree
decisions with heavily optimized machinery:
trailing-zero span recovery, one-hot stack gathers, direction-form
(creation-order) U-turn reductions.  These tests validate those decisions
against a NAIVE reference tree builder that

* stores every point of the current subtree in an explicit Python list,
* runs the U-turn checks with the plain sorted-index criterion
  (``is_turning``) on the actual stored endpoints — the reference semantics
  of nuts-rs ``src/nuts.rs:148-161``, and
* consumes the *exact same uniform stream* as the kernel under test
  (its threefry calls replayed),

so depth / n_steps / selected index / divergence / turning must match
DETERMINISTICALLY, draw by draw — not just in distribution.  (The recursive
reference algorithm itself consumes randomness in a different order, so
cross-checking iterative-vs-recursive stays distributional by construction;
see PARITY.md deviation 2.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuts_rs_tpu.dynamics.hamiltonian import initialize_trajectory, KineticKind
from nuts_rs_tpu.dynamics.point import Point
from nuts_rs_tpu.kernels.nuts import NutsOptions, nuts_draw
from nuts_rs_tpu.transform.affine import identity_transform


# ---------------------------------------------------------------------------
# Naive reference tree builder (shared tree semantics, pluggable RNG/arith).
# ---------------------------------------------------------------------------

class NaivePoint:
    def __init__(self, z, v, zg, logp, ke, idx):
        self.z, self.v, self.zg = z, v, zg
        self.logp, self.ke, self.idx = logp, ke, idx

    def energy(self, logdet):
        return self.ke - (self.logp + logdet)


def naive_turning(a: NaivePoint, b: NaivePoint, xp):
    """Sorted-index scalar_prods3 criterion (transformed_hamiltonian.rs:617-638)."""
    lo, hi = (a, b) if a.idx <= b.idx else (b, a)
    dz = hi.z - lo.z
    return bool(xp.sum(dz * lo.v) < 0) or bool(xp.sum(dz * hi.v) < 0)


def naive_tree_draw(pt0, step_size, opts, uniforms, eval_z, logdet, xp,
                    max_err):
    """One NUTS draw with explicit subtree point lists.

    ``uniforms()`` yields (r_sel, r_acc, r_dir) per leapfrog iteration;
    ``eval_z(z)`` returns (logp, zg).  Mirrors the *semantics* of
    ``_tree_body`` with none of its stack machinery.
    """
    D = opts.maxdepth
    initial_energy = pt0.energy(logdet)
    direction = uniforms.initial_direction()
    p_minus = p_plus = pt0
    draw_main, logw_main = pt0, 0.0
    depth = 0
    subtree = []            # points of the current doubling, creation order
    draw_sub, logw_sub = None, -np.inf
    diverging = turning = False
    n_steps = 0
    sum_accept = 0.0
    edge = pt0

    while depth < D:
        r_sel, r_acc, r_dir = uniforms.next3()
        # --- leapfrog (naive, same arithmetic as the kernel) ---
        eps = direction * step_size
        v1 = edge.v + (eps / 2.0) * edge.zg
        z1 = edge.z + eps * v1
        logp1, zg1 = eval_z(z1)
        v2 = v1 + (eps / 2.0) * zg1
        ke1 = 0.5 * xp.sum(v2 * v2)
        new = NaivePoint(z1, v2, zg1, logp1, ke1, edge.idx + direction)
        err = float(new.energy(logdet) - initial_energy)
        diverged = (err > max_err) or not np.isfinite(err)
        n_steps += 1
        if not diverged:
            sum_accept += float(np.exp(min(-err, 0.0)))

        # --- progressive multinomial within the subtree ---
        logw_leaf = -err
        if not subtree:
            logw_sub = logw_leaf
            draw_sub = new
        else:
            logw_sub = np.logaddexp(logw_sub, logw_leaf)
            if np.log(float(r_sel)) < logw_leaf - logw_sub:
                draw_sub = new
        subtree.append(new)
        leaf = len(subtree) - 1

        # --- completed-span U-turn checks (nuts.rs:148-161 semantics) ---
        turning_int = False
        nxt = leaf + 1
        tz_next = D if nxt == 0 else (nxt & -nxt).bit_length() - 1
        for j in range(1, min(tz_next, D) + 1):
            s = nxt - (1 << j)           # span [s, s + 2^j - 1]
            a_first = subtree[s]
            a_last = subtree[s + (1 << (j - 1)) - 1]
            b_first = subtree[s + (1 << (j - 1))]
            b_last = new
            t = naive_turning(a_first, b_last, xp)
            if j >= 2:
                t = t or naive_turning(a_last, b_last, xp)
                t = t or naive_turning(a_first, b_first, xp)
            if t:
                turning_int = True
        subtree_complete = len(subtree) == (1 << depth)

        # --- top-level checks + biased acceptance ---
        far = p_minus if direction > 0 else p_plus
        near = p_plus if direction > 0 else p_minus
        t_outer = naive_turning(far, new, xp)
        t_near = naive_turning(near, new, xp)
        t_b0 = naive_turning(far, subtree[0], xp)
        turning_top = t_outer or (depth > 0 and (t_near or t_b0))

        do_merge = subtree_complete and not diverged and not turning_int
        if do_merge:
            if (logw_sub >= logw_main
                    or np.log(float(r_acc)) < logw_sub - logw_main):
                draw_main = draw_sub
            logw_main = np.logaddexp(logw_main, logw_sub)
            if direction > 0:
                p_plus = new
            else:
                p_minus = new
            depth += 1

        turned_now = turning_int or (do_merge and turning_top)
        if diverged:
            diverging = True
            break
        if turned_now:
            turning = True
            break

        if do_merge:
            subtree = []
            logw_sub = -np.inf
            draw_sub = None
            direction = 1 if float(r_dir) < 0.5 else -1
            edge = p_plus if direction > 0 else p_minus
        elif turning_int:  # unreachable: turning_int breaks above
            pass
        else:
            edge = new

    return dict(
        depth=depth,
        n_steps=n_steps,
        diverging=diverging,
        turning=turning,
        idx=draw_main.idx,
        z=draw_main.z,
        sum_accept=sum_accept,
        reached_maxdepth=(not diverging and not turning and depth >= D),
    )


# ---------------------------------------------------------------------------
# XLA kernel: replay the threefry stream of nuts_draw.
# ---------------------------------------------------------------------------

class ThreefryUniforms:
    """Replays nuts_draw's exact jax.random consumption order."""

    def __init__(self, key, dtype):
        key, self.key_mom, key_dir = jax.random.split(key, 3)
        self._key = key
        self._dir0 = float(jax.random.uniform(key_dir, dtype=dtype))
        self.dtype = dtype

    def momentum(self, dim):
        return jax.random.normal(self.key_mom, (dim,), self.dtype)

    def initial_direction(self):
        return 1 if self._dir0 < 0.5 else -1

    def next3(self):
        self._key, k_r = jax.random.split(self._key)
        r = jax.random.uniform(k_r, (3,), dtype=self.dtype)
        return float(r[0]), float(r[1]), float(r[2])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("step", [0.15, 0.4, 0.9])
def test_xla_kernel_matches_naive_tree(seed, step):
    dim = 4
    dtype = jnp.float64
    mu = jnp.asarray([1.0, -2.0, 0.5, 3.0], dtype)

    def logp_grad(q):
        return -0.5 * jnp.sum((q - mu) ** 2), -(q - mu)

    t = identity_transform(dim, dtype)._replace(
        stds=jnp.asarray([1.0, 2.0, 0.5, 1.5], dtype))
    t = t._replace(inv_stds=1.0 / t.stds,
                   logdet=jnp.sum(jnp.log(t.inv_stds)))
    opts = NutsOptions(maxdepth=6, max_energy_error=1000.0)

    q = jnp.asarray([0.3, -0.7, 1.2, 0.1], dtype)
    logp, g = logp_grad(q)
    z = (q - t.mean) * t.inv_stds
    zg = g * t.stds
    pt = Point(q=q, g=g, z=z, zg=zg, v=jnp.zeros_like(q), logp=logp,
               logdet=t.logdet, ke=jnp.zeros((), dtype),
               idx=jnp.zeros((), jnp.int32))

    draw_fn = jax.jit(lambda k, p: nuts_draw(k, p, t, jnp.asarray(step, dtype),
                                             logp_grad, opts))

    def eval_z(z1):
        q1 = z1 * t.stds + t.mean
        logp1, g1 = logp_grad(q1)
        return logp1, g1 * t.stds

    key = jax.random.key(seed)
    cur = pt
    for d in range(8):  # 8 sequential draws per seed
        key, k_draw = jax.random.split(key)
        got_pt, info = draw_fn(k_draw, cur)

        uni = ThreefryUniforms(k_draw, dtype)
        v0 = uni.momentum(dim)
        # initialize_trajectory resyncs z/zg from (q, g) through the
        # transform; replicate that rather than reusing the trajectory z.
        z0 = np.asarray((cur.q - t.mean) * t.inv_stds)
        zg0 = np.asarray(cur.g * t.stds)
        pt0 = NaivePoint(z0, np.asarray(v0), zg0, float(cur.logp),
                         0.5 * float(jnp.sum(v0 * v0)), 0)
        want = naive_tree_draw(pt0, step, opts, uni, eval_z,
                               float(t.logdet), np, opts.max_energy_error)

        label = (seed, step, d)
        assert int(info.depth) == want["depth"], label
        assert int(info.n_steps) == want["n_steps"], label
        assert bool(info.diverging) == want["diverging"], label
        assert bool(info.turning) == want["turning"], label
        assert int(info.idx_in_trajectory) == want["idx"], label
        assert bool(info.reached_maxdepth) == want["reached_maxdepth"], label
        np.testing.assert_allclose(np.asarray(got_pt.z), want["z"],
                                   rtol=1e-9, atol=1e-12, err_msg=str(label))
        np.testing.assert_allclose(float(info.sum_accept), want["sum_accept"],
                                   rtol=1e-7, atol=1e-9, err_msg=str(label))
        cur = got_pt

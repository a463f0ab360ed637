"""The XLA MCLMC kernel (``kernels/mclmc.py::mclmc_draw``) against a naive
replay.

The kernel runs its trajectory as one masked ``lax.while_loop`` with an
explicit fixed-depth halving stack (the reference's dynamic step-size retry,
nuts-rs ``src/mclmc.rs:242,274-359``).  The replay below consumes the same
threefry keys but runs plain Python control flow — ``if``/``else`` and a
Python-list stack — with numpy f64 arithmetic, so agreement checks the
masking and stack logic, not just the happy path.  Target: iid N(3, 1) under
the identity transform.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuts_rs_tpu.dynamics.hamiltonian import KineticKind, init_point_from_q
from nuts_rs_tpu.kernels.mclmc import MAX_HALVINGS, MclmcOptions, mclmc_draw
from nuts_rs_tpu.transform.affine import identity_transform

MU = 3.0


def _logp_grad(q):
    return -0.5 * jnp.sum((q - MU) ** 2), -(q - MU)


def _normal(key, d):
    return np.asarray(jax.random.normal(key, (d,), jnp.float64))


def _naive_draw(key, q0, v0, step, opts, resample):
    """One MCLMC draw by plain control flow; returns (q, v, stats)."""
    micro = opts.kind is KineticKind.MICROCANONICAL
    d = q0.shape[0]
    ell = opts.momentum_decoherence_length
    max_halvings = MAX_HALVINGS if opts.dynamic_step_size else 0

    def lg(q):
        return -0.5 * np.sum((q - MU) ** 2), -(q - MU)

    def esh(g, v, eps):
        gn = np.sqrt(g @ g)
        gh = g / gn
        alpha = v @ gh
        delta = eps * gn / (d - 1)
        zeta = math.exp(-delta)
        vr = (1 - zeta) * (1 + zeta + alpha * (1 - zeta)) * gh + 2 * zeta * v
        dke = (delta - math.log(2.0)
               + math.log(1 + alpha + (1 - alpha) * zeta * zeta)) * (d - 1)
        return vr / np.sqrt(vr @ vr), dke

    def refresh(v, ke, noise, half):
        if micro:
            nu = math.sqrt(math.expm1(2 * half / ell) / d)
            vr = v + nu * noise
            return vr / np.sqrt(vr @ vr), ke
        a = math.exp(-half / ell)
        vr = a * v + math.sqrt(1 - a * a) * noise
        return vr, 0.5 * vr @ vr

    key, k_mom, k_noise0 = jax.random.split(key, 3)
    v = _normal(k_mom, d) if resample else v0
    if resample and micro:
        v = v / np.sqrt(v @ v)
    q = q0
    logp, g = lg(q)
    ke = 0.0 if micro else 0.5 * v @ v
    e_init = ke - logp
    noise = _normal(k_noise0, d)
    n_base = int(min(max(round(opts.subsample_frequency * ell / step), 1), 1e6))
    max_err = opts.max_energy_error / n_base

    remaining, factor, stack = n_base, 1.0, []
    steps, time, diverged, halved = 0, 0.0, False, False
    while remaining > 0 and not diverged:
        key, k1, k2 = jax.random.split(key, 3)
        eps = step * factor
        vr, ke_r = refresh(v, ke, noise, eps / 2)
        base = ke_r - logp
        if micro:
            v1, dke1 = esh(g, vr, math.sqrt(d) * eps / 2)
            q1 = q + eps * math.sqrt(d) * v1
        else:
            v1 = vr + eps / 2 * g
            q1 = q + eps * v1
        logp1, g1 = lg(q1)
        if micro:
            v2, dke2 = esh(g1, v1, math.sqrt(d) * eps / 2)
            ke2 = ke_r + dke1 + dke2
        else:
            v2 = v1 + eps / 2 * g1
            ke2 = 0.5 * v2 @ v2
        err = (ke2 - logp1) - base
        bad = (abs(err) >= max_err * factor if micro
               else err > max_err * factor)
        if bad or not np.isfinite(err):
            # retry from the pre-refresh state with the same noise
            if len(stack) >= max_halvings:
                diverged = True
            else:
                stack.append(remaining)
                remaining, factor, halved = 2, factor * 0.5, True
            continue
        v, ke = refresh(v2, ke2, _normal(k1, d), eps / 2)
        q, logp, g = q1, logp1, g1
        noise = _normal(k2, d)
        remaining -= 1
        steps += 1
        time += factor * step
        while remaining == 0 and stack:
            remaining = stack.pop() - 1
            factor *= 2.0

    stats = {"diverging": diverged, "n_steps": steps,
             "energy_change": (ke - logp) - e_init,
             "average_step_size": time / max(steps, 1), "halved": halved}
    if diverged:
        # stay at the start, fully resampled momentum
        v = _normal(jax.random.fold_in(key, 1), d)
        if micro:
            v = v / np.sqrt(v @ v)
        q = q0
    return q, v, stats


def _kernel_draws(opts, step, num_draws, d=6, seed=1):
    """Run ``num_draws`` kernel draws and their naive replays side by side."""
    tr = identity_transform(d, jnp.float64)
    draw = jax.jit(lambda k, pt, s, r: mclmc_draw(
        k, pt, tr, s, _logp_grad, opts, r))
    rng = np.random.default_rng(seed)
    q = rng.normal(MU, 1.0, d)
    pt = init_point_from_q(jnp.asarray(q), tr, _logp_grad)
    v = np.zeros(d)
    rows = []
    for i in range(num_draws):
        key = jax.random.fold_in(jax.random.key(seed), i)
        resample = i == 0
        pt, info = draw(key, pt, jnp.float64(step), jnp.asarray(resample))
        q_n, v_n, st = _naive_draw(key, q, v, step, opts, resample)
        rows.append((pt, info, q_n, v_n, st))
        q, v = np.asarray(pt.q), np.asarray(pt.v)
    return rows


@pytest.mark.parametrize("max_err,kind,step", [
    (1000.0, KineticKind.MICROCANONICAL, 0.5),
    (0.05, KineticKind.MICROCANONICAL, 1.4),   # exercises the halving stack
    (1e-6, KineticKind.MICROCANONICAL, 2.5),   # gives up: resampled restarts
    (1000.0, KineticKind.EUCLIDEAN, 0.5),
])
def test_mclmc_xla_matches_naive_replay(max_err, kind, step):
    opts = MclmcOptions(kind=kind, max_energy_error=max_err)
    rows = _kernel_draws(opts, step, num_draws=6)
    for i, (pt, info, q_n, v_n, st) in enumerate(rows):
        msg = f"draw {i}"
        assert bool(info.diverging) == st["diverging"], msg
        assert int(info.num_steps) == st["n_steps"], msg
        np.testing.assert_allclose(np.asarray(pt.q), q_n, rtol=1e-9,
                                   atol=1e-10, err_msg=msg)
        np.testing.assert_allclose(np.asarray(pt.v), v_n, rtol=1e-9,
                                   atol=1e-10, err_msg=msg)
        np.testing.assert_allclose(float(info.energy_change),
                                   st["energy_change"], rtol=1e-8,
                                   atol=1e-9, err_msg=msg)
        np.testing.assert_allclose(float(info.average_step_size),
                                   st["average_step_size"], rtol=1e-12,
                                   err_msg=msg)
    if max_err < 1:
        assert any(st["halved"] for *_, st in rows)
    if max_err < 1e-3:
        assert any(st["diverging"] for *_, st in rows)


def test_mclmc_xla_nsteps_matches_schedule():
    """Without divergences every draw takes exactly round(F*L/eps) steps at
    the base step size."""
    opts = MclmcOptions(kind=KineticKind.MICROCANONICAL)
    for step in (0.3, 0.5, 0.7):
        for pt, info, *_ in _kernel_draws(opts, step, num_draws=4, d=10):
            assert not bool(info.diverging)
            assert int(info.num_steps) == round(3.0 / step)
            np.testing.assert_allclose(float(info.average_step_size), step,
                                       rtol=1e-12)


def test_mclmc_xla_divergences_recover():
    """A pathological threshold produces give-up divergences whose draws
    stay at the trajectory start with a fresh unit momentum, and the
    halvings shrink the realized step size."""
    opts = MclmcOptions(kind=KineticKind.MICROCANONICAL,
                        max_energy_error=1e-6)
    rows = _kernel_draws(opts, 2.5, num_draws=8, d=10)
    assert any(bool(info.diverging) for _, info, *_ in rows)
    prev_q = None
    for pt, info, *_ in rows:
        q = np.asarray(pt.q)
        assert np.isfinite(q).all()
        assert float(info.average_step_size) < 2.5
        if bool(info.diverging) and prev_q is not None:
            np.testing.assert_array_equal(q, prev_q)
            np.testing.assert_allclose(np.linalg.norm(np.asarray(pt.v)), 1.0)
        prev_q = q

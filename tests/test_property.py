"""Property-based tests over adversarial float inputs.

JAX analog of the reference's proptest suite
(nuts-rs ``src/math/util.rs:745-968`` + the pinned regressions in
``proptest-regressions/math/util.txt``): every fused kernel is checked against
an independent naive implementation over arbitrary f64 values INCLUDING
NaN/Inf/denormals.  Where the reference compares SIMD vs scalar with a 32-ULP
tolerance, here we compare jnp (XLA CPU, f64) vs numpy with tight relative
tolerances and exact NaN propagation.

Pinned regressions (the proptest-regressions analog) are the explicit
parametrized cases at the bottom of each section.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

# Adversarial inputs overflow/NaN by design; the assertions check the results.
pytestmark = pytest.mark.filterwarnings(
    "ignore::RuntimeWarning")

from nuts_rs_tpu.adapt.mass_matrix import (
    RunningVariance,
    add_sample,
    new_running_variance,
)
from nuts_rs_tpu.adapt.low_rank import _spd_mean
from nuts_rs_tpu.dynamics.hamiltonian import (
    KineticKind,
    _esh_momentum_update,
    is_turning,
    leapfrog,
)
from nuts_rs_tpu.dynamics.point import Point
from nuts_rs_tpu.transform.affine import (
    _lowrank_apply,
    identity_transform,
    to_transformed,
    to_untransformed,
)
from nuts_rs_tpu.utils.bits import trailing_zeros

# Arbitrary f64 including NaN, +-Inf, denormals, signed zeros — the same
# input space as proptest's `any::<f64>()`.
any_f64 = st.floats(width=64, allow_nan=True, allow_infinity=True,
                    allow_subnormal=True)
finite_f64 = st.floats(width=64, allow_nan=False, allow_infinity=False,
                       allow_subnormal=True, min_value=-1e100, max_value=1e100)


def vec(elems, min_size=1, max_size=8):
    return st.lists(elems, min_size=min_size, max_size=max_size).map(
        lambda l: np.asarray(l, np.float64))


_TINY = float(np.finfo(np.float64).tiny)


def assert_same(a, b, rtol=1e-12, atol=8 * _TINY):
    """Near-equality with NaN == NaN and signed-inf awareness.

    The default atol sits just above the subnormal boundary: XLA CPU runs
    with flush-to-zero, so each subnormal intermediate legitimately differs
    from numpy's by up to ``tiny``, and an accumulation over a handful of
    draws (e.g. ``var_sum`` += subnormal ``diff**2`` terms whose numpy sum
    rounds up to a small NORMAL number) by a few ``tiny`` (the analog of the
    reference proptests' 32-ULP slack)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)


# ---------------------------------------------------------------------------
# RunningVariance.add_sample vs a naive numpy replication of the reference's
# nonstandard accumulation (cpu_math.rs:605-631).
# ---------------------------------------------------------------------------

def naive_add_sample(mean, var_sum, count, value, include=True):
    if not include:
        return mean, var_sum, count + 0.0
    count = count + 1.0
    if count == 1.0:
        return value.copy(), var_sum + 0.0, count
    diff = value - mean
    return mean + diff / count, var_sum + diff * diff, count


@settings(max_examples=80, deadline=None)
@given(st.lists(vec(any_f64, min_size=3, max_size=3), min_size=1, max_size=6),
       st.booleans())
def test_add_sample_matches_naive(samples, include_last):
    rv = new_running_variance(3, jnp.float64)
    mean, var_sum, count = (np.zeros(3), np.zeros(3), 0.0)
    for i, s in enumerate(samples):
        include = include_last or i < len(samples) - 1
        rv = add_sample(rv, jnp.asarray(s), include)
        mean, var_sum, count = naive_add_sample(mean, var_sum, count, s,
                                                include)
    assert_same(rv.mean, mean)
    assert_same(rv.var_sum, var_sum)
    assert float(rv.count) == count


@pytest.mark.parametrize("case", [
    # pinned regressions: denormal, inf-cancel, NaN poisoning, -0.0
    [np.array([5e-324, -5e-324, 0.0])] * 3,
    [np.array([np.inf, -np.inf, 1.0]), np.array([1.0, 1.0, 1.0])],
    [np.array([np.nan, 0.0, -0.0])],
    [np.array([-0.0, -0.0, -0.0]), np.array([0.0, -0.0, 0.0])],
    [np.array([1e308, 1e308, -1e308]), np.array([-1e308, 1e308, 1e308])],
])
def test_add_sample_regressions(case):
    rv = new_running_variance(3, jnp.float64)
    mean, var_sum, count = (np.zeros(3), np.zeros(3), 0.0)
    for s in case:
        rv = add_sample(rv, jnp.asarray(s), True)
        mean, var_sum, count = naive_add_sample(mean, var_sum, count, s)
    assert_same(rv.mean, mean)
    assert_same(rv.var_sum, var_sum)


# ---------------------------------------------------------------------------
# is_turning vs the naive sorted scalar_prods3 form
# (transformed_hamiltonian.rs:617-638).
# ---------------------------------------------------------------------------

def naive_is_turning(z1, v1, i1, z2, v2, i2):
    if i1 > i2:
        (z1, v1), (z2, v2) = (z2, v2), (z1, v1)
    dz = z2 - z1
    a = float(np.sum(dz * v1))
    b = float(np.sum(dz * v2))
    return (a < 0.0) or (b < 0.0)


@settings(max_examples=80, deadline=None)
@given(vec(any_f64, 4, 4), vec(any_f64, 4, 4), st.integers(-20, 20),
       vec(any_f64, 4, 4), vec(any_f64, 4, 4), st.integers(-20, 20))
def test_is_turning_matches_naive(z1, v1, i1, z2, v2, i2):
    got = bool(is_turning(jnp.asarray(z1), jnp.asarray(v1), jnp.int32(i1),
                          jnp.asarray(z2), jnp.asarray(v2), jnp.int32(i2)))
    # NaN dots: comparisons with NaN are False in both impls by IEEE.
    want = naive_is_turning(z1, v1, i1, z2, v2, i2)
    assert got == want


@pytest.mark.parametrize("z1,v1,z2,v2", [
    (np.array([np.nan, 0.0]), np.ones(2), np.zeros(2), np.ones(2)),
    (np.array([np.inf, -np.inf]), np.ones(2), np.zeros(2), np.ones(2)),
    (np.array([-0.0, 0.0]), np.array([0.0, -0.0]), np.zeros(2), np.zeros(2)),
])
def test_is_turning_regressions(z1, v1, z2, v2):
    got = bool(is_turning(jnp.asarray(z1), jnp.asarray(v1), jnp.int32(0),
                          jnp.asarray(z2), jnp.asarray(v2), jnp.int32(1)))
    assert got == naive_is_turning(z1, v1, 0, z2, v2, 1)


# ---------------------------------------------------------------------------
# Euclidean leapfrog vs naive numpy (transformed_hamiltonian.rs:524-615),
# including divergence classification on non-finite energies.
# ---------------------------------------------------------------------------

def _mk_point(z, v, dtype=jnp.float64):
    z = jnp.asarray(z, dtype)
    v = jnp.asarray(v, dtype)
    return Point(q=z, g=-z, z=z, zg=-z, v=v,
                 logp=-0.5 * jnp.sum(z * z),
                 logdet=jnp.zeros((), dtype),
                 ke=0.5 * jnp.sum(v * v),
                 idx=jnp.zeros((), jnp.int32))


def _std_normal_logp(q):
    return -0.5 * jnp.sum(q * q), -q


@settings(max_examples=60, deadline=None)
@given(vec(finite_f64, 3, 3), vec(finite_f64, 3, 3),
       st.floats(1e-8, 10.0), st.sampled_from([1, -1]))
def test_leapfrog_euclidean_matches_naive(z, v, step, direction):
    t = identity_transform(3, jnp.float64)
    pt = _mk_point(z, v)
    res = leapfrog(pt, jnp.int32(direction), jnp.asarray(step), t,
                   _std_normal_logp, KineticKind.EUCLIDEAN,
                   energy_baseline=pt.energy, max_energy_error=1000.0)
    eps = direction * step
    v1 = v + (eps / 2.0) * (-z)
    z1 = z + eps * v1
    v2 = v1 + (eps / 2.0) * (-z1)
    energy = 0.5 * np.sum(v2 * v2) + 0.5 * np.sum(z1 * z1)
    err = energy - float(pt.energy)
    assert_same(res.point.z, z1, rtol=1e-12, atol=1e-300)
    assert_same(res.point.v, v2, rtol=1e-12, atol=1e-300)
    if np.isfinite(err):
        np.testing.assert_allclose(float(res.energy_error), err, rtol=1e-9,
                                   atol=1e-9)
    else:
        assert bool(res.diverging)
    assert int(res.point.idx) == direction


def test_leapfrog_nonfinite_diverges():
    # NaN/Inf positions must classify as divergence, never crash (the
    # LogpError recoverability contract, math.rs:9-13).
    t = identity_transform(2, jnp.float64)
    for bad in (np.nan, np.inf, -np.inf):
        pt = _mk_point(np.array([bad, 0.0]), np.ones(2))
        res = leapfrog(pt, jnp.int32(1), jnp.asarray(0.5), t,
                       _std_normal_logp, KineticKind.EUCLIDEAN,
                       energy_baseline=jnp.zeros(()), max_energy_error=1000.0)
        assert bool(res.diverging)


# ---------------------------------------------------------------------------
# ESH momentum update: formula vs naive numpy + unit-norm invariant
# (math.rs:188-204, cpu_math.rs:505-551).
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(vec(st.floats(-1e3, 1e3), 4, 4), vec(st.floats(-10, 10), 4, 4),
       st.floats(1e-6, 2.0))
def test_esh_momentum_update_matches_naive(g, v_raw, step):
    if np.sum(g * g) < 1e-20 or np.sum(v_raw * v_raw) < 1e-20:
        return
    v = v_raw / np.sqrt(np.sum(v_raw * v_raw))
    v_new, dke = _esh_momentum_update(jnp.asarray(g), jnp.asarray(v),
                                      jnp.asarray(step))
    n = len(g)
    gn = np.sqrt(np.sum(g * g))
    ghat = g / gn
    alpha = np.sum(v * ghat)
    delta = step * gn / (n - 1)
    zeta = np.exp(-delta)
    vr = ghat * (1 - zeta) * (1 + zeta + alpha * (1 - zeta)) + 2 * zeta * v
    vexp = vr / np.sqrt(np.sum(vr * vr))
    dke_exp = (delta - np.log(2.0)
               + np.log1p(alpha + (1 - alpha) * zeta * zeta)) * (n - 1)
    assert_same(v_new, vexp, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(dke), dke_exp, rtol=1e-9, atol=1e-12)
    # invariant: result stays on the unit sphere
    np.testing.assert_allclose(float(jnp.sum(v_new * v_new)), 1.0, rtol=1e-10)


# ---------------------------------------------------------------------------
# Low-rank transform: _lowrank_apply vs naive, and round-trip invariants
# (low_rank.rs:95-110, math.rs:131).
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 3))
def test_lowrank_apply_matches_naive_and_roundtrips(seed, rank):
    rng = np.random.default_rng(seed)
    d = 6
    a = rng.normal(size=(d, d))
    qmat, _ = np.linalg.qr(a)
    u = qmat[:, :rank]
    vals = np.exp(rng.normal(size=rank))
    rhs = rng.normal(size=d) * np.exp(rng.normal())
    got = _lowrank_apply(jnp.asarray(u), jnp.asarray(vals), jnp.asarray(rhs))
    want = rhs + u @ ((vals - 1.0) * (u.T @ rhs))
    assert_same(got, want, rtol=1e-10, atol=1e-12)
    # (I + U(D-1)U^T)(I + U(1/D-1)U^T) = I for orthonormal U
    back = _lowrank_apply(jnp.asarray(u), jnp.asarray(1.0 / vals), got)
    assert_same(back, rhs, rtol=1e-8, atol=1e-10)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_affine_transform_roundtrip(seed):
    rng = np.random.default_rng(seed)
    d, rank = 5, 2
    t = identity_transform(d, jnp.float64, rank=rank)
    qmat, _ = np.linalg.qr(rng.normal(size=(d, d)))
    vals_sqrt = np.exp(rng.normal(size=rank))
    t = t._replace(
        mean=jnp.asarray(rng.normal(size=d)),
        stds=jnp.asarray(np.exp(rng.normal(size=d))),
        inv_stds=1.0 / jnp.asarray(np.exp(0.0)),  # overwritten below
        vecs=jnp.asarray(qmat[:, :rank]),
        vals_sqrt=jnp.asarray(vals_sqrt),
        vals_sqrt_inv=jnp.asarray(1.0 / vals_sqrt),
        mu_lr=jnp.asarray(rng.normal(size=d)),
    )
    t = t._replace(inv_stds=1.0 / t.stds)
    q = jnp.asarray(rng.normal(size=d) * 3.0)
    z = to_transformed(t, q)
    q2 = to_untransformed(t, z)
    assert_same(q2, q, rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# _spd_mean: defining property C @ G @ C = D and the diagonal case
# (low_rank.rs:237-262 + its unit test).
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_spd_mean_defining_property(seed):
    rng = np.random.default_rng(seed)
    r = 4
    a = rng.normal(size=(r, r))
    b = rng.normal(size=(r, r))
    cov_d = a @ a.T + 0.1 * np.eye(r)
    cov_g = b @ b.T + 0.1 * np.eye(r)
    c = np.asarray(_spd_mean(jnp.asarray(cov_d), jnp.asarray(cov_g)))
    np.testing.assert_allclose(c @ cov_g @ c, cov_d, rtol=1e-7, atol=1e-8)
    # symmetric positive definite result
    np.testing.assert_allclose(c, c.T, rtol=1e-9, atol=1e-10)
    assert np.linalg.eigvalsh(c).min() > 0


def test_spd_mean_diagonal_case():
    d_draws = np.array([4.0, 9.0, 1.0])
    d_grads = np.array([1.0, 4.0, 16.0])
    c = np.asarray(_spd_mean(jnp.diag(jnp.asarray(d_draws)),
                             jnp.diag(jnp.asarray(d_grads))))
    np.testing.assert_allclose(np.diag(c), np.sqrt(d_draws / d_grads),
                               rtol=1e-10)


# ---------------------------------------------------------------------------
# trailing_zeros vs Python bit twiddling over the int32 range.
# ---------------------------------------------------------------------------

@settings(max_examples=100, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 31))
def test_trailing_zeros(x, cap):
    got = int(trailing_zeros(jnp.int32(x), cap))
    want = cap if x == 0 else (x & -x).bit_length() - 1
    assert got == want


@pytest.mark.parametrize("x,cap,expect", [
    (0, 10, 10), (1, 10, 0), (2, 10, 1), (1 << 30, 31, 30),
    (2**31 - 1, 10, 0), (6, 3, 1),
])
def test_trailing_zeros_regressions(x, cap, expect):
    assert int(trailing_zeros(jnp.int32(x), cap)) == expect


def test_uturn_row_index_derivation():
    """Number-theoretic fact behind the NUTS kernel's U-turn row lookups
    (kernels/nuts.py, trailing-zero rows): for a new leaf count
    n = leaf+1 with t = tz(n), every active check level j (1 <= j <= t)
    reads row rb = tz(n - 2^(j-1)) == j-1 ALWAYS, and row
    ra = tz(n - 2^j) == j for every j < t — i.e. only the boundary level
    j == t needs a dynamic row."""
    def tz(x):
        return (x & -x).bit_length() - 1 if x else 64

    for n in range(1, 1 << 13):
        t = tz(n)
        for j in range(1, t + 1):
            assert tz(n - (1 << (j - 1))) == j - 1
            if j < t:
                assert tz(n - (1 << j)) == j
            else:
                assert n - (1 << j) == 0 or tz(n - (1 << j)) > j

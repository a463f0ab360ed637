"""``chip_smoke.py``'s contract and helpers, checked without a card.

The script itself runs on the GPU; here it must refuse the CPU, and its
reference computations (Laplace approximation, MCSE check, gradient error)
and output format are checked on small inputs.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_ok_line(stdout):
    return any('"ok"' in line for line in stdout.splitlines())


def test_refuses_cpu_without_ok_line():
    out = _run(REPO, REPO / "chip_smoke.py")
    assert out.returncode != 0
    assert not _has_ok_line(out.stdout)
    assert "needs a GPU" in out.stderr


def test_fails_alone_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert not _has_ok_line(out.stdout)


@pytest.mark.parametrize("environ,expect", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}, None),
    ({}, str(REPO / ".jax_cache")),
])
def test_compile_cache_dir(environ, expect):
    assert chip_smoke.compile_cache_dir(environ) == expect


def test_last_line_format():
    line = chip_smoke.last_line("NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_laplace_reference_recovers_known_map():
    """Labels drawn from a known weight vector: Newton's MAP zeroes the
    log-density gradient, lies near the generating weights, and the
    covariance is the inverse Hessian."""
    rng = np.random.default_rng(3)
    n, d = 4000, 4
    x = rng.normal(size=(n, d))
    w_true = np.array([0.8, -0.5, 0.3, 0.0])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-x @ w_true))).astype(float)
    w_map, cov = chip_smoke.laplace_reference(x, y)
    _, g = chip_smoke.logreg_logp_grad_np(x, y, w_map)
    assert np.max(np.abs(g)) < 1e-8
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(w_map - w_true) < 4 * sd)
    # covariance = inverse of the negative log-density Hessian (finite
    # differences of the analytic gradient)
    eps = 1e-5
    hess = np.stack([
        (chip_smoke.logreg_logp_grad_np(x, y, w_map + eps * e)[1]
         - chip_smoke.logreg_logp_grad_np(x, y, w_map - eps * e)[1])
        / (2 * eps) for e in np.eye(d)])
    np.testing.assert_allclose(np.linalg.inv(-hess), cov, rtol=1e-5)


@pytest.mark.parametrize("shift,ok", [(0.0, True), (0.05, False)])
def test_mcse_check(shift, ok):
    """iid N(3, 1) draws: the true mean passes, a mean off by 0.05 (far
    beyond 5 MCSE of 1e5 draws) fails."""
    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 1.0, size=(100_000, 3))
    check = chip_smoke.mcse_check(x.mean(0) + shift, x.std(0),
                                  np.full(3, 1e5), 3.0)
    assert check["ok"] is ok
    assert check["limit"] == 5.0


def test_grad_rel_err_is_normwise_worst_case():
    g_ref = np.array([[3.0, 4.0], [1.0, 0.0]])
    g = g_ref + np.array([[0.0, 0.5], [0.0, 0.01]])
    assert chip_smoke.grad_rel_err(g, g_ref) == pytest.approx(0.1)

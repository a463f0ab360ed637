"""Unrecoverable logp-error semantics (reference: LogpError::is_recoverable,
src/math/math.rs:9-13; abort + finalize src/sampler.rs:1202-1207,1452-1457).

A permanently failing logp (NaN beyond an impossibly tight region) must end
the run early with ChainFailedError, per-chain errors in ChainProgress, and a
FINALIZED partial trace riding on the exception — instead of spinning for the
full draw budget emitting garbage.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import nuts_rs_tpu as nt
from nuts_rs_tpu.models.model import Model
from nuts_rs_tpu.parallel.axis import dsum


def _nan_wall_model(dim=4):
    """logp is finite ONLY at bit-exact zero (the init point): every leapfrog
    proposal q + eps*v is nonzero no matter how small adaptation drives eps,
    returns NaN, diverges, and the chain can never move — the batched-kernel
    analog of an unrecoverable LogpError (a permanently failing solver)."""

    def logp(q):
        base = -0.5 * dsum(jnp.square(q))
        bad = jnp.any(q != 0.0)
        return jnp.where(bad, jnp.nan, base)

    return Model(logp_fn=logp, dim=dim, name="nan_wall")


def test_unrecoverable_chain_raises_with_partial_trace():
    model = _nan_wall_model()
    settings = nt.DiagNutsSettings(
        num_tune=200, num_draws=200, num_chains=4, seed=3)
    sampler = nt.Sampler(
        model, settings, chunk_size=32,
        init_positions=np.zeros((4, model.dim)), fail_after=48)
    with pytest.raises(nt.ChainFailedError) as exc_info:
        sampler.run()
    err = exc_info.value
    # every chain is stuck at the origin -> all fail
    assert err.chains == [0, 1, 2, 3]
    # the run stopped long before the 400-draw budget
    assert sampler._next_draw < 200
    # per-chain error surfaced in ChainProgress
    for prog in sampler.progress:
        assert prog.failed
        assert "unrecoverable" in prog.error
    # traces were finalized despite the failure (partial draws present)
    trace = err.trace
    assert trace is not None
    pos = trace.warmup_posterior["position"]
    assert pos.shape[0] == 4 and pos.shape[1] >= 48


def test_wait_timeout_raises_on_failure():
    model = _nan_wall_model()
    settings = nt.DiagNutsSettings(
        num_tune=100, num_draws=100, num_chains=2, seed=0)
    sampler = nt.Sampler(
        model, settings, chunk_size=32,
        init_positions=np.zeros((2, model.dim)), fail_after=40)
    with pytest.raises(nt.ChainFailedError):
        sampler.wait_timeout(600.0)


def test_healthy_model_untouched_by_detector():
    """A well-behaved model must never trip the detector (moves reset the
    streak), and fail_after=None disables it entirely."""
    from nuts_rs_tpu.models.gaussian import normal_logp

    model = normal_logp(3, mu=0.0)
    settings = nt.DiagNutsSettings(
        num_tune=60, num_draws=60, num_chains=4, seed=1)
    sampler = nt.Sampler(model, settings, chunk_size=30, fail_after=10)
    trace = sampler.run()
    assert not any(p.failed for p in sampler.progress)
    assert trace.posterior["position"].shape[1] == 60


def test_detector_streak_resets_across_chunks():
    """Streak accounting is exact across chunk boundaries: a divergent
    stuck run split over two chunks still accumulates."""
    model = _nan_wall_model(dim=2)
    settings = nt.DiagNutsSettings(
        num_tune=100, num_draws=100, num_chains=2, seed=7)
    sampler = nt.Sampler(
        model, settings, chunk_size=16,
        init_positions=np.zeros((2, 2)), fail_after=24)  # 1.5 chunks
    with pytest.raises(nt.ChainFailedError):
        sampler.run()
    assert sampler._next_draw <= 48  # detected shortly after 24 draws


def _fault(*_a, **_k):
    raise RuntimeError("UNAVAILABLE: device worker process crashed or restarted."
                       " This can be caused by a kernel fault.")


def test_auto_recover_replays_from_chunk_boundary():
    """Device-fault auto-recovery: a chunk that dies with a worker-crash
    error is replayed from the last completed-chunk snapshot with a halved
    launch group; the finished trace has every draw exactly once."""
    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(3, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=20, num_draws=20, num_chains=8,
                                   seed=3)
    s = nt.Sampler(model, settings, chunk_size=10, auto_recover=2)
    s.run_next_chunk()  # one clean chunk -> snapshot at draw 10
    real = list(s._phase_runners)
    s._phase_runners = [(a, b, _fault) for a, b, _ in real]
    with pytest.warns(RuntimeWarning, match="device fault"):
        trace = s.run()  # recovery rebuilds the REAL runners and replays
    assert s.max_chains_per_launch == 4  # halved from the full 8
    assert s._recover_left == 1
    pos = np.asarray(trace.posterior["position"])
    assert pos.shape == (8, 20, 3) and np.isfinite(pos).all()
    # every draw exactly once: counts match an unperturbed run, and the
    # draws agree to float-reassociation noise (split launches may
    # reassociate reductions)
    t2 = nt.sample(model, settings, chunk_size=10)
    np.testing.assert_array_equal(
        np.asarray(trace.sample_stats["n_steps"]),
        np.asarray(t2.sample_stats["n_steps"]))
    np.testing.assert_allclose(pos, np.asarray(t2.posterior["position"]),
                               rtol=1e-6, atol=1e-8)


def test_auto_recover_budget_and_error_filter():
    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(2, mu=0.0)
    settings = nt.DiagNutsSettings(num_tune=8, num_draws=8, num_chains=4,
                                   seed=0)
    # non-device errors propagate immediately, budget untouched
    s = nt.Sampler(model, settings, chunk_size=8, auto_recover=2)
    s._phase_runners = [
        (a, b, lambda *_: (_ for _ in ()).throw(ValueError("user bug")))
        for a, b, _ in s._phase_runners]
    with pytest.raises(ValueError, match="user bug"):
        s.run_next_chunk()
    assert s._recover_left == 2
    # feature off: device-fault errors propagate
    s2 = nt.Sampler(model, settings, chunk_size=8)
    s2._phase_runners = [(a, b, _fault) for a, b, _ in s2._phase_runners]
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        s2.run_next_chunk()
    # exhausted budget: the fault propagates after N replays (pin the
    # faulting runners past recovery's runner rebuild)
    s3 = nt.Sampler(model, settings, chunk_size=8, auto_recover=1)
    s3._phase_runners = [(a, b, _fault) for a, b, _ in s3._phase_runners]
    s3._build_phase_runners = lambda fresh=False: None
    with pytest.warns(RuntimeWarning, match="device fault"):
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            s3.run_next_chunk()
    assert s3._recover_left == 0


def test_auto_recover_spills_snapshot_when_device_stays_dead(tmp_path,
                                                             monkeypatch):
    """When the reconnect probe keeps failing (in-process reconnection after
    a hard worker crash is impossible on some platforms), the snapshot is
    spilled to recovery_path in checkpoint format and DeviceLostError tells
    the user to resume in a fresh process — which must produce the remaining
    draws bit-identically to an uninterrupted run."""
    from nuts_rs_tpu.models import gaussian
    from nuts_rs_tpu.sampler import DeviceLostError

    model = gaussian.normal_logp(3, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=20, num_draws=20, num_chains=4,
                                   seed=7)
    path = str(tmp_path / "recover.npz")
    s = nt.Sampler(model, settings, chunk_size=10, auto_recover=2,
                   recovery_path=path)
    s.run_next_chunk()  # snapshot at draw 10
    s._phase_runners = [(a, b, _fault) for a, b, _ in s._phase_runners]
    # dead device: the probe inside _maybe_recover must keep failing
    monkeypatch.setattr("jax.block_until_ready",
                        lambda _x: _fault())
    monkeypatch.setattr("time.sleep", lambda _s: None)
    with pytest.warns(RuntimeWarning, match="device fault"):
        with pytest.raises(DeviceLostError, match="restore"):
            s.run_next_chunk()
    assert os.path.exists(path)

    # "fresh process": a new Sampler with the same settings resumes
    s2 = nt.Sampler(model, settings, chunk_size=10)
    s2.restore(path)
    assert s2._next_draw == 10
    while not s2.finished:
        s2.run_next_chunk()
    resumed = s2.trace.finalize()

    clean = nt.sample(model, settings, chunk_size=10)
    np.testing.assert_array_equal(
        np.asarray(resumed.posterior["position"]),
        np.asarray(clean.posterior["position"]))


def test_auto_launch_probe_full_batch_when_no_fault():
    """max_chains_per_launch="auto" on a healthy device resolves to one
    full-batch launch (no split) and samples normally."""
    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(3, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=20, num_draws=20, num_chains=4,
                                   seed=7)
    s = nt.Sampler(model, settings, chunk_size=20,
                   max_chains_per_launch="auto")
    trace = s.run()
    assert s.max_chains_per_launch is None
    clean = nt.sample(model, settings, chunk_size=20)
    np.testing.assert_array_equal(
        np.asarray(trace.posterior["position"]),
        np.asarray(clean.posterior["position"]))


def test_auto_launch_probe_halves_on_kernel_fault(monkeypatch):
    """The probe halves the launch size on a (injected) device kernel fault
    until a launch survives, then runs split launches without the user
    supplying a divisor (VERDICT r3 task 6: SV at 128 chains must run
    without a magic number)."""
    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(3, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=20, num_draws=20, num_chains=8,
                                   seed=7)
    s = nt.Sampler(model, settings, chunk_size=20,
                   max_chains_per_launch="auto")

    def inject():
        # Fault any launch with more than 4 chains — the shape-triggered
        # crash class, minus the dead worker.
        wrapped = []
        for a, b, r in s._phase_runners:
            def f(state, flags, r=r):
                if state.pt.q.shape[0] > 4:
                    raise RuntimeError("XLA kernel fault (injected)")
                return r(state, flags)
            wrapped.append((a, b, f))
        s._phase_runners = wrapped

    orig_build = s._build_phase_runners

    def build_and_inject(fresh=False):
        orig_build(fresh=fresh)
        inject()

    monkeypatch.setattr(s, "_build_phase_runners", build_and_inject)
    monkeypatch.setattr("time.sleep", lambda _s: None)
    inject()
    with pytest.warns(RuntimeWarning, match="launch-size probe"):
        trace = s.run()
    assert s.max_chains_per_launch == 4

    # Split launches are bit-transparent: same draws as an unsplit run.
    clean = nt.sample(model, settings, chunk_size=20)
    np.testing.assert_array_equal(
        np.asarray(trace.posterior["position"]),
        np.asarray(clean.posterior["position"]))


def test_auto_launch_probe_validation():
    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(3)
    settings = nt.DiagNutsSettings(num_tune=10, num_draws=10, num_chains=4)
    with pytest.raises(ValueError, match="progress_tick"):
        nt.Sampler(model, settings, max_chains_per_launch="auto",
                   progress_tick=1)

"""Sampler control-surface parity tests.

Covers the reference's controller API beyond plain ``run``:
``sample_sequentially`` as a true lazy iterator (src/sampler.rs:994-1005),
``wait_timeout``/``abort`` (src/sampler.rs:1516-1542), and ``inspect()``
returning a readable snapshot of a live Zarr trace
(src/storage/core.rs:28-33).
"""

import numpy as np
import pytest

import nuts_rs_tpu as nt
from nuts_rs_tpu.models import gaussian


def test_sample_sequentially_lazy_and_complete():
    model = gaussian.normal_logp(3, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=20, num_draws=30, seed=4)
    it = nt.sample_sequentially(model, settings, start=np.zeros(3), draws=50,
                                chunk_size=10)
    rows = list(it)
    assert len(rows) == 50
    pos, prog = rows[0]
    assert pos.shape == (3,)
    assert prog["tuning"] is True and prog["draw"] == 0
    assert rows[19][1]["tuning"] is True
    assert rows[20][1]["tuning"] is False
    assert rows[-1][1]["draw"] == 49
    assert all(np.isfinite(p).all() for p, _ in rows)
    # num_steps/step_size mirror the reference's Progress fields
    assert prog["num_steps"] >= 1 and prog["step_size"] > 0


def test_sample_sequentially_is_lazy():
    # Consuming 3 draws with chunk_size=10 must launch exactly one chunk.
    model = gaussian.normal_logp(3, mu=0.0)
    settings = nt.DiagNutsSettings(num_tune=50, num_draws=50, seed=8)
    it = nt.sample_sequentially(model, settings, start=np.zeros(3), draws=100,
                                chunk_size=10)
    launched = []
    for i, (pos, prog) in enumerate(it):
        launched.append(prog["draw"])
        if i == 2:
            break
    assert launched == [0, 1, 2]
    # generator abandoned after 3 draws: no error, no full run


def test_sample_sequentially_matches_batched():
    # Same seed, same chunking -> identical draws to the batched API.
    model = gaussian.normal_logp(3, mu=2.0)
    settings = nt.DiagNutsSettings(num_tune=20, num_draws=30, num_chains=1,
                                   seed=4)
    start = np.full(3, 0.5)
    seq = [p for p, pr in nt.sample_sequentially(
        model, settings, start=start, draws=50, seed=4, chunk_size=25)
        if not pr["tuning"]]
    batched = nt.sample(model, settings, init_positions=start[None, :],
                        chunk_size=25)
    np.testing.assert_array_equal(np.stack(seq),
                                  batched.posterior["position"][0])


def test_wait_timeout_and_resume():
    model = gaussian.normal_logp(4, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=40, num_draws=40, num_chains=2,
                                   seed=6)
    sam = nt.Sampler(model, settings, chunk_size=10)
    # zero timeout: returns None without finishing
    out = sam.wait_timeout(0.0)
    assert out is None
    assert not sam.finished
    # generous timeout: completes and finalizes
    trace = sam.wait_timeout(600.0)
    assert trace is not None
    assert trace.posterior["position"].shape == (2, 40, 4)


def test_abort_returns_partial_snapshot():
    model = gaussian.normal_logp(4, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=40, num_draws=40, num_chains=2,
                                   seed=6)
    sam = nt.Sampler(model, settings, chunk_size=10)
    sam.run_next_chunk()
    sam.run_next_chunk()
    snap = sam.abort()
    # memory backend: a Trace-like object built from what was recorded
    assert snap.warmup_posterior["position"].shape == (2, 20, 4)
    # aborted samplers refuse to run() further
    with pytest.raises(RuntimeError):
        sam.run()


def test_zarr_inspect_partial(tmp_path):
    from nuts_rs_tpu.storage.zarr import ZarrConfig

    model = gaussian.normal_logp(3, mu=0.0)
    settings = nt.DiagNutsSettings(num_tune=30, num_draws=50, num_chains=2,
                                   seed=7)
    storage = ZarrConfig(str(tmp_path / "trace.zarr"), chunk_draws=10,
                         async_writes=False)
    sam = nt.Sampler(model, settings, storage=storage, chunk_size=25)
    sam.run_next_chunk()  # draws 0..24 (all warmup + 0 posterior? 25 > 30 no)
    snap = sam.inspect()
    # 25 warmup draws seen; only full 10-draw chunks are on disk -> 20
    w = snap["warmup_posterior"]["position"]
    assert w.shape == (2, 20, 3)
    assert np.isfinite(w).all()
    sam.run_next_chunk()  # through draw 49: warmup complete, 20 posterior
    snap = sam.inspect()
    assert snap["warmup_posterior"]["position"].shape == (2, 30, 3)
    assert snap["posterior"]["position"].shape[1] >= 10
    # finishing still works after inspect
    while not sam.finished:
        sam.run_next_chunk()
    path = sam.trace.finalize()
    from nuts_rs_tpu.storage.zarr_format import read_array
    import os

    full = read_array(os.path.join(path, "posterior", "position"))
    assert full.shape == (2, 50, 3)
    assert np.isfinite(full).all()


def test_flush_forces_buffered_chunks(tmp_path):
    # Sampler.flush mirrors the reference controller's flush command
    # (src/sampler.rs:1231-1244): buffered rows land in storage mid-run
    # without being consumed.
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian
    from nuts_rs_tpu.storage.zarr import ZarrConfig

    sam = nt.Sampler(gaussian.normal_logp(3, 1.0),
                     nt.DiagNutsSettings(num_tune=30, num_draws=20,
                                         num_chains=2, seed=0),
                     storage=ZarrConfig(str(tmp_path / "t.zarr"),
                                        chunk_draws=10),
                     chunk_size=25)
    sam.run_next_chunk()   # 25 draws seen by storage
    sam.flush()            # forces the two FULL 10-draw chunks to disk
    # (the 5-row partial tail stays buffered until finalize — zarr chunk
    # files are write-once, matching the reference's flush semantics)
    snap = sam.inspect()
    assert snap["warmup_posterior"]["position"].shape[1] == 20
    while not sam.finished:
        sam.run_next_chunk()
    sam.trace.finalize()


def test_convergence_early_stop():
    # Easy unimodal target at many chains converges far before the draw
    # budget: the sampler must stop early, return a valid shorter trace,
    # and the diagnostics on it must actually satisfy the criteria.
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.diagnostics import ess_bulk, split_rhat

    model = gaussian.normal_logp(4, mu=2.0)
    settings = nt.DiagNutsSettings(num_tune=200, num_draws=4000,
                                   num_chains=8, seed=0)
    crit = nt.ConvergenceStop(rhat_max=1.01, min_ess_bulk=500.0,
                              min_draws=64)
    sampler = nt.Sampler(model, settings, chunk_size=100, stop_when=crit)
    trace = sampler.run()
    pos = np.asarray(trace.posterior["position"])
    assert sampler.converged
    assert pos.shape[1] < 4000, "did not stop early"
    assert pos.shape[1] >= 64
    assert np.all(np.asarray(split_rhat(pos)) <= 1.01)
    assert np.all(np.asarray(ess_bulk(pos)) >= 500.0)
    assert abs(pos.mean() - 2.0) < 0.1


def test_convergence_stop_never_met_runs_to_budget():
    import nuts_rs_tpu as nt

    model = gaussian.normal_logp(3, mu=0.0)
    settings = nt.DiagNutsSettings(num_tune=100, num_draws=200,
                                   num_chains=2, seed=1)
    # unreachable ESS target -> must run the full budget
    crit = nt.ConvergenceStop(min_ess_bulk=1e9, min_draws=10)
    sampler = nt.Sampler(model, settings, chunk_size=100, stop_when=crit)
    trace = sampler.run()
    assert not sampler.converged
    assert np.asarray(trace.posterior["position"]).shape[1] == 200


def test_convergence_early_stop_zarr_truncates(tmp_path):
    # Early stop with the Zarr backend must shrink the draw axis to the
    # draws actually written (no NaN fill tail).
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.storage.zarr_format import read_array

    path = str(tmp_path / "z")
    model = gaussian.normal_logp(4, mu=2.0)
    settings = nt.DiagNutsSettings(num_tune=200, num_draws=4000,
                                   num_chains=8, seed=0)
    crit = nt.ConvergenceStop(rhat_max=1.01, min_ess_bulk=500.0,
                              min_draws=64)
    # chunk_size deliberately misaligned with the Zarr chunk_draws (100) so
    # the early stop lands with a partial pending block: the final zarr
    # chunk is written short and the draw axis must truncate to the real
    # row count, not the padded one.
    sampler = nt.Sampler(model, settings, storage=nt.ZarrConfig(path),
                         chunk_size=128, stop_when=crit)
    sampler.run()
    assert sampler.converged
    arr = read_array(path + "/posterior/position")
    assert arr.shape[0] == 8 and arr.shape[2] == 4
    assert arr.shape[1] < 4000
    assert np.isfinite(arr).all()
    # the stop landed on a partial zarr chunk (otherwise this test cannot
    # see the truncation-overcount bug it was written for)
    assert arr.shape[1] % 100 != 0


def test_convergence_stop_buffer_bounded():
    """The host-side convergence buffer thins progressively instead of
    duplicating the whole trace in RAM (max_buffer_draws cap)."""
    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(2, mu=0.0)
    stop = nt.ConvergenceStop(rhat_max=1.0001, min_ess_bulk=1e9,
                              min_draws=10, max_buffer_draws=64)
    settings = nt.DiagNutsSettings(num_tune=50, num_draws=400,
                                   num_chains=4, seed=0)
    sampler = nt.Sampler(model, settings, chunk_size=50, stop_when=stop)
    sampler.run()
    assert not sampler.converged  # unreachable targets -> ran to num_draws
    series = np.concatenate(sampler._post_buffer, axis=1)
    assert series.shape[1] <= 64
    assert sampler._post_thin >= 4  # 400 draws within 64 -> stride >= 8


def test_max_chains_per_launch_transparent():
    """Splitting the chain batch into sequential launches is transparent for
    independent-chain settings (per-chain RNG keys; no pooling).  XLA may
    reassociate reductions differently per batch size, so equality holds to
    float-reassociation noise (~1e-9), with identical tree shapes."""
    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(3, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=40, num_draws=40,
                                   num_chains=8, seed=4)
    t1 = nt.sample(model, settings, chunk_size=40)
    t2 = nt.sample(model, settings, chunk_size=40, max_chains_per_launch=2)
    np.testing.assert_allclose(t1.posterior["position"],
                               t2.posterior["position"],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(t1.sample_stats["n_steps"],
                                  t2.sample_stats["n_steps"])


def test_max_chains_per_launch_validation():
    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(2, mu=0.0)
    s = nt.DiagNutsSettings(num_tune=10, num_draws=10, num_chains=6, seed=0)
    with pytest.raises(ValueError, match="multiple"):
        nt.Sampler(model, s, max_chains_per_launch=4)
    # Cross-chain adaptation under split launches pools within each launch
    # group (a psum over the vmapped group) — allowed with a warning, since
    # split launches exist for models where one full-batch launch faults the
    # device (BASELINE config 4 at [1024, 1e4]).
    s2 = nt.DiagNutsSettings(num_tune=10, num_draws=10, num_chains=4, seed=0,
                             cross_chain_adaptation=True)
    with pytest.warns(UserWarning, match="launch group"):
        sampler = nt.Sampler(model, s2, max_chains_per_launch=2)
    trace = sampler.run()
    assert np.isfinite(np.asarray(trace.posterior["position"])).all()


def test_keep_stats_and_draw_dtype():
    """Transfer-reduction knobs: keep_stats drops unlisted stat arrays before
    the device->host move; draw_dtype down-casts the position draws."""
    import jax.numpy as jnp

    from nuts_rs_tpu.models import gaussian

    model = gaussian.normal_logp(3, mu=0.0)
    settings = nt.DiagNutsSettings(num_tune=30, num_draws=30,
                                   num_chains=4, seed=0)
    sampler = nt.Sampler(model, settings, chunk_size=30,
                         keep_stats=("logp",), draw_dtype=jnp.float16)
    trace = sampler.run()
    keys = set(trace.sample_stats)
    assert "logp" in keys and "diverging" in keys and "n_steps" in keys
    assert "energy" not in keys and "fisher_distance" not in keys
    assert trace.posterior["position"].dtype == np.float16
    assert abs(float(trace.posterior["position"].astype(np.float64).mean())) < 0.3


def test_progress_tick_live_in_chunk():
    """``progress_tick`` surfaces ChainProgress updates from INSIDE a chunk
    (the reference ticks its progress channel per draw from within the draw
    loop, src/sampler.rs:1340-1363; chunked execution would otherwise go
    dark until the chunk boundary)."""
    model = gaussian.normal_logp(3, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=32, num_draws=32, num_chains=4,
                                   seed=0)
    seen = []

    def cb(progress):
        seen.append([p.finished_draws for p in progress])

    s = nt.Sampler(model, settings, chunk_size=64, progress_callback=cb,
                   progress_tick=8)
    s.progress_rate_seconds = 0.0
    trace = s.run()
    mid = [d for snap in seen for d in snap if 0 < d < 64]
    assert mid, "no in-chunk progress observed"
    assert all(p.finished_draws == 64 for p in s.progress)

    # Chunk-end accounting stays EXACT (ticks are provisional) and the
    # draws themselves are bit-identical to a tick-free run.
    s2 = nt.Sampler(model, settings, chunk_size=64)
    trace2 = s2.run()
    assert ([p.divergences for p in s.progress]
            == [p.divergences for p in s2.progress])
    assert ([p.total_num_steps for p in s.progress]
            == [p.total_num_steps for p in s2.progress])
    np.testing.assert_array_equal(np.asarray(trace.posterior["position"]),
                                  np.asarray(trace2.posterior["position"]))


def test_progress_tick_validation():
    model = gaussian.normal_logp(3)
    settings = nt.DiagNutsSettings(num_tune=8, num_draws=8, num_chains=4,
                                   seed=0)
    with pytest.raises(ValueError, match="progress_tick"):
        nt.Sampler(model, settings, progress_tick=0)
    with pytest.raises(ValueError, match="max_chains_per_launch"):
        nt.Sampler(model, settings, progress_tick=4,
                   max_chains_per_launch=2)


def test_draw_dtype_failure_detector_full_precision():
    """The stuck-chain detector must compare positions in FULL precision
    when draw_dtype downcasts the stored draws (ADVICE r3: tiny real moves
    that round to bit-identical f16 values used to read as "stuck" and a
    healthy chain could be declared permanently failed)."""
    import time

    import jax.numpy as jnp

    model = gaussian.normal_logp(2, mu=0.0)
    settings = nt.DiagNutsSettings(num_tune=4, num_draws=4, num_chains=2,
                                   seed=0)
    s = nt.Sampler(model, settings, chunk_size=4, draw_dtype=jnp.float16,
                   fail_after=3)
    # Synthetic chunk, bypassing the device runner: every draw divergent;
    # chain 0 makes tiny REAL moves around 2048 (f16 ulp there is 2.0, so
    # +0.05 steps round to bit-identical f16); chain 1 is frozen.
    k, C, d = 4, 2, 2
    pos = np.full((k, C, d), 2048.0)
    for j in range(k):
        pos[j, 0] += j * 0.05
    stats = {
        "position": jnp.asarray(pos),
        "diverging": jnp.ones((k, C), bool),
        "n_steps": jnp.ones((k, C), jnp.int32),
        "step_size": jnp.full((k, C), 0.1),
    }
    s._next_draw = k  # as if the chunk had been launched
    _, out, _ = s._finish_chunk(0, k, stats, time.monotonic())
    # stored copy IS bit-identical in f16 (the old comparison's view)...
    p16 = out["position"][0]  # chain 0, [k, d]
    assert p16.dtype == np.float16
    assert (p16[1:] == p16[:-1]).all()
    # ...but the full-precision device mask sees the moves: chain 0 healthy
    assert not s.progress[0].failed
    assert s._div_streak[0] == 0
    # the genuinely frozen chain is still caught
    assert s.progress[1].failed
    # and the detector's cross-chunk anchor stays full precision
    np.testing.assert_array_equal(s._last_pos[0], pos[-1, 0])


def test_runner_reuse_across_samplers():
    """A second Sampler with identical (model, settings, precision) must
    reuse the first one's jitted phase runners: jax.jit caches per wrapper
    object, and rebuilding wrappers re-traced + re-loaded every runner on
    each fresh Sampler."""
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g

    model = g.normal_logp(4, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=40, num_draws=40, num_chains=2,
                                   seed=11)
    s1 = nt.Sampler(model, settings)
    s2 = nt.Sampler(model, settings)
    assert [id(r) for _, _, r in s1._phase_runners] == \
        [id(r) for _, _, r in s2._phase_runners]
    # different settings -> different runners
    s3 = nt.Sampler(model, nt.DiagNutsSettings(
        num_tune=40, num_draws=40, num_chains=2, seed=12))
    assert [id(r) for _, _, r in s3._phase_runners] != \
        [id(r) for _, _, r in s1._phase_runners]
    # a different model with EQUAL settings -> different runners
    model2 = g.normal_logp(4, mu=1.0)
    s4 = nt.Sampler(model2, settings)
    assert [id(r) for _, _, r in s4._phase_runners] != \
        [id(r) for _, _, r in s1._phase_runners]
    # reused runners still produce correct, reproducible results
    t1 = s2.run()
    t2 = nt.sample(model, settings)
    np.testing.assert_array_equal(t1.posterior["position"],
                                  t2.posterior["position"])


def test_runner_reuse_lru_cap_and_pinning():
    """The cache is LRU-capped (entries hold executables AND pin their
    models via the runner closures — which is what makes id(model) keys
    alias-proof), so old entries must fall out."""
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g
    from nuts_rs_tpu.sampler import _RUNNER_CACHE, _RUNNER_CACHE_MAX

    settings = nt.DiagNutsSettings(num_tune=20, num_draws=20, num_chains=2)
    model0 = g.normal_logp(3)
    nt.Sampler(model0, settings)
    assert any(k[0] == id(model0) for k in _RUNNER_CACHE)
    models = [g.normal_logp(3) for _ in range(_RUNNER_CACHE_MAX)]
    for m in models:
        nt.Sampler(m, settings)
    assert len(_RUNNER_CACHE) <= _RUNNER_CACHE_MAX
    assert not any(k[0] == id(model0) for k in _RUNNER_CACHE)


def test_stats_dtype_downcast():
    """stats_dtype down-casts every float stat array (not positions, not
    int/bool stats) on device before transfer — the symmetric knob to
    draw_dtype for full-stats transfer-bound hosts."""
    import jax.numpy as jnp

    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g

    model = g.normal_logp(4, mu=1.0)
    settings = nt.DiagNutsSettings(num_tune=30, num_draws=30, num_chains=2,
                                   seed=3)
    t = nt.sample(model, settings, stats_dtype=jnp.float16)
    assert t.sample_stats["step_size"].dtype == np.float16
    assert t.sample_stats["mean_tree_accept"].dtype == np.float16
    assert t.sample_stats["n_steps"].dtype != np.float16      # int stays
    assert t.sample_stats["diverging"].dtype == np.bool_
    assert t.posterior["position"].dtype != np.float16        # draw_dtype's job
    # posterior still correct
    full = nt.sample(model, settings)
    np.testing.assert_array_equal(t.posterior["position"],
                                  full.posterior["position"])


def test_expand_host_fn_sees_full_precision_under_draw_dtype():
    """Host deterministics must be computed from the FULL-precision
    positions even when draw_dtype down-casts the stored copy (same
    contract as the device expand_fn)."""
    import jax.numpy as jnp

    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g

    base = g.normal_logp(3, mu=1.0)
    import dataclasses as dc

    model = dc.replace(
        base, expand_host_fn=lambda pos: {"double": pos.astype(np.float64) * 2.0})
    settings = nt.DiagNutsSettings(num_tune=20, num_draws=20, num_chains=2,
                                   seed=9)
    full = nt.sample(model, settings)
    thin = nt.sample(model, settings, draw_dtype=jnp.float16)
    # identical expansion values — not f16-rounded ones
    np.testing.assert_array_equal(full.posterior["double"],
                                  thin.posterior["double"])
    assert thin.posterior["position"].dtype == np.float16


def test_runner_cache_fully_purged_on_fresh_rebuild():
    """A worker restart invalidates every cached executable; fresh=True must
    clear the whole cache, not just the rebuilding sampler's key."""
    import nuts_rs_tpu as nt
    from nuts_rs_tpu.models import gaussian as g
    from nuts_rs_tpu.sampler import _RUNNER_CACHE

    model = g.normal_logp(3)
    s1 = nt.Sampler(model, nt.DiagNutsSettings(num_tune=10, num_draws=10,
                                               num_chains=2, seed=1))
    s2 = nt.Sampler(model, nt.DiagNutsSettings(num_tune=10, num_draws=10,
                                               num_chains=2, seed=2))
    assert len(_RUNNER_CACHE) >= 2
    s1._build_phase_runners(fresh=True)
    assert len(_RUNNER_CACHE) == 0 or all(
        k[1].seed != 2 for k in _RUNNER_CACHE)  # s2's stale entry gone

"""High-level sampler entry points: settings presets and the chunked runner.

Batched counterpart of nuts-rs ``src/sampler.rs``.  Where the reference
spawns one rayon thread per chain (``src/sampler.rs:1286-1326``), here all
chains run as one batched device computation: the chains axis is vmapped
within a chip and (M5) sharded over a device mesh.  The host loop only
launches scan *chunks* and streams finished chunks to storage, mirroring the
reference's progressive trace writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import warnings
from functools import partial
from typing import Any, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .adapt.flow import FlowAdaptSettings, build_flow_schedule
from .adapt.low_rank import LowRankSettings
from .adapt.schedule import AdaptSchedule, AdaptScheduleOptions, build_schedule
from .adapt.step_size import StepSizeMethod, StepSizeSettings
from .chain import (
    ChainConfig,
    ChainState,
    DiagStrategy,
    init_chain_state,
    make_draw_step,
)
from .dynamics.hamiltonian import KineticKind
from .kernels.nuts import NutsOptions
from .models.model import Model
from .storage.core import StorageConfig
from .storage.memory import MemoryConfig, Trace


@dataclasses.dataclass(frozen=True)
class NutsSettings:
    """Generic NUTS settings (nuts-rs ``NutsSettings``, src/sampler.rs:199-239)."""

    num_tune: int = 400
    num_draws: int = 1000
    maxdepth: int = 10
    mindepth: int = 0
    num_chains: int = 6
    seed: int = 0
    max_energy_error: float = 1000.0
    check_turning: bool = True
    target_integration_time: Optional[float] = None
    extra_doublings: int = 0
    store_gradient: bool = False
    store_unconstrained: bool = False
    store_transformed: bool = False
    store_divergences: bool = False
    store_mass_matrix: bool = False
    kinetic_energy: KineticKind = KineticKind.EUCLIDEAN
    # Posterior draws on the draw-asynchronous kernel: each chain starts its
    # next draw immediately instead of waiting for the slowest tree in the
    # batch.  Wins on targets with heavy-tailed tree depths; for shallow
    # uniform trees the per-iteration bookkeeping overhead makes it slightly
    # slower, so the default is the draw-synchronous path.
    async_posterior: bool = False
    # "sync" (default) | "async": which posterior-phase engine to use.
    # "async" is the draw-asynchronous kernel (kernels/nuts_async.py), the
    # same as async_posterior=True.
    posterior_kernel: str = "sync"
    # Optional GLOBAL matmul-precision override for everything the sampler
    # traces.  The energy-critical sites (Model.logp_and_grad, the low-rank
    # transform matvecs, the flow maps) already run at "highest" locally —
    # reduced-precision f32 matmuls (TF32 on GPUs, bf16 passes elsewhere)
    # corrupt Hamiltonian energies (biased logistic-regression posteriors
    # and spurious low-rank divergences).  None keeps tree bookkeeping at
    # the backend default; set "highest" to force every matmul to full f32.
    matmul_precision: Optional[str] = None
    # Cross-chain adaptation (extension beyond the reference, SURVEY.md
    # §2.12): pool mass-matrix estimators and step-size acceptance
    # statistics across all chains (psum/pmean over the mesh axis when
    # sharded).
    cross_chain_adaptation: bool = False
    mesh_axis_name: Optional[str] = None
    adapt: AdaptScheduleOptions = AdaptScheduleOptions()
    step_size: StepSizeSettings = StepSizeSettings()
    low_rank: LowRankSettings = LowRankSettings()
    flow: FlowAdaptSettings = FlowAdaptSettings()
    flow_spec: Any = None  # FlowSpec; None -> built-in coupling flow
    use_grad_based_estimate: bool = True
    mass_matrix: str = "diag"  # "diag" | "low_rank" | "flow"

    def nuts_options(self) -> NutsOptions:
        return NutsOptions(
            maxdepth=self.maxdepth,
            mindepth=self.mindepth,
            check_turning=self.check_turning,
            max_energy_error=self.max_energy_error,
            extra_doublings=self.extra_doublings,
            target_integration_time=self.target_integration_time,
            kind=self.kinetic_energy,
            store_divergences=self.store_divergences,
            collect_orbit=(self.mass_matrix == "flow"
                           and self.flow.use_orbit_for_training),
        )

    def chain_config(self) -> ChainConfig:
        window_params = None
        if self.adapt.window_by_good_draws:
            # Reference-semantics warmup (adapt_strategy.rs:121-216): the
            # per-chain window counters are wired through the diag strategy's
            # estimator counts; pooled (cross-chain) estimators and the other
            # mass-matrix strategies keep the draw-index schedule.
            if self.mass_matrix != "diag":
                raise ValueError(
                    "adapt.window_by_good_draws=True requires "
                    f"mass_matrix='diag' (got {self.mass_matrix!r}); "
                    "low-rank/flow refits run on the draw-index schedule")
            if self.cross_chain_adaptation:
                raise ValueError(
                    "adapt.window_by_good_draws=True is incompatible with "
                    "cross_chain_adaptation=True: pooled estimators share "
                    "one window across chains by construction")
            from .adapt.schedule import build_window_params

            window_params = build_window_params(self.num_tune, self.adapt)
        return ChainConfig(
            nuts=self.nuts_options(),
            step_size=self.step_size,
            use_grad_based_estimate=self.use_grad_based_estimate,
            store_gradient=self.store_gradient,
            store_unconstrained=self.store_unconstrained,
            store_transformed=self.store_transformed,
            store_divergences=self.store_divergences,
            store_mass_matrix=self.store_mass_matrix,
            store_mass_matrix_eigs=(self.mass_matrix == "low_rank"
                                    and self.low_rank.store_mass_matrix),
            cross_chain_step_size=self.cross_chain_adaptation,
            axis_name=self.mesh_axis_name,
            window_params=window_params,
        )

    @property
    def sampler_name(self) -> str:
        return "nuts"

    @property
    def adaptation_name(self) -> str:
        return self.mass_matrix

    @property
    def _enabled_extra_stores(self) -> list:
        names = ("store_gradient", "store_unconstrained", "store_transformed",
                 "store_divergences", "store_mass_matrix")
        return [n for n in names if getattr(self, n)]

    @property
    def _posterior_kernel(self) -> str:
        if self.async_posterior and self.posterior_kernel == "sync":
            return "async"
        return self.posterior_kernel

    def build_phases(self, model, strategy, config):
        from .chain import make_async_posterior_runner

        step = make_draw_step(model, strategy, config)
        sync = partial(_scan_chunk, step)
        total = self.num_tune + self.num_draws
        kind = _check_posterior_kernel(self._posterior_kernel,
                                       ("sync", "async"))
        if kind == "sync":
            return [(0, total, sync)]
        enabled = self._enabled_extra_stores
        if enabled:
            # The draw-async kernel emits no per-leapfrog extras.
            raise ValueError(
                "posterior_kernel='async' stores no per-leapfrog extras; "
                "disable " + ", ".join(enabled) + " or use 'sync'")
        runner = make_async_posterior_runner(
            model, strategy, config, phase_start=self.num_tune)
        # Warmup stays draw-synchronous (per-draw-index adaptation schedule).
        return [(0, self.num_tune, sync), (self.num_tune, total, runner)]

    def extra_flags(self, flags, lo, hi):
        return flags


def _check_posterior_kernel(kind: str, accepted: tuple) -> str:
    """Validate a ``posterior_kernel`` request against the engines that
    exist for this sampler."""
    if kind not in accepted:
        raise ValueError(
            f"unknown posterior_kernel {kind!r}; accepted values: "
            + ", ".join(repr(a) for a in accepted))
    return kind


class MclmcTrajectoryKind(str, __import__("enum").Enum):
    """nuts-rs ``MclmcTrajectoryKind`` (src/mclmc.rs:44-70)."""

    MICROCANONICAL = "microcanonical"
    EUCLIDEAN = "euclidean"
    EUCLIDEAN_EARLY_THEN_MICROCANONICAL = "euclidean_early_then_microcanonical"


@dataclasses.dataclass(frozen=True)
class MclmcSettings:
    """Unadjusted MCLMC settings (nuts-rs ``MclmcSettings``,
    src/sampler.rs:268-318; experimental in the reference too).

    Step size and decoherence length L are constants (no adaptation); the
    geometry adapts during warmup with the shared window schedule.
    """

    step_size: float = 0.5
    momentum_decoherence_length: float = 3.0
    num_tune: int = 400
    num_draws: int = 1000
    num_chains: int = 6
    seed: int = 0
    max_energy_error: float = 1000.0
    store_gradient: bool = False
    store_unconstrained: bool = False
    store_transformed: bool = False
    store_divergences: bool = False
    store_mass_matrix: bool = False
    subsample_frequency: float = 1.0
    dynamic_step_size: bool = True
    trajectory_kind: MclmcTrajectoryKind = (
        MclmcTrajectoryKind.EUCLIDEAN_EARLY_THEN_MICROCANONICAL)
    trajectory_switch_fraction: float = 0.3
    adapt: AdaptScheduleOptions = AdaptScheduleOptions()
    low_rank: LowRankSettings = LowRankSettings()
    flow: FlowAdaptSettings = FlowAdaptSettings()
    flow_spec: Any = None  # FlowSpec; None -> built-in coupling flow
    use_grad_based_estimate: bool = True
    mass_matrix: str = "diag"
    matmul_precision: Optional[str] = None
    # Cross-chain adaptation (extension beyond the reference, as on
    # NutsSettings; BASELINE config 5's "psum'd adaptation"): pool the diag
    # mass-matrix foreground estimators across all chains (pmean over the
    # mesh axis when sharded).  MCLMC's step size stays fixed (reference
    # semantics), so only the geometry pools.
    cross_chain_adaptation: bool = False
    mesh_axis_name: Optional[str] = None
    # "sync" only: the XLA scan engine.  There is no draw-asynchronous
    # MCLMC engine.
    posterior_kernel: str = "sync"

    @property
    def step_size_settings(self) -> StepSizeSettings:
        # Reference MCLMC presets: Fixed step size with the default 10% jitter.
        return StepSizeSettings(method=StepSizeMethod.FIXED,
                                fixed_value=self.step_size,
                                initial_step=self.step_size)

    def chain_config(self) -> ChainConfig:
        from .kernels.nuts import NutsOptions

        if self.adapt.window_by_good_draws:
            raise ValueError(
                "adapt.window_by_good_draws is a NUTS warmup option; the "
                "MCLMC driver runs the draw-index schedule")
        return ChainConfig(
            nuts=NutsOptions(max_energy_error=self.max_energy_error),
            step_size=self.step_size_settings,
            use_grad_based_estimate=self.use_grad_based_estimate,
            store_gradient=self.store_gradient,
            store_unconstrained=self.store_unconstrained,
            store_transformed=self.store_transformed,
            store_divergences=self.store_divergences,
            store_mass_matrix=self.store_mass_matrix,
            store_mass_matrix_eigs=(self.mass_matrix == "low_rank"
                                    and self.low_rank.store_mass_matrix),
            axis_name=self.mesh_axis_name,
        )

    @property
    def switch_draw(self) -> Optional[int]:
        if self.trajectory_kind is not MclmcTrajectoryKind.EUCLIDEAN_EARLY_THEN_MICROCANONICAL:
            return None
        return int(self.trajectory_switch_fraction * self.num_tune)

    def _mclmc_options(self, kind):
        from .dynamics.hamiltonian import KineticKind
        from .kernels.mclmc import MclmcOptions

        kk = (KineticKind.MICROCANONICAL
              if kind is MclmcTrajectoryKind.MICROCANONICAL
              else KineticKind.EUCLIDEAN)
        return MclmcOptions(
            momentum_decoherence_length=self.momentum_decoherence_length,
            subsample_frequency=self.subsample_frequency,
            dynamic_step_size=self.dynamic_step_size,
            max_energy_error=self.max_energy_error,
            kind=kk,
            store_divergences=self.store_divergences,
        )

    def build_phases(self, model, strategy, config):
        from .chain import make_mclmc_draw_step

        _check_posterior_kernel(self.posterior_kernel, ("sync",))
        total = self.num_tune + self.num_draws
        if self.switch_draw is None:
            opts = self._mclmc_options(self.trajectory_kind)
            step = make_mclmc_draw_step(model, strategy, config, opts)
            return [(0, total, partial(_scan_chunk, step))]
        sw = self.switch_draw
        eucl = make_mclmc_draw_step(
            model, strategy, config,
            self._mclmc_options(MclmcTrajectoryKind.EUCLIDEAN))
        micro = make_mclmc_draw_step(
            model, strategy, config,
            self._mclmc_options(MclmcTrajectoryKind.MICROCANONICAL))
        return [(0, sw, partial(_scan_chunk, eucl)),
                (sw, total, partial(_scan_chunk, micro))]

    def extra_flags(self, flags, lo, hi):
        # Full momentum resample on the first draw and at the trajectory
        # switch (mclmc.rs:488-503).
        resample = np.zeros(hi - lo, bool)
        special = {0, self.switch_draw}
        for d in range(lo, hi):
            if d in special:
                resample[d - lo] = True
        flags = dict(flags)
        flags["resample_velocity"] = jnp.asarray(resample)
        return flags

    @property
    def sampler_name(self) -> str:
        return "mclmc"

    @property
    def adaptation_name(self) -> str:
        return self.mass_matrix


def DiagMclmcSettings(**kw) -> MclmcSettings:
    """Defaults of nuts-rs ``DiagMclmcSettings`` (src/sampler.rs:381-387)."""
    return MclmcSettings(**kw)


def LowRankMclmcSettings(**kw) -> MclmcSettings:
    """Defaults of nuts-rs ``LowRankMclmcSettings`` (src/sampler.rs:389-396)."""
    kw.setdefault("num_tune", 800)
    kw.setdefault("mass_matrix", "low_rank")
    kw.setdefault("adapt", AdaptScheduleOptions(early_mass_matrix_switch_freq=20))
    return MclmcSettings(**kw)


def FlowMclmcSettings(**kw) -> MclmcSettings:
    """Defaults of nuts-rs ``FlowMclmcSettings`` (src/sampler.rs:334,390-392):
    1500 tuning draws, 1 chain, max_energy_error 20, learned-flow transform."""
    kw.setdefault("num_tune", 1500)
    kw.setdefault("num_chains", 1)
    kw.setdefault("max_energy_error", 20.0)
    kw.setdefault("mass_matrix", "flow")
    return MclmcSettings(**kw)


def DiagNutsSettings(**kw) -> NutsSettings:
    """Defaults of nuts-rs ``DiagNutsSettings`` (src/sampler.rs:630-633)."""
    return NutsSettings(**kw)


def LowRankNutsSettings(**kw) -> NutsSettings:
    """Defaults of nuts-rs ``LowRankNutsSettings`` (src/sampler.rs:635-641)."""
    kw.setdefault("num_tune", 800)
    kw.setdefault("mass_matrix", "low_rank")
    kw.setdefault(
        "adapt", AdaptScheduleOptions(mass_matrix_update_freq=20))
    return NutsSettings(**kw)


def FlowNutsSettings(**kw) -> NutsSettings:
    """Defaults of nuts-rs ``FlowNutsSettings`` (src/sampler.rs:643-646):
    1500 tuning draws, 1 chain, max_energy_error 20."""
    kw.setdefault("num_tune", 1500)
    kw.setdefault("num_chains", 1)
    kw.setdefault("max_energy_error", 20.0)
    kw.setdefault("mass_matrix", "flow")
    return NutsSettings(**kw)


@dataclasses.dataclass(frozen=True)
class ConvergenceStop:
    """Early-stopping criteria: sample until converged, then stop.

    No reference counterpart — the chunked controller makes between-chunk
    diagnostics essentially free, so "run until R-hat/ESS targets are met"
    becomes a first-class mode instead of a guess-num_draws-and-rerun loop.
    After every chunk containing post-warmup draws the sampler computes
    rank-normalized split-R-hat and bulk ESS (diagnostics.py) over the
    posterior draws accumulated so far on ``var``; once every dimension
    satisfies BOTH targets the sampler stops and finalizes the (shorter)
    trace.  ``settings.num_draws`` stays the hard upper bound.  Dimensions
    whose diagnostics are NaN (e.g. constant) never satisfy the check, so
    such runs simply continue to ``num_draws``.
    """

    rhat_max: float = 1.01
    min_ess_bulk: float = 400.0
    # posterior draws required before the first (and any) check
    min_draws: int = 100
    # check only the first N dims of ``var`` (None = all); caps host-side
    # diagnostic cost for huge-d models
    check_dims: Optional[int] = None
    var: str = "position"
    # Hard cap on the host-side diagnostic buffer (draws per chain): beyond
    # it the buffered series is progressively THINNED by 2 (keeping every
    # stride-th draw), so memory stays O(max_buffer_draws * chains * dims)
    # instead of duplicating the whole trace next to the storage backend.
    # Thinning only discards information, so ESS of the thinned series
    # UNDERESTIMATES the true ESS — the stop stays conservative.
    max_buffer_draws: int = 4096

    def satisfied(self, x) -> bool:
        from .diagnostics import ess_bulk, split_rhat

        if x.shape[1] < max(self.min_draws, 4):
            return False
        if self.check_dims is not None and x.ndim == 3:
            x = x[..., : self.check_dims]
        rhat = np.asarray(split_rhat(x))
        if not np.all(rhat <= self.rhat_max):  # NaN -> False -> keep going
            return False
        ess = np.asarray(ess_bulk(x))
        return bool(np.all(ess >= self.min_ess_bulk))


@dataclasses.dataclass
class ChainProgress:
    """Mirror of nuts-rs ``ChainProgress`` (src/sampler.rs:1009-1051)."""

    finished_draws: int = 0
    total_draws: int = 0
    divergences: int = 0
    tuning: bool = True
    started: bool = False
    latest_num_steps: int = 0
    total_num_steps: int = 0
    step_size: float = 0.0
    runtime: float = 0.0
    divergent_draws: list = dataclasses.field(default_factory=list)
    # Unrecoverable-failure surface (reference: LogpError::is_recoverable,
    # src/math/math.rs:9-13; chain abort src/sampler.rs:1202-1207): set by
    # the sampler's between-chunk failure detector.
    failed: bool = False
    error: Optional[str] = None


class DeviceLostError(RuntimeError):
    """The device died mid-run and could not be reconnected in-process.

    Raised by ``auto_recover`` when the reconnect probe keeps failing after
    a device fault.  The last chunk-boundary snapshot has been written to
    ``Sampler(recovery_path=...)`` in checkpoint format and storage was
    flushed; a Sampler built with the same settings in a fresh process
    continues via ``restore(recovery_path)``.
    """


class ChainFailedError(RuntimeError):
    """A chain's logp function failed unrecoverably (every draw diverges and
    the chain never moves — e.g. logp permanently returns NaN).

    Mirror of the reference's unrecoverable ``LogpError`` path
    (src/math/math.rs:9-13): sampling stops, traces are FINALIZED first
    (src/sampler.rs:1452-1457 runs finalization even when a chain failed),
    and the partial results ride on the exception.

    Attributes:
        trace: the finalized partial trace (all chains, draws so far).
        chains: indices of the failed chains.
    """

    def __init__(self, msg: str, trace=None, chains=()):
        super().__init__(msg)
        self.trace = trace
        self.chains = list(chains)


def _strategy_for(settings, config: ChainConfig):
    cross = getattr(settings, "cross_chain_adaptation", False)
    axis = getattr(settings, "mesh_axis_name", None)
    if settings.mass_matrix == "diag":
        return DiagStrategy(config, cross_chain=cross, axis_name=axis)
    if settings.mass_matrix == "low_rank":
        from .adapt.low_rank import LowRankStrategy

        return LowRankStrategy(config, settings)
    if settings.mass_matrix == "flow":
        from .adapt.flow import FlowStrategy
        from .flows.coupling import coupling_flow

        spec = getattr(settings, "flow_spec", None) or coupling_flow()
        return FlowStrategy(config, settings, spec)
    raise NotImplementedError(f"mass matrix kind {settings.mass_matrix!r}")


def _schedule_for(settings):
    if settings.mass_matrix == "flow":
        return build_flow_schedule(settings.num_tune, settings.num_draws,
                                   settings.flow)
    return build_schedule(settings.num_tune, settings.num_draws,
                          settings.adapt)


# Stat names stored under the posterior/warmup_posterior groups; everything
# else lands in sample_stats (matches the storage backends' split).
_POSTERIOR_STAT_KEYS = ("position",)


def _schedule_chunk(sched: AdaptSchedule, lo: int, hi: int) -> Mapping[str, jax.Array]:
    return {
        "is_tuning": jnp.asarray(sched.is_tuning[lo:hi]),
        "update_estimators": jnp.asarray(sched.update_estimators[lo:hi]),
        "do_switch": jnp.asarray(sched.do_switch[lo:hi]),
        "do_update": jnp.asarray(sched.do_update[lo:hi]),
        "use_late_estimator": jnp.asarray(sched.use_late_estimator[lo:hi]),
        "reinit_step_size": jnp.asarray(sched.reinit_step_size[lo:hi]),
        "use_best_guess": jnp.asarray(sched.use_best_guess[lo:hi]),
        "advance_da": jnp.asarray(sched.advance_da[lo:hi]),
    }


def _scan_chunk(step, state, flags):
    return jax.lax.scan(step, state, flags)


# Cross-instance jitted-runner reuse.  jax.jit caches per WRAPPER object, so
# a fresh Sampler used to re-trace + re-lower + re-load every phase runner on
# its first chunk (trace + lower + executable load) even though the
# persistent compile cache already held the binary.  Runners are pure
# functions of (model, settings, matmul precision), so identical requests
# share one wrapper and hit jax's C++ fast path.  Keyed by id(model): the
# cached runners close over model.logp_and_grad and therefore PIN the model,
# so an id can never be recycled while its entry lives — aliasing is
# impossible by construction, and the LRU cap is the memory bound (entries
# hold compiled executables and the models they close over).
_RUNNER_CACHE: "dict[tuple, list]" = {}
_RUNNER_CACHE_ORDER: "list[tuple]" = []
_RUNNER_CACHE_MAX = 8


def _scan_chunk_ticked(step, tick, every, num_chains, state, flags):
    """``lax.scan`` with an in-chunk live progress tick.

    Every ``every`` draws the scan body fires an async
    ``jax.debug.callback`` shipping (draws done, cumulative divergences,
    cumulative leapfrog steps, last draw's steps) to the host — live
    per-draw progress from inside the device loop, the batched analog of
    the reference ticking its progress channel per draw
    (src/sampler.rs:1340-1363).  Callbacks are unordered: the host keeps a
    monotone max over draws-done, and the chunk-end accounting recomputes
    the exact values from the full stats.
    """
    n = jax.tree.leaves(flags)[0].shape[0]
    zeros = jnp.zeros(num_chains, jnp.int32)

    def body(carry, xf):
        st, divs, steps = carry
        i, f = xf
        st2, stats = step(st, f)
        divs = divs + stats["diverging"].astype(jnp.int32)
        nst = stats["n_steps"].astype(jnp.int32)
        steps = steps + nst
        jax.lax.cond(
            (i + 1) % every == 0,
            lambda: jax.debug.callback(tick, i + 1, divs, steps, nst,
                                       stats["step_size"]),
            lambda: None)
        return (st2, divs, steps), stats

    (state, _, _), stats = jax.lax.scan(
        body, (state, zeros, zeros), (jnp.arange(n), flags))
    return state, stats


class Sampler:
    """Chunked multi-chain sampler (parallel controller of src/sampler.rs:1254).

    Chains run lock-step on device; ``pause``/``resume`` and progressive
    ``inspect``/``flush`` operate at chunk granularity on the host.
    """

    def __init__(
        self,
        model: Model,
        settings: NutsSettings,
        storage: Optional[StorageConfig] = None,
        dtype=None,
        chunk_size: int = 128,
        init_positions=None,
        progress_callback=None,
        mesh=None,
        profile_dir: Optional[str] = None,
        stop_when: Optional[ConvergenceStop] = None,
        fail_after: Optional[int] = 100,
        max_chains_per_launch: Optional[int] = None,
        keep_stats=None,
        draw_dtype=None,
        stats_dtype=None,
        store_warmup: bool = True,
        progress_tick: Optional[int] = None,
        auto_recover=0,
        recovery_path: Optional[str] = None,
        _reflect_only: bool = False,
    ):
        # Mesh execution (SURVEY.md §2.12): shard the chain axis over a
        # ``jax.sharding.Mesh`` with ``shard_map`` so chains scale across
        # devices and hosts; cross-chain adaptation then pools statistics
        # with psum over the same axis.  Replaces the reference's
        # one-thread-per-chain rayon pool (src/sampler.rs:1286-1326).
        self._dim_sharded = False
        if mesh is not None:
            from .parallel.axis import DIM_AXIS
            from .parallel.mesh import CHAIN_AXIS, mesh_axis_size

            n_chain_dev = mesh_axis_size(mesh, CHAIN_AXIS)
            n_dim_dev = mesh_axis_size(mesh, DIM_AXIS)
            self._dim_sharded = DIM_AXIS in mesh.axis_names
            if settings.num_chains % n_chain_dev:
                raise ValueError(
                    f"num_chains ({settings.num_chains}) must be a multiple "
                    f"of the chains mesh axis ({n_chain_dev})")
            if (self._dim_sharded
                    and getattr(settings, "posterior_kernel", "sync")
                    != "sync"):
                raise ValueError(
                    "dim-sharded execution requires posterior_kernel='sync'")
            if self._dim_sharded:
                # Parameter-axis sharding (SURVEY.md §5; BASELINE config 5):
                # state vectors and the kernels' contractions split over the
                # "dim" mesh axis; see parallel/axis.py for the mechanics.
                if model.dim % n_dim_dev:
                    raise ValueError(
                        f"model.dim ({model.dim}) must be a multiple of the "
                        f"dim mesh axis ({n_dim_dev})")
                if not getattr(model, "dim_shardable", False):
                    raise ValueError(
                        "dim-sharded execution needs a model whose logp is "
                        "written against parallel.axis.dsum/dfinish (set "
                        "Model.dim_shardable=True); this model computes a "
                        "shard-local density under sharding")
                if getattr(settings, "mass_matrix", "diag") != "diag":
                    raise ValueError(
                        "dim-sharded execution currently supports the "
                        "diagonal mass matrix only (low-rank/flow refits "
                        "operate on full-dimension draw windows)")
            flow_pooled = (getattr(settings, "mass_matrix", "diag") == "flow"
                           and getattr(getattr(settings, "flow", None),
                                       "pool_chains", False))
            if ((getattr(settings, "cross_chain_adaptation", False)
                 or flow_pooled)
                    and getattr(settings, "mesh_axis_name", None) is None):
                # Pooled flow refits are cross-chain BY DESIGN: without the
                # axis bound each device would train its own "shared" flow
                # on 1/N of the windows (adapt/flow.py gathers over it).
                settings = dataclasses.replace(
                    settings, mesh_axis_name=CHAIN_AXIS)
        self.mesh = mesh
        self.model = model
        self.settings = settings
        self.dtype = dtype or (
            jnp.float64
            if jax.config.read("jax_enable_x64")
            else jnp.float32
        )
        self.chunk_size = chunk_size
        self.progress_callback = progress_callback

        config = settings.chain_config()
        self.config = config
        self.strategy = _strategy_for(settings, config)
        self.schedule = _schedule_for(settings)
        storage = storage or MemoryConfig()
        self.trace = storage.new_trace(settings, model, settings.num_chains)
        self.progress = [
            ChainProgress(total_draws=settings.num_tune + settings.num_draws)
            for _ in range(settings.num_chains)
        ]

        if init_positions is not None:
            init_positions = np.asarray(init_positions)
            expect = (settings.num_chains, model.dim)
            if init_positions.shape != expect:
                raise ValueError(
                    f"init_positions has shape {init_positions.shape}, "
                    f"expected (num_chains, dim) = {expect}")
        if model.dim < 1:
            raise ValueError("model.dim must be >= 1")

        # Under mesh execution, init runs eagerly BEFORE the state is
        # sharded, so all chains are local: pooling over the vmapped chain
        # axis is already the global pool and psum would find its axis
        # unbound.  Use an axis-free strategy/config for init only.
        init_config, init_strategy = config, self.strategy
        if mesh is not None and config.axis_name is not None:
            init_config = dataclasses.replace(config, axis_name=None)
            init_strategy = _strategy_for(
                dataclasses.replace(settings, mesh_axis_name=None),
                init_config)

        precision = getattr(settings, "matmul_precision", None)
        prec_ctx = (jax.default_matmul_precision(precision)
                    if precision is not None else contextlib.nullcontext())
        if _reflect_only:
            # Settings-level schema reflection (module-level :func:`schema`):
            # the chain state is built ABSTRACTLY — ``jax.eval_shape`` traces
            # ``init_chain_state`` without allocating one device buffer, so
            # storage can be created before any device exists.  Mirrors the
            # reference reflecting the trace schema from ``Settings`` alone
            # (src/sampler.rs:73-162).
            key_sds = jax.eval_shape(lambda: jax.random.key(settings.seed))
            with prec_ctx:
                self.state: ChainState = jax.eval_shape(
                    lambda k: init_chain_state(
                        k, model, init_strategy, init_config,
                        settings.num_chains, settings.num_tune, self.dtype),
                    key_sds)
        else:
            key = jax.random.key(settings.seed)
            with prec_ctx:
                state = init_chain_state(
                    key, model, init_strategy, init_config,
                    settings.num_chains, settings.num_tune, self.dtype,
                    init_positions=init_positions)
            # Deep-copy so no two leaves alias one buffer: the chunk runner
            # donates its input state, and XLA rejects donating the same
            # buffer twice.
            self.state: ChainState = jax.tree.map(
                lambda x: jnp.array(x, copy=True), state)
            if mesh is not None:
                from .parallel.mesh import shard_chain_state

                self.state = shard_chain_state(
                    self.state, mesh, model.dim if self._dim_sharded else None)

            # Fail fast on unusable starting points (reference: 500 init
            # retries then a hard error, src/sampler.rs:1133-1143).  Without
            # this a bad chain would silently diverge on every draw.
            init_logp = np.asarray(self.state.pt.logp)
            if not np.isfinite(init_logp).all():
                bad = np.nonzero(~np.isfinite(init_logp))[0]
                raise RuntimeError(
                    f"could not find a valid initial position for chains "
                    f"{bad.tolist()[:10]} (logp is not finite after retries); "
                    "provide init_positions or check the model")

        # In-chunk live progress (the reference reports per-chain progress
        # from inside its draw loop, src/sampler.rs:1340-1363; chunked
        # execution would otherwise go dark for a whole chunk): every
        # ``progress_tick`` draws the scan body fires an async
        # jax.debug.callback that updates ChainProgress provisionally —
        # exact values are recomputed at chunk end.  Applies to the XLA
        # sync-scan phases (a draw-async chunk is one opaque while loop);
        # disables run()'s launch/finish pipelining so tick bookkeeping
        # stays ordered.
        if progress_tick is not None:
            if progress_tick < 1:
                raise ValueError("progress_tick must be >= 1")
            if mesh is not None:
                raise ValueError(
                    "progress_tick is incompatible with mesh execution "
                    "(debug callbacks fire once per device)")
            if max_chains_per_launch is not None:
                raise ValueError(
                    "progress_tick is incompatible with "
                    "max_chains_per_launch (each chain-group launch would "
                    "re-count the chunk's draws)")
        self.progress_tick = progress_tick
        self._tick_lo = 0
        self._tick_base = None
        self._live_done = 0

        self._precision = precision
        self._build_phase_runners()

        # expand_host_fn arity: fn(positions) or fn(positions, first_draw) —
        # the offset form keeps draw-indexed outputs chunk-size-invariant.
        self._expand_host_wants_offset = False
        if model.expand_host_fn is not None:
            import inspect

            try:
                params = inspect.signature(
                    model.expand_host_fn).parameters.values()
                pos = [p for p in params
                       if p.kind in (p.POSITIONAL_ONLY,
                                     p.POSITIONAL_OR_KEYWORD)]
                # Only EXPLICIT two-REQUIRED-parameter signatures opt in: a
                # bare *args wrapper around a one-argument fn, and a
                # one-argument fn with a defaulted extra (def f(pos,
                # scale=1.0)), must keep getting the one-argument call — the
                # defaulted parameter is the user's knob, not the draw
                # offset (backward compatibility beats guessing).
                self._expand_host_wants_offset = (
                    len(pos) >= 2 and pos[1].default is pos[1].empty)
            except (TypeError, ValueError):
                pass  # builtins/C callables: single-argument form

        if model.expand_fn is not None:
            def expand_chunk(keys, qs):
                return jax.vmap(jax.vmap(model.expand))(keys, qs)

            self._expand_chunk = jax.jit(expand_chunk)
        else:
            self._expand_chunk = None

        self._next_draw = 0
        self._total = settings.num_tune + settings.num_draws
        self._expand_key = (
            jax.eval_shape(lambda: jax.random.key(settings.seed + 1))
            if _reflect_only else jax.random.key(settings.seed + 1))
        self._paused = False
        # Opt-in device profiling (SURVEY.md §5 tracing): each chunk runs
        # under a jax profiler trace written to profile_dir, viewable in
        # TensorBoard/Perfetto.  The reference's only observability is
        # per-draw stats; the per-draw stats pipeline here is unchanged.
        self._profile_dir = profile_dir
        # Convergence early-stop (ConvergenceStop): posterior draws of
        # stop_when.var accumulate host-side per chunk; `converged` flips
        # once the criteria hold and run()/wait_timeout() stop launching.
        self.stop_when = stop_when
        self.converged = False
        self._post_buffer: list = []
        self._post_thin = 1
        self._post_seen = 0
        self._last_callback = 0.0
        # Rate-limit the progress callback like the reference's
        # ProgressCallback (src/sampler.rs:1262-1265,1340-1363).
        self.progress_rate_seconds = 0.5
        # Unrecoverable-error detection (reference: LogpError::is_recoverable,
        # src/math/math.rs:9-13; abort plumbing src/sampler.rs:1202-1207).
        # The batched kernels turn every logp failure into a divergence; a
        # PERMANENT failure is recognized between chunks as `fail_after`
        # consecutive draws that all diverged while the position never moved
        # (a NaN-logp chain can never accept a proposal).  None disables.
        self.fail_after = fail_after
        self._div_streak = np.zeros(settings.num_chains, np.int64)
        self._last_pos: Optional[np.ndarray] = None
        self._failed_chains: list = []
        # Chain-batch splitting (for models where one huge batched launch
        # faults the device or runs out of device memory while smaller
        # launches run fine).  Each chunk runs ceil(C / max_chains_per_launch) sequential device
        # launches over chain groups; per-chain RNG/state make the split
        # bit-transparent for independent-chain settings.
        # "auto": resolve the largest non-faulting launch size by probing a
        # 2-draw chunk at full batch before the first real launch, halving on
        # a device fault or out-of-memory error (both are launch-shape
        # triggered — users shouldn't have to discover that in production
        # and then guess a divisor).
        self._auto_launch_probe = max_chains_per_launch == "auto"
        self._probed_runners: set = set()
        if self._auto_launch_probe:
            max_chains_per_launch = None
            if mesh is not None:
                raise ValueError(
                    'max_chains_per_launch="auto" is incompatible with mesh '
                    "execution (shard the chain axis instead)")
            if progress_tick is not None:
                raise ValueError(
                    'max_chains_per_launch="auto" may resolve to split '
                    "launches, which progress_tick does not support")
        if max_chains_per_launch is not None:
            if mesh is not None:
                raise ValueError(
                    "max_chains_per_launch is incompatible with mesh "
                    "execution (shard the chain axis instead)")
            if getattr(settings, "cross_chain_adaptation", False):
                # Pooling is a psum over the vmapped chain axis INSIDE one
                # launch, so each group of max_chains_per_launch chains
                # pools independently.  Statistically this is still pooled
                # adaptation (over B chains instead of C); allowed with a
                # warning because split launches exist precisely for models
                # where one full-batch launch faults the device.
                warnings.warn(
                    "cross_chain_adaptation with max_chains_per_launch "
                    f"pools within each {max_chains_per_launch}-chain "
                    "launch group only", UserWarning)
            if settings.num_chains % max_chains_per_launch:
                raise ValueError(
                    f"num_chains ({settings.num_chains}) must be a multiple "
                    f"of max_chains_per_launch ({max_chains_per_launch})")
        self.max_chains_per_launch = max_chains_per_launch
        # Device->host payload knobs: where the device->host link dominates
        # (1000+ chains at small d), ``keep_stats`` drops un-listed stat arrays ON DEVICE (never
        # transferred, never stored) and ``draw_dtype`` down-casts the
        # position draws (e.g. jnp.float16 halves the dominant array).
        # Keys the controller itself consumes are always retained.
        if keep_stats is not None:
            needed = {"position", "diverging", "n_steps", "step_size"}
            if stop_when is not None:
                needed.add(stop_when.var)
            keep_stats = set(keep_stats) | needed
        self._stats_keep = keep_stats
        self.draw_dtype = draw_dtype
        # Symmetric knob for the REST of the stats tree: float stat arrays
        # (accept rates, energies, step sizes, ...) down-cast on device
        # before transfer/storage.  Positions are governed by draw_dtype;
        # int/bool stats keep their dtypes.  Diagnostics promote to f64
        # internally, so the cost is storage precision, not compute.
        self.stats_dtype = stats_dtype
        # ``store_warmup=False``: warmup rows are not stored (reference:
        # ``ZarrAsyncConfig::store_warmup``, src/storage/zarr/async_impl.rs:
        # 660-668 — "only post-warmup samples are stored").  Extension
        # of the semantics: for all-tuning chunks the draw/stat
        # payload is dropped ON DEVICE — only the accounting planes
        # (diverging/n_steps/step_size) and the stuck-chain detector's
        # position-equality mask cross the D2H link, so warmup transfer
        # cost disappears along with the storage.  Chunks that straddle the
        # warmup/posterior boundary (MCLMC's trajectory-switch phases)
        # transfer normally and drop the tuning rows host-side.
        self.store_warmup = store_warmup
        # Device-fault auto-recovery (SURVEY.md §5 failure recovery, beyond
        # the reference): with auto_recover=N, the sampler keeps a HOST
        # snapshot of the device state at every completed-chunk boundary
        # (one extra D2H of the state pytree per chunk) and, when a chunk
        # dies with a device-fault error (worker crash/restart, OOM),
        # restores the snapshot,
        # HALVES the chain-group launch size, rebuilds fresh executables,
        # and replays from the boundary — up to N times.  Storage stays
        # consistent because the snapshot is taken only after the chunk is
        # fully recorded.  Requires model data captured in jit closures to
        # be host (numpy) arrays so re-tracing re-uploads it.  Disables
        # run()'s launch/finish pipelining.  Incompatible with mesh
        # execution (a multi-chip fault domain needs external orchestration).
        if auto_recover is True:
            auto_recover = 3
        self._auto_recover = int(auto_recover or 0)
        self._recover_left = self._auto_recover
        if self._auto_recover and mesh is not None:
            raise ValueError(
                "auto_recover is incompatible with mesh execution")
        if recovery_path is not None and not recovery_path.endswith(".npz"):
            recovery_path += ".npz"  # np.savez appends it silently otherwise
        self.recovery_path = recovery_path
        self._snap_state = None
        self._snap_draw = 0
        self._snap_streak = None
        self._snap_last_pos = None
        if self._auto_recover:
            self._take_snapshot()

        # Upfront trace-schema declaration (reference: the Zarr backend
        # creates every array at trace init, sync_impl.rs:487-521): backends
        # that opt in get the reflected schema before the first draw, so a
        # reader attaching mid-run sees the complete hierarchy from draw 0
        # and a stat that never fires still declares itself.
        if getattr(self.trace, "wants_schema", False):
            try:
                self.trace.declare_schema(self.schema())
            except Exception as e:
                warnings.warn(
                    f"trace schema reflection failed ({e!r}); storage "
                    "arrays will materialize on first write", RuntimeWarning)

    def _materialize_snapshot(self):
        """D2H copy of the device state for auto-recovery — the fault-prone
        half of the snapshot, split out so _finish_chunk can run it BEFORE
        the chunk's host-side accounting (a fault here must replay a chunk
        that was never recorded, not one that was).  Typed PRNG keys
        round-trip via key_data/wrap_key_data (same scheme as
        checkpoint.py)."""
        from .checkpoint import _is_key

        return jax.tree.map(
            lambda x: (np.asarray(jax.random.key_data(x)) if _is_key(x)
                       else np.asarray(x)), self.state)

    def _commit_snapshot(self, snap_state) -> None:
        """Adopt a materialized state snapshot as the replay boundary —
        pure host work, safe after record/progress/convergence accounting."""
        self._snap_state = snap_state
        self._snap_draw = self._next_draw
        self._snap_streak = self._div_streak.copy()
        self._snap_last_pos = (None if self._last_pos is None
                               else self._last_pos.copy())

    def _take_snapshot(self) -> None:
        """Host snapshot of everything needed to replay from this chunk
        boundary (see ``auto_recover``)."""
        self._commit_snapshot(self._materialize_snapshot())

    def _spill_snapshot(self, path: str) -> None:
        """Write the replay snapshot to disk in checkpoint format, so a
        fresh process resumes it with :meth:`restore` (see
        :class:`DeviceLostError`).  Pure host work — safe on a dead device."""
        from .checkpoint import _is_key

        snap_leaves = jax.tree.leaves(self._snap_state)
        # Key flags come from the live state's leaf METADATA (dtype checks
        # work on deleted device arrays).
        flags = [i for i, leaf in enumerate(jax.tree.leaves(self.state))
                 if _is_key(leaf)]
        arrays = {f"leaf_{i}": np.asarray(a)
                  for i, a in enumerate(snap_leaves)}
        arrays["__key_leaves__"] = np.asarray(flags, np.int64)
        arrays["__next_draw__"] = np.asarray(self._snap_draw, np.int64)
        arrays["__num_leaves__"] = np.asarray(len(snap_leaves), np.int64)
        np.savez(path, **arrays)

    _RECOVERABLE_TOKENS = ("UNAVAILABLE", "crashed or restarted",
                           "RESOURCE_EXHAUSTED", "DATA_LOSS", "kernel fault")

    @staticmethod
    def _wait_device_alive(attempts: int = 6) -> bool:
        """Probe the device with exponential backoff (a restarting worker
        raises UNAVAILABLE on requests issued immediately after a crash)."""
        delay = 5.0
        for _ in range(attempts):
            try:
                jax.block_until_ready(jnp.zeros(8) + 1.0)
                return True
            except Exception:
                time.sleep(delay)
                delay = min(delay * 2, 60.0)
        return False

    def _resolve_launch_size(self) -> None:
        """``max_chains_per_launch="auto"``: find the largest chain-group
        size that launches without a device fault, by running the current
        phase's runner on a 2-draw chunk and halving on fault (device
        faults and out-of-memory errors are launch-shape-triggered).  Runs
        lazily at each PHASE's first launch
        (warmup and posterior run different kernels, so a fault can be
        phase-specific); later probes start from the already-resolved group
        size.  A faulting probe loses only a re-uploadable state copy."""
        from .checkpoint import _is_key

        C = self.settings.num_chains
        lo = self._next_draw
        hi0 = min(lo + 2, self._total)
        # Host copy of the pristine state: a faulting probe kills the worker
        # and every device buffer with it; survivors re-upload from here.
        host = jax.tree.map(
            lambda x: np.asarray(jax.random.key_data(x) if _is_key(x)
                                 else x), self.state)

        def upload(n=None):
            def up(ref, a):
                if n is not None and a.ndim >= 1 and a.shape[0] == C:
                    a = a[:n]
                arr = jnp.asarray(a)
                return (jax.random.wrap_key_data(arr) if _is_key(ref)
                        else arr)
            return jax.tree.map(up, self.state, host)

        b = self.max_chains_per_launch or C
        while True:
            start, end, runner = next(
                (s, e, r) for s, e, r in self._phase_runners if s <= lo < e)
            hi = min(hi0, end)
            flags = self.settings.extra_flags(
                _schedule_chunk(self.schedule, lo, hi), lo, hi)
            try:
                out = runner(upload(None if b == C else b), flags)
                jax.block_until_ready(out)
                break
            except Exception as e:
                msg = f"{type(e).__name__}: {e}"
                if b <= 1 or not any(tok in msg
                                     for tok in self._RECOVERABLE_TOKENS):
                    raise
                nb = max(1, b // 2)
                while C % nb:  # keep the group size a divisor of C
                    nb -= 1
                warnings.warn(
                    f"launch-size probe: a {b}-chain launch faulted the "
                    f"device ({msg[:160]}); retrying at {nb}",
                    RuntimeWarning)
                b = nb
                if not self._wait_device_alive():
                    raise DeviceLostError(
                        "device unreachable after a launch-size probe "
                        "fault; restart the process and pass an explicit "
                        f"max_chains_per_launch (try {b}; sizes >= "
                        f"{min(b * 2, C)} faulted)") from e
                # Executables compiled before the worker restart are bound
                # to the dead device instance.
                self._build_phase_runners(fresh=True)
        # The successful probe DONATED its upload and advanced a throwaway
        # copy; the real run starts from the pristine state at draw `lo`.
        self._probed_runners.add(id(runner))
        self.state = upload()
        if b < C:
            self.max_chains_per_launch = b
            if getattr(self.settings, "cross_chain_adaptation", False):
                warnings.warn(
                    "cross_chain_adaptation with the probed "
                    f"max_chains_per_launch={b} pools within each "
                    f"{b}-chain launch group only", UserWarning)

    def _maybe_recover(self, err: Exception) -> bool:
        """Restore the last chunk-boundary snapshot after a device fault and
        shrink the launch batch; False when not eligible (error type, budget,
        feature off) — the caller re-raises."""
        if not self._auto_recover or self._recover_left <= 0:
            return False
        msg = f"{type(err).__name__}: {err}"
        if not any(tok in msg for tok in self._RECOVERABLE_TOKENS):
            return False
        self._recover_left -= 1
        if self.progress_tick is None:  # ticks forbid split launches
            C = self.settings.num_chains
            b = self.max_chains_per_launch or C
            if b > 1:
                nb = max(1, b // 2)
                while C % nb:  # keep the group size a divisor of C
                    nb -= 1
                self.max_chains_per_launch = nb
        warnings.warn(
            f"device fault during the chunk at draw {self._snap_draw} "
            f"({msg[:200]}); restoring the snapshot and retrying with "
            f"max_chains_per_launch={self.max_chains_per_launch} "
            f"({self._recover_left} retries left)", RuntimeWarning)
        # The worker may still be RESTARTING (a re-upload issued right after
        # a worker crash can raise UNAVAILABLE): probe the device with exponential backoff before
        # moving the snapshot back on.
        alive = self._wait_device_alive()
        if not alive:
            # In-process reconnection is impossible on some platforms: a
            # remote client can stay wedged after a worker crash even
            # through jax.extend.backend.clear_backends().  Escape hatch: spill the replay snapshot to disk in checkpoint
            # format, flush storage, and tell the caller to resume in a
            # fresh process via Sampler.restore().
            if self.recovery_path is not None:
                self._spill_snapshot(self.recovery_path)
                try:
                    self.flush()
                except Exception:
                    pass
                raise DeviceLostError(
                    f"device unreachable after a fault; the draw-"
                    f"{self._snap_draw} snapshot was saved to "
                    f"{self.recovery_path!r} — build a Sampler with the "
                    "same settings in a NEW process and call "
                    f"restore({self.recovery_path!r}) to continue"
                ) from err
            return False  # caller re-raises the original fault
        from .checkpoint import _is_key

        self.state = jax.tree.map(
            lambda ref, a: (jax.random.wrap_key_data(jnp.asarray(a))
                            if _is_key(ref) else jnp.asarray(a)),
            self.state, self._snap_state)
        self._next_draw = self._snap_draw
        self._div_streak = self._snap_streak.copy()
        self._last_pos = (None if self._snap_last_pos is None
                          else self._snap_last_pos.copy())
        self._tick_base = None
        self._live_done = 0
        # Fresh jit objects: executables compiled before a worker restart
        # may be bound to the dead device instance (so the cross-instance
        # runner cache must be bypassed AND purged of the stale wrappers).
        self._build_phase_runners(fresh=True)
        return True

    def _build_phase_runners(self, fresh: bool = False):
        """(Re)build the per-phase jitted runners from ``self.settings``.

        Called from ``__init__`` and again after a device fault.

        ``fresh=True`` (device-fault recovery) bypasses the cross-instance
        runner cache and evicts this key's entry: executables compiled
        before a worker restart may be bound to the dead device instance.
        """
        settings, model, mesh = self.settings, self.model, self.mesh
        precision = self._precision

        reuse_key = self._runner_reuse_key()
        if fresh:
            # A worker restart invalidates EVERY cached executable (they are
            # bound to the dead device instance), not just this sampler's
            # entry — other keys would otherwise serve stale wrappers to
            # later samplers on the healthy restarted worker.
            _RUNNER_CACHE.clear()
            _RUNNER_CACHE_ORDER.clear()
        elif reuse_key is not None and reuse_key in _RUNNER_CACHE:
            self._phase_runners = _RUNNER_CACHE[reuse_key]
            self._probe_runners = []
            _RUNNER_CACHE_ORDER.remove(reuse_key)
            _RUNNER_CACHE_ORDER.append(reuse_key)
            return

        # Phases: draw-index ranges with their own compiled runner (MCLMC's
        # Euclidean -> Microcanonical switch and the async posterior kernel
        # are host-known boundaries).  Runners trace under the configured
        # matmul precision.
        def jit_prec(fn):
            if precision is None:
                return jax.jit(fn, donate_argnums=0)

            @functools.wraps(fn)
            def wrapped(*a, **k):
                with jax.default_matmul_precision(precision):
                    return fn(*a, **k)
            return jax.jit(wrapped, donate_argnums=0)

        if mesh is not None:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            from .parallel.axis import DIM_AXIS, dim_axis_ctx
            from .parallel.mesh import CHAIN_AXIS, chain_specs, stats_specs

            spec_dim = model.dim if self._dim_sharded else None
            state_specs = chain_specs(self.state, spec_dim)

            if self._dim_sharded:
                # Axis-free twin runners for out-shape discovery: stats
                # shapes don't depend on the collectives, and tracing the
                # real runner outside shard_map would leave psum("chains")
                # unbound.
                probe_kw = {
                    k: v for k, v in (("mesh_axis_name", None),
                                      ("cross_chain_adaptation", False))
                    if hasattr(settings, k)}
                probe_settings = (dataclasses.replace(settings, **probe_kw)
                                  if probe_kw else settings)
                probe_config = probe_settings.chain_config()
                probe_strategy = _strategy_for(probe_settings, probe_config)
                self._probe_runners = [
                    r for _, _, r in probe_settings.build_phases(
                        model, probe_strategy, probe_config)]
            else:
                self._probe_runners = []

            def wrap_mesh(runner, probe_runner=None):
                # flags are per-draw scalars (replicated); stats come back
                # [draws, chains, ...] so the chain axis is axis 1.  Under a
                # 2-D mesh the runner body traces inside dim_axis_ctx, which
                # turns every parameter-axis contraction into psum("dim")
                # (parallel/axis.py), and parameter-indexed stats shard their
                # trailing axis.
                if self._dim_sharded:
                    def body(state, flags):
                        with dim_axis_ctx(DIM_AXIS):
                            return runner(state, flags)

                    # Out-structure discovery: specs depend only on ranks /
                    # trailing dims, so a 1-draw eval_shape suffices.
                    flags1 = self.settings.extra_flags(
                        _schedule_chunk(self.schedule, 0, 1), 0, 1)
                    out_shapes = jax.eval_shape(
                        probe_runner or runner, self.state, flags1)
                    out_stats_specs = stats_specs(out_shapes[1], model.dim)
                else:
                    body = runner
                    out_stats_specs = P(None, CHAIN_AXIS)
                return shard_map(
                    body, mesh=mesh, in_specs=(state_specs, P()),
                    out_specs=(state_specs, out_stats_specs),
                    check_vma=False)
        else:
            self._probe_runners = []

            def wrap_mesh(runner, probe_runner=None):
                return runner

        # One jitted wrapper per distinct runner: phases that share a runner
        # share the jit object and its compile cache.
        jitted: dict[int, Any] = {}
        self._phase_runners = []
        for i, (start, end, runner) in enumerate(settings.build_phases(
                model, self.strategy, self.config)):
            if id(runner) not in jitted:
                r = runner
                if (self.progress_tick is not None
                        and isinstance(r, functools.partial)
                        and r.func is _scan_chunk):
                    # Live-progress variant of the sync scan (see __init__).
                    r = functools.partial(
                        _scan_chunk_ticked, r.args[0], self._tick_fn,
                        self.progress_tick, settings.num_chains)
                probe = (self._probe_runners[i]
                         if i < len(self._probe_runners) else None)
                jitted[id(runner)] = jit_prec(wrap_mesh(r, probe))
            self._phase_runners.append((start, end, jitted[id(runner)]))

        if reuse_key is not None:
            _RUNNER_CACHE[reuse_key] = self._phase_runners
            _RUNNER_CACHE_ORDER.append(reuse_key)
            while len(_RUNNER_CACHE_ORDER) > _RUNNER_CACHE_MAX:
                old = _RUNNER_CACHE_ORDER.pop(0)
                _RUNNER_CACHE.pop(old, None)

    def _runner_reuse_key(self):
        """Cache key for cross-instance runner reuse, or None when the
        runners close over per-sampler state (mesh specs, tick callbacks) or
        the settings aren't safely hashable (user flow_spec objects)."""
        if self.mesh is not None or self.progress_tick is not None:
            return None
        if getattr(self.settings, "flow_spec", None) is not None:
            return None
        try:
            hash(self.settings)
        except TypeError:
            return None
        return (id(self.model), self.settings, self._precision)

    @property
    def finished(self) -> bool:
        return self._next_draw >= self._total

    def run_next_chunk(self):
        """Launch one chunk and stream it to storage.

        Returns ``(lo, stats, tuning)`` — the chunk's first global draw index,
        the host-side stats dict (``stats[name]`` shaped [chains, k, ...]
        including expanded deterministics), and the per-draw tuning mask — so
        callers like :func:`sample_sequentially` can consume draws lazily as
        they land.
        """
        while True:
            try:
                return self._finish_chunk(*self._launch_chunk())
            except Exception as e:
                # Device-fault auto-recovery (see ``auto_recover``): restore
                # the last chunk-boundary snapshot and replay.
                if not self._maybe_recover(e):
                    raise

    def _launch_chunk(self):
        """Dispatch one chunk's device computation (async) and advance the
        draw cursor; host-side processing happens in :meth:`_finish_chunk`.
        Splitting the two lets :meth:`run` overlap chunk N's device->host
        streaming with chunk N+1's device compute."""
        lo = self._next_draw
        if self._auto_launch_probe:
            probe_runner = next(
                r for s, e, r in self._phase_runners if s <= lo < e)
            if id(probe_runner) not in self._probed_runners:
                self._resolve_launch_size()
        start, end, runner = next(
            (s, e, r) for s, e, r in self._phase_runners if s <= lo < e)
        hi = min(lo + self.chunk_size, self._total, end)
        if self.progress_tick is not None:
            # Baseline for the in-chunk ticks' provisional absolute values.
            self._tick_lo = lo
            self._tick_base = [(p.finished_draws, p.divergences,
                                p.total_num_steps) for p in self.progress]
            self._live_done = 0
        flags = _schedule_chunk(self.schedule, lo, hi)
        flags = self.settings.extra_flags(flags, lo, hi)
        t0 = time.monotonic()
        if self._profile_dir is not None:
            with jax.profiler.trace(self._profile_dir):
                self.state, stats = self._run_runner(runner, flags)
                jax.block_until_ready(stats)
        else:
            self.state, stats = self._run_runner(runner, flags)
        self._next_draw = hi
        return lo, hi, stats, t0

    def _run_runner(self, runner, flags):
        """One chunk's device computation — split into sequential chain-group
        launches when ``max_chains_per_launch`` is set (see __init__)."""
        B = self.max_chains_per_launch
        C = self.settings.num_chains
        if B is None or B >= C:
            return runner(self.state, flags)

        def split(x, g):
            # per-chain leaves carry a leading [C] axis; scalars (draw_idx)
            # are launch-invariant — but must be COPIED per group, since the
            # runner donates its input buffers and the same buffer cannot be
            # donated twice
            if getattr(x, "ndim", 0) >= 1 and x.shape[0] == C:
                return x[g * B:(g + 1) * B]
            return jnp.array(x, copy=True)

        def join(*xs):
            if getattr(xs[0], "ndim", 0) >= 1 and xs[0].shape[0] == B:
                return jnp.concatenate(xs, axis=0)
            return xs[0]

        out_states, out_stats = [], []
        for g in range(C // B):
            sub = jax.tree.map(lambda x: split(x, g), self.state)
            s2, st = runner(sub, flags)
            out_states.append(s2)
            out_stats.append(st)
        state = jax.tree.map(join, *out_states)
        # stats are [draws, chains, ...]: chain axis is 1
        stats = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1),
                             *out_stats)
        return state, stats

    def _finish_chunk(self, lo, hi, stats, t0):
        # Transfer-reduction knobs run ON DEVICE, before any D2H move.
        if self._stats_keep is not None:
            stats = {k: v for k, v in stats.items() if k in self._stats_keep}
        # store_warmup=False + a chunk made entirely of tuning draws: the
        # whole draw/stat payload drops on device — only the accounting
        # planes (and the detector mask below) cross the link.
        tuning = self.schedule.is_tuning[lo:hi]
        drop_warm = (not self.store_warmup and hi > lo
                     and bool(tuning.all()))
        pos_full_dev = None
        detector_same = None
        if "position" in stats and (self.draw_dtype is not None or drop_warm):
            stats = dict(stats)
            pos_full_dev = stats["position"]       # [k, C, d] full precision
            if self.fail_after is not None:
                # The stuck-chain detector compares successive positions for
                # EQUALITY; in a downcast dtype (f16) genuinely tiny moves
                # round to bit-identical values and a slow-but-healthy chain
                # would be declared permanently failed.  Compute the
                # comparison ON DEVICE in full precision (NaN equal to NaN,
                # matching the host detector) and hand the [k, C] mask over;
                # only the copy bound for storage is downcast.
                prev = (pos_full_dev[0] if self._last_pos is None
                        else jnp.asarray(self._last_pos,
                                         dtype=pos_full_dev.dtype))
                prev_all = jnp.concatenate([prev[None], pos_full_dev[:-1]], 0)
                eq = ((pos_full_dev == prev_all)
                      | (jnp.isnan(pos_full_dev) & jnp.isnan(prev_all)))
                same = jnp.all(eq, axis=-1)        # [k, C]
                if self._last_pos is None:
                    # The run's first draw has no predecessor: it moved.
                    same = same.at[0].set(False)
                detector_same = same
            if drop_warm:
                pass                     # dropped below; never downcast
            elif self.draw_dtype is not None:
                stats["position"] = stats["position"].astype(self.draw_dtype)
        if drop_warm:
            keep = {"diverging", "n_steps", "step_size"}
            stats = {k: v for k, v in stats.items() if k in keep}
        if self.stats_dtype is not None:
            stats = {k: (v.astype(self.stats_dtype)
                         if k != "position"
                         and jnp.issubdtype(v.dtype, jnp.floating)
                         else v)
                     for k, v in stats.items()}
        # Device -> host; [k, C, ...] -> [C, k, ...]
        stats = jax.tree.map(lambda x: np.moveaxis(np.asarray(x), 0, 1), stats)
        if detector_same is not None:
            detector_same = np.moveaxis(np.asarray(detector_same), 0, 1)
        detector_last = (np.asarray(pos_full_dev[-1])
                         if pos_full_dev is not None
                         and self.fail_after is not None else None)
        elapsed = time.monotonic() - t0
        # Auto-recovery: materialize the post-chunk state snapshot BEFORE
        # the host-side accounting below.  The snapshot D2H is the one
        # device interaction that used to run AFTER record_chunk; a worker
        # crash surfacing there replayed an already-recorded chunk, double-
        # counting ChainProgress/divergence events and misaligning the
        # convergence buffer.  The snapshot is COMMITTED (adopted as the
        # replay boundary) only once everything is recorded.
        pending_snap = (self._materialize_snapshot()
                        if self._auto_recover else None)

        expanded = {}
        if self._expand_chunk is not None and not drop_warm:
            k = hi - lo
            c = self.settings.num_chains
            keys = jax.random.split(
                jax.random.fold_in(self._expand_key, lo), (c, k))
            # Expansion reads the FULL-precision positions when draw_dtype
            # downcasts the stored copy (deterministics must not inherit
            # f16 rounding; the device array also skips a host round-trip).
            pos_for_expand = (jnp.moveaxis(pos_full_dev, 0, 1)
                              if pos_full_dev is not None
                              else stats["position"])
            exp = self._expand_chunk(keys, pos_for_expand)
            expanded = {name: np.asarray(v) for name, v in exp.items()}
        if self.model.expand_host_fn is not None and not drop_warm:
            # Host-side expansion: arbitrary numpy dtypes (strings,
            # datetime64 — nuts-storable Value parity; see Model).  A
            # two-argument fn also receives the chunk's first GLOBAL draw
            # index, so draw-indexed outputs don't shift with chunk_size (a
            # performance knob must never change stored data).  Like the
            # device expansion above, the host fn sees the FULL-precision
            # positions when draw_dtype downcasts the stored copy.
            pos_np = (np.moveaxis(np.asarray(pos_full_dev), 0, 1)
                      if pos_full_dev is not None
                      else np.asarray(stats["position"]))
            if self._expand_host_wants_offset:
                expanded.update(self.model.expand_host_fn(pos_np, lo))
            else:
                expanded.update(self.model.expand_host_fn(pos_np))

        if drop_warm:
            pass          # all-tuning chunk with store_warmup=False: no rows
        elif not self.store_warmup and tuning.any():
            # Mixed warmup/posterior chunk (MCLMC trajectory-switch phases):
            # transferred in full, tuning rows dropped host-side.
            split = int(tuning.sum())
            self.trace.record_chunk(
                lo + split,
                {k: v[:, split:] for k, v in stats.items()},
                {k: np.asarray(v)[:, split:] for k, v in expanded.items()},
                tuning[split:])
        else:
            self.trace.record_chunk(lo, stats, expanded, tuning)
        if self.stop_when is not None and not self.converged and not drop_warm:
            merged = {**stats, **expanded}
            x = np.asarray(merged[self.stop_when.var])
            post = x[:, ~tuning]
            if post.shape[1]:
                # Keep only the checked dims (check_dims exists to cap host
                # cost for huge-d models) and the draw dtype — diagnostics
                # promote to f64 internally.
                if (self.stop_when.check_dims is not None
                        and post.ndim == 3):
                    post = post[..., : self.stop_when.check_dims]
                # Keep only every _post_thin-th posterior draw (aligned on
                # the GLOBAL posterior index so thinning is phase-coherent
                # across chunks), then double the stride whenever the buffer
                # outgrows max_buffer_draws.
                thin = self._post_thin
                idx = np.arange(self._post_seen,
                                self._post_seen + post.shape[1])
                self._post_seen += post.shape[1]
                keep = (idx % thin) == 0
                if keep.any():
                    self._post_buffer.append(post[:, keep].copy())
                series = (self._post_buffer[0] if len(self._post_buffer) == 1
                          else np.concatenate(self._post_buffer, axis=1))
                while series.shape[1] > self.stop_when.max_buffer_draws:
                    series = series[:, ::2]
                    self._post_thin *= 2
                    self._post_buffer = [series]
                self.converged = self.stop_when.satisfied(series)
        self._update_progress(lo, stats, tuning, elapsed)
        if self.fail_after is not None:
            self._detect_failed_chains(stats, same=detector_same,
                                       last_pos=detector_last)
        if self.progress_callback is not None:
            now = time.monotonic()
            if (now - self._last_callback >= self.progress_rate_seconds
                    or self.finished):
                self._last_callback = now
                self.progress_callback(self.progress)
        if self._auto_recover:
            # Chunk fully recorded + accounted: commit the replay boundary
            # (state already materialized above, before the accounting).
            self._commit_snapshot(pending_snap)
        return lo, {**stats, **expanded}, tuning

    def _tick_fn(self, done, divs, steps, last, step_size):
        """In-chunk live-progress callback (see ``progress_tick``).

        Runs on the JAX callback thread while the device computes; callbacks
        are unordered, so only a strictly newer tick (larger draws-done)
        applies.  Values written here are PROVISIONAL — e.g. divergences
        count tuning draws too — and are replaced by the exact chunk-end
        accounting in :meth:`_update_progress`.
        """
        done = int(done)
        if done <= self._live_done or self._tick_base is None:
            return
        self._live_done = done
        base, lo = self._tick_base, self._tick_lo
        tuning = bool(self.schedule.is_tuning[min(lo + done - 1,
                                                  self._total - 1)])
        divs, steps, last = np.asarray(divs), np.asarray(steps), np.asarray(last)
        step_size = np.asarray(step_size)
        for c, prog in enumerate(self.progress):
            b = base[c]
            prog.started = True
            prog.finished_draws = b[0] + done
            prog.divergences = b[1] + int(divs[c])
            prog.total_num_steps = b[2] + int(steps[c])
            prog.latest_num_steps = int(last[c])
            prog.step_size = float(step_size[c])
            prog.tuning = tuning
        cb = self.progress_callback
        if cb is None:
            return
        now = time.monotonic()
        if now - self._last_callback >= self.progress_rate_seconds:
            self._last_callback = now
            cb(self.progress)

    def _update_progress(self, lo, stats, tuning, elapsed):
        if self.progress_tick is not None and self._tick_base is not None:
            # All of this chunk's ticks have fired once the device results
            # are on the host, but flush the callback queue and rewind the
            # provisional values before the exact accumulation below.
            try:
                jax.effects_barrier()
            except Exception:
                # A dying runtime can fail the barrier AFTER this chunk was
                # recorded; the rewind below still applies (late ticks see
                # _tick_base None and return), and the fault resurfaces at
                # the next launch where replay is safe.
                pass
            for c, prog in enumerate(self.progress):
                (prog.finished_draws, prog.divergences,
                 prog.total_num_steps) = self._tick_base[c]
            self._tick_base = None
        k = stats["diverging"].shape[1]
        # Per-chain runtime estimate: chains share one device computation, so
        # the chunk wall-clock is common; a chain's *active* time is
        # proportional to its leapfrog count, with the busiest chain defining
        # the wall (straggler effect under the sync kernel).  The
        # reference accumulates genuine per-chain thread time
        # (src/sampler.rs:1038-1050); this is the batched-execution analog.
        steps_per_chain = stats["n_steps"].sum(axis=1).astype(np.float64)
        max_steps = max(float(steps_per_chain.max()), 1.0)
        for c, prog in enumerate(self.progress):
            prog.started = True
            div_mask = stats["diverging"][c] & ~tuning
            prog.divergences += int(div_mask.sum())
            prog.divergent_draws.extend((lo + np.nonzero(div_mask)[0]).tolist())
            prog.finished_draws += k
            prog.tuning = bool(tuning[-1])
            prog.latest_num_steps = int(stats["n_steps"][c, -1])
            prog.total_num_steps += int(stats["n_steps"][c].sum())
            prog.step_size = float(stats["step_size"][c, -1])
            prog.runtime += elapsed * (steps_per_chain[c] / max_steps)

    def _detect_failed_chains(self, stats, same=None, last_pos=None) -> None:
        """Between-chunk unrecoverable-failure detector (see ``fail_after``).

        A chain accumulates a "stuck" streak over draws that BOTH diverged
        and left the position identical to the previous draw (NaN-equal —
        a NaN coordinate must still read as "not moved"); any move or
        non-divergent draw resets it.  Even a heavily-diverging but healthy
        chain moves occasionally (a divergent tree's partial proposal can
        be accepted), so ``fail_after`` consecutive frozen divergent draws
        indicates a permanently-failing logp, the reference's unrecoverable
        ``LogpError`` (``None`` disables the detector).  Crossing
        ``fail_after`` marks the chain failed in :class:`ChainProgress`;
        :meth:`run` / :meth:`wait_timeout` then finalize the traces and
        raise :class:`ChainFailedError` (reference: src/sampler.rs:1202-1207
        stops the chain, 1452-1457 still finalizes every trace).
        """
        div = np.asarray(stats["diverging"]).astype(bool)  # [C, k]
        C, k = div.shape
        if same is not None:
            # draw_dtype path: the position-equality mask was computed ON
            # DEVICE in full precision (_finish_chunk) because the stored
            # positions are downcast; ``last_pos`` is the full-precision
            # final position.
            if not div.any():
                self._div_streak[:] = 0
                self._last_pos = last_pos
                return
            stuck = div & same
            self._last_pos = last_pos
        else:
            pos = np.asarray(stats["position"])          # [C, k, d]
            if not div.any():
                # Nothing can extend a streak; every chain had an ok draw.
                self._div_streak[:] = 0
                self._last_pos = pos[:, -1].copy()
                return
            # Per-draw comparison slices ([C, d] temporaries) instead of one
            # [C, k+1, d] concatenated copy — at 1024 chains x 700-draw
            # chunks the copy transiently doubled the largest host buffer.
            stuck = np.zeros((C, k), bool)
            prev = self._last_pos  # None on the run's first chunk: no
            for j in range(k):     # predecessor, first draw counts as moved
                if prev is not None and div[:, j].any():
                    cur = pos[:, j]
                    eq = (cur == prev) | (np.isnan(cur) & np.isnan(prev))
                    stuck[:, j] = div[:, j] & eq.all(axis=-1)
                prev = pos[:, j]
            self._last_pos = pos[:, -1].copy()
        ok = ~stuck
        has_ok = ok.any(axis=1)
        last_ok = np.where(has_ok, k - 1 - np.argmax(ok[:, ::-1], axis=1), -1)
        self._div_streak = np.where(
            has_ok, k - 1 - last_ok, self._div_streak + k)
        newly = np.nonzero((self._div_streak >= self.fail_after)
                           & ~np.array([p.failed for p in self.progress]))[0]
        for c in newly.tolist():
            self.progress[c].failed = True
            self.progress[c].error = (
                f"chain {c}: logp function appears permanently failing — "
                f"{int(self._div_streak[c])} consecutive divergent draws "
                "with no accepted move (unrecoverable; see "
                "ChainFailedError)")
            self._failed_chains.append(c)

    def _raise_if_failed(self) -> None:
        if not self._failed_chains:
            return
        self.flush()
        trace = self.trace.finalize()
        chains = list(self._failed_chains)
        msgs = "; ".join(
            str(self.progress[c].error) for c in chains[:3])
        raise ChainFailedError(
            f"{len(chains)} chain(s) failed unrecoverably: {msgs}"
            + (" ..." if len(chains) > 3 else ""),
            trace=trace, chains=chains)

    def pause(self) -> None:
        """Stop launching further chunks from :meth:`run` (the reference's
        chain pause commands, src/sampler.rs:1469-1490; granularity here is
        the chunk)."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def run(self) -> Trace:
        # Pipelined: dispatch chunk N+1 (async device compute) BEFORE doing
        # chunk N's host-side work, so device->host streaming and storage
        # writes overlap the next chunk's compute instead of serializing
        # with it.
        pending = None
        # Ticks need ordered tick bookkeeping; auto-recovery needs the
        # snapshot boundary to trail the LAST STORED chunk — both require
        # finish-before-next-launch (see their __init__ notes).
        pipelined = self.progress_tick is None and not self._auto_recover
        while (not self.finished and not self.converged
               and not self._failed_chains):
            if self._paused:
                break
            if not pipelined:
                self.run_next_chunk()
                continue
            nxt = self._launch_chunk()
            if pending is not None:
                self._finish_chunk(*pending)
            pending = nxt
        if pending is not None:
            self._finish_chunk(*pending)
        self._raise_if_failed()
        if self.converged and not self.finished:
            # Early convergence stop: finalize the shorter trace.
            self.flush()
            return self.trace.finalize()
        if not self.finished:
            raise RuntimeError(
                "sampler paused before completion; call resume() and run() "
                "again, or inspect() the partial trace")
        return self.trace.finalize()

    def wait_timeout(self, timeout: float) -> Optional[Trace]:
        """Run until finished or ``timeout`` seconds elapse (the reference's
        ``Sampler::wait_timeout``, src/sampler.rs:1526-1542).

        Returns the finalized trace when sampling completed within the
        timeout, else ``None`` — the sampler keeps its state and a later
        ``wait_timeout``/``run`` call continues where it stopped.  The check
        runs between chunks (chains are one device computation), so the
        actual wait can overshoot by up to one chunk's runtime.
        """
        deadline = time.monotonic() + timeout
        while not self.finished:
            self._raise_if_failed()
            if self.converged:
                self.flush()
                return self.trace.finalize()
            if self._paused or time.monotonic() >= deadline:
                return None
            self.run_next_chunk()
        self._raise_if_failed()
        return self.trace.finalize()

    def abort(self) -> Any:
        """Stop sampling now and return the partial results (the reference's
        ``Sampler::abort``, src/sampler.rs:1516-1524, which joins the workers
        and returns the trace written so far).  Storage is flushed; the
        returned value is the backend's ``inspect()`` snapshot."""
        self._paused = True
        self.trace.flush()
        return self.trace.inspect()

    # ---- checkpoint / resume (capability absent from the reference;
    # SURVEY.md §5 recommends adding it since device state is one pytree) ----

    # ---- trace schema reflection (reference: Settings reflects every stat
    # name/type/dims/coords/event-dim BEFORE sampling, src/sampler.rs:73-162)

    _DIV_EVENT_KEYS = ("divergence_start", "divergence_end",
                       "divergence_start_gradient",
                       "divergence_start_momentum", "divergence_momentum",
                       "divergence_energy_error", "divergence_reason")
    _TRANSFORM_EVENT_KEYS = ("mass_matrix_inv", "transformation_mu",
                             "mass_matrix_eigvals", "num_eigenvalues")

    def schema(self):
        """The full trace schema, reflected WITHOUT running any device
        computation (``jax.eval_shape`` on each phase runner — the
        JAX analog of the reference's Settings-level reflection,
        src/sampler.rs:73-162).

        Returns ``{group: {name: {"dtype": np.dtype, "shape": tail_shape,
        "dims": [...]}}}`` for the four draw groups, plus ``"coords"``
        (model coordinate arrays) and ``"events"`` (sparse event streams:
        ``{event_name: {field: {...}}}``; reference nuts-storable event
        dims, src/lib.rs:101-118).  Reflects exactly what will be STORED:
        the ``keep_stats`` / ``draw_dtype`` transfer knobs are applied, and
        host/device expansions are included (host expansion is probed with
        a zero-position call; see Model.expand_host_fn)."""
        from .storage.core import dims_for_tail

        num_tune = self.settings.num_tune
        C = self.settings.num_chains
        warm, post = {}, {}
        for start, end, runner in self._phase_runners:
            probe = min(start, self._total - 1)
            flags = self.settings.extra_flags(
                _schedule_chunk(self.schedule, probe, probe + 1),
                probe, probe + 1)
            _, stats_shape = jax.eval_shape(runner, self.state, flags)
            for name, s in stats_shape.items():
                entry = {"dtype": np.dtype(s.dtype),
                         "shape": tuple(s.shape[2:])}
                if start < num_tune:
                    warm.setdefault(name, entry)
                if end > num_tune:
                    post.setdefault(name, entry)
        if self._stats_keep is not None:
            warm = {k: v for k, v in warm.items() if k in self._stats_keep}
            post = {k: v for k, v in post.items() if k in self._stats_keep}
        if self.draw_dtype is not None:
            for d in (warm, post):
                if "position" in d:
                    d["position"] = dict(d["position"],
                                         dtype=np.dtype(self.draw_dtype))
        if self.stats_dtype is not None:
            # Mirror _finish_chunk's on-device downcast: float stat arrays
            # (not positions) land in storage at stats_dtype, so the
            # declared schema must say so (an upfront-declared f32 array
            # would silently upcast the f16 chunks back on write).
            sd = np.dtype(self.stats_dtype)
            for d in (warm, post):
                for name, e in d.items():
                    if (name != "position"
                            and np.issubdtype(e["dtype"], np.floating)):
                        d[name] = dict(e, dtype=sd)

        expanded = {}
        if self._expand_chunk is not None:
            keys = jax.eval_shape(
                lambda k: jax.random.split(k, (C, 1)), self._expand_key)
            pos_sd = jax.ShapeDtypeStruct(
                (C, 1, self.model.dim), self.dtype)
            exp = jax.eval_shape(self._expand_chunk, keys, pos_sd)
            expanded.update({
                name: {"dtype": np.dtype(s.dtype),
                       "shape": tuple(s.shape[2:])}
                for name, s in exp.items()})
        if self.model.expand_host_fn is not None:
            # Host expansion has no declared schema (arbitrary numpy
            # dtypes); probe it with one zero position.  A fn that cannot
            # handle that is simply not reflected — its arrays materialize
            # on first write as before.
            try:
                zero = np.zeros(
                    (C, 1, self.model.dim),
                    np.dtype(self.draw_dtype) if self.draw_dtype is not None
                    else np.dtype(self.dtype))
                out = (self.model.expand_host_fn(zero, 0)
                       if self._expand_host_wants_offset
                       else self.model.expand_host_fn(zero))
                for name, v in out.items():
                    v = np.asarray(v)
                    expanded.setdefault(
                        name, {"dtype": v.dtype, "shape": tuple(v.shape[2:])})
            except Exception as e:
                # An expand_host_fn that chokes on the zero-position probe
                # is NOT reflected: its arrays materialize lazily on first
                # write — the exact behavior upfront reflection exists to
                # eliminate — so say so instead of silently degrading
                # (round-4 verdict weak #8).
                warnings.warn(
                    "expand_host_fn failed on the schema probe "
                    f"({type(e).__name__}: {str(e)[:200]}); its arrays are "
                    "not reflected upfront and will materialize on first "
                    "write", UserWarning)

        def group(entries):
            return {name: dict(e, dims=dims_for_tail(
                        self.model, name, e["shape"]))
                    for name, e in entries.items()}

        post_names = {k: v for k, v in post.items()
                      if k in _POSTERIOR_STAT_KEYS}
        warm_names = {k: v for k, v in warm.items()
                      if k in _POSTERIOR_STAT_KEYS}
        out = {
            "posterior": group({**post_names, **expanded}),
            "sample_stats": group({k: v for k, v in post.items()
                                   if k not in _POSTERIOR_STAT_KEYS}),
            "warmup_posterior": group({**warm_names, **expanded}),
            "warmup_sample_stats": group({k: v for k, v in warm.items()
                                          if k not in _POSTERIOR_STAT_KEYS}),
            "coords": dict(getattr(self.model, "coords", None) or {}),
        }
        if not self.store_warmup:
            # store_warmup=False: no warmup groups exist anywhere
            # (reference async_impl.rs:660-668 — "only post-warmup samples
            # are stored"), so none are reflected either.
            out["warmup_posterior"] = {}
            out["warmup_sample_stats"] = {}

        # Sparse event streams (storage array names are
        # f"{event}_{field}"): reflected from the stat keys present.
        events = {}
        every = {**warm, **post}

        def ev_field(e):
            dt = (e["dtype"] if e["dtype"].kind == "f"
                  else np.dtype(np.int64))
            dims = ["unconstrained_parameter"] if e["shape"] else []
            return {"dtype": dt, "shape": e["shape"], "dims": dims}

        if "diverging" in every:
            ev = {"draw": {"dtype": np.dtype(np.int64), "shape": (),
                           "dims": []}}
            for key in self._DIV_EVENT_KEYS:
                if key in every:
                    ev[key] = ev_field(every[key])
            events["divergence"] = ev
        if "transformation_index" in every:
            ev = {"draw": {"dtype": np.dtype(np.int64), "shape": (),
                           "dims": []},
                  "transformation_update_id": {"dtype": np.dtype(np.int64),
                                               "shape": (), "dims": []}}
            for key in self._TRANSFORM_EVENT_KEYS:
                if key in every:
                    ev[key] = ev_field(every[key])
            events["transformation_update"] = ev
        out["events"] = events
        return out

    def checkpoint(self, path: str) -> None:
        """Save the full device state; a Sampler built with the same
        settings can ``restore`` and continue bit-identically."""
        from .checkpoint import save_state

        save_state(path, self.state, self._next_draw)

    def restore(self, path: str) -> None:
        from .checkpoint import load_state

        state, next_draw = load_state(path, self.state)
        self.state = jax.tree.map(lambda x: jnp.array(x, copy=True), state)
        self._next_draw = next_draw
        # Convergence bookkeeping restarts from the checkpoint: the buffer
        # holds draws past (or duplicating) the restored cursor, and a stale
        # `converged` would make run() return without sampling.
        self.converged = False
        self._post_buffer = []
        self._post_thin = 1
        self._post_seen = 0
        if self._auto_recover:
            self._take_snapshot()  # the pre-restore snapshot is stale

    def inspect(self):
        return self.trace.inspect()

    def flush(self) -> None:
        """Force buffered trace chunks to storage without consuming them
        (nuts-rs ``Sampler`` flush command, src/sampler.rs:1231-1244)."""
        flush = getattr(self.trace, "flush", None)
        if flush is not None:
            flush()


def schema(
    model: Model,
    settings=None,
    *,
    dtype=None,
    keep_stats=None,
    draw_dtype=None,
    stats_dtype=None,
    store_warmup: bool = True,
):
    """Settings-level trace-schema reflection — no ``Sampler``, no device.

    The reference reflects the full trace schema from ``Settings`` alone,
    before any sampler exists (src/sampler.rs:73-162 builds the storage
    hierarchy from ``Settings::Stats`` + the model's variable list), so
    storage can be created before a single device buffer is allocated.  This
    free function is the JAX analog: the chain state and every phase runner
    are traced abstractly with ``jax.eval_shape`` — pure host-side shape
    arithmetic — and the returned schema is identical to
    ``Sampler(model, settings, ...).schema()``.

    Returns ``{group: {name: {"dtype", "shape", "dims"}}}`` for the four
    draw groups plus ``"coords"`` and ``"events"`` — see
    :meth:`Sampler.schema`.
    """
    settings = settings or NutsSettings()
    s = Sampler(model, settings, dtype=dtype, keep_stats=keep_stats,
                draw_dtype=draw_dtype, stats_dtype=stats_dtype,
                store_warmup=store_warmup, _reflect_only=True)
    return s.schema()


def sample(
    model: Model,
    settings=None,
    *,
    seed: Optional[int] = None,
    storage: Optional[StorageConfig] = None,
    dtype=None,
    chunk_size: int = 128,
    init_positions=None,
    progress_callback=None,
    mesh=None,
    stop_when: Optional[ConvergenceStop] = None,
    fail_after: Optional[int] = 100,
    max_chains_per_launch: Optional[int] = None,
    keep_stats=None,
    draw_dtype=None,
    stats_dtype=None,
    store_warmup: bool = True,
) -> Trace:
    """Sample from ``model`` — the JAX analog of ``Sampler::new`` + ``wait``.

    Returns an in-memory :class:`Trace` unless a different storage backend is
    given.  ``stop_when`` enables convergence-based early stopping (see
    :class:`ConvergenceStop`); ``fail_after`` configures the
    unrecoverable-chain detector (see :class:`Sampler`, :class:`ChainFailedError`).
    """
    settings = settings or NutsSettings()
    if seed is not None:
        settings = dataclasses.replace(settings, seed=seed)
    sampler = Sampler(
        model, settings, storage=storage, dtype=dtype, chunk_size=chunk_size,
        init_positions=init_positions, progress_callback=progress_callback,
        mesh=mesh, stop_when=stop_when, fail_after=fail_after,
        max_chains_per_launch=max_chains_per_launch,
        keep_stats=keep_stats, draw_dtype=draw_dtype,
        stats_dtype=stats_dtype, store_warmup=store_warmup)
    return sampler.run()


def sample_sequentially(model, settings, start, draws, chain=0, seed=0,
                        chunk_size: int = 16):
    """Single-chain lazy iterator API (nuts-rs ``sample_sequentially``,
    src/sampler.rs:994-1005: each ``next()`` advances the chain).

    ``draws`` counts total ``draw()`` calls — the first ``num_tune`` of them
    are tuning draws, exactly like calling the reference's chain ``draws``
    times.  Yields ``(position, progress_dict)`` per draw, where the progress
    dict mirrors the reference's ``Progress`` fields (chain.rs:178-188).

    Sampling is lazy at ``chunk_size`` granularity: the next device chunk is
    launched only when the previous chunk's draws have been consumed
    (``chunk_size=1`` gives strict per-draw laziness; larger chunks amortize
    launch overhead).  The batched :func:`sample` is the fast path.
    """
    num_tune = min(getattr(settings, "num_tune", 0), draws)
    settings = dataclasses.replace(settings, num_chains=1, num_tune=num_tune,
                                   num_draws=draws - num_tune, seed=seed)
    sampler = Sampler(model, settings, chunk_size=max(1, min(chunk_size, draws)),
                      init_positions=np.asarray(start)[None, :])
    while not sampler.finished:
        lo, stats, tuning = sampler.run_next_chunk()
        k = len(tuning)
        for j in range(k):
            progress = {
                "draw": lo + j,
                "chain": chain,
                "diverging": bool(stats["diverging"][0, j]),
                "tuning": bool(tuning[j]),
                "step_size": float(stats["step_size"][0, j]),
                "num_steps": int(stats["n_steps"][0, j]),
            }
            yield np.asarray(stats["position"][0, j]), progress

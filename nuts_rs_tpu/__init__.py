"""nuts_rs_tpu — a batched NUTS/HMC inference engine in JAX.

A from-scratch JAX/XLA re-design with the capabilities of
pymc-devs/nuts-rs: NUTS with diagonal /
low-rank / normalizing-flow mass-matrix adaptation, MCLMC, dual-averaging and
Adam step-size adaptation, multi-chain sampling vmapped within a chip and
sharded over device meshes, and progressive ArviZ-compatible trace storage.
"""

from .adapt.schedule import AdaptScheduleOptions
from .adapt.step_size import (
    AdamOptions,
    DualAverageOptions,
    StepSizeMethod,
    StepSizeSettings,
)
from .dynamics.hamiltonian import KineticKind
from .kernels.nuts import NutsOptions
from .models.model import Model
from .adapt.flow import FlowAdaptSettings
from .adapt.low_rank import LowRankSettings
from .sampler import (
    ChainFailedError,
    ChainProgress,
    ConvergenceStop,
    DiagMclmcSettings,
    DiagNutsSettings,
    FlowMclmcSettings,
    FlowNutsSettings,
    LowRankMclmcSettings,
    LowRankNutsSettings,
    MclmcSettings,
    MclmcTrajectoryKind,
    NutsSettings,
    Sampler,
    sample,
    sample_sequentially,
    schema,
)
from .diagnostics import ess_bulk, ess_tail, split_rhat, summary
from .storage.arrow import ArrowConfig
from .storage.csv import CsvConfig
from .storage.memory import MemoryConfig, Trace
from .storage.zarr import ZarrConfig
from .parallel.mesh import make_mesh
from .kernels.nuts import DivergenceInfo

# Reference-name aliases — drop-in familiarity for nuts-rs users (each maps
# to the closest concept here; the aliased class IS the implementation, not
# a shim).  src/lib.rs:115-153 is the reference export list.
KineticEnergyKind = KineticKind            # sampler.rs KineticEnergyKind
StepSizeAdaptMethod = StepSizeMethod       # stepsize/ StepSizeAdaptMethod
FlowSettings = FlowAdaptSettings           # external_adapt_strategy.rs
# EuclideanAdaptOptions' schedule fields are AdaptScheduleOptions verbatim
# (adapt_strategy.rs:42-54); its nested step_size_settings /
# mass_matrix_options live as flat `step_size` / `store_mass_matrix` /
# `use_grad_based_estimate` fields on the Settings presets here.
EuclideanAdaptOptions = AdaptScheduleOptions
# The reference's HashMap and Ndarray backends are both "keep everything in
# host memory"; MemoryConfig is that backend here (dict-of-arrays trace).
HashMapConfig = MemoryConfig
NdarrayConfig = MemoryConfig

__version__ = "0.1.0"

__all__ = [
    "AdamOptions",
    "ArrowConfig",
    "CsvConfig",
    "ZarrConfig",
    "make_mesh",
    "AdaptScheduleOptions",
    "ChainFailedError",
    "ChainProgress",
    "DiagMclmcSettings",
    "DiagNutsSettings",
    "DualAverageOptions",
    "FlowAdaptSettings",
    "FlowMclmcSettings",
    "FlowNutsSettings",
    "KineticKind",
    "LowRankMclmcSettings",
    "LowRankNutsSettings",
    "LowRankSettings",
    "MclmcSettings",
    "MclmcTrajectoryKind",
    "MemoryConfig",
    "Model",
    "ConvergenceStop",
    "NutsOptions",
    "NutsSettings",
    "Sampler",
    "StepSizeMethod",
    "StepSizeSettings",
    "Trace",
    "ess_bulk",
    "ess_tail",
    "split_rhat",
    "summary",
    "sample",
    "sample_sequentially",
    "schema",
    # reference-name aliases (see the alias block above)
    "DivergenceInfo",
    "KineticEnergyKind",
    "StepSizeAdaptMethod",
    "FlowSettings",
    "EuclideanAdaptOptions",
    "HashMapConfig",
    "NdarrayConfig",
]

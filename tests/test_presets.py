"""Every settings preset is constructible and can draw.

Mirror of the reference's ``assert_settings_smoke`` suite
(nuts-rs ``src/sampler.rs:1621-1660``), which constructs each of the
six presets (Diag/LowRank/Flow x Nuts/Mclmc) and samples a small normal
target.  Flow presets use the cheap diagonal affine flow here to keep the CPU
refits fast; the coupling flow is exercised in test_flow.py.
"""

import numpy as np
import pytest

import nuts_rs_tpu as nt
from nuts_rs_tpu.flows.coupling import diag_affine_flow
from nuts_rs_tpu.models import gaussian

SMALL = dict(num_tune=60, num_draws=40, num_chains=2, seed=5)


def _check(trace, num_draws=40, num_chains=2, dim=4):
    pos = trace.posterior["position"]
    assert pos.shape == (num_chains, num_draws, dim)
    assert np.isfinite(pos).all()
    # the sampler moved
    assert pos[:, -1].std() > 0


@pytest.mark.parametrize("factory", [
    nt.DiagNutsSettings,
    nt.LowRankNutsSettings,
    nt.DiagMclmcSettings,
    nt.LowRankMclmcSettings,
])
def test_affine_presets_smoke(factory):
    model = gaussian.normal_logp(4, mu=1.0)
    settings = factory(**SMALL)
    _check(nt.sample(model, settings, chunk_size=50))


@pytest.mark.parametrize("factory", [nt.FlowNutsSettings, nt.FlowMclmcSettings])
def test_flow_presets_smoke(factory):
    model = gaussian.normal_logp(4, mu=1.0)
    settings = factory(flow_spec=diag_affine_flow(), **SMALL)
    # Reference flow presets default to 1500 tune / 1 chain / max_err 20
    # (src/sampler.rs:334,390-392); the smoke run overrides the sizes only.
    assert factory(flow_spec=diag_affine_flow()).num_tune == 1500
    assert factory(flow_spec=diag_affine_flow()).num_chains == 1
    assert factory(flow_spec=diag_affine_flow()).max_energy_error == 20.0
    _check(nt.sample(model, settings, chunk_size=50))


def test_flow_mclmc_defaults_constructible():
    # Regression: MclmcSettings(mass_matrix="flow") used to crash in
    # _schedule_for because MclmcSettings had no `flow` field.
    model = gaussian.normal_logp(3, mu=0.0)
    settings = nt.MclmcSettings(mass_matrix="flow", num_tune=30, num_draws=20,
                                num_chains=1, seed=2,
                                flow_spec=diag_affine_flow())
    trace = nt.sample(model, settings, chunk_size=25)
    assert trace.posterior["position"].shape == (1, 20, 3)


def test_low_rank_store_mass_matrix_events():
    # LowRankSettings.store_mass_matrix emits MatrixStats events
    # (low_rank.rs:195,210-222): eigenvalues + selected count per update.
    model = gaussian.correlated_normal_rank1(6, scale=1.5, eig=100.0)
    settings = nt.LowRankNutsSettings(
        num_tune=150, num_draws=50, num_chains=2, seed=9,
        low_rank=nt.LowRankSettings(store_mass_matrix=True))
    trace = nt.sample(model, settings, chunk_size=100)
    ev = trace.transformation_updates[0]
    assert "mass_matrix_eigvals" in ev
    assert "num_eigenvalues" in ev
    assert ev["mass_matrix_eigvals"].shape[1] == 6
    # at least one update found a non-trivial eigendirection
    assert max(e["num_eigenvalues"].max(initial=0)
               for e in trace.transformation_updates) >= 1


def test_reference_name_aliases():
    # Drop-in names from the reference's crate root (src/lib.rs:115-153):
    # each alias IS the implementing class, not a shim.
    import nuts_rs_tpu as nt

    assert nt.KineticEnergyKind is nt.KineticKind
    assert nt.StepSizeAdaptMethod is nt.StepSizeMethod
    assert nt.FlowSettings is nt.FlowAdaptSettings
    assert nt.EuclideanAdaptOptions is nt.AdaptScheduleOptions
    assert nt.HashMapConfig is nt.MemoryConfig
    assert nt.NdarrayConfig is nt.MemoryConfig
    assert nt.DivergenceInfo is not None
    # EuclideanAdaptOptions schedule fields match adapt_strategy.rs:42-54
    import dataclasses

    names = {f.name for f in dataclasses.fields(nt.EuclideanAdaptOptions)}
    for ref_field in ("early_window", "step_size_window",
                      "mass_matrix_switch_freq",
                      "early_mass_matrix_switch_freq",
                      "mass_matrix_update_freq",
                      "mass_matrix_window_growth"):
        assert ref_field in names, ref_field

"""store_warmup=False: warmup rows are not stored.

Reference: ``ZarrAsyncConfig::store_warmup`` (src/storage/zarr/
async_impl.rs:660-668 — "When false, only post-warmup samples are
stored").  Two independent knobs here:

* ``Sampler(store_warmup=False)`` / ``nt.sample(..., store_warmup=False)``
  — beyond the reference: for all-tuning chunks the draw/stat payload is dropped ON
  DEVICE (only the accounting planes cross the D2H link); mixed
  warmup/posterior chunks drop the tuning rows host-side.  Must not
  change the chain path (posterior bit-identical to a storing run).
* ``ZarrConfig(store_warmup=False)`` — storage-level, matching the
  reference API: no warmup groups are created on disk at all.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import nuts_rs_tpu as nt
from nuts_rs_tpu.models import gaussian


@pytest.fixture(scope="module")
def model():
    return gaussian.normal_logp(4, mu=1.5)


SETTINGS = dict(num_tune=120, num_draws=150, num_chains=4, seed=7)


def test_sampler_level_drops_warmup_and_keeps_posterior_bit_exact(model):
    s = nt.DiagNutsSettings(**SETTINGS)
    full = nt.sample(model, s, chunk_size=64)
    thin = nt.sample(model, s, chunk_size=64, store_warmup=False)
    # identical chain path: dropping transfer/storage must not change draws
    np.testing.assert_array_equal(np.asarray(full.posterior["position"]),
                                  np.asarray(thin.posterior["position"]))
    np.testing.assert_array_equal(np.asarray(full.sample_stats["diverging"]),
                                  np.asarray(thin.sample_stats["diverging"]))
    # warmup groups exist but hold zero draws
    for grp in (thin.warmup_posterior, thin.warmup_sample_stats):
        for name, arr in grp.items():
            assert arr.shape[1] == 0, (name, arr.shape)


def test_sampler_level_schema_reflects_no_warmup(model):
    s = nt.DiagNutsSettings(**SETTINGS)
    sch = nt.schema(model, s, store_warmup=False)
    assert sch["warmup_posterior"] == {}
    assert sch["warmup_sample_stats"] == {}
    assert "position" in sch["posterior"]
    sch_full = nt.schema(model, s)
    assert "position" in sch_full["warmup_posterior"]


def test_zarr_config_level_no_warmup_groups_on_disk(tmp_path, model):
    from nuts_rs_tpu.storage.zarr import ZarrConfig

    s = nt.DiagNutsSettings(**SETTINGS)
    path = str(tmp_path / "t.zarr")
    nt.sample(model, s, chunk_size=64,
              storage=ZarrConfig(path, chunk_draws=32, store_warmup=False))
    assert os.path.isdir(os.path.join(path, "posterior"))
    assert not os.path.exists(os.path.join(path, "warmup_posterior"))
    assert not os.path.exists(os.path.join(path, "warmup_sample_stats"))
    from nuts_rs_tpu.storage.zarr_format import read_array

    pos = read_array(os.path.join(path, "posterior", "position"))
    assert pos.shape == (4, 150, 4)


def test_sampler_level_with_zarr_storage(tmp_path, model):
    from nuts_rs_tpu.storage.zarr import ZarrConfig
    from nuts_rs_tpu.storage.zarr_format import read_array

    s = nt.DiagNutsSettings(**SETTINGS)
    path = str(tmp_path / "t.zarr")
    nt.sample(model, s, chunk_size=64, store_warmup=False,
              storage=ZarrConfig(path, chunk_draws=32))
    pos = read_array(os.path.join(path, "posterior", "position"))
    assert pos.shape == (4, 150, 4)
    # warmup arrays truncate to the zero rows actually written
    warm_pos = os.path.join(path, "warmup_posterior", "position")
    if os.path.exists(warm_pos):
        assert read_array(warm_pos).shape[1] == 0


def test_mixed_chunk_mclmc(model):
    # MCLMC FIXED-step phases split at the trajectory switch, not at
    # num_tune, so one chunk can straddle the warmup/posterior boundary;
    # the tuning rows must drop host-side without touching the posterior.
    s = nt.DiagMclmcSettings(num_tune=60, num_draws=90, num_chains=4, seed=3)
    full = nt.sample(model, s, chunk_size=150)
    thin = nt.sample(model, s, chunk_size=150, store_warmup=False)
    np.testing.assert_array_equal(np.asarray(full.posterior["position"]),
                                  np.asarray(thin.posterior["position"]))
    for name, arr in thin.warmup_posterior.items():
        assert arr.shape[1] == 0, (name, arr.shape)


def test_detector_still_fires_during_unstored_warmup():
    # The stuck-chain detector must keep working when warmup positions
    # never reach the host: the equality mask is computed on device.
    # Model finite ONLY at bit-exact zero (the init point) — every proposal
    # NaNs, diverges, and the chain can never move (test_failure.py's
    # nan-wall construction).
    def logp(q):
        base = -0.5 * jnp.sum(jnp.square(q))
        return jnp.where(jnp.any(q != 0.0), jnp.nan, base)

    model = nt.Model(logp_fn=logp, dim=3, name="nan_wall")
    s = nt.DiagNutsSettings(num_tune=80, num_draws=40, num_chains=2, seed=0)
    with pytest.raises(nt.ChainFailedError):
        nt.sample(model, s, chunk_size=32, store_warmup=False, fail_after=20,
                  init_positions=np.zeros((2, 3)))


def test_thin_knobs_compose(model):
    s = nt.DiagNutsSettings(**SETTINGS)
    tr = nt.sample(model, s, chunk_size=64, store_warmup=False,
                   keep_stats=(), draw_dtype=jnp.float16)
    pos = np.asarray(tr.posterior["position"])
    assert pos.dtype == np.float16
    assert abs(pos.astype(np.float64).mean() - 1.5) < 0.1

import os

# Tests run on a virtual 8-device CPU mesh with f64 enabled so they reproduce
# the reference's numerical behavior; GPU runs use f32 (chip_smoke.py).
# Tests that need the card are marked ``gpu`` and decide in the ``gpu_env``
# fixture (never at import or collection) whether to skip.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu"


# ---- fast/slow test tiers -------------------------------------------------
# The full suite costs tens of minutes on the virtual CPU mesh; the quick
# lane (`pytest -m "not slow"`) is the per-change check.
# Central list (measured >=10 s each) instead of scattered decorators so the
# tier assignment is auditable in one place.

import pytest  # noqa: E402

_SLOW_TESTS = {
    "test_posterior_kernels_agree_statistically",
    "test_mesh_fused_kernels_posterior",
    "test_mesh_pooled_flow_trains_one_shared_flow",
    "test_mesh_mclmc_posterior",
    "test_extra_doublings",
    "test_recovers_generating_parameters",
    "test_async_posterior_kernel",
    "test_dryrun_multichip",
    "test_dim_sharded_with_cross_chain_adaptation",
    "test_zarr_matches_memory",
    "test_dim_sharded_nuts_posterior",
    "test_coupling_flow_sampling_funnel",
    "test_flow_async_posterior_chunk_invariance",
    "test_radon_parameter_recovery",
    "test_zarr_roundtrip_with_time_coord",
    "test_dim_sharded_deterministic",
    "test_dim_sharded_mclmc_large_d",
    "test_checkpoint_resume",
    "test_cross_chain_pooled_low_rank",
    "test_low_rank_store_mass_matrix_events",
    "test_flow_mclmc_defaults_constructible",
    "test_low_rank_exact_gaussian_whitening",
    "test_expand_fn",
    "test_zarr_layout",
    "test_mesh_public_api",
    "test_smoke_reaches_mean_30",
    "test_mclmc_draws_normal",
    "test_mclmc_posterior_moments",
    "test_chains_differ",
    "test_diag_affine_flow_sampling",
    "test_mclmc_cross_chain_adaptation_on_mesh",
}


def pytest_collection_modifyitems(config, items):
    matched = set()
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW_TESTS:
            matched.add(base)
            item.add_marker(pytest.mark.slow)
    # Self-check the tier list on full collections: a renamed test must not
    # silently drop a multi-minute case into the quick lane.  (Partial
    # collections — pytest path/file or -k selections — see only a subset,
    # so only enforce when everything was collected.)
    full = (not getattr(config.option, "keyword", "")
            and not config.getoption("--ignore", None)
            and not config.getoption("--ignore-glob", None)
            and all(os.path.isdir(a.split("::")[0]) for a in config.args))
    if full:
        stale = _SLOW_TESTS - matched
        if stale:
            # Warn, don't assert: a collection/import error elsewhere also
            # leaves entries unmatched, and the real error must stay the
            # headline.  The warning keeps renames from silently demoting a
            # slow test into the quick lane.
            import warnings

            warnings.warn(
                f"_SLOW_TESTS entries match no collected test: "
                f"{sorted(stale)}; update tests/conftest.py after "
                "renaming/removing tests", UserWarning)


@pytest.fixture
def gpu_env():
    """Environment for a child process that runs on the card, or a skip
    when ``nvidia-smi`` finds none.  This process stays pinned to the CPU,
    so the child is the only one on the card."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs a GPU (on the card: python -m pytest -m gpu)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env

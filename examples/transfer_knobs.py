"""Transfer-reduction knobs for link-bound deployments.

The reference streams draws through in-process channels, so storage cost
is memcpy-cheap; on an accelerator the device→host link is a real budget
(at 1024 chains and small d the draws and stats outweigh the compute).
Four independent
knobs shrink the payload ON DEVICE — nothing unlisted is ever
transferred, let alone stored:

* ``keep_stats=(...)`` — drop unlisted stat arrays (the controller's
  accounting planes are always retained).
* ``draw_dtype=jnp.float16`` — down-cast position draws.
* ``stats_dtype=jnp.float16`` — down-cast float stat arrays.
* ``store_warmup=False`` — drop the warmup payload entirely (the
  reference's ``ZarrAsyncConfig::store_warmup``,
  src/storage/zarr/async_impl.rs:660-668, extended device-side: the
  stuck-chain detector keeps working through an on-device equality
  mask).  ``ZarrConfig(store_warmup=False)`` is the storage-level
  equivalent for any sampler configuration.

The chain path is unaffected: posterior draws are bit-identical to an
unthinned run (tests/test_store_warmup.py pins this).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import numpy as np
import jax.numpy as jnp

import nuts_rs_tpu as nt

from _model import make_model, make_settings


def main():
    model = make_model()
    settings = make_settings()

    trace = nt.sample(
        model, settings,
        keep_stats=("energy",),        # + the always-kept accounting planes
        draw_dtype=jnp.float16,
        stats_dtype=jnp.float16,
        store_warmup=False,
    )

    pos = trace.posterior["position"]
    print("posterior/position:", pos.shape, pos.dtype)
    print("posterior mean:", np.round(pos.astype(np.float32).mean(axis=(0, 1)), 3))
    print("stat arrays kept:", sorted(trace.sample_stats))
    print("warmup draws stored:", trace.warmup_posterior["position"].shape[1])


if __name__ == "__main__":
    main()

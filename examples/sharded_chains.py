"""Shard thousands of chains over a device mesh (beyond the reference).

The reference parallelizes with one OS thread per chain
(``src/sampler.rs:1286-1326``).  Here the chain axis is vmapped on each device and
sharded over a ``jax.sharding.Mesh`` axis with ``shard_map``; cross-chain
adaptation pools Welford statistics with ``psum`` — a capability a
single-process CPU sampler cannot express.

Run on CPU with a virtual 8-device mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_chains.py
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import numpy as np
import jax

import nuts_rs_tpu as nt
from nuts_rs_tpu.parallel.mesh import make_mesh

from _model import make_model, make_settings


def main():
    model = make_model()
    n_dev = len(jax.devices())
    settings = make_settings(num_chains=8 * n_dev,
                             cross_chain_adaptation=n_dev > 1)
    mesh = make_mesh()
    print(f"devices: {n_dev}, chains: {settings.num_chains}, mesh: {mesh}")

    trace = nt.sample(model, settings, mesh=mesh)

    pos = trace.posterior["position"]
    print("posterior/position:", pos.shape)
    print("posterior mean:", np.round(pos.mean(axis=(0, 1)), 3))


if __name__ == "__main__":
    main()

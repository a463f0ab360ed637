"""Shard the PARAMETER axis of a huge-d model over the mesh.

The reference's large-d axis is its SIMD kernels benched to d=4567
(``benches/sample.rs:126``) on one core.  Here the parameter dimension of
every state vector (positions, gradients, momenta, the NUTS checkpoint
stacks, the mass matrix) shards over a ``"dim"`` mesh axis; every
contraction inside the fused kernels — U-turn dots, kinetic energies,
logdet sums, the model's own log-density reduction — becomes a
device-local partial sum completed by one ``psum``
(``nuts_rs_tpu/parallel/axis.py``).  A 2-D ``(chains, dim)`` mesh composes
this with chain sharding and cross-chain adaptation.

The model's logp must be written against ``parallel.axis.dsum``/``dfinish``
(set ``Model.dim_shardable=True``) so each shard computes the global density
from its local parameter block.

Run on CPU with a virtual 8-device mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/dim_sharded.py
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import numpy as np
import jax

import nuts_rs_tpu as nt
from nuts_rs_tpu.models import gaussian
from nuts_rs_tpu.parallel.mesh import make_mesh_2d


def main():
    n_dev = len(jax.devices())
    n_chain_dev = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    n_dim_dev = n_dev // n_chain_dev

    d = 1024 * n_dim_dev
    model = gaussian.normal_logp(d, mu=1.0)   # written against dsum
    mesh = make_mesh_2d(n_chain_dev, n_dim_dev)
    settings = nt.DiagNutsSettings(
        num_tune=200, num_draws=300, num_chains=2 * n_chain_dev, seed=0,
        cross_chain_adaptation=n_chain_dev > 1)
    print(f"mesh: {n_chain_dev} chain-devices x {n_dim_dev} dim-devices, "
          f"d={d}, chains={settings.num_chains}")

    trace = nt.sample(model, settings, mesh=mesh, chunk_size=250)

    pos = trace.posterior["position"]
    print("posterior/position:", pos.shape)
    print("posterior mean (want 1.0):", round(float(pos.mean()), 4))
    print("posterior std  (want 1.0):", round(float(pos.std()), 4))


if __name__ == "__main__":
    main()

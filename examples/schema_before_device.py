"""Create trace storage from Settings alone — before any device exists.

The reference reflects the full trace schema from ``Settings``
(src/sampler.rs:73-162) so storage can be laid out before sampling starts.
``nuts_rs_tpu.schema(model, settings)`` is the JAX analog: the chain
state and every phase runner are traced abstractly with ``jax.eval_shape``
— pure host-side shape arithmetic, ZERO device allocation (tested with a
``jax.live_arrays()`` diff) — and the result matches
``Sampler(...).schema()`` exactly.

Use cases: pre-provisioning Zarr hierarchies on shared storage from a
scheduler node with no accelerator, schema-validating a pipeline in CI,
or sizing storage before committing device time.
"""

import json

import numpy as np

import nuts_rs_tpu as nt
from nuts_rs_tpu.models import gaussian


def main():
    model = gaussian.normal_logp(50, mu=0.0)
    settings = nt.DiagNutsSettings(num_tune=500, num_draws=1000,
                                   num_chains=512, seed=0,
                                   store_divergences=True)

    # No Sampler, no device buffers: pure reflection.
    sch = nt.schema(model, settings, draw_dtype=np.float16)

    for group in ("posterior", "sample_stats"):
        print(f"[{group}]")
        for name, e in sch[group].items():
            dims = " x ".join(["chain", "draw"] + list(e["dims"]))
            print(f"  {name:24s} {str(e['dtype']):10s} ({dims})")
    print("[events]", list(sch["events"]))

    # Estimated posterior-group bytes per draw across all chains — sizing
    # storage before any device work.
    per_draw = sum(np.dtype(e["dtype"]).itemsize * int(np.prod(e["shape"]))
                   for e in sch["posterior"].values()) * settings.num_chains
    total = per_draw * settings.num_draws
    print(f"posterior payload: {per_draw/1e6:.2f} MB/draw, "
          f"{total/1e9:.2f} GB total")

    # The same schema drives upfront Zarr array creation
    # (ZarrConfig(...).new_trace declares every array at init; see
    # examples/zarr_trace.py), optionally with the Blosc-style byte
    # shuffle: ZarrConfig(path, shuffle=True).
    print(json.dumps({"groups": {g: len(sch[g]) for g in
                                 ("posterior", "sample_stats",
                                  "warmup_posterior",
                                  "warmup_sample_stats")}}))


if __name__ == "__main__":
    main()

"""Sample into the in-memory trace (dense arrays per variable).

Mirror of nuts-rs ``examples/hashmap_storage.rs`` and
``ndarray_storage.rs`` combined: the default backend collects every variable
into numpy arrays shaped ``[chain, draw, ...]`` in ArviZ-style groups
(``posterior``, ``sample_stats``, ``warmup_*``).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import numpy as np

import nuts_rs_tpu as nt

from _model import make_model, make_settings, print_progress


def main():
    model = make_model()
    settings = make_settings()

    trace = nt.sample(model, settings, progress_callback=print_progress)

    pos = trace.posterior["position"]
    print("posterior/position:", pos.shape, pos.dtype)
    print("posterior mean:", np.round(pos.mean(axis=(0, 1)), 3))
    print("sample_stats keys:", sorted(trace.sample_stats)[:8], "...")
    print("warmup draws:", trace.warmup_posterior["position"].shape[1])
    print("divergence rate:", float(trace.sample_stats["diverging"].mean()))
    assert pos.shape == (settings.num_chains, settings.num_draws, model.dim)


if __name__ == "__main__":
    main()

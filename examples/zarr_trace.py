"""Sample into an ArviZ-compatible Zarr store and read it back.

Mirror of nuts-rs ``examples/zarr_trace.rs``: MV-normal model,
parallel sampler, synchronous Zarr backend, then a readback of the
``posterior`` and ``sample_stats`` groups plus the settings attrs.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import os
import tempfile

import numpy as np

import nuts_rs_tpu as nt
from nuts_rs_tpu.storage.zarr_format import read_array, read_attrs

from _model import make_model, make_settings, print_progress


def main():
    model = make_model()
    settings = make_settings()
    path = os.path.join(tempfile.mkdtemp(), "trace.zarr")

    # For file-backed storage, ``sample`` returns the finalized store path;
    # the data lives in the ArviZ hierarchy posterior/, sample_stats/, warmup_*.
    out = nt.sample(
        model, settings,
        storage=nt.ZarrConfig(path=path, async_writes=False),
        progress_callback=print_progress)
    assert out == path
    pos = read_array(os.path.join(path, "posterior", "position"))
    depth = read_array(os.path.join(path, "sample_stats", "depth"))
    attrs = read_attrs(path)   # root group attrs

    print("store:", path)
    print("posterior/position shape:", pos.shape)       # [chain, draw, dim]
    print("sample_stats/depth mean:", float(depth.mean()))
    print("settings in attrs:", sorted(attrs)[:5], "...")
    assert pos.shape == (settings.num_chains, settings.num_draws, model.dim)
    assert np.isfinite(pos).all()
    print("readback OK")


if __name__ == "__main__":
    main()

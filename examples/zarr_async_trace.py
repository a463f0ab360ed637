"""Sample into Zarr through the native C++ async writer.

Mirror of nuts-rs ``examples/zarr_async_trace.rs``: same layout as
the sync backend, but chunk compression + file I/O run on a native worker
pool with bounded-queue backpressure (``native/trace_writer.cpp``; the
reference uses a tokio ``JoinSet`` with ``max_queued_writes``,
``src/storage/zarr/async_impl.rs:365-400``).  Falls back to the sync path
automatically when the shared library cannot be built.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import os
import tempfile

import nuts_rs_tpu as nt
from nuts_rs_tpu.storage.zarr_format import read_array

from _model import make_model, make_settings, print_progress


def main():
    model = make_model()
    settings = make_settings()
    path = os.path.join(tempfile.mkdtemp(), "trace.zarr")

    nt.sample(
        model, settings,
        storage=nt.ZarrConfig(path=path, async_writes=True,
                              max_queued_writes=64, writer_threads=2),
        progress_callback=print_progress)

    pos = read_array(os.path.join(path, "posterior", "position"))
    print("store:", path)
    print("posterior/position shape:", pos.shape)
    assert pos.shape == (settings.num_chains, settings.num_draws, model.dim)
    print("async-written store reads back fine")


if __name__ == "__main__":
    main()

"""Native (C++) runtime components, loaded via ctypes.

The compute path is JAX/XLA; the host-side I/O runtime around it is
native C++ (mirroring the reference, whose entire runtime is Rust):
``trace_writer.cpp`` implements the async chunk writer with a bounded queue
and worker threads (nuts-rs ``src/storage/zarr/async_impl.rs`` analog).

The shared library is built on demand with g++ and cached next to the source;
when no compiler is available everything falls back to synchronous Python
writes.
"""

from .writer import AsyncTraceWriter, native_available, native_zstd_available

__all__ = ["AsyncTraceWriter", "native_available", "native_zstd_available"]

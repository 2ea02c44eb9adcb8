"""Process-parallel host entropy stage for serving decode.

The host half of the device decode (codestream parse + native rANS
token decode, ``api/decoder._device_decode_inputs``) is ~60% small Python
steps between GIL-released C calls. Under a thread pool that Python
fraction serializes: a few threads reach well under their count in
speed-up (the GIL is the ceiling, not the cores). The
reference fans the identical work over C++ threads with no such limit
(``lib/threads/thread_parallel_runner_internal.h``); the equivalent
CPython design is a pool of *processes*, each decoding whole streams
on its own interpreter and returning the compact device-staging
arrays (FrameRecon pytrees, ~0.3 MB/frame) by pickle — the parent
pays one memcpy-class deserialize per stream, not the decode.

Workers are pinned to ``JAX_PLATFORMS=cpu`` before anything imports
jax so they never open the accelerator (one process per card: a second
JAX process would reserve device memory the parent needs), and the
pool persists across calls (spawn + imports cost seconds; a serving
process pays them once).
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor

_pool: ProcessPoolExecutor | None = None
_pool_size = 0


def _worker_init() -> None:
    # The parent owns the accelerator; workers only ever run host-side
    # numpy/C, and must not open the card. The env var covers a fresh
    # interpreter; the config update covers one that imported jax early.
    os.environ["JAX_PLATFORMS"] = "cpu"
    import sys
    if "jax" in sys.modules:
        import jax
        jax.config.update("jax_platforms", "cpu")


def _decode_inputs_task(data: bytes):
    from libjxl_tpu.api.decoder import _device_decode_inputs
    from libjxl_tpu.core.fields import FormatError
    try:
        return _device_decode_inputs(data)
    except FormatError:
        return None


def default_workers() -> int:
    # Workers do all the heavy lifting; the parent only deserializes
    # and stages to the device, so use every core.
    return max(1, os.cpu_count() or 1)


def get_pool(workers: int | None = None) -> ProcessPoolExecutor:
    """Persistent spawn-context pool of exactly ``workers`` processes
    (created on first use, re-created when the size changes)."""
    global _pool, _pool_size
    n = workers or default_workers()
    if _pool is not None and _pool_size == n:
        return _pool
    if _pool is not None:
        _pool.shutdown(wait=False, cancel_futures=True)
    import multiprocessing as mp

    from libjxl_tpu.utils import native
    # build the native library once here, before any worker imports it
    native.get_lib()

    # spawn, not fork: the parent may hold a live XLA runtime whose
    # locks/threads do not survive fork.
    _pool = ProcessPoolExecutor(n, mp_context=mp.get_context("spawn"),
                                initializer=_worker_init)
    _pool_size = n
    return _pool


def _warm_task(_):
    import libjxl_tpu.api.decoder  # noqa: F401  (pays the import cost)
    from libjxl_tpu.utils import native
    native.available()             # builds/loads the native library
    return os.getpid()


def warm(workers: int | None = None) -> None:
    """Spin the workers up and pay their import cost now."""
    pool = get_pool(workers)
    n = _pool_size
    list(pool.map(_warm_task, range(n), chunksize=1))


def map_decode_inputs(streams, workers: int | None = None) -> list:
    """``_device_decode_inputs`` over a batch on the process pool.

    Returns one entry per stream (None where the stream needs the
    general path). Raises whatever the pool raises — callers fall back
    to the thread pool (decode_many does)."""
    pool = get_pool(workers)
    # chunk to amortize per-task IPC once every worker has >=2 chunks
    # (one chunk per worker would lose load balance)
    cs = max(1, min(4, len(streams) // (2 * _pool_size)))
    return list(pool.map(_decode_inputs_task, streams, chunksize=cs))


def shutdown() -> None:
    global _pool, _pool_size
    if _pool is not None:
        _pool.shutdown(wait=False, cancel_futures=True)
        _pool = None
        _pool_size = 0

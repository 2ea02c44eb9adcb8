"""libjxl_tpu: a JPEG XL codec whose pixel-parallel stages run as JAX/XLA
device programs (GPU), with the sequential entropy work on the host.

Enables the persistent XLA compilation cache by default: the codec's
device programs (lossless group pipeline, VarDCT loop, filters) take
tens of seconds to compile but are stable across processes, and every
CLI/bench/test invocation is a fresh process. JAX_COMPILATION_CACHE_DIR
wins when set (an empty string opts out); otherwise the cache is the
fixed <checkout>/.jax_cache, so its keys stay stable between runs.
"""

import os as _os

_cache = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                       _os.pardir, ".jax_cache")
_os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                       _os.path.abspath(_cache))
_os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")
_os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

try:  # late import: honor the env vars even if jax is already loaded
    import sys as _sys
    if "jax" in _sys.modules:
        import jax as _jax
        if _os.environ["JAX_COMPILATION_CACHE_DIR"]:
            _jax.config.update(
                "jax_compilation_cache_dir",
                _os.environ["JAX_COMPILATION_CACHE_DIR"])
            _jax.config.update(
                "jax_persistent_cache_min_compile_time_secs", 2.0)
except Exception:  # pragma: no cover - cache is best-effort
    pass

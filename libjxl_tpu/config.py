"""Global runtime configuration for libjxl_tpu.

Mirrors the reference's layered flag system (enc_params.h /
JxlDecoder setters) for knobs that cut across the whole pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RuntimeConfig:
    # Run decode-side restoration filters (gaborish/EPF) and the batched
    # reconstruction of decode_many as XLA programs instead of host
    # numpy. Pays a per-shape compile on first use; wins on repeated
    # shapes. None = auto (see device_filters_enabled).
    device_filters: bool | None = None
    # Shard the group axis of device encode passes over all visible
    # devices (jax.sharding mesh; groups are THE parallel axis of JPEG
    # XL, SURVEY.md 2.2). Histograms become cross-shard reductions; the
    # emitted bitstream is identical to the single-device one.
    shard_encode: bool = False
    # e5+/e7 device path: run the variable-block forward transforms +
    # quantization as one fused program (models/vardct_transform)
    # instead of fetching the XYB plane and transforming on host
    device_transform: bool = True
    # Shard the decode-side restoration filters over all visible devices
    # (row bands + ppermute halo exchange, parallel/shard_filters.py);
    # output is bit-identical to the single-device filters.
    shard_decode: bool = False
    # decode() switches to the banded low-memory decoder above this
    # many pixels (low_memory_render_pipeline.cc spirit): pixel
    # intermediates stay bounded by ~3 group rows. 64 MP default.
    auto_band_pixels: int = 64 << 20
    # decode_many host entropy stage: number of worker PROCESSES
    # (parallel/host_pool.py). 0 = thread pool (default: threads cost
    # nothing to start, right for one-shot decodes); serving loops
    # should set the core count — the thread pool's throughput is
    # capped by the GIL-held Python between native calls; processes
    # restore linear scaling.
    decode_host_processes: int = 0


config = RuntimeConfig()


def device_filters_enabled(num_pixels: int | None = None) -> bool:
    """Resolve the device_filters auto default (see RuntimeConfig).

    In auto mode the XLA path is always on for a GPU backend. On the CPU
    backend it engages for frames >= 4 MP: below that a cold process
    spends more on the one-time stencil compiles than the numpy filters
    cost outright, and the decision must be a pure function of the frame
    (not of what is already compiled) so whole-frame and banded decode
    of the same stream always take the same path. CPU serving loops that
    decode repeatedly should set config.device_filters = True."""
    v = config.device_filters
    if v is not None:
        return v
    import jax
    if jax.default_backend() == "gpu":
        return True
    return num_pixels is None or num_pixels >= (4 << 20)

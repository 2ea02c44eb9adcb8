"""Decode throughput axes on one GPU: a 1024x768 VarDCT d1.0 stream
(BASELINE config 2) in serving mode — a batch of streams through
``decode_many`` (host entropy decode, one batched device reconstruction
program per chunk) — plus the device and host stages alone.

Usage: python bench_decode.py   (prints one JSON line; needs a GPU)
"""

import os

import numpy as np

from bench import median_seconds, require_gpu

E7_STREAM_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "profiling",
    "bench_e7_stream.jxl")


def _make_stream():
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:768, 0:1024]
    img = np.stack([
        (xx * 255 // 1024 + rng.integers(0, 8, (768, 1024))),
        (yy * 255 // 768 + rng.integers(0, 8, (768, 1024))),
        ((xx + yy) * 255 // 1792 + rng.integers(0, 8, (768, 1024))),
    ], -1).clip(0, 255).astype(np.uint8)
    return encode_lossy(img, LossyOptions(distance=1.0, effort=3))


def _serving_mpps(data: bytes, n: int) -> float:
    """decode_many over n copies of one stream, host stage on the
    process pool (one worker per core)."""
    from libjxl_tpu.api.decoder import decode_many
    from libjxl_tpu.config import config

    config.decode_host_processes = os.cpu_count() or 1
    # decode_many returns host arrays: the window ends with the copy
    dt = median_seconds(lambda: decode_many([data] * n), reps=2)
    return round(n * 0.786432 / dt, 2)


def bench_decode_mpps() -> float:
    """End-to-end serving throughput of e3 streams."""
    return _serving_mpps(_make_stream(), 24)


def bench_decode_device_mpps() -> float:
    """Device-resident decode rate: the coefficient blob already in
    device memory, dequant + IDCT + EPF + colour output per call."""
    import jax
    import jax.numpy as jnp

    from libjxl_tpu.api.decoder import _device_decode_inputs
    from libjxl_tpu.models.vardct_decode import (
        decode_frames_device_blob, pack_frames_blob,
    )

    fr, key, lf = _device_decode_inputs(_make_stream())
    h, w, yb, xb, gab, epf_iters, bits = key
    K = 16
    blob_np, meta = pack_frames_blob([fr] * K)
    blob = jax.device_put(jnp.asarray(blob_np))
    dt = median_seconds(lambda: jax.block_until_ready(
        decode_frames_device_blob(blob, meta, lf, gab, epf_iters, h, w)),
        reps=6)
    return round(K * 0.786432 / dt, 1)


def bench_decode_host_entropy_mpps() -> float:
    """Host entropy stage alone on the process pool: codestream parse +
    native rANS token decode + coefficient staging, no device work."""
    from libjxl_tpu.parallel.host_pool import map_decode_inputs, warm

    data = _make_stream()
    n = 48
    warm()
    dt = median_seconds(lambda: map_decode_inputs([data] * n), reps=5)
    return round(n * 0.786432 / dt, 2)


def bench_decode_e7_mpps() -> float:
    """Serving decode of e7 (variable-block) streams: host entropy
    decode + per-strategy-class batched device reconstruction.

    The input stream is pinned (profiling/bench_e7_stream.jxl), so the
    axis measures decode, not whichever streams the encoder emits."""
    with open(E7_STREAM_PATH, "rb") as f:
        data = f.read()
    return _serving_mpps(data, 16)


if __name__ == "__main__":
    import json
    device = require_gpu()
    print(json.dumps({"decode_mpps": bench_decode_mpps(),
                      "decode_device_mpps": bench_decode_device_mpps(),
                      "decode_host_entropy_mpps":
                          bench_decode_host_entropy_mpps(),
                      "decode_e7_mpps": bench_decode_e7_mpps(),
                      "device": device}))

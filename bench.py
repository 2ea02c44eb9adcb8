"""Benchmark: codec throughput on one GPU.

Prints the card's name and power limit (``nvidia-smi``), then ONE JSON
line: the headline axis (lossless batch encode, MP/s, end to end through
``encode_lossless_many``) plus an "extra" dict with the other axes and
the device the numbers were taken on. Every timed window ends with
``block_until_ready`` or a host copy of the result; each axis is the
median of its repeats after a warm-up call, so compilation stays out of
the window. Exits non-zero when JAX finds no GPU: there is no fallback.

Inputs are gradients with 3-bit noise (``make_image``); content decides
token counts and therefore host entropy time, so these axes are not
comparable with corpus-content numbers.

Usage: python bench.py
"""

import json
import subprocess
import sys
import time

import numpy as np


def make_image(seed: int, h: int = 1024, w: int = 1024) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([
        (xx * 255 // w + rng.integers(0, 8, (h, w))),
        (yy * 255 // h + rng.integers(0, 8, (h, w))),
        ((xx + yy) * 255 // (h + w) + rng.integers(0, 8, (h, w))),
    ], axis=-1).clip(0, 255).astype(np.uint8)


def median_seconds(fn, reps: int = 3) -> float:
    """Median wall time of ``fn`` after one warm-up call; ``fn`` must end
    its own window (block_until_ready or a host copy)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def require_gpu() -> dict:
    """The device the numbers are taken on; exits without a GPU."""
    import jax
    devices = jax.devices()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {devices}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices),
            "card": card}


def bench_lossless_encode() -> dict:
    from libjxl_tpu.api.encoder import EncodeOptions, encode_lossless_many

    imgs = [make_image(s) for s in range(16)]
    opts = EncodeOptions(use_device=True, entropy="prefix-device")
    outs = encode_lossless_many(imgs, opts)
    assert all(len(o) > 0 for o in outs)
    dt = median_seconds(lambda: encode_lossless_many(imgs, opts))
    mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
    bpp = sum(len(o) for o in outs) * 8 / (mp * 1e6)
    return {"mpps": round(mp / dt, 3), "bpp": round(bpp, 3)}


def bench_device_encode() -> float:
    """Device-resident lossless encode rate: pixels already in device
    memory, one ``lossless_pack_fused`` program (RCT + residuals + tokens
    + prefix pack) per call, with a fixed random prefix code."""
    import jax
    import jax.numpy as jnp

    from libjxl_tpu.models.lossless import (
        frame_groups_host, lossless_pack_fused,
    )

    n_img = 16
    imgs = [make_image(100 + s) for s in range(n_img)]
    groups = np.concatenate([frame_groups_host(im, 256)[0] for im in imgs])
    g = jax.device_put(groups)
    rng = np.random.default_rng(0)
    lut_b = jnp.asarray(rng.integers(0, 1 << 14, 256).astype(np.uint32))
    lut_l = jnp.asarray(rng.integers(4, 15, 256).astype(np.int32))

    def step():
        jax.block_until_ready(lossless_pack_fused(
            g, 1024, 1024, lut_b, lut_l, gx=4, per_image=16,
            cap_words=1 << 23))

    return round(n_img * 1.048576 / median_seconds(step, reps=6), 1)


def bench_encode_host_splice() -> float:
    """Lossless encode host stage alone: header emit + native per-group
    stream splice on pack words already copied to the host."""
    from libjxl_tpu.api.encoder import (
        EncodeOptions, _prefix_assemble, _prefix_pass1, _prefix_pass2,
    )

    imgs = [make_image(200 + s) for s in range(8)]
    opts = EncodeOptions(use_device=True, entropy="prefix-device")
    st = _prefix_pass2(_prefix_pass1(None, opts, batch=imgs))
    st["words_slices"] = [np.asarray(s) for s in st["words_slices"]]
    if st.get("chunk_bits_dev") is not None:
        st["chunk_bits_dev"] = np.asarray(st["chunk_bits_dev"])
    assert all(len(o) > 0 for o in _prefix_assemble(st))
    return round(8 * 1.048576 / median_seconds(
        lambda: _prefix_assemble(st)), 1)


def measure() -> dict:
    device = require_gpu()
    enc = bench_lossless_encode()
    extra = {"lossless_encode_bpp": enc["bpp"],
             "device_encode_mpps": bench_device_encode(),
             "encode_host_splice_mpps": bench_encode_host_splice()}
    from bench_decode import (
        bench_decode_device_mpps, bench_decode_e7_mpps,
        bench_decode_host_entropy_mpps, bench_decode_mpps,
    )
    extra["decode_mpps"] = bench_decode_mpps()
    extra["decode_device_mpps"] = bench_decode_device_mpps()
    extra["decode_host_entropy_mpps"] = bench_decode_host_entropy_mpps()
    extra["decode_e7_mpps"] = bench_decode_e7_mpps()
    from bench_vardct import bench_vardct_e7_mpps, bench_vardct_encode_mpps
    extra["vardct_encode_mpps"] = bench_vardct_encode_mpps()
    extra["vardct_e7_mpps"] = bench_vardct_e7_mpps()
    extra["device"] = device
    return {"metric": "lossless_encode_throughput", "value": enc["mpps"],
            "unit": "MP/s", "extra": extra}


if __name__ == "__main__":
    print(json.dumps(measure()))

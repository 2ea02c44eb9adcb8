"""VarDCT (lossy) encode throughput axes on one GPU: 1024x768 d1.0
(BASELINE config 2) through the device encode pipeline (XYB + batched
DCT + quantize on the device, host entropy coding), at e3 (batch) and
e7 (single image, butteraugli loop on the device).

Usage: python bench_vardct.py   (prints one JSON line; needs a GPU)
"""

import numpy as np

from bench import median_seconds, require_gpu


def _make_images(n: int):
    out = []
    for s in range(n):
        rng = np.random.default_rng(s)
        yy, xx = np.mgrid[0:768, 0:1024]
        out.append(np.stack([
            (xx * 255 // 1024 + rng.integers(0, 8, (768, 1024))),
            (yy * 255 // 768 + rng.integers(0, 8, (768, 1024))),
            ((xx + yy) * 255 // 1792 + rng.integers(0, 8, (768, 1024))),
        ], -1).clip(0, 255).astype(np.uint8))
    return out


def bench_vardct_encode_mpps() -> float:
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy_many

    imgs = _make_images(8)
    opts = LossyOptions(distance=1.0, effort=3, use_device=True)
    assert all(len(o) > 0 for o in encode_lossy_many(imgs, opts))
    dt = median_seconds(lambda: encode_lossy_many(imgs, opts), reps=4)
    return round(len(imgs) * 0.786432 / dt, 2)


def bench_vardct_e7_mpps() -> float:
    """Full-heuristics e7 encode via the device-resident butteraugli
    loop (models/vardct_loop: requantize + recon + filters + diffmap as
    one program per iteration) + device EPF sharpness search."""
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    img = _make_images(1)[0]
    opts = LossyOptions(distance=1.0, effort=7, use_device=True)
    assert len(encode_lossy(img, opts)) > 0
    dt = median_seconds(lambda: encode_lossy(img, opts), reps=4)
    return round(0.786432 / dt, 3)


if __name__ == "__main__":
    import json

    device = require_gpu()
    print(json.dumps({"vardct_encode_mpps": bench_vardct_encode_mpps(),
                      "vardct_e7_mpps": bench_vardct_e7_mpps(),
                      "device": device}))

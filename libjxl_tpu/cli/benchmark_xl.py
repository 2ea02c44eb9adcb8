"""benchmark_xl-class harness (reference ``tools/benchmark/
benchmark_xl.cc``, table semantics per ``doc/benchmarking.md:56-77``).

Runs a set of codec configs over a set of images and prints one row per
config with the reference's columns: kPixels, Bytes, BPP, E MP/s,
D MP/s, Max norm, SSIMULACRA2, PSNR, pnorm, BPP*pnorm, QABPP.

Codec specs use the reference's syntax::

    jxl:d1.0:e5     VarDCT at butteraugli distance 1.0, effort 5
    jxl:d0:e3       lossless modular, effort 3
    jxl:d0:e3:device   device (GPU) encode path

Usage: python -m libjxl_tpu.cli.benchmark_xl --codec jxl:d0:e2,jxl:d1:e3
           img1.png img2.png [--decode_reps N] [--encode_reps N]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _load(path: str) -> np.ndarray:
    from libjxl_tpu.extras.io import load_image
    img = load_image(path)
    if img.ndim == 2:
        img = img[:, :, None]
    return img[:, :, :3] if img.shape[2] >= 3 else img


def _parse_codec(spec: str):
    parts = spec.split(":")
    if parts[0] != "jxl":
        raise SystemExit(f"unknown codec {parts[0]!r} (only jxl)")
    distance, effort, device = 1.0, 3, False
    for p in parts[1:]:
        if p.startswith("d"):
            distance = float(p[1:])
        elif p.startswith("e"):
            effort = int(p[1:])
        elif p == "device":
            device = True
        else:
            raise SystemExit(f"bad codec param {p!r}")
    return dict(distance=distance, effort=effort, device=device)


def _encode(img, cfg) -> bytes:
    if cfg["distance"] == 0:
        from libjxl_tpu.api.encoder import EncodeOptions, encode_lossless
        return encode_lossless(img, EncodeOptions(
            effort=cfg["effort"], use_device=cfg["device"],
            entropy="prefix-device" if cfg["device"] else "ans"))
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
    return encode_lossy(img, LossyOptions(
        distance=cfg["distance"], effort=cfg["effort"],
        use_device=cfg["device"]))


def run_benchmark(images, codec_specs, encode_reps=1, decode_reps=1,
                  out=sys.stdout):
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.metrics.butteraugli import (
        butteraugli_diffmap, compute_distance_p,
    )
    from libjxl_tpu.metrics.ssimulacra2 import ssimulacra2

    header = (f"{'Codec':<18}{'kPixels':>9}{'Bytes':>10}{'BPP':>8}"
              f"{'E MP/s':>8}{'D MP/s':>8}{'Max norm':>10}"
              f"{'SSIMULACRA2':>12}{'PSNR':>7}{'pnorm':>8}"
              f"{'BPP*pnorm':>11}{'QABPP':>8}")
    print(header, file=out)
    print("-" * len(header), file=out)
    rows = []
    for spec in codec_specs:
        cfg = _parse_codec(spec)
        kpx = tot_bytes = enc_t = dec_t = 0.0
        max_norm = pnorm = psnr_mse = s2 = 0.0
        for img in images:
            px = img.shape[0] * img.shape[1]
            kpx += px / 1e3
            t0 = time.perf_counter()
            for _ in range(encode_reps):
                data = _encode(img, cfg)
            enc_t += (time.perf_counter() - t0) / encode_reps
            tot_bytes += len(data)
            t0 = time.perf_counter()
            for _ in range(decode_reps):
                dec = decode(data)
            dec_t += (time.perf_counter() - t0) / decode_reps
            dec3 = dec[:, :, :3] if dec.ndim == 3 else dec[:, :, None]
            a = img.astype(np.float64)
            b = dec3.astype(np.float64)
            mse = ((a - b) ** 2).mean()
            psnr_mse += mse
            dm = np.asarray(butteraugli_diffmap(
                _to_linear(img), _to_linear(dec3)))
            max_norm = max(max_norm, float(dm.max()))
            pnorm += compute_distance_p(dm, 3.0)
            s2 += ssimulacra2(img, dec3)
        n = len(images)
        mp = kpx / 1e3
        bpp = tot_bytes * 8 / (kpx * 1e3)
        maxval = 255.0
        psnr = (10 * np.log10(maxval ** 2 / (psnr_mse / n))
                if psnr_mse > 0 else 99.99)
        pn = pnorm / n
        qabpp = bpp * max(1.0, pn)
        row = (f"{spec:<18}{kpx:>9.1f}{int(tot_bytes):>10}{bpp:>8.4f}"
               f"{mp / max(enc_t, 1e-9):>8.2f}"
               f"{mp / max(dec_t, 1e-9):>8.2f}{max_norm:>10.4f}"
               f"{s2 / n:>12.2f}{psnr:>7.2f}{pn:>8.4f}"
               f"{bpp * pn:>11.4f}{qabpp:>8.4f}")
        print(row, file=out)
        rows.append(dict(codec=spec, kpixels=kpx, bytes=int(tot_bytes),
                         bpp=bpp, enc_mpps=mp / max(enc_t, 1e-9),
                         dec_mpps=mp / max(dec_t, 1e-9),
                         max_norm=max_norm, ssimulacra2=s2 / n,
                         psnr=psnr, pnorm=pn, qabpp=qabpp))
    return rows


def _to_linear(img_u8: np.ndarray) -> np.ndarray:
    from libjxl_tpu.color.xyb import srgb_to_linear
    return np.asarray(np.moveaxis(
        srgb_to_linear(img_u8.astype(np.float64) / 255.0), -1, 0),
        np.float32)


def main(argv=None) -> int:
    from libjxl_tpu.cli import apply_platform_env
    apply_platform_env()
    ap = argparse.ArgumentParser(
        prog="benchmark_xl",
        description="Multi-config codec benchmark (benchmark_xl model)")
    ap.add_argument("images", nargs="+")
    ap.add_argument("--codec", default="jxl:d1.0:e3",
                    help="comma-separated codec specs (jxl:dD:eE[:device])")
    ap.add_argument("--encode_reps", type=int, default=1)
    ap.add_argument("--decode_reps", type=int, default=1)
    args = ap.parse_args(argv)
    images = [_load(p) for p in args.images]
    run_benchmark(images, args.codec.split(","),
                  args.encode_reps, args.decode_reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""cjxl_tpu — JPEG XL encoder CLI (reference ``tools/cjxl_main.cc``).

Usage: python -m libjxl_tpu.cli.cjxl in.png out.jxl [-d DIST] [-e EFFORT]
       [--lossless] [--device]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    from libjxl_tpu.cli import apply_platform_env
    apply_platform_env()
    p = argparse.ArgumentParser(prog="cjxl_tpu",
                                description="JPEG XL encoder (JAX device path)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-d", "--distance", type=float, default=None,
                   help="Butteraugli distance target; 0 = lossless "
                        "(default 1.0)")
    p.add_argument("--quality", type=float, default=None,
                   help="JPEG-style quality 0-100 mapped to distance "
                        "(100 = lossless; encode.cc "
                        "JxlEncoderDistanceFromQuality)")
    p.add_argument("-e", "--effort", type=int, default=3,
                   help="encoder effort 1 (fastest) .. 11 (most thorough)")
    p.add_argument("--lossless", action="store_true")
    p.add_argument("-m", "--modular", action="store_true",
                   help="modular mode; with -d > 0: lossy modular "
                        "(squeeze-residual quantization)")
    p.add_argument("-r", "--resampling", type=int, default=0,
                   choices=(0, 1, 2, 4, 8),
                   help="encode at 1/r scale, decoder upsamples "
                        "(0 = auto: 2x at very low quality)")
    p.add_argument("-p", "--progressive", action="store_true",
                   help="3-pass qprogressive AC (VarDCT)")
    p.add_argument("--progressive_ac", action="store_true",
                   help="spectral progressive AC: VLF/LF/full passes "
                        "(cjxl --progressive_ac)")
    p.add_argument("--qprogressive_ac", action="store_true",
                   help="2-pass quantization-shift progressive AC "
                        "(cjxl --qprogressive_ac)")
    p.add_argument("--progressive_dc", type=int, default=0,
                   help="1: DC rides a separate LF frame")
    p.add_argument("--intensity_target", type=float, default=0.0,
                   help="luminance of samples at 1.0, in nits "
                        "(0 = default; 255 SDR / 10000 PQ)")
    p.add_argument("--photon_noise_iso", type=float, default=0.0,
                   help="synthesize the grain a 35mm sensor at this "
                        "ISO would have")
    p.add_argument("--noise", type=int, default=-1, choices=(-1, 0, 1),
                   help="1: estimate and signal synthetic noise; "
                        "0: off (default: off unless photon_noise_iso)")
    p.add_argument("--patches", type=int, default=-1, choices=(-1, 0, 1),
                   help="0: disable patch detection (default: auto at "
                        "effort >= 7)")
    p.add_argument("--faster_decoding", type=int, default=0,
                   choices=range(5),
                   help="decoding-speed tier 0-4: trade density for "
                        "faster decode (fewer filter passes, capped "
                        "histograms)")
    p.add_argument("--epf", type=int, default=-1, choices=(-1, 0, 1, 2, 3),
                   help="force the edge-preserving-filter iteration "
                        "count (-1 = auto from distance)")
    p.add_argument("--gaborish", type=int, default=-1,
                   choices=(-1, 0, 1),
                   help="force gaborish smoothing on/off (-1 = auto)")
    p.add_argument("--dots", type=int, default=-1, choices=(-1, 0, 1),
                   help="force dot detection on/off (-1 = auto at "
                        "low quality)")
    p.add_argument("--group_order", type=int, default=0, choices=(0, 1),
                   help="1: write sections center-first with a "
                        "permuted TOC (progressive-friendly order)")
    p.add_argument("--center_x", type=int, default=-1,
                   help="--group_order center x (-1 = frame center)")
    p.add_argument("--center_y", type=int, default=-1,
                   help="--group_order center y (-1 = frame center)")
    p.add_argument("-x", "--dec-hints", action="append", default=[],
                   metavar="key=value",
                   help="input hints, e.g. -x color_space="
                        "RGB_D65_SRG_Rel_Lin (color_description.cc "
                        "format)")
    p.add_argument("--override_bitdepth", type=int, default=0,
                   help="sign the stream with this bit depth instead "
                        "of the input's (0 = keep)")
    p.add_argument("--brotli_effort", type=int, default=9,
                   help="brotli quality 0-11 for brotli-coded payloads "
                        "(JPEG metadata, Exif)")
    p.add_argument("--streaming_input", action="store_true",
                   help="memory-map binary PNM input and feed the "
                        "encoder row bands on demand (ChunkedPNM, "
                        "extras/dec/pnm.cc); other formats load whole")
    p.add_argument("--streaming_output", action="store_true",
                   help="lossless: emit via the spec streaming encoder "
                        "(DC-group-major permuted TOC, bounded memory)")
    p.add_argument("--ec_resampling", type=int, default=1,
                   choices=(1, 2, 4, 8),
                   help="encode extra channels (alpha) at 1/r scale "
                        "(requires -r; decoder upsamples)")
    p.add_argument("--frame_indexing", type=str, default="",
                   help="'0'/'1' pattern per animation frame (first "
                        "must be 1): store a jxli frame-index box "
                        "with keyframe codestream offsets")
    p.add_argument("--container", type=int, default=-1,
                   choices=(-1, 0, 1),
                   help="force the ISOBMFF container on (1) or off (0); "
                        "default: container only when boxes need it "
                        "(cjxl_main.cc --container semantics)")
    p.add_argument("--num_threads", type=int, default=0,
                   help="host worker threads for per-group work "
                        "(0 = auto)")
    p.add_argument("--device", action="store_true",
                   help="run pixel compute on the JAX device (GPU) path")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--lossless_jpeg", type=int, default=1,
                   help="1 (default): recompress .jpg input losslessly "
                        "(byte-exact reconstruction); 0: re-encode pixels")
    args = p.parse_args(argv)
    if not 1 <= args.effort <= 11:
        p.error("effort must be in 1..11")
    if args.quality is not None:
        if args.distance is not None:
            p.error("give either --quality or --distance, not both")
        q = args.quality
        # JxlEncoderDistanceFromQuality (encode.cc:1626-1631)
        args.distance = (0.0 if q >= 100.0 else
                         0.1 + (100 - q) * 0.09 if q >= 30 else
                         53.0 / 3000.0 * q * q - 23.0 / 20.0 * q + 25.0)
    elif args.distance is None:
        args.distance = 1.0
    if args.num_threads > 0:
        from libjxl_tpu.parallel.runner import (
            ThreadRunner, set_default_runner,
        )
        set_default_runner(ThreadRunner(args.num_threads))
    if args.brotli_effort != 9:
        from libjxl_tpu.utils import brotli
        brotli.set_default_quality(args.brotli_effort)
    color_encoding = None
    for hint in args.dec_hints:
        key, _, val = hint.partition("=")
        if key == "color_space":
            from libjxl_tpu.extras.color_description import (
                parse_color_description,
            )
            color_encoding = parse_color_description(val)
        else:
            p.error(f"unknown -x hint {key!r} (supported: color_space)")

    # JPEG input defaults to lossless recompression (cjxl_main.cc behavior)
    with open(args.input, "rb") as f:
        head = f.read(3)
    if head[:2] == b"\xff\xd8" and args.lossless_jpeg:
        from libjxl_tpu.jpeg.transcode import encode_jpeg
        with open(args.input, "rb") as f:
            jpg = f.read()
        t0 = time.perf_counter()
        data = encode_jpeg(jpg)
        dt = time.perf_counter() - t0
        with open(args.output, "wb") as f:
            f.write(data)
        if not args.quiet:
            print(f"Recompressed JPEG {len(jpg)} -> {len(data)} bytes "
                  f"({100 * (1 - len(data) / len(jpg)):.1f}% smaller, "
                  f"{dt * 1000:.0f} ms; byte-exact reversible)",
                  file=sys.stderr)
        return 0

    from libjxl_tpu.extras.io import load_animation, load_image

    # animated GIF/APNG input becomes an animated JXL (cjxl_main.cc)
    if args.input.lower().endswith((".gif", ".png", ".apng", ".webp")):
        frames, durations_ms, loops = load_animation(args.input)
        if len(frames) > 1:
            t0 = time.perf_counter()
            if args.lossless or args.distance == 0:
                from libjxl_tpu.api.encoder import (
                    EncodeOptions, encode_animation,
                )
                data = encode_animation(
                    frames, durations_ms,
                    EncodeOptions(effort=args.effort),
                    tps=(1000, 1), num_loops=loops,
                    frame_indexing=args.frame_indexing or None)
            else:
                from libjxl_tpu.vardct.frame_enc import (
                    LossyOptions, encode_lossy_animation,
                )
                data = encode_lossy_animation(
                    frames, durations_ms,
                    LossyOptions(distance=args.distance,
                                 effort=args.effort),
                    tps=(1000, 1), num_loops=loops)
            dt = time.perf_counter() - t0
            with open(args.output, "wb") as f:
                f.write(data)
            if not args.quiet:
                print(f"Compressed {len(frames)} frames to {len(data)} "
                      f"bytes ({dt:.2f} s)", file=sys.stderr)
            return 0

    if args.streaming_input:
        from libjxl_tpu.extras.io import open_image_chunked
        img = open_image_chunked(args.input)
    else:
        img = load_image(args.input)
    if args.override_bitdepth:
        if args.override_bitdepth > 8 and img.dtype == "uint8":
            img = img.astype("uint16") << (args.override_bitdepth - 8)
        # samples are reinterpreted at the signaled depth
        # (cjxl_main.cc --override_bitdepth semantics)
    t0 = time.perf_counter()
    if args.lossless or args.distance == 0 or args.modular:
        from libjxl_tpu.api.encoder import EncodeOptions, encode_lossless
        eo = EncodeOptions(
            effort=args.effort, use_device=args.device,
            faster_decoding=args.faster_decoding,
            distance=0.0 if (args.lossless or args.distance == 0)
            else args.distance)
        if color_encoding is not None:
            eo.color_encoding = color_encoding
        if args.streaming_output:
            from libjxl_tpu.api.encoder import encode_lossless_streaming
            data = b"".join(encode_lossless_streaming(img, eo))
        else:
            data = encode_lossless(img, eo)
    else:
        from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
        lo = LossyOptions(
            distance=args.distance, effort=args.effort,
            resampling=args.resampling, use_device=args.device,
            intensity_target=args.intensity_target,
            photon_noise_iso=args.photon_noise_iso,
            faster_decoding=args.faster_decoding,
            progressive=args.progressive,
            progressive_ac=args.progressive_ac,
            qprogressive_ac=args.qprogressive_ac,
            progressive_dc=args.progressive_dc,
            epf=args.epf, gaborish=args.gaborish,
            group_order=args.group_order,
            center_x=args.center_x, center_y=args.center_y,
            ec_resampling=args.ec_resampling)
        if color_encoding is not None:
            lo.color_encoding = color_encoding
        if args.noise == 1:
            lo.noise = "auto"
        if args.patches == 0:
            lo.patches = False
        if args.dots == 0:
            lo.dots = False
        elif args.dots == 1:
            lo.dots = True
        data = encode_lossy(img, lo)
    dt = time.perf_counter() - t0
    if args.container == 1:
        from libjxl_tpu.api.container import is_container, wrap_container
        if not is_container(data):
            data = wrap_container(data)
    with open(args.output, "wb") as f:
        f.write(data)
    if not args.quiet:
        h, w = img.shape[:2]
        mp = h * w / 1e6
        bpp = len(data) * 8 / (h * w)
        print(f"Compressed {w}x{h} to {len(data)} bytes "
              f"({bpp:.3f} bpp, {mp / dt:.2f} MP/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

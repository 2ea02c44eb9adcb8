"""Minimal one-shot encode (analog of reference examples/encode_oneshot.cc):
load an image file, encode to JPEG XL, write the codestream.

Usage: python examples/encode_oneshot.py in.png out.jxl [distance]
"""
import sys

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")   # force host; drop for the GPU


def main(argv):
    inp, outp = argv[1], argv[2]
    distance = float(argv[3]) if len(argv) > 3 else 1.0
    from libjxl_tpu.extras.io import load_image
    img = load_image(inp)
    if distance == 0.0:
        from libjxl_tpu.api.encoder import EncodeOptions, encode_lossless
        data = encode_lossless(img, EncodeOptions(effort=5))
    else:
        from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
        data = encode_lossy(img, LossyOptions(distance=distance, effort=5))
    with open(outp, "wb") as f:
        f.write(data)
    print(f"{img.shape[1]}x{img.shape[0]} -> {len(data)} bytes")


if __name__ == "__main__":
    main(sys.argv)

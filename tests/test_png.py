"""The stdlib zlib + numpy PNG reader (extras/io.py) against stored
pixel checksums of the corpus (taken with an independent PNG decoder)."""
import hashlib
import os

import numpy as np
import pytest

from libjxl_tpu.extras.io import load_image

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus")
# name: (shape, first 16 hex digits of sha256 over the uint8 pixels)
PIXELS = {
    "graphics.png": ((128, 128, 3), "eef7ed2f6b17d1c1"),
    "large_photo.png": ((768, 1024, 3), "0265618a273fd7fc"),
    "large_screenshot.png": ((768, 1024, 3), "b791a8f983a03406"),
    "large_sky.png": ((768, 1024, 3), "aff62669b1cafd3c"),
    "large_wood.png": ((768, 1024, 3), "331f0ac6aefaf412"),
    "photo_face.png": ((256, 256, 3), "1fa6d5c9c5b7a337"),
    "photo_small.png": ((300, 256, 3), "63912e4526818423"),
    "photo_uniform.png": ((256, 256, 3), "42890c85d439b54e"),
    "pink1.png": ((256, 256, 3), "bb064a166c5d50ec"),
    "pink2.png": ((256, 256, 3), "7bcfd1c9d889a606"),
    "pink3.png": ((256, 256, 3), "a70117a7d456ab0c"),
    "screenshot.png": ((256, 256, 3), "061341a15ed350a4"),
    "sky.png": ((256, 256, 3), "fca655c96ff9f62a"),
    "texture.png": ((256, 256, 3), "e84753d66393e882"),
}


def test_corpus_is_listed():
    assert sorted(PIXELS) == sorted(
        f for f in os.listdir(CORPUS) if f.endswith(".png"))


@pytest.mark.parametrize("name", sorted(PIXELS))
def test_png_reader_matches_checksum(name):
    with open(os.path.join(CORPUS, name), "rb") as f:
        data = f.read()
    from libjxl_tpu.extras.io import _read_png
    px = _read_png(data)
    shape, digest = PIXELS[name]
    assert px.dtype == np.uint8 and px.shape == shape
    assert hashlib.sha256(px.tobytes()).hexdigest()[:16] == digest
    assert np.array_equal(load_image(os.path.join(CORPUS, name)), px)

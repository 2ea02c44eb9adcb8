"""Butteraugli metric tests: self-consistency properties + agreement with
the system libjxl oracle (version-drift tolerance: the reference algorithm
constants evolved between the installed 0.7 and the 0.12 we implement)."""

import numpy as np
import pytest

from libjxl_tpu.metrics.butteraugli import (
    butteraugli_diffmap, butteraugli_distance_srgb, compute_distance_p,
)
from libjxl_tpu.utils.oracle import oracle_available


def _smooth(h=96, w=96):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 200 // w + 20), (yy * 200 // h + 30),
                     np.full((h, w), 128)], -1).astype(np.uint8)


def test_identical_is_zero():
    img = _smooth()
    assert butteraugli_distance_srgb(img, img) < 1e-3


def test_monotone_in_noise():
    img = _smooth()
    rng = np.random.default_rng(0)
    noise = rng.integers(-1, 2, img.shape)
    prev = 0.0
    for k in (2, 6, 14):
        dist = np.clip(img.astype(int) + k * noise, 0, 255).astype(np.uint8)
        d = butteraugli_distance_srgb(img, dist)
        assert d > prev
        prev = d


def test_distmap_locality():
    img = _smooth(128, 128)
    mod = img.copy().astype(int)
    mod[60:68, 60:68] += 30
    mod = np.clip(mod, 0, 255).astype(np.uint8)
    from libjxl_tpu.color.xyb import srgb_to_linear
    a = srgb_to_linear(np.moveaxis(img, -1, 0) / 255.0).astype(np.float32)
    b = srgb_to_linear(np.moveaxis(mod, -1, 0) / 255.0).astype(np.float32)
    dm = np.asarray(butteraugli_diffmap(a, b))
    cy, cx = np.unravel_index(np.argmax(dm), dm.shape)
    assert 52 <= cy <= 76 and 52 <= cx <= 76
    # far corner should be much less affected
    assert dm[:16, :16].max() < 0.2 * dm.max()


@pytest.mark.skipif(not oracle_available(), reason="libjxl not found")
def test_oracle_agreement():
    from libjxl_tpu.utils.oracle import oracle_butteraugli
    from libjxl_tpu.color.xyb import srgb_to_linear
    rng = np.random.default_rng(1)
    img = _smooth(128, 128)
    img = np.clip(img + rng.integers(-12, 12, img.shape), 0,
                  255).astype(np.uint8)
    dist = np.clip((img // 8) * 8 + rng.integers(0, 5, img.shape), 0,
                   255).astype(np.uint8)
    d_oracle, _, dm_oracle = oracle_butteraugli(img, dist)
    a = srgb_to_linear(np.moveaxis(img, -1, 0) / 255.0).astype(np.float32)
    b = srgb_to_linear(np.moveaxis(dist, -1, 0) / 255.0).astype(np.float32)
    dm = np.asarray(butteraugli_diffmap(a, b))
    d_ours = compute_distance_p(dm)
    # version drift tolerance (0.7 system lib vs 0.12 reference constants)
    assert 0.55 * d_oracle < d_ours < 1.5 * d_oracle
    m = dm_oracle > 0.3
    ratio = dm[m] / dm_oracle[m]
    assert ratio.std() < 0.25          # same structure

"""Device restoration-filter pipeline: Gaborish + EPF as one jitted XLA
program (the device render path; same math as ``render/filters.py``
via its ``xp`` parameter — reference ``stage_gaborish.cc``,
``stage_epf.cc``).

The loop-filter parameters travel as a pytree of scalars/arrays so one
compiled program serves every stream of a given shape."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from libjxl_tpu.render import filters as F


class LfParams(NamedTuple):
    """Traced loop-filter constants (frame_header.h LoopFilter)."""

    gab_x_weight1: object
    gab_x_weight2: object
    gab_y_weight1: object
    gab_y_weight2: object
    gab_b_weight1: object
    gab_b_weight2: object
    epf_quant_mul: object
    epf_sharp_lut: object
    epf_channel_scale: object
    epf_border_sad_mul: object
    epf_pass0_sigma_scale: object
    epf_pass2_sigma_scale: object


def lf_params(lf) -> LfParams:
    import jax.numpy as jnp

    f = jnp.float32
    return LfParams(
        f(lf.gab_x_weight1), f(lf.gab_x_weight2),
        f(lf.gab_y_weight1), f(lf.gab_y_weight2),
        f(lf.gab_b_weight1), f(lf.gab_b_weight2),
        f(lf.epf_quant_mul),
        jnp.asarray(lf.epf_sharp_lut, jnp.float32),
        jnp.asarray(lf.epf_channel_scale, jnp.float32),
        f(lf.epf_border_sad_mul),
        f(lf.epf_pass0_sigma_scale), f(lf.epf_pass2_sigma_scale),
    )


@functools.partial(
    __import__("jax").jit,
    static_argnames=("gab", "epf_iters"))
def _restore(xyb, raw_quant, epf_sharpness, quant_scale, lfp: LfParams,
             gab: bool, epf_iters: int):
    import jax.numpy as jnp

    if gab:
        xyb = F.gaborish(xyb, lfp, xp=jnp)
    if epf_iters > 0:
        inv_sigma = F.compute_sigma(lfp, None, None, raw_quant,
                                    epf_sharpness, quant_scale, xp=jnp)
        if epf_iters >= 3:
            xyb = F.epf_step0(xyb, inv_sigma, lfp, xp=jnp)
        xyb = F.epf_step1(xyb, inv_sigma, lfp, xp=jnp)
        if epf_iters >= 2:
            xyb = F.epf_step2(xyb, inv_sigma, lfp, xp=jnp)
    return xyb


def restore_device(xyb: np.ndarray, lf, raw_quant, epf_sharpness,
                   quant_scale: float, fetch: bool = True):
    """Run gaborish+EPF as one fused XLA device program.

    With ``fetch`` (default) the result comes back as numpy; with
    ``fetch=False`` it STAYS on device so a downstream device stage
    (color conversion / quantization) can consume it without a host
    round-trip."""
    import jax.numpy as jnp

    out = _restore(jnp.asarray(xyb, jnp.float32),
                   jnp.asarray(raw_quant), jnp.asarray(epf_sharpness),
                   jnp.float32(quant_scale), lf_params(lf),
                   bool(lf.gab), int(lf.epf_iters))
    if not fetch:
        return out
    return np.asarray(out).astype(xyb.dtype)


@functools.partial(__import__("jax").jit, static_argnames=("maxval",))
def _output_int(xyb, intensity, maxval: int):
    """XYB (3, H, W) -> (H, W, 3) integer sRGB on device: the inverse
    opsin transform (dec_xyb-inl.h:39-86), sRGB encode and quantization
    fused into the same device program as the filters so only the final
    uint8/uint16 image is copied to the host."""
    import jax.numpy as jnp

    from libjxl_tpu.color.xyb import INVERSE_OPSIN, NEG_BIAS_CBRT, \
        OPSIN_BIAS

    gamma = jnp.stack([xyb[1] + xyb[0], xyb[1] - xyb[0], xyb[2]])
    gamma = gamma - NEG_BIAS_CBRT
    mixed = gamma * gamma * gamma - OPSIN_BIAS
    # 3x3 color matrix as explicit float32 multiply-adds: a matmul may
    # run at reduced (bf16/TF32) precision and visibly shift dark pixels
    inv = INVERSE_OPSIN * (255.0 / intensity)
    linear = jnp.stack([
        inv[c][0] * mixed[0] + inv[c][1] * mixed[1] + inv[c][2] * mixed[2]
        for c in range(3)])
    a = jnp.abs(linear)
    enc = jnp.where(a <= 0.0031308, a * 12.92,
                    1.055 * a ** (1 / 2.4) - 0.055)
    srgb = jnp.sign(linear) * enc
    out = jnp.clip(jnp.round(srgb * maxval), 0, maxval)
    out = jnp.moveaxis(out, 0, -1)
    return out.astype(jnp.uint8 if maxval <= 255 else jnp.uint16)


def output_srgb_int_device(xyb_dev, intensity: float,
                           maxval: int) -> np.ndarray:
    """Fetch the final integer sRGB image (h, w, 3) from a device-held
    XYB array produced by ``restore_device(fetch=False)``."""
    import jax.numpy as jnp

    return np.asarray(_output_int(xyb_dev, jnp.float32(intensity),
                                  int(maxval)))


def restore_banded(xyb: np.ndarray, lf, raw_quant, epf_sharpness,
                   quant_scale: float, gd: int = 256,
                   margin: int = 8) -> np.ndarray:
    """Whole-frame filters applied in the SAME group-row windows the
    low-memory path uses (decoder.py filter_band: 8-row halos from the
    neighboring bands). Window shapes — and therefore the compiled XLA
    programs and their f32 rounding — match decode_rows exactly, so
    banded and whole-frame decode stay bit-identical."""
    h = xyb.shape[1]
    n_gy = -(-h // gd)
    parts = []
    for gy in range(n_gy):
        y0 = gy * gd
        rows = min(gd, h - y0)
        top = margin if gy > 0 else 0
        bot = margin if y0 + rows < h else 0
        ext = xyb[:, y0 - top:y0 + rows + bot]
        br0 = (y0 - top) // 8
        br1 = br0 + -(-ext.shape[1] // 8)
        f = np.asarray(restore_device(
            ext, lf, np.asarray(raw_quant)[br0:br1],
            np.asarray(epf_sharpness)[br0:br1], quant_scale))
        parts.append(f[:, top:top + rows])
    return np.concatenate(parts, axis=1)

"""Encoder-side roundtrip reconstruction for the butteraugli loop.

The reference's FindBestQuantization scores candidate quant fields by
reconstructing the image directly from encoder state — RoundtripImage
(``enc_adaptive_quantization.cc:840``) runs the real decoder fed by
``GetBlockFromEncoder`` (``dec_group.cc:662``), so no bitstream is
emitted or parsed inside the loop. This module is that path for our
encoder: it fills a ``VarDCTFrameDecoder`` with the encoder's quantized
products (no BitReaders involved) and reuses the decoder's own batched
dequant + CfL + LLF + IDCT (``_reconstruct_group_batched``) and filter
math, guaranteeing the roundtrip matches what the emitted stream will
decode to.
"""

from __future__ import annotations

import numpy as np

from libjxl_tpu.core.frame_header import (
    ColorTransform, FrameEncoding, FrameHeader,
)


def _recon_meta():
    """Minimal ImageMetadata for a recon-only decoder instance."""
    from libjxl_tpu.core.headers import ColorEncoding, ImageMetadata
    return ImageMetadata(xyb_encoded=True,
                         color_encoding=ColorEncoding.srgb(gray=False))


def reconstruct_prefilter(state: dict):
    """Reconstruct the pre-filter XYB image from encoder state.

    ``state`` is the dict captured by ``encode_lossy(_recon_only=True)``.
    Returns ``(xyb, dec, lf)`` with the same meaning as the decoder's
    ``_return_prefilter`` hook: cropped (3, H, W) float XYB plus the
    filled decoder (for compute_sigma inputs) and loop-filter params.
    """
    from libjxl_tpu.vardct.frame_dec import VarDCTFrameDecoder

    fd = state["fd"]
    fh = FrameHeader(encoding=FrameEncoding.VARDCT,
                     color_transform=ColorTransform.XYB)
    fh.x_qm_scale = state["x_qm_scale"]
    fh.loop_filter.gab = state["gab"]
    fh.loop_filter.epf_iters = state["epf_iters"]
    dec = VarDCTFrameDecoder(fh, _recon_meta(), fd)
    dec.quantizer = state["quantizer"]
    dec.matrices = state["matrices"]
    dec.raw_quant[:] = state["raw_quant"]
    dec.acs_raw[:] = state["acs"]
    dec.acs_anchor[:] = state["anchors"]
    sharp = state.get("sharpness")
    if sharp is None:
        dec.epf_sharpness[:] = 4 if fh.loop_filter.epf_iters > 0 else 0
    else:
        dec.epf_sharpness[:] = sharp
    dec.ytox_map[:] = state["ytox"]
    dec.ytob_map[:] = state["ytob"]

    # DC exactly as decode_dc_group dequantizes it (CfL DC base factors
    # x=0, b=1), then adaptive smoothing
    q_dc = state["q_dc"]
    mul_dc = dec.quantizer.mul_dc(dec.matrices.dc_quant)
    dcy = q_dc[:, :, 1].astype(np.float32) * np.float32(mul_dc[1])
    dcx = q_dc[:, :, 0].astype(np.float32) * np.float32(mul_dc[0])
    dcb = q_dc[:, :, 2].astype(np.float32) * np.float32(mul_dc[2]) + dcy
    dec.dc = np.stack([dcx, dcy, dcb])
    dec.finalize_dc()

    yb, xb = state["raw_quant"].shape
    gdb = fd.group_dim // 8
    blocks = state["blocks"]
    q_ac = state.get("q_ac")
    for gy in range(fd.ysize_groups):
        for gx in range(fd.xsize_groups):
            by0, bx0 = gy * gdb, gx * gdb
            h_ = min(gdb, yb - by0)
            w_ = min(gdb, xb - bx0)
            acs_g = dec.acs_raw[by0:by0 + h_, bx0:bx0 + w_]
            anc_g = dec.acs_anchor[by0:by0 + h_, bx0:bx0 + w_]
            if blocks is not None:
                ys, xs = np.nonzero(anc_g)
                parts = [blocks[(by0 + by, bx0 + bx)]["q"].reshape(3, -1)
                         for by, bx in zip(ys, xs)]
                coeffs = (np.concatenate(parts, axis=1).astype(np.float32)
                          if parts else np.zeros((3, 0), np.float32))
            else:
                # DCT8-only path: every block is an anchor of size 64
                coeffs = q_ac[by0:by0 + h_, bx0:bx0 + w_].transpose(
                    2, 0, 1, 3).reshape(3, -1).astype(np.float32)
            dec._reconstruct_group_batched(bx0, by0, w_, h_,
                                           acs_g, anc_g, coeffs)
    xyb = dec.pixels[:, :fd.ysize, :fd.xsize]
    return xyb, dec, fh.loop_filter


def _score_jit():
    """Build (once) the fused device scorer: gaborish + EPF + XYB->linear
    + butteraugli diffmap + per-8x8 16th-power block sums, one XLA
    program; only the (yb, xb) block-sum grid leaves the device. This is
    the SURVEY §7 step-9 design: the roundtrip never visits the host
    (the reference decodes on CPU inside its loop,
    enc_adaptive_quantization.cc:840)."""
    global _SCORE_FN
    if _SCORE_FN is not None:
        return _SCORE_FN
    import functools

    import jax
    import jax.numpy as jnp

    from libjxl_tpu.color.xyb import INVERSE_OPSIN, NEG_BIAS_CBRT, \
        OPSIN_BIAS
    from libjxl_tpu.metrics.butteraugli import butteraugli_diffmap
    from libjxl_tpu.render import filters as F

    @functools.partial(jax.jit,
                       static_argnames=("gab", "epf_iters", "h", "w"))
    def score(xyb, orig_lin, raw_quant, sharp, scale, lfp,
              gab: bool, epf_iters: int, h: int, w: int):
        if gab:
            xyb = F.gaborish(xyb, lfp, xp=jnp)
        if epf_iters > 0:
            inv_sigma = F.compute_sigma(lfp, None, None, raw_quant,
                                        sharp, scale, xp=jnp)
            if epf_iters >= 3:
                xyb = F.epf_step0(xyb, inv_sigma, lfp, xp=jnp)
            xyb = F.epf_step1(xyb, inv_sigma, lfp, xp=jnp)
            if epf_iters >= 2:
                xyb = F.epf_step2(xyb, inv_sigma, lfp, xp=jnp)
        # XYB -> linear RGB (dec_xyb-inl.h), clipped like a u8 decode
        g = jnp.stack([xyb[1] + xyb[0], xyb[1] - xyb[0], xyb[2]]) \
            - NEG_BIAS_CBRT
        mixed = g * g * g - OPSIN_BIAS
        lin = jnp.einsum("ij,jhw->ihw",
                         jnp.asarray(INVERSE_OPSIN, jnp.float32), mixed,
                         precision=jax.lax.Precision.HIGHEST)
        lin = jnp.clip(lin, 0.0, 1.0)
        dm = butteraugli_diffmap(orig_lin, lin, hf_asymmetry=0.8)
        yb8, xb8 = (h + 7) // 8, (w + 7) // 8
        pad = jnp.zeros((yb8 * 8, xb8 * 8), jnp.float32
                        ).at[:h, :w].set(dm.astype(jnp.float32))
        # f32 pow-16: dm < ~0.004 underflows to 0, a vanishing
        # contribution to the 16-norm (the device path stays in f32)
        v16 = pad ** 16
        return v16.reshape(yb8, 8, xb8, 8).sum(axis=(1, 3))

    _SCORE_FN = score
    return score


_SCORE_FN = None


def roundtrip_block_sums(state: dict, orig_lin_f32, h: int, w: int
                         ) -> np.ndarray:
    """Reconstruct + filter + butteraugli-score on device: returns the
    (yb, xb) per-block sums of diffmap**16 for _tile_dist_map."""
    import jax.numpy as jnp

    from libjxl_tpu.render.filters_jax import lf_params

    xyb, dec, lf = reconstruct_prefilter(state)
    score = _score_jit()
    sums = score(jnp.asarray(xyb, jnp.float32), orig_lin_f32,
                 jnp.asarray(dec.raw_quant), jnp.asarray(dec.epf_sharpness),
                 float(dec.quantizer.scale), lf_params(lf),
                 bool(lf.gab), int(lf.epf_iters), h, w)
    return np.asarray(sums, np.float64)


_EPF_ERR_FN = None


def _epf_err_jit():
    """Fused candidate-sharpness error grids for the EPF search
    (ComputeARHeuristics, enc_heuristics.cc:892-1018): for each uniform
    sharpness candidate, run the EPF chain and reduce the weighted L2
    error to per-8x8-block sums — one XLA program, one small fetch."""
    global _EPF_ERR_FN
    if _EPF_ERR_FN is not None:
        return _EPF_ERR_FN
    import functools

    import jax
    import jax.numpy as jnp

    from libjxl_tpu.render import filters as F

    @functools.partial(jax.jit, static_argnames=("steps", "gab",
                                                 "epf_iters", "h", "w"))
    def errs(xyb, orig, raw_quant, scale, lfp, steps: tuple,
             gab: bool, epf_iters: int, h: int, w: int):
        if gab:
            xyb = F.gaborish(xyb, lfp, xp=jnp)
        kw = jnp.asarray([12.339445295782363, 1.0, 0.2], jnp.float32)
        yb8, xb8 = (h + 7) // 8, (w + 7) // 8

        def one(s):
            sh = jnp.full((yb8, xb8), s, jnp.int32)
            inv_sigma = F.compute_sigma(lfp, None, None, raw_quant, sh,
                                        scale, xp=jnp)
            out = xyb
            if epf_iters >= 3:
                out = F.epf_step0(out, inv_sigma, lfp, xp=jnp)
            out = F.epf_step1(out, inv_sigma, lfp, xp=jnp)
            if epf_iters >= 2:
                out = F.epf_step2(out, inv_sigma, lfp, xp=jnp)
            d2 = ((out - orig) ** 2 * kw[:, None, None]).sum(axis=0)
            pad = jnp.zeros((yb8 * 8, xb8 * 8), jnp.float32
                            ).at[:h, :w].set(d2)
            return pad.reshape(yb8, 8, xb8, 8).sum(axis=(1, 3))

        return jnp.stack([one(s) for s in steps])

    _EPF_ERR_FN = errs
    return errs


def epf_candidate_errs(xyb_pre, dec, lf, orig_xyb, steps: tuple
                       ) -> np.ndarray:
    """(len(steps), yb, xb) per-block weighted-L2 error sums for uniform
    sharpness candidates, computed on device."""
    import jax.numpy as jnp

    from libjxl_tpu.render.filters_jax import lf_params

    _, h, w = xyb_pre.shape
    fn = _epf_err_jit()
    out = fn(jnp.asarray(xyb_pre, jnp.float32),
             jnp.asarray(orig_xyb[:, :h, :w], jnp.float32),
             jnp.asarray(dec.raw_quant), float(dec.quantizer.scale),
             lf_params(lf), tuple(int(s) for s in steps),
             bool(lf.gab), int(lf.epf_iters), h, w)
    return np.asarray(out, np.float64)


def filtered_linear(xyb: np.ndarray, dec, lf) -> np.ndarray:
    """Apply gaborish + EPF to a pre-filter recon and convert to linear
    RGB clipped to [0, 1] (the range a u8 decode would produce) for
    butteraugli scoring."""
    from libjxl_tpu.color.xyb import xyb_to_linear
    from libjxl_tpu.render.filters import (
        compute_sigma, epf_step0, epf_step1, epf_step2, gaborish,
    )
    out = gaborish(xyb, lf) if lf.gab else xyb
    if lf.epf_iters > 0:
        inv_sigma = compute_sigma(lf, dec.acs_raw, dec.acs_anchor,
                                  dec.raw_quant, dec.epf_sharpness,
                                  dec.quantizer.scale)
        if lf.epf_iters >= 3:
            out = epf_step0(out, inv_sigma, lf)
        out = epf_step1(out, inv_sigma, lf)
        if lf.epf_iters >= 2:
            out = epf_step2(out, inv_sigma, lf)
    return np.clip(xyb_to_linear(np.asarray(out, np.float64)), 0.0, 1.0)

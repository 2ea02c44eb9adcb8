"""Device-resident butteraugli loop for e7+ VarDCT encode.

The reference's FindBestQuantization reconstructs candidate quant
fields straight from encoder state (RoundtripImage,
``enc_adaptive_quantization.cc:840``) — but on the CPU, once per
iteration. Here the whole iteration body lives in ONE XLA program per
step: requantize the cached forward coefficients with the new field,
dequantize, chroma-from-luma, LLF + IDCT, restoration filters,
XYB->linear, butteraugli diffmap, per-8x8 pow-16 sums. Only the (yb,
xb) raw-quant field goes up and the (yb8, xb8) sum grid comes down
(~50 KB each way); pixels never leave HBM (SURVEY §7 step 9).

The per-strategy-class dense batching mirrors the batched device
decoder (``models/vardct_decode._decode_batch_var``); the forward
quantization mirrors ``vardct/enc_acs.transform_all``/``finish_chroma``
(enc_group.cc:329-360 semantics) with the CfL factor maps frozen at
their first-pass values — the final emit recomputes them exactly, the
loop only steers the field.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

_SPECIALS = (1, 2, 3, 12, 13, 14, 15, 16, 17)


@jax.jit
def _srgb_linear_dev(px_u8):
    """(h, w, 3) u8 sRGB -> (3, h, w) f32 linear, on device."""
    srgb = jnp.moveaxis(px_u8.astype(jnp.float32), -1, 0) / 255.0
    return jnp.where(srgb <= 0.04045, srgb / 12.92,
                     ((srgb + 0.055) / 1.055) ** 2.4)


def _bias(q, c):
    from libjxl_tpu.vardct.frame_dec import K_BIASES
    absq = jnp.abs(q)
    out = q - K_BIASES[3] / jnp.where(q == 0, 1.0, q)
    out = jnp.where(absq < 0.5, 0.0, out)
    return jnp.where((absq > 0.5) & (absq < 1.5),
                     jnp.sign(q) * K_BIASES[c], out)


@functools.partial(jax.jit, static_argnames=(
    "classes", "gab", "epf_iters", "h", "w", "yb", "xb", "sharp_val",
    "score"))
def _loop_step(class_data, dc_float, fx_map, fb_map, x_cc, b_cc,
               raw_quant, scale, inv_gs, mul_dc, dms, x_qm_mul,
               orig_lin, lfp, classes: tuple, gab: bool, epf_iters: int,
               h: int, w: int, yb: int, xb: int, sharp_val: int,
               score: bool):
    """One loop iteration on device. Returns (yb8, xb8) diffmap**16
    block sums when ``score``, else the pre-filter (3, h, w) recon."""
    from libjxl_tpu.render import filters as F
    from libjxl_tpu.vardct.ac_strategy import COVERED_X, COVERED_Y
    from libjxl_tpu.vardct.dct import (
        dct_matrix, idct_matrix, resample_scales,
    )
    from libjxl_tpu.vardct.enc_acs import _thresholds
    from libjxl_tpu.vardct.enc_transforms_small import inverse_matrix
    from libjxl_tpu.vardct.quant_weights import DequantMatrices

    hp = jax.lax.Precision.HIGHEST
    mats = DequantMatrices()

    # ---- DC: quantize + dequantize + adaptive smoothing (the exact
    # q_dc math of frame_enc.py:626-638 and compressed_dc.cc:47-127) --
    dcy = jnp.rint(dc_float[1] / mul_dc[1]) * mul_dc[1]
    dcx = jnp.rint(dc_float[0] / mul_dc[0]) * mul_dc[0]
    dcb = jnp.rint((dc_float[2] - dcy) / mul_dc[2]) * mul_dc[2] + dcy
    dc = jnp.stack([dcx, dcy, dcb])
    if yb > 2 and xb > 2:
        w1 = jnp.float32(0.20345139757231578)
        w2 = jnp.float32(0.0334829185968739)
        w0 = 1.0 - 4.0 * (w1 + w2)
        cc = dc[:, 1:-1, 1:-1]
        sm = (w0 * cc
              + w1 * (dc[:, 1:-1, :-2] + dc[:, 1:-1, 2:]
                      + dc[:, :-2, 1:-1] + dc[:, 2:, 1:-1])
              + w2 * (dc[:, :-2, :-2] + dc[:, :-2, 2:]
                      + dc[:, 2:, :-2] + dc[:, 2:, 2:]))
        gap = jnp.maximum(
            jnp.float32(0.5),
            jnp.abs((cc - sm) / mul_dc[:, None, None]).max(axis=0))
        factor = jnp.maximum(3.0 - 4.0 * gap, 0.0)
        dc = dc.at[:, 1:-1, 1:-1].set((sm - cc) * factor[None] + cc)

    # scratch frame 1 absorbs padding-block scatters
    img = jnp.zeros((2, 3, yb * 8, xb * 8), jnp.float32)
    dc_p = jnp.stack([dc, jnp.zeros_like(dc)])
    rq_f = raw_quant.astype(jnp.float32)

    for ci, s in enumerate(classes):
        coefs, fy, fx, fi = class_data[ci]
        nby, nbx = COVERED_Y[s], COVERED_X[s]
        tab = jnp.asarray(
            mats.table_for_strategy(s).reshape(3, -1), jnp.float32)
        ith = 1.0 / tab
        th_y = jnp.asarray(_thresholds(nby, nbx, True), jnp.float32)
        th_xb = jnp.asarray(_thresholds(nby, nbx, False), jnp.float32)
        qf_c = jnp.where(fi == 0, rq_f[fy, fx], 1.0)
        qac = scale * qf_c

        # forward quantize (enc_group.cc:329-360): Y, roundtrip for CfL,
        # then X/B residuals against the frozen factor maps
        vy = coefs[:, 1] * (ith[1][None] * qac[:, None])
        q_y = jnp.where(jnp.abs(vy) >= th_y[None], jnp.rint(vy), 0.0)
        y_rt = _bias(q_y, 1) * tab[1][None] * (inv_gs / qf_c)[:, None]
        fxc = fx_map[fy, fx]
        fbc = fb_map[fy, fx]
        vx = (coefs[:, 0] - fxc[:, None] * y_rt) * \
            (ith[0][None] * (qac * x_qm_mul)[:, None])
        vb = (coefs[:, 2] - fbc[:, None] * y_rt) * \
            (ith[2][None] * qac[:, None])
        q_x = jnp.where(jnp.abs(vx) >= th_xb[None], jnp.rint(vx), 0.0)
        q_b = jnp.where(jnp.abs(vb) >= th_xb[None], jnp.rint(vb), 0.0)
        q = jnp.stack([q_x, q_y, q_b], axis=1)

        # decoder-side dequant + CfL (models/vardct_decode semantics)
        dq = jnp.stack([_bias(q[:, c], c) for c in range(3)], axis=1)
        dq = dq * (tab[None] * dms[None, :, None]) * \
            (inv_gs / qf_c)[:, None, None]
        xc = x_cc[fy // 8, fx // 8]
        bc = b_cc[fy // 8, fx // 8]
        y_ch = dq[:, 1]
        dq = jnp.stack([dq[:, 0] + xc[:, None] * y_ch, y_ch,
                        dq[:, 2] + bc[:, None] * y_ch], axis=1)
        if s in _SPECIALS:
            stored = dq.at[:, :, 0].set(
                dc_p[fi[:, None], jnp.arange(3)[None, :], fy[:, None],
                     fx[:, None]])
            M = jnp.asarray(inverse_matrix(s), jnp.float32)
            pix = jnp.einsum("ncs,ps->ncp", stored, M,
                             precision=hp).reshape(-1, 3, 8, 8)
            R = C = 8
        else:
            mn, mx = min(nby, nbx), max(nby, nbx)
            stored = dq.reshape(-1, 3, mn * 8, mx * 8)
            ay = jnp.arange(nby)
            ax = jnp.arange(nbx)
            dcb_ = dc_p[fi[:, None, None, None],
                        jnp.arange(3)[None, :, None, None],
                        (fy[:, None, None] + ay[None, :, None])[:, None],
                        (fx[:, None, None] + ax[None, None, :])[:, None]]
            dmy = jnp.asarray(dct_matrix(nby), jnp.float32)
            dmx = jnp.asarray(dct_matrix(nbx), jnp.float32)
            llf = jnp.einsum("uy,ncyx,vx->ncuv", dmy, dcb_, dmx,
                             precision=hp)
            llf = llf / jnp.asarray(
                resample_scales(nby), jnp.float32)[:, None] / \
                jnp.asarray(resample_scales(nbx), jnp.float32)[None, :]
            llf_st = jnp.swapaxes(llf, 2, 3) if nby >= nbx else llf
            stored = stored.at[:, :, :llf_st.shape[2],
                               :llf_st.shape[3]].set(llf_st)
            R, C = nby * 8, nbx * 8
            rc = jnp.swapaxes(stored, 2, 3) if R >= C else stored
            imy = jnp.asarray(idct_matrix(R), jnp.float32)
            imx = jnp.asarray(idct_matrix(C), jnp.float32)
            pix = jnp.einsum("uy,ncyx,vx->ncuv", imy, rc, imx,
                             precision=hp)
        yy = fy[:, None] * 8 + jnp.arange(R)[None, :]
        xx = fx[:, None] * 8 + jnp.arange(C)[None, :]
        img = img.at[fi[:, None, None, None],
                     jnp.arange(3)[None, :, None, None],
                     yy[:, None, :, None],
                     xx[:, None, None, :]].set(pix)

    xyb = img[0, :, :h, :w]
    if not score:
        return xyb

    # ---- filters + butteraugli + per-block pow-16 sums (the fused
    # scorer of enc_roundtrip._score_jit) ------------------------------
    from libjxl_tpu.color.xyb import INVERSE_OPSIN, NEG_BIAS_CBRT, \
        OPSIN_BIAS
    from libjxl_tpu.metrics.butteraugli import butteraugli_diffmap

    out = xyb
    if gab:
        out = F.gaborish(out, lfp, xp=jnp)
    if epf_iters > 0:
        sharp = jnp.full((yb, xb), sharp_val, jnp.int32)
        inv_sigma = F.compute_sigma(lfp, None, None, raw_quant, sharp,
                                    scale, xp=jnp)
        if epf_iters >= 3:
            out = F.epf_step0(out, inv_sigma, lfp, xp=jnp)
        out = F.epf_step1(out, inv_sigma, lfp, xp=jnp)
        if epf_iters >= 2:
            out = F.epf_step2(out, inv_sigma, lfp, xp=jnp)
    g = jnp.stack([out[1] + out[0], out[1] - out[0], out[2]]) \
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
    v16 = pad ** 16
    return v16.reshape(yb8, 8, xb8, 8).sum(axis=(1, 3))


class LoopState:
    """Per-frame device-resident loop state, built once after the first
    heuristics pass (coefficients, DC grid, CfL maps, original image)."""

    def __init__(self, state: dict, aux: dict, orig_lin_f32, d: float,
                 x_qm_mul: float, h: int, w: int,
                 orig_u8: np.ndarray | None = None):
        from libjxl_tpu.render.filters_jax import lf_params
        from libjxl_tpu.vardct.cfl import ColorCorrelation

        cc = aux["coef_cache"]
        acs = aux["acs"]
        anchors = aux["anchors"]
        yb, xb = acs.shape
        self.d = d
        self.acs, self.anchors = acs, anchors
        self.yb, self.xb, self.h, self.w = yb, xb, h, w
        self.gab = bool(state["gab"])
        self.epf_iters = int(state["epf_iters"])
        self.x_qm_mul = float(x_qm_mul)
        x_qm_scale = state["x_qm_scale"]
        self.dms = jnp.asarray(
            [(1 / 1.25) ** (x_qm_scale - 2.0), 1.0, 1.0], jnp.float32)
        self.lfp = lf_params(state_lf(state))
        cmap = ColorCorrelation()
        self.x_cc = jnp.asarray(
            cmap.ytox_ratio_arr(state["ytox"]), jnp.float32)
        self.b_cc = jnp.asarray(
            cmap.ytob_ratio_arr(state["ytob"]), jnp.float32)
        cs = cmap.color_scale
        fx_full = np.repeat(np.repeat(state["ytox"], 8, 0), 8, 1)[
            :yb, :xb] * cs
        fb_full = 1.0 + np.repeat(np.repeat(state["ytob"], 8, 0), 8, 1)[
            :yb, :xb] * cs
        self.fx_map = jnp.asarray(fx_full, jnp.float32)
        self.fb_map = jnp.asarray(fb_full, jnp.float32)
        self.dc_float = jnp.asarray(cc["dc_float"], jnp.float32)
        if orig_u8 is not None:
            # ship the ORIGINAL as uint8 and widen on device: a quarter
            # of the f32 linear plane's bytes, and the sRGB->linear
            # convert is trivial elementwise work
            self.orig_lin = _srgb_linear_dev(jnp.asarray(orig_u8))
        else:
            self.orig_lin = jnp.asarray(orig_lin_f32, jnp.float32)

        # FIXED class tuple + coarse capacity buckets: `classes` and
        # every class_data shape are static jit args, so a per-image
        # class layout would recompile _loop_step per image (tens of
        # seconds per compile). Keeping the full candidate set
        # (absent classes ride as all-padding) and bucketing counts to
        # >=256-pow2 makes the program cache key depend only on the
        # image SIZE for virtually all content.
        dev = cc.get("dev")
        if dev is not None:
            # device transform path (models/vardct_transform): the raw
            # per-class coefficient batches already sit in HBM with the
            # shared fixed-class layout — zero h2d staging here
            classes = []
            class_data = []
            for s_ in sorted(dev):
                coefs_d, by0_d, bx0_d, fi_d, _n = dev[s_]
                classes.append(int(s_))
                class_data.append((coefs_d, by0_d, bx0_d, fi_d))
            self.classes = tuple(classes)
            self.class_data = tuple(class_data)
            return

        present = {int(k) for k in cc if isinstance(k, int)}
        all_classes = sorted(present | {0, 1, 2, 3, 4, 5, 6, 7, 10, 11,
                                        12, 13, 14, 15, 16, 17, 18, 19,
                                        20})
        classes = []
        class_data = []
        from libjxl_tpu.vardct.ac_strategy import COVERED_X as _CX, \
            COVERED_Y as _CY
        for s in all_classes:
            cov = int(_CY[s]) * int(_CX[s])
            if s in present:
                by0, bx0 = np.nonzero(anchors & (acs == s))
                coefs = np.stack([cc[s][c] for c in range(3)], axis=1)
                n = len(by0)
            else:
                by0 = bx0 = np.zeros(0, np.int64)
                coefs = np.zeros((0, 3, cov * 64), np.float32)
                n = 0
            # min cap sized so each class's padding costs <= ~0.2 MP of
            # IDCT work; the total padded overhead stays ~1x the image
            min_cap = max(16, 2048 // cov)
            cap = max(min_cap, 1 << int(np.ceil(np.log2(max(n, 1)))))
            pad = cap - n

            def cat_pad(a, fill=0):
                return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1),
                              constant_values=fill)

            classes.append(int(s))
            class_data.append((
                jnp.asarray(cat_pad(coefs).astype(np.float32)),
                jnp.asarray(cat_pad(by0.astype(np.int32))),
                jnp.asarray(cat_pad(bx0.astype(np.int32))),
                jnp.asarray(np.pad(np.zeros(n, np.int32), (0, pad),
                                   constant_values=1)),
            ))
        self.classes = tuple(classes)
        self.class_data = tuple(class_data)

    def _quant_for(self, qf: np.ndarray):
        from libjxl_tpu.vardct.adaptive_quant import (
            compute_global_scale_and_quant, initial_quant_dc,
        )
        from libjxl_tpu.vardct.enc_acs import adjust_field_for_acs
        from libjxl_tpu.vardct.frame_dec import Quantizer
        from libjxl_tpu.vardct.quant_weights import DequantMatrices

        quant_dc_f = initial_quant_dc(self.d)
        global_scale, quant_dc_int, raw_quant = \
            compute_global_scale_and_quant(quant_dc_f, qf)
        raw_quant = adjust_field_for_acs(
            self.acs, self.anchors, raw_quant, self.d)
        quantizer = Quantizer(global_scale, quant_dc_int)
        mul_dc = quantizer.mul_dc(DequantMatrices().dc_quant)
        return (jnp.asarray(raw_quant.astype(np.int32)),
                jnp.float32(quantizer.scale),
                jnp.float32(quantizer.inv_global_scale),
                jnp.asarray(np.asarray(mul_dc), jnp.float32))

    def _run(self, qf, score: bool):
        raw_quant, scale, inv_gs, mul_dc = self._quant_for(qf)
        return _loop_step(
            self.class_data, self.dc_float, self.fx_map, self.fb_map,
            self.x_cc, self.b_cc, raw_quant, scale, inv_gs, mul_dc,
            self.dms, jnp.float32(self.x_qm_mul), self.orig_lin,
            self.lfp, classes=self.classes, gab=self.gab,
            epf_iters=self.epf_iters, h=self.h, w=self.w, yb=self.yb,
            xb=self.xb, sharp_val=4 if self.epf_iters > 0 else 0,
            score=score)

    def block_sums(self, qf: np.ndarray) -> np.ndarray:
        """(yb8, xb8) diffmap**16 sums for _tile_dist_map."""
        return np.asarray(self._run(qf, True), np.float64)

    def recon_prefilter(self, qf: np.ndarray):
        """Pre-filter (3, h, w) recon as a DEVICE array (for the EPF
        sharpness search) plus a shim with the decoder fields
        epf_candidate_errs reads."""
        from libjxl_tpu.vardct.adaptive_quant import (
            compute_global_scale_and_quant, initial_quant_dc,
        )
        from libjxl_tpu.vardct.enc_acs import adjust_field_for_acs
        from libjxl_tpu.vardct.frame_dec import Quantizer

        xyb = self._run(qf, False)
        quant_dc_f = initial_quant_dc(self.d)
        global_scale, quant_dc_int, raw_quant = \
            compute_global_scale_and_quant(quant_dc_f, qf)
        raw_quant = adjust_field_for_acs(
            self.acs, self.anchors, raw_quant, self.d)

        class _Shim:
            pass

        shim = _Shim()
        shim.raw_quant = raw_quant
        shim.quantizer = Quantizer(global_scale, quant_dc_int)
        shim.epf_sharpness = np.full((self.yb, self.xb),
                                     4 if self.epf_iters > 0 else 0,
                                     np.int32)
        return xyb, shim


def state_lf(state: dict):
    """LoopFilter params matching enc_roundtrip.reconstruct_prefilter."""
    from libjxl_tpu.core.frame_header import (
        ColorTransform, FrameEncoding, FrameHeader,
    )
    fh = FrameHeader(encoding=FrameEncoding.VARDCT,
                     color_transform=ColorTransform.XYB)
    fh.loop_filter.gab = state["gab"]
    fh.loop_filter.epf_iters = state["epf_iters"]
    return fh.loop_filter

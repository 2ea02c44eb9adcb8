"""Device-resident VarDCT frame reconstruction.

The host does what is inherently serial — bitstream parse + rANS token
decode (native C++, GIL-released) — and ships one compact int16
coefficient tensor per frame to the device. Everything pixel-shaped
runs as ONE jitted XLA program per batch of frames:

    dequant-bias -> dequant -> chroma-from-luma -> IDCT8 (matmuls)
    -> frame assembly -> EPF/Gaborish stencils -> inverse XYB
    -> sRGB encode -> uint8

This is the device re-design of the reference decode loop
(``dec_group.cc:183`` DecodeGroupImpl + ``dec_transforms-inl.h:456``
TransformToPixels + the render pipeline stages): instead of per-group
fork-join over CPU threads, all groups of all frames in the batch are
one data-parallel program, and the image never visits the host between
stages.  Restricted to the high-volume serving shape (single-frame
444 DCT8 streams, e.g. every e<=4 encode); anything fancier falls back
to the general host path in ``vardct/frame_dec.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from libjxl_tpu.render.filters_jax import LfParams


class FrameRecon(NamedTuple):
    """Device inputs for one frame batch (leading axis = frames).

    Quantized AC coefficients travel SPARSE (values + flat indices):
    ~90% are zero at normal distances, so the h2d payload drops ~8x."""

    coeff_vals: object    # (N,) int16 nonzero quantized coefficients
    coeff_idx: object     # (N,) int32 flat indices into (K,3,yb,xb,64)
    dc: object            # (K, 3, yb, xb) f32 dequantized DC
    raw_quant: object     # (K, yb, xb) i32
    sharpness: object     # (K, yb, xb) i32
    x_cc: object          # (K, ty, tx) f32 CfL X ratios
    b_cc: object          # (K, ty, tx) f32 CfL B ratios
    inv_gs: object        # (K,) f32 quantizer inverse global scale
    dms: object           # (K, 3) f32 x/b qm-scale dequant multipliers
    table: object         # (3, 64) f32 DCT8 dequant table
    quant_scale: object   # (K,) f32 quantizer scale for EPF sigma
    intensity: object     # (K,) f32 intensity target


@functools.partial(
    __import__("jax").jit,
    static_argnames=("gab", "epf_iters", "h", "w", "maxval",
                     "K", "yb", "xb", "ty_n", "tx_n", "cap"))
def _decode_batch(blob, lfp: LfParams, gab: bool,
                  epf_iters: int, h: int, w: int, maxval: int,
                  K: int, yb: int, xb: int, ty_n: int, tx_n: int,
                  cap: int):
    import jax
    import jax.numpy as jnp

    from libjxl_tpu.render import filters as F
    from libjxl_tpu.render.filters_jax import _output_int
    from libjxl_tpu.vardct.dct import idct_matrix
    from libjxl_tpu.vardct.frame_dec import K_BIASES

    # the whole frame batch arrives as ONE flat int32 blob: one upload
    # instead of a dozen per-leaf ones; slicing + bitcasting on device
    # is free
    off = 0

    def take(n, dtype=None, shape=None):
        nonlocal off
        part = jax.lax.slice_in_dim(blob, off, off + n)
        off += n
        if dtype is not None and dtype != jnp.int32:
            part = jax.lax.bitcast_convert_type(part, dtype)
        return part.reshape(shape) if shape is not None else part

    fr = FrameRecon(
        coeff_vals=take(cap),
        coeff_idx=take(cap),
        dc=take(K * 3 * yb * xb, jnp.float32, (K, 3, yb, xb)),
        raw_quant=take(K * yb * xb, None, (K, yb, xb)),
        sharpness=take(K * yb * xb, None, (K, yb, xb)),
        x_cc=take(K * ty_n * tx_n, jnp.float32, (K, ty_n, tx_n)),
        b_cc=take(K * ty_n * tx_n, jnp.float32, (K, ty_n, tx_n)),
        inv_gs=take(K, jnp.float32),
        dms=take(K * 3, jnp.float32, (K, 3)),
        table=take(3 * 64, jnp.float32, (3, 64)),
        quant_scale=take(K, jnp.float32),
        intensity=take(K, jnp.float32),
    )
    # scatter the sparse coefficients (padding entries are (idx 0,
    # val 0): add-identity, so no masking needed)
    q = jnp.zeros(K * 3 * yb * xb * 64, jnp.float32).at[
        fr.coeff_idx].add(fr.coeff_vals.astype(jnp.float32)
                          ).reshape(K, 3, yb, xb, 64)
    # AdjustQuantBias (quantizer-inl.h:35-60)
    absq = jnp.abs(q)
    biased = q - K_BIASES[3] / jnp.where(q == 0, 1.0, q)
    biased = jnp.where(absq < 0.5, 0.0, biased)
    small = jnp.sign(q) * jnp.asarray(K_BIASES[:3], jnp.float32
                                      ).reshape(1, 3, 1, 1, 1)
    biased = jnp.where((absq > 0.5) & (absq < 1.5), small, biased)
    # dequant: table x qm-scale x per-block scalar
    tab = fr.table.reshape(1, 3, 1, 1, 64) * \
        fr.dms.reshape(K, 3, 1, 1, 1)
    sd = (fr.inv_gs.reshape(K, 1, 1) /
          fr.raw_quant.astype(jnp.float32)).reshape(K, 1, yb, xb, 1)
    dq = biased * tab * sd
    # chroma from luma per 64x64 tile (chroma_from_luma.h:28)
    ty = jnp.arange(yb) // 8
    tx = jnp.arange(xb) // 8
    xc = fr.x_cc[:, ty[:, None], tx[None, :]].reshape(K, 1, yb, xb, 1)
    bc = fr.b_cc[:, ty[:, None], tx[None, :]].reshape(K, 1, yb, xb, 1)
    y_ch = dq[:, 1:2]
    dq = jnp.concatenate([dq[:, 0:1] + xc * y_ch, y_ch,
                          dq[:, 2:3] + bc * y_ch], axis=1)
    # LLF slot <- DC; stored order is transposed for 8x8 (R >= C)
    stored = dq.at[..., 0].set(fr.dc)
    blocks = stored.reshape(K, 3, yb, xb, 8, 8).transpose(
        0, 1, 2, 3, 5, 4)
    im = jnp.asarray(idct_matrix(8), jnp.float32)
    pix = jnp.einsum("rk,KCyxkl,cl->KCyrxc", im, blocks, im,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    img = pix.reshape(K, 3, yb * 8, xb * 8)[:, :, :h, :w]

    def restore(xyb, raw_quant, sharp, scale):
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
        return xyb

    img = jax.vmap(restore)(img, fr.raw_quant, fr.sharpness,
                            fr.quant_scale)
    out = jax.vmap(lambda x, i: _output_int(x, i, maxval))(
        img, fr.intensity)
    return out.reshape(-1)      # flat d2h


def pack_frames_blob(inputs: list):
    """Pack a batch of FrameRecon pytrees into ONE flat int32 blob
    (float leaves bit-punned): one transfer instead of a dozen
    per-leaf ones. Returns (blob, (K, yb, xb, ty_n, tx_n, cap))."""
    K = len(inputs)
    yb, xb = inputs[0].dc.shape[1], inputs[0].dc.shape[2]
    ty_n, tx_n = inputs[0].x_cc.shape
    per_frame = 3 * yb * xb * 64
    vals = np.concatenate([f.coeff_vals for f in inputs])
    idx = np.concatenate([f.coeff_idx.astype(np.int64) + k * per_frame
                          for k, f in enumerate(inputs)])
    # pad the sparse run to a power-of-two bucket: one compiled program
    # per bucket instead of per batch
    cap = max(1024, 1 << int(np.ceil(np.log2(len(vals) or 1))))
    parts = [np.pad(vals.astype(np.int32), (0, cap - len(vals))),
             np.pad(idx, (0, cap - len(idx))).astype(np.int32)]
    for f in inputs:
        parts.append(f.dc.ravel().astype(np.float32).view(np.int32))
    for f in inputs:
        parts.append(f.raw_quant.ravel().astype(np.int32))
    for f in inputs:
        parts.append(f.sharpness.ravel().astype(np.int32))
    for f in inputs:
        parts.append(f.x_cc.ravel().astype(np.float32).view(np.int32))
    for f in inputs:
        parts.append(f.b_cc.ravel().astype(np.float32).view(np.int32))
    parts.append(np.asarray([f.inv_gs for f in inputs],
                            np.float32).view(np.int32))
    for f in inputs:
        parts.append(f.dms.ravel().astype(np.float32).view(np.int32))
    parts.append(inputs[0].table.ravel().astype(np.float32).view(np.int32))
    parts.append(np.asarray([f.quant_scale for f in inputs],
                            np.float32).view(np.int32))
    parts.append(np.asarray([f.intensity for f in inputs],
                            np.float32).view(np.int32))
    return np.concatenate(parts), (K, yb, xb, ty_n, tx_n, cap)


def decode_frames_device_blob(blob_dev, meta, lf, gab: bool,
                              epf_iters: int, h: int, w: int,
                              maxval: int = 255):
    """Run the batched decode program on an already-staged device blob
    (device-resident serving: the consumer keeps pixels in HBM)."""
    from libjxl_tpu.render.filters_jax import lf_params
    K, yb, xb, ty_n, tx_n, cap = meta
    return _decode_batch(blob_dev, lf_params(lf), bool(gab),
                         int(epf_iters), int(h), int(w), int(maxval),
                         K, yb, xb, ty_n, tx_n, cap)


def decode_frames_device(inputs: list, lf, gab: bool, epf_iters: int,
                         h: int, w: int, maxval: int = 255,
                         fetch: bool = True):
    """Run a batch of same-shape frames through the device program.

    ``inputs`` is a list of per-frame FrameRecon pytrees with numpy
    leaves (no leading K axis); they are stacked, shipped once, and
    decoded by a single compiled program."""
    import jax.numpy as jnp

    from libjxl_tpu.render.filters_jax import lf_params

    blob_np, meta = pack_frames_blob(inputs)
    K, yb, xb, ty_n, tx_n, cap = meta
    out = _decode_batch(jnp.asarray(blob_np), lf_params(lf), bool(gab),
                        int(epf_iters), int(h), int(w), int(maxval),
                        K, yb, xb, ty_n, tx_n, cap)
    if fetch:
        out = np.asarray(out).reshape(K, h, w, 3)
        return [out[i] for i in range(K)]
    # device-resident serving: stays FLAT (K*h*w*3 u8); the consumer
    # reshapes after its copy to the host
    return out


# ---- variable-block-size device reconstruction (round 3) ----------------
#
# e5+ streams carry merged transforms (DCT16/32/64 + rectangles) and the
# 8x8 specials. Ragged per-block work maps to the device as PER-CLASS
# BATCHES: every class is a fixed-shape (cap, 3, size) tensor whose
# dequant + CfL + LLF + IDCT are dense matmuls, scattered into the frame
# canvas by block coordinates. Padding blocks target a scratch frame.
# (dec_group.cc:156-181 / dec_transforms-inl.h:456 re-designed batched.)

_SPECIALS = (1, 2, 3, 12, 13, 14, 15, 16, 17)


def _class_geometry(s: int):
    from libjxl_tpu.vardct.ac_strategy import COVERED_X, COVERED_Y
    nby, nbx = COVERED_Y[s], COVERED_X[s]
    return nby, nbx, nby * nbx * 64


@functools.partial(
    __import__("jax").jit,
    static_argnames=("classes", "caps", "gab", "epf_iters",
                     "h", "w", "maxval", "K", "yb", "xb"))
def _decode_batch_var(class_data, dc, raw_quant, sharpness, x_cc, b_cc,
                      inv_gs, dms, quant_scale, intensity, lfp,
                      classes: tuple, caps: tuple, gab: bool,
                      epf_iters: int, h: int, w: int, maxval: int,
                      K: int, yb: int, xb: int):
    import jax
    import jax.numpy as jnp

    from libjxl_tpu.render import filters as F
    from libjxl_tpu.render.filters_jax import _output_int
    from libjxl_tpu.vardct.ac_strategy import COVERED_X, COVERED_Y
    from libjxl_tpu.vardct.dct import (
        dct_matrix, idct_matrix, resample_scales,
    )
    from libjxl_tpu.vardct.enc_transforms_small import inverse_matrix
    from libjxl_tpu.vardct.frame_dec import K_BIASES

    hp = jax.lax.Precision.HIGHEST
    # scratch frame K absorbs padding-block scatters
    img = jnp.zeros((K + 1, 3, yb * 8, xb * 8), jnp.float32)
    dc_p = jnp.pad(dc, ((0, 1), (0, 0), (0, 0), (0, 0)))
    iv_p = jnp.pad(inv_gs, (0, 1), constant_values=1.0)
    dm_p = jnp.pad(dms, ((0, 1), (0, 0)), constant_values=1.0)
    xcc_p = jnp.pad(x_cc, ((0, 1), (0, 0), (0, 0)))
    bcc_p = jnp.pad(b_cc, ((0, 1), (0, 0), (0, 0)))

    def bias(q, c):
        absq = jnp.abs(q)
        out = q - K_BIASES[3] / jnp.where(q == 0, 1.0, q)
        out = jnp.where(absq < 0.5, 0.0, out)
        return jnp.where((absq > 0.5) & (absq < 1.5),
                         jnp.sign(q) * K_BIASES[c], out)

    from libjxl_tpu.vardct.quant_weights import DequantMatrices
    mats = DequantMatrices()
    for ci, s in enumerate(classes):
        q, qf, fy, fx, fi = class_data[ci]
        nby, nbx = COVERED_Y[s], COVERED_X[s]
        size = nby * nbx * 64
        qf32 = q.astype(jnp.float32)
        dq = jnp.stack([bias(qf32[:, c], c) for c in range(3)], axis=1)
        tab = jnp.asarray(
            mats.table_for_strategy(s).reshape(3, -1), jnp.float32)
        dq = dq * (tab[None] * dm_p[fi][:, :, None]) * \
            (iv_p[fi] / qf.astype(jnp.float32))[:, None, None]
        xc = xcc_p[fi, fy // 8, fx // 8]
        bc = bcc_p[fi, fy // 8, fx // 8]
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
            dcb = dc_p[fi[:, None, None, None],
                       jnp.arange(3)[None, :, None, None],
                       (fy[:, None, None] + ay[None, :, None])[:, None],
                       (fx[:, None, None] + ax[None, None, :])[:, None]]
            dmy = jnp.asarray(dct_matrix(nby), jnp.float32)
            dmx = jnp.asarray(dct_matrix(nbx), jnp.float32)
            llf = jnp.einsum("uy,ncyx,vx->ncuv", dmy, dcb, dmx,
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

    img = img[:K, :, :h, :w]

    def restore(xyb, rq, shp, scale):
        if gab:
            xyb = F.gaborish(xyb, lfp, xp=jnp)
        if epf_iters > 0:
            inv_sigma = F.compute_sigma(lfp, None, None, rq, shp,
                                        scale, xp=jnp)
            if epf_iters >= 3:
                xyb = F.epf_step0(xyb, inv_sigma, lfp, xp=jnp)
            xyb = F.epf_step1(xyb, inv_sigma, lfp, xp=jnp)
            if epf_iters >= 2:
                xyb = F.epf_step2(xyb, inv_sigma, lfp, xp=jnp)
        return xyb

    img = jax.vmap(restore)(img, raw_quant, sharpness, quant_scale)
    out = jax.vmap(lambda x, i: _output_int(x, i, maxval))(img, intensity)
    return out.reshape(-1)


def decode_frames_device_var(inputs: list, lf, gab: bool, epf_iters: int,
                             h: int, w: int, maxval: int = 255,
                             fetch: bool = True):
    """Batched var-block device reconstruction.

    ``inputs``: per-frame dicts with keys ``classes`` ({strategy:
    (q (n,3,size) i32, qf (n,) i32, fy (n,) i32, fx (n,) i32)}),
    ``dc`` (3, yb, xb) f32, ``raw_quant``/``sharpness`` (yb, xb) i32,
    ``x_cc``/``b_cc`` (ty, tx) f32 ratio maps, ``inv_gs``, ``dms`` (3,),
    ``quant_scale``, ``intensity`` scalars."""
    import jax.numpy as jnp

    from libjxl_tpu.render.filters_jax import lf_params

    K = len(inputs)
    yb, xb = inputs[0]["dc"].shape[1:]
    all_classes = sorted({s for f in inputs for s in f["classes"]})
    class_data = []
    caps = []
    for s in all_classes:
        qs, qfs, fys, fxs, fis = [], [], [], [], []
        for k, f in enumerate(inputs):
            if s not in f["classes"]:
                continue
            q, qf, fy, fx = f["classes"][s]
            qs.append(q)
            qfs.append(qf)
            fys.append(fy)
            fxs.append(fx)
            fis.append(np.full(len(qf), k, np.int32))
        q = np.concatenate(qs)
        n = len(q)
        cap = max(64, 1 << int(np.ceil(np.log2(max(n, 1)))))
        _, _, size = _class_geometry(s)
        pad = cap - n

        def cat_pad(parts, fill=0):
            a = np.concatenate(parts)
            return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1),
                          constant_values=fill)

        class_data.append((
            jnp.asarray(cat_pad(qs)),
            jnp.asarray(cat_pad(qfs, fill=1).astype(np.int32)),
            jnp.asarray(cat_pad(fys).astype(np.int32)),
            jnp.asarray(cat_pad(fxs).astype(np.int32)),
            jnp.asarray(np.pad(np.concatenate(fis), (0, pad),
                               constant_values=K)),
        ))
        caps.append(cap)
    out = _decode_batch_var(
        tuple(class_data),
        jnp.asarray(np.stack([f["dc"] for f in inputs])),
        jnp.asarray(np.stack([f["raw_quant"] for f in inputs])),
        jnp.asarray(np.stack([f["sharpness"] for f in inputs])),
        jnp.asarray(np.stack([f["x_cc"] for f in inputs])),
        jnp.asarray(np.stack([f["b_cc"] for f in inputs])),
        jnp.asarray(np.asarray([f["inv_gs"] for f in inputs],
                               np.float32)),
        jnp.asarray(np.stack([f["dms"] for f in inputs])),
        jnp.asarray(np.asarray([f["quant_scale"] for f in inputs],
                               np.float32)),
        jnp.asarray(np.asarray([f["intensity"] for f in inputs],
                               np.float32)),
        lf_params(lf), tuple(all_classes), tuple(caps), bool(gab),
        int(epf_iters), int(h), int(w), int(maxval), K, yb, xb)
    if fetch:
        arr = np.asarray(out).reshape(K, h, w, 3)
        return [arr[i] for i in range(K)]
    return out

"""Device-side variable-block forward transform + quantization for the
e5+/e7 encode path (SURVEY §7: keep everything pixel-shaped on device).

One fused XLA program computes, from the on-device padded XYB plane:
  * the whole-frame DCT8 Y quantization + roundtrip and the per-64x64
    chroma-from-luma least squares (the same math as
    ``models/vardct_pipeline._frame_body``; enc_chroma_from_luma.cc),
  * per-ACS-class forward DCTs (einsums over aligned whole-frame
    grids, the layout of ``models/vardct_heuristics.acs_grids_device``),
  * anchor gathers + dead-zone quantization of all three channels with
    the CfL factors unapplied (enc_group.cc:329-360 semantics,
    mirroring ``vardct/enc_acs.transform_all`` + ``finish_chroma``),
  * the DC grid from each block's lowest frequencies
    (DCFromLowestFrequencies).

The host fetches int16 quantized coefficients (~2 bytes/coeff) instead
of the f32 XYB plane, and the butteraugli loop receives DEVICE handles
for the raw per-class coefficient batches — its ~9 MB h2d staging
disappears. Float32 device math vs the host's float64 can move a
rounding boundary on rare coefficients: streams differ from the host
path by the occasional +-1 quantized value (both valid; quality
verified by tests/test_vardct_encoder.py::test_device_transform_*).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from libjxl_tpu.vardct.ac_strategy import COVERED_X, COVERED_Y

_SPECIALS = (1, 2, 3, 12, 13, 14, 15, 16, 17)
_COLOR_SCALE = 1.0 / 84.0


def class_cap(n: int, cov: int) -> int:
    """Shared jit-stable capacity bucket (same policy as
    models/vardct_loop.LoopState)."""
    min_cap = max(16, 2048 // cov)
    return max(min_cap, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _bias_dev(q, c):
    from libjxl_tpu.vardct.frame_dec import K_BIASES
    absq = jnp.abs(q)
    out = q - K_BIASES[3] / jnp.where(q == 0, 1.0, q)
    out = jnp.where(absq < 0.5, 0.0, out)
    return jnp.where((absq > 0.5) & (absq < 1.5),
                     jnp.sign(q) * K_BIASES[c], out)


@functools.partial(jax.jit, static_argnames=(
    "classes", "caps", "yb", "xb", "x_qm_mul"))
def _tq_jit(xyb, rq, by0s, bx0s, scale, inv_gs, tables, th_ys, th_xbs,
            classes: tuple, caps: tuple, yb: int, xb: int,
            x_qm_mul: float):
    """Returns (ytox, ytob, dc_float, [per class: (raw (cap,3,size) f32,
    q (cap,3,size) i16, dc (cap,3,nby,nbx) f32)])."""
    from libjxl_tpu.vardct.dct import (
        dct_matrix, idct_matrix, resample_scales,
    )
    from libjxl_tpu.vardct.enc_transforms_small import forward_matrix

    hp = jax.lax.Precision.HIGHEST
    rq_f = rq.astype(jnp.float32)

    # ---- whole-frame DCT8 -> Y quantize/roundtrip -> CfL LS (the
    # exact _frame_body fragment; host mirror frame_enc.py:612-645) ---
    blocks8 = xyb.reshape(3, yb, 8, xb, 8).transpose(1, 3, 0, 2, 4)
    m8 = jnp.asarray(dct_matrix(8), jnp.float32)
    coef8 = jnp.einsum("ux,ybcxz,vz->ybcuv", m8, blocks8, m8,
                       precision=hp)
    stored8 = coef8.transpose(0, 1, 2, 4, 3).reshape(yb, xb, 3, 64)
    tab8 = tables[0]                      # DCT8 (3, 64) f32
    th8_y = th_ys[0]
    qac8 = scale * rq_f
    val_y = stored8[:, :, 1] * ((1.0 / tab8[1])[None, None] *
                                qac8[:, :, None])
    q_y8 = jnp.where(jnp.abs(val_y) >= th8_y[None, None],
                     jnp.round(val_y), 0.0)
    y_rt8 = _bias_dev(q_y8, 1) * (tab8[1][None, None] *
                                  (inv_gs / rq_f)[:, :, None])
    ty_n = -(-yb // 8)
    tx_n = -(-xb // 8)
    pad_y, pad_x = ty_n * 8 - yb, tx_n * 8 - xb

    def tiled(a):
        a = jnp.pad(a, ((0, pad_y), (0, pad_x), (0, 0)))
        return a.reshape(ty_n, 8, tx_n, 8, 63)

    yt = tiled(y_rt8[:, :, 1:])
    xt = tiled(stored8[:, :, 0, 1:])
    bt = tiled(stored8[:, :, 2, 1:])
    denom = jnp.einsum("tyxzk,tyxzk->tx", yt, yt, precision=hp)
    dx = jnp.einsum("tyxzk,tyxzk->tx", xt, yt, precision=hp)
    db = jnp.einsum("tyxzk,tyxzk->tx", bt, yt, precision=hp)
    ok = denom >= 1e-9
    dsafe = jnp.where(ok, denom, 1.0)
    ytox = jnp.where(ok, jnp.clip(jnp.round(
        dx / dsafe / _COLOR_SCALE), -128, 127), 0).astype(jnp.int32)
    ytob = jnp.where(ok, jnp.clip(jnp.round(
        (db / dsafe - 1.0) / _COLOR_SCALE), -128, 127),
        0).astype(jnp.int32)
    fx_t = ytox.astype(jnp.float32) * _COLOR_SCALE
    fb_t = 1.0 + ytob.astype(jnp.float32) * _COLOR_SCALE

    out_classes = []
    for ci, s in enumerate(classes):
        nby, nbx = int(COVERED_Y[s]), int(COVERED_X[s])
        rows, cols = nby * 8, nbx * 8
        size = nby * nbx * 64
        gy, gx = yb // nby, xb // nbx
        tab = tables[ci + 1]              # (3, size) f32
        th_y = th_ys[ci + 1]
        th_xb = th_xbs[ci + 1]
        by0 = by0s[ci]
        bx0 = bx0s[ci]

        def windows(plane):
            return plane[:gy * rows, :gx * cols].reshape(
                gy, rows, gx, cols).transpose(0, 2, 1, 3).reshape(
                gy * gx, rows, cols)

        if s in _SPECIALS:
            F = jnp.asarray(forward_matrix(s), jnp.float32)
            stored = jnp.stack([
                jnp.einsum("np,sp->ns",
                           windows(xyb[c]).reshape(gy * gx, 64), F,
                           precision=hp)
                for c in range(3)], axis=1)      # (gy*gx, 3, 64)
        else:
            mr = jnp.asarray(dct_matrix(rows), jnp.float32)
            mc = jnp.asarray(dct_matrix(cols), jnp.float32)
            parts = []
            for c in range(3):
                rc = jnp.einsum("ur,nrc,vc->nuv", mr, windows(xyb[c]),
                                mc, precision=hp)
                st = jnp.swapaxes(rc, 1, 2) if rows >= cols else rc
                parts.append(st.reshape(gy * gx, size))
            stored = jnp.stack(parts, axis=1)     # (gy*gx, 3, size)

        # anchor gather (padded indices point at grid cell 0, masked
        # out host-side via the real count)
        gi = (by0 // nby) * gx + (bx0 // nbx)
        raw = stored[gi]                          # (cap, 3, size)
        qf_c = jnp.maximum(rq_f[by0, bx0], 1.0)
        qac = scale * qf_c
        ith = 1.0 / tab
        vy = raw[:, 1] * (ith[1][None] * qac[:, None])
        q_yc = jnp.where(jnp.abs(vy) >= th_y[None], jnp.round(vy), 0.0)
        y_rt = _bias_dev(q_yc, 1) * tab[1][None] * \
            (inv_gs / qf_c)[:, None]
        fxc = fx_t[by0 // 8, bx0 // 8]
        fbc = fb_t[by0 // 8, bx0 // 8]
        vx = (raw[:, 0] - fxc[:, None] * y_rt) * \
            (ith[0][None] * (qac * x_qm_mul)[:, None])
        vb = (raw[:, 2] - fbc[:, None] * y_rt) * \
            (ith[2][None] * qac[:, None])
        q_x = jnp.where(jnp.abs(vx) >= th_xb[None], jnp.round(vx), 0.0)
        q_b = jnp.where(jnp.abs(vb) >= th_xb[None], jnp.round(vb), 0.0)
        q = jnp.stack([q_x, q_yc, q_b], axis=1)
        q = jnp.clip(q, -32767, 32767).astype(jnp.int16)

        # per-anchor DC block from the pre-CfL lowest frequencies
        # (DCFromLowestFrequencies; host mirror enc_acs.transform_all)
        if s in _SPECIALS:
            dcb = raw[:, :, 0:1].reshape(-1, 3, 1, 1)    # (cap, 3, 1, 1)
        else:
            mn, mx = min(nby, nbx), max(nby, nbx)
            llf_st = raw.reshape(-1, 3, mn * 8, mx * 8)[:, :, :mn, :mx]
            llf = jnp.swapaxes(llf_st, 2, 3) if nby >= nbx else llf_st
            sy = jnp.asarray(1.0 / resample_scales(nby), jnp.float32)
            sx = jnp.asarray(1.0 / resample_scales(nbx), jnp.float32)
            imy = jnp.asarray(idct_matrix(nby), jnp.float32)
            imx = jnp.asarray(idct_matrix(nbx), jnp.float32)
            ll = llf / sy[None, None, :, None] / sx[None, None, None, :]
            dcb = jnp.einsum("yu,ncuv,xv->ncyx", imy, ll, imx,
                             precision=hp)       # (cap, 3, nby, nbx)
        out_classes.append((raw, q, dcb))
    q_flat = jnp.concatenate([oc[1].reshape(-1) for oc in out_classes])
    dc_flat = jnp.concatenate([oc[2].reshape(-1) for oc in out_classes])
    raws = tuple(oc[0] for oc in out_classes)
    return ytox, ytob, q_flat, dc_flat, raws


def transform_quantize_device(xyb_dev, acs: np.ndarray,
                              anchors: np.ndarray, raw_quant: np.ndarray,
                              matrices, quantizer, x_qm_mul: float):
    """Run the fused transform+quantize program for the frame's ACS
    layout. Returns a dict:
      blocks_q: {(by, bx): {"q": (3, size) int32 view}} for the host
        tokenizer (same "q" contract as transform_all+finish_chroma)
      dc_float: (3, yb, xb) float64 grid (anchor cells filled)
      ytox, ytob: (ty, tx) int32 CfL maps
      dev_cache: LoopState-ready per-class device data
        {s: (coefs (cap,3,size) f32 DEVICE, by0 (cap,) i32 DEVICE,
             bx0 (cap,) i32 DEVICE, fi (cap,) i32 DEVICE, n)}
        plus "dc_float": DEVICE (3, yb, xb) f32.
    """
    from libjxl_tpu.vardct.enc_acs import _thresholds

    yb, xb = acs.shape
    # FIXED class list: `classes`/caps are static jit args, and the
    # butteraugli-loop program shares this class layout — per-image
    # class sets would recompile both programs per image (the
    # models/vardct_loop stability fix)
    present = {int(s) for s in np.unique(acs[anchors])}
    fixed = [0, 1, 2, 3, 4, 5, 6, 7, 10, 11, 12, 13, 14, 15, 16, 17,
             18, 19, 20]
    classes = []
    caps = []
    by0s = []
    bx0s = []
    ns = []
    hosts = []
    for s in fixed:
        nby, nbx = int(COVERED_Y[s]), int(COVERED_X[s])
        if s in present:
            by0, bx0 = np.nonzero(anchors & (acs == s))
        else:
            by0 = bx0 = np.zeros(0, np.int64)
        n = len(by0)
        cap = class_cap(n, nby * nbx)
        pad = cap - n
        by0p = np.pad(by0.astype(np.int32), (0, pad))
        bx0p = np.pad(bx0.astype(np.int32), (0, pad))
        classes.append(s)
        caps.append(cap)
        ns.append(n)
        hosts.append((by0, bx0))
        by0s.append(jnp.asarray(by0p))
        bx0s.append(jnp.asarray(bx0p))
    tables = [jnp.asarray(
        matrices.tables[0].reshape(3, 64), jnp.float32)]
    th_ys = [jnp.asarray(_thresholds(1, 1, True), jnp.float32)]
    th_xbs = [jnp.asarray(_thresholds(1, 1, False), jnp.float32)]
    for s in classes:
        nby, nbx = int(COVERED_Y[s]), int(COVERED_X[s])
        tables.append(jnp.asarray(
            matrices.table_for_strategy(s).reshape(3, -1), jnp.float32))
        th_ys.append(jnp.asarray(_thresholds(nby, nbx, True),
                                 jnp.float32))
        th_xbs.append(jnp.asarray(_thresholds(nby, nbx, False),
                                  jnp.float32))
    ytox_d, ytob_d, q_flat_d, dc_flat_d, raws = _tq_jit(
        xyb_dev, jnp.asarray(raw_quant.astype(np.int32)),
        tuple(by0s), tuple(bx0s),
        jnp.float32(quantizer.scale),
        jnp.float32(quantizer.inv_global_scale),
        tuple(tables), tuple(th_ys), tuple(th_xbs),
        classes=tuple(classes), caps=tuple(caps), yb=yb, xb=xb,
        x_qm_mul=float(x_qm_mul))

    # TWO consolidated fetches (q + dc) instead of one per class
    ytox = np.asarray(ytox_d)
    ytob = np.asarray(ytob_d)
    q_all = np.asarray(q_flat_d)
    dc_all = np.asarray(dc_flat_d)
    blocks_q = {}
    dc_float = np.zeros((3, yb, xb), np.float64)
    dev_cache: dict = {}
    q_off = dc_off = 0
    for ci, s in enumerate(classes):
        n = ns[ci]
        by0, bx0 = hosts[ci]
        nby, nbx = int(COVERED_Y[s]), int(COVERED_X[s])
        size = nby * nbx * 64
        cap = caps[ci]
        q_np = q_all[q_off:q_off + cap * 3 * size].reshape(
            cap, 3, size)[:n].astype(np.int32)
        dc_np = dc_all[dc_off:dc_off + cap * 3 * nby * nbx].reshape(
            cap, 3, nby, nbx)[:n].astype(np.float64)
        q_off += cap * 3 * size
        dc_off += cap * 3 * nby * nbx
        fi = np.pad(np.zeros(n, np.int32), (0, cap - n),
                    constant_values=1)
        dev_cache[s] = (raws[ci], by0s[ci], bx0s[ci], jnp.asarray(fi), n)
        if n == 0:
            continue
        if nby == 1 and nbx == 1:
            dc_float[:, by0, bx0] = dc_np[:, :, 0, 0].T
        else:
            for i in range(n):
                by, bx = int(by0[i]), int(bx0[i])
                dc_float[:, by:by + nby, bx:bx + nbx] = dc_np[i]
        for i in range(n):
            blocks_q[(int(by0[i]), int(bx0[i]))] = {
                "q": q_np[i], "strategy": s, "covered": nby * nbx,
                "nby": nby, "nbx": nbx}
    return dict(blocks_q=blocks_q, dc_float=dc_float, ytox=ytox,
                ytob=ytob, dev_cache=dev_cache)

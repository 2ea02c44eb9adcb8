"""Device-side VarDCT encode heuristics for effort >= 5 (the round-3
lift of the e<=4 device gate, VERDICT r2 item 3).

Two fused XLA programs:

1. ``front_device``: sRGB -> XYB (pre-gaborish, padded to the block
   grid), the adaptive quantization field (InitialQuantField,
   enc_adaptive_quantization.cc — the xp-generic math of
   vardct/adaptive_quant.py run under jnp), and the gaborish-inverse
   sharpened encoder input. One dispatch; the host fetches the small
   (yb, xb) field, derives the integer global scale (exact host int
   semantics), and keeps the sharpened image for the transform stage.

2. ``acs_grids_device``: the AC-strategy cost grids — for every
   candidate transform class, a batched whole-frame DCT (matmuls
   over all aligned positions at once, the device analog of
   enc_ac_strategy.cc:618's per-tile loop), dead-zone quantization,
   rate estimate and weighted distortion, reduced to one cost per
   aligned position. The host runs only the (cheap, sequential) merge
   decisions on the fetched grids.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from libjxl_tpu.vardct.ac_strategy import COVERED_X, COVERED_Y
from libjxl_tpu.vardct.dct import dct_matrix


@functools.partial(jax.jit, static_argnames=("distance", "use_gab",
                                             "h", "w", "yb", "xb"))
def front_device(pixels_u8, distance: float, use_gab: bool,
                 h: int, w: int, yb: int, xb: int):
    """(h, w, 3) u8 sRGB -> (qf (yb, xb) f32, xyb_p (3, yb*8, xb*8) f32,
    xyb_pre_gab padded)."""
    from libjxl_tpu.models.vardct_pipeline import (
        _BIAS, _NEG_BIAS_CBRT, _OPSIN,
    )
    from libjxl_tpu.render.filters import gaborish_inverse
    from libjxl_tpu.vardct.adaptive_quant import adaptive_quant_field

    hp = jax.lax.Precision.HIGHEST
    srgb = jnp.moveaxis(pixels_u8.astype(jnp.float32), -1, 0) / 255.0
    linear = jnp.where(srgb <= 0.04045, srgb / 12.92,
                       ((srgb + 0.055) / 1.055) ** 2.4)
    mixed = jnp.einsum("ij,jhw->ihw", jnp.asarray(_OPSIN, jnp.float32),
                       linear, precision=hp) + _BIAS
    g = jnp.cbrt(jnp.maximum(mixed, 1e-12)) + _NEG_BIAS_CBRT
    xyb = jnp.stack([0.5 * (g[0] - g[1]), 0.5 * (g[0] + g[1]), g[2]])
    pre_gab = jnp.pad(xyb, ((0, 0), (0, yb * 8 - h), (0, xb * 8 - w)),
                      mode="edge")
    qf, _ = adaptive_quant_field(
        pre_gab, distance if use_gab else distance * 0.62, xp=jnp)
    if use_gab:
        xyb = gaborish_inverse(xyb, xp=jnp)
    xyb_p = jnp.pad(xyb, ((0, 0), (0, yb * 8 - h), (0, xb * 8 - w)),
                    mode="edge")
    return qf, xyb_p, pre_gab




@functools.partial(jax.jit, static_argnames=("strategies", "scale",
                                             "distance"))
def _grids_jit(xyb, raw_quant, tables, strategies: tuple,
               scale: float, distance: float):
    from libjxl_tpu.vardct.enc_acs import (
        compute_mask1x1, strategy_rate_loss,
    )

    mask1x1 = compute_mask1x1(xyb[1], xp=jnp)
    out = []
    for i, s in enumerate(strategies):
        out.append(strategy_rate_loss(
            xyb, raw_quant, tables[i], scale, int(s), mask1x1,
            distance, xp=jnp))
    # ONE flat payload instead of 2*len(strategies) separate fetches;
    # the grids are tiny (< 200 KB total)
    return jnp.concatenate([g.reshape(-1)
                            for pair in out for g in pair])


def acs_grids_device(xyb_dev, raw_quant: np.ndarray, matrices,
                     quantizer, distance: float,
                     strategies: tuple) -> dict:
    """Compute the per-strategy (rate, loss) grids on device; returns
    {strategy: (rate, loss) np grids} for choose_acs's merge pass
    (same xp-generic 3-channel cost as the host:
    enc_acs.strategy_rate_loss). All grids ride ONE d2h payload."""
    tables = tuple(
        tuple(jnp.asarray(matrices.table_for_strategy(s)[c].reshape(-1),
                          jnp.float32) for c in range(3))
        for s in strategies)
    flat = np.asarray(_grids_jit(
        xyb_dev, jnp.asarray(raw_quant), tables,
        tuple(int(s) for s in strategies),
        float(quantizer.scale), float(distance)), np.float64)
    yb8, xb8 = raw_quant.shape
    out = {}
    off = 0
    for s in strategies:
        gy = yb8 // COVERED_Y[s]
        gx = xb8 // COVERED_X[s]
        n = gy * gx
        rate = flat[off:off + n].reshape(gy, gx)
        loss = flat[off + n:off + 2 * n].reshape(gy, gx)
        off += 2 * n
        out[int(s)] = (rate, loss)
    return out

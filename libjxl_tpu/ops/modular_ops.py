"""Device-side (JAX/XLA) kernels for the Modular integer path.

All ops are shape-static, integer-exact (int32) and group-parallel: arrays
are laid out as ``(groups, channels, gd, gd)`` so the group axis can be
sharded over a device mesh (the reference's parallel axis, SURVEY.md §2.2).

The sequential rANS bit emission stays on the host; the device produces
residual tokens and per-context histograms (the FLOP- and bandwidth-heavy
part of lossless encode: RCT, prediction, tokenization, histogramming).
Reference semantics: ``lib/jxl/modular/transform/rct.cc`` (forward),
``lib/jxl/modular/encoding/context_predict.h:385-398`` (ClampedGradient),
``lib/jxl/pack_signed.h``, ``lib/jxl/dec_ans.h:69-103`` (hybrid uint).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def fwd_ycocg(rgb: jnp.ndarray) -> jnp.ndarray:
    """Forward YCoCg RCT; channels-first (..., 3, h, w) int32."""
    r = rgb[..., 0, :, :]
    g = rgb[..., 1, :, :]
    b = rgb[..., 2, :, :]
    co = r - b
    tmp = b + (co >> 1)
    cg = g - tmp
    y = tmp + (cg >> 1)
    return jnp.stack([y, co, cg], axis=-3)


def inv_ycocg(ycc: jnp.ndarray) -> jnp.ndarray:
    y = ycc[..., 0, :, :]
    co = ycc[..., 1, :, :]
    cg = ycc[..., 2, :, :]
    tmp = y - (cg >> 1)
    g = cg + tmp
    b = tmp - (co >> 1)
    r = b + co
    return jnp.stack([r, g, b], axis=-3)


def clamped_gradient(n: jnp.ndarray, w: jnp.ndarray, l: jnp.ndarray
                     ) -> jnp.ndarray:
    m = jnp.minimum(n, w)
    M = jnp.maximum(n, w)
    grad = n + w - l
    return jnp.where(l < m, M, jnp.where(l > M, m, grad))


def gradient_residuals(plane: jnp.ndarray) -> jnp.ndarray:
    """Residuals v - ClampedGradient(N, W, NW) with the modular edge rules
    (W at x=0 is N; N at y=0 is W; NW falls back to W). plane: (..., h, w)."""
    w_n = jnp.pad(plane[..., :, :-1], [(0, 0)] * (plane.ndim - 1) + [(1, 0)])
    # x=0: left = (y>0 ? N : 0)
    n_full = jnp.pad(plane[..., :-1, :], [(0, 0)] * (plane.ndim - 2) +
                     [(1, 0), (0, 0)])
    left = w_n.at[..., :, 0].set(n_full[..., :, 0])
    top = n_full
    # y=0: top = left
    top = top.at[..., 0, :].set(left[..., 0, :])
    nw = jnp.pad(plane[..., :-1, :-1], [(0, 0)] * (plane.ndim - 2) +
                 [(1, 0), (1, 0)])
    # x=0 or y=0: topleft = left
    nw = nw.at[..., :, 0].set(left[..., :, 0])
    nw = nw.at[..., 0, :].set(left[..., 0, :])
    guess = clamped_gradient(top, left, nw)
    return plane - guess


def pack_signed(v: jnp.ndarray) -> jnp.ndarray:
    """X>=0 -> 2X ; -X -> 2X-1 (uint token)."""
    return jnp.where(v >= 0, v * 2, -v * 2 - 1).astype(jnp.uint32)


def floor_log2(v: jnp.ndarray) -> jnp.ndarray:
    """Floor log2 of uint32 (0 -> 0)."""
    v = v.astype(jnp.uint32)
    n = jnp.zeros(v.shape, jnp.int32)
    x = v
    for shift in (16, 8, 4, 2, 1):
        m = x >= (1 << shift)
        n = jnp.where(m, n + shift, n)
        x = jnp.where(m, x >> shift, x)
    return n


def hybrid_uint_tokenize(values: jnp.ndarray, split_exponent: int = 4,
                         msb_in_token: int = 2, lsb_in_token: int = 0):
    """Vectorized hybrid-uint encoding -> (token, nbits, bits)."""
    values = values.astype(jnp.uint32)
    split_token = 1 << split_exponent
    small = values < split_token
    n = floor_log2(jnp.maximum(values, 1))
    mant = values - (jnp.uint32(1) << n.astype(jnp.uint32))
    tok_big = (split_token +
               ((n - split_exponent) << (msb_in_token + lsb_in_token)) +
               ((mant >> jnp.maximum(n - msb_in_token, 0).astype(jnp.uint32))
                << lsb_in_token).astype(jnp.int32) +
               (mant & ((1 << lsb_in_token) - 1)).astype(jnp.int32))
    nbits_big = n - msb_in_token - lsb_in_token
    bits_big = (values >> jnp.uint32(lsb_in_token)) & \
        ((jnp.uint32(1) << jnp.clip(nbits_big, 0, 31).astype(jnp.uint32)) -
         jnp.uint32(1))
    token = jnp.where(small, values.astype(jnp.int32), tok_big)
    nbits = jnp.where(small, 0, nbits_big)
    bits = jnp.where(small, jnp.uint32(0), bits_big)
    return token, nbits, bits


def token_histogram(tokens: jnp.ndarray, mask: jnp.ndarray,
                    alphabet_size: int = 256,
                    chunk: int = 1 << 16) -> jnp.ndarray:
    """Masked histogram of token values.

    Compare-and-reduce over fixed-size chunks: each chunk builds a
    (chunk, alphabet) compare and reduces it, so no two lanes update one
    bin (a scatter-add puts most of the skewed token mass on a few bins'
    atomics, and a full one-hot does not fit in memory)."""
    flat = jnp.clip(tokens, 0, alphabet_size - 1).reshape(-1)
    weights = mask.reshape(-1).astype(jnp.int32)
    n = flat.shape[0]
    pad = (-n) % chunk
    flat = jnp.pad(flat, (0, pad))
    weights = jnp.pad(weights, (0, pad))
    flat = flat.reshape(-1, chunk)
    weights = weights.reshape(-1, chunk)
    ids = jnp.arange(alphabet_size, dtype=flat.dtype)

    def body(acc, xs):
        t, m = xs
        eq = (t[:, None] == ids[None, :]).astype(jnp.int32) * m[:, None]
        return acc + eq.sum(axis=0), None

    hist, _ = jax.lax.scan(body, jnp.zeros(alphabet_size, jnp.int32),
                           (flat, weights))
    return hist


def image_to_groups(img: jnp.ndarray, group_dim: int):
    """(C, H, W) -> (G, C, gd, gd) padded groups + validity mask.

    Padding replicates the edge pixel so padded residuals are zero-heavy;
    masks mark real pixels for histogram/token selection."""
    c, h, w = img.shape
    gy = -(-h // group_dim)
    gx = -(-w // group_dim)
    ph, pw = gy * group_dim, gx * group_dim
    img_p = jnp.pad(img, ((0, 0), (0, ph - h), (0, pw - w)), mode="edge")
    groups = img_p.reshape(c, gy, group_dim, gx, group_dim)
    groups = groups.transpose(1, 3, 0, 2, 4).reshape(
        gy * gx, c, group_dim, group_dim)
    yy = jnp.arange(ph).reshape(gy, group_dim)
    xx = jnp.arange(pw).reshape(gx, group_dim)
    mask = (yy[:, None, :, None] < h) & (xx[None, :, None, :] < w)
    mask = mask.reshape(gy * gx, 1, group_dim, group_dim)
    return groups, mask


def groups_to_image(groups: jnp.ndarray, h: int, w: int, group_dim: int
                    ) -> jnp.ndarray:
    """Inverse of image_to_groups (crops padding)."""
    g, c, gd, _ = groups.shape
    gy = -(-h // group_dim)
    gx = -(-w // group_dim)
    img = groups.reshape(gy, gx, c, gd, gd).transpose(2, 0, 3, 1, 4)
    img = img.reshape(c, gy * gd, gx * gd)
    return img[:, :h, :w]

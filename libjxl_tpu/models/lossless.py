"""Device pipeline: Modular lossless encode, group-parallel.

The device computes everything pixel-shaped — RCT, prediction residuals,
zigzag packing, token histograms — in one fused XLA program over a
``(groups, channels, gd, gd)`` layout; the host only runs hybrid-uint
bit-splitting (vectorized numpy), the sequential rANS emission and byte
assembly (SURVEY.md §7 design stance).

Transfer discipline: the host->device payload is the raw uint8/uint16
pixels; the device->host payload is one packed-residual plane (uint16 for
8-bit inputs) plus a 256-entry histogram — ~2 bytes/pixel each way (the
prefix-device mode instead returns the entropy-coded stream itself).

Multi-chip: shard the leading group axis with ``NamedSharding`` (see
``libjxl_tpu.parallel.mesh``); the histogram is the cross-shard psum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from libjxl_tpu.ops.modular_ops import (
    fwd_ycocg, gradient_residuals, image_to_groups, pack_signed,
    token_histogram,
)


@functools.partial(jax.jit, static_argnames=("gx", "use_rct", "out16",
                                             "emit_planes"))
def encode_groups_device(groups: jnp.ndarray, h, w, gx: int = 1,
                         use_rct: bool = True, out16: bool = True,
                         emit_planes: bool = True):
    """Device side of lossless encode.

    groups: (G, C, gd, gd) integer (any int dtype); ``h``/``w`` are the
    true image extents (the valid-pixel mask is built on device — no
    boolean upload), ``gx`` the group-grid width. Returns
    (payload, packed_wide): one concatenated uint8 d2h payload (clamped
    residual planes + per-group max + histogram, one transfer instead of
    three) and the full-width residuals (fetched per group only when the
    group max says uint8 clipped).
    """
    groups = groups.astype(jnp.int32)
    ng, _, gd, _ = groups.shape
    row0 = (jnp.arange(ng) // gx) * gd
    col0 = (jnp.arange(ng) % gx) * gd
    ymask = row0[:, None] + jnp.arange(gd)[None, :] < h     # (G, gd)
    xmask = col0[:, None] + jnp.arange(gd)[None, :] < w
    mask = ymask[:, None, :, None] & xmask[:, None, None, :]
    if use_rct and groups.shape[1] >= 3:
        rgb = groups[:, :3]
        rest = groups[:, 3:]
        groups = jnp.concatenate([fwd_ycocg(rgb), rest], axis=1)
    res = gradient_residuals(groups)
    packed = pack_signed(res)
    # token id is a pure function of the packed value; histogram it here so
    # the host never needs a second pass (and so multi-chip runs reduce it
    # with a psum over the sharded group axis).
    token = _token_id(packed)
    hist = token_histogram(token, jnp.broadcast_to(mask, token.shape))
    wide = packed.astype(jnp.uint16) if out16 else packed
    packed8 = jnp.minimum(packed, 255).astype(jnp.uint8)
    gmax = jnp.max(jnp.where(jnp.broadcast_to(mask, packed.shape), packed,
                             0), axis=(1, 2, 3))
    # single d2h payload: residual planes + per-group max + histogram
    # (SURVEY.md §7 transfer discipline)
    parts = [gmax.astype(jnp.uint32).view(jnp.uint8).reshape(-1),
             hist.astype(jnp.uint32).view(jnp.uint8).reshape(-1)]
    if emit_planes:
        parts.insert(0, packed8.reshape(-1))
    payload = jnp.concatenate(parts)
    return payload, wide


def _token_id(packed: jnp.ndarray, split_exponent: int = 4,
              msb_in_token: int = 2, lsb_in_token: int = 0) -> jnp.ndarray:
    from libjxl_tpu.ops.modular_ops import floor_log2
    split_token = 1 << split_exponent
    small = packed < split_token
    n = floor_log2(jnp.maximum(packed, 1))
    mant = packed - (jnp.uint32(1) << n.astype(jnp.uint32))
    tok_big = (split_token +
               ((n - split_exponent) << (msb_in_token + lsb_in_token)) +
               ((mant >> jnp.maximum(n - msb_in_token, 0).astype(jnp.uint32))
                << lsb_in_token).astype(jnp.int32) +
               (mant & ((1 << lsb_in_token) - 1)).astype(jnp.int32))
    return jnp.where(small, packed.astype(jnp.int32), tok_big)


def frame_groups_host(img: np.ndarray, group_dim: int):
    """(H, W, C) -> (G, C, gd, gd) uint8/uint16 groups + bool mask (numpy)."""
    h, w, c = img.shape
    gy = -(-h // group_dim)
    gx = -(-w // group_dim)
    ph, pw = gy * group_dim, gx * group_dim
    imgp = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    groups = imgp.reshape(gy, group_dim, gx, group_dim, c)
    groups = groups.transpose(0, 2, 4, 1, 3).reshape(
        gy * gx, c, group_dim, group_dim)
    yy = np.arange(ph).reshape(gy, group_dim)
    xx = np.arange(pw).reshape(gx, group_dim)
    # (gy, gx, gd, gd) then flatten group axes
    mask = (yy[:, None, :, None] < h) & (xx[None, :, None, :] < w)
    mask = mask.reshape(gy * gx, 1, group_dim, group_dim)
    return np.ascontiguousarray(groups), mask


def encode_image_device(img: np.ndarray, group_dim: int = 256,
                        use_rct: bool = True):
    """Host wrapper: (H, W, C) -> per-group packed residuals + histogram.

    Returns (packed list of per-group (C, gd, gd) arrays, mask, hist).
    Each group is uint8 when its residuals fit, else the wide dtype; only
    the narrow planes are copied to the host by default."""
    dev = encode_image_device_dispatch(img, group_dim, use_rct)
    return encode_image_device_collect(dev)


def encode_image_device_dispatch(img: np.ndarray, group_dim: int = 256,
                                 use_rct: bool = True):
    """Async half: enqueue device compute + d2h; returns a handle.

    Use with ``encode_image_device_collect`` to pipeline several images
    (transfers overlap the host entropy coding of earlier images)."""
    groups, mask = frame_groups_host(img, group_dim)
    out16 = img.dtype == np.uint8
    h, w = img.shape[:2]
    gx = -(-w // group_dim)
    payload, wide = encode_groups_device(
        jnp.asarray(groups), h, w, gx=gx, use_rct=use_rct, out16=out16)
    payload.copy_to_host_async()
    return payload, wide, mask, groups.shape


def encode_image_device_collect(dev):
    """Blocking half: fetch the payload and split it."""
    payload, wide, mask, gshape = dev
    ng, nch, gd, _ = gshape
    buf = np.asarray(payload)
    psize = ng * nch * gd * gd
    packed8 = buf[:psize].reshape(ng, nch, gd, gd)
    gmax = buf[psize:psize + 4 * ng].view(np.uint32)
    hist = buf[psize + 4 * ng:].view(np.uint32).astype(np.int64)
    out = []
    for g in range(ng):
        if gmax[g] >= 255:
            out.append(np.asarray(wide[g]))   # rare wide fetch
        else:
            out.append(packed8[g])
    return out, mask, hist


PACK_T = 128          # tokens per packed chunk
PACK_NW = 128         # worst-case words per chunk (max real: 124)
PACK_ROW = 8          # chunks start 8-word aligned in the dense
                      # stream (host splice drops the slack)


@functools.partial(jax.jit, static_argnames=("gx", "per_image", "out16"))
def lossless_tokens_device(groups: jnp.ndarray, h, w, gx: int = 1,
                           per_image: int = 0, out16: bool = True):
    """Pass 1 of the two-pass device encode: residuals + token histogram.

    groups: (G_total, C, gd, gd) int pixels, possibly a whole batch of
    images stacked along the group axis (``per_image`` groups each; 0 =
    single image). Returns (wide residuals on device, histogram uint32 —
    the ONLY d2h payload of this pass, ~1KB).
    """
    groups = groups.astype(jnp.int32)
    ng, nch, gd, _ = groups.shape
    gi = jnp.arange(ng) if not per_image else jnp.arange(ng) % per_image
    row0 = (gi // gx) * gd
    col0 = (gi % gx) * gd
    ymask = row0[:, None] + jnp.arange(gd)[None, :] < h
    xmask = col0[:, None] + jnp.arange(gd)[None, :] < w
    mask = ymask[:, None, :, None] & xmask[:, None, None, :]
    if nch >= 3:
        rgb = groups[:, :3]
        rest = groups[:, 3:]
        groups = jnp.concatenate([fwd_ycocg(rgb), rest], axis=1)
    res = gradient_residuals(groups)
    packed = pack_signed(res)
    token = _token_id(packed)
    hist = token_histogram(token, jnp.broadcast_to(mask, token.shape))
    # 8-bit inputs: post-RCT residuals fit uint16; 16-bit inputs reach
    # 2^17 and need the full uint32 (matching encode_groups_device out16)
    wide = packed.astype(jnp.uint16) if out16 else packed
    # zero invalid positions so pass 2 can emit zero-length tokens for them
    wide = jnp.where(jnp.broadcast_to(mask, wide.shape), wide,
                     jnp.zeros((), wide.dtype))
    valid = jnp.broadcast_to(mask, wide.shape)
    # host-pack mode payload: clamped 1 B/px residuals + per-group
    # wide-escape maxes. The raw residual plane is the SMALLER d2h
    # payload whenever the stream exceeds ~8 bpp.
    wide8 = jnp.minimum(wide, 255).astype(jnp.uint8)
    gmax = jnp.max(jnp.where(valid, wide, 0), axis=(1, 2, 3))
    payload = jnp.concatenate([
        gmax.astype(jnp.uint32).view(jnp.uint8).reshape(-1),
        hist.astype(jnp.uint32).view(jnp.uint8).reshape(-1)])
    return wide, wide8, valid, payload


@functools.partial(jax.jit, static_argnames=("gx", "per_image"))
def lossless_hist_device(groups: jnp.ndarray, h, w, gx: int = 1,
                         per_image: int = 0):
    """Histogram-only probe: one tiny d2h payload (per-group maxes +
    256-bin token histogram), with every pixel-shaped intermediate
    fused away — used to build the prefix code before the single-pass
    fused encode, so the residual planes are never materialized in
    device memory and re-read (the two-program pass-1/pass-2 split
    pays that round-trip)."""
    groups = groups.astype(jnp.int32)
    ng, nch, gd, _ = groups.shape
    gi = jnp.arange(ng) if not per_image else jnp.arange(ng) % per_image
    row0 = (gi // gx) * gd
    col0 = (gi % gx) * gd
    ymask = row0[:, None] + jnp.arange(gd)[None, :] < h
    xmask = col0[:, None] + jnp.arange(gd)[None, :] < w
    mask = ymask[:, None, :, None] & xmask[:, None, None, :]
    if nch >= 3:
        groups = jnp.concatenate(
            [fwd_ycocg(groups[:, :3]), groups[:, 3:]], axis=1)
    packed = pack_signed(gradient_residuals(groups))
    token = _token_id(packed)
    hist = token_histogram(token, jnp.broadcast_to(mask, token.shape))
    valid = jnp.broadcast_to(mask, packed.shape)
    gmax = jnp.max(jnp.where(valid, packed, 0), axis=(1, 2, 3))
    return jnp.concatenate([
        gmax.astype(jnp.uint32).view(jnp.uint8).reshape(-1),
        hist.astype(jnp.uint32).view(jnp.uint8).reshape(-1)])


@functools.partial(jax.jit, static_argnames=("gx", "per_image",
                                              "cap_words"))
def lossless_pack_fused(groups: jnp.ndarray, h, w, code_bits, code_len,
                        gx: int = 1, per_image: int = 0,
                        cap_words: int = 1 << 20):
    """Single-program lossless encode: RCT + residuals + tokens + prefix
    pack, when the prefix code is already known (trailing-code serving
    mode: batch k reuses batch 0's code — the stream stays legal because
    the code actually used is the one written in the header, it is just
    ~0-2% denser to re-derive it per batch; enc_fast_lossless.cc uses
    the same sampled-stats trick to stay single-pass).

    Returns (dense words, chunk_bits)."""
    groups = groups.astype(jnp.int32)
    ng, nch, gd, _ = groups.shape
    gi = jnp.arange(ng) if not per_image else jnp.arange(ng) % per_image
    row0 = (gi // gx) * gd
    col0 = (gi % gx) * gd
    ymask = row0[:, None] + jnp.arange(gd)[None, :] < h
    xmask = col0[:, None] + jnp.arange(gd)[None, :] < w
    mask = ymask[:, None, :, None] & xmask[:, None, None, :]
    if nch >= 3:
        groups = jnp.concatenate(
            [fwd_ycocg(groups[:, :3]), groups[:, 3:]], axis=1)
    packed = pack_signed(gradient_residuals(groups))
    valid = jnp.broadcast_to(mask, packed.shape)
    wide = jnp.where(valid, packed, jnp.zeros((), packed.dtype))
    return chunk_pack_device(wide, valid, code_bits, code_len,
                             cap_words=cap_words)


def _lut2_apply(tokens: jnp.ndarray, t0: jnp.ndarray, t1: jnp.ndarray):
    """Look tokens up in two code tables (prefix bits, lengths) with a
    plain gather; out-of-range tokens clamp to the last entry."""
    t = jnp.clip(tokens, 0, t0.shape[0] - 1)
    return t0[t], t1[t]


def _pack_dense(v, valid, code_bits, code_len, cap_words: int):
    """Prefix-code each PACK_T-token chunk straight into the dense word
    stream. An in-chunk cumsum of bit lengths gives every token its
    word and bit offset, chunks start PACK_ROW-word aligned after the
    words of the chunks before them, and each token's low and high
    word parts are scatter-added at (start + wt) and (start + wt + 1).
    Within a chunk the bit fields are disjoint, so add equals OR.
    Returns (dense words uint32[cap_words], chunk_bits int32[Cn]);
    words past cap_words are dropped (callers detect the overflow from
    chunk_bits)."""
    T, rw = PACK_T, PACK_ROW
    token = _token_id(v)
    n = jnp.maximum(_floor_log2_u32(jnp.maximum(v, 1)), 2)
    nbits = jnp.where(v < 16, 0, n - 2).astype(jnp.uint32)
    raw = jnp.where(v < 16, 0, v & ((jnp.uint32(1) << nbits) - 1))
    cbits, clen = _lut2_apply(token, code_bits.astype(jnp.uint32),
                              code_len.astype(jnp.uint32))
    comb = jnp.where(valid, cbits | (raw << clen), 0).reshape(-1, T)
    lens = jnp.where(valid, clen + nbits, 0).astype(jnp.int32).reshape(-1, T)
    off = jnp.cumsum(lens, axis=1) - lens
    chunk_bits = off[:, -1] + lens[:, -1]
    rows = (chunk_bits + rw * 32 - 1) // (rw * 32)
    pos = ((jnp.cumsum(rows) - rows) * rw)[:, None] + (off >> 5)
    b = (off & 31).astype(jnp.uint32)
    lo = comb << b                      # uint32, b < 32
    hi = jnp.where(b == 0, 0, comb >> ((jnp.uint32(32) - b) & 31))
    dense = jnp.zeros(cap_words, jnp.uint32)
    dense = dense.at[pos].add(lo, mode="drop")
    dense = dense.at[pos + 1].add(hi, mode="drop")
    return dense, chunk_bits


@functools.partial(jax.jit, static_argnames=("cap_words",))
def chunk_pack_device(wide, valid, code_bits, code_len,
                      cap_words: int = 1 << 20):
    """Pass 2: entropy-code residuals into a dense LSB-first word stream.

    Each PACK_T-token chunk is packed independently and starts
    PACK_ROW-word aligned (``_pack_dense``); the host splices the chunks
    bit-exactly (native jxlt_splice_chunks), so the alignment slack
    never reaches the bitstream. Replaces WriteTokens (enc_ans.cc:1237)
    + emission.

    Returns (dense words uint32[cap_words], chunk_bits uint16[Cn]).
    """
    dense, chunk_bits = _pack_dense(
        wide.astype(jnp.uint32).reshape(-1), valid.reshape(-1),
        code_bits, code_len, cap_words)
    return dense, chunk_bits.astype(jnp.uint16)


def _floor_log2_u32(v):
    n = jnp.zeros_like(v, dtype=jnp.int32)
    x = v
    for s in (16, 8, 4, 2, 1):
        m = x >= (jnp.uint32(1) << s)
        n = jnp.where(m, n + s, n)
        x = jnp.where(m, x >> jnp.uint32(s), x)
    return n

"""Sharded restoration filters with ICI halo exchange.

The decode render pipeline's cross-group border problem
(low_memory_render_pipeline.h:62-84, dec_group_border.h:19) maps to a
row-sharded image on a device mesh: each shard needs HALO rows of its
vertical neighbors before running the gaborish+EPF stencils. We
exchange halos with ``jax.lax.ppermute`` (ICI neighbor traffic, no
all-gather), run the exact whole-image filter code
(render/filters.py with xp=jnp) on the widened shard, and crop.

Boundary shards substitute a local mirror for the missing neighbor —
the same edge rule the unsharded filters apply via np.pad(symmetric).
"""

from __future__ import annotations

import functools

import numpy as np

HALO = 16  # rows: covers gaborish(1) + EPF0(3) + EPF1(3) + EPF2(2)
#            rounded to 2 block rows so the sigma plane shards evenly


def _exchange_halo(x, axis_name: str, halo: int = HALO):
    """Append ``halo`` rows from both vertical neighbors (ring ppermute;
    boundary shards get a mirror of their own edge rows)."""
    import jax
    import jax.numpy as jnp

    n = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    top_rows = x[..., :halo, :]         # my top rows -> to my upper nb
    bot_rows = x[..., -halo:, :]
    # receive the shard above's bottom rows and the shard below's top rows
    from_above = jax.lax.ppermute(
        bot_rows, axis_name, [(j, (j + 1) % n) for j in range(n)])
    from_below = jax.lax.ppermute(
        top_rows, axis_name, [(j, (j - 1) % n) for j in range(n)])
    # boundary shards: mirror own edge (np.pad symmetric equivalent)
    mirror_top = x[..., :halo, :][..., ::-1, :]
    mirror_bot = x[..., -halo:, :][..., ::-1, :]
    top = jnp.where(i == 0, mirror_top, from_above)
    bot = jnp.where(i == n - 1, mirror_bot, from_below)
    return jnp.concatenate([top, x, bot], axis=-2)


def restore_sharded_padded(xyb: np.ndarray, lf, raw_quant: np.ndarray,
                           epf_sharpness: np.ndarray, quant_scale: float,
                           mesh=None) -> np.ndarray:
    """restore_sharded for arbitrary heights: symmetric-pads H to a
    multiple of 8*n_devices and crops after filtering.

    Bit-exactness: the filters' own boundary rule is a symmetric mirror
    (render/filters._mirror_pad), so as long as the pad is 0 or >= 4
    rows (the widest stencil reach), every true row sees exactly the
    pixel values the unsharded filter would — a 1-3 row pad is bumped
    by one extra shard row block to stay exact."""
    import jax

    n = len(jax.devices()) if mesh is None else mesh.devices.size
    H = xyb.shape[1]
    step = 8 * n
    p = (-H) % step
    if 0 < p < 4:
        p += step
    # each shard needs >= HALO rows for the exchange, and np.pad
    # symmetric cannot mirror more rows than exist: tiny images run
    # the single-device fused filters instead
    if H + p < HALO * n or p > H:
        from libjxl_tpu.render.filters_jax import restore_device
        return restore_device(xyb, lf, raw_quant, epf_sharpness,
                              quant_scale, fetch=True)
    if p:
        xyb = np.pad(xyb, ((0, 0), (0, p), (0, 0)), mode="symmetric")
    yb_p = xyb.shape[1] // 8
    def _pad_blocks(a):
        rows = yb_p - a.shape[0]
        return a if rows <= 0 else np.pad(
            a, ((0, rows), (0, 0)), mode="edge")
    out = restore_sharded(xyb, lf, _pad_blocks(raw_quant),
                          _pad_blocks(epf_sharpness), quant_scale,
                          mesh=mesh)
    return out[:, :H, :]


def restore_sharded(xyb: np.ndarray, lf, raw_quant: np.ndarray,
                    epf_sharpness: np.ndarray, quant_scale: float,
                    mesh=None, axis: str = "rows") -> np.ndarray:
    """Run gaborish+EPF with the image row-sharded over ``mesh``.

    xyb: (3, H, W) with H a multiple of 8*n_devices (callers pad);
    raw_quant/epf_sharpness: (H/8, W/8) block planes.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax import shard_map

    from libjxl_tpu.render import filters as F
    from libjxl_tpu.render.filters_jax import LfParams, lf_params

    if mesh is None:
        devices = jax.devices()
        mesh = Mesh(np.array(devices), (axis,))
    n = mesh.devices.size
    assert xyb.shape[1] % (8 * n) == 0, "pad H to 8*n_devices"

    lfp = lf_params(lf)
    gab = bool(lf.gab)
    epf_iters = int(lf.epf_iters)
    bh = HALO // 8

    def shard_fn(x, rq, shp, qs, lfp):
        x = _exchange_halo(x, axis)
        # block-unit planes: halo in block rows (HALO pixel rows / 8)
        rq = _exchange_halo(rq, axis, halo=bh)
        shp = _exchange_halo(shp, axis, halo=bh)
        if gab:
            x = F.gaborish(x, lfp, xp=jnp)
        if epf_iters > 0:
            inv_sigma = F.compute_sigma(lfp, None, None, rq, shp,
                                        qs[0], xp=jnp)
            if epf_iters >= 3:
                x = F.epf_step0(x, inv_sigma, lfp, xp=jnp)
            x = F.epf_step1(x, inv_sigma, lfp, xp=jnp)
            if epf_iters >= 2:
                x = F.epf_step2(x, inv_sigma, lfp, xp=jnp)
        return x[:, HALO:-HALO, :]

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, axis, None), P(axis, None), P(axis, None),
                  P(None), P()),
        out_specs=P(None, axis, None))
    # NOTE on fidelity: the EPF sad_mul plane is built per shard, but it
    # is 8-periodic in rows and every shard starts at a multiple of 8
    # (HALO included), so per-shard construction equals the global one.
    fn = jax.jit(fn)
    from libjxl_tpu.parallel.mesh import shard_groups
    out = fn(shard_groups(mesh, np.asarray(xyb, np.float32), dim=1),
             shard_groups(mesh, np.asarray(raw_quant, np.int32)),
             shard_groups(mesh, np.asarray(epf_sharpness, np.int32)),
             jnp.asarray([quant_scale], jnp.float32), lfp)
    return np.asarray(out)

"""Multi-chip sharding: production encode over an 8-device CPU mesh
must emit byte-identical streams, and the halo-exchange filter pipeline
must match the whole-image filters (VERDICT r1 item 3).

The conftest forces an 8-device virtual CPU backend; GPU meshes use
the same code paths (jax.sharding / shard_map are backend-neutral).
"""

import numpy as np
import pytest

import jax


def _img(seed, h, w):
    rng = np.random.default_rng(seed)
    return np.clip(np.cumsum(rng.integers(-3, 4, (h, w, 3)), axis=1),
                   0, 255).astype(np.uint8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_encode_byte_identical():
    """Group-axis sharding over the mesh changes the execution layout,
    not the bitstream: byte-equal output, both decoders agree."""
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.api.encoder import EncodeOptions, encode_lossless_many
    from libjxl_tpu.config import config

    # 2 images x 4 groups = 8 shards on the groups axis
    imgs = [_img(1, 512, 512), _img(2, 512, 512)]
    opts = EncodeOptions(use_device=True, entropy="prefix-device")
    config.shard_encode = False
    try:
        base = encode_lossless_many(imgs, opts)
        config.shard_encode = True
        sharded = encode_lossless_many(imgs, opts)
    finally:
        config.shard_encode = False
    assert [len(b) for b in base] == [len(s) for s in sharded]
    for b, s, im in zip(base, sharded, imgs):
        assert b == s
        assert np.array_equal(decode(s), im)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_filters_match_whole_image():
    """Halo exchange via ppermute reproduces the whole-image gaborish +
    EPF output exactly (border shards mirror like np.pad symmetric)."""
    from libjxl_tpu.core.frame_header import LoopFilter
    from libjxl_tpu.parallel.shard_filters import restore_sharded
    from libjxl_tpu.render import filters as F

    rng = np.random.default_rng(3)
    h, w = 8 * 8 * 8, 128          # H = 512 = 8 devices x 64 rows
    xyb = rng.normal(0, 0.2, (3, h, w)).astype(np.float32)
    raw_quant = rng.integers(1, 60, (h // 8, w // 8)).astype(np.int32)
    sharp = rng.integers(0, 8, (h // 8, w // 8)).astype(np.int32)
    lf = LoopFilter()
    lf.gab = True
    lf.epf_iters = 2
    quant_scale = 0.0009
    out_sharded = restore_sharded(xyb, lf, raw_quant, sharp, quant_scale)

    inv_sigma = F.compute_sigma(lf, None, None, raw_quant, sharp,
                                quant_scale)
    ref = F.gaborish(xyb, lf)
    ref = F.epf_step1(ref, inv_sigma, lf)
    ref = F.epf_step2(ref, inv_sigma, lf)
    assert np.allclose(out_sharded, ref, atol=2e-5), \
        np.abs(out_sharded - ref).max()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_vardct_encode_byte_identical():
    """VarDCT device encode shard_mapped over row bands emits the same
    bytes as the single-device fused program (VERDICT r2 item 4)."""
    from libjxl_tpu.config import config
    from libjxl_tpu.utils.oracle import oracle_available, oracle_decode
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    img = _img(7, 200, 168)            # partial blocks + partial tiles
    opts = LossyOptions(distance=1.0, effort=3, use_device=True)
    config.shard_encode = False
    try:
        base = encode_lossy(img, opts)
        config.shard_encode = True
        sharded = encode_lossy(img, opts)
    finally:
        config.shard_encode = False
    assert base == sharded
    if oracle_available():
        assert oracle_decode(sharded).pixels.shape[:2] == (200, 168)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_decode_filters_byte_identical():
    """decode() with config.shard_decode runs the restoration filters
    row-sharded over the mesh and must produce the identical image."""
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.config import config
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    img = _img(9, 384, 160)
    data = encode_lossy(img, LossyOptions(distance=2.0, effort=5))
    old_df = config.device_filters
    try:
        config.device_filters = True
        config.shard_decode = False
        base = decode(data)
        config.shard_decode = True
        sharded = decode(data)
    finally:
        config.shard_decode = False
        config.device_filters = old_df
    assert np.array_equal(base, sharded)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_dryrun_multichip_smoke():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)

"""VarDCT lossy encoder conformance: both our decoder and the reference
accept the stream and agree; quality tracks the requested distance."""

import numpy as np
import pytest

from libjxl_tpu.api.decoder import decode
from libjxl_tpu.utils.oracle import oracle_available, oracle_decode
from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

needs_oracle = pytest.mark.skipif(not oracle_available(),
                                  reason="libjxl oracle not available")


def _img(rng, h=64, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3 + yy) % 256, (yy * 2) % 256, (xx + yy) % 256],
                   -1).astype(int)
    img += rng.integers(0, 20, img.shape)
    return img.clip(0, 255).astype(np.uint8)


@needs_oracle
def test_lossy_roundtrip_and_oracle(rng):
    img = _img(rng)
    data = encode_lossy(img, LossyOptions(distance=1.0))
    ours = decode(data)
    ref = oracle_decode(data, num_channels=3).pixels
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    rmse = np.sqrt(np.mean((ref.astype(float) - img.astype(float)) ** 2))
    assert rmse < 8.0


@needs_oracle
def test_lossy_distance_tradeoff(rng):
    img = _img(rng)
    sizes, rmses = [], []
    for d in (0.5, 1.0, 2.0):
        data = encode_lossy(img, LossyOptions(distance=d))
        ref = oracle_decode(data, num_channels=3).pixels
        sizes.append(len(data))
        rmses.append(np.sqrt(np.mean(
            (ref.astype(float) - img.astype(float)) ** 2)))
    assert sizes[0] > sizes[1] > sizes[2]
    assert rmses[0] < rmses[2]


@needs_oracle
def test_lossy_multigroup(rng):
    img = _img(rng, 300, 280)
    data = encode_lossy(img, LossyOptions(distance=1.0))
    ours = decode(data)
    ref = oracle_decode(data, num_channels=3).pixels
    # our float64 pipeline vs libjxl's float32 can differ by one u8 step
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@needs_oracle
def test_lossy_odd_size(rng):
    img = _img(rng, 33, 49)
    data = encode_lossy(img)
    ref = oracle_decode(data, num_channels=3).pixels
    assert np.abs(decode(data).astype(int) - ref.astype(int)).max() <= 1


def test_lossy_rate_quality_parity():
    """e3-parity guard: at d=1.0 our stream should be within 25% of the
    size the system libjxl produces at the same distance, with decoded
    quality in the same butteraugli class."""
    import numpy as np
    import pytest
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.metrics.butteraugli import butteraugli_distance_srgb
    from libjxl_tpu.utils.oracle import oracle_available
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    rng = np.random.default_rng(11)
    low = rng.integers(0, 256, (32, 32, 3), np.uint8)
    img = np.kron(low, np.ones((8, 8, 1))).astype(np.uint8)
    img = np.clip(img.astype(int) + rng.integers(-6, 6, img.shape),
                  0, 255).astype(np.uint8)

    data = encode_lossy(img, LossyOptions(distance=1.0))
    dec = decode(data)
    ba = butteraugli_distance_srgb(img, dec)
    assert ba < 2.5
    if not oracle_available():
        pytest.skip("libjxl not found")
    from libjxl_tpu.utils.oracle import oracle_decode, oracle_encode
    ref = oracle_encode(img, lossless=False, effort=3)
    ref_ba = butteraugli_distance_srgb(
        img, oracle_decode(ref).pixels[:, :, :3])
    assert len(data) < 1.25 * len(ref)
    assert ba < ref_ba + 0.8


def test_lossy_acs_e7():
    """effort>=5: AC strategy search (DCT16/DCT32 merges) — smooth image
    should use big transforms, stream decodable by both decoders with
    better rate than the DCT8-only path."""
    import numpy as np
    from PIL import Image

    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.metrics.butteraugli import butteraugli_distance_srgb
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
    rng = np.random.default_rng(4)
    img = np.asarray(Image.fromarray(
        rng.integers(0, 256, (16, 16, 3), np.uint8)).resize(
            (192, 160), Image.BICUBIC)).astype(np.uint8)
    e3 = encode_lossy(img, LossyOptions(distance=1.0, effort=3))
    e7 = encode_lossy(img, LossyOptions(distance=1.0, effort=7))
    assert len(e7) < len(e3)
    dec = decode(e7)
    assert butteraugli_distance_srgb(img, dec) < 2.0
    from libjxl_tpu.utils.oracle import oracle_available
    if oracle_available():
        from libjxl_tpu.utils.oracle import oracle_decode
        ref = oracle_decode(e7).pixels[:, :, :3]
        assert np.abs(ref.astype(int) - dec.astype(int)).max() <= 1
    # confirm big transforms were actually used
    from libjxl_tpu.api.codestream import parse_codestream
    from libjxl_tpu.core.toc import ac_group_index
    from libjxl_tpu.utils.bits import BitReader
    from libjxl_tpu.vardct.frame_dec import VarDCTFrameDecoder
    meta, frames = parse_codestream(e7)
    fr = frames[-1]
    d2 = VarDCTFrameDecoder(fr.header, meta.m, fr.dims)
    r = BitReader(fr.sections[0])
    d2.decode_dc_global(r)
    d2.decode_dc_group(r, 0)
    d2.finalize_dc()
    d2.decode_ac_global(r)
    d2.decode_ac_group([r], 0, 1)
    assert set(np.unique(d2.acs_raw[d2.acs_anchor])) - {0}


@needs_oracle
def test_lossy_alpha_roundtrip(rng):
    """RGBA lossy: alpha is carried losslessly as a modular extra channel
    in the VarDCT frame; both decoders restore it bit-exactly (single- and
    multi-group layouts)."""
    for h, w in ((60, 80), (300, 400)):
        img = _img(rng, h, w)
        alpha = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
        rgba = np.concatenate([img, alpha.astype(np.uint8)], axis=-1)
        data = encode_lossy(rgba, LossyOptions(distance=1.0))
        ours = decode(data)
        assert ours.shape == (h, w, 4)
        assert np.array_equal(ours[:, :, 3], rgba[:, :, 3])
        ref = oracle_decode(data, num_channels=4).pixels
        assert np.array_equal(ref[:, :, 3], rgba[:, :, 3])
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@needs_oracle
def test_lossy_alpha_oracle_encoded(rng):
    """Oracle-encoded lossy RGBA (VarDCT frame + modular EC streams in the
    AC groups): our decoder agrees with the oracle's own decode."""
    from libjxl_tpu.utils.oracle import oracle_encode
    h, w = 300, 400
    rgba = np.concatenate(
        [_img(rng, h, w), rng.integers(0, 256, (h, w, 1), dtype=np.uint8)],
        axis=-1)
    data = oracle_encode(rgba, lossless=False)
    ours = decode(data)
    ref = oracle_decode(data, num_channels=4).pixels
    assert np.array_equal(ours[:, :, 3], ref[:, :, 3])
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@needs_oracle
def test_lossy_u16_input(rng):
    """uint16 sRGB input: 16-bit metadata, oracle decodes at 16 bits."""
    img = (_img(rng).astype(np.uint16) * 257)
    data = encode_lossy(img, LossyOptions(distance=1.0))
    ours = decode(data)
    assert ours.dtype == np.uint16
    ref = oracle_decode(data, dtype=np.uint16, num_channels=3).pixels
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 257
    rmse = np.sqrt(np.mean((ref.astype(float) - img.astype(float)) ** 2))
    assert rmse < 8.0 * 257


@needs_oracle
def test_lossy_e7_iterated_and_small_transforms(rng):
    """effort>=7: butteraugli-iterated quant field (FindBestQuantization)
    plus 8x8 special-transform candidates (IDENTITY/DCT2X2/DCT4X4/
    DCT4X8/AFV). Asserts both decoders agree on the stream (the
    rate/quality comparison itself is covered by the BASELINE sweep in
    test_baseline_configs.py)."""
    h, w = 128, 192
    img = np.full((h, w, 3), 230, np.uint8)
    for i in range(6):
        img[i * 20 + 5:i * 20 + 15, 10:180] = (20, 20, 20) if i % 2 \
            else (200, 30, 30)
    img = (img.astype(int) + rng.integers(0, 5, img.shape)) \
        .clip(0, 255).astype(np.uint8)
    data = encode_lossy(img, LossyOptions(distance=1.0, effort=7))
    ours = decode(data)
    ref = oracle_decode(data, num_channels=3).pixels
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@needs_oracle
def test_lossy_animation(rng):
    """Multi-frame lossy (VarDCT) animation: REPLACE-blended regular
    frames with durations; both decoders accept the stream and our
    decoder reproduces frame count, durations and content."""
    from libjxl_tpu.api.decoder import decode_frames
    from libjxl_tpu.vardct.frame_enc import encode_lossy_animation

    frames = []
    for i in range(3):
        yy, xx = np.mgrid[0:64, 0:96]
        frames.append(np.stack(
            [(xx + 8 * i) % 256, (yy * 2 + i * 4) % 256, (xx + yy) % 256],
            -1).astype(np.uint8))
    data = encode_lossy_animation(frames, [1, 2, 3],
                                  LossyOptions(distance=1.0, effort=3))
    meta, decs = decode_frames(data)
    assert len(decs) == 3
    assert [f.duration for f in decs] == [1, 2, 3]
    for i, f in enumerate(decs):
        p = np.asarray(f.pixels[..., :3], np.float32)
        if p.max() <= 1.01:
            p = p * 255
        assert np.abs(p - frames[i].astype(np.float32)).max() < 48
    oracle_decode(data)           # reference accepts multi-frame stream


@needs_oracle
def test_device_lossy_matches_host(rng):
    """The fused device encode program (encode_lossy_frame_device)
    emits byte-identical streams to the host path."""
    img = rng.integers(0, 255, (120, 200, 3)).astype(np.uint8)
    host = encode_lossy(img, LossyOptions(distance=1.5, effort=3))
    dev = encode_lossy(img, LossyOptions(distance=1.5, effort=3,
                                         use_device=True))
    assert host == dev


def test_decode_many_device_batch_matches_general_path():
    """The batched device reconstruction (models/vardct_decode.py: sparse
    coefficient upload, dequant+CfL+IDCT+EPF+color in one program)
    must agree with the general host path within float tolerance and
    with libjxl within +-1."""
    import numpy as np

    from libjxl_tpu.api.decoder import decode, decode_many
    from libjxl_tpu.config import config
    from libjxl_tpu.utils.oracle import oracle_available, oracle_decode
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:120, 0:200]
    img = np.stack([
        (xx * 255 // 200 + rng.integers(0, 12, (120, 200))),
        (yy * 255 // 120 + rng.integers(0, 12, (120, 200))),
        ((xx + yy) * 255 // 320 + rng.integers(0, 12, (120, 200))),
    ], -1).clip(0, 255).astype(np.uint8)
    data = encode_lossy(img, LossyOptions(distance=1.0, effort=3))
    old = config.device_filters
    config.device_filters = True
    try:
        ref = decode(data)
        outs = decode_many([data] * 3)
    finally:
        config.device_filters = old
    for o in outs:
        assert np.abs(o.astype(int) - ref.astype(int)).max() <= 1
    if oracle_available():
        orc = oracle_decode(data).pixels
        assert np.abs(outs[0].astype(int) - orc.astype(int)).max() <= 1


def test_lossy_e7_large_transform_merges():
    """effort>=7 promotes smooth regions to 64-class transforms
    (enc_ac_strategy.cc:897-921 second-level merge); the stream stays
    decodable by both decoders (+-1) and at least one 64-class strategy
    (DCT64X64/DCT64X32/DCT32X64, raw 18-20) is selected."""
    import collections

    import libjxl_tpu.vardct.enc_acs as EA
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    yy, xx = np.mgrid[0:192, 0:256]
    img = np.stack([
        128 + 60 * np.sin(xx / 97) + 40 * np.cos(yy / 71),
        128 + 50 * np.sin((xx + yy) / 131),
        128 + 50 * np.cos((xx - yy) / 113),
    ], axis=-1).clip(0, 255).astype(np.uint8)
    seen = collections.Counter()
    orig = EA.choose_acs

    def spy(*a, **k):
        acs, anch, rq = orig(*a, **k)
        seen.update(acs[anch].tolist())
        return acs, anch, rq

    EA.choose_acs = spy
    try:
        data = encode_lossy(img, LossyOptions(distance=1.0, effort=7))
    finally:
        EA.choose_acs = orig
    assert any(s in seen for s in (18, 19, 20)), seen
    dec = decode(data)
    assert dec.shape == img.shape
    from libjxl_tpu.utils.oracle import oracle_available, oracle_decode
    if oracle_available():
        ref = oracle_decode(data).pixels
        assert np.abs(ref.astype(int) - dec.astype(int)).max() <= 1


def test_epf_sharpness_search_field():
    """ComputeARHeuristics (enc_heuristics.cc:892): at e7 the encoder
    signals a PER-BLOCK sharpness field chosen by candidate-filter
    error, not the flat fast-tier constant; mixed smooth/noisy content
    must produce a non-constant field and decode +-1 vs the oracle."""
    import libjxl_tpu.vardct.frame_enc as FE
    from libjxl_tpu.api.decoder import decode

    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:160, 0:224]
    img = np.stack([
        150 + 60 * np.sin(xx / 90) + 30 * np.cos(yy / 60),
        140 + 50 * np.sin((xx + yy) / 120),
        120 + 40 * np.cos((xx - yy) / 100),
    ], axis=-1)
    img[80:, :, :] += rng.normal(0, 25, (80, 224, 3))
    img = img.clip(0, 255).astype(np.uint8)

    fields = []
    orig = FE._epf_sharpness_search_state

    def spy(xyb, dec, lf, opsin, d):
        f = orig(xyb, dec, lf, opsin, d)
        fields.append(f)
        return f

    FE._epf_sharpness_search_state = spy
    try:
        data = FE.encode_lossy(img, FE.LossyOptions(distance=1.5,
                                                    effort=7))
    finally:
        FE._epf_sharpness_search_state = orig
    assert fields and fields[0] is not None
    assert len(np.unique(fields[0])) > 1      # actually per-block
    dec = decode(data)
    from libjxl_tpu.utils.oracle import oracle_available, oracle_decode
    if oracle_available():
        ref = oracle_decode(data).pixels
        assert np.abs(ref.astype(int) - dec.astype(int)).max() <= 1


def test_progressive_dc_lf_frame():
    """progressive_dc=1 (enc_frame.cc progressive DC): the DC rides a
    modular-XYB DC_FRAME at dc_level 1, the main frame sets
    USE_DC_FRAME and omits the DC-modular payload. Decodes match the
    in-band-DC encode's quality class, and the system decoder agrees
    +-1."""
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.metrics.butteraugli import butteraugli_distance_srgb
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:300, 0:280]
    img = (np.stack([xx % 256, yy % 256, (xx * yy) % 256], -1)
           + rng.integers(0, 10, (300, 280, 3))
           ).clip(0, 255).astype(np.uint8)
    data = encode_lossy(img, LossyOptions(distance=1.0, effort=3,
                                          progressive_dc=1))
    dec = decode(data)
    base = decode(encode_lossy(img, LossyOptions(distance=1.0,
                                                 effort=3)))
    ba = butteraugli_distance_srgb(img, dec)
    ba0 = butteraugli_distance_srgb(img, base)
    assert ba < ba0 + 0.1
    from libjxl_tpu.utils.oracle import oracle_available, oracle_decode
    if oracle_available():
        ref = oracle_decode(data).pixels
        assert np.abs(ref.astype(int) - dec.astype(int)).max() <= 1


def test_epf0_three_iterations_high_distance(rng):
    """d >= 4 signals three EPF passes including EPF0's 5x5 diamond
    (enc_frame.cc:333-342, stage_epf.cc EPF0Stage); streams decode +-1
    vs the oracle and the banded decoder matches whole-frame."""
    from libjxl_tpu.api.decoder import decode, decode_rows
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    yy, xx = np.mgrid[0:300, 0:340]
    img = (np.stack([xx % 256, yy % 256, (xx + yy) % 256], -1)
           + rng.integers(0, 14, (300, 340, 3))
           ).clip(0, 255).astype(np.uint8)
    data = encode_lossy(img, LossyOptions(distance=5.0, effort=3))
    from libjxl_tpu.api.codestream import parse_codestream
    from libjxl_tpu.api.container import extract_codestream
    _, frames = parse_codestream(extract_codestream(data))
    assert frames[0].header.loop_filter.epf_iters == 3
    dec = decode(data)
    from libjxl_tpu.utils.oracle import oracle_available, oracle_decode
    if oracle_available():
        ref = oracle_decode(data).pixels
        assert np.abs(ref.astype(int) - dec.astype(int)).max() <= 1
    got = np.concatenate([b for _, b in decode_rows(data)], axis=0)
    assert np.array_equal(got, dec)


def test_custom_block_ctx_map_qf_split():
    """Large images engage the content-adaptive block context model
    with a quant-field segment split (enc_heuristics.cc
    FindBestBlockEntropyModel size_for_qf_split); the serialized
    custom BlockCtxMap roundtrips through our own decoder."""
    import libjxl_tpu.vardct.ac_context as AC
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    rng = np.random.default_rng(4)
    h, w = 768, 768
    yy, xx = np.mgrid[0:h, 0:w]
    noise = np.where(xx[:, :, None] < w // 2,
                     rng.normal(0, 14, (h, w, 3)),
                     rng.normal(0, 2, (h, w, 3)))
    img = np.clip(np.stack([128 + 70 * np.sin(xx / 31.0),
                            128 + 50 * np.cos((xx + yy) / 37.0),
                            128 + 60 * np.sin(yy / 23.0)], -1) + noise,
                  0, 255).astype(np.uint8)

    seen = {}
    orig = AC.build_block_ctx_map

    def spy(d, rq, am):
        b = orig(d, rq, am)
        seen["bctx"] = b
        return b

    AC.build_block_ctx_map = spy
    try:
        data = encode_lossy(img, LossyOptions(distance=1.0, effort=5))
    finally:
        AC.build_block_ctx_map = orig
    b = seen["bctx"]
    assert b is not None and b.num_ctxs < 15     # model collapsed
    assert b.qf_thresholds                       # qf split engaged
    out = decode(data)
    mse = np.mean((out[:, :, :3].astype(float) - img) ** 2)
    assert out.shape == img.shape and mse < 200.0


def test_encoder_resampling_factors(rng):
    """-r 2/4/8 (enc_frame.cc resampling): encode at 1/r scale, signal
    fh.upsampling; decode returns the full size and the stream shrinks
    with r."""
    img = _img(rng, 120, 180)
    base = encode_lossy(img, LossyOptions(distance=1.0, effort=5,
                                          resampling=1))
    sizes = [len(base)]
    for r in (2, 4, 8):
        data = encode_lossy(img, LossyOptions(distance=1.0, effort=5,
                                              resampling=r))
        out = decode(data)
        assert out.shape[:2] == (120, 180)
        sizes.append(len(data))
        if oracle_available():
            ref = oracle_decode(data, num_channels=3).pixels
            assert np.abs(out[:, :, :3].astype(int) -
                          ref.astype(int)).max() <= 1
    assert sizes[0] > sizes[1] > sizes[2] > sizes[3]


def test_encoder_resampling_auto_low_bitrate(rng):
    """d >= 10 auto-enables 2x resampling with the reference's distance
    rebalance (enc_frame.cc:104-117)."""
    from libjxl_tpu.api.codestream import parse_codestream

    img = _img(rng, 96, 96)
    data = encode_lossy(img, LossyOptions(distance=12.0, effort=5))
    meta, frames = parse_codestream(data)
    assert frames[0].header.upsampling == 2
    assert decode(data).shape[:2] == (96, 96)


def test_faster_decoding_tiers(rng):
    """decoding_speed tiers trade density for decode speed: tier 3 kills
    EPF, tier 4 kills gaborish too (enc_frame.cc:316-345)."""
    from libjxl_tpu.api.codestream import parse_codestream

    img = _img(rng, 96, 96)
    lfs = {}
    for tier in (0, 2, 3, 4):
        data = encode_lossy(img, LossyOptions(
            distance=2.0, effort=5, faster_decoding=tier))
        meta, frames = parse_codestream(data)
        lfs[tier] = frames[0].header.loop_filter
        out = decode(data)
        assert out.shape[:2] == (96, 96)
        if oracle_available():
            ref = oracle_decode(data, num_channels=3).pixels
            assert np.abs(out[:, :, :3].astype(int) -
                          ref.astype(int)).max() <= 1
    assert lfs[0].epf_iters > lfs[2].epf_iters > lfs[3].epf_iters == 0
    assert lfs[0].gab and not lfs[4].gab


def test_effort_10_11_accepted(rng):
    """e10/e11 (kTectonicPlate/kGlacier, common.h:42-71): the exhaustive
    tiers run the e9 ladder with more butteraugli iterations."""
    img = _img(rng, 64, 64)
    d10 = encode_lossy(img, LossyOptions(distance=1.0, effort=10))
    out = decode(d10)
    assert out.shape[:2] == (64, 64)
    if oracle_available():
        ref = oracle_decode(d10, num_channels=3).pixels
        assert np.abs(out[:, :, :3].astype(int) - ref.astype(int)).max() <= 1


def test_device_heuristics_e5_e7(rng):
    """effort>=5 device front-end (VERDICT r2 #3 gate lift): XYB +
    gaborish-inverse + adaptive quant field + ACS cost grids run as
    fused XLA programs; the stream stays oracle-decodable with rate
    within a few percent of the host path."""
    from libjxl_tpu.metrics.butteraugli import butteraugli_distance_srgb

    img = _img(rng, 120, 168)
    for e in (5, 7):
        host = encode_lossy(img, LossyOptions(distance=1.0, effort=e))
        dev = encode_lossy(img, LossyOptions(distance=1.0, effort=e,
                                             use_device=True))
        assert len(dev) <= 1.08 * len(host)
        out = decode(dev)
        assert butteraugli_distance_srgb(img, out[:, :, :3]) < 3.0
        if oracle_available():
            ref = oracle_decode(dev, num_channels=3).pixels
            assert np.abs(out[:, :, :3].astype(int) -
                          ref.astype(int)).max() <= 1


def test_decode_many_varblock_device_batch(rng):
    """Variable-block streams (e5/e7: merges + specials) now take the
    batched device reconstruction in decode_many — per-strategy-class
    dense batches (models/vardct_decode.decode_frames_device_var) —
    matching the host decode within the f32/f64 rounding step."""
    from libjxl_tpu.api.decoder import decode_many
    from libjxl_tpu.config import config

    imgs = [_img(rng, 120, 144), _img(rng, 120, 144), _img(rng, 96, 80)]
    streams = [encode_lossy(im, LossyOptions(distance=1.0, effort=e))
               for im, e in zip(imgs, (7, 5, 5))]
    host = [decode(s) for s in streams]
    old = config.device_filters
    config.device_filters = True
    try:
        dev = decode_many(streams)
    finally:
        config.device_filters = old
    for a, b in zip(host, dev):
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_progressive_ac_and_qprogressive_ac_modes():
    """--progressive_ac (spectral VLF/LF/full passes, shift 0, with
    downsample markers 4/2) and --qprogressive_ac (2-pass shift 1/0)
    as SEPARATE modes (enc_frame.cc:264-289 SetProgressiveMode): both
    must decode to the same quality class as the single-pass stream,
    agree with the system decoder, and signal the expected Passes
    header."""
    from libjxl_tpu.api.codestream import parse_codestream
    from libjxl_tpu.api.container import extract_codestream
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:256, 0:320]
    img = (np.stack([xx % 256, yy % 256, (xx + yy) % 256], -1)
           + rng.integers(0, 12, (256, 320, 3))
           ).clip(0, 255).astype(np.uint8)
    base = decode(encode_lossy(img, LossyOptions(distance=1.0,
                                                 effort=3)))
    cases = {
        "progressive_ac": dict(num_passes=3, shift=(0, 0, 0),
                               downsample=(4, 2)),
        "qprogressive_ac": dict(num_passes=2, shift=(1, 0),
                                downsample=(2,)),
    }
    from libjxl_tpu.utils.oracle import oracle_available, oracle_decode
    for flag, want in cases.items():
        data = encode_lossy(img, LossyOptions(
            distance=1.0, effort=3, **{flag: True}))
        _, frames = parse_codestream(extract_codestream(data))
        ps = frames[0].header.passes
        assert ps.num_passes == want["num_passes"], flag
        assert tuple(ps.shift) == want["shift"], flag
        assert tuple(ps.downsample) == want["downsample"], flag
        dec = decode(data)
        rmse = float(np.sqrt(np.mean(
            (dec.astype(np.float64) - base.astype(np.float64)) ** 2)))
        assert rmse < 3.0, (flag, rmse)
        if oracle_available():
            ref = oracle_decode(data).pixels
            assert np.abs(ref.astype(int) - dec.astype(int)).max() <= 1


def test_device_transform_matches_host_transform(rng):
    """The fused device transform+quantize path (models/vardct_transform,
    config.device_transform) must produce the same stream as the host
    transform_all/finish_chroma path on the CPU backend — including the
    e7 loop, whose class data it feeds as device handles."""
    from libjxl_tpu.config import config
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    img = _img(rng, 200, 280)
    for e in (5, 7):
        try:
            config.device_transform = True
            a = encode_lossy(img, LossyOptions(distance=1.0, effort=e,
                                               use_device=True))
            config.device_transform = False
            b = encode_lossy(img, LossyOptions(distance=1.0, effort=e,
                                               use_device=True))
        finally:
            config.device_transform = True
        assert a == b

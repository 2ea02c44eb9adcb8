"""Device lossless packer (models/lossless.py) against numpy references.

The host splice (native jxlt_splice_chunks) and therefore the bitstream
depend on the exact dense layout: every PACK_T-token chunk starts
PACK_ROW-word aligned and carries exactly chunk_bits LSB-first bits.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402


def _random_code(rng):
    """A structurally plausible canonical-prefix-style LUT: lengths in
    [1, 15], bits < 2^len (exact canonicity is irrelevant to packing)."""
    lens = rng.integers(1, 16, 96).astype(np.int32)
    bits = (rng.integers(0, 1 << 30, 96).astype(np.uint32)
            & ((np.uint32(1) << lens.astype(np.uint32)) - 1))
    code_bits = np.zeros(256, np.uint32)
    code_len = np.zeros(256, np.int32)
    code_bits[:96] = bits
    code_len[:96] = lens
    return code_bits, code_len


def _hybrid_uint(v: int):
    """Hybrid-uint (4, 2, 0) token, extra-bit count and extra bits."""
    if v < 16:
        return v, 0, 0
    n = v.bit_length() - 1
    return 16 + ((n - 4) << 2) + ((v >> (n - 2)) & 3), n - 2, \
        v & ((1 << (n - 2)) - 1)


def _numpy_pack(v, valid, code_bits, code_len, T=128, row=8):
    """Bit-by-bit writer: each chunk's tokens LSB-first into its own
    word run, runs PACK_ROW-word aligned one after another."""
    words, chunk_bits = [], []
    for c in range(len(v) // T):
        acc, nbits = 0, 0
        for x, ok in zip(v[c * T:(c + 1) * T], valid[c * T:(c + 1) * T]):
            if not ok:
                continue
            tok, nb, raw = _hybrid_uint(int(x))
            ln = int(code_len[tok])
            acc |= (int(code_bits[tok]) | (raw << ln)) << nbits
            nbits += ln + nb
        n_words = -(-nbits // (32 * row)) * row
        words += [(acc >> (32 * i)) & 0xFFFFFFFF for i in range(n_words)]
        chunk_bits.append(nbits)
    return np.asarray(words, np.uint32), np.asarray(chunk_bits)


@pytest.mark.parametrize("bits", [8, 16])
def test_chunk_pack_device_matches_numpy_bit_writer(bits):
    from libjxl_tpu.models.lossless import PACK_T, chunk_pack_device

    rng = np.random.default_rng(42 + bits)
    cn = 24
    n = cn * PACK_T
    hi = (1 << 12) if bits == 8 else (1 << 19) - 1
    v = np.minimum(rng.geometric(0.2, n) - 1, hi).astype(np.uint32)
    v[rng.random(n) < 0.02] = hi            # long raw mantissas
    valid = np.ones(n, bool)
    valid[PACK_T // 2:PACK_T] = False       # chunk 0: valid prefix only
    valid[(cn - 1) * PACK_T:] = False       # last chunk: fully invalid
    v = np.where(valid, v, 0).astype(np.uint32)
    code_bits, code_len = _random_code(rng)
    ref_words, ref_bits = _numpy_pack(v, valid, code_bits, code_len)
    dense, cb = chunk_pack_device(
        jnp.asarray(v), jnp.asarray(valid), jnp.asarray(code_bits),
        jnp.asarray(code_len), cap_words=1 << 13)
    np.testing.assert_array_equal(np.asarray(cb), ref_bits)
    dense = np.asarray(dense)
    np.testing.assert_array_equal(dense[:len(ref_words)], ref_words)
    assert not dense[len(ref_words):].any()


def test_lut2_apply_matches_numpy():
    from libjxl_tpu.models.lossless import _lut2_apply

    rng = np.random.default_rng(3)
    code_bits, code_len = _random_code(rng)
    tokens = rng.integers(0, 300, 5000).astype(np.int32)
    b, ln = _lut2_apply(jnp.asarray(tokens), jnp.asarray(code_bits),
                        jnp.asarray(code_len))
    t = np.minimum(tokens, 255)
    np.testing.assert_array_equal(np.asarray(b), code_bits[t])
    np.testing.assert_array_equal(np.asarray(ln), code_len[t])


def test_token_histogram_matches_numpy():
    from libjxl_tpu.ops.modular_ops import token_histogram

    rng = np.random.default_rng(5)
    n = (1 << 16) + 777                     # not a chunk multiple
    tokens = np.minimum(rng.geometric(0.1, n) - 1, 255).astype(np.int32)
    mask = rng.random(n) < 0.9
    hist = token_histogram(jnp.asarray(tokens), jnp.asarray(mask))
    np.testing.assert_array_equal(
        np.asarray(hist), np.bincount(tokens[mask], minlength=256))


def test_chunk_pack_device_dense_layout():
    """chunk_pack_device's dense stream: every chunk starts 8-word
    aligned and carries exactly its chunk_bits payload."""
    from libjxl_tpu.models.lossless import chunk_pack_device

    rng = np.random.default_rng(7)
    n = 4 * 128
    v = np.minimum(rng.geometric(0.3, n) - 1, 4000).astype(np.uint16)
    valid = np.ones(n, bool)
    code_bits, code_len = _random_code(rng)
    dense, cb = chunk_pack_device(
        jnp.asarray(v), jnp.asarray(valid), jnp.asarray(code_bits),
        jnp.asarray(code_len), cap_words=1 << 12)
    cb = np.asarray(cb).astype(np.int64)
    nw = ((cb + 31) >> 5 + np.int64(0))
    nw_pad = (nw + 7) & ~np.int64(7)
    ws = np.concatenate([[0], np.cumsum(nw_pad)])
    dense = np.asarray(dense)
    # bits beyond each chunk's payload up to its row padding are zero
    for c in range(len(cb)):
        seg = dense[ws[c]:ws[c] + nw_pad[c]]
        used_words = (cb[c] + 31) >> 5
        assert not seg[used_words:].any()
        tail_bits = int(cb[c]) & 31
        if used_words and tail_bits:
            assert (int(seg[used_words - 1]) >> tail_bits) == 0

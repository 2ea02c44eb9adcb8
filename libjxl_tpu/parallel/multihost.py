"""Multi-host (DCN) encode: the streaming DC-group schedule sharded
across JAX processes.

The reference's streaming encoder already proves the schedule: DC-group
bands are encoded independently with per-band histograms so no global
synchronization is needed (enc_frame.cc:2045-2160; per-DC-group
histogram count at :2074). On a multi-host cluster the same schedule maps to
hosts: every process encodes only the DC-group row bands it owns (its
local chips do the pixel math), and the per-section byte blobs — the
only inter-host data — are gathered over DCN with one allgather. The
result is byte-identical to the single-host streaming encode because
every section is self-contained by construction
(api/encoder._StreamingLayout).

Collective traffic: one ragged allgather of compressed section bytes
(≈ the final stream size, split across hosts), nothing else — the
same "bitstream assembly is a host gather" plan as SURVEY.md §5.
"""

from __future__ import annotations

import numpy as np


def _process_allgather_bytes(blobs: list[bytes]) -> list[list[bytes]]:
    """Allgather a per-process list of byte blobs over DCN.

    Two collectives: an int32 length matrix, then one padded uint8
    payload (jax.experimental.multihost_utils.process_allgather rides
    the distributed client's Gloo/DCN channel)."""
    import jax
    from jax.experimental import multihost_utils

    nproc = jax.process_count()
    counts = multihost_utils.process_allgather(
        np.asarray([len(blobs)], np.int32))
    max_n = int(counts.max())
    lens = np.zeros(max_n, np.int32)
    lens[:len(blobs)] = [len(b) for b in blobs]
    all_lens = multihost_utils.process_allgather(lens).reshape(nproc,
                                                               max_n)
    max_bytes = int(all_lens.sum(axis=1).max()) or 1
    payload = np.zeros(max_bytes, np.uint8)
    cat = b"".join(blobs)
    payload[:len(cat)] = np.frombuffer(cat, np.uint8)
    all_payload = multihost_utils.process_allgather(payload).reshape(
        nproc, max_bytes)
    out: list[list[bytes]] = []
    for p in range(nproc):
        pos = 0
        rows = []
        for i in range(int(counts[p, 0] if counts.ndim == 2
                            else counts[p])):
            ln = int(all_lens[p, i])
            rows.append(all_payload[p, pos:pos + ln].tobytes())
            pos += ln
        out.append(rows)
    return out


def encode_lossless_multihost(pixels, options=None) -> bytes | None:
    """Encode one huge image across all JAX processes; returns the
    complete codestream on process 0 (None on other processes).

    DC-group row bands (2048 px, the streaming chunk of
    enc_frame.cc:2135) are dealt round-robin to processes; each process
    only materializes and compresses its own bands. Byte-identical to
    ``b"".join(encode_lossless_streaming(pixels, options))``."""
    import jax

    from libjxl_tpu.api.encoder import EncodeOptions, _StreamingLayout

    options = options or EncodeOptions()
    first = np.asarray(pixels[0:1])
    h = len(pixels)
    w = first.shape[1]
    nch = 1 if first.ndim == 2 else first.shape[2]
    pid, nproc = jax.process_index(), jax.process_count()
    lay = _StreamingLayout(h, w, nch, first.dtype, options)
    fd = lay.fd

    owned = [dcy for dcy in range(fd.ysize_dc_groups)
             if dcy % nproc == pid]
    mine: list[bytes] = []
    for dcy in owned:
        mine.extend(lay.dc_band_sections(pixels, dcy))
    gathered = _process_allgather_bytes(mine)

    if pid != 0:
        return None
    # reassemble file order: bands were dealt round-robin by dcy
    per_band = fd.xsize_dc_groups  # DC sections per band ...
    cursors = [0] * nproc
    file_sections = [lay.dc_global_section()]
    for dcy in range(fd.ysize_dc_groups):
        p = dcy % nproc
        n = _band_section_count(fd, dcy)
        file_sections.extend(
            gathered[p][cursors[p]:cursors[p] + n])
        cursors[p] += n
    file_sections.append(b"")       # AC global
    del per_band
    return lay.header_bytes + b"".join(lay.assemble(file_sections))


def _band_section_count(fd, dcy: int) -> int:
    """Sections one DC row band contributes (DC groups + AC groups)."""
    gys = min(fd.ysize_groups, dcy * 8 + 8) - dcy * 8
    return fd.xsize_dc_groups + gys * fd.xsize_groups


def encode_lossy_multihost(pixels, options=None) -> bytes | None:
    """Multi-host VarDCT encode over DCN: each process encodes its
    round-robin share of DC-group row bands with the band-local
    streaming layout (vardct/frame_enc.encode_lossy_streaming — per-band
    AC histogram sets, enc_frame.cc:2074), and one ragged allgather
    moves the section bytes + per-band entropy codes to process 0,
    which writes headers, the merged ACGlobal and the permuted TOC.
    Byte-identical to the single-process streaming encode."""
    import pickle

    import jax

    from libjxl_tpu.core.geometry import FrameDimensions
    from libjxl_tpu.vardct.frame_enc import (
        LossyOptions, _lossy_band_sections, _merged_stream_ac_global,
        _stream_assemble, _stream_headers_and_frame,
        _streaming_lossy_check,
    )

    options = options or LossyOptions()
    pixels = np.asarray(pixels)
    _streaming_lossy_check(pixels, options)
    pid, nproc = jax.process_index(), jax.process_count()
    bw, fd = _stream_headers_and_frame(pixels, options)
    nbands = fd.ysize_dc_groups
    sel_bits = (nbands - 1).bit_length() if nbands > 1 else 0
    mine: list[bytes] = []
    for dcy in range(nbands):
        if dcy % nproc != pid:
            continue
        res = _lossy_band_sections(pixels, dcy, options, sel_bits)
        mine.append(pickle.dumps(
            (dcy, res["sections"], res["num_dc_groups"], res["codes"]),
            protocol=4))
    gathered = _process_allgather_bytes(mine)
    if pid != 0:
        return None
    by_band = {}
    for rows in gathered:
        for blob in rows:
            dcy, secs, nb_dc, codes = pickle.loads(blob)
            by_band[dcy] = (secs, nb_dc, codes)
    dc_global = by_band[0][0][0]
    band_secs = []
    codes_list = []
    for dcy in range(nbands):
        secs, nb_dc, codes = by_band[dcy]
        band_secs.append((secs[1:1 + nb_dc], secs[2 + nb_dc:]))
        codes_list.append(codes)
    ac_global = _merged_stream_ac_global(codes_list, fd)
    return _stream_assemble(bw, fd, dc_global, ac_global, band_secs)


def decode_multihost(data: bytes) -> np.ndarray | None:
    """Multi-host sharded decode over DCN: each process renders a
    contiguous window of group rows with the banded decoder
    (api/decoder.decode_rows gy_range — one extra neighbor band per
    boundary keeps the restoration filters halo-exact), and one ragged
    allgather moves the pixel shards to process 0. Bit-identical to the
    single-process ``decode(data)``.

    The reference's analog is the AC-group RunOnPool fan-out
    (dec_frame.cc:726) plus the low-memory pipeline's cross-group
    border store (low_memory_render_pipeline.h:62-84); over DCN the
    border exchange becomes one redundantly-decoded 256-row band per
    process boundary (~1/8 duplicated work per boundary at 2048-row
    shards), which beats a pixel-halo roundtrip at DCN latencies."""
    import pickle

    import jax

    from libjxl_tpu.api.codestream import parse_codestream
    from libjxl_tpu.api.container import extract_codestream
    from libjxl_tpu.api.decoder import decode_rows

    pid, nproc = jax.process_index(), jax.process_count()
    meta, frames = parse_codestream(extract_codestream(data))
    fd = frames[-1].dims
    n_gy = fd.ysize_groups
    a = pid * n_gy // nproc
    b = (pid + 1) * n_gy // nproc
    gd = fd.group_dim
    chunks = [arr for (y0, arr) in decode_rows(data, gy_range=(a, b))
              if a * gd <= y0 < b * gd]     # fallback paths yield all
    mine = np.concatenate(chunks, axis=0) if chunks else \
        np.zeros((0, fd.xsize, 3), np.uint8)
    gathered = _process_allgather_bytes([pickle.dumps(mine, protocol=4)])
    if pid != 0:
        return None
    parts = []
    for p in range(nproc):
        arr = pickle.loads(gathered[p][0])
        if arr.shape[0]:
            parts.append(arr)
    return np.concatenate(parts, axis=0)

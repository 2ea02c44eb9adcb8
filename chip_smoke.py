"""Smoke test of the codec's main paths on an NVIDIA GPU.

Drives the public entry points on the corpus images at deployment size:

  0. device check: a GPU backend, the card's name and power limit, the
     native host library;
  1. lossless batch encode, 16 x 1024x768 (``encode_lossless_many``,
     prefix codes packed on the device);
  2. VarDCT e3 d1.0 batch encode (``encode_lossy_many``);
  3. VarDCT e7 d1.0 encode with the butteraugli loop on the device;
  4. serving decode of 24 e3 and 8 e7 streams (``decode_many``), which
     must take the batched device reconstruction;
  5. one 3840x2160 frame through lossless encode, e3 encode and
     ``decode_many``;
  6. device times of the lossless packer, the token histogram, the fused
     lossless program, the restoration filters and the e<=4 VarDCT frame
     program.

Each phase compares the device result with the same call run on the CPU.
The CPU runs happen in a child process pinned to ``JAX_PLATFORMS=cpu``,
so it never opens the card; it runs while the card works and sends its
streams back over a pipe. Lossless streams must be byte-identical to the
CPU's and decode bit-exactly; lossy streams must keep their size and
butteraugli distance; decoded pixels must agree with the host decoder
within 1 per sample. Any failed check exits non-zero; there is no CPU
fallback. The last line of standard output is one JSON object naming
the device.

Usage (from the repository root):

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # only the sharded paths, 4 GPUs:
                                        # lossless and e3 encode
                                        # (config.shard_encode) and the
                                        # restoration filters behind
                                        # config.shard_decode
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = ("photo", "screenshot", "sky", "wood")
E7_IMAGES = ("sky", "screenshot")
MOSAIC_SHAPE = (2160, 3840)
PLATFORM = "gpu"          # the device kind every phase must run on


def _load_corpus() -> dict:
    from libjxl_tpu.extras.io import load_image
    return {n: load_image(os.path.join(ROOT, "tests", "corpus",
                                       f"large_{n}.png")) for n in CORPUS}


def _mosaic(imgs: dict) -> np.ndarray:
    """3840x2160 frame tiled with the four 1024x768 corpus images."""
    h, w = MOSAIC_SHAPE
    tiles = [imgs[n] for n in CORPUS]
    th, tw = tiles[0].shape[:2]
    out = np.empty((h, w, 3), np.uint8)
    for ty in range(-(-h // th)):
        for tx in range(-(-w // tw)):
            y0, x0 = ty * th, tx * tw
            t = tiles[(ty + tx) % len(tiles)]
            out[y0:y0 + th, x0:x0 + tw] = t[:h - y0, :w - x0]
    return out


def _lossless_opts():
    from libjxl_tpu.api.encoder import EncodeOptions
    return EncodeOptions(use_device=True, entropy="prefix-device")


def _lossy_opts(effort: int):
    from libjxl_tpu.vardct.frame_enc import LossyOptions
    return LossyOptions(distance=1.0, effort=effort, use_device=True)


def _lossless_batch(imgs: dict) -> list:
    return [imgs[n] for n in CORPUS] * 4


# ---------------------------------------------------------------- CPU side

def _cpu_reference() -> None:
    """Child process: the same encode calls on the CPU backend.

    Sends one pickled dict per phase on stdout (phases 1, 2, 3, 5) and
    writes everything else to stderr. Lossless streams are decoded on a
    process pool while the encodes go on."""
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)                     # library prints must not reach the pipe
    sys.stdout = sys.stderr
    import libjxl_tpu  # noqa: F401  (compile cache before the first compile)
    import jax
    assert jax.default_backend() == "cpu"
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.api.encoder import encode_lossless_many
    from libjxl_tpu.parallel import host_pool
    from libjxl_tpu.vardct.frame_enc import encode_lossy, encode_lossy_many

    def send(msg):
        pickle.dump(msg, out)
        out.flush()

    imgs = _load_corpus()
    mosaic = _mosaic(imgs)
    batch = _lossless_batch(imgs)
    pool = host_pool.get_pool(5)
    lossless = encode_lossless_many(batch, _lossless_opts())
    distinct = {s: i for i, s in reversed(list(enumerate(lossless)))}
    dec1 = {s: pool.submit(decode, s) for s in distinct}
    lossless4k = encode_lossless_many([mosaic], _lossless_opts())[0]
    dec4k = pool.submit(decode, lossless4k)
    send(dict(streams=lossless, decoded_exact={
        distinct[s]: bool(np.array_equal(f.result(), batch[distinct[s]]))
        for s, f in dec1.items()}))
    send(dict(streams=encode_lossy_many([imgs[n] for n in CORPUS],
                                        _lossy_opts(3))))
    send(dict(streams=[encode_lossy(imgs[n], _lossy_opts(7))
                       for n in E7_IMAGES]))
    e3_4k = encode_lossy_many([mosaic], _lossy_opts(3))[0]
    send(dict(lossless=lossless4k, e3=e3_4k, lossless_decoded_exact=bool(
        np.array_equal(dec4k.result(), mosaic))))
    host_pool.shutdown()
    out.close()


class _Reference:
    """The CPU child: started first, read phase by phase."""

    def __init__(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke._cpu_reference()"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            start_new_session=True)

    def next(self) -> dict:
        try:
            return pickle.load(self.proc.stdout)
        except EOFError:
            raise RuntimeError(
                f"CPU reference exited early (rc {self.proc.wait()})")

    def close(self, kill: bool) -> None:
        if kill and self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        rc = self.proc.wait(timeout=60)
        if not kill and rc != 0:
            raise RuntimeError(f"CPU reference failed (rc {rc})")


# ---------------------------------------------------------------- helpers

def _nvidia_smi(*query: str) -> str:
    return subprocess.run(["nvidia-smi", *query, "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _host_decode(stream: bytes) -> np.ndarray:
    """decode() on the host path (numpy filters and colour output)."""
    from libjxl_tpu.api.decoder import decode
    from libjxl_tpu.config import config
    config.device_filters = False
    try:
        return decode(stream)
    finally:
        config.device_filters = None


def _distance(orig: np.ndarray, stream: bytes) -> float:
    """Butteraugli distance of the host decode, computed on the CPU."""
    import jax

    from libjxl_tpu.metrics.butteraugli import butteraugli_distance_srgb
    dec = _host_decode(stream)
    with jax.default_device(jax.devices("cpu")[0]):
        return float(butteraugli_distance_srgb(orig, dec[..., :3]))


def _max_diff(a: np.ndarray, b: np.ndarray) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


class _CountCalls:
    """Counts frames that reach the batched device reconstruction."""

    def __init__(self):
        from libjxl_tpu.models import vardct_decode
        self.mod = vardct_decode
        self.frames = {"decode_frames_device": 0,
                       "decode_frames_device_var": 0}
        self.orig = {k: getattr(vardct_decode, k) for k in self.frames}

    def __enter__(self):
        for name, fn in self.orig.items():
            def wrapped(inputs, *a, _fn=fn, _name=name, **kw):
                self.frames[_name] += len(inputs)
                return _fn(inputs, *a, **kw)
            setattr(self.mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


class Report:
    def __init__(self):
        self.failed: list = []

    def phase(self, n, name: str, seconds: float, checks: list) -> None:
        """checks: (description, ok) pairs; one line per phase."""
        bad = [d for d, ok in checks if not ok]
        if bad:
            self.failed.append(n)
        print(f"phase {n} {name}: {'ok' if not bad else 'FAILED'} "
              f"in {seconds:.2f} s; " + "; ".join(
                  d + ("" if ok else " [FAILED]") for d, ok in checks),
              flush=True)


# ---------------------------------------------------------------- phases

def _device_check(count: int) -> list:
    import jax
    devices = jax.devices()
    if jax.default_backend() != PLATFORM or len(devices) < count or \
            any(d.platform != PLATFORM for d in devices[:count]):
        raise SystemExit(f"chip_smoke: needs {count} {PLATFORM} device(s), "
                         f"JAX found {devices}")
    return devices[:count]


def _phase0(rep: Report, t0: float):
    import jax

    from libjxl_tpu.utils import native
    dev = _device_check(1)[0]
    card = _nvidia_smi("--query-gpu=name,power.limit")
    print(card, flush=True)
    lib, dt = _timed(native.get_lib)
    checks = [
        (f"backend {jax.default_backend()}, device {dev.device_kind}", True),
        (f"native host library loaded ({dt:.1f} s)", lib is not None)]
    rep.phase(0, "device check", time.perf_counter() - t0, checks)
    return dev


def _phase1(rep, ref, imgs):
    from libjxl_tpu.api.encoder import encode_lossless_many
    t0 = time.perf_counter()
    batch = _lossless_batch(imgs)
    cold, t_cold = _timed(
        lambda: encode_lossless_many(batch, _lossless_opts()))
    got, t_warm = _timed(
        lambda: encode_lossless_many(batch, _lossless_opts()))
    cpu = ref.next()
    same = sum(g == c for g, c in zip(got, cpu["streams"]))
    exact = cpu["decoded_exact"]
    checks = [
        (f"first call {t_cold:.2f} s, second {t_warm:.2f} s "
         f"({16 * 0.786432 / t_warm:.1f} MP/s), {sum(map(len, got))} "
         f"bytes", True),
        (f"{same}/16 streams byte-identical to the CPU's (tolerance: "
         f"exact)", same == 16 and cold == got),
        (f"{sum(exact.values())}/{len(exact)} distinct streams decode "
         f"bit-exactly (tolerance: exact)", all(exact.values()))]
    rep.phase(1, "lossless batch encode 16x1024x768",
              time.perf_counter() - t0, checks)


def _lossy_checks(origs, got, cpu, size_tol, dist_tol) -> list:
    checks = []
    for orig, g, c in zip(origs, got, cpu):
        dg, dc = _distance(orig, g), _distance(orig, c)
        ratio = len(g) / len(c)
        checks.append((f"size {len(g)}/{len(c)} = {ratio:.4f} (tolerance "
                       f"1 +- {size_tol}), distance {dg:.4f} vs {dc:.4f} "
                       f"(tolerance <= {1 + dist_tol} x), byte-identical "
                       f"{g == c}",
                       abs(ratio - 1) <= size_tol and
                       dg <= (1 + dist_tol) * dc))
    return checks


def _phase2(rep, ref, imgs):
    from libjxl_tpu.vardct.frame_enc import encode_lossy_many
    t0 = time.perf_counter()
    origs = [imgs[n] for n in CORPUS]
    _, t_cold = _timed(lambda: encode_lossy_many(origs, _lossy_opts(3)))
    got, t_warm = _timed(lambda: encode_lossy_many(origs, _lossy_opts(3)))
    cpu = ref.next()["streams"]
    checks = [(f"first call {t_cold:.2f} s, second {t_warm:.2f} s", True)]
    checks += _lossy_checks(origs, got, cpu, 0.01, 0.02)
    rep.phase(2, "VarDCT e3 d1.0 batch encode 4x1024x768",
              time.perf_counter() - t0, checks)
    return got


def _phase3(rep, ref, imgs):
    from libjxl_tpu.vardct.frame_enc import encode_lossy
    t0 = time.perf_counter()
    origs = [imgs[n] for n in E7_IMAGES]
    got, times = [], []
    for im in origs:
        s, dt = _timed(lambda: encode_lossy(im, _lossy_opts(7)))
        got.append(s)
        times.append(dt)
    cpu = ref.next()["streams"]
    checks = [("encode " + ", ".join(f"{t:.2f} s" for t in times), True)]
    checks += _lossy_checks(origs, got, cpu, 0.02, 0.03)
    rep.phase(3, "VarDCT e7 d1.0 encode (sky, screenshot)",
              time.perf_counter() - t0, checks)
    return got


def _decode_checks(streams, out, counts, n_frames) -> list:
    refs = {s: _host_decode(s) for s in set(streams)}
    worst = max(_max_diff(o, refs[s]) for s, o in zip(streams, out))
    frames = sum(counts.frames.values())
    return [(f"{frames}/{n_frames} frames through the batched device "
             f"reconstruction {counts.frames}", frames == n_frames),
            (f"max |device - host decode| = {worst} (tolerance 1)",
             worst <= 1)]


def _phase4(rep, e3, e7):
    from libjxl_tpu.api.decoder import decode_many
    t0 = time.perf_counter()
    streams = list(e3) * 6 + list(e7) * 4
    _, t_cold = _timed(lambda: decode_many(streams))
    with _CountCalls() as counts:
        out, t_warm = _timed(lambda: decode_many(streams))
    # the card may report pids of another pid namespace: require one
    # process on it, and say whether its pid is this one
    apps = _nvidia_smi("--query-compute-apps=pid").split()
    mp = sum(o.shape[0] * o.shape[1] for o in out) / 1e6
    checks = [(f"first call {t_cold:.2f} s, second {t_warm:.2f} s "
               f"({mp / t_warm:.1f} MP/s)", True)]
    checks += _decode_checks(streams, out, counts, len(streams))
    checks.append((f"processes on the card: {apps} (this pid "
                   f"{os.getpid()})", len(apps) == 1))
    rep.phase(4, "serving decode 24 e3 + 8 e7 streams",
              time.perf_counter() - t0, checks)


def _phase5(rep, ref, imgs, dev):
    from libjxl_tpu.api.decoder import decode_many
    from libjxl_tpu.api.encoder import encode_lossless_many
    from libjxl_tpu.vardct.frame_enc import encode_lossy_many
    t0 = time.perf_counter()
    mosaic = _mosaic(imgs)
    lossless, t_ll = _timed(
        lambda: encode_lossless_many([mosaic], _lossless_opts())[0])
    e3, t_e3 = _timed(
        lambda: encode_lossy_many([mosaic], _lossy_opts(3))[0])
    with _CountCalls() as counts:
        out, t_dec = _timed(lambda: decode_many([e3]))
    cpu = ref.next()
    checks = [
        (f"lossless encode {t_ll:.2f} s, e3 encode {t_e3:.2f} s, "
         f"decode_many {t_dec:.2f} s (first calls)", True),
        ("lossless stream byte-identical to the CPU's (tolerance: exact)",
         lossless == cpu["lossless"]),
        ("lossless stream decodes bit-exactly (tolerance: exact)",
         cpu["lossless_decoded_exact"])]
    checks += _lossy_checks([mosaic], [e3], [cpu["e3"]], 0.01, 0.02)
    checks += _decode_checks([e3], out, counts, 1)
    checks.append((f"peak_bytes_in_use "
                   f"{dev.memory_stats()['peak_bytes_in_use']}", True))
    rep.phase(5, "3840x2160 frame", time.perf_counter() - t0, checks)


def _median_ms(fn, *args, reps: int = 7) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _phase6(rep, imgs):
    """Device times of the formulations the GPU port chose (host clock
    around block_until_ready, median of 7 after a warm-up call)."""
    import jax
    import jax.numpy as jnp

    from libjxl_tpu.api.encoder import _prefix_code_state
    from libjxl_tpu.core.frame_header import LoopFilter
    from libjxl_tpu.models import lossless as L
    from libjxl_tpu.ops.modular_ops import token_histogram
    from libjxl_tpu.models.vardct_pipeline import encode_lossy_frame_device
    from libjxl_tpu.render.filters_jax import restore_device
    from libjxl_tpu.vardct.frame_enc import _falcon_device_scalars
    t0 = time.perf_counter()
    batch = _lossless_batch(imgs)
    groups = jnp.asarray(np.concatenate(
        [L.frame_groups_host(im, 256)[0] for im in batch]))
    h, w = batch[0].shape[:2]
    per = groups.shape[0] // len(batch)
    wide, _, valid, payload = L.lossless_tokens_device(
        groups, h, w, gx=4, per_image=per, out16=True)
    st = _prefix_code_state(np.asarray(payload), groups.shape, np.uint8)
    lut_bits, lut_len = jnp.asarray(st["lut_bits"]), jnp.asarray(st["lut_len"])
    n_tok = int(np.prod(wide.shape))
    cap = 1 << int(np.ceil(np.log2(st["total_bits"] // 32 +
                                   n_tok // L.PACK_T * 8 + 64)))
    pack = _median_ms(lambda: L.chunk_pack_device(wide, valid, lut_bits,
                                                  lut_len, cap_words=cap))
    tokens = L._token_id(wide.astype(jnp.uint32))
    hist = _median_ms(jax.jit(token_histogram), tokens, valid)
    fused = _median_ms(lambda: L.lossless_pack_fused(
        groups, h, w, lut_bits, lut_len, gx=4, per_image=per,
        cap_words=cap))
    rng = np.random.default_rng(0)
    n = 2048
    xyb = jnp.asarray((rng.random((3, n, n), np.float32) - 0.4) * 0.3)
    rq = rng.integers(1, 40, (n // 8, n // 8)).astype(np.int32)
    sharp = np.full((n // 8, n // 8), 4, np.int32)
    lf = LoopFilter()
    lf.gab, lf.epf_iters = True, 2
    filt = _median_ms(lambda: restore_device(xyb, lf, rq, sharp, 0.005,
                                             fetch=False))
    mosaic = _mosaic(imgs)
    (qac, inv_qac, table, th_y, th_xb, mul_dc, mh, mw, yb, xb,
     x_qm_mul) = _falcon_device_scalars(mosaic.shape, _lossy_opts(3))
    e3_args = [jnp.asarray(a, jnp.float32) for a in (
        qac, inv_qac, table, th_y, th_xb, mul_dc)]
    e3 = _median_ms(lambda: encode_lossy_frame_device(
        jnp.asarray(mosaic), *e3_args, h=mh, w=mw, yb=yb, xb=xb,
        x_qm_mul=x_qm_mul))
    checks = [
        (f"lossless packer chunk_pack_device (gather LUT + scatter-add "
         f"into the dense stream), {n_tok} tokens: {pack:.3f} ms", True),
        (f"token_histogram (compare-reduce), {n_tok} tokens: "
         f"{hist:.3f} ms", True),
        (f"lossless_pack_fused (residuals + pack), {n_tok} tokens: "
         f"{fused:.3f} ms", True),
        (f"XLA restoration filters gab+EPF2 at {n}x{n}: {filt:.3f} ms = "
         f"{n * n / 1e3 / filt:.1f} MP/s", True),
        (f"VarDCT e<=4 frame program (opsin mix as multiply-adds, DCT8 "
         f"einsum) at {mw}x{mh}: {e3:.3f} ms", True)]
    rep.phase(6, "device times", time.perf_counter() - t0, checks)


# ---------------------------------------------------------------- 4 cards

def _four_cards(rep: Report) -> None:
    """Sharded lossless encode, sharded VarDCT e3 and the sharded
    restoration filters on four cards, each against one device."""
    import jax.numpy as jnp

    from libjxl_tpu.api.container import extract_codestream
    from libjxl_tpu.api.decoder import decode_vardct_frame, parse_codestream
    from libjxl_tpu.api.encoder import encode_lossless_many
    from libjxl_tpu.config import config
    from libjxl_tpu.parallel import mesh
    from libjxl_tpu.parallel.shard_filters import restore_sharded_padded
    from libjxl_tpu.render.filters_jax import (
        output_srgb_int_device, restore_device,
    )
    from libjxl_tpu.vardct.frame_enc import encode_lossy

    devices = _device_check(4)
    print(_nvidia_smi("--query-gpu=name,power.limit"), flush=True)
    imgs = _load_corpus()
    placed = []
    orig_shard = mesh.shard_groups

    def recording(m, arr, dim=0):
        out = orig_shard(m, arr, dim)
        placed.append(out.sharding.device_set)
        return out

    def sharded(fn):
        """(one-device result, sharded result, device sets placed)."""
        placed.clear()
        base = fn()
        assert not placed
        config.shard_encode = True
        mesh.shard_groups = recording
        try:
            out = fn()
        finally:
            config.shard_encode = False
            mesh.shard_groups = orig_shard
        return base, out, list(placed)

    def spread(sets) -> tuple:
        ok = bool(sets) and all(
            len(s) == 4 and all(d.platform == PLATFORM for d in s)
            for s in sets)
        return (f"{len(sets)} sharded inputs, each on "
                f"{sorted({len(s) for s in sets})} distinct devices", ok)

    t0 = time.perf_counter()
    batch = _lossless_batch(imgs)
    base, out, sets = sharded(
        lambda: encode_lossless_many(batch, _lossless_opts()))
    checks = [("streams byte-identical to one device (tolerance: exact)",
               base == out), spread(sets)]
    rep.phase("S1", "sharded lossless encode 16x1024x768",
              time.perf_counter() - t0, checks)
    t0 = time.perf_counter()
    mosaic = _mosaic(imgs)
    base, out, sets = sharded(lambda: encode_lossy(mosaic, _lossy_opts(3)))
    checks = [("stream byte-identical to one device (tolerance: exact)",
               base == out), spread(sets)]
    rep.phase("S2", "sharded VarDCT e3 encode 3840x2160",
              time.perf_counter() - t0, checks)
    # S3: the row-sharded restoration filters behind config.shard_decode
    # (halo exchange by ppermute) against the one-device fused filters,
    # on the 3840x2160 frame's pre-filter XYB
    t0 = time.perf_counter()
    meta, frames = parse_codestream(extract_codestream(out))
    xyb, dec, lf = decode_vardct_frame(meta, frames[0],
                                       _return_prefilter=True)
    args = (np.asarray(xyb, np.float32), lf, dec.raw_quant,
            dec.epf_sharpness, dec.quantizer.scale)
    base = restore_device(*args)
    placed.clear()
    mesh.shard_groups = recording
    try:
        out = restore_sharded_padded(*args)
    finally:
        mesh.shard_groups = orig_shard
    fdiff = float(np.abs(base - out).max())
    intensity = meta.m.tone_mapping.intensity_target
    pdiff = _max_diff(*(output_srgb_int_device(jnp.asarray(x), intensity,
                                               255) for x in (base, out)))
    # float sums taken in another fusion order differ in the last bit,
    # which can move a uint8 sample across a rounding boundary
    checks = [(f"max |sharded - one device| = {fdiff:.3g} in XYB "
               f"(tolerance 1e-6), {pdiff} per uint8 sample (tolerance 1)",
               fdiff <= 1e-6 and pdiff <= 1), spread(list(placed))]
    rep.phase("S3", "sharded restoration filters 3840x2160",
              time.perf_counter() - t0, checks)
    print(f"devices: {[str(d) for d in devices]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "libjxl_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import libjxl_tpu  # noqa: F401  (compile cache before the first compile)
    import jax

    rep = Report()
    count = 4 if args.four_cards else 1
    if args.four_cards:
        _four_cards(rep)
    else:
        t0 = time.perf_counter()
        dev = _phase0(rep, t0)
        ref = _Reference()
        ok = False
        try:
            imgs = _load_corpus()
            _phase1(rep, ref, imgs)
            e3 = _phase2(rep, ref, imgs)
            e7 = _phase3(rep, ref, imgs)
            _phase4(rep, e3, e7)
            _phase5(rep, ref, imgs, dev)
            _phase6(rep, imgs)
            ok = True
        finally:
            ref.close(kill=not ok)
    if rep.failed:
        print(f"chip_smoke: failed phases {rep.failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(_nvidia_smi("--query-gpu=name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

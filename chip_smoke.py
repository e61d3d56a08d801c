"""Bring-up check of the stabilization engine on the GPU.

Runs the main path end to end through the entry points users call
(`runtime.stream.stream`, `runtime.multistream.stream_multi`), at the widths
users run, then compares every warp/enhancement op at 1080p and 4K with the
same op on the host CPU under `highest` matmul precision, and times the XLA
warps and upscales against the card's HBM roofline.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded paths only,
                                   # each beside its one-card run

Everything runs in this one process; the only child is the `nvidia-smi`
query.  The script exits non-zero, printing no result, when JAX finds no GPU.
Its last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# HBM bandwidth by `device_kind` (NVIDIA's H100 SXM data sheet, at 700 W).
# A device missing here is an error: a roofline share needs the card's peak.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

HD = (1080, 1920)
UHD = (2160, 3840)
FPS = 60.0
CLIP_FRAMES = 180  # 3 s at 60 fps: the flagship's steady state is reached


def log(*parts) -> None:
    print(*parts, flush=True)


def require_gpu(n: int = 1):
    """The GPU devices, or SystemExit when JAX has none (no CPU fallback)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX platform is "
            f"{devices[0].platform!r}); this check runs only on a GPU"
        )
    if len(devices) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPUs, JAX sees {len(devices)}")
    return devices


def card_line() -> str:
    """Card name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def mb(n_bytes) -> str:
    return f"{n_bytes / 2**20:.1f}"


def memory_fields(step_memory, device) -> str:
    """XLA's analysis of the compiled step, and the process's device peak."""
    m = step_memory
    peak = (device.memory_stats() or {}).get("peak_bytes_in_use")
    return (
        f"step_args_MB={mb(m.argument_size_in_bytes)} "
        f"step_out_MB={mb(m.output_size_in_bytes)} "
        f"step_temp_MB={mb(m.temp_size_in_bytes)} "
        f"step_alias_MB={mb(m.alias_size_in_bytes)} "
        f"device_peak_MB={'n/a' if peak is None else mb(peak)}"
    )


def steady_ms(arrivals: list[float]) -> float:
    """Mean output interval after the pipeline fills (host clock)."""
    k = min(10, len(arrivals) // 4)
    return (arrivals[-1] - arrivals[k]) / max(len(arrivals) - 1 - k, 1) * 1e3


class OutputCheck:
    """on_output sink: every emitted frame is shaped and finite.

    The sink runs on the pipeline's writer thread, so its cost is part of
    the end-to-end time; it is kept small (a sum is non-finite iff some
    element is, for values in a bounded range) and reported as `sink_ms`.
    """

    def __init__(self, shape: tuple[int, ...]):
        self.shape = shape
        self.arrivals: list[float] = []
        self.sink_s = 0.0

    def __call__(self, *args) -> None:
        t0 = time.perf_counter()
        px = args[-2]
        if px.shape != self.shape or not np.isfinite(px.sum(dtype=np.float64)):
            raise RuntimeError(f"bad output frame: shape {px.shape}")
        self.arrivals.append(time.perf_counter())
        self.sink_s += self.arrivals[-1] - t0

    def sink_ms(self) -> float:
        return self.sink_s / max(len(self.arrivals), 1) * 1e3


# ---------------------------------------------------------------------------
# Deployments through the served entry points
# ---------------------------------------------------------------------------


def stream_phase(name: str, filt, frames: list[np.ndarray], out_size, device):
    """One stream through `runtime.stream.stream`; prints and returns stats."""
    from livevisionkit_tpu.runtime.stream import stream

    check = OutputCheck((3,) + tuple(out_size))
    reader = ((f, t / FPS) for t, f in enumerate(frames))
    stats = stream(filt, reader, on_output=check)
    want = len(frames) - filt.delay
    if stats.frames_in != len(frames) or stats.frames_out != want:
        raise RuntimeError(
            f"{name}: frames in/out {stats.frames_in}/{stats.frames_out}, "
            f"want {len(frames)}/{want}"
        )
    q = stats.latency_quantiles()
    row = dict(
        frames_in=stats.frames_in, frames_out=stats.frames_out,
        compile_s=stats.compile_seconds, ms_per_frame=steady_ms(check.arrivals),
        p50_ms=q["p50_ms"], p99_ms=q["p99_ms"],
    )
    log(
        f"[{name}] frames_in={row['frames_in']} frames_out={row['frames_out']} "
        f"compile_s={row['compile_s']:.2f} ms_per_frame={row['ms_per_frame']:.3f} "
        f"latency_p50_ms={row['p50_ms']:.3f} latency_p99_ms={row['p99_ms']:.3f} "
        f"sink_ms={check.sink_ms():.3f} "
        + memory_fields(stats.step_memory, device)
    )
    return row


def multi_readers(frames: list[np.ndarray], n_streams: int, per_stream: int):
    """`n_streams` in-memory readers over one clip, each from its own offset."""
    stride = max(len(frames) // n_streams, 1)

    def reader(i):
        for t in range(per_stream):
            yield frames[(i * stride + t) % len(frames)], t / FPS

    return [reader(i) for i in range(n_streams)]


def multi_phase(name: str, filt, frames, n_streams: int, per_stream: int,
                device, mesh=None, on_output=None):
    """`n_streams` streams through `runtime.multistream.stream_multi`."""
    from livevisionkit_tpu.runtime.multistream import stream_multi

    check = OutputCheck((3,) + frames[0].shape[:2])

    def sink(i, px, ts):
        check(i, px, ts)
        if on_output is not None:
            on_output(i, px, ts)

    stats = stream_multi(
        filt, multi_readers(frames, n_streams, per_stream), on_output=sink,
        mesh=mesh,
    )
    want = n_streams * per_stream
    if stats.frames_in != want or stats.frames_out != want:
        raise RuntimeError(
            f"{name}: frames in/out {stats.frames_in}/{stats.frames_out}, "
            f"want {want}/{want}"
        )
    ms = steady_ms(check.arrivals)  # per output frame, all streams
    log(
        f"[{name}] streams={n_streams} frames_in={stats.frames_in} "
        f"frames_out={stats.frames_out} compile_s={stats.compile_seconds:.2f} "
        f"ms_per_batch={ms * n_streams:.3f} aggregate_fps={1e3 / ms:.1f} "
        f"stalls={stats.stalls} sink_ms={check.sink_ms():.3f} "
        + memory_fields(stats.step_memory, device)
    )
    return stats


def obs_chain():
    """The OBS filter chain: vs(mesh, EASU) + adb + cas."""
    import livevisionkit_tpu as lvk
    from livevisionkit_tpu import presets

    return lvk.CompositeFilter(filters=(
        lvk.StabilizationFilter(
            settings=presets.stabilization_preset(model="field")),
        lvk.DeblockingFilter(),
        lvk.CASFilter(),
    ))


def fsr_filter(out_size):
    import livevisionkit_tpu as lvk

    return lvk.ScalingFilter(
        settings=lvk.ScalingFilterSettings(output_size=tuple(out_size))
    )


# ---------------------------------------------------------------------------
# Parity with the plain reference on the host CPU
# ---------------------------------------------------------------------------


def smooth_rgb(size, rng) -> np.ndarray:
    """(3, H, W) float32 texture in [0, 1] with distinct channels."""
    from livevisionkit_tpu.utils.synthetic import make_texture

    g = np.asarray(make_texture(*size, rng))
    return np.stack([g, 0.85 * g + 0.1, 0.7 * g + 0.2]).astype(np.float32)


def shake_map(size) -> np.ndarray:
    """(2, H, W) sample map of a small similarity, computed on the host CPU
    so that both devices sample at bit-identical coordinates."""
    import jax
    import jax.numpy as jnp

    from livevisionkit_tpu.models.homography import Homography

    with jax.default_device(jax.devices("cpu")[0]):
        pose = Homography.from_similarity(
            jnp.float32(1.003), jnp.float32(0.004),
            jnp.float32(0.004 * size[1]), jnp.float32(-0.003 * size[0]),
        )
        return np.asarray(pose.sample_map(size))


def _deblock(img):
    from livevisionkit_tpu.data.frame import Frame
    from livevisionkit_tpu.filters.deblocking import DeblockingFilter
    from livevisionkit_tpu.types import PixelFormat

    frame = Frame.create(img, fmt=PixelFormat.YUV)
    return DeblockingFilter().step((), frame)[1].pixels


def parity_ops():
    """(name, fn(img, smap, out_size), input scale, tolerance, reason)."""
    from livevisionkit_tpu.ops import cas, color, easu, rcas, remap
    from livevisionkit_tpu.types import PixelFormat

    yuv = PixelFormat.YUV
    return [
        ("remap_bilinear", lambda x, m, s: remap.remap(x, m, fill=0.0), 1,
         1e-5, "no matmul and identical coordinates: FMA contraction only"),
        ("easu_remap", lambda x, m, s: easu.easu_remap(x, m, fmt=yuv), 1,
         1e-4, "rsqrt/division order in the 12-tap weights"),
        ("easu_scale_2x", lambda x, m, s: easu.easu_scale(x, s, fmt=yuv), 2,
         1e-4, "rsqrt/division order in the 12-tap weights"),
        ("rcas", lambda x, m, s: rcas.rcas(x, 0.8), 1,
         1e-4, "divisions in the lobe limiter"),
        ("cas", lambda x, m, s: cas.cas(x, 0.8), 1,
         1e-4, "sqrt and division in the amplitude"),
        ("bgr_to_yuv", lambda x, m, s: color.convert(
            x, PixelFormat.BGR, yuv), 1,
         1e-5, "3x3 matmul pinned at HIGHEST: f32 rounding only"),
        ("yuv_to_bgr", lambda x, m, s: color.convert(
            x, yuv, PixelFormat.BGR), 1,
         1e-5, "3x3 matmul pinned at HIGHEST: f32 rounding only"),
        ("deblock", lambda x, m, s: _deblock(x), 1,
         1e-5, "block means: summation order only, outside tie blocks"),
    ]


# A deblocking block's smoothing level is floor(255 * block measure); a
# summation-order difference can move a measure sitting on an integer to the
# neighbouring level.  Such tie blocks (and the bilinear keep-map spill into
# their neighbours) are counted, bounded, and left out of the max error.
DEBLOCK_TIE_BLOCK_SHARE = 1e-3


def _deblock_error(got: np.ndarray, ref: np.ndarray, block: int = 16):
    err = np.abs(got - ref).max(axis=0)
    h, w = err.shape
    hb, wb = -(-h // block), -(-w // block)
    pad = np.zeros((hb * block, wb * block), err.dtype)
    pad[:h, :w] = err
    per_block = pad.reshape(hb, block, wb, block).max(axis=(1, 3))
    ties = per_block > 1e-5
    spill = ties.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            spill |= np.roll(np.roll(ties, dy, 0), dx, 1)
    rest = np.where(np.repeat(np.repeat(spill, block, 0), block, 1)[:h, :w],
                    0.0, err)
    return float(rest.max()), float(ties.mean())


def parity_phase(sizes, gpu, cpu, seed: int = 0) -> None:
    """Every op on `gpu` vs on `cpu` at `highest` precision; raises when an
    error exceeds its stated tolerance."""
    import jax

    rng = np.random.default_rng(seed)
    failures = []
    for size in sizes:
        inputs = {}
        for name, fn, scale, tol, reason in parity_ops():
            in_size = (size[0] // scale, size[1] // scale)
            if in_size not in inputs:
                inputs[in_size] = (smooth_rgb(in_size, rng), shake_map(in_size))
            img, smap = inputs[in_size]

            def run(device):
                f = jax.jit(lambda x, m: fn(x, m, size))
                args = jax.device_put((img, smap), device)
                return np.asarray(f(*args))

            got = run(gpu)
            with jax.default_matmul_precision("highest"):
                ref = run(cpu)
            if got.shape != ref.shape or not np.isfinite(got).all():
                raise RuntimeError(f"parity {name}: bad output {got.shape}")
            extra = ""
            if name == "deblock":
                err, ties = _deblock_error(got, ref)
                extra = f" tie_block_share={ties:.5f}"
                bad = err > tol or ties > DEBLOCK_TIE_BLOCK_SHARE
            else:
                err = float(np.abs(got - ref).max())
                bad = err > tol
            log(
                f"[parity] op={name} out={got.shape[-2]}x{got.shape[-1]} "
                f"max_abs_err={err:.3g} tol={tol:g}{extra} ({reason})"
                + (" FAIL" if bad else "")
            )
            if bad:
                failures.append(f"{name}@{size}")
    if failures:
        raise RuntimeError(f"parity failures: {failures}")


def _point_track(corrections, valids, poses, size, predictive, t0):
    """Input and stabilized image positions of one scene point over the
    steady-state outputs (the trajectory oracle's construction)."""
    import jax.numpy as jnp

    h, w = size
    scene = jnp.asarray([[0.5 * w, 0.5 * h]], jnp.float32)
    x_in = np.asarray([np.asarray(p.inverse().transform(scene))[0] for p in poses])
    xs, ys = [], []
    for t, (c, ok) in enumerate(zip(corrections, valids)):
        if not ok or t < t0:
            continue
        xt = x_in[t - predictive]
        gh, gw = c.shape[1:]
        fy = np.clip(xt[1] / (h - 1) * (gh - 1), 0, gh - 1)
        fx = np.clip(xt[0] / (w - 1) * (gw - 1), 0, gw - 1)
        y0, x0 = int(fy), int(fx)
        y1, x1 = min(y0 + 1, gh - 1), min(x0 + 1, gw - 1)
        wy, wx = fy - y0, fx - x0
        cval = (c[:, y0, x0] * (1 - wy) * (1 - wx) + c[:, y0, x1] * (1 - wy) * wx
                + c[:, y1, x0] * wy * (1 - wx) + c[:, y1, x1] * wy * wx)
        xs.append(xt)
        ys.append(xt - np.array([cval[1] * (w - 1), cval[0] * (h - 1)]))
    return np.asarray(xs), np.asarray(ys)


def run_filter(filt, frames, device):
    """Per-frame correction fields and output validity of `filt` over
    uint8 BGR `frames`, run on `device` (the live path's ingest and
    colour conversion, without the threads)."""
    import jax
    import jax.numpy as jnp

    from livevisionkit_tpu.data.frame import Frame
    from livevisionkit_tpu.filters.base import FrameSpec
    from livevisionkit_tpu.types import PixelFormat

    def step(state, raw, ts):
        px = raw.astype(jnp.float32).transpose(2, 0, 1) * (1.0 / 255.0)
        frame = Frame.create(px, timestamp=ts, fmt=PixelFormat.BGR)
        state, out = filt.step(state, frame.reformat(PixelFormat.YUV))
        return state, state.correction.offsets, out.valid

    h, w = frames[0].shape[:2]
    with jax.default_device(device):
        state = filt.init(FrameSpec(h, w, 3, PixelFormat.YUV))
        state = jax.device_put(state, device)
        step = jax.jit(step, donate_argnums=0)
        corr, valid = [], []
        for t, f in enumerate(frames):
            state, c, ok = step(state, jax.device_put(f, device),
                                jnp.float32(t / FPS))
            corr.append(c)
            valid.append(ok)
        return [np.asarray(c) for c in corr], [bool(v) for v in valid]


# Tolerances of the flagship comparison.  RANSAC picks an argmax over
# truncated-quadratic scores and FAST keeps corners above a threshold: a
# last-bit difference in LK can flip a near-tie, which moves one frame's
# model by a fraction of a pixel.  So the trajectories are compared, not
# the bits: per-frame corrections within 2 px at 1080p, and the output
# ATE and jitter within 20% of the CPU reference's.
FLAGSHIP_CORRECTION_PX = 2.0
FLAGSHIP_METRIC_REL = 0.2


def flagship_parity(filt, frames, poses, gpu, cpu) -> None:
    from livevisionkit_tpu.utils import metrics

    import jax

    h, w = frames[0].shape[:2]
    corr_g, valid_g = run_filter(filt, frames, gpu)
    with jax.default_matmul_precision("highest"):
        corr_c, valid_c = run_filter(filt, frames, cpu)
    if valid_g != valid_c:
        raise RuntimeError("flagship parity: output validity differs")
    scale = np.array([h - 1, w - 1], np.float32).reshape(2, 1, 1)
    corr_err = max(float(np.abs((a - b) * scale).max())
                   for a, b in zip(corr_g, corr_c))
    p = filt.delay
    t0 = max(2 * p, 25)
    sigma = p / 2.0
    rows = {}
    for tag, corr in (("gpu", corr_g), ("cpu", corr_c)):
        xs, ys = _point_track(corr, valid_g, poses[: len(frames)], (h, w), p, t0)
        ideal = metrics.smooth_path(xs, sigma=sigma)
        rows[tag] = dict(
            jitter_in=metrics.jitter(xs), jitter_out=metrics.jitter(ys),
            ate_in=metrics.ate(xs, ideal), ate_out=metrics.ate(ys, ideal),
        )
    g, c = rows["gpu"], rows["cpu"]
    rel = max(abs(g[k] - c[k]) / max(c[k], 1e-9) for k in ("jitter_out", "ate_out"))
    bad = (corr_err > FLAGSHIP_CORRECTION_PX or rel > FLAGSHIP_METRIC_REL
           or g["jitter_out"] >= g["jitter_in"])
    log(
        f"[parity] flagship frames={len(frames)} "
        f"max_correction_diff_px={corr_err:.4f} tol={FLAGSHIP_CORRECTION_PX} "
        f"jitter_in={g['jitter_in']:.4f} "
        f"jitter_out_gpu={g['jitter_out']:.4f} jitter_out_cpu={c['jitter_out']:.4f} "
        f"ate_in={g['ate_in']:.4f} ate_out_gpu={g['ate_out']:.4f} "
        f"ate_out_cpu={c['ate_out']:.4f} max_rel_diff={rel:.4f} "
        f"tol={FLAGSHIP_METRIC_REL} (RANSAC argmax near-ties, so compare "
        f"trajectories and not bits)" + (" FAIL" if bad else "")
    )
    if bad:
        raise RuntimeError("flagship parity outside tolerance")


# ---------------------------------------------------------------------------
# XLA in place of the removed kernels: warm device time vs the HBM roofline
# ---------------------------------------------------------------------------


def device_ms(fn, *args, reps: int = 25) -> float:
    """Median host-clock time of `fn(*args)` through `block_until_ready`."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def xla_cases(hd, uhd, lk_size, n_features):
    """(name, fn, args, bytes the op must move at least)."""
    import jax
    import jax.numpy as jnp

    from livevisionkit_tpu.config import OpticalFlowSettings
    from livevisionkit_tpu.ops import easu, rcas, remap
    from livevisionkit_tpu.types import PixelFormat
    from livevisionkit_tpu.vision import optical_flow

    rng = np.random.default_rng(1)
    cases = []

    def warp(mode):
        return lambda x, m: remap.remap(x, m, fill=0.0, filter_mode=mode,
                                        fmt=PixelFormat.YUV)

    for mode in ("bilinear", "easu"):
        for size, batch in ((hd, 1), (hd, 8), (uhd, 1)):
            h, w = size
            img = (smooth_rgb(size, rng) * 255).astype(np.uint8)
            smap = shake_map(size)
            fn = jax.jit(warp(mode))
            args = (img, smap)
            if batch > 1:
                fn = jax.jit(jax.vmap(warp(mode)))
                args = (np.stack([img] * batch), np.stack([smap] * batch))
            # u8 frame in, f32 (y, x) map in, u8 frame out.
            nbytes = batch * h * w * (3 + 8 + 3)
            cases.append((f"{mode}_warp_{h}p_x{batch}", fn,
                          jax.device_put(args), nbytes))
    img = smooth_rgb(hd, rng)
    cases.append((
        f"easu_scale_{hd[0]}p_to_{2 * hd[0]}p",
        jax.jit(lambda x: easu.easu_scale(x, (2 * hd[0], 2 * hd[1]))),
        (jax.device_put(img),), 4 * 3 * hd[0] * hd[1] * 5,
    ))
    img = smooth_rgb(uhd, rng)
    cases.append((f"rcas_{uhd[0]}p", jax.jit(lambda x: rcas.rcas(x, 0.8)),
                  (jax.device_put(img),), 4 * 3 * uhd[0] * uhd[1] * 2))

    settings = OpticalFlowSettings()
    h, w = lk_size
    g0 = smooth_rgb(lk_size, rng)[0]
    g1 = np.roll(g0, (1, 2), axis=(0, 1))
    gy, gx = np.meshgrid(np.linspace(16, h - 17, 17), np.linspace(16, w - 17, 30),
                         indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], -1)[:n_features].astype(np.float32)

    def lk(a, b, p):
        prev = optical_flow.Pyramid.build(a, settings.pyramid_levels)
        nxt = optical_flow.Pyramid.build(b, settings.pyramid_levels)
        return optical_flow.track(prev, nxt, p, jnp.ones(p.shape[0], bool),
                                  settings)

    pyramid_bytes = 4 * h * w * sum(4.0**-i for i in range(settings.pyramid_levels))
    cases.append((
        f"lk_track_{w}x{h}_{len(pts)}pts", jax.jit(lk),
        jax.device_put((g0, g1, pts)),
        int(2 * 4 * h * w + 2 * pyramid_bytes + 4 * len(pts) * 5),
    ))
    return cases


def xla_timing_phase(peak_bytes_per_s: float, hd=HD, uhd=UHD,
                     lk_size=(270, 480), n_features=510, reps: int = 25):
    rows = []
    for name, fn, args, nbytes in xla_cases(hd, uhd, lk_size, n_features):
        ms = device_ms(fn, *args, reps=reps)
        floor_ms = nbytes / peak_bytes_per_s * 1e3
        rows.append((name, ms, floor_ms))
        log(
            f"[xla] op={name} median_ms={ms:.4f} reps={reps} "
            f"bytes={nbytes} hbm_floor_ms={floor_ms:.4f} "
            f"roofline_share={floor_ms / ms:.3f}"
        )
    return rows


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# One-card vs sharded results of the same program.  The u8 delay queue
# re-quantizes every warped pixel, so a last-bit coordinate difference can
# move a pixel by one code (1/255); RANSAC near-ties can move one frame's
# model.  Bounded: mean error and the share of pixels off by more than a code.
SHARDED_MEAN_ERR = 1e-3
SHARDED_OFF_SHARE = 1e-3


def _frame_diff(a, b) -> tuple[float, float, float]:
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(d.max()), float(d.mean()), float((d > 1.0 / 255 + 1e-6).mean())


def four_serving(frames, devices, n_streams=4, per_stream=30) -> bool:
    """stream_multi over make_mesh(n, 1) beside the same streams batched on
    devices[0]."""
    import jax

    from __graft_entry__ import _flagship_filter
    from livevisionkit_tpu.parallel.streams import make_mesh

    filt = _flagship_filter()
    one: dict = {}
    with jax.default_device(devices[0]):
        multi_phase("serving_1card", filt, frames, n_streams, per_stream,
                    devices[0], on_output=lambda i, px, ts: one.__setitem__(
                        (i, round(ts, 6)), px))
    worst = [0.0, 0.0, 0.0]

    def compare(i, px, ts):
        d = _frame_diff(px, one[(i, round(ts, 6))])
        for k in range(3):
            worst[k] = max(worst[k], d[k])

    multi_phase(f"serving_{n_streams}card", filt, frames, n_streams, per_stream,
                devices[0], mesh=make_mesh(n_streams, 1, devices),
                on_output=compare)
    ok = worst[1] <= SHARDED_MEAN_ERR and worst[2] <= SHARDED_OFF_SHARE
    log(f"[four] serving stream_multi mesh=({n_streams},1) vs 1 card: "
        f"max_abs={worst[0]:.4g} worst_frame_mean={worst[1]:.3g} "
        f"worst_frame_off_share={worst[2]:.3g} tol_mean={SHARDED_MEAN_ERR} "
        f"tol_share={SHARDED_OFF_SHARE}" + ("" if ok else " FAIL"))
    return ok


def four_chain(frames_uhd, devices, n_tiles=4) -> bool:
    """The 4K chain through MultiStreamFilter over make_mesh(1, n) beside
    the same program on devices[0]."""
    import jax
    import jax.numpy as jnp

    from livevisionkit_tpu.data.frame import Frame
    from livevisionkit_tpu.filters.base import FrameSpec
    from livevisionkit_tpu.parallel.streams import MultiStreamFilter, make_mesh
    from livevisionkit_tpu.types import PixelFormat

    h, w = frames_uhd[0].shape[:2]
    outs = {}
    for tag, mesh in (("1card", make_mesh(1, 1, devices[:1])),
                      (f"{n_tiles}card", make_mesh(1, n_tiles, devices))):
        ms = MultiStreamFilter(obs_chain(), 1, mesh)
        states = ms.init(FrameSpec(h, w, 3, PixelFormat.YUV))
        step = ms.jit_step()

        def ingest(raw, t):
            px = raw.astype(jnp.float32).transpose(0, 3, 1, 2) * (1.0 / 255.0)
            return jax.vmap(lambda p: Frame.create(
                p, timestamp=t, fmt=PixelFormat.BGR).reformat(PixelFormat.YUV))(px)

        ingest = jax.jit(ingest)
        res = []
        t0 = time.perf_counter()
        for t, f in enumerate(frames_uhd):
            frames = ms._shard(ingest(f[None], jnp.float32(t / FPS)), tile_w=True)
            states, out = step(states, frames)
            res.append((out.pixels, out.valid))
        res = [(np.asarray(p), bool(np.asarray(v)[0])) for p, v in res]
        log(f"[four] chain_{tag} frames={len(res)} "
            f"wall_s={time.perf_counter() - t0:.2f}")
        outs[tag] = res
    worst = [0.0, 0.0, 0.0]
    for (pa, va), (pb, vb) in zip(outs["1card"], outs[f"{n_tiles}card"]):
        if va != vb:
            raise RuntimeError("4K chain: output validity differs")
        if va:
            d = _frame_diff(pa, pb)
            worst = [max(x, y) for x, y in zip(worst, d)]
    ok = worst[1] <= SHARDED_MEAN_ERR and worst[2] <= SHARDED_OFF_SHARE
    log(f"[four] 4K chain MultiStreamFilter mesh=(1,{n_tiles}) vs 1 card: "
        f"max_abs={worst[0]:.4g} worst_frame_mean={worst[1]:.3g} "
        f"worst_frame_off_share={worst[2]:.3g}" + ("" if ok else " FAIL"))
    return ok


# Halo remap and distributed solve: the same arithmetic per pixel/feature in
# a different fusion or reduction order.
REMAP_SHARDED_TOL = 1e-4
SOLVE_SHARDED_TOL = 2e-5


def four_remap(devices, size=UHD, n_tiles=4) -> bool:
    import jax
    from jax.sharding import Mesh

    from livevisionkit_tpu.ops import remap
    from livevisionkit_tpu.parallel import spatial
    from livevisionkit_tpu.types import PixelFormat

    rng = np.random.default_rng(2)
    img, smap = smooth_rgb(size, rng), shake_map(size)
    ref = jax.jit(lambda x, m: remap.remap(
        x, m, fill=0.0, filter_mode="easu", fmt=PixelFormat.YUV))(
        *jax.device_put((img, smap), devices[0]))
    mesh = Mesh(np.asarray(devices[:n_tiles]), ("tile",))
    got = jax.jit(lambda x, m: spatial.remap_sharded(
        x, m, mesh, fill=0.0, halo=192, filter_mode="easu",
        fmt=PixelFormat.YUV))(img, smap)
    err = max_abs(got, ref)
    ok = err <= REMAP_SHARDED_TOL
    log(f"[four] remap_sharded easu {size[0]}x{size[1]} tiles={n_tiles} vs "
        f"remap on 1 card: max_abs={err:.3g} tol={REMAP_SHARDED_TOL}"
        + ("" if ok else " FAIL"))
    return ok


def four_solve(devices, n_tiles=4, n_features=512) -> bool:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from livevisionkit_tpu.config import MeshMotionSettings
    from livevisionkit_tpu.models.warp_field import WarpField
    from livevisionkit_tpu.parallel import distributed_solve
    from livevisionkit_tpu.vision import mesh_motion

    rng = np.random.default_rng(3)
    size = (272, 480)
    dst = np.stack([rng.uniform(2, size[1] - 3, n_features),
                    rng.uniform(2, size[0] - 3, n_features)], -1)
    src = dst + rng.normal(0, 1.5, size=dst.shape) + np.array([3.0, -2.0])
    src, dst = jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32)
    w = jnp.ones(n_features, jnp.float32)
    warm = WarpField.identity((16, 16))
    settings = MeshMotionSettings()
    with jax.default_device(devices[0]):
        ref, ref_inl, _ = mesh_motion.estimate(src, dst, w, warm, size, settings)
    mesh = Mesh(np.asarray(devices[:n_tiles]), ("tile",))
    got, got_inl, _ = distributed_solve.estimate_sharded(
        src, dst, w, warm, size, settings, mesh)
    err = max_abs(got.offsets, ref.offsets)
    same_inliers = bool(np.array_equal(np.asarray(got_inl), np.asarray(ref_inl)))
    ok = err <= SOLVE_SHARDED_TOL and same_inliers
    log(f"[four] distributed_solve tiles={n_tiles} vs single-device solve: "
        f"max_abs_offsets={err:.3g} tol={SOLVE_SHARDED_TOL} "
        f"inliers_equal={same_inliers}" + ("" if ok else " FAIL"))
    return ok


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    import jax

    # The parity phases need the host CPU beside the GPU: keep it among the
    # platforms when the environment names only the GPU.
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    devices = require_gpu(4 if args.four else 1)

    from livevisionkit_tpu.utils import compile_cache
    from livevisionkit_tpu.utils.synthetic import shaky_clip_bgr_u8

    cache = compile_cache.enable_default()
    gpu = devices[0]
    kind = gpu.device_kind
    if kind not in HBM_BYTES_PER_S:
        raise SystemExit(f"chip_smoke: no HBM peak for device kind {kind!r}")
    log(f"[device] kind={kind} count={len(devices)} compile_cache={cache}")
    log(f"[device] nvidia-smi name,power.limit: {card_line()}")

    t_start = time.perf_counter()
    if args.four:
        frames, _ = shaky_clip_bgr_u8(40, HD, seed=0)
        frames_uhd, _ = shaky_clip_bgr_u8(16, UHD, seed=1)
        ok = [
            four_serving(frames, devices),
            four_chain(frames_uhd, devices),
            four_remap(devices),
            four_solve(devices),
        ]
        if not all(ok):
            raise RuntimeError("four-card comparison outside tolerance")
    else:
        from __graft_entry__ import _flagship_filter

        t0 = time.perf_counter()
        frames, poses = shaky_clip_bgr_u8(CLIP_FRAMES, HD, seed=0)
        frames_uhd, _ = shaky_clip_bgr_u8(60, UHD, seed=1)
        log(f"[clip] {len(frames)}x1080p + {len(frames_uhd)}x2160p BGR u8 "
            f"rendered in {time.perf_counter() - t0:.1f}s")
        flagship = _flagship_filter()
        stream_phase("flagship_1080p", flagship, frames, HD, gpu)
        stream_phase("obs_chain_1080p", obs_chain(), frames[:120], HD, gpu)
        stream_phase("chain_2160p", obs_chain(), frames_uhd, UHD, gpu)
        multi_phase("serving_8x1080p", flagship, frames, 8, 60, gpu)
        stream_phase("fsr_1080p_to_2160p", fsr_filter(UHD), frames[:60], UHD, gpu)
        cpu = jax.devices("cpu")[0]
        parity_phase((HD, UHD), gpu, cpu)
        flagship_parity(flagship, frames[:90], poses, gpu, cpu)
        xla_timing_phase(HBM_BYTES_PER_S[kind])
    log(f"[done] wall_s={time.perf_counter() - t_start:.1f}")
    log(f"[device] nvidia-smi name,power.limit: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": kind, "count": len(devices)}}),
        flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)

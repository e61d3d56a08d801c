"""chip_smoke.py: its phases at a tiny size on the CPU, its refusal to run
without a GPU, and (marked `gpu`) the whole script on a card."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from __graft_entry__ import _flagship_filter
from livevisionkit_tpu.utils.synthetic import shaky_clip_bgr_u8

SIZE = (96, 128)


def _small_filter():
    return _flagship_filter(detection=(48, 64), grid=(4, 4), predictive=3,
                            min_samples=6, hypotheses=32)


@pytest.fixture(scope="module")
def clip():
    return shaky_clip_bgr_u8(30, SIZE, seed=0)


def test_main_refuses_cpu_backend():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert "no GPU found" in str(exc.value.code)


def test_stream_phase_counts_frames(clip):
    frames, _ = clip
    row = chip_smoke.stream_phase("tiny", _small_filter(), frames[:12], SIZE,
                                  jax.devices()[0])
    assert (row["frames_in"], row["frames_out"]) == (12, 9)
    assert row["compile_s"] > 0 and row["p99_ms"] >= row["p50_ms"] > 0


def test_multi_phase_flushes_every_stream(clip):
    frames, _ = clip
    stats = chip_smoke.multi_phase("tiny", _small_filter(), frames, 2, 6,
                                   jax.devices()[0])
    assert stats.per_stream_out == [6, 6]
    assert stats.step_memory.temp_size_in_bytes > 0


def test_parity_phase_passes_on_one_backend():
    cpu = jax.devices("cpu")[0]
    chip_smoke.parity_phase(((32, 48),), cpu, cpu)


def test_flagship_parity_on_one_backend(clip):
    frames, poses = clip
    cpu = jax.devices("cpu")[0]
    chip_smoke.flagship_parity(_small_filter(), frames, poses, cpu, cpu)


def test_xla_timing_phase_rows():
    rows = chip_smoke.xla_timing_phase(1e11, hd=(32, 48), uhd=(48, 64),
                                       lk_size=(64, 96), n_features=20, reps=2)
    names = [r[0] for r in rows]
    assert len(names) == 9 and names[-1].startswith("lk_track")
    assert all(ms > 0 and floor > 0 for _, ms, floor in rows)


def test_deblock_error_isolates_tie_blocks():
    ref = np.zeros((3, 64, 96), np.float32)
    got = ref.copy()
    got[:, 16:32, 32:48] += 0.05  # one block moved a level
    got[:, 60, 5] += 3e-6         # float noise elsewhere
    err, ties = chip_smoke._deblock_error(got, ref)
    assert err == pytest.approx(3e-6, rel=1e-3)
    assert ties == pytest.approx(1 / 24)


@pytest.mark.parametrize("phase", ["remap", "solve", "serving"])
def test_four_card_phases_on_virtual_devices(phase, clip):
    devices = jax.devices()[:4]
    if phase == "remap":
        assert chip_smoke.four_remap(devices, size=(48, 128))
    elif phase == "solve":
        assert chip_smoke.four_solve(devices, n_features=64)
    else:
        assert chip_smoke.four_serving(clip[0], devices, per_stream=5)


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The whole script in a child process (this process stays on the CPU,
    so the child has the card to itself)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"

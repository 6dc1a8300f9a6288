"""chip_smoke.py: its checks, its phase selection and result line, and
every phase rehearsed on the CPU at tiny shapes (on the card the script
runs them at full width; ``python chip_smoke.py [--four]``)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from zraytrace_tpu.render import RenderStats  # noqa: E402


def _stats(**kw):
    base = dict(rays=100, reflections=60, background_hits=40,
                recursion_depth_hits=8, samples=48)
    base.update(kw)
    return RenderStats(**base)


@pytest.mark.parametrize("kw,ok", [
    ({}, True),
    (dict(samples=47), False),   # samples != w*h*spp
    (dict(rays=101), False),     # rays identity broken
])
def test_stats_identity(kw, ok):
    st = _stats(**kw)
    if ok:
        cs.stats_identity(st, 4, 4, 3)
    else:
        with pytest.raises(AssertionError):
            cs.stats_identity(st, 4, 4, 3)


@pytest.mark.parametrize("delta,ok", [(0, True), (1, True), (2, False)])
def test_counter_tolerance(delta, ok):
    """0.1% of 1000 rays is one ray."""
    ref = _stats(rays=1000)
    got = _stats(rays=1000 + delta)
    if ok:
        assert cs.check_counters("t", "x", got, ref) == delta / 1000
    else:
        with pytest.raises(AssertionError):
            cs.check_counters("t", "x", got, ref)


@pytest.mark.parametrize("shift,ok", [(0.0, True), (0.9 / 255, True),
                                      (1.1 / 255, False)])
def test_image_tolerance(shift, ok):
    ref = np.zeros((4, 5, 3), np.float32)
    got = ref + np.float32(shift)
    if ok:
        assert cs.check_image("t", "x", got, ref) == pytest.approx(shift)
    else:
        with pytest.raises(AssertionError):
            cs.check_image("t", "x", got, ref)


def test_grad_tolerance():
    ref = {"a": np.ones(4), "b": np.asarray([3.0, 4.0])}
    got = {"a": np.ones(4), "b": np.asarray([3.0, 4.0 + 5e-4])}
    errs = cs.tree_rel_err(got, ref)
    assert errs["a"] == 0.0 and errs["b"] == pytest.approx(1e-4)
    cs.check_grads("t", "x", got, ref, 1e-3)
    with pytest.raises(AssertionError):
        cs.check_grads("t", "x", got, ref, 1e-5)


def test_result_line_format():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line([dev] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


@pytest.mark.parametrize("argv,phases", [
    ([], cs.PHASES_ONE),
    (["--four"], ("device", "four")),
    (["--resume-across", "d"], ("device", "resume_across")),
])
def test_phase_selection(argv, phases):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true")
    ap.add_argument("--resume-across", default=None)
    assert cs.phases_for(ap.parse_args(argv)) == phases


def test_without_gpu_fails_and_prints_no_result(capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        cs.main(["--spp", "1"])
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """Shrink every phase to CPU size and let the CLI run on the CPU."""
    import zraytrace_tpu.runtime as rt

    monkeypatch.setattr(rt, "require_gpu", lambda what: None)
    monkeypatch.setattr(cs, "OUT", tmp_path / "out")
    monkeypatch.setattr(cs, "SPHERES", dict(width=24, height=16,
                                            max_depth=4))
    monkeypatch.setattr(cs, "REFERENCE", (
        (1, dict(width=12, height=8, samples_per_pixel=2, max_depth=3)),
        (3, dict(width=8, height=8, samples_per_pixel=1, max_depth=3))))
    monkeypatch.setattr(cs, "TEAPOT", dict(width=12, height=12,
                                           max_depth=3))
    monkeypatch.setattr(cs, "FIT", dict(size=16, spp=2, depth=3, steps=4,
                                        cpu_size=8))
    monkeypatch.setattr(cs, "CKPT", dict(width=12, height=10,
                                         samples_per_pixel=4, max_depth=4))
    monkeypatch.setattr(cs, "CKPT_CHUNK", 2)
    monkeypatch.setattr(cs, "TRAIN", dict(size=8, spp=2, depth=3))
    monkeypatch.setattr(cs, "MESH_FIT_ARGS", [
        "--steps", "2", "--size", "8", "--spp", "1", "--depth", "2"])
    return SimpleNamespace(spp=2, four=False,
                           resume_across=str(tmp_path / "resume"))


@pytest.mark.parametrize("phase", ["spheres", "reference", "teapot",
                                   "checkpoint", "fit"])
def test_phase_runs_on_cpu(tiny, phase, capsys):
    cs.run_phases([phase], tiny)
    out = capsys.readouterr().out
    assert f"[{phase}] done in" in out


def test_resume_across_two_calls(tiny, capsys):
    cs.run_phases(["resume_across"], tiny)
    assert "run again to resume" in capsys.readouterr().out
    cs.run_phases(["resume_across"], tiny)
    assert "bit for bit: True" in capsys.readouterr().out


def test_four_phase_on_virtual_devices(tiny, capsys):
    """The --four path on four virtual CPU devices: sharded renders on
    2x2 and 4x1 meshes and the sharded train step against card 0."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cs.run_phases(["four"], tiny)
    out = capsys.readouterr().out
    assert out.count("counters equal to card 0: True") == 2
    assert "value_and_grad 2x2 vs card 0" in out


@pytest.fixture
def gpu_present():
    """Whether this machine has an NVIDIA GPU (decided at run time)."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_reference_phase_on_gpu(gpu_present):
    """On a GPU machine: the device and reference phases in a process of
    their own (this test process is held to the CPU)."""
    import os

    code = ("import chip_smoke as cs; cs.phase_device(1); "
            "cs.run_phases(['reference'], None)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[reference] done in" in proc.stdout

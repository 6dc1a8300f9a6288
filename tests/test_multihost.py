"""Two-process jax.distributed loopback test (SURVEY.md §4d): the
standard way to exercise the multi-host path without a pod. Two
subprocesses each own 4 virtual CPU devices, rendezvous over localhost,
form one global 4x2 mesh, and render a sharded image that must match the
single-process result."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_render(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [str(tmp_path / f"worker{i}.npz") for i in range(2)]
    env = dict(os.environ)
    # CPU-only workers (tests/multihost_worker.py selects the platform)
    inherited = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo] + inherited)
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(repo, "tests", "multihost_worker.py"),
             str(i), str(port), outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        logs.append(err.decode(errors="replace")[-2000:])
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log

    # single-process reference
    from tests.test_render import _mini_scene
    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.render import render

    scene, camera = _mini_scene()
    params = RenderParams(width=8, height=8, samples_per_pixel=4, max_depth=3)
    img_ref, stats_ref = render(scene, camera, params)

    seen_coordinator = False
    for path in outs:
        with np.load(path) as z:
            np.testing.assert_allclose(z["image"], img_ref, atol=1e-5)
            assert int(z["rays"]) == stats_ref.rays
            assert int(z["samples"]) == stats_ref.samples
            assert int(z["background"]) == stats_ref.background_hits
            seen_coordinator |= bool(z["coordinator"])
    assert seen_coordinator

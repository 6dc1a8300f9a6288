"""The differentiable-path cost metric (tools/diff_bench.py) is tracked
like the throughput bench: this test pins the machinery at a tiny
config — the jitted value-and-grad step must run, the ray accounting
must come from the wavefront counters (exact, not estimated), and the
written report must be well-formed.

The full-config report is produced on the GPU by
``python tools/diff_bench.py``."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_diff_bench_reduced_config():
    from tools.diff_bench import bench_sphere_albedo

    entry = bench_sphere_albedo(16, 2, 3, steps=1)
    # ray accounting is the wavefront engine's exact counter: positive
    # and at least one segment per pixel sample
    assert entry["rays_forward"] >= 16 * 16 * 2
    assert entry["step_seconds"] > 0
    assert entry["eff_rays_per_s"] > 0
    assert entry["config"]["spp"] == 2


def test_diff_bench_artifact_fresh(tmp_path):
    """The report the tool writes carries both workloads with exact ray
    counts and positive rates, and names the device it ran on."""
    import json

    from tools.diff_bench import compute_report, write_report

    rep = compute_report(steps=1, sphere=(8, 1, 2), teapot=(8, 1, 2),
                         verbose=False)
    path = tmp_path / "DIFF_BENCH.json"
    write_report(rep, path)
    rep = json.loads(path.read_text())
    assert rep["device"]["platform"] == "cpu"
    assert rep["device"]["count"] >= 1
    for name in ("sphere_albedo_fit", "teapot_pose_fit"):
        w = rep["workloads"][name]
        assert w["rays_forward"] > 0
        assert w["eff_rays_per_s"] > 0
        assert w["step_seconds"] > 0

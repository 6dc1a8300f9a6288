"""The gradient-quality metric (tools/grad_report.py) is tracked like
the throughput bench: this test pins the methodology at a reduced
config so regressions in any estimator (edge-aware silhouettes,
occlusion, the Fresnel branch score factor) show up as a metric jump.

The full-config artifact (GRAD_REPORT.json, 64x64 at the class spp
scales, on the GPU) is produced by ``python tools/grad_report.py``."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_grad_report_reduced_config():
    from tools.grad_report import compute_report

    rep = compute_report(width=32, height=32, spp=32, verbose=False,
                         classes=("sphere_radius", "albedo"))
    cls = rep["classes"]
    # albedo gradients are fully continuous — near-exact at any spp
    assert cls["albedo"]["max_rel_error"] < 0.02
    # radius is coverage-dominated; the edge estimator must stay within
    # a third of FD even at this reduced sampling (5% at full config,
    # GRAD_REPORT.json)
    assert cls["sphere_radius"]["max_rel_error"] < 0.35


def test_grad_report_artifact_fresh():
    """If the committed artifact exists it must satisfy the quality bar
    the round records. Round 5: the probes became honest (rendered
    targets give lateral components O(1) signal), which exposed the
    log-sigmoid kernel's ln2-class normalization bias on the boundary
    classes (~15-36%, seed-tight — PERF.md round-5 diagnosis); the
    continuous classes stay tight. The bars encode that split."""
    import json

    path = Path(__file__).resolve().parent.parent / "GRAD_REPORT.json"
    if not path.exists():
        import pytest

        pytest.skip("GRAD_REPORT.json not generated yet")
    rep = json.loads(path.read_text())
    # boundary classes: characterized relaxation bias, not noise
    assert rep["max_rel_error_overall"] < 0.45
    for k in ("sphere_center", "camera_pose", "triangle_vertex"):
        c = rep["classes"][k]
        assert c["max_rel_error"] < 0.45, (k, c["max_rel_error"])
    # continuous classes: genuinely verified
    assert rep["classes"]["albedo"]["max_rel_error"] < 0.02
    assert rep["classes"]["ior"]["max_rel_error"] < 0.05
    assert rep["classes"]["sphere_radius"]["max_rel_error"] < 0.10

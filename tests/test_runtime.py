"""Runtime helpers: where compiled programs persist, and the entry points
that refuse to run without a GPU."""

from pathlib import Path

import jax
import pytest

from zraytrace_tpu import runtime

ROOT = Path(__file__).resolve().parent.parent


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    package sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compilation_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    runtime.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compilation_cache_dir() == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu("render")


@pytest.mark.parametrize("argv", [["8", "8", "1", "2", "1"], []])
def test_cli_without_gpu_exits_with_message(tmp_path, argv):
    """Without ``--cpu`` the CLI requires a GPU; with it, it renders."""
    from zraytrace_tpu import cli

    out = tmp_path / "o.png"
    args = (argv or ["4", "4", "1", "2", "1"]) + [str(out)]
    if argv:
        with pytest.raises(SystemExit, match="no GPU"):
            cli.main(args)
        assert not out.exists()
    else:
        assert cli.main(args + ["--cpu"]) == 0
        assert out.exists()


def test_bench_without_gpu_exits_with_message(monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT))
    import bench

    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()
    assert capsys.readouterr().out == ""

"""Smoke tests: every example CLI parses and exposes --help."""

import os
import subprocess
import sys

import pytest

SCRIPTS = [
    "examples/benchmark.py",
    "examples/skqd_validation.py",
    "examples/skqd_necessity_test.py",
    "examples/skqd_lattice_validation.py",
    "examples/moderate_system_benchmark.py",
    "examples/large_system_benchmark.py",
]


@pytest.mark.parametrize("script", SCRIPTS)
def test_help(script):
    out = subprocess.run([sys.executable, script, "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage" in out.stdout.lower()


def test_bench_and_entry_importable():
    import importlib.util
    for mod in ("bench", "__graft_entry__"):
        spec = importlib.util.find_spec(mod)
        assert spec is not None


def test_chip_smoke_refuses_cpu():
    """Without a GPU the device smoke test exits non-zero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

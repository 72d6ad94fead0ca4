"""Compile-cache location rules (utils/platform.py).

Each case runs in a subprocess so the suite's own jax config stays
untouched.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SNIPPET = """
import jax
from qkan_implementation.utils.platform import enable_compile_cache
print("RETURNED=", enable_compile_cache(), sep="")
print("CONFIG=", jax.config.jax_compilation_cache_dir, sep="")
"""


def run(env_extra, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    for k in drop:
        env.pop(k, None)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", SNIPPET], capture_output=True, text=True,
        env=env, timeout=120, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr[-800:]
    return dict(
        line.split("=", 1) for line in out.stdout.splitlines() if "=" in line
    )


def test_env_var_is_used_and_nothing_else_set(tmp_path):
    want = str(tmp_path / "cache")
    got = run({"JAX_COMPILATION_CACHE_DIR": want})
    assert got["RETURNED"] == want
    # JAX read the variable itself; enable_compile_cache changed nothing
    assert got["CONFIG"] == want


def test_default_is_the_fixed_checkout_dir():
    got = run({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    want = str(REPO / ".jax_cache")
    assert got["RETURNED"] == want
    assert got["CONFIG"] == want


@pytest.mark.parametrize("tmp_env", ["TMPDIR", "HOME"])
def test_default_never_follows_temp_or_home(tmp_path, tmp_env):
    """The default path is built from the checkout alone: moving TMPDIR or
    HOME must not move the cache (its path is part of the cache key)."""
    got = run(
        {tmp_env: str(tmp_path / "elsewhere")},
        drop=("JAX_COMPILATION_CACHE_DIR",),
    )
    assert got["CONFIG"] == str(REPO / ".jax_cache")
    assert str(tmp_path) not in got["CONFIG"]


def test_default_dir_is_git_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_default_is_stable_across_processes():
    a = run({}, drop=("JAX_COMPILATION_CACHE_DIR",))["CONFIG"]
    b = run({}, drop=("JAX_COMPILATION_CACHE_DIR",))["CONFIG"]
    assert a == b

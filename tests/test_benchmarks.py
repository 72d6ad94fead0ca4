"""Tests for benchmark harness logic that gates runs on the card.

The contracts bench (benchmarks/contracts.py) declares f32 precision floors
for the GPU and must FAIL when a measured contract regresses past its
floor.  These tests pin the gate logic itself so a refactor cannot silently
disable it.
"""

import importlib.util
import json
import pathlib
import sys
import types

import pytest

_BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks"


def _load_contracts():
    spec = importlib.util.spec_from_file_location(
        "contracts_mod", _BENCH_DIR / "contracts.py"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("contracts_mod", mod)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def contracts():
    return _load_contracts()


def test_chip_floor_gate_fires_on_regression(contracts):
    floors = {"mul_deg0": 6.0e-07, "lcu": 1.7e-06}
    # 10x precision loss on one contract -> exactly that contract flagged.
    results = {"mul_deg0": 6.0e-06, "lcu": 1.0e-06, "device": "x"}
    regressions = contracts.check_chip_floor(results, floors, gate=True)
    assert set(regressions) == {"mul_deg0"}
    assert regressions["mul_deg0"]["achieved"] == 6.0e-06
    assert regressions["mul_deg0"]["floor"] == 6.0e-07


def test_chip_floor_gate_passes_at_floor(contracts):
    floors = {"sum": 1.6e-06}
    # Exactly at the floor is a pass (floor is the declared contract).
    assert contracts.check_chip_floor({"sum": 1.6e-06}, floors, gate=True) == {}


def test_chip_floor_gate_disabled_off_chip(contracts):
    floors = {"sum": 1.6e-06}
    assert contracts.check_chip_floor({"sum": 1.0}, floors, gate=False) == {}


def test_chip_floor_gate_ignores_unmeasured_contracts(contracts):
    floors = {"sum": 1.6e-06, "not_measured": 1e-9}
    assert contracts.check_chip_floor({"sum": 1e-07}, floors, gate=True) == {}


def test_declared_floors_cover_every_float_contract(contracts):
    """Every float contract of the committed card record has a declared
    floor, so a new contract cannot land ungated."""
    rec = json.loads((_BENCH_DIR / "records" / "contracts_gpu.json").read_text())
    floats = {k for k, v in rec.items() if isinstance(v, float)}
    assert floats and floats <= set(contracts.CHIP_FLOOR), (
        floats - set(contracts.CHIP_FLOOR)
    )
    # and the committed run itself passed its floors
    assert all(rec[k] <= contracts.CHIP_FLOOR[k] for k in floats)


def test_main_exits_nonzero_on_regression(contracts, monkeypatch, tmp_path):
    """End-to-end: a deliberate precision regression on the card makes the
    bench fail and records the failing contract."""
    mod = contracts
    monkeypatch.setattr(
        mod, "measure",
        lambda: {"device": "fake", "platform": "gpu", "mul_deg0": 1.0},
    )
    monkeypatch.setattr(mod, "CHIP_FLOOR", {"mul_deg0": 6.0e-07})
    monkeypatch.setattr(
        mod.subprocess, "run",
        lambda *a, **k: types.SimpleNamespace(stdout="Fake card, 700 W"),
    )
    monkeypatch.setattr(
        mod, "__file__", str(tmp_path / "benchmarks" / "contracts.py")
    )
    with pytest.raises(SystemExit) as exc:
        mod.main()
    assert exc.value.code == 1
    rec = json.loads(
        (tmp_path / "benchmarks" / "records" / "contracts_gpu.json").read_text()
    )
    assert set(rec["regressions"]) == {"mul_deg0"}
    assert rec["card"] == "Fake card, 700 W"


def test_bench_refuses_without_a_gpu():
    """bench.py has no CPU fallback: without a GPU it exits non-zero and
    prints no result line."""
    import os
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "bench.py"], cwd=str(_BENCH_DIR.parent), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"metric"' not in out.stdout

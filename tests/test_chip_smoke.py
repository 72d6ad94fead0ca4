"""chip_smoke.py: its refusal off the GPU, the shape of its last line, and
every phase's logic at small sizes on the CPU.

On the card the same phases run at full width (``python chip_smoke.py``);
here they run with the sizes cut, which checks the paths, references and
tolerance plumbing but not the device numbers.
"""

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=str(cwd), env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [(), ("--multi",)])
def test_refuses_without_a_gpu(args):
    out = _run_script(REPO, *args)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_last_line_names_the_device(monkeypatch):
    """With every phase stubbed, main() ends on the one JSON line that
    names the device."""
    monkeypatch.setattr(chip_smoke, "require_gpu", lambda: jax)
    monkeypatch.setattr(chip_smoke, "phase0_device", lambda jax: None)
    for name in ("phase1_flagship", "phase2_layer_op", "phase3_fable",
                 "phase4_quantum_training", "phase5_annealer",
                 "phase6_kernel"):
        monkeypatch.setattr(chip_smoke, name, lambda jax: None)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        chip_smoke.main()
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    dev = jax.devices()[0]
    assert last == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}


def test_multi_needs_four_devices(monkeypatch):
    monkeypatch.setattr(chip_smoke, "require_gpu", lambda: jax)
    monkeypatch.setattr(chip_smoke, "phase0_device", lambda jax: None)
    monkeypatch.setattr(jax, "devices", lambda *a: [object()] * 2)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--multi"])
    with pytest.raises(SystemExit, match="4 GPUs"):
        chip_smoke.main()


def test_report_raises_past_tolerance(capsys):
    chip_smoke.report("p", 1e-7, 1e-6, "f32", 0.0)
    with pytest.raises(chip_smoke.PhaseFailed, match="exceeds"):
        chip_smoke.report("p", 2e-6, 1e-6, "f32", 0.0)
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.report("p", float("nan"), 1e-6, "f32", 0.0)
    line = capsys.readouterr().out.splitlines()[0]
    for key in ("[p]", "max_err=", "tol=", "precision=f32", "wall="):
        assert key in line


def test_layer_reference_matches_reference_faithful_forward():
    """The vectorized f64 reference of phase 2 equals the reference's own
    per-sample algorithm (bench.py) and its gradient equals a finite
    difference."""
    import numpy as np

    from bench import reference_faithful_forward

    rng = np.random.default_rng(0)
    N = K = 4
    x = rng.uniform(-1, 1, (5, N))
    w = rng.uniform(-1, 1, (3, N * K))
    out, grad = chip_smoke._numpy_layer_f64(x, w, N, K)
    for i in range(5):
        np.testing.assert_allclose(
            out[i], reference_faithful_forward(x[i], w, N, K), atol=1e-12
        )
    eps = 1e-6
    w2 = w.copy()
    w2[1, 6] += eps
    fd = (np.sum(chip_smoke._numpy_layer_f64(x, w2, N, K)[0] ** 2)
          - np.sum(out ** 2)) / eps
    assert abs(fd - grad[1, 6]) < 1e-4


def test_phase1_flagship_small():
    chip_smoke.phase1_flagship(
        jax, shape=(784, 8, 10), train_size=300, num_reads=16, num_sweeps=50,
        epochs=3, batch_size=128,
    )


def test_phase2_layer_op_small():
    chip_smoke.phase2_layer_op(jax, batch=512, rows=128)


def test_phase3_fable_small():
    chip_smoke.phase3_fable(jax, ns=(3, 4))


def test_phase4_quantum_training():
    chip_smoke.phase4_quantum_training(jax)


def test_phase5_annealer_small():
    chip_smoke.phase5_annealer(jax, funcs=8, reads=64, sweeps=100,
                               native_reads=4)


def test_multi_sharded_fable_small():
    chip_smoke.multi_sharded_fable(jax, n=4)


def test_multi_dp_train_small():
    chip_smoke.multi_dp_train(jax, shape=(16, 4, 10), rows=256, batch_size=64)


@pytest.mark.gpu
def test_phase6_kernel_on_gpu(gpu):
    chip_smoke.phase6_kernel(jax)

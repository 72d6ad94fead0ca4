"""Device-time reduction of jax.profiler traces (utils/profiling.py) and
the layer-0 kernel bench built on it (benchmarks/fused_layer_bench.py)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from qkan_implementation.utils.profiling import (
    device_kernel_times,
    stream_kernel_times,
)

REPO = Path(__file__).resolve().parent.parent


def _meta(pid, name, tid=None):
    e = {"ph": "M", "pid": pid, "args": {"name": name},
         "name": "process_name" if tid is None else "thread_name"}
    if tid is not None:
        e["tid"] = tid
    return e


def _x(pid, tid, name, dur):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": 0.0, "dur": dur}


def _trace():
    return {"traceEvents": [
        _meta(1, "/host:CPU"), _meta(1, "python", tid=10),
        _meta(2, "/device:GPU:0"),
        _meta(2, "Stream #13(Compute)", tid=13),
        _meta(2, "Stream #14(MemcpyD2D)", tid=14),
        _meta(2, "XLA Ops", tid=99),
        _x(1, 10, "PjitFunction(f)", 500.0),  # host: not device time
        _x(2, 13, "kan_layer_fused_fwd", 40.0),
        _x(2, 13, "kan_layer_fused_fwd", 42.0),
        _x(2, 13, "loop_fusion", 5.0),
        _x(2, 14, "memcpy", 1.5),
        _x(2, 99, "fusion.1", 47.0),  # repeats the stream's kernels
    ]}


def test_stream_kernel_times_sums_gpu_streams_only():
    assert stream_kernel_times(_trace()) == {
        "kan_layer_fused_fwd": 82.0, "loop_fusion": 5.0, "memcpy": 1.5,
    }


@pytest.mark.parametrize("wrap", [dict, list])
def test_stream_kernel_times_accepts_both_trace_forms(wrap):
    trace = _trace()
    doc = trace if wrap is dict else trace["traceEvents"]
    assert sum(stream_kernel_times(doc).values()) == 88.5


def test_stream_kernel_times_without_a_gpu():
    events = [e for e in _trace()["traceEvents"] if e["pid"] == 1]
    assert stream_kernel_times({"traceEvents": events}) == {}


def test_device_kernel_times_off_the_gpu(tmp_path):
    """On the CPU the trace holds no GPU stream: no device times, and the
    trace lands in the directory given."""
    fn = jax.jit(lambda x: jnp.tanh(x) @ x)
    assert device_kernel_times(fn, jnp.ones((8, 8)), calls=2,
                               log_dir=str(tmp_path)) == {}
    assert list(tmp_path.glob("plugins/profile/*/*.trace.json.gz"))


def test_layer0_bench_small_off_the_gpu(monkeypatch):
    """The bench's rows at a small width: every path agrees with full f32
    (the kernel in interpret mode); no device times on the CPU."""
    monkeypatch.syspath_prepend(str(REPO))
    from benchmarks import fused_layer_bench

    monkeypatch.setattr(
        fused_layer_bench, "device_kernel_times", lambda fn, *a, calls: {}
    )
    rows = fused_layer_bench.layer0_rows(calls=1, batch=70, in_dim=40,
                                         out=4, T=10, D=5)
    assert set(rows) == {"fwd_tf32", "fwd_bf16x3", "dw_tf32"}
    for row in rows.values():
        assert row["err_kernel"] < 1e-4 and row["err_xla"] < 1e-4
        assert row["kernel_ms"] == 0 and not row["kernel_in_trace"]

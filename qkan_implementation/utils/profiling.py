"""Profiling: stage timers + jax.profiler integration.

The reference instruments with ad-hoc ``time.time()`` prints -- per-stage
breakdowns with percentages and memory footprint (``LCUStep.py:126-161``),
compute-time prints (``QKANLayer.py:203-244``).  This module keeps that
report shape but as a reusable component, and adds ``jax.profiler`` trace
annotation so stages show up on the device timeline.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import jax

#: Where ``device_kernel_times`` writes its traces by default: fixed,
#: inside the checkout, git-ignored.
REPO_TRACE_DIR = Path(__file__).resolve().parents[2] / "results" / "traces"


class StageTimer:
    """Accumulate named stage durations; render the reference-style report.

    >>> timer = StageTimer()
    >>> with timer.stage("weights"): ...
    >>> with timer.stage("circuit"): ...
    >>> print(timer.report(memory_bytes=expected.nbytes))
    """

    def __init__(self, annotate_trace: bool = True):
        self.durations: Dict[str, float] = {}
        self.annotate_trace = annotate_trace

    @contextlib.contextmanager
    def stage(self, name: str):
        ctx = (
            jax.profiler.TraceAnnotation(name)
            if self.annotate_trace
            else contextlib.nullcontext()
        )
        start = time.perf_counter()
        with ctx:
            yield
        self.durations[name] = self.durations.get(name, 0.0) + (
            time.perf_counter() - start
        )

    @property
    def total(self) -> float:
        return sum(self.durations.values())

    def report(self, memory_bytes: Optional[int] = None) -> str:
        """Stage breakdown with percentages (the LCUStep.py:152-161 shape)."""
        lines = ["Breakdown of computation:"]
        total = self.total or 1e-30
        for name, dur in self.durations.items():
            lines.append(f"{name}: {dur:.4f}s ({dur / total * 100:.1f}%)")
        lines.append(f"Total: {total:.4f}s")
        if memory_bytes is not None:
            lines.append(f"Memory footprint: {memory_bytes / 1024 / 1024:.2f} MB")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler device trace around a block.

    View with TensorBoard or xprof; this is the upgrade path from the
    reference's print-based timing.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timeit_chained(fn, x, iters: int = 50, consts: tuple = ()) -> float:
    """Steady-state seconds/call of a shape-preserving ``x -> x`` function.

    ``iters`` dependent calls run as one device-side ``lax.scan`` (one
    dispatch, no host round trip between steps), timed to
    ``block_until_ready`` after a compile call.  ``consts``: large arrays
    the op needs besides ``x`` -- passed as operands rather than closed
    over, so they do not bake into the program as constants.
    """

    @jax.jit
    def chain(x, *cs):
        def body(c, _):
            return fn(c, *cs), None

        return jax.lax.scan(body, x, None, length=iters)[0]

    jax.block_until_ready(chain(x, *consts))  # compile
    start = time.perf_counter()
    jax.block_until_ready(chain(x, *consts))
    return (time.perf_counter() - start) / iters


def stream_kernel_times(trace: dict) -> Dict[str, float]:
    """Total microseconds per kernel name on the GPU streams of a trace.

    ``trace`` is a Chrome trace-event document as ``jax.profiler`` writes
    it (``*.trace.json.gz``): a device is a process named ``/device:GPU:N``
    and each CUDA stream a thread named ``Stream #K(...)``.  The device's
    other lines (XLA ops, modules, steps) repeat the kernels' time and are
    left out.
    """
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    gpu_pids, streams = set(), set()
    for e in events:
        if e.get("ph") != "M":
            continue
        name = e.get("args", {}).get("name", "")
        if e.get("name") == "process_name" and name.startswith("/device:GPU"):
            gpu_pids.add(e["pid"])
        elif e.get("name") == "thread_name" and name.startswith("Stream"):
            streams.add((e["pid"], e["tid"]))
    totals: Dict[str, float] = defaultdict(float)
    for e in events:
        if (
            e.get("ph") == "X"
            and e.get("pid") in gpu_pids
            and (e["pid"], e.get("tid")) in streams
        ):
            totals[e["name"]] += float(e.get("dur", 0.0))
    return dict(totals)


def device_kernel_times(fn, *args, calls: int = 20,
                        log_dir: Optional[str] = None) -> Dict[str, float]:
    """Device milliseconds per call of each kernel ``fn(*args)`` runs.

    Runs ``fn`` once to compile, then ``calls`` times under a
    ``jax.profiler`` trace, and reduces the trace with
    ``stream_kernel_times``.  Host dispatch is not counted, so a kernel of
    a few microseconds is timed as itself.  Empty off the GPU.  The trace
    goes to ``log_dir`` (default ``REPO_TRACE_DIR``).
    """
    log_dir = Path(log_dir or REPO_TRACE_DIR)
    jax.block_until_ready(fn(*args))
    with device_trace(str(log_dir)):
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
    # the newest trace is this one (a run directory is named by the second,
    # so a second trace within it overwrites the first)
    path = max(log_dir.glob("plugins/profile/*/*.trace.json.gz"),
               key=lambda p: p.stat().st_mtime)
    with gzip.open(path, "rt") as f:
        totals = stream_kernel_times(json.load(f))
    return {k: v / calls / 1e3 for k, v in totals.items()}

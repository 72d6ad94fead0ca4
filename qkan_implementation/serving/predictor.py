"""Bucketed batched inference over FixedKAN checkpoints.

XLA compiles one program per input shape, so a production predictor must
pin the set of shapes it serves: requests are padded up to power-of-two
batch buckets (bounded recompiles, amortized by warmup) and results sliced
back.  Tracks simple latency statistics.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp

from qkan_implementation.models.fixed_kan import FixedKAN


class BatchedPredictor:
    def __init__(
        self,
        model: Union[FixedKAN, str],
        max_batch: int = 4096,
        dtype=jnp.float32,
    ):
        if isinstance(model, str):
            model = FixedKAN.load_model(model)
        if model.params is None:
            raise ValueError("Model has no parameters; run optimize() first")
        if not isinstance(max_batch, int) or max_batch < 1:
            raise ValueError(
                f"max_batch must be a positive int, got {max_batch!r}"
            )
        self.model = model
        self.dtype = dtype
        self.max_batch = max_batch
        self.buckets = []
        b = 1
        while b <= max_batch:
            self.buckets.append(b)
            b *= 2
        if self.buckets[-1] != max_batch:
            # non-power-of-two max_batch: keep it as the terminal bucket so
            # every n <= max_batch is servable (one extra compiled shape)
            self.buckets.append(max_batch)
        self._latencies: List[float] = []
        self._served = 0  # monotonically increasing, unlike the trimmed window
        # the HTTP server wraps this in ThreadingHTTPServer: guard the
        # read-modify-write stats (counter increment, window trim) so
        # concurrent requests can't undercount or interleave trims
        self._stats_lock = threading.Lock()
        # reuse the model's own jitted apply: same computation, same jit
        # cache entry as direct FixedKAN calls
        self._apply = model._apply

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"Batch {n} exceeds max_batch {self.max_batch}")

    def warmup(self, input_dim: Optional[int] = None) -> None:
        """Pre-compile every bucket shape (call before taking traffic)."""
        if input_dim is None:
            input_dim = self.model.config.network_shape[0]
        for b in self.buckets:
            x = jnp.zeros((b, input_dim), dtype=self.dtype)
            jax.block_until_ready(self._apply(self.model.params, x))

    def predict(self, inputs) -> np.ndarray:
        # one cast straight to the serving dtype: a float64 predictor must
        # not round-trip its inputs through float32
        x = np.asarray(inputs, dtype=np.dtype(self.dtype))
        if x.ndim == 1:
            x = x[None, :]
        in_dim = self.model.config.network_shape[0]
        if x.ndim != 2 or x.shape[1] != in_dim:
            # without this, a size-1 model input dim silently BROADCASTS
            # against mis-shaped requests via einsum instead of failing
            raise ValueError(
                f"Expected inputs of shape [n, {in_dim}], got {x.shape}"
            )
        n = x.shape[0]
        bucket = self._bucket_for(n)
        if bucket != n:
            x = np.concatenate(
                [x, np.zeros((bucket - n, x.shape[1]), dtype=x.dtype)]
            )
        start = time.perf_counter()
        out = self._apply(self.model.params, jnp.asarray(x))
        out = np.asarray(jax.block_until_ready(out))[:n]
        elapsed = time.perf_counter() - start
        with self._stats_lock:
            self._latencies.append(elapsed)
            self._served += 1
            if len(self._latencies) > 1000:
                del self._latencies[:-1000]
        return out

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            served = self._served
            lat_copy = list(self._latencies)
        if not lat_copy:
            return {"requests": served}
        lat = np.array(lat_copy)
        return {
            "requests": served,
            "latency_mean_ms": float(lat.mean() * 1e3),
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        }

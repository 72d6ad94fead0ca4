"""Serving tests: bucketed predictor + the HTTP endpoint driven over a
real socket."""

import json
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest

from qkan_implementation.models import FixedKAN, FixedKANConfig
from qkan_implementation.serving import BatchedPredictor, serve


@pytest.fixture(scope="module")
def trained_model(tmp_path_factory):
    x = jnp.asarray(np.linspace(-1, 1, 100).reshape(-1, 1))
    y = 0.5 * x**2 + 0.3 * x + 0.1
    kan = FixedKAN(
        FixedKANConfig(
            network_shape=[1, 3, 1],
            max_degree=3,
            degree_objective="penalized_mse",
            complexity_weight=0.001,
            consistent_tanh=True,
        )
    )
    kan.optimize(x, y, solver="exact")
    path = str(tmp_path_factory.mktemp("m") / "model.npz")
    kan.save_model(path)
    return kan, path


def test_predictor_matches_model(trained_model):
    kan, path = trained_model
    pred = BatchedPredictor(path, max_batch=64)
    x = np.linspace(-1, 1, 10).reshape(-1, 1)
    np.testing.assert_allclose(
        pred.predict(x), np.asarray(kan(jnp.asarray(x))), atol=1e-5
    )
    # bucket padding: a batch of 5 pads to 8, output sliced back to 5
    out5 = pred.predict(x[:5])
    assert out5.shape[0] == 5
    stats = pred.stats()
    assert stats["requests"] == 2
    assert stats["latency_mean_ms"] > 0


def test_predictor_rejects_oversize_batch(trained_model):
    _, path = trained_model
    pred = BatchedPredictor(path, max_batch=8)
    with pytest.raises(ValueError):
        pred.predict(np.zeros((9, 1)))


def test_http_server_round_trip(trained_model):
    kan, path = trained_model
    pred = BatchedPredictor(path, max_batch=32)
    server, thread = serve(pred, port=0, background=True)
    try:
        host, port = server.server_address
        base = f"http://{host}:{port}"

        with urllib.request.urlopen(base + "/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"

        x = [[0.5], [-0.25], [0.0]]
        req = urllib.request.Request(
            base + "/predict",
            data=json.dumps({"inputs": x}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as r:
            out = json.loads(r.read())["outputs"]
        expected = np.asarray(kan(jnp.asarray(np.asarray(x))))
        np.testing.assert_allclose(np.asarray(out), expected, atol=1e-5)

        # probe: malformed request -> clean 400, server stays up
        bad = urllib.request.Request(
            base + "/predict", data=b'{"nope": 1}',
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(bad)
            raise AssertionError("expected HTTP 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
        with urllib.request.urlopen(base + "/healthz") as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        server.shutdown()


def test_predictor_non_pow2_max_batch_and_counters(trained_model):
    """Regression quartet: (1) a non-power-of-two max_batch must serve
    every n <= max_batch (a terminal bucket is added) with VALUE-correct
    output; (2) a float64 predictor must feed float64 to the model (spied
    at the apply boundary -- a host-side cast assertion cannot catch an
    internal f32 round-trip); (3) stats()['requests'] counts requests
    served, not the trimmed latency window; (4) mis-shaped inputs are
    rejected instead of silently einsum-broadcast."""
    kan, _ = trained_model
    p = BatchedPredictor(kan, max_batch=100)
    assert p.buckets[-1] == 100
    x = np.random.default_rng(0).uniform(-1, 1, (70, 1))
    out = p.predict(x)  # terminal (100) bucket: pad to 100, slice to 70
    assert out.shape[0] == 70
    np.testing.assert_allclose(
        out, np.asarray(kan(jnp.asarray(x))), atol=1e-5
    )
    with pytest.raises(ValueError):
        p.predict(np.zeros((101, 1)))
    with pytest.raises(ValueError, match="shape"):
        p.predict(np.zeros((4, 2)))  # wrong feature count

    p64 = BatchedPredictor(kan, max_batch=8, dtype=jnp.float64)
    seen = {}
    orig_apply = p64._apply

    def spy(params, xp):
        seen["dtype"] = xp.dtype
        return orig_apply(params, xp)

    p64._apply = spy
    fine = np.full((1, 1), 0.1234567890123456, dtype=np.float64)
    p64.predict(fine)
    assert seen["dtype"] == jnp.float64, seen

    before = p.stats()["requests"]
    for _ in range(3):
        p.predict(x[:2])
    assert p.stats()["requests"] == before + 3


def test_predictor_rejects_bad_max_batch(trained_model):
    """max_batch < 1 is a config error, not an IndexError (review r3)."""
    kan, _ = trained_model
    for bad in (0, -4):
        with pytest.raises(ValueError, match="max_batch"):
            BatchedPredictor(kan, max_batch=bad)


def test_predictor_stats_thread_safe(trained_model):
    """Concurrent predict() calls (the ThreadingHTTPServer model) must not
    lose counter increments: 4 threads x 25 requests == 100 served."""
    import threading

    kan, _ = trained_model
    pred = BatchedPredictor(kan, max_batch=8)
    pred.warmup()
    errs = []

    def worker():
        try:
            for _ in range(25):
                pred.predict(np.zeros((3, 1)))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert pred.stats()["requests"] == 100

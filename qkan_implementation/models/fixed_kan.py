"""FixedKAN: cumulative-Chebyshev KAN with QUBO-selected degrees, in JAX.

JAX rebuild of ``KAN_w_cumulative_polynomials.py`` (reference
``:13-598``).  Parameters are a pytree (list of per-layer dicts), the forward
pass is one fused einsum per layer, degree search is a vmappable lstsq sweep
+ the on-device annealer, and -- beyond the reference, which trains only the
per-neuron ``horizontal_weight`` scalars (``:309-333``) -- the whole model is
differentiable end-to-end with ``jax.grad``.

Reference semantics replicated exactly (pinned by tests):

- every layer's neurons are fit against the *same* target ``y`` (reference
  ``FixedKAN.optimize:335-353`` passes y_data to every layer), so each
  layer maps [B, in] -> [B, target_dim];
- the fit-time transform is computed on the raw layer input while the
  forward pass applies ``tanh`` first (reference ``KANLayer.optimize_degrees
  :133`` vs ``KANNeuron.forward:79``) -- an inconsistency the reference's
  accuracy numbers bake in; ``consistent_tanh=True`` in the config fixes it;
- Chebyshev evaluation is unclipped polynomial recurrence, like
  ``torch.special.chebyshev_polynomial_t``;
- degree selection solves the same QUBO (improvement reward, cw*d^2 penalty,
  one-hot penalty 10) with num_reads annealing chains.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.ops.chebyshev import chebyshev_basis
from qkan_implementation.anneal import (
    degree_selection_qubo,
    solve_qubo,
)


@dataclass
class FixedKANConfig:
    """Configuration for the fixed-architecture KAN.

    Mirror of the reference ``FixedKANConfig``
    (KAN_w_cumulative_polynomials.py:13-18) plus build-specific options.
    """

    network_shape: List[int]
    max_degree: int
    complexity_weight: float = 0.1
    # -- build extensions (default to reference-faithful behavior) ----------
    consistent_tanh: bool = False  # fit on tanh(x) like the forward pass does
    degree_objective: str = "reference"  # or 'penalized_mse' (see anneal.qubo)
    # 'svd' (reference min-norm semantics) | 'normal' (Gram/Cholesky
    # fast path; big-F f32 layers auto-route to 'qr') | 'qr' (one
    # Householder QR serves every cumulative degree; backward-stable where
    # f32 Cholesky breaks, 2x closer to exact than the f32 SVD)
    lstsq_method: str = "svd"
    lstsq_ridge: float = 1e-8  # ridge for the normal-equations path
    # row cap for use_quantum=True (block-encoding circuit size is set by
    # max(rows, cols) padded to a power of two); 0/None disables the cap
    quantum_sample_cap: int = 256
    # optional matmul input dtype for the forward pass ('bfloat16'): the
    # bf16io mixed-precision inference recipe -- bf16 multiplies, f32
    # accumulation (kan_layer_apply).  None = exact f32/f64 semantics.
    # 'int8' selects the quantized serving path (inference-only; training
    # methods always run the f32 kan_apply regardless of this flag).
    # Both recipes are for NARROW layers: at wide fan-in their per-product
    # error accumulates over thousands of terms.
    compute_dtype: Optional[str] = None
    # precision policy for the f32 forward matmul: 'auto' resolves per
    # layer by fan-in (kan_layer_apply); None = device default everywhere
    forward_matmul_precision: Optional[str] = "auto"

    #: Named switch bundles for the reference-faithful-vs-fixed behaviors.
    #: 'reference' keeps the dataclass defaults (every reference quirk
    #: pinned by the faithfulness golden tests: tanh fit/forward mismatch,
    #: degenerate degree reward in the QUBO objective, svd lstsq).
    #: 'recommended' enables the documented fixes + the Gram/Cholesky
    #: solve -- the bundle the YAML experiment harness runs with.
    PRESETS = {
        "reference": {},
        "recommended": {
            "consistent_tanh": True,
            "degree_objective": "penalized_mse",
            "lstsq_method": "normal",
        },
    }

    # FixedKAN.train(**kwargs) bundles for the same two philosophies.
    # 'reference' keeps its trainer semantics (horizontal scalars only,
    # constant lr, no clipping -- reference :309-333); 'recommended' is
    # the measured flagship recipe (docs/benchmarks.md quality table:
    # full-gradient refinement, fan-in-scaled lr, clip 1.0, 30-epoch
    # cosine schedule -- 0.886 +- 0.008 on the CPU).  Merge explicit choices
    # over the bundle: kan.train(x, y, **{**TRAIN_PRESETS['recommended'],
    # 'epochs': 15}).
    TRAIN_PRESETS = {
        "reference": {
            "trainable": "horizontal",
            "lr_scale": "none",
            "lr_schedule": "none",
            "grad_clip": None,
        },
        "recommended": {
            "trainable": "all",
            "lr_scale": "fanin",
            "lr_schedule": "cosine",
            "grad_clip": 1.0,
            "learning_rate": 0.002,
            "epochs": 30,
        },
    }

    @classmethod
    def preset(
        cls, name: str, network_shape: List[int], max_degree: int, **overrides
    ) -> "FixedKANConfig":
        """Build a config from a named preset; explicit overrides win."""
        if name not in cls.PRESETS:
            raise ValueError(
                f"Unknown preset {name!r}; choose from {sorted(cls.PRESETS)}"
            )
        kwargs = {**cls.PRESETS[name], **overrides}
        return cls(
            network_shape=network_shape, max_degree=max_degree, **kwargs
        )


def _lstsq(X: jax.Array, y: jax.Array, method: str, ridge: float) -> jax.Array:
    """Least-squares solve, [B, F] x [B, T] -> [F, T].

    'svd' matches torch.linalg.lstsq / np.linalg.lstsq min-norm semantics
    (reference KANLayer._optimize_coefficients_classical:190-193); 'normal'
    solves the ridge-regularized normal equations with Cholesky -- plain
    matmuls, the fast path.
    """
    # Solve-path matmuls pin full-f32 multiplies: a default-precision f32
    # dot may run in TF32 on the GPU (~1e-3/term multiply noise) and the
    # Gram system is conditioned near 1/ridge, so that noise would be
    # amplified into O(10%) coefficient error.  The SOLVES are where
    # precision buys fit quality.
    if method == "svd":
        with jax.default_matmul_precision("highest"):
            return jnp.linalg.lstsq(X, y)[0]
    if method == "normal":
        with jax.default_matmul_precision("highest"):
            f = X.shape[1]
            gram = X.T @ X
            scale = jnp.trace(gram) / f + 1e-30
            gram = gram + (ridge * scale) * jnp.eye(f, dtype=X.dtype)
            return jax.scipy.linalg.solve(gram, X.T @ y, assume_a="pos")
    raise ValueError(f"Unknown lstsq method {method!r}")


from functools import lru_cache


# Relative ridge floor for the f32 QR degree sweep.  Measured on the
# flagship layer-0 (F=4704, upsampled-digits data, f32, one refinement
# step): train-MSE 0.0289 at d=5 with max|c| ~ 7 vs 0.0495 for the f32
# SVD path (whose default rcond ~ B*eps ~ 1e-3 truncates informative
# directions; 0.0188 exact f64).  A hard R-diagonal DROP fits tighter
# (0.0234) but with max|c| ~ 2e5 -- coefficients that large turn bf16
# serving noise (~8e-3 relative per term) into O(1) output error, so the
# small-norm ridge solution is the production choice.
_QR_RIDGE_F32 = 1e-6


def _dim_major(c, k: int, d: int, in_dim: int, t_dim: int):
    """Reorder a degree-major solution's leading-block rows into the
    dim-major layout the forward pass stores: [d+1, in, T] -> [in, d+1, T]
    flattened to [k, T].  Shared by the gram and QR sweeps so the two
    solver paths cannot diverge in layout."""
    return jnp.swapaxes(
        c[:k].reshape(d + 1, in_dim, t_dim), 0, 1
    ).reshape(k, t_dim)


@lru_cache(maxsize=64)
def _layer_qr_kernels(dp1: int, in_dim: int, ridge: float):
    """Two cached jitted kernels for the ridge-augmented QR degree sweep.

    ``qr_fn`` factors the stacked matrix [X; sqrt(lam) I] (Householder,
    R-only): its leading [k, k] R block satisfies R_k'R_k = X_k'X_k +
    lam*I exactly, so ONE factorization serves every cumulative degree --
    and unlike the Gram Cholesky (which NaNs once eps_f32 * F exceeds the
    relative ridge) QR is backward-stable at any size, letting the ridge
    sit at 1e-6 instead of the 1e-2 a big-F f32 Cholesky would need.
    ``solve_fn`` runs two masked triangular solves (block size is a
    traced scalar -- one executable for all degrees) plus one iterative-
    refinement step against the UNRIDGED normal equations, and scores
    with the honest full-data MSE."""

    @jax.jit
    def qr_fn(basis, y):
        with jax.default_matmul_precision("highest"):
            b = basis.shape[0]
            f = dp1 * in_dim
            X = jnp.swapaxes(basis, 1, 2).reshape(b, f)
            lam = ridge if basis.dtype != jnp.float32 else max(
                ridge, _QR_RIDGE_F32
            )
            s = jnp.sqrt(lam * jnp.sum(X * X) / f)
            Xa = jnp.concatenate([X, s * jnp.eye(f, dtype=X.dtype)], axis=0)
            R = jnp.linalg.qr(Xa, mode="r")
            bvec = X.T @ y
            return X, R, bvec

    @jax.jit
    def solve_fn(X, R, bvec, y, k):
        with jax.default_matmul_precision("highest"):
            n = R.shape[0]
            m = jnp.arange(n) < k
            # rows/cols >= k become identity with zero rhs -> c[k:] == 0
            # exactly, so one full-size pair of triangular solves serves
            # every leading block
            Rm = jnp.where(
                m[:, None] & m[None, :], R, jnp.eye(n, dtype=R.dtype)
            )

            def rsolve(v):
                z = jax.scipy.linalg.solve_triangular(
                    Rm.T, jnp.where(m[:, None], v, 0.0), lower=True
                )
                return jax.scipy.linalg.solve_triangular(
                    Rm, z, lower=False
                )

            bm = jnp.where(m[:, None], bvec, 0.0)
            c = rsolve(bm)
            # one refinement step against the unridged system cancels
            # most of the ridge bias on the well-conditioned directions
            c = c + rsolve(bm - X.T @ (X @ c))
            res = jnp.mean((y - X @ c) ** 2)
            return c, res

    return qr_fn, solve_fn


@lru_cache(maxsize=64)
def _layer_gram_kernels(dp1: int, in_dim: int, ridge: float):
    """Two cached jitted kernels per (degrees, input-dim) shape: a Gram
    pass over the degree-major design matrix, and a masked leading-block
    Cholesky solve with a traced block size (one executable serves every
    cumulative degree)."""

    # full-f32 multiplies throughout the solve path (see _lstsq: Gram
    # conditioning ~1/ridge amplifies default-precision multiply noise
    # into large coefficient error)
    @jax.jit
    def gram_fn(basis, y):
        with jax.default_matmul_precision("highest"):
            b = basis.shape[0]
            X = jnp.swapaxes(basis, 1, 2).reshape(b, dp1 * in_dim)
            return X.T @ X, X.T @ y, jnp.sum(y**2)

    @jax.jit
    def solve_fn(G, bvec, yy, k):
        with jax.default_matmul_precision("highest"):
            n = G.shape[0]
            r = jnp.arange(n)
            m = r < k
            mm = m[:, None] & m[None, :]
            scale = jnp.trace(G) / n + 1e-30
            Gm = jnp.where(mm, G, 0.0) + jnp.diag(
                jnp.where(m, ridge * scale, 1.0)
            )
            Gu = jnp.where(mm, G, 0.0)  # unridged masked block
            bm = jnp.where(m[:, None], bvec, 0.0)
            cho = jax.scipy.linalg.cho_factor(Gm)
            c = jax.scipy.linalg.cho_solve(cho, bm)
            # one iterative-refinement step against the UNRIDGED system:
            # cancels most of the ridge bias while keeping the stable
            # factorization (matters at the f32 ridge floor)
            c = c + jax.scipy.linalg.cho_solve(cho, bm - Gu @ c)
            # residual: yy - 2 c'b + c'Gc over the block
            Gc = Gu @ c
            res = yy - 2.0 * jnp.sum(c * bm) + jnp.sum(c * Gc)
            return c, res

    return gram_fn, solve_fn


# Fan-in from which a layer's contraction counts as wide: the precision
# policy (``_resolve_forward_precision``) and the choice of the fused GPU
# kernel (``choose_layer_backend``) both key off it.  Flagship layer 0 has
# fan-in 784*6 = 4704; its hidden layers have 10*6 = 60.
_FORWARD_PRECISION_MIN_FANIN = 512

# What 'auto' resolves to at wide fan-in, and for training: the cheapest
# precision whose flagship test accuracy matched full f32 within two test
# images on every seed (benchmarks/eval_precision_probe.py; PERF.md).  On
# the GPU the f32 default is TF32: it matched for training but cost up to
# three images in evaluation, where three bf16 passes matched exactly.
# The CPU multiplies in exact f32 under every setting.
_WIDE_LAYER_PRECISION = "BF16_BF16_F32_X3"
_TRAIN_PRECISION = None


def _resolve_forward_precision(matmul_precision, fan_in: int, dtype):
    """'auto' -> ``_WIDE_LAYER_PRECISION`` for a wide f32 layer, the device
    default otherwise (an f64 layer would lose accuracy to bf16 passes)."""
    if matmul_precision == "auto":
        wide = fan_in >= _FORWARD_PRECISION_MIN_FANIN
        return (
            _WIDE_LAYER_PRECISION
            if wide and jnp.dtype(dtype) == jnp.float32
            else None
        )
    return matmul_precision


def _kernel_mode(precision) -> str | None:
    """The fused kernel's mode that computes what XLA computes at this
    matmul precision, or None when the kernel has no such mode."""
    if precision in (None, "default"):
        return "default"
    if precision == "BF16_BF16_F32_X3":
        return "bf16x3"
    return None


def choose_layer_backend(fan_in: int, compute_dtype, precision,
                         dtype) -> str:
    """The layer backend for this input: 'fused' (``ops.fused_layer``) on
    a GPU for a wide f32 layer at a precision the kernel has, 'xla'
    otherwise.  ``dtype`` is the layer's result dtype: the kernel computes
    in f32, so an f64 layer stays on XLA.  The fused kernel keeps the
    Chebyshev basis out of device memory, which is what bounds a wide
    layer; a narrow layer's basis is small and XLA's cuBLAS call is as
    fast (PERF.md, kernel decisions)."""
    if (
        jax.default_backend() == "gpu"
        and compute_dtype is None
        and jnp.dtype(dtype) == jnp.float32
        and fan_in >= _FORWARD_PRECISION_MIN_FANIN
        and _kernel_mode(precision) is not None
    ):
        return "fused"
    return "xla"


def kan_layer_apply(
    layer_params: dict,
    x: jax.Array,
    max_degree: int,
    compute_dtype=None,
    backend: str = "auto",
    matmul_precision: str | None = "auto",
) -> jax.Array:
    """Apply one KAN layer: [B, in] -> [B, target_dim].

    y = sum_o hw_o * (cumulative_transform(tanh(x))[<=d_o] @ C_o), the fused
    form of the reference's per-neuron loop (KANLayer.forward:180-188,
    KANNeuron.forward:72-82).

    ``compute_dtype``: optional matmul input dtype for mixed-precision
    inference (the layer-op bf16io recipe): the FINAL einsum operands are
    cast (cast placement matters -- see ops/qkan_layer.py) and
    accumulation stays f32.  Output returns in f32.

    ``compute_dtype=jnp.int8`` selects the quantized SERVING path (same
    scheme as ``ops.qkan_layer_forward_batched_int8``: the basis is
    analytically bounded in [-1, 1] because it is Chebyshev-of-tanh, so a
    static 127 activation scale is exact; weights get a per-target-channel
    symmetric scale; int32 accumulation).  Inference-only -- rounding has
    zero gradient.  'int8x2'/'int8x2w' are its two-level residual variants
    (``ops.qkan_layer.int8_residual_matmul``).

    ``backend``: 'auto' picks per layer (``choose_layer_backend``); 'xla'
    builds the basis and calls one matmul; 'fused' runs the GPU kernel of
    ``ops.fused_layer`` (in interpret mode off the GPU) on f32 inputs and
    weights only, at the precision 'default' or 'BF16_BF16_F32_X3'.

    ``matmul_precision`` governs the f32 layer matmul.  'auto' pins
    ``_WIDE_LAYER_PRECISION`` on layers whose fan-in in*(D+1) reaches
    ``_FORWARD_PRECISION_MIN_FANIN`` and keeps the device default below
    it; ``None`` defers to the ambient ``jax.default_matmul_precision``;
    any other value is a JAX precision name ('highest' is full f32).
    Ignored by the int8/bf16io recipes (their precision is the recipe).
    """
    if backend not in ("auto", "xla", "fused"):
        raise ValueError(
            f"unknown backend {backend!r}: expected 'auto', 'xla' or 'fused'"
        )
    degs = layer_params["degrees"]  # [out]
    mask = (
        jnp.arange(max_degree + 1)[None, :] <= degs[:, None]
    )  # [out, D+1]
    coeffs = layer_params["coefficients"]  # [out, in, D+1, T]
    hw = layer_params["horizontal_weights"]  # [out]
    fan_in = coeffs.shape[1] * (max_degree + 1)
    dtype = jnp.result_type(x, coeffs)
    prec = _resolve_forward_precision(matmul_precision, fan_in, dtype)
    # the precision this layer's matmul runs at, ambient context included
    effective = prec if prec is not None else (
        jax.config.jax_default_matmul_precision
    )
    if backend == "auto":
        backend = choose_layer_backend(fan_in, compute_dtype, effective, dtype)
    if backend == "fused":
        if compute_dtype is not None or jnp.dtype(dtype) != jnp.float32:
            raise ValueError(
                f"backend='fused' computes in f32 only (layer dtype {dtype}, "
                f"compute_dtype {compute_dtype})"
            )
        from qkan_implementation.ops.fused_layer import kan_layer_fused

        # degree-major [dp1*in, T] fold for the kernel's layout
        w_dm = jnp.einsum(
            "oidt,od->dit", coeffs, mask.astype(coeffs.dtype) * hw[:, None]
        ).reshape(-1, coeffs.shape[-1])
        mode = _kernel_mode(effective)
        if mode is None:
            raise ValueError(
                f"backend='fused' has no mode for precision {effective!r}"
            )
        out = kan_layer_fused(
            x, w_dm, max_degree + 1, mode,
            interpret=jax.default_backend() != "gpu",
        )
        return out
    t = jnp.tanh(x)
    basis = chebyshev_basis(t, max_degree, clip=False)  # [B, in, D+1]
    # basis carries no `o` axis, so sum_o(coeffs * mask * hw) collapses the
    # whole layer to ONE [B, in*(D+1)] @ [in*(D+1), T] matmul.  The
    # collapse is batch-independent (out*in*(D+1)*T flops, ~1.5M at the
    # flagship layer-0) while the naive bid,oidt->bt reduction pays an
    # `out`-fold redundant per-batch contraction: 32x the flops at
    # [784 -> 32].
    b = x.shape[0]
    W = jnp.einsum(
        "oidt,od->idt", coeffs, mask.astype(coeffs.dtype) * hw[:, None]
    ).reshape(-1, coeffs.shape[-1])  # [in*(D+1), T]
    if compute_dtype is None:
        # precision=None defers to the ambient default, so this composes
        # with (and is consistent under) train()'s precision context
        return jnp.matmul(basis.reshape(b, -1), W, precision=prec)
    if compute_dtype in ("int8x2", "int8x2w"):
        from qkan_implementation.ops.qkan_layer import (
            int8_residual_matmul,
        )

        return int8_residual_matmul(
            basis.reshape(b, -1), W,
            acts_residual=compute_dtype == "int8x2",
        )
    if jnp.dtype(compute_dtype) == jnp.int8:
        from qkan_implementation.ops.qkan_layer import (
            int8_quantized_matmul,
        )

        if W.shape[0] >= _FORWARD_PRECISION_MIN_FANIN:
            import warnings

            # per-element ~4e-3 quantization noise random-walks through a
            # wide contraction into O(1) logit error; the recipe is sound
            # only at narrow fan-in (the ~1e-3 relative error the tests pin
            # is an N=16-scale number)
            warnings.warn(
                f"int8 serving at fan-in {W.shape[0]} >= "
                f"{_FORWARD_PRECISION_MIN_FANIN}: quantization noise at "
                "this contraction width can cost most of the model's "
                "accuracy; use compute_dtype=None",
                stacklevel=2,
            )
        return int8_quantized_matmul(basis.reshape(b, -1), W)
    # bf16io: cast the FINAL dot operands only (after reshape -- the
    # cast-placement rule of ops/qkan_layer.py), accumulate f32
    return jax.lax.dot_general(
        basis.reshape(b, -1).astype(compute_dtype),
        W.astype(compute_dtype),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def kan_apply(
    params: list,
    x: jax.Array,
    max_degree: int,
    compute_dtype=None,
    backend: str = "auto",
    matmul_precision: str | None = "auto",
) -> jax.Array:
    """Full forward pass through all layers (FixedKAN.forward:369-374)."""
    current = x
    for layer_params in params:
        current = kan_layer_apply(
            layer_params, current, max_degree, compute_dtype, backend,
            matmul_precision,
        )
    return current


class FixedKAN:
    """Stateful convenience wrapper around the pure param-pytree functions."""

    def __init__(self, config: FixedKANConfig):
        self.config = config
        self.params: Optional[list] = None
        self.last_train_diverged = False
        self.last_train_losses: list = []
        # resolved by train(); None means "never trained" (reading it
        # before train() used to raise AttributeError -- ADVICE r4)
        self.last_matmul_precision: Optional[str] = None
        # 'int8x2'/'int8x2w' are recipe sentinels (two-level residual
        # int8 serving, ops.qkan_layer.int8_residual_matmul), not dtypes
        cd = (
            config.compute_dtype
            if config.compute_dtype in ("int8x2", "int8x2w")
            else jnp.dtype(config.compute_dtype)
            if config.compute_dtype
            else None
        )
        self._apply = jax.jit(
            partial(
                kan_apply,
                max_degree=config.max_degree,
                compute_dtype=cd,
                matmul_precision=config.forward_matmul_precision,
            ),
        )

    # -- structure optimization ------------------------------------------
    def _evaluate_layer_degrees(self, x_fit: jax.Array, y: jax.Array):
        """Per-cumulative-degree lstsq + MSE scores.

        Equivalent of the (neuron x degree) loop in
        KANLayer.optimize_degrees (reference :127-146); since every neuron
        shares the same transform and target, one solve per degree suffices.
        Returns (scores [D+1], coeffs list of [in*(d+1), T] in dim-major
        layout).

        With ``lstsq_method='normal'`` the whole sweep is two compiled
        kernels: one Gram/statistics pass, and one masked leading-block
        Cholesky solve whose block size is a *traced* scalar -- every
        cumulative degree reuses the same executable (compile count stays
        constant in max_degree; residuals via the quadratic-form identity).
        """
        cfg = self.config
        basis = chebyshev_basis(x_fit, cfg.max_degree, clip=False)
        b = basis.shape[0]
        in_dim = basis.shape[1]
        dp1 = cfg.max_degree + 1
        if cfg.lstsq_method == "qr":
            if b < dp1 * in_dim:
                # underdetermined: keep the reference's min-norm SVD
                # semantics (a deliberate choice -- the ridge-augmented
                # stack is square for any b, so QR WOULD run, but its
                # ridge solution differs from min-norm in this regime)
                return self._svd_fallback(basis, y)
            return self._qr_sweep(basis, y)
        if cfg.lstsq_method != "normal":
            return self._svd_fallback(basis, y, method=cfg.lstsq_method)

        t_dim = y.shape[1]
        # The design matrix is structurally rank-deficient (T_0 of every
        # input dim is the same all-ones column), so the Cholesky needs a
        # ridge above the working precision's conditioning floor: 1e-8
        # is fine at f64 but NaNs the factorization at f32.
        ridge = float(cfg.lstsq_ridge)
        if basis.dtype == jnp.float32:
            # f32 Cholesky breaks down around cond ~ 1/eps ~ 8e6; the
            # trace-scaled spectrum spans ~n/ridge, so ridge must sit near
            # 1e-4 for the flagship shapes (n = (D+1)*in_dim ~ 64-320) or
            # the factorization NaNs and the whole sweep silently falls
            # back to the SVD path (paying Gram + SVD, slower than SVD
            # alone).  The bias this adds is ~1e-4 relative -- scoring
            # noise, not fit-quality noise ('svd' remains the exact path).
            ridge = max(ridge, 1e-4)
            # f32 Cholesky breakdown is also a SIZE effect: the factor's
            # rounding error grows ~ eps * F * lambda_max, so once
            # eps_f32 * F exceeds the relative ridge the factorization
            # NaNs regardless of data (measured: F=4704 NaNs at ridge
            # 1e-4 AND 1e-3, factors at 1e-2 -- but that ridge costs real
            # fit quality).  Route those layers straight to the
            # backward-stable QR sweep (or min-norm SVD when
            # underdetermined) instead of paying Gram + fallback.  The
            # 2.4e-7 constant (2 eps_f32) brackets the measured band:
            # F=4704 gives 1.13e-3 -- above the NaNing ridge 1e-3, below
            # the factoring 1e-2 -- while F<=832 stays under the 1e-4
            # floor, preserving the Gram route for every default shape.
            if dp1 * in_dim * 2.4e-7 > ridge:
                if b >= dp1 * in_dim:
                    return self._qr_sweep(basis, y)
                return self._svd_fallback(basis, y)
        gram_fn, solve_fn = _layer_gram_kernels(dp1, in_dim, ridge)
        # degree-major columns so cumulative degrees are leading blocks
        G, bvec, yy = gram_fn(basis, y)
        scores, coeffs = [], []
        for d in range(dp1):
            k = (d + 1) * in_dim
            c, res = solve_fn(G, bvec, yy, k)
            # res pools squared residuals over B rows AND T target
            # columns: normalize by both so the score is the same
            # mean((y - pred)**2) the svd and quantum paths report
            scores.append(max(float(res), 0.0) / (b * t_dim))
            coeffs.append(_dim_major(c, k, d, in_dim, t_dim))
        if not np.all(np.isfinite(scores)):
            # conditioning defeated the fast path: fall back to the
            # backward-stable QR sweep (or SVD when underdetermined)
            # rather than silently selecting degrees from NaN scores
            if b >= dp1 * in_dim:
                return self._qr_sweep(basis, y)
            return self._svd_fallback(basis, y)
        return np.array(scores), coeffs

    def _qr_sweep(self, basis: jax.Array, y: jax.Array):
        """One-QR-all-degrees scoring: ridge-augmented Householder QR of
        the degree-major design matrix (backward-stable at f32 where the
        Gram Cholesky breaks down), two masked triangular solves + one
        unridged refinement per cumulative degree, honest full-data MSE
        scores.  Requires rows >= columns.

        Quality (flagship layer-0, F=4704, f32): train-MSE 0.0289 at d=5
        with max|c| ~ 7 vs 0.0495 for the f32 SVD fallback (0.0188 exact
        f64) -- closer to exact than SVD at ~8x less compute (one QR vs
        six SVDs; see docs/benchmarks.md structure-search section)."""
        cfg = self.config
        in_dim = basis.shape[1]
        dp1 = cfg.max_degree + 1
        t_dim = y.shape[1]
        qr_fn, solve_fn = _layer_qr_kernels(
            dp1, in_dim, float(cfg.lstsq_ridge)
        )
        X, R, bvec = qr_fn(basis, y)
        scores, coeffs = [], []
        for d in range(dp1):
            k = (d + 1) * in_dim
            c, res = solve_fn(X, R, bvec, y, k)
            scores.append(float(res))
            coeffs.append(_dim_major(c, k, d, in_dim, t_dim))
        if not np.all(np.isfinite(scores)):
            # never hand NaN scores to QUBO degree selection
            return self._svd_fallback(basis, y)
        return np.array(scores), coeffs

    def _svd_fallback(self, basis: jax.Array, y: jax.Array, method: str = "svd"):
        """Per-degree lstsq sweep over a precomputed [B, in, D+1] basis:
        the 'svd' scoring path, and the last-resort fallback of the
        'normal'/'qr' fast paths.

        The in_dim T_0 columns of every design matrix are one and the same
        all-ones column.  They are solved as ONE column ``sqrt(in) * 1``
        whose coefficient is then shared evenly: the even split is the
        min-norm way to share a sum, so this IS the min-norm solution of
        the full system.  It also removes the exact rank deficiency on
        which LAPACK's SVD (CPU build of JAX 0.9) returns NaN singular
        vectors for some shapes -- the [600, 64] all-ones degree-0 block of
        the 8x8 digits data, which used to turn every coefficient of the
        model into NaN."""
        cfg = self.config
        b, in_dim, _ = basis.shape
        root = float(np.sqrt(in_dim))
        ones = jnp.full((b, 1), root, dtype=basis.dtype)
        scores, coeffs = [], []
        for d in range(cfg.max_degree + 1):
            X_d = jnp.concatenate(
                [ones, basis[:, :, 1 : d + 1].reshape(b, -1)], axis=1
            )
            c = _lstsq(X_d, y, method, cfg.lstsq_ridge)
            pred = X_d @ c
            scores.append(float(jnp.mean((y - pred) ** 2)))
            # back to the dim-major [in*(d+1), T] layout of the forward pass
            c0 = jnp.broadcast_to(c[:1] / root, (in_dim, 1, c.shape[1]))
            rest = c[1:].reshape(in_dim, d, c.shape[1])
            coeffs.append(
                jnp.concatenate([c0, rest], axis=1).reshape(-1, c.shape[1])
            )
        return np.array(scores), coeffs

    def _evaluate_layer_degrees_quantum(self, x_fit: jax.Array, y: jax.Array):
        """Quantum-verified coefficient solves: the design matrix for each
        cumulative degree is FABLE-encoded, recovered column-by-column from
        circuit simulations, and used for the solve -- the realized version
        of the reference's commented-out ``_optimize_coefficients_quantum``
        (KAN_w_cumulative_polynomials.py:194-235).  Tracks resources per
        degree in ``self.last_quantum_resources``.

        Cost control (VERDICT r1 item 2): only the F*(d+1) needed columns
        are simulated (``quantum_extract_block_columns``, O(cols * 2^(2m+1))
        vs the round-1 full-unitary O(4^(2m+1))), and rows are capped at
        ``config.quantum_sample_cap`` (evenly strided subsample) so the
        circuit size stays bounded; the recovered-matrix fit is then scored
        on the FULL data classically.
        """
        from qkan_implementation.ops.quantum import (
            quantum_extract_block_columns,
        )

        cfg = self.config
        basis = chebyshev_basis(x_fit, cfg.max_degree, clip=False)
        b = basis.shape[0]
        cap = cfg.quantum_sample_cap
        sub = (
            np.linspace(0, b - 1, cap).round().astype(int)
            if cap and b > cap
            else np.arange(b)
        )
        y_np = np.asarray(y)
        scores, coeffs = [], []
        for d in range(cfg.max_degree + 1):
            X = np.asarray(basis[:, :, : d + 1].reshape(b, -1))
            X_sub = X[sub]
            # the returned circuit is the one actually simulated -- no
            # second FABLE build just for resource accounting
            X_rec, circuit, alpha = quantum_extract_block_columns(
                X_sub, return_encoding=True
            )
            self.last_quantum_resources.append(
                {
                    "n_qubits": circuit.num_qubits,
                    "circuit_depth": circuit.depth(),
                    "gate_count": circuit.gate_count,
                    "alpha_scaling": float(alpha),
                    "rows_encoded": int(len(sub)),
                    "columns_simulated": int(X.shape[1]),
                }
            )
            c = np.linalg.lstsq(X_rec, y_np[sub], rcond=None)[0]
            pred = X @ c  # score the quantum-fit coefficients on full data
            scores.append(float(np.mean((y_np - pred) ** 2)))
            coeffs.append(jnp.asarray(c))
        return np.array(scores), coeffs

    def optimize(
        self,
        x_data,
        y_data,
        num_reads: int = 1000,
        num_sweeps: int = 1000,
        seed: int = 0,
        solver: str = "anneal",
        use_quantum: bool = False,
        mesh=None,
    ) -> None:
        """QUBO degree selection, layer by layer (FixedKAN.optimize:335-353).

        ``solver``: 'anneal' runs the batched on-device annealer with one-hot
        polish (the neal-equivalent path); 'exact' takes the blockwise
        optimum directly (the QUBO is per-neuron separable).

        ``use_quantum``: route the per-degree coefficient solves through the
        FABLE block-encoding simulator (the path the reference sketches but
        comments out, KAN_w_cumulative_polynomials.py:194-235), recording
        per-solve quantum resources in ``self.last_quantum_resources``.

        ``mesh``: data-parallel structure search.  The dataset rows shard
        over the mesh's first axis: the Gram pass contracts the sharded
        row dimension, so XLA inserts one psum per layer and every device
        scores its shard locally (SURVEY section 2: data parallelism for
        lstsq degree evaluation); with solver='anneal' the annealing
        chains additionally shard across the mesh (chain parallelism)
        before the one-hot polish.  The big-F QR sweep gathers rows (a
        distributed TSQR is not implemented); row counts not divisible by
        the mesh axis stay unsharded.
        """
        cfg = self.config
        x = jnp.asarray(x_data)
        y = jnp.asarray(y_data)
        if y.ndim == 1:
            y = y[:, None]
        if mesh is not None:
            if x.shape[0] % mesh.shape[mesh.axis_names[0]] == 0:
                from jax.sharding import NamedSharding, PartitionSpec

                rows = lambda a: NamedSharding(
                    mesh,
                    PartitionSpec(
                        mesh.axis_names[0], *([None] * (a.ndim - 1))
                    ),
                )
                x = jax.device_put(x, rows(x))
                y = jax.device_put(y, rows(y))
            else:
                # documented degradation, but never a SILENT one (train()
                # raises for the same condition -- keep the asymmetry
                # visible)
                import warnings

                warnings.warn(
                    f"row count {x.shape[0]} not divisible by mesh axis "
                    f"{mesh.axis_names[0]!r} "
                    f"({mesh.shape[mesh.axis_names[0]]} devices): "
                    "structure search runs unsharded"
                )

        params = []
        current = x
        dp1 = cfg.max_degree + 1
        self.last_quantum_resources = [] if use_quantum else None
        for layer_idx in range(len(cfg.network_shape) - 1):
            out_dim = cfg.network_shape[layer_idx + 1]
            x_fit = jnp.tanh(current) if cfg.consistent_tanh else current
            if use_quantum:
                scores, coeffs = self._evaluate_layer_degrees_quantum(x_fit, y)
            else:
                scores, coeffs = self._evaluate_layer_degrees(x_fit, y)

            model = degree_selection_qubo(
                scores,
                num_functions=out_dim,
                complexity_weight=cfg.complexity_weight,
                objective=cfg.degree_objective,
            )
            if solver == "anneal" and mesh is not None:
                from qkan_implementation.anneal.sa import (
                    polish_one_hot_blocks,
                    simulated_annealing_sharded,
                )

                # pre-polish energies are recomputed after the one-hot
                # polish; the sampler's own energies don't enter selection
                samples, _ = simulated_annealing_sharded(
                    model,
                    mesh,
                    axis_name=mesh.axis_names[0],
                    num_reads=num_reads,
                    num_sweeps=num_sweeps,
                    seed=seed + layer_idx,
                )
                samples = polish_one_hot_blocks(model, samples, dp1)
                sample = samples[int(np.argmin(model.energy(samples)))]
            elif solver == "anneal":
                sample, _ = solve_qubo(
                    model,
                    num_reads=num_reads,
                    num_sweeps=num_sweeps,
                    seed=seed + layer_idx,
                    one_hot_block_size=dp1,
                )
            elif solver == "exact":
                lin = model.h[:dp1] + 0.0  # blocks are identical
                choice = int(np.argmin(lin))
                sample = np.zeros(out_dim * dp1)
                sample[choice::dp1] = 1.0
            else:
                raise ValueError(f"Unknown solver {solver!r}")

            q = sample.reshape(out_dim, dp1)
            degrees = np.argmax(q, axis=1).astype(np.int32)

            in_dim = current.shape[1]
            t_dim = y.shape[1]
            # coefficients are float regardless of the target dtype --
            # integer labels (valid for train()) must not truncate the
            # fitted lstsq coefficients to zeros
            C = np.zeros(
                (out_dim, in_dim, dp1, t_dim),
                # y.dtype, not np.asarray(y).dtype: the latter gathers a
                # possibly mesh-sharded target to host just to read a dtype
                dtype=np.promote_types(y.dtype, np.float32),
            )
            for o in range(out_dim):
                d = int(degrees[o])
                c = np.asarray(coeffs[d]).reshape(in_dim, d + 1, t_dim)
                C[o, :, : d + 1, :] = c
            layer_params = {
                "degrees": jnp.asarray(degrees),
                "coefficients": jnp.asarray(C),
                "horizontal_weights": jnp.ones(out_dim, dtype=C.dtype),
            }
            params.append(layer_params)
            current = kan_layer_apply(layer_params, current, cfg.max_degree)

        self.params = params

    def calculate_layer_complexity_weight(self, layer_idx: int, degree: int) -> float:
        """Depth-dependent parabolic complexity weight.

        Port of FixedKAN._calculate_layer_complexity_weight (reference
        :354-368).  NOTE: like the reference, the degree optimizer does not
        consume this (optimize_degrees uses the flat complexity_weight); it
        is exposed for API parity and experimentation.
        """
        num_layers = len(self.config.network_shape) - 1
        layer_pos = layer_idx / (num_layers - 1) if num_layers > 1 else 0.0
        layer_scale = 4 * (layer_pos - 0.5) ** 2
        degree_penalty = degree * (1 + np.log(degree + 1))
        return self.config.complexity_weight * layer_scale * degree_penalty

    # -- inference --------------------------------------------------------
    def __call__(self, x) -> jax.Array:
        if self.params is None:
            raise RuntimeError("Neuron degree not set. Run optimization first.")
        return self._apply(self.params, jnp.asarray(x))

    forward = __call__

    # -- gradient training ------------------------------------------------
    def train(
        self,
        x_data,
        y_data,
        epochs: int = 10,
        batch_size: int = 64,
        learning_rate: float = 0.01,
        loss: str = "cross_entropy",
        trainable: str = "all",
        grad_clip: float | None = None,
        lr_scale: str = "none",
        lr_schedule: str = "none",
        seed: int = 0,
        verbose: bool = False,
        backend: str = "auto",
        compute_dtype=None,
        matmul_precision: str | None = "auto",
        mesh=None,
        mesh_axis: str | None = None,
        tensor_axis: str | None = "auto",
    ) -> list:
        """Gradient training with Adam.

        ``trainable='horizontal'`` reproduces the reference's
        ``train_horizontal_weights`` (only the per-neuron scalars move,
        reference :309-333); ``'all'`` differentiates through every
        coefficient -- the upgrade the pytree design buys.  ``grad_clip``
        (opt-in, like every behavior extension here) applies global-norm
        clipping; deep stacks benefit, and the reference's own MLP trainer
        clips at 1.0 (train_utils.py:42).  The default (None) keeps the
        reference's unclipped Adam semantics.

        ``backend``/``compute_dtype`` select the TRAINING kernel path --
        unlike the config-level ``compute_dtype`` (inference-only), these
        run the optimization itself through ``kan_apply``'s variants:
        ``backend='auto'`` picks per layer (``choose_layer_backend``), and
        ``compute_dtype='bfloat16'`` stores the data at bf16 and multiplies
        in bf16 with f32 accumulation.  ``compute_dtype='int8'`` is invalid
        here (zero gradients).

        ``matmul_precision`` pins the multiply precision of every matmul
        in the training step: it enters ``jax.default_matmul_precision``
        around the whole trace (forward, cotangents, Adam), and the fused
        kernel follows it.  The default ``'auto'`` resolves to
        ``_TRAIN_PRECISION``; ``None`` keeps the device default.  The CPU
        multiplies in true f32 either way.

        Each epoch runs as ONE device-side ``lax.scan`` over the permuted
        batch indices (gathered on-device), not a host loop per step, so
        the host is off the critical path between steps.  Losses are
        fetched per epoch, which is the divergence-restore granularity.

        ``lr_schedule='cosine'`` (opt-in) decays every Adam lr to zero
        over the full run with optax's cosine schedule; the default keeps
        the reference's constant-lr semantics.

        ``mesh`` (a ``jax.sharding.Mesh``) turns on data-parallel
        training: dataset rows and every minibatch shard over
        ``mesh_axis`` (default: the mesh's first axis) with parameters
        and optimizer state replicated -- XLA's sharding propagation
        inserts the gradient all-reduces, the idiomatic pjit dp pattern
        (SURVEY section 2, data parallelism).  Updates follow the
        single-device trajectory (same global batches in the same order)
        up to float reduction-order noise from the cross-device gradient
        all-reduce -- equivalence is pinned to rtol 1e-5 by
        tests/test_models_fixed_kan.py, not bitwise.  ``tensor_axis``
        selects the tensor-parallel mesh axis: the default ``'auto'``
        uses an axis named ``'tp'`` when the mesh carries one, ``None``
        opts out (any ``'tp'`` axis is then left unused -- replicated
        compute), and an explicit name requires that axis.  With tensor
        parallelism on, coefficient tensors row-shard their ``in`` axis
        over it (for layers whose in_dim divides the axis) along with
        ``x``'s feature axis, and sharding propagation inserts the
        contraction psums -- the 2-D (dp, tp) recipe for models past one
        chip's HBM (explicit shard_map semantics in ``parallel/tp.py``).

        ``lr_scale='fanin'`` divides each layer's coefficient lr by its
        summation fan-in (in_dim * (D+1) * out_neurons, normalized to the
        last layer's): Adam's scale-free per-param steps otherwise drift a
        wide layer's OUTPUT by lr * fan_in per epoch, saturating the next
        layer's tanh and collapsing deep stacks (measured: [784,...] layer
        outputs hit |100| within an epoch at lr 2e-4).
        Returns per-epoch average losses.
        """
        import optax

        if self.params is None:
            raise RuntimeError("Run optimization first.")
        x = jnp.asarray(x_data)
        y = jnp.asarray(y_data)
        max_degree = self.config.max_degree
        if compute_dtype is not None and (
            compute_dtype in ("int8x2", "int8x2w")
            or jnp.dtype(compute_dtype) == jnp.int8
        ):
            raise ValueError("int8 rounding has zero gradient; use bf16")
        if compute_dtype is not None:
            x = x.astype(compute_dtype)  # store-once, the bf16io recipe

        if matmul_precision == "auto":
            matmul_precision = _TRAIN_PRECISION
        self.last_matmul_precision = matmul_precision
        if mesh is not None:
            # a pallas_call under sharding propagation would gather its
            # operands onto every device
            backend = "xla"

        if loss == "cross_entropy":
            if y.ndim == 1:
                y1h = jax.nn.one_hot(y.astype(jnp.int32), self.config.network_shape[-1])
            else:
                y1h = y

            def loss_fn(params, xb, yb):
                # matmul_precision=None: the ambient default_matmul_precision
                # context (entered below) owns EVERY matmul's numerics.
                # Letting the forward re-pin its own 'auto' policy would
                # override an explicit train(matmul_precision=...).
                logits = kan_apply(
                    params, xb, max_degree, compute_dtype, backend,
                    matmul_precision=None,
                )
                return jnp.mean(
                    optax.softmax_cross_entropy(logits, yb)
                )

            y_train = y1h
        elif loss == "mse":
            y_train = y if y.ndim > 1 else y[:, None]

            def loss_fn(params, xb, yb):
                # precision routing: see the cross_entropy note
                pred = kan_apply(
                    params, xb, max_degree, compute_dtype, backend,
                    matmul_precision=None,
                )
                return jnp.mean((pred - yb) ** 2)
        else:
            raise ValueError(f"Unknown loss {loss!r}")

        # The integer 'degrees' leaves are structural, not differentiable:
        # hold them out of the optimized pytree and close over them.
        degrees = [lp["degrees"] for lp in self.params]

        def rebuild(train_params):
            return [
                dict(tp, degrees=d) for tp, d in zip(train_params, degrees)
            ]

        full_loss = loss_fn

        def loss_on_trainable(train_params, xb, yb):
            return full_loss(rebuild(train_params), xb, yb)

        if trainable == "horizontal":
            train_labels = [
                {"coefficients": "off", "horizontal_weights": "hw"}
                for _ in self.params
            ]
        elif trainable == "all":
            train_labels = [
                {"coefficients": f"coef{i}", "horizontal_weights": "hw"}
                for i in range(len(self.params))
            ]
        else:
            raise ValueError(f"Unknown trainable {trainable!r}")

        n = x.shape[0]
        batch_size = min(batch_size, n)  # a batch can't exceed the dataset
        steps = max(1, n // batch_size)

        def make_adam(lr):
            # opt-in cosine decay to zero over the whole run (an optax
            # schedule, counted per optimizer step inside the epoch scans);
            # 'none' keeps the reference's constant-lr Adam semantics
            if lr_schedule == "cosine":
                lr = optax.cosine_decay_schedule(lr, epochs * steps)
            elif lr_schedule != "none":
                raise ValueError(f"Unknown lr_schedule {lr_schedule!r}")
            if grad_clip:
                return optax.chain(
                    optax.clip_by_global_norm(grad_clip), optax.adam(lr)
                )
            return optax.adam(lr)

        transforms = {"off": optax.set_to_zero(), "hw": make_adam(learning_rate)}
        if lr_scale == "fanin":
            dp1 = max_degree + 1
            fanins = [
                float(lp["coefficients"].shape[1] * dp1 * lp["coefficients"].shape[0])
                for lp in self.params
            ]
            ref = fanins[-1]
            for i, f in enumerate(fanins):
                transforms[f"coef{i}"] = make_adam(learning_rate * ref / f)
        else:
            for i in range(len(self.params)):
                transforms[f"coef{i}"] = make_adam(learning_rate)
        tx = optax.multi_transform(transforms, train_labels)
        params = [
            {k: v for k, v in lp.items() if k != "degrees"} for lp in self.params
        ]

        idx_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            # the tensor_axis adds tensor parallelism on top of dp:
            # coefficients' in-axis and x's feature axis shard over it and
            # GSPMD inserts the contraction psums (the propagation route;
            # parallel/tp.py holds the explicit shard_map semantics with
            # exact parity tests).  Layers whose in_dim does not divide
            # the tp axis stay replicated (same static rule).
            axes = list(mesh.axis_names)
            if tensor_axis == "auto":
                tp_ax = "tp" if "tp" in axes else None
            else:
                tp_ax = tensor_axis
                if tp_ax is not None and tp_ax not in axes:
                    raise ValueError(
                        f"mesh has axes {axes}, no tensor axis {tp_ax!r}"
                    )
            if tp_ax is not None and axes == [tp_ax]:
                raise ValueError(
                    f"a 1-D mesh whose only axis is the tensor axis "
                    f"{tp_ax!r} is ambiguous here: train(mesh=) shards the "
                    "batch over the remaining axis, so add a batch axis "
                    "(Mesh(devs.reshape(1, -1), ('dp', 'tp'))), pass "
                    "tensor_axis=None for pure dp, or use "
                    "parallel.tp.make_tp_train_step for a pure "
                    "tensor-parallel step"
                )
            axis = mesh_axis or next(a for a in axes if a != tp_ax)
            if axis == tp_ax:
                raise ValueError(
                    f"mesh_axis {axis!r} is the tensor-parallel axis; "
                    "pass the batch axis (or tensor_axis=None)"
                )
            n_dev = mesh.shape[axis]
            if batch_size % n_dev or x.shape[0] % n_dev:
                raise ValueError(
                    f"dp training needs batch_size ({batch_size}) and the "
                    f"row count ({x.shape[0]}) divisible by mesh axis "
                    f"{axis!r} ({n_dev} devices)"
                )
            rows = lambda a: NamedSharding(
                mesh, PartitionSpec(axis, *([None] * (a.ndim - 1)))
            )
            replicated = NamedSharding(mesh, PartitionSpec())
            if tp_ax is not None:
                # reuse the shard_map path's layout rule verbatim so the
                # two routes cannot desynchronize (specs map 1:1 onto
                # NamedShardings)
                from qkan_implementation.parallel.tp import (
                    _param_specs,
                    _tp_layer_flags,
                )

                flags = _tp_layer_flags(
                    self.params, mesh.shape[tp_ax], x.shape[1]
                )
                x = jax.device_put(
                    x,
                    NamedSharding(
                        mesh,
                        PartitionSpec(axis, tp_ax if flags[0] else None),
                    ),
                )
                params = [
                    {
                        k: jax.device_put(v, NamedSharding(mesh, sp[k]))
                        for k, v in lp.items()
                    }
                    for lp, sp in zip(params, _param_specs(params, flags, tp_ax))
                ]
            else:
                x = jax.device_put(x, rows(x))
                params = jax.device_put(params, replicated)
            y_train = jax.device_put(y_train, rows(y_train))
            # [steps, batch]: shard each step's minibatch over the axis
            idx_sharding = NamedSharding(mesh, PartitionSpec(None, axis))

        # init AFTER any device_put: eager zeros_like inherits each param's
        # sharding, so tp-sharded coefficients get tp-sharded mu/nu -- a
        # replicated init would hold 2x the full model on every device,
        # defeating the tp path's HBM point (jit(tx.init) drops shardings;
        # eager preserves them -- measured)
        opt_state = tx.init(params)

        def train_step(carry, idx_row):
            params, opt_state = carry
            xb = jnp.take(x, idx_row, axis=0)
            yb = jnp.take(y_train, idx_row, axis=0)
            l, grads = jax.value_and_grad(loss_on_trainable)(params, xb, yb)
            updates, opt_state = tx.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), l

        # One scan program per EPOCH, not one dispatch per step: the scan
        # performs the SAME per-batch Adam updates in the same order
        # (batches gathered on-device from a permutation index array); only
        # the loss fetch moves to epoch granularity -- which is already the
        # divergence-restore granularity below.
        @jax.jit
        def epoch_fn(params, opt_state, idx_mat):
            (params, opt_state), ls = jax.lax.scan(
                train_step, (params, opt_state), idx_mat
            )
            return params, opt_state, ls

        rng = np.random.default_rng(seed)
        import contextlib

        # the precision context must wrap the epoch_fn TRACE (first call),
        # and jit keys on the ambient precision config, so wrapping the
        # whole loop is both necessary and cache-correct
        prec_ctx = (
            jax.default_matmul_precision(matmul_precision)
            if matmul_precision is not None
            else contextlib.nullcontext()
        )
        with prec_ctx:
            losses, params, diverged = self._run_epochs(
                epoch_fn, params, opt_state, rng, epochs, n, steps,
                batch_size, idx_sharding, verbose,
            )
        self.params = rebuild(params)
        # diagnosability: callers (e.g. experiments/mnist.py records) need
        # to distinguish "trained to chance" from "diverged and restored"
        self.last_train_diverged = diverged
        self.last_train_losses = list(losses)
        return losses

    @staticmethod
    def _run_epochs(
        epoch_fn, params, opt_state, rng, epochs, n, steps, batch_size,
        idx_sharding, verbose,
    ):
        """Epoch loop with divergence detection: per-step losses arrive at
        each epoch end; any non-finite value restores the last finite
        epoch's parameters instead of silently returning a NaN-poisoned
        model.  Returns (losses, params, diverged)."""
        losses = []
        last_good = params
        diverged = False
        for epoch in range(epochs):
            perm = rng.permutation(n)[: steps * batch_size]
            idx_np = perm.reshape(steps, batch_size).astype(np.int32)
            if idx_sharding is not None:
                idx_mat = jax.device_put(idx_np, idx_sharding)
            else:
                idx_mat = jnp.asarray(idx_np)
            params, opt_state, ls = epoch_fn(params, opt_state, idx_mat)
            ls = np.asarray(ls, dtype=np.float64)
            if not np.isfinite(ls).all():
                import logging

                bad = int(np.argmax(~np.isfinite(ls)))
                logging.getLogger(__name__).warning(
                    "Non-finite loss at epoch %d step %d; stopping and "
                    "restoring the last finite epoch's parameters",
                    epoch, bad,
                )
                params = last_good
                diverged = True
                break
            last_good = params
            losses.append(float(ls.mean()))
            if verbose:
                print(f"Epoch {epoch+1}/{epochs}, avg Loss: {losses[-1]:.4f}")
        return losses, params, diverged

    def train_horizontal_weights(
        self, x_data, y_data, epochs: int, learning_rate: float = 0.01, **kw
    ) -> list:
        """Reference-parity trainer: Adam + cross-entropy on the horizontal
        weights only (FixedKAN.train_horizontal_weights:309-333)."""
        return self.train(
            x_data,
            y_data,
            epochs=epochs,
            learning_rate=learning_rate,
            loss="cross_entropy",
            trainable="horizontal",
            **kw,
        )

    # -- analysis ---------------------------------------------------------
    def analyze_network(self, x_data) -> dict:
        """Per-layer neuron contributions (FixedKAN.analyze_network:376-435)."""
        if self.params is None:
            raise RuntimeError("Run optimization first.")
        cfg = self.config
        x = jnp.asarray(x_data)
        analysis = {}
        current = x
        for layer_idx, lp in enumerate(self.params):
            t = jnp.tanh(current)
            basis = chebyshev_basis(t, cfg.max_degree, clip=False)
            mask = (
                jnp.arange(cfg.max_degree + 1)[None, :] <= lp["degrees"][:, None]
            )
            weighted = (
                lp["coefficients"]
                * mask[:, None, :, None]
                * lp["horizontal_weights"][:, None, None, None]
            )
            neuron_outputs = jnp.einsum("bid,oidt->obt", basis, weighted)
            combined = neuron_outputs.sum(axis=0)
            analysis[f"layer_{layer_idx}"] = {
                "neuron_outputs": neuron_outputs,
                "degrees": [int(d) for d in np.asarray(lp["degrees"])],
                "combined_output": combined,
                "input_dim": int(current.shape[1]),
            }
            current = combined
        return analysis

    def visualize_analysis(
        self, analysis: dict, x_data, y_data=None, save_path: str | None = None
    ):
        """Plot the per-layer analysis (FixedKAN.visualize_analysis:437-548).

        2-D inputs get 3-D scatter + contour + degree-histogram panels per
        layer; other dims get output-scatter + histogram panels.  Headless
        (Agg); returns the figure, optionally saving it.
        """
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        num_layers = len(self.params)
        x_np = np.asarray(x_data)
        input_dim = x_np.shape[1]

        if input_dim == 2:
            fig = plt.figure(figsize=(20, 8 * num_layers))
            gs = plt.GridSpec(num_layers, 3)
            for layer_idx in range(num_layers):
                layer_data = analysis[f"layer_{layer_idx}"]
                sort_idx = np.lexsort((x_np[:, 1], x_np[:, 0]))
                x_plot = x_np[sort_idx]

                ax1 = fig.add_subplot(gs[layer_idx, 0], projection="3d")
                neuron_outputs = np.asarray(layer_data["neuron_outputs"])
                for i, degree in enumerate(layer_data["degrees"]):
                    out = neuron_outputs[i].squeeze()[sort_idx]
                    out = out if out.ndim == 1 else out[:, 0]
                    ax1.scatter(
                        x_plot[:, 0], x_plot[:, 1], out,
                        alpha=0.3, label=f"Neuron {i} (deg={degree})",
                    )
                combined = np.asarray(layer_data["combined_output"]).squeeze()[sort_idx]
                combined = combined if combined.ndim == 1 else combined[:, 0]
                ax1.scatter(
                    x_plot[:, 0], x_plot[:, 1], combined,
                    c="red", alpha=0.7, label="Layer Output",
                )
                if layer_idx == num_layers - 1 and y_data is not None:
                    y_plot = np.asarray(y_data).squeeze()[sort_idx]
                    y_plot = y_plot if y_plot.ndim == 1 else y_plot[:, 0]
                    ax1.scatter(
                        x_plot[:, 0], x_plot[:, 1], y_plot,
                        c="black", alpha=0.5, label="Target",
                    )
                ax1.set_title(f"Layer {layer_idx+1} Contributions")
                ax1.legend()

                ax2 = fig.add_subplot(gs[layer_idx, 1])
                sc = ax2.tricontourf(
                    x_plot[:, 0], x_plot[:, 1], combined, levels=20, cmap="viridis"
                )
                fig.colorbar(sc, ax=ax2)
                ax2.set_title(f"Layer {layer_idx+1} Output Contours")

                ax3 = fig.add_subplot(gs[layer_idx, 2])
                ax3.hist(
                    layer_data["degrees"],
                    bins=range(self.config.max_degree + 2),
                    alpha=0.7,
                    rwidth=0.8,
                )
                ax3.set_title(f"Layer {layer_idx+1} Degree Distribution")
        else:
            fig = plt.figure(figsize=(15, 5 * num_layers))
            gs = plt.GridSpec(num_layers, 2)
            for layer_idx in range(num_layers):
                layer_data = analysis[f"layer_{layer_idx}"]
                ax1 = fig.add_subplot(gs[layer_idx, 0])
                combined = np.asarray(layer_data["combined_output"]).squeeze()
                combined1 = combined if combined.ndim == 1 else combined[:, 0]
                if input_dim == 1:
                    ax1.scatter(x_np[:, 0], combined1, alpha=0.5)
                else:
                    sc = ax1.scatter(
                        x_np[:, 0], x_np[:, 1], c=combined1, cmap="viridis", alpha=0.5
                    )
                    fig.colorbar(sc, ax=ax1)
                ax1.set_title(f"Layer {layer_idx+1} Output")
                ax2 = fig.add_subplot(gs[layer_idx, 1])
                ax2.hist(
                    layer_data["degrees"],
                    bins=range(self.config.max_degree + 2),
                    alpha=0.7,
                    rwidth=0.8,
                )
                ax2.set_title(f"Layer {layer_idx+1} Degree Distribution")

        fig.tight_layout()
        if save_path:
            fig.savefig(save_path)
        return fig

    # -- checkpointing ----------------------------------------------------
    def save_model(self, filepath: str) -> None:
        """Save config + params (FixedKAN.save_model:574-576 equivalent).

        Format: .npz with a JSON config entry and flat per-layer arrays --
        config-in-checkpoint semantics so load needs no external state.
        """
        if self.params is None:
            raise RuntimeError("Run optimization first.")
        arrays = {"config_json": np.frombuffer(
            json.dumps(asdict(self.config)).encode(), dtype=np.uint8
        )}
        for i, lp in enumerate(self.params):
            for k, v in lp.items():
                arrays[f"layer{i}/{k}"] = np.asarray(v)
        np.savez(filepath, **arrays)

    @classmethod
    def load_model(cls, filepath: str) -> "FixedKAN":
        """Rebuild a model from a checkpoint (FixedKAN.load_model:578-598)."""
        data = np.load(filepath if str(filepath).endswith(".npz") else filepath + ".npz")
        cfg_dict = json.loads(bytes(data["config_json"]).decode())
        model = cls(FixedKANConfig(**cfg_dict))
        params = []
        i = 0
        while f"layer{i}/degrees" in data:
            params.append(
                {
                    "degrees": jnp.asarray(data[f"layer{i}/degrees"]),
                    "coefficients": jnp.asarray(data[f"layer{i}/coefficients"]),
                    "horizontal_weights": jnp.asarray(
                        data[f"layer{i}/horizontal_weights"]
                    ),
                }
            )
            i += 1
        model.params = params
        return model

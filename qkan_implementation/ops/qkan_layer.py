"""The fused QKAN layer forward: DILATE/CHEB -> MUL -> LCU -> SUM.

JAX re-design of ``QKAN_Steps_original/{MulStep,LCUStep,SUMStep,
QKANLayer}.py``.  The reference materializes NK x NK dense diagonal matrices
at every step and loops in Python (``QKANLayer.py:124-135``); here the whole
layer collapses to a handful of fused elementwise ops and one reduction --
O(d*N*K) work, jit/vmap/grad-compatible, with a batched variant for data
parallelism.

Semantics contract (pinned by golden tests against the reference):

  dilated_d[j]  = T_d(x[j // K])                      j in [0, N*K)
  weighted_d[j] = dilated_d[j] * w_d[j]               (MulStep.py:41-72)
  lcu[j]        = sum_d weighted_d[j] / (D+1)         (LCUStep.py:34-36)
  out[k]        = sum_{i<N} lcu[i + k*N] / N          (SUMStep.py:28-30,
                                                       Fortran-order reshape)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.ops.chebyshev import (
    chebyshev_basis,
    chebyshev_t,
    dilate,
)


def weighted_chebyshev_diag(
    x: jax.Array, weights: jax.Array, K: int, degree: int
) -> jax.Array:
    """Diagonal of one weighted Chebyshev term: T_degree dilated * w_degree.

    ``x``: [N]; ``weights``: [N*K] with |w| <= 1.  Equivalent of
    ``MulStep.get_weighted_polynomial_matrix`` (reference ``MulStep.py:41-72``)
    without the dense diag.
    """
    # single-column recurrence: building the whole [N, degree+1] stack to
    # slice one column wastes O(N*D) work/memory
    t = chebyshev_t(x, degree)
    return dilate(t, K) * weights


def lcu_combine_diag(x: jax.Array, weights: jax.Array, K: int) -> jax.Array:
    """Diagonal of the LCU-combined matrix: uniform 1/(D+1) average.

    ``x``: [N]; ``weights``: [D+1, N*K].  Equivalent of
    ``LCUStep.get_combined_matrix`` (reference ``LCUStep.py:18-36``).
    """
    max_degree = weights.shape[0] - 1
    basis = chebyshev_basis(x, max_degree)  # [N, D+1]
    dilated = dilate(basis.T, K)  # [D+1, N*K]
    return jnp.mean(dilated * weights, axis=0)


def sum_step(lcu_diag: jax.Array, N: int, K: int) -> jax.Array:
    """SUM step: Fortran-order (N, K) reshape, mean over the N inputs.

    out[k] = (1/N) * sum_i lcu_diag[i + k*N].  The C-order reshape to (K, N)
    is the transpose of the reference's Fortran-order (N, K) reshape
    (``SUMStep.py:28-30``), so summing its last axis reproduces the exact
    semantics -- pinned by golden tests (easy to get wrong, SURVEY.md section 7).
    """
    return jnp.sum(lcu_diag.reshape(K, N), axis=-1) / N


def qkan_layer_forward(
    x: jax.Array, weights: jax.Array, N: int, K: int
) -> jax.Array:
    """Full QKAN layer forward: [N] inputs -> [K] outputs.

    ``weights``: [max_degree+1, N*K], |w| <= 1.  Equivalent of
    ``QKANLayer.forward`` (reference ``QKANLayer.py:77-135``) as one fused
    jit-able computation.
    """
    lcu = lcu_combine_diag(x, weights, K)
    return sum_step(lcu, N, K)


def qkan_weight_tensor(weights: jax.Array, N: int, K: int) -> jax.Array:
    """Fold the per-degree weight vectors into the layer's contraction
    tensor M [K, N, D+1]:

      out[b, k] = sum_{n, d} T_d(x[b, n]) * M[k, n, d]

    which is exactly the DILATE->MUL->LCU->SUM composition (the 1/(N(D+1))
    normalization and the Fortran-order SUM gather are absorbed into M).
    Differentiable in ``weights`` (a linear scatter-add).
    """
    dp1 = weights.shape[0]
    j_idx = np.arange(K)[:, None] * N + np.arange(N)[None, :]  # [K, N] = j
    n_idx = j_idx // K  # input feature feeding slot (k, i)
    w_g = jnp.transpose(weights[:, j_idx], (1, 2, 0))  # [K, N, D+1]
    k_idx = np.broadcast_to(np.arange(K)[:, None], (K, N))
    M = jnp.zeros((K, N, dp1), dtype=weights.dtype)
    M = M.at[k_idx.reshape(-1), n_idx.reshape(-1)].add(
        w_g.reshape(K * N, dp1)
    )
    return M / (N * dp1)


def qkan_layer_forward_batched(
    x: jax.Array, weights: jax.Array, N: int, K: int,
    compute_dtype=None,
) -> jax.Array:
    """Batched layer forward: [B, N] -> [B, K] as one matmul.

    The data-parallel path the reference lacks (its ``QKANLayer.forward`` was
    written for 1-D vectors; ``DegreeOptimizer.predict`` feeding it a batch
    is a documented reference bug, SURVEY.md section 7).  The contraction
    runs over the combined (feature, degree) axis -- [B, N*(D+1)] @
    [N*(D+1), K] -- so the hot loop lives on the systolic array instead of
    the vector units.

    ``compute_dtype``: optional matmul input dtype for the mixed-precision
    production recipe.  Pass ``jnp.bfloat16`` with ``x`` ALREADY stored in
    bf16 (cast once in the data pipeline, not per step) for native-bf16
    multiplies with f32 accumulation; only the small [N*(D+1), K] weight
    tensor casts per step.  Output is always f32 when set.  Default
    ``None`` keeps f32 storage and accumulation with the device's default
    multiply precision (TF32 on the GPU; the on-card error of this path vs
    the exact forward is measured as ``layer_quantum_vs_classical_N16`` in
    benchmarks/contracts.py).
    Quality-critical SOLVES pin full-f32 multiplies instead -- see
    models/fixed_kan._lstsq.
    """
    max_degree = weights.shape[0] - 1
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
    basis = chebyshev_basis(x, max_degree)  # [B, N, D+1]
    M = qkan_weight_tensor(weights, N, K)  # [K, N, D+1]
    b = x.shape[0]
    M2 = M.reshape(K, -1).T
    if compute_dtype is not None:
        # cast the FINAL dot operand, after the reshape/transpose:
        # convert(transpose(M)) fuses into the dot read, while
        # transpose(convert(M)) breaks XLA's backward fusion
        M2 = M2.astype(compute_dtype)
    return jnp.dot(
        basis.reshape(b, -1),
        M2,
        preferred_element_type=(
            jnp.float32 if compute_dtype is not None else basis.dtype
        ),
    )


def qkan_layer_forward_batched_int8(
    x: jax.Array, weights: jax.Array, N: int, K: int
) -> jax.Array:
    """Inference-only int8 path: [B, N] -> [B, K] float32.

    The serving-throughput lever past bf16io: int8 x int8 -> int32 tensor
    cores run at 2x the bf16 rate.  Quantization scheme:

    - activations: the Chebyshev basis is analytically bounded in [-1, 1]
      (T_d of eps-clipped inputs), so a STATIC symmetric scale of 127 is
      exact -- no per-row max reduction, no dynamic-range surprises.
    - weights: the folded contraction tensor column for output k spans
      [-1, 1]/(N*(D+1)) (|w| <= 1 enforced by ``check_weight_magnitudes``);
      a per-output-channel symmetric scale keeps each column at full int8
      resolution.
    - accumulate int32 (``preferred_element_type``), dequantize
      once per output element.

    Worst-case per-element quantization error is 1/254 on the basis and
    1/254 of the column range on the weights; across the N*(D+1)-term mean
    the observed output error vs the f32 path is ~1e-3 relative (pinned by
    tests/test_ops_qkan_layer.py).  Rounding is not differentiable --
    this path is for serving, not training; use ``compute_dtype=bfloat16``
    for mixed-precision training.
    """
    max_degree = weights.shape[0] - 1
    basis = chebyshev_basis(x, max_degree)  # [B, N, D+1] in [-1, 1]
    b = x.shape[0]
    M2 = qkan_weight_tensor(weights, N, K).reshape(K, -1).T  # [F, K]
    return int8_quantized_matmul(basis.reshape(b, -1), M2)


def int8_quantized_matmul(basis2d: jax.Array, W: jax.Array) -> jax.Array:
    """``[B, F] @ [F, K] -> [B, K] float32`` on the int8 path.

    The single implementation of the quantization scheme documented in
    ``qkan_layer_forward_batched_int8`` -- static 127 activation scale
    (``basis2d`` must be analytically bounded in [-1, 1]), per-output
    -channel symmetric weight scale, int32 accumulation, one f32
    dequant.  Shared with ``models.fixed_kan.kan_layer_apply`` so the two
    serving paths cannot drift."""
    s_w = jnp.max(jnp.abs(W), axis=0, keepdims=True) / 127.0  # [1, K]
    qa = jnp.round(basis2d * 127.0).astype(jnp.int8)
    qw = jnp.round(W / jnp.maximum(s_w, 1e-30)).astype(jnp.int8)
    acc = jax.lax.dot_general(
        qa, qw, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    # cast the scale too: under x64 an f64 weight tensor yields an f64
    # scale that would silently promote the float32 output contract to
    # float64 (doubling serving bandwidth)
    return acc.astype(jnp.float32) * (s_w / 127.0).astype(jnp.float32)


def int8_residual_matmul(
    basis2d: jax.Array, W: jax.Array, acts_residual: bool = True
) -> jax.Array:
    """``[B, F] @ [F, K] -> [B, K] float32`` via two-level residual int8.

    Single-level int8 is structurally dead at wide fan-in: the flagship
    F=4704 contraction random-walks the ~1/254 per-element quantization
    noise into O(1) logit error (chance accuracy on a trained flagship
    model, benchmarks/eval_precision_probe.py), and quantizing one side
    at a time convicts the WEIGHT side (acts-only quantization held full
    flagship accuracy on the CPU; weights-only scored chance -- the trained
    weight columns' dynamic range swamps a single per-column scale).
    This path therefore always quantizes the weights twice: the first
    int8 level plus an int8 encoding of its rounding residual (exactly
    representable: |residual*254*127| <= 127), ~1/254^2 effective weight
    resolution.

    ``acts_residual=True`` (the 'int8x2' recipe) gives the basis the same
    two-level treatment -- THREE int8 dots:

        a @ W ~= s/127^2 * [qa1@qw1 + (qa1@qw2 + qa2@qw1)/254]

    (the qa2@qw2 cross term is O(1/254^2) per element and dropped).
    ``acts_residual=False`` (the 'int8x2w' recipe) keeps the basis at one
    int8 level -- TWO dots -- which the decomposition predicts is enough
    (activation resolution was never the problem).  int8 tensor cores run
    at 2x the bf16 rate, so 2-3 int8 passes cost about 1-1.5 bf16 passes.
    At the flagship shape 'int8x2' matched full-f32 accuracy and 'int8x2w'
    did not (benchmarks/eval_precision_probe.py; their speed on the card
    is not measured).  Same contracts as
    ``int8_quantized_matmul``: basis analytically bounded in [-1, 1],
    per-output-channel symmetric weight scale, int32 accumulation, f32
    dequant.  Inference-only (rounding has no grad).
    """
    s_w = jnp.maximum(
        jnp.max(jnp.abs(W), axis=0, keepdims=True), 1e-30
    )  # [1, K]
    wn = W / s_w  # columns span [-1, 1]
    qw1 = jnp.round(wn * 127.0)
    qw2 = jnp.round((wn - qw1 / 127.0) * (127.0 * 254.0))
    qa1 = jnp.round(basis2d * 127.0)
    qw1, qw2 = qw1.astype(jnp.int8), qw2.astype(jnp.int8)

    def dot(a, b):
        return jax.lax.dot_general(
            a, b, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32)

    if acts_residual:
        qa2 = jnp.round((basis2d - qa1 / 127.0) * (127.0 * 254.0))
        qa1, qa2 = qa1.astype(jnp.int8), qa2.astype(jnp.int8)
        acc = dot(qa1, qw1) + (dot(qa1, qw2) + dot(qa2, qw1)) / 254.0
    else:
        qa1 = qa1.astype(jnp.int8)
        acc = dot(qa1, qw1) + dot(qa1, qw2) / 254.0
    return acc * (s_w / (127.0 * 127.0)).astype(jnp.float32)


def qkan_intermediates(
    x: jax.Array, weights: jax.Array, N: int, K: int
) -> dict:
    """Expose every stage of the pipeline for debugging.

    Diagonal-vector analog of ``QKANLayer.get_intermediate_matrices``
    (reference ``QKANLayer.py:30-75``): returns diagonals rather than dense
    matrices.  ``reshaped`` uses the same Fortran-order (N, K) layout.
    """
    max_degree = weights.shape[0] - 1
    basis = chebyshev_basis(x, max_degree)  # [N, D+1]
    dilated = dilate(basis.T, K)  # [D+1, N*K]
    weighted = dilated * weights
    lcu = jnp.mean(weighted, axis=0)
    reshaped = lcu.reshape(K, N).T  # Fortran-order (N, K)
    final = jnp.sum(reshaped, axis=0) / N
    return {
        "input": x,
        "cheb": {d: dilated[d] for d in range(max_degree + 1)},
        "weighted": {d: weighted[d] for d in range(max_degree + 1)},
        "lcu": lcu,
        "reshaped": reshaped,
        "final": final,
    }

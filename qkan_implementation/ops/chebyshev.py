"""Chebyshev transforms for the QKAN pipeline.

JAX equivalent of ``QKAN_Steps_original/ChebyshevStep.py`` (reference
``ChebyshevStep.py:8-65``): T_d(x) = cos(d * arccos(x)) on values in [-1, 1],
with the reference's eps-tolerant clipping, plus the dilated (K-fold repeated)
diagonal used by the MUL step.  All functions are pure and jit/vmap/grad
compatible; validation (which raises) is offered as separate eager-mode
helpers so the compiled path stays branch-free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Same tolerance the reference applies before clipping
# (ChebyshevStep.py:25-30).
UNIT_EPS = 1e-8


def check_unit_interval(x, eps: float = UNIT_EPS, name: str = "Input value"):
    """Eagerly validate that all values lie in [-1-eps, 1+eps].

    Mirrors the ValueError contract of ``ChebyshevStep.apply_chebyshev``
    (reference ``ChebyshevStep.py:24-28``).  Call at API boundaries, outside
    jit.  Returns the input unchanged for chaining.
    """
    arr = np.asarray(x)
    if not np.all((arr >= -1 - eps) & (arr <= 1 + eps)):
        raise ValueError(f"{name} must be between -1 and 1.")
    return x


def check_weight_magnitudes(weights, limit: float = 1.0):
    """Eagerly validate |w| <= 1 (unitarity bound).

    Mirrors ``MulStep.set_weights`` (reference ``MulStep.py:36-37``).
    """
    arr = np.asarray(weights)
    if not np.all(np.abs(arr) <= limit):
        raise ValueError("Weight magnitudes must be <= 1 for unitarity")
    return weights


def chebyshev_t(x: jax.Array, degree: int) -> jax.Array:
    """T_degree(x) = cos(degree * arccos(clip(x, -1, 1))), elementwise.

    Matches ``ChebyshevStep.apply_chebyshev`` (reference
    ``ChebyshevStep.py:18-30``) including the clip of slightly-out-of-range
    values.  Degree is static.
    """
    if degree < 0:
        raise ValueError("Degree must be a non-negative integer.")
    x = jnp.clip(x, -1.0, 1.0)
    return jnp.cos(degree * jnp.arccos(x))


def transform_diagonal(x: jax.Array, degree: int) -> jax.Array:
    """Vectorized T_degree over a vector of inputs.

    Equivalent of ``ChebyshevStep.transform_diagonal`` (reference
    ``ChebyshevStep.py:32-53``) -- but a single fused elementwise op instead
    of a per-element Python loop.
    """
    return chebyshev_t(x, degree)


def chebyshev_basis(x: jax.Array, max_degree: int, clip: bool = True) -> jax.Array:
    """All T_0..T_max_degree stacked on a trailing axis: shape x.shape + (D+1,).

    Uses the three-term recurrence T_{d+1} = 2x T_d - T_{d-1}, which is exact
    on [-1, 1] and, unlike cos/arccos, has bounded gradients at x = +/-1 --
    this is the differentiable path used by the KAN models (the reference uses
    ``torch.special.chebyshev_polynomial_t``, KAN_w_cumulative_polynomials.py:66).

    ``clip=True`` matches the quantum pipeline's [-1, 1] clamp
    (ChebyshevStep.py:29); ``clip=False`` matches torch's unclipped polynomial
    evaluation used by the KAN models, which may receive values outside the
    interval.
    """
    if max_degree < 0:
        raise ValueError("Degree must be a non-negative integer.")
    if clip:
        x = jnp.clip(x, -1.0, 1.0)
    cols = [jnp.ones_like(x)]
    if max_degree >= 1:
        cols.append(x)
    for _ in range(2, max_degree + 1):
        cols.append(2.0 * x * cols[-1] - cols[-2])
    return jnp.stack(cols, axis=-1)


def cumulative_transform(x: jax.Array, max_degree: int, clip: bool = False) -> jax.Array:
    """Cumulative per-dimension Chebyshev features, flattened.

    Input ``x``: [batch, input_dim].  Output: [batch, input_dim * (D+1)] laid
    out as [T_0(x_0)..T_D(x_0), T_0(x_1)..T_D(x_1), ...] -- i.e. all degrees
    of dim 0 first, matching ``KANNeuron._compute_cumulative_transform``
    (reference ``KAN_w_cumulative_polynomials.py:56-70``).  Unclipped by
    default, like torch's polynomial evaluation.
    """
    basis = chebyshev_basis(x, max_degree, clip=clip)  # [batch, in, D+1]
    b, n, dp1 = basis.shape
    return basis.reshape(b, n * dp1)


def dilate(values: jax.Array, K: int) -> jax.Array:
    """Repeat each value K times: [N] -> [N*K], index n*K + k holds values[n].

    Matches ``np.repeat(chebyshev_values, K)`` in
    ``ChebyshevStep.create_dilated_chebyshev`` (reference
    ``ChebyshevStep.py:55-65``).
    """
    return jnp.repeat(values, K, axis=-1)


def dilated_chebyshev_diag(x: jax.Array, K: int, degree: int) -> jax.Array:
    """Diagonal of the dilated Chebyshev matrix, as a vector of length N*K.

    The reference materializes an NK x NK dense diagonal matrix
    (``ChebyshevStep.py:65``); here only the diagonal is ever formed.
    """
    return dilate(transform_diagonal(x, degree), K)

"""Fused FixedKAN layer for NVIDIA GPUs (Pallas, Triton route).

tanh -> Chebyshev recurrence -> matmul, with the basis kept in registers.
The plain XLA layer (``models.fixed_kan.kan_layer_apply``) writes the
``[B, in*(D+1)]`` basis to device memory and reads it back for the matmul;
at the flagship layer 0 (B=8192, in=784, D+1=6) that is 154 MB against a
25 MB read of ``x`` for a ~0.8 GFLOP product, so the layer is bound by
memory traffic.  Here each row block walks the input columns in chunks and
runs the recurrence degree by degree, contracting every ``T_d`` tile as
soon as it exists.

Math (``t = tanh(x)``, ``W`` degree-major ``[dp1, in, T]``)::

    out[b, :] = sum_d T_d(t[b, :]) @ W_d
    dW_d      = T_d(t)^T @ g
    dx[b, i]  = (1 - t^2) * sum_{d>=1} d * U_{d-1}(t) * (g @ W_d^T)[b, i]

with ``T'_d = d * U_{d-1}`` (Chebyshev polynomials of the second kind).
The forward and ``dW`` are kernels; ``dx`` is plain ``jax.numpy``, which
XLA drops where the input is data (the first layer of a model, the only
layer wide enough to take this path in the flagship).  The ``dW`` grid is
(input-column chunk, batch split); each program accumulates its split's
partial in registers and the splits are summed afterwards, since GPU
blocks run in no fixed order.

``precision`` is the dot's algorithm: ``'default'`` is TF32 on the tensor
cores (what an f32 XLA dot gets by default on the GPU) and ``'bf16x3'`` is
three bf16 passes with f32 accumulation (``BF16_BF16_F32_X3``), accurate
to about f32.  Full-f32 (IEEE) dots inside the kernel lost to XLA's, so
there is no such mode.  ``interpret=True`` runs the same kernels on the
CPU.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Rows per block and input columns per chunk.  Triton needs power-of-two
# tiles, and every dot operand dimension must be at least 16.
# The values won a sweep of the flagship train step on an H100 (PERF.md).
_TB = 64
_BN = 32
_MIN_T = 16
# Batch splits of the dW grid: in/_BN chunks alone (25 at in=784) would
# leave most of the card's 132 SMs idle.
_SPLITS = 16
_WARPS = 4

_PRECISION = {
    "default": lax.Precision.DEFAULT,
    "bf16x3": lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_t(t_dim: int) -> int:
    return max(_MIN_T, pl.next_power_of_2(t_dim))


def _idx(v):
    """A computed index in JAX's default int type, like the static indices
    beside it: with x64 on (interpret mode in the CPU tests) an int32
    program id would otherwise meet int64 constants inside one slice."""
    return jnp.asarray(v, jax.dtypes.canonicalize_dtype(jnp.int64))


def _tile(ref, r0, c0, nrows, ncols, rows, cols):
    """Masked [nrows, ncols] load at (r0, c0); zeros outside [rows, cols]."""
    r = r0 + jnp.arange(nrows)
    c = c0 + jnp.arange(ncols)
    mask = (r < rows)[:, None] & (c < cols)[None, :]
    return plgpu.load(
        ref.at[pl.ds(r0, nrows), pl.ds(c0, ncols)], mask=mask, other=0.0
    ), mask


def _fwd_kernel(x_ref, w_ref, o_ref, *, dp1, rows, cols, prec):
    r0 = _idx(pl.program_id(0) * _TB)
    t_pad = o_ref.shape[1]

    def chunk(k, acc):
        c0 = pl.multiple_of(_idx(k * _BN), _BN)
        x, _ = _tile(x_ref, r0, c0, _TB, _BN, rows, cols)
        t = jnp.tanh(x)
        prev, cur = jnp.ones_like(t), t
        for d in range(dp1):
            w = w_ref[d, pl.ds(c0, _BN), :]
            acc += pl.dot(prev if d == 0 else cur, w, precision=prec)
            if d:
                prev, cur = cur, 2.0 * t * cur - prev
        return acc

    acc = lax.fori_loop(
        0, pl.cdiv(cols, _BN), chunk, jnp.zeros((_TB, t_pad), jnp.float32)
    )
    r = r0 + jnp.arange(_TB)
    plgpu.store(
        o_ref.at[pl.ds(r0, _TB), :], acc.astype(o_ref.dtype),
        mask=(r < rows)[:, None],
    )


def _dw_kernel(x_ref, g_ref, dw_ref, *, dp1, rows, cols, blocks_per_split,
               prec):
    c0 = pl.multiple_of(_idx(pl.program_id(0) * _BN), _BN)
    split = _idx(pl.program_id(1))
    t_pad = g_ref.shape[1]

    def block(j, dws):
        r0 = _idx((split * blocks_per_split + j) * _TB)
        x, _ = _tile(x_ref, r0, c0, _TB, _BN, rows, cols)
        g, _ = _tile(g_ref, r0, 0, _TB, t_pad, rows, t_pad)
        t = jnp.tanh(x)
        # rows past the batch load g = 0, so they add nothing to dW
        prev, cur = jnp.ones_like(t), t
        dws = list(dws)
        dws[0] += pl.dot(prev, g, trans_a=True, precision=prec)
        for d in range(1, dp1):
            dws[d] += pl.dot(cur, g, trans_a=True, precision=prec)
            prev, cur = cur, 2.0 * t * cur - prev
        return tuple(dws)

    zero = jnp.zeros((_BN, t_pad), jnp.float32)
    dws = lax.fori_loop(0, blocks_per_split, block, (zero,) * dp1)
    for d in range(dp1):
        dw_ref[split, d, pl.ds(c0, _BN), :] = dws[d]


def _pad_weights(w: jax.Array, dp1: int, cols: int) -> jax.Array:
    """Degree-major [dp1*in, T] -> zero-padded [dp1, in_pad, T_pad] f32."""
    t_dim = w.shape[1]
    w3 = w.reshape(dp1, cols, t_dim).astype(jnp.float32)
    return jnp.pad(
        w3,
        ((0, 0), (0, _round_up(cols, _BN) - cols), (0, _pad_t(t_dim) - t_dim)),
    )


@partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def kan_layer_fused(
    x: jax.Array, w: jax.Array, dp1: int, precision: str = "default",
    interpret: bool = False,
) -> jax.Array:
    """Fused layer: ``[B, in]`` x degree-major ``[dp1*in, T]`` -> ``[B, T]``.

    ``w[d*in + i, t]`` multiplies ``T_d(tanh(x[:, i]))``.  Computes in f32
    and returns f32; differentiable in ``x`` and ``w``.
    """
    return _fwd(x, w, dp1, precision, interpret)[0]


def _fwd(x, w, dp1, precision, interpret):
    rows, cols = x.shape
    t_dim = w.shape[1]
    wp = _pad_weights(w, dp1, cols)
    kernel = partial(
        _fwd_kernel, dp1=dp1, rows=rows, cols=cols,
        prec=_PRECISION[precision],
    )
    out = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(rows, _TB),),
        out_shape=jax.ShapeDtypeStruct((rows, wp.shape[2]), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=_WARPS, num_stages=2),
        interpret=interpret,
        name="kan_layer_fused_fwd",
    )(x.astype(jnp.float32), wp)
    return out[:, :t_dim], (x, w)


def _bwd(dp1, precision, interpret, res, g):
    x, w = res
    rows, cols = x.shape
    t_dim = w.shape[1]
    prec = _PRECISION[precision]
    xf, gf = x.astype(jnp.float32), g.astype(jnp.float32)
    w3 = w.reshape(dp1, cols, t_dim).astype(jnp.float32)
    # dx: the U_{d-1} recurrence times g @ W_d^T, degree by degree
    t = jnp.tanh(xf)
    u_prev, u_cur = jnp.zeros_like(t), jnp.ones_like(t)  # U_{-1}, U_0
    dt = jnp.zeros_like(t)
    for d in range(1, dp1):
        dt += (float(d) * u_cur) * lax.dot(gf, w3[d].T, precision=prec)
        u_prev, u_cur = u_cur, 2.0 * t * u_cur - u_prev
    dx = (1.0 - t * t) * dt
    # dW: the kernel, from per-split partials
    wp = _pad_weights(w, dp1, cols)
    gp = jnp.pad(gf, ((0, 0), (0, wp.shape[2] - t_dim)))
    blocks = pl.cdiv(rows, _TB)
    splits = min(_SPLITS, blocks)
    dw = pl.pallas_call(
        partial(
            _dw_kernel, dp1=dp1, rows=rows, cols=cols,
            blocks_per_split=pl.cdiv(blocks, splits), prec=prec,
        ),
        grid=(wp.shape[1] // _BN, splits),
        out_shape=jax.ShapeDtypeStruct((splits,) + wp.shape, jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=_WARPS, num_stages=2),
        interpret=interpret,
        name="kan_layer_fused_wgrad",
    )(xf, gp)
    dw = dw.sum(axis=0)[:, :cols, :t_dim].reshape(w.shape)
    return dx.astype(x.dtype), dw.astype(w.dtype)


kan_layer_fused.defvjp(_fwd, _bwd)

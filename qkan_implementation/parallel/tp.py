"""Tensor-parallel KAN layers: Megatron-style row parallelism.

The fused layer forward is one contraction
``[B, in*(D+1)] @ [in*(D+1), T]`` (models/fixed_kan.kan_layer_apply).  The
reference has no model-parallel axis at all (single-process torch,
KAN_w_cumulative_polynomials.py); across devices the natural split of that
contraction is the *row* (input-feature) dimension:

- input features and the coefficient tensor's ``in`` axis shard over a
  ``tp`` mesh axis; tanh + the Chebyshev basis are elementwise in the
  feature axis, so they stay local to the shard;
- every device computes a partial ``[B, T]`` product from its feature
  slice; a single ``psum`` over ``tp`` completes the contraction.  When the
  NEXT layer is also feature-sharded the reduction is a ``psum_scatter``
  instead — each device receives exactly its slice of the next layer's
  input, which moves half the bytes of an all-reduce and skips the
  re-slice;
- layers whose ``in_dim`` does not divide the ``tp`` axis fall back to
  replicated compute for that layer (the partials would be ragged); the
  decision is static per layer.

Composes with data parallelism on a 2-D ``(dp, tp)`` mesh: the batch axis
shards over ``dp``.  Gradient reductions are NOT hand-inserted: under
``check_vma=True`` shard_map tracks which values vary over which mesh axes,
so differentiating through the forward gives each coefficient shard its
local gradient while tp-invariant leaves (horizontal weights of a sharded
layer) and dp-invariant params automatically receive the required psums in
the transpose.  (With ``check_vma=False`` psum is its own transpose — the
old pmap convention — which double-counts by the axis size; measured 8x on
the 2x4 mesh before this was pinned.)  Parity with the single-device path
is exact under x64: tests/test_parallel_tp.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qkan_implementation.models.fixed_kan import (
    _FORWARD_PRECISION_MIN_FANIN,
    _resolve_forward_precision,
    kan_layer_apply,
)


def _tp_layer_flags(params: list, n_tp: int, x_dim: int) -> list[bool]:
    """Static per-layer decision: shard the ``in`` axis over tp?"""
    flags = []
    in_dim = x_dim
    for lp in params:
        c_in = lp["coefficients"].shape[1]
        if c_in != in_dim:
            raise ValueError(
                f"layer expects in_dim={c_in}, previous layer produces "
                f"{in_dim}"
            )
        flags.append(n_tp > 1 and in_dim % n_tp == 0)
        in_dim = lp["coefficients"].shape[3]  # every layer outputs target_dim
    return flags


def _param_specs(params: list, flags: list[bool], tp_axis: str) -> list:
    """PartitionSpec pytree matching ``params`` (degrees/hw replicated)."""
    specs = []
    for lp, sharded in zip(params, flags):
        spec = {k: P() for k in lp}
        if sharded:
            spec["coefficients"] = P(None, tp_axis, None, None)
        specs.append(spec)
    return specs


def _forward_local(
    params, x, max_degree, flags, tp_axis, n_tp, compute_dtype,
    matmul_precision="auto",
):
    """Per-device forward: partial contractions + tp reductions.

    ``x`` arrives feature-sharded iff ``flags[0]``.  Between two
    consecutive sharded layers the reduction is a tiled ``psum_scatter``
    over the feature axis, so the intermediate never materializes
    replicated.

    The fan-in-aware precision policy is resolved against the GLOBAL
    contraction width, not the local shard's: a flagship layer (fan-in
    4704) sharded 16-way sees only 294 local rows, but the psum'd result
    is still a 4704-term contraction -- exactly the width where a single
    bf16 pass costs 5.6 accuracy points (eval_precision_probe, r4).
    Deciding on local width would silently drop the bf16x3 pin under tp.
    """
    cur = x
    n_layers = len(params)
    for i, (lp, sharded) in enumerate(zip(params, flags)):
        fan_in_global = (
            lp["coefficients"].shape[1]
            * (max_degree + 1)
            * (n_tp if sharded else 1)
        )
        prec = _resolve_forward_precision(
            matmul_precision, fan_in_global,
            jnp.result_type(cur, lp["coefficients"]),
        )
        y = kan_layer_apply(
            lp, cur, max_degree, compute_dtype, matmul_precision=prec
        )
        if sharded:
            next_sharded = i + 1 < n_layers and flags[i + 1]
            if next_sharded:
                y = jax.lax.psum_scatter(
                    y, tp_axis, scatter_dimension=1, tiled=True
                )
            else:
                y = jax.lax.psum(y, tp_axis)
        elif i + 1 < n_layers and flags[i + 1]:
            # replicated output feeding a sharded layer: take our slice
            chunk = y.shape[1] // n_tp
            y = jax.lax.dynamic_slice_in_dim(
                y, jax.lax.axis_index(tp_axis) * chunk, chunk, axis=1
            )
        cur = y
    return cur


def _resolve_axes(mesh: Mesh, tp_axis: str, dp_axis: str | None):
    """Validate the mesh against the requested axes.

    ``dp_axis='auto'`` resolves to ``'dp'`` when the mesh carries one
    (and to ``None`` on a pure-tp/pp mesh), so the default works on both
    1-D and 2-D meshes; an EXPLICIT missing axis still raises.
    Returns ``(model_axis_size, dp_axis)``.
    """
    if dp_axis == "auto":
        dp_axis = "dp" if "dp" in mesh.axis_names else None
    if tp_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}, no model axis {tp_axis!r}"
        )
    if dp_axis is not None and dp_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}, no dp axis {dp_axis!r}"
        )
    extra = set(mesh.axis_names) - {tp_axis, dp_axis}
    if extra:
        raise ValueError(
            f"unused mesh axes {sorted(extra)}: these paths shard over "
            f"(dp, {tp_axis!r}) only"
        )
    return mesh.shape[tp_axis], dp_axis


def kan_apply_tp(
    params: list,
    x: jax.Array,
    max_degree: int,
    mesh: Mesh,
    tp_axis: str = "tp",
    dp_axis: str | None = "auto",
    compute_dtype=None,
    matmul_precision: str | None = "auto",
) -> jax.Array:
    """Tensor-parallel forward: [B, in] -> [B, target_dim], replicated out.

    ``mesh`` must carry ``tp_axis`` (and ``dp_axis`` if given; the batch
    then shards over it).  Equals ``kan_apply`` up to reduction order in
    float dtypes.  ``compute_dtype=int8`` is the one exception: the
    quantized matmul derives per-channel scales from each device's row
    slice of W and rounds partial products independently before the psum,
    so outputs drift ~1% from single-device int8 (measured 0.07 abs on a
    ~6.8-scale output) -- validate int8 tp serving against the tp path
    itself, not the single-chip int8 reference.
    """
    n_tp, dp_axis = _resolve_axes(mesh, tp_axis, dp_axis)
    flags = _tp_layer_flags(params, n_tp, x.shape[1])
    if compute_dtype is not None and compute_dtype not in (
        "int8x2", "int8x2w"
    ) and jnp.dtype(compute_dtype) == jnp.int8:
        # the wide-fan-in chance-accuracy warning in kan_layer_apply checks
        # the LOCAL shard's W rows, which an n_tp-way shard can pull below
        # the threshold while the psum'd contraction is still global-wide
        # -- mirror the precision policy and warn on GLOBAL fan-in here
        # (ADVICE r4).  Unlike _forward_local, the params HERE are still
        # the global (unsharded) pytree, so shape[1] IS the global in-dim.
        for lp in params:
            fan_in_global = lp["coefficients"].shape[1] * (max_degree + 1)
            if fan_in_global >= _FORWARD_PRECISION_MIN_FANIN:
                import warnings

                warnings.warn(
                    f"int8 tp serving at GLOBAL fan-in {fan_in_global} >= "
                    f"{_FORWARD_PRECISION_MIN_FANIN}: quantization noise "
                    "at this contraction width measured chance accuracy "
                    "on the flagship shape (benchmarks/"
                    "eval_precision_probe.py); use compute_dtype=None",
                    stacklevel=2,
                )
                break
    specs = _param_specs(params, flags, tp_axis)
    x_spec = P(dp_axis, tp_axis if flags[0] else None)
    if dp_axis is not None and x.shape[0] % mesh.shape[dp_axis] != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by dp axis "
            f"{mesh.shape[dp_axis]}"
        )

    fwd = jax.shard_map(
        partial(
            _forward_local,
            max_degree=max_degree,
            flags=flags,
            tp_axis=tp_axis,
            n_tp=n_tp,
            compute_dtype=compute_dtype,
            matmul_precision=matmul_precision,
        ),
        mesh=mesh,
        in_specs=(specs, x_spec),
        out_specs=P(dp_axis, None),
        check_vma=True,
    )
    return fwd(params, x)


def make_tp_train_step(
    mesh: Mesh,
    max_degree: int,
    learning_rate: float = 1e-3,
    tp_axis: str = "tp",
    dp_axis: str | None = "auto",
    compute_dtype=None,
    matmul_precision: str | None = "auto",
):
    """A jitted SGD train step over the (dp, tp) mesh.

    Returns ``step(train_params, degrees, x, y) -> (new_params, loss)``
    where ``train_params`` is the params list WITHOUT the integer
    ``degrees`` leaves (non-differentiable; passed alongside), sharded per
    ``shard_params``.  Loss is global MSE; gradient reductions over ``dp``
    and ``tp`` come from the vma-aware transpose (module docstring).
    """
    if compute_dtype is not None and (
        compute_dtype in ("int8x2", "int8x2w")
        or jnp.dtype(compute_dtype) == jnp.int8
    ):
        # same guard as FixedKAN.train: the rounded int8 operands have
        # zero tangent, so "training" through them applies garbage updates
        raise ValueError("int8 rounding has zero gradient; use bf16")

    def build(train_params, degrees, x, y):
        full = [dict(tp_, degrees=d) for tp_, d in zip(train_params, degrees)]
        n_tp, dp_ax = _resolve_axes(mesh, tp_axis, dp_axis)
        flags = _tp_layer_flags(full, n_tp, x.shape[1])
        full_specs = _param_specs(full, flags, tp_axis)
        train_specs = [
            {k: v for k, v in s.items() if k != "degrees"} for s in full_specs
        ]
        deg_specs = [P() for _ in degrees]
        x_spec = P(dp_ax, tp_axis if flags[0] else None)
        batch = x.shape[0]

        def local_step(train_params, degrees, xb, yb):
            def loss_fn(tps):
                full = [
                    dict(tp_, degrees=d) for tp_, d in zip(tps, degrees)
                ]
                pred = _forward_local(
                    full, xb, max_degree, flags, tp_axis, n_tp,
                    compute_dtype, matmul_precision,
                )
                sse = jnp.sum((pred - yb) ** 2)
                if dp_ax is not None:
                    sse = jax.lax.psum(sse, dp_ax)
                return sse / (batch * yb.shape[1])

            # no hand-inserted grad psums: the vma-aware transpose reduces
            # over dp (params are dp-invariant) and over tp for the
            # tp-invariant leaves of sharded layers (module docstring)
            loss, grads = jax.value_and_grad(loss_fn)(train_params)
            new = jax.tree.map(
                lambda p, g: p - learning_rate * g, train_params, grads
            )
            return new, loss

        return jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(train_specs, deg_specs, x_spec, P(dp_ax, None)),
            out_specs=(train_specs, P()),
            check_vma=True,
        )(train_params, degrees, x, y)

    return jax.jit(build)


def shard_params(
    params: list,
    x_dim: int,
    mesh: Mesh,
    tp_axis: str = "tp",
    dp_axis: str | None = "auto",
) -> list:
    """device_put the params pytree under its tp sharding (coefficients of
    divisible layers split over ``tp``'s axis-1; everything else
    replicated)."""
    n_tp, _ = _resolve_axes(mesh, tp_axis, dp_axis)
    flags = _tp_layer_flags(params, n_tp, x_dim)
    specs = _param_specs(params, flags, tp_axis)
    return [
        {
            k: jax.device_put(v, NamedSharding(mesh, spec[k]))
            for k, v in lp.items()
        }
        for lp, spec in zip(params, specs)
    ]

"""Pipeline-parallel KAN layers: GPipe-style microbatching.

Completes the parallelism triad (dp in models/fixed_kan, tp in parallel/tp):
layers place on pipeline stages along a ``pp`` mesh axis, microbatches
stream through a ``lax.scan`` of (apply stage, ``ppermute`` forward) ticks.
The reference is single-process torch with no model placement at all
(KAN_w_cumulative_polynomials.py); across devices this is how a network
taller than one card's memory trains.

Design:

- KAN layers after the first all map ``[B, T] -> [B, T]`` (every layer
  outputs ``target_dim``), so the inter-stage activation is a fixed
  ``[B_micro, T]`` tile and the schedule is shape-static — one compiled
  scan regardless of microbatch count.
- Stage parameters stack along a leading stage axis sharded ``P('pp')``;
  layers with differing neuron counts pad ``out`` to the max with
  zero horizontal weights (exact: a padded neuron contributes
  ``hw=0`` times its basis row).  A first layer whose ``in_dim`` differs
  from ``target_dim`` (the [784 -> ...] flagship head) runs replicated
  before the pipeline; shard it with parallel/tp.py when it dominates.
- The scan body is: inject microbatch ``t`` at stage 0, apply the local
  stage (``k`` layers, unrolled — ``k`` is tiny), collect stage ``S-1``'s
  emission, ``ppermute`` the activation ring one step forward.
  ``M`` microbatches drain in ``M + S - 1`` ticks (the classic pipeline
  bubble); ticks where a stage holds no live microbatch compute on a
  zero tile (cheap at these widths).
- Differentiating through the scan transposes every ``ppermute`` into its
  reverse permutation: the backward pass IS the reverse pipeline, no
  hand-written 1F1B schedule.  Under ``check_vma=True`` the stacked stage
  params are pp-varying, so their gradients stay stage-local, and
  dp-invariant leaves psum over ``dp`` in the transpose automatically
  (same rule as parallel/tp.py).

Exact parity with ``kan_apply`` under x64: tests/test_parallel_pp.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qkan_implementation.models.fixed_kan import kan_layer_apply
from qkan_implementation.parallel.tp import _resolve_axes


def stack_pipeline_params(params: list, n_stages: int):
    """Split layers into ``n_stages`` contiguous stages and stack.

    Returns ``(lead, stacked)``: ``lead`` is ``params[0]`` when its
    ``in_dim`` differs from ``target_dim`` (runs before the pipeline),
    else ``None``; ``stacked`` is a dict of arrays with leading axes
    ``[n_stages, k, ...]`` (``k`` layers per stage), neuron counts padded
    to the max with ``horizontal_weights = 0``.
    """
    t_dim = params[0]["coefficients"].shape[3]
    lead = None
    body = params
    if params[0]["coefficients"].shape[1] != t_dim:
        lead, body = params[0], params[1:]
    for lp in body:
        if lp["coefficients"].shape[1] != t_dim:
            raise ValueError(
                "pipeline body layers must map [B, target_dim] -> "
                f"[B, target_dim]; got in_dim "
                f"{lp['coefficients'].shape[1]} != {t_dim}"
            )
    if not body or len(body) % n_stages != 0:
        raise ValueError(
            f"{len(body)} pipeline layers do not split over "
            f"{n_stages} stages"
        )
    k = len(body) // n_stages
    max_out = max(lp["coefficients"].shape[0] for lp in body)

    def pad(lp):
        out = lp["coefficients"].shape[0]
        pw = [(0, max_out - out)]
        return {
            "degrees": jnp.pad(lp["degrees"], pw),
            "coefficients": jnp.pad(
                lp["coefficients"], pw + [(0, 0)] * 3
            ),
            "horizontal_weights": jnp.pad(lp["horizontal_weights"], pw),
        }

    padded = [pad(lp) for lp in body]
    stacked = {
        key: jnp.stack([lp[key] for lp in padded]).reshape(
            (n_stages, k) + padded[0][key].shape
        )
        for key in ("degrees", "coefficients", "horizontal_weights")
    }
    return lead, stacked


def _apply_stage(stage, x, max_degree, compute_dtype):
    """Apply one stage's k layers as an inner ``lax.scan``.

    A Python unroll here would sit inside the microbatch scan's body —
    the unroll-inside-scan pattern that multiplies program size and
    compile time.  The stacked ``[k, ...]`` stage layout scans directly.
    """

    def body(cur, lp):
        return kan_layer_apply(lp, cur, max_degree, compute_dtype), None

    out, _ = jax.lax.scan(body, x, stage)
    return out


def _pipeline_local(
    stacked, x, max_degree, microbatches, pp_axis, n_pp, compute_dtype
):
    """Per-device pipeline: [B_local, T] -> [B_local, T] (replicated out).

    ``stacked`` arrives with the stage axis consumed by shard_map (local
    shape [1, k, ...]); ``x`` is the full local batch, replicated over pp.
    """
    stage = {key: v[0] for key, v in stacked.items()}
    b = x.shape[0]
    if b % microbatches != 0:
        raise ValueError(
            f"local batch {b} not divisible by microbatches={microbatches}"
        )
    bm = b // microbatches
    xm = x.reshape(microbatches, bm, x.shape[1])
    idx = jax.lax.axis_index(pp_axis)
    fwd_perm = [(i, (i + 1) % n_pp) for i in range(n_pp)]

    def tick(carry, t):
        state, outs = carry
        # stage 0 injects microbatch t (clamped gather; dead ticks reuse
        # the last microbatch and their results are never collected)
        inj = jax.lax.dynamic_index_in_dim(
            xm, jnp.clip(t, 0, microbatches - 1), keepdims=False
        )
        state = jnp.where(idx == 0, inj, state)
        y = _apply_stage(stage, state, max_degree, compute_dtype)
        # stage S-1 emits microbatch t-(S-1) once the fill drains
        pos = jnp.clip(t - (n_pp - 1), 0, microbatches - 1)
        emit = (idx == n_pp - 1) & (t >= n_pp - 1)
        old = jax.lax.dynamic_index_in_dim(outs, pos, keepdims=False)
        outs = jax.lax.dynamic_update_index_in_dim(
            outs, jnp.where(emit, y, old), pos, 0
        )
        state = jax.lax.ppermute(y, pp_axis, fwd_perm)
        return (state, outs), None

    # the carries become pp-varying after the first tick (axis_index /
    # ppermute); mark the zero initials varying up front so the scan's
    # carry type is fixed (vma tracking).  Deriving them from xm keeps any
    # dp-varying tag too.
    state0 = jax.lax.pcast(xm[0] * 0, (pp_axis,), to="varying")
    outs0 = jax.lax.pcast(xm * 0, (pp_axis,), to="varying")
    (_, outs), _ = jax.lax.scan(
        tick, (state0, outs0), jnp.arange(microbatches + n_pp - 1)
    )
    # replicate the last stage's collected outputs over pp
    mask = (idx == n_pp - 1).astype(outs.dtype)
    outs = jax.lax.psum(mask * outs, pp_axis)
    return outs.reshape(b, x.shape[1])


# shared axis validation with tp.py: 'auto' dp resolution, explicit
# missing-axis errors, and unused-mesh-axes rejection
_resolve = _resolve_axes


def _stacked_specs(stacked, pp_axis):
    return {
        key: P(pp_axis, *([None] * (v.ndim - 1)))
        for key, v in stacked.items()
    }


def kan_apply_pp(
    params,
    x: jax.Array,
    max_degree: int,
    mesh: Mesh,
    microbatches: int = 4,
    pp_axis: str = "pp",
    dp_axis: str | None = "auto",
    compute_dtype=None,
) -> jax.Array:
    """Pipeline-parallel forward: [B, in] -> [B, target_dim].

    Layers place over ``mesh``'s ``pp_axis`` (contiguous stages); the
    batch additionally shards over ``dp_axis`` if present (``'auto'``
    picks a ``'dp'`` mesh axis when there is one), each dp row running
    its own microbatch stream.  Equals ``kan_apply`` exactly.

    ``params`` is either the plain layer list (stacked per call) or a
    pre-placed ``(lead, stacked)`` pair from ``place_pipeline_params`` /
    ``stack_pipeline_params`` — the form that keeps each stage's layers
    resident on its own device between calls.
    """
    n_pp, dp_axis = _resolve(mesh, pp_axis, dp_axis)
    if isinstance(params, tuple):
        lead, stacked = params
        if stacked["coefficients"].shape[0] != n_pp:
            raise ValueError(
                f"stacked params carry {stacked['coefficients'].shape[0]} "
                f"stages, mesh axis {pp_axis!r} has {n_pp}"
            )
    else:
        lead, stacked = stack_pipeline_params(params, n_pp)

    def fwd(stacked, x):
        if lead is not None:
            x = kan_layer_apply(lead, x, max_degree, compute_dtype)
        return _pipeline_local(
            stacked, x, max_degree, microbatches, pp_axis, n_pp,
            compute_dtype,
        )

    return jax.shard_map(
        fwd,
        mesh=mesh,
        in_specs=(_stacked_specs(stacked, pp_axis), P(dp_axis, None)),
        out_specs=P(dp_axis, None),
        check_vma=True,
    )(stacked, x)


def make_pp_train_step(
    mesh: Mesh,
    max_degree: int,
    learning_rate: float = 1e-3,
    microbatches: int = 4,
    pp_axis: str = "pp",
    dp_axis: str | None = "auto",
    compute_dtype=None,
):
    """A jitted SGD train step with pipeline (+ optional data) parallelism.

    Returns ``step(lead_train, lead_degrees, stacked_train,
    stacked_degrees, x, y) -> ((lead_train, stacked_train), loss)`` where
    ``stacked_*`` come from ``stack_pipeline_params`` split into trainable
    leaves vs integer degrees (``lead_*`` may be ``None``).  The backward
    pipeline pass comes from transposing the forward scan's ppermutes
    (module docstring); gradient dp-reductions from the vma transpose.
    """
    if compute_dtype is not None and jnp.dtype(compute_dtype) == jnp.int8:
        # same guard as FixedKAN.train: the rounded int8 operands have
        # zero tangent, so "training" through them applies garbage updates
        raise ValueError("int8 rounding has zero gradient; use bf16")
    n_pp, dp_axis = _resolve(mesh, pp_axis, dp_axis)

    def build(lead_train, lead_degrees, stacked_train, stacked_degrees, x, y):
        batch = x.shape[0]
        specs = (
            None if lead_train is None else {k: P() for k in lead_train},
            _stacked_specs(stacked_train, pp_axis),
        )

        def local_step(lead_train, stacked_train, stacked_deg, xb, yb):
            def loss_fn(args):
                lead_t, stacked_t = args
                cur = xb
                if lead_t is not None:
                    lead = dict(lead_t, degrees=lead_degrees)
                    cur = kan_layer_apply(
                        lead, cur, max_degree, compute_dtype
                    )
                stacked = dict(stacked_t, degrees=stacked_deg)
                pred = _pipeline_local(
                    stacked, cur, max_degree, microbatches, pp_axis,
                    n_pp, compute_dtype,
                )
                sse = jnp.sum((pred - yb) ** 2)
                if dp_axis is not None:
                    sse = jax.lax.psum(sse, dp_axis)
                return sse / (batch * yb.shape[1])

            loss, grads = jax.value_and_grad(loss_fn)(
                (lead_train, stacked_train)
            )
            new = jax.tree.map(
                lambda p, g: p - learning_rate * g,
                (lead_train, stacked_train),
                grads,
            )
            return new, loss

        # stacked degrees ride as a pp-sharded OPERAND, not a closure
        # constant: a closed-over array broadcasts whole to every device,
        # and the stage-local [0]-indexing would read stage 0's degrees
        # everywhere
        deg_spec = P(pp_axis, *([None] * (stacked_degrees.ndim - 1)))
        return jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(
                specs[0], specs[1], deg_spec, P(dp_axis, None),
                P(dp_axis, None),
            ),
            out_specs=(specs, P()),
            check_vma=True,
        )(lead_train, stacked_train, stacked_degrees, x, y)

    return jax.jit(build)


def place_pipeline_params(
    params: list,
    mesh: Mesh,
    pp_axis: str = "pp",
    dp_axis: str | None = "auto",
):
    """``stack_pipeline_params`` + device_put under the pp sharding.

    Returns ``(lead, stacked)`` with ``stacked`` stage-sharded (each
    device holds only its stage's layers) and ``lead`` replicated;
    feed the pair straight to ``kan_apply_pp``.
    """
    n_pp, _ = _resolve(mesh, pp_axis, dp_axis)
    lead, stacked = stack_pipeline_params(params, n_pp)
    specs = _stacked_specs(stacked, pp_axis)
    stacked = {
        k: jax.device_put(v, NamedSharding(mesh, specs[k]))
        for k, v in stacked.items()
    }
    if lead is not None:
        lead = {
            k: jax.device_put(v, NamedSharding(mesh, P()))
            for k, v in lead.items()
        }
    return lead, stacked

"""On-device batched simulated annealing over QUBOs.

JAX replacement for neal's C++ ``SimulatedAnnealingSampler``
(reference ``DegreeOptimizer.py:236-237``, num_reads=1000): all ``num_reads``
chains run as one batched computation -- state [R, n], local fields
maintained incrementally, sequential-variable Metropolis sweeps via
``lax.scan`` under a geometric temperature schedule.  Each sweep is O(R*n^2)
fused vector work, exactly the shape the VPU wants; chains can additionally
be sharded across a device mesh (chain parallelism, SURVEY.md section 2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.anneal.qubo import QuboModel


def default_beta_range(model: QuboModel) -> tuple[float, float]:
    """Heuristic (beta_hot, beta_cold) from the coupling magnitudes.

    Hot: even the largest single-flip |dE| is accepted with prob 1/2.
    Cold: the smallest *individual* nonzero bias (the finest energy scale in
    the problem, e.g. the complexity-weight gaps between degree choices) is
    rejected with prob 99/100.  Same heuristic family as neal's default.
    """
    abs_fields = np.abs(model.h) + np.sum(np.abs(model.J), axis=1)
    max_de = float(np.max(abs_fields)) if abs_fields.size else 1.0
    entries = np.concatenate([np.abs(model.h).ravel(), np.abs(model.J).ravel()])
    nonzero = entries[entries > 1e-12]
    min_de = float(np.min(nonzero)) if nonzero.size else 1.0
    # The finest scale that matters may be a *difference* of linear biases
    # (degree gaps), not a bias itself; include pairwise h-gaps.
    h_sorted = np.sort(np.abs(model.h))
    gaps = np.diff(h_sorted)
    gaps = gaps[gaps > 1e-9]
    if gaps.size:
        min_de = min(min_de, float(np.min(gaps)))
    max_de = max(max_de, 1e-12)
    min_de = max(min_de, 1e-9)
    beta_hot = np.log(2.0) / max_de
    beta_cold = max(np.log(100.0) / min_de, 10.0 * beta_hot)
    return (beta_hot, beta_cold)


def default_tempering_beta_range(model: QuboModel) -> tuple[float, float]:
    """Ladder-specific (beta_hot, beta_cold) for parallel tempering.

    SA's geometric SCHEDULE visits ``num_sweeps`` (~1000) temperatures, so
    anchoring its cold end to the finest energy scale (``min |entry|``,
    ``default_beta_range``) costs nothing.  A tempering LADDER has only
    ``num_replicas`` (~16) rungs, and the whole mechanism is
    adjacent-rung exchange: stretching 16 rungs over the min-scale span
    (beta_cold ~ 2.3e8 on a dense Gaussian n=2048) spaces neighbors so far
    apart that exchanges never accept, every rung quenches independently,
    and PT loses to plain SA (r5 measured: best energy -1136.76 vs SA's
    -1137.37 on the n=2048 head-to-head).  Anchoring the cold end to the
    MEDIAN coupling scale (beta_cold ~ 218 on the same instance) restores
    exchange flow and matches SA's best energy at 8, 16, and 32 replicas
    on the same chain budget (``benchmarks/anneal_bench.py``).  Callers who
    need the min-scale cold end (fine bias gaps) can pass ``beta_range``
    explicitly.
    """
    beta_hot, _ = default_beta_range(model)
    entries = np.concatenate(
        [np.abs(model.h).ravel(), np.abs(model.J).ravel()]
    )
    nonzero = entries[entries > 1e-12]
    med = float(np.median(nonzero)) if nonzero.size else 1.0
    beta_cold = max(np.log(100.0) / max(med, 1e-9), 20.0 * beta_hot)
    return (beta_hot, beta_cold)


@partial(jax.jit, static_argnames=("num_reads", "num_sweeps"))
def _anneal_kernel(h, J, betas, key, num_reads: int, num_sweeps: int):
    n = h.shape[0]
    key, init_key = jax.random.split(key)
    s = jax.random.bernoulli(init_key, 0.5, (num_reads, n)).astype(h.dtype)

    # local fields: f[r, i] = dE of flipping i from 0 -> 1 direction factor,
    # i.e. E contribution h_i + sum_j J_ij s_j
    f = h[None, :] + s @ J

    def sweep(carry, beta_key):
        s, f = carry
        beta, key = beta_key

        def flip_var(carry, i):
            s, f, key = carry
            key, sub = jax.random.split(key)
            de = (1.0 - 2.0 * s[:, i]) * f[:, i]
            u = jax.random.uniform(sub, (num_reads,), dtype=h.dtype)
            accept = (de <= 0.0) | (u < jnp.exp(-beta * de))
            delta = jnp.where(accept, 1.0 - 2.0 * s[:, i], 0.0)
            s = s.at[:, i].add(delta)
            f = f + delta[:, None] * J[i][None, :]
            return (s, f, key), None

        (s, f, key), _ = jax.lax.scan(flip_var, (s, f, key), jnp.arange(n))
        return (s, f), None

    keys = jax.random.split(key, num_sweeps)
    (s, f), _ = jax.lax.scan(sweep, (s, f), (betas, keys))

    energies = s @ h + 0.5 * jnp.einsum("ri,ij,rj->r", s, J, s)
    return s, energies


_HI = jax.lax.Precision.HIGHEST  # f32 dots may otherwise run in TF32


def _delayed_structs(J, block: int):
    """Static per-problem structures for the delayed-update sweep:
    row blocks of J, and the within-block coupling rows PRE-ROLLED so that
    row r of the rolled diagonal block couples variable j with variable
    (j + r) mod block -- aligned with the rolling field buffer in
    ``_delayed_sweep``."""
    n = J.shape[0]
    nb = n // block
    J_rows = J.reshape(nb, block, n)  # scan xs: leading-axis slicing is free
    J_diag = J.reshape(nb, block, nb, block)[
        jnp.arange(nb), :, jnp.arange(nb), :
    ]  # [nb, block, block] within-block couplings
    roll_idx = (
        np.arange(block)[:, None] + np.arange(block)[None, :]
    ) % block
    Jd_rolled = J_diag[:, np.arange(block)[:, None], roll_idx]
    i0s = jnp.arange(nb) * block
    return J_rows, Jd_rolled, i0s


def _delayed_sweep(s, f, beta_r, u, J_rows, Jd_rolled, i0s, block: int):
    """One delayed-update sequential Metropolis sweep over all variables.

    The schedule shared by the SA and tempering kernels: the
    chain is the per-variable sequential sweep (variables visited in index
    order, each seeing every earlier acceptance through its field), but the
    O(R*n) global field update per flip is DEFERRED -- within a block only
    the block's own field rows are maintained (O(R*block) VPU work per
    variable, via a rolling [block, R] buffer whose row 0 is always the
    current variable), and the full-field update lands as ONE
    [n,block]x[block,R] matmul per block: matrix-unit work instead of n
    scan steps of strided minor-axis updates.  Layout is [n, R] (reads on
    the minor axis, so ``s.at[i]`` updates a contiguous row), and the inner
    loop is a scan (a 32-wide static unroll makes a far larger program to
    compile).  The block size (``sweep_block``, 32 by default) has not been
    tuned for the GPU yet.

    ``beta_r`` is per-read [R]: a broadcast scalar for SA's annealing
    schedule, the tiled temperature ladder for parallel tempering.

    Returns (s, f, dE) where dE [R] is the summed accepted energy change
    (for incremental energy tracking; fp drift only, callers recompute
    exact energies at the end).

    JAX replacement for neal's sequential C++ sweep (reference
    ``DegreeOptimizer.py:236-237``).
    """
    R = s.shape[1]

    def block_step(carry, xs):
        s, f = carry
        Jrow, Jdr, u_blk, i0 = xs
        sblk = jax.lax.dynamic_slice(s, (i0, 0), (block, R))
        fblk = jax.lax.dynamic_slice(f, (i0, 0), (block, R))

        def var_step(fblk, xs_j):
            s_j, u_j, Jdr_j = xs_j
            de = (1.0 - 2.0 * s_j) * fblk[0]
            accept = (de <= 0.0) | (u_j < jnp.exp(-beta_r * de))
            delta = jnp.where(accept, 1.0 - 2.0 * s_j, 0.0)
            # roll so the CURRENT variable is always row 0: rows ahead get
            # their field maintenance, processed rows roll to the back
            # (their stale fields are never read again)
            fblk = jnp.roll(fblk + delta[None, :] * Jdr_j[:, None], -1, 0)
            return fblk, (delta, jnp.where(accept, de, 0.0))

        _, (dblk, deblk) = jax.lax.scan(
            var_step, fblk, (sblk, u_blk, Jdr)
        )
        s = jax.lax.dynamic_update_slice(s, sblk + dblk, (i0, 0))
        # deferred global field update: fblk was scratch, so adding the
        # full J[block,:].T @ dblk here is exact for block rows too
        f = f + jax.lax.dot_general(
            Jrow, dblk, (((0,), (0,)), ((), ())), precision=_HI
        )
        return (s, f), jnp.sum(deblk, axis=0)

    (s, f), de_blocks = jax.lax.scan(
        block_step, (s, f), (J_rows, Jd_rolled, u, i0s)
    )
    return s, f, jnp.sum(de_blocks, axis=0)


@partial(jax.jit, static_argnames=("num_reads", "num_sweeps", "block"))
def _anneal_kernel_delayed(
    h, J, betas, key, num_reads: int, num_sweeps: int, block: int
):
    """Delayed-update sequential-sweep SA (see ``_delayed_sweep``).

    Produces the SAME Markov chain as a per-variable sequential Metropolis
    sweep consuming the same uniforms in the same variable order (pinned by
    the block-size-invariance test at x64); ``block`` is a pure scheduling
    knob.
    """
    n = h.shape[0]
    R = num_reads
    assert n % block == 0, "caller pads n to a multiple of block"
    nb = n // block
    key, init_key = jax.random.split(key)
    s = jax.random.bernoulli(init_key, 0.5, (n, R)).astype(h.dtype)
    f = h[:, None] + jax.lax.dot_general(
        J, s, (((1,), (0,)), ((), ())), precision=_HI
    )
    structs = _delayed_structs(J, block)

    def sweep(carry, beta_key):
        s, f = carry
        beta, skey = beta_key
        # one RNG draw per sweep, consumed in variable order (the per-step
        # key split of the naive kernel is 2 extra ops per variable)
        u = jax.random.uniform(skey, (nb, block, R), dtype=h.dtype)
        s, f, _ = _delayed_sweep(
            s, f, jnp.broadcast_to(beta, (R,)), u, *structs, block
        )
        return (s, f), None

    keys = jax.random.split(key, num_sweeps)
    (s, f), _ = jax.lax.scan(sweep, (s, f), (betas, keys))
    s_flat = s.T  # [R, n]
    energies = s_flat @ h + 0.5 * jnp.einsum(
        "ri,ij,rj->r", s_flat, J, s_flat, precision=_HI
    )
    return s_flat, energies


@partial(
    jax.jit,
    static_argnames=("num_chains", "num_replicas", "num_sweeps", "block"),
)
def _tempering_kernel_delayed(
    h, J, betas, key, num_chains: int, num_replicas: int,
    num_sweeps: int, block: int,
):
    """Parallel tempering on the delayed-update sweep.

    Same replica-exchange algebra as ``_tempering_kernel`` (shared
    ``_apply_replica_swaps``), but each replica's Metropolis sweep runs
    through ``_delayed_sweep`` with the temperature ladder tiled into the
    per-read beta vector: state [n, C*T] with reads on lanes, deferred
    field updates.  Energies are maintained incrementally from the sweep's
    accepted-dE sums (exchange decisions), with an exact recompute at the
    end.
    """
    n = h.shape[0]
    C, T = num_chains, num_replicas
    R = C * T
    nb = n // block
    beta_r = jnp.tile(betas, C)  # read r = c*T + t holds replica t
    key, init_key = jax.random.split(key)
    s = jax.random.bernoulli(init_key, 0.5, (n, R)).astype(h.dtype)
    f = h[:, None] + jax.lax.dot_general(
        J, s, (((1,), (0,)), ((), ())), precision=_HI
    )
    E = jax.lax.dot_general(
        s, h, (((0,), (0,)), ((), ())), precision=_HI
    ) + 0.5 * jnp.einsum("ir,ij,jr->r", s, J, s, precision=_HI)
    structs = _delayed_structs(J, block)
    even = (jnp.arange(T - 1) % 2) == 0

    def sweep(carry, skey):
        s, f, E = carry
        skey, flip_key = jax.random.split(skey)
        u = jax.random.uniform(flip_key, (nb, block, R), dtype=h.dtype)
        s, f, dE = _delayed_sweep(s, f, beta_r, u, *structs, block)
        E = E + dE

        # replica exchange, even pairs then odd pairs, via the shared swap
        # algebra on [C, T, n] views (transposes are n*R*4B -- trivial next
        # to the sweep)
        for parity in (0, 1):
            skey, ex_key = jax.random.split(skey)
            E2 = E.reshape(C, T)
            dB = betas[:-1] - betas[1:]
            dE2 = E2[:, :-1] - E2[:, 1:]
            logp = dB[None, :] * dE2
            u2 = jax.random.uniform(ex_key, (C, T - 1), dtype=h.dtype)
            pair_mask = even if parity == 0 else ~even
            do_swap = (jnp.log(u2) < logp) & pair_mask[None, :]
            s_v = jnp.moveaxis(s.reshape(n, C, T), 0, 2)
            f_v = jnp.moveaxis(f.reshape(n, C, T), 0, 2)
            s_v, f_v, E2 = _apply_replica_swaps(s_v, f_v, E2, do_swap)
            s = jnp.moveaxis(s_v, 2, 0).reshape(n, R)
            f = jnp.moveaxis(f_v, 2, 0).reshape(n, R)
            E = E2.reshape(R)
        return (s, f, E), None

    keys = jax.random.split(key, num_sweeps)
    (s, f, E), _ = jax.lax.scan(sweep, (s, f, E), keys)
    s_flat = s.T
    energies = s_flat @ h + 0.5 * jnp.einsum(
        "ri,ij,rj->r", s_flat, J, s_flat, precision=_HI
    )
    return s_flat, energies


def _pad_for_block(h, J, block: int):
    """Zero-pad (h, J) so the variable count is a multiple of ``block``.
    Padding variables have zero bias and zero couplings: they random-walk
    freely and contribute nothing to any energy or field."""
    n = h.shape[0]
    pad = (-n) % block
    if pad == 0:
        return h, J, n
    h2 = np.zeros(n + pad, dtype=h.dtype)
    h2[:n] = h
    J2 = np.zeros((n + pad, n + pad), dtype=J.dtype)
    J2[:n, :n] = J
    return h2, J2, n


def _prepare_delayed(model: QuboModel, dtype, sweep_block: int | None):
    """Shared preparation for the delayed-update kernels: validate/derive
    the sweep block, zero-pad (h, J) to a block multiple at f64, and cast
    to the kernel dtype.  Returns ``(h, J, n_orig, sweep_block)``.

    One definition for all four entry points (single/sharded SA and
    tempering) so the auto-block heuristic and the padding contract
    cannot diverge between them."""
    n = model.num_variables
    if sweep_block is None:
        sweep_block = min(32, 1 << (n - 1).bit_length())
    elif not isinstance(sweep_block, int) or sweep_block < 1:
        raise ValueError(
            f"sweep_block must be a positive int, got {sweep_block!r}"
        )
    h_np, J_np, n_orig = _pad_for_block(
        model.h.astype(np.float64), model.J.astype(np.float64), sweep_block
    )
    return (
        jnp.asarray(h_np, dtype=dtype),
        jnp.asarray(J_np, dtype=dtype),
        n_orig,
        sweep_block,
    )


def simulated_annealing(
    model: QuboModel,
    num_reads: int = 1000,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=jnp.float32,
    backend: str = "jax",
    block_structure: int | None = None,
    sweep_block: int | None = None,
):
    """Sample a QUBO with batched SA.  Returns (samples [R, n], energies [R]).

    Energies include the model offset, matching the reference's
    ``min(decoded, key=lambda x: x.energy)`` selection semantics.

    ``backend='jax'`` runs all chains on-device; ``'native'``
    uses the C++ annealer (host CPU -- the neal-equivalent, useful for tiny
    problems where device dispatch dominates).

    ``block_structure``: when the QUBO is block-diagonal with this block
    size (verified; falls back silently otherwise), variables in different
    blocks flip simultaneously -- a sweep is block_size sequential steps
    instead of n, the latency win for the per-function-independent degree
    QUBO.

    ``sweep_block``: delayed-update block size for the dense path (see
    ``_anneal_kernel_delayed``); the chain is block-size-invariant, so this
    is a pure scheduling knob.  None = auto (min(32, next pow2 >= n)).
    """
    if backend not in ("jax", "native"):
        raise ValueError(
            f"unknown backend {backend!r}: expected 'jax' or 'native'"
        )
    if backend == "native":
        from qkan_implementation.native_bindings import anneal_native

        return anneal_native(model, num_reads, num_sweeps, beta_range, seed)
    if beta_range is None:
        beta_range = default_beta_range(model)
    betas = jnp.asarray(
        np.geomspace(beta_range[0], beta_range[1], num_sweeps), dtype=dtype
    )
    key = jax.random.key(seed)
    J_blocks = (
        _block_diagonal_J(model, block_structure)
        if block_structure is not None
        else None
    )
    if J_blocks is not None:
        nb = model.num_variables // block_structure
        samples, energies = _anneal_kernel_blocked(
            jnp.asarray(model.h.reshape(nb, block_structure), dtype=dtype),
            jnp.asarray(J_blocks, dtype=dtype),
            betas,
            key,
            num_reads,
            num_sweeps,
        )
    else:
        h_d, J_d, n_orig, sweep_block = _prepare_delayed(
            model, dtype, sweep_block
        )
        samples, energies = _anneal_kernel_delayed(
            h_d,
            J_d,
            betas,
            key,
            num_reads,
            num_sweeps,
            sweep_block,
        )
        samples = samples[:, :n_orig]
    return np.asarray(samples), np.asarray(energies, dtype=np.float64) + model.offset


@partial(jax.jit, static_argnames=("num_reads", "num_sweeps"))
def _anneal_kernel_blocked(h, J_blocks, betas, key, num_reads: int, num_sweeps: int):
    """SA for block-diagonal QUBOs: one variable per block flips per step.

    ``h``: [nb, bs]; ``J_blocks``: [nb, bs, bs] (symmetric, zero diagonal).
    Blocks don't interact, so a sweep is ``bs`` sequential steps instead of
    ``nb * bs`` -- the latency win that makes 1000-sweep anneals of the
    (per-function independent) degree QUBO fast on the device.
    """
    nb, bs = h.shape
    key, init_key = jax.random.split(key)
    # Layout [R, bs, nb]: the (large) block-count axis is minor and the
    # (small) within-block axis is indexed dynamically; dynamic updates
    # along a tiny minor axis would be strided.
    s = jax.random.bernoulli(init_key, 0.5, (num_reads, bs, nb)).astype(h.dtype)
    hT = h.T  # [bs, nb]
    # f[r, i, b] = h[b, i] + sum_j J_blocks[b, i, j] s[r, j, b]
    f = hT[None] + jnp.einsum("bij,rjb->rib", J_blocks, s)
    # Jrows[i][j, b] = J_blocks[b, i, j]: the field update rows per variable
    Jrows = jnp.transpose(J_blocks, (1, 2, 0))  # [bs(i), bs(j), nb]

    def sweep(carry, beta_key):
        s, f = carry
        beta, key = beta_key
        # bs is small and static: unroll (static indices compile to plain
        # slices, where a nested scan would need dynamic minor-axis updates)
        for i in range(bs):
            key, sub = jax.random.split(key)
            si = s[:, i, :]
            de = (1.0 - 2.0 * si) * f[:, i, :]
            u = jax.random.uniform(sub, (num_reads, nb), dtype=h.dtype)
            accept = (de <= 0.0) | (u < jnp.exp(-beta * de))
            delta = jnp.where(accept, 1.0 - 2.0 * si, 0.0)
            s = s.at[:, i, :].add(delta)
            f = f + delta[:, None, :] * Jrows[i][None]
        return (s, f), None

    keys = jax.random.split(key, num_sweeps)
    (s, f), _ = jax.lax.scan(sweep, (s, f), (betas, keys))
    energies = jnp.einsum("rib,bi->r", s, h) + 0.5 * jnp.einsum(
        "rib,bij,rjb->r", s, J_blocks, s
    )
    # back to flat variable order: block-major [nb, bs]
    samples = jnp.transpose(s, (0, 2, 1)).reshape(num_reads, nb * bs)
    return samples, energies


def _block_diagonal_J(model: QuboModel, block_size: int):
    """Return J as [nb, bs, bs] blocks if couplings are block-diagonal,
    else None."""
    n = model.num_variables
    if block_size is None or n % block_size != 0:
        return None
    nb = n // block_size
    J = model.J.reshape(nb, block_size, nb, block_size)
    off = J.copy()
    for b in range(nb):
        off[b, :, b, :] = 0.0
    if np.any(off != 0.0):
        return None
    return np.stack([J[b, :, b, :] for b in range(nb)])


def _apply_replica_swaps(s, f, E, do_swap):
    """Lift pairwise exchange decisions ``do_swap`` [C, T-1] to per-slot
    replica swaps of (state, local field, energy) -- shared by the local
    and mesh-ladder tempering kernels so the exchange algebra cannot
    drift between them."""
    swap_lo = jnp.pad(do_swap, ((0, 0), (0, 1)))  # slot t swaps up
    swap_hi = jnp.pad(do_swap, ((0, 0), (1, 0)))  # slot t swaps down
    up = jnp.roll(s, -1, axis=1)
    down = jnp.roll(s, 1, axis=1)
    s = jnp.where(
        swap_lo[:, :, None], up, jnp.where(swap_hi[:, :, None], down, s)
    )
    f_up, f_dn = jnp.roll(f, -1, axis=1), jnp.roll(f, 1, axis=1)
    f = jnp.where(
        swap_lo[:, :, None], f_up, jnp.where(swap_hi[:, :, None], f_dn, f)
    )
    E_up, E_dn = jnp.roll(E, -1, axis=1), jnp.roll(E, 1, axis=1)
    E = jnp.where(swap_lo, E_up, jnp.where(swap_hi, E_dn, E))
    return s, f, E


@partial(
    jax.jit, static_argnames=("num_chains", "num_replicas", "num_sweeps")
)
def _tempering_kernel(
    h, J, betas, key, num_chains: int, num_replicas: int, num_sweeps: int
):
    """Parallel tempering: each chain holds a full temperature ladder.

    State [C, T, n]; every replica Metropolis-sweeps at its own fixed beta,
    then adjacent replicas attempt a state exchange with probability
    min(1, exp((beta_i - beta_j)(E_i - E_j))) -- hot replicas tunnel over
    barriers, cold replicas refine, and exchanges carry good basins down
    the ladder.  Energies are maintained incrementally (E += dE per
    accepted flip), so exchanges are O(1) per pair.
    """
    n = h.shape[0]
    C, T = num_chains, num_replicas
    key, init_key = jax.random.split(key)
    s = jax.random.bernoulli(init_key, 0.5, (C, T, n)).astype(h.dtype)
    f = h[None, None, :] + jnp.einsum("ctn,nm->ctm", s, J)
    E = jnp.einsum("ctn,n->ct", s, h) + 0.5 * jnp.einsum(
        "ctn,nm,ctm->ct", s, J, s
    )

    even = (jnp.arange(T - 1) % 2) == 0  # pair (t, t+1) parity masks

    def sweep(carry, key):
        s, f, E = carry
        key, flip_key = jax.random.split(key)

        def flip_var(carry, i):
            s, f, E, key = carry
            key, sub = jax.random.split(key)
            de = (1.0 - 2.0 * s[:, :, i]) * f[:, :, i]  # [C, T]
            u = jax.random.uniform(sub, (C, T), dtype=h.dtype)
            accept = (de <= 0.0) | (u < jnp.exp(-betas[None, :] * de))
            delta = jnp.where(accept, 1.0 - 2.0 * s[:, :, i], 0.0)
            s = s.at[:, :, i].add(delta)
            f = f + delta[:, :, None] * J[i][None, None, :]
            E = E + jnp.where(accept, de, 0.0)
            return (s, f, E, key), None

        (s, f, E, key), _ = jax.lax.scan(
            flip_var, (s, f, E, flip_key), jnp.arange(n)
        )

        # replica exchange, even pairs then odd pairs
        for parity in (0, 1):
            key, ex_key = jax.random.split(key)
            dB = betas[:-1] - betas[1:]  # [T-1] (negative: beta ascending)
            dE = E[:, :-1] - E[:, 1:]  # [C, T-1]
            logp = dB[None, :] * dE
            u = jax.random.uniform(ex_key, (C, T - 1), dtype=h.dtype)
            pair_mask = even if parity == 0 else ~even
            do_swap = (jnp.log(u) < logp) & pair_mask[None, :]  # [C, T-1]
            s, f, E = _apply_replica_swaps(s, f, E, do_swap)
        return (s, f, E), None

    keys = jax.random.split(key, num_sweeps)
    (s, f, E), _ = jax.lax.scan(sweep, (s, f, E), keys)
    s_flat = s.reshape(C * T, n)
    # exact final energies (the incremental E accumulates fp drift)
    energies = s_flat @ h + 0.5 * jnp.einsum("ri,ij,rj->r", s_flat, J, s_flat)
    return s_flat, energies


def parallel_tempering(
    model: QuboModel,
    num_chains: int = 64,
    num_replicas: int = 16,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=jnp.float32,
    sweep_block: int | None = None,
    kernel: str = "delayed",
):
    """Sample a QUBO with on-device parallel tempering (replica exchange).

    The move single-flip SA lacks for rugged, NON-separable QUBOs: a
    geometric ladder of ``num_replicas`` temperatures per chain with
    adjacent-replica state exchanges after every sweep.  All
    chains x replicas run as one batched kernel.  Returns
    (samples [C*T, n], energies [C*T]) with offset included.

    ``kernel='delayed'`` (default) runs sweeps on the delayed-update
    schedule (``_delayed_sweep``); ``'reference'`` keeps the per-variable
    kernel (the statistical-equivalence oracle).  ``sweep_block`` as in
    ``simulated_annealing``.
    """
    if beta_range is None:
        beta_range = default_tempering_beta_range(model)
    betas = jnp.asarray(
        np.geomspace(beta_range[0], beta_range[1], num_replicas), dtype=dtype
    )
    if kernel not in ("delayed", "reference"):
        raise ValueError(
            f"unknown kernel {kernel!r}: expected 'delayed' or 'reference'"
        )
    if kernel == "reference":
        samples, energies = _tempering_kernel(
            jnp.asarray(model.h, dtype=dtype),
            jnp.asarray(model.J, dtype=dtype),
            betas,
            jax.random.key(seed),
            num_chains,
            num_replicas,
            num_sweeps,
        )
    else:
        h_d, J_d, n_orig, sweep_block = _prepare_delayed(
            model, dtype, sweep_block
        )
        samples, energies = _tempering_kernel_delayed(
            h_d,
            J_d,
            betas,
            jax.random.key(seed),
            num_chains,
            num_replicas,
            num_sweeps,
            sweep_block,
        )
        samples = samples[:, :n_orig]
    return (
        np.asarray(samples),
        np.asarray(energies, dtype=np.float64) + model.offset,
    )


def parallel_tempering_sharded(
    model: QuboModel,
    mesh,
    axis_name: str = "d",
    num_chains: int = 64,
    num_replicas: int = 16,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=jnp.float32,
    sweep_block: int | None = None,
):
    """Mesh-sharded parallel tempering: chains split across devices, each
    device running full temperature ladders locally (replica exchange never
    crosses devices, so the only collective is the final gather) -- the
    tempering analog of ``simulated_annealing_sharded``.

    Returns (samples [C'*T, n], energies) with C' = ceil(C / n_dev) * n_dev.
    """
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"axis {axis_name!r} not in mesh axes {mesh.axis_names}"
        )
    # the SHARDED axis size only: on a multi-axis mesh the all-axes
    # product silently dropped reads (chains shard over axis_name alone;
    # other axes just duplicate work) or crashed the ladder split
    n_dev = int(mesh.shape[axis_name])
    chains_local = -(-num_chains // n_dev)
    if beta_range is None:
        beta_range = default_tempering_beta_range(model)
    betas = jnp.asarray(
        np.geomspace(beta_range[0], beta_range[1], num_replicas), dtype=dtype
    )
    # same delayed-update schedule as the single-device path
    h, J, n_orig, sweep_block = _prepare_delayed(model, dtype, sweep_block)
    keys = jax.random.split(jax.random.key(seed), n_dev)

    from jax.sharding import PartitionSpec as P

    def local(keys_local):
        s, e = _tempering_kernel_delayed(
            h, J, betas, keys_local[0], chains_local, num_replicas,
            num_sweeps, sweep_block,
        )
        return s[:, :n_orig], e

    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name)
        )
    )
    samples, energies = fn(keys)
    return (
        np.asarray(samples),
        np.asarray(energies, dtype=np.float64) + model.offset,
    )


def _tempering_mesh_kernel(
    h,
    J,
    betas_local,
    base_key,
    axis_name: str,
    n_dev: int,
    num_chains: int,
    t_local: int,
    num_sweeps: int,
):
    """Parallel tempering with the temperature ladder SHARDED over the mesh
    axis: global ladder T = n_dev * t_local, each device sweeping its
    ``t_local`` replicas locally.  Runs inside ``shard_map``.

    Within-device adjacent pairs exchange exactly as in
    ``_tempering_kernel``; the BOUNDARY pair between device d's coldest
    local replica (global index d*t_local + t_local - 1) and device d+1's
    hottest one crosses the interconnect: both neighbors ``ppermute`` their edge
    replica's (s, f, E) to each other, derive the SAME uniform from a
    device-independent key stream (folded with sweep index and parity, not
    device id), and each applies the identical Metropolis swap decision to
    its own side -- one collective pair per parity phase, no coordinator.
    """
    n = h.shape[0]
    C, Tl = num_chains, t_local
    dev = jax.lax.axis_index(axis_name)
    dev_key = jax.random.fold_in(jax.random.fold_in(base_key, 1), dev)
    shared_key = jax.random.fold_in(base_key, 2)  # same on every device

    dev_key, init_key = jax.random.split(dev_key)
    s = jax.random.bernoulli(init_key, 0.5, (C, Tl, n)).astype(h.dtype)
    f = h[None, None, :] + jnp.einsum("ctn,nm->ctm", s, J)
    E = jnp.einsum("ctn,n->ct", s, h) + 0.5 * jnp.einsum(
        "ctn,nm,ctm->ct", s, J, s
    )

    g_idx = dev * Tl + jnp.arange(Tl)  # global replica indices
    perm_up = [(i + 1, i) for i in range(n_dev - 1)]  # neighbor above -> me
    perm_dn = [(i, i + 1) for i in range(n_dev - 1)]  # me -> neighbor above
    nb_beta_first = jax.lax.ppermute(betas_local[0:1], axis_name, perm_up)[0]
    pb_beta_last = jax.lax.ppermute(betas_local[-1:], axis_name, perm_dn)[0]

    def sweep(carry, sweep_i):
        s, f, E = carry
        flip_key = jax.random.fold_in(dev_key, sweep_i)

        def flip_var(carry, i):
            s, f, E, key = carry
            key, sub = jax.random.split(key)
            de = (1.0 - 2.0 * s[:, :, i]) * f[:, :, i]  # [C, Tl]
            u = jax.random.uniform(sub, (C, Tl), dtype=h.dtype)
            accept = (de <= 0.0) | (u < jnp.exp(-betas_local[None, :] * de))
            delta = jnp.where(accept, 1.0 - 2.0 * s[:, :, i], 0.0)
            s = s.at[:, :, i].add(delta)
            f = f + delta[:, :, None] * J[i][None, None, :]
            E = E + jnp.where(accept, de, 0.0)
            return (s, f, E, key), None

        (s, f, E, _), _ = jax.lax.scan(
            flip_var, (s, f, E, flip_key), jnp.arange(n)
        )

        for parity in (0, 1):
            # -- within-device pairs (local, as in _tempering_kernel) ----
            if Tl > 1:
                ex_key = jax.random.fold_in(
                    jax.random.fold_in(dev_key, sweep_i), 100 + parity
                )
                dB = betas_local[:-1] - betas_local[1:]
                dE = E[:, :-1] - E[:, 1:]
                logp = dB[None, :] * dE
                u = jax.random.uniform(ex_key, (C, Tl - 1), dtype=h.dtype)
                pair_mask = (g_idx[:-1] % 2) == parity
                do_swap = (jnp.log(u) < logp) & pair_mask[None, :]
                s, f, E = _apply_replica_swaps(s, f, E, do_swap)

            # -- boundary pairs across the mesh axis ---------------------
            # shared uniforms: boundary b lives between devices b, b+1
            bkey = jax.random.fold_in(
                jax.random.fold_in(shared_key, sweep_i), parity
            )
            u_all = jax.random.uniform(bkey, (C, n_dev), dtype=h.dtype)
            # neighbor-above's hottest replica comes down to me ...
            nf_s = jax.lax.ppermute(s[:, 0], axis_name, perm_up)
            nf_f = jax.lax.ppermute(f[:, 0], axis_name, perm_up)
            nf_E = jax.lax.ppermute(E[:, 0], axis_name, perm_up)
            # ... and my coldest replica goes up to them
            pl_s = jax.lax.ppermute(s[:, -1], axis_name, perm_dn)
            pl_f = jax.lax.ppermute(f[:, -1], axis_name, perm_dn)
            pl_E = jax.lax.ppermute(E[:, -1], axis_name, perm_dn)

            # lower side of boundary dev: my last vs neighbor's first
            gb_lo = dev * Tl + Tl - 1
            lo_active = (gb_lo % 2 == parity) & (dev < n_dev - 1)
            logp_lo = (betas_local[-1] - nb_beta_first) * (E[:, -1] - nf_E)
            swap_lo = (
                (jnp.log(u_all[:, jnp.minimum(dev, n_dev - 2)]) < logp_lo)
                & lo_active
            )
            s = s.at[:, -1].set(jnp.where(swap_lo[:, None], nf_s, s[:, -1]))
            f = f.at[:, -1].set(jnp.where(swap_lo[:, None], nf_f, f[:, -1]))
            E = E.at[:, -1].set(jnp.where(swap_lo, nf_E, E[:, -1]))

            # upper side of boundary dev-1: neighbor's last vs my first
            gb_hi = (dev - 1) * Tl + Tl - 1
            hi_active = (gb_hi % 2 == parity) & (dev > 0)
            logp_hi = (pb_beta_last - betas_local[0]) * (pl_E - E[:, 0])
            swap_hi = (
                (jnp.log(u_all[:, jnp.maximum(dev - 1, 0)]) < logp_hi)
                & hi_active
            )
            s = s.at[:, 0].set(jnp.where(swap_hi[:, None], pl_s, s[:, 0]))
            f = f.at[:, 0].set(jnp.where(swap_hi[:, None], pl_f, f[:, 0]))
            E = E.at[:, 0].set(jnp.where(swap_hi, pl_E, E[:, 0]))
        return (s, f, E), None

    (s, f, E), _ = jax.lax.scan(
        sweep, (s, f, E), jnp.arange(num_sweeps)
    )
    s_flat = s.reshape(C * Tl, n)
    energies = s_flat @ h + 0.5 * jnp.einsum("ri,ij,rj->r", s_flat, J, s_flat)
    return s_flat, energies


def parallel_tempering_mesh_ladder(
    model: QuboModel,
    mesh,
    axis_name: str = "d",
    num_chains: int = 64,
    num_replicas: int = 16,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=jnp.float32,
):
    """Parallel tempering with the replica ladder spanning the device mesh.

    Unlike ``parallel_tempering_sharded`` (independent full ladders per
    device), ONE global geometric ladder of ``num_replicas`` temperatures is
    split contiguously across devices; boundary replicas exchange over the
    interconnect each sweep.  This is the memory-scaling mode: state is
    [chains, replicas/device, n] per device, so ladders (or problems) too
    large for one device's batch still temper globally.  ``num_replicas``
    must be divisible by the mesh size.  Returns (samples [C*T, n],
    energies) with offset included.
    """
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"axis {axis_name!r} not in mesh axes {mesh.axis_names}"
        )
    # the SHARDED axis size only: on a multi-axis mesh the all-axes
    # product silently dropped reads (chains shard over axis_name alone;
    # other axes just duplicate work) or crashed the ladder split
    n_dev = int(mesh.shape[axis_name])
    if num_replicas % n_dev != 0:
        raise ValueError(
            f"num_replicas {num_replicas} must divide over {n_dev} devices"
        )
    t_local = num_replicas // n_dev
    if beta_range is None:
        beta_range = default_tempering_beta_range(model)
    betas = jnp.asarray(
        np.geomspace(beta_range[0], beta_range[1], num_replicas), dtype=dtype
    )
    h = jnp.asarray(model.h, dtype=dtype)
    J = jnp.asarray(model.J, dtype=dtype)
    base_key = jax.random.key(seed)

    from jax.sharding import PartitionSpec as P

    def local(betas_local):
        return _tempering_mesh_kernel(
            h, J, betas_local, base_key, axis_name, n_dev,
            num_chains, t_local, num_sweeps,
        )

    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name)
        )
    )
    samples, energies = fn(betas)
    return (
        np.asarray(samples),
        np.asarray(energies, dtype=np.float64) + model.offset,
    )


def simulated_annealing_sharded(
    model: QuboModel,
    mesh,
    axis_name: str = "d",
    num_reads: int = 1000,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=jnp.float32,
    sweep_block: int | None = None,
):
    """Chain-parallel SA: the ``num_reads`` chains sharded across a device
    mesh (SURVEY.md section 2, "chain parallelism for annealing").

    Each device runs an independent slice of chains with its own PRNG
    stream; no communication is needed until the final argmin.  Returns
    (samples [R', n], energies [R']) with R' = ceil(R / n_dev) * n_dev.
    """
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"axis {axis_name!r} not in mesh axes {mesh.axis_names}"
        )
    # the SHARDED axis size only: on a multi-axis mesh the all-axes
    # product silently dropped reads (chains shard over axis_name alone;
    # other axes just duplicate work) or crashed the ladder split
    n_dev = int(mesh.shape[axis_name])
    reads_local = -(-num_reads // n_dev)
    if beta_range is None:
        beta_range = default_beta_range(model)
    betas = jnp.asarray(
        np.geomspace(beta_range[0], beta_range[1], num_sweeps), dtype=dtype
    )
    # same delayed-update schedule as the single-device path
    h, J, n_orig, sweep_block = _prepare_delayed(model, dtype, sweep_block)
    keys = jax.random.split(jax.random.key(seed), n_dev)

    from jax.sharding import PartitionSpec as P

    def local(keys_local):
        s, e = _anneal_kernel_delayed(
            h, J, betas, keys_local[0], reads_local, num_sweeps, sweep_block
        )
        return s[:, :n_orig], e

    fn = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=P(axis_name),
            out_specs=P(axis_name),
        )
    )
    samples, energies = fn(keys)
    return (
        np.asarray(samples),
        np.asarray(energies, dtype=np.float64) + model.offset,
    )


@jax.jit
def _greedy_kernel(h, J, s):
    # the local field is CARRIED and updated incrementally per flip (one
    # row of J), like the annealing kernels: recomputing the full s@J
    # every round costs O(R*n^2) per single flip -- the dominant cost of
    # solve-then-polish on large QUBOs for no accuracy benefit
    def round_(carry):
        s, f, _ = carry
        de = (1.0 - 2.0 * s) * f  # dE of flipping each bit
        best = jnp.argmin(de, axis=1)  # steepest single flip per sample
        gain = jnp.take_along_axis(de, best[:, None], axis=1)[:, 0]
        flip = gain < -1e-12
        s_best = jnp.take_along_axis(s, best[:, None], axis=1)[:, 0]
        dval = jnp.where(flip, 1.0 - 2.0 * s_best, 0.0)  # [R]
        # genuine rank-1 field update: gather the flipped row of J per
        # sample -- O(R*n) per round, vs the O(R*n^2) dense s@J recompute
        f = f + dval[:, None] * J[best]
        onehot = jnp.arange(s.shape[1])[None, :] == best[:, None]
        return s + dval[:, None] * onehot, f, jnp.any(flip)

    def cond(carry):
        return carry[2]

    f0 = h[None, :] + s @ J  # [R, n]
    s, _, _ = jax.lax.while_loop(
        cond, lambda c: round_(c), (s, f0, jnp.asarray(True))
    )
    return s


def greedy_descent(model: QuboModel, samples: np.ndarray) -> np.ndarray:
    """Steepest-descent single-flip polish to a local optimum, vectorized
    over samples (what neal's C++ post-pass effectively buys on dense
    QUBOs; closes the sub-1e-2 gaps batched SA leaves at its coldest
    temperature)."""
    s = _greedy_kernel(
        jnp.asarray(model.h, dtype=jnp.float32),
        jnp.asarray(model.J, dtype=jnp.float32),
        jnp.asarray(samples, dtype=jnp.float32),
    )
    return np.asarray(s, dtype=np.float64)


def polish_one_hot_blocks(
    model: QuboModel, samples: np.ndarray, block_size: int
) -> np.ndarray:
    """Greedy blockwise repair for one-hot-structured QUBOs.

    For each consecutive block of ``block_size`` variables, fix everything
    outside the block and set the single bit minimizing the energy -- the
    natural move set for one-hot selection problems, where single-bit
    Metropolis must tunnel through the constraint penalty.  Guarantees each
    sample is blockwise-optimal (and hence globally optimal when blocks are
    independent, as in the degree-selection QUBO).
    """
    s = np.array(samples, dtype=np.float64, copy=True)
    n = model.num_variables
    if n % block_size != 0:
        raise ValueError("block_size must divide the number of variables")
    for i0 in range(0, n, block_size):
        i1 = i0 + block_size
        s[:, i0:i1] = 0.0
        fields = model.h[i0:i1][None, :] + s @ model.J[:, i0:i1]
        choice = np.argmin(fields, axis=1)
        s[np.arange(s.shape[0]), i0 + choice] = 1.0
    return s


def solve_qubo(
    model: QuboModel,
    num_reads: int = 1000,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    one_hot_block_size: int | None = None,
) -> tuple[np.ndarray, float]:
    """Anneal (optionally polish one-hot blocks) and return the best sample."""
    samples, energies = simulated_annealing(
        model, num_reads, num_sweeps, beta_range, seed,
        block_structure=one_hot_block_size,
    )
    if one_hot_block_size is not None:
        samples = polish_one_hot_blocks(model, samples, one_hot_block_size)
        energies = model.energy(samples)
    best = int(np.argmin(energies))
    return samples[best], float(energies[best])

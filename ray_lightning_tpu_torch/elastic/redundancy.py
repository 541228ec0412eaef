"""Parity-redundant optimizer state: zero-replay recovery.

Counterpart of ``ray_lightning_tpu/elastic/redundancy.py`` over the
port's ZeRO-1 layout (parallel/strategy.py ``Zero1State``: each rank
holds ``[lo, hi)`` of every flat group vector, ``_Flat.shard_of``)
instead of JAX shardings.  Shrink-to-continue (elastic/driver.py)
survives a dead rank but replays from the last durable snapshot; this
module keeps in the fleet what a dead rank takes with it:

- **What is rank-unique.**  Under ZeRO-1 the optimizer state of the
  sharded group (the fp32 master and the moments, ``zero1/shard``) is
  cut across the ranks: a dead rank's piece exists nowhere else.  So is
  each rank's row of the comm plane's error-feedback residual.  The
  params (whole on every rank after the all-gather), the buffers, the
  small whole group (``zero1/whole``), the counts, the step and the
  seed survive on any rank.  :func:`partition_leaves` names each leaf
  of the state with its global shape and, for a unique one, the index
  of this rank's piece; :func:`pack_partition` packs the unique leaves
  (the rank's *unique blob*) or the others (the *replicated blob*).
  Pieces travel as host arrays of their raw bits: a bf16 moment as its
  int16 view, never through a float cast, so the escrow is a bit-exact
  copy.

- **Parity, not replicas.**  On a cadence piggybacked on the step
  (``ElasticConfig(redundancy_every_n_steps=...)``) each rank sends its
  unique blob to its ``k`` parity holders over the worker-to-worker peer
  channel (cluster/worker_state.py ``peer_send``, routed by the driver)
  and XORs the blobs of the ``k`` ranks it covers into one parity block
  (``redundancy=k``).  Byte-wise XOR is dtype-agnostic and exact, so
  encode, drop one, decode round-trips bit for bit.  Each rank stores
  one parity block; the wire costs ``k x shard bytes / cadence`` a step
  (:func:`declared_parity_bytes`), counted in ``stats["parity_bytes"]``.

- **Escrow.**  Each completed tick deposits this rank's recovery escrow
  (step, unique blob and its digest, replicated blob, parity block, the
  digests its members sent with their blobs) into the worker process's
  escrow cell, which the worker's frame reader serves: the driver
  harvests it even while the main thread is wedged in a collective that
  will never complete.

- **Reconstruct and continue.**  On a single-rank death the plugin
  harvests the survivors' escrows before teardown (plugins/ray_ddp.py),
  the driver recomputes the dead rank's blob as ``parity XOR (the other
  covered members' blobs)`` and checks it against the digest the dead
  rank sent (:func:`build_recovery`), and the N-1 attempt restores the
  assembled state in memory (:func:`apply_recovery`): no snapshot is
  read, and training resumes at the escrowed step.  Snapshot replay
  stays the fallback for a multi-rank loss, parity off, or any gap in
  the escrows; ``trainer._elastic_report["recovery"]`` says which
  (``parity``, ``replay`` or ``scratch``).

The residual reassembles at the old world size and is re-bucketed N ->
M by the rule of elastic/reshard.py.  Parity covers the DDP and ZeRO-1
layouts; under FSDP or SPMD (params cut by the layout) the trainer
leaves it off and replay is the recovery.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import threading
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.cluster.peer import PeerTimeout
from ray_lightning_tpu_torch.telemetry import metrics as _metrics
from ray_lightning_tpu_torch.telemetry.spans import span

_log = logging.getLogger(__name__)

#: bound on one parity tick's peer receive: a peer that died mid-tick
#: costs a skipped tick, not a wedged fleet
ENV_PARITY_TIMEOUT = "RLT_ELASTIC_PARITY_TIMEOUT_S"
DEFAULT_PARITY_TIMEOUT_S = 30.0

ESCROW_KIND = "rlt-parity-escrow"


def digest(blob: bytes) -> str:
    """The hex SHA-256 of a blob: what a rank sends beside its unique
    blob, and what the reconstruction is checked against."""
    return hashlib.sha256(blob).hexdigest()


# -- the state's partition -------------------------------------------------------


class Leaf(NamedTuple):
    """One leaf of a rank's state: ``value`` (a tensor or a Python
    scalar), ``path`` (its keys from the state's root), ``shape`` (its
    global shape) and ``index`` (``((start, stop), ...)`` of this rank's
    piece in it for a rank-unique leaf, None for a replicated one)."""

    value: Any
    path: tuple
    shape: tuple
    index: Optional[tuple]


def _walk(tree, path: tuple, out: dict, unique_of=None) -> None:
    """Every leaf of a nested state dict into ``out`` (an empty dict is a
    leaf, so the structure comes back whole); ``unique_of(node, key)``
    gives ``(shape, index)`` for a rank-unique tensor, else None."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            hit = unique_of(tree, k) if unique_of is not None else None
            if hit is not None:
                out["/".join(map(str, path + (k,)))] = Leaf(
                    v, path + (k,), hit[0], hit[1])
            else:
                _walk(v, path + (k,), out, unique_of)
        return
    shape = tuple(tree.shape) if isinstance(tree, torch.Tensor) else ()
    out["/".join(map(str, path))] = Leaf(tree, path, shape, None)


def partition_leaves(trainer) -> "dict[str, Leaf]":
    """The trainer's state as :class:`Leaf`\\ s by key (module
    docstring): ``params/<name>``, ``model_state/<name>``, the optimizer
    state's raw leaves under ``opt_state/`` (a ZeRO-1 ``zero1/shard``
    entry and a comm residual row rank-unique), ``step`` and ``rng``.
    Local: no collective."""
    from ray_lightning_tpu_torch.comm.collectives import CommState
    from ray_lightning_tpu_torch.parallel.strategy import Zero1State

    if trainer._layout is not None:
        raise ValueError("parity covers the DDP and ZeRO-1 layouts, not "
                         "a model cut by the layout (FSDP, SPMD)")
    model = trainer.lightning_module.model
    out: "dict[str, Leaf]" = {}
    _walk({"params": dict(model.named_parameters()),
           "model_state": dict(model.named_buffers())}, (), out)
    opt = trainer.state.opt_state
    prefix: tuple = ("opt_state",)
    if isinstance(opt, CommState):
        sync = trainer._grad_sync
        for k, r in opt.residual.items():
            shape = (opt.world,) + tuple(r.shape)
            index = ((sync.index, sync.index + 1),) + tuple(
                (0, d) for d in r.shape)
            path = prefix + ("residual", k)
            out["/".join(path)] = Leaf(r, path, shape, index)
        opt = opt.inner
        prefix += ("inner",)
    unique_of = None
    if isinstance(opt, Zero1State):
        groups = {k: g for k, g in zip(opt.keys, opt.groups)}

        def unique_of(node, key):
            g = groups.get(key)
            if g is None or g.shards == 1 or set(node) != set(groups):
                return None
            return (g.size * g.shards,), ((g.lo, g.hi),)
        raw = opt.inner.state_dict()
    else:
        raw = opt.state_dict()
    _walk(raw, prefix, out, unique_of)
    _walk({"step": int(trainer.state.step),
           "rng": int(trainer.state.generator.initial_seed())}, (), out)
    return out


def _host_bits(value) -> "tuple[np.ndarray, str, str]":
    """``(raw bits as a host array, dtype name, kind)``: a tensor as its
    bits (bf16 as its int16 view, any dtype numpy lacks as the integer
    of its width), a Python scalar as a 0-d array."""
    if isinstance(value, torch.Tensor):
        # a host copy (a device tensor's own; a host tensor's made here,
        # so the live state cannot change what is packed)
        t = value.detach()
        t = t.to("cpu") if t.device.type != "cpu" else t.clone()
        t = t.contiguous()
        name = str(t.dtype).replace("torch.", "")
        try:
            arr = t.numpy()
        except TypeError:
            arr = t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[t.element_size()]).numpy()
        return arr, name, "tensor"
    if isinstance(value, dict):     # an empty state (``EmptyState``)
        return np.zeros((), np.int8), "int8", "dict"
    arr = np.asarray(value)
    return arr, str(arr.dtype), type(value).__name__


def _full_index(shape: tuple) -> tuple:
    return tuple((0, int(d)) for d in shape)


def pack_partition(leaves: "dict[str, Leaf]", *, unique: bool) -> bytes:
    """This rank's view of the state, pickled: ``unique=True`` the
    rank-unique leaves, each its piece with its global index (what parity
    must cover); ``unique=False`` the replicated rest, whole."""
    out: dict = {}
    for key, leaf in leaves.items():
        if (leaf.index is not None) != unique:
            continue
        arr, dtype, kind = _host_bits(leaf.value)
        out[key] = {"path": leaf.path, "shape": tuple(leaf.shape),
                    "dtype": dtype, "kind": kind,
                    "pieces": [(leaf.index if unique
                                else _full_index(leaf.shape), arr)]}
    return pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL)


def unpack_partition(blob: bytes) -> dict:
    return pickle.loads(blob)


# -- the XOR parity codec -------------------------------------------------------


def xor_blocks(blobs: list) -> bytes:
    """Byte-wise XOR of ``blobs`` (bytes, or any buffer of them: a uint8
    array) zero-padded to the longest: the parity block.  Any single
    missing blob is recoverable from the others and its recorded length
    (:func:`recover_block`)."""
    if not blobs:
        return b""
    views = [np.frombuffer(b, dtype=np.uint8) for b in blobs]
    n = max(len(v) for v in views)
    acc = np.zeros(n, dtype=np.uint8)
    for v in views:
        np.bitwise_xor(acc[:len(v)], v, out=acc[:len(v)])
    return acc.tobytes()


def recover_block(parity: bytes, others: list, length: int) -> bytes:
    """The missing member's blob: ``parity XOR others``, cut to its
    recorded ``length`` (the padding XORs to zero)."""
    if not others:                  # the parity of one member is its blob
        return np.frombuffer(parity, np.uint8)[:length].tobytes()
    return xor_blocks([parity] + list(others))[:length]


class ParityGroup:
    """Who covers whom for ``redundancy=k`` on ``world`` ranks: rank
    ``r`` holds one parity block over the unique blobs of its ``k`` next
    neighbours ``(r+1 .. r+k) mod world`` and sends its own blob to the
    ``k`` ranks before it, so any single dead rank has ``k`` holders."""

    def __init__(self, rank: int, world: int, k: int):
        if world < 2 or k < 1:
            raise ValueError("parity needs world >= 2 and redundancy >= 1")
        self.rank = int(rank)
        self.world = int(world)
        self.k = min(int(k), world - 1)
        self.covers = [(rank + 1 + i) % world for i in range(self.k)]
        self.holders = [(rank - 1 - i) % world for i in range(self.k)]

    @staticmethod
    def holder_of(dead: int, world: int, k: int) -> int:
        """The canonical (nearest preceding) parity holder of a dead
        rank."""
        del k
        return (dead - 1) % world


# -- transports -------------------------------------------------------------------


class PeerParityTransport:
    """The parity exchange over the worker-to-worker peer channel: sends
    by actor name through ``worker_state.peer_send``, receives block on
    this process's peer mailbox."""

    def __init__(self, peer_names: list, rank: int, timeout_s: float):
        from ray_lightning_tpu_torch.cluster import worker_state
        self.peer_names = list(peer_names)
        self.rank = int(rank)
        self.timeout_s = timeout_s
        self._mailbox = worker_state.peer_mailbox()

    def send(self, dst_rank: int, tag: tuple, wire) -> None:
        from ray_lightning_tpu_torch.cluster import worker_state
        worker_state.peer_send(self.peer_names[dst_rank],
                               {"tag": tag, "wire": wire})

    def recv(self, tag: tuple):
        return self._mailbox.take(
            tag, self.timeout_s, who=f"rank {self.rank} parity tick",
            src="parity exchange (peer dead or ticks desynchronized)")


class LoopbackParityTransport:
    """In-process multi-rank transport for units and selfchecks: one
    shared dict of mailboxes keyed by rank."""

    def __init__(self, boxes: dict, rank: int, timeout_s: float = 2.0):
        self.boxes = boxes
        self.rank = int(rank)
        self.timeout_s = timeout_s

    def send(self, dst_rank: int, tag: tuple, wire) -> None:
        self.boxes[dst_rank].put(tag, wire)

    def recv(self, tag: tuple):
        return self.boxes[self.rank].take(tag, self.timeout_s,
                                          who=f"rank {self.rank} parity",
                                          src="loopback")


# -- the worker-side manager ----------------------------------------------------


class RedundancyManager:
    """Cadence-driven parity upkeep for one fit stage.

    Made by ``Trainer._run_stage`` when the elastic config has
    ``redundancy > 0`` and the fleet spans more than one process, and
    ticked after each step before the snapshotter.  A tick that cannot
    complete (a peer died mid-exchange, frames dropped) is skipped: the
    previous escrow stays, the run goes on, and a recovery resumes from
    the last completed tick's step.  ``stats``: ``parity_ticks``,
    ``parity_skipped``, ``parity_bytes`` (the wire bytes sent), one
    entry a completed tick in ``parity_tick_seconds``,
    ``parity_tick_bytes`` and ``parity_tick_parts`` (its seconds by part:
    the packing of the unique blob, its digest beside the packing of the
    replicated blob, the sends, the wait for the covered members'
    blobs, the XOR), and ``declared_parity_bytes``
    (:func:`declared_parity_bytes` of the stage's state).
    """

    def __init__(self, trainer, cfg, rank: int, world: int,
                 transport, store: Optional[Callable] = None):
        self.trainer = trainer
        self.cfg = cfg
        self.group = ParityGroup(rank, world, cfg.redundancy)
        self.every = max(1, int(cfg.redundancy_every_n_steps))
        self.transport = transport
        if store is None:
            from ray_lightning_tpu_torch.cluster import worker_state
            store = worker_state.escrow_set
        self.store = store
        self.stats = {"parity_ticks": 0, "parity_skipped": 0,
                      "parity_bytes": 0, "parity_tick_seconds": [],
                      "parity_tick_bytes": [], "parity_tick_parts": []}
        if getattr(trainer, "state", None) is not None:
            self.stats["declared_parity_bytes"] = declared_parity_bytes(
                partition_leaves(trainer), self.group.k, self.every)

    def _count(self, name: str, value: float = 1.0) -> None:
        reg = _metrics.get_registry()
        if reg is not None:
            reg.counter(name).inc(value)

    def maybe_tick(self) -> bool:
        """One cadence check; True when a parity tick completed.  Every
        rank decides from ``global_step`` alone (the exchange needs all
        ranks ticking the same steps)."""
        t = self.trainer
        if t.global_step <= 0 or t.global_step % self.every:
            return False
        step = int(t.global_step)
        with span("parity", step=step, k=self.group.k):
            try:
                self._tick(step)
            except PeerTimeout as e:
                self.stats["parity_skipped"] += 1
                self._count("rlt_parity_skipped_total")
                _log.warning("parity tick at step %d skipped: %s", step, e)
                return False
        return True

    def _pack(self, unique: bool) -> bytes:
        """One packing call (the seam for units that simulate
        rank-distinct partitions in one process)."""
        return pack_partition(partition_leaves(self.trainer), unique=unique)

    def _tick(self, step: int) -> None:
        t0 = time.monotonic()
        marks = [t0]

        def mark():
            marks.append(time.monotonic())
        t = self.trainer
        g = self.group
        unique = self._pack(unique=True)
        mark()
        # the digest (hashlib frees the GIL) beside the replicated pack
        box: dict = {}
        th = threading.Thread(target=lambda: box.update(d=digest(unique)),
                              name="rlt-parity-digest")
        th.start()
        replicated = self._pack(unique=False)
        th.join()
        mine = box["d"]
        mark()
        # blobs travel as uint8 arrays: out of band on the wire
        # (cluster/protocol.py), no copy into a pickle
        wire = {"blob": np.frombuffer(unique, np.uint8), "digest": mine}
        for h in g.holders:
            self.transport.send(h, ("parity", step, g.rank), wire)
        mark()
        member = {m: self.transport.recv(("parity", step, m))
                  for m in g.covers}
        mark()
        blobs = [member[m]["blob"] for m in g.covers]
        # one member: the parity block is its blob (XOR of one)
        parity = blobs[0] if len(blobs) == 1 else np.frombuffer(
            xor_blocks(blobs), np.uint8)
        mark()
        module = getattr(t, "lightning_module", None)
        meta = {
            "epoch": int(t.current_epoch),
            "global_step": step,
            "world_size": g.world,
            "callbacks": {type(cb).__name__: cb.state_dict()
                          for cb in t.callbacks},
        }
        if module is not None and getattr(module, "hparams", None):
            meta["hparams"] = dict(module.hparams)
        wire = len(unique) * len(g.holders)
        self.stats["parity_ticks"] += 1
        self.stats["parity_bytes"] += wire
        self.stats["parity_tick_bytes"].append(wire)
        self.stats["parity_tick_seconds"].append(time.monotonic() - t0)
        self.stats["parity_tick_parts"].append(dict(zip(
            ("pack", "digest_and_pack_replicated", "send", "wait", "xor"),
            (b - a for a, b in zip(marks, marks[1:])))))
        self._count("rlt_parity_ticks_total")
        self._count("rlt_parity_bytes_total", wire)
        self.store({
            "kind": ESCROW_KIND,
            "rank": g.rank,
            "world": g.world,
            "k": g.k,
            "step": step,
            "epoch": int(t.current_epoch),
            "unique_blob": np.frombuffer(unique, np.uint8),
            "unique_digest": mine,
            "replicated_blob": np.frombuffer(replicated, np.uint8),
            "parity": parity,
            "parity_members": list(g.covers),
            "parity_lengths": {m: len(b["blob"]) for m, b in member.items()},
            "parity_digests": {m: b["digest"] for m, b in member.items()},
            "meta": meta,
            # the tick counters ride the escrow, so the driver's report
            # still shows the dead fleet's parity overhead after teardown
            "stats": {k: (list(v) if isinstance(v, list) else v)
                      for k, v in self.stats.items()},
        })


def declared_parity_bytes(leaves: "dict[str, Leaf]", k: int,
                          every: int) -> int:
    """The parity's wire bytes a step, amortized over the cadence: each
    tick sends this rank's rank-unique bytes to ``k`` holders."""
    shard_bytes = 0
    for leaf in leaves.values():
        if leaf.index is not None:
            shard_bytes += leaf.value.numel() * leaf.value.element_size()
    return int(shard_bytes * max(1, k) / max(1, every))


# -- the driver-side reconstruction ---------------------------------------------


def build_recovery(escrows: dict, dead: int, world: int,
                   k: int) -> tuple:
    """``(package, None)``: the in-memory recovery package of a single
    rank's loss, or ``(None, why not)``.

    ``escrows`` maps an old fleet rank to the escrow harvested from that
    survivor.  Every survivor's escrow must be at one step; the dead
    rank's unique blob is its nearest preceding holder's parity block
    XOR the other covered members' blobs, and must hash to the digest
    the dead rank sent with it.
    """
    t0 = time.monotonic()
    survivors = [r for r in range(world) if r != dead]
    missing = [r for r in survivors if r not in escrows]
    if missing:
        return None, f"no escrow harvested from rank(s) {missing}"
    steps = {r: escrows[r].get("step") for r in survivors}
    if len(set(steps.values())) != 1:
        return None, f"escrow steps diverge across survivors: {steps}"
    step = steps[survivors[0]]
    holder = ParityGroup.holder_of(dead, world, k)
    esc_h = escrows.get(holder)
    if esc_h is None:
        return None, f"parity holder rank {holder} did not survive"
    members = list(esc_h.get("parity_members", ()))
    if dead not in members:
        return None, (f"holder rank {holder} parity covers {members}, "
                      f"not dead rank {dead}")
    lengths = esc_h.get("parity_lengths", {})
    if dead not in lengths:
        return None, f"holder parity lengths miss rank {dead}"
    try:
        others = [escrows[m]["unique_blob"] for m in members if m != dead]
        dead_blob = recover_block(esc_h["parity"], others, int(lengths[dead]))
        got = digest(dead_blob)
        sent = esc_h.get("parity_digests", {}).get(dead)
        if got != sent:
            return None, (f"rank {dead}'s reconstructed blob hashes to "
                          f"{got}, not the {sent} it sent")
        leaves: dict = {}
        for blob in [escrows[r]["unique_blob"] for r in survivors] \
                + [dead_blob, escrows[survivors[0]]["replicated_blob"]]:
            for key, entry in unpack_partition(blob).items():
                slot = leaves.setdefault(key, {
                    "path": tuple(entry["path"]),
                    "shape": tuple(entry["shape"]),
                    "dtype": entry["dtype"], "kind": entry["kind"],
                    "pieces": {}})
                for idx, arr in entry["pieces"]:
                    slot["pieces"][tuple(idx)] = arr
    except Exception as e:   # noqa: BLE001 - any gap falls back to replay
        return None, f"parity reconstruction failed: {e!r}"
    package = {
        "kind": ESCROW_KIND,
        "step": int(step),
        "epoch": int(escrows[survivors[0]].get("epoch", 0)),
        "world": int(world),
        "dead_rank": int(dead),
        "dead_digest": got,
        "escrowed_digest": sent,
        "leaves": {key: {**slot, "pieces": sorted(slot["pieces"].items())}
                   for key, slot in leaves.items()},
        "meta": dict(escrows[survivors[0]].get("meta", {})),
        # the dead fleet's parity counters (its workers returned no
        # result), folded into the driver's report
        "escrow_stats": dict(escrows[survivors[0]].get("stats", {})),
        "reconstruct_seconds": time.monotonic() - t0,
    }
    return package, None


def assemble_leaf(entry: dict) -> np.ndarray:
    """The global array (raw bits) from a leaf's escrowed pieces; raises
    ``ValueError`` if the pieces do not tile the whole shape (a gap: the
    caller falls back to replay)."""
    shape = tuple(entry["shape"])
    pieces = entry["pieces"]
    if shape == ():
        return np.asarray(pieces[0][1]).reshape(())
    first = np.asarray(pieces[0][1])
    out = np.zeros(shape, dtype=first.dtype)
    filled = np.zeros(shape, dtype=bool)
    for idx, arr in pieces:
        sl = tuple(slice(a, b) for a, b in idx)
        out[sl] = np.asarray(arr).reshape(out[sl].shape)
        filled[sl] = True
    if not filled.all():
        raise ValueError(
            f"escrowed pieces cover {int(filled.sum())}/{filled.size} "
            f"elements of shape {shape}")
    return out


def leaf_value(entry: dict, device=None):
    """An assembled leaf as the state holds it: a tensor of its dtype
    (the raw bits viewed back, never cast) on ``device``, or a Python
    scalar."""
    arr = assemble_leaf(entry)
    if entry["kind"] != "tensor":
        return {"int": int, "float": float, "bool": bool,
                "dict": lambda _: {}}.get(entry["kind"],
                                         lambda a: a)(arr.item())
    dtype = getattr(torch, entry["dtype"])
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.dtype != dtype:
        t = t.view(dtype)
    return t if device is None else t.to(device)


def _nest(entries: "list[tuple[tuple, Any]]") -> dict:
    out: dict = {}
    for path, value in entries:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


# -- the worker-side restore (the N-1 attempt) ----------------------------------


def apply_recovery(trainer, package: dict, module) -> None:
    """Restore the reconstructed state into this stage's layout, which
    may hold another number of ranks than the fleet that escrowed it:
    the params and buffers load whole; a ZeRO-1 group's old flat vector
    is taken back to the single-device layout by parameter name and cut
    for this world by ``Zero1State.load_state_dict``; the comm residual
    is re-bucketed by ``CommState.load_residual`` (elastic/reshard.py's
    rule); then the counters, the seed and the hooks, as a checkpoint
    restore runs them."""
    from ray_lightning_tpu_torch.comm.collectives import CommState
    from ray_lightning_tpu_torch.parallel.strategy import (Zero1State,
                                                           _regroup)

    device = trainer.device
    values = {key: (tuple(e["path"]), leaf_value(e, device))
              for key, e in package["leaves"].items()}
    tree = _nest(list(values.values()))
    model = module.model
    live = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    saved = {**tree.get("params", {}), **tree.get("model_state", {})}
    problems = [f"{k}: missing from the recovery escrow"
                for k in live if k not in saved]
    problems += [f"{k}: escrowed {tuple(saved[k].shape)} "
                 f"{saved[k].dtype} != live {tuple(v.shape)} {v.dtype}"
                 for k, v in live.items() if k in saved and (
                     saved[k].shape != v.shape or saved[k].dtype != v.dtype)]
    if problems:
        raise ValueError("recovery escrow does not restore onto this "
                         "model:\n  " + "\n  ".join(problems))
    trainer._load_full_state(model, saved)
    opt = trainer.state.opt_state
    opt_tree = tree.get("opt_state", {})
    if isinstance(opt, CommState):
        if "residual" in opt_tree:
            opt.load_residual(opt_tree["residual"])
        else:
            opt.zero_residual()
        opt, opt_tree = opt.inner, opt_tree.get("inner", opt_tree)
    elif "inner" in opt_tree and "residual" in opt_tree:
        opt_tree = opt_tree["inner"]    # the plane is inert here
    if isinstance(opt, Zero1State):
        keys = set(opt.keys)
        groups = dict(zip(opt.keys, opt.groups))

        def by_name(entry: dict) -> dict:
            out = {}
            for k, flat in entry.items():
                out.update({n: v.clone() for n, v in
                            groups[k].unflatten(flat.reshape(-1)).items()})
            return out
        opt.load_state_dict(_regroup(opt_tree, lambda ks: ks == keys,
                                     by_name))
    else:
        opt.load_state_dict(opt_tree)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    meta = dict(package.get("meta", {}))
    meta.setdefault("epoch", package["epoch"])
    meta["global_step"] = int(package["step"])
    trainer._restore_counters(int(tree["step"]), int(tree["rng"]), meta,
                              module)
    reg = _metrics.get_registry()
    if reg is not None:
        reg.counter("rlt_parity_restore_total").inc()
    _log.info("parity recovery: resumed in memory at step %d (rank %d's "
              "shard reconstructed from parity; no snapshot read)",
              package["step"], package.get("dead_rank", -1))


def parity_timeout_s() -> float:
    raw = os.environ.get(ENV_PARITY_TIMEOUT, "").strip()
    try:
        return float(raw) if raw else DEFAULT_PARITY_TIMEOUT_S
    except ValueError:
        return DEFAULT_PARITY_TIMEOUT_S


__all__ = ["ESCROW_KIND", "Leaf", "LoopbackParityTransport", "ParityGroup",
           "PeerParityTransport", "RedundancyManager", "apply_recovery",
           "assemble_leaf", "build_recovery", "declared_parity_bytes",
           "digest", "pack_partition", "parity_timeout_s", "partition_leaves",
           "recover_block", "unpack_partition", "xor_blocks"]

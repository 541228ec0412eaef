"""Step builders: init, train, eval and predict steps; k train steps as
one dispatch (a CUDA graph on the card); the serve programs (prefill,
decode, the paged KV copy and suffix step, the speculative draft and
verify).

Counterpart of ``ray_lightning_tpu/core/steps.py`` ``build_init_fn`` /
``build_train_step`` / ``build_eval_step``
/ ``build_predict_step`` / ``build_prefill_step`` / ``build_decode_step``
/ ``build_kv_copy`` / the engine's ``kv_import`` / ``build_suffix_step`` / ``build_draft_step`` /
``build_verify_step``, and of the JAX trainer's ``multi_step``,
``cached_multi`` and ``cached_single`` programs
(``ray_lightning_tpu/core/trainer.py:987-1020``: ``lax.scan`` over k
steps) as :class:`ChunkRunner`.  A torch module holds its own
parameters, so the builders close over the model (the JAX builders take
the params as an argument of the jitted program) and the train step
updates them IN PLACE where the JAX program returns new ones; PyTorch
runs eagerly, so there is nothing to trace or compile: the
counterpart of a compiled program is a CUDA graph
(:func:`capture_graph`), captured once for the chunks and for each
serve program (serve/engine.py).  The serve caches are updated in place
too, where the JAX programs return new caches from donated buffers, and
the serve steps take their request values (slot, length, page-copy
source and destination) as device tensors, so a graph captured over
them freezes none.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ray_lightning_tpu_torch.core.module import StepContext
from ray_lightning_tpu_torch.core.state import TrainState
from ray_lightning_tpu_torch.ops import random
from ray_lightning_tpu_torch.ops._kernels import add_launches, launch_counts


def build_init_fn(module, tx, shard: "Callable | None" = None
                  ) -> Callable:
    """``generator -> TrainState``: initialize the module's model in
    place (``module.init_params``, on the generator's device), cut it to
    this rank's blocks (``shard(model)``, a sharded strategy's layout:
    parallel/layout.py), let the optimizer snapshot its state (an
    ``fp32_master`` its fp32 master) from the full-precision init, and
    only then cast the float params to ``module.param_dtype``, as the
    JAX init does."""

    def init_fn(generator: torch.Generator) -> TrainState:
        module.init_params(generator)
        if shard is not None:
            shard(module.model)
        opt_state = tx.init(dict(module.model.named_parameters()))
        pd = getattr(module, "param_dtype", None)
        if pd is not None:
            module.model.to(dtype=pd)      # casts the floating params only
        return TrainState(step=0, opt_state=opt_state, generator=generator)

    return init_fn


def _split_loss(out) -> "tuple[torch.Tensor, dict]":
    if isinstance(out, dict):
        if "loss" not in out:
            raise ValueError("training_step dict output must contain 'loss'")
        extra = {k: v.detach().float() for k, v in out.items()
                 if k != "loss"}
        return out["loss"], extra
    return out, {}


def build_train_step(module, tx, accumulate_grad_batches: int = 1,
                     grad_sync: "Callable | None" = None,
                     rank: "int | None" = None,
                     metric_sync: "Callable | None" = None,
                     comm=None) -> Callable:
    """``(state, batch, scalars=None, keys=None) -> (state, metrics)``:
    one optimizer step.

    With ``accumulate_grad_batches=k`` the batch's leading dim splits
    into k microbatches whose gradients are summed in fp32 (whatever the
    params' dtype: k bf16 additions would lose the low bits the
    optimizer needs) and averaged; the loss and logged metrics are the
    microbatch means.  With k=1 the gradients keep the params' dtype
    (bf16 for bf16-resident params) and the optimizer upcasts them.
    ``metrics`` holds detached fp32 tensors on the device.

    ``grad_sync`` (``grads -> grads``, the strategy's: DDP's average over
    the ranks) runs between the backward and the update, ``metric_sync``
    (``values -> values``: the mean over the ranks) on the step's
    metrics, so a graphed chunk captures both collectives.  ``rank``
    joins the step's entropy, so the ranks of a multi-process run draw
    different dropout masks (``None``: one process, whose entropy is
    the seed, the step and the microbatch).  ``scalars`` is the
    optimizer's count-dependent scalars on the device (``tx.update``'s;
    ``None``: made from the host count).

    ``comm`` (a ``comm.GradSync``, the comm plane) takes the place of
    ``grad_sync``: the gradients (accumulated first, so one sync an
    optimizer step) go through ``comm.sync_step`` with the residual of
    the optimizer state (``CommState``), and the new residual is copied
    back into it in place; its stochastic rounding draws from the
    step's key (``keys[0]``, folded under ``comm.COMM_STREAM``), so a
    graphed chunk draws each step's own numbers (the JAX step derives
    its comm key from the state's key the same way).
    """
    k = max(1, int(accumulate_grad_batches))

    def grads_of(params, batch, rng, device, key):
        ctx = StepContext(module, training=True, rng=rng, device=device,
                          key=key)
        loss, extra = _split_loss(module.training_step(ctx, batch))
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach().float(), {**ctx.logged, **extra}, grads

    def micro(x, i):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        if x.shape[0] % k:
            raise ValueError(f"Batch size {x.shape[0]} must be divisible "
                             f"by accumulate_grad_batches={k}")
        n = x.shape[0] // k
        return x[i * n:(i + 1) * n]

    ranked = () if rank is None else (rank,)

    def key_words(state: TrainState, steps: int = 1) -> np.ndarray:
        """The key words [steps, k, 2] of ``state``'s step and the
        ``steps - 1`` after it, one row a microbatch, as each step's
        contexts make them from the host entropy."""
        return random.key_words(state.generator.initial_seed(),
                                state.step + np.arange(steps)[:, None],
                                np.arange(k)[None, :], *ranked)

    def step_fn(state: TrainState, batch: Any,
                scalars: "torch.Tensor | None" = None,
                keys: "torch.Tensor | None" = None):
        params = dict(module.model.named_parameters())
        # the step's entropy: the seed, the step, the microbatch (the JAX
        # step folds the step and the microbatch index into its key)
        seed, dev = state.generator.initial_seed(), state.generator.device
        if k == 1:
            loss, logged, grads = grads_of(params, batch,
                                           (seed, state.step, 0, *ranked),
                                           dev,
                                           None if keys is None else keys[0])
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in params.values()]
            losses, logs = [], []
            for i in range(k):
                mb = (type(batch)(micro(x, i) for x in batch)
                      if isinstance(batch, (tuple, list))
                      else micro(batch, i))
                loss_i, logged_i, grads_i = grads_of(
                    params, mb, (seed, state.step, i, *ranked), dev,
                    None if keys is None else keys[i])
                torch._foreach_add_(acc, [g.float() for g in grads_i])
                losses.append(loss_i)
                logs.append(logged_i)
            grads = torch._foreach_div(acc, k)
            loss = torch.stack(losses).mean()
            logged = {n: torch.stack([d[n] for d in logs]).mean()
                      for n in logs[0]}
        if comm is not None:
            grads = _comm_sync(comm, state, list(params), list(grads),
                               keys, ranked)
        elif grad_sync is not None:
            grads = grad_sync(list(grads))
        tx.update(dict(zip(params, grads)), state.opt_state, params,
                  scalars)
        state.step += 1
        metrics = {"loss": loss, **logged}
        if metric_sync is not None:
            metrics = dict(zip(metrics, metric_sync(list(metrics.values()))))
        return state, metrics

    step_fn.key_words = key_words
    return step_fn


def _comm_sync(comm, state: TrainState, names: "list[str]",
               grads: "list[torch.Tensor]", keys, ranked: tuple):
    """The comm plane's sync of one step's gradients (``build_train_step``
    docstring): the residual read from and written back to the
    optimizer state."""
    from ray_lightning_tpu_torch.ops.random import Key
    res = getattr(state.opt_state, "residual", None) or None
    residual = [res[n] for n in names] if res else None
    key = None
    if comm.policy.stochastic_rounding:
        words = keys[0] if keys is not None else torch.from_numpy(
            random.key_words(state.generator.initial_seed(), state.step, 0,
                             *ranked)).to(grads[0].device)
        key = Key(words)
    if comm.zero1:
        # ZeRO-1 reduce-scatters over its own shard layout
        # (parallel/strategy.py ``Zero1Optimizer``)
        comm.defer(res, key)
        return grads
    synced, new_res = comm.sync_step(grads, residual, key=key)
    if new_res is not None:
        with torch.no_grad():
            for r, e in zip(residual, new_res):
                r.copy_(e)
    return synced


#: eager steps a capture runs first (on a side stream, then undone):
#: lazy set-up (cuBLAS and cuDNN handles, NCCL communicators, the
#: kernels' shared-memory attributes) must not happen inside a capture
GRAPH_WARMUP_STEPS = 1


def tree_map(fn: Callable, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every tensor inside its tuples,
    lists and dicts (a batch, a predict step's output); other leaves
    as they are."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_leaves(tree: Any) -> "list[torch.Tensor]":
    """The tensors of ``tree`` in :func:`tree_map`'s order."""
    found: list = []
    tree_map(found.append, tree)
    return found


def _state_tensors(obj, seen: "set[int] | None" = None) -> list:
    """Every tensor an optimizer state holds: dataclass fields, dicts,
    lists and the attributes of other state objects (``Zero1State``'s
    masters and inners), each once."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float,
                                           type(None), torch.Size)):
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif dataclasses.is_dataclass(obj):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif hasattr(obj, "__dict__") and not callable(obj):
        items = list(vars(obj).values())
    else:
        return []
    return [t for x in items for t in _state_tensors(x, seen)]


@dataclasses.dataclass
class CapturedGraph:
    """One CUDA graph, the (static) outputs its capture returned, the
    kernel launches one replay runs, and what the capture cost."""

    graph: "torch.cuda.CUDAGraph"
    out: Any
    launches: "dict[str, int]"
    capture_ms: float
    #: device memory reserved by the capture (its share of the pool)
    pool_bytes: int

    def replay(self) -> Any:
        """Run the graph on the current stream and count its launches
        (no wrapper's Python runs in a replay); returns the outputs,
        which the next replay of a graph of the same pool may
        overwrite."""
        self.graph.replay()
        add_launches(self.launches)
        return self.out


def capture_graph(fn: Callable, device: torch.device, pool=None,
                  stream: "torch.cuda.Stream | None" = None
                  ) -> CapturedGraph:
    """``fn()`` captured as one CUDA graph on ``stream`` (default:
    torch's capture stream), its memory from ``pool`` (default: a pool
    of its own; graphs that share one must never replay at once).

    The caller has run ``fn`` eagerly first, on the same stream where
    a wrapper keeps per-stream state (ops/flash_decode.py ``_scratch``):
    lazy set-up (cuBLAS handles and workspaces, the kernels' shared
    memory attributes, NCCL communicators) must not happen inside a
    capture.  ``thread_local``: the NCCL watchdog's event queries on
    other threads stay legal during the capture.  The capture runs the
    Python but no kernel, so the launches its wrappers counted are
    taken back; :meth:`CapturedGraph.replay` adds them again."""
    before = launch_counts()
    # the capture empties the allocator's cache first; so does this,
    # so the reserved bytes' growth is the graph's pool
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn()
    capture_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: c - before.get(n, 0) for n, c in launch_counts().items()
                if c != before.get(n, 0)}
    add_launches({n: -c for n, c in launches.items()})
    return CapturedGraph(graph, out, launches, capture_ms,
                         torch.cuda.memory_reserved(device) - reserved)


@dataclasses.dataclass
class _ChunkGraph:
    """One captured chunk: its static inputs (the stacked batches, or the
    cached batch indices), the optimizer scalars' feed [k, n], the steps'
    key words [k, microbatches, 2] and the graph, whose outputs are the
    stacked metrics."""

    inputs: Any
    batch_of: Callable
    feed: "torch.Tensor | None" = None
    keys: "torch.Tensor | None" = None
    captured: "CapturedGraph | None" = None


def copy_in(dst: torch.Tensor, src: Any) -> None:
    """``src`` (a tensor, or anything ``np.asarray`` takes) into the
    buffer ``dst`` on the current stream, cast to its dtype and shape: a
    host source into the card from pinned memory without a wait."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(np.asarray(src)))
    src = src.to(dst.dtype)
    if dst.device.type == "cuda" and src.device.type == "cpu":
        src = src.pin_memory()
    dst.copy_(src.reshape(dst.shape), non_blocking=True)


def _stack_metrics(outs: "list[dict]") -> "dict[str, torch.Tensor]":
    return {n: torch.stack([o[n] for o in outs]) for n in outs[0]}


class ChunkRunner:
    """k optimizer steps as ONE dispatch (``Trainer(steps_per_execution=
    k)``), over stacked host batches (:meth:`run`) or the device-resident
    train set (:meth:`run_cached`); the metrics come back stacked to
    ``[k]``.  The counterpart of the JAX trainer's ``lax.scan`` programs.

    On the card each (source, batch signature) is captured once as a
    ``torch.cuda.CUDAGraph`` of k steps, at its first full chunk: one
    eager warm-up step on a side stream (then undone: params, buffers
    and optimizer state copied back, counters moved back), then the
    capture, whose Python does the chunk's host bookkeeping (the step
    and optimizer counts advance by k), then the first replay.  Every
    later chunk copies its batches (or indices) and the optimizer's k
    rows of host scalars (``tx.host_scalars``) into the graph's static
    buffers and replays, then advances the counts by k.  The graph
    updates the live params and optimizer state in place; the
    collectives of the strategy (DDP's all-reduce, ZeRO-1's
    reduce-scatter and all-gather, BatchNorm's moments, the metric mean)
    are captured with them.  A capture or replay that fails raises.
    Kernel launches: each graph's captured launches are counted once,
    taken back (the capture ran none) and added again on each replay.
    The steps' key words (``step_fn.key_words``) ride a static input
    too, so a step's keyed draws (``StepContext.make_key``: dropout, the
    masked LM's mask; ops/random.py) are the eager step's bit for bit.
    On the CPU a chunk is k eager steps, and so it is on the card when
    ``ungraphed`` gives the reason it cannot be captured (the steps'
    collectives run over gloo, whose collectives a CUDA graph cannot
    hold).  A step that draws from a ``torch.Generator``
    (``StepContext.make_rng``) raises inside a capture.

    ``stats``: ``captures``, ``replays``, ``warmup_steps``, per capture
    its ``capture_ms`` and ``pool_bytes`` (device memory reserved by the
    capture), ``launches_per_replay`` of the last capture, and
    ``ungraphed``: ``None``, or why the chunks on the card run eagerly
    (``eager_chunks`` counts them).
    """

    def __init__(self, step_fn: Callable, tx, k: int, model: torch.nn.Module,
                 device: torch.device, ungraphed: "str | None" = None):
        self.step_fn = step_fn
        self.tx = tx
        self.k = int(k)
        self.model = model
        self.device = torch.device(device)
        self.ungraphed = ungraphed
        self._graphs: "dict[Any, _ChunkGraph]" = {}
        self.stats: dict = {"captures": 0, "replays": 0, "warmup_steps": 0,
                            "capture_ms": [], "pool_bytes": [],
                            "launches_per_replay": {},
                            "ungraphed": ungraphed, "eager_chunks": 0}

    # -- entry points --------------------------------------------------

    def run(self, state: TrainState, stacked: Any):
        """k steps over ``stacked``: host batches stacked to ``[k, B,
        ...]`` (CPU tensors, already cast)."""
        if not self._graphed():
            return self._eager(state, lambda i: tree_map(
                lambda x: x[i].to(self.device), stacked))
        key = ("stream", signature(stacked))
        entry = self._graphs.get(key)
        if entry is None:
            inputs = tree_map(lambda x: torch.empty(
                x.shape, dtype=x.dtype, device=self.device), stacked)
            entry = _ChunkGraph(inputs, lambda i: tree_map(
                lambda x: x[i], inputs))
        for dst, src in zip(tree_leaves(entry.inputs),
                            tree_leaves(stacked)):
            copy_in(dst, src)
        return self._dispatch(key, entry, state)

    def run_cached(self, state: TrainState, dataset: Any,
                   idxs: np.ndarray):
        """k steps over batches ``idxs`` of the device-resident
        ``dataset`` (``[n_batches, B, ...]`` leaves): each step gathers
        its batch on the device by index, so only indices cross the
        host link."""
        if not self._graphed():
            return self._eager(state, lambda i: tree_map(
                lambda d: d[int(idxs[i])], dataset))
        key = ("cached", tuple((d.data_ptr(), tuple(d.shape), d.dtype)
                               for d in tree_leaves(dataset)))
        entry = self._graphs.get(key)
        if entry is None:
            idx = torch.empty(self.k, dtype=torch.int64, device=self.device)
            entry = _ChunkGraph(idx, lambda i: tree_map(
                lambda d: d.index_select(0, idx[i:i + 1])[0], dataset))
        copy_in(entry.inputs, np.asarray(idxs, np.int64))
        return self._dispatch(key, entry, state)

    # -- the two ways ----------------------------------------------------

    def _graphed(self) -> bool:
        return self.device.type == "cuda" and self.ungraphed is None

    def _eager(self, state, batch_of):
        if self.device.type == "cuda":
            self.stats["eager_chunks"] += 1
        outs = []
        for i in range(self.k):
            state, metrics = self.step_fn(state, batch_of(i))
            outs.append(metrics)
        return state, _stack_metrics(outs)

    def _feed_rows(self, state) -> np.ndarray:
        return np.stack([self.tx.host_scalars(state.opt_state, i)
                         for i in range(self.k)]).astype(np.float32)

    def _dispatch(self, key, entry: _ChunkGraph, state):
        rows = self._feed_rows(state)
        keys = self.step_fn.key_words(state, self.k)
        if entry.captured is None:
            entry.feed = torch.empty(rows.shape, dtype=torch.float32,
                                     device=self.device)
            entry.keys = torch.empty(keys.shape, dtype=torch.int64,
                                     device=self.device)
            copy_in(entry.feed, rows)
            copy_in(entry.keys, keys)
            self._capture(entry, state)
            self._graphs[key] = entry
        else:
            copy_in(entry.feed, rows)
            copy_in(entry.keys, keys)
            self.tx.advance(state.opt_state, self.k)
            state.step += self.k
        metrics = entry.captured.replay()
        self.stats["replays"] += 1
        return state, {n: v.clone() for n, v in metrics.items()}

    def _capture(self, entry: _ChunkGraph, state) -> None:
        """Warm up, undo the warm-up, capture (module docstring).  The
        capture's Python advances the host counts by k, which the first
        replay then makes true."""
        dev = self.device
        live = list({id(t): t for t in [
            *self.model.parameters(), *self.model.buffers(),
            *_state_tensors(state.opt_state)]}.values())
        saved = [t.detach().clone() for t in live]
        compute = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            for i in range(GRAPH_WARMUP_STEPS):
                self.step_fn(state, entry.batch_of(i), entry.feed[i],
                             entry.keys[i])
        compute.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
        del saved
        self.tx.advance(state.opt_state, -GRAPH_WARMUP_STEPS)
        state.step -= GRAPH_WARMUP_STEPS
        self.stats["warmup_steps"] += GRAPH_WARMUP_STEPS

        def chunk():
            return _stack_metrics([
                self.step_fn(state, entry.batch_of(i), entry.feed[i],
                             entry.keys[i])[1]
                for i in range(self.k)])

        entry.captured = captured = capture_graph(chunk, dev)
        self.stats["capture_ms"].append(captured.capture_ms)
        self.stats["pool_bytes"].append(captured.pool_bytes)
        self.stats["captures"] += 1
        self.stats["launches_per_replay"] = dict(captured.launches)


def signature(tree: Any) -> tuple:
    """Each tensor's shape and dtype, in order: a batch's signature."""
    return tuple((tuple(x.shape), x.dtype) for x in tree_leaves(tree))


def build_eval_step(module, stage: str) -> Callable:
    """``(state, batch) -> logged metrics`` for ``validate`` / ``test``,
    under ``torch.no_grad()``.  A bare returned scalar with nothing
    logged surfaces as ``val_loss`` / ``test_loss``."""
    step = {"validate": module.validation_step,
            "test": module.test_step}[stage]

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Any):
        ctx = StepContext(module, training=False)
        out = step(ctx, batch)
        logged = ctx.logged
        if out is not None and not isinstance(out, dict) and not logged:
            logged = {"val_loss" if stage == "validate" else "test_loss":
                      torch.as_tensor(out).float()}
        elif isinstance(out, dict):
            logged = {**logged, **{n: torch.as_tensor(v).float()
                                   for n, v in out.items()}}
        return logged

    return step_fn


def build_predict_step(module) -> Callable:
    """``(state, batch) -> module.predict_step(ctx, batch)`` under
    ``torch.no_grad()``, with no entropy (as the JAX predict step has no
    key): a forward only."""

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Any):
        return module.predict_step(StepContext(module, training=False),
                                   batch)

    return step_fn


def build_prefill_step(model: torch.nn.Module,
                       bucket_len: int) -> Callable:
    """Prefill for ONE sequence-length bucket.

    ``(k_caches, v_caches, tokens, slot, length) -> first_token``:
    ``tokens`` [1, bucket_len] (right-padded) long on the model's
    device; ``slot``/``length`` [1] long on the same device (a CUDA
    graph's static inputs: the step indexes with them on the device, so
    a capture freezes neither; the caller checks them on the host).
    Runs the whole-sequence forward, takes the greedy token at
    ``length - 1`` and writes every layer's K/V block into rows
    ``[0, bucket_len)`` of ``slot``.  Rows ``>= length`` hold pad garbage
    that the causal mask keeps out of the first token and
    ``cached_attention``'s position bound out of every later one.
    Returns a 0-d long tensor (not yet synced).
    """
    def step_fn(k_caches, v_caches, tokens, slot, length):
        if tokens.shape != (1, bucket_len):
            raise ValueError(f"prefill_{bucket_len} takes tokens "
                             f"[1, {bucket_len}], got {tuple(tokens.shape)}")
        x, kvs = model.hidden_with_kv(tokens)
        # only row length-1 feeds the first token: no [T, V] logits
        logits = model.head(x[0].index_select(0, length - 1)[0])
        for i, (k, v) in enumerate(kvs):
            k_caches[i, :, :bucket_len].index_copy_(0, slot, k)
            v_caches[i, :, :bucket_len].index_copy_(0, slot, v)
        return torch.argmax(logits, dim=-1)

    return step_fn


def build_decode_step(model: torch.nn.Module,
                      impl: "str | None" = None,
                      page_table: "torch.Tensor | None" = None) -> Callable:
    """Continuous-batching decode: THE serving hot path.

    ``(k_caches, v_caches, tokens, positions) -> next_tokens``: advances
    every slot one token; ``tokens``/``positions`` [S] int32 on the
    model's device, caches [n_layer, S, L, H, D] written in place.
    ``impl`` is the decode attention (``dense`` | ``flash_decode`` |
    ``paged``, ops/flash_decode.py ``resolve_decode_impl``);
    ``page_table`` ([S, L / page_size] int32 on the device,
    serve/fleet/pages.py ``identity_page_table``) is what the paged
    kernel walks.  Returns [S] long (not yet synced).
    """
    def step_fn(k_caches, v_caches, tokens, positions):
        logits = model.decode(tokens, positions, k_caches, v_caches,
                              impl=impl, page_table=page_table)
        return torch.argmax(logits, dim=-1)

    return step_fn


def build_draft_step(model: torch.nn.Module, k: int,
                     impl: "str | None" = None,
                     page_table: "torch.Tensor | None" = None) -> Callable:
    """Speculative-decode draft: ``k`` greedy decode steps of the DRAFT
    model over its own KV cache.

    ``(dk_caches, dv_caches, tokens, positions) -> drafts``:
    ``tokens``/``positions`` [S] are each slot's last emitted token at
    its position (the plain decode inputs); ``drafts`` [S, k] long (not
    yet synced).  Each step writes its row of the draft cache and feeds
    its argmax forward; a row past the cache end is dropped (an idle
    slot's dummy row at ``L - 1`` plus the step).  Rows drafted past the
    accepted prefix are masked and overwritten by the next round, which
    restarts at the corrected position.

    One forward more than the JAX program: the k-th draft's own row
    (position ``pos + k``) is written too, its logits unused.  When a
    round accepts all k drafts the next one starts at ``pos + k + 1``,
    and the JAX draft cache holds a stale row at ``pos + k`` there, so
    even a draft identical to the target can disagree; here the draft
    cache always holds the accepted stream.  The drafts themselves are
    the JAX program's, and the emitted tokens are the target's either
    way.
    """
    def step_fn(dk_caches, dv_caches, tokens, positions):
        toks, pos, drafts = tokens, positions, []
        for i in range(k + 1):
            logits = model.decode(toks, pos, dk_caches, dv_caches,
                                  impl=impl, page_table=page_table,
                                  drop_past_end=True)
            if i == k:
                break
            toks = torch.argmax(logits, dim=-1).to(tokens.dtype)
            pos = pos + 1
            drafts.append(toks)
        return torch.stack(drafts, dim=1)

    return step_fn


def build_verify_step(model: torch.nn.Module, impl: "str | None" = None,
                      page_table: "torch.Tensor | None" = None
                      ) -> Callable:
    """Speculative-decode verify: ONE batched target forward over the k
    drafted positions per slot.

    ``(k_caches, v_caches, tokens, positions) -> argmaxes`` with
    ``tokens``/``positions`` [S, k+1] — per slot the last emitted token
    and its k drafts at consecutive positions; ``argmaxes`` [S, k+1]
    long: column j is the token the target emits after the prefix
    extended by drafts ``1..j``.  The scheduler accepts the longest
    agreeing prefix plus one corrected token (serve/scheduler.py), so
    the output equals target-only greedy decode.  Rides
    ``GPT.verify``'s multi-query cached attention: the decode kernels
    and per-query masks of the plain path, k+1 launches a layer.
    """
    def step_fn(k_caches, v_caches, tokens, positions):
        logits = model.verify(tokens, positions, k_caches, v_caches,
                              impl=impl, page_table=page_table)
        return torch.argmax(logits, dim=-1)

    return step_fn


def build_kv_copy() -> Callable:
    """Paged-KV copy (serve/fleet/pages.py prefix reuse).

    ``(k_caches, v_caches, src, dst)`` copies every cache row of slot
    ``src`` into slot ``dst`` in every layer, in place (``src``/``dst``
    [1] long on the caches' device): the device half of a prefix-cache
    hit, the matched rows moved instead of recomputed.  Sound because a
    cache row is a pure per-(token, position) value: identical prefixes
    have identical rows wherever they were computed.  Whole rows, not
    the matched ones, so no length is frozen into a graph: the rows past
    the match are rewritten by the suffix steps and the decode before
    any query's position bound (``cached_attention``) reaches them.
    """
    def copy_fn(k_caches, v_caches, src, dst):
        for c in (k_caches, v_caches):
            c.index_copy_(1, dst, c.index_select(1, src))

    return copy_fn


def build_kv_import(bucket_len: int) -> Callable:
    """KV-page import for ONE bucket (fleet disaggregation and prefix
    federation: the device half of a shipped donor).

    ``(k_caches, v_caches, k_rows, v_rows, slot)`` writes the shipped
    rows ``[n_layer, 1, bucket_len, H, D]`` into rows ``[0, bucket_len)``
    of ``slot`` ([1] long on the caches' device) in every layer, in
    place: the JAX program's ``dynamic_update_slice``.  Sound for the
    reason :func:`build_kv_copy` is: a cache row is a pure per-(token,
    position) value, identical on whichever replica computed it.
    """
    def import_fn(k_caches, v_caches, k_rows, v_rows, slot):
        k_caches[:, :, :bucket_len].index_copy_(1, slot, k_rows)
        v_caches[:, :, :bucket_len].index_copy_(1, slot, v_rows)

    return import_fn


def build_suffix_step(model: torch.nn.Module, impl: "str | None" = None,
                      page_table: "torch.Tensor | None" = None
                      ) -> Callable:
    """Single-slot suffix step (the compute leg of prefix reuse).

    ``(k_caches, v_caches, token, pos, slot) -> next_token``: advances
    ONE slot one token through the decode forward on the one-slot slice
    of the cache (a view, written in place).  After a prefix-cache hit
    copies the matched pages (:func:`build_kv_copy`), the unmatched
    suffix is teacher-forced through this step one token at a time.  It
    writes nothing outside ``slot``, so it needs no dispatch-order
    contract.  ``page_table`` is the ONE-slot table
    (``identity_page_table(1, L, page_size)``): the slice's pages are
    slice-relative, the same for every slot.  ``token``/``pos`` hold one
    int32 each on the device; ``slot`` is a Python int, so the serve
    engine captures one graph per slot (a gather of the slot's cache
    would move 2 x n_layer x L x C elements a token).  Returns a 0-d
    long tensor (not yet synced).
    """
    def step_fn(k_caches, v_caches, token, pos, slot: int):
        logits = model.decode(token.reshape(1), pos.reshape(1),
                              k_caches[:, slot:slot + 1],
                              v_caches[:, slot:slot + 1], impl=impl,
                              page_table=page_table)
        return torch.argmax(logits[0], dim=-1)

    return step_fn


__all__ = ["CapturedGraph", "ChunkRunner", "GRAPH_WARMUP_STEPS",
           "build_decode_step", "capture_graph", "copy_in", "signature",
           "tree_leaves", "tree_map",
           "build_draft_step", "build_eval_step",
           "build_init_fn", "build_kv_copy", "build_kv_import",
           "build_predict_step",
           "build_prefill_step", "build_suffix_step", "build_train_step",
           "build_verify_step"]

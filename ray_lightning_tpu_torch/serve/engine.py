"""Serve engine: per-bucket prefill and one decode step over a
device-resident slot KV cache, each program one CUDA graph on the card.

Counterpart of ``ray_lightning_tpu/serve/engine.py`` ``ServeEngine``
(setup, ``prefill``, ``decode``, ``stats``).  At setup it:

1. builds the decode model on the device and loads the given weights
   (a ``state_dict``, e.g. ``convert.flax_to_torch`` of a JAX param
   tree) or draws a seeded init from a ``torch.Generator``, then casts
   float params to the module's ``param_dtype``;
2. derives the cache geometry from one prefill at the smallest bucket
   and allocates the zeroed ``[n_layer, slots, max_seq_len, H, D]`` K/V
   caches;
3. builds one prefill step per bucket and one decode step
   (core/steps.py) — with ``paged=`` also the page copy and the
   one-slot suffix step of prefix reuse, with ``spec=`` the draft plane
   (a draft model whose parameters ARE the target's tensors by name,
   or, with ``draft_quant="int8"``, int8 (payload, scale) pairs
   dequantized inside each draft program; its own KV cache, one draft
   prefill per bucket, the k-step draft and the batched verify), with
   ``kvship=True`` one KV import per bucket (fleet disaggregation and
   prefix federation: ``export_kv`` reads a slot's rows, ``import_kv``
   installs shipped rows) — gives each program its static input
   buffers, and runs each once on the scratch caches;
4. on the card, captures each program as one CUDA graph
   (core/steps.py ``capture_graph``), the counterpart of the JAX
   engine's AOT warm-up: ``prefill_{b}`` per bucket, ``decode``, with
   ``paged=`` ``kv_copy`` and ``suffix`` (one graph per slot), with
   ``spec=`` ``draft_prefill_{b}`` per bucket, ``draft`` and
   ``verify``, with ``kvship=`` ``kv_import_{b}`` per bucket.  The
   warm-up of step 3 ran on the capture stream, so
   every lazy set-up and every per-stream scratch buffer
   (ops/flash_decode.py ``_scratch``) exists before the captures.  All
   graphs share one memory pool: they never replay at once, and each
   call copies its outputs out before the next replay.  The caches keep
   their addresses and are zeroed after the captures.

Every call validates on the host, copies its inputs into the program's
static buffers and replays (on the CPU: runs the eager step on them).
``run_eager`` runs the eager step a graph was captured from, on the
same caches, for the tests and the smoke script to hold each replay
against.  ``stats()["captures"]`` counts the graphs per program and
``recaptures`` those captured since setup (the JAX ``traces`` /
``retraces``): the engine captures only in ``setup``.

The decode attention is ``RLT_DECODE_IMPL`` (ops/flash_decode.py):
``paged`` walks the identity page table of the slot cache
(serve/fleet/pages.py) through the paged kernel when ``paged=`` is on
and its page size tiles ``max_seq_len``, and degrades to the
slot-contiguous ``flash_decode`` kernel otherwise, as the JAX engine
does; ``decode_kernel`` says which runs.

Under a training strategy (``strategy=``, the JAX engine's mesh) the
serving layout is the training layout, as in the JAX engine: the mesh
is ``strategy.build_mesh(batch_hint=slots)`` over the default process
group (``Server``'s ranks, serve/worker.py), the model is built and
initialised (or loaded) whole on this rank and cut to its pieces by the
strategy's layout (parallel/layout.py: FSDP pieces gathered at use,
``tensor`` pieces computed on by the model's Megatron forward), and the
cache holds this rank's block of ``strategy.kv_cache_block``: its data
shard's slots and its ``n_head / tensor`` heads, ``[n_layer,
slots / data, L, H / tensor, D]``.  Every rank builds, warms and
captures the same programs in the same order, and every rank of a mesh
runs every program of each plan (serve/worker.py), so the collectives
inside them match.  When a program gathers parameters over the data
shards (FSDP), a rank also runs another shard's admissions, through
the same programs, at a scratch slot past its block
(:meth:`shadow_prefill`).  Over NCCL each
program is one CUDA graph with its collectives inside, every
communicator made by the warm-up's collectives before the first
capture; gloo's collectives cannot be captured, so over gloo on the
card the programs with collectives run eagerly and ``stats()``'s
``ungraphed`` says why.  ``export_kv`` gathers the tensor group's heads
in rank order (a collective of that group) and ``import_kv`` takes this
rank's heads of whole rows, so engines of any layout ship to each
other.  The sequence, stage and expert axes split nothing a dense decode
model holds: their ranks serve the same slots as replicas, and only the
rank at coordinate 0 on every axis but the data axes (``leader``)
reports its block's results.

The compile cache is not ported yet, and asking for it raises.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.comm.quant import (dequantize_blob,
                                                quantize_blob)
from ray_lightning_tpu_torch.core.steps import (CapturedGraph,
                                                build_decode_step,
                                                build_draft_step,
                                                build_kv_copy,
                                                build_kv_import,
                                                build_prefill_step,
                                                build_suffix_step,
                                                build_verify_step,
                                                capture_graph, copy_in)
from ray_lightning_tpu_torch.compile import cache as compile_cache_mod
from ray_lightning_tpu_torch.compile.cache import CompileCacheConfig
from ray_lightning_tpu_torch.ops import _kernels
from ray_lightning_tpu_torch.ops.flash_decode import resolve_decode_impl
from ray_lightning_tpu_torch.parallel.mesh import all_gather_along
from ray_lightning_tpu_torch.parallel.strategy import resolve_strategy
from ray_lightning_tpu_torch.serve.fleet.pages import identity_page_table
from ray_lightning_tpu_torch.serve.kvcache import KVCacheSpec
from ray_lightning_tpu_torch.telemetry import metrics as _metrics

_log = logging.getLogger(__name__)


class ServeEngine:
    """Generation executor bound to one device: the whole model and every
    slot, or under ``strategy=`` this rank's pieces and block (module
    docstring)."""

    def __init__(self, module, buckets: Sequence[int], slots: int,
                 max_seq_len: int, seed: int = 0,
                 weights: "Optional[dict]" = None,
                 device: "str | torch.device | None" = None, *,
                 strategy: Any = None, compile_cache: Any = None,
                 paged: Any = None, spec: Any = None,
                 kvship: bool = False):
        #: the kernel libraries' cache (compile/cache.py; ``None``: the
        #: ``RLT_COMPILE_CACHE*`` env, which ``Server`` sets in its
        #: workers), active from here on
        self.compile_cache = CompileCacheConfig.resolve(compile_cache)
        compile_cache_mod.activate(self.compile_cache)
        #: the training strategy served under (``None``: one rank)
        self.strategy = None if strategy is None \
            else resolve_strategy(strategy)
        #: PageConfig (serve/fleet/pages.py): when enabled the engine also
        #: builds the page copy and the one-slot suffix step that make
        #: prefix-cache hits executable
        self.paged = paged if paged is not None and paged.enabled \
            else None
        #: SpecConfig (serve/spec.py): when enabled the engine builds the
        #: draft plane
        self.spec = spec if spec is not None and spec.enabled else None
        #: KV-page shipping (fleet disaggregation, prefix federation):
        #: one ``kv_import_{b}`` program per bucket
        self.kvship = bool(kvship)
        self.device = resolve_device(device)
        self.module = module
        self.buckets = tuple(buckets)
        #: the fleet's slots, and (after setup) this rank's block of them
        #: ``[lo, hi)`` and its size; every slot without a strategy
        self.fleet_slots = int(slots)
        self.slot_block = (0, self.fleet_slots)
        self.slots = self.fleet_slots
        #: this rank's heads ``[lo, hi)`` of the cache (all without one)
        self.head_block: "Optional[tuple[int, int]]" = None
        #: the mesh and the model's layout (``None``: whole, one rank)
        self.mesh = None
        self.layout = None
        #: whether this rank reports its block's results (module
        #: docstring): coordinate 0 on every axis but the data axes
        self.leader = True
        #: whether another data shard's admissions run here too (their
        #: programs gather parameters over the data shards)
        self.lockstep = False
        #: why the programs run eagerly on the card (``None``: graphed)
        self.ungraphed: "Optional[str]" = None
        self.max_seq_len = int(max_seq_len)
        self.seed = int(seed)
        self._weights = weights
        #: which decode attention the decode step uses — dense |
        #: flash_decode | paged (resolved at setup from RLT_DECODE_IMPL)
        self.decode_kernel = "dense"
        self.kv_spec: Optional[KVCacheSpec] = None
        self.model: Optional[torch.nn.Module] = None
        #: calls served per program (the smoke script holds the kernels'
        #: launch counts against these) and their host wall seconds; the
        #: token-returning ones end in the device sync that reads them
        self.calls = {name: 0 for name in self.PROGRAMS + self.SHIPPING}
        self.seconds = {name: 0.0 for name in self.PROGRAMS + self.SHIPPING}
        self._prefills: dict = {}
        self._decode = None
        self._kv_copy = None
        self._suffix = None
        #: the caches ``(k, v)``: this rank's slots, and under lockstep
        #: one scratch slot past them (:meth:`shadow_prefill`)
        self._kv: "Optional[tuple]" = None
        #: views of this rank's slots of them
        self._k: Optional[torch.Tensor] = None
        self._v: Optional[torch.Tensor] = None
        #: the paged kernel's tables on the device (None: not paged)
        self.page_table: Optional[torch.Tensor] = None
        self._suffix_table: Optional[torch.Tensor] = None
        # draft plane (speculative decoding)
        self.draft_model: Optional[torch.nn.Module] = None
        self.draft_layers = 0
        self.draft_kv_spec: Optional[KVCacheSpec] = None
        self._draft_prefills: dict = {}
        self._draft = None
        self._verify = None
        self._dkv: "Optional[tuple]" = None
        self._dk: Optional[torch.Tensor] = None
        self._dv: Optional[torch.Tensor] = None
        #: int8 draft residency (``draft_quant="int8"``): name -> the
        #: (payload, scale) pair of each draft tensor, and the bytes a
        #: standalone draft copy in the target's dtype would take
        self._draft_q: "Optional[dict]" = None
        self.draft_resident_bytes = 0
        self.draft_fp_bytes = 0
        #: program key (name, variant: a suffix graph's slot) -> the step
        #: on its caches, and its static input buffers
        self._programs: "dict[tuple, tuple[Callable, tuple]]" = {}
        #: the programs' CUDA graphs (empty on the CPU)
        self._graphs: "dict[tuple, CapturedGraph]" = {}
        #: graphs captured per program name, and at the end of setup
        self.captures: "dict[str, int]" = {}
        self._captures_at_setup: "dict[str, int]" = {}
        #: the captures' host ms and the bytes their shared pool reserved
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self._stream: "Optional[torch.cuda.Stream]" = None

    # -- setup -------------------------------------------------------------

    @torch.inference_mode()
    def setup(self) -> "ServeEngine":
        t0 = time.monotonic()
        dev = self.device
        if dev.type == "cuda":
            # parity with the fp32 reference: TF32 keeps ~3 decimal
            # digits, so an fp32 product must run in full fp32 (the
            # default for matmuls, not for cuDNN convolutions)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = decode_model_of(self.module, dev)
        model.requires_grad_(False)
        model.eval()
        if self._weights is not None:
            state = self._weights
            if isinstance(state, dict) and "params" in state:
                raise TypeError(
                    "weights must be a torch state_dict; convert a JAX "
                    "param tree with ray_lightning_tpu_torch.convert."
                    "flax_to_torch")
            model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in state.items()},
                strict=True)
        else:
            model.init_weights(
                torch.Generator(device=dev).manual_seed(self.seed))
        self._weights = None
        pd = getattr(self.module, "param_dtype", None)
        if pd is not None:
            model.to(dtype=pd)     # casts the floating params only
        if self.strategy is not None:
            self._shard(model)
        self.model = model

        # cache geometry from one prefill capture at the smallest bucket
        # (under a strategy this rank's heads; collective like any
        # program, so every rank runs it here)
        probe = torch.zeros((1, self.buckets[0]), dtype=torch.long,
                            device=dev)
        _, kvs = model.hidden_with_kv(probe)
        k0 = kvs[0][0]
        self.kv_spec = KVCacheSpec.from_capture(
            [k for k, _ in kvs], self.slots, self.max_seq_len)
        if self.head_block is not None and self.kv_spec != KVCacheSpec(
                self.kv_spec.n_layer, self.fleet_slots, self.max_seq_len,
                model.config.n_head, self.kv_spec.head_dim).block(
                    self.slot_block, self.head_block):
            raise RuntimeError(
                f"the prefill gave the cache {self.kv_spec.shape}, not "
                f"the layout's block of slots {self.slot_block} and "
                f"heads {self.head_block}")
        self._kv = self._caches(self.kv_spec, k0.dtype)
        self._k, self._v = (c[:, :self.slots] for c in self._kv)

        for b in self.buckets:
            self._prefills[b] = build_prefill_step(model, b)
        # the paged kernel needs a table whose pages tile the cache; with
        # paging off or ragged, "paged" degrades to the slot-contiguous
        # kernel rather than failing set-up (the JAX engine's rule)
        impl = resolve_decode_impl(None, dev)
        if impl == "paged":
            if self.paged is not None \
                    and self.max_seq_len % self.paged.page_size == 0:
                ps = self.paged.page_size
                self.page_table = torch.from_numpy(identity_page_table(
                    self.slots, self.max_seq_len, ps)).to(dev)
                self._suffix_table = torch.from_numpy(identity_page_table(
                    1, self.max_seq_len, ps)).to(dev)
            else:
                impl = "flash_decode"
        self.decode_kernel = impl
        self._decode = build_decode_step(model, impl, self.page_table)
        if self.paged is not None:
            self._suffix = build_suffix_step(model, impl, self._suffix_table)
            self._kv_copy = build_kv_copy()
        if self.spec is not None:
            self._setup_draft(model, impl)
        self._define_programs()
        self._warm()
        if dev.type == "cuda" and self.ungraphed is None:
            self._capture_all()
        self._zero_caches()
        self._captures_at_setup = dict(self.captures)
        _log.info(
            "serve engine ready in %.2fs: device=%s buckets=%s slots=%d "
            "kv=%s (%.1f MB) decode=%s graphs=%d (%.0f ms, pool %.1f MB)"
            " mesh=%s%s", time.monotonic() - t0, dev, self.buckets,
            self.slots, self.kv_spec.shape,
            self.kv_spec.nbytes(self._k.element_size()) / 2**20,
            self.decode_kernel, len(self._graphs), self.capture_ms,
            self.pool_bytes / 2**20,
            None if self.mesh is None else self.mesh.shape,
            "" if self.ungraphed is None else f" ({self.ungraphed})")
        return self

    def _shard(self, model) -> None:
        """The strategy's mesh over the process group, ``model`` (whole,
        initialised) cut to this rank's pieces by its layout, and this
        rank's block of the slots and heads (module docstring)."""
        strategy = self.strategy
        mesh = self.mesh = strategy.build_mesh(batch_hint=self.fleet_slots)
        layout = self.layout = strategy.layout(model, mesh)
        if layout is not None:
            layout.apply(model)     # the whole tensors are freed here
        _replicate_sequence(model)
        self.slot_block, self.head_block = strategy.kv_cache_block(
            mesh, self.fleet_slots, model.config.n_head)
        self.slots = self.slot_block[1] - self.slot_block[0]
        self.leader = mesh.rank in mesh.batch_leaders()
        gathers = layout is not None and any(
            i.gather for i in layout.params.values())
        self.lockstep = gathers and mesh.batch_size > 1
        collective = gathers or model.tp is not None
        if self.device.type == "cuda" and collective \
                and mesh.backend == "gloo":
            self.ungraphed = ("gloo's collectives cannot be captured in a "
                              "CUDA graph: every program runs eagerly")

    def _setup_draft(self, model, impl: str) -> None:
        """The draft plane (serve/spec.py): the module's draft, made
        without storage and pointed at the target's tensors by name (no
        weight memory of its own), its KV cache from a draft prefill
        capture, one draft prefill per bucket, the draft and verify
        steps (over the target's page table where the decode is
        paged)."""
        draft = self.module.configure_draft(self.spec.draft_layers or None,
                                            device="meta")
        if draft is None:
            raise ValueError(
                f"spec= requires {type(self.module).__name__}."
                f"configure_draft() to return a draft module "
                f"(core/module.py hook); it returned None")
        if self.layout is not None:
            # the draft's blocks are the target's first ones: the same
            # layout cuts them, and sets its tensor group
            self.strategy.layout(draft, self.mesh).apply(draft)
        _replicate_sequence(draft)
        target = model.state_dict()
        pieces = dict(model.named_parameters())
        shared = {}
        for name, p in draft.state_dict().items():
            if name not in target:
                raise ValueError(
                    f"draft param {name!r} missing from the target: "
                    f"configure_draft() must share the target's names")
            if target[name].shape != p.shape:
                raise ValueError(
                    f"draft param {name!r}: shape {tuple(p.shape)} != "
                    f"target {tuple(target[name].shape)}")
            shared[name] = target[name]
        draft.load_state_dict(shared, strict=True, assign=True)
        for name, p in draft.named_parameters():
            # the tags the assignment dropped: a sharded piece is
            # gathered at use as the target's is
            info = getattr(pieces[name], "_rlt_shard", None)
            if info is not None:
                p._rlt_shard = info
        draft.requires_grad_(False)
        draft.eval()
        self.draft_model = draft
        self.draft_fp_bytes = sum(t.numel() * 2 for t in shared.values())
        wrap = None
        if self.spec.draft_quant == "int8":
            # int8 residency: each draft tensor as a blockwise (payload,
            # scale) pair, dequantized INSIDE the draft programs (so on
            # the card inside their graphs, into the pool's
            # temporaries); the draft's own parameters stay the
            # target's tensors but no draft program reads them
            self._draft_q = {n: quantize_blob(t, "int8")
                             for n, t in shared.items()}
            self.draft_resident_bytes = sum(
                p.nbytes + q.nbytes for p, q in self._draft_q.values())
            meta = {n: (tuple(t.shape), t.dtype) for n, t in shared.items()}

            def wrap(step):
                def run(*args):
                    weights = {n: dequantize_blob(p, q, "int8", meta[n][0],
                                                  dtype=meta[n][1])
                               for n, (p, q) in self._draft_q.items()}
                    with _swapped_params(draft, weights):
                        return step(*args)
                return run
        self.draft_layers = draft.config.n_layer
        probe = torch.zeros((1, self.buckets[0]), dtype=torch.long,
                            device=self.device)
        _, kvs = draft.hidden_with_kv(probe)
        self.draft_kv_spec = KVCacheSpec.from_capture(
            [k for k, _ in kvs], self.slots, self.max_seq_len)
        self._dkv = self._caches(self.draft_kv_spec, kvs[0][0].dtype)
        self._dk, self._dv = (c[:, :self.slots] for c in self._dkv)
        wrap = wrap or (lambda step: step)
        for b in self.buckets:
            self._draft_prefills[b] = wrap(build_prefill_step(draft, b))
        self._draft = wrap(build_draft_step(draft, self.spec.k, impl,
                                            self.page_table))
        self._verify = build_verify_step(model, impl, self.page_table)

    def _caches(self, spec: KVCacheSpec, dtype: torch.dtype) -> tuple:
        """Zeroed ``(k, v)`` of ``spec``'s shape, with one slot more
        under lockstep: the scratch slot of :meth:`shadow_prefill`."""
        shape = list(spec.shape)
        shape[1] += self.lockstep
        return tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                     for _ in range(2))

    def _define_programs(self) -> None:
        """Each program's step on its caches, and its static inputs
        (zeros, slot 0, length 1: valid values for the warm-up).  The
        admissions' programs (the prefills, the suffix, the draft
        prefills) take the whole caches, so under lockstep they reach
        the scratch slot too; a suffix graph is one a slot, scratch
        included."""
        dev, S = self.device, self.slots

        def longs(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.long, device=dev)

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        def add(name, step, caches, inputs, variant=None):
            self._programs[(name, variant)] = (
                lambda *x: step(*caches, *x), inputs)

        kv = (self._k, self._v)
        slot, length = longs(1), longs(1, fill=1)
        for b, step in self._prefills.items():
            add(f"prefill_{b}", step, self._kv, (longs(1, b), slot, length))
        add("decode", self._decode, kv, (ints(S), ints(S)))
        if self.paged is not None:
            add("kv_copy", self._kv_copy, kv, (longs(1), longs(1, fill=S - 1)))
            token, pos = ints(1), ints(1)
            for s in range(S + self.lockstep):
                add("suffix", lambda k, v, t, p, s=s: self._suffix(
                    k, v, t, p, s), self._kv, (token, pos), variant=s)
        if self.spec is not None:
            dkv = (self._dk, self._dv)
            for b, step in self._draft_prefills.items():
                add(f"draft_prefill_{b}", step, self._dkv,
                    (longs(1, b), slot, length))
            add("draft", self._draft, dkv, (ints(S), ints(S)))
            k1 = self.spec.k + 1
            add("verify", self._verify, kv, (ints(S, k1), ints(S, k1)))
        if self.kvship:
            nl, _, _, nh, hd = self.kv_spec.shape
            for b in self.buckets:
                rows = (nl, 1, b, nh, hd)
                add(f"kv_import_{b}", build_kv_import(b), kv,
                    (torch.zeros(rows, dtype=self._k.dtype, device=dev),
                     torch.zeros(rows, dtype=self._k.dtype, device=dev),
                     slot))

    def _warm(self) -> None:
        """Run every program once on the scratch caches (first-call
        costs: kernel library load, cuBLAS handles and workspaces, the
        decode kernels' scratch), on the card on the stream the captures
        will use."""
        dev = self.device
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()):
            for fn, inputs in self._programs.values():
                fn(*inputs)
        if self._stream is not None:
            torch.cuda.current_stream(dev).wait_stream(self._stream)

    def _zero_caches(self) -> None:
        for c in (*self._kv, *(self._dkv or ())):
            c.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _capture_all(self) -> None:
        """One CUDA graph per program (module docstring), in one pool,
        on the warm-up's stream."""
        pool = torch.cuda.graph_pool_handle()
        for key, (fn, inputs) in self._programs.items():
            g = capture_graph(lambda: fn(*inputs), self.device, pool=pool,
                              stream=self._stream)
            self._graphs[key] = g
            self.captures[key[0]] = self.captures.get(key[0], 0) + 1
            self.capture_ms += g.capture_ms
            self.pool_bytes += g.pool_bytes

    def _run(self, name: str, *values, variant=None):
        """Program ``name``: ``values`` (host arrays or tensors) into its
        static inputs, then its graph's replay (on the CPU its eager
        step).  The outputs of a replay are the graph's own buffers:
        read them before the next call."""
        key = (name, variant)
        fn, inputs = self._programs[key]
        for buf, v in zip(inputs, values):
            copy_in(buf, v)
        graph = self._graphs.get(key)
        return graph.replay() if graph is not None else fn(*inputs)

    @torch.inference_mode()
    def run_eager(self, name: str, *values, variant=None):
        """The eager step that program ``name``'s graph was captured
        from, on the same caches, with ``values`` as its inputs (fresh
        tensors on the device): what a replay is held against.  Returns
        its output tensor (not yet synced)."""
        fn, inputs = self._programs[(name, variant)]
        args = []
        for buf, v in zip(inputs, values):
            t = torch.empty_like(buf)
            copy_in(t, v)
            args.append(t)
        return fn(*args)

    def close(self) -> None:
        """Release the graphs (their captured collectives included), the
        programs and the caches now, not when the collector reaches the
        programs' reference cycles: a process group is destroyed only
        after the graphs that use its communicators."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for g in self._graphs.values():
            g.graph.reset()
        self._graphs.clear()
        self._programs.clear()
        self._prefills.clear()
        self._draft_prefills.clear()
        self._decode = self._draft = self._verify = None
        self._suffix = self._kv_copy = None
        self._kv = self._dkv = None
        self._k = self._v = self._dk = self._dv = None

    # -- serving -----------------------------------------------------------

    def _prompt(self, slot: int, tokens, length: int,
                bucket: int) -> np.ndarray:
        """A prefill's inputs, checked on the host (the device indexes
        with them): ``[1, bucket]`` token ids in the vocabulary."""
        ids = np.asarray(tokens, np.int64).reshape(1, -1)
        if bucket not in self._prefills or ids.shape != (1, bucket) \
                or not 0 <= slot < self.slots or not 1 <= length <= bucket:
            raise ValueError(f"bad prefill slot={slot} length={length} "
                             f"bucket={bucket} tokens {ids.shape}")
        vocab = self.model.config.vocab_size
        if ids.min() < 0 or ids.max() >= vocab:
            # prompts come from users: an id past the embedding would be a
            # device-side fault on the card (the JAX gather clamps it)
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        return ids

    @torch.inference_mode()
    def prefill(self, slot: int, tokens: np.ndarray, length: int,
                bucket: int) -> int:
        """Insert a request at ``slot``: write its K/V block, return its
        first generated token."""
        t0 = time.monotonic()
        ids = self._prompt(slot, tokens, length, bucket)
        out = int(self._run(f"prefill_{bucket}", ids, [slot], [length]))
        self._account("prefill", time.monotonic() - t0)
        return out

    def _positions(self, positions) -> np.ndarray:
        pos = np.asarray(positions, np.int32)
        if pos.shape != (self.slots,) or pos.min() < 0 \
                or pos.max() >= self.max_seq_len:
            # validated on the host: the device write would go out of
            # bounds (the JAX program would drop it silently)
            raise ValueError(f"decode positions must be [{self.slots}] in "
                             f"[0, {self.max_seq_len}), got {pos}")
        return pos

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray,
               positions: np.ndarray) -> np.ndarray:
        """One continuous-batching step: every slot advances a token."""
        t0 = time.monotonic()
        out = self._run("decode", np.asarray(tokens, np.int32),
                        self._positions(positions))
        result = out.cpu().numpy().astype(np.int32)
        self._account("decode", time.monotonic() - t0)
        return result

    @torch.inference_mode()
    def prefill_reused(self, slot: int, src_slot: int, tokens: np.ndarray,
                       length: int, matched: int) -> int:
        """Prefix-cache-hit insertion (serve/fleet/pages.py): copy the
        donor's rows on the device (the ``matched`` ones and the rest,
        core/steps.py ``build_kv_copy``), then teacher-force ONLY the
        unmatched suffix through the one-slot suffix step.  The last
        suffix step's argmax is the request's first generated token —
        the greedy contract of :meth:`prefill` at ``length - matched``
        computed tokens instead of ``length``."""
        if self._kv_copy is None:
            raise RuntimeError("engine built without paged=; no reuse "
                               "programs")
        toks = np.asarray(tokens, np.int64).reshape(-1)
        if not (0 <= slot < self.slots and 0 <= src_slot < self.slots
                and slot != src_slot and 1 <= matched <= length
                <= min(len(toks), self.max_seq_len)):
            raise ValueError(f"bad reuse slot={slot} src={src_slot} "
                             f"matched={matched} length={length}")
        vocab = self.model.config.vocab_size
        if toks[:length].min() < 0 or toks[:length].max() >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        t0 = time.monotonic()
        self._run("kv_copy", [src_slot], [slot])
        self._account("kv_copy", time.monotonic() - t0)
        # a full-prompt match still replays the final prompt token (a
        # same-value rewrite) to read its logits for the first token
        first = min(int(matched), int(length) - 1)
        dev = self.device
        t0 = time.monotonic()
        suffix = torch.from_numpy(toks[first:length].astype(np.int32)).to(
            dev)
        pos = torch.arange(first, length, dtype=torch.int32, device=dev)
        for i in range(length - first):
            out = self._run("suffix", suffix[i], pos[i], variant=int(slot))
        token = int(out)
        self._account("suffix", time.monotonic() - t0, n=length - first)
        return token

    @torch.inference_mode()
    def shadow_prefill(self, entry: dict) -> None:
        """Another data shard's admission (a plan's prefill ``entry``,
        serve/scheduler.py) run here at the scratch slot past this
        rank's block, its results dropped: under lockstep (module
        docstring) that admission's programs gather parameters over
        every data shard, so every rank runs them, in the plan's order.
        The owner's programs, counted as its calls are: the bucket's
        prefill, or, for a prefix-cache hit, as many suffix steps (the
        page copy moves no parameter); then the draft prefill when the
        plan asks for one."""
        if not self.lockstep:
            raise RuntimeError("shadow_prefill without lockstep")
        scratch = self.slots
        bucket, length = entry["bucket"], entry["length"]
        ids = self._prompt(0, entry["tokens"], length, bucket)
        t0 = time.monotonic()
        reuse = entry.get("reuse")
        if reuse is not None:
            toks = np.asarray(entry["tokens"], np.int64).reshape(-1)
            first = min(int(reuse["matched"]), int(length) - 1)
            for i in range(first, length):
                self._run("suffix", [int(toks[i])], [i], variant=scratch)
            self._account("suffix", time.monotonic() - t0, n=length - first)
        else:
            self._run(f"prefill_{bucket}", ids, [scratch], [length])
            self._account("prefill", time.monotonic() - t0)
        if entry.get("draft"):
            t0 = time.monotonic()
            self._run(f"draft_prefill_{bucket}", ids, [scratch], [length])
            self._account("draft_prefill", time.monotonic() - t0)

    # -- KV-page shipping (fleet disaggregation, prefix federation) --------

    @torch.no_grad()
    def export_kv(self, slot: int, bucket: int
                  ) -> "tuple[torch.Tensor, torch.Tensor]":
        """Device-to-host copy of ``slot``'s cache rows ``[0, bucket)``
        in every layer: ``([n_layer, 1, bucket, H, D], same)`` CPU
        tensors in the cache dtype, the payload a prefill replica ships
        to a decode replica; under ``tensor`` every head, gathered over
        the tensor group (each of its ranks calls this together).  Rows
        past the prompt are pad garbage; the importer registers (and the
        reuse path copies) only the prompt's whole pages, so they never
        reach a decode."""
        if bucket not in self.buckets or not 0 <= slot < self.slots:
            raise ValueError(f"bad export slot={slot} bucket={bucket}")
        t0 = time.monotonic()
        tp = self.model.tp
        rows = []
        for c in (self._k, self._v):
            r = c[:, slot:slot + 1, :bucket]
            if tp is not None:
                # the tensor group's heads in rank order (collective)
                r = all_gather_along(r.contiguous(), 3, tp.group)
            rows.append(r.to("cpu", copy=True))
        rows = tuple(rows)
        self._account("kv_export", time.monotonic() - t0)
        return rows

    @torch.inference_mode()
    def import_kv(self, slot: int, k_rows, v_rows) -> None:
        """Install shipped donor rows at ``slot`` through the bucket's
        ``kv_import_{b}`` program: the rows are cast to the cache dtype
        on the host, copied into the program's static buffers and the
        program replays (nothing is captured again).  Rows with every
        head give this rank its block of them."""
        if not self.kvship:
            raise RuntimeError("engine built without kvship=; no import "
                               "programs")
        bucket = int(k_rows.shape[2])
        nl, _, _, nh, hd = self.kv_spec.shape
        if self.head_block is not None and k_rows.ndim == 5 \
                and k_rows.shape[3] == self.model.config.n_head != nh:
            lo, hi = self.head_block
            k_rows, v_rows = k_rows[:, :, :, lo:hi], v_rows[:, :, :, lo:hi]
        if bucket not in self.buckets or not 0 <= slot < self.slots \
                or tuple(k_rows.shape) != (nl, 1, bucket, nh, hd) \
                or tuple(v_rows.shape) != tuple(k_rows.shape):
            raise ValueError(f"bad import slot={slot} rows "
                             f"{tuple(k_rows.shape)}")
        t0 = time.monotonic()
        dt = self._k.dtype
        self._run(f"kv_import_{bucket}", torch.as_tensor(k_rows).to(dt),
                  torch.as_tensor(v_rows).to(dt), [slot])
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._account("kv_import", time.monotonic() - t0)

    # -- speculative decoding ------------------------------------------------

    @torch.inference_mode()
    def draft_prefill(self, slot: int, tokens: np.ndarray, length: int,
                      bucket: int) -> None:
        """Write the DRAFT model's K/V rows for an admitted prompt (fresh
        and reused admissions alike: the draft cache has no copy plane).
        Its argmax is discarded: only the target decides tokens."""
        t0 = time.monotonic()
        ids = self._prompt(slot, tokens, length, bucket)
        self._run(f"draft_prefill_{bucket}", ids, [slot], [length])
        self._account("draft_prefill", time.monotonic() - t0)

    @torch.inference_mode()
    def draft(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """One k-step draft round over every slot: ``[S, k]`` drafted
        tokens (core/steps.py ``build_draft_step``)."""
        t0 = time.monotonic()
        out = self._run("draft", np.asarray(tokens, np.int32),
                        self._positions(positions))
        drafts = out.cpu().numpy().astype(np.int32)
        self._account("draft", time.monotonic() - t0)
        return drafts

    @torch.inference_mode()
    def verify(self, tokens: np.ndarray, positions: np.ndarray,
               drafts: np.ndarray) -> np.ndarray:
        """ONE batched target forward over the k drafted positions:
        ``[S, k+1]`` target argmaxes — column j is the token plain
        decode emits after accepting drafts ``1..j`` (the scheduler
        folds the longest agreeing prefix plus one corrected token)."""
        t0 = time.monotonic()
        pos = self._positions(positions)
        toks2 = np.concatenate([np.asarray(tokens, np.int32)[:, None],
                                np.asarray(drafts, np.int32)], axis=1)
        pos2 = (pos[:, None]
                + np.arange(self.spec.k + 1, dtype=np.int32)[None, :])
        out = self._run("verify", toks2, pos2)
        ver = out.cpu().numpy().astype(np.int32)
        self._account("verify", time.monotonic() - t0)
        return ver

    def _account(self, kind: str, seconds: float, n: int = 1) -> None:
        self.calls[kind] += n
        self.seconds[kind] += seconds
        reg = _metrics.get_registry()
        if reg is not None:
            reg.counter(f"rlt_serve_{kind}_seconds_total").inc(seconds)

    # -- evidence ----------------------------------------------------------

    #: the kernels the serve path runs (prefill; decode, suffix, draft
    #: and verify on one of the two decode kernels)
    KERNELS = ("flash_fwd", "flash_decode", "flash_decode_paged")
    #: the engine's programs, counted in ``calls`` / ``seconds`` (under
    #: lockstep another data shard's admissions too)
    PROGRAMS = ("prefill", "decode", "kv_copy", "suffix", "draft_prefill",
                "draft", "verify")
    #: KV shipping's calls, counted beside them: a slot's rows read out
    #: (no program) and ``kv_import_{b}``
    SHIPPING = ("kv_export", "kv_import")

    def stats(self) -> dict:
        """The engine's evidence:

        - ``decode_kernel``: the decode attention of the hot path
          (``dense`` | ``flash_decode`` | ``paged``);
        - ``calls`` / ``seconds``: calls served per program (suffix: per
          token) and their host wall seconds (:data:`PROGRAMS`, and
          :data:`SHIPPING`'s export and import);
        - ``kernel_launches``: this process's launch counts of the serve
          path's kernels (:data:`KERNELS`), a replay counting its
          graph's launches;
        - ``captures``: CUDA graphs per program name (``prefill_{b}``,
          ``decode``, ``kv_copy``, ``suffix`` one a slot,
          ``draft_prefill_{b}``, ``draft``, ``verify``; empty on the
          CPU), and ``recaptures``: those captured since setup, 0
          while serving (the JAX engine's ``traces`` / ``retraces``);
        - ``capture_ms``: the captures' host ms; ``pool_bytes``: the
          device memory their shared pool reserved; ``ungraphed``:
          ``None``, or why the programs run eagerly on the card;
        - ``mesh`` (``None`` without a strategy), ``slot_block``,
          ``head_block``, ``leader`` (module docstring) and ``kv_bytes``:
          this rank's share of the cache (both tensors; the draft's
          besides, with ``spec=``);
        - ``programs``: the JAX engine's program count for the same
          options (its ``kv_init``, the decode, a prefill per bucket,
          with ``paged=`` the copy and the suffix, with ``spec=`` the
          draft cache's init, draft and verify and a draft prefill per
          bucket, with ``kvship=`` an import per bucket);
        - ``spec`` (with ``spec=``): ``k``, the draft's layers, whether
          its parameters are the target's own tensors, ``draft_quant``,
          the bytes of a standalone draft copy (``draft_fp_bytes``), the
          bytes its residency adds (``draft_resident_bytes``: 0 when
          shared, the int8 pairs otherwise) and their difference;
        - ``compile_cache``: whether the cache is active, its dir and
          status word, and this process's hits, misses, nvcc and
          capture seconds (compile/cache.py ``engine_stats``).
        """
        counts = _kernels.launch_counts()
        out = {
            "compile_cache": compile_cache_mod.engine_stats(),
            "decode_kernel": self.decode_kernel,
            "calls": dict(self.calls),
            "seconds": dict(self.seconds),
            "kernel_launches": {k: counts[k] for k in self.KERNELS},
            "captures": dict(self.captures),
            "recaptures": {n: c - self._captures_at_setup.get(n, 0)
                           for n, c in self.captures.items()},
            "capture_ms": self.capture_ms,
            "pool_bytes": self.pool_bytes,
            "ungraphed": self.ungraphed,
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            "slot_block": list(self.slot_block),
            "head_block": None if self.head_block is None
            else list(self.head_block),
            "leader": self.leader,
            "kv_bytes": self.kv_spec.nbytes(self._k.element_size())
            if self.kv_spec is not None else 0,
            "programs": 2 + len(self._prefills)
            + (2 if self.paged is not None else 0)
            + (3 + len(self._draft_prefills) if self.spec is not None
               else 0)
            + (len(self.buckets) if self.kvship else 0),
        }
        if self.spec is not None:
            target = {p.data_ptr() for p in self.model.parameters()}
            out["spec"] = {
                "k": self.spec.k,
                "draft_layers": self.draft_layers,
                # the draft's parameters are the target's own tensors
                "draft_shares_weights": all(
                    p.data_ptr() in target
                    for p in self.draft_model.parameters()),
                "draft_quant": self.spec.draft_quant,
                "draft_fp_bytes": self.draft_fp_bytes,
                "draft_resident_bytes": self.draft_resident_bytes,
                "draft_hbm_delta_bytes": self.draft_resident_bytes
                - self.draft_fp_bytes,
            }
        return out


@contextlib.contextmanager
def _swapped_params(module: torch.nn.Module, tensors: dict):
    """``module``'s parameters named in ``tensors`` replaced by those
    tensors for the block (the int8 draft's dequantized weights), then
    restored."""
    saved = []
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner)
        saved.append((mod, leaf, mod._parameters[leaf]))
        info = getattr(mod._parameters[leaf], "_rlt_shard", None)
        if info is not None:
            t._rlt_shard = info      # a piece is gathered at use
        mod._parameters[leaf] = t
    try:
        yield
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def decode_model_of(module, device) -> torch.nn.Module:
    """``module.configure_decode_model(device=device)``, or
    ``AttributeError`` when it has no decode model (``None``, or a model
    without the ``hidden_with_kv`` / ``decode`` surface: a pipelined
    GPT), the class the JAX engine raises on such a module."""
    model = module.configure_decode_model(device=device)
    missing = [n for n in ("hidden_with_kv", "decode")
               if not hasattr(model, n)]
    if missing:
        raise AttributeError(
            f"{type(module).__name__} has no decode model to serve: "
            f"configure_decode_model() gave {type(model).__name__}, "
            f"which has no {' or '.join(missing)}")
    return model


def _replicate_sequence(model: torch.nn.Module) -> None:
    """A serve model never splits a sequence: drop the sequence group a
    layout set, so a ``sequence`` axis's ranks serve as replicas."""
    for mod in model.modules():
        if hasattr(mod, "sp"):
            mod.sp = None


__all__ = ["ServeEngine", "decode_model_of"]

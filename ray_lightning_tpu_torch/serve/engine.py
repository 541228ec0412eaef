"""Serve engine: per-bucket prefill and one decode step over a
device-resident slot KV cache.

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
   its own KV cache, one draft prefill per bucket, the k-step draft and
   the batched verify) — and warms each once on the scratch caches,
   which it then zeroes again.

The decode attention is ``RLT_DECODE_IMPL`` (ops/flash_decode.py):
``paged`` walks the identity page table of the slot cache
(serve/fleet/pages.py) through the paged kernel when ``paged=`` is on
and its page size tiles ``max_seq_len``, and degrades to the
slot-contiguous ``flash_decode`` kernel otherwise, as the JAX engine
does; ``decode_kernel`` says which runs.

PyTorch runs eagerly, so there is no trace or compile cache: the JAX
engine's strategy/mesh, compile cache, KV shipping and int8-resident
drafts are not ported yet, and asking for them raises.  One CUDA graph
per bucket is the planned counterpart of "compiled once".
"""

from __future__ import annotations

import logging
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core.steps import (build_decode_step,
                                                build_draft_step,
                                                build_kv_copy,
                                                build_prefill_step,
                                                build_suffix_step,
                                                build_verify_step)
from ray_lightning_tpu_torch.ops import _kernels
from ray_lightning_tpu_torch.ops.flash_decode import resolve_decode_impl
from ray_lightning_tpu_torch.serve.fleet.pages import identity_page_table
from ray_lightning_tpu_torch.serve.kvcache import KVCacheSpec
from ray_lightning_tpu_torch.telemetry import metrics as _metrics

_log = logging.getLogger(__name__)


class ServeEngine:
    """Generation executor bound to one device."""

    def __init__(self, module, buckets: Sequence[int], slots: int,
                 max_seq_len: int, seed: int = 0,
                 weights: "Optional[dict]" = None,
                 device: "str | torch.device | None" = None, *,
                 strategy: Any = None, compile_cache: Any = None,
                 paged: Any = None, spec: Any = None,
                 kvship: bool = False):
        for name, value in (("strategy", strategy),
                            ("compile_cache", compile_cache)):
            if value is not None:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not ported yet")
        if kvship:
            raise NotImplementedError(
                "ServeEngine(kvship=True) is not ported yet")
        #: PageConfig (serve/fleet/pages.py): when enabled the engine also
        #: builds the page copy and the one-slot suffix step that make
        #: prefix-cache hits executable
        self.paged = paged if paged is not None and paged.enabled \
            else None
        #: SpecConfig (serve/spec.py): when enabled the engine builds the
        #: draft plane
        self.spec = spec if spec is not None and spec.enabled else None
        if self.spec is not None and self.spec.draft_quant is not None:
            raise NotImplementedError(
                f"draft_quant={self.spec.draft_quant!r} needs the comm "
                f"plane's codecs (comm/quant.py), not ported yet")
        self.device = resolve_device(device)
        self.module = module
        self.buckets = tuple(buckets)
        self.slots = int(slots)
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
        self.calls = {name: 0 for name in self.PROGRAMS}
        self.seconds = {name: 0.0 for name in self.PROGRAMS}
        self._prefills: dict = {}
        self._decode = None
        self._kv_copy = None
        self._suffix = None
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
        self._dk: Optional[torch.Tensor] = None
        self._dv: Optional[torch.Tensor] = None

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
        model = self.module.configure_decode_model(device=dev)
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
        self.model = model

        # cache geometry from one prefill capture at the smallest bucket
        probe = torch.zeros((1, self.buckets[0]), dtype=torch.long,
                            device=dev)
        _, kvs = model.hidden_with_kv(probe)
        k0 = kvs[0][0]
        self.kv_spec = KVCacheSpec.from_capture(
            [k for k, _ in kvs], self.slots, self.max_seq_len)
        self._k = torch.zeros(self.kv_spec.shape, dtype=k0.dtype,
                              device=dev)
        self._v = torch.zeros_like(self._k)

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
        self._warm()
        _log.info(
            "serve engine ready in %.2fs: device=%s buckets=%s slots=%d "
            "kv=%s (%.1f MB) decode=%s", time.monotonic() - t0, dev,
            self.buckets, self.slots, self.kv_spec.shape,
            self.kv_spec.nbytes(self._k.element_size()) / 2**20,
            self.decode_kernel)
        return self

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
        target = model.state_dict()
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
        draft.requires_grad_(False)
        draft.eval()
        self.draft_model = draft
        self.draft_layers = draft.config.n_layer
        probe = torch.zeros((1, self.buckets[0]), dtype=torch.long,
                            device=self.device)
        _, kvs = draft.hidden_with_kv(probe)
        self.draft_kv_spec = KVCacheSpec.from_capture(
            [k for k, _ in kvs], self.slots, self.max_seq_len)
        self._dk = torch.zeros(self.draft_kv_spec.shape,
                               dtype=kvs[0][0].dtype, device=self.device)
        self._dv = torch.zeros_like(self._dk)
        for b in self.buckets:
            self._draft_prefills[b] = build_prefill_step(draft, b)
        self._draft = build_draft_step(draft, self.spec.k, impl,
                                       self.page_table)
        self._verify = build_verify_step(model, impl, self.page_table)

    def _warm(self) -> None:
        """Run every step once on the scratch caches (first-call costs:
        kernel library load, cuBLAS handles), then zero the caches."""
        dev = self.device
        for b, step in self._prefills.items():
            step(self._k, self._v,
                 torch.zeros((1, b), dtype=torch.long, device=dev), 0, 1)
        zeros = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        self._decode(self._k, self._v, zeros, zeros)
        if self.paged is not None:
            self._kv_copy(self._k, self._v, 0, self.slots - 1, 1)
            z1 = torch.zeros(1, dtype=torch.int32, device=dev)
            self._suffix(self._k, self._v, z1, z1, 0)
        if self.spec is not None:
            for b, step in self._draft_prefills.items():
                step(self._dk, self._dv,
                     torch.zeros((1, b), dtype=torch.long, device=dev), 0,
                     1)
            self._draft(self._dk, self._dv, zeros, zeros)
            z2 = torch.zeros((self.slots, self.spec.k + 1),
                             dtype=torch.int32, device=dev)
            self._verify(self._k, self._v, z2, z2)
            self._dk.zero_()
            self._dv.zero_()
        self._k.zero_()
        self._v.zero_()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- serving -----------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, slot: int, tokens: np.ndarray, length: int,
                bucket: int) -> int:
        """Insert a request at ``slot``: write its K/V block, return its
        first generated token."""
        t0 = time.monotonic()
        if not 0 <= slot < self.slots or not 1 <= length <= bucket:
            raise ValueError(f"bad prefill slot={slot} length={length} "
                             f"bucket={bucket}")
        ids = np.asarray(tokens, np.int64).reshape(1, -1)
        vocab = self.model.config.vocab_size
        if ids.min() < 0 or ids.max() >= vocab:
            # prompts come from users: an id past the embedding would be a
            # device-side fault on the card (the JAX gather clamps it)
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        toks = torch.from_numpy(ids).to(self.device)
        out = int(self._prefills[bucket](self._k, self._v, toks,
                                         int(slot), int(length)))
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

    def _on_device(self, array) -> torch.Tensor:
        return torch.from_numpy(np.asarray(array, np.int32)).to(self.device)

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray,
               positions: np.ndarray) -> np.ndarray:
        """One continuous-batching step: every slot advances a token."""
        t0 = time.monotonic()
        out = self._decode(self._k, self._v, self._on_device(tokens),
                           self._on_device(self._positions(positions)))
        result = out.cpu().numpy().astype(np.int32)
        self._account("decode", time.monotonic() - t0)
        return result

    @torch.inference_mode()
    def prefill_reused(self, slot: int, src_slot: int, tokens: np.ndarray,
                       length: int, matched: int) -> int:
        """Prefix-cache-hit insertion (serve/fleet/pages.py): copy the
        ``matched`` donor rows on the device, then teacher-force ONLY the
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
        self._kv_copy(self._k, self._v, int(src_slot), int(slot),
                      int(matched))
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
            out = self._suffix(self._k, self._v, suffix[i], pos[i],
                               int(slot))
        token = int(out)
        self._account("suffix", time.monotonic() - t0, n=length - first)
        return token

    # -- speculative decoding ------------------------------------------------

    @torch.inference_mode()
    def draft_prefill(self, slot: int, tokens: np.ndarray, length: int,
                      bucket: int) -> None:
        """Write the DRAFT model's K/V rows for an admitted prompt (fresh
        and reused admissions alike: the draft cache has no copy plane).
        Its argmax is discarded: only the target decides tokens."""
        t0 = time.monotonic()
        ids = np.asarray(tokens, np.int64).reshape(1, -1)
        self._draft_prefills[bucket](self._dk, self._dv,
                                     torch.from_numpy(ids).to(self.device),
                                     int(slot), int(length))
        self._account("draft_prefill", time.monotonic() - t0)

    @torch.inference_mode()
    def draft(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """One k-step draft round over every slot: ``[S, k]`` drafted
        tokens (core/steps.py ``build_draft_step``)."""
        t0 = time.monotonic()
        out = self._draft(self._dk, self._dv, self._on_device(tokens),
                          self._on_device(self._positions(positions)))
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
        out = self._verify(self._k, self._v, self._on_device(toks2),
                           self._on_device(pos2))
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
    #: the engine's programs, counted in ``calls`` / ``seconds``
    PROGRAMS = ("prefill", "decode", "kv_copy", "suffix", "draft_prefill",
                "draft", "verify")

    def stats(self) -> dict:
        """Which decode attention serves the hot path, the steps served,
        the launch counts in this process of the serve path's kernels,
        and the draft plane's shape."""
        counts = _kernels.launch_counts()
        out = {
            "decode_kernel": self.decode_kernel,
            "calls": dict(self.calls),
            "seconds": dict(self.seconds),
            "kernel_launches": {k: counts[k] for k in self.KERNELS},
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
            }
        return out


__all__ = ["ServeEngine"]

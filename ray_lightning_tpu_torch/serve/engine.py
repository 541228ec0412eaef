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
   (core/steps.py) and warms each once on the scratch cache, which it
   then zeroes again.

PyTorch runs eagerly, so there is no trace or compile cache: the JAX
engine's strategy/mesh, compile cache, paged KV, speculative decoding
and KV shipping are not ported yet, and asking for them raises.  One
CUDA graph per bucket is the planned counterpart of "compiled once".
"""

from __future__ import annotations

import logging
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core.steps import (build_decode_step,
                                                build_prefill_step)
from ray_lightning_tpu_torch.ops import _kernels
from ray_lightning_tpu_torch.ops.flash_decode import resolve_decode_impl
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
                            ("compile_cache", compile_cache),
                            ("paged", paged), ("spec", spec)):
            if value is not None:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not ported yet")
        if kvship:
            raise NotImplementedError(
                "ServeEngine(kvship=True) is not ported yet")
        self.device = resolve_device(device)
        self.module = module
        self.buckets = tuple(buckets)
        self.slots = int(slots)
        self.max_seq_len = int(max_seq_len)
        self.seed = int(seed)
        self._weights = weights
        #: which decode attention the decode step uses — dense |
        #: flash_decode (resolved at setup from RLT_DECODE_IMPL)
        self.decode_kernel = "dense"
        self.kv_spec: Optional[KVCacheSpec] = None
        self.model: Optional[torch.nn.Module] = None
        #: prefill / decode calls served (the smoke script holds the
        #: kernels' launch counts against these) and their host wall
        #: seconds, each ending in the device sync that reads the tokens
        self.calls = {"prefill": 0, "decode": 0}
        self.seconds = {"prefill": 0.0, "decode": 0.0}
        self._prefills: dict = {}
        self._decode = None
        self._k: Optional[torch.Tensor] = None
        self._v: Optional[torch.Tensor] = None

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
        self.decode_kernel = resolve_decode_impl(None, dev)
        self._decode = build_decode_step(model, impl=self.decode_kernel)
        self._warm()
        _log.info(
            "serve engine ready in %.2fs: device=%s buckets=%s slots=%d "
            "kv=%s (%.1f MB) decode=%s", time.monotonic() - t0, dev,
            self.buckets, self.slots, self.kv_spec.shape,
            self.kv_spec.nbytes(self._k.element_size()) / 2**20,
            self.decode_kernel)
        return self

    def _warm(self) -> None:
        """Run every step once on the scratch cache (first-call costs:
        kernel library load, cuBLAS handles), then zero the cache."""
        for b, step in self._prefills.items():
            step(self._k, self._v,
                 torch.zeros((1, b), dtype=torch.long, device=self.device),
                 0, 1)
        zeros = torch.zeros(self.slots, dtype=torch.int32,
                            device=self.device)
        self._decode(self._k, self._v, zeros, zeros)
        self._k.zero_()
        self._v.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray,
               positions: np.ndarray) -> np.ndarray:
        """One continuous-batching step: every slot advances a token."""
        t0 = time.monotonic()
        pos = np.asarray(positions, np.int32)
        if pos.shape != (self.slots,) or pos.min() < 0 \
                or pos.max() >= self.max_seq_len:
            # validated on the host: the device write would go out of
            # bounds (the JAX program would drop it silently)
            raise ValueError(f"decode positions must be [{self.slots}] in "
                             f"[0, {self.max_seq_len}), got {pos}")
        toks = torch.from_numpy(np.asarray(tokens, np.int32)).to(
            self.device)
        out = self._decode(self._k, self._v, toks,
                           torch.from_numpy(pos).to(self.device))
        result = out.cpu().numpy().astype(np.int32)
        self._account("decode", time.monotonic() - t0)
        return result

    def _account(self, kind: str, seconds: float) -> None:
        self.calls[kind] += 1
        self.seconds[kind] += seconds
        reg = _metrics.get_registry()
        if reg is not None:
            reg.counter(f"rlt_serve_{kind}_seconds_total").inc(seconds)

    # -- evidence ----------------------------------------------------------

    #: the kernels the serve path runs (prefill, decode)
    KERNELS = ("flash_fwd", "flash_decode")

    def stats(self) -> dict:
        """Which decode attention serves the hot path, the steps served,
        and the launch counts in this process of the serve path's
        kernels."""
        counts = _kernels.launch_counts()
        return {
            "decode_kernel": self.decode_kernel,
            "calls": dict(self.calls),
            "seconds": dict(self.seconds),
            "kernel_launches": {k: counts[k] for k in self.KERNELS},
        }


__all__ = ["ServeEngine"]

"""Launch-free candidate scoring: bytes -> seconds, shapes -> memory fit.

Counterpart of ``ray_lightning_tpu/plan/cost.py``.  Per candidate,
without running anything on the card:

- **communication seconds**: the strategy's own per-step declaration
  (``step_collective_bytes``, parallel/strategy.py: the numbers the
  comm plane's audit is held to) through the per-link model
  (comm/audit.py ``bytes_to_seconds``): ``_ici`` ops ride NVLink, every
  other op the NIC when the run spans processes and NVLink otherwise;
  ``_bucketed`` ops count their modeled exposed half;
- **memory peak**: the state a rank holds (parameters at their resident
  dtype, the optimizer state: fp32 master and moments) under the
  candidate's layout (:func:`sharded_bytes`: whole under DDP, the
  optimizer state 1/W under ZeRO-1, each piece's bytes under FSDP and
  SPMD, parallel/layout.py ``ShardLayout`` on an abstract mesh), plus
  the step's transients (gradients at the parameters' dtype and fp32
  update deltas, as the parameters are laid out) and an activation
  term: the candidate policy's kept bytes (core/remat.py probe, scaled
  to the per-rank microbatch, :data:`REMAT_RESIDENCY_FACTOR`), or
  without a ladder the JAX batch proxy.  No un-donated second copy
  exists in the port (plan/candidates.py);
- **remat seconds** (:func:`remat_terms`): kept bytes a store and a
  load at ``hbm_gbps``, recomputed products at ``device_tflops``, and
  :data:`REMAT_BLOCK_OVERHEAD_S` a region a microbatch for every policy
  but "off".

Over-budget candidates are rejected under a named reason; the verify
step (compile/aot.py ``compile_scored``) replaces the modeled peak and
bytes by a fake-mode step's for the top-k.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

from ray_lightning_tpu_torch.comm.audit import bytes_to_seconds
from ray_lightning_tpu_torch.plan.candidates import Candidate
from ray_lightning_tpu_torch.plan.config import PlanConfig


@dataclasses.dataclass
class AbstractState:
    """A training state's shapes and dtypes, no storage: ``params``
    (name -> meta tensor at the resident dtype, the names
    ``named_parameters`` gives) and ``opt`` (every optimizer-state
    tensor as a meta tensor, with the parameter name it belongs to or
    ``None``), as ``build_init_fn`` would make them."""

    params: "dict[str, torch.Tensor]"
    opt: "list[tuple[Optional[str], torch.Tensor]]"


def _named_state(obj, key=None, out=None, seen=None) -> list:
    """(parameter name or None, tensor) of every tensor an optimizer
    state holds (dataclass fields, dicts, lists), each once."""
    out = [] if out is None else out
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        if id(obj) not in seen:
            seen.add(id(obj))
            out.append((key, obj))
        return out
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float,
                                           type(None), torch.Size)):
        return out
    seen.add(id(obj))
    if isinstance(obj, Mapping):
        for k, v in obj.items():
            _named_state(v, k if isinstance(k, str) else key, out, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _named_state(v, key, out, seen)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _named_state(getattr(obj, f.name), key, out, seen)
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            _named_state(v, key, out, seen)
    return out


def abstract_state(module, tx) -> AbstractState:
    """The module's training state on the meta device: the model made
    there, the optimizer state snapshot from its fp32 parameters, then
    the parameters cast to ``module.param_dtype`` (``build_init_fn``'s
    order)."""
    model = module.configure_model(device="meta")
    params = dict(model.named_parameters())
    opt = _named_state(tx.init(params))
    pd = getattr(module, "param_dtype", None)
    if pd is not None:
        params = {k: (p.to(pd) if p.is_floating_point() else p)
                  for k, p in params.items()}
    return AbstractState(params=params, opt=opt)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _local_fraction(strategy, mesh, params) -> "dict[str, float]":
    """Each parameter's share held by one rank under ``strategy``."""
    from ray_lightning_tpu_torch.parallel.layout import ShardLayout
    from ray_lightning_tpu_torch.parallel.strategy import _ParamSharded
    if not isinstance(strategy, _ParamSharded):
        return {k: 1.0 for k in params}
    layout = ShardLayout({k: tuple(p.shape) for k, p in params.items()},
                         strategy, mesh)
    return {k: math.prod(i.local_storage) / max(1, math.prod(i.storage))
            for k, i in layout.params.items()}


def sharded_bytes(abstract: AbstractState, strategy, mesh) -> int:
    """Bytes one rank holds of the state under ``strategy`` on ``mesh``
    (module docstring)."""
    from ray_lightning_tpu_torch.parallel.strategy import (
        FullyShardedStrategy, SpmdStrategy, Zero1Strategy)
    frac = _local_fraction(strategy, mesh, abstract.params)
    total = sum(int(_nbytes(p.shape, p.dtype) * frac[k])
                for k, p in abstract.params.items())
    dp = max(1, strategy.data_parallel_size(mesh))
    for key, t in abstract.opt:
        b = _nbytes(t.shape, t.dtype)
        if isinstance(strategy, (FullyShardedStrategy, SpmdStrategy)):
            b = int(b * frac.get(key, 1.0))
        elif isinstance(strategy, Zero1Strategy):
            b = math.ceil(math.prod(t.shape) / dp) * t.element_size()
        total += b
    return total


def _param_transients(abstract: AbstractState, strategy, mesh
                      ) -> "tuple[int, int]":
    """(gradient bytes at the parameters' dtypes, fp32 update-delta
    bytes) one rank holds."""
    frac = _local_fraction(strategy, mesh, abstract.params)
    grads = updates = 0
    for k, p in abstract.params.items():
        grads += int(_nbytes(p.shape, p.dtype) * frac[k])
        updates += int(4 * math.prod(p.shape) * frac[k])
    return grads, updates


#: fraction of a policy's saved bytes modeled live: 1.0, since eager
#: autograd keeps every saved tensor until the backward reads it (the
#: JAX package's 0.3 models XLA's buffer sharing, which the port has no
#: counterpart of)
REMAT_RESIDENCY_FACTOR = 1.0

#: seconds one remat region adds a step beyond its modeled recompute,
#: a region a microbatch for every policy but "off": the ladder's
#: measured gap of a selective checkpoint (its Python dispatch mode over
#: every op of the block) on an H100 80GB HBM3 at 700 W, gpt2-medium
#: "dots" 180.117 ms against "off" 119.304 ms a step over 24 regions
#: (``chip_smoke.py`` phase 17); the JAX package's 5e-6 models a TPU
#: fusion break
REMAT_BLOCK_OVERHEAD_S = (180.117 - 119.304) / 1e3 / 24


def remat_terms(probe, policy: str, config: PlanConfig,
                process_count: int, dp: int,
                microbatch: int) -> "tuple[int, float]":
    """(peak activation bytes, remat seconds) for one candidate: the
    probe at the process-local batch, scaled by ``process_count / dp``;
    residency divides by the microbatch count, traffic and recompute do
    not (the JAX function, with the port's two constants)."""
    scale = process_count / max(1, dp)
    saved = probe.saved_bytes * REMAT_RESIDENCY_FACTOR * scale
    act_bytes = int(saved / max(1, microbatch))
    seconds = bytes_to_seconds(2 * saved, config.hbm_gbps)
    seconds += (probe.recompute_flops * scale
                / (config.device_tflops * 1e12))
    if policy != "off":
        seconds += probe.n_blocks * microbatch * REMAT_BLOCK_OVERHEAD_S
    return act_bytes, seconds


def link_gbps(op: str, config: PlanConfig, process_count: int) -> float:
    """The modeled rate ONE declared collective op rides: ``_ici`` ops
    NVLink always; every other op the NIC exactly when the run spans
    processes."""
    if op.endswith("_ici"):
        return config.ici_gbps
    return config.dcn_gbps if process_count > 1 else config.ici_gbps


#: modeled fraction of a ``_bucketed`` collective's time left exposed
#: (half hidden behind compute; bytes stay the full payload)
BUCKETED_EXPOSED_FRACTION = 0.5


def op_overlap_factor(op: str) -> float:
    """Multiplier on one declared op's modeled seconds."""
    return BUCKETED_EXPOSED_FRACTION if op.endswith("_bucketed") else 1.0


def device_memory_budget(config: PlanConfig,
                         device: "torch.device | None" = None
                         ) -> Optional[int]:
    """Per-device budget: the config's ``hbm_budget_bytes``, else the
    card's ``total_memory`` (``device`` or the current card), else
    ``None`` (the CPU: memory never rejects)."""
    if config.hbm_budget_bytes is not None:
        return int(config.hbm_budget_bytes)
    dev = torch.device(device) if device is not None else None
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        index = dev.index if dev is not None and dev.index is not None \
            else torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(index).total_memory)
    return None


@dataclasses.dataclass
class Estimate:
    """One candidate's launch-free score (the JAX fields)."""

    comm_bytes: int
    comm_seconds: float
    state_bytes: int
    peak_bytes: int
    budget: Optional[int]
    donate_preferred: bool = True     # in place: always (candidates.py)
    reason: Optional[str] = None
    remat_policy: str = ""
    act_bytes: int = 0
    remat_seconds: float = 0.0

    @property
    def fits(self) -> bool:
        return self.reason is None

    @property
    def step_seconds(self) -> float:
        return self.comm_seconds + self.remat_seconds

    def to_dict(self) -> dict:
        return {
            "comm_bytes": int(self.comm_bytes),
            "comm_seconds": float(self.comm_seconds),
            "state_bytes": int(self.state_bytes),
            "peak_bytes": int(self.peak_bytes),
            "budget_bytes": self.budget,
            "donate_preferred": self.donate_preferred,
            "remat_policy": self.remat_policy or None,
            "act_bytes": int(self.act_bytes),
            "remat_seconds": float(self.remat_seconds),
        }


def estimate_candidate(candidate: Candidate, strategy, mesh,
                       abstract: AbstractState, batch_bytes_global: int,
                       config: PlanConfig, process_count: int,
                       grad_sync=None, remat_probe=None,
                       device: "torch.device | None" = None) -> Estimate:
    """Score one candidate from shapes alone (module docstring)."""
    op_bytes = strategy.step_collective_bytes(mesh, abstract.params,
                                              comm=grad_sync)
    comm_bytes = int(sum(op_bytes.values()))
    comm_seconds = sum(
        bytes_to_seconds(b, link_gbps(op, config, process_count))
        * op_overlap_factor(op) for op, b in op_bytes.items())
    state_bytes = sharded_bytes(abstract, strategy, mesh)
    dp = max(1, strategy.data_parallel_size(mesh))
    if grad_sync is not None:
        # the error-feedback residual: one fp32 copy of what a rank syncs
        n = sum(math.prod(p.shape) for p in abstract.params.values())
        state_bytes += 4 * n
    grads_bytes, updates_bytes = _param_transients(abstract, strategy, mesh)
    remat_seconds = 0.0
    if remat_probe is not None:
        act_bytes, remat_seconds = remat_terms(
            remat_probe, candidate.remat, config, process_count, dp,
            max(1, candidate.microbatch))
    else:
        act_bytes = int(batch_bytes_global / dp * config.activation_factor
                        / max(1, candidate.microbatch))
    peak = state_bytes + grads_bytes + updates_bytes + act_bytes
    budget = device_memory_budget(config, device)
    reason = None
    if budget is not None and peak > config.headroom * budget:
        reason = (f"hbm_over_budget: modeled peak {peak >> 20} MiB "
                  f"(donated) > {int(config.headroom * budget) >> 20} MiB "
                  f"({config.headroom:.0%} of {budget >> 20} MiB/device)")
    return Estimate(comm_bytes=comm_bytes, comm_seconds=comm_seconds,
                    state_bytes=state_bytes, peak_bytes=peak,
                    budget=budget, reason=reason,
                    remat_policy=candidate.remat, act_bytes=act_bytes,
                    remat_seconds=remat_seconds)


def rank_key(candidate: Candidate, est: Estimate) -> tuple:
    """Deterministic ranking: fewest modeled seconds (comm + remat),
    then the donation flag agreeing with the preferred one, then lower
    peak, then label: a total order every rank computes alike."""
    mismatch = 0 if candidate.donate == est.donate_preferred else 1
    return (est.step_seconds, mismatch, est.peak_bytes, candidate.label)


def expected_accepted(acceptance: float, k: int) -> float:
    """Expected draft tokens accepted a speculative round at per-token
    acceptance ``acceptance`` and depth ``k``: ``a (1 - a^k) / (1 - a)``
    (the mean of the truncated geometric run)."""
    a = min(1.0, max(0.0, float(acceptance)))
    k = max(1, int(k))
    if a >= 1.0:
        return float(k)
    return a * (1.0 - a ** k) / (1.0 - a)


def speculative_speedup(acceptance: float, k: int,
                        draft_cost_ratio: float) -> float:
    """Modeled speedup of speculative decoding over plain decode:
    ``(1 + E[accepted]) / (1 + k * draft_cost_ratio)``; below 1 the
    speculation loses (the scheduler's ``min_accept`` fallback)."""
    r = max(0.0, float(draft_cost_ratio))
    return (1.0 + expected_accepted(acceptance, k)) \
        / (1.0 + max(1, int(k)) * r)


__all__ = ["AbstractState", "BUCKETED_EXPOSED_FRACTION", "Estimate",
           "REMAT_BLOCK_OVERHEAD_S", "REMAT_RESIDENCY_FACTOR",
           "abstract_state", "device_memory_budget", "estimate_candidate",
           "expected_accepted", "link_gbps", "op_overlap_factor",
           "rank_key", "remat_terms", "sharded_bytes",
           "speculative_speedup"]

"""Mixture-of-experts feed-forward layer (a routed MLP).

Counterpart of ``ray_lightning_tpu/ops/moe.py`` ``MoEMLP`` and
``total_aux_loss``, op for op, so both packages agree on the same
weights:

- an fp32 router: gate logits ``x @ router`` and their softmax in fp32,
  the top ``k`` experts of each token (``torch.topk``; ``jax.lax.top_k``);
  with ``k > 1`` the k gate values renormalised to sum to one, with
  ``k == 1`` the raw top-1 probability kept (Switch), so the router
  learns through the task loss;
- a fixed capacity a group (the batch row): ``min(S, ceil(cf * k * S /
  E))`` slots an expert, filled choice by choice with a per-expert
  counter carried across choices (a token's second choice sees the
  slots other tokens' first choices took); a token past an expert's
  capacity is dropped there (its output is zero; the block's residual
  passes it on);
- the Switch load-balance loss ``E * sum_e(frac_e * mean_prob_e)`` over
  the first choices (1.0 at perfect balance);
- dispatch, expert FFN (tanh GELU), combine as four ``torch.einsum``
  products in the compute dtype, the combine weights cast to it.  The
  JAX package leaves these products to XLA (no Pallas kernel), so here
  they are plain products.

The intermediates ``moe_dispatch``, ``moe_hact`` and ``moe_combine``
carry their names (core/remat.py ``checkpoint_name``) when the model's
remat policy is one of the MoE save lists.  Expert *parallelism*
(``moe_partition_rules``: the experts on an ``expert`` mesh axis) needs
``SpmdStrategy`` and raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.remat import checkpoint_name


class MoEMLP(nn.Module):
    """Routed MLP over ``[G, S, M]`` (groups = the batch rows): returns
    ``(out [G, S, M] in the compute dtype, aux)``, the fp32 scalar
    load-balance loss.  Parameters in the flax layout and names:
    ``router`` [M, E], ``w1`` [E, M, d_ff], ``w2`` [E, d_ff, M], fp32
    (cast to the compute dtype at use, as flax promotes them)."""

    def __init__(self, n_embd: int, n_experts: int, d_ff: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 tag_names: bool = False):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k={top_k} must be in [1, {n_experts}]")
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        #: tag the named intermediates for a MoE save list (a copy each)
        self.tag_names = tag_names
        self.router = nn.Parameter(torch.empty(n_embd, n_experts))
        self.w1 = nn.Parameter(torch.empty(n_experts, n_embd, d_ff))
        self.w2 = nn.Parameter(torch.empty(n_experts, d_ff, n_embd))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers: ``router`` N(0, 0.02); ``w1``, ``w2``
        ``lecun_normal`` (a truncated normal of variance 1 / fan_in, where
        jax's fan_in of an [E, in, out] kernel is E * in)."""
        self.router.copy_(torch.randn(self.router.shape, generator=generator,
                                      device=self.router.device) * 0.02)
        for w in (self.w1, self.w2):
            std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) \
                / .87962566103423978
            t = torch.empty(w.shape, device=w.device)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.copy_(t * std)

    def capacity(self, S: int) -> int:
        return min(S, int(math.ceil(
            self.capacity_factor * self.top_k * S / self.n_experts)))

    def _name(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return checkpoint_name(x, name) if self.tag_names else x

    def route(self, x: torch.Tensor):
        """The router: ``(dispatch [G, S, E, cap] in x's dtype, combine
        [G, S, E, cap] fp32, aux)``."""
        G, S, _ = x.shape
        E, k = self.n_experts, self.top_k
        cap = self.capacity(S)
        probs = torch.softmax(
            torch.einsum("gsm,me->gse", x.float(), self.router.float()), -1)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
        if k > 1:
            gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        dispatch = x.new_zeros((G, S, E, cap))
        combine = torch.zeros((G, S, E, cap), dtype=torch.float32,
                              device=x.device)
        taken = torch.zeros((G, 1, E), dtype=torch.int32, device=x.device)
        for i in range(k):
            onehot = F.one_hot(gate_idx[..., i], E).to(torch.int32)
            pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1 + taken
            taken = taken + onehot.sum(dim=1, keepdim=True, dtype=torch.int32)
            keep = onehot * (pos < cap)
            slot = F.one_hot(pos.clamp(0, cap - 1).long(), cap).float()
            d_i = keep.float()[..., None] * slot
            dispatch = dispatch + d_i.to(x.dtype)
            combine = combine + gate_vals[..., i, None, None] * d_i
        first = F.one_hot(gate_idx[..., 0], E).float()
        aux = E * torch.sum(first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
        return dispatch, combine, aux

    def forward(self, x: torch.Tensor):
        from ray_lightning_tpu_torch.models.gpt import gelu_tanh
        dt = self.dtype
        dispatch, combine, aux = self.route(x)
        dispatch = self._name(dispatch, "moe_dispatch")
        xe = torch.einsum("gsec,gsm->egcm", dispatch, x)
        h = torch.einsum("egcm,emh->egch", xe, self.w1.to(dt))
        h = self._name(gelu_tanh(h), "moe_hact")
        out = torch.einsum("egch,ehm->egcm", h, self.w2.to(dt))
        return torch.einsum("gsec,egcm->gsm",
                            self._name(combine.to(dt), "moe_combine"),
                            out), aux


def total_aux_loss(model) -> "torch.Tensor | None":
    """The sum of the load-balance losses of ``model``'s last forward
    (``model.moe_aux``: models/gpt.py ``GPT.hidden`` sums its routed
    layers', in layer order), or ``None`` for a model without routed
    layers, as the JAX function sums the sown ``losses`` leaves."""
    return getattr(model, "moe_aux", None)


def moe_partition_rules(expert_axis: str = "expert",
                        tensor_axis: str = "tensor"):
    """The JAX package's SPMD rules for expert parallelism (the experts
    sharded on an ``expert`` mesh axis).  Not ported: they need
    ``SpmdStrategy`` (ROADMAP.md queue 1 item 9); the routed layer
    itself runs on one card."""
    raise NotImplementedError(
        "moe_partition_rules (expert parallelism) needs SpmdStrategy, "
        "which is not ported yet (ROADMAP.md queue 1 item 9)")


__all__ = ["MoEMLP", "moe_partition_rules", "total_aux_loss"]

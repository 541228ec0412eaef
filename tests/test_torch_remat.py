"""PyTorch/CUDA port, the remat ladder (core/remat.py) and the kernels as
torch custom ops.

- (a) every policy ("off", "dots", "dots_no_batch", "full", and on the
  routed model "dots_moe_act", "dots_moe") gives the loss and every
  gradient of "off" bit for bit: the narrow GPT with plain attention
  and with the flash ops (their plain versions on the CPU), tiny BERT,
  and ``moe-tiny``;
- (b) what a policy keeps: the bytes autograd saves (a
  ``saved_tensors_hooks`` count) plus the outputs the selective
  checkpoint keeps (the ops its policy function marks, counted by a
  dispatch mode over the forward) order off >= dots >= dots_no_batch
  >= full, strictly where the model has batched products (the plain
  attention), and the MoE save lists keep more than "dots"; the flash
  ops are recomputed under every policy but "off";
- (c) ``torch.library.opcheck`` on every custom op's CPU implementation:
  ``rlt::flash_fwd`` (with its gradient), ``rlt::flash_bwd``,
  ``rlt::flash_decode``, ``rlt::flash_decode_paged`` (their scratch
  declared mutated), ``rlt::philox_uniform``, ``rlt::checkpoint_name``;
- (d) gpt2-medium and gpt2-moe-8e build with their default "dots"
  (meta device: no storage).

Bit for bit is the bar throughout: a policy changes what is saved and
what is recomputed, never the arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd.graph import saved_tensors_hooks
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from ray_lightning_tpu_torch.core.remat import (CHECKPOINT_NAME_OP,
                                                MOE_POLICIES, POLICY_LADDER,
                                                checkpoint_name,
                                                policy_object, save_policy)
from ray_lightning_tpu_torch.models import bert as tbert
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPT,
                                                GPTLightningModule)
from ray_lightning_tpu_torch.ops import flash_attention as fa
from ray_lightning_tpu_torch.ops import flash_decode as fd
from ray_lightning_tpu_torch.ops import random as trandom

#: the narrow GPT: tiny's widths, fp32
NARROW = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32,
                             remat=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _KeptBytes(TorchDispatchMode):
    """Over a forward: the bytes of every op output the selective
    policy ``policy`` marks ``MUST_SAVE`` (what the checkpoint caches),
    and the ops seen."""

    def __init__(self, policy):
        super().__init__()
        self.policy = policy
        self.bytes = 0
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.add(func)
        if self.policy is not None and self.policy(
                None, func, *args, **(kwargs or {})) \
                is CheckpointPolicy.MUST_SAVE:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.bytes += sum(t.numel() * t.element_size() for t in outs
                              if isinstance(t, torch.Tensor))
        return out


def _run(model, forward, policy):
    """``(loss, grads, kept bytes, ops)``: one forward and backward, the
    bytes autograd saves outside checkpoints plus those the policy's
    checkpoints keep."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    mode = _KeptBytes(save_policy(policy))
    with saved_tensors_hooks(pack, lambda t: t), mode:
        loss = forward(model)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads, saved[0] + mode.bytes, mode.ops


def _gpt(policy, **kw):
    model = GPT(dataclasses.replace(NARROW, remat_policy=policy, **kw),
                device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _tokens(vocab=512, shape=(2, 64), seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape))


def _lm_loss(x):
    return lambda m: m(x).logsumexp(-1).mean() - m(x)[..., 0].mean()


def _ladder(make, forward, policies):
    out = {p: _run(make(p), forward, p) for p in policies}
    loss0, g0, _, _ = out["off"]
    for p, (loss, g, _, _) in out.items():
        assert torch.equal(loss, loss0), p
        assert all(torch.equal(a, b) for a, b in zip(g, g0)), p
    return {p: out[p][2] for p in policies}, {p: out[p][3] for p in policies}


# -- (a) + (b) ----------------------------------------------------------------

def test_gpt_plain_attention_ladder():
    """Plain attention (the CPU's default): its score and PV products are
    batched, so "dots" keeps strictly more than "dots_no_batch"."""
    kept, _ = _ladder(lambda p: _gpt(p, attention_impl="dot"),
                      _lm_loss(_tokens()), POLICY_LADDER)
    assert kept["off"] > kept["dots"] > kept["dots_no_batch"] \
        > kept["full"], kept


def test_gpt_flash_ops_ladder():
    """The flash custom ops (plain versions on the CPU): every policy's
    gradients equal "off"; the ops are recomputed (never kept) under the
    dots policies; a linear folds to a product without batch dims, so
    "dots" and "dots_no_batch" keep the same bytes here."""
    kept, ops = _ladder(lambda p: _gpt(p, attention_impl="flash"),
                        _lm_loss(_tokens()), POLICY_LADDER)
    assert kept["off"] > kept["dots"] == kept["dots_no_batch"] \
        > kept["full"], kept
    flash = torch.ops.rlt.flash_fwd.default
    assert flash in ops["dots"]
    for p in ("dots", "dots_no_batch"):
        assert save_policy(p)(None, flash) \
            is CheckpointPolicy.PREFER_RECOMPUTE


def test_bert_ladder():
    """Tiny BERT's masked-LM head over every policy, non-causal flash."""
    cfg = dataclasses.replace(tbert.CONFIGS["tiny"], dtype=torch.float32,
                              attention_impl="flash")
    base = tbert.BertForMaskedLM(cfg, device="cpu")
    base.init_weights(torch.Generator().manual_seed(0))

    def make(policy):
        m = tbert.BertForMaskedLM(dataclasses.replace(
            cfg, remat=True, remat_policy=policy), device="cpu")
        m.load_state_dict(base.state_dict())
        assert m.remat_policy == policy
        return m

    kept, _ = _ladder(make, _lm_loss(_tokens(cfg.vocab_size, (2, 64))),
                      POLICY_LADDER)
    assert kept["off"] >= kept["dots"] >= kept["dots_no_batch"] \
        >= kept["full"], kept


def test_moe_tiny_ladder_with_save_lists():
    """moe-tiny (its routed block's four batched products): every policy,
    the MoE save lists included, gives "off"'s gradients bit for bit;
    "dots_moe" keeps more than "dots_moe_act", which keeps more than
    "dots"; "dots_no_batch" recomputes the routed products."""
    base = GPT(dataclasses.replace(CONFIGS["moe-tiny"], dtype=torch.float32),
               device="cpu")
    base.init_weights(torch.Generator().manual_seed(0))

    def make(policy):
        m = GPT(dataclasses.replace(CONFIGS["moe-tiny"], dtype=torch.float32,
                                    remat=True, remat_policy=policy),
                device="cpu")
        m.load_state_dict(base.state_dict())
        return m

    x = _tokens()

    def forward(m):
        return _lm_loss(x)(m) + 0.01 * m.moe_aux

    kept, ops = _ladder(make, forward, POLICY_LADDER + MOE_POLICIES)
    assert kept["off"] > kept["dots_moe"] > kept["dots_moe_act"] \
        > kept["dots"] > kept["dots_no_batch"] > kept["full"], kept
    assert torch.ops.rlt.checkpoint_name.default in ops["dots_moe"]
    assert torch.ops.rlt.checkpoint_name.default not in ops["dots"]


def test_policy_objects():
    """"off" is no wrap; the rest wrap; an unknown name raises naming the
    options; a name tag is a copy with a straight-through gradient."""
    assert policy_object("off") is None
    for p in POLICY_LADDER[1:] + MOE_POLICIES:
        assert callable(policy_object(p))
    assert save_policy("full") is None and save_policy("off") is None
    with pytest.raises(ValueError, match="options"):
        policy_object("no_such")
    x = torch.randn(3, requires_grad=True)
    y = checkpoint_name(x, "moe_hact")
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    (g,) = torch.autograd.grad((y * 2).sum(), [x])
    assert torch.equal(g, torch.full((3,), 2.0))


# -- (c) opcheck ----------------------------------------------------------------

def _qkv(B=1, T=16, H=2, D=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, T, H, D, generator=g, requires_grad=True)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ops_pass_opcheck(causal):
    q, k, v = _qkv()
    torch.library.opcheck(fa.FWD_OP, (q, k, v, causal, 0.25))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                          sm_scale=0.25)
    torch.library.opcheck(fa.BWD_OP, tuple(t.detach() for t in
                                           (q, k, v, o, lse))
                          + (torch.randn_like(o), causal, 0.25))


def test_decode_ops_pass_opcheck():
    S, L, H, D = 2, 32, 2, 16
    g = torch.Generator().manual_seed(1)
    q = torch.randn(S, 1, H, D, generator=g)
    kc, vc = (torch.randn(S, L, H, D, generator=g) for _ in range(2))
    pos = torch.tensor([3, L - 1], dtype=torch.int32)

    def scratch():
        return torch.zeros(S * H, dtype=torch.int32), torch.zeros(64)

    torch.library.opcheck(fd.DECODE_OP, (q, kc, vc, pos, *scratch(), 64, 1))
    table = torch.arange(S * 2, dtype=torch.int32).view(S, 2)
    view = (S * 2, 16, H, D)
    torch.library.opcheck(fd.PAGED_OP, (q, kc.view(view), vc.view(view),
                                        pos, table, *scratch(), 64, 1))
    for op in (fd.DECODE_OP, fd.PAGED_OP):
        written = {a.name for a in op._opoverload._schema.arguments
                   if a.is_write}
        assert written == {"tickets", "ws"}


def test_other_ops_pass_opcheck():
    torch.library.opcheck(trandom.PHILOX_OP,
                          (torch.tensor([3, 4]), 99, [5, 6]))
    torch.library.opcheck(CHECKPOINT_NAME_OP,
                          (torch.randn(4, requires_grad=True), "moe_hact"))


# -- (d) the configs that default to "dots" -----------------------------------

@pytest.mark.parametrize("name", ["gpt2-medium", "gpt2-moe-8e"])
def test_dots_configs_build(name):
    model = GPTLightningModule(name).configure_model("meta")
    assert model.remat_policy == "dots"
    cfg = CONFIGS[name]
    assert len(model.h) == cfg.n_layer
    assert model.wte.weight.shape == (cfg.vocab_size, cfg.n_embd)

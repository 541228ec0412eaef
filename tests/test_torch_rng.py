"""PyTorch/CUDA port, keyed random draws (ops/random.py): the draws a
graphed chunk replays with each step's own key.

- (a) the draw: Philox4x32-10 against the published known-answer
  vectors (Salmon et al., SC'11, Random123's ``kat_vectors``); a keyed
  uniform is deterministic, stateless (the global RNG state untouched),
  exact multiples of 2**-24 in [0, 1), different across keys and sites;
  ``rlt::philox_uniform`` passes ``torch.library.opcheck``;
- (b) the context: ``StepContext.make_key`` is a function of the step's
  entropy and the call's index, ``dropout_seed`` is a key, keys pickle
  and compare; a context without entropy raises;
- (c) the chunk: a train step fed the key words a graphed chunk feeds
  (``step_fn.key_words``, the ``ChunkRunner``'s static input) equals the
  eager step bit for bit, for a dropout GPT and a masked-LM BERT; a
  ``steps_per_execution=4`` fit equals the k=1 fit bit for bit
  (losses, parameters and optimizer state);
- (d) remat: every remat policy's recompute draws the same dropout
  masks: loss and gradients equal "off" bit for bit.

The card's side (the kernel against this plain version, bit for bit;
graphed fits against eager ones) is in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import Callback, Trainer
from ray_lightning_tpu_torch.core.module import StepContext
from ray_lightning_tpu_torch.core.steps import (build_init_fn,
                                                build_train_step)
from ray_lightning_tpu_torch.models.bert import BertMLMModule
from ray_lightning_tpu_torch.models.bert import CONFIGS as BERT_CONFIGS
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPTConfig,
                                                GPTLightningModule)
from ray_lightning_tpu_torch.ops import random as trandom
from ray_lightning_tpu_torch.ops.attention import (dropout,
                                                   dropout_keep_mask,
                                                   fold_in)
from ray_lightning_tpu_torch.ops.random import Key, as_key, key_words


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the draw --------------------------------------------------------------

#: (counter, key, output) of Philox4x32-10 (Random123 kat_vectors)
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
       ((0xffffffff,) * 4, (0xffffffff,) * 2,
        (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


@pytest.mark.parametrize("ctr,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_matches_known_answers(ctr, key, want):
    got = trandom.philox4x32([torch.tensor([c]) for c in ctr],
                             torch.tensor(key[0]), torch.tensor(key[1]))
    assert [int(g) for g in got] == list(want)


def test_uniform_is_the_words_of_its_counters():
    """Element i is word i % 4 of the block at counter (i // 4, 0,
    stream lo, stream hi), as ``(w >> 8) * 2**-24``: exact, in [0, 1)."""
    words = torch.tensor([0x243f6a88, 0x85a308d3])
    stream = (0x03707344 << 32) | 0x13198a2e
    u = trandom.philox_uniform_plain(words, stream, (7,))
    block = [int(w) for w in trandom.philox4x32(
        [torch.tensor([1]), torch.tensor([0]), torch.tensor([0x13198a2e]),
         torch.tensor([0x03707344])], words[0], words[1])]
    assert [float(x) for x in u[4:]] == [(w >> 8) / 2 ** 24
                                         for w in block[:3]]
    big = Key(torch.tensor([1, 2])).uniform((64, 1000))
    scaled = big.double() * 2 ** 24
    assert torch.equal(scaled, scaled.floor())
    assert 0 <= float(big.min()) and float(big.max()) < 1
    assert abs(float(big.mean()) - 0.5) < 0.01


def test_keyed_draw_is_deterministic_and_stateless():
    state = torch.get_rng_state()
    k = Key(torch.from_numpy(key_words(0, 5, 0)), (1,))
    a, b = k.uniform((4, 33)), k.uniform((4, 33))
    assert torch.equal(a, b)
    others = [k.fold_in(0).uniform((4, 33)),
              Key(k.words, (2,)).uniform((4, 33)),
              Key(torch.from_numpy(key_words(0, 6, 0)), (1,)).uniform(
                  (4, 33))]
    assert not any(torch.equal(a, o) for o in others)
    # a draw's prefix does not depend on its length
    assert torch.equal(k.uniform((10,)), k.uniform((4, 33)).reshape(-1)[:10])
    assert torch.equal(torch.get_rng_state(), state)


def test_philox_op_passes_opcheck():
    torch.library.opcheck(trandom.PHILOX_OP,
                          (torch.tensor([5, 7]), 12, [4, 3]))
    with pytest.raises(TypeError, match="int64"):
        trandom.philox_uniform(torch.tensor([1, 2], dtype=torch.int32), 0,
                               (3,))


# -- (b) the context ------------------------------------------------------------

def test_make_key_is_explicit_and_deterministic():
    """``make_key`` derives a key per call from (seed, step, microbatch)
    and the call's index; the same entropy draws the same, any other
    entropy other draws; ``dropout_seed`` is such a key (``None`` out of
    training or at rate 0); keys pickle and compare; a context without
    entropy raises, as the JAX one."""
    def draws(rng, calls=2):
        ctx = StepContext(None, training=True, rng=rng)
        return [ctx.make_key().uniform((16,)) for _ in range(calls)]

    a, b = draws((0, 5, 0)), draws((0, 5, 0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    others = [draws(e)[0] for e in ((1, 5, 0), (0, 6, 0), (0, 5, 1))]
    assert not any(torch.equal(a[0], o) for o in others)

    ctx = StepContext(None, training=True, rng=(0, 5, 0))
    key = ctx.dropout_seed(0.1)
    assert isinstance(key, Key) and key.path == (0,)
    assert pickle.loads(pickle.dumps(key)) == key
    assert fold_in(key, 3, 1).path == (0, 3, 1)
    assert StepContext(None, training=False).dropout_seed(0.1) is None
    assert ctx.dropout_seed(0.0) is None
    given = torch.tensor([9, 10])
    assert torch.equal(StepContext(None, True, key=given).make_key().words,
                       given)
    with pytest.raises(RuntimeError, match="PRNG"):
        StepContext(None, training=False).make_key()


def test_dropout_masks_follow_the_key():
    """``dropout_keep_mask`` is the keyed uniform below ``keep_prob``; an
    int seed keys a draw too; dropout scales the kept values."""
    key = Key(torch.from_numpy(key_words(3)), (0, 1))
    keep = dropout_keep_mask((8, 64), 0.9, key, "cpu")
    assert torch.equal(keep, key.uniform((8, 64)) < 0.9)
    assert torch.equal(dropout_keep_mask((8, 64), 0.9, 3, "cpu"),
                       as_key(3, "cpu").uniform((8, 64)) < 0.9)
    x = torch.ones(8, 64)
    y = dropout(x, 0.1, key)
    assert torch.equal(y, torch.where(keep, x / 0.9, torch.zeros(())))


# -- (c) the chunk's key feed ---------------------------------------------------

def _gpt(dropout_rate=0.1, **kw):
    cfg = dataclasses.replace(CONFIGS["tiny"], dropout=dropout_rate,
                              dtype=torch.float32, **kw)
    return GPTLightningModule(cfg, dataset_size=32, batch_size=4,
                              warmup_steps=2)


def _bert():
    return BertMLMModule(dataclasses.replace(BERT_CONFIGS["tiny"],
                                             dropout=0.1),
                         batch_size=4, train_size=32, val_size=8)


def _batch(module):
    return next(iter(module.train_dataloader()))


@pytest.mark.parametrize("make", [_gpt, _bert], ids=["gpt", "bert_mlm"])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_fed_keys_equal_the_eager_step(make, accumulate):
    """Two steps fed the key words a graphed chunk feeds equal two eager
    steps bit for bit: losses, parameters, optimizer moments."""
    runs = []
    for feed in (False, True):
        module = make()
        tx = module.configure_optimizers()
        module.setup_model("cpu")
        state = build_init_fn(module, tx)(torch.Generator().manual_seed(0))
        step = build_train_step(module, tx, accumulate)
        batch = _batch(module)
        losses = []
        for _ in range(2):
            keys = (torch.from_numpy(step.key_words(state)[0]) if feed
                    else None)
            state, m = step(state, batch, None, keys)
            losses.append(m["loss"])
        runs.append((losses, {k: v.clone() for k, v in
                              module.model.state_dict().items()},
                     tx, state))
    (l0, p0, _, s0), (l1, p1, _, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert step.key_words(s0, 3).shape == (3, accumulate, 2)


class _Record(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        loss = outputs["loss"]
        self.losses.extend(np.atleast_1d(np.asarray(loss, np.float32)))


@pytest.mark.parametrize("make", [_gpt, _bert], ids=["gpt", "bert_mlm"])
def test_chunked_fit_equals_eager_fit(make, tmp_path):
    """A k=4 fit (on the CPU a chunk is k eager steps; on the card one
    graph replay) equals the k=1 fit bit for bit: every loss, parameter
    and optimizer-state tensor."""
    out = []
    for k in (1, 4):
        rec = _Record()
        module = make()
        trainer = Trainer(max_steps=8, steps_per_execution=k, device="cpu",
                          enable_checkpointing=False, logger=False,
                          num_sanity_val_steps=0, limit_val_batches=0,
                          callbacks=[rec], seed=3,
                          default_root_dir=str(tmp_path))
        trainer.fit(module)
        assert trainer.global_step == 8
        out.append((rec.losses, module.model.state_dict(),
                    trainer.state.opt_state.state_dict()))
    (l1, p1, o1), (l4, p4, o4) = out
    assert len(l1) == len(l4) == 8 and l1 == l4
    assert all(torch.equal(p1[k], p4[k]) for k in p1)
    flat1, flat4 = (torch.utils._pytree.tree_leaves(o) for o in (o1, o4))
    assert len(flat1) == len(flat4)
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(flat1, flat4))


def test_chunk_runner_feeds_each_steps_key_words():
    """The rows a chunk feeds are, step by step, the words the eager
    step's context makes from the host entropy (seed, step, microbatch,
    rank)."""
    module = _gpt()
    tx = module.configure_optimizers()
    module.setup_model("cpu")
    state = build_init_fn(module, tx)(torch.Generator().manual_seed(7))
    state.step = 5
    step = build_train_step(module, tx, 2, rank=1)
    rows = step.key_words(state, 4)
    assert rows.shape == (4, 2, 2)
    for ahead in range(4):
        for i in range(2):
            assert np.array_equal(rows[ahead, i],
                                  key_words(7, 5 + ahead, i, 1))
    ctx = StepContext(module, True, rng=(7, 8, 1, 1))
    assert np.array_equal(ctx.make_key().words.numpy(), rows[3, 1])
    # distinct entropy tuples give distinct words, a length prefix apart
    words = {tuple(key_words(*e)) for e in ((7,), (7, 0), (7, 0, 0),
                                            (0, 7), (7, 1))}
    assert len(words) == 5


# -- (d) remat redraws the same masks -------------------------------------------

@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_recompute_draws_the_same_masks(policy):
    """With dropout 0.1, each block recomputed under the policy draws its
    masks again from the same keys: the loss and every gradient equal
    the run without remat, bit for bit."""
    toks = np.random.default_rng(4).integers(0, 512, (2, 17))
    batch = (torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]))
    out = []
    for remat in (False, True):
        module = _gpt(remat=remat, remat_policy=policy)
        module.setup_model("cpu")
        module.model.init_weights(torch.Generator().manual_seed(0))
        named = dict(module.model.named_parameters())
        loss = module.training_step(StepContext(module, True, rng=(0, 1, 0)),
                                    batch)
        out.append((loss, torch.autograd.grad(loss, list(named.values()))))
        assert module.model.remat_policy == (policy if remat else "off")
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))

"""PyTorch/CUDA port, the comm plane's collective record
(comm/audit.py) and its checkpoints, against the facts the JAX package
pins over its compiled programs (``tests/test_collective_audit.py:117-
356``) and its checkpoint tests (``tests/test_comm.py:521-580``,
``tests/test_sharded_checkpoint.py:226-300``).

Each audit fit is one step of a tiny GPT over ``RayPlugin`` /
``RayShardedPlugin`` gloo workers, with every rank recording that
step's collectives (``comm.audit.recording``):

- DDP all-reduces its gradients in fp32 and gathers nothing; ZeRO-1
  reduce-scatters and all-gathers; the gradient all-reduces ride f32;
- int8 DDP moves s8 all-to-all and all-gather rows and >= 3.5x fewer
  bytes than the fp32 step; int8 ZeRO-1's gradient phase >= 3.5x fewer
  than its fp32 reduce-scatter, its param gather unchanged;
- the hierarchical (2 x 2) programs' compressed bytes across pairs are
  at most half the flat int8 path's, nothing compressed rides inside a
  pair and the in-pair phases are f32; fp8 rides one byte (u8), int4
  at most 1 / 1.6 of int8's compressed bytes; ``param_gather="int8"``
  gathers s8;
- the off policy records the very collectives of no policy;
- every compressed step's recorded bytes equal ``GradSync``'s model
  exactly (the gradient sync and the param gather by tag).

The checkpoints: the plain checkpoint holds every rank's residual as
``[W, ...]`` and a resume takes each rank's row (under another codec
too; at another world the rows' mean); the sharded one re-buckets it
N -> M by mean-broadcast, drops it going to one rank, starts from zeros
coming from one, and records the comm world in its meta (the port's
counterparts of R2's ``test_commstate_reshard_*`` and
``test_sharded_meta_records_comm_world``).

Workers unpickle this module's callbacks by import path, so it imports
no JAX at its top.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (BoringModel, Callback, CommPolicy,
                                     GPTLightningModule, RayPlugin,
                                     RayShardedPlugin, Trainer, session)
from ray_lightning_tpu_torch.comm import audit
from ray_lightning_tpu_torch.models.gpt import GPTConfig

RUN_TIMEOUT_S = 120
TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")
INT8 = CommPolicy("int8", axes=("data",))
QDT = ("s8", "u8")

#: items the workers relayed, appended on the driver
RELAYED: list = []


def _record(rank, item):
    RELAYED.append((rank, item))


def _relay(trainer, item):
    session.put_queue(functools.partial(_record, trainer.global_rank, item))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RecordStep(Callback):
    """Records the first step's collectives on each rank and relays them
    with what the comm plane's model says that step records."""

    needs_batch = False

    def on_train_batch_start(self, trainer, module, batch, i):
        if trainer.global_step == 0:
            self._window = audit.recording()
            self._log = self._window.__enter__()

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        if getattr(self, "_window", None) is None:
            return
        self._window.__exit__(None, None, None)
        self._window = None
        sync, model = trainer._grad_sync, None
        if sync is not None:
            if sync.zero1:
                model = trainer._tx.tx.comm_wire_bytes()
            else:
                numels = [p.numel() for p in module.model.parameters()]
                model = {"grad_sync": sum(
                    sync.step_wire_bytes(numels).values())}
        _relay(trainer, {"records": [
            (r.op, r.dtype, r.nbytes, r.group, r.tag)
            for r in self._log.records], "model": model})


def _gpt():
    return GPTLightningModule(GPTConfig(**TINY), lr=3e-3, warmup_steps=2,
                              batch_size=2, dataset_size=32)


def _plugin(world, zero1):
    cls = RayShardedPlugin if zero1 else RayPlugin
    return cls(num_workers=world, platform="cpu", timeout_s=RUN_TIMEOUT_S)


#: name -> (world, zero1, policy)
AUDIT_FITS = {
    "ddp": (2, False, None),
    "ddp_off": (2, False, CommPolicy()),
    "zero1": (2, True, None),
    "ddp_int8": (2, False, INT8),
    "zero1_int8": (2, True, INT8),
    "ddp_fp8": (2, False, CommPolicy("fp8", axes=("data",))),
    "ddp_int4": (2, False, CommPolicy("int4", axes=("data",))),
    "ddp_int8_w4": (4, False, INT8),
    "ddp_hier": (4, False, CommPolicy("int8", axes=("data",),
                                      hierarchy=2)),
    "zero1_int8_w4": (4, True, INT8),
    "zero1_hier": (4, True, CommPolicy("int8", axes=("data",),
                                       hierarchy=2)),
    "zero1_pg": (2, True, CommPolicy("int8", axes=("data",),
                                     param_gather="int8")),
    "zero1_gbkt": (2, True, CommPolicy("int8", axes=("data",),
                                       param_gather="bf16",
                                       gather_bucket_bytes=16 << 10)),
    "ddp_bkt": (2, False, CommPolicy("int8", axes=("data",),
                                     bucket_bytes=64 << 10)),
}


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Each audit fit's relayed records, per rank (fits made on first
    use)."""
    cache = {}
    tmp = tmp_path_factory.mktemp("audit")

    def get(name):
        if name not in cache:
            world, zero1, pol = AUDIT_FITS[name]
            RELAYED.clear()
            Trainer(plugins=[_plugin(world, zero1)], max_steps=1,
                    max_epochs=1, limit_val_batches=0,
                    num_sanity_val_steps=0, enable_checkpointing=False,
                    logger=False, seed=0, callbacks=[RecordStep()],
                    default_root_dir=str(tmp / name),
                    comm_policy=pol).fit(_gpt())
            cache[name] = dict(RELAYED)
            RELAYED.clear()
            assert set(cache[name]) == set(range(world))
        return cache[name]
    return get


def _recs(rank_items, rank=0):
    return [audit.CollectiveRecord(*r) for r in rank_items[rank]["records"]]


def _count(recs, op):
    return sum(r.op == op for r in recs)


def test_ddp_allreduces_grads_and_never_gathers_params(logs):
    recs = _recs(logs("ddp"))
    assert any(r.op == "all-reduce" and r.tag == "ddp" for r in recs)
    assert _count(recs, "all-gather") == 0
    assert _count(recs, "reduce-scatter") == 0


def test_zero1_shards_update_and_gathers_params(logs):
    recs = _recs(logs("zero1"))
    assert any(r.op == "reduce-scatter" and r.tag == "zero1" for r in recs)
    assert any(r.op == "all-gather" and r.tag == "zero1" for r in recs)


@pytest.mark.parametrize("name", ["ddp", "zero1"])
def test_grad_allreduce_rides_f32(name, logs):
    for rank in (0, 1):
        types = {r.dtype for r in _recs(logs(name), rank)
                 if r.op in ("all-reduce", "reduce-scatter")}
        assert types == {"f32"}, types


def test_compressed_ddp_reduction_bytes(logs):
    fp = audit.collective_wire_bytes(_recs(logs("ddp")))
    q = audit.collective_wire_bytes(_recs(logs("ddp_int8")))
    assert ("all-to-all", "s8") in q and ("all-gather", "s8") in q, q
    # only the metrics' scalar all-reduce stays fp32
    assert q.get(("all-reduce", "f32"), 0) < 1024
    ratio = sum(fp.values()) / sum(q.values())
    assert ratio >= 3.5, (ratio, fp, q)


def test_compressed_zero1_grad_phase_bytes(logs):
    """The gradient phase >= 3.5x under its fp32 reduce-scatter; the
    updated-param gather (``param_gather="none"``) is the same."""
    fp, q = _recs(logs("zero1")), _recs(logs("zero1_int8"))
    grad_fp = audit.total_wire_bytes(fp, ops=("reduce-scatter",
                                              "all-reduce"), tags=("zero1",))
    grad_q = audit.total_wire_bytes(q, tags=("grad_sync",))
    assert grad_fp / grad_q >= 3.5, (grad_fp, grad_q)
    gather = [audit.total_wire_bytes(x, ops=("all-gather",),
                                     tags=("zero1",)) for x in (fp, q)]
    assert gather[0] == gather[1] > 0


@pytest.mark.parametrize("name", ["ddp", "zero1"])
def test_hierarchical_dcn_bytes_vs_flat_int8(name, logs):
    """W=4 as pairs: the compressed bytes across pairs at most half the
    flat path's, whose groups all span pairs."""
    for rank in range(4):
        flat = audit.wire_bytes_by_link(_recs(logs(f"{name}_int8_w4"), rank),
                                        2, dtypes=QDT)
        hier = audit.wire_bytes_by_link(_recs(logs(f"{name}_hier"), rank),
                                        2, dtypes=QDT)
        assert flat["dcn"] > 0 and hier["dcn"] > 0, (flat, hier)
        assert flat["ici"] == 0 and hier["ici"] == 0, (flat, hier)
        assert 2 * hier["dcn"] <= flat["dcn"], (hier, flat)


def test_hierarchical_ici_phases_stay_fp32(logs):
    recs = _recs(logs("ddp_hier"))
    f32 = audit.wire_bytes_by_link(recs, 2, dtypes=("f32",),
                                   ops=("all-to-all", "all-gather"))
    assert f32["ici"] > 0, f32          # the slow tier's f32 is scales
    assert audit.wire_bytes_by_link(recs, 2, dtypes=QDT)["ici"] == 0


def test_fp8_rides_one_byte_wire(logs):
    wire = audit.collective_wire_bytes(_recs(logs("ddp_fp8")))
    assert ("all-to-all", "u8") in wire and ("all-gather", "u8") in wire
    assert not any(dt == "f16" for _op, dt in wire), wire


def test_int4_halves_the_payload(logs):
    b8 = audit.total_wire_bytes(_recs(logs("ddp_int8")), dtypes=QDT)
    b4 = audit.total_wire_bytes(_recs(logs("ddp_int4")), dtypes=QDT)
    assert b4 * 1.6 <= b8, (b4, b8)


def test_comm_policy_off_records_the_same_collectives(logs):
    """The resolved-but-off policy issues the step's collectives of no
    policy, one for one (the port's ``test_comm_policy_off_is_bit_
    identical``; the fits' bits: tests/test_torch_comm.py)."""
    for rank in (0, 1):
        assert logs("ddp_off")[rank]["records"] \
            == logs("ddp")[rank]["records"]
        assert logs("ddp_off")[rank]["model"] is None


def test_zero1_param_gather_compresses(logs):
    fp = audit.collective_wire_bytes(_recs(logs("zero1")))
    q = audit.collective_wire_bytes(_recs(logs("zero1_pg")))
    assert all(dt != "s8" for _op, dt in fp), fp
    assert ("all-gather", "s8") in q
    pg = audit.collective_wire_bytes(
        [r for r in _recs(logs("zero1_pg")) if r.tag == "param_gather"])
    assert pg.get(("all-gather", "f32"), 0) < pg[("all-gather", "s8")]


@pytest.mark.parametrize("name", ["ddp_int8", "ddp_fp8", "ddp_int4",
                                  "ddp_hier", "ddp_bkt", "zero1_int8",
                                  "zero1_hier", "zero1_pg", "zero1_gbkt"])
def test_recorded_bytes_equal_the_model(name, logs):
    """Every rank's recorded bytes, by tag, equal ``GradSync``'s model of
    the step (``step_wire_bytes``; ZeRO-1's ``comm_wire_bytes``)."""
    for rank, item in logs(name).items():
        recs = _recs(logs(name), rank)
        for tag, want in item["model"].items():
            assert audit.total_wire_bytes(recs, tags=(tag,)) == want, (
                name, rank, tag)


def test_audit_functions_equal_jax():
    """``crosses_dcn``, ``declared_dcn_bytes``, ``bytes_to_seconds`` and
    ``collective_kind`` over HLO-style names answer as JAX's; the
    profiler spellings classify; ``event_link`` reads c10d's ranks."""
    from ray_lightning_tpu.comm import audit as ja
    for groups, ici in (([[0, 1], [2, 3]], 2), ([[0, 2]], 2), (None, 4),
                        ([[0, 1, 2, 3]], 4), ([[0, 1, 2, 3]], 2)):
        assert audit.crosses_dcn(groups, ici) == ja.crosses_dcn(groups, ici)
    d = {"grad_all_reduce_dcn": 10, "grad_all_reduce_ici": 7, "x": 3}
    for multi in (True, False):
        assert audit.declared_dcn_bytes(d, multi) \
            == ja.declared_dcn_bytes(d, multi)
        flat = {"grad_all_reduce": 11}
        assert audit.declared_dcn_bytes(flat, multi) \
            == ja.declared_dcn_bytes(flat, multi)
    assert audit.bytes_to_seconds(d, 50.0) == ja.bytes_to_seconds(d, 50.0)
    for name in ("all-reduce.3", "fusion.all-gather.1", "reduce-scatter",
                 "all-to-all.7", "collective-permute-start", "flash_fwd",
                 "dot.12"):
        assert audit.collective_kind(name) == ja.collective_kind(name)
    assert audit.collective_kind(
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "all-reduce"
    assert audit.collective_kind("ncclKernel_AllGather_RING") \
        == "all-gather"
    assert audit.collective_kind("nccl:reduce_scatter") == "reduce-scatter"
    assert audit.collective_kind("gloo:all_to_all") == "all-to-all"
    assert audit.collective_kind("ncclDevKernel_SendRecv") \
        == "collective-permute"
    assert audit.collective_kind("philox_uniform") is None
    assert audit.collective_kind("aten::mm") is None
    assert audit.event_link({"Process Group Ranks": "[0, 1]"}, 2,
                            True) == "ici"
    assert audit.event_link({"Process Group Ranks": "[0, 2]"}, 2,
                            False) == "dcn"
    assert audit.event_link({}, 2, True) == "dcn"
    assert audit.event_link({}, 2, False) == "ici"
    assert audit.NVLINK4_GBPS == 450.0 and audit.NIC_GBPS == 50.0


# -- checkpoints ---------------------------------------------------------------

class Snapshot(Callback):
    """Relays each rank's residual and inner optimizer state at the fit's
    start (restored) and end; saves a plain or a sharded checkpoint at
    the end when given a path."""

    def __init__(self, plain=None, sharded=None):
        self.plain, self.sharded = plain, sharded

    def _state(self, trainer, module):
        opt = trainer.state.opt_state
        inner = opt.inner if hasattr(opt, "residual") else opt
        return {"comm": hasattr(opt, "residual"),
                "residual": {k: v.clone() for k, v in
                             getattr(opt, "residual", {}).items()},
                "inner": _cloned(inner.state_dict()),
                "params": _cloned(dict(trainer._full_state(module.model))),
                "step": trainer.global_step}

    def on_fit_start(self, trainer, module):
        _relay(trainer, {"start": self._state(trainer, module)})

    def on_fit_end(self, trainer, module):
        _relay(trainer, {"end": self._state(trainer, module)})
        if self.plain:
            trainer.save_checkpoint(self.plain)
        if self.sharded:
            trainer.save_sharded_checkpoint(self.sharded)
            trainer.wait_for_checkpoints()


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


def _ckpt_fit(tmp_path, tag, world, pol, steps, ckpt=None, **snap):
    RELAYED.clear()
    trainer = Trainer(plugins=[_plugin(world, False)], max_steps=steps,
                      max_epochs=100, limit_val_batches=0,
                      num_sanity_val_steps=0, enable_checkpointing=False,
                      logger=False, seed=0, callbacks=[Snapshot(**snap)],
                      default_root_dir=str(tmp_path / tag),
                      comm_policy=pol)
    trainer.fit(BoringModel(lr=0.05, batch_size=8 // world), ckpt_path=ckpt)
    out = {}
    for rank, item in RELAYED:
        out.setdefault(rank, {}).update(item)
    RELAYED.clear()
    assert set(out) == set(range(world))
    return out


def _same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_checkpoint_roundtrip_carries_residual(tmp_path):
    """The plain checkpoint holds ``[W, *shape]`` (row r rank r's
    residual); a resume restores each rank's row, the inner state
    whole, and continues."""
    path = str(tmp_path / "ck.pt")
    saved = _ckpt_fit(tmp_path, "save", 2, INT8, 4, plain=path)
    ck = Trainer.load_checkpoint_dict(path)
    res = ck["state"]["opt_state"]["residual"]
    for r in (0, 1):
        end = saved[r]["end"]
        assert end["comm"]
        for k, v in end["residual"].items():
            assert res[k].shape == (2,) + tuple(v.shape)
            assert torch.equal(res[k][r], v) and v.abs().max() > 0
    resumed = _ckpt_fit(tmp_path, "resume", 2, INT8, 8, ckpt=path)
    for r in (0, 1):
        start = resumed[r]["start"]
        _same_tree(start["residual"], saved[r]["end"]["residual"])
        _same_tree(start["inner"], saved[r]["end"]["inner"])
        _same_tree(start["params"], saved[r]["end"]["params"])
        assert resumed[r]["end"]["step"] == 8


def test_checkpoint_roundtrip_across_codec_change(tmp_path):
    """An int8 save resumes under fp8 carrying each rank's residual (it
    is codec-agnostic pending correction), and at W=4 under a 2 x 2
    hierarchy with the saved rows' mean on every rank; an off resume
    drops it, and a save without the plane resumes into it from zero."""
    path = str(tmp_path / "ck.pt")
    saved = _ckpt_fit(tmp_path, "save", 2, INT8, 4, plain=path)
    fp8 = _ckpt_fit(tmp_path, "fp8", 2, CommPolicy("fp8", axes=("data",)),
                    4, ckpt=path)
    for r in (0, 1):
        _same_tree(fp8[r]["start"]["residual"],
                   saved[r]["end"]["residual"])
    hier = _ckpt_fit(tmp_path, "hier", 4, CommPolicy(
        "int8", axes=("data",), hierarchy=2), 4, ckpt=path)
    for r in range(4):
        for k, v in hier[r]["start"]["residual"].items():
            mean = (saved[0]["end"]["residual"][k]
                    + saved[1]["end"]["residual"][k]) / 2
            assert torch.equal(v, torch.stack(
                [saved[0]["end"]["residual"][k],
                 saved[1]["end"]["residual"][k]]).mean(0)), k
            torch.testing.assert_close(v, mean)
    off = _ckpt_fit(tmp_path, "off", 2, None, 4, ckpt=path)
    for r in (0, 1):
        assert not off[r]["start"]["comm"]
        _same_tree(off[r]["start"]["inner"], saved[r]["end"]["inner"])
    path2 = str(tmp_path / "plain.pt")
    _ckpt_fit(tmp_path, "plain", 2, None, 4, plain=path2)
    on = _ckpt_fit(tmp_path, "on", 2, INT8, 4, ckpt=path2)
    for r in (0, 1):
        assert on[r]["start"]["comm"]
        assert all((v == 0).all() for v in
                   on[r]["start"]["residual"].values())


def _sharded_save(tmp_path, world, pol):
    ckdir = str(tmp_path / f"ck{world}")
    saved = _ckpt_fit(tmp_path, f"save{world}", world, pol, 4,
                      sharded=ckdir)
    return ckdir, saved


def test_commstate_reshard_2_to_4_rebuckets_residual(tmp_path):
    """N -> M: the inner state restores exactly; each of the 4 ranks
    holds the mean of the 2 saved rows (exact in the injected sum
    ``(1 / W) sum_i r_i``)."""
    ckdir, saved = _sharded_save(tmp_path, 2, INT8)
    got = _ckpt_fit(tmp_path, "to4", 4, INT8, 4, ckpt=ckdir)
    rows = {k: torch.stack([saved[r]["end"]["residual"][k]
                            for r in (0, 1)])
            for k in saved[0]["end"]["residual"]}
    assert any(v.abs().max() > 0 for v in rows.values())
    for r in range(4):
        assert got[r]["start"]["comm"] and got[r]["end"]["step"] == 4
        for k, v in got[r]["start"]["residual"].items():
            assert torch.equal(v, rows[k].mean(0)), k
        _same_tree(got[r]["start"]["inner"], saved[0]["end"]["inner"])
        _same_tree(got[r]["start"]["params"], saved[0]["end"]["params"])


def test_commstate_reshard_2_to_1_drops_residual(tmp_path):
    ckdir, saved = _sharded_save(tmp_path, 2, INT8)
    got = _ckpt_fit(tmp_path, "to1", 1, INT8, 4, ckpt=ckdir)
    assert not got[0]["start"]["comm"]
    _same_tree(got[0]["start"]["inner"], saved[0]["end"]["inner"])
    _same_tree(got[0]["start"]["params"], saved[0]["end"]["params"])


def test_commstate_reshard_1_to_2_keeps_zero_residual(tmp_path):
    ckdir, saved = _sharded_save(tmp_path, 1, INT8)
    assert not saved[0]["end"]["comm"]          # one rank: inert
    got = _ckpt_fit(tmp_path, "to2", 2, INT8, 4, ckpt=ckdir)
    for r in (0, 1):
        assert got[r]["start"]["comm"]
        assert all((v == 0).all()
                   for v in got[r]["start"]["residual"].values())
        _same_tree(got[r]["start"]["inner"], saved[0]["end"]["inner"])


def test_commstate_reshard_2_to_2_keeps_each_row(tmp_path):
    ckdir, saved = _sharded_save(tmp_path, 2, INT8)
    got = _ckpt_fit(tmp_path, "to2", 2, INT8, 4, ckpt=ckdir)
    for r in (0, 1):
        _same_tree(got[r]["start"]["residual"],
                   saved[r]["end"]["residual"])


def test_sharded_meta_records_comm_world(tmp_path):
    ckdir, _ = _sharded_save(tmp_path, 2, INT8)
    with open(os.path.join(ckdir, "4", "meta.json")) as f:
        assert json.load(f)["comm_world"] == 2
    plain, _ = _sharded_save(tmp_path / "p", 2, None)
    with open(os.path.join(plain, "4", "meta.json")) as f:
        assert "comm_world" not in json.load(f)

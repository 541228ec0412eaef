"""Weight bridge: the JAX package's flax param trees -> this package's
``state_dict`` objects.

``flax_to_torch(params)`` takes a GPT or BERT param tree (nested dicts
of numpy arrays, e.g. ``jax.device_get`` of a JAX engine's params) and
maps it by path:

- GPT: ``h{i}/attn/qkv|proj``, ``h{i}/mlp/fc|out``: ``kernel [in, out]``
  transposes to ``Linear.weight [out, in]``, ``bias`` is copied (the qkv
  column order stays ``jnp.split(qkv, 3, -1)``'s q|k|v);
  ``h{i}/ln1|ln2``, ``ln_f``: ``scale`` -> ``weight``, ``bias``;
  ``wte/embedding`` -> ``wte.weight`` (the tied embedding), ``wpe`` as
  is;
- BERT: the same under ``encoder/`` (-> ``encoder.``), with the
  layer's ``fc|out`` directly under ``h{i}`` (no ``mlp/``), and the
  heads ``mlm_head``, ``pooler``, ``classifier`` as linear layers;
- the test-fixture models (models/boring.py): ``Dense_{i}`` as linear
  layers of the same names.

An unknown path raises.  Dtypes are kept: a bf16 array becomes a bf16
tensor.  Nothing here imports JAX; the tree only has to hold numpy
arrays.

``flax_opt_state_to_torch(opt_state)`` maps the JAX optimizer state
(``FP32MasterState(inner=adamw state, master=tree)``, or the bare adamw
state of fp32-resident params, with a schedule or a constant rate) onto
the port's (ops/optim.py) by the same path map: a test can start both
packages mid-schedule.  Gradient trees have the param tree's paths and
convert with ``flax_to_torch``.

``jax_checkpoint_to_torch(ckpt)`` carries a whole JAX ``Trainer``
checkpoint across: it takes the dict flax's ``msgpack_restore`` makes of
the file (numpy leaves; the caller decodes it, since the port reads no
msgpack) and returns the port's checkpoint dict (core/trainer.py), which
``Trainer.save_checkpoint``'s format holds and ``ckpt_path=`` resumes.
"""

from __future__ import annotations

import collections
import re
from typing import Mapping

import numpy as np
import torch


def to_tensor(a) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a CPU tensor of
    the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _flatten(tree: Mapping, prefix: str = "") -> "dict[str, object]":
    out = {}
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            out.update(_flatten(sub, path + "/"))
        else:
            out[path] = sub
    return out


_LINEAR = re.compile(r"^(?:(encoder)/h(\d+)/(attn/qkv|attn/proj|fc|out)"
                     r"|h(\d+)/(attn/qkv|attn/proj|mlp/fc|mlp/out)"
                     r"|(mlm_head|pooler|classifier|Dense_\d+))"
                     r"/(kernel|bias)$")
_NORM = re.compile(r"^(?:(encoder)/)?(?:h(\d+)/)?(ln1|ln2|ln_f)/"
                   r"(scale|bias)$")
_EMBED = re.compile(r"^(?:(encoder)/)?(wte/embedding|wpe)$")


def _name(prefix, layer, mod) -> str:
    """The torch module path of a flax path's parts."""
    parts = [p for p in (prefix, layer and f"h.{layer}") if p]
    return ".".join(parts + [mod.replace("/", ".")])


def flax_to_torch(params: Mapping) -> "dict[str, torch.Tensor]":
    """A flax GPT or BERT param tree as the port's model's state_dict
    (models/gpt.py ``GPT``, models/bert.py ``BertForMaskedLM`` /
    ``BertClassifier``).  A ``{"params": tree}`` wrapper is accepted; an
    unknown path raises."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    state = {}
    for path, arr in _flatten(params).items():
        t = to_tensor(arr)
        if m := _EMBED.match(path):
            prefix, leaf = m.groups()
            state[_name(prefix, None,
                        leaf.replace("/embedding", ".weight"))] = t
        elif m := _LINEAR.match(path):
            enc, enc_layer, enc_mod, layer, mod, head, leaf = m.groups()
            name = (_name(enc, enc_layer, enc_mod) if enc
                    else _name(None, layer, mod) if mod else head)
            if leaf == "kernel":
                state[f"{name}.weight"] = t.t().contiguous()
            else:
                state[f"{name}.bias"] = t
        elif m := _NORM.match(path):
            prefix, layer, mod, leaf = m.groups()
            name = _name(prefix, layer, mod)
            state[f"{name}.{'weight' if leaf == 'scale' else 'bias'}"] = t
        else:
            raise KeyError(f"no mapping for flax param {path!r}")
    return state


def flax_opt_state_to_torch(opt_state):
    """The JAX ``optax.adamw`` state, optionally inside
    ``FP32MasterState(inner, master)``, as the port's ``AdamWState`` /
    ``FP32MasterState``.  Over a schedule the state is
    ``(ScaleByAdamState(count, mu, nu), EmptyState(),
    ScaleByScheduleState(count))``; at a constant rate (``adamw(float)``)
    its last entry is an ``EmptyState`` and the count is the adam
    state's alone.  Read by attribute, so numpy leaves (e.g.
    ``jax.device_get`` of the state) are all it needs."""
    from ray_lightning_tpu_torch.ops.optim import AdamWState, FP32MasterState
    master = getattr(opt_state, "master", None)
    inner = opt_state.inner if master is not None else opt_state
    adam, schedule = inner[0], inner[-1]
    count = int(np.asarray(adam.count))
    if "count" in getattr(schedule, "_fields", ()) \
            and int(np.asarray(schedule.count)) != count:
        raise ValueError("adam and schedule counts differ: not an "
                         "optax.adamw state")
    state = AdamWState(count=count, mu=flax_to_torch(adam.mu),
                       nu=flax_to_torch(adam.nu))
    if master is None:
        return state
    return FP32MasterState(inner=state, master=flax_to_torch(master))


def _fields(node: Mapping):
    """A NamedTuple state in flax's dict form as an object read by
    attribute again (its param-tree leaves stay dicts)."""
    return collections.namedtuple("State", list(node))(**node)


def _opt_state_dict(node: Mapping) -> dict:
    """An optax state in flax's dict form (a tuple as ``{"0": .., "1":
    ..}``, a NamedTuple as a dict of its fields) as the ``state_dict`` of
    the port's counterpart (ops/optim.py):

    - ``FP32MasterState``: ``{"inner", "master"}``;
    - ``adamw`` / ``adam``: ``(ScaleByAdamState, ...)``, through
      :func:`flax_opt_state_to_torch`;
    - ``sgd``: a tuple of empty states -> ``{}`` (``SGD``'s
      ``EmptyState``);
    - ``chain(clip_by_global_norm, tx)``: ``(EmptyState, tx)`` -> the
      port's ``chain`` state, ``{"0": {}, "1": <tx>}``."""
    if set(node) == {"inner", "master"}:
        return {"inner": _opt_state_dict(node["inner"]),
                "master": flax_to_torch(node["master"])}
    entries = [node[str(i)] for i in range(len(node))]
    if list(node) != [str(i) for i in range(len(node))] or not entries:
        raise KeyError(f"no optax state has the entries {sorted(node)}")
    if "mu" in entries[0]:
        return flax_opt_state_to_torch(
            tuple(_fields(e) for e in entries)).state_dict()
    if not any(entries):
        return {}
    if len(entries) == 2 and not entries[0]:
        return {"0": {}, "1": _opt_state_dict(entries[1])}
    raise KeyError(f"no optax state has the entries {entries}")


def jax_checkpoint_to_torch(ckpt: Mapping) -> dict:
    """A JAX ``Trainer`` checkpoint (the msgpack-restored dict) as the
    port's: the same top-level entries, ``state.params`` through
    :func:`flax_to_torch`, ``state.opt_state`` as the ``state_dict`` of
    the port's optimizer state (:func:`_opt_state_dict`; with
    ``gradient_clip_val`` the ``(EmptyState, inner)`` of ``optax.chain(
    clip_by_global_norm, tx)`` on both sides).  ``state.rng``, the JAX
    key, becomes the port's step seed, its words read as one integer:
    the steps draw other numbers than JAX's in either case.  The model's
    non-parameter collections must be empty (the port's models hold
    none)."""
    st = ckpt["state"]
    if _flatten(st.get("model_state") or {}):
        raise ValueError("the JAX checkpoint holds model state the port's "
                         "models do not have")
    seed = 0
    for word in np.asarray(st["rng"]).reshape(-1):
        seed = (seed << 32) | (int(word) & 0xFFFFFFFF)
    return {
        **{k: v for k, v in ckpt.items() if k != "state"},
        "state": {"step": int(np.asarray(st["step"])),
                  "params": flax_to_torch(st["params"]),
                  "model_state": {},
                  "opt_state": _opt_state_dict(st["opt_state"]),
                  "rng": seed % (1 << 64)},
    }


__all__ = ["flax_opt_state_to_torch", "flax_to_torch",
           "jax_checkpoint_to_torch", "to_tensor"]

"""Weight bridge: the JAX package's flax param trees -> this package's
``state_dict`` objects.

``flax_to_torch(params)`` takes a GPT, BERT or ResNet param tree
(nested dicts of numpy arrays, e.g. ``jax.device_get`` of a JAX
engine's params), or a variables dict that adds ResNet's
``batch_stats``, and maps it by path:

- GPT: ``h{i}/moe/router|w1|w2`` (a routed block, ops/moe.py) in the
  flax layout, as they are; ``h{i}/attn/qkv|proj``, ``h{i}/mlp/fc|out``:
  ``kernel [in, out]``
  transposes to ``Linear.weight [out, in]``, ``bias`` is copied (the qkv
  column order stays ``jnp.split(qkv, 3, -1)``'s q|k|v);
  ``h{i}/ln1|ln2``, ``ln_f``: ``scale`` -> ``weight``, ``bias``;
  ``wte/embedding`` -> ``wte.weight`` (the tied embedding), ``wpe`` as
  is;
- BERT: the same under ``encoder/`` (-> ``encoder.``), with the
  layer's ``fc|out`` directly under ``h{i}`` (no ``mlp/``), and the
  heads ``mlm_head``, ``pooler``, ``classifier`` as linear layers;
- ResNet (models/resnet.py): ``stem``, ``s{stage}b{block}/Conv_{i}``
  and ``.../proj`` conv ``kernel`` HWIO -> ``weight`` OIHW; ``stem_bn``,
  ``.../BatchNorm_{i}``, ``.../proj_bn``: ``scale`` -> ``weight``,
  ``bias``, and from ``batch_stats`` ``mean`` -> ``running_mean``,
  ``var`` -> ``running_var``; ``head`` a linear layer;
- the test-fixture models (models/boring.py): ``Dense_{i}`` as linear
  layers of the same names;
- the pipelined GPT (models/pipeline_gpt.py): the raw ``wte`` and
  ``wpe``, ``ln_f``, and the layer-stacked ``blocks/...`` (a leading
  ``n_layer`` dim) as the stacked ``blocks.`` tensors, each layer's
  kernel transposed; :func:`unstack_blocks` / :func:`stack_blocks` move
  them to and from per-layer ``h.{i}.`` names, the GPT's.

An unknown path raises.  ``torch_to_flax(state, template)`` is the way
back, onto a flax tree's paths and dtypes.  Dtypes are kept: a bf16 array becomes a bf16
tensor.  Nothing here imports JAX; the tree only has to hold numpy
arrays.

``flax_opt_state_to_torch(opt_state)`` maps the JAX optimizer state
(``FP32MasterState(inner=adamw state, master=tree)``, the bare adamw
state of fp32-resident params, with a schedule or a constant rate, and
ResNet's ``chain(add_decayed_weights, sgd(momentum))`` with its
``TraceState``) onto the port's (ops/optim.py) by the same path map: a
test can start both packages mid-schedule.  Gradient trees have the param tree's paths and
convert with ``flax_to_torch``.

``flax_to_shards(params, layout)`` gives one rank's blocks of a flax tree
under a sharded strategy's layout (parallel/layout.py ``ShardLayout``:
FSDP, SPMD), and ``shards_to_flax(state, layout, template)`` the way
back, gathering every rank's blocks (collective): both packages start
from the same weights whatever the mesh.

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
                     r"|(mlm_head|pooler|classifier|head|Dense_\d+))"
                     r"/(kernel|bias)$")
_NORM = re.compile(r"^(?:(encoder)/)?(?:h(\d+)/)?(ln1|ln2|ln_f)/"
                   r"(scale|bias)$")
_EMBED = re.compile(r"^(?:(encoder)/)?(wte/embedding|wpe|wte)$")
#: the pipelined GPT's layer-stacked blocks (leading dim: the layers)
_STACKED = re.compile(r"^blocks/(?:(attn/qkv|attn/proj|mlp/fc|mlp/out)"
                      r"/(kernel|bias)|(ln1|ln2)/(scale|bias))$")
_STACKED_PERM = (0, 2, 1)
_MOE = re.compile(r"^h(\d+)/moe/(router|w1|w2)$")
#: ResNet (models/resnet.py): the stem, each block's convs and its
#: projection, and their BatchNorms (a block's own tree has no prefix)
_CONV = re.compile(r"^(stem|(?:s\d+b\d+/)?(?:Conv_\d+|proj))/kernel$")
_BN = re.compile(r"^(stem_bn|(?:s\d+b\d+/)?(?:BatchNorm_\d+|proj_bn))/"
                 r"(scale|bias|mean|var)$")
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
#: flax layout -> torch layout: a Dense kernel [in, out] -> [out, in], a
#: conv kernel HWIO -> OIHW
_DENSE_PERM = (1, 0)
_CONV_PERM = (3, 2, 0, 1)


def _name(prefix, layer, mod) -> str:
    """The torch module path of a flax path's parts."""
    parts = [p for p in (prefix, layer and f"h.{layer}") if p]
    return ".".join(parts + [mod.replace("/", ".")])


def _torch_key(path: str) -> "tuple[str, tuple | None]":
    """A flax path's torch name, and the permutation that takes the flax
    layout to the torch one (``None``: the same layout)."""
    if m := _EMBED.match(path):
        prefix, leaf = m.groups()
        return _name(prefix, None,
                     leaf.replace("/embedding", ".weight")), None
    if m := _STACKED.match(path):
        lin, lin_leaf, norm, norm_leaf = m.groups()
        mod, leaf = (lin, lin_leaf) if lin else (norm, norm_leaf)
        name = "blocks." + mod.replace("/", ".")
        if leaf == "kernel":
            return f"{name}.weight", _STACKED_PERM
        return f"{name}.{'weight' if leaf == 'scale' else 'bias'}", None
    if m := _MOE.match(path):
        return f"h.{m.group(1)}.moe.{m.group(2)}", None
    if m := _LINEAR.match(path):
        enc, enc_layer, enc_mod, layer, mod, head, leaf = m.groups()
        name = (_name(enc, enc_layer, enc_mod) if enc
                else _name(None, layer, mod) if mod else head)
        if leaf == "kernel":
            return f"{name}.weight", _DENSE_PERM
        return f"{name}.bias", None
    if m := _NORM.match(path):
        prefix, layer, mod, leaf = m.groups()
        name = _name(prefix, layer, mod)
        return f"{name}.{'weight' if leaf == 'scale' else 'bias'}", None
    if m := _CONV.match(path):
        return f"{m.group(1).replace('/', '.')}.weight", _CONV_PERM
    if m := _BN.match(path):
        mod, leaf = m.groups()
        return f"{mod.replace('/', '.')}.{_BN_LEAF[leaf]}", None
    raise KeyError(f"no mapping for flax param {path!r}")


#: the flax leaf names a torch leaf may come from, tried in order
_FLAX_LEAVES = {"weight": ("kernel", "scale", "embedding"), "bias": ("bias",),
                "running_mean": ("mean",), "running_var": ("var",)}


def flax_path(name: str) -> "tuple[str, tuple | None]":
    """The inverse of the path map: a torch parameter name's flax path
    and the permutation that takes the flax layout to the torch one
    (``None``: the same layout), so one rule set of the JAX package
    (``gpt_partition_rules``: ``r"attn/qkv/kernel"``) answers for the
    port's ``h.0.attn.qkv.weight``.  A name outside the map (a model
    the JAX package lacks) keeps its parts, joined by ``/``."""
    parts = name.split(".")
    out, i = [], 0
    while i < len(parts):
        if parts[i] == "h" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"h{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    *mods, leaf = out
    for cand in [f"{'/'.join(mods)}/{f}" for f in _FLAX_LEAVES.get(leaf, ())] \
            + ["/".join(out)]:
        try:
            got, perm = _torch_key(cand.lstrip("/"))
        except KeyError:
            continue
        if got == name:
            return cand.lstrip("/"), perm
    return "/".join(out), None


def _convert(tree: Mapping, stats: bool) -> "dict[str, torch.Tensor]":
    state = {}
    for path, arr in _flatten(tree).items():
        if stats != bool(re.search(r"/(mean|var)$", path)):
            raise KeyError(f"no mapping for flax "
                           f"{'batch_stats' if stats else 'param'} {path!r}")
        name, perm = _torch_key(path)
        t = to_tensor(arr)
        state[name] = t.permute(perm).contiguous() if perm else t
    return state


def flax_to_torch(params: Mapping) -> "dict[str, torch.Tensor]":
    """A flax GPT, BERT or ResNet param tree as the port's model's
    state_dict (models/gpt.py ``GPT``, models/bert.py ``BertForMaskedLM``
    / ``BertClassifier``, models/resnet.py ``ResNet``).  A variables
    dict ``{"params": tree}`` is accepted, and with it a
    ``"batch_stats"`` collection (ResNet's BatchNorm ``mean`` and
    ``var``, as ``running_mean`` and ``running_var``); an unknown path
    raises."""
    stats = {}
    if "params" in params and isinstance(params["params"], Mapping):
        stats = params.get("batch_stats") or {}
        params = params["params"]
    return {**_convert(params, stats=False), **_convert(stats, stats=True)}


def torch_to_flax(state: Mapping, template: Mapping) -> dict:
    """The inverse of :func:`flax_to_torch` for one tree: the tensors of
    ``state`` (a state_dict, or a gradient or optimizer tree keyed like
    one) laid out as the flax tree ``template`` (params, or a
    ``batch_stats`` tree), each leaf a numpy array in the template
    leaf's dtype."""
    def leaf(path: str, like):
        name, perm = _torch_key(path)
        t = state[name].detach().cpu()
        if perm:
            t = t.permute(tuple(np.argsort(perm)))
        return np.asarray(t.float().numpy(), np.float32).astype(
            np.asarray(like).dtype)

    def walk(node: Mapping, prefix: str) -> dict:
        return {k: (walk(v, f"{prefix}{k}/") if isinstance(v, Mapping)
                    else leaf(f"{prefix}{k}", v))
                for k, v in node.items()}

    return walk(template, "")


def flax_to_shards(params: Mapping, layout) -> "dict[str, torch.Tensor]":
    """:func:`flax_to_torch` of ``params``, each parameter cut to this
    rank's block under ``layout`` (a ``parallel.layout.ShardLayout``)."""
    return {k: (layout.local_of(k, v) if k in layout.params else v)
            for k, v in flax_to_torch(params).items()}


def shards_to_flax(state: Mapping, layout, template: Mapping) -> dict:
    """The inverse of :func:`flax_to_shards`: every rank's blocks of
    ``state`` gathered whole (collective: each rank calls it) and laid
    out as the flax tree ``template``."""
    from ray_lightning_tpu_torch.parallel.gather import fetch_tree
    return torch_to_flax(fetch_tree(dict(state), layout), template)


def unstack_blocks(state: Mapping) -> "dict[str, torch.Tensor]":
    """A pipelined GPT's state (its stacked ``blocks.`` tensors) with
    per-layer names: ``blocks.X`` [L, ...] becomes ``h.{i}.X`` for each
    layer ``i``, the GPT's names (models/gpt.py); the rest as it is."""
    out = {}
    for k, v in state.items():
        if k.startswith("blocks."):
            for i, layer in enumerate(v.unbind(0)):
                out[f"h.{i}.{k[len('blocks.'):]}"] = layer
        else:
            out[k] = v
    return out


def stack_blocks(state: Mapping) -> "dict[str, torch.Tensor]":
    """The inverse of :func:`unstack_blocks`: per-layer ``h.{i}.X``
    tensors stacked in layer order as ``blocks.X``."""
    layers: "dict[str, dict[int, torch.Tensor]]" = {}
    out = {}
    for k, v in state.items():
        if m := re.match(r"^h\.(\d+)\.(.+)$", k):
            layers.setdefault(m.group(2), {})[int(m.group(1))] = v
        else:
            out[k] = v
    for rest, by in layers.items():
        if sorted(by) != list(range(len(by))):
            raise KeyError(f"h.{{i}}.{rest}: layers {sorted(by)}")
        out[f"blocks.{rest}"] = torch.stack([by[i] for i in range(len(by))])
    return out


def _empty(node) -> bool:
    """An ``optax.EmptyState`` (a NamedTuple without fields)."""
    return hasattr(node, "_fields") and not node._fields


def flax_opt_state_to_torch(opt_state):
    """An optax state, read by attribute (numpy leaves, e.g.
    ``jax.device_get`` of the state, are all it needs), as the port's
    (ops/optim.py):

    - ``FP32MasterState(inner, master)`` -> ``FP32MasterState``;
    - ``optax.adamw``: over a schedule ``(ScaleByAdamState(count, mu,
      nu), EmptyState(), ScaleByScheduleState(count))``, at a constant
      rate its last entry an ``EmptyState`` and the count the adam
      state's alone -> ``AdamWState``;
    - ``optax.sgd`` with momentum: ``(TraceState(trace), EmptyState())``
      -> ``TraceState``; without: empty states -> ``EmptyState``;
    - ``optax.chain(clip_by_global_norm | add_decayed_weights, tx)``:
      ``(EmptyState(), tx)`` -> ``ChainState((EmptyState(), tx))``."""
    from ray_lightning_tpu_torch.ops.optim import (AdamWState, ChainState,
                                                   EmptyState,
                                                   FP32MasterState,
                                                   TraceState)
    master = getattr(opt_state, "master", None)
    if master is not None:
        return FP32MasterState(inner=flax_opt_state_to_torch(
            opt_state.inner), master=flax_to_torch(master))
    first = opt_state[0]
    if hasattr(first, "mu"):
        count = int(np.asarray(first.count))
        schedule = opt_state[-1]
        if "count" in getattr(schedule, "_fields", ()) \
                and int(np.asarray(schedule.count)) != count:
            raise ValueError("adam and schedule counts differ: not an "
                             "optax.adamw state")
        return AdamWState(count=count, mu=flax_to_torch(first.mu),
                          nu=flax_to_torch(first.nu))
    if hasattr(first, "trace"):
        return TraceState(flax_to_torch(first.trace))
    if all(_empty(e) for e in opt_state):
        return EmptyState()
    if len(opt_state) == 2 and _empty(first):
        return ChainState((EmptyState(),
                           flax_opt_state_to_torch(opt_state[1])))
    raise KeyError(f"no optax state has the entries {opt_state}")


#: the fields of the optax states :func:`flax_opt_state_to_torch` reads
_STATE_FIELDS = {"count", "mu", "nu", "trace", "inner", "master"}
_EMPTY = collections.namedtuple("EmptyState", [])()


def _as_state(node: Mapping):
    """An optax state in flax's dict form (a tuple as ``{"0": .., "1":
    ..}``, a NamedTuple as a dict of its fields, an ``EmptyState`` as
    ``{}``) as objects read by attribute again; the param-tree leaves of
    a state stay dicts."""
    if not node:
        return _EMPTY
    keys = list(node)
    if keys == [str(i) for i in range(len(keys))]:
        return tuple(_as_state(node[k]) for k in keys)
    if set(keys) <= _STATE_FIELDS:
        return collections.namedtuple("State", keys)(**{
            k: _as_state(v) if k == "inner" else v
            for k, v in node.items()})
    raise KeyError(f"no optax state has the entries {sorted(node)}")


def comm_state_to_torch(residual, inner_state_dict: dict) -> dict:
    """A JAX ``CommState``'s parts as the ``state_dict`` of the port's
    ``comm.CommState``: ``residual``, the ``[W, *param]`` leaves of every
    rank's error-feedback residual (a param tree of numpy arrays, or
    empty with error feedback off), each row through
    :func:`flax_to_torch` and stacked back to ``[W, *torch shape]``;
    ``inner_state_dict`` the wrapped optimizer's, already converted.
    Each rank's ``load_state_dict`` takes its row, so both packages can
    start from the same residual."""
    leaves = _flatten(residual) if residual else {}
    if not leaves:
        return {"residual": {}, "inner": inner_state_dict}
    world = int(np.asarray(next(iter(leaves.values()))).shape[0])

    def row(tree, w):
        if isinstance(tree, Mapping):
            return {k: row(v, w) for k, v in tree.items()}
        return np.asarray(tree)[w]

    rows = [flax_to_torch(row(residual, w)) for w in range(world)]
    return {"residual": {k: torch.stack([r[k] for r in rows])
                         for k in rows[0]},
            "inner": inner_state_dict}


def _opt_state_dict(node: Mapping) -> dict:
    """An optax state in flax's dict form as the ``state_dict`` of the
    port's counterpart (:func:`flax_opt_state_to_torch`; a comm plane's
    ``CommState`` through :func:`comm_state_to_torch`)."""
    if isinstance(node, Mapping) and set(node) == {"residual", "inner"}:
        return comm_state_to_torch(node["residual"],
                                   _opt_state_dict(node["inner"]))
    return flax_opt_state_to_torch(_as_state(node)).state_dict()


def jax_checkpoint_to_torch(ckpt: Mapping) -> dict:
    """A JAX ``Trainer`` checkpoint (the msgpack-restored dict) as the
    port's: the same top-level entries, ``state.params`` through
    :func:`flax_to_torch`, ``state.opt_state`` as the ``state_dict`` of
    the port's optimizer state (:func:`_opt_state_dict`; with
    ``gradient_clip_val`` the ``(EmptyState, inner)`` of ``optax.chain(
    clip_by_global_norm, tx)`` on both sides).  ``state.rng``, the JAX
    key, becomes the port's step seed, its words read as one integer:
    the steps draw other numbers than JAX's in either case.  The model's
    non-parameter state may hold ``batch_stats`` alone (ResNet's), which
    becomes the running buffers of the port's ``model_state``."""
    st = ckpt["state"]
    model_state = dict(st.get("model_state") or {})
    stats = model_state.pop("batch_stats", {})
    if _flatten(model_state):
        raise ValueError(f"the JAX checkpoint holds model state the "
                         f"port's models do not have: {sorted(model_state)}")
    seed = 0
    for word in np.asarray(st["rng"]).reshape(-1):
        seed = (seed << 32) | (int(word) & 0xFFFFFFFF)
    return {
        **{k: v for k, v in ckpt.items() if k != "state"},
        "state": {"step": int(np.asarray(st["step"])),
                  "params": flax_to_torch(st["params"]),
                  "model_state": _convert(stats, stats=True),
                  "opt_state": _opt_state_dict(st["opt_state"]),
                  "rng": seed % (1 << 64)},
    }


__all__ = ["comm_state_to_torch", "flax_opt_state_to_torch", "flax_path",
           "flax_to_shards",
           "flax_to_torch", "jax_checkpoint_to_torch", "shards_to_flax",
           "stack_blocks", "to_tensor", "torch_to_flax", "unstack_blocks"]

"""Weight bridge: the JAX package's flax param tree -> this package's
``state_dict``.

``flax_to_torch(params)`` takes the GPT param tree (nested dicts of
numpy arrays, e.g. ``jax.device_get`` of a JAX engine's params) and maps
it by path:

- ``h{i}/attn/qkv|proj``, ``h{i}/mlp/fc|out``: ``kernel [in, out]``
  transposes to ``Linear.weight [out, in]``, ``bias`` is copied (the qkv
  column order stays ``jnp.split(qkv, 3, -1)``'s q|k|v);
- ``h{i}/ln1|ln2``, ``ln_f``: ``scale`` -> ``weight``, ``bias``;
- ``wte/embedding`` -> ``wte.weight`` (the tied embedding), ``wpe`` as is.

Dtypes are kept: a bf16 array becomes a bf16 tensor.  Nothing here
imports JAX; the tree only has to hold numpy arrays.

``flax_opt_state_to_torch(opt_state)`` maps the JAX optimizer state
(``FP32MasterState(inner=adamw state, master=tree)``, or the bare adamw
state of fp32-resident params) onto the port's (ops/optim.py) by the
same path map: a test can start both packages mid-schedule.  Gradient
trees have the param tree's paths and convert with ``flax_to_torch``.
"""

from __future__ import annotations

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


_LINEAR = re.compile(r"^h(\d+)/(attn/qkv|attn/proj|mlp/fc|mlp/out)/"
                     r"(kernel|bias)$")
_NORM = re.compile(r"^(?:h(\d+)/)?(ln1|ln2|ln_f)/(scale|bias)$")


def flax_to_torch(params: Mapping) -> "dict[str, torch.Tensor]":
    """The flax GPT param tree as a ``models.gpt.GPT`` state_dict.  A
    ``{"params": tree}`` wrapper is accepted; an unknown path raises."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    state = {}
    for path, arr in _flatten(params).items():
        t = to_tensor(arr)
        if path == "wte/embedding":
            state["wte.weight"] = t
        elif path == "wpe":
            state["wpe"] = t
        elif m := _LINEAR.match(path):
            layer, mod, leaf = m.groups()
            name = f"h.{layer}.{mod.replace('/', '.')}"
            if leaf == "kernel":
                state[f"{name}.weight"] = t.t().contiguous()
            else:
                state[f"{name}.bias"] = t
        elif m := _NORM.match(path):
            layer, mod, leaf = m.groups()
            name = mod if layer is None else f"h.{layer}.{mod}"
            state[f"{name}.{'weight' if leaf == 'scale' else 'bias'}"] = t
        else:
            raise KeyError(f"no mapping for flax param {path!r}")
    return state


def flax_opt_state_to_torch(opt_state):
    """The JAX ``optax.adamw`` state (``(ScaleByAdamState(count, mu, nu),
    EmptyState(), ScaleByScheduleState(count))``), optionally inside
    ``FP32MasterState(inner, master)``, as the port's ``AdamWState`` /
    ``FP32MasterState``.  Read by attribute, so numpy leaves (e.g.
    ``jax.device_get`` of the state) are all it needs."""
    from ray_lightning_tpu_torch.ops.optim import AdamWState, FP32MasterState
    master = getattr(opt_state, "master", None)
    inner = opt_state.inner if master is not None else opt_state
    adam, schedule = inner[0], inner[-1]
    count = int(np.asarray(adam.count))
    if int(np.asarray(schedule.count)) != count:
        raise ValueError("adam and schedule counts differ: not an "
                         "optax.adamw state")
    state = AdamWState(count=count, mu=flax_to_torch(adam.mu),
                       nu=flax_to_torch(adam.nu))
    if master is None:
        return state
    return FP32MasterState(inner=state, master=flax_to_torch(master))


__all__ = ["flax_opt_state_to_torch", "flax_to_torch", "to_tensor"]

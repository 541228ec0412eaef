"""Whole tensors of a sharded state, for checkpoints and the trained
weights the driver gets back.

Counterpart of ``ray_lightning_tpu/parallel/gather.py`` ``fetch_tree``:
there arrays spanning processes are replicated by one compiled identity
program before the host reads them.  Here each per-parameter tensor of
the tree (a model's ``state_dict``, an optimizer's, keyed by parameter
name) is all-gathered along the axes its layout splits it over
(parallel/layout.py ``ShardLayout.full_tensor``): every rank must call
it together, and every rank gets the whole tensors.
"""

from __future__ import annotations

from typing import Any

import torch


def fetch_tree(tree: Any, layout=None, host: bool = True) -> Any:
    """``tree`` (nested dicts) with every tensor whole: a tensor keyed by
    a parameter name of ``layout`` gathered from every rank's block
    (collective), every other one as it is; on the host when ``host``,
    else where it lives.  Numbers pass through."""
    def leaf(name, value):
        if not isinstance(value, torch.Tensor):
            return value
        value = value.detach()
        if layout is not None and name in layout.params:
            value = layout.full_tensor(name, value)
        return value.cpu() if host else value

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(tree) if isinstance(tree, dict) else tree


__all__ = ["fetch_tree"]

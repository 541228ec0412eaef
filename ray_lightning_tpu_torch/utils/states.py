"""State streams: in-band serialization of state dicts.

Counterpart of ``ray_lightning_tpu/utils/states.py`` (``to_state_stream``
/ ``load_state_stream``, there flax's msgpack codec).  Here the stream is
``torch.save`` into a ``BytesIO``, read back with ``torch.load(...,
weights_only=True)``: the stream holds plain containers only (dicts,
lists, tensors, ints, floats, strings, ``None``), so loading runs no
pickled code.  Tensors keep their dtypes; ``map_location`` places them
(the reference's ``util.py:78-90`` rehydration).
"""

from __future__ import annotations

import io
from typing import Any

import torch


def to_state_stream(state: Any) -> bytes:
    """Serialize a nested dict/list of tensors and Python scalars."""
    buf = io.BytesIO()
    torch.save(state, buf)
    return buf.getvalue()


def load_state_stream(stream: bytes,
                      map_location: "str | torch.device | None" = None
                      ) -> Any:
    """Deserialize a state stream, its tensors on ``map_location`` (as
    saved when ``None``) in their saved dtypes."""
    return torch.load(io.BytesIO(stream), map_location=map_location,
                      weights_only=True)


__all__ = ["load_state_stream", "to_state_stream"]

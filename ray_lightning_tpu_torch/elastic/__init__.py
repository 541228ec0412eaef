"""Elastic plane: async snapshots, fault injection, parity redundancy and
the shrink-to-continue driver (the counterpart of
``ray_lightning_tpu/elastic/``).

- ``snapshot.py``: async sharded snapshots off the critical path, with
  bounded backpressure and failure hardening;
- ``reshard.py``: a snapshot of N ranks restored onto M (the residual
  re-bucket and the shape check of the trainer's sharded restore);
- ``redundancy.py``: XOR parity of the ZeRO-1 optimizer shards over the
  worker-to-worker peer channel, escrowed in each worker, so a single
  rank's loss is rebuilt in the fleet and training continues from the
  current step with no snapshot read;
- ``driver.py``: the recovery router (parity for one dead rank, else
  snapshot replay, else scratch), reported as ``recovery``;
- ``faults.py``: deterministic fault injection (kill, wedge, slow,
  snapkill, peerdrop; ``RLT_FAULT`` takes a semicolon-separated list);
- ``config.py``: ``Trainer(elastic=...)`` and the ``RLT_ELASTIC*``
  knobs.

Only the light pieces import here (config and faults): the trainer
touches this package on every stage.
"""

from ray_lightning_tpu_torch.elastic.config import ElasticConfig  # noqa: F401
from ray_lightning_tpu_torch.elastic.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    maybe_injector_from_env,
    parse_fault,
    parse_faults,
)

__all__ = [
    "ElasticConfig",
    "FaultInjector",
    "FaultSpec",
    "maybe_injector_from_env",
    "parse_fault",
    "parse_faults",
]

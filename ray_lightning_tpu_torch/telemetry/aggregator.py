"""The telemetry aggregator's failure exception, alone.

Counterpart of ``WorkerHeartbeatTimeout`` in
``ray_lightning_tpu/telemetry/aggregator.py``, which the elastic driver
(elastic/driver.py) classifies as a restartable death.  The aggregator
itself, the heartbeat sender and its watchdog are not ported yet
(ROADMAP.md queue 1 item 13), so nothing in the port raises this today:
a ``wedge`` fault (elastic/faults.py) is caught by the plugin's
``timeout_s`` instead, and the driver's classifier reads a wedged or
dead rank from the failure's message (``elastic/driver.py``
``_DEATH_MARKERS``) and from the strict liveness probe.
"""

from __future__ import annotations


class WorkerHeartbeatTimeout(RuntimeError):
    """A rank's heartbeats have been silent past the hard timeout."""


__all__ = ["WorkerHeartbeatTimeout"]

"""Driver-side plumbing (the reference's ``ray_lightning/util.py``).

Counterpart of ``ray_lightning_tpu/util.py`` without the telemetry
plane: :func:`process_results` waits on the workers' futures while
draining the worker-to-driver queue and calling the relayed callables in
the driver process ("relay the side effect, not the call").  A run's
data-check validator (core/datacheck.py, ``RLT_DATA_CHECK=1``) takes
the fingerprint items and raises in the poll loop on a divergence.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

from ray_lightning_tpu_torch.cluster.backend import ClusterBackend, Future
from ray_lightning_tpu_torch.cluster.local import RemoteActorError
from ray_lightning_tpu_torch.utils.states import (load_state_stream,
                                                  to_state_stream)


#: seconds the other workers get to finish or fail after one fails
FAILURE_GRACE_S = 5.0


def _handle_queue_item(item: Any, validator=None) -> None:
    """Run one queue item on the driver: items are ``(rank, payload)``;
    a data-check item goes to ``validator``, a callable payload is
    called here, anything else is dropped."""
    payload = item[1] if isinstance(item, tuple) and len(item) == 2 \
        else item
    if validator is not None and validator.maybe_ingest(payload):
        return
    if callable(payload):
        payload()


def _drain(backend: ClusterBackend, actors: set, validator=None) -> bool:
    drained = False
    while (item := backend.queue_get_nowait(actors)) is not None:
        drained = True
        _handle_queue_item(item, validator)
    if validator is not None:
        validator.verify()
    return drained


def process_results(futures: Sequence[Future], backend: ClusterBackend,
                    timeout: Optional[float] = None,
                    poll_interval: float = 0.02,
                    validator=None) -> list:
    """The futures' results, relaying queue items as they arrive.

    A worker's error fails the whole run (``ray.get`` semantics): the
    others get ``FAILURE_GRACE_S`` more seconds to finish or fail, since
    a rank that fails takes its peers' collectives down with it and the
    first error to arrive need not be the cause; then every error raises
    together, worker by worker.  A wait past ``timeout`` seconds raises
    ``TimeoutError`` naming the workers still running.  Only the queue
    items of the futures' actors are relayed here, so runs on other
    threads of this driver (Tune trials) keep theirs; an exception a
    relayed callable raises (a Tune scheduler's stop or exploit) leaves
    at once, the workers still running: their owner kills them.  So
    does ``validator``'s (core/datacheck.py ``DataCheckValidator``)
    divergence, checked after each drain."""
    pending = list(futures)
    actors = {f.actor_id for f in pending}
    deadline = None if timeout is None else time.monotonic() + timeout
    failed_at = None
    while not all(f.done() for f in pending):
        drained = _drain(backend, actors, validator)
        now = time.monotonic()
        if failed_at is None and any(f.error() for f in pending):
            failed_at = now
        if failed_at is not None and now - failed_at > FAILURE_GRACE_S:
            break
        if deadline is not None and now > deadline:
            waiting = [i for i, f in enumerate(pending) if not f.done()]
            raise TimeoutError(
                f"workers {waiting} of {len(pending)} still running after "
                f"{timeout:.0f} s")
        if not drained:
            # wakes as soon as the first call still running returns
            next(f for f in pending if not f.done()).wait(poll_interval)
    # items sent just before the workers finished
    _drain(backend, actors, validator)
    errors = [(i, f.error()) for i, f in enumerate(pending) if f.error()]
    if len(errors) == 1:
        raise errors[0][1]
    if errors:
        running = [i for i, f in enumerate(pending) if not f.done()]
        raise RemoteActorError("\n\n".join(
            [f"worker {i} failed: {e}" for i, e in errors]
            + [f"workers {running} were still running"] * bool(running)))
    return [f.result() for f in pending]


__all__ = ["load_state_stream", "process_results", "to_state_stream"]

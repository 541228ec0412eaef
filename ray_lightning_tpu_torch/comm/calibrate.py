"""Measured link bandwidths for the byte -> seconds model.

Counterpart of ``ray_lightning_tpu/comm/calibrate.py``.  The audit's
link constants (comm/audit.py: NVLink 4 and the NIC, published
figures) are right in order of magnitude and wrong for any particular
machine.  :func:`calibrated_gbps` replaces them with measured values:
an fp32 ``all_reduce`` of :data:`PAYLOAD_ELEMENTS` elements, timed over
:data:`REPEATS` calls after one untimed call, once within a host's
ranks (``"ici"``: NVLink between the cards of one host, or whatever
the group's backend rides) and once across hosts when there are more
than one (``"dcn"``).  On the card under NCCL the time comes from CUDA
events; over gloo (the CPU, or every rank on card 0) from the host
clock on host tensors.  The bytes are the audit's ring charge, ``2 x 4
x PAYLOAD_ELEMENTS`` a call.

The result is cached as JSON keyed by the topology fingerprint (card
name, cards a host, hosts, torch and NCCL versions), so a later run on
the same machine reads the file.  Cache location (first match wins):
the ``cache_dir`` argument, ``$RLT_CALIBRATE_DIR``, ``$RLT_TELEMETRY_DIR``,
else ``~/.cache/ray_lightning_tpu_torch``.

Never raises into its caller: a failed measurement keeps the constants
and records why (``ici_error`` / ``dcn_error``); ``measured`` lists the
links that were timed.  Under a process group every function here that
measures or fingerprints is collective (every rank calls it).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ray_lightning_tpu_torch.comm.audit import (INTER_HOST_GBPS,
                                                INTRA_HOST_GBPS)

_log = logging.getLogger(__name__)

#: payload of the timed all-reduce (fp32 elements, 8 MiB)
PAYLOAD_ELEMENTS = 2 * 1024 * 1024
REPEATS = 5

ENV_DIR = "RLT_CALIBRATE_DIR"


def _cache_dir(cache_dir: Optional[str]) -> str:
    return (cache_dir or os.environ.get(ENV_DIR)
            or os.environ.get("RLT_TELEMETRY_DIR")
            or os.path.join(os.path.expanduser("~"), ".cache",
                            "ray_lightning_tpu_torch"))


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def topology_fingerprint(hosts: "int | None" = None,
                         local: "int | None" = None) -> str:
    """``<card>-c<cards a host>-h<hosts>-torch<v>-nccl<v>`` (spaces in
    the card's name as ``_``); ``hosts`` / ``local`` default to the
    group's (comm/policy.py ``host_layout``, a collective)."""
    if hosts is None or local is None:
        from ray_lightning_tpu_torch.comm.policy import host_layout
        hosts, local = host_layout()
    card = (torch.cuda.get_device_name(torch.cuda.current_device())
            if torch.cuda.is_available() else "cpu")
    nccl = "none"
    if torch.cuda.is_available():
        try:
            v = torch.cuda.nccl.version()
            nccl = ".".join(map(str, v)) if isinstance(v, tuple) else str(v)
        except Exception:   # noqa: BLE001 - a build without NCCL
            pass
    return (f"{card.replace(' ', '_')}-c{local}-h{hosts}-"
            f"torch{torch.__version__.split('+')[0]}-nccl{nccl}")


def cache_path(cache_dir: Optional[str] = None,
               fingerprint: "str | None" = None) -> str:
    return os.path.join(_cache_dir(cache_dir),
                        f"bandwidth_{fingerprint or topology_fingerprint()}"
                        f".json")


def _time_allreduce(group, device: torch.device) -> "tuple[float, int]":
    """(seconds an all-reduce, the audit's wire bytes) over ``group``:
    CUDA events under NCCL, the host clock over gloo."""
    gloo = dist.get_backend(group) == "gloo"
    dev = torch.device("cpu") if gloo or device.type != "cuda" else device
    x = torch.ones(PAYLOAD_ELEMENTS, dtype=torch.float32, device=dev)
    dist.all_reduce(x, group=group)                 # set-up outside
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEATS):
            dist.all_reduce(x, group=group)
        end.record()
        end.synchronize()
        per_op = start.elapsed_time(end) / 1e3 / REPEATS
    else:
        dist.barrier(group=group)
        t0 = time.perf_counter()
        for _ in range(REPEATS):
            dist.all_reduce(x, group=group)
        per_op = (time.perf_counter() - t0) / REPEATS
    return per_op, 2 * 4 * PAYLOAD_ELEMENTS


def measure_bandwidths(device: "torch.device | str | None" = None) -> dict:
    """One measurement pass (no cache): ``{"ici_gbps", "dcn_gbps",
    "measured": [...], "fingerprint", "backend", ...}``, the links it
    could not time left at the constants with the reason."""
    from ray_lightning_tpu_torch.comm.policy import host_layout
    hosts, local = host_layout() if _active() else (1, 1)
    result = {
        "fingerprint": topology_fingerprint(hosts, local),
        "ici_gbps": INTRA_HOST_GBPS,
        "dcn_gbps": INTER_HOST_GBPS,
        "measured": [],
        "payload_bytes": 4 * PAYLOAD_ELEMENTS,
        "hosts": hosts,
        "ranks_per_host": local,
    }
    if not _active():
        result["ici_error"] = "no process group: nothing to time"
        return result
    device = torch.device(device if device is not None else (
        f"cuda:{torch.cuda.current_device()}"
        if torch.cuda.is_available() else "cpu"))
    result["backend"] = str(dist.get_backend())
    world, rank = dist.get_world_size(), dist.get_rank()
    # every host's block of consecutive ranks: one group each, made by
    # every rank in one order (new_group is collective)
    mine = None
    for h in range(world // local):
        g = dist.new_group(list(range(h * local, (h + 1) * local)))
        if h * local <= rank < (h + 1) * local:
            mine = g
    if local >= 2:
        try:
            secs, wire = _time_allreduce(mine, device)
            result["ici_gbps"] = wire / secs / 1e9
            result["ici_seconds"] = secs
            result["measured"].append("ici")
        except Exception as e:   # noqa: BLE001 - calibration never fails
            result["ici_error"] = repr(e)
    else:
        result["ici_error"] = "one rank a host: no intra-host link"
    if hosts > 1:
        try:
            secs, wire = _time_allreduce(None, device)
            result["dcn_gbps"] = wire / secs / 1e9
            result["dcn_seconds"] = secs
            result["measured"].append("dcn")
        except Exception as e:   # noqa: BLE001
            result["dcn_error"] = repr(e)
    return result


def _agree(value):
    """Rank 0's ``value`` on every rank (a collective under a group)."""
    if not _active():
        return value
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out[0]


def calibrated(cache_dir: Optional[str] = None, force: bool = False,
               device=None) -> dict:
    """The cached measurement of this topology, measuring (and writing
    the cache from rank 0) on first use; every rank gets rank 0's
    answer.  On any failure the constants, with ``error`` set."""
    path = None
    try:
        path = cache_path(cache_dir)
        data = None
        if not force:
            try:
                with open(path) as f:
                    data = json.load(f)
            except FileNotFoundError:
                pass
            except Exception as e:   # noqa: BLE001 - corrupt: remeasure
                _log.warning("bandwidth cache %s unreadable (%r); "
                             "remeasuring", path, e)
        data = _agree(data)
        if data is not None:
            return {**data, "cache": path, "from_cache": True}
        data = measure_bandwidths(device)
        if not _active() or dist.get_rank() == 0:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
        _log.info("calibrated link bandwidths %s -> %s",
                  {k: data[k] for k in ("ici_gbps", "dcn_gbps")}, path)
        return {**_agree(data), "cache": path, "from_cache": False}
    except Exception as e:   # noqa: BLE001 - constants beat a crash
        _log.warning("bandwidth calibration failed (%r); using the "
                     "audit constants", e)
        return {"ici_gbps": INTRA_HOST_GBPS, "dcn_gbps": INTER_HOST_GBPS,
                "measured": [], "error": repr(e), "cache": path}


def calibrated_gbps(cache_dir: Optional[str] = None, force: bool = False,
                    device=None) -> "tuple[float, float]":
    """``(ici_gbps, dcn_gbps)`` of :func:`calibrated` (the JAX
    function)."""
    data = calibrated(cache_dir, force, device)
    return float(data["ici_gbps"]), float(data["dcn_gbps"])


# -- live calibration ---------------------------------------------------------
#
# The JAX trainer writes a measured-vs-modeled comm correction at the end
# of an instrumented run; the port's trace anatomy that measures exposed
# comm comes with the telemetry planes (ROADMAP.md queue 1 item 13), so
# nothing in the port writes these yet: the store and its bounds are
# here for it.

#: sane bounds on the correction (outside: the sample is discarded)
LIVE_SCALE_BOUNDS = (0.1, 10.0)


def live_cache_path(cache_dir: Optional[str] = None,
                    fingerprint: "str | None" = None) -> str:
    return os.path.join(_cache_dir(cache_dir),
                        f"live_{fingerprint or topology_fingerprint()}.json")


def save_live_calibration(step_wall_s: float, exposed_comm_s: float,
                          modeled_comm_s: Optional[float],
                          cache_dir: Optional[str] = None,
                          fingerprint: "str | None" = None
                          ) -> Optional[str]:
    """Persist one run's measured / modeled comm correction, keyed by
    topology fingerprint.  The path, or ``None`` when the sample is
    unusable (no modeled comm, a ratio out of bounds, any failure)."""
    try:
        if not modeled_comm_s or float(modeled_comm_s) <= 0:
            return None
        scale = float(exposed_comm_s) / float(modeled_comm_s)
        if not (LIVE_SCALE_BOUNDS[0] <= scale <= LIVE_SCALE_BOUNDS[1]):
            _log.info("live calibration sample discarded: comm_scale "
                      "%.3f outside %s", scale, LIVE_SCALE_BOUNDS)
            return None
        fingerprint = fingerprint or topology_fingerprint()
        path = live_cache_path(cache_dir, fingerprint)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        doc = {
            "fingerprint": fingerprint,
            "comm_scale": round(scale, 4),
            "step_wall_s": round(float(step_wall_s), 6),
            "exposed_comm_s": round(float(exposed_comm_s), 6),
            "modeled_comm_s": round(float(modeled_comm_s), 6),
            "ts": time.time(),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path
    except Exception:   # noqa: BLE001 - calibration never raises
        _log.debug("live calibration write failed", exc_info=True)
        return None


def live_calibration(cache_dir: Optional[str] = None,
                     fingerprint: "str | None" = None) -> Optional[dict]:
    """The stored live correction for this topology, or ``None``."""
    try:
        with open(live_cache_path(cache_dir, fingerprint)) as f:
            doc = json.load(f)
        scale = float(doc["comm_scale"])
        if not (LIVE_SCALE_BOUNDS[0] <= scale <= LIVE_SCALE_BOUNDS[1]):
            return None
        return doc
    except Exception:   # noqa: BLE001 - missing / corrupt: no correction
        return None


__all__ = ["ENV_DIR", "LIVE_SCALE_BOUNDS", "PAYLOAD_ELEMENTS", "REPEATS",
           "cache_path", "calibrated", "calibrated_gbps",
           "live_cache_path", "live_calibration", "measure_bandwidths",
           "save_live_calibration", "topology_fingerprint"]

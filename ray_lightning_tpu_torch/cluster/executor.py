"""Generic remote executor actor (the reference's ``RayExecutor``): run
functions, set environment variables, report topology facts.

Counterpart of ``ray_lightning_tpu/cluster/executor.py``; the device
inventory is the CUDA devices this worker sees.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from ray_lightning_tpu_torch.cluster.protocol import find_free_port, node_ip


class RLTExecutor:
    """One instance per worker process."""

    def __init__(self, env: Optional[dict] = None):
        if env:
            self.set_env_vars(env)

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def set_env_var(self, key: str, value: str) -> None:
        os.environ[key] = str(value)

    def set_env_vars(self, env: dict) -> None:
        for k, v in env.items():
            self.set_env_var(k, v)

    def get_node_ip(self) -> str:
        return node_ip()

    def get_free_port(self) -> int:
        return find_free_port()

    def get_node_and_device_info(self) -> dict:
        """The node's address, this process's pid, and the CUDA devices
        it sees: their count and names (the reference's
        ``get_node_and_gpu_ids``)."""
        import torch
        n = torch.cuda.device_count()
        return {"ip": node_ip(), "pid": os.getpid(), "num_gpus": n,
                "gpu_names": [torch.cuda.get_device_name(i)
                              for i in range(n)]}


__all__ = ["RLTExecutor"]

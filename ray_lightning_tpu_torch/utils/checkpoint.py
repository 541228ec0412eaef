"""Sharded checkpoints over ``torch.distributed.checkpoint``: no gather.

Counterpart of ``ray_lightning_tpu/utils/checkpoint.py`` (orbax's
``ShardedCheckpointer``).  ``Trainer.save_checkpoint`` gathers the whole
state into one file on global zero, which funnels a sharded 1.3B state
through one process.  Here every rank writes only the blocks it owns:
each parameter and optimizer tensor is a DTensor of its storage shape
(parallel/layout.py ``ShardLayout.dtensor``) over a CPU mesh, so its
chunk carries its global offsets, and a restore into another mesh (or
one process) reads the chunks that overlap the blocks it wants.

Layout: ``<directory>/<step>/`` holds the DCP files (``.metadata``,
``__<rank>_<i>.distcp``) and ``meta.json`` (epoch, global_step,
strategy, hparams, callback states, the step count and seed).  A save
is written under ``<step>.partial`` and renamed when every rank's
files and the metadata are down, so a step directory is always whole.

A save copies the state to host memory first (the blocking part), then
writes it on one thread of this checkpointer's, behind the training
steps, its coordination on a gloo group of its own (parallel/mesh.py
``Mesh.checkpoint_mesh``): every rank submits its saves in the same
order, so the threads meet in the same collectives.  ``wait`` blocks
until they are durable.  Paths may be local or fsspec URLs
(``memory://`` in the tests; fsspec is imported only for those).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

_META = "meta.json"
_PARTIAL = ".partial"
#: files a rank writes in parallel (DCP's writer threads)
WRITE_THREADS = 4


def _remote(path: str) -> bool:
    return "://" in path


def _fs(path: str):
    import fsspec
    return fsspec.core.url_to_fs(path)


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict as ``{"a/b/c": leaf}`` (empty dicts dropped)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten_like(template: dict, flat: dict, prefix: str = "") -> dict:
    """``flat``'s leaves laid out as ``template`` (empty dicts kept)."""
    return {k: (unflatten_like(v, flat, f"{prefix}{k}/")
                if isinstance(v, dict) else flat[f"{prefix}{k}"])
            for k, v in template.items()}


def _jsonable(obj):
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    if hasattr(obj, "item"):
        return obj.item()
    return repr(obj)


class ShardedCheckpointer:
    """Per-rank, asynchronous checkpoints in a step-numbered directory
    (module docstring).  ``mesh`` (parallel/mesh.py, default the
    trainer's current one) gives the gloo group the ranks coordinate
    on; without a process group the save is one process's."""

    def __init__(self, directory: str, async_save: bool = True,
                 max_to_keep: Optional[int] = None, mesh=None):
        if not _remote(directory):
            directory = os.path.abspath(directory)
        self.directory = directory.rstrip("/")
        self.async_save = async_save
        self.max_to_keep = max_to_keep
        if mesh is None:
            from ray_lightning_tpu_torch.parallel.mesh import get_current_mesh
            mesh = get_current_mesh()
        self._mesh = mesh
        self._pool: "concurrent.futures.ThreadPoolExecutor | None" = None
        self._pending: list = []
        self._submitted: "set[int]" = set()

    # -- the group ---------------------------------------------------------

    def _distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1

    def _group(self):
        if self._mesh is None or self._mesh.world == 1:
            raise RuntimeError("a multi-rank checkpoint needs the mesh of "
                               "its ranks (parallel/mesh.py)")
        return self._mesh.checkpoint_mesh()[1]

    def _rank0(self) -> bool:
        return not self._distributed() or dist.get_rank() == 0

    def _barrier(self) -> None:
        if self._distributed():
            dist.barrier(group=self._group())

    # -- save --------------------------------------------------------------

    def save(self, step: int, state: dict, meta: Optional[dict] = None):
        """Write ``state`` (a nested dict of tensors, DTensors and
        numbers: the trainer's ``sharded_state_dict``) under ``step``.
        Tensors are copied to host memory now; with ``async_save`` the
        write runs behind this call.  A step already saved (or
        submitted) is a no-op: two cadences can land on one step."""
        step = int(step)
        if self.has(step):
            return
        self._submitted.add(step)
        flat = {k: _stage(v) for k, v in flatten(state).items()}
        meta = dict(meta or {})
        if self._distributed():
            self._group()           # made here, in the caller's order
        if not self.async_save:
            self._write(step, flat, meta)
            return
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="rlt-ckpt")
        self._pending.append(self._pool.submit(self._write, step, flat,
                                               meta))

    def has(self, step: int) -> bool:
        """Whether ``step`` is saved, or submitted by this checkpointer."""
        return int(step) in self._submitted or int(step) in self.all_steps()

    def _write(self, step: int, flat: dict, meta: dict) -> None:
        import torch.distributed.checkpoint as dcp
        tmp = f"{self.directory}/{step}{_PARTIAL}"
        final = f"{self.directory}/{step}"
        if self._rank0():
            self._makedirs(tmp)
        self._barrier()
        kw = ({"process_group": self._group()} if self._distributed()
              else {"no_dist": True})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dcp.save(flat, storage_writer=self._writer(tmp), **kw)
        if self._rank0():
            self._write_text(f"{tmp}/{_META}",
                             json.dumps(meta, default=_jsonable))
            self._rename(tmp, final)
            self._evict()
        self._barrier()

    def wait(self) -> None:
        """Block until every submitted save is durable (re-raising a
        save's failure)."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def saving_in_progress(self) -> bool:
        return any(not f.done() for f in self._pending)

    # -- restore -----------------------------------------------------------

    def all_steps(self) -> "list[int]":
        names = self._dir_entries(self.directory) or []
        return sorted(int(n) for n in names if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def saved_state_metadata(self, step: Optional[int] = None):
        """``{key: (shape, dtype)}`` of the saved tensors at ``step``
        (default: the latest), read from the DCP metadata alone; ``None``
        without a step."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        md = self._reader(f"{self.directory}/{int(step)}").read_metadata()
        out = {}
        for k, v in md.state_dict_metadata.items():
            if hasattr(v, "size"):
                out[k] = (tuple(v.size), v.properties.dtype)
        return out

    def restore(self, template: dict, step: Optional[int] = None
                ) -> "tuple[dict, dict]":
        """``(state, meta)`` at ``step`` (default: the latest): ``state``
        laid out as ``template`` (host tensors and DTensors of the blocks
        this rank wants, in the layout it wants, which may be another
        mesh's than the one that saved; numbers for the numbers),
        filled from the saved chunks."""
        import torch.distributed.checkpoint as dcp
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"No checkpoint steps under {self.directory}")
        path = f"{self.directory}/{int(step)}"
        flat = flatten(template)
        kw = ({"process_group": self._group()} if self._distributed()
              else {"no_dist": True})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dcp.load(flat, storage_reader=self._reader(path), **kw)
        meta = json.loads(self._read_text(f"{path}/{_META}"))
        return unflatten_like(template, flat), meta

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    # -- storage -----------------------------------------------------------

    def _writer(self, path: str):
        if _remote(path):
            from torch.distributed.checkpoint._fsspec_filesystem import \
                FsspecWriter
            return FsspecWriter(path)
        from torch.distributed.checkpoint import FileSystemWriter
        return FileSystemWriter(path, thread_count=WRITE_THREADS)

    def _reader(self, path: str):
        if _remote(path):
            from torch.distributed.checkpoint._fsspec_filesystem import \
                FsspecReader
            return FsspecReader(path)
        from torch.distributed.checkpoint import FileSystemReader
        return FileSystemReader(path)

    @staticmethod
    def _makedirs(path: str) -> None:
        if _remote(path):
            fs, p = _fs(path)
            fs.makedirs(p, exist_ok=True)
        else:
            os.makedirs(path, exist_ok=True)

    @staticmethod
    def _write_text(path: str, text: str) -> None:
        if _remote(path):
            fs, p = _fs(path)
            with fs.open(p, "w") as f:
                f.write(text)
        else:
            with open(path, "w") as f:
                f.write(text)

    @staticmethod
    def _read_text(path: str) -> str:
        if _remote(path):
            fs, p = _fs(path)
            with fs.open(p, "r") as f:
                return f.read()
        with open(path) as f:
            return f.read()

    @staticmethod
    def _rename(src: str, dst: str) -> None:
        if _remote(src):
            fs, s = _fs(src)
            fs.mv(s, _fs(dst)[1], recursive=True)
        else:
            os.replace(src, dst)

    def _evict(self) -> None:
        if not self.max_to_keep:
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            path = f"{self.directory}/{step}"
            if _remote(path):
                fs, p = _fs(path)
                fs.rm(p, recursive=True)
            else:
                shutil.rmtree(path, ignore_errors=True)

    # -- detection ---------------------------------------------------------

    @staticmethod
    def _dir_entries(path: str) -> "Optional[list[str]]":
        # any listing failure means "not a sharded checkpoint": remote
        # file systems raise their own exceptions
        try:
            if _remote(path):
                fs, p = _fs(path)
                if not fs.isdir(p):
                    return None
                return [os.path.basename(e.rstrip("/"))
                        for e in fs.ls(p, detail=False)]
            if os.path.isdir(path):
                return os.listdir(path)
        except Exception:
            pass
        return None

    @staticmethod
    def split_step_dir(path: str) -> "tuple[str, Optional[int]]":
        """``.../cks/42`` -> ``(.../cks, 42)``; a root -> ``(path,
        None)``."""
        base = os.path.basename(path.rstrip("/"))
        if base.isdigit():
            return path.rstrip("/")[: -len(base)].rstrip("/"), int(base)
        return path, None

    @classmethod
    def is_sharded_checkpoint(cls, path: str) -> bool:
        """True for a step-numbered root or one step inside it (vs the
        one-file checkpoint of ``Trainer.save_checkpoint``)."""
        names = cls._dir_entries(path)
        if names is None:
            return False
        _root, step = cls.split_step_dir(path)
        if step is not None:
            return any(n in (_META, ".metadata") for n in names)
        return any(n.isdigit() for n in names)


def abstract_like(tree: dict) -> dict:
    """A restore target shaped as ``tree`` (a ``sharded_state_dict``):
    empty host tensors, and DTensors of empty blocks in the same layout,
    numbers kept (the JAX ``abstract_like``: where every block lands)."""
    from torch.distributed.tensor import DTensor

    def empty(v):
        if isinstance(v, DTensor):
            return DTensor.from_local(
                torch.empty_like(v.to_local(), device="cpu"), v.device_mesh,
                v.placements, run_check=False, shape=v.shape,
                stride=v.stride())
        if isinstance(v, torch.Tensor):
            return torch.empty(v.shape, dtype=v.dtype)
        return v

    return unflatten_like(tree, {k: empty(v)
                                 for k, v in flatten(tree).items()})


def _stage(value: Any) -> Any:
    """A host copy of a leaf: a tensor's bytes now, so the training steps
    after the call cannot change what is written.  DTensors come staged
    (their blocks are host copies, ``ShardLayout.dtensor``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(value, DTensor):
        return value
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return value


__all__ = ["ShardedCheckpointer", "abstract_like", "flatten",
           "unflatten_like"]

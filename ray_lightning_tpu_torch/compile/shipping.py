"""Cache-dir shipping for workers without the driver's filesystem.

Counterpart of ``ray_lightning_tpu/compile/shipping.py``: the built-in
backend's actors share the driver's disk, so pointing them at the
driver's cache root is already sharing.  Workers on other machines get
the root packed into one blob (:func:`pack_cache_dir`) and seed their
local root from it (:func:`unpack_cache_dir`) before their first
kernel build.  Seeding is additive (an existing library is never
overwritten) and capped, newest libraries first.
"""

from __future__ import annotations

import io
import logging
import os
import tarfile
from typing import Optional

_log = logging.getLogger(__name__)

#: most packed payload broadcast to workers; newest entries win
MAX_PACK_BYTES = 256 << 20


def pack_cache_dir(root: str,
                   max_bytes: int = MAX_PACK_BYTES) -> Optional[bytes]:
    """Gzipped tar of ``root``'s files, newest first, stopping at
    ``max_bytes`` of file payload; None when the dir is missing or
    empty."""
    if not root or not os.path.isdir(root):
        return None
    entries: "list[tuple[float, str, int]]" = []
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, path, st.st_size))
    if not entries:
        return None
    entries.sort(reverse=True)          # newest first
    buf = io.BytesIO()
    packed = skipped = 0
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for _mtime, path, size in entries:
            if packed + size > max_bytes:
                skipped += 1
                continue
            packed += size
            tar.add(path, arcname=os.path.relpath(path, root))
    if skipped:
        _log.warning("compile-cache pack capped at %d bytes: %d older "
                     "entr%s not shipped", max_bytes, skipped,
                     "y" if skipped == 1 else "ies")
    return buf.getvalue()


def unpack_cache_dir(blob: bytes, root: str) -> int:
    """Seed ``root`` from a :func:`pack_cache_dir` blob, keeping existing
    entries; returns the number written."""
    os.makedirs(root, exist_ok=True)
    written = 0
    base = os.path.realpath(root) + os.sep
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            dest = os.path.realpath(os.path.join(root, member.name))
            if not dest.startswith(base):
                _log.warning("skipping cache entry with unsafe path %r",
                             member.name)
                continue
            if os.path.exists(dest):
                continue
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            src = tar.extractfile(member)
            if src is None:
                continue
            tmp = f"{dest}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(src.read())
            os.replace(tmp, dest)       # atomic: readers never see half
            written += 1
    return written


__all__ = ["MAX_PACK_BYTES", "pack_cache_dir", "unpack_cache_dir"]

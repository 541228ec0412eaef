"""Metrics logger: ``CSVLogger`` and ``resolve_logger``.

Counterpart of ``ray_lightning_tpu/utils/logger.py``: one
``<save_dir>/logs/metrics.csv``, a row per ``log_metrics`` call, the
columns the union of every call's names in the order they first appear
(``step`` first).  ``Trainer(logger=True)`` (the default) installs it
under ``default_root_dir``, ``logger=False`` disables logging, and any
object with ``log_metrics(dict, step)`` is used as it is.

The port runs one process, so a logger object is the file's one writer:
the JAX logger's run-id sidecar, which lets pickled copies of a logger
in worker processes share one file, has nothing to do here.  A new
logger truncates the file at its first row; the same logger appends
across stages.  When the columns grow, the file is rewritten under the
new header into a temporary file in the same directory that replaces
it (``os.replace``), so a reader sees the old file or the new one,
never a half-written header.
"""

from __future__ import annotations

import csv
import os
import tempfile


class CSVLogger:
    """Append-only CSV metrics log (PL's ``CSVLogger`` analog)."""

    def __init__(self, save_dir: str, name: str = "logs"):
        self.save_dir = save_dir
        self.name = name
        self._fields: "list[str]" = ["step"]
        self._started = False

    @property
    def log_dir(self) -> str:
        return os.path.join(self.save_dir, self.name)

    @property
    def path(self) -> str:
        return os.path.join(self.log_dir, "metrics.csv")

    def log_metrics(self, metrics: dict, step: int) -> None:
        row = {"step": int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        new_fields = [k for k in row if k not in self._fields]
        self._fields.extend(new_fields)
        os.makedirs(self.log_dir, exist_ok=True)
        if self._started and new_fields:
            self._rewrite_with_new_header()
        with open(self.path, "a" if self._started else "w",
                  newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fields, restval="")
            if not self._started:
                writer.writeheader()
            writer.writerow(row)
        self._started = True

    def _rewrite_with_new_header(self) -> None:
        """The file's rows under the grown header, through a temporary
        file that replaces it."""
        with open(self.path, newline="") as f:
            old_rows = list(csv.DictReader(f))
        fd, tmp = tempfile.mkstemp(dir=self.log_dir, suffix=".csv")
        try:
            with os.fdopen(fd, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fields,
                                        restval="")
                writer.writeheader()
                writer.writerows(old_rows)
            os.replace(tmp, self.path)
        except BaseException:
            os.unlink(tmp)
            raise


def resolve_logger(logger, default_root_dir: str):
    """The ``Trainer``'s ``logger=``: ``True`` -> a :class:`CSVLogger`
    under ``default_root_dir``; ``False``/``None`` -> no logging; an
    object with ``log_metrics`` -> itself."""
    if logger is True:
        return CSVLogger(default_root_dir)
    if not logger:
        return None
    if hasattr(logger, "log_metrics"):
        return logger
    raise TypeError(
        f"logger must be True/False or expose log_metrics(dict, step); "
        f"got {type(logger).__name__}")


__all__ = ["CSVLogger", "resolve_logger"]

"""Durable text writes for the port's telemetry (PyTorch port).

The one helper of ``distributed_embeddings_tpu/telemetry/export.py``
that the tracer and the flight recorder use: :func:`atomic_write_text`.
The Prometheus textfile writer, the JSONL event log and the verdict
emitter wait for the rest of the telemetry package.
"""

from __future__ import annotations

import os

__all__ = ["atomic_write_text"]


def _fsync_file(f) -> None:
  f.flush()
  os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
  # best effort, as checkpoint._fsync_dir: the entry publication matters
  # on filesystems that support it, EINVAL elsewhere
  try:
    fd = os.open(path, os.O_RDONLY)
  except OSError:
    return
  try:
    os.fsync(fd)
  except OSError:
    pass
  finally:
    os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
  """Write ``text`` to ``path`` durably: tmp file, fsync, atomic
  replace (a reader sees the old complete file or the new complete
  file, never a torn one)."""
  tmp = path + ".tmp"
  with open(tmp, "w") as f:
    f.write(text)
    _fsync_file(f)
  os.replace(tmp, path)
  _fsync_dir(os.path.dirname(os.path.abspath(path)))

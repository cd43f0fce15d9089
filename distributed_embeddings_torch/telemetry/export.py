"""Telemetry export: Prometheus textfile, rotated JSONL event log, verdicts
(PyTorch port of ``distributed_embeddings_tpu/telemetry/export.py``).

Three durable sinks over the registry/tracer state, all through the
write + flush + fsync before any rename discipline:

- :func:`write_prometheus` — the registry as a node-exporter
  textfile-collector file (atomic replace, so the scraper never reads a
  torn file); :func:`prometheus_text` renders the same text for the
  live ``/metrics`` endpoint (:mod:`.http`). Counters and gauges as
  scalars, histograms as summaries with ``quantile`` labels plus
  ``_sum``/``_count`` — character for character the JAX package's
  rendering of the same registry.
- :class:`JsonlWriter` — an append-only JSON-lines event log with size
  rotation (``events.jsonl`` -> ``.1`` -> ``.2`` ...), each line fsynced
  before :meth:`JsonlWriter.write` returns, so the last event of a
  killed process is on disk.
- :func:`emit_verdict` — the one way a tool reports its result: a
  normalized ``{"tool", "ok", "verdict"}`` record printed as JSON,
  appended to a JSONL log when configured (``path=`` or the
  ``DE_TPU_VERDICT_LOG`` environment variable, the JAX package's name,
  so both packages' tools share one log), and mapped to the exit code
  (0 iff ``ok``).

:func:`atomic_write_text` is the tracer's and the flight recorder's
durable write.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

from .registry import MetricsRegistry

__all__ = [
    "atomic_write_text",
    "write_prometheus",
    "prometheus_text",
    "JsonlWriter",
    "emit_verdict",
    "VERDICT_LOG_ENV",
]

VERDICT_LOG_ENV = "DE_TPU_VERDICT_LOG"


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


_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
  n = _PROM_NAME_RE.sub("_", name)
  if n and n[0].isdigit():
    n = "_" + n
  return n


def prometheus_text(registry: MetricsRegistry) -> str:
  """Render a registry in the Prometheus text exposition format."""
  lines = []
  for name, m in sorted(registry.metrics().items()):
    pn = _prom_name(name)
    if m.kind == "counter":
      lines.append(f"# TYPE {pn} counter")
      lines.append(f"{pn} {m.value}")
    elif m.kind == "gauge":
      lines.append(f"# TYPE {pn} gauge")
      lines.append(f"{pn} {_fmt(m.value)}")
    else:  # histogram -> summary (quantiles are what latency SLOs read)
      lines.append(f"# TYPE {pn} summary")
      for q in (0.5, 0.9, 0.99, 0.999):
        lines.append(f'{pn}{{quantile="{q}"}} '
                     f"{_fmt(m.percentile(q * 100.0))}")
      lines.append(f"{pn}_sum {_fmt(m.sum)}")
      lines.append(f"{pn}_count {m.count}")
  return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
  if v != v:  # NaN
    return "NaN"
  return repr(float(v))


def write_prometheus(registry: MetricsRegistry, path: str) -> str:
  """Atomically publish ``registry`` as a textfile-collector file."""
  atomic_write_text(path, prometheus_text(registry))
  return path


class JsonlWriter:
  """Durable append-only JSON-lines log with size rotation.

  ``write(obj)`` appends one line and fsyncs before returning; when the
  file exceeds ``max_bytes`` it rotates — ``path`` -> ``path.1`` ->
  ``path.2`` ... keeping ``keep`` rotated files (the oldest is
  deleted).  Rotation renames are preceded by an fsync of the live
  file, so a crash at any point leaves every already-written line on
  disk in some file of the set."""

  def __init__(self, path: str, max_bytes: int = 16 << 20, keep: int = 3,
               fsync: bool = True):
    if max_bytes < 1:
      raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
    if keep < 1:
      raise ValueError(f"keep must be >= 1, got {keep}")
    self.path = path
    self.max_bytes = int(max_bytes)
    self.keep = int(keep)
    self.fsync = fsync
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    self._f = open(path, "a")

  def write(self, obj: Any) -> None:
    line = json.dumps(obj, sort_keys=True)
    self._f.write(line + "\n")
    if self.fsync:
      _fsync_file(self._f)
    else:
      self._f.flush()
    if self._f.tell() >= self.max_bytes:
      self._rotate()

  def _rotate(self) -> None:
    _fsync_file(self._f)
    self._f.close()
    oldest = f"{self.path}.{self.keep}"
    if os.path.exists(oldest):
      os.remove(oldest)
    for i in range(self.keep - 1, 0, -1):
      src = f"{self.path}.{i}"
      if os.path.exists(src):
        os.replace(src, f"{self.path}.{i + 1}")
    os.replace(self.path, f"{self.path}.1")
    _fsync_dir(os.path.dirname(os.path.abspath(self.path)))
    self._f = open(self.path, "a")

  def close(self) -> None:
    if not self._f.closed:
      _fsync_file(self._f)
      self._f.close()

  def __enter__(self) -> "JsonlWriter":
    return self

  def __exit__(self, exc_type, exc, tb):
    self.close()
    return False


def emit_verdict(tool: str, result: Dict[str, Any], verbose: bool = True,
                 path: Optional[str] = None) -> int:
  """Report a tool verdict the one sanctioned way; returns the exit
  code (0 iff ``result['ok']`` is truthy).

  The normalized record is ``{"tool": <name>, "ok": <bool>,
  "verdict": <the tool's full result dict>}`` — printed as indented
  JSON plus the classic ``TOOL: PASS|FAIL`` line, and appended through
  :class:`JsonlWriter` to ``path`` (or ``$DE_TPU_VERDICT_LOG`` when
  set), so every tool shares one field schema and one exit-code
  convention."""
  ok = bool(result.get("ok", False))
  record = {"tool": tool, "ok": ok, "verdict": result}
  if verbose:
    print(json.dumps(record, indent=1))
  log_path = path if path is not None else os.environ.get(VERDICT_LOG_ENV)
  if log_path:
    with JsonlWriter(log_path) as w:
      w.write(record)
  print(f"{tool.upper()}: {'PASS' if ok else 'FAIL'}")
  return 0 if ok else 1

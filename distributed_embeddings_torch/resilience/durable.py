"""Rotated durable checkpoints: save-by-step, newest-valid restore
(PyTorch port of ``resilience/durable.py``).

``checkpoint.save`` makes ONE checkpoint durable (fsync, checksummed
manifest last, atomic rename). This module manages a DIRECTORY of them —
the unit a long-running job actually operates on:

    <root>/
        ckpt_0000000200/      (oldest retained)
        ckpt_0000000400/
        ckpt_0000000600/      (newest)
        ckpt_0000000800.tmp/  (a crash mid-save: no manifest, ignored)

- :func:`save_rotating` writes ``ckpt_<step>`` (with retry/backoff around
  the I/O at world 1 — a transient filesystem error must not kill a
  multi-day run) and prunes beyond the newest ``keep``.
- :func:`latest_valid` scans newest-first and returns the first directory
  that passes ``checkpoint.verify`` — a truncated, bit-flipped, or
  manifest-less latest checkpoint falls back to the previous one instead
  of aborting the resume.
- :func:`restore_latest` is the auto-resume entry point: restore the
  newest valid checkpoint, or return None when the directory holds no
  usable checkpoint (fresh start).

The directory names, the rotation and the fallback are the JAX
package's, so either package resumes the other's root. At world N every
rank calls :func:`save_rotating` and :func:`restore_latest` with its
mesh; a tiered run passes its ``HostTierStore`` (``store=``) and a
dynamic-vocabulary run its ``DynVocabTranslator`` (``vocab=``) through to
``checkpoint.save`` / ``restore``, and a streaming run its
``streaming.DeltaPublisher`` (``stream=``: its chain state rides the
checkpoint's ``stream`` section).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

from . import retry

_CKPT_RE = re.compile(r"^ckpt_(\d{10})$")


def step_dir(root: str, step: int) -> str:
  if step < 0:
    raise ValueError(f"checkpoint step must be >= 0, got {step}")
  return os.path.join(root, f"ckpt_{step:010d}")


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
  """All published checkpoints under ``root``, oldest first, as
  ``(step, path)``. ``.tmp`` leftovers and foreign entries are ignored."""
  if not os.path.isdir(root):
    return []
  out = []
  for entry in os.listdir(root):
    m = _CKPT_RE.match(entry)
    if m and os.path.isdir(os.path.join(root, entry)):
      out.append((int(m.group(1)), os.path.join(root, entry)))
  return sorted(out)


def latest_valid(root: str) -> Optional[Tuple[int, str]]:
  """Newest checkpoint that passes integrity verification, or None.

  Invalid candidates (truncated block, flipped bit, missing manifest)
  are skipped — newest-first — so one corrupted checkpoint costs one
  snapshot interval of progress, not the run."""
  from .. import checkpoint
  for step, path in reversed(list_checkpoints(root)):
    if not checkpoint.verify(path):
      return step, path
  return None


def prune(root: str, keep: int) -> List[str]:
  """Delete all but the newest ``keep`` checkpoints (and any stale
  ``.tmp`` dirs of already-pruned steps); returns the removed paths."""
  if keep < 1:
    raise ValueError(f"keep must be >= 1, got {keep}")
  ckpts = list_checkpoints(root)
  removed = []
  for _, path in ckpts[:-keep] if len(ckpts) > keep else []:
    shutil.rmtree(path, ignore_errors=True)
    shutil.rmtree(path + ".tmp", ignore_errors=True)
    removed.append(path)
  return removed


def _world_n(mesh) -> bool:
  return mesh is not None and mesh.world > 1


def save_rotating(root: str, plan, rule, state: Dict[str, Any],
                  store=None, keep: int = 3,
                  policy: retry.RetryPolicy = retry.DEFAULT_POLICY,
                  extra: Optional[Dict[str, Any]] = None,
                  vocab=None, telemetry=None, stream=None,
                  mesh=None) -> str:
  """Durably save ``state`` as ``<root>/ckpt_<step>`` and rotate.

  The step is read from ``state['step']`` so the directory name always
  matches the resumable position. At world 1 the whole
  ``checkpoint.save`` is retried on ``OSError`` — it is idempotent (a
  partial tmp dir from a failed attempt is removed by the next one). At
  world N (every rank calls this with its ``mesh``) saves are NOT
  retried: ``checkpoint.save`` is barrier-synchronized, so one rank
  re-entering it after a local fault would sit alone in the first
  barrier while the others never return — a deadlock, not a recovery.
  Pruning runs AFTER the new checkpoint is published (by rank 0), so the
  retention invariant ("keep newest K valid") never dips below K during a
  save."""
  from .. import checkpoint
  from ..telemetry import counter as _counter, span as _span

  step = int(state["step"])
  path = step_dir(root, step)
  rank = mesh.rank if _world_n(mesh) else 0
  if rank == 0:
    os.makedirs(root, exist_ok=True)
  with _span("ckpt/save", args={"step": step}):
    if _world_n(mesh):
      checkpoint.save(path, plan, rule, state, store=store, extra=extra,
                      vocab=vocab, telemetry=telemetry, stream=stream,
                      mesh=mesh)
    else:
      retry.retry_call(checkpoint.save, path, plan, rule, state,
                       store=store, extra=extra, vocab=vocab,
                       telemetry=telemetry, stream=stream, mesh=mesh,
                       policy=policy)
  _counter("ckpt/saves").inc()
  if rank == 0:
    prune(root, keep)
  if _world_n(mesh):
    dist.barrier()  # no rank scans the root while rank 0 prunes it
  return path


def restore_latest(root: str, plan, rule, state_like: Dict[str, Any],
                   mesh=None, store=None, vocab=None, stream=None,
                   device="cuda"
                   ) -> Optional[Tuple[Dict[str, Any], int, str]]:
  """Auto-resume: restore the newest VALID checkpoint under ``root``.

  Returns ``(state, step, path)``, or None when no usable checkpoint
  exists (the caller starts fresh). The candidate already passed
  ``checkpoint.verify`` during the scan, so the restore itself skips the
  duplicate checksum pass. ``device`` is where the state lands without a
  mesh (``"cuda"`` unless the caller asks for the CPU)."""
  from .. import checkpoint
  from ..telemetry import counter as _counter, span as _span

  if _world_n(mesh):
    # The choice of checkpoint must be COLLECTIVE. Two ranks scanning a
    # shared filesystem independently can disagree under attribute-cache
    # lag, and each would silently restore a different step — forking
    # the replicated state with no error. Rank 0 scans (also sparing
    # n-1 redundant full-crc passes) and broadcasts its verdict.
    step = [-1]
    if mesh.rank == 0:
      got = latest_valid(root)
      if got is not None:
        step = [got[0]]
    dist.broadcast_object_list(step, src=0)
    step = int(step[0])
    if step < 0:
      return None
    path = step_dir(root, step)
  else:
    got = latest_valid(root)
    if got is None:
      return None
    step, path = got
  with _span("ckpt/restore", args={"step": step}):
    state = checkpoint.restore(path, plan, rule, state_like, mesh=mesh,
                               store=store, verify_integrity=False,
                               vocab=vocab, stream=stream, device=device)
  _counter("ckpt/restores").inc()
  return state, step, path

"""Non-finite and out-of-vocabulary guards for the fused train step
(PyTorch port of ``resilience/guards.py``).

A single NaN batch is the worst failure mode this system has: the fused
scatter-add commits ``NaN`` into every touched row of every packed class
buffer — table lanes AND interleaved optimizer state — and from there it
spreads through the hot rows of a multi-day run with nothing logged. The
guard closes that hole at the only safe point: AFTER the backward
produces the loss and all gradients, BEFORE anything is committed.

:func:`all_finite` is the detection primitive (one ``isfinite``
reduction per float leaf, a device bool, no host read).
``training.make_sparse_train_step(guard=True)`` wires it in: a bad step
zeroes the sparse delta streams (a scatter-add of zeros is an exact
no-op on the packed buffers), skips the dense optimizers' steps and
leaves the step counter unchanged, so a guarded run that skips a
poisoned batch is bit-identical to a run that never saw it. The step's
metrics report the skip; :class:`~.trainer.ResilientTrainer` counts
consecutive skips and aborts-with-rollback past a threshold (a
persistently-NaN run signals diverged state, not one bad batch).

OOV policy: ids outside a table's vocabulary are clipped to the last row
(reference semantics). The plan-level ``oov`` policy keeps ``"clip"`` as
the numeric default but makes it observable — per-class OOV counters ride
the guarded step's metrics — and ``oov="error"`` escalates a nonzero
counter to a host-side error (:func:`check_oov`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaves(tree):
  if isinstance(tree, dict):
    for v in tree.values():
      yield from _leaves(v)
  elif isinstance(tree, (tuple, list)):
    for v in tree:
      yield from _leaves(v)
  elif tree is not None:
    yield tree


def all_finite(tree: Any) -> torch.Tensor:
  """Scalar bool tensor: every float leaf of ``tree`` (nested dicts,
  tuples and lists of tensors or arrays) is finite, on the leaves' device
  and without a host read.

  Integer and bool leaves are skipped (``isfinite`` is undefined there and
  ids and counters cannot be non-finite). An empty tree is vacuously
  finite."""
  flags = []
  for leaf in _leaves(tree):
    t = torch.as_tensor(leaf)
    if t.is_floating_point():
      flags.append(torch.isfinite(t).all())
  if not flags:
    return torch.tensor(True)
  if len(flags) == 1:
    return flags[0]
  dev = flags[0].device
  return torch.stack([f.to(dev) for f in flags]).all()


def _as_int(v) -> int:
  if isinstance(v, torch.Tensor):
    return int(v.item())
  return int(np.asarray(v))


def check_oov(plan, oov_counts: Dict[str, Any],
              where: str = "train step") -> Dict[str, int]:
  """Host-side enforcement of the plan's OOV policy on step metrics.

  Args:
    plan: the ``DistEmbeddingStrategy`` (its ``oov`` attribute is the
      policy; plans without it default to ``"clip"``).
    oov_counts: class name -> clipped-occurrence count (the ``"oov"``
      entry of a guarded step's metrics; tensors or ints).

  Returns the counts as a plain ``{name: int}`` dict. With
  ``oov="error"`` a nonzero count raises — naming every offending class,
  its count, and its tables' vocabularies — instead of letting clipped
  ids train the last row of each table. The guarded step upholds that
  claim by folding the OOV count into its commit gate under the
  ``"error"`` policy: the offending batch commits nothing, so this raise
  always fires with the state bit-identical to before the batch.
  """
  counts = {name: _as_int(v) for name, v in oov_counts.items()}
  policy = getattr(plan, "oov", "clip")
  if policy == "allocate":
    # dynamic vocabulary: the translator emits only in-range rows (or
    # PAD), so a nonzero in-trace counter means RAW ids reached the step
    # untranslated — a wiring bug the commit gate already kept out of
    # the state; escalate it like 'error', naming the actual failure
    bad = {name: n for name, n in counts.items() if n}
    if bad:
      raise ValueError(
          f"OOV policy 'allocate': {where} observed out-of-range ids — "
          f"{sorted(bad.items())} — but a translated stream is in-range "
          "by construction, so raw ids leaked past the dynvocab "
          "translator (was the batch fed to the step without "
          "DistributedLookup.translate_dynamic_ids / DynVocabTrainer?). "
          "The offending batch committed nothing.")
    return counts
  if policy != "error":
    return counts
  bad = {name: n for name, n in counts.items() if n}
  if bad:
    from ..parallel.lookup_engine import class_param_name
    vocab_of = {}
    for key in plan.class_keys:
      name = class_param_name(*key)
      tables = sorted({s.shard.table_id
                       for slots in plan.classes[key].slots_per_rank
                       for s in slots})
      vocab_of[name] = {t: plan.global_configs[t].input_dim for t in tables}
    detail = "; ".join(
        f"{name}: {n} id(s) out of range (table vocabs "
        f"{vocab_of.get(name, {})})" for name, n in sorted(bad.items()))
    raise ValueError(
        f"OOV policy 'error': {where} observed out-of-vocabulary ids that "
        f"the clip policy would have silently mapped to each table's last "
        f"row — {detail}. Fix the id pipeline, or set oov='clip' on the "
        "DistEmbeddingStrategy to accept clipping.")
  return counts


class BadStepCounter:
  """Host-side consecutive-bad-step accounting for a guarded loop.

  ``update(bad_step)`` returns True while training may continue; once
  ``max_consecutive`` bad steps arrive in a row it returns False — the
  caller should roll back to the last durable checkpoint and abort (the
  :class:`~.trainer.ResilientTrainer` contract). ``None`` disables the
  abort (count forever)."""

  def __init__(self, max_consecutive: Optional[int] = 3):
    if max_consecutive is not None and max_consecutive < 1:
      raise ValueError(
          f"max_consecutive must be >= 1 or None, got {max_consecutive}")
    self.max_consecutive = max_consecutive
    self.skipped = 0
    self.consecutive = 0

  def update(self, bad_step) -> bool:
    if _as_int(bad_step):
      self.skipped += 1
      self.consecutive += 1
      return (self.max_consecutive is None
              or self.consecutive < self.max_consecutive)
    self.consecutive = 0
    return True

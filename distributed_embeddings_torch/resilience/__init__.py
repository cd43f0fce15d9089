"""Resilience subsystem of the port: durable checkpoints, guards, retry,
fault injection (PyTorch port of ``resilience/``).

Long-running embedding training fails in four characteristic ways, and
each module here owns one of them:

- **Torn / corrupted checkpoints** — ``checkpoint.py`` writes each
  snapshot durably (fsync, checksummed manifest last, atomic rename);
  :mod:`.durable` rotates the last K and resumes from the newest VALID
  one when the latest is truncated or bit-flipped.
- **Poison batches** — :mod:`.guards` detects non-finite loss, gradients
  and delta streams after the backward and before the fused scatter-add
  commits; ``training.make_sparse_train_step(guard=True)`` skips the step
  bit-exactly, and out-of-range ids become observable per-class OOV
  counters under the plan's ``oov`` policy instead of silent clips.
- **Transient host I/O faults** — :mod:`.retry` wraps checkpoint I/O in
  bounded exponential backoff.
- **Everything at once** — :class:`.trainer.ResilientTrainer` composes
  them: periodic snapshots, auto-resume on restart, skip accounting,
  abort-with-rollback after K consecutive bad steps.
- **Lost and regained workers** — :mod:`.elastic` re-shards a state onto
  another world (in the run, ``ResilientTrainer.resize``, and across
  restarts through ``checkpoint.restore``) and keeps the pod's membership
  in lease files.

:mod:`.faultinject` is the deterministic harness the tests (and
``tools/torch_chaos_train.py``) drive all of the above with:
crash-mid-save, file truncation/bit flips, transient write errors, NaN
batches.

``durable`` and ``trainer`` are imported lazily (PEP 562): they pull in
``checkpoint``, which itself hooks :mod:`.faultinject` — eager imports
here would close that cycle.
"""

from . import faultinject, guards, retry  # noqa: F401  (cycle-free)

__all__ = [
    "durable",
    "elastic",
    "faultinject",
    "guards",
    "retry",
    "trainer",
    "FaultInjector",
    "InjectedCrash",
    "TransientIOError",
    "ResilientTrainer",
    "TooManyBadSteps",
    "RetryPolicy",
]

from .faultinject import FaultInjector, InjectedCrash, TransientIOError  # noqa: E402,F401
from .retry import RetryPolicy  # noqa: E402,F401


def __getattr__(name):
  if name in ("durable", "elastic", "trainer"):
    import importlib
    return importlib.import_module(f".{name}", __name__)
  if name in ("ResilientTrainer", "TooManyBadSteps"):
    from .trainer import ResilientTrainer, TooManyBadSteps
    return {"ResilientTrainer": ResilientTrainer,
            "TooManyBadSteps": TooManyBadSteps}[name]
  raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Deterministic fault injection for resilience testing.

A copy of ``distributed_embeddings_tpu/resilience/faultinject.py`` for the PyTorch port
(pure Python; the port imports nothing of the JAX package).

Production embedding training dies in ways unit tests never exercise:
preemption mid-checkpoint, a cosmic-ray bit flip in a multi-GiB ``.npy``
block, an NFS server hiccup during a host-tier gather, a NaN batch from
an upstream feature pipeline. This module is the ONE mechanism the
resilience tests (and future chaos tooling) drive all of them through —
every fault is counter-based and therefore exactly reproducible.

Instrumented sites consult the active injector by name via :func:`fire`:

- ``"ckpt_write"``: after each checkpoint data file is written
  (``checkpoint.save``) — ``crash_after`` simulates preemption mid-save.
- ``"ckpt_rename"``: before the final tmp -> live rename — simulates a
  crash after a complete write but before publication.
- ``"host_gather"``: inside ``HostTierStore.gather`` — ``fail_first``
  simulates transient cold-store read errors the retry layer must absorb.
- ``"ckpt_owner_write"``: after each per-OWNER cold-store block write in
  a (possibly multi-controller) tiered save — the sharded-cold-store
  counterpart of ``ckpt_write``, so chaos can die between one owner's
  blocks and another's.
- ``"sigkill"``: fired by trainers/drivers at step boundaries as a kill
  MARKER — carries no library behavior of its own; the cross-run chaos
  driver (``tools/chaos_kill.py``) installs a :meth:`FaultInjector.kill_at`
  rule on it to SIGKILL a real worker process mid-run.
- ``"reshard_gather"``: per source block read during an elastic
  (world-N save -> world-M restore) re-shard in ``checkpoint.restore`` —
  lets chaos interrupt the re-shard itself.

Streaming (online-learning) extension sites, registered by their home
modules via :func:`register_site` (same lint/validation treatment as
``SITES`` members):

- ``"delta_extract"`` (`streaming/publish.py`): per physical-row window
  a delta extraction reads.
- ``"delta_seal"`` (`streaming/publish.py`): per data file sealed into
  a ``delta_<seq>.tmp`` — SIGKILL here leaves a torn publish the
  subscriber never reads (``tools/chaos_stream.py``).
- ``"stream_attach"`` (`streaming/publish.py`): per tail delta a
  publisher ATTACH validates after a kill/restore.
- ``"stream_read"`` (`streaming/subscribe.py`): per subscriber
  filesystem read ATTEMPT, inside the retry loop — ``fail_first``
  simulates the transient NFS/GCS-fuse errors retry must absorb.
- ``"delta_promote"`` (`streaming/subscribe.py`): at the start of each
  delta application — the kill-the-subscriber-mid-promote hook.
- ``"compact_fold"`` (`streaming/compact.py`): per sparse class folded
  into a compacted base — the kill-the-compactor-mid-fold hook.
- ``"fleet_rpc"`` (`fleet/transport.py`): per router->owner RPC attempt,
  inside the retry loop — ``fail_first`` simulates a flaky fleet
  network; persistent failure drives the router's counted failover.

With no injector installed :func:`fire` is a dict lookup + None check:
the hooks cost nothing in production.

File-corruption helpers (:func:`truncate_file`, :func:`bitflip_file`) and
the NaN-batch stream wrapper (:func:`nan_batches`) round out the fault
menu; they act directly rather than through ``fire`` because they corrupt
state at rest, not an operation in flight.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


# The registry of instrumented sites. A rule installed for a name not in
# this set can NEVER fire — historically such typos were silently ignored
# and the test went on "passing" while testing nothing — so the injector
# validates at rule-installation time, and the graftlint GL108 rule
# cross-checks every site literal in the tree against this set (parsed
# from the AST: keep it a literal).
SITES = frozenset({"ckpt_write", "ckpt_rename", "host_gather",
                   "ckpt_owner_write", "reshard_gather"})

_extra_sites = set()


def register_site(site: str) -> str:
  """Register an additional instrumented site name (for downstream /
  experimental hooks). Returns ``site`` so it can be used inline.

  String-literal ``register_site`` calls in the library package and
  tools/ are ALSO parsed by graftlint (GL108 context), so a registered
  extension site lints the same as a ``SITES`` member — typos in rule
  installs still fail."""
  _extra_sites.add(site)
  return site


# The cross-run chaos driver's kill marker: NOT a library-instrumented
# site (no library code path consults it) — trainers and drivers fire it
# at step boundaries so a `kill_at` rule can SIGKILL a real process
# there. Registered here so every process (worker subprocesses included)
# knows it without import-order coupling to the driver.
SIGKILL_SITE = register_site("sigkill")


def known_sites() -> frozenset:
  return SITES | frozenset(_extra_sites)


class InjectedCrash(RuntimeError):
  """A simulated hard crash (preemption / SIGKILL stand-in).

  Deliberately NOT an ``OSError``: the retry layer must treat it as fatal
  (a preempted process does not get to retry), so tests that inject a
  crash see it propagate exactly as a real preemption would."""


class TransientIOError(OSError):
  """A simulated transient I/O failure (the retry layer's food)."""


class FaultInjector:
  """Counter-based fault rules, keyed by instrumented site name.

  Rules are evaluated per :func:`fire` call in the order installed;
  counters make every run bit-reproducible. Thread-safe (the tiered
  trainer may classify on a worker thread)."""

  def __init__(self):
    self._lock = threading.Lock()
    self._counts: Dict[str, int] = {}
    self._crash_at: Dict[str, int] = {}
    self._fail_until: Dict[str, Tuple[int, type]] = {}
    self._kill_at: Dict[str, int] = {}
    self._delay: Dict[str, float] = {}
    self._delay_when: Dict[str, Tuple[float, Dict[str, object]]] = {}

  # ---- rule installation -------------------------------------------------
  @staticmethod
  def _check_site(site: str) -> str:
    if site not in known_sites():
      raise ValueError(
          f"unknown fault-injection site {site!r}: no instrumented code "
          f"path consults it, so this rule would never fire and the test "
          f"would silently test nothing. Valid sites: "
          f"{sorted(known_sites())} (extend via "
          "faultinject.register_site).")
    return site

  def crash_after(self, site: str, n: int) -> "FaultInjector":
    """Raise :class:`InjectedCrash` on the ``n``-th event at ``site``
    (0-indexed: ``n=0`` crashes the first event)."""
    self._crash_at[self._check_site(site)] = n
    return self

  def fail_first(self, site: str, k: int,
                 exc: type = TransientIOError) -> "FaultInjector":
    """Raise ``exc`` for the first ``k`` events at ``site``, then let
    every later event through — the canonical transient fault."""
    self._fail_until[self._check_site(site)] = (k, exc)
    return self

  def kill_at(self, site: str, n: int) -> "FaultInjector":
    """SIGKILL **this process** on the ``n``-th event at ``site``.

    Unlike :meth:`crash_after` (a catchable Python exception), this is a
    real, uncatchable kill: no ``finally`` blocks run, no buffers flush,
    no barriers release — exactly what preemption looks like to a
    training process. Only the cross-run chaos harness
    (``tools/chaos_kill.py``), which relaunches and inspects from a
    SEPARATE driver process, should install it."""
    self._kill_at[self._check_site(site)] = n
    return self

  def delay_each(self, site: str, seconds: float) -> "FaultInjector":
    """Sleep ``seconds`` at every event at ``site`` — a deterministic
    slow-storage stand-in (e.g. stretch ``ckpt_write`` so an async
    snapshot observably overlaps training steps)."""
    if seconds < 0:
      raise ValueError(f"delay must be >= 0, got {seconds}")
    self._delay[self._check_site(site)] = float(seconds)
    return self

  def delay_when(self, site: str, seconds: float,
                 **match) -> "FaultInjector":
    """Sleep ``seconds`` at events at ``site`` whose :func:`fire` info
    matches every ``match`` key (e.g. ``delay_when("fleet_rpc", 0.05,
    owner=0)`` slows exactly one replica — the straggler workload the
    hedging tests need). An event missing a matched key does not match;
    ``match`` must name at least one key (otherwise use
    :meth:`delay_each`)."""
    if seconds < 0:
      raise ValueError(f"delay must be >= 0, got {seconds}")
    if not match:
      raise ValueError("delay_when without match keys would fire on "
                       "every event — that is delay_each; name at least "
                       "one info key to match on")
    self._delay_when[self._check_site(site)] = (float(seconds),
                                                dict(match))
    return self

  # ---- observation -------------------------------------------------------
  def count(self, site: str) -> int:
    """Events observed at ``site`` so far (including failed ones)."""
    with self._lock:
      return self._counts.get(site, 0)

  # ---- the hook ----------------------------------------------------------
  def fire(self, site: str, **info) -> None:
    with self._lock:
      n = self._counts.get(site, 0)
      self._counts[site] = n + 1
    delay = self._delay.get(site)
    if delay:
      import time
      time.sleep(delay)
    cond = self._delay_when.get(site)
    if cond is not None:
      seconds, match = cond
      if seconds and all(k in info and info[k] == v
                         for k, v in match.items()):
        import time
        time.sleep(seconds)
    kill = self._kill_at.get(site)
    if kill is not None and n == kill:
      import os
      import signal
      os.kill(os.getpid(), signal.SIGKILL)  # real preemption: no unwind
    crash = self._crash_at.get(site)
    if crash is not None and n == crash:
      raise InjectedCrash(
          f"injected crash at site {site!r} event #{n} ({info or 'no info'})")
    rule = self._fail_until.get(site)
    if rule is not None and n < rule[0]:
      raise rule[1](
          f"injected transient failure at site {site!r} event #{n} "
          f"({n + 1} of {rule[0]}; {info or 'no info'})")


_active: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> None:
  """Install ``injector`` globally (None deactivates)."""
  global _active
  _active = injector


def active() -> Optional[FaultInjector]:
  return _active


@contextlib.contextmanager
def injected(injector: FaultInjector):
  """Scope an injector to a ``with`` block (always deactivates on exit,
  including when the injected fault propagates)."""
  prev = _active
  install(injector)
  try:
    yield injector
  finally:
    install(prev)


def fire(site: str, **info) -> None:
  """Instrumentation hook: no-op unless an injector is installed."""
  if _active is not None:
    _active.fire(site, **info)


# ---------------------------------------------------------------------------
# State-at-rest corruption (checkpoint files)
# ---------------------------------------------------------------------------


def truncate_file(path: str, keep_bytes: Optional[int] = None) -> None:
  """Truncate ``path`` (default: to half its size) — a torn write."""
  import os
  size = os.path.getsize(path)
  keep = size // 2 if keep_bytes is None else keep_bytes
  with open(path, "r+b") as f:
    f.truncate(keep)


def bitflip_file(path: str, offset: Optional[int] = None,
                 bit: int = 0) -> None:
  """Flip one bit of ``path`` (default: the middle byte) — silent media
  corruption a size check cannot see."""
  import os
  size = os.path.getsize(path)
  if not size:
    raise ValueError(f"cannot bit-flip empty file {path!r}")
  off = size // 2 if offset is None else offset
  with open(path, "r+b") as f:
    f.seek(off)
    b = f.read(1)
    f.seek(off)
    f.write(bytes([b[0] ^ (1 << bit)]))


# ---------------------------------------------------------------------------
# Bad-batch injection
# ---------------------------------------------------------------------------


def nan_batches(batches: Iterable, at_steps, field: int = 0):
  """Yield ``batches`` with NaN poison injected at the given step indices.

  ``field`` selects which element of each batch tuple to poison (default
  0: the dense ``numerical`` features — NaNs there reach the loss and
  every gradient, the way a broken upstream feature pipeline does).
  Non-destructive: poisoned batches are copies."""
  bad = frozenset(int(s) for s in at_steps)
  for i, batch in enumerate(batches):
    if i in bad:
      batch = list(batch)
      x = np.array(np.asarray(batch[field]), np.float32, copy=True)
      x[...] = np.nan
      batch[field] = x
      yield tuple(batch)
    else:
      yield batch

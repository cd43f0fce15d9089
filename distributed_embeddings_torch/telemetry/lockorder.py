"""Test-time lock-order sanitizer: the runtime half of threadlint
(PyTorch port of ``distributed_embeddings_tpu/telemetry/lockorder.py``).

The JAX package's ``analysis.threadlint`` derives a static
lock-acquisition graph from lexically nested ``with`` blocks and rejects
cycles (GL121).  The static view is conservative — it cannot see
cross-function nesting (e.g. a ``ServeEngine`` method taking its lock
while a ``MicroBatcher`` holds its own) or orders that only materialize
under a particular interleaving.  This module closes that gap in
tests: wrap a subsystem's locks in :class:`LockOrderMonitor`
instruments, run the normal workload, and the monitor records every
ACTUAL held->acquired edge.  A same-run inversion (B-then-A observed
after A-then-B) raises :class:`LockOrderError` at acquisition time —
at the exact second acquisition, with both sites in the message — and
:meth:`LockOrderMonitor.assert_consistent_with` asserts the observed
edges merged with the static graph stay acyclic, so the runtime truth
and the checked-in model cannot drift apart silently.

Usage (see tests/test_torch_telemetry.py)::

    mon = LockOrderMonitor()
    b._lock = mon.wrap(b._lock, "MicroBatcher._lock")
    b._nonempty = mon.wrap(b._nonempty, "MicroBatcher._lock")
    ... run the workload ...
    mon.assert_consistent_with(static_edges)

A ``Condition`` and its underlying lock share one NAME (holding either
is holding both — the same canonicalization threadlint applies), so
the condition's internal re-acquire never self-reports.  The wrapper
delegates the full lock/condvar surface and is reentrancy-aware: a
re-acquire of an already-held name records no edge.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["InstrumentedLock", "LockOrderError", "LockOrderMonitor"]


class LockOrderError(AssertionError):
  """A lock-acquisition-order inversion (potential deadlock)."""


class _HeldState(threading.local):
  def __init__(self):
    self.stack: List[str] = []


class LockOrderMonitor:
  """Records held->acquired edges across every wrapped lock."""

  def __init__(self):
    self._meta = threading.Lock()
    # (held, acquired) -> first site description
    self._edges: Dict[Tuple[str, str], str] = {}
    self._held = _HeldState()

  def wrap(self, lock, name: str) -> "InstrumentedLock":
    """Wrap any lock-like object (Lock/RLock/Condition) under ``name``.
    Use threadlint's canonical token (``Class.attr``) so the runtime
    edges line up with the static graph."""
    return InstrumentedLock(self, lock, name)

  # -- recording ------------------------------------------------------------
  def _on_acquire(self, name: str) -> None:
    stack = self._held.stack
    if name in stack:
      stack.append(name)  # reentrant: no new edges
      return
    site = f"thread {threading.current_thread().name}"
    with self._meta:
      for held in set(stack):
        rev = self._edges.get((name, held))
        if rev is not None:
          raise LockOrderError(
              f"lock-order inversion: acquiring {name!r} while "
              f"holding {held!r} ({site}), but the opposite order "
              f"{name!r} -> {held!r} was already observed ({rev}) — "
              "two threads interleaving these paths can deadlock.")
        self._edges.setdefault((held, name), site)
    stack.append(name)

  def _on_release(self, name: str) -> None:
    stack = self._held.stack
    for i in range(len(stack) - 1, -1, -1):
      if stack[i] == name:
        del stack[i]
        return

  # -- inspection -----------------------------------------------------------
  def edges(self) -> Set[Tuple[str, str]]:
    with self._meta:
      return set(self._edges)

  def assert_consistent_with(
      self, static_edges: Iterable[Tuple[str, str]]) -> None:
    """The observed edges merged with threadlint's static graph must be
    acyclic; a cycle means the runtime order contradicts (or extends
    into a knot with) the checked-in model."""
    graph: Dict[str, Set[str]] = {}
    for a, b in list(static_edges) + sorted(self.edges()):
      graph.setdefault(a, set()).add(b)
      graph.setdefault(b, set())
    state: Dict[str, int] = {}  # 1=visiting, 2=done

    def visit(node: str, path: List[str]) -> Optional[List[str]]:
      state[node] = 1
      path.append(node)
      for nxt in sorted(graph[node]):
        if state.get(nxt) == 1:
          return path[path.index(nxt):] + [nxt]
        if state.get(nxt) != 2:
          cyc = visit(nxt, path)
          if cyc is not None:
            return cyc
      path.pop()
      state[node] = 2
      return None

    for node in sorted(graph):
      if state.get(node) is None:
        cyc = visit(node, [])
        if cyc is not None:
          raise LockOrderError(
              "observed lock order contradicts the static "
              f"acquisition graph: cycle {' -> '.join(cyc)} in the "
              "merged (static + runtime) graph.")


class InstrumentedLock:
  """Delegating wrapper recording acquisition order into a monitor.

  Covers the Lock, RLock and Condition surfaces; anything else
  (``locked``, ``wait``, ``wait_for``...) falls through to the wrapped
  object.  ``wait()`` releases and re-acquires the underlying lock
  internally without changing the held NAME set — correct, because the
  condvar shares its lock's name."""

  def __init__(self, monitor: LockOrderMonitor, lock, name: str):
    self._monitor = monitor
    self._lock = lock
    self._name = name

  def acquire(self, *args, **kwargs):
    got = self._lock.acquire(*args, **kwargs)
    if got:
      self._monitor._on_acquire(self._name)
    return got

  def release(self):
    self._monitor._on_release(self._name)
    return self._lock.release()

  def __enter__(self):
    got = self._lock.__enter__()
    self._monitor._on_acquire(self._name)
    return got

  def __exit__(self, *exc):
    self._monitor._on_release(self._name)
    return self._lock.__exit__(*exc)

  def __getattr__(self, attr):
    return getattr(self._lock, attr)

  def __repr__(self):
    return f"InstrumentedLock({self._name!r}, {self._lock!r})"

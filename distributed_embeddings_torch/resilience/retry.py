"""Bounded retry with exponential backoff for host-side I/O (PyTorch port
of ``resilience/retry.py``, whole; pure Python).

Two operations in a long-running embedding run touch storage a transient
fault can break without anything being *wrong* with the run: host-tier
cold-store gathers (`tiering/`) and checkpoint I/O. Both are pure reads
or idempotent whole-directory writes, so the correct response to an
``OSError`` is to try again, not to kill a multi-day job.

Policy notes:

- Only exceptions in ``retry_on`` (default ``OSError`` — which covers
  :class:`faultinject.TransientIOError`) are retried; anything else —
  including :class:`faultinject.InjectedCrash` and real ``IndexError``
  bounds violations — propagates immediately. A retry loop that eats a
  correctness error turns a crash into silent data corruption.
- Backoff defaults to deterministic exponential (``backoff *
  2**attempt`` seconds, no jitter) — reproducible tests, and fine for a
  lone single-controller host. ``jitter='full'`` draws each sleep
  uniformly from ``[0, that cap]`` (AWS full jitter): an elastically
  resized pod has MANY workers whose retries against the same shared
  filesystem or cold store would otherwise fire on identical schedules
  — thundering-herd shaped. ``seed`` pins the draw sequence so jittered
  tests stay exact (None: OS entropy, the production decorrelation).
- When retries are exhausted the LAST exception is re-raised with the
  attempt count noted, so the root cause is never swallowed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
  """How many times to retry and how long to wait between attempts."""

  retries: int = 3            # retry attempts AFTER the first call
  backoff: float = 0.05      # base sleep seconds; doubles per attempt
  max_backoff: float = 2.0
  retry_on: Tuple[Type[BaseException], ...] = (OSError,)
  # "none": sleep exactly the exponential cap (deterministic, the
  # historical behavior). "full": sleep uniform(0, cap) — decorrelates
  # a resized pod's workers retrying the same storage on one schedule.
  jitter: str = "none"
  # full-jitter determinism knob: a fixed seed reproduces the exact
  # sleep sequence per retried call (tests); None draws OS entropy.
  seed: Optional[int] = None

  def __post_init__(self):
    if self.jitter not in ("none", "full"):
      raise ValueError(
          f"jitter must be 'none' or 'full', got {self.jitter!r}")

  def make_rng(self):
    """One RNG per retried CALL (not per policy — a frozen shared
    policy object must not thread hidden mutable state between
    callers): None under deterministic backoff."""
    if self.jitter == "none":
      return None
    import random
    return random.Random(self.seed)

  def sleep_for(self, attempt: int, rng=None) -> float:
    cap = min(self.backoff * (2 ** attempt), self.max_backoff)
    if rng is None:
      return cap
    return rng.uniform(0.0, cap)


DEFAULT_POLICY = RetryPolicy()


def retry_call(fn: Callable, *args,
               policy: RetryPolicy = DEFAULT_POLICY,
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep,
               **kwargs):
  """Call ``fn(*args, **kwargs)``, retrying per ``policy``.

  ``on_retry(attempt, exc)`` is invoked before each sleep (metrics /
  logging hook); ``sleep`` is injectable so tests don't wait wall-clock.
  """
  from ..telemetry import counter as _counter

  attempt = 0
  rng = policy.make_rng()  # full-jitter draws; None = deterministic
  while True:
    try:
      return fn(*args, **kwargs)
    except policy.retry_on as e:
      if attempt >= policy.retries:
        raise _exhausted(e, attempt + 1) from e
      # every retried attempt is observable process-wide (next to each
      # caller's own on_retry accounting, e.g. the prefetcher's)
      _counter("retry/attempts").inc()
      if on_retry is not None:
        on_retry(attempt, e)
      sleep(policy.sleep_for(attempt, rng))
      attempt += 1


def _exhausted(e: BaseException, attempts: int) -> BaseException:
  """The terminal exception: same type with the attempt count appended.

  Rebuilding with a single message string would lose OSError's
  errno/strerror/filename (callers branch on e.errno, e.g. ENOSPC) and
  would TypeError for exception classes whose constructors need other
  arguments — so those attributes are copied over, and any failure to
  reconstruct falls back to the ORIGINAL exception unmodified (the root
  cause must never be masked by the wrapper)."""
  note = f"(failed after {attempts} attempts, retries exhausted)"
  try:
    wrapped = type(e)(f"{e} {note}")
  except Exception:
    return e
  if isinstance(e, OSError):
    # Copy only attributes that are actually set: assigning None to
    # OSError.filename stores a real Py_None in the C slot, which flips
    # OSError.__str__ into its "[Errno ...] ...: filename" branch and
    # discards the message entirely.
    for attr in ("errno", "filename", "filename2"):
      val = getattr(e, attr, None)
      if val is not None:
        setattr(wrapped, attr, val)
    strerror = getattr(e, "strerror", None)
    if strerror is not None:
      # an errno-carrying OSError prints "[Errno e] strerror[: file]"
      # and ignores args[0], so the note must ride strerror to be seen
      wrapped.strerror = f"{strerror} {note}"
  return wrapped


def retrying(fn: Callable, policy: RetryPolicy = DEFAULT_POLICY,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             sleep: Callable[[float], None] = time.sleep) -> Callable:
  """Bind ``fn`` to a policy: returns a callable with ``fn``'s signature."""
  def wrapped(*args, **kwargs):
    return retry_call(fn, *args, policy=policy, on_retry=on_retry,
                      sleep=sleep, **kwargs)
  return wrapped

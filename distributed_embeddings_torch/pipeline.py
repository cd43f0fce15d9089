"""Step pipeline: the next batch's host pass on a worker thread while the
card runs this step (PyTorch port of ``pipeline.py``).

The tiered trainer's host pass (classify the batch against the resident
maps, gather its cold rows out of the host images) is welded to every
step. Run serially a step costs host + device time; here batch k+1's pass
runs on ONE worker thread while step k's kernels run, so that a step
tends toward ``max(host, device)``. The overlapped loop is bit-equal to
the serial one, by three rules:

1. **Write-back conflict repair.** Step k's write-back scatters its staged
   rows into the host images that batch k+1's gather reads. The worker
   gathers concurrently, and the main thread re-gathers only
   ``intersect(cold rows staged for k+1, rows written back by k)`` once
   the write-back has landed (``TieredPrefetcher.repair_conflicts``):
   exactly what a serial gather would have read. A guard-skipped step's
   write-back rewrites unchanged rows, so its repair is skipped.
2. **Deferred side effects.** The worker's classify is the pure half
   (``classify_pure``): the observed-count increments come back as data
   and the main thread commits them (``apply_counts``) after the step's
   hooks, so a snapshot after step j sees the counts of batches 1..j.
   The device uploads and the gather counters commit on the main thread
   too (``upload_staged``), after the worker was joined.
3. **No overlap across a re-rank.** A re-rank rebuilds the resident maps,
   so the batch after a re-rank step is staged serially against the new
   maps.

The worker never touches CUDA or a collective: ``classify_pure`` and
``gather_cold`` are numpy over host batches and host images (a
collective issued on the worker would interleave with the main thread's
on the one default process group). It is joined before the accounting,
because a guard rollback restores store state. A failed job fails the
step that needed it (:meth:`HostWorker.result` re-raises on the caller's
thread): there is no fallback to the serial loop. The worker's jobs are
``telemetry.timed`` spans under their label (their own trace track), and
the host time each step hid is observed as ``tiered/overlap_hidden_s``.

The overlap pays only while the main thread gives up the GIL during the
device's work: the job is submitted after ``_dispatch`` has queued the
step's launches, and the main thread then blocks in the write-back's
download, which releases it.

The dynamic-vocabulary half (:func:`run_dynvocab_overlapped`) translates
batch k+1's raw ids on the worker while step k runs. The translation
mutates the translator, in batch order on the one worker, so the id
space evolves exactly as in the serial loop; the re-zeroing of recycled
rows (``DynVocabTrainer._apply_zero``, a device write) stays on the main
thread, before the dispatch of the step that may read them; and the
worker is joined before the accounting. The translate-ahead is skipped
where the caller's ``defer_overlap`` says a snapshot may follow (a
snapshot must never see a translator a batch ahead of the consumed
stream). The hidden host time is observed as
``dynvocab/overlap_hidden_s``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, List, Optional, Tuple

from .telemetry import span as _span, timed as _timed


class _Job:
  """One submitted unit: result or error, and the job's own seconds
  (from which the hidden host time is computed)."""

  __slots__ = ("fn", "label", "done", "result", "error", "elapsed")

  def __init__(self, fn: Callable[[], Any], label: str):
    self.fn = fn
    self.label = label
    self.done = threading.Event()
    self.result: Any = None
    self.error: Optional[BaseException] = None
    self.elapsed = 0.0


class HostWorker:
  """ONE worker thread running host jobs in submission order.

  Single-threaded by design: the tiered gather never races itself, and
  stateful passes stay in the serial loop's order. Jobs are timed with
  ``telemetry.timed`` under their label. :meth:`result` re-raises a
  failed job's exception on the caller's thread; :meth:`close` drains
  and joins without raising for jobs whose results were dropped.

  No lock: the hand-off is the ``queue.Queue`` and each job's
  ``threading.Event``; a job's fields are written by the worker before
  ``done.set()`` and read by the caller after ``done.wait()``."""

  def __init__(self, name: str = "host-pipeline"):
    self.name = name
    self._q: "queue.Queue[Optional[_Job]]" = queue.Queue()
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name=name)
    self._thread.start()

  def _loop(self) -> None:
    while True:
      job = self._q.get()
      if job is None:
        return
      try:
        with _timed(job.label) as t:
          job.result = job.fn()
        job.elapsed = t.elapsed
      except BaseException as e:  # re-raised at result()
        job.error = e
      finally:
        job.done.set()

  def submit(self, fn: Callable[..., Any], *args: Any,
             label: str = "pipeline/job") -> _Job:
    if not self._thread.is_alive():
      raise RuntimeError(f"HostWorker {self.name!r} is closed")
    job = _Job((lambda: fn(*args)), label)
    self._q.put(job)
    return job

  def result(self, job: _Job) -> Tuple[Any, float]:
    """Wait for ``job``; return ``(result, elapsed_seconds)`` or re-raise
    the exception the job died with."""
    job.done.wait()
    if job.error is not None:
      raise job.error
    return job.result, job.elapsed

  def close(self) -> None:
    if self._thread.is_alive():
      self._q.put(None)
      self._thread.join()

  def __enter__(self) -> "HostWorker":
    return self

  def __exit__(self, *exc: Any) -> None:
    self.close()


def _hidden(reg, name: str, job_s: float, wait_s: float) -> None:
  # host seconds the device window absorbed: the job's time minus the
  # tail the main thread still waited for
  reg.histogram(name).observe(max(0.0, job_s - wait_s))


def _tiered_host_job(pf, cats) -> Tuple[Any, Any]:
  cold, count_updates = pf.classify_pure(cats)
  return count_updates, pf.gather_cold(cold)


def run_tiered_overlapped(trainer, batches: Iterable, *,
                          account: Optional[Callable] = None,
                          on_dispatch: Optional[Callable] = None,
                          after_step: Optional[Callable] = None
                          ) -> List[float]:
  """The overlapped form of ``TieredTrainer.run``: while step j runs on
  the card, the worker classifies batch j+1 and gathers its cold rows.

  Hooks (the ``ResilientTrainer`` wiring):
    ``account(metrics)``: replaces ``trainer._account`` (the step's
      metrics as the step returned them);
    ``on_dispatch()``: right after the dispatch (the stream position);
    ``after_step(loss, metrics, stepped, pending_ahead)``: after the
      write-back, the accounting and the re-rank, before the next
      batch's blocks commit; True stops the run (a SIGTERM drain).
      ``pending_ahead`` says a worker job for the next batch finished
      (snapshotting over it is safe: the job is pure)."""
  pf = trainer.prefetcher
  interval = trainer.tplan.config.rerank_interval
  reg = trainer.telemetry
  losses: List[float] = []
  it = iter(batches)
  cur = next(it, None)
  if cur is None:
    return losses
  with HostWorker("tiered-overlap") as worker:
    staged = pf.prepare(cur[1])
    while cur is not None:
      numerical, cats, labels = cur
      nxt = next(it, None)
      staged_out, metrics, loss = trainer._dispatch(staged, numerical, cats,
                                                    labels)
      if on_dispatch is not None:
        on_dispatch()
      # the card is computing now: start batch j+1's host pass unless this
      # step re-ranks (the serial loop defers its classify there too)
      will_rerank = bool(interval) and (
          pf.steps_since_rerank + 1 >= interval)
      job = None
      if nxt is not None and not will_rerank:
        job = worker.submit(_tiered_host_job, pf, nxt[1],
                            label="tiered/host_prepare")
      pf.write_back(staged, staged_out)  # syncs on the device
      trainer._dev_span.finish()
      # join the worker BEFORE accounting: a guard rollback restores store
      # state, and must never race an in-flight gather
      prepared = None
      if job is not None:
        with _timed("tiered/overlap_wait", reg) as w:
          prepared, job_s = worker.result(job)
        _hidden(reg, "tiered/overlap_hidden_s", job_s, w.elapsed)
      (account or trainer._account)(metrics)
      trainer.state["fused"] = pf.maybe_rerank(trainer.state["fused"])
      losses.append(float(loss))
      stop = bool(after_step(losses[-1], metrics, int(trainer.state["step"]),
                             prepared is not None)) \
          if after_step is not None else False
      if stop or nxt is None:
        break
      if prepared is not None:
        count_updates, blocks = prepared
        skipped = bool(int(metrics["bad_step"])) if trainer.guard else False
        if not skipped:
          pf.repair_conflicts(blocks, staged.cold)
        pf.apply_counts(count_updates)
        staged = pf.upload_staged(blocks)
      else:
        staged = pf.prepare(nxt[1])  # after a re-rank: against the new maps
      cur = nxt
  return losses


def _dynvocab_translate_job(trainer, cats):
  return trainer.engine.translate_dynamic_ids(cats, trainer.translator)


def run_dynvocab_overlapped(trainer, batches: Iterable, *,
                            account: Optional[Callable] = None,
                            on_dispatch: Optional[Callable] = None,
                            after_step: Optional[Callable] = None,
                            defer_overlap: Optional[Callable] = None
                            ) -> List[float]:
  """The overlapped form of ``DynVocabTrainer.run``: while step j runs
  on the card, the worker translates batch j+1's raw ids.

  Hooks (the ``ResilientTrainer`` wiring):
    ``account(metrics, vocab_metrics)``: replaces the trainer's own
      accounting (guard metrics, then the lifecycle counters);
    ``on_dispatch()``: right after the dispatch (the stream position);
    ``defer_overlap(prev_stepped)``: True keeps the next batch's
      translation off the worker (it then runs serially at the next
      step): the ResilientTrainer defers around snapshot boundaries and
      drain requests, so a snapshot never captures a translator a batch
      ahead of the consumed stream;
    ``after_step(loss, metrics, stepped, pending_ahead)``: True stops the
      run. With a translated batch pending, that batch is consumed as
      one more step before stopping, so the translator clock equals the
      consumed count at the drain snapshot.

  Zero work for recycled rows always applies on the main thread before
  the dispatch."""
  losses: List[float] = []
  it = iter(batches)
  cur = next(it, None)
  if cur is None:
    return losses
  reg = trainer.telemetry
  prev_stepped = int(trainer.state["step"])
  pending = None  # (cats_t, vocab_metrics, zero) translated ahead for cur
  with HostWorker("dynvocab-overlap") as worker:
    while cur is not None:
      numerical, cats, labels = cur
      if pending is None:
        with _span("dynvocab/translate"):
          cats_t, vocab_metrics, zero = trainer.engine.translate_dynamic_ids(
              cats, trainer.translator)
      else:
        cats_t, vocab_metrics, zero = pending
        pending = None
      trainer._apply_zero(zero)  # a device write: main thread, pre-dispatch
      nxt = next(it, None)
      loss, metrics = trainer._dispatch(numerical, cats_t, labels)
      if on_dispatch is not None:
        on_dispatch()
      job = None
      if nxt is not None and not (
          defer_overlap(prev_stepped) if defer_overlap is not None
          else False):
        job = worker.submit(_dynvocab_translate_job, trainer, nxt[1],
                            label="dynvocab/translate_ahead")
      loss = float(loss)  # the host read ending the device window
      trainer._dev_span.finish()
      # join the worker BEFORE the accounting: a guard rollback restores
      # the translator, and must never race an in-flight translation
      if job is not None:
        with _timed("dynvocab/overlap_wait", reg) as w:
          pending, job_s = worker.result(job)
        _hidden(reg, "dynvocab/overlap_hidden_s", job_s, w.elapsed)
      if account is not None:
        account(metrics, vocab_metrics)
      else:
        if trainer.guard:
          trainer._account(metrics)
        else:
          trainer.steps += 1
        trainer.account_vocab(vocab_metrics)
      losses.append(loss)
      prev_stepped = int(trainer.state["step"])
      stop = bool(after_step(loss, metrics, prev_stepped,
                             pending is not None)) \
          if after_step is not None else False
      if (stop and pending is None) or nxt is None:
        break
      # a stop with a translated batch pending falls through: cur is the
      # pending batch, no new job is submitted (defer_overlap sees the
      # drain), and the next after_step stops with pending None
      cur = nxt
  return losses

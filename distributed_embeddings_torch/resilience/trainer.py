"""ResilientTrainer: snapshot / guard / auto-resume around the fused step
(PyTorch port of ``resilience/trainer.py``).

The training loop a preemptible multi-day run actually needs, as a thin
host-side wrapper over ``training.make_sparse_train_step(guard=True)``:

- **periodic durable snapshots** (``durable.save_rotating``: fsync +
  checksummed-manifest-last + atomic rename + rotation, with
  retry/backoff around the I/O);
- **auto-resume**: construction restores the newest VALID checkpoint
  under the checkpoint root (corrupted latest falls back), so restarting
  the same script after a kill continues the run — the caller only has
  to skip the already-consumed batches (``trainer.consumed`` says how
  many);
- **non-finite guard accounting**: the guarded step skips a bad batch
  (nothing commits, the step counter holds); this loop counts the skips
  and aborts-with-rollback after ``max_consecutive_bad`` consecutive
  skips — one NaN batch is an upstream data bug, K in a row means the
  run itself has diverged and retrying batches cannot fix it;
- **OOV policy enforcement**: per-class out-of-vocabulary counters from
  the step metrics accumulate here, and ``plan.oov == "error"`` turns a
  nonzero count into an immediate host-side error;
- **dedup-capacity overflow**: under a plan's ``dedup_capacity`` the
  step's per-class ``dedup_overflow`` counts accumulate into
  ``dedup_overflow_totals`` and the ``train/dedup_overflow/<class>``
  counters, and travel with the checkpoint (``extra`` and ``telemetry``
  sections) as the OOV counts do.

Skipped-batch semantics: a skipped batch is as if it never arrived — the
committed state and step counter are bit-identical to a run fed the same
stream without that batch.

The checkpoints are the JAX package's (``ckpt_<step>`` directories with
the ``extra`` and ``telemetry`` sections), so either package's trainer
resumes the other's root. At world N every rank builds a trainer with
its mesh and calls :meth:`step` / :meth:`snapshot` alike; the step's
metrics are already reduced over the ranks, so every rank takes the same
skip, abort and rollback decisions.

Tiered mode (``tiered=``, a guarded ``tiering.TieredTrainer``): every
:meth:`ResilientTrainer.step` runs the tiered protocol (classify, stage,
device step, write-back, re-rank) on a HOST batch with this trainer's
guard accounting; snapshots checkpoint the ``HostTierStore`` (a frozen
``snapshot_view`` for async ones) and every resume restores it and
refreshes the prefetcher's device resident maps.

Dynvocab mode (``dynvocab=``, a guarded ``dynvocab.DynVocabTrainer``):
every step translates a HOST batch of raw ids (the id space consumes
guard-skipped batches too, as the stream position does), re-zeroes
recycled rows and steps, with this trainer's guard accounting; snapshots
persist the id space through the checkpoint's ``vocab`` section and every
resume or rollback restores it in place. Snapshots there are synchronous
(the translator is live host state every step mutates).

With ``overlap_host=True`` (tiered or dynvocab mode) the next batch's
host pass runs on the pipeline's worker thread while the card runs this
step (``pipeline.run_tiered_overlapped`` / ``run_dynvocab_overlapped``),
bit-equal to the serial loop, snapshots and drains included.

:meth:`ResilientTrainer.resize` changes the world in the run
(``resilience/elastic``): in one process it re-shards the whole-world
state in memory; across processes (``pod_dir=``) the pod meets at a
file barrier, the old world spills itself into the pod directory, the
default process group is formed again at the new world, and each rank
of the new world reads its own blocks back, while a process outside it
parks (it holds no state and takes part in the next resize, which may
bring it back). ``consumed == step_count + skipped_steps`` holds across
every shrink and grow.

A streaming run passes its ``streaming.DeltaPublisher`` as ``stream=``:
every snapshot carries the publisher's chain state (the checkpoint's
``stream`` section and ``stream.npz``), every resume re-attaches it to
the publish directory's chain (``DeltaPublisher.attach``: the orphaned
tail's rows are re-stamped, a forked chain is refused naming the field),
and a resize re-roots the chain with the reason recorded in the new
base's manifest.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, List, Optional

import torch

from .. import telemetry as _telemetry
from ..telemetry import span as _span
from ..telemetry.flight import flight_trip as _flight_trip
from . import durable, guards, retry


class TooManyBadSteps(RuntimeError):
  """Raised after ``max_consecutive_bad`` consecutive non-finite steps.

  The trainer's state has already been ROLLED BACK to the newest valid
  checkpoint when this raises (or left at the last committed state when
  no checkpoint exists yet), so a supervising process may inspect,
  adjust (e.g. lower the learning rate), and resume from a known-good
  point."""

  def __init__(self, msg: str, resumed_step: Optional[int]):
    super().__init__(msg)
    self.resumed_step = resumed_step


def _state_device(state: Dict[str, Any], mesh) -> torch.device:
  """Where the state lives: the mesh's device, else its first tensor's."""
  if mesh is not None:
    return mesh.device
  for part in ("fused", "dense", "emb_dense"):
    for t in state[part].values():
      return t.device
  raise ValueError("the train state holds no tensor to place batches by")


def _host_copy(state: Dict[str, Any]) -> Dict[str, Any]:
  """A copy of a train state on the host that no later step can change:
  every tensor copied (``.cpu()`` of a CPU tensor would alias it), the
  optimizers rebuilt over the copies with their states installed."""
  from ..convert import install_optax_state, optax_state_of
  from ..training import OptaxState, rebind_optimizer

  def copy(t):
    return t.detach().to("cpu", copy=True)

  out = {"fused": {k: copy(v) for k, v in state["fused"].items()},
         "dense": {k: copy(v) for k, v in state["dense"].items()},
         "emb_dense": {k: copy(v) for k, v in state["emb_dense"].items()},
         "step": int(state["step"])}
  for part in ("dense", "emb_dense"):
    opt = state.get(f"{part}_opt")
    if opt is None or isinstance(opt, OptaxState):
      out[f"{part}_opt"] = opt
      continue
    bound = rebind_optimizer(opt, list(out[part].values()))
    install_optax_state(bound, out[part], optax_state_of(opt, state[part]))
    out[f"{part}_opt"] = bound
  return out


def _fetch(loss, metrics):
  """The loss and the metrics on the host in ONE copy: packed into one
  float64 tensor (exact for f32 losses and int32 counters) on their
  device, then moved. Returns ``(loss, bad_step, oov, dedup_overflow)``
  (the last empty without a ``dedup_capacity``)."""
  names = sorted(metrics["oov"])
  ovf = metrics.get("dedup_overflow", {})
  ovf_names = sorted(ovf)
  loss = torch.as_tensor(loss)
  vals = torch.stack([torch.as_tensor(v).to(loss.device, torch.float64)
                      for v in [loss, metrics["bad_step"]] +
                      [metrics["oov"][n] for n in names] +
                      [ovf[n] for n in ovf_names]]).cpu()
  host = vals.tolist()
  cut = 2 + len(names)
  return (host[0], int(host[1]),
          {n: int(v) for n, v in zip(names, host[2:cut])},
          {n: int(v) for n, v in zip(ovf_names, host[cut:])})


class ResilientTrainer:
  """Owns the train state and the durability/guard protocol around it.

  Args:
    step_fn: a GUARDED fused train step — built by
      ``training.make_sparse_train_step(..., guard=True)`` — returning
      ``(state, loss, metrics)`` with ``metrics = {'bad_step', 'oov'[,
      'dedup_overflow']}``.
    state: the initial train state (replaced by the checkpointed state
      when ``resume=True`` finds one); its device is where the trainer
      places batches and restores checkpoints (the mesh's at world N).
    plan / rule: the placement plan and sparse rule (checkpoint identity).
    ckpt_root: directory of rotated ``ckpt_<step>`` checkpoints.
    mesh: this rank's mesh at world N (every rank builds a trainer).
    snapshot_every: durable snapshot every N COMMITTED steps (0 = only
      explicit :meth:`snapshot` calls).
    keep: checkpoint rotation depth.
    max_consecutive_bad: abort-with-rollback threshold (None = never
      abort, count forever).
    resume: restore the newest valid checkpoint at construction.
    retry_policy: backoff policy for checkpoint I/O.
    async_snapshots: periodic snapshots copy the state to the host and
      hand the file writes to a background writer thread (see
      :meth:`snapshot`), so training steps proceed while the checkpoint
      lands on disk.
    telemetry: the ``telemetry.MetricsRegistry`` this trainer emits
      through (default: the process-wide registry). Snapshots persist its
      cumulative state under the checkpoint manifest's ``telemetry``
      section and the first resume of a fresh process adopts it.
    tiered: a GUARDED ``tiering.TieredTrainer``: :meth:`step` then runs
      its protocol on HOST batches (``step_fn`` must be None and ``state``
      may be None: the TieredTrainer's are used), its tier bookkeeping
      stays with it (``account_tier``, the ``missed > 0`` contract) and
      the guard accounting is this trainer's. Snapshots flush and
      checkpoint its store; a resume restores the store and refreshes the
      prefetcher's resident maps.
    store: the ``HostTierStore`` of a tiered plan (default: the
      TieredTrainer's), passed to every checkpoint save and restore.
    dynvocab: a GUARDED ``dynvocab.DynVocabTrainer``: :meth:`step` then
      runs its translate / re-zero / step protocol on HOST batches of raw
      ids (``step_fn`` must be None and ``state`` may be None: the
      DynVocabTrainer's are used); the lifecycle counters stay with it
      (``account_vocab``), the guard accounting is this trainer's, and
      its translator rides every snapshot (``vocab=``) and resume.
      Incompatible with ``tiered=`` and ``async_snapshots``.
    overlap_host: tiered or dynvocab mode: :meth:`run` takes the next
      batch's host pass on the pipeline's worker thread while the card
      runs this step, bit-equal to the serial loop.
    stream: the run's ``streaming.DeltaPublisher`` (at world N this
      rank's): every snapshot persists its chain state, and every resume
      (auto-resume and the abort path's rollback alike) re-attaches it to
      the publish directory's chain before the next publication; a
      :meth:`resize` re-roots the chain. Incompatible with
      ``async_snapshots``.
  """

  def __init__(self, step_fn, state: Dict[str, Any], plan, rule,
               ckpt_root: str, mesh=None,
               snapshot_every: int = 0, keep: int = 3,
               max_consecutive_bad: Optional[int] = 3,
               resume: bool = True, store=None,
               retry_policy: retry.RetryPolicy = retry.DEFAULT_POLICY,
               async_snapshots: bool = False,
               tiered=None, dynvocab=None, telemetry=None, stream=None,
               overlap_host: bool = False):
    self.stream = stream
    if stream is not None and async_snapshots:
      raise NotImplementedError(
          "async_snapshots with a DeltaPublisher (stream=...): the "
          "publisher's tracker stamps are live host state every "
          "observe_batch mutates — a background save would tear the "
          "chain state it seals (same limit as the translator). "
          "Snapshot streaming runs synchronously.")
    if overlap_host and tiered is None and dynvocab is None:
      raise ValueError(
          "overlap_host=True without a tiered or dynvocab trainer: the "
          "sparse step has no per-step host pass to overlap (its batch "
          "sharding is already inside the device dispatch). Drop the "
          "flag, or wrap the host pass you mean into a TieredTrainer/"
          "DynVocabTrainer.")
    self.overlap_host = overlap_host
    # The metrics registry this trainer emits through (and persists:
    # snapshots write its state into the checkpoint manifest's
    # ``telemetry`` section, and the FIRST resume of a fresh process
    # adopts the persisted values — the same never-double-count
    # discipline as the skip/OOV counters below; a mid-run rollback
    # keeps the observed counts).
    self.telemetry = telemetry if telemetry is not None \
        else _telemetry.get_registry()
    self.dynvocab = dynvocab
    if dynvocab is not None:
      # the trainer drives the guarded DynVocabTrainer's translate /
      # re-zero / step protocol and owns the durability and guard
      # accounting; snapshots persist the id space (translation table,
      # sketch, freelist, cumulative counters) through the manifest's
      # vocab section, and resume or rollback restores it IN PLACE
      if tiered is not None:
        raise NotImplementedError(
            "tiered= with dynvocab=: the dynamic-id translation and the "
            "tiered classify are separate host passes that do not "
            "compose yet (make_tiered_train_step refuses oov='allocate' "
            "for the same reason).")
      if not getattr(dynvocab, "guard", False):
        raise ValueError(
            "ResilientTrainer(dynvocab=...) needs a DynVocabTrainer "
            "built with guard=True: the resilience accounting reads the "
            "guarded step's {'bad_step', 'oov'} metrics, and under "
            "oov='allocate' the in-trace OOV counter doubles as the "
            "raw-ids-leaked-past-the-translator tripwire.")
      if step_fn is not None:
        raise ValueError(
            "ResilientTrainer(dynvocab=...) drives the DynVocabTrainer's "
            "own step; pass step_fn=None (the two would race on the "
            "state).")
      if async_snapshots:
        raise NotImplementedError(
            "async_snapshots with a dynvocab trainer: checkpoint.save "
            "serializes the translator's live host state (mapping, "
            "sketch, freelist), which every step's translate pass "
            "mutates — a background save would tear it. (The tiered "
            "store solved this with a copy-on-snapshot view; the "
            "translator has no equivalent frozen surface yet.)")
      dynvocab.telemetry = self.telemetry
      state = dynvocab.state if state is None else state
    self.vocab = dynvocab.translator if dynvocab is not None else None
    self.tiered = tiered
    if tiered is not None:
      if not getattr(tiered, "guard", False):
        raise ValueError(
            "ResilientTrainer(tiered=...) needs a TieredTrainer built "
            "with guard=True: the resilience accounting reads the "
            "guarded step's {'bad_step', 'oov'} metrics, and an "
            "unguarded tiered step surfaces neither (a poison batch "
            "would commit into the host images).")
      if step_fn is not None:
        raise ValueError(
            "ResilientTrainer(tiered=...) drives the TieredTrainer's own "
            "step; pass step_fn=None (the two would race on the state).")
      # the wrapped trainer and its prefetcher emit through this registry,
      # so the whole protocol's counters persist together
      tiered.telemetry = self.telemetry
      tiered.prefetcher.telemetry = self.telemetry
      state = tiered.state if state is None else state
      store = tiered.store if store is None else store
    self.store = store
    # a resize keeps the mode when this process parks (tiered= is dropped
    # with the state) and a grow brings it back
    self._tiered_mode = tiered is not None
    self._step_fn = step_fn
    self.state = state
    self.plan = plan
    self.rule = rule
    self.ckpt_root = ckpt_root
    self.mesh = mesh
    self.device = _state_device(state, mesh)
    self.snapshot_every = snapshot_every
    self.keep = keep
    self.retry_policy = retry_policy
    self._bad = guards.BadStepCounter(max_consecutive_bad)
    self.oov_totals: Dict[str, int] = {}
    # per-class dedup-capacity overflow totals (plans with dedup_capacity:
    # the counter that keeps the smaller cap observable; empty, and
    # absent from snapshots and the summary, otherwise)
    self.dedup_overflow_totals: Dict[str, int] = {}
    self.resumed_from: Optional[str] = None
    self.async_snapshots = async_snapshots
    self._writer: Optional[threading.Thread] = None
    self._writer_err: Optional[BaseException] = None
    # Stream position: batches CONSUMED (committed + skipped). Differs
    # from the state's step counter by the number of guard-skipped
    # batches, and is what exact stream resumption needs — resuming at
    # stream[step_count:] would re-apply a committed batch for every
    # skip that preceded the snapshot. Persisted in each checkpoint's
    # manifest (``extra``) and restored with it.
    self.consumed = 0
    # SIGTERM graceful drain (install_sigterm_drain): the preemption
    # NOTICE path — finish the in-flight step, snapshot, exit clean
    self._drain_requested = threading.Event()
    self._drained = threading.Event()  # watchdog disarm (set on failure too)
    self._drain_ok = False             # drain snapshot durably on disk
    self.drain_deadline_s: Optional[float] = None
    self._last_snapshot = self.step_count if not resume else None
    if resume:
      self.maybe_resume()
      if self._last_snapshot is None:
        self._last_snapshot = self.step_count

  # ---- resume / snapshot -------------------------------------------------
  @property
  def step_count(self) -> int:
    """Committed steps so far (the state's step counter)."""
    return int(self.state["step"])

  @property
  def parked(self) -> bool:
    """This process sits outside the pod's current world (a resize left
    it without state); the next resize may bring it back."""
    return self.state is None

  @property
  def skipped_steps(self) -> int:
    """Skips in the logical run: a fresh process resuming a checkpoint
    adopts its persisted count (so ``consumed == step_count +
    skipped_steps`` survives restarts), then counts what it observes. A
    mid-run rollback does NOT rewind it — the skips happened."""
    return self._bad.skipped

  @property
  def writer_active(self) -> bool:
    """True while a background snapshot writer is still flushing."""
    return self._writer is not None and self._writer.is_alive()

  def join_writer(self) -> None:
    """Wait for an in-flight async snapshot and re-raise its failure.

    Called automatically before the next snapshot (so at most one writer
    ever runs, preserving the crc32-manifest-last / rotate-after-publish
    ordering) and before a rollback resume; call it explicitly before
    process exit — a snapshot still buffered when the process dies was
    never durable."""
    w, self._writer = self._writer, None
    if w is not None:
      w.join()
    if self._writer_err is not None:
      err, self._writer_err = self._writer_err, None
      raise err

  def close(self) -> None:
    """Flush pending async work (alias for :meth:`join_writer`)."""
    self.join_writer()

  def maybe_resume(self) -> bool:
    """Restore the newest valid checkpoint under ``ckpt_root`` into
    ``self.state``; False when none exists (fresh start). The restored
    state's optimizers are new ones of the run's kind, bound to its
    tensors, so the step (which reads them from the state) continues from
    the checkpoint's optimizer states."""
    self.join_writer()  # never scan the root under a concurrent save
    got = durable.restore_latest(self.ckpt_root, self.plan, self.rule,
                                 self.state, mesh=self.mesh,
                                 store=self.store, vocab=self.vocab,
                                 stream=self.stream, device=self.device)
    if got is None:
      return False
    from .. import checkpoint
    first_resume = self.consumed == 0
    self.state, step, path = got
    if self.tiered is not None:
      # the restore rewrote the store's images and resident sets: point
      # the TieredTrainer at the restored state and re-derive its device
      # resident maps (classifying against the pre-restore maps would
      # stage the wrong cold rows)
      self.tiered.state = self.state
      self.tiered.prefetcher.refresh_resident()
    if self.dynvocab is not None:
      # the restore loaded the id space into the translator in place;
      # only the state pointer moves
      self.dynvocab.state = self.state
    if self.stream is not None and not self.stream.attached:
      # the restore loaded chain state the publisher has not validated
      # against the pubdir yet: re-attach now (auto-resume and the abort
      # path's rollback both land here). Deltas published past the
      # restored watermark are re-validated and their rows re-stamped
      # before the next publication; a forked or diverged chain raises
      # ChainDivergedError naming the field, after a flight bundle
      try:
        self.stream.attach()
      except Exception as e:
        field = getattr(e, "field", None)
        if field is not None:
          _flight_trip("chain_diverged", field=field, error=repr(e),
                       resumed_from=path, step=step)
        raise
    manifest = checkpoint.read_manifest(path)
    if first_resume:
      # adopt the persisted cumulative telemetry along with the stream
      # position — a fresh process resuming a run continues its counts
      # instead of restarting them at zero. A mid-run rollback keeps the
      # observed values (those events happened), like the skip/OOV
      # adoption below.
      sec = manifest.get("telemetry")
      if sec is not None:
        self.telemetry.load_state_dict(sec)
    self.resumed_from = path
    self._last_snapshot = step
    extra = manifest.get("extra", {})
    # checkpoints written outside this trainer carry no consumed count;
    # step is then the best (and with no skips, exact) stream position
    self.consumed = int(extra.get("consumed", step))
    if first_resume:
      # A process that has consumed nothing yet adopts the run's
      # persisted skip/OOV accounting along with its stream position. A
      # mid-run rollback (abort path) keeps the counts this process
      # observed: those skips and clipped ids really happened.
      self._bad.skipped = int(extra.get("skipped", 0))
      self.oov_totals = {str(k): int(v)
                         for k, v in extra.get("oov", {}).items()}
      self.dedup_overflow_totals = {
          str(k): int(v)
          for k, v in extra.get("dedup_overflow", {}).items()}
    return True

  # ---- elastic resize (the in-run world change) ---------------------------
  def _template(self) -> Dict[str, Any]:
    """What a resize's new state is assembled by: the state itself, or
    in a parked process its skeleton (the dense names and shapes, the
    optimizers' kinds)."""
    return self.state if self.state is not None else self._skeleton

  def resize(self, new_plan, step_fn=None, *, new_mesh=None,
             new_store=None, tiered_factory=None, reason: str = "",
             spill_dir=None, pod_dir=None, barrier_epoch=None,
             member_id=None, n_participants=None,
             barrier_timeout_s: float = 60.0):
    """Change the world in the run: quiesce, re-shard every rank block
    (``resilience.elastic.elastic_resize``, the regroup engine of the
    elastic restore), swap in the new world's step function, and go on.
    ``resumed_from`` and the checkpoint root are untouched, and the
    accounting (``consumed``, ``skipped_steps``, the OOV and overflow
    totals, the bad-step streak) carries across: ``consumed ==
    step_count + skipped_steps`` holds through any shrink and grow.

    Sparse mode: ``step_fn`` built against the new plan and ``new_mesh``.
    Tiered mode: ``new_store`` (the new world's ``HostTierStore``; the
    re-sharded images land in it, the observed counts re-mapped) and
    ``tiered_factory(new_state) -> TieredTrainer`` built around it; the
    new trainer takes over the old one's prefetcher
    (``TieredPrefetcher.rebind`` to the new plan and store, its gather,
    spill and retry counters kept) and its hit, skip and OOV
    bookkeeping.

    In one process (no ``pod_dir``) the state holds every rank's blocks
    before and after. Across processes pass ``pod_dir``,
    ``barrier_epoch`` (one per membership change, the same on every
    participant), ``member_id`` and ``n_participants`` (every process
    taking part: the old world's, and any joining or staying parked):
    they first agree on one step boundary at the membership barrier
    (``elastic.membership_barrier``; a parked process posts no step),
    then the old world spills itself into ``spill_dir`` (default
    ``<pod_dir>/spill``), the default process group is formed again at
    the new world (``new_mesh``, this process's rank in it, e.g. from
    ``elastic.member_rank``; None: this process parks) and each rank
    reads its own blocks back. A process that joins from parking adopts
    the run's accounting and telemetry from the spill.

    ``new_plan`` may be a world size. Returns the new plan. A
    ``DeltaPublisher`` (``stream=``) is re-rooted on the new world
    (``DeltaPublisher.re_root``: a full base under the new plan, counted
    ``stream/re_roots``, with ``reason`` or the world change recorded in
    its manifest; the chain's plan fingerprint pins the world, so no
    subscriber would accept the old chain's next delta). At world N the
    re-root is collective over the new world's ranks; a parked process
    does not publish."""
    from . import elastic as _elastic

    if self.dynvocab is not None:
      raise NotImplementedError(
          "resize with dynvocab=...: the translator state is "
          "world-free, but the DynVocabTrainer's translate/step wiring "
          "is not rebuilt in place yet — snapshot and relaunch at the "
          "new world instead (the elastic restore path preserves the id "
          "space exactly).")
    if self.writer_active:
      # an in-flight async snapshot reads the OLD state's buffers
      self.join_writer()
    was_parked = self.parked
    joining = pod_dir is None or new_mesh is not None
    if joining and self._tiered_mode:
      if tiered_factory is None or new_store is None:
        raise ValueError(
            "resize of a tiered trainer needs new_store (the new "
            "world's HostTierStore) and tiered_factory(new_state) -> "
            "TieredTrainer built around it")
    elif joining and step_fn is None:
      raise ValueError(
          "resize needs the new world's step_fn (build it with "
          "make_sparse_train_step against the new plan/mesh before "
          "calling resize)")
    pod = None
    if pod_dir is not None:
      if barrier_epoch is None or member_id is None \
          or n_participants is None:
        raise ValueError(
            "a membership-change barrier needs barrier_epoch (one per "
            "membership change, same on every survivor), member_id and "
            "n_participants (the agreed survivor count) along with "
            "pod_dir")
      if spill_dir is None:
        spill_dir = os.path.join(pod_dir, "spill")
      _elastic.membership_barrier(
          pod_dir, barrier_epoch, member_id, n_participants,
          step=None if was_parked else self.step_count,
          world=self.plan.world_size, timeout_s=barrier_timeout_s)
      self.telemetry.counter("elastic/membership_barriers").inc()
      pod = _elastic.PodSync(pod_dir, int(barrier_epoch), member_id,
                             int(n_participants), barrier_timeout_s)
    elif self.mesh is not None and self.mesh.world > 1:
      raise ValueError(
          "this trainer runs one rank of a process group; pass pod_dir "
          "(with barrier_epoch, member_id, n_participants) so that the "
          "pod can meet while the group is formed again at the new world")
    elif new_mesh is not None:
      raise ValueError(
          "new_mesh without pod_dir: a resize in one process re-shards the "
          "whole-world state it holds (no mesh before or after)")
    manifest: Dict[str, Any] = {}
    new_plan, new_state = _elastic.elastic_resize(
        self.state, self.plan, new_plan, self.rule, new_mesh=new_mesh,
        old_mesh=self.mesh if pod is not None else None,
        old_store=self.store, new_store=new_store,
        telemetry=self.telemetry, spill_dir=spill_dir, pod=pod,
        state_like=self._template(), extra=self._extra(),
        manifest_out=manifest)
    if new_state is None:
      self._park(new_plan)
      return new_plan
    if was_parked:
      self._adopt(manifest)
    if self._tiered_mode:
      old_t = self.tiered
      new_t = tiered_factory(new_state)
      if not getattr(new_t, "guard", False):
        raise ValueError(
            "tiered_factory must build a guard=True TieredTrainer (the "
            "same requirement as ResilientTrainer(tiered=...)).")
      new_t.telemetry = self.telemetry
      if old_t is not None:
        # the bookkeeping of the run survives the resize
        new_t.steps = old_t.steps
        new_t.bad_steps = old_t.bad_steps
        new_t.oov_totals = dict(old_t.oov_totals)
        new_t.dedup_overflow_totals = dict(old_t.dedup_overflow_totals)
        for name, m in old_t.hits.items():
          if name in new_t.hits:
            new_t.hits[name] = new_t.hits[name] + m
        pf = old_t.prefetcher
        pf.rebind(new_t.tplan, new_t.store, mesh=new_t.mesh,
                  device=new_t.device)
        new_t.prefetcher = pf
      new_t.prefetcher.telemetry = self.telemetry
      new_t.state = new_state
      new_t.prefetcher.refresh_resident()
      self.tiered = new_t
      self.store = new_t.store
    else:
      self._step_fn = step_fn
      self.store = new_store
    old_world = self.plan.world_size
    self.state = new_state
    self.plan = new_plan
    self.mesh = new_mesh
    self.device = _state_device(new_state, new_mesh)
    if self.stream is not None:
      from ..streaming.generations import RowGenerationTracker
      self.stream.re_root(
          self.state,
          reason=reason or (f"elastic resize world {old_world} -> "
                            f"{new_plan.world_size}"),
          plan=new_plan, tracker=RowGenerationTracker(new_plan),
          store=self.store, mesh=new_mesh)
    return new_plan

  def _park(self, new_plan) -> None:
    """Leave the world: drop the state (keeping its skeleton for the
    resize that brings this process back) and the step."""
    from ..training import OptaxState, rebind_optimizer
    like = self._template()

    def meta(part):
      return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in like[part].items()}

    def kind(opt):
      if opt is None or isinstance(opt, OptaxState):
        return opt
      return rebind_optimizer(opt, [torch.zeros(1, requires_grad=True)])

    self._skeleton = {"dense": meta("dense"), "emb_dense": meta("emb_dense"),
                      "dense_opt": kind(like.get("dense_opt")),
                      "emb_dense_opt": kind(like.get("emb_dense_opt"))}
    self.state = None
    self.tiered = None
    self.store = None
    self._step_fn = None
    self.mesh = None
    self.plan = new_plan

  def _adopt(self, manifest: Dict[str, Any]) -> None:
    """A process back from parking takes the run's accounting and
    telemetry from the spill (the survivors' own)."""
    extra = manifest.get("extra", {})
    self.consumed = int(extra.get("consumed", manifest["step"]))
    self._bad.skipped = int(extra.get("skipped", 0))
    self.oov_totals = {str(k): int(v)
                       for k, v in extra.get("oov", {}).items()}
    self.dedup_overflow_totals = {
        str(k): int(v) for k, v in extra.get("dedup_overflow", {}).items()}
    if manifest.get("telemetry") is not None:
      self.telemetry.load_state_dict(manifest["telemetry"])
    self._last_snapshot = int(manifest["step"])

  # ---- SIGTERM graceful drain (the preemption NOTICE path) ---------------
  def install_sigterm_drain(self, deadline_s: float = 30.0) -> None:
    """Arm the preemption-notice path: on SIGTERM, finish the in-flight
    step, take one durable snapshot, and let the caller exit 0 — all
    within ``deadline_s`` of the signal.

    The handler only sets a flag (Python delivers it between bytecodes
    of the main thread, so a step already running finishes first —
    exactly "finish the in-flight step") and arms a watchdog. :meth:`run`
    checks the flag after every step and calls :meth:`maybe_drain`;
    custom loops call it themselves. The watchdog guards HANGS, not
    failures: if the drain has not completed when the deadline passes it
    hard-exits (status 3) — the notice window is about to end in a
    SIGKILL, and dying now with the previous checkpoint intact beats
    dying mid-manifest later. A snapshot that RAISES disarms the watchdog
    and propagates — the caller exits nonzero promptly on its own.

    Main-thread only (``signal.signal``'s own constraint); call once,
    early."""
    import signal

    self.drain_deadline_s = float(deadline_s)

    def _handler(signum, frame):
      del signum, frame
      if self._drain_requested.is_set():
        return  # a second notice changes nothing; the first deadline holds
      self._drain_requested.set()
      # deadline watchdog, not step work: it must outlive a wedged step
      threading.Thread(target=self._drain_watchdog,
                       name="sigterm-drain-watchdog", daemon=True).start()

    signal.signal(signal.SIGTERM, _handler)

  def _drain_watchdog(self) -> None:
    if not self._drained.wait(self.drain_deadline_s):
      os._exit(3)  # drain overran the notice window: see install docstring

  @property
  def drain_requested(self) -> bool:
    """A SIGTERM preemption notice arrived (drain pending or done)."""
    return self._drain_requested.is_set()

  @property
  def drained(self) -> bool:
    """The drain snapshot is durably on disk; exiting 0 is safe. False
    while the drain is pending AND after a drain snapshot that RAISED."""
    return self._drain_ok

  def maybe_drain(self) -> bool:
    """Complete a requested SIGTERM drain; returns True when the caller
    should stop feeding batches and exit 0 (False: no notice arrived,
    keep training). Idempotent on success — the snapshot is taken once
    and repeated calls keep returning True; a snapshot that RAISES
    propagates (the caller exits nonzero) and the next call retries it,
    so :attr:`drained` only ever turns True on a durable snapshot."""
    if not self._drain_requested.is_set():
      return False
    if not self._drain_ok:
      try:
        self.join_writer()
        self.snapshot()
        self.telemetry.counter("train/sigterm_drains").inc()
        self._drain_ok = True
      finally:
        # disarm the watchdog on failure too: the raised exception
        # propagates to the caller, which exits nonzero on its own
        self._drained.set()
    return True

  def _extra(self) -> Dict[str, Any]:
    extra = {"consumed": self.consumed, "skipped": self.skipped_steps,
             "oov": dict(self.oov_totals)}
    if self.dedup_overflow_totals:
      extra["dedup_overflow"] = dict(self.dedup_overflow_totals)
    return extra

  def snapshot(self, async_: bool = False) -> str:
    """Durably checkpoint the current state (rotating, with retry).

    ``async_=True`` copies the state to the host SYNCHRONOUSLY (a real
    copy: the step updates the state in place, and on the CPU ``.cpu()``
    would alias it) and hands the file writes, manifest sealing and
    pruning to a background thread, so training proceeds while the bytes
    land. The previous writer is always joined first — with its error
    re-raised — so at most one snapshot is in flight and the
    rotate-after-publish invariant holds; :meth:`join_writer` flushes
    before exit. World 1 only: the save's cross-rank barriers must run on
    every rank's main thread. A tiered run's store rides along as its
    copy-on-snapshot view (``store.snapshot_view``), reconciled here
    against this step's buffers, so the writer serializes frozen images
    while the per-step write-back keeps mutating the live ones."""
    self.join_writer()
    self.telemetry.counter("ckpt/snapshots").inc()
    extra = self._extra()
    if not async_:
      path = durable.save_rotating(self.ckpt_root, self.plan, self.rule,
                                   self.state, store=self.store,
                                   keep=self.keep, policy=self.retry_policy,
                                   extra=extra, vocab=self.vocab,
                                   telemetry=self.telemetry,
                                   stream=self.stream, mesh=self.mesh)
      self._last_snapshot = self.step_count
      return path
    if self.mesh is not None and self.mesh.world > 1:
      raise NotImplementedError(
          "snapshot(async_=True) under multi-controller: the save's "
          "publication barriers are collective and must run on every "
          "process's main thread. Use synchronous snapshots there.")
    if self.vocab is not None:
      raise NotImplementedError(
          "snapshot(async_=True) with a DynVocabTranslator: the save "
          "serializes the translator's live host state, which the next "
          "step's translate pass mutates — a background save would tear "
          "the id space it checksums. Snapshot dynvocab runs "
          "synchronously.")
    state_host = _host_copy(self.state)
    step_now = int(state_host["step"])
    # capture the registry synchronously, like the state: later steps
    # mutate the live counters while the writer flushes
    telemetry_state = self.telemetry.state_dict()
    # and the store the same way: a frozen reconciled copy of the images
    # (the save's flush is a no-op on the view)
    store_view = (self.store.snapshot_view(state_host["fused"])
                  if self.store is not None else None)

    def _write():
      try:
        durable.save_rotating(self.ckpt_root, self.plan, self.rule,
                              state_host, store=store_view, keep=self.keep,
                              policy=self.retry_policy, extra=extra,
                              telemetry=telemetry_state)
      except BaseException as e:  # surfaced at the next join_writer
        self._writer_err = e

    # I/O writer over frozen copies: it overlaps any number of steps and
    # joins at join_writer
    self._writer = threading.Thread(target=_write, daemon=True,
                                    name=f"ckpt-writer-{step_now}")
    self._writer.start()
    self._last_snapshot = step_now
    return durable.step_dir(self.ckpt_root, step_now)

  # ---- stepping ----------------------------------------------------------
  def _account(self, bad: int, counts: Dict[str, int],
               overflow: Dict[str, int]) -> None:
    # Account FIRST, enforce second: the oov='error' raise below must
    # leave every counter consistent with the already-incremented
    # consumed count — a supervisor that catches the documented error
    # and snapshots would otherwise persist a stream position whose
    # rejected batch appears in no counter, breaking
    # consumed == step_count + skipped_steps across the resume.
    reg = self.telemetry
    for name, n in counts.items():
      self.oov_totals[name] = self.oov_totals.get(name, 0) + n
      if n:
        reg.counter(f"train/oov/{name}").inc(n)
    # dedup_capacity overflow: aliased ids must stay observable, so they
    # are accumulated, summarized and persisted as the OOV counts are
    for name, n in overflow.items():
      if n:
        self.dedup_overflow_totals[name] = \
            self.dedup_overflow_totals.get(name, 0) + n
        reg.counter(f"train/dedup_overflow/{name}").inc(n)
    if bad:
      reg.counter("train/bad_step").inc(bad)
    may_continue = self._bad.update(bad)
    guards.check_oov(self.plan, counts, where="guarded step")
    if not may_continue:
      limit = self._bad.max_consecutive
      resumed = None
      if self.maybe_resume():
        resumed = self.step_count
      # the abort consumed this bad streak: a supervisor that catches the
      # exception and resumes gets the full K-consecutive allowance
      # again, not an instant re-abort on the next single bad step
      self._bad.consecutive = 0
      # the guard trip is exactly the moment the post-mortem needs a
      # flight bundle (no-op when no recorder is installed)
      _flight_trip("guard_abort", limit=limit, step=self.step_count,
                   consumed=self.consumed,
                   rolled_back_to=resumed,
                   checkpoint=self.resumed_from if resumed is not None
                   else None)
      raise TooManyBadSteps(
          f"{limit} consecutive non-finite steps: the run has diverged "
          "(skipping more batches cannot recover it). "
          + (f"State rolled back to checkpoint step {resumed} "
             f"({self.resumed_from})."
             if resumed is not None else
             "No valid checkpoint exists yet, so NO rollback happened — "
             "the state is the last committed (possibly diverged) one; "
             "do not resume from it without inspection."), resumed)

  def step(self, *batch) -> float:
    """One guarded step on a batch already on the state's device (this
    rank's slice at world N); returns the loss (NaN on a skipped step —
    the skip is counted, nothing commits). Tiered mode: ``batch`` is the
    GLOBAL HOST batch (the classify stage routes every rank's ids before
    the device sees them). Dynvocab mode: ``batch`` is the GLOBAL HOST
    batch of RAW ids (the translate pass needs them before any
    sharding)."""
    if self.tiered is not None:
      return self._step_tiered(*batch)
    if self.dynvocab is not None:
      return self._step_dynvocab(*batch)
    dev = _span("device/step", track="device").start()
    self.state, loss, metrics = self._step_fn(self.state, *batch)
    self.consumed += 1
    self.telemetry.counter("train/consumed").inc()
    # ONE host transfer for everything the accounting reads: one copy
    # per counter would cost a blocking device round-trip apiece
    loss, bad, counts, overflow = _fetch(loss, metrics)
    dev.finish()  # dispatch -> fetched: the device window
    self._account(bad, counts, overflow)
    if self.snapshot_every and \
        self.step_count - self._last_snapshot >= self.snapshot_every:
      self.snapshot(async_=self.async_snapshots)
    return loss

  def _step_tiered(self, numerical, cats, labels) -> float:
    """One guarded TIERED step: the TieredTrainer's prefetch, dispatch,
    write-back and re-rank with THIS trainer's guard accounting (skip
    counting, the consecutive-bad abort with rollback, ``oov='error'``);
    the tier hit bookkeeping and the ``missed > 0`` contract stay with
    the TieredTrainer. A skipped tiered batch leaves the host images
    bit-identical (the guarded step's write-back rewrites unchanged
    staging rows), so rollback carries over; on the abort path the resume
    restores the store and refreshes the prefetcher before raising."""
    t = self.tiered
    t.state = self.state
    staged = t.prefetcher.prepare(cats)
    staged_out, metrics, loss = t._dispatch(staged, numerical, cats, labels)
    self.consumed += 1
    self.telemetry.counter("train/consumed").inc()
    loss, bad, counts, overflow = _fetch(loss, metrics)
    t._dev_span.finish()  # the first host sync of the tiered step

    def account(m):
      t.account_tier(m["tier"])
      t.steps += 1
      self._account(bad, counts, overflow)

    t._finish(staged, staged_out, metrics, account=account)
    self.state = t.state
    if self.snapshot_every and \
        self.step_count - self._last_snapshot >= self.snapshot_every:
      self.snapshot(async_=self.async_snapshots)
    return loss

  def _step_dynvocab(self, numerical, cats, labels) -> float:
    """One guarded DYNVOCAB step: translate (the id space consumes the
    batch — allocation, admission counts, TTL clock), re-zero evicted
    rows, device step, with THIS trainer's guard accounting.

    The id space deliberately consumes guard-SKIPPED batches too — the
    same discipline as the ``consumed`` stream position: an unkilled
    reference run translates every batch, so a resumed run must as
    well, or the two id spaces diverge. Per-class lifecycle counters
    stay with the DynVocabTrainer (``account_vocab``); the cumulative
    totals live INSIDE the translator state, so snapshots persist them
    and restarts never double-count."""
    d = self.dynvocab
    d.state = self.state
    cats_t, vocab_metrics = d._translate(cats)
    loss, metrics = d._dispatch(numerical, cats_t, labels)
    self.consumed += 1
    self.telemetry.counter("train/consumed").inc()
    loss, bad, counts, overflow = _fetch(loss, metrics)
    d._dev_span.finish()
    d.account_vocab(vocab_metrics)
    d.steps += 1
    self.state = d.state
    self._account(bad, counts, overflow)
    if self.snapshot_every and \
        self.step_count - self._last_snapshot >= self.snapshot_every:
      self.snapshot()
    return loss

  def run(self, batches: Iterable, snapshot_final: bool = False
          ) -> List[float]:
    """Train over host batches of ``(numerical, cats, labels)`` (global
    batches at world N: each rank keeps its slice, ``training.
    shard_batch``). To resume an interrupted stream, feed the SAME stream
    minus the first ``trainer.consumed`` batches — the checkpointed
    stream position, which counts committed AND skipped batches."""
    from ..training import shard_batch

    if self.overlap_host:
      losses = (self._run_tiered_overlapped(batches)
                if self.tiered is not None
                else self._run_dynvocab_overlapped(batches))
      self.join_writer()
      if snapshot_final:
        self.snapshot()
      return losses
    losses = []
    for batch in batches:
      if self.tiered is not None or self.dynvocab is not None:
        # the prefetch or translate protocol shards it
        losses.append(self.step(*batch))
      else:
        sb = shard_batch(tuple(batch), self.mesh, device=self.device)
        losses.append(self.step(*sb))
      if self.maybe_drain():
        # SIGTERM preemption notice: the in-flight step finished and a
        # drain snapshot is durably down — stop consuming the stream (a
        # relaunch resumes at trainer.consumed, bit-exact)
        break
    self.join_writer()  # a run's last periodic snapshot must be durable
    if snapshot_final:
      self.snapshot()
    return losses

  def _on_dispatch(self) -> None:
    # the overlapped loop's stream-position hook: the serial steps'
    # consumed accounting, at the same point (right after the dispatch)
    self.consumed += 1
    self.telemetry.counter("train/consumed").inc()

  def _run_tiered_overlapped(self, batches: Iterable) -> List[float]:
    from ..pipeline import run_tiered_overlapped

    t = self.tiered
    t.state = self.state

    def account(m):
      # the split of _step_tiered: tier bookkeeping with the
      # TieredTrainer, guard verdict, OOV and rollback with this trainer
      _, bad, counts, overflow = _fetch(m["bad_step"], m)
      t.account_tier(m["tier"])
      t.steps += 1
      self._account(bad, counts, overflow)

    def after_step(loss, metrics, stepped, pending_ahead):
      del loss, metrics, pending_ahead  # the worker's job is pure:
      # snapshotting over it is safe (the flush writes resident rows, the
      # worker gathers cold ones), and the deferred apply_counts keeps
      # the persisted counts at exactly this step
      self.state = t.state
      if self.snapshot_every and \
          int(stepped) - self._last_snapshot >= self.snapshot_every:
        self.snapshot(async_=self.async_snapshots)
      return self.maybe_drain()

    return run_tiered_overlapped(t, batches, account=account,
                                 on_dispatch=self._on_dispatch,
                                 after_step=after_step)

  def _run_dynvocab_overlapped(self, batches: Iterable) -> List[float]:
    from ..pipeline import run_dynvocab_overlapped

    d = self.dynvocab
    d.state = self.state

    def account(metrics, vocab_metrics):
      _, bad, counts, overflow = _fetch(metrics["bad_step"], metrics)
      d.account_vocab(vocab_metrics)
      d.steps += 1
      self.state = d.state
      self._account(bad, counts, overflow)

    def defer_overlap(prev_stepped):
      # the translate-ahead job MUTATES the translator, so never submit
      # one when the NEXT step's hooks might snapshot: the periodic
      # predicate is conservative (a skipped step just loses one
      # overlap), and a drain notice stops look-ahead cold
      if self._drain_requested.is_set():
        return True
      return bool(self.snapshot_every) and \
          prev_stepped + 1 - self._last_snapshot >= self.snapshot_every

    def after_step(loss, metrics, stepped, pending_ahead):
      del loss, metrics
      self.state = d.state
      if self.snapshot_every and \
          int(stepped) - self._last_snapshot >= self.snapshot_every:
        self.snapshot()  # synchronous: dynvocab async snapshots refuse
      if pending_ahead:
        # the worker already translated the next batch into the id
        # space; consume it first, then drain — the translator clock
        # equals the consumed count at the drain snapshot
        return False
      return self.maybe_drain()

    return run_dynvocab_overlapped(d, batches, account=account,
                                   on_dispatch=self._on_dispatch,
                                   after_step=after_step,
                                   defer_overlap=defer_overlap)

  def metrics_summary(self) -> Dict[str, Any]:
    out = {
        "steps": self.step_count,
        "consumed": self.consumed,
        "skipped": self.skipped_steps,
        "consecutive_bad": self._bad.consecutive,
        "oov": dict(self.oov_totals),
        "resumed_from": self.resumed_from,
    }
    if self.dedup_overflow_totals:
      out["dedup_overflow"] = dict(self.dedup_overflow_totals)
    if self.dynvocab is not None:
      out["vocab"] = self.dynvocab.metrics_summary()["per_class"]
    return out

"""The delta stream's protocol in the port, at world 1 (port only).

Each case holds the port to the assertions of the JAX package's own
streaming test (``tests/test_streaming.py``), refusal fields and messages
included, on the port's train step, publisher and subscriber over
``tests/torch_stream_cases.py``'s cell:

- torn, manifest-less, out-of-order, forked and out-of-bounds deltas are
  refused with the field named, and the subscriber keeps serving the
  last valid state;
- a publish faulted at ``ckpt_write`` or ``ckpt_rename`` leaves nothing
  the subscriber reads, and its retry converges;
- a re-rooted chain rebases the subscriber;
- copy-on-promote under concurrent micro-batcher traffic: no request is
  dropped, and every answer is the answer of one published generation,
  never a mix;
- attach after a kill: superset re-publication, a pre-root snapshot, a
  forked or re-rooted chain refused, a crash in the tail walk;
- ``ResilientTrainer(stream=)``: the chain state rides every snapshot and
  a fresh trainer re-attaches;
- compaction, cold start from the compacted base, a crash mid-fold,
  retention under live heartbeats;
- back-pressure: throttle then coalesce, ``force``, expired heartbeats;
- two subscribers, poll jitter, retried and exhausted reads;
- tiered serving (f32): the fold equals a re-export, the extraction is
  flush-free, and the hot set follows the shipped counts;
- dynvocab: a raw id admitted by training is servable after one delta.
"""

import functools
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import torch_stream_cases as SC
from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch.resilience import faultinject, retry
from distributed_embeddings_torch.resilience.trainer import ResilientTrainer
from distributed_embeddings_torch.serving import (
    MicroBatcher,
    Rejected,
    ServeEngine,
    ServeTierConfig,
)
from distributed_embeddings_torch.serving import export as serve_export
from distributed_embeddings_torch.serving import load as serve_load
from distributed_embeddings_torch.streaming import (
    ChainDivergedError,
    DeltaCompactor,
    DeltaPublisher,
    DeltaSubscriber,
    RowGenerationTracker,
    artifact_bytes,
    delta_dirname,
    poll_phase,
    published_delta_seqs,
    read_heartbeats,
    write_heartbeat,
)
from distributed_embeddings_torch.streaming.publish import heartbeat_path
from distributed_embeddings_torch.telemetry import MetricsRegistry


class Cell:
  """A trained state, its publisher (base + one delta published) and a
  subscriber on the base."""

  def __init__(self, tmp_path, quantize="f32", pre=2, post=2,
               registry=None, seed=7):
    self.tmp = str(tmp_path)
    self.rng = np.random.default_rng(seed)
    self.plan, self.rule = SC.torch_plan(), SC.torch_rule()
    self.state = SC.torch_state(self.plan)
    self.step_fn = SC.torch_step(self.plan)
    self.quantize = quantize
    self.path = os.path.join(self.tmp, "pub")
    self.publisher = DeltaPublisher(self.path, self.plan, self.rule,
                                    RowGenerationTracker(self.plan),
                                    quantize=quantize, telemetry=registry)
    self.train(pre)
    self.publisher.publish_base(self.state)
    self.sub = self.subscriber(telemetry=registry)
    self.train(post)
    assert self.publisher.publish_delta(self.state) is not None

  def batch(self, b=4):
    return SC.mkbatch(self.rng, b)

  def train(self, n=1, publisher=None):
    """``n`` observed steps; returns the batches."""
    done = []
    for _ in range(n):
      bt = self.batch()
      (publisher or self.publisher).observe_batch(bt[1])
      self.state = SC.run_step(self.step_fn, self.state, bt)
      done.append(bt)
    return done

  def subscriber(self, **kw):
    return DeltaSubscriber.from_artifact(SC.TorchActsModel(), self.plan,
                                         self.path, device="cpu", **kw)

  def publisher_like(self, path=None):
    return DeltaPublisher(path or self.path, self.plan, self.rule,
                          RowGenerationTracker(self.plan),
                          quantize=self.quantize)

  def full(self, name="full", state=None):
    """A full re-export of ``state`` (default: the current one), loaded."""
    path = os.path.join(self.tmp, name)
    serve_export(path, self.plan, self.rule, state or self.state,
                 quantize=self.quantize)
    return serve_load(path, self.plan, device="cpu")

  def assert_serves_full(self, sub, state=None):
    art = self.full(state=state)
    for name, want in art.state["serve"].items():
      assert torch.equal(sub.engine.state["serve"][name].view(torch.uint8),
                         want.view(torch.uint8)), name
    probe = self.batch(8)
    np.testing.assert_array_equal(
        sub.predict(probe[0], probe[1]),
        ServeEngine(SC.TorchActsModel(), self.plan, art,
                    device="cpu").predict(probe[0], probe[1]))


# ---------------------------------------------------------------------------
# chain durability: torn, out-of-order, forked, faulted
# ---------------------------------------------------------------------------


def test_torn_delta_refused_and_skipped(tmp_path):
  reg = MetricsRegistry()
  c = Cell(tmp_path, registry=reg)
  dpath = os.path.join(c.path, "delta_000001")
  victim = sorted(f for f in os.listdir(dpath) if f.startswith("rows_"))[0]
  faultinject.bitflip_file(os.path.join(dpath, victim))
  probe = c.batch(4)
  before = c.sub.predict(probe[0], probe[1])
  assert c.sub.poll_once() == 0  # refused, not applied, not crashed
  assert c.sub.applied_seq == 0
  assert c.sub.last_refusal["field"] == "checksums"
  assert victim in c.sub.last_refusal["reason"]
  assert reg.counter("stream/deltas_refused").value == 1
  np.testing.assert_array_equal(c.sub.predict(probe[0], probe[1]), before)


def test_manifestless_tmp_dir_ignored(tmp_path):
  c = Cell(tmp_path)
  assert c.sub.poll_once() == 1
  os.makedirs(os.path.join(c.path, "delta_000002.tmp"))
  assert c.sub.poll_once() == 0
  assert c.sub.last_refusal is None


def test_out_of_order_seq_refused(tmp_path):
  c = Cell(tmp_path)
  c.train()
  assert c.publisher.publish_delta(c.state) is not None
  shutil.rmtree(os.path.join(c.path, "delta_000001"))
  assert c.sub.poll_once() == 0
  assert c.sub.last_refusal["field"] == "seq"
  assert c.sub.applied_seq == 0


def test_base_fingerprint_mismatch_refused_naming_field(tmp_path):
  c = Cell(tmp_path)
  mpath = os.path.join(c.path, "delta_000001", "manifest.json")
  with open(mpath) as f:
    manifest = json.load(f)
  manifest["base_fingerprint"] = "f" * 64  # a fork or a replay
  with open(mpath, "w") as f:
    json.dump(manifest, f)
  assert c.sub.poll_once() == 0
  assert c.sub.last_refusal["field"] == "base_fingerprint"
  assert "base_fingerprint" in c.sub.last_refusal["reason"]


def test_out_of_bounds_delta_rows_refused(tmp_path):
  """Re-sealed (the manifest's crc updated), so only the bounds check
  can catch it."""
  c = Cell(tmp_path)
  dpath = os.path.join(c.path, "delta_000001")
  victim = sorted(f for f in os.listdir(dpath) if f.startswith("rows_"))[0]
  fpath = os.path.join(dpath, victim)
  z = SC.npz_arrays(fpath)
  z["idx"][-1] = 10**9
  np.savez(fpath, **z)
  mpath = os.path.join(dpath, "manifest.json")
  with open(mpath) as f:
    manifest = json.load(f)
  manifest["checksums"][victim] = tck._crc32_file(fpath)
  with open(mpath, "w") as f:
    json.dump(manifest, f)
  assert c.sub.poll_once() == 0
  assert c.sub.applied_seq == 0
  assert c.sub.last_refusal["field"] == "rows"
  assert "1000000000" in c.sub.last_refusal["reason"]


@pytest.mark.parametrize("site", ["ckpt_write", "ckpt_rename"])
def test_faulted_publish_retries_and_converges(tmp_path, site):
  c = Cell(tmp_path)
  assert c.sub.poll_once() == 1
  c.train()
  seq_before = c.publisher.seq
  inj = faultinject.FaultInjector().crash_after(site, 0)
  with faultinject.injected(inj):
    with pytest.raises(faultinject.InjectedCrash):
      c.publisher.publish_delta(c.state)
  assert c.publisher.seq == seq_before
  assert c.sub.poll_once() == 0
  assert c.publisher.publish_delta(c.state) is not None
  assert c.sub.poll_once() == 1
  c.assert_serves_full(c.sub)


def test_publisher_rebase_resets_chain(tmp_path):
  """A restarted publisher (no tracker history) re-roots with a new base;
  the subscriber detects the fingerprint change and rebases. An explicit
  ``re_root`` records why in the base's manifest."""
  reg = MetricsRegistry()
  c = Cell(tmp_path, registry=reg)
  assert c.sub.poll_once() == 1
  old_base_fp = c.sub.base_fingerprint
  pub2 = c.publisher_like()
  c.train(publisher=pub2)
  pub2.publish_base(c.state)
  assert c.sub.poll_once() >= 1  # the rebase
  assert c.sub.base_fingerprint != old_base_fp
  assert c.sub.applied_seq == 0
  assert reg.counter("stream/rebases").value == 1
  c.assert_serves_full(c.sub)
  with pytest.raises(ValueError, match="requires a reason"):
    pub2.re_root(c.state, " ")
  prev = pub2.fingerprint
  pub2.re_root(c.state, "operator decision")
  note = tck.read_manifest(os.path.join(c.path, "base"))["extra"][
      "stream"]["re_rooted"]
  assert note == {"reason": "operator decision",
                  "prev_chain_root": prev, "prev_seq": 0,
                  "prev_fingerprint": prev}
  assert pub2.telemetry.counter("stream/re_roots").value >= 1


# ---------------------------------------------------------------------------
# copy-on-promote under live traffic
# ---------------------------------------------------------------------------


def test_promote_under_concurrent_batcher_traffic(tmp_path):
  """Deltas fold in while a micro-batcher keeps dispatching: every
  request resolves, and every answer is one published generation's
  answer for that request (the lock pairs each dispatch with one
  promoted state); the final state equals the full re-export."""
  reg = MetricsRegistry()
  c = Cell(tmp_path, registry=reg)
  pool = [c.batch(n) for n in (1, 2, 3, 4, 2, 1)]
  gens = [c.full("gen0", state=None)]  # the state delta 1 published
  batcher = MicroBatcher(c.sub.dispatch, max_batch=4, max_delay_s=0.001,
                         registry=MetricsRegistry())
  stop = threading.Event()
  failures, answers = [], []

  def client(k):
    r = np.random.default_rng(k)
    while not stop.is_set():
      i = int(r.integers(len(pool)))
      try:
        fut = batcher.submit(pool[i][0], pool[i][1])
        answers.append((i, fut.result(timeout=30.0)))
      except Rejected:
        pass
      except Exception as e:  # noqa: BLE001 — collected for the assert
        failures.append(e)

  threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
  for t in threads:
    t.start()
  c.sub.start()
  try:
    for k in range(3):
      c.train()
      assert c.publisher.publish_delta(c.state) is not None
      gens.append(c.full(f"gen{k + 1}"))
      time.sleep(0.05)
    deadline = time.monotonic() + 30.0
    while c.sub.applied_seq < c.publisher.seq \
        and time.monotonic() < deadline:
      time.sleep(0.02)
    time.sleep(0.05)  # traffic on the last generation too
  finally:
    stop.set()
    for t in threads:
      t.join(timeout=30.0)
    c.sub.stop()
    batcher.close()
  assert not failures, failures
  assert c.sub.last_error is None
  assert c.sub.applied_seq == c.publisher.seq == 4
  engines = [ServeEngine(SC.TorchActsModel(), c.plan, art, device="cpu")
             for art in gens]
  want = [[e.predict(req[0], req[1]) for e in engines] for req in pool]
  # the base's generation too: requests answered before the first fold
  base = serve_load(os.path.join(c.path, "base"), c.plan, device="cpu")
  for i, req in enumerate(pool):
    want[i].append(ServeEngine(SC.TorchActsModel(), c.plan, base,
                               device="cpu").predict(req[0], req[1]))
  seen = set()
  for i, got in answers:
    match = [g for g, w in enumerate(want[i]) if np.array_equal(got, w)]
    assert match, f"request {i}: an answer of no published generation"
    seen.update(match)
  assert len(answers) > 20 and len(seen) >= 2
  c.assert_serves_full(c.sub)
  assert c.sub.freshness.count == c.publisher.seq
  assert np.isfinite(c.sub.freshness.p99)
  assert len(c.sub.promote_s) == c.publisher.seq


def test_batcher_dispatch_fn_swap_between_flushes():
  calls = []

  def d1(numerical, cats):
    calls.append(1)
    return torch.zeros((numerical.shape[0], 1))

  def d2(numerical, cats):
    calls.append(2)
    return torch.ones((numerical.shape[0], 1))

  mb = MicroBatcher(d1, max_batch=4, start=False,
                    registry=MetricsRegistry())
  mb.submit(np.zeros((2, 1)), [np.zeros((2, 1), np.int32)])
  mb.flush_now()
  mb.set_dispatch_fn(d2)
  fut = mb.submit(np.zeros((2, 1)), [np.zeros((2, 1), np.int32)])
  mb.flush_now()
  assert calls == [1, 2]
  np.testing.assert_array_equal(fut.result(), np.ones((2, 1)))
  mb.close()


def test_published_delta_seqs_ignores_stray_entries(tmp_path):
  pub = str(tmp_path)
  os.makedirs(os.path.join(pub, "delta_000002"))
  with open(os.path.join(pub, "delta_000002", "manifest.json"), "w") as f:
    f.write("{}")
  os.makedirs(os.path.join(pub, "delta_000001"))  # torn: no manifest
  for d in ("delta_000003.tmp", "delta_000004.old", "heartbeats",
            "not_a_delta"):
    os.makedirs(os.path.join(pub, d))
  with open(os.path.join(pub, "delta_000005"), "w") as f:
    f.write("x")  # a stray FILE named like a delta
  assert published_delta_seqs(pub) == [2]
  assert published_delta_seqs(os.path.join(pub, "nope")) == []


# ---------------------------------------------------------------------------
# attach: chain state through the checkpoint, superset re-publish
# ---------------------------------------------------------------------------


def _rows_of(dpath):
  return {f: set(SC.npz_arrays(os.path.join(dpath, f))["idx"].tolist())
          for f in os.listdir(dpath) if f.startswith("rows_")}


def test_publisher_attach_rejoins_chain_with_superset(tmp_path):
  c = Cell(tmp_path)
  ckpt = str(tmp_path / "ckpt")
  tck.save(ckpt, c.plan, c.rule, c.state, stream=c.publisher)
  seq_snap, fp_snap = c.publisher.seq, c.publisher.fingerprint
  snap = tck.restore(ckpt, c.plan, c.rule, c.state, device="cpu")
  replay = c.train()  # the orphan's batch
  assert c.publisher.publish_delta(c.state) is not None
  orphan = os.path.join(c.path, delta_dirname(2))

  pub2 = c.publisher_like()
  state2 = tck.restore(ckpt, c.plan, c.rule, c.state, stream=pub2,
                       device="cpu")
  assert not pub2.attached
  with pytest.raises(RuntimeError, match="unattached"):
    pub2.publish_delta(state2)
  assert pub2.seq == seq_snap and pub2.fingerprint == fp_snap
  assert pub2.attach() == 1  # the orphan tail delta is adopted
  assert pub2.attached and pub2.seq == 2
  assert pub2.fingerprint == tck.manifest_fingerprint(orphan)
  for bt in replay:  # the replayed stream (bit-identical training)
    pub2.observe_batch(bt[1])
    state2 = SC.run_step(c.step_fn, state2, bt)
  assert pub2.publish_delta(state2) is not None
  d3 = _rows_of(os.path.join(c.path, delta_dirname(3)))
  for f, idx in _rows_of(orphan).items():
    assert idx <= d3.get(f, set()), f
  assert c.sub.poll_once() == 3
  c.assert_serves_full(c.sub, state=state2)
  del snap


def test_preroot_snapshot_resumes_fresh_publisher(tmp_path):
  c = Cell(tmp_path)
  other = str(tmp_path / "pub2")
  fresh = c.publisher_like(other)
  ckpt = str(tmp_path / "ckpt_preroot")
  tck.save(ckpt, c.plan, c.rule, c.state, stream=fresh)
  pub2 = c.publisher_like(other)
  tck.restore(ckpt, c.plan, c.rule, c.state, stream=pub2, device="cpu")
  assert pub2.attached and pub2.fingerprint is None
  pub2.publish_base(c.state)  # root explicitly; no ChainDiverged crash
  assert pub2.seq == 0 and pub2.fingerprint is not None


def test_attach_refuses_forked_or_rerooted_chain(tmp_path):
  c = Cell(tmp_path)
  ckpt = str(tmp_path / "ckpt")
  tck.save(ckpt, c.plan, c.rule, c.state, stream=c.publisher)
  c.train()
  assert c.publisher.publish_delta(c.state) is not None
  mpath = os.path.join(c.path, delta_dirname(2), "manifest.json")
  with open(mpath) as f:
    manifest = json.load(f)
  good = manifest["base_fingerprint"]
  manifest["base_fingerprint"] = "f" * 64
  with open(mpath, "w") as f:
    json.dump(manifest, f)
  pub2 = c.publisher_like()
  tck.restore(ckpt, c.plan, c.rule, c.state, stream=pub2, device="cpu")
  with pytest.raises(ChainDivergedError) as ei:
    pub2.attach()
  assert ei.value.field == "base_fingerprint"
  assert not pub2.attached
  manifest["base_fingerprint"] = good
  with open(mpath, "w") as f:
    json.dump(manifest, f)
  # re-rooted base: another publisher replaced base/ entirely
  pub3 = c.publisher_like()
  reroot = c.publisher_like()
  reroot.tracker.observe(c.batch()[1])
  reroot.publish_base(c.state)
  tck.restore(ckpt, c.plan, c.rule, c.state, stream=pub3, device="cpu")
  with pytest.raises(ChainDivergedError) as ei:
    pub3.attach()
  assert ei.value.field == "base_fingerprint"


def test_attach_fault_injection_crash_and_retry(tmp_path):
  c = Cell(tmp_path)
  ckpt = str(tmp_path / "ckpt")
  tck.save(ckpt, c.plan, c.rule, c.state, stream=c.publisher)
  c.train()
  assert c.publisher.publish_delta(c.state) is not None
  pub2 = c.publisher_like()
  tck.restore(ckpt, c.plan, c.rule, c.state, stream=pub2, device="cpu")
  inj = faultinject.FaultInjector().crash_after("stream_attach", 0)
  with faultinject.injected(inj):
    with pytest.raises(faultinject.InjectedCrash):
      pub2.attach()
  assert not pub2.attached and pub2.seq == 1  # nothing adopted
  assert pub2.attach() == 1
  assert pub2.attached and pub2.seq == 2


def test_resilient_trainer_stream_auto_reattach(tmp_path):
  """``ResilientTrainer(stream=)`` persists the chain state per snapshot;
  a fresh trainer and publisher auto-resume AND auto-attach, and the
  continued chain folds to the re-export of the continued state."""
  rng = np.random.default_rng(3)
  plan, rule = SC.torch_plan(), SC.torch_rule()
  step = SC.torch_step(plan, guard=True)
  batches = [SC.mkbatch(rng, 8) for _ in range(6)]
  root, pubdir = str(tmp_path / "ckpts"), str(tmp_path / "pub")

  def publisher():
    return DeltaPublisher(pubdir, plan, rule, RowGenerationTracker(plan),
                          quantize="f32")

  with pytest.raises(NotImplementedError, match="async_snapshots"):
    ResilientTrainer(step, SC.torch_state(plan), plan, rule, root,
                     stream=publisher(), async_snapshots=True)
  pub1 = publisher()
  t1 = ResilientTrainer(step, SC.torch_state(plan), plan, rule, root,
                        snapshot_every=2, stream=pub1)
  pub1.publish_base(t1.state)
  t1.snapshot()
  for i in range(4):  # the first lifetime: 4 of 6 batches, 2 deltas
    pub1.observe_batch(batches[i][1])
    t1.run([batches[i]])
    if (i + 1) % 2 == 0:
      assert pub1.publish_delta(t1.state) is not None
  # the step-4 snapshot came before delta 2: delta 2 is the orphan
  from distributed_embeddings_torch.resilience import durable
  assert tck.read_manifest(durable.step_dir(root, 4))["stream"][
      "seq"] == 1
  pub2 = publisher()
  t2 = ResilientTrainer(step, SC.torch_state(plan), plan, rule, root,
                        snapshot_every=2, stream=pub2)
  assert t2.resumed_from is not None
  assert pub2.attached
  assert pub2.seq == pub1.seq
  assert pub2.base_fingerprint == pub1.base_fingerprint
  for i in range(t2.consumed, 6):
    pub2.observe_batch(batches[i][1])
    t2.run([batches[i]])
  assert pub2.publish_delta(t2.state) is not None
  sub = DeltaSubscriber.from_artifact(SC.TorchActsModel(), plan, pubdir,
                                      device="cpu", heartbeat=False)
  assert sub.poll_once() == pub2.seq
  path = str(tmp_path / "full")
  serve_export(path, plan, rule, t2.state)
  art = serve_load(path, plan, device="cpu")
  for name, want in art.state["serve"].items():
    assert torch.equal(sub.engine.state["serve"][name], want), name


# ---------------------------------------------------------------------------
# compaction: fold the chain into a new base, GC under the retention floor
# ---------------------------------------------------------------------------


def _chain_of(tmp_path, n_deltas, quantize="f32"):
  c = Cell(tmp_path, quantize=quantize)
  for _ in range(n_deltas - 1):
    c.train()
    assert c.publisher.publish_delta(c.state) is not None
  return c


def test_compaction_folds_chain_to_new_base(tmp_path):
  c = _chain_of(tmp_path, 3)
  reg = MetricsRegistry()
  res = DeltaCompactor(c.path, telemetry=reg).compact_once(through_seq=2)
  assert res["through_seq"] == 2 and res["deltas_folded"] == 2
  assert res["gc_removed"] == [1, 2]  # no heartbeats yet: GC'd
  assert published_delta_seqs(c.path) == [3]
  comp = tck.read_manifest(os.path.join(c.path, "base"))["stream"][
      "compacted"]
  assert comp["through_seq"] == 2
  assert comp["chain_root"] == c.publisher.base_fingerprint
  cold = c.subscriber(heartbeat=False)
  assert cold.applied_seq == 2
  assert cold.poll_once() == 1 and cold.applied_seq == 3
  c.assert_serves_full(cold)
  # a LIVE subscriber past the compaction point only adopts the new base
  sreg = MetricsRegistry()
  live = c.subscriber(telemetry=sreg, heartbeat=False)
  live.poll_once()
  before = live.base_fingerprint
  assert DeltaCompactor(c.path).compact_once()["through_seq"] == 3
  assert live.poll_once() == 0
  assert live.base_fingerprint != before
  assert sreg.counter("stream/compactions_adopted").value == 1
  assert sreg.counter("stream/rebases").value == 0


def test_compaction_quantized_cold_start_quant_exact(tmp_path):
  c = _chain_of(tmp_path, 2, quantize="int8")
  DeltaCompactor(c.path).compact_once(through_seq=1)
  cold = c.subscriber(heartbeat=False)
  cold.poll_once()
  c.assert_serves_full(cold)


def test_compaction_crash_mid_fold_never_corrupts_base(tmp_path):
  c = _chain_of(tmp_path, 2)
  base = os.path.join(c.path, "base")
  fp_before = tck.manifest_fingerprint(base)
  inj = faultinject.FaultInjector().crash_after("compact_fold", 0)
  with faultinject.injected(inj):
    with pytest.raises(faultinject.InjectedCrash):
      DeltaCompactor(c.path).compact_once()
  assert tck.manifest_fingerprint(base) == fp_before
  assert tck.verify(base) == []
  assert published_delta_seqs(c.path) == [1, 2]  # GC never ran
  inj = faultinject.FaultInjector().fail_first("compact_fold", 1)
  with faultinject.injected(inj):
    with pytest.raises(faultinject.TransientIOError):
      DeltaCompactor(c.path).compact_once()
  assert tck.verify(base) == []
  assert DeltaCompactor(c.path).compact_once()["through_seq"] == 2
  cold = c.subscriber(heartbeat=False)
  assert cold.applied_seq == 2
  c.assert_serves_full(cold)


def test_compaction_retention_respects_live_heartbeats(tmp_path):
  c = _chain_of(tmp_path, 3)
  write_heartbeat(c.path, "laggard", 1)
  res = DeltaCompactor(c.path).compact_once(through_seq=3)
  assert res["gc_removed"] == [1]
  assert published_delta_seqs(c.path) == [2, 3]
  hb = {"id": "dead", "applied_seq": 0, "wall": time.time() - 10_000}
  with open(os.path.join(c.path, "heartbeats", "dead.json"), "w") as f:
    json.dump(hb, f)
  os.remove(os.path.join(c.path, "heartbeats", "laggard.json"))
  assert DeltaCompactor(c.path).gc_deltas(3) == [2, 3]


# ---------------------------------------------------------------------------
# back-pressure: heartbeats, throttle-then-coalesce, expiry
# ---------------------------------------------------------------------------


def test_backpressure_throttles_then_coalesces(tmp_path):
  reg = MetricsRegistry()
  c = Cell(tmp_path, registry=reg)
  pub = c.publisher
  pub.max_subscriber_lag = 2
  write_heartbeat(c.path, "slow", 0)
  c.train()
  assert pub.publish_delta(c.state) is not None
  assert pub.seq == 2
  wm = pub.watermark
  c.train()
  assert pub.publish_delta(c.state) is None  # lag 2 >= 2: deferred
  assert pub.watermark == wm
  assert reg.counter("stream/publishes_throttled").value == 1
  write_heartbeat(c.path, "slow", 2)
  changed_before = pub.tracker.changed_row_total(wm)
  assert pub.publish_delta(c.state) is not None
  assert pub.seq == 3
  assert reg.counter("stream/deltas_coalesced").value == 1
  d3 = os.path.join(c.path, delta_dirname(3))
  n_shipped = sum(SC.npz_arrays(os.path.join(d3, f))["idx"].size
                  for f in os.listdir(d3) if f.startswith("rows_"))
  assert n_shipped == changed_before  # both intervals' rows, one delta
  assert c.sub.poll_once() == 3
  c.assert_serves_full(c.sub)


def test_backpressure_force_bypasses_throttle(tmp_path):
  c = Cell(tmp_path, registry=MetricsRegistry())
  c.publisher.max_subscriber_lag = 1
  write_heartbeat(c.path, "slow", 0)
  c.train()
  assert c.publisher.publish_delta(c.state) is None  # lag 1 >= 1
  assert c.publisher.publish_delta(c.state, force=True) is not None
  with pytest.raises(ValueError, match="max_subscriber_lag must be >= 1"):
    DeltaPublisher(c.path, c.plan, c.rule, RowGenerationTracker(c.plan),
                   max_subscriber_lag=0)


def test_expired_heartbeat_drops_from_quorum_once(tmp_path):
  reg = MetricsRegistry()
  c = Cell(tmp_path, registry=reg)
  c.publisher.max_subscriber_lag = 1
  hb = {"id": "dead", "applied_seq": 0, "wall": time.time() - 10_000}
  os.makedirs(os.path.join(c.path, "heartbeats"), exist_ok=True)
  with open(os.path.join(c.path, "heartbeats", "dead.json"), "w") as f:
    json.dump(hb, f)
  for _ in range(2):
    c.train()
    assert c.publisher.publish_delta(c.state) is not None
    assert reg.counter("stream/subscribers_expired").value == 1  # once


def test_two_subscribers_one_chain_heartbeats_and_rollup(tmp_path):
  c = Cell(tmp_path)
  reg_a, reg_b = MetricsRegistry(), MetricsRegistry()
  sub_a = c.subscriber(telemetry=reg_a, subscriber_id="serve-a")
  sub_b = c.subscriber(telemetry=reg_b, subscriber_id="serve-b")
  assert sub_a.poll_once() == 1 and sub_b.poll_once() == 1
  c.train()
  assert c.publisher.publish_delta(c.state) is not None
  assert sub_a.poll_once() == 1
  live, expired = read_heartbeats(c.path, ttl_s=30.0)
  assert not expired
  assert live["serve-a"]["applied_seq"] == 2
  assert live["serve-b"]["applied_seq"] == 1
  c.publisher.max_subscriber_lag = 10
  assert c.publisher.subscriber_lag() == 1
  fleet = MetricsRegistry()
  fleet.merge(reg_a)
  fleet.merge(reg_b)
  assert fleet.counter("stream/deltas_applied").value == 3
  rolled = fleet.metrics()["stream/freshness_s"]
  assert rolled.count == 3 == (reg_a.metrics()["stream/freshness_s"].count
                               + reg_b.metrics()["stream/freshness_s"].count)


def test_subscriber_poll_jitter_phases_and_interleave(tmp_path):
  pa, pb = poll_phase("serve-a", 0.04), poll_phase("serve-b", 0.04)
  assert pa != pb and 0.0 <= pa < 0.04 and 0.0 <= pb < 0.04
  assert poll_phase("serve-a", 0.04) == pa
  assert poll_phase("serve-a", 0.0) == 0.0
  assert abs(poll_phase("serve-a", 0.4) - 10 * pa) < 1e-12
  c = Cell(tmp_path, pre=1, post=1)
  sub_a = c.subscriber(subscriber_id="serve-a", poll_interval_s=0.05,
                       poll_jitter_s=0.04)
  sub_b = c.subscriber(subscriber_id="serve-b", poll_interval_s=0.05,
                       poll_jitter_s=0.04)
  assert sub_a.poll_phase_s == pa and sub_b.poll_phase_s == pb
  assert sub_a.poll_once() == 1 and sub_b.poll_once() == 1
  sub_a.start()
  sub_b.start()
  time.sleep(0.6)
  sub_a.stop()
  sub_b.stop()
  assert len(sub_a.poll_walls) >= 3 and len(sub_b.poll_walls) >= 3
  merged = sorted([(t, "a") for t in sub_a.poll_walls]
                  + [(t, "b") for t in sub_b.poll_walls])
  flips = sum(1 for x, y in zip(merged, merged[1:]) if x[1] != y[1])
  assert flips >= 2, merged


# ---------------------------------------------------------------------------
# transient-read retry on the subscriber's validate/fold path
# ---------------------------------------------------------------------------


def test_subscriber_retries_transient_reads(tmp_path):
  from distributed_embeddings_torch import telemetry as _t
  c = Cell(tmp_path)
  c.sub.retry_policy = retry.RetryPolicy(retries=3, backoff=0.0)
  before = _t.get_registry().counter("retry/attempts").value
  inj = faultinject.FaultInjector().fail_first("stream_read", 2)
  with faultinject.injected(inj):
    assert c.sub.poll_once() == 1  # transient faults absorbed, applied
  assert c.sub.last_refusal is None
  assert _t.get_registry().counter("retry/attempts").value - before == 2


def test_heartbeat_reads_retry_then_degrade_to_expired(tmp_path):
  from distributed_embeddings_torch import telemetry as _t
  pub = str(tmp_path / "pub")
  write_heartbeat(pub, "healthy", 5)
  os.makedirs(heartbeat_path(pub, "sick"))  # open() raises every attempt
  before = _t.get_registry().counter("retry/attempts").value
  live, expired = read_heartbeats(pub, ttl_s=30.0)
  assert live["healthy"]["applied_seq"] == 5
  assert "sick" not in live
  assert expired["sick"]["unreadable"] is True
  assert expired["sick"]["applied_seq"] == -1
  assert _t.get_registry().counter("retry/attempts").value - before \
      == retry.DEFAULT_POLICY.retries
  assert read_heartbeats(str(tmp_path / "nope"), ttl_s=30.0) == ({}, {})


def test_subscriber_exhausted_reads_surface_without_advancing(tmp_path):
  c = Cell(tmp_path)
  c.sub.retry_policy = retry.RetryPolicy(retries=1, backoff=0.0)
  inj = faultinject.FaultInjector().fail_first("stream_read", 10_000)
  with faultinject.injected(inj):
    with pytest.raises(OSError):
      c.sub.poll_once()
  assert c.sub.applied_seq == 0  # held position, nothing half-applied
  assert c.sub.poll_once() == 1
  assert c.sub.applied_seq == 1
  assert artifact_bytes(os.path.join(c.path, delta_dirname(1))) < \
      artifact_bytes(os.path.join(c.path, "base"))


# ---------------------------------------------------------------------------
# tiered serving, world 1, f32
# ---------------------------------------------------------------------------


@pytest.fixture
def tiered(tmp_path):
  plan, rule, store, trainer = SC.tiered_cell()
  pub = str(tmp_path / "pub")
  publisher = DeltaPublisher(pub, plan, rule, RowGenerationTracker(plan),
                             store=store)
  for i in range(2):
    bt = SC.tiered_batch(100 + i)
    publisher.observe_batch(bt[1])
    trainer.step(*bt)
  publisher.publish_base(trainer.state)
  cfg = ServeTierConfig(**SC.T_CFG)
  sub = DeltaSubscriber.from_artifact(SC.tiered_model(), plan, pub,
                                      tier_config=cfg, with_metrics=True,
                                      device="cpu")
  for i in range(2):
    bt = SC.tiered_batch(200 + i)
    publisher.observe_batch(bt[1])
    trainer.step(*bt)
  return plan, rule, store, trainer, publisher, sub, cfg, str(tmp_path)


def _tiered_full(tmp, plan, rule, state, store, cfg):
  full = os.path.join(tmp, "full")
  serve_export(full, plan, rule, state, store=store)
  art = serve_load(full, plan, device="cpu")
  eng = ServeEngine(SC.tiered_model(), plan, art, device="cpu",
                    tier_config=cfg, with_metrics=True)
  return art, eng


def test_tiered_delta_is_flush_free_and_folds_to_reexport(tiered):
  """``publish_delta`` reads the tiered classes through the store's
  overlay reader (the live images are not mutated), and the folded cold
  images and predictions equal a full re-export's."""
  plan, rule, store, trainer, publisher, sub, cfg, tmp = tiered
  before = {name: [img.copy() for img in imgs]
            for name, imgs in store.images.items()}
  assert publisher.publish_delta(trainer.state) is not None
  for name, imgs in store.images.items():
    for r, img in enumerate(imgs):
      np.testing.assert_array_equal(img, before[name][r],
                                    err_msg=f"{name} rank {r}")
  assert "counts_" + sorted(store.images)[0] + ".npz" in os.listdir(
      os.path.join(publisher.path, delta_dirname(1)))
  assert sub.poll_once() == 1
  art, eng = _tiered_full(tmp, plan, rule, trainer.state, store, cfg)
  for name, images in art.host_images.items():
    for r, img in enumerate(images):
      np.testing.assert_array_equal(
          sub.engine.store.images[name][r].view(np.uint8),
          np.asarray(img).view(np.uint8))
  probe = SC.tiered_batch(999)
  pa, ma = sub.predict(probe[0], probe[1])
  pb, _ = eng.predict(probe[0], probe[1])
  np.testing.assert_array_equal(pa, pb)
  assert all(int(v[2]) == 0 for v in ma["tier"].values())  # no misses


def test_tiered_hot_set_adapts_to_shipped_counts(tiered):
  plan, rule, store, trainer, publisher, sub, cfg, tmp = tiered
  assert publisher.publish_delta(trainer.state) is not None
  assert sub.poll_once() == 1
  eng = sub.engine
  shipped_total = 0
  for name in eng.store.images:
    c = eng.tplan.by_name(name)
    for rank in range(plan.world_size):
      counts = eng.store.counts[name][rank]
      shipped_total += int(counts.sum())
      resident = set(eng.store.resident_grps[name][rank].tolist())
      assert len(resident) == c.spec.cache_grps
      floor = min(int(counts[g]) for g in resident)
      outside = np.delete(counts, sorted(resident))
      assert outside.size == 0 or int(outside.max()) <= floor
  assert shipped_total > 0


# ---------------------------------------------------------------------------
# dynvocab: a newly admitted raw id is servable after one delta cycle
# ---------------------------------------------------------------------------


def test_dynvocab_new_id_servable_after_one_delta(tmp_path):
  from distributed_embeddings_torch.dynvocab import DynVocabTranslator
  from distributed_embeddings_torch.layers.dist_model_parallel import \
      set_weights
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import \
      DistEmbeddingStrategy
  from distributed_embeddings_torch.training import init_sparse_state
  sizes, widths, hot = [256, 40], [16, 8], [2, 1]

  def mk(**kw):
    return DistEmbeddingStrategy(
        [TableConfig(s, w, combiner="sum") for s, w in zip(sizes, widths)],
        1, "memory_balanced", dense_row_threshold=0, input_hotness=hot,
        **kw)

  plan = mk(oov="allocate", admit_threshold=1)
  serve_plan = mk()  # the same tables: the same fingerprint; it clips
  rng = np.random.default_rng(0)
  tables = set_weights(plan, [
      (rng.standard_normal((s, w)) * 0.1).astype(np.float32)
      for s, w in zip(sizes, widths)])
  rule = SC.torch_rule()
  state = init_sparse_state(plan, {"embeddings": tables}, rule,
                            functools.partial(torch.optim.SGD,
                                              lr=SC.DENSE_LR), device="cpu")
  step = SC.torch_step(plan)
  b = 8

  def mkbatch(extra_id=None):
    ids = [rng.integers(0, 10**9, (b, h)).astype(np.int64) for h in hot]
    if extra_id is not None:
      ids[0][0, 0] = extra_id
    return (rng.standard_normal((b, 4)).astype(np.float32), ids,
            rng.integers(0, 2, b).astype(np.float32))

  translator = DynVocabTranslator(plan, rule)
  pub = str(tmp_path / "pub")
  publisher = DeltaPublisher(pub, plan, rule, RowGenerationTracker(plan),
                             vocab=translator)

  def train(state, raw):
    cats_t, _, _ = translator.translate_batch(raw[1])
    publisher.observe_batch(cats_t)  # the ids the STEP consumes
    return SC.run_step(step, state, (raw[0], cats_t, raw[2]))

  state = train(state, mkbatch())
  publisher.publish_base(state)
  sub = DeltaSubscriber.from_artifact(SC.TorchActsModel(), serve_plan, pub,
                                      device="cpu")
  assert sub.translator is not None  # the snapshot rode the base
  new_id = 987_654_321
  probe = mkbatch(new_id)
  assert sub.translator.translate(list(probe[1]))[0][0, 0] == SC.PAD_ID
  p_before = sub.predict(probe[0], probe[1])
  state = train(state, probe)  # admits new_id, trains its row
  assert publisher.publish_delta(state) is not None
  assert sub.poll_once() == 1  # ONE delta cycle, no full re-export
  assert sub.translator.translate(list(probe[1]))[0][0, 0] >= 0
  p_after = sub.predict(probe[0], probe[1])
  assert not np.array_equal(p_before[0], p_after[0])
  full = str(tmp_path / "full")
  serve_export(full, serve_plan, rule, state, vocab=translator)
  art = serve_load(full, serve_plan, device="cpu")
  eng = ServeEngine(SC.TorchActsModel(), serve_plan, art, device="cpu")
  np.testing.assert_array_equal(
      p_after, eng.predict(probe[0], art.vocab.translate(list(probe[1]))))

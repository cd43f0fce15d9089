"""The port's resilience subsystem (``resilience/retry.py``, ``durable.py``,
``trainer.py``) and the checkpoint's ``telemetry`` section, against the
JAX package's.

- **Retry**: the same sleep schedule as the JAX policy for a seed (both
  jitter modes), the same retried calls and the same exhausted
  exception.
- **Durable**: rotation, pruning and the newest-valid fallback pick the
  same directories as the JAX package's on one tree (truncated,
  bit-flipped, manifest-less and torn newest checkpoints), and either
  package restores the other's newest valid one.
- **Telemetry section**: a registry saved by either package's
  ``checkpoint.save(telemetry=)`` loads into the other's registry.
- **The chaos story** (``tools/torch_chaos_train.py``): NaN batches, a
  transient write fault and a crash mid-save, then a fresh trainer that
  auto-resumes; from one JAX initial state, the port's run against the
  JAX ``ResilientTrainer`` on the same stream: ``metrics_summary`` equal,
  the final state in the f32 class (rtol 1e-5, atol 1e-6), the port's
  resumed trajectory bit-equal to its own uninterrupted run.
- **The trainer**: abort with rollback; async snapshots equal to sync
  ones; a JAX trainer's root resumed by the port's trainer (and the
  reverse), adopting ``consumed``, ``skipped``, ``oov`` and the
  telemetry; the SIGTERM drain; every refusal by name.
"""

import functools
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import train_state_from_flax
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.parallel.mesh import Mesh
from distributed_embeddings_torch.resilience import (
    FaultInjector,
    InjectedCrash,
    durable,
    faultinject,
    retry,
)
from distributed_embeddings_torch.resilience.trainer import (
    ResilientTrainer,
    TooManyBadSteps,
)
from distributed_embeddings_torch.telemetry import MetricsRegistry
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.resilience import durable as jdurable
from distributed_embeddings_tpu.resilience import faultinject as jfault
from distributed_embeddings_tpu.resilience import retry as jretry
from distributed_embeddings_tpu.resilience.trainer import \
    ResilientTrainer as JTrainer
from distributed_embeddings_tpu.telemetry import \
    MetricsRegistry as JRegistry
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_train_step,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_chaos_train as chaos  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB = chaos.VOCAB
D = chaos.DIM
NUM = chaos.NUM
LR = chaos.LR


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"backoff": 0.05, "max_backoff": 0.3},
    {"jitter": "full", "seed": 42}, {"jitter": "full", "seed": 7,
                                     "retries": 5}])
def test_retry_schedules_match_jax(kw):
  tp, jp = retry.RetryPolicy(**kw), jretry.RetryPolicy(**kw)
  trng, jrng = tp.make_rng(), jp.make_rng()
  assert [tp.sleep_for(a, trng) for a in range(9)] == \
      [jp.sleep_for(a, jrng) for a in range(9)]

  def flaky(calls):
    def fn():
      calls.append(1)
      if len(calls) <= 3:
        raise OSError(5, "transient", "/x")
      return "ok"
    return fn

  tslept, jslept = [], []
  assert retry.retry_call(flaky([]), policy=tp, sleep=tslept.append) == \
      jretry.retry_call(flaky([]), policy=jp, sleep=jslept.append) == "ok"
  assert tslept == jslept
  always = retry.RetryPolicy(retries=1, backoff=0.0)

  def broken():
    raise OSError(28, "No space left on device", "/ckpt")

  with pytest.raises(OSError) as te:
    retry.retrying(broken, always, sleep=lambda s: None)()
  with pytest.raises(OSError) as je:
    jretry.retrying(broken, jretry.RetryPolicy(retries=1, backoff=0.0),
                    sleep=lambda s: None)()
  assert str(te.value) == str(je.value) and te.value.errno == 28
  with pytest.raises(ValueError) as te:
    retry.RetryPolicy(jitter="half")
  with pytest.raises(ValueError) as je:
    jretry.RetryPolicy(jitter="half")
  assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# a small port run and its JAX twin
# ---------------------------------------------------------------------------


def _plans(oov="clip"):
  def cfg(mod):
    return [mod(input_dim=v, output_dim=D) for v in VOCAB]
  return (DistEmbeddingStrategy(cfg(TableConfig), 1, "basic",
                                dense_row_threshold=chaos.THRESHOLD, oov=oov),
          TStrategy(cfg(TTableConfig), 1, "basic",
                    dense_row_threshold=chaos.THRESHOLD, oov=oov))


def _jax_model():
  return DLRM(vocab_sizes=VOCAB, embedding_dim=D, bottom_mlp=(32, D),
              top_mlp=(32, 1))


def _jax_state(jplan, jrule):
  dense = _jax_model().init(
      jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
      emb_acts=[jnp.zeros((2, D)) for _ in VOCAB])["params"]
  return init_sparse_state_direct(jplan, jrule, dense, optax.adagrad(LR),
                                  jax.random.PRNGKey(1))


def _numpy_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense", "step")}


def _port_state(state, opt):
  """The port's train state from the JAX state ``state``, with ``opt``
  bound (on the CPU)."""
  return ttr._with_optimizers(
      train_state_from_flax(_numpy_state(state), device="cpu"), opt, None)


class _Twins:
  """The JAX and the port guarded steps on one plan, from one state."""

  def __init__(self, oov="clip"):
    self.jplan, self.tplan = _plans(oov)
    self.jrule = jpt.sparse_rule("adagrad", LR)
    self.trule = tpt.sparse_rule("adagrad", LR)
    self.state = _jax_state(self.jplan, self.jrule)
    self.batches = chaos.chaos_batches(12)
    self.jstep = make_sparse_train_step(
        _jax_model(), self.jplan, bce_loss, optax.adagrad(LR), self.jrule,
        None, self.state, self.batches[0], donate=False, guard=True)
    self.opt = functools.partial(ttr.Adagrad, lr=LR)
    self.tstep = ttr.make_sparse_train_step(
        chaos.chaos_model("cpu"), self.tplan, torch_bce, self.opt,
        self.trule, guard=True)

  def port_state(self):
    return _port_state(self.state, self.opt)

  def port(self, root, **kw):
    kw.setdefault("telemetry", MetricsRegistry())
    return ResilientTrainer(self.tstep, self.port_state(), self.tplan,
                            self.trule, str(root), **kw)

  def jax(self, root, **kw):
    kw.setdefault("telemetry", JRegistry())
    return JTrainer(self.jstep, self.state, self.jplan, self.jrule,
                    str(root), **kw)


def _assert_close_states(tstate, jstate, tol=TOL):
  jstate = jax.device_get(jstate)
  for name, buf in jstate["fused"].items():
    np.testing.assert_allclose(tstate["fused"][name].numpy(),
                               np.asarray(buf), err_msg=name, **tol)
  for name, t in jstate["emb_dense"].items():
    np.testing.assert_allclose(tstate["emb_dense"][name].detach().numpy(),
                               np.asarray(t), err_msg=name, **tol)
  assert tstate["step"] == int(jstate["step"])


def _port_arrays(state):
  out = {f"fused/{k}": v.clone() for k, v in state["fused"].items()}
  for part in ("dense", "emb_dense"):
    out.update({f"{part}/{k}": v.detach().clone()
                for k, v in state[part].items()})
  return out


def _assert_bit_equal(a, b):
  assert sorted(a) == sorted(b)
  for k in a:
    assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def twins():
  return _Twins()


# ---------------------------------------------------------------------------
# durable
# ---------------------------------------------------------------------------


def _saved_root(twins, root, steps=3):
  t = twins.port(root, resume=False)
  for b in twins.batches[:steps]:
    t.step(*ttr.shard_batch(b, device="cpu"))
    t.snapshot()
  return t


@pytest.mark.parametrize("mode", ["truncated", "bitflip", "no_manifest",
                                  "torn"])
def test_newest_valid_fallback_matches_jax(twins, tmp_path, mode):
  root = tmp_path / "ckpts"
  t = _saved_root(twins, root)
  os.makedirs(root / "not_a_ckpt")
  open(root / "ckpt_notanumber", "w").close()
  latest = durable.step_dir(str(root), 3)
  fname = next(f for f in sorted(os.listdir(latest))
               if f.startswith("fused_"))
  if mode == "truncated":
    faultinject.truncate_file(os.path.join(latest, fname))
  elif mode == "bitflip":
    faultinject.bitflip_file(os.path.join(latest, fname))
  elif mode == "no_manifest":
    os.remove(os.path.join(latest, "manifest.json"))
  else:  # the step-4 save dies mid-way: a torn .tmp beside step 3
    t.step(*ttr.shard_batch(twins.batches[3], device="cpu"))
    with pytest.raises(InjectedCrash):
      with faultinject.injected(FaultInjector().crash_after("ckpt_write",
                                                            1)):
        t.snapshot()
    assert os.path.isdir(durable.step_dir(str(root), 4) + ".tmp")
  assert durable.list_checkpoints(str(root)) == \
      jdurable.list_checkpoints(str(root))
  assert durable.latest_valid(str(root)) == jdurable.latest_valid(str(root))
  want = 3 if mode == "torn" else 2
  assert durable.latest_valid(str(root))[0] == want
  got, step, _ = durable.restore_latest(str(root), twins.tplan, twins.trule,
                                        twins.port_state(), device="cpu")
  jgot, jstep, _ = jdurable.restore_latest(str(root), twins.jplan,
                                           twins.jrule, twins.state)
  assert step == jstep == want == got["step"]
  for name, buf in jax.device_get(jgot["fused"]).items():
    np.testing.assert_array_equal(got["fused"][name].numpy(),
                                  np.asarray(buf))


def test_rotation_and_prune_match_jax(twins, tmp_path):
  root = tmp_path / "ckpts"
  t = twins.port(root, resume=False, keep=2, snapshot_every=1)
  jroot = tmp_path / "jckpts"
  jt = twins.jax(jroot, resume=False, keep=2, snapshot_every=1)
  for d in (root, jroot):
    os.makedirs(d / "not_a_ckpt")
    open(d / "ckpt_notanumber", "w").close()
  t.run(twins.batches[:4])
  jt.run(twins.batches[:4])
  assert [s for s, _ in durable.list_checkpoints(str(root))] == \
      [s for s, _ in jdurable.list_checkpoints(str(jroot))] == [3, 4]
  assert sorted(os.listdir(root)) == sorted(os.listdir(jroot))
  assert durable.prune(str(root), 1) == [durable.step_dir(str(root), 3)]
  assert jdurable.prune(str(jroot), 1) == [jdurable.step_dir(str(jroot), 3)]
  with pytest.raises(ValueError) as te:
    durable.prune(str(root), 0)
  with pytest.raises(ValueError) as je:
    jdurable.prune(str(root), 0)
  assert str(te.value) == str(je.value)


def test_telemetry_section_crosses_both_ways(twins, tmp_path):
  def fill(reg):
    reg.counter("train/consumed").inc(7)
    reg.counter("train/bad_step").inc(2)
    reg.gauge("occupancy").set(0.25)
    h = reg.histogram("ckpt/save_s", rel_err=0.01)
    for v in (0.5, 1.5, 2.5, 40.0):
      h.observe(v)

  treg, jreg = MetricsRegistry(), JRegistry()
  fill(treg)
  fill(jreg)
  assert treg.state_dict() == jreg.state_dict()
  tstate = twins.port_state()
  tck.save(str(tmp_path / "t"), twins.tplan, twins.trule, tstate,
           telemetry=treg)
  jck.save(str(tmp_path / "j"), twins.jplan, twins.jrule, twins.state,
           telemetry=jreg)
  assert tck.read_manifest(str(tmp_path / "t"))["telemetry"] == \
      jck.read_manifest(str(tmp_path / "j"))["telemetry"]
  into_j, into_t = JRegistry(), MetricsRegistry()
  jck.restore(str(tmp_path / "t"), twins.jplan, twins.jrule, twins.state,
              telemetry=into_j)
  tck.restore(str(tmp_path / "j"), twins.tplan, twins.trule, tstate,
              telemetry=into_t, device="cpu")
  assert into_j.state_dict() == into_t.state_dict() == treg.state_dict()
  # a captured dict (what an async snapshot passes) writes the same
  tck.save(str(tmp_path / "d"), twins.tplan, twins.trule, tstate,
           telemetry=treg.state_dict())
  assert tck.read_manifest(str(tmp_path / "d"))["telemetry"] == \
      treg.state_dict()


# ---------------------------------------------------------------------------
# the chaos story
# ---------------------------------------------------------------------------


def _jax_chaos(twins_, stream, crash_event, root):
  """The chaos story of ``tools/chaos_train.py`` at world 1 with the JAX
  ``ResilientTrainer``: returns the resumed trainer and the trajectory."""
  ref = twins_.jax(root / "ref", snapshot_every=4)
  losses_ref = ref.run(stream)
  t = twins_.jax(root / "run", snapshot_every=4)
  inj = (jfault.FaultInjector().fail_first("ckpt_write", 1)
         .crash_after("ckpt_write", crash_event))
  losses = []
  with pytest.raises(jfault.InjectedCrash):
    with jfault.injected(inj):
      for b in stream:
        losses.append(t.step(*b))
  t2 = twins_.jax(root / "run", snapshot_every=4)
  return t2, losses[:t2.consumed] + t2.run(stream[t2.consumed:]), losses_ref


def test_chaos_story_matches_the_jax_trainer(tmp_path):
  twins_ = _Twins()
  setup = chaos.chaos_setup(torch.device("cpu"), 24)
  setup["fresh_state"] = lambda: _port_state(twins_.state, setup["opt"])
  res = chaos.run_chaos(device="cpu", setup=setup)
  assert res["ok"], res
  assert res["trajectory_bit_exact"] and res["crashed"]
  assert res["skipped_total"] == res["expected_skips"] == 3
  stream = list(jfault.nan_batches(chaos.chaos_batches(24),
                                   at_steps={6, 13, 20}))
  jt, jtraj, jref = _jax_chaos(twins_, stream, res["crash_at_write_event"],
                               tmp_path)
  want = {**jt.metrics_summary(),
          "resumed_from": os.path.basename(jt.resumed_from)}
  assert res["metrics_summary"] == want
  ref_state, resumed_state = res["_states"]
  _assert_close_states(resumed_state, jt.state)
  _assert_bit_equal(_port_arrays(resumed_state), _port_arrays(ref_state))
  assert all(np.isnan(a) == np.isnan(b) for a, b in zip(jtraj, jref))


def test_chaos_tool_exits_0_on_the_cpu(capsys):
  assert chaos.main(["--device", "cpu", "--steps", "12", "--nan_every",
                     "5", "--snapshot_every", "3"]) == 0
  line = capsys.readouterr().out.strip().splitlines()[-1]
  assert '"ok": true' in line and '"chaos": "torch"' in line


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_abort_rolls_back_as_in_jax(twins, tmp_path):
  poison = list(faultinject.nan_batches(twins.batches[2:6],
                                        at_steps={0, 1, 2, 3}))
  outs = []
  for make, root in ((twins.port, tmp_path / "t"), (twins.jax,
                                                    tmp_path / "j")):
    t = make(root, max_consecutive_bad=2)
    t.run(twins.batches[:2])
    t.snapshot()
    with pytest.raises(Exception) as e:
      t.run(poison)
    assert type(e.value).__name__ == "TooManyBadSteps"
    assert e.value.resumed_step == 2 and t.step_count == 2
    outs.append((str(e.value).split("(")[0], t.skipped_steps, t.consumed,
                 t.metrics_summary()["consecutive_bad"]))
    if make == twins.port:
      assert isinstance(e.value, TooManyBadSteps)
  # the rollback rewinds the stream position to the snapshot's, and
  # keeps the skips it observed
  assert outs[0] == outs[1] == (outs[0][0], 2, 2, 0)


def test_rollback_continues_like_a_restart(twins, tmp_path):
  """After an abort the step continues from the restored tensors and
  their optimizers: bit-equal to a fresh trainer resuming the same
  checkpoint and taking the same steps."""
  t = twins.port(tmp_path / "r", max_consecutive_bad=1)
  t.run(twins.batches[:2])
  t.snapshot()
  with pytest.raises(TooManyBadSteps):
    t.run(faultinject.nan_batches(twins.batches[2:3], at_steps={0}))
  t.run(twins.batches[3:5])
  other = twins.port(tmp_path / "r2", resume=False)
  other.state = tck.restore(durable.step_dir(str(tmp_path / "r"), 2),
                            twins.tplan, twins.trule, other.state,
                            device="cpu")
  other.run(twins.batches[3:5])
  _assert_bit_equal(_port_arrays(t.state), _port_arrays(other.state))


def test_async_snapshots_equal_sync_ones(twins, tmp_path):
  ts = twins.port(tmp_path / "sync", snapshot_every=2)
  ta = twins.port(tmp_path / "async", snapshot_every=2,
                  async_snapshots=True)
  stream = list(faultinject.nan_batches(twins.batches[:8], at_steps={3}))
  ls = ts.run(stream)
  overlap = 0
  la = []
  with faultinject.injected(FaultInjector().delay_each("ckpt_write", 0.02)):
    for b in stream:
      la.append(ta.step(*ttr.shard_batch(b, device="cpu")))
      overlap += int(ta.writer_active)
    ta.close()
  assert overlap > 0
  np.testing.assert_array_equal(ls, la)
  steps = [s for s, _ in durable.list_checkpoints(str(tmp_path / "sync"))]
  assert steps == [s for s, _ in
                   durable.list_checkpoints(str(tmp_path / "async"))]
  for s in steps:
    a = tck.restore(durable.step_dir(str(tmp_path / "async"), s),
                    twins.tplan, twins.trule, ts.state, device="cpu")
    b = tck.restore(durable.step_dir(str(tmp_path / "sync"), s),
                    twins.tplan, twins.trule, ts.state, device="cpu")
    _assert_bit_equal(_port_arrays(a), _port_arrays(b))
    assert tck.read_manifest(durable.step_dir(str(tmp_path / "async"), s)
                             )["extra"] == tck.read_manifest(
        durable.step_dir(str(tmp_path / "sync"), s))["extra"]
  # a background writer's failure surfaces at the join
  ta.retry_policy = retry.RetryPolicy(retries=1, backoff=0.0)
  with faultinject.injected(FaultInjector().fail_first("ckpt_write", 10)):
    ta.snapshot(async_=True)
    with pytest.raises(faultinject.TransientIOError):
      ta.join_writer()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_roots_cross_between_the_trainers(tmp_path, writer):
  """One trainer runs a stream with a NaN batch and out-of-range ids
  (clip) and snapshots; a fresh trainer of the other package resumes the
  root, adopting ``consumed``, ``skipped``, ``oov`` and the telemetry,
  and both continue alike."""
  twins_ = _Twins()
  stream = list(faultinject.nan_batches(twins_.batches[:5], at_steps={2}))
  numerical, cats, labels = stream[1]
  cats = [c.copy() for c in cats]
  cats[0][:3] = VOCAB[0] + 4
  stream[1] = (numerical, cats, labels)
  root = tmp_path / "root"
  first = (twins_.jax if writer == "jax" else twins_.port)(root)
  first.run(stream)
  first.snapshot()
  second = (twins_.port if writer == "jax" else twins_.jax)(root)
  for t in (first, second):
    assert (t.consumed, t.skipped_steps, t.step_count) == (5, 1, 4)
  assert second.oov_totals == first.oov_totals
  assert sum(second.oov_totals.values()) == 3
  tel = second.telemetry.state_dict()
  assert tel["counters"]["train/consumed"] == 5
  assert tel["counters"]["train/bad_step"] == 1
  port, jax_t = (second, first) if writer == "jax" else (first, second)
  if writer == "port":
    port = twins_.port(root)
  port.run(twins_.batches[5:7])
  jax_t.run(twins_.batches[5:7])
  _assert_close_states(port.state, jax_t.state)
  assert port.metrics_summary()["oov"] == jax_t.metrics_summary()["oov"]


def test_sigterm_drain_snapshots_and_the_handler_is_restored(twins,
                                                             tmp_path):
  seen = []

  def previous(signum, frame):
    seen.append(signum)

  old = signal.signal(signal.SIGTERM, previous)
  try:
    t = twins.port(tmp_path / "drain", snapshot_every=0)
    got = signal.getsignal(signal.SIGTERM)
    t.install_sigterm_drain(deadline_s=60.0)
    assert got is previous and signal.getsignal(signal.SIGTERM) is not got
    stream = iter(twins.batches)

    def batches():
      for i, b in enumerate(stream):
        if i == 2:
          os.kill(os.getpid(), signal.SIGTERM)
        yield b

    losses = t.run(batches())
    assert len(losses) == 3 and t.drain_requested and t.drained
    assert t.maybe_drain()  # idempotent: no second snapshot
    assert [s for s, _ in durable.list_checkpoints(
        str(tmp_path / "drain"))] == [3]
    assert t.telemetry.state_dict()["counters"]["train/sigterm_drains"] == 1
    signal.signal(signal.SIGTERM, got)
    os.kill(os.getpid(), signal.SIGTERM)
    assert seen == [signal.SIGTERM]
  finally:
    signal.signal(signal.SIGTERM, old)


@pytest.mark.parametrize("kw,item", [
    ({"dynvocab": object()}, "item 12"), ({"stream": object()}, "item 12"),
    ({"overlap_host": True}, "item 11")])
def test_trainer_refusals_name_their_item(twins, tmp_path, kw, item):
  if item == "item 11":
    # item 11a ported overlap_host: without a tiered trainer there is no
    # host pass to overlap, refused as the JAX trainer refuses it
    with pytest.raises(ValueError) as got:
      twins.port(tmp_path / "p", **kw)
    with pytest.raises(ValueError) as want:
      twins.jax(tmp_path / "j", **kw)
    assert str(got.value) == str(want.value)
    assert "without a tiered" in str(got.value)
    return
  with pytest.raises(NotImplementedError, match=item):
    twins.port(tmp_path, **kw)


def test_other_refusals(twins, tmp_path):
  t = twins.port(tmp_path / "r", resume=False)
  jt = twins.jax(tmp_path / "j", resume=False)
  # item 11b ported resize: without the new world's step it is refused
  # as the JAX trainer refuses it
  with pytest.raises(ValueError) as got:
    t.resize(2)
  with pytest.raises(ValueError) as want:
    jt.resize(2)
  assert str(got.value) == str(want.value)
  t4 = twins.port(tmp_path / "r4", resume=False,
                  mesh=Mesh(rank=0, world=4, device=torch.device("cpu"),
                            backend="gloo"))
  with pytest.raises(NotImplementedError, match="multi-controller"):
    t4.snapshot(async_=True)
  for kw, item in (({"vocab": object()}, "item 12"),
                   ({"stream": object()}, "item 12")):
    with pytest.raises(NotImplementedError, match=item):
      durable.save_rotating(str(tmp_path / "x"), twins.tplan, twins.trule,
                            t.state, **kw)
    with pytest.raises(NotImplementedError, match=item):
      durable.restore_latest(str(tmp_path / "x"), twins.tplan, twins.trule,
                             t.state, device="cpu", **kw)
  assert durable.restore_latest(str(tmp_path / "empty"), twins.tplan,
                                twins.trule, t.state, device="cpu") is None


# ---------------------------------------------------------------------------
# world 4
# ---------------------------------------------------------------------------


def test_world4_trainer_resumes_and_matches_the_jax_trainer(tmp_path):
  """Four gloo ranks (``tests/torch_ranks.py: trainer_job``) run the
  guarded step through ``ResilientTrainer`` with their meshes: a NaN in
  one rank's slice of a batch is skipped by all, every second committed
  step is snapshot, a fresh trainer resumes the root at its consumed
  position. The JAX ``ResilientTrainer`` over a 4-device CPU mesh runs
  the same stream: the summaries equal, the final states in the f32
  class; and the JAX trainer resumes the port's world-4 root at the
  same position with the same accounting."""
  from distributed_embeddings_tpu.parallel import create_mesh
  from distributed_embeddings_tpu.training import shard_params
  from test_torch_micro_batch import (
      LR as W_LR,
      _w_model,
      _w_plan,
      assert_w_final,
      w_batches,
      w_initial,
      w_spec,
  )
  from torch_ranks import spawn

  state = w_initial()
  stream = w_batches(6, seed=11)
  numerical = stream[2][0].copy()
  n = len(numerical) // 4
  numerical[2 * n:3 * n] = np.nan  # rank 2's slice only
  stream[2] = (numerical,) + tuple(stream[2][1:])
  spec = w_spec(state, [], stream)
  spec.update({"overlap": "fused", "root": str(tmp_path / "port"),
               "snapshot_every": 2, "split": 5, "stream": stream})
  res = spawn(tmp_path, 4, "trainer_job", spec)
  mesh = create_mesh(4)
  plan = _w_plan(4, "fused")
  rule = jpt.adagrad_rule(W_LR)
  st = shard_params(state, mesh)
  jstep = make_sparse_train_step(_w_model(4), plan, bce_loss,
                                 optax.sgd(W_LR), rule, mesh, st, stream[0],
                                 donate=False, guard=True)

  def jtrainer(root, resume=True):
    return JTrainer(jstep, st, plan, rule, root, mesh=mesh,
                    snapshot_every=2, telemetry=JRegistry(), resume=resume)

  jt = jtrainer(str(tmp_path / "jax"))
  jl = jt.run(stream[:5])
  jt2 = jtrainer(str(tmp_path / "jax"))
  jl = jl[:jt2.consumed] + jt2.run(stream[jt2.consumed:])
  want = {**jt2.metrics_summary(),
          "resumed_from": os.path.basename(jt2.resumed_from)}
  assert want["skipped"] == 1 and want["steps"] == 5
  from distributed_embeddings_tpu.training import unpack_sparse_state
  params, aux = jax.tree_util.tree_map(np.asarray, unpack_sparse_state(
      plan, rule, jax.device_get(jt2.state), include_aux=True))
  for r in res:
    assert r["summary"] == want
    np.testing.assert_allclose(r["losses"], jl, **TOL)
  assert_w_final(res[0], params, aux)
  # the JAX trainer resumes the port's world-4 root
  jr = jtrainer(spec["root"])
  assert (jr.consumed, jr.skipped_steps, jr.step_count) == (5, 1, 4)
  assert jr.oov_totals == {k: 0 for k in jr.oov_totals} and jr.oov_totals

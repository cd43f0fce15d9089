"""The delta stream (``streaming/``) against the JAX package, at world 1.

One JAX reference run, shared by the module: ``tests/test_streaming.py``'s
small plan trained by the JAX sparse step over six batches, its state
taken after batches 2, 4 and 6. From those states each package's
publisher roots a chain (``publish_base``) and publishes two deltas, at
f32, int8 and fp8, under the raw plan and the ``dedup_exchange`` one;
each port publisher's tracker observes the same batches as the JAX one.
The states cross to the port through ``convert.train_state_from_flax``.

- the tracker: clock, stamps, counts, ``changed_rows`` and
  ``force_dirty`` bit-equal to the JAX tracker's;
- the publisher: every directory the port writes holds the JAX
  publisher's files, name for name, each ``.npy`` byte for byte and each
  ``.npz`` array for array, and an equal manifest apart from its wall
  clocks and digests (which carry the wall clocks);
- cross-reading: the port's subscriber folds the JAX-published chain, the
  JAX subscriber the port-published one, and the predictions of a probe
  are bit-equal to the JAX subscriber's over its own chain (activations
  through a model stub, f32, int8 and fp8 images);
- fold against re-export: the port's folded serve blocks are byte-equal
  to a full re-export at the same watermark;
- the checkpoint's ``stream`` section crosses both ways;
- the one-pass row gather is byte-equal to the window-wise reads and
  fires ``delta_extract`` with the same ``rows=``;
- the golden ``tests/data/torch_stream_golden.npz`` is current and
  replays on the CPU.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_stream_cases as SC
from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch import streaming as ts
from distributed_embeddings_torch.convert import train_state_from_flax
from distributed_embeddings_torch.ops.packed_table import PackedLayout
from distributed_embeddings_torch.resilience import faultinject as tfi
from distributed_embeddings_torch.serving import ServeEngine as TorchEngine
from distributed_embeddings_torch.serving import export as torch_export
from distributed_embeddings_torch.serving import load as torch_load
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu import streaming as js
from distributed_embeddings_tpu.layers.dist_model_parallel import set_weights
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.ops.packed_table import sparse_rule
from distributed_embeddings_tpu.training import (
    init_sparse_state,
    make_sparse_train_step,
)


class ActsModel:
  """The JAX model stub: the concatenated embedding activations."""

  def apply(self, variables, numerical, cats, emb_acts=None):
    del variables, numerical, cats
    return jnp.concatenate(list(emb_acts), axis=-1)


def loss_fn(preds, labels):
  return jnp.mean((jnp.sum(preds, axis=-1) - labels) ** 2)


def jax_plan(world=1, dedup=False):
  return DistEmbeddingStrategy(
      [TableConfig(s, w, combiner="sum")
       for s, w in zip(SC.SIZES, SC.WIDTHS)],
      world, "memory_balanced", **SC.plan_kw(dedup))


def jax_rule():
  return sparse_rule("adagrad", SC.SPARSE_LR)


def _numpy(state):
  return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in state.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
  """The JAX run, both packages' chains from its states, and the probe."""
  tmp = str(tmp_path_factory.mktemp("stream_ref"))
  rng = np.random.default_rng(11)
  plan, rule = jax_plan(), jax_rule()
  params = {"embeddings": {k: jnp.asarray(v) for k, v in set_weights(
      plan, SC.weights(0)).items()}}
  state = init_sparse_state(plan, params, rule, optax.sgd(SC.DENSE_LR))
  batches = [SC.mkbatch(rng, 4) for _ in range(6)]
  step = make_sparse_train_step(ActsModel(), plan, loss_fn,
                                optax.sgd(SC.DENSE_LR), rule, None, state,
                                batches[0], donate=False)
  states = []
  for i, bt in enumerate(batches):
    state, _ = step(state, *bt)
    if i % 2:
      states.append(_numpy(state))
  dirs = {}
  for dedup in (False, True):
    jp_, tp_ = jax_plan(1, dedup), SC.torch_plan(1, dedup)
    for q in SC.QUANTIZE:
      jdir = os.path.join(tmp, f"jax_{int(dedup)}_{q}")
      tdir = os.path.join(tmp, f"port_{int(dedup)}_{q}")
      jpub = js.DeltaPublisher(jdir, jp_, rule, js.RowGenerationTracker(jp_),
                               quantize=q)
      tpub = ts.DeltaPublisher(tdir, tp_, SC.torch_rule(),
                               ts.RowGenerationTracker(tp_), quantize=q)
      for k, s in enumerate(states):
        for bt in batches[2 * k:2 * k + 2]:
          jpub.observe_batch(bt[1])
          tpub.observe_batch(bt[1])
        port_state = train_state_from_flax(s, device="cpu")
        if k == 0:
          jpub.publish_base(s)
          tpub.publish_base(port_state)
        else:
          assert jpub.publish_delta(s) is not None
          assert tpub.publish_delta(port_state) is not None
      dirs[dedup, q] = (jdir, tdir, jpub, tpub)
  return {"tmp": tmp, "batches": batches, "states": states, "dirs": dirs,
          "probe": SC.mkbatch(np.random.default_rng(99), 8)}


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------


def test_tracker_bit_equal_to_jax(ref):
  jt = js.RowGenerationTracker(jax_plan())
  tt = ts.RowGenerationTracker(SC.torch_plan())
  for i, bt in enumerate(ref["batches"]):
    assert jt.observe(bt[1]) == tt.observe(
        [torch.from_numpy(c) for c in bt[1]] if i % 2 else bt[1])
  for wm in (0, 2, 5, 6):
    a, b = jt.changed_rows(wm), tt.changed_rows(wm)
    assert sorted(a) == sorted(b)
    for name in a:
      for x, y in zip(a[name], b[name]):
        np.testing.assert_array_equal(x, y)
    assert jt.changed_row_total(wm) == tt.changed_row_total(wm)
  name = sorted(jt.gen)[0]
  rows = {name: {0: np.array([0, 3, 7], np.int64)}}
  jt.force_dirty(rows, floor=9)
  tt.force_dirty(rows, floor=9)
  jt.force_dirty(rows)
  tt.force_dirty(rows)
  assert jt.clock == tt.clock == 11
  ja, ta = jt.state_arrays(), tt.state_arrays()
  assert sorted(ja) == sorted(ta)
  for k in ja:
    np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
  with pytest.raises(IndexError, match="outside"):
    tt.force_dirty({name: {0: np.array([10**6])}})
  with pytest.raises(ValueError, match="unknown class"):
    tt.force_dirty({"nope": {0: np.array([1])}})


# ---------------------------------------------------------------------------
# publisher parity, cross-reading, fold against re-export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", SC.QUANTIZE)
@pytest.mark.parametrize("dedup", [False, True])
def test_publisher_parity(ref, dedup, quantize):
  jdir, tdir, jpub, tpub = ref["dirs"][dedup, quantize]
  base = SC.compare_artifacts(os.path.join(tdir, "base"),
                              os.path.join(jdir, "base"))
  assert "manifest.json" in base
  assert js.published_delta_seqs(jdir) == ts.published_delta_seqs(tdir) \
      == [1, 2]
  for seq in (1, 2):
    names = SC.compare_artifacts(
        os.path.join(tdir, ts.delta_dirname(seq)),
        os.path.join(jdir, js.delta_dirname(seq)))
    assert any(n.startswith("rows_") for n in names)
    assert {"dense.npz", "emb_dense.npz"} <= set(names)
  assert tpub.seq == jpub.seq == 2
  assert tpub.watermark == jpub.watermark == 6
  assert tpub.last_publish_bytes == ts.artifact_bytes(
      os.path.join(tdir, ts.delta_dirname(2)))
  assert tpub.last_publish_bytes < ts.artifact_bytes(
      os.path.join(tdir, "base"))


@pytest.mark.parametrize("quantize", SC.QUANTIZE)
def test_each_package_folds_the_others_chain(ref, quantize):
  jdir, tdir, _, _ = ref["dirs"][False, quantize]
  plan, tplan = jax_plan(), SC.torch_plan()
  num, cats, _ = ref["probe"]

  def jax_sub(path):
    sub = js.DeltaSubscriber.from_artifact(ActsModel(), plan, path,
                                           heartbeat=False)
    assert sub.poll_once() == 2 and sub.last_refusal is None
    return sub.predict(num, cats)

  def port_sub(path):
    sub = ts.DeltaSubscriber.from_artifact(SC.TorchActsModel(), tplan, path,
                                           heartbeat=False, device="cpu")
    assert sub.poll_once() == 2 and sub.last_refusal is None
    assert sub.applied_seq == 2 and sub.engine.step == ref["states"][-1][
        "step"]
    return sub, sub.predict(num, cats)

  want = jax_sub(jdir)
  np.testing.assert_array_equal(jax_sub(tdir), want)
  sub, got = port_sub(jdir)
  np.testing.assert_array_equal(got, want)
  # fold against re-export: the folded blocks are the full export's bytes
  sub, got = port_sub(tdir)
  np.testing.assert_array_equal(got, want)
  full = os.path.join(ref["tmp"], f"full_{quantize}")
  torch_export(full, tplan, SC.torch_rule(),
               train_state_from_flax(ref["states"][-1], device="cpu"),
               quantize=quantize)
  art = torch_load(full, tplan, device="cpu")
  for name, block in art.state["serve"].items():
    assert torch.equal(sub.engine.state["serve"][name].view(torch.uint8),
                       block.view(torch.uint8)), name
  np.testing.assert_array_equal(
      TorchEngine(SC.TorchActsModel(), tplan, art,
                  device="cpu").predict(num, cats), want)


def test_checkpoint_stream_section_crosses(ref, tmp_path):
  """A JAX checkpoint's ``stream`` section restores into the port's
  publisher, and a port checkpoint's into the JAX one; both then attach
  to the other package's chain."""
  jdir, tdir, jpub, tpub = ref["dirs"][False, "int8"]
  plan, tplan = jax_plan(), SC.torch_plan()
  s = ref["states"][-1]
  like = SC.torch_state(tplan)
  jpath = str(tmp_path / "jax_ckpt")
  jck.save(jpath, plan, jax_rule(), s, stream=jpub)
  tpub2 = ts.DeltaPublisher(jdir, tplan, SC.torch_rule(),
                            ts.RowGenerationTracker(tplan), quantize="int8")
  tck.restore(jpath, tplan, SC.torch_rule(), like, stream=tpub2,
              device="cpu")
  tpath = str(tmp_path / "port_ckpt")
  tck.save(tpath, tplan, SC.torch_rule(), like, stream=tpub)
  assert jck.verify(tpath) == []
  sec_t, sec_j = (tck.read_manifest(p)["stream"] for p in (tpath, jpath))
  assert sorted(sec_t) == sorted(sec_j)
  for k in ("seq", "watermark", "clock", "quantize"):
    assert sec_t[k] == sec_j[k], k
  jpub2 = js.DeltaPublisher(tdir, plan, jax_rule(),
                            js.RowGenerationTracker(plan), quantize="int8")
  jck.restore(tpath, plan, jax_rule(), s, stream=jpub2)
  for got, want in ((tpub2, jpub), (jpub2, tpub)):
    assert not got.attached
    assert got.manifest_section() == want.manifest_section()
    ga, wa = got.state_arrays(), want.state_arrays()
    assert sorted(ga) == sorted(wa)
    for k in ga:
      np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
    assert got.attach() == 0 and got.attached
  # a quantize mismatch is refused naming it
  tpub3 = ts.DeltaPublisher(jdir, tplan, SC.torch_rule(),
                            ts.RowGenerationTracker(tplan), quantize="f32")
  with pytest.raises(ValueError, match="quantize='int8'"):
    tck.restore(jpath, tplan, SC.torch_rule(), like, stream=tpub3,
                device="cpu")


# ---------------------------------------------------------------------------
# the one-pass row gather against the window-wise reads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,n_aux", [(8, 1), (16, 0), (48, 1), (128, 0),
                                         (160, 0)])
def test_gather_equals_window_reads(width, n_aux):
  rng = np.random.default_rng(width + n_aux)
  lay = PackedLayout(rows=997, width=width, n_aux=n_aux)
  block = torch.from_numpy(
      rng.standard_normal(lay.shape).astype(np.float32))
  changed = np.unique(np.concatenate([
      rng.choice(lay.rows, 12, replace=False), np.arange(300, 340),
      [0, lay.rows - 1]])).astype(np.int64)

  class Recorder(tfi.FaultInjector):
    def __init__(self):
      super().__init__()
      self.rows = []

    def fire(self, site, **info):
      if site == "delta_extract":
        self.rows.append(info["rows"])
      super().fire(site, **info)

  def fired(fn):
    inj = Recorder()
    with tfi.injected(inj):
      out = fn()
    return out, inj.rows

  want, want_rows = fired(lambda: ts.extract_changed_rows(
      lay, lambda p0, p1: block[p0:p1].numpy(), changed))
  got, got_rows = fired(lambda: ts.publish.gather_changed_rows(
      lay, block, changed))
  assert got_rows == want_rows and len(got_rows) >= 2
  assert got.dtype == torch.float32
  assert got.numpy().tobytes() == want.tobytes()
  empty = ts.publish.gather_changed_rows(lay, block,
                                         np.zeros((0,), np.int64))
  assert tuple(empty.shape) == (0, width)


# ---------------------------------------------------------------------------
# the golden the card replays
# ---------------------------------------------------------------------------


def make_stream_golden():
  """The golden's arrays, from the JAX package on the CPU: a small DLRM
  trained by the JAX sparse step, its chain published (the base after
  ``STREAM_BASE_AFTER`` batches, a delta after each later one) and folded
  by the JAX
  subscriber, with each delta's row sets and rows and the predictions of
  a probe after each fold."""
  import tempfile

  from distributed_embeddings_torch import train_golden as tg
  from distributed_embeddings_tpu.models import DLRM, bce_loss
  from distributed_embeddings_tpu.ops import packed_table as jpt
  from distributed_embeddings_tpu.training import init_sparse_state_direct
  plan = tg.stream_plan(TableConfig, DistEmbeddingStrategy)
  model = DLRM(vocab_sizes=list(tg.STREAM_VOCAB),
               embedding_dim=tg.STREAM_DIM, bottom_mlp=tg.STREAM_BOTTOM,
               top_mlp=tg.STREAM_TOP,
               dense_row_threshold=tg.STREAM_DENSE_ROW_THRESHOLD)
  batches = tg.stream_batches()
  probe = tg.stream_probe()
  params = model.init(
      jax.random.PRNGKey(tg.STREAM_SEED), jnp.zeros((2, tg.STREAM_NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in tg.STREAM_VOCAB],
      emb_acts=[jnp.zeros((2, tg.STREAM_DIM))
                for _ in tg.STREAM_VOCAB])["params"]
  rule = jpt.sgd_rule(tg.LR)
  opt = optax.sgd(tg.LR)
  state = init_sparse_state_direct(plan, rule, params, opt,
                                   jax.random.PRNGKey(tg.STREAM_SEED + 1))
  out = {"numerical": np.stack([b[0] for b in batches]),
         "labels": np.stack([b[2] for b in batches]),
         "probe_numerical": probe[0]}
  for j in range(len(tg.STREAM_VOCAB)):
    out[f"cat/{j}"] = np.stack([b[1][j] for b in batches])
    out[f"probe_cat/{j}"] = probe[1][j]
  host = jax.device_get(state)
  for name, buf in host["fused"].items():
    out[f"fused0/{name}"] = np.asarray(buf)
  for name, table in host["emb_dense"].items():
    out[f"emb_dense0/{name}"] = np.asarray(table)
  for mlp, layers in host["dense"].items():
    for layer, leaves in layers.items():
      for leaf, arr in leaves.items():
        out[f"dense0/{mlp}/{layer}/{leaf}"] = np.asarray(arr)
  step = make_sparse_train_step(model, plan, bce_loss, opt, rule, None,
                                state, batches[0], donate=False)
  with tempfile.TemporaryDirectory() as tmp:
    pub = js.DeltaPublisher(tmp, plan, rule, js.RowGenerationTracker(plan),
                            quantize=tg.STREAM_QUANTIZE)
    sub = None
    for i, bt in enumerate(batches):
      pub.observe_batch(bt[1])
      state, _ = step(state, *bt)
      if i < tg.STREAM_BASE_AFTER - 1:
        continue
      if i == tg.STREAM_BASE_AFTER - 1:
        pub.publish_base(state)
        sub = js.DeltaSubscriber.from_artifact(model, plan, tmp,
                                               heartbeat=False)
      else:
        path = pub.publish_delta(state)
        assert sub.poll_once() == 1
        for f in sorted(os.listdir(path)):
          if f.startswith("rows_"):
            z = SC.npz_arrays(os.path.join(path, f))
            out[f"delta{i}/idx/{f[5:-4]}"] = z["idx"]
            out[f"delta{i}/data/{f[5:-4]}"] = z["data"]
      out[f"preds{i}"] = np.asarray(sub.predict(*probe), np.float32)
  return out


def test_stream_golden_is_current_and_replays_on_cpu():
  from distributed_embeddings_torch import train_golden as tg
  assert tg.STREAM_PATH.stat().st_size < 1024 * 1024
  committed = tg.load(tg.STREAM_PATH)
  fresh = make_stream_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  got = tg.replay_stream(committed, device="cpu")
  worst = tg.compare_stream(committed, got)
  assert worst["rows_max_err_share"] <= tg.UPDATE_TOL
  assert worst["deltas"] == tg.STREAM_STEPS - tg.STREAM_BASE_AFTER


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_streaming.py --write")
  jax.config.update("jax_platforms", "cpu")
  from distributed_embeddings_torch import train_golden as _tg
  np.savez_compressed(_tg.STREAM_PATH, **make_stream_golden())
  print(_tg.STREAM_PATH, _tg.STREAM_PATH.stat().st_size)

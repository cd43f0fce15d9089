"""The dynamic vocabulary in the port (``distributed_embeddings_torch/
dynvocab``, ``make_sparse_train_step`` under ``oov='allocate'``, the
``vocab`` checkpoint section, the serve snapshot) against the JAX
package's, on the JAX ``tests/test_dynvocab.py`` cell: tables ``[500,
300]`` of width 16, every table sparse, Adagrad 0.05 on the rows, Adam
1e-3 on the dense parameters.

- **Host state, bit-equal.** The open-addressing table, the count-min
  sketch and the row recycler under the same operation sequences; the
  translator over several steps of power-law raw 64-bit ids with
  admission, capacity denials and TTL evictions: translated ids, the
  per-class ``[allocs, evictions, admit_denied, occupancy]`` metrics, the
  zero work and ``state_arrays`` equal.
- **The trainer** against the JAX ``DynVocabTrainer`` on the same numpy
  batches: at world 1 (one-shot and two micro-batches) and at worlds 2
  and 4 over spawned gloo ranks (one spawn of four ranks:
  ``tests/torch_ranks.py: dynvocab_job``), translator state bit-equal,
  losses and final tables in the f32 class (rtol 1e-5, atol 1e-6); the
  id space pre-admitted as the identity, the run equals the static plan's
  bit for bit.
- **Lifecycle**: eviction, then the recycled row re-zeroed in every lane
  (Adagrad's accumulator too) before a new id lands on it; admission and
  the capacity cap deny and count; raw ids leaking past the translator
  are gated and raised.
- **Checkpoints**: a port checkpoint with a ``vocab`` section restores
  into the JAX package and the reverse, the refusals with the JAX
  messages, and the id space carried through a 4 -> 2 elastic restore.
- **Serving**: the exported ``vocab_snapshot`` translates raw request
  ids read-only, and ``predict`` on them equals the JAX engine's.
- **ResilientTrainer(dynvocab=)**: a killed and resumed run continues to
  the serial reference's losses and id space; the JAX refusals.
- **The golden** ``tests/data/torch_train_dynvocab_golden.npz``
  (``train_golden.replay_dynvocab``, which ``chip_smoke.py`` replays on
  the card) is regenerated from the JAX package and must equal the
  committed file; the port's CPU replay holds it. Rewrite it with
  ``PYTHONPATH=.:tests JAX_PLATFORMS=cpu python
  tests/test_torch_dynvocab.py --write``.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch import dynvocab as tdv
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import train_state_from_flax
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as tbce
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu import dynvocab as jdv
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.models.dlrm import _dlrm_initializer
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    shard_params,
)
from torch_ranks import free_port, spawn

TOL = dict(rtol=1e-5, atol=1e-6)
WIDTH = 16
VOCAB = [500, 300]
LR = 0.05
ADAM = 1e-3
B = 32
RAW = 10 ** 12  # raw ids spread over a 64-bit-sized space


# ---------------------------------------------------------------------------
# the cell, on both sides
# ---------------------------------------------------------------------------


def _plans(world, **kw):
  jt = [TableConfig(input_dim=v, output_dim=WIDTH,
                    initializer=_dlrm_initializer(v)) for v in VOCAB]
  tt = [TTableConfig(input_dim=v, output_dim=WIDTH) for v in VOCAB]
  return (DistEmbeddingStrategy(jt, world, "memory_balanced",
                                dense_row_threshold=0, **kw),
          TStrategy(tt, world, "memory_balanced", dense_row_threshold=0,
                    **kw))


def _jmodel(world):
  return DLRM(vocab_sizes=VOCAB, embedding_dim=WIDTH, bottom_mlp=(32, WIDTH),
              top_mlp=(32, 1), world_size=world, strategy="memory_balanced",
              dense_row_threshold=0)


def _tmodel():
  return TDLRM(VOCAB, WIDTH, bottom_mlp=(32, WIDTH), top_mlp=(32, 1),
               num_numerical=13, tables=False, device="cpu")


def _topt():
  return functools.partial(ttr.Adam, lr=ADAM)


def _raw_batch(seed, batch=B, space=None, alpha=1.05):
  """Numerical, raw-id cats (power law over ``space`` ranks, each rank
  mapped to a fixed random 40-bit id) and labels."""
  r = np.random.default_rng(seed)
  numerical = r.standard_normal((batch, 13)).astype(np.float32)
  cats = []
  for t, v in enumerate(VOCAB):
    n = space or 2 * v
    ranks = np.minimum(r.zipf(alpha + 1.0, batch) - 1, n - 1)
    keys = np.random.default_rng(1000 + t).choice(RAW, n, replace=False)
    cats.append(keys[ranks].astype(np.int64))
  labels = r.integers(0, 2, batch).astype(np.float32)
  return numerical, cats, labels


def _jax_state(world, plan):
  model = _jmodel(world)
  num = np.zeros((2, 13), np.float32)
  dense = model.init(jax.random.PRNGKey(0), num,
                     [np.zeros((2,), np.int32) for _ in VOCAB],
                     emb_acts=[np.zeros((2, WIDTH), np.float32)
                               for _ in VOCAB])["params"]
  return init_sparse_state_direct(plan, jpt.adagrad_rule(LR), dense,
                                  optax.adam(ADAM), jax.random.PRNGKey(1))


def _numpy_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense", "step")}


def _jax_trainer(world, plan, state, batch0, guard=True, micro_batches=1):
  mesh = create_mesh(world) if world > 1 else None
  tr = jdv.DynVocabTranslator(plan, jpt.adagrad_rule(LR))
  return jdv.DynVocabTrainer(
      _jmodel(world), plan, tr, bce_loss, optax.adam(ADAM),
      jpt.adagrad_rule(LR), mesh, shard_params(state, mesh), batch0,
      guard=guard, micro_batches=micro_batches, donate=False)


def _port_trainer(plan, nstate, guard=True, micro_batches=1, **kw):
  tr = tdv.DynVocabTranslator(plan, tpt.adagrad_rule(LR))
  state = ttr._with_optimizers(train_state_from_flax(nstate, device="cpu"),
                               _topt(), None)
  return tdv.DynVocabTrainer(_tmodel(), plan, tr, tbce, _topt(),
                             tpt.adagrad_rule(LR), None, state, guard=guard,
                             micro_batches=micro_batches, device="cpu", **kw)


def _translator_arrays(tr):
  return {k: np.asarray(v).copy() for k, v in tr.state_arrays().items()}


def _assert_arrays_equal(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _zero_work_equal(got, want):
  assert sorted(got) == sorted(want)
  for name in want:
    for a, b in zip(got[name], want[name]):
      np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# host state: bit-equal units
# ---------------------------------------------------------------------------


def test_table_and_recycler_churn_bit_equal():
  """The same insert / remove / allocate / release sequence (enough
  removals to force tombstone rebuilds) leaves the two packages' tables
  and recyclers with equal backing arrays, mappings and freelists."""
  cap = 64
  tabs = (tdv.IdTranslationTable(cap), jdv.IdTranslationTable(cap))
  recs = (tdv.RowRecycler(cap), jdv.RowRecycler(cap))
  rng = np.random.default_rng(11)
  live = []
  for step in range(1500):
    if live and (len(live) == cap or rng.random() < 0.5):
      rid = live.pop(int(rng.integers(len(live))))
      rows = [t.remove(rid) for t in tabs]
      assert rows[0] == rows[1]
      for r in recs:
        r.release(rows[0])
    else:
      rid = int(rng.integers(RAW))
      if rid in live:
        continue
      rows = [r.allocate(rid, step) for r in recs]
      assert rows[0] == rows[1] >= 0
      for t in tabs:
        t.insert(rid, rows[0])
      live.append(rid)
  for a, b in ((tabs[0]._keys, tabs[1]._keys), (tabs[0]._vals, tabs[1]._vals),
               *zip(tabs[0].items(), tabs[1].items())):
    np.testing.assert_array_equal(a, b)
  _assert_arrays_equal(recs[0].state(), {k: np.asarray(v) for k, v in
                                         recs[1].state().items()})
  probe = np.concatenate([np.asarray(live, np.int64),
                          rng.integers(0, RAW, 50)])
  np.testing.assert_array_equal(tabs[0].lookup(probe), tabs[1].lookup(probe))
  np.testing.assert_array_equal(recs[0].expired(1500, 300),
                                recs[1].expired(1500, 300))


def test_sketch_bit_equal():
  rng = np.random.default_rng(5)
  sks = (tdv.CountMinSketch(width=1 << 12, depth=4),
         jdv.CountMinSketch(width=1 << 12, depth=4))
  for _ in range(3):
    ids = rng.integers(0, RAW, 3000).astype(np.int64)
    for s in sks:
      s.update(ids)
  np.testing.assert_array_equal(sks[0].state(), sks[1].state())
  probe = rng.integers(0, RAW, 500).astype(np.int64)
  np.testing.assert_array_equal(sks[0].estimate(probe),
                                sks[1].estimate(probe))
  with pytest.raises(ValueError, match="width/depth"):
    tdv.CountMinSketch(width=1 << 9, depth=4).load_state(sks[0].state())


@pytest.mark.parametrize("world", [1, 2, 4])
def test_translator_bit_equal_over_steps(world):
  """Power-law raw ids over a space four times each table's capacity,
  ``admit_threshold=2``, ``evict_ttl=2`` and a capacity of 96 rows: the
  port's translator allocates, denies, evicts and re-zeroes exactly as
  the JAX one, step by step (zero targets over every shard window)."""
  kw = dict(oov="allocate", admit_threshold=2, evict_ttl=2,
            vocab_capacity=96)
  jplan, tplan = _plans(world, **kw)
  jtr = jdv.DynVocabTranslator(jplan, jpt.adagrad_rule(LR),
                               sketch_width=1 << 10)
  ttr_ = tdv.DynVocabTranslator(tplan, tpt.adagrad_rule(LR),
                                sketch_width=1 << 10)
  evictions = denied = 0
  for s in range(8):
    _, cats, _ = _raw_batch(40 + s, batch=64, space=4 * 96)
    got = ttr_.translate_batch(cats)
    want = jtr.translate_batch(cats)
    for g, w in zip(got[0], want[0]):
      np.testing.assert_array_equal(g, w)
    _assert_arrays_equal(got[1], want[1])
    _zero_work_equal(got[2], want[2])
    evictions += sum(int(v[1]) for v in got[1].values())
    denied += sum(int(v[2]) for v in got[1].values())
  assert evictions > 0 and denied > 0
  _assert_arrays_equal(_translator_arrays(ttr_), _translator_arrays(jtr))
  assert ttr_.manifest_section() == jtr.manifest_section()
  _, cats, _ = _raw_batch(99, batch=64, space=4 * 96)
  for g, w in zip(ttr_.translate_readonly(cats), jtr.translate_readonly(cats)):
    np.testing.assert_array_equal(g, w)
  # the read-only snapshot and its arrays
  tsnap = tdv.ReadonlyIdTranslator.from_translator(ttr_)
  jsnap = jdv.ReadonlyIdTranslator.from_translator(jtr)
  _assert_arrays_equal(tsnap.state_arrays(), jsnap.state_arrays())
  back = tdv.ReadonlyIdTranslator.from_arrays(jsnap.state_arrays())
  for g, w in zip(back.translate(cats), jsnap.translate(cats)):
    np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the trainer at world 1
# ---------------------------------------------------------------------------


def _port_tables(trainer, aux=True):
  params, aux_t = ttr.unpack_sparse_state(
      trainer.plan, tpt.adagrad_rule(LR), trainer.state, include_aux=aux,
      mesh=trainer.mesh)
  out = {k: v.numpy() for k, v in params["embeddings"].items()}
  out.update({f"aux/{k}": v[0].numpy() for k, v in aux_t.items()})
  return out


def _jax_tables(trainer, aux=True):
  from distributed_embeddings_tpu.training import unpack_sparse_state
  params, aux_j = unpack_sparse_state(
      trainer.plan, jpt.adagrad_rule(LR), jax.device_get(trainer.state),
      include_aux=aux)
  out = {k: np.asarray(v) for k, v in params["embeddings"].items()}
  out.update({f"aux/{k}": np.asarray(v[0]) for k, v in aux_j.items()})
  return out


def _close(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


KNOBS = dict(oov="allocate", admit_threshold=2, evict_ttl=2,
             vocab_capacity=120)


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_trainer_matches_jax_world1(micro_batches):
  """Six guarded steps of power-law raw ids with admission, capacity
  denials and evictions: the same translator state and lifecycle
  metrics, losses and tables (optimizer lanes too) in the f32 class."""
  jplan, tplan = _plans(1, **KNOBS)
  state = _jax_state(1, jplan)
  batches = [_raw_batch(200 + s, space=480) for s in range(6)]
  jt = _jax_trainer(1, jplan, state, batches[0],
                    micro_batches=micro_batches)
  tt = _port_trainer(tplan, _numpy_state(state),
                     micro_batches=micro_batches)
  want = [jt.step(*b) for b in batches]
  got = tt.run(batches)
  np.testing.assert_allclose(got, want, **TOL)
  _assert_arrays_equal(_translator_arrays(tt.translator),
                       _translator_arrays(jt.translator))
  assert tt.metrics_summary() == jt.metrics_summary()
  assert tt.metrics_summary()["rows_zeroed"] > 0
  _close(_port_tables(tt), _jax_tables(jt))


def test_identity_id_space_is_bit_exact_vs_static():
  """The id space pre-admitted as the identity (threshold 1 admits on
  sight; fresh rows in id order): the dynvocab run equals the static
  plan's run bit for bit, losses and every fused buffer."""
  jplan, tplan = _plans(1, oov="allocate")
  _, static = _plans(1)
  state = _jax_state(1, jplan)
  tt = _port_trainer(tplan, _numpy_state(state))
  tt.translator.translate_batch([np.arange(v, dtype=np.int64)
                                 for v in VOCAB])
  st = ttr._with_optimizers(train_state_from_flax(_numpy_state(state),
                                                  device="cpu"), _topt(), None)
  step = ttr.make_sparse_train_step(_tmodel(), static, tbce, _topt(),
                                    tpt.adagrad_rule(LR), guard=True)
  r = np.random.default_rng(7)
  for s in range(3):
    b = (r.standard_normal((B, 13)).astype(np.float32),
         [r.integers(0, v, B).astype(np.int64) for v in VOCAB],
         r.integers(0, 2, B).astype(np.float32))
    loss_dv = tt.step(*b)
    st, loss, _ = step(st, *ttr.shard_batch(b, device="cpu"))
    assert loss_dv == float(loss)
  for name in st["fused"]:
    assert torch.equal(tt.state["fused"][name], st["fused"][name]), name
  per = tt.metrics_summary()["per_class"]
  assert all(v["evictions"] == 0 and v["admit_denied"] == 0
             for v in per.values())


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def _lanes(trainer, table, row):
  """Every shard window's lanes (table row and optimizer state) of one
  table row, host copies."""
  out = []
  for (name, base, rs0, nrows, off, rpp) in trainer.translator._recipe[table]:
    if rs0 <= row < rs0 + nrows:
      local = row - rs0 + off
      stride = trainer.layouts[name].stride
      phys = trainer.state["fused"][name][base + local // rpp]
      out.append(phys[(local % rpp) * stride:
                      (local % rpp + 1) * stride].numpy().copy())
  assert out, "no shard window covers the row"
  return out


def test_eviction_then_reuse_lands_on_zeroed_row():
  """Under Adagrad: a trained id's row, once its TTL expires, reads zero
  in every lane of its stride (the accumulator too) before a new id
  recycles it (FIFO), and the new id's first update starts from zero."""
  jplan, tplan = _plans(1, oov="allocate", evict_ttl=2)
  state = _jax_state(1, jplan)
  tt = _port_trainer(tplan, _numpy_state(state))
  tr = tt.translator
  num, _, labels = _raw_batch(100)
  hot = 7_000_000_001
  fillers = (np.arange(B, dtype=np.int64) % 20) + 1
  cats1 = fillers.copy()
  cats1[0] = hot
  tt.step(num, [cats1, np.full(B, 42, np.int64)], labels)
  row = int(tr.tables[0].lookup(np.asarray([hot]))[0])
  assert row >= 0
  assert any(np.any(w != 0.0) for w in _lanes(tt, 0, row))
  # an untouched row was never written: its accumulator lanes hold the
  # rule's initial value, which the re-zeroing must clear as well
  for s in range(4):
    n2, _, l2 = _raw_batch(400 + s)
    tt.step(n2, [fillers, np.full(B, 42, np.int64)], l2)
  assert tr.tables[0].lookup(np.asarray([hot]))[0] == -1
  assert row in tr.recyclers[0].freelist
  for w in _lanes(tt, 0, row):
    assert np.all(w == 0.0), "the evicted row must re-zero in every lane"
  expect = tr.recyclers[0].freelist[0]
  new_id = 8_000_000_008
  before = tt.metrics_summary()["rows_zeroed"]
  assert before >= 1
  tt.step(num, [np.full(B, new_id, np.int64), np.full(B, 42, np.int64)],
          labels)
  assert int(tr.tables[0].lookup(np.asarray([new_id]))[0]) == expect
  per = tt.metrics_summary()["per_class"]
  assert sum(v["evictions"] for v in per.values()) > 0


def test_zero_rows_update_bf16_in_place():
  """The re-zeroing writes the buffer in place (no copy), on bf16
  buffers too, and touches only the targeted lanes."""
  lay = tpt.PackedLayout(rows=40, width=WIDTH, n_aux=1)
  for dtype in (torch.float32, torch.bfloat16):
    buf = torch.ones(lay.shape, dtype=dtype)
    ptr = buf.data_ptr()
    out = tdv.zero_rows_update(lay, buf, np.asarray([0, 3, 3]),
                               np.asarray([1, 0, 0]))
    assert out.data_ptr() == ptr
    rpp, st = lay.rows_per_phys, lay.stride
    want = torch.ones(lay.shape, dtype=dtype)
    want[0, st:2 * st] = 0
    want[3, 0:st] = 0
    assert torch.equal(out, want) and rpp >= 2


def test_admission_and_capacity_deny_and_count():
  jplan, tplan = _plans(1, oov="allocate", admit_threshold=3)
  state = _jax_state(1, jplan)
  tt = _port_trainer(tplan, _numpy_state(state))
  num, _, labels = _raw_batch(100)
  one_shot = np.arange(B, dtype=np.int64) + 10 ** 10
  tt.step(num, [one_shot, np.full(B, 1, np.int64)], labels)
  assert tt.translator.recyclers[0].occupancy == 0
  assert tt.translator.recyclers[1].occupancy == 1
  per = tt.metrics_summary()["per_class"]
  assert sum(v["admit_denied"] for v in per.values()) >= B
  jplan, tplan = _plans(1, oov="allocate", vocab_capacity=8)
  tt = _port_trainer(tplan, _numpy_state(_jax_state(1, jplan)))
  ids = np.arange(B, dtype=np.int64) + 5 * 10 ** 9
  tt.step(num, [ids, ids + 777], labels)
  assert [tt.translator.recyclers[t].occupancy for t in (0, 1)] == [8, 8]
  assert sum(v["admit_denied"] for v in
             tt.metrics_summary()["per_class"].values()) > 0


def test_untranslated_leak_is_gated_and_raised():
  """Raw out-of-range ids fed straight to the guarded allocate step
  commit nothing, are counted as the JAX step counts them, and
  ``check_oov`` raises with the JAX message."""
  from distributed_embeddings_torch.resilience import guards as tguards
  from distributed_embeddings_tpu.resilience import guards as jguards
  from distributed_embeddings_tpu.training import make_sparse_train_step
  jplan, tplan = _plans(1, oov="allocate")
  state = _jax_state(1, jplan)
  num, _, labels = _raw_batch(100)
  bad = (num, [np.full(B, VOCAB[0] + 50, np.int64), np.zeros(B, np.int64)],
         labels)
  jstep = make_sparse_train_step(_jmodel(1), jplan, bce_loss,
                                 optax.adam(ADAM), jpt.adagrad_rule(LR),
                                 None, state, bad, donate=False, guard=True)
  _, _, jm = jstep(state, *bad)
  st = ttr._with_optimizers(train_state_from_flax(_numpy_state(state),
                                                  device="cpu"), _topt(), None)
  before = {k: v.clone() for k, v in st["fused"].items()}
  step = ttr.make_sparse_train_step(_tmodel(), tplan, tbce, _topt(),
                                    tpt.adagrad_rule(LR), guard=True)
  st, _, tm = step(st, *ttr.shard_batch(bad, device="cpu"))
  assert {k: int(v) for k, v in tm["oov"].items()} == \
      {k: int(v) for k, v in jm["oov"].items()}
  assert int(tm["bad_step"]) == 1 and st["step"] == 0
  for k, v in before.items():
    assert torch.equal(st["fused"][k], v), k
  with pytest.raises(ValueError) as et:
    tguards.check_oov(tplan, tm["oov"], where="test")
  with pytest.raises(ValueError) as ej:
    jguards.check_oov(jplan, jm["oov"], where="test")
  assert str(et.value) == str(ej.value)
  assert "leaked past the dynvocab" in str(et.value)


def test_builders_refuse_allocate_with_the_jax_messages():
  """The tiered, eval, serve and dense-autodiff builders refuse an
  allocate plan as the JAX ones do; the translator refuses a tiered plan
  and a static one."""
  from distributed_embeddings_torch.serving.engine import make_serve_step
  from distributed_embeddings_torch.tiering import TieringConfig, \
      TieringPlan
  from distributed_embeddings_tpu.serving.engine import \
      make_serve_step as jserve
  from distributed_embeddings_tpu.tiering import TieringConfig as JCfg
  from distributed_embeddings_tpu.tiering import TieringPlan as JTPlan
  from distributed_embeddings_tpu.training import (
      make_sparse_eval_step,
      make_tiered_train_step,
      make_train_step,
  )
  jplan, tplan = _plans(1, oov="allocate")
  state = _jax_state(1, jplan)
  batch = _raw_batch(0)
  rule = tpt.adagrad_rule(LR)

  def same(exc, tfn, jfn):
    with pytest.raises(exc) as et:
      tfn()
    with pytest.raises(exc) as ej:
      jfn()
    assert str(et.value) == str(ej.value)

  same(ValueError,
       lambda: ttr.make_sparse_eval_step(_tmodel(), tplan, rule),
       lambda: make_sparse_eval_step(_jmodel(1), jplan, jpt.adagrad_rule(LR),
                                     None, state, batch))
  same(ValueError,
       lambda: make_serve_step(_tmodel(), tplan, {}),
       lambda: jserve(_jmodel(1), jplan, {}, None, state, batch))
  same(NotImplementedError,
       lambda: ttr.make_train_step(lambda *a: 0.0, None, _tmodel(),
                                   plan=tplan, device="cpu"),
       lambda: make_train_step(lambda p, *b: 0.0, optax.adam(ADAM), None,
                               {}, {}, batch, plan=jplan))
  tiered = [cls([cfg(input_dim=v, output_dim=WIDTH) for v in (5000, 300)],
                1, "memory_balanced", dense_row_threshold=0,
                host_row_threshold=1000, oov="allocate")
            for cls, cfg in ((TStrategy, TTableConfig),
                             (DistEmbeddingStrategy, TableConfig))]
  same(NotImplementedError,
       lambda: ttr.make_tiered_train_step(
           None, TieringPlan(tiered[0], rule, TieringConfig(staging_grps=64)),
           tbce, _topt(), rule),
       lambda: make_tiered_train_step(
           None, JTPlan(tiered[1], jpt.adagrad_rule(LR),
                        JCfg(staging_grps=64)),
           bce_loss, optax.adam(ADAM), jpt.adagrad_rule(LR), None, {}, None))
  same(NotImplementedError,
       lambda: tdv.DynVocabTranslator(tiered[0], rule),
       lambda: jdv.DynVocabTranslator(tiered[1], jpt.adagrad_rule(LR)))
  same(ValueError,
       lambda: tdv.DynVocabTranslator(_plans(1)[1], rule),
       lambda: jdv.DynVocabTranslator(_plans(1)[0], jpt.adagrad_rule(LR)))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _trained_pair(world=1, steps=3, **kw):
  jplan, tplan = _plans(world, **(kw or KNOBS))
  state = _jax_state(world, jplan)
  batches = [_raw_batch(500 + s, space=480) for s in range(steps)]
  jt = _jax_trainer(world, jplan, state, batches[0])
  for b in batches:
    jt.step(*b)
  tt = None
  if world == 1:
    tt = _port_trainer(tplan, _numpy_state(state))
    tt.run(batches)
  return jplan, tplan, jt, tt


def _fused_np(state):
  return {k: np.asarray(jax.device_get(v)) if not isinstance(v, torch.Tensor)
          else v.numpy() for k, v in state["fused"].items()}


def test_checkpoints_with_vocab_cross_both_ways(tmp_path):
  """A port checkpoint with the ``vocab`` section restores into the JAX
  package (translator state bit-equal, buffers bit-equal), and a JAX one
  into the port; the refusals carry the JAX messages; one process saves
  no ``pod_clock.json``."""
  jplan, tplan, jt, tt = _trained_pair()
  rule, jrule = tpt.adagrad_rule(LR), jpt.adagrad_rule(LR)
  ppath, jpath = str(tmp_path / "port"), str(tmp_path / "jax")
  tck.save(ppath, tplan, rule, tt.state, vocab=tt.translator)
  jck.save(jpath, jplan, jrule, jt.state, vocab=jt.translator)
  assert tck.read_manifest(ppath)["vocab"] == \
      jck.read_manifest(jpath)["vocab"]
  assert jck.verify(ppath) == []
  jtr = jdv.DynVocabTranslator(jplan, jrule)
  jstate = jck.restore(ppath, jplan, jrule, jt.state, vocab=jtr)
  _assert_arrays_equal(_translator_arrays(jtr),
                       _translator_arrays(tt.translator))
  _assert_arrays_equal(_fused_np(jstate), _fused_np(tt.state))
  ttr2 = tdv.DynVocabTranslator(tplan, rule)
  tstate = tck.restore(jpath, tplan, rule, tt.state, vocab=ttr2,
                       device="cpu")
  _assert_arrays_equal(_translator_arrays(ttr2),
                       _translator_arrays(jt.translator))
  _assert_arrays_equal(_fused_np(tstate), _fused_np(jt.state))
  assert tck.read_pod_clock(ppath) == jck.read_pod_clock(ppath) == {}

  def same(tfn, jfn, what):
    with pytest.raises(ValueError) as et:
      tfn()
    with pytest.raises(ValueError) as ej:
      jfn()
    assert str(et.value) == str(ej.value) and what in str(et.value)

  same(lambda: tck.save(str(tmp_path / "a"), tplan, rule, tt.state),
       lambda: jck.save(str(tmp_path / "b"), jplan, jrule, jt.state),
       "no DynVocabTranslator")
  same(lambda: tck.restore(ppath, tplan, rule, tt.state, device="cpu"),
       lambda: jck.restore(ppath, jplan, jrule, jt.state), "'vocab'")
  k3 = dict(KNOBS, admit_threshold=5)
  jplan3, tplan3 = _plans(1, **k3)
  same(lambda: tck.restore(ppath, tplan3, rule, tt.state, device="cpu",
                           vocab=tdv.DynVocabTranslator(tplan3, rule)),
       lambda: jck.restore(ppath, jplan3, jrule, jt.state,
                           vocab=jdv.DynVocabTranslator(jplan3, jrule)),
       "admit_threshold")


def test_vocab_survives_elastic_reshard(tmp_path):
  """A JAX world-4 run's checkpoint restores into the port at world 4
  (every rank's blocks in one process), the port saves it with its
  translator, and the port and JAX restores of that checkpoint at world
  2 carry the id space verbatim."""
  jplan4, tplan4, jt, _ = _trained_pair(world=4, steps=2)
  _, tplan2 = _plans(2, **KNOBS)
  jplan2 = _plans(2, **KNOBS)[0]
  rule, jrule = tpt.adagrad_rule(LR), jpt.adagrad_rule(LR)
  jpath, ppath = str(tmp_path / "j4"), str(tmp_path / "p4")
  jck.save(jpath, jplan4, jrule, jt.state, vocab=jt.translator)
  like4 = ttr._with_optimizers(train_state_from_flax(
      _numpy_state(_jax_state(4, jplan4)), device="cpu"), _topt(), None)
  tr4 = tdv.DynVocabTranslator(tplan4, rule)
  st4 = tck.restore(jpath, tplan4, rule, like4, vocab=tr4, device="cpu")
  tck.save(ppath, tplan4, rule, st4, vocab=tr4)
  like2 = ttr._with_optimizers(train_state_from_flax(
      _numpy_state(_jax_state(2, jplan2)), device="cpu"), _topt(), None)
  tr2 = tdv.DynVocabTranslator(tplan2, rule)
  tck.restore(ppath, tplan2, rule, like2, vocab=tr2, device="cpu")
  jtr2 = jdv.DynVocabTranslator(jplan2, jrule)
  jck.restore(ppath, jplan2, jrule, _jax_state(2, jplan2), vocab=jtr2)
  want = _translator_arrays(jt.translator)
  _assert_arrays_equal(_translator_arrays(tr2), want)
  _assert_arrays_equal(_translator_arrays(jtr2), want)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_snapshot_translates_then_predicts_as_jax(tmp_path):
  """The trained id space rides the serve artifact: request raw ids
  translated read-only by ``ServeArtifact.vocab`` (unmapped ids -> PAD),
  then ``predict``, equal to the JAX engine's on the JAX export."""
  from distributed_embeddings_torch import serving as tserving
  from distributed_embeddings_tpu import serving as jserving
  jplan, tplan, jt, tt = _trained_pair()
  rule = tpt.adagrad_rule(LR)
  ppath, jpath = str(tmp_path / "p"), str(tmp_path / "j")
  tserving.export(ppath, tplan, rule, tt.state, vocab=tt.translator)
  jserving.export(jpath, jplan, jpt.adagrad_rule(LR), jt.state,
                  vocab=jt.translator)
  jclip, tclip = _plans(1)  # the serve plan: same tables, static ids
  art = tserving.load(ppath, tclip, device="cpu")
  jart = jserving.load(jpath, jclip)
  _assert_arrays_equal(art.vocab.state_arrays(), jart.vocab.state_arrays())
  assert art.vocab.occupancy() == jart.vocab.occupancy()
  num, raw, _ = _raw_batch(77, space=480)
  cats = art.vocab.translate(raw)
  for g, w in zip(cats, jart.vocab.translate(raw)):
    np.testing.assert_array_equal(g, w)
  assert any(np.any(c == -1) for c in cats)  # unmapped ids ride as PAD
  got = tserving.ServeEngine(_tmodel(), tclip, art,
                             device="cpu").predict(num, cats)
  want = jserving.ServeEngine(_jmodel(1), jclip, jart).predict(
      num, tuple(jart.vocab.translate(raw)))
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the resilient trainer
# ---------------------------------------------------------------------------


def _resilient(root, jplan_tplan, state, **kw):
  from distributed_embeddings_torch.resilience.trainer import \
      ResilientTrainer
  from distributed_embeddings_torch.telemetry import MetricsRegistry
  _, tplan = jplan_tplan
  dvt = _port_trainer(tplan, _numpy_state(state))
  return ResilientTrainer(None, None, tplan, tpt.adagrad_rule(LR),
                          str(root), snapshot_every=2, resume=True,
                          dynvocab=dvt, telemetry=MetricsRegistry(), **kw)


def test_resilient_resume_restores_id_space_and_trajectory(tmp_path):
  """A killed dynvocab run resumed by a fresh trainer from its snapshots
  continues to the serial reference's losses, id space and counters, the
  overlapped loop (translate-ahead deferred at snapshot boundaries)
  giving the same losses; and the JAX refusals."""
  plans = _plans(1, oov="allocate", admit_threshold=1, evict_ttl=3)
  state = _jax_state(1, plans[0])
  stream = [_raw_batch(700 + s) for s in range(6)]
  ref = _resilient(tmp_path / "ref", plans, state)
  ref_losses = ref.run(stream)
  ovl = _resilient(tmp_path / "ovl", plans, state, overlap_host=True)
  assert ovl.run(stream) == ref_losses
  assert ovl.metrics_summary() == dict(ref.metrics_summary(),
                                       resumed_from=None)
  t1 = _resilient(tmp_path / "run", plans, state)
  first = [t1.step(*b) for b in stream[:3]]
  t2 = _resilient(tmp_path / "run", plans, state)
  assert t2.resumed_from is not None
  at = t2.consumed
  rest = t2.run(stream[at:])
  assert first[:at] + rest == ref_losses
  a, b = ref.dynvocab.translator, t2.dynvocab.translator
  _assert_arrays_equal(_translator_arrays(b), _translator_arrays(a))
  for name in ref.state["fused"]:
    assert torch.equal(ref.state["fused"][name], t2.state["fused"][name])
  assert ref.metrics_summary()["vocab"] == ovl.metrics_summary()["vocab"]
  with pytest.raises(NotImplementedError, match="async"):
    _resilient(tmp_path / "x", plans, state, async_snapshots=True)
  with pytest.raises(NotImplementedError, match="resize with dynvocab"):
    ref.resize(2)


# ---------------------------------------------------------------------------
# worlds 2 and 4 over spawned gloo ranks
# ---------------------------------------------------------------------------

OVERLAP = {4: "fused", 2: "pipelined"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  """One spawn of four ranks (``torch_ranks.dynvocab_job``) beside the
  JAX runs at worlds 4 and 2 on the same batches, from the same
  states."""
  tmp = tmp_path_factory.mktemp("dynvocab_ranks")
  batches = [_raw_batch(900 + s, space=480) for s in range(4)]
  jplans = {w: _plans(w, overlap=OVERLAP[w], **KNOBS)[0] for w in (2, 4)}
  states = {w: _jax_state(w, jplans[w]) for w in (2, 4)}
  spec = {"vocab": VOCAB, "knobs": KNOBS, "overlap": OVERLAP, "lr": LR,
          "adam": ADAM, "batches": batches, "ckpt": str(tmp / "ckpt4"),
          "port2": free_port(),
          **{f"state{w}": _numpy_state(states[w]) for w in (2, 4)}}
  res = spawn(tmp, 4, "dynvocab_job", spec)
  want = {}
  for w in (4, 2):
    jt = _jax_trainer(w, jplans[w], states[w], batches[0])
    want[w] = {"losses": [jt.step(*b) for b in batches],
               "tables": _jax_tables(jt),
               "vocab": _translator_arrays(jt.translator),
               "summary": jt.metrics_summary()}
  return res, want, spec


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_matches_jax_world_n(ranks, world):
  res, want, _ = ranks
  got = [r[f"w{world}"] for r in res[:world]]
  for r in got:
    np.testing.assert_allclose(r["losses"], want[world]["losses"], **TOL)
    _assert_arrays_equal(r["vocab"], want[world]["vocab"])
    assert r["summary"] == want[world]["summary"]
    _close(r["tables"], want[world]["tables"])
  assert got[0]["summary"]["rows_zeroed"] > 0


def test_world_n_save_and_4_to_2_restore(ranks):
  """The world-4 ranks' save carries the id space and every rank's clock
  record (``pod_clock.json``, read alike by both packages, rank 0 the
  reference); ranks 0 and 1, regrouped at world 2, restore it with the
  id space verbatim."""
  res, want, spec = ranks
  clocks = tck.read_pod_clock(spec["ckpt"])
  assert clocks == jck.read_pod_clock(spec["ckpt"])
  assert sorted(clocks) == [0, 1, 2, 3]
  assert clocks[0]["offset_ns"] == clocks[0]["uncertainty_ns"] == 0
  for r, rec in clocks.items():
    assert rec["process"] == r and rec["rounds"] == 8
    assert rec["uncertainty_ns"] == (0 if r == 0
                                     else max(1, rec["rtt_ns"] // 2))
  for r in res[:2]:
    _assert_arrays_equal(r["restored_vocab"], want[4]["vocab"])
  assert jck.verify(spec["ckpt"]) == []


# ---------------------------------------------------------------------------
# the golden the card replays
# ---------------------------------------------------------------------------


def make_dynvocab_golden():
  """The golden's arrays, from the JAX package on the CPU."""
  from distributed_embeddings_torch import train_golden as tg
  plan = tg.dynvocab_plan(TableConfig, DistEmbeddingStrategy)
  model = DLRM(vocab_sizes=list(tg.DYNVOCAB_VOCAB),
               embedding_dim=tg.DYNVOCAB_DIM, bottom_mlp=tg.DYNVOCAB_BOTTOM,
               top_mlp=tg.DYNVOCAB_TOP,
               dense_row_threshold=tg.DYNVOCAB_DENSE_ROW_THRESHOLD,
               compute_dtype=jnp.bfloat16)
  batches = tg.dynvocab_batches()
  params = model.init(
      jax.random.PRNGKey(tg.DYNVOCAB_SEED),
      jnp.zeros((2, tg.DYNVOCAB_NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in tg.DYNVOCAB_VOCAB],
      emb_acts=[jnp.zeros((2, tg.DYNVOCAB_DIM))
                for _ in tg.DYNVOCAB_VOCAB])["params"]
  rule = jpt.sgd_rule(tg.LR)
  opt = optax.sgd(tg.LR)
  state = init_sparse_state_direct(plan, rule, params, opt,
                                   jax.random.PRNGKey(tg.DYNVOCAB_SEED + 1))
  out = {"numerical": np.stack([b[0] for b in batches]),
         "labels": np.stack([b[2] for b in batches])}
  for j in range(len(tg.DYNVOCAB_VOCAB)):
    out[f"cat/{j}"] = np.stack([b[1][j] for b in batches])
  _golden_state(out, "0", state)
  tr = jdv.DynVocabTranslator(plan, rule,
                              sketch_width=tg.DYNVOCAB_SKETCH_WIDTH)
  jt = jdv.DynVocabTrainer(model, plan, tr, bce_loss, opt, rule, None, state,
                           batches[0], guard=True, donate=False)
  translated = []
  translate = jt.engine.translate_dynamic_ids

  def recorded(cats, translator):
    res = translate(cats, translator)
    translated.append([np.asarray(c) for c in res[0]])
    return res

  jt.engine.translate_dynamic_ids = recorded
  out["losses"] = np.asarray([jt.step(*b) for b in batches], np.float32)
  for j in range(len(tg.DYNVOCAB_VOCAB)):
    out[f"tcat/{j}"] = np.stack([t[j] for t in translated]).astype(np.int64)
  for k, v in tr.state_arrays().items():
    out[f"vocab/{k}"] = np.asarray(v)
  for name, v in jt.vocab_totals.items():
    out[f"vocab_totals/{name}"] = np.asarray(v)
  _golden_state(out, "_final", jax.device_get(jt.state))
  return out


def _golden_state(out, tag, state):
  for name, buf in state["fused"].items():
    out[f"fused{tag}/{name}"] = np.asarray(buf)
  for name, table in state["emb_dense"].items():
    out[f"emb_dense{tag}/{name}"] = np.asarray(table)
  for mlp, layers in state["dense"].items():
    for layer, leaves in layers.items():
      for leaf, arr in leaves.items():
        out[f"dense{tag}/{mlp}/{layer}/{leaf}"] = np.asarray(arr)


def test_dynvocab_golden_is_current_and_replays_on_cpu():
  from distributed_embeddings_torch import train_golden as tg
  assert tg.DYNVOCAB_PATH.stat().st_size < 1024 * 1024
  committed = tg.load(tg.DYNVOCAB_PATH)
  fresh = make_dynvocab_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  totals = np.stack([v for k, v in committed.items()
                     if k.startswith("vocab_totals/")])
  assert np.all(totals[:, :3].sum(axis=0) > 0)  # allocs, evictions, denials
  losses, got, translated, trainer = tg.replay_dynvocab(committed,
                                                        device="cpu")
  worst = tg.compare_dynvocab(committed, losses, got, translated, trainer)
  assert worst["state_max_err_share"] <= tg.UPDATE_TOL
  assert worst["rows_zeroed"] > 0


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_dynvocab.py --write")
  jax.config.update("jax_platforms", "cpu")
  from distributed_embeddings_torch import train_golden as _tg
  np.savez_compressed(_tg.DYNVOCAB_PATH, **make_dynvocab_golden())
  print(_tg.DYNVOCAB_PATH, _tg.DYNVOCAB_PATH.stat().st_size)

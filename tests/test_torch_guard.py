"""The guarded sparse train step (``make_sparse_train_step(guard=True)``),
``resilience.guards`` and the eval step's OOV metrics in the port, against
the JAX package's.

- **World 1.** One JAX state crosses by ``convert.train_state_from_flax``;
  a stream with a NaN batch goes through the JAX guarded step and the
  port's: the same ``bad_step`` and per-class ``oov`` metrics every step,
  the final states in the f32 class (rtol 1e-5, atol 1e-6); the port's
  skipped step leaves every array bit-equal to before (packed buffers
  with their optimizer lanes, dense-class tables, dense params, the dense
  optimizers' states — the schedule's count, momentum, Adagrad's sums —
  and ``step``), and the whole poisoned run is bit-equal to a clean run
  without that batch (so the skipped step's gradients were dropped).
  Under ``oov='error'`` an out-of-range id gates the step and
  ``check_oov`` raises with the JAX message, the state bit-equal; under
  ``'clip'`` it is counted and trains as the JAX step does.
- **World 4** (four gloo ranks, ``tests/torch_ranks.py: mb_guard_job``,
  against the JAX mesh step over a 4-device CPU mesh): a NaN in one
  rank's slice only is skipped by every rank, each rank's arrays
  bit-equal to before; an out-of-range id on one rank under
  ``oov='error'`` likewise, with ``check_oov`` raising on every rank; the
  metrics equal the JAX step's, the final states in the f32 class.
- **Guards**: ``all_finite``, ``check_oov`` (messages) and
  ``BadStepCounter`` against the JAX package's.
- **Eval metrics**: ``make_sparse_eval_step(with_metrics=True)`` counts
  as the JAX eval step does, at world 1 and 4.
- **Refusals**: ``guard`` with ``exact`` and ``oov='error'`` without the
  guard with the JAX messages; ``oov='allocate'`` (item 12) by name. A
  ``dedup_capacity`` plan is refused without the guard (and by the eval
  step without metrics) with the JAX messages, and with them reports the
  JAX steps' ``dedup_overflow`` counters.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    optax_state_of,
    train_state_from_flax,
)
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.parallel.lookup_engine import \
    class_param_name
from distributed_embeddings_torch.resilience import faultinject
from distributed_embeddings_torch.resilience import guards as tguards
from distributed_embeddings_torch.utils import data as tdata
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.resilience import guards as jguards
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_eval_step,
    make_sparse_train_step,
)
from distributed_embeddings_tpu.utils import data as jdata
from test_torch_micro_batch import (
    W_VOCAB,
    assert_w_final,
    w_batches,
    w_initial,
    w_jax_run,
    w_spec,
)
from torch_ranks import spawn

TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB = [40, 9, 200, 14, 120]
HOT = {2: 3}
NUM = 4
B = 16
D = 16
LR = 0.05
THRESHOLD = 16  # the two smallest tables ride a dense class
SCHED = (LR, 2, 3, 3)


def _dense_opts(name):
  if name == "sched":
    js, ts = jdata.dlrm_lr_schedule(*SCHED), tdata.dlrm_lr_schedule(*SCHED)
    return optax.sgd(js), lambda ps: ttr.ScheduledSGD(ps, ts)
  if name == "momentum":
    return (optax.sgd(LR, momentum=0.9),
            functools.partial(torch.optim.SGD, lr=LR, momentum=0.9))
  return optax.adagrad(LR), functools.partial(ttr.Adagrad, lr=LR)


def _plans(oov="clip"):
  def cfg(mod):
    return [mod(input_dim=v, output_dim=D,
                combiner="sum" if i in HOT else None)
            for i, v in enumerate(VOCAB)]
  return (DistEmbeddingStrategy(cfg(TableConfig), 1,
                                dense_row_threshold=THRESHOLD, oov=oov),
          TStrategy(cfg(TTableConfig), 1, dense_row_threshold=THRESHOLD,
                    oov=oov))


def _batches(n, seed=0):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n):
    cats = []
    for i, v in enumerate(VOCAB):
      if i in HOT:
        ids = rng.integers(0, v, (B, HOT[i])).astype(np.int32)
        ids[rng.random((B, HOT[i])) < 0.3] = -1
        cats.append(ids)
      else:
        cats.append(rng.integers(0, v, B).astype(np.int32))
    out.append((rng.standard_normal((B, NUM)).astype(np.float32), cats,
                rng.integers(0, 2, B).astype(np.float32)))
  return out


def _with_oov(batch, input_id=0, extra=7):
  """A copy of ``batch`` with one id of input ``input_id`` past its
  vocabulary."""
  numerical, cats, labels = batch
  cats = [c.copy() for c in cats]
  cats[input_id].reshape(-1)[0] = VOCAB[input_id] + extra
  return numerical, cats, labels


def _jax_model():
  return DLRM(vocab_sizes=VOCAB, embedding_dim=D, bottom_mlp=(16, D),
              top_mlp=(16, 1))


def _tmodel():
  return TDLRM(VOCAB, D, bottom_mlp=(16, D), top_mlp=(16, 1),
               num_numerical=NUM, tables=False, device="cpu")


def _jax_state(jplan, jrule, jopt):
  dense = _jax_model().init(
      jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
      emb_acts=[jnp.zeros((2, D)) for _ in VOCAB])["params"]
  return init_sparse_state_direct(jplan, jrule, dense, jopt,
                                  jax.random.PRNGKey(1))


def _numpy_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense", "step")}


def _arrays(state):
  """Every array of a port state (optimizer states in optax's spelling),
  copied."""
  out = {f"fused/{k}": v.clone() for k, v in state["fused"].items()}
  for part in ("dense", "emb_dense"):
    out.update({f"{part}/{k}": v.detach().clone()
                for k, v in state[part].items()})
    out.update({f"{part}_opt/{k}": torch.from_numpy(v)
                for k, v in optax_state_of(state[f"{part}_opt"],
                                           state[part]).items()})
  out["step"] = torch.tensor(state["step"])
  return out


def _assert_bit_equal(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k


def _t(batch):
  numerical, cats, labels = batch
  return (torch.tensor(numerical), [torch.tensor(c) for c in cats],
          torch.tensor(labels))


def _j(batch):
  numerical, cats, labels = batch
  return (jnp.asarray(numerical), [jnp.asarray(c) for c in cats],
          jnp.asarray(labels))


def _ints(m):
  return {"bad_step": int(m["bad_step"]),
          "oov": {k: int(v) for k, v in m["oov"].items()}}


def _both(opt_name, rule_name, oov="clip"):
  jplan, tplan = _plans(oov)
  jopt, topt = _dense_opts(opt_name)
  jrule = getattr(jpt, f"{rule_name}_rule")(LR)
  trule = getattr(tpt, f"{rule_name}_rule")(LR)
  state = _jax_state(jplan, jrule, jopt)
  batches = _batches(4)
  jstep = make_sparse_train_step(_jax_model(), jplan, bce_loss, jopt, jrule,
                                 None, state, batches[0], donate=False,
                                 guard=True)
  tstep = ttr.make_sparse_train_step(_tmodel(), tplan, torch_bce, topt,
                                     trule, guard=True)

  def fresh():
    return ttr._with_optimizers(
        train_state_from_flax(_numpy_state(state), device="cpu"), topt, None)

  return jplan, tplan, state, batches, jstep, tstep, fresh


@pytest.mark.parametrize("opt_name,rule_name", [("sched", "sgd"),
                                                ("momentum", "adagrad"),
                                                ("adagrad", "momentum")])
def test_nan_batch_is_skipped_bit_exactly_as_in_jax(opt_name, rule_name):
  _, _, state, batches, jstep, tstep, fresh = _both(opt_name, rule_name)
  poisoned = list(faultinject.nan_batches(batches, at_steps={2}))
  tstate, jstate = fresh(), state
  for i, batch in enumerate(poisoned):
    before = _arrays(tstate)
    jstate, jloss, jm = jstep(jstate, *_j(batch))
    tstate, tloss, tm = tstep(tstate, *_t(batch))
    assert _ints(tm) == _ints(jm)
    assert _ints(tm)["bad_step"] == int(i == 2)
    if i == 2:
      assert np.isnan(float(tloss)) and np.isnan(float(jloss))
      _assert_bit_equal(_arrays(tstate), before)
      # no gradient is left behind to join the next step's
      assert all(t.grad is None for part in ("dense", "emb_dense")
                 for t in tstate[part].values())
    else:
      np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
  assert tstate["step"] == int(jstate["step"]) == 3
  for name, buf in jstate["fused"].items():
    np.testing.assert_allclose(tstate["fused"][name].numpy(),
                               np.asarray(buf), err_msg=name, **TOL)
  clean = fresh()
  for i in (0, 1, 3):
    clean, _, _ = tstep(clean, *_t(batches[i]))
  _assert_bit_equal(_arrays(tstate), _arrays(clean))


def test_oov_error_gates_the_step_and_check_oov_raises_as_in_jax():
  jplan, tplan, state, batches, jstep, tstep, fresh = _both(
      "momentum", "adagrad", oov="error")
  tstate, jstate = fresh(), state
  tstate, _, _ = tstep(tstate, *_t(batches[0]))
  jstate, _, _ = jstep(jstate, *_j(batches[0]))
  bad = _with_oov(batches[1], input_id=2)
  before = _arrays(tstate)
  tstate, _, tm = tstep(tstate, *_t(bad))
  jstate, _, jm = jstep(jstate, *_j(bad))
  assert _ints(tm) == _ints(jm)
  assert _ints(tm)["bad_step"] == 1 and sum(_ints(tm)["oov"].values()) == 1
  _assert_bit_equal(_arrays(tstate), before)
  with pytest.raises(ValueError) as et:
    tguards.check_oov(tplan, tm["oov"])
  with pytest.raises(ValueError) as ej:
    jguards.check_oov(jplan, jm["oov"])
  assert str(et.value) == str(ej.value)
  assert "OOV policy 'error'" in str(et.value)
  # the unguarded builder refuses the policy with the JAX message
  with pytest.raises(ValueError) as et:
    ttr.make_sparse_train_step(_tmodel(), tplan, torch_bce,
                               _dense_opts("sgd")[1], tpt.sgd_rule(LR))
  with pytest.raises(ValueError) as ej:
    make_sparse_train_step(_jax_model(), jplan, bce_loss, optax.sgd(LR),
                           jpt.sgd_rule(LR), None, state, batches[0])
  assert str(et.value) == str(ej.value)


def test_oov_clip_is_counted_and_trains_as_in_jax():
  _, _, state, batches, jstep, tstep, fresh = _both("adagrad", "adagrad")
  tstate, jstate = fresh(), state
  for i, batch in enumerate(batches):
    if i % 2:
      batch = _with_oov(_with_oov(batch, 0), 4, extra=1)
    jstate, jloss, jm = jstep(jstate, *_j(batch))
    tstate, tloss, tm = tstep(tstate, *_t(batch))
    assert _ints(tm) == _ints(jm)
    assert _ints(tm)["bad_step"] == 0
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
  assert sum(_ints(tm)["oov"].values()) == 2
  for name, buf in jstate["fused"].items():
    np.testing.assert_allclose(tstate["fused"][name].numpy(),
                               np.asarray(buf), err_msg=name, **TOL)


def test_guards_match_jax():
  jplan, tplan = _plans("error")
  trees = [
      {"a": np.ones(3, np.float32), "b": (np.arange(3), [np.zeros(2)])},
      {"a": np.array([1.0, np.nan], np.float32)},
      [np.array([np.inf]), np.ones(2, np.int32)],
      {"empty": {}},
  ]
  for tree in trees:
    tt = {"t": tree} if not isinstance(tree, list) else tree
    want = bool(jguards.all_finite(tt))
    got = tguards.all_finite(
        jax.tree_util.tree_map(lambda x: torch.as_tensor(np.asarray(x)), tt))
    assert isinstance(got, torch.Tensor) and bool(got) == want
  names = sorted(class_param_name(*k) for k in tplan.class_keys)
  counts = {n: i for i, n in enumerate(names)}
  for policy in ("clip", "error"):
    jplan.oov = tplan.oov = policy
    try:
      want = jguards.check_oov(jplan, counts)
    except ValueError as e:
      want = str(e)
    try:
      got = tguards.check_oov(tplan, {k: torch.tensor(v, dtype=torch.int32)
                                      for k, v in counts.items()})
    except ValueError as e:
      got = str(e)
    assert got == want
  jplan.oov = tplan.oov = "error"
  assert tguards.check_oov(tplan, {n: 0 for n in names}) == \
      jguards.check_oov(jplan, {n: 0 for n in names})
  for limit in (1, 2, None):
    jc, tc = jguards.BadStepCounter(limit), tguards.BadStepCounter(limit)
    for bad in (0, 1, 1, 0, 1, 1, 1):
      assert tc.update(torch.tensor(bad)) == jc.update(bad)
      assert (tc.skipped, tc.consecutive) == (jc.skipped, jc.consecutive)
  for bad_limit in (0, -1):
    with pytest.raises(ValueError) as et:
      tguards.BadStepCounter(bad_limit)
    with pytest.raises(ValueError) as ej:
      jguards.BadStepCounter(bad_limit)
    assert str(et.value) == str(ej.value)


def test_eval_metrics_count_as_in_jax():
  for oov in ("clip", "error"):
    jplan, tplan = _plans(oov)
    jrule, trule = jpt.sgd_rule(LR), tpt.sgd_rule(LR)
    state = _jax_state(jplan, jrule, optax.sgd(LR))
    batch = _with_oov(_with_oov(_batches(1)[0], 2), 3, extra=2)
    numerical, cats, _ = batch
    jev = make_sparse_eval_step(_jax_model(), jplan, jrule, None, state,
                                batch, with_metrics=True)
    jp, jm = jev(state, jnp.asarray(numerical),
                 [jnp.asarray(c) for c in cats])
    tev = ttr.make_sparse_eval_step(_tmodel(), tplan, trule,
                                    with_metrics=True)
    tstate = train_state_from_flax(_numpy_state(state), device="cpu")
    tp, tm = tev(tstate, torch.tensor(numerical),
                 [torch.tensor(c) for c in cats])
    assert {k: int(v) for k, v in tm["oov"].items()} == \
        {k: int(v) for k, v in jm["oov"].items()}
    assert sum(int(v) for v in tm["oov"].values()) == 2
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_refusals():
  jplan, tplan = _plans()
  jrule, trule = jpt.adagrad_rule(LR), tpt.adagrad_rule(LR)
  state = _jax_state(jplan, jrule, optax.sgd(LR))
  sgd = _dense_opts("momentum")[1]
  with pytest.raises(NotImplementedError) as et:
    ttr.make_sparse_train_step(_tmodel(), tplan, torch_bce, sgd, trule,
                               guard=True, exact=True)
  with pytest.raises(NotImplementedError) as ej:
    make_sparse_train_step(_jax_model(), jplan, bce_loss, optax.sgd(LR),
                           jrule, None, state, _batches(1)[0], guard=True,
                           exact=True)
  assert str(et.value) == str(ej.value)
  alloc = TStrategy([TTableConfig(input_dim=v, output_dim=D) for v in VOCAB],
                    1, dense_row_threshold=THRESHOLD, oov="allocate")
  with pytest.raises(NotImplementedError, match="item 12"):
    ttr.make_sparse_train_step(_tmodel(), alloc, torch_bce, sgd, trule,
                               guard=True)
  # a capped dedup_capacity: refused without the counter path, with the
  # JAX messages; with it, the guarded step and the eval step surface the
  # per-class dedup_overflow counters the JAX steps return (zero at world
  # 1, where nothing crosses a wire to dedup)
  jcap, tcap = (
      cls([cfg(input_dim=v, output_dim=D,
               combiner="sum" if i in HOT else None)
           for i, v in enumerate(VOCAB)], 1,
          dense_row_threshold=THRESHOLD, dedup_exchange=True,
          dedup_capacity=8)
      for cls, cfg in ((DistEmbeddingStrategy, TableConfig),
                       (TStrategy, TTableConfig)))
  batch = _batches(1)[0]
  with pytest.raises(ValueError) as et:
    ttr.make_sparse_train_step(_tmodel(), tcap, torch_bce, sgd, trule)
  with pytest.raises(ValueError) as ej:
    make_sparse_train_step(_jax_model(), jcap, bce_loss, optax.sgd(LR),
                           jrule, None, state, batch)
  assert str(et.value) == str(ej.value)
  with pytest.raises(ValueError) as et:
    ttr.make_sparse_eval_step(_tmodel(), tcap, trule)
  with pytest.raises(ValueError) as ej:
    make_sparse_eval_step(_jax_model(), jcap, jrule, None, state, batch)
  assert str(et.value) == str(ej.value)
  jstep = make_sparse_train_step(_jax_model(), jcap, bce_loss,
                                 optax.sgd(LR), jrule, None, state, batch,
                                 guard=True, donate=False)
  _, jloss, jm = jstep(state, jnp.asarray(batch[0]),
                       [jnp.asarray(c) for c in batch[1]],
                       jnp.asarray(batch[2]))
  tstep = ttr.make_sparse_train_step(_tmodel(), tcap, torch_bce, sgd,
                                     trule, guard=True)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  _, tloss, tm = tstep(tstate, torch.tensor(batch[0]),
                       [torch.tensor(c) for c in batch[1]],
                       torch.tensor(batch[2]))
  np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
  want = {k: int(v) for k, v in jm["dedup_overflow"].items()}
  assert {k: int(v) for k, v in tm["dedup_overflow"].items()} == want
  assert set(want) == set(tm["oov"])
  jev = make_sparse_eval_step(_jax_model(), jcap, jrule, None, state,
                              batch, with_metrics=True)
  _, jem = jev(state, jnp.asarray(batch[0]),
               [jnp.asarray(c) for c in batch[1]])
  _, tem = ttr.make_sparse_eval_step(_tmodel(), tcap, trule,
                                     with_metrics=True)(
      tstate, torch.tensor(batch[0]), [torch.tensor(c) for c in batch[1]])
  assert {k: int(v) for k, v in tem["dedup_overflow"].items()} == \
      {k: int(v) for k, v in jem["dedup_overflow"].items()}


# ---------------------------------------------------------------------------
# world 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world4_guard(tmp_path_factory):
  state = w_initial()
  batches = w_batches(4, seed=9)
  runs = [
      {"name": "nan", "overlap": "fused", "micro_batches": 1, "guard": True,
       "nan_rank": 2, "nan_steps": (1,)},
      {"name": "oov", "overlap": "none", "micro_batches": 1, "guard": True,
       "oov": "error", "oov_rank": 1, "oov_steps": (2,),
       "eval": _eval_batch(batches[0])},
      {"name": "nan_mb", "overlap": "fused", "micro_batches": 2,
       "guard": True, "nan_rank": 0, "nan_steps": (0,)},
  ]
  res = spawn(tmp_path_factory.mktemp("guard4"), 4, "mb_guard_job",
              w_spec(state, runs, batches))
  return state, batches, res


def _eval_batch(batch):
  """``batch``'s features and ids with out-of-range ids in three ranks'
  slices (a dense and a sparse class among them)."""
  numerical, cats, _ = batch
  cats = [c.copy() for c in cats]
  n = len(numerical) // 4
  cats[0][0] = W_VOCAB[0] + 1
  cats[0][n + 1] = W_VOCAB[0] + 2
  cats[-1][3 * n + 2] = W_VOCAB[-1] + 9
  return numerical, cats


def _global(batches, rank, steps, poison):
  """The global batches with rank ``rank``'s slice poisoned at ``steps``
  (``poison(batch, lo, hi)``)."""
  out = []
  for i, (numerical, cats, labels) in enumerate(batches):
    numerical, cats = numerical.copy(), [c.copy() for c in cats]
    if i in steps:
      n = len(labels) // 4
      poison(numerical, cats, rank * n, (rank + 1) * n)
    out.append((numerical, cats, labels))
  return out


def _nan(numerical, cats, lo, hi):
  numerical[lo:hi] = np.nan


def _oov(numerical, cats, lo, hi):
  cats[0][lo] = W_VOCAB[0] + 5  # as mb_guard_job poisons the rank's slice


@pytest.mark.parametrize("run,rank,steps,poison,oov", [
    ("nan", 2, (1,), _nan, "clip"), ("oov", 1, (2,), _oov, "error")])
def test_world4_one_rank_poison_is_skipped_by_every_rank(
    world4_guard, run, rank, steps, poison, oov):
  state, batches, res = world4_guard
  overlap = "fused" if run == "nan" else "none"
  losses, metrics, (params, aux) = w_jax_run(
      state, _global(batches, rank, steps, poison), guard=True,
      overlap=overlap, oov=oov)
  for r in res:
    got = r[run]
    assert got["metrics"] == metrics
    assert [i for i, _ in got["skipped"]] == list(steps)
    assert all(not diff for _, diff in got["skipped"]), got["skipped"]
    assert got["step"] == len(batches) - len(steps)
    finite = [i for i in range(len(batches)) if i not in steps]
    np.testing.assert_allclose([got["losses"][i] for i in finite],
                               [losses[i] for i in finite], **TOL)
    if oov == "error":
      assert [i for i, _ in got["raised"]] == list(steps)
      assert "OOV policy 'error'" in got["raised"][0][1]
  assert_w_final(res[0][run], params, aux)


def test_world4_micro_batches_with_the_guard(world4_guard):
  """``micro_batches=2`` with the guard at world 4: the NaN on rank 0's
  slice is skipped everywhere, the rest against the JAX one-shot
  guarded mesh step."""
  state, batches, res = world4_guard
  poisoned = _global(batches, 0, (0,), _nan)
  losses, metrics, (params, aux) = w_jax_run(state, poisoned, guard=True,
                                             overlap="fused")
  for r in res:
    got = r["nan_mb"]
    assert got["metrics"] == metrics
    assert got["skipped"] == [(0, [])]
    np.testing.assert_allclose(got["losses"][1:], losses[1:], **TOL)
  assert_w_final(res[0]["nan_mb"], params, aux)


def test_world4_eval_metrics_count_as_in_jax(world4_guard):
  state, batches, res = world4_guard
  poisoned = _global(batches, 1, (2,), _oov)
  *_, evaluated = w_jax_run(state, poisoned, guard=True, overlap="none",
                            oov="error", eval_batch=_eval_batch(batches[0]))
  assert sum(evaluated["oov"].values()) == 3
  for r in res:
    got = r["oov"]["eval"]
    assert got["oov"] == evaluated["oov"]
    np.testing.assert_allclose(got["preds"], evaluated["preds"], **TOL)

"""Narrow storage (bf16 tables) in the port against the JAX package, world 1.

The JAX package keeps bf16 fused buffers and dense-class tables when
``init_sparse_state_direct(dtype=jnp.bfloat16)`` draws them; its step
then gathers bf16 rows, applies bf16 buffers with XLA's scatter (the
delta cast to bf16, SGD's scale cast to bf16, each add rounded to bf16)
and updates the dense-class tables from f32 gradients. One JAX bf16
state is carried across (``convert.train_state_from_flax``, bf16 leaves
as their bits) and both packages run the same batches on the CPU:

- the port's own bf16 init: dtypes, layout, the aux constants bit-equal
  to the JAX init's, the draw's distribution;
- the eval step's activations (a model stub that returns them) bit-equal;
- K1's plain bf16 version bit-equal to JAX ``scatter_add_fused`` on a
  bf16 buffer, with duplicates and out-of-range ids (XLA adds one
  occurrence after another; the plain version does too);
- three SGD and three Adagrad steps on a DLRM with sparse and dense
  classes, narrow (several rows a physical row) and multi-hot classes,
  ``exact=True``: every cell within ``ULPS`` bf16 ulps of the JAX step's
  (the ulp of the larger magnitude) and at least ``BIT_EQUAL_SHARE`` of
  the cells bit-equal (the share is printed); the losses in the f32
  class;
- the same bf16 run against the port's own f32 run from the same
  (bf16-representable) values, within a bf16 bound;
- bf16 buffers run under the momentum and Adam rules, with ragged and
  deduplicated buckets, and in the dense-autodiff layer (held to the JAX
  package in ``tests/test_torch_narrow_rules.py``); micro-batches stay
  refused, as the JAX micro-batched step fails on them;
- ``convert`` both ways, checkpoints byte-equal to the JAX package's
  saves, and the JAX ``restore``'s ``TypeError`` on its own bf16 save
  (the reference divergence the port does not share);
- f32 and int8 serve images frozen from the bf16 state equal to JAX's;
- the committed narrow-storage train golden
  (``tests/data/torch_train_bf16_golden.npz``, which ``chip_smoke.py``
  replays on the card) current, and replayed on the CPU within
  ``train_golden``'s tolerances. Rewrite it after a deliberate change with
  ``python tests/test_torch_narrow_storage.py --write``.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from torch import nn
from torch_narrow_cases import one_torch_thread  # noqa: F401 (autouse)

from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    train_state_from_flax,
    train_state_to_flax,
)
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.ops import cuda_apply
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.parallel.lookup_engine import \
    DistributedLookup
from distributed_embeddings_torch.serving import freeze as torch_freeze
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.models.dlrm import dlrm_embedding_plan
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.serving.export import freeze
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_eval_step,
    make_sparse_train_step,
)

BF16 = ml_dtypes.bfloat16
TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB = [50, 7, 300, 12, 90, 4000]
NUM = 4
B = 32
STEPS = 3
LR = 0.5
PAD_ID = -1
THRESHOLD = 64
# every cell within this many bf16 ulps of the JAX step's (the ulp of the
# larger of the two magnitudes), and at least this share bit-equal
ULPS = 4
BIT_EQUAL_SHARE = 0.999

# name -> (width, rule, exact, multi-hot inputs (input -> hotness)). At
# width 16 a class packs several rows a physical row (8 under SGD, 4 with
# Adagrad's accumulator lanes).
CASES = {
    "sgd_d128": (128, "sgd", False, {}),
    "sgd_d16_multihot": (16, "sgd", False, {0: 3, 5: 4}),
    "adagrad_d16": (16, "adagrad", False, {}),
    "adagrad_d128_multihot": (128, "adagrad", False, {2: 3}),
    "adagrad_d16_exact": (16, "adagrad", True, {}),
}


def _configs(mod, d, hot):
  return [mod(input_dim=v, output_dim=d,
              combiner="sum" if i in hot else None)
          for i, v in enumerate(VOCAB)]


def _plans(d, hot):
  return (DistEmbeddingStrategy(_configs(TableConfig, d, hot), 1,
                                dense_row_threshold=THRESHOLD),
          TStrategy(_configs(TTableConfig, d, hot), 1,
                    dense_row_threshold=THRESHOLD))


def _batches(hot, seed=0, steps=STEPS):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(steps):
    cats = []
    for i, v in enumerate(VOCAB):
      if i in hot:
        ids = rng.integers(0, v, (B, hot[i])).astype(np.int32)
        ids[rng.random((B, hot[i])) < 0.3] = PAD_ID
        cats.append(ids)
      else:
        cats.append(rng.integers(0, v, B).astype(np.int32))
    out.append((rng.standard_normal((B, NUM)).astype(np.float32), cats,
                rng.integers(0, 2, B).astype(np.float32)))
  return out


def _rules(name):
  return getattr(jpt, f"{name}_rule")(LR), getattr(tpt, f"{name}_rule")(LR)


def _jax_model(d):
  return DLRM(vocab_sizes=VOCAB, embedding_dim=d, bottom_mlp=(32, d),
              top_mlp=(32, 16, 1))


def _torch_model(d):
  return TDLRM(VOCAB, d, bottom_mlp=(32, d), top_mlp=(32, 16, 1),
               num_numerical=NUM, tables=False, device="cpu")


def _jax_dense_params(d):
  acts = [jnp.zeros((2, d)) for _ in VOCAB]
  cats = [jnp.zeros((2,), jnp.int32) for _ in VOCAB]
  return _jax_model(d).init(jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
                            cats, emb_acts=acts)["params"]


def _jax_state(case, dtype=jnp.bfloat16):
  d, rule_name, _, hot = CASES[case]
  jplan, _ = _plans(d, hot)
  jrule, _ = _rules(rule_name)
  return init_sparse_state_direct(jplan, jrule, _jax_dense_params(d),
                                  optax.sgd(LR), jax.random.PRNGKey(1),
                                  dtype=dtype)


def _numpy_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense", "step")}


def _f32(x) -> np.ndarray:
  """A bf16 tensor, an ml_dtypes array or an f32 array as f32 numpy."""
  if isinstance(x, torch.Tensor):
    return x.detach().to(torch.float32).numpy()
  return np.asarray(x).astype(np.float32)


def _bits(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().view(torch.int16).numpy().view(np.uint16)
  return np.asarray(x).view(np.uint16)


def _ulps(got, want) -> np.ndarray:
  """|got - want| in bf16 ulps of the larger magnitude of the two."""
  g, w = _f32(got), _f32(want)
  m = np.maximum(np.abs(g), np.abs(w))
  ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
  return np.abs(g - w) / ulp


def _run_both(case):
  d, rule_name, exact, hot = CASES[case]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  state = _jax_state(case)
  batches = _batches(hot)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  jstep = make_sparse_train_step(_jax_model(d), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 batches[0], exact=exact, donate=False)
  tstep = ttr.make_sparse_train_step(
      _torch_model(d), tplan, torch_bce,
      functools.partial(torch.optim.SGD, lr=LR), trule, exact=exact)
  jl, tl = [], []
  for numerical, cats, labels in batches:
    state, loss = jstep(state, jnp.asarray(numerical),
                        [jnp.asarray(c) for c in cats], jnp.asarray(labels))
    jl.append(float(loss))
    tstate, loss = tstep(tstate, torch.tensor(numerical),
                         [torch.tensor(c) for c in cats],
                         torch.tensor(labels))
    tl.append(float(loss))
  return state, tstate, jl, tl


@pytest.fixture(scope="module")
def runs():
  return {}


def _run(runs, case):
  if case not in runs:
    runs[case] = _run_both(case)
  return runs[case]


def test_port_init_draws_bf16_in_the_jax_layout():
  case = "adagrad_d16"
  d, rule_name, _, hot = CASES[case]
  _, tplan = _plans(d, hot)
  _, trule = _rules(rule_name)
  jstate = _jax_state(case)
  tstate = ttr.init_sparse_state_direct(
      tplan, trule, {}, functools.partial(torch.optim.SGD, lr=LR),
      torch.Generator().manual_seed(0), device="cpu",
      dtype=torch.bfloat16)
  layouts = DistributedLookup(tplan).fused_layouts(trule)
  assert set(tstate["fused"]) == set(jstate["fused"]) and tstate["fused"]
  assert set(tstate["emb_dense"]) == set(jstate["emb_dense"])
  for name, buf in tstate["fused"].items():
    want = np.asarray(jstate["fused"][name])
    assert buf.dtype == torch.bfloat16 and tuple(buf.shape) == want.shape
    table, (acc,) = layouts[name].unpack(buf)
    jtable, (jacc,) = layouts[name].unpack(torch.from_numpy(
        want.view(np.int16).copy()).view(torch.bfloat16))
    # the same logical rows are live, and padding is zero
    np.testing.assert_array_equal((_f32(table) != 0).any(axis=1),
                                  (_f32(jtable) != 0).any(axis=1))
    pad = np.ones(want.shape, bool)
    pad[:, :layouts[name].rows_per_phys * layouts[name].stride] = False
    assert not _f32(buf)[pad].any()
    # the aux constants: bf16(0.1), the JAX template's bits
    live = jacc.to(torch.float32) != 0
    assert torch.equal(acc.view(torch.int16)[live],
                       jacc.view(torch.int16)[live])
    assert float(acc[live][0]) == float(np.float32(0.1).astype(BF16))
    # uniform in +-1/sqrt(rows) per table: the port's draw against the
    # JAX draw's extremes and spread
    t, jt = _f32(table), _f32(jtable)
    assert np.abs(t).max() <= np.abs(jt).max() * 1.01
    assert abs(t.std() - jt.std()) <= 0.1 * jt.std()
  for name, table in tstate["emb_dense"].items():
    assert table.dtype == torch.bfloat16
    assert tuple(table.shape) == np.asarray(jstate["emb_dense"][name]).shape
  assert all(p.dtype == torch.float32 for p in tstate["dense"].values())


class _ActsModel:
  """JAX model stub returning the embedding activations."""

  def apply(self, variables, numerical, cats, emb_acts=None):
    del variables, numerical, cats
    return jnp.concatenate([a.astype(jnp.float32) for a in emb_acts], -1)


class _TorchActsModel(nn.Module):

  def forward(self, numerical, cats, emb_acts=None):
    del numerical, cats
    return torch.cat([a.to(torch.float32) for a in emb_acts], dim=-1)


@pytest.mark.parametrize("case", ["sgd_d16_multihot",
                                  "adagrad_d128_multihot", "adagrad_d16"])
def test_eval_activations_are_bit_equal(case):
  d, rule_name, _, hot = CASES[case]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  state = _jax_state(case)
  numerical, cats, _ = _batches(hot, seed=5)[0]
  jeval = make_sparse_eval_step(_ActsModel(), jplan, jrule, None, state,
                                (numerical, cats))
  want = np.asarray(jeval(state, jnp.asarray(numerical),
                          [jnp.asarray(c) for c in cats]))
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  tstate["dense"] = {}  # the stub has no parameters
  got = ttr.make_sparse_eval_step(_TorchActsModel(), tplan, trule)(
      tstate, torch.tensor(numerical), [torch.tensor(c) for c in cats])
  assert got.shape == want.shape == (B, len(VOCAB) * d)
  np.testing.assert_array_equal(got.numpy().view(np.int32),
                                want.view(np.int32))


@pytest.mark.parametrize("width,n_aux", [(128, 0), (16, 1), (16, 0)])
@pytest.mark.parametrize("scaled", [False, True])
def test_plain_bf16_apply_matches_jax_scatter(width, n_aux, scaled):
  rng = np.random.default_rng(width + n_aux)
  jlay = jpt.PackedLayout(rows=200, width=width, n_aux=n_aux)
  tlay = tpt.PackedLayout(rows=200, width=width, n_aux=n_aux)
  buf = rng.standard_normal(jlay.shape).astype(BF16)
  ids = rng.integers(-5, 205, 1500).astype(np.int32)  # out of range too
  ids[:200] = 7  # a hot row
  ids[200:300] = 199
  delta = (rng.standard_normal((1500, jlay.stride)) * 0.3).astype(np.float32)
  kw = {"delta_scale": jnp.asarray(-0.1, jnp.float32)} if scaled else {}
  want = np.asarray(jax.jit(
      lambda b, i, u: jpt.scatter_add_fused(jlay, b, i, u, **kw))(
          jnp.asarray(buf), jnp.asarray(ids), jnp.asarray(delta)))
  tbuf = torch.from_numpy(buf.view(np.int16).copy()).view(torch.bfloat16)
  got = tpt.scatter_add_fused(
      tlay, tbuf, torch.from_numpy(ids), torch.from_numpy(delta),
      torch.tensor(-0.1) if scaled else None)
  np.testing.assert_array_equal(_bits(got), want.view(np.uint16))
  assert cuda_apply.launches_bf16 == 0  # CPU tensors launch nothing


def test_apply_rows_plain_adds_in_stream_order():
  """The plain bf16 apply rounds every occurrence's add, in stream order
  (an index_add_ of the whole stream would sum duplicates in f32)."""
  buf = torch.zeros((2, 128), dtype=torch.bfloat16)
  buf[0] = 256.0
  ids = torch.tensor([0, 0, 0, 1, 0], dtype=torch.int64)
  delta = torch.full((5, 128), 0.75, dtype=torch.bfloat16)
  cuda_apply.apply_rows_plain(buf, ids, delta)
  # 256 + 0.75 rounds to 257 (ulp 2) each time: 256 -> 257 -> 258 -> ...
  seq = 256.0
  for _ in range(4):
    seq = float(np.float32(seq + 0.75).astype(BF16))
  assert float(buf[0, 0]) == seq != 256.0 + 4 * 0.75
  assert float(buf[1, 0]) == 0.75


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(runs, case, capsys):
  state, tstate, jl, tl = _run(runs, case)
  np.testing.assert_allclose(tl, jl, **TOL)
  assert tstate["step"] == int(state["step"]) == STEPS
  cells = equal = 0
  worst = 0.0
  for part in ("fused", "emb_dense"):
    assert set(tstate[part]) == set(state[part]) and tstate[part]
    for name, want in state[part].items():
      got = tstate[part][name]
      assert got.dtype == torch.bfloat16 and want.dtype == BF16
      ulps = _ulps(got, want)
      worst = max(worst, float(ulps.max()))
      assert ulps.max() <= ULPS, f"{part}/{name}: {ulps.max()} ulps"
      cells += ulps.size
      equal += int((_bits(got) == _bits(want)).sum())
  share = equal / cells
  with capsys.disabled():
    print(f"\n{case}: {share:.6%} of {cells} bf16 cells bit-equal to the "
          f"JAX step, worst {worst} ulps")
  assert share >= BIT_EQUAL_SHARE
  for name, p in tstate["dense"].items():
    assert p.dtype == torch.float32, name


@pytest.mark.parametrize("case", ["sgd_d16_multihot", "adagrad_d16"])
def test_bf16_run_tracks_the_f32_run(runs, case):
  """The bf16 run against the port's own f32 run from the same values
  (the bf16 state widened): losses within 1e-2, every table within 2^-7
  of its largest magnitude plus 5 % of its largest update."""
  d, rule_name, exact, hot = CASES[case]
  _, tplan = _plans(d, hot)
  _, trule = _rules(rule_name)
  init = _numpy_state(_jax_state(case))
  wide = {**init, "fused": {k: v.astype(np.float32)
                            for k, v in init["fused"].items()},
          "emb_dense": {k: v.astype(np.float32)
                        for k, v in init["emb_dense"].items()}}
  losses = {}
  states = {}
  for tag, st in (("bf16", init), ("f32", wide)):
    tstate = train_state_from_flax(st, device="cpu")
    tstep = ttr.make_sparse_train_step(
        _torch_model(d), tplan, torch_bce,
        functools.partial(torch.optim.SGD, lr=LR), trule, exact=exact)
    losses[tag] = []
    for numerical, cats, labels in _batches(hot):
      tstate, loss = tstep(tstate, torch.tensor(numerical),
                           [torch.tensor(c) for c in cats],
                           torch.tensor(labels))
      losses[tag].append(float(loss))
    states[tag] = tstate
  np.testing.assert_allclose(losses["bf16"], losses["f32"], rtol=1e-2)
  for part in ("fused", "emb_dense"):
    for name, start in init[part].items():
      a = _f32(states["bf16"][part][name])
      b = _f32(states["f32"][part][name])
      moved = np.abs(b - start.astype(np.float32)).max()
      assert moved > 0, name
      bound = 2.0 ** -7 * np.abs(b).max() + 0.05 * moved
      assert np.abs(a - b).max() <= bound, (part, name)


def test_micro_batched_bf16_step_is_refused_as_jax_fails():
  """Micro-batches on bf16 tables: the JAX micro-batched step fails (its
  scan carries f32 gradients into the bf16 dense-class tables), so the
  port refuses it naming ROADMAP item 7b."""
  case = "adagrad_d16"
  d, rule_name, _, hot = CASES[case]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  state = _jax_state(case)
  numerical, cats, labels = _batches(hot, seed=9, steps=1)[0]
  jstep = make_sparse_train_step(_jax_model(d), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 (numerical, cats, labels), donate=False,
                                 micro_batches=2)
  with pytest.raises(TypeError, match="carry"):
    jstep(state, jnp.asarray(numerical), [jnp.asarray(c) for c in cats],
          jnp.asarray(labels))
  tstep = ttr.make_sparse_train_step(
      _torch_model(d), tplan, torch_bce,
      functools.partial(torch.optim.SGD, lr=LR), trule, micro_batches=2)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  with pytest.raises(NotImplementedError, match="item 7b"):
    tstep(tstate, torch.tensor(numerical), [torch.tensor(c) for c in cats],
          torch.tensor(labels))


def test_guarded_bf16_step_matches_jax():
  """The guarded step on bf16 tables against the JAX guarded step: its
  metrics equal and its state within the trajectory bounds above."""
  case = "adagrad_d16"
  d, rule_name, _, hot = CASES[case]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  state = _jax_state(case)
  batches = _batches(hot, seed=9, steps=2)
  kw = {"guard": True}
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  jstep = make_sparse_train_step(_jax_model(d), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 batches[0], donate=False, **kw)
  tstep = ttr.make_sparse_train_step(
      _torch_model(d), tplan, torch_bce,
      functools.partial(torch.optim.SGD, lr=LR), trule, **kw)
  for numerical, cats, labels in batches:
    jres = jstep(state, jnp.asarray(numerical),
                 [jnp.asarray(c) for c in cats], jnp.asarray(labels))
    tres = tstep(tstate, torch.tensor(numerical),
                 [torch.tensor(c) for c in cats], torch.tensor(labels))
    state, tstate = jres[0], tres[0]
    np.testing.assert_allclose(float(tres[1]), float(jres[1]), **TOL)
    assert int(tres[2]["bad_step"]) == int(jres[2]["bad_step"]) == 0
  for part in ("fused", "emb_dense"):
    for name, want in state[part].items():
      got = tstate[part][name]
      assert got.dtype == torch.bfloat16
      assert _ulps(got, want).max() <= ULPS, (part, name)


def test_unported_narrow_combinations_are_refused():
  """bf16 buffers run under every rule and id form the JAX package runs
  them with (the momentum and Adam rules, ragged and deduplicated
  buckets, bf16 dense-autodiff class buffers: held to the JAX package in
  ``tests/test_torch_narrow_rules.py``); what narrow storage still
  refuses, micro-batches, where the JAX step itself fails, raises naming
  ROADMAP item 7b."""
  from distributed_embeddings_torch.layers.dist_model_parallel import (
      DistributedEmbedding,
  )
  from distributed_embeddings_torch.ops.ragged import RaggedIds
  d, _, _, hot = CASES["sgd_d16_multihot"]
  _, tplan = _plans(d, hot)
  model = _torch_model(d)
  numerical, cats, labels = _batches(hot)[0]
  args = (torch.tensor(numerical), [torch.tensor(c) for c in cats],
          torch.tensor(labels))

  def fresh(plan, rule):
    return ttr.init_sparse_state_direct(
        plan, rule, model.state_dict(),
        functools.partial(torch.optim.SGD, lr=LR),
        torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.bfloat16)

  def moved(state, before):
    return any(not torch.equal(state["fused"][k], before[k])
               for k in before)

  for name in ("momentum", "adam"):
    rule = getattr(tpt, f"{name}_rule")(LR)
    state = fresh(tplan, rule)
    before = {k: v.clone() for k, v in state["fused"].items()}
    step = ttr.make_sparse_train_step(
        model, tplan, torch_bce, functools.partial(torch.optim.SGD, lr=LR),
        rule)
    state, loss = step(state, *args)
    assert np.isfinite(float(loss)) and moved(state, before)
    assert all(t.dtype == torch.bfloat16 for t in state["fused"].values())
  rule = tpt.sgd_rule(LR)
  sgd = functools.partial(torch.optim.SGD, lr=LR)
  ragged_plan = TStrategy(_configs(TTableConfig, d, hot), 1,
                          dense_row_threshold=THRESHOLD,
                          input_hotness=[-4 if i == 5 else 1
                                         for i in range(len(VOCAB))])
  dedup_plan = TStrategy(_configs(TTableConfig, d, hot), 1,
                         dense_row_threshold=THRESHOLD, dedup_exchange=True)
  rg = RaggedIds(torch.tensor([1, 2, 3, 4], dtype=torch.int32),
                 torch.tensor([0, 1, 3] + [4] * (B - 2), dtype=torch.int32))
  ragged_cats = [torch.tensor(c) for c in cats]
  ragged_cats[5] = rg
  for plan, cats_in in ((ragged_plan, ragged_cats), (dedup_plan, args[1])):
    state = fresh(plan, rule)
    before = {k: v.clone() for k, v in state["fused"].items()}
    step = ttr.make_sparse_train_step(model, plan, torch_bce, sgd, rule)
    state, loss = step(state, args[0], cats_in, args[2])
    assert np.isfinite(float(loss)) and moved(state, before)
  emb = DistributedEmbedding(_configs(TTableConfig, d, hot),
                             dense_row_threshold=THRESHOLD, device="cpu")
  emb.to(torch.bfloat16)
  outs = emb([torch.tensor(c) for c in cats])
  assert all(o.dtype == torch.bfloat16 and o.shape == (B, d) for o in outs)
  sum(o.float().sum() for o in outs).backward()
  assert all(p.grad is not None and p.grad.dtype == torch.bfloat16
             for p in emb.parameters())
  step = ttr.make_sparse_train_step(model, tplan, torch_bce, sgd, rule,
                                    micro_batches=2)
  with pytest.raises(NotImplementedError, match="item 7b"):
    step(fresh(tplan, rule), *args)


def test_planner_lifts_the_tpu_buffer_bound_on_request():
  """A table past the TPU's 2^31-element buffer bound at world 1: the
  JAX planner and the port's default refuse it with the same message;
  ``buffer_elements=None`` (a port-only plan, the card indexes in 64
  bits) keeps it whole in a class of its own; below the bound the knob
  changes nothing."""
  big = [TTableConfig(input_dim=20_000_000, output_dim=128),
         TTableConfig(input_dim=5_000, output_dim=128)]
  with pytest.raises(ValueError) as want:
    DistEmbeddingStrategy([TableConfig(input_dim=c.input_dim,
                                       output_dim=128) for c in big], 1,
                          dense_row_threshold=4096)
  with pytest.raises(ValueError) as got:
    TStrategy(big, 1, dense_row_threshold=4096)
  assert str(got.value) == str(want.value)
  plan = TStrategy(big, 1, dense_row_threshold=4096, buffer_elements=None)
  sparse = [k for k in plan.class_keys if plan.classes[k].kind == "sparse"]
  assert max(sum(sh.input_dim for sh in plan.classes[k].shards_per_rank[0])
             for k in sparse) == 20_000_000
  small = _configs(TTableConfig, 16, {})
  a = TStrategy(small, 1, dense_row_threshold=THRESHOLD)
  b = TStrategy(small, 1, dense_row_threshold=THRESHOLD,
                buffer_elements=None)
  assert a.class_keys == b.class_keys


def test_convert_carries_bf16_bits_both_ways():
  state = _numpy_state(_jax_state("adagrad_d16"))
  tstate = train_state_from_flax(state, device="cpu")
  for part in ("fused", "emb_dense"):
    for name, arr in state[part].items():
      assert arr.dtype == BF16
      assert tstate[part][name].dtype == torch.bfloat16
      np.testing.assert_array_equal(_bits(tstate[part][name]),
                                    arr.view(np.uint16))
  back = train_state_to_flax(tstate)
  for part in ("fused", "emb_dense"):
    for name, arr in state[part].items():
      assert back[part][name].dtype == np.uint16
      np.testing.assert_array_equal(back[part][name].view(BF16), arr)
  jax.tree_util.tree_map(np.testing.assert_array_equal, back["dense"],
                         state["dense"])


def _saved_pair(tmp_path, case="adagrad_d16"):
  d, rule_name, _, hot = CASES[case]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  jstate = _jax_state(case)
  jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
  jck.save(jpath, jplan, jrule, jstate)
  tstate = ttr._with_optimizers(
      train_state_from_flax(_numpy_state(jstate), device="cpu"),
      functools.partial(torch.optim.SGD, lr=LR), None)
  tck.save(tpath, tplan, trule, tstate)
  return jplan, tplan, jrule, trule, jstate, tstate, jpath, tpath


def _read(path):
  with open(path, "rb") as f:
    return f.read()


def test_checkpoint_bytes_equal_the_jax_save(tmp_path):
  _, _, _, _, jstate, _, jpath, tpath = _saved_pair(tmp_path)
  with open(os.path.join(jpath, "manifest.json")) as f:
    jman = json.load(f)
  with open(os.path.join(tpath, "manifest.json")) as f:
    tman = json.load(f)
  assert tman["fused"] == jman["fused"]
  assert {m["dtype"] for m in tman["fused"].values()} == {"bfloat16"}
  for name in jstate["fused"]:
    fname = f"fused_{name}_r0.npy"
    blob = _read(os.path.join(tpath, fname))
    assert blob == _read(os.path.join(jpath, fname))
    assert b"'descr': '<V2'" in blob
    assert tman["checksums"][fname] == jman["checksums"][fname]
  for part in ("emb_dense", "dense", "dense_opt", "emb_dense_opt"):
    with np.load(os.path.join(jpath, f"{part}.npz")) as j, \
        np.load(os.path.join(tpath, f"{part}.npz")) as t:
      assert sorted(j.files) == sorted(t.files), part
      for k in j.files:
        assert j[k].dtype.str == t[k].dtype.str, (part, k)
        assert j[k].tobytes() == t[k].tobytes(), (part, k)
  for key in ("format_version", "step", "rule", "plan", "world"):
    assert tman[key] == jman[key], key


def test_port_restores_the_jax_bf16_checkpoint(tmp_path):
  jplan, tplan, jrule, trule, jstate, tstate, jpath, tpath = \
      _saved_pair(tmp_path)
  for path in (jpath, tpath):
    got = tck.restore(path, tplan, trule, tstate, device="cpu")
    for part in ("fused", "emb_dense"):
      for name, arr in jstate[part].items():
        assert got[part][name].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got[part][name]),
                                      np.asarray(arr).view(np.uint16))
  # the reference divergence: the JAX restore cannot read its own bf16
  # blocks back (np.load gives 2-byte voids, jnp.asarray refuses them)
  with pytest.raises(TypeError, match="V2"):
    jck.restore(jpath, jplan, jrule, jstate)


@pytest.mark.parametrize("quantize", ["f32", "int8"])
def test_serve_images_from_bf16_state_equal_jax(quantize):
  d, rule_name, _, hot = CASES["adagrad_d16"]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  state = _jax_state("adagrad_d16")
  want = freeze(jplan, jrule, state, quantize=quantize)
  got = torch_freeze(tplan, trule,
                     train_state_from_flax(_numpy_state(state),
                                           device="cpu"),
                     quantize=quantize)
  assert set(got.device_blocks) == set(want.device_blocks)
  for name, blocks in want.device_blocks.items():
    for g, w in zip(got.device_blocks[name], blocks):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  for name, table in want.emb_dense.items():
    assert got.emb_dense[name].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got.emb_dense[name]),
                                  np.asarray(table).view(np.uint16))


def make_bf16_golden():
  """The narrow-storage train golden's arrays, from the JAX package on the
  CPU: the train golden's model and batches (``tests/
  test_torch_train_golden.py``) on ``init_sparse_state_direct(dtype=
  jnp.bfloat16)``; bf16 arrays as their ``uint16`` bits."""
  import test_torch_train_golden as G
  rng = np.random.default_rng(G.SEED)
  model = DLRM(vocab_sizes=G.VOCAB, embedding_dim=G.DIM,
               bottom_mlp=G.BOTTOM, top_mlp=G.TOP,
               dense_row_threshold=G.DENSE_ROW_THRESHOLD,
               compute_dtype=jnp.bfloat16)
  steps = port_golden.STEPS
  numerical = rng.standard_normal((steps, G.B, G.NUM)).astype(np.float32)
  cats = np.stack([np.stack([rng.integers(0, v, (G.B,)) for v in G.VOCAB])
                   for _ in range(steps)]).astype(np.int32)
  labels = rng.integers(0, 2, (steps, G.B)).astype(np.float32)
  params = model.init(
      jax.random.PRNGKey(G.SEED), jnp.zeros((2, G.NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in G.VOCAB],
      emb_acts=[jnp.zeros((2, G.DIM)) for _ in G.VOCAB])["params"]
  plan = dlrm_embedding_plan(G.VOCAB, G.DIM,
                             dense_row_threshold=G.DENSE_ROW_THRESHOLD)
  rule = jpt.sgd_rule(port_golden.LR)
  opt = optax.sgd(port_golden.LR)
  state = init_sparse_state_direct(plan, rule, params, opt,
                                   jax.random.PRNGKey(G.SEED + 1),
                                   dtype=jnp.bfloat16)
  out = {"vocab": np.asarray(G.VOCAB, np.int64), "dim": np.int64(G.DIM),
         "bottom_mlp": np.asarray(G.BOTTOM, np.int64),
         "top_mlp": np.asarray(G.TOP, np.int64),
         "dense_row_threshold": np.int64(G.DENSE_ROW_THRESHOLD),
         "numerical": numerical, "cats": cats, "labels": labels}

  def entries(tag, st):
    for part in ("fused", "emb_dense"):
      for name, arr in st[part].items():
        out[f"{part}{tag}/{name}"] = np.asarray(arr).view(np.uint16)
    G._flat(out, f"dense{tag}", st["dense"])

  entries("0", state)
  step = make_sparse_train_step(model, plan, bce_loss, opt, rule, None,
                                state, (numerical[0], list(cats[0]),
                                        labels[0]), donate=False)
  losses = []
  for i in range(steps):
    state, loss = step(state, jnp.asarray(numerical[i]),
                       [jnp.asarray(c) for c in cats[i]],
                       jnp.asarray(labels[i]))
    losses.append(np.float32(loss))
  out["losses"] = np.asarray(losses, np.float32)
  entries("3", state)
  return out


@pytest.fixture(scope="module")
def bf16_golden():
  return port_golden.load(port_golden.BF16_PATH)


def test_committed_bf16_golden_is_current(bf16_golden):
  assert port_golden.BF16_PATH.stat().st_size < 1024 * 1024
  fresh = make_bf16_golden()
  assert sorted(fresh) == sorted(bf16_golden)
  for key, arr in fresh.items():
    assert arr.dtype == bf16_golden[key].dtype, key
    np.testing.assert_array_equal(arr, bf16_golden[key], err_msg=key)
  assert any(k.startswith("emb_dense3/") for k in fresh)
  assert all(bf16_golden[k].dtype == np.uint16 for k in fresh
             if k.startswith(("fused", "emb_dense")))


def test_port_replays_bf16_golden_on_cpu(bf16_golden):
  losses, got = port_golden.replay_bf16(bf16_golden, device="cpu")
  assert len(losses) == port_golden.STEPS and np.all(np.isfinite(losses))
  worst = port_golden.compare_bf16(bf16_golden, losses, got)
  assert worst["table_max_ulps"] <= port_golden.BF16_ULPS
  assert worst["dense_max_err_share"] <= port_golden.BF16_DENSE_UPDATE_TOL
  print(worst)


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_narrow_storage.py --write")
  jax.config.update("jax_platforms", "cpu")
  np.savez_compressed(port_golden.BF16_PATH, **make_bf16_golden())
  print(port_golden.BF16_PATH, port_golden.BF16_PATH.stat().st_size)

"""Narrow storage under every rule and id form, in the port against the
JAX package, world 1.

The JAX package trains bf16 buffers (``init_sparse_state_direct(dtype=
jnp.bfloat16)``) under the momentum and Adam rules, with ragged inputs and
with ``exact=True``, and its dense-autodiff ``make_train_step`` trains
bf16 ``mp_table_*`` params; ``optax.adam`` is a dense optimizer there. One
JAX state is carried across (``convert.train_state_from_flax``, bf16
leaves as their bits, the optax states installed into the port's
optimizers) and both packages run the same batches on the CPU:

- three momentum and three Adam steps on a DLRM with sparse and dense
  classes, narrow (several rows a physical row) and multi-hot classes,
  ``exact`` off and on, ``optax.adam`` / ``training.Adam`` on the dense
  side of the Adam cases: every cell within ``ULPS`` bf16 ulps of the JAX
  step's (``torch_narrow_cases.ulps``, scaled by the largest magnitude
  the cell held over the JAX run) and at least ``BIT_EQUAL_SHARE`` of the
  cells bit-equal; the losses in the f32 class;
- ragged ``sum`` and ``mean`` buckets on bf16 buffers (negative ids, an
  empty sample, a capacity-0 stream), trained and evaluated;
- the eval step's activations on a momentum and an Adam state bit-equal;
- ``convert`` both ways with Adam's optax state (bf16 moments of the
  dense-class tables as their bits), checkpoints byte-equal to the JAX
  package's save, and the port restoring it;
- f32 and int8 serve images frozen from bf16 momentum and Adam states
  byte-equal to JAX's (the images take the table lanes only);
- the dense-autodiff ``DistributedEmbedding`` with bf16 class buffers
  under SGD and Adam against the JAX ``make_train_step`` on params whose
  ``mp_table_*`` leaves are bf16;
- the committed rules golden (``tests/data/torch_train_bf16_rules_golden.npz``,
  which ``chip_smoke.py`` replays on the card: the train golden's model,
  in f32 compute, and batches on bf16 buffers under ``adam_rule``, ``optax.adam`` on the
  dense side, one input ragged) current, and replayed on the CPU within
  ``train_golden.compare_bf16``'s tolerances. Rewrite it after a
  deliberate change with ``python tests/test_torch_narrow_rules.py
  --write``; its cells are held to a share of their tensor's largest
  update: ``train_golden.RULES_CPU_UPDATE_TOL`` on the CPU, every dense
  cell; ``RULES_UPDATE_TOL`` on the card, whose interaction rounds its
  operands to bf16 (Adam normalizes the gradients that rounding moves).
  The card bound is shown to refuse a faulty Adam: with the interaction's
  operands rounded to bf16 on the CPU as on the card, the right rule
  passes it with the card's readings and three planted faults fail it.
- the card emulation (``tests/data/torch_train_bf16_rules_card.npz``, the
  rules golden replayed on the CPU with the card's bf16 interaction
  operands and K1-bf16's tiles; rewrite it with ``python
  tests/test_torch_narrow_rules.py --write-card``) current, and its bound
  (``train_golden.compare_card_emulation``, the card's second) passed by
  the emulation with its tiles in reverse order and refusing
  ``b2=0.998``.
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
import torch_narrow_cases as nc
from torch_narrow_cases import one_torch_thread  # noqa: F401 (autouse)
from torch import nn

from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    dlrm_state_dict_from_flax,
    dlrm_state_dict_to_flax,
    train_state_from_flax,
)
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.ops.ragged import RaggedIds as TRagged
from distributed_embeddings_torch.serving import freeze as torch_freeze
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.ops.ragged import RaggedIds as JRagged
from distributed_embeddings_tpu.serving.export import freeze
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_eval_step,
    make_sparse_train_step,
    make_train_step,
)

BF16 = ml_dtypes.bfloat16
TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB = [50, 7, 300, 12, 90, 4000]
NUM = 4
B = 32
STEPS = 3
PAD_ID = -1
THRESHOLD = 64
# the sparse rules' and the dense optimizers' learning rates
LR = {"momentum": 0.5, "adam": 0.05, "sgd": 0.5, "adagrad": 0.5}
DENSE_LR = {"sgd": 0.5, "adam": 0.01}

# name -> (width, rule, exact, multi-hot inputs (input -> hotness), dense
# optimizer). At width 16 a class packs several rows a physical row (4
# with momentum's lanes, 2 with Adam's).
CASES = {
    "momentum_d128": (128, "momentum", False, {}, "sgd"),
    "momentum_d16_multihot": (16, "momentum", False, {0: 3, 5: 4}, "sgd"),
    "momentum_d16_exact": (16, "momentum", True, {5: 4}, "sgd"),
    "adam_d16": (16, "adam", False, {}, "adam"),
    "adam_d128_multihot": (128, "adam", False, {2: 3}, "adam"),
    "adam_d16_exact": (16, "adam", True, {0: 3}, "adam"),
}


def _configs(mod, d, hot, combiner="sum"):
  return [mod(input_dim=v, output_dim=d,
              combiner=combiner if i in hot else None)
          for i, v in enumerate(VOCAB)]


def _plans(d, hot, **kw):
  return (DistEmbeddingStrategy(_configs(TableConfig, d, hot), 1,
                                dense_row_threshold=THRESHOLD, **kw),
          TStrategy(_configs(TTableConfig, d, hot), 1,
                    dense_row_threshold=THRESHOLD, **kw))


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
  return (getattr(jpt, f"{name}_rule")(LR[name]),
          getattr(tpt, f"{name}_rule")(LR[name]))


def _dense_opts(name):
  """The dense optimizer as ``(optax, port factory)``."""
  lr = DENSE_LR[name]
  if name == "adam":
    return optax.adam(lr), functools.partial(ttr.Adam, lr=lr)
  return optax.sgd(lr), functools.partial(torch.optim.SGD, lr=lr)


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


def _jax_state(d, jplan, jrule, jopt):
  return init_sparse_state_direct(jplan, jrule, _jax_dense_params(d), jopt,
                                  jax.random.PRNGKey(1), dtype=jnp.bfloat16)


def _numpy_state(state, opt=True):
  keys = ("fused", "emb_dense", "dense", "step") + (
      ("dense_opt", "emb_dense_opt") if opt else ())
  return {k: jax.tree_util.tree_map(np.asarray, state[k]) for k in keys}


def _port_cats(cats):
  return [TRagged(torch.as_tensor(np.asarray(c.values)),
                  torch.as_tensor(np.asarray(c.row_splits)))
          if isinstance(c, JRagged) else torch.as_tensor(np.asarray(c))
          for c in cats]


def _jax_cats(cats):
  return [c if isinstance(c, JRagged) else jnp.asarray(c) for c in cats]


def _run_both(case):
  """Both packages' three steps from one JAX state: ``(jax states per
  step, port state, jax losses, port losses)``."""
  d, rule_name, exact, hot, dense = CASES[case]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  jopt, topt = _dense_opts(dense)
  state = _jax_state(d, jplan, jrule, jopt)
  batches = _batches(hot)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  jstep = make_sparse_train_step(_jax_model(d), jplan, bce_loss, jopt, jrule,
                                 None, state, batches[0], exact=exact,
                                 donate=False)
  tstep = ttr.make_sparse_train_step(_torch_model(d), tplan, torch_bce, topt,
                                     trule, exact=exact)
  jstates, jl, tl = [state], [], []
  for numerical, cats, labels in batches:
    state, loss = jstep(state, jnp.asarray(numerical), _jax_cats(cats),
                        jnp.asarray(labels))
    jstates.append(state)
    jl.append(float(loss))
    tstate, loss = tstep(tstate, torch.tensor(numerical), _port_cats(cats),
                         torch.tensor(labels))
    tl.append(float(loss))
  return jstates, tstate, jl, tl


@pytest.fixture(scope="module")
def runs():
  return {}


def _run(runs, case):
  if case not in runs:
    runs[case] = _run_both(case)
  return runs[case]


def _state_pairs(jstates, tstate, layouts):
  """``(label, got, want, scale)`` of every bf16 buffer and table: the
  scale is the cell's running maximum over the JAX run, and on a buffer's
  optimizer-state lanes at least their floor (``nc.state_floor``)."""
  pairs = []
  for part in ("fused", "emb_dense"):
    assert set(tstate[part]) == set(jstates[-1][part]) and tstate[part]
    for name, want in jstates[-1][part].items():
      got = tstate[part][name]
      assert got.dtype == torch.bfloat16 and want.dtype == BF16
      scale = nc.running_max(s[part][name] for s in jstates)
      if part == "fused":
        lay = layouts[name]
        scale = np.maximum(scale, nc.state_floor(
            want, lay.width, lay.stride, lay.rows_per_phys))
      pairs.append((f"{part}/{name}", got, want, scale))
  return pairs


def _layouts(tplan, trule):
  from distributed_embeddings_torch.parallel.lookup_engine import \
      DistributedLookup
  return DistributedLookup(tplan).fused_layouts(trule)


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(runs, case, capsys):
  jstates, tstate, jl, tl = _run(runs, case)
  np.testing.assert_allclose(tl, jl, **TOL)
  assert tstate["step"] == int(jstates[-1]["step"]) == STEPS
  d, rule_name, _, hot, _ = CASES[case]
  layouts = _layouts(_plans(d, hot)[1], _rules(rule_name)[1])
  got = nc.compare_cells(_state_pairs(jstates, tstate, layouts),
                         nc.BIT_EQUAL_SHARE)
  with capsys.disabled():
    print(f"\n{case}: {got['share']:.6%} of {got['cells']} bf16 cells "
          f"bit-equal to the JAX step, worst {got['worst']} ulps")
  for name, p in tstate["dense"].items():
    assert p.dtype == torch.float32, name
    np.testing.assert_allclose(
        p.detach().numpy(),
        dlrm_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, jstates[-1]["dense"]))[name]
        .numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_adam_dense_state_keeps_the_jax_dtypes(runs):
  """Adam's moments take optax's dtypes: bf16 zeros for a bf16 dense-class
  table before the first step (optax's init on the table), f32 after it
  (the step's f32 gradients promote them), f32 for the dense params; the
  counts agree, and the moments agree within the narrow tolerance."""
  jstates, tstate, _, _ = _run(runs, "adam_d16")
  opt = tstate["emb_dense_opt"]
  assert isinstance(opt, ttr.Adam) and opt.count == STEPS
  assert int(jstates[-1]["emb_dense_opt"][0].count) == STEPS
  for name, table in ttr.trained_tables(tstate).items():
    assert jstates[0]["emb_dense_opt"][0].mu[name].dtype == BF16
    for slot in ("mu", "nu"):
      want = getattr(jstates[-1]["emb_dense_opt"][0], slot)[name]
      got = opt.state[table][slot]
      assert got.dtype == torch.float32 and want.dtype == np.float32
      np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                                 atol=1e-6, err_msg=(name, slot))
  for p in tstate["dense"].values():
    assert tstate["dense_opt"].state[p]["mu"].dtype == torch.float32


# ---- ragged buckets -------------------------------------------------------

RAGGED = {2: 6, 5: 5}  # input -> max length
RAGGED_CASES = {"sum": ("sum", "momentum"), "mean": ("mean", "adam")}


def _ragged_plans(combiner):
  hot = [-RAGGED[i] if i in RAGGED else 1 for i in range(len(VOCAB))]
  kw = dict(dense_row_threshold=THRESHOLD, input_hotness=hot)
  return (DistEmbeddingStrategy(_configs(TableConfig, 16, RAGGED, combiner),
                                1, **kw),
          TStrategy(_configs(TTableConfig, 16, RAGGED, combiner), 1, **kw))


def _ragged_stream(rng, vocab, max_len, capacity, empty=(), batch=B):
  lens = rng.integers(0, max_len + 1, batch)
  for i in empty:
    lens[i] = 0
  while lens.sum() > capacity:
    lens[rng.integers(0, batch)] -= 1
    lens = np.maximum(lens, 0)
  n = int(lens.sum())
  vals = rng.integers(0, vocab, n).astype(np.int32)
  vals[rng.random(n) < 0.2] = -1  # skipped like padding
  vals = np.concatenate([vals, np.zeros(capacity - n, np.int32)])
  return JRagged(jnp.asarray(vals),
                 jnp.asarray(np.concatenate([[0], np.cumsum(lens)])
                             .astype(np.int32)))


def _ragged_batches(seed=0, steps=STEPS):
  rng = np.random.default_rng(seed)
  out = []
  for s in range(steps):
    cats = []
    for i, v in enumerate(VOCAB):
      if i in RAGGED:
        # input 5's capacity is 0 in the last step (an all-empty batch)
        cap = 0 if (i == 5 and s == steps - 1) else B * RAGGED[i] // 2
        cats.append(_ragged_stream(rng, v, RAGGED[i], cap, empty=(3,)))
      else:
        cats.append(rng.integers(0, v, B).astype(np.int32))
    out.append((rng.standard_normal((B, NUM)).astype(np.float32), cats,
                rng.integers(0, 2, B).astype(np.float32)))
  return out


@pytest.fixture(scope="module")
def ragged_runs():
  return {}


def _ragged_run(ragged_runs, combiner):
  if combiner in ragged_runs:
    return ragged_runs[combiner]
  _, rule_name = RAGGED_CASES[combiner]
  jplan, tplan = _ragged_plans(combiner)
  jrule, trule = _rules(rule_name)
  jopt, topt = _dense_opts("sgd")
  state = _jax_state(16, jplan, jrule, jopt)
  batches = _ragged_batches()
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  jstep = make_sparse_train_step(_jax_model(16), jplan, bce_loss, jopt,
                                 jrule, None, state, batches[0],
                                 donate=False)
  tstep = ttr.make_sparse_train_step(_torch_model(16), tplan, torch_bce,
                                     topt, trule)
  jstates, jl, tl = [state], [], []
  for numerical, cats, labels in batches:
    state, loss = jstep(state, jnp.asarray(numerical), _jax_cats(cats),
                        jnp.asarray(labels))
    jstates.append(state)
    jl.append(float(loss))
    tstate, loss = tstep(tstate, torch.tensor(numerical), _port_cats(cats),
                         torch.tensor(labels))
    tl.append(float(loss))
  numerical, cats, _ = _ragged_batches(seed=7, steps=1)[0]
  jev = make_sparse_eval_step(_ActsModel(), jplan, jrule, None, state,
                              (numerical, cats))
  want = np.asarray(jev(state, jnp.asarray(numerical), _jax_cats(cats)))
  ev_state = dict(tstate, dense={})  # the stub has no parameters
  got = ttr.make_sparse_eval_step(_TorchActsModel(), tplan, trule)(
      ev_state, torch.tensor(numerical), _port_cats(cats))
  ragged_runs[combiner] = (jstates, tstate, jl, tl, got, want)
  return ragged_runs[combiner]


@pytest.mark.parametrize("combiner", list(RAGGED_CASES))
def test_ragged_buckets_on_bf16_match_jax(ragged_runs, combiner):
  jstates, tstate, jl, tl, _, _ = _ragged_run(ragged_runs, combiner)
  np.testing.assert_allclose(tl, jl, **TOL)
  layouts = _layouts(_ragged_plans(combiner)[1],
                     _rules(RAGGED_CASES[combiner][1])[1])
  nc.compare_cells(_state_pairs(jstates, tstate, layouts),
                   nc.BIT_EQUAL_SHARE)


@pytest.mark.parametrize("combiner", list(RAGGED_CASES))
def test_ragged_eval_on_bf16_is_bit_equal(ragged_runs, combiner):
  """The eval step's activations of the trained bf16 state, ragged
  ``sum`` / ``mean`` buckets (every add of a bag rounded to bf16, XLA's
  ``segment_sum``): bit-equal to JAX's."""
  *_, got, want = _ragged_run(ragged_runs, combiner)
  assert got.shape == want.shape == (B, len(VOCAB) * 16)
  np.testing.assert_array_equal(got.numpy().view(np.int32),
                                want.view(np.int32))


class _ActsModel:
  """JAX model stub returning the embedding activations."""

  def apply(self, variables, numerical, cats, emb_acts=None):
    del variables, numerical, cats
    return jnp.concatenate([a.astype(jnp.float32) for a in emb_acts], -1)


class _TorchActsModel(nn.Module):

  def forward(self, numerical, cats, emb_acts=None):
    del numerical, cats
    return torch.cat([a.to(torch.float32) for a in emb_acts], dim=-1)


@pytest.mark.parametrize("case", ["momentum_d16_multihot",
                                  "adam_d128_multihot"])
def test_eval_activations_are_bit_equal(runs, case):
  d, rule_name, _, hot, _ = CASES[case]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  state = _run(runs, case)[0][-1]
  numerical, cats, _ = _batches(hot, seed=5)[0]
  jeval = make_sparse_eval_step(_ActsModel(), jplan, jrule, None, state,
                                (numerical, cats))
  want = np.asarray(jeval(state, jnp.asarray(numerical), _jax_cats(cats)))
  tstate = train_state_from_flax(_numpy_state(state, opt=False),
                                 device="cpu")
  tstate["dense"] = {}
  got = ttr.make_sparse_eval_step(_TorchActsModel(), tplan, trule)(
      tstate, torch.tensor(numerical), _port_cats(cats))
  np.testing.assert_array_equal(got.numpy().view(np.int32),
                                want.view(np.int32))


# ---- convert, checkpoints, serving -----------------------------------------


def _adam_state():
  d, rule_name, _, hot, dense = CASES["adam_d16"]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  jopt, topt = _dense_opts(dense)
  return jplan, tplan, jrule, trule, jopt, topt, _jax_state(
      d, jplan, jrule, jopt)


def test_convert_carries_adam_state_both_ways(runs):
  """A trained JAX state with Adam's optax states crosses into the port
  (bound and installed at the step's first use) and back through
  ``optax_state_of``: every leaf, bf16 moments as their bits."""
  from distributed_embeddings_torch.convert import (
      flatten_paths,
      optax_state_of,
  )
  jstates = _run(runs, "adam_d16")[0]
  jstate = jstates[-1]
  _, _, _, _, _, topt, _ = _adam_state()
  tstate = ttr._with_optimizers(
      train_state_from_flax(_numpy_state(jstate), device="cpu"), topt, None)
  assert isinstance(tstate["emb_dense_opt"], ttr.Adam)
  for part, params in (("dense_opt", tstate["dense"]),
                       ("emb_dense_opt", ttr.trained_tables(tstate))):
    want = flatten_paths(jax.tree_util.tree_map(np.asarray, jstate[part]))
    got = optax_state_of(tstate[part], params)
    assert sorted(got) == sorted(want), part
    for k, w in want.items():
      g = got[k]
      if w.dtype == BF16:
        assert g.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(nc.bits(g), nc.bits(w), err_msg=k)
      else:
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=k)


def _read(path):
  with open(path, "rb") as f:
    return f.read()


def test_checkpoint_with_adam_bytes_equal_the_jax_save(runs, tmp_path):
  """The Adam run's state (adam rule lanes in bf16 buffers, optax.adam's
  bf16 moments of the dense-class tables) saved by both packages: the
  blocks and every npz entry byte-equal; the port restores either save,
  and the JAX restore reads the port's dense_opt."""
  jplan, tplan, jrule, trule, _, topt, _ = _adam_state()
  jstate = _run(runs, "adam_d16")[0][-1]
  jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
  jck.save(jpath, jplan, jrule, jstate)
  tstate = ttr._with_optimizers(
      train_state_from_flax(_numpy_state(jstate), device="cpu"), topt, None)
  tck.save(tpath, tplan, trule, tstate)
  with open(os.path.join(jpath, "manifest.json")) as f:
    jman = json.load(f)
  with open(os.path.join(tpath, "manifest.json")) as f:
    tman = json.load(f)
  assert tman["fused"] == jman["fused"]
  for name in jstate["fused"]:
    fname = f"fused_{name}_r0.npy"
    assert _read(os.path.join(tpath, fname)) == _read(
        os.path.join(jpath, fname))
  for part in ("emb_dense", "dense", "dense_opt", "emb_dense_opt"):
    with np.load(os.path.join(jpath, f"{part}.npz")) as j, \
        np.load(os.path.join(tpath, f"{part}.npz")) as t:
      assert sorted(j.files) == sorted(t.files), part
      for k in j.files:
        assert j[k].dtype.str == t[k].dtype.str, (part, k)
        assert j[k].tobytes() == t[k].tobytes(), (part, k)
  assert any(k.startswith("0/mu/") for k in np.load(
      os.path.join(tpath, "emb_dense_opt.npz")).files)
  for path in (jpath, tpath):
    got = tck.restore(path, tplan, trule, tstate, device="cpu")
    opt = got["emb_dense_opt"]
    assert isinstance(opt, ttr.OptaxState) or opt is None or \
        isinstance(opt, ttr.Adam)
    got = ttr._with_optimizers(got, topt, None)
    for name, table in ttr.trained_tables(got).items():
      mu = got["emb_dense_opt"].state[table]["mu"]
      np.testing.assert_array_equal(
          nc.bits(mu), nc.bits(jstate["emb_dense_opt"][0].mu[name]))
    assert got["emb_dense_opt"].count == STEPS
    for name, arr in jstate["fused"].items():
      np.testing.assert_array_equal(nc.bits(got["fused"][name]),
                                    nc.bits(arr))


@pytest.mark.parametrize("quantize", ["f32", "int8"])
@pytest.mark.parametrize("case", ["momentum_d16_multihot", "adam_d16"])
def test_serve_images_from_bf16_rule_states_equal_jax(runs, case, quantize):
  d, rule_name, _, hot, _ = CASES[case]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  state = _run(runs, case)[0][-1]
  want = freeze(jplan, jrule, state, quantize=quantize)
  got = torch_freeze(tplan, trule,
                     train_state_from_flax(_numpy_state(state, opt=False),
                                           device="cpu"),
                     quantize=quantize)
  assert set(got.device_blocks) == set(want.device_blocks)
  for name, blocks in want.device_blocks.items():
    for g, w in zip(got.device_blocks[name], blocks):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  for name, table in want.emb_dense.items():
    np.testing.assert_array_equal(nc.bits(got.emb_dense[name]),
                                  nc.bits(table))


@pytest.mark.parametrize("quantize", ["f32", "int8"])
def test_serve_artifacts_from_bf16_adam_state_equal_jax(runs, tmp_path,
                                                        quantize):
  """The trained bf16 Adam state exported by both packages: every serve
  image file and the dense-class tables' npz byte-equal (the images take
  the table lanes only; the optimizer lanes stay behind)."""
  from distributed_embeddings_torch.serving import export as torch_export
  from distributed_embeddings_tpu.serving.export import export as jexport
  d, rule_name, _, hot, _ = CASES["adam_d16"]
  jplan, tplan = _plans(d, hot)
  jrule, trule = _rules(rule_name)
  state = _run(runs, "adam_d16")[0][-1]
  jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
  jexport(jpath, jplan, jrule, _numpy_state(state, opt=False),
          quantize=quantize)
  torch_export(tpath, tplan, trule,
               train_state_from_flax(_numpy_state(state, opt=False),
                                     device="cpu"), quantize=quantize)
  images = sorted(f for f in os.listdir(jpath) if f.startswith("serve_"))
  assert images and images == sorted(f for f in os.listdir(tpath)
                                     if f.startswith("serve_"))
  for f in images + ["emb_dense.npz"]:
    if f.endswith(".npz"):
      with np.load(os.path.join(jpath, f)) as j, \
          np.load(os.path.join(tpath, f)) as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
          assert j[k].dtype.str == t[k].dtype.str, (f, k)
          assert j[k].tobytes() == t[k].tobytes(), (f, k)
    else:
      assert _read(os.path.join(jpath, f)) == _read(os.path.join(tpath, f)), f


# ---- the dense-autodiff layer with bf16 class buffers -----------------------

DENSE_VOCAB = [40, 300, 1000, 120]
DENSE_D = 8


def _dense_batches(seed=0, steps=STEPS):
  rng = np.random.default_rng(seed)
  return [(rng.standard_normal((B, NUM)).astype(np.float32),
           [rng.integers(0, v, (B,)).astype(np.int32) for v in DENSE_VOCAB],
           rng.integers(0, 2, (B,)).astype(np.float32))
          for _ in range(steps)]


def _dense_jax_model():
  return DLRM(vocab_sizes=DENSE_VOCAB, embedding_dim=DENSE_D,
              bottom_mlp=(16, DENSE_D), top_mlp=(16, 8, 1),
              dense_row_threshold=THRESHOLD)


def _bf16_tables(params):
  """The flax params with every ``mp_table_*`` leaf cast to bf16."""
  out = jax.tree_util.tree_map(np.asarray, params)
  out["embeddings"] = {k: v.astype(BF16) if k.startswith("mp_table_") else v
                       for k, v in out["embeddings"].items()}
  return out


@pytest.fixture(scope="module")
def dense_jax_runs():
  """Per dense optimizer (``optax.sgd``, ``optax.adam``): the bf16-table
  initial params, the JAX ``make_train_step``'s losses, its params after
  each step and the batches."""
  batches = _dense_batches()
  model = _dense_jax_model()
  numerical, cats, _ = batches[0]
  params = _bf16_tables(model.init(
      jax.random.PRNGKey(0), jnp.asarray(numerical),
      [jnp.asarray(c) for c in cats])["params"])

  def loss_fn(p, numerical, cats, labels):
    return bce_loss(model.apply({"params": p}, numerical, cats), labels)

  runs = {}
  for opt_name in ("sgd", "adam"):
    jopt = (optax.sgd(DENSE_LR["sgd"]) if opt_name == "sgd" else
            optax.adam(DENSE_LR["adam"]))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    step = make_train_step(loss_fn, jopt, None, jparams, jopt.init(jparams),
                           batches[0], donate=False)
    jst = jopt.init(jparams)
    jl, history = [], [jparams]
    for n, c, l in batches:
      jparams, jst, loss = step(jparams, jst, jnp.asarray(n),
                                [jnp.asarray(x) for x in c], jnp.asarray(l))
      jl.append(float(loss))
      history.append(jparams)
    runs[opt_name] = (params, jl, history, batches)
  return runs


def _dense_port_model(params):
  """The port's DLRM on the JAX init, its class buffers bf16 leaves."""
  tmodel = TDLRM(DENSE_VOCAB, DENSE_D, bottom_mlp=(16, DENSE_D),
                 top_mlp=(16, 8, 1), num_numerical=NUM,
                 dense_row_threshold=THRESHOLD, device="cpu")
  sd = dlrm_state_dict_from_flax(params)
  emb = tmodel.embeddings
  for name in emb.class_params():
    setattr(emb, name, nn.Parameter(sd.pop(f"embeddings.{name}")))
  tmodel.load_state_dict(sd, strict=False)
  assert all(p.dtype == torch.bfloat16 for p in emb.class_params().values())
  return tmodel


def _dense_port_opt(opt_name, tmodel):
  return (torch.optim.SGD(tmodel.parameters(), lr=DENSE_LR["sgd"])
          if opt_name == "sgd" else
          ttr.Adam(tmodel.parameters(), lr=DENSE_LR["adam"]))


def _check_dense_run(tmodel, tl, jl, history):
  """The port's losses and final params against the JAX run's: the class
  buffers bf16 in the narrow class, the MLPs in the f32 class."""
  np.testing.assert_allclose(tl, jl, **TOL)
  jparams = history[-1]
  emb = tmodel.embeddings
  got = dlrm_state_dict_to_flax(tmodel.state_dict())
  pairs = []
  for name in emb.class_params():
    want = jparams["embeddings"][name]
    assert got["embeddings"][name].dtype == np.uint16 and want.dtype == BF16
    pairs.append((name, got["embeddings"][name], np.asarray(want),
                  nc.running_max(np.asarray(h["embeddings"][name])
                                 for h in history)))
  nc.compare_cells(pairs, nc.BIT_EQUAL_SHARE)
  for path, arr in port_golden.flax_paths(got).items():
    if "mp_table_" not in path:
      want = port_golden.flax_paths(
          jax.tree_util.tree_map(np.asarray, jparams))[path]
      np.testing.assert_allclose(arr, want, rtol=1e-4, atol=1e-5,
                                 err_msg=path)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_dense_autodiff_bf16_class_buffers_match_jax(dense_jax_runs,
                                                      opt_name):
  params, jl, history, batches = dense_jax_runs[opt_name]
  tmodel = _dense_port_model(params)
  tstep = ttr.make_train_step(port_golden.dense_loss,
                              _dense_port_opt(opt_name, tmodel), tmodel,
                              device="cpu")
  tl = [float(tstep(torch.tensor(n), [torch.tensor(x) for x in c],
                    torch.tensor(l))) for n, c, l in batches]
  _check_dense_run(tmodel, tl, jl, history)


@pytest.mark.parametrize("zero", ["optimizer", "module"])
@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_dense_autodiff_bf16_hand_written_loop_matches_jax(dense_jax_runs,
                                                           opt_name, zero):
  """The loop a user writes (``zero_grad``, ``loss.backward()``,
  ``step``) on the bf16 class buffers, zeroing through the optimizer or
  the module, against the JAX ``make_train_step``: each step reads its
  own gradient (``training.Adam`` takes a bf16 dense class's f32
  gradient, which no earlier step's may swell)."""
  params, jl, history, batches = dense_jax_runs[opt_name]
  tmodel = _dense_port_model(params)
  opt = _dense_port_opt(opt_name, tmodel)
  tl = []
  for n, c, l in batches:
    (opt if zero == "optimizer" else tmodel).zero_grad()
    loss = port_golden.dense_loss(tmodel, torch.tensor(n),
                                  [torch.tensor(x) for x in c],
                                  torch.tensor(l))
    loss.backward()
    opt.step()
    tl.append(float(loss.detach()))
  _check_dense_run(tmodel, tl, jl, history)


# ---- the rules golden -------------------------------------------------------


def make_rules_golden():
  """The rules golden's arrays, from the JAX package on the CPU: the train
  golden's model (f32 compute, every table a sparse class) and batches
  (``tests/test_torch_train_golden.py``), input 7 a ragged stream (lengths 0-6, a fifth of the ids -1), on
  ``init_sparse_state_direct(dtype=jnp.bfloat16)`` under ``adam_rule``
  with ``optax.adam``; bf16 arrays as their ``uint16`` bits."""
  import test_torch_train_golden as G
  rng = np.random.default_rng(G.SEED + 7)
  model = DLRM(vocab_sizes=G.VOCAB, embedding_dim=G.DIM,
               bottom_mlp=G.BOTTOM, top_mlp=G.TOP,
               dense_row_threshold=port_golden.RULES_DENSE_ROW_THRESHOLD)
  steps = port_golden.STEPS
  numerical = rng.standard_normal((steps, G.B, G.NUM)).astype(np.float32)
  cats = np.stack([np.stack([rng.integers(0, v, (G.B,)) for v in G.VOCAB])
                   for _ in range(steps)]).astype(np.int32)
  labels = rng.integers(0, 2, (steps, G.B)).astype(np.float32)
  out = {"vocab": np.asarray(G.VOCAB, np.int64), "dim": np.int64(G.DIM),
         "bottom_mlp": np.asarray(G.BOTTOM, np.int64),
         "top_mlp": np.asarray(G.TOP, np.int64),
         "dense_row_threshold": np.int64(
             port_golden.RULES_DENSE_ROW_THRESHOLD),
         "numerical": numerical, "cats": cats, "labels": labels}
  ragged = {}
  for j, longest in port_golden.RULES_RAGGED.items():
    streams = [_ragged_stream(rng, G.VOCAB[j], longest, G.B * longest // 2,
                              batch=G.B) for _ in range(steps)]
    out[f"values/{j}"] = np.stack([np.asarray(r.values) for r in streams])
    out[f"splits/{j}"] = np.stack([np.asarray(r.row_splits)
                                   for r in streams])
    ragged[j] = streams
  params = model.init(
      jax.random.PRNGKey(G.SEED), jnp.zeros((2, G.NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in G.VOCAB],
      emb_acts=[jnp.zeros((2, G.DIM)) for _ in G.VOCAB])["params"]
  plan = port_golden.bf16_rules_plan(out, TableConfig, DistEmbeddingStrategy)
  rule = jpt.adam_rule(port_golden.RULES_LR)
  opt = optax.adam(port_golden.RULES_LR)
  state = init_sparse_state_direct(plan, rule, params, opt,
                                   jax.random.PRNGKey(G.SEED + 1),
                                   dtype=jnp.bfloat16)

  def entries(tag, st):
    for part in ("fused", "emb_dense"):
      for name, arr in st[part].items():
        out[f"{part}{tag}/{name}"] = np.asarray(arr).view(np.uint16)
    G._flat(out, f"dense{tag}", st["dense"])

  def batch_cats(i):
    return [ragged[j][i] if j in ragged else jnp.asarray(cats[i][j])
            for j in range(len(G.VOCAB))]

  entries("0", state)
  step = make_sparse_train_step(model, plan, bce_loss, opt, rule, None,
                                state, (numerical[0], batch_cats(0),
                                        labels[0]), donate=False)
  losses = []
  for i in range(steps):
    state, loss = step(state, jnp.asarray(numerical[i]), batch_cats(i),
                       jnp.asarray(labels[i]))
    losses.append(np.float32(loss))
  out["losses"] = np.asarray(losses, np.float32)
  entries("3", state)
  return out


@pytest.fixture(scope="module")
def rules_golden():
  return port_golden.load(port_golden.BF16_RULES_PATH)


def test_committed_rules_golden_is_current(rules_golden):
  assert port_golden.BF16_RULES_PATH.stat().st_size < 1024 * 1024
  fresh = make_rules_golden()
  assert sorted(fresh) == sorted(rules_golden)
  for key, arr in fresh.items():
    assert arr.dtype == rules_golden[key].dtype, key
    np.testing.assert_array_equal(arr, rules_golden[key], err_msg=key)
  assert any(k.startswith("values/") for k in fresh)
  assert not any(k.startswith("emb_dense") for k in fresh)


def test_port_replays_rules_golden_on_cpu(rules_golden):
  losses, got = port_golden.replay_bf16_rules(rules_golden, device="cpu")
  assert len(losses) == port_golden.STEPS and np.all(np.isfinite(losses))
  worst = port_golden.compare_bf16(rules_golden, losses, got,
                                   port_golden.RULES_CPU_UPDATE_TOL,
                                   dense_cell_share=1.0)
  assert worst["table_max_ulps"] <= port_golden.BF16_ULPS
  print(worst)


def _card_operands(monkeypatch):
  """Round the interaction's f32 operands to bf16 on the CPU, as the card
  does (``packed_table.mxu_operand_dtype``)."""
  from distributed_embeddings_torch.models import dlrm as tdlrm
  monkeypatch.setattr(
      tdlrm, "mxu_operand_dtype",
      lambda dtype, device: (torch.bfloat16 if dtype == torch.float32
                             else dtype))


# a planted fault in both Adams -> whether the card bound passes it
CARD_BOUND_CASES = {"right": ({}, True), "b2=0.99": ({"b2": 0.99}, False),
                    "b1=0.8": ({"b1": 0.8}, False),
                    "eps=1e-5": ({"eps": 1e-5}, False)}


@pytest.mark.parametrize("case", list(CARD_BOUND_CASES))
def test_rules_golden_card_bound_refuses_a_faulty_adam(rules_golden,
                                                       monkeypatch, case,
                                                       capsys):
  """The card's bound (``RULES_UPDATE_TOL``, ``RULES_DENSE_CELL_SHARE``)
  on a CPU replay whose interaction rounds its operands to bf16 as the
  card's does: the right Adam passes it, needing about the share of the
  tensor's largest update the card needs (0.300-0.305), and Adam with
  another ``b2``, ``b1`` or ``eps`` fails it."""
  adam_kw, right = CARD_BOUND_CASES[case]
  _card_operands(monkeypatch)
  losses, got = port_golden.replay_bf16_rules(rules_golden, device="cpu",
                                              adam_kw=adam_kw)
  if right:
    worst = port_golden.compare_bf16(rules_golden, losses, got,
                                     port_golden.RULES_UPDATE_TOL)
    assert 0.2 < worst["table_update_share_needed"] < 0.4
    reading = worst
  else:
    with pytest.raises(AssertionError) as err:
      port_golden.compare_bf16(rules_golden, losses, got,
                               port_golden.RULES_UPDATE_TOL)
    reading = str(err.value).splitlines()[0]
  with capsys.disabled():
    print(f"\ncard bound, {case}: {reading}")


def test_rules_golden_cpu_bound_refuses_a_small_fault(rules_golden):
  """The CPU bound (``RULES_CPU_UPDATE_TOL``) sees a fault far below the
  card's noise: ``b2=0.998`` in both Adams, where the golden has 0.999."""
  losses, got = port_golden.replay_bf16_rules(rules_golden, device="cpu",
                                              adam_kw={"b2": 0.998})
  with pytest.raises(AssertionError):
    port_golden.compare_bf16(rules_golden, losses, got,
                             port_golden.RULES_CPU_UPDATE_TOL,
                             dense_cell_share=1.0)


# ---- the card emulation: the rules golden's second card bound ------------


def _card_k1(patch, reverse=False):
  """K1-bf16's arithmetic on the CPU, as the card's kernel does it: the
  occurrences cut into the launcher's tiles (``cuda_apply.plan_apply``),
  each tile's run of one id summed in f32 and added to the bf16 row
  once, the tiles in stream order (``reverse``: the other extreme of the
  card's atomics' order). f32 buffers keep the plain version."""
  from distributed_embeddings_torch.ops import cuda_apply
  plain = cuda_apply.apply_rows_plain

  def tiles(buf, ids, delta, scale=None):
    if buf.dtype != torch.bfloat16:
      return plain(buf, ids, delta, scale)
    i = ids.reshape(-1).long()
    d = delta.reshape(i.shape[0], -1).float()
    if scale is not None:
      d = d * float(torch.tensor(float(scale)).to(torch.bfloat16))
    tile = cuda_apply.plan_apply(buf.shape[1], i.shape[0]).tile
    starts = list(range(0, i.shape[0], tile))
    for t0 in (starts[::-1] if reverse else starts):
      ti, td = i[t0:t0 + tile], d[t0:t0 + tile]
      keep = (ti >= 0) & (ti < buf.shape[0])
      rows, inv = torch.unique(ti[keep], return_inverse=True)
      run = torch.zeros((rows.shape[0], td.shape[1])).index_add_(
          0, inv, td[keep])
      buf[rows] = (buf[rows].float() + run).to(torch.bfloat16)
    return buf

  patch.setattr(cuda_apply, "apply_rows_plain", tiles)


def card_emulation(golden, patch, reverse=False, adam_kw=None):
  """The rules golden replayed on the CPU with the card's arithmetic:
  the interaction's operands rounded to bf16 and K1-bf16's tiles
  (:func:`_card_k1`). Returns ``(losses, final state)``."""
  _card_operands(patch)
  _card_k1(patch, reverse)
  return port_golden.replay_bf16_rules(golden, device="cpu",
                                       adam_kw=adam_kw)


def card_emulation_arrays(golden, patch):
  """What ``tests/data/torch_train_bf16_rules_card.npz`` holds: the
  emulation's losses and final bf16 buffers as their ``uint16`` bits."""
  losses, got = card_emulation(golden, patch)
  out = {"losses": np.asarray(losses, np.float32), "dim": golden["dim"]}
  for name, v in got["fused"].items():
    out[f"fused3/{name}"] = (np.ascontiguousarray(v, np.float32).view(
        np.uint32) >> 16).astype(np.uint16)
  return out


def test_committed_card_emulation_is_current(rules_golden, monkeypatch):
  committed = port_golden.load(port_golden.RULES_CARD_PATH)
  fresh = card_emulation_arrays(rules_golden, monkeypatch)
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)


# the card emulation's bound on the card's other extreme (its tiles'
# atomics in reverse order: passes) and on a small planted fault (fails)
CARD_EMULATION_CASES = {"tiles reversed": (True, {}, True),
                        "b2=0.998": (False, {"b2": 0.998}, False)}


@pytest.mark.parametrize("case", list(CARD_EMULATION_CASES))
def test_card_emulation_bound_refuses_b2_0998(rules_golden, monkeypatch,
                                              case, capsys):
  """The second card bound (``train_golden.compare_card_emulation``):
  the emulation with its K1 tiles added in reverse order stays within it,
  Adam with ``b2=0.998`` (the golden's is 0.999) does not."""
  reverse, adam_kw, right = CARD_EMULATION_CASES[case]
  committed = port_golden.load(port_golden.RULES_CARD_PATH)
  losses, got = card_emulation(rules_golden, monkeypatch, reverse, adam_kw)
  loose = port_golden.compare_card_emulation(committed, losses, got,
                                             moment_share=0.0)
  if right:
    port_golden.compare_card_emulation(committed, losses, got)
  else:
    with pytest.raises(AssertionError, match="card emulation"):
      port_golden.compare_card_emulation(committed, losses, got)
  with capsys.disabled():
    print(f"\ncard emulation bound, {case}: {loose}")


if __name__ == "__main__":
  if sys.argv[1:] not in (["--write"], ["--write-card"]):
    sys.exit("usage: python tests/test_torch_narrow_rules.py --write | "
             "--write-card")
  jax.config.update("jax_platforms", "cpu")
  if sys.argv[1] == "--write":
    np.savez_compressed(port_golden.BF16_RULES_PATH, **make_rules_golden())
    print(port_golden.BF16_RULES_PATH,
          port_golden.BF16_RULES_PATH.stat().st_size)
  else:
    torch.set_num_threads(1)  # as the tests run it (one_torch_thread)
    with pytest.MonkeyPatch.context() as patch:
      arrays = card_emulation_arrays(
          port_golden.load(port_golden.BF16_RULES_PATH), patch)
    np.savez_compressed(port_golden.RULES_CARD_PATH, **arrays)
    print(port_golden.RULES_CARD_PATH,
          port_golden.RULES_CARD_PATH.stat().st_size)

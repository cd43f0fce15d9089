"""The synthetic zoo's train step (Tiny) against the JAX package's.

Tiny at its published widths, with the vocabularies above
``train_golden.ZOO_VOCAB_CAP`` (2,000) rows cut to it and the published
split of sparse and dense classes kept (``train_golden.zoo_plan``): 55
tables, three of them read by a one-hot and a ten-hot input, two narrow
sparse classes (widths 8 and 16) whose ten-hot buckets take the masked
physical-row gather. One initial state (``train_golden.
zoo_initial_state``: numpy draws packed by either package's
``init_sparse_state``, bit-equal) goes through three batches of 64
power-law samples in the JAX ``make_sparse_train_step`` and in the port's
on the CPU, with ``optax.adagrad(0.01)`` / ``training.Adagrad`` on the
dense parameters and Adagrad, momentum or Adam on the sparse classes.
Losses and every final tensor agree in the f32 class (rtol 1e-5, atol
1e-6). The port's run is checked for the path it took: the masked gather
on the ten-hot buckets, and the fused delta build (kernel K6's plain
version on the CPU) on every sparse bucket where the rule has a lane form
on 128-lane rows (Adagrad, momentum), on none for Adam (its masked rows
are 96 and 120 lanes wide).

``tests/data/torch_train_zoo_golden.npz`` is the Adagrad run, written by
:func:`make_golden`: the test regenerates it and requires the committed
file to be identical, then replays it through the port on the CPU as
``chip_smoke.py`` replays it on the card. Rewrite it after a deliberate
change with ``python tests/test_torch_train_zoo.py --write``.
"""

import functools
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import train_golden as tg
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    synthetic_state_dict_from_flax,
    zoo_train_state_from_flax,
)
from distributed_embeddings_torch.models import SyntheticModel as TSynthetic
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.parallel import lookup_engine
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import (
    SYNTHETIC_MODELS,
    SyntheticModel,
    bce_loss,
    expand_tables,
)
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.training import (
    init_sparse_state,
    make_sparse_train_step,
)

TOL = dict(rtol=1e-5, atol=1e-6)
RULES = ("adagrad", "momentum", "adam")
# sparse buckets of the cut plan (two classes, a one-hot and a ten-hot
# bucket each) and its ten-hot ones
SPARSE_BUCKETS, TEN_HOT_BUCKETS = 4, 2


def _rules(name):
  # Adam's first steps divide g by |g| + eps: a summation-order error in a
  # gradient entry near eps would be amplified up to |g| / eps fold, so
  # its case takes an eps that keeps the comparison f32-class (as in
  # tests/test_torch_train.py)
  kw = {"eps": 1e-3} if name == "adam" else {}
  return (getattr(jpt, f"{name}_rule")(tg.ZOO_LR, **kw),
          getattr(tpt, f"{name}_rule")(tg.ZOO_LR, **kw))


def _jax_plan():
  _, tmap, hotness = expand_tables(SYNTHETIC_MODELS[tg.ZOO_MODEL])
  tables = [TableConfig(input_dim=t.input_dim, output_dim=t.output_dim,
                        combiner=t.combiner) for t in tg.zoo_tables()]
  return DistEmbeddingStrategy(
      tables, 1, "basic", input_table_map=tmap,
      dense_row_threshold=tg.ZOO_DENSE_ROW_THRESHOLD, input_hotness=hotness)


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _jax_run(rule_name):
  """Three JAX steps from the zoo's initial state: ``(initial, final,
  losses)``, the states as numpy."""
  jplan = _jax_plan()
  jrule, _ = _rules(rule_name)
  params = tg.zoo_initial_params(tg.zoo_plan())
  opt = optax.adagrad(tg.ZOO_LR)
  state = init_sparse_state(
      jplan, {"embeddings": {k: jnp.asarray(v)
                             for k, v in params["embeddings"].items()},
              "mlp": params["mlp"]}, jrule, opt)
  initial = {k: _np(state[k]) for k in ("fused", "emb_dense", "dense")}
  batches = tg.zoo_batches()
  model = SyntheticModel(config=SYNTHETIC_MODELS[tg.ZOO_MODEL], world_size=1)
  step = make_sparse_train_step(model, jplan, bce_loss, opt, jrule, None,
                                state, batches[0], donate=False)
  losses = []
  for numerical, cats, labels in batches:
    state, loss = step(state, jnp.asarray(numerical),
                       [jnp.asarray(c) for c in cats], jnp.asarray(labels))
    losses.append(np.float32(loss))
  final = {k: _np(state[k]) for k in ("fused", "emb_dense", "dense")}
  return initial, final, np.asarray(losses, np.float32)


def _port_run(rule_name, initial):
  """Three port steps on the CPU from the numpy ``initial`` state: ``(state,
  losses, masked gathers, delta builds)``, the last two counted by
  wrapping the engine's calls."""
  _, trule = _rules(rule_name)
  state = zoo_train_state_from_flax({**initial, "step": 0}, device="cpu")
  model = TSynthetic(SYNTHETIC_MODELS[tg.ZOO_MODEL], device="cpu")
  step = ttr.make_sparse_train_step(
      model, tg.zoo_plan(), torch_bce,
      functools.partial(ttr.Adagrad, lr=tg.ZOO_LR), trule)
  masked = []
  gather = mock.patch.object(
      lookup_engine, "gather_fused_chunked",
      side_effect=lambda *a, **kw: (
          masked.append(kw.get("masked_phys", False)),
          tpt.gather_fused_chunked(*a, **kw))[1])
  build = mock.patch.object(lookup_engine, "build_delta_rows",
                            wraps=lookup_engine.build_delta_rows)
  losses = []
  with gather, build as built:
    for numerical, cats, labels in tg.zoo_batches():
      state, loss = step(state, torch.tensor(numerical),
                         [torch.tensor(c) for c in cats],
                         torch.tensor(labels))
      losses.append(float(loss))
    n_built = built.call_count
  return state, losses, sum(masked), n_built


@pytest.fixture(scope="module")
def runs():
  return {}


def _runs(runs, rule_name):
  if rule_name not in runs:
    initial, final, jl = _jax_run(rule_name)
    runs[rule_name] = (initial, final, jl, _port_run(rule_name, initial))
  return runs[rule_name]


def test_initial_state_packs_as_the_jax_package(runs):
  """The port's ``zoo_initial_state`` (its ``init_sparse_state``) is the
  JAX ``init_sparse_state`` of the same numpy params, bit for bit."""
  initial = _runs(runs, "adagrad")[0]
  mine = tg.zoo_initial_state(tg.zoo_plan(), tpt.adagrad_rule(tg.ZOO_LR))
  for part in ("fused", "emb_dense"):
    assert sorted(mine[part]) == sorted(initial[part])
    for k, v in initial[part].items():
      np.testing.assert_array_equal(mine[part][k], v, err_msg=k)
  plan = tg.zoo_plan()
  kinds = [plan.classes[k].kind for k in plan.class_keys]
  assert kinds.count("sparse") == 2 and "dense" in kinds


@pytest.mark.parametrize("rule_name", RULES)
def test_three_steps_match_jax(runs, rule_name):
  _, final, jl, (tstate, tl, n_masked, n_built) = _runs(runs, rule_name)
  np.testing.assert_allclose(tl, jl, **TOL)
  assert tstate["step"] == tg.STEPS
  for part in ("fused", "emb_dense"):
    assert sorted(tstate[part]) == sorted(final[part])
    for k, v in final[part].items():
      np.testing.assert_allclose(tstate[part][k].detach().numpy(), v,
                                 err_msg=k, **TOL)
  want_dense = synthetic_state_dict_from_flax(final["dense"])
  assert sorted(want_dense) == sorted(tstate["dense"])
  for k, v in want_dense.items():
    np.testing.assert_allclose(tstate["dense"][k].detach().numpy(),
                               v.numpy(), err_msg=k, **TOL)
  # the masked physical-row gather ran on every ten-hot bucket and step
  assert n_masked == TEN_HOT_BUCKETS * tg.STEPS
  # K6 (its plain version here) built every sparse bucket's rows where
  # the rule has a 128-lane lane form, none for Adam
  want_built = 0 if rule_name == "adam" else SPARSE_BUCKETS * tg.STEPS
  assert n_built == want_built


def test_pin_on_is_bit_equal_to_pin_off(monkeypatch):
  """``DE_TORCH_COTANGENT_PIN=1`` copies each sparse bucket's cotangent
  (K7's plain version here) and changes no value."""
  plan = tg.zoo_plan()
  rule = tpt.adagrad_rule(tg.ZOO_LR)
  initial = tg.zoo_initial_state(plan, rule)
  model = TSynthetic(SYNTHETIC_MODELS[tg.ZOO_MODEL], device="cpu")
  numerical, cats, labels = tg.zoo_batches(steps=1)[0]
  out = {}
  for pin in ("0", "1"):
    monkeypatch.setenv("DE_TORCH_COTANGENT_PIN", pin)
    state = zoo_train_state_from_flax(initial, device="cpu")
    step = ttr.make_sparse_train_step(
        model, plan, torch_bce, functools.partial(ttr.Adagrad, lr=tg.ZOO_LR),
        rule)
    with mock.patch.object(lookup_engine, "row_major",
                           wraps=lookup_engine.row_major) as pinned:
      _, loss = step(state, torch.tensor(numerical),
                     [torch.tensor(c) for c in cats], torch.tensor(labels))
    out[pin] = (float(loss), state, pinned.call_count)
  assert out["0"][2] == 0 and out["1"][2] == SPARSE_BUCKETS
  assert out["0"][0] == out["1"][0]
  for part in ("fused", "emb_dense", "dense"):
    for k, v in out["0"][1][part].items():
      assert torch.equal(out["1"][1][part][k], v), k


@pytest.mark.parametrize("rank", [0, 3])
def test_fused_schedule_gathers_masked_rows_per_round(rank):
  """At world 4 under ``overlap='fused'`` each round gathers its own
  block of a narrow multi-hot class as window-masked physical rows:
  reassembled, the rounds' activations and residuals are bit-equal to the
  monolithic gather's (the gather and the bag fold act per (slot,
  sample))."""
  from distributed_embeddings_torch.layers.embedding import \
      TableConfig as TTableConfig
  from distributed_embeddings_torch.layers.planner import \
      DistEmbeddingStrategy as TStrategy
  from distributed_embeddings_torch.parallel.mesh import Mesh

  world = 4
  plan = TStrategy([TTableConfig(input_dim=v, output_dim=16, combiner="sum")
                    for v in (300, 500, 700, 900)], world,
                   overlap="fused", exchange_chunks=2)
  mesh = Mesh(rank=rank, world=world, device=torch.device("cpu"),
              backend="gloo")
  engine = lookup_engine.DistributedLookup(plan, mesh=mesh)
  rule = tpt.adagrad_rule(0.1)
  layouts = engine.fused_layouts(rule)
  key = next(k for k in plan.class_keys if plan.classes[k].kind == "sparse")
  layout = layouts[lookup_engine.class_param_name(*key)]
  assert layout.rows_per_phys == 4
  rng = np.random.default_rng(rank)
  buf = torch.tensor(rng.standard_normal(layout.shape).astype(np.float32))
  sentinel = lookup_engine.padded_rows(plan, key)
  n_b = len(plan.classes[key].slots_per_rank[rank]) or 1
  ids = rng.integers(0, sentinel + 1, (n_b, world * 6, 3))  # 6 per rank
  ids = torch.tensor(ids)
  z, aux = engine._z_sparse_fused(key, layout, buf, ids)
  fz, aux_jit = engine._z_sparse_fused_jit(key, layout, buf, ids)
  assert aux.shape[-1] == layout.rows_per_phys * layout.stride  # masked
  rounds = engine._fused_reassemble(
      [torch.cat(blk, dim=1) for blk in fz.blocks])
  assert torch.equal(rounds, z)
  assert torch.equal(aux_jit, aux)


def make_golden(run=None):
  """The zoo golden's arrays from the JAX package on the CPU (``run``: an
  Adagrad :func:`_jax_run` result already at hand)."""
  initial, final, losses = run or _jax_run("adagrad")
  batches = tg.zoo_batches()
  out = {"seed": np.int64(tg.ZOO_SEED),
         "numerical": np.stack([b[0] for b in batches]),
         "labels": np.stack([b[2] for b in batches]),
         "losses": losses}
  for j in range(len(batches[0][1])):
    out[f"cat/{j}"] = np.stack([b[1][j] for b in batches])
  for part in ("fused", "emb_dense"):
    for k, v in final[part].items():
      out[f"{part}_moved/{k}"] = v - initial[part][k]
  for layer, leaves in final["dense"]["mlp"].items():
    for leaf, arr in leaves.items():
      out[f"dense3/mlp/{layer}/{leaf}"] = arr
  out.update(tg.zoo_init_sums(initial))
  return out


@pytest.fixture(scope="module")
def committed():
  return tg.load(tg.ZOO_PATH)


def test_committed_zoo_golden_is_current(runs, committed):
  assert tg.ZOO_PATH.stat().st_size < 1.5 * 1024 * 1024
  initial, final, jl, _ = _runs(runs, "adagrad")
  fresh = make_golden((initial, final, jl))
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert np.asarray(arr).dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)


def test_port_replays_zoo_golden_on_cpu(committed):
  losses, got = tg.replay_zoo(committed, device="cpu")
  assert len(losses) == tg.STEPS and np.all(np.isfinite(losses))
  worst = tg.compare_zoo(committed, losses, got)
  assert worst["state_max_err_share"] <= tg.UPDATE_TOL


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_train_zoo.py --write")
  jax.config.update("jax_platforms", "cpu")
  np.savez_compressed(tg.ZOO_PATH, **make_golden())
  print(tg.ZOO_PATH, tg.ZOO_PATH.stat().st_size)

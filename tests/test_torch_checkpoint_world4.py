"""Full train-state checkpoints at world 4: the port's four gloo ranks
(``tests/torch_ranks.py: ckpt_job``) against the JAX package over a
4-device CPU mesh, both ways, and the JAX package's elastic restore of a
port checkpoint at world 2.

- The port's ranks take two steps from one JAX initial state (its optax
  state carried by ``convert.train_state_from_flax``), each saves its own
  blocks and rank 0 publishes; the JAX package restores the directory
  over its mesh (every restored array bit-equal to what the ranks held)
  and takes the remaining steps, in the f32 class (rtol 1e-5, atol 1e-6)
  of the port's own continuation.
- The JAX package takes two steps and saves; the port's ranks restore it
  (each rank's blocks bit-equal to the JAX state's) and continue, in the
  f32 class of the JAX package's straight run.
- The JAX package restores the port's world-4 checkpoint onto a world-2
  plan through its elastic re-shard: every logical table row and
  optimizer lane is bit-equal to the port's at the save, which holds the
  manifest's ``layout`` and ``world`` sections to the JAX package's.

The plan has row-sliced tables and a dense class, under
``overlap='fused'``; the optimizers are Adagrad (dense and sparse) and
the scheduled SGD (dense and sparse).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_embeddings_torch.convert import dlrm_state_dict_from_flax
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu.layers import get_weights
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.resilience.elastic import flatten_with_paths
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_train_step,
    shard_batch,
    shard_params,
    unpack_sparse_state,
)
from distributed_embeddings_tpu.utils import data as jdata
from torch_ranks import spawn

TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 4
VOCAB = [3, 10, 24, 40, 64, 100, 160, 300, 600]
DIM = 16
BOTTOM = (32, DIM)
TOP = (32, 1)
NUM = 13
B = 32  # global: 8 per rank
THRESHOLD = 32
ROW_SLICE = 256 * DIM  # tables of more than 256 rows are row-sliced
LR = 0.05
SCHED = (LR, 2, 3, 3)
N_STEPS, STEPS = 2, 4
# name -> (dense optimizer, sparse rule)
CASES = {"adagrad": ("adagrad", "adagrad"), "sched": ("sched", "sched")}


def _jax_opt(name):
  if name == "sched":
    return optax.sgd(jdata.dlrm_lr_schedule(*SCHED))
  return optax.adagrad(LR)


def _jax_rule(name):
  if name == "sched":
    return jpt.sgd_rule(jdata.dlrm_lr_schedule(*SCHED))
  return jpt.adagrad_rule(LR)


def _plan(world):
  return DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=DIM) for v in VOCAB], world,
      "memory_balanced", dense_row_threshold=THRESHOLD,
      row_slice_threshold=ROW_SLICE, batch_hint=B, overlap="fused",
      exchange_chunks=2)


def _model(world):
  return DLRM(vocab_sizes=VOCAB, embedding_dim=DIM, bottom_mlp=BOTTOM,
              top_mlp=TOP, world_size=world, row_slice=ROW_SLICE,
              dense_row_threshold=THRESHOLD)


def _batches():
  rng = np.random.default_rng(5)
  return [(rng.standard_normal((B, NUM)).astype(np.float32),
           [rng.integers(0, v, B).astype(np.int32) for v in VOCAB],
           rng.integers(0, 2, B).astype(np.float32))
          for _ in range(STEPS)]


def _init(case):
  opt_name, rule_name = CASES[case]
  plan, model = _plan(WORLD), _model(WORLD)
  dense = model.init(jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
                     [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
                     emb_acts=[jnp.zeros((2, DIM)) for _ in VOCAB])["params"]
  state = init_sparse_state_direct(plan, _jax_rule(rule_name), dense,
                                   _jax_opt(opt_name), jax.random.PRNGKey(1))
  return plan, model, state


def _jax_run(case, mesh, plan, model, state, batches):
  opt_name, rule_name = CASES[case]
  st = shard_params(state, mesh)
  first = shard_batch(batches[0], mesh)
  step = make_sparse_train_step(model, plan, bce_loss, _jax_opt(opt_name),
                                _jax_rule(rule_name), mesh, st, first,
                                donate=False)
  losses = []
  for numerical, cats, labels in batches:
    st, loss = step(st, *shard_batch((numerical, list(cats), labels), mesh))
    losses.append(float(loss))
  return st, losses


def _numpy(state):
  return jax.tree_util.tree_map(np.asarray, jax.device_get(state))


def _spec(case, mode, path, state):
  opt_name, rule_name = CASES[case]
  return {"vocab": VOCAB, "dim": DIM, "combiner": {}, "world": WORLD,
          "strategy": "memory_balanced", "dense_row_threshold": THRESHOLD,
          "row_slice": ROW_SLICE, "batch": B, "bottom": BOTTOM, "top": TOP,
          "num": NUM, "overlap": "fused", "chunks": 2,
          "opt": opt_name, "rule": rule_name,
          "lr": SCHED if opt_name == "sched" else LR,
          "state": _numpy(state), "batches": _batches(), "n": N_STEPS,
          "mode": mode, "path": path}


def _rank_view(flat_global, rank, names):
  """Rank ``rank``'s rows of a global flat JAX snapshot, in the job's
  ``snap`` spelling (``fused/``, ``emb_dense/`` and per-row
  ``emb_dense_opt/`` leaves cut; the dense parts whole)."""
  out = {}
  for k, v in flat_global.items():
    part = k.split("/")[0]
    cut = part in ("fused", "emb_dense") or (
        part == "emb_dense_opt" and k.split("/")[-1] in names)
    if cut:
      n = v.shape[0] // WORLD
      v = v[rank * n:(rank + 1) * n]
    out[k] = v
  return out


def _jax_flat(state):
  st = _numpy(state)
  out = {f"fused/{k}": v for k, v in st["fused"].items()}
  out.update({f"emb_dense/{k}": v for k, v in st["emb_dense"].items()})
  for part in ("dense_opt", "emb_dense_opt"):
    out.update({f"{part}/{k}": np.asarray(v)
                for k, v in flatten_with_paths(st[part]).items()})
  dense = dlrm_state_dict_from_flax(st["dense"])
  out.update({f"dense/{k}": v.numpy() for k, v in dense.items()})
  out["step"] = int(st["step"])
  return out


def _compare(got, want, exact):
  assert sorted(got) == sorted(want)
  for k, w in want.items():
    if exact or np.asarray(w).dtype.kind in "iu":
      np.testing.assert_array_equal(np.asarray(got[k]), w, err_msg=k)
    else:
      np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)


@pytest.fixture(scope="module", params=sorted(CASES))
def port_saved(request, tmp_path_factory):
  case = request.param
  tmp = tmp_path_factory.mktemp(f"w4ckpt_{case}")
  plan, model, state = _init(case)
  path = str(tmp / "ckpt")
  got = spawn(tmp, WORLD, "ckpt_job", _spec(case, "save", path, state))
  return case, plan, model, state, path, got


def test_port_world4_checkpoint_resumes_in_jax(port_saved):
  case, plan, model, state, path, got = port_saved
  mesh = create_mesh(WORLD)
  like = shard_params(state, mesh)
  restored = jck.restore(path, plan, _jax_rule(CASES[case][1]), like,
                         mesh=mesh)
  names = set(state["emb_dense"])
  flat = _jax_flat(restored)
  assert flat["step"] == N_STEPS
  for rank, out in enumerate(got):
    _compare(out["at_ckpt"], _rank_view(flat, rank, names), exact=True)
  final, losses = _jax_run(case, mesh, plan, model, restored,
                           _batches()[N_STEPS:])
  flat = _jax_flat(final)
  for rank, out in enumerate(got):
    np.testing.assert_allclose(losses, out["losses"][N_STEPS:], **TOL)
    _compare(_rank_view(flat, rank, names), out["final"], exact=False)


def test_jax_elastic_restore_of_a_port_world4_checkpoint(port_saved):
  """JAX re-shards the port's world-4 checkpoint onto world 2: every
  logical row of every table and optimizer lane bit-equal."""
  case, _, _, state, path, got = port_saved
  rule = _jax_rule(CASES[case][1])
  plan2, model2 = _plan(2), _model(2)
  dense = model2.init(jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
                      [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
                      emb_acts=[jnp.zeros((2, DIM)) for _ in VOCAB])["params"]
  like = init_sparse_state_direct(plan2, rule, dense,
                                  _jax_opt(CASES[case][0]),
                                  jax.random.PRNGKey(3))
  mesh2 = create_mesh(2)
  restored = jck.restore(path, plan2, rule, shard_params(like, mesh2),
                         mesh=mesh2)
  params, aux = unpack_sparse_state(plan2, rule, _numpy(restored),
                                    include_aux=True)
  want = got[0]["logical"]
  tables = get_weights(plan2, params["embeddings"])
  assert len(tables) == len(want["tables"]) == len(VOCAB)
  for t, (a, b) in enumerate(zip(tables, want["tables"])):
    np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"table {t}")
  for j in range(rule.n_aux):
    lanes = get_weights(plan2, {**params["embeddings"],
                                **{k: v[j] for k, v in aux.items()}})
    for t, (a, b) in enumerate(zip(lanes, want[f"aux{j}"])):
      np.testing.assert_array_equal(np.asarray(a), b,
                                    err_msg=f"aux {j} table {t}")
  assert int(np.asarray(restored["step"])) == N_STEPS


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_world4_checkpoint_resumes_in_the_port(tmp_path, case):
  plan, model, state = _init(case)
  mesh = create_mesh(WORLD)
  batches = _batches()
  straight, losses = _jax_run(case, mesh, plan, model, state, batches)
  half, _ = _jax_run(case, mesh, plan, model, state, batches[:N_STEPS])
  path = str(tmp_path / "jax_ckpt")
  jck.save(path, plan, _jax_rule(CASES[case][1]), half)
  got = spawn(tmp_path, WORLD, "ckpt_job",
              _spec(case, "restore", path, state))
  names = set(state["emb_dense"])
  at_ckpt, final = _jax_flat(half), _jax_flat(straight)
  for rank, out in enumerate(got):
    _compare(out["at_ckpt"], _rank_view(at_ckpt, rank, names), exact=True)
    np.testing.assert_allclose(out["losses"], losses[N_STEPS:], **TOL)
    _compare(out["final"], _rank_view(final, rank, names), exact=False)

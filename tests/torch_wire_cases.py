"""Shared cases of the wire-compression parity tests (``dedup_exchange``,
``dedup_capacity``, ``wire_dtype='fp8'``) at world 4.

The JAX side runs a 4-device CPU mesh (one ``shard_map`` program); the
port runs four gloo processes (``tests/torch_ranks.py: mb_guard_job``),
both from one JAX initial state. The DLRM cell: nine tables of width 16,
three in a dense class, two row-sliced; one-hot inputs, a padded
multi-hot ``sum`` input, and two padded multi-hot ``mean`` inputs (one
on a row-sliced table), global batch 32 of uniform ids over small
vocabularies, so every exchange block carries duplicates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.parallel.lookup_engine import (
    class_buckets,
    padded_rows,
)
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_eval_step,
    make_sparse_train_step,
    shard_batch,
    shard_params,
    unpack_sparse_state,
)

TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 4
VOCAB = [3, 10, 24, 40, 64, 100, 160, 300, 600]
DIM = 16
B = 32  # global: 8 per rank
NUM = 4
LR = 0.1
THRESHOLD = 32  # the three smallest tables ride a dense class
ROW_SLICE = 256 * DIM  # tables of more than 256 rows are row-sliced
HOT = {4: 3, 5: 2, 8: 4}  # padded multi-hot inputs
COMBINER = {4: "sum", 5: "mean", 8: "mean"}  # input 8's table is row-sliced
BOTTOM = (16, DIM)
TOP = (16, 1)
STEPS = 3


def plan(overlap="none", chunks=None, **kw):
  if chunks is None:
    chunks = 1 if overlap == "none" else 2
  return DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=DIM, combiner=COMBINER.get(i))
       for i, v in enumerate(VOCAB)], WORLD, "memory_balanced",
      dense_row_threshold=THRESHOLD, row_slice_threshold=ROW_SLICE,
      batch_hint=B, overlap=overlap, exchange_chunks=chunks, **kw)


def model():
  return DLRM(vocab_sizes=VOCAB, embedding_dim=DIM, bottom_mlp=BOTTOM,
              top_mlp=TOP, world_size=WORLD, row_slice=ROW_SLICE,
              dense_row_threshold=THRESHOLD)


def rule_of(name):
  return getattr(jpt, f"{name}_rule")(LR)


def initial(rule_name):
  """The JAX initial state of the cell under ``rule_name``."""
  dense = model().init(jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
                       [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
                       emb_acts=[jnp.zeros((2, DIM)) for _ in VOCAB]
                       )["params"]
  return init_sparse_state_direct(plan(), rule_of(rule_name), dense,
                                  optax.sgd(LR), jax.random.PRNGKey(1))


def numpy_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense", "step")}


def batches(n, seed=7, b=B):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n):
    cats = []
    for i, v in enumerate(VOCAB):
      if i in HOT:
        ids = rng.integers(0, v, (b, HOT[i])).astype(np.int32)
        ids[rng.random((b, HOT[i])) < 0.25] = -1  # padded bags
        cats.append(ids)
      else:
        cats.append(rng.integers(0, v, b).astype(np.int32))
    out.append((rng.standard_normal((b, NUM)).astype(np.float32), cats,
                rng.integers(0, 2, b).astype(np.float32)))
  return out


def spec(state, rule_name, runs, train_batches):
  """The ``mb_guard_job`` spec of the cell."""
  return {"vocab": VOCAB, "dim": DIM, "combiner": COMBINER, "world": WORLD,
          "strategy": "memory_balanced", "dense_row_threshold": THRESHOLD,
          "row_slice": ROW_SLICE, "batch": B, "bottom": BOTTOM, "top": TOP,
          "num": NUM, "rule": rule_name, "lr": LR,
          "state": numpy_state(state), "batches": train_batches,
          "runs": runs}


def jax_run(state, rule_name, train_batches, guard=False, eval_batch=None,
            rule_lr=None, **plan_kw):
  """The JAX mesh step over the batches (losses, metrics when guarded,
  the final state unpacked to the simple layout; the rule at ``rule_lr``
  when given, else at ``LR``), and with
  ``eval_batch`` the eval step's predictions (and metrics) on the final
  state."""
  mesh = create_mesh(WORLD)
  p = plan(**plan_kw)
  rule = (rule_of(rule_name) if rule_lr is None
          else getattr(jpt, f"{rule_name}_rule")(rule_lr))
  st = shard_params(state, mesh)
  out = {"losses": [], "metrics": []}
  if train_batches:
    step = make_sparse_train_step(model(), p, bce_loss, optax.sgd(LR), rule,
                                  mesh, st, shard_batch(train_batches[0],
                                                        mesh),
                                  donate=False, guard=guard)
    for numerical, cats, labels in train_batches:
      res = step(st, *shard_batch((numerical, list(cats), labels), mesh))
      st = res[0]
      out["losses"].append(float(res[1]))
      if guard:
        out["metrics"].append(jax.tree_util.tree_map(int, res[2]))
  params, aux = unpack_sparse_state(p, rule, jax.device_get(st),
                                    include_aux=True)
  out["final"] = jax.tree_util.tree_map(np.asarray, (params, aux))
  if eval_batch is not None:
    ev = make_sparse_eval_step(model(), p, rule, mesh, st, eval_batch,
                               with_metrics=True)
    preds, m = ev(st, *shard_batch(eval_batch, mesh))
    out["eval"] = {"preds": np.asarray(preds),
                   **jax.tree_util.tree_map(int, m)}
  return out


def routed_overflow(p, cats, cap):
  """Per class, the dedup-capacity overflow of one global batch counted
  in numpy from the plan's slots: each source rank routes its slice of
  the batch to every destination rank, one block per (sparse bucket,
  destination) of ``n_b`` slots (a padded slot and every padded or
  out-of-window id is the sentinel), and a block with more distinct
  values than ``cap`` overflows by the excess. Summed over the ranks."""
  from distributed_embeddings_tpu.parallel.lookup_engine import (
      class_param_name,
  )
  world = p.world_size
  b = cats[0].shape[0] // world
  hot = [1 if c.ndim == 1 else c.shape[1] for c in cats]
  out = {class_param_name(*k): 0 for k in p.class_keys}
  for key in p.class_keys:
    cp = p.classes[key]
    if cp.kind != "sparse":
      continue
    sentinel = padded_rows(p, key)
    for bucket in class_buckets(p, key, lambda i: hot[i]):
      for src in range(world):
        for dst in range(world):
          idxs = bucket.slot_idx_per_rank[dst]
          vals = []
          for k in range(bucket.n_b):
            if k >= len(idxs):
              vals.append(np.full(1, sentinel))
              continue
            slot = cp.slots_per_rank[dst][idxs[k]]
            ids = np.asarray(cats[slot.input_id][src * b:(src + 1) * b])
            ids = ids.reshape(b, -1)[:, :max(1, bucket.h)].reshape(-1)
            sh = slot.shard
            if sh.row_sliced:
              vocab = p.global_configs[sh.table_id].input_dim
              cl = np.clip(ids, 0, vocab - 1)
              inw = (ids >= 0) & (cl >= sh.row_start) & (
                  cl < sh.row_start + sh.input_dim)
              vals.append(np.where(inw, cl - sh.row_start + slot.row_offset,
                                   sentinel))
            else:
              vals.append(np.where(ids < 0, sentinel,
                                   np.clip(ids, 0, sh.input_dim - 1)
                                   + slot.row_offset))
          m = bucket.n_b * b * max(1, bucket.h)
          if cap < min(m, sentinel + 1):
            distinct = np.unique(np.concatenate(vals)).size
            out[class_param_name(*key)] += max(0, distinct - cap)
  return out

"""The delta-stream cell the port's streaming tests share (no JAX here:
the spawned ranks import it too).

``tests/test_streaming.py``'s small plan: five tables of widths 16/16/8/
8/16 and hotness 3/1/3/2/1 (a quarter of the slots PAD), every table
sparse, Adagrad 0.05 on the tables, SGD 0.01 on the (empty) dense
parameters, a model stub that returns the concatenated activations, and
a squared-error loss on their sum.
"""

import functools
import json
import os

import numpy as np
import torch
from torch import nn

SIZES = [131, 97, 53, 40, 67]
WIDTHS = [16, 16, 8, 8, 16]
HOTNESS = [3, 1, 3, 2, 1]
SPARSE_LR = 0.05
DENSE_LR = 0.01
PAD_ID = -1
QUANTIZE = ("f32", "int8", "fp8")
# manifest fields that carry wall clocks, or digests of files whose bytes
# carry them (an npz's zip entries are time-stamped)
WALL_FIELDS = ("published_wall", "train_wall_oldest", "train_wall_newest")
DIGEST_FIELDS = ("checksums", "base_fingerprint")


class TorchActsModel(nn.Module):
  """The port's model stub: the concatenated embedding activations."""

  def forward(self, numerical, cats, emb_acts=None):
    del numerical, cats
    return torch.cat(list(emb_acts), dim=-1)


def torch_loss(preds, labels):
  return torch.mean((preds.sum(dim=-1) - labels) ** 2)


def mkbatch(rng, b):
  ids = []
  for s, h in zip(SIZES, HOTNESS):
    x = rng.integers(0, s, (b, h)).astype(np.int32)
    x[rng.random(x.shape) < 0.25] = PAD_ID
    ids.append(x)
  return (rng.standard_normal((b, 4)).astype(np.float32), ids,
          rng.integers(0, 2, b).astype(np.float32))


def weights(seed: int = 0):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal((s, w)).astype(np.float32)
          for s, w in zip(SIZES, WIDTHS)]


def plan_kw(dedup: bool = False):
  return dict(dense_row_threshold=0, input_hotness=HOTNESS,
              dedup_exchange=dedup)


def torch_plan(world: int = 1, dedup: bool = False):
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import \
      DistEmbeddingStrategy
  return DistEmbeddingStrategy(
      [TableConfig(s, w, combiner="sum") for s, w in zip(SIZES, WIDTHS)],
      world, "memory_balanced", **plan_kw(dedup))


def torch_rule():
  from distributed_embeddings_torch.ops.packed_table import sparse_rule
  return sparse_rule("adagrad", SPARSE_LR)


def torch_state(plan, mesh=None, seed: int = 0):
  """The port's initial train state (this rank's blocks with a mesh)."""
  from distributed_embeddings_torch.layers.dist_model_parallel import \
      set_weights
  from distributed_embeddings_torch.training import init_sparse_state
  tables = {k: torch.as_tensor(v)
            for k, v in set_weights(plan, weights(seed)).items()}
  return init_sparse_state(plan, {"embeddings": tables}, torch_rule(),
                           functools.partial(torch.optim.SGD, lr=DENSE_LR),
                           device="cpu", mesh=mesh)


def torch_step(plan, mesh=None, guard: bool = False):
  from distributed_embeddings_torch.training import make_sparse_train_step
  return make_sparse_train_step(
      TorchActsModel(), plan, torch_loss,
      functools.partial(torch.optim.SGD, lr=DENSE_LR), torch_rule(),
      mesh=mesh, guard=guard)


def run_step(step, state, batch, mesh=None):
  """One port step on a GLOBAL numpy batch (this rank's slice at world
  N); returns the new state."""
  from distributed_embeddings_torch.training import shard_batch
  num, cats, labels = shard_batch(
      (batch[0], tuple(batch[1]), batch[2]), mesh, "cpu")
  out = step(state, num, list(cats), labels)
  return out[0]


def state_numpy(state):
  """A copy of a port train state's publishable parts as numpy."""
  return {"fused": {k: v.detach().cpu().numpy().copy()
                    for k, v in state["fused"].items()},
          "emb_dense": {k: v.detach().cpu().numpy().copy()
                        for k, v in state["emb_dense"].items()},
          "dense": {}, "step": int(state["step"])}


def strip_manifest(man):
  """A delta or base manifest without its wall clocks and digests."""
  man = json.loads(json.dumps(man))
  for f in DIGEST_FIELDS:
    man.pop(f, None)
  for sec in (man.get("stream") or {}, (man.get("extra") or {}).get(
      "stream") or {}):
    for f in WALL_FIELDS:
      sec.pop(f, None)
  return man


def npz_arrays(path):
  with np.load(path) as z:
    return {k: np.asarray(z[k]) for k in z.files}


def compare_artifacts(got_dir, want_dir):
  """Two published directories (a delta or a base) hold the same files,
  each ``.npy`` byte for byte and each ``.npz`` array for array (the zip
  entries carry their write times), and equal manifests apart from the
  wall clocks and digests. Returns the file names."""
  from distributed_embeddings_torch.checkpoint import read_manifest
  names = sorted(os.listdir(got_dir))
  assert names == sorted(os.listdir(want_dir)), (names,
                                                 sorted(os.listdir(want_dir)))
  for name in names:
    a, b = os.path.join(got_dir, name), os.path.join(want_dir, name)
    if name.endswith(".npy"):
      with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), name
    elif name.endswith(".npz"):
      za, zb = npz_arrays(a), npz_arrays(b)
      assert sorted(za) == sorted(zb), (name, sorted(za), sorted(zb))
      for k in za:
        assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, \
            (name, k, za[k].dtype, zb[k].dtype)
        assert za[k].tobytes() == zb[k].tobytes(), (name, k)
  ma, mb = read_manifest(got_dir), read_manifest(want_dir)
  assert sorted(ma["checksums"]) == sorted(mb["checksums"])
  assert strip_manifest(ma) == strip_manifest(mb)
  return names


# ---------------------------------------------------------------------------
# the tiered cell: tests/test_streaming.py's ``_tiered_run`` plan
# ---------------------------------------------------------------------------

T_VOCAB = [2000, 300, 40]
T_WIDTH = 16
T_HOST_ROWS = 1000
T_CFG = dict(cache_fraction=0.3, staging_grps=64)


def tiered_batch(seed, n=32):
  from distributed_embeddings_torch.models.synthetic import power_law_ids
  r = np.random.default_rng(seed)
  return (r.standard_normal((n, 13)).astype(np.float32),
          [power_law_ids(r, n, 1, v, 1.05).astype(np.int32)[:, 0]
           for v in T_VOCAB],
          r.integers(0, 2, n).astype(np.float32))


def tiered_model():
  from distributed_embeddings_torch.models import DLRM
  torch.manual_seed(0)
  return DLRM(T_VOCAB, T_WIDTH, bottom_mlp=(32, T_WIDTH), top_mlp=(32, 1),
              num_numerical=13, tables=False, device="cpu")


def tiered_cell(world: int = 1, mesh=None):
  """``(plan, rule, store, trainer)``: the port's ``TieredTrainer`` over
  the tiered plan (the 2,000-row table host-tier), each rank's store
  owning its rank at world N."""
  from distributed_embeddings_torch import tiering as tt
  from distributed_embeddings_torch.layers.dist_model_parallel import \
      set_weights
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import \
      DistEmbeddingStrategy
  from distributed_embeddings_torch.models import bce_loss
  plan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=T_WIDTH) for v in T_VOCAB],
      world, "memory_balanced", dense_row_threshold=0,
      host_row_threshold=T_HOST_ROWS)
  rule = torch_rule()
  tplan = tt.TieringPlan(plan, rule, tt.TieringConfig(**T_CFG))
  store = tt.HostTierStore(
      tplan, owned_ranks=None if mesh is None else (mesh.rank,))
  rng = np.random.default_rng(1)
  tables = set_weights(plan, [
      (rng.standard_normal((v, T_WIDTH)) * 0.05).astype(np.float32)
      for v in T_VOCAB])
  model = tiered_model()
  params = dict(model.state_dict())
  params["embeddings"] = tables
  factory = functools.partial(torch.optim.SGD, lr=DENSE_LR)
  state = tt.init_tiered_state_from_params(tplan, store, rule, params,
                                           factory, mesh=mesh, device="cpu")
  trainer = tt.TieredTrainer(model, tplan, store, bce_loss, factory, rule,
                             mesh, state, device="cpu")
  return plan, rule, store, trainer

"""The port's hybrid-parallel training helpers (``layers/
dist_model_parallel.py``) against the JAX package and against world 1.

- After ``finalize_hybrid_grads`` on four gloo ranks, every gradient
  equals the world-1 gradient of the same model over the global batch
  (the f32 class): the replicated MLPs' directly, the class blocks'
  gathered and compared table by table through ``get_weights`` (row
  slices and a dense class included).
- ``hybrid_partition_specs`` splits a model's parameters and its Adagrad
  state as the JAX one does (``tests/test_dist_embedding_module.py:
  test_hybrid_partition_specs_for_adagrad_state``).
- ``broadcast_variables`` makes ranks whose MLPs came from different
  seeds equal to the root's and leaves the class blocks alone;
  ``BroadcastGlobalVariablesCallback`` broadcasts on its first batch only;
  ``DistributedGradientTape`` raises; ``DistributedOptimizer`` carries
  its optimizer through.
- ``DistributedEmbedding(return_oov=True)`` at world 4 returns the JAX
  layer's psum'd ``metrics`` counters (``tests/
  test_dist_embedding_module.py: test_metrics_collection_psums_across_mesh``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distributed_embeddings_torch.layers import dist_model_parallel as tdmp
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss
from distributed_embeddings_torch.training import Adagrad
from distributed_embeddings_tpu.compat import shard_map
from distributed_embeddings_tpu.layers import hybrid_partition_specs
from distributed_embeddings_tpu.layers.dist_model_parallel import (
    DistributedEmbedding,
)
from distributed_embeddings_tpu.layers.embedding import TableConfig
from torch_ranks import spawn

TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 4
VOCAB = [3, 10, 24, 40, 64, 100, 160, 300, 600]
DIM = 16
B = 64  # global
MODEL = dict(vocab_sizes=VOCAB, embedding_dim=DIM, bottom_mlp=(32, DIM),
             top_mlp=(32, 16, 1), num_numerical=13, strategy="memory_balanced",
             row_slice=256 * DIM, dense_row_threshold=32)
OOV_VOCAB = [50, 50, 50]
OOV_DIM = 8


def _oov_inputs():
  rng = np.random.default_rng(1)
  inputs = [rng.integers(0, 50, 2 * WORLD).astype(np.int32)
            for _ in OOV_VOCAB]
  inputs[1][:5] = 77  # 5 OOV ids spread over the ranks' slices
  return inputs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
  rng = np.random.default_rng(0)
  weights = [rng.uniform(-0.5, 0.5, (v, DIM)).astype(np.float32)
             for v in VOCAB]
  dense = {k: v.numpy() for k, v in TDLRM(
      **MODEL, device="cpu", tables=False,
      generator=torch.Generator().manual_seed(0)).state_dict().items()}
  batch = (rng.standard_normal((B, 13)).astype(np.float32),
           [rng.integers(0, v, (B,)).astype(np.int32) for v in VOCAB],
           rng.integers(0, 2, (B,)).astype(np.float32))
  spec = {"model": MODEL, "weights": weights, "dense": dense, "batch": batch,
          "oov_vocab": OOV_VOCAB, "oov_dim": OOV_DIM,
          "oov_inputs": _oov_inputs()}
  return spec, spawn(tmp_path_factory.mktemp("hybrid"), WORLD, "hybrid_job",
                     spec)


def test_finalized_grads_equal_the_world1_global_batch_grads(job):
  spec, got = job
  model = TDLRM(**MODEL, device="cpu")
  plan1 = model.embeddings.plan
  tables = tdmp.set_weights(plan1, spec["weights"])
  model.load_state_dict({**{k: torch.tensor(v)
                            for k, v in spec["dense"].items()},
                         **{f"embeddings.{k}": torch.tensor(v)
                            for k, v in tables.items()}})
  numerical, cats, labels = spec["batch"]
  bce_loss(model(torch.tensor(numerical), [torch.tensor(c) for c in cats]),
           torch.tensor(labels)).backward()
  want = {n: p.grad.numpy() for n, p in model.named_parameters()}
  plan4 = TDLRM(**MODEL, world_size=WORLD, device="cpu").embeddings.plan
  assert any(sh.row_sliced for shards in plan4.rank_shards for sh in shards)
  assert {cp.kind for cp in plan4.classes.values()} == {"sparse", "dense"}
  want_tables = tdmp.get_weights(plan1, {
      n.split(".", 1)[1]: g for n, g in want.items()
      if n.startswith("embeddings.")})
  for rank_out in got:
    grads = rank_out["grads"]
    for name, g in want.items():
      if not name.startswith("embeddings."):
        np.testing.assert_allclose(grads[name], g, err_msg=name, **TOL)
    got_tables = tdmp.get_weights(plan4, {
        n.split(".", 1)[1]: g for n, g in grads.items()
        if n.startswith("embeddings.")})
    for t, (g, w) in enumerate(zip(got_tables, want_tables)):
      assert np.any(w), t
      np.testing.assert_allclose(g, w, err_msg=f"table {t}", **TOL)


def test_broadcast_variables_copies_the_root_and_keeps_the_blocks(job):
  _, got = job
  root = got[0]["broadcast"]["before"]
  assert not np.array_equal(got[1]["broadcast"]["before"], root)
  for rank_out in got:
    np.testing.assert_array_equal(rank_out["broadcast"]["after"], root)
    assert rank_out["broadcast"]["blocks_kept"]


def test_broadcast_callback_broadcasts_once(job):
  _, got = job
  root = got[0]["callback"]["first"]
  for rank, rank_out in enumerate(got):
    np.testing.assert_array_equal(rank_out["callback"]["first"], root)
    # the second batch's end broadcast nothing: each rank keeps its shift
    assert np.array_equal(rank_out["callback"]["second"], root) == (rank == 0)


def test_return_oov_equals_the_jax_psum(job):
  _, got = job
  configs = tuple(TableConfig(input_dim=v, output_dim=OOV_DIM)
                  for v in OOV_VOCAB)
  dmp = DistributedEmbedding(embeddings=configs, world_size=WORLD)
  inputs = [jnp.asarray(x) for x in _oov_inputs()]
  variables = dmp.init(jax.random.PRNGKey(0), inputs)
  names = list(variables["params"].keys())
  mesh = Mesh(np.array(jax.devices()[:WORLD]), ("mp",))

  def fwd(variables, *inputs):
    _, mut = dmp.apply(variables, list(inputs), mutable=["metrics"])
    return {k: jax.tree_util.tree_leaves(v)[0]
            for k, v in mut["metrics"].items()}

  flat = jax.jit(shard_map(
      fwd, mesh=mesh,
      in_specs=({"params": {n: P("mp", None) for n in names}},)
      + tuple(P("mp") for _ in inputs),
      out_specs={f"oov_{n}": P() for n in names}))(variables, *inputs)
  want = {k: int(np.asarray(v)) for k, v in flat.items()}
  assert sum(want.values()) == 5
  for rank_out in got:
    assert rank_out["oov"] == want


def test_hybrid_partition_specs_match_jax_with_adagrad_state():
  configs = [dict(input_dim=16, output_dim=8) for _ in range(8)]
  jemb = DistributedEmbedding(
      embeddings=tuple(TableConfig(**c) for c in configs),
      world_size=WORLD).init(jax.random.PRNGKey(0),
                             [jnp.zeros((WORLD,), jnp.int32)] * 8)["params"]
  jparams = {"emb": jemb, "dense": {"w": jnp.zeros((4,))}}
  jspecs = hybrid_partition_specs(optax.adagrad(0.1).init(jparams))
  want = {}
  for path, spec in jax.tree_util.tree_leaves_with_path(jspecs):
    names = [str(getattr(p, "key", getattr(p, "name", ""))) for p in path]
    want[names[-1]] = "mp" if spec == P("mp", None) else "replicated"
  assert sorted(set(want.values())) == ["mp", "replicated"]

  emb = tdmp.DistributedEmbedding([TTableConfig(**c) for c in configs],
                                  world_size=WORLD, device="cpu")
  params = {"emb": emb, "dense": torch.nn.Linear(4, 1)}
  model = torch.nn.ModuleDict(params)
  opt = Adagrad(model.parameters(), lr=0.1)
  for p in model.parameters():
    p.grad = torch.ones_like(p)
  opt.step()
  specs = tdmp.hybrid_partition_specs(model)
  state = {n: opt.state[p] for n, p in model.named_parameters()}
  state_specs = tdmp.hybrid_partition_specs(state)
  for name, spec in specs.items():
    leaf = name.split(".")[-1]
    assert state_specs[name] == {"sum": spec}, name
    if leaf.startswith("mp_table_"):
      assert spec == want[leaf] == "mp", name
    else:
      assert spec == "replicated", name
  assert want["w"] == "replicated"


def test_distributed_gradient_tape_raises():
  with pytest.raises(NotImplementedError, match="loss.backward"):
    tdmp.DistributedGradientTape()


def test_distributed_optimizer_carries_its_optimizer():
  """At world 1 (no process group) ``DistributedOptimizer`` steps as its
  optimizer does and carries its state and groups through."""
  lin = torch.nn.Linear(3, 2)
  twin = torch.nn.Linear(3, 2)
  twin.load_state_dict(lin.state_dict())
  opt = tdmp.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.5,
                                                  momentum=0.9), lin)
  ref = torch.optim.SGD(twin.parameters(), lr=0.5, momentum=0.9)
  x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
  for _ in range(2):
    for m, o in ((lin, opt), (twin, ref)):
      o.zero_grad()
      m(x).square().sum().backward()
      o.step()
  for a, b in zip(lin.parameters(), twin.parameters()):
    torch.testing.assert_close(a, b, rtol=0, atol=0)
  assert opt.param_groups is opt.optimizer.param_groups
  assert opt.state_dict()["state"].keys() == ref.state_dict()["state"].keys()
  opt.zero_grad()
  assert all(p.grad is None for p in lin.parameters())

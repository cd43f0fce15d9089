"""World-4 serving from artifacts, against the JAX serve step over a
4-device CPU mesh.

The DLRM of ``tests/test_torch_train_world4.py`` (nine tables at D=128,
two of them row-sliced over the ranks, three in a dense class, SGD,
``overlap='fused'`` with two chunks) and one JAX train state. The JAX
package exports it from its single controller; the port exports it from
four gloo ranks (``tests/torch_ranks.py: serve_job``), each writing its
own blocks into the shared directory, rank 0 publishing. Then:

- the port's artifact loads in JAX (``serving.load(mesh=)``): its
  manifest sections are the JAX artifact's, its serve blocks
  byte-identical, and the JAX ``ServeEngine`` predicts on it what it
  predicts on its own (bit-equal);
- the JAX artifact loads in the port, each rank reading its own blocks:
  every rank answers every global request alike, on either artifact and
  on the in-memory ``FrozenTables`` (bit-equal), and within the f32
  class (rtol 1e-5, atol 1e-6) of the JAX engine;
- f32 serving is bit-equal to the port's own world-4 eval step.
"""

import os

import jax
import numpy as np
import optax
import pytest

from distributed_embeddings_torch import checkpoint as tckpt
from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_tpu import checkpoint as jckpt
from distributed_embeddings_tpu import serving as jserving
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.training import init_sparse_state_direct
from test_torch_train_world4 import (
    BOTTOM,
    DENSE_ROW_THRESHOLD,
    DIM,
    NUM,
    ROW_SLICE,
    TOP,
    VOCAB,
    WORLD,
    _jax_model,
    _jax_params,
)
from torch_ranks import spawn

TOL = dict(rtol=1e-5, atol=1e-6)
B = 64  # global: 16 per rank
QUANTIZE = ("f32", "int8")
REQUESTS = 2


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("w4serve")
  plan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=DIM) for v in VOCAB], WORLD,
      "memory_balanced", dense_row_threshold=DENSE_ROW_THRESHOLD,
      row_slice_threshold=ROW_SLICE, batch_hint=B, overlap="fused",
      exchange_chunks=2)
  assert any(sh.row_sliced for shards in plan.rank_shards for sh in shards)
  assert {cp.kind for cp in plan.classes.values()} == {"sparse", "dense"}
  rule = jpt.sgd_rule(port_golden.LR)
  model = _jax_model(VOCAB, WORLD)
  state = init_sparse_state_direct(plan, rule, _jax_params(model, VOCAB),
                                   optax.sgd(port_golden.LR),
                                   jax.random.PRNGKey(5))
  numpy_state = {k: jax.tree_util.tree_map(np.asarray, state[k])
                 for k in ("fused", "emb_dense", "dense", "step")}
  rng = np.random.default_rng(6)
  requests = [(rng.standard_normal((B, NUM)).astype(np.float32),
               [rng.integers(0, v + 2, (B,)).astype(np.int32)
                for v in VOCAB]) for _ in range(REQUESTS)]
  mesh = create_mesh(WORLD)
  jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
  want = {}
  for q in QUANTIZE:
    jserving.export(os.path.join(jax_dir, q), plan, rule, numpy_state,
                    quantize=q)
    eng = jserving.ServeEngine(model, plan, jserving.load(
        os.path.join(jax_dir, q), plan, mesh=mesh), mesh=mesh)
    want[q] = [np.asarray(eng.predict(n, tuple(c))) for n, c in requests]
  spec = {"vocab": VOCAB, "dim": DIM, "combiner": {}, "world": WORLD,
          "strategy": "memory_balanced",
          "dense_row_threshold": DENSE_ROW_THRESHOLD, "row_slice": ROW_SLICE,
          "batch": B, "bottom": BOTTOM, "top": TOP, "num": NUM,
          "lr": port_golden.LR, "state": numpy_state, "requests": requests,
          "quantize": QUANTIZE, "jax": jax_dir, "port": port_dir}
  got = spawn(tmp, WORLD, "serve_job", spec)
  return plan, mesh, model, requests, jax_dir, port_dir, want, got


@pytest.mark.parametrize("q", QUANTIZE)
def test_every_rank_answers_alike_on_either_artifact(world4, q):
  *_, want, got = world4
  base = got[0][q]["port"]
  for rank_out in got:
    for source in ("port", "jax", "frozen"):
      for g, b in zip(rank_out[q][source], base):
        assert g.shape == (B,) and np.all(np.isfinite(g))
        np.testing.assert_array_equal(g, b, err_msg=source)
  for g, w in zip(base, want[q]):
    np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("q", QUANTIZE)
def test_port_world4_artifact_loads_in_jax(world4, q):
  plan, mesh, model, requests, jax_dir, port_dir, want, got = world4
  path, jpath = os.path.join(port_dir, q), os.path.join(jax_dir, q)
  assert jckpt.verify(path) == [] and tckpt.verify(path) == []
  pm, jm = tckpt.read_manifest(path), tckpt.read_manifest(jpath)
  for key in ("format_version", "kind", "step", "rule", "plan", "serve"):
    assert pm[key] == jm[key], key
  assert pm["checksums"].keys() == jm["checksums"].keys()
  serve_files = [f for f in pm["checksums"] if f.startswith("serve_")]
  assert len(serve_files) == WORLD * len(pm["serve"]["classes"])
  for f in serve_files:
    assert pm["checksums"][f] == jm["checksums"][f], f
  art = jserving.load(path, plan, mesh=mesh)
  eng = jserving.ServeEngine(model, plan, art, mesh=mesh)
  for (n, c), w in zip(requests, want[q]):
    np.testing.assert_array_equal(np.asarray(eng.predict(n, tuple(c))), w)
  for rank, rank_out in enumerate(got):
    for name, block in rank_out[q]["blocks"].items():
      np.testing.assert_array_equal(block, art.rank_block(name, rank))


def test_f32_serving_is_bit_equal_to_the_eval_step(world4):
  *_, got = world4
  for rank_out in got:
    for s, e in zip(rank_out["f32"]["port"], rank_out["f32"]["eval"]):
      np.testing.assert_array_equal(s, e)

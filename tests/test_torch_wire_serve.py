"""World-4 serving and the dense-autodiff step (the README's Quick start)
under ``dedup_exchange=True`` and the fp8 wire, against the JAX package.

- **Serving**: the DLRM of ``tests/test_torch_serve_world4.py`` under a
  dedup plan (``overlap='fused'``, 2 chunks). Four gloo ranks
  (``tests/torch_ranks.py: serve_job``) export, load and serve; every
  rank's answers on the port's artifact, the JAX package's and the
  in-memory frozen tables are bit-equal, bit-equal to the port's raw
  (non-dedup) serving of the same artifact and, f32, to the dedup eval
  step; they agree with the JAX dedup ``ServeEngine`` in the f32 class
  (the MLPs sum in each BLAS's order). A capped plan is unservable, with
  the JAX message.
- **Dense autodiff**: ``make_train_step(mesh=)`` on a model that owns a
  ``DistributedEmbedding(dedup_exchange=True)`` (penalties, a multi-hot
  ``mean`` input on a row-sliced table, Adagrad: the fixture of
  ``tests/test_torch_dense_train_world4.py``) under the monolithic and
  fused schedules, against the JAX world-4 step (whose layer takes the
  default wire) in the f32 class; with ``wire_dtype='fp8'`` the losses
  stay finite and within the JAX tests' fp8 bound (5e-2) of f32.
"""

import os

import jax
import numpy as np
import optax
import pytest

from distributed_embeddings_torch import serving as tserving
from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
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
B = 64
QUANTIZE = ("f32", "int8")
DEDUP = {"dedup_exchange": True}


def _jax_plan(**kw):
  return DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=DIM) for v in VOCAB], WORLD,
      "memory_balanced", dense_row_threshold=DENSE_ROW_THRESHOLD,
      row_slice_threshold=ROW_SLICE, batch_hint=B, overlap="fused",
      exchange_chunks=2, **kw)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("w4wireserve")
  plan = _jax_plan(**DEDUP)
  rule = jpt.sgd_rule(port_golden.LR)
  model = _jax_model(VOCAB, WORLD)
  state = init_sparse_state_direct(plan, rule, _jax_params(model, VOCAB),
                                   optax.sgd(port_golden.LR),
                                   jax.random.PRNGKey(7))
  numpy_state = {k: jax.tree_util.tree_map(np.asarray, state[k])
                 for k in ("fused", "emb_dense", "dense", "step")}
  rng = np.random.default_rng(8)
  # ids past the vocabulary clip; small tables repeat ids in every block
  requests = [(rng.standard_normal((B, NUM)).astype(np.float32),
               [rng.integers(0, v + 2, (B,)).astype(np.int32)
                for v in VOCAB]) for _ in range(2)]
  mesh = create_mesh(WORLD)
  jax_dir = str(tmp / "jax")
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
          "quantize": QUANTIZE, "jax": jax_dir}
  got = {}
  for name, kw in (("dedup", DEDUP), ("raw", {})):
    s = dict(spec, port=str(tmp / f"port_{name}"), plan_kw=kw)
    os.makedirs(tmp / name)
    got[name] = spawn(tmp / name, WORLD, "serve_job", s)
  return want, got


@pytest.mark.parametrize("q", QUANTIZE)
def test_dedup_serving_matches_raw_serving_and_jax(served, q):
  want, got = served
  base = got["raw"][0][q]["port"]
  for rank_out in got["dedup"]:
    for source in ("port", "jax", "frozen"):
      for g, b in zip(rank_out[q][source], base):
        assert g.shape == (B,) and np.all(np.isfinite(g))
        np.testing.assert_array_equal(g, b, err_msg=source)
    if q == "f32":
      for g, e in zip(rank_out[q]["port"], rank_out[q]["eval"]):
        np.testing.assert_array_equal(g, e)
  for g, w in zip(got["dedup"][0][q]["port"], want[q]):
    np.testing.assert_allclose(g, w, **TOL)


def test_a_capped_plan_is_unservable_with_the_jax_message():
  from distributed_embeddings_tpu.models import DLRM as JDLRM
  jplan = _jax_plan(dedup_exchange=True, dedup_capacity=8)
  tplan = TStrategy(
      [TTableConfig(input_dim=v, output_dim=DIM) for v in VOCAB], WORLD,
      "memory_balanced", dense_row_threshold=DENSE_ROW_THRESHOLD,
      row_slice_threshold=ROW_SLICE, batch_hint=B, overlap="fused",
      exchange_chunks=2, dedup_exchange=True, dedup_capacity=8)
  with pytest.raises(ValueError) as ej:
    jserving.make_serve_step(JDLRM(vocab_sizes=VOCAB, embedding_dim=DIM),
                             jplan, {}, None, {}, None)
  with pytest.raises(ValueError) as et:
    tserving.make_serve_step(
        TDLRM(VOCAB, DIM, tables=False, device="cpu"), tplan, {})
  assert str(et.value) == str(ej.value)
  assert "dedup_capacity" in str(et.value)


# ---------------------------------------------------------------------------
# the dense-autodiff step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
  import test_torch_dense_train_world4 as dw
  batches = dw._batches(np.random.default_rng(dw.SEED + 2), dw.VOCAB,
                        port_golden.STEPS, dw.HOT)
  (numerical, cats, _), = dw._batches(np.random.default_rng(dw.SEED + 3),
                                      dw.VOCAB, 1, dw.HOT)
  model = dw._JaxTiny()
  init = jax.tree_util.tree_map(np.asarray, model.init(
      jax.random.PRNGKey(dw.SEED), *dw._as_jax(batches[0][:2]))["params"])
  dense_name = next(k for k in init["embeddings"] if k.endswith("_dense"))
  init["embeddings"][dense_name] = init["embeddings"][dense_name] * 20.0
  plan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=dw.DIM,
                   combiner=dw.COMBINER.get(i),
                   regularizer=dw.PENALTIES.get(("reg", i)),
                   constraint=dw.PENALTIES.get(("con", i)))
       for i, v in enumerate(dw.VOCAB)], WORLD, "memory_balanced",
      dense_row_threshold=dw.DENSE_ROW_THRESHOLD,
      row_slice_threshold=dw.ROW_SLICE)
  want = dw._jax_train(model, init, batches, (numerical, cats),
                       optax.adagrad(port_golden.LR), plan=plan)
  spec = {"vocab": dw.VOCAB, "dim": dw.DIM, "num": dw.NUM,
          "combiner": dw.COMBINER, "penalties": dw.PENALTIES,
          "row_slice": dw.ROW_SLICE,
          "dense_row_threshold": dw.DENSE_ROW_THRESHOLD,
          "lr": port_golden.LR, "init": init, "batches": batches,
          "eval_batch": (numerical, cats),
          "schedules": (("none", 1, DEDUP), ("fused", 2, DEDUP),
                        ("fused", 2, dict(DEDUP, wire_dtype="fp8")),
                        ("fused", 2))}
  got = spawn(tmp_path_factory.mktemp("w4wiredense"), WORLD,
              "dense_extras_job", spec)
  return want, got


@pytest.mark.parametrize("key", ["none/1/dedup_exchange=True",
                                 "fused/2/dedup_exchange=True"])
def test_dense_dedup_step_matches_jax(dense, key):
  (want_losses, want, want_preds), got = dense
  for rank_out in got:
    losses, final, preds = rank_out[key]
    np.testing.assert_allclose(losses, want_losses, **TOL)
    for name, buf in want["embeddings"].items():
      np.testing.assert_allclose(final[f"embeddings.{name}"], buf,
                                 err_msg=name, **TOL)
    np.testing.assert_allclose(final["head.weight"],
                               want["head"]["kernel"].T, **TOL)
    np.testing.assert_allclose(preds, want_preds, **TOL)
  # the first loss is a forward through a bit-exact lookup
  raw = got[0]["fused/2"]
  assert got[0][key][0][0] == raw[0][0]


def test_dense_fp8_dedup_step_stays_close_to_f32(dense):
  _, got = dense
  losses = np.asarray(got[0]["fused/2/dedup_exchange=True/wire_dtype=fp8"][0])
  f32 = np.asarray(got[0]["fused/2"][0])
  assert np.all(np.isfinite(losses))
  np.testing.assert_allclose(losses, f32, rtol=0, atol=5e-2)
  assert not np.array_equal(losses, f32)

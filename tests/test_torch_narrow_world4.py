"""Narrow storage and fp8 serve images at world 4: four gloo ranks (one
spawn of ``tests/torch_ranks.py: multi_job``) against the JAX package
over a 4-device CPU mesh.

The DLRM cell of ``tests/torch_wire_cases.py`` (nine width-16 tables,
three in a dense class, two row-sliced; padded multi-hot ``sum`` and
``mean`` inputs) drawn by the JAX ``init_sparse_state_direct(dtype=
jnp.bfloat16)``: bf16 packed buffers (several rows a physical row), bf16
optimizer lanes under Adagrad, bf16 dense-class tables. The JAX mesh step
runs on those buffers under ``'none'``, ``'pipelined'`` and ``'fused'``
and ships the bf16 rows over its f32 (identity) wire as they are; so does
the port.

- **The sparse step** (``narrow_job``): three SGD and three Adagrad steps
  under each schedule, and three Adagrad steps of the cell's
  column-sliced plan (``SLICED``) under ``'fused'``, then the eval step.
  Every buffer stays bf16; every
  final table and optimizer-lane cell within ``ULPS`` bf16 ulps of the
  JAX mesh step's under the same schedule, at least ``BIT_EQUAL_SHARE``
  of them bit-equal; losses in the f32 class, predictions within
  ``PRED_TOL``; the port's schedules bit-equal to its ``'none'``.
- **Serving** (``serve_job``): the bf16 state exported by every rank as
  f32 and fp8 images byte-identical to the JAX package's export; the
  answers from the port's artifact, the JAX artifact and the frozen
  tables bit-equal to each other, f32 within ``PRED_TOL`` of the eval
  step (which rounds a bf16 state's multi-hot bags to bf16), and in the
  f32 class of the JAX world-4 engine's (on the JAX frozen tables:
  the JAX ``load`` cannot read the bf16 ``emb_dense.npz`` its own export
  writes). The activations themselves are held bit-equal at world 1
  (``tests/test_torch_serve_fp8.py``).
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest

import torch_wire_cases as C
from distributed_embeddings_tpu import serving as jserving
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.serving.export import freeze as jfreeze
from distributed_embeddings_tpu.training import init_sparse_state_direct
from torch_ranks import spawn_start, spawn_wait

SCHEDULES = {"none": ("none", 1), "pipelined": ("pipelined", 2),
             "fused": ("fused", 2)}
RULES = ("sgd", "adagrad")
# the world-1 test's ulp bound (tests/test_torch_narrow_storage.py); the
# bit-equal share is lower than world 1's 99.9 %: at world N the f32 sums
# of a row's cotangents from several ranks (the dense classes' one-hot
# backward, the reverse exchange) run in another order than the JAX mesh
# step's, and an f32 sum a few f32 ulps off flips its bf16 rounding now
# and then (this cell: 99.78 % SGD, 99.95 % Adagrad, every cell within 4
# ulps)
ULPS = 4
BIT_EQUAL_SHARE = 0.995
# the predictions on tables a bf16 ulp (2^-8) apart here and there
PRED_TOL = dict(rtol=1e-3, atol=1e-5)
SERVE_Q = ("f32", "fp8")
# column slices: the cell's tables above 512 elements cut into 8- and
# 4-lane slices (tests/test_torch_colslice_world4.py), Adagrad's bf16
# lanes beside them, several rows a physical row, the multi-hot buckets
# through the window-masked gather
SLICED = {"column_slice_threshold": 512}


def _bf16_initial(rule_name, **plan_kw):
  dense = C.model().init(
      jax.random.PRNGKey(0), jnp.zeros((2, C.NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in C.VOCAB],
      emb_acts=[jnp.zeros((2, C.DIM)) for _ in C.VOCAB])["params"]
  return init_sparse_state_direct(C.plan(**plan_kw), C.rule_of(rule_name),
                                  dense, optax.sgd(C.LR),
                                  jax.random.PRNGKey(1), dtype=jnp.bfloat16)


def _ulps(got, want):
  g = np.asarray(got).view(ml_dtypes.bfloat16).astype(np.float32)
  w = np.asarray(want).astype(np.float32)
  m = np.maximum(np.abs(g), np.abs(w))
  ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
  return np.abs(g - w) / ulp


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("narrow_w4")
  batches, ev = C.batches(C.STEPS, seed=51), C.batches(1, seed=52)[0][:2]
  states = {r: _bf16_initial(r) for r in RULES}
  states["sliced"] = _bf16_initial("adagrad", **SLICED)
  runs = [{"name": f"{r}_{s}", "rule": r, "overlap": o, "chunks": c}
          for r in RULES for s, (o, c) in SCHEDULES.items()]
  runs.append({"name": "adagrad_sliced", "rule": "adagrad",
               "overlap": "fused", "chunks": 2, "plan_kw": SLICED,
               "state": "sliced"})
  narrow_spec = dict(C.spec(states["sgd"], "sgd", [], batches),
                     states={r: C.numpy_state(st) for r, st in
                             states.items()},
                     runs=runs, eval=ev)
  jax_dir = str(tmp / "jax")
  serve_plan = C.plan("fused", 2)
  for q in SERVE_Q:
    jserving.export(os.path.join(jax_dir, q), serve_plan, C.rule_of("sgd"),
                    C.numpy_state(states["sgd"]), quantize=q)
  requests = [C.batches(1, seed=54 + i)[0][:2] for i in range(2)]
  serve_spec = dict(C.spec(states["sgd"], "sgd", [], []), requests=requests,
                    quantize=SERVE_Q, jax=jax_dir, port=str(tmp / "port"))
  started = spawn_start(tmp, C.WORLD, "multi_job", {"jobs": {
      "narrow": ("narrow_job", narrow_spec),
      "serve": ("serve_job", serve_spec)}})
  want = {}
  for r in RULES:
    for s, (o, c) in SCHEDULES.items():
      want[f"{r}_{s}"] = C.jax_run(states[r], r, batches, eval_batch=ev,
                                   overlap=o, chunks=c)
  want["adagrad_sliced"] = C.jax_run(states["sliced"], "adagrad", batches,
                                     eval_batch=ev, overlap="fused",
                                     chunks=2, **SLICED)
  mesh = create_mesh(C.WORLD)
  want["serve"] = {}
  for q in SERVE_Q:
    # the JAX package's own load cannot read its bf16 emb_dense.npz back
    # (ROADMAP.md §3): its engine serves the frozen tables
    eng = jserving.ServeEngine(C.model(), serve_plan, jfreeze(
        serve_plan, C.rule_of("sgd"), C.numpy_state(states["sgd"]),
        quantize=q), mesh=mesh)
    want["serve"][q] = [np.asarray(eng.predict(n, tuple(c)))
                        for n, c in requests]
  got = spawn_wait(started)
  return want, got, jax_dir


@pytest.mark.parametrize("rule,schedule", [
    (r, s) for r in RULES for s in SCHEDULES] + [("adagrad", "sliced")])
def test_bf16_step_matches_jax(world4, rule, schedule, capsys):
  want, got, _ = world4
  name = f"{rule}_{schedule}"
  w = want[name]
  params, aux = w["final"]
  cells = equal = 0
  res = got[0]["narrow"][name]
  pairs = [(res["tables"][k], v) for k, v in params["embeddings"].items()]
  pairs += [(a, b) for k, lanes in aux.items()
            for a, b in zip(res["aux"][k], lanes)]
  assert len(pairs) > len(params["embeddings"]) or rule == "sgd"
  for g, v in pairs:
    assert v.dtype == ml_dtypes.bfloat16 and g.dtype == np.uint16
    u = _ulps(g, v)
    assert u.max() <= ULPS, (name, u.max())
    cells += u.size
    equal += int((g == np.asarray(v).view(np.uint16)).sum())
  share = equal / cells
  with capsys.disabled():
    print(f"\n{name}: {share:.6%} of {cells} bf16 cells bit-equal to the "
          "JAX mesh step")
  assert share >= BIT_EQUAL_SHARE
  for rank_out in got:
    res = rank_out["narrow"][name]
    assert set(res["dtypes"].values()) == {"torch.bfloat16"}
    np.testing.assert_allclose(res["losses"], w["losses"], **C.TOL)
    np.testing.assert_allclose(res["preds"], w["eval"]["preds"], **PRED_TOL)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("schedule", ["pipelined", "fused"])
def test_bf16_schedules_are_bit_exact_against_none(world4, rule, schedule):
  _, got, _ = world4
  for rank_out in got:
    base = rank_out["narrow"][f"{rule}_none"]
    res = rank_out["narrow"][f"{rule}_{schedule}"]
    assert res["losses"] == base["losses"]
    np.testing.assert_array_equal(res["preds"], base["preds"])
    for k, t in base["tables"].items():
      np.testing.assert_array_equal(res["tables"][k], t, err_msg=k)
    for k, lanes in base["aux"].items():
      for a, b in zip(res["aux"][k], lanes):
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("quantize", SERVE_Q)
def test_world4_images_and_answers_equal_jax(world4, quantize):
  want, got, jax_dir = world4
  for rank, rank_out in enumerate(got):
    res = rank_out["serve"][quantize]
    for name, block in res["blocks"].items():
      ref = np.load(os.path.join(jax_dir, quantize,
                                 f"serve_{name}_r{rank}.npy"))
      np.testing.assert_array_equal(block.view(np.uint8) if quantize ==
                                    "fp8" else block, ref.view(np.uint8)
                                    if quantize == "fp8" else ref)
    # the three sources bit-equal; the JAX engine's DLRM in the f32 class
    # (the MLPs' products sum in each library's order)
    for src in ("port", "jax", "frozen"):
      for a, b, c in zip(res[src], res["port"], want["serve"][quantize]):
        np.testing.assert_array_equal(a, b, err_msg=src)
        np.testing.assert_allclose(a, c, err_msg=src, **C.TOL)
    if quantize == "f32":
      # the eval step combines a bf16 state's multi-hot rows in f32 and
      # rounds the bag to bf16 (as the JAX step does); the f32 image's
      # bag stays f32
      for a, b in zip(res["eval"], res["port"]):
        np.testing.assert_allclose(a, b, **PRED_TOL)

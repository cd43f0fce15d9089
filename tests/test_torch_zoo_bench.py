"""The zoo harness's torch twins against their JAX originals on the CPU.

- ``distributed_embeddings_torch/utils/zoo_bench.py: run_zoo_plan_step``
  against ``distributed_embeddings_tpu/utils/zoo_bench.py`` (the recipe
  behind ``tests/test_plan_scale.py``): Tiny at its cut vocabulary, from
  the JAX recipe's initial state (carried by
  ``convert.zoo_train_state_from_flax``), at world 1 and at world 4 (four
  gloo ranks, ``tests/torch_ranks.py: zoo_plan_job``, against the 4-device
  CPU mesh): the same counts of tables, inputs and classes, the loss in
  the f32 class (rtol 1e-5, atol 1e-6).
- ``examples/benchmarks/synthetic_models/main_torch.py`` against
  ``main.py`` at ``--shrink 0.0001``: started from ``main.py``'s own
  initial params (``model.init(PRNGKey(0), ...)``), the twin's loss after
  one Adagrad step is ``main.py``'s (``--warmup_steps 1 --steps 1`` prints
  it, to 5 decimals); the twin runs as two gloo ranks with ``torchrun``'s
  environment and prints its lines from rank 0.
- ``examples/benchmarks/benchmark_torch.py`` against ``benchmark.py``'s
  inputs and functions at vocab 1,000 x 8, batch 64, hotness <= 64: the
  same numpy draws; the CSR and padded forwards in the f32 class of the
  JAX ones (XLA reduces each bag in its own order), their gradients of
  ``sum(out ** 2)`` and the SGD step the same with each cell within 1e-5
  of the largest gradient cell (a row adds its bags' cotangents, which
  cancel); ``main`` runs and prints its rows.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch.convert import zoo_train_state_from_flax
from distributed_embeddings_torch.utils.zoo_bench import run_zoo_plan_step
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import synthetic as jsyn
from distributed_embeddings_tpu.ops.packed_table import adagrad_rule
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.training import init_sparse_state_direct
from distributed_embeddings_tpu.utils import zoo_bench as jzoo
from torch_ranks import free_port, spawn_start, spawn_wait

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = Path(__file__).resolve().parent.parent
ZOO = REPO / "examples" / "benchmarks" / "synthetic_models"
BENCH = REPO / "examples" / "benchmarks"
WORLD = 4


def _load(name, path):
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _jax_recipe_state(name, world, b_local=2, vocab_cap=2000,
                      dense_row_threshold=16):
  """The initial state the JAX ``run_zoo_plan_step`` draws (the same
  keys, plan and model), as numpy."""
  cfg = jsyn.SYNTHETIC_MODELS[name]
  tables, tmap, hotness = jsyn.expand_tables(cfg)
  scale = vocab_cap / max(t.input_dim for t in tables)
  tables = [dataclasses.replace(t, input_dim=max(8, int(t.input_dim * scale)))
            for t in tables]
  batch = b_local * world
  plan = DistEmbeddingStrategy(tables, world, "memory_balanced",
                               input_table_map=tmap,
                               dense_row_threshold=dense_row_threshold,
                               input_hotness=hotness, batch_hint=batch)
  model = jsyn.SyntheticModel(config=cfg, world_size=world,
                              dense_row_threshold=dense_row_threshold)
  numerical, cats, _ = jsyn.generate_batch(cfg, batch, alpha=1.05, seed=0)
  cats = [np.minimum(c, tables[t].input_dim - 1).astype(np.int32)
          for c, t in zip(cats, tmap)]
  cats = [jnp.asarray(c if h > 1 else c[:, 0])
          for c, h in zip(cats, hotness)]
  dummy = [jnp.zeros((2, tables[t].output_dim), jnp.float32) for t in tmap]
  dense = model.init(jax.random.PRNGKey(0), jnp.asarray(numerical[:2]),
                     [c[:2] for c in cats], emb_acts=dummy)["params"]
  state = init_sparse_state_direct(plan, adagrad_rule(0.01), dense,
                                   optax.adagrad(0.01),
                                   jax.random.PRNGKey(1))
  return jax.tree_util.tree_map(np.asarray, jax.device_get(state))


@pytest.fixture(scope="module")
def zoo_world4(tmp_path_factory):
  state = _jax_recipe_state("tiny", WORLD)
  started = spawn_start(tmp_path_factory.mktemp("zoo_plan_w4"), WORLD,
                        "zoo_plan_job", {"name": "tiny", "state": state})
  want = jzoo.run_zoo_plan_step("tiny", create_mesh(WORLD), WORLD)
  return want, spawn_wait(started)


def _assert_result(got, want):
  for k in ("name", "tables", "inputs", "classes"):
    assert got[k] == want[k], k
  assert sorted(got) == sorted(want)
  np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
  for k in ("plan_s", "init_s", "step_s"):
    assert got[k] > 0


def test_zoo_plan_step_world1_matches_jax():
  want = jzoo.run_zoo_plan_step("tiny", None, 1)
  state = zoo_train_state_from_flax(_jax_recipe_state("tiny", 1),
                                    device="cpu")
  got = run_zoo_plan_step("tiny", None, 1, state=state, device="cpu")
  _assert_result(got, want)
  assert got["tables"] == 55 and got["inputs"] == 58
  # its own seeded draw runs too, to a finite loss
  own = run_zoo_plan_step("tiny", None, 1, device="cpu")
  assert np.isfinite(own["loss"]) and own["classes"] == want["classes"]


def test_zoo_plan_step_world4_matches_jax(zoo_world4):
  want, got = zoo_world4
  for rank_out in got:
    _assert_result(rank_out, want)


def _jax_main_loss(argv):
  """``main.py``'s printed first loss and its initial params, in this
  process."""
  mod = _load("zoo_main_jax", ZOO / "main.py")
  old = sys.argv
  sys.argv = ["main.py", *argv, "--platform", "cpu", "--world_size", "1"]
  buf = io.StringIO()
  try:
    with contextlib.redirect_stdout(buf):
      mod.main()
  finally:
    sys.argv = old
  out = buf.getvalue()
  return float(re.findall(r"loss ([-+0-9.naif]+)", out)[-1]), out


ZOO_ARGS = ["--model", "tiny", "--batch_size", "64", "--steps", "1",
            "--warmup_steps", "1", "--shrink", "0.0001", "--num_batches", "1"]


def test_zoo_main_twin_first_loss_matches_main_py():
  want, jout = _jax_main_loss(ZOO_ARGS)
  twin = _load("zoo_main_torch", ZOO / "main_torch.py")
  args = twin.parse_args(ZOO_ARGS)
  tcfg = twin.shrunk_config(args.model, args.shrink)
  jcfg = jsyn.SYNTHETIC_MODELS["tiny"]
  jcfg = dataclasses.replace(jcfg, embedding_groups=tuple(
      dataclasses.replace(g, num_rows=max(4, int(g.num_rows * args.shrink)))
      for g in jcfg.embedding_groups))
  numerical, cats, _ = twin.host_batches(tcfg, args)[0]
  model = jsyn.SyntheticModel(config=jcfg, world_size=1,
                              strategy=args.strategy, batch_hint=64)
  init = jax.tree_util.tree_map(np.asarray, model.init(
      jax.random.PRNGKey(0), jnp.asarray(numerical),
      [jnp.asarray(c) for c in cats])["params"])
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    res = twin.main(ZOO_ARGS + ["--device", "cpu"], init=init)
  out = buf.getvalue()
  # the same first line, but for the platform
  assert out.splitlines()[0].replace("platform=cpu", "") == \
      jout.splitlines()[0].replace("platform=cpu", "")
  assert "step time:" in out and "samples/sec" in out
  assert len(res["losses"]) == 2
  # main.py prints 5 decimals of the loss of its second step
  assert abs(res["losses"][-1] - want) <= 5e-6 + 1e-5 * abs(want)


def test_zoo_main_twin_runs_at_world_2():
  port = free_port()
  procs = []
  for rank in range(2):
    env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "OMP_NUM_THREADS": "1"}
    procs.append(subprocess.Popen(
        [sys.executable, str(ZOO / "main_torch.py"), "--model", "tiny",
         "--batch_size", "32", "--steps", "2", "--warmup_steps", "1",
         "--shrink", "0.0001", "--num_batches", "2", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True))
  outs = []
  try:
    for p in procs:
      outs.append(p.communicate(timeout=240))
  finally:
    for p in procs:  # a hung rank must not outlive the test
      if p.poll() is None:
        p.kill()
        p.wait()
  for p, (out, err) in zip(procs, outs):
    assert p.returncode == 0, out + err
  out = outs[0][0]
  assert "world=2" in out and not outs[1][0]  # rank 0 prints
  loss = float(re.findall(r"loss ([-+0-9.naif]+)", out)[-1])
  assert np.isfinite(loss)


@pytest.fixture(scope="module")
def bench():
  return _load("benchmark_torch", BENCH / "benchmark_torch.py")


BENCH_SHAPE = dict(vocab=1000, width=8, batch=64, hotness=64)


def _jax_inputs(vocab, width, batch, hotness):
  """``benchmark.py: main``'s draws, in its order."""
  rng = np.random.default_rng(0)
  params = jnp.asarray(rng.standard_normal((vocab, width)), jnp.float32)
  lengths = rng.integers(1, hotness + 1, batch)
  nnz = int(lengths.sum())
  values = jnp.asarray(rng.integers(0, vocab, nnz), jnp.int32)
  row_splits = jnp.asarray(np.concatenate([[0], np.cumsum(lengths)]),
                           jnp.int32)
  dense_ids = jnp.asarray(rng.integers(0, vocab, (batch, hotness)),
                          jnp.int32)
  return params, values, row_splits, dense_ids


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_lookup_benchmark_functions_match_benchmark_py(bench, combiner):
  from distributed_embeddings_tpu.ops import csr_lookup as jcsr
  jp, jv, js, jd = _jax_inputs(**BENCH_SHAPE)
  params, _, values, splits, dense = bench.make_inputs(**BENCH_SHAPE)
  np.testing.assert_array_equal(params, np.asarray(jp))
  np.testing.assert_array_equal(values, np.asarray(jv))
  np.testing.assert_array_equal(splits, np.asarray(js))
  np.testing.assert_array_equal(dense, np.asarray(jd))
  jfwd = {"fused_csr": (lambda p, v: jcsr(p, v, js, combiner), jv),
          "padded_dense": ((lambda p, i: jnp.sum(jnp.take(p, i, axis=0), 1))
                           if combiner == "sum" else
                           (lambda p, i: jnp.mean(jnp.take(p, i, axis=0), 1)),
                           jd)}
  tsplits = torch.from_numpy(splits)
  tfwd = {"fused_csr": (bench.csr_fwd(tsplits, combiner),
                        torch.from_numpy(values)),
          "padded_dense": (bench.padded_fwd(combiner),
                           torch.from_numpy(dense))}
  tparams = torch.from_numpy(params)
  for name, (jf, jids) in jfwd.items():
    tf, tids = tfwd[name]
    with torch.no_grad():
      got = tf(tparams, tids).numpy()
    want = np.asarray(jax.jit(jf)(jp, jids))
    np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    jgrad = np.asarray(jax.grad(
        lambda p, i, jf=jf: jnp.sum(jf(p, i) ** 2))(jp, jids))
    # a row's gradient adds its bags' cotangents, which cancel: each cell
    # within 1e-5 of the largest
    np.testing.assert_allclose(bench.grad_of(tf)(tparams, tids).numpy(),
                               jgrad, rtol=1e-5,
                               atol=1e-5 * np.abs(jgrad).max(), err_msg=name)
    p = tparams.clone()
    bench.sgd_of(tf)(p, tids)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp) - 0.01 * jgrad,
                               rtol=1e-5,
                               atol=1e-7 * np.abs(jgrad).max(), err_msg=name)
  # the engine's ragged combine gives the CSR forward
  with torch.no_grad():
    seg = bench.segment_fwd(tsplits, combiner)(tparams,
                                                torch.from_numpy(values))
    np.testing.assert_allclose(
        seg.numpy(), tfwd["fused_csr"][0](tparams,
                                          torch.from_numpy(values)).numpy(),
        **TOL)


def test_lookup_benchmark_main_runs(bench):
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    res = bench.main(["--vocab", "1000", "--width", "8", "--batch", "64",
                      "--steps", "1", "--device", "cpu"])
  out = buf.getvalue()
  assert "fused_csr: forward" in out and "padded_dense: forward" in out
  assert "speedup" in out
  assert set(res["rows"]) == {"fused_csr", "padded_dense"}
  assert res["nnz"] == int(bench.make_inputs(1000, 8, 64, 64)[1].sum())

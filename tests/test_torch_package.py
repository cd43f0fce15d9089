"""The PyTorch port stands alone and runs on the card unless told not to.

- It imports with ``jax``, ``flax``, ``optax``, ``ml_dtypes`` and
  ``distributed_embeddings_tpu`` blocked, every module of it (the
  world > 1 modules ``parallel.mesh``, ``parallel.wire`` and
  ``ops.cuda_exchange``, and the zoo's ``models.synthetic``,
  ``ops.cuda_delta`` and ``ops.cuda_layout`` included);
- no ``.py`` file of it, nor ``chip_smoke.py``, names one of those in an
  import statement;
- its entry points default to ``device="cuda"``: without a GPU they raise
  instead of quietly running on the CPU (slice 5's too: ``DLRM`` with its
  tables, ``DistributedEmbedding``, ``Embedding``, ``make_train_step``,
  ``shard_params``; and the world-N Quick start's: ``create_mesh``, whose
  mesh places ``DistributedEmbedding(mesh=)`` and the world-N
  ``make_train_step`` / ``shard_params``, and the trainer script
  ``examples/dlrm/main_torch.py``);
- ``convert.split_rank_state`` cuts a rank's view out of a JAX world-N
  train state and ``join_rank_states`` reverses it;
- the trainer's modules (``checkpoint`` with ``save``/``restore``, the
  Criteo reader and the native loader's builder ``cc``) import with JAX
  blocked, and ``cc/data_loader.cc`` is the port's own copy; the native
  build writes only under ``build/`` (which ``.gitignore`` lists), and
  ``checkpoint.restore`` defaults to the card;
- the resilience modules (``guards``, ``retry``, ``durable``,
  ``trainer``) import with JAX blocked, and so does
  ``tools/torch_chaos_train.py``; ``durable.restore_latest`` and the chaos
  tool default to the card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_embeddings_torch import train_golden
from distributed_embeddings_torch.convert import (
    join_rank_states,
    split_rank_state,
)
from distributed_embeddings_torch.layers.dist_model_parallel import (
    DistributedEmbedding,
)
from distributed_embeddings_torch.layers.embedding import (
    Embedding,
    TableConfig,
)
from distributed_embeddings_torch.models import DLRM, dlrm_embedding_plan
from distributed_embeddings_torch.ops.packed_table import (
    PackedLayout,
    init_packed_uniform,
    sgd_rule,
)
from distributed_embeddings_torch.parallel.lookup_engine import (
    class_param_name,
    padded_rows,
)
from distributed_embeddings_torch.parallel.mesh import create_mesh
from distributed_embeddings_torch.serving import (
    MicroBatcher,
    ServeEngine,
    export,
    freeze,
    load,
)
from distributed_embeddings_torch.serving.engine import shard_batch
from distributed_embeddings_torch.serving.export import serve_class_meta
from distributed_embeddings_torch.training import (
    make_train_step,
    shard_params,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "distributed_embeddings_torch"
BANNED = ("jax", "flax", "optax", "ml_dtypes", "distributed_embeddings_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in {banned!r}:
  sys.modules[name] = None
import distributed_embeddings_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
  importlib.import_module(name)
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in {banned!r} and sys.modules[n] is not None)
assert not leaked, leaked
print(" ".join(names))
"""


def test_port_imports_with_jax_blocked():
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  r = subprocess.run([sys.executable, "-c", _IMPORT_ALL.format(banned=BANNED)],
                     cwd=REPO, env=env, capture_output=True, text=True,
                     timeout=120)
  assert r.returncode == 0, r.stdout + r.stderr
  names = set(r.stdout.split())
  assert len(names) >= 15  # every module was imported
  # slice 3's modules among them: the process group, the wire, K4; slice
  # 4's: K6, K7 and the synthetic zoo; slice 5's: the op and layer surface
  # of the dense-autodiff path; slice 10's: the serve artifact, the
  # micro-batcher and the telemetry it reports through; slice 11's: the
  # trainer's data
  for mod in ("parallel.mesh", "parallel.wire", "ops.cuda_exchange",
              "ops.cuda_delta", "ops.cuda_layout", "models.synthetic",
              "ops.ragged", "ops.embedding_lookup",
              "layers.dist_model_parallel", "layers.embedding",
              "checkpoint", "resilience.faultinject", "serving.batcher",
              "telemetry.registry", "telemetry.trace", "telemetry.flight",
              "telemetry.export", "utils", "utils.data", "cc",
              "resilience.guards", "resilience.retry", "resilience.durable",
              "resilience.trainer"):
    assert f"distributed_embeddings_torch.{mod}" in names, mod


def _imported_roots(path: Path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split(".")[0], node.lineno
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split(".")[0], node.lineno


def test_no_source_imports_jax_or_the_jax_package():
  files = sorted(PORT.rglob("*.py")) + [
      REPO / "chip_smoke.py", REPO / "examples" / "dlrm" / "main_torch.py",
      REPO / "tools" / "torch_chaos_train.py"]
  assert len(files) > 15
  bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
         for f in files for root, line in _imported_roots(f)
         if root in BANNED]
  assert not bad, bad


def test_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is usable")
  vocab = [5, 300]
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    DLRM(vocab, embedding_dim=8, bottom_mlp=(8,), top_mlp=(4, 1),
         num_numerical=2)
  lay = PackedLayout(4, 8)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    init_packed_uniform(lay, torch.Generator(), torch.ones(4), ())
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    shard_batch((np.zeros((2, 2), np.float32),))
  plan = dlrm_embedding_plan(vocab, 8, dense_row_threshold=16)
  model = DLRM(vocab, embedding_dim=8, bottom_mlp=(8,), top_mlp=(4, 1),
               num_numerical=2, tables=False, device="cpu")
  rule = sgd_rule(0.1)
  _, layouts = serve_class_meta(plan, rule, "f32")
  dense_key = [k for k in plan.class_keys
               if plan.classes[k].kind == "dense"]
  state = {"fused": {n: np.zeros(lay.shape, np.float32)
                     for n, lay in layouts.items()},
           "emb_dense": {class_param_name(*k): np.zeros(
               (padded_rows(plan, k), 8), np.float32) for k in dense_key},
           "dense": model.state_dict()}
  assert state["fused"] and state["emb_dense"]
  frozen = freeze(plan, rule, state)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    ServeEngine(model, plan, frozen)
  ServeEngine(model, plan, frozen, device="cpu")  # asked for: runs
  # slice 5's entry points: the layers, the dense-autodiff step
  tables = [TableConfig(input_dim=v, output_dim=8) for v in vocab]
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    DistributedEmbedding(tables)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    Embedding(5, 8)
  dlrm = DLRM(vocab, embedding_dim=8, bottom_mlp=(8,), top_mlp=(4, 1),
              num_numerical=2, dense_row_threshold=16, device="cpu")
  opt = torch.optim.SGD(dlrm.parameters(), lr=0.1)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    make_train_step(lambda m, *b: m(*b[:2]).sum(), opt, dlrm)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    shard_params(dlrm)
  step = make_train_step(lambda m, n, c, y: m(n, c).sum(), opt, dlrm,
                         device="cpu")  # asked for: runs
  loss = step(torch.zeros((2, 2)), [torch.zeros(2, dtype=torch.long)] * 2,
              torch.zeros(2))
  assert torch.isfinite(loss)
  assert DistributedEmbedding(tables, device="cpu").class_params()
  assert Embedding(5, 8, device="cpu").embeddings.device.type == "cpu"


def test_serve_artifact_entry_points_default_to_cuda(tmp_path):
  """``serving.load`` and a ``ServeEngine`` on a loaded artifact run on
  the card unless the caller asks for the CPU (``export`` writes from
  wherever the state lies)."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is usable")
  vocab = [5, 300]
  plan = dlrm_embedding_plan(vocab, 8, dense_row_threshold=16)
  model = DLRM(vocab, embedding_dim=8, bottom_mlp=(8,), top_mlp=(4, 1),
               num_numerical=2, tables=False, device="cpu")
  rule = sgd_rule(0.1)
  _, layouts = serve_class_meta(plan, rule, "f32")
  state = {"fused": {n: torch.zeros(lay.shape) for n, lay in layouts.items()},
           "emb_dense": {class_param_name(*k): torch.zeros(
               (padded_rows(plan, k), 8)) for k in plan.class_keys
               if plan.classes[k].kind == "dense"},
           "dense": model.state_dict()}
  path = str(tmp_path / "serve")
  export(path, plan, rule, state)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    load(path, plan)
  art = load(path, plan, device="cpu")  # asked for: runs
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    ServeEngine(model, plan, art)
  eng = ServeEngine(model, plan, art, device="cpu")
  mb = MicroBatcher(eng.dispatch, max_batch=4, start=False)
  fut = mb.submit(np.zeros((3, 2), np.float32),
                  [np.zeros(3, np.int32), np.ones(3, np.int32)])
  assert mb.flush_now() == 1
  assert fut.result(1.0).shape == (3,)


def test_world_n_entry_points_default_to_cuda():
  """The world-N Quick start runs on the card unless asked: its mesh
  (which places ``DistributedEmbedding(mesh=)``, ``DLRM(mesh=)`` and the
  world-N ``make_train_step`` / ``shard_params``) and the trainer script
  default to CUDA and raise without it."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is usable")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    create_mesh(1, 0, "tcp://127.0.0.1:1")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    shard_params({"embeddings.mp_table_w8_cat": np.zeros((4, 8))})
  twin = REPO / "examples" / "dlrm" / "main_torch.py"
  r = subprocess.run([sys.executable, str(twin), "--steps", "1",
                      "--vocab_scale", "1e-5", "--batch_size", "8"],
                     cwd=REPO, capture_output=True, text=True, timeout=120)
  assert r.returncode != 0
  assert "CUDA is not available" in r.stderr, r.stdout + r.stderr


def test_rank_views_split_and_join():
  """``convert.split_rank_state`` cuts rank ``r``'s rows out of every
  fused buffer and dense-class block and keeps the dense params whole;
  ``join_rank_states`` puts the global state back together."""
  state = train_golden.initial_state(train_golden.load(
      train_golden.WORLD4_PATH))
  world = 4
  views = [split_rank_state(state, world, r) for r in range(world)]
  for part in ("fused", "emb_dense"):
    for name, arr in state[part].items():
      n = arr.shape[0] // world
      for r, view in enumerate(views):
        np.testing.assert_array_equal(view[part][name],
                                      arr[r * n:(r + 1) * n])
  assert views[3]["dense"] is state["dense"]
  joined = join_rank_states(views)
  for part in ("fused", "emb_dense"):
    for name, arr in state[part].items():
      np.testing.assert_array_equal(joined[part][name], arr)
  with pytest.raises(ValueError, match="rank blocks"):
    split_rank_state({"fused": {"x": np.zeros((6, 2))}, "emb_dense": {}},
                     world, 0)


def test_native_loader_is_the_ports_own_and_builds_under_build():
  """``cc/data_loader.cc`` is a copy of the JAX package's loader (its code
  after the header comment is the same), built by the port's builder
  into ``build/torch_native/``, never into the JAX package."""
  from distributed_embeddings_torch import cc

  ours = (PORT / "cc" / "data_loader.cc").read_text()
  theirs = (REPO / "distributed_embeddings_tpu" / "cc" /
            "data_loader.cc").read_text()
  start = "#include <atomic>"
  assert ours[ours.index(start):] == theirs[theirs.index(start):]
  assert cc.SOURCE == PORT / "cc" / "data_loader.cc"
  assert cc.BUILD_DIR == REPO / "build" / "torch_native"
  assert "build/" in (REPO / ".gitignore").read_text().split()
  path = cc.build()
  assert path.parent == cc.BUILD_DIR and path.exists()
  assert not list((PORT / "cc").glob("*.so"))


def test_restore_defaults_to_cuda(tmp_path):
  """``checkpoint.restore`` puts the state on the card unless asked."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is usable")
  import functools

  from distributed_embeddings_torch import checkpoint
  from distributed_embeddings_torch.training import init_sparse_state_direct

  vocab = [5, 300]
  plan = dlrm_embedding_plan(vocab, 8, dense_row_threshold=16)
  model = DLRM(vocab, embedding_dim=8, bottom_mlp=(8,), top_mlp=(4, 1),
               num_numerical=2, tables=False, device="cpu")
  rule = sgd_rule(0.1)
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(),
      functools.partial(torch.optim.SGD, lr=0.1), torch.Generator(),
      device="cpu")
  path = str(tmp_path / "ckpt")
  checkpoint.save(path, plan, rule, state)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    checkpoint.restore(path, plan, rule, state)
  got = checkpoint.restore(path, plan, rule, state, device="cpu")
  assert all(t.device.type == "cpu" for t in got["fused"].values())


def test_resilience_entry_points_default_to_cuda(tmp_path):
  """``resilience.durable.restore_latest`` restores onto the card unless
  asked; the chaos tool runs on the card unless given ``--device cpu``;
  ``ResilientTrainer`` resumes onto its state's device."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is usable")
  import functools

  from distributed_embeddings_torch.resilience import durable
  from distributed_embeddings_torch.resilience.trainer import (
      ResilientTrainer,
  )
  from distributed_embeddings_torch.telemetry import MetricsRegistry
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )
  from distributed_embeddings_torch.models import bce_loss

  vocab = [5, 300]
  plan = dlrm_embedding_plan(vocab, 8, dense_row_threshold=16)
  model = DLRM(vocab, embedding_dim=8, bottom_mlp=(8,), top_mlp=(4, 1),
               num_numerical=2, tables=False, device="cpu")
  rule = sgd_rule(0.1)
  sgd = functools.partial(torch.optim.SGD, lr=0.1)
  state = init_sparse_state_direct(plan, rule, model.state_dict(), sgd,
                                   torch.Generator(), device="cpu")
  root = str(tmp_path / "root")
  durable.save_rotating(root, plan, rule, state)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    durable.restore_latest(root, plan, rule, state)
  step = make_sparse_train_step(model, plan, bce_loss, sgd, rule, guard=True)
  t = ResilientTrainer(step, state, plan, rule, root,
                       telemetry=MetricsRegistry())
  assert t.resumed_from and t.device.type == "cpu"
  chaos = REPO / "tools" / "torch_chaos_train.py"
  r = subprocess.run([sys.executable, str(chaos), "--steps", "2"], cwd=REPO,
                     capture_output=True, text=True, timeout=120)
  assert r.returncode != 0
  assert "CUDA is not available" in r.stderr, r.stdout + r.stderr

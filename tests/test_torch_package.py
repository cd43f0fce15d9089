"""The PyTorch port stands alone and runs on the card unless told not to.

- It imports with ``jax``, ``flax``, ``optax``, ``ml_dtypes`` and
  ``distributed_embeddings_tpu`` blocked, every module of it (the
  world > 1 modules ``parallel.mesh``, ``parallel.wire`` and
  ``ops.cuda_exchange``, and the zoo's ``models.synthetic``,
  ``ops.cuda_delta`` and ``ops.cuda_layout`` included);
- no ``.py`` file of it, nor ``chip_smoke.py``, names one of those in an
  import statement;
- its entry points default to ``device="cuda"``: without a GPU they raise
  instead of quietly running on the CPU;
- ``convert.split_rank_state`` cuts a rank's view out of a JAX world-N
  train state and ``join_rank_states`` reverses it.
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
from distributed_embeddings_torch.serving import ServeEngine, freeze
from distributed_embeddings_torch.serving.engine import shard_batch
from distributed_embeddings_torch.serving.export import serve_class_meta

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
  # 4's: K6, K7 and the synthetic zoo
  for mod in ("parallel.mesh", "parallel.wire", "ops.cuda_exchange",
              "ops.cuda_delta", "ops.cuda_layout", "models.synthetic"):
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
  files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
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
               num_numerical=2, device="cpu")
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

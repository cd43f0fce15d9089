"""The DLRM trainer's data and script in the port: ``utils/data.py`` and
``examples/dlrm/main_torch.py`` against the JAX package's.

- ``DummyDataset`` draws the JAX package's batches bit for bit;
- ``dlrm_lr_schedule`` gives the JAX schedule's float32 values bit for
  bit, at steps across warmup, plateau, decay and after it;
- the twin's ``auc`` equals ``examples/dlrm/main.py: auc``, ties included;
- ``main_torch.py --device cpu`` trains 3 steps and evaluates at world 1
  (one process) and at world 2 (two gloo processes with ``torchrun``'s
  environment), printing finite losses and an AUC;
- the flags of later ROADMAP items are refused, naming the item.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_embeddings_torch.utils import data as tdata
from distributed_embeddings_tpu.utils import data as jdata
from torch_ranks import free_port

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "examples" / "dlrm" / "main_torch.py"
ARGS = ["--device", "cpu", "--dataset", "dummy", "--steps", "3",
        "--batch_size", "64", "--vocab_scale", "1e-5", "--lr", "0.1",
        "--warmup_steps", "2", "--eval",
        "--eval_every", "2"]


def _load(name, path):
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture(scope="module")
def twin():
  return _load("main_torch", SCRIPT)


@pytest.mark.parametrize("seed,idx", [(0, 0), (0, 3), (777, 1), (12, 7)])
def test_dummy_dataset_is_bit_equal_to_jax(seed, idx):
  vocab = [3, 100, 40000, 7]
  want = jdata.DummyDataset(32, 13, vocab, num_batches=8, seed=seed)[idx]
  got = tdata.DummyDataset(32, 13, vocab, num_batches=8, seed=seed)[idx]
  for w, g in zip([want[0], want[2]] + want[1], [got[0], got[2]] + got[1]):
    assert w.dtype == g.dtype
    np.testing.assert_array_equal(g, w)
  assert len(tdata.DummyDataset(4, vocab_sizes=vocab, num_batches=5)) == 5
  with pytest.raises(IndexError):
    tdata.DummyDataset(4, vocab_sizes=vocab, num_batches=5)[5]


@pytest.mark.parametrize("args", [(24.0, 2750, 49315, 27772),
                                  (0.1, 5, 12, 7), (0.37, 1, 3, 1),
                                  (0.1, 0, 0, 0)])
def test_lr_schedule_is_jax_in_float32(args):
  want, got = jdata.dlrm_lr_schedule(*args), tdata.dlrm_lr_schedule(*args)
  base, warm, start, span = args
  steps = sorted({0, 1, 2, warm - 1, warm, warm + 1, start - 1, start,
                  start + 1, start + span // 2, start + span - 1,
                  start + span, start + span + 1, start + span + 1000,
                  *range(0, 40)} - {-1})
  for s in steps:
    w, g = np.float32(want(s)), got(s)
    assert isinstance(g, np.float32), type(g)
    assert g.view(np.int32) == w.view(np.int32), (s, g, w)


def test_auc_equals_the_jax_script(twin):
  main = _load("jax_dlrm_main", REPO / "examples" / "dlrm" / "main.py")
  rng = np.random.default_rng(0)
  labels = rng.integers(0, 2, 500).astype(np.float32)
  scores = np.round(rng.random(500), 2).astype(np.float32)  # many ties
  assert len(np.unique(scores)) < 200
  assert twin.auc(labels, scores) == main.auc(labels, scores)
  assert np.isnan(twin.auc(np.ones(4), scores[:4]))


def _finite_lines(out):
  losses = [float(v) for v in re.findall(r"loss ([-+0-9.naif]+)", out)]
  aucs = [float(v) for v in re.findall(r"AUC: ([-+0-9.naif]+)", out)]
  assert losses and len(aucs) == 2, out
  assert np.all(np.isfinite(losses + aucs)), out
  assert "trained 3 steps" in out


def test_script_trains_at_world_1():
  r = subprocess.run([sys.executable, str(SCRIPT), *ARGS], cwd=REPO,
                     capture_output=True, text=True, timeout=240)
  assert r.returncode == 0, r.stdout + r.stderr
  _finite_lines(r.stdout)
  assert "world=1" in r.stdout


def test_script_trains_at_world_2(tmp_path):
  port = free_port()
  procs = []
  for rank in range(2):
    env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "OMP_NUM_THREADS": "1"}
    procs.append(subprocess.Popen(
        [sys.executable, str(SCRIPT), *ARGS, "--save_checkpoint",
         str(tmp_path / "tables.npz")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
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
  _finite_lines(outs[0][0])
  assert "world=2" in outs[0][0] and not outs[1][0]  # rank 0 prints
  with np.load(tmp_path / "tables.npz") as z:
    assert len(z.files) == 26
    assert z["arr_0"].shape == (max(4, int(39884406 * 1e-5)), 128)


@pytest.mark.parametrize("flags,item", [
    (["--sparse"], "item 5"), (["--checkpoint_dir", "/nonexistent"], "item 5"),
    (["--dataset", "criteo"], "item 5"), (["--micro_batches", "2"], "item 6")])
def test_refused_flags_name_their_roadmap_item(twin, flags, item):
  with pytest.raises(SystemExit, match=item):
    twin.main(ARGS + flags)

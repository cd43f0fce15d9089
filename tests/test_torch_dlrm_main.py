"""The DLRM trainer's data and script in the port: ``utils/data.py`` and
``examples/dlrm/main_torch.py`` against the JAX package's.

- ``DummyDataset`` draws the JAX package's batches bit for bit;
- ``dlrm_lr_schedule`` gives the JAX schedule's float32 values bit for
  bit, at steps across warmup, plateau, decay and after it;
- the twin's ``auc`` equals ``examples/dlrm/main.py: auc``, ties included;
- ``main_torch.py --device cpu`` trains 3 steps and evaluates at world 1
  (one process) and at world 2 (two gloo processes with ``torchrun``'s
  environment), printing finite losses and an AUC;
- ``--sparse --checkpoint_dir`` at world 1 and 2, each run twice: the
  second run resumes (``resumed from <dir> at step 3``) and the published
  directory passes both packages' ``verify``;
- ``--dataset criteo`` over a split that ``write_dummy_criteo_split``
  writes, at world 1 and 2, dense and sparse; at world 2 the ranks'
  batches together are the JAX reader's world-1 batch of the global size
  (``main.py`` reads rank 0's slice on every rank instead: ROADMAP.md
  §3);
- script against script: a checkpoint that ``main.py --sparse`` writes
  is resumed by ``main_torch.py --sparse``, and the reverse;
- ``--sparse --micro_batches 2`` at world 1 and 2 ends where the
  one-shot run does (every checkpointed array in the f32 class); the
  dense path reads no such flag, as in ``main.py``.
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


# vocabularies x 2e-4: the six largest tables (> 4,096 rows) are sparse
# classes, the rest ride the dense class
SPARSE = ["--sparse", "--vocab_scale", "2e-4"]
VOCAB_SCALED = [max(4, int(v * 2e-4)) for v in (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)]


def _run(argv, world, tmp_path, script=SCRIPT):
  """``script`` at ``world`` (one process, or one gloo process per rank
  with ``torchrun``'s environment); returns rank 0's stdout."""
  if world == 1:
    r = subprocess.run([sys.executable, str(script), *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout
  port = free_port()
  procs = []
  for rank in range(world):
    env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "OMP_NUM_THREADS": "1"}
    procs.append(subprocess.Popen(
        [sys.executable, str(script), *argv], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
  outs = []
  try:
    for p in procs:
      outs.append(p.communicate(timeout=300))
  finally:
    for p in procs:  # a hung rank must not outlive the test
      if p.poll() is None:
        p.kill()
        p.wait()
  for p, (out, err) in zip(procs, outs):
    assert p.returncode == 0, out + err
  assert all(not out for out, _ in outs[1:])  # rank 0 prints
  return outs[0][0]


@pytest.mark.parametrize("world", [1, 2])
def test_sparse_checkpoint_and_resume(tmp_path, world):
  from distributed_embeddings_torch import checkpoint as tck
  from distributed_embeddings_tpu import checkpoint as jck
  ckpt = str(tmp_path / "ckpt")
  argv = ARGS + SPARSE + ["--checkpoint_dir", ckpt, "--checkpoint_every",
                          "2"]
  first = _run(argv, world, tmp_path)
  _finite_lines(first)
  assert "resumed" not in first
  assert f"checkpointed step 2 -> {ckpt}" in first
  assert f"saved full train state -> {ckpt}" in first
  assert tck.read_manifest(ckpt)["step"] == 3
  second = _run(argv, world, tmp_path)
  _finite_lines(second)
  assert f"resumed from {ckpt} at step 3" in second
  manifest = tck.read_manifest(ckpt)
  assert manifest["step"] == 6 and manifest["plan"]["world_size"] == world
  assert tck.verify(ckpt) == jck.verify(ckpt) == []
  assert any(f.startswith("fused_") for f in os.listdir(ckpt))
  assert os.path.isdir(ckpt + ".old")


@pytest.mark.parametrize("world", [1, 2])
def test_micro_batches_train_as_the_one_shot_step(tmp_path, world):
  """``--sparse --micro_batches 2`` against the one-shot run of the same
  seeds: every array of the final checkpoint in the f32 class (rtol
  1e-5, atol 1e-6; only the scatter's and the gradients' addition order
  differ)."""
  dirs = {n: str(tmp_path / f"mb{n}") for n in (1, 2)}
  for n, ckpt in dirs.items():
    out = _run(ARGS + SPARSE + ["--checkpoint_dir", ckpt, "--micro_batches",
                                str(n)], world, tmp_path)
    _finite_lines(out)
  names = sorted(f for f in os.listdir(dirs[1])
                 if f.endswith((".npy", ".npz")))
  assert names == sorted(f for f in os.listdir(dirs[2])
                         if f.endswith((".npy", ".npz")))
  assert any(f.startswith("fused_") for f in names)
  for f in names:
    a, b = (np.load(os.path.join(d, f)) for d in (dirs[1], dirs[2]))
    pairs = ([(f, a, b)] if f.endswith(".npy") else
             [(f"{f}/{k}", a[k], b[k]) for k in a.files])
    for key, x, y in pairs:
      if x.dtype.kind == "f":
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6, err_msg=key)
      else:
        np.testing.assert_array_equal(y, x, err_msg=key)


def test_micro_batches_is_read_on_the_sparse_path_only(twin, capsys):
  # the dense path ignores the flag, as main.py's does (3 divides no batch
  # of 64)
  twin.main(ARGS + ["--micro_batches", "3"])
  _finite_lines(capsys.readouterr().out)
  with pytest.raises(ValueError, match="batch 64 not divisible by "
                     "micro_batches 3"):
    twin.main(ARGS + SPARSE + ["--micro_batches", "3"])


@pytest.fixture(scope="module")
def criteo_dir(tmp_path_factory):
  d = tmp_path_factory.mktemp("criteo")
  tdata.write_dummy_criteo_split(str(d), 512, VOCAB_SCALED, seed=4)
  return str(d)


@pytest.mark.parametrize("world,sparse", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_criteo_dataset_trains(tmp_path, criteo_dir, world, sparse):
  argv = ARGS + ["--vocab_scale", "2e-4", "--dataset", "criteo",
                 "--dataset_path", criteo_dir]
  out = _run(argv + (["--sparse"] if sparse else []), world, tmp_path)
  _finite_lines(out)


def test_world_n_criteo_batches_are_the_global_batch(twin, criteo_dir):
  """At world 2 every rank reads its own half of each global batch: the
  ranks' batches together are the JAX reader's world-1 batch of
  ``--batch_size`` samples. (``main.py`` passes only ``world_size`` to
  its reader, so every rank reads rank 0's half: ROADMAP.md §3.)"""
  args = twin.parse_args(["--dataset", "criteo", "--dataset_path",
                          criteo_dir, "--batch_size", "64"])
  ranks = [twin.make_datasets(args, VOCAB_SCALED, r, 2) for r in range(2)]
  want = jdata.RawBinaryCriteoDataset(
      criteo_dir, 64, numerical_features=13,
      categorical_features=list(range(26)),
      categorical_feature_sizes=VOCAB_SCALED, backend="numpy")
  for split in (0, 1):
    if split:
      want = jdata.RawBinaryCriteoDataset(
          criteo_dir, 64, numerical_features=13,
          categorical_features=list(range(26)),
          categorical_feature_sizes=VOCAB_SCALED, valid=True)
    parts = [list(r[split]) for r in ranks]
    assert len(parts[0]) == len(parts[1]) == len(want) == 512 // 64
    for i, (a, b) in enumerate(zip(*parts)):
      num, cats, labels = want[i]
      np.testing.assert_array_equal(np.concatenate([a[0], b[0]]), num)
      np.testing.assert_array_equal(np.concatenate([a[2], b[2]]), labels)
      for f in range(26):
        np.testing.assert_array_equal(np.concatenate([a[1][f], b[1][f]]),
                                      cats[f])
  # the reference script's reader at world 2 (no rank given): every rank
  # reads rank 0's half, the first 32 samples of each global batch
  jax_rank = jdata.RawBinaryCriteoDataset(
      criteo_dir, 32, numerical_features=13,
      categorical_features=list(range(26)),
      categorical_feature_sizes=VOCAB_SCALED, world_size=2)
  whole = jdata.RawBinaryCriteoDataset(
      criteo_dir, 64, numerical_features=13,
      categorical_features=list(range(26)),
      categorical_feature_sizes=VOCAB_SCALED)
  np.testing.assert_array_equal(jax_rank[1][2], whole[1][2][:32])


JAX_SCRIPT = REPO / "examples" / "dlrm" / "main.py"
CROSS = ["--dataset", "dummy", "--batch_size", "64", "--lr", "0.1",
         "--warmup_steps", "2", "--sparse", "--vocab_scale", "2e-4"]


def test_jax_script_checkpoint_resumes_in_the_twin(tmp_path):
  ckpt = str(tmp_path / "ckpt")
  _run(CROSS + ["--platform", "cpu", "--world_size", "1", "--steps", "2",
                "--checkpoint_dir", ckpt], 1, tmp_path, JAX_SCRIPT)
  out = _run(CROSS + ["--device", "cpu", "--steps", "2", "--checkpoint_dir",
                      ckpt], 1, tmp_path)
  assert f"resumed from {ckpt} at step 2" in out
  from distributed_embeddings_torch import checkpoint as tck
  assert tck.read_manifest(ckpt)["step"] == 4


def test_twin_checkpoint_resumes_in_the_jax_script(tmp_path):
  ckpt = str(tmp_path / "ckpt")
  _run(CROSS + ["--device", "cpu", "--steps", "2", "--checkpoint_dir",
                ckpt], 1, tmp_path)
  out = _run(CROSS + ["--platform", "cpu", "--world_size", "1", "--steps",
                      "2", "--checkpoint_dir", ckpt], 1, tmp_path,
             JAX_SCRIPT)
  assert f"resumed from {ckpt} at step 2" in out
  from distributed_embeddings_tpu import checkpoint as jck
  assert jck.read_manifest(ckpt)["step"] == 4

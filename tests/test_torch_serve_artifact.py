"""The serve artifact on disk, across the two packages, at world 1.

An artifact written by the port's ``serving.export`` loads in the JAX
package's ``serving.load`` and serves the same predictions through the
JAX ``ServeEngine``; an artifact written by the JAX ``export`` loads in
the port. The same train state exported by both packages gives the same
manifest sections and byte-identical serve blocks (their crc32s agree).

Fixtures: the mixed one of ``tests/test_torch_serving.py`` (five tables
of widths 16 and 8, the adagrad rule; one-hot ids, or hotness 3/1/3/2/1
with PAD holes and a few out-of-vocabulary ids; all tables sparse, or
``dense_row_threshold=100``), served through a model stub that returns
the activations: bit-equal, except a multi-hot dense class, whose JAX
one-hot einsum sums the hotness slots in its own order (rtol 1e-6). And
the small DLRM of ``tests/test_torch_dlrm.py``: predictions within the
f32 class (rtol 1e-5, atol 1e-6), the dense parameters bit-equal.

Then the durable protocol: a flipped bit is named by both packages'
``verify``; a crash in the middle of an export leaves the previous
artifact loadable and a ``.tmp`` without a manifest; a load under
another plan is refused naming the same differing keys in both.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import checkpoint as tckpt
from distributed_embeddings_torch.convert import train_state_from_flax
from distributed_embeddings_torch.layers.embedding import (
    TableConfig as TorchTableConfig,
)
from distributed_embeddings_torch.layers.planner import (
    DistEmbeddingStrategy as TorchStrategy,
)
from distributed_embeddings_torch.models import dlrm_embedding_plan as \
    torch_dlrm_embedding_plan
from distributed_embeddings_torch.ops.packed_table import sgd_rule as \
    torch_sgd_rule
from distributed_embeddings_torch.ops.packed_table import (
    sparse_rule as torch_sparse_rule,
)
from distributed_embeddings_torch.resilience import faultinject as tfi
from distributed_embeddings_torch.serving import ServeEngine as TorchEngine
from distributed_embeddings_torch.serving import export as torch_export
from distributed_embeddings_torch.serving import load as torch_load
from distributed_embeddings_tpu import checkpoint as jckpt
from distributed_embeddings_tpu import serving as jserving
from distributed_embeddings_tpu.layers.dist_model_parallel import set_weights
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models.dlrm import dlrm_embedding_plan
from distributed_embeddings_tpu.ops.packed_table import sgd_rule, sparse_rule
from distributed_embeddings_tpu.parallel.lookup_engine import PAD_ID
from distributed_embeddings_tpu.training import (
    init_sparse_state,
    init_sparse_state_direct,
)
from test_torch_dlrm import D, F32_TOL, NUM, VOCAB, flax_params, jax_dlrm, \
    torch_dlrm
from test_torch_serving import TorchActsModel

SIZES = [131, 97, 53, 40, 67]
WIDTHS = [16, 16, 8, 8, 16]
MULTI_HOT = [3, 1, 3, 2, 1]
B = 16


class ActsModel:
  """JAX model stub returning the concatenated embedding activations."""

  def apply(self, variables, numerical, cats, emb_acts=None):
    del variables, numerical, cats
    return jnp.concatenate(list(emb_acts), axis=-1)


def _mixed(combiner, dense_thr, hotness, step=7):
  """The JAX and port plans, the JAX train state (numpy leaves) and a
  request."""
  rng = np.random.default_rng(0)
  kw = dict(dense_row_threshold=dense_thr, input_hotness=hotness)
  plan = DistEmbeddingStrategy(
      [TableConfig(s, w, combiner=combiner) for s, w in zip(SIZES, WIDTHS)],
      1, "memory_balanced", **kw)
  tplan = TorchStrategy(
      [TorchTableConfig(s, w, combiner=combiner)
       for s, w in zip(SIZES, WIDTHS)], 1, "memory_balanced", **kw)
  weights = [rng.standard_normal((s, w)).astype(np.float32)
             for s, w in zip(SIZES, WIDTHS)]
  params = {"embeddings": {k: jnp.asarray(v)
                           for k, v in set_weights(plan, weights).items()}}
  state = init_sparse_state(plan, params, sparse_rule("adagrad", 0.05),
                            optax.sgd(0.01))
  state = {"fused": state["fused"], "emb_dense": state["emb_dense"],
           "dense": {}, "step": step}
  state = {k: jax.tree_util.tree_map(np.asarray, v)
           for k, v in state.items()}
  ids = []
  for s, h in zip(SIZES, hotness):
    x = rng.integers(0, s + 3, (B, h)).astype(np.int32)  # a few OOV ids
    if h > 1:
      x[rng.random(x.shape) < 0.25] = PAD_ID
    ids.append(x)
  numerical = rng.standard_normal((B, 4)).astype(np.float32)
  return plan, tplan, state, numerical, ids


def _serve_crcs(path):
  return {f: v for f, v in tckpt.read_manifest(path)["checksums"].items()
          if f.startswith("serve_")}


def _assert_acts(got, want, dense_thr, hotness):
  """Bit-equal activations, but a multi-hot dense class (rtol 1e-6)."""
  assert got.shape == want.shape == (B, sum(WIDTHS))
  off = 0
  for t, w in enumerate(WIDTHS):
    g, e = got[:, off:off + w], want[:, off:off + w]
    if SIZES[t] <= dense_thr and hotness[t] > 1:
      np.testing.assert_allclose(g, e, rtol=1e-6, atol=0)
    else:
      np.testing.assert_array_equal(g.view(np.int32), e.view(np.int32))
    off += w


@pytest.mark.parametrize("hot", ["one_hot", "multi_hot"])
@pytest.mark.parametrize("dense_thr", [0, 100])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("quantize", ["f32", "int8"])
def test_artifact_crosses_both_ways(tmp_path, quantize, combiner, dense_thr,
                                    hot):
  hotness = MULTI_HOT if hot == "multi_hot" else [1] * len(SIZES)
  plan, tplan, state, numerical, ids = _mixed(combiner, dense_thr, hotness)
  rule, trule = sparse_rule("adagrad", 0.05), torch_sparse_rule("adagrad",
                                                                0.05)
  port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
  torch_export(port_dir, tplan, trule, train_state_from_flax(state, "cpu"),
               quantize=quantize, extra={"by": "port"})
  jserving.export(jax_dir, plan, rule, state, quantize=quantize,
                  extra={"by": "jax"})
  assert jckpt.verify(port_dir) == [] and tckpt.verify(jax_dir) == []

  # the manifests agree but for the checksums of the npz archives
  pm, jm = tckpt.read_manifest(port_dir), tckpt.read_manifest(jax_dir)
  for key in ("format_version", "kind", "step", "rule", "plan", "serve"):
    assert pm[key] == jm[key], key
  assert set(pm["checksums"]) == set(jm["checksums"])
  assert _serve_crcs(port_dir) == _serve_crcs(jax_dir)
  assert pm["extra"] == {"by": "port"}

  # the port's artifact served by the JAX engine, the JAX one by the port
  jart = jserving.load(port_dir, plan)
  want = np.asarray(jserving.ServeEngine(ActsModel(), plan, jart)
                    .predict(numerical, tuple(ids)))
  tart = torch_load(jax_dir, tplan, device="cpu")
  assert tart.step == jart.step == 7 and tart.quantize == quantize
  got = TorchEngine(TorchActsModel(), tplan, tart, device="cpu").predict(
      numerical, ids)
  _assert_acts(got, want, dense_thr, hotness)
  mine = TorchEngine(TorchActsModel(), tplan,
                     torch_load(port_dir, tplan, device="cpu"),
                     device="cpu").predict(numerical, ids)
  np.testing.assert_array_equal(mine, got)
  for name in tart.meta:
    np.testing.assert_array_equal(tart.rank_block(name, 0),
                                  jart.rank_block(name, 0))


@pytest.fixture(scope="module")
def dlrm_state():
  plan = dlrm_embedding_plan(VOCAB, D, dense_row_threshold=64)
  state = init_sparse_state_direct(plan, sgd_rule(0.1), flax_params(),
                                   optax.sgd(0.1), jax.random.PRNGKey(3))
  state = {k: jax.tree_util.tree_map(np.asarray, state[k])
           for k in ("fused", "emb_dense", "dense", "step")}
  rng = np.random.default_rng(4)
  numerical = rng.standard_normal((B, NUM)).astype(np.float32)
  cats = [rng.integers(0, v, (B,)).astype(np.int32) for v in VOCAB]
  return plan, state, numerical, cats


@pytest.mark.parametrize("quantize", ["f32", "int8"])
def test_dlrm_artifact_predictions_cross(tmp_path, dlrm_state, quantize):
  """The model's parameters ride the artifact as the flax tree: the
  port's ``dense.npz`` equals the JAX package's key for key and bit for
  bit, and each package's engine on the other's artifact predicts what
  its own does (the f32 class between the packages)."""
  plan, state, numerical, cats = dlrm_state
  tplan = torch_dlrm_embedding_plan(VOCAB, D, dense_row_threshold=64)
  port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
  torch_export(port_dir, tplan, torch_sgd_rule(0.1),
               train_state_from_flax(state, "cpu"), quantize=quantize)
  jserving.export(jax_dir, plan, sgd_rule(0.1), state, quantize=quantize)
  for part in ("dense", "emb_dense"):
    with np.load(os.path.join(port_dir, f"{part}.npz")) as p, \
        np.load(os.path.join(jax_dir, f"{part}.npz")) as j:
      assert sorted(p.files) == sorted(j.files) and p.files
      for k in p.files:
        assert p[k].dtype == j[k].dtype == np.float32, k
        np.testing.assert_array_equal(p[k], j[k])

  want = np.asarray(jserving.ServeEngine(
      jax_dlrm(jnp.float32), plan, jserving.load(port_dir, plan))
      .predict(numerical, tuple(cats)))
  # the model's own weights are overwritten by the artifact's
  mine = TorchEngine(torch_dlrm(flax_params(seed=9), torch.float32), tplan,
                     torch_load(port_dir, tplan, device="cpu"),
                     device="cpu").predict(numerical, cats)
  got = TorchEngine(torch_dlrm(flax_params(seed=9), torch.float32), tplan,
                    torch_load(jax_dir, tplan, device="cpu"),
                    device="cpu").predict(numerical, cats)
  assert got.shape == want.shape == (B,) and np.all(np.isfinite(got))
  np.testing.assert_allclose(got, want, **F32_TOL)
  np.testing.assert_array_equal(got, mine)


def _small(tmp_path, name="art", step=7, quantize="f32"):
  plan, tplan, state, numerical, ids = _mixed("sum", 0, MULTI_HOT, step)
  path = str(tmp_path / name)
  torch_export(path, tplan, torch_sparse_rule("adagrad", 0.05),
               train_state_from_flax(state, "cpu"), quantize=quantize)
  return plan, tplan, state, path


@pytest.mark.parametrize("target", ["serve", "npz", "manifest"])
def test_bitflip_named_by_both_verifies(tmp_path, target):
  plan, tplan, _, path = _small(tmp_path)
  files = sorted(os.listdir(path))
  if target == "serve":
    fname = next(f for f in files if f.startswith("serve_"))
  elif target == "npz":
    fname = "emb_dense.npz"
  else:
    fname = "manifest.json"
  if target == "manifest":
    # a flipped bit in the table itself: the recorded size of a block
    mpath = os.path.join(path, fname)
    with open(mpath) as f:
      manifest = json.load(f)
    fname = next(f for f in files if f.startswith("serve_"))
    manifest["checksums"][fname]["size"] ^= 1
    with open(mpath, "w") as f:
      json.dump(manifest, f)
  else:
    tfi.bitflip_file(os.path.join(path, fname))
  got, want = tckpt.verify(path), jckpt.verify(path)
  assert got == want and len(got) == 1 and fname in got[0]
  with pytest.raises(ValueError, match=re.escape(fname)):
    torch_load(path, tplan, device="cpu")
  with pytest.raises(ValueError, match=re.escape(fname)):
    jserving.load(path, plan)


@pytest.mark.parametrize("site,k", [("ckpt_write", 0), ("ckpt_write", 2),
                                    ("ckpt_write", 3), ("ckpt_rename", 0)])
def test_crash_mid_export_keeps_previous_artifact(tmp_path, site, k):
  plan, tplan, state, path = _small(tmp_path, step=7)
  state = dict(state, step=8)
  with tfi.injected(tfi.FaultInjector().crash_after(site, k)):
    with pytest.raises(tfi.InjectedCrash):
      torch_export(path, tplan, torch_sparse_rule("adagrad", 0.05),
                   train_state_from_flax(state, "cpu"))
  assert not os.path.exists(os.path.join(path + ".tmp", "manifest.json")) \
      or site == "ckpt_rename"
  assert os.path.isdir(path + ".tmp")
  assert tckpt.verify(path) == [] and jckpt.verify(path) == []
  assert torch_load(path, tplan, device="cpu").step == 7
  assert jserving.load(path, plan).step == 7
  # the next export replaces the stale .tmp and publishes; the old one
  # rotates to .old
  torch_export(path, tplan, torch_sparse_rule("adagrad", 0.05),
               train_state_from_flax(state, "cpu"))
  assert not os.path.exists(path + ".tmp")
  assert torch_load(path, tplan, device="cpu").step == 8
  assert jserving.load(path + ".old", plan).step == 7


def _differing(exc) -> str:
  return re.search(r"differs in (\[[^\]]*\])", str(exc.value)).group(1)


@pytest.mark.parametrize("change", ["threshold", "table"])
def test_plan_mismatch_refused_with_the_same_keys(tmp_path, change):
  _, _, _, path = _small(tmp_path)
  sizes = list(SIZES)
  thr = 0
  if change == "threshold":
    thr = 60
  else:
    sizes[2] += 1
  plan = DistEmbeddingStrategy(
      [TableConfig(s, w, combiner="sum") for s, w in zip(sizes, WIDTHS)],
      1, "memory_balanced", dense_row_threshold=thr, input_hotness=MULTI_HOT)
  tplan = TorchStrategy(
      [TorchTableConfig(s, w, combiner="sum") for s, w in zip(sizes, WIDTHS)],
      1, "memory_balanced", dense_row_threshold=thr, input_hotness=MULTI_HOT)
  with pytest.raises(ValueError, match="does not match") as got:
    torch_load(path, tplan, device="cpu")
  with pytest.raises(ValueError, match="does not match") as want:
    jserving.load(path, plan)
  assert _differing(got) == _differing(want) != "[]"


def test_unported_options_are_refused(tmp_path):
  plan, tplan, state, path = _small(tmp_path)
  tstate = train_state_from_flax(state, "cpu")
  trule = torch_sparse_rule("adagrad", 0.05)
  for kw, item in ((dict(store=object()), "item 8"),
                   (dict(vocab=object()), "item 12")):
    with pytest.raises(NotImplementedError, match=item):
      torch_export(str(tmp_path / "x"), tplan, trule, tstate, **kw)
  with pytest.raises(NotImplementedError, match="item 12"):
    torch_load(path, tplan, owned_ranks=(0,), device="cpu")


def test_zoo_artifact_holds_the_flax_mlp_tree(tmp_path):
  """A synthetic-zoo model exports too: ``dense.npz`` holds its flax
  tree (``mlp/dense_i/{kernel, bias}``) as the JAX package writes it from
  the same state, the JAX ``verify`` accepts the artifact, and the loaded
  state_dict fits a ``SyntheticModel``."""
  from distributed_embeddings_torch import train_golden as tg
  from distributed_embeddings_torch.convert import (
      dense_state_dict_from_flax,
      dense_state_dict_to_flax,
      zoo_train_state_from_flax,
  )
  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      SyntheticModel,
  )
  from distributed_embeddings_torch.ops.packed_table import adagrad_rule

  plan = tg.zoo_plan()
  rule = adagrad_rule(tg.ZOO_LR)
  initial = tg.zoo_initial_state(plan, rule)
  state = zoo_train_state_from_flax(initial, device="cpu")
  path = str(tmp_path / "zoo")
  torch_export(path, plan, rule, state, quantize="int8")
  assert jckpt.verify(path) == []
  with np.load(os.path.join(path, "dense.npz")) as z:
    got = dict(z)
  want = jckpt._flatten_with_paths(initial["dense"])
  assert sorted(got) == sorted(want) and all(
      k.startswith("mlp/dense_") for k in got)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  art = torch_load(path, plan, device="cpu")
  model = SyntheticModel(SYNTHETIC_MODELS[tg.ZOO_MODEL], tables=False,
                         device="cpu")
  model.load_state_dict(art.state["dense"])
  roundtrip = dense_state_dict_from_flax(dense_state_dict_to_flax(
      model.state_dict()))
  assert roundtrip.keys() == model.state_dict().keys()
  for k, v in model.state_dict().items():
    assert torch.equal(roundtrip[k], v), k

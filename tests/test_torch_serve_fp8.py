"""fp8 serve images in the port against the JAX package's, world 1.

The JAX package's ``quantize="fp8"`` scales each row onto the e4m3 grid
(``scale = max|row| / 448``), casts it to ``float8_e4m3fn`` and keeps the
f32 scale's bytes in 4 trailing lanes; it writes the image viewed as
int8. The port holds the image as those bytes (int8 storage) and views
only the value lanes as ``torch.float8_e4m3fn``. Here:

- the codec's bytes equal to JAX's on rows with zeros, values that land
  on e4m3 subnormals and row magnitudes from 2^-14 to 2^10, and the
  dequantized rows bit-equal;
- the JAX error bounds (``tests/test_serving.py``:
  ``test_fp8_roundtrip_error_bound``, ``test_fp8_serve_error_bound``):
  per element ``2^-4 * max|row|``, a sum-combined bag ``h`` times that,
  held here against the f32 serve (which is the eval step's activations,
  ``tests/test_torch_serving.py``);
- artifacts both ways: the manifests and the serve blocks' checksums
  equal, each package's engine on the other's artifact giving bit-equal
  activations, a frozen JAX image carried by ``convert``;
- the ``MicroBatcher`` in front of an fp8 engine: every request's rows
  bit-equal to ``predict`` of them alone.

World 4: ``tests/test_torch_narrow_world4.py``.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.convert import (
    serve_state_from_frozen,
    train_state_from_flax,
)
from distributed_embeddings_torch.ops.packed_table import (
    sparse_rule as torch_sparse_rule,
)
from distributed_embeddings_torch.serving import MicroBatcher
from distributed_embeddings_torch.serving import ServeEngine as TorchEngine
from distributed_embeddings_torch.serving import export as torch_export
from distributed_embeddings_torch.serving import load as torch_load
from distributed_embeddings_torch.serving.export import (
    dequantize_rows_fp8 as torch_dequantize_rows_fp8,
)
from distributed_embeddings_torch.serving.export import (
    quantize_rows_fp8 as torch_quantize_rows_fp8,
)
from distributed_embeddings_tpu import checkpoint as jckpt
from distributed_embeddings_tpu import serving as jserving
from distributed_embeddings_tpu.ops.packed_table import sparse_rule
from distributed_embeddings_tpu.serving.export import (
    dequantize_rows_fp8,
    freeze,
    quantize_rows_fp8,
)

from test_torch_serve_artifact import (
    MULTI_HOT,
    SIZES,
    WIDTHS,
    ActsModel,
    _assert_acts,
    _mixed,
    _serve_crcs,
)
from test_torch_serving import TorchActsModel

RULE = ("adagrad", 0.05)


def _codec_table() -> np.ndarray:
  """Rows of magnitudes 2^-14 .. 2^10, each with elements from its amax
  down to 2^-20 of it (below 2^-9 of the amax an element lands on an
  e4m3 subnormal or on zero), signs mixed, one all-zero row and rows
  with zero lanes."""
  rng = np.random.default_rng(3)
  rows = []
  for e in range(-14, 11):
    for _ in range(4):
      ratio = np.exp2(rng.uniform(-20.0, 0.0, 32)).astype(np.float32)
      ratio[0] = 1.0
      sign = np.where(rng.random(32) < 0.5, -1.0, 1.0).astype(np.float32)
      row = (np.float32(2.0 ** e) * ratio * sign).astype(np.float32)
      row[rng.random(32) < 0.1] = 0.0
      row[0] = np.float32(2.0 ** e) * sign[0]
      rows.append(row)
  rows.append(np.zeros(32, np.float32))
  return np.stack(rows)


def test_fp8_codec_bytes_equal_jax():
  table = _codec_table()
  want = quantize_rows_fp8(table)
  got = torch_quantize_rows_fp8(torch.tensor(table))
  assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
  np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                want.view(np.uint8))
  # some values really are e4m3 subnormals (exponent bits 0, mantissa
  # not), and every row's amax sits on 448 (0x7e, with its sign)
  vals = want[:, :-4].view(np.uint8)
  assert np.any(((vals & 0x78) == 0) & ((vals & 0x07) != 0))
  assert np.all((np.abs(want[:-1, 0].astype(np.float32)) == 448.0))
  deq = torch_dequantize_rows_fp8(got).numpy()
  np.testing.assert_array_equal(deq.view(np.int32),
                                dequantize_rows_fp8(want).view(np.int32))
  # uint8 bytes read the same
  np.testing.assert_array_equal(
      torch_dequantize_rows_fp8(got.view(torch.uint8)).numpy(), deq)


def test_fp8_roundtrip_error_bound():
  """``tests/test_serving.py::test_fp8_roundtrip_error_bound`` on the
  port's codec."""
  rng = np.random.default_rng(2)
  table = rng.standard_normal((200, 16)).astype(np.float32) * \
      rng.uniform(0.01, 10.0, (200, 1)).astype(np.float32)
  table[7] = 0.0
  q = torch_quantize_rows_fp8(torch.tensor(table))
  assert q.dtype == torch.int8 and tuple(q.shape) == (200, 20)
  np.testing.assert_array_equal(q.numpy().view(ml_dtypes.float8_e4m3fn),
                                quantize_rows_fp8(table))
  deq = torch_dequantize_rows_fp8(q).numpy()
  amax = np.abs(table).max(axis=1, keepdims=True)
  assert np.all(np.abs(deq - table) <= amax * 2.0 ** -4 + 1e-12)
  np.testing.assert_array_equal(deq[7], 0.0)


def _engine(tplan, state, quantize, tmp_path, name):
  path = str(tmp_path / name)
  torch_export(path, tplan, torch_sparse_rule(*RULE),
               train_state_from_flax(state, "cpu"), quantize=quantize)
  return TorchEngine(TorchActsModel(), tplan,
                     torch_load(path, tplan, device="cpu"), device="cpu")


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_fp8_serve_error_bound(tmp_path, combiner):
  """``tests/test_serving.py::test_fp8_serve_error_bound``'s bound: per
  table, ``rows * 2^-4 * max|table| + 1e-6`` (``rows`` the hotness for
  ``sum``, 1 for ``mean``), against the f32 serve's activations."""
  plan, tplan, state, numerical, ids = _mixed(combiner, 0, MULTI_HOT)
  want = _engine(tplan, state, "f32", tmp_path, "f32").predict(numerical,
                                                               ids)
  got = _engine(tplan, state, "fp8", tmp_path, "fp8").predict(numerical,
                                                              ids)
  rng = np.random.default_rng(0)
  weights = [rng.standard_normal((s, w)).astype(np.float32)
             for s, w in zip(SIZES, WIDTHS)]  # _mixed's tables
  off = 0
  for t, (w, h) in enumerate(zip(weights, MULTI_HOT)):
    width = w.shape[1]
    rows = h if combiner == "sum" else 1
    bound = rows * (2.0 ** -4) * np.abs(w).max() + 1e-6
    err = np.abs(got[:, off:off + width] - want[:, off:off + width]).max()
    assert err <= bound, (t, err, bound)
    off += width
  assert np.abs(want - got).max() > 0


@pytest.mark.parametrize("combiner,dense_thr,hot", [
    ("sum", 0, "multi_hot"), ("mean", 100, "one_hot"),
    ("sum", 100, "multi_hot")])
def test_fp8_artifact_crosses_both_ways(tmp_path, combiner, dense_thr, hot):
  hotness = MULTI_HOT if hot == "multi_hot" else [1] * len(SIZES)
  plan, tplan, state, numerical, ids = _mixed(combiner, dense_thr, hotness)
  port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
  torch_export(port_dir, tplan, torch_sparse_rule(*RULE),
               train_state_from_flax(state, "cpu"), quantize="fp8")
  jserving.export(jax_dir, plan, sparse_rule(*RULE), state, quantize="fp8")
  assert jckpt.verify(port_dir) == []
  pm, jm = jckpt.read_manifest(port_dir), jckpt.read_manifest(jax_dir)
  for key in ("format_version", "kind", "step", "rule", "plan", "serve"):
    assert pm[key] == jm[key], key
  assert {c["dtype"] for c in pm["serve"]["classes"].values()} == \
      {"float8_e4m3fn"}
  assert _serve_crcs(port_dir) == _serve_crcs(jax_dir)

  jart = jserving.load(port_dir, plan)
  want = np.asarray(jserving.ServeEngine(ActsModel(), plan, jart)
                    .predict(numerical, tuple(ids)))
  tart = torch_load(jax_dir, tplan, device="cpu")
  assert tart.quantize == "fp8"
  got = TorchEngine(TorchActsModel(), tplan, tart, device="cpu").predict(
      numerical, ids)
  _assert_acts(got, want, dense_thr, hotness)
  mine = TorchEngine(TorchActsModel(), tplan,
                     torch_load(port_dir, tplan, device="cpu"),
                     device="cpu").predict(numerical, ids)
  np.testing.assert_array_equal(mine, got)
  for name in tart.meta:
    assert tart.state["serve"][name].dtype == torch.int8
    np.testing.assert_array_equal(
        tart.rank_block(name, 0).view(np.uint8),
        np.asarray(jart.rank_block(name, 0)).view(np.uint8))


def test_frozen_jax_fp8_image_carries_across():
  plan, tplan, state, numerical, ids = _mixed("sum", 0, MULTI_HOT)
  jfrozen = freeze(plan, sparse_rule(*RULE),
                   jax.tree_util.tree_map(np.asarray, state),
                   quantize="fp8")
  tfrozen = serve_state_from_frozen(jfrozen)
  for name, blocks in jfrozen.device_blocks.items():
    got = tfrozen.device_blocks[name][0]
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                  np.asarray(blocks[0]).view(np.uint8))
  eng = TorchEngine(TorchActsModel(), tplan, tfrozen, device="cpu")
  want = np.asarray(jserving.ServeEngine(ActsModel(), plan, jfrozen)
                    .predict(numerical, tuple(ids)))
  _assert_acts(eng.predict(numerical, ids), want, 0, MULTI_HOT)


@pytest.mark.parametrize("threads", [False, True])
def test_batcher_over_an_fp8_engine(tmp_path, threads):
  _, tplan, state, numerical, ids = _mixed("sum", 100, MULTI_HOT)
  eng = _engine(tplan, state, "fp8", tmp_path, "fp8")
  mb = MicroBatcher(eng.dispatch, max_batch=8, max_delay_s=0.002,
                    start=threads)
  cuts = [0, 3, 4, 11, 16]
  futs = [mb.submit(numerical[a:b], [x[a:b] for x in ids])
          for a, b in zip(cuts, cuts[1:])]
  if not threads:
    assert mb.flush_now() == 3
  for (a, b), fut in zip(zip(cuts, cuts[1:]), futs):
    want = eng.predict(numerical[a:b], [x[a:b] for x in ids])
    got = fut.result(timeout=30)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
  mb.close()
  assert mb.stats["completed"] == 4 and mb.stats["rejected"] == 0

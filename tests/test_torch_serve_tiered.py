"""Tiered serving in the port against the JAX package's, world 1, on
``tests/test_serving.py``'s tiered cell (``tests/torch_serve_tiered_
cases.py``: vocabularies ``[5000, 300, 40]``, width 16, the 5,000-row
table host-tier, Adagrad 0.05, observed counts from classifying
power-law batches).

- **Freeze.** ``freeze(store=)`` strips the cold images, turns the counts
  into the serve ranking and re-bins them per serve physical row byte for
  byte as the JAX ``freeze`` does, for f32, int8 and fp8 (the serve
  layouts pack 8 and 6 rows a physical row where training packs 4).
- **Engine.** The port's tiered ``ServeEngine`` gives activations
  bit-equal to the JAX tiered engine's, predictions within rtol 1e-5 /
  atol 1e-6 and the same ``[hot, staged, missed, valid]`` counters
  (``missed == 0``, ``hot + staged == valid``); a dispatch whose cold rows
  spill past the staging region and a repeated dispatch give the same
  answers. Its f32 predictions are bit-equal to the port's all-device
  eval step, and its int8 and fp8 ones to the all-device int8 and fp8
  engines (``test_tiered_serve_vs_all_device_eval``'s oracle).
- **Artifacts both ways** (``test_export_load_roundtrip_tiered``): the
  JAX ``verify`` and ``load`` accept the port's tiered artifact with
  byte-equal cold images, rankings and counts, and the port loads and
  serves the JAX package's; ``convert`` carries a JAX tiered
  ``FrozenTables`` across.
- **Tier plan.** ``ServeTierPlan`` geometry equal to the JAX plan's under
  its clamps, and its refusal with the JAX message.

World 4: ``tests/test_torch_serve_tiered_world4.py``.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import torch_serve_tiered_cases as S
import torch_tiering_cases as C
from distributed_embeddings_torch import checkpoint as tckpt
from distributed_embeddings_torch import serving as ts
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    serve_state_from_frozen,
    train_state_from_flax,
)
from distributed_embeddings_tpu import checkpoint as jckpt
from distributed_embeddings_tpu import serving as js
from distributed_embeddings_tpu.serving import engine as jengine
from distributed_embeddings_tpu.serving.export import freeze as jfreeze

from test_torch_serving import TorchActsModel


@functools.lru_cache(maxsize=None)
def _jax():
  return S.jax_case(1)


@functools.lru_cache(maxsize=None)
def _jax_frozen(q):
  case = _jax()
  return jfreeze(case["plan_t"], case["rule"], case["state_t"], quantize=q,
                 store=case["store"])


@functools.lru_cache(maxsize=None)
def _jax_answers(q, cfg="serve"):
  """The JAX tiered engine's ``(preds, metrics, acts)`` per request and
  its spill dispatches."""
  case = _jax()
  tc = js.ServeTierConfig(**(S.SERVE_CFG if cfg == "serve" else S.SPILL_CFG))
  frozen = _jax_frozen(q)
  eng = js.ServeEngine(case["model"], case["plan_t"], frozen,
                       tier_config=tc, with_metrics=True)
  acts = js.ServeEngine(S.JaxActs(), case["plan_t"], frozen, tier_config=tc)
  out = []
  for seed in S.REQUESTS:
    preds, m = eng.predict(*S.request(seed))
    out.append((preds, {k: np.asarray(v) for k, v in m["tier"].items()},
                np.asarray(acts.predict(*S.request(seed)))))
  return out, eng.prefetcher.spill_steps


def _port():
  """The port's tiered plan, rule, train state and store from the JAX
  case's arrays (fresh, so a flush never touches another test's)."""
  case = _jax()
  _, plan_t = S.torch_plans(1)
  rule, tplan = S.torch_tplan(plan_t)
  store = S.port_store(tplan, S.store_arrays(case["store"]))
  state = train_state_from_flax(S.numpy_state(case["state_t"]), "cpu")
  return plan_t, rule, state, store


def _engine(plan, frozen, cfg=S.SERVE_CFG, acts=False, **kw):
  if acts:
    return ts.ServeEngine(TorchActsModel(), plan,
                          dataclasses.replace(frozen, dense={}),
                          device="cpu", tier_config=ts.ServeTierConfig(**cfg),
                          **kw)
  return ts.ServeEngine(C.torch_model(), plan, frozen, device="cpu",
                        tier_config=ts.ServeTierConfig(**cfg), **kw)


def _bits(a):
  return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("q", S.QUANTIZE)
def test_freeze_matches_jax(q):
  plan_t, rule, state, store = _port()
  got = ts.freeze(plan_t, rule, state, quantize=q, store=store)
  want = _jax_frozen(q)
  assert {n: m.tier for n, m in got.meta.items()} == {
      n: m.tier for n, m in want.meta.items()}
  assert sorted(got.host_images) == sorted(want.host_images) != []
  for name in want.host_images:
    assert got.meta[name].tier == "host"
    np.testing.assert_array_equal(S.bytes_of(got.host_images[name][0]),
                                  S.bytes_of(want.host_images[name][0]))
    np.testing.assert_array_equal(got.ranking[name][0],
                                  want.ranking[name][0])
    assert got.ranking[name][0].dtype == want.ranking[name][0].dtype
    np.testing.assert_array_equal(got.counts[name][0], want.counts[name][0])
    # the counts came from traffic: the ranking is not the default order
    assert not np.array_equal(got.ranking[name][0],
                              np.arange(got.ranking[name][0].shape[0]))
  assert sorted(got.device_blocks) == sorted(want.device_blocks)
  for name, blocks in want.device_blocks.items():
    np.testing.assert_array_equal(S.bytes_of(got.device_blocks[name][0]),
                                  S.bytes_of(blocks[0]))


@pytest.mark.parametrize("q", S.QUANTIZE)
def test_tiered_engine_matches_jax(q):
  plan_t, rule, state, store = _port()
  frozen = ts.freeze(plan_t, rule, state, quantize=q, store=store)
  eng = _engine(plan_t, frozen, with_metrics=True)
  acts = _engine(plan_t, frozen, acts=True)
  spill = _engine(plan_t, frozen, cfg=S.SPILL_CFG, acts=True,
                  with_metrics=True)
  want, _ = _jax_answers(q)
  spill_want, spill_steps = _jax_answers(q, "spill")
  for (want_p, want_m, want_a), (_, spill_m, _), seed in zip(
      want, spill_want, S.REQUESTS):
    req = S.request(seed)
    preds, m = eng.predict(*req)
    np.testing.assert_allclose(preds, want_p, **S.PRED_TOL)
    a = acts.predict(*req)
    np.testing.assert_array_equal(_bits(a), _bits(want_a))
    assert sorted(m["tier"]) == sorted(want_m)
    for name, counters in m["tier"].items():
      np.testing.assert_array_equal(counters, want_m[name])
      hot, staged, missed, valid = (int(v) for v in counters)
      assert missed == 0 and hot + staged == valid > 0 and staged > 0
    # repeated dispatch: immutable images, persistent residency
    np.testing.assert_array_equal(_bits(eng.predict(*req)[0]), _bits(preds))
    # two staging rows: a dispatch of more cold rows spills into a larger
    # bucket (an extended copy of the compact buffer)
    a_spill, m_spill = spill.predict(*req)
    np.testing.assert_array_equal(_bits(a_spill), _bits(want_a))
    for name, counters in m_spill["tier"].items():
      np.testing.assert_array_equal(counters, spill_m[name])
      assert int(counters[2]) == 0
  assert spill.prefetcher.spill_steps == spill_steps >= 1
  assert eng.prefetcher.spill_steps == 0


@pytest.mark.parametrize("q", S.QUANTIZE)
def test_tiered_serve_vs_all_device_eval(q):
  """The port's tiered engine against the port's all-device path on the
  same tables (the untiered plan's state): f32 bit-equal to the eval
  step; every mode bit-equal to the all-device engine of its image."""
  plan_b, _ = S.torch_plans(1)
  plan_t, rule, state, store = _port()
  state_b = train_state_from_flax(S.numpy_state(_jax()["state_b"]), "cpu")
  tiered = _engine(plan_t, ts.freeze(plan_t, rule, state, quantize=q,
                                     store=store))
  flat = ts.ServeEngine(C.torch_model(), plan_b,
                        ts.freeze(plan_b, rule, state_b, quantize=q),
                        device="cpu")
  ev = ttr.make_sparse_eval_step(C.torch_model(), plan_b, rule)
  for seed in S.REQUESTS:
    numerical, cats = S.request(seed)
    got = tiered.predict(numerical, cats)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(flat.predict(numerical, cats)))
    with torch.inference_mode():
      want = ev(state_b, *ttr.shard_batch((numerical, cats),
                                          device="cpu")).numpy()
    if q == "f32":
      np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
      # the JAX oracle's int8 bound; fp8's per-element error bound is 8x
      # int8's (2^-4 against 2^-7 of a row's largest magnitude)
      assert np.abs(got - want).max() < {"int8": 1e-3, "fp8": 8e-3}[q]


@pytest.mark.parametrize("q", S.QUANTIZE)
def test_export_load_roundtrip_tiered(tmp_path, q):
  case = _jax()
  plan_t, rule, state, store = _port()
  path = str(tmp_path / "port")
  frozen = ts.export(path, plan_t, rule, state, quantize=q, store=store)
  assert frozen.host_images and jckpt.verify(path) == []
  assert tckpt.verify(path) == []
  cold = sorted(f for f in os.listdir(path) if f.startswith("serve_cold_"))
  assert cold == [f"serve_cold_{n}_r0.npy" for n in sorted(
      frozen.host_images)]
  # the JAX package loads the port's artifact, byte for byte
  art_j = js.load(path, case["plan_t"])
  want = _jax_frozen(q)
  for name in want.host_images:
    np.testing.assert_array_equal(S.bytes_of(art_j.host_images[name][0]),
                                  S.bytes_of(want.host_images[name][0]))
    np.testing.assert_array_equal(art_j.ranking[name][0],
                                  want.ranking[name][0])
    np.testing.assert_array_equal(art_j.counts[name][0],
                                  want.counts[name][0])
  tc = js.ServeTierConfig(**S.SERVE_CFG)
  eng_j = js.ServeEngine(case["model"], case["plan_t"], art_j,
                         tier_config=tc)
  for (want_p, _, _), seed in zip(_jax_answers(q)[0], S.REQUESTS):
    np.testing.assert_array_equal(
        _bits(eng_j.predict(*S.request(seed))), _bits(want_p))
  # the port loads its own artifact and the JAX package's
  jpath = str(tmp_path / "jax")
  js.export(jpath, case["plan_t"], case["rule"], case["state_t"],
            quantize=q, store=case["store"])
  ref = _engine(plan_t, frozen)
  for p in (path, jpath):
    art = ts.load(p, plan_t, device="cpu")
    for name in frozen.host_images:
      assert art.meta[name].tier == "host"
      np.testing.assert_array_equal(S.bytes_of(art.rank_block(name, 0)),
                                    S.bytes_of(frozen.host_images[name][0]))
      np.testing.assert_array_equal(art.ranking[name][0],
                                    frozen.ranking[name][0])
      np.testing.assert_array_equal(art.counts[name][0],
                                    frozen.counts[name][0])
    eng = _engine(plan_t, art)
    for seed in S.REQUESTS:
      np.testing.assert_array_equal(_bits(eng.predict(*S.request(seed))),
                                    _bits(ref.predict(*S.request(seed))))


@pytest.mark.parametrize("q", S.QUANTIZE)
def test_convert_carries_tiered_frozen(q):
  plan_t, rule, state, store = _port()
  mine = ts.freeze(plan_t, rule, state, quantize=q, store=store)
  carried = serve_state_from_frozen(_jax_frozen(q))
  for name in mine.host_images:
    assert carried.host_images[name][0].dtype == mine.host_images[
        name][0].dtype
    np.testing.assert_array_equal(carried.host_images[name][0],
                                  mine.host_images[name][0])
    np.testing.assert_array_equal(carried.ranking[name][0],
                                  mine.ranking[name][0])
    np.testing.assert_array_equal(carried.counts[name][0],
                                  mine.counts[name][0])
  got, want = _engine(plan_t, carried), _engine(plan_t, mine)
  for seed in S.REQUESTS:
    np.testing.assert_array_equal(_bits(got.predict(*S.request(seed))),
                                  _bits(want.predict(*S.request(seed))))


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("cfg", [
    {}, S.SERVE_CFG, dict(cache_fraction=0.9, staging_grps=1),
    dict(cache_fraction=0.05, staging_grps=1 << 20),
    dict(cache_fraction=1.0, staging_grps=64, spill_factor_max=2)])
@pytest.mark.parametrize("q", ["f32", "int8"])
def test_serve_tier_plan_matches_jax(world, cfg, q):
  from distributed_embeddings_torch.ops.packed_table import adagrad_rule
  from distributed_embeddings_torch.serving.export import serve_class_meta
  from distributed_embeddings_tpu.ops.packed_table import sparse_rule
  from distributed_embeddings_tpu.serving.export import (
      serve_class_meta as jserve_class_meta,
  )
  jplan, tplan = C.jax_plan(world), C.torch_plan(world)
  jmeta, _ = jserve_class_meta(jplan, sparse_rule("adagrad", C.LR), q)
  tmeta, _ = serve_class_meta(tplan, adagrad_rule(C.LR), q)
  want = jengine.ServeTierPlan(jplan, jmeta, js.ServeTierConfig(**cfg))
  got = ts.ServeTierPlan(tplan, tmeta, ts.ServeTierConfig(**cfg))
  assert sorted(got.tier_specs) == sorted(want.tier_specs) != []
  for name, spec in want.tier_specs.items():
    assert got.tier_specs[name].__dict__ == spec.__dict__
    g, w = got.by_name(name), want.by_name(name)
    assert g.spill_cap_grps == w.spill_cap_grps
    assert g.layout_logical.shape == w.layout_logical.shape


def test_serve_tier_plan_refusals_match_jax():
  from distributed_embeddings_torch.layers.embedding import (
      TableConfig as TTable,
  )
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy as TStrategy,
  )
  from distributed_embeddings_torch.serving.export import serve_class_meta
  from distributed_embeddings_tpu.layers.embedding import TableConfig
  from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
  from distributed_embeddings_tpu.serving.export import (
      serve_class_meta as jserve_class_meta,
  )
  from distributed_embeddings_tpu.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.ops.packed_table import (
      sgd_rule as tsgd_rule,
  )
  kw = dict(dense_row_threshold=0, host_row_threshold=4)
  # a host-tier table of 7 rows: fewer logical rows than the serve image
  # packs into one physical row, so no cache row fits under the sentinel
  jplan = DistEmbeddingStrategy([TableConfig(7, 16), TableConfig(3, 16)], 1,
                                "basic", **kw)
  tplan = TStrategy([TTable(7, 16), TTable(3, 16)], 1, "basic", **kw)
  jmeta, _ = jserve_class_meta(jplan, sgd_rule(0.1), "f32")
  tmeta, _ = serve_class_meta(tplan, tsgd_rule(0.1), "f32")
  with pytest.raises(ValueError) as want:
    jengine.ServeTierPlan(jplan, jmeta)
  with pytest.raises(ValueError) as got:
    ts.ServeTierPlan(tplan, tmeta)
  assert str(got.value) == str(want.value)
  assert "no room for a serve hot cache" in str(got.value)
  untiered = C.torch_plan(1, None)
  with pytest.raises(ValueError, match="no host-tier classes"):
    ts.ServeTierPlan(untiered, serve_class_meta(
        untiered, tsgd_rule(0.1), "f32")[0])


def test_freeze_without_store_is_refused_as_in_jax():
  case = _jax()
  plan_t, rule, state, _ = _port()
  with pytest.raises(ValueError) as want:
    jfreeze(case["plan_t"], case["rule"], case["state_t"])
  with pytest.raises(ValueError) as got:
    ts.freeze(plan_t, rule, state)
  assert str(got.value) == str(want.value)


def test_batcher_in_front_of_a_tiered_engine():
  """``world_batcher`` at world 1 is a ``MicroBatcher`` over the tiered
  engine: each request's rows bit-equal to a direct padded dispatch of
  them (``test_batcher_end_to_end_with_engine``'s oracle)."""
  from distributed_embeddings_torch.parallel.lookup_engine import PAD_ID
  plan_t, rule, state, store = _port()
  eng = _engine(plan_t, ts.freeze(plan_t, rule, state, quantize="int8",
                                  store=store))
  numerical, cats = S.request(7)
  max_batch = 16

  def direct(rows):
    n = rows[0].shape[0]
    pad = max_batch - n
    num_p = np.concatenate(
        [rows[0], np.zeros((pad,) + rows[0].shape[1:], np.float32)])
    cats_p = [np.concatenate([c, np.full((pad,), PAD_ID, c.dtype)])
              for c in rows[1]]
    return eng.dispatch(num_p, cats_p).numpy()[:n]

  rng = np.random.default_rng(11)
  reqs = []
  for _ in range(12):
    n = int(rng.integers(1, 6))
    lo = int(rng.integers(0, numerical.shape[0] - n))
    reqs.append((numerical[lo:lo + n], [c[lo:lo + n] for c in cats]))
  wants = [direct(r) for r in reqs]
  mb = ts.world_batcher(eng, max_batch, max_delay_s=0.005)
  futs = [mb.submit(*r) for r in reqs]
  for fut, want in zip(futs, wants):
    np.testing.assert_array_equal(_bits(fut.result(timeout=60)), _bits(want))
  mb.close()
  assert mb.stats["completed"] == len(reqs)

"""The port's lookup engine on ragged value streams and in model-parallel
input mode, against the JAX package's, on the same numpy inputs.

World 1 and the dp-side routing of a world-4 plan run in this process;
world 2 runs as two gloo ranks (``tests/torch_ranks.py: multi_job`` of
``wire_forward_job`` and ``mp_input_job``) against ``shard_map`` programs
over a 2-device CPU mesh.

Bit-exact: the routing ``(vals, lens)`` (row slices, negative ids, the
dead tail), the exchanged streams at world 2, ``_seg_ids``, the valid-id
counts, ``mean_counts``, ``oov_counts``, the eager ``oov='error'``
message, the forward (``sum`` and ``mean``, negative ids, empty samples,
capacity 0, segments of up to 40 ids, a row-sliced ``mean`` table, a
plan mixing deduplicated padded buckets with raw ragged ones, and the
three schedules at world 2): the port sums each segment in stream order
from +0.0 (``torch.segment_reduce``), as XLA's CPU ``segment_sum`` does.
``pack_mp_inputs``' arrays and ``forward_mp`` (through the engine and
through ``DistributedEmbedding(dp_input=False)``) are bit-exact, equal to
the dp-input forward, and their gradients equal the dp-input forward's.
The sparse apply of ragged parts (``h=0``), chunked below the stream's
length or not, ``exact=True`` too, agrees with the JAX apply in the f32
class. The refusals carry the JAX messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_embeddings_torch.layers.dist_model_parallel import \
    DistributedEmbedding as TDistributedEmbedding
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.ops.ragged import RaggedIds as TRagged
from distributed_embeddings_torch.parallel import lookup_engine as tle
from distributed_embeddings_tpu.compat import shard_map
from distributed_embeddings_tpu.layers.dist_model_parallel import set_weights
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.parallel import lookup_engine as jle
from torch_ragged_cases import (
    TOL,
    ragged_input,
    to_jax,
    to_port,
)
from torch_ranks import spawn_start, spawn_wait


def _plans(tables, world, strategy="basic", **kw):
  return (DistEmbeddingStrategy([TableConfig(v, w, combiner=c)
                                 for v, w, c in tables], world, strategy,
                                **kw),
          TStrategy([TTableConfig(v, w, combiner=c) for v, w, c in tables],
                    world, strategy, **kw))


def _params(plan, tables, seed):
  rng = np.random.default_rng(seed)
  return set_weights(plan, [rng.standard_normal((v, w)).astype(np.float32)
                            for v, w, _ in tables])


def _jax_fwd(plan, params, inputs):
  return [np.asarray(o) for o in jle.DistributedLookup(plan).forward(
      {k: jnp.asarray(v) for k, v in params.items()},
      [to_jax(x) for x in inputs])]


def _port_fwd(plan, params, inputs, **kw):
  return [o.detach().numpy() for o in tle.DistributedLookup(plan, **kw)
          .forward({k: torch.tensor(v) for k, v in params.items()},
                   [to_port(x) for x in inputs])]


# ---------------------------------------------------------------------------
# world 1, and the dp side of a world-4 plan
# ---------------------------------------------------------------------------

MIXED = [(50, 16, "sum"), (80, 16, "sum"), (30, 8, "mean"), (120, 8, "mean")]


def _mixed_inputs(seed, b=12, cap=40, max_hot=9):
  rng = np.random.default_rng(seed)
  x1 = rng.integers(0, 80, (b, 3)).astype(np.int32)
  x1[rng.random(x1.shape) < 0.3] = -1
  return [ragged_input(rng, 1, b, 50, max_hot, cap, neg=0.2), x1,
          ragged_input(rng, 1, b, 30, max_hot, cap, neg=0.2),
          ragged_input(rng, 1, b, 120, 40, 300, neg=0.1, min_hot=20)]


CASES = {
    "mixed": lambda: (MIXED, _mixed_inputs(0)),
    "zero_capacity": lambda: (
        [(12, 8, "sum"), (12, 8, "mean")],
        [TRagged(np.zeros(0, np.int32), np.zeros(4, np.int32))] * 2),
    # the JAX test's fixture: sample 0 [3, -1, 5] (one invalid), sample 1 [7]
    "negative_in_window": lambda: (
        [(12, 8, "mean")],
        [TRagged(np.asarray([3, -1, 5, 7], np.int32),
                 np.asarray([0, 3, 4], np.int32))]),
    "empty_rows_and_tail": lambda: (
        [(40, 16, "sum"), (40, 16, "mean")],
        [TRagged(np.asarray([5, 6, 7, 8, 99, 99], np.int32),
                 np.asarray([0, 0, 3, 3, 4, 4], np.int32))] * 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_world1_forward_is_bit_exact(name):
  tables, inputs = CASES[name]()
  jplan, tplan = _plans(tables, 1, dense_row_threshold=0)
  params = _params(jplan, tables, 1)
  for a, b in zip(_port_fwd(tplan, params, inputs),
                  _jax_fwd(jplan, params, inputs)):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_world1_forward_matches_the_padded_path():
  tables, inputs = CASES["mixed"]()
  _, tplan = _plans(tables, 1, dense_row_threshold=0)
  params = _params(_plans(tables, 1, dense_row_threshold=0)[0], tables, 1)
  padded = [tle.ragged_to_padded(to_port(x), 40).numpy()
            if isinstance(x, TRagged) else x for x in inputs]
  for a, b in zip(_port_fwd(tplan, params, inputs),
                  _port_fwd(tplan, params, padded)):
    np.testing.assert_allclose(a, b, **TOL)


ROW_SLICED = [(64, 16, "mean"), (64, 16, "sum")] + [
    (24 + i, 16, "mean") for i in range(6)]


def _row_sliced_inputs(seed, world=4, b=4, cap=16):
  rng = np.random.default_rng(seed)
  out = [ragged_input(rng, world, b, 80, 6, cap, neg=0.2)
         for _ in range(2)]  # ids past the 64-row vocabulary clamp first
  return out + [rng.integers(0, v, world * b).astype(np.int32)
                for v, _, _ in ROW_SLICED[2:]]


def test_dp_side_routing_of_a_row_sliced_world4_plan_is_bit_exact():
  jplan, tplan = _plans(ROW_SLICED, 4, dense_row_threshold=0,
                        row_slice_threshold=16 * 16)
  assert any(sh.row_sliced for s in tplan.rank_shards for sh in s)
  # rank 1's block of the global batch, as its own RaggedIds
  inputs = _row_sliced_inputs(2)
  blocks = [TRagged(np.asarray(x.values)[16:32],
                    np.asarray(x.row_splits)[5:10])
            if isinstance(x, TRagged) else x[4:8] for x in inputs]
  jeng, teng = jle.DistributedLookup(jplan), tle.DistributedLookup(tplan)
  jin = [jle._normalize_input(to_jax(x)) for x in blocks]
  tin = [tle._normalize_input(to_port(x)) for x in blocks]
  hot = [jle.ragged_hotness(x) for x in jin]
  assert hot == [tle.ragged_hotness(x) for x in tin]
  seen = 0
  for key in tplan.class_keys:
    for tb, jb in zip(teng._buckets(key, lambda i: hot[i]),
                      jeng._buckets(key, lambda i: hot[i])):
      if tb.h >= 0:
        continue
      tv, tl = teng._build_routing(key, tb, tin)
      jv, jl = jeng._build_routing(key, jb, jin)
      np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
      np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
      seen += 1
  assert seen


def test_counts_are_bit_exact():
  jplan, tplan = _plans(ROW_SLICED, 4, dense_row_threshold=0,
                        row_slice_threshold=16 * 16)
  inputs = _row_sliced_inputs(3, world=1)
  jeng, teng = jle.DistributedLookup(jplan), tle.DistributedLookup(tplan)
  want = jeng.mean_counts([to_jax(x) for x in inputs])
  got = teng.mean_counts([to_port(x) for x in inputs])
  assert sorted(got) == sorted(want) and 0 in got
  for i in want:
    np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
  # _seg_ids and the valid counts of a routed stream
  rg = to_port(inputs[0])
  lens = rg.row_lengths()
  for cap in (0, 5, 16):
    np.testing.assert_array_equal(
        tle._seg_ids(lens[None], cap)[0].numpy(),
        np.asarray(jle._seg_ids(jnp.asarray(lens.numpy()), cap)))
  # a routed stream: ids or sentinels, the dead tail all sentinels
  key = tplan.class_keys[0]
  sentinel = tle.padded_rows(tplan, key)
  vals = np.random.default_rng(4).integers(0, sentinel + 1, (2, 3, 16))
  lens3 = np.random.default_rng(5).integers(0, 4, (2, 3, 4))
  vals[np.arange(16) >= lens3.sum(-1, keepdims=True)] = sentinel
  vals, lens3 = (torch.tensor(vals.astype(np.int32)),
                 torch.tensor(lens3.astype(np.int32)))
  _, jc = jeng._ragged_valid_counts(jnp.asarray(vals.numpy()),
                                    jnp.asarray(lens3.numpy()), key)
  np.testing.assert_array_equal(
      teng._ragged_valid_counts(vals, lens3, key).reshape(6, 4).numpy(),
      np.asarray(jc))


def test_oov_counts_and_the_eager_error_are_the_jax_ones():
  tables = [(40, 16, "sum"), (40, 16, "mean")]
  rg = TRagged(np.asarray([1, 45, 3, 2, 77, 41], np.int32),
               np.asarray([0, 2, 3, 4], np.int32))  # 77, 41: dead tail
  inputs = [rg, np.asarray([[1, 2], [50, -1], [3, 4]], np.int32)]
  jplan, tplan = _plans(tables, 1, dense_row_threshold=0)
  jeng, teng = jle.DistributedLookup(jplan), tle.DistributedLookup(tplan)
  want = jeng.oov_counts([to_jax(x) for x in inputs])
  got = teng.oov_counts([to_port(x) for x in inputs])
  assert {k: int(v) for k, v in got.items()} == \
      {k: int(v) for k, v in want.items()}
  jplan, tplan = _plans(tables, 1, dense_row_threshold=0, oov="error")
  with pytest.raises(ValueError) as ej:
    jle.DistributedLookup(jplan).route_ids([to_jax(x) for x in inputs])
  with pytest.raises(ValueError) as et:
    tle.DistributedLookup(tplan).route_ids([to_port(x) for x in inputs])
  assert str(et.value) == str(ej.value)
  assert "first offender 45" in str(et.value)


def test_refusals_are_the_jax_messages():
  rg = TRagged(np.asarray([1, 2, 3], np.int32), np.asarray([0, 2, 3],
                                                           np.int32))
  for tables, kw, exc in (
      ([(50, 16, None)], {"dense_row_threshold": 0}, ValueError),
      ([(10, 16, "sum")], {"dense_row_threshold": 2048},
       NotImplementedError)):
    jplan, tplan = _plans(tables, 1, **kw)
    jeng, teng = jle.DistributedLookup(jplan), tle.DistributedLookup(tplan)
    with pytest.raises(exc) as ej:
      jeng.forward({k: jnp.zeros(s) for k, s in jeng.param_shapes().items()},
                   [to_jax(rg)])
    with pytest.raises(exc) as et:
      teng.forward({k: torch.zeros(s) for k, s in
                    teng.param_shapes().items()}, [to_port(rg)])
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("rule_name,chunk,exact", [
    ("sgd", 1 << 22, False), ("sgd", 97, False), ("adagrad", 64, False),
    ("adagrad", 1 << 22, True)])
def test_sparse_apply_of_ragged_parts_matches_jax(rule_name, chunk, exact):
  """``lookup_sparse_fused`` then ``apply_sparse`` with a random cotangent
  (``mean`` and ``sum`` streams of narrow classes with state); chunks
  below the stream's length take the chunked path."""
  tables, inputs = CASES["mixed"]()
  jplan, tplan = _plans(tables, 1, dense_row_threshold=0)
  jrule = getattr(jpt, f"{rule_name}_rule")(0.1)
  trule = getattr(tpt, f"{rule_name}_rule")(0.1)
  jeng = jle.DistributedLookup(jplan, apply_chunk=chunk)
  teng = tle.DistributedLookup(tplan, apply_chunk=chunk)
  layouts_j, layouts_t = jeng.fused_layouts(jrule), teng.fused_layouts(trule)
  rng = np.random.default_rng(6)
  bufs = {n: rng.uniform(0.1, 1.0, l.shape).astype(np.float32)
          for n, l in layouts_t.items()}
  jids = jeng.route_ids([to_jax(x) for x in inputs])
  tids = teng.route_ids([to_port(x) for x in inputs])
  jz, jres = jeng.lookup_sparse_fused({n: jnp.asarray(b) for n, b in
                                       bufs.items()}, layouts_j, jids)
  tz, tres = teng.lookup_sparse_fused({n: torch.tensor(b) for n, b in
                                       bufs.items()}, layouts_t, tids)
  d_z = {bk: rng.standard_normal(tuple(z.shape)).astype(np.float32)
         for bk, z in tz.items()}
  for bk in tz:
    np.testing.assert_array_equal(tz[bk].numpy(), np.asarray(jz[bk]))
  want = jeng.apply_sparse({n: jnp.asarray(b) for n, b in bufs.items()},
                           layouts_j, {bk: jnp.asarray(g) for bk, g in
                                       d_z.items()}, jres, jrule,
                           jnp.int32(0), exact=exact)
  got = teng.apply_sparse({n: torch.tensor(b) for n, b in bufs.items()},
                          layouts_t, {bk: torch.tensor(g) for bk, g in
                                      d_z.items()}, tres, trule, 0,
                          exact=exact)
  for n in bufs:
    assert not np.array_equal(np.asarray(want[n]), bufs[n])
    np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                               err_msg=n, **TOL)


# ---------------------------------------------------------------------------
# model-parallel input mode
# ---------------------------------------------------------------------------

MP_TABLES = [(40, 16, "sum"), (9, 16, None), (70, 16, "mean"),
             (12, 16, "sum")]
MP_HOTNESS = [3, 1, 2, 2]


def _mp_case(world, seed=7, g=8):
  rng = np.random.default_rng(seed)
  jplan, tplan = _plans(MP_TABLES, world, dense_row_threshold=10)
  params = _params(jplan, MP_TABLES, seed)
  inputs = []
  for (v, _, _), h in zip(MP_TABLES, MP_HOTNESS):
    x = rng.integers(0, v + 2, (g, h) if h > 1 else (g,)).astype(np.int32)
    if h > 1:
      x[rng.random(x.shape) < 0.3] = -1
    inputs.append(x)
  per_rank = [[inputs[i] for i in tplan.input_ids_list[r]]
              for r in range(world)]
  ct = [rng.standard_normal((g, 16)).astype(np.float32) for _ in MP_TABLES]
  return jplan, tplan, {
      "tables": MP_TABLES, "strategy": "basic",
      "plan_kw": {"dense_row_threshold": 10}, "params": params,
      "per_rank": per_rank, "hotness": MP_HOTNESS, "inputs": inputs,
      "ct": ct}


def test_world1_mp_input_mode_is_bit_exact():
  jplan, tplan, case = _mp_case(1)
  jpacked = jle.pack_mp_inputs(jplan, [[jnp.asarray(x) for x in r]
                                       for r in case["per_rank"]],
                               MP_HOTNESS)
  tpacked = tle.pack_mp_inputs(tplan, [[torch.tensor(x) for x in r]
                                       for r in case["per_rank"]],
                               MP_HOTNESS)
  assert sorted(tpacked) == sorted(jpacked)
  for k in jpacked:
    np.testing.assert_array_equal(tpacked[k].numpy(), np.asarray(jpacked[k]))
  want = jle.DistributedLookup(jplan).forward_mp(
      {k: jnp.asarray(v) for k, v in case["params"].items()}, jpacked,
      MP_HOTNESS)
  tparams = {k: torch.tensor(v) for k, v in case["params"].items()}
  got = tle.DistributedLookup(tplan).forward_mp(tparams, tpacked, MP_HOTNESS)
  layer = TDistributedEmbedding(
      [TTableConfig(v, w, combiner=c) for v, w, c in MP_TABLES],
      dp_input=False, input_hotness=MP_HOTNESS, dense_row_threshold=10,
      device="cpu")
  layer.load_state_dict(tparams)
  dp = tle.DistributedLookup(tplan).forward(
      tparams, [torch.tensor(x) for x in case["inputs"]])
  for g_, w_, l_, d_ in zip(got, want, layer(tpacked), dp):
    np.testing.assert_array_equal(g_.detach().numpy(), np.asarray(w_))
    np.testing.assert_array_equal(l_.detach().numpy(), np.asarray(w_))
    np.testing.assert_array_equal(d_.detach().numpy(), np.asarray(w_))
  assert layer(tpacked, return_oov=True)[1] == {}


def test_mp_input_refusals_are_the_jax_messages():
  jplan, tplan, case = _mp_case(1)
  per_j = [[jnp.asarray(x) for x in r] for r in case["per_rank"]]
  per_t = [[torch.tensor(x) for x in r] for r in case["per_rank"]]
  calls = [
      (ValueError, lambda le, p, per: le.pack_mp_inputs(p, per,
                                                        [-3, 1, 2, 2])),
      (ValueError, lambda le, p, per: le.pack_mp_inputs(p, per,
                                                        [2, 1, 2, 2])),
      (ValueError, lambda le, p, per: le.DistributedLookup(p).forward_mp(
          {}, {}, [-3, 1, 2, 2])),
  ]
  for exc, call in calls:
    with pytest.raises(exc) as ej:
      call(jle, jplan, per_j)
    with pytest.raises(exc) as et:
      call(tle, tplan, per_t)
    assert str(et.value) == str(ej.value)
  rg_j = [[to_jax(TRagged(np.asarray([1, 2], np.int32),
                          np.asarray([0, 1, 2], np.int32)))] + r[1:]
          for r in per_j]
  rg_t = [[to_port(TRagged(np.asarray([1, 2], np.int32),
                           np.asarray([0, 1, 2], np.int32)))] + r[1:]
          for r in per_t]
  with pytest.raises(TypeError) as ej:
    jle.pack_mp_inputs(jplan, rg_j, MP_HOTNESS)
  with pytest.raises(TypeError) as et:
    tle.pack_mp_inputs(tplan, rg_t, MP_HOTNESS)
  assert str(et.value) == str(ej.value)
  tpacked = tle.pack_mp_inputs(tplan, per_t, MP_HOTNESS)
  jpacked = jle.pack_mp_inputs(jplan, per_j, MP_HOTNESS)
  name = next(k for k in sorted(tpacked) if tpacked[k].shape[3] > 1)
  with pytest.raises(ValueError) as ej:
    jle.DistributedLookup(jplan).forward_mp(
        {k: jnp.asarray(v) for k, v in case["params"].items()},
        {**jpacked, name: jpacked[name][:, :, :, :1]}, MP_HOTNESS)
  with pytest.raises(ValueError) as et:
    tle.DistributedLookup(tplan).forward_mp(
        {k: torch.tensor(v) for k, v in case["params"].items()},
        {**tpacked, name: tpacked[name][:, :, :, :1]}, MP_HOTNESS)
  assert str(et.value).replace("torch.Size(", "").replace("])", "]") \
      .split(" has shape")[0] == str(ej.value).split(" has shape")[0]
  rs_j, rs_t = _plans(ROW_SLICED, 4, dense_row_threshold=0,
                      row_slice_threshold=16 * 16)
  with pytest.raises(NotImplementedError) as ej:
    jle.pack_mp_inputs(rs_j, [[]] * 4)
  with pytest.raises(NotImplementedError) as et:
    tle.pack_mp_inputs(rs_t, [[]] * 4)
  assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# world 2, two gloo ranks against a 2-device CPU mesh
# ---------------------------------------------------------------------------

W2 = 2
W2_TABLES = [(50, 16, "sum"), (80, 16, "mean"), (23, 16, "sum"),
             (31, 16, "mean"), (47, 16, "sum")]
W2_KNOBS = {
    "none": {},
    "pipelined": {"overlap": "pipelined", "exchange_chunks": 3},
    "fused": {"overlap": "fused", "exchange_chunks": 3},
    "dedup_mix": {"dedup_exchange": True},
    "dedup_mix_fused": {"dedup_exchange": True, "overlap": "fused",
                        "exchange_chunks": 2},
}


def _w2_case(knobs):
  rng = np.random.default_rng(8)
  kw = dict(dense_row_threshold=0, input_hotness=[-6, -6, 3, 1, -4],
            **knobs)
  jplan = DistEmbeddingStrategy([TableConfig(v, w, combiner=c)
                                 for v, w, c in W2_TABLES], W2,
                                "memory_balanced", **kw)
  b, cap = 6, 20
  x2 = rng.integers(0, 23, (W2 * b, 3)).astype(np.int32)
  x2[rng.random(x2.shape) < 0.25] = -1
  inputs = [ragged_input(rng, W2, b, 50, 6, cap),
            ragged_input(rng, W2, b, 90, 6, cap),  # ids past 80 clamp
            x2, rng.integers(0, 31, W2 * b).astype(np.int32),
            ragged_input(rng, W2, b, 47, 4, 12)]
  return jplan, {"tables": W2_TABLES, "strategy": "memory_balanced",
                 "plan_kw": kw, "params": _params(jplan, W2_TABLES, 9),
                 "inputs": inputs, "route": True}


def _jax_world_forward(plan, params, inputs, world):
  engine = jle.DistributedLookup(plan)
  mesh = create_mesh(world)

  def fwd(p, *xs):
    outs = engine.forward(p, list(xs))
    routed = engine.route_ids(list(xs))
    return tuple(outs), {repr(tuple(bk)): (v[None], l[None])
                         for bk, (v, l) in
                         ((bk, r) for bk, r in routed.items()
                          if isinstance(r, tuple))}

  jin = [to_jax(x) for x in inputs]
  outs, routed = jax.jit(shard_map(
      fwd, mesh=mesh, in_specs=({n: P("mp", None) for n in params},)
      + tuple(P("mp") for _ in inputs),
      out_specs=(tuple(P("mp") for _ in inputs), P("mp"))))(
          {k: jnp.asarray(v) for k, v in params.items()}, *jin)
  return ([np.asarray(o) for o in outs],
          {k: (np.asarray(v), np.asarray(l)) for k, (v, l) in
           routed.items()})


def _jax_world_mp(plan, case, world):
  engine = jle.DistributedLookup(plan)
  mesh = create_mesh(world)
  packed = jle.pack_mp_inputs(plan, [[jnp.asarray(x) for x in r]
                                     for r in case["per_rank"]],
                              case["hotness"])

  def fwd(p, pk):
    return tuple(engine.forward_mp(p, pk, case["hotness"]))

  outs = jax.jit(shard_map(
      fwd, mesh=mesh, in_specs=({n: P("mp", None) for n in case["params"]},
                                {n: P("mp") for n in packed}),
      out_specs=tuple(P("mp") for _ in case["inputs"])))(
          {k: jnp.asarray(v) for k, v in case["params"].items()}, packed)
  return {k: np.asarray(v) for k, v in packed.items()}, \
      [np.asarray(o) for o in outs]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
  cases = {n: _w2_case(k) for n, k in W2_KNOBS.items()}
  mp_jplan, _, mp_case = _mp_case(W2, seed=10, g=8)
  started = spawn_start(tmp_path_factory.mktemp("ragged_w2"), W2,
                        "multi_job", {"jobs": {
                            "forward": ("wire_forward_job", {"cases": {
                                n: c for n, (_, c) in cases.items()}}),
                            "mp": ("mp_input_job", {"cases": {
                                "mp": mp_case}})}})
  want = {n: _jax_world_forward(p, c["params"], c["inputs"], W2)
          for n, (p, c) in cases.items() if n in ("none", "dedup_mix")}
  want_mp = _jax_world_mp(mp_jplan, mp_case, W2)
  return want, want_mp, spawn_wait(started)


@pytest.mark.parametrize("name", sorted(W2_KNOBS))
def test_world2_forward_and_exchanged_streams_are_bit_exact(world2, name):
  want, _, got = world2
  outs, routed = want["dedup_mix" if "dedup" in name else "none"]
  for rank, rank_out in enumerate(got):
    res = rank_out["forward"][name]
    for t, (a, b) in enumerate(zip(res["outs"], outs)):
      np.testing.assert_array_equal(a, b, err_msg=f"{name} input {t}")
    assert sorted(res["routed"]) == sorted(routed)
    for k, (v, l) in res["routed"].items():
      np.testing.assert_array_equal(v, routed[k][0][rank], err_msg=k)
      np.testing.assert_array_equal(l, routed[k][1][rank], err_msg=k)


def test_world2_mp_input_mode_is_bit_exact_with_dp_gradients(world2):
  _, (packed, outs), got = world2
  for rank_out in got:
    res = rank_out["mp"]["mp"]
    for k in packed:
      np.testing.assert_array_equal(res["packed"][k], packed[k])
    for form in ("mp", "dp"):
      for a, b in zip(res[form]["outs"], outs):
        np.testing.assert_array_equal(a, b, err_msg=form)
    for a, b in zip(res["layer"], outs):
      np.testing.assert_array_equal(a, b)
    for k, g in res["dp"]["grads"].items():
      np.testing.assert_allclose(res["mp"]["grads"][k], g, err_msg=k, **TOL)

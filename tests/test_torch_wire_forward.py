"""The port's world-4 lookup under the wire-compression knobs, bit-exact
against the JAX package's.

``DistributedLookup.forward`` runs as four gloo processes
(``tests/torch_ranks.py: wire_forward_job``) and as one ``shard_map``
program over a 4-device CPU mesh, on the same class params and ids drawn
with numpy (the JAX tests' fixtures, ``tests/test_wire_exchange.py:
122-215, 597-632``):

- nine tables of width 16 with padded multi-hot ``sum`` and ``mean``
  inputs (25 % PAD holes) under ``dedup_exchange=True`` with the
  monolithic, pipelined (3 chunks) and fused (3 chunks) schedules, under
  ``wire_dtype='fp8'`` with each schedule (2 chunks), fp8 and dedup
  together, and a capped ``dedup_capacity`` (whose aliased ids read the
  wrong rows, as the JAX package's do);
- row-sliced ``mean`` tables under dedup and each schedule.

Every output is bit-equal to the JAX one; the f32 dedup outputs are
bit-equal to the raw exchange's, and the fp8 outputs lie within the JAX
tests' bound of f32 (``h * 2^-3 * max|row|`` per element).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from distributed_embeddings_tpu.compat import shard_map
from distributed_embeddings_tpu.layers import DistEmbeddingStrategy, TableConfig
from distributed_embeddings_tpu.layers.dist_model_parallel import set_weights
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.parallel.lookup_engine import (
    PAD_ID,
    DistributedLookup,
)
from torch_ranks import spawn

WORLD = 4
MIXED = [50, 80, 23, 31, 47, 19, 27, 35, 41]
ROW_SLICED = [96, 64, 48, 40, 88, 56, 72, 104]
MIXED_KNOBS = {
    "raw": {},
    "dedup": {"dedup_exchange": True},
    "dedup_pipelined": {"dedup_exchange": True, "overlap": "pipelined",
                        "exchange_chunks": 3},
    "dedup_fused": {"dedup_exchange": True, "overlap": "fused",
                    "exchange_chunks": 3},
    "fp8": {"wire_dtype": "fp8"},
    "fp8_pipelined": {"wire_dtype": "fp8", "overlap": "pipelined",
                      "exchange_chunks": 2},
    "fp8_fused": {"wire_dtype": "fp8", "overlap": "fused",
                  "exchange_chunks": 2},
    "fp8_dedup_fused": {"wire_dtype": "fp8", "dedup_exchange": True,
                        "overlap": "fused", "exchange_chunks": 2},
    "dedup_capped": {"dedup_exchange": True, "dedup_capacity": 5},
}
ROW_SLICED_KNOBS = {
    "raw": {},
    "dedup": {"dedup_exchange": True},
    "dedup_pipelined": {"dedup_exchange": True, "overlap": "pipelined",
                        "exchange_chunks": 3},
    "dedup_fused": {"dedup_exchange": True, "overlap": "fused",
                    "exchange_chunks": 3},
}


def _mixed(combiner, knobs):
  rng = np.random.default_rng(0)
  kw = dict(dense_row_threshold=0, **knobs)
  plan = DistEmbeddingStrategy(
      [TableConfig(s, 16, combiner=combiner) for s in MIXED], WORLD,
      "memory_balanced", **kw)
  weights = [rng.standard_normal((s, 16)).astype(np.float32) for s in MIXED]
  ids = [rng.integers(0, s, (4 * WORLD, 3)).astype(np.int32) for s in MIXED]
  for x in ids:  # PAD holes exercise the sentinel / valid-count handling
    x[rng.random(x.shape) < 0.25] = PAD_ID
  case = {"tables": [(s, 16, combiner) for s in MIXED],
          "strategy": "memory_balanced", "plan_kw": kw,
          "params": set_weights(plan, weights), "inputs": ids}
  return plan, case


def _row_sliced(knobs):
  rng = np.random.default_rng(1)
  kw = dict(row_slice_threshold=16 * 8, **knobs)
  plan = DistEmbeddingStrategy(
      [TableConfig(s, 8, combiner="mean") for s in ROW_SLICED], WORLD,
      "basic", **kw)
  assert any(sh.row_sliced for shards in plan.rank_shards for sh in shards)
  weights = [rng.standard_normal((s, 8)).astype(np.float32)
             for s in ROW_SLICED]
  ids = [rng.integers(0, s, (2 * WORLD, 3)).astype(np.int32)
         for s in ROW_SLICED]
  for x in ids:
    x[rng.random(x.shape) < 0.2] = PAD_ID
  case = {"tables": [(s, 8, "mean") for s in ROW_SLICED],
          "strategy": "basic", "plan_kw": kw,
          "params": set_weights(plan, weights), "inputs": ids}
  return plan, case


def _cases():
  out = {}
  for combiner in ("sum", "mean"):
    for name, knobs in MIXED_KNOBS.items():
      out[f"{combiner}/{name}"] = _mixed(combiner, knobs)
  for name, knobs in ROW_SLICED_KNOBS.items():
    out[f"row_sliced/{name}"] = _row_sliced(knobs)
  return out


def _jax_forward(plan, params, inputs):
  engine = DistributedLookup(plan)
  mesh = create_mesh(WORLD)
  pspecs = {n: P("mp", None) for n in params}

  def fwd(p, *xs):
    return tuple(engine.forward(p, list(xs)))

  outs = jax.jit(shard_map(
      fwd, mesh=mesh, in_specs=(pspecs,) + tuple(P("mp") for _ in inputs),
      out_specs=tuple(P("mp") for _ in inputs)))(
          {k: jnp.asarray(v) for k, v in params.items()},
          *[jnp.asarray(x) for x in inputs])
  return [np.asarray(o) for o in outs]


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
  cases = _cases()
  got = spawn(tmp_path_factory.mktemp("wirefwd"), WORLD, "wire_forward_job",
              {"cases": {n: c for n, (_, c) in cases.items()}})
  for rank_out in got[1:]:  # every rank gathers the same global outputs
    for name, res in rank_out.items():
      for a, b in zip(res["outs"], got[0][name]["outs"]):
        np.testing.assert_array_equal(a, b, err_msg=name)
  return cases, got[0]


@functools.lru_cache(maxsize=None)
def _want(name):
  plan, case = _cases()[name]
  return _jax_forward(plan, case["params"], case["inputs"])


NAMES = ([f"{c}/{n}" for c in ("sum", "mean") for n in MIXED_KNOBS]
         + [f"row_sliced/{n}" for n in ROW_SLICED_KNOBS])


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_bit_exact(forwards, name):
  _, got = forwards
  want = _want(name)
  assert len(got[name]["outs"]) == len(want)
  for t, (a, b) in enumerate(zip(got[name]["outs"], want)):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b, err_msg=f"{name} table {t}")


@pytest.mark.parametrize("name", [n for n in NAMES if "dedup" in n
                                  and "fp8" not in n and "capped" not in n])
def test_f32_dedup_is_bit_exact_against_the_raw_exchange(forwards, name):
  _, got = forwards
  raw = got[name.rsplit("/", 1)[0] + "/raw"]["outs"]
  for t, (a, b) in enumerate(zip(got[name]["outs"], raw)):
    np.testing.assert_array_equal(a, b, err_msg=f"{name} table {t}")


@pytest.mark.parametrize("name", [n for n in NAMES if "fp8" in n])
def test_fp8_wire_within_the_jax_bound_of_f32(forwards, name):
  _, got = forwards
  raw = got[name.split("/", 1)[0] + "/raw"]["outs"]
  h = 3
  for t, (a, b) in enumerate(zip(raw, got[name]["outs"])):
    bound = h * 2.0 ** -3 * np.abs(a).max() + 1e-6
    assert np.abs(a - b).max() <= bound, (t, np.abs(a - b).max(), bound)
    assert np.abs(a - b).max() > 0  # the wire really narrowed something

"""The port's wire (``parallel/wire.py``) across real gloo ranks.

Every schedule — the monolithic ``all_to_all``, the pipelined rotation
rounds (chunks 1-3) and the fused per-round block sends — runs in world-2
and world-4 gloo processes (``tests/torch_ranks.py``) on payloads drawn
with numpy from a seed. Each is held bit-exact to the numpy permutation
it stands for (``out_i[j] = x_j[i]``), forward and, under
``torch.autograd``, backward (the reverse exchange brings ``ct_j[i]``
back to rank ``i``). The bf16 wire is held bit-exact to the JAX package's
``float_all_to_all`` on a CPU mesh of as many devices, on the same
inputs and cotangents.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from distributed_embeddings_torch.parallel import wire as twire
from distributed_embeddings_tpu.compat import shard_map
from distributed_embeddings_tpu.parallel import wire as jwire
from torch_ranks import spawn

CHUNKS = (1, 2, 3)
SHAPE = (3, 5, 7)  # per destination block: odd sizes, so chunks pad


def _payloads(world, seed=0):
  rng = np.random.default_rng(seed + world)
  x = rng.standard_normal((world, world) + SHAPE).astype(np.float32)
  ct = rng.standard_normal((world, world) + SHAPE).astype(np.float32)
  ids = rng.integers(-1, 1 << 20, (world, world, 4, 6)).astype(np.int32)
  return x, ct, ids


def _permuted(a):
  """``out[i][j] = a[j][i]``: rank ``i`` receives block ``i`` of every
  rank, source-major."""
  return np.swapaxes(a, 0, 1)


def _bf16(a):
  return a.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
  world = request.param
  x, ct, ids = _payloads(world)
  spec = {"x": x, "ct": ct, "ids": ids, "chunks": CHUNKS}
  out = spawn(tmp_path_factory.mktemp(f"wire{world}"), world, "wire_job",
              spec)
  return world, x, ct, ids, out


def test_id_exchanges_are_the_permutation(ranks):
  world, _, _, ids, out = ranks
  want = _permuted(ids)
  for rank in range(world):
    for name in ["ids/mono"] + [f"ids/pipe{c}" for c in CHUNKS]:
      got = out[rank][name]
      assert got.dtype == np.int32, name
      np.testing.assert_array_equal(got, want[rank], err_msg=name)


@pytest.mark.parametrize("schedule", ["mono", "pipe1", "pipe2", "pipe3",
                                      "fused"])
def test_f32_exchanges_and_their_reverse_are_bit_exact(ranks, schedule):
  world, x, ct, _, out = ranks
  want_y, want_g = _permuted(x), _permuted(ct)
  for rank in range(world):
    y, g = out[rank][f"f32/{schedule}"]
    np.testing.assert_array_equal(y, want_y[rank])
    np.testing.assert_array_equal(g, want_g[rank])


@pytest.mark.parametrize("schedule", ["mono", "pipe1", "pipe2", "pipe3",
                                      "fused"])
def test_bf16_wire_rounds_both_directions(ranks, schedule):
  world, x, ct, _, out = ranks
  want_y, want_g = _permuted(_bf16(x)), _permuted(_bf16(ct))
  for rank in range(world):
    y, g = out[rank][f"bf16/{schedule}"]
    assert y.dtype == g.dtype == np.float32
    np.testing.assert_array_equal(y, want_y[rank])
    np.testing.assert_array_equal(g, want_g[rank])


def test_gather_blocks_stacks_every_rank(ranks):
  world, x, _, _, out = ranks
  want = np.concatenate([x[r][0] for r in range(world)])
  for rank in range(world):
    np.testing.assert_array_equal(out[rank]["gather"], want)


@functools.lru_cache(maxsize=None)
def _jax_bf16_exchange(world):
  mesh = Mesh(np.asarray(jax.devices()[:world]), ("mp",))

  def local(x, ct):
    def f(v):
      return jwire.float_all_to_all(v, "mp", jnp.bfloat16)
    y, vjp = jax.vjp(f, x)
    return y, vjp(ct)[0]

  return jax.jit(shard_map(local, mesh=mesh, in_specs=(P("mp"), P("mp")),
                           out_specs=(P("mp"), P("mp"))))


def test_bf16_wire_matches_jax_float_all_to_all(ranks):
  world, x, ct, _, out = ranks
  flat = (world * world,) + SHAPE
  y, g = _jax_bf16_exchange(world)(jnp.asarray(x.reshape(flat)),
                                   jnp.asarray(ct.reshape(flat)))
  y = np.asarray(y).reshape(x.shape)
  g = np.asarray(g).reshape(x.shape)
  for rank in range(world):
    for schedule in ("mono", "pipe2", "fused"):
      got_y, got_g = out[rank][f"bf16/{schedule}"]
      np.testing.assert_array_equal(got_y, y[rank], err_msg=schedule)
      np.testing.assert_array_equal(got_g, g[rank], err_msg=schedule)


def test_world_one_is_the_identity_and_fp8_is_refused():
  x = torch.arange(12.0).reshape(1, 3, 4)
  assert twire.float_all_to_all(x, None) is x
  assert twire.exchange_ids(x, None) is x
  assert twire.pipelined_float_exchange(x, None, torch.bfloat16, 2) is x
  assert twire.fused_block_send(x, None, 0) is x

  class Plan:
    wire_dtype = "fp8"
    overlap = "bogus"

  with pytest.raises(NotImplementedError, match="fp8"):
    twire.plan_wire_dtype(Plan())
  with pytest.raises(ValueError, match="overlap"):
    twire.plan_overlap(Plan())
  assert twire.fused_round_perm(1, 4) == [(0, 1), (1, 2), (2, 3), (3, 0)]


def test_backend_follows_the_topology():
  """gloo on the CPU; a CUDA mesh's backend is decided by the card count
  (NCCL when every rank owns a card), which only the card can show."""
  from distributed_embeddings_torch.parallel import mesh
  assert mesh.choose_backend("cpu", 4) == "gloo"
  assert mesh.rank_device("cpu", 3, 4) == torch.device("cpu")
  with pytest.raises(ValueError, match="no process-group backend"):
    mesh.choose_backend("meta", 4)

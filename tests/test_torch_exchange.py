"""K4 (the fused exchange's per-round row gather) in the port vs the JAX
package.

The K4 wrapper ``ops/cuda_exchange.py:gather_rows`` runs its plain
version on CPU tensors. It is held bit-exact (pure data movement) to

- the Pallas kernel body run in interpret mode,
  ``ops/pallas_exchange_sim.py:gather_rows_sim``, over the shared golden
  streams of ``tests/pallas_goldens.py`` at each stream's own chunk
  size and at 128;
- the port's and the JAX package's ``packed_table.gather_fused``, on
  streams with sentinel and out-of-range ids (what row slicing sends),
  multi-dimensional id blocks, an empty id list, a 256-lane fused
  stride (128 table lanes with one optimizer-state slot), and strides
  that leave lanes of the 128-lane physical row unused (96, 100 and 65:
  f32 rows of one fused row per physical row, as in the TPU kernel,
  which gathers whole physical rows and keeps ``[:, :stride]``).

The ids are int32, as the wire carries them.

Its refusals mirror the Pallas kernel's
(``tests/test_pallas_goldens.py:test_exchange_kernel_rejects_unserved_layouts``).
The CUDA kernel computes the same function; ``chip_smoke.py`` holds it
bit-equal to the plain version on the card.

K5 (``gather_send_rows``, one gather-and-push round of the fused wire) is
held the same way: its wrapper's plain version, on CPU tensors, against
the JAX kernel body's loopback twin ``gather_send_rows_sim`` (Pallas
interpret mode, the remote copy modeled as a local one) over the golden
streams ``exchange_vectors(CASE_NAMES[:4])``, bit-exact, into a
preallocated receive buffer; and its refusals. The peer push runs on the
card only (``chip_smoke.py``: loopback on one card, rotate-by-k rounds
across four).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import cuda_exchange
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.ops.pallas_exchange_sim import (
    gather_rows_sim,
    gather_send_rows_sim,
)
from pallas_goldens import CASE_NAMES, exchange_vectors


def _gather(layout, buf, ids):
  before = cuda_exchange.launches
  got = cuda_exchange.gather_rows(layout, torch.tensor(buf),
                                  torch.tensor(ids.astype(np.int32)))
  assert cuda_exchange.launches == before  # CPU tensors: plain version
  return got.numpy()


@pytest.mark.parametrize("chunk", ["golden", 128])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_gather_rows_matches_pallas_twin(name, chunk):
  buf, ids, golden_chunk = exchange_vectors(name)
  chunk = golden_chunk if chunk == "golden" else chunk
  layout = tpt.PackedLayout(rows=buf.shape[0], width=buf.shape[1])
  want = np.asarray(gather_rows_sim(
      jpt.PackedLayout(rows=buf.shape[0], width=buf.shape[1]),
      jnp.asarray(buf), jnp.asarray(ids), chunk=chunk))
  got = _gather(layout, buf, ids)
  assert got.shape == want.shape == (len(ids), buf.shape[1])
  np.testing.assert_array_equal(got, want, err_msg=name)


def _stream(rng, rows, shape, bad_share=0.3):
  """int32 ids in ``[0, rows)`` with ``bad_share`` of them replaced by
  the routing's sentinel (``rows``), -1 or ids at the ends of int32."""
  ids = rng.integers(0, rows, shape)
  bad = rng.random(shape) < bad_share
  i32 = np.iinfo(np.int32)
  junk = rng.choice(np.array([rows, -1, rows + 7, i32.max, i32.min]), shape)
  return np.where(bad, junk, ids).astype(np.int32)


def _check_against_gather_fused(shape, width, n_aux, seed):
  rows = 300
  rng = np.random.default_rng(seed)
  tl = tpt.PackedLayout(rows=rows, width=width, n_aux=n_aux)
  jl = jpt.PackedLayout(rows=rows, width=width, n_aux=n_aux)
  assert tl.rows_per_phys == 1 and tl.phys_width % 128 == 0
  buf = rng.standard_normal(tuple(tl.shape)).astype(np.float32)
  ids = _stream(rng, rows, shape)
  got = _gather(tl, buf, ids)
  want_port = tpt.gather_fused(tl, torch.tensor(buf),
                               torch.tensor(ids)).numpy()
  want_jax = np.asarray(jpt.gather_fused(jl, jnp.asarray(buf),
                                         jnp.asarray(ids)))
  assert got.shape == shape + (tl.stride,)
  np.testing.assert_array_equal(got, want_port)
  np.testing.assert_array_equal(got, want_jax)
  valid = (ids >= 0) & (ids < rows)
  assert not np.any(got[~valid]), "out-of-range ids give all-zero rows"


SHAPES = [(0,), (1,), (37,), (3, 64), (2, 5, 4)]


@pytest.mark.parametrize("n_aux", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_rows_matches_gather_fused(shape, n_aux):
  _check_against_gather_fused(shape, 128, n_aux,
                              len(shape) * 100 + n_aux + sum(shape))


@pytest.mark.parametrize("width", [96, 100, 65])
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_rows_short_stride_matches_gather_fused(shape, width):
  """A fused row short of its 128-lane physical row (a stride of 96, 100
  or 65 lanes): the kernel reads the stride's lanes of each whole
  physical row, as the TPU kernel keeps ``[:, :stride]``."""
  _check_against_gather_fused(shape, width, 0,
                              len(shape) * 100 + width + sum(shape))


def test_gather_rows_rejects_unserved_layouts():
  buf = torch.zeros((8, 128))
  ids = torch.zeros((4,), dtype=torch.int32)
  narrow = tpt.PackedLayout(rows=8, width=16)
  with pytest.raises(ValueError, match="rows_per_phys"):
    cuda_exchange.gather_rows(narrow, torch.zeros(tuple(narrow.shape)), ids)
  wide = tpt.PackedLayout(rows=8, width=128)
  # f32 and bf16 buffers are served (bf16: narrow storage), others not
  with pytest.raises(ValueError, match="float32 or bfloat16"):
    cuda_exchange.gather_rows(wide, buf.to(torch.float16), ids)
  assert cuda_exchange.gather_rows(
      wide, buf.to(torch.bfloat16), ids).dtype == torch.bfloat16
  with pytest.raises(ValueError, match="128"):
    cuda_exchange.gather_rows(wide, torch.zeros((8, 256)), ids)
  # a stride short of its physical row is served, on the whole-row buffer
  # only (as the TPU kernel's [rows, 128] buffer)
  odd = tpt.PackedLayout(rows=8, width=200)
  assert tuple(cuda_exchange.gather_rows(
      odd, torch.zeros(tuple(odd.shape)), ids).shape) == (4, 200)
  with pytest.raises(ValueError, match="phys_width"):
    cuda_exchange.gather_rows(odd, torch.zeros((8, 200)), ids)
  with pytest.raises(TypeError, match="int32"):
    cuda_exchange.gather_rows(wide, buf, ids.long())
  with pytest.raises(ValueError, match="device"):
    cuda_exchange.gather_rows(wide, buf, ids.to("meta"))


def test_gather_rows_on_cuda_launches_or_raises():
  """On a CUDA tensor the wrapper launches the kernel: with no card here
  there is no CUDA tensor to give it, and a device the kernel does not
  serve is refused, never answered by the plain version."""
  wide = tpt.PackedLayout(rows=8, width=128)
  with pytest.raises(ValueError, match="no gather kernel"):
    cuda_exchange.gather_rows(wide, torch.zeros((8, 128), device="meta"),
                              torch.zeros((4,), dtype=torch.int32,
                                          device="meta"))


@pytest.mark.parametrize("width,to_k4", [(96, True), (128, True),
                                         (16, False)])
def test_fused_gather_routes_plain_rows_to_k4(monkeypatch, width, to_k4):
  """The fused schedule's per-round gather sends every one-row-per-
  physical-row f32 layout to K4's wrapper, whatever its stride (96
  included), and narrow layouts to ``gather_fused_chunked``: the same
  rows either way."""
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  from distributed_embeddings_torch.parallel import lookup_engine
  calls = []

  def spy(layout, buf, ids):
    calls.append(ids.dtype)
    return cuda_exchange.gather_rows(layout, buf, ids)

  monkeypatch.setattr(lookup_engine, "gather_rows", spy)
  plan = DistEmbeddingStrategy([TableConfig(input_dim=40, output_dim=width)],
                               1, "basic")
  engine = lookup_engine.DistributedLookup(plan)
  rows = 40
  layout = tpt.PackedLayout(rows=rows, width=width)
  rng = np.random.default_rng(width)
  buf = torch.tensor(rng.standard_normal(tuple(layout.shape))
                     .astype(np.float32))
  ids = torch.tensor(_stream(rng, rows, (3, 17)))
  got = engine._fused_gather(layout, buf, ids)
  assert calls == ([torch.int32] if to_k4 else [])
  np.testing.assert_array_equal(got.numpy(),
                                tpt.gather_fused(layout, buf, ids).numpy())


@pytest.mark.parametrize("name", CASE_NAMES[:4])
def test_gather_send_rows_matches_loopback_twin(name):
  buf, ids, chunk = exchange_vectors(name)
  want = np.asarray(gather_send_rows_sim(jnp.asarray(buf), jnp.asarray(ids),
                                         chunk=chunk))
  dst = torch.full((len(ids), buf.shape[1]), float("nan"))
  before = cuda_exchange.send_launches
  got = cuda_exchange.gather_send_rows(torch.tensor(buf),
                                       torch.tensor(ids.astype(np.int32)), dst)
  assert cuda_exchange.send_launches == before  # CPU tensors: plain version
  assert got is dst
  np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
  # the plain version itself, and its own receive buffer
  np.testing.assert_array_equal(
      cuda_exchange.gather_send_rows_plain(
          torch.tensor(buf), torch.tensor(ids.astype(np.int32))).numpy(),
      want)


def test_gather_send_rows_refuses_what_the_kernel_does_not_take():
  buf = torch.zeros((8, 128))
  ids = torch.zeros((4,), dtype=torch.int32)
  with pytest.raises(ValueError, match="128"):
    cuda_exchange.gather_send_rows(torch.zeros((8, 256)), ids)
  with pytest.raises(ValueError, match="float32"):
    cuda_exchange.gather_send_rows(buf.to(torch.bfloat16), ids)
  with pytest.raises(TypeError, match="int32"):
    cuda_exchange.gather_send_rows(buf, ids.long())
  with pytest.raises(ValueError, match="receive buffer"):
    cuda_exchange.gather_send_rows(buf, ids, torch.zeros((5, 128)))
  with pytest.raises(ValueError, match="CPU receive buffer"):
    cuda_exchange.gather_send_rows(buf, ids,
                                   torch.zeros((4, 128), device="meta"))
  with pytest.raises(ValueError, match="no gather-and-push kernel"):
    cuda_exchange.gather_send_rows(buf.to("meta"), ids.to("meta"))

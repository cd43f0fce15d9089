"""Kernel K6, the fused delta build, against the JAX package.

Two layers, on the same numpy inputs:

1. every rule's ``delta_lanes`` twin in the port computes exactly what the
   port's ``delta`` computes, and agrees with the JAX ``delta_lanes``;
2. the port's ``build_delta_rows`` on CPU tensors (its plain version: the
   lookup engine's chain of hotness broadcast, state-lane extraction,
   ``rule.delta`` and ``expand_phys``) against the JAX
   ``build_delta_rows(..., interpret=True)`` over the cases of
   ``tests/test_pallas_delta.py``: Adagrad at widths 16 and 8 with
   stride-wide and window-masked physical state rows, momentum, Adam, and
   hotness 1 and 5. Tolerance rtol 1e-6, atol 2e-7, the JAX test's own:
   the two sides round the rsqrt chains a few ulps apart.

The kernel itself runs on the card only (``chip_smoke.py``: ``kernel
build_delta_rows``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import cuda_delta
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.ops.pallas_delta import build_delta_rows

TOL = dict(rtol=1e-6, atol=2e-7)


@pytest.mark.parametrize("name", ["adagrad", "momentum", "adam"])
def test_delta_lanes_matches_delta_and_jax(name):
  trule = tpt.sparse_rule(name, 0.07)
  jrule = jpt.sparse_rule(name, 0.07)
  rng = np.random.default_rng(0)
  g = rng.standard_normal((64, 16)).astype(np.float32)
  aux = (rng.random((64, trule.n_aux, 16)) + 0.01).astype(np.float32)
  step = 3
  tg, taux = torch.tensor(g), torch.tensor(aux)
  lanes = trule.delta_lanes(tg, [taux[:, a, :] for a in range(trule.n_aux)],
                            step)
  got = torch.cat(lanes, dim=-1)
  assert torch.equal(got, trule.delta(tg, taux, step))
  want = jnp.concatenate(jrule.delta_lanes(
      jnp.asarray(g), [jnp.asarray(aux[:, a, :]) for a in range(jrule.n_aux)],
      jnp.asarray(step, jnp.int32)), axis=-1)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  # the kernel's host scalars: f32 constants, Adam's bias corrections
  scalars = trule.lane_scalars(step)
  assert all(isinstance(s, float) for s in scalars)
  if name == "adam":  # 1 - b1^t, 1 - b2^t as the JAX rule rounds them
    t = jnp.asarray(step + 1, jnp.float32)
    np.testing.assert_allclose(
        scalars[3:5], [float(1.0 - jnp.power(0.9, t)),
                       float(1.0 - jnp.power(0.999, t))], rtol=2e-7)


CASES = [
    ("adagrad", 16, "stride"),   # stride 32, rpp 4
    ("adagrad", 16, "phys"),     # window-masked physical state rows
    ("adagrad", 8, "stride"),    # stride 16, rpp 8
    ("adagrad", 8, "phys"),
    ("momentum", 16, "stride"),
    ("momentum", 16, "phys"),
    ("adam", 16, "stride"),      # stride 48, rpp 2, 32 lanes of padding
    ("adagrad", 64, "stride"),   # stride 128, rpp 1
]


@pytest.mark.parametrize("h", [1, 5])
@pytest.mark.parametrize("name,w,aux_kind", CASES)
def test_plain_build_matches_jax_kernel(name, w, aux_kind, h):
  trule = tpt.sparse_rule(name, 0.03)
  jrule = jpt.sparse_rule(name, 0.03)
  layout = tpt.PackedLayout(rows=1000, width=w, n_aux=trule.n_aux)
  jlayout = jpt.PackedLayout(rows=1000, width=w, n_aux=jrule.n_aux)
  rng = np.random.default_rng(1)
  k = 64
  n = k * h
  rpp = layout.rows_per_phys
  dz = rng.standard_normal((k, w)).astype(np.float32)
  sub = rng.integers(0, rpp, n)
  last = layout.stride if aux_kind == "stride" else layout.phys_width
  aux = (rng.random((n, last)) + 0.01).astype(np.float32)
  if aux_kind == "phys":
    # the masked layout's invariant: one window nonzero per occurrence
    mask = np.zeros((n, last), np.float32)
    win = rng.integers(0, rpp, n)
    for i in range(n):
      mask[i, win[i] * layout.stride:(win[i] + 1) * layout.stride] = 1.0
    aux = aux * mask
  step = 2
  got = cuda_delta.build_delta_rows(
      layout, trule, torch.tensor(dz), torch.tensor(sub), torch.tensor(aux),
      h, step)
  want = build_delta_rows(jlayout, jrule, jnp.asarray(dz),
                          jnp.asarray(sub, jnp.int32), jnp.asarray(aux), h,
                          jnp.asarray(step, jnp.int32), interpret=True)
  assert tuple(got.shape) == (n, 128) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  assert cuda_delta.launches == 0  # CPU tensors never launch the kernel


def test_build_refuses_what_the_kernel_does_not_take():
  rule = tpt.adagrad_rule(0.1)
  layout = tpt.PackedLayout(rows=100, width=16, n_aux=1)
  dz = torch.zeros((4, 16))
  sub = torch.zeros((8,), dtype=torch.int64)
  aux = torch.zeros((8, 32))
  with pytest.raises(ValueError, match="sub must be"):
    cuda_delta.build_delta_rows(layout, rule, dz, sub, aux, 1, 0)
  with pytest.raises(ValueError, match="aux_last"):
    cuda_delta.build_delta_rows(layout, rule, dz, sub, aux[:, :20], 2, 0)
  with pytest.raises(ValueError, match="no delta_lanes"):
    cuda_delta.build_delta_rows(layout, tpt.sgd_rule(0.1), dz, sub, aux, 2, 0)
  decayed = dataclasses.replace(rule, weight_decay=0.01)
  with pytest.raises(ValueError, match="weight_decay"):
    cuda_delta.build_delta_rows(layout, decayed, dz, sub, aux, 2, 0)
  wide = tpt.PackedLayout(rows=100, width=128, n_aux=1)
  with pytest.raises(ValueError, match="128-lane"):
    cuda_delta.build_delta_rows(wide, rule, torch.zeros((4, 128)), sub,
                                torch.zeros((8, 256)), 2, 0)
  # a rule the kernel has no form of is refused at launch, not run plain
  odd = tpt.SparseRule("custom", 1, (0.0,), rule.delta,
                       delta_lanes=rule.delta_lanes,
                       lane_scalars=rule.lane_scalars)
  with pytest.raises(NotImplementedError, match="no form of rule"):
    cuda_delta._launch(layout, odd, dz, sub, aux, 2, 0)


def test_engine_builds_a_class_with_an_empty_part_through_the_kernel_route():
  """An empty bucket does not take its class off K6's route: every part
  of the class goes through ``build_delta_rows`` (its plain version on
  CPU tensors; on the card the wrapper returns the empty part's rows
  without a launch), and the rows are the plain chain's."""
  from unittest import mock

  from distributed_embeddings_torch import train_golden as tg
  from distributed_embeddings_torch.parallel import lookup_engine

  rule = tpt.adagrad_rule(0.03)
  layout = tpt.PackedLayout(rows=1000, width=16, n_aux=1)
  rng = np.random.default_rng(4)
  ids = torch.tensor(rng.integers(0, 1000, (2, 8, 3)))
  dz = torch.tensor(rng.standard_normal((2, 8, 16)).astype(np.float32))
  aux = torch.tensor((rng.random((2, 8, 3, 128)) + 0.01).astype(np.float32))
  empty = (torch.zeros((1, 0), dtype=torch.int64), torch.zeros((1, 0, 16)),
           torch.zeros((1, 0, 32)), 1)
  parts = [empty, (ids, dz, aux, 3)]
  engine = lookup_engine.DistributedLookup(tg.zoo_plan())
  with mock.patch.object(lookup_engine, "build_delta_rows",
                         wraps=lookup_engine.build_delta_rows) as built:
    got_ids, got_rows = engine._stream_of_parts(layout, parts, rule, 2)
  assert built.call_count == 2
  _, sub, _ = tpt._grp_sub(layout, ids.reshape(-1))
  want = cuda_delta.build_delta_rows_plain(layout, rule, dz.reshape(16, 16),
                                           sub, aux.reshape(48, 128), 3, 2)
  assert torch.equal(got_ids, ids.reshape(-1))
  assert torch.equal(got_rows, want)


# every rule at the widths chip_smoke.py holds the kernel to on the card
# (the vector path's multiples of 4 and the general path's 6) that
# CASES leaves out, window-masked state rows, h 1 and 10
WIDTH_CASES = [(name, w) for name in ("adagrad", "momentum", "adam")
               for w in (6, 8, 16, 32, 64)
               if w * (2 + (name == "adam")) <= 128
               and (name, w) not in {(c[0], c[1]) for c in CASES}]


@pytest.mark.parametrize("h", [1, 10])
@pytest.mark.parametrize("name,w", WIDTH_CASES)
def test_plain_build_matches_jax_kernel_at_card_widths(name, w, h):
  test_plain_build_matches_jax_kernel(name, w, "phys", h)

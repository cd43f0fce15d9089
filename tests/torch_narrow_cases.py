"""Shared helpers of the narrow-storage parity tests
(``tests/test_torch_narrow_rules.py``, ``test_torch_narrow_dedup_world4.py``).

bf16 arrays cross as their bits. A cell's error is counted in bf16 ulps
of a magnitude: :func:`ulps` takes the larger of the two values' by
default, or a ``scale`` array (the largest magnitude the cell held over
the reference run, :func:`running_max`). The scale matters for optimizer
state lanes: a momentum lane that nearly cancels (``m + (m' - m)`` with
``m' ≈ 0``) ends orders of magnitude below the values it was computed
from, and an f32-class difference of the cotangents that were added into
it then shows as hundreds of ulps of its own tiny magnitude, while it is
an ulp or two of the operands.
"""

import numpy as np
import pytest
import torch

# every cell within this many bf16 ulps of the JAX run's
ULPS = 4
# the share of cells bit-equal to the JAX run's, world 1 and world 4
BIT_EQUAL_SHARE = 0.999
BIT_EQUAL_SHARE_W4 = 0.995
# the optimizer-state lanes' floor, a share of the lane group's largest
# magnitude (:func:`state_floor`). At world 4 the cotangents of a row's
# occurrences sum over the ranks in another order than the JAX mesh
# step's; a momentum or Adam lane that a step fills from occurrences that
# nearly cancel then differs by up to 7 % of the lane's largest value
# (measured on the world-4 cell, ``tests/test_torch_narrow_dedup_world4.py``;
# the table lanes beside it within an ulp)
STATE_FLOOR = 2.0 ** -10
STATE_FLOOR_W4 = 2.0 ** -3


def f32(x) -> np.ndarray:
  """A bf16 tensor, an ml_dtypes array, bf16 bits or an f32 array as f32
  numpy (``uint16`` arrays are read as bf16 bits)."""
  if isinstance(x, torch.Tensor):
    return x.detach().to(torch.float32).cpu().numpy()
  arr = np.asarray(x)
  if arr.dtype == np.uint16:
    return (arr.astype(np.uint32) << 16).view(np.float32)
  return arr.astype(np.float32)


def bits(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().view(torch.int16).numpy().view(np.uint16)
  arr = np.asarray(x)
  return arr if arr.dtype == np.uint16 else arr.view(np.uint16)


def ulps(got, want, scale=None) -> np.ndarray:
  """|got - want| in bf16 ulps of ``max(|got|, |want|, scale)``."""
  g, w = f32(got), f32(want)
  m = np.maximum(np.abs(g), np.abs(w))
  if scale is not None:
    m = np.maximum(m, scale)
  ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
  return np.abs(g - w) / ulp


def running_max(states) -> np.ndarray:
  """Per cell, the largest magnitude over a run's states (arrays of one
  shape)."""
  out = None
  for s in states:
    a = np.abs(f32(s))
    out = a if out is None else np.maximum(out, a)
  return out


def state_floor(want, width: int, stride: int, rows_per_phys: int,
                floor: float = STATE_FLOOR) -> np.ndarray:
  """Per cell of a packed buffer ``want`` ``[phys_rows, phys_width]``: 0 on
  the table lanes and the padding, and on each optimizer-state lane group
  ``floor`` times the group's largest magnitude."""
  w = f32(want)
  out = np.zeros_like(w)
  lanes = np.arange(w.shape[1])
  within, window = lanes % stride, lanes // stride
  live = window < rows_per_phys
  for s in range(1, stride // width):
    group = live & (within >= s * width) & (within < (s + 1) * width)
    if group.any():
      out[:, group] = floor * np.abs(w[:, group]).max()
  return out


def compare_cells(pairs, share_min: float, limit: int = ULPS) -> dict:
  """``pairs``: ``(label, got, want, scale)``. Asserts every cell within
  ``limit`` ulps and at least ``share_min`` of all cells bit-equal;
  returns the share and the worst cell."""
  cells = equal = 0
  worst = 0.0
  for label, got, want, scale in pairs:
    u = ulps(got, want, scale)
    worst = max(worst, float(u.max()) if u.size else 0.0)
    assert u.size == 0 or u.max() <= limit, f"{label}: {u.max()} ulps"
    cells += u.size
    equal += int((bits(got) == bits(want)).sum())
  share = equal / max(cells, 1)
  assert share >= share_min, f"{share:.6%} bit-equal"
  return {"share": share, "worst": worst, "cells": cells}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  """One intra-op thread for a module of many small ops (bf16 adds level
  by level, a few hundred rows each): with more, each op's threads spin
  against the other test workers' and the module runs tens of times
  slower on a loaded machine. Restored after the module."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)

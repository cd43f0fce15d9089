"""K2 and K3: the DLRM pairwise interaction, forward and backward (CUDA
kernels + plain forms).

K2-fwd replaces ``distributed_embeddings_tpu/ops/pallas_interact.py:
interact_parts_fwd``. Its kernel (``csrc/interact_fwd.cu``) takes the f
per-table ``[B, D]`` bf16 parts and writes ``[B, P]`` f32 activations:
for each pair ``(p, q)`` of ``np.tril_indices(f, k)``, the f32-accumulated
dot of the two rows, rounded to bf16 and widened back to f32 — the TPU
kernel's function (its half-weight selection matrix reproduces the
bf16-rounded pair value exactly, ``models/dlrm.py:_tril_select_np``).

The kernel computes each sample's ``X X^T`` on the tensor cores, only the
output tiles that hold a pair, in units of :func:`fwd_geometry` (pure
Python; the library's ``interact_fwd_geometry`` reads back what the
launcher lays out).

K2-bwd replaces ``pallas_interact.py:interact_parts_bwd``. Its kernel
(``csrc/interact_bwd.cu``) takes the ``[B, P]`` f32 cotangent and the f
bf16 parts and writes the f bf16 part cotangents ``bf16(sum_q c_pq x_q)``
with ``c`` the symmetric coefficients of ``bf16(d_acts)`` (doubled on the
diagonal) — the TPU kernel's ``2 * bf16(d_acts . M^T) @ F``.

K3-fwd and K3-bwd replace ``pallas_interact.py:interact_fwd`` and
``:interact_bwd``: K2's two functions on one flat ``[B, F, D]`` bf16 input
(the ``[B, F*D]`` concat) and, backward, one flat ``[B, F, D]`` bf16
output (``csrc/interact_flat_fwd.cu``, ``csrc/interact_flat_bwd.cu``; the
maths of both pairs is written once, in ``csrc/interact_common.cuh``). No
JAX path launches the TPU pair (``models/dlrm.py:dot_interact`` takes the
per-part kernels wherever the flat ones could run), so the port keeps
K2 on every path and K3 is held at kernel level.

:func:`interact_parts_fwd` / :func:`interact_parts_bwd` and
:func:`interact_flat_fwd` / :func:`interact_flat_bwd` run the kernels for
CUDA tensors and the plain versions for CPU tensors. On CUDA they launch
the kernel or raise: there is no fallback. ``launches``,
``bwd_launches``, ``flat_launches`` and ``flat_bwd_launches`` count kernel
launches (the main path's proof that it went through the kernels).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

MAX_PARTS = 32
SMEM_MAX = 227 * 1024         # H100 opt-in limit per block
MAX_SAMPLES_PER_BLOCK = 8
# the forward's unit: a ring of this many stages, k tiles of at most this
# many columns, all within this much shared memory (three blocks on an
# SM's 228 KB, each with its 1 KB reserve)
FWD_STAGES = 2
FWD_MAX_K_TILE = 128
FWD_SMEM_TARGET = 75 * 1024
# the backward's unit: at most this many columns, stage within this much
BWD_MAX_D_TILE = 128
BWD_SMEM_TARGET = 100 * 1024

launches = 0
bwd_launches = 0
flat_launches = 0
flat_bwd_launches = 0


def tril_pairs(f: int, k: int):
  """The ``(rows, cols)`` of the lower-triangle pairs, in output order."""
  return np.tril_indices(f, k=k)


def interact_parts_fwd_plain(parts: Sequence[torch.Tensor],
                             k: int) -> torch.Tensor:
  """Plain PyTorch version: stack, f32 batched product, lower-triangle
  index, round to bf16, widen to f32."""
  feats = torch.stack([p.float() for p in parts], dim=1)   # [B, F, D]
  inter = torch.bmm(feats, feats.transpose(1, 2))           # [B, F, F]
  rows, cols = tril_pairs(len(parts), k)
  idx = torch.as_tensor(rows * len(parts) + cols, device=inter.device)
  acts = inter.flatten(1).index_select(1, idx)
  return acts.to(torch.bfloat16).float()


class FwdGeometry(NamedTuple):
  """The forward kernel's unit and its shared-memory layout
  (``csrc/interact_common.cuh: fwd_geo``): ``ns`` samples a unit, their
  rows padded to ``xr`` (16 or 32, the MMA's M and N), staged ``kt``
  columns (a k tile, a multiple of 16) at a time in ``nkt`` tiles, ``re``
  bf16 elements a staged row; ``tiles``, the 16 x 8 output tiles ``(m,
  n)`` the kernel issues; ``x_stage`` bytes a stage of rows (the ring has
  ``FWD_STAGES``), ``o_stage`` bytes of its output stage, ``smem`` bytes
  in all."""
  ns: int
  xr: int
  kt: int
  nkt: int
  re: int
  tiles: Tuple[Tuple[int, int], ...]
  x_stage: int
  o_stage: int
  smem: int


def fwd_tiles(f: int, k: int) -> Tuple[Tuple[int, int], ...]:
  """The output tiles ``(m, n)`` (rows ``16m .. 16m + 15``, columns ``8n ..
  8n + 7`` of the padded ``X X^T``) that hold a pair ``(p, q)`` of
  ``tril_indices(f, k)``; every pair lies in exactly one of them."""
  xr = 16 if f <= 16 else 32
  tiles = []
  for m in range(xr // 16):
    pmax = min(m * 16 + 15, f - 1)
    if m * 16 > pmax:
      continue
    tiles += [(m, n) for n in range(xr // 8) if n * 8 <= pmax + k]
  return tuple(tiles)


def fwd_geometry(f: int, d: int, k: int) -> FwdGeometry:
  """The forward kernel's unit for ``f`` features of ``d`` lanes: as many
  samples as keep the ring of ``FWD_STAGES`` k-tile stages and the output
  stage within ``FWD_SMEM_TARGET``, 1 to 8 (one warp a sample), a
  multiple of 4 where that leaves at least 4 (so that a unit's outputs
  start 16-byte aligned for any P). Rows are padded to 16 or 32, columns
  to a multiple of 16 and staged in k tiles of at most ``FWD_MAX_K_TILE``,
  so one sample's stage is bounded and every ``d`` is served."""
  if k not in (-1, 0):
    raise ValueError(f"k must be -1 or 0, got {k}")
  if not 1 <= f <= MAX_PARTS or d <= 0 or d % 8:
    raise ValueError(f"the forward kernel takes 1..{MAX_PARTS} features of "
                     f"a multiple of 8 lanes, got f={f}, d={d}")
  xr = 16 if f <= 16 else 32
  kt = min(-(-d // 16) * 16, FWD_MAX_K_TILE)
  re = kt + 8
  npair = len(tril_pairs(f, k)[0])

  def layout(ns):
    x_stage = ns * xr * re * 2
    o_stage = -(-((ns * npair + 4) * 4) // 16) * 16
    return x_stage, o_stage, FWD_STAGES * x_stage + o_stage

  ns = MAX_SAMPLES_PER_BLOCK
  while ns > 1 and layout(ns)[2] > FWD_SMEM_TARGET:
    ns -= 1
  if ns >= 4:
    ns -= ns % 4
  x_stage, o_stage, smem = layout(ns)
  return FwdGeometry(ns, xr, kt, -(-d // kt), re, fwd_tiles(f, k), x_stage,
                     o_stage, smem)


def _check_parts(parts: Sequence[torch.Tensor], k: int):
  if k not in (-1, 0):
    raise ValueError(f"k must be -1 or 0, got {k}")
  f = len(parts)
  if f < 1 or f > MAX_PARTS:
    raise ValueError(f"interact_parts_fwd takes 1..{MAX_PARTS} parts, "
                     f"got {f}")
  b, d = parts[0].shape
  for p in parts:
    if p.dtype != torch.bfloat16:
      raise TypeError(f"interact_parts_fwd takes bf16 parts, got {p.dtype}")
    if p.shape != (b, d):
      raise ValueError(f"parts must all be [{b}, {d}], got {tuple(p.shape)}")
    if p.device != parts[0].device:
      raise ValueError("parts must all lie on one device")
    if not p.is_contiguous():
      raise ValueError("interact_parts_fwd takes contiguous parts")
  return f, b, d


def _check_kernel_rows(t: torch.Tensor, d: int) -> None:
  """What the kernels need of a feature tensor beyond the plain version:
  rows of a multiple of 8 bf16 lanes, 16-byte aligned."""
  if d % 8:
    raise ValueError(f"the kernel takes D % 8 == 0, got D={d}")
  if t.data_ptr() % 16:
    raise ValueError("the kernel reads 16-byte aligned rows")


def _check_cotangent(d_acts: torch.Tensor, like: torch.Tensor, b: int,
                     npair: int) -> None:
  if d_acts.dtype != torch.float32:
    raise TypeError(f"the interaction backward takes an f32 cotangent, got "
                    f"{d_acts.dtype}")
  if tuple(d_acts.shape) != (b, npair):
    raise ValueError(f"cotangent must be [{b}, {npair}], got "
                     f"{tuple(d_acts.shape)}")
  if d_acts.device != like.device or not d_acts.is_contiguous():
    raise ValueError("the cotangent must be contiguous and on the features' "
                     "device")


# the launchers' argument lists, the stream (last) left out
_FWD_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6


def _call(name: str, argtypes, args, dev: torch.device) -> None:
  """Launch kernel ``name`` (its ``<name>_launch``) on ``dev``'s current
  stream; raises on a CUDA error."""
  from ._build import load
  fn = getattr(load(name), f"{name}_launch")
  fn.argtypes = list(argtypes) + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  stream = torch.cuda.current_stream(dev).cuda_stream
  with torch.cuda.device(dev):
    err = fn(*args, stream)
  if err != 0:
    raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _pointers(tensors: Sequence[torch.Tensor]) -> ctypes.c_void_p:
  """A host array of the tensors' device pointers."""
  ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
  return ctypes.cast(ptrs, ctypes.c_void_p)


def _launch(parts: Sequence[torch.Tensor], k: int, f: int, b: int,
            d: int) -> torch.Tensor:
  global launches
  for p in parts:
    _check_kernel_rows(p, d)
  npair = len(tril_pairs(f, k)[0])
  dev = parts[0].device
  out = torch.empty((b, npair), dtype=torch.float32, device=dev)
  _call("interact_fwd", _FWD_ARGS,
        (_pointers(parts), f, b, d, k, fwd_geometry(f, d, k).ns,
         out.data_ptr()), dev)
  launches += 1
  return out


def interact_parts_fwd(parts: Sequence[torch.Tensor], k: int = -1
                       ) -> torch.Tensor:
  """f x ``[B, D]`` bf16 parts -> ``[B, P]`` f32 pair activations.

  ``k = -1`` pairs distinct features; ``k = 0`` adds self-interaction.
  CPU tensors take the plain version; CUDA tensors launch the kernel."""
  f, b, d = _check_parts(parts, k)
  if parts[0].device.type == "cpu":
    return interact_parts_fwd_plain(parts, k)
  if parts[0].device.type != "cuda":
    raise ValueError(f"no interaction kernel for device {parts[0].device}")
  return _launch(parts, k, f, b, d)


# ---------------------------------------------------------------------------
# K2-bwd
# ---------------------------------------------------------------------------


def pair_coefficients(d_acts: torch.Tensor, f: int, k: int) -> torch.Tensor:
  """``[B, P]`` cotangent -> ``[B, F, F]`` f32 symmetric coefficients of
  ``bf16(d_acts)``: each pair's value in both of its cells, twice it on
  the diagonal (``k = 0``), zero diagonal for ``k = -1``."""
  da = d_acts.to(torch.bfloat16).float()
  rows, cols = tril_pairs(f, k)
  rows_t = torch.as_tensor(rows, device=d_acts.device)
  cols_t = torch.as_tensor(cols, device=d_acts.device)
  coef = torch.zeros((d_acts.shape[0], f, f), dtype=torch.float32,
                     device=d_acts.device)
  coef[:, rows_t, cols_t] = da
  coef[:, cols_t, rows_t] = da
  if k == 0:
    diag = torch.as_tensor(np.flatnonzero(rows == cols), device=d_acts.device)
    idx = rows_t[diag]
    coef[:, idx, idx] = 2.0 * da[:, diag]
  return coef


def interact_parts_bwd_plain(d_acts: torch.Tensor,
                             parts: Sequence[torch.Tensor],
                             k: int) -> Tuple[torch.Tensor, ...]:
  """Plain PyTorch version: the coefficients by index assignment, one f32
  batched product, rounded to bf16 and split per part."""
  f = len(parts)
  coef = pair_coefficients(d_acts, f, k)
  feats = torch.stack([p.float() for p in parts], dim=1)   # [B, F, D]
  out = torch.bmm(coef, feats).to(torch.bfloat16)
  return tuple(out[:, p].contiguous() for p in range(f))


def bwd_geometry(f: int, d: int) -> Tuple[int, int]:
  """The backward kernel's unit: ``(samples, columns)``. Columns: ``D``
  up to 128 (wider ``D`` loops over 128-column tiles). Samples: as many as
  keep a block's double-buffered stage, its bf16 coefficients and its pair
  table within ``BWD_SMEM_TARGET`` (two blocks per SM), 1 to 8.
  ``csrc/interact_common.cuh: bwd_geo`` lays the same bytes out."""
  dt = min(d, BWD_MAX_D_TILE)
  xr = 16 if f <= 16 else 32                      # rows padded for the MMA
  row = dt + (8 if (dt // 8) % 2 == 0 else 16)    # bf16 elements per row
  npair_max = f * (f + 1) // 2
  per_sample = (2 * xr * row * 2                  # two stages of rows
                + 2 * npair_max * 4               # two cotangent blocks
                + xr * (xr + 8) * 2)              # bf16 coefficients
  fixed = 2 * 32 + 2 * npair_max + 16             # alignment, pair table
  fit = (BWD_SMEM_TARGET - fixed) // per_sample
  return max(1, min(MAX_SAMPLES_PER_BLOCK, fit)), dt


def _launch_bwd(d_acts: torch.Tensor, parts: Sequence[torch.Tensor], k: int,
                f: int, b: int, d: int) -> Tuple[torch.Tensor, ...]:
  global bwd_launches
  for p in parts:
    _check_kernel_rows(p, d)
  dev = parts[0].device
  outs = [torch.empty((b, d), dtype=torch.bfloat16, device=dev)
          for _ in range(f)]
  _call("interact_bwd", _BWD_ARGS,
        (d_acts.data_ptr(), _pointers(parts), _pointers(outs), f, b, d, k,
         *bwd_geometry(f, d)), dev)
  bwd_launches += 1
  return tuple(outs)


def interact_parts_bwd(d_acts: torch.Tensor, parts: Sequence[torch.Tensor],
                       k: int = -1) -> Tuple[torch.Tensor, ...]:
  """``[B, P]`` f32 cotangent + f x ``[B, D]`` bf16 parts -> f x ``[B, D]``
  bf16 part cotangents. CPU tensors take the plain version; CUDA tensors
  launch the kernel."""
  f, b, d = _check_parts(parts, k)
  _check_cotangent(d_acts, parts[0], b, len(tril_pairs(f, k)[0]))
  if parts[0].device.type == "cpu":
    return interact_parts_bwd_plain(d_acts, parts, k)
  if parts[0].device.type != "cuda":
    raise ValueError(f"no interaction kernel for device {parts[0].device}")
  return _launch_bwd(d_acts, parts, k, f, b, d)


# ---------------------------------------------------------------------------
# K3: the same two functions on one flat [B, F, D] input
# ---------------------------------------------------------------------------


def _check_flat(feats: torch.Tensor, k: int):
  if k not in (-1, 0):
    raise ValueError(f"k must be -1 or 0, got {k}")
  if feats.dim() != 3:
    raise ValueError(f"feats must be [B, F, D], got {tuple(feats.shape)}")
  b, f, d = feats.shape
  if f < 1 or f > MAX_PARTS:
    raise ValueError(f"the flat interaction takes 1..{MAX_PARTS} features, "
                     f"got {f}")
  if feats.dtype != torch.bfloat16:
    raise TypeError(f"the flat interaction takes bf16 features, got "
                    f"{feats.dtype}")
  if not feats.is_contiguous():
    raise ValueError("the flat interaction takes contiguous features")
  return b, f, d


def interact_flat_fwd_plain(feats: torch.Tensor, k: int) -> torch.Tensor:
  """Plain PyTorch version of K3-fwd: f32 batched product, lower-triangle
  index, round to bf16, widen to f32."""
  b, f, _ = feats.shape
  x = feats.float()
  inter = torch.bmm(x, x.transpose(1, 2))                  # [B, F, F]
  rows, cols = tril_pairs(f, k)
  idx = torch.as_tensor(rows * f + cols, device=inter.device)
  return inter.reshape(b, f * f).index_select(1, idx) \
      .to(torch.bfloat16).float()


def interact_flat_fwd(feats: torch.Tensor, k: int = -1) -> torch.Tensor:
  """``[B, F, D]`` bf16 features -> ``[B, P]`` f32 pair activations (K3-fwd).
  CPU tensors take the plain version; CUDA tensors launch the kernel."""
  b, f, d = _check_flat(feats, k)
  if feats.device.type == "cpu":
    return interact_flat_fwd_plain(feats, k)
  if feats.device.type != "cuda":
    raise ValueError(f"no interaction kernel for device {feats.device}")
  global flat_launches
  _check_kernel_rows(feats, d)
  npair = len(tril_pairs(f, k)[0])
  out = torch.empty((b, npair), dtype=torch.float32, device=feats.device)
  _call("interact_flat_fwd", _FWD_ARGS,
        (feats.data_ptr(), f, b, d, k, fwd_geometry(f, d, k).ns,
         out.data_ptr()), feats.device)
  flat_launches += 1
  return out


def interact_flat_bwd_plain(d_acts: torch.Tensor, feats: torch.Tensor,
                            k: int) -> torch.Tensor:
  """Plain PyTorch version of K3-bwd: the symmetric coefficients, one f32
  batched product, rounded to bf16: ``[B, F, D]``."""
  coef = pair_coefficients(d_acts, feats.shape[1], k)
  return torch.bmm(coef, feats.float()).to(torch.bfloat16)


def interact_flat_bwd(d_acts: torch.Tensor, feats: torch.Tensor,
                      k: int = -1) -> torch.Tensor:
  """``[B, P]`` f32 cotangent + ``[B, F, D]`` bf16 features -> ``[B, F, D]``
  bf16 feature cotangent (K3-bwd). CPU tensors take the plain version;
  CUDA tensors launch the kernel."""
  b, f, d = _check_flat(feats, k)
  _check_cotangent(d_acts, feats, b, len(tril_pairs(f, k)[0]))
  if feats.device.type == "cpu":
    return interact_flat_bwd_plain(d_acts, feats, k)
  if feats.device.type != "cuda":
    raise ValueError(f"no interaction kernel for device {feats.device}")
  global flat_bwd_launches
  _check_kernel_rows(feats, d)
  out = torch.empty_like(feats)
  _call("interact_flat_bwd", _BWD_ARGS,
        (d_acts.data_ptr(), feats.data_ptr(), out.data_ptr(), f, b, d, k,
         *bwd_geometry(f, d)), feats.device)
  flat_bwd_launches += 1
  return out

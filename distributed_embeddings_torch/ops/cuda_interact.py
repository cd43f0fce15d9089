"""K2: the DLRM pairwise interaction, forward and backward (CUDA kernels +
plain forms).

K2-fwd replaces ``distributed_embeddings_tpu/ops/pallas_interact.py:
interact_parts_fwd``. Its kernel (``csrc/interact_fwd.cu``) takes the f
per-table ``[B, D]`` bf16 parts and writes ``[B, P]`` f32 activations:
for each pair ``(p, q)`` of ``np.tril_indices(f, k)``, the f32-accumulated
dot of the two rows, rounded to bf16 and widened back to f32 — the TPU
kernel's function (its half-weight selection matrix reproduces the
bf16-rounded pair value exactly, ``models/dlrm.py:_tril_select_np``).

K2-bwd replaces ``pallas_interact.py:interact_parts_bwd``. Its kernel
(``csrc/interact_bwd.cu``) takes the ``[B, P]`` f32 cotangent and the f
bf16 parts and writes the f bf16 part cotangents ``bf16(sum_q c_pq x_q)``
with ``c`` the symmetric coefficients of ``bf16(d_acts)`` (doubled on the
diagonal) — the TPU kernel's ``2 * bf16(d_acts . M^T) @ F``.

:func:`interact_parts_fwd` / :func:`interact_parts_bwd` run the kernels for
CUDA tensors and the plain versions for CPU tensors. On CUDA they launch
the kernel or raise: there is no fallback. ``launches`` and
``bwd_launches`` count kernel launches (the main path's proof that it went
through the kernels).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

MAX_PARTS = 32
# bf16 elements of padding per row the kernel stages in shared memory
ROW_PAD = 8
SMEM_TARGET = 48 * 1024       # default dynamic shared memory per block
SMEM_MAX = 227 * 1024         # H100 opt-in limit per block
MAX_SAMPLES_PER_BLOCK = 8

launches = 0
bwd_launches = 0


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


def samples_per_block(f: int, d: int) -> int:
  """Samples one block stages: as many as fit the default 48 KB of shared
  memory, 1 to 8; raises when one sample alone exceeds the card's
  per-block limit."""
  per_sample = f * (d + ROW_PAD) * 2
  npair_max = f * (f + 1) // 2
  if per_sample + 2 * npair_max > SMEM_MAX:
    raise ValueError(
        f"interact_parts_fwd: one sample's {f} x {d} bf16 rows need "
        f"{per_sample:,} B of shared memory, over the {SMEM_MAX:,} B a "
        "block may use")
  return max(1, min(MAX_SAMPLES_PER_BLOCK, SMEM_TARGET // per_sample))


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


def _launch(parts: Sequence[torch.Tensor], k: int, f: int, b: int,
            d: int) -> torch.Tensor:
  from ._build import load
  global launches
  if d % 8:
    raise ValueError(f"the kernel takes D % 8 == 0, got D={d}")
  for p in parts:
    if p.data_ptr() % 16:
      raise ValueError("the kernel reads 16-byte aligned parts")
  spb = samples_per_block(f, d)
  npair = len(tril_pairs(f, k)[0])
  dev = parts[0].device
  out = torch.empty((b, npair), dtype=torch.float32, device=dev)
  lib = load("interact_fwd")
  fn = lib.interact_fwd_launch
  fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p]
  fn.restype = ctypes.c_int
  ptrs = (ctypes.c_void_p * f)(*[p.data_ptr() for p in parts])
  stream = torch.cuda.current_stream(dev).cuda_stream
  with torch.cuda.device(dev):
    err = fn(ctypes.cast(ptrs, ctypes.c_void_p), f, b, d, k, spb,
             out.data_ptr(), stream)
  if err != 0:
    raise RuntimeError(f"interact_fwd launch failed: cudaError {err}")
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


def bwd_samples_per_block(f: int, d: int) -> int:
  """Samples one backward block stages (rows + f32 coefficients): as many
  as fit the default 48 KB of shared memory, 1 to 8; raises when one
  sample alone exceeds the card's per-block limit."""
  per_sample = f * (d + ROW_PAD) * 2 + f * f * 4
  npair_max = f * (f + 1) // 2
  if per_sample + 2 * npair_max > SMEM_MAX:
    raise ValueError(
        f"interact_parts_bwd: one sample's {f} x {d} bf16 rows and {f} x "
        f"{f} coefficients need {per_sample:,} B of shared memory, over "
        f"the {SMEM_MAX:,} B a block may use")
  fit = (SMEM_TARGET - 2 * npair_max) // per_sample
  return max(1, min(MAX_SAMPLES_PER_BLOCK, fit))


def _launch_bwd(d_acts: torch.Tensor, parts: Sequence[torch.Tensor], k: int,
                f: int, b: int, d: int) -> Tuple[torch.Tensor, ...]:
  from ._build import load
  global bwd_launches
  if d % 8:
    raise ValueError(f"the kernel takes D % 8 == 0, got D={d}")
  for p in parts:
    if p.data_ptr() % 16:
      raise ValueError("the kernel reads 16-byte aligned parts")
  spb = bwd_samples_per_block(f, d)
  dev = parts[0].device
  outs = [torch.empty((b, d), dtype=torch.bfloat16, device=dev)
          for _ in range(f)]
  lib = load("interact_bwd")
  fn = lib.interact_bwd_launch
  fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  in_ptrs = (ctypes.c_void_p * f)(*[p.data_ptr() for p in parts])
  out_ptrs = (ctypes.c_void_p * f)(*[o.data_ptr() for o in outs])
  stream = torch.cuda.current_stream(dev).cuda_stream
  with torch.cuda.device(dev):
    err = fn(d_acts.data_ptr(), ctypes.cast(in_ptrs, ctypes.c_void_p),
             ctypes.cast(out_ptrs, ctypes.c_void_p), f, b, d, k, spb, stream)
  if err != 0:
    raise RuntimeError(f"interact_bwd launch failed: cudaError {err}")
  bwd_launches += 1
  return tuple(outs)


def interact_parts_bwd(d_acts: torch.Tensor, parts: Sequence[torch.Tensor],
                       k: int = -1) -> Tuple[torch.Tensor, ...]:
  """``[B, P]`` f32 cotangent + f x ``[B, D]`` bf16 parts -> f x ``[B, D]``
  bf16 part cotangents. CPU tensors take the plain version; CUDA tensors
  launch the kernel."""
  f, b, d = _check_parts(parts, k)
  npair = len(tril_pairs(f, k)[0])
  if d_acts.dtype != torch.float32:
    raise TypeError(f"interact_parts_bwd takes an f32 cotangent, got "
                    f"{d_acts.dtype}")
  if tuple(d_acts.shape) != (b, npair):
    raise ValueError(f"cotangent must be [{b}, {npair}], got "
                     f"{tuple(d_acts.shape)}")
  if d_acts.device != parts[0].device or not d_acts.is_contiguous():
    raise ValueError("the cotangent must be contiguous and on the parts' "
                     "device")
  if parts[0].device.type == "cpu":
    return interact_parts_bwd_plain(d_acts, parts, k)
  if parts[0].device.type != "cuda":
    raise ValueError(f"no interaction kernel for device {parts[0].device}")
  return _launch_bwd(d_acts, parts, k, f, b, d)

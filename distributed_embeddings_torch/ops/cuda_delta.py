"""K6: the fused delta build of the sparse apply (CUDA kernel + plain form).

Replaces ``distributed_embeddings_tpu/ops/pallas_delta.py:
build_delta_rows``. For one bucket of a narrow class with optimizer state
it turns the per-sample cotangents ``dz [K, w]``, each occurrence's
sub-row window ``sub [K*h]`` and the forward-saved rows ``aux [K*h,
aux_last]`` into the physical-row updates ``[K*h, 128]`` that the apply
(kernel K1) adds into the packed buffer. Four steps in one pass:

1. the hotness broadcast (occurrence ``i`` reads sample ``i // h``);
2. the optimizer-state lanes of each occurrence: lanes ``[w, stride)`` of
   a stride-wide fused row (``aux_last == stride``), or the sum of the
   ``rpp`` windows' lanes of a window-masked physical row (``aux_last ==
   128``; exactly one window is nonzero);
3. the rule's delta (``rule.delta_lanes``: Adagrad, momentum or Adam);
4. the window expansion: the delta in window ``sub``, zeros in the other
   windows and the lane padding.

:func:`build_delta_rows` runs the kernel (``csrc/build_delta_rows.cu``)
for CUDA tensors and the plain version :func:`build_delta_rows_plain`
(broadcast, ``residual_lanes``, ``rule.delta``, ``expand_phys``) for CPU
tensors. On CUDA it launches the kernel or raises: there is no fallback.
The plain version is also the one place the lookup engine writes this
chain: it builds the update rows of the classes whose rule or layout the
kernel does not take (no lane form, rows wider than 128 lanes, bf16).
``launches`` counts kernel launches. No single PyTorch call computes this
function.
"""

from __future__ import annotations

import ctypes

import torch

from .packed_table import PackedLayout, SparseRule, expand_phys, residual_lanes

PHYS = 128

launches = 0

# the rules the kernel has, by name -> its template index
_RULE_IDS = {"adagrad": 0, "momentum": 1, "adam": 2}
_N_SCALARS = 6


def _check(layout: PackedLayout, rule: SparseRule, dz: torch.Tensor,
           sub: torch.Tensor, aux, h: int) -> None:
  if layout.phys_width != PHYS:
    raise ValueError(f"the delta build serves {PHYS}-lane physical rows, got "
                     f"phys_width={layout.phys_width}")
  if rule.delta_lanes is None or rule.lane_scalars is None:
    raise ValueError(f"rule {rule.name!r} has no delta_lanes / lane_scalars")
  if rule.linear_scale is not None or rule.weight_decay:
    raise ValueError("the delta build takes rules without linear_scale or "
                     "weight_decay (those stay on the elementwise chain)")
  if dz.dim() != 2 or dz.shape[1] != layout.width or dz.dtype != torch.float32:
    raise ValueError(f"dz must be f32 [K, {layout.width}], got "
                     f"{dz.dtype} {tuple(dz.shape)}")
  n = dz.shape[0] * h
  if h < 1 or tuple(sub.shape) != (n,) or sub.dtype != torch.int64:
    raise ValueError(f"sub must be int64 [K*h] = [{n}], got {sub.dtype} "
                     f"{tuple(sub.shape)} (h={h})")
  if rule.n_aux:
    if aux is None or aux.dim() != 2 or aux.shape[0] != n \
        or aux.dtype != torch.float32:
      raise ValueError(f"aux must be f32 [K*h, aux_last] = [{n}, ...]")
    if aux.shape[1] not in (layout.stride, layout.phys_width):
      raise ValueError(f"aux_last must be the stride ({layout.stride}) or "
                       f"phys_width ({layout.phys_width}), got {aux.shape[1]}")
    if aux.shape[1] != layout.stride \
        and aux.shape[1] < layout.rows_per_phys * layout.stride:
      raise ValueError("masked physical aux rows must hold every window")
  if not (dz.device == sub.device
          and (aux is None or aux.device == dz.device)):
    raise ValueError("dz, sub and aux must lie on one device")


def build_delta_rows_plain(layout: PackedLayout, rule: SparseRule,
                           dz: torch.Tensor, sub: torch.Tensor, aux, h: int,
                           step) -> torch.Tensor:
  """Plain PyTorch version: the engine's chain, ``[K*h, 128]`` f32."""
  k, w = dz.shape
  n = k * h
  g = dz[:, None, :].expand(k, h, w).reshape(n, w)
  aux_r = None
  if rule.n_aux:
    aux_r = residual_lanes(layout, aux, w, layout.stride).reshape(
        n, rule.n_aux, w)
  return expand_phys(layout, rule.delta(g, aux_r, step), sub)


def _launch(layout: PackedLayout, rule: SparseRule, dz: torch.Tensor,
            sub: torch.Tensor, aux, h: int, step) -> torch.Tensor:
  from ._build import load
  global launches
  rule_id = _RULE_IDS.get(rule.name)
  if rule_id is None or rule.n_aux not in (1, 2):
    raise NotImplementedError(
        f"the delta-build kernel has no form of rule {rule.name!r}; it "
        f"builds {sorted(_RULE_IDS)}")
  scalars = list(rule.lane_scalars(step))
  scalars += [0.0] * (_N_SCALARS - len(scalars))
  dz = dz.contiguous()
  sub = sub.contiguous()
  aux = aux.contiguous()
  n = sub.shape[0]
  out = torch.empty((n, PHYS), dtype=torch.float32, device=dz.device)
  if n == 0:
    return out  # nothing to build: no launch
  if out.data_ptr() % 16:
    raise ValueError("the kernel writes 16-byte aligned rows")
  lib = load("build_delta_rows")
  fn = lib.build_delta_rows_launch
  fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_void_p]
                 + [ctypes.c_float] * _N_SCALARS + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  stream = torch.cuda.current_stream(dz.device).cuda_stream
  with torch.cuda.device(dz.device):
    err = fn(rule_id, rule.n_aux, dz.data_ptr(), layout.width,
             sub.data_ptr(), aux.data_ptr(), aux.shape[1], layout.stride,
             layout.rows_per_phys, h, n, out.data_ptr(), *scalars, stream)
  if err != 0:
    raise RuntimeError(f"build_delta_rows launch failed: cudaError {err}")
  launches += 1
  return out


def build_delta_rows(layout: PackedLayout, rule: SparseRule, dz: torch.Tensor,
                     sub: torch.Tensor, aux, h: int, step) -> torch.Tensor:
  """``dz [K, w]`` per-sample cotangents, ``sub [K*h]`` int64 window
  indices, ``aux [K*h, aux_last]`` forward-saved rows (stride-wide or
  window-masked physical rows) -> ``[K*h, 128]`` f32 physical-row updates
  (invalid ids are dropped later, by the apply). CPU tensors take the
  plain version; CUDA tensors launch the kernel."""
  _check(layout, rule, dz, sub, aux, h)
  if dz.device.type == "cpu":
    return build_delta_rows_plain(layout, rule, dz, sub, aux, h, step)
  if dz.device.type != "cuda":
    raise ValueError(f"no delta-build kernel for device {dz.device}")
  return _launch(layout, rule, dz, sub, aux, h, step)

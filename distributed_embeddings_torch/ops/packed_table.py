"""Lane-packed table storage (PyTorch port of ``ops/packed_table.py``).

The packed layout stores several narrow logical rows per 128-lane
physical row, with a rule's per-row optimizer state interleaved beside
each table row:

    physical row (128 lanes):
    [ t[4k] | acc[4k] | t[4k+1] | acc[4k+1] | ... ]   (width 16, 1 aux slot)

The port keeps the layout bit-for-bit, so a buffer packed by either
package reads the same in the other (``convert.py`` hands buffers across
as numpy arrays). Ids outside ``[0, rows)`` are padding sentinels: the
gather returns all-zero rows for them and the scatter drops them.

Ported here: the layout, the fused gather (with the window-masked
physical-row form of narrow multi-hot classes), the uniform packed init,
the fused scatter-add (:func:`scatter_add_fused`, kernel K1 on the card)
and the ``sgd``/``adagrad``/``momentum``/``adam`` rules with the
``delta_lanes`` twins and host scalars that the fused delta build
(``ops/cuda_delta.py``, kernel K6) takes, and the host cold-store helpers
of the tiering subsystem (numpy images in the same physical layout:
:func:`host_gather_rows`, :func:`host_scatter_rows`, the numpy draw
:func:`init_host_store` and :func:`init_host_store_device`, which draws on
the card chunk by chunk and downloads each chunk into the image).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

LANES = 128
# physical rows drawn per step by init_packed_uniform (bounds its
# temporaries on multi-GB buffers)
_INIT_CHUNK_PHYS = 1 << 16


@dataclasses.dataclass(frozen=True)
class PackedLayout:
  """Physical layout of one logical ``[rows, width]`` table with ``n_aux``
  interleaved per-row optimizer-state rows."""

  rows: int
  width: int
  n_aux: int = 0

  @property
  def stride(self) -> int:
    """Lanes per logical row: table row + its aux rows."""
    return self.width * (1 + self.n_aux)

  @property
  def rows_per_phys(self) -> int:
    return max(1, LANES // self.stride)

  @property
  def phys_width(self) -> int:
    return max(LANES, -(-self.stride // LANES) * LANES)

  @property
  def phys_rows(self) -> int:
    return -(-self.rows // self.rows_per_phys)

  @property
  def shape(self):
    return (self.phys_rows, self.phys_width)

  # ---- packing (strided copies, no staging) ------------------------------
  def pack(self, table: torch.Tensor,
           aux: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """``[rows, width]`` table (+ per-aux ``[rows, width]``) -> packed buf
    on the table's device.

    Logical row ``r`` lands in physical row ``r // rpp``, window
    ``r % rpp``; aux slot ``s`` follows the table lanes inside the window.
    Row and lane padding are zero."""
    parts = [table] + list(aux)
    if len(parts) != 1 + self.n_aux:
      raise ValueError(f"Expected {self.n_aux} aux arrays, got {len(aux)}")
    buf = torch.zeros(self.shape, dtype=table.dtype, device=table.device)
    rpp, w = self.rows_per_phys, self.width
    for j in range(rpp):
      n = len(range(j, self.rows, rpp))
      for s, part in enumerate(parts):
        lo = j * self.stride + s * w
        buf[:n, lo:lo + w] = part[j::rpp]
    return buf

  def unpack(self, buf):
    """Packed buf -> ``(table [rows, width], [aux_0, aux_1, ...])``; views
    where the layout allows (``rows_per_phys == 1``)."""
    rpp = self.rows_per_phys
    flat = buf[:, :rpp * self.stride]
    stacked = flat.reshape(self.phys_rows * rpp, 1 + self.n_aux, self.width)
    stacked = stacked[:self.rows]
    table = stacked[:, 0, :]
    aux = [stacked[:, 1 + j, :] for j in range(self.n_aux)]
    return table, aux


def init_packed_uniform(layout: PackedLayout, generator: torch.Generator,
                        scale_rows: torch.Tensor, aux_values: Sequence[float],
                        device="cuda", dtype=torch.float32) -> torch.Tensor:
  """Initialize a packed buffer directly in its physical layout.

  Table lanes get ``uniform(-1, 1) * scale_rows[row]``; aux lanes their
  ``aux_values`` constants on live physical rows (a row is live when any
  of its logical rows has ``scale_rows > 0``); padding is zero. The
  logical ``[rows, width]`` f32 table is never materialized: the peak
  allocation is the buffer plus one ``_INIT_CHUNK_PHYS``-row draw. The draw
  comes from ``generator`` (which must live on ``device``); it matches
  the JAX package's distribution, not its bits. ``dtype`` is the buffer's
  storage type (f32, or bf16 for narrow storage): each chunk is drawn in
  f32 and rounded into the buffer, the aux constants too (``bf16(0.1)``,
  as the JAX package's bf16 template holds them).
  """
  dev = resolve_device(device)
  f32 = torch.float32
  rpp, stride, w = layout.rows_per_phys, layout.stride, layout.width
  pr = layout.phys_rows
  scale_p = torch.zeros((pr * rpp,), dtype=f32, device=dev)
  scale_p[:layout.rows] = torch.as_tensor(scale_rows, dtype=f32, device=dev)
  scale_p = scale_p.view(pr, rpp)
  buf = torch.zeros((pr, layout.phys_width), dtype=dtype, device=dev)
  for p0 in range(0, pr, _INIT_CHUNK_PHYS):
    cp = min(_INIT_CHUNK_PHYS, pr - p0)
    vals = torch.rand((cp, rpp, stride), generator=generator, dtype=f32,
                      device=dev)
    vals.mul_(2.0).sub_(1.0)
    sc = scale_p[p0:p0 + cp]
    vals.mul_(sc[..., None])
    live = (sc > 0).any(dim=1)
    for s, v in enumerate(aux_values):
      lanes = vals[..., (1 + s) * w:(2 + s) * w]
      lanes.copy_(torch.where(live[:, None, None],
                              torch.full_like(lanes, float(v)),
                              torch.zeros_like(lanes)))
    buf[p0:p0 + cp, :rpp * stride] = vals.view(cp, rpp * stride)
  return buf


def _grp_sub(layout: PackedLayout, ids: torch.Tensor):
  """ids -> (physical row, sub-row, valid) with OOB ids sent past the
  buffer (``grp == phys_rows``)."""
  valid = (ids >= 0) & (ids < layout.rows)
  safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
  rpp = layout.rows_per_phys
  grp = torch.where(valid, safe // rpp, layout.phys_rows)
  sub = safe % rpp
  return grp, sub, valid


def gather_fused(layout: PackedLayout, buf: torch.Tensor,
                 ids: torch.Tensor, masked_phys: bool = False) -> torch.Tensor:
  """Gather fused rows: ``[..., stride]`` = (table row | aux rows).

  Reads each occurrence's logical row straight out of its window (a
  strided ``[phys_rows, rpp, stride]`` view of the buffer), so nothing of
  the physical row beyond the window is staged. OOB/sentinel ids return
  all-zero rows.

  ``masked_phys=True`` returns window-MASKED physical rows ``[...,
  rpp * stride]`` instead: every lane outside the occurrence's window is
  zero, and callers fold the ``rpp`` windows at bag granularity (the
  multi-hot narrow-class path of ``lookup_engine._combine_fused``)."""
  grp, sub, valid = _grp_sub(layout, ids)
  rpp, stride = layout.rows_per_phys, layout.stride
  safe_grp = torch.where(valid, grp, torch.zeros_like(grp))
  if masked_phys:
    rows = buf[:, :rpp * stride][safe_grp]
    keep = valid[..., None]
    if rpp > 1:
      win = torch.arange(rpp * stride, device=buf.device) // stride
      keep = keep & (win == sub[..., None])
    return torch.where(keep, rows, torch.zeros_like(rows))
  windows = buf[:, :rpp * stride].unflatten(1, (rpp, stride))
  rows = windows[safe_grp, sub]
  rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
  if rpp > 1 and rows.is_floating_point():
    # the JAX gather extracts a window by summing the rpp masked windows,
    # which turns a -0.0 lane into +0.0; adding +0.0 does the same here
    rows = rows + 0.0
  return rows


def gather_fused_chunked(layout: PackedLayout, buf: torch.Tensor,
                         ids: torch.Tensor,
                         chunk: Optional[int] = None,
                         masked_phys: bool = False) -> torch.Tensor:
  """:func:`gather_fused` over id chunks of at most ``chunk`` ids, so the
  index temporaries stay bounded on large streams; one shot when the
  stream fits one chunk. Same values as :func:`gather_fused`."""
  if chunk is None:
    chunk = 1 << 22
  width = (layout.rows_per_phys * layout.stride if masked_phys
           else layout.stride)
  flat = ids.reshape(-1)
  n = flat.shape[0]
  if n <= chunk:
    return gather_fused(layout, buf, ids, masked_phys)
  out = torch.empty((n, width), dtype=buf.dtype, device=buf.device)
  for c0 in range(0, n, chunk):
    out[c0:c0 + chunk] = gather_fused(layout, buf, flat[c0:c0 + chunk],
                                      masked_phys)
  return out.reshape(tuple(ids.shape) + (width,))


def residual_lanes(layout: PackedLayout, res: torch.Tensor, lo: int,
                   hi: int) -> torch.Tensor:
  """Lanes ``[lo, hi)`` of each occurrence's fused row, ``[n, hi - lo]``,
  from forward-saved rows in either layout: stride-wide fused rows, or
  window-masked physical rows (``gather_fused(masked_phys=True)``), whose
  one nonzero window is extracted by summing the ``rpp`` windows in
  order, as the JAX engine does (in f32, rounded once for bf16 rows, as
  XLA reduces bf16)."""
  stride = layout.stride
  flat = res.reshape(-1, res.shape[-1])
  if flat.shape[-1] == stride:
    return flat[:, lo:hi]
  out = flat[:, lo:hi].to(torch.float32)
  for s in range(1, layout.rows_per_phys):
    out = out + flat[:, s * stride + lo:s * stride + hi]
  return out.to(flat.dtype)


def mxu_operand_dtype(dtype: torch.dtype, device) -> torch.dtype:
  """Operand dtype of the pairwise interaction: bf16 for f32 operands on
  a CUDA device, pass-through elsewhere.

  The JAX package casts f32 matmul operands to bf16 on the TPU, whose
  default matmul precision multiplies them as one bf16 pass anyway; the
  CUDA device takes the TPU's place here, so the interaction runs the
  bf16 kernel for f32 and bf16 models alike. On the CPU (the tests) f32
  stays f32, as in the JAX package's CPU path."""
  if dtype == torch.float32 and torch.device(device).type == "cuda":
    return torch.bfloat16
  return dtype


def expand_phys(layout: PackedLayout, fused_delta: torch.Tensor,
                sub: torch.Tensor) -> torch.Tensor:
  """``[n, stride]`` fused deltas -> ``[n, phys_width]`` physical-row
  updates: each delta lands in its sub-row window (``rpp > 1``), the
  other windows and the lane padding are zero. Two logical rows sharing a
  physical row then accumulate disjointly, and same-window duplicates like
  any duplicate — the JAX package's one-hot lane expansion."""
  n = fused_delta.shape[0]
  rpp, stride = layout.rows_per_phys, layout.stride
  upd = torch.zeros((n, layout.phys_width), dtype=fused_delta.dtype,
                    device=fused_delta.device)
  if rpp == 1:
    upd[:, :stride] = fused_delta
    return upd
  windows = upd[:, :rpp * stride].view(n, rpp, stride)
  windows[torch.arange(n, device=sub.device), sub] = fused_delta
  return upd


def scatter_add_fused(layout: PackedLayout, buf: torch.Tensor,
                      ids: torch.Tensor, fused_delta: torch.Tensor,
                      delta_scale=None) -> torch.Tensor:
  """``buf[ids] += delta_scale * fused_delta`` in place (one indexed RMW
  for table + all aux lanes); returns ``buf``.

  ``fused_delta``: ``[..., stride]`` additive deltas in gather_fused's
  lane order (or ``[..., phys_width]`` rows already expanded). Duplicate
  ids accumulate; ids outside ``[0, rows)`` are dropped: the validity
  mask sends them to physical row ``phys_rows``, past the buffer, which
  the apply drops, so their deltas need no masking. ``delta_scale``: an
  optional scalar multiplier (SGD's ``-lr``), applied by the apply itself,
  so scale-only rules pass the raw cotangent rows.

  The apply is kernel K1 (``ops/cuda_apply.py``) on a CUDA buffer and its
  plain version on the CPU. The TPU's regime rule (XLA's scatter above an
  ids-to-rows ratio of 0.15) and its 128-lane limit came from XLA's TPU
  scatter and from Mosaic, so on the card K1 serves every buffer, at any
  ratio and any ``phys_width`` (always a multiple of 128). A bf16 buffer
  (narrow storage) takes K1's bf16 form with the JAX package's bf16
  arithmetic: the rows cast to bf16 first, ``delta_scale`` cast to bf16
  and multiplied in bf16, then each row added in bf16."""
  from .cuda_apply import apply_rows
  if buf.dtype not in (torch.float32, torch.bfloat16):
    raise NotImplementedError(
        f"scatter_add_fused on a {buf.dtype} buffer: K1 applies f32 and "
        "bf16 buffers")
  grp, sub, _ = _grp_sub(layout, ids.reshape(-1))
  flat = fused_delta.reshape(grp.shape[0], fused_delta.shape[-1])
  if flat.shape[-1] != layout.phys_width:
    flat = expand_phys(layout, flat, sub)
  flat = flat.to(buf.dtype).contiguous()
  return apply_rows(buf, grp.contiguous(), flat, delta_scale)


# ---------------------------------------------------------------------------
# Host cold-store blocks (tiering subsystem)
# ---------------------------------------------------------------------------
#
# The host tier stores a class's FULL packed image, in the same physical
# layout as the device buffer (physical rows of phys_width lanes, optimizer
# state interleaved), as one numpy array per rank in host RAM. Moving rows
# between tiers is a block copy at physical-row granularity: the staging
# rows a step uploads are bit-identical to what an all-device run holds at
# those rows. The helpers take physical-row ids, the granularity the
# hot/cold split classifies at.


def host_gather_rows(layout: PackedLayout, store: np.ndarray,
                     grps: np.ndarray) -> np.ndarray:
  """Cold-block gather: ``store[grps]`` with bounds validation.

  ``store``: the rank's host image ``[phys_rows, phys_width]``;
  ``grps``: int physical-row ids (unique and in range: the prefetcher
  dedups before gathering, and a silent clamp here would turn a routing
  bug into wrong training)."""
  grps = np.asarray(grps)
  if grps.size and (grps.min() < 0 or grps.max() >= layout.phys_rows):
    raise IndexError(
        f"cold gather out of range: grps in [{grps.min()}, {grps.max()}] "
        f"for a {layout.phys_rows}-physical-row store")
  if store.shape != (layout.phys_rows, layout.phys_width):
    raise ValueError(
        f"host store shape {store.shape} does not match layout "
        f"{(layout.phys_rows, layout.phys_width)}")
  # torch's gather runs on its threads (numpy's fancy index on one)
  return torch.from_numpy(store).index_select(
      0, torch.from_numpy(grps.astype(np.int64))).numpy()


def host_scatter_rows(layout: PackedLayout, store: np.ndarray,
                      grps: np.ndarray, rows: np.ndarray) -> None:
  """Cold-block write-back: ``store[grps] = rows`` in place.

  Overwrite (not add): the device staging region accumulated every
  occurrence's scatter-add delta during the step, so its rows ARE the new
  authoritative values. ``grps`` must be unique."""
  grps = np.asarray(grps)
  if grps.size and (grps.min() < 0 or grps.max() >= layout.phys_rows):
    raise IndexError(
        f"cold scatter out of range: grps in [{grps.min()}, {grps.max()}] "
        f"for a {layout.phys_rows}-physical-row store")
  if rows.shape != (grps.shape[0], layout.phys_width):
    raise ValueError(
        f"cold scatter rows shape {rows.shape}, expected "
        f"{(grps.shape[0], layout.phys_width)}")
  # torch's scatter runs on its threads (numpy's fancy index on one)
  torch.from_numpy(store).index_copy_(
      0, torch.from_numpy(grps.astype(np.int64)),
      torch.from_numpy(np.ascontiguousarray(rows, store.dtype)))


def init_host_store(layout: PackedLayout, rng: np.random.Generator,
                    scale_rows: np.ndarray, aux_values: Sequence[float],
                    dtype=np.float32) -> np.ndarray:
  """One rank's host image drawn with numpy, in the packed layout: table
  lanes ``uniform(-1, 1) * scale_rows[row]``, aux lanes their init
  constants (zero on dead rows, ``scale_rows == 0``), lane padding zero.
  The JAX package's ``init_host_store``, draw for draw: the same ``rng``
  gives the same image bits."""
  rpp, stride, w = layout.rows_per_phys, layout.stride, layout.width
  scale_rows = np.asarray(scale_rows, dtype)
  if scale_rows.shape != (layout.rows,):
    raise ValueError(
        f"scale_rows shape {scale_rows.shape}, expected ({layout.rows},)")
  store = np.zeros((layout.phys_rows, layout.phys_width), dtype)
  scale_p = np.zeros((layout.phys_rows * rpp,), dtype)
  scale_p[:layout.rows] = scale_rows
  vals = rng.uniform(-1.0, 1.0,
                     (layout.phys_rows * rpp, w)).astype(dtype)
  vals *= scale_p[:, None]
  live = scale_p > 0
  for j in range(rpp):
    lo = j * stride
    store[:, lo:lo + w] = vals[j::rpp]
    for s, v in enumerate(aux_values):
      store[:, lo + (1 + s) * w:lo + (2 + s) * w] = np.where(
          live[j::rpp, None], dtype(v) if np.isscalar(v) else v, 0)
  return store


def init_host_store_device(layout: PackedLayout, generator: torch.Generator,
                           scale_rows: torch.Tensor,
                           aux_values: Sequence[float],
                           out: Optional[np.ndarray] = None,
                           device="cuda") -> np.ndarray:
  """One rank's f32 host image drawn on ``device`` and downloaded chunk by
  chunk: :func:`init_packed_uniform`'s draw (``generator`` lives on
  ``device``), each ``_INIT_CHUNK_PHYS``-row chunk drawn there and copied
  into ``out`` (a new ``[phys_rows, phys_width]`` f32 array if None), so
  the device never holds more than one chunk and the host draws nothing.
  The same distribution as :func:`init_host_store`, not its bits; for a
  multi-GB image it is the host's copy rate, not numpy's draw rate, that
  bounds the time."""
  dev = resolve_device(device)
  f32 = torch.float32
  rpp, stride, w = layout.rows_per_phys, layout.stride, layout.width
  pr = layout.phys_rows
  if out is None:
    out = np.empty((pr, layout.phys_width), np.float32)
  if out.shape != (pr, layout.phys_width) or out.dtype != np.float32:
    raise ValueError(f"out must be f32 {(pr, layout.phys_width)}, got "
                     f"{out.dtype} {out.shape}")
  scale_p = torch.zeros((pr * rpp,), dtype=f32, device=dev)
  scale_p[:layout.rows] = torch.as_tensor(scale_rows, dtype=f32, device=dev)
  scale_p = scale_p.view(pr, rpp)
  host = torch.from_numpy(out)
  for p0 in range(0, pr, _INIT_CHUNK_PHYS):
    cp = min(_INIT_CHUNK_PHYS, pr - p0)
    chunk = torch.zeros((cp, layout.phys_width), dtype=f32, device=dev)
    vals = torch.rand((cp, rpp, stride), generator=generator, dtype=f32,
                      device=dev)
    vals.mul_(2.0).sub_(1.0)
    sc = scale_p[p0:p0 + cp]
    vals.mul_(sc[..., None])
    live = (sc > 0).any(dim=1)
    for s, v in enumerate(aux_values):
      lanes = vals[..., (1 + s) * w:(2 + s) * w]
      lanes.copy_(torch.where(live[:, None, None],
                              torch.full_like(lanes, float(v)),
                              torch.zeros_like(lanes)))
    chunk[:, :rpp * stride] = vals.view(cp, rpp * stride)
    host[p0:p0 + cp].copy_(chunk)  # a synchronous download
  return out


# ---------------------------------------------------------------------------
# Sparse update rules (fused-delta form)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseRule:
  """Per-occurrence sparse update rule in additive (scatter-add) form.

  ``n_aux`` per-row state slots ride in the packed layout and ``aux_init``
  gives their fill values; ``delta(g, aux_rows, step)`` maps a cotangent
  row ``[..., W]`` and its pre-step aux rows ``[..., n_aux, W]`` to the
  fused additive delta ``[..., stride]``. With duplicate ids each
  occurrence computes its delta from the forward-time state (the engine's
  ``exact=True`` path deduplicates first).

  ``weight_decay``: λ of a uniform l2 penalty on the sparse tables; the
  engine adds ``2·λ·row`` to each occurrence's cotangent before ``delta``
  (decay on touched rows only; make_sparse_train_step folds a table
  ``regularizer='l2'`` in). ``linear_scale(step)``: for rules whose delta
  is a scalar multiple of the cotangent (SGD), that multiplier; the engine
  then skips the delta and the apply (K1) scales the raw rows.

  ``delta_lanes(g, [aux_0, ..], step)``: the flat-lanes twin of ``delta``,
  returning the delta as a list of ``[..., W]`` lane groups (table first);
  it computes exactly what ``delta`` computes. ``lane_scalars(step)``: the
  host floats the fused delta build (kernel K6, ``ops/cuda_delta.py``)
  takes for this rule at ``step`` (the learning rate, the rule's constants
  and Adam's bias corrections, computed on the host so the kernel needs no
  device read). The engine builds a class's update rows with K6 only for
  rules that have both."""

  name: str
  n_aux: int
  aux_init: Sequence[float]
  delta: Callable
  weight_decay: float = 0.0
  linear_scale: Optional[Callable] = None
  delta_lanes: Optional[Callable] = None
  lane_scalars: Optional[Callable] = None


def _lr_at(lr, step):
  return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


def _host_lr(lr, step) -> float:
  """The learning rate at ``step`` as a host float (a schedule returns a
  Python number or a CPU tensor: nothing is read back from the card)."""
  return float(lr(step) if callable(lr) else lr)


def _f32(x) -> float:
  """``x`` rounded to f32, as the JAX rules' weakly typed constants are."""
  return float(np.float32(x))


def _weak(c: float, dtype: torch.dtype) -> float:
  """The Python constant ``c`` as the JAX rules' weak typing reads it
  beside a tensor of ``dtype``, as a host float: ``bf16(c)`` beside bf16
  lanes (torch would multiply a bf16 tensor by ``f32(c)``), ``f32(c)``
  beside f32 ones. An f32 tensor times it rounds once, as XLA's op does,
  and no value goes to the card."""
  return float(torch.tensor(c, dtype=dtype))


def _on(x, device) -> torch.Tensor:
  """A scalar (a Python number or a 0-d tensor) as a 0-d f32 tensor on
  ``device``. A host value is filled in there (``torch.full``), so it
  takes no blocking copy to the card; a divisor on the card is a tensor
  there, which the card divides by exactly (a host scalar divisor becomes
  a multiply by its reciprocal)."""
  if isinstance(x, torch.Tensor) and x.device.type != "cpu":
    return x.to(device=device, dtype=torch.float32)
  return torch.full((), float(x), dtype=torch.float32, device=device)


def _lo(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """An f32 result of one elementwise op whose JAX type is ``dtype``,
  rounded as XLA's CPU jit rounds it where another op of that type reads
  it: to bf16 (kept in f32) for a bf16 op, unchanged for an f32 one."""
  if dtype == torch.float32:
    return x
  return x.to(dtype).to(torch.float32)


def sgd_rule(learning_rate) -> SparseRule:
  """Row-sparse SGD: table[id] -= lr * g."""

  def delta(g, aux_rows, step):
    del aux_rows
    return -_on(_lr_at(learning_rate, step), g.device) * g

  return SparseRule("sgd", 0, (), delta,
                    linear_scale=lambda step: -_lr_at(learning_rate, step))


def adagrad_rule(learning_rate, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> SparseRule:
  """Row-sparse Adagrad (``optax.adagrad``'s rule): acc' = acc + g^2;
  table -= lr * g * rsqrt(acc' + eps). The accumulator rides in the fused
  row (``n_aux=1``)."""

  def delta_lanes(g, aux_list, step):
    (acc,) = aux_list
    g2 = g * g
    acc_new = acc + g2
    scaled = torch.where(acc_new > 0, g * torch.rsqrt(acc_new + eps),
                         torch.zeros_like(g))
    lr = _on(_lr_at(learning_rate, step), g.device)
    return [-lr * scaled, g2]

  def delta(g, aux_rows, step):
    return torch.cat(delta_lanes(g, [aux_rows[..., 0, :]], step), dim=-1)

  return SparseRule(
      "adagrad", 1, (initial_accumulator_value,), delta,
      delta_lanes=delta_lanes,
      lane_scalars=lambda step: (_host_lr(learning_rate, step), _f32(eps)))


def momentum_rule(learning_rate, momentum: float = 0.9,
                  nesterov: bool = False) -> SparseRule:
  """Row-sparse SGD with momentum (``optax.sgd(lr, momentum)``'s rule):
  m' = momentum * m + g; table -= lr * m' (nesterov: lr * (g + momentum *
  m')). The momentum buffer rides in the fused row; the delta is
  ``[-lr*upd | m' - m]``."""

  def delta_lanes(g, aux_list, step):
    (m,) = aux_list
    # JAX's dtype flow op for op (see _lo): bf16 lanes promote against an
    # f32 cotangent; a bf16 result that an f32 op reads enters unrounded
    dt = torch.promote_types(m.dtype, g.dtype)
    f32 = torch.float32
    prod = _lo(_weak(momentum, m.dtype) * m.to(f32), dt)
    m_new = prod + g.to(f32)
    if nesterov:
      m_r = _lo(m_new, dt)
      upd = g.to(f32) + _lo(_weak(momentum, dt) * m_r, dt)
    else:
      upd = m_new
    lr = _on(_lr_at(learning_rate, step), g.device)
    return [-lr * upd, _lo(m_new, dt) - m.to(f32)]

  def delta(g, aux_rows, step):
    return torch.cat(delta_lanes(g, [aux_rows[..., 0, :]], step), dim=-1)

  return SparseRule(
      "momentum", 1, (0.0,), delta, delta_lanes=delta_lanes,
      lane_scalars=lambda step: (_host_lr(learning_rate, step),
                                 _f32(momentum), float(bool(nesterov))))


def adam_rule(learning_rate, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> SparseRule:
  """Row-sparse Adam (``optax.adam``'s rule): both moments ride in the
  fused row (``n_aux=2``), bias-corrected with the global ``t = step +
  1``; the delta is ``[-lr*upd | dm | dv]``."""

  def delta_lanes(g, aux_list, step):
    m, v = aux_list
    # JAX's dtype flow op for op (see _lo): on bf16 lanes the moment
    # deltas round at every op, the new moments enter the f32 bias
    # correction unrounded
    dt = torch.promote_types(m.dtype, g.dtype)
    f32 = torch.float32
    gf = g.to(f32)
    dm = _lo(_weak(1.0 - b1, dt) * _lo(gf - m.to(f32), dt), dt)
    gv = _lo(_lo(gf * gf, g.dtype) - v.to(f32), dt)
    dv = _lo(_weak(1.0 - b2, dt) * gv, dt)
    m_new = m.to(f32) + dm
    v_new = v.to(f32) + dv
    # the bias corrections where the step lies (the host, for an int)
    t = torch.as_tensor(step, dtype=f32) + 1.0
    m_hat = m_new / _on(1.0 - torch.pow(
        torch.full((), b1, dtype=f32, device=t.device), t), g.device)
    v_hat = v_new / _on(1.0 - torch.pow(
        torch.full((), b2, dtype=f32, device=t.device), t), g.device)
    lr = _on(_lr_at(learning_rate, step), g.device)
    upd = m_hat / (torch.sqrt(v_hat) + eps)
    return [-lr * upd, dm, dv]

  def delta(g, aux_rows, step):
    return torch.cat(delta_lanes(g, [aux_rows[..., 0, :],
                                     aux_rows[..., 1, :]], step), dim=-1)

  def lane_scalars(step):
    # the bias corrections 1 - b^t in f32, t = step + 1 (the JAX rule's
    # f32 power of weakly typed betas; the power is taken in f64 and
    # rounded once)
    t = float(step) + 1.0
    c1 = np.float32(1.0) - np.float32(float(np.float32(b1)) ** t)
    c2 = np.float32(1.0) - np.float32(float(np.float32(b2)) ** t)
    return (_host_lr(learning_rate, step), _f32(1.0 - b1), _f32(1.0 - b2),
            float(c1), float(c2), _f32(eps))

  return SparseRule("adam", 2, (0.0, 0.0), delta, delta_lanes=delta_lanes,
                    lane_scalars=lane_scalars)


_RULES = {"sgd": sgd_rule, "adagrad": adagrad_rule,
          "momentum": momentum_rule, "adam": adam_rule}


def sparse_rule(name: str, learning_rate, **kwargs) -> SparseRule:
  if name not in _RULES:
    raise ValueError(f"Unknown sparse rule {name!r}; have {sorted(_RULES)}")
  return _RULES[name](learning_rate, **kwargs)

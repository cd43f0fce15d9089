"""The wire: every dp<->mp exchange of the lookup rides here (PyTorch port
of ``parallel/wire.py``).

The payloads are the routed ids (dp->mp), the activations (mp->dp) and
their cotangents (the reverse exchange of the backward). Every float
exchange is a ``torch.autograd.Function`` whose backward runs the reverse
exchange, so one ``loss.backward()`` brings each rank the cotangents of
the rows it owns. The collectives are ``torch.distributed``'s
``all_to_all_single`` on the default process group that
:func:`~.mesh.create_mesh` started: NCCL or gloo alike.

The plan's knobs choose the schedule (``DistEmbeddingStrategy``):

- ``overlap='none'``: one monolithic ``all_to_all`` per exchange;
- ``overlap='pipelined'``: ``world - 1`` rotation rounds per chunk of
  ``exchange_chunks`` chunks; round ``k`` sends this rank's block for
  rank ``(i + k) % world`` and receives rank ``(i - k) % world``'s block
  for this rank (one ``all_to_all_single`` with one nonzero split each
  way, which NCCL and gloo both take);
- ``overlap='fused'``: the rounds of the pipelined schedule with each
  round's block gathered just before its own send
  (:func:`fused_block_send`; the engine's ``_z_sparse_fused_jit``).

All three move the same bytes to the same places, so at the f32 wire they
are bit-exact against each other. ``wire_dtype='bf16'`` narrows each
float payload for the flight and widens it on arrival, in both
directions; the tables, combiners and rules stay f32. ``wire_dtype=
'fp8'`` (float8_e4m3) scales each destination block (each chunk of it
under the pipelined and fused schedules) by its own amax, mapped onto
``FP8_MAX``, and ships the f32 scale in 4 trailing byte lanes of the
block (:func:`_fp8_encode`), so no second collective carries the
scales; every backward re-scales the cotangent blocks by their own
amax. The encoded block travels as ``uint8`` bytes on every backend
(gloo has no float8 type). One codec (:func:`_chunk_encode` /
:func:`_chunk_decode`) serves the three schedules.

At world 1 there is no wire: every function returns its input.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

WIRE_DTYPES = {"f32": None, "bf16": torch.bfloat16,
               "fp8": torch.float8_e4m3fn}
FP8 = torch.float8_e4m3fn

# the largest finite float8_e4m3fn value: each block's amax maps onto it
FP8_MAX = 448.0
# the f32 reciprocal of FP8_MAX: XLA compiles ``amax / FP8_MAX`` to a
# multiply by it, and the scale must match the JAX step's bit for bit
_FP8_INV_MAX = float(np.float32(1.0) / np.float32(FP8_MAX))
# byte lanes appended per block to carry its f32 scale
_FP8_SCALE_LANES = 4
# the e4m3fn cast rounds to nearest even and has no inf: a value past the
# midpoint between 448 and the next step (480) becomes NaN (XLA's cast);
# torch's cast saturates there, so the codec writes those NaNs itself
_FP8_OVERFLOW = 464.0


def plan_wire_dtype(plan) -> Optional[torch.dtype]:
  """The plan's wire dtype (None: the f32 identity wire)."""
  name = getattr(plan, "wire_dtype", "f32")
  if name not in WIRE_DTYPES:
    raise ValueError(f"unknown wire_dtype {name!r}; have {sorted(WIRE_DTYPES)}")
  return WIRE_DTYPES[name]


def plan_dedup_exchange(plan) -> bool:
  """The plan's ``dedup_exchange`` knob (default False)."""
  return bool(getattr(plan, "dedup_exchange", False))


def plan_overlap(plan) -> str:
  """The plan's ``overlap`` knob (default 'none')."""
  name = getattr(plan, "overlap", "none")
  if name not in ("none", "pipelined", "fused"):
    raise ValueError(f"unknown overlap mode {name!r}; have ['none', "
                     "'pipelined', 'fused']")
  return name


def plan_exchange_chunks(plan) -> int:
  """The plan's ``exchange_chunks`` knob (default 1)."""
  return int(getattr(plan, "exchange_chunks", 1) or 1)


def _world(mesh) -> int:
  return 1 if mesh is None else mesh.world


# ---------------------------------------------------------------------------
# transport: the two collectives every schedule is made of
# ---------------------------------------------------------------------------


def _all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
  """``out[j] = x_j[i]``: block ``j`` of dim 0 goes to rank ``j``."""
  x = x.contiguous()
  out = torch.empty_like(x)
  dist.all_to_all_single(out, x)
  return out


def fused_round_perm(k: int, world: int) -> List[Tuple[int, int]]:
  """Round ``k``'s rotate-by-k permutation ``(source, destination)``."""
  return [(s, (s + k) % world) for s in range(world)]


def _rotate(x: torch.Tensor, mesh, k: int) -> torch.Tensor:
  """One rotation round: ``x`` goes to rank ``(i + k) % world``; the
  same-shape block of rank ``(i - k) % world`` comes back."""
  world, i = mesh.world, mesh.rank
  k %= world
  if k == 0:
    return x
  perm = fused_round_perm(k, world)
  send_to = perm[i][1]
  recv_from = next(s for s, d in perm if d == i)
  flat = x.contiguous().reshape(-1)
  in_splits = [0] * world
  out_splits = [0] * world
  in_splits[send_to] = flat.numel()
  out_splits[recv_from] = flat.numel()
  out = torch.empty_like(flat)
  dist.all_to_all_single(out, flat, out_splits, in_splits)
  return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# the codec: per-block amax scale for fp8, shipped in the block
# ---------------------------------------------------------------------------


def _e4m3_bytes(y: torch.Tensor) -> torch.Tensor:
  """f32 -> float8_e4m3fn bits as ``uint8``, rounding to nearest even; a
  magnitude past 464 (inf included) becomes NaN of its sign, as XLA's
  cast gives it, where torch's own cast saturates to 448."""
  q = y.to(FP8).view(torch.uint8)
  nan = torch.where(torch.signbit(y), 0xFF, 0x7F).to(torch.uint8)
  return torch.where(y.abs() > _FP8_OVERFLOW, nan, q)


def _fp8_encode(blocks: torch.Tensor) -> torch.Tensor:
  """``[n, m]`` float -> ``[n, m + 4]`` ``uint8`` wire blocks.

  Each block is divided by its own scale ``amax / FP8_MAX`` before the
  cast, so the 3-bit mantissa spends its range on the block's own
  dynamic range; the f32 scale's 4 bytes (little-endian, as the JAX
  package's bitcast lays them) trail the block. All-zero blocks keep
  scale 1."""
  x = blocks.to(torch.float32)
  amax = x.abs().amax(dim=1)
  scale = torch.where(amax > 0, amax * _FP8_INV_MAX, torch.ones_like(amax))
  q = _e4m3_bytes(x / scale[:, None])
  lanes = scale.contiguous().view(torch.uint8).reshape(x.shape[0],
                                                       _FP8_SCALE_LANES)
  return torch.cat([q, lanes], dim=1)


def _fp8_decode(blocks: torch.Tensor, dtype) -> torch.Tensor:
  """``[n, m + 4]`` ``uint8`` wire blocks -> ``[n, m]`` of ``dtype``."""
  q = blocks[:, :-_FP8_SCALE_LANES].contiguous().view(FP8)
  # a fresh [n, 4] copy: a slice's offset and strides need not be
  # multiples of the f32 size
  lanes = blocks[:, -_FP8_SCALE_LANES:]
  scale = torch.empty(lanes.shape, dtype=torch.uint8,
                      device=lanes.device).copy_(lanes).view(torch.float32)
  return (q.to(torch.float32) * scale).to(dtype)


def _chunk_encode(x: torch.Tensor, wire_dtype) -> torch.Tensor:
  """The one wire codec of every schedule: the identity for the f32
  wire, a cast for bf16, the scaled block form for fp8 (``x`` then
  2-D ``[blocks, m]``: the scale lanes append per block)."""
  if wire_dtype is None:
    return x
  if wire_dtype == FP8:
    return _fp8_encode(x)
  return x.to(wire_dtype)


def _chunk_decode(y: torch.Tensor, wire_dtype, dtype) -> torch.Tensor:
  if wire_dtype is None:
    return y
  if wire_dtype == FP8:
    return _fp8_decode(y, dtype)
  return y.to(dtype)


def _narrowing(x: torch.Tensor, wire_dtype) -> Optional[torch.dtype]:
  """The wire dtype to narrow ``x`` to, or None for the identity wire."""
  return None if wire_dtype is None or wire_dtype == x.dtype else wire_dtype


# ---------------------------------------------------------------------------
# monolithic exchange
# ---------------------------------------------------------------------------


def exchange_ids(x: torch.Tensor, mesh) -> torch.Tensor:
  """Integer payload exchange (routed ids), ``[world, ...]`` dest-major
  in, source-major out."""
  if _world(mesh) == 1:
    return x
  return _all_to_all(x, mesh)


def _wire_mono(x: torch.Tensor, mesh, wire_dtype) -> torch.Tensor:
  """One monolithic exchange through the codec; only the fp8 wire
  flattens each destination block (its scale lanes append per block)."""
  if wire_dtype == FP8:
    enc = _chunk_encode(x.reshape(x.shape[0], -1), wire_dtype)
    return _chunk_decode(_all_to_all(enc, mesh), wire_dtype,
                         x.dtype).reshape(x.shape)
  return _chunk_decode(_all_to_all(_chunk_encode(x, wire_dtype), mesh),
                       wire_dtype, x.dtype)


class _AllToAll(torch.autograd.Function):
  """Monolithic float exchange; the block permutation is an involution,
  so the backward is the same exchange on the cotangent (narrowed like
  the forward payload)."""

  @staticmethod
  def forward(ctx, x, mesh, wire_dtype):
    ctx.mesh, ctx.wire_dtype = mesh, wire_dtype
    return _wire_mono(x, mesh, wire_dtype)

  @staticmethod
  def backward(ctx, ct):
    return _wire_mono(ct, ctx.mesh, ctx.wire_dtype), None, None


def float_all_to_all(x: torch.Tensor, mesh,
                     wire_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
  """Float payload exchange under the plan's wire dtype, differentiable:
  ``[world, ...]`` dest-major in, source-major out."""
  if _world(mesh) == 1:
    return x
  return _AllToAll.apply(x, mesh, _narrowing(x, wire_dtype))


# ---------------------------------------------------------------------------
# pipelined exchange: (world - 1) rotation rounds per chunk
# ---------------------------------------------------------------------------


def _pipelined_rounds(xf: torch.Tensor, mesh, chunks: int,
                      wire_dtype=None) -> torch.Tensor:
  """Chunked-rotation equivalent of the monolithic exchange.

  ``xf [world, m]`` is the flattened dest-major payload. Per chunk,
  ``world - 1`` rounds: round ``k`` sends the block for rank ``(i + k) %
  world`` and receives the block of rank ``(i - k) % world``; round 0 is
  the self block and never crosses the wire. A chunk count that does not
  divide ``m`` pads the last chunk with zeros, sliced off after."""
  world, m = xf.shape
  i = mesh.rank
  chunks = max(1, int(chunks))
  mc = -(-m // chunks)
  pad = chunks * mc - m
  if pad:
    xf = torch.cat([xf, xf.new_zeros((world, pad))], dim=1)
  # round k came from rank (i - k) % world; out[j] = rounds[(i - j) % world]
  src_pos = [(i - j) % world for j in range(world)]
  outs = []
  for c in range(chunks):
    # fp8: one scale per (destination block, chunk)
    enc = _chunk_encode(xf[:, c * mc:(c + 1) * mc], wire_dtype)
    # round k sends my block for rank (i + k) % world
    rounds = [enc[i]] + [_rotate(enc[(i + k) % world], mesh, k)
                         for k in range(1, world)]
    outs.append(_chunk_decode(torch.stack([rounds[p] for p in src_pos]),
                              wire_dtype, xf.dtype))
  out = outs[0] if chunks == 1 else torch.cat(outs, dim=1)
  return out[:, :m] if pad else out


def pipelined_exchange_ids(x: torch.Tensor, mesh,
                           chunks: int = 1) -> torch.Tensor:
  """Integer payload exchange as chunked rotation rounds; the same
  result as :func:`exchange_ids`."""
  world = _world(mesh)
  if world == 1:
    return x
  return _pipelined_rounds(x.reshape(world, -1), mesh, chunks).reshape(
      x.shape)


class _Pipelined(torch.autograd.Function):
  """Pipelined float exchange; the backward runs the same rounds on the
  cotangent."""

  @staticmethod
  def forward(ctx, x, mesh, wire_dtype, chunks):
    ctx.mesh, ctx.wire_dtype, ctx.chunks = mesh, wire_dtype, chunks
    return _pipelined_rounds(x.reshape(x.shape[0], -1), mesh, chunks,
                             wire_dtype).reshape(x.shape)

  @staticmethod
  def backward(ctx, ct):
    g = _pipelined_rounds(ct.reshape(ct.shape[0], -1), ctx.mesh, ctx.chunks,
                          ctx.wire_dtype)
    return g.reshape(ct.shape), None, None, None


def pipelined_float_exchange(x: torch.Tensor, mesh,
                             wire_dtype: Optional[torch.dtype] = None,
                             chunks: int = 1) -> torch.Tensor:
  """Float payload exchange as chunked rotation rounds, differentiable;
  the same result as :func:`float_all_to_all` at the f32 wire."""
  if _world(mesh) == 1:
    return x
  return _Pipelined.apply(x, mesh, _narrowing(x, wire_dtype), int(chunks))


# ---------------------------------------------------------------------------
# fused exchange: one send per just-gathered block
# ---------------------------------------------------------------------------


def _block_send(x: torch.Tensor, mesh, k: int, wire_dtype) -> torch.Tensor:
  """encode -> rotate-by-k -> decode of one block (fp8: one scale for
  the whole block)."""
  enc = _chunk_encode(x.reshape(1, -1), wire_dtype)
  return _chunk_decode(_rotate(enc, mesh, k), wire_dtype,
                       x.dtype).reshape(x.shape)


class _FusedBlock(torch.autograd.Function):
  """One round's block send; the transpose of rotate-by-k is
  rotate-by-(world - k): the cotangent of the block sent to ``(i + k) %
  world`` comes back from that rank."""

  @staticmethod
  def forward(ctx, x, mesh, k, wire_dtype):
    ctx.mesh, ctx.k, ctx.wire_dtype = mesh, k, wire_dtype
    return _block_send(x, mesh, k, wire_dtype)

  @staticmethod
  def backward(ctx, ct):
    back = (ctx.mesh.world - ctx.k) % ctx.mesh.world
    return _block_send(ct, ctx.mesh, back, ctx.wire_dtype), None, None, None


def fused_block_send(x: torch.Tensor, mesh, k: int,
                     wire_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
  """Ship one just-gathered block over round ``k``'s rotation: ``x`` is
  what this rank gathered for rank ``(i + k) % world``; the result is
  what rank ``(i - k) % world`` gathered for this rank. Round 0 is the
  self block (narrowed and widened under a narrow wire, as in the
  pipelined schedule)."""
  if _world(mesh) == 1:
    return x
  wd = _narrowing(x, wire_dtype)
  if wd is None and k % mesh.world == 0:
    return x
  return _FusedBlock.apply(x, mesh, int(k), wd)


# ---------------------------------------------------------------------------
# whole-state views
# ---------------------------------------------------------------------------


def gather_blocks(x: torch.Tensor, mesh) -> torch.Tensor:
  """Every rank's ``x`` stacked by rank: ``[world * n, ...]`` on every
  rank (``all_gather``, which NCCL and gloo both take)."""
  world = _world(mesh)
  if world == 1:
    return x
  x = x.contiguous()
  parts = [torch.empty_like(x) for _ in range(world)]
  dist.all_gather(parts, x)
  return torch.cat(parts)

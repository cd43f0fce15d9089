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
directions; the tables, combiners and rules stay f32. The fp8 wire (its
per-block amax scale packed into the block) is not ported yet.

At world 1 there is no wire: every function returns its input.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

WIRE_DTYPES = ("f32", "bf16", "fp8")


def plan_wire_dtype(plan) -> Optional[torch.dtype]:
  """The plan's wire dtype (None: the f32 identity wire)."""
  name = getattr(plan, "wire_dtype", "f32")
  if name not in WIRE_DTYPES:
    raise ValueError(f"unknown wire_dtype {name!r}; have {list(WIRE_DTYPES)}")
  if name == "fp8":
    raise NotImplementedError(
        "wire_dtype='fp8': the fp8 wire codec (one amax scale per block, "
        "bit-packed into the block) is not ported yet; use 'f32' or 'bf16'")
  return None if name == "f32" else torch.bfloat16


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


def _encode(x: torch.Tensor, wire_dtype) -> torch.Tensor:
  return x if wire_dtype is None else x.to(wire_dtype)


def _decode(y: torch.Tensor, dtype) -> torch.Tensor:
  return y if y.dtype == dtype else y.to(dtype)


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
  return _decode(_all_to_all(_encode(x, wire_dtype), mesh), x.dtype)


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
    enc = _encode(xf[:, c * mc:(c + 1) * mc], wire_dtype)
    # round k sends my block for rank (i + k) % world
    rounds = [enc[i]] + [_rotate(enc[(i + k) % world], mesh, k)
                         for k in range(1, world)]
    outs.append(torch.stack([_decode(rounds[p], xf.dtype)
                             for p in src_pos]))
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
  return _decode(_rotate(_encode(x, wire_dtype), mesh, k), x.dtype)


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

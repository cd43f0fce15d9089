"""DLRM (PyTorch port of ``models/dlrm.py``).

Bottom MLP over the numerical features, the embedding activations, the
pairwise dot-product interaction over the lower triangle, and the top MLP
to one logit. ``compute_dtype=torch.bfloat16`` runs the MLPs and the
interaction in bf16 with f32 parameters, as the JAX model does.

The interaction runs kernel K2-fwd forward and K2-bwd backward
(``ops/cuda_interact.py``, one ``torch.autograd.Function``) on a CUDA
device, for f32 and bf16 models alike: on the card f32 operands are cast
to bf16 first (``mxu_operand_dtype``), as the JAX package does on the
TPU, and the cast's backward widens the bf16 cotangents back to f32. On
the CPU a bf16 model takes the kernels' plain versions and an f32 model
the JAX package's CPU form (the f32 pair einsum with its hand-written
``2 * einsum(d_sym, feats)`` backward).

:class:`DLRM` takes its embedding activations through ``emb_acts`` (the
serving and sparse training paths compute them; the embedding layer is
not ported yet). :func:`bce_loss` is the training loss.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.cuda_interact import interact_parts_bwd, interact_parts_fwd
from ..ops.packed_table import mxu_operand_dtype


class MLP(nn.Module):
  """A stack of dense layers with ReLU between them (and after the last
  when ``activate_final``). Parameters stay f32; the compute runs in
  ``dtype``, with the bias added after the product as flax's ``Dense``
  does."""

  def __init__(self, in_features: int, features: Sequence[int],
               activate_final: bool = False, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.dtype = dtype
    self.activate_final = activate_final
    self.layers = nn.ModuleList()
    fan_in = in_features
    for width in features:
      lin = nn.Linear(fan_in, width)
      with torch.no_grad():
        # lecun-scaled normal weights and zero biases, drawn from the
        # caller's generator (flax Dense's defaults, up to truncation)
        lin.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        lin.bias.zero_()
      self.layers.append(lin)
      fan_in = width

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    last = len(self.layers) - 1
    for i, lin in enumerate(self.layers):
      x = torch.matmul(x.to(self.dtype), lin.weight.to(self.dtype).t())
      x = x + lin.bias.to(self.dtype)
      if i < last or self.activate_final:
        x = torch.relu(x)
    return x


@functools.lru_cache(maxsize=None)
def _tril_select_np(f: int, k: int):
  """Half-weight symmetric selection tensor ``M [f, f, p]`` of the JAX
  model: ``einsum("bpq,pqn->bn", inter, M)`` extracts the lower-triangle
  pairs of the symmetric pair products (both mirrored cells weigh 0.5,
  diagonal cells 1.0)."""
  rows, cols = np.tril_indices(f, k=k)
  p = len(rows)
  m = np.zeros((f, f, p), np.float32)
  for n, (i, j) in enumerate(zip(rows, cols)):
    if i == j:
      m[i, j, n] = 1.0
    else:
      m[i, j, n] = 0.5
      m[j, i, n] = 0.5
  m.flags.writeable = False
  return m, p


class _PairProducts(torch.autograd.Function):
  """K2: f bf16 ``[B, D]`` parts -> ``[B, P]`` f32 pair activations, with
  the cotangents of the parts from K2-bwd (the JAX package's
  ``_pair_products_pallas`` custom VJP). The forward's parts are saved
  for the backward."""

  @staticmethod
  def forward(ctx, k, *parts):
    ctx.k = k
    ctx.save_for_backward(*parts)
    return interact_parts_fwd(list(parts), k)

  @staticmethod
  def backward(ctx, d_acts):
    parts = ctx.saved_tensors
    d_parts = interact_parts_bwd(d_acts.contiguous(), list(parts), ctx.k)
    return (None,) + tuple(d_parts)


class _TrilProducts(torch.autograd.Function):
  """The JAX package's CPU form (``_tril_products``): flat ``[B, F*D]``
  features -> ``[B, P]`` by the pair einsum and the ``M`` selection
  einsum; the backward uses the symmetry of ``d_sym = d_acts . M`` to form
  ``d_feats`` as one product einsum scaled by 2."""

  @staticmethod
  def forward(ctx, flat, f, k):
    b = flat.shape[0]
    feats = flat.view(b, f, flat.shape[1] // f)
    m_np, _ = _tril_select_np(f, k)
    m = torch.tensor(m_np, dtype=feats.dtype, device=feats.device)
    inter = torch.einsum("bpd,bqd->bpq", feats, feats)
    ctx.save_for_backward(feats)
    ctx.k = k
    return torch.einsum("bpq,pqn->bn", inter, m).float()

  @staticmethod
  def backward(ctx, d_acts):
    (feats,) = ctx.saved_tensors
    b, f, d = feats.shape
    m_np, _ = _tril_select_np(f, ctx.k)
    m = torch.tensor(m_np, dtype=feats.dtype, device=feats.device)
    d_sym = torch.einsum("bn,pqn->bpq", d_acts.to(feats.dtype), m)
    d_feats = 2.0 * torch.einsum("bqp,bqd->bpd", d_sym, feats)
    return d_feats.to(feats.dtype).reshape(b, f * d), None, None


def dot_interact(bottom_out: torch.Tensor,
                 emb_outs: Sequence[torch.Tensor],
                 self_interaction: bool = False) -> torch.Tensor:
  """Pairwise dot-product interaction + bottom-MLP passthrough:
  ``[B, F*(F-1)/2 + D]`` (F = embeddings + 1) f32, differentiable.

  On a CUDA device every case goes through K2 (f32 and bf16 operands run
  as bf16; any other type raises in the kernels' wrappers); bf16 on the
  CPU takes the kernels' plain versions, and f32 on the CPU the JAX
  package's CPU form (:class:`_TrilProducts`)."""
  parts = [bottom_out] + list(emb_outs)
  b, d = parts[0].shape
  bad = [tuple(p.shape) for p in parts if tuple(p.shape) != (b, d)]
  if bad:
    raise ValueError(
        f"dot_interact needs equal [B, D] features; got {bad} vs ({b}, {d})")
  cd = mxu_operand_dtype(parts[0].dtype, parts[0].device)
  k = 0 if self_interaction else -1
  if cd == torch.bfloat16 or parts[0].device.type == "cuda":
    acts = _PairProducts.apply(k, *[p.to(cd).contiguous() for p in parts])
  else:
    flat = torch.cat([p.to(cd) for p in parts], dim=1)
    acts = _TrilProducts.apply(flat, len(parts), k)
  return torch.cat([acts, bottom_out.to(acts.dtype)], dim=1)


class DLRM(nn.Module):
  """DLRM forward over precomputed embedding activations.

  Args:
    vocab_sizes: per categorical feature, its vocabulary size (the count
      of embedding activations the model takes).
    embedding_dim: embedding width (128 for the MLPerf config).
    bottom_mlp / top_mlp: dense stack widths; top ends in 1 logit.
    num_numerical: numerical features per sample (13 for Criteo).
    compute_dtype: dtype of the MLP/interaction compute (bf16 = AMP).
    device: where the parameters live; ``"cuda"`` unless the caller asks
      for the CPU.
    generator: CPU ``torch.Generator`` for the initial weights.
  """

  def __init__(self, vocab_sizes: Sequence[int], embedding_dim: int = 128,
               bottom_mlp: Tuple[int, ...] = (512, 256, 128),
               top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1),
               num_numerical: int = 13, compute_dtype=torch.float32,
               device="cuda", generator: Optional[torch.Generator] = None):
    super().__init__()
    dev = resolve_device(device)
    if bottom_mlp[-1] != embedding_dim:
      raise ValueError(
          f"bottom MLP must end at embedding_dim ({embedding_dim}), "
          f"got {bottom_mlp}")
    self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
    self.embedding_dim = embedding_dim
    self.compute_dtype = compute_dtype
    f = len(self.vocab_sizes) + 1
    self.bottom_mlp = MLP(num_numerical, bottom_mlp, activate_final=True,
                          dtype=compute_dtype, generator=generator)
    self.top_mlp = MLP(f * (f - 1) // 2 + embedding_dim, top_mlp,
                       dtype=compute_dtype, generator=generator)
    self.to(dev)

  def forward(self, numerical: torch.Tensor, categorical=None,
              emb_acts: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
    """numerical ``[B, num_numerical]``; ``emb_acts``: per categorical
    feature its ``[B, embedding_dim]`` activation. Returns ``[B]`` f32
    logits."""
    del categorical
    if emb_acts is None:
      raise NotImplementedError(
          "the port's DLRM takes its embedding activations through "
          "emb_acts (the embedding layer is not ported yet; "
          "serving.ServeEngine computes them from frozen tables)")
    bottom_out = self.bottom_mlp(numerical.to(self.compute_dtype))
    emb_outs = [e.to(self.compute_dtype) for e in emb_acts]
    x = dot_interact(bottom_out, emb_outs)
    logit = self.top_mlp(x.to(self.compute_dtype))
    return logit.squeeze(-1).float()


def dlrm_embedding_plan(vocab_sizes, embedding_dim: int = 128,
                        world_size: int = 1, strategy: str = "basic",
                        column_slice_threshold: Optional[int] = None,
                        dense_row_threshold: int = 4096,
                        row_slice: Optional[int] = None,
                        batch_hint: Optional[int] = None):
  """The placement plan of a DLRM's embeddings (same plan as the JAX
  package's ``dlrm_embedding_plan`` for the same arguments)."""
  from ..layers.embedding import TableConfig
  from ..layers.planner import DistEmbeddingStrategy

  tables = [TableConfig(input_dim=int(v), output_dim=embedding_dim)
            for v in vocab_sizes]
  return DistEmbeddingStrategy(tables, world_size, strategy,
                               column_slice_threshold=column_slice_threshold,
                               dense_row_threshold=dense_row_threshold,
                               row_slice_threshold=row_slice,
                               batch_hint=batch_hint)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
  """Mean sigmoid binary cross-entropy from logits (the JAX package's
  ``bce_loss``, in its numerically stable form)."""
  labels = labels.to(torch.float32)
  return torch.mean(torch.clamp(logits, min=0) - logits * labels
                    + torch.log1p(torch.exp(-torch.abs(logits))))

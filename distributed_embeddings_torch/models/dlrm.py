"""DLRM forward (PyTorch port of ``models/dlrm.py``).

Bottom MLP over the numerical features, the embedding activations, the
pairwise dot-product interaction over the lower triangle, and the top MLP
to one logit. ``compute_dtype=torch.bfloat16`` runs the MLPs and the
interaction in bf16 with f32 parameters, as the JAX model does.

The interaction runs kernel K2-fwd (``ops/cuda_interact.py``) on a CUDA
device, for f32 and bf16 models alike: on the card f32 operands are cast
to bf16 first (``mxu_operand_dtype``), as the JAX package does on the
TPU. On the CPU an f32 model keeps the JAX package's f32 einsum form.

Forward only: the embedding layer and the custom backward passes are not
ported yet, so :class:`DLRM` takes its embedding activations through
``emb_acts`` (which is how the serving and sparse training paths call it).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.cuda_interact import interact_parts_fwd
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


def dot_interact(bottom_out: torch.Tensor,
                 emb_outs: Sequence[torch.Tensor],
                 self_interaction: bool = False) -> torch.Tensor:
  """Pairwise dot-product interaction + bottom-MLP passthrough:
  ``[B, F*(F-1)/2 + D]`` (F = embeddings + 1) f32.

  On a CUDA device every case goes through K2-fwd's wrapper (f32 and
  bf16 operands run as bf16; any other type raises there); bf16 on the
  CPU takes the wrapper's plain version, and f32 on the CPU the JAX
  package's CPU form (the f32 pair einsum and the ``M`` selection
  einsum)."""
  parts = [bottom_out] + list(emb_outs)
  b, d = parts[0].shape
  bad = [tuple(p.shape) for p in parts if tuple(p.shape) != (b, d)]
  if bad:
    raise ValueError(
        f"dot_interact needs equal [B, D] features; got {bad} vs ({b}, {d})")
  cd = mxu_operand_dtype(parts[0].dtype, parts[0].device)
  k = 0 if self_interaction else -1
  if cd == torch.bfloat16 or parts[0].device.type == "cuda":
    acts = interact_parts_fwd([p.to(cd).contiguous() for p in parts], k)
  else:
    f = len(parts)
    feats = torch.cat([p.to(cd) for p in parts], dim=1).view(b, f, d)
    m_np, _ = _tril_select_np(f, k)
    m = torch.tensor(m_np, dtype=cd, device=feats.device)
    inter = torch.einsum("bpd,bqd->bpq", feats, feats)
    acts = torch.einsum("bpq,pqn->bn", inter, m).float()
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


def dlrm_scale_rows(plan, key, rank: int = 0) -> np.ndarray:
  """Per logical row of one class block, the DLRM initializer's uniform
  scale ``1/sqrt(vocab)`` of the table the row belongs to (0 on padding
  rows) — the ``scale_rows`` of ``init_packed_uniform``."""
  from ..parallel.lookup_engine import padded_rows
  cp = plan.classes[key]
  scale = np.zeros((padded_rows(plan, key),), np.float32)
  for sh, off in zip(cp.shards_per_rank[rank], cp.row_offsets_per_rank[rank]):
    vocab = plan.global_configs[sh.table_id].input_dim
    scale[off:off + sh.input_dim] = 1.0 / np.sqrt(vocab)
  return scale

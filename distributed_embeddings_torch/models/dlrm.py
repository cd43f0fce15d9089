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

:class:`DLRM` owns a :class:`~..layers.dist_model_parallel.
DistributedEmbedding` over its tables and, without ``emb_acts``, looks
the categorical ids up through it: the dense-autodiff path of
``training.make_train_step``, where ``loss.backward()`` gives every class
buffer its dense gradient. The serving and fused sparse training paths
compute the activations themselves and hand them in through ``emb_acts``;
their models are built with ``tables=False`` (no class buffers: the JAX
model initialized with ``emb_acts`` has no embedding params either).
:func:`bce_loss` is the training loss.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..layers.dist_model_parallel import DistributedEmbedding
from ..layers.embedding import TableConfig
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
  """DLRM with its embedding layer.

  Args:
    vocab_sizes: per categorical feature, its vocabulary size (26 for
      Criteo).
    embedding_dim: embedding width (128 for the MLPerf config).
    bottom_mlp / top_mlp: dense stack widths; top ends in 1 logit.
    num_numerical: numerical features per sample (13 for Criteo).
    compute_dtype: dtype of the MLP/interaction compute (bf16 = AMP).
    world_size / strategy / column_slice_threshold / row_slice /
      dense_row_threshold / batch_hint: the embedding layer's plan, as in
      the JAX model (``dlrm_embedding_plan`` with the same arguments gives
      the same plan).
    overlap / exchange_chunks: the plan's wire schedule (the JAX model's
      plan always takes ``'none'``; all three give the same values).
    wire_dtype / dedup_exchange: the plan's wire compression (``'f32'``,
      ``'bf16'`` or ``'fp8'``; the deduplicated exchange), passed to the
      embedding layer.
    mesh: this rank's :class:`~..parallel.mesh.Mesh` at world > 1: the
      embedding layer holds this rank's blocks only and the MLPs are
      replicated, all on the mesh's device (``world_size`` must be the
      mesh's).
    tables: build the embedding layer with its class buffers; False for a
      model that is handed its activations (``emb_acts``).
    device: where the parameters live without a mesh; ``"cuda"`` unless
      the caller asks for the CPU.
    generator: CPU ``torch.Generator`` for the MLPs' initial weights.
    table_generator: ``torch.Generator`` on the tables' device for their
      initial draws (None takes PyTorch's default generator); with a mesh
      it draws this rank's shards only, so seed it per rank.
  """

  def __init__(self, vocab_sizes: Sequence[int], embedding_dim: int = 128,
               bottom_mlp: Tuple[int, ...] = (512, 256, 128),
               top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1),
               num_numerical: int = 13, compute_dtype=torch.float32,
               world_size: int = 1, strategy: str = "basic",
               column_slice_threshold: Optional[int] = None,
               row_slice: Optional[int] = None,
               dense_row_threshold: int = 4096,
               batch_hint: Optional[int] = None, overlap: str = "none",
               exchange_chunks: int = 1, wire_dtype: str = "f32",
               dedup_exchange: bool = False, mesh=None, tables: bool = True,
               device="cuda", generator: Optional[torch.Generator] = None,
               table_generator: Optional[torch.Generator] = None):
    super().__init__()
    dev = mesh.device if mesh is not None else resolve_device(device)
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
    self.embeddings = None
    if tables:
      self.embeddings = DistributedEmbedding(
          [TableConfig(input_dim=v, output_dim=embedding_dim,
                       initializer=_dlrm_initializer(v))
           for v in self.vocab_sizes],
          strategy=strategy, column_slice_threshold=column_slice_threshold,
          row_slice=row_slice, world_size=world_size,
          dense_row_threshold=dense_row_threshold, batch_hint=batch_hint,
          overlap=overlap, exchange_chunks=exchange_chunks,
          wire_dtype=wire_dtype, dedup_exchange=dedup_exchange, mesh=mesh,
          device=dev, generator=table_generator)

  def forward(self, numerical: torch.Tensor, categorical=None,
              emb_acts: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
    """numerical ``[B, num_numerical]``; categorical: per feature its
    ``[B]`` (or ``[B, H]``) ids, looked up through the embedding layer;
    ``emb_acts`` overrides the lookup with per-feature ``[B,
    embedding_dim]`` activations. Returns ``[B]`` f32 logits."""
    if emb_acts is None:
      if self.embeddings is None:
        raise ValueError(
            "this DLRM was built with tables=False: pass its embedding "
            "activations through emb_acts")
      emb_acts = self.embeddings(categorical)
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


def _dlrm_initializer(rows: int):
  """Uniform(-1/sqrt(rows), 1/sqrt(rows)) per table (the reference's
  ``DLRMInitializer``, as the JAX model's ``_dlrm_initializer``)."""
  scale = 1.0 / np.sqrt(rows)

  def init(generator, shape, dtype=torch.float32, device=None):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        -scale, scale, generator=generator)

  init.scale = scale  # enables the direct packed init
  return init


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
  """Mean sigmoid binary cross-entropy from logits (the JAX package's
  ``bce_loss``, in its numerically stable form)."""
  labels = labels.to(torch.float32)
  return torch.mean(torch.clamp(logits, min=0) - logits * labels
                    + torch.log1p(torch.exp(-torch.abs(logits))))

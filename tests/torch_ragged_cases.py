"""Shared cases of the ragged value-stream parity tests
(``tests/test_torch_ragged_*.py``).

Ragged inputs are drawn with numpy as the JAX package's own tests draw
them (``tests/test_ragged_distributed.py: _make_ragged``): per-sample
lengths uniform in ``[0, max_hot]``, trimmed until they fit the static
capacity, the value buffer padded past ``row_splits[-1]``. A world-N
batch is the JAX package's global form: the ranks' blocks stacked (every
block's splits from 0), which the JAX step shards over its mesh and the
port's ``training.shard_batch`` cuts into each rank's block.

Both packages get the same numpy arrays: :func:`to_jax` and
:func:`to_port` wrap them; a port :class:`RaggedIds` with numpy fields
pickles to the spawned ranks (``tests/torch_ranks.py``).
"""

import jax.numpy as jnp
import numpy as np

from distributed_embeddings_torch.ops.ragged import RaggedIds as TRagged
from distributed_embeddings_tpu.ops.ragged import RaggedIds as JRagged

TOL = dict(rtol=1e-5, atol=1e-6)


def make_ragged(rng, b, vocab, max_hot, capacity, neg=0.0, min_hot=0):
  """``(values [capacity], row_splits [b + 1])`` int32: lengths uniform in
  ``[min_hot, max_hot]`` trimmed to the capacity, ids uniform over the
  vocabulary, a share ``neg`` of them -1 (skipped like PAD ids)."""
  lengths = rng.integers(min_hot, max_hot + 1, b)
  while lengths.sum() > capacity:
    i = rng.integers(0, b)
    lengths[i] = max(0, lengths[i] - 1)
  total = int(lengths.sum())
  values = rng.integers(0, vocab, total).astype(np.int32)
  if neg:
    values[rng.random(total) < neg] = -1
  values = np.concatenate([values, np.zeros(capacity - total, np.int32)])
  splits = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
  return values, splits


def stacked(blocks):
  """Per-rank ``(values, splits)`` blocks -> the global stacked form."""
  return (np.concatenate([v for v, _ in blocks]),
          np.concatenate([s for _, s in blocks]))


def ragged_input(rng, world, b_local, vocab, max_hot, capacity, neg=0.2,
                 min_hot=0):
  """A port RaggedIds (numpy fields) of ``world`` stacked blocks."""
  return TRagged(*stacked([make_ragged(rng, b_local, vocab, max_hot,
                                       capacity, neg, min_hot)
                           for _ in range(world)]))


def single_stream(x, world):
  """A stacked ragged input as one CSR stream over the global batch: the
  blocks' live values in order, the splits offset (the form a
  ``MicroBatcher`` dispatch carries)."""
  v, s = np.asarray(x.values), np.asarray(x.row_splits)
  cap, n = v.shape[0] // world, s.shape[0] // world
  vals, lens = [], []
  for r in range(world):
    sr = s[r * n:(r + 1) * n]
    vals.append(v[r * cap:r * cap + sr[-1]])
    lens.append(np.diff(sr))
  return TRagged(np.concatenate(vals), np.concatenate(
      [[0], np.cumsum(np.concatenate(lens))]).astype(s.dtype))


def to_jax(x):
  """A numpy input or a (port) RaggedIds -> the JAX package's form."""
  if isinstance(x, TRagged):
    return JRagged(jnp.asarray(np.asarray(x.values)),
                   jnp.asarray(np.asarray(x.row_splits)))
  return jnp.asarray(x)


def to_port(x):
  """A numpy input or a RaggedIds -> torch tensors (CPU)."""
  import torch
  if isinstance(x, TRagged):
    return TRagged(torch.as_tensor(np.asarray(x.values)),
                   torch.as_tensor(np.asarray(x.row_splits)))
  return torch.as_tensor(np.asarray(x))


def ragged_batches(n, vocab, hot, world, b_local, num, seed, neg=0.2):
  """``n`` global DLRM batches ``(numerical, cats, labels)``: input ``i``
  in ``hot`` is ragged with lengths in ``[0, hot[i]]`` and a per-rank
  capacity of ``b_local * hot[i] // 2 + 1``, every other input one-hot."""
  rng = np.random.default_rng(seed)
  out = []
  b = world * b_local
  for _ in range(n):
    cats = []
    for i, v in enumerate(vocab):
      if i in hot:
        cats.append(ragged_input(rng, world, b_local, v, hot[i],
                                 b_local * hot[i] // 2 + 1, neg))
      else:
        cats.append(rng.integers(0, v, b).astype(np.int32))
    out.append((rng.standard_normal((b, num)).astype(np.float32), cats,
                rng.integers(0, 2, b).astype(np.float32)))
  return out


def jax_batch(batch):
  return tuple([to_jax(x) for x in part] if isinstance(part, list)
               else to_jax(part) for part in batch)


def port_batch(batch):
  return tuple([to_port(x) for x in part] if isinstance(part, list)
               else to_port(part) for part in batch)

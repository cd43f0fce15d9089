"""One micro-batcher in front of a world-N serve engine: rank 0 leads,
the other ranks follow.

A world-N :class:`~.engine.ServeEngine` is one process per rank, and
every rank must run each dispatch with the same global request (its
collectives span the ranks). The JAX package puts its ``MicroBatcher`` in
front of a world-N engine from one controller; the port's ranks are
processes, so:

- **rank 0** runs the unchanged :class:`~.batcher.MicroBatcher` over a
  leading dispatch function (:class:`LeaderBatcher`). For each packed
  request it broadcasts a fixed header (the shapes and dtypes, padded or
  ragged, and a stop flag) and the packed payload (every categorical
  input's ids in one int64 tensor, the numerical features in one float
  tensor) to the other ranks, then calls ``engine.dispatch``;
- **every other rank** runs :func:`follow`: a blocking loop that
  receives each request and calls ``engine.dispatch`` with it, until the
  stop message that rank 0 sends from ``LeaderBatcher.close()``.

The header's last word carries a lockstep seq when the engine is a
streaming ``DeltaSubscriber`` (its ``lockstep_seq`` on rank 0): every
rank folds the published deltas through that seq
(``DeltaSubscriber.dispatch_at``) before the dispatch, so all ranks
promote at the same dispatch boundary.

Every process classifies and routes the same global request, so a tiered
engine's staged shapes agree with no further collective. What rank 0
rejects, sheds or fails to pack never reaches the leading function, so it
is never broadcast; a request is encoded whole before its first
broadcast, so once a header goes out its payload follows. A dispatch
that raises on every rank alike (a refusal in the classify, say) is
delivered to rank 0's requests, and the followers record it and go on
following (``serve/follow_errors``). The batcher's collectives run on its
flusher thread (or the caller's thread under ``flush_now``): no other
thread of rank 0 may use the process group while a :class:`LeaderBatcher`
is open.

:func:`world_batcher` is the entry point: at world 1 a plain
``MicroBatcher``, at world N rank 0's :class:`LeaderBatcher`, and on
every other rank the follow loop (it returns ``None`` once rank 0 closed
its batcher).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.ragged import RaggedIds
from .batcher import MicroBatcher

__all__ = ["LeaderBatcher", "follow", "world_batcher"]

_log = logging.getLogger(__name__)

# header words: [kind, n_cats, int words, batch, features, float dtype,
# float words, lockstep seq (0 unless the engine streams deltas)]
HEADER_WORDS = 8
_STOP, _REQUEST = 0, 1
# per categorical input: [ragged, ids dtype, a, b, c, d]
#   padded: 0, dtype, ndim, dim 0, dim 1 (0 for 1-D), 0
#   ragged: 1, values dtype, values, splits, splits dtype, 0
_CAT_WORDS = 6
_INT_DTYPES = (np.dtype(np.int32), np.dtype(np.int64))
_FLOAT_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))


def _code(dtype, table) -> int:
  dtype = np.dtype(dtype)
  if dtype not in table:
    raise TypeError(f"dtype {dtype} cannot ride the leader's broadcast "
                    f"(have {[str(d) for d in table]})")
  return table.index(dtype)


def _host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
      else np.asarray(x)


def encode_request(numerical, cats: Sequence):
  """A packed global request -> ``(header, ints, floats)`` numpy arrays
  (int64, int64, the features' own float type). Raises on what cannot be
  encoded, before anything is sent."""
  numerical = _host(numerical)
  if numerical.ndim != 2:
    raise ValueError(f"numerical features {numerical.shape}: [B, F] "
                     "expected")
  desc, parts = [], []
  for c in cats:
    if isinstance(c, RaggedIds):
      values, splits = _host(c.values), _host(c.row_splits)
      desc += [1, _code(values.dtype, _INT_DTYPES), values.shape[0],
               splits.shape[0], _code(splits.dtype, _INT_DTYPES), 0]
      parts += [values.reshape(-1), splits.reshape(-1)]
      continue
    c = _host(c)
    if c.ndim not in (1, 2):
      raise ValueError(f"categorical input {c.shape}: [B] or [B, H] "
                       "expected")
    desc += [0, _code(c.dtype, _INT_DTYPES), c.ndim, c.shape[0],
             c.shape[1] if c.ndim == 2 else 0, 0]
    parts.append(c.reshape(-1))
  ints = np.concatenate([np.asarray(desc, np.int64)]
                        + [p.astype(np.int64) for p in parts])
  floats = np.ascontiguousarray(numerical).reshape(-1)
  header = np.asarray(
      [_REQUEST, len(cats), ints.shape[0], numerical.shape[0],
       numerical.shape[1], _code(floats.dtype, _FLOAT_DTYPES),
       floats.shape[0], 0], np.int64)
  return header, ints, floats


def decode_request(header: np.ndarray, ints: np.ndarray,
                   floats: np.ndarray):
  """Inverse of :func:`encode_request`: ``(numerical, cats)``, numpy (a
  ragged input as a ``RaggedIds`` of numpy fields), in the types rank 0
  packed."""
  n_cats, batch, feats = int(header[1]), int(header[3]), int(header[4])
  numerical = floats.reshape(batch, feats)
  desc = ints[:n_cats * _CAT_WORDS].reshape(n_cats, _CAT_WORDS)
  off = n_cats * _CAT_WORDS
  cats = []
  for ragged, dt, a, b, c, _ in desc.tolist():
    if ragged:
      values = ints[off:off + a].astype(_INT_DTYPES[dt])
      splits = ints[off + a:off + a + b].astype(_INT_DTYPES[c])
      cats.append(RaggedIds(values, splits))
      off += a + b
      continue
    shape = (b,) if a == 1 else (b, c)
    n = b * (c if a == 2 else 1)
    cats.append(ints[off:off + n].astype(_INT_DTYPES[dt]).reshape(shape))
    off += n
  return numerical, cats


def _comm_device(mesh) -> torch.device:
  """Where the broadcasts' tensors live: the host under gloo (the
  request is host data), the rank's card under NCCL."""
  return torch.device("cpu") if mesh.backend == "gloo" else mesh.device


def _send(mesh, header, ints, floats) -> None:
  dev = _comm_device(mesh)
  dist.broadcast(torch.from_numpy(header).to(dev), src=0)
  if header[0] == _STOP:
    return
  dist.broadcast(torch.from_numpy(ints).to(dev), src=0)
  dist.broadcast(torch.from_numpy(floats).to(dev), src=0)


def _receive(mesh):
  """The next message from rank 0: ``None`` for the stop message, else
  ``(lockstep seq, (numerical, cats))``."""
  dev = _comm_device(mesh)
  header = torch.empty((HEADER_WORDS,), dtype=torch.int64, device=dev)
  dist.broadcast(header, src=0)
  header = header.cpu().numpy()
  if header[0] == _STOP:
    return None
  ints = torch.empty((int(header[2]),), dtype=torch.int64, device=dev)
  dist.broadcast(ints, src=0)
  fdt = torch.from_numpy(np.zeros(0, _FLOAT_DTYPES[int(header[5])])).dtype
  floats = torch.empty((int(header[6]),), dtype=fdt, device=dev)
  dist.broadcast(floats, src=0)
  return int(header[7]), decode_request(header, ints.cpu().numpy(),
                                        floats.cpu().numpy())


def _dispatch(engine, seq: int, request):
  """One dispatch on every rank alike: a streaming engine folds through
  the leader's seq first."""
  if hasattr(engine, "dispatch_at"):
    return engine.dispatch_at(seq, *request)
  return engine.dispatch(*request)


def follow(engine) -> int:
  """The follow loop of a rank other than 0: receive each request rank
  0's :class:`LeaderBatcher` dispatches and dispatch it on ``engine``,
  until rank 0 closes its batcher. A dispatch that raises is counted
  (``serve/follow_errors`` in the engine's registry) and logged with its
  traceback, and the loop goes on: rank 0 raised alike and delivered the
  error to its requests.
  Returns the number of requests followed."""
  mesh = engine.mesh
  if mesh is None or mesh.rank == 0:
    raise ValueError("follow() runs on the ranks other than 0 of a "
                     "world-N engine; rank 0 runs a LeaderBatcher")
  errors = engine.telemetry.counter("serve/follow_errors")
  n = 0
  while True:
    msg = _receive(mesh)
    if msg is None:
      return n
    try:
      _dispatch(engine, *msg)
    except Exception:  # noqa: BLE001 — rank 0 delivers it per request
      errors.inc()
      _log.exception("rank %d: a followed dispatch raised", mesh.rank)
    n += 1


class LeaderBatcher(MicroBatcher):
  """Rank 0's :class:`~.batcher.MicroBatcher` in front of a world-N
  engine: each packed dispatch is broadcast to the followers
  (:func:`follow`) before it runs here, and :meth:`close` sends them the
  stop message once the batcher has drained. Takes
  ``MicroBatcher``'s arguments besides the engine."""

  def __init__(self, engine, max_batch: int, **batcher_kw):
    mesh = engine.mesh
    if mesh is None or mesh.rank != 0:
      raise ValueError("a LeaderBatcher runs on rank 0 of a world-N "
                       "engine; the other ranks call follow(engine)")
    self.engine = engine
    self.mesh = mesh
    self._followers_stopped = False
    super().__init__(self._lead, max_batch, **batcher_kw)

  def _lead(self, numerical, cats):
    header, ints, floats = encode_request(numerical, cats)
    if hasattr(self.engine, "dispatch_at"):
      header[7] = self.engine.lockstep_seq()
    _send(self.mesh, header, ints, floats)
    return _dispatch(self.engine, int(header[7]), (numerical, cats))

  def close(self, drain: bool = True) -> None:
    """Stop the batcher (``drain``: flush what is pending first), then
    the followers."""
    try:
      super().close(drain)
    finally:
      if not self._followers_stopped:
        self._followers_stopped = True
        stop = np.zeros((HEADER_WORDS,), np.int64)
        stop[0] = _STOP
        _send(self.mesh, stop, None, None)


def world_batcher(engine, max_batch: int, **batcher_kw
                  ) -> Optional[MicroBatcher]:
  """The batcher of a serve engine at any world: at world 1 a
  ``MicroBatcher`` over ``engine.dispatch``; at world N, on rank 0, a
  :class:`LeaderBatcher`, and on every other rank :func:`follow` (it
  blocks until rank 0 closes its batcher, then returns ``None``)."""
  if engine.mesh is None:
    return MicroBatcher(engine.dispatch, max_batch, **batcher_kw)
  if engine.mesh.rank == 0:
    return LeaderBatcher(engine, max_batch, **batcher_kw)
  follow(engine)
  return None

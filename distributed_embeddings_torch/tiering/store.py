"""Host-RAM cold store for tiered classes, with the resident-set
bookkeeping (PyTorch port of ``tiering/store.py``).

One :class:`HostTierStore` holds, per host-tier class and per rank:

- ``images``: the FULL packed class image ``[phys_rows, phys_width]`` in
  host memory, in a device buffer's physical layout (optimizer-state
  lanes interleaved), so tier moves are block copies
  (``ops/packed_table.host_gather_rows`` / ``host_scatter_rows``);
- ``resident_map``: int32 ``[phys_rows]``, the physical row's hot-cache
  slot or -1 (the host mirror of the device-side translation map);
- ``resident_grps``: int32 ``[cache_grps]``, the inverse map (slot ->
  physical row);
- ``counts``: int64 ``[phys_rows]`` observed lookup counts, the
  re-ranking signal.

Authority: rows resident in the device cache have their authoritative
values ON DEVICE (the image copy goes stale between flushes); cold rows
are authoritative in the image (the prefetcher writes the staged rows
back every step). :meth:`HostTierStore.flush` reconciles before a
checkpoint.

At world N every rank is a process, and its store owns that rank only
(``owned_ranks=(mesh.rank,)``): the image bytes cover that rank, while
the resident maps, resident groups and counts are replicated for every
rank (they derive deterministically from the global batch stream, and
every process's classify must agree on every rank's hot/cold split so
that the staged shapes agree). Image access on an un-owned rank raises.
:meth:`HostTierStore.build_fused` and
:meth:`~HostTierStore.resident_arrays` return the owned ranks' device
blocks: this rank's block at world N, every rank's concatenated for a
store that owns all of them (world 1).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.packed_table import (
    host_gather_rows,
    host_scatter_rows,
    init_host_store,
    init_host_store_device,
)
from ..resilience import faultinject
from .plan import TieringPlan


# physical rows moved between a device buffer and a host image at a time
_MOVE_CHUNK = 1 << 16


def _host_rows(t: torch.Tensor) -> np.ndarray:
  """A device tensor's values as a numpy array that no later device write
  changes (on the CPU ``.numpy()`` would alias the tensor)."""
  t = t.detach()
  return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


class HostTierStore:
  """Cold-store images and resident-set state for one
  :class:`~.plan.TieringPlan` (f32 training images)."""

  def __init__(self, tplan: TieringPlan,
               owned_ranks: Optional[Iterable[int]] = None,
               dtype=np.float32):
    self.tplan = tplan
    self.plan = tplan.plan
    self.dtype = np.dtype(dtype)
    world = self.plan.world_size
    if owned_ranks is None:
      self.owned_ranks = tuple(range(world))
    else:
      self.owned_ranks = tuple(sorted(set(int(r) for r in owned_ranks)))
      if not self.owned_ranks:
        raise ValueError("owned_ranks must name at least one rank")
      if self.owned_ranks[0] < 0 or self.owned_ranks[-1] >= world:
        raise ValueError(
            f"owned_ranks {self.owned_ranks} outside [0, {world}) — the "
            "store shards by MESH rank, not process index")
    owned = frozenset(self.owned_ranks)
    self.images: Dict[str, List[Optional[np.ndarray]]] = {}
    self.resident_map: Dict[str, List[np.ndarray]] = {}
    self.resident_grps: Dict[str, List[np.ndarray]] = {}
    self.counts: Dict[str, List[np.ndarray]] = {}
    for c in tplan.classes.values():
      lay = c.layout_logical
      # images shard by owner; the resident/count bookkeeping replicates
      self.images[c.name] = [
          np.zeros((lay.phys_rows, lay.phys_width), self.dtype)
          if r in owned else None for r in range(world)]
      self.resident_map[c.name] = [
          np.full((lay.phys_rows,), -1, np.int32) for _ in range(world)]
      self.resident_grps[c.name] = [
          np.zeros((c.spec.cache_grps,), np.int32) for _ in range(world)]
      self.counts[c.name] = [
          np.zeros((lay.phys_rows,), np.int64) for _ in range(world)]
    self.warm_start()

  @property
  def owns_all(self) -> bool:
    return len(self.owned_ranks) == self.plan.world_size

  def _own(self, name: str, rank: int) -> int:
    """Validate that this store holds ``rank``'s block of ``name``."""
    rank = int(rank)
    if rank < 0 or rank >= self.plan.world_size \
        or self.images[name][rank] is None:
      raise ValueError(
          f"class {name!r} rank {rank} is not owned by this store "
          f"(owned_ranks={self.owned_ranks}): in a rank-owner-sharded "
          "cold store each process holds only its mesh ranks' blocks — "
          "route the access to the owning process (checkpoint.save / "
          "restore already do).")
    return rank

  # ---- initialization ----------------------------------------------------
  def _scale_rows(self, key, rank) -> np.ndarray:
    """Per-logical-row uniform-init scale of one rank's class block."""
    from ..training import init_scale_rows
    lay = self.tplan.classes[key].layout_logical
    scale = init_scale_rows(self.plan, key, rank).numpy()
    if scale.shape != (lay.rows,):
      raise ValueError(f"scale rows {scale.shape}, layout rows {lay.rows}")
    return scale

  def init_uniform(self, seed: int = 0, device=None) -> None:
    """Draw every OWNED image in place, deterministic in ``seed``, class
    and rank (a sharded store's processes draw disjoint ranks of one
    global initialization).

    ``device=None`` draws with numpy on the host, the JAX package's
    ``init_uniform`` draw for draw (the same seed gives the same image
    bits). With a ``device`` (``"cuda"``), each image is drawn there chunk
    by chunk and downloaded (``init_host_store_device``): the same
    distribution, at the host's copy rate rather than numpy's draw rate."""
    for ki, (key, c) in enumerate(sorted(
        self.tplan.classes.items(), key=lambda kv: kv[1].name)):
      for rank in self.owned_ranks:
        if device is None:
          rng = np.random.default_rng((seed, ki, rank))
          self.images[c.name][rank] = init_host_store(
              c.layout_logical, rng, self._scale_rows(key, rank),
              self.tplan.rule.aux_init)
          continue
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(
            (seed * 1_000_003 + ki) * 65_537 + rank)
        img = self.images[c.name][rank]
        if img.dtype != np.float32:
          raise ValueError("the device draw fills f32 images")
        init_host_store_device(
            c.layout_logical, gen, torch.from_numpy(
                self._scale_rows(key, rank)), self.tplan.rule.aux_init,
            out=img, device=dev)

  def set_image(self, name: str, rank: int, image: np.ndarray,
                copy: bool = True) -> None:
    """Install an explicit packed image (e.g. packed from a reference
    run's initial table, or a checkpoint block). ``copy=False`` adopts an
    image already in the store's dtype and C order without copying it (a
    serve store, whose images are never written, holds the artifact's
    own arrays)."""
    rank = self._own(name, rank)
    lay = self.tplan.by_name(name).layout_logical
    if image.shape != (lay.phys_rows, lay.phys_width):
      raise ValueError(f"image shape {image.shape}, expected "
                       f"{(lay.phys_rows, lay.phys_width)}")
    image = np.asarray(image, self.dtype)
    if copy or not image.flags.c_contiguous:
      image = image.copy()
    self.images[name][rank] = image

  def warm_start(self, ranking: Optional[Dict[str, List[np.ndarray]]] = None
                 ) -> None:
    """Choose the initial resident set.

    ``ranking[name][rank]``: physical rows in descending priority (e.g.
    restored counts, or profiled hotness). Default: the lowest row ids,
    which for the id-sorted-by-frequency vocabularies recommender
    pipelines emit (and the synthetic power-law streams) IS the hot set;
    the periodic re-rank repairs any other distribution."""
    world = self.plan.world_size
    for name, maps in self.resident_map.items():
      cache = self.tplan.by_name(name).spec.cache_grps
      for rank in range(world):
        if ranking is not None and name in ranking:
          grps = np.asarray(ranking[name][rank][:cache], np.int32)
          if grps.shape[0] < cache:
            # fill the remaining slots with the lowest unranked rows
            rest = np.setdiff1d(
                np.arange(maps[rank].shape[0], dtype=np.int32), grps,
                assume_unique=False)[:cache - grps.shape[0]]
            grps = np.concatenate([grps, rest])
        else:
          grps = np.arange(cache, dtype=np.int32)
        maps[rank][:] = -1
        maps[rank][grps] = np.arange(cache, dtype=np.int32)
        self.resident_grps[name][rank] = grps.copy()

  # ---- bounds-checked image access ---------------------------------------
  def check_rows(self, name: str, rank: int, grps: np.ndarray) -> np.ndarray:
    """Validate physical-row indices against a class's host image.

    Every index the prefetch pipeline derives from BATCH DATA passes
    through here before it touches an image, so a routing bug or a
    corrupt id stream fails with the class named and the offending index
    shown (a negative index would otherwise read the wrong rows
    silently). Pure bounds arithmetic, valid for ANY rank, owned or not."""
    grps = np.asarray(grps)
    if not grps.size:
      return grps
    c = self.tplan.by_name(name)
    lay = c.layout_logical
    lo, hi = int(grps.min()), int(grps.max())
    if lo < 0 or hi >= lay.phys_rows:
      bad = int(grps[(grps < 0) | (grps >= lay.phys_rows)][0])
      raise IndexError(
          f"class {name!r} rank {rank}: physical-row index {bad} is "
          f"outside this rank's host image [0, {lay.phys_rows}) "
          f"(= {lay.rows} logical vocab rows at {lay.rows_per_phys}/"
          "physical row). The ids came from the batch's routing "
          "arithmetic — this is a routing/classify bug or a corrupt id "
          "stream, not a capacity problem.")
    return grps

  def gather(self, name: str, rank: int, grps: np.ndarray) -> np.ndarray:
    """Bounds-checked cold-row gather from one rank's host image. The
    ``host_gather`` fault-injection site lives here (simulated transient
    read errors); the prefetcher retries it with backoff."""
    faultinject.fire("host_gather", clazz=name, rank=rank,
                     rows=int(np.asarray(grps).size))
    rank = self._own(name, rank)
    grps = self.check_rows(name, rank, grps)
    return host_gather_rows(self.tplan.by_name(name).layout_logical,
                            self.images[name][rank], grps)

  def scatter(self, name: str, rank: int, grps: np.ndarray,
              rows: np.ndarray) -> None:
    """Bounds-checked write-back into one rank's host image."""
    rank = self._own(name, rank)
    grps = self.check_rows(name, rank, grps)
    host_scatter_rows(self.tplan.by_name(name).layout_logical,
                      self.images[name][rank], grps, rows)

  # ---- device-state construction ----------------------------------------
  def local_ranks(self, mesh=None) -> tuple:
    """The ranks whose blocks this process's device arrays hold, in
    order: the mesh's rank at world N, every rank otherwise (the store
    must own them)."""
    if mesh is not None and self.plan.world_size > 1:
      if mesh.world != self.plan.world_size:
        raise ValueError(f"the mesh has {mesh.world} ranks, the plan "
                         f"{self.plan.world_size}")
      ranks = (mesh.rank,)
    else:
      ranks = tuple(range(self.plan.world_size))
    for name in self.images:
      for r in ranks:
        self._own(name, r)
    return ranks

  def _device_of(self, mesh, device) -> torch.device:
    return mesh.device if mesh is not None else resolve_device(device)

  def _upload_cache(self, name: str, rank: int, out: torch.Tensor) -> None:
    """Copy one rank's cache rows (the image at the resident set) into
    ``out`` (its ``[cache_grps, phys_width]`` device block), a chunk of
    :data:`_MOVE_CHUNK` rows at a time, so the host holds one chunk beside
    the image however large the cache."""
    rank = self._own(name, rank)
    img = self.images[name][rank]
    grps = self.resident_grps[name][rank]
    for c0 in range(0, grps.shape[0], _MOVE_CHUNK):
      g = grps[c0:c0 + _MOVE_CHUNK]
      if g.shape[0] and int(g[-1]) - int(g[0]) == g.shape[0] - 1 \
          and bool(np.all(np.diff(g) == 1)):
        rows = img[int(g[0]):int(g[-1]) + 1]  # a run: no gather copy
      else:
        rows = host_gather_rows(self.tplan.by_name(name).layout_logical,
                                img, g)
      out[c0:c0 + g.shape[0]].copy_(torch.from_numpy(rows))

  def build_fused(self, mesh=None, device="cuda") -> Dict[str, torch.Tensor]:
    """Compact device buffers ``[cache + staging, phys_width]`` per local
    rank (:meth:`local_ranks`, concatenated): cache rows copied from the
    images at the resident set, staging region zeroed. On the mesh's
    device, else ``device``."""
    dev = self._device_of(mesh, device)
    ranks = self.local_ranks(mesh)
    out = {}
    for c in self.tplan.classes.values():
      per = c.spec.cache_grps + c.spec.staging_grps
      buf = torch.zeros((len(ranks) * per, c.layout_logical.phys_width),
                        dtype=torch.from_numpy(np.zeros(0, self.dtype)).dtype,
                        device=dev)
      for i, r in enumerate(ranks):
        self._upload_cache(c.name, r, buf[i * per:i * per + c.spec.cache_grps])
      out[c.name] = buf
    return out

  def resident_arrays(self, mesh=None, device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Device translation maps ``[phys_rows]`` int32 per local rank
    (concatenated)."""
    dev = self._device_of(mesh, device)
    ranks = self.local_ranks(mesh)
    out = {}
    for c in self.tplan.classes.values():
      maps = [self.resident_map[c.name][r] for r in ranks]
      block = maps[0] if len(maps) == 1 else np.concatenate(maps)
      out[c.name] = torch.from_numpy(block).to(dev, copy=True)
    return out

  # ---- device -> host reconciliation -------------------------------------
  def _cache_block(self, fused: Dict[str, torch.Tensor], name: str,
                   rank: int) -> torch.Tensor:
    """``rank``'s cache rows (a view) of a device buffer that holds the
    blocks of this store's owned ranks in order (a world-N process: its
    own)."""
    spec = self.tplan.by_name(name).spec
    per = spec.cache_grps + spec.staging_grps
    buf = fused[name]
    if buf.shape[0] != per * len(self.owned_ranks):
      raise ValueError(
          f"class {name!r}: a device buffer of {buf.shape[0]} rows is not "
          f"the blocks of {per} rows of owned ranks {self.owned_ranks}")
    base = self.owned_ranks.index(rank) * per
    return buf[base:base + spec.cache_grps]

  def _rank_cache_rows(self, fused: Dict[str, torch.Tensor], name: str,
                       rank: int) -> np.ndarray:
    """``rank``'s cache rows of a device buffer (:meth:`_cache_block`), as
    host numpy."""
    return _host_rows(self._cache_block(fused, name, rank))

  def flush(self, fused: Dict[str, torch.Tensor]) -> None:
    """Copy every OWNED resident row's device value back into the host
    image (cold rows are already authoritative there); call before a
    checkpoint or a global weight view. A world-N process flushes its own
    rank; every process flushing covers the world. The rows come down a
    chunk of :data:`_MOVE_CHUNK` at a time through one host staging block
    (page-locked for a CUDA buffer)."""
    for name in self.images:
      lay = self.tplan.by_name(name).layout_logical
      for rank in self.owned_ranks:
        grps = self.resident_grps[name][rank]
        cache = self._cache_block(fused, name, rank)
        stage = torch.empty((min(_MOVE_CHUNK, grps.shape[0]),
                             lay.phys_width), dtype=cache.dtype,
                            pin_memory=cache.is_cuda)
        for c0 in range(0, grps.shape[0], _MOVE_CHUNK):
          g = grps[c0:c0 + _MOVE_CHUNK]
          rows = stage[:g.shape[0]].copy_(cache[c0:c0 + g.shape[0]])
          host_scatter_rows(lay, self.images[name][rank], g, rows.numpy())

  # ---- read-only reconciled views ---------------------------------------
  def snapshot_view(self, fused: Dict[str, torch.Tensor]
                    ) -> "TierStoreSnapshot":
    """Copy-on-snapshot view for async checkpoints: every OWNED image
    COPIED with the resident rows' device values scattered into the copy
    (``flush``'s reconciliation, without mutating the live images). The
    device reads happen here, synchronously; a background writer
    serializes the frozen view while training mutates this store."""
    return TierStoreSnapshot(self, fused)

  def overlay_reader(self, name: str, rank: int,
                     fused: Dict[str, torch.Tensor]):
    """Flush-free window reader over one rank's RECONCILED image:
    ``reader(p0, p1)`` returns a COPY of physical rows ``[p0, p1)`` with
    the resident rows' values overlaid from the device cache,
    byte-identical to flushing then slicing, with the live image left
    untouched. The cache rows are fetched once, on the first window that
    needs a resident row."""
    rank = self._own(name, rank)
    img = self.images[name][rank]
    grps = self.resident_grps[name][rank]
    lay = self.tplan.by_name(name).layout_logical
    cache: Dict[str, np.ndarray] = {}

    def read(p0: int, p1: int) -> np.ndarray:
      win = img[p0:p1].copy()
      sel = np.where((grps >= p0) & (grps < p1))[0]
      if sel.size:
        if "rows" not in cache:
          cache["rows"] = self._rank_cache_rows(fused, name, rank)
        self.check_rows(name, rank, grps[sel])
        win[grps[sel] - p0] = cache["rows"][sel]
      assert win.shape[1] == lay.phys_width
      return win

    return read


class TierStoreSnapshot:
  """Frozen, reconciled copy of a :class:`HostTierStore`'s checkpoint
  surface: ``tplan``/``plan``, ``owned_ranks``/``owns_all``, ``images``,
  ``resident_grps``, ``resident_map``, ``counts``, with ``flush`` a no-op
  (the resident rows were scattered into the image COPIES at
  construction). A background checkpoint writer serializes it while the
  training loop keeps gathering from and scattering into the live
  store."""

  def __init__(self, store: HostTierStore, fused: Dict[str, torch.Tensor]):
    self.tplan = store.tplan
    self.plan = store.plan
    self.dtype = store.dtype
    self.owned_ranks = store.owned_ranks
    owned = frozenset(store.owned_ranks)
    self.images: Dict[str, List[Optional[np.ndarray]]] = {}
    self.resident_map: Dict[str, List[np.ndarray]] = {}
    self.resident_grps: Dict[str, List[np.ndarray]] = {}
    self.counts: Dict[str, List[np.ndarray]] = {}
    for name in store.images:
      lay = store.tplan.by_name(name).layout_logical
      imgs: List[Optional[np.ndarray]] = []
      for rank in range(store.plan.world_size):
        if rank not in owned:
          imgs.append(None)
          continue
        img = store.images[name][rank].copy()
        host_scatter_rows(lay, img, store.resident_grps[name][rank],
                          store._rank_cache_rows(fused, name, rank))
        imgs.append(img)
      self.images[name] = imgs
      self.resident_map[name] = [m.copy()
                                 for m in store.resident_map[name]]
      self.resident_grps[name] = [g.copy()
                                  for g in store.resident_grps[name]]
      self.counts[name] = [c.copy() for c in store.counts[name]]

  @property
  def owns_all(self) -> bool:
    return len(self.owned_ranks) == self.plan.world_size

  def flush(self, fused: Dict[str, torch.Tensor]) -> None:
    """No-op: the view was reconciled at construction."""

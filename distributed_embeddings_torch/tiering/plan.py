"""Tiering plan: size each host-tier class's hot cache and staging region
(PyTorch port of ``tiering/plan.py``).

The :class:`~..layers.planner.DistEmbeddingStrategy` decides WHICH
classes are host-tier (``host_row_threshold``); this module decides their
device-side geometry:

- ``cache_grps``: resident hot physical rows per rank, sized against the
  per-device ``hbm_budget_bytes`` after the device-tier classes, the
  staging regions and the resident maps are accounted for (budget shares
  proportional to each class's cold-store size), or as a plain fraction
  of the class without a budget;
- ``staging_grps``: the persistent per-step staging region for the
  batch's cold rows. A batch stages at most ``staging_grps`` distinct cold
  physical rows before the spill path takes over
  (``prefetch.TieredPrefetcher``), so size it near the expected per-rank
  deduplicated cold row count.

Invariant: ``(cache_grps + staging_max) * rows_per_phys <= logical
rows``: the compact buffer is smaller than the vocabulary, and translated
compact ids stay below the routing sentinel, so the engine's sentinel and
mean-count comparisons hold unchanged and an id that missed both tiers
(the sentinel) lies past the compact buffer's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..layers.planner import DistEmbeddingStrategy
from ..ops.packed_table import PackedLayout, SparseRule
from ..parallel.lookup_engine import TierSpec, class_param_name, padded_rows


@dataclasses.dataclass(frozen=True)
class TieringConfig:
  """Knobs of the tiered storage subsystem.

  Attributes:
    hbm_budget_bytes: per-device budget covering ALL embedding-class
      buffers (device-tier classes and the host-tier caches, staging
      regions and maps). None: no budget, caches sized by
      ``cache_fraction``.
    cache_fraction: resident fraction of each host-tier class's physical
      rows without a budget.
    staging_grps: persistent staging physical rows per class per rank.
    rerank_interval: steps between resident-set re-rankings by observed
      counts (promotion and eviction); 0 disables.
    spill_factor_max: staging grows in ``staging_grps * 2^k`` buckets up
      to this factor when a batch's deduplicated cold rows overflow the
      base region; demand past ``staging_grps * spill_factor_max`` pads
      to exactly the deduplicated count. Updates are never dropped.
  """

  hbm_budget_bytes: Optional[int] = None
  cache_fraction: float = 0.25
  staging_grps: int = 1024
  rerank_interval: int = 0
  spill_factor_max: int = 16


@dataclasses.dataclass(frozen=True)
class TieredClassPlan:
  """Resolved geometry of one host-tier class."""

  key: tuple
  name: str
  spec: TierSpec
  layout_logical: PackedLayout  # full vocabulary (host image shape)
  layout_compact: PackedLayout  # cache + staging (device buffer shape)
  spill_cap_grps: int           # hard max staged rows for one step


class TieringPlan:
  """Per-class :class:`TierSpec` geometry and capacity accounting."""

  def __init__(self, plan: DistEmbeddingStrategy, rule: SparseRule,
               config: TieringConfig = TieringConfig()):
    host_keys = plan.host_tier_class_keys()
    if not host_keys:
      raise ValueError(
          "plan has no host-tier classes: set host_row_threshold on the "
          "DistEmbeddingStrategy (tables above it are host-offloaded)")
    if config.staging_grps < 1:
      raise ValueError(f"staging_grps must be >= 1, got "
                       f"{config.staging_grps}")
    self.plan = plan
    self.rule = rule
    self.config = config

    logical: Dict[tuple, PackedLayout] = {}
    for key in host_keys:
      cp = plan.classes[key]
      logical[key] = PackedLayout(rows=padded_rows(plan, key),
                                  width=cp.width, n_aux=rule.n_aux)

    # ---- cache sizing ----------------------------------------------------
    cache_of: Dict[tuple, int] = {}
    if config.hbm_budget_bytes is not None:
      report = plan.tier_capacity_report(rule.n_aux)
      fixed = report["device_bytes_per_rank"]
      for key in host_keys:
        lay = logical[key]
        staging = min(config.staging_grps, lay.phys_rows - 1)
        # staging rows + the int32 resident map (4 B per physical row)
        fixed += (staging * lay.phys_width + lay.phys_rows) * 4
      avail = config.hbm_budget_bytes - fixed
      if avail <= 0:
        raise ValueError(
            f"hbm_budget_bytes={config.hbm_budget_bytes:,} leaves no room "
            f"for hot caches: device-tier classes + staging regions + "
            f"resident maps already need {fixed:,} bytes/rank. Raise the "
            "budget, lower host_row_threshold (offload more classes), or "
            "shrink staging_grps.")
      total_w = sum(logical[k].phys_rows for k in host_keys)
      for key in host_keys:
        lay = logical[key]
        share = avail * lay.phys_rows // total_w
        cache_of[key] = max(1, share // (lay.phys_width * 4))
    else:
      for key in host_keys:
        cache_of[key] = max(1, int(logical[key].phys_rows
                                   * config.cache_fraction))

    # ---- per-class geometry ---------------------------------------------
    self.classes: Dict[tuple, TieredClassPlan] = {}
    for key in host_keys:
      lay = logical[key]
      name = class_param_name(*key)
      rpp = lay.rows_per_phys
      # compact ids must stay under the logical sentinel (module doc):
      # cache + staging (spill growth included) <= rows // rpp
      hard_cap = lay.rows // rpp
      staging = min(config.staging_grps, max(1, lay.phys_rows - 1))
      cache = min(cache_of[key], hard_cap - staging)
      if cache < 1:
        raise ValueError(
            f"class {name}: no room for a hot cache "
            f"(staging_grps={staging}, class has {lay.phys_rows:,} "
            "physical rows). Shrink staging_grps or raise the budget — "
            "or keep the class on device (raise host_row_threshold): "
            "tiering a class this small cannot shrink it.")
      spec = TierSpec(name=name, rows=lay.rows, rpp=rpp,
                      cache_grps=cache, staging_grps=staging)
      compact = PackedLayout(rows=spec.compact_rows, width=lay.width,
                             n_aux=rule.n_aux)
      # the TPU's per-buffer bound, kept where the plan keeps it (a plan
      # built with buffer_elements=None indexes in 64 bits)
      limit = getattr(plan, "buffer_elements", 2 ** 31)
      if limit is not None and \
          compact.phys_rows * compact.phys_width > limit:
        raise ValueError(
            f"class {name}: compact buffer [{compact.phys_rows:,} x "
            f"{compact.phys_width}] exceeds XLA's 2^31-element indexing; "
            "shrink the cache (budget) or shard finer.")
      self.classes[key] = TieredClassPlan(
          key=key, name=name, spec=spec, layout_logical=lay,
          layout_compact=compact, spill_cap_grps=hard_cap - cache)

    self.tier_specs: Dict[str, TierSpec] = {
        c.name: c.spec for c in self.classes.values()}
    # fused_layouts() substitution: device buffers at compact size
    self.rows_overrides: Dict[str, int] = {
        c.name: c.spec.compact_rows for c in self.classes.values()}

  def geometry(self) -> Dict[str, Dict[str, int]]:
    """Per-class tier geometry as plain ints: the checkpoint manifest's
    ``tiering.classes`` section, which a restore validates its store's
    plan against."""
    return {c.name: {"cache_grps": c.spec.cache_grps,
                     "staging_grps": c.spec.staging_grps,
                     "phys_rows": c.layout_logical.phys_rows,
                     "phys_width": c.layout_logical.phys_width}
            for c in self.classes.values()}

  def by_name(self, name: str) -> TieredClassPlan:
    for c in self.classes.values():
      if c.name == name:
        return c
    raise KeyError(name)

  def device_bytes_per_rank(self) -> int:
    """Device bytes the tiered classes occupy per rank (compact buffers +
    resident maps)."""
    total = 0
    for c in self.classes.values():
      total += c.layout_compact.phys_rows * c.layout_compact.phys_width * 4
      total += c.layout_logical.phys_rows * 4  # int32 resident map
    return total

  def host_bytes_per_rank(self) -> int:
    """Host RAM the cold stores occupy per rank (full packed images)."""
    return sum(
        c.layout_logical.phys_rows * c.layout_logical.phys_width * 4
        for c in self.classes.values())

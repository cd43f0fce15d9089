"""Tiered embedding storage: host-RAM cold rows with a device hot cache
(PyTorch port of ``tiering/``).

Embedding tables larger than one card's memory train on it through a
storage hierarchy:

- the planner marks classes of tables above ``host_row_threshold`` as
  host-tier (``layers/planner.py``);
- each host-tier class keeps its FULL packed image (table rows with
  interleaved optimizer-state lanes) in host RAM (:class:`HostTierStore`),
  while the device holds a compact buffer: a frequency-ranked hot cache
  plus a fixed staging region (:class:`TieringPlan` sizes both, against a
  device budget or as a fraction);
- per step, a prefetcher dedups the batch's ids, classifies them hot or
  cold, host-gathers the cold rows and uploads them into the staging
  region (:class:`TieredPrefetcher`); the routed ids are translated to
  compact slots inside the step (``parallel/lookup_engine.
  translate_tiered_ids``), so the fused gather and the one scatter-add per
  class of the sparse step cover both tiers unchanged (K1, and K4 under
  ``overlap='fused'``, on the compact buffers);
- after the step the updated staging rows are written back to the host
  image; periodically the resident set is re-ranked by observed counts
  (promotion and eviction);
- a staging overflow spills into a power-of-two-bucketed larger upload;
  updates are never dropped.

At world N every rank is a process whose store owns its rank's images
and replicates every rank's bookkeeping (:class:`HostTierStore`).
"""

from .plan import TieredClassPlan, TieringConfig, TieringPlan
from .prefetch import TieredPrefetcher
from .store import HostTierStore, TierStoreSnapshot
from .train import (
    TieredTrainer,
    init_tiered_state,
    init_tiered_state_from_fused,
    init_tiered_state_from_params,
    unpack_tiered_state,
)

__all__ = [
    "TieringConfig",
    "TieringPlan",
    "TieredClassPlan",
    "TieredPrefetcher",
    "HostTierStore",
    "TierStoreSnapshot",
    "TieredTrainer",
    "init_tiered_state",
    "init_tiered_state_from_fused",
    "init_tiered_state_from_params",
    "unpack_tiered_state",
]

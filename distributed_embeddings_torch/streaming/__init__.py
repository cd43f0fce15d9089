"""Online learning: row-granular streaming from trainer to serving
(PyTorch port of ``streaming/``).

A production recommender retrains continuously, and its train -> serve
freshness lag is a product metric; a full frozen-table re-export gates
freshness on re-publishing every row. This package streams instead:

- :mod:`.generations`: :class:`RowGenerationTracker` stamps each observed
  batch's routed logical rows with a monotone clock (routing is a pure
  host computation, ``plan.routing_recipe``), which identifies exactly
  the rows a delta must ship;
- :mod:`.publish`: :class:`DeltaPublisher` gathers the advanced rows of
  each rank block in one pass on its device (K4 on the card), quantizes
  them with the serve row codecs (f32 / int8 / fp8) and seals them as
  ``delta_<seq>/`` through the crc32-manifest-last protocol with a
  sha256-chained ``base_fingerprint`` a delta: torn, out-of-order or
  forked deltas are refused by construction;
- :mod:`.subscribe`: :class:`DeltaSubscriber` polls the publish
  directory, validates the chain and folds deltas into a running
  ``ServeEngine`` by copy-on-promote (build off the dispatch lock, swap
  the references between dispatches), re-ranks the tiered serve cache
  with the shipped counts, promotes the dynvocab snapshot, and measures
  ``stream/freshness_s``; at world N the ranks fold in lockstep behind
  the rank-0 batcher;
- :mod:`.compact`: :class:`DeltaCompactor` folds ``delta_1..k`` into a
  new sealed base and garbage-collects folded deltas under the
  subscribers' heartbeat retention floor.

The publisher's chain state persists through the checkpoint manifest's
``stream`` section (``checkpoint.save(stream=)``,
``ResilientTrainer(stream=)``), and :meth:`DeltaPublisher.attach`
re-joins the chain after a kill. The directories on disk are the JAX
package's, file for file: either package's subscriber folds the other's
chain.
"""

from .compact import DeltaCompactor, compact_chain
from .generations import RowGenerationTracker
from .publish import (
    BASE_DIR,
    ChainDivergedError,
    DeltaPublisher,
    artifact_bytes,
    chain_anchor,
    delta_dirname,
    extract_changed_rows,
    published_delta_seqs,
    read_heartbeats,
    write_heartbeat,
)
from .subscribe import DeltaSubscriber, poll_phase

__all__ = [
    "poll_phase",
    "BASE_DIR",
    "ChainDivergedError",
    "DeltaCompactor",
    "DeltaPublisher",
    "DeltaSubscriber",
    "RowGenerationTracker",
    "artifact_bytes",
    "chain_anchor",
    "compact_chain",
    "delta_dirname",
    "extract_changed_rows",
    "published_delta_seqs",
    "read_heartbeats",
    "write_heartbeat",
]

"""Dynamic vocabularies: the id space itself becomes mutable state
(PyTorch port of ``distributed_embeddings_tpu/dynvocab``).

Every subsystem before this one — tiering, resilience, the compressed
and overlapped exchanges, elastic pods, serving — assumed a frozen id
space; production recommenders never see one (PAPERS.md: "Scalable ML
Training Infrastructure for Online Ads at Google"). This subsystem
replaces the static-vocab assumption with a dynamic id layer, riding the
OOV-policy plumbing of the resilience round: where ``oov='clip'|'error'``
clamp or reject out-of-range ids, ``oov='allocate'`` ALLOCATES for them:

- a host-side open-addressing translation table per sparse-kind table
  maps raw 64-bit ids onto physical rows of the EXISTING packed class
  buffers (:mod:`.table`), run between steps like the tiered
  prefetcher's classify — the step sees only translated in-range ids,
  so it runs exactly as a static plan's (K1, K2, and K4 on the fused
  wire) and the one-scatter-add backward is untouched;
- count-min-sketch admission (:mod:`.admission`): an id must be observed
  ``admit_threshold`` times before it earns a row — one-shot ids (the
  bulk of a power-law tail) never allocate;
- TTL eviction recycles rows in place through a freelist
  (:mod:`.lifecycle`): an expired row's table AND interleaved
  optimizer-state lanes re-zero in place on the card before reuse, so a
  re-admitted id starts training-neutral;
- per-class lifecycle counters ``[allocs, evictions, admit_denied,
  occupancy]`` surface in the step metrics next to ``oov`` /
  ``dedup_overflow`` (:class:`DynVocabTrainer`), at world 1 and N;
- the whole id space — mapping, sketch, freelist, cumulative counters —
  persists through the crc32-manifest-last checkpoint protocol under a
  ``vocab`` manifest section, so ``ResilientTrainer(dynvocab=...)``
  auto-resume restores it exactly (the consumed-batch discipline of the
  stream position, applied to rows); serving takes a read-only snapshot
  (``serving.export(vocab=)``, :class:`ReadonlyIdTranslator`).

The translation, the sketch and the freelist are host numpy, bit-equal
to the JAX package's on the same batches; the only device work is the
in-place re-zeroing of recycled rows.
"""

from .admission import CountMinSketch
from .lifecycle import RowRecycler, apply_zero_work, zero_rows_update
from .table import IdTranslationTable, ReadonlyIdTranslator
from .trainer import DynVocabTrainer, DynVocabTranslator

__all__ = [
    "CountMinSketch",
    "DynVocabTrainer",
    "DynVocabTranslator",
    "IdTranslationTable",
    "ReadonlyIdTranslator",
    "RowRecycler",
    "apply_zero_work",
    "zero_rows_update",
]

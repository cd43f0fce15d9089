"""Plain-data table descriptions for the planner.

Counterpart of ``TableConfig`` in ``distributed_embeddings_tpu/layers/
embedding.py``. The port serves frozen tables, so it needs the planner's
input only; the flax ``Embedding`` / ``ConcatOneHotEmbedding`` layers and
the initializer registry are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class TableConfig:
  """One embedding table as the planner sees it (reference layer config
  dict fields)."""

  input_dim: int
  output_dim: int
  combiner: Optional[str] = None
  initializer: Any = "uniform"
  regularizer: Any = None
  constraint: Any = None
  name: Optional[str] = None
  # dynamic-vocabulary cap (plan oov='allocate' only); the planner
  # refuses it on static plans, exactly as the JAX planner does
  vocab_capacity: Optional[int] = None

  def size(self) -> int:
    return self.input_dim * self.output_dim

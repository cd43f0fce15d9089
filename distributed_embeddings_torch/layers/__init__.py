"""Embedding layers, table descriptions and the sharding planner."""

from .dist_model_parallel import (
    DistributedEmbedding,
    get_weights,
    set_weights,
)
from .embedding import (
    ConcatOneHotEmbedding,
    Embedding,
    TableConfig,
    collect_regularization_losses,
    resolve_constraint,
    resolve_regularizer,
)
from .planner import DistEmbeddingStrategy

__all__ = [
    "ConcatOneHotEmbedding",
    "DistEmbeddingStrategy",
    "DistributedEmbedding",
    "Embedding",
    "TableConfig",
    "collect_regularization_losses",
    "get_weights",
    "resolve_constraint",
    "resolve_regularizer",
    "set_weights",
]

"""Embedding layers, table descriptions and the sharding planner."""

from .dist_model_parallel import (
    BroadcastGlobalVariablesCallback,
    DistributedEmbedding,
    DistributedGradientTape,
    DistributedOptimizer,
    broadcast_variables,
    finalize_hybrid_grads,
    get_weights,
    hybrid_partition_specs,
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
    "BroadcastGlobalVariablesCallback",
    "ConcatOneHotEmbedding",
    "DistEmbeddingStrategy",
    "DistributedEmbedding",
    "DistributedGradientTape",
    "DistributedOptimizer",
    "Embedding",
    "TableConfig",
    "broadcast_variables",
    "collect_regularization_losses",
    "finalize_hybrid_grads",
    "get_weights",
    "hybrid_partition_specs",
    "resolve_constraint",
    "resolve_regularizer",
    "set_weights",
]

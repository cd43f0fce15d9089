"""Embedding placement: table descriptions and the sharding planner."""

from .embedding import TableConfig
from .planner import DistEmbeddingStrategy

__all__ = ["DistEmbeddingStrategy", "TableConfig"]

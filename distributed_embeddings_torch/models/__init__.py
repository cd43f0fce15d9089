"""Models: the DLRM (forward and backward), its loss, and the synthetic
benchmark zoo."""

from .dlrm import DLRM, bce_loss, dlrm_embedding_plan, dot_interact
from .synthetic import (
    SYNTHETIC_MODELS,
    EmbeddingGroup,
    SyntheticModel,
    SyntheticModelConfig,
    expand_tables,
    generate_batch,
    model_size_gib,
    power_law_ids,
    synthetic_plan,
)

__all__ = [
    "DLRM",
    "bce_loss",
    "dlrm_embedding_plan",
    "dot_interact",
    "SYNTHETIC_MODELS",
    "EmbeddingGroup",
    "SyntheticModel",
    "SyntheticModelConfig",
    "expand_tables",
    "generate_batch",
    "model_size_gib",
    "power_law_ids",
    "synthetic_plan",
]

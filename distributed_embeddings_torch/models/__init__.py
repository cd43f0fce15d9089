"""Models: the DLRM (forward and backward) and its loss."""

from .dlrm import DLRM, bce_loss, dlrm_embedding_plan, dot_interact

__all__ = ["DLRM", "bce_loss", "dlrm_embedding_plan", "dot_interact"]

"""Models: the DLRM forward."""

from .dlrm import DLRM, dlrm_embedding_plan, dot_interact

__all__ = ["DLRM", "dlrm_embedding_plan", "dot_interact"]

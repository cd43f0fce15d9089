"""The process group, the wire and the distributed lookup engine."""

from . import wire
from .lookup_engine import (
    Bucket,
    DedupRouted,
    DistributedLookup,
    class_buckets,
    class_param_name,
    padded_rows,
)
from .mesh import Mesh, create_mesh

__all__ = [
    "Bucket",
    "DedupRouted",
    "DistributedLookup",
    "Mesh",
    "wire",
    "class_buckets",
    "class_param_name",
    "create_mesh",
    "padded_rows",
]

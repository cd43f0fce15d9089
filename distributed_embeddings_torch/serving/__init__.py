"""Serving on frozen tables: freeze or export a train state, load the
artifact, serve predictions, micro-batch concurrent requests."""

from .batcher import REJECT_REASONS, MicroBatcher, Rejected, ServeFuture
from .engine import ServeEngine, make_serve_step, shard_batch
from .export import (
    SERVE_FORMAT_VERSION,
    FrozenTables,
    ServeArtifact,
    ServeClassMeta,
    dequantize_rows_fp8,
    dequantize_rows_int8,
    export,
    freeze,
    frozen_device_state,
    load,
    quantize_rows_fp8,
    quantize_rows_int8,
)

__all__ = [
    "FrozenTables", "MicroBatcher", "REJECT_REASONS", "Rejected",
    "SERVE_FORMAT_VERSION", "ServeArtifact", "ServeClassMeta",
    "ServeEngine", "ServeFuture", "dequantize_rows_fp8",
    "dequantize_rows_int8", "export", "freeze", "frozen_device_state",
    "load", "make_serve_step", "quantize_rows_fp8", "quantize_rows_int8",
    "shard_batch",
]

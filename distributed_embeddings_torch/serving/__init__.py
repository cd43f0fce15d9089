"""Serving on frozen tables: freeze a train state, serve predictions."""

from .engine import ServeEngine, make_serve_step, shard_batch
from .export import (
    FrozenTables,
    ServeClassMeta,
    dequantize_rows_int8,
    freeze,
    frozen_device_state,
    quantize_rows_int8,
)

__all__ = [
    "FrozenTables", "ServeClassMeta", "ServeEngine", "dequantize_rows_int8",
    "freeze", "frozen_device_state", "make_serve_step", "quantize_rows_int8",
    "shard_batch",
]

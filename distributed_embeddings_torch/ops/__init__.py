"""Packed table storage and the CUDA kernels (``cuda_*.py`` wrappers over
``csrc/``), and the row-sparse gradients with their table-level
optimizers (``sparse_grad``)."""

from .sparse_grad import (
    SparseAdagradState,
    SparseAdamState,
    SparseMomentumState,
    SparseOptimizer,
    SparseRows,
    SparseSgdState,
    dedup_rows,
    expand_unique_rows,
    sparse_adagrad,
    sparse_adam,
    sparse_momentum,
    sparse_optimizer,
    sparse_sgd,
    unique_ids_map,
)

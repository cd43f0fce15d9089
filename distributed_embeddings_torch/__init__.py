"""PyTorch + CUDA port of distributed_embeddings_tpu.

The JAX package ``distributed_embeddings_tpu`` is the reference; this
package ports it slice by slice to PyTorch on an NVIDIA H100, with every
TPU kernel on a ported path rewritten by hand for Hopper. It imports
``torch`` and numpy only, never JAX or the JAX package.

Ported so far: DLRM serving (``serving``), the fused sparse train step
at world 1 and across ranks (``training.make_sparse_train_step``), the
synthetic zoo (``models.synthetic``), and the dense-autodiff step of the
README's Quick start (``layers.DistributedEmbedding``,
``training.make_train_step``), and the README's wire compression
(``dedup_exchange``, ``dedup_capacity``, the bf16 and fp8 wires), and
online learning (``streaming``: row-granular deltas from a training run
into a running serve engine), with every TPU kernel as a CUDA kernel
(``ops/cuda_*.py`` over ``csrc/``). Entry points run on
``device="cuda"`` unless the caller asks for the CPU.
"""

"""PyTorch + CUDA port of distributed_embeddings_tpu (first slice: serving).

The JAX package ``distributed_embeddings_tpu`` is the reference; this
package ports it slice by slice to PyTorch on an NVIDIA H100, with every
TPU kernel on a ported path rewritten by hand for Hopper. It imports
``torch`` and numpy only, never JAX or the JAX package.

Slice 1 is the DLRM serving path at world 1: freeze a train state into
f32 or int8 serve images, build a :class:`serving.ServeEngine` and answer
requests, with the pairwise interaction in a CUDA kernel
(``ops/cuda_interact.py``). Entry points run on ``device="cuda"`` unless
the caller asks for the CPU.
"""

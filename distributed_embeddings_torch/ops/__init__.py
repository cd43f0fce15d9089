"""Packed table storage and the CUDA kernels (``cuda_*.py`` wrappers over
``csrc/``)."""

"""Exact int8 matrix product: CUDA kernel (``ops``) and plain version (``ref``)."""

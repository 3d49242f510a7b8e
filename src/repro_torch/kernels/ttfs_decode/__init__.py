"""Grouped-TTFS decode: CUDA kernel (``ops``) and plain version (``ref``)."""

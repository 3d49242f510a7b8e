"""Event accumulation: CUDA kernel (``ops``) and plain version (``ref``)."""

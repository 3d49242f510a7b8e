"""The LIF scan over currents: CUDA kernel (``ops``) and plain version (``ref``)."""

"""Online-softmax attention: CUDA kernel (``ops``) and plain version (``ref``)."""

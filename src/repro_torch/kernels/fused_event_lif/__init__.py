"""Fused event->LIF->decode: CUDA kernels (``ops``) and plain versions (``ref``)."""

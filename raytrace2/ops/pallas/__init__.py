"""Pallas kernels: the path-regeneration megakernel (Triton on the GPU)."""

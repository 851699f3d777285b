"""The denoiser's stages on torch tensors, and the wrappers of the two
CUDA kernels (``warp_blend``, ``fit_reconstruct_cholesky``)."""

"""Hand-written CUDA kernels of the search path, each beside its plain
PyTorch version. A wrapper launches its kernel for CUDA tensors (or
raises) and takes the plain version only for CPU tensors; each counts its
launches in a plain integer attribute (`wrapper.launches`)."""

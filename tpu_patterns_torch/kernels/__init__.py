"""Build and load of the package's hand-written CUDA kernels."""

"""Image featurizers and their CUDA kernels."""

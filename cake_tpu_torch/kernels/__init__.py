"""Build and load the port's hand-written CUDA kernels (see build.py)."""

"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the build that compiles them (route: nvcc into a shared library with a C
interface, loaded with ctypes)."""

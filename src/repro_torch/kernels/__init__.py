"""The port's kernels: CUDA C++ sources in `csrc/`, their ctypes
wrappers and plain PyTorch versions here, routed by `ops`."""

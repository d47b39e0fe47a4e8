"""Kernels: the oracle (``ref``), the super-step loops (``ops``), the
streaming kernel's wrapper and plain version (``builder``), and its CUDA
source (``csrc/stencil_stream.cu``), built by ``_build``."""

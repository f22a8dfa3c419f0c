"""strawberry_tpu_torch: the PyTorch/CUDA port of strawberry_tpu.

It runs the same CLI (`python -m strawberry_tpu_torch.cli`) with the
device work as hand-written CUDA kernels for Hopper (csrc/*.cu, built by
nvcc at first use). It stands on its own: the host layer (config, sim,
io/, core/, the host modules of assembly/ and quant/, utils/) is a copy of
the JAX package's at the same relative paths, and the host C++ library is
built by g++ at first use from this package's own native/ sources. It
imports neither jax nor anything of strawberry_tpu.
"""
__version__ = "0.1.0"

"""openvla_oft_tpu_torch: the PyTorch / CUDA port of openvla_oft_tpu.

The JAX package `openvla_oft_tpu` stays the reference. This package imports
torch and numpy and never JAX; it reuses only the JAX package's jax-free host
modules (config, constants, serving.server, serving.json_numpy). Module paths
mirror the JAX package. Kernels written by hand for Hopper live in `csrc/` and
are built at first use by `_build.py`.
"""

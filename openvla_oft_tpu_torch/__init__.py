"""openvla_oft_tpu_torch: the PyTorch / CUDA port of openvla_oft_tpu.

The JAX package `openvla_oft_tpu` stays the reference. This package imports
torch, numpy and the standard library, and nothing of the JAX package: where
it needs one of that package's host modules (config, constants, the action
tokenizer, the CLI parser, the collator, metrics, recipes, the HTTP server)
it keeps its own copy at the matching path. Module paths mirror the JAX
package. Kernels written by hand for Hopper live in `csrc/` and are built at
first use by `_build.py`.
"""

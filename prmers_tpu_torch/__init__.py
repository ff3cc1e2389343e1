"""prmers_tpu_torch — the PyTorch/CUDA port of prmers_tpu for NVIDIA Hopper.

The JAX package `prmers_tpu` stays the reference. This package runs the
same PRP / Lucas-Lehmer squaring path with hand-written CUDA kernels
(`csrc/`, built with nvcc at first use and bound with ctypes), and keeps a
plain torch version of every kernel beside it: a kernel wrapper given a
CPU tensor runs the plain version, a CUDA tensor launches the kernel.

The host-side modules (plan, field, digits, GMP, checkpoints, the Engine
API, the PRP/LL driver, the CLI and the result JSON) are the port's own
copies of the JAX package's, under the same paths (`core/`, `engine/api`,
`io/`, `modes/`, `utils/`), so checkpoints, result JSON and CLI parsing
stay byte-identical. This package imports neither jax nor `prmers_tpu`.
"""

__version__ = "0.1.0"

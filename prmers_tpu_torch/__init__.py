"""prmers_tpu_torch — the PyTorch/CUDA port of prmers_tpu for NVIDIA Hopper.

The JAX package `prmers_tpu` stays the reference. This package runs the
same PRP / Lucas-Lehmer squaring path with hand-written CUDA kernels
(`csrc/`, built with nvcc at first use and bound with ctypes), and keeps a
plain torch version of every kernel beside it: a kernel wrapper given a
CPU tensor runs the plain version, a CUDA tensor launches the kernel.

Host-side modules that need no jax (plan, digits, checkpoints, the PRP/LL
driver, the CLI) are imported from `prmers_tpu` rather than copied. This
package never loads jax.
"""

__version__ = "0.1.0"

"""swirlfem_tpu_torch: the PyTorch + CUDA port of swirlfem_tpu.

Mirrors the JAX package's module layout (core/, utils/, ops/, linalg/,
nse/, niles/).  This slice runs the 2D, single-device, structured, fully
periodic spectral-element Navier-Stokes step and the Kolmogorov DNS datagen
on it.  The Pallas TPU kernels of that path are hand-written CUDA kernels
for Hopper (csrc/), built with nvcc at first use on a CUDA device; every
kernel has a plain PyTorch version that CPU tensors take.  Importing the
package builds nothing and needs no CUDA.
"""

__version__ = '0.1.0'

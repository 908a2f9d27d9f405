"""PyTorch/CUDA port of the ecwave spectral wave model.

The JAX package ``ecwam_tpu`` is the reference; this package mirrors its
module paths and function names.  Plain tensor code is PyTorch; the
Pallas TPU kernels are CUDA kernels written for Hopper (``csrc/``), built
at first use by :mod:`ecwam_tpu_torch._build`.  Nothing here imports
``jax`` or the JAX package: the numpy modules the port needs from it are
copied under the same paths.
"""

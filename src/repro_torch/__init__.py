"""PyTorch + CUDA port of :mod:`repro` (heterogeneous CSR-k SpMV).

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``sparse``, ``core``, ``kernels``, ``obs``, ``configs``,
``optim``) so each module's counterpart is easy to find.  Host-side setup
(Band-k, tuning, tile building) stays numpy and is bit-identical to the
reference; the per-call SpMV runs through a CUDA kernel written for Hopper
(``csrc/spmv_csrk.cu``) on CUDA tensors and through its plain PyTorch
version on CPU tensors.  Nothing here imports ``jax`` or ``repro``.
"""

"""PyTorch + CUDA port of :mod:`repro` (heterogeneous CSR-k SpMV).

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``sparse``, ``core``, ``kernels``, ``obs``, ``configs``,
``optim``, ``serve``, ``launch``, ``models``, ``data``, ``checkpoint``,
``train``; ``util`` holds the training path's tree walks) so each module's
counterpart is easy to find.  Host-side setup
(Band-k, tuning, tile building) stays numpy and is bit-identical to the
reference; the per-call SpMV runs through a CUDA kernel written for Hopper
(``csrc/spmv_csrk.cu``) on CUDA tensors and through its plain PyTorch
version on CPU tensors.  The LM tree (``models``) has no kernel of its own:
it is plain PyTorch, as the reference's is jnp, and trains through
``torch.autograd`` where the reference uses ``jax.value_and_grad``.  Nothing here imports
``jax`` or ``repro``.
"""

"""Kernels of the port: hand-written CUDA for Hopper, with plain versions.

spmv_csrk.py — CSR-k tile kernel wrapper (``csrc/spmv_csrk.cu``)
ops.py       — public wrappers;  ref.py — plain PyTorch versions and oracles
build.py     — nvcc build and ctypes loading at first use
"""

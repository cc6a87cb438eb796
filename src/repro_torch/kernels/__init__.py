"""Kernels of the port: hand-written CUDA for Hopper, with plain versions.

spmv_csrk.py   — CSR-k tile kernel wrapper (``csrc/spmv_csrk.cu``)
spmv_sellcs.py — SELL-C-σ chunk kernel wrapper (``csrc/spmv_sellcs.cu``)
spmv_segsum.py — segmented-sum kernel wrapper (``csrc/spmv_segsum.cu``)
spmv_diahybrid.py — DIA/CSR-hybrid kernel wrapper (``csrc/spmv_diahybrid.cu``)
spmv_ell.py    — ELL baseline kernel wrapper (``csrc/spmv_ell.cu``)
ops.py         — public wrappers;  ref.py — plain PyTorch versions and oracles
build.py       — nvcc build and ctypes loading at first use
"""

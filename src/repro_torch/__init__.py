"""PyTorch port of ``repro`` for NVIDIA Hopper (H100).

It keeps ``repro``'s module layout and names, imports ``torch`` and numpy,
and imports nothing of JAX or of ``repro``. Its kernels are written by hand
in CUDA C++ (``kernels/csrc``) and built at first use.
"""

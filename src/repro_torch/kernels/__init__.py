"""CUDA C++ kernels for Hopper (``csrc/``), each with a plain PyTorch version.

  merge_sort/  sort_blocks, merge_pass (bitonic network), remop_sort,
               argsort_by_key
  dispatch/    gather_rows
  runtime.py   nvcc build, ctypes loading, device resolution, launch counts
"""

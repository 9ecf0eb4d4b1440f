"""CUDA C++ kernels for Hopper (``csrc/``), each with a plain PyTorch version.

  merge_sort/  sort_blocks, merge_pass (bitonic network), remop_sort,
               argsort_by_key
  dispatch/    gather_rows
  flash_attention/  flash_attention, remop_flash_attention, plan_blocks
  paged_attention/  paged_attention, remop_paged_attention
  ssd_scan/    ssd_scan (Mamba-2's inter-chunk state scan), remop_ssd_scan
  matmul/      matmul_tiled (blocked matmul), remop_matmul, plan_for
  runtime.py   nvcc build, ctypes loading, device resolution, launch counts
"""

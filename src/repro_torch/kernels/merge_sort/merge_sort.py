"""Blocked bitonic merge sort: the EMS analogue as CUDA kernels for Hopper.

Structure mirrors external merge sort (§III-B):
  * run formation: each block of ``block`` keys is sorted in-core by a
    bitonic network (:func:`sort_blocks`);
  * merge passes: adjacent sorted runs are merged pairwise by a bitonic merge
    ladder (:func:`merge_pass`) until one run remains.

The kernels (``csrc/merge_sort.cu``) replace the TPU kernels ``sort_blocks``
and ``merge_pass`` of the JAX package's ``kernels/merge_sort/merge_sort.py``
and run the same compare-exchange network stage for stage, so their output
is bit-identical to it, ties included.  Beside each wrapper is its plain
PyTorch version: the same stages in ``reshape``/``minimum``/``maximum``/
``where``.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  Keys are int32 or float32, values int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import runtime

KEY_DTYPES = {torch.int32: "i32", torch.float32: "f32"}
# Largest block the sort kernel holds in one CTA's shared memory: 2^14 keys
# plus 2^14 values is 128 KiB.
MAX_BLOCK = 1 << 14

Pair = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _cmp_exchange(keys: torch.Tensor, values: torch.Tensor, j: int,
                  dirs: Optional[torch.Tensor]) -> Pair:
    """One compare-exchange stage at distance 2^j on a batch of vectors.

    ``keys``/``values`` are ``[batch, n]``; ``dirs`` holds one direction per
    group of 2^(j+1) (True = descending), or ``None`` for all ascending.
    """
    b, n = keys.shape
    d = 1 << j
    g = n // (2 * d)
    kr = keys.reshape(b, g, 2, d)
    vr = values.reshape(b, g, 2, d)
    lo = torch.minimum(kr[:, :, 0], kr[:, :, 1])
    hi = torch.maximum(kr[:, :, 0], kr[:, :, 1])
    take_lo_first = kr[:, :, 0] <= kr[:, :, 1]  # first already holds lo
    v_lo = torch.where(take_lo_first, vr[:, :, 0], vr[:, :, 1])
    v_hi = torch.where(take_lo_first, vr[:, :, 1], vr[:, :, 0])
    if dirs is None:
        k0, k1, v0, v1 = lo, hi, v_lo, v_hi
    else:
        swap = dirs[None, :, None]
        k0 = torch.where(swap, hi, lo)
        k1 = torch.where(swap, lo, hi)
        v0 = torch.where(swap, v_hi, v_lo)
        v1 = torch.where(swap, v_lo, v_hi)
    return (torch.stack([k0, k1], 2).reshape(b, n),
            torch.stack([v0, v1], 2).reshape(b, n))


def sort_blocks_plain(keys: torch.Tensor, values: torch.Tensor, block: int) -> Pair:
    """Ascending bitonic sort of each ``block``-length run (plain PyTorch)."""
    n = keys.shape[0]
    k = keys.reshape(n // block, block)
    v = values.reshape(n // block, block)
    m = block.bit_length() - 1
    for stage in range(1, m + 1):
        for j in range(stage - 1, -1, -1):
            g = block // (2 << j)
            dirs = ((torch.arange(g, device=keys.device) >> (stage - 1 - j)) & 1).bool()
            k, v = _cmp_exchange(k, v, j, dirs)
    return k.reshape(n), v.reshape(n)


def merge_pass_plain(keys: torch.Tensor, values: torch.Tensor, run: int) -> Pair:
    """Merge adjacent sorted runs of length ``run`` pairwise (plain PyTorch).

    The second run of each pair is reversed, which makes the pair bitonic,
    and an all-ascending ladder of stages sorts it.
    """
    n = keys.shape[0]
    span = 2 * run
    k = keys.reshape(n // span, span)
    v = values.reshape(n // span, span)
    k = torch.cat([k[:, :run], k[:, run:].flip(1)], 1)
    v = torch.cat([v[:, :run], v[:, run:].flip(1)], 1)
    for j in range(span.bit_length() - 2, -1, -1):
        k, v = _cmp_exchange(k, v, j, None)
    return k.reshape(n), v.reshape(n)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_pair(keys: torch.Tensor, values: torch.Tensor) -> int:
    if keys.dtype not in KEY_DTYPES:
        raise TypeError(f"keys must be int32 or float32, got {keys.dtype}")
    if values.dtype != torch.int32:
        raise TypeError(f"values must be int32, got {values.dtype}")
    if keys.dim() != 1 or values.shape != keys.shape:
        raise ValueError(
            f"keys and values must be 1-D of one length, got "
            f"{tuple(keys.shape)} and {tuple(values.shape)}"
        )
    if not (keys.is_contiguous() and values.is_contiguous()):
        raise ValueError("keys and values must be contiguous")
    return keys.shape[0]


def _launch(kernel: str, keys: torch.Tensor, values: torch.Tensor, arg: int) -> Pair:
    keys_out = torch.empty_like(keys)
    values_out = torch.empty_like(values)
    lib = runtime.library("merge_sort")
    fn = getattr(lib, f"remop_{kernel}_{KEY_DTYPES[keys.dtype]}")
    with torch.cuda.device(keys.device):
        err = fn(keys.data_ptr(), values.data_ptr(), keys_out.data_ptr(),
                 values_out.data_ptr(), keys.shape[0], arg, runtime.stream_of(keys))
    runtime.check(kernel, "merge_sort", err)
    runtime.launches[kernel] += 1
    return keys_out, values_out


def sort_blocks(keys: torch.Tensor, values: torch.Tensor, block: int) -> Pair:
    """Sort each ``block``-length run; ``len(keys) % block == 0``, block = 2^m."""
    n = _check_pair(keys, values)
    if block < 1 or block & (block - 1) or n % block:
        raise ValueError(f"block must be a power of two dividing {n}, got {block}")
    if runtime.on_cpu(keys, values):
        return sort_blocks_plain(keys, values, block)
    if block > MAX_BLOCK:
        raise ValueError(f"the sort kernel holds blocks of at most {MAX_BLOCK} keys, got {block}")
    return _launch("sort_blocks", keys, values, block)


def merge_pass(keys: torch.Tensor, values: torch.Tensor, run: int) -> Pair:
    """One pairwise merge pass: adjacent runs of length ``run`` -> ``2*run``."""
    n = _check_pair(keys, values)
    if run < 1 or run & (run - 1) or n % (2 * run):
        raise ValueError(f"run must be a power of two with 2*run dividing {n}, got {run}")
    if runtime.on_cpu(keys, values):
        return merge_pass_plain(keys, values, run)
    return _launch("merge_pass", keys, values, run)

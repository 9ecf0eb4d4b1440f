"""Full blocked merge sort and a stable argsort over the merge-sort kernels.

Plain PyTorch around :func:`sort_blocks` and :func:`merge_pass`: pad to a
power of two with a sentinel, sort in-core runs, merge until one run remains.
Everything runs on the device of ``keys``.  ``remop_sort_plain`` and
``argsort_by_key_plain`` run the same steps through the plain versions on
any device; they are the yardstick the kernels are held to on the card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.merge_sort.merge_sort import (
    MAX_BLOCK,
    Pair,
    merge_pass,
    merge_pass_plain,
    sort_blocks,
    sort_blocks_plain,
)

# Default in-core run: the whole sort kernel block.
DEFAULT_RUN_ITEMS = MAX_BLOCK


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


Stage = Callable[[torch.Tensor, torch.Tensor, int], Pair]


def remop_sort(keys: torch.Tensor, values: Optional[torch.Tensor] = None,
               run_items: Optional[int] = None) -> Pair:
    """Sort ``(keys[, values])`` ascending via blocked bitonic merge sort.

    ``run_items`` (a power of two) is the in-core run size; the default is
    ``min(2^14, next_pow2(n))``.  Keys are int32 or float32; ``values``
    (int32) default to ``arange(n)``.  On the card ``n`` is at most 2^28,
    the widest merge :func:`merge_pass` takes.
    """
    return _sort(keys, values, run_items, sort_blocks, merge_pass)


def remop_sort_plain(keys: torch.Tensor, values: Optional[torch.Tensor] = None,
                     run_items: Optional[int] = None) -> Pair:
    """:func:`remop_sort` through the plain versions, on any device."""
    return _sort(keys, values, run_items, sort_blocks_plain, merge_pass_plain)


def _sort(keys, values, run_items, sort_fn: Stage, merge_fn: Stage) -> Pair:
    n = keys.shape[0]
    if values is None:
        values = torch.arange(n, dtype=torch.int32, device=keys.device)
    if run_items is None:
        run_items = DEFAULT_RUN_ITEMS
    run_items = max(2, min(_next_pow2(run_items), _next_pow2(n)))
    n_pad = max(_next_pow2(n), run_items)
    if keys.dtype.is_floating_point:
        sentinel = float("inf")
    else:
        sentinel = torch.iinfo(keys.dtype).max
    kp = torch.full((n_pad,), sentinel, dtype=keys.dtype, device=keys.device)
    kp[:n] = keys
    vp = torch.zeros((n_pad,), dtype=values.dtype, device=values.device)
    vp[:n] = values

    run = min(run_items, n_pad)
    kp, vp = sort_fn(kp, vp, run)
    while run < n_pad:
        kp, vp = merge_fn(kp, vp, run)
        run *= 2
    return kp[:n], vp[:n]


def argsort_by_key(keys: torch.Tensor, max_key: Optional[int] = None) -> torch.Tensor:
    """Stable argsort via unique composite keys (key-major, index-minor).

    Requires ``max(keys) * n + n < 2**31`` (the composite is built in int32).
    The precondition is checked from static bounds: ``max_key`` when given (a
    promise about the key range, e.g. the largest partition id), else the key
    dtype's maximum.  A violated bound raises ``ValueError`` instead of
    silently overflowing into a wrong permutation.
    """
    return _argsort(keys, max_key, remop_sort)


def argsort_by_key_plain(keys: torch.Tensor, max_key: Optional[int] = None) -> torch.Tensor:
    """:func:`argsort_by_key` through the plain versions, on any device."""
    return _argsort(keys, max_key, remop_sort_plain)


def _argsort(keys, max_key, sort) -> torch.Tensor:
    n = int(keys.shape[0])
    if keys.dtype.is_floating_point or keys.dtype.is_complex or keys.dtype == torch.bool:
        raise ValueError(f"argsort_by_key needs integer keys, got dtype {keys.dtype}")
    bound = torch.iinfo(keys.dtype).max if max_key is None else int(max_key)
    if bound < 0:
        raise ValueError(f"max_key must be >= 0, got {max_key}")
    if n and bound * n + n >= 2**31:
        raise ValueError(
            f"argsort_by_key composite overflows int32: "
            f"max_key({bound}) * n({n}) + n >= 2**31 — pass a tighter "
            f"static max_key= bound for the actual key range"
        )
    index = torch.arange(n, dtype=torch.int32, device=keys.device)
    composite = keys.to(torch.int32) * n + index
    _, idx = sort(composite, index)
    return idx
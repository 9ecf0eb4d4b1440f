"""Plain oracle for the blocked merge sort.

Both sorts are stable, as ``jnp.sort``/``jnp.argsort(stable=True)`` are:
-0.0 and +0.0 compare equal and keep their order, NaNs go last in theirs.
"""

import torch


def sort_ref(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).values


def sort_pairs_ref(keys: torch.Tensor, values: torch.Tensor):
    order = torch.argsort(keys, stable=True)
    return keys[order], values[order]

"""Plain oracle for the REMOP blocked matmul."""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``a @ b`` with an f32 product, cast once to ``out_dtype`` (default a's)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)

"""Building-block layers as plain functions over dicts of tensors.

Conventions, as in the JAX package's ``models/layers.py``:
  * parameters are nested dicts; matrices are held in bf16 by default and
    norm scales in f32 (JAX keeps f32 masters and casts each matrix to the
    activation dtype per call, which computes the same bf16 product);
    training asks for f32 masters (:func:`matrix_dtype`), as JAX's
    ``init_*`` give, and autograd carries each product's gradient back to
    the f32 master through the cast;
  * every apply computes in the dtype of its input, rmsnorm and rope in f32;
  * the ``init_*`` functions draw from a seeded ``torch.Generator`` on the
    device the weights live on.  They give other numbers than ``jax.random``
    from the same seed; ``models.convert`` carries JAX's weights over where
    the two must compute the same thing.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Iterator, Tuple

import torch

Params = Dict[str, torch.Tensor]
WEIGHT_DTYPE = torch.bfloat16
_MATRIX_DTYPE = [WEIGHT_DTYPE]  # what truncated_normal draws in by default


@contextlib.contextmanager
def matrix_dtype(dtype: torch.dtype) -> Iterator[None]:
    """Draw every matrix in ``dtype`` inside the block (``init_params``'s
    ``dtype``: f32 masters for training)."""
    _MATRIX_DTYPE.append(dtype)
    try:
        yield
    finally:
        _MATRIX_DTYPE.pop()


def truncated_normal(shape, scale: float, generator: torch.Generator,
                     device: torch.device, dtype=None) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2], in ``dtype``
    (by default the matrix dtype of :func:`matrix_dtype`, bf16 outside it)."""
    w = torch.empty(shape, dtype=dtype or _MATRIX_DTYPE[-1], device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, scale, -2.0 * scale, 2.0 * scale,
                                       generator=generator)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, device: torch.device) -> Params:
    return {"scale": torch.zeros(dim, dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + p["scale"])).to(dtype)


# ---------------------------------------------------------------------------
# Dense / embeddings
# ---------------------------------------------------------------------------


def init_dense(in_dim: int, out_dim: int, generator: torch.Generator,
               device: torch.device, scale: float | None = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return {"w": truncated_normal((in_dim, out_dim), scale, generator, device)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype)


def init_embedding(vocab: int, dim: int, generator: torch.Generator,
                   device: torch.device) -> Params:
    # 1/sqrt(dim) so the sqrt(d)-scaled embedding has unit variance and the
    # tied unembedding produces O(1) logits at init.
    return {"table": truncated_normal((vocab, dim), 1.0 / math.sqrt(dim), generator, device)}


def embed(p: Params, tokens: torch.Tensor, scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    table = p["table"]
    x = table[tokens.long()].to(torch.bfloat16)
    if scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(table.shape[-1]), dtype=x.dtype, device=x.device)
    return x


def unembed(p: Params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = x @ p["table"].to(x.dtype).T
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as JAX computes it, ``x * (1 / (1 + exp(-x)))`` with
    every step rounded to the input's dtype; ``F.silu`` rounds once and
    differs from it in a third of bf16 outputs by one ulp."""
    return x * (1 / (1 + torch.exp(-x)))


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (a host scalar: no
    device tensor a call)."""
    return torch.tensor(value, dtype=dtype).item()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` as JAX computes it: its constants
    rounded to the input's dtype, then every step rounded to it;
    ``F.gelu(approximate="tanh")`` rounds once and differs from it in four
    of ten bf16 outputs by an ulp."""
    c0, c1 = _rounded(math.sqrt(2 / math.pi), x.dtype), _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c0 * (x + c1 * (x ** 3)))))


def init_mlp(d_model: int, d_ff: int, generator: torch.Generator, device: torch.device,
             mlp_type: str = "swiglu") -> Params:
    p = {}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = init_dense(d_model, d_ff, generator, device)
    p["w_up"] = init_dense(d_model, d_ff, generator, device)
    p["w_down"] = init_dense(d_ff, d_model, generator, device, scale=1.0 / math.sqrt(d_ff))
    return p


def mlp(p: Params, x: torch.Tensor, mlp_type: str = "swiglu") -> torch.Tensor:
    up = dense(p["w_up"], x)
    t = mlp_type if "w_gate" in p else "gelu"
    if t == "swiglu":
        act = silu(dense(p["w_gate"], x)) * up
    elif t == "geglu":
        act = gelu_tanh(dense(p["w_gate"], x)) * up
    else:
        act = gelu_tanh(up)
    return dense(p["w_down"], act)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions; returns (cos, sin) [..., dim/2]."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exponents)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim/2]."""
    dtype = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy in f32 (``repro``'s ``softmax_xent``); with
    ``mask`` the mean over the masked-in tokens (at least one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()

"""Mamba-2 (SSD, state-space duality) block: chunked prefill and recurrent decode.

As in the JAX package's ``models/ssm.py``: the sequence is cut into chunks
of ``Q = min(ssm_chunk, S)`` positions (``S`` must be a multiple of ``Q``).
Inside a chunk the work is dense contractions; between chunks a
``[H, P, N]`` state passes through a sequential scan, which here is one
call of the CUDA kernel :func:`remop_ssd_scan` per layer (under grad
through ``SsdScanFn``, whose backward is the scan's backward kernel; the
JAX package differentiates its ``jax.lax.scan``).  Like the TPU
kernel it starts from a zero carry, so an ``initial_state`` adds its share
outside the kernel: ``s0 * prod(decays before c)`` into each chunk's
entering state and ``s0 * prod(all decays)`` into the final one.

The JAX package writes three contractions as one multi-operand ``einsum``
each; ``torch.einsum`` would contract them left to right, so they are
written as explicit pairwise steps whose largest intermediate is
``[B, NC, H, Q, Q]`` f32 (64 MiB a layer at mamba2-370m's widths and
S = 2048).  ``constrain`` (a no-op without a sharder) is dropped.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import remop_ssd_scan
from repro_torch.models.layers import dense, init_dense, silu, truncated_normal

Params = Dict
SSMCache = Tuple[torch.Tensor, torch.Tensor]  # (conv [B, W-1, C] bf16, state [B,H,P,N] f32)


def init_ssm(cfg: ModelConfig, generator: torch.Generator, device: torch.device) -> Params:
    d, d_in, h, n = cfg.d_model, cfg.d_inner_ssm, cfg.n_ssm_heads, cfg.ssm_state
    # in_proj packs [z, x, B, C, dt] like the reference implementation.
    d_proj = 2 * d_in + 2 * n + h
    return {
        "w_in": init_dense(d, d_proj, generator, device),
        "conv": {"w": truncated_normal((cfg.conv_width, d_in + 2 * n), 0.1, generator,
                                       device)},
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "dt_bias": torch.zeros(h, device=device),
        "d_skip": torch.ones(h, device=device),
        "w_out": init_dense(d_in, d, generator, device),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, n, h = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * n, h], dim=-1)
    return z, xbc, dt  # xbc = [x, B, C] fused for the conv


def _causal_conv(w: torch.Tensor, x: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv; x [B,S,C], w [W,C]. Returns (y, new_state)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(width))  # bf16, as in JAX
    new_state = xp[:, xp.shape[1] - (width - 1):].clone()  # not a view holding all of xp
    return silu(y), new_state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = sum_{j < k <= i} x[..., k] (lower-triangular),
    as a difference of cumulative sums, as in JAX."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                initial_state: Optional[torch.Tensor] = None, return_state: bool = False):
    """Chunked SSD over the full sequence. x: [B,S,d].

    Returns ``out`` or, with ``return_state``, ``(out, (conv_state, final_state))``.
    """
    b, s, _ = x.shape
    d_in, n, hd, h = cfg.d_inner_ssm, cfg.ssm_state, cfg.ssm_head_dim, cfg.n_ssm_heads
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q

    proj = dense(p["w_in"], x)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(p["conv"]["w"], xbc)
    xc, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B,S,H]
    a = -torch.exp(p["a_log"].float())  # [H]
    da = dt * a

    xh = xc.reshape(b, nc, q, h, hd).float()
    bm = bmat.reshape(b, nc, q, n).float()
    cm = cmat.reshape(b, nc, q, n).float()
    dac = da.reshape(b, nc, q, h).transpose(2, 3)  # [B,nc,H,Q]
    dtc = dt.reshape(b, nc, q, h)
    xdt = xh * dtc[..., None]  # [B,nc,Q,H,P]

    # Intra-chunk (diagonal blocks): C B^T, masked by the decay L, times dt x.
    l_mat = torch.exp(_segsum(dac))  # [B,nc,H,Q,Q]
    cb = torch.einsum("bcln,bcsn->bcls", cm, bm)  # [B,nc,Q,Q]
    y_diag = torch.einsum("bchls,bcshp->bclhp", l_mat * cb[:, :, None], xdt)

    # Chunk-final states.
    a_cum = torch.cumsum(dac, dim=-1)  # [B,nc,H,Q]
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # [B,nc,H,Q]
    states = torch.einsum("bcshp,bcsn->bchpn", xdt * decay_states.transpose(2, 3)[..., None],
                          bm)  # [B,nc,H,P,N]

    # Inter-chunk recurrence (sequential over nc chunks): the CUDA kernel.
    chunk_decay = torch.exp(a_cum[..., -1])  # [B,nc,H]
    prev_states, final_state = remop_ssd_scan(states, chunk_decay)
    if initial_state is not None:
        s0 = initial_state.float()[:, None]  # [B,1,H,P,N]
        entering = torch.cumprod(chunk_decay, dim=1)  # decay of chunks 0..c
        before = torch.cat([torch.ones_like(entering[:, :1]), entering[:, :-1]], dim=1)
        prev_states = prev_states + s0 * before[..., None, None]
        final_state = final_state + s0[:, 0] * entering[:, -1, :, None, None]

    state_decay = torch.exp(a_cum)  # decay from chunk start to position l
    y_off = (torch.einsum("bcln,bchpn->bclhp", cm, prev_states)
             * state_decay.transpose(2, 3)[..., None])

    y = (y_diag + y_off).reshape(b, s, h, hd)
    y = y + xh.reshape(b, s, h, hd) * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = y * silu(z)
    out = dense(p["w_out"], y)
    if return_state:
        return out, (conv_state, final_state)
    return out


def ssd_decode(p: Params, cfg: ModelConfig, x_t: torch.Tensor, cache: SSMCache):
    """Single-token recurrent step. x_t: [B,1,d]; cache=(conv_state, ssm_state)."""
    b = x_t.shape[0]
    d_in, n, hd, h = cfg.d_inner_ssm, cfg.ssm_state, cfg.ssm_head_dim, cfg.n_ssm_heads
    conv_state, ssm_state = cache

    proj = dense(p["w_in"], x_t)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(p["conv"]["w"], xbc, conv_state)
    xc, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]  # [B,H]
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a)  # [B,H]

    xh = xc.reshape(b, h, hd).float()
    bm = bmat[:, 0].float()  # [B,N]
    cm = cmat[:, 0].float()
    ssm_state = (ssm_state.float() * da[..., None, None]
                 + (dt[..., None] * xh)[..., None] * bm[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", cm, ssm_state)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_in).to(x_t.dtype)
    y = y * silu(z)
    return dense(p["w_out"], y), (conv_state, ssm_state)


def ssm_cache_shapes(cfg: ModelConfig, batch: int):
    conv = (batch, cfg.conv_width - 1, cfg.d_inner_ssm + 2 * cfg.ssm_state)
    state = (batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return conv, state

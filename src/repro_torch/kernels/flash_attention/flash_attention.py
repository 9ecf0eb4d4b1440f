"""Causal GQA flash attention (prefill) as a CUDA kernel for Hopper.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention`` of the JAX package's
``kernels/flash_attention/flash_attention.py``: ``q [B, H, S, hd]``,
``k, v [B, KV, T, hd]``, query head ``h`` reading KV head ``h // (H / KV)``,
causal with the query positions offset by ``T - S``, an online softmax in
f32 over KV blocks of ``bk`` positions, fully masked blocks skipped, output
in q's dtype.  Unlike the TPU kernel it takes any ``S <= T`` (rows and
columns past the ends are masked) and any strides with a contiguous last
dimension, so the model hands it ``[B, S, H, hd]`` activations as
transposed views and gets its output back in the same layout.

Two routes, chosen on the host by :func:`route` from dtype, head width and
alignment alone:

- ``"tc"``: bf16 at ``hd`` in :data:`TC_HEAD_DIMS` whose q, k and v start
  on 16 bytes and step every dimension of extent > 1 by a positive multiple
  of 16 bytes (what TMA loads).  Both products on the tensor cores
  (``wgmma``), K and V in a two-stage TMA ring; ``bq, bk`` in
  :data:`TC_BLOCKS`.
- ``"simt"``: everything else (every f32 call, bf16 at hd 16 or 32 or with
  unaligned strides): the CUDA-core kernel, ``bq, bk`` in ``[1, 64]``.

A call the tensor-core route takes never goes to the CUDA-core kernel:
blocks it refuses raise, and so does a failed build, encode or launch.
``runtime.launches`` counts every launch under ``"flash_attention"`` and
under the route's own name, ``"flash_attention_tc"`` or
``"flash_attention_simt"``.

Beside the wrapper is its plain PyTorch version, the same online softmax
over the same KV blocks; a CPU tensor takes it, a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.cost_model import H100
from repro_torch.kernels import runtime

NEG_INF = -1e30
# Largest bq and bk of the CUDA-core kernel: 256 threads as 16 x 16, each
# holding 4 query rows of the f32 accumulator in registers.
MAX_BLOCK = 64
HEAD_DIMS = (16, 32, 64, 128, 256)
# The tensor-core route: head widths, and blocks in wgmma's 64 rows (one
# consumer warpgroup per 64 query rows; bk stops at 128 because S and P
# of a block live in registers beside O).
TC_HEAD_DIMS = (64, 128, 256)
TC_BLOCKS = (64, 128)
SMEM_LIMIT = H100.vmem_bytes  # shared memory one CTA may use (227 KB)
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def smem_bytes(bq: int, bk: int, hd: int, dtype_bytes: int, route: str = "simt") -> int:
    """Dynamic shared memory of one CTA on ``route``.

    ``"simt"``: q and K/V tiles (rows padded by one 32-bit word) in the
    input dtype, plus the f32 P tile ``[bq, bk + 1]``.  ``"tc"``: bf16 Q
    ``[bq, hd]`` and two ring stages of K and V ``[bk, hd]`` each, seven
    mbarriers and 1024 bytes to align the swizzled tiles (P stays in
    registers).
    """
    if route == "tc":
        return 1024 + bq * hd * 2 + 4 * bk * hd * 2 + 7 * 8
    return (bq + bk) * (hd * dtype_bytes + 4) + bq * (bk + 1) * 4


def _tma_aligned(x: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0 and all(
        st > 0 and st % 8 == 0 for n, st in zip(x.shape[:3], x.stride()[:3]) if n > 1)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tc"`` when q is bf16, ``hd`` in :data:`TC_HEAD_DIMS` and q, k, v
    are TMA-aligned (16-byte base; every dimension of extent > 1 but the
    last stepped by a positive multiple of 8 elements); else ``"simt"``."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
            and all(_tma_aligned(x) for x in (q, k, v))):
        return "tc"
    return "simt"


def check_blocks(path: str, bq: int, bk: int, hd: int) -> None:
    """Raise ``ValueError`` for blocks ``path`` does not launch."""
    if path == "tc":
        if (bq not in TC_BLOCKS or bk not in TC_BLOCKS
                or smem_bytes(bq, bk, hd, 2, "tc") > SMEM_LIMIT):
            raise ValueError(f"the tensor-core route takes bq, bk in {TC_BLOCKS} within "
                             f"{SMEM_LIMIT} bytes of shared memory; got bq={bq}, bk={bk} at "
                             f"hd={hd}")
    elif not (1 <= bq <= MAX_BLOCK and 1 <= bk <= MAX_BLOCK):
        raise ValueError(f"bq={bq}, bk={bk} must lie in [1, {MAX_BLOCK}]")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B,H,S,hd] and k, v [B,KV,T,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] < s:
        raise ValueError(f"more queries ({s}) than keys ({k.shape[2]})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {sorted(map(str, _DTYPES))}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bk: int = MAX_BLOCK) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: online softmax over KV blocks of ``bk``.

    All query rows take every block; a block the kernel skips is fully
    masked for the rows it would skip it for, and adds exactly 0 there.
    """
    b, h, s, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, kv, h // kv, s, hd)
    q_pos = torch.arange(s, device=q.device) + (t - s)
    m = torch.full((b, kv, h // kv, s, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, t, bk):
        kb = k[:, :, k0:k0 + bk].float()
        vb = v[:, :, k0:k0 + bk].float()
        sc = torch.einsum("bkgsd,bktd->bkgst", qf, kb) * scale
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        sc = sc.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb[:, :, None])
        m = m_new
    return (acc / l.clamp_min(1e-30)).reshape(b, h, s, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = MAX_BLOCK, bk: int = MAX_BLOCK,
                    split_p: bool = True) -> torch.Tensor:
    """q: [B, H, S, hd]; k/v: [B, KV, T, hd]; causal with offset T - S.

    ``bq, bk`` must suit the call's :func:`route` (:func:`check_blocks`);
    on a CUDA tensor ``hd`` must also lie in ``HEAD_DIMS``.  The output has
    q's strides where q is dense.  ``split_p=False`` (tensor-core route
    only) rounds P to bf16 once instead of keeping it as ``P_hi + P_lo``: a
    probe of what the split costs, not the main path.  Query blocks do not
    change any row's arithmetic, so the plain version takes only ``bk``.
    """
    _check(q, k, v)
    b, h, s, hd = q.shape
    path = route(q, k, v)
    check_blocks(path, bq, bk, hd)
    if not split_p and path != "tc":
        raise ValueError("split_p=False exists on the tensor-core route only")
    if runtime.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, bk)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the last dimension of q, k and v must be contiguous")
    kv, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # keeps q's layout when q is dense
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in (x.stride(0), x.stride(1), x.stride(2))))
    lib = runtime.library("flash_attention")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
            b, h, kv, s, t, hd, bq, bk, 1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        if path == "tc":
            err = lib.remop_flash_attention_tc(*args, int(split_p), runtime.stream_of(q))
        else:
            err = getattr(lib, f"remop_flash_attention_{_DTYPES[q.dtype]}")(
                *args, runtime.stream_of(q))
    runtime.check("flash_attention", "flash_attention", err)
    runtime.launches["flash_attention"] += 1
    runtime.launches[f"flash_attention_{path}"] += 1
    return out


def occupancy(hd: int, bq: int, bk: int, split_p: bool = True) -> dict:
    """The tensor-core instantiation these blocks launch, on the current
    card: CTAs one SM holds at once (CUDA's occupancy calculator), registers
    and local (spilled) bytes a thread, dynamic shared memory and threads a
    CTA."""
    check_blocks("tc", bq, bk, hd)
    out = (ctypes.c_int * 5)()
    err = runtime.library("flash_attention").remop_flash_attention_tc_occupancy(
        hd, bq, bk, int(split_p), ctypes.addressof(out))
    runtime.check("flash_attention", "flash_attention", err)
    return dict(zip(("resident_ctas", "registers", "local_bytes", "smem_bytes", "threads"), out))

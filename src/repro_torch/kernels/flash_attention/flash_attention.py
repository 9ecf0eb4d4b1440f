"""Causal GQA flash attention (prefill) as a CUDA kernel for Hopper.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention`` of the JAX package's
``kernels/flash_attention/flash_attention.py``: ``q [B, H, S, hd]``,
``k [B, KV, T, hd]``, ``v [B, KV, T, hd_v]``, query head ``h`` reading KV
head ``h // (H / KV)``, causal with the query positions offset by ``T - S``,
an online softmax in f32 over KV blocks of ``bk`` positions, scores scaled by
``scale`` (by default ``1 / sqrt(hd)``), fully masked blocks skipped, output
``[B, H, S, hd_v]`` in q's dtype.  With ``window = W > 0`` a query at
position ``q`` sees the keys ``q - W + 1 .. q`` (``repro``'s local attention,
``full_attention(window=W)``, which the TPU kernel does not compute): the
KV loop starts at the first block the query block's first row can see, so
the work follows the visible pairs; ``window = 0`` is causal only.  With ``prefix = P >
0`` a query at position ``q`` sees the keys ``k < P`` beside ``k <= q``:
``repro``'s prefix-LM mask (paligemma's ``mask_pos = max(pos - P + 1,
0)``), and at ``P >= T`` every key (the encoder's all-zero ``mask_pos``,
and cross-attention's ``q_pos = 1e9`` over ``kv_pos = 0``, where S may
exceed T); the KV loop then runs at least to key ``min(P, T) - 1``.  A
window and a prefix are never given together.  ``hd_v`` equals ``hd``
except at the pair (192, 128), MLA's prefill (128 nope + 64 rope columns of
q and k, values of 128).  Unlike the TPU kernel it takes any ``S <= T``
(any S at ``P >= T``; rows and columns past the ends are masked) and any
strides with a contiguous last dimension, so the model hands it ``[B, S,
H, hd]`` activations as transposed views and gets its output back in the
same layout.  With ``softcap = c > 0`` every score is capped after the scale
and before the mask, ``s = tanh(s / c) * c`` (``repro``'s attention logit
softcap, which the TPU kernel does not compute either); a capped launch runs
its own instantiation of either route, so a call without a cap keeps its
code and its bits.

Two routes, chosen on the host by :func:`route` from dtype, head widths and
alignment alone:

- ``"tc"``: bf16 at ``(hd, hd_v)`` in :data:`TC_HEAD_PAIRS` whose q, k and
  v start on 16 bytes and step every dimension of extent > 1 by a positive
  multiple of 16 bytes (what TMA loads).  Both products on the tensor cores
  (``wgmma``), K and V in a two-stage TMA ring; ``bq, bk`` in
  :data:`TC_BLOCKS`.
- ``"simt"``: everything else (every f32 call, bf16 at hd 16 or 32 or with
  unaligned strides, reduced MLA's (24, 16)): the CUDA-core kernel, ``bq,
  bk`` in ``[1, 64]``.  Its threads hold hd / 16 columns each, so at (24,
  16) the wrapper zero-pads q and k to 32 (:data:`PADDED_HEAD_PAIRS`) and
  launches the (32, 16) instantiation with the scale of 24: the zero
  columns add exact zeros to every score.

A call the tensor-core route takes never goes to the CUDA-core kernel:
blocks it refuses raise, and so does a failed build, encode or launch.
``runtime.launches`` counts every launch under ``"flash_attention"`` and
under the route's own name, ``"flash_attention_tc"`` or
``"flash_attention_simt"``; a launch at unequal widths also counts under
``"flash_attention_<route>_<hd>x<hd_v>"``, a windowed launch under
``"flash_attention_windowed"``, one with a prefix under
``"flash_attention_prefix"`` and, when the prefix covers every key, also
under ``"flash_attention_full"``.

With ``return_lse=True`` the call also returns each row's log-sum-exp,
f32 ``[B, H, S]``, ``m + log(l)`` in the scaled and capped score domain P
is formed in: the tensor-core route writes it in its epilogue at ``(hd,
hd_v)`` in :data:`LSE_HEAD_PAIRS`, every width of the route (the entry
``remop_flash_attention_tc_lse`` and instantiations of their own, so a call
without it passes and runs what it did before), other CUDA calls refuse it,
the plain version computes it.
The backward's tensor-core route reads it (``flash_attention_bwd``).

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
# (hd, hd_v) of q/k and of v: equal widths, MLA's 192 / 128 and reduced
# MLA's 24 / 16 (nope 16 + rope 8 over values of 16).
MLA_HEAD_PAIR = (192, 128)
# Widths the CUDA-core kernels (each thread holds hd / 16 columns) take with
# q and k zero-padded to a width they are built for, by pair: the zero
# columns add exact zeros to every score, and the scale stays the caller's.
PADDED_HEAD_PAIRS = {(24, 16): (32, 16)}
HEAD_PAIRS = tuple((hd, hd) for hd in HEAD_DIMS) + (MLA_HEAD_PAIR, *PADDED_HEAD_PAIRS)
# The tensor-core route: head widths, and blocks in wgmma's 64 rows (one
# consumer warpgroup per 64 query rows; bk stops at 128 because S and P
# of a block live in registers beside O).
TC_HEAD_DIMS = (64, 128, 256)
TC_HEAD_PAIRS = tuple((hd, hd) for hd in TC_HEAD_DIMS) + (MLA_HEAD_PAIR,)
TC_BLOCKS = (64, 128)
# The widths whose tensor-core forward is built to write each row's
# log-sum-exp (return_lse): those the backward's tensor-core route takes,
# every width of the route.
LSE_HEAD_PAIRS = TC_HEAD_PAIRS
SMEM_LIMIT = H100.vmem_bytes  # shared memory one CTA may use (227 KB)
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def smem_bytes(bq: int, bk: int, hd: int, dtype_bytes: int, route: str = "simt",
               hd_v: int | None = None) -> int:
    """Dynamic shared memory of one CTA on ``route`` (``hd_v`` defaults to ``hd``).

    ``"simt"``: q and K/V tiles (rows of ``hd`` padded by one 32-bit word;
    V is staged where K was) in the input dtype, plus the f32 P tile ``[bq,
    bk + 1]``.  ``"tc"``: bf16 Q ``[bq, hd]`` and two ring stages of K
    ``[bk, hd]`` and V ``[bk, hd_v]``, seven mbarriers and 1024 bytes to
    align the swizzled tiles (P stays in registers).
    """
    if route == "tc":
        hd_v = hd if hd_v is None else hd_v
        return 1024 + bq * hd * 2 + 2 * bk * (hd + hd_v) * 2 + 7 * 8
    return (bq + bk) * (hd * dtype_bytes + 4) + bq * (bk + 1) * 4


def _tma_aligned(x: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0 and all(
        st > 0 and st % 8 == 0 for n, st in zip(x.shape[:3], x.stride()[:3]) if n > 1)


def kernel_widths(hd: int, hd_v: int) -> tuple:
    """The (hd, hd_v) a CUDA kernel runs a call of these widths at: q and
    k padded to :data:`PADDED_HEAD_PAIRS`' width where it lists the pair."""
    return PADDED_HEAD_PAIRS.get((hd, hd_v), (hd, hd_v))


def pad_heads(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` [..., hd] with zero columns up to ``width`` (``x`` itself at
    ``width`` hd): a new dense tensor."""
    return x if x.shape[-1] == width else torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tc"`` when q is bf16, ``(hd, hd_v)`` in :data:`TC_HEAD_PAIRS` and
    q, k, v are TMA-aligned (16-byte base; every dimension of extent > 1 but
    the last stepped by a positive multiple of 8 elements); else ``"simt"``."""
    if (q.dtype == torch.bfloat16 and (q.shape[-1], v.shape[-1]) in TC_HEAD_PAIRS
            and all(_tma_aligned(x) for x in (q, k, v))):
        return "tc"
    return "simt"


def check_blocks(path: str, bq: int, bk: int, hd: int, hd_v: int | None = None) -> None:
    """Raise ``ValueError`` for blocks ``path`` does not launch."""
    if path == "tc":
        if (bq not in TC_BLOCKS or bk not in TC_BLOCKS
                or smem_bytes(bq, bk, hd, 2, "tc", hd_v) > SMEM_LIMIT):
            raise ValueError(f"the tensor-core route takes bq, bk in {TC_BLOCKS} within "
                             f"{SMEM_LIMIT} bytes of shared memory; got bq={bq}, bk={bk} at "
                             f"hd={hd}, hd_v={hd if hd_v is None else hd_v}")
    elif not (1 <= bq <= MAX_BLOCK and 1 <= bk <= MAX_BLOCK):
        raise ValueError(f"bq={bq}, bk={bk} must lie in [1, {MAX_BLOCK}]")


def _check_mask(s: int, t: int, window: int, prefix: int) -> None:
    """Raise ``ValueError`` for a mask the kernel does not compute: S > T
    unless the prefix covers every key, a negative window or prefix, both
    together."""
    if t < s and prefix < t:
        raise ValueError(f"more queries ({s}) than keys ({t}) under a causal mask")
    if window < 0 or prefix < 0:
        raise ValueError(f"window={window} and prefix={prefix} must be 0 (causal only) or "
                         "positive")
    if window and prefix:
        raise ValueError(f"a window ({window}) and a prefix ({prefix}) together: no model "
                         "uses both")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, prefix: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"q must be [B,H,S,hd], k [B,KV,T,hd] and v [B,KV,T,hd_v]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    _check_mask(s, k.shape[2], window, prefix)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {sorted(map(str, _DTYPES))}")


def hidden_keys(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                prefix: int) -> torch.Tensor:
    """[S, T] True where the query at ``q_pos`` does not see the key at
    ``k_pos``: past its position and outside the prefix, or (with a window)
    ``window`` or more positions back."""
    hidden = (q_pos[:, None] < k_pos[None, :]) & (k_pos[None, :] >= prefix)
    if window:
        hidden |= q_pos[:, None] - k_pos[None, :] >= window
    return hidden


def first_block(q_pos: int, window: int, bk: int) -> int:
    """The first KV block of ``bk`` positions a query at ``q_pos`` can see
    (0 without a window), the kernels' ``j0`` for a query block's first row."""
    return max(0, q_pos - window + 1) // bk if window else 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bk: int = MAX_BLOCK, scale: float | None = None,
                          window: int = 0, prefix: int = 0, softcap: float = 0.0,
                          return_lse: bool = False):
    """The kernel's arithmetic in PyTorch: online softmax over KV blocks of ``bk``.

    All query rows take every block from the first row's first visible one
    on; a block the kernel skips is fully masked for the rows it would skip
    it for, and adds exactly 0 there: before a row's first live key its m
    stays ``NEG_INF`` (each masked p is ``exp(0) = 1``), and the first live
    key's correction ``exp(NEG_INF - m)`` is exactly 0.  Key ``k`` is seen
    by the query at position ``q`` iff ``k <= q`` or ``k < prefix`` (inside
    the window, if any).  The cap comes before the mask, so a hidden score
    is ``NEG_INF`` whatever the cap, and the argument holds with one.
    With ``return_lse`` it returns ``(out, lse)``, lse = m + log(l) of each
    row, f32 ``[B, H, S]``.
    """
    _check_mask(q.shape[2], k.shape[2], window, prefix)
    softcap = runtime.check_softcap(softcap)
    b, h, s, hd = q.shape
    kv, t, hd_v = k.shape[1], k.shape[2], v.shape[3]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qf = q.float().reshape(b, kv, h // kv, s, hd)
    q_pos = torch.arange(s, device=q.device) + (t - s)
    m = torch.full((b, kv, h // kv, s, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, h // kv, s, hd_v), device=q.device)
    for k0 in range(first_block(t - s, window, bk) * bk, t, bk):
        kb = k[:, :, k0:k0 + bk].float()
        vb = v[:, :, k0:k0 + bk].float()
        sc = runtime.cap_scores(torch.einsum("bkgsd,bktd->bkgst", qf, kb) * scale, softcap)
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        sc = sc.masked_fill(hidden_keys(q_pos, k_pos, window, prefix), NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb[:, :, None])
        m = m_new
    out = (acc / l.clamp_min(1e-30)).reshape(b, h, s, hd_v).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l.clamp_min(1e-30))).reshape(b, h, s)
    return out


def _empty_out(q: torch.Tensor, hd_v: int) -> torch.Tensor:
    """The output ``[B, H, S, hd_v]``: ``empty_like(q)`` at equal widths;
    else laid out as q's first three dimensions are (by decreasing stride),
    so the model's transposed ``[B, S, H, hd]`` views give the same view of
    ``[B, S, H, hd_v]``."""
    if hd_v == q.shape[3]:
        return torch.empty_like(q)  # keeps q's layout when q is dense
    order = sorted(range(3), key=lambda i: -q.stride(i))
    shape = [q.shape[i] for i in order] + [hd_v]
    out = torch.empty(shape, dtype=q.dtype, device=q.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = MAX_BLOCK, bk: int = MAX_BLOCK,
                    split_p: bool = True, scale: float | None = None,
                    window: int = 0, prefix: int = 0, softcap: float = 0.0,
                    return_lse: bool = False):
    """q: [B, H, S, hd]; k: [B, KV, T, hd]; v: [B, KV, T, hd_v]; causal with
    offset T - S, and with ``window > 0`` only the last ``window`` keys up to
    each query's position, with ``prefix > 0`` also every key below
    ``prefix`` (every key at ``prefix >= T``, where S may exceed T); scores
    scaled by ``scale`` (default ``1 / sqrt(hd)``), then capped by
    ``softcap`` when it is positive.

    ``bq, bk`` must suit the call's :func:`route` (:func:`check_blocks`);
    on a CUDA tensor ``(hd, hd_v)`` must also lie in ``HEAD_PAIRS``.  The
    output ``[B, H, S, hd_v]`` has q's strides where q is dense (its
    dimension order at unequal widths).  ``split_p=False`` (tensor-core route
    only) rounds P to bf16 once instead of keeping it as ``P_hi + P_lo``: a
    probe of what the split costs, not the main path (it raises under grad).
    Under grad (an input requiring it) a CUDA call raises: its launch records
    nothing for autograd, so training goes through ``remop_flash_attention``
    (``FlashAttentionFn``).  Query blocks do not
    change any row's arithmetic, so the plain version takes only ``bk``.
    ``return_lse=True`` returns ``(out, lse)`` with each row's log-sum-exp,
    f32 ``[B, H, S]``; on a CUDA tensor only the tensor-core route writes it,
    at ``(hd, hd_v)`` in :data:`LSE_HEAD_PAIRS`.
    """
    _check(q, k, v, window, prefix)
    softcap = runtime.check_softcap(softcap)
    b, h, s, hd = q.shape
    hd_v = v.shape[3]
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    path = route(q, k, v)
    check_blocks(path, bq, bk, hd, hd_v)
    if not split_p and (path != "tc" or softcap):
        raise ValueError("split_p=False exists on the tensor-core route only, without a cap")
    grad = runtime.needs_grad(q, k, v)
    if grad and not split_p:
        raise NotImplementedError("split_p=False is a probe, not a path: it has no backward")
    if runtime.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, bk, scale, window, prefix, softcap, return_lse)
    if grad:
        raise NotImplementedError(
            "flash_attention launches the forward kernel alone, whose output carries no "
            "gradient; under grad call remop_flash_attention, which goes through "
            "FlashAttentionFn and its backward kernel")
    if (hd, hd_v) not in HEAD_PAIRS:
        raise ValueError(f"head_dim {hd} with value width {hd_v} not in {HEAD_PAIRS}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the last dimension of q, k and v must be contiguous")
    if return_lse and (path != "tc" or (hd, hd_v) not in LSE_HEAD_PAIRS):
        raise ValueError(f"only the tensor-core route at (hd, hd_v) in {LSE_HEAD_PAIRS} writes "
                         f"the log-sum-exp (return_lse); got {path} at {(hd, hd_v)}")
    kv, t = k.shape[1], k.shape[2]
    out = _empty_out(q, hd_v)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    width = kernel_widths(hd, hd_v)[0]
    qk, kk = pad_heads(q, width), pad_heads(k, width)
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (qk, kk, v, out) for st in (x.stride(0), x.stride(1), x.stride(2))))
    lib = runtime.library("flash_attention")
    args = (qk.data_ptr(), kk.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, h, kv, s, t, width, bq, bk, scale)
    with torch.cuda.device(q.device):
        if path == "tc":
            tail = (int(split_p), hd_v, window, prefix, softcap)
            if lse is None:
                err = lib.remop_flash_attention_tc(*args, *tail, runtime.stream_of(q))
            else:
                err = lib.remop_flash_attention_tc_lse(*args, *tail, lse.data_ptr(),
                                                       runtime.stream_of(q))
        else:
            err = getattr(lib, f"remop_flash_attention_{_DTYPES[q.dtype]}")(
                *args, hd_v, window, prefix, softcap, runtime.stream_of(q))
    runtime.check("flash_attention", "flash_attention", err)
    runtime.launches["flash_attention"] += 1
    runtime.launches[f"flash_attention_{path}"] += 1
    if hd_v != hd:
        runtime.launches[f"flash_attention_{path}_{hd}x{hd_v}"] += 1
    if window:
        runtime.launches["flash_attention_windowed"] += 1
    if prefix:
        runtime.launches["flash_attention_prefix"] += 1
    if prefix >= t:
        runtime.launches["flash_attention_full"] += 1
    if softcap:
        runtime.launches["flash_attention_softcap"] += 1
    return (out, lse) if return_lse else out


def occupancy(hd: int, bq: int, bk: int, split_p: bool = True, hd_v: int | None = None,
              capped: bool = False) -> dict:
    """The tensor-core instantiation these blocks launch (``capped``: the
    one with a softcap), on the current card: CTAs one SM holds at once
    (CUDA's occupancy calculator), registers and local (spilled) bytes a
    thread, dynamic shared memory and threads a CTA."""
    hd_v = hd if hd_v is None else hd_v
    check_blocks("tc", bq, bk, hd, hd_v)
    out = (ctypes.c_int * 5)()
    err = runtime.library("flash_attention").remop_flash_attention_tc_occupancy(
        hd, hd_v, bq, bk, int(split_p), int(capped), ctypes.addressof(out))
    runtime.check("flash_attention", "flash_attention", err)
    return dict(zip(("resident_ctas", "registers", "local_bytes", "smem_bytes", "threads"), out))

"""Paged decode attention (flash-decoding) as a CUDA kernel for Hopper.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``paged_attention`` of the JAX package's
``kernels/paged_attention/paged_attention.py``: ``q [B, KV, G, hd]``,
caches ``[B, S, KV, hd]``, ``lengths [B]`` int32; scores in f32 with
positions ``>= lengths[b]`` masked, an f32 softmax, ``p @ v`` in f32.

The positions are split over CTAs.  :func:`plan` gives, on the host, the
number of splits and the query heads one CTA holds; each CTA finds its own
chunk of positions on the device from ``lengths[b]`` by the rule of
:func:`chunk_len` (:func:`chunk_bounds` on the host), so the host never reads
``lengths``.  Each live chunk leaves an f32 partial ``(acc, m, l)`` per query
head in a scratch buffer the wrapper allocates, and a second kernel merges
the partials in split order.

The latent route, :func:`latent_decode`, is MLA's absorbed-weight decode
(the JAX package's ``models/attention.py`` ``mla_decode``, which computes it
with jnp einsums): ``q [B, H, 576]`` (``q_nope W_uk^T`` beside ``q_rope``)
against the latent cache ``[B, S, 576]`` (``c_kv`` 512 beside ``k_rope``
64), the values the first 512 columns of the same rows, so each row is read
once for both; the caller gives the scale (``1 / sqrt(nope + rope)``, not
``1 / sqrt(576)``).  It is the same split kernel with ``(HD, HDV) = (576,
512)``, all H query heads on the one latent head (:func:`latent_plan`), and
its own chunk floor: chunks of at least :data:`LATENT_MIN_CHUNK` positions,
so the f32 partials (``16 x 514`` floats a chunk at 16 heads) stay at most
22% of the chunk's cache bytes (at length 2048: 16 chunks, 526,336 bytes of
partials against 2,359,296 of cache; chunks of 16 would write 4.2 MB).
Launches count under ``"paged_attention_latent"``.

With ``softcap = c > 0`` the scaled scores are capped before the mask, ``s =
tanh(s / c) * c`` (``repro``'s attention logit softcap), in an instantiation
of its own, so a call without a cap keeps its code and its bits; capped
launches also count under ``"paged_attention_softcap"``.  The latent route
takes no cap: ``repro``'s ``mla_decode`` applies none.

The int8 route, :func:`paged_attention_int8`, reads ``repro``'s int8 KV
cache: int8 ``k_q``, ``v_q`` ``[B, S, KV, hd]`` and bf16 scales ``[B, S,
KV, 1]``, q and the output bf16.  Its CTAs copy the int8 rows (half the
bf16 route's bytes, plus two bytes a row of scale) into their ring, widen
each landed tile in shared memory to the bf16 tile the bf16 route reads, a
value ``bf16(float(q) * float(scale))`` as ``models.attention.dequantize_kv``
rounds it, and from there run the bf16 route's code: its output equals the
bf16 route on the dequantized caches bit for bit.  Launches count under
``"paged_attention_int8"``.

Beside each wrapper is its plain PyTorch version, the same split arithmetic:
an online softmax page by page, kept per chunk, then the same fixed-order
merge; with one split it is the TPU kernel's page-by-page online softmax.
Positions past ``lengths`` add exactly 0, whatever they hold (NaN
included).  A CPU tensor takes it, a CUDA tensor launches the kernel or
raises.  :func:`check_shape` is the wrapper's pre-launch check of what the
kernel takes, callable on the host without a card.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import runtime

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# The plan's inputs: the H100's SMs, the most query heads one CTA holds (its
# shared memory at f32, hd 256: 207,872 of 232,448 bytes), and the chunk
# granule.  Chunks of fewer than 16 positions would leave most of a 32-row
# tile idle.
SMS = 132
MAX_GROUP = 64
MIN_CHUNK = 16
# The latent route: key and value widths (kv_lora_rank 512 + rope 64, and
# 512), the query heads one CTA holds (16 q rows of 576 f32 in shared
# memory), and the least positions a chunk takes.
LATENT_DIMS = (576, 512)
LATENT_MAX_GROUP = 16
LATENT_MIN_CHUNK = 128


def check_shape(g: int, hd: int) -> None:
    """Raise ``ValueError`` unless the kernel can launch for G query heads
    per KV head at head width ``hd``: any ``G >= 1``, ``hd`` in ``HEAD_DIMS``."""
    if g < 1:
        raise ValueError(f"G={g} query heads per KV head; need at least 1")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} must be in {HEAD_DIMS}")


def plan(b: int, kv: int, g: int, s: int) -> Tuple[int, int]:
    """``(splits, gc)`` for the kernel: ``gc`` query heads a CTA (all G of a
    KV head up to ``MAX_GROUP``, so each K/V row is read once), and enough
    splits of the positions that the ``B * KV * ceil(G / gc)`` head groups
    fill the SMs at least once, with no more splits than chunks of
    ``MIN_CHUNK`` positions in S."""
    gc = min(g, MAX_GROUP)
    groups = b * kv * -(-g // gc)
    return max(1, min(-(-SMS // groups), -(-s // MIN_CHUNK))), gc


def latent_plan(b: int, h: int, s: int) -> Tuple[int, int]:
    """``(splits, gc)`` of the latent route: ``gc = min(H, LATENT_MAX_GROUP)``
    query heads a CTA, and enough splits to fill the SMs with no more than
    chunks of ``LATENT_MIN_CHUNK`` positions in S."""
    gc = min(h, LATENT_MAX_GROUP)
    groups = b * -(-h // gc)
    return max(1, min(-(-SMS // groups), -(-s // LATENT_MIN_CHUNK))), gc


def chunk_len(length, splits: int, min_chunk: int = MIN_CHUNK):
    """Positions of each split's chunk for a row of ``length`` valid positions:
    ``ceil(max(length, 1) / splits)`` rounded up to ``MIN_CHUNK``, and at
    least ``min_chunk`` (a multiple of ``MIN_CHUNK``).  Takes an int or an
    integer tensor of lengths (the kernel's rule, written in torch)."""
    if isinstance(length, torch.Tensor):
        c = (length.clamp_min(1) + splits - 1) // splits
        return ((c + MIN_CHUNK - 1) // MIN_CHUNK * MIN_CHUNK).clamp_min(min_chunk)
    c = (max(length, 1) + splits - 1) // splits
    return max((c + MIN_CHUNK - 1) // MIN_CHUNK * MIN_CHUNK, min_chunk)


def chunk_bounds(length: int, splits: int, min_chunk: int = MIN_CHUNK) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of each split's chunk; an empty chunk has ``lo == hi``."""
    c = chunk_len(length, splits, min_chunk)
    return [(min(i * c, length), min((i + 1) * c, length)) for i in range(splits)]


def scratch_floats(b: int, kv: int, g: int, hd: int, splits: int) -> int:
    """f32 values of the partials' buffer: ``acc [B*KV*G, splits, hd]`` then
    ``(m, l) [B*KV*G, splits, 2]`` (``hd`` the value width)."""
    return b * kv * g * splits * (hd + 2)


def _check(q, k_cache, v_cache, lengths, page: int, pages_divide: bool) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q must be [B,KV,G,hd] and caches [B,S,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, kv, _, hd = q.shape
    if (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) != (b, kv, hd):
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q {tuple(q.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32 [{b}], got {lengths.dtype} {tuple(lengths.shape)}")
    if page < 1 or (pages_divide and k_cache.shape[1] % page):
        raise ValueError(f"page={page} must divide S={k_cache.shape[1]}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q and caches must share one dtype of {sorted(map(str, _DTYPES))}")


def _split_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, page: int, splits: int, scale: float,
                     min_chunk: int, softcap: float = 0.0) -> torch.Tensor:
    """The split kernel's arithmetic: q [B, KV, G, hd], k [B, S, KV, hd],
    v [B, S, KV, hd_v] -> [B, KV, G, hd_v]; scores capped before the mask
    when ``softcap > 0``."""
    b, kv, g, _ = q.shape
    s, hd_v = k_cache.shape[1], v_cache.shape[3]
    qf = q.float()
    ln = lengths.long().clamp(max=s)
    c = chunk_len(ln, splits, min_chunk)  # [B]
    ids = torch.arange(splits, device=q.device)
    m = torch.full((b, kv, g, splits), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, g, splits, hd_v), device=q.device)
    # Pages past the longest length are not walked: every position there
    # would add exactly 0 (p = 0, m and l unchanged).
    for p0 in range(0, int(ln.max()), page):
        kp = k_cache[:, p0:p0 + page].float()
        sc = runtime.cap_scores(torch.einsum("bkgd,btkd->bkgt", qf, kp) * scale, softcap)
        pos = torch.arange(p0, p0 + kp.shape[1], device=q.device)
        valid = pos[None, :] < ln[:, None]  # [B, page]
        # Rows past the length are never read by the kernel: zeroed here, so
        # whatever they hold (NaN too) adds exactly 0.
        vp = torch.where(valid[:, :, None, None], v_cache[:, p0:p0 + page].float(), 0.0)
        owner = (pos[None, :] // c[:, None])[..., None] == ids  # [B, page, splits]
        inside = (owner & valid[..., None])[:, None, None]  # [B, 1, 1, page, splits]
        sc = sc[..., None].expand(*sc.shape, splits)
        m_new = torch.maximum(m, sc.masked_fill(~inside, NEG_INF).amax(dim=-2))
        p = torch.where(inside, torch.exp(sc - m_new[..., None, :]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-2)
        acc = acc * corr[..., None] + torch.einsum("bkgts,btkd->bkgsd", p, vp)
        m = m_new
    live = (ids[None, :] * c[:, None] < ln[:, None])[:, None, None]  # [B, 1, 1, splits]
    m_all = m.masked_fill(~live, NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - m_all), 0.0)
    l_all = (l * w).sum(dim=-1, keepdim=True)
    return ((acc * w[..., None]).sum(dim=-2) / l_all.clamp_min(1e-30)).to(q.dtype)


def paged_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          lengths: torch.Tensor, page: int = 128,
                          splits: Optional[int] = None, softcap: float = 0.0) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: ``splits`` chunks by the kernel's
    rule (by default :func:`plan`'s), an online softmax page by page in each,
    then the fixed-order merge of the chunks' partials.

    A position outside a chunk adds exactly 0 to that chunk's partial; a
    chunk past the length is skipped by the merge; pages past the longest
    length are not walked.
    """
    b, kv, g, hd = q.shape
    if splits is None:
        splits = plan(b, kv, g, k_cache.shape[1])[0]
    return _split_attention(q, k_cache, v_cache, lengths, page, splits, 1.0 / math.sqrt(hd),
                            MIN_CHUNK, runtime.check_softcap(softcap))


def paged_attention_int8_plain(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                               k_scale: torch.Tensor, v_scale: torch.Tensor,
                               lengths: torch.Tensor, page: int = 128,
                               splits: Optional[int] = None,
                               softcap: float = 0.0) -> torch.Tensor:
    """The int8 route's plain version: each cache value widened to q's dtype
    as the kernel widens it, ``float(q) * float(scale)`` rounded once (what
    ``models.attention.dequantize_kv`` computes), then
    :func:`paged_attention_plain`."""
    k, v = ((x.float() * s.float()).to(q.dtype) for x, s in ((k_q, k_scale), (v_q, v_scale)))
    return paged_attention_plain(q, k, v, lengths, page, splits, softcap)


def latent_decode_plain(q: torch.Tensor, latent: torch.Tensor, lengths: torch.Tensor,
                        scale: float, v_dim: int = LATENT_DIMS[1], page: int = 128,
                        splits: Optional[int] = None) -> torch.Tensor:
    """The latent route's arithmetic in PyTorch: q [B, H, D] against the rows
    of latent [B, S, D] up to ``lengths``, values their first ``v_dim``
    columns -> [B, H, v_dim]; :func:`latent_plan`'s splits by default, chunks
    of at least ``LATENT_MIN_CHUNK`` positions, the same online softmax and
    merge as :func:`paged_attention_plain`.  Any widths (the reduced models'
    too); the kernel takes (576, 512)."""
    if splits is None:
        splits = latent_plan(q.shape[0], q.shape[1], latent.shape[1])[0]
    rows = latent[:, :, None, :]
    out = _split_attention(q[:, None], rows, rows[..., :v_dim], lengths, page, splits, scale,
                           LATENT_MIN_CHUNK)
    return out[:, 0]


def attributes(dtype: torch.dtype, hd: int, gc: int) -> dict:
    """The split kernel's registers, local (spilled) bytes, dynamic shared
    memory and CTAs resident on one SM at ``gc`` heads, and the combine
    kernel's registers and local bytes, on the current card; ``dtype``
    ``torch.int8`` names the int8 route (bf16 q)."""
    check_shape(gc, hd)
    out = (ctypes.c_int * 6)()
    route = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}[dtype]
    err = runtime.library("paged_attention").remop_paged_attention_attributes(
        route, hd, gc, ctypes.addressof(out))
    runtime.check("paged_attention", "paged_attention", err)
    return dict(zip(("registers", "local_bytes", "smem_bytes", "resident_ctas",
                     "combine_registers", "combine_local_bytes"), out))


def _launch_args(q: torch.Tensor, tensors, s: int):
    """Checks of a CUDA launch: the shape, contiguous tensors, 16-byte
    aligned q and caches.  Returns (splits, gc, out, scratch)."""
    b, kv, g, hd = q.shape
    check_shape(g, hd)
    runtime.refuse_grad("paged_attention", "a decode gradient (decode is inference only)",
                        *tensors)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, the caches, their scales and lengths must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors[:3]):
        raise ValueError("q and the caches must start on a 16-byte boundary")
    splits, gc = plan(b, kv, g, s)
    scratch = torch.empty(scratch_floats(b, kv, g, hd, splits), dtype=torch.float32,
                          device=q.device)
    return splits, gc, torch.empty_like(q), scratch


def _count(route: str, softcap: float) -> None:
    runtime.launches[route] += 1
    if softcap:
        runtime.launches["paged_attention_softcap"] += 1


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    lengths: torch.Tensor, page: int = 128, softcap: float = 0.0) -> torch.Tensor:
    """q: [B, KV, G, hd]; k/v_cache: [B, S, KV, hd]; lengths: [B] int32 in [1, S];
    scores capped by ``softcap`` when it is positive.

    ``page`` is the plain version's page and must divide S on the CPU; the
    kernel walks its own tiles and takes any S.  On a CUDA tensor all four
    must be contiguous and pass :func:`check_shape`.
    """
    cpu = runtime.on_cpu(q, k_cache, v_cache, lengths)
    _check(q, k_cache, v_cache, lengths, page, pages_divide=cpu)
    softcap = runtime.check_softcap(softcap)
    if cpu:
        return paged_attention_plain(q, k_cache, v_cache, lengths, page, softcap=softcap)
    b, kv, g, hd = q.shape
    s = k_cache.shape[1]
    splits, gc, out, scratch = _launch_args(q, (q, k_cache, v_cache, lengths), s)
    lib = runtime.library("paged_attention")
    with torch.cuda.device(q.device):
        err = getattr(lib, f"remop_paged_attention_{_DTYPES[q.dtype]}")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, kv, g, s, hd, splits, gc,
            1.0 / math.sqrt(hd), softcap, runtime.stream_of(q))
    runtime.check("paged_attention", "paged_attention", err)
    _count("paged_attention", softcap)
    return out


def _check_int8(q, k_q, v_q, k_scale, v_scale, lengths, page: int, pages_divide: bool) -> None:
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise TypeError(f"the int8 route takes int8 caches, got {k_q.dtype}, {v_q.dtype}")
    if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
        raise TypeError(f"the int8 route takes bf16 scales, got {k_scale.dtype}, {v_scale.dtype}")
    if k_q.dim() != 4 or tuple(k_scale.shape) != tuple(k_q.shape[:3]) + (1,) or (
            k_scale.shape != v_scale.shape):
        raise ValueError(f"scales must be [B, S, KV, 1] beside caches [B, S, KV, hd]; got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}, {tuple(k_q.shape)}")
    # The rest as the bf16 route checks it: the caches' shapes, in q's dtype.
    _check(q, *(torch.empty(x.shape, dtype=q.dtype, device="meta") for x in (k_q, v_q)),
           lengths, page, pages_divide)


def paged_attention_int8(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor, lengths: torch.Tensor,
                         page: int = 128, softcap: float = 0.0) -> torch.Tensor:
    """q: [B, KV, G, hd]; int8 k_q/v_q: [B, S, KV, hd]; bf16 k_scale/v_scale:
    [B, S, KV, 1]; lengths: [B] int32 in [1, S] -> [B, KV, G, hd]: the paged
    attention of q over the dequantized caches, scores capped by ``softcap``
    when it is positive.

    On a CPU tensor q may be any float dtype (the caches dequantize to it);
    on a CUDA tensor q is bf16, all six tensors contiguous, and the split
    plan, chunks and combine are the bf16 route's.
    """
    tensors = (q, k_q, v_q, lengths, k_scale, v_scale)
    cpu = runtime.on_cpu(*tensors)
    _check_int8(q, k_q, v_q, k_scale, v_scale, lengths, page, pages_divide=cpu)
    softcap = runtime.check_softcap(softcap)
    if cpu:
        return paged_attention_int8_plain(q, k_q, v_q, k_scale, v_scale, lengths, page,
                                          softcap=softcap)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the int8 route takes bf16 q on the card, got {q.dtype}")
    b, kv, g, hd = q.shape
    s = k_q.shape[1]
    splits, gc, out, scratch = _launch_args(q, tensors, s)
    lib = runtime.library("paged_attention")
    with torch.cuda.device(q.device):
        err = lib.remop_paged_attention_int8_bf16(
            q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, kv,
            g, s, hd, splits, gc, 1.0 / math.sqrt(hd), softcap, runtime.stream_of(q))
    runtime.check("paged_attention", "paged_attention", err)
    _count("paged_attention_int8", softcap)
    return out


def latent_attributes(dtype: torch.dtype, gc: int) -> dict:
    """:func:`attributes` of the latent route's split kernel at ``gc`` heads."""
    if not 1 <= gc <= LATENT_MAX_GROUP:
        raise ValueError(f"gc={gc} must lie in [1, {LATENT_MAX_GROUP}]")
    out = (ctypes.c_int * 6)()
    err = runtime.library("paged_attention").remop_latent_decode_attributes(
        int(dtype == torch.float32), gc, ctypes.addressof(out))
    runtime.check("paged_attention", "paged_attention", err)
    return dict(zip(("registers", "local_bytes", "smem_bytes", "resident_ctas",
                     "combine_registers", "combine_local_bytes"), out))


def _check_latent(q, latent, lengths, v_dim: int) -> None:
    if q.dim() != 3 or latent.dim() != 3:
        raise ValueError(f"q must be [B,H,D] and latent [B,S,D]; got {tuple(q.shape)}, "
                         f"{tuple(latent.shape)}")
    b, h, d = q.shape
    if latent.shape[0] != b or latent.shape[2] != d or not 1 <= v_dim <= d or h < 1:
        raise ValueError(f"latent {tuple(latent.shape)} and v_dim {v_dim} do not fit "
                         f"q {tuple(q.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32 [{b}], got {lengths.dtype} {tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or latent.dtype != q.dtype:
        raise TypeError(f"q and latent must share one dtype of {sorted(map(str, _DTYPES))}")


def latent_decode(q: torch.Tensor, latent: torch.Tensor, lengths: torch.Tensor, scale: float,
                  v_dim: int = LATENT_DIMS[1]) -> torch.Tensor:
    """q: [B, H, D]; latent: [B, S, D]; lengths: [B] int32 in [1, S] ->
    [B, H, v_dim]: softmax(scale q latent^T) latent[..., :v_dim] over the
    positions below ``lengths``.

    Any S; on a CUDA tensor ``(D, v_dim)`` must be :data:`LATENT_DIMS` and
    all three tensors contiguous.
    """
    _check_latent(q, latent, lengths, v_dim)
    if runtime.on_cpu(q, latent, lengths):
        return latent_decode_plain(q, latent, lengths, scale, v_dim)
    b, h, d = q.shape
    if (d, v_dim) != LATENT_DIMS:
        raise ValueError(f"the latent route takes (D, v_dim) = {LATENT_DIMS}, got {(d, v_dim)}")
    tensors = (q, latent, lengths)
    runtime.refuse_grad("paged_attention_latent", "a decode gradient (decode is inference only)",
                        *tensors)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, latent and lengths must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors[:2]):
        raise ValueError("q and latent must start on a 16-byte boundary")
    s = latent.shape[1]
    splits, gc = latent_plan(b, h, s)
    out = torch.empty((b, h, v_dim), dtype=q.dtype, device=q.device)
    scratch = torch.empty(scratch_floats(b, 1, h, v_dim, splits), dtype=torch.float32,
                          device=q.device)
    lib = runtime.library("paged_attention")
    with torch.cuda.device(q.device):
        err = getattr(lib, f"remop_latent_decode_{_DTYPES[q.dtype]}")(
            q.data_ptr(), latent.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, h, s, splits, gc, LATENT_MIN_CHUNK, float(scale),
            runtime.stream_of(q))
    runtime.check("paged_attention", "paged_attention", err)
    runtime.launches["paged_attention_latent"] += 1
    return out

"""The gradient of the flash kernel, and the autograd Function around both.

The TPU kernel ``flash_attention`` of the JAX package's
``kernels/flash_attention/flash_attention.py`` has no backward: ``repro``
trains through XLA's autodiff of ``full_attention``/``chunked_attention``
(``models/attention.py``).  The port's forward on the card is the
hand-written flash kernel, whose launch records nothing for autograd, so its
gradient is a hand-written kernel too (``csrc/flash_attention_bwd.cu``,
the library ``flash_attention_bwd``): given q, k, v, the forward's output
and that output's gradient it returns (dq, dk, dv) of what the forward
computes, with the same mask (causal with offset ``T - S``, ``window``,
``prefix``, every key at ``prefix >= T``), ``scale`` and ``softcap``.  No
atomics on either route: two calls give the same bits.  Two routes, chosen
on the host by :func:`bwd_route` from dtype, head widths and alignment
alone:

- ``"tc"``: bf16 at ``(hd, hd_v)`` in :data:`BWD_TC_HEAD_PAIRS` (64, 128,
  256 and MLA's (192, 128)) whose five tensors are TMA-aligned (the
  forward's rule).  Two launches on the tensor cores (``wgmma``, TMA
  rings): ``dq_tc`` (which also writes ``D = sum(dO * O)``) and a dkdv
  kernel, reading each row's log-sum-exp from the forward
  (``flash_attention(..., return_lse=True)``), blocks
  :func:`plan_bwd_tc_blocks`'.  At hd 64 and 128 the dkdv kernel is
  ``dkdv_tc`` (128 keys a CTA, dK and dV of 64 keys in each consumer
  warpgroup); at (256, 256) and (192, 128) it is ``dkdv_wg`` (64 keys a
  CTA, dV in one warpgroup and dK in the other, P^T passed between them in
  shared memory).  There, where few KV heads leave most SMs idle,
  :func:`plan_bwd_kv_split` cuts each key block's walk over the GQA group's
  heads and query blocks into ``n`` parts, one CTA each: they write f32
  partial dK and dV, and a third launch sums them in a fixed order
  (:func:`kv_reduce`), so two calls still give the same bits.  A long
  walk loses dK's precision in wgmma's f32 sums, so where a key block's
  walk may pass :data:`BWD_RUN_ROWS` (head, query) rows, or the call has a
  prefix (:func:`bwd_flushes`), both dkdv kernels flush: every
  :data:`BWD_FLUSH_ROWS` rows of its walk each CTA adds its accumulators
  into its f32 partial in scratch and restarts them from 0
  (:func:`plan_bwd_flush_steps`, :func:`dkdv_runs`), in one launch; such
  a call splits over CTAs only where occupancy asks, at dkdv_tc too (and
  there into CTAs of at most :data:`BWD_CTA_ROWS` rows of the longest
  walk), and at one CTA a key block writes dk and dv itself.  Both form dK from dS^T
  in three bf16 terms (hi + mid + lo).  A call this route takes never runs
  on the CUDA-core kernel: a missing lse, a failed build, encode or launch
  raises.
- ``"simt"``: everything else, at ``(hd, hd_v)`` in
  :data:`BWD_HEAD_PAIRS`: three launches on the CUDA cores (``prep``: each
  row's log-sum-exp and D; ``dq``; ``dkdv``), bf16 or f32, blocks
  :func:`plan_bwd_blocks`': every f32 call, and bf16 at the reduced
  configs' widths (hd 16 and 32; at (24, 16) the kernels run at (32, 16)
  on q and k zero-padded to 32, and dq and dk are cut back to 24).

``runtime.launches`` counts every call under ``"flash_attention_bwd"`` and
under ``"flash_attention_bwd_tc"`` or ``"flash_attention_bwd_simt"``, and,
as the forward counts its mask kinds, a windowed call under
``"flash_attention_bwd_windowed"``, one with a prefix under
``"flash_attention_bwd_prefix"`` and, where the prefix covers every key,
also under ``"flash_attention_bwd_full"``.

Beside it is its plain PyTorch version, the same formulas in f64 over the
same KV blocks (given the forward's lse it uses it, else it recomputes it);
a CPU tensor takes it, a CUDA tensor launches the kernel or raises.

:class:`FlashAttentionFn` runs the forward wrapper and saves q, k, v and
the output, and with a ``tc`` backward ahead also the forward's lse; its
backward is :func:`flash_attention_bwd`.  ``ops.remop_flash_attention``
goes through it only under grad, so serving (``torch.inference_mode``)
keeps its launches, bits and time.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.cost_model import H100
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.flash_attention import (
    NEG_INF, SMEM_LIMIT, _DTYPES, _check, _tma_aligned, first_block,
    flash_attention, hidden_keys, kernel_widths, pad_heads,
)

# (hd, hd_v) the backward kernel takes: the widths the repo's configs train
# at, the reduced ones (``configs.reduced``: hd 16; hd 32 beside it; MLA's
# nope 16 + rope 8 over values of 16) among them.  (24, 16) runs the CUDA-core
# kernels at (32, 16) on q and k zero-padded to 32 (``PADDED_HEAD_PAIRS``).
BWD_HEAD_PAIRS = ((64, 64), (128, 128), (256, 256), (192, 128), (16, 16), (32, 32), (24, 16))
# Square blocks (bq = bk), largest first: the first whose three kernels fit a CTA.
BWD_BLOCKS = (64, 32, 16)
BWD_KERNELS = ("prep", "dq", "dkdv")
# The tensor-core route: every width the backward takes (the forward
# writes lse at all of them), its kernels and, per width and kernel, the
# (rows of the CTA's own tile, rows of each streamed block) it is built
# for.  dq_tc holds 128 query rows (64 at hd 256, where 128 would not fit
# shared memory) and streams K/V blocks of 64 keys, one consumer warpgroup
# per 64 rows.  dkdv at hd 64 / 128 (dkdv_tc) holds 128 keys, one
# warpgroup per 64, and streams Q/dO blocks of 64 (or 32) query rows; at
# (256, 256) and (192, 128) (dkdv_wg, blocks (64, 64)) its two consumer
# warpgroups share 64 keys, one holding dV, the other dK.  A key block may
# take several CTAs where KV heads are few (plan_bwd_kv_split): at dkdv_wg,
# and at dkdv_tc in a call that flushes (bwd_flushes).  The narrower widths
# of BWD_HEAD_PAIRS (16, 32, (24, 16)) run on the CUDA cores ("simt").
BWD_TC_HEAD_PAIRS = ((64, 64), (128, 128), (256, 256), (192, 128))
BWD_TC_WG_PAIRS = ((256, 256), (192, 128))
BWD_TC_KERNELS = ("dq", "dkdv")
_NARROW_BLOCKS = {"dq": ((128, 64),), "dkdv": ((128, 64), (128, 32))}
BWD_TC_BLOCKS = {
    (64, 64): _NARROW_BLOCKS,
    (128, 128): _NARROW_BLOCKS,
    (256, 256): {"dq": ((64, 64),), "dkdv": ((64, 64),)},
    (192, 128): {"dq": ((128, 64),), "dkdv": ((64, 64),)},
}
# Instantiations that spill at their first block pair (ptxas on sm_90a,
# read on the card), as (kernel, hd, capped, blocks): the capped dkdv at hd
# 128 and 64 query rows (16 bytes with dS^T in three terms, flushing or not;
# 28 with two); the plan takes the next pair there.
BWD_TC_SPILLS = {("dkdv", 128, True, (128, 64))}
# dkdv's CTAs a key block at most (its f32 partials are scratch of
# kv_split x dK and dV).
BWD_KV_SPLIT_MAX = 16
# The (head, query) rows one dkdv accumulator may sum in a call that does
# not flush: wgmma's f32 sums lose more than the CUDA cores' over long walks.
# On an H100 with q 8 times the unit scale (flash_probe.py --bwd-run-rows,
# 41 draws a row), accumulators of 4,096 rows left dK past ATTN_TOL's
# elementwise bound against f64 on 3 draws of qwen3-0.6b's [4, 16, 2048,
# 128] on 8 KV heads, of 2,048 rows on none of MLA's [4, 16, 2048] (192,
# 128) or seamless-m4t's every-key [4, 16, 2048, 64] on 16 KV heads.  A call
# whose walk may pass it flushes.
BWD_RUN_ROWS = 2048
# The rows one accumulator sums between flushes in a call that flushes.  On
# an H100 with q 8 times the unit scale (flash_probe.py --bwd-run-rows, 41
# draws a row): parts and runs of 4,096 rows missed ATTN_TOL's elementwise
# bound against f64 on 3 of 46 draws of the causal G 8 rows (up to 1.39x)
# and on 26 of 41 of paligemma-3b's prefix shape; runs of 256 rows flushed
# into the f32 partial on 1 draw of 41 of granite-20b's G 48 (1.29x, an
# entry of 4e-4 cancelling from terms summing to 330) and on none of the
# other eight q-gain-8 rows.
BWD_FLUSH_ROWS = 256
# The (head, query) rows of a key block's longest walk that one CTA of a
# flushing call takes at most, where its key blocks leave SMs idle: shorter
# CTAs even the SMs out under the flushes' traffic.  On an H100 (device ms,
# flash_probe.py --bwd, each split of 1 .. 16): paligemma-3b's [4, 8, 2048,
# 256] with prefix 256, 2 CTAs a key block 1.744, 4 1.417, 8 1.410;
# recurrentgemma-2b's [2, 10, 4096, 256] at window 2048, 2 2.849, 4 2.421,
# 8 2.441; gemma-2b's [1, 8, 2048, 256], 8 0.416, 16 0.456.
BWD_CTA_ROWS = 4096


def bwd_smem_bytes(kernel: str, bq: int, bk: int, hd: int, hd_v: int, dtype_bytes: int) -> int:
    """Dynamic shared memory of one CTA of ``kernel``: staged rows of ``w``
    values padded by one 32-bit word; ``prep`` holds Q and a K block,
    ``dq`` Q, dO, one K/V block and the f32 dS tile, ``dkdv`` its K and V,
    a Q and a dO block, the f32 P^T and dS^T tiles and the block's lse and D."""
    row, row_v = (hd * dtype_bytes + 4), (hd_v * dtype_bytes + 4)
    if kernel == "prep":
        return (bq + bk) * row
    if kernel == "dq":
        return (bq + bk) * row + bq * row_v + bq * (bk + 1) * 4
    return (bk + bq) * (row + row_v) + 2 * bk * (bq + 1) * 4 + 2 * bq * 4


def plan_bwd_blocks(hd: int, hd_v: int, dtype_bytes: int) -> int:
    """The largest block of :data:`BWD_BLOCKS` whose three kernels fit in
    the shared memory one CTA may use (64 but for f32 at hd 256: 32)."""
    for b in BWD_BLOCKS:
        if all(bwd_smem_bytes(kind, b, b, hd, hd_v, dtype_bytes) <= SMEM_LIMIT
               for kind in BWD_KERNELS):
            return b
    raise ValueError(f"no backward block fits hd={hd}, hd_v={hd_v}")


def bwd_tc_smem_bytes(kernel: str, rows: int, block: int, hd: int, hd_v: int | None = None
                      ) -> int:
    """Dynamic shared memory of one CTA of the tensor-core ``kernel``: its
    own tile (Q and dO of ``rows`` queries for ``dq``, K and V of ``rows``
    keys for ``dkdv``) and two ring stages of the streamed blocks (K and V,
    or Q and dO, of ``block`` rows), bf16, q and k ``hd`` wide, v and dO
    ``hd_v`` (default ``hd``); ``dkdv`` also the f32 lse and D of each
    stage and, at 64 keys (``dkdv_wg``), the f32 P^T the two warpgroups
    exchange; seven mbarriers and 1024 bytes to align the swizzled tiles."""
    hd_v = hd if hd_v is None else hd_v
    extra = 0
    if kernel == "dkdv":
        extra = 4 * block * 4 + (64 * block * 4 if rows == 64 else 0)
    return 1024 + rows * (hd + hd_v) * 2 + 2 * block * (hd + hd_v) * 2 + extra + 7 * 8


def check_bwd_tc_blocks(kernel: str, rows: int, block: int, hd: int, hd_v: int) -> None:
    """Raise ``ValueError`` for blocks or widths the tensor-core ``kernel``
    is not built for, or whose CTA would not fit in shared memory."""
    built = BWD_TC_BLOCKS.get((hd, hd_v), {}).get(kernel, ())
    if (rows, block) not in built or bwd_tc_smem_bytes(kernel, rows, block, hd,
                                                       hd_v) > SMEM_LIMIT:
        raise ValueError(f"the tensor-core backward's {kernel} takes (hd, hd_v) in "
                         f"{BWD_TC_HEAD_PAIRS} at the blocks of BWD_TC_BLOCKS ({built} at "
                         f"these widths) within {SMEM_LIMIT} bytes; got {(rows, block)} at "
                         f"{(hd, hd_v)}")


def plan_bwd_tc_blocks(hd: int, hd_v: int, capped: bool = False) -> dict:
    """The tensor-core route's blocks at these widths (``capped``: with a
    softcap): each kernel's first block pair of :data:`BWD_TC_BLOCKS` that
    fits and does not spill (:data:`BWD_TC_SPILLS`); at hd 64 / 128
    ``{"dq": (128, 64), "dkdv": (128, 64)}``, but dkdv at (128, 32) capped
    at hd 128; at (256, 256) ``(64, 64)`` both; at (192, 128) dq (128, 64)
    and dkdv (64, 64)."""
    plan = {}
    for kernel in BWD_TC_KERNELS:
        for rows, block in BWD_TC_BLOCKS.get((hd, hd_v), {}).get(kernel, ()):
            try:
                check_bwd_tc_blocks(kernel, rows, block, hd, hd_v)
            except ValueError:
                continue
            if (kernel, hd, bool(capped), (rows, block)) in BWD_TC_SPILLS:
                continue
            plan[kernel] = (rows, block)
            break
        else:
            raise ValueError(f"no tensor-core backward block fits hd={hd}, hd_v={hd_v}")
    return plan


def plan_bwd_kv_split(b: int, kv: int, t: int, group: int, keys_per_cta: int,
                      sms: int = H100.sms) -> int:
    """dkdv's CTAs a key block: 1 when its one CTA per (key block of
    ``keys_per_cta``, KV head, batch) already fill the ``sms`` SMs, else as
    many as two waves hold, ``2 sms // (b kv ceil(t / keys_per_cta))``, at
    most :data:`BWD_KV_SPLIT_MAX`.  Two waves and not one: under the causal
    mask the first key block has S / 64 query blocks to walk and the last
    one, so more and shorter runs even the SMs out (gemma-2b's
    ``[1,8,2048,256]`` on an H100: 0.347 ms device at 8, 0.457 at the one
    wave's 4, 1.187 unsplit; ``flash_probe.py --bwd``).  Each CTA takes one run
    of the key block's steps, the ``group`` query heads of its KV head
    first, then their query blocks.  A pure function of its arguments."""
    if min(b, kv, t, group, keys_per_cta, sms) < 1:
        raise ValueError(f"plan_bwd_kv_split takes positive sizes, got b={b}, kv={kv}, t={t}, "
                         f"group={group}, keys_per_cta={keys_per_cta}, sms={sms}")
    ctas = b * kv * -(-t // keys_per_cta)
    return 1 if ctas >= sms else min(2 * sms // ctas, BWD_KV_SPLIT_MAX)


def bwd_flushes(group: int, s: int, prefix: int = 0) -> bool:
    """Whether dkdv flushes its accumulators every :data:`BWD_FLUSH_ROWS`
    rows in a call of ``group`` query heads a KV head over ``s`` query rows
    with ``prefix``: where the longest walk of a key block (all ``group s``
    rows see it) passes :data:`BWD_RUN_ROWS`, or the call has a prefix
    (whose key blocks every row sees; the encoder's and cross-attention's
    every key too).  Every other call keeps one run a CTA, its plan and its
    bits: MLA's G 1 (2,048 rows)."""
    if min(group, s) < 1:
        raise ValueError(f"bwd_flushes takes positive sizes, got group={group}, s={s}")
    return bool(prefix) or group * s > BWD_RUN_ROWS


def plan_bwd_flush_steps(group: int, s: int, bq: int, prefix: int = 0) -> int:
    """The steps (query blocks of ``bq`` rows) between dkdv's flushes, which
    :func:`bwd_tc_launch` hands the kernels: :data:`BWD_FLUSH_ROWS` / ``bq``
    where the call flushes (:func:`bwd_flushes`), else 0."""
    if min(group, s, bq) < 1:
        raise ValueError(f"plan_bwd_flush_steps takes positive sizes, got group={group}, s={s}, "
                         f"bq={bq}")
    return BWD_FLUSH_ROWS // bq if bwd_flushes(group, s, prefix) else 0


def dkdv_runs(steps: int, kv_split: int, flush_steps: int) -> list:
    """The runs each dkdv CTA sums into one set of accumulators, as both
    dkdv kernels walk a key block's ``steps`` (a query block of one head
    each): CTA z of ``kv_split`` takes the part ``[steps z / n, steps (z +
    1) / n)``, flushing its sums into its f32 partial every ``flush_steps``
    steps (storing them at the first flush and adding them after), or in one
    run at ``flush_steps`` 0.  A list per CTA of the ``range`` of steps of
    each run."""
    if min(steps + 1, kv_split, flush_steps + 1) < 1:
        raise ValueError(f"dkdv_runs takes sizes of at least 0, got steps={steps}, "
                         f"kv_split={kv_split}, flush_steps={flush_steps}")
    ctas = []
    for z in range(kv_split):
        lo, hi = steps * z // kv_split, steps * (z + 1) // kv_split
        run = flush_steps or max(hi - lo, 1)
        ctas.append([range(a, min(a + run, hi)) for a in range(lo, hi, run)])
    return ctas


@functools.lru_cache(maxsize=256)
def longest_bwd_run(group: int, s: int, bq: int, kv_split: int,
                    flush_steps: int | None = None, prefix: int = 0) -> int:
    """The most (head, query) rows one dkdv accumulator sums between flushes
    when a key block seen by all ``s`` query rows of the ``group`` heads (the
    longest walk: ``ceil(s / bq)`` query blocks of ``bq`` rows a head) is
    walked by ``kv_split`` CTAs flushing every ``flush_steps`` steps (by
    default :func:`plan_bwd_flush_steps`' at ``prefix``; :func:`dkdv_runs`)."""
    n_q = -(-s // bq)
    if flush_steps is None:
        flush_steps = plan_bwd_flush_steps(group, s, bq, prefix)
    return max((sum(min(bq, s - (i % n_q) * bq) for i in run)
                for cta in dkdv_runs(group * n_q, kv_split, flush_steps) for run in cta),
               default=0)


def check_bwd_runs(group: int, s: int, bq: int, kv_split: int,
                   flush_steps: int | None = None, prefix: int = 0) -> None:
    """Raise ``ValueError`` where a dkdv plan (:func:`longest_bwd_run`'s
    arguments) lets one accumulator sum more rows between flushes than a
    call with ``prefix`` may: :data:`BWD_FLUSH_ROWS` where it flushes
    (:func:`bwd_flushes`), else :data:`BWD_RUN_ROWS`."""
    longest = longest_bwd_run(group, s, bq, kv_split, flush_steps, prefix)
    rows = BWD_FLUSH_ROWS if bwd_flushes(group, s, prefix) else BWD_RUN_ROWS
    if longest > rows:
        raise ValueError(f"a dkdv run of {longest} (head, query) rows at group={group}, s={s}, "
                         f"bq={bq}, kv_split={kv_split}, prefix={prefix}: at most {rows}")


def bwd_tc_kv_split(b: int, h: int, kv: int, s: int, t: int, hd: int, hd_v: int,
                    prefix: int = 0) -> int:
    """dkdv's CTAs a key block on the tensor-core route:
    :func:`plan_bwd_kv_split`'s at :data:`BWD_TC_WG_PAIRS` (``dkdv_wg``, 64
    keys a CTA) and in a call that flushes (:func:`bwd_flushes`, both
    kernels), else 1 (``dkdv_tc`` in one CTA a key block); a flushing call
    that splits takes at least enough CTAs that each walks at most
    :data:`BWD_CTA_ROWS` of the longest walk's ``group s`` rows, at most
    :data:`BWD_KV_SPLIT_MAX`."""
    group = h // kv
    flushes = bwd_flushes(group, s, prefix)
    if (hd, hd_v) not in BWD_TC_WG_PAIRS and not flushes:
        return 1
    split = plan_bwd_kv_split(b, kv, t, group, plan_bwd_tc_blocks(hd, hd_v)["dkdv"][0])
    if flushes and split > 1:
        split = min(max(split, -(-group * s // BWD_CTA_ROWS)), BWD_KV_SPLIT_MAX)
    return split


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
              dout: torch.Tensor) -> str:
    """``"tc"`` when all five tensors are bf16, ``(hd, hd_v)`` lies in
    :data:`BWD_TC_HEAD_PAIRS` and all five are TMA-aligned (the forward's
    rule: 16-byte base; every dimension of extent > 1 but the last stepped
    by a positive multiple of 8 elements); else ``"simt"``."""
    xs = (q, k, v, out, dout)
    if (all(x.dtype == torch.bfloat16 for x in xs)
            and (q.shape[-1], v.shape[-1]) in BWD_TC_HEAD_PAIRS
            and all(_tma_aligned(x) for x in xs)):
        return "tc"
    return "simt"


def check_bwd_widths(hd: int, hd_v: int) -> None:
    """Raise ``ValueError`` for head widths the backward kernel does not take."""
    if (hd, hd_v) not in BWD_HEAD_PAIRS:
        raise ValueError(f"the flash backward kernel takes (hd, hd_v) in {BWD_HEAD_PAIRS}, got "
                         f"{(hd, hd_v)}; training at this width waits for a later slice")


def cap_grad(capped: torch.Tensor, softcap: float) -> torch.Tensor:
    """The cap's derivative at a capped score ``s_c = c tanh(s / c)``:
    ``1 - (s_c / c)^2``."""
    return 1 - (capped / softcap) ** 2


def _check_grads(q, out, dout) -> None:
    want = (*q.shape[:3], out.shape[3])
    if tuple(out.shape) != want or tuple(dout.shape) != want:
        raise ValueError(f"out and dout must be {want}, got {tuple(out.shape)} and "
                         f"{tuple(dout.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out and dout must be {q.dtype}, got {out.dtype} and {dout.dtype}")


def _check_lse(q: torch.Tensor, lse: torch.Tensor) -> None:
    want = tuple(q.shape[:3])
    if tuple(lse.shape) != want or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 {want} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, dout: torch.Tensor,
                              scale: float | None = None, window: int = 0, prefix: int = 0,
                              softcap: float = 0.0, bk: int = BWD_BLOCKS[0],
                              lse: torch.Tensor | None = None):
    """The kernel's arithmetic in PyTorch, over KV blocks of ``bk``, in f64:
    each row's log-sum-exp over its visible keys (an online max and sum;
    ``lse``, the forward's f32 ``[B, H, S]``, when given) and ``D = sum(dO
    * O)``, then per block ``P = exp(s_c - lse)`` (0 where hidden), ``dV
    += P^T dO``, ``dP = dO V^T``, ``dS = P (dP - D)`` times ``1 - (s_c /
    c)^2`` when capped, ``dQ += dS K``, ``dK += dS^T Q``; dQ and dK times
    ``scale``; each rounded once to the inputs' dtype.  The blocks before
    the first one any row sees (under a window) get 0.  f64 and not the
    kernel's f32: where a KV head's G x S rows are many, an f32 reference's
    own rounding of the scores and of the sums over the rows is as large as
    the kernel's (at 48 heads of 2048 on one KV head, q 8 times the unit
    scale, dK at 0.82-0.86 of ``ATTN_TOL``'s bound against f64 on an H100,
    the kernel's at 0.58), and would count against the kernel."""
    _check(q, k, v, window, prefix)
    _check_grads(q, out, dout)
    softcap = runtime.check_softcap(softcap)
    b, h, s, hd = q.shape
    kv, t, hd_v = k.shape[1], k.shape[2], v.shape[3]
    g = h // kv
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    wd = torch.float64
    qf = q.to(wd).reshape(b, kv, g, s, hd)
    dof = dout.to(wd).reshape(b, kv, g, s, hd_v)
    delta = (dof * out.to(wd).reshape(b, kv, g, s, hd_v)).sum(-1, keepdim=True)
    q_pos = torch.arange(s, device=q.device) + (t - s)
    start = first_block(t - s, window, bk) * bk
    blocks = range(start, t, bk)

    def scores(k0):
        kb = k[:, :, k0:k0 + bk].to(wd)
        sc = runtime.cap_scores(torch.einsum("bkgsd,bktd->bkgst", qf, kb) * scale, softcap)
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        return kb, sc, hidden_keys(q_pos, k_pos, window, prefix)

    if lse is None:
        m = torch.full((b, kv, g, s, 1), NEG_INF, dtype=wd, device=q.device)
        l = torch.zeros_like(m)
        for k0 in blocks:
            _, sc, hidden = scores(k0)
            sc = sc.masked_fill(hidden, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(sc - m_new).sum(dim=-1, keepdim=True)
            m = m_new
        lse = m + torch.log(l)
    else:
        _check_lse(q, lse)
        lse = lse.to(wd).reshape(b, kv, g, s, 1)

    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, kv, t, hd), dtype=wd, device=q.device)
    dv = torch.zeros((b, kv, t, hd_v), dtype=wd, device=q.device)
    for k0 in blocks:
        kb, sc, hidden = scores(k0)
        vb = v[:, :, k0:k0 + bk].to(wd)
        p = torch.exp(sc - lse).masked_fill(hidden, 0.0)
        dv[:, :, k0:k0 + bk] = torch.einsum("bkgst,bkgsd->bktd", p, dof)
        ds = p * (torch.einsum("bkgsd,bktd->bkgst", dof, vb) - delta)
        if softcap:
            ds = ds * cap_grad(sc, softcap)
        dq += torch.einsum("bkgst,bktd->bkgsd", ds, kb)
        dk[:, :, k0:k0 + bk] = torch.einsum("bkgst,bkgsd->bktd", ds, qf)
    return ((dq * scale).reshape(b, h, s, hd).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, scale: float | None = None,
                        window: int = 0, prefix: int = 0, softcap: float = 0.0,
                        lse: torch.Tensor | None = None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, scale=scale, window=window,
    prefix=prefix, softcap=softcap)`` whose output is ``out``, given its
    gradient ``dout`` [B, H, S, hd_v]; each gradient in its input's shape,
    dtype and (where it is dense) memory layout.  ``lse`` is the forward's
    log-sum-exp (``flash_attention(..., return_lse=True)``), f32 [B, H, S]:
    the ``"tc"`` route (:func:`bwd_route`) requires it, the ``"simt"``
    route recomputes it and ignores one given; on the CPU the plain version
    uses it when given.

    On a CUDA tensor ``(hd, hd_v)`` must lie in :data:`BWD_HEAD_PAIRS` and
    the last dimension of all five inputs must be contiguous (any other
    strides); blocks are :func:`plan_bwd_tc_blocks`' or :func:`plan_bwd_blocks`'.
    """
    _check(q, k, v, window, prefix)
    _check_grads(q, out, dout)
    softcap = runtime.check_softcap(softcap)
    b, h, s, hd = q.shape
    kv, t, hd_v = k.shape[1], k.shape[2], v.shape[3]
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    if runtime.on_cpu(q, k, v, out, dout):
        return flash_attention_bwd_plain(q, k, v, out, dout, scale, window, prefix, softcap,
                                         lse=lse)
    check_bwd_widths(hd, hd_v)
    if any(x.stride(-1) != 1 for x in (q, k, v, out, dout)):
        raise ValueError("the last dimension of q, k, v, out and dout must be contiguous")
    path = bwd_route(q, k, v, out, dout)
    if path == "tc":
        if lse is None:
            raise ValueError("the tensor-core backward reads the forward's log-sum-exp: pass "
                             "lse from flash_attention(..., return_lse=True)")
        dq, dk, dv, part, n_split = bwd_tc_launch(q, k, v, out, dout, lse, scale, window, prefix,
                                                  softcap)
        if n_split > 1:
            kv_reduce(part, dk, dv, n_split, scale)
    else:
        width = kernel_widths(hd, hd_v)[0]
        qk, kk = pad_heads(q, width), pad_heads(k, width)
        dq, dk, dv = torch.empty_like(qk), torch.empty_like(kk), torch.empty_like(v)
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        scratch = torch.empty_like(delta)  # prep's lse
        blk = plan_bwd_blocks(width, hd_v, q.element_size())
        strides = _strides(qk, kk, v, out, dout, dq, dk, dv)
        with torch.cuda.device(q.device):
            err = getattr(runtime.library("flash_attention_bwd"),
                          f"remop_flash_attention_bwd_{_DTYPES[q.dtype]}")(
                *_pointers(qk, kk, v, out, dout, dq, dk, dv), scratch.data_ptr(),
                delta.data_ptr(), ctypes.addressof(strides), b, h, kv, s, t, width, blk, blk,
                scale, hd_v, window, prefix, softcap, runtime.stream_of(q))
        runtime.check("flash_attention_bwd", "flash_attention_bwd", err)
        if width != hd:
            dq = torch.empty_like(q).copy_(dq[..., :hd])
            dk = torch.empty_like(k).copy_(dk[..., :hd])
    runtime.launches["flash_attention_bwd"] += 1
    runtime.launches[f"flash_attention_bwd_{path}"] += 1
    if window:
        runtime.launches["flash_attention_bwd_windowed"] += 1
    if prefix:
        runtime.launches["flash_attention_bwd_prefix"] += 1
    if prefix >= t:
        runtime.launches["flash_attention_bwd_full"] += 1
    return dq, dk, dv


def _strides(*xs: torch.Tensor):
    """The (batch, head, position) element strides of each tensor, as the
    C entries take them."""
    return (ctypes.c_longlong * (3 * len(xs)))(
        *(st for x in xs for st in (x.stride(0), x.stride(1), x.stride(2))))


def _pointers(*xs: torch.Tensor) -> tuple:
    return tuple(x.data_ptr() for x in xs)


def bwd_tc_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  dout: torch.Tensor, lse: torch.Tensor, scale: float, window: int = 0,
                  prefix: int = 0, softcap: float = 0.0, flush_steps: int | None = None):
    """The tensor-core route's two launches (``dq_tc``, then dkdv) on CUDA
    tensors the route takes, at :func:`plan_bwd_tc_blocks`' blocks and
    :func:`bwd_tc_kv_split`'s CTAs a key block (``kv_split``), each CTA
    flushing its sums every ``flush_steps`` query blocks (0 or a power of
    two; by default :func:`plan_bwd_flush_steps`'; held to
    :func:`check_bwd_runs`).  Returns
    ``(dq, dk, dv, part, kv_split)``: at ``kv_split`` 1 dk and dv are
    written (``part``, where the call flushes, is the scratch the flushes
    summed in, else None); above 1 dk and dv are empty and ``part``, f32
    ``[kv_split, B, KV, T, hd + hd_v]``, holds each CTA's unscaled dK then
    dV, for :func:`kv_reduce`.  Counts no launch: :func:`flash_attention_bwd`
    does."""
    _check_lse(q, lse)
    b, h, s, hd = q.shape
    kv, t, hd_v = k.shape[1], k.shape[2], v.shape[3]
    plan = plan_bwd_tc_blocks(hd, hd_v, softcap > 0)
    kv_split = bwd_tc_kv_split(b, h, kv, s, t, hd, hd_v, prefix)
    if flush_steps is None:
        flush_steps = plan_bwd_flush_steps(h // kv, s, plan["dkdv"][1], prefix)
    if flush_steps & (flush_steps - 1):
        raise ValueError(f"the kernels flush every power of two of steps, got {flush_steps}")
    check_bwd_runs(h // kv, s, plan["dkdv"][1], kv_split, flush_steps, prefix)
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    part = (torch.empty((kv_split, b, kv, t, hd + hd_v), dtype=torch.float32, device=q.device)
            if kv_split > 1 or flush_steps else None)
    strides = _strides(q, k, v, out, dout, dq, dk, dv)
    with torch.cuda.device(q.device):
        err = runtime.library("flash_attention_bwd").remop_flash_attention_bwd_tc(
            *_pointers(q, k, v, out, dout, dq, dk, dv), lse.data_ptr(), delta.data_ptr(),
            None if part is None else part.data_ptr(), ctypes.addressof(strides), b, h, kv, s,
            t, hd, hd_v, *plan["dq"], *plan["dkdv"], kv_split, scale, window, prefix, softcap,
            flush_steps, runtime.stream_of(q))
    runtime.check("flash_attention_bwd", "flash_attention_bwd", err)
    return dq, dk, dv, part, kv_split


def kv_reduce(part: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, kv_split: int,
              scale: float) -> None:
    """Write ``dk = scale * (part[0] + part[1] + ... + part[kv_split - 1])``
    and ``dv`` the same sum unscaled (``part``'s first ``hd`` columns are
    dK's), summed in that order (no atomics), each rounded once:
    :func:`bwd_tc_launch`'s partials into its dk and dv.  On the card one
    launch of ``kv_reduce_kernel``; on the CPU its plain version, the same
    f32 additions in the same order."""
    b, kv, t, hd = dk.shape
    hd_v = dv.shape[3]
    if part.shape[1:] != (b, kv, t, hd + hd_v) or not 1 <= kv_split <= part.shape[0]:
        raise ValueError(f"part {tuple(part.shape)} does not hold {kv_split} partials of dk "
                         f"{tuple(dk.shape)} and dv {tuple(dv.shape)}")
    if runtime.on_cpu(part, dk, dv):
        total = part[0].clone()
        for z in range(1, kv_split):
            total += part[z]
        dk.copy_(total[..., :hd] * scale)
        dv.copy_(total[..., hd:])
        return
    strides = (ctypes.c_longlong * 24)(*([0] * 18), *(st for x in (dk, dv)
                                                       for st in x.stride()[:3]))
    with torch.cuda.device(dk.device):
        err = runtime.library("flash_attention_bwd").remop_flash_attention_bwd_kv_reduce(
            part.data_ptr(), dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides), b, kv, t,
            hd, hd_v, kv_split, scale, runtime.stream_of(dk))
    runtime.check("flash_attention_bwd", "flash_attention_bwd", err)


def kv_split_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                            kv_split: int, scale: float | None = None, window: int = 0,
                            prefix: int = 0, softcap: float = 0.0, keys: int = 64,
                            rows: int = 64, flush_steps: int | None = None) -> torch.Tensor:
    """The partials the tensor-core dkdv writes with ``kv_split`` CTAs a key
    block, in PyTorch: per key block of ``keys`` keys its steps (head ``i //
    n_q`` of the GQA group, query block ``first + i % n_q`` of ``rows`` rows,
    over the query blocks that see the block), CTA z's part ``[steps z / n,
    steps (z + 1) / n)`` walked in :func:`dkdv_runs`' runs between flushes of
    ``flush_steps`` steps (by default :func:`plan_bwd_flush_steps`'), each
    run's f32 sums from 0 added into ``part[z]`` in order:
    CTA z's f32 dK (unscaled) and dV of the block's keys, f32 ``[kv_split, B,
    KV, T, hd + hd_v]`` (:func:`kv_reduce` sums them).  ``lse`` and ``delta``
    (``D = sum(dO * O)``) are f32 [B, H, S]."""
    b, h, s, hd = q.shape
    kv, t, hd_v = k.shape[1], k.shape[2], v.shape[3]
    g = h // kv
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    softcap = runtime.check_softcap(softcap)
    offset = t - s
    part = torch.zeros((kv_split, b, kv, t, hd + hd_v), device=q.device)
    qf, dof = q.float(), dout.float()
    if flush_steps is None:
        flush_steps = plan_bwd_flush_steps(g, s, rows, prefix)
    for k0 in range(0, t, keys):
        k_last = min(k0 + keys, t) - 1
        first = 0 if k0 < prefix else max(0, k0 - offset)
        last = min(s - 1, k_last + window - 1 - offset if window else s - 1)
        n_q = last // rows - first // rows + 1 if first <= last else 0
        steps = g * n_q
        kb, vb = k[:, :, k0:k_last + 1].float(), v[:, :, k0:k_last + 1].float()
        k_pos = torch.arange(k0, k_last + 1, device=q.device)
        for z, runs in enumerate(dkdv_runs(steps, kv_split, flush_steps)):
            for run in runs:
                acc = torch.zeros_like(part[z, :, :, k0:k_last + 1])
                for i in run:
                    head = torch.arange(kv, device=q.device) * g + i // n_q
                    q0 = (first // rows + i % n_q) * rows
                    qs, ds_ = qf[:, head, q0:q0 + rows], dof[:, head, q0:q0 + rows]
                    sc = runtime.cap_scores(torch.einsum("bksd,bktd->bkts", qs, kb) * scale,
                                            softcap)
                    q_pos = torch.arange(q0, q0 + qs.shape[2], device=q.device) + offset
                    hidden = hidden_keys(q_pos, k_pos, window, prefix).T
                    p = torch.exp(sc - lse[:, head, q0:q0 + rows][:, :, None]).masked_fill(
                        hidden, 0.0)
                    dp = torch.einsum("bktd,bksd->bkts", vb, ds_)
                    dst = p * (dp - delta[:, head, q0:q0 + rows][:, :, None])
                    if softcap:
                        dst = dst * cap_grad(sc, softcap)
                    acc[..., :hd] += torch.einsum("bkts,bksd->bktd", dst, qs)
                    acc[..., hd:] += torch.einsum("bkts,bksd->bktd", p, ds_)
                part[z, :, :, k0:k_last + 1] += acc
    return part


def bwd_attributes(dtype: torch.dtype, hd: int, hd_v: int) -> dict:
    """Registers, local (spilled) bytes a thread and the largest CTA of the
    ``prep``, ``dq`` and ``dkdv`` kernels at these widths (the instantiation
    :func:`kernel_widths` gives), on the current card."""
    check_bwd_widths(hd, hd_v)
    out = (ctypes.c_int * 9)()
    err = runtime.library("flash_attention_bwd").remop_flash_attention_bwd_attributes(
        int(dtype == torch.float32), *kernel_widths(hd, hd_v), ctypes.addressof(out))
    runtime.check("flash_attention_bwd", "flash_attention_bwd", err)
    return {kind: dict(zip(("registers", "local_bytes", "max_threads"), out[3 * i:3 * i + 3]))
            for i, kind in enumerate(BWD_KERNELS)}


def bwd_tc_attributes(hd: int, hd_v: int, capped: bool = False,
                      plan: dict | None = None, flush: bool = False) -> dict:
    """Per tensor-core kernel (``dq``, ``dkdv``) at ``plan``'s blocks (by
    default :func:`plan_bwd_tc_blocks`'), on the current card: CTAs one SM
    holds, registers and local (spilled) bytes a thread, dynamic shared
    memory and threads a CTA (``capped``: the instantiations with a cap;
    ``flush``: dkdv's flushing one)."""
    plan = plan or plan_bwd_tc_blocks(hd, hd_v, capped)
    for kernel in BWD_TC_KERNELS:
        check_bwd_tc_blocks(kernel, *plan[kernel], hd, hd_v)
    out = (ctypes.c_int * 10)()
    err = runtime.library("flash_attention_bwd").remop_flash_attention_bwd_tc_attributes(
        hd, hd_v, *plan["dq"], *plan["dkdv"], int(capped), int(flush), ctypes.addressof(out))
    runtime.check("flash_attention_bwd", "flash_attention_bwd", err)
    keys = ("resident_ctas", "registers", "local_bytes", "smem_bytes", "threads")
    return {kernel: {"blocks": list(plan[kernel]), **dict(zip(keys, out[5 * i:5 * i + 5]))}
            for i, kernel in enumerate(BWD_TC_KERNELS)}


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel under autograd: the forward wrapper (q, k, v, the
    output saved and, when the backward's route will be ``"tc"``, the
    forward's lse, which the forward then writes), its gradient
    :func:`flash_attention_bwd`.  The route is decided at forward time by
    :func:`bwd_route` with q standing in for the output (which takes q's
    layout) and for dO (the backward hands the kernel an aligned copy where
    it is not), so it is the route the backward then takes.  On a CUDA
    tensor a width the backward does not take raises before the forward
    runs."""

    @staticmethod
    def forward(ctx, q, k, v, bq: int, bk: int, scale: float | None, window: int, prefix: int,
                softcap: float):
        if not runtime.on_cpu(q, k, v):
            check_bwd_widths(q.shape[3], v.shape[3])
        scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
        ctx.path = bwd_route(q, k, v, q, q)
        res = flash_attention(q, k, v, bq=bq, bk=bk, scale=scale, window=window, prefix=prefix,
                              softcap=softcap, return_lse=ctx.path == "tc")
        out, lse = res if ctx.path == "tc" else (res, None)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, window, prefix, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        if ctx.path == "tc" and not _tma_aligned(dout):
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, *ctx.args, lse)
        return dq, dk, dv, None, None, None, None, None, None

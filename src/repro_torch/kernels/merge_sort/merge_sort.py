"""Blocked bitonic merge sort: the EMS analogue as CUDA kernels for Hopper.

Structure mirrors external merge sort (§III-B):
  * run formation: each block of ``block`` keys is sorted in-core by a
    bitonic network (:func:`sort_blocks`);
  * merge passes: adjacent sorted runs are merged pairwise by a bitonic merge
    ladder (:func:`merge_pass`) until one run remains.

The kernels (``csrc/merge_sort.cu``) replace the TPU kernels ``sort_blocks``
and ``merge_pass`` of the JAX package's ``kernels/merge_sort/merge_sort.py``
and run the same compare-exchange network stage for stage, so their output
is bit-identical to it, ties, signed zeros and NaNs included.  Beside each
wrapper is its plain PyTorch version: the same stages in ``reshape``/
``minimum``/``maximum``/``where``.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.  Keys are int32 or float32, values
int32.

The host plans the launches (:func:`plan`) and the kernel follows them.  A
launch runs a range of the network's stages on tiles of at most ``chunk``
elements, one tile a CTA.  A ``"chunk"`` tile is ``width`` contiguous
elements.  A ``"strided"`` tile is ``rows`` rows at stride ``rows * width``
by ``width`` contiguous columns, so that the stages at distances of a tile
and more run inside it.  A merge with ``2*run > chunk`` is two launches (two
passes over device memory): the strided launch runs stages ``top-1 ..
log2(tile)``, the chunk launch the rest in place.  Every other call is one
launch.  :func:`run_plan_plain` executes a plan tile by tile on any device,
so the CPU tests hold the tiles' index maps to the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import runtime

KEY_DTYPES = {torch.int32: "i32", torch.float32: "f32"}
# Largest tile the kernels hold in one CTA's shared memory: 2^14 keys plus
# 2^14 values is 128 KiB.  It is also the largest block sort_blocks takes.
MAX_BLOCK = 1 << 14
ROUTES = ("chunk", "strided")

Pair = Tuple[torch.Tensor, torch.Tensor]


class Launch(NamedTuple):
    """One kernel launch of a plan: one pass over device memory.

    The launch runs the ascending ladder's stages at distances ``2^j_hi ..
    2^j_lo`` or, with ``sort_log2 = m > 0``, the whole bitonic sort of blocks
    of ``2^m`` (``j_hi = m - 1``, ``j_lo = 0``).  ``reversed``: the second run
    of each pair of runs of ``2^j_hi`` is read reversed as the tile loads.
    """

    route: str
    j_hi: int
    j_lo: int
    rows: int
    width: int
    reversed: bool
    sort_log2: int = 0


def _log2(x: int) -> int:
    return x.bit_length() - 1


def chunk_for(n: int, unit: int, chunk: int = MAX_BLOCK) -> int:
    """Widest power-of-two tile, at most ``chunk``, made of whole ``unit``
    spans, that tiles ``n``."""
    tile = unit
    while tile < chunk and n % (2 * tile) == 0:
        tile *= 2
    return tile


def plan(n: int, kind: str, arg: int, chunk: int = MAX_BLOCK) -> List[Launch]:
    """The launches of one ``sort_blocks`` (``arg`` = block) or ``merge_pass``
    (``arg`` = run) call on ``n`` keys, with tiles of at most ``chunk``.

    A launch takes tiles of ``chunk // 2`` where its stages fit in them, else
    of ``chunk``.  A CTA of a 2^13 tile holds half the registers and shared
    memory of a 2^14 one, so two share an SM and one's loads and stores
    overlap the other's stages.  A strided tile holds at most ``chunk`` rows,
    so runs are at most ``chunk * chunk // 2`` (2^27 keys: n <= 2^28).
    """
    small = chunk // 2
    if kind == "sort_blocks":
        m = _log2(arg)
        size = chunk_for(n, arg, small if arg <= small else chunk)
        return [Launch("chunk", m - 1, 0, 1, size, False, m)]
    if kind != "merge_pass":
        raise ValueError(f"kind must be 'sort_blocks' or 'merge_pass', got {kind!r}")
    top = _log2(2 * arg)
    if 2 * arg <= chunk:
        size = chunk_for(n, 2 * arg, small if 2 * arg <= small else chunk)
        return [Launch("chunk", top - 1, 0, 1, size, True)]
    if top > 2 * _log2(chunk):
        raise ValueError(f"merges of two runs of {arg} need tiles wider than "
                         f"{chunk} rows of {chunk}; the widest run is {chunk * chunk // 2}")
    # Strided tiles: the stages at distances of a tile and more, on rows at
    # stride `size`; then the rest on aligned tiles, in place.
    size = small if top <= 2 * _log2(small) else chunk
    c = _log2(size)
    rows = 1 << (top - c)
    return [Launch("strided", top - 1, c, rows, size // rows, True),
            Launch("chunk", c - 1, 0, 1, size, False)]


def tile_maps(n: int, launch: Launch, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(load, store)``: the device index of every tile element, ``[tiles,
    rows * width]`` int64, tile-major.  Tile element ``t`` is row ``t //
    width``, column ``t % width``; ``load`` reads the second run reversed
    where the launch says so, ``store`` writes in place."""
    rows, width = launch.rows, launch.width
    size = rows * width
    t = torch.arange(size, device=device)
    tiles = torch.arange(n // size, device=device)[:, None]
    if launch.route == "chunk":
        store = tiles * size + t
        if not launch.reversed:
            return store, store
        run = 1 << launch.j_hi
        q = t & (2 * run - 1)
        load = tiles * size + torch.where(q < run, t, t - q + 3 * run - 1 - q)
        return load, store
    # Strided: rows at stride `size`; the tiles of one span of rows * size
    # elements are its column blocks.
    r, c = t // width, t % width
    span, c0 = tiles // rows * rows * size, tiles % rows * width
    store = span + r * size + c0 + c
    if not launch.reversed:
        return store, store
    flipped = span + (3 * rows // 2 - 1 - r) * size + size - 1 - c0 - c
    return torch.where(r >= rows // 2, flipped, store), store


def tile_bit(launch: Launch, j: int) -> int:
    """The tile index bit of the network's distance bit ``j``."""
    return j - _log2(launch.rows) if launch.route == "strided" else j


def run_plan_plain(keys: torch.Tensor, values: torch.Tensor,
                   launches: List[Launch]) -> Pair:
    """Execute a plan tile by tile, as the kernel does (plain PyTorch, any
    device): gather each tile by its load map, run the stages in tile
    coordinates, scatter it back by its store map."""
    n = keys.shape[0]
    for launch in launches:
        load, store = tile_maps(n, launch, keys.device)
        k, v = keys[load], values[load]
        m = launch.sort_log2
        if m:
            for stage in range(1, m + 1):
                for j in range(stage - 1, -1, -1):
                    k, v = _cmp_exchange(k, v, j, _sort_dirs(k.shape[1], stage, j, m, k.device))
        else:
            for j in range(launch.j_hi, launch.j_lo - 1, -1):
                k, v = _cmp_exchange(k, v, tile_bit(launch, j), None)
        keys, values = torch.empty_like(keys), torch.empty_like(values)
        keys[store.reshape(-1)] = k.reshape(-1)
        values[store.reshape(-1)] = v.reshape(-1)
    return keys, values


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _cmp_exchange(keys: torch.Tensor, values: torch.Tensor, j: int,
                  dirs: Optional[torch.Tensor]) -> Pair:
    """One compare-exchange stage at distance 2^j on a batch of vectors.

    ``keys``/``values`` are ``[batch, n]``; ``dirs`` holds one direction per
    group of 2^(j+1) (True = descending), or ``None`` for all ascending.
    Keys go to ``jnp.minimum``/``jnp.maximum`` as the JAX package takes them,
    bit for bit: -0.0 < +0.0 (``torch.minimum`` returns its first argument
    there), and a NaN spreads to both keys with its bits (``torch.minimum``
    makes every NaN canonical).  Of two NaNs, ``min`` is the first and
    ``max`` the second, swapped when the first has its sign bit set.  Values
    follow ``take_lo_first = first <= second``.
    """
    b, n = keys.shape
    d = 1 << j
    g = n // (2 * d)
    kr = keys.reshape(b, g, 2, d)
    vr = values.reshape(b, g, 2, d)
    first, second = kr[:, :, 0], kr[:, :, 1]
    lo = torch.minimum(first, second)
    hi = torch.maximum(first, second)
    if keys.dtype.is_floating_point:
        # Equal keys differ in bits only as signed zeros: min takes the sign.
        eq = first == second
        b0, b1 = first.view(torch.int32), second.view(torch.int32)
        lo = torch.where(eq, (b0 | b1).view(keys.dtype), lo)
        hi = torch.where(eq, (b0 & b1).view(keys.dtype), hi)
        n0, n1 = torch.isnan(first), torch.isnan(second)
        nan, neg0 = n0 | n1, b0 < 0
        lo = torch.where(nan, torch.where(n1 & (~n0 | neg0), second, first), lo)
        hi = torch.where(nan, torch.where(n0 & (~n1 | neg0), first, second), hi)
    take_lo_first = first <= second  # first already holds lo
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


def _sort_dirs(n: int, stage: int, j: int, m: int, device) -> Optional[torch.Tensor]:
    """Directions of stage (``stage``, ``j``) of the sort of blocks of 2^m
    laid end to end in vectors of ``n``: bit ``stage`` of the index below the
    last stage (``_bitonic_sort``'s ``(group >> (k-1-j)) & 1``), ascending at
    ``stage == m``."""
    if stage == m:
        return None
    return ((torch.arange(n >> (j + 1), device=device) >> (stage - 1 - j)) & 1).bool()


def sort_blocks_plain(keys: torch.Tensor, values: torch.Tensor, block: int) -> Pair:
    """Ascending bitonic sort of each ``block``-length run (plain PyTorch)."""
    n = keys.shape[0]
    k = keys.reshape(n // block, block)
    v = values.reshape(n // block, block)
    m = _log2(block)
    for stage in range(1, m + 1):
        for j in range(stage - 1, -1, -1):
            k, v = _cmp_exchange(k, v, j, _sort_dirs(block, stage, j, m, keys.device))
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


PLAN_FIELDS = 7  # int32s a launch takes in the C entry's plan array


def plan_array(launches: List[Launch]) -> ctypes.Array:
    """The plan as the C entry reads it: per launch (route index, j_hi, j_lo,
    rows, width, reversed, sort_log2) as int32."""
    flat = [x for launch in launches
            for x in (ROUTES.index(launch.route), launch.j_hi, launch.j_lo, launch.rows,
                      launch.width, int(launch.reversed), launch.sort_log2)]
    return (ctypes.c_int * len(flat))(*flat)


def _launch(kernel: str, keys: torch.Tensor, values: torch.Tensor, arg: int) -> Pair:
    runtime.refuse_grad(kernel, "a gradient through the sort", keys, values)
    launches = plan(keys.shape[0], kernel, arg)
    keys_out = torch.empty_like(keys)
    values_out = torch.empty_like(values)
    lib = runtime.library("merge_sort")
    fn = getattr(lib, f"remop_{kernel}_{KEY_DTYPES[keys.dtype]}")
    array = plan_array(launches)
    with torch.cuda.device(keys.device):
        err = fn(keys.data_ptr(), values.data_ptr(), keys_out.data_ptr(),
                 values_out.data_ptr(), keys.shape[0], ctypes.addressof(array),
                 len(launches), runtime.stream_of(keys))
    runtime.check(kernel, "merge_sort", err)
    runtime.launches[kernel] += 1
    return keys_out, values_out


def attributes(dtype: torch.dtype) -> dict:
    """Registers, local (spilled) bytes and dynamic shared memory of the tile
    kernel at a 2^14 tile, and its CTAs resident on one SM at tiles of 2^14
    and of 2^13, on the current card."""
    out = (ctypes.c_int * 5)()
    err = runtime.library("merge_sort").remop_merge_sort_attributes(
        int(dtype == torch.float32), ctypes.addressof(out))
    runtime.check("merge_sort", "merge_sort", err)
    return dict(zip(("registers", "local_bytes", "smem_bytes", "resident_ctas",
                     "resident_ctas_half_tile"), out))


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
    """One pairwise merge pass: adjacent runs of length ``run`` -> ``2*run``.

    On the card ``run`` is at most 2^27 (``plan``'s strided tiles), so a
    merge covers at most 2^28 keys.
    """
    n = _check_pair(keys, values)
    if run < 1 or run & (run - 1) or n % (2 * run):
        raise ValueError(f"run must be a power of two with 2*run dividing {n}, got {run}")
    if runtime.on_cpu(keys, values):
        return merge_pass_plain(keys, values, run)
    return _launch("merge_pass", keys, values, run)

"""Build, load and launch the CUDA kernels; resolve devices; count launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into ``_build/``
beside this file (listed in ``.gitignore``).  A library's file name carries a
hash of its source, the headers in ``csrc/`` and the compiler flags, so an
edited source or header rebuilds and an unchanged one is loaded as it is.
:func:`build` compiles every missing library at once, one ``nvcc`` process
per source, all started together.

The libraries are loaded with ``ctypes``: every pointer and the stream pass
as ``c_void_p``, and every entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

Where a kernel runs is decided by the device of the tensors it is given: a
CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor launches
the kernel or raises.  :data:`launches` counts the launches per kernel.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Union

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("merge_sort", "gather_rows", "flash_attention", "flash_attention_bwd",
           "paged_attention", "ssd_scan", "matmul")
# ptxas splits its work over 8 threads: the same machine code, built in
# less time (the attention libraries' ptxas was most of their build).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "--split-compile=8",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# C signature of every entry point, per library: (argtypes, restype).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "merge_sort": {
        # keys, values, keys_out, values_out, n, &plan[launches * 7] (int32), launches, stream
        **{f"remop_{op}_{t}": ([_P, _P, _P, _P, _I64, _P, _I32, _P], _I32)
           for op in ("sort_blocks", "merge_pass") for t in ("i32", "f32")},
        # is_f32, &out[5]
        "remop_merge_sort_attributes": ([_I32, _P], _I32),
        "remop_merge_sort_error_string": ([_I32], ctypes.c_char_p),
    },
    "gather_rows": {
        # x, idx, out, n, row_bytes, route, unit, lanes, stream
        "remop_gather_rows": ([_P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P], _I32),
        # route, unit, &out[3]
        "remop_gather_rows_attributes": ([_I32, _I32, _P], _I32),
        "remop_gather_rows_error_string": ([_I32], ctypes.c_char_p),
    },
    "flash_attention": {
        # q, k, v, out, &strides[12] (int64), b, h, kv, s, t, hd, bq, bk, scale, hd_v,
        # window, prefix, softcap, stream
        **{f"remop_flash_attention_{t}": ([_P] * 5 + [_I32] * 8 + [_F32] + [_I32] * 3
                                          + [_F32, _P], _I32)
           for t in ("bf16", "f32")},
        # q, k, v, out, &strides[12], b, h, kv, s, t, hd, bq, bk, scale, split, hd_v,
        # window, prefix, softcap, stream
        "remop_flash_attention_tc": ([_P] * 5 + [_I32] * 8 + [_F32] + [_I32] * 4 + [_F32, _P],
                                     _I32),
        # the same, with lse (f32 [B, H, S]) before the stream
        "remop_flash_attention_tc_lse": ([_P] * 5 + [_I32] * 8 + [_F32] + [_I32] * 4
                                         + [_F32, _P, _P], _I32),
        # hd, hd_v, bq, bk, split, cap, &out[5]
        "remop_flash_attention_tc_occupancy": ([_I32] * 6 + [_P], _I32),
        "remop_flash_attention_error_string": ([_I32], ctypes.c_char_p),
    },
    "flash_attention_bwd": {
        # q, k, v, o, do, dq, dk, dv, lse, delta, &strides[24] (int64), b, h, kv, s, t, hd,
        # bq, bk, scale, hd_v, window, prefix, softcap, stream
        **{f"remop_flash_attention_bwd_{t}": ([_P] * 11 + [_I32] * 8 + [_F32] + [_I32] * 3
                                              + [_F32, _P], _I32)
           for t in ("bf16", "f32")},
        # is_f32, hd, hd_v, &out[9]
        "remop_flash_attention_bwd_attributes": ([_I32] * 3 + [_P], _I32),
        # q, k, v, o, do, dq, dk, dv, lse, delta, part, &strides[24], b, h, kv, s, t, hd,
        # hd_v, dq_bq, dq_bk, kv_bk, kv_bq, kv_split, scale, window, prefix, softcap,
        # flush_steps, stream
        "remop_flash_attention_bwd_tc": ([_P] * 12 + [_I32] * 12 + [_F32] + [_I32] * 2
                                         + [_F32, _I32, _P], _I32),
        # part, dk, dv, &strides[24], b, kv, t, hd, hd_v, kv_split, scale, stream
        "remop_flash_attention_bwd_kv_reduce": ([_P] * 4 + [_I32] * 6 + [_F32, _P], _I32),
        # hd, hd_v, dq_bq, dq_bk, kv_bk, kv_bq, cap, flush, &out[10]
        "remop_flash_attention_bwd_tc_attributes": ([_I32] * 8 + [_P], _I32),
        "remop_flash_attention_bwd_error_string": ([_I32], ctypes.c_char_p),
    },
    "paged_attention": {
        # q, k_cache, v_cache, lengths, out, scratch, b, kv, g, s, hd, splits, gc,
        # scale, softcap, stream
        **{f"remop_paged_attention_{t}": ([_P] * 6 + [_I32] * 7 + [_F32, _F32, _P], _I32)
           for t in ("bf16", "f32")},
        # q, k_q, v_q, k_scale, v_scale, lengths, out, scratch, b, kv, g, s, hd, splits, gc,
        # scale, softcap, stream
        "remop_paged_attention_int8_bf16": ([_P] * 8 + [_I32] * 7 + [_F32, _F32, _P], _I32),
        # route (0 bf16, 1 f32, 2 int8), hd, gc, &out[6]
        "remop_paged_attention_attributes": ([_I32] * 3 + [_P], _I32),
        # q, latent, lengths, out, scratch, b, h, s, splits, gc, min_chunk, scale, stream
        **{f"remop_latent_decode_{t}": ([_P] * 5 + [_I32] * 6 + [_F32, _P], _I32)
           for t in ("bf16", "f32")},
        # is_f32, gc, &out[6]
        "remop_latent_decode_attributes": ([_I32] * 2 + [_P], _I32),
        "remop_paged_attention_error_string": ([_I32], ctypes.c_char_p),
    },
    "ssd_scan": {
        # states, decays, prev, final, b, nc, h, p * n, stream
        **{f"remop_ssd_scan_{t}": ([_P] * 4 + [_I32] * 3 + [_I64, _P], _I32)
           for t in ("bf16", "f32")},
        # dprev, dfinal, prev, decays, dstates, ddecays, partial, b, nc, h, p * n, parts, stream
        **{f"remop_ssd_scan_bwd_{t}": ([_P] * 7 + [_I32] * 3 + [_I64, _I32, _P], _I32)
           for t in ("bf16", "f32")},
        "remop_ssd_scan_error_string": ([_I32], ctypes.c_char_p),
    },
    "matmul": {
        # a, b, c, m, n, k, lda, ldb, bm, bn, bk, sub, out_f32, route (tma / wide), stream
        **{f"remop_matmul_{t}": ([_P] * 3 + [_I64] * 5 + [_I32] * 6 + [_P], _I32)
           for t in ("bf16", "f32")},
        # bm, bn, bk, sub, route, &out[5]
        **{f"remop_matmul_occupancy_{t}": ([_I32] * 5 + [_P], _I32)
           for t in ("bf16", "f32")},
        "remop_matmul_error_string": ([_I32], ctypes.c_char_p),
    },
}

# Launches per kernel since the last reset_launches(): a wrapper adds one
# where it launches its kernel, and nowhere else.
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` is ``cuda:0``; only an explicit ``"cpu"`` runs on the CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is False.
    """
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "kernels' plain versions on the CPU"
        )
    return dev if dev.index is not None else torch.device("cuda", 0)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on the CPU, False on one CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record a call on ``tensors``: grad is
    enabled and one of them requires it."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, later: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when a launch of the kernel ``name``
    would be recorded by autograd (:func:`needs_grad`): the kernel has no
    backward yet, so its output would carry no gradient.  ``later`` names
    the slice that brings it.  The kernels' CUDA branches call it; their
    plain versions on the CPU are differentiable."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel yet, so a CUDA call under grad would return an "
            f"output without a gradient; {later} waits for a later slice (ROADMAP queue 1)")


def check_softcap(softcap: float) -> float:
    """``softcap`` as a float; raise ``ValueError`` unless it is 0 (no cap)
    or positive and finite.  The attention kernels' shared argument."""
    softcap = float(softcap)
    if not (softcap == 0.0 or 0.0 < softcap < math.inf):
        raise ValueError(f"softcap={softcap} must be 0 (no cap) or positive and finite")
    return softcap


def cap_scores(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    """``tanh(s / softcap) * softcap``, or the scores as they are at 0: the
    attention kernels' plain versions cap with it."""
    return torch.tanh(scores / softcap) * softcap if softcap else scores


def nvcc() -> str:
    """The CUDA toolkit's compiler: ``$CUDA_HOME/bin/nvcc``, by default under
    ``/usr/local/cuda``."""
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """``_build/lib<name>-<hash>.so``: the hash covers ``csrc/<name>.cu``,
    every header ``csrc/*.cuh`` (any source may include one) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns the names it compiled (libraries already built are skipped).
    Raises ``RuntimeError`` with the compiler's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return list(procs)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check(name: str, lib: str, err: int) -> None:
    """Raise if a kernel's entry point returned a CUDA error."""
    if err != 0:
        what = getattr(library(lib), f"remop_{lib}_error_string")(err)
        raise RuntimeError(f"{name}: CUDA error {err}: {what.decode()}")


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream

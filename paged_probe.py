#!/usr/bin/env python3
"""Quick card check of the paged-attention (decode) kernel after an edit.

Run from the root of a checkout on a machine with one H100:

    python3 paged_probe.py [LOG_DIR]

It compiles ``csrc/paged_attention.cu`` with ``-Xptxas -v`` (the full log
goes to LOG_DIR, by default the gitignored ``src/repro_torch/kernels/_build``)
and prints each kernel's registers and spills; then holds the kernel to
``paged_attention_plain`` (at the kernel's own plan) under
``chip_smoke.ATTN_TOL`` at every head width in bf16 and f32, at gemma-2b's
and granite-20b's decode shapes, at lengths 1, S, mid-chunk and ragged, at
G past one CTA's group and at S that is no multiple of 16; the latent route
(MLA's decode, 576 / 512, 16 heads) to ``latent_decode_plain`` in bf16 and
f32 at S 64 to 4096 with lengths below S and a NaN tail past them; checks
that two calls give the same bits; with a softcap (cap 5 on q scaled by 8) at
every head width in bf16 and f32, each shown to differ from the uncapped
call; the int8 route against the bf16 route on the dequantized caches, bit
for bit, at every head width, gemma-2b's, granite-moe's and
recurrentgemma's decode shapes, with and without a cap; prints the
kernels' device time at gemma-2b's and
granite-20b's decode shapes from a profiler window, and the cycles each
phase of one CTA takes there, from ``clock64()`` stamps in a copy of the
source built beside the log.  ``chip_smoke.py`` is the full check.  Exits 1
if any check fails.
"""

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def ptxas_report(log_dir: Path) -> None:
    from repro_torch.kernels import runtime

    t0 = time.time()
    r = subprocess.run([runtime.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-c", "-Xptxas", "-v", "-o",
                        str(log_dir / "paged_attention.o"),
                        str(runtime.CSRC / "paged_attention.cu")],
                       capture_output=True, text=True)
    log = r.stdout + r.stderr
    (log_dir / "ptxas_paged_attention.txt").write_text(log)
    print("paged_attention rc", r.returncode, "secs", time.time() - t0, flush=True)
    if r.returncode:
        print(log[-8000:])
        sys.exit(1)
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            info = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            print(name[:90], "|", " ; ".join(info)[:220])
        elif "warning" in line.lower():
            print(line[:300])


# The split kernel's phases: (name, a line of csrc/paged_attention.cu, whether
# the stamp goes after it).  A stamp records clock64() in thread 0 of one CTA.
PHASES = (
    ("start", "  const int split = blockIdx.x, b = blockIdx.z;", True),
    ("q copies issued, lengths read", "  if (lo >= hi) {  // empty chunk", False),
    ("K/V copies issued", "  issue(lo, 0);", True),
    ("q widened (bf16)", "  // p @ v accumulators: thread", False),
    ("copies waited for",
     "    __syncthreads();  // this tile's rows (and, at the first, q_s, m_s, l_s) are in", True),
    ("scores", "    // The online softmax: warp w takes", False),
    ("softmax", "    // p @ v over the tile's valid rows", False),
    ("p @ v",
     "    __syncthreads();  // the stage, p_s and c_s are rewritten by later tiles", True),
    ("acc stored",
     "  for (int hh = tid; hh < gn; hh += kThreads) {\n    float* dst = part_ml", False),
)


def phase_cycles(log_dir: Path, dev, shapes) -> None:
    """Builds a copy of the kernel with a clock64() stamp at each of PHASES in
    CTA 5 (a live chunk at the probe's length) and prints the cycles between
    stamps at each (G, hd) of ``shapes`` (bf16, S 4096, length 2048), then
    on the latent route (16 heads, 576 / 512: CTA 5 walks 4 tiles there, so
    its per-tile phases are the last tile's)."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.paged_attention import paged_attention as pa

    src = (runtime.CSRC / "paged_attention.cu").read_text()
    src = src.replace('#include "hopper.cuh"\n', '#include "hopper.cuh"\n\n'
                      "__device__ long long g_stamps[16];\n", 1)
    for i, (_, anchor, after) in enumerate(PHASES):
        assert src.count(anchor) == 1, f"stamp anchor not found once: {anchor!r}"
        stamp = f"\nif (threadIdx.x == 0 && blockIdx.x == 5) g_stamps[{i}] = clock64();\n"
        src = src.replace(anchor, anchor + stamp if after else stamp + anchor)
    src += ('extern "C" int read_stamps(long long* out) {\n'
            "  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n}\n")
    (log_dir / "paged_stamped.cu").write_text(src)
    lib_path = log_dir / "libpaged_stamped.so"
    subprocess.run([runtime.nvcc(), *runtime.NVCC_FLAGS, "-I", str(runtime.CSRC), "-o",
                    str(lib_path), str(log_dir / "paged_stamped.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in runtime.SIGNATURES["paged_attention"].items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    stamps = (ctypes.c_longlong * 16)()
    for g, hd in shapes:
        q = torch.randn(1, 1, g, hd, device=dev, generator=gen).to(torch.bfloat16)
        kc, vc = (torch.randn(1, 4096, 1, hd, device=dev, generator=gen).to(torch.bfloat16)
                  for _ in range(2))
        ln = torch.tensor([2048], dtype=torch.int32, device=dev)
        splits, gc = pa.plan(1, 1, g, 4096)
        out = torch.empty_like(q)
        scratch = torch.empty(pa.scratch_floats(1, 1, g, hd, splits), device=dev)
        for _ in range(10):  # the stamps of the last call stay
            err = lib.remop_paged_attention_bf16(
                q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ln.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), 1, 1, g, 4096, hd, splits, gc, hd ** -0.5, 0.0,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        torch.cuda.synchronize()
        assert lib.read_stamps(stamps) == 0
        print(f"cycles G {g} hd {hd}:", ", ".join(
            f"{PHASES[i][0]} {stamps[i] - stamps[i - 1]}" for i in range(1, len(PHASES))),
            f"| total {stamps[len(PHASES) - 1] - stamps[0]}", flush=True)
    q = torch.randn(1, 16, 576, device=dev, generator=gen).to(torch.bfloat16)
    latent = torch.randn(1, 4096, 576, device=dev, generator=gen).to(torch.bfloat16)
    ln = torch.tensor([2048], dtype=torch.int32, device=dev)
    splits, gc = pa.latent_plan(1, 16, 4096)
    out = torch.empty(1, 16, 512, dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(pa.scratch_floats(1, 1, 16, 512, splits), device=dev)
    for _ in range(10):
        err = lib.remop_latent_decode_bf16(
            q.data_ptr(), latent.data_ptr(), ln.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            1, 16, 4096, splits, gc, pa.LATENT_MIN_CHUNK, 192 ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
    torch.cuda.synchronize()
    assert lib.read_stamps(stamps) == 0
    print("cycles latent H 16, 4 tiles:", ", ".join(
        f"{PHASES[i][0]} {stamps[i] - stamps[i - 1]}" for i in range(1, len(PHASES))),
        f"| total {stamps[len(PHASES) - 1] - stamps[0]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("paged_probe.py: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import runtime
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models import attention as attn

    log_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else runtime.BUILD_DIR
    log_dir.mkdir(parents=True, exist_ok=True)
    ptxas_report(log_dir)
    print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
    runtime.build(["paged_attention"])
    chip_smoke.load_peaks()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    failed = []

    def case(b, kv, g, hd, s, lengths, dtype):
        name = f"b{b} kv{kv} g{g} hd{hd} s{s} {str(dtype)[6:]} len {lengths}"
        q = torch.randn(b, kv, g, hd, device=dev, generator=gen).to(dtype)
        kc = torch.randn(b, s, kv, hd, device=dev, generator=gen).to(dtype)
        vc = torch.randn(b, s, kv, hd, device=dev, generator=gen).to(dtype)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        runtime.reset_launches()
        try:
            got = pa.paged_attention(q, kc, vc, ln)
            again = pa.paged_attention(q, kc, vc, ln)
            torch.cuda.synchronize()
        except Exception as e:  # report and go on to the next case
            print(name, "RAISED", repr(e)[:300], flush=True)
            failed.append(name)
            return
        want = pa.paged_attention_plain(q, kc, vc, ln)
        ok, err, rel, _ = chip_smoke.attn_close(torch, got, want)
        same = torch.equal(got, again)
        finite = bool(torch.isfinite(got.float()).all())
        print(name, pa.plan(b, kv, g, s), dict(runtime.launches),
              f"ok {ok} same {same} finite {finite} maxabs {err:.3e} rel {rel:.3e}", flush=True)
        if not (ok and same and finite):
            failed.append(name)

    for dtype in (torch.bfloat16, torch.float32):
        for hd in pa.HEAD_DIMS:
            case(2, 2, 4, hd, 777, (777, 33), dtype)
    bf = torch.bfloat16
    for ln in (2077, 1, 4096, 4095, 33, 2049, 2048, 16, 17):
        case(1, 1, 8, 256, 4096, (ln,), bf)
    for ln in (2077, 4096, 1, 2049):
        case(1, 1, 48, 128, 4096, (ln,), bf)
    case(4, 8, 2, 128, 4096, (1, 1000, 2049, 4096), torch.float32)
    case(1, 1, 64, 256, 1000, (999,), torch.float32)   # the widest CTA
    case(2, 1, 100, 64, 300, (300, 7), bf)            # G past one group
    case(3, 2, 1, 16, 1, (1, 1, 1), bf)                # S = 1
    case(1, 3, 5, 32, 50, (50,), torch.float32)        # S no multiple of 16

    def capped_case(b, kv, g, hd, s, lengths, dtype):
        name = f"softcap 5 b{b} kv{kv} g{g} hd{hd} s{s} {str(dtype)[6:]} len {lengths}"
        q = torch.randn(b, kv, g, hd, device=dev, generator=gen).to(dtype) * 8
        kc, vc = (torch.randn(b, s, kv, hd, device=dev, generator=gen).to(dtype)
                  for _ in range(2))
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        runtime.reset_launches()
        try:
            got = pa.paged_attention(q, kc, vc, ln, softcap=5.0)
            torch.cuda.synchronize()
        except Exception as e:  # report and go on to the next case
            print(name, "RAISED", repr(e)[:300], flush=True)
            failed.append(name)
            return
        ok, err, rel, _ = chip_smoke.attn_close(
            torch, got, pa.paged_attention_plain(q, kc, vc, ln, softcap=5.0))
        bites = not chip_smoke.attn_close(torch, got, pa.paged_attention_plain(q, kc, vc, ln))[0]
        print(name, dict(runtime.launches), f"ok {ok} bites {bites} maxabs {err:.3e} "
              f"rel {rel:.3e}", flush=True)
        if not (ok and bites):
            failed.append(name)

    def int8_case(b, kv, g, hd, s, lengths, softcap):
        name = f"int8 b{b} kv{kv} g{g} hd{hd} s{s} len {lengths} softcap {softcap}"
        q = torch.randn(b, kv, g, hd, device=dev, generator=gen).to(bf) * (8 if softcap else 1)
        k_q, v_q = (torch.randint(-127, 128, (b, s, kv, hd), device=dev, generator=gen,
                                  dtype=torch.int8) for _ in range(2))
        k_s, v_s = (torch.rand(b, s, kv, 1, device=dev, generator=gen).mul(0.02).to(bf)
                    for _ in range(2))
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        runtime.reset_launches()
        try:
            got = pa.paged_attention_int8(q, k_q, v_q, k_s, v_s, ln, softcap=softcap)
            torch.cuda.synchronize()
        except Exception as e:  # report and go on to the next case
            print(name, "RAISED", repr(e)[:300], flush=True)
            failed.append(name)
            return
        launches = dict(runtime.launches)
        want = pa.paged_attention(q, attn.dequantize_kv(k_q, k_s),
                                  attn.dequantize_kv(v_q, v_s), ln, softcap=softcap)
        same = torch.equal(got, want)
        print(name, launches, f"bit-equal to the bf16 route {same}", flush=True)
        if not same:
            failed.append(name)

    for dtype in (torch.bfloat16, torch.float32):
        for hd in pa.HEAD_DIMS:
            capped_case(2, 2, 4, hd, 777, (777, 33), dtype)
    for softcap in (0.0, 5.0):
        for hd in pa.HEAD_DIMS:
            int8_case(2, 2, 4, hd, 777, (777, 33), softcap)
        int8_case(1, 1, 8, 256, 4096, (2077,), softcap)  # gemma-2b
        int8_case(1, 8, 3, 64, 4096, (1000,), softcap)   # granite-moe
        int8_case(1, 8, 1, 64, 4096, (4096,), softcap)   # G 1
        int8_case(1, 1, 10, 256, 2048, (2048,), softcap)  # recurrentgemma's ring
        int8_case(1, 1, 64, 128, 300, (299,), softcap)   # the widest CTA

    def latent_case(s, lengths, dtype, h=16):
        name = f"latent h{h} s{s} {str(dtype)[6:]} len {lengths}"
        q = torch.randn(len(lengths), h, 576, device=dev, generator=gen).to(dtype)
        latent = torch.randn(len(lengths), s, 576, device=dev, generator=gen).to(dtype)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        nan, clean = chip_smoke.with_nan_tail(torch, latent, ln)
        runtime.reset_launches()
        try:
            got = pa.latent_decode(q, nan, ln, 192 ** -0.5)
            again = pa.latent_decode(q, clean, ln, 192 ** -0.5)
            torch.cuda.synchronize()
        except Exception as e:  # report and go on to the next case
            print(name, "RAISED", repr(e)[:300], flush=True)
            failed.append(name)
            return
        want = pa.latent_decode_plain(q, clean, ln, 192 ** -0.5)
        ok, err, rel, _ = chip_smoke.attn_close(torch, got, want)
        same = torch.equal(got, again)
        finite = bool(torch.isfinite(got.float()).all())
        print(name, pa.latent_plan(len(lengths), h, s), dict(runtime.launches),
              f"ok {ok} same {same} finite {finite} maxabs {err:.3e} rel {rel:.3e}", flush=True)
        if not (ok and same and finite):
            failed.append(name)

    for dtype in (torch.bfloat16, torch.float32):
        for s, lengths in ((64, (50, 1)), (2048, (2047, 1000)), (4096, (4095, 2077)),
                           (4096, (1, 128, 129, 4096)), (300, (300, 17))):
            latent_case(s, lengths, dtype)
    latent_case(777, (777, 5), bf, h=8)
    latent_case(777, (700,), bf, h=40)  # heads past one CTA's 16

    for dtype in (torch.bfloat16, torch.float32):
        for hd in pa.HEAD_DIMS:
            for gc in (8, 48, 64):
                print("attributes", str(dtype)[6:], hd, gc, pa.attributes(dtype, hd, gc),
                      flush=True)
        print("latent attributes", str(dtype)[6:], 16, pa.latent_attributes(dtype, 16),
              flush=True)
    for hd in pa.HEAD_DIMS:
        for gc in (8, 48, 64):
            print("attributes int8", hd, gc, pa.attributes(torch.int8, hd, gc), flush=True)

    # Device time at gemma-2b's and granite-20b's decode shapes, warm L2 (no
    # flush): a first look.
    from torch.profiler import ProfilerActivity, profile
    for g, hd in ((8, 256), (48, 128)):
        q = torch.randn(1, 1, g, hd, device=dev, generator=gen).to(bf)
        kc, vc = (torch.randn(1, 4096, 1, hd, device=dev, generator=gen).to(bf)
                  for _ in range(2))
        ln = torch.tensor([2048], dtype=torch.int32, device=dev)
        for _ in range(5):
            pa.paged_attention(q, kc, vc, ln)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                pa.paged_attention(q, kc, vc, ln)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "paged_attention_kernel" in e.key:
                print("device G", g, "hd", hd, e.key[:80], "count", e.count, "us/call",
                      e.self_device_time_total / e.count, flush=True)
    # The latent route at deepseek's decode (length 2048 of 4096), per kernel.
    q = torch.randn(1, 16, 576, device=dev, generator=gen).to(bf)
    latent = torch.randn(1, 4096, 576, device=dev, generator=gen).to(bf)
    ln = torch.tensor([2048], dtype=torch.int32, device=dev)
    for _ in range(5):
        pa.latent_decode(q, latent, ln, 192 ** -0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            pa.latent_decode(q, latent, ln, 192 ** -0.5)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "paged_attention_kernel" in e.key:
            print("device latent", e.key[:80], "count", e.count, "us/call",
                  e.self_device_time_total / e.count, flush=True)
    phase_cycles(log_dir, dev, ((8, 256), (48, 128)))
    print("FAILED" if failed else "ALL OK", failed, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

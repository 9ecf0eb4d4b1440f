#!/usr/bin/env python3
"""Quick card check of the matmul and paged-attention kernels after an edit.

Run from the root of a checkout on a machine with one H100:

    python3 matmul_probe.py [LOG_DIR]

It compiles ``csrc/matmul.cu`` and ``csrc/paged_attention.cu`` with
``-Xptxas -v`` (the full logs go to LOG_DIR, by default the gitignored
``src/repro_torch/kernels/_build``) and prints each kernel's registers and
spills; builds every kernel; holds the bf16 matmul on its TMA and element
routes, the f32 matmul and the paged kernel at wide query groups against
their plain versions at small shapes (relative L2 error, max abs error and
the share of elements off by more than 1e-2 + 1e-2 |want|, with that share
by row mod 8 and column mod 64 when it is not 0); prints the occupancy of
three tiles; and times the bf16 kernel at gemma-7b's FFN up product,
[4096, 3072] @ [3072, 24576], under five tilings (3 launches after 1
warm-up, L2 not flushed).  ``chip_smoke.py`` is the full check.
"""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def ptxas_report(log_dir: Path) -> None:
    from repro_torch.kernels import runtime

    t0 = time.time()
    for src in ("matmul", "paged_attention"):
        r = subprocess.run([runtime.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-c", "-Xptxas", "-v", "-o",
                            str(log_dir / f"{src}.o"), str(runtime.CSRC / f"{src}.cu")],
                           capture_output=True, text=True)
        (log_dir / f"ptxas_{src}.txt").write_text(r.stdout + r.stderr)
        print(src, "rc", r.returncode, "secs", time.time() - t0, flush=True)
        if r.returncode:
            print((r.stdout + r.stderr)[-6000:])
            sys.exit(1)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                info = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
                print(name[:60], "|", " ; ".join(info)[:200])


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("matmul_probe.py: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime
    from repro_torch.kernels.matmul.matmul import launch, matmul_tiled_plain, occupancy
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention, paged_attention_plain)

    log_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else runtime.BUILD_DIR
    log_dir.mkdir(parents=True, exist_ok=True)
    ptxas_report(log_dir)
    print(torch.__version__, torch.version.cuda)
    t1 = time.time()
    runtime.build()
    print("build", time.time() - t1, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def plain(a, b, bm, bn, bk, od=None):
        (m, k), n = a.shape, b.shape[1]
        ap = F.pad(a, (0, (-k) % bk, 0, (-m) % bm))
        bp = F.pad(b, (0, (-n) % bn, 0, (-k) % bk))
        return matmul_tiled_plain(ap, bp, bm, bn, bk, od)[:m, :n]

    def diag(got, want):
        d = (got.float() - want.float()).abs()
        rel = float(d.norm() / want.float().norm())
        bad = d > (1e-2 + 1e-2 * want.float().abs())
        out = f"rel {rel:.3e} maxabs {float(d.max()):.3e} bad {float(bad.float().mean()):.3f}"
        if bad.any():
            rows, cols = bad.float().mean(1), bad.float().mean(0)
            out += f" | bad by row%8 {[round(float(rows[i::8].mean()), 2) for i in range(8)]}"
            if cols.numel() >= 64:
                c64 = cols[:cols.numel() // 64 * 64].view(-1, 64)
                out += f" by col%64/8 {[round(float(c64[:, j * 8:(j + 1) * 8].mean()), 2) for j in range(8)]}"
        return out

    def case(name, m, k, n, bm, bn, bk, dtype=torch.bfloat16, od=None, misalign=False):
        a = torch.randn(m, k, device=dev, generator=g).to(dtype)
        b = torch.randn(k, n, device=dev, generator=g).to(dtype)
        if misalign:  # a base 2 (bf16) or 4 (f32) bytes past 16: the element route
            a2 = torch.empty(m * k + 1, dtype=dtype, device=dev)[1:].view(m, k)
            a2.copy_(a)
            a = a2
        runtime.reset_launches()
        try:
            got = launch(a, b, bm, bn, bk, od)
            torch.cuda.synchronize()
        except Exception as e:  # report and go on to the next case
            print(name, "RAISED", repr(e)[:300], flush=True)
            return
        want = plain(a, b, bm, bn, bk, od)
        print(name, (m, k, n), (bm, bn, bk), dict(runtime.launches), diag(got, want), flush=True)

    case("tma remop", 48, 256, 256, 24, 128, 128)
    case("tma remop ragged", 50, 200, 300, 24, 128, 128)
    case("elem remop", 48, 256, 256, 24, 128, 128, misalign=True)
    case("tma conv", 64, 2048, 256, 8, 128, 512)
    case("elem conv", 64, 2048, 256, 8, 128, 512, misalign=True)
    case("tma 64x64", 128, 256, 128, 64, 64, 128)
    case("tma probe", 256, 256, 512, 128, 256, 64)
    case("elem jax", 128, 64, 128, 16, 16, 16)
    case("elem jax2", 128, 64, 128, 32, 64, 16, od=torch.float32)
    case("elem odd", 200, 130, 70, 48, 70, 130)
    case("f32 conv", 64, 2048, 256, 8, 128, 512, dtype=torch.float32)
    case("f32 odd", 33, 257, 129, 8, 128, 257, dtype=torch.float32)
    for t in ((24, 128, 128), (8, 128, 512), (128, 256, 64)):
        print("occupancy", t, occupancy(*t))
    print("occupancy f32", occupancy(8, 128, 512, torch.float32))
    for gg, hd, ln in ((48, 128, 2077), (48, 128, 4096), (8, 256, 2077), (10, 256, 1000)):
        q = torch.randn(1, 1, gg, hd, device=dev, generator=g).to(torch.bfloat16)
        kc = torch.randn(1, 4096, 1, hd, device=dev, generator=g).to(torch.bfloat16)
        vc = torch.randn(1, 4096, 1, hd, device=dev, generator=g).to(torch.bfloat16)
        lengths = torch.tensor([ln], dtype=torch.int32, device=dev)
        got = paged_attention(q, kc, vc, lengths).float()
        want = paged_attention_plain(q, kc, vc, lengths).float()
        print("paged", gg, hd, ln, float((got - want).abs().max()),
              float((got - want).norm() / want.norm()))
    a = torch.randn(4096, 3072, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(3072, 24576, device=dev, generator=g).to(torch.bfloat16)
    for t in ((24, 128, 128), (8, 128, 512), (128, 256, 64), (8, 128, 128), (64, 64, 128)):
        launch(a, b, *t)
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(3):
            launch(a, b, *t)
        e.record()
        e.synchronize()
        ms = s.elapsed_time(e) / 3
        print("time", t, ms, "ms", 2 * 4096 * 3072 * 24576 / ms / 1e9, "TFLOP/s", flush=True)
    print("gemma remop", diag(launch(a, b, 24, 128, 128), plain(a, b, 24, 128, 128)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())

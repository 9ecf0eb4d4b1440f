#!/usr/bin/env python3
"""Quick card check of the merge-sort kernels (``sort_blocks``, ``merge_pass``)
and the row gather (``gather_rows``) after an edit.

Run from the root of a checkout on a machine with one H100:

    python3 sort_probe.py [LOG_DIR]

It compiles ``csrc/merge_sort.cu`` and ``csrc/gather_rows.cu`` with
``-Xptxas -v`` (the full logs go to LOG_DIR, by default the gitignored
``src/repro_torch/kernels/_build``) and prints each kernel's registers and
spills, then runs ``chip_smoke.py``'s kernels phase alone: the sort and
gather kernels bit for bit against their plain versions (every block, every
run, tied int32 keys, float32 keys with signed zeros and with NaNs; every
gather route and unit), the instantiations' registers and spills, and the
kernels' timings.  ``chip_smoke.py`` is the full check.  Exits 1 if a check
fails.
"""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def ptxas_report(log_dir: Path, name: str) -> None:
    from repro_torch.kernels import runtime

    t0 = time.time()
    r = subprocess.run([runtime.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-c", "-Xptxas", "-v", "-o",
                        str(log_dir / f"{name}.o"), str(runtime.CSRC / f"{name}.cu")],
                       capture_output=True, text=True)
    log = r.stdout + r.stderr
    (log_dir / f"ptxas_{name}.txt").write_text(log)
    print(name, "rc", r.returncode, "secs", time.time() - t0, flush=True)
    if r.returncode:
        print(log[-8000:])
        sys.exit(1)
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            info = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            print(line.split("'")[1][:90], "|", " ; ".join(info)[:220])
        elif "warning" in line.lower():
            print(line[:300])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sort_probe.py: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke

    log_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "src/repro_torch/kernels/_build"
    log_dir.mkdir(parents=True, exist_ok=True)
    for name in ("merge_sort", "gather_rows"):
        ptxas_report(log_dir, name)
    chip_smoke.load_peaks()
    print(chip_smoke.nvidia_smi(), flush=True)
    try:
        chip_smoke.phase_kernels(torch, torch.device("cuda", 0))
    except AssertionError as e:
        print("FAILED", e, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

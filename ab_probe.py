#!/usr/bin/env python3
"""Parent/change A/B of the attention kernels without a cap, on one H100.

Run from the root of a checkout on a machine with one card:

    python3 ab_probe.py PARENT_DIR

PARENT_DIR holds an unpacked checkout of the commit to compare with, for
example ``git archive <commit> | tar -x -C .chip_parent`` (``.chip_parent/``
is gitignored).  Four turns run in order, parent, change, change, parent,
each a process of its own with that checkout's ``src`` first on
``sys.path`` (each builds its own kernels): the flash kernel at six causal
and windowed serving shapes and the paged kernel at rows 5, 5c and 5d of
``PERF.md``'s kernel table, each call's output digested bit for bit and
timed by device ms (``chip_smoke.Bench.device_ms``).  One JSON line a turn,
then one with the card's ``nvidia-smi`` line and whether every turn's
digests agree; exits 1 if they do not.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TURNS = ("parent", "change", "change", "parent")
# (name, h, kv, s, hd, hd_v, window) on one batch row, and (name, kv, g, hd,
# s, length).
FLASH = (("gemma-2b", 8, 1, 2048, 256, 256, 0), ("granite-moe", 24, 8, 2048, 64, 64, 0),
         ("deepseek 192/128", 16, 16, 2048, 192, 128, 0),
         ("recurrentgemma causal", 10, 1, 4096, 256, 256, 0),
         ("recurrentgemma window 2048", 10, 1, 4096, 256, 256, 2048),
         ("seamless causal", 16, 16, 4096, 64, 64, 0))
PAGED = (("paged row 5", 1, 8, 256, 4096, 2048), ("paged row 5c ring", 1, 10, 256, 2048, 2048),
         ("paged row 5d", 16, 1, 64, 4096, 4096))


def turn(src: str) -> dict:
    """Every shape of FLASH and PAGED through the kernels of ``src``:
    a digest of the output's bits and the device ms a call."""
    import hashlib

    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import plan_blocks
    from repro_torch.kernels.paged_attention import paged_attention as pa

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(3)
    bench = chip_smoke.Bench(torch, device)
    out = {}

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen).to(torch.bfloat16)

    def record(name, fn):
        digest = hashlib.sha256(fn().view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        out[name] = {"digest": digest[:16], "device_ms": bench.device_ms(fn)["device_ms"]}

    for name, h, kv, s, hd, hd_v, window in FLASH:
        q, k, v = randn(1, h, s, hd), randn(1, kv, s, hd), randn(1, kv, s, hd_v)
        bq, bk = plan_blocks(s, s, hd, 2, hd_v=hd_v)
        record(name, lambda q=q, k=k, v=v, bq=bq, bk=bk, window=window: fa.flash_attention(
            q, k, v, bq=bq, bk=bk, window=window))
    for name, kv, g, hd, s, length in PAGED:
        q, kc, vc = randn(1, kv, g, hd), randn(1, s, kv, hd), randn(1, s, kv, hd)
        ln = torch.full((1,), length, dtype=torch.int32, device=device)
        record(name, lambda q=q, kc=kc, vc=vc, ln=ln: pa.paged_attention(q, kc, vc, ln))
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--turn":
        print(json.dumps({"turn": sys.argv[2], **turn(sys.argv[3])}), flush=True)
        return 0
    if len(sys.argv) != 2 or not (Path(sys.argv[1]) / "src" / "repro_torch").is_dir():
        print("usage: ab_probe.py PARENT_DIR (an unpacked checkout with src/repro_torch)",
              file=sys.stderr)
        return 2
    srcs = {"parent": str(Path(sys.argv[1]).resolve() / "src"), "change": str(ROOT / "src")}
    runs = []
    for name in TURNS:
        r = subprocess.run([sys.executable, __file__, "--turn", name, srcs[name]],
                           capture_output=True, text=True, check=True)
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    same = all(run[k]["digest"] == runs[0][k]["digest"] for run in runs for k in runs[0]
               if k != "turn")
    print(json.dumps({"card": card.strip(), "equal_bits": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

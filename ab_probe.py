#!/usr/bin/env python3
"""Parent/change A/B of the attention kernels without a cap, on one H100.

Run from the root of a checkout on a machine with one card:

    python3 ab_probe.py PARENT_DIR [--changes NAME,...]
    python3 ab_probe.py --train PARENT_DIR

PARENT_DIR holds an unpacked checkout of the commit to compare with, for
example ``git archive <commit> | tar -x -C .chip_parent`` (``.chip_parent/``
is gitignored).  Four turns run in order, parent, change, change, parent,
each a process of its own with that checkout's ``src`` first on
``sys.path`` (each builds its own kernels): the flash kernel at six causal
and windowed serving shapes, the paged kernel at rows 5, 5c and 5d of
``PERF.md``'s kernel table, and the flash backward's tensor-core route at
every bf16 row of this tree's ``chip_smoke.BWD_CHECKS`` at the checkout's
``BWD_TC_HEAD_PAIRS`` (named ``"bwd "`` and the row's name: qwen3-0.6b's
training shape, gemma-2b's, MLA's, the windowed, prefix and capped rows, the "G 8" and "G 48" rows of query heads
on one KV head with q 8 times the unit scale, granite-moe-3b-a800m's
training shape (G 3) plain and at q gain 8, qwen3-0.6b's and MLA's training
shapes at q gain 8 (rows that keep one run a CTA and no flush), and
seamless-m4t-large-v2's every-key and cross calls; given the forward's lse,
in the model's ``[B, S, heads, hd]`` memory), each call's output digested bit
for bit and timed by device ms
(``chip_smoke.Bench.device_ms``); each backward also held to this tree's
plain version under ``chip_smoke.ATTN_TOL`` (``within_attn_tol`` and
``tol_excess``, the largest share of the elementwise bound).  One JSON
line a turn, then one with the card's ``nvidia-smi`` line and, per shape,
whether every turn's digests agree; exits 1 unless they do at every shape
but those named by ``--changes`` (a change meant to move their bits).
With ``--train`` each turn instead
trains qwen3-0.6b through ``launch.train.main`` at ``chip_smoke``'s command
line cut to ``TRAIN_AB_STEPS`` steps and no checkpoints, and reports its
losses (which must agree) and the median host seconds of steps 3 on: the
trainer's step time, host launches included, parent against change.
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
TRAIN_AB_STEPS = 12


def train_turn(src: str) -> dict:
    """qwen3-0.6b's trainer through the kernels of ``src``: the losses'
    digest and the median host seconds a step (steps 3 on)."""
    import hashlib
    import statistics
    import time

    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.launch import train as train_mod

    argv = list(chip_smoke.TRAIN_ARGV)
    argv[argv.index("--steps") + 1] = str(TRAIN_AB_STEPS)
    argv[argv.index("--checkpoint-every") + 1] = "1000"
    stamps = {}
    _, losses = train_mod.main([*argv, "--device", "cuda:0"],
                               metrics_cb=lambda step, m: stamps.__setitem__(
                                   step, (time.perf_counter(), float(m["loss_total"]))))
    torch.cuda.synchronize()
    steps = sorted(stamps)
    digest = hashlib.sha256(json.dumps([stamps[s][1] for s in steps]).encode()).hexdigest()
    return {"trainer": {"digest": digest[:16], "step_seconds_median": statistics.median(
        stamps[s][0] - stamps[s - 1][0] for s in steps[2:])}}


def turn(src: str) -> dict:
    """Every shape of FLASH and PAGED through the kernels of ``src``:
    a digest of the output's bits and the device ms a call."""
    import hashlib

    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention.ops import plan_blocks
    from repro_torch.kernels.paged_attention import paged_attention as pa

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(3)
    bench = chip_smoke.Bench(torch, device)
    out = {}

    def randn(*shape, gain=1.0):
        return (torch.randn(*shape, device=device, generator=gen) * gain).to(torch.bfloat16)

    def record(name, fn):
        got = fn()
        flat = torch.cat([x.reshape(-1) for x in got]) if isinstance(got, tuple) else got
        digest = hashlib.sha256(flat.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        out[name] = {"digest": digest[:16], "device_ms": bench.device_ms(fn)["device_ms"]}
        return got

    for name, h, kv, s, hd, hd_v, window in FLASH:
        q, k, v = randn(1, h, s, hd), randn(1, kv, s, hd), randn(1, kv, s, hd_v)
        bq, bk = plan_blocks(s, s, hd, 2, hd_v=hd_v)
        record(name, lambda q=q, k=k, v=v, bq=bq, bk=bk, window=window: fa.flash_attention(
            q, k, v, bq=bq, bk=bk, window=window))
    for name, kv, g, hd, s, length in PAGED:
        q, kc, vc = randn(1, kv, g, hd), randn(1, s, kv, hd), randn(1, s, kv, hd)
        ln = torch.full((1,), length, dtype=torch.int32, device=device)
        record(name, lambda q=q, kc=kc, vc=vc, ln=ln: pa.paged_attention(q, kc, vc, ln))
    for (name, b, h, kv, s, t, hd, hd_v, window, prefix, cap, gain,
         dtype) in chip_smoke.BWD_CHECKS:
        if dtype != "bfloat16" or (hd, hd_v) not in fab.BWD_TC_HEAD_PAIRS:
            continue
        name = f"bwd {name}"
        q = randn(b, s, h, hd, gain=gain).transpose(1, 2)
        k, v = (randn(b, t, kv, w).transpose(1, 2) for w in (hd, hd_v))
        dout = randn(b, s, h, hd_v).transpose(1, 2)
        bq, bk = plan_blocks(s, t, hd, 2, path="tc", hd_v=hd_v)
        mask = dict(window=window, prefix=prefix, softcap=cap)
        with torch.no_grad():
            o, lse = fa.flash_attention(q, k, v, bq=bq, bk=bk, return_lse=True, **mask)
        got = record(name, lambda q=q, k=k, v=v, o=o, dout=dout, lse=lse, mask=mask:
                     fab.flash_attention_bwd(q, k, v, o, dout, lse=lse, **mask))
        want = fab.flash_attention_bwd_plain(q, k, v, o, dout, **mask)
        out[name].update(within_attn_tol=chip_smoke.grads_close(torch, got, want)[0],
                         tol_excess=[chip_smoke.tol_excess(torch, g, w)
                                     for g, w in zip(got, want)])
        del got, want
    return out


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--turn":
        fn = train_turn if sys.argv[2] == "train" else turn
        print(json.dumps({"turn": sys.argv[3], **fn(sys.argv[4])}), flush=True)
        return 0
    args = sys.argv[1:]
    what = "train" if args[:1] == ["--train"] else "kernels"
    args = args[1:] if what == "train" else args
    changes = set()
    if "--changes" in args[1:2]:
        changes, args = set(args[2].split(",")), args[:1]
    if len(args) != 1 or not (Path(args[0]) / "src" / "repro_torch").is_dir():
        print("usage: ab_probe.py [--train] PARENT_DIR [--changes NAME,...] (an unpacked "
              "checkout with src/repro_torch)", file=sys.stderr)
        return 2
    srcs = {"parent": str(Path(args[0]).resolve() / "src"), "change": str(ROOT / "src")}
    runs = []
    for name in TURNS:
        r = subprocess.run([sys.executable, __file__, "--turn", what, name, srcs[name]],
                           capture_output=True, text=True, check=True)
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    same = {k: all(run[k]["digest"] == runs[0][k]["digest"] for run in runs)
            for k in runs[0] if k != "turn"}
    kept = all(ok for k, ok in same.items() if k not in changes)
    print(json.dumps({"card": card.strip(), "equal_bits": same, "changes": sorted(changes),
                      "equal_bits_where_kept": kept}), flush=True)
    return 0 if kept else 1


if __name__ == "__main__":
    sys.exit(main())

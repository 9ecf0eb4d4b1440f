#!/usr/bin/env python3
"""Quick card check of the flash-attention kernel's two routes after an edit.

Run from the root of a checkout on a machine with one H100:

    python3 flash_probe.py [LOG_DIR]
    python3 flash_probe.py --bwd [LOG_DIR]
    python3 flash_probe.py --bwd-long-runs [LOG_DIR]
    python3 flash_probe.py --grad-swap
    python3 flash_probe.py --hybrid-swap

With ``--bwd`` it checks the backward kernel instead (the quick check after
an edit of ``csrc/flash_attention_bwd.cu``): ``-Xptxas -v`` of that source
(registers and spills of both routes' kernels, ``dq_tc_kernel``,
``dkdv_tc_kernel`` and ``dkdv_wg_kernel`` among them) and of the forward's
(its lse instantiations), then ``chip_smoke.phase_train_kernels``
(every ``BWD_CHECKS`` shape on its route against the plain version, equal
bits twice, the forward's lse, the planted faults, registers and spills,
each route's timing row), then both routes and the plain version against
an f64 reference at hd 256, 128 and 64 on one KV head with q 8 times the
unit scale, capped and not, and at hd 128 with 48 query heads on one KV
head (granite-20b's, past the split's cap of 16 CTAs) (and the tensor-core
route with each key block's walk cut into 1 .. 16 CTAs), then the
tensor-core route at qwen3-0.6b's training shape under each hd-128
``dkdv`` block of ``BWD_TC_BLOCKS``, and at gemma-2b's, recurrentgemma's
window and paligemma's prefix shapes (hd 256, one KV head) under each dkdv
split (device ms, and the error against the plain version).  With
``--bwd-long-runs`` it prints ``-Xptxas -v`` of the backward, then holds
the tensor-core route at 48 heads on one KV head of 2048 (hd 128, q 8
times the unit scale: 16 CTAs a key block, each part walked in runs of
each length of ``LONG_RUNS``, handed to the launch) to the f64 reference,
on the inputs of each seed of ``LONG_RUN_SEEDS``, beside the CUDA-core
route and the plain version, with each one's device ms.  With
``--grad-swap`` it trains granite-moe-3b-a800m and deepseek-v2-lite-16b
as ``chip_smoke.py``'s phase 8c does and reads which half of the flash
kernel, forward or backward, carries the whole-model gradients' gap to
the plain path, on the trained weights, after the profiled step and at
init (``grad_swap``).  With ``--hybrid-swap`` it reads the same of
recurrentgemma-2b's first-step gradients at phase 8d's widths and tokens,
and how far the plain path moves when its forward sums in another order
(``hybrid_swap``).  Without any of these:

It compiles ``csrc/flash_attention.cu`` with ``-Xptxas -v`` (the full log
goes to LOG_DIR, by default the gitignored ``src/repro_torch/kernels/_build``)
and prints each kernel's registers and spills; then holds the kernel to
``flash_attention_plain`` under ``chip_smoke.ATTN_TOL`` at the main path's
shapes (gemma-2b, qwen3-0.6b, granite-20b's 48 heads on one KV head, a
ragged hd-64 prefill, the model's transposed layout, deepseek-v2-lite's
q/k 192 and v 128), at every block pair the tensor-core route takes (the
pair 192 / 128 too), with P rounded once to bf16 (the probe off the
main path), and on the CUDA-core route (bf16 hd 32, f32); with a sliding
window (recurrentgemma's 10 heads on one KV head of 256 at W 2048, S 2048,
3000 and 4096, in both routes and the model's layout; W 1000 at a GQA
shape; W 100 at every tensor-core block pair, with T > S); with a prefix
(paligemma's 8 heads on one KV head of 256 at P 256 under 200 and 512 text
rows, an unaligned P 100, in both routes; every key at seamless's 16 heads
of 64, bidirectional at T 4096 and 2500 and cross-attention with S above
and below T; P 100 and every key with S > T at every tensor-core block
pair); with a softcap (cap 5 on q scaled by 8, so that most scores pass
the cap) at gemma-2b's, deepseek-v2-lite's, recurrentgemma's windowed and
paligemma's prefix shapes and on the CUDA-core route, each also shown to
differ from the uncapped call; prints the occupancy of every tensor-core
instantiation, capped ones too.  It times one thing: the softcap rows'
library call, ``flex_attention`` under ``torch.compile`` with a tanh
``score_mod`` (cap 50) at gemma-2b's prefill and decode shapes, beside the
capped kernels, by device time (``chip_smoke.Bench.device_ms``), printed
with its error against the plain version or the error it raised;
``chip_smoke.py`` is the full check.  Exits 1 if any check fails.
"""

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def ptxas_report(log_dir: Path, name: str = "flash_attention") -> None:
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
            name = line.split("'")[1]
            info = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            print(name[:90], "|", " ; ".join(info)[:220])
        elif "warning" in line.lower():
            print(line[:300])


def bwd_tc_blocks(torch, chip_smoke) -> None:
    """The tensor-core backward at qwen3-0.6b's training shape under each
    dkdv block of ``BWD_TC_BLOCKS[(128, 128)]``, then at three hd-256 shapes
    on one KV head (gemma-2b's causal, recurrentgemma's window 2048,
    paligemma's prefix 256) under each dkdv split of 1 ..
    ``BWD_KV_SPLIT_MAX`` CTAs a key block: device ms a call and the error
    against the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    bench = chip_smoke.Bench(torch, dev)

    def inputs(b, h, kv, s, hd, **mask):
        q, k, v, dout = (torch.randn(b, s, n, hd, device=dev, generator=g).to(
            torch.bfloat16).transpose(1, 2) for n in (h, kv, kv, h))
        out, lse = chip_smoke.forward_with_lse(torch, q, k, v, **mask)
        return q, k, v, out, dout, lse, fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask)

    def report(what, q, k, v, out, dout, lse, want, **mask):
        got = fab.flash_attention_bwd(q, k, v, out, dout, lse=lse, **mask)
        ok, err, rel = chip_smoke.grads_close(torch, got, want)
        print(what, bench.device_ms(
            lambda: fab.flash_attention_bwd(q, k, v, out, dout, lse=lse, **mask), reps=10),
            f"ok {ok} maxabs {err:.3e} rel {rel:.3e}", flush=True)

    plan, split, runs = fab.plan_bwd_tc_blocks, fab.bwd_tc_kv_split, fab.check_bwd_runs
    table = fab.BWD_TC_BLOCKS[(128, 128)]
    fab.check_bwd_runs = lambda *args, **kwargs: None  # the sweeps' splits pass 4,096 rows
    try:
        case = inputs(4, 16, 8, 2048, 128)
        for blocks in table["dkdv"]:
            fab.plan_bwd_tc_blocks = lambda hd, hd_v, capped=False, blocks=blocks: {
                "dq": table["dq"][0], "dkdv": blocks}
            report(f"bwd tc qwen3-0.6b dkdv blocks {blocks}", *case)
        fab.plan_bwd_tc_blocks = plan
        for name, (b, h, kv, s, hd), mask in (("gemma-2b", (1, 8, 1, 2048, 256), {}),
                                              ("window 2048", (1, 10, 1, 4096, 256),
                                               {"window": 2048}),
                                              ("prefix 256", (1, 8, 1, 768, 256),
                                               {"prefix": 256})):
            case = inputs(b, h, kv, s, hd, **mask)
            print(f"bwd tc {name} planned kv_split", split(b, h, kv, s, s, hd, hd), flush=True)
            for n in range(1, fab.BWD_KV_SPLIT_MAX + 1):
                fab.bwd_tc_kv_split = lambda *args, n=n: n
                report(f"bwd tc {name} kv_split {n}", *case, **mask)
    finally:
        fab.plan_bwd_tc_blocks, fab.bwd_tc_kv_split, fab.check_bwd_runs = plan, split, runs


def f64_reference(torch, q, k, v, out, dout, softcap):
    """(dq, dk, dv) of causal softmax attention written out in float64 on
    the same bf16 inputs, with D from the same bf16 forward output."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    kd, vd = (x.double().repeat_interleave(g, 1) for x in (k, v))
    qd, dod = q.double(), dout.double()
    scale = 1 / math.sqrt(hd)
    sc = torch.einsum("bhsd,bhtd->bhst", qd, kd) * scale
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    seen = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~seen, float("-inf")), -1)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", dod, vd)
              - (dod * out.double()).sum(-1, keepdim=True))
    if softcap:
        ds = ds * (1 - (sc.masked_fill(~seen, 0) / softcap) ** 2)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kd) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qd) * scale
    dv = torch.einsum("bhst,bhsd->bhtd", p, dod)
    return dq, dk.view(b, -1, g, s, hd).sum(2), dv.view(b, -1, g, s, vd.shape[3]).sum(2)


def bwd_against_f64(torch, chip_smoke) -> None:
    """Both backward routes and the plain version against an f64 reference
    (softmax attention written out in float64 on the same bf16 inputs, with
    D from the same bf16 forward output) at hd 256, 128 and 64 with 8 query
    heads on one KV head and q 8 times the unit scale, capped at 50 or not,
    and at hd 128 with 48 heads on one KV head; then the tensor-core route
    at hd 256 and 128 with each key block's walk cut over 1 .. 16 CTAs (dK
    and dV only): per gradient the
    largest |got - ref| / (atol + rtol |ref|) of ``ATTN_TOL`` (below 1
    within it), the reference and the value there, and the count above 1."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab

    dev = torch.device("cuda", 0)

    def reference(q, k, v, out, dout, softcap):
        return f64_reference(torch, q, k, v, out, dout, softcap)

    def excess(got, ref):
        tol = chip_smoke.ATTN_TOL["torch.bfloat16"]
        r = (got.double() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())
        i = int(r.argmax())
        return [round(float(r.max()), 4), float(ref.reshape(-1)[i]),
                float(got.reshape(-1)[i]), int((r > 1).sum())]

    def inputs(hd, cap, heads=8):
        g = torch.Generator(device=dev).manual_seed(8)
        q, k, v, dout = ((torch.randn(1, 2048, n, hd, device=dev, generator=g) * gain).to(
            torch.bfloat16).transpose(1, 2) for n, gain in ((heads, 8.0), (1, 1.0), (1, 1.0),
                                                            (heads, 1.0)))
        out, lse = chip_smoke.forward_with_lse(torch, q, k, v, softcap=cap)
        return q, k, v, out, dout, lse, reference(q, k, v, out, dout, cap)

    # G 48: granite-20b's 48 heads on one KV head, 98,304 rows a key block,
    # 16 CTAs (the cap) each walking runs of 4,096 rows.
    for hd, cap, heads in ((256, 50.0, 8), (256, 0.0, 8), (128, 50.0, 8), (128, 0.0, 8),
                           (64, 50.0, 8), (64, 0.0, 8), (128, 0.0, 48)):
        q, k, v, out, dout, lse, ref = inputs(hd, cap, heads)
        route = fab.bwd_route
        got = {"tc": fab.flash_attention_bwd(q, k, v, out, dout, softcap=cap, lse=lse)}
        fab.bwd_route = lambda *xs: "simt"
        try:
            got["simt"] = fab.flash_attention_bwd(q, k, v, out, dout, softcap=cap)
        finally:
            fab.bwd_route = route
        got["plain"] = fab.flash_attention_bwd_plain(q, k, v, out, dout, softcap=cap)
        for who, grads in got.items():
            print(f"bwd vs f64 hd {hd} cap {cap} G {heads} q gain 8 {who}",
                  {n: excess(x, r) for n, x, r in zip(("dq", "dk", "dv"), grads, ref)},
                  flush=True)
        del got, ref

    # The tc route against the (head, query) rows one CTA sums into its
    # wgmma accumulators: each key block's 16,384 rows cut into n parts,
    # one CTA each (a split CTA sums at most BWD_RUN_ROWS rows a run).
    split, runs = fab.bwd_tc_kv_split, fab.check_bwd_runs
    fab.check_bwd_runs = lambda *args, **kwargs: None  # 1 CTA: runs of 16,384 rows
    try:
        for hd in (256, 128):
            q, k, v, out, dout, lse, ref = inputs(hd, 0.0)
            for n in (1, 2, 4, 8, 16):
                fab.bwd_tc_kv_split = lambda *args, n=n: n
                grads = fab.flash_attention_bwd(q, k, v, out, dout, lse=lse)
                run = 8 * 2048 // n if n == 1 else min(8 * 2048 // n, fab.BWD_RUN_ROWS)
                print(f"bwd vs f64 hd {hd} q gain 8 tc, {8 * 2048 // n} rows a CTA, runs of "
                      f"{run}",
                      {w: excess(x, r) for w, x, r in zip(("dk", "dv"), grads[1:], ref[1:])},
                      flush=True)
    finally:
        fab.bwd_tc_kv_split, fab.check_bwd_runs = split, runs


# The run lengths --bwd-long-runs hands the backward (run_steps), and the
# seeds of its inputs.
LONG_RUNS = (4096, 2048, 1024, 512)
LONG_RUN_SEEDS = (8, 1, 2)


def bwd_long_runs(torch, chip_smoke) -> None:
    """The tensor-core backward at G 48 (``[1, 48, 2048, 128]`` on one KV
    head, q gain 8) against f64 under each run length of ``LONG_RUNS``
    (one build: the launch takes the run length), on inputs of each seed of
    ``LONG_RUN_SEEDS``; the CUDA-core route and the plain version beside
    them."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab

    dev = torch.device("cuda", 0)
    bench = chip_smoke.Bench(torch, dev)
    tol = chip_smoke.ATTN_TOL["torch.bfloat16"]
    bq = fab.plan_bwd_tc_blocks(128, 128)["dkdv"][1]
    for seed in LONG_RUN_SEEDS:
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, dout = ((torch.randn(1, 2048, n, 128, device=dev, generator=g) * gain).to(
            torch.bfloat16).transpose(1, 2)
            for n, gain in ((48, 8.0), (1, 1.0), (1, 1.0), (48, 1.0)))
        out, lse = chip_smoke.forward_with_lse(torch, q, k, v)
        ref = f64_reference(torch, q, k, v, out, dout, 0.0)

        def excess(got, want):
            r = (got.double() - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())
            return [round(float(r.max()), 4), int((r > 1).sum())]

        def report(what, fn):
            grads = fn()
            ms = bench.device_ms(fn, reps=10)["device_ms"]
            print(f"bwd vs f64 G 48 hd 128 q gain 8 seed {seed} {what}: device ms {ms:.4f}",
                  {n: excess(x, r) for n, x, r in zip(("dq", "dk", "dv"), grads, ref)},
                  flush=True)

        plan = fab.plan_bwd_run_steps
        try:
            for rows in LONG_RUNS:
                fab.plan_bwd_run_steps = lambda *args, rows=rows: rows // bq
                report(f"tc, runs of {rows} rows",
                       lambda: fab.flash_attention_bwd(q, k, v, out, dout, lse=lse))
        finally:
            fab.plan_bwd_run_steps = plan
        route = fab.bwd_route
        fab.bwd_route = lambda *xs: "simt"
        try:
            report("simt", lambda: fab.flash_attention_bwd(q, k, v, out, dout))
        finally:
            fab.bwd_route = route
        report("plain", lambda: fab.flash_attention_bwd_plain(q, k, v, out, dout))
        del q, k, v, dout, out, lse, ref


@contextlib.contextmanager
def unsplit_dkdv():
    """The kernel backward's dkdv walks each key block in one CTA and one
    run while the context lasts."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab

    saved = fab.bwd_tc_kv_split, fab.check_bwd_runs
    fab.bwd_tc_kv_split = lambda *args: 1
    fab.check_bwd_runs = lambda *args, **kwargs: None
    try:
        yield
    finally:
        fab.bwd_tc_kv_split, fab.check_bwd_runs = saved


# (label, plain forward, plain backward, unsplit dkdv) of --grad-swap's paths,
# each held to the plain forward and plain backward (chip_smoke.plain_flash_training).
SWAP_PATHS = (("kernel forward, kernel backward", False, False, False),
              ("plain forward, kernel backward", True, False, False),
              ("kernel forward, plain backward", False, True, False),
              ("kernel forward, kernel backward, dkdv unsplit", False, False, True))


def grad_swap(torch, chip_smoke, dev) -> None:
    """Which half of the flash kernel carries the whole-model gradients'
    kernel-against-plain gap of a trained MoE decoder: each family of
    ``chip_smoke.MOE_TRAIN_FAMILIES`` trained as phase 8c trains it (20
    steps, no checkpoints), then one step's gradients (its first batch,
    full remat) on each path of ``SWAP_PATHS`` against the plain forward and
    backward, every path on the first path's routing (``chip_smoke.
    RoutingLog``, replayed), on three sets of weights: after 8c's profiled
    step (``chip_smoke.train_breakdown``: two more donating updates on that
    batch, the state phase 8c's gradient check first read), after the 20
    steps, and the initial ones."""
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    for arch, layers, _ in chip_smoke.MOE_TRAIN_FAMILIES:
        run = chip_smoke.train_window(torch, dev, chip_smoke.family_argv(arch, layers))
        cfg, args = run["cfg"], run["args"]
        state = run.pop("state")
        batch = next(synthetic_batches(cfg, run["shape"], seed=args.seed))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers, "losses": run["loss"]}),
              flush=True)
        trained = tree_map(lambda t: t.to("cpu", copy=True), state["params"])
        chip_smoke.train_breakdown(
            torch, steps_lib.make_train_step(cfg, run["opt_cfg"], donate=True), state, batch)
        weights = {"after the profiled step": state["params"]}
        del state
        torch.cuda.empty_cache()
        for label in ("after the profiled step", "trained", "init"):
            if label == "trained":
                params = tree_map(lambda t: t.to(dev), trained)
            elif label == "init":
                params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                                        dev, dtype=torch.float32)
            else:
                params = weights.pop(label)
            names = ["/".join(p) for p, _ in leaves_with_paths(params)]
            log = chip_smoke.RoutingLog(moe._top_k)

            def model_grads():
                log.agree = []
                live = tree_map(lambda t: t.detach().requires_grad_(), params)
                total, _ = tf.loss_fn(live, cfg, batch, remat=True)
                return torch.autograd.grad(total, leaves(live))

            moe._top_k = log
            try:
                first = model_grads()
                log.replaying = True
                with chip_smoke.plain_flash_training():
                    want = model_grads()
                for path, fwd, bwd, unsplit in SWAP_PATHS:
                    try:
                        if path != SWAP_PATHS[0][0]:
                            with chip_smoke.plain_flash_training(fwd, bwd), (
                                    unsplit_dkdv() if unsplit else contextlib.nullcontext()):
                                first = model_grads()
                    except Exception as e:  # report and go on to the next path
                        print(json.dumps({"arch": cfg.name, "weights": label, "path": path,
                                          "raised": repr(e)[:300]}), flush=True)
                        continue
                    errs = {n: chip_smoke.rel_err(torch, g, w)
                            for n, g, w in zip(names, first, want)}
                    print(json.dumps({
                        "arch": cfg.name, "weights": label, "path": path,
                        "against": "plain forward, plain backward",
                        "per_leaf_rel_err_max": max(errs.values()),
                        "worst_leaves": sorted(errs.items(), key=lambda kv: -kv[1])[:6],
                        "routing_agreement_min": min(log.agree)}), flush=True)
                    first = None
            finally:
                moe._top_k = log.top_k
            del params, want
            torch.cuda.empty_cache()
        del trained


# (label, plain forward, plain backward, the plain forward's key blocks as a
# multiple of the call's) of --hybrid-swap's paths, each held to the plain
# forward and backward at the call's key blocks.
HYBRID_SWAP_PATHS = (("kernel forward, kernel backward", False, False, 1),
                     ("plain forward, kernel backward", True, False, 1),
                     ("kernel forward, plain backward", False, True, 1),
                     ("plain forward at twice the key blocks, plain backward", True, True, 2))


def hybrid_swap(torch, chip_smoke, dev) -> None:
    """Which half of the flash kernel carries recurrentgemma-2b's first-step
    whole-model gradient gap (phase 8d's check), and how far the plain path
    moves when its forward sums the same f32 softmax in another order: the
    initial weights and the first batch's first microbatch, as phase 8d
    reads them, on each path of ``HYBRID_SWAP_PATHS``."""
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as tf

    argv = [*chip_smoke.family_argv(chip_smoke.HYBRID_ARCH, 0, chip_smoke.HYBRID_TRAIN_ARGV),
            "--device", str(dev)]
    args = train_mod.parse_args(argv)
    cfg, shape, _, _ = train_mod.setup(args)
    rows = shape.global_batch // args.microbatches
    batch = {k: torch.as_tensor(v[:rows], device=dev)
             for k, v in next(synthetic_batches(cfg, shape, seed=args.seed)).items()}
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev,
                            dtype=torch.float32)
    paths = [functools.partial(chip_smoke.plain_flash_training, fwd, bwd, blocks)
             if fwd or bwd else contextlib.nullcontext
             for _, fwd, bwd, blocks in HYBRID_SWAP_PATHS]
    for (path, *_), errs in zip(HYBRID_SWAP_PATHS, chip_smoke.path_grad_errors(
            torch, cfg, params, batch, chip_smoke.plain_flash_training, paths)):
        print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers, "tokens": [rows, shape.seq_len],
                          "path": path, "against": "plain forward, plain backward",
                          "per_leaf_rel_err_max": max(errs.values()),
                          "worst_leaves": sorted(errs.items(), key=lambda kv: -kv[1])[:6]}),
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_probe.py: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention.flash_attention import (
        TC_BLOCKS, TC_HEAD_PAIRS, SMEM_LIMIT, flash_attention, flash_attention_plain, occupancy,
        route, smem_bytes)
    from repro_torch.kernels.flash_attention.ops import remop_flash_attention

    args = [a for a in sys.argv[1:]
            if a not in ("--bwd", "--bwd-long-runs", "--grad-swap", "--hybrid-swap")]
    log_dir = Path(args[0]) if args else runtime.BUILD_DIR
    log_dir.mkdir(parents=True, exist_ok=True)
    if "--hybrid-swap" in sys.argv[1:]:
        print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
        chip_smoke.load_peaks()
        runtime.build(["flash_attention", "flash_attention_bwd"])
        hybrid_swap(torch, chip_smoke, torch.device("cuda", 0))
        print("ALL OK", flush=True)
        return 0
    if "--grad-swap" in sys.argv[1:]:
        print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
        chip_smoke.load_peaks()
        runtime.build()
        grad_swap(torch, chip_smoke, torch.device("cuda", 0))
        print("ALL OK", flush=True)
        return 0
    if "--bwd-long-runs" in sys.argv[1:]:
        ptxas_report(log_dir, "flash_attention_bwd")
        print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
        chip_smoke.load_peaks()
        runtime.build(["flash_attention", "flash_attention_bwd"])
        bwd_long_runs(torch, chip_smoke)
        print("ALL OK", flush=True)
        return 0
    if "--bwd" in sys.argv[1:]:
        ptxas_report(log_dir, "flash_attention_bwd")
        ptxas_report(log_dir, "flash_attention")  # the forward's lse instantiations
        print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
        chip_smoke.load_peaks()
        t1 = time.time()
        runtime.build(["flash_attention", "flash_attention_bwd"])
        print("build", time.time() - t1, flush=True)
        chip_smoke.phase_train_kernels(torch, torch.device("cuda", 0))
        bwd_against_f64(torch, chip_smoke)
        bwd_tc_blocks(torch, chip_smoke)
        print("ALL OK", flush=True)
        return 0
    ptxas_report(log_dir)
    print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
    t1 = time.time()
    runtime.build()
    print("build", time.time() - t1, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    failed = []

    def inputs(b, h, kv, s, t, hd, dtype, hd_v=None):
        q = torch.randn(b, h, s, hd, device=dev, generator=g).to(dtype)
        k = torch.randn(b, kv, t, hd, device=dev, generator=g).to(dtype)
        v = torch.randn(b, kv, t, hd if hd_v is None else hd_v, device=dev, generator=g).to(dtype)
        return q, k, v

    def case(name, q, k, v, fn, window=0, prefix=0, softcap=0.0):
        runtime.reset_launches()
        try:
            got = fn(q, k, v)
            torch.cuda.synchronize()
        except Exception as e:  # report and go on to the next case
            print(name, "RAISED", repr(e)[:300], flush=True)
            failed.append(name)
            return
        want = flash_attention_plain(q, k, v, window=window, prefix=prefix, softcap=softcap)
        ok, err, rel, _ = chip_smoke.attn_close(torch, got, want)
        if softcap:  # the cap must change the output
            ok = ok and not chip_smoke.attn_close(
                torch, got, flash_attention_plain(q, k, v, window=window, prefix=prefix))[0]
        finite = bool(torch.isfinite(got.float()).all())
        print(name, tuple(q.shape), tuple(k.shape), str(q.dtype), route(q, k, v),
              dict(runtime.launches), f"ok {ok} finite {finite} maxabs {err:.3e} rel {rel:.3e}",
              flush=True)
        if not (ok and finite):
            failed.append(name)

    shapes = (("gemma-2b", 1, 8, 1, 2048, 2048, 256), ("gemma-2b 777", 1, 8, 1, 777, 777, 256),
              ("qwen3", 1, 16, 8, 2048, 2048, 128), ("hd64 ragged", 2, 4, 2, 300, 333, 64),
              ("granite G48", 1, 48, 1, 1000, 1000, 128))
    for name, *shape in shapes:
        q, k, v = inputs(*shape, torch.bfloat16)
        case(name, q, k, v, remop_flash_attention)
    q, k, v = inputs(1, 8, 1, 777, 777, 256, torch.bfloat16)
    qm, km, vm = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    case("model layout", qm, km, vm, remop_flash_attention)
    for s in (2048, 777):
        q, k, v = inputs(1, 16, 16, s, s, 192, torch.bfloat16, hd_v=128)
        case(f"deepseek 192/128 S {s}", q, k, v, remop_flash_attention)
        qm, km, vm = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
        case(f"deepseek 192/128 model layout S {s}", qm, km, vm, remop_flash_attention)
    for hd, hd_v in TC_HEAD_PAIRS:
        q, k, v = inputs(1, 4, 2, 200, 260, hd, torch.bfloat16, hd_v=hd_v)
        for bq in TC_BLOCKS:
            for bk in TC_BLOCKS:
                if smem_bytes(bq, bk, hd, 2, "tc", hd_v) <= SMEM_LIMIT:
                    case(f"blocks {bq},{bk} hd {hd}/{hd_v}", q, k, v,
                         lambda q, k, v, bq=bq, bk=bk: flash_attention(q, k, v, bq=bq, bk=bk))
                    print("occupancy", hd, hd_v, bq, bk, occupancy(hd, bq, bk, hd_v=hd_v),
                          flush=True)
    q, k, v = inputs(1, 8, 1, 2048, 2048, 256, torch.bfloat16)
    case("single bf16 P (probe; may exceed ATTN_TOL)", q, k, v,
         lambda q, k, v: flash_attention(q, k, v, bq=128, bk=64, split_p=False))
    failed = [f for f in failed if not f.startswith("single")]
    for dtype, hd, hd_v in ((torch.bfloat16, 32, 32), (torch.float32, 128, 128),
                            (torch.float32, 192, 128)):
        q, k, v = inputs(2, 16, 8, 300, 333, hd, dtype, hd_v=hd_v)
        case(f"simt {dtype} hd {hd}/{hd_v}", q, k, v, remop_flash_attention)
    for s in (2048, 3000, 4096):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(1, 10, 1, s, s, 256, dtype)
            case(f"recurrentgemma W 2048 S {s} {dtype}", q, k, v,
                 lambda q, k, v: remop_flash_attention(q, k, v, window=2048), window=2048)
    q, k, v = inputs(1, 10, 1, 3000, 3000, 256, torch.bfloat16)
    qm, km, vm = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    case("recurrentgemma W 2048 model layout", qm, km, vm,
         lambda q, k, v: remop_flash_attention(q, k, v, window=2048), window=2048)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(1, 8, 2, 1500, 1500, 128, dtype)
        case(f"GQA W 1000 {dtype}", q, k, v,
             lambda q, k, v: remop_flash_attention(q, k, v, window=1000), window=1000)
    for hd, hd_v in TC_HEAD_PAIRS:
        q, k, v = inputs(1, 4, 2, 300, 333, hd, torch.bfloat16, hd_v=hd_v)
        for bq in TC_BLOCKS:
            for bk in TC_BLOCKS:
                if smem_bytes(bq, bk, hd, 2, "tc", hd_v) <= SMEM_LIMIT:
                    case(f"W 100 blocks {bq},{bk} hd {hd}/{hd_v}", q, k, v,
                         lambda q, k, v, bq=bq, bk=bk: flash_attention(q, k, v, bq=bq, bk=bk,
                                                                       window=100), window=100)
    def prefixed(p):
        return lambda q, k, v: remop_flash_attention(q, k, v, prefix=p)

    for s, p in ((456, 256), (768, 256), (612, 100)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(1, 8, 1, s, s, 256, dtype)
            case(f"paligemma P {p} S {s} {dtype}", q, k, v, prefixed(p), prefix=p)
    for s, t in ((4096, 4096), (2500, 2500), (300, 200), (1, 4096), (64, 2500)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(1, 16, 16, s, t, 64, dtype)
            case(f"seamless every key S {s} T {t} {dtype}", q, k, v, prefixed(t), prefix=t)
    for hd, hd_v in TC_HEAD_PAIRS:
        for s, t, p in ((333, 333, 100), (300, 260, 260)):
            q, k, v = inputs(1, 4, 2, s, t, hd, torch.bfloat16, hd_v=hd_v)
            for bq in TC_BLOCKS:
                for bk in TC_BLOCKS:
                    if smem_bytes(bq, bk, hd, 2, "tc", hd_v) <= SMEM_LIMIT:
                        case(f"P {p} S {s} T {t} blocks {bq},{bk} hd {hd}/{hd_v}", q, k, v,
                             lambda q, k, v, bq=bq, bk=bk, p=p: flash_attention(
                                 q, k, v, bq=bq, bk=bk, prefix=p), prefix=p)
    def capped(**kw):
        return lambda q, k, v: remop_flash_attention(q, k, v, softcap=5.0, **kw)

    for name, shape, kw in (("gemma-2b", (1, 8, 1, 2048, 2048, 256), {}),
                            ("qwen3", (1, 16, 8, 777, 777, 128), {}),
                            ("hd64 ragged", (2, 4, 2, 300, 333, 64), {}),
                            ("recurrentgemma W 2048", (1, 10, 1, 4096, 4096, 256),
                             {"window": 2048}),
                            ("paligemma P 256", (1, 8, 1, 456, 456, 256), {"prefix": 256})):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(*shape, dtype)
            case(f"softcap 5 {name} {dtype}", q * 8, k, v, capped(**kw), softcap=5.0, **kw)
    q, k, v = inputs(1, 16, 16, 777, 777, 192, torch.bfloat16, hd_v=128)
    case("softcap 5 deepseek 192/128", q * 8, k, v, capped(), softcap=5.0)
    q, k, v = inputs(2, 16, 8, 300, 333, 32, torch.bfloat16)
    case("softcap 5 simt bf16 hd 32", q * 8, k, v, capped(), softcap=5.0)
    for hd, hd_v in TC_HEAD_PAIRS:
        q, k, v = inputs(1, 4, 2, 200, 260, hd, torch.bfloat16, hd_v=hd_v)
        for bq in TC_BLOCKS:
            for bk in TC_BLOCKS:
                if smem_bytes(bq, bk, hd, 2, "tc", hd_v) <= SMEM_LIMIT:
                    case(f"softcap 5 blocks {bq},{bk} hd {hd}/{hd_v}", q * 8, k, v,
                         lambda q, k, v, bq=bq, bk=bk: flash_attention(q, k, v, bq=bq, bk=bk,
                                                                       softcap=5.0),
                         softcap=5.0)
                    print("occupancy capped", hd, hd_v, bq, bk,
                          occupancy(hd, bq, bk, hd_v=hd_v, capped=True), flush=True)
    flex_times(torch, dev, chip_smoke)
    print("FAILED" if failed else "ALL OK", failed, flush=True)
    return 1 if failed else 0


def flex_times(torch, dev, chip_smoke) -> None:
    """The library call for the capped kernels' rows: ``flex_attention``
    compiled with ``score_mod = tanh(s / 50) * 50`` (after its 1/sqrt(hd)
    scale, as the kernels cap) at gemma-2b's causal prefill ``[1,8,2048,256]``
    on one KV head and at its decode (one query over 2048 of 4096 cached
    positions), by device ms beside the kernels'."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa

    cap = chip_smoke.ATTN_SOFTCAP
    bench = chip_smoke.Bench(torch, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(1, h, 2048, 256, device=dev, generator=g).to(torch.bfloat16)
               for h in (8, 1, 1))
    qd = torch.randn(1, 1, 8, 256, device=dev, generator=g).to(torch.bfloat16)
    kc, vc = (torch.randn(1, 4096, 1, 256, device=dev, generator=g).to(torch.bfloat16)
              for _ in range(2))
    ln = torch.tensor([2048], dtype=torch.int32, device=dev)
    print("capped kernels device ms", {
        "flash": bench.device_ms(lambda: fa.flash_attention(q, k, v, bq=128, bk=64,
                                                            softcap=cap))["device_ms"],
        "paged": bench.device_ms(lambda: pa.paged_attention(qd, kc, vc, ln,
                                                            softcap=cap))["device_ms"]},
          flush=True)
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        def tanh_cap(score, b, h, q_idx, kv_idx):
            return torch.tanh(score / cap) * cap

        flex = torch.compile(flex_attention)
        causal = create_block_mask(lambda b, h, q_idx, kv_idx: q_idx >= kv_idx, None, None,
                                   2048, 2048, device=dev)

        def prefill():
            return flex(q, k, v, score_mod=tanh_cap, block_mask=causal, enable_gqa=True)

        ok, err, rel, _ = chip_smoke.attn_close(
            torch, prefill(), fa.flash_attention_plain(q, k, v, softcap=cap))
        print("flex_attention prefill", bench.device_ms(prefill), f"ok {ok} maxabs {err:.3e} "
              f"rel {rel:.3e}", flush=True)
        seen = create_block_mask(lambda b, h, q_idx, kv_idx: kv_idx < 2048, None, None, 1,
                                 4096, device=dev)
        qf, kf, vf = qd.view(1, 8, 1, 256), kc.transpose(1, 2), vc.transpose(1, 2)

        def decode():
            return flex(qf, kf, vf, score_mod=tanh_cap, block_mask=seen, enable_gqa=True)

        ok, err, rel, _ = chip_smoke.attn_close(
            torch, decode().view(1, 1, 8, 256), pa.paged_attention_plain(qd, kc, vc, ln,
                                                                          softcap=cap))
        print("flex_attention decode", bench.device_ms(decode), f"ok {ok} maxabs {err:.3e} "
              f"rel {rel:.3e}", flush=True)
    except Exception as e:  # report what the library call did and go on
        print("flex_attention RAISED", repr(e)[:2000], flush=True)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Quick card check of the flash-attention kernel's two routes after an edit.

Run from the root of a checkout on a machine with one H100:

    python3 flash_probe.py [LOG_DIR]
    python3 flash_probe.py --bwd [LOG_DIR]
    python3 flash_probe.py --bwd-run-rows [ROW FLUSH_ROWS,... | planned]
    python3 flash_probe.py --emulate ROW SEED,...
    python3 flash_probe.py --simt-rows [ROW,...]
    python3 flash_probe.py --swap ARCH {init,trained}
    python3 flash_probe.py --layer-f64 ARCH {init,trained}

With ``--bwd`` it checks the backward kernel instead (the quick check after
an edit of ``csrc/flash_attention_bwd.cu``): ``-Xptxas -v`` of that source
(registers and spills of both routes' kernels, ``dq_tc_kernel``,
``dkdv_tc_kernel`` and ``dkdv_wg_kernel`` among them) and of the forward's
(its lse instantiations), then ``chip_smoke.phase_train_kernels``
(every ``BWD_CHECKS`` shape on its route against the plain version, equal
bits twice, the forward's lse, the planted faults, registers and spills,
each route's timing row), then both routes and the plain version against
an f64 reference at hd 256, 128 and 64 on one KV head with q 8 times the
unit scale, capped and not, at hd 128 with 48 query heads on one KV
head (granite-20b's, past the split's cap of 16 CTAs), and the tensor-core
route and the plain version at paligemma-3b's training shape (prefix 256)
plain and with q 8 times the unit scale (and the tensor-core
route with each key block's walk cut into 1 .. 16 CTAs, flushing and
not), then the tensor-core route at qwen3-0.6b's training shape under
each hd-128 ``dkdv`` block of ``BWD_TC_BLOCKS``, at gemma-2b's,
recurrentgemma's window and paligemma's prefix shapes (hd 256, one KV
head) under each dkdv split, and at the trainers' flushing shapes under
each split flushing and not (device ms, and the error against the plain
version).  With ``--bwd-run-rows`` it holds the tensor-core backward's dK
to the f64 reference under each of ``FLUSH_CANDIDATES`` as the rows one
dkdv accumulator sums between flushes (0: no flush) at the q-gain-8 rows
of ``BWD_CHECKS`` (G 1 to 48, the prefix and every-key rows among them),
on ``chip_smoke.py``'s inputs and on 40 fresh draws each, and times the
backward's model shapes under each (given a row and flush lengths, that row
under those only, e.g. ``--bwd-run-rows "G 48 q gain 8 hd 128" 128,256``).  With
``--emulate ROW SEED,...`` it holds that row's dK to the f64 reference on
the draws of those seeds (-1: ``chip_smoke.py``'s) under each candidate
cause of a miss (``emulate``): the kernel; the kernel fed the f64 lse
rounded to f32; probe builds whose P takes its exponent another way
(``EXPONENT_VARIANTS``: the form the kernel had before); its plan written
out in f32; that plan with wgmma's accumulation modelled as truncating.
With ``--simt-rows`` it holds the CUDA-core route's gradients to f64 at the
reduced configs' widths, q 8 times the unit scale, over 41 draws a row
(``simt_rows``).  With ``--swap ARCH STATE`` it reads which half
of the flash kernel, forward or backward, carries the gap between the
kernel and plain paths of one whole-model gradient check of
``chip_smoke.py`` (qwen3-0.6b's of phase 5h, or that of the trainer of
phases 8c-8e that trains ARCH), and how far the plain path moves when its
forward sums in another order, on the initial weights or the trained ones
(``swap``).  With ``--layer-f64 ARCH STATE`` it holds each flash call of
that gradient check (the kernel path) to float64 on its own inputs, the
forward's output and the backward's gradients, layer by layer.  Without any
of these:

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


def tc_grads(torch, fab, q, k, v, out, dout, lse, kv_split, flush_steps, **mask):
    """(dq, dk, dv) of the tensor-core route with ``kv_split`` CTAs a key
    block flushing every ``flush_steps`` query blocks (0: none), the plan's
    bounds set aside: the kernel's launches, then ``kv_reduce`` where split."""
    split, runs = fab.bwd_tc_kv_split, fab.check_bwd_runs
    fab.bwd_tc_kv_split = lambda *args: kv_split
    fab.check_bwd_runs = lambda *args, **kwargs: None
    try:
        scale = 1 / math.sqrt(q.shape[3])
        dq, dk, dv, part, n = fab.bwd_tc_launch(q, k, v, out, dout, lse, scale, **mask,
                                                flush_steps=flush_steps)
    finally:
        fab.bwd_tc_kv_split, fab.check_bwd_runs = split, runs
    if n > 1:
        fab.kv_reduce(part, dk, dv, n, scale)
    return dq, dk, dv


# The splits the sweeps below try at the trainers' flushing shapes.
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def bwd_tc_blocks(torch, chip_smoke) -> None:
    """The tensor-core backward at qwen3-0.6b's training shape under each
    dkdv block of ``BWD_TC_BLOCKS[(128, 128)]``, then at three hd-256 shapes
    on one KV head (gemma-2b's causal, recurrentgemma's window 2048,
    paligemma's prefix 256) under each dkdv split of 1 ..
    ``BWD_KV_SPLIT_MAX`` CTAs a key block, and at the flushing rows of the
    trainers' shapes (``BWD_CHECKS``' "paligemma train", "recurrentgemma
    train", "granite-moe train", "seamless encoder train" and "G 8 q gain 8
    hd 64") under each split of ``SWEEP_SPLITS``, flushing as planned and
    not: device ms a call and the error against the plain version."""
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
    fab.check_bwd_runs = lambda *args, **kwargs: None  # the sweeps' plans pass the bounds
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
    rows = {c[0]: c for c in chip_smoke.BWD_CHECKS}
    for name in ("paligemma train", "recurrentgemma train", "granite-moe train",
                 "seamless encoder train", "G 8 q gain 8 hd 64"):
        _, b, h, kv, s, t, hd, hd_v, window, prefix, cap, gain, _ = rows[name]
        q, k, v, dout = seeded_inputs(torch, dev, rows[name], 0)
        mask = dict(window=window, prefix=prefix, softcap=cap)
        out, lse = chip_smoke.forward_with_lse(torch, q, k, v, **mask)
        want = fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask)
        bq = fab.plan_bwd_tc_blocks(hd, hd_v, cap > 0)["dkdv"][1]
        planned = (fab.bwd_tc_kv_split(b, h, kv, s, t, hd, hd_v, prefix),
                   fab.plan_bwd_flush_steps(h // kv, s, bq, prefix))
        for n in SWEEP_SPLITS:
            for flush in (planned[1], 0):
                ms = bench.device_ms(lambda: tc_grads(torch, fab, q, k, v, out, dout, lse, n,
                                                      flush, **mask), reps=10)["device_ms"]
                ok, err, rel = chip_smoke.grads_close(
                    torch, tc_grads(torch, fab, q, k, v, out, dout, lse, n, flush, **mask),
                    want)
                print(f"bwd tc {name} kv_split {n} flush_steps {flush}"
                      f"{' (planned)' if (n, flush) == planned else ''}: device ms {ms:.4f} "
                      f"ok {ok} maxabs {err:.3e} rel {rel:.3e}", flush=True)
        del q, k, v, dout, out, lse, want


def f64_reference(torch, q, k, v, out, dout, softcap, prefix=0):
    """(dq, dk, dv) of causal softmax attention (every query also seeing the
    first ``prefix`` keys) written out in float64 on the same bf16 inputs,
    with D from the same bf16 forward output."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    kd, vd = (x.double().repeat_interleave(g, 1) for x in (k, v))
    qd, dod = q.double(), dout.double()
    scale = 1 / math.sqrt(hd)
    sc = torch.einsum("bhsd,bhtd->bhst", qd, kd) * scale
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    seen = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    seen[:, :prefix] = True
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
    at hd 128 with 48 heads on one KV head, and (the tensor-core route and
    the plain version) at paligemma-3b's training shape ``[4, 8, 2048, 256]``
    on one KV head with prefix 256, q at gain 1 and 8; then the tensor-core
    route at hd 256 and 128 with each key block's walk cut over 1 .. 16 CTAs (dK
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
    # 16 CTAs (the cap) each flushing every BWD_FLUSH_ROWS rows.
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

    # paligemma-3b's training shape: 4 x 2048 positions, 8 heads on one KV
    # head of 256, prefix 256 (BWD_CHECKS' "paligemma train" rows).
    for gain in (1.0, 8.0):
        g = torch.Generator(device=dev).manual_seed(8)
        q, k, v, dout = ((torch.randn(4, 2048, n, 256, device=dev, generator=g) * x).to(
            torch.bfloat16).transpose(1, 2) for n, x in ((8, gain), (1, 1.0), (1, 1.0),
                                                         (8, 1.0)))
        out, lse = chip_smoke.forward_with_lse(torch, q, k, v, prefix=256)
        ref = f64_reference(torch, q, k, v, out, dout, 0.0, prefix=256)
        got = {"tc": fab.flash_attention_bwd(q, k, v, out, dout, prefix=256, lse=lse),
               "plain": fab.flash_attention_bwd_plain(q, k, v, out, dout, prefix=256)}
        for who, grads in got.items():
            print(f"bwd vs f64 paligemma train [4,8,2048,256] prefix 256 q gain {gain} {who}",
                  {n: excess(x, r) for n, x, r in zip(("dq", "dk", "dv"), grads, ref)},
                  flush=True)
        del got, ref, q, k, v, dout, out, lse

    # The tc route against the (head, query) rows one accumulator sums:
    # each key block's 16,384 rows cut into n parts, one CTA each, without
    # a flush (runs of 16,384 / n rows) and flushing every BWD_FLUSH_ROWS.
    for hd in (256, 128):
        q, k, v, out, dout, lse, ref = inputs(hd, 0.0)
        bq = fab.plan_bwd_tc_blocks(hd, hd)["dkdv"][1]
        for n in (1, 2, 4, 8, 16):
            for flush in (0, fab.BWD_FLUSH_ROWS // bq):
                grads = tc_grads(torch, fab, q, k, v, out, dout, lse, n, flush)
                print(f"bwd vs f64 hd {hd} q gain 8 tc, {8 * 2048 // n} rows a CTA, runs of "
                      f"{flush * bq if flush else 8 * 2048 // n}",
                      {w: excess(x, r) for w, x, r in zip(("dk", "dv"), grads[1:], ref[1:])},
                      flush=True)


# The seeds of --bwd-run-rows' fresh draws of each row.
ROW_SEEDS = range(40)


def check_inputs(torch, chip_smoke, dev, names, first=()):
    """The (q, k, v, dout) of each ``BWD_CHECKS`` row in ``names``, drawn as
    ``chip_smoke.phase_train_kernels`` draws them (its generator replayed
    over every row before), in the model's layout; with the rows named in
    ``first`` drawn right after "prefix 256" instead of last."""
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = [c for c in chip_smoke.BWD_CHECKS if c[0] not in first]
    at = next(i for i, c in enumerate(rows) if c[0] == "prefix 256") + 1
    rows[at:at] = [c for c in chip_smoke.BWD_CHECKS if c[0] in first]
    out = {}
    for name, b, h, kv, s, t, hd, hd_v, *_, gain, dtype in rows:
        q, k, v, dout = (
            (torch.randn(b, n, heads, width, device=dev, generator=gen) * x).to(
                getattr(torch, dtype)).transpose(1, 2)
            for heads, n, width, x in ((h, s, hd, gain), (kv, t, hd, 1.0), (kv, t, hd_v, 1.0),
                                       (h, s, hd_v, 1.0)))
        if name in names:
            out[name] = (q, k, v, dout)
    return out


def seeded_inputs(torch, dev, row, seed):
    """(q, k, v, dout) of the ``BWD_CHECKS`` row ``row`` drawn afresh from
    ``seed``, in the model's layout."""
    _, b, h, kv, s, t, hd, hd_v, *_, gain, dtype = row
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple((torch.randn(b, n, heads, width, device=dev, generator=gen) * x).to(
        getattr(torch, dtype)).transpose(1, 2) for heads, n, width, x in (
            (h, s, hd, gain), (kv, t, hd, 1.0), (kv, t, hd_v, 1.0), (h, s, hd_v, 1.0)))


def cancelled_terms(torch, q, k, v, out, dout, index, prefix, softcap):
    """The sum of |dS q| / sqrt(hd) in f64 over the (head, query) rows that
    dK's entry ``index`` = (b, KV head, key, column) sums: the magnitude its
    terms cancel from."""
    bi, ki, ti, di = index
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    heads = slice(ki * g, (ki + 1) * g)
    qd, dod = q[bi, heads].double(), dout[bi, heads].double()
    kd, vd = k[bi, ki].double(), v[bi, ki].double()
    pos = torch.arange(s, device=q.device)
    seen = (pos[:, None] >= pos[None, :]) | (pos[None, :] < prefix)
    sc = qd @ kd.T / math.sqrt(hd)
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    p = torch.softmax(sc.masked_fill(~seen, float("-inf")), -1)
    ds = p * (dod @ vd.T - (dod * out[bi, heads].double()).sum(-1, keepdim=True))
    if softcap:
        ds = ds * (1 - (sc.masked_fill(~seen, 0) / softcap) ** 2)
    return float((ds[:, :, ti].abs() * qd[:, :, di].abs()).sum() / math.sqrt(hd))


# The rows one dkdv accumulator sums between flushes that --bwd-run-rows
# tries at each row's planned split (0: no flush, each CTA's part in one
# run; the plan of a call that does not flush), the q-gain-8 rows it reads
# against f64 on every draw, and the rows it times.
FLUSH_CANDIDATES = (256, 1024, 4096, 0)
RUN_ROW_PRECISION = ("q gain 8", "G 8 q gain 8 hd 64", "G 8 softcap 50 hd 128",
                     "granite-moe q gain 8", "G 48 q gain 8 hd 128", "paligemma q gain 8",
                     "qwen3-0.6b q gain 8", "mla q gain 8", "seamless encoder q gain 8")
RUN_ROW_TIMED = ("qwen3-0.6b train", "gemma-2b", "recurrentgemma train", "paligemma train",
                 "granite-moe train", "mla 192/128", "G 48 q gain 8 hd 128",
                 "seamless encoder train")


def flush_label(rows: int) -> str:
    return f"flush {rows}" if rows else "no flush"


def bwd_run_rows(torch, chip_smoke, names=RUN_ROW_PRECISION, candidates=FLUSH_CANDIDATES,
                 timed=RUN_ROW_TIMED) -> None:
    """The tensor-core backward's dK against the f64 reference at each row
    of ``names`` (by default ``RUN_ROW_PRECISION``), on ``chip_smoke.py``'s
    inputs (for "q gain 8" also on those it has with the paligemma rows
    drawn first) and on fresh draws from each seed of ``ROW_SEEDS``: the
    largest |got - ref| / (atol + rtol |ref|) of ``ATTN_TOL`` under each of
    ``candidates`` (by default ``FLUSH_CANDIDATES``; None: the row's planned
    flush only) at the row's planned split, the planned plan marked, with the count of draws
    over 1 (and for each draw over 1, and the planned plan on chip_smoke's
    inputs, the worst entry: its reference, kernel and plain values, the
    kernel against the plain version, and the magnitude its terms cancel
    from); then each row of ``timed`` timed under each candidate (device
    ms, seed 0), with its kv_split and flush steps."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = chip_smoke.ATTN_TOL["torch.bfloat16"]
    rows = {c[0]: c for c in chip_smoke.BWD_CHECKS}
    bench = chip_smoke.Bench(torch, dev)

    def plan_of(name):
        _, b, h, kv, s_, t, hd, hd_v, window, prefix, cap, *_ = rows[name]
        bq = fab.plan_bwd_tc_blocks(hd, hd_v, cap > 0)["dkdv"][1]
        return (dict(window=window, prefix=prefix, softcap=cap), bq,
                fab.bwd_tc_kv_split(b, h, kv, s_, t, hd, hd_v, prefix),
                fab.plan_bwd_flush_steps(h // kv, s_, bq, prefix) * bq)

    draws = {name: [("chip_smoke", xs)]
             for name, xs in check_inputs(torch, chip_smoke, dev, names).items()}
    if "q gain 8" in draws:
        draws["q gain 8"].append(("paligemma rows first", check_inputs(
            torch, chip_smoke, dev, ["q gain 8"],
            first=("paligemma train", "paligemma q gain 8"))["q gain 8"]))
    for name in names:
        mask, bq, split, planned = plan_of(name)
        row_candidates = (planned,) if candidates is None else candidates
        found = {c: [] for c in row_candidates}
        for label, xs in draws[name] + [(f"seed {seed}", seeded_inputs(
                torch, dev, rows[name], seed)) for seed in ROW_SEEDS]:
            q, k, v, dout = xs
            out, lse = chip_smoke.forward_with_lse(torch, q, k, v, **mask)
            ref = f64_reference(torch, q, k, v, out, dout, mask["softcap"],
                                prefix=mask["prefix"])[1]
            plain = None
            for c in row_candidates:
                dk = tc_grads(torch, fab, q, k, v, out, dout, lse, split, c // bq, **mask)[1]
                r = (dk.double() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())
                found[c].append(round(float(r.max()), 4))
                if r.max() > 1 or (c == planned and label == "chip_smoke"):
                    if plain is None:
                        plain = fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask)[1]
                    at = tuple(int(x) for x in torch.unravel_index(r.argmax(), r.shape))
                    cancel = cancelled_terms(torch, q, k, v, out, dout, at, mask["prefix"],
                                             mask["softcap"])
                    print(f"bwd run rows {flush_label(c)} {name} {label}: worst dk at {list(at)}, "
                          f"ref {float(ref[at]):.6g}, kernel {float(dk[at]):.6g}, plain "
                          f"{float(plain[at]):.6g}, against the plain version "
                          f"{chip_smoke.tol_excess(torch, dk, plain):.4f}, sum |dS q| "
                          f"{cancel:.6g}", flush=True)
            del ref, plain, out, lse
        for c in row_candidates:
            print(f"bwd run rows {flush_label(c)}{' (planned)' if c == planned else ''} {name} "
                  f"kv_split {split}: dk excess vs f64 on {len(found[c])} draws "
                  f"({[label for label, _ in draws[name]]} and seeds {ROW_SEEDS.start}.."
                  f"{ROW_SEEDS.stop - 1}): max {max(found[c])}, {sum(x > 1 for x in found[c])} "
                  f"over 1: {found[c]}", flush=True)
    for name in timed:
        q, k, v, dout = seeded_inputs(torch, dev, rows[name], 0)
        mask, bq, split, planned = plan_of(name)
        out, lse = chip_smoke.forward_with_lse(torch, q, k, v, **mask)
        for c in ((planned,) if candidates is None else candidates):
            ms = bench.device_ms(lambda: tc_grads(torch, fab, q, k, v, out, dout, lse, split,
                                                  c // bq, **mask), reps=10)["device_ms"]
            print(f"bwd run rows {flush_label(c)}{' (planned)' if c == planned else ''} {name}: "
                  f"device ms {ms:.4f} kv_split {split} flush steps {c // bq}", flush=True)
        del q, k, v, dout, out, lse


# The CUDA-core route's q-gain-8 rows at the reduced configs' widths that
# --simt-rows reads against f64.
SIMT_PRECISION = ("G 8 q gain 8 hd 16", "G 8 q gain 8 hd 32", "mla reduced q gain 8")


def simt_rows(torch, chip_smoke, names=SIMT_PRECISION) -> None:
    """The CUDA-core backward's dq, dk and dv against the f64 reference at
    each row of ``names`` (by default ``SIMT_PRECISION``), on
    ``chip_smoke.py``'s inputs and on fresh draws from each seed of
    ``ROW_SEEDS``: the largest |got - ref| / (atol + rtol |ref|) of
    ``ATTN_TOL`` of each, with the count of draws over 1; the route
    asserted by the launch counters."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention.ops import remop_flash_attention

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = chip_smoke.ATTN_TOL["torch.bfloat16"]
    rows = {c[0]: c for c in chip_smoke.BWD_CHECKS}
    draws = check_inputs(torch, chip_smoke, dev, names)
    for name in names:
        found = {w: [] for w in ("dq", "dk", "dv")}
        for label, xs in [("chip_smoke", draws[name])] + [(f"seed {seed}", seeded_inputs(
                torch, dev, rows[name], seed)) for seed in ROW_SEEDS]:
            q, k, v, dout = xs
            with torch.no_grad():
                out = remop_flash_attention(q, k, v)
            runtime.reset_launches()
            got = fab.flash_attention_bwd(q, k, v, out, dout)
            if dict(runtime.launches) != {"flash_attention_bwd": 1,
                                          "flash_attention_bwd_simt": 1}:
                raise RuntimeError(f"{name}: launches {dict(runtime.launches)}, not one simt")
            ref = f64_reference(torch, q, k, v, out, dout, 0.0)
            for w, g, r in zip(found, got, ref):
                found[w].append(round(float(((g.double() - r).abs() / (
                    tol["atol"] + tol["rtol"] * r.abs())).max()), 4))
            del q, k, v, dout, out, got, ref
        print(f"simt rows {name}: against f64 on {len(found['dk'])} draws (chip_smoke's and "
              f"seeds {ROW_SEEDS.start}..{ROW_SEEDS.stop - 1}): " + "; ".join(
                  f"{w} max {max(x)}, {sum(e > 1 for e in x)} over 1" for w, x in found.items())
              + f"; dk {found['dk']}", flush=True)


# Probe builds of csrc/flash_attention_bwd.cu whose P takes its exponent
# another way (--emulate reads each beside the shipped kernel), as edits
# (old text, new text, count) of the source.  The shipped flushing dkdv_tc
# walks form P as 2^((x - lse) log2 e) (p_exponent); "rounded lse log2 e"
# gives them the form every other call keeps, 2^(x log2 e - lse2) with lse2
# = lse * log2 e rounded to f32 once a row (on an H100, G 48's dK at q gain
# 8 missed ATTN_TOL against f64 on seed 37 with it, 1.29x, and read 0.66
# without).
EXPONENT_VARIANTS = {
    "rounded lse log2 e": (
        ("return EXACT ? (x - lse) * kLog2e : fmaf(x, kLog2e, -lse);",
         "return fmaf(x, kLog2e, -lse);", 1),
        ("lse_s[r] = EXACT ? lse : lse * kLog2e;", "lse_s[r] = lse * kLog2e;", 1),
    ),
}


def variant_libraries(names):
    """The backward's library built from each variant of ``names``
    (``EXPONENT_VARIANTS``' edits of this checkout's source, one nvcc each,
    all started together) into the gitignored build directory, loaded."""
    import ctypes
    import shutil

    from repro_torch.kernels import runtime

    src = (runtime.CSRC / "flash_attention_bwd.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new, count in EXPONENT_VARIANTS[name]:
            if text.count(old) != count:
                raise RuntimeError(f"variant {name}: {old!r} found {text.count(old)} times")
            text = text.replace(old, new)
        d = runtime.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention_bwd.cu").write_text(text)
        for header in runtime.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        out = d / "libflash_attention_bwd.so"
        procs[name] = (subprocess.Popen([runtime.nvcc(), *runtime.NVCC_FLAGS, "-o", str(out),
                                         str(d / "flash_attention_bwd.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc exited {proc.returncode}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in runtime.SIGNATURES["flash_attention_bwd"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


@contextlib.contextmanager
def backward_library(lib):
    """``runtime.library("flash_attention_bwd")`` is ``lib`` while the
    context lasts (None: the shipped one)."""
    from repro_torch.kernels import runtime

    saved = runtime.library
    if lib is not None:
        runtime.library = lambda name: lib if name == "flash_attention_bwd" else saved(name)
    try:
        yield
    finally:
        runtime.library = saved


def f64_lse(torch, q, k, prefix=0, softcap=0.0):
    """Each row's log-sum-exp in f64 (causal, the first ``prefix`` keys
    seen by all), on the inputs of :func:`f64_reference`."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    sc = torch.einsum("bhsd,bhtd->bhst", q.double(),
                      k.double().repeat_interleave(g, 1)) / math.sqrt(hd)
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    seen = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    seen[:, :prefix] = True
    return torch.logsumexp(sc.masked_fill(~seen, float("-inf")), -1)


def truncating_add(torch, acc, prods):
    """``acc + sum(prods)`` as a tensor core is modelled to add one group
    of exact products into an f32 accumulator (Fasi, Higham, Mikaitis and
    Pranesh, "Numerical behavior of NVIDIA tensor cores", PeerJ Comput.
    Sci. 2021, measured on earlier cards): every term aligned to the largest
    exponent among them and the accumulator, cut to 24 bits below it
    (towards zero), summed exactly, the sum cut to f32 towards zero.  f64
    in and out; ``prods`` [n, ...]."""
    terms = torch.cat([acc[None], prods])
    top = terms.abs().amax(0)
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-300))) - 23)
    total = (torch.trunc(terms / ulp) * ulp).sum(0)
    ulp = torch.exp2(torch.floor(torch.log2(total.abs().clamp_min(1e-300))) - 23)
    return torch.where(total == 0, total, torch.trunc(total / ulp) * ulp)


def truncated_dk_block(torch, q, k, v, dout, lse, delta, key, split, flush, keys, rows, scale):
    """dK of the key block of ``keys`` keys holding key ``key`` (batch 0, KV
    head 0, no mask but causal), as the tensor-core dkdv forms it, with
    wgmma's accumulation modelled by :func:`truncating_add`: P and dS in
    f32 from the forward's lse (the f32 plan's), dS^T cut into three bf16
    terms, each step's 64 query rows added 16 at a time (hi, mid, lo) into
    accumulators restarted at every flush (``flush`` steps; the flush adds
    them into the CTA's f32 partial, rounded to nearest), the CTAs of
    ``split`` summed in order, times ``scale``, to bf16: ``[keys, hd]``."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    k0 = key // keys * keys
    kb = k[0, 0, k0:k0 + keys].float()
    vb = v[0, 0, k0:k0 + keys].float()
    first = k0 - (k.shape[2] - s)
    first_qb, n_q = max(first, 0) // rows, -(-s // rows) - max(first, 0) // rows
    steps = g * n_q
    k_pos = torch.arange(k0, k0 + kb.shape[0], device=q.device)
    total = torch.zeros(kb.shape[0], hd, dtype=torch.float32, device=q.device)

    def bf(x):
        return x.to(torch.bfloat16).double()

    for z in range(split):
        lo, hi = steps * z // split, steps * (z + 1) // split
        part = None
        for a in range(lo, hi, flush or max(hi - lo, 1)):
            acc = torch.zeros(kb.shape[0], hd, dtype=torch.float64, device=q.device)
            for i in range(a, min(a + (flush or hi - lo), hi)):
                head, q0 = i // n_q, (first_qb + i % n_q) * rows
                qs, ds_ = q[0, head, q0:q0 + rows].float(), dout[0, head, q0:q0 + rows].float()
                sc = kb @ qs.T * scale
                q_pos = torch.arange(q0, q0 + qs.shape[0], device=q.device) + k.shape[2] - s
                p = torch.exp(sc - lse[0, head, q0:q0 + rows][None]).masked_fill(
                    k_pos[:, None] > q_pos[None], 0.0)
                dst = p * (vb @ ds_.T - delta[0, head, q0:q0 + rows][None])
                hi_ = bf(dst)
                mid = bf(dst.double() - hi_)
                low = bf(dst.double() - hi_ - mid)
                qd = qs.double()
                for c in range(0, qs.shape[0], 16):
                    for term in (hi_, mid, low):
                        acc = truncating_add(torch, acc, term[:, c:c + 16].T[:, :, None]
                                             * qd[c:c + 16, None, :])
            part = acc.float() if part is None else part + acc.float()
        total += part
    return (total * scale).to(torch.bfloat16)


def emulate(torch, chip_smoke, name, seeds) -> None:
    """dK of the ``BWD_CHECKS`` row ``name`` against the f64 reference on
    the draws of ``seeds`` (``seeded_inputs``' seeds; -1: chip_smoke's
    draw), each as the largest |got - ref| / (atol + rtol |ref|) of
    ``ATTN_TOL`` and at the shipped kernel's worst entry, for each candidate
    cause of a miss: the shipped tensor-core kernel; the kernel fed the f64
    reference's lse rounded to f32 (the forward's lse); the probe builds of
    ``EXPONENT_VARIANTS`` (P's exponent); the kernel's plan written out in
    f32 on the same inputs, lse and D (``kv_split_partials_plain`` at the
    row's blocks, split and flush, and without the flush, summed in split
    order and rounded to bf16 as ``kv_reduce`` does: f32 sums in the
    kernel's order); and that plan with wgmma's accumulation modelled as
    truncating (``truncated_dk_block``, the worst entry's key block only,
    causal rows)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = chip_smoke.ATTN_TOL["torch.bfloat16"]
    row = next(c for c in chip_smoke.BWD_CHECKS if c[0] == name)
    _, b, h, kv, s, t, hd, hd_v, window, prefix, cap, *_ = row
    mask = dict(window=window, prefix=prefix, softcap=cap)
    keys, bq = fab.plan_bwd_tc_blocks(hd, hd_v, cap > 0)["dkdv"]
    split = fab.bwd_tc_kv_split(b, h, kv, s, t, hd, hd_v, prefix)
    flush = fab.plan_bwd_flush_steps(h // kv, s, bq, prefix)
    scale = 1 / math.sqrt(hd)
    libs = {"kernel": None, **{f"kernel, {v} exponent": lib
                               for v, lib in variant_libraries(EXPONENT_VARIANTS).items()}}
    for seed in seeds:
        q, k, v, dout = (check_inputs(torch, chip_smoke, dev, [name])[name] if seed < 0
                         else seeded_inputs(torch, dev, row, seed))
        out, lse = chip_smoke.forward_with_lse(torch, q, k, v, **mask)
        ref = f64_reference(torch, q, k, v, out, dout, cap, prefix=prefix)[1]
        delta = (dout.float() * out.float()).sum(-1)

        def excess(dk):
            return (dk.double() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())

        found = {}
        for label, lib in libs.items():
            with backward_library(lib):
                found[label] = excess(tc_grads(torch, fab, q, k, v, out, dout, lse, split,
                                               flush, **mask)[1])
        at = tuple(int(x) for x in torch.unravel_index(found["kernel"].argmax(),
                                                       found["kernel"].shape))
        lse64 = f64_lse(torch, q, k, prefix, cap).float()
        found["kernel, f64 lse"] = excess(tc_grads(torch, fab, q, k, v, out, dout, lse64, split,
                                                   flush, **mask)[1])
        del lse64
        for label, steps in (("f32 plan", flush), ("f32 plan, no flush", 0)):
            part = fab.kv_split_partials_plain(q, k, v, dout, lse, delta, split, **mask,
                                               keys=keys, rows=bq, flush_steps=steps)
            total = part[0].clone()
            for z in range(1, split):
                total += part[z]
            found[label] = excess((total[..., :hd] * scale).to(torch.bfloat16))
            del part, total
        k0 = at[2] // keys * keys
        block = None
        if not (window or prefix or cap) and at[0] == 0 and at[1] == 0:
            block = truncated_dk_block(torch, q, k, v, dout, lse, delta, at[2], split, flush,
                                       keys, bq, scale)
            trunc = ((block.double() - ref[0, 0, k0:k0 + keys]).abs()
                     / (tol["atol"] + tol["rtol"] * ref[0, 0, k0:k0 + keys].abs()))
        print(f"emulate {name} seed {seed} kv_split {split} flush steps {flush} blocks "
              f"{(keys, bq)}: ref at {list(at)} {float(ref[at]):.6g}; " + "; ".join(
                  f"{label} max {float(r.max()):.4f} ({int((r > 1).sum())} entries over 1), "
                  f"at the kernel's worst {float(r[at]):.4f}" for label, r in found.items())
              + ("" if block is None else
                 f"; f32 plan, truncating accumulation, keys {k0}..{k0 + keys - 1}: max "
                 f"{float(trunc.max()):.4f}, at the kernel's worst "
                 f"{float(trunc[at[2] - k0, at[3]]):.4f}"),
              flush=True)
        del q, k, v, dout, out, lse, ref, delta, found, block


# (label, plain forward, plain backward, the plain forward's key blocks as a
# multiple of the call's) of --swap's paths, each held to the plain forward
# and backward at the call's key blocks: which half of the flash kernel
# carries the gap, and (the last) how far the plain path moves when its
# forward sums the same f32 softmax in another order.
SWAP_PATHS = (("kernel forward, kernel backward", False, False, 1),
              ("plain forward, kernel backward", True, False, 1),
              ("kernel forward, plain backward", False, True, 1),
              ("plain forward at twice the key blocks, plain backward", True, True, 2))
SWAP_STATES = ("init", "trained")


def swap_case(torch, chip_smoke, dev, arch: str, state: str):
    """(cfg, params, batch) of ``arch``'s whole-model gradient check as
    ``chip_smoke.py`` reads it.  qwen3-0.6b (phase 5h): one [1, 2048] batch
    on the initial weights or on those its fixed-batch steps leave
    (``trained``).  The trainers of phases 8c-8e: their first batch's first
    microbatch on the initial weights or on those their 20 steps leave."""
    import dataclasses

    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig

    if arch == chip_smoke.TRAIN_ARCH:
        args = train_mod.parse_args([*chip_smoke.TRAIN_ARGV, "--device", str(dev)])
        cfg, shape, _, _ = train_mod.setup(args)
        raw = next(synthetic_batches(cfg, dataclasses.replace(shape, global_batch=1), seed=1))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        st = steps_lib.init_state(cfg, torch.Generator(device=dev).manual_seed(chip_smoke.SEED),
                                  dev)
        if state == "trained":
            step_fn = steps_lib.make_train_step(cfg, AdamWConfig(
                lr=3e-3, total_steps=chip_smoke.FIXED_BATCH_STEPS, warmup_steps=2,
                weight_decay=0.0))
            for _ in range(chip_smoke.FIXED_BATCH_STEPS):
                st, _ = step_fn(st, batch)
        return cfg, st["params"], batch
    layers = {a: n for a, n, _ in chip_smoke.MOE_TRAIN_FAMILIES}
    tails = {fam.arch: fam.tail for fam in (chip_smoke.HYBRID_TRAINER, chip_smoke.VLM_TRAINER)}
    if arch not in layers and arch not in tails:
        raise SystemExit(f"flash_probe.py --swap: no trainer of chip_smoke.py trains {arch}")
    argv = chip_smoke.family_argv(arch, layers.get(arch, 0), tails.get(arch))
    args = train_mod.parse_args([*argv, "--device", str(dev)])
    cfg, shape, _, _ = train_mod.setup(args)
    rows = shape.global_batch // args.microbatches
    batch = {k: torch.as_tensor(v[:rows], device=dev)
             for k, v in next(synthetic_batches(cfg, shape, seed=args.seed)).items()}
    if state == "trained":
        params = chip_smoke.train_window(torch, dev, argv)["state"]["params"]
    else:
        params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev,
                                dtype=torch.float32)
    return cfg, params, batch


def swap(torch, chip_smoke, dev, arch: str, state: str) -> None:
    """``arch``'s whole-model gradients (:func:`swap_case`'s weights and
    batch, full remat) on each path of ``SWAP_PATHS`` against the plain
    forward and backward; an MoE decoder's paths all on the kernel path's
    routing (``chip_smoke.RoutingLog``, recorded once, then replayed)."""
    from repro_torch.models import moe

    cfg, params, batch = swap_case(torch, chip_smoke, dev, arch, state)
    log = chip_smoke.RoutingLog(moe._top_k)

    def path(fwd, bwd, blocks):
        @contextlib.contextmanager
        def context():
            log.agree, log.replaying = [], True
            with (chip_smoke.plain_flash_training(fwd, bwd, blocks) if fwd or bwd
                  else contextlib.nullcontext()):
                yield
        return context

    moe._top_k = log
    try:
        chip_smoke.loss_and_grads(torch, cfg, params, batch, contextlib.nullcontext)  # routing
        errors = chip_smoke.path_grad_errors(
            torch, cfg, params, batch, path(True, True, 1), [path(*p[1:]) for p in SWAP_PATHS])
    finally:
        moe._top_k = log.top_k
    for (name, *_), errs in zip(SWAP_PATHS, errors):
        print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers, "weights": state,
                          "tokens": list(batch["tokens"].shape), "path": name,
                          "against": "plain forward, plain backward",
                          "per_leaf_rel_err_max": max(errs.values()),
                          "worst_leaves": sorted(errs.items(), key=lambda kv: -kv[1])[:6]}),
              flush=True)


def f64_forward(torch, q, k, v, prefix=0):
    """The output of causal softmax attention (every query also seeing the
    first ``prefix`` keys) written out in float64 on the same bf16 inputs."""
    g = q.shape[1] // k.shape[1]
    kd, vd = (x.double().repeat_interleave(g, 1) for x in (k, v))
    s, t = q.shape[2], k.shape[2]
    sc = torch.einsum("bhsd,bhtd->bhst", q.double(), kd) / math.sqrt(q.shape[3])
    pos = torch.arange(s, device=q.device)[:, None] + (t - s)
    seen = (torch.arange(t, device=q.device)[None, :] <= pos) | (
        torch.arange(t, device=q.device)[None, :] < prefix)
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(sc.masked_fill(~seen, float("-inf")),
                                                         -1), vd)


def layer_f64(torch, chip_smoke, dev, arch: str, state: str) -> None:
    """Each flash call of ``arch``'s whole-model gradient check (:func:`swap_case`'s
    weights and batch, the kernel path, full remat) held to float64 on its
    own inputs: the forward's output against softmax attention written out
    in f64, the backward's dq, dk and dv against :func:`f64_reference`, each
    as the largest share of ``ATTN_TOL``'s elementwise bound and the relative
    L2 error; a call past ``ATTN_TOL`` (an excess over 1 or a relative L2
    over its 5e-3) is a fault of the kernels.  One line a layer, then the
    worst of each."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab

    cfg, params, batch = swap_case(torch, chip_smoke, dev, arch, state)
    tol = chip_smoke.ATTN_TOL["torch.bfloat16"]
    calls, bwd = [], fab.flash_attention_bwd

    def recording(q, k, v, out, dout, scale, window, prefix, softcap, lse=None):
        if window or softcap:
            raise SystemExit("flash_probe.py --layer-f64 takes causal and prefix calls only")
        got = bwd(q, k, v, out, dout, scale, window, prefix, softcap, lse)
        calls.append((q, k, v, out, dout, prefix, got))
        return got

    def excess(got, ref):
        d = (got.double() - ref).abs()
        return (round(float((d / (tol["atol"] + tol["rtol"] * ref.abs())).max()), 4),
                float(d.norm() / ref.norm()))

    fab.flash_attention_bwd = recording
    try:
        chip_smoke.loss_and_grads(torch, cfg, params, batch, contextlib.nullcontext)
    finally:
        fab.flash_attention_bwd = bwd
    worst = {"forward": (0.0, 0.0), "dq": (0.0, 0.0), "dk": (0.0, 0.0), "dv": (0.0, 0.0)}
    past = []
    # The backward runs the layers last to first.
    for layer, (q, k, v, out, dout, prefix, got) in zip(reversed(range(len(calls))), calls):
        row = {"forward": excess(out, f64_forward(torch, q, k, v, prefix))}
        row.update(zip(("dq", "dk", "dv"), (excess(g, r) for g, r in zip(
            got, f64_reference(torch, q, k, v, out, dout, 0.0, prefix=prefix)))))
        for key, (ex, rel) in row.items():
            worst[key] = (max(worst[key][0], ex), max(worst[key][1], rel))
            if ex > 1 or rel > tol["rel"]:
                past.append([layer, key, ex, rel])
        print(json.dumps({"arch": cfg.name, "weights": state, "layer": layer,
                          "shape": list(q.shape), "prefix": prefix,
                          "excess_and_rel_l2_vs_f64": row}), flush=True)
    print(json.dumps({"arch": cfg.name, "weights": state, "calls": len(calls),
                      "worst_excess_and_rel_l2": worst, "past_attn_tol": past}), flush=True)


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

    if sys.argv[1:2] == ["--layer-f64"]:
        if len(sys.argv) != 4 or sys.argv[3] not in SWAP_STATES:
            print(f"usage: flash_probe.py --layer-f64 ARCH {{{','.join(SWAP_STATES)}}}",
                  file=sys.stderr)
            return 2
        print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
        chip_smoke.load_peaks()
        runtime.build()
        layer_f64(torch, chip_smoke, torch.device("cuda", 0), sys.argv[2], sys.argv[3])
        print("ALL OK", flush=True)
        return 0
    if sys.argv[1:2] == ["--swap"]:
        if len(sys.argv) != 4 or sys.argv[3] not in SWAP_STATES:
            print(f"usage: flash_probe.py --swap ARCH {{{','.join(SWAP_STATES)}}}",
                  file=sys.stderr)
            return 2
        print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
        chip_smoke.load_peaks()
        runtime.build()
        swap(torch, chip_smoke, torch.device("cuda", 0), sys.argv[2], sys.argv[3])
        print("ALL OK", flush=True)
        return 0
    if sys.argv[1:2] == ["--emulate"]:
        if len(sys.argv) != 4:
            print("usage: flash_probe.py --emulate ROW SEED,...", file=sys.stderr)
            return 2
        print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
        chip_smoke.load_peaks()
        runtime.build(["flash_attention", "flash_attention_bwd"])
        emulate(torch, chip_smoke, sys.argv[2], [int(x) for x in sys.argv[3].split(",")])
        print("ALL OK", flush=True)
        return 0
    if sys.argv[1:2] == ["--simt-rows"]:
        print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
        runtime.build(["flash_attention", "flash_attention_bwd"])
        simt_rows(torch, chip_smoke, tuple(sys.argv[2].split(",")) if sys.argv[2:] else
                  SIMT_PRECISION)
        print("ALL OK", flush=True)
        return 0
    if sys.argv[1:2] == ["--bwd-run-rows"]:
        print(torch.__version__, torch.version.cuda, chip_smoke.nvidia_smi(), flush=True)
        chip_smoke.load_peaks()
        runtime.build(["flash_attention", "flash_attention_bwd"])
        if len(sys.argv) == 4:  # one row of BWD_CHECKS under the given flush lengths (0: none)
            row, flush = sys.argv[2], tuple(int(x) for x in sys.argv[3].split(","))
            bwd_run_rows(torch, chip_smoke, (row,), flush, (row,))
        elif sys.argv[2:] == ["planned"]:  # every row at its planned flush only
            bwd_run_rows(torch, chip_smoke, candidates=None)
        else:
            bwd_run_rows(torch, chip_smoke)
        print("ALL OK", flush=True)
        return 0
    args = [a for a in sys.argv[1:] if a != "--bwd"]
    log_dir = Path(args[0]) if args else runtime.BUILD_DIR
    log_dir.mkdir(parents=True, exist_ok=True)
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

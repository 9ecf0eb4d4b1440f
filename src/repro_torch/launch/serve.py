"""Serving driver: greedy decoding with continuous batching.

``python -m repro_torch.launch.serve --arch gemma-2b --no-reduced`` (or
``--arch mamba2-370m``, ``granite-moe-3b-a800m``, ``deepseek-v2-lite-16b``,
``recurrentgemma-2b``) serves the full-width model on ``cuda:0`` (the
default device; it raises without a card); ``--device cpu`` runs the
kernels' plain versions at the default reduced size.  A Mamba-2 prompt is
at most one chunk or a multiple of it (``--prompt-len``); a recurrentgemma
prompt may exceed its window (2048, reduced 32), the local-attention
caches being rings of the window's length.  paligemma-3b and
seamless-m4t-large-v2 are refused, as ``repro``'s ``launch/serve.py``
refuses them: their requests carry patches or encoder frames, which it does
not take (drive ``models.transformer``'s ``prefill`` and ``decode_step``
instead).  Weights are random, drawn from a ``torch.Generator`` seeded with
``--seed`` on the serving device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.runtime.serve_loop import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    cfg = reduced(ARCHS[args.arch]) if args.reduced else ARCHS[args.arch]
    if cfg.family in ("vlm", "audio_encdec"):
        raise SystemExit("serve driver targets decoder-only archs")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(cfg, gen, device)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, args.prompt_len, dtype=np.int32),
                max_new_tokens=args.max_new_tokens)
        for i in range(args.requests)
    ]
    engine = ServeEngine(cfg, params, max_len=args.max_len, batch_slots=args.slots,
                         device=device)
    t0 = time.perf_counter()
    results = engine.submit(reqs)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in results.values())
    for rid in sorted(results):
        print(f"request {rid}: {results[rid]}")
    print(f"{len(results)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {device}")
    return results


if __name__ == "__main__":
    main()

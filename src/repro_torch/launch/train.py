"""Training driver: ``python -m repro_torch.launch.train --arch qwen3-0.6b``.

``repro``'s ``launch/train.py`` on one card: ``--device`` (default
``cuda:0``, which raises without a card; ``cpu`` runs the kernels' plain
versions, as the tests do) and no mesh: ``--production-mesh`` and
``--multi-pod`` raise until the distributed slice.  ``--reduced`` trains
the tiny same-family config (``python -m repro_torch.launch.train --reduced
--device cpu --steps 5``); without it the published widths.  The state is
f32 master parameters and AdamW moments (``steps.init_state``), updated in
place (the step donates them, as ``repro``'s jitted step does), the
activations bf16, each decoder layer rematerialized; weights are random,
drawn from a ``torch.Generator`` seeded with ``--seed`` on the device, and
the batches are ``synthetic_batches`` keyed by ``(seed, step)``, moved by
the ``PrefetchingLoader``.  With ``--ckpt-dir`` the loop saves every
``--checkpoint-every`` steps and at the end.
"""

from __future__ import annotations

import argparse
import logging
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import PrefetchingLoader, synthetic_batches
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import LoopConfig, train


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--reduced-overrides", default="",
                    help="k=v,k=v overrides for the reduced config")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(cfg, shape, AdamW config, device) of a parsed command line."""
    if args.production_mesh or args.multi_pod:
        raise NotImplementedError("--production-mesh and --multi-pod wait for the "
                                  "distributed slice (ROADMAP queue 1 item 3)")
    cfg = ARCHS[args.arch]
    if args.reduced:
        overrides = {}
        for kv in filter(None, args.reduced_overrides.split(",")):
            k, v = kv.split("=")
            overrides[k] = type(getattr(cfg, k))(v)
        cfg = reduced(cfg, **overrides)
    shape = ShapeSpec("cli", seq_len=args.seq_len, global_batch=args.global_batch,
                      kind="train")
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1))
    return cfg, shape, opt_cfg, resolve_device(args.device)


def main(argv=None, metrics_cb: Optional[Callable[[int, Dict], None]] = None):
    """Train; returns (state, losses).  ``metrics_cb(step, metrics)`` is
    also called at every logged step, after the line is printed."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg, shape, opt_cfg, device = setup(args)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                                        donate=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = steps_lib.init_state(cfg, gen, device)

    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    losses = []

    def log_metrics(step, m):
        losses.append(float(m["loss_total"]))
        print(f"step {step}: loss={m['loss_total']:.4f} "
              f"grad_norm={m['grad_norm']:.3f} lr={m['lr']:.2e}", flush=True)
        if metrics_cb is not None:
            metrics_cb(step, m)

    def batches(start_step):
        it = synthetic_batches(cfg, shape, seed=args.seed, start_step=start_step)
        return PrefetchingLoader(it, device=device)

    state = train(
        step_fn, state, batches, store,
        LoopConfig(total_steps=args.steps,
                   checkpoint_every=args.checkpoint_every,
                   log_every=max(args.steps // 20, 1)),
        metrics_cb=log_metrics)
    print(f"done at step {int(state['step'])}; "
          f"final loss {losses[-1] if losses else float('nan'):.4f}")
    return state, losses


if __name__ == "__main__":
    main()

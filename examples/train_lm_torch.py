"""End-to-end driver on the PyTorch port: train a ~100M-parameter
qwen3-family LM for 200 steps (the twin of ``examples/train_lm.py``).

Exercises the port's full training stack: model init (f32 masters), the
flash kernel and its backward (their plain versions on the CPU), AdamW, the
synthetic data pipeline with its prefetching loader, the fault-tolerant
loop with async checkpoints.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]
(``--device`` defaults to ``cuda:0``; use ``--device cpu --steps 20`` for a
quick run on the CPU.)
"""

import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="remop_train_lm_torch_") as ckpt:
        # ~100M params: d_model=512, 8 layers, vocab 32k on the qwen3 family.
        state, losses = train_main([
            "--arch", "qwen3-0.6b",
            "--reduced",
            "--reduced-overrides",
            "d_model=512,n_layers=8,n_heads=8,n_kv_heads=4,head_dim=64,"
            "d_ff=2048,vocab_size=32768",
            "--steps", str(args.steps),
            "--global-batch", "8",
            "--seq-len", "256",
            "--ckpt-dir", ckpt,
            "--checkpoint-every", "50",
            "--lr", "3e-4",
            "--device", args.device,
        ])
    assert losses[-1] < losses[0], "loss should decrease"
    print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} on {args.device}")


if __name__ == "__main__":
    main()

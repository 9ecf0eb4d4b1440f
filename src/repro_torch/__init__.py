"""repro_torch — REMOP (REmote-Memory-aware OPerator Optimization) in PyTorch.

The PyTorch/CUDA port of the spill engine and of LM serving, laid out like
the JAX package so each module has a counterpart of the same name:

  core/     cost model L = D + tau*C, policies (Prop. 4/5/6), memory arbiter
  engine/   shared spill engine: buffer pools, page cursors, transfer
            scheduler, operator/plan registry, eviction, Session, Server
            and the SlotLoop continuous-batching discipline
  remote/   simulated remote-memory tiers, the four operators, and the torch
            execution backend (device pages + CUDA kernels)
  configs/  the architectures (a copy of the JAX package's)
  models/   layers, GQA attention over the flash/paged kernels, Mamba-2's
            SSD block over the scan kernel, the decoder stacks (dense and
            Mamba-2), and params_from_jax
  runtime/  ServeEngine (LM serving over SlotLoop)
  launch/   ``python -m repro_torch.launch.serve``
  kernels/  CUDA C++ kernels for Hopper (``csrc/``), built at first use, each
            with a plain PyTorch version beside it

Host-side modules are numpy.  Device code takes an explicit ``torch.device``:
``None`` means ``cuda:0`` and raises when no card is present; only an
explicit ``device="cpu"`` runs the plain versions on the CPU.
"""

__version__ = "0.1.0"

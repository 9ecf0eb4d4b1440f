"""Training gemma-7b and granite-20b at the reduced config against the JAX
package's, on the CPU.

Neither model had a port test of its own: at ``configs.reduced`` gemma-7b
keeps 4 heads on 2 KV heads with GeGLU and granite-20b 4 heads on one KV
head (its 48 on 1 cut to the reduced 4), both at head width 16, which the
card trains on the CUDA-core flash kernels.  The checks and their bounds
are ``tests/test_torch_train.py``'s (``LOSS_TOL``, ``MODEL_TOL``):

1. The whole model's loss and per-leaf gradients with bf16 activations
   against ``jax.value_and_grad`` of ``repro``'s ``loss_fn``.
2. ``make_train_step`` at ``microbatches`` 1 and 2 against ``repro``'s
   step run without a ``Sharder``, two steps from the same state:
   ``loss_total`` within ``LOSS_TOL``, ``grad_norm`` and each m within
   ``MODEL_TOL``, each v and each leaf's update within ``2 * MODEL_TOL``,
   ``lr`` within 1e-6.
3. ``launch.train.main([..., "--reduced", "--device", "cpu"])`` runs to the
   end with every flash call at head width 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, leaves_with_paths, tree_map

LOSS_TOL = 2e-3
MODEL_TOL = 3e-2
ARCH_NAMES = ["gemma-7b", "granite-20b"]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batch(cfg, seed=3, b=2, s=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return {"tokens": tokens, "targets": tokens}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_reduced_config_keeps_the_family_shape(arch):
    cfg, jcfg = reduced(ARCHS[arch]), jax_reduced(JAX_ARCHS[arch])
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.mlp_type) == (
        jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim, jcfg.mlp_type)
    assert cfg.head_dim == 16 and (cfg.head_dim, cfg.head_dim) in fab.BWD_HEAD_PAIRS
    assert (cfg.head_dim, cfg.head_dim) not in fab.BWD_TC_HEAD_PAIRS


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_loss_and_gradients_match_jax_in_bf16(arch):
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch]), reduced(ARCHS[arch])
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu", torch.float32)
    batch = _batch(cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                              remat=True), has_aux=True)(jparams)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = tf.loss_fn(live, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(live))
    want = leaves(params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, "cpu", torch.float32))
    errs = {"/".join(path): _rel(g.numpy(), w.numpy())
            for (path, _), g, w in zip(leaves_with_paths(live), grads, want)}
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL * float(jloss)
    assert max(errs.values()) <= MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_matches_jax_unsharded(arch, microbatches):
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch]), reduced(ARCHS[arch])
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt), None,
                                           microbatches=microbatches))
    step = steps_lib.make_train_step(cfg, AdamWConfig(**opt), microbatches=microbatches)
    jstate = jsteps.init_state(jcfg, jax.random.key(0))
    state = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    before = [x.clone() for x in leaves(state["params"])]
    for i in range(2):
        batch = _batch(cfg, seed=10 + i, b=4)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm) == {"loss", "aux", "loss_total", "grad_norm", "lr"}
        assert abs(float(m["loss_total"]) - float(jm["loss_total"])) <= LOSS_TOL * float(
            jm["loss_total"])
        assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) <= MODEL_TOL
        assert _rel(float(m["lr"]), float(jm["lr"])) <= 1e-6
    assert int(state["step"]) == int(jstate["step"]) == 2
    want = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    for got, ref, p0 in zip(leaves(state["params"]), leaves(want["params"]), before):
        assert _rel((got - p0).numpy(), (ref - p0).numpy()) <= 2 * MODEL_TOL
    for name, tol in (("m", MODEL_TOL), ("v", 2 * MODEL_TOL)):
        for got, ref in zip(leaves(state["opt"][name]), leaves(want["opt"][name])):
            assert _rel(got.numpy(), ref.numpy()) <= tol, name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launch_train_reduced_runs_to_the_end(arch):
    state, losses = train_mod.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                                    "3", "--global-batch", "2", "--seq-len", "32",
                                    "--checkpoint-every", "1000"])
    assert int(state["step"]) == 3 and len(losses) == 3
    assert all(np.isfinite(losses))

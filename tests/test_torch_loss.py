"""The loss and the active-parameter count against the JAX package, on the CPU.

``layers.softmax_xent`` (f32 logsumexp, token mean, optional mask) is held
to ``repro``'s within 1e-6 of its value on the same logits; ``transformer.
loss_fn``'s forward value (next-token cross entropy, the VLM's patch
positions dropped, plus ``router_aux_coef`` times the MoE aux loss) within
1e-2 of ``repro``'s, relative, at reduced gemma-2b, paligemma-3b and
granite-moe-3b-a800m with ``repro``'s weights (the logits agree to bf16
precision, 1e-2 of their scale; the loss averages them); the aux loss
within 1e-3, relative; ``active_param_count`` exactly, at reduced
granite-moe (experts counted at top-k / E) and at reduced gemma-2b (every
parameter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.models import layers as jlayers
from repro.models import transformer as jtf

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax

XENT_TOL = 1e-6
LOSS_TOL = 1e-2
AUX_TOL = 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(dtype, masked):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7), dtype=np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = float(jlayers.softmax_xent(jnp.asarray(logits).astype(jdt), jnp.asarray(labels),
                                      None if mask is None else jnp.asarray(mask)))
    got = layers.softmax_xent(torch.from_numpy(logits).to(tdt), torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= XENT_TOL * abs(want)


def test_softmax_xent_with_an_empty_mask_is_zero():
    logits = torch.randn(2, 3, 5)
    labels = torch.zeros(2, 3, dtype=torch.int64)
    got = layers.softmax_xent(logits, labels, torch.zeros(2, 3))
    want = jlayers.softmax_xent(jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy()),
                                jnp.zeros((2, 3)))
    assert float(got) == float(want) == 0.0


def _models(arch, **over):
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch], **over), reduced(ARCHS[arch], **over)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, seed, masked):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)}
    arrays["targets"] = arrays["tokens"]
    if masked:
        arrays["mask"] = (rng.random((2, 15)) < 0.7).astype(np.float32)
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal((2, cfg.frontend_seq, cfg.frontend_dim)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ["gemma-2b", "paligemma-3b", "granite-moe-3b-a800m"])
def test_loss_fn_matches_jax(arch, masked, monkeypatch):
    monkeypatch.setattr(jtf, "_UNROLL", True)
    jcfg, jparams, cfg, params = _models(arch, n_layers=2)
    jbatch, batch = _batch(cfg, 3, masked)
    jtotal, jparts = jtf.loss_fn(jparams, jcfg, jbatch, remat=False)
    total, parts = tf.loss_fn(params, cfg, batch)
    assert set(parts) == set(jparts) == {"loss", "aux"}
    assert abs(float(parts["loss"]) - float(jparts["loss"])) <= LOSS_TOL * float(jparts["loss"])
    assert abs(float(parts["aux"]) - float(jparts["aux"])) <= AUX_TOL * max(
        abs(float(jparts["aux"])), 1e-6)
    assert abs(float(total) - float(jtotal)) <= LOSS_TOL * float(jtotal)
    torch.testing.assert_close(total, parts["loss"] + cfg.router_aux_coef * parts["aux"],
                               rtol=0, atol=0)
    assert (float(parts["aux"]) > 0) == (cfg.family == "moe")
    if cfg.family == "vlm":  # the patch positions carry no loss
        logits, _, _ = tf.forward(params, cfg, batch)
        want = layers.softmax_xent(logits[:, cfg.frontend_seq:-1], batch["targets"][:, 1:],
                                   batch.get("mask"))
        torch.testing.assert_close(parts["loss"], want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "gemma-2b", "deepseek-v2-lite-16b"])
def test_active_param_count_matches_jax(arch):
    jcfg, jparams, cfg, params = _models(arch)
    got, want = tf.active_param_count(params, cfg), jtf.active_param_count(jparams, jcfg)
    assert got == want
    if cfg.n_experts:
        assert got < tf.param_count(params)
    else:
        assert got == tf.param_count(params)

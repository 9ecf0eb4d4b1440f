"""AdamW against the JAX package's, on the CPU.

``schedule``, ``global_norm``, ``clip_by_global_norm``, ``init_opt_state``
and ``adamw_update`` of ``repro_torch.optim.adamw`` against ``repro``'s on
the same f32 trees (a model's parameter tree carried over by
``convert.params_from_jax`` and gradients drawn with numpy): scalars within
``TOL`` = 1e-6 relative, every element of a tree within ``TOL`` of its
leaf's largest magnitude (an update ``p - lr * delta`` that nearly cancels
keeps the one-ulp differences of its terms, which XLA may fuse otherwise).  ``repro``'s quadratic-convergence test runs on the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw

from repro_torch.configs import ARCHS, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.tree import leaves

TOL = 1e-6


def _trees(seed=0, grad_scale=1.0):
    """(jax params, jax grads, port params, port grads) of reduced qwen3-0.6b."""
    cfg = jax_reduced(JAX_ARCHS["qwen3-0.6b"])
    jparams = jtf.init_params(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    jgrads = jax.tree.map(
        lambda p: jnp.asarray((rng.standard_normal(p.shape) * grad_scale).astype(np.float32)),
        jparams)
    port = reduced(ARCHS["qwen3-0.6b"])
    to_port = lambda t: params_from_jax(jax.tree.map(np.asarray, t), port, "cpu",  # noqa: E731
                                        torch.float32)
    return jparams, jgrads, to_port(jparams), to_port(jgrads), to_port


def _close(got, want, tol=TOL):
    """Scalars within ``tol`` relative; arrays elementwise within ``tol`` of
    their largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want) if want.ndim == 0 else np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol * max(scale, 1e-30)), (
        float(np.max(np.abs(got - want))), float(scale))


@pytest.mark.parametrize("warmup,total,min_frac", [(100, 10_000, 0.1), (2, 30, 0.1),
                                                    (0, 200, 1.0), (5, 5, 0.0)])
def test_schedule_matches_jax(warmup, total, min_frac):
    cfg = dict(lr=3e-3, warmup_steps=warmup, total_steps=total, min_lr_frac=min_frac)
    for step in (0, 1, 2, warmup, warmup + 1, total // 2, total - 1, total, total + 7):
        want = float(jadamw.schedule(jadamw.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32)))
        got = adamw.schedule(adamw.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(float(got), want)


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0, 30.0])
def test_global_norm_and_clip_match_jax(grad_scale):
    _, jgrads, _, grads, to_port = _trees(1, grad_scale)
    _close(float(adamw.global_norm(grads)), float(jadamw.global_norm(jgrads)))
    jclipped, jnorm = jadamw.clip_by_global_norm(jgrads, 1.0)
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    _close(float(norm), float(jnorm))
    for got, want in zip(leaves(clipped), leaves(to_port(jclipped))):
        _close(got.numpy(), want.numpy())
    assert (float(norm) > 1.0) == (grad_scale > 1e-3)


def test_init_opt_state_is_zeros_in_f32():
    _, _, params, _, _ = _trees()
    opt = adamw.init_opt_state(params)
    assert set(opt) == {"m", "v"}
    for tree in opt.values():
        assert all(x.dtype == torch.float32 and not x.any() for x in leaves(tree))
        assert [x.shape for x in leaves(tree)] == [x.shape for x in leaves(params)]


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_jax_over_steps(weight_decay):
    """Three updates from the same trees: params, m, v, grad_norm and lr
    within ``TOL`` after each; the inputs are left as they were."""
    jparams, jgrads, params, grads, to_port = _trees(2, 3.0)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=weight_decay)
    jopt, opt = jadamw.init_opt_state(jparams), adamw.init_opt_state(params)
    before = [x.clone() for x in leaves(params)]
    for step in range(3):
        jparams, jopt, jm = jadamw.adamw_update(jadamw.AdamWConfig(**cfg), jparams, jgrads, jopt,
                                                jnp.asarray(step, jnp.int32))
        new, opt, m = adamw.adamw_update(adamw.AdamWConfig(**cfg), params, grads, opt,
                                         torch.tensor(step, dtype=torch.int32))
        if step == 0:
            assert all(torch.equal(a, b) for a, b in zip(leaves(params), before))
        params = new
        _close(float(m["grad_norm"]), float(jm["grad_norm"]))
        _close(float(m["lr"]), float(jm["lr"]))
        for got, want in zip(leaves({"p": params, "o": opt}),
                             leaves({"p": to_port(jparams),
                                     "o": {k: to_port(jopt[k]) for k in ("m", "v")}})):
            _close(got.numpy(), want.numpy())


def test_a_dropped_decay_misses_the_bound():
    """An update that leaves out the decoupled decay (``lr * wd * p``, 1e-3
    of p here) against ``repro``'s with it: the bound sees it at once."""
    jparams, jgrads, params, grads, to_port = _trees(2, 3.0)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jopt = jadamw.init_opt_state(jparams)
    for step in range(2):
        jparams, jopt, _ = jadamw.adamw_update(jadamw.AdamWConfig(**cfg, weight_decay=0.1),
                                               jparams, jgrads, jopt,
                                               jnp.asarray(step, jnp.int32))
    opt = adamw.init_opt_state(params)
    for step in range(2):
        params, opt, _ = adamw.adamw_update(adamw.AdamWConfig(**cfg, weight_decay=0.0), params,
                                            grads, opt, torch.tensor(step, dtype=torch.int32))
    with pytest.raises(AssertionError):
        for got, want in zip(leaves(params), leaves(to_port(jparams))):
            _close(got.numpy(), want.numpy())


def test_adamw_quadratic_convergence():
    """``tests/test_runtime.py``'s convergence test on the port."""
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200,
                            min_lr_frac=1.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = adamw.init_opt_state(params)
    step = torch.zeros((), dtype=torch.int32)
    for _ in range(200):
        grads = {"x": 2 * params["x"]}
        params, opt, _ = adamw.adamw_update(cfg, params, grads, opt, step)
        step = step + 1
    assert float(params["x"].abs().max()) < 0.05

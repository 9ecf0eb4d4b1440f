"""Training the MoE decoder (granite-moe-3b-a800m, reduced) against the JAX
package's, on the CPU.

Routing comes first.  Two paths that differ in the router product's last
bit can route a near-tie differently, and every gradient downstream then
differs by far more than any tolerance; so each check records the expert
ids of every top-k both packages take (``repro``'s through a
``jax.debug.callback`` on ``jax.lax.top_k``, which fires inside ``jit``,
``scan``, ``grad`` and ``checkpoint``; the port's by wrapping
``moe._top_k``) and asserts them equal, call for call, before it compares
anything.  Under full remat both run each layer's forward again in the
backward pass, in reverse layer order, and that recompute must route as
the first forward did (asserted too).

1. One MoE block's parameter and input gradients with f32 activations, the
   block's aux loss added to its output's product with a fixed weight,
   against ``jax.grad`` of ``repro``'s ``block_forward``: ``BLOCK_TOL``
   per leaf.  This holds the top-k values' gradient, the combine weights,
   the Switch aux loss's gradient through the mean of ``probs`` only and
   the dense dispatch.
2. The whole model's loss, aux and per-leaf gradients with bf16 activations
   (f32 masters, full remat, ``router_aux_coef * aux`` in the loss)
   against ``jax.value_and_grad`` of ``repro``'s ``loss_fn``: ``LOSS_TOL``
   and ``MODEL_TOL``; also with a dense first block and a
   ``capacity_factor`` of 1, where drops are asserted to occur (a dropped
   assignment gets no gradient in either package).
3. ``make_train_step`` at ``microbatches`` 1 and 2 (each microbatch its own
   aux) against ``repro``'s step run without a ``Sharder``, two steps from
   one state carried over by ``state_from_jax``.
4. Remat off, full and ``"dots"``: the same gradients bit for bit, and the
   recompute's routing equal to the forward's.
5. ``launch.train.main([..., "--arch", ARCH, "--reduced", "--device",
   "cpu"])`` runs to the end.
6. A planted fault the checks must reject: the combine weights detached
   from the router (its gradient then comes from the aux loss alone).
7. The in-place AdamW of the donating step (``adamw_update_``, the one
   ``launch.train`` steps with) equals the pure update bit for bit.

Tolerances are ``test_torch_train.py``'s.  The JAX model runs without a
``Sharder`` (its sharded step is red under jax 0.9.0).
"""

import contextlib

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
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_mod
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.convert import _segments, params_from_jax, state_from_jax
from repro_torch.optim.adamw import AdamWConfig, adamw_update, adamw_update_
from repro_torch.tree import leaves, leaves_with_paths, tree_map

from test_torch_train import BLOCK_TOL, LOSS_TOL, MODEL_TOL, _rel

ARCH = "granite-moe-3b-a800m"
# A dense first block and capacity_factor 1: cap = S * k / E = S / 2 rows an
# expert, which the random init's imbalance overflows.
DROPS = {"first_k_dense": 1, "capacity_factor": 1.0}
# Batch seeds at which every top-k of the two packages agrees (at seeds 3
# and 4 under DROPS, and 10 for the steps, one of the 128 assignments of
# the second MoE call is a near-tie the packages' last bits route apart:
# assert_same_routing stops the check there, as it must).
MODEL_SEEDS = {"moe": 3, "dense first, drops": 5}
STEP_SEED = 12


def models(arch, over=None):
    """(jcfg, jax params, cfg, the port's f32 params carried over)."""
    over = over or {}
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch], **over), reduced(ARCHS[arch], **over)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu", torch.float32)
    return jcfg, jparams, cfg, params


def jax_layer(jparams, cfg, layer):
    """Layer ``layer``'s block of ``repro``'s stacked tree, in the port's
    layer order (``params_from_jax``'s)."""
    i = 0
    for seg, blocks, repeats in _segments(cfg):
        for rep in range(repeats):
            for block in blocks:
                if i == layer:
                    return jax.tree.map(lambda a: a[rep], jparams[seg][block])
                i += 1
    raise IndexError(layer)


def live(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


@contextlib.contextmanager
def jax_routing():
    """The ids of every ``jax.lax.top_k`` ``repro`` runs while the context
    lasts, in the order they run (a debug callback, so jitted, scanned and
    rematerialized calls report too)."""
    calls, top_k = [], jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda ids: calls.append(np.asarray(ids)), out[1])
        return out

    jax.clear_caches()
    jax.lax.top_k = recording
    try:
        yield calls
    finally:
        jax.effects_barrier()
        jax.lax.top_k = top_k
        jax.clear_caches()


@contextlib.contextmanager
def port_routing():
    """The port's routing while the context lasts: the ids of every
    ``moe._top_k`` call, and the assignments each dense dispatch dropped."""
    calls, drops = [], []
    top_k, dispatch = moe._top_k, moe.dispatch_dense

    def recording(probs, k):
        values, ids = top_k(probs, k)
        calls.append(ids.detach().numpy().copy())
        return values, ids

    def counting(x, ids, n_experts, cap):
        out = dispatch(x, ids, n_experts, cap)
        drops.append(int((~out[1]).sum()))
        return out

    moe._top_k, moe.dispatch_dense = recording, counting
    try:
        yield calls, drops
    finally:
        moe._top_k, moe.dispatch_dense = top_k, dispatch


def assert_same_routing(got, want, n_moe, remat):
    """Equal ids call for call; under remat the calls are the forward's
    (layer order) then the recompute's (reverse order), which must agree."""
    assert len(got) == len(want) == n_moe * (2 if remat else 1), (len(got), len(want))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if remat:
        for fwd, again in zip(got[:n_moe], reversed(got[n_moe:])):
            np.testing.assert_array_equal(fwd, again)


def n_moe_layers(cfg):
    return sum(tf.is_moe_layer(cfg, i) for i in range(cfg.n_layers))


def block_errors(arch, layer, over=None):
    """Per-leaf relative L2 of one block's parameter and input gradients in
    f32 (its output's product with a fixed weight, plus its aux loss),
    the port's against ``jax.grad`` of ``repro``'s ``block_forward``, the
    routing asserted equal first."""
    jcfg, jparams, cfg, params = models(arch, over)
    kind = tf.layer_kinds(cfg)[layer]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))

    def jloss(p, xx):
        out, _, aux = jtf.block_forward(p, jcfg, kind, xx, jnp.asarray(pos), jnp.asarray(pos))
        return jnp.sum(out * w) + aux

    with jax_routing() as jids:
        jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax_layer(jparams, cfg, layer),
                                                   jnp.asarray(x))
    block = live(params["layers"][layer])
    xt = torch.from_numpy(x).requires_grad_()
    with port_routing() as (ids, _):
        out, _, aux = tf.block_forward(block, cfg, kind, xt, torch.from_numpy(pos.copy()))
        total = (out * torch.from_numpy(w)).sum() + (0 if aux is None else aux)
        grads = torch.autograd.grad(total, leaves(block) + [xt])
    assert_same_routing(ids, jids, int(tf.is_moe_layer(cfg, layer)), remat=False)
    want = leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgx)]
    assert len(grads) == len(want)
    names = ["/".join(p) for p, _ in leaves_with_paths(block)] + ["x"]
    return {n: _rel(g.numpy(), w_) for n, g, w_ in zip(names, grads, want)}


def batch_of(cfg, seed=3, b=2, s=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return {"tokens": tokens, "targets": tokens}


def model_errors(arch, over=None, seed=3):
    """(loss's relative error, aux's, per-leaf gradient errors, drops) of
    the whole model with bf16 activations under full remat, the port's
    ``loss_fn`` against ``jax.value_and_grad`` of ``repro``'s, the routing
    (forward and recompute) asserted equal first."""
    jcfg, jparams, cfg, params = models(arch, over)
    batch = batch_of(cfg, seed)
    with jax_routing() as jids:
        (jloss, jm), jgrads = jax.value_and_grad(
            lambda p: jtf.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                  remat=True), has_aux=True)(jparams)
    tree = live(params)
    with port_routing() as (ids, drops):
        loss, m = tf.loss_fn(tree, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves(tree))
    assert_same_routing(ids, jids, n_moe_layers(cfg), remat=True)
    want = leaves(params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, "cpu", torch.float32))
    errs = {"/".join(path): _rel(g.numpy(), w.numpy())
            for (path, _), g, w in zip(leaves_with_paths(tree), grads, want)}
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))  # noqa: E731
    return rel(loss.detach(), jloss), rel(m["aux"].detach(), jm["aux"]), errs, sum(drops)


@pytest.fixture
def detached_combine(monkeypatch):
    """The combine weights detached from the router: the top-k values (and
    so the router) get no gradient from the output, only from the aux loss."""
    normalise = moe._normalise

    def plant():
        monkeypatch.setattr(moe, "_normalise", lambda w: normalise(w).detach())

    return plant


def test_block_gradients_match_jax_in_f32():
    errs = block_errors(ARCH, 0)
    assert max(errs.values()) <= BLOCK_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert "moe/router/w" in errs and "moe/experts/w_gate" in errs


def test_block_check_rejects_combine_weights_detached_from_the_router(detached_combine):
    detached_combine()
    errs = block_errors(ARCH, 0)
    assert errs["moe/router/w"] > 100 * BLOCK_TOL


@pytest.mark.parametrize("over", [None, DROPS], ids=["moe", "dense first, drops"])
def test_model_loss_and_gradients_match_jax_in_bf16(over):
    loss_err, aux_err, errs, drops = model_errors(
        ARCH, over, MODEL_SEEDS["dense first, drops" if over else "moe"])
    assert loss_err <= LOSS_TOL and aux_err <= LOSS_TOL, (loss_err, aux_err)
    assert max(errs.values()) <= MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    # cf 4 keeps every assignment (cap 2 S); cf 1 must drop some, under remat
    # in both the forward and its recompute.
    assert (drops > 0) == (over is DROPS), drops


def test_model_check_rejects_combine_weights_detached_from_the_router(detached_combine):
    detached_combine()
    _, _, errs, _ = model_errors(ARCH)
    assert max(v for k, v in errs.items() if k.endswith("router/w")) > 3 * MODEL_TOL


def train_step_errors(arch, microbatches, over=None, seed=STEP_SEED, steps=2):
    """Two steps of ``make_train_step`` against ``repro``'s unsharded jitted
    step from one state: the routing of every call asserted equal, then the
    metrics and the state compared as ``test_torch_train.py`` compares them."""
    over = over or {}
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch], **over), reduced(ARCHS[arch], **over)
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt), None,
                                           microbatches=microbatches))
    step = steps_lib.make_train_step(cfg, AdamWConfig(**opt), microbatches=microbatches)
    jstate = jsteps.init_state(jcfg, jax.random.key(0))
    state = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    before = [x.clone() for x in leaves(state["params"])]
    for i in range(steps):
        batch = batch_of(cfg, seed=seed + i, b=4)
        with jax_routing() as jids:
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            jax.block_until_ready(jstate)
        with port_routing() as (ids, _):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        # Each microbatch: its forward, then its recompute.
        n = n_moe_layers(cfg)
        assert len(ids) == len(jids) == 2 * n * microbatches
        for j in range(microbatches):
            part = slice(2 * n * j, 2 * n * (j + 1))
            assert_same_routing(ids[part], jids[part], n, remat=True)
        assert set(m) == set(jm) == {"loss", "aux", "loss_total", "grad_norm", "lr"}
        for key in ("loss_total", "aux"):
            assert abs(float(m[key]) - float(jm[key])) <= LOSS_TOL * abs(float(jm[key])), key
        assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) <= MODEL_TOL
        assert _rel(float(m["lr"]), float(jm["lr"])) <= 1e-6
    assert int(state["step"]) == int(jstate["step"]) == steps
    want = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    for got, ref, p0 in zip(leaves(state["params"]), leaves(want["params"]), before):
        assert _rel((got - p0).numpy(), (ref - p0).numpy()) <= 2 * MODEL_TOL
    for name, tol in (("m", MODEL_TOL), ("v", 2 * MODEL_TOL)):
        for got, ref in zip(leaves(state["opt"][name]), leaves(want["opt"][name])):
            assert _rel(got.numpy(), ref.numpy()) <= tol, name


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_unsharded(microbatches):
    train_step_errors(ARCH, microbatches)


def remat_results(arch, over=None):
    """Loss and gradients under remat off, full and ``"dots"``, and the
    routing of each run."""
    _, _, cfg, params = models(arch, over)
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg).items()}
    results = []
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        tf.set_remat_policy(policy)
        try:
            tree = live(params)
            with port_routing() as (ids, _):
                loss, _ = tf.loss_fn(tree, cfg, batch, remat=remat)
                grads = torch.autograd.grad(loss, leaves(tree))
            results.append((loss.detach(), grads, ids))
        finally:
            tf.set_remat_policy(None)
    return cfg, results


@pytest.mark.parametrize("over", [None, DROPS], ids=["moe", "dense first, drops"])
def test_remat_policies_give_equal_gradients_and_routing(over):
    cfg, results = remat_results(ARCH, over)
    n = n_moe_layers(cfg)
    assert len(results[0][2]) == n
    for loss, grads, ids in results[1:]:
        assert torch.equal(loss, results[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, results[0][1]))
        assert len(ids) == 2 * n
        for got, want in zip(ids[:n], results[0][2]):
            np.testing.assert_array_equal(got, want)
        for fwd, again in zip(ids[:n], reversed(ids[n:])):
            np.testing.assert_array_equal(fwd, again)


def test_launch_train_runs_the_moe_family_to_the_end(tmp_path, capsys):
    state, losses = train_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                                    "--steps", "4", "--global-batch", "2", "--seq-len", "16",
                                    "--checkpoint-every", "2", "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 4 and len(losses) == 4
    assert all(np.isfinite(losses))
    assert "done at step 4" in capsys.readouterr().out


def test_in_place_adamw_equals_the_pure_update():
    """``adamw_update_`` (the donating step's) writes the pure update's bits
    into the state's own tensors, with clipping at work (norm above 1)."""
    _, _, cfg, params = models(ARCH, DROPS)
    gen = torch.Generator().manual_seed(4)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    opt = {"m": tree_map(lambda p: torch.randn(p.shape, generator=gen) * 1e-2, params),
           "v": tree_map(lambda p: torch.rand(p.shape, generator=gen) * 1e-3, params)}
    step = torch.tensor(3, dtype=torch.int32)
    cfg_opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    want_p, want_opt, want_m = adamw_update(cfg_opt, params, grads, opt, step)
    tree = tree_map(torch.clone, {"p": params, "m": opt["m"], "v": opt["v"]})
    ptrs = [t.data_ptr() for t in leaves(tree)]
    got_p, got_opt, got_m = adamw_update_(cfg_opt, tree["p"], grads,
                                          {"m": tree["m"], "v": tree["v"]}, step)
    assert [t.data_ptr() for t in leaves({"p": got_p, **got_opt})] == ptrs
    assert float(want_m["grad_norm"]) > 1.0
    for key in ("grad_norm", "lr"):
        assert torch.equal(got_m[key], want_m[key])
    for got, want in zip(leaves({"p": got_p, **got_opt}), leaves({"p": want_p, **want_opt})):
        assert torch.equal(got, want)


def test_the_donating_step_equals_the_pure_step():
    """``launch.train``'s step (``donate=True``) gives the pure step's state and
    metrics bit for bit, in the state's own tensors."""
    cfg = reduced(ARCHS[ARCH], **DROPS)
    opt = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg, b=4).items()}
    states = [steps_lib.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
              for _ in range(2)]
    ptrs = [t.data_ptr() for t in leaves(states[1]["params"])]
    want, wm = steps_lib.make_train_step(cfg, opt, microbatches=2)(states[0], batch)
    got, gm = steps_lib.make_train_step(cfg, opt, microbatches=2, donate=True)(states[1], batch)
    assert [t.data_ptr() for t in leaves(got["params"])] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    assert all(torch.equal(gm[k], wm[k]) for k in wm)

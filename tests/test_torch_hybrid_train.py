"""Training the RG-LRU hybrid (recurrentgemma-2b, reduced) against the JAX
package's, on the CPU.

The reduced config is one Griffin period, ``("rec", "rec", "attn_local")``:
d_model 64, lru_width 64, 4 query heads on 1 KV head of 16, window 32.
Every check runs at S = 80, past the window, so the local layer's
attention hides keys (``q_pos - k_pos >= 32``) and under grad goes through
``FlashAttentionFn`` with ``window = 32`` (its plain backward here; on the
card the tensor-core backward).  The RG-LRU trains through autograd of
``models/rglru.py``: the conv, the gates and the transcribed
``associative_scan``, which writes its levels into ``new_empty`` slices.

1. Each block's (``"rec"`` and ``"attn_local"``) parameter and input
   gradients with f32 activations against ``jax.grad`` of ``repro``'s
   ``block_forward``: ``BLOCK_TOL`` per leaf (measured 5e-7..1e-6).
2. The whole model's loss and per-leaf gradients with bf16 activations
   under full remat against ``jax.value_and_grad`` of ``repro``'s
   ``loss_fn``: ``LOSS_TOL`` and ``MODEL_TOL`` (the worst leaves are the
   RG-LRU's, 1.5-1.9% on batch seeds 3-5: bf16 roundings of the two
   packages' derivative rules; a sigmoid with JAX's rule for
   ``lax.logistic``, ``g * s * (1 - s)``, in place of autograd's through
   ``1 / (1 + exp(-x))`` moved them by -0.1 to +0.2%, so the port keeps
   autograd's); every flash backward the model takes carries ``window =
   cfg.window``, one a local layer.
3. ``make_train_step`` at ``microbatches`` 1 and 2 against ``repro``'s step
   run without a ``Sharder``, two steps from one state: ``loss_total``,
   ``grad_norm``, ``lr``, each leaf's m and v as ``test_torch_train.py``
   holds them, and the whole parameter update (relative L2 over every leaf;
   measured 2.5%) within ``2 * MODEL_TOL``.  Leaf by leaf the update is no
   check here: on layer 1's conv weights (256 values) Adam's m / sqrt(v)
   turns the bf16 noise of a few near-zero gradient entries (v ~ 3e-11)
   into sign flips of a full learning rate, so that leaf's update reads
   7.8-10.5% against ``repro``'s jitted step while its m and v read 1.7%, and
   ``repro``'s own step run op by op (unjitted, ``_UNROLL``) reads 7.5%
   there against its jitted one.
4. Remat off, full and ``"dots"``: the same gradients bit for bit.
5. ``launch.train.main([..., "--arch", ARCH, "--reduced", "--device",
   "cpu", "--seq-len", "80"])`` runs to the end.
6. Planted faults the checks must reject: a flash backward handed
   ``window = 0`` (check 2), and an RG-LRU whose recurrence gate ``a`` is
   detached from the recursion (check 1).
7. The flash backward counts its launches by mask kind, as the forward
   does (``flash_attention_bwd_windowed``, ``_prefix``, ``_full``), through
   a stand-in library.
8. The in-place AdamW of ``launch.train``'s step updates a leaf a slice at
   a time (so that its temporaries stay small beside the full-width
   state); at slices that cut every leaf unevenly it still writes the pure
   update's bits.

The JAX gradients are computed once a module (fixtures).  Tolerances are
``test_torch_train.py``'s.  ``PYTHONPATH=src python
tests/test_torch_hybrid_train.py`` prints the measurements quoted here.
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
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_mod
from repro_torch.models import rglru as rec_mod
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, leaves_with_paths, tree_map

import test_torch_moe_train as moe_train
from test_torch_flash_bwd_tc import _FakeLibrary, _bf16, fake_card  # noqa: F401
from test_torch_train import BLOCK_TOL, LOSS_TOL, MODEL_TOL, _rel

ARCH = "recurrentgemma-2b"
SEQ = 80  # past the reduced window of 32
LAYERS = {"rec": 0, "attn_local": 2}


@pytest.fixture(scope="module")
def models():
    return moe_train.models(ARCH)


@pytest.fixture
def flash_windows(monkeypatch):
    """The ``window`` of every flash backward call."""
    calls, bwd = [], fab.flash_attention_bwd

    def spying(q, k, v, out, dout, scale, window, *args):
        calls.append(window)
        return bwd(q, k, v, out, dout, scale, window, *args)

    monkeypatch.setattr(fab, "flash_attention_bwd", spying)
    return calls


@pytest.fixture
def window_zero(monkeypatch):
    """A flash backward handed ``window = 0`` after a windowed forward."""
    bwd = fab.flash_attention_bwd

    def plant():
        monkeypatch.setattr(fab, "flash_attention_bwd",
                            lambda q, k, v, out, dout, scale, window, *args: bwd(
                                q, k, v, out, dout, scale, 0, *args))

    return plant


@pytest.fixture
def detached_gate(monkeypatch):
    """The RG-LRU's recurrence gate ``a`` detached where the scan takes it:
    the recursion's gradient no longer reaches ``a_param`` or ``a_gate``."""
    gates = rec_mod._gates

    def plant():
        def detached(p, xb):
            a, gated = gates(p, xb)
            return a.detach(), gated

        monkeypatch.setattr(rec_mod, "_gates", detached)

    return plant


def _block_inputs(cfg):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (2, SEQ))
    return x, w, pos


@pytest.fixture(scope="module")
def jax_block_grads(models):
    """``jax.grad`` of each block's output against a fixed weight, f32."""
    jcfg, jparams, cfg, _ = models
    x, w, pos = _block_inputs(cfg)
    out = {}
    for kind, layer in LAYERS.items():
        def jloss(p, xx, kind=kind):
            y, _, _ = jtf.block_forward(p, jcfg, kind, xx, jnp.asarray(pos), jnp.asarray(pos))
            return jnp.sum(y * w)

        jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
            moe_train.jax_layer(jparams, cfg, layer), jnp.asarray(x))
        out[kind] = leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgx)]
    return out


def _block_errors(models, jax_block_grads, kind):
    _, _, cfg, params = models
    assert tf.layer_kinds(cfg)[LAYERS[kind]] == kind
    x, w, pos = _block_inputs(cfg)
    block = moe_train.live(params["layers"][LAYERS[kind]])
    xt = torch.from_numpy(x).requires_grad_()
    out, _, _ = tf.block_forward(block, cfg, kind, xt, torch.from_numpy(pos.copy()))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves(block) + [xt])
    want = jax_block_grads[kind]
    assert len(grads) == len(want)
    names = ["/".join(p) for p, _ in leaves_with_paths(block)] + ["x"]
    return {n: _rel(g.numpy(), w_) for n, g, w_ in zip(names, grads, want)}


@pytest.mark.parametrize("kind", list(LAYERS))
def test_block_gradients_match_jax_in_f32(models, jax_block_grads, flash_windows, kind):
    errs = _block_errors(models, jax_block_grads, kind)
    assert max(errs.values()) <= BLOCK_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert ("rec/a_param" in errs) == (kind == "rec")
    assert flash_windows == ([32] if kind == "attn_local" else [])


def test_block_check_rejects_a_detached_recurrence_gate(models, jax_block_grads, detached_gate):
    detached_gate()
    errs = _block_errors(models, jax_block_grads, "rec")
    assert errs["rec/a_param"] > 100 * BLOCK_TOL and errs["rec/a_gate/w"] > 100 * BLOCK_TOL


def _batch(cfg, seed=3, b=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, SEQ), dtype=np.int32)
    return {"tokens": tokens, "targets": tokens}


@pytest.fixture(scope="module")
def jax_model_grads(models):
    """``jax.value_and_grad`` of ``repro``'s ``loss_fn`` under full remat,
    bf16 activations: (loss, the gradients in the port's leaf order)."""
    jcfg, jparams, cfg, _ = models
    batch = _batch(cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                              remat=True), has_aux=True)(jparams)
    return float(jloss), leaves(params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, "cpu",
                                                torch.float32))


def _model_errors(models, jax_model_grads):
    _, _, cfg, params = models
    jloss, want = jax_model_grads
    tree = moe_train.live(params)
    loss, _ = tf.loss_fn(tree, cfg, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    grads = torch.autograd.grad(loss, leaves(tree))
    errs = {"/".join(path): _rel(g.numpy(), w.numpy())
            for (path, _), g, w in zip(leaves_with_paths(tree), grads, want)}
    return abs(float(loss.detach()) - jloss) / jloss, errs


def test_model_loss_and_gradients_match_jax_in_bf16(models, jax_model_grads, flash_windows):
    loss_err, errs = _model_errors(models, jax_model_grads)
    assert loss_err <= LOSS_TOL, loss_err
    assert max(errs.values()) <= MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    # One backward a local layer, each with the config's window.
    assert flash_windows == [32] * tf.layer_kinds(models[2]).count("attn_local") == [32]


def test_model_check_rejects_a_backward_handed_window_0(models, jax_model_grads, window_zero):
    window_zero()
    _, errs = _model_errors(models, jax_model_grads)
    assert max(v for k, v in errs.items() if "/attn/" in k) > 3 * MODEL_TOL


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_unsharded(microbatches):
    jcfg, cfg = jax_reduced(JAX_ARCHS[ARCH]), reduced(ARCHS[ARCH])
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
    update = [np.ravel((got - p0).numpy()) for got, p0 in zip(leaves(state["params"]), before)]
    ref = [np.ravel((r - p0).numpy()) for r, p0 in zip(leaves(want["params"]), before)]
    assert _rel(np.concatenate(update), np.concatenate(ref)) <= 2 * MODEL_TOL
    for name, tol in (("m", MODEL_TOL), ("v", 2 * MODEL_TOL)):
        for got, ref in zip(leaves(state["opt"][name]), leaves(want["opt"][name])):
            assert _rel(got.numpy(), ref.numpy()) <= tol, name


def test_remat_policies_give_equal_gradients(models):
    _, _, cfg, params = models
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    results = []
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        tf.set_remat_policy(policy)
        try:
            tree = moe_train.live(params)
            loss, _ = tf.loss_fn(tree, cfg, batch, remat=remat)
            results.append((loss.detach(), torch.autograd.grad(loss, leaves(tree))))
        finally:
            tf.set_remat_policy(None)
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, results[0][1]))


def test_launch_train_runs_the_hybrid_to_the_end(tmp_path, capsys):
    state, losses = train_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                                    "--steps", "4", "--global-batch", "2",
                                    "--seq-len", str(SEQ), "--checkpoint-every", "2",
                                    "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 4 and len(losses) == 4
    assert all(np.isfinite(losses))
    assert "done at step 4" in capsys.readouterr().out


@pytest.mark.parametrize("mask,kinds", [
    ({"window": 32}, {"flash_attention_bwd_windowed": 1}),
    ({"prefix": 16}, {"flash_attention_bwd_prefix": 1}),
    ({"prefix": 128}, {"flash_attention_bwd_prefix": 1, "flash_attention_bwd_full": 1}),
    ({}, {}),
], ids=["window", "prefix", "every key", "causal"])
def test_the_backward_counts_its_launches_by_mask_kind(fake_card, mask, kinds):
    """As the forward counts its launches: a windowed call under
    ``_windowed``, a prefix under ``_prefix`` and, where the prefix covers
    every key, also under ``_full``; the route's counts as before."""
    fake_card(_FakeLibrary())
    q, k, v = _bf16(1, 4, 128, 64, seed=1), _bf16(1, 1, 128, 64, seed=2), _bf16(1, 1, 128, 64,
                                                                               seed=3)
    out, dout = (_bf16(1, 4, 128, 64, seed=s) for s in (4, 5))
    fab.flash_attention_bwd(q, k, v, out, dout, lse=torch.zeros(1, 4, 128), **mask)
    assert dict(runtime.launches) == {"flash_attention_bwd": 1, "flash_attention_bwd_tc": 1,
                                      **kinds}


@pytest.mark.parametrize("slice_len", [7, 1 << 24])
def test_in_place_adamw_by_slices_equals_the_pure_update(models, monkeypatch, slice_len):
    _, _, _, params = models
    monkeypatch.setattr(adamw_mod, "UPDATE_SLICE", slice_len)
    gen = torch.Generator().manual_seed(5)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    opt = {"m": tree_map(lambda p: torch.randn(p.shape, generator=gen) * 1e-2, params),
           "v": tree_map(lambda p: torch.rand(p.shape, generator=gen) * 1e-3, params)}
    step = torch.tensor(3, dtype=torch.int32)
    cfg_opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    want_p, want_opt, want_m = adamw_mod.adamw_update(cfg_opt, params, grads, opt, step)
    tree = tree_map(torch.clone, {"p": params, "m": opt["m"], "v": opt["v"]})
    got_p, got_opt, got_m = adamw_mod.adamw_update_(cfg_opt, tree["p"], grads,
                                                    {"m": tree["m"], "v": tree["v"]}, step)
    assert float(want_m["grad_norm"]) > 1.0  # clipping at work
    assert all(torch.equal(got_m[k], want_m[k]) for k in ("grad_norm", "lr"))
    for got, want in zip(leaves({"p": got_p, **got_opt}), leaves({"p": want_p, **want_opt})):
        assert torch.equal(got, want)


class _JaxRuleSigmoid(torch.autograd.Function):
    """``rglru.sigmoid``'s forward with JAX's derivative of ``lax.logistic``,
    ``g * (s * (1 - s))``, in place of autograd's through ``1 / (1 +
    exp(-x))`` (the candidate the measurements below weigh)."""

    written_out = staticmethod(rec_mod.sigmoid)

    @staticmethod
    def forward(ctx, x):
        s = _JaxRuleSigmoid.written_out(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


def _step_updates(microbatches, jit=True, unroll=False):
    """Relative L2 of the parameter update after two steps over all leaves and
    per leaf, the port against ``repro`` (jitted or op by op, scanned or
    unrolled)."""
    jcfg, cfg = jax_reduced(JAX_ARCHS[ARCH]), reduced(ARCHS[ARCH])
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jtf._UNROLL = unroll
    try:
        jstep = jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt), None,
                                       microbatches=microbatches)
        jstep = jax.jit(jstep) if jit else jstep
        step = steps_lib.make_train_step(cfg, AdamWConfig(**opt), microbatches=microbatches)
        jstate = jsteps.init_state(jcfg, jax.random.key(0))
        state = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
        before = [x.clone() for x in leaves(state["params"])]
        for i in range(2):
            batch = _batch(cfg, seed=10 + i, b=4)
            jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            state, _ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        jtf._UNROLL = False
    want = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    got = [(g - p0).numpy() for g, p0 in zip(leaves(state["params"]), before)]
    ref = [(r - p0).numpy() for r, p0 in zip(leaves(want["params"]), before)]
    whole = _rel(np.concatenate([g.ravel() for g in got]), np.concatenate([r.ravel() for r in ref]))
    return whole, {"/".join(path): _rel(g, r) for (path, _), g, r in
                   zip(leaves_with_paths(state["params"]), got, ref)}


if __name__ == "__main__":
    # The measurements the module's text quotes, on the CPU:
    #   PYTHONPATH=src python tests/test_torch_hybrid_train.py
    # (1) the whole model's worst leaf with autograd's sigmoid and with JAX's
    # rule, three batches; (2) the train step's worst leaf update, the port
    # against repro jitted and op by op, at 1 and 2 microbatches, and repro's
    # jitted step against its own op-by-op step.
    import json

    models_ = moe_train.models(ARCH)
    jcfg, jparams, cfg, params = models_
    grads_ = jax_block_grads.__wrapped__(models_)
    for kind in LAYERS:
        print(json.dumps({"block": kind, "f32_rel_err_max": max(
            _block_errors(models_, grads_, kind).values())}), flush=True)
    for rule in ("autograd", "jax"):
        rec_mod.sigmoid = _JaxRuleSigmoid.apply if rule == "jax" else _JaxRuleSigmoid.written_out
        for seed in (3, 4, 5):
            batch = _batch(cfg, seed=seed)
            (jl, _), jg = jax.value_and_grad(
                lambda p: jtf.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                      remat=True), has_aux=True)(jparams)
            want = leaves(params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu",
                                          torch.float32))
            tree = moe_train.live(params)
            loss, _ = tf.loss_fn(tree, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
            errs = {"/".join(path): _rel(g.numpy(), w.numpy()) for (path, _), g, w in
                    zip(leaves_with_paths(tree), torch.autograd.grad(loss, leaves(tree)), want)}
            worst = max(errs, key=errs.get)
            print(json.dumps({"model": rule, "batch_seed": seed, "worst_leaf": worst,
                              "rel_err": errs[worst]}), flush=True)
    rec_mod.sigmoid = _JaxRuleSigmoid.written_out
    for mb in (1, 2):
        for jit, unroll in ((True, False), (False, True)):
            whole, errs = _step_updates(mb, jit, unroll)
            worst = max(errs, key=errs.get)
            print(json.dumps({"step_update": "port against repro", "microbatches": mb,
                              "repro": "jitted" if jit else "op by op, unrolled",
                              "whole_rel_err": whole, "worst_leaf": worst,
                              "rel_err": errs[worst]}), flush=True)
    jcfg = jax_reduced(JAX_ARCHS[ARCH])
    ups = []
    for jit, unroll in ((True, False), (False, True)):
        jtf._UNROLL = unroll
        step = jsteps.make_train_step(jcfg, jadamw.AdamWConfig(lr=1e-3, total_steps=10,
                                                                warmup_steps=1), None)
        step = jax.jit(step) if jit else step
        st = jsteps.init_state(jcfg, jax.random.key(0))
        p0 = st["params"]
        for i in range(2):
            b = _batch(reduced(ARCHS[ARCH]), seed=10 + i, b=4)
            st, _ = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        ups.append(jax.tree.leaves(jax.tree.map(
            lambda x, y: np.asarray(x, np.float64) - np.asarray(y, np.float64),
            st["params"], p0)))
    jtf._UNROLL = False
    print(json.dumps({"step_update": "repro jitted against repro op by op",
                      "worst_rel_err": max(_rel(a, b) for a, b in zip(*ups))}), flush=True)

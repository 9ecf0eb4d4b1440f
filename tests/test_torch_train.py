"""Training against the JAX package's, on the CPU.

1. One block's parameter and input gradients with f32 activations against
   ``jax.grad`` of ``repro``'s ``block_forward`` (reduced qwen3-0.6b and
   gemma-2b): relative L2 per leaf within ``BLOCK_TOL`` (measured 5e-7..7e-7).
2. The whole model's loss and per-leaf gradients with bf16 activations (f32
   masters, full remat) against ``jax.value_and_grad`` of ``repro``'s
   ``loss_fn``: the loss within ``LOSS_TOL`` relative (measured 1e-4..3e-4),
   each leaf within ``MODEL_TOL`` relative L2 (measured up to 1.4e-2:
   ``repro`` rounds scores, P and the backward's dP and dS to bf16, the
   flash kernel's plain version keeps them in f32).  Both bounds reject a
   flash backward that drops ``D = sum(dO * O)``.
3. ``make_train_step`` at ``microbatches`` 1 and 2 against ``repro``'s step
   run without a ``Sharder`` (its sharded step is red under jax 0.9.0), two
   steps from the same state: ``loss_total`` within ``LOSS_TOL``,
   ``grad_norm`` and each m (relative L2 per leaf; measured 1.4e-2) within
   ``MODEL_TOL``, each v and each leaf's parameter update (after minus
   before; measured 3.3e-2: Adam divides m by sqrt(v), so their errors add)
   within ``2 * MODEL_TOL``, ``lr`` within 1e-6.
4. Remat off, full (``None``) and ``"dots"`` give the same gradients, bit
   for bit.
5. ``train()`` with checkpoint and resume, restart after an injected
   failure, the straggler watch and a retry policy that gives up
   (``tests/test_runtime.py:51-124``, two of which are red for ``repro``
   because of its sharded step); under the donating step an async
   checkpoint holds its step's state bit for bit while the next steps
   update the state in place, and a restart with no checkpoint raises.
6. ``tests/test_runtime.py:37``'s rule: on one fixed batch the last loss is
   below 0.7 of the first within 30 steps at the reduced config.
7. ``launch.train.main([..., "--reduced", "--device", "cpu"])`` runs to the
   end; without a card the default device raises, and so do the mesh flags.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw

from repro_torch.checkpoint import store as store_mod
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import PrefetchingLoader, synthetic_batches
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.ft import RetryPolicy, StragglerWatch
from repro_torch.runtime.train_loop import LoopConfig, train
from repro_torch.tree import leaves, leaves_with_paths, tree_map

BLOCK_TOL = 1e-5
LOSS_TOL = 2e-3
MODEL_TOL = 3e-2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _models(arch):
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch]), reduced(ARCHS[arch])
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu", torch.float32)
    return jcfg, jparams, cfg, params


def _live(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


@pytest.fixture
def drop_delta(monkeypatch):
    """A flash backward that drops D = sum(dO * O) (its ``out`` zeroed)."""
    bwd = fab.flash_attention_bwd

    def faulty(q, k, v, out, dout, *args):
        return bwd(q, k, v, torch.zeros_like(out), dout, *args)

    def plant():
        monkeypatch.setattr(fab, "flash_attention_bwd", faulty)

    return plant


def _block_errors(arch):
    jcfg, jparams, cfg, params = _models(arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    jblock = jax.tree.map(lambda a: a[0], jparams["seg0"]["b0_attn"])

    def jloss(p, xx):
        out, _, _ = jtf.block_forward(p, jcfg, "attn", xx, jnp.asarray(pos), jnp.asarray(pos))
        return jnp.sum(out * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jblock, jnp.asarray(x))
    block = _live(params["layers"][0])
    xt = torch.from_numpy(x).requires_grad_()
    out, _, _ = tf.block_forward(block, cfg, "attn", xt, torch.from_numpy(pos.copy()))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves(block) + [xt])
    want = leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgx)]
    assert len(grads) == len(want)
    return [_rel(g.numpy(), w_) for g, w_ in zip(grads, want)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma-2b"])
def test_block_gradients_match_jax_in_f32(arch):
    assert max(_block_errors(arch)) <= BLOCK_TOL


def test_block_check_rejects_a_backward_without_d(drop_delta):
    drop_delta()
    assert max(_block_errors("qwen3-0.6b")) > 100 * BLOCK_TOL


def _batch(cfg, seed=3, b=2, s=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return {"tokens": tokens, "targets": tokens}


def _model_errors(arch):
    jcfg, jparams, cfg, params = _models(arch)
    batch = _batch(cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                              remat=True), has_aux=True)(jparams)
    live = _live(params)
    loss, _ = tf.loss_fn(live, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(live))
    want = leaves(params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, "cpu", torch.float32))
    errs = {"/".join(path): _rel(g.numpy(), w.numpy())
            for (path, _), g, w in zip(leaves_with_paths(live), grads, want)}
    return abs(float(loss.detach()) - float(jloss)) / float(jloss), errs


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma-2b"])
def test_model_loss_and_gradients_match_jax_in_bf16(arch):
    loss_err, errs = _model_errors(arch)
    assert loss_err <= LOSS_TOL
    assert max(errs.values()) <= MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_model_check_rejects_a_backward_without_d(drop_delta):
    drop_delta()
    _, errs = _model_errors("qwen3-0.6b")
    assert max(errs.values()) > 3 * MODEL_TOL


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_unsharded(microbatches):
    jcfg, cfg = jax_reduced(JAX_ARCHS["qwen3-0.6b"]), reduced(ARCHS["qwen3-0.6b"])
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


def test_train_step_check_rejects_undivided_microbatches(monkeypatch):
    """Gradients summed over two microbatches and not divided (planted by
    doubling what reaches AdamW) miss ``MODEL_TOL`` on the grad norm."""
    jcfg, cfg = jax_reduced(JAX_ARCHS["qwen3-0.6b"]), reduced(ARCHS["qwen3-0.6b"])
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    update = steps_lib.adamw_update
    monkeypatch.setattr(steps_lib, "adamw_update", lambda c, p, g, o, s: update(
        c, p, tree_map(lambda x: 2 * x, g), o, s))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt), None,
                                           microbatches=2))
    step = steps_lib.make_train_step(cfg, AdamWConfig(**opt), microbatches=2)
    jstate = jsteps.init_state(jcfg, jax.random.key(0))
    state = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    batch = _batch(cfg, seed=10, b=4)
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) > 10 * MODEL_TOL


def test_remat_policies_give_equal_gradients():
    _, _, cfg, params = _models("qwen3-0.6b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    results = []
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        tf.set_remat_policy(policy)
        try:
            live = _live(params)
            loss, _ = tf.loss_fn(live, cfg, batch, remat=remat)
            results.append((loss.detach(), torch.autograd.grad(loss, leaves(live))))
        finally:
            tf.set_remat_policy(None)
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, results[0][1]))
    with pytest.raises(ValueError):
        tf.set_remat_policy("everything")


def _trainer(steps=30, lr=3e-3):
    cfg = reduced(ARCHS["qwen3-0.6b"])
    shape = ShapeSpec("t", seq_len=32, global_batch=4, kind="train")
    opt = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=2, weight_decay=0.0)
    step_fn = steps_lib.make_train_step(cfg, opt)
    state = steps_lib.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, shape, step_fn, state


def test_loss_decreases_over_training():
    cfg, shape, step_fn, state = _trainer(steps=30)
    batch = {k: torch.from_numpy(v) for k, v in next(synthetic_batches(cfg, shape, seed=1)).items()}
    first = last = None
    for _ in range(30):
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        last = loss
    assert last < first * 0.7, (first, last)


def _batches(cfg, shape):
    def batches(start):
        return PrefetchingLoader(synthetic_batches(cfg, shape, seed=0, start_step=start))

    return batches


def test_train_loop_with_checkpoint_and_resume(tmp_path):
    cfg, shape, step_fn, state = _trainer(steps=10)
    store = CheckpointStore(str(tmp_path), keep=2)
    out = train(step_fn, state, _batches(cfg, shape), store,
                LoopConfig(total_steps=10, checkpoint_every=5, log_every=100,
                           async_checkpoint=False))
    assert int(out["step"]) == 10
    assert store.latest_step() == 10
    out2 = train(step_fn, out, _batches(cfg, shape), store,
                 LoopConfig(total_steps=10, checkpoint_every=5, log_every=100))
    assert int(out2["step"]) == 10


def test_resume_from_a_checkpoint_repeats_the_steps(tmp_path):
    cfg, shape, step_fn, state = _trainer(steps=6)
    store = CheckpointStore(str(tmp_path), keep=5)
    losses = {}
    out = train(step_fn, state, _batches(cfg, shape), store,
                LoopConfig(total_steps=6, checkpoint_every=3, log_every=1,
                           async_checkpoint=True),
                metrics_cb=lambda s, m: losses.setdefault(s, m["loss_total"]))
    mid, _ = store.restore(3, out)
    assert int(mid["step"]) == 3
    again = {}
    out2 = train(step_fn, mid, _batches(cfg, shape), None,
                 LoopConfig(total_steps=6, checkpoint_every=3, log_every=1),
                 metrics_cb=lambda s, m: again.setdefault(s, m["loss_total"]))
    assert sorted(again) == [4, 5, 6]
    assert all(again[s] == losses[s] for s in again)
    assert all(torch.equal(a, b) for a, b in zip(leaves(out2), leaves(out)))


def test_restart_after_injected_failure(tmp_path):
    cfg, shape, step_fn, state = _trainer(steps=8)
    store = CheckpointStore(str(tmp_path), keep=3)
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 6:  # die once mid-run (after ckpt at step 4)
            raise RuntimeError("injected node failure")
        return step_fn(state, batch)

    out = train(flaky_step, state, _batches(cfg, shape), store,
                LoopConfig(total_steps=8, checkpoint_every=4, log_every=100,
                           async_checkpoint=False, max_restarts=2))
    assert int(out["step"]) == 8
    assert calls["n"] == 10  # 5 good steps, the failure, steps 5..8 again from step 4


def _donating_trainer(steps):
    cfg, shape, _, state = _trainer(steps=steps)
    opt = AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=2, weight_decay=0.0)
    return cfg, shape, opt, steps_lib.make_train_step(cfg, opt, donate=True), state


def test_async_checkpoint_under_the_donating_step_restores_bit_for_bit(tmp_path, monkeypatch):
    """The step-10 checkpoint, written in the background while steps 11 on
    update the state in place (its writer held until step 11 is done),
    restores the pure step's step-10 state bit for bit."""
    cfg, shape, opt, step_fn, state = _donating_trainer(steps=14)
    pure = steps_lib.make_train_step(cfg, opt)
    want = steps_lib.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    it = iter(_batches(cfg, shape)(0))
    for _ in range(10):
        want, _ = pure(want, next(it))

    stepped_11 = threading.Event()
    savez = store_mod.np.savez

    def held_savez(f, **arrays):
        if "ckpt_00000010" in f.name:
            assert stepped_11.wait(timeout=60)
        return savez(f, **arrays)

    def step(state, batch):
        out = step_fn(state, batch)
        if int(out[0]["step"]) == 11:
            stepped_11.set()
        return out

    step.donates = True
    monkeypatch.setattr(store_mod.np, "savez", held_savez)
    store = CheckpointStore(str(tmp_path), keep=3)
    out = train(step, state, _batches(cfg, shape), store,
                LoopConfig(total_steps=14, checkpoint_every=10, log_every=100,
                           async_checkpoint=True))
    assert stepped_11.is_set() and int(out["step"]) == 14
    got, meta = store.restore(10, out)
    assert meta["step"] == 10 and int(got["step"]) == 10
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))


@pytest.mark.parametrize("donate", [False, True])
def test_restart_with_no_checkpoint(tmp_path, donate):
    """A failure before the first checkpoint: the pure step starts again
    from the starting state; the donating step, which updated it in place,
    raises."""
    cfg, shape, opt, _, state = _donating_trainer(steps=6)
    step_fn = steps_lib.make_train_step(cfg, opt, donate=donate)
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected node failure")
        return step_fn(state, batch)

    flaky_step.donates = step_fn.donates
    run = functools.partial(train, flaky_step, state, _batches(cfg, shape),
                            CheckpointStore(str(tmp_path)),
                            LoopConfig(total_steps=6, checkpoint_every=5, log_every=100,
                                       max_restarts=2))
    if donate:
        with pytest.raises(RuntimeError, match="no checkpoint to restart from"):
            run()
        assert calls["n"] == 3
    else:
        assert int(run()["step"]) == 6 and calls["n"] == 9


def test_straggler_watch():
    w = StragglerWatch(threshold=2.0)
    assert not w.observe(1, 1.0)
    assert not w.observe(2, 1.1)
    assert w.observe(3, 5.0)
    assert w.slow_steps == 1


def test_retry_policy_gives_up():
    p = RetryPolicy(max_restarts=2, backoff_seconds=0.0)
    tries = {"n": 0}

    def always_fails():
        tries["n"] += 1
        raise ValueError("nope")

    with pytest.raises(ValueError):
        p.run(always_fails)
    assert tries["n"] == 3


def test_launch_train_runs_to_the_end(tmp_path, capsys):
    state, losses = train_mod.main(["--reduced", "--device", "cpu", "--steps", "4",
                                    "--global-batch", "2", "--seq-len", "16",
                                    "--checkpoint-every", "2", "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 4 and len(losses) == 4
    assert all(np.isfinite(losses))
    assert CheckpointStore(str(tmp_path)).latest_step() == 4
    assert "done at step 4" in capsys.readouterr().out


def test_launch_train_refuses_what_it_cannot_do(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--reduced", "--steps", "1"])
    for flag in ("--production-mesh", "--multi-pod"):
        with pytest.raises(NotImplementedError, match="distributed slice"):
            train_mod.main(["--reduced", "--device", "cpu", flag])

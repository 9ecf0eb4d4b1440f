"""Training the prefix-LM VLM (paligemma-3b, reduced) against the JAX
package's, on the CPU.

``reduced(paligemma-3b)``: 2 gemma layers, d_model 64, 4 query heads on one
KV head of 16, GeGLU, 8 patch embeddings of width 32 projected in by
``frontend.proj_in`` and concatenated before the token embedding.  Every
check runs at 8 patches and 40 text tokens, 48 positions.  ``repro``
writes the prefix-LM mask as ``mask_positions = max(pos - P + 1, 0)``; the
port hands ``prefix = P`` to the flash kernel, which under grad goes
through ``FlashAttentionFn`` (its plain backward here; on the card the
tensor-core backward with the prefix).

1. One ``attn`` block's parameter and input gradients with f32 activations,
   the port's ``prefix`` form against ``jax.grad`` of ``repro``'s
   ``block_forward`` with ``mask_positions``: ``BLOCK_TOL`` per leaf; the
   backward handed ``prefix = P``.
2. The whole model's loss and per-leaf gradients with bf16 activations
   under full remat against ``jax.value_and_grad`` of ``repro``'s
   ``loss_fn`` (the loss on text positions only): ``LOSS_TOL`` and
   ``MODEL_TOL``, ``frontend/proj_in/w`` among the leaves; every flash
   backward the model takes is handed ``prefix = frontend_seq``, one a
   layer.
3. A planted fault the model check must reject by more than 3
   ``MODEL_TOL``: a flash backward handed ``prefix = 0`` after a prefix
   forward.
4. ``make_train_step`` at ``microbatches`` 1 and 2 (the patches split with
   the tokens) against ``repro``'s step run without a ``Sharder``, two
   steps from one state: ``loss_total``, ``grad_norm``, ``lr``, and the
   parameter update, m and v each over the whole tree (relative L2 of all
   leaves at once; leaf by leaf Adam's m / sqrt(v) turns bf16 noise on
   near-zero gradient entries into sign flips, ``PERF.md`` §7).
5. ``launch.train.main([..., "--arch", ARCH, "--reduced", "--device",
   "cpu"])`` runs to the end, and steps 3..4 run again from its step-2
   checkpoint equal the first run's bit for bit, the patches redrawn from
   ``(seed, step)``.
6. On a stand-in card (``test_torch_flash_bwd_tc.py``'s fake library, the
   model at head_dim 64 so that the tensor-core route takes it), one
   training step's flash launches: the prefix forward twice a layer (the
   forward and remat's recompute), the ``tc`` backward once a layer, each
   counted under ``flash_attention_bwd_prefix`` too.

Tolerances are ``test_torch_train.py``'s.  The JAX model runs without a
``Sharder``.
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

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.pipeline import PrefetchingLoader, synthetic_batches
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import LoopConfig, train
from repro_torch.tree import leaves, leaves_with_paths

import test_torch_moe_train as moe_train
from test_torch_flash_bwd_tc import _FakeLibrary, fake_card  # noqa: F401
from test_torch_train import BLOCK_TOL, LOSS_TOL, MODEL_TOL, _rel

ARCH = "paligemma-3b"
TEXT = 40  # text tokens a sequence, after the reduced config's 8 patches


@pytest.fixture(scope="module")
def models():
    return moe_train.models(ARCH)


@pytest.fixture
def flash_prefixes(monkeypatch):
    """The ``prefix`` of every flash backward call."""
    calls, bwd = [], fab.flash_attention_bwd

    def spying(q, k, v, out, dout, scale, window, prefix, *args):
        calls.append(prefix)
        return bwd(q, k, v, out, dout, scale, window, prefix, *args)

    monkeypatch.setattr(fab, "flash_attention_bwd", spying)
    return calls


@pytest.fixture
def prefix_zero(monkeypatch):
    """A flash backward handed ``prefix = 0`` after a prefix forward."""
    bwd = fab.flash_attention_bwd

    def plant():
        monkeypatch.setattr(fab, "flash_attention_bwd",
                            lambda q, k, v, out, dout, scale, window, prefix, *args: bwd(
                                q, k, v, out, dout, scale, window, 0, *args))

    return plant


def _block_inputs(cfg):
    rng = np.random.default_rng(0)
    s = cfg.frontend_seq + TEXT
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    return x, w, pos


def test_block_gradients_match_jax_mask_positions_in_f32(models, flash_prefixes):
    jcfg, jparams, cfg, params = models
    x, w, pos = _block_inputs(cfg)
    p_len = cfg.frontend_seq
    mask_pos = np.maximum(pos - p_len + 1, 0)

    def jloss(p, xx):
        y, _, _ = jtf.block_forward(p, jcfg, "attn", xx, jnp.asarray(pos), jnp.asarray(mask_pos))
        return jnp.sum(y * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(moe_train.jax_layer(jparams, cfg, 0),
                                               jnp.asarray(x))
    want = leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgx)]
    block = moe_train.live(params["layers"][0])
    xt = torch.from_numpy(x).requires_grad_()
    out, _, _ = tf.block_forward(block, cfg, "attn", xt, torch.from_numpy(pos.copy()),
                                 prefix=p_len)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves(block) + [xt])
    assert len(grads) == len(want)
    names = ["/".join(p) for p, _ in leaves_with_paths(block)] + ["x"]
    errs = {n: _rel(g.numpy(), w_) for n, g, w_ in zip(names, grads, want)}
    assert max(errs.values()) <= BLOCK_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert flash_prefixes == [p_len]


def _batch(cfg, seed=3, b=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, TEXT), dtype=np.int32)
    patches = rng.standard_normal((b, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return {"tokens": tokens, "targets": tokens, "patches": patches}


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


def test_model_loss_and_gradients_match_jax_in_bf16(models, jax_model_grads, flash_prefixes):
    loss_err, errs = _model_errors(models, jax_model_grads)
    assert loss_err <= LOSS_TOL, loss_err
    assert max(errs.values()) <= MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    cfg = models[2]
    assert {"frontend/proj_in/w", "embed/table"} <= set(errs)
    # One backward a layer, each handed the patches as its prefix.
    assert flash_prefixes == [cfg.frontend_seq] * cfg.n_layers


def test_model_check_rejects_a_backward_handed_prefix_0(models, jax_model_grads, prefix_zero):
    prefix_zero()
    _, errs = _model_errors(models, jax_model_grads)
    assert max(errs.values()) > 3 * MODEL_TOL
    assert errs["frontend/proj_in/w"] > 3 * MODEL_TOL


def _flat(tree):
    return np.concatenate([np.ravel(x.numpy()) for x in leaves(tree)])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_unsharded(microbatches):
    jcfg, cfg = jax_reduced(JAX_ARCHS[ARCH]), reduced(ARCHS[ARCH])
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt), None,
                                           microbatches=microbatches))
    step = steps_lib.make_train_step(cfg, AdamWConfig(**opt), microbatches=microbatches)
    jstate = jsteps.init_state(jcfg, jax.random.key(0))
    state = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    before = _flat(state["params"])
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
    assert _rel(_flat(state["params"]) - before, _flat(want["params"]) - before) <= 2 * MODEL_TOL
    assert _rel(_flat(state["opt"]["m"]), _flat(want["opt"]["m"])) <= MODEL_TOL
    assert _rel(_flat(state["opt"]["v"]), _flat(want["opt"]["v"])) <= 2 * MODEL_TOL


def test_launch_train_runs_the_vlm_and_resumes_bit_for_bit(tmp_path, capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4", "--global-batch",
            "2", "--seq-len", str(8 + TEXT), "--checkpoint-every", "2", "--ckpt-dir",
            str(tmp_path)]
    first = {}
    state, losses = train_mod.main(argv, metrics_cb=lambda s, m: first.__setitem__(
        s, m["loss_total"]))
    assert int(state["step"]) == 4 and len(losses) == 4 and all(np.isfinite(losses))
    assert "done at step 4" in capsys.readouterr().out

    args = train_mod.parse_args(argv)
    cfg, shape, opt_cfg, device = train_mod.setup(args)
    # The batches are drawn from (seed, step): a resume from step 2 draws
    # step 2's tokens and patches again, and the patches change by step.
    again_2 = next(synthetic_batches(cfg, shape, seed=0, start_step=2))
    fresh = synthetic_batches(cfg, shape, seed=0)
    drawn = [next(fresh) for _ in range(4)]
    assert drawn[2]["patches"].shape == (2, cfg.frontend_seq, cfg.frontend_dim)
    assert all(np.array_equal(again_2[k], drawn[2][k]) for k in drawn[2])
    assert not np.array_equal(drawn[2]["patches"], drawn[3]["patches"])

    mid, meta = CheckpointStore(str(tmp_path)).restore(2, state)
    assert meta["step"] == 2 and int(mid["step"]) == 2
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, donate=True)
    resumed = {}
    out = train(step_fn, mid, lambda start: PrefetchingLoader(
                    synthetic_batches(cfg, shape, seed=args.seed, start_step=start),
                    device=device), None,
                LoopConfig(total_steps=4, checkpoint_every=5, log_every=1),
                metrics_cb=lambda s, m: resumed.__setitem__(s, m["loss_total"]))
    assert sorted(resumed) == [3, 4]
    assert all(float(resumed[s]) == float(first[s]) for s in resumed)
    assert all(torch.equal(a, b) for a, b in zip(leaves(out), leaves(state)))


def test_the_vlm_step_counts_its_flash_launches_as_prefix(fake_card):
    """Under grad each layer's flash call is a prefix call: forward and
    recompute on the tensor-core route with the prefix, the backward on
    ``tc`` with the prefix, none covering every key."""
    fake_card(_FakeLibrary())
    cfg = reduced(ARCHS[ARCH], head_dim=64)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tree = moe_train.live(params)
    loss, _ = tf.loss_fn(tree, cfg, batch, remat=True)
    torch.autograd.grad(loss, leaves(tree))
    n = cfg.n_layers
    assert dict(runtime.launches) == {
        "flash_attention": 2 * n, "flash_attention_tc": 2 * n, "flash_attention_prefix": 2 * n,
        "flash_attention_bwd": n, "flash_attention_bwd_tc": n, "flash_attention_bwd_prefix": n}


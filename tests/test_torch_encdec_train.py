"""Training the encoder-decoder (seamless-m4t-large-v2, reduced) against the
JAX package's, on the CPU.

``reduced(seamless-m4t-large-v2)``: 2 bidirectional encoder layers and 2
decoder layers (causal self-attention, then cross-attention over the
encoder's output), d_model 64, 4 query heads on 2 KV heads of 16, GeLU,
frames of width 32 projected in by ``frontend.proj_in``.  The encoder's
frames are drawn apart from the decoder's tokens (a generator of their
own), 48 frames under 40 tokens, so cross-attention runs with S < T.
``repro`` writes the encoder's mask as all-zero ``mask_pos`` and
cross-attention's as every key seen; the port hands the flash kernel
``prefix = T`` for both, which under grad goes through ``FlashAttentionFn``
(its plain backward here; on the card the tensor-core backward, flushing).

1. An ``"enc"`` block's and a ``"cross"`` block's parameter and input
   gradients (the encoder output's too) with f32 activations against
   ``jax.grad`` of ``repro``'s ``block_forward``: ``BLOCK_TOL`` per leaf;
   the backward handed ``prefix = T`` on every every-key call.
2. The whole model's loss and per-leaf gradients with bf16 activations
   under full remat (the decoder rematted, the encoder not, as ``repro``'s
   training scan) against ``jax.value_and_grad`` of ``repro``'s
   ``loss_fn``: ``LOSS_TOL`` and ``MODEL_TOL``, ``frontend/proj_in/w`` and
   the encoder's leaves among them; one backward an encoder layer (every
   key) and two a decoder layer (causal, then cross over every key).
3. A planted fault the model check must reject by more than 3
   ``MODEL_TOL``: the cross-attention backward handed ``prefix = 0``
   (causal) after an every-key forward (``chip_smoke.cross_prefix_zero``).
4. ``make_train_step`` at ``microbatches`` 1 and 2 (the frames split with
   the tokens) against ``repro``'s step run without a ``Sharder``, two
   steps from one state: ``loss_total``, ``grad_norm``, ``lr``, and the
   parameter update, m and v each over the whole tree.
5. ``launch.train.main([..., "--arch", ARCH, "--reduced", "--device",
   "cpu"])`` runs to the end, and steps 3..4 run again from its step-2
   checkpoint equal the first run's bit for bit, the frames redrawn from
   ``(seed, step)``.
6. On a stand-in card (the model at head_dim 64, the tensor-core route),
   one training step's flash launches by mask kind: the encoder's every-key
   forward once a layer, the decoder's causal and cross forwards twice (the
   forward and remat's recompute), the ``tc`` backward three times a
   decoder-and-encoder pair, the every-key ones counted under
   ``flash_attention_bwd_prefix`` and ``_full``.
7. ``chip_smoke.family_argv`` cuts the encoder with the decoder (the card's
   resume check at 2 + 2 layers of the published widths).

Tolerances are ``test_torch_train.py``'s.  The JAX model runs without a
``Sharder``.
"""

import importlib.util
from pathlib import Path

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

ARCH = "seamless-m4t-large-v2"
TOKENS, FRAMES = 40, 48
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_encdec", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()


@pytest.fixture(scope="module")
def models():
    return moe_train.models(ARCH)


@pytest.fixture
def flash_prefixes(monkeypatch):
    """(S, T, prefix) of every flash backward call."""
    calls, bwd = [], fab.flash_attention_bwd

    def spying(q, k, v, out, dout, scale, window, prefix, *args):
        calls.append((q.shape[2], k.shape[2], prefix))
        return bwd(q, k, v, out, dout, scale, window, prefix, *args)

    monkeypatch.setattr(fab, "flash_attention_bwd", spying)
    return calls


def _draws(cfg, b, seed):
    """(tokens' generator, frames' generator): the frames drawn apart."""
    return np.random.default_rng(seed), np.random.default_rng(seed + 1000)


def _block_inputs(cfg):
    tok, frm = _draws(cfg, 2, 0)
    x = tok.standard_normal((2, TOKENS, cfg.d_model)).astype(np.float32)
    w = tok.standard_normal((2, TOKENS, cfg.d_model)).astype(np.float32)
    enc = frm.standard_normal((2, FRAMES, cfg.d_model)).astype(np.float32)
    xe = frm.standard_normal((2, FRAMES, cfg.d_model)).astype(np.float32)
    we = frm.standard_normal((2, FRAMES, cfg.d_model)).astype(np.float32)
    return x, w, enc, xe, we


def _jax_block(jparams, cfg, kind):
    if kind == "enc":
        return jax.tree.map(lambda a: a[0], jparams["encoder"]["b0_enc"])
    return moe_train.jax_layer(jparams, cfg, 0)


def _port_block(params, kind):
    return moe_train.live(params["encoder"][0] if kind == "enc" else params["layers"][0])


@pytest.mark.parametrize("kind", ["enc", "cross"])
def test_block_gradients_match_jax_in_f32(models, flash_prefixes, kind):
    jcfg, jparams, cfg, params = models
    x, w, enc, xe, we = _block_inputs(cfg)
    if kind == "enc":
        x, w = xe, we
    s = x.shape[1]
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))

    def jloss(p, xx, ee):
        y, _, _ = jtf.block_forward(p, jcfg, kind, xx, jnp.asarray(pos), jnp.asarray(pos),
                                    enc_out=ee if kind == "cross" else None)
        return jnp.sum(y * w)

    jgp, jgx, jge = jax.grad(jloss, argnums=(0, 1, 2))(_jax_block(jparams, cfg, kind),
                                                       jnp.asarray(x), jnp.asarray(enc))
    want = leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgx)]
    block = _port_block(params, kind)
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(enc).requires_grad_()
    out, _, _ = tf.block_forward(block, cfg, kind, xt, torch.from_numpy(pos.copy()),
                                 enc_out=et if kind == "cross" else None)
    inputs = leaves(block) + [xt] + ([et] if kind == "cross" else [])
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), inputs)
    if kind == "cross":
        want.append(np.asarray(jge))
    assert len(grads) == len(want)
    names = ["/".join(p) for p, _ in leaves_with_paths(block)] + ["x"] + (
        ["enc_out"] if kind == "cross" else [])
    errs = {n: _rel(g.numpy(), w_) for n, g, w_ in zip(names, grads, want)}
    assert max(errs.values()) <= BLOCK_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    if kind == "enc":
        assert flash_prefixes == [(FRAMES, FRAMES, FRAMES)]
    else:  # the cross call, then the causal self-attention
        assert flash_prefixes == [(TOKENS, FRAMES, FRAMES), (TOKENS, TOKENS, 0)]
        assert "xattn/wk/w" in errs and errs["enc_out"] <= BLOCK_TOL


def _batch(cfg, seed=3, b=2, frames=FRAMES):
    tok, frm = _draws(cfg, b, seed)
    tokens = tok.integers(0, cfg.vocab_size, (b, TOKENS), dtype=np.int32)
    return {"tokens": tokens, "targets": tokens,
            "frames": frm.standard_normal((b, frames, cfg.frontend_dim)).astype(np.float32)}


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
    assert {"frontend/proj_in/w", "encoder/0/attn/wq/w", "encoder/1/mlp/w_down/w",
            "layers/1/xattn/wk/w", "enc_norm/scale"} <= set(errs)
    # Backward order: the decoder's layers last to first (each its cross
    # call, then its causal one), then the encoder's every-key calls.
    dec = [(TOKENS, FRAMES, FRAMES), (TOKENS, TOKENS, 0)] * cfg.n_layers
    assert flash_prefixes == dec + [(FRAMES, FRAMES, FRAMES)] * cfg.n_encoder_layers


def test_model_check_rejects_a_cross_backward_handed_prefix_0(models, jax_model_grads,
                                                              flash_prefixes):
    with SMOKE.cross_prefix_zero():
        _, errs = _model_errors(models, jax_model_grads)
    assert max(errs.values()) > 3 * MODEL_TOL
    assert errs["frontend/proj_in/w"] > 3 * MODEL_TOL
    cfg = models[2]
    # Only the cross calls were handed 0; the encoder's kept every key.
    dec = [(TOKENS, FRAMES, 0), (TOKENS, TOKENS, 0)] * cfg.n_layers
    assert flash_prefixes == dec + [(FRAMES, FRAMES, FRAMES)] * cfg.n_encoder_layers


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


def test_launch_train_runs_the_encdec_and_resumes_bit_for_bit(tmp_path, capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4", "--global-batch",
            "2", "--seq-len", str(TOKENS), "--checkpoint-every", "2", "--ckpt-dir",
            str(tmp_path)]
    first = {}
    state, losses = train_mod.main(argv, metrics_cb=lambda s, m: first.__setitem__(
        s, m["loss_total"]))
    assert int(state["step"]) == 4 and len(losses) == 4 and all(np.isfinite(losses))
    assert "done at step 4" in capsys.readouterr().out

    args = train_mod.parse_args(argv)
    cfg, shape, opt_cfg, device = train_mod.setup(args)
    # The batches are drawn from (seed, step): a resume from step 2 draws
    # step 2's tokens and frames again, and the frames change by step.
    again_2 = next(synthetic_batches(cfg, shape, seed=0, start_step=2))
    fresh = synthetic_batches(cfg, shape, seed=0)
    drawn = [next(fresh) for _ in range(4)]
    assert drawn[2]["frames"].shape == (2, TOKENS, cfg.frontend_dim)
    assert all(np.array_equal(again_2[k], drawn[2][k]) for k in drawn[2])
    assert not np.array_equal(drawn[2]["frames"], drawn[3]["frames"])

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


def test_the_encdec_step_counts_its_flash_launches_by_kind(fake_card):
    """Under grad: the encoder's every-key forward once a layer (not
    rematted), the decoder's causal and cross forwards twice (the forward
    and remat's recompute), all on the tensor-core route; the ``tc``
    backward once an encoder layer and twice a decoder layer, the every-key
    calls (encoder and cross) counted under ``_prefix`` and ``_full``; as
    ``chip_smoke.ENCDEC_TRAINER`` reckons them a step."""
    fake_card(_FakeLibrary())
    cfg = reduced(ARCHS[ARCH], head_dim=64)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, frames=64).items()}
    tree = moe_train.live(params)
    loss, _ = tf.loss_fn(tree, cfg, batch, remat=True)
    torch.autograd.grad(loss, leaves(tree))
    e, d = cfg.n_encoder_layers, cfg.n_layers
    want = {"flash_attention": e + 4 * d, "flash_attention_tc": e + 4 * d,
            "flash_attention_prefix": e + 2 * d, "flash_attention_full": e + 2 * d,
            "flash_attention_bwd": e + 2 * d, "flash_attention_bwd_tc": e + 2 * d,
            "flash_attention_bwd_prefix": e + d, "flash_attention_bwd_full": e + d}
    assert dict(runtime.launches) == want
    assert SMOKE.ENCDEC_TRAINER.launches(cfg) == want


def test_the_resume_check_cuts_the_encoder_with_the_decoder():
    """``chip_smoke.family_argv`` at 2 layers gives seamless-m4t-large-v2's
    published widths with 2 encoder and 2 decoder layers (the 8f resume),
    and its reckoned checkpoint is 12 bytes a parameter of that config."""
    argv = SMOKE.family_argv(ARCH, SMOKE.ENCDEC_RESUME_LAYERS, SMOKE.ENCDEC_TRAIN_ARGV)
    cfg = train_mod.setup(train_mod.parse_args([*argv, "--device", "cpu"]))[0]
    full = ARCHS[ARCH]
    assert (cfg.n_layers, cfg.n_encoder_layers) == (2, 2)
    assert cfg == full.__class__(**{**full.__dict__, "n_layers": 2, "n_encoder_layers": 2})
    assert SMOKE.family_argv(ARCH, 0, SMOKE.ENCDEC_TRAIN_ARGV)[:2] == ("--arch", ARCH)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_a_train_step_leaves_no_tensors_to_the_garbage_collector(microbatches):
    """Every tensor a step makes is freed when its last reference goes, not
    when Python's cycle collector next runs: with the collector off, a
    step's cyclic garbage holds no tensor.  (A reference cycle through the
    unflattened gradients kept a step's f32 gradients alive past the step on
    the card, and 8f's trainer ran out of memory at a step the collector
    had not yet reached.)"""
    import gc

    cfg = reduced(ARCHS[ARCH])
    step = steps_lib.make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1),
                                     microbatches=microbatches, donate=True)
    state = steps_lib.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, b=4, frames=TOKENS).items()}
    state, _ = step(state, batch)  # warm up: module-level objects made once
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        state, _ = step(state, batch)
        gc.collect()
        held = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []

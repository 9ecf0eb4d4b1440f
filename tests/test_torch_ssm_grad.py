"""The SSD scan's gradient and mamba2-370m training against the JAX package's, on the CPU.

The JAX package has no backward kernel for the scan: it trains through
XLA's autodiff of ``jax.lax.scan``.  The port's gradient is a hand-written
kernel (``csrc/ssd_scan.cu``, ``ssd_scan_bwd``) behind ``SsdScanFn``; on
CPU tensors the Function's backward is the kernel's plain version,
``ssd_scan_bwd_plain``, so these tests exercise the backward's own
arithmetic.  Inputs are numpy arrays from a seed, handed to both packages.

1. ``ssd_scan_bwd_plain`` against ``jax.vjp`` of ``repro``'s ``ssd_scan_ref``
   with sigmoid decays and decays near 1 (Mamba-2's dt range), at shapes
   whose ``P * N`` is and is not a multiple of 4.  ``ssd_scan_ref`` carries
   in the states' dtype, the port (as the TPU kernel) in f32, so the bf16
   cases take JAX's vjp in f32 of the bf16 inputs.  Bounds, with n = P * N
   and S = sum |G * prev| over a (b, c, h) row:
     * ``dstates``: f32 within ``SCAN_TOL`` absolute and relative (XLA may
       contract ``G * decay + dprev`` into one FMA where the port rounds
       twice, as the forward's tests say); bf16 within one bf16 ulp of
       each value plus ``SCAN_TOL`` (both round an f32 G once);
     * ``ddecays``: f32 within ``(n + NC) * 2^-24 * S`` (the sum's order,
       and G's FMA differences carried over at most NC chunks); bf16 also
       within ``2^-8 * S`` plus one ulp (the port multiplies G by the
       bf16-rounded ``prev`` it saved, JAX by the f32 carry).
2. ``SsdScanFn``'s gradient against autograd of ``ssd_scan_plain``: f32
   ``dstates`` bit for bit, ``ddecays`` within ``n * 2^-24 * S``; bf16 as
   above (autograd multiplies by the f32 carry).
3. The reduced mamba2-370m (2 layers, d_model 64, 8 heads of 16, state 16,
   chunk 32) at S = 96, three chunks, with Mamba-2's dt initialisation on
   both sides (at ``repro``'s ``dt_bias`` of 0 the chunk decays are about
   ``exp(-0.7 a 32)`` and the gradients barely see the scan): one block's
   parameter and input gradients in f32 within ``BLOCK_TOL``; the whole
   model's loss and per-leaf gradients with bf16 activations within
   ``LOSS_TOL`` and ``MODEL_TOL`` (``tests/test_torch_train.py``'s bounds;
   measured 7e-8 and 1.0e-2, the largest at ``conv/w``, where the bf16
   convolution rounds as ``repro``'s does but its gradient sums differ);
   two steps of ``make_train_step`` against ``repro``'s step run without a
   ``Sharder`` as ``test_train_step_matches_jax_unsharded`` holds qwen3.
4. Two planted faults, a backward that drops ``ddecays`` and one that
   drops the carried G, each missing the scan bound and the model bound
   (measured 0.25 at ``a_log`` and 0.28 at ``dt_bias`` against 3e-2).
5. The CUDA branch through a stand-in library: a call under grad goes
   through the Function to the backward entry point with its partials and
   counts one ``ssd_scan_bwd`` launch; a failed call raises and never
   reroutes; the C entry's partial count (``bwd_parts``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_scan_ref
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import runtime
from repro_torch.kernels.ssd_scan import ssd_scan as scan_mod
from repro_torch.kernels.ssd_scan.ops import remop_ssd_scan
from repro_torch.kernels.ssd_scan.ssd_scan import (
    bwd_parts, ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain)
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, leaves_with_paths, tree_map

ARCH = "mamba2-370m"
SCAN_TOL = 1e-6
BF16_ULP = 2.0 ** -7
BLOCK_TOL = 1e-5
LOSS_TOL = 2e-3
MODEL_TOL = 3e-2
SEQ = 96  # three chunks of the reduced config's 32
SHAPES = [(2, 5, 3, 8, 16), (1, 7, 2, 5, 3), (3, 4, 1, 4, 6), (2, 16, 4, 16, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def mamba2_dt_bias(rng, shape):
    """Mamba-2's dt initialisation: the inverse softplus of a log-uniform
    draw in [1e-3, 1e-1] per (layer,) head."""
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
    return (dt + np.log(-np.expm1(-dt))).astype(np.float32)


def _scan_case(shape, decays_kind, seed):
    """(states, decays, dprev, dfinal) as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    states = rng.standard_normal(shape).astype(np.float32)
    if decays_kind == "sigmoid":
        decays = 1 / (1 + np.exp(-rng.standard_normal(shape[:3])))
    else:  # one position's decay exp(dt * A) at A = -1 over Mamba-2's dt range
        decays = np.exp(-np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape[:3])))
    dprev = rng.standard_normal(shape).astype(np.float32)
    dfinal = rng.standard_normal((shape[0], *shape[2:])).astype(np.float32)
    return states, decays.astype(np.float32), dprev, dfinal


def _to(dtype, *arrays):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _sum_scale(dstates, prev):
    """S = sum over a (b, c, h) row of |G_{c+1} * prev[:, c]|, in f64."""
    return (dstates.double() * prev.double()).abs().sum(dim=(-2, -1))


def _jax_vjp(states, decays, dprev, dfinal):
    (prev, _), vjp = jax.vjp(jax_scan_ref, jnp.asarray(states), jnp.asarray(decays))
    dstates, ddecays = vjp((jnp.asarray(dprev), jnp.asarray(dfinal)))
    return np.asarray(prev), np.asarray(dstates), np.asarray(ddecays)


def _check_scan_grads(dstates, ddecays, want_ds, want_dd, prev, dtype, nc, slack=0.0):
    """The bounds of the docstring; ``prev`` is what the port multiplied by."""
    n = prev.shape[-1] * prev.shape[-2]
    got_ds, got_dd = dstates.double().numpy(), ddecays.double().numpy()
    want_ds, want_dd = np.asarray(want_ds, np.float64), np.asarray(want_dd, np.float64)
    scale = _sum_scale(dstates, prev).numpy()
    ulp = BF16_ULP if dtype == "bfloat16" else 0.0
    np.testing.assert_array_less(np.abs(got_ds - want_ds),
                                 SCAN_TOL + (SCAN_TOL + ulp) * np.abs(want_ds) + 1e-300)
    bound = (n + nc) * 2.0 ** -24 * scale + slack * scale + ulp * np.abs(want_dd)
    np.testing.assert_array_less(np.abs(got_dd - want_dd), bound + 1e-300)


# -- 1. the plain backward against jax.vjp -------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("decays_kind", ["sigmoid", "near 1"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_backward_matches_jax_vjp(shape, decays_kind, dtype):
    arrays = _scan_case(shape, decays_kind, seed=shape[1])
    tdt = DTYPES[dtype][1]
    states, decays, dprev, dfinal = _to(tdt, *arrays)
    # JAX in f32 on the inputs as the port holds them (bf16-rounded in bf16).
    ref_in = [x.float().numpy() for x in (states, decays, dprev, dfinal)]
    _, want_ds, want_dd = _jax_vjp(*ref_in)
    prev, _ = ssd_scan_plain(states, decays)
    dstates, ddecays = ssd_scan_bwd_plain(dprev, dfinal, prev, decays)
    assert dstates.dtype == prev.dtype == tdt and ddecays.dtype == tdt
    assert dstates.shape == states.shape and ddecays.shape == decays.shape
    _check_scan_grads(dstates, ddecays, want_ds, want_dd, prev, dtype, shape[1],
                      slack=2.0 ** -8 if dtype == "bfloat16" else 0.0)


def test_jax_vjp_of_the_scan_is_its_recurrence():
    """The reference itself: ``jax.vjp`` gives dstates[:, c] = G_{c+1} and
    ddecays = sum G_{c+1} prev[:, c] with G carried backwards (f64 numpy)."""
    states, decays, dprev, dfinal = (a.astype(np.float64) for a in
                                     _scan_case((2, 6, 3, 4, 5), "sigmoid", seed=1))
    prev, want_ds, want_dd = _jax_vjp(*(a.astype(np.float32) for a in
                                        (states, decays, dprev, dfinal)))
    g, ds, dd = dfinal, np.empty_like(states), np.empty_like(decays)
    for c in reversed(range(states.shape[1])):
        ds[:, c] = g
        dd[:, c] = (g * prev[:, c]).sum(axis=(-2, -1))
        g = dprev[:, c] + g * decays[:, c, :, None, None]
    np.testing.assert_allclose(want_ds, ds, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want_dd, dd, rtol=1e-5, atol=1e-4)


# -- 2. the Function against autograd of the plain loop -------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_function_gradient_matches_autograd_of_the_plain_loop(shape, dtype):
    tdt = DTYPES[dtype][1]
    states, decays, dprev, dfinal = _to(tdt, *_scan_case(shape, "sigmoid", seed=3))
    grads = []
    for fn in (ssd_scan_plain, ssd_scan):
        s, d = states.clone().requires_grad_(), decays.clone().requires_grad_()
        prev, final = fn(s, d)
        grads.append(torch.autograd.grad((prev, final), (s, d), (dprev, dfinal)) + (prev,))
    (want_ds, want_dd, _), (got_ds, got_dd, prev) = grads
    assert type(prev.grad_fn).__name__ == "SsdScanFnBackward"
    if dtype == "float32":
        assert torch.equal(got_ds, want_ds)
    _check_scan_grads(got_ds, got_dd, want_ds.double().numpy(), want_dd.double().numpy(),
                      prev.detach(), dtype, 0, slack=2.0 ** -8 if dtype == "bfloat16" else 0.0)


def test_function_forward_is_the_no_grad_forward():
    states, decays, _, _ = _to(torch.float32, *_scan_case((2, 5, 3, 8, 16), "near 1", seed=4))
    want = ssd_scan(states, decays)
    got = remop_ssd_scan(states.requires_grad_(), decays)
    assert all(torch.equal(g.detach(), w) for g, w in zip(got, want))
    assert got[0].grad_fn is not None and got[1].grad_fn is not None


def test_backward_checks_its_inputs():
    prev = torch.zeros(1, 2, 3, 4, 4)
    decays = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="dfinal"):
        ssd_scan_bwd(prev, torch.zeros(1, 3, 4, 5), prev, decays)
    with pytest.raises(TypeError, match="dprev"):
        ssd_scan_bwd(prev.double(), torch.zeros(1, 3, 4, 4), prev, decays)
    runtime.reset_launches()
    ssd_scan_bwd(prev, torch.zeros(1, 3, 4, 4), prev, decays)
    assert runtime.launches["ssd_scan_bwd"] == 0  # CPU tensors launch nothing


# -- 3. mamba2-370m training against repro ---------------------------------------------


def _with_dt_init(jparams, seed=0):
    """repro's params with every layer's dt_bias drawn from Mamba-2's range."""
    ssm_p = jparams["seg0"]["b0_ssm"]["ssm"]
    bias = mamba2_dt_bias(np.random.default_rng(seed), ssm_p["dt_bias"].shape)
    seg = {**jparams["seg0"]["b0_ssm"], "ssm": {**ssm_p, "dt_bias": jnp.asarray(bias)}}
    return {**jparams, "seg0": {**jparams["seg0"], "b0_ssm": seg}}


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jax_reduced(JAX_ARCHS[ARCH]), reduced(ARCHS[ARCH])
    jparams = _with_dt_init(jtf.init_params(jax.random.key(0), jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu", torch.float32)
    return jcfg, jparams, cfg, params


def _live(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


def _batch(cfg, seed=3, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return {"tokens": tokens, "targets": tokens}


def test_block_gradients_match_jax_in_f32(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (2, SEQ))
    jblock = jax.tree.map(lambda a: a[0], jparams["seg0"]["b0_ssm"])

    def jloss(p, xx):
        out, _, _ = jtf.block_forward(p, jcfg, "ssm", xx, jnp.asarray(pos), jnp.asarray(pos))
        return jnp.sum(out * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jblock, jnp.asarray(x))
    block = _live(params["layers"][0])
    xt = torch.from_numpy(x).requires_grad_()
    out, _, _ = tf.block_forward(block, cfg, "ssm", xt, torch.from_numpy(pos.copy()))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves(block) + [xt])
    want = leaves(jax.tree.map(np.asarray, jgp)) + [np.asarray(jgx)]
    assert len(grads) == len(want)
    errs = [_rel(g.numpy(), w_) for g, w_ in zip(grads, want)]
    assert max(errs) <= BLOCK_TOL, errs


def _model_errors(models):
    jcfg, jparams, cfg, params = models
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


def test_model_loss_and_gradients_match_jax_in_bf16(models):
    runtime.reset_launches()
    loss_err, errs = _model_errors(models)
    assert loss_err <= LOSS_TOL
    assert max(errs.values()) <= MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert not runtime.launches  # the CPU launches nothing


def test_the_model_gradients_go_through_the_function(models, monkeypatch):
    """Every layer's scan takes ``SsdScanFn``'s backward, once a layer
    (remat recomputes the forward, not the backward)."""
    calls = []
    bwd = scan_mod.ssd_scan_bwd

    def counted(*args):
        calls.append(args[0].shape)
        return bwd(*args)

    monkeypatch.setattr(scan_mod, "ssd_scan_bwd", counted)
    _, _, cfg, params = models
    live = _live(params)
    loss, _ = tf.loss_fn(live, cfg, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    torch.autograd.grad(loss, leaves(live))
    assert calls == [(2, SEQ // cfg.ssm_chunk, cfg.n_ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_state)] * cfg.n_layers


def test_train_step_matches_jax_unsharded():
    jcfg, cfg = jax_reduced(JAX_ARCHS[ARCH]), reduced(ARCHS[ARCH])
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**opt), None))
    step = steps_lib.make_train_step(cfg, AdamWConfig(**opt))
    jstate = jsteps.init_state(jcfg, jax.random.key(0))
    jstate = {**jstate, "params": _with_dt_init(jstate["params"])}
    state = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    before = [x.clone() for x in leaves(state["params"])]
    for i in range(2):
        batch = _batch(cfg, seed=10 + i, b=4)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
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


# -- 4. planted faults ---------------------------------------------------------------


def _drops_ddecays(dprev, dfinal, prev, decays):
    dstates, ddecays = ssd_scan_bwd_plain(dprev, dfinal, prev, decays)
    return dstates, torch.zeros_like(ddecays)


def _drops_carried_g(dprev, dfinal, prev, decays):
    """G_c = dprev[:, c]: the carried G_{c+1} * decays[:, c] left out."""
    return ssd_scan_bwd_plain(dprev, dfinal, prev, torch.zeros_like(decays))


FAULTS = {"drops ddecays": _drops_ddecays, "drops the carried G": _drops_carried_g}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_misses_the_scan_bound(fault):
    arrays = _scan_case((2, 5, 3, 8, 16), "near 1", seed=5)
    states, decays, dprev, dfinal = _to(torch.float32, *arrays)
    _, want_ds, want_dd = _jax_vjp(*arrays)
    prev, _ = ssd_scan_plain(states, decays)
    dstates, ddecays = FAULTS[fault](dprev, dfinal, prev, decays)
    with pytest.raises(AssertionError):
        _check_scan_grads(dstates, ddecays, want_ds, want_dd, prev, "float32", 5)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_misses_the_model_bound(models, monkeypatch, fault):
    monkeypatch.setattr(scan_mod, "ssd_scan_bwd_plain", FAULTS[fault])
    _, errs = _model_errors(models)
    assert max(errs.values()) > MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


# -- 5. the CUDA branch through a stand-in library -----------------------------------


class _FakeLibrary:
    def __init__(self, bwd_error=0):
        self.calls = []
        self.bwd_error = bwd_error

    def remop_ssd_scan_f32(self, *args):
        self.calls.append(("fwd_f32", args))
        return 0

    def remop_ssd_scan_bwd_f32(self, *args):
        self.calls.append(("bwd_f32", args))
        return self.bwd_error

    def remop_ssd_scan_bwd_bf16(self, *args):
        self.calls.append(("bwd_bf16", args))
        return self.bwd_error

    def remop_ssd_scan_error_string(self, err):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    runtime.reset_launches()

    def install(lib):
        monkeypatch.setattr(runtime, "library", lambda name: lib)
        return lib

    yield install
    runtime.reset_launches()


def _under_grad(shape=(2, 8, 32, 64, 128)):
    states = torch.zeros(shape, requires_grad=True)
    decays = torch.zeros(shape[:3], requires_grad=True)
    return states, decays


def test_a_call_under_grad_reaches_the_backward_kernel_and_counts(fake_card):
    lib = fake_card(_FakeLibrary())
    states, decays = _under_grad()
    prev, final = remop_ssd_scan(states, decays)
    assert [name for name, _ in lib.calls] == ["fwd_f32"]
    assert dict(runtime.launches) == {"ssd_scan": 1}
    torch.autograd.grad((prev, final), (states, decays),
                        (torch.ones_like(prev), torch.ones_like(final)))
    (name, args), = lib.calls[1:]
    assert name == "bwd_f32"
    assert args[2] == lib.calls[0][1][2]  # the forward's prev, saved
    # b, nc, h, p * n and the partials a row: 8192 elements, 1024 a CTA, 8 warps each
    assert args[7:12] == (2, 8, 32, 8192, 64) and bwd_parts(8192, torch.float32) == 64
    assert dict(runtime.launches) == {"ssd_scan": 1, "ssd_scan_bwd": 1}


def test_a_failed_backward_raises_and_never_reroutes(fake_card, monkeypatch):
    lib = fake_card(_FakeLibrary(bwd_error=700))
    plain = []
    monkeypatch.setattr(scan_mod, "ssd_scan_bwd_plain", lambda *a: plain.append(a))
    states, decays = _under_grad((1, 3, 2, 4, 4))
    prev, final = ssd_scan(states, decays)
    with pytest.raises(RuntimeError, match="ssd_scan_bwd: CUDA error 700"):
        torch.autograd.grad(prev.sum() + final.sum(), (states, decays))
    assert [name for name, _ in lib.calls] == ["fwd_f32", "bwd_f32"] and not plain
    assert dict(runtime.launches) == {"ssd_scan": 1}


@pytest.mark.parametrize("pn,dtype,want", [(8192, torch.float32, 64), (8192, torch.bfloat16, 32),
                                           (15, torch.float32, 8), (2049, torch.bfloat16, 16),
                                           (1024, torch.float32, 8)])
def test_bwd_parts(pn, dtype, want):
    assert bwd_parts(pn, dtype) == want


def test_the_cuda_branch_wants_contiguous_inputs(fake_card):
    fake_card(_FakeLibrary())
    prev = torch.zeros(1, 2, 3, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_bwd(prev.transpose(-1, -2), torch.zeros(1, 3, 4, 4), prev,
                     torch.zeros(1, 2, 3))

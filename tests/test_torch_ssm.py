"""The port's Mamba-2 path against the JAX package's, at reduced size.

Inputs are numpy arrays from a seed, handed to both packages.  The JAX
scan kernel runs in Pallas interpret mode, as ``tests/test_kernels.py``
runs it on the CPU; the port's wrapper on CPU tensors takes the kernel's
plain version.  ``reduced(mamba2-370m)`` (2 layers, d_model 64, 8 heads of
16, state 16, chunk 32) is initialised by ``repro``'s ``tf.init_params``
and carried over with ``params_from_jax``.

Tolerances, and why:
  * scan, f32: ``1e-6`` absolute and relative.  Both keep an f32 carry;
    XLA may contract ``carry * decay + state`` into one FMA where the port
    rounds twice (up to 5e-7 seen).
  * scan, bf16: one bf16 ulp (``2^-7`` relative) plus the f32 rule's
    ``1e-6`` absolute: both round an f32 carry once, and the two carries
    differ by the f32 noise above, which near a cancellation (a carry of
    ~1e-5) is more than one ulp of the rounded value.
  * ``ssd_forward`` in f32 (JAX given the bf16-rounded weights the port
    holds, activations in f32): ``F32_TOL = 1e-5`` of the output's scale.
    Both compute the same function in f32 and differ only in the order of
    the chunk contractions (up to 1.5e-6 seen).  This is the comparison
    that sees the scan: at random init the carried state adds ~0.2% of the
    output's scale, far below a bf16 rule and far above ``F32_TOL``
    (``test_ssd_forward_parity_sees_the_scan``).
  * ``ssd_forward`` in bf16: the output within one bf16 ulp of its largest
    value (``2^-7`` of the scale), the conv state bit for bit, the f32
    final state within ``1e-4`` of its scale.  The port rounds where JAX
    rounds (the bf16 conv, ``jax.nn.silu`` step by step), so the bf16
    outputs are nearly identical (1.3e-4 of the scale seen).
  * whole model and serving: ``BF16_TOL = 1e-2`` of the logits' scale, as
    for the dense decoder (``tests/test_torch_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.kernels.ssd_scan.ops import remop_ssd_scan as jax_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_scan_ref
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.runtime.serve_loop import Request as JaxRequest, ServeEngine as JaxServeEngine

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import runtime
from repro_torch.kernels.ssd_scan import ssd_scan as scan_mod
from repro_torch.kernels.ssd_scan.ops import remop_ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.serve_loop import Request, ServeEngine

ARCH = "mamba2-370m"
F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7
BF16_TOL = 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _err(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want|."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _scan_inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    states = rng.standard_normal(shape).astype(np.float32)
    decays = (1 / (1 + np.exp(-rng.standard_normal(shape[:3])))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(states).astype(jdt), jnp.asarray(decays).astype(jdt)),
            (torch.from_numpy(states).to(tdt), torch.from_numpy(decays).to(tdt)))


def _scan_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)


# -- the scan kernel's plain version ---------------------------------------------


REDUCED_SCAN = (2, 4, 8, 16, 16)  # reduced mamba2: b, nc, h = 8 heads, p = 16, n = 16


@pytest.mark.parametrize("shape", [(1, 4, 2, 8, 4), (2, 16, 4, 16, 8), (3, 7, 1, 4, 4),
                                   REDUCED_SCAN])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_scan_matches_pallas_kernel(shape, dtype):
    (jstates, jdecays), (states, decays) = _scan_inputs(shape[1], shape, dtype)
    want_prev, want_final = jax_scan(jstates, jdecays)
    prev, final = remop_ssd_scan(states, decays)
    assert prev.dtype == final.dtype == states.dtype
    assert final.shape == states[:, 0].shape
    _scan_close(prev, want_prev, dtype)
    _scan_close(final, want_final, dtype)
    plain = ssd_scan_plain(states, decays)
    assert torch.equal(prev, plain[0]) and torch.equal(final, plain[1])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_scan_ref_with_initial_matches_jax(dtype):
    shape = (2, 5, 3, 4, 6)
    (jstates, jdecays), (states, decays) = _scan_inputs(7, shape, dtype)
    s0 = np.random.default_rng(8).standard_normal((2, 3, 4, 6)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want_prev, want_final = jax_scan_ref(jstates, jdecays, initial=jnp.asarray(s0).astype(jdt))
    prev, final = ssd_scan_ref(states, decays, initial=torch.from_numpy(s0).to(tdt))
    assert prev.dtype == final.dtype == tdt
    _scan_close(prev, want_prev, dtype)
    _scan_close(final, want_final, dtype)
    np.testing.assert_array_equal(prev[:, 0].float().numpy(),
                                  torch.from_numpy(s0).to(tdt).float().numpy())
    if dtype == "float32":  # zero carry: the ref is the plain version's loop
        p0, f0 = ssd_scan_ref(states, decays)
        p1, f1 = ssd_scan_plain(states, decays)
        assert torch.equal(p0, p1) and torch.equal(f0, f1)


def test_ssd_scan_wrapper_checks_its_inputs():
    states = torch.zeros(1, 2, 3, 4, 4)
    with pytest.raises(ValueError, match="decays"):
        ssd_scan(states, torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="decays"):
        ssd_scan(states[0], torch.zeros(2, 3))
    with pytest.raises(ValueError, match="one chunk"):
        ssd_scan(torch.zeros(1, 0, 3, 4, 4), torch.zeros(1, 0, 3))
    with pytest.raises(TypeError):
        ssd_scan(states, torch.zeros(1, 2, 3, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        ssd_scan(states.to(torch.float16), torch.zeros(1, 2, 3, dtype=torch.float16))
    runtime.reset_launches()
    ssd_scan(states, torch.ones(1, 2, 3))
    assert runtime.launches["ssd_scan"] == 0  # CPU tensors launch nothing


# -- the SSD block ---------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jax_reduced(JAX_ARCHS[ARCH]), reduced(ARCHS[ARCH])
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def mamba2_dt_bias(rng, n_heads):
    """Mamba-2's dt initialisation: the inverse softplus of a log-uniform
    draw in [1e-3, 1e-1] per head."""
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), n_heads))
    return (dt + np.log(-np.expm1(-dt))).astype(np.float32)


def _block(models, dt_init, precision, rng):
    """Layer 0's SSM parameters in both packages.  In f32 JAX gets the
    bf16-rounded matrices the port holds, so both compute one function."""
    jcfg, jparams, cfg, params = models
    jp = jax.tree.map(lambda a: a[0], jparams["seg0"]["b0_ssm"]["ssm"])
    p = dict(params["layers"][0]["ssm"])
    if precision == "float32":
        jp = jax.tree.map(
            lambda a: a.astype(jnp.bfloat16).astype(jnp.float32) if a.ndim == 2 else a, jp)
    if dt_init == "mamba2":
        bias = mamba2_dt_bias(rng, cfg.n_ssm_heads)
        jp = dict(jp, dt_bias=jnp.asarray(bias))
        p["dt_bias"] = torch.from_numpy(bias)
    return jp, p


def _ssd_pair(models, s, dt_init, precision, seed, initial=False):
    jcfg, _, cfg, _ = models
    rng = np.random.default_rng(seed)
    jp, p = _block(models, dt_init, precision, rng)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jdt, tdt = DTYPES[precision]
    kw, jkw = {}, {}
    if initial:
        s0 = rng.standard_normal((2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state)).astype(np.float32) * 0.1
        kw, jkw = {"initial_state": torch.from_numpy(s0)}, {"initial_state": jnp.asarray(s0)}
    jout = jssm.ssd_forward(jp, jcfg, jnp.asarray(x).astype(jdt), return_state=True, **jkw)
    out = ssm.ssd_forward(p, cfg, torch.from_numpy(x).to(tdt), return_state=True, **kw)
    return out, jout


SEQS = (20, 32, 96)  # one short chunk, one full chunk, three chunks


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("dt_init", ["jax", "mamba2"])
@pytest.mark.parametrize("initial", [False, True], ids=["zero", "initial_state"])
def test_ssd_forward_matches_jax_in_f32(models, s, dt_init, initial):
    (out, (conv, state)), (jout, (jconv, jstate)) = _ssd_pair(
        models, s, dt_init, "float32", seed=s, initial=initial)
    assert out.dtype == conv.dtype == state.dtype == torch.float32
    assert _err(out, jout) <= F32_TOL
    assert _err(conv, jconv) <= F32_TOL
    assert _err(state, jstate) <= F32_TOL


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("dt_init", ["jax", "mamba2"])
def test_ssd_forward_matches_jax_in_bf16(models, s, dt_init):
    (out, (conv, state)), (jout, (jconv, jstate)) = _ssd_pair(
        models, s, dt_init, "bfloat16", seed=s)
    assert out.dtype == conv.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert _err(out, jout) <= BF16_ULP
    np.testing.assert_array_equal(conv.float().numpy(), np.asarray(jconv, np.float32))
    assert _err(state, jstate) <= 1e-4


def test_ssd_forward_parity_sees_the_scan(models, monkeypatch):
    """With the plain scan's ``prev`` zeroed the f32 parity fails at the
    Mamba-2 dt range, so the comparisons above are not blind to the scan."""
    plain = scan_mod.ssd_scan_plain

    def zeroed(states, decays):
        prev, final = plain(states, decays)
        return torch.zeros_like(prev), final

    monkeypatch.setattr(scan_mod, "ssd_scan_plain", zeroed)
    (out, (_, state)), (jout, (_, jstate)) = _ssd_pair(models, 96, "mamba2", "float32", seed=96)
    assert _err(state, jstate) <= F32_TOL  # the final carry is untouched ...
    assert _err(out, jout) > 100 * F32_TOL  # ... but every later chunk's output moves


def test_seq_not_a_chunk_multiple_raises_as_in_jax(models):
    jcfg, jparams, cfg, params = models
    jp = jax.tree.map(lambda a: a[0], jparams["seg0"]["b0_ssm"]["ssm"])
    x = np.zeros((1, cfg.ssm_chunk + 8, cfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="not divisible"):
        jssm.ssd_forward(jp, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="not divisible"):
        ssm.ssd_forward(params["layers"][0]["ssm"], cfg, torch.from_numpy(x))


@pytest.mark.parametrize("dt_init", ["jax", "mamba2"])
def test_ssd_decode_step_matches_jax(models, dt_init):
    jcfg, _, cfg, _ = models
    rng = np.random.default_rng(11)
    jp, p = _block(models, dt_init, "bfloat16", rng)
    conv_shape, state_shape = ssm.ssm_cache_shapes(cfg, 2)
    assert (conv_shape, state_shape) == jssm.ssm_cache_shapes(jcfg, 2)
    conv = rng.standard_normal(conv_shape).astype(np.float32)
    state = rng.standard_normal(state_shape).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, (jconv, jstate) = jssm.ssd_decode(
        jp, jcfg, jnp.asarray(x).astype(jnp.bfloat16),
        (jnp.asarray(conv).astype(jnp.bfloat16), jnp.asarray(state)))
    out, (nconv, nstate) = ssm.ssd_decode(
        p, cfg, torch.from_numpy(x).to(torch.bfloat16),
        (torch.from_numpy(conv).to(torch.bfloat16), torch.from_numpy(state)))
    assert out.dtype == nconv.dtype == torch.bfloat16 and nstate.dtype == torch.float32
    assert _err(out, jout) <= BF16_ULP
    np.testing.assert_array_equal(nconv.float().numpy(), np.asarray(jconv, np.float32))
    assert _err(nstate, jstate) <= F32_TOL


# -- the whole model -------------------------------------------------------------


def test_params_from_jax_keeps_every_leaf(models):
    jcfg, jparams, cfg, params = models
    assert tf.param_count(params) == jtf.param_count(jparams)
    jleaves = jax.tree_util.tree_flatten_with_path(jparams["seg0"]["b0_ssm"])[0]
    for layer in range(cfg.n_layers):
        for path, jleaf in jleaves:
            leaf = params["layers"][layer]
            for key in path:
                leaf = leaf[key.key]
            name = path[-1].key
            f32 = name in ("scale", "a_log", "dt_bias", "d_skip")
            assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), name
            want = np.asarray(jleaf[layer]).astype(np.float32)
            if not f32:
                want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32)
            np.testing.assert_array_equal(leaf.float().numpy(), want)
    assert set(params["layers"][0]) == {"norm1", "ssm"}
    fresh = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), fresh)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params))
    with pytest.raises(ValueError, match="b0_ssm"):
        params_from_jax({"embed": {}, "final_norm": {}, "seg0": {"b0_attn": {}}}, cfg,
                        device="cpu")


@pytest.mark.parametrize("prompt_len", [20, 64])
def test_prefill_and_teacher_forced_decode_match_jax(models, prompt_len):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(prompt_len)
    prompt = rng.integers(0, cfg.vocab_size, (2, prompt_len), dtype=np.int32)
    jlogits, jcaches = jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    logits, caches = tf.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)})
    assert _err(logits, jlogits) <= BF16_TOL
    full, _, _ = tf.forward(params, cfg, {"tokens": torch.from_numpy(prompt)})
    torch.testing.assert_close(full[:, -1], logits, rtol=0, atol=0)

    max_len = prompt_len + 12
    jcaches = jtf.pad_caches(jcfg, jcaches, max_len)
    caches = tf.pad_caches(cfg, caches, max_len)
    token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for pos in range(prompt_len, max_len - 1):
        jlogits, jcaches = jtf.decode_step(jparams, jcfg, jcaches, token,
                                           jnp.asarray(pos, jnp.int32))
        logits, caches = tf.decode_step(params, cfg, caches,
                                        torch.from_numpy(np.array(token)), pos)
        assert _err(logits, jlogits) <= BF16_TOL
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    jconv, jstate = jcaches[0]["b0_ssm"]
    for layer, (conv, state) in enumerate(caches):
        assert _err(state, jstate[layer]) <= BF16_TOL
        assert _err(conv, jconv[layer]) <= BF16_TOL


def test_cache_struct_and_pad_caches(models):
    jcfg, jparams, cfg, params = models
    _, caches = tf.prefill(params, cfg, {"tokens": torch.zeros(3, 32, dtype=torch.int32)})
    (jstruct,) = jtf.cache_struct(jcfg, 3, 100)
    jconv, jstate = jstruct["b0_ssm"]
    struct = tf.cache_struct(cfg, 3, 100)
    assert len(struct) == len(caches) == jconv.shape[0] == cfg.n_layers
    for (conv_spec, state_spec), (conv, state) in zip(struct, caches):
        assert conv_spec == (torch.Size(jconv.shape[1:]), torch.bfloat16)
        assert state_spec == (torch.Size(jstate.shape[1:]), torch.float32)
        assert (conv.shape, conv.dtype) == conv_spec
        assert (state.shape, state.dtype) == state_spec
    padded = tf.pad_caches(cfg, caches, 100)
    assert len(padded) == len(caches)
    for (conv, state), (pconv, pstate) in zip(caches, padded):
        assert pconv is conv and pstate is state  # fixed-size: untouched


# -- serving ---------------------------------------------------------------------------


def test_serve_engine_step_logits_match_jax(models, monkeypatch):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in (64, 7, 32)]

    jax_calls = []
    prefill = jtf.prefill

    def recording_prefill(p, c, batch):
        logits, caches = prefill(p, c, batch)
        jax_calls.append(("prefill", logits[0]))
        return logits, caches

    monkeypatch.setattr(jtf, "prefill", recording_prefill)
    jengine = JaxServeEngine(jcfg, jparams, max_len=96, batch_slots=2)
    decode = jengine._decode

    def recording_decode(p, c, t, pos):
        logits, c = decode(p, c, t, pos)
        jax_calls.append(("decode", logits[0]))
        return logits, c

    jengine._decode = recording_decode
    jresults = jengine.submit(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])

    calls = []
    engine = ServeEngine(cfg, params, max_len=96, batch_slots=2, device="cpu",
                         on_step=lambda req, logits, hidden: calls.append((req.rid, logits)))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    runtime.reset_launches()
    results = engine.submit(reqs)
    assert sum(runtime.launches.values()) == 0

    assert results == jresults
    assert len(calls) == len(jax_calls) == 3 * 6
    seen = set()
    for (rid, logits), (kind, jlogits) in zip(calls, jax_calls):
        assert kind == ("decode" if rid in seen else "prefill")
        seen.add(rid)
        assert _err(logits, jlogits) <= BF16_TOL

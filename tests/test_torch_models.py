"""The port's dense decoder against the JAX package's, at reduced size.

``reduced(gemma-2b)`` (MQA, GeGLU) and ``reduced(qwen3-0.6b)`` (GQA, SwiGLU,
qk-norm) are initialised with ``repro``'s ``tf.init_params`` and carried
over with ``params_from_jax``; inputs are numpy arrays from a seed.  The
JAX model runs without a ``Sharder`` (its ``constrain`` is then a no-op).

Tolerance.  Both compute in bf16, but round at other places: JAX's
``full_attention`` rounds the scores and P to bf16, the port's kernels keep
them in f32, and the bf16 matrix products sum in other orders.  Logits and
activations are held to ``max|got - want| <= BF16_TOL * max|want|`` with
``BF16_TOL = 1e-2``; the differences found are 2-4e-3 of the logits' scale
(logits up to ~7, differences up to 0.023, one or two bf16 steps there).
Token streams are not compared alone: at random init greedy decoding
repeats the last prompt token whatever attention computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.runtime.serve_loop import Request as JaxRequest, ServeEngine as JaxServeEngine

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import runtime
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.serve_loop import Request, ServeEngine

BF16_TOL = 1e-2
MODEL_ARCHS = ("gemma-2b", "qwen3-0.6b")


def _close(got: torch.Tensor, want, tol: float = BF16_TOL) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, err
    return err


def _rel(got: torch.Tensor, want) -> float:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _models(arch):
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch]), reduced(ARCHS[arch])
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=MODEL_ARCHS)
def models(request):
    return _models(request.param)


def _bf16(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


# -- layers ------------------------------------------------------------------------


def test_rmsnorm_dense_embed_unembed_match_jax():
    rng = np.random.default_rng(0)
    jx, x = _bf16(rng, 2, 5, 64)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)}, x),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx), 8e-3)
    w = rng.standard_normal((64, 48)).astype(np.float32) / 8
    _close(layers.dense({"w": torch.from_numpy(w).to(torch.bfloat16)}, x),
           jlayers.dense({"w": jnp.asarray(w)}, jx))
    table = rng.standard_normal((128, 64)).astype(np.float32) / 8
    tokens = rng.integers(0, 128, (2, 5)).astype(np.int32)
    ptable = {"table": torch.from_numpy(table).to(torch.bfloat16)}
    emb = layers.embed(ptable, torch.from_numpy(tokens), scale_by_sqrt_dim=True)
    jemb = jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens), True)
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.float().numpy(), np.asarray(jemb, np.float32))
    _close(layers.unembed(ptable, x), jlayers.unembed({"table": jnp.asarray(table)}, jx))


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(mlp_type):
    jp = jlayers.init_mlp(jax.random.key(1), 64, 128, mlp_type)
    if mlp_type == "gelu":
        jp.pop("w_gate", None)
    p = {k: {"w": torch.from_numpy(np.array(v["w"])).to(torch.bfloat16)}
         for k, v in jp.items()}
    jx, x = _bf16(np.random.default_rng(2), 3, 64)
    _close(layers.mlp(p, x, mlp_type), jlayers.mlp(jp, jx, mlp_type))


def test_rope_matches_jax():
    positions = np.arange(40, dtype=np.int32).reshape(2, 20) * 37
    cos, sin = layers.rope_tables(torch.from_numpy(positions), 16, 1e4)
    jcos, jsin = jlayers.rope_tables(jnp.asarray(positions), 16, 1e4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-5)
    jx, x = _bf16(np.random.default_rng(3), 2, 20, 4, 16)
    _close(layers.apply_rope(x, cos, sin), jlayers.apply_rope(jx, jcos, jsin), 8e-3)


# -- attention --------------------------------------------------------------------


def test_gqa_forward_and_decode_match_jax(models):
    jcfg, jparams, cfg, params = models
    jp = jax.tree.map(lambda a: a[0], jparams["seg0"]["b0_attn"]["attn"])
    p = params["layers"][0]["attn"]
    rng = np.random.default_rng(4)
    s, max_len = 9, 16
    jx, x = _bf16(rng, 2, s, cfg.d_model)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    jout, (jk, jv) = jattn.gqa_forward(jp, jcfg, jx, jnp.asarray(positions), return_kv=True)
    out, (k, v) = attn.gqa_forward(p, cfg, x, torch.from_numpy(positions.copy()),
                                   return_kv=True)
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)

    def pad(a):
        return jnp.pad(a, ((0, 0), (0, max_len - s), (0, 0), (0, 0)))

    jcache = (pad(jk), pad(jv))
    cache = tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, max_len - s)) for a in (k, v))
    for pos in range(s, s + 3):
        jx1, x1 = _bf16(rng, 2, 1, cfg.d_model)
        jout, jcache = jattn.gqa_decode(jp, jcfg, jx1, jcache, jnp.asarray(pos, jnp.int32))
        out, cache = attn.gqa_decode(p, cfg, x1, cache, pos)
        _close(out, jout)
        _close(cache[0], jcache[0])
    assert attn.gqa_cache_shape(cfg, 2, max_len) == jattn.gqa_cache_shape(jcfg, 2, max_len)


def test_unported_attention_variants_raise():
    """The attention softcap and the int8 KV cache, which raised before they
    were ported, compute ``repro``'s at one layer of reduced gemma-2b:
    ``gqa_forward`` and ``gqa_decode`` with a cap that bites (0.5 on ``wq``
    times 2: at least 10% of the scores above it, the capped output apart
    from the uncapped one by more than 10 ``BF16_TOL``), and ``gqa_decode``
    over an int8 cache (every entry byte for byte); a 4-tuple cross cache
    raises, as ``repro`` never quantizes one.  A window computes
    ``repro``'s too, and recurrentgemma, paligemma and seamless-m4t
    initialise with a cap."""
    cfg = reduced(ARCHS["gemma-2b"], attn_softcap=0.5)
    jcfg = jax_reduced(JAX_ARCHS["gemma-2b"], attn_softcap=0.5)
    jp = jattn.init_gqa(jax.random.key(5), jcfg)
    jp["wq"]["w"] = jp["wq"]["w"] * 2
    p = {k: {"w": torch.from_numpy(np.array(v["w"])).to(torch.bfloat16)} for k, v in jp.items()}
    rng = np.random.default_rng(5)
    jx, xs = _bf16(rng, 2, 20, cfg.d_model)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    tpos = torch.from_numpy(pos.copy())
    _close(attn.gqa_forward(p, cfg, xs, tpos, window=8),
           jattn.gqa_forward(jp, jcfg, jx, jnp.asarray(pos), window=8))
    want, (jk, jv) = jattn.gqa_forward(jp, jcfg, jx, jnp.asarray(pos), return_kv=True)
    got, (k, v) = attn.gqa_forward(p, cfg, xs, tpos, return_kv=True)
    _close(got, want)
    q, _, _ = attn._gqa_qkv(p, cfg, xs, tpos)
    scores = torch.einsum("bshd,btkd->bhst", q.float(), k.float()) / cfg.head_dim ** 0.5
    causal = torch.ones(20, 20, dtype=torch.bool).tril()
    assert float((scores.abs() > 0.5)[:, :, causal].float().mean()) >= 0.1
    uncapped = attn.gqa_forward(p, reduced(ARCHS["gemma-2b"]), xs, tpos)
    assert _rel(uncapped, want) > 10 * BF16_TOL
    # Decode, bf16 and int8 caches, from the prefill's rows.
    jcache = tuple(jnp.pad(a, ((0, 0), (0, 4), (0, 0), (0, 0))) for a in (jk, jv))
    cache = tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 4)) for a in (k, v))
    (jkq, jks), (jvq, jvs) = (jattn.quantize_kv(a) for a in jcache)
    jq8 = (jkq, jvq, jks, jvs)
    (kq, ks), (vq, vs) = (attn.quantize_kv(a) for a in cache)
    q8 = (kq, vq, ks, vs)
    for step in range(20, 24):
        jx1, x1 = _bf16(rng, 2, 1, cfg.d_model)
        jstep = jnp.asarray(step, jnp.int32)
        jout, jcache = jattn.gqa_decode(jp, jcfg, jx1, jcache, jstep)
        out, cache = attn.gqa_decode(p, cfg, x1, cache, step)
        _close(out, jout)
        jout8, jq8 = jattn.gqa_decode(jp, jcfg, jx1, jq8, jstep)
        out8, q8 = attn.gqa_decode(p, cfg, x1, q8, step)
        _close(out8, jout8)
        for got8, want8 in zip(q8, jq8):
            np.testing.assert_array_equal(
                got8.contiguous().view(torch.uint8).numpy(), np.asarray(want8).view(np.uint8))
    with pytest.raises(ValueError, match="never quantizes"):
        attn.cross_decode(p, cfg, x1, q8)
    for arch in ("recurrentgemma-2b", "paligemma-3b", "seamless-m4t-large-v2"):
        tf.init_params(reduced(ARCHS[arch], attn_softcap=50.0), device="cpu")


# -- the whole model ----------------------------------------------------------------


def test_params_from_jax_keeps_every_weight(models):
    jcfg, jparams, cfg, params = models
    assert tf.param_count(params) == jtf.param_count(jparams)
    layer = params["layers"][1]
    assert layer["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert layer["norm1"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        layer["mlp"]["w_down"]["w"].float().numpy(),
        np.asarray(jparams["seg0"]["b0_attn"]["mlp"]["w_down"]["w"][1].astype(jnp.bfloat16),
                   np.float32))
    fresh = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tf.param_count(fresh) == tf.param_count(params)
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), fresh)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params))


def test_prefill_and_teacher_forced_decode_match_jax(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    jlogits, jcaches = jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    logits, caches = tf.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)})
    _close(logits, jlogits)
    full, _, _ = tf.forward(params, cfg, {"tokens": torch.from_numpy(prompt)})
    torch.testing.assert_close(full[:, -1], logits, rtol=0, atol=0)

    max_len = 24
    jcaches = jtf.pad_caches(jcfg, jcaches, max_len)
    caches = tf.pad_caches(cfg, caches, max_len)
    # Teacher forcing: both models decode JAX's own greedy stream.
    token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for pos in range(12, max_len - 1):
        jlogits, jcaches = jtf.decode_step(jparams, jcfg, jcaches, token,
                                           jnp.asarray(pos, jnp.int32))
        logits, caches = tf.decode_step(params, cfg, caches, torch.from_numpy(np.asarray(token)),
                                        pos)
        _close(logits, jlogits)
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)


def test_cache_struct_and_pad_caches_shapes(models):
    jcfg, jparams, cfg, params = models
    prompt = torch.zeros(3, 7, dtype=torch.int32)
    _, caches = tf.prefill(params, cfg, {"tokens": prompt})
    padded = tf.pad_caches(cfg, caches, 20)
    (jstruct,) = jtf.cache_struct(jcfg, 3, 20)
    jk, jv = jstruct["b0_attn"]
    struct = tf.cache_struct(cfg, 3, 20)
    assert len(struct) == len(padded) == jk.shape[0] == cfg.n_layers
    for (kspec, vspec), (k, v) in zip(struct, padded):
        assert kspec == vspec == (torch.Size(jk.shape[1:]), torch.bfloat16)
        assert k.shape == v.shape == kspec[0] and k.dtype == torch.bfloat16
        assert torch.equal(k[:, 7:], torch.zeros_like(k[:, 7:]))
    assert tf.pad_caches(cfg, padded, 10)[0][0] is padded[0][0]  # never shrinks


# -- serving ---------------------------------------------------------------------------


def test_serve_engine_step_logits_match_jax(monkeypatch):
    jcfg, jparams, cfg, params = _models("gemma-2b")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in (12, 5, 9)]

    # JAX's engine exposes no logits: record its prefill and decode calls.
    jax_calls = []
    prefill = jtf.prefill

    def recording_prefill(p, c, batch):
        logits, caches = prefill(p, c, batch)
        jax_calls.append(("prefill", logits[0]))
        return logits, caches

    monkeypatch.setattr(jtf, "prefill", recording_prefill)
    jengine = JaxServeEngine(jcfg, jparams, max_len=32, batch_slots=2)
    decode = jengine._decode

    def recording_decode(p, c, t, pos):
        logits, c = decode(p, c, t, pos)
        jax_calls.append(("decode", logits[0]))
        return logits, c

    jengine._decode = recording_decode
    jresults = jengine.submit(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])

    calls = []
    engine = ServeEngine(cfg, params, max_len=32, batch_slots=2, device="cpu",
                         on_step=lambda req, logits, hidden: calls.append((req.rid, logits)))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    results = engine.submit(reqs)

    assert results == jresults
    # Both engines run the same SlotLoop, so their calls come in one order:
    # each request's first call is its prefill, then its decode steps.
    assert len(calls) == len(jax_calls) == 3 * 6
    seen = set()
    for (rid, logits), (kind, jlogits) in zip(calls, jax_calls):
        assert kind == ("decode" if rid in seen else "prefill")
        seen.add(rid)
        _close(logits, jlogits)
    for req in reqs:
        assert req.prefill_seconds > 0 and req.decode_seconds > 0


def test_serve_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(ARCHS["gemma-2b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(cfg)
    params = tf.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    runtime.reset_launches()
    ServeEngine(cfg, params, max_len=16, device="cpu").submit(
        [Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=3)])
    assert sum(runtime.launches.values()) == 0

"""paligemma (prefix-LM VLM) against the JAX package, at reduced size.

``reduced(paligemma-3b)``: the gemma backbone at 2 and 3 layers, d_model 64,
4 query heads on one KV head of 16, GeGLU, 8 patch embeddings of width 32
projected in by ``frontend.proj_in``, every position seeing the 8 patches.
``repro``'s weights are carried over by ``params_from_jax``; inputs
(tokens, patches) are numpy draws from a seed handed to both; the JAX model
runs on the CPU without a ``Sharder``, unrolled (``_UNROLL``).  ``repro``
writes the prefix-LM mask as ``mask_pos = max(pos - P + 1, 0)``; the port
passes ``prefix = P`` to the flash kernel.

Tolerances, as a share of the reference's largest magnitude: logits, layer
outputs and caches at 1e-2 in bf16 (JAX's ``full_attention`` rounds the
scores and P to bf16, the port's kernels keep them in f32); the final-normed
hidden state of a decode step at 2e-2, three bf16 ulps at its largest
magnitude, as in the other model tests.  Cache shapes are held exactly.
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

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax

ARCH = "paligemma-3b"
BF16_TOL = 1e-2
HIDDEN_TOL = 2e-2
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _close(got: torch.Tensor, want, tol: float = BF16_TOL) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, err
    return err


def _models(**over):
    jcfg, cfg = jax_reduced(JAX_ARCHS[ARCH], **over), reduced(ARCHS[ARCH], **over)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=[2, 3], ids=["2layers", "3layers"])
def models(request):
    return _models(n_layers=request.param)


@pytest.fixture
def unrolled(monkeypatch):
    monkeypatch.setattr(jtf, "_UNROLL", True)


def _batch(cfg, seed, seq, batch=2):
    """(numpy batch, the JAX batch, the port's batch): tokens and patches."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32),
              "patches": rng.standard_normal((batch, cfg.frontend_seq, cfg.frontend_dim))
              .astype(np.float32)}
    return (arrays, {k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _jax_layers(jcfg, seg_caches):
    """JAX's caches (one stacked pytree per segment) in the port's layer
    order; of ``ShapeDtypeStruct``s, each layer's (shape, dtype) pairs."""
    def one(a, layer):
        if isinstance(a, jax.ShapeDtypeStruct):
            return tuple(a.shape[1:]), TORCH_DTYPES[a.dtype.type]
        return a[layer]

    return [tuple(one(a, layer) for a in seg[f"b{i}_{kind}"])
            for (kinds, repeats), seg in zip(tf.decoder_segments(jcfg), seg_caches)
            for layer in range(repeats) for i, kind in enumerate(kinds)]


def _jax_decode(jp, jcfg, caches, token, pos):
    """(hidden state, logits, caches) of ``repro``'s decode step."""
    x = jlayers.embed(jp["embed"], token[:, None], scale_by_sqrt_dim=True)
    new = []
    for i, seg in enumerate(jtf._decoder_segments(jcfg)):
        x, c = jtf.segment_decode(jp[f"seg{i}"], jcfg, seg, x, caches[i],
                                  jnp.asarray(pos, jnp.int32))
        new.append(c)
    x = jlayers.rmsnorm(jp["final_norm"], x, jcfg.norm_eps)[:, 0]
    return x, jlayers.unembed(jp["embed"], x, jcfg.logit_softcap), new


def test_config_is_admitted_at_both_sizes():
    """paligemma at both sizes, and with the attention softcap, which raised
    before it was ported: one prefix-LM layer with a cap that bites (0.5 on
    ``wq`` times 2; at least 10% of the visible scores above it) equals
    ``repro``'s at ``mask_pos = max(pos - P + 1, 0)`` within ``BF16_TOL``
    and differs from the uncapped layer by more than 10 ``BF16_TOL``."""
    cfg = ARCHS[ARCH]
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.frontend_seq, cfg.frontend_dim) == (
                "vlm", 18, 2048, 8, 1, 256, 256, 1152)
    tf.check_supported(cfg)
    tf.check_supported(reduced(cfg))
    assert tf.layer_kinds(cfg) == ["attn"] * 18
    capped = reduced(cfg, attn_softcap=0.5)
    tf.check_supported(capped)
    with pytest.raises(NotImplementedError, match="family"):
        tf.check_supported(reduced(cfg, n_encoder_layers=2))  # encoder layers: enc-dec only
    jcfg = jax_reduced(JAX_ARCHS[ARCH], attn_softcap=0.5)
    jp = jattn.init_gqa(jax.random.key(3), jcfg)
    jp["wq"]["w"] = jp["wq"]["w"] * 2
    p = {name: {"w": torch.from_numpy(np.array(w["w"])).to(torch.bfloat16)}
         for name, w in jp.items()}
    s, prefix = 21, capped.frontend_seq
    x = np.random.default_rng(3).standard_normal((2, s, capped.d_model)).astype(np.float32)
    xs = torch.from_numpy(x).to(torch.bfloat16)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    tpos = torch.from_numpy(positions.copy())
    want = jattn.gqa_forward(jp, jcfg, jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(positions),
                             mask_pos=jnp.maximum(jnp.asarray(positions) - prefix + 1, 0))
    _close(attn.gqa_forward(p, capped, xs, tpos, prefix=prefix), want)
    q, k, _ = attn._gqa_qkv(p, capped, xs, tpos)
    scores = torch.einsum("bshd,btkd->bhst", q.float(), k.float()) / capped.head_dim ** 0.5
    rows, cols = torch.arange(s)[:, None], torch.arange(s)[None, :]
    assert float((scores.abs() > 0.5)[:, :, (cols <= rows) | (cols < prefix)]
                 .float().mean()) >= 0.1
    uncapped = attn.gqa_forward(p, reduced(cfg), xs, tpos, prefix=prefix)
    assert float((uncapped.float() - torch.from_numpy(np.asarray(want, np.float32))).abs()
                 .max()) > 10 * BF16_TOL * float(np.abs(np.asarray(want, np.float32)).max())


def test_gqa_forward_prefix_matches_jax_mask_pos():
    """One layer's attention at ``prefix = P`` against ``repro``'s at
    ``mask_pos = max(pos - P + 1, 0)``, P = 8 patches and 13 text rows; the
    causal layer differs."""
    jcfg, cfg = jax_reduced(JAX_ARCHS[ARCH]), reduced(ARCHS[ARCH])
    jp = jattn.init_gqa(jax.random.key(3), jcfg)
    p = {name: {"w": torch.from_numpy(np.array(w["w"])).to(torch.bfloat16)}
         for name, w in jp.items()}
    s, prefix = 21, cfg.frontend_seq
    x = np.random.default_rng(3).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want, (jk, jv) = jattn.gqa_forward(jp, jcfg, jx, jnp.asarray(positions),
                                       mask_pos=jnp.maximum(jnp.asarray(positions) - prefix + 1,
                                                            0), return_kv=True)
    got, (k, v) = attn.gqa_forward(p, cfg, torch.from_numpy(x).to(torch.bfloat16),
                                   torch.from_numpy(positions.copy()), prefix=prefix,
                                   return_kv=True)
    _close(got, want)
    _close(k, jk)
    _close(v, jv)
    causal = attn.gqa_forward(p, cfg, torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(positions.copy()))
    assert float((causal.float() - got.float()).abs().max()) > 10 * BF16_TOL * float(
        np.abs(np.asarray(want, np.float32)).max())


def test_params_from_jax_keeps_every_weight(models):
    jcfg, jparams, cfg, params = models
    assert set(params) == {"embed", "final_norm", "layers", "frontend"}
    assert tf.param_count(params) == jtf.param_count(jparams)
    w = params["frontend"]["proj_in"]["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (cfg.frontend_dim, cfg.d_model)
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(jparams["frontend"]["proj_in"]["w"].astype(jnp.bfloat16), np.float32))
    for layer, rep in zip(params["layers"], range(cfg.n_layers)):
        assert set(layer) == {"norm1", "attn", "norm2", "mlp"}
        np.testing.assert_array_equal(
            layer["mlp"]["w_gate"]["w"].float().numpy(),
            np.asarray(jparams["seg0"]["b0_attn"]["mlp"]["w_gate"]["w"][rep]
                       .astype(jnp.bfloat16), np.float32))
    fresh = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), fresh)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params))
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="not the tree"):
        params_from_jax({k: v for k, v in tree.items() if k != "frontend"}, cfg, device="cpu")


def test_forward_logits_match_jax(models, unrolled):
    """Logits of every position, patches and text, against ``repro``'s."""
    jcfg, jparams, cfg, params = models
    _, jbatch, batch = _batch(cfg, 1, 12)
    jlogits, _, _ = jtf.forward(jparams, jcfg, jbatch)
    logits, aux, _ = tf.forward(params, cfg, batch)
    assert logits.shape == (2, cfg.frontend_seq + 12, cfg.vocab_size)
    _close(logits, jlogits)
    assert float(aux) == 0.0


def test_prefill_caches_match_jax(models, unrolled):
    """The last position's logits and every layer's (k, v) over patches and
    text, against ``repro``'s prefill."""
    jcfg, jparams, cfg, params = models
    _, jbatch, batch = _batch(cfg, 2, 11)
    jlogits, jcaches = jtf.prefill(jparams, jcfg, jbatch)
    logits, caches = tf.prefill(params, cfg, batch)
    _close(logits, jlogits)
    jlayers_ = _jax_layers(jcfg, jcaches)
    assert len(caches) == len(jlayers_) == cfg.n_layers
    for cache, jcache in zip(caches, jlayers_):
        for got, want in zip(cache, jcache):
            assert got.shape == (2, cfg.frontend_seq + 11, cfg.n_kv_heads, cfg.head_dim)
            _close(got, want)


def test_decode_steps_match_jax(models, unrolled):
    """Prefill seq - 1 tokens after the patches, then decode at ``pos = P +
    seq - 1`` (``repro``'s prefill/decode consistency check) and 5 more
    steps teacher-forced on JAX's greedy tokens: each step's hidden state,
    logits and the caches, against ``repro``; the first step also against
    the full forward's last position."""
    jcfg, jparams, cfg, params = models
    seq = 12
    arrays, jbatch, batch = _batch(cfg, 3, seq)
    p_len = cfg.frontend_seq
    jpre = dict(jbatch, tokens=jbatch["tokens"][:, :seq - 1])
    pre = dict(batch, tokens=batch["tokens"][:, :seq - 1])
    _, jcaches = jtf.prefill(jparams, jcfg, jpre)
    _, caches = tf.prefill(params, cfg, pre)
    jcaches = jtf.pad_caches(jcfg, jcaches, p_len + seq + 8)
    caches = tf.pad_caches(cfg, caches, p_len + seq + 8)
    full, _, _ = tf.forward(params, cfg, batch)
    token = jnp.asarray(arrays["tokens"][:, seq - 1])
    for step in range(6):
        pos = p_len + seq - 1 + step
        jhidden, jlogits, jcaches = _jax_decode(jparams, jcfg, jcaches, token, pos)
        logits, caches, hidden = tf.decode_step(params, cfg, caches,
                                                torch.from_numpy(np.array(token)), pos,
                                                return_hidden=True)
        _close(hidden, jhidden, HIDDEN_TOL)
        _close(logits, jlogits)
        if step == 0:
            _close(logits, full[:, -1].float().numpy(), 2e-2)
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for cache, jcache in zip(caches, _jax_layers(jcfg, jcaches)):
        for got, want in zip(cache, jcache):
            _close(got, want)


def test_cache_struct_and_pad_caches_match_jax(models):
    jcfg, jparams, cfg, params = models
    total = cfg.frontend_seq + 12
    spec = tf.cache_struct(cfg, 2, total)
    jspec = _jax_layers(jcfg, jtf.cache_struct(jcfg, 2, total))
    assert [tuple((tuple(sh), dt) for sh, dt in layer) for layer in spec] == jspec
    _, _, batch = _batch(cfg, 4, 12)
    _, caches = tf.prefill(params, cfg, batch)
    assert [tuple((a.shape, a.dtype) for a in c) for c in caches] == \
        [tuple(tuple(s) for s in layer) for layer in spec]
    padded = tf.pad_caches(cfg, caches, total + 9)
    jpadded = jtf.pad_caches(jcfg, jtf.prefill(jparams, jcfg, _batch(cfg, 4, 12)[1])[1],
                             total + 9)
    assert [tuple(tuple(a.shape) for a in c) for c in padded] == \
        [tuple(tuple(np.shape(a)) for a in layer) for layer in _jax_layers(jcfg, jpadded)]
    for layer, plain in zip(padded, caches):
        for grown, a in zip(layer, plain):
            assert grown.shape[1] == total + 9
            torch.testing.assert_close(grown[:, :total], a, rtol=0, atol=0)


def test_every_prefill_layer_passes_the_patch_count_as_prefix(models, monkeypatch):
    """The VLM's prefill reaches the flash kernel's entry once a layer, over
    patches and text (S = T = P + text) at ``prefix = P``."""
    jcfg, jparams, cfg, params = models
    calls = []
    flash = attn.remop_flash_attention

    def recording(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(attn, "remop_flash_attention", recording)
    _, _, batch = _batch(cfg, 5, 9)
    tf.prefill(params, cfg, batch)
    total = cfg.frontend_seq + 9
    assert calls == [(total, total, {"window": 0, "prefix": cfg.frontend_seq,
                                     "softcap": cfg.attn_softcap})] * cfg.n_layers


def test_serve_cli_refuses_the_vlm():
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu"])

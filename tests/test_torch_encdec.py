"""seamless-m4t (encoder-decoder) against the JAX package, at reduced size.

``reduced(seamless-m4t-large-v2)``: 2 bidirectional encoder layers and 2
and 3 decoder layers (each self-attention, then cross-attention over the
encoder's output), d_model 64, 4 query heads on 2 KV heads of 16, GeLU,
encoder frames of width 32 projected in by ``frontend.proj_in``.
``repro``'s weights are carried over by ``params_from_jax``; inputs (tokens,
frames) are numpy draws from a seed handed to both; the JAX model runs on
the CPU without a ``Sharder``, unrolled (``_UNROLL``).  Encoder inputs of
20 frames (more than the decoder's tokens) and of 7 (fewer: cross-attention
with S > T).  ``repro`` writes the encoder's mask as all-zero ``mask_pos``
and cross-attention's as ``q_pos = 1e9`` over ``kv_pos = 0``; the port
passes ``prefix = T`` to the flash kernel, and decodes cross-attention with
the paged kernel over the fixed cross cache at ``lengths = T_enc``.

Tolerances, as a share of the reference's largest magnitude: logits, layer
outputs, the encoder's output and caches at 1e-2 in bf16 (JAX's
``full_attention`` rounds the scores and P to bf16, the port's kernels keep
them in f32); the final-normed hidden state of a decode step at 2e-2, three
bf16 ulps at its largest magnitude, as in the other model tests, and so
are the self caches after decode steps (the rows the steps wrote come from
those hidden states: 1.2% at 3 layers).  Cache shapes are held exactly, and
the cross cache bit for bit across decode steps (it is never written).
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

ARCH = "seamless-m4t-large-v2"
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


def _batch(cfg, seed, seq, frames, batch=2):
    """(numpy batch, the JAX batch, the port's batch): tokens and frames."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32),
              "frames": rng.standard_normal((batch, frames, cfg.frontend_dim))
              .astype(np.float32)}
    return (arrays, {k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _jax_layers(seg_caches, n_layers):
    """JAX's cross-block caches (stacked over layers) per layer, in the
    port's layout: ``{"self": (k, v), "cross": (ck, cv)}``."""
    seg = seg_caches[0]["b0_cross"]
    return [{part: tuple(a[layer] for a in seg[part]) for part in ("self", "cross")}
            for layer in range(n_layers)]


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


def _close_caches(caches, jcaches, tol=BF16_TOL):
    for cache, jcache in zip(caches, jcaches):
        assert set(cache) == {"self", "cross"}
        for part in ("self", "cross"):
            for got, want in zip(cache[part], jcache[part]):
                _close(got, want, tol)


def test_config_is_admitted_at_both_sizes():
    cfg = ARCHS[ARCH]
    assert (cfg.family, cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.frontend_seq) == (
                "audio_encdec", 24, 24, 1024, 16, 16, 64, 4096)
    tf.check_supported(cfg)
    tf.check_supported(reduced(cfg))
    assert tf.decoder_segments(cfg) == ((("cross",), 24),)
    assert tf.layer_kinds(cfg) == ["cross"] * 24
    with pytest.raises(NotImplementedError, match="family"):
        tf.check_supported(reduced(cfg, n_encoder_layers=0))


def _gqa_pair(seed):
    jcfg, cfg = jax_reduced(JAX_ARCHS[ARCH]), reduced(ARCHS[ARCH])
    jp = jattn.init_gqa(jax.random.key(seed), jcfg)
    p = {name: {"w": torch.from_numpy(np.array(w["w"])).to(torch.bfloat16)}
         for name, w in jp.items()}
    return jcfg, jp, cfg, p


def _bf16(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("s,t", [(12, 20), (12, 7), (1, 9)])
def test_cross_attention_matches_jax(s, t):
    """``gqa_forward(xa=...)`` against ``repro``'s (q from x, k and v from
    xa, unroped, every key seen; S > T included), its returned cross K/V, and
    ``cross_decode`` of each row over those K/V against the same rows."""
    jcfg, jp, cfg, p = _gqa_pair(7)
    rng = np.random.default_rng(s * 31 + t)
    jx, x = _bf16(rng, 2, s, cfg.d_model)
    jxa, xa = _bf16(rng, 2, t, cfg.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want, (jk, jv) = jattn.gqa_forward(jp, jcfg, jx, jnp.asarray(pos), xa=jxa, return_kv=True)
    got, (k, v) = attn.gqa_forward(p, cfg, x, torch.from_numpy(pos.copy()), xa=xa,
                                   return_kv=True)
    _close(got, want)
    assert k.shape == v.shape == (2, t, cfg.n_kv_heads, cfg.head_dim)
    _close(k, jk)
    _close(v, jv)
    for row in range(s):
        step = attn.cross_decode(p, cfg, x[:, row:row + 1], (k, v))
        _close(step, np.asarray(want, np.float32)[:, row:row + 1])


def test_encoder_matches_jax(unrolled):
    """The encoder's output (proj_in, 2 bidirectional layers, enc_norm)."""
    jcfg, jparams, cfg, params = _models()
    for frames in (20, 7):
        _, jbatch, batch = _batch(cfg, frames, 5, frames)
        want = jtf._encode(jparams, jcfg, jbatch)
        got = tf.encode(params, cfg, batch)
        assert got.shape == (2, frames, cfg.d_model) and got.dtype == torch.bfloat16
        _close(got, want)


def test_params_from_jax_keeps_every_weight(models):
    jcfg, jparams, cfg, params = models
    assert set(params) == {"embed", "final_norm", "layers", "frontend", "encoder", "enc_norm"}
    assert tf.param_count(params) == jtf.param_count(jparams)
    assert len(params["encoder"]) == cfg.n_encoder_layers == 2
    for rep, layer in enumerate(params["encoder"]):
        assert set(layer) == {"norm1", "attn", "norm2", "mlp"}
        np.testing.assert_array_equal(
            layer["attn"]["wk"]["w"].float().numpy(),
            np.asarray(jparams["encoder"]["b0_enc"]["attn"]["wk"]["w"][rep]
                       .astype(jnp.bfloat16), np.float32))
    for rep, layer in enumerate(params["layers"]):
        assert set(layer) == {"norm1", "attn", "norm_x", "xattn", "norm2", "mlp"}
        np.testing.assert_array_equal(
            layer["xattn"]["wv"]["w"].float().numpy(),
            np.asarray(jparams["seg0"]["b0_cross"]["xattn"]["wv"]["w"][rep]
                       .astype(jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(params["enc_norm"]["scale"].numpy(),
                                  np.asarray(jparams["enc_norm"]["scale"]))
    fresh = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), fresh)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params))
    tree = jax.tree.map(np.asarray, jparams)
    for missing in ("encoder", "enc_norm", "frontend"):
        with pytest.raises(ValueError, match="not the tree"):
            params_from_jax({k: v for k, v in tree.items() if k != missing}, cfg, device="cpu")


@pytest.mark.parametrize("frames", [20, 7])
def test_forward_and_prefill_match_jax(models, unrolled, frames):
    """Every position's logits, and the prefill's last logits and caches:
    each layer's self (k, v) over the decoder's tokens and cross (k, v) over
    the encoder's frames."""
    jcfg, jparams, cfg, params = models
    _, jbatch, batch = _batch(cfg, frames + 1, 12, frames)
    jlogits, _, _ = jtf.forward(jparams, jcfg, jbatch)
    logits, _, _ = tf.forward(params, cfg, batch)
    assert logits.shape == (2, 12, cfg.vocab_size)
    _close(logits, jlogits)
    jlast, jcaches = jtf.prefill(jparams, jcfg, jbatch)
    last, caches = tf.prefill(params, cfg, batch)
    _close(last, jlast)
    assert len(caches) == cfg.n_layers
    for cache in caches:
        assert all(a.shape == (2, 12, cfg.n_kv_heads, cfg.head_dim) for a in cache["self"])
        assert all(a.shape == (2, frames, cfg.n_kv_heads, cfg.head_dim) for a in cache["cross"])
    _close_caches(caches, _jax_layers(jcaches, cfg.n_layers))


@pytest.mark.parametrize("frames", [20, 7])
def test_decode_steps_match_jax(models, unrolled, frames):
    """Prefill seq - 1 tokens, decode at ``pos = seq - 1`` (``repro``'s
    prefill/decode consistency check) and 5 more steps teacher-forced on
    JAX's greedy tokens: each step's hidden state and logits, and the
    caches, against ``repro``; the first step also against the full forward's
    last position; the cross cache unchanged, bit for bit."""
    jcfg, jparams, cfg, params = models
    seq = 12
    arrays, jbatch, batch = _batch(cfg, frames + 2, seq, frames)
    _, jcaches = jtf.prefill(jparams, jcfg, dict(jbatch, tokens=jbatch["tokens"][:, :seq - 1]))
    _, caches = tf.prefill(params, cfg, dict(batch, tokens=batch["tokens"][:, :seq - 1]))
    jcaches = jtf.pad_caches(jcfg, jcaches, seq + 8)
    caches = tf.pad_caches(cfg, caches, seq + 8)
    cross = [tuple(a.clone() for a in c["cross"]) for c in caches]
    full, _, _ = tf.forward(params, cfg, batch)
    token = jnp.asarray(arrays["tokens"][:, seq - 1])
    for step in range(6):
        pos = seq - 1 + step
        jhidden, jlogits, jcaches = _jax_decode(jparams, jcfg, jcaches, token, pos)
        logits, caches, hidden = tf.decode_step(params, cfg, caches,
                                                torch.from_numpy(np.array(token)), pos,
                                                return_hidden=True)
        _close(hidden, jhidden, HIDDEN_TOL)
        _close(logits, jlogits)
        if step == 0:
            _close(logits, full[:, -1].float().numpy(), 2e-2)
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    # The rows the steps wrote carry the steps' hidden-state differences.
    _close_caches(caches, _jax_layers(jcaches, cfg.n_layers), HIDDEN_TOL)
    for cache, before in zip(caches, cross):
        for a, b in zip(cache["cross"], before):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cache_struct_and_pad_caches_match_jax(models):
    """``cache_struct`` equals ``repro``'s, the encoder's length by default
    ``frontend_seq`` or given; ``pad_caches`` grows each self cache to
    ``repro``'s length and never pads the cross cache (the same tensors)."""
    jcfg, jparams, cfg, params = models

    def shapes(tree):
        return jax.tree.map(lambda a: (tuple(a.shape[1:]), TORCH_DTYPES[a.dtype.type]), tree,
                            is_leaf=lambda a: isinstance(a, jax.ShapeDtypeStruct))

    for enc_len in (None, 20):
        jseg = shapes(jtf.cache_struct(jcfg, 2, 40, enc_len=enc_len))[0]["b0_cross"]
        want = {part: tuple(jseg[part]) for part in ("self", "cross")}
        spec = tf.cache_struct(cfg, 2, 40, enc_len=enc_len)
        assert len(spec) == cfg.n_layers
        assert all({part: tuple((tuple(sh), dt) for sh, dt in layer[part])
                    for part in ("self", "cross")} == want for layer in spec)
    assert spec[0]["cross"][0][0] == (2, 20, cfg.n_kv_heads, cfg.head_dim)
    assert tf.cache_struct(cfg, 2, 40)[0]["cross"][0][0][1] == cfg.frontend_seq
    _, jbatch, batch = _batch(cfg, 9, 12, 20)
    _, caches = tf.prefill(params, cfg, batch)
    padded = tf.pad_caches(cfg, caches, 40)
    jpadded = _jax_layers(jtf.pad_caches(jcfg, jtf.prefill(jparams, jcfg, jbatch)[1], 40),
                          cfg.n_layers)
    for layer, plain, jlayer in zip(padded, caches, jpadded):
        assert all(a is b for a, b in zip(layer["cross"], plain["cross"]))
        for grown, a, ja in zip(layer["self"], plain["self"], jlayer["self"]):
            assert tuple(grown.shape) == tuple(np.shape(ja)) == (2, 40, cfg.n_kv_heads,
                                                                 cfg.head_dim)
            torch.testing.assert_close(grown[:, :12], a, rtol=0, atol=0)
        assert [tuple(a.shape) for a in layer["cross"]] == \
            [tuple(np.shape(a)) for a in jlayer["cross"]]


def test_kernel_entries_per_prefill_and_decode_step(models, monkeypatch):
    """A prefill reaches the flash entry once an encoder layer (every key,
    S = T = T_enc) and twice a decoder layer (causal over the tokens, then
    every key of the encoder's T_enc); a decode step reaches the paged entry
    twice a layer (self at ``pos + 1`` positions, cross at T_enc)."""
    jcfg, jparams, cfg, params = models
    flash_calls, paged_calls = [], []
    flash, paged = attn.remop_flash_attention, attn.remop_paged_attention

    def recording_flash(q, k, v, **kw):
        flash_calls.append((q.shape[2], k.shape[2], kw["prefix"]))
        return flash(q, k, v, **kw)

    def recording_paged(q, kc, vc, lengths, **kw):
        paged_calls.append((kc.shape[1], lengths.tolist()))
        return paged(q, kc, vc, lengths, **kw)

    monkeypatch.setattr(attn, "remop_flash_attention", recording_flash)
    monkeypatch.setattr(attn, "remop_paged_attention", recording_paged)
    t_enc, seq = 7, 10
    _, _, batch = _batch(cfg, 11, seq, t_enc)
    logits, caches = tf.prefill(params, cfg, batch)
    assert flash_calls == ([(t_enc, t_enc, t_enc)] * cfg.n_encoder_layers
                           + [(seq, seq, 0), (seq, t_enc, t_enc)] * cfg.n_layers)
    caches = tf.pad_caches(cfg, caches, 16)
    tf.decode_step(params, cfg, caches, logits.argmax(-1), seq)
    assert paged_calls == [(16, [seq + 1] * 2), (t_enc, [t_enc] * 2)] * cfg.n_layers


def test_serve_cli_refuses_the_encoder_decoder():
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu"])

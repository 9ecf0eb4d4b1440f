"""The port's MoE layer and MoE decoder against the JAX package's.

``topk_route`` and ``moe_apply``'s routing are held to ``jax.lax.top_k``
bit for bit: among equal probabilities the lower expert index comes first
(``torch.topk`` promises no order), on planted ties at the k-th/k+1-th
boundary and on bf16 N(0, 1) logits, where such ties are asserted to occur.
``moe_apply`` is held to ``repro``'s on the same numpy-seeded inputs: in f32
within 1e-5 of the output's scale, in bf16 within ``BF16_TOL`` (1e-2 of
scale) with the two routings asserted equal, and at ``capacity_factor=1.0``
with drops asserted to occur and the kept assignments equal one for one.
The reduced granite-moe-3b-a800m (weights carried over by ``params_from_jax``)
is held to ``repro``'s logits in prefill and teacher-forced decode, with and
without a dense first block.  The JAX model runs without a ``Sharder``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.models import moe as jmoe
from repro.models import transformer as jtf

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax

ARCH = "granite-moe-3b-a800m"
BF16_TOL = 1e-2
F32_TOL = 1e-5


def _close(got: torch.Tensor, want, tol: float) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, err
    return err


def _cfgs(**over):
    return jax_reduced(JAX_ARCHS[ARCH], **over), reduced(ARCHS[ARCH], **over)


def _moe_params(rng, cfg):
    """Router and expert weights as numpy f32, scaled as ``init_moe`` scales them."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {"router": {"w": rng.standard_normal((d, e)).astype(np.float32) / np.sqrt(d)},
            "experts": {"w_gate": rng.standard_normal((e, d, ff)).astype(np.float32) / np.sqrt(d),
                        "w_up": rng.standard_normal((e, d, ff)).astype(np.float32) / np.sqrt(d),
                        "w_down": rng.standard_normal((e, ff, d)).astype(np.float32) / np.sqrt(ff)}}


@contextlib.contextmanager
def _recorded(log):
    """Append ``(ids, keep)`` of every MoE layer call to ``log``: the layer's
    dense dispatch, wrapped while the block runs."""
    dispatch = moe.dispatch_dense

    def recording(x, ids, n_experts, cap):
        out = dispatch(x, ids, n_experts, cap)
        log.append((ids, out[1]))
        return out

    moe.dispatch_dense = recording
    try:
        yield log
    finally:
        moe.dispatch_dense = dispatch


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in params.items()}


def _jax_routing(jp, jx, k):
    """JAX's own ids of ``moe_apply`` (its router product and top-k)."""
    logits = jx @ jp["router"]["w"].astype(jx.dtype)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


def _jax_keep(ids, e, cap):
    """Which assignments survive capacity ``cap``: token-major, choice-minor
    positions per expert, counted in numpy."""
    b = ids.shape[0]
    flat = ids.reshape(b, -1)
    keep = np.zeros(flat.shape, bool)
    for r in range(b):
        seen = np.zeros(e, int)
        for i, x in enumerate(flat[r]):
            keep[r, i] = seen[x] < cap
            seen[x] += 1
    return keep


# -- top-k ------------------------------------------------------------------------


def _planted_ties(k, e=8, rows=64, seed=0):
    """Probabilities that tie at the k-th/k+1-th boundary in every row: k-1
    distinct larger values, then 2 to e-k+1 copies of one value, then
    smaller ones, at random places."""
    rng = np.random.default_rng(seed + k)
    out = np.empty((rows, e), np.float32)
    for r in range(rows):
        ties = int(rng.integers(2, e - k + 2))
        vals = np.concatenate([0.9 - 0.1 * np.arange(k - 1), np.full(ties, 0.2),
                               0.1 - 0.01 * np.arange(e - k + 1 - ties)])
        out[r] = rng.permutation(vals)
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_top_k_breaks_ties_to_the_lower_index(k):
    e = 12 if k == 8 else 8
    probs = _planted_ties(k, e)
    srt = -np.sort(-probs, axis=1)
    assert (srt[:, k - 1] == srt[:, k]).all()  # every row ties at the boundary
    jw, jids = jax.lax.top_k(jnp.asarray(probs), k)
    w, ids = moe._top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert jax.lax.top_k(jnp.asarray([0.1, .5, .5, .2, .5, .3]), 2)[1].tolist() == [1, 2]
    assert moe._top_k(torch.tensor([0.1, .5, .5, .2, .5, .3]), 2)[1].tolist() == [1, 2]


@pytest.mark.parametrize("t,e,k", [(2048, 40, 8), (512, 4, 2), (300, 16, 4)])
def test_topk_route_matches_jax_on_bf16_logits_with_ties(t, e, k):
    x = np.random.default_rng(e).standard_normal((t, e)).astype(np.float32)
    jl = jnp.asarray(x).astype(jnp.bfloat16)
    tl = torch.from_numpy(x).to(torch.bfloat16)
    srt = -np.sort(-tl.float().numpy(), axis=1)
    ties = int((srt[:, k - 1] == srt[:, k]).sum())
    assert ties > 0  # bf16 logits tie at the k-th/k+1-th boundary
    jw, jids, jaux = jmoe.topk_route(jl, k)
    w, ids, aux = moe.topk_route(tl, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))
    # On JAX's own probabilities the top-k is JAX's bit for bit.
    jprobs = np.array(jax.nn.softmax(jl.astype(jnp.float32), axis=-1))
    jtop, jtop_ids = jax.lax.top_k(jnp.asarray(jprobs), k)
    top, top_ids = moe._top_k(torch.from_numpy(jprobs), k)
    np.testing.assert_array_equal(top_ids.numpy(), np.asarray(jtop_ids))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    # The two softmaxes differ by a few f32 units in the last place (XLA's exp
    # is not PyTorch's), which can move a normalised weight across a bf16
    # rounding boundary: at most one bf16 step, on a few weights in 10^4.
    assert w.dtype == torch.bfloat16
    got, want = w.float().numpy(), np.asarray(jw.astype(jnp.float32))
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)).all()
    assert (got != want).mean() <= 1e-3


# -- moe_apply ----------------------------------------------------------------------


def _apply_both(dtype, cf=None, seed=0, s=24, b=2):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    params = _moe_params(rng, cfg)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = _tree(params, jnp.asarray)  # f32 masters, cast per call as JAX does
    jx = jnp.asarray(x).astype(jdtype)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jx, capacity_factor=cf)
    p = _tree(params, lambda a: torch.from_numpy(a).to(dtype))
    with _recorded([]) as log:
        y, aux = moe.moe_apply(p, cfg, torch.from_numpy(x).to(dtype), capacity_factor=cf)
    (ids, keep), = log
    return jcfg, cfg, (jy, jaux, _jax_routing(jp, jx, cfg.experts_per_token)), (y, aux, ids, keep)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_apply_f32_matches_jax(seed):
    jcfg, cfg, (jy, jaux, jids), (y, aux, ids, keep) = _apply_both(torch.float32, seed=seed)
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert keep.all()  # the reduced config's capacity factor (4.0) drops nothing
    assert y.dtype == torch.float32
    _close(y, jy, F32_TOL)
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_apply_bf16_matches_jax_where_the_routings_agree(seed):
    jcfg, cfg, (jy, jaux, jids), (y, aux, ids, keep) = _apply_both(torch.bfloat16, seed=seed)
    # The router's product rounds to bf16 in both; the routings must agree
    # for the outputs to be comparable at all.
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert y.dtype == torch.bfloat16
    _close(y, jy, BF16_TOL)
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_moe_apply_drops_what_jax_drops(dtype, tol):
    jcfg, cfg, (jy, _, jids), (y, _, ids, keep) = _apply_both(dtype, cf=1.0, s=40)
    np.testing.assert_array_equal(ids.numpy(), jids)
    cap = moe.capacity(cfg, 40, 1.0)
    assert cap == max(1, int(1.0 * 40 * cfg.experts_per_token / cfg.n_experts))
    want_keep = _jax_keep(jids, cfg.n_experts, cap)
    assert (~want_keep).sum() > 0  # drops occur in the data
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    _close(y, jy, tol)


def test_dense_dispatch_never_lets_a_drop_overwrite_a_kept_row():
    """An expert past capacity: the kept rows hold their tokens and the
    dropped assignments (which JAX parks at slot C-1 with a zero update)
    leave no trace; a kept -0.0 stays -0.0 (JAX's ``zeros().at[].add()``
    gives +0.0: equal by value)."""
    x = torch.arange(1, 13, dtype=torch.float32).reshape(1, 6, 2)
    x[0, 0, 0] = -0.0
    ids = torch.tensor([[[0, 1], [0, 2], [0, 1], [0, 3], [2, 0], [1, 0]]])
    expert_in, keep, slot = moe.dispatch_dense(x, ids, 4, 2)
    # Capacity 2: expert 0 keeps tokens 0 and 1, expert 1 tokens 0 and 2;
    # expert 0's tokens 2, 3, 4, 5 and expert 1's token 5 are dropped.
    assert keep.tolist() == [[True, True, True, True, False, True,
                              False, True, True, False, False, False]]
    assert expert_in[0, 0].tolist() == [[0.0, 2.0], [3.0, 4.0]]
    assert torch.signbit(expert_in[0, 0, 0, 0]) and torch.signbit(expert_in[0, 1, 0, 0])
    assert expert_in[0, 1].tolist() == [[0.0, 2.0], [5.0, 6.0]]
    assert expert_in[0, 2].tolist() == [[3.0, 4.0], [9.0, 10.0]]
    assert expert_in[0, 3].tolist() == [[7.0, 8.0], [0.0, 0.0]]


def test_ep_shard_map_waits_for_the_distributed_slice():
    cfg = reduced(ARCHS[ARCH])
    p = tf.init_params(cfg, device="cpu")["layers"][0]["moe"]
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    moe.set_moe_impl("ep_shard_map")
    try:
        with pytest.raises(NotImplementedError, match="distributed"):
            moe.moe_apply(p, cfg, x)
    finally:
        moe.set_moe_impl("gspmd")
    y, aux = moe.moe_apply(p, cfg, x)
    assert y.shape == x.shape and y.dtype == torch.bfloat16 and aux.dtype == torch.float32


# -- the MoE decoder ------------------------------------------------------------------


def _models(**over):
    jcfg, cfg = _cfgs(**over)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=[{}, {"first_k_dense": 1}, {"capacity_factor": 1.0}],
                ids=["moe", "first_k_dense", "cf1"])
def models(request):
    return _models(**request.param)


def test_params_from_jax_keeps_every_weight(models):
    jcfg, jparams, cfg, params = models
    assert tf.param_count(params) == jtf.param_count(jparams)
    kinds = ["moe" if "moe" in layer else "mlp" for layer in params["layers"]]
    assert kinds == ["mlp"] * cfg.first_k_dense + ["moe"] * (cfg.n_layers - cfg.first_k_dense)
    last = params["layers"][-1]["moe"]
    seg = f"seg{1 if cfg.first_k_dense else 0}"
    jlast = jax.tree.map(lambda a: a[-1], jparams[seg]["b0_moe"]["moe"])
    for name in ("w_gate", "w_up", "w_down"):
        assert last["experts"][name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            last["experts"][name].float().numpy(),
            np.asarray(jlast["experts"][name].astype(jnp.bfloat16), np.float32))
    assert last["router"]["w"].dtype == torch.bfloat16
    fresh = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), fresh)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params))


@pytest.fixture
def jax_routing(monkeypatch):
    """Runs the JAX model unrolled (``set_unroll``, its own switch for the
    dry-run's probes) and records the ids of every ``jax.lax.top_k`` it calls,
    so each MoE call's routing can be read beside the port's."""
    monkeypatch.setattr(jtf, "_UNROLL", True)
    calls = []
    top_k = jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        calls.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    return calls


def _routed(fn):
    with _recorded([]) as log:
        out = fn()
    return out, [ids.numpy() for ids, _ in log], sum(int((~keep).sum()) for _, keep in log)


def test_prefill_and_teacher_forced_decode_match_jax(models, jax_routing):
    """Routing follows rounding: a near-tie of two experts' probabilities goes
    to whichever side the router product's last bit puts it.  So the routings
    are asserted equal call for call, and the logits compared only then.  (At
    this seed, with a dense first block, token (1, 7) ties experts 0 and 1
    exactly for its second choice in unrolled JAX and the port, which both
    take expert 0; under ``lax.scan`` XLA rounds that product otherwise and
    routes the token elsewhere, 8% of the logits' scale away.)"""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    tokens = torch.from_numpy(prompt)
    n_moe = cfg.n_layers - cfg.first_k_dense

    jlogits_all, jaux, _ = jtf.forward(jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    (full, aux, _), ids, dropped = _routed(lambda: tf.forward(params, cfg, {"tokens": tokens}))
    assert len(ids) == len(jax_routing) == n_moe
    for got, want in zip(ids, jax_routing):
        np.testing.assert_array_equal(got, want)
    _close(full, jlogits_all, BF16_TOL)
    assert abs(float(aux) - float(jaux)) <= 1e-3 * abs(float(jaux))
    assert (dropped > 0) == (cfg.capacity_factor < cfg.n_experts / cfg.experts_per_token)

    jax_routing.clear()
    jlogits, jcaches = jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    (logits, caches), ids, _ = _routed(lambda: tf.prefill(params, cfg, {"tokens": tokens}))
    for got, want in zip(ids, jax_routing):
        np.testing.assert_array_equal(got, want)
    _close(logits, jlogits, BF16_TOL)
    torch.testing.assert_close(full[:, -1], logits, rtol=0, atol=0)

    max_len = 24
    jcaches = jtf.pad_caches(jcfg, jcaches, max_len)
    caches = tf.pad_caches(cfg, caches, max_len)
    # Teacher forcing: both models decode JAX's own greedy stream.
    token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for pos in range(12, max_len - 1):
        jax_routing.clear()
        jlogits, jcaches = jtf.decode_step(jparams, jcfg, jcaches, token,
                                           jnp.asarray(pos, jnp.int32))
        (logits, caches), ids, dropped = _routed(lambda: tf.decode_step(
            params, cfg, caches, torch.from_numpy(np.array(token)), pos))
        assert dropped == 0 and len(ids) == len(jax_routing) == n_moe
        for got, want in zip(ids, jax_routing):
            np.testing.assert_array_equal(got, want)
        _close(logits, jlogits, BF16_TOL)
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)


def test_mla_moe_still_waits_for_its_slice(monkeypatch):
    # MLA-MoE is served (tests/test_torch_mla.py), and now with the logit
    # softcap too: reduced deepseek's prefill with a cap that bites (0.25)
    # equals repro's within BF16_TOL, routing read first (a near-tie goes
    # where the router product's last bit puts it), and differs from the
    # uncapped prefill by more than 10 BF16_TOL.  A window is ignored by its
    # MLA and MoE blocks, as in repro: the model computes what it computes
    # without one.
    over = {"n_experts": 8, "attn_softcap": 0.25}
    jcfg = jax_reduced(JAX_ARCHS["deepseek-v2-lite-16b"], **over)
    capped = reduced(ARCHS["deepseek-v2-lite-16b"], **over)
    tf.check_supported(capped)
    monkeypatch.setattr(jtf, "_UNROLL", True)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    cparams = params_from_jax(jax.tree.map(np.asarray, jparams), capped, device="cpu")
    prompt = np.random.default_rng(5).integers(0, capped.vocab_size, (2, 12), dtype=np.int32)
    jax_ids = []
    top_k = jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        jax_ids.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    jlogits, _ = jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    (logits, _), ids, _ = _routed(
        lambda: tf.prefill(cparams, capped, {"tokens": torch.from_numpy(prompt)}))
    assert len(ids) == len(jax_ids) == 1
    np.testing.assert_array_equal(ids[0], jax_ids[0])
    _close(logits, jlogits, BF16_TOL)
    uncapped = tf.prefill(cparams, dataclasses.replace(capped, attn_softcap=0.0),
                          {"tokens": torch.from_numpy(prompt)})[0].float().numpy()
    assert float(np.abs(uncapped - np.asarray(jlogits, np.float32)).max()) > (
        10 * BF16_TOL * float(np.abs(np.asarray(jlogits, np.float32)).max()))
    windowed = reduced(ARCHS["deepseek-v2-lite-16b"], window=8)
    tf.check_supported(windowed)
    params = tf.init_params(windowed, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, windowed.vocab_size, (1, 12),
                                                                dtype=np.int32))
    logits = [tf.prefill(params, c, {"tokens": tokens})[0]
              for c in (windowed, dataclasses.replace(windowed, window=0))]
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)
    tf.check_supported(ARCHS[ARCH])
    assert tf.is_moe_layer(dataclasses.replace(ARCHS[ARCH], first_k_dense=2), 2)
    assert not tf.is_moe_layer(dataclasses.replace(ARCHS[ARCH], first_k_dense=2), 1)

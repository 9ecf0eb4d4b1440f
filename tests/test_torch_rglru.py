"""The port's RG-LRU block (``models/rglru.py``) against the JAX package's.

Inputs are numpy arrays from a seed, handed to both frameworks; JAX runs on
the CPU outside ``jit``, as ``repro``'s unrolled model runs it.

Tolerances.
- The scan: :func:`associative_scan` transcribes ``jax.lax.associative_scan``
  and is **bit-equal** to it on the CPU (both outputs, decays in [0.9, 1)),
  so those tests assert equality.  (Under ``jit`` XLA contracts
  ``b2 + a2 * b1`` into a fused multiply-add, and the last bit moves.)
- The bf16 sigmoid and GeLU are written out step by step and equal JAX's
  bit for bit; the convolution state is copied, so it is equal too.
- The f32 state ``h`` holds to ``F32_TOL = 1e-5`` of its largest magnitude:
  XLA's CPU ``exp`` and ``sqrt`` differ from PyTorch's in the last bit of a
  few percent of elements, so the gates differ by an ulp there.
- The block's bf16 output holds to ``BF16_TOL = 1e-2`` of its scale: an ulp
  of ``h`` can flip one bf16 rounding of ``y``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.models import rglru as jrec

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import layers
from repro_torch.models import rglru as rec

ARCH = "recurrentgemma-2b"
F32_TOL = 1e-5
BF16_TOL = 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got: torch.Tensor, want, tol: float) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, err
    return err


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, b2 + a2 * b1


def _scan_inputs(n, seed=0, width=48):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.9, 1.0, (2, n, width)).astype(np.float32)
    b = rng.standard_normal((2, n, width)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("n", [1, 2, 3, 5, 64, 257])
def test_scan_transcription_equals_jax_bit_for_bit(n):
    a, b = _scan_inputs(n, seed=n)
    ja, jb = jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = rec.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("n", [7, 100])
def test_scan_is_the_linear_recurrence(n):
    a, b = _scan_inputs(n, seed=100 + n)
    _, h = rec.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = np.zeros_like(b, dtype=np.float64)
    prev = np.zeros(b[:, 0].shape)
    for t in range(n):
        prev = a[:, t].astype(np.float64) * prev + b[:, t]
        want[:, t] = prev
    np.testing.assert_allclose(h.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_bf16_sigmoid_and_gelu_round_as_jax():
    x = (np.random.default_rng(1).standard_normal((8, 257, 64)) * 3).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(rec.sigmoid(tx).float().numpy(),
                                  np.asarray(jax.nn.sigmoid(jx), np.float32))
    np.testing.assert_array_equal(layers.gelu_tanh(tx).float().numpy(),
                                  np.asarray(jax.nn.gelu(jx, approximate=True), np.float32))


def _cfgs():
    return jax_reduced(JAX_ARCHS[ARCH]), reduced(ARCHS[ARCH])


def _params(jcfg, dtype, seed=0):
    """JAX's ``init_rglru`` weights, and the same as torch tensors (matrices
    in ``dtype``, ``a_param`` in f32)."""
    jp = jrec.init_rglru(jax.random.key(seed), jcfg)

    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else
                torch.from_numpy(np.array(v, np.float32)).to(
                    torch.float32 if k == "a_param" else dtype)
                for k, v in d.items()}

    return jp, tree(jp)


def _inputs(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def test_init_rglru_matches_jax_shapes_and_decay_range():
    jcfg, cfg = _cfgs()
    p = rec.init_rglru(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jrec.init_rglru(jax.random.key(0), jcfg)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), p) == shapes
    assert p["a_param"].dtype == torch.float32 and p["w_x"]["w"].dtype == torch.bfloat16
    base = torch.sigmoid(p["a_param"])  # a = base^(c r), base = u^(1/c), u in [0.9, 0.999]
    assert float(base.min()) >= 0.9 ** (1 / 8) - 1e-6 and float(base.max()) <= 0.999 ** (1 / 8)
    assert rec.rglru_cache_shapes(cfg, 3) == jrec.rglru_cache_shapes(jcfg, 3)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("s", [1, 5, 64, 257])
def test_rglru_forward_matches_jax(dtype, tol, s):
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg, DTYPES[dtype][1], seed=s)
    jx, x = _inputs(np.random.default_rng(s), (2, s, cfg.d_model), dtype)
    jout, (jconv, jh) = jrec.rglru_forward(jp, jcfg, jx, return_state=True)
    out, (conv, h) = rec.rglru_forward(p, cfg, x, return_state=True)
    assert out.dtype == x.dtype and conv.dtype == x.dtype and h.dtype == torch.float32
    _close(out, jout, tol)
    np.testing.assert_array_equal(conv.float().numpy(), np.asarray(jconv, np.float32))
    _close(h, jh, F32_TOL)


def test_rglru_forward_folds_initial_h_as_jax():
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg, torch.float32, seed=3)
    rng = np.random.default_rng(3)
    jx, x = _inputs(rng, (2, 9, cfg.d_model), "float32")
    h0 = rng.standard_normal((2, cfg.lru_width)).astype(np.float32)
    jout = jrec.rglru_forward(jp, jcfg, jx, initial_h=jnp.asarray(h0))
    out = rec.rglru_forward(p, cfg, x, initial_h=torch.from_numpy(h0))
    _close(out, jout, F32_TOL)
    without = rec.rglru_forward(p, cfg, x)
    assert float((out - without).abs().max()) > 100 * F32_TOL * float(out.abs().max())


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_rglru_decode_matches_jax(dtype, tol):
    """Several steps from JAX's own prefill state: the output of every step
    and the state it leaves."""
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg, DTYPES[dtype][1], seed=4)
    rng = np.random.default_rng(4)
    jx, _ = _inputs(rng, (2, 6, cfg.d_model), dtype)
    _, (jconv, jh) = jrec.rglru_forward(jp, jcfg, jx, return_state=True)
    cache = (torch.from_numpy(np.asarray(jconv, np.float32)).to(DTYPES[dtype][1]),
             torch.from_numpy(np.array(jh)))
    jcache = (jconv, jh)
    for _ in range(5):
        jx1, x1 = _inputs(rng, (2, 1, cfg.d_model), dtype)
        jout, jcache = jrec.rglru_decode(jp, jcfg, jx1, jcache)
        out, cache = rec.rglru_decode(p, cfg, x1, cache)
        _close(out, jout, tol)
        np.testing.assert_array_equal(cache[0].float().numpy(), np.asarray(jcache[0], np.float32))
        _close(cache[1], jcache[1], F32_TOL)


def test_rglru_decode_continues_forward():
    """In f32, a prefill of S tokens then k decode steps gives the rows and
    the state of a prefill of S + k: the scan and the step compute one
    recurrence (a one-row product sums in another order than a 40-row one,
    so the f32 rule, not equality)."""
    _, cfg = _cfgs()
    p = rec.init_rglru(cfg, torch.Generator().manual_seed(5), "cpu")
    p = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
         for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 40, cfg.d_model))
                         .astype(np.float32))
    want, (conv_want, h_want) = rec.rglru_forward(p, cfg, x, return_state=True)
    _, cache = rec.rglru_forward(p, cfg, x[:, :33], return_state=True)
    for t in range(33, 40):
        out, cache = rec.rglru_decode(p, cfg, x[:, t:t + 1], cache)
        torch.testing.assert_close(out[:, 0], want[:, t], rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(cache[0], conv_want, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(cache[1], h_want, rtol=F32_TOL, atol=F32_TOL)
    assert math.isfinite(float(cache[1].abs().max()))

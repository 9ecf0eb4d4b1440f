"""What the host decides for the flash-attention kernel's tensor-core route.

The kernel itself builds and runs only on the card (``chip_smoke.py`` holds
both routes to the plain version there).  These tests pin what the wrapper
decides on the host: which route a call takes (dtype, head width, TMA
alignment), the blocks REMOP's rule plans for that route and the shared
memory they need, that a refused tensor-core call raises instead of going to
the CUDA-core kernel (through a stand-in for the kernel's library), and the
premise of the split P, in plain torch.  Then the plain version at the
tensor-core route's blocks against the JAX package's Pallas kernel (interpret
mode), bf16 within the JAX tests' 3e-2.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import remop_flash_attention as jax_flash

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import (
    BLOCK_CANDIDATES, plan_blocks, remop_flash_attention,
)

BF16 = torch.bfloat16


def _qkv(b, h, kv, s, t, hd, dtype=BF16):
    return (torch.zeros(b, h, s, hd, dtype=dtype), torch.zeros(b, kv, t, hd, dtype=dtype),
            torch.zeros(b, kv, t, hd, dtype=dtype))


def _model_layout(b, h, kv, s, hd, dtype=BF16):
    """The model's [B, S, heads, hd] activations seen as [B, heads, S, hd]."""
    return (torch.zeros(b, s, h, hd, dtype=dtype).transpose(1, 2),
            torch.zeros(b, s, kv, hd, dtype=dtype).transpose(1, 2),
            torch.zeros(b, s, kv, hd, dtype=dtype).transpose(1, 2))


def _misaligned(b, h, kv, s, hd):
    """bf16 q, k, v whose bases sit 2 bytes past a 16-byte boundary."""
    out = []
    for heads in (h, kv, kv):
        n = b * heads * s * hd
        out.append(torch.zeros(n + 1, dtype=BF16)[1:].view(b, heads, s, hd))
    return out


def _odd_head_stride(b, h, kv, s, hd):
    """q whose heads lie hd + 4 elements apart (a slice of wider rows)."""
    q = torch.zeros(b, s, h, hd + 4, dtype=BF16)[..., :hd].transpose(1, 2)
    return (q, *_qkv(b, h, kv, s, s, hd)[1:])


@pytest.mark.parametrize("make,want", [
    (lambda: _qkv(1, 8, 1, 2048, 2048, 256), "tc"),              # the kernel's own layout
    (lambda: _model_layout(1, 8, 1, 777, 256), "tc"),            # gemma-2b's transposed views
    (lambda: _model_layout(2, 16, 8, 300, 128), "tc"),           # qwen3-0.6b's
    (lambda: _qkv(2, 4, 2, 300, 333, 64), "tc"),                 # hd 64, ragged suffix
    (lambda: _qkv(1, 1, 1, 1, 1, 128), "tc"),                    # extent-1 dims: any stride
    (lambda: _misaligned(1, 2, 1, 64, 128), "simt"),             # base not on 16 bytes
    (lambda: _odd_head_stride(1, 4, 2, 64, 128), "simt"),        # head stride 132 elements
    (lambda: _qkv(1, 8, 1, 512, 512, 256, torch.float32), "simt"),  # f32: never TF32
    (lambda: _qkv(1, 8, 1, 512, 512, 32), "simt"),               # hd 32
    (lambda: _qkv(1, 8, 1, 512, 512, 16), "simt"),               # hd 16
])
def test_route_rule(make, want):
    q, k, v = make()
    assert fa.route(q, k, v) == want
    # The plan follows the route: wgmma's 64 rows on the tensor cores.
    s, t, hd = q.shape[2], k.shape[2], q.shape[3]
    bq, bk = plan_blocks(s, t, hd, q.element_size(), path=want)
    assert bq in BLOCK_CANDIDATES[want] and bk in BLOCK_CANDIDATES[want]
    fa.check_blocks(want, bq, bk, hd)


@pytest.mark.parametrize("hd", fa.TC_HEAD_DIMS)
def test_tc_plan_blocks_are_wgmma_rows_within_shared_memory(hd):
    for s, t in ((32768, 32768), (2048, 2048), (1000, 1000), (300, 333), (1, 4096), (64, 64)):
        bq, bk = plan_blocks(s, t, hd, 2)
        assert bq % 64 == 0 and bk % 64 == 0
        assert fa.smem_bytes(bq, bk, hd, 2, "tc") <= fa.SMEM_LIMIT == 232_448
    # REMOP's rule: the fewest KV staging rounds that fit.  At hd 256 two
    # stages of K and V at bk 128 need 263 KB, so bk stays 64.
    assert plan_blocks(2048, 2048, hd, 2) == ((128, 64) if hd == 256 else (128, 128))
    # What the card's occupancy query reported for these instantiations.
    assert fa.smem_bytes(128, 64, 256, 2, "tc") == 197_688
    assert fa.smem_bytes(128, 128, 128, 2, "tc") == 164_920


@pytest.mark.parametrize("bq,bk,hd", [(32, 32, 128), (64, 16, 64), (128, 128, 256),
                                      (256, 64, 128), (1, 64, 64)])
def test_tc_route_refuses_blocks_it_does_not_launch(bq, bk, hd):
    q, k, v = _qkv(1, 2, 1, 128, 128, hd)
    assert fa.route(q, k, v) == "tc"
    with pytest.raises(ValueError, match="tensor-core route"):
        fa.flash_attention(q, k, v, bq=bq, bk=bk)
    # The same blocks on the CUDA-core route are its own rule.
    qf, kf, vf = (x.float() for x in (q, k, v))
    if 1 <= bq <= fa.MAX_BLOCK and 1 <= bk <= fa.MAX_BLOCK:
        fa.flash_attention(qf, kf, vf, bq=bq, bk=bk)
    else:
        with pytest.raises(ValueError, match="must lie in"):
            fa.flash_attention(qf, kf, vf, bq=bq, bk=bk)


class _FakeLibrary:
    """Stands in for the built ``flash_attention`` library: records each call
    (its entry point, arguments and the 12 strides it was handed) and returns
    ``tc_error`` from the tensor-core entry point."""

    def __init__(self, tc_error=0):
        self.calls = []
        self.tc_error = tc_error

    def _record(self, name, args):
        strides = ctypes.cast(args[4], ctypes.POINTER(ctypes.c_longlong))[:12]
        self.calls.append((name, args, strides))

    def remop_flash_attention_tc(self, *args):
        self._record("tc", args)
        return self.tc_error

    def remop_flash_attention_bf16(self, *args):
        self._record("bf16", args)
        return 0

    def remop_flash_attention_f32(self, *args):
        self._record("f32", args)
        return 0

    def remop_flash_attention_error_string(self, err):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake_card(monkeypatch):
    """Makes the wrapper take its CUDA branch on CPU tensors, with a stand-in
    library; returns a function that installs one."""
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    runtime.reset_launches()

    def install(lib):
        monkeypatch.setattr(runtime, "library", lambda name: lib)
        return lib

    yield install
    runtime.reset_launches()


def test_tc_calls_go_to_the_tc_entry_point_and_count(fake_card):
    lib = fake_card(_FakeLibrary())
    q, k, v = _model_layout(1, 8, 1, 777, 256)
    out = remop_flash_attention(q, k, v)
    assert out.stride() == q.stride()
    (name, args, strides), = lib.calls
    assert name == "tc"
    assert strides == [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    assert args[5:13] == (1, 8, 1, 777, 777, 256, 128, 64)  # b h kv s t hd bq bk
    assert args[14] == 1  # P split into P_hi + P_lo
    assert dict(runtime.launches) == {"flash_attention": 1, "flash_attention_tc": 1}
    fa.flash_attention(q, k, v, bq=128, bk=64, split_p=False)
    assert lib.calls[-1][0] == "tc" and lib.calls[-1][1][14] == 0
    with pytest.raises(ValueError, match="tensor-core route only"):
        fa.flash_attention(*(x.float() for x in (q, k, v)), split_p=False)


@pytest.mark.parametrize("make,entry", [
    (lambda: _qkv(2, 16, 8, 300, 333, 128, torch.float32), "f32"),
    (lambda: _qkv(2, 16, 8, 300, 333, 32), "bf16"),
    (lambda: _misaligned(1, 2, 1, 64, 128), "bf16"),
])
def test_other_calls_go_to_the_cuda_core_entry_point(fake_card, make, entry):
    lib = fake_card(_FakeLibrary())
    q, k, v = make()
    remop_flash_attention(q, k, v)
    (name, args, _), = lib.calls
    assert name == entry and args[11:13] == (min(64, q.shape[2]), min(64, k.shape[2]))
    assert dict(runtime.launches) == {"flash_attention": 1, "flash_attention_simt": 1}


def test_a_failed_tc_launch_raises_and_never_reroutes(fake_card):
    lib = fake_card(_FakeLibrary(tc_error=700))
    q, k, v = _qkv(1, 8, 1, 2048, 2048, 256)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        remop_flash_attention(q, k, v)
    assert [name for name, _, _ in lib.calls] == ["tc"]
    assert sum(runtime.launches.values()) == 0


def _softmax_draw(seed, rows=64, cols=512):
    g = torch.Generator().manual_seed(seed)
    scores = torch.randn(rows, cols, generator=g) * 3
    return torch.softmax(scores, dim=-1), torch.randn(cols, 256, generator=g).to(BF16).float()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_p_split_keeps_16_bits_of_p(seed):
    p, v = _softmax_draw(seed)
    p_hi = p.to(BF16).float()
    p_lo = (p - p_hi).to(BF16).float()
    assert bool(((p - (p_hi + p_lo)).abs() <= 2.0 ** -16 * p.abs()).all())
    # The PV product with the split is closer to the f32 product than with
    # one bf16 P: the two products the kernel runs into the same O.
    exact = p @ v
    err_split = ((p_hi @ v + p_lo @ v) - exact).norm() / exact.norm()
    err_single = (p_hi @ v - exact).norm() / exact.norm()
    assert err_split < err_single / 100


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("shape", [(1, 2, 1, 256, 256), (2, 4, 2, 128, 256)])
def test_plain_at_tc_blocks_matches_pallas(hd, shape):
    b, h, kv, s, t = shape
    rng = np.random.default_rng(hd + s + t)
    arrays = [rng.standard_normal(sh).astype(np.float32)
              for sh in ((b, h, s, hd), (b, kv, t, hd), (b, kv, t, hd))]
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    q, k, v = (torch.from_numpy(a).to(BF16) for a in arrays)
    assert fa.route(q, k, v) == "tc"
    bq, bk = plan_blocks(s, t, hd, 2)
    want = np.asarray(jax_flash(jq, jk, jv, bq=bq, bk=bk), np.float32)
    got = remop_flash_attention(q, k, v)
    assert got.dtype == BF16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)

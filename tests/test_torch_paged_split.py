"""The split (flash-decoding) paged-attention kernel's host rules and plain version.

The kernel itself builds and runs only on the card (``chip_smoke.py`` holds
it to its plain version there).  These tests pin what can be checked without
one: the chunk rule that each CTA applies on the device to ``lengths[b]``
(the chunks tile ``[0, len)`` exactly), the host's plan (enough CTAs for one
wave at gemma-2b's and granite-20b's decode shapes), the plain version's
split arithmetic against the JAX package's Pallas kernel in interpret mode
at 1 to 132 splits (f32 within the JAX tests' 2e-5, bf16 within their
3e-2), and the wrapper's CUDA branch through a stand-in for the kernel's
library: the planned grid, the scratch buffer, one launch counted a call, a
failed launch raising with no second route, and no padding of the caches.
"""

import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.paged_attention.ops import remop_paged_attention as jax_paged

from repro_torch.kernels import runtime
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention.ops import remop_paged_attention

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
SPLITS = (1, 3, 7, 16, 132)


# -- the chunk rule -----------------------------------------------------------------


@pytest.mark.parametrize("splits", SPLITS + (2, 64, 256))
def test_chunks_tile_every_length_exactly(splits):
    s = 700
    for length in range(1, s + 1):
        bounds = pa.chunk_bounds(length, splits)
        assert len(bounds) == splits
        c = pa.chunk_len(length, splits)
        assert c % pa.MIN_CHUNK == 0 and c >= pa.MIN_CHUNK
        # In split order, each chunk starts where the last ended: no gap, no
        # overlap, and together they are [0, length).
        end = 0
        for lo, hi in bounds:
            assert lo == min(end, length) and lo <= hi <= length
            end = hi
        assert end == length
        live = [b for b in bounds if b[0] < b[1]]
        assert live[0][0] == 0 and all(hi - lo <= c for lo, hi in live)
        # The combine's count of live chunks, ceil(len / c), is the chunks
        # the rule leaves non-empty, and never more than the splits.
        assert len(live) == -(-length // c) <= splits


def test_chunk_len_in_torch_is_the_host_rule():
    lengths = torch.arange(0, 5000, dtype=torch.int32)
    for splits in SPLITS:
        want = [pa.chunk_len(int(n), splits) for n in lengths]
        assert pa.chunk_len(lengths.long(), splits).tolist() == want


# -- the plan ---------------------------------------------------------------------


@pytest.mark.parametrize("name,b,kv,g,s", [
    ("gemma-2b decode", 1, 1, 8, 4096),
    ("granite-20b decode", 1, 1, 48, 4096),
    ("qwen3-0.6b decode", 1, 8, 2, 4096),
    ("f32 check shape", 4, 8, 2, 4096),
])
def test_plan_fills_a_wave(name, b, kv, g, s):
    splits, gc = pa.plan(b, kv, g, s)
    ctas = splits * b * kv * -(-g // gc)
    assert ctas >= pa.SMS, name
    assert gc == min(g, pa.MAX_GROUP)  # all heads of a KV head in one CTA
    assert splits <= -(-s // pa.MIN_CHUNK)
    # At the serving lengths every chunk of the decode shapes is one tile of
    # 32 positions or less, so a CTA has its whole chunk in flight at once.
    if b == kv == 1:
        assert pa.chunk_len(s, splits) <= 32


def test_plan_caps_splits_at_short_caches_and_large_batches():
    assert pa.plan(1, 1, 8, 40) == (3, 8)      # ceil(40 / 16) chunks of 16
    assert pa.plan(1, 1, 1, 1) == (1, 1)
    assert pa.plan(64, 8, 4, 4096) == (1, 4)   # 512 head groups fill the card alone
    assert pa.plan(1, 1, 100, 4096) == (66, 64)  # two head groups


# -- the split plain version against the Pallas kernel --------------------------------


CASES = {
    # (b, kv, g, hd, s, lengths): ragged; lengths 1 and S; granite-20b's group
    "ragged": (2, 2, 4, 32, 256, (77, 200)),
    "one and full": (2, 1, 2, 64, 192, (1, 192)),
    "granite G 48": (2, 1, 48, 128, 128, (1, 100)),
}


@functools.lru_cache(maxsize=None)
def _case(name, dtype):
    b, kv, g, hd, s, lengths = CASES[name]
    rng = np.random.default_rng(len(name) * 7 + hd)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, kv, g, hd), (b, s, kv, hd), (b, s, kv, hd))]
    jdt, tdt, _ = DTYPES[dtype]
    ln = np.asarray(lengths, np.int32)
    want = np.asarray(jax_paged(*(jnp.asarray(a).astype(jdt) for a in arrays),
                                jnp.asarray(ln), page=64), np.float32)
    return [torch.from_numpy(a).to(tdt) for a in arrays], torch.from_numpy(ln), want


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_plain_matches_pallas(case, dtype, splits):
    (q, kc, vc), ln, want = _case(case, dtype)
    got = pa.paged_attention_plain(q, kc, vc, ln, page=64, splits=splits)
    assert got.dtype == q.dtype
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_split_plain_skips_chunks_past_the_length():
    """At length 77 over 132 splits of 16, 5 chunks are live; the other 127
    hold no position and must add nothing, whatever their (m, l, acc)."""
    (q, kc, vc), ln, _ = _case("ragged", "float32")
    assert sum(lo < hi for lo, hi in pa.chunk_bounds(77, 132)) == 5
    one = pa.paged_attention_plain(q, kc, vc, ln, page=64, splits=1)
    many = pa.paged_attention_plain(q, kc, vc, ln, page=64, splits=132)
    assert torch.isfinite(many).all()
    torch.testing.assert_close(many, one, rtol=2e-6, atol=2e-6)


def test_cpu_route_takes_the_planned_splits():
    (q, kc, vc), ln, _ = _case("granite G 48", "float32")
    want = pa.paged_attention_plain(q, kc, vc, ln, page=128,
                                    splits=pa.plan(*q.shape[:3], kc.shape[1])[0])
    assert torch.equal(pa.paged_attention(q, kc, vc, ln), want)


def test_pages_that_do_not_divide_s_give_the_same_results_on_the_cpu():
    """``remop_paged_attention`` pads the caches for the plain version on the
    CPU only; the results are those of the padded call."""
    (q, kc, vc), ln, _ = _case("one and full", "float32")
    for page in (50, 100, 128):
        pad = (-kc.shape[1]) % page
        assert pad
        want = pa.paged_attention(q, F.pad(kc, (0, 0, 0, 0, 0, pad)),
                                  F.pad(vc, (0, 0, 0, 0, 0, pad)), ln, page=page)
        assert torch.equal(remop_paged_attention(q, kc, vc, ln, page=page), want)


# -- the CUDA branch, through a stand-in for the kernel's library -----------------------


class _FakeLibrary:
    """Stands in for the built ``paged_attention`` library: records each call
    and returns ``error`` from the entry points."""

    def __init__(self, error=0):
        self.calls = []
        self.error = error

    def remop_paged_attention_bf16(self, *args):
        self.calls.append(("bf16", args))
        return self.error

    def remop_paged_attention_f32(self, *args):
        self.calls.append(("f32", args))
        return self.error

    def remop_paged_attention_error_string(self, err):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake_card(monkeypatch):
    """Makes the wrapper take its CUDA branch on CPU tensors, with a stand-in
    library and a record of the buffers ``torch.empty`` allocates."""
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    allocated = []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        out = empty(*args, **kwargs)
        allocated.append(out)
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    runtime.reset_launches()

    def install(lib):
        monkeypatch.setattr(runtime, "library", lambda name: lib)
        return lib

    yield install, allocated
    runtime.reset_launches()


@pytest.mark.parametrize("b,kv,g,hd,s,dtype", [
    (1, 1, 8, 256, 4096, torch.bfloat16),   # gemma-2b decode
    (1, 1, 48, 128, 4096, torch.bfloat16),  # granite-20b decode
    (4, 8, 2, 128, 4095, torch.float32),    # S no multiple of the page
])
def test_cuda_calls_reach_the_split_entry_point_with_the_plan(fake_card, b, kv, g, hd, s, dtype):
    install, allocated = fake_card
    lib = install(_FakeLibrary())
    q = torch.zeros(b, kv, g, hd, dtype=dtype)
    kc, vc = torch.zeros(b, s, kv, hd, dtype=dtype), torch.zeros(b, s, kv, hd, dtype=dtype)
    ln = torch.full((b,), s, dtype=torch.int32)
    out = remop_paged_attention(q, kc, vc, ln)
    (entry, args), = lib.calls
    assert entry == {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
    splits, gc = pa.plan(b, kv, g, s)
    # q, k, v, lengths, out, scratch, b, kv, g, s, hd, splits, gc, scale, stream
    assert args[:4] == (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ln.data_ptr())
    assert args[4] == out.data_ptr() and out.shape == q.shape and out.dtype == q.dtype
    assert args[6:13] == (b, kv, g, s, hd, splits, gc)  # the caches are not padded
    assert args[13] == pytest.approx(hd ** -0.5)
    scratch, = [t for t in allocated if t.data_ptr() == args[5]]
    assert scratch.dtype == torch.float32
    assert scratch.numel() == pa.scratch_floats(b, kv, g, hd, splits)
    assert scratch.numel() == b * kv * g * splits * (hd + 2)
    assert dict(runtime.launches) == {"paged_attention": 1}
    pa.paged_attention(q, kc, vc, ln)
    assert len(lib.calls) == 2 and dict(runtime.launches) == {"paged_attention": 2}


def test_a_failed_launch_raises_and_never_reroutes(fake_card):
    install, _ = fake_card
    lib = install(_FakeLibrary(error=700))
    q = torch.zeros(1, 1, 8, 256, dtype=torch.bfloat16)
    kc = torch.zeros(1, 4096, 1, 256, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        pa.paged_attention(q, kc, kc, torch.tensor([2048], dtype=torch.int32))
    assert len(lib.calls) == 1
    assert sum(runtime.launches.values()) == 0


def test_cuda_branch_checks_what_the_kernel_takes(fake_card):
    install, _ = fake_card
    lib = install(_FakeLibrary())
    q = torch.zeros(1, 1, 8, 192, dtype=torch.bfloat16)
    kc = torch.zeros(1, 64, 1, 192, dtype=torch.bfloat16)
    ln = torch.tensor([64], dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, kc, kc, ln)
    q, kc = q[..., :128].contiguous(), kc[..., :128].contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, torch.zeros(1, 64, 1, 256, dtype=torch.bfloat16)[..., :128], kc, ln)
    # Any S on the card: the page only matters to the plain version.
    pa.paged_attention(q, kc, kc, ln, page=48)
    assert len(lib.calls) == 1

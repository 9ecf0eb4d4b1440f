"""MoE dispatch/combine and the sort oracle against the JAX package's.

The same rows and expert ids, made with numpy from a seed, go through
``repro``'s ``remop_dispatch``/``remop_combine`` (Pallas in interpret mode,
as its own tests run them on the CPU) and ``dispatch_ref``/``combine_ref``,
and through the port's (CPU tensors: the sort and gather kernels' plain
versions).  Slots and expert buffers must be equal bit for bit, a kept -0.0
included (``remop_dispatch`` copies it, ``dispatch_ref`` adds it onto +0.0);
combine within 1e-6 of scale in f32.  ``sort_ref``/``sort_pairs_ref`` are
held to ``repro``'s.  The CUDA branch runs against stand-in libraries that
execute the sort plan tile by tile (``run_plan_plain``) and the gather on the
bytes they are handed: no card is needed.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dispatch.ops import remop_combine as jax_combine
from repro.kernels.dispatch.ops import remop_dispatch as jax_dispatch
from repro.kernels.dispatch.ref import combine_ref as jax_combine_ref
from repro.kernels.dispatch.ref import dispatch_ref as jax_dispatch_ref
from repro.kernels.merge_sort.ref import sort_pairs_ref as jax_sort_pairs_ref
from repro.kernels.merge_sort.ref import sort_ref as jax_sort_ref

from repro_torch.kernels import runtime
from repro_torch.kernels.dispatch.ops import (
    remop_combine, remop_combine_plain, remop_dispatch, remop_dispatch_plain)
from repro_torch.kernels.dispatch.ref import combine_ref, dispatch_ref
from repro_torch.kernels.merge_sort import merge_sort as ms
from repro_torch.kernels.merge_sort.ref import sort_pairs_ref, sort_ref
from repro_torch.models import moe

# (experts, capacity, assignments, row width): tests/test_kernels.py's three,
# granite-moe's 40 experts with drops, and one past a sort block (2^14).
CASES = [(4, 8, 24, 8), (8, 4, 64, 8), (16, 16, 100, 8), (40, 6, 256, 32),
         (40, 420, (1 << 14) + 40, 4)]


def _rows(rng, a, d):
    x = rng.standard_normal((a, d)).astype(np.float32)
    x[rng.random((a, d)) < 0.05] = -0.0
    return x


def _bits(a) -> bytes:
    return np.asarray(a).tobytes()


@pytest.mark.parametrize("e,cap,a,d", CASES)
def test_dispatch_matches_jax_bit_for_bit(e, cap, a, d):
    rng = np.random.default_rng(a)
    x = _rows(rng, a, d)
    ids = rng.integers(0, e, a).astype(np.int32)
    jin, jslot = jax_dispatch(jnp.asarray(x), jnp.asarray(ids), e, cap, interpret=True)
    got_in, got_slot = remop_dispatch(torch.from_numpy(x), torch.from_numpy(ids), e, cap)
    assert got_in.shape == (e, cap, d) and got_slot.dtype == torch.int32
    assert _bits(got_slot) == _bits(jslot) and _bits(got_in) == _bits(jin)
    rin, rslot = dispatch_ref(torch.from_numpy(x), torch.from_numpy(ids), e, cap)
    jrin, jrslot = jax_dispatch_ref(jnp.asarray(x), jnp.asarray(ids), e, cap)
    assert _bits(rslot) == _bits(jrslot) and _bits(rin) == _bits(jrin)
    # The kernels' dispatch and the oracle agree by value (the oracle adds
    # each row onto +0.0, so a kept -0.0 reads +0.0 there).
    assert torch.equal(got_slot, rslot) and torch.equal(got_in, rin)
    assert (got_slot < 0).any() == (np.bincount(ids, minlength=e).max() > cap)
    assert bool(torch.signbit(got_in).any()) and not bool(torch.signbit(rin[rin == 0]).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_are_the_dispatch_and_combine(dtype):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rows(rng, 600, 16)).to(dtype)
    ids = torch.from_numpy(rng.integers(0, 40, 600).astype(np.int32))
    got = remop_dispatch(x, ids, 40, 12)
    want = remop_dispatch_plain(x, ids, 40, 12)
    assert all(_bits(g.view(torch.int16) if g.dtype == torch.bfloat16 else g)
               == _bits(w.view(torch.int16) if w.dtype == torch.bfloat16 else w)
               for g, w in zip(got, want))
    w = torch.rand(600).to(dtype)
    out = remop_combine(got[0], got[1], w, top_k=4)
    assert torch.equal(out, remop_combine_plain(got[0], got[1], w, top_k=4))
    assert torch.equal(out, combine_ref(got[0], got[1], w, 150, 4))


@pytest.mark.parametrize("t,k,e,cap,d", [(16, 2, 4, 12, 8), (64, 8, 40, 6, 16),
                                         (50, 4, 8, 30, 8)])
def test_dispatch_combine_roundtrip_matches_jax(t, k, e, cap, d):
    rng = np.random.default_rng(t * k)
    x = rng.standard_normal((t, d)).astype(np.float32)
    xa = np.repeat(x, k, axis=0)
    ids = rng.integers(0, e, t * k).astype(np.int32)
    logits = rng.standard_normal(t * k).astype(np.float32)
    w = np.exp(logits - logits.max())
    w = (w / w.sum()).astype(np.float32)
    jin, jslot = jax_dispatch(jnp.asarray(xa), jnp.asarray(ids), e, cap, interpret=True)
    # Identity "experts": combine reproduces the weighted sum of kept rows.
    jgot = np.asarray(jax_combine(jin, jslot, jnp.asarray(w), top_k=k, interpret=True))
    jwant = np.asarray(jax_combine_ref(jin, jslot, jnp.asarray(w), t, k))
    got_in, got_slot = remop_dispatch(torch.from_numpy(xa), torch.from_numpy(ids), e, cap)
    got = remop_combine(got_in, got_slot, torch.from_numpy(w), top_k=k).numpy()
    want = combine_ref(got_in, got_slot, torch.from_numpy(w), t, k).numpy()
    scale = float(np.abs(jwant).max())
    for a in (got, want):
        assert a.shape == (t, d) and np.abs(a - jgot).max() <= 1e-6 * scale
    assert np.abs(jgot - jwant).max() <= 1e-6 * scale


def test_dispatch_is_the_moe_layers_dense_scatter():
    """At batch 1 the kernels' dispatch of the flat (token-major,
    choice-minor) assignments fills the buffers the MoE layer's dense scatter
    fills, bit for bit, drops included."""
    rng = np.random.default_rng(3)
    s, k, e = 300, 8, 40
    cap = max(1, int(1.0 * s * k / e))
    x = torch.from_numpy(_rows(rng, s, 24)[None]).to(torch.bfloat16)
    ids = torch.from_numpy(np.argsort(rng.random((1, s, e)), axis=-1)[..., :k].copy())
    dense_in, keep, slot = moe.dispatch_dense(x, ids, e, cap)
    assert not bool(keep.all())  # drops occur
    got_in, got_slot = remop_dispatch(x[0].repeat_interleave(k, dim=0),
                                      ids.reshape(-1).to(torch.int32), e, cap)
    assert _bits(got_in.view(torch.int16)) == _bits(dense_in[0].view(torch.int16))
    assert torch.equal(got_slot >= 0, keep[0])
    assert torch.equal(got_slot[keep[0]].long(), slot[0][keep[0]])


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_sort_oracles_match_jax(dtype):
    rng = np.random.default_rng(11)
    keys = rng.integers(-50, 50, 3000).astype(dtype)
    if dtype == np.float32:
        keys[rng.random(3000) < 0.1] = 0.0
        keys[rng.random(3000) < 0.1] = -0.0
        keys[rng.random(3000) < 0.02] = np.float32(np.nan)
        keys[rng.random(3000) < 0.02] = -np.float32(np.nan)
        assert np.signbit(keys[keys == 0]).any() and not np.signbit(keys[keys == 0]).all()
    values = rng.permutation(3000).astype(np.int32)
    assert _bits(sort_ref(torch.from_numpy(keys))) == _bits(jax_sort_ref(jnp.asarray(keys)))
    got = sort_pairs_ref(torch.from_numpy(keys), torch.from_numpy(values))
    want = jax_sort_pairs_ref(jnp.asarray(keys), jnp.asarray(values))
    assert all(_bits(g) == _bits(w) for g, w in zip(got, want))


# -- the CUDA branch, on stand-in libraries ------------------------------------------


class _FakeSort:
    """Stands in for ``libmerge_sort``: runs the plan it is handed tile by
    tile on the bytes at the pointers, and counts its calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("remop_") or not name.endswith(("_i32", "_f32")):
            raise AttributeError(name)
        ctype, dtype = ((ctypes.c_float, torch.float32) if name.endswith("_f32")
                        else (ctypes.c_int32, torch.int32))

        def entry(keys, values, keys_out, values_out, n, plan, launches, stream):
            fields = list((ctypes.c_int * (ms.PLAN_FIELDS * launches)).from_address(plan))
            rows = [fields[i * ms.PLAN_FIELDS:(i + 1) * ms.PLAN_FIELDS] for i in range(launches)]
            steps = [ms.Launch(ms.ROUTES[r[0]], *r[1:5], bool(r[5]), r[6]) for r in rows]

            def view(ptr, ct, dt):
                return torch.frombuffer((ct * n).from_address(ptr), dtype=dt)

            k, v = ms.run_plan_plain(view(keys, ctype, dtype).clone(),
                                     view(values, ctypes.c_int32, torch.int32).clone(), steps)
            view(keys_out, ctype, dtype).copy_(k)
            view(values_out, ctypes.c_int32, torch.int32).copy_(v)
            self.calls.append(name)
            return 0

        return entry


class _FakeGather:
    """Stands in for ``libgather_rows``: copies the rows it is handed."""

    def __init__(self):
        self.calls = 0

    def remop_gather_rows(self, x, idx, out, n, row_bytes, route, unit, lanes, stream):
        rows = torch.frombuffer((ctypes.c_int32 * n).from_address(idx), dtype=torch.int32)
        src = (ctypes.c_uint8 * (row_bytes * (int(rows.max()) + 1))).from_address(x)
        src = torch.frombuffer(src, dtype=torch.uint8).view(-1, row_bytes)
        dst = torch.frombuffer((ctypes.c_uint8 * (row_bytes * n)).from_address(out),
                               dtype=torch.uint8).view(n, row_bytes)
        dst.copy_(src[rows.long()])
        self.calls += 1
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers take their CUDA branch on CPU tensors, against stand-in
    libraries."""
    libs = {"merge_sort": _FakeSort(), "gather_rows": _FakeGather()}
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(runtime, "library", libs.__getitem__)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    runtime.reset_launches()
    yield libs
    runtime.reset_launches()


@pytest.mark.parametrize("a,e,cap", [(600, 40, 12), ((1 << 14) + 8, 40, 400)])
def test_cuda_branch_launches_the_sort_and_gather_kernels(fake_card, a, e, cap):
    rng = np.random.default_rng(a)
    x = torch.from_numpy(_rows(rng, a, 16)).to(torch.bfloat16)
    ids = torch.from_numpy(rng.integers(0, e, a).astype(np.int32))
    want_in, want_slot = remop_dispatch_plain(x, ids, e, cap)
    w = torch.rand(a).to(torch.bfloat16)
    want_y = remop_combine_plain(want_in, want_slot, w, top_k=4)

    got_in, got_slot = remop_dispatch(x, ids, e, cap)
    launches = dict(runtime.launches)
    assert launches["sort_blocks"] == 1 and launches["gather_rows"] == 1
    assert launches.get("merge_pass", 0) == (1 if a > ms.MAX_BLOCK else 0)
    assert torch.equal(got_slot, want_slot)
    assert _bits(got_in.view(torch.int16)) == _bits(want_in.view(torch.int16))
    got_y = remop_combine(got_in, got_slot, w, top_k=4)
    assert runtime.launches["gather_rows"] == 2 and fake_card["gather_rows"].calls == 2
    assert _bits(got_y.view(torch.int16)) == _bits(want_y.view(torch.int16))
    assert fake_card["merge_sort"].calls[0] == "remop_sort_blocks_i32"

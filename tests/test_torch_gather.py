"""``gather_rows`` against the JAX package's Pallas kernel, its host plan, and
its CUDA branch.

The same rows and indices, made with numpy from a seed, go through the JAX
package's ``gather_rows`` (Pallas in interpret mode, as its own tests run it
on the CPU) and the port's wrapper on CPU tensors (its plain version); the
outputs must be equal bit for bit, at ``rows_per_block`` 1, 2 and 8, rows of
1 to 64 elements of int32, int64, bf16 and uint8, and on the main path's
index pattern (the stable argsort of partition ids).  On the card the
wrapper runs ``rows_per_block > 1`` as a gather of blocks
(``block_view``) and picks the kernel's route on the host (``plan``); both
are checked here on their own, and the CUDA branch runs against a stand-in
library: no card is needed.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dispatch.dispatch import gather_rows as jax_gather_rows

from repro_torch.kernels import runtime
from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.dispatch.dispatch import Plan, block_view, gather_rows, plan

T, N = 64, 48  # rows of x, indices
WIDTHS = (1, 2, 3, 4, 5, 8, 12, 16, 33, 64)
# dtype: (numpy type of the bits, the torch dtype they are viewed as)
DTYPES = {"int32": (np.int32, torch.int32), "int64": (np.int64, torch.int64),
          "bfloat16": (np.uint16, torch.bfloat16), "uint8": (np.uint8, torch.uint8)}


def _rows(rng, dtype, t, d):
    """Random rows as their bits (numpy) and as the port's tensor."""
    bits_type, torch_dtype = DTYPES[dtype]
    if dtype == "bfloat16":  # finite values: JAX's CPU quiets a signalling NaN it copies
        scaled = rng.standard_normal((t, d)).astype(np.float32) * 1e3
        bits = (scaled.view(np.uint32) >> 16).astype(np.uint16)
    else:
        info = np.iinfo(bits_type)
        bits = rng.integers(info.min, info.max, size=(t, d), dtype=bits_type, endpoint=True)
    return bits, torch.from_numpy(bits).view(torch_dtype)


def _jax_gather(bits, idx, rpb):
    """The Pallas kernel on the same bytes: 8-byte rows go as pairs of int32
    (JAX keeps 32-bit integers on the CPU), bf16 bits as ``jnp.bfloat16``."""
    x = jnp.asarray(bits.view(np.int32) if bits.dtype == np.int64 else bits)
    if bits.dtype == np.uint16:
        x = x.view(jnp.bfloat16)
    out = jax_gather_rows(x, jnp.asarray(idx), rows_per_block=rpb, interpret=True)
    return np.asarray(out).tobytes()


@pytest.mark.parametrize("rpb", [1, 2, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_matches_pallas_at_every_width(dtype, rpb):
    rng = np.random.default_rng(len(dtype) * 10 + rpb)
    for d in WIDTHS:
        bits, x = _rows(rng, dtype, T, d)
        idx = rng.integers(0, T, size=N).astype(np.int32)
        got = gather_rows(x, torch.from_numpy(idx), rows_per_block=rpb)
        assert got.dtype == x.dtype and got.shape == (N, d)
        got_bytes = got.view(torch.uint8).numpy().tobytes()
        assert got_bytes == _jax_gather(bits, idx, rpb), d
        if rpb == 1:
            assert got_bytes == bits[idx].tobytes(), d


def test_gather_matches_pallas_on_the_partition_pattern():
    """The main path's indices: the stable argsort of uniform partition ids in
    [0, 64), 64 interleaved ascending streams, over (key, payload) int32 rows."""
    rng = np.random.default_rng(21)
    n = 4096
    parts = rng.integers(0, 64, size=n)
    idx = np.argsort(parts, kind="stable").astype(np.int32)
    streams = np.split(idx, np.cumsum(np.bincount(parts, minlength=64))[:-1])
    assert len(streams) == 64 and all((np.diff(s) > 0).all() for s in streams)
    bits, x = _rows(rng, "int32", n, 2)
    got = gather_rows(x, torch.from_numpy(idx))
    assert got.numpy().tobytes() == _jax_gather(bits, idx, 1)
    assert np.array_equal(got.numpy(), bits[idx])


def test_a_partial_last_block():
    """With ``len(x) % rows_per_block != 0`` the JAX package's interpreter
    pads x to whole blocks: a whole block reads x, the partial block at the
    end reads the interpreter's fill (int32's minimum) past it.  The port
    matches every gather of whole blocks bit for bit; an index into the
    partial block lies outside its range, and the plain version raises."""
    t, d, rpb = 10, 3, 4
    x = (np.arange(t * d, dtype=np.int32).reshape(t, d) + 100)
    idx = np.array([8, 9, 10, 11, 0, 1, 2, 3], dtype=np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(x), jnp.asarray(idx), rows_per_block=rpb,
                                      interpret=True))
    assert np.array_equal(want[:2], x[8:10]) and np.array_equal(want[4:], x[0:4])
    assert (want[2:4] == np.iinfo(np.int32).min).all()
    with pytest.raises(IndexError):
        gather_rows(torch.from_numpy(x), torch.from_numpy(idx), rows_per_block=rpb)
    whole = np.array([5, 6, 7, 4, 0, 1, 2, 3, 7, 4, 5, 6], dtype=np.int32)
    got = gather_rows(torch.from_numpy(x), torch.from_numpy(whole), rows_per_block=rpb)
    assert got.numpy().tobytes() == _jax_gather(x, whole, rpb)
    assert np.array_equal(got.numpy(), x[[4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7]])
    # rows_per_block = 1 takes any x.
    ids = idx % t
    assert np.array_equal(gather_rows(torch.from_numpy(x), torch.from_numpy(ids)).numpy(), x[ids])


@pytest.mark.parametrize("rpb,d,dtype,t", [(2, 1, torch.int32, 64), (8, 2, torch.int32, 64),
                                            (4, 3, torch.int16, 64), (8, 5, torch.uint8, 64),
                                            (8, 2, torch.int32, 69), (4, 3, torch.int16, 67)])
def test_block_view_is_the_blocked_gather(rpb, d, dtype, t):
    rng = np.random.default_rng(rpb * d + t)
    n = 32
    x = torch.from_numpy(rng.integers(0, 100, size=(t, d))).to(dtype)
    idx = torch.from_numpy(rng.integers(0, t - t % rpb, size=n).astype(np.int32))
    wide, blocks = block_view(x, idx, rpb)
    # A view of x's storage, one row a whole block; the block of each output
    # block.
    assert wide.data_ptr() == x.data_ptr() and wide.shape == (t // rpb, rpb * d)
    assert blocks.dtype == torch.int32 and blocks.is_contiguous()
    assert blocks.tolist() == [int(i) // rpb for i in idx[::rpb]]
    got = dispatch.gather_rows_plain(wide, blocks).view(n, d)
    assert torch.equal(got, dispatch.gather_rows_plain(x, idx, rpb))


def test_plan_routes():
    base = 1 << 20  # a 512-byte-aligned base address, as the allocator gives
    # The main path: (key, payload) rows narrowed to int32, 8 bytes.
    assert plan(8, base, base, base) == Plan("narrow", 8, 1)
    assert plan(4, base, base, base) == Plan("narrow", 4, 1)
    assert plan(16, base, base + 4, base) == Plan("narrow", 16, 1)
    # Indices the narrow route cannot load C at a time, x below the row's
    # alignment: the grouped route, one lane a unit.
    assert plan(4, base, base + 4, base) == Plan("grouped", 4, 1)
    assert plan(8, base, base + 4, base) == Plan("grouped", 8, 1)
    assert plan(8, base + 4, base, base) == Plan("grouped", 4, 2)
    # Wide rows: granite-moe-3b's d_model 1536 in bf16, 192 units of 16 bytes.
    assert plan(3072, base, base, base) == Plan("grouped", 16, 32)
    # chip_smoke's odd shapes: (4096, 3) int64, (1000, 5) int16, (777, 8)
    # float32, (513, 7) uint8; and a block of 8 main-path rows.
    assert plan(24, base, base, base) == Plan("grouped", 8, 4)
    assert plan(10, base, base, base) == Plan("grouped", 2, 8)
    assert plan(32, base, base, base) == Plan("grouped", 16, 2)
    assert plan(7, base, base, base) == Plan("grouped", 1, 8)
    assert plan(64, base, base, base) == Plan("grouped", 16, 4)


class _FakeLibrary:
    """Stands in for ``libgather_rows``: records each call with the indices it
    was handed (read while the call lasts) and returns ``error``."""

    def __init__(self, error=0):
        self.error = error
        self.calls = []

    def remop_gather_rows(self, *args):
        x, idx, out, n, row_bytes, route, unit, lanes, stream = args
        rows = list((ctypes.c_int32 * n).from_address(idx))
        self.calls.append((args, rows))
        return self.error

    def remop_gather_rows_error_string(self, err):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake_card(monkeypatch):
    """Makes the wrapper take its CUDA branch on CPU tensors, with a stand-in
    library."""
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    runtime.reset_launches()

    def install(lib):
        monkeypatch.setattr(runtime, "library", lambda name: lib)
        return lib

    yield install
    runtime.reset_launches()


def test_cuda_branch_launches_once_with_its_plan(fake_card):
    lib = fake_card(_FakeLibrary())
    x = torch.zeros((1 << 12, 2), dtype=torch.int32)
    idx = torch.randperm(1 << 12).to(torch.int32)
    out = gather_rows(x, idx)
    (args, rows), = lib.calls
    p = plan(8, x.data_ptr(), idx.data_ptr(), out.data_ptr())
    assert args[:8] == (x.data_ptr(), idx.data_ptr(), out.data_ptr(), 1 << 12, 8,
                        dispatch.ROUTES.index(p.route), p.unit, p.lanes)
    assert p.route == "narrow" and rows == idx.tolist()
    assert out.shape == (1 << 12, 2) and out.dtype == torch.int32
    assert dict(runtime.launches) == {"gather_rows": 1}


def test_cuda_branch_gathers_blocks_as_wide_rows(fake_card):
    lib = fake_card(_FakeLibrary())
    rpb, t, d = 8, 1 << 10, 2
    x = torch.zeros((t, d), dtype=torch.int32)
    idx = torch.randint(0, t, (256,), dtype=torch.int32)
    out = gather_rows(x, idx, rows_per_block=rpb)
    (args, rows), = lib.calls
    assert args[0] == x.data_ptr() and args[2] == out.data_ptr()
    assert args[3:5] == (256 // rpb, rpb * d * 4)  # 32 rows of 64 bytes
    assert args[5:8] == (dispatch.ROUTES.index("grouped"), 16, 4)
    assert rows == [int(i) // rpb for i in idx[::rpb]]
    assert out.shape == (256, d) and dict(runtime.launches) == {"gather_rows": 1}


def test_cuda_branch_gathers_the_whole_blocks_of_a_partial_x(fake_card):
    lib = fake_card(_FakeLibrary())
    rpb, t, d = 8, 100, 2  # 12 whole blocks and 4 rows past them
    x = torch.zeros((t, d), dtype=torch.int32)
    idx = torch.tensor([88, 89, 90, 91, 92, 93, 94, 95] * 2, dtype=torch.int32)
    out = gather_rows(x, idx, rows_per_block=rpb)
    (args, rows), = lib.calls
    assert args[0] == x.data_ptr() and args[3:5] == (2, rpb * d * 4)
    assert rows == [11, 11] and out.shape == (16, d)


def test_cuda_branch_raises_on_a_failed_launch(fake_card):
    lib = fake_card(_FakeLibrary(error=700))
    x = torch.zeros((100, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        gather_rows(x, torch.zeros(8, dtype=torch.int32))
    assert len(lib.calls) == 1 and sum(runtime.launches.values()) == 0

"""The merge-sort kernels' launch plan, its tile-by-tile emulation, and the
CUDA branch of the wrappers.

``plan`` decides how the stages of one ``sort_blocks`` or ``merge_pass`` call
are grouped into launches (passes over device memory) and which device index
each tile element loads and stores; the CUDA kernel follows it.
``run_plan_plain`` executes a plan tile by tile as the kernel does.  At tiles
of 2^4..2^6 elements the strided route and its reversed loads run on the
CPU, and the emulation is held bit for bit to the JAX package's Pallas
kernels (interpret mode) on tied int32 and float32 keys, signed zeros
included, with scrambled values.  The CUDA branch runs against a stand-in
library: no card is needed.
"""

import ast
import contextlib
import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.merge_sort.merge_sort import (
    merge_pass as jax_merge_pass,
    sort_blocks as jax_sort_blocks,
)

from repro_torch.kernels import runtime
from repro_torch.kernels.merge_sort import merge_sort as ms

CHUNKS = (1 << 4, 1 << 5, 1 << 6)


def _log2(x):
    return x.bit_length() - 1


def _cases(chunk):
    """(n, kind, arg) for every block and run the plan takes at this chunk,
    n up to 2^12, some n with few factors of two."""
    for n in (chunk, 6 * chunk, 1 << (2 * _log2(chunk)), 3 << 9):
        for e in range(0, 2 * _log2(chunk)):
            if n % (2 << e) == 0:
                yield n, "merge_pass", 1 << e
        for e in range(0, _log2(chunk) + 1):
            if n % (1 << e) == 0:
                yield n, "sort_blocks", 1 << e


def _stages(launch):
    if launch.sort_log2:
        return [(k, j) for k in range(1, launch.sort_log2 + 1) for j in range(k - 1, -1, -1)]
    return list(range(launch.j_hi, launch.j_lo - 1, -1))


@pytest.mark.parametrize("chunk", CHUNKS + (ms.MAX_BLOCK,))
def test_plan_passes_stages_and_tiles(chunk):
    cases = list(_cases(chunk)) if chunk in CHUNKS else [
        (1 << 22, "merge_pass", 1 << e) for e in range(22)] + [
        (1 << 22, "sort_blocks", 1 << e) for e in range(15)] + [(6, "merge_pass", 1)]
    for n, kind, arg in cases:
        launches = ms.plan(n, kind, arg, chunk)
        what = (n, kind, arg, chunk, launches)
        strided = kind == "merge_pass" and 2 * arg > chunk
        assert len(launches) == (2 if strided else 1), what
        assert [x.route for x in launches] == (["strided", "chunk"] if strided else ["chunk"]), what
        reversed_flags = [kind == "merge_pass"] + [False] * (len(launches) - 1)
        assert [x.reversed for x in launches] == reversed_flags, what
        if kind == "sort_blocks":
            m = _log2(arg)
            assert _stages(launches[0]) == [(k, j) for k in range(1, m + 1)
                                             for j in range(k - 1, -1, -1)], what
        else:
            # The ladder's stages top-1..0, each once, in order.
            ladder = list(range(_log2(2 * arg) - 1, -1, -1))
            assert sum((_stages(x) for x in launches), []) == ladder, what
        for x in launches:
            size = x.rows * x.width
            assert size <= chunk and n % size == 0, what
            bits = [ms.tile_bit(x, j) for j in range(x.j_lo, x.j_hi + 1)]
            if x.route == "strided":
                # The rows are the index bits of the stages at distance >= chunk.
                assert x.rows * x.width in (chunk, chunk // 2), what
                assert bits == list(range(_log2(x.width), _log2(size))), what
            else:
                assert x.rows == 1 and all(0 <= b < _log2(size) for b in bits), what
            if chunk in CHUNKS or n <= 1 << 16:
                load, store = ms.tile_maps(n, x)
                # Every index loaded and stored exactly once.
                assert torch.equal(load.reshape(-1).sort().values, torch.arange(n)), what
                assert torch.equal(store.reshape(-1).sort().values, torch.arange(n)), what


def test_plan_tiles_at_the_ladder_widths():
    """At n = 2^22 every merge past one tile is a strided pass of 2^(top-13)
    rows of W >= 16 contiguous columns (64-byte segments: two whole sectors),
    then a chunk pass, both on tiles of 2^13 (two CTAs an SM).  A block or a
    pair of runs of 2^14 takes the whole 2^14 tile."""
    for top in range(15, 23):
        strided, chunk = ms.plan(1 << 22, "merge_pass", 1 << (top - 1))
        assert (strided.rows, strided.width) == (1 << (top - 13), 1 << (26 - top))
        assert strided.width >= 16
        assert (strided.j_hi, strided.j_lo) == (top - 1, 13)
        assert chunk == ms.Launch("chunk", 12, 0, 1, 1 << 13, False)
    # Past 2^26 the strided rows no longer fit a half tile: whole tiles.
    assert ms.plan(1 << 28, "merge_pass", 1 << 26)[0][3:5] == (1 << 13, 2)
    assert ms.plan(1 << 22, "merge_pass", 1 << 13) == [
        ms.Launch("chunk", 13, 0, 1, 1 << 14, True)]
    assert ms.plan(1 << 22, "merge_pass", 1 << 12) == [
        ms.Launch("chunk", 12, 0, 1, 1 << 13, True)]
    assert ms.plan(1 << 22, "sort_blocks", 1 << 14)[0].width == 1 << 14
    assert ms.plan(1 << 22, "sort_blocks", 1 << 13)[0].width == 1 << 13
    with pytest.raises(ValueError, match="widest run"):
        ms.plan(1 << 29, "merge_pass", 1 << 28)


def test_strided_reversed_load_reads_the_mirrored_segment_backwards():
    n, chunk = 1 << 8, 16
    strided, _ = ms.plan(n, "merge_pass", 64, chunk)  # top 7: 8 rows of 2 columns
    assert (strided.rows, strided.width) == (8, 2)
    load, store = ms.tile_maps(n, strided)
    for tile in range(load.shape[0]):
        c0 = tile % 8 * 2
        rows = load[tile].reshape(8, 2) % 128
        assert rows[:4].tolist() == [[r * 16 + c0, r * 16 + c0 + 1] for r in range(4)]
        # Second run: rows 7..4 of the span, columns [16 - c0 - 2, 16 - c0) backwards.
        assert rows[4:].tolist() == [[r * 16 + 15 - c0, r * 16 + 14 - c0] for r in (7, 6, 5, 4)]


def _keys(rng, n, dtype):
    """Keys from a small range (most have equal partners); float keys hold
    -0.0 and +0.0 beside each other."""
    k = rng.integers(-4, 5, size=n)
    if dtype == "int32":
        return k.astype(np.int32)
    k = k.astype(np.float32)
    zero = rng.random(n) < 0.3
    k[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    return k


def _assert_bits(want, got, what):
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, what
        assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_emulation_matches_pallas_bit_for_bit(chunk, dtype):
    rng = np.random.default_rng(chunk + (dtype == "float32"))
    strided = 0
    unstable = {"merge_pass": 0, "sort_blocks": 0}
    for n, kind, arg in _cases(chunk):
        if n > 1 << 10 and arg < chunk:
            continue  # the same tiles as at n <= 2^10; keeps the test short
        keys = _keys(rng, n, dtype)
        values = rng.permutation(n).astype(np.int32)
        if kind == "merge_pass":
            keys = np.sort(keys.reshape(-1, arg), axis=1).reshape(-1)
            want = jax_merge_pass(jnp.asarray(keys), jnp.asarray(values), arg, interpret=True)
            strided += 2 * arg > chunk
        else:
            want = jax_sort_blocks(jnp.asarray(keys), jnp.asarray(values), arg, interpret=True)
        k, v = torch.from_numpy(keys), torch.from_numpy(values)
        launches = ms.plan(n, kind, arg, chunk)
        got = ms.run_plan_plain(k, v, launches)
        _assert_bits(want, got, (n, kind, arg, launches))
        # The wrappers' CPU route (the plain versions) gives the same bits.
        wrapper = ms.merge_pass if kind == "merge_pass" else ms.sort_blocks
        _assert_bits(want, wrapper(k, v, arg), (n, kind, arg, "plain"))
        # Ties decide where values go: count the calls where a stable sort of
        # each span would place them elsewhere.
        span = 2 * arg if kind == "merge_pass" else arg
        stable = torch.sort(k.view(-1, span), dim=1, stable=True).indices
        stable_v = v.view(-1, span).gather(1, stable).reshape(-1)
        unstable[kind] += not torch.equal(stable_v, got[1])
    assert strided > 0
    assert min(unstable.values()) > 0, unstable


def test_plain_keys_take_jax_signed_zeros():
    """``torch.minimum(+0.0, -0.0)`` is +0.0 on the CPU; the JAX package's
    ``jnp.minimum`` gives -0.0, and so must every route of the port."""
    keys = np.array([0.0, -0.0, -0.0, 0.0], dtype=np.float32)
    values = np.arange(4, dtype=np.int32)
    want = jax_merge_pass(jnp.asarray(keys), jnp.asarray(values), 1, interpret=True)
    got = ms.merge_pass(torch.from_numpy(keys), torch.from_numpy(values), 1)
    _assert_bits(want, got, "merge")
    assert np.signbit(got[0].numpy()).tolist() == [True, False, True, False]
    assert got[1].tolist() == [0, 1, 2, 3]  # values keep their order: a <= b


class _FakeLibrary:
    """Stands in for ``libmerge_sort``: records each call with the plan it was
    given (read from the array while the call lasts) and returns ``error``."""

    def __init__(self, error=0):
        self.error = error
        self.calls = []

    def _record(self, name, args):
        keys, values, keys_out, values_out, n, plan, launches, stream = args
        fields = (ctypes.c_int * (ms.PLAN_FIELDS * launches)).from_address(plan)
        rows = [tuple(fields[i * ms.PLAN_FIELDS:(i + 1) * ms.PLAN_FIELDS]) for i in range(launches)]
        self.calls.append((name, args, rows))
        return self.error

    def __getattr__(self, name):
        if name.startswith("remop_") and name.endswith(("_i32", "_f32")):
            return lambda *args: self._record(name, args)
        if name == "remop_merge_sort_error_string":
            return lambda err: b"an illegal memory access was encountered"
        raise AttributeError(name)


@pytest.fixture
def fake_card(monkeypatch):
    """Makes the wrappers take their CUDA branch on CPU tensors, with a
    stand-in library."""
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    runtime.reset_launches()

    def install(lib):
        monkeypatch.setattr(runtime, "library", lambda name: lib)
        return lib

    yield install
    runtime.reset_launches()


def _rows(launches):
    return [(ms.ROUTES.index(x.route), x.j_hi, x.j_lo, x.rows, x.width, int(x.reversed),
             x.sort_log2) for x in launches]


@pytest.mark.parametrize("kind,arg,dtype", [
    ("merge_pass", 1 << 21, torch.int32),    # the widest pass of a 2^22 sort: strided + chunk
    ("merge_pass", 1 << 13, torch.float32),  # one tile
    ("merge_pass", 1, torch.int32),
    ("sort_blocks", 1 << 14, torch.float32),
    ("sort_blocks", 2, torch.int32),
])
def test_cuda_calls_reach_the_entry_point_with_the_plan(fake_card, kind, arg, dtype):
    lib = fake_card(_FakeLibrary())
    n = 1 << 22
    keys, values = torch.zeros(n, dtype=dtype), torch.zeros(n, dtype=torch.int32)
    wrapper = ms.merge_pass if kind == "merge_pass" else ms.sort_blocks
    out_k, out_v = wrapper(keys, values, arg)
    (name, args, rows), = lib.calls
    assert name == f"remop_{kind}_{ms.KEY_DTYPES[dtype]}"
    assert args[:5] == (keys.data_ptr(), values.data_ptr(), out_k.data_ptr(), out_v.data_ptr(), n)
    assert out_k.dtype == dtype and out_v.dtype == torch.int32 and out_k.shape == (n,)
    assert rows == _rows(ms.plan(n, kind, arg)) and args[6] == len(rows)
    assert len(rows) == (2 if kind == "merge_pass" and 2 * arg > ms.MAX_BLOCK else 1)
    assert dict(runtime.launches) == {kind: 1}
    wrapper(keys, values, arg)
    assert len(lib.calls) == 2 and dict(runtime.launches) == {kind: 2}


@pytest.mark.parametrize("kind", ["merge_pass", "sort_blocks"])
def test_a_failed_launch_raises_and_never_reroutes(fake_card, kind):
    lib = fake_card(_FakeLibrary(error=700))
    keys = torch.zeros(1 << 16, dtype=torch.int32)
    wrapper = ms.merge_pass if kind == "merge_pass" else ms.sort_blocks
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wrapper(keys, keys.clone(), 1 << 14)
    assert len(lib.calls) == 1
    assert sum(runtime.launches.values()) == 0


def test_cuda_branch_refuses_what_the_kernel_cannot_hold(fake_card):
    lib = fake_card(_FakeLibrary())
    keys = torch.zeros(1 << 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        ms.sort_blocks(keys, keys.clone(), 1 << 15)
    assert lib.calls == [] and sum(runtime.launches.values()) == 0


PROBES = sorted(Path(__file__).resolve().parents[1].glob("*_probe.py"))


@pytest.mark.parametrize("path", PROBES, ids=lambda p: p.name)
def test_probes_import_nothing_of_jax_or_the_jax_package(path):
    """The card probes run where there is no JAX: they import ``repro_torch``
    and ``chip_smoke``, never ``jax`` or ``repro``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        blocked = [x for x in names if x.split(".")[0] in ("jax", "repro")]
        assert not blocked, (path.name, node.lineno, blocked)


def test_every_probe_is_checked():
    assert {"sort_probe.py", "paged_probe.py", "flash_probe.py", "matmul_probe.py"} <= {
        p.name for p in PROBES}

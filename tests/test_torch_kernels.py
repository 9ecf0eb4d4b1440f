"""The port's kernels against the JAX package's Pallas kernels, bit for bit.

Each test makes its inputs with numpy from a seed and hands the same arrays
to the JAX function (Pallas in interpret mode, as ``tests/test_kernels.py``
runs it on the CPU) and to the port's wrapper on CPU tensors, which takes
the kernel's plain PyTorch version.  Keys and values must agree exactly,
including the order of values under equal keys: both run one network.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dispatch.dispatch import gather_rows as jax_gather_rows
from repro.kernels.merge_sort.merge_sort import (
    merge_pass as jax_merge_pass,
    sort_blocks as jax_sort_blocks,
)
from repro.kernels.merge_sort.ops import (
    argsort_by_key as jax_argsort_by_key,
    remop_sort as jax_remop_sort,
)

from repro_torch.kernels import runtime
from repro_torch.kernels.dispatch.dispatch import gather_rows
from repro_torch.kernels.merge_sort.merge_sort import merge_pass, sort_blocks
from repro_torch.kernels.merge_sort.ops import argsort_by_key, remop_sort
from repro_torch.remote import make_backend

NP_DTYPES = {"int32": np.int32, "float32": np.float32}


def _tied_keys(rng, n, dtype):
    """Keys from a small range, so most keys have equal partners."""
    return rng.integers(0, max(2, n // 8), size=n).astype(NP_DTYPES[dtype])


def _assert_same(jax_out, torch_out):
    for a, b in zip(jax_out, torch_out):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", sorted(NP_DTYPES))
@pytest.mark.parametrize("block", [2, 8, 64, 256])
def test_sort_blocks_matches_pallas_with_ties(block, dtype):
    rng = np.random.default_rng(block)
    keys = _tied_keys(rng, 512, dtype)
    values = np.arange(512, dtype=np.int32)
    want = jax_sort_blocks(jnp.asarray(keys), jnp.asarray(values), block,
                           interpret=True)
    got = sort_blocks(torch.from_numpy(keys), torch.from_numpy(values), block)
    _assert_same(want, got)


@pytest.mark.parametrize("dtype", sorted(NP_DTYPES))
@pytest.mark.parametrize("run", [1, 4, 32, 128])
def test_merge_pass_matches_pallas_with_ties(run, dtype):
    rng = np.random.default_rng(run)
    # Sorted runs of length `run` with ties inside and across runs; values
    # scrambled so the order under equal keys is visible.
    keys = np.sort(_tied_keys(rng, 512, dtype).reshape(-1, run), axis=1).reshape(-1)
    values = rng.permutation(512).astype(np.int32)
    want = jax_merge_pass(jnp.asarray(keys), jnp.asarray(values), run,
                          interpret=True)
    got = merge_pass(torch.from_numpy(keys), torch.from_numpy(values), run)
    _assert_same(want, got)


@pytest.mark.parametrize("n", [64, 100, 1000, 4096])
@pytest.mark.parametrize("dtype", sorted(NP_DTYPES))
def test_remop_sort_matches_pallas(n, dtype):
    rng = np.random.default_rng(n)
    if dtype == "int32":
        keys = rng.integers(-(1 << 20), 1 << 20, size=n).astype(np.int32)
    else:
        keys = rng.standard_normal(n).astype(np.float32)
    keys[: n // 4] = keys[n // 2: n // 2 + n // 4]  # ties
    want = jax_remop_sort(jnp.asarray(keys), run_items=256)
    got = remop_sort(torch.from_numpy(keys), run_items=256)
    _assert_same(want, got)
    np.testing.assert_array_equal(got[0].numpy(), np.sort(keys))


def test_remop_sort_default_run_matches_pallas():
    # The JAX default run is min(2^14, next_pow2(n)) for every n; so is ours.
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 50, size=700).astype(np.int32)
    _assert_same(jax_remop_sort(jnp.asarray(keys)), remop_sort(torch.from_numpy(keys)))


def test_sort_carries_values():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 1 << 10, size=300).astype(np.int32)
    vals = np.arange(300, dtype=np.int32)
    ks, vs = remop_sort(torch.from_numpy(keys), torch.from_numpy(vals), run_items=64)
    np.testing.assert_array_equal(keys[vs.numpy()], ks.numpy())
    _assert_same(jax_remop_sort(jnp.asarray(keys), jnp.asarray(vals), run_items=64),
                 (ks, vs))


# -- argsort_by_key: mirrors tests/test_kernels.py ---------------------------


def test_argsort_stable_matches_pallas():
    keys = np.random.default_rng(7).integers(0, 8, size=512).astype(np.int32)
    got = argsort_by_key(torch.from_numpy(keys), max_key=7)
    want = jax_argsort_by_key(jnp.asarray(keys), max_key=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.argsort(keys, kind="stable"))


def test_argsort_small_dtype_needs_no_max_key():
    # int16 keys bound the composite statically: iinfo.max * n + n < 2^31.
    keys = np.random.default_rng(17).integers(0, 1 << 14, size=256).astype(np.int16)
    got = argsort_by_key(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_argsort_by_key(jnp.asarray(keys))))
    np.testing.assert_array_equal(got.numpy(), np.argsort(keys, kind="stable"))


def test_argsort_overflow_guard_raises():
    n = 1 << 12
    keys = torch.full((n,), 1 << 20, dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows int32"):
        argsort_by_key(keys)  # dtype bound: iinfo(int32).max * n overflows
    with pytest.raises(ValueError, match="overflows int32"):
        argsort_by_key(keys, max_key=1 << 20)  # honest bound still overflows
    with pytest.raises(ValueError, match="max_key must be >= 0"):
        argsort_by_key(keys, max_key=-1)
    with pytest.raises(ValueError, match="needs integer keys"):
        argsort_by_key(keys.float())


def test_argsort_max_key_boundary_is_exact():
    # Largest admissible bound for this n: (max_key + 1) * n == 2^31 - n.
    n = 512
    max_key = (2**31 - n) // n - 1
    keys = np.random.default_rng(23).integers(0, max_key + 1, size=n).astype(np.int32)
    got = argsort_by_key(torch.from_numpy(keys), max_key=max_key)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_argsort_by_key(jnp.asarray(keys), max_key=max_key)))
    np.testing.assert_array_equal(got.numpy(), np.argsort(keys, kind="stable"))
    with pytest.raises(ValueError, match="overflows int32"):
        argsort_by_key(torch.from_numpy(keys), max_key=max_key + 1)


# -- gather_rows --------------------------------------------------------------


@pytest.mark.parametrize("rows_per_block", [1, 4])
def test_gather_rows_matches_pallas(rows_per_block):
    rng = np.random.default_rng(9 + rows_per_block)
    x = rng.integers(-1000, 1000, size=(64, 3)).astype(np.int32)
    if rows_per_block == 1:
        idx = rng.integers(0, 64, size=40).astype(np.int32)
    else:
        # Contiguous index runs, as the sorted-dispatch contract asks.
        starts = rng.integers(0, 64 // rows_per_block, size=10) * rows_per_block
        idx = (starts[:, None] + np.arange(rows_per_block)).reshape(-1).astype(np.int32)
    want = jax_gather_rows(jnp.asarray(x), jnp.asarray(idx),
                           rows_per_block=rows_per_block, interpret=True)
    got = gather_rows(torch.from_numpy(x), torch.from_numpy(idx),
                      rows_per_block=rows_per_block)
    _assert_same([want], [got])
    np.testing.assert_array_equal(got.numpy(), x[idx])


# -- dispatch on the tensor's device ------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    runtime.reset_launches()
    keys = torch.from_numpy(np.random.default_rng(1).integers(0, 9, 100).astype(np.int32))
    _, order = remop_sort(keys)
    argsort_by_key(keys, max_key=8)
    gather_rows(torch.arange(200, dtype=torch.int32).reshape(100, 2), order)
    assert sum(runtime.launches.values()) == 0


def test_wrappers_check_their_inputs():
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 or float32"):
        sort_blocks(keys.long(), keys, 8)
    with pytest.raises(ValueError, match="power of two"):
        sort_blocks(keys, keys, 3)
    with pytest.raises(ValueError, match="power of two"):
        merge_pass(keys, keys, 8)
    with pytest.raises(TypeError, match="1-D int32"):
        gather_rows(keys.reshape(4, 2), keys.long())
    with pytest.raises(ValueError, match="different devices"):
        runtime.on_cpu(keys, keys.to("meta"))


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend("tcp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend("tcp", device="cuda")
    assert make_backend("tcp", device="cpu").device == torch.device("cpu")
    assert runtime.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("edit", ["header", "other source", "nothing"])
def test_library_path_covers_the_headers(monkeypatch, tmp_path, edit):
    """A built library is keyed by its source, every csrc/*.cuh header and
    the flags: editing a header rebuilds every library, editing another
    source leaves this one as it is."""
    for f in runtime.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(runtime, "CSRC", tmp_path)
    before = runtime.library_path("matmul")
    assert (tmp_path / "hopper.cuh").exists()
    target = {"header": "hopper.cuh", "other source": "paged_attention.cu",
              "nothing": None}[edit]
    if target:
        path = tmp_path / target
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
    after = runtime.library_path("matmul")
    assert (after != before) == (edit == "header")
    assert after.parent == runtime.BUILD_DIR and after.name.startswith("libmatmul-")

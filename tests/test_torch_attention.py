"""The port's attention kernels against the JAX package's Pallas kernels.

Each test makes its inputs with numpy from a seed and hands the same arrays
to the JAX function (Pallas in interpret mode, as ``tests/test_kernels.py``
runs it on the CPU) and to the port's entry point on CPU tensors, which
takes the kernel's plain PyTorch version (the same online softmax over the
same blocks or pages).  Tolerances are the JAX tests': 2e-5 in f32 and
3e-2 in bf16 (``tests/test_kernels.py``).  bf16 inputs are the f32 arrays
rounded to bf16 on each side, which both frameworks do to nearest-even.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import remop_flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.paged_attention.ops import remop_paged_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, MAX_BLOCK, TC_HEAD_DIMS, flash_attention, route, smem_bytes,
)
from repro_torch.kernels.flash_attention.ops import (
    BLOCK_CANDIDATES, HOPPER_SMEM_BYTES, default_route, plan_blocks, remop_flash_attention,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.ops import remop_paged_attention
from repro_torch.kernels.paged_attention.paged_attention import (
    check_shape, paged_attention, paged_attention_plain,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _pair(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(torch_out, jax_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(), np.asarray(jax_out, np.float32),
                               rtol=tol, atol=tol)


def _qkv(seed, b, h, kv, s, t, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, hd), (b, kv, t, hd), (b, kv, t, hd))]


def _paged_inputs(seed, b, kv, g, hd, s):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, kv, g, hd), (b, s, kv, hd), (b, s, kv, hd))]
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    return arrays, lengths


# -- flash attention ------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    (1, 2, 1, 64, 64, 32, 16, 16),    # MQA
    (2, 4, 2, 128, 128, 32, 32, 64),  # GQA, rectangular blocks
    (1, 2, 2, 64, 256, 16, 32, 32),   # q shorter than kv (suffix prefill)
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_matches_pallas(cfg, dtype):
    b, h, kv, s, t, hd, bq, bk = cfg
    (jq, jk, jv), (q, k, v) = _pair(_qkv(s + t, b, h, kv, s, t, hd), dtype)
    want = jax_flash(jq, jk, jv, bq=bq, bk=bk)
    got = remop_flash_attention(q, k, v, bq=bq, bk=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("shape", [
    (1, 8, 1, 77, 77, 32),     # MQA, S = T not a block multiple
    (2, 4, 2, 50, 131, 16),    # GQA, ragged suffix prefill
    (1, 2, 2, 1, 65, 64),      # one query row over a ragged cache
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_ragged_lengths_match_ref(shape, dtype):
    arrays = _qkv(sum(shape), *shape)
    (jq, jk, jv), (q, k, v) = _pair(arrays, dtype)
    want = jax_flash_ref(jq, jk, jv)
    tol = DTYPES[dtype][2]
    _close(remop_flash_attention(q, k, v), want, tol)
    _close(flash_attention_ref(q, k, v), want, tol)


def test_flash_attention_block_size_invariance():
    # The CUDA-core route (f32): any bq, bk in [1, 64].
    (jq, jk, jv), (q, k, v) = _pair(_qkv(0, 1, 2, 2, 128, 128, 32), "float32")
    assert route(q, k, v) == "simt"
    want = jax_flash(jq, jk, jv, bq=128, bk=128)
    for bq, bk in ((16, 16), (32, 64), (64, 64), (64, 24), (7, 50)):
        _close(flash_attention(q, k, v, bq=bq, bk=bk), want, 2e-5)
    for bq, bk in ((16, 16), (32, 64)):
        _close(flash_attention(q, k, v, bq=bq, bk=bk), jax_flash(jq, jk, jv, bq=bq, bk=bk), 2e-5)
    # The tensor-core route (bf16, hd 64): bq, bk in wgmma's 64 rows.
    (jq, jk, jv), (q, k, v) = _pair(_qkv(1, 1, 2, 2, 256, 256, 64), "bfloat16")
    assert route(q, k, v) == "tc"
    for bq, bk in ((64, 64), (64, 128), (128, 64), (128, 128)):
        _close(flash_attention(q, k, v, bq=bq, bk=bk), jax_flash(jq, jk, jv, bq=bq, bk=bk),
               DTYPES["bfloat16"][2])


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_plan_blocks_fits_hopper_shared_memory(hd, dtype_bytes):
    # bf16 at hd 64 / 128 / 256 plans for the tensor-core route, the rest for
    # the CUDA-core route; each within its own working set.
    path = default_route(hd, dtype_bytes)
    assert path == ("tc" if dtype_bytes == 2 and hd in TC_HEAD_DIMS else "simt")
    cands = BLOCK_CANDIDATES[path]
    for s, t in ((32768, 32768), (2048, 2048), (777, 777), (1, 4096), (16, 16)):
        bq, bk = plan_blocks(s, t, hd, dtype_bytes)
        assert bq in cands and bk in cands
        assert smem_bytes(bq, bk, hd, dtype_bytes, path) <= HOPPER_SMEM_BYTES == 232_448
    # Long sequences take the largest blocks that fit: fewest staging rounds.
    fits = [(bq, bk) for bq in cands for bk in cands
            if smem_bytes(bq, bk, hd, dtype_bytes, path) <= HOPPER_SMEM_BYTES]
    assert plan_blocks(2048, 2048, hd, dtype_bytes) == max(fits, key=lambda x: (x[0] * x[1], x))
    if path == "simt":
        assert plan_blocks(2048, 2048, hd, dtype_bytes) == (MAX_BLOCK, MAX_BLOCK)
    # A tight budget trades block size for fit; nothing fits -> smallest.
    lo = cands[0] if path == "tc" else 32
    small = smem_bytes(lo, lo, hd, dtype_bytes, path)
    bq, bk = plan_blocks(2048, 2048, hd, dtype_bytes, smem_budget=small)
    assert smem_bytes(bq, bk, hd, dtype_bytes, path) <= small and bq * bk == lo * lo
    assert plan_blocks(2048, 2048, hd, dtype_bytes, smem_budget=1) == (cands[0], cands[0])


def test_flash_attention_checks_its_inputs():
    q, k = torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="more queries"):
        flash_attention(q, k[:, :, :4], k[:, :, :4])
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q.double(), k.double(), k.double())


# -- paged attention --------------------------------------------------------------


@pytest.mark.parametrize("b,kv,g,hd,s,page", [
    (2, 1, 4, 32, 256, 64),
    (1, 2, 2, 64, 128, 32),
    (3, 4, 1, 16, 512, 128),
])
def test_paged_attention_matches_pallas(b, kv, g, hd, s, page):
    arrays, lengths = _paged_inputs(b * 1000 + s, b, kv, g, hd, s)
    (jq, jk, jv), (q, kc, vc) = _pair(arrays, "float32")
    want = jax_paged(jq, jk, jv, jnp.asarray(lengths), page=page)
    got = remop_paged_attention(q, kc, vc, torch.from_numpy(lengths), page=page)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_attention_dtypes_match_pallas(dtype):
    b, kv, g, hd, s = 2, 2, 2, 32, 256
    arrays, _ = _paged_inputs(42, b, kv, g, hd, s)
    lengths = np.array([s, s // 2], np.int32)
    (jq, jk, jv), (q, kc, vc) = _pair(arrays, dtype)
    want = jax_paged(jq, jk, jv, jnp.asarray(lengths), page=64)
    got = remop_paged_attention(q, kc, vc, torch.from_numpy(lengths), page=64)
    assert got.dtype == q.dtype
    _close(got, want, DTYPES[dtype][2])
    _close(paged_attention_ref(q, kc, vc, torch.from_numpy(lengths)),
           jax_paged_ref(jq, jk, jv, jnp.asarray(lengths)), DTYPES[dtype][2])


def test_paged_attention_page_size_invariance():
    arrays, _ = _paged_inputs(5, 1, 1, 4, 32, 512)
    lengths = np.array([300], np.int32)
    (jq, jk, jv), (q, kc, vc) = _pair(arrays, "float32")
    ln = torch.from_numpy(lengths)
    for page in (32, 64, 128, 256):
        want = jax_paged(jq, jk, jv, jnp.asarray(lengths), page=page)
        _close(remop_paged_attention(q, kc, vc, ln, page=page), want, 2e-5)
    # Pages that do not divide S: the entry point pads, as JAX's does.
    want = jax_paged(jq, jk, jv, jnp.asarray(lengths), page=32)
    for page in (48, 100, 512):
        _close(remop_paged_attention(q, kc, vc, ln, page=page), want, 2e-5)


def test_paged_attention_checks_its_inputs():
    q, kc = torch.zeros(2, 1, 4, 16), torch.zeros(2, 64, 1, 16)
    ln = torch.tensor([1, 64], dtype=torch.int32)
    with pytest.raises(ValueError, match="must divide"):
        paged_attention(q, kc, kc, ln, page=48)
    with pytest.raises(TypeError, match="int32"):
        paged_attention(q, kc, kc, ln.long(), page=32)
    with pytest.raises(ValueError, match="do not fit"):
        paged_attention(q, kc[:, :, :, :8], kc[:, :, :, :8], ln, page=32)


def test_cpu_tensors_take_the_plain_versions():
    runtime.reset_launches()
    (_, (q, k, v)) = _pair(_qkv(1, 1, 2, 1, 16, 16, 16), "float32")
    remop_flash_attention(q, k, v)
    remop_paged_attention(q.reshape(1, 1, 2, 256), k.reshape(1, 16, 1, 16).repeat(1, 1, 1, 16),
                          k.reshape(1, 16, 1, 16).repeat(1, 1, 1, 16),
                          torch.tensor([5], dtype=torch.int32))
    assert sum(runtime.launches.values()) == 0


def test_paged_attention_plain_at_granite_group_matches_pallas():
    """granite-20b's decode group: 48 query heads on one KV head of 128."""
    b, kv, g, hd, s = 2, 1, 48, 128, 256
    arrays, _ = _paged_inputs(48, b, kv, g, hd, s)
    lengths = np.array([77, 200], np.int32)  # ragged: the last page masked part-way
    (jq, jk, jv), (q, kc, vc) = _pair(arrays, "float32")
    want = jax_paged(jq, jk, jv, jnp.asarray(lengths), page=64)
    _close(paged_attention_plain(q, kc, vc, torch.from_numpy(lengths), page=64), want, 2e-5)
    _close(remop_paged_attention(q, kc, vc, torch.from_numpy(lengths), page=64), want, 2e-5)


@pytest.mark.parametrize("g,hd,ok", [(48, 128, True), (8, 256, True), (10, 256, True),
                                     (1, 16, True), (0, 128, False), (48, 192, False)])
def test_paged_check_shape_takes_any_group(g, hd, ok):
    if ok:
        check_shape(g, hd)
    else:
        with pytest.raises(ValueError):
            check_shape(g, hd)

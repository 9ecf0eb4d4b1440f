"""The port's blocked matmul against the JAX package's.

Inputs are made with numpy from a seed and handed to ``repro``'s functions
(Pallas in interpret mode, as ``tests/test_kernels.py`` runs them on the
CPU) and to the port's on CPU tensors, which take the kernel's plain PyTorch
version.  The two packages plan under different figures (the TPU's and the
H100's), so ``remop_matmul`` runs other tiles in each and only the order of
the f32 sums differs: f32 is held to the JAX tests' 1e-5; bf16 inputs (exact
products, f32 sums, bf16 or f32 out) to 1e-2, inside the JAX tests' 3e-2.
At the JAX tests' explicit tiles the plain version runs the same K steps as
``matmul_pallas``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.matmul import matmul_pallas as jax_matmul_pallas
from repro.kernels.matmul.ops import plan_for as jax_plan_for
from repro.kernels.matmul.ops import remop_matmul as jax_remop_matmul
from repro.kernels.matmul.ref import matmul_ref as jax_matmul_ref

from repro_torch.kernels import runtime
from repro_torch.core.planner import matmul_vmem
from repro_torch.kernels.matmul.matmul import (
    MAX_ACC,
    MAX_ACC_REGS,
    MAX_BN,
    MMA_N,
    RING_STAGES,
    SMEM_BYTES,
    THREADS,
    check_tiles,
    f32_sub,
    matmul_tiled,
    matmul_tiled_plain,
    ring_bytes,
    ring_slot_bytes,
    ring_sub,
)
from repro_torch.kernels.matmul.ops import clamped_tiles, plan_for, remop_matmul
from repro_torch.kernels.matmul.ref import matmul_ref

MM_SHAPES = [(64, 64, 64), (128, 256, 64), (200, 130, 70), (33, 257, 129)]  # (m, k, n)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
POLICIES = ["remop", "conventional", "closed-form"]
EXPLICIT_TILES = [(16, 16, 16), (32, 64, 16), (64, 32, 32)]


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", MM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_remop_matmul_matches_repro(shape, dtype, policy):
    m, k, n = shape
    a, b = _inputs(m, k, n, seed=m + k + n)
    tdt, jdt = DTYPES[dtype]
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    want = jax_remop_matmul(ja, jb, policy=policy, interpret=True, out_dtype=jnp.float32)
    if dtype == "float32" and policy != "conventional":
        # Under the H100's figures no f32 tile fits half a CTA's shared
        # memory double-buffered: the planner asserts, as repro's would.
        with pytest.raises(AssertionError, match="no feasible tile"):
            remop_matmul(ta, tb, policy=policy, out_dtype=torch.float32)
        # The port's wrapper at the tiles repro planned, clamped and padded
        # as remop_matmul does, against repro's result.
        jp = jax_plan_for((m, k), (k, n), jdt, policy)
        bm, bn, bk = min(jp.bm, m), min(jp.bn, n), min(jp.bk, k)
        ap = torch.nn.functional.pad(ta, (0, (-k) % bk, 0, (-m) % bm))
        bp = torch.nn.functional.pad(tb, (0, (-n) % bn, 0, (-k) % bk))
        got = matmul_tiled(ap, bp, bm, bn, bk, out_dtype=torch.float32)[:m, :n]
    else:
        got = remop_matmul(ta, tb, policy=policy, out_dtype=torch.float32)
        check_tiles(*clamped_tiles(plan_for((m, k), (k, n), tdt, policy), m, n, k),
                    ta.element_size())
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_remop_matmul_default_out_dtype_is_input_dtype(dtype):
    tdt, jdt = DTYPES[dtype]
    a, b = _inputs(200, 130, 70, seed=7)
    want = jax_remop_matmul(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
                            policy="conventional", interpret=True)
    got = remop_matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
                       policy="conventional")
    assert got.dtype == tdt and str(np.asarray(want).dtype) == dtype
    # One output ulp (2^-7 in bf16) plus the f32 sums' order.
    _close(got, np.asarray(want.astype(jnp.float32)), 2.0 ** -7 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tiles", EXPLICIT_TILES, ids=lambda t: "x".join(map(str, t)))
def test_plain_matches_matmul_pallas_at_explicit_tiles(tiles, dtype):
    bm, bn, bk = tiles
    a, b = _inputs(128, 64, 128, seed=bm * bn * bk)
    tdt, jdt = DTYPES[dtype]
    want = jax_matmul_pallas(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
                             bm, bn, bk, out_dtype=jnp.float32, interpret=True)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    _close(matmul_tiled_plain(ta, tb, bm, bn, bk, out_dtype=torch.float32), want, 1e-5)
    # On CPU tensors the wrapper takes the plain version.
    assert torch.equal(matmul_tiled(ta, tb, bm, bn, bk, out_dtype=torch.float32),
                       matmul_tiled_plain(ta, tb, bm, bn, bk, out_dtype=torch.float32))
    check_tiles(bm, bn, bk, ta.element_size())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_ref_matches_repro(dtype):
    tdt, jdt = DTYPES[dtype]
    a, b = _inputs(33, 257, 129, seed=3)
    want = jax_matmul_ref(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
                          out_dtype=jnp.float32)
    got = matmul_ref(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
                     out_dtype=torch.float32)
    _close(got, want, 1e-5)
    assert matmul_ref(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)).dtype == tdt


@pytest.mark.parametrize("tiles", [(24, 16, 16), (16, 48, 16), (16, 16, 48), (0, 16, 16)])
def test_non_dividing_tile_raises(tiles):
    a = torch.zeros(64, 64)
    b = torch.zeros(64, 32)
    with pytest.raises(ValueError, match="divide"):
        matmul_tiled(a, b, *tiles)
    with pytest.raises(ValueError, match="divide"):
        matmul_tiled_plain(a, b, *tiles)


def test_bad_shapes_and_dtypes_raise():
    with pytest.raises(ValueError, match=r"\[M,K\]"):
        matmul_tiled(torch.zeros(8, 16), torch.zeros(8, 16), 8, 8, 8)
    with pytest.raises(TypeError):
        matmul_tiled(torch.zeros(8, 8), torch.zeros(8, 8, dtype=torch.bfloat16), 8, 8, 8)
    with pytest.raises(TypeError):
        matmul_tiled(torch.zeros(8, 8), torch.zeros(8, 8), 8, 8, 8, out_dtype=torch.int32)


@pytest.mark.parametrize("tiles,elem", [
    ((8, 512, 16), 2),     # bn above the tensor-core kernel's 4 warpgroups of 64 columns
    ((264, 128, 16), 2),   # bm above wgmma's largest N, 256
    ((256, 256, 64), 2),   # 256 accumulator columns on 4 warpgroups: 128 f32 registers x 512
    ((72, 128, 16), 4),    # f32: 36 accumulators a thread
])
def test_check_tiles_rejects_what_the_kernel_cannot_take(tiles, elem):
    with pytest.raises(ValueError):
        check_tiles(*tiles, elem)


def test_check_tiles_limits():
    assert THREADS == 256 and MAX_ACC == 32 and SMEM_BYTES == 232_448
    assert MAX_BN == 256 and MAX_ACC_REGS == 512 and MMA_N[0] == 8 and MMA_N[-1] == 256
    check_tiles(24, 128, 128, 2)   # the REMOP bf16 plan
    check_tiles(8, 128, 512, 2)    # the conventional bf16 plan: its step split in two
    check_tiles(8, 128, 512, 4)    # the conventional f32 plan: 278,528 bytes, in sub-steps
    check_tiles(128, 256, 64, 2)   # the tile probe: 4 warpgroups of 64 accumulators
    check_tiles(256, 128, 1, 2)    # 2 warpgroups of 128 accumulators
    check_tiles(1, 256, 1, 4)
    check_tiles(48, 70, 130, 2)    # bn = 70: 2 warpgroups, bk = 130: element route
    check_tiles(64, 128, 128, 4)   # f32: 32 accumulators a thread


# Every tile the port's entry points give the bf16 kernel (the five products
# of chip_smoke.py under both plans, the tile probes, the JAX tests' explicit
# tiles) with the K depth of a ring slot on its route and the shared memory
# the ring asks for: two slots, 1024 bytes of alignment, four mbarriers.
PRODUCTS = {"gemma-7b ffn up": (4096, 3072, 24576), "granite-20b ffn up": (4096, 6144, 24576),
            "deepseek qkv": (8192, 2048, 2048), "qwen3 unembed": (4096, 1024, 151936),
            "deepseek expert": (16384, 2048, 1408)}
RINGS = {  # (bm, bn, bk, TMA route) -> (sub, ring bytes)
    (24, 128, 128, True): (128, 1024 + 2 * (2 * 24 * 128 + 2 * 128 * 128) + 32),
    (8, 128, 512, True): (256, 1024 + 2 * (4 * 8 * 128 + 2 * 256 * 128) + 32),
    (8, 128, 128, True): (128, 1024 + 2 * (2 * 8 * 128 + 2 * 128 * 128) + 32),
    (64, 64, 128, True): (128, 1024 + 2 * (2 * 64 * 128 + 1 * 128 * 128) + 32),
    (128, 256, 64, True): (64, 1024 + 2 * (1 * 128 * 128 + 4 * 64 * 128) + 32),
    (16, 16, 16, False): (16, 1024 + 2 * (1 * 16 * 128 + 1 * 16 * 128) + 32),
    (32, 64, 16, False): (16, 1024 + 2 * (1 * 32 * 128 + 1 * 16 * 128) + 32),
    (64, 32, 32, False): (32, 1024 + 2 * (1 * 64 * 128 + 1 * 32 * 128) + 32),
}


@pytest.mark.parametrize("case", [(name, policy) for name in PRODUCTS
                                  for policy in ("remop", "conventional")]
                         + [("probe", t) for t in ((8, 128, 128), (64, 64, 128), (128, 256, 64))]
                         + [("jax tiles", t) for t in EXPLICIT_TILES]
                         + [("f32 conventional", (8192, 2048, 2048))], ids=str)
def test_every_planned_tile_is_accepted_with_its_ring(case):
    what, arg = case
    if what in PRODUCTS or what == "f32 conventional":
        m, k, n = PRODUCTS.get(what, arg)
        dtype = torch.float32 if what == "f32 conventional" else torch.bfloat16
        tiles = clamped_tiles(plan_for((m, k), (k, n), dtype, arg if what in PRODUCTS
                                       else "conventional"), m, n, k)
    else:
        dtype, tiles = torch.bfloat16, arg
    check_tiles(*tiles, dtype.itemsize)
    bm, bn, bk = tiles
    if dtype == torch.float32:
        # The f32 kernel stages the planned step in even sub-steps that fit.
        assert tiles == (8, 128, 512) and f32_sub(*tiles) == 256
        assert (bm + bn) * f32_sub(*tiles) * 4 <= SMEM_BYTES < (bm + bn) * bk * 4
        return
    tma = bk % 64 == 0 and bn % 64 == 0  # contiguous aligned inputs: only the tiles decide
    sub = ring_sub(bm, bn, bk, tma)
    assert (sub, ring_bytes(bm, bn, sub)) == RINGS[bm, bn, bk, tma]
    assert ring_bytes(bm, bn, sub) <= SMEM_BYTES and bk % sub == 0
    if tma and sub == bk and bm in MMA_N:
        # The ring is the planner's double-buffered working set, without the
        # accumulator (in registers).
        assert RING_STAGES * ring_slot_bytes(bm, bn, sub) == matmul_vmem(bm, bn, bk, 2, 0)


def test_cuda_call_without_card_raises():
    a = torch.zeros(16, 16)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the call would launch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        remop_matmul(a.to(runtime.resolve_device(None)), a.to(runtime.resolve_device(None)))


def test_non_cpu_tensor_never_takes_the_plain_version():
    a = torch.zeros(16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        matmul_tiled(a, a, 16, 16, 16)


def test_cpu_calls_count_no_launch():
    before = runtime.launches["matmul"]
    a, b = _inputs(64, 64, 64, seed=1)
    remop_matmul(torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16))
    assert runtime.launches["matmul"] == before
    assert "matmul" in runtime.SOURCES and "remop_matmul_bf16" in runtime.SIGNATURES["matmul"]

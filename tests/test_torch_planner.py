"""The port's planner (``repro_torch.core.planner``) against the JAX package's.

The port's planner is ``repro``'s with its imports renamed and the H100 as
its default spec, so every public function must give the same plan, field
for field with exact float equality (both run the same Python arithmetic):
first under the TPU figures (``repro``'s ``TPU_V5E`` passed to the port),
then under the H100's (``H100`` passed to both).  Then the H100's figures,
the tier lookup, and what the planner does with those figures at the five
LLM products of ``benchmarks/bench_kernel_policy.py``: facts of the planner,
not claims that the REMOP plan wins.
"""

import dataclasses
import inspect

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import cost_model as jax_cost_model
from repro.core import planner as jax_planner
from repro.core.cost_model import TPU_TIERS, TPU_V5E

from repro_torch.core import H100, H100_TIERS, H100Spec, planner
from repro_torch.core.cost_model import resolve_tier_name
from repro_torch.engine.registry import resolve_tier
from repro_torch.kernels.flash_attention.ops import HOPPER_SMEM_BYTES, plan_blocks
from repro_torch.kernels.matmul.matmul import SMEM_BYTES, check_tiles

# (m, k, n) of bench_kernel_policy.LLM_MATMULS (benchmarks/bench_kernel_policy.py:25-31).
LLM_MATMULS = [
    (4096, 3072, 24576),   # gemma-7b ffn up
    (4096, 6144, 24576),   # granite-20b ffn up
    (8192, 2048, 2048),    # deepseek qkv
    (4096, 1024, 151936),  # qwen3 unembed
    (16384, 2048, 1408),   # deepseek expert matmul
]
SPECS = {"tpu": TPU_V5E, "h100": H100}
PLAN_FUNCTIONS = ("plan_matmul_tiles", "conventional_matmul_tiles", "plan_sort",
                  "plan_grad_buckets", "plan_kv_pages", "plan_microbatches")


def _same(name, args, kwargs, spec_key):
    """Call ``name`` in both packages; equal results field for field, or both
    raise AssertionError.  Under the TPU figures ``repro`` takes its default
    spec and the port is passed ``TPU_V5E``; under the H100's both are passed
    ``H100``."""
    spec = SPECS[spec_key]
    jax_kwargs = dict(kwargs) if spec_key == "tpu" else dict(kwargs, spec=spec)

    def call(fn, kw):
        try:
            return fn(*args, **kw)
        except AssertionError as exc:
            return ("AssertionError", str(exc))

    got = call(getattr(planner, name), dict(kwargs, spec=spec))
    want = call(getattr(jax_planner, name), jax_kwargs)
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got == want, (name, args, kwargs, spec_key)
    return got


# ---------------------------------------------------------------------------
# parity with repro, field for field
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(shape=st.sampled_from(LLM_MATMULS + [(m, k, n) for m in (512, 2048, 4096, 8192)
                                            for k in (512, 1024, 4096)
                                            for n in (512, 2048, 16384)]),
       in_bytes=st.sampled_from([2, 4]),
       exhaustive=st.booleans(),
       budget=st.sampled_from([None, 1 << 16, 1 << 20, 64 << 20]))
def test_matmul_plans_match_repro(shape, in_bytes, exhaustive, budget):
    m, k, n = shape
    for spec_key in SPECS:
        _same("plan_matmul_tiles", (m, n, k),
              dict(in_bytes=in_bytes, vmem_budget=budget, exhaustive=exhaustive), spec_key)
        _same("conventional_matmul_tiles", (m, n, k),
              dict(in_bytes=in_bytes, vmem_budget=budget), spec_key)


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 20000), n=st.integers(1, 200000), k=st.integers(1, 8192),
       bm=st.integers(1, 1024), bn=st.integers(1, 1024), bk=st.integers(1, 1024),
       in_bytes=st.sampled_from([1, 2, 4]), double=st.booleans())
def test_matmul_costs_and_vmem_match_repro(m, n, k, bm, bn, bk, in_bytes, double):
    assert (planner.matmul_costs(m, n, k, bm, bn, bk, in_bytes, 4)
            == jax_planner.matmul_costs(m, n, k, bm, bn, bk, in_bytes, 4))
    assert (planner.matmul_vmem(bm, bn, bk, in_bytes, double_buffer=double)
            == jax_planner.matmul_vmem(bm, bn, bk, in_bytes, double_buffer=double))


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 1 << 24), item_bytes=st.sampled_from([4, 8, 16]),
       budget=st.sampled_from([None, 1 << 14, 1 << 20]),
       context=st.integers(1, 65536), kv_heads=st.sampled_from([1, 2, 8]),
       head_dim=st.sampled_from([8, 14, 64, 128, 256]), kv_bytes=st.sampled_from([1, 2]))
def test_sort_and_kv_page_plans_match_repro(n, item_bytes, budget, context, kv_heads,
                                             head_dim, kv_bytes):
    for spec_key in SPECS:
        _same("plan_sort", (n,), dict(item_bytes=item_bytes, vmem_budget=budget), spec_key)
        _same("plan_kv_pages", (context, kv_heads, head_dim),
              dict(kv_bytes=kv_bytes, vmem_budget=budget), spec_key)


@settings(max_examples=20, deadline=None)
@given(total=st.integers(0, 10 ** 10), backward=st.floats(0.0, 0.5),
       group=st.sampled_from([1, 2, 4, 8, 16, 64]),
       batch=st.sampled_from([1, 3, 8, 16, 64]), seq=st.sampled_from([128, 4096, 32768]),
       d_model=st.sampled_from([512, 2048, 6144]), layers=st.integers(1, 96),
       budget=st.sampled_from([None, 1 << 30, 6 << 30]))
def test_bucket_and_microbatch_plans_match_repro(total, backward, group, batch, seq,
                                                 d_model, layers, budget):
    for spec_key in SPECS:
        _same("plan_grad_buckets", (total, backward, group), {}, spec_key)
        _same("plan_microbatches", (batch, seq, d_model, layers),
              dict(hbm_activation_budget=budget), spec_key)


@settings(max_examples=20, deadline=None)
@given(tokens=st.integers(1, 1 << 17), token_bytes=st.sampled_from([512, 4096, 14336]),
       experts=st.sampled_from([8, 64, 160]), ep=st.sampled_from([1, 2, 4, 16]),
       budget=st.integers(1, 1 << 28))
def test_dispatch_plan_matches_repro(tokens, token_bytes, experts, ep, budget):
    got = planner.plan_dispatch(tokens, token_bytes, experts, ep, budget)
    want = jax_planner.plan_dispatch(tokens, token_bytes, experts, ep, budget)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the H100 as default spec, its figures and tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PLAN_FUNCTIONS)
def test_default_spec_is_h100(name):
    param = inspect.signature(getattr(planner, name)).parameters["spec"]
    assert param.default is H100
    jax_param = inspect.signature(getattr(jax_planner, name)).parameters["spec"]
    assert jax_param.default is TPU_V5E


def test_default_spec_plans_equal_explicit_h100():
    for m, k, n in LLM_MATMULS:
        assert planner.plan_matmul_tiles(m, n, k) == planner.plan_matmul_tiles(m, n, k, spec=H100)
        assert (planner.conventional_matmul_tiles(m, n, k)
                == planner.conventional_matmul_tiles(m, n, k, spec=H100))
    assert planner.plan_sort(1 << 22) == planner.plan_sort(1 << 22, spec=H100)


def test_h100_figures():
    assert isinstance(H100, H100Spec) and H100 == H100Spec()
    assert H100.vmem_bytes == 232_448
    assert H100.hbm_bandwidth == 3.35e12
    assert H100.ici_bandwidth == 450e9
    assert H100.peak_flops == 989e12
    assert H100.hbm_bytes == 80 * 1024 ** 3
    # Placeholders chosen for the card, not the TPU's 1 us and 10 us.
    assert H100.dma_overhead_s != TPU_V5E.dma_overhead_s
    assert H100.collective_launch_s != TPU_V5E.collective_launch_s
    assert H100.tau_dma_bytes == H100.hbm_bandwidth * H100.dma_overhead_s
    assert H100.tau_ici_bytes == H100.ici_bandwidth * H100.collective_launch_s
    with pytest.raises(dataclasses.FrozenInstanceError):
        H100.vmem_bytes = 1
    # One source for a CTA's shared memory.
    assert HOPPER_SMEM_BYTES == SMEM_BYTES == H100.vmem_bytes


@pytest.mark.parametrize("tier", sorted(H100_TIERS))
def test_h100_tiers_resolve_by_name(tier):
    spec = resolve_tier_name(tier)
    assert spec is H100_TIERS[tier] is resolve_tier(tier)
    assert spec.name == tier
    if tier in TPU_TIERS:  # repro resolves the same name to its TPU tier
        assert jax_cost_model.resolve_tier_name(tier) is TPU_TIERS[tier]
        assert jax_cost_model.resolve_tier_name(tier) != spec


def test_h100_tier_figures():
    assert resolve_tier_name("hbm_dma").bandwidth == H100.hbm_bandwidth
    assert resolve_tier_name("hbm_dma").rtt == H100.dma_overhead_s
    assert resolve_tier_name("nvlink").bandwidth == H100.ici_bandwidth
    assert resolve_tier_name("nvlink").rtt == H100.collective_launch_s
    assert resolve_tier_name("pcie_host").bandwidth == 64e9
    with pytest.raises(KeyError, match="nvlink"):
        resolve_tier_name("ici")


# ---------------------------------------------------------------------------
# what the planner does with the H100's figures
# ---------------------------------------------------------------------------

# (m, k, n) -> (C, D) of the REMOP plan (24, 128, 128) and of the
# conventional plan (8, 128, 512), in bf16.
H100_PLAN_COSTS = {
    (4096, 3072, 24576): ((1_608_768, 31_054_626_816), (1_277_952, 82_543_902_720)),
    (4096, 6144, 24576): ((3_184_704, 61_706_600_448), (2_457_600, 164_685_152_256)),
    (8192, 2048, 2048): ((180_576, 3_472_883_712), (147_456, 9_193_914_368)),
    (4096, 1024, 151936): ((3_450_609, 65_655_799_808), (3_038_720, 171_763_040_256)),
    (16384, 2048, 1408): ((247_929, 4_769_447_936), (202_752, 12_641_632_256)),
}


@pytest.mark.parametrize("shape", LLM_MATMULS, ids=lambda s: "x".join(map(str, s)))
def test_h100_plans_at_kernel_policy_shapes(shape):
    m, k, n = shape
    budget = H100.vmem_bytes // 2
    remop = planner.plan_matmul_tiles(m, n, k, in_bytes=2)
    conv = planner.conventional_matmul_tiles(m, n, k, in_bytes=2)
    # No candidate of the exhaustive search fits: the closed form stands.
    assert remop == planner.plan_matmul_tiles(m, n, k, in_bytes=2, exhaustive=False)
    assert (remop.bm, remop.bn, remop.bk, remop.policy) == (24, 128, 128, "remop-closed-form")
    assert remop.vmem_bytes == 90_112 <= budget
    # The conventional plan ignores the budget, and exceeds a CTA's shared
    # memory double-buffered; single-buffered it fits.
    assert (conv.bm, conv.bn, conv.bk) == (8, 128, 512)
    assert conv.vmem_bytes == 282_624 > H100.vmem_bytes > budget
    assert planner.matmul_vmem(8, 128, 512, 2, double_buffer=False) <= H100.vmem_bytes
    (c_r, d_r), (c_c, d_c) = H100_PLAN_COSTS[shape]
    assert (remop.c_rounds, remop.d_bytes) == (c_r, d_r)
    assert (conv.c_rounds, conv.d_bytes) == (c_c, d_c)
    # REMOP's plan: 14-30% more rounds than the conventional plan, ~2.6x fewer bytes.
    assert 1.13 < remop.c_rounds / conv.c_rounds < 1.30
    assert 2.6 < conv.d_bytes / remop.d_bytes < 2.7
    # Both plans launch: the kernel's own pre-launch check accepts them.
    check_tiles(remop.bm, remop.bn, remop.bk, 2)
    check_tiles(conv.bm, conv.bn, conv.bk, 2)
    # The tiles do not move with the placeholder overhead over 0.25-2 us.
    for overhead in (0.25e-6, 0.7e-6, 2e-6):
        spec = dataclasses.replace(H100, dma_overhead_s=overhead)
        for plan, ref in ((planner.plan_matmul_tiles(m, n, k, in_bytes=2, spec=spec), remop),
                          (planner.conventional_matmul_tiles(m, n, k, in_bytes=2, spec=spec),
                           conv)):
            assert (plan.bm, plan.bn, plan.bk) == (ref.bm, ref.bn, ref.bk)
    # With Hopper-like alignment (64-row wgmma) REMOP picks (64, 64, 128)
    # and has fewer rounds than the conventional plan.
    aligned = planner.plan_matmul_tiles(m, n, k, in_bytes=2, lane=64, sublane=64)
    assert (aligned.bm, aligned.bn, aligned.bk) == (64, 64, 128)
    assert aligned.c_rounds < conv.c_rounds


def test_h100_smallest_exhaustive_candidate_does_not_fit():
    assert planner.matmul_vmem(64, 128, 128, 2) == 131_072 > H100.vmem_bytes // 2


def test_h100_f32_matmul_has_no_feasible_tile():
    # The smallest tile the closed form reaches, (8, 128, 128), needs 143,360
    # bytes in f32 double-buffered against a budget of 116,224.
    assert planner.matmul_vmem(8, 128, 128, 4) == 143_360 > H100.vmem_bytes // 2
    for m, k, n in LLM_MATMULS[:2] + [(64, 64, 64)]:
        for exhaustive in (True, False):
            with pytest.raises(AssertionError, match="no feasible tile"):
                planner.plan_matmul_tiles(m, n, k, in_bytes=4, exhaustive=exhaustive)


def test_h100_kv_pages_and_sort_runs():
    # No page for a KV width above 56 bytes a token: gemma-2b's 256 x 2 B asserts.
    assert planner.plan_kv_pages(4096, 1, 28).page_tokens == 128
    for kv_heads, head_dim in ((1, 29), (1, 256), (8, 128)):
        with pytest.raises(AssertionError):
            planner.plan_kv_pages(4096, kv_heads, head_dim)
    # Sort runs stop being powers of two (sort_blocks takes powers of two).
    run = planner.plan_sort(1 << 22).run_items
    assert run == 3072 and run & (run - 1)
    assert jax_planner.plan_sort(1 << 22).run_items == 1 << 21


@pytest.mark.parametrize("s", [2048, 1536, 1000, 777, 512, 64, 2077])
def test_flash_plan_blocks_unchanged_at_gemma_shapes(s):
    # gemma-2b prefill (head width 256, bf16) takes the tensor-core route: the
    # budget read from the H100 spec plans as the literal 232,448 bytes, and
    # two KV stages of 256-wide rows fit at bk 64 only (bk 128 needs 263 KB).
    assert plan_blocks(s, s, 256, 2) == plan_blocks(s, s, 256, 2, smem_budget=232_448)
    assert plan_blocks(s, s, 256, 2) == ((64, 64) if s <= 64 else (128, 64))
    assert plan_blocks(s, s, 256, 2, path="simt") == (64, 64)

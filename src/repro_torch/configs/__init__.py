"""Architecture registry: ``--arch <id>`` resolves here."""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, reduced, shape_applicable
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE_16B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B_A800M
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.qwen3_0_6b import CONFIG as QWEN3_0_6B
from repro_torch.configs.granite_20b import CONFIG as GRANITE_20B
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.paligemma_3b import CONFIG as PALIGEMMA_3B
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as SEAMLESS_M4T_LARGE_V2
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B

ARCHS = {c.name: c for c in [
    DEEPSEEK_V2_LITE_16B,
    GRANITE_MOE_3B_A800M,
    GEMMA_7B,
    GEMMA_2B,
    QWEN3_0_6B,
    GRANITE_20B,
    MAMBA2_370M,
    PALIGEMMA_3B,
    SEAMLESS_M4T_LARGE_V2,
    RECURRENTGEMMA_2B,
]}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_arch",
           "reduced", "shape_applicable"]

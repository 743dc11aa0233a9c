"""Assigned-architecture registry: ``--arch <id>`` resolves here."""
from repro_torch.configs.base import (ArchConfig, MoECfg, MLACfg, EncoderCfg,
                                      ShapeCfg, SHAPES, shape_applicable,
                                      reduce_for_smoke)

from repro_torch.configs.smollm_135m import CONFIG as _smollm
from repro_torch.configs.granite_34b import CONFIG as _granite
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma

ARCHS = {c.name: c for c in [
    _smollm, _granite, _yi, _stablelm, _xlstm,
    _llava, _dsv2, _qwen, _whisper, _rgemma,
]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "MoECfg", "MLACfg", "EncoderCfg", "ShapeCfg",
           "SHAPES", "ARCHS", "get_arch", "shape_applicable",
           "reduce_for_smoke"]

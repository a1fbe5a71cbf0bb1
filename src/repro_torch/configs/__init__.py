"""Per-architecture configs (exact assigned sizes) + smoke variants: the
port's copies of ``repro/configs/<id>.py``, data only.

``get_arch(id)`` returns the module for an assigned architecture;
``ARCHS`` lists all 10 LM-family ids.  The reference's ``fagp.py`` (the
legacy ``FAGPConfig``, which the port does not export) and ``shapes.py``
(the dry run's shape table) wait for A8's dry-run part.
"""
from . import (
    deepseek_v3_671b,
    llama32_vision_11b,
    mamba2_130m,
    olmoe_1b_7b,
    qwen2_1p5b,
    qwen2p5_3b,
    smollm_360m,
    starcoder2_3b,
    whisper_small,
    zamba2_7b,
)

ARCHS = {
    "mamba2-130m": mamba2_130m,
    "deepseek-v3-671b": deepseek_v3_671b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "qwen2-1.5b": qwen2_1p5b,
    "smollm-360m": smollm_360m,
    "starcoder2-3b": starcoder2_3b,
    "qwen2.5-3b": qwen2p5_3b,
    "whisper-small": whisper_small,
    "zamba2-7b": zamba2_7b,
    "llama-3.2-vision-11b": llama32_vision_11b,
}


def get_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]

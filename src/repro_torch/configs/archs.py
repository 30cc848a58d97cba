"""Import every assigned architecture config for registry side effects."""

from . import (deepseek_v2_236b, deepseek_v3_671b, gemma3_1b, internvl2_1b,
               llama3_8b, mamba2_130m, minitron_8b, recurrentgemma_9b,
               seamless_m4t_medium, stablelm_12b)  # noqa: F401

ARCH_IDS = [
    "llama3-8b",
    "gemma3-1b",
    "minitron-8b",
    "stablelm-12b",
    "deepseek-v2-236b",
    "deepseek-v3-671b",
    "seamless-m4t-medium",
    "recurrentgemma-9b",
    "internvl2-1b",
    "mamba2-130m",
]

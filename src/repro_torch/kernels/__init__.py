"""Hand-written Hopper kernels for the serving hot spots, with plain versions.

* flash_attention — prefill attention (tiled online softmax), CUDA
* decode_attention — flash-decode against a KV cache, CUDA
* ssd_scan — Mamba2 chunked SSD scan with its final state, CUDA
* rglru_scan — RG-LRU linear recurrence over time, CUDA

``ops`` holds the public wrappers (the reference's padding semantics),
``ref`` the plain PyTorch versions, ``build`` the nvcc build and the
launch counters.
"""

from . import build, ops, ref
from .decode_attention import stats as decode_attention_stats
from .flash_attention import stats as flash_attention_stats
from .rglru_scan import stats as rglru_scan_stats
from .ssd_scan import stats as ssd_scan_stats

KERNEL_STATS = {"flash_attention": flash_attention_stats,
                "decode_attention": decode_attention_stats,
                "ssd_scan": ssd_scan_stats,
                "rglru_scan": rglru_scan_stats}

__all__ = ["KERNEL_STATS", "build", "ops", "ref"]

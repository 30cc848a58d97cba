"""Hand-written Hopper kernels for the serving hot spots, with plain versions.

* flash_attention — prefill attention (tiled online softmax), CUDA
* decode_attention — flash-decode against a KV cache, CUDA

``ops`` holds the public wrappers (the reference's padding semantics),
``ref`` the plain PyTorch versions, ``build`` the nvcc build and the
launch counters.  The Pallas ``ssd_scan`` and ``rglru_scan`` kernels are
ported with the SSM and RG-LRU model slices.
"""

from . import build, ops, ref
from .decode_attention import stats as decode_attention_stats
from .flash_attention import stats as flash_attention_stats

KERNEL_STATS = {"flash_attention": flash_attention_stats,
                "decode_attention": decode_attention_stats}

__all__ = ["KERNEL_STATS", "build", "ops", "ref"]

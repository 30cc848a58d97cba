"""Hand-written Hopper kernels for the serving hot spots, with plain versions.

* flash_attention — prefill attention (tiled online softmax), CUDA:
  tensor cores (wgmma fed by TMA) for bf16, a warp per (batch, head) for fp32
  with at most 16 rows and keys (the short route), CUDA cores for the
  rest of fp32 and head dim 8 (register-tiled, two blocks a query tile)
* decode_attention — flash-decode against a KV cache, CUDA: tensor cores
  (mma.sync) for bf16 with GQA groups up to 16 as one launch (a cluster
  of blocks a (batch row, KV head), merged in distributed shared
  memory), CUDA cores for fp32, head dim 8 and larger groups (64-row
  splits and a combine)
* ssd_scan — Mamba2 chunked SSD scan with its final state, CUDA: tensor
  cores (mma.sync) for bf16 as one launch (a cluster of blocks a (batch
  row, head), the state handed on in distributed shared memory, in
  tiles where one block would not hold it), three CUDA-core passes for
  fp32
* rglru_scan — RG-LRU linear recurrence over time, CUDA: one chunked
  scan for every shape

decode_attention and ssd_scan each have two routes, flash_attention
three, and each chooses one by dtype and shape before the launch
(``<module>.route``); ``launch`` in each of those modules can force one,
for timing and checking them all on a card.

``ops`` holds the public wrappers (the reference's padding semantics),
``ref`` the plain PyTorch versions, ``build`` the nvcc build and the
launch counters (kept by route).
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

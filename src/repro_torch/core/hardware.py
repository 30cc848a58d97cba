"""The port's card: an NVIDIA H100 SXM as a roofline ``HardwareSpec``.

The counterpart of ``TPU_V5E`` in the copied ``core/roofline.py`` (which
stays byte-identical to the reference's): the analytic profiler
(``launch/profile_gpu.py``) and the dry run (``launch/dryrun.py``) build
their roofline terms from :data:`H100`.  Each constant names its source:
NVIDIA's H100 SXM datasheet (dense rates, no sparsity, at the full 700 W
power limit), or a measurement by ``chip_smoke.py`` on one NVIDIA H100
80GB HBM3 at a 700.00 W power limit.

The dispatch term.  Every eager LM step of the port is bound by the host
that issues it: one aten op costs the host about :data:`HOST_S_PER_LAUNCH`
whatever the device does.  ``H100.dispatch_overhead`` is one launch's
host time; :func:`with_launches` gives a spec whose overhead is a step's
``launches`` of them, as the terms of a counted step use.
"""

from __future__ import annotations

import dataclasses

from .roofline import HardwareSpec

# datasheet: dense bf16 tensor-core rate
BF16_PEAK_FLOPS = 989e12
# datasheet: float32 and float64 outside the tensor cores
FP32_PEAK_FLOPS = 67e12
FP64_PEAK_FLOPS = 34e12
# datasheet: HBM3 bandwidth
HBM_BANDWIDTH = 3.35e12
# datasheet: NVLink 4, 900 GB/s a card both ways over 18 links, so
# 25 GB/s a link each way
NVLINK_LINKS = 18
NVLINK_LINK_BANDWIDTH = 25e9
# measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit:
# torch.cuda.get_device_properties(0).total_memory (79.18 GiB)
HBM_CAPACITY = 85_017_493_504
# measured on the same card by chip_smoke.py's profile phase: the wall
# time of full-width gemma3-1b's bf16 decode step (8192 cache slots,
# kernels off) over its 2,115 device ops, the median of b = 1, 4 and 16
# in three runs (14.9-33.7 us)
HOST_S_PER_LAUNCH = 20.9e-6

H100 = HardwareSpec(
    name="h100_sxm",
    peak_flops=BF16_PEAK_FLOPS,
    hbm_bandwidth=HBM_BANDWIDTH,
    ici_link_bandwidth=NVLINK_LINK_BANDWIDTH,
    hbm_capacity=HBM_CAPACITY,
    dispatch_overhead=HOST_S_PER_LAUNCH,
)


def with_launches(hw: HardwareSpec, launches: int) -> HardwareSpec:
    """``hw`` with the dispatch overhead of a step of ``launches`` device
    ops, each issued by the host in :data:`HOST_S_PER_LAUNCH`."""
    return dataclasses.replace(hw, dispatch_overhead=launches
                               * HOST_S_PER_LAUNCH)


__all__ = ["BF16_PEAK_FLOPS", "FP32_PEAK_FLOPS", "FP64_PEAK_FLOPS", "H100",
           "HBM_BANDWIDTH", "HBM_CAPACITY", "HOST_S_PER_LAUNCH",
           "NVLINK_LINKS", "NVLINK_LINK_BANDWIDTH", "with_launches"]

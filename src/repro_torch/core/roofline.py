"""Three-term roofline model for TPU serving/training steps.

The paper profiles ⟨1,t,b⟩ configurations by *measuring* wall-clock
latency.  On this CPU-only container targeting TPU v5e, the analogous
profile is derived from the compiled dry-run artifact:

    compute term    = HLO_FLOPs      / (chips × peak_FLOP/s)
    memory term     = HLO_bytes      / (chips × HBM_bw)
    collective term = collective_bytes / (chips × link_bw)

``L(t, b) = max(terms) + α_dispatch`` is the per-instance latency fed to
Packrat's knapsack DP (core/knapsack.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip hardware constants."""

    name: str
    peak_flops: float          # FLOP/s (bf16)
    hbm_bandwidth: float       # bytes/s
    ici_link_bandwidth: float  # bytes/s per link
    hbm_capacity: float        # bytes
    dispatch_overhead: float   # seconds of fixed per-step host/dispatch cost


# TPU v5e constants from the assignment: 197 TFLOP/s bf16, 819 GB/s HBM,
# ~50 GB/s/link ICI, 16 GiB HBM.
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bandwidth=819e9,
    ici_link_bandwidth=50e9,
    hbm_capacity=16 * (1 << 30),
    dispatch_overhead=50e-6,
)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Roofline terms for one (program, mesh) pair.

    ``flops``/``bytes`` are totals across all chips (HLO cost analysis of
    the SPMD program is per-chip; callers multiply by chip count — see
    launch/hlo_analysis.py).  ``collective_bytes`` is the per-chip sum of
    collective operand bytes.
    """

    flops: float               # total FLOPs across chips
    hbm_bytes: float           # total HBM bytes moved across chips
    collective_bytes: float    # per-chip collective operand bytes
    chips: int
    hw: HardwareSpec = TPU_V5E
    ici_links: int = 4         # links per chip engaged (2D torus: 4)

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.hw.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.hw.hbm_bandwidth)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.ici_links * self.hw.ici_link_bandwidth)

    @property
    def latency(self) -> float:
        """max(terms) + fixed dispatch overhead (overlap-optimal bound)."""
        return (max(self.compute_s, self.memory_s, self.collective_s)
                + self.hw.dispatch_overhead)

    @property
    def latency_serial(self) -> float:
        """sum(terms) + overhead (no compute/comm overlap — pessimistic bound)."""
        return (self.compute_s + self.memory_s + self.collective_s
                + self.hw.dispatch_overhead)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "latency_s": self.latency,
            "chips": self.chips,
        }

    def roofline_fraction(self, model_flops: Optional[float] = None) -> float:
        """Fraction of the hardware roofline achieved by this program.

        Achieved useful-FLOP rate divided by the per-chip bound implied by
        the *binding* roofline term.  With ``model_flops`` (6·N·D style
        algorithmic FLOPs) the numerator counts only useful work, so remat
        and redundancy lower the score.
        """
        useful = model_flops if model_flops is not None else self.flops
        if self.latency <= 0:
            return 0.0
        achieved = useful / (self.latency * self.chips)
        return achieved / self.hw.peak_flops


def model_flops_ratio(model_flops: float, terms: RooflineTerms) -> float:
    """MODEL_FLOPS / HLO_FLOPs — how much compiled compute is useful."""
    if terms.flops <= 0:
        return 0.0
    return model_flops / terms.flops

"""Beyond-paper extensions: SLO-constrained and multi-model optimization.

The paper (§6) contrasts Packrat with Clipper/Nexus, which batch under
latency SLOs and pack multiple models onto shared resources.  Both
compose naturally with the ⟨i,t,b⟩ knapsack:

* :func:`solve_with_slo` — the largest batch (max throughput) whose
  optimal configuration still meets a latency SLO: sweep B down the
  power-of-two grid, reusing the DP's memoised tables.
* :class:`MultiModelAllocator` — split the pod's T units across several
  models (each with its own profile and live batch size) to minimize the
  worst per-model batch latency: binary search on the latency bound λ,
  feasibility-checked with the minimal T_m such that
  ``PackratOptimizer_m.solve(T_m, B_m).latency ≤ λ``; monotone in T_m by
  construction (solve_with_units uses the ≤-units relaxation).

Both are exercised in tests/test_multimodel.py and demonstrate how
Packrat's optimizer doubles as a cluster-level placement policy —
thin-instance partitions leave contiguous idle sub-meshes that other
models can claim (the multi-tenant regime the TPU profile makes
explicit: L(32,1) < L(256,1) for llama3-8b decode).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .knapsack import (PackratConfig, PackratOptimizer, PlanTableRegistry,
                       powers_of_two)

Profile = Mapping[Tuple[int, int], float]


# --------------------------------------------------------------------- #
# SLO-constrained batch selection
# --------------------------------------------------------------------- #
def solve_with_slo(optimizer: PackratOptimizer, threads: int,
                   latency_slo: float, *, max_batch: int = 1 << 16
                   ) -> Optional[Tuple[int, PackratConfig]]:
    """Largest power-of-two batch whose optimal config meets the SLO.

    Returns (B, config) maximizing throughput subject to
    ``config.latency ≤ latency_slo``, or None if even B=1 misses it.

    When the profile is latency-monotone in b (real profiles are: larger
    batches never take less absolute time), the sweep early-exits at the
    first probe whose provable makespan floor
    (:meth:`PackratOptimizer.slo_latency_floor`) already exceeds the
    SLO — the floor is nondecreasing in b, so no later probe can be both
    feasible and within the deadline.  Skipped probes are tallied on
    ``optimizer.slo_probes_saved``.
    """
    best: Optional[Tuple[int, PackratConfig]] = None
    probes = powers_of_two(max_batch)
    monotone = optimizer.latency_monotone_in_b
    for idx, b in enumerate(probes):
        if monotone and optimizer.slo_latency_floor(threads, b) > latency_slo:
            optimizer.slo_probes_saved += len(probes) - idx
            break
        cfg = optimizer.try_solve(threads, b)
        if cfg is None:
            continue
        if cfg.latency <= latency_slo:
            if best is None or cfg.throughput > best[1].throughput:
                best = (b, cfg)
    optimizer.slo_sweeps += 1
    return best


# --------------------------------------------------------------------- #
# multi-model unit allocation
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ModelWorkload:
    name: str
    profile: Profile
    batch: int
    # Optional throughput floor (req/s).  The live planner passes the
    # per-model arrival-rate estimate λ̂_m: a share that meets the
    # latency bound λ but cannot *sustain* the model's traffic
    # (batch/latency < λ̂_m) is not a feasible share at all.  Since
    # batch/latency ≥ min_rate ⇔ latency ≤ batch/min_rate, the floor is
    # just a second latency bound and the λ-binary-search is unchanged.
    min_rate: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelPlacement:
    name: str
    units: int
    config: PackratConfig


class MultiModelAllocator:
    """Minimize the worst per-model batch latency across shared units."""

    def __init__(self, workloads: Sequence[ModelWorkload], *,
                 optimizers: Optional[Mapping[str, PackratOptimizer]] = None,
                 registry: Optional[PlanTableRegistry] = None) -> None:
        """``optimizers`` optionally supplies pre-built per-model solvers
        (must use the ≤-units relaxation) so a caller re-planning every
        few seconds — the live multi-model controller — keeps the DP's
        memoised ⟨T,B⟩ caches across plans instead of rebuilding them.
        ``registry`` shares DP tables across the models' optimizers, so
        tenants serving the same profile plan off one table."""
        if not workloads:
            raise ValueError("no workloads")
        self.workloads = list(workloads)
        if optimizers is not None:
            missing = {w.name for w in workloads} - set(optimizers)
            if missing:
                raise ValueError(f"optimizers missing models: {sorted(missing)}")
            self._opts = {w.name: optimizers[w.name] for w in workloads}
        else:
            # ≤-units relaxation makes latency monotone nonincreasing in T_m
            self._opts = {w.name: PackratOptimizer(w.profile,
                                                   allow_unused_threads=True)
                          for w in workloads}
        if registry is not None:
            for opt in self._opts.values():
                opt.adopt_registry(registry)

    def _min_units_for(self, w: ModelWorkload, lam: float, total: int
                       ) -> Optional[int]:
        """Smallest T_m with optimal latency ≤ λ (binary search).

        A ``min_rate`` throughput floor tightens the bound to
        ``min(λ, batch/min_rate)`` — both constraints are monotone in
        T_m under the ≤-units relaxation, so one search serves both.
        """
        opt = self._opts[w.name]
        bound = lam
        if w.min_rate > 0.0:
            bound = min(bound, w.batch / w.min_rate)

        def latency(units: int) -> float:
            cfg = opt.try_solve(units, w.batch)
            return cfg.latency if cfg is not None else math.inf

        if latency(total) > bound:
            return None
        lo, hi = 1, total
        while lo < hi:
            mid = (lo + hi) // 2
            if latency(mid) <= bound:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def allocate(self, total_units: int, *, iters: int = 20,
                 prior: Optional[Mapping[str, int]] = None
                 ) -> List[ModelPlacement]:
        """Binary-search the makespan λ; assign leftover units greedily.

        ``prior`` (the live planner passes the current share map) makes
        the leftover assignment *stability-aware*: units beyond every
        model's λ-minimum first restore models toward their prior share
        — so a tenant idling through a quiet spell keeps its headroom
        instead of being stripped for a marginal latency gain elsewhere
        — and only the remainder is distributed greedily.
        """
        candidates = sorted({
            self._opts[w.name].solve(t, w.batch).latency
            for w in self.workloads
            for t in {1, 2, 4, total_units}
            if self._feasible_latency(w, t)})
        lo = min(candidates)
        hi = max(candidates)
        best: Optional[Dict[str, int]] = None
        for _ in range(iters):
            lam = 0.5 * (lo + hi)
            assign = self._try(lam, total_units)
            if assign is not None:
                best = assign
                hi = lam
            else:
                lo = lam
        if best is None:
            best = self._try(hi, total_units)
        if best is None:
            # even λ = max is infeasible jointly: give every model its
            # proportional share as a last resort
            share = max(1, total_units // len(self.workloads))
            best = {w.name: share for w in self.workloads}
        leftover = total_units - sum(best.values())
        if prior:
            for w in self.workloads:
                if leftover <= 0:
                    break
                want = prior.get(w.name, 0) - best[w.name]
                if want > 0:
                    extra = min(want, leftover)
                    best[w.name] += extra
                    leftover -= extra
        placements = []
        for w in self.workloads:
            units = best[w.name]
            if leftover > 0:
                extra = min(leftover, units)  # double the tightest first
                units += extra
                leftover -= extra
            placements.append(ModelPlacement(
                w.name, units, self._opts[w.name].solve(units, w.batch)))
        return placements

    def _feasible_latency(self, w: ModelWorkload, units: int) -> bool:
        return self._opts[w.name].try_solve(units, w.batch) is not None

    def _try(self, lam: float, total: int) -> Optional[Dict[str, int]]:
        used = 0
        out: Dict[str, int] = {}
        for w in self.workloads:
            need = self._min_units_for(w, lam, total - used)
            if need is None:
                return None
            out[w.name] = need
            used += need
            if used > total:
                return None
        return out

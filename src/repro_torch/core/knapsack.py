"""Packrat's optimizer: 2-D unbounded-knapsack dynamic program (paper §3.3).

Given a profile of *single-instance* average batch latencies
``L[t, b]`` (``t`` = units of intra-op parallelism — CPU threads in the
paper, TPU chips here; ``b`` = per-instance batch size), find the
partition ``[⟨i_1,t_1,b_1⟩, …, ⟨i_n,t_n,b_n⟩]`` that minimizes the
*makespan* (latency of the slowest concurrent instance)

    minimize   max_j L[t_j, b_j]
    subject to Σ_j i_j · t_j = T   and   Σ_j i_j · b_j = B

via the recurrence (paper, §3.3)

    opt[t, b] = min over profiled (t', b') of
                max(opt[t - t', b - b'], L[t', b'])

with ``opt[0, 0] = 0``.  Backtracking the argmin recovers the (possibly
non-uniform, §5.2.3) instance list.

The DP is *unbounded* (a profiled ⟨t', b'⟩ item may be used many times —
that is simply several identical concurrent instances).  Because every
item consumes ``t' ≥ 1`` threads, a forward iteration over ``t`` is a
correct unbounded-knapsack order, which lets the inner loop be
vectorized over the batch dimension with numpy.

Shared-table planning engine
----------------------------

An item ⟨t', b'⟩ can only reach cell ``(t, b)`` when ``t' ≤ t`` and
``b' ≤ b``, so the ``(T+1)×(B+1)`` ``opt``/``choice`` arrays built for
the *largest* ⟨T, B⟩ already contain the answer to **every** smaller
query, bit for bit.  The default engine therefore keeps **one**
:class:`PlanTable` per planning profile — grown geometrically when a
query exceeds its bounds — and answs each ``solve(t, b)`` by an
O(groups) backtrack into the shared table instead of an
``O(T·B·items)`` rebuild.  That is what makes the control plane's query
volume affordable: the :func:`~repro.core.multimodel.solve_with_slo`
power-of-two sweep, the multi-model λ-binary-search (re-solving per
model per probe across unit counts), and calibration-epoch refreshes
all hit the same table.

Tables live in a :class:`PlanTableRegistry` keyed by a profile
fingerprint, so same-profile optimizers — multi-model tenants serving
the same model, homogeneous fleet nodes — share one table *and* its
⟨T,B⟩ plan cache.  A calibration refresh swaps the planning costs with
:meth:`PackratOptimizer.update_profile`, which bumps the optimizer's
``epoch`` and re-interns a fresh table (rebuilt once, at the bounds the
next query needs) instead of discarding the optimizer object.

``engine="reference"`` retains the original per-query DP verbatim; the
two engines return bit-identical :class:`PackratConfig` objects (the
property tests in tests/test_planning.py and the CI byte-identity smoke
pin this), so the shared table is a pure amortization.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import itertools
import math
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

Profile = Mapping[Tuple[int, int], float]  # (t, b) -> avg batch latency (s)

_INF = float("inf")

# planning engines: the shared-table amortized solver (default) and the
# retained per-query reference DP (bit-identical results, used by the
# equivalence tests and the CI control-plane byte-identity smoke)
PLANNER_ENGINES = ("shared", "reference")
_DEFAULT_ENGINE = "shared"


def set_default_engine(name: str) -> str:
    """Set the process-wide default planning engine; returns the old one
    (``repro.launch.bench_serving --planner`` drives this)."""
    global _DEFAULT_ENGINE
    if name not in PLANNER_ENGINES:
        raise ValueError(f"unknown planner engine {name!r}; "
                         f"choose from {PLANNER_ENGINES}")
    old, _DEFAULT_ENGINE = _DEFAULT_ENGINE, name
    return old


def default_engine() -> str:
    return _DEFAULT_ENGINE


@dataclasses.dataclass(frozen=True, order=True)
class InstanceGroup:
    """``i`` identical instances, each with ``t`` threads/chips and batch ``b``."""

    i: int
    t: int
    b: int

    def __str__(self) -> str:  # ⟨i, t, b⟩ like the paper
        return f"<{self.i},{self.t},{self.b}>"


@dataclasses.dataclass(frozen=True)
class PackratConfig:
    """A full ⟨i,t,b⟩ configuration (paper's configuration list)."""

    groups: Tuple[InstanceGroup, ...]
    latency: float  # expected makespan (max over instances), seconds

    @property
    def total_threads(self) -> int:
        return sum(g.i * g.t for g in self.groups)

    @property
    def total_batch(self) -> int:
        return sum(g.i * g.b for g in self.groups)

    @property
    def n_instances(self) -> int:
        return sum(g.i for g in self.groups)

    @property
    def is_uniform(self) -> bool:
        return len(self.groups) <= 1

    @property
    def throughput(self) -> float:
        """Items/second of the steady-state configuration."""
        if self.latency <= 0:
            return _INF
        return self.total_batch / self.latency

    def __str__(self) -> str:
        return "[" + ", ".join(str(g) for g in self.groups) + f"] L={self.latency * 1e3:.2f}ms"


def fat_config(profile: Profile, threads: int, batch: int) -> Optional[PackratConfig]:
    """The paper's baseline ⟨1, T, B⟩ configuration, if profiled."""
    lat = profile.get((threads, batch))
    if lat is None:
        return None
    return PackratConfig(groups=(InstanceGroup(1, threads, batch),), latency=lat)


def one_thread_per_core_config(
    profile: Profile, threads: int, batch: int
) -> Optional[PackratConfig]:
    """The ⟨T, 1, B/T⟩ strawman from paper Fig. 7 (T single-threaded instances)."""
    if batch % threads:
        return None
    lat = profile.get((1, batch // threads))
    if lat is None:
        return None
    return PackratConfig(
        groups=(InstanceGroup(threads, 1, batch // threads),), latency=lat
    )


# --------------------------------------------------------------------- #
# shared DP table
# --------------------------------------------------------------------- #
def plan_fingerprint(profile: Profile, allow_unused_threads: bool) -> tuple:
    """Hashable identity of one planning state: the exact item set plus
    the constraint relaxation.  Two optimizers with equal fingerprints
    may safely share a :class:`PlanTable` (``dispatch_overhead`` is
    applied after backtracking and never enters the table)."""
    return (bool(allow_unused_threads), tuple(sorted(profile.items())))


def _backtrack_groups(opt: np.ndarray, choice: np.ndarray,
                      items: Sequence[Tuple[int, int, float]],
                      T: int, B: int) -> List[InstanceGroup]:
    """Recover the ⟨i,t,b⟩ groups from a filled DP table (shared by the
    shared-table and reference engines — the tie-break order is the
    table's, so both produce identical group lists)."""
    counts: Dict[Tuple[int, int], int] = {}
    t, b = T, B
    while t > 0 or b > 0:
        k = int(choice[t, b])
        if k == -2:  # slack step (allow_unused_threads)
            t -= 1
            continue
        assert k >= 0, f"backtrack hit unreachable state ({t},{b})"
        tp, bp, _ = items[k]
        counts[(tp, bp)] = counts.get((tp, bp), 0) + 1
        t -= tp
        b -= bp
    groups = [
        InstanceGroup(i=c, t=tp, b=bp)
        for (tp, bp), c in sorted(counts.items(), key=lambda kv: (-kv[0][0], -kv[0][1]))
    ]
    return groups


class PlanTable:
    """One profile's shared ``opt``/``choice`` DP table plus its ⟨T,B⟩
    plan cache.

    The table is built lazily and grows **geometrically**: a query
    beyond the current bounds doubles the exceeded axis (at least to the
    query), so a rising sweep of probes — the SLO power-of-two sweep,
    the λ-binary-search — costs at most ~2× one build at the largest
    bounds, and every later query inside the bounds is an O(groups)
    backtrack.  Cell values are bit-identical to a per-query build of
    exactly that cell's ⟨t,b⟩ (an item only reaches cells it fits in,
    and the strict-improvement update preserves the reference solver's
    sorted-item tie-break), which is what lets one table answer every
    smaller query.

    Plans are memoised per exact ⟨T,B⟩ in :attr:`_plans` — the
    cross-optimizer plan cache: tenants and fleet nodes sharing the
    table (same profile fingerprint) share solved plans too.
    """

    def __init__(self, profile: Profile, allow_unused_threads: bool, *,
                 fingerprint: Optional[tuple] = None) -> None:
        self.items: List[Tuple[int, int, float]] = sorted(
            (t, b, lat) for (t, b), lat in profile.items())
        self.allow_unused_threads = bool(allow_unused_threads)
        self.fingerprint = (fingerprint if fingerprint is not None
                            else plan_fingerprint(profile,
                                                  allow_unused_threads))
        self._item_t = np.array([it[0] for it in self.items], dtype=np.int64)
        self._item_b = np.array([it[1] for it in self.items], dtype=np.int64)
        self._item_l = np.array([it[2] for it in self.items], dtype=np.float64)
        # the first build covers at least the profile's own ⟨t,b⟩ extent:
        # queries inside the profiled grid are the common case, and
        # flooring there turns an ascending probe sweep's ~log(T·B)
        # doubling rebuilds into one build
        self._floor_t = int(self._item_t.max())
        self._floor_b = int(self._item_b.max())
        self.T = 0
        self.B = 0
        self._opt: Optional[np.ndarray] = None
        self._choice: Optional[np.ndarray] = None
        # counters (surface in planner reports / BENCH planning rows)
        self.builds = 0          # full table (re)builds
        self.cells_built = 0     # Σ cells over all builds
        self.backtracks = 0      # plans recovered by walking the table
        self.plan_hits = 0       # plans answered from the ⟨T,B⟩ memo
        self._plans: Dict[Tuple[int, int],
                          Tuple[Tuple[InstanceGroup, ...], float]] = {}

    # ------------------------------------------------------------------ #
    def fits(self, threads: int, batch: int) -> bool:
        """Whether any profiled item fits within ⟨T,B⟩ at all."""
        return bool(np.any((self._item_t <= threads)
                           & (self._item_b <= batch)))

    def ensure(self, threads: int, batch: int) -> None:
        """Grow the table to cover ⟨threads, batch⟩ (geometric growth)."""
        if (self._opt is not None and threads <= self.T
                and batch <= self.B):
            return
        T, B = self.T, self.B
        if threads > T:
            T = max(threads, self._floor_t, 2 * T)
        if batch > B:
            B = max(batch, self._floor_b, 2 * B)
        self._build(T, B)

    def _build(self, T: int, B: int) -> None:
        """The §3.3 recurrence over the full ⟨T,B⟩ grid — the identical
        numpy update sequence as the reference per-query solver, so
        every cell ``(t, b)`` equals a dedicated ``(t, b)`` build."""
        opt = np.full((T + 1, B + 1), _INF, dtype=np.float64)
        opt[0, 0] = 0.0
        choice = np.full((T + 1, B + 1), -1, dtype=np.int32)
        item_t, item_b, item_l = self._item_t, self._item_b, self._item_l
        fits_b = item_b <= B
        for t in range(1, T + 1):
            row = opt[t]
            ch = choice[t]
            usable = np.nonzero((item_t <= t) & fits_b)[0]
            for k in usable:
                tp = int(item_t[k])
                bp = int(item_b[k])
                lat = item_l[k]
                # candidate[b] = max(opt[t - tp, b - bp], lat) for b >= bp
                prev = opt[t - tp, : B + 1 - bp]
                cand = np.maximum(prev, lat)
                seg = row[bp:]
                better = cand < seg
                if better.any():
                    seg[better] = cand[better]
                    ch[bp:][better] = k
            if self.allow_unused_threads:
                # opt[t, b] may fall back to opt[t-1, b] (leave a thread idle).
                better = opt[t - 1] < row
                if better.any():
                    row[better] = opt[t - 1][better]
                    # mark slack with choice -2 so backtracking walks down t.
                    ch[better] = -2
        self._opt, self._choice = opt, choice
        self.T, self.B = T, B
        self.builds += 1
        self.cells_built += (T + 1) * (B + 1)

    # ------------------------------------------------------------------ #
    def makespan(self, threads: int, batch: int) -> float:
        """The optimal makespan at exactly ⟨threads, batch⟩ (``inf``
        when infeasible) — a feasibility probe with no backtrack."""
        self.ensure(threads, batch)
        return float(self._opt[threads, batch])

    def plan(self, threads: int, batch: int
             ) -> Tuple[Tuple[InstanceGroup, ...], float]:
        """The optimal ``(groups, makespan)`` at exactly ⟨threads,
        batch⟩, memoised across every optimizer sharing this table."""
        key = (threads, batch)
        got = self._plans.get(key)
        if got is not None:
            self.plan_hits += 1
            return got
        self.ensure(threads, batch)
        if not np.isfinite(self._opt[threads, batch]):
            raise ValueError(
                f"(T={threads}, B={batch}) infeasible with profiled items "
                f"{[(t, b) for t, b, _ in self.items]}"
            )
        groups = _backtrack_groups(self._opt, self._choice, self.items,
                                   threads, batch)
        self.backtracks += 1
        entry = (tuple(groups), float(self._opt[threads, batch]))
        self._plans[key] = entry
        return entry

    def report(self) -> Dict[str, object]:
        return {
            "bounds": [self.T, self.B],
            "builds": self.builds,
            "cells_built": self.cells_built,
            "backtracks": self.backtracks,
            "plan_cache_hits": self.plan_hits,
            "plans_cached": len(self._plans),
        }


class PlanTableRegistry:
    """Interns :class:`PlanTable` objects by profile fingerprint so
    same-profile optimizers share one table and plan cache.

    The multi-model resource plane keys one registry per server (shared
    across tenants), the cluster fabric one per router (shared across
    homogeneous nodes); an optimizer built without one gets a private
    registry.  Bounded LRU: calibration epochs keep minting new
    fingerprints, and evicting an old epoch's table only drops
    *sharing* — any optimizer still holding it keeps it alive.
    """

    def __init__(self, max_tables: int = 16) -> None:
        if max_tables < 1:
            raise ValueError(f"max_tables must be >= 1, got {max_tables}")
        self.max_tables = max_tables
        self._tables: "collections.OrderedDict[tuple, PlanTable]" = \
            collections.OrderedDict()

    def table_for(self, profile: Profile,
                  allow_unused_threads: bool) -> PlanTable:
        fp = plan_fingerprint(profile, allow_unused_threads)
        table = self._tables.get(fp)
        if table is None:
            table = PlanTable(profile, allow_unused_threads, fingerprint=fp)
            self._tables[fp] = table
            self._evict()
        else:
            self._tables.move_to_end(fp)
        return table

    def intern(self, table: PlanTable) -> PlanTable:
        """Adopt ``table`` unless an equal-fingerprint one is already
        registered (in which case the registered one wins — that is the
        sharing)."""
        got = self._tables.get(table.fingerprint)
        if got is not None:
            self._tables.move_to_end(table.fingerprint)
            return got
        self._tables[table.fingerprint] = table
        self._evict()
        return table

    def _evict(self) -> None:
        while len(self._tables) > self.max_tables:
            self._tables.popitem(last=False)

    def __len__(self) -> int:
        return len(self._tables)

    def tables(self) -> List[PlanTable]:
        return list(self._tables.values())


class PackratOptimizer:
    """The DP optimizer with the paper's memoised ⟨T,B⟩ result cache (§3.3).

    ``engine="shared"`` (default) answers queries out of a
    :class:`PlanTable`; ``engine="reference"`` retains the original
    per-query DP.  Both produce bit-identical configurations.
    """

    def __init__(
        self,
        profile: Profile,
        *,
        allow_unused_threads: bool = False,
        dispatch_overhead: float = 0.0,
        engine: Optional[str] = None,
        registry: Optional[PlanTableRegistry] = None,
    ) -> None:
        """``allow_unused_threads`` relaxes Σt_j = T to Σt_j ≤ T (beyond-paper;
        useful when the profile is non-monotone in t).  ``dispatch_overhead``
        is added per instance *count* to model per-instance dispatch cost.
        ``engine`` picks the planning engine (default: the process-wide
        :func:`default_engine`); ``registry`` shares DP tables with
        same-profile peers (tenants, fleet nodes).
        """
        self._validate(profile)
        self.profile: Dict[Tuple[int, int], float] = dict(profile)
        self.allow_unused_threads = allow_unused_threads
        self.dispatch_overhead = float(dispatch_overhead)
        self.engine = engine if engine is not None else _DEFAULT_ENGINE
        if self.engine not in PLANNER_ENGINES:
            raise ValueError(f"unknown planner engine {self.engine!r}; "
                             f"choose from {PLANNER_ENGINES}")
        self.registry = (registry if registry is not None
                         else PlanTableRegistry())
        self.epoch = 0            # bumped by every update_profile()
        self.solves = 0           # queries answered by the engine
        self.cache_hits = 0       # queries answered from the ⟨T,B⟩ memo
        self.slo_sweeps = 0       # solve_with_slo invocations
        self.slo_probes_saved = 0 # probes skipped by the monotone bound
        self._cache: Dict[Tuple[int, int], PackratConfig] = {}
        self._monotone: Optional[bool] = None
        self._rows_sorted: Optional[Dict[int, Tuple[List[int], List[float]]]] = None
        self._table: Optional[PlanTable] = None
        if self.engine == "shared":
            self._table = self.registry.table_for(self.profile,
                                                  allow_unused_threads)

    @staticmethod
    def _validate(profile: Profile) -> None:
        if not profile:
            raise ValueError("empty profile")
        for (t, b), lat in profile.items():
            if t < 1 or b < 1:
                raise ValueError(f"profiled item ({t},{b}) must have t,b >= 1")
            if not (lat >= 0):
                raise ValueError(f"profiled latency for ({t},{b}) is {lat!r}")

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def solve(self, threads: int, batch: int) -> PackratConfig:
        """Optimal ⟨i,t,b⟩ configuration for a ⟨T, B⟩ knapsack."""
        key = (threads, batch)
        got = self._cache.get(key)
        if got is not None:
            self.cache_hits += 1
            return got
        self.solves += 1
        if self.engine == "reference":
            cfg = self._solve_uncached(threads, batch)
        else:
            cfg = self._solve_shared(threads, batch)
        self._cache[key] = cfg
        return cfg

    def try_solve(self, threads: int, batch: int) -> Optional[PackratConfig]:
        """:meth:`solve`, or ``None`` when ⟨T,B⟩ is infeasible — the
        probe entry point for sweeps and binary searches, which before
        this used per-probe ``ValueError`` control flow."""
        if threads < 1 or batch < 1:
            return None
        got = self._cache.get((threads, batch))
        if got is not None:
            self.cache_hits += 1
            return got
        if self._table is not None and not math.isfinite(
                self._table.makespan(threads, batch)):
            # opt[T,B] is inf both when no item fits and when the exact
            # sums are unreachable — one probe covers both failure modes
            return None
        try:
            return self.solve(threads, batch)
        except ValueError:
            return None

    def solve_all(self, threads: int, batches: Iterable[int]) -> Dict[int, PackratConfig]:
        return {b: self.solve(threads, b) for b in batches}

    def predicted_speedup(self, threads: int, batch: int) -> float:
        """Expected speedup of the chosen config over the fat ⟨1,T,B⟩ baseline."""
        base = fat_config(self.profile, threads, batch)
        if base is None:
            raise KeyError(f"fat configuration ({threads},{batch}) not profiled")
        chosen = self.solve(threads, batch)
        return base.latency / chosen.latency if chosen.latency > 0 else _INF

    # ------------------------------------------------------------------ #
    # calibration epochs
    # ------------------------------------------------------------------ #
    def update_profile(self, new_profile: Profile) -> None:
        """Swap the planning costs in place (a calibration epoch).

        Bumps :attr:`epoch`, drops the per-optimizer ⟨T,B⟩ memo, and
        re-interns the shared table for the new fingerprint — the table
        is rebuilt **once**, lazily at the bounds the next query needs,
        instead of the old discard-the-optimizer-and-its-cache cycle.
        Same-epoch peers (another tenant calibrated to the same costs)
        land on the same table via the registry.
        """
        self._validate(new_profile)
        self.profile = dict(new_profile)
        self.epoch += 1
        self._cache.clear()
        self._monotone = None
        self._rows_sorted = None
        if self.engine == "shared":
            self._table = self.registry.table_for(self.profile,
                                                  self.allow_unused_threads)

    def adopt_registry(self, registry: PlanTableRegistry) -> None:
        """Re-intern this optimizer's table into ``registry`` so
        same-profile peers (multi-model tenants, homogeneous fleet
        nodes) share one DP table and plan cache.  No-op for the
        reference engine."""
        self.registry = registry
        if self._table is not None:
            self._table = registry.intern(self._table)

    def plan_key(self) -> tuple:
        """Cheap hashable identity of the planning inputs — what a plan
        memo above the optimizer (the fabric's overload planner) should
        key on.  Equal keys guarantee equal solve results."""
        if self._table is not None:
            fp = self._table.fingerprint
        else:
            fp = plan_fingerprint(self.profile, self.allow_unused_threads)
        return (fp, self.dispatch_overhead)

    # ------------------------------------------------------------------ #
    # monotone SLO bound (solve_with_slo's early exit)
    # ------------------------------------------------------------------ #
    @property
    def latency_monotone_in_b(self) -> bool:
        """Whether every profiled thread row has nondecreasing latency
        in b — the property that makes :meth:`slo_latency_floor` a valid
        lower bound (true for real profiles: bigger batches never get
        cheaper in absolute time)."""
        if self._monotone is None:
            mono = True
            for _, (bs, lats) in self._rows().items():
                for a, b in zip(lats, lats[1:]):
                    if b < a:
                        mono = False
                        break
                if not mono:
                    break
            self._monotone = mono
        return self._monotone

    def _rows(self) -> Dict[int, Tuple[List[int], List[float]]]:
        if self._rows_sorted is None:
            rows: Dict[int, List[Tuple[int, float]]] = {}
            for (t, b), lat in self.profile.items():
                rows.setdefault(t, []).append((b, lat))
            self._rows_sorted = {}
            for t, pairs in rows.items():
                pairs.sort()
                self._rows_sorted[t] = ([b for b, _ in pairs],
                                        [lat for _, lat in pairs])
        return self._rows_sorted

    def slo_latency_floor(self, threads: int, batch: int) -> float:
        """Provable lower bound on the makespan of *any* exact-``batch``
        configuration within ``threads`` units, valid when
        :attr:`latency_monotone_in_b`.

        Every config has at most ``threads`` instances (each takes
        ``t ≥ 1``), so some instance serves ``≥ ceil(batch/threads)``
        items; with monotone rows its latency is at least the cheapest
        profiled cell hosting that many.  Nondecreasing in ``batch``,
        so the SLO sweep may stop at the first probe whose floor
        exceeds the deadline (``inf`` ⇒ provably infeasible too).
        """
        need = -(-batch // threads)
        best = _INF
        for t, (bs, lats) in self._rows().items():
            if t > threads:
                continue
            idx = bisect.bisect_left(bs, need)
            if idx < len(bs) and lats[idx] < best:
                best = lats[idx]
        return best

    # ------------------------------------------------------------------ #
    # instrumentation
    # ------------------------------------------------------------------ #
    def planner_report(self) -> Dict[str, object]:
        """JSON-serializable solver counters (bench ``planning`` rows)."""
        rep: Dict[str, object] = {
            "engine": self.engine,
            "epoch": self.epoch,
            "solves": self.solves,
            "solve_cache_hits": self.cache_hits,
            "slo_sweeps": self.slo_sweeps,
            "slo_probes_saved": self.slo_probes_saved,
        }
        if self._table is not None:
            rep["table"] = self._table.report()
        return rep

    # ------------------------------------------------------------------ #
    # shared-table engine
    # ------------------------------------------------------------------ #
    def _solve_shared(self, threads: int, batch: int) -> PackratConfig:
        if threads < 1 or batch < 1:
            raise ValueError(f"need T >= 1 and B >= 1, got T={threads}, B={batch}")
        table = self._table
        try:
            groups, makespan = table.plan(threads, batch)
        except ValueError:
            # match the reference engine's error split: no fitting item
            # at all vs. exact ⟨T,B⟩ sums unreachable
            if not table.fits(threads, batch):
                raise ValueError(
                    f"no profiled configuration fits within "
                    f"(T={threads}, B={batch})") from None
            raise
        latency = makespan + self.dispatch_overhead * sum(g.i for g in groups)
        return PackratConfig(groups=groups, latency=latency)

    # ------------------------------------------------------------------ #
    # reference engine: the original per-query DP, retained verbatim as
    # the equivalence oracle (tests/test_planning.py, CI byte-identity)
    # ------------------------------------------------------------------ #
    def _solve_uncached(self, threads: int, batch: int) -> PackratConfig:
        if threads < 1 or batch < 1:
            raise ValueError(f"need T >= 1 and B >= 1, got T={threads}, B={batch}")
        items = sorted(
            (t, b, lat)
            for (t, b), lat in self.profile.items()
            if t <= threads and b <= batch
        )
        if not items:
            raise ValueError(
                f"no profiled configuration fits within (T={threads}, B={batch})"
            )

        T, B = threads, batch
        # opt[t, b]: minimal makespan to process exactly b items on exactly t
        # threads (or <= t threads when slack is allowed).
        opt = np.full((T + 1, B + 1), _INF, dtype=np.float64)
        opt[0, 0] = 0.0
        # choice[t, b] = index into `items` of the last instance added; -1 = none.
        choice = np.full((T + 1, B + 1), -1, dtype=np.int32)

        item_t = np.array([it[0] for it in items], dtype=np.int64)
        item_b = np.array([it[1] for it in items], dtype=np.int64)
        item_l = np.array([it[2] for it in items], dtype=np.float64)

        for t in range(1, T + 1):
            row = opt[t]
            ch = choice[t]
            usable = np.nonzero(item_t <= t)[0]
            for k in usable:
                tp = int(item_t[k])
                bp = int(item_b[k])
                lat = item_l[k]
                # candidate[b] = max(opt[t - tp, b - bp], lat) for b >= bp
                prev = opt[t - tp, : B + 1 - bp]
                cand = np.maximum(prev, lat)
                seg = row[bp:]
                better = cand < seg
                if better.any():
                    seg[better] = cand[better]
                    ch[bp:][better] = k
            if self.allow_unused_threads:
                # opt[t, b] may fall back to opt[t-1, b] (leave a thread idle).
                better = opt[t - 1] < row
                if better.any():
                    row[better] = opt[t - 1][better]
                    # mark slack with choice -2 so backtracking walks down t.
                    ch[better] = -2

        if not np.isfinite(opt[T, B]):
            raise ValueError(
                f"(T={T}, B={B}) infeasible with profiled items "
                f"{sorted(self.profile)}"
            )

        groups = _backtrack_groups(opt, choice, items, T, B)
        latency = float(opt[T, B]) + self.dispatch_overhead * sum(g.i for g in groups)
        return PackratConfig(groups=tuple(groups), latency=latency)


def planning_report(optimizers: Iterable[PackratOptimizer]
                    ) -> Dict[str, object]:
    """Aggregate solver counters across a control plane's optimizers.

    Shared tables are deduplicated by identity so a table serving N
    tenants/nodes is counted once; the plan-cache hit rate is hits over
    all plan recoveries (hits + backtracks)."""
    opts: List[PackratOptimizer] = []
    seen: set = set()
    for opt in optimizers:
        if id(opt) not in seen:
            seen.add(id(opt))
            opts.append(opt)
    engines = sorted({o.engine for o in opts})
    tables: List[PlanTable] = []
    tseen: set = set()
    for o in opts:
        if o._table is not None and id(o._table) not in tseen:
            tseen.add(id(o._table))
            tables.append(o._table)
    solves = sum(o.solves for o in opts)
    cache_hits = sum(o.cache_hits for o in opts)
    backtracks = sum(t.backtracks for t in tables)
    plan_hits = sum(t.plan_hits for t in tables)
    return {
        "engine": engines[0] if len(engines) == 1 else "mixed",
        "optimizers": len(opts),
        "epochs": sum(o.epoch for o in opts),
        "solves": solves,
        "solve_cache_hits": cache_hits,
        "solve_cache_hit_rate": round(
            cache_hits / max(1, solves + cache_hits), 4),
        "slo_sweeps": sum(o.slo_sweeps for o in opts),
        "slo_probes_saved": sum(o.slo_probes_saved for o in opts),
        "tables": len(tables),
        "table_builds": sum(t.builds for t in tables),
        "table_cells_built": sum(t.cells_built for t in tables),
        "plan_backtracks": backtracks,
        "plan_cache_hits": plan_hits,
        "plan_cache_hit_rate": round(
            plan_hits / max(1, plan_hits + backtracks), 4),
    }


@dataclasses.dataclass(frozen=True)
class FidelityRung:
    """One rung of a model's fidelity ladder.

    ``rung`` 0 is the full-fidelity model; higher rungs are cheaper
    variants (fewer layers / narrower widths) of the same architecture.
    ``quality`` is the rung's relative output quality in ``(0, 1]``
    (1.0 at the top) — the weight used by goodput-at-fidelity metrics.
    ``profile`` is the rung's own measured ⟨t,b⟩ → latency table.
    """

    rung: int
    name: str
    quality: float
    profile: Dict[Tuple[int, int], float]


class FidelityLadder:
    """An ordered ladder of per-rung planners over one shared registry.

    This is the PlanTable's fidelity axis: each rung owns a
    :class:`PackratOptimizer` built on the rung's profile, and all rungs
    intern their DP tables into **one** :class:`PlanTableRegistry`, so a
    fleet of nodes degrading independently still shares one table per
    ⟨rung profile, relaxation⟩ fingerprint.  The top rung's optimizer is
    constructed from exactly the same inputs as a ladder-free planner —
    same profile dict, engine, overhead, registry protocol — so
    reference-engine solves at rung 0 stay bit-identical to today's
    plans (pinned by tests/test_planning.py).
    """

    def __init__(
        self,
        rungs: Sequence[FidelityRung],
        *,
        allow_unused_threads: bool = False,
        dispatch_overhead: float = 0.0,
        engine: Optional[str] = None,
        registry: Optional[PlanTableRegistry] = None,
    ) -> None:
        if not rungs:
            raise ValueError("empty fidelity ladder")
        for i, r in enumerate(rungs):
            if r.rung != i:
                raise ValueError(f"rung {i} carries index {r.rung}; ladders "
                                 f"are listed top (full fidelity) first")
            if not (0.0 < r.quality <= 1.0):
                raise ValueError(f"rung {r.name!r} quality {r.quality!r} "
                                 f"outside (0, 1]")
        if rungs[0].quality != 1.0:
            raise ValueError("top rung must have quality 1.0")
        for a, b in zip(rungs, rungs[1:]):
            if b.quality > a.quality:
                raise ValueError(f"quality must not increase down the "
                                 f"ladder ({a.name!r} -> {b.name!r})")
        self.rungs: Tuple[FidelityRung, ...] = tuple(rungs)
        self.registry = registry if registry is not None else PlanTableRegistry()
        self.optimizers: List[PackratOptimizer] = [
            PackratOptimizer(r.profile,
                             allow_unused_threads=allow_unused_threads,
                             dispatch_overhead=dispatch_overhead,
                             engine=engine, registry=self.registry)
            for r in self.rungs
        ]

    def __len__(self) -> int:
        return len(self.rungs)

    def optimizer(self, rung: int) -> PackratOptimizer:
        return self.optimizers[rung]

    def quality(self, rung: int) -> float:
        return self.rungs[rung].quality

    def name(self, rung: int) -> str:
        return self.rungs[rung].name

    def update_profile(self, rung: int, new_profile: Profile) -> None:
        """A calibration epoch for one rung (measured costs drifted);
        other rungs' tables and memos are untouched."""
        self.optimizers[rung].update_profile(new_profile)

    def adopt_registry(self, registry: PlanTableRegistry) -> None:
        """Re-intern every rung's table into ``registry`` (the fabric
        adopts node ladders into its fleet-wide registry)."""
        self.registry = registry
        for opt in self.optimizers:
            opt.adopt_registry(registry)

    def plan_key(self) -> tuple:
        """Hashable identity of the whole ladder's planning inputs —
        equal keys guarantee equal per-rung solve results."""
        return tuple(opt.plan_key() for opt in self.optimizers)

    def solve_with_fidelity(
        self, threads: int, latency_slo: float, *, max_batch: int = 1 << 16,
    ) -> Optional[Tuple[int, int, PackratConfig]]:
        """Highest-fidelity rung whose makespan fits the SLO.

        Scans rungs top-down; each probe is the SLO-constrained
        power-of-two sweep (:func:`~repro.core.multimodel.solve_with_slo`)
        over that rung's shared table.  Returns ``(rung, batch, config)``
        for the first feasible rung — i.e. the *cheapest acceptable
        degradation is none at all* when rung 0 fits — or ``None`` when
        even the bottom rung cannot meet the SLO (the caller falls back
        to batch-floor degradation and shedding).
        """
        from .multimodel import solve_with_slo  # deferred: core↔core cycle
        for rung, opt in enumerate(self.optimizers):
            got = solve_with_slo(opt, threads, latency_slo,
                                 max_batch=max_batch)
            if got is not None:
                return (rung, got[0], got[1])
        return None

    def report(self) -> Dict[str, object]:
        return {
            "rungs": [
                {"rung": r.rung, "name": r.name, "quality": r.quality,
                 "epoch": opt.epoch, "solves": opt.solves}
                for r, opt in zip(self.rungs, self.optimizers)
            ],
        }


def solve_phase_split(
    phase_optimizers: Mapping[str, PackratOptimizer],
    phase_batches: Mapping[str, int],
    total_units: int,
    *,
    min_units: int = 1,
) -> Optional[Dict[str, object]]:
    """Phase-split unit allocation for autoregressive serving.

    An LM server runs two pools with opposite resource profiles —
    compute-bound **prefill** and memory-bound **decode** — against one
    unit budget.  This enumerates every split ``u_a + u_b =
    total_units`` (each ≥ ``min_units``), solves each phase's knapsack
    against its *own* per-phase profile at its *own* estimated batch
    (:class:`~repro.core.estimator.PhaseEstimator`), and returns the
    split minimizing the worse phase makespan — the bottleneck phase
    bounds both TTFT (prefill) and TPOT (decode), so minimizing the max
    is minimizing whichever tail the user hits.

    Each probe goes through :meth:`PackratOptimizer.try_solve`, so the
    sweep rides the shared-table engine: one table build per phase, then
    O(groups) backtracks.  Returns ``{"units": {phase: u}, "configs":
    {phase: PackratConfig}, "objective": worst_latency}`` or ``None``
    when no split is feasible.  Ties break toward giving the
    first-listed phase fewer units (deterministic).
    """
    phases = list(phase_optimizers)
    if len(phases) != 2:
        raise ValueError(f"solve_phase_split plans exactly two phases, "
                         f"got {phases}")
    if set(phase_batches) != set(phases):
        raise ValueError(f"phase_batches keys {sorted(phase_batches)} != "
                         f"optimizer phases {sorted(phases)}")
    if min_units < 1:
        raise ValueError(f"min_units must be >= 1, got {min_units}")
    if total_units < 2 * min_units:
        return None
    p0, p1 = phases
    best: Optional[Dict[str, object]] = None
    for u0 in range(min_units, total_units - min_units + 1):
        u1 = total_units - u0
        c0 = phase_optimizers[p0].try_solve(u0, phase_batches[p0])
        if c0 is None:
            continue
        c1 = phase_optimizers[p1].try_solve(u1, phase_batches[p1])
        if c1 is None:
            continue
        objective = max(c0.latency, c1.latency)
        if best is None or objective < best["objective"]:
            best = {
                "units": {p0: u0, p1: u1},
                "configs": {p0: c0, p1: c1},
                "objective": objective,
            }
    return best


def brute_force_solve(
    profile: Profile, threads: int, batch: int, *, allow_unused_threads: bool = False
) -> Optional[PackratConfig]:
    """Exhaustive reference solver (exponential; only for tests on tiny T, B).

    Enumerates multisets of profiled items whose (t, b) sums hit (T, B)
    exactly (or Σt ≤ T with slack) and returns the min-makespan one.
    """
    items = sorted(
        (t, b, lat) for (t, b), lat in profile.items() if t <= threads and b <= batch
    )
    best: Optional[Tuple[float, Dict[Tuple[int, int], int]]] = None

    def rec(idx: int, t_left: int, b_left: int, cur_max: float,
            used: Dict[Tuple[int, int], int]) -> None:
        nonlocal best
        if b_left == 0 and (t_left == 0 or allow_unused_threads):
            if best is None or cur_max < best[0]:
                best = (cur_max, dict(used))
            return
        if idx >= len(items) or b_left < 0 or t_left <= 0:
            return
        t, b, lat = items[idx]
        max_count = min(t_left // t, b_left // b)
        for c in range(max_count, -1, -1):
            if c:
                used[(t, b)] = c
            rec(idx + 1, t_left - c * t, b_left - c * b, max(cur_max, lat) if c else cur_max, used)
            used.pop((t, b), None)

    rec(0, threads, batch, 0.0, {})
    if best is None:
        return None
    lat, counts = best
    groups = tuple(
        InstanceGroup(i=c, t=t, b=b)
        for (t, b), c in sorted(counts.items(), key=lambda kv: (-kv[0][0], -kv[0][1]))
    )
    return PackratConfig(groups=groups, latency=lat)


def powers_of_two(limit: int) -> List[int]:
    """[1, 2, 4, …, <= limit] — the paper's profiled batch grid (§3.2)."""
    if limit < 1:
        return []
    return [1 << k for k in range(limit.bit_length()) if (1 << k) <= limit]


def next_power_of_two(b: int) -> int:
    """Smallest power of two >= b (>= 1): the compiled-bucket rounding
    shared by every real-execution path (servers pad partial batches to
    compiled bucket sizes rather than recompiling per size)."""
    return 1 << max(0, (b - 1)).bit_length()


def profile_grid(threads: int, max_batch: int, *, thread_values: Optional[Sequence[int]] = None
                 ) -> List[Tuple[int, int]]:
    """The ⟨t,b⟩ grid Packrat profiles: t ∈ {1..T} × b ∈ powers of two (§3.2).

    ``thread_values`` overrides the thread axis (e.g. powers of two for
    TPU sub-mesh sizes, where t must be a divisor of the mesh).
    """
    ts = list(thread_values) if thread_values is not None else list(range(1, threads + 1))
    return [(t, b) for t in ts for b in powers_of_two(max_batch)]

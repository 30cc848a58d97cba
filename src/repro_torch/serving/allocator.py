"""Resource allocator (paper §3.4): chip/core assignment for instances.

Assigns each instance a *contiguous* run of compute units and never
splits an instance across locality domains (CPU sockets in the paper;
TPU pods here) unless unavoidable — the paper's NUMA rule (§7) carries
over directly because cross-pod ICI hops behave like cross-socket QPI.
Resources are statically pinned for an instance's lifetime; the
allocator tracks idle/busy units so active-passive scaling can
temporarily oversubscribe (paper Fig. 11's transient).

Multi-model serving adds a layer above: a :class:`ResourcePool` owns the
full unit set and grants each model *tenant* a :class:`UnitLease` — a
disjoint contiguous span with its own :class:`ResourceAllocator` scoped
to those units.  Re-splitting the pool (the controller's planning step,
see ``serving/tenancy.py``) hands tenants fresh leases; draining worker
sets keep releasing against the allocator that placed them, so a resize
never corrupts occupancy accounting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.knapsack import PackratConfig


@dataclasses.dataclass(frozen=True)
class Placement:
    instance_id: int
    threads: int
    batch: int
    units: Tuple[int, ...]          # global unit (core/chip) ids

    @property
    def domain(self) -> int:
        return -1 if not self.units else self.units[0] // _DOMAIN_SENTINEL


_DOMAIN_SENTINEL = 1 << 30  # replaced per-allocator; see domain_of()


class AllocationError(RuntimeError):
    pass


class ResourceAllocator:
    """Tracks unit occupancy across locality domains.

    ``domain_size`` = units per socket/pod.  ``oversubscribe`` permits a
    second allocation epoch to coexist (active-passive scale-up); the
    paper notes reconfiguration transiently oversubscribes resources.
    """

    def __init__(self, total_units: int, domain_size: Optional[int] = None,
                 *, oversubscribe_factor: int = 2,
                 units: Optional[Sequence[int]] = None) -> None:
        """``units`` scopes the allocator to a subset of *global* unit ids
        (a tenant's lease); by default it manages ``range(total_units)``.
        Domain membership is always computed from the global id, so a
        lease never blurs socket/pod boundaries."""
        if units is None:
            if total_units < 1:
                raise ValueError("total_units must be >= 1")
            self.domain_size = domain_size or total_units
            if self.domain_size < 1 or total_units % self.domain_size:
                raise ValueError("domain_size must divide total_units")
            self._units: Tuple[int, ...] = tuple(range(total_units))
        else:
            if not units:
                raise ValueError("units must be non-empty")
            self._units = tuple(sorted(units))
            if len(set(self._units)) != len(self._units):
                raise ValueError("duplicate unit ids in lease")
            self.domain_size = domain_size or (self._units[-1] + 1)
            if self.domain_size < 1:
                raise ValueError("domain_size must be >= 1")
        self.total_units = len(self._units)
        self.oversubscribe_factor = oversubscribe_factor
        self._occupancy: Dict[int, int] = {u: 0 for u in self._units}
        self._next_instance = 0

    # ------------------------------------------------------------------ #
    @property
    def units(self) -> Tuple[int, ...]:
        return self._units

    def domain_of(self, unit: int) -> int:
        return unit // self.domain_size

    def _find_run(self, n: int, max_occupancy: int) -> Optional[List[int]]:
        """Contiguous run of n units within one domain at given occupancy."""
        run: List[int] = []
        for u in self._units:
            if (run and (u != run[-1] + 1
                         or self.domain_of(u) != self.domain_of(run[0]))):
                run = []
            if self._occupancy[u] <= max_occupancy:
                run.append(u)
                if len(run) == n:
                    return run
            else:
                run = []
        return None

    def _find_spanning_run(self, n: int, max_occupancy: int
                           ) -> Optional[List[int]]:
        run: List[int] = []
        for u in self._units:
            if run and u != run[-1] + 1:
                run = []
            if self._occupancy[u] <= max_occupancy:
                run.append(u)
                if len(run) == n:
                    return run
            else:
                run = []
        return None

    def allocate(self, config: PackratConfig) -> List[Placement]:
        """Place every instance of a ⟨i,t,b⟩ configuration.

        Prefers idle units and domain-local runs; at most one instance
        may span domains (paper §7).  Raises AllocationError if the
        configuration cannot fit even with oversubscription.
        """
        placements: List[Placement] = []
        spanned = False
        try:
            for group in config.groups:
                for _ in range(group.i):
                    units = None
                    for occ in range(self.oversubscribe_factor):
                        units = self._find_run(group.t, occ)
                        if units is not None:
                            break
                    if units is None and not spanned:
                        for occ in range(self.oversubscribe_factor):
                            units = self._find_spanning_run(group.t, occ)
                            if units is not None:
                                spanned = True
                                break
                    if units is None:
                        raise AllocationError(
                            f"cannot place instance of {group} "
                            f"(T={self.total_units}, oversubscribe="
                            f"{self.oversubscribe_factor})")
                    for u in units:
                        self._occupancy[u] += 1
                    placements.append(Placement(self._next_instance, group.t,
                                                group.b, tuple(units)))
                    self._next_instance += 1
        except AllocationError:
            self.release(placements)
            raise
        return placements

    def release(self, placements: Sequence[Placement]) -> None:
        for p in placements:
            for u in p.units:
                if self._occupancy[u] > 0:
                    self._occupancy[u] -= 1

    @property
    def busy_units(self) -> int:
        return sum(1 for v in self._occupancy.values() if v > 0)

    @property
    def oversubscribed_units(self) -> int:
        return sum(1 for v in self._occupancy.values() if v > 1)

    def spans_domains(self, placement: Placement) -> bool:
        return len({self.domain_of(u) for u in placement.units}) > 1


# --------------------------------------------------------------------- #
# multi-tenant unit pool
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class UnitLease:
    """A tenant's claim on a disjoint contiguous span of the pool.

    The lease's allocator places that tenant's instances *within* the
    span only, and the pool guarantees spans never overlap — so a
    tenant can never *newly place* workers on another tenant's units.
    During a re-split, a shrinking tenant's draining worker set may
    still occupy units that now belong to a neighbour's lease until its
    active-passive drain completes: that is the paper's §3.7 transient
    oversubscription, surfaced across leases, and it is why worker sets
    always release against the allocator that placed them.
    """

    tenant: str
    units: Tuple[int, ...]
    allocator: ResourceAllocator

    @property
    def n_units(self) -> int:
        return len(self.units)


class ResourcePool:
    """Owner of the full unit set; grants disjoint leases to tenants.

    Tenants are laid out in grant order as contiguous spans.  ``split``
    re-partitions the pool according to a {tenant: units} share map —
    the controller's planning step calls it on every re-plan — and
    preserves lease object identity for tenants whose span did not
    move, so their allocators keep live occupancy state.
    """

    def __init__(self, total_units: int,
                 domain_size: Optional[int] = None) -> None:
        if total_units < 1:
            raise ValueError("total_units must be >= 1")
        self.total_units = total_units
        self.domain_size = domain_size or total_units
        if self.domain_size < 1 or total_units % self.domain_size:
            raise ValueError("domain_size must divide total_units")
        self._leases: Dict[str, UnitLease] = {}   # insertion order = layout

    # ------------------------------------------------------------------ #
    def lease_of(self, tenant: str) -> UnitLease:
        return self._leases[tenant]

    @property
    def tenants(self) -> List[str]:
        return list(self._leases)

    @property
    def leased_units(self) -> int:
        return sum(l.n_units for l in self._leases.values())

    def grant(self, tenant: str, n_units: int) -> UnitLease:
        """Lease ``n_units`` to a new tenant, appended after existing spans."""
        if tenant in self._leases:
            raise ValueError(f"tenant {tenant!r} already holds a lease")
        if n_units < 1:
            raise ValueError("n_units must be >= 1")
        offset = self.leased_units
        if offset + n_units > self.total_units:
            raise AllocationError(
                f"cannot lease {n_units} units to {tenant!r}: only "
                f"{self.total_units - offset} of {self.total_units} free")
        lease = self._make_lease(tenant, offset, n_units)
        self._leases[tenant] = lease
        return lease

    def revoke(self, tenant: str) -> None:
        """Drop a tenant's lease (its units become free at the next split)."""
        self._leases.pop(tenant, None)

    def split(self, shares: Mapping[str, int]) -> Dict[str, UnitLease]:
        """Re-partition the pool per ``shares`` (must cover every tenant).

        Spans are laid out in the pool's existing tenant order; a tenant
        whose span is unchanged keeps its lease object (and therefore
        its allocator's occupancy state).  Returns the full new lease
        map; the caller decides which tenants must relocate workers.
        """
        unknown = set(shares) - set(self._leases)
        if unknown:
            raise ValueError(f"unknown tenants in split: {sorted(unknown)}")
        missing = set(self._leases) - set(shares)
        if missing:
            raise ValueError(f"split misses tenants: {sorted(missing)}")
        if any(n < 1 for n in shares.values()):
            raise ValueError("every tenant needs >= 1 unit")
        if sum(shares.values()) > self.total_units:
            raise AllocationError(
                f"shares {dict(shares)} exceed pool of {self.total_units}")
        new: Dict[str, UnitLease] = {}
        offset = 0
        for tenant in self._leases:
            n = shares[tenant]
            span = tuple(range(offset, offset + n))
            old = self._leases[tenant]
            new[tenant] = (old if old.units == span
                           else self._make_lease(tenant, offset, n))
            offset += n
        self._leases = new
        return dict(new)

    # ------------------------------------------------------------------ #
    def _make_lease(self, tenant: str, offset: int, n: int) -> UnitLease:
        span = tuple(range(offset, offset + n))
        alloc = ResourceAllocator(len(span), self.domain_size, units=span)
        return UnitLease(tenant=tenant, units=span, allocator=alloc)

"""Active-passive scaling: zero-downtime reconfiguration (paper §3.7, Fig. 5).

For each model Packrat keeps two versions: the *active* set (serving
under the current ⟨i,t,b⟩ configuration) and a *passive* set (zero
workers).  A reconfiguration runs three steps:

  1. SCALE_UP_PASSIVE — the passive set is brought up under the new
     configuration (workers created, pinned, model loaded/compiled);
     the active set keeps serving: no downtime.
  2. SWAP — the dispatcher atomically redirects *new* requests to the
     (now ready) passive set, which becomes active.
  3. DRAIN_OLD — the previous active set finishes in-flight work and is
     scaled to zero in the background; its resources return to the
     allocator.

If the new configuration only changes instance *counts* (same threads
per worker), plain worker scaling is used instead (paper's first case);
active-passive is needed only when per-worker thread counts change,
because thread-pool libraries (MKL/OpenMP — or, here, a compiled
sub-mesh program) cannot be resized in place cheaply.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional

from .knapsack import PackratConfig


class Phase(enum.Enum):
    STABLE = "stable"
    SCALE_UP_PASSIVE = "scale_up_passive"
    SWAP = "swap"
    DRAIN_OLD = "drain_old"


@dataclasses.dataclass
class ReconfigEvent:
    time: float
    phase: Phase
    detail: str


def needs_active_passive(old: Optional[PackratConfig], new: PackratConfig) -> bool:
    """True iff per-worker thread counts change (paper's second case)."""
    if old is None:
        return False
    old_ts = sorted({g.t for g in old.groups})
    new_ts = sorted({g.t for g in new.groups})
    return old_ts != new_ts


class ActivePassiveController:
    """Drives the Fig.-5 state transitions against a virtual or real clock.

    The controller is backend-agnostic: ``spawn_cost(config)`` returns the
    time to bring up the passive set (worker start + model load/compile),
    ``drain_cost(config)`` the time for in-flight work to finish.  The
    serving layer supplies these (measured, or simulated).
    """

    def __init__(
        self,
        *,
        spawn_cost: Callable[[PackratConfig], float],
        drain_cost: Callable[[PackratConfig], float],
        on_swap: Optional[Callable[[PackratConfig], None]] = None,
    ) -> None:
        self.spawn_cost = spawn_cost
        self.drain_cost = drain_cost
        self.on_swap = on_swap
        self.phase = Phase.STABLE
        self.active: Optional[PackratConfig] = None
        self.passive: Optional[PackratConfig] = None
        self._phase_end: float = 0.0
        self.events: List[ReconfigEvent] = []

    # ------------------------------------------------------------------ #
    @property
    def serving_config(self) -> Optional[PackratConfig]:
        """The configuration requests are currently dispatched to.

        Never None once serving has started — this is the zero-downtime
        property (validated in tests/test_reconfig.py).
        """
        return self.active

    @property
    def oversubscribed(self) -> bool:
        """During SCALE_UP/DRAIN both sets hold resources (paper Fig. 11
        observes a transient latency bump from exactly this)."""
        return self.phase in (Phase.SCALE_UP_PASSIVE, Phase.DRAIN_OLD) and \
            self.passive is not None

    def start(self, config: PackratConfig, now: float = 0.0) -> None:
        """Initial bring-up (no previous configuration)."""
        self.active = config
        self.phase = Phase.STABLE
        self.events.append(ReconfigEvent(now, Phase.STABLE, f"start {config}"))

    def request_reconfig(self, new: PackratConfig, now: float) -> float:
        """Begin a reconfiguration; returns the expected completion time."""
        if self.phase is not Phase.STABLE:
            raise RuntimeError(f"reconfig requested while in {self.phase}")
        if self.active is None:
            self.start(new, now)
            return now
        self.passive = new
        self.phase = Phase.SCALE_UP_PASSIVE
        cost = self.spawn_cost(new)
        self._phase_end = now + cost
        self.events.append(ReconfigEvent(now, Phase.SCALE_UP_PASSIVE,
                                         f"spawning {new} ({cost:.3f}s)"))
        return self._phase_end + self.drain_cost(self.active)

    def tick(self, now: float) -> Phase:
        """Advance the state machine to ``now``; returns the current phase."""
        while True:
            if self.phase is Phase.SCALE_UP_PASSIVE and now >= self._phase_end:
                # SWAP is atomic at the dispatcher: new requests go to the
                # new set from this instant on.
                assert self.passive is not None
                old = self.active
                self.active, self.passive = self.passive, old
                if self.on_swap is not None:
                    self.on_swap(self.active)
                self.events.append(ReconfigEvent(self._phase_end, Phase.SWAP,
                                                 f"dispatch -> {self.active}"))
                self.phase = Phase.DRAIN_OLD
                assert self.passive is not None
                self._phase_end = self._phase_end + self.drain_cost(self.passive)
                continue
            if self.phase is Phase.DRAIN_OLD and now >= self._phase_end:
                self.events.append(ReconfigEvent(self._phase_end, Phase.DRAIN_OLD,
                                                 f"drained {self.passive}"))
                self.passive = None
                self.phase = Phase.STABLE
                continue
            return self.phase

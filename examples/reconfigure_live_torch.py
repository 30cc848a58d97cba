"""Active-passive reconfiguration on the PyTorch port, observed live
(paper Fig. 5 + Fig. 11).

Runs the serving simulator with the paper-calibrated Inception-v3
profile, steps the request rate at t=4 s, and prints a per-second
latency timeline annotated with the controller's phase transitions —
the zero-downtime property is visible directly: completions continue
through SCALE_UP_PASSIVE → SWAP → DRAIN_OLD.  ``repro_torch.core`` and
``repro_torch.serving`` hold byte-identical copies of the planner and
controller, so this prints exactly what ``examples/reconfigure_live.py``
prints; it touches no device.

Run:  PYTHONPATH=src python examples/reconfigure_live_torch.py
"""

import collections
import statistics

from repro_torch.core import EstimatorConfig, PackratOptimizer
from repro_torch.core.paper_profiles import INCEPTION_V3
from repro_torch.serving import (ArrivalProcess, ControllerConfig,
                                 DispatcherConfig, EventLoop, PackratServer,
                                 Request, TabulatedBackend, step_rate)


def run_timeline(duration: float = 40.0, step_at: float = 4.0):
    """Inception-v3 at T=16 under a rate step from B=8-matched to
    B=64-matched load at ``step_at``: (server, arrivals)."""
    profile = INCEPTION_V3.profile(16, 1024)
    opt = PackratOptimizer(profile)
    cfg8, cfg64 = opt.solve(16, 8), opt.solve(16, 64)
    rate = step_rate(8 / cfg8.latency, 0.9 * 64 / cfg64.latency, step_at)
    # hold the stale configuration ~4 s (the paper forces the server to
    # keep serving with the B=8 config to expose the degraded region);
    # batch timeout sized for the largest expected aggregation time so
    # timeouts signal genuine load drops, not slow aggregation
    ccfg = ControllerConfig(
        estimator=EstimatorConfig(reconfigure_timeout=8.0),
        dispatcher=DispatcherConfig(batch_timeout=0.6))
    loop = EventLoop()
    server = PackratServer(loop, total_units=16, optimizer=opt,
                           backend=TabulatedBackend(profile),
                           initial_batch=8, config=ccfg)
    arrivals = ArrivalProcess.uniform(rate, duration)
    for i, t in enumerate(arrivals):
        loop.at(t, (lambda i=i, t=t: server.submit(Request(i, t))))
    loop.run_until(duration + 60.0)
    return server, arrivals


def main() -> int:
    server, arrivals = run_timeline(duration=40.0)
    by_s = collections.defaultdict(list)
    for r in server.responses:
        by_s[int(r.request.arrival)].append(r.latency)
    events = {int(t): f"  <-- reconfig to B={b}: "
              f"{' '.join(str(g) for g in c.groups)}"
              for t, b, c in server.reconfig_log if t > 0}
    print(f"{'t':>4} {'median latency':>15}")
    for s in sorted(by_s):
        med = statistics.median(by_s[s]) * 1e3
        bar = "#" * min(60, int(med / 25))
        print(f"{s:3d}s {med:12.0f}ms {bar}{events.get(s, '')}")
    print(f"\ncompleted {len(server.responses)}/{len(arrivals)} "
          f"requests; reconfigurations: {len(server.reconfig_log) - 1}; "
          f"active-passive events: "
          f"{[e.phase.value for e in server.apc.events]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

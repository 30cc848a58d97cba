"""Packrat's analytic profiler on H100s: L[t, b] tables from counted steps.

The counterpart of ``repro/launch/profile_tpu.py``.  The paper measures
⟨1, t, b⟩ wall-clock latencies; the analytic profile counts the decode
step of one *thin instance* on a t-rank submesh at batch b
(:func:`.step_cost.program_cost` on meta tensors, DTensors on torch's
``"fake"`` process group) and derives L(t, b) = max(roofline terms) +
dispatch overhead on the H100 spec (``core.hardware``).  The table feeds
the same 2-D knapsack optimizer.

Here ``t`` counts ranks of a submesh, one H100 each, as it counts chips
in the reference; a one-rank submesh holds every tensor whole, so t = 1
counts the plain step, the one a single card serves.  The dispatch term
is the step's device ops (``launches``) times the host time of one
(``HOST_S_PER_LAUNCH``): every eager step of the port is bound by the
host that issues it.  Steps are counted with ``use_pallas_kernels`` off:
a CUDA kernel counts no FLOPs.

As in the paper (§3.2), profiling keeps to powers of two.
"""

import argparse
import json
import pathlib
from typing import Dict, Optional

import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..core.hardware import H100, NVLINK_LINKS, with_launches
from ..core.profiler import AnalyticProfiler
from ..core.roofline import RooflineTerms
from ..distributed.sharding import (batch_pspecs, cache_pspecs, params_pspecs,
                                    sharded_zeros)
from ..models.lm import decode_step, init_cache, init_params
from .mesh import fake_world, make_submesh
from .step_cost import StepCost, program_cost, roofline_from_cost

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results"


def decode_args(cfg: ModelConfig, batch: int, seq_len: int, *,
                device="meta", seed: int = 0):
    """(serve_step, (params, cache, tokens)) of one thin instance's decode
    step at the cache's last slot, with ``use_pallas_kernels`` off: meta
    tensors, or ``device``'s with seeded weights and a zeroed cache."""
    cfg = cfg.with_overrides(use_pallas_kernels=False)
    dev = torch.device(device)
    params = init_params(cfg, seed, device=dev)
    cache = init_cache(cfg, batch, seq_len,
                       min(4096, seq_len) if cfg.is_encdec else 0,
                       device=dev)
    tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)

    def serve_step(params, cache, tokens):
        with torch.no_grad():
            return decode_step(params, cache, tokens, seq_len - 1, cfg)

    return serve_step, (params, cache, tokens)


def decode_cost(cfg: ModelConfig, n_chips: int, batch: int, seq_len: int,
                *, model_parallel: Optional[int] = None,
                device="meta", seed: int = 0) -> StepCost:
    """The count of one decode step (:func:`decode_args`) of a thin
    instance on ``n_chips`` ranks: on meta tensors, or (one rank only)
    on ``device``'s real tensors, where the step runs."""
    if n_chips > 1 and torch.device(device).type != "meta":
        raise ValueError("a submesh of several ranks is counted on meta")
    serve_step, (params, cache, tokens) = decode_args(
        cfg, batch, seq_len, device=device, seed=seed)
    if n_chips == 1:
        return program_cost(serve_step, params, cache, tokens)
    cfg = cfg.with_overrides(use_pallas_kernels=False)
    with fake_world(n_chips):
        mesh = make_submesh(n_chips, model_parallel=model_parallel,
                            device_type="cpu")
        params = sharded_zeros(params, params_pspecs(cfg, params, mesh), mesh)
        cache = sharded_zeros(cache, cache_pspecs(cfg, cache, mesh), mesh)
        tokens = sharded_zeros({"tokens": tokens}, batch_pspecs(
            {"tokens": tokens}, mesh), mesh)["tokens"]
        return program_cost(serve_step, params, cache, tokens)


def decode_terms(cfg: ModelConfig, n_chips: int, batch: int, seq_len: int,
                 *, model_parallel: Optional[int] = None) -> RooflineTerms:
    """Roofline terms of one thin instance: serve_step on a t-rank
    submesh, counted at full depth, its dispatch term its launches."""
    cost = decode_cost(cfg, n_chips, batch, seq_len,
                       model_parallel=model_parallel)
    return roofline_from_cost(cost.cost, n_chips,
                              hw=with_launches(H100, cost.launches))


class GPUPackratProfiler(AnalyticProfiler):
    """AnalyticProfiler whose terms_fn counts thin-instance submeshes."""

    def __init__(self, arch: str, *, seq_len: int = 8192,
                 cache_file: Optional[str] = None, overlap: bool = True):
        self.cfg = get_config(arch)
        self.seq_len = seq_len
        self.cache_file = (pathlib.Path(cache_file) if cache_file else
                           RESULTS_DIR / "torch_profiles" /
                           f"{arch}_s{seq_len}.json")
        self._disk: Dict[str, dict] = {}
        if self.cache_file.exists():
            self._disk = json.loads(self.cache_file.read_text())
        super().__init__(self._terms, overlap=overlap)

    def _terms(self, t: int, b: int) -> RooflineTerms:
        key = f"{t},{b}"
        if key not in self._disk:
            cost = decode_cost(self.cfg, t, b, self.seq_len)
            terms = roofline_from_cost(cost.cost, t)
            self._disk[key] = {"flops": terms.flops,
                               "hbm_bytes": terms.hbm_bytes,
                               "collective_bytes": terms.collective_bytes,
                               "launches": cost.launches}
            self.cache_file.parent.mkdir(parents=True, exist_ok=True)
            self.cache_file.write_text(json.dumps(self._disk, indent=1))
        d = self._disk[key]
        return RooflineTerms(flops=d["flops"], hbm_bytes=d["hbm_bytes"],
                             collective_bytes=d["collective_bytes"],
                             chips=t, hw=with_launches(H100, d["launches"]),
                             ici_links=NVLINK_LINKS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--chips", type=int, nargs="+",
                    default=[8, 16, 32, 64, 128, 256])
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[1, 4, 16, 64])
    args = ap.parse_args(argv)
    prof = GPUPackratProfiler(args.arch, seq_len=args.seq)
    print("t,b,compute_s,memory_s,collective_s,L_s")
    for t in args.chips:
        for b in args.batches:
            terms = prof.terms(t, b)
            print(f"{t},{b},{terms.compute_s:.6f},{terms.memory_s:.6f},"
                  f"{terms.collective_s:.6f},{terms.latency:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

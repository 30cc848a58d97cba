"""Multi-pod dry run on meta tensors: every (architecture × shape × mesh).

The counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's step for the production mesh with
``ShapeDtypeStruct`` stand-ins; the port builds the same step with its
arguments as DTensors of **meta** shards (nothing allocated), laid out
by ``params_pspecs``, ``batch_pspecs``, ``cache_pspecs`` and (train)
``optimizer_pspecs`` on the 256- or 512-rank production mesh of torch's
``"fake"`` process group, and counts it with
:func:`.step_cost.program_cost`:

1. **residency** (the reference's validation compile): per-rank argument,
   temporary, output and aliased bytes of the full-depth step, and
   whether they fit one H100 (:data:`..core.hardware.H100`);
2. **cost**: the same full-depth run's per-rank FLOPs, HBM bytes,
   collectives and device ops.  An eager count sees every layer, so the
   reference's ``n_repeats = r0, r0 + 1`` differencing (its HLO cost
   analysis counts a scanned body once) is not needed, and full depth
   is what is counted (gemma3-1b's four cells take about two minutes
   on one CPU core).  Only
   ``collectives_by_op_per_layer`` differences two short counts (1 and
   2 repeats), as the reference defines it;
3. roofline terms on the H100 spec (dispatch: the step's device ops at
   the measured host time of one) and ``model_flops`` ratios, one JSON
   record a cell in ``results/torch_dryrun/`` with the reference's keys.

Steps are counted with ``cfg.use_pallas_kernels`` off: the reference's
sharded steps run its jnp paths, and a CUDA kernel counts no FLOPs.
The fake group holds no device, so nothing here needs a card.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""

import argparse
import json
import pathlib
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import SHAPES, ShapeConfig, all_configs, applicable_shapes, get_config
from ..configs.base import ModelConfig
from ..core.hardware import H100, with_launches
from ..distributed.sharding import (batch_pspecs, cache_pspecs,
                                    optimizer_pspecs, params_pspecs,
                                    sharded_zeros)
from ..models import build_model
from ..models.lm import param_count
from ..training.optimizer import AdamWConfig, init_adamw
from ..training.train_loop import TrainConfig, make_train_step
from .mesh import fake_world, make_production_mesh
from .step_cost import StepCost, program_cost, roofline_from_cost

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch_dryrun"


# --------------------------------------------------------------------- #
# the cells' steps
# --------------------------------------------------------------------- #
def _train_cfg(cfg: ModelConfig) -> TrainConfig:
    return TrainConfig(adamw=AdamWConfig(state_dtype=cfg.train_state_dtype))


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The cell's step on ``mesh`` with meta DTensor arguments; returns
    (step, args, n_chips)."""
    cfg = cfg.with_overrides(use_pallas_kernels=False)
    model = build_model(cfg)
    p_shape = model.param_specs()
    p_spec = params_pspecs(cfg, p_shape, mesh)
    params = sharded_zeros(p_shape, p_spec, mesh)
    in_specs = model.input_specs(shape)
    batch = sharded_zeros(in_specs, batch_pspecs(in_specs, mesh), mesh)
    n_chips = mesh.size()

    if shape.kind == "train":
        tcfg = _train_cfg(cfg)
        opt = init_adamw(tcfg.adamw, p_shape)
        o_spec = optimizer_pspecs(p_spec, p_shape, mesh)
        opt = opt._replace(
            mu=sharded_zeros(opt.mu, o_spec, mesh),
            nu=sharded_zeros(opt.nu, o_spec, mesh),
            master=(sharded_zeros(opt.master, o_spec, mesh)
                    if opt.master is not None else None))
        return make_train_step(cfg, tcfg), (params, opt, batch), n_chips

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch)
        return prefill_step, (params, batch), n_chips

    # decode: serve_step(params, cache, tokens, pos) at the last slot
    cache_shape = model.cache_specs(shape)
    cache = sharded_zeros(cache_shape, cache_pspecs(cfg, cache_shape, mesh),
                          mesh)
    pos = shape.seq_len - 1

    def serve_step(params, cache, tokens):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos)
    return serve_step, (params, cache, batch["tokens"]), n_chips


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> StepCost:
    """:func:`.step_cost.program_cost` of the cell's step on ``mesh``."""
    step, args, _ = lower_cell(cfg, shape, mesh)
    return program_cost(step, *args)


# --------------------------------------------------------------------- #
# algorithmic FLOPs (assignment definition)
# --------------------------------------------------------------------- #
def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D train / 2·N·D inference, N = active matmul params."""
    model = build_model(cfg)
    p_shape = model.param_specs()
    total = param_count(p_shape)
    embed = cfg.vocab_size * cfg.d_model
    n = total - (0 if cfg.tie_embeddings else embed)
    if cfg.moe is not None:
        moe = cfg.moe
        n_moe_layers = sum(1 for k in cfg.layers if k == "mla_moe")
        per_expert = 3 * cfg.d_model * moe.expert_ff
        n -= n_moe_layers * (moe.n_experts - moe.top_k) * per_expert
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: one token per sequence


# --------------------------------------------------------------------- #
# per-cell analysis
# --------------------------------------------------------------------- #
def _reduced_depth(cfg: ModelConfig, r: int) -> ModelConfig:
    return cfg.with_overrides(n_repeats=r, scan_layers=False)


def analyze_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                 skip_validation: bool = False, validation_only: bool = False,
                 cfg_override: Optional[ModelConfig] = None,
                 tag: str = "") -> Dict:
    shape = SHAPES[shape_name]
    if cfg_override is not None:
        # hillclimb path: caller controls every knob (incl. tile sizes)
        cfg = cfg_override
    else:
        # remat only matters for the backward pass; larger attention
        # tiles cut the blocked loop's op count (same math)
        cfg = get_config(arch).with_overrides(
            remat=(shape.kind == "train"),
            attn_block_q=2048,
            attn_block_kv=4096)
    n_ranks = 512 if multi_pod else 256
    rec: Dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": n_ranks, "tag": tag,
    }
    t0 = time.perf_counter()
    with fake_world(n_ranks):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        n_chips = mesh.size()
        # ---- 1. the full-depth count: residency and cost ------------- #
        full = count_cell(cfg, shape, mesh)
        if not validation_only:
            # collectives of one pattern repeat: 2 repeats less 1
            per_layer = (count_cell(_reduced_depth(cfg, 2), shape, mesh).cost
                         - count_cell(_reduced_depth(cfg, 1), shape,
                                      mesh).cost)
    cost = full.cost
    if not skip_validation:
        rec["memory"] = {
            "argument_bytes_per_device": int(cost.argument_bytes),
            "temp_bytes_per_device": int(cost.temp_bytes),
            "output_bytes_per_device": int(cost.output_bytes),
            "alias_bytes_per_device": int(full.alias_bytes),
            "peak_bytes_per_device": int(full.peak_bytes),
        }
        rec["fits_hbm"] = rec["memory"]["peak_bytes_per_device"] \
            <= H100.hbm_capacity
        rec["validation_cost_analysis"] = {"flops": cost.flops,
                                           "bytes accessed": cost.hbm_bytes}

    if validation_only:
        rec["elapsed_s"] = time.perf_counter() - t0
        return rec

    # ---- 2. roofline terms ------------------------------------------- #
    terms = roofline_from_cost(cost, n_chips,
                               hw=with_launches(H100, full.launches))
    mf = model_flops(cfg, shape)
    rec["roofline"] = {
        "hlo_flops_total": terms.flops,
        "hlo_bytes_total": terms.hbm_bytes,
        "collective_bytes_per_chip": terms.collective_bytes,
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "latency_s": terms.latency,
        "dominant": terms.dominant,
        "model_flops": mf,
        "model_flops_ratio": mf / terms.flops if terms.flops else 0.0,
        "roofline_fraction": terms.roofline_fraction(mf),
        "collectives_by_op_per_layer": dict(
            per_layer.collectives.bytes_by_op),
    }
    rec["elapsed_s"] = time.perf_counter() - t0
    return rec


def all_cells():
    for arch, cfg in all_configs().items():
        for shape in applicable_shapes(cfg):
            yield arch, shape.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", help="architecture id (see configs.archs)")
    ap.add_argument("--shape", help="shape name", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--skip-validation", action="store_true",
                    help="leave the residency out of the record")
    ap.add_argument("--validation-only", action="store_true",
                    help="residency only (no roofline)")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose result JSON already exists OK")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = list(all_cells())
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        cfg = get_config(args.arch)
        shapes = ([args.shape] if args.shape else
                  [s.name for s in applicable_shapes(cfg)])
        cells = [(args.arch, s) for s in shapes]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape in cells:
        for multi in meshes:
            name = f"{arch}__{shape}__{'multi' if multi else 'single'}"
            out_file = outdir / f"{name}.json"
            if args.skip_existing and out_file.exists() \
                    and "error" not in json.loads(out_file.read_text()):
                print(f"[skip] {name}")
                continue
            try:
                rec = analyze_cell(arch, shape, multi_pod=multi,
                                   skip_validation=args.skip_validation,
                                   validation_only=args.validation_only)
                out_file.write_text(json.dumps(rec, indent=2))
                r = rec.get("roofline", {})
                mem = rec.get("memory", {})
                if r:
                    print(f"[ok] {name}: dominant={r['dominant']} "
                          f"L={r['latency_s']*1e3:.2f}ms "
                          f"mfu={r['roofline_fraction']*100:.1f}% "
                          f"peak/dev={mem.get('peak_bytes_per_device', 0)/2**30:.2f}GiB "
                          f"({rec['elapsed_s']:.0f}s)")
                else:
                    print(f"[ok] {name}: counted; "
                          f"peak/dev={mem.get('peak_bytes_per_device', 0)/2**30:.2f}GiB "
                          f"({rec['elapsed_s']:.0f}s)")
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                out_file.write_text(json.dumps(
                    {"arch": arch, "shape": shape, "multi_pod": multi,
                     "error": "".join(traceback.format_exception(e))[-4000:]},
                    indent=2))
                print(f"[FAIL] {name}: {type(e).__name__}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

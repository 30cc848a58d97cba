"""The rank side of ``tests/test_torch_distributed.py``: two spawns of
8 gloo ranks (:data:`CHECKS`, then :data:`LAYOUT_CHECKS`) run every
multi-rank check of the port and write what they got as ``.npy`` files
for the test process to compare.

Imports no JAX (the ranks start from a fresh interpreter and need only
torch).  Every rank pins torch to one thread and joins its group through
a ``file://`` store in the test's temporary directory, so parallel test
workers share no port.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import numpy as np

WORLD = 8
# the (2, 4) ("data", "model") mesh of tests/test_distributed.py
MESH_2X4 = ((2, 4), ("data", "model"))
# sharded steps: test_distributed.py's reduced model widths, in fp32 so
# the tolerances (loss 1e-5, logits 2e-5 of the largest) measure the
# layout, not rounding; case -> (arch, config overrides)
STEP_REDUCED = dict(n_repeats=2, d_model=64, n_heads=4, d_ff=128,
                    vocab_size=512, dtype="float32")
STEP_CASES = {
    "llama3-8b": ("llama3-8b", {}),
    # the reference's sharding hints: shard_seq, shard_heads and
    # shard_decode_scores on DTensors
    "llama3-8b-hints": ("llama3-8b", dict(seq_sharding=True,
                                          sp_gather_heads=True,
                                          decode_seq_shard=True)),
    # apply_moe_ep inside the model, x a DTensor
    "deepseek-v2-236b-moe-ep": ("deepseek-v2-236b", dict(moe_ep=True)),
    "gemma3-1b": ("gemma3-1b", {}),
    "mamba2-130m": ("mamba2-130m", {}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}),
    "internvl2-1b": ("internvl2-1b", {}),
}
STEP_BATCH, STEP_SEQ, DECODE_LEN, DECODE_POS, MEMORY_LEN = 8, 32, 64, 3, 32
# the cases whose moments optimizer_pspecs can lay out: with moe_ep on
# (2, 4), deepseek-v2-236b's experts shard over ("data", "model") and the
# ZeRO rule names "data" again, which both sides refuse
ZERO_CASES = tuple(c for c in STEP_CASES if c != "deepseek-v2-236b-moe-ep")
# expert parallelism: (case, mesh shape, mesh axes, capacity factor)
EP_CASES = (("model8-cf8", (8,), ("model",), 8.0),
            ("model8-cf1.25", (8,), ("model",), 1.25),
            ("2x4-cf8", (2, 4), ("data", "model"), 8.0),
            ("2x4-cf1.25", (2, 4), ("data", "model"), 1.25))


def ep_config(get_config, capacity_factor: float):
    """test_distributed.py's EP config (reduced deepseek-v2-236b, 8
    experts top-2) at ``capacity_factor``."""
    cfg = get_config("deepseek-v2-236b").reduced(
        n_repeats=1, d_model=32, n_heads=4, d_ff=64)
    return cfg.with_overrides(moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=capacity_factor))


def _load_tree(path: Path, torch):
    """{name: tensor} from ``path``'s ``*.npy`` files, ``__`` nesting dicts."""
    tree: dict = {}
    for f in sorted(path.glob("*.npy")):
        node = tree
        *outer, leaf = f.stem.split("__")
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(np.load(f))
    return tree


# the checks of one spawn each, by name, in two groups so that
# each spawn stays well inside its hang guard
CHECKS = ("_compression", "_expert_parallel", "_sharded_steps")
LAYOUT_CHECKS = ("_zero_train_steps", "_sharded_prefill")


def run(rank: int, out: str, checks=CHECKS) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group("gloo",
                            init_method=f"file://{out}/store{checks[0]}",
                            rank=rank, world_size=WORLD)
    try:
        for name in checks:
            globals()[name](rank, out, torch)
    finally:
        dist.destroy_process_group()


def _save(out: Path, name: str, t) -> None:
    np.save(out / f"{name}.npy", t.detach().cpu().numpy())


def _compression(rank, out, torch):
    """Rank r holds row r of the reference test's (8, 512) input."""
    from repro_torch.distributed.compression import compressed_psum
    x = torch.from_numpy(np.load(out / "psum_x.npy"))[rank:rank + 1]
    _save(out, f"got_psum_{rank}", compressed_psum(x))


def _expert_parallel(rank, out, torch):
    from repro_torch.configs import get_config
    from repro_torch.distributed.expert_parallel import apply_moe_ep
    from repro_torch.launch.mesh import make_mesh
    params = _load_tree(out / "ep_params", torch)
    x = torch.from_numpy(np.load(out / "ep_x.npy"))
    meshes = {}
    for case, shape, axes, cf in EP_CASES:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, axes, device_type="cpu")
        cfg = ep_config(get_config, cf)
        got = apply_moe_ep(params, x, cfg, mesh=meshes[shape])
        if rank == 0:
            _save(out, f"got_ep_{case}", got)


def _sharded_steps(rank, out, torch):
    """Each :data:`STEP_CASES` model's train and decode steps with
    DTensor parameters, batch and cache on the (2, 4) mesh, against the
    port's unsharded steps (overrides off) on the same weights and
    inputs."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import batches_for_model
    from repro_torch.distributed import (batch_pspecs, cache_pspecs,
                                         distribute_tree, params_pspecs,
                                         sharded_step)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, TrainConfig, init_adamw,
                                      make_train_step)
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.training.tree import leaves_with_path

    mesh = make_mesh(*MESH_2X4, device_type="cpu")
    tcfg = TrainConfig(adamw=AdamWConfig(warmup_steps=1))
    shape = ShapeConfig("t", seq_len=STEP_SEQ, global_batch=STEP_BATCH,
                        kind="train")
    tokens = torch.from_numpy(np.load(out / "decode_tokens.npy"))
    for case, (arch, overrides) in STEP_CASES.items():
        base = get_config(arch).reduced(**STEP_REDUCED)
        cfg = base.with_overrides(**overrides)
        plain, model = build_model(base), build_model(cfg)
        params = plain.init(0, device="cpu")
        d_params = distribute_tree(params, params_pspecs(cfg, params, mesh),
                                   mesh)

        batch = {k: torch.as_tensor(v)
                 for k, v in next(batches_for_model(base, shape)).items()}
        want_p, _, want_m = make_train_step(base, tcfg)(
            params, init_adamw(tcfg.adamw, params), batch)
        d_batch = distribute_tree(batch, batch_pspecs(batch, mesh), mesh)
        got_p, _, got_m = make_train_step(cfg, tcfg)(
            d_params, init_adamw(tcfg.adamw, d_params), d_batch)
        # every returned leaf keeps its layout; the gradients, each leaf's
        # error over its largest |g| (full_tensor is a collective: every
        # rank calls it)
        laid_out = all(isinstance(g, DTensor)
                       for _, g in leaves_with_path(got_p))
        loss = got_m["loss"].full_tensor()
        _, want_g = value_and_grad(params, batch, base)
        with sharded_step(d_params["embed"]):
            _, got_g = value_and_grad(d_params, d_batch, cfg)
        grad_err = 0.0
        for (path, g), (_, w) in zip(leaves_with_path(got_g),
                                     leaves_with_path(want_g)):
            e = float((g.full_tensor() - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            if rank == 0 and e > 1e-4:
                print(case, path, e, flush=True)
            grad_err = max(grad_err, e)

        mem = MEMORY_LEN if base.is_encdec else 0
        cache = plain.init_cache(STEP_BATCH, DECODE_LEN, mem, device="cpu")
        want_logits, _ = plain.decode_step(params, cache, tokens, DECODE_POS)
        d_cache = plain.init_cache(STEP_BATCH, DECODE_LEN, mem, device="cpu")
        d_cache = distribute_tree(d_cache, cache_pspecs(cfg, d_cache, mesh),
                                  mesh)
        got_logits, d_cache = model.decode_step(d_params, d_cache, tokens,
                                                DECODE_POS)
        got_logits = got_logits.full_tensor()
        cache_err = max(float((g.full_tensor() - w).abs().max())
                        for (_, g), (_, w) in zip(leaves_with_path(d_cache),
                                                  leaves_with_path(cache)))
        if rank == 0:
            _save(out, f"step_{case}_loss", torch.stack(
                [loss, want_m["loss"]]))
            _save(out, f"step_{case}_logits", torch.stack(
                [got_logits, want_logits]))
            _save(out, f"step_{case}_errs", torch.tensor(
                [grad_err, float(laid_out), cache_err]))


def _zero_train_steps(rank, out, torch):
    """Two train steps of each :data:`ZERO_CASES` model with DTensor
    parameters and batch and the moments laid out by
    ``optimizer_pspecs`` (ZeRO over "data"), each step against the
    port's unsharded step from the same state; after each step, the
    layout of every returned parameter and moment."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import batches_for_model
    from repro_torch.distributed import (batch_pspecs, distribute_tree,
                                         optimizer_pspecs, params_pspecs)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, TrainConfig, init_adamw,
                                      make_train_step)
    from repro_torch.training.tree import leaves_with_path

    mesh = make_mesh(*MESH_2X4, device_type="cpu")
    tcfg = TrainConfig(adamw=AdamWConfig(warmup_steps=1))
    shape = ShapeConfig("t", seq_len=STEP_SEQ, global_batch=STEP_BATCH,
                        kind="train")

    def same_layout(got, like):
        return all(tuple(g.placements) == tuple(w.placements)
                   for (_, g), (_, w) in zip(leaves_with_path(got),
                                             leaves_with_path(like)))

    def abs_err(got, want):
        return max(float((g.full_tensor() - w).abs().max())
                   for (_, g), (_, w) in zip(leaves_with_path(got),
                                             leaves_with_path(want)))

    def rel_err(got, want):
        return max(float((g.full_tensor() - w).abs().max())
                   / max(float(w.abs().max()), 1e-30)
                   for (_, g), (_, w) in zip(leaves_with_path(got),
                                             leaves_with_path(want)))

    for case in ZERO_CASES:
        arch, overrides = STEP_CASES[case]
        base = get_config(arch).reduced(**STEP_REDUCED)
        cfg = base.with_overrides(**overrides)
        params = build_model(base).init(0, device="cpu")
        p_spec = params_pspecs(cfg, params, mesh)
        d_params = distribute_tree(params, p_spec, mesh)
        state = init_adamw(tcfg.adamw, params)
        o_spec = optimizer_pspecs(p_spec, params, mesh)
        d_state = state._replace(mu=distribute_tree(state.mu, o_spec, mesh),
                                 nu=distribute_tree(state.nu, o_spec, mesh))
        layout = (d_params, d_state.mu, d_state.nu)
        data = batches_for_model(base, shape)
        plain_step = make_train_step(base, tcfg)
        step = make_train_step(cfg, tcfg)
        errs = []
        for _ in range(2):
            batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
            params, state, want_m = plain_step(params, state, batch)
            d_batch = distribute_tree(batch, batch_pspecs(batch, mesh), mesh)
            d_params, d_state, got_m = step(d_params, d_state, d_batch)
            kept = all(same_layout(g, w) for g, w in zip(
                (d_params, d_state.mu, d_state.nu), layout))
            loss = got_m["loss"].full_tensor()
            errs.append([float(kept),
                         abs(float(loss) - float(want_m["loss"]))
                         / abs(float(want_m["loss"])),
                         abs_err(d_params, params),
                         max(rel_err(d_state.mu, state.mu),
                             rel_err(d_state.nu, state.nu))])
        if rank == 0:
            _save(out, f"zero_{case}_errs", torch.tensor(errs))


def _sharded_prefill(rank, out, torch):
    """Each :data:`STEP_CASES` model's prefill with DTensor parameters
    and batch on the (2, 4) mesh against the port's unsharded prefill on
    the same weights and prompt, its cache's and logits' layouts against
    the specs, then one decode step from that DTensor cache against the
    unsharded step from the unsharded cache."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import batches_for_model
    from repro_torch.distributed import (batch_pspecs, cache_pspecs,
                                         distribute_tree, params_pspecs,
                                         to_placements)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.training.tree import leaves_with_path

    mesh = make_mesh(*MESH_2X4, device_type="cpu")
    shape = ShapeConfig("p", seq_len=STEP_SEQ, global_batch=STEP_BATCH,
                        kind="prefill")
    tokens = torch.from_numpy(np.load(out / "decode_tokens.npy"))

    def cache_err(got, want):
        return max(float((g.full_tensor() - w).abs().max())
                   for (_, g), (_, w) in zip(leaves_with_path(got),
                                             leaves_with_path(want)))

    for case, (arch, overrides) in STEP_CASES.items():
        base = get_config(arch).reduced(**STEP_REDUCED)
        cfg = base.with_overrides(**overrides)
        plain, model = build_model(base), build_model(cfg)
        params = plain.init(0, device="cpu")
        d_params = distribute_tree(params, params_pspecs(cfg, params, mesh),
                                   mesh)
        batch = {k: torch.as_tensor(v) for k, v in next(
            batches_for_model(base, shape)).items() if k != "labels"}
        want_logits, cache = plain.prefill(params, batch, DECODE_LEN)
        d_batch = distribute_tree(batch, batch_pspecs(batch, mesh), mesh)
        got_logits, d_cache = model.prefill(d_params, d_batch, DECODE_LEN)
        want_spec = cache_pspecs(cfg, d_cache, mesh)
        laid_out = all(
            tuple(g.placements) == tuple(to_placements(mesh, s))
            for (_, g), (_, s) in zip(leaves_with_path(d_cache),
                                      leaves_with_path(want_spec)))
        laid_out &= tuple(got_logits.placements) == tuple(to_placements(
            mesh, batch_pspecs(got_logits, mesh)))
        prefill_logits = got_logits.full_tensor()
        prefill_cache_err = cache_err(d_cache, cache)
        want_dec, _ = plain.decode_step(params, cache, tokens, STEP_SEQ)
        got_dec, d_cache = model.decode_step(d_params, d_cache, tokens,
                                             STEP_SEQ)
        got_dec = got_dec.full_tensor()
        decode_cache_err = cache_err(d_cache, cache)
        if rank == 0:
            _save(out, f"prefill_{case}_logits", torch.stack(
                [prefill_logits, want_logits]))
            _save(out, f"prefill_{case}_decode_logits", torch.stack(
                [got_dec, want_dec]))
            _save(out, f"prefill_{case}_errs", torch.tensor(
                [float(laid_out), prefill_cache_err, decode_cache_err]))


def spawn(out: str, checks=CHECKS, timeout: float = 300.0) -> None:
    """Run :func:`run` of ``checks`` on :data:`WORLD` spawned ranks; kill
    them and raise if they have not all finished within ``timeout``
    seconds."""
    import torch.multiprocessing as mp
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ctx = mp.start_processes(run, args=(out, checks), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")

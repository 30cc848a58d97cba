"""Micro PyTorch models for the real execution plane.

A port of ``repro/models/micro.py``.  The real serving path
(``repro_torch.serving.plane.RealPlane``) needs model steps that build
in milliseconds and run in tens of microseconds, so that a whole
profile grid and a served trace fit in a smoke budget, while still
being real execution on the device (launch, padding to bucketed batch
sizes, waiting for the result: the overheads Packrat's ``c0`` term
models).  Three registered micro models:

* ``mlp-tiny`` / ``mlp`` — small dense MLP stacks,
  ``x = tanh(x @ w + c)`` per layer in fp32 (:func:`mlp_step`);
* ``attn-tiny`` — one causal attention over a short sequence
  (:func:`attn_step`).  On a card it runs the hand-written CUDA flash
  kernel through ``kernels.ops.flash_attention`` (fp32, head dim 16:
  the CUDA-core ``flash_fwd_kernel``); on the CPU the wrapper computes
  its plain version, ``kernels.ref.flash_attention_ref``, which is what
  the reference's step calls.

Every factory returns a ``make_runner(t, b)`` callable: the plane's
``RunnerFactory`` contract.  ``t`` is the instance's unit budget; the
plane enforces it as a concurrency budget, so it does not alter the
step, and runners for the same ``b`` are shared across ``t``.

Threads and streams follow ``models/serve_lm.py``: each worker thread
that calls a runner gets its own ``torch.cuda.Stream``, which waits for
the weights and inputs before its first step, and a run synchronizes
only that stream.  The factories default to
``device="cuda"`` and raise without a card unless given ``"cpu"``.
Weights come from ``torch.Generator(seed)``, or from the reference's own
parameters through ``models.convert.micro_params_from_numpy``.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import resolve_device
from ..kernels import build as kernel_build
from ..kernels import ops

MICRO_MODELS = ("mlp-tiny", "mlp", "attn-tiny")

MicroParams = List[Tuple[torch.Tensor, torch.Tensor]]


def mlp_step(x: torch.Tensor, params: MicroParams) -> torch.Tensor:
    """One MLP micro step: ``x = tanh(x @ w + c)`` for each layer."""
    for w, c in params:
        x = torch.tanh(x @ w + c)
    return x


def attn_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """One attn-tiny step: causal attention over (b, seq, heads, dim),
    through the flash kernel's wrapper (its plain version on the CPU)."""
    return ops.flash_attention(q, k, v, causal=True)


def init_mlp_params(dim: int, depth: int, seed: int, device) -> MicroParams:
    """Seeded weights of the shapes ``micro.py:37-39`` draws: w ~ N(0, 1)
    / sqrt(dim), c = 0, fp32."""
    gen = torch.Generator().manual_seed(seed)
    return [((torch.randn((dim, dim), generator=gen) / dim ** 0.5).to(device),
             torch.zeros((dim,), dtype=torch.float32, device=device))
            for _ in range(depth)]


def _runner(device: torch.device, step: Callable[[], object]
            ) -> Callable[[], None]:
    """A zero-argument runner around ``step`` that returns None once the
    step's work is done: on a card, on a stream of the calling thread's
    own that it alone synchronizes.  Inputs and weights made so far on
    the current stream are ready before any runner stream reads them:
    each new stream first waits on an event recorded here, so nothing
    synchronizes the whole device."""
    if device.type != "cuda":
        def run() -> None:
            step()
        return run
    ready = torch.cuda.Event()
    ready.record()
    local = threading.local()

    def run() -> None:
        stream = getattr(local, "stream", None)
        if stream is None:
            stream = local.stream = torch.cuda.Stream(device)
            stream.wait_event(ready)
        with torch.cuda.stream(stream):
            step()
        stream.synchronize()

    return run


def _mlp_factory(dim: int, depth: int, seed: int, *,
                 params: Optional[MicroParams] = None, device="cuda"):
    dev = resolve_device(device)
    if params is None:
        params = init_mlp_params(dim, depth, seed, dev)
    elif len(params) != depth or any(tuple(w.shape) != (dim, dim)
                                     for w, _ in params):
        raise ValueError(f"params do not match a {depth}-layer MLP of "
                         f"width {dim}")
    params = [(w.to(dev), c.to(dev)) for w, c in params]

    @functools.lru_cache(maxsize=None)
    def compiled(b: int) -> Callable[[], None]:
        x = torch.ones((b, dim), dtype=torch.float32, device=dev)
        run = _runner(dev, lambda: mlp_step(x, params))
        run()                           # warm outside the timed path
        return run

    def make_runner(t: int, b: int) -> Callable[[], None]:
        return compiled(b)

    return make_runner


def _attn_factory(seq: int, heads: int, head_dim: int, seed: int, *,
                  device="cuda"):
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the kernel builds once per process, not inside a cell's build
        kernel_build.build_kernels()

    @functools.lru_cache(maxsize=None)
    def compiled(b: int) -> Callable[[], None]:
        gen = torch.Generator().manual_seed(seed)
        shape = (b, seq, heads, head_dim)
        q, k, v = (torch.randn(shape, generator=gen).to(dev)
                   for _ in range(3))
        run = _runner(dev, lambda: attn_step(q, k, v))
        run()
        return run

    def make_runner(t: int, b: int) -> Callable[[], None]:
        return compiled(b)

    return make_runner


_BUILDERS: Dict[str, Callable] = {
    "mlp-tiny": lambda seed, **kw: _mlp_factory(dim=32, depth=2, seed=seed,
                                                **kw),
    "mlp": lambda seed, **kw: _mlp_factory(dim=128, depth=4, seed=seed, **kw),
    "attn-tiny": lambda seed, **kw: _attn_factory(seq=16, heads=2,
                                                  head_dim=16, seed=seed,
                                                  **kw),
}


def _kwargs(name: str, params, device) -> Dict[str, object]:
    if params is not None and name == "attn-tiny":
        raise ValueError("attn-tiny has no weights; its inputs are drawn "
                         "from the seed")
    kw: Dict[str, object] = {"device": device}
    if params is not None:
        kw["params"] = params
    return kw


def make_micro_runner(name: str = "mlp-tiny", *, seed: int = 0,
                      params: Optional[MicroParams] = None, device="cuda"):
    """Runner factory for one registered micro model: the plane's
    ``make_runner(t, b) -> Callable[[], None]`` contract.  ``params``
    (MLPs only) replaces the seeded weights."""
    if name not in _BUILDERS:
        raise ValueError(f"unknown micro model {name!r}; "
                         f"choose from {sorted(_BUILDERS)}")
    return _BUILDERS[name](seed, **_kwargs(name, params, device))


# per-rung architecture variants for the fidelity ladder (rung 0 first):
# the MLPs shrink their hidden width, the attention model its sequence
# length — cheaper real execution, not a simulated discount
_FIDELITY_BUILDERS: Dict[str, tuple] = {
    "mlp-tiny": tuple(
        lambda seed, d=d, **kw: _mlp_factory(dim=d, depth=2, seed=seed, **kw)
        for d in (32, 16, 8)),
    "mlp": tuple(
        lambda seed, d=d, **kw: _mlp_factory(dim=d, depth=4, seed=seed, **kw)
        for d in (128, 64, 32)),
    "attn-tiny": tuple(
        lambda seed, s=s, **kw: _attn_factory(seq=s, heads=2, head_dim=16,
                                              seed=seed, **kw)
        for s in (16, 8, 4)),
}


def make_fidelity_micro_runner(name: str = "mlp-tiny", *, seed: int = 0,
                               n_rungs: int = 3,
                               params: Optional[Sequence[MicroParams]] = None,
                               device="cuda"):
    """Fidelity-aware runner factory for one registered micro model.

    Returns ``make_runner(t, b, *, fidelity=0)``: rung 0 is the exact
    model :func:`make_micro_runner` builds (so ladder-off execution is
    unchanged), higher rungs dispatch progressively cheaper variants
    (narrower MLPs / shorter attention).  ``params`` (MLPs only) holds
    one weight list per rung.  The factory carries the
    ``fidelity_aware`` marker RealPlane keys its runner cache on.
    """
    if name not in _FIDELITY_BUILDERS:
        raise ValueError(f"unknown micro model {name!r}; "
                         f"choose from {sorted(_FIDELITY_BUILDERS)}")
    builders = _FIDELITY_BUILDERS[name]
    if not (1 <= n_rungs <= len(builders)):
        raise ValueError(f"n_rungs must be in [1, {len(builders)}], "
                         f"got {n_rungs}")
    if params is not None and len(params) != n_rungs:
        raise ValueError(f"params holds {len(params)} rungs, not {n_rungs}")
    rungs = [build(seed, **_kwargs(
        name, None if params is None else params[r], device))
        for r, build in enumerate(builders[:n_rungs])]

    def make_runner(t: int, b: int, *, fidelity: int = 0):
        if not (0 <= fidelity < len(rungs)):
            raise ValueError(f"fidelity rung {fidelity} out of range "
                             f"[0, {len(rungs)})")
        return rungs[fidelity](t, b)

    make_runner.fidelity_aware = True
    return make_runner


__all__ = ["MICRO_MODELS", "attn_step", "init_mlp_params",
           "make_fidelity_micro_runner", "make_micro_runner", "mlp_step"]

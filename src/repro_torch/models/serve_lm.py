"""Autoregressive LM serving engine: ``models/lm.py`` behind the plane.

A port of ``repro/models/serve_lm.py``: a decoder wired into
:class:`~repro_torch.serving.plane.RealPlane` behind the
``make_runner(t, b)`` factory contract, split into the two phases of
LLM inference:

* **prefill** — one full-prompt forward through the CUDA
  ``flash_attention`` kernel, building the KV cache.  Runner cells are
  pow2-bucketed ⟨t, b, seq-bucket⟩.
* **decode** — one token for every resident sequence through the CUDA
  ``decode_attention`` kernel against the pooled KV cache, which each
  step updates **in place** (the reference donates the cache buffers to
  its jitted step to the same effect).

The kernels are those of the configuration's blocks: an MLA
configuration (deepseek) runs blocked prefill attention, an absorbed
latent decode and its MoE in plain PyTorch and launches no kernel, as
the reference's MLA blocks ignore ``use_pallas_kernels``; an
encoder-decoder's encoder and cross-attention run blocked attention,
and only its decoder's self-attention reaches the kernels.

A prompt batch carries every input :func:`~.lm.input_specs` names for
the configuration at the cell's ⟨b, seq-bucket⟩: seeded tokens, and for
a frontend seeded standard-normal embeddings in the model dtype (a
vision prompt is ``n_prefix_tokens`` patches then text, an audio prompt
min(s, n_frames) encoder frames and s decoder tokens), so a prompt
fills s positions.  The reference's engine passes tokens only; its
``Model.prefill`` takes the other inputs.

The engine owns a KV-cache pool: each decode cell ⟨b⟩ keeps a resident
⟨cache, position⟩ it advances every step.  Every cell is built and run
once inside the factory, outside the timed path, so ``RealPlane``'s
``compile_ms`` accounts for it; the CUDA kernels themselves are built
once per process when the first CUDA engine is created, so that build is
not charged to the first cell.

Threads and streams.  ``RealPlane`` runs each worker's batches on the
worker's own thread and times ``run()`` on the wall clock.  A batch
therefore runs on a ``torch.cuda.Stream`` of its own and synchronizes
only that stream: a device-wide ``torch.cuda.synchronize()`` would also
wait on other workers' batches and charge them to this one.  A prefill
cell keeps one stream per worker thread that calls it; a decode cell
keeps one stream, since its lock lets one step run at a time.  Each cell
marks its batch's span record (``serving/spans.py``): the decode cell
once it holds its lock, both just before the stream wait, so a call
splits into lock wait, host enqueue and stream wait.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..configs.base import ShapeConfig
from ..configs.gemma3_1b import GEMMA3_1B
from ..core.knapsack import next_power_of_two
from ..kernels import build as kernel_build
from ..serving.spans import mark
from .lm import Model, build_model, input_specs

LM_MODELS = ("lm-tiny",)

PHASE_PREFILL = "prefill"
PHASE_DECODE = "decode"
PHASES = (PHASE_PREFILL, PHASE_DECODE)


def lm_tiny_config():
    """gemma3-1b scaled to smoke size, routed through the CUDA kernels.

    float32 keeps the prefill+decode vs full-forward differential test
    tolerance tight; the layer stack keeps gemma3's 5:1 local:global
    attention mix (sliding window 64) so both the ring-cache and the
    full-cache decode paths are exercised.
    """
    return GEMMA3_1B.reduced(
        n_repeats=1, d_model=32, n_heads=2, d_ff=64, vocab_size=256,
        name="lm-tiny", dtype="float32", use_pallas_kernels=True)


class LmEngine:
    """KV-cache pool + pow2-bucketed runner cells for one decoder.

    ``factory()`` returns the plane-facing runner factory (marked
    ``phase_aware``: the plane passes the worker pool's phase as a third
    argument).  ``prefill``/``decode_step`` expose the same callables
    functionally for the differential tests.  ``device`` defaults to
    CUDA and raises without a card unless ``device="cpu"`` is asked for.
    """

    def __init__(self, cfg=None, *, seed: int = 0, max_seq: int = 64,
                 default_seq_bucket: int = 16, device="cuda") -> None:
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else lm_tiny_config()
        if not self.cfg.use_pallas_kernels:
            raise ValueError("LmEngine serves through the CUDA kernels; "
                             "cfg.use_pallas_kernels must be set")
        if max_seq < 2 or default_seq_bucket >= max_seq:
            raise ValueError(
                f"need default_seq_bucket < max_seq, got "
                f"{default_seq_bucket} vs {max_seq}")
        self.kernel_build_s = 0.0
        if self.device.type == "cuda":
            self.kernel_build_s = kernel_build.build_kernels()
        self.model: Model = build_model(self.cfg)
        self.params = self.model.init(seed, device=self.device)
        self.max_seq = max_seq
        self.default_seq_bucket = next_power_of_two(default_seq_bucket)
        self._gen = torch.Generator().manual_seed(seed + 1)
        # ⟨b⟩-keyed resident decode state: (cache, python position)
        self._resident: Dict[int, Tuple[object, int]] = {}
        self._runners: Dict[Tuple[str, int, int], Callable[[], None]] = {}
        self._sync()

    # ------------------------------------------------------------------ #
    # functional surface (differential tests)
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def prefill(self, tokens, **inputs):
        """(logits_last (B,1,V), cache) for a prompt batch: (B, S) tokens
        and the configuration's other inputs (``vision_embeds``,
        ``frames``) by name."""
        batch = {name: torch.as_tensor(x, device=self.device)
                 for name, x in inputs.items()}
        batch["tokens"] = torch.as_tensor(tokens, dtype=torch.long,
                                          device=self.device)
        return self.model.prefill(self.params, batch, max_len=self.max_seq)

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One decode step; updates ``cache`` in place and returns it."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self.model.decode_step(self.params, cache, tokens, int(pos))

    # ------------------------------------------------------------------ #
    # bucketing, devices
    # ------------------------------------------------------------------ #
    def seq_bucket(self, prompt_len: int) -> int:
        """Pow2 seq bucket for a prompt length, clamped to max_seq."""
        return min(next_power_of_two(max(1, prompt_len)), self.max_seq)

    def _sample_batch(self, b: int, s: int) -> Dict[str, torch.Tensor]:
        """A seeded prompt batch of b sequences filling s positions, with
        the leaves :func:`~.lm.input_specs` names."""
        fe = self.cfg.frontend
        if fe is not None and fe.kind == "vision" and s <= fe.n_prefix_tokens:
            raise ValueError(f"a {s}-position prompt leaves no text after "
                             f"{fe.n_prefix_tokens} patch embeddings")
        specs = input_specs(self.cfg, ShapeConfig(
            "serve", seq_len=s, global_batch=b, kind="prefill"))
        batch = {}
        for name, spec in specs.items():
            if spec.dtype.is_floating_point:
                x = torch.randn(spec.shape, generator=self._gen).to(
                    spec.dtype)
            else:
                x = torch.randint(0, self.cfg.vocab_size, spec.shape,
                                  generator=self._gen, dtype=torch.long)
            batch[name] = x.to(self.device)
        return batch

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cell_stream(self):
        """A new stream for a runner cell's batches (None on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.Stream(self.device)
        return None

    @staticmethod
    def _on(stream):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    @staticmethod
    def _wait(stream) -> None:
        if stream is not None:
            stream.synchronize()

    # ------------------------------------------------------------------ #
    # runner cells
    # ------------------------------------------------------------------ #
    def prefill_runner(self, t: int, b: int, s: Optional[int] = None
                       ) -> Callable[[], None]:
        """Prefill runner for a ⟨t, b, seq-bucket⟩ cell.  ``t`` is a
        concurrency budget the plane enforces, not a partition of the
        device: same-shape cells share one runner across t."""
        b = next_power_of_two(max(1, b))
        s = self.seq_bucket(s if s is not None else self.default_seq_bucket)
        key = (PHASE_PREFILL, b, s)
        run = self._runners.get(key)
        if run is None:
            batch = self._sample_batch(b, s)
            self._sync()            # inputs are ready before any cell stream
            # Cells ⟨t, b⟩ with the same b share this runner, and the plane
            # may run several of them at once, each on its worker's thread.
            # Each thread gets its own stream, so its synchronize() waits
            # for its own batch only.
            local = threading.local()
            engine = self

            def run() -> None:
                stream = getattr(local, "stream", None)
                if stream is None:
                    stream = local.stream = engine._cell_stream()
                with engine._on(stream):
                    engine.prefill(**batch)
                mark("enqueued")
                engine._wait(stream)

            run()                                        # build + warm here
            self._runners[key] = run
        return run

    def decode_runner(self, t: int, b: int) -> Callable[[], None]:
        """Decode runner for a ⟨t, b⟩ cell over its resident KV-cache
        pool: each call advances every resident sequence by one token,
        updating the cache in place.  The resident position wraps inside
        [seq_bucket, max_seq) so the cell serves indefinitely."""
        b = next_power_of_two(max(1, b))
        key = (PHASE_DECODE, b, 0)
        run = self._runners.get(key)
        if run is None:
            s0 = self.default_seq_bucket
            stream = self._cell_stream()
            prompt = self._sample_batch(b, s0)
            self._sync()
            with self._on(stream):
                _, cache = self.prefill(**prompt)
                tokens = torch.zeros((b, 1), dtype=torch.long,
                                     device=self.device)
            self._resident[b] = (cache, s0)
            # Cells ⟨t, b⟩ with the same b share this runner and its
            # resident cache (t does not key it).  Their worker threads
            # may call run() at once, and each step writes the cache in
            # place: the lock keeps two steps from interleaving.
            lock = threading.Lock()
            engine = self

            def run() -> None:
                with lock:
                    mark("locked")
                    cache, pos = engine._resident[b]
                    with engine._on(stream):
                        engine.decode_step(cache, tokens, pos)
                    mark("enqueued")
                    engine._wait(stream)
                    nxt = s0 + (pos - s0 + 1) % (engine.max_seq - s0)
                    engine._resident[b] = (cache, nxt)

            run()                                        # build + warm here
            self._runners[key] = run
        return run

    # ------------------------------------------------------------------ #
    # plane-facing factory
    # ------------------------------------------------------------------ #
    def factory(self, *, seq_bucket: Optional[int] = None):
        """The plane's ``RunnerFactory``, phase-aware: ``make(t, b,
        phase)`` routes "prefill" to the ⟨t, b, seq-bucket⟩ prefill cell
        and everything else to the decode pool."""
        s = self.seq_bucket(seq_bucket if seq_bucket is not None
                            else self.default_seq_bucket)

        def make(t: int, b: int, phase: str = PHASE_DECODE
                 ) -> Callable[[], None]:
            if phase == PHASE_PREFILL:
                return self.prefill_runner(t, b, s)
            return self.decode_runner(t, b)

        make.phase_aware = True
        return make


def make_lm_engine(name: str = "lm-tiny", *, seed: int = 0, device="cuda",
                   **kw) -> LmEngine:
    """Engine for one registered LM serving model."""
    if name not in LM_MODELS:
        raise ValueError(f"unknown LM serving model {name!r}; "
                         f"choose from {sorted(LM_MODELS)}")
    return LmEngine(lm_tiny_config(), seed=seed, device=device, **kw)


# --------------------------------------------------------------------- #
# fidelity ladder: per-rung reduced decoders
# --------------------------------------------------------------------- #
def lm_tiny_rung_configs(n_rungs: int = 3):
    """Rung configs for the ``lm-tiny`` fidelity ladder (rung 0 first).

    Rung 0 is :func:`lm_tiny_config` verbatim; higher rungs shrink width
    and FFN via the same ``GEMMA3_1B.reduced`` machinery (head dim 8 at
    rungs 1-2): genuinely cheaper decoders through the same kernels.
    """
    reductions = [
        dict(n_repeats=1, d_model=32, n_heads=2, d_ff=64, vocab_size=256),
        dict(n_repeats=1, d_model=16, n_heads=2, d_ff=32, vocab_size=256),
        dict(n_repeats=1, d_model=8, n_heads=1, d_ff=16, vocab_size=256),
    ]
    if not (1 <= n_rungs <= len(reductions)):
        raise ValueError(f"n_rungs must be in [1, {len(reductions)}], "
                         f"got {n_rungs}")
    cfgs = [lm_tiny_config()]
    for r, red in enumerate(reductions[1:n_rungs], start=1):
        cfgs.append(GEMMA3_1B.reduced(
            name=f"lm-tiny:r{r}", dtype="float32",
            use_pallas_kernels=True, **red))
    return cfgs


def make_fidelity_lm_factory(name: str = "lm-tiny", *, seed: int = 0,
                             n_rungs: int = 3, seq_bucket: int = 16,
                             device="cuda", **kw):
    """Fidelity- and phase-aware runner factory for an LM ladder.

    One :class:`LmEngine` per rung (rung 0 identical to
    :func:`make_lm_engine`'s engine); higher rungs pair their narrower
    decoder with a halved seq bucket.  Returns ``make(t, b, phase, *,
    fidelity=0)`` carrying the ``phase_aware`` and ``fidelity_aware``
    markers RealPlane keys its runner cache on.
    """
    if name not in LM_MODELS:
        raise ValueError(f"unknown LM serving model {name!r}; "
                         f"choose from {sorted(LM_MODELS)}")
    engines = []
    buckets = []
    for rung, cfg in enumerate(lm_tiny_rung_configs(n_rungs)):
        s = max(2, seq_bucket >> rung)
        engines.append(LmEngine(cfg, seed=seed, default_seq_bucket=s,
                                device=device, **kw))
        buckets.append(s)
    factories = [eng.factory(seq_bucket=s)
                 for eng, s in zip(engines, buckets)]

    def make(t: int, b: int, phase: str = PHASE_DECODE, *,
             fidelity: int = 0) -> Callable[[], None]:
        if not (0 <= fidelity < len(factories)):
            raise ValueError(f"fidelity rung {fidelity} out of range "
                             f"[0, {len(factories)})")
        return factories[fidelity](t, b, phase)

    make.phase_aware = True
    make.fidelity_aware = True
    make.engines = tuple(engines)
    return make


__all__ = ["LM_MODELS", "LmEngine", "PHASES", "PHASE_DECODE",
           "PHASE_PREFILL", "lm_tiny_config", "lm_tiny_rung_configs",
           "make_fidelity_lm_factory", "make_lm_engine"]

"""Synthetic data pipeline: deterministic token streams + batch iterators.

A port of ``repro/data/pipeline.py``.  The corpus is procedurally
generated (seeded Zipfian bigram chains) by numpy, exactly as the
reference generates it, so ``tokens`` and ``labels`` are byte-identical
to the reference's for the same :class:`DataConfig`, host sharding
included.  Batches are CPU tensors (the train loop moves them to its
device).  The vision and audio stub embeddings come from a seeded
``torch.Generator``, as ``LmEngine``'s prompts do, where the reference
draws them with ``jax.random``: their shapes, dtypes and the -100
labels of a vision prefix are the reference's, their values are not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..training.train_loop import shift_labels


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    host_id: int = 0
    host_count: int = 1


class SyntheticCorpus:
    """Zipfian bigram chain: learnable structure with a few MB of state."""

    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        k = min(branching, vocab_size)
        # each token deterministically prefers `k` successors (Zipf weights)
        self.succ = rng.integers(0, vocab_size,
                                 size=(min(vocab_size, 65536), k))
        w = 1.0 / np.arange(1, k + 1)
        self.w = w / w.sum()

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        t = int(rng.integers(0, self.succ.shape[0]))
        for i in range(n):
            out[i] = t
            nxt = rng.choice(self.succ.shape[1], p=self.w)
            t = int(self.succ[t % self.succ.shape[0], nxt])
        return out


def token_batches(dcfg: DataConfig, *, with_labels: bool = True,
                  ignore_prefix: int = 0) -> Iterator[Dict]:
    """Infinite iterator of {tokens, labels} batches (host-sharded)."""
    corpus = SyntheticCorpus(dcfg.vocab_size, dcfg.seed)
    rng = np.random.default_rng(dcfg.seed * dcfg.host_count + dcfg.host_id + 1)
    B, S = dcfg.batch_size, dcfg.seq_len
    while True:
        toks = np.stack([corpus.sample(rng, S) for _ in range(B)])
        batch = {"tokens": torch.from_numpy(toks.astype(np.int32))}
        if with_labels:
            batch["labels"] = shift_labels(batch["tokens"], ignore_prefix)
        yield batch


def batches_for_model(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0
                      ) -> Iterator[Dict]:
    """Batches matching a model's input_specs (vision/audio stubs filled)."""
    B, S = shape.global_batch, shape.seq_len
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator().manual_seed(seed)
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        P = cfg.frontend.n_prefix_tokens
        for batch in token_batches(DataConfig(cfg.vocab_size, S - P, B, seed)):
            vis = torch.randn((B, P, cfg.d_model), generator=gen).to(dtype)
            labels = torch.cat([torch.full((B, P), -100, dtype=torch.int32),
                                batch["labels"]], dim=1)
            yield {"tokens": batch["tokens"], "vision_embeds": vis,
                   "labels": labels}
    elif cfg.is_encdec:
        n_frames = min(S, cfg.frontend.n_frames) if cfg.frontend else S
        for batch in token_batches(DataConfig(cfg.vocab_size, S, B, seed)):
            frames = torch.randn((B, n_frames, cfg.d_model),
                                 generator=gen).to(dtype)
            yield {"tokens": batch["tokens"], "frames": frames,
                   "labels": batch["labels"]}
    else:
        yield from token_batches(DataConfig(cfg.vocab_size, S, B, seed))

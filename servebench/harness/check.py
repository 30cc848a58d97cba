"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of what the timed path served is run through the
plain reference (:mod:`.reference`), teacher-forced on the served
tokens:

* from every decode cell, up to :data:`ROWS_PER_CELL` resident rows: the
  prompt, the greedy first token its prefill served and every greedy
  token its decode steps served through the cache (the last
  :data:`LAST_TOKENS` of them compared);
* :data:`PREFILL_CALLS` prefill calls of the window, one row each: the
  first token served from the prompt's last logits.

The number compared is ``gap_max``: the widest gap by which a served
token's reference logit lies below the reference's best at that
position.  Greedy tokens of an exact program have gap 0 wherever the
best is not tied; rounding in bfloat16 turns near ties into small gaps,
a wrong path into large ones.  The control (``control=True``, only for
setting the limit) reads the same gap for the tokens the fp8 reference
puts first at the same positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .reference import Reference

ROWS_PER_CELL = 2
LAST_TOKENS = 128
PREFILL_CALLS = 4


@dataclasses.dataclass
class Item:
    tokens: torch.Tensor          # (L,) input ids
    at: torch.Tensor              # positions whose next-token scores count
    served: torch.Tensor          # the tokens served there
    what: str


def sample(rec, pool: torch.Tensor, window_lo: float, seed: int
           ) -> List[Item]:
    """The seeded sample of served tokens (see the module's docstring)."""
    rng = np.random.default_rng([seed, 2])
    items = []
    for seq in sorted(rec.resident.values(), key=lambda s: s.prefill.b):
        if not seq.tokens:
            continue
        b, s0, start = seq.prefill.b, seq.pos0, seq.prefill.start
        outs = torch.cat(seq.tokens, dim=1)                   # (b, n)
        served = torch.cat([seq.prefill.first[:, None], outs], dim=1)
        n = outs.shape[1]
        keep = min(n + 1, LAST_TOKENS)
        for row in sorted(rng.choice(b, min(ROWS_PER_CELL, b),
                                     replace=False).tolist()):
            tokens = torch.cat([pool[start + row], served[row, :n]])
            at = torch.arange(s0 - 1, s0 + n, device=tokens.device)
            items.append(Item(tokens, at[-keep:], served[row, -keep:],
                              f"decode b{b} row {row}: {keep} of {n + 1}"))
    calls = [p for p in rec.prefills if p.t >= window_lo]
    for i in sorted(rng.choice(len(calls), min(PREFILL_CALLS, len(calls)),
                               replace=False).tolist()):
        p = calls[i]
        row = int(rng.integers(p.b))
        tokens = pool[p.start + row]
        items.append(Item(tokens, torch.tensor([len(tokens) - 1],
                                               device=tokens.device),
                          p.first[row:row + 1],
                          f"prefill b{p.b} row {row}"))
    return items


def _gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    return logits.max(dim=-1).values \
        - logits.gather(-1, served[:, None].long())[:, 0]


def compare(conf: Dict, weights, items: List[Item], *,
            control: bool = False) -> Dict[str, object]:
    ref = Reference(conf, weights).logits([i.tokens for i in items],
                                          [i.at for i in items])
    per_item = [float(_gaps(lg, i.served).max()) for lg, i in
                zip(ref, items)]
    out = {"gap_max": max(per_item), "served": sum(len(i.at) for i in items),
           "items": [[i.what, g] for i, g in zip(items, per_item)]}
    if control:
        low = Reference(conf, weights, quant="fp8").logits(
            [i.tokens for i in items], [i.at for i in items])
        out["control_gap_max"] = max(
            float(_gaps(r, lo.argmax(-1)).max()) for r, lo in zip(ref, low))
    return out

"""The plain reference: the dense decoder in float32, layer by layer.

Plain PyTorch, importing nothing of the program.  It follows the block
of the configuration files (``servebench/configs``): pre-LayerNorm
attention with grouped-query heads, partial rotary embeddings on
adjacent pairs of the first ``rope_pct`` of each head, causal softmax
attention, a squared-ReLU MLP, a final LayerNorm and an untied head.  Each
way this departs from a published model is listed under ``assumed`` in
the configuration's file.

Matrix products run in float32 with TF32 off.  ``quant="fp8"`` is the
control: every product's operands are rounded to float8 e4m3 first (a
scale a row of activations, a column of weights), the nearest precision
below the bfloat16 the configurations state.

The sequences of one call are run together, layer by layer: a layer's
weights are converted once and applied to every sequence, so a model of
any depth fits beside the activations of a few sequences.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

FP8_MAX = 448.0                      # float8 e4m3's largest finite value
Q_BLOCK = 512                        # query rows a block of attention


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale per slice along the
    other dims (the max over ``dim`` maps to the largest finite value)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Reference:
    """Logits of whole sequences, in float32 (or the fp8 control)."""

    def __init__(self, conf: Dict, weights: Dict[str, torch.Tensor],
                 quant: Optional[str] = None) -> None:
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quantization {quant!r}")
        self.c = conf
        self.w = weights
        self.quant = quant

    # ------------------------------------------------------------------ #
    def _mm(self, x, w):
        """x (..., k) @ w (k, n) in float32 (fp8 operands in the control)."""
        if self.quant == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    @staticmethod
    def _layer_norm(x, scale, bias, eps):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * scale + bias

    def _rope(self, x, positions):
        """Rotate adjacent pairs of the first rope_pct of each head."""
        D = x.shape[-1]
        rot = int(D * self.c["rope_pct"])
        rot -= rot % 2
        inv = 1.0 / (self.c["rope_theta"] ** (
            torch.arange(0, rot, 2, dtype=torch.float32, device=x.device)
            / rot))
        ang = positions[:, None].float() * inv                # (S, rot/2)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :rot:2], x[..., 1:rot:2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                              dim=-1).reshape(*x.shape[:-1], rot)
        return torch.cat([rotated, x[..., rot:]], dim=-1)

    def _attention(self, q, k, v):
        """Causal softmax attention, q (S, H, D), k and v (S, Hkv, D)."""
        S, H, D = q.shape
        rep = H // k.shape[1]
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # (H, S, D)
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        out = torch.empty_like(q)
        keys = torch.arange(S, device=q.device)
        for a in range(0, S, Q_BLOCK):
            b = min(S, a + Q_BLOCK)
            s = torch.matmul(*self._operands(q[:, a:b], k.transpose(1, 2)))
            s = s / math.sqrt(D)
            s = s.masked_fill(keys[None, None, :] > torch.arange(
                a, b, device=q.device)[None, :, None], float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[:, a:b] = torch.matmul(*self._operands(p, v))
        return out.transpose(0, 1)

    def _operands(self, a, b):
        if self.quant == "fp8":
            return _fp8(a, -1), _fp8(b, -2)
        return a, b

    def _block(self, x, lw, positions):
        c = self.c
        S, d = x.shape
        H, Hkv, D = c["n_heads"], c["n_kv_heads"], c["head_dim"]
        h = self._layer_norm(x, lw["pre_attn.scale"], lw["pre_attn.bias"],
                             c["norm_eps"])
        q = self._mm(h, lw["wq"].reshape(d, H * D)).view(S, H, D)
        k = self._mm(h, lw["wk"].reshape(d, Hkv * D)).view(S, Hkv, D)
        v = self._mm(h, lw["wv"].reshape(d, Hkv * D)).view(S, Hkv, D)
        q, k = self._rope(q, positions), self._rope(k, positions)
        attn = self._attention(q, k, v).reshape(S, H * D)
        x = x + self._mm(attn, lw["wo"].reshape(H * D, d))
        h = self._layer_norm(x, lw["pre_mlp.scale"], lw["pre_mlp.bias"],
                             c["norm_eps"])
        m = torch.relu(self._mm(h, lw["up"])).square()
        return x + self._mm(m, lw["down"])

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               at: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """For each token sequence (1-D), float32 logits (len(at_i), V) at
        its positions ``at_i``: the next-token scores after each."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(seqs, at)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32

    def _logits(self, seqs, at):
        c, w = self.c, self.w
        xs = [w["embed"][s].float() for s in seqs]
        pos = [torch.arange(len(s), device=s.device) for s in seqs]
        layer_keys = [k for k in w if k.startswith("layers.")]
        for layer in range(c["n_layers"]):
            lw = {k[len("layers."):]: w[k][layer].float()
                  for k in layer_keys}
            xs = [self._block(x, lw, p) for x, p in zip(xs, pos)]
            del lw
        head = w["head"].float()
        out = []
        for x, idx in zip(xs, at):
            h = self._layer_norm(x[idx], w["final_norm.scale"],
                                 w["final_norm.bias"], c["norm_eps"])
            out.append(self._mm(h, head))
        return out


__all__ = ["Reference"]

"""Plain float32 reference of a dense GQA decoder with qk-norm (Qwen3).

Per layer: x += o(attn(rope(qknorm(q)), rope(qknorm(k)), v)) on
RMSNorm(x), then x += w2(silu(w1 h) * w3 h) on RMSNorm(x); a final RMSNorm
and the head (the embedding, transposed, where they are tied).  RoPE
rotates split halves at theta ** (-2i / D); attention is causal softmax
over q.k / sqrt(D), query head h reading key-value head h // (H / KV).
RMSNorm's eps is 1e-6 and its scale an offset from one, as the port
stores it.  One sequence at a time, with no cache, no kernel and no
batching (a training block stacks whole sequences): the prefill-and-decode
of the program is held to this full pass."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import Weights, rmsnorm, run_layers, xent_sum
from bench.reference.fp8 import mm

EPS = 1e-6
KNOWN = {
    ("attn", "ln", "scale"), ("attn", "wqkv"), ("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
    ("attn", "wo"), ("attn", "q_norm"), ("attn", "k_norm"), ("ffn", "ln", "scale"),
    ("ffn", "w1"), ("ffn", "w3"), ("ffn", "w2"), ("embed",), ("final_norm", "scale"),
    ("lm_head",),
}


class Decoder:
    """``sizes``: d, H, KV, D, F, layers, rope_theta; ``leaves``: the
    harness's {path: tensor} (float32 copies for a training reference)."""

    rows_per_block = 1  # sequences a training block holds (1 GB of scores a row at 4096)

    def __init__(self, sizes: dict, leaves: dict, prec: str = "f32"):
        self.s = sizes
        self.w = Weights(leaves, sizes["layers"], KNOWN)
        self.prec = prec

    def head(self) -> torch.Tensor:
        w = self.w.leaves.get(("lm_head",))
        return self.w.top("embed").T if w is None else w

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        S, D = x.shape[1], x.shape[-1]
        inv = self.s["rope_theta"] ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                                      device=x.device) / D)
        ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
        cos = torch.cos(ang).float()[:, None, :]
        sin = torch.sin(ang).float()[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v):
        b, S, H, D = q.shape
        G = H // k.shape[2]
        k = k.repeat_interleave(G, dim=2).transpose(1, 2)
        v = v.repeat_interleave(G, dim=2).transpose(1, 2)
        s = mm(q.transpose(1, 2), k.transpose(-1, -2), self.prec) / math.sqrt(D)
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
        p = torch.softmax(s.masked_fill(mask, -math.inf), dim=-1)
        return mm(p, v, self.prec).transpose(1, 2).reshape(b, S, H * D)

    def layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Layer ``i`` on the hidden states (b, S, d) of b sequences."""
        s, lp, P = self.s, self.w.layer(i), self.prec
        H, KV, D = s["H"], s["KV"], s["D"]
        b, S = x.shape[:2]
        h = rmsnorm(x, lp[("attn", "ln", "scale")], EPS)
        if ("attn", "wqkv") in lp:
            q, k, v = mm(h, lp[("attn", "wqkv")], P).split([H * D, KV * D, KV * D], dim=-1)
        else:
            q, k, v = (mm(h, lp[("attn", n)], P) for n in ("wq", "wk", "wv"))
        q = rmsnorm(q.reshape(b, S, H, D), lp[("attn", "q_norm")], EPS)
        k = rmsnorm(k.reshape(b, S, KV, D), lp[("attn", "k_norm")], EPS)
        o = self._attention(self._rope(q), self._rope(k), v.reshape(b, S, KV, D))
        x = x + mm(o, lp[("attn", "wo")], P)
        h = rmsnorm(x, lp[("ffn", "ln", "scale")], EPS)
        f = F.silu(mm(h, lp[("ffn", "w1")], P)) * mm(h, lp[("ffn", "w3")], P)
        return x + mm(f, lp[("ffn", "w2")], P)

    def hidden(self, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """Final-norm hidden states (b, S, d) of b sequences of token ids."""
        x = self.w.top("embed")[tokens.long()].float()
        x = run_layers(x, self.s["layers"], self.layer, remat)
        return rmsnorm(x, self.w.top("final_norm", "scale"), EPS)

    def logits_at(self, tokens: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """f32 logits (len(rows), V) at the positions ``rows`` of one pass."""
        with torch.no_grad():
            x = self.hidden(tokens[None])[0, rows]
            return mm(x, self.head(), self.prec)

    def loss_sum(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Summed next-token cross-entropy of b sequences (b, S), layers and
        loss chunks recomputed in the backward."""
        x = self.hidden(tokens, remat=True)
        return xent_sum(x.reshape(-1, x.shape[-1]), self.head(), targets.reshape(-1), self.prec)

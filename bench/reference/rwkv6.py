"""Plain float32 reference of RWKV-6 ("Finch", arXiv:2404.05892) as the
configuration runs it.

Per layer, on h = LayerNorm(x) (eps 1e-6):
  time-mix   x_s = h + (shift(h) - h) * mix_s for s in r, k, v, g, w
             (shift: the previous token's h, zero before the first);
             r, k, v = x_r W_r, x_k W_k, x_v W_v (H heads of D); g = silu(x_g W_g);
             log w = -exp(w0 + tanh(x_w A) B)          (decay in (0, 1));
             o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T;
             o = GroupNorm_per_head(o; eps 1e-5) * gn_scale + gn_bias;  x += (o * g) W_o
  channel    on h = LayerNorm(x): x_k, x_r token-shifted as above;
             x += sigmoid(x_r W_r) * (relu(x_k W_1)^2 W_2)
then a final LayerNorm and the head.  Departures from the published model,
which the configuration (and the JAX package it ports) makes: static
token-shift mixes (no data-dependent ``ddlerp``), no LayerNorm after the
embedding, these eps.

The recurrence runs in chunks of up to 64 tokens, in log-decay space:
within a chunk the pairs (t, j < t) weigh exp(L_{t-1} - L_j), split around
the chunk's middle into one factor for t and one for j, the chunk short
enough that no factor (nor a masked pair's product) leaves float32's range;
across chunks the state carries with exp(L_c) <= 1.  ``wkv_scan`` is the
sequential form the tests hold it to."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import Weights, layernorm, run_layers, xent_sum
from bench.reference.fp8 import mm, quantize

LN_EPS = 1e-6
GN_EPS = 1e-5
CHUNK = 64
MAX_EXPONENT = 40.0  # a factor's exponent; a masked pair's product stays under e^80
KNOWN = {
    ("attn", "ln", "scale"), ("attn", "ln", "bias"), ("attn", "w_r"), ("attn", "w_k"),
    ("attn", "w_v"), ("attn", "w_g"), ("attn", "w_o"), ("attn", "lora_a"), ("attn", "lora_b"),
    ("attn", "w0"), ("attn", "u"), ("attn", "gn_scale"), ("attn", "gn_bias"),
    ("attn", "mix_r"), ("attn", "mix_k"), ("attn", "mix_v"), ("attn", "mix_g"),
    ("attn", "mix_w"), ("ffn", "ln", "scale"), ("ffn", "ln", "bias"), ("ffn", "mix_k"),
    ("ffn", "mix_r"), ("ffn", "w1"), ("ffn", "w_r"), ("ffn", "w2"), ("embed",),
    ("final_norm", "scale"), ("final_norm", "bias"), ("lm_head",),
}


def wkv_scan(r, k, v, logw, u):
    """Sequential WKV of one sequence: r, k, v, logw (S, H, D); u (H, D).
    (S, H, D) f32."""
    S, H, D = r.shape
    state = r.new_zeros((H, D, D), dtype=torch.float32)
    out = []
    for t in range(S):
        kv = k[t, :, :, None] * v[t, :, None, :]
        out.append(torch.einsum("hk,hkd->hd", r[t], state + u[:, :, None] * kv))
        state = torch.exp(logw[t])[:, :, None] * state + kv
    return torch.stack(out)


def wkv_chunked(r, k, v, logw, u, chunk: int = CHUNK):
    """The same recurrence over (b, S, H, D) inputs, a chunk of tokens at a
    time (see the module)."""
    b, S, H, D = r.shape
    steepest = float(logw.detach().abs().max()) if logw.numel() else 0.0
    while chunk > 1 and chunk * steepest > 2 * MAX_EXPONENT:
        chunk //= 2
    r, k, v, logw = (t.float().transpose(1, 2) for t in (r, k, v, logw))  # (b, H, S, D)
    u = u.float()[:, None]
    state = r.new_zeros((b, H, D, D))
    lower = torch.ones((chunk, chunk), dtype=torch.bool, device=r.device).tril(-1)
    outs = []
    for s0 in range(0, S, chunk):
        rc, kc, vc, lw = (t[:, :, s0:s0 + chunk] for t in (r, k, v, logw))
        c = rc.shape[2]
        L = torch.cumsum(lw, dim=2)  # inclusive
        Lq = L - lw  # exclusive: decay before t
        mid = L[:, :, c // 2:c // 2 + 1]
        att = ((rc * torch.exp(Lq - mid)) @ (kc * torch.exp(mid - L)).transpose(-1, -2))
        o = (att * lower[:c, :c]) @ vc
        o = o + (rc * u * kc).sum(-1, keepdim=True) * vc
        o = o + (rc * torch.exp(Lq)) @ state
        Lc = L[:, :, -1:]
        state = (torch.exp(Lc).transpose(-1, -2) * state
                 + (kc * torch.exp(Lc - L)).transpose(-1, -2) @ vc)
        outs.append(o)
    return torch.cat(outs, dim=2).transpose(1, 2)


def _shift(h: torch.Tensor) -> torch.Tensor:
    """(b, S, d): the previous token's row, zero before the first."""
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def _lerp(h, hs, mix):
    return h + (hs - h) * mix.float()


class RWKV6:
    """``sizes``: d, H, D, F, layers; ``leaves``: the harness's weights."""

    rows_per_block = 8  # sequences a training block holds

    def __init__(self, sizes: dict, leaves: dict, prec: str = "f32"):
        self.s = sizes
        self.w = Weights(leaves, sizes["layers"], KNOWN)
        self.prec = prec

    def head(self) -> torch.Tensor:
        return self.w.top("lm_head")

    def layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        lp, P = self.w.layer(i), self.prec
        H, D = self.s["H"], self.s["D"]
        b, S = x.shape[:2]
        a = lambda n: lp[("attn", n)]  # noqa: E731
        h = layernorm(x, lp[("attn", "ln", "scale")], lp[("attn", "ln", "bias")], LN_EPS)
        hs = _shift(h)
        xr, xk, xv, xg, xw = (_lerp(h, hs, a(f"mix_{n}")) for n in "rkvgw")
        r = mm(xr, a("w_r"), P).reshape(b, S, H, D)
        k = mm(xk, a("w_k"), P).reshape(b, S, H, D)
        v = mm(xv, a("w_v"), P).reshape(b, S, H, D)
        g = F.silu(mm(xg, a("w_g"), P))
        logit = a("w0").float() + mm(torch.tanh(mm(xw, a("lora_a"), P)), a("lora_b"), P)
        logw = -torch.exp(logit).reshape(b, S, H, D)
        if P == "fp8":  # the recurrence's inputs as a float8 kernel would read them
            r, k, v = quantize(r), quantize(k), quantize(v)
        elif P == "bf16":
            r, k, v = (t.to(torch.bfloat16).float() for t in (r, k, v))
        o = wkv_chunked(r, k, v, logw, a("u"))
        mu = o.mean(-1, keepdim=True)
        var = (o - mu).square().mean(-1, keepdim=True)
        o = (o - mu) * torch.rsqrt(var + GN_EPS)
        o = o * a("gn_scale").float().reshape(H, D) + a("gn_bias").float().reshape(H, D)
        x = x + mm(o.reshape(b, S, H * D) * g, a("w_o"), P)
        f = lambda n: lp[("ffn", n)]  # noqa: E731
        h = layernorm(x, lp[("ffn", "ln", "scale")], lp[("ffn", "ln", "bias")], LN_EPS)
        hs = _shift(h)
        xk, xr = _lerp(h, hs, f("mix_k")), _lerp(h, hs, f("mix_r"))
        kk = torch.square(torch.relu(mm(xk, f("w1"), P)))
        return x + torch.sigmoid(mm(xr, f("w_r"), P)) * mm(kk, f("w2"), P)

    def hidden(self, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        x = self.w.top("embed")[tokens.long()].float()
        x = run_layers(x, self.s["layers"], self.layer, remat)
        return layernorm(x, self.w.top("final_norm", "scale"), self.w.top("final_norm", "bias"),
                         LN_EPS)

    def logits_at(self, tokens: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return mm(self.hidden(tokens[None])[0, rows], self.head(), self.prec)

    def loss_sum(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        x = self.hidden(tokens, remat=True)
        return xent_sum(x.reshape(-1, x.shape[-1]), self.head(), targets.reshape(-1), self.prec)

"""Each plain reference against an independent small computation."""
import math

import pytest
import torch
import torch.nn.functional as F

from bench.portbench import weights
from bench.reference import adamw
from bench.reference.decoder import Decoder
from bench.reference.fp8 import mm, quantize
from bench.reference.rwkv6 import RWKV6, wkv_chunked, wkv_scan

SIZES = {"d": 32, "H": 4, "KV": 2, "D": 8, "F": 48, "layers": 2, "rope_theta": 10000.0}


def _decoder_leaves(seed=3, fused=True):
    L, d, H, KV, D, F_ = 2, 32, 4, 2, 8, 48
    bf, f32 = torch.bfloat16, torch.float32
    attn = {"ln": {"scale": torch.empty(L, d)}, "wo": torch.empty(L, H * D, d, dtype=bf),
            "q_norm": torch.empty(L, D), "k_norm": torch.empty(L, D)}
    if fused:
        attn["wqkv"] = torch.empty(L, d, (H + 2 * KV) * D, dtype=bf)
    else:
        attn.update(wq=torch.empty(L, d, H * D, dtype=bf), wk=torch.empty(L, d, KV * D, dtype=bf),
                    wv=torch.empty(L, d, KV * D, dtype=bf))
    layout = {"blocks": {"stack": ({"attn": attn, "ffn": {
        "ln": {"scale": torch.empty(L, d)}, "w1": torch.empty(L, d, F_, dtype=bf),
        "w3": torch.empty(L, d, F_, dtype=bf), "w2": torch.empty(L, F_, d, dtype=bf)}},),
        "tail": ()}, "embed": torch.empty(64, d, dtype=bf), "final_norm": {"scale": torch.empty(d)}}
    leaves = weights.draw(layout, seed, "rmsnorm", "cpu")
    return {p: x.to(f32) for p, x in leaves.items()}


def _naive_decoder_logits(lv, tokens):
    """Token by token over a growing cache; RoPE as a complex rotation."""
    s = SIZES
    H, KV, D = s["H"], s["KV"], s["D"]
    G = H // KV

    def norm(x, w):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * (1 + w)

    def rot(x, t):
        c = torch.view_as_complex(torch.stack(x.chunk(2, -1), -1).contiguous())
        f = torch.tensor([s["rope_theta"] ** (-2 * i / D) for i in range(D // 2)],
                         dtype=torch.float64)
        c = c * torch.polar(torch.ones(D // 2, dtype=torch.float64), t * f).to(torch.complex64)
        return torch.cat([c.real, c.imag], -1)

    g = lambda *k: lv[("blocks", "stack", 0) + k]  # noqa: E731
    caches = [([], []) for _ in range(2)]
    out = []
    for t, tok in enumerate(tokens):
        x = lv[("embed",)][tok]
        for i in range(2):
            h = norm(x, g("attn", "ln", "scale")[i])
            q, k, v = (h @ g("attn", "wqkv")[i]).split([H * D, KV * D, KV * D])
            q = rot(norm(q.view(H, D), g("attn", "q_norm")[i]), t)
            k = rot(norm(k.view(KV, D), g("attn", "k_norm")[i]), t)
            caches[i][0].append(k)
            caches[i][1].append(v.view(KV, D))
            K, V = torch.stack(caches[i][0]), torch.stack(caches[i][1])
            o = torch.stack([torch.softmax(K[:, hh // G] @ q[hh] / math.sqrt(D), 0) @ V[:, hh // G]
                             for hh in range(H)]).reshape(-1)
            x = x + o @ g("attn", "wo")[i]
            h = norm(x, g("ffn", "ln", "scale")[i])
            x = x + (F.silu(h @ g("ffn", "w1")[i]) * (h @ g("ffn", "w3")[i])) @ g("ffn", "w2")[i]
        out.append(norm(x, lv[("final_norm", "scale")]) @ lv[("embed",)].T)
    return torch.stack(out)


def test_decoder_matches_a_token_by_token_pass():
    lv = _decoder_leaves()
    tokens = torch.tensor([5, 9, 1, 33, 7, 2, 60])
    ref = Decoder(SIZES, lv).logits_at(tokens, torch.arange(7))
    torch.testing.assert_close(ref, _naive_decoder_logits(lv, tokens.tolist()),
                               atol=2e-5, rtol=1e-4)


def test_decoder_split_projections_match_the_fused_one():
    fused = _decoder_leaves(fused=True)
    split = {p: x for p, x in fused.items() if p[-1] != "wqkv"}
    w = fused[("blocks", "stack", 0, "attn", "wqkv")]
    for n, a, b in (("wq", 0, 32), ("wk", 32, 48), ("wv", 48, 64)):
        split[("blocks", "stack", 0, "attn", n)] = w[..., a:b]
    t = torch.tensor([3, 4, 5, 6])
    torch.testing.assert_close(Decoder(SIZES, fused).logits_at(t, torch.arange(4)),
                               Decoder(SIZES, split).logits_at(t, torch.arange(4)))


def test_decoder_loss_and_its_gradient():
    lv = {p: x.requires_grad_(True) for p, x in _decoder_leaves().items()}
    tokens = torch.tensor([[5, 9, 1, 33], [7, 2, 60, 4]])
    targets = torch.roll(tokens, -1, 1)
    loss = Decoder(SIZES, lv).loss_sum(tokens, targets)
    logits = torch.cat([Decoder(SIZES, lv).logits_at(tokens[b], torch.arange(4))
                        for b in range(2)])
    want = F.cross_entropy(logits, targets.reshape(-1), reduction="sum")
    torch.testing.assert_close(loss.detach(), want)
    loss.backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in lv.values())


def test_wkv_chunks_match_the_sequential_scan():
    g = torch.Generator().manual_seed(0)
    S, H, D = 37, 2, 8
    r, k, v = (torch.randn(S, H, D, generator=g) for _ in range(3))
    logw = -torch.exp(torch.rand(S, H, D, generator=g) * 3 - 4)  # decays 0.98 .. 0.37
    u = torch.randn(H, D, generator=g) * 0.3
    got = wkv_chunked(r[None], k[None], v[None], logw[None], u)[0]
    torch.testing.assert_close(got, wkv_scan(r, k, v, logw, u), atol=1e-4, rtol=1e-4)


def _rwkv_leaves(seed=4):
    L, d, H, D, F_, lora, V = 2, 16, 2, 8, 24, 4, 40
    bf = torch.bfloat16
    e = lambda *s, dt=bf: torch.empty(*s, dtype=dt)  # noqa: E731
    attn = {"ln": {"scale": e(L, d, dt=torch.float32), "bias": e(L, d, dt=torch.float32)},
            "w_r": e(L, d, H * D), "w_k": e(L, d, H * D), "w_v": e(L, d, H * D),
            "w_g": e(L, d, H * D), "w_o": e(L, H * D, d),
            "lora_a": e(L, d, lora, dt=torch.float32), "lora_b": e(L, lora, H * D, dt=torch.float32),
            "w0": e(L, H * D, dt=torch.float32), "u": e(L, H, D, dt=torch.float32),
            "gn_scale": e(L, H * D, dt=torch.float32), "gn_bias": e(L, H * D, dt=torch.float32),
            **{f"mix_{n}": e(L, d) for n in "rkvgw"}}
    ffn = {"ln": {"scale": e(L, d, dt=torch.float32), "bias": e(L, d, dt=torch.float32)},
           "mix_k": e(L, d), "mix_r": e(L, d), "w1": e(L, d, F_), "w_r": e(L, d, d), "w2": e(L, F_, d)}
    layout = {"blocks": {"stack": ({"attn": attn, "ffn": ffn},), "tail": ()}, "embed": e(V, d),
              "final_norm": {"scale": e(d, dt=torch.float32), "bias": e(d, dt=torch.float32)},
              "lm_head": e(d, V)}
    lv = weights.draw(layout, seed, "layernorm", "cpu")
    return {p: x.float() for p, x in lv.items()}, {"d": d, "H": H, "D": D, "F": F_, "layers": L}


def _naive_rwkv_logits(lv, sizes, tokens):
    """Token by token, carrying each layer's state and shifted rows."""
    H, D, d = sizes["H"], sizes["D"], sizes["d"]
    g = lambda *k: lv[("blocks", "stack", 0) + k]  # noqa: E731

    def ln(x, w, b):
        return (x - x.mean()) / torch.sqrt(x.var(unbiased=False) + 1e-6) * w + b

    st = [{"S": torch.zeros(H, D, D), "a": torch.zeros(d), "f": torch.zeros(d)} for _ in range(2)]
    out = []
    for tok in tokens:
        x = lv[("embed",)][tok]
        for i in range(2):
            A = lambda n: g("attn", n)[i]  # noqa: E731
            h = ln(x, g("attn", "ln", "scale")[i], g("attn", "ln", "bias")[i])
            mixed = {n: h + (st[i]["a"] - h) * A(f"mix_{n}") for n in "rkvgw"}
            st[i]["a"] = h
            r, k, v = ((mixed[n] @ A(f"w_{n}")).view(H, D) for n in "rkv")
            gate = F.silu(mixed["g"] @ A("w_g"))
            w = torch.exp(-torch.exp(A("w0") + torch.tanh(mixed["w"] @ A("lora_a")) @ A("lora_b")))
            kv = k[:, :, None] * v[:, None, :]
            o = torch.einsum("hk,hkd->hd", r, st[i]["S"] + A("u")[:, :, None] * kv)
            st[i]["S"] = w.view(H, D)[:, :, None] * st[i]["S"] + kv
            o = (o - o.mean(-1, keepdim=True)) / torch.sqrt(o.var(-1, unbiased=False, keepdim=True) + 1e-5)
            o = o.reshape(-1) * A("gn_scale") + A("gn_bias")
            x = x + (o * gate) @ A("w_o")
            Fp = lambda n: g("ffn", n)[i]  # noqa: E731
            h = ln(x, g("ffn", "ln", "scale")[i], g("ffn", "ln", "bias")[i])
            xk = h + (st[i]["f"] - h) * Fp("mix_k")
            xr = h + (st[i]["f"] - h) * Fp("mix_r")
            st[i]["f"] = h
            x = x + torch.sigmoid(xr @ Fp("w_r")) * (torch.relu(xk @ Fp("w1")) ** 2 @ Fp("w2"))
        out.append(ln(x, lv[("final_norm", "scale")], lv[("final_norm", "bias")]) @ lv[("lm_head",)])
    return torch.stack(out)


def test_rwkv6_matches_a_token_by_token_recurrence():
    lv, sizes = _rwkv_leaves()
    tokens = torch.tensor([1, 5, 9, 2, 30, 7, 7, 11, 3, 0, 39, 12, 8, 6, 4, 2, 19, 21, 5])
    ref = RWKV6(sizes, lv).logits_at(tokens, torch.arange(len(tokens)))
    torch.testing.assert_close(ref, _naive_rwkv_logits(lv, sizes, tokens.tolist()),
                               atol=5e-5, rtol=1e-4)


def test_adamw_matches_torch_optim():
    g = torch.Generator().manual_seed(1)
    opt = {"peak_lr": 1e-2, "min_lr": 1e-3, "warmup_steps": 1, "total_steps": 100, "b1": 0.9,
           "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0}
    p = {("a",): torch.randn(4, 3, generator=g), ("b",): torch.randn(5, generator=g)}
    tp = {k: torch.nn.Parameter(v.clone()) for k, v in p.items()}
    torch_opt = torch.optim.AdamW([{"params": [tp[("a",)]], "weight_decay": 0.1},
                                   {"params": [tp[("b",)]], "weight_decay": 0.0}],
                                  lr=1e-2, betas=(0.9, 0.95), eps=1e-8)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    for t in (1, 2, 3):
        grads = {k: torch.randn(x.shape, generator=g) * 3 for k, x in p.items()}
        for k in tp:
            tp[k].grad = grads[k].clone()
        torch.nn.utils.clip_grad_norm_(list(tp.values()), 1.0)
        for grp in torch_opt.param_groups:
            grp["lr"] = adamw.lr_at(opt, t)
        torch_opt.step()
        adamw.step(p, grads, m, v2, t, opt)
    for k in p:
        torch.testing.assert_close(p[k], tp[k].detach(), atol=1e-6, rtol=1e-5)


def test_fp8_products_carry_float8_error_and_gradients():
    g = torch.Generator().manual_seed(2)
    a = torch.randn(64, 128, generator=g, requires_grad=True)
    b = (torch.randn(128, 32, generator=g) * 0.02).requires_grad_(True)
    exact = a @ b
    low = mm(a, b, "fp8")
    err = float((low - exact).detach().norm() / exact.detach().norm())
    assert 0.005 < err < 0.1  # e4m3 keeps 3 mantissa bits
    low.sum().backward()
    assert a.grad.abs().sum() > 0 and b.grad.abs().sum() > 0
    x = torch.randn(100, generator=g, requires_grad=True)
    quantize(x).sum().backward()
    torch.testing.assert_close(x.grad, torch.ones(100))  # straight through
    assert mm(a, b, "f32").dtype == torch.float32
    with pytest.raises(ValueError):
        mm(a, b, "int4")

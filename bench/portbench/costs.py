"""Operations and bytes that the inputs need, frozen with the benchmark.

These are the benchmark's yardstick, not the program's accounting: each
counts the work of the mathematics at the shapes given, whatever computes
it, with each input byte read once and each output byte written once.
Shares of a peak use the published figures of one NVIDIA H100 SXM (dense
bf16 989 TFLOP/s, HBM3 3.35 TB/s)."""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two floors."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ----------------------------------------------------------- model FLOPs
def decoder_matrix_weights(d: int, H: int, KV: int, D: int, F: int) -> int:
    """Matrix weights a layer of a dense GQA decoder applies to a token:
    q, k, v, o and the gated MLP's three."""
    return d * (H + 2 * KV) * D + H * D * d + 3 * d * F


def rwkv6_matrix_weights(d: int, H: int, D: int, F: int, lora: int) -> int:
    """Matrix weights of an RWKV-6 layer a token meets: r, k, v, g, o, the
    decay's low-rank pair, and the channel-mix's key, value and gate."""
    hd = H * D
    return 4 * d * hd + hd * d + d * lora + lora * hd + d * F + F * d + d * d


def attention_pair_flops(H: int, D: int) -> int:
    """Forward FLOPs of one visible (query, key) pair: q.k and p.v."""
    return 4 * H * D


def causal_pairs(S: int) -> int:
    """Visible (query, key) pairs of a causal sequence of S tokens."""
    return S * (S + 1) // 2


def context_pairs(c0: int, c1: int) -> int:
    """Visible pairs of the rows at positions c0 .. c1 - 1 over a causal
    cache: row i sees i + 1 keys."""
    return causal_pairs(c1) - causal_pairs(c0)


def wkv_token_flops(H: int, D: int) -> int:
    """Forward FLOPs of the WKV recurrence a token: ~6 D^2 a head (decay,
    rank-one update, read-out)."""
    return 6 * H * D * D


# ------------------------------------------------------------- kernels
def paged_attention_bytes(slots, KV: int, D: int, H: int, block_size: int,
                          kv_elem: int = 2, q_elem: int = 2) -> int:
    """Bytes one paged-attention call needs: for each live slot ``(rows,
    ctx)`` the pages that hold its ``ctx`` keys (K and V, whole pages), its
    live query rows and their outputs."""
    total = 0
    for rows, ctx in slots:
        pages = -(-ctx // block_size)
        total += pages * block_size * KV * D * 2 * kv_elem + 2 * rows * H * D * q_elem
    return total


def paged_attention_flops(slots, H: int, D: int) -> int:
    """FLOPs of one paged-attention call: each live row over the keys it
    sees (``(rows, ctx)``: rows at positions ctx - rows .. ctx - 1)."""
    return sum(attention_pair_flops(H, D) * context_pairs(ctx - rows, ctx)
               for rows, ctx in slots)


def flash_forward(B: int, S: int, H: int, KV: int, D: int, elem: int = 2) -> tuple:
    """(FLOPs, bytes) of one causal flash-attention forward: q, k, v read,
    the output written, the f32 log-sum-exp written."""
    flops = attention_pair_flops(H, D) * B * causal_pairs(S)
    nbytes = B * S * D * (2 * H + 2 * KV) * elem + 4 * B * H * S
    return flops, nbytes


def flash_backward(B: int, S: int, H: int, KV: int, D: int, elem: int = 2) -> tuple:
    """(FLOPs, bytes) of one causal flash-attention backward: five products
    a visible pair (scores again, dP, dV, dQ, dK: 10 H D), q, k, v, o, dO
    and the log-sum-exp read, dq, dk, dv written."""
    flops = 10 * H * D * B * causal_pairs(S)
    nbytes = B * S * D * (3 * H + 2 * KV) * elem + 4 * B * H * S + B * S * D * (H + 2 * KV) * elem
    return flops, nbytes


def wkv_forward(B: int, S: int, H: int, D: int, elem: int = 2) -> tuple:
    """(FLOPs, bytes) of one WKV forward: r, k, v in their type, the f32
    decay read and f32 output written, u once."""
    n = B * S * H * D
    return wkv_token_flops(H, D) * B * S, 3 * n * elem + 4 * n + 4 * n + 4 * H * D


def wkv_backward(B: int, S: int, H: int, D: int, elem: int = 2) -> tuple:
    """(FLOPs, bytes) of one WKV backward: r, k, v, the f32 decay and dO
    read, dr, dk, dv and the f32 d(log w) written, u read and du written
    (8 D^2 a token and head)."""
    n = B * S * H * D
    return 8 * H * D * D * B * S, 6 * n * elem + 12 * n + 8 * H * D

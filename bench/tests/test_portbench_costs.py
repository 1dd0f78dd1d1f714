"""The frozen arithmetic against numbers worked by hand at small shapes."""
import types

import pytest

from bench.portbench import costs, readers
from bench.portbench.serving import StepRecord, step_flops


def test_pairs():
    assert costs.causal_pairs(4) == 10  # 1 + 2 + 3 + 4
    assert costs.context_pairs(2, 4) == 7  # rows at 2 and 3 see 3 and 4 keys
    assert costs.context_pairs(16, 17) == 17


def test_matrix_weights():
    # q 4x4, k and v 4x2 each (32), o 4x4 (16), w1 w3 4x8 and w2 8x4 (96)
    assert costs.decoder_matrix_weights(d=4, H=2, KV=1, D=2, F=8) == 144
    # r k v g 4 x (4x4) = 64, o 16, lora 4x2 + 2x4 = 16, w1 4x8 + w2 8x4 = 64, gate 16
    assert costs.rwkv6_matrix_weights(d=4, H=2, D=2, F=8, lora=2) == 176


def test_flash():
    flops, nbytes = costs.flash_forward(B=1, S=4, H=2, KV=1, D=8)
    assert flops == 4 * 2 * 8 * 10
    assert nbytes == 4 * 8 * (2 * 2 + 2 * 1) * 2 + 4 * 2 * 4  # q k v o in bf16, f32 lse
    bflops, bbytes = costs.flash_backward(B=1, S=4, H=2, KV=1, D=8)
    assert bflops == 10 * 2 * 8 * 10
    assert bbytes == 4 * 8 * (3 * 2 + 2) * 2 + 4 * 2 * 4 + 4 * 8 * (2 + 2) * 2


def test_paged():
    # one slot, one live row at position 16: 17 keys on 2 pages of 16
    slots = [(1, 17)]
    assert costs.paged_attention_bytes(slots, KV=1, D=8, H=2, block_size=16) == \
        2 * 16 * 1 * 8 * 2 * 2 + 2 * 1 * 2 * 8 * 2
    assert costs.paged_attention_flops(slots, H=2, D=8) == 4 * 2 * 8 * 17


def test_wkv():
    f, b = costs.wkv_forward(B=1, S=2, H=1, D=4)
    assert f == 6 * 16 * 2 and b == 3 * 8 * 2 + 4 * 8 + 4 * 8 + 4 * 4
    f, b = costs.wkv_backward(B=1, S=2, H=1, D=4)
    assert f == 8 * 16 * 2 and b == 6 * 8 * 2 + 12 * 8 + 8 * 4


def test_bound_takes_the_larger_floor():
    assert costs.bound_s(989e12, 0) == pytest.approx(1.0)
    assert costs.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def _cfg(**kw):
    base = dict(d_model=4, n_heads=2, n_kv_heads=1, d_head=2, d_ff=8, n_layers=3,
                vocab_size=10, layer_pattern=("attn",), rnn_heads=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_serving_step_flops():
    cfg = _cfg()
    rec = StepRecord(t0=0.0, t1=1.0, rows=3, slots=[(2, 5), (1, 9)], sampled=2)
    # rows x 2 x 144 x 3 layers; pairs (4 + 5) + 9 = 18 at 4 x 2 x 2 a pair a layer;
    # the head for 2 tokens
    assert step_flops(cfg, rec) == 3 * 2 * 144 * 3 + 16 * 3 * 18 + 2 * 4 * 10 * 2


def test_training_model_flops():
    cfg = _cfg()
    run = types.SimpleNamespace(cfg=cfg, cell=types.SimpleNamespace(
        traffic={"batch": 2, "seq_len": 4}))
    weights = 144 * 3 + 4 * 10
    assert readers.train_model_flops_per_step(run) == \
        6 * weights * 8 + 3 * 16 * 2 * 10 * 3

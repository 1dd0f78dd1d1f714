"""The traffic generators and the weights repeat exactly for a seed, and
every seed draws the same set of sizes."""
import numpy as np
import torch

from bench.portbench import draw, spec, weights

SEED = 5_000_000_017  # past 32 bits, as the driver's are


def _closed(seed):
    mix = spec._json(spec.BENCH_DIR / "traffic" / "decode_closed.json")
    return spec.generator("closed_loop").make(mix, 151936, seed, 30.0)


def _open(seed):
    mix = spec._json(spec.BENCH_DIR / "traffic" / "code_open.json")
    return spec.generator("open_loop").make(mix, 151936, seed, 30.0)


def test_closed_loop_repeats_for_a_seed():
    a, b = _closed(SEED).first(), _closed(SEED).first()
    assert a == b
    assert _closed(SEED).next(3) == _closed(SEED).next(3)
    assert a != _closed(SEED + 1).first()


def test_closed_loop_sizes_are_one_set_for_every_seed():
    sizes = [sorted((len(r["prompt"]), r["max_new"]) for r in _closed(s).first())
             for s in (SEED, 7)]
    assert sorted(x[0] for x in sizes[0]) == sorted(x[0] for x in sizes[1])
    assert sorted(x[1] for x in sizes[0]) == sorted(x[1] for x in sizes[1])
    reqs = _closed(SEED).first()
    assert len(reqs) == 256 and all(128 + 64 <= len(r["prompt"]) <= 128 + 512 for r in reqs)
    assert all(128 <= r["max_new"] <= 1024 for r in reqs)
    # clients of one tenant share its system prompt
    assert reqs[0]["prompt"][:128] == reqs[4]["prompt"][:128] != reqs[1]["prompt"][:128]


def test_open_loop_repeats_and_offers_the_same_work():
    a, b, c = _open(SEED), _open(SEED), _open(SEED + 1)
    assert [(t, r["prompt"], r["max_new"]) for t, r in a.arrivals] == \
        [(t, r["prompt"], r["max_new"]) for t, r in b.arrivals]
    assert len(a.arrivals) == len(c.arrivals)
    assert sorted(len(r["prompt"]) for _, r in a.arrivals) == \
        sorted(len(r["prompt"]) for _, r in c.arrivals)
    assert np.isclose(a.arrivals[-1][0], c.arrivals[-1][0] + 0.0, rtol=0.1)
    offs = [t for t, _ in a.arrivals]
    assert offs == sorted(offs) and offs[0] == 0.0
    assert all(32 + 512 <= len(r["prompt"]) <= 32 + 1856 and 8 <= r["max_new"] <= 96
               for _, r in a.arrivals)


def test_quantile_sets():
    q = draw.quantile_set(4, {"dist": "loguniform", "lo": 8, "hi": 96})
    assert list(q) == sorted(q) and q[0] >= 8 and q[-1] <= 96
    e = draw.quantile_set(1000, {"dist": "exponential", "mean": 2.0})
    assert abs(e.mean() - 2.0) < 0.05


def test_train_batches_repeat_and_rows_differ():
    mix = spec._json(spec.BENCH_DIR / "traffic" / "train_b8_s4096.json")
    mix = dict(mix, batch=4, seq_len=16)
    gen = spec.generator("train_batches")
    a, b = gen.make(mix, 1000, SEED, "cpu"), gen.make(mix, 1000, SEED, "cpu")
    for s in (1, 2):
        assert torch.equal(a.batch(s)["tokens"], b.batch(s)["tokens"])
    x = a.batch(1)
    assert torch.equal(x["tokens"][:, 1:], x["targets"][:, :-1])
    assert not torch.equal(a.batch(1)["tokens"], a.batch(2)["tokens"])
    assert len({tuple(r.tolist()) for r in x["tokens"]}) == 4


def test_weights_repeat_and_follow_their_rules():
    layout = {"blocks": {"stack": ({"attn": {"ln": {"scale": torch.empty(2, 8)},
                                             "wo": torch.empty(2, 8, 8, dtype=torch.bfloat16),
                                             "w_k": torch.empty(2, 64, 64, dtype=torch.bfloat16),
                                             "mix_r": torch.empty(2, 8)}},),
                         "tail": ()},
              "embed": torch.empty(64, 8, dtype=torch.bfloat16)}
    a = weights.draw(layout, SEED, "rmsnorm", "cpu")
    b = weights.draw(layout, SEED, "rmsnorm", "cpu")
    c = weights.draw(layout, SEED + 1, "rmsnorm", "cpu")
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert not torch.equal(a[("embed",)], c[("embed",)])
    mix = a[("blocks", "stack", 0, "attn", "mix_r")]
    assert mix.min() > 0 and mix.max() < 1
    # RWKV-6's time-mix keys at ten times the other matrices' 0.02
    key = a[("blocks", "stack", 0, "attn", "w_k")].float()
    assert 0.18 < key.std() < 0.22 and a[("embed",)].float().std() < 0.03
    assert a[("embed",)].dtype == torch.bfloat16
    tree = weights.rebuild(layout, a)
    assert tree["embed"] is a[("embed",)] and tree["blocks"]["tail"] == ()

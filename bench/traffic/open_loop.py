"""Open loop: requests due on the wall clock whatever the system does.

A mix file of this kind holds::

    {"kind": "open_loop", "rate_per_s": 10.0,            # mean arrivals a second
     "preroll_s": 20.0,                                  # schedule starts this long
     "tenants": 8, "prefix_len": 32,                     # before the window
     "body_len": {"dist": "loguniform", "lo": 512, "hi": 1856},   # after the header
     "output_len": {"dist": "loguniform", "lo": 8, "hi": 96},
     "check_requests": 8}

The schedule has three parts: the pre-roll, the window and a margin of 60 s
after it.  Each part's gaps, body and output lengths are one fixed set
(``draw``) in an order the seed shuffles, the window's gaps scaled to fill
it exactly: every seed offers the window the same requests in another
order.  Gaps are exponential: Poisson arrivals."""
from __future__ import annotations

import numpy as np

from bench.portbench import draw

MARGIN_S = 60.0


class OpenLoop:
    kind = "open"

    def __init__(self, mix: dict, vocab: int, seed: int, seconds: float):
        g = draw.rng(seed, "open_loop")
        self.mix = mix
        self.preroll_s = float(mix["preroll_s"])
        rate = float(mix["rate_per_s"])
        tenants = draw.Tenants(mix["tenants"], mix["prefix_len"], vocab, g)
        self.arrivals = []
        start = 0.0
        for span in (self.preroll_s, float(seconds), MARGIN_S):
            n = max(1, int(round(rate * span)))
            gaps = draw.quantile_set(n, {"dist": "exponential", "mean": 1.0 / rate})
            gaps = g.permutation(gaps) * (span / gaps.sum())
            offsets = start + np.cumsum(gaps) - gaps[0]
            blen = draw.shuffled_set(n, mix["body_len"], g)
            olen = draw.shuffled_set(n, mix["output_len"], g)
            for i in range(n):
                t = int(g.integers(0, len(tenants)))
                self.arrivals.append((float(offsets[i]), {
                    "rid": f"o{len(self.arrivals)}", "tenant": f"t{t}", "max_new": int(olen[i]),
                    "prompt": tenants.prefixes[t] + draw.tokens(g, int(blen[i]), vocab)}))
            start += span


def make(mix: dict, vocab: int, seed: int, seconds: float) -> OpenLoop:
    return OpenLoop(mix, vocab, seed, seconds)

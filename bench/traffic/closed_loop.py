"""Closed loop: ``clients`` callers, each with one request outstanding,
sending the next the moment the last one finishes.

A mix file of this kind holds::

    {"kind": "closed_loop", "clients": 256,
     "tenants": 4, "prefix_len": 128,                  # shared system prompts
     "body_len": {"dist": "loguniform", "lo": 64, "hi": 512},
     "output_len": {"dist": "loguniform", "lo": 128, "hi": 1024},
     "check_requests": 8}                               # requests the check samples

Client i belongs to tenant i mod ``tenants``.  The clients' first requests
take their user-turn and output lengths from one fixed set (``draw``), in an
order the seed shuffles; later requests draw freely."""
from __future__ import annotations

from bench.portbench import draw


class ClosedLoop:
    kind = "closed"

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.clients = int(mix["clients"])
        self.g = draw.rng(seed, "closed_loop")
        self.tenants = draw.Tenants(mix["tenants"], mix["prefix_len"], vocab, self.g)
        self._user = draw.shuffled_set(self.clients, mix["body_len"], self.g)
        self._out = draw.shuffled_set(self.clients, mix["output_len"], self.g)
        self.sent = [0] * self.clients

    def _request(self, client: int, body_len: int, out_len: int) -> dict:
        t = client % len(self.tenants)
        self.sent[client] += 1
        return {"rid": f"c{client}-{self.sent[client] - 1}", "client": client,
                "tenant": f"t{t}", "prompt": self.tenants.prefixes[t]
                + draw.tokens(self.g, body_len, self.vocab), "max_new": int(out_len)}

    def first(self) -> list:
        return [self._request(i, int(self._user[i]), int(self._out[i]))
                for i in range(self.clients)]

    def next(self, client: int) -> dict:
        return self._request(client, int(draw.sample(self.mix["body_len"], self.g)),
                             int(draw.sample(self.mix["output_len"], self.g)))


def make(mix: dict, vocab: int, seed: int, seconds: float) -> ClosedLoop:
    return ClosedLoop(mix, vocab, seed)

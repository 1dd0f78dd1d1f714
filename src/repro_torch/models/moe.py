"""Mixture-of-Experts FFN stage (the port's ``repro/models/moe.py``).

Two dispatch implementations, selected by ``ExecutionPlan.moe_dispatch``:

* ``gshard``: grouped one-hot dispatch (GShard/Switch style), the serving
  default.  Tokens dispatch in groups of ``group_size``; each (token, k)
  takes the next free slot of its expert's queue in its group, up to the
  capacity ``max(1, int(g K cf / E))``, and is dropped past it.  Dispatch
  and combine are matrix products over one-hot (slot) operands, as JAX
  computes them: the dispatch in the activations' dtype, the combine in
  f32.
* ``sort``: a stable argsort of the (token, k) assignments into (E, C, d)
  buffers (MegaBlocks-style dropping, C over the whole T), the expert
  outputs scattered back with their gates in f32.

Under data parallelism (``MoESettings.dp``: mesh, axes) each rank routes its own
rows and the aux loss's statistics are averaged over the ranks, so the aux
loss is the whole batch's, as in JAX.  Under tensor parallelism without SP
(``tp=(mesh, split)``, the plan's ``moe_mode``) the router, its top-k and
the aux loss run whole on every rank, on the replicated tokens, so the aux
loss is the same everywhere:

* ``ep``: this rank holds E/n experts.  GShard dispatches to its slice of
  the combine tensor, runs those experts and combines their outputs into a
  partial (T, d), which Megatron's g (``dist.collectives.row_sum``) sums;
  the tokens and the combine tensor enter through f (``column_input``).
  The sort dispatch fills the whole (E, C, d) buffer, runs its experts' rows
  and sums the zero-padded outputs with g.
* ``tp``: every expert's ``w1`` / ``w3`` are column shards and ``w2`` a
  row shard: the dispatched (E, C, d) inputs enter through f, g sums the
  experts' partial outputs after ``w2``, and the combine runs whole.

The module holds no Pallas kernel: its products are ``torch`` matmuls, as
the JAX package leaves them to XLA.  JAX's three-operand combine einsum
(moe.py:93) has one non-zero term per (token, expert, slot), since a
token's top-k experts are distinct and a slot holds one (token, k); the
port writes the gates into the (T, E, C) combine tensor directly, which
gives the same values without the (G, g, K, E, C) product.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 1024  # gshard dispatch group (tokens)
    dispatch: str = "gshard"  # gshard | sort
    # (mesh, the axes that split the batch): the aux loss's statistics are
    # taken over every rank's tokens (``router_topk``)
    dp: Optional[tuple] = None


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int, dp=None):
    """x: (T, d) -> (gates (T, k) f32, idx (T, k) int64, aux load-balance
    loss f32).  The top k in descending order, the lower expert first on a
    tie (``lax.top_k``'s order; ``torch.topk`` leaves ties unspecified, a
    stable descending sort does not).  ``dp`` (mesh, the axes that split
    the batch): the aux loss's mean probabilities and expert shares are
    taken over every rank's tokens, as JAX takes them over the whole
    batch."""
    logits = x.float() @ w_router.float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :top_k], idx[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss
    E = w_router.shape[-1]
    me = probs.mean(dim=0)
    # each expert's count of choices, by an index_add of ones: exact integers,
    # and a static shape (bincount's depends on the values; the dry run traces
    # on the meta device)
    flat = idx.reshape(-1)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
    ce = torch.zeros(E, dtype=torch.float32, device=flat.device).index_add_(0, flat, ones)
    ce = ce / idx.numel()
    if dp is not None:
        from repro_torch.dist.collectives import batch_mean

        me, ce = batch_mean(me, dp[1], mesh=dp[0]), batch_mean(ce, dp[1], mesh=dp[0])
    aux = E * torch.sum(me * ce)
    return gates, idx, aux


def _expert_ffn(params: dict, xe: torch.Tensor, activation: str) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d), batched over experts."""
    h = torch.bmm(xe, params["w1"])
    if activation in ("swiglu", "geglu"):
        act = F.silu(h) if activation == "swiglu" else F.gelu(h, approximate="tanh")
        del h
        h = act * torch.bmm(xe, params["w3"])
        del act
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, params["w2"])


# ---------------------------------------------------------------------------
# GShard grouped dispatch
# ---------------------------------------------------------------------------
def gshard_groups(T: int, st: MoESettings):
    """(g, G, cap): tokens a group (``group_size`` halved until it divides
    T), groups, and each expert's slots a group."""
    g = min(st.group_size, T)
    while T % g:
        g //= 2
    return g, T // g, max(1, int(g * st.top_k * st.capacity_factor / st.n_experts))


def queue_ranks(idxg: torch.Tensor, n_experts: int) -> torch.Tensor:
    """idxg: (G, g, K) expert of each (token, k) -> (G, g, K) its rank in its
    expert's queue within its group: the count of earlier entries with the
    same expert in the token-major (g x K) order (an exclusive cumsum)."""
    G, g, K = idxg.shape
    flat = idxg.reshape(G, g * K)
    onehot = F.one_hot(flat, n_experts).to(torch.int32)  # (G, g K, E)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return pos.gather(-1, flat[..., None]).reshape(G, g, K)


def gshard_route(x: torch.Tensor, w_router: torch.Tensor, st: MoESettings):
    """Router and slot assignment: (combine (G, g, E, cap) f32, aux).
    ``combine[G, s, e, c]`` is token s's gate if one of its k choices took
    slot c of expert e, else 0 (a dropped choice takes none)."""
    T = x.shape[0]
    E, K = st.n_experts, st.top_k
    g, G, cap = gshard_groups(T, st)
    gates, idx, aux = router_topk(x, w_router, K, st.dp)
    idxg = idx.reshape(G, g, K)
    pos = queue_ranks(idxg, E)
    in_cap = pos < cap
    dev = x.device
    tok = torch.arange(G * g, device=dev).reshape(G, g, 1)
    flat = (tok * E + idxg) * cap + pos  # (G, g, K) into the flattened combine
    n = G * g * E * cap
    # a dropped choice writes the drop bin (entry n, never read): a static
    # shape where a boolean mask's would depend on the values
    slot = torch.where(in_cap, flat, n).reshape(-1)
    combine = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    combine[slot] = gates.reshape(-1).to(torch.float32)
    return combine[:n].reshape(G, g, E, cap), aux


def gshard_dispatch(combine: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One-hot dispatch product: (E, G cap, d) expert inputs in x's dtype."""
    G, g, E, cap = combine.shape
    dispatch = (combine > 0).to(x.dtype).reshape(G, g, E * cap)
    xe = torch.bmm(dispatch.transpose(1, 2), x.reshape(G, g, -1))  # (G, E cap, d)
    del dispatch
    return xe.reshape(G, E, cap, -1).transpose(0, 1).reshape(E, G * cap, -1)


def gshard_combine(combine: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """f32 combine product: (T, d) f32 from the expert outputs (E, G cap, d)."""
    G, g, E, cap = combine.shape
    d = ye.shape[-1]
    ye32 = torch.empty((G, E, cap, d), dtype=torch.float32, device=ye.device)
    ye32.copy_(ye.reshape(E, G, cap, d).transpose(0, 1))  # one f32 copy, group-major
    return torch.bmm(combine.reshape(G, g, E * cap), ye32.reshape(G, E * cap, d)).reshape(
        G * g, d)


def _tp_ops(tp):
    """(f, g, this rank's index, ranks) of a ``tp`` pair over ``model``."""
    from repro_torch.dist.collectives import column_input, row_sum

    mesh = tp[0]
    return (lambda t: column_input(t, mesh=mesh), lambda t: row_sum(t, mesh=mesh),
            mesh.index("model"), mesh.extent("model"))


def _split_experts(params: dict, xe: torch.Tensor, activation: str, tp) -> torch.Tensor:
    """The experts on (E, C, d) inputs, whole or, under ``tp``'s split,
    summed over the ranks: ``ep`` runs this rank's experts' rows and sums
    the zero-padded outputs, ``tp`` its slice of every expert's width."""
    if tp is None:
        return _expert_ffn(params, xe, activation)
    f, g, r, n = _tp_ops(tp)
    xe = f(xe)
    if tp[1] == "tp":
        return g(_expert_ffn(params, xe, activation))
    El = params["w1"].shape[-3]
    ye = _expert_ffn(params, xe.narrow(0, r * El, El), activation)
    return g(torch.cat([ye.new_zeros((r * El,) + ye.shape[1:]), ye,
                        ye.new_zeros(((n - r - 1) * El,) + ye.shape[1:])]))


def moe_gshard(params: dict, x: torch.Tensor, st: MoESettings, activation: str, tp=None):
    """x: (T, d) -> ((T, d) in x's dtype, aux).  Groups of g tokens dispatch
    independently (bounds the one-hot size and the products' flops).  With
    ``tp`` (mesh, "ep" | "tp"): the module's tensor-parallel splits."""
    combine, aux = gshard_route(x, params["router"], st)
    if tp is not None and tp[1] == "ep":
        f, g, r, _ = _tp_ops(tp)
        El = params["w1"].shape[-3]
        local = f(combine).narrow(2, r * El, El)  # this rank's experts' slots
        ye = _expert_ffn(params, gshard_dispatch(local, f(x)), activation)
        return g(gshard_combine(local, ye)).to(x.dtype), aux
    ye = _split_experts(params, gshard_dispatch(combine, x), activation, tp)
    return gshard_combine(combine, ye).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Sort-based dispatch
# ---------------------------------------------------------------------------
def moe_sort(params: dict, x: torch.Tensor, st: MoESettings, activation: str, tp=None):
    T, d = x.shape
    E, K = st.n_experts, st.top_k
    N = T * K
    C = max(1, int(T * K * st.capacity_factor / E))

    gates, idx, aux = router_topk(x, params["router"], K, st.dp)
    flat_e = idx.reshape(N)
    flat_gate = gates.reshape(N)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank within expert = position - first index of that expert value
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(N, device=x.device) - first
    valid = rank < C
    slot = torch.where(valid, sorted_e * C + rank, E * C)  # E*C = drop bin
    token_of = order // K

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[token_of]  # the drop bin's row is never read
    ye = _split_experts(params, buf[:-1].reshape(E, C, d), activation, tp)
    y_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    contrib = y_flat[slot].float() * (flat_gate[order] * valid)[:, None]
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, token_of, contrib)
    return out.to(x.dtype), aux


def moe_ffn(params: dict, x: torch.Tensor, st: MoESettings, activation: str, tp=None):
    """x: (..., d) -> (..., d), plus the aux loss (f32 scalar).  ``tp``:
    (mesh, "ep" | "tp"), this rank's shards of the experts."""
    shape = x.shape
    fn = moe_sort if st.dispatch == "sort" else moe_gshard
    y, aux = fn(params, x.reshape(-1, shape[-1]), st, activation, tp)
    return y.reshape(shape), aux

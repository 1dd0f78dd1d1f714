"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference, each number held to the cell's limit.

* Serving: for a sample of the requests the window served (drawn from the
  seed, the longest always in it), the reference runs once over each
  prompt with its served tokens; ``logit_gap`` is the widest gap by which a
  served token's reference logit lies below the reference's best.  The
  control, the reference in float8, reads the same gap for the token it
  puts first at each of those positions.
* Training: ``loss_gap`` is the widest gap between the program's and the
  reference's loss over the job's first steps, ``first_loss_gap`` the
  first step's (the forward alone, before any update); ``grad_gap`` and
  ``change_gap`` the worst layer-leaf's gap between the two norms (of the
  first gradient AdamW received, and of the parameters' change over those
  steps), over the reference's norm of that leaf or of the median leaf,
  whichever is larger.  Leaves whose reference gradient is under a
  thousandth of the median leaf's move by round-off alone and are left out
  of ``change_gap``."""
from __future__ import annotations

import statistics

import torch

from bench.portbench import draw, weights
from bench.reference.fp8 import strict_f32


def reference_class(name: str):
    if name == "decoder":
        from bench.reference.decoder import Decoder
        return Decoder
    if name == "rwkv6":
        from bench.reference.rwkv6 import RWKV6
        return RWKV6
    raise ValueError(f"no reference {name!r}")


def sizes_of(cfg) -> dict:
    return {"d": cfg.d_model, "H": cfg.n_heads, "KV": cfg.n_kv_heads, "D": cfg.d_head,
            "F": cfg.d_ff, "layers": cfg.n_layers, "rope_theta": cfg.rope_theta,
            "V": cfg.vocab_size}


def sample_requests(tracks: list, n: int, seed: int) -> list:
    """``n`` of the served requests, drawn from the seed, with the longest
    (prompt and served tokens) among them."""
    cands = sorted((tr for tr in tracks if tr.req.out), key=lambda tr: tr.req.rid)
    if len(cands) <= n:
        return cands
    longest = max(cands, key=lambda tr: (len(tr.req.prompt) + len(tr.req.out), tr.req.rid))
    rest = [tr for tr in cands if tr is not longest]
    g = draw.rng(seed, "check_sample")
    pick = g.choice(len(rest), size=n - 1, replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def serve_numbers(model_cls, sizes, leaves32: dict, records: list, control: bool,
                  device) -> dict:
    """``logit_gap`` over ``records`` ((prompt, served tokens) pairs), and
    with ``control`` the float8 reference's ``logit_gap.fp8``."""
    strict_f32()
    ref = model_cls(sizes, leaves32, "f32")
    low = model_cls(sizes, leaves32, "fp8") if control else None
    gap, cgap, n_tok = 0.0, 0.0, 0
    for prompt, out in records:
        toks = torch.tensor(prompt + out[:-1], device=device)
        rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out), device=device)
        logits = ref.logits_at(toks, rows)
        best = logits.max(-1).values
        served = logits.gather(-1, torch.tensor(out, device=device)[:, None])[:, 0]
        gap = max(gap, float((best - served).max()))
        n_tok += len(out)
        if low is not None:
            first = low.logits_at(toks, rows).argmax(-1)
            cgap = max(cgap, float((best - logits.gather(-1, first[:, None])[:, 0]).max()))
        del logits
    out = {"logit_gap": gap, "tokens_compared": n_tok}
    if control:
        out["logit_gap.fp8"] = cgap
    return out


def _gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |program norm - reference norm| / max(reference norm, median)}."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> list:
    """The ``n`` leaves with the widest gaps, for the record:
    [path/layer, gap, program norm, reference norm]."""
    g = _gaps(prog, ref)
    top = sorted(g, key=lambda k: -g[k])[:n]
    return [["/".join(map(str, k[0])) + ("" if k[1] is None else f"[{k[1]}]"), g[k], prog[k],
             ref[k]] for k in top]


def train_numbers(prog: dict, ref: dict) -> dict:
    """The gaps between the program's readings and the reference's
    (``training.check_steps`` and ``reference.train.follow``): the worst
    leaf's, and the median leaf's (``*_median``), which is steady from seed
    to seed where one small leaf's gradient is ill-conditioned."""
    med_g = statistics.median(ref["grad"].values())
    moving = {k for k, v in ref["grad"].items() if v >= 1e-3 * med_g}
    grad = _gaps(prog["grad"], ref["grad"])
    change = _gaps(prog["change"], ref["change"], moving)
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
        "first_loss_gap": abs(prog["losses"][0] - ref["losses"][0]),
        "grad_gap": max(grad.values()),
        "grad_gap_median": statistics.median(grad.values()),
        "change_gap": max(change.values()),
        "change_gap_median": statistics.median(change.values()),
        "left_out": len(ref["grad"]) - len(moving),
    }


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): each number the cell's limits
    name, at or under its limit; a missing number or limit cannot pass."""
    rows, ok = [], bool(limits)
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        rows.append((name, value, lim))
        ok = ok and lim is not None and value == value and value <= lim
    return ok, rows


CONTROLS = ("fp8", "half_batch", "bf16_witness")


def control_tags(arg: str) -> tuple:
    """``--control``: ``0`` none, ``1`` all, else a comma list of ``CONTROLS``."""
    if arg in ("0", ""):
        return ()
    if arg == "1":
        return CONTROLS
    tags = tuple(t for t in arg.split(",") if t)
    bad = [t for t in tags if t not in CONTROLS]
    if bad:
        raise ValueError(f"--control {arg!r}: no control {bad}; have {CONTROLS}")
    return tags


def judge_controls(numbers: dict, limits: dict) -> dict:
    """{tag: correct} of each control or fault read beside the program
    (``<number>.<tag>`` readings, ``--control 1``), judged by ``judge`` on
    the cell's own limits: the float8 control and the half batch have to
    come out not correct."""
    out = {}
    for tag in CONTROLS:
        theirs = {k: numbers[f"{k}.{tag}"] for k in limits if f"{k}.{tag}" in numbers}
        if theirs:
            out[tag] = judge(theirs, limits)[0]
    return out


def redraw(layout, seed: int, cfg, device, dtype=None) -> dict:
    """The weights again, as the harness drew them for the program."""
    leaves = weights.draw(layout, seed, cfg.norm, device)
    if dtype is not None:
        leaves = {p: x.to(dtype) for p, x in leaves.items()}
    return leaves

"""The comparisons that decide ``correct``, each number beside its limit.

Serving: a sample of the finished requests, drawn from the seed with the
longest among them (and, where the run preempted any, up to two of those),
of at least ``sample_tokens`` served tokens. The reference runs once over
each prompt with its served tokens; a served token's gap is how far its
reference logit lies below the reference's best at that position, and the
number compared is the widest gap. Greedy decoding serves the program's
best, so a sound program's gaps are rounding and routing flips near ties.
The control (``served_gaps(control=True)``) reads, at the same positions, the gap of
the token that the reference computed in float8 puts first.
"""
from __future__ import annotations

import numpy as np
import torch

from . import family
from .plain import no_tf32


def check(value, limit, held: bool | None = None) -> dict:
    ok = value is not None and value <= limit if held is None else held
    return {"value": value, "limit": limit, "held": bool(ok)}


def sample(finished: list, seed: int, tokens: int) -> list:
    """(prompt, served, preempted) triples: the longest, up to two that were
    preempted, then others in an order drawn from the seed until ``tokens``
    served tokens are covered."""
    if not finished:
        return []
    rng = np.random.default_rng([seed % 2 ** 64, 7])
    longest = max(range(len(finished)), key=lambda j: len(finished[j][1]))
    chosen = [longest]
    pre = [j for j, f in enumerate(finished) if f[2] and j != longest]
    rng.shuffle(pre)
    chosen += pre[:2]
    rest = [j for j in range(len(finished)) if j not in chosen]
    rng.shuffle(rest)
    while rest and sum(len(finished[j][1]) for j in chosen) < tokens:
        chosen.append(rest.pop())
    return [finished[j] for j in chosen]


def _seqs(picked: list) -> list:
    return [(list(p) + list(out[:-1]), len(p)) for p, out, _ in picked]


def _gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's best."""
    return ref.max(-1).values - ref.gather(1, tokens[:, None])[:, 0]


def served_gaps(params: dict, conf: dict, picked: list, control: bool = False) -> dict:
    """Each served token's gap (``program``) over the sampled requests and,
    with ``control``, at the same positions the gap of the token the float8
    reference puts first (``control``)."""
    no_tf32()
    fam = family(conf)
    ref = fam.served_logits(params, conf["port"], _seqs(picked))
    out = {"program": torch.cat([_gaps(r, torch.tensor(s, device=r.device))
                                 for r, (_, s, _) in zip(ref, picked)])}
    if control:
        low = fam.served_logits(params, conf["port"], _seqs(picked), precision="fp8")
        out["control"] = torch.cat([_gaps(r, lw.argmax(-1)) for r, lw in zip(ref, low)])
    return out


def gap_numbers(gaps: torch.Tensor) -> dict:
    """The widest gap, the mean gap and the share of tokens with a gap."""
    return {"widest_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "gap_share": float((gaps > 0).float().mean())}


def served(params: dict, conf: dict, finished: list, cell: dict, seed: int,
           unanswered: int) -> dict:
    """The serving cell's checks: the mean gap over the sampled served
    tokens (the widest is printed beside it), and no request unanswered."""
    c = cell["check"]
    picked = sample(finished, seed, c["sample_tokens"])
    nums = gap_numbers(served_gaps(params, conf, picked)["program"]) if picked else {}
    print(f"bench: reference over {len(picked)} requests, "
          f"{sum(len(f[1]) for f in picked)} served tokens "
          f"({sum(f[2] for f in picked)} of the requests preempted on the way): {nums}")
    return {"mean_gap": check(nums.get("mean_gap"), c["mean_gap"]),
            "unanswered": check(unanswered, 0)}


def leaf_gaps(got: dict, want: dict, leaves) -> dict:
    """Per leaf, the gap between the program's and the reference's norm of
    it, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    med = float(np.median([want[k] for k in want]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in leaves}


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training cell's three numbers from the program's readings and
    the reference's (``train_ref.run_steps``): the first step's loss (a
    later step's forward reads bfloat16 weights that cannot yet hold the
    warm-up's small updates, in the program and in any lower precision
    alike), the worst leaf's first gradient and the worst leaf's change.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone under Adam and are left out of the
    change."""
    med_g = float(np.median(list(ref["first_grad"].values())))
    moved = [k for k, g in ref["first_grad"].items() if g >= 1e-3 * med_g]
    return {"loss_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "first_grad_gap": max(leaf_gaps(prog["first_grad"], ref["first_grad"],
                                            ref["first_grad"]).values()),
            "change_gap": max(leaf_gaps(prog["change"], ref["change"], moved).values()),
            "left_out": sorted(set(ref["first_grad"]) - set(moved))}


def trained(params: dict, conf: dict, cell: dict, batches: list, prog: dict) -> dict:
    from . import train_ref

    ref = train_ref.run_steps(params, conf, batches, cell["optimizer"], cell["microbatches"])
    got = train_numbers(prog, ref)
    print(f"bench: reference over {len(batches)} steps: losses {ref['losses']} against "
          f"{prog['losses']}; leaves left out of the change: {got['left_out']}")
    print(f"bench: first-step loss gap {got['loss_gap']} (not compared: no lower precision "
          "or fault reads three times it)")
    return {k: check(got[k], lim) for k, lim in cell["check"].items()}

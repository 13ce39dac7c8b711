"""The comparison that decides ``correct`` for a training cell.

Set-up drives the program's round from the seed through its first
rounds (``runners/fed_round.py``'s ``CHECKED_ROUNDS``), on the same feed
as the window; the reference follows them from the same weights and
inputs once the window has closed.
The numbers, each compared against the cell's limit:

* ``loss_gap``: over the rounds, the largest gap between the program's
  mean local loss and the reference's, over the reference's;
* ``update_gap``: the first round's update ``w1 - w0`` (the gradient as
  the optimizer takes it: compressed, weighted and mixed); for each leaf
  the gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; the worst leaf;
* ``change_gap``: the same of the change ``w_n - w0`` after the checked
  rounds;
* ``update_median_gap``, ``change_median_gap``: the median leaf's gap
  (the lower one of the two middle leaves), steady from seed to seed
  where one small leaf's noise sets the worst leaf.

A cell's ``limits`` name the numbers it compares.

Leaves whose gradient is nought to rounding move by round-off alone; a
leaf whose gradient in the reference (its first group's first step) is
under a thousandth of the median leaf's is left out of both leaf
numbers.  None is left out at the cells' configurations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

NOUGHT = 1e-3


@dataclass
class Readings:
    """One side's readings of the checked rounds."""
    names: List[str]
    losses: List[float] = field(default_factory=list)
    update: List[float] = field(default_factory=list)
    change: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)


def leaf_norms(new: Dict, old: Dict) -> Tuple[List[str], List[float]]:
    """Each leaf's norm of ``new - old``, summed in float64."""
    import torch
    from perfbench.reference.fed_round import flatten
    a, b = flatten(new), flatten(old)
    if [p for p, _ in a] != [p for p, _ in b]:
        raise ValueError("the two weight trees have different leaves")
    norms = torch.stack([torch.linalg.vector_norm(
        (x.detach() - y.detach()).to(torch.float32), dtype=torch.float64)
        for (_, x), (_, y) in zip(a, b)])
    return [p for p, _ in a], norms.tolist()


def _leaf_gaps(got: List[float], want: List[float], keep: List[int]
               ) -> List[Tuple[float, int]]:
    med = float(np.median([want[i] for i in keep]))
    return [(abs(got[i] - want[i]) / max(want[i], med), i) for i in keep]


def gaps(prog: Readings, ref: Readings) -> Dict[str, Dict]:
    """The numbers of the module docstring, each with where it was
    read."""
    if prog.names != ref.names:
        raise ValueError("program and reference hold different leaves")
    med = float(np.median(ref.grad_norms))
    keep = [i for i, g in enumerate(ref.grad_norms) if g >= NOUGHT * med]
    loss = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]
    if len(prog.losses) != len(ref.losses) or not all(
            np.isfinite(prog.losses)):
        loss_gap, at = float("inf"), 0
    else:
        loss_gap, at = max((v, i) for i, v in enumerate(loss))
    out = {"loss_gap": {"value": loss_gap, "at": f"round {at + 1}"}}
    for key, p, r in (("update", prog.update, ref.update),
                      ("change", prog.change, ref.change)):
        if not np.all(np.isfinite(p)):
            for name in (key + "_gap", key + "_median_gap"):
                out[name] = {"value": float("inf"), "at": "not finite"}
            continue
        gaps = sorted(_leaf_gaps(p, r, keep))
        v, i = gaps[-1]
        out[key + "_gap"] = {"value": v, "at": ref.names[i]}
        v, i = gaps[(len(gaps) - 1) // 2]
        out[key + "_median_gap"] = {"value": v, "at": ref.names[i]}
    return out


def judge(found: Dict[str, Dict], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict]]:
    """-> (every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": found[k]["value"], "limit": limits[k]}
              for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def excluded(ref: Readings) -> List[str]:
    med = float(np.median(ref.grad_norms))
    return [n for n, g in zip(ref.names, ref.grad_norms) if g < NOUGHT * med]


def format_checks(checks: Dict[str, Dict], where: Optional[Dict] = None
                  ) -> List[str]:
    lines = []
    for k, c in checks.items():
        at = f" (worst at {where[k]['at']})" if where and k in where else ""
        lines.append(f"check {k} {c['value']!r} limit {c['limit']!r}{at}")
    return lines

"""The numbers that decide `correct`, each beside its limit.

Training: the program's set-up calls (the warm-up bundle and the first
replay of the captured graph: 2k steps) against the reference's 2k
steps, from the same first weights, images and generator seed:
  loss_gap     the largest relative gap of the 2k steps' losses (the
               last k are the replay's);
  grad_gap     the worst leaf's gap between the norms of the first
               gradient as the optimizer got it (the program's from its
               Adam state after one step, exp_avg / (1 - beta1)), against
               the reference's norm of that leaf or the median leaf's,
               whichever is larger;
  change_gap   the same of the parameters' change over the 2k steps (as
               the replay leaves them), over the leaves whose reference
               gradient is at least a thousandth of the median leaf's
               (the others move under Adam by round-off alone);
  frozen_moved the largest change of a leaf the reference leaves alone
               (a frozen camera), exact: limit 0;
  nonfinite    bundles of the window whose loss was not finite: limit 0.
"""

from __future__ import annotations

import math
import statistics

import torch

SMALL_GRAD = 1e-3      # of the median leaf's reference gradient norm


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def worst_leaf_gap(prog: dict, ref: dict, names) -> float:
    """max over `names` of |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖);
    a leaf missing on the program's side reads as norm 0."""
    names = list(names)
    if not names:
        return 0.0
    rn = {k: _norm(ref[k]) for k in names}
    med = statistics.median(rn.values())
    worst = 0.0
    for k in names:
        pn = _norm(prog[k]) if k in prog else 0.0
        den = max(rn[k], med)
        gap = abs(pn - rn[k]) / den if den > 0 else (0.0 if pn == 0 else math.inf)
        worst = max(worst, gap if math.isfinite(pn) else math.inf)
    return worst


def training(prog: dict, ref: dict, p0: dict, nonfinite: int) -> dict:
    """{number: value}. prog / ref: {"losses": [...], "grad": {leaf: first
    gradient}, "params": {leaf: after the steps}}; p0: the first weights."""
    lp, lr = prog["losses"], ref["losses"]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12) if math.isfinite(a) else math.inf
                   for a, b in zip(lp, lr))
    if len(lp) != len(lr):      # a step missing on either side
        loss_gap = math.inf
    learnt = sorted(ref["grad"])
    grad_gap = worst_leaf_gap(prog["grad"], ref["grad"], learnt)
    gn = {k: _norm(ref["grad"][k]) for k in learnt}
    med = statistics.median(gn.values()) if gn else 0.0
    moving = [k for k in learnt if gn[k] >= SMALL_GRAD * med]
    d_prog = {k: prog["params"][k].double() - p0[k].double() for k in moving
              if k in prog["params"]}
    d_ref = {k: ref["params"][k].double() - p0[k].double() for k in moving}
    change_gap = worst_leaf_gap(d_prog, d_ref, moving)
    frozen = [k for k in p0 if k not in ref["grad"]]
    frozen_moved = max((float((prog["params"][k].double() - p0[k].double()).abs().max())
                        for k in frozen if k in prog["params"]), default=0.0)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "frozen_moved": frozen_moved, "nonfinite": float(nonfinite)}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}): every number finite and at
    or under its limit; a number without a limit fails."""
    out, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        out[k] = {"value": v, "limit": lim}
        if lim is None or not math.isfinite(v) or v > lim:
            ok = False
    return ok, out

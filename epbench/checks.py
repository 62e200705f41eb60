"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference (``epbench.reference``), with TF32 off.

* ``mean_gap`` (served decode): over every sequence of a finished cycle
  and every generated position, the mean gap by which the served token's
  logit lies below the reference's best, over that position's spread
  (the standard deviation of its logits).
* ``grad_gap``, ``change_gap`` (training): each leaf's norm of the first
  gradient as the optimizer got it, and of its change after the steps;
  the gap between the program's norm and the reference's over the larger
  of that leaf's and the median leaf's reference norm, the worst leaf.
  ``grad_diff``: the median leaf's norm of the difference between the
  program's first gradient and the reference's, over the reference's
  norm.  Leaves whose reference gradient is under a thousandth of the
  median leaf's (the routers' selection-only bias) move by round-off
  alone and are left out, by that rule.  Each step's loss is read
  (``_loss_gap``) and not compared.

PERF.md §2 gives why these numbers, the readings each limit was set from,
and the limits (``limits/<cell>.json``).  Each control
(``precision="fp8"``) reads the same number from the reference computed
with fp8 products in the program's place.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from epbench.reference import model as M
from epbench.reference import train as RT


@contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(best - ref[chosen]) / std(ref) at every position: ref (..., V)."""
    best = ref.max(-1).values
    got = torch.gather(ref, -1, chosen[..., None].long())[..., 0]
    return (best - got) / ref.std(-1)


def gap_stats(g: torch.Tensor) -> dict:
    """Summary of per-position gaps: the widest, the mean, quantiles, the
    share over 0.1 of a spread."""
    q = torch.quantile(g.reshape(-1).float(),
                       torch.tensor([0.5, 0.9, 0.99], device=g.device))
    return {"max": float(g.max()), "mean": float(g.mean()),
            "p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
            "over_0.1": float((g > 0.1).float().mean())}


def decode_gaps(params, seqs, P, sz, control: bool = False,
                block: int = 8):
    """seqs (B, L): prompts and served tokens of one batch.  The reference
    runs the batch's first L - 1 positions (the steps the server ran) and
    reads every sequence's generated ones, ``block`` sequences of logits
    at a time.  Returns the served tokens' gaps (B, L - P), and with
    ``control`` the gaps of the tokens the fp8 reference puts first."""
    B, L = seqs.shape
    got, low = [], []
    with no_tf32(), torch.no_grad():
        h = M.hidden(params, seqs[:, :L - 1], sz, "ll")
        h_low = (M.hidden(params, seqs[:, :L - 1], sz, "ll", "fp8")
                 if control else None)
        for r in range(0, B, block):
            ref = M.head(params, h[r:r + block, P - 1:L - 1], sz)
            got.append(gaps(ref, seqs[r:r + block, P:L]))
            if control:
                lo = M.head(params, h_low[r:r + block, P - 1:L - 1], sz, "fp8")
                low.append(gaps(ref, lo.argmax(-1)))
            del ref
    return torch.cat(got), (torch.cat(low) if control else None)


def decode_numbers(g: torch.Tensor) -> dict:
    """The number compared for served decode tokens' gaps ``g``: their
    mean over every sequence and generated position (the widest gap reads
    routing near-ties, which flip an expert under any rounding:
    PERF.md)."""
    return {"mean_gap": float(g.mean())}


def leaf_gap(prog: dict, ref: dict, keep, base: dict | None = None):
    """The worst leaf's |prog - ref| / max(base, median base) over ``keep``
    (``base`` defaults to ``ref``), and that leaf."""
    base = ref if base is None else base
    med = float(torch.tensor([base[p] for p in keep]).median())
    worst, where = 0.0, ""
    for p in keep:
        g = abs(prog[p] - ref[p]) / max(base[p], med)
        if g > worst:
            worst, where = g, p
    return worst, where


def moved(ref_grads: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = float(torch.tensor(list(ref_grads.values())).median())
    return [p for p, v in ref_grads.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, ref: dict, k: int = 0) -> dict:
    """prog/ref: {"losses", "grad_norms", "change_norms"}; ``ref`` also
    holds each leaf's norm of its difference from other runs
    (``grad_diff``, ``final_diff``), of which ``prog`` is the ``k``-th."""
    keep = moved(ref["grad_norms"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                        ref["losses"]))
    grad_gap, grad_at = leaf_gap(prog["grad_norms"], ref["grad_norms"], keep)
    change_gap, change_at = leaf_gap(prog["change_norms"],
                                     ref["change_norms"], keep)
    # each step's loss is read but not compared: no fault nor the control
    # reads it ten (three) times the program's (PERF.md 2)
    out = {"_loss_gap": loss_gap, "grad_gap": grad_gap,
           "change_gap": change_gap}
    if ref.get("grad_diff"):
        rel = sorted(ref["grad_diff"][k][p] / ref["grad_norms"][p]
                     for p in keep)
        out["grad_diff"] = rel[len(rel) // 2]
        out["_grad_diff_worst"] = rel[-1]
        crel = sorted(ref["final_diff"][k][p] / ref["change_norms"][p]
                      for p in keep)
        out["_change_diff_median"] = crel[len(crel) // 2]
    if "dropped" in prog and "dropped" in ref:
        out["_dropped"] = (prog["dropped"], ref["dropped"])
    out.update({"_gnorm_ratio": prog.get("gnorm", float("nan"))
                / ref["gnorm"] - 1,
                "_grad_leaf": grad_at, "_change_leaf": change_at,
                "_left_out": sorted(set(ref["grad_norms"]) - set(keep)),
                "_grad_worst": sorted(
                    ((prog["grad_norms"][p] / ref["grad_norms"][p] - 1, p)
                     for p in keep), key=lambda r: -abs(r[0]))[:6]})
    return out


def train_reference(initial, batches, sz, hp, steps: int,
                    precision: str = "fp32", others=None,
                    keep: bool = False) -> dict:
    with no_tf32():
        return RT.run(initial, batches, sz, hp, steps, precision, others,
                      keep)

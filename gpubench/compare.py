"""The numbers that decide ``correct``: the program's readings against the
plain reference's, each a gap that is 0 where they agree.

Training (the fits a run checks: set-up's, from the seed's weights, and the
window's first): a loss's gap is ``|program - reference| / |reference|``,
the widest of the steps read (the first steps, the last step of each chunk)
and of each fit's mean; a leaf's norm's gap (its first gradient's, as the
optimizer got it; its change after set-up's fits) is ``|program norm -
reference norm| / max(reference norm of the leaf, median leaf's)``, the gap
of the norms and not the norm of the difference: the gradient's by its
worst leaf, the change's by its median leaf, and the count of leaves whose
change is off by half its own or more. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of the change.

Retrieval: a served score's gap is how far it lies from the reference's
score of the same id, and a served id's rank gap how far the reference's
score of it lies below the reference's own score at that rank, both over
the spread of the reference's top scores. A mean metric's gap is counted in
queries: ``|program - reference| * queries``, the number of queries' worth
by which the two differ (one answer altered moves it by up to 1).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np

ROUNDOFF_SHARE = 1e-3  # a leaf's gradient under this share of the median's moves by round-off
LEAF_OFF = 0.5  # a leaf's change off by this share of its own is unmoved, doubled or lost


def _gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's gap of the norms, over the larger of its reference norm
    and the median leaf's."""
    names = list(names)
    floor = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names}


def fit_means(losses: List[float], steps_per_fit: int) -> List[float]:
    """Each fit's mean loss, from every step's loss."""
    return [statistics.fmean(losses[j * steps_per_fit:(j + 1) * steps_per_fit])
            for j in range(len(losses) // steps_per_fit)]


def observed(full: dict, steps: List[int], steps_per_fit: int) -> dict:
    """A reference's readings (every step's loss) as a run reads the
    program's: the losses of ``steps`` and each fit's mean."""
    return dict(full, losses={s: full["losses"][s] for s in steps},
                fit_losses=fit_means(full["losses"], steps_per_fit))


def training_gaps(prog: dict, ref: dict, steps_per_fit: int,
                  look: Dict[str, object] = None) -> Dict[str, float]:
    """The training numbers: ``loss_gap`` (the widest of the steps read and
    of the fits' means), ``grad_gap`` (the first gradient's worst leaf),
    ``change_gap`` (the change's median leaf: the worst leaf's swings from
    seed to seed with the later steps' round-off on a few rows of the
    smallest tables) and ``leaves_off`` (the leaves whose change is off by
    half the reference's or more: a leaf left unmoved or moved double).
    ``prog``'s losses are by step; ``ref``'s are every step's. ``look``,
    where given, gets the worst leaf of each norm and its gap."""
    every = ref["losses"]
    losses = [abs(v - every[s]) / abs(every[s]) if 0 <= s < len(every) else float("inf")
              for s, v in prog["losses"].items()]
    means = fit_means(every, steps_per_fit)
    losses += [abs(p - r) / abs(r) for p, r in zip(prog["fit_losses"], means)]
    if len(prog["fit_losses"]) != len(means) or not prog["losses"]:
        losses.append(float("inf"))
    grads = ref["grad_norms"]
    median = statistics.median(grads.values())
    moved = [n for n, g in grads.items() if g >= ROUNDOFF_SHARE * median]
    grad = _gaps(prog["grad_norms"], grads, grads)
    change = _gaps(prog["change_norms"], ref["change_norms"], moved)
    own = {n: abs(prog["change_norms"][n] - ref["change_norms"][n])
           / max(ref["change_norms"][n], 1e-30) for n in moved}
    if look is not None:
        for name, gaps in (("grad", grad), ("change", change)):
            worst = max(gaps, key=gaps.get)
            look[name] = (worst, gaps[worst])
    return {"loss_gap": max(losses), "grad_gap": max(grad.values()),
            "change_gap": statistics.median(change.values()),
            "leaves_off": float(sum(v >= LEAF_OFF for v in own.values()))}


def served_gaps(served_scores: np.ndarray, served_exact: np.ndarray,
                ref_scores: np.ndarray) -> Dict[str, float]:
    """``served_scores`` (n, k) as served, ``served_exact`` the reference's
    scores of the served ids, ``ref_scores`` the reference's own top k."""
    scale = float(np.std(ref_scores[:, 0])) + float(np.mean(np.abs(ref_scores[:, 0])))
    return {
        "score_gap": float(np.max(np.abs(served_scores - served_exact))) / scale,
        "rank_gap": float(np.max(ref_scores - served_exact)) / scale,
    }


def metric_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str],
               queries: int) -> float:
    return max(abs(prog[n] - ref[n]) for n in names) * queries

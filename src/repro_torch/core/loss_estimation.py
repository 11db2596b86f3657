"""Round-budget estimation (paper Appendix, Formula 13).

Loss_m(r) = 1 / (b0*r + b1) + b2, fitted to the observed (round, loss) history
by least squares on the linearized form, then R_m = (1+0.3) * R_m^c where
R_m^c solves Loss(R) = l_m.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def fit_loss_curve(rounds: Sequence[int], losses: Sequence[float]) -> Tuple[float, float, float]:
    """Fit (b0, b1, b2) of Loss(r) = 1/(b0 r + b1) + b2.

    b2 is estimated as a fraction of the running minimum (the asymptote must sit
    strictly below every observation for the linearization to be defined), then
    1/(loss - b2) = b0 r + b1 is fit by linear least squares.
    """
    r = np.asarray(rounds, dtype=np.float64)
    l = np.asarray(losses, dtype=np.float64)
    if r.size < 2:
        raise ValueError("need >= 2 observations")
    A = np.stack([r, np.ones_like(r)], axis=1)
    best = None
    # The asymptote b2 must sit below every observation; grid-search the
    # fraction of the running minimum and keep the best reconstruction.
    for frac in (0.0, 0.25, 0.5, 0.7, 0.85, 0.95, 0.99):
        b2 = float(l.min()) * frac
        y = 1.0 / np.maximum(l - b2, 1e-9)
        (b0, b1), *_ = np.linalg.lstsq(A, y, rcond=None)
        b0, b1 = max(b0, 1e-9), max(b1, 1e-9)
        resid = float(np.mean((1.0 / (b0 * r + b1) + b2 - l) ** 2))
        if best is None or resid < best[0]:
            best = (resid, b0, b1, b2)
    _, b0, b1, b2 = best
    return float(b0), float(b1), float(b2)


def rounds_to_target(b0: float, b1: float, b2: float, target_loss: float,
                     safety: float = 0.3, max_rounds: int = 100000) -> int:
    """R_m = ceil((1 + safety) * R_m^c) with R_m^c solving Loss(R)=target."""
    if target_loss <= b2:
        return max_rounds
    rc = (1.0 / (target_loss - b2) - b1) / b0
    rc = max(rc, 1.0)
    return int(min(np.ceil((1.0 + safety) * rc), max_rounds))

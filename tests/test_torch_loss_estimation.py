"""Round-budget estimation (paper Formula 13) in the port: bit-exact to the
reference on several loss histories."""

import numpy as np
import pytest

from repro.core import loss_estimation as ref
from repro_torch.core import loss_estimation as port


def histories():
    r = np.arange(1, 40)
    rng = np.random.default_rng(0)
    clean = 1.0 / (0.05 * r + 0.4) + 0.3
    return {
        "monotone": (r, clean),
        "noisy": (r, clean + rng.normal(0.0, 0.02, r.size)),
        "flat": (np.arange(5), np.full(5, 0.7)),
        "two-points": ([1, 2], [2.0, 1.5]),
        "rising": (r[:10], 0.2 + 0.01 * r[:10]),
    }


@pytest.mark.parametrize("name", list(histories()))
def test_fit_and_rounds_bit_exact(name):
    rounds, losses = histories()[name]
    fit = port.fit_loss_curve(rounds, losses)
    assert fit == ref.fit_loss_curve(rounds, losses)
    b0, b1, b2 = fit
    # targets above, at and below the asymptote b2
    for target in (b2 + 0.5, b2 + 1e-3, b2, b2 - 0.1):
        assert (port.rounds_to_target(b0, b1, b2, target)
                == ref.rounds_to_target(b0, b1, b2, target))
        assert (port.rounds_to_target(b0, b1, b2, target, safety=0.0,
                                      max_rounds=50)
                == ref.rounds_to_target(b0, b1, b2, target, safety=0.0,
                                        max_rounds=50))
    assert port.rounds_to_target(b0, b1, b2, b2, max_rounds=77) == 77


def test_needs_two_observations():
    with pytest.raises(ValueError, match="need >= 2"):
        port.fit_loss_curve([1], [0.5])

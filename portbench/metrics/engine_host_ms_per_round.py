"""The engine's host time a round: the self time of the program's
``ctx_build``, ``dispatch`` and ``record`` spans in the window, over the
rounds recorded there (ms)."""

from portbench import tracing


def read(run):
    if not run.spans or not run.rounds:
        return None
    sec = tracing.self_seconds(run.spans, ("ctx_build", "dispatch", "record"))
    return 1e3 * sec / run.rounds

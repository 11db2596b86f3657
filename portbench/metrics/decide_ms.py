"""The scheduler's time a decision: the program's ``schedule`` spans in the
window, summed, over their number (ms)."""


def read(run):
    spans = [s for s in (run.spans or ()) if s.name == "schedule"]
    if not spans:
        return None
    return 1e3 * sum((s.end_ns - s.start_ns) / 1e9 for s in spans) / len(spans)

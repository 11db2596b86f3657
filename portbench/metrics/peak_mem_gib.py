"""The FL runtime's peak device memory in the window:
``torch.cuda.max_memory_allocated()`` after a reset at the window's start
(GiB)."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30

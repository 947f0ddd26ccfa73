"""Reconstructions completed in the window over the window's seconds."""


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    return len(run.requests) / run.window_s

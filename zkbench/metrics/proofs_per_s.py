"""Proofs completed in the window over the window's time, from the first
proof's start to the last one's end (host clock)."""


def read(run):
    return run.proofs / run.window_s if run.window_s > 0 and run.proofs else None

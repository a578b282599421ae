"""Tokens trained in the window over the window's seconds, every step
counted; the window ends when the last step's work has left the card."""


def read(run):
    return run.counters["tokens"] / run.window_s

"""Set-up: from the process's start to the first timed operation (kernel
build, weights drawn on the card, the cell's warm-up)."""


def read(run):
    return run.setup_s

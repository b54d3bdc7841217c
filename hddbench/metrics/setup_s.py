"""Set-up seconds: from the start of the harness's main (the program not yet
imported) to the end of the warm-up solve: the program's host set-up,
kernel builds and loads, and one solve of the cell's own shapes."""


def read(run):
    return run.setup_s

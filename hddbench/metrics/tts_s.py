"""Time to solution: the window's seconds over the solves that reached the
configuration's tolerance in it."""


def read(run):
    ok = sum(1 for r in run.outcomes if r["ok"])
    return run.window_s / ok if ok else None

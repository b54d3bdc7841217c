"""Shared arithmetic of the span readers."""


def mean_ms(run, name):
    s = run.spans.get(name) if run.spans else None
    return 1e3 * sum(s) / len(s) if s else None


def iter_ms(run, build):
    """Solve span less the separately timed build span, per PCG iteration."""
    if not run.spans or "solve" not in run.spans or build not in run.spans:
        return None
    iters = sum(r["iterations"] for r in run.outcomes)
    if not iters:
        return None
    return 1e3 * (sum(run.spans["solve"]) - sum(run.spans[build])) / iters

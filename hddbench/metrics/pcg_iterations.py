"""Mean PCG iterations per solve over the window (the program's count:
``BenchSolution.iterations``, ``last_solve_info["iterations"]``)."""


def read(run):
    if not run.outcomes:
        return None
    return sum(r["iterations"] for r in run.outcomes) / len(run.outcomes)

"""Study success checking: a finished EocStudy's results against the
expectation registry (values within a tolerance where recorded) and the
theoretical EOC rates.  Counterpart of ``dune_hdd_tpu/studies/check.py``."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .eoc import EocStudy, eoc_rates
from .expectations import expected_rate, expected_results

__all__ = ["check_eoc_study_for_success", "StudyCheckError"]


class StudyCheckError(AssertionError):
    pass


def check_eoc_study_for_success(
    study: EocStudy,
    testcase: str,
    grid_variant: str,
    polorder: int = 1,
    value_rtol: float = 7e-3,
    rate_tolerance: float = 0.35,
    check_rates_for: Optional[Sequence[str]] = None,
) -> Dict[str, List[float]]:
    """Raises StudyCheckError on mismatch; returns the results on success.

    * every result type with a recorded expectation must match within
      ``value_rtol`` (tables are recorded to 3 significant digits);
    * the final EOC of each type in ``check_rates_for`` (default: all types
      with a nonzero theoretical rate) must reach rate - rate_tolerance.
    """
    if not hasattr(study, "results"):
        raise StudyCheckError("run the study before checking it")
    problems = []
    for type_, values in study.results.items():
        expected = expected_results(testcase, grid_variant, polorder, type_)
        if expected is not None:
            want = expected[: len(values)]
            if not np.allclose(values, want, rtol=value_rtol):
                problems.append(f"{type_}: values {values} do not match expected {want} "
                                f"(rtol {value_rtol})")
        rate = expected_rate(type_, polorder)
        if rate > 0 and (check_rates_for is None or type_ in check_rates_for):
            if len(values) >= 2:
                final = eoc_rates(values)[-1]
                if final < rate - rate_tolerance:
                    problems.append(f"{type_}: final EOC {final:.2f} below expected "
                                    f"{rate} - {rate_tolerance}")
    if problems:
        raise StudyCheckError("EOC study failed:\n  " + "\n  ".join(problems))
    return study.results

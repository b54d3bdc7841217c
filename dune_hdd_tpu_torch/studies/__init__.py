from .check import StudyCheckError, check_eoc_study_for_success
from .eoc import EocStudy, eoc_rates
from .expectations import expected_results, record

__all__ = ["EocStudy", "eoc_rates", "expected_results", "record",
           "check_eoc_study_for_success", "StudyCheckError"]

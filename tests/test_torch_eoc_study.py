"""The ESV2007 ALU-conforming SWIPDG EOC study of the PyTorch port against
the JAX package's (x64, CPU), levels 0-1: the error norms equal the
reference's to 1e-8 relative (both solve with cg.jacobi to 1e-12), the
port's check passes against the published table, and doubled results
raise StudyCheckError, as in the reference's own study test."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from dune_hdd_tpu.discretizations import SWIPDGDiscretization as JD  # noqa: E402
from dune_hdd_tpu.studies import EocStudy as JStudy  # noqa: E402
from dune_hdd_tpu.testcases import ESV2007TestCase as JCase  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.studies import (  # noqa: E402
    EocStudy,
    StudyCheckError,
    check_eoc_study_for_success,
    eoc_rates,
    expected_results,
)
from dune_hdd_tpu_torch.testcases.base import make_cube_hierarchy  # noqa: E402
from dune_hdd_tpu_torch.testcases.esv2007 import ESV2007TestCase  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

OPTIONS = {"type": "cg.jacobi", "precision": 1e-12, "max_iter": 20000}


@pytest.fixture(scope="module")
def studies():
    study = EocStudy(ESV2007TestCase(num_refinements=1), TD, solver_options=OPTIONS,
                     device="cpu")
    study.run(verbose=False)
    ref = JStudy(JCase(num_refinements=1), JD, solver_options=OPTIONS)
    ref.run(verbose=False)
    return study, ref


def test_results_equal_the_reference(studies):
    study, ref = studies
    assert sorted(study.results) == sorted(ref.results)
    for k, v in study.results.items():
        np.testing.assert_allclose(v, ref.results[k], rtol=1e-8, atol=0, err_msg=k)
        assert study.eoc(k) == pytest.approx(ref.eoc(k), rel=1e-7)
    assert [i["num_dofs"] for i in study.level_info] == [384, 1536]
    assert len(study.time_to_solution) == 2


def test_check_passes_and_doubled_results_raise(studies):
    study, _ = studies
    check_eoc_study_for_success(study, "ESV2007", "alu_conforming", 1)
    results = study.results
    try:
        study.results = {k: [v * 2 for v in vs] for k, vs in results.items()}
        with pytest.raises(StudyCheckError):
            check_eoc_study_for_success(study, "ESV2007", "alu_conforming", 1)
    finally:
        study.results = results


def test_stencil_cg_study_matches_the_table():
    """The chip's solver option on the CPU: stencil_cg with the 4x4 macro."""
    study = EocStudy(ESV2007TestCase(num_refinements=1), TD, device="cpu",
                     solver_options={"type": "stencil_cg", "precision": 1e-12,
                                     "max_iter": 50000, "macro": (4, 4)})
    study.run(verbose=False)
    check_eoc_study_for_success(study, "ESV2007", "alu_conforming", 1)
    assert all(i["type"] == "stencil_cg" and i["iterations"] > 0 for i in study.level_info)


def test_expectations_and_rates():
    assert expected_results("ESV2007", "alu_conforming", 1, "L2")[:2] == [1.83e-02, 4.53e-03]
    assert eoc_rates([4.0, 1.0, 0.25]) == [2.0, 2.0]
    # the quad ("cube") and red-refined triangle ("simplex") variants equal the reference's
    from dune_hdd_tpu.testcases.base import make_cube_hierarchy as j_hierarchy

    for variant in ("cube", "simplex"):
        t, j = (f((0, 0), (1, 1), (2, 2), variant, 1, 1) for f in (make_cube_hierarchy,
                                                                    j_hierarchy))
        assert len(t) == len(j) == 2
        for level in range(2):
            assert t[level].cell_type == j[level].cell_type
            np.testing.assert_array_equal(t[level].cells, j[level].cells)
            np.testing.assert_array_equal(t[level].vertices, j[level].vertices)
    with pytest.raises(StudyCheckError):
        check_eoc_study_for_success(object(), "ESV2007", "alu_conforming", 1)

"""Expectation tables for the EOC/estimator regression studies.

A copy of the data of ``dune_hdd_tpu/studies/expectations.py`` (the port
keeps its own).  It mirrors dune-hdd's compile-time expectation specializations
(test/linearelliptic-swipdg-expectations*.cxx): hard-coded error/estimator
values per (test case, grid variant, polynomial order, norm type), plus the
expected EOC rates (test/linearelliptic-swipdg-expectations.hh:54-79).

Values marked REFERENCE are copied from the reference's tables and are
matched by this framework on the bit-compatible newest-vertex-bisection
grids.  Values marked RECORDED were recorded with this framework where the
reference grid cannot be reproduced (see each entry's note) — their EOC
rates are still checked against the theoretical rates.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["expected_results", "expected_rate", "record"]

# (testcase, grid_variant, polorder) -> {type: [values]}
_TABLES: Dict[Tuple[str, str, int], Dict[str, List[float]]] = {}


def record(testcase: str, grid_variant: str, polorder: int,
           values: Dict[str, List[float]]):
    _TABLES.setdefault((testcase, grid_variant, polorder), {}).update(values)


def expected_results(testcase: str, grid_variant: str, polorder: int,
                     type_: str) -> Optional[List[float]]:
    table = _TABLES.get((testcase, grid_variant, polorder))
    if table is None:
        return None
    return table.get(type_)


def expected_rate(type_: str, polorder: int = 1) -> float:
    """Theoretical EOC rates (test/linearelliptic-swipdg-expectations.hh:54-79)."""
    if type_ == "L2" or type_ == "eta_R_ESV2007":
        return polorder + 1
    if type_.startswith("eff_"):
        return 0.0
    return float(polorder)  # H1_semi, energy, eta_NC/DF/ESV2007/OS2014 families


# ---------------------------------------------------------------------------
# SWIPDG, ESV2007, polOrder 1, ALUGrid<2,2,simplex,conforming> — REFERENCE
# values (test/linearelliptic-swipdg-expectations_esv2007_2daluconform.cxx:30-61),
# reproduced exactly by the alu_conforming NVB hierarchy.
record("ESV2007", "alu_conforming", 1, {
    "L2": [1.83e-02, 4.53e-03, 1.12e-03, 2.78e-04],
    "H1_semi": [3.28e-01, 1.62e-01, 8.04e-02, 4.01e-02],
    "energy": [3.28e-01, 1.62e-01, 8.04e-02, 4.01e-02],
    "eta_NC_ESV2007": [1.66e-1, 7.89e-2, 3.91e-2, 1.95e-2],
    "eta_R_ESV2007": [7.23e-2, 1.82e-2, 4.54e-3, 1.14e-3],
    "eta_DF_ESV2007": [3.55e-1, 1.76e-1, 8.73e-2, 4.35e-2],
    "eta_ESV2007": [4.49e-01, 2.07e-01, 9.91e-02, 4.85e-02],
    "eff_ESV2007": [1.37, 1.28, 1.23, 1.21],
    "eta_ESV2007_alt": [5.93e-01, 2.73e-01, 1.31e-01, 6.42e-02],
    "eff_ESV2007_alt": [1.81, 1.69, 1.63, 1.60],
})

# SWIPDG, ESV2007, polOrder 1, quad ("cube"/SGrid) — RECORDED with this
# framework (Q1 nodal DG).  The reference's SGrid table
# (..._esv2007_2dsgrid.cxx: L2 1.13e-02...) could not be reproduced by Q1 or
# total-degree-P1 DG with the documented SWIPDG form (no penalty value in
# [2, 100] reproduces it either); our Q1 values converge at the correct
# rates and are regression-locked here.
record("ESV2007", "cube", 1, {
    "L2": [1.49680e-02, 3.78525e-03, 9.49301e-04, 2.37627e-04],
    "H1_semi": [2.52014e-01, 1.25951e-01, 6.29625e-02, 3.14787e-02],
    "energy": [2.52014e-01, 1.25951e-01, 6.29625e-02, 3.14787e-02],
    # estimators on quads are beyond the reference (its estimators are
    # ALU-simplex-only, estimators/swipdg.hh:57-71); RECORDED 2026-08-18
    # with RT0-on-rectangles + Q1 Oswald (direct solver).  eta_R ==
    # eta_R_* by construction for RT0 (div t == P0 f exactly); eta_NC
    # superconverges (~rate 2) on the tensor grid.
    "eta_NC_ESV2007": [1.575e-02, 4.405e-03, 1.150e-03],
    "eta_R_ESV2007": [8.852e-02, 2.223e-02, 5.563e-03],
    "eta_R_ESV2007_*": [8.852e-02, 2.223e-02, 5.563e-03],
    "eta_DF_ESV2007": [3.515e-01, 1.775e-01, 8.896e-02],
    "eta_ESV2007": [4.295e-01, 1.966e-01, 9.370e-02],
    "eta_ESV2007_alt": [4.558e-01, 2.041e-01, 9.567e-02],
})

# ---------------------------------------------------------------------------
# BlockSWIPDG, ESV2007Multiscale, polOrder 1, ALU-conforming, by partitioning
# — REFERENCE values (test/linearelliptic-block-swipdg-expectations_esv2007_
# 2daluconform.cxx:33-137), reproduced to <=0.5%.  L2/H1/energy coincide with
# the single-domain table for every partitioning (same global space).
for _part, _values in {
    "[1 1 1]": {
        "eta_R_OS2014": [5.79e-01, 2.90e-01, 1.45e-01, 7.27e-02],
        "eta_OS2014": [1.10, 5.45e-01, 2.72e-01, 1.36e-01],
        "eff_OS2014": [3.35, 3.37, 3.38, 3.39],
    },
    "[2 2 1]": {
        "eta_R_OS2014": [2.89e-01, 1.45e-01, 7.27e-02, 3.63e-02],
        "eta_OS2014": [8.10e-01, 4.00e-01, 1.99e-01, 9.94e-02],
        "eff_OS2014": [2.47, 2.47, 2.48, 2.48],
    },
    "[4 4 1]": {
        "eta_R_OS2014": [1.45e-01, 7.26e-02, 3.63e-02, 1.82e-02],
        "eta_OS2014": [6.65e-01, 3.27e-01, 1.63e-01, 8.12e-02],
        "eff_OS2014": [2.03, 2.02, 2.02, 2.03],
    },
    "[8 8 1]": {
        "eta_R_OS2014": [7.23e-02, 3.63e-02, 1.82e-02, 9.09e-03],
        "eta_OS2014": [5.93e-01, 2.91e-01, 1.45e-01, 7.21e-02],
        "eff_OS2014": [1.81, 1.80, 1.80, 1.80],
    },
}.items():
    record(f"ESV2007Multiscale.{_part}", "alu_conforming", 1, _values)

# Common to all partitionings (BASELINE.md):
for _part in ("[1 1 1]", "[2 2 1]", "[4 4 1]", "[8 8 1]"):
    record(f"ESV2007Multiscale.{_part}", "alu_conforming", 1, {
        "eta_NC_OS2014": [1.66e-01, 7.89e-02, 3.91e-02, 1.95e-02],
        "eta_DF_OS2014": [3.55e-01, 1.76e-01, 8.73e-02, 4.35e-02],
        "eta_DF_OS2014_*": [3.55e-01, 1.76e-01, 8.73e-02, 4.35e-02],
    })

# ---------------------------------------------------------------------------
# FVCA7-poster workflow (test/OS2014-FVCA7-poster.cc:53-85): BlockSWIPDG on
# ESV2007 over partitionings 1/4/16/64 via cli/main.py fvca7_poster_study —
# RECORDED with this framework (2026-08-17, cg.jacobi precision 1e-12,
# levels 0-1).  The efficiencies match the reference's recorded
# eff_OS2014 rows per partitioning ([1 1 1] 3.35, [2 2 1] 2.47,
# [4 4 1] 2.03, [8 8 1] 1.81 — ...block-swipdg-expectations_esv2007_
# 2daluconform.cxx:54-57,79-82,104-107,129-132) to <1%.
for _part, _values in {
    "[1 1 1]": {"eta_OS2014": [1.0992, 0.54505],
                "eff_OS2014": [3.3491, 3.3695]},
    "[2 2 1]": {"eta_OS2014": [0.80981, 0.39984],
                "eff_OS2014": [2.4673, 2.4718]},
    "[4 4 1]": {"eta_OS2014": [0.66511, 0.32723],
                "eff_OS2014": [2.0265, 2.0229]},
    "[8 8 1]": {"eta_OS2014": [0.59277, 0.29092],
                "eff_OS2014": [1.8061, 1.7985]},
}.items():
    record(f"FVCA7.poster.{_part}", "alu_conforming", 1,
           dict(_values, energy=[0.32821, 0.16176]))

# ---------------------------------------------------------------------------
# BlockSWIPDG, OS2014 parametric, [4 4 1] — the reference's per-component
# self-weighted scheme (swipdg.hh:222-249).  At mu = 1 these REPRODUCE the
# reference parametric tables (.._os2014_2daluconform.cxx:95-190) exactly
# (3-digit rounding), including eta_OS2014_* with components-only
# alpha/gamma; at mu != 1 the published values deviate 3-8% (see
# docs/DESIGN.md — our values are quadrature-converged; the deviation was
# bracketed over quadrature rules/orders and weighting conventions).
record("OS2014.block.[4 4 1].mu0.1_bar0.1_hat0.1", "alu_conforming", 1, {
    "eta_DF_OS2014": [1.16913, 0.68621],
    "eta_DF_OS2014_*": [1.16913, 0.68621],
    "eta_OS2014": [1.90907, 1.11173],
})
record("OS2014.block.[4 4 1].mu1_bar1_hat0.1", "alu_conforming", 1, {
    "eta_DF_OS2014": [1.35774, 1.33231],  # == reference exactly (mu = 1)
    "eta_DF_OS2014_*": [0.413058, 0.204837],
    "eta_OS2014": [4.71208, 4.41939],
    "eta_OS2014_*": [0.549155, 0.271049],
})
record("OS2014.block.[4 4 1].mu1_bar1_hat1", "alu_conforming", 1, {
    "eta_DF_OS2014": [0.354808, 0.175709],  # == reference exactly (mu = 1)
    "eta_DF_OS2014_*": [0.354808, 0.175709],
    "eta_OS2014": [0.773342, 0.381983],
    "eta_OS2014_*": [0.773342, 0.381983],
})
record("OS2014.block.[4 4 1].mu0.1_bar0.1_hat1", "alu_conforming", 1, {
    "eta_DF_OS2014": [0.900929, 1.15947],
    "eta_DF_OS2014_*": [0.998228, 0.596825],
    "eta_OS2014": [3.58893, 4.09209],
})

# ---------------------------------------------------------------------------
# SPE10 ParametricBlockModel1, [20 4 1], 100x20 macro grid, levels 0-1 —
# OUR values on the documented synthetic field (the reference's
# perm_case1.dat is not distributed; its table ..._spe10_2daluconform.cxx:
# 36-75 is matched STRUCTURALLY: eta == eta_* at mu_hat == mu, plain eta
# stagnates / star converges at mu_hat != mu, energy rate ~1).
for _mus, _values in {
    "mu0.1_bar0.1_hat0.1": {"energy_mu": [3.44836, 1.47451],
                            "eta_OS2014": [9.29559, 4.08830],
                            "eta_OS2014_*": [9.29559, 4.08830]},
    "mu1_bar1_hat0.1": {"energy_mu": [3.44392, 1.47207],
                        "eta_OS2014": [49.0474, 44.3156],
                        "eta_OS2014_*": [6.38280, 2.65178]},
    "mu0.1_bar0.1_hat1": {"energy_mu": [3.44836, 1.47451],
                          "eta_OS2014": [35.3307, 29.9544],
                          "eta_OS2014_*": [18.5272, 8.63450]},
    "mu1_bar1_hat1": {"energy_mu": [3.44392, 1.47207],
                      "eta_OS2014": [9.27974, 4.07744],
                      "eta_OS2014_*": [9.27974, 4.07744]},
}.items():
    record(f"Spe10.parametric_block.[20 4 1].{_mus}", "alu_conforming", 1, _values)

# ---------------------------------------------------------------------------
# Adaptive LRBMS on SPE10 ParametricBlockModel1, [20 4 1], mu = 0.1 —
# RECORDED with this framework (2026-08-18; the reference's analog is the
# OS2014 localization study's online-enrichment property,
# OS2014_localization_study.cc:90-136, which it runs on the OS2014 case).
# Configuration (scripts/run_adaptive_spe10_lock.py forensics): snapshot
# init at mu_train = 1 (rhs-only init leaves 75/80 subdomains empty),
# Doerfler(0.85) bulk marking on eta_OS2014_* (with snapshot init the star
# indicator is the best-ranked against true local errors: Spearman +0.76,
# 6/10 top-10 overlap — scripts/diag_marking_indicators.py; one-worst and
# eta_NC marking stall).  true_h1_semi is the true reduction error per
# enrichment round; the full 4-round recording continues 6.069, 5.479
# (2.25x).  eta_OS2014_* rises with enrichment: its eta_R term is evaluated
# on the FIXED detailed grid and does not shrink with basis growth —
# documented estimator-floor behaviour, which is why stopping at
# target_estimate uses it only as a floor detector here.
record("Spe10.adaptive.[20 4 1].mu0.1", "alu_conforming", 1, {
    "true_h1_semi": [12.31622, 7.502474, 6.707649],
    "eta_OS2014_*": [288.8299, 350.6335, 381.4010],
    # the reduced-consistent Riesz residual bound (mor/residual.py composed
    # into adaptive_lrbms, round 5): energy-norm-at-mu upper bound on the
    # REDUCTION error — unlike eta_OS2014_* above it FALLS with enrichment
    # (2.688 -> 2.218 while true_h1 falls 12.32 -> 6.71), so target_estimate
    # stopping is honest (recorded 2026-08-19, run_adaptive_spe10_lock.py)
    "rb_bound_energy": [2.687737, 2.437942, 2.218073],
})

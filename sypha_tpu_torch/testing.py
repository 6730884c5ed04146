"""Golden values for the Beasley OR-Library SCP suite, and synthetic instances.

The golden tables are those of sypha_tpu/testing.py (LP-relaxation optima
from the reference's end-to-end tests; MILP incumbents and statuses from its
benchmark CSVs).

``synthetic_scp`` makes seeded instances of the OR-Library classes' shapes
for tests and smoke runs where the instance files are not at hand.  It is a
test helper, not a solver feature.
"""

from __future__ import annotations

import numpy as np

# instance name -> LP relaxation optimum (primal == dual at optimality)
GOLDEN_LP = {
    # scp4x (200 rows x 1000 cols)
    "scp41": 429.0,
    "scp42": 512.0,
    "scp43": 516.0,
    "scp44": 494.0,
    "scp45": 512.0,
    "scp46": 557.25,
    "scp47": 430.0,
    "scp48": 488.66666666666663,
    "scp49": 638.5384615384615,
    "scp410": 513.5,
    # scp5x (200 rows x 2000 cols)
    "scp51": 251.22499999999997,
    "scp52": 299.76111111111112,
    "scp53": 226.0,
    "scp54": 240.5,
    "scp55": 211.0,
    "scp56": 212.5,
    "scp57": 291.77777777777783,
    "scp58": 287.0,
    "scp59": 279.0,
    "scp510": 265.0,
    # scpnre (500 rows x 5000 cols)
    "scpnre1": 21.379416207246248,
    "scpnre2": 22.360044873608039,
    "scpnre3": 20.486142236242543,
    "scpnre4": 21.352715255058822,
    "scpnre5": 21.321920958180868,
    # scpnrf
    "scpnrf1": 8.7952638227569615,
    "scpnrf2": 9.9936151600008856,
    "scpnrf3": 9.4923769291525240,
    "scpnrf4": 8.4711900922824324,
    "scpnrf5": 7.8355272485863994,
    # scpnrg
    "scpnrg1": 159.88624078126432,
    "scpnrg2": 142.07332051900437,
    "scpnrg3": 148.26913540494277,
    "scpnrg4": 148.94652093714018,
    "scpnrg5": 148.23146550380926,
    # scpnrh
    "scpnrh1": 48.124554641790994,
    "scpnrh2": 48.637624895853385,
    "scpnrh3": 45.197462139046252,
    "scpnrh4": 44.042108164700451,
    "scpnrh5": 42.370358868231932,
}

# instance -> (MILP incumbent, status) from the reference's own benchmark run
GOLDEN_MILP = {
    "scp41": (429, "OPTIMAL"),
    "scp42": (512, "OPTIMAL"),
    "scp43": (516, "OPTIMAL"),
    "scp44": (494, "OPTIMAL"),
    "scp45": (512, "OPTIMAL"),
    "scp46": (560, "OPTIMAL"),
    "scp47": (430, "OPTIMAL"),
    "scp48": (492, "OPTIMAL"),
    "scp49": (641, "OPTIMAL"),
    "scp410": (514, "OPTIMAL"),
    "scp51": (253, "OPTIMAL"),
    "scp52": (302, "OPTIMAL"),
    "scp53": (226, "OPTIMAL"),
    "scp54": (242, "OPTIMAL"),
    "scp55": (211, "OPTIMAL"),
    "scp56": (213, "OPTIMAL"),
    "scp57": (293, "OPTIMAL"),
    "scp58": (288, "FEASIBLE"),
    "scp59": (279, "OPTIMAL"),
    "scp510": (265, "OPTIMAL"),
}

ACCEPT_TOL = 1e-4  # reference python/sypha_unit_tests.py:10


def synthetic_scp(nrows: int, ncols: int, density: float, seed: int) -> str:
    """SCP text of a random instance made the way OR-Library's are.

    Beasley's generator (OR-Library ``scpinfo``): each entry of the 0/1
    matrix is set with probability ``density``; every column then covers at
    least one row and every row is covered by at least two columns; costs
    are integers uniform in [1, 100].  Seeded with
    ``np.random.default_rng(seed)``.  Returns text in the OR-Library format,
    so callers go through the reader.
    """
    if nrows < 1 or ncols < 2:
        raise ValueError(f"synthetic_scp needs nrows >= 1 and ncols >= 2, got {nrows}x{ncols}")
    rng = np.random.default_rng(seed)
    cover = rng.random((nrows, ncols)) < density
    for j in np.flatnonzero(~cover.any(axis=0)):
        cover[rng.integers(nrows), j] = True
    for i in np.flatnonzero(cover.sum(axis=1) < 2):
        free = np.flatnonzero(~cover[i])
        need = 2 - int(cover[i].sum())
        cover[i, rng.choice(free, size=need, replace=False)] = True
    costs = rng.integers(1, 101, size=ncols)

    lines = [f"{nrows} {ncols}", " ".join(map(str, costs))]
    for i in range(nrows):
        cols = np.flatnonzero(cover[i]) + 1
        lines.append(f"{len(cols)} " + " ".join(map(str, cols)))
    return "\n".join(lines) + "\n"

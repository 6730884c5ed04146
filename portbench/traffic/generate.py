"""The benchmark's one traffic generator: instances and node fixings from a seed.

Frozen copies, so that later changes to the program's helpers cannot move the
yardstick:

- ``beasley_instance`` is ``sypha_tpu_torch/testing.py: synthetic_scp`` as of
  the port's PR 14 (Beasley's OR-Library generator, ``scpinfo``): each entry
  of the 0/1 matrix is set with probability ``density``; every column then
  covers at least one row and every row is covered by at least two columns;
  costs are integers uniform in [1, 100]; ``np.random.default_rng(seed)``.
  It returns the arrays as well as the OR-Library text, so the reference
  reads the same instance as the program without the program's reader.
- ``seeded_fixings`` is ``chip_smoke.py: seeded_fixings`` as of the same
  commit: per lane 0..5 columns fixed to 0 and 0..5 to 1, disjoint.

An instance of a class is named as the port's ``--synthetic`` stand-ins name
them (``sypha_tpu_torch/benchmark/__init__.py``): instance *i* (0-based) of a
family is ``beasley_instance`` at the family's class with seed *i*, so
``scp41`` is seed 0.  A traffic file is a JSON object of parameters that the
cell's kind (``portbench/kinds/<kind>.py``) reads; this module holds what
every kind shares.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Instance:
    """One set-covering instance: min c.x s.t. every row covered, x binary."""

    name: str
    nrows: int
    ncols: int
    rows: tuple  # nrows int32 arrays of 0-based covering column indices
    costs: np.ndarray  # [ncols] int64

    def text(self) -> str:
        """The instance in the OR-Library format (1-based column indices)."""
        lines = [f"{self.nrows} {self.ncols}", " ".join(map(str, self.costs))]
        for cols in self.rows:
            lines.append(f"{len(cols)} " + " ".join(map(str, cols + 1)))
        return "\n".join(lines) + "\n"

    @functools.cached_property
    def dense(self) -> np.ndarray:
        """The 0/1 covering matrix [nrows, ncols] as float64 (made once)."""
        A = np.zeros((self.nrows, self.ncols), dtype=np.float64)
        for i, cols in enumerate(self.rows):
            A[i, cols] = 1.0
        return A


def beasley_instance(nrows: int, ncols: int, density: float, seed: int, name: str = "") -> Instance:
    """A random instance made the way OR-Library's are (see the module note)."""
    if nrows < 1 or ncols < 2:
        raise ValueError(f"an instance needs nrows >= 1 and ncols >= 2, got {nrows}x{ncols}")
    rng = np.random.default_rng(seed)
    cover = rng.random((nrows, ncols)) < density
    for j in np.flatnonzero(~cover.any(axis=0)):
        cover[rng.integers(nrows), j] = True
    for i in np.flatnonzero(cover.sum(axis=1) < 2):
        free = np.flatnonzero(~cover[i])
        need = 2 - int(cover[i].sum())
        cover[i, rng.choice(free, size=need, replace=False)] = True
    costs = rng.integers(1, 101, size=ncols)
    rows = tuple(np.flatnonzero(cover[i]).astype(np.int32) for i in range(nrows))
    return Instance(name=name, nrows=nrows, ncols=ncols, rows=rows, costs=costs.astype(np.int64))


def class_instances(config: dict, names) -> list:
    """The named instances of a configuration's class (``config["instances"]``
    lists the class in order; instance i has generator seed i)."""
    order = config["instances"]
    return [
        beasley_instance(config["rows"], config["cols"], config["density"], order.index(n), name=n)
        for n in names
    ]


def seeded_fixings(rng, lanes: int, ncols: int, n_pad: int):
    """Per lane 0..5 columns fixed to 0 and 0..5 fixed to 1 (disjoint), as
    [lanes, n_pad] float64 masks."""
    fix0 = np.zeros((lanes, n_pad))
    fix1 = np.zeros((lanes, n_pad))
    for lane in range(lanes):
        cols = rng.permutation(ncols)
        k0, k1 = rng.integers(0, 6, size=2)
        fix0[lane, cols[:k0]] = 1.0
        fix1[lane, cols[k0 : k0 + k1]] = 1.0
    return fix0, fix1


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    """An independent stream per (seed, purpose); any whole seed, negative
    or past 64 bits included."""
    s = int(seed)
    words = [purpose, int(s < 0)]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return np.random.default_rng(np.random.SeedSequence(words))

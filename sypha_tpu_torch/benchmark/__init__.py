"""The solver's sweep and study tools, ported from the JAX package's
``benchmark/`` scripts.  Each runs as ``python3 -m
sypha_tpu_torch.benchmark.<tool>`` and has ``main(argv=None) -> int``:

- ``run_benchmark``: LP / MILP rows per OR-Library family, as CSV;
- ``lp_parity``: LP optima against the golden tables or HiGHS;
- ``ell_vs_dense``: the padded-ELL against the dense node operator;
- ``root_cut_study``: the dual bound per root cut round;
- ``face_make``, ``face_replay``, ``tune_exact_cover``: the exact-cover
  engine's offline tuning, on the host.

The device tools share ``--device`` (``cuda`` unless ``--device cpu``; no
card raises, never falls back), ``--data-dir`` (default
``$SYPHA_DATA_DIR``) and ``--synthetic``: where an instance's file is not in
the data directory, instance *i* (0-based) of ``FAMILIES[family]`` becomes
``testing.synthetic_scp(rows, cols, density, seed=i)`` at the family's size
in OR-Library's ``scpinfo`` (``SYNTHETIC_CLASSES``).  The unicost families
scpclr and scpcyc have a structure the generator does not make, so they have
no synthetic stand-in.  Rows and log lines name a synthetic instance as
such ("synthetic scp41").
"""

from __future__ import annotations

import argparse
import os
import pathlib

FAMILIES = {
    "scp4": [f"scp4{i}" for i in range(1, 10)] + ["scp410"],
    "scp5": [f"scp5{i}" for i in range(1, 10)] + ["scp510"],
    "scpa": [f"scpa{i}" for i in range(1, 6)],
    "scpb": [f"scpb{i}" for i in range(1, 6)],
    "scpnre": [f"scpnre{i}" for i in range(1, 6)],
    "scpnrf": [f"scpnrf{i}" for i in range(1, 6)],
    "scpnrg": [f"scpnrg{i}" for i in range(1, 6)],
    "scpnrh": [f"scpnrh{i}" for i in range(1, 6)],
    # unicost families (the reference commits no MILP results for these)
    "scpclr": [f"scpclr{i}" for i in range(10, 14)],
    "scpcyc": ["scpcyc06", "scpcyc07"],
}

# family -> (rows, columns, density) of its OR-Library class (scpinfo)
SYNTHETIC_CLASSES = {
    "scp4": (200, 1000, 0.02),
    "scp5": (200, 2000, 0.02),
    "scpa": (300, 3000, 0.02),
    "scpb": (300, 3000, 0.05),
    "scpnre": (500, 5000, 0.10),
    "scpnrf": (500, 5000, 0.20),
    "scpnrg": (1000, 10000, 0.02),
    "scpnrh": (1000, 10000, 0.05),
}

RESULTS_DIR = pathlib.Path(__file__).resolve().parent / "results"


def add_common_args(ap: argparse.ArgumentParser) -> None:
    """--device, --data-dir and --synthetic, shared by the device tools."""
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    add_instance_args(ap)


def add_instance_args(ap: argparse.ArgumentParser) -> None:
    """--data-dir and --synthetic."""
    ap.add_argument(
        "--data-dir", default=os.environ.get("SYPHA_DATA_DIR"),
        help="directory of the OR-Library files <name>.txt (default: $SYPHA_DATA_DIR)",
    )
    ap.add_argument(
        "--synthetic", action="store_true",
        help="stand in a seeded synthetic instance of the family's class for each absent file",
    )


def label(name: str, source) -> str:
    """``name``, or "synthetic <name>" for a synthetic ``instance_source``."""
    return name if source[1] is None else f"synthetic {name}"


def row_name(name: str, source) -> str:
    """The ``instance`` column of a CSV row: the file's name, or the label."""
    return f"{name}.txt" if source[1] is None else label(name, source)


def instance_source(name: str, data_dir: str | None, synthetic: bool):
    """(path, None) where ``data_dir`` holds ``name``.txt, else (None, SCP
    text of its stand-in) for ``synthetic`` where its family has a class,
    else None."""
    from sypha_tpu_torch.testing import synthetic_scp

    if data_dir is not None:
        path = os.path.join(data_dir, f"{name}.txt")
        if os.path.exists(path):
            return path, None
    fam = next((f for f, names in FAMILIES.items() if name in names), None)
    if synthetic and fam in SYNTHETIC_CLASSES:
        rows, cols, density = SYNTHETIC_CLASSES[fam]
        return None, synthetic_scp(rows, cols, density, seed=FAMILIES[fam].index(name))
    return None


def require_source(name: str, data_dir: str | None, synthetic: bool):
    """``instance_source``, raising FileNotFoundError where there is none."""
    src = instance_source(name, data_dir, synthetic)
    if src is None:
        raise FileNotFoundError(
            f"{name}.txt is not in --data-dir {data_dir}, and {name} has no synthetic stand-in "
            "(pass --synthetic for an OR-Library name of a family in SYNTHETIC_CLASSES)"
        )
    return src


def load(source, name: str):
    """The ScpModel of an ``instance_source`` result."""
    from sypha_tpu_torch.io.scp_reader import parse_scp_text, read_scp_file

    path, text = source
    return read_scp_file(path) if path is not None else parse_scp_text(text, name=name)


def family_instances(fam: str, data_dir: str | None, synthetic: bool, keep=()):
    """[(name, source)] of the family's instances that are at hand (restricted
    to ``keep`` when given), printing a line for a family whose files are
    absent and that has no synthetic class."""
    names = [n for n in FAMILIES.get(fam, []) if not keep or n in keep]
    found = [(n, instance_source(n, data_dir, synthetic)) for n in names]
    missing = [n for n, src in found if src is None]
    if synthetic and missing and fam not in SYNTHETIC_CLASSES:
        print(f"[{fam}] skipped {','.join(missing)}: a unicost family, which synthetic_scp does not make")
    return [(n, src) for n, src in found if src is not None]

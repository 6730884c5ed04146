"""Generate exact-closure-style faces offline (host only, HiGHS duals): the
port of the JAX package's benchmark/face_make.py.

    python3 -m sypha_tpu_torch.benchmark.face_make INSTANCE INCUMBENT OUT.npz \\
        [CUT_ROUNDS] [--data-dir DIR] [--synthetic]

Mimics the B&B driver's plateau state without the device: solve the LP
relaxation with scipy/HiGHS, iterate reduced-cost fixing at cutoff
incumbent-1 to a fixpoint (optionally with cut rounds between), and save
the resulting face in the format ``native.exact_cover`` dumps under
SYPHA_TPU_DUMP_FACES, for ``face_replay``.  Faces made this way are
slightly HARDER than in-run faces (no cuts from the tree raising the LP
bound), which is the right direction for engine tuning.  INSTANCE is an
OR-Library name in ``--data-dir`` or, with ``--synthetic``, its stand-in.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import scipy.optimize

from sypha_tpu_torch import native
from sypha_tpu_torch.benchmark import add_instance_args, label, load, require_source
from sypha_tpu_torch.milp.base_model import BaseModel
from sypha_tpu_torch.milp.cuts import separate_cuts


def make_face(model, incumbent: float, cut_rounds: int = 0):
    """(base with the face's columns active, LP bound z, duals y)."""
    base = BaseModel(model)
    cutoff = incumbent - 1.0 + 1e-6
    z = y = None

    def fixpoint():
        nonlocal z, y
        x_full = None
        for it in range(64):
            A, rhs = base.rel_csr()
            cols = np.flatnonzero(base.active)
            Asub = A[:, cols].tocsc()
            res = scipy.optimize.linprog(
                base.costs[cols], A_ub=-A[:, cols], b_ub=-rhs,
                bounds=(0, 1), method="highs",
            )
            if res.status != 0:
                raise RuntimeError(f"HiGHS on the face LP: {res.message}")
            z = res.fun
            y = np.maximum(0.0, -res.ineqlin.marginals)
            rc = base.costs[cols] - Asub.T @ y
            x = res.x
            x_full = np.zeros(base.ncols)
            x_full[cols] = x
            fix = (rc > 0) & (x < 0.5) & (z + rc > cutoff + 1e-9)
            n_fix = int(fix.sum())
            print(f"  it{it}: LP={z:.6f} active={len(cols)} rc-fix={n_fix}")
            if n_fix == 0:
                break
            base.deactivate(cols[fix])
        return x_full

    x_full = fixpoint()
    for r in range(cut_rounds):
        cuts = separate_cuts(base, x_full, y, 1e-6, max_cuts=40)
        if not cuts:
            print(f"  cut round {r}: dry")
            break
        base.add_cuts(cuts)
        print(f"  cut round {r}: +{len(cuts)} cuts (model {base.nrows} rows)")
        x_full = fixpoint()
    return base, z, y


def save_face(out: str, base: BaseModel, z: float, y: np.ndarray) -> None:
    """The face as ``native.exact_cover`` dumps it; the budget is the first
    bottom-up probe level, ceil(z)."""
    cuts = None
    if base.cuts:
        coef = np.zeros((len(base.cuts), base.ncols))
        for i, cu in enumerate(base.cuts):
            coef[i, cu.indices] = cu.values
        cuts = (np.maximum(0.0, y[base.nrows_cover:]), coef, np.array([cu.rhs for cu in base.cuts]))
    ar = native._arrays(base)
    native.save_face(
        out, ar, np.ascontiguousarray(base.active.astype(np.uint8)), np.ceil(z - 1e-6), 60.0,
        np.ascontiguousarray(y[: ar.nrows]), cuts,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sypha_tpu_torch.benchmark.face_make")
    ap.add_argument("instance")
    ap.add_argument("incumbent", type=float)
    ap.add_argument("out", help="output .npz")
    ap.add_argument("cut_rounds", type=int, nargs="?", default=0)
    add_instance_args(ap)
    args = ap.parse_args(argv)
    src = require_source(args.instance, args.data_dir, args.synthetic)
    base, z, y = make_face(load(src, args.instance), args.incumbent, args.cut_rounds)
    save_face(args.out, base, z, y)
    print(f"{label(args.instance, src)}: face {base.n_active} cols, LP bound {z:.6f} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

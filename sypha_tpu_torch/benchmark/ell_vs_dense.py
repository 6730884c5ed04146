"""The padded-ELL sparse operator against the dense one: the port of the JAX
package's benchmark/ell_vs_dense.py.

    python3 -m sypha_tpu_torch.benchmark.ell_vs_dense --synthetic \\
        [--lanes 8] [--instances scpnre1,scpnrf1,scpnrg1,scpnrh1] \\
        [--strategy dense|cg] [--out DIR] [--device cpu] [--data-dir DIR]

For each instance, ``--lanes`` replica lanes of its LP relaxation on the ELL
operator (``make_shared_batch_sparse``) and on the dense one, padded to the
same bucket, each solved by ``mehrotra_solve_shared`` once untimed (kernel
build, library handles, allocator blocks) and once timed between device
syncs.  Writes ``ell_vs_dense.csv`` with the JAX tool's columns (operator
memory, seconds, lane 0's objective and the converged lanes per operator)
and prints one JSON record per instance with them and, beside them, the
Gram kernel's launches in each timed solve (``<operator>_gram_launches``,
0 on the CPU), the lanes whose status differs between the operators
(``lanes_flipped``) and the largest relative difference between the
operators' objectives over the lanes converged on both
(``max_rel_diff_converged``).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

from sypha_tpu_torch.benchmark import RESULTS_DIR, add_common_args, label, load, require_source


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sypha_tpu_torch.benchmark.ell_vs_dense")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--instances", default="scpnre1,scpnrf1,scpnrg1,scpnrh1")
    ap.add_argument(
        "--strategy", default="dense", choices=["dense", "cg"],
        help="linear-solver strategy for BOTH operators ('dense' = f32 "
        "Gram-factor preconditioner; 'cg' = pure Jacobi-CG, the "
        "reference Krylov path)",
    )
    ap.add_argument("--out", default=str(RESULTS_DIR))
    add_common_args(ap)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from sypha_tpu_torch.config import IpmOptions
    from sypha_tpu_torch.core.device import resolve_device
    from sypha_tpu_torch.core.status import IpmStatus
    from sypha_tpu_torch.io.standard_form import pad_lp
    from sypha_tpu_torch.ipm.shared import make_shared_batch, make_shared_batch_sparse, mehrotra_solve_shared
    from sypha_tpu_torch.ops.gram import gram

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    opts = IpmOptions(linear_solver=args.strategy)
    rows, records = [], []
    for name in args.instances.split(","):
        name = name.strip()
        src = require_source(name, args.data_dir, args.synthetic)
        model = load(src, name)
        sp = make_shared_batch_sparse(model, args.lanes, device=dev)
        dn = make_shared_batch(pad_lp(model, m_pad=sp.m_pad, n_pad=sp.n_pad, device=dev), args.lanes)
        ell = sp.A
        ell_bytes = sum(t.numel() * t.element_size() for t in (ell.row_idx, ell.row_val, ell.col_idx, ell.col_val))
        dense_bytes = ell.m_pad * ell.n_pad * 8

        rec = {"instance": label(name, src), "lanes": args.lanes,
               "strategy": args.strategy,
               "ell_mb": round(ell_bytes / 1e6, 2),
               "dense_mb": round(dense_bytes / 1e6, 2),
               "mem_ratio": round(dense_bytes / ell_bytes, 2)}
        extra, lanes = {}, {}
        for tag, batch in (("dense", dn), ("sparse", sp)):
            mehrotra_solve_shared(batch, opts)  # warm: kernel build, handles
            sync()
            launches = gram.launches
            t0 = time.perf_counter()
            st = mehrotra_solve_shared(batch, opts)
            sync()
            dt = time.perf_counter() - t0
            extra[f"{tag}_gram_launches"] = gram.launches - launches
            status = st.status.cpu().numpy()
            obj = np.einsum("bn,bn->b", batch.c.cpu().numpy(), st.x.cpu().numpy())
            lanes[tag] = (status, obj)
            rec[f"{tag}_s"] = round(dt, 4)
            rec[f"{tag}_obj"] = round(float(obj[0]), 6)
            rec[f"{tag}_conv"] = int((status == IpmStatus.CONVERGED).sum())
        rec["speed_ratio_sparse_over_dense"] = round(rec["dense_s"] / rec["sparse_s"], 3)
        (s_d, o_d), (s_s, o_s) = lanes["dense"], lanes["sparse"]
        both = (s_d == IpmStatus.CONVERGED) & (s_s == IpmStatus.CONVERGED)
        extra["lanes_flipped"] = int((s_d != s_s).sum())
        extra["max_rel_diff_converged"] = float(
            np.max(np.abs(o_d - o_s)[both] / np.maximum(1.0, np.abs(o_d[both])), initial=0.0)
        )
        rows.append(rec)
        records.append({**rec, **extra})
        print(json.dumps(records[-1]), flush=True)

    os.makedirs(args.out, exist_ok=True)
    out_csv = os.path.join(args.out, "ell_vs_dense.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

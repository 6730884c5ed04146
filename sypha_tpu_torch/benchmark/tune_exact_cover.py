"""Offline tuning sweep of the exact-cover engine: the port of the JAX
package's benchmark/tune_exact_cover.py.

Replays one face against the native DFS (``face_replay`` in a fresh
process per run, so that each run reads its own engine environment) so
that engine knobs can be graded in minutes, with no solver run in the
loop.  Faces come from ``face_make`` (HiGHS duals: slightly harder than
in-run faces, the right direction for tuning) or SYPHA_TPU_DUMP_FACES:

    python3 -m sypha_tpu_torch.benchmark.face_make scpnre1 29 faces/nre1_b29.npz --synthetic
    python3 -m sypha_tpu_torch.benchmark.tune_exact_cover faces/nre1_b29.npz --budget 28 \\
        [--deadline 420] [--env SYPHA_EC_PROBE=1 ...] [--grid]

Each run reports the verdict, the wall and the SYPHA_EC_STATS counters (DFS
calls, ascent visits, dominance pairs), so a knob's effect is attributable.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(face: str, budget: float, deadline: float, env_overrides):
    """(stdout, wall s, [ec] stats lines, return code) of one replay."""
    env = dict(os.environ)
    env["SYPHA_EC_STATS"] = "1"
    for kv in env_overrides:
        k, _, v = kv.partition("=")
        env[k] = v
    t0 = time.monotonic()
    p = subprocess.run(
        [
            sys.executable, "-m", "sypha_tpu_torch.benchmark.face_replay", os.path.abspath(face),
            "--budget", str(budget), "--deadline", str(deadline),
        ],
        capture_output=True,
        text=True,
        env=env,
        cwd=ROOT,
    )
    wall = time.monotonic() - t0
    stats = [ln for ln in p.stderr.splitlines() if ln.startswith("[ec]")]
    return p.stdout.strip(), wall, stats, p.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sypha_tpu_torch.benchmark.tune_exact_cover",
        description="Offline tuning sweep of the exact-cover engine.",
    )
    ap.add_argument("face")
    ap.add_argument("--budget", type=float, required=True)
    ap.add_argument("--deadline", type=float, default=420.0)
    ap.add_argument("--env", nargs="*", default=[], help="engine env overrides, e.g. SYPHA_EC_PROBE=0")
    ap.add_argument(
        "--grid", action="store_true",
        help="sweep SYPHA_EC_SWEEPS x SYPHA_EC_DOM (PROBE on), best-first "
        "report; single --env run otherwise",
    )
    args = ap.parse_args(argv)
    if not args.grid:
        out, wall, stats, rc = run_one(args.face, args.budget, args.deadline, args.env)
        print(out)
        for ln in stats[-4:]:
            print(ln)
        print(f"wall={wall:.1f}s rc={rc}")
        return rc

    results = []
    for sweeps in (1, 2, 4, 8):
        for dom in (16, 64, 256, 2048):
            env = [f"SYPHA_EC_SWEEPS={sweeps}", f"SYPHA_EC_DOM={dom}"]
            out, wall, stats, rc = run_one(args.face, args.budget, args.deadline, env)
            verdict = out.splitlines()[-1] if out else "?"
            tag = f"sweeps={sweeps} dom={dom}"
            print(f"{tag:24s} wall={wall:7.1f}s  {verdict}", flush=True)
            results.append((wall, tag, verdict))
    results.sort()
    print("\n=== fastest ===")
    for wall, tag, verdict in results[:5]:
        print(f"{wall:7.1f}s  {tag}  {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

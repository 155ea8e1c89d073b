#!/usr/bin/env python3
"""Run a cell several times, one process after another (one process on
the card at a time), and report each metric's median and spread:

    python3 portbench/sets.py --workload <cell> --seeds 11,12,13 \
        [--seconds 30] [--trace 0|1] [--control] [--out FILE]

Each run is ``run.py`` with one seed; its last line is kept. A spread is
(third quartile − first) / median, the quartiles as
``statistics.quantiles(values, n=4)`` gives them. Every kept line and the
summary are appended to ``--out`` (default
``build/portbench/sets.jsonl`` in the checkout)."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import spec, stats  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "portbench" /
                                         "sets.jsonl"))
    args = ap.parse_args(argv)
    secs = args.seconds or spec.benchmark()["run_seconds"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, str(ROOT / "portbench" / "run.py"),
               "--workload", args.workload, "--seed", seed,
               "--seconds", str(secs), "--trace", str(args.trace)]
        if args.control:
            cmd.append("--control")
        t = time.time()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        wall = time.time() - t
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        rec = {"workload": args.workload, "seed": int(seed), "rc": p.returncode,
               "wall_s": wall, "trace": args.trace, "control": args.control}
        try:
            rec["result"] = json.loads(last)
        except json.JSONDecodeError:
            rec["stdout_tail"] = p.stdout[-3000:]
        prev = p.stdout.strip().splitlines()[-2:-1]
        if prev:
            rec["info"] = prev[0][:6000]
        rec["stderr_tail"] = p.stderr[-1500:]
        lines.append(rec)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        r = rec.get("result", {})
        print(f"seed {seed} rc {p.returncode} wall {wall:.1f}s correct "
              f"{r.get('correct')} metrics "
              f"{ {k: v['value'] for k, v in r.get('metrics', {}).items()} } "
              f"compared { {k: v['value'] for k, v in r.get('compared', {}).items()} }",
              flush=True)
        if p.returncode != 0:
            print(p.stderr[-3000:], flush=True)
    summary = {}
    names = sorted({k for rec in lines
                    for k in rec.get("result", {}).get("metrics", {})})
    for name in names:
        vals = [rec["result"]["metrics"][name]["value"] for rec in lines
                if name in rec.get("result", {}).get("metrics", {})]
        row = {"n": len(vals), "median": statistics.median(vals),
               "values": vals}
        if len(vals) >= 2:
            row["spread"] = stats.spread(vals)
        summary[name] = row
    print(json.dumps({"summary": args.workload, "seconds": secs,
                      "trace": args.trace, "metrics": summary}), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps({"summary": args.workload, "seconds": secs,
                            "metrics": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start to the first
timed operation): the program's kernels built or loaded, the data made on
the card from the seed, the index fitted, every shape the window uses
warmed. Then the window: the cell's traffic for ``--seconds``. Then, with
the window closed and the peak memory read, what the judge needs from the
program; the program freed; the reference over the live rows; the numbers
compared, each beside its limit; the result as the last line of standard
output. With ``--trace 1`` the window runs the same and the profiler
traces a steady part of it; the line then holds the per-layer metrics.

Other modes (none of them a benchmark run):
  --rehearse            the same run on the CPU at the configuration's
                        rehearsal sizes, through the kernels' plain
                        versions; its line says platform "cpu"
  --control             the reference in TF32 put in the program's place,
                        judged as a run is (its ``correct`` must be false)
  --sweep R1,R2,...     an open-loop cell's knee sweep, one process,
                        ``--seconds`` a rate
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# every cache of the program and of the toolchain in fixed directories of
# the checkout (the program's nvcc and g++ libraries go to build/kernels
# and build/native there by themselves)
for _var, _sub in (("CUDA_CACHE_PATH", "cuda-cache"),
                   ("TORCH_EXTENSIONS_DIR", "torch-extensions"),
                   ("TRITON_CACHE_DIR", "triton-cache")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)

import torch  # noqa: E402


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def fail(msg: str, code: int = 2) -> None:
    log(f"portbench: {msg}")
    sys.exit(code)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--sweep", default=None)
    return ap.parse_args(argv)


class Run:
    """What one run knows; the metric readers read it (README.md)."""

    def __init__(self, cell, device, args):
        self.cell = cell
        self.device = device
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.span = None
        self.trace_result = None
        self.setup_s = None
        self.build_timings: dict = {}
        self.window: dict = {}
        self.before: dict = {}
        self.after: dict = {}
        self.probes: dict = {}
        self.judged: dict = {}
        self.info: dict = {}
        self.idx = None
        self.loop = None


def rehearsal(cell) -> None:
    """The configuration's and the mix's rehearsal sizes in place."""
    cell.config["data"].update(cell.config["rehearsal"]["data"])
    cell.traffic.update(cell.traffic.get("rehearsal", {}))


def counters() -> dict:
    """The program's own counters: every kernel's launches (summed) and
    the captured layer's captures, seconds and replays."""
    from alayalite_tpu_torch.index import captured

    by_kernel = {fn.__name__: n for (fn, attr, route), n
                 in captured.counts().items()
                 if attr == "launches" and route is None}
    return {"launches": sum(by_kernel.values()), "by_kernel": by_kernel,
            "captured": dict(captured.stats)}


def card() -> dict:
    """Name, power limit, clocks, draw and temperature from nvidia-smi."""
    fields = "name,power.limit,power.draw,clocks.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    return {"nvidia_smi": out}


def build_index(cell, device):
    from alayalite_tpu_torch.index_api import create_index

    params = dict(cell.config["index"])
    params["capacity"] = int(cell.traffic.get(
        "capacity", cell.config["data"]["n"]))
    return create_index(cell.name, device=device, **params)


def free_program(run) -> None:
    from alayalite_tpu_torch.index import captured

    run.idx = None
    run.loop.idx = None
    captured.clear()
    gc.unfreeze()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()


def reference_and_judge(run, control: bool = False) -> dict:
    from portbench import reference

    loop = run.loop
    x_live, live_pos, store = loop.live_rows()
    q = loop.judged_queries()
    t = time.perf_counter()
    ref = reference.knn(x_live, q, loop.k, loop.metric)
    run.info["reference_s"] = time.perf_counter() - t
    if control:
        got = reference.knn_tf32(x_live, q, loop.k, loop.metric)
        live_ids = torch.nonzero(live_pos >= 0).reshape(-1)
        loop.set_control_answers(live_ids[got.ids].cpu().numpy())
    return loop.judge(ref, x_live, live_pos, store)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import judge, nojax, spec
    from portbench import data as data_mod
    from portbench.trace import Span

    if args.rehearse:
        device = torch.device("cpu")
        torch.set_num_threads(4)
    else:
        if not torch.cuda.is_available():
            fail("no CUDA device: the benchmark runs on the card only "
                 "(--rehearse runs the CPU rehearsal)")
        device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    if not args.rehearse and torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")
    if args.rehearse:
        rehearsal(cell)
    run = Run(cell, device, args)
    marks = run.info["setup_marks_s"] = {"imports": time.perf_counter()
                                         - T_START}
    data = data_mod.make(cell.config["data"], run.seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks["data"] = time.perf_counter() - T_START
    loop_cls = spec.traffic_kind(cell.traffic["kind"])
    if args.control:
        return control(run, data, loop_cls)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.idx = build_index(cell, device)
    run.idx.fit(data.base,
                ef_construction=int(cell.config["fit"]["ef_construction"]))
    run.build_timings = dict(run.idx._engine.build_timings)
    marks["fit"] = time.perf_counter() - T_START
    run.loop = loop = loop_cls(run, run.idx, data)
    loop.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks["warm"] = time.perf_counter() - T_START
    # what set-up made (the index's host side, the interpreter's modules,
    # the data's host copies) goes out of the collector's reach, so that a
    # full collection in the window walks only what the window allocates
    # (PERF.md: ~70-140 ms pauses otherwise, in every cell)
    gc.collect()
    gc.freeze()
    if args.sweep:
        return sweep(run, [float(r) for r in args.sweep.split(",")],
                     run.seconds)
    if run.trace:
        run.span = Span(device)
        run.span.warm()
    run.before = counters()
    gc0 = [g["collections"] for g in gc.get_stats()]
    run.setup_s = time.perf_counter() - T_START
    run.window = loop.window(run.seconds)
    run.after = counters()
    run.info["gc_collections_in_window"] = [
        g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if run.span is not None:
        run.trace_result = run.span.reduce()
    metrics = cell.per_layer if run.trace else cell.end_to_end
    spec.probe_all(metrics, run)
    loop.collect()
    free_program(run)
    run.judged = reference_and_judge(run)
    checks = judge.compared(run.judged, cell.limits,
                            float(cell.config["search"]["recall_floor"]))
    values = spec.read_all(metrics, run)
    bad = nojax.found()
    if bad:
        fail(f"modules of JAX or the JAX package were loaded: {bad}", 3)
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": int(run.window["attempted"]),
        "failed": int(run.window["failed"]),
        "metrics": values,
        "device": device_entry(device, peak, run),
    }
    if run.trace_result is not None:
        result["breakdown"] = run.trace_result.breakdown()
    result["compared"] = {c.name: c.entry() for c in checks}
    print(json.dumps({"info": info(run, device)}), flush=True)
    for c in checks:
        log(c.line())
    print(json.dumps(result), flush=True)
    return 0


def device_entry(device, peak: int, run) -> dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": run.cell.chips, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu rehearsal", "count": 1,
               "memory_peak_bytes": 0}
    tr = run.trace_result
    if tr is not None:
        out["busy_s"] = tr.busy_s
        out["window_s"] = tr.window_s
    return out


def info(run, device) -> dict:
    out = dict(run.info)
    out.update({"workload": run.cell.name, "seed": run.seed,
                "seconds": run.seconds, "trace": run.trace,
                "setup_s": run.setup_s,
                "window_s": run.window.get("seconds"),
                "fit_phases_s": run.build_timings,
                "judged": run.judged,
                "captured_in_window": {
                    k: run.after["captured"][k] - run.before["captured"][k]
                    for k in run.after["captured"]},
                "launches_in_window": run.after["launches"]
                - run.before["launches"]})
    if device.type == "cuda":
        out["card"] = card()
        out["memory_peak_reserved_bytes"] = torch.cuda.max_memory_reserved(
            device)
    if run.trace_result is not None:
        out["trace_work"] = run.trace_result.work
    return out


def control(run, data, loop_cls) -> int:
    """The reference in TF32 in the program's place, judged as a run is."""
    from portbench import judge

    run.loop = loop = loop_cls(run, None, data)
    loop.simulate()
    run.judged = reference_and_judge(run, control=True)
    checks = judge.compared(run.judged, run.cell.limits,
                            float(run.cell.config["search"]["recall_floor"]))
    for c in checks:
        log(c.line())
    print(json.dumps({"control": True, "workload": run.cell.name,
                      "seed": run.seed,
                      "correct": all(c.ok for c in checks),
                      "compared": {c.name: c.entry() for c in checks}}),
          flush=True)
    return 0


def sweep(run, rates, secs: float) -> int:
    """The knee sweep of an open-loop cell: a table line a rate."""
    rows = run.loop.sweep(rates, secs)
    for r in rows:
        print("sweep " + " ".join(f"{k}={v!r}" for k, v in r.items()),
              flush=True)
    run.loop.collect()
    print(json.dumps({"sweep": rows, "seconds": secs,
                      "card": card() if run.device.type == "cuda" else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

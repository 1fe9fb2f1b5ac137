"""One benchmark run of one cell of ``tpuvc_torch`` on the CUDA card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's file (``workloads/<cell>.json``) names its configuration and
traffic mix; the mix's ``kind`` picks the driver (``drivers/<kind>.py``)
that sets the program up, runs the measured window and compares what the
window produced with the plain reference (``reference/``).  The last
line of standard output is one JSON object: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics and
``breakdown`` (a profiler over the window's first ``trace.TRACE_S``
seconds; the benchmark's own spans are read over the rest).  The numbers compared with
the reference, each beside its limit, close standard error and the
result line.  A machine without enough CUDA cards, or a run that loaded
JAX or the JAX package, exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import common  # noqa: E402

common.set_run_env()

import torch  # noqa: E402

from benchmark import kernels, readers, trace  # noqa: E402


class Run:
    """What a driver sees of the run: its names, seed, files and device,
    and what it reports back (end-to-end values, counters and spans for
    the per-layer readers, the requests attempted and failed)."""

    def __init__(self, cell: str, seed: int, device, traffic_overrides=None,
                 config_overrides=None):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.workload = common.load_json("workloads", cell)
        self.config = {**common.load_json("configs", self.workload["config"]),
                       **(config_overrides or {})}
        # a cell may set its own values of its mix's parameters
        self.traffic = {**common.load_json("traffic",
                                           self.workload["traffic"]),
                        **self.workload.get("traffic_params", {}),
                        **(traffic_overrides or {})}
        self.limits = self.workload.get("limits", {})
        self.end_to_end: dict[str, float] = {}
        self.counters: dict[str, float] = {}
        self.spans: dict[str, list[float]] = {}
        self.notes: dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.summary: trace.Summary | None = None
        self.roofline: kernels.Recorder | None = None
        self.tracer: trace.Tracer | None = None

    def boundary(self) -> None:
        """Called by the driver after each request, step or tick, with
        the counters and spans brought up to date."""
        if self.tracer is not None:
            self.tracer.poll(self)


def device_info(dev, count: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def execute(cell: str, seed: int, seconds: float, traced: bool,
            device="cuda", traffic_overrides=None, config_overrides=None,
            t_start=None) -> dict:
    """Set up, measure and check one run; the result object (the last
    line's keys, ``checks`` last).  The overrides replace top-level keys
    of the cell's traffic mix and configuration (small CPU runs)."""
    t_start = T_START if t_start is None else t_start
    spec = common.benchmark_spec()
    run = Run(cell, seed, device, traffic_overrides, config_overrides)
    kind = run.traffic["kind"]
    driver = importlib.import_module(f"benchmark.drivers.{kind}").Cell(run)
    per_layer = common.cell_metrics(spec, cell, "per_layer")
    end_to_end = common.cell_metrics(spec, cell, "end_to_end")
    if traced:
        run.roofline = kernels.Recorder.for_metrics(
            [m["name"] for m in per_layer])
    driver.setup()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    # what set-up made lives through the window: keep the collector off it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    run.tracer = trace.Tracer(traced, trace.TRACE_S)
    run.tracer.start()
    driver.window(seconds)
    run.tracer.stop(run)
    gc.unfreeze()
    run.tracer.finish()
    run.summary = run.tracer.summary
    dev = device_info(run.device, run.workload["chips"])
    driver.release()
    checks = driver.check()
    correct = (run.failed == 0 and bool(checks)
               and all(v <= lim for v, lim in checks.values()))
    if traced:
        # readings of the trace take the counters of the traced stretch;
        # the benchmark's own spans and counters, the rest of the window
        views = {"device_trace": run.tracer.stretch(run)}
        rest = run.tracer.rest(run)
        metrics = {}
        for m in per_layer:
            run.counters, run.spans = views.get(m["source"], rest)
            value = readers.find(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        s = run.summary
        if s is not None:
            dev["busy_s"] = s.busy_s
            dev["window_s"] = s.window_s
    else:
        values = {**run.end_to_end, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in end_to_end}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if traced and run.summary is not None:
        out["breakdown"] = run.summary.breakdown()
    if run.notes:
        out["notes"] = run.notes
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = common.load_json("workloads", args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this run needs {chips} CUDA card(s) and the machine has "
              f"{n}: no measurement on the CPU", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    found = common.forbidden_loaded()
    if found:
        print("the run loaded JAX or the JAX package: " + ", ".join(found),
              file=sys.stderr)
        return 3
    leaks = common.reference_leaks()
    if leaks:
        print("the reference holds the program's names: " + ", ".join(leaks),
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

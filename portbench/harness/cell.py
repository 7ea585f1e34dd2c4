"""One run of one cell: set-up (weights and inputs from the seed, the
port's timed path built and warmed up), with `--trace 1` one trace of a
few calls, then the measured window, then the check against the plain
reference, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result object; the numbers
compared, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from harness import check, spec, tracing, traffic, weights
from harness.drivers import PREDICTOR_KEY, ServeDriver, TrainDriver

# top-level module names that no process of the benchmark may hold: the
# JAX package, JAX itself and the JAX package's benchmark
FORBIDDEN = ("jax", "jaxlib", "flax", "gridgcn_tpu", "bench")
SAMPLE_SEED = 7         # the reservoir's stream under the run's seed
TRACE_FILE = "build/portbench/trace.json"


def forbidden_modules(modules=None) -> list:
    """The names in `modules` (default `sys.modules`) whose top-level name,
    compared whole, is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the cell, the window, the trace."""
    cell: spec.Cell
    driver: str             # "serve" or "train"
    points: int             # points one call carries
    calls: int              # requests or steps completed in the window
    window_s: float
    latencies_s: list
    setup_s: float
    trace: tracing.TraceRecord | None
    gc_collections: list    # the cyclic collector's runs in the window,
                            # by generation


class Reservoir:
    """A uniform sample of `k` of the window's outputs, drawn from the
    seed as they come (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = np.random.default_rng([seed, SAMPLE_SEED])

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def power_limit_w():
    """The card's power limit in watts from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             root=None, log=print) -> dict:
    """One run of cell `name`; returns {"result": the result object
    (without "device"), "checked": the numbers compared, "memory_peak":
    bytes or None, "trace": TraceRecord or None, "run": the `Run` the
    readers read}. `log` takes the lines for standard error."""
    t_start = time.perf_counter() if t_start is None else t_start
    from gridgcn_torch.configs.base import from_dict as port_from_dict
    from reference.config import from_dict as ref_from_dict

    root = spec.ROOT if root is None else root
    cell = spec.load_cell(name, root)
    wl = cell.workload
    port_cfg = port_from_dict(cell.config_file["config"])
    ref_cfg = ref_from_dict(cell.config_file["config"])
    net = spec.reference_network(cell.config_file, cell.bench_dir)
    sd = weights.make_state_dict(ref_cfg.model, seed, device, net)
    pool = traffic.make_pool(wl, seed, cell.bench_dir)
    key = np.array([0, seed & 0xFFFFFFFF], np.uint32)   # PRNGKey(seed)
    batch = int(wl["batch"])
    chk = wl["check"]

    if wl["driver"] == "serve":
        # what the check hands the reference: the traffic's own requests,
        # whatever the timed path made of them
        served = traffic.requests(pool, batch)
        drv = ServeDriver(port_cfg, sd, pool, batch, device, net=net)
        for i in range(int(wl["warmup"])):
            drv.call(i)
    elif wl["driver"] == "train":
        batches = traffic.Batches(pool, batch, seed)
        drv = TrainDriver(port_cfg, sd, batches, key, device, net=net)
        # the check's first steps are the window's own calls on its feed
        prog = {"losses": []}
        for i in range(int(chk["steps"])):
            prog["losses"].append(drv.call(i))
            if i == 0:
                prog["grad_norms"] = drv.first_gradient_norms()
        prog["changes"] = check.changes(drv.state_copy(), sd)
        check_batches = [batches.get(j) for j in range(int(chk["steps"]))]
    else:
        raise ValueError(f"unknown driver {wl['driver']!r}")
    _sync(device)

    n_done = int(wl["warmup"]) if wl["driver"] == "serve" else \
        int(chk["steps"])
    rec = None
    if trace:
        trace_window = tracing.capture(
            lambda i: drv.call(n_done + i), int(wl["trace_iters"]),
            str(root / TRACE_FILE))
        n_done += int(wl["trace_iters"])

    # the measured window: calls back to back, each timed from its start
    # until its result is on the host. What set-up made (modules, weights,
    # pools) leaves the cyclic collector first, so that the window's
    # collections traverse only the window's own objects.
    sample = Reservoir(int(chk.get("sample", 0)), seed)
    lat = []
    gc.collect()
    gc.freeze()
    gc_before = [g["collections"] for g in gc.get_stats()]
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    i = 0
    while True:
        ts = time.perf_counter()
        out = drv.call(n_done + i)
        te = time.perf_counter()
        lat.append(te - ts)
        if wl["driver"] == "serve":
            sample.offer((served[(n_done + i) % len(served)], out))
        i += 1
        if te >= deadline:
            break
    window_s = te - t0
    gc_window = [g["collections"] - b
                 for g, b in zip(gc.get_stats(), gc_before)]
    gc.unfreeze()
    mem = (torch.cuda.max_memory_allocated()
           if torch.device(device).type == "cuda" else None)

    # the program's state freed before the reference runs
    drv.close()
    del drv
    _free(device)

    if trace:
        try:
            rec = tracing.read(str(root / TRACE_FILE),
                               int(wl["trace_iters"]), trace_window)
        except tracing.LostRecords as e:
            log(f"trace refused, no per-layer metric read: {e}")

    if wl["driver"] == "serve":
        from reference.serve import ServeReference

        ref = ServeReference(ref_cfg, sd, device, net=net)
        readings = check.serve_readings(
            sample.items,
            lambda r: ref(r.xyz, PREDICTOR_KEY, r.feat).cpu().numpy())
        del ref
    else:
        from reference.train import TrainReference

        trainer = TrainReference(ref_cfg, sd, batches.per_epoch, device,
                                 net=net)
        ref_readings = check.reference_train_readings(trainer, check_batches,
                                                      key)
        readings = check.train_readings(prog, ref_readings)
        log(f"check beside the compared numbers: "
            f"{check.train_diagnostics(prog, ref_readings)}")
        del trainer
    _free(device)
    correct, checked = check.verdict(readings, chk["limits"])

    run = Run(cell=cell, driver=wl["driver"],
              points=int(batch * pool.xyz.shape[1]), calls=i,
              window_s=window_s, latencies_s=lat, setup_s=setup_s,
              trace=rec, gc_collections=gc_window)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    result = {"correct": correct, "attempted": i, "failed": 0,
              "metrics": metrics}
    if rec is not None:
        result["breakdown"] = rec.breakdown()
    return {"result": result, "checked": checked, "memory_peak": mem,
            "trace": rec, "run": run}


def main(argv=None, t_start: float | None = None) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = spec.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
              "found", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=t_start, log=log)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3

    res = out["result"]
    rec = out["trace"]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": out["memory_peak"],
           "power_limit_w": power_limit_w()}
    if args.trace:
        dev["busy_s"] = rec.busy_s if rec else None
        dev["window_s"] = rec.window_s if rec else None
    res["device"] = dev
    # a NaN or an infinite reading is printed as text: JSON has no number
    # for it
    res["checked"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                          else repr(c["value"]), "limit": c["limit"]}
                      for k, c in out["checked"].items()}
    run = out["run"]
    log(f"cell {args.workload} seed {args.seed}: {run.calls} calls in "
        f"{run.window_s:.6f} s, set-up {run.setup_s:.6f} s, peak memory "
        f"{out['memory_peak']} bytes, collections in the window by "
        f"generation {run.gc_collections}")
    for line in info_lines(run):
        log(line)
    for name, c in out["checked"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


def info_lines(run: Run) -> list:
    """Lines for standard error beside the metrics: each metric reader's
    `info(run)` where it has one."""
    out = []
    for m in run.cell.end_to_end + run.cell.per_layer:
        info = getattr(m.reader, "info", None)
        if info is not None:
            line = info(run)
            if line:
                out.append(f"{m.name}: {line}")
    return out

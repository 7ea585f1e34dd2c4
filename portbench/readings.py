#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card: for each
seed, in one process, a short run of the cell through the harness's own
`cell.run_cell` (the window, the check and its verdict as every run makes
them), with the timed path as it is (`program`), the port in float32
(`program32`, a witness beside the reference), or the driver swapped for
the control (the reference computed in fp8 in the program's place) or for
the fault the cell can have (serving: an answer altered where it is
produced; training: half of each batch left out, the mean taken over the
rest). One JSON line per seed and side: the numbers compared beside their
limits, the verdict, and the lines the run logged.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \
        [--sides program control fault program32] [--seconds 3] \
        [--out FILE]

Not run by the benchmark's runs: its numbers go into PERF.md and the
workload's limits."""

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

SIDES = ("program", "control", "fault", "program32")


def _float32(port_cfg):
    """The port's configuration with every dtype float32."""
    return dataclasses.replace(port_cfg, model=dataclasses.replace(
        port_cfg.model, dtype="float32", bn_dtype="", att_dtype="",
        interp_dtype="", eval_dtype=""))


def drivers(side: str) -> tuple:
    """(serving driver, training driver) that stand in `side`'s timed
    path; each takes the arguments of `harness.drivers`' own."""
    from harness import controls
    from harness.drivers import ServeDriver, TrainDriver

    if side == "program":
        return ServeDriver, TrainDriver
    if side == "program32":
        return (lambda cfg, *a, **k: ServeDriver(_float32(cfg), *a, **k),
                lambda cfg, *a, **k: TrainDriver(_float32(cfg), *a, **k))
    if side == "control":
        return controls.ControlServe, controls.ControlTrain
    if side == "fault":
        return controls.AlteredServe, controls.half_batch_train
    raise ValueError(f"unknown side {side!r}")


@contextlib.contextmanager
def timed_path(side: str):
    """`cell.run_cell` with its drivers swapped for `side`'s."""
    from harness import cell

    saved = cell.ServeDriver, cell.TrainDriver
    cell.ServeDriver, cell.TrainDriver = drivers(side)
    try:
        yield cell
    finally:
        cell.ServeDriver, cell.TrainDriver = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sides", nargs="+", default=list(SIDES[:3]),
                   choices=SIDES)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            for side in args.sides:
                logged = []
                t0 = time.perf_counter()
                with timed_path(side) as cell:
                    r = cell.run_cell(args.workload, seed, args.seconds,
                                      False, device=args.device,
                                      log=logged.append)
                line = json.dumps({
                    "workload": args.workload, "seed": seed, "side": side,
                    "correct": r["result"]["correct"],
                    "readings": {k: c["value"]
                                 for k, c in r["checked"].items()},
                    "checked": r["checked"],
                    "seconds": time.perf_counter() - t0, "log": logged})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

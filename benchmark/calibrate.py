"""Readings that a cell's limits are set from: the program's compared
numbers on many seeds, and those of each control put in its place.

    python3 -m benchmark.calibrate --workload <name> --seeds 11 12 13 ...

For each seed it builds the cell as a run does and drives the program
through what a run compares (a train cell's first steps; an encrypted
cell's requests, back to back, as many as ``--units`` says: those a
run's window serves), then
prints one JSON line: the program's readings against the reference, and
each control's (``Run.controls``); for an encrypted request whose logits
are off by more than the largest logit, the readings of two witnesses on
its images (``Run.witness``). The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload: str, seed: int, device: str = "cuda", cell=None,
             units: int = None) -> dict:
    """One seed's readings; ``cell`` (entry, configuration, traffic,
    limits) replaces the cell's files."""
    import importlib

    from benchmark import common

    entry, cfg, traffic, limits = cell or common.cell(workload)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    run = driver.Run(cfg, traffic, seed, device)
    t0 = time.perf_counter()
    run.setup()
    if driver.UNIT == "request":
        if units is None:
            raise SystemExit("a cell of requests needs --units: the requests a run's window "
                             "serves")
        run.run_units(units)
    ref = run.reference()
    prog = run.readings(ref)
    where = dict(run.where)
    out = {"workload": workload, "seed": seed, "program": prog, "where": where,
           "controls": run.controls(ref), "seconds": time.perf_counter() - t0}
    if where.get("off_by_over_scale"):
        out["witness"] = run.witness(ref, where["off_by_over_scale"])
    run.release()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, default=None)
    p.add_argument("--config", help="with --traffic: a cell not in BENCHMARK.json")
    p.add_argument("--traffic")
    a = p.parse_args(argv)
    from benchmark import common

    cell = common.cell(a.workload, a.config, a.traffic)
    for seed in a.seeds:
        print(json.dumps(readings(a.workload, seed, cell=cell, units=a.units)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its limits are found by
name from ``BENCHMARK.json``; the traffic mix names the driver
(``benchmark/drivers/<driver>.py``) that sets the program up and runs its
window, and each per-layer metric is read by
``benchmark/metrics/<metric>.py``. With ``--trace 0`` the metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones, read
from a traced stretch after an untraced window. Every run compares what
its timed path produced with the plain reference under
``benchmark/reference/`` and prints each compared number beside its limit.

It measures ``primia_tpu_torch`` only, on CUDA devices only: without a
card, or with fewer than the cell asks for, it exits with 3 and prints no
result; it exits with 4 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BUILD = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "primia_tpu")


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["USE_FLAX"] = "0"


def _age_at_start() -> float:
    """Seconds from the process's start (the kernel's start time, in clock
    ticks) to the first line of this module: the interpreter's start-up."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start - (time.perf_counter() - _T0), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _age_at_start()


def _process_age() -> float:
    """Seconds since this process started."""
    return _AGE0 + time.perf_counter() - _T0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _reader(name: str):
    """The module of a per-layer metric (``benchmark/metrics/<name>.py``):
    its ``read(ctx)`` and, where it needs calls of the port's functions
    noted in the traced stretch, its ``PATCHES``."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


# seconds from the process's start to the end of each step of ``main``
# before the driver's set-up
_STARTUP = {}


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            cell=None, setup_started: float = None) -> dict:
    """One run of ``workload``; returns the result's fields. ``cell``
    (workload entry, configuration, traffic, limits) replaces the files'
    (tests run small cells on the CPU)."""
    import torch

    from benchmark import common

    _, cfg, traffic, limits = cell or common.cell(workload)
    s = common.spec()
    e2e = [m for m in s["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in s["per_layer"] if workload in m.get("workloads", [workload])]
    torch.manual_seed(seed % (1 << 63))
    if device == "cuda":
        torch.backends.cudnn.benchmark = False
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    run = driver.Run(cfg, traffic, seed, device)
    setup_at = _process_age() if setup_started is None else 0.0
    run.setup()
    setup_s = (_process_age() if setup_started is None
               else time.perf_counter() - setup_started)
    res = run.window(seconds)
    metrics = {}
    for m in e2e:
        if m["name"] == "setup_s":
            metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
        elif m["name"] in res["metrics"]:
            metrics[m["name"]] = {"value": res["metrics"][m["name"]], "unit": m["unit"]}
    cuda = device == "cuda"
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1}
    if cuda:
        torch.cuda.synchronize()
    dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    out = {"attempted": res["attempted"], "failed": res["failed"]}
    if trace:
        from benchmark import trace as T

        readers = {m["name"]: _reader(m["name"]) for m in per_layer}
        t, attributed, calls = T.capture(
            run, run.trace_units(), BUILD / f"trace-{os.getpid()}.json", device,
            {n: r.PATCHES for n, r in readers.items() if getattr(r, "PATCHES", None)})
        ctx = T.Ctx(unit=driver.UNIT, units=run.trace_units(),
                    images_per_unit=run.images_per_unit, unit_seconds=run.unit_seconds,
                    cfg=cfg, trace=t, attributed=attributed)
        metrics = {}
        for m in per_layer:
            v = readers[m["name"]].read(dataclasses.replace(ctx, calls=calls.get(m["name"], [])))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=t.busy_us / 1e6, window_s=t.window_us / 1e6)
        out["breakdown"] = T.breakdown(t, attributed)
    found = forbidden_modules()
    if found:
        out["forbidden"] = found
        return out
    run.release()
    readings = run.check()
    compared = {k: {"value": readings[k], "limit": lim["limit"]} for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    out.update(correct=correct, metrics=metrics, device=dev_info, compared=compared,
               notes=dict(getattr(run, "notes", {}),
                          startup_at_s=dict(_STARTUP, driver_setup=setup_at),
                          setup_phases_s=getattr(run, "phases", {}),
                          **getattr(run, "where", {})))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _caches()
    _STARTUP["interpreter"] = _AGE0
    import torch

    from benchmark import common

    _STARTUP["import_torch"] = _process_age()
    entry = common.cell(a.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # one intra-op thread: the program's host work is one thread dispatching
    # to the card, and a pool of a thread a core spinning beside it spread the
    # rate between runs (PERF.md)
    torch.set_num_threads(1)
    _STARTUP["cuda_query"] = _process_age()
    out = execute(a.workload, a.seed, a.seconds, bool(a.trace))
    if "forbidden" in out:
        print(f"loaded after the window: {', '.join(out['forbidden'])}", file=sys.stderr)
        return 4
    # read once the window has closed: no request needs it
    print(f"card: {_power_limit()}", file=sys.stderr)
    print(json.dumps({"notes": out.pop("notes")}), file=sys.stderr)
    for k, c in out["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["compared"] = out["compared"]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

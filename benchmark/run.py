"""The benchmark of vacancy_tpu_torch on NVIDIA GPUs.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(imports, the CUDA context, the kernels from the build cache inside the
checkout, the inputs made on the card from the seed, a warm request), a
closed loop of reconstructions for ``--seconds``, then the check against
the plain reference (``benchmark/reference``). With ``--trace 1`` the
window runs under ``torch.profiler`` and the cell's per-layer metrics are
reported; with ``--trace 0`` its end-to-end metrics.

Its last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
with ``--trace 1``), and last ``checks``, each compared number with its
limit; those numbers are also the last lines on standard error. It exits
with 2, printing no result, without enough CUDA devices, and with 3 when
the process holds JAX or the JAX package after the window.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent


def _boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def _process_start() -> float:
    """When this process started, on ``_boot_clock``."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def _import_path() -> None:
    """The benchmark's folder and the checkout on the import path. The
    program builds its kernels into ``build/vacancy_tpu_torch/`` inside
    the checkout by itself and reads no cache setting."""
    sys.path[:0] = [str(BENCH), str(CHECKOUT)]


FORBIDDEN = ("jax", "jaxlib", "flax", "vacancy_tpu")


def _card(device_index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def _forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = _process_start()
    _import_path()

    from harness import cells, check, driver, roofline

    cell = cells.load_cell(args.workload)
    benchmark = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    section = "per_layer" if args.trace else "end_to_end"
    wanted = cells.metrics_of(args.workload, section, benchmark)
    readers = {name: cells.load_reader(
        "layer_metrics" if args.trace else "end_to_end", name)
        for name in wanted}

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {cell.chips} CUDA device(s); {n} found",
              file=sys.stderr)
        return 2

    run = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", started, clock=_boot_clock)

    found = _forbidden_modules()
    if found:
        print(f"the process holds {found} after the window", file=sys.stderr)
        return 3

    name = torch.cuda.get_device_name(0)
    print(f"device {name!r}; nvidia-smi name, power limit: {_card(0)}; "
          f"published peaks {roofline.PEAK_BYTES_S:.4g} B/s, "
          f"{roofline.PEAK_F32_OPS_S:.4g} float32 op/s", file=sys.stderr)
    print(f"set-up {run.setup_s!r} s: {run.setup_phases}", file=sys.stderr)
    print(f"requests {len(run.requests)} in {run.window_s!r} s, "
          f"failed {run.failed}; launches per request {run.launches}",
          file=sys.stderr)
    print(f"memory peak {run.memory_peak_bytes} B without the check's "
          f"samples, {run.process_peak_bytes} B with them", file=sys.stderr)
    print(f"per request {driver.describe(run.requests)}; load average "
          f"{os.getloadavg()}", file=sys.stderr)

    metrics = {}
    for mname, spec in wanted.items():
        value = readers[mname](run)
        if value is not None:
            metrics[mname] = {"value": value, "unit": spec["unit"]}
    device = {"platform": "gpu", "kind": name, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": run.correct,
              "attempted": len(run.requests) + run.failed,
              "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {k: {"value": run.readings.get(k), "limit": v}
                        for k, v in cell.limits.items()}
    for line in check.format_lines(run.readings, cell.limits):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

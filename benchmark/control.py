"""The readings that the limits of a cell's checks are set from.

    python benchmark/control.py --workload <cell> --seconds 3 \
        --seeds <n> [<n> ...] [--control-seeds 3]

In one process, on one CUDA device: for every seed, a short run of the
cell (its set-up, a window of ``--seconds`` at the cell's own load, the
check of as many sampled requests as a run checks), whose compared
numbers are the program's readings; and for the first
``--control-seeds`` seeds the control: the plain reference put in the
program's place with its SDF images and state kept in bfloat16, one
precision below the configuration's float32, on the frames the run
sampled as many, compared with the same numbers. The last line is a JSON
object: per number the largest program reading (the lower reading) and
the smallest control reading (the upper one). The benchmark's own runs
do not run this.
"""

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import argparse  # noqa: E402
import json  # noqa: E402


def control_readings(cell, seed, device):
    """The control's compared numbers on ``check_requests`` frames of the
    seed's pool."""
    import torch

    from harness import cells, check, driver

    rig, pool = driver.make_inputs(cell, seed, device)
    cfg = cell.config
    reference = cells.load_reference(cfg["reference"])
    stages = driver.kept_outputs(cell.traffic)
    kept = []
    for f in range(min(len(pool), int(cell.traffic["check_requests"]))):
        out = reference.reconstruct(pool[f], *rig, cfg, stages,
                                    store=torch.bfloat16)
        if "sdf_images" in out:
            out["sdf_images"] = out["sdf_images"].cpu().numpy()
        kept.append((f, out))
        del out
    readings = driver.compare(cfg, kept, pool, rig)
    return readings, check.verdict(readings, cell.limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from harness import cells, driver

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    lower, upper = {}, {}
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        run = driver.run(cell, seed, args.seconds, False, "cuda:0",
                         time.perf_counter())
        print(json.dumps({"seed": seed, "side": "program",
                          "correct": run.correct, "requests": len(run.requests),
                          "readings": run.readings,
                          "seconds": time.perf_counter() - t}), flush=True)
        for k, v in run.readings.items():
            lower[k] = max(lower.get(k, 0.0), v)
        del run
        torch.cuda.empty_cache()
        if i < args.control_seeds:
            t = time.perf_counter()
            readings, passed = control_readings(cell, seed, "cuda:0")
            print(json.dumps({"seed": seed, "side": "control",
                              "correct": passed, "readings": readings,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
            for k, v in readings.items():
                upper[k] = min(upper.get(k, float("inf")), v)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

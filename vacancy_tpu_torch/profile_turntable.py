"""Where the device time of the turntable main path goes.

    python -m vacancy_tpu_torch.profile_turntable --n 512 --views 36

runs ``pipeline.run_turntable`` once to warm up, then once more under
``torch.profiler`` on one CUDA device, and prints one JSON line: the
profiled run's wall seconds, carve and extract seconds, the device time
summed over every kernel and copy, the device's idle share of the wall
time, and the device time of each kernel or copy, largest first. The
profiled run holds the warm-up carve, the timed carve and the extract.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .pipeline import run_turntable


def _device_us(ev) -> float:
    t = getattr(ev, "self_device_time_total", None)
    return float(ev.self_cuda_time_total if t is None else t)


def profile_turntable(n: int, n_views: int, device="cuda") -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the profile reads device time: it needs a CUDA "
                         "device")
    run_turntable(n=n, n_views=n_views, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_turntable(n=n, n_views=n_views, device=device)
        wall = time.perf_counter() - t0
    spans = sorted(
        ({"name": e.key, "calls": e.count, "ms": _device_us(e) / 1e3}
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r["ms"],
    )
    device_s = sum(r["ms"] for r in spans) / 1e3
    return {
        "grid": res["grid"], "views": n_views, "device": res["device"],
        "wall_s": wall, "carve_s": res["carve_s"],
        "extract_s": res["extract_s"], "device_s": device_s,
        "idle_share": 1.0 - device_s / wall, "spans": spans,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="vacancy_tpu_torch.profile_turntable")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--views", type=int, default=36)
    args = p.parse_args(argv)
    out = profile_turntable(args.n, args.views)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

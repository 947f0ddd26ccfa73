"""Where the device time of the turntable main path, or of the facade at
capture resolution, goes.

    python -m vacancy_tpu_torch.profile_turntable --n 512 --views 36
    python -m vacancy_tpu_torch.profile_turntable --n 512 --views 36 --facade
    python -m vacancy_tpu_torch.profile_turntable --n 1024 --views 100 --sweep

The first runs ``pipeline.run_turntable`` once to warm up, then once more
under ``torch.profiler``; the profiled run holds the warm-up carve, the
timed carve and the extract. With ``--facade`` it builds a
``VoxelCarver`` on the same n^3 grid (``pipeline.facade_inputs``: WAVG,
band 0.05, bilinear), runs ``carve_batch(engine="warp")`` of ``--views``
silhouettes of 3840 x 2160 (4K UHD) once to warm up, resets the grid,
and profiles one more ``carve_batch`` ending in a synchronize. With
``--sweep`` it runs ``pipeline.run_sweep`` once to warm up and once more
under the profiler (a cold and a warm z-chunked carve, two extracts). Each
prints one JSON line on one CUDA device: the profiled run's wall
seconds, the device time summed over every kernel and copy, the device's
idle share of the wall time, and the device time of each kernel or copy,
largest first.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .carver import VoxelCarver
from .pipeline import facade_inputs, run_sweep, run_turntable


def _device_us(ev) -> float:
    t = getattr(ev, "self_device_time_total", None)
    return float(ev.self_cuda_time_total if t is None else t)


def _profiled(fn, device: torch.device):
    """(fn's result, wall seconds, spans) of one ``fn()`` under the
    profiler, ending in a device synchronize."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    spans = sorted(
        ({"name": e.key, "calls": e.count, "ms": _device_us(e) / 1e3}
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r["ms"],
    )
    return res, wall, spans


def _summary(wall: float, spans) -> dict:
    device_s = sum(r["ms"] for r in spans) / 1e3
    return {"wall_s": wall, "device_s": device_s,
            "idle_share": 1.0 - device_s / wall, "spans": spans}


def _cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the profile reads device time: it needs a CUDA "
                         "device")
    return device


def profile_turntable(n: int, n_views: int, device="cuda") -> dict:
    device = _cuda(device)
    run_turntable(n=n, n_views=n_views, device=device)
    res, wall, spans = _profiled(
        lambda: run_turntable(n=n, n_views=n_views, device=device), device)
    return {"grid": res["grid"], "views": n_views, "device": res["device"],
            "carve_s": res["carve_s"], "extract_s": res["extract_s"],
            **_summary(wall, spans)}


def profile_sweep(n: int, n_views: int, device="cuda") -> dict:
    device = _cuda(device)
    run_sweep(n=n, n_views=n_views, device=device)
    res, wall, spans = _profiled(
        lambda: run_sweep(n=n, n_views=n_views, device=device), device)
    return {"grid": res["grid"], "views": n_views, "device": res["device"],
            "carve_s": res["carve_s"], "extract_s": res["extract_s"],
            **_summary(wall, spans)}


def profile_facade(n: int, n_views: int, width: int, height: int,
                   device="cuda") -> dict:
    device = _cuda(device)
    opt, cams, masks = facade_inputs(n, n_views, width, height, device)
    carver = VoxelCarver(opt, device)
    carver.init()
    carver.carve_batch(cams, masks, engine="warp")
    torch.cuda.synchronize(device)
    carver.init()
    _, wall, spans = _profiled(
        lambda: carver.carve_batch(cams, masks, engine="warp"), device)
    return {"grid": list(carver.grid.shape_zyx), "views": n_views,
            "image": [height, width],
            "device": torch.cuda.get_device_name(device),
            **_summary(wall, spans)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="vacancy_tpu_torch.profile_turntable")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--views", type=int, default=36)
    p.add_argument("--facade", action="store_true",
                   help="profile one VoxelCarver.carve_batch(engine='warp')")
    p.add_argument("--sweep", action="store_true",
                   help="profile pipeline.run_sweep (the z-chunked carve)")
    args = p.parse_args(argv)
    if args.facade and args.sweep:
        p.error("--facade and --sweep are two profiles: pass one")
    if args.facade:
        out = profile_facade(args.n, args.views, 3840, 2160)
    elif args.sweep:
        out = profile_sweep(args.n, args.views)
    else:
        out = profile_turntable(args.n, args.views)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

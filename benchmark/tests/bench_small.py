"""A cell of the benchmark cut to a size the CPU runs in a second."""

import copy

from harness import cells


def small_cell(n=32, views=6, width=64, height=48, name="qvga36-512.frames",
               root=cells.ROOT):
    """The cell ``name`` (under ``root``) at an ``n``^3 grid and
    ``views`` views of ``width`` x ``height``, with a pool of three
    frames."""
    cell = cells.load_cell(name, root=root)
    cfg = copy.deepcopy(cell.config)
    res = 2.2 / n
    cfg["grid"] = {"n": n, "bb_min": [-1.1] * 3,
                   "bb_max": [-1.1 + (n + 0.4) * res] * 3, "resolution": res}
    cfg["rig"].update(views=views, width=width, height=height)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, pool_frames=3, warm_requests=1,
                        check_requests=2)
    return cell

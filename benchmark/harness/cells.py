"""Cells as data: every configuration, traffic mix, cell and metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it.

    <root>/configs/<config>.json        a deployment: grid, rig (a layout
                                        of ``scene.LAYOUTS``), update
                                        rule, and the reference it names
    <root>/traffic/<mix>.json           a traffic mix: the pool of frames,
                                        the facade calls of a request
    <root>/reference/<name>.py          a plain reference (``reconstruct``)
    <root>/workloads/<cell>.json        config, traffic, chips, why, limits
    <root>/end_to_end/<metric>.py       a reader of an end-to-end metric
    <root>/layer_metrics/<metric>.py    a reader of a per-layer metric

A reader module defines ``read(run)`` and returns a number, or None when
the run holds nothing for it to read (the metric is then left out).
"""

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, Optional

from . import scene

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]  # each compared number and its limit


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a name")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic mix; raises
    ``ValueError`` where the configuration's rig is not one that
    ``scene.rig`` lays out."""
    w = _json(root / "workloads" / f"{_name('cell', name)}.json")
    config = _json(root / "configs" / f"{_name('config', w['config'])}.json")
    scene.check_rig(config["rig"])
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=_json(root / "traffic" / f"{_name('traffic', w['traffic'])}.json"),
        limits={k: float(v) for k, v in w["limits"].items()},
    )


def load_reader(kind: str, name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``<root>/<kind>/<name>.py``."""
    path = root / kind / f"{_name('metric', name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_reference(name: str):
    """The reference module ``reference.<name>``: the benchmark's folder
    is on the import path, and ``reference`` is a package there."""
    if not name.isidentifier():
        raise ValueError(f"reference name {name!r} is not a module name")
    return importlib.import_module(f"reference.{name}")


def metrics_of(cell: str, section: str,
               benchmark: Optional[dict] = None) -> Dict[str, dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that
    ``cell`` reports: those whose ``workloads`` name it, and those with
    no ``workloads`` key."""
    if benchmark is None:
        benchmark = _json(ROOT.parent / "BENCHMARK.json")
    return {m["name"]: m for m in benchmark[section]
            if cell in m.get("workloads", [cell])}

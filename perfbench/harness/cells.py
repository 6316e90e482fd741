"""A cell's files, found by the names in BENCHMARK.json: its configuration
(`perfbench/configs/<config>.json`), its traffic mix
(`perfbench/traffic/<traffic>.json`), its correctness limits
(`perfbench/limits/<workload>.json`) and the metrics it reports; and the
modules that a configuration or a metric names (`module`)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PERFBENCH = os.path.join(ROOT, "perfbench")


def module(folder: str, name: str, root: str = PERFBENCH):
    """The module `<root>/<folder>/<name>.py`, loaded from its path as
    `perfbench.<folder>.<name>`, so that its relative imports resolve in the
    package: a head kind (`reference/heads`), a kernel of a launch plan
    (`kernels`) or a per-layer metric's reader (`metrics`).
    FileNotFoundError naming the path where there is no such file."""
    path = os.path.join(root, folder, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"perfbench: no file {path} for "
                                f"{folder} {name!r}")
    spec = importlib.util.spec_from_file_location(
        ".".join(["perfbench", *folder.split("/"),
                  name.replace(".", "_").replace("-", "_")]), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload`; KeyError naming the known cells when
    BENCHMARK.json has no such cell."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return _cell(workload, w["config"], w["traffic"], int(w["chips"]),
                 os.path.join(root, configs[w["config"]]["file"]), root,
                 [m for m in bench["end_to_end"] if _reports(m, workload)],
                 [m for m in bench["per_layer"] if _reports(m, workload)])


def from_files(workload: str, root: str = ROOT) -> Cell:
    """A cell from its files alone, named `<config>-<traffic>` (a cell whose
    files are kept for a later PR, and not in BENCHMARK.json), with no
    metrics: for the tests and the readings."""
    config, traffic = workload.split("-", 1)
    pb = os.path.join(root, "perfbench")
    chips = int(_load(os.path.join(pb, "traffic", traffic + ".json")).get(
        "ranks", 1))
    return _cell(workload, config, traffic, chips,
                 os.path.join(pb, "configs", config + ".json"), root, [], [])


def _cell(workload, config, traffic, chips, config_file, root, end_to_end,
          per_layer) -> Cell:
    pb = os.path.join(root, "perfbench")
    return Cell(
        name=workload, chips=chips, config_name=config, traffic_name=traffic,
        config=_load(config_file),
        traffic=_load(os.path.join(pb, "traffic", traffic + ".json")),
        limits=_load(os.path.join(pb, "limits", workload + ".json")),
        end_to_end=end_to_end, per_layer=per_layer)

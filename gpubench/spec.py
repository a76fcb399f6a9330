"""What a cell is, found by name from ``BENCHMARK.json``.

A cell ``<config>.<mix>`` is one entry of ``workloads``.  Its parts are
files found by name, so that a new cell or metric is new files and
entries, and no edit of a file that is there:

  configs/<config>.json   the model configuration as run (``hparams``: every
                          field of the program's Config), its source and
                          what was assumed
  traffic/<mix>.json      the traffic mix: a ``kind`` (train, batch_synth,
                          utterance; each a driver in ``drivers/``), its
                          parameters, and ``hparams`` it sets for the
                          program (batch budgets, the decode path)
  limits/<cell>.json      the limit of each number the correctness check
                          compares, with the readings it was set from
  metrics/<metric>.py     one reader per per-layer metric: ``read(r)`` of
                          a ``readers.Readings``, a number or None
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict            # configs/<config>.json
    mix: dict               # traffic/<mix>.json
    limits: dict            # limits/<cell>.json ("limits": {number: limit})
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict = field(default_factory=dict)   # per-layer name -> read

    @property
    def hparams(self) -> dict:
        """The program's Config values: the configuration's, then the
        mix's."""
        return {**self.config["hparams"], **self.mix.get("hparams", {})}


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_reader(name: str, base: Path = HERE):
    path = base / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(root: Path, name: str, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json; raises KeyError for a
    name it does not list."""
    bench = load_json(Path(root) / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError("BENCHMARK.json lists no workload %r (it has %s)"
                       % (name, ", ".join(sorted(work))))
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(Path(root) / configs[w["config"]]["file"])
    mix = load_json(base / "traffic" / (w["traffic"] + ".json"))
    limits_path = base / "limits" / (name + ".json")
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    cell = Cell(name, config, mix, limits, e2e, per_layer)
    cell.readers = {m["name"]: load_reader(m["name"], base)
                    for m in per_layer}
    return cell

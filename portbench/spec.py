"""What a run reads: BENCHMARK.json, and the files of its cell, each found
by name.

- configs/<config>.json: the configuration as it is run: `config`, the
  program's whole configuration (data, model, train, live), `arch`, the
  sizes the reference model takes, `reference`, the reference model's
  name, and the source, `reduced` and `assumed`.
- traffic/<traffic>.json: the traffic mix, parameters that the module
  named by its `mode` key reads (modes/<mode>.py).
- limits/<workload>.json: the limit of each number that `correct`
  compares, with the readings it was set from.
- metrics/<metric>.py: the reader of each per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read(kind, name):
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                     f"{[w['name'] for w in bench['workloads']]}")


def config(name):
    return _read("configs", name)


def traffic(name):
    return _read("traffic", name)


def limits(workload_name):
    return _read("limits", workload_name)


def mode(traffic_spec: dict):
    return importlib.import_module(f"portbench.modes.{traffic_spec['mode']}")


def metrics_for(bench: dict, cell: str, section: str):
    """The metrics of `section` that `cell` reports: those that list it, or
    that list no cell and move an end-to-end metric it reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(metric_name: str):
    """The `read(ctx)` function of metrics/<metric_name>.py."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric_name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def program_config(config_spec: dict, run_overrides: dict):
    """The program's Config from the file's `config`, with the run's
    overrides ({"data.data_dir": ..., ...}) applied."""
    import dataclasses

    from ann3depth_tpu_torch import config as cfglib

    sections = {}
    for section, cls in (("data", cfglib.DataConfig),
                         ("model", cfglib.ModelConfig),
                         ("train", cfglib.TrainConfig),
                         ("live", cfglib.LiveConfig)):
        values = dict(config_spec["config"][section])
        for key, v in run_overrides.items():
            sec, field = key.split(".")
            if sec == section:
                values[field] = v
        for f in dataclasses.fields(cls):
            if isinstance(values.get(f.name), list):
                values[f.name] = tuple(values[f.name])
        sections[section] = cls(**values)
    return cfglib.Config(**sections)

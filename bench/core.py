"""What one cell is made of, found by name.

``BENCHMARK.json`` names the cell's configuration, traffic mix and
metrics; each is a file of its own under ``bench/``:

    configs/<config>.json    the configuration as it is run (its ``run``)
    mixes/<traffic>.json     the traffic's parameters and its ``loop``
    loops/<loop>.py          the generator and runner of that loop kind
    reference/<family>.py    the plain float32 reference of the family
    flops/<family>.py        the family's model flops
    metrics/<metric>.py      one reader per metric
    roofline/<kernel>.py     a kernel entry's operations and bytes
    limits/<cell>.json       the numbers ``correct`` compares, and limits

A name with no file is an error. A later cell adds files; none of these
needs an edit for it.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class UnknownName(LookupError):
    pass


def find(kind: str, name: str, suffix: str, dirs=(BENCH,)) -> Path:
    for d in dirs:
        path = Path(d) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise UnknownName(f"no {kind[:-1] if kind.endswith('s') else kind} "
                      f"named {name!r} (looked for {kind}/{name}{suffix} "
                      f"under {', '.join(str(d) for d in dirs)})")


def load_json(kind, name, dirs=(BENCH,)) -> dict:
    return json.loads(find(kind, name, ".json", dirs).read_text())


_modules = {}


def load_module(kind, name, dirs=(BENCH,)):
    """The module ``<kind>/<name>.py`` (loaded once a process)."""
    path = find(kind, name, ".py", dirs)
    if path not in _modules:
        mod_name = "bench_" + "_".join(
            "".join(ch if ch.isalnum() else "_" for ch in part)
            for part in (kind, name))
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _modules[path] = module
    return _modules[path]


def load_spec(root=ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


class Cell:
    """One workload of a spec, with its configuration, mix, limits and
    metrics loaded."""

    def __init__(self, spec: dict, name: str, root=ROOT, dirs=(BENCH,)):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise UnknownName(f"no workload named {name!r} in the spec "
                              f"(it has {', '.join(sorted(cells))})")
        self.name, self.entry, self.dirs = name, cells[name], dirs
        configs = {c["name"]: c for c in spec["configs"]}
        if self.entry["config"] not in configs:
            raise UnknownName(f"no configuration named "
                              f"{self.entry['config']!r} in the spec")
        self.config = json.loads(
            (Path(root) / configs[self.entry["config"]]["file"]).read_text())
        self.run = dict(self.config["run"])
        self.mix = load_json("mixes", self.entry["traffic"], dirs)
        self.limits = load_json("limits", name, dirs)
        self.chips = self.entry["chips"]

        def applies(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if applies(m)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m)]

    def module(self, kind, name):
        return load_module(kind, name, self.dirs)

    @property
    def family(self):
        return self.run["family"]

    def metrics(self, traced: bool):
        return self.per_layer if traced else self.end_to_end

"""What one cell is, found by name from ``BENCHMARK.json``.

A cell names a configuration and a traffic mix. Each has a data file of
its own: ``configs/<config>.json`` (the file ``BENCHMARK.json`` names),
``traffic/<traffic>.json``, ``workloads/<cell>.json`` (the limits of the
comparison that decides ``correct``), and one reader
``metrics/<metric>.py`` for every per-layer metric the cell reports. A
later cell, configuration, mix or metric is a new file; no file here names
one. A configuration or mix file states its own cut for the CPU tests under
``cpu_cut``, which the harness checks and never applies.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CONFIG_KEYS = {"n_train": int, "n_test": int, "d": int, "sparsity": float, "lam": float,
               "class_balance": float, "label_noise": float, "storage": str}
TRAFFIC_KEYS = {"m": int, "batch_size": int, "gossip_rounds": int, "topology": str,
                "segment_iters": int, "warmup_segments": int}
TOPOLOGIES = ("random", "exponential")
# the keys a file's "cpu_cut" may replace (the tests' small_root applies it)
CONFIG_CUT_KEYS = set(CONFIG_KEYS) | {"col_skew"}
TRAFFIC_CUT_KEYS = set(TRAFFIC_KEYS)


class SpecError(ValueError):
    """A benchmark file is missing or malformed."""


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the cell's end-to-end metric entries
    per_layer: list    # the cell's per-layer metric entries
    readers: dict      # per-layer metric name -> read(ctx)


def _json(path: Path) -> dict:
    try:
        data = json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"missing {path}") from None
    except json.JSONDecodeError as e:
        raise SpecError(f"{path} is not JSON: {e}") from None
    if not isinstance(data, dict):
        raise SpecError(f"{path} must hold a JSON object")
    return data


def _typed(data: dict, keys: dict, where: str) -> None:
    for key, kind in keys.items():
        value = data.get(key)
        if isinstance(value, bool) or not isinstance(value, (int, float) if kind is float else kind):
            raise SpecError(f"{where}: {key!r} must be a {kind.__name__}, got {value!r}")


def _check_cut(data: dict, known: set, where: str) -> None:
    cut = data.get("cpu_cut")
    if cut is not None and not (isinstance(cut, dict) and set(cut) <= known):
        raise SpecError(f"{where}: 'cpu_cut' must be an object of keys among {sorted(known)}")


def check_config(cfg: dict, where: str) -> dict:
    _typed(cfg, CONFIG_KEYS, where)
    _check_cut(cfg, CONFIG_CUT_KEYS, where)
    if cfg["storage"] not in ("dense", "ell"):
        raise SpecError(f"{where}: storage must be 'dense' or 'ell'")
    if not (0 < cfg["sparsity"] <= 1 and cfg["lam"] > 0 and 0 < cfg["class_balance"] < 1
            and 0 <= cfg["label_noise"] < 0.5 and cfg["n_train"] > 0 and cfg["n_test"] > 0
            and cfg["d"] > 0 and cfg.get("col_skew", 0.0) >= 0):
        raise SpecError(f"{where}: a size, share or lambda is out of range")
    return cfg


def check_traffic(tr: dict, where: str) -> dict:
    _typed(tr, TRAFFIC_KEYS, where)
    _check_cut(tr, TRAFFIC_CUT_KEYS, where)
    if tr["topology"] not in TOPOLOGIES:
        raise SpecError(f"{where}: topology must be one of {TOPOLOGIES}")
    if min(tr["m"], tr["batch_size"], tr["gossip_rounds"], tr["segment_iters"],
           tr["warmup_segments"]) < 1:
        raise SpecError(f"{where}: m, batch_size, gossip_rounds, segment_iters and "
                        "warmup_segments must be at least 1")
    faults = tr.get("faults")
    if faults is not None:
        if not (isinstance(faults, dict) and faults.get("drop") in ("link", "message")
                and isinstance(faults.get("drop_prob"), (int, float))
                and 0 <= faults["drop_prob"] < 1
                and all(isinstance(n, int) and 0 <= n < tr["m"]
                        for n in faults.get("dead_nodes", []))):
            raise SpecError(f"{where}: faults need drop 'link' or 'message', drop_prob in "
                            "[0, 1) and dead_nodes among the m nodes")
    return tr


def load_reader(name: str, root: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path} for the per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise SpecError(f"{path} defines no read(ctx)")
    return module.read


def load(workload: str, root: Path | None = None) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with all its files;
    raises :class:`SpecError` for anything missing or malformed."""
    root = HERE.parent if root is None else Path(root)
    here = root / HERE.name
    bench = _json(root / "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        if not isinstance(bench.get(key), list):
            raise SpecError(f"BENCHMARK.json: {key!r} must be a list")
    cells = {w.get("name"): w for w in bench["workloads"]}
    if workload not in cells or not NAME.match(workload):
        raise SpecError(f"BENCHMARK.json has no workload {workload!r}")
    w = cells[workload]
    configs = {c.get("name"): c for c in bench["configs"]}
    if w.get("config") not in configs:
        raise SpecError(f"workload {workload!r} names no known config")
    if not (isinstance(w.get("traffic"), str) and NAME.match(w["traffic"])):
        raise SpecError(f"workload {workload!r} has a malformed traffic name")
    if w.get("chips") not in (1, 4):
        raise SpecError(f"workload {workload!r}: chips must be 1 or 4")
    cfile = configs[w["config"]].get("file", "")
    if not (isinstance(cfile, str) and cfile.startswith(HERE.name + "/configs/")):
        raise SpecError(f"config {w['config']!r}: file must lie under {HERE.name}/configs/")
    config = check_config(_json(root / cfile), cfile)
    traffic = check_traffic(_json(here / "traffic" / f"{w['traffic']}.json"),
                            f"traffic/{w['traffic']}.json")
    limits = _json(here / "workloads" / f"{workload}.json").get("limits")
    if not (isinstance(limits, dict) and limits
            and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())):
        raise SpecError(f"workloads/{workload}.json: 'limits' must map numbers to limits >= 0")

    def mine(entry: dict) -> bool:
        return workload in entry.get("workloads", [workload])

    e2e = [e for e in bench["end_to_end"] if mine(e)]
    per_layer = [e for e in bench["per_layer"] if mine(e)]
    for e in e2e + per_layer:
        if not NAME.match(str(e.get("name"))):
            raise SpecError(f"malformed metric name {e.get('name')!r}")
    readers = {e["name"]: load_reader(e["name"], here) for e in per_layer}
    return Cell(workload, w["chips"], config, traffic, limits, e2e, per_layer, readers)

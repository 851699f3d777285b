"""``BENCHMARK.json`` and the files it names, found by name:
``benchmark/configs/<config>.json``, ``benchmark/traffic/<mix>.json``
and ``benchmark/metrics/<metric>.py``; the start state that a
configuration's ``carry`` names; and the program's entry that it names
(``entry``, with ``scenes``)."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench, workload):
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (it has "
                     f"{[w['name'] for w in bench['workloads']]})")


def _json(path):
    with open(path) as f:
        return json.load(f)


def config(bench, name):
    """The configuration file of configuration ``name``, as a dict."""
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def start_state(bt, config, cfg, device):
    """The all-zero carry that the configuration file names (``carry``:
    ``"PackedState"`` or ``"TemporalState"``), built by the program's own
    ``initial(cfg, device)``; ``bt`` the program's package. Raises where
    the program's step does not take that carry for ``cfg``: it takes a
    ``PackedState`` only under ``warp_mode="pallas"``."""
    carry = config["carry"]
    if carry not in ("PackedState", "TemporalState"):
        raise SystemExit(f"the configuration states a {carry!r} carry; the "
                         "program carries a PackedState or a TemporalState")
    if carry == "PackedState" and cfg.warp_mode != "pallas":
        raise SystemExit(f"the configuration states a PackedState carry "
                         f"under warp_mode={cfg.warp_mode!r}; the program's "
                         "step takes a PackedState only under "
                         "warp_mode='pallas'")
    return getattr(bt, carry).initial(cfg, device)


#: the program's entries a configuration may name, the first the default
ENTRIES = ("make_denoise_frame", "denoise_scenes_jit")


def entry(config):
    """``(entry, scenes)``: the program's entry that the configuration
    names (``entry``; without it the per-frame step,
    ``make_denoise_frame``) and the scenes S it hands the card each call
    (``scenes``, default 1; the per-frame step takes one)."""
    name = config.get("entry", ENTRIES[0])
    if name not in ENTRIES:
        raise SystemExit(f"the configuration names the entry {name!r}; the "
                         f"harness drives {ENTRIES}")
    S = config.get("scenes", 1)
    if name == "make_denoise_frame" and S != 1:
        raise SystemExit(f"make_denoise_frame steps one scene, not {S}")
    return name, S


def traffic(name):
    """The traffic file of mix ``name``, as a dict."""
    return _json(HERE / "traffic" / f"{name}.json")


def reports(metric, workload, bench):
    """Whether cell ``workload`` reports ``metric`` (a metric entry): it
    lists the cell, or lists none and its ``moves`` (or, for an
    end-to-end metric, itself) is reported there."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in bench["end_to_end"]
                     if m["name"] == metric["moves"])
        return reports(moved, workload, bench)
    return True


def end_to_end(bench, workload):
    return [m for m in bench["end_to_end"] if reports(m, workload, bench)]


def per_layer(bench, workload):
    return [m for m in bench["per_layer"] if reports(m, workload, bench)]

"""Lookup by name, the run's context, and the checks every run makes.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is a file of its own, found from the names in
``BENCHMARK.json``:

    configs/<config>.json         sizes, source, reduced, peak
    traffic/<workload>.json       {"driver": <kind>, ...its parameters}
    drivers/<kind>.py             run(ctx) -> Outcome
    layer_metrics/<metric>.py     read(ctx) -> float | None

so a later cell is a new traffic file and a new entry, and a later
metric a new reader, with no file here edited.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no run may hold once its window has closed:
# JAX and the JAX package (the port's name begins with the latter's, so
# names are compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax",
                     "attentionalpoolingaction_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each compared whole."""
    names = {m.partition(".")[0] for m in (modules or sys.modules)}
    return sorted(n for n in FORBIDDEN_MODULES if n in names)


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def find_config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def read_json(root: pathlib.Path, rel: str) -> dict:
    with open(root / rel) as f:
        return json.load(f)


def traffic_file(root: pathlib.Path, workload: str) -> pathlib.Path:
    return root / "bench_h100" / "traffic" / f"{workload}.json"


def driver_module(kind: str):
    return importlib.import_module(f"bench_h100.drivers.{kind}")


def load_reader(root: pathlib.Path, metric: str):
    """The ``read(ctx)`` of ``layer_metrics/<metric>.py`` (a name may hold
    dots, so it is loaded from its path)."""
    path = root / "bench_h100" / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_h100_layer_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` (``kind``) or ``per_layer`` metrics that
    ``workload`` reports: those that list it, and those with no list whose
    end-to-end metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e_names)]


@dataclasses.dataclass
class Check:
    """One number compared with its limit: ``ok`` when ``value <=
    limit`` (a NaN or a missing value fails)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""
    end_to_end: dict            # metric name -> value (this run's window)
    window_start: float         # time.monotonic() when the window opened
    attempted: int
    failed: int
    checks: list                # [Check]
    memory_peak_bytes: int
    device_count: int
    layer_ctx: dict = dataclasses.field(default_factory=dict)
    trace: object = None        # trace.Summary of the traced run
    notes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    """A run's inputs: the cell, its configuration and traffic, and where
    to put its files."""
    workload: dict
    config: dict                # BENCHMARK.json's entry
    config_file: dict           # configs/<config>.json
    traffic: dict               # traffic/<workload>.json
    seed: int
    seconds: float
    trace: bool
    tmpdir: str
    device: str = "cuda"
    # a tiny stand-in of the configuration for the CPU tests (the
    # TrainConfig fields it changes); empty on the chip
    shrink: dict = dataclasses.field(default_factory=dict)


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def cache_env(root: pathlib.Path = ROOT) -> None:
    """Fixed cache directories inside the checkout, so that only the first
    run of a cell there builds (the port's nvcc builds live in its own
    fixed ``_build/``)."""
    cache = root / "bench_h100" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

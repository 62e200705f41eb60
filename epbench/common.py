"""The harness's shared pieces: finding a cell's files by name, the
configuration as the port's ``ModelConfig``, the seeds, the import guard,
the caches inside the checkout, and the device record.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); the mix names its driver
(``traffic/<driver>.py``); each per-layer metric is a reader
(``metrics/<name>.py``); each cell's limits sit in ``limits/<cell>.json``.
Adding any of them is a new file and a new entry, never an edit here.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent          # epbench/
CHECKOUT = HERE.parent                          # the repository's root
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among ``sys.modules``, each compared
    whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def ensure_src_on_path() -> None:
    """Put the checkout's ``src`` (the port) on ``sys.path``; the command
    names only ``epbench/run.py``."""
    src = str(CHECKOUT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def set_cache_dirs() -> dict:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds: the port builds its kernels into
    ``build/repro_torch/<hash>`` by itself; torch's and Triton's caches go
    to ``build/epbench/``.  A library that would load JAX by itself is kept
    from it (``USE_FLAX``, ``USE_JAX``)."""
    base = CHECKOUT / "build" / "epbench"
    dirs = {"TORCH_EXTENSIONS_DIR": base / "torch_extensions",
            "TRITON_CACHE_DIR": base / "triton",
            "TORCHINDUCTOR_CACHE_DIR": base / "inductor"}
    for k, v in dirs.items():
        os.environ[k] = str(v)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    return {k: str(v) for k, v in dirs.items()}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = CHECKOUT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str, root: Path = HERE) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def traffic_file(name: str, root: Path = HERE) -> dict:
    return load_json(root / "traffic" / f"{name}.json")


def limits_file(cell: str, root: Path = HERE) -> dict:
    return load_json(root / "limits" / f"{cell}.json")


def load_module(kind: str, name: str, root: Path = HERE):
    """``<root>/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so the file is loaded by its path)."""
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"epbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of_cell(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those that list it under ``workloads``, and those without the key."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def mix_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of draws (a weight group, a cycle's
    prompts, a step's batch) of run seed ``seed``: every stream is fixed by
    the seed alone, whatever else the run draws."""
    return (int(seed) * 1_000_003 + int(stream) * 7_919 + 17) % (2 ** 63 - 1)


def model_config(conf: dict, traffic: dict):
    """The port's ``ModelConfig`` as the configuration file states it
    (its ``port`` block), with what the traffic mix sets: the depth a cell
    cuts to (``layers``), the wire, the capacity factors."""
    import dataclasses

    from repro_torch.configs.base import ModelConfig, MoEConfig
    port = dict(conf["port"])
    moe = dict(port.pop("moe"))
    moe["wire_dtype"] = traffic.get("wire_dtype", "fp32")
    for k in ("capacity_factor", "ll_capacity_factor"):
        if k in traffic:
            moe[k] = traffic[k]
    cfg = ModelConfig(family="moe", moe=MoEConfig(**moe), **port)
    if "layers" in traffic:
        cfg = dataclasses.replace(cfg, n_layers=traffic["layers"])
    return cfg


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0..1) of ``values`` by the nearest rank: the
    smallest value with at least a share ``q`` of the values at or below
    it."""
    v = sorted(values)
    if not v:
        raise ValueError("quantile of nothing")
    k = min(len(v), max(1, math.ceil(q * len(v) - 1e-9))) - 1
    return float(v[k])

"""A cell by name: its workload, configuration and traffic files, the
port's configuration objects built from them, and its pool.

``workloads/<cell>.json`` names ``config`` and ``traffic`` and holds the
cell's ``batch`` (clips a step), ``threads`` (host threads), ``limits``
(of each number ``checks.py`` compares) and ``why``;
``configs/<config>.json`` holds ``model`` (the port's ``ModelConfig``
fields) and ``data`` (the pool generator's parameters and each split's
clips); ``traffic/<traffic>.json`` holds ``kind`` (the module
``kinds/<kind>.py`` that drives and judges it), ``split`` and the
``train`` and ``rl`` settings.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from benchmark import corpus

ROOT = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def manifest() -> dict:
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


class Cell:
    def __init__(self, name: str, overrides: dict | None = None):
        """``overrides``: ``{"model": {...}, "data": {...}, "workload":
        {...}}`` merged over the files (the tests' tiny sizes)."""
        o = overrides or {}
        self.name = name
        self.workload = {**load("workloads", name), **o.get("workload", {})}
        conf = load("configs", self.workload["config"])
        self.model = {**conf["model"], **o.get("model", {})}
        self.data = {**conf["data"], **o.get("data", {})}
        self.traffic = load("traffic", self.workload["traffic"])
        self.kind = self.traffic["kind"]
        self.batch = int(self.workload["batch"])
        self.threads = int(self.workload["threads"])

    def model_config(self):
        from cst_captioning_tpu_torch.config import ModelConfig

        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        kw = {k: v for k, v in self.model.items() if k in fields}
        kw["modalities"] = tuple((str(n), int(d))
                                 for n, d in self.model["modalities"])
        return ModelConfig(**kw)

    def section(self, cls_name: str, key: str):
        from cst_captioning_tpu_torch import config

        return getattr(config, cls_name)(**self.traffic.get(key, {}))

    def rl_config(self):
        rl = self.section("RLConfig", "rl")
        return dataclasses.replace(rl, reward_threads=self.threads)

    def pool(self) -> Path:
        split = self.traffic["split"]
        params = corpus.pool_params(self.model, self.data,
                                    int(self.data[f"{split}_clips"]), split)
        return corpus.ensure_pool(params)

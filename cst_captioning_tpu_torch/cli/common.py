"""Shared CLI plumbing: presets, typed ``--set`` overrides and the dataset
(the JAX package's ``cli/common.py``). ``--feature NAME=PATH`` names the
port's ``<modality>.npy`` feature files (``data/dataset.py``); a JAX-era
h5 file converts with ``data.convert_h5_features``."""

from __future__ import annotations

import argparse
import ast

from cst_captioning_tpu_torch.config import ExperimentConfig
from cst_captioning_tpu_torch.data.dataset import CaptionDataset
from cst_captioning_tpu_torch.presets import get_experiment


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", required=True, help="named experiment preset")
    p.add_argument("--info-json", default="", help="dataset info.json path")
    p.add_argument(
        "--feature", action="append", default=[], metavar="NAME=PATH",
        help="modality feature file (<modality>.npy), repeatable "
             "(e.g. resnet=feats/resnet.npy)")
    p.add_argument(
        "--set", action="append", default=[],
        metavar="SECTION__FIELD=VALUE",
        help="config override, repeatable (e.g. train__epochs=10)")
    p.add_argument("--log-jsonl", default="",
                   help="structured event log path")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write torch.profiler Chrome traces of training "
                        "steps under DIR (sets train.profile_dir)")
    p.add_argument("--obs", default="", metavar="DIR",
                   help="enable the observability subsystem and write the "
                        "run's events.jsonl / trace.json / metrics.prom to "
                        "DIR (sets train.obs + train.obs_dir; report with "
                        "`python -m cst_captioning_tpu_torch.cli.obs_report "
                        "DIR`)")
    p.add_argument("--dist-init", default=None, metavar="URL",
                   help="torch.distributed init URL (e.g. file:///tmp/x) "
                        "with RANK / WORLD_SIZE from the env; default: the "
                        "launcher's env:// (MASTER_ADDR / MASTER_PORT)")
    # the JAX CLI's flag: sets train.debug_nans (the Trainer's anomaly
    # mode and forward NaN hooks)
    p.add_argument("--debug-nans", action="store_true",
                   help="NaN sanitizer: raise at the first non-finite "
                        "module output or backward op")


def parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise SystemExit(
                f"--set expects SECTION__FIELD=VALUE, got {pair!r}")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw  # a plain string
    return out


def load_config(args: argparse.Namespace) -> ExperimentConfig:
    cfg = get_experiment(args.preset)
    overrides = parse_overrides(args.set)
    if getattr(args, "profile", ""):
        overrides["train__profile_dir"] = args.profile
    if getattr(args, "obs", ""):
        overrides["train__obs"] = True
        overrides["train__obs_dir"] = args.obs
    if getattr(args, "debug_nans", False):
        overrides["train__debug_nans"] = True
    if overrides:
        cfg = cfg.override(**overrides)
    return cfg


def feature_map(args: argparse.Namespace) -> dict[str, str]:
    out = {}
    for pair in args.feature:
        name, sep, path = pair.partition("=")
        if not sep:
            raise SystemExit(f"--feature expects NAME=PATH, got {pair!r}")
        out[name] = path
    return out


def open_dataset(args: argparse.Namespace, cfg: ExperimentConfig,
                 split: str) -> CaptionDataset:
    if not args.info_json:
        raise SystemExit("--info-json is required")
    feats = feature_map(args)
    names = [n for n, _ in cfg.model.modalities]
    missing = [n for n in names if n not in feats]
    if missing:
        raise SystemExit(
            f"preset {cfg.name!r} needs --feature for modalities: {missing}")
    return CaptionDataset(
        args.info_json, {n: feats[n] for n in names}, split=split,
        max_frames=cfg.model.max_frames,
        consensus_weights=cfg.data.consensus_weights,
        cache_features=cfg.data.cache_features)

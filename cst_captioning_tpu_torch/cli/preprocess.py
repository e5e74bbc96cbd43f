"""Preprocessing CLI: a captions json -> ``info.json``, the CIDEr df and
the WXE consensus weights, in the port's formats.

    python -m cst_captioning_tpu_torch.cli.preprocess \\
        --captions captions.json --out-dir data/

The captions json:

    {"videos": [{"id": "video0", "split": "train",
                 "captions": ["a man is cooking", ...]}, ...]}

The df (``cider_df.npz``) and the weights (``consensus_weights.npz``)
come from the train split; the weights use that df.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from cst_captioning_tpu_torch.data.preprocess import (
    build_info_json,
    compute_cider_df,
    compute_consensus_weights,
    tokenize_captions,
)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--captions", required=True, help="raw captions json")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--min-count", type=int, default=1, help="vocab threshold")
    args = p.parse_args(argv)

    with open(args.captions) as f:
        raw = json.load(f)
    caps = {v["id"]: v["captions"] for v in raw["videos"]}
    splits = {v["id"]: v.get("split", "train") for v in raw["videos"]}
    os.makedirs(args.out_dir, exist_ok=True)

    build_info_json(os.path.join(args.out_dir, "info.json"), caps, splits,
                    min_count=args.min_count)
    tokenized = tokenize_captions(
        {vid: c for vid, c in caps.items() if splits[vid] == "train"})
    df = compute_cider_df(tokenized)
    df.save(os.path.join(args.out_dir, "cider_df.npz"))
    weights = compute_consensus_weights(tokenized, df=df)
    np.savez(os.path.join(args.out_dir, "consensus_weights.npz"), **weights)
    print(f"wrote info.json, cider_df.npz, consensus_weights.npz to "
          f"{args.out_dir}")


if __name__ == "__main__":
    main()

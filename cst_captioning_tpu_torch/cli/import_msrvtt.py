"""MSR-VTT import CLI: the standard distribution -> the port's dataset
files.

    python -m cst_captioning_tpu_torch.cli.import_msrvtt \\
        --videodatainfo videodatainfo.json --out-dir data/msrvtt \\
        --feature resnet=/path/to/resnet_feats.h5 \\
        --feature c3d=/path/to/c3d_npy_dir

A feature source is a directory of ``<video_id>.npy`` arrays or an h5
file keyed by video id. Prints the written paths as JSON; the output
trains as it is:

    python -m cst_captioning_tpu_torch.cli.train --preset msrvtt_xe_attention \\
        --info-json data/msrvtt/info.json \\
        --feature resnet=data/msrvtt/resnet.npy \\
        --feature c3d=data/msrvtt/c3d.npy \\
        --set "data__cider_df='data/msrvtt/cider_df.npz'"
"""

from __future__ import annotations

import argparse
import json

from cst_captioning_tpu_torch.cli.common import feature_map
from cst_captioning_tpu_torch.data.importers import import_msrvtt


def main(argv: list[str] | None = None) -> dict[str, str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--videodatainfo", required=True,
                   help="MSR-VTT videodatainfo.json")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--feature", action="append", default=[],
                   metavar="NAME=SOURCE",
                   help="modality source (h5 keyed by video id, or dir of "
                        "<vid>.npy)")
    p.add_argument("--min-word-count", type=int, default=2)
    p.add_argument("--no-weights", action="store_true",
                   help="skip consensus (WXE) weight computation")
    p.add_argument("--no-df", action="store_true",
                   help="skip CIDEr df computation")
    args = p.parse_args(argv)
    paths = import_msrvtt(
        args.videodatainfo, args.out_dir, features=feature_map(args),
        min_word_count=args.min_word_count,
        write_consensus_weights=not args.no_weights,
        write_cider_df=not args.no_df)
    print(json.dumps(paths, indent=2))
    return paths


if __name__ == "__main__":
    main()

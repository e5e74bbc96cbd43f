"""MSVD import CLI: the standard distribution -> the port's dataset files.

    python -m cst_captioning_tpu_torch.cli.import_msvd \\
        --corpus video_corpus.csv --mapping youtube_mapping.txt \\
        --out-dir data/msvd --feature resnet=/path/to/resnet_npy_dir

``--corpus`` is the MSR Video Description Corpus CSV (``VideoID, Start,
End, ..., Language, Description``; English rows only) or a plain-text
``<clip_id> <caption>``-a-line file. ``--mapping`` (optional) is
``youtube_mapping.txt``, which fixes the canonical 1970-clip order; the
split is then 1200 train / 100 val / 670 test (``--n-train`` /
``--n-val`` change it). Prints the written paths as JSON; the output
trains as it is:

    python -m cst_captioning_tpu_torch.cli.train --preset msvd_xe_meanpool \\
        --info-json data/msvd/info.json --feature resnet=data/msvd/resnet.npy
"""

from __future__ import annotations

import argparse
import json

from cst_captioning_tpu_torch.cli.common import feature_map
from cst_captioning_tpu_torch.data.importers import (
    MSVD_NUM_TRAIN,
    MSVD_NUM_VAL,
    import_msvd,
)


def main(argv: list[str] | None = None) -> dict[str, str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus", required=True,
                   help="MSVD caption csv or '<clip_id> <caption>' text file")
    p.add_argument("--mapping", default=None,
                   help="youtube_mapping.txt ('<clip_id> vid<N>' per line)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--feature", action="append", default=[],
                   metavar="NAME=SOURCE",
                   help="modality source (h5 keyed by clip id, or dir of "
                        "<clip_id>.npy)")
    p.add_argument("--n-train", type=int, default=MSVD_NUM_TRAIN)
    p.add_argument("--n-val", type=int, default=MSVD_NUM_VAL)
    p.add_argument("--min-word-count", type=int, default=2)
    p.add_argument("--no-weights", action="store_true",
                   help="skip consensus (WXE) weight computation")
    p.add_argument("--no-df", action="store_true",
                   help="skip CIDEr df computation")
    args = p.parse_args(argv)
    paths = import_msvd(
        args.corpus, args.out_dir, mapping=args.mapping,
        features=feature_map(args), n_train=args.n_train, n_val=args.n_val,
        min_word_count=args.min_word_count,
        write_consensus_weights=not args.no_weights,
        write_cider_df=not args.no_df)
    print(json.dumps(paths, indent=2))
    return paths


if __name__ == "__main__":
    main()

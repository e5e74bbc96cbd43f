"""The port's parameter-name contract for its partition-rule tables.

``shardings_contract.json`` beside this module lists the ``/``-joined JAX
paths (``train.mesh.param_path_names``) of the presets' models; GL007 and
GL018 hold ``train/mesh.py``'s ``PARAM_PARTITION_RULES`` and
``MP_PARAM_PARTITION_RULES`` against it without building a model.

    python -m cst_captioning_tpu_torch.tools.graftlint.contract [--write]

Default mode regenerates the names and compares (exit 1 on a drift);
``--write`` rewrites the file after a model refactor. Building the models
needs torch (imported here only, inside the functions: the lint itself
never imports it). Widths are cut to a few units: the names do not depend
on them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

CONTRACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "shardings_contract.json")


def contract_param_names() -> list[str]:
    """The union of the presets' models' parameter paths."""
    from cst_captioning_tpu_torch.models import CaptionModel
    from cst_captioning_tpu_torch.presets import PRESETS
    from cst_captioning_tpu_torch.train.mesh import param_path_names

    names: set[str] = set()
    for cfg in PRESETS.values():
        small = dataclasses.replace(
            cfg, vocab_size=16, d_embed=4, d_hidden=4, d_att=4,
            modalities=tuple((n, 4) for n, _ in cfg.modalities),
            dtype="float32")
        names.update(param_path_names(CaptionModel(small, device="cpu")))
    return sorted(names)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="graftlint_torch.contract",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the contract instead of comparing")
    args = ap.parse_args(argv)
    names = contract_param_names()
    if args.write:
        with open(CONTRACT, "w", encoding="utf-8") as f:
            json.dump({"comment": (
                "Parameter paths of the port's presets' models "
                "(train.mesh.param_path_names), the names the port's "
                "PARAM_PARTITION_RULES and MP_PARAM_PARTITION_RULES were "
                "written against; read by graftlint GL007/GL018. "
                "Regenerate with `python -m "
                "cst_captioning_tpu_torch.tools.graftlint.contract "
                "--write`."), "params": names}, f, indent=2)
            f.write("\n")
        return 0
    with open(CONTRACT, encoding="utf-8") as f:
        recorded = json.load(f)["params"]
    if recorded != names:
        added = sorted(set(names) - set(recorded))
        gone = sorted(set(recorded) - set(names))
        print(f"contract drift: new {added}, gone {gone} — rerun with "
              "--write after checking the rule tables", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

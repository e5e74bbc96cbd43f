"""Run report CLI: phase breakdown + resilience summary from an obs run dir.

    python -m cst_captioning_tpu_torch.cli.obs_report <run_dir> [--json]
    python -m cst_captioning_tpu_torch.cli.obs_report --postmortem <bundle> [--json]
    python -m cst_captioning_tpu_torch.cli.obs_report --postmortem <run_dir> [--json]
    python -m cst_captioning_tpu_torch.cli.obs_report --postmortem <run_dir> --list

``<run_dir>`` is the directory ``train.obs_dir`` (or ``--obs``) pointed a
run at; it must contain the run's ``events.jsonl``. Prints the phase table
(per-phase totals, self-time %-of-wall-clock, mfu with its FLOPs-source tag,
p50/p95/max), the decode early-exit summary (scan depth vs the T budget),
the serving funnel + SLO burn rates, and the resilience summary (nan-skips,
rollbacks, retries). A stream the JAX package wrote renders as the JAX
package's ``cli.obs_report`` renders it.

``--postmortem`` renders flight-recorder evidence (obs/recorder.py)
instead. Pointed at a single bundle dir (it has a ``meta.json``) it renders
that bundle: manifest verification, the trip context, and the ring as a
step timeline with anomaly verdicts inline. Pointed at a run dir it renders
the latest bundle there. Bundles of several processes (``proc<k>/``) need
the fleet merge, which comes with the port's data-parallel slice: the CLI
refuses them. ``--list`` enumerates every bundle under the run dir with
its trip kind + step. Pure stdlib, no torch import.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from cst_captioning_tpu_torch.obs.report import (
    discover_bundles,
    list_bundles,
    load_postmortem,
    render_postmortem,
    render_report,
    report_run,
)


def _render_listing(rows: list[dict]) -> str:
    lines = []
    hdr = (f"{'proc':>5} {'reason':<28} {'phase':<6} {'step':>8} "
           f"{'ring':>5} {'ok':<3} bundle")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for r in rows:
        step = r["step"] if r["step"] is not None else ""
        lines.append(
            f"{r['proc']:>5} {r['reason']:<28} {r['phase'] or '':<6} "
            f"{step:>8} {r['ring_steps']:>5} "
            f"{'yes' if r['verified'] else 'NO':<3} {r['bundle']}"
        )
    return "\n".join(lines)


def _latest_bundle(run_dir: str) -> str:
    """The newest bundle of a single-process run dir."""
    found = discover_bundles(run_dir)
    if not found:
        raise FileNotFoundError(
            f"no postmortem bundles under {run_dir!r}")
    if len(found) > 1:
        raise ValueError(
            f"{run_dir!r} holds bundles of {len(found)} processes "
            f"(procs {sorted(found)}): merging them needs the fleet merge "
            "(obs/fleet.py), which is not ported yet (it comes with the "
            "data-parallel slice); pass one bundle dir, or use the JAX "
            "package's cli.obs_report")
    return next(iter(found.values()))[-1]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="obs_report",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("run_dir", nargs="?", default=None,
                   help="obs run directory (holds events.jsonl)")
    p.add_argument("--postmortem", metavar="DIR", default=None,
                   help="render a flight-recorder postmortem bundle dir, or "
                        "the latest bundle of a run dir")
    p.add_argument("--list", action="store_true", dest="list_bundles",
                   help="with --postmortem RUN_DIR: enumerate all bundles "
                        "(proc, trip kind, step, integrity)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the machine-readable report on stdout")
    args = p.parse_args(argv)
    if args.postmortem is None and args.run_dir is None:
        p.error("a run_dir (or --postmortem DIR) is required")
    if args.list_bundles and args.postmortem is None:
        p.error("--list requires --postmortem RUN_DIR")
    try:
        if args.postmortem is not None:
            if args.list_bundles:
                rows = list_bundles(args.postmortem)
                if not rows:
                    print(f"obs_report: no postmortem bundles under "
                          f"{args.postmortem!r}", file=sys.stderr)
                    return 2
                if args.as_json:
                    print(json.dumps(rows, indent=2, default=float))
                else:
                    print(_render_listing(rows))
                return 0
            bundle = args.postmortem
            if not os.path.exists(os.path.join(bundle, "meta.json")):
                bundle = _latest_bundle(bundle)
            pm = load_postmortem(bundle)
            if args.as_json:
                print(json.dumps(pm, indent=2, default=float))
            else:
                print(render_postmortem(pm))
            return 0
        report = report_run(args.run_dir)
    except (FileNotFoundError, ValueError) as e:
        print(f"obs_report: {e}", file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(report, indent=2, default=float))
    else:
        print(render_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

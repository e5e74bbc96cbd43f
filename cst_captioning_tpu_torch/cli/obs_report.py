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
step timeline with anomaly verdicts inline. Pointed at a run dir it merges
the latest bundle of every process (``postmortem_*`` and
``proc<k>/postmortem_*``) into one skew-corrected fleet timeline: one
column per host, the trip marker, straggler and victim attribution, DCN
stalls interleaved (``obs/fleet.py``; ``--json`` prints the merged dict).
``--list`` enumerates every bundle under the run dir with its trip kind +
step. Pure stdlib, no torch import.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from cst_captioning_tpu_torch.obs.fleet import (
    list_bundles,
    merge_bundles,
    render_fleet,
)
from cst_captioning_tpu_torch.obs.report import (
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
                        "merge every proc's latest bundle when DIR is a run "
                        "dir (fleet timeline)")
    p.add_argument("--list", action="store_true", dest="list_bundles",
                   help="with --postmortem RUN_DIR: enumerate all bundles "
                        "(proc, trip kind, step, integrity) instead of "
                        "merging")
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
            if os.path.exists(os.path.join(args.postmortem, "meta.json")):
                # one bundle dir: the per-process render
                pm = load_postmortem(args.postmortem)
                if args.as_json:
                    print(json.dumps(pm, indent=2, default=float))
                else:
                    print(render_postmortem(pm))
                return 0
            # a run dir: every proc's latest bundle, merged
            fleet = merge_bundles(args.postmortem)
            if args.as_json:
                print(json.dumps(fleet, indent=2, default=float))
            else:
                print(render_fleet(fleet))
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

"""CLI: ``python -m repro_torch.analysis`` — run both analysis layers.

Exit status 0 means the serving hot path is clean: no AST lint finding
outside the checked-in baseline, and every step-audit check holds. See the
package docstring for the rules and checks.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu  # both layers
    PYTHONPATH=src python -m repro_torch.analysis --ast-only
    PYTHONPATH=src python -m repro_torch.analysis --trace-only   # on the card
    PYTHONPATH=src python -m repro_torch.analysis --write-baseline
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import astlint

BASELINE = Path(__file__).resolve().parent / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="host-sync / device-branch lint and step audit (static program, in "
                    "place, growth, dtypes, CUDA-graph capture) over the serving hot path",
    )
    ap.add_argument("--ast-only", action="store_true",
                    help="run only the layer 1 AST lint")
    ap.add_argument("--trace-only", action="store_true",
                    help="run only the layer 2 step audit")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept every current AST finding into baseline.json instead of "
                         "failing on it")
    ap.add_argument("--baseline", type=Path, default=BASELINE,
                    help=f"baseline path (default {BASELINE})")
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[3],
                    help="repo root containing src/repro_torch (default: inferred from "
                         "this file)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the step audit runs: cuda audits full-width llama3.2-1b "
                         "and captures every step; cpu the smoke config, no capture")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    if args.ast_only and args.trace_only:
        ap.error("--ast-only and --trace-only are mutually exclusive")
    verbose = not args.quiet
    status = 0

    if not args.trace_only:
        findings = astlint.lint_paths(args.root)
        if args.write_baseline:
            astlint.write_baseline(findings, args.baseline)
            print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        else:
            baseline = astlint.load_baseline(args.baseline)
            new, stale = astlint.apply_baseline(findings, baseline)
            for f in new:
                print(f.render())
            for fp in sorted(stale):
                print(f"warning: stale baseline entry (fixed? remove it): {fp}")
            if verbose:
                print(f"ast lint: {len(findings)} finding(s), "
                      f"{len(findings) - len(new)} baselined, {len(new)} new")
            if new:
                status = 1

    if not args.ast_only:
        from repro_torch.analysis import trace_audit

        fails = trace_audit.run_trace_audit(args.device, verbose=verbose)
        for msg in fails:
            print(f"trace audit: {msg}")
        if verbose:
            print(f"trace audit: {len(fails)} failure(s)")
        if fails:
            status = 1

    if verbose:
        print("analysis: " + ("CLEAN" if status == 0 else "FAILED"))
    return status


if __name__ == "__main__":
    sys.exit(main())

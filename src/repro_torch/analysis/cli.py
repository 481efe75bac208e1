"""``python -m repro_torch.analysis`` — run every invariant pass and report.

Exit status 0 means: zero unsuppressed findings AND zero stale
suppressions.  The committed suppression file
(``src/repro_torch/analysis/suppressions.txt``) is the complete, justified
list of intentional contract exceptions — anything else fails CI.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import invariants, registry
from repro_torch.analysis.base import (SuppressionError,
                                       apply_suppressions, load_suppressions)

DEFAULT_SUPPRESSIONS = Path(__file__).with_name("suppressions.txt")


def _find_root(start: Path) -> Path:
    """The repo root: the nearest ancestor containing src/repro_torch."""
    p = start.resolve()
    for cand in (p, *p.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    raise SystemExit(f"no src/repro_torch found above {start}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant linter for the storage planes")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: walk up from this file)")
    ap.add_argument("--suppressions", type=Path,
                    default=DEFAULT_SUPPRESSIONS,
                    help="suppression file (default: the committed one)")
    ap.add_argument("--list-suppressed", action="store_true",
                    help="also print the suppressed findings")
    args = ap.parse_args(argv)

    root = args.root or _find_root(Path(__file__).parent)
    findings = invariants.analyze(root) + registry.check_registry()
    try:
        supps = load_suppressions(args.suppressions)
    except SuppressionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    active, quiet, unused = apply_suppressions(findings, supps)

    for f in active:
        print(f.render())
    if args.list_suppressed:
        for f in quiet:
            print(f"(suppressed) {f.render()}")
    for s in unused:
        print(f"{args.suppressions.name}:{s.lineno}: stale suppression "
              f"(matched nothing): {s.key}")
    print(f"repro_torch.analysis: {len(active)} finding(s), "
          f"{len(quiet)} suppressed, {len(unused)} stale "
          f"suppression(s)")
    return 1 if (active or unused) else 0

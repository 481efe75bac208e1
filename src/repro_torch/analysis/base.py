"""Shared plumbing for the verification plane: findings + suppressions.

A :class:`Finding` is one contract violation with a stable *suppression
key* — ``rule file.py:qualname`` — that names the violating *function*
(or registry op), never a line number, so an intentional finding stays
suppressed across unrelated edits to the file.  Suppressions live in a
committed text file and each line MUST carry a justification after
``--``; a suppression that no longer matches anything is itself
reported (stale suppressions hide future regressions).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation.

    ``file``/``line`` point at the most useful source location (for
    call-graph rules that is the *root*, with the mutation site named
    in the message); ``qualname`` is the dotted function path used in
    the suppression key.
    """

    rule: str       # "accounting" | "lock-guard" | "lock-blocking" |
    #                 "write-path" | "registry" | ...
    file: str       # repo-relative path
    line: int
    qualname: str   # e.g. "ObjectStore.put", "SkyhookDriver.run.pump"
    message: str

    @property
    def key(self) -> str:
        """Suppression key: rule + basename + qualname (line-free)."""
        return f"{self.rule} {Path(self.file).name}:{self.qualname}"

    def render(self) -> str:
        return (f"{self.file}:{self.line}: [{self.rule}] "
                f"{self.qualname}: {self.message}")


@dataclasses.dataclass
class Suppression:
    key: str            # "rule file.py:qualname"
    justification: str
    lineno: int         # line in the suppression file (for reporting)
    used: bool = False


class SuppressionError(ValueError):
    """A malformed suppression line (missing justification, bad shape)."""


def load_suppressions(path: Path) -> list[Suppression]:
    """Parse the suppression file.

    Format, one per line (blank lines and ``#`` comments ignored)::

        <rule> <file.py>:<qualname> -- <why this is intentional>

    The justification is REQUIRED — an unexplained suppression is a
    parse error, not a working suppression.
    """
    out: list[Suppression] = []
    if not path.exists():
        return out
    for i, raw in enumerate(path.read_text().splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if "--" not in line:
            raise SuppressionError(
                f"{path.name}:{i}: suppression needs a justification "
                f"after '--': {line!r}")
        head, _, why = line.partition("--")
        why = why.strip()
        if not why:
            raise SuppressionError(
                f"{path.name}:{i}: empty justification: {line!r}")
        parts = head.split()
        if len(parts) != 2 or ":" not in parts[1]:
            raise SuppressionError(
                f"{path.name}:{i}: expected '<rule> <file>:<qualname>"
                f" -- <why>', got: {line!r}")
        out.append(Suppression(" ".join(parts), why, i))
    return out


def apply_suppressions(
    findings: list[Finding], supps: list[Suppression],
) -> tuple[list[Finding], list[Finding], list[Suppression]]:
    """Split findings into (active, suppressed); also return the
    suppressions that matched nothing (stale — report those too)."""
    by_key: dict[str, Suppression] = {s.key: s for s in supps}
    active, quiet = [], []
    for f in findings:
        s = by_key.get(f.key)
        if s is not None:
            s.used = True
            quiet.append(f)
        else:
            active.append(f)
    unused = [s for s in supps if not s.used]
    return active, quiet, unused

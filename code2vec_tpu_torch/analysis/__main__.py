"""``python -m code2vec_tpu_torch.analysis`` — run torchlint, the sharding
checker and the CX/RS rule families over the port.

Counterpart of ``python -m code2vec_tpu.analysis``, with the same flags.
Pure stdlib (no torch, no numpy): the whole pass costs parse time. Exit
status is 1 iff any NEW finding exists — one that is neither
inline-suppressed (``# torchlint: disable=TXnnn``) nor recorded in the
baseline file (``analysis/baseline.json``; regenerate with
``--write-baseline``).

``--diff-only [REF]`` restricts the scan to ``.py`` files changed vs
``REF`` (default: the merge base with ``origin/main``, else ``HEAD~1``)
plus uncommitted/untracked files — the fast mode. An unresolvable ref
falls back to the full scan rather than silently passing.
"""

from __future__ import annotations

import argparse
import ast
import json
import subprocess
import sys
from pathlib import Path

from code2vec_tpu_torch.analysis import concurrency, lifecycle, torchlint
from code2vec_tpu_torch.analysis.sharding_check import check_source, declared_axes

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_PATHS = ("code2vec_tpu_torch", "chip_smoke.py")
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"
DEFAULT_MESH = "code2vec_tpu_torch/parallel/mesh.py"
SYNC_MODULE = "code2vec_tpu_torch/obs/sync.py"
HANDLES_MODULE = "code2vec_tpu_torch/obs/handles.py"
# textual markers of a lock-factory call site / raw lock construction: a
# change to any such module can add or remove acquisition-graph edges whose
# cycles close through UNCHANGED files, so the diff-restricted scan widens
_LOCK_SITE_MARKERS = (
    "make_lock(",
    "make_rlock(",
    "make_condition(",
    "threading.Lock(",
    "threading.RLock(",
    "threading.Condition(",
)
# textual markers of resource construction: RS005's repo-wide finalize
# joins per-file class fragments, so a diff adding a resource ctor (or
# touching the ledger module) can change verdicts on UNCHANGED owner
# classes — same rationale as the CX002 widening above
_RESOURCE_SITE_MARKERS = (
    "subprocess.Popen(",
    "SharedMemory(",
    "np.memmap(",
    "open_memmap(",
    "mmap.mmap(",
    "mkdtemp(",
    "NamedTemporaryFile(",
    "threading.Thread(",
    "ThreadPoolExecutor(",
    "ProcessPoolExecutor(",
)


def _touches_lock_graph(root: Path, changed: list[Path]) -> Path | None:
    """The first changed file that can perturb the repo-wide lock
    acquisition graph (the sync module itself, or any module constructing
    locks / calling the lock factory); None when the diff is graph-inert."""
    for rel in changed:
        if rel.as_posix() == SYNC_MODULE:
            return rel
        path = root / rel
        if not path.exists():  # a deleted lock-site module also perturbs
            continue
        try:
            text = path.read_text()
        except OSError:  # pragma: no cover - unreadable working tree file
            continue
        if any(marker in text for marker in _LOCK_SITE_MARKERS):
            return rel
    return None


def _touches_resource_graph(root: Path, changed: list[Path]) -> Path | None:
    """The first changed file that can perturb the repo-wide resource
    ownership table (the handle-ledger module itself, or any module
    constructing tracked resources); None when the diff is inert."""
    for rel in changed:
        if rel.as_posix() == HANDLES_MODULE:
            return rel
        path = root / rel
        if not path.exists():  # a deleted owner module also perturbs
            continue
        try:
            text = path.read_text()
        except OSError:  # pragma: no cover - unreadable working tree file
            continue
        if any(marker in text for marker in _RESOURCE_SITE_MARKERS):
            return rel
    return None


def _git(root: Path, *args: str) -> str:
    return subprocess.run(
        ["git", "-C", str(root), *args],
        check=True,
        capture_output=True,
        text=True,
    ).stdout


def changed_py_files(root: Path, ref: str | None) -> list[Path] | None:
    """Repo-relative ``.py`` files changed vs ``ref`` + working-tree
    changes + untracked files; None when git state can't be read (the
    caller falls back to a full scan)."""
    try:
        if not ref:
            try:
                ref = _git(root, "merge-base", "origin/main", "HEAD").strip()
            except subprocess.CalledProcessError:
                ref = "HEAD~1"
        names = set(_git(root, "diff", "--name-only", ref).splitlines())
        names |= set(_git(root, "diff", "--name-only", "--cached").splitlines())
        names |= set(
            _git(
                root, "ls-files", "--others", "--exclude-standard"
            ).splitlines()
        )
    except (subprocess.CalledProcessError, OSError):
        return None
    return [Path(n) for n in sorted(names) if n.endswith(".py")]


def _severity_counts(findings: list[torchlint.Finding]) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in findings:
        out[f.severity] = out.get(f.severity, 0) + 1
    return out


def run(
    paths: list[Path],
    root: Path,
    baseline_path: Path,
    mesh_file: Path | None,
) -> list[torchlint.Finding]:
    # one read + one ast.parse per file, shared by the lint and the
    # other layers — parse time is the whole cost of this tool
    axis_decls = (
        declared_axes(mesh_file.read_text()) if mesh_file is not None else None
    )
    findings: list[torchlint.Finding] = []
    fragments: list[concurrency.ModuleFragment] = []
    rs_fragments: list[lifecycle.LifecycleFragment] = []
    for file in torchlint.iter_py_files(paths):
        rel = torchlint.relative(file, root)
        source = file.read_text()
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError:
            tree = None  # lint_source reparses to emit TX000
        findings += torchlint.lint_source(source, rel, tree=tree)
        if axis_decls is not None and tree is not None:
            findings += check_source(source, rel, axis_decls, tree=tree)
        if tree is not None:
            cx_findings, fragment = concurrency.check_source(
                source, rel, tree=tree
            )
            findings += cx_findings
            fragments.append(fragment)
            rs_findings, rs_fragment = lifecycle.check_source(
                source, rel, tree=tree
            )
            findings += rs_findings
            rs_fragments.append(rs_fragment)
    # CX002 is repo-wide: the acquisition graph joins every scanned file's
    # fragments, so cross-class cycles surface wherever their edges live
    findings += concurrency.finalize(fragments)
    # RS005 likewise: owned-class attributes resolve against every class
    # seen anywhere in the scan
    findings += lifecycle.finalize(rs_fragments)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    torchlint.apply_baseline(findings, torchlint.load_baseline(baseline_path))
    return findings


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m code2vec_tpu_torch.analysis",
        description="PyTorch-footgun lint + sharding, lock and resource checks",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help=f"files/dirs to scan (default: {' '.join(DEFAULT_PATHS)})",
    )
    parser.add_argument(
        "--root",
        type=Path,
        default=REPO_ROOT,
        help="repo root for relative finding paths (default: the package's)",
    )
    parser.add_argument(
        "--baseline",
        type=Path,
        default=DEFAULT_BASELINE,
        help="baseline file of accepted pre-existing findings",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="record the current findings as the new baseline and exit 0",
    )
    parser.add_argument(
        "--diff-only",
        nargs="?",
        const="",
        default=None,
        metavar="REF",
        help="scan only .py files changed vs REF (default: merge-base with "
        "origin/main, else HEAD~1) — the fast mode",
    )
    parser.add_argument(
        "--mesh-file",
        type=Path,
        default=None,
        help=f"mesh-axis declarations for SC rules (default: {DEFAULT_MESH})",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit findings as a JSON document"
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule table"
    )
    args = parser.parse_args(argv)

    if args.diff_only is not None and args.write_baseline:
        # a baseline written from a restricted scan would drop every
        # accepted fingerprint in the unscanned files
        parser.error("--write-baseline needs the full scan; drop --diff-only")

    if args.list_rules:
        for rule in torchlint.RULES.values():
            print(f"{rule.id} [{rule.severity:7}] {rule.name}: {rule.summary}")
            print(f"       fix: {rule.hint}")
        return 0

    root = args.root.resolve()
    scan = [
        root / p for p in (args.paths or DEFAULT_PATHS) if (root / p).exists()
    ]
    mesh_file = args.mesh_file if args.mesh_file is not None else root / DEFAULT_MESH
    if not mesh_file.exists():
        mesh_file = None

    if args.diff_only is not None:
        changed = changed_py_files(root, args.diff_only or None)
        if changed is None:
            print(
                "torchlint: --diff-only could not read git state; running the "
                "full scan",
                file=sys.stderr,
            )
        elif mesh_file is not None and any(
            (root / c).resolve() == mesh_file.resolve() for c in changed
        ):
            # a mesh-axis rename/removal invalidates PartitionSpecs in
            # UNCHANGED files; restricting to the diff would pass the PR
            # and break the full scan on main
            print(
                "torchlint: mesh declarations changed; running the full scan",
                file=sys.stderr,
            )
        elif (lock_site := _touches_lock_graph(root, changed)) is not None:
            # same widening logic as the mesh rule, for CX002: the lock
            # acquisition graph is repo-wide, so an edge added in this
            # diff can close a cycle through unchanged files
            print(
                f"torchlint: lock construction changed ({lock_site.as_posix()})"
                "; running the full scan",
                file=sys.stderr,
            )
        elif (res_site := _touches_resource_graph(root, changed)) is not None:
            # RS005's ownership table is repo-wide: a resource ctor added
            # in this diff can change verdicts on unchanged owner classes
            print(
                f"torchlint: resource construction changed "
                f"({res_site.as_posix()}); running the full scan",
                file=sys.stderr,
            )
        else:
            scan_files = {
                f.resolve() for f in torchlint.iter_py_files(scan)
            }
            scan = [
                root / c for c in changed if (root / c).resolve() in scan_files
            ]
            if not scan:
                print("torchlint: no changed files in scope; nothing to do")
                return 0

    findings = run(scan, root, args.baseline, mesh_file)

    if args.write_baseline:
        torchlint.write_baseline(
            [f for f in findings if not f.suppressed], args.baseline
        )
        print(f"torchlint: baseline written to {args.baseline}")
        return 0

    new = [f for f in findings if not f.suppressed and not f.baselined]
    if args.json:
        print(
            json.dumps(
                {
                    "version": 1,
                    "tool": torchlint.TOOL,
                    "findings": [f.to_json() for f in findings],
                    "summary": {
                        "total": len(findings),
                        "new": len(new),
                        "baselined": sum(1 for f in findings if f.baselined),
                        "suppressed": sum(1 for f in findings if f.suppressed),
                        "by_severity": _severity_counts(new),
                    },
                },
                indent=2,
            )
        )
    else:
        for f in new:
            print(f.text())
        print(
            f"torchlint: {len(new)} new finding(s), "
            f"{sum(1 for f in findings if f.baselined)} baselined, "
            f"{sum(1 for f in findings if f.suppressed)} suppressed "
            f"({len(findings)} total)"
        )
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())

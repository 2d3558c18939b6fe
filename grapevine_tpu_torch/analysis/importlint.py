"""Stdlib import lint (a copy of ``grapevine_tpu/analysis/importlint.py``
whose default root is the port's package): F401 + F841 + E722 (+ E9).

The repo pins ruff's pyflakes/import tier in pyproject.toml
(``[tool.ruff] select = ["E4", "E7", "E9", "F"]``) and tier-1 runs
``ruff check`` wherever the binary exists (tests/test_lint.py). This
container image has no ruff wheel and the build bakes its dependencies,
so the gate needs always-on teeth that never install anything — an AST
checker for the subsets that matter and never false-positive:

- **F401** unused import (the original check);
- **F841** unused local variable — simple ``name = value`` bindings
  (and ``except ... as name`` handlers) whose name is never read
  anywhere in the enclosing function, skipping underscore names,
  augmented/annotated/tuple targets, declared globals/nonlocals, and
  any function that touches ``locals()``/``eval``/``exec``;
- **E722** bare ``except:`` — swallows ``KeyboardInterrupt`` and
  ``SystemExit``; name the exception (``except Exception:`` at
  minimum);
- **E9** for free (``ast.parse`` failing IS a syntax error).

Deliberately conservative throughout: for F401 a name counts as *used*
if its identifier token appears anywhere else in the file outside the
import statement's own line (string annotations, docstring'd doctests,
``__all__``, getattr strings all count). That under-reports, never
false-positives — the right polarity for a merge gate. ``__init__.py``
re-exports are exempt (mirroring the pyproject per-file-ignores), as is
any line carrying ``# noqa``.
"""

from __future__ import annotations

import ast
import os
import re


def _binding_names(node) -> list:
    """(bound_name, display) pairs for an import statement."""
    out = []
    if isinstance(node, ast.Import):
        for a in node.names:
            bound = a.asname or a.name.split(".")[0]
            out.append((bound, a.name))
    elif isinstance(node, ast.ImportFrom):
        if node.module == "__future__":
            return []
        for a in node.names:
            if a.name == "*":
                continue
            out.append((a.asname or a.name, a.name))
    return out


def _own_scope_stores(fn_node) -> list:
    """Simple-name Assign targets and ``except as`` names in THIS
    function's scope only — nested function/class scopes bind their own
    locals and are skipped."""
    out = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue  # separate scope
            if isinstance(child, ast.Assign) and len(child.targets) == 1 \
                    and isinstance(child.targets[0], ast.Name):
                out.append((child.lineno, child.targets[0].id))
            elif isinstance(child, ast.ExceptHandler) and child.name:
                out.append((child.lineno, child.name))
            visit(child)

    visit(fn_node)
    return out


def _function_f841(fn_node, noqa_lines: set) -> list:
    """F841 findings for one function node (conservative, see module
    docstring): stores from this scope, loads from the whole subtree
    (closures in nested defs legitimately read enclosing locals)."""
    dynamic = False
    declared: set = set()
    loads: set = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in ("locals", "eval",
                                                    "exec", "vars"):
                dynamic = True
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            declared.update(node.names)
        elif isinstance(node, ast.AugAssign) and isinstance(
                node.target, ast.Name):
            # x += 1 reads AND writes x: the prior binding is required
            # (deleting it raises UnboundLocalError), so it counts as a
            # use — the never-false-positive polarity
            loads.add(node.target.id)
        elif isinstance(node, ast.Name) and not isinstance(
                node.ctx, ast.Store):
            loads.add(node.id)  # Load and Del both count as uses
    if dynamic:
        return []
    out = []
    seen: set = set()
    for lineno, name in _own_scope_stores(fn_node):
        if (name in loads or name in declared or name.startswith("_")
                or name in seen or lineno in noqa_lines):
            continue
        seen.add(name)
        out.append(
            (lineno, name,
             f"F841 local variable {name!r} is assigned to but never used")
        )
    return out


def check_source(src: str, filename: str = "<src>") -> list:
    """F401/F841/E722 findings for one file: (line, name, message)."""
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as exc:
        return [(exc.lineno or 0, "<syntax>", f"syntax error: {exc.msg}")]
    lines = src.splitlines()
    noqa_lines = {
        i for i, line in enumerate(lines, start=1) if "noqa" in line
    }
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None \
                and node.lineno not in noqa_lines:
            findings.append(
                (node.lineno, "<bare-except>",
                 "E722 bare 'except:' swallows KeyboardInterrupt/"
                 "SystemExit — name the exception class")
            )
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.extend(_function_f841(node, noqa_lines))
    imports = []  # (lineno, end_lineno, bound, display)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for bound, display in _binding_names(node):
                imports.append(
                    (node.lineno, node.end_lineno or node.lineno,
                     bound, display)
                )
    for lineno, end_lineno, bound, display in imports:
        if any(
            "noqa" in lines[i - 1]
            for i in range(lineno, min(end_lineno, len(lines)) + 1)
        ):
            continue
        if bound == "_":
            continue
        pat = re.compile(rf"\b{re.escape(bound)}\b")
        used = False
        for i, line in enumerate(lines, start=1):
            if lineno <= i <= end_lineno:
                continue
            if pat.search(line):
                used = True
                break
        if not used:
            findings.append(
                (lineno, bound,
                 f"F401 {display!r} imported but unused")
            )
    return findings


def check_tree(root: str, skip_init: bool = True) -> dict:
    """Lint every .py under ``root``; returns {relpath: findings}."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [
            d for d in dirnames
            if d not in ("__pycache__", ".git")
        ]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            if skip_init and fn == "__init__.py":
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as fh:
                findings = check_source(fh.read(), filename=path)
            if findings:
                out[os.path.relpath(path, root)] = findings
    return out


def main(argv=None) -> int:
    roots = argv if argv else [
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ]
    n = 0
    for root in roots:
        for rel, findings in sorted(check_tree(root).items()):
            for lineno, _name, msg in findings:
                print(f"{os.path.join(root, rel)}:{lineno}: {msg}")
                n += 1
    print(f"[importlint] {n} finding(s)")
    return 1 if n else 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))

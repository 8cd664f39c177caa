"""Layer 1: rule-based AST lint over ``src/repro_torch`` (see the package
docstring).

Rules
-----
``HS001``
    Host sync inside a hot-path function (``@hot_path`` or a
    :data:`repro_torch.analysis.hotpath.HOT_PATHS` entry): ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``; ``np.asarray`` / ``np.array``;
    ``torch.cuda.synchronize`` and ``.synchronize()``; ``nonzero``,
    ``masked_select`` and ``unique`` (their output shapes depend on the
    data, so the host waits for them); ``torch.tensor`` / ``torch.as_tensor``
    with a ``device=`` (a pageable host-to-device copy); and
    ``bool()`` / ``int()`` / ``float()`` casts. The scheduler's staged wait
    (``self._staging.wait(...)``, the step's one device-to-host copy behind a
    CUDA event) is the one sanctioned sync, the counterpart of the
    reference's ``jax.device_get``: it is never flagged, nor is a cast of
    what it returned (or of a name bound from it), a constant or ``len()``.
``TB001``
    Inside a hot-path function: an ``if`` / ``while`` whose test calls a
    tensor method (``.any()``, ``.all()``, ``.sum()``, a comparison method,
    ...) or a ``torch`` function. Python control flow on a device value
    syncs, and a captured step bakes the branch it took into the graph.
    ``x is None`` tests are exempt (argument presence is static), as are
    ``torch.is_*`` / ``torch.cuda.*`` queries of host state.

The reference's ``DN001`` (a jit site that does not donate its cache) has no
AST counterpart here: PyTorch has no donation, and the port writes its
caches in place. The step audit (``analysis/trace_audit.py``) holds every
cache leaf to its storage and bans cache-sized copies instead.

Suppression: ``# repro-lint: disable=RULE[,RULE2]`` on the offending line
(anywhere within a multi-line statement) or as a standalone comment on the
line directly above. Every suppression carries its reason on the same
comment.

Findings carry a *fingerprint*, ``rule:path:qualname:snippet``, that is
stable across line-number drift; ``baseline.json`` stores the fingerprints
of findings that pre-date a rule, so the analysis fails only on new ones
(its goal is empty).
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.hotpath import HOT_PATHS

RULES: Dict[str, str] = {
    "HS001": "host sync inside a serving hot-path function",
    "TB001": "Python branch on a device value inside a serving hot-path function",
}

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Z0-9_,\s]+)")
_NUMPY_ALIASES = ("np", "numpy", "onp")
_CAST_BUILTINS = ("bool", "int", "float")
#: tensor methods that copy to the host
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
#: ops whose output shape depends on the data (the host waits for the count)
_DATA_SHAPE_OPS = ("nonzero", "masked_select", "unique")
#: tensor methods whose result is a device value (a branch on one syncs)
_DEVICE_METHODS = frozenset({
    "any", "all", "item", "sum", "max", "min", "amax", "amin", "argmax", "argmin",
    "eq", "ne", "lt", "le", "gt", "ge", "equal", "allclose", "isclose", "isfinite",
    "isnan", "isinf", "count_nonzero", "nonzero", "mean", "prod",
})


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative posix path
    line: int
    qualname: str
    message: str
    snippet: str  # stripped source of the offending line

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.qualname}:{self.snippet}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.qualname}] "
                f"{self.message}\n    {self.snippet}")


# --------------------------------------------------------------------------
# small AST helpers
# --------------------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_staged_wait(node: ast.AST) -> bool:
    """``self._staging.wait(...)`` / ``_Staging.wait(...)``: the scheduler's
    one sanctioned sync (the staged copy of the step's sampled tokens)."""
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        return bool(d) and (d.endswith("_staging.wait") or d == "_Staging.wait")
    return False


def _rooted_at(node: ast.AST, names: Set[str]) -> bool:
    """``node`` is a subscript, attribute or method call chain rooted at one
    of ``names`` (``host[:n]``, ``rest.all()``)."""
    while isinstance(node, (ast.Subscript, ast.Attribute, ast.Call)):
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Attribute):
                return False
            node = node.func.value
        else:
            node = node.value
    return isinstance(node, ast.Name) and node.id in names


def _host_assigned_names(fn: ast.AST) -> Set[str]:
    """Names this function binds from the staged wait, or from casts and
    ``len``, and names bound from slices of those (``feed, rest =
    host[:n], host[n:]``), in source order. Casting such a name (or a
    subscript of it) later is host arithmetic, not a sync."""
    host: Set[str] = set()
    assigns = sorted((n for n in ast.walk(fn)
                      if isinstance(n, ast.Assign) and len(n.targets) == 1),
                     key=lambda n: (n.lineno, n.col_offset))

    def is_host(val: ast.AST) -> bool:
        return _is_staged_wait(val) or _rooted_at(val, host) or (
            isinstance(val, ast.Call)
            and isinstance(val.func, ast.Name)
            and val.func.id in _CAST_BUILTINS + ("len",)
        )

    for node in assigns:
        val, tgt = node.value, node.targets[0]
        if isinstance(tgt, ast.Name):
            if is_host(val):
                host.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            if isinstance(val, (ast.Tuple, ast.List)) and len(val.elts) == len(tgt.elts):
                host.update(t.id for t, v in zip(tgt.elts, val.elts)
                            if isinstance(t, ast.Name) and is_host(v))
            elif is_host(val):
                host.update(e.id for e in tgt.elts if isinstance(e, ast.Name))
    return host


def _is_presence_test(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None`` (argument presence is static)."""
    if isinstance(test, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
    return False


def _is_host_torch_query(d: str) -> bool:
    """``torch.is_*`` / ``torch.cuda.*`` / ``torch.device`` and friends:
    torch functions that read host state, not a device value."""
    last = d.split(".")[-1]
    return (d.startswith("torch.cuda.") or last.startswith("is_")
            or last in ("device", "finfo", "iinfo", "get_default_dtype"))


def _device_call(test: ast.AST, host: Set[str]) -> Optional[str]:
    """The first call in ``test`` that yields a device value (a tensor
    method of :data:`_DEVICE_METHODS` on anything but a ``host`` name, or a
    ``torch.*`` function), as text; None when there is none."""
    for n in ast.walk(test):
        if not isinstance(n, ast.Call):
            continue
        d = _dotted(n.func)
        if d and d.startswith("torch.") and not _is_host_torch_query(d):
            return d
        if (isinstance(n.func, ast.Attribute) and n.func.attr in _DEVICE_METHODS
                and not _rooted_at(n.func.value, host)):
            return f".{n.func.attr}()"
    return None


# --------------------------------------------------------------------------
# per-file linter
# --------------------------------------------------------------------------

class _FileLint(ast.NodeVisitor):
    def __init__(self, rel_path: str, module_name: str, source: str):
        self.rel_path = rel_path
        self.module = module_name
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self._qual: List[str] = []  # class/function name stack
        self._hot_depth = 0  # >0 while inside a hot-path function
        self._host_stack: List[Set[str]] = []  # names bound from the staged wait
        # line -> set of rule ids suppressed there
        self._suppress: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self._suppress[i] = rules
                if text.strip().startswith("#"):
                    # a standalone comment suppresses the next code line;
                    # continuation comment lines extend the reach
                    j = i + 1
                    while (j <= len(self.lines)
                           and self.lines[j - 1].strip().startswith("#")):
                        j += 1
                    self._suppress.setdefault(j, set()).update(rules)

    # ---- plumbing --------------------------------------------------------
    def _qualname(self) -> str:
        return ".".join(self._qual) if self._qual else "<module>"

    def _suppressed(self, rule: str, node: ast.AST) -> bool:
        start = node.lineno
        for deco in getattr(node, "decorator_list", []):
            start = min(start, deco.lineno)
        end = getattr(node, "end_lineno", node.lineno) or node.lineno
        if isinstance(node, (ast.If, ast.While)):
            end = node.test.end_lineno or node.lineno  # the test, not the body
        for line in range(start, end + 1):
            if rule in self._suppress.get(line, set()):
                return True
        return False

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if self._suppressed(rule, node):
            return
        line = node.lineno
        snippet = self.lines[line - 1].strip() if line <= len(self.lines) else ""
        self.findings.append(Finding(
            rule=rule, path=self.rel_path, line=line,
            qualname=self._qualname(), message=message, snippet=snippet,
        ))

    # ---- scopes ----------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()

    def _function_is_hot(self, node) -> bool:
        for deco in node.decorator_list:
            d = _dotted(deco)
            if d and d.split(".")[-1] == "hot_path":
                return True
        # _qual already ends with node.name here
        return f"{self.module}.{'.'.join(self._qual)}" in HOT_PATHS

    def _visit_function(self, node) -> None:
        self._qual.append(node.name)
        hot = self._function_is_hot(node)
        self._hot_depth += 1 if hot else 0
        self._host_stack.append(_host_assigned_names(node))
        self.generic_visit(node)
        self._host_stack.pop()
        self._hot_depth -= 1 if hot else 0
        self._qual.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # ---- HS001 -----------------------------------------------------------
    def _sanctioned_cast_arg(self, node: ast.AST) -> bool:
        """Casting HOST data is fine: constants, ``len()``, the staged
        wait's result, or any expression rooted at a name the function bound
        from one (``toks[slot]``, ``both[0]``, ...)."""
        if isinstance(node, ast.Constant):
            return True
        host = set().union(*self._host_stack) if self._host_stack else set()
        while True:
            if _is_staged_wait(node):
                return True
            if isinstance(node, ast.Call):
                if _dotted(node.func) == "len":
                    return True
                if isinstance(node.func, ast.Attribute):
                    node = node.func.value  # method call: peel to receiver
                    continue
                return False
            if isinstance(node, (ast.Subscript, ast.Attribute)):
                node = node.value
                continue
            if isinstance(node, ast.Name):
                return node.id in host
            return False

    def visit_Call(self, node: ast.Call) -> None:
        if self._hot_depth > 0:
            self._check_host_sync(node)
        self.generic_visit(node)

    def _check_host_sync(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            owner = _dotted(func.value)
            dotted = _dotted(func)
            if owner in _NUMPY_ALIASES and func.attr in ("asarray", "array"):
                self._emit(
                    "HS001", node,
                    f"{owner}.{func.attr}() on a device value blocks the host per "
                    f"call: fold it into the step's staged copy",
                )
            elif func.attr in _SYNC_METHODS and not node.args and not (
                    func.attr == "numpy" and self._sanctioned_cast_arg(func.value)):
                self._emit("HS001", node,
                           f".{func.attr}() copies to the host and waits for the card")
            elif func.attr == "synchronize":
                self._emit("HS001", node,
                           f"{dotted or '.synchronize'}() stalls the host inside the "
                           f"hot path")
            elif func.attr in _DATA_SHAPE_OPS:
                self._emit(
                    "HS001", node,
                    f"{func.attr}() has a data-dependent output shape: the host waits "
                    f"for the count, and no graph can capture it",
                )
            elif dotted in ("torch.tensor", "torch.as_tensor") and any(
                    k.arg == "device" for k in node.keywords):
                self._emit(
                    "HS001", node,
                    f"{dotted}(..., device=) copies from pageable host memory: "
                    f"stage it through the pinned buffers",
                )
        elif isinstance(func, ast.Name) and func.id in _CAST_BUILTINS:
            if node.args and not self._sanctioned_cast_arg(node.args[0]):
                self._emit(
                    "HS001", node,
                    f"{func.id}() on a device value is a hidden host sync: take it "
                    f"from the step's staged copy",
                )

    # ---- TB001 -----------------------------------------------------------
    def _check_device_branch(self, node) -> None:
        if self._hot_depth == 0 or _is_presence_test(node.test):
            return
        hit = _device_call(node.test, set().union(*self._host_stack))
        if hit is not None:
            kind = "if" if isinstance(node, ast.If) else "while"
            self._emit(
                "TB001", node,
                f"`{kind}` on {hit} inside a hot-path function: a branch on a "
                f"device value syncs, and a captured step bakes one branch in",
            )

    def visit_If(self, node: ast.If) -> None:
        self._check_device_branch(node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_device_branch(node)
        self.generic_visit(node)


# --------------------------------------------------------------------------
# tree runner + baseline
# --------------------------------------------------------------------------

def lint_source(source: str, rel_path: str = "<memory>",
                module_name: str = "<memory>") -> List[Finding]:
    """Lint one source string (unit-test entry point)."""
    lint = _FileLint(rel_path, module_name, source)
    lint.visit(ast.parse(source))
    return lint.findings


def _module_name(rel: Path) -> str:
    parts = list(rel.with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    return ".".join(parts)


def lint_paths(root: Path, subdirs: Sequence[str] = ("src/repro_torch",),
               exclude: Sequence[str] = ("src/repro_torch/analysis",),
               ) -> List[Finding]:
    """Lint every ``.py`` under ``root/<subdir>`` (repo-relative paths in
    findings). The analysis package itself is excluded by default: its
    fixture strings would flag themselves."""
    root = Path(root)
    findings: List[Finding] = []
    for sub in subdirs:
        for path in sorted((root / sub).rglob("*.py")):
            rel = path.relative_to(root)
            if any(rel.as_posix().startswith(e) for e in exclude):
                continue
            findings.extend(lint_source(
                path.read_text(), rel.as_posix(), _module_name(rel)
            ))
    return findings


def load_baseline(path: Path) -> Set[str]:
    path = Path(path)
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("findings", []))


def write_baseline(findings: Sequence[Finding], path: Path) -> None:
    payload = {
        "comment": (
            "Fingerprints of lint findings that pre-date a rule. The analysis "
            "fails only on findings NOT listed here; keep this empty: a "
            "justified exception belongs in a repro-lint disable comment "
            "beside the code, with its reason."
        ),
        "findings": sorted({f.fingerprint for f in findings}),
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def apply_baseline(findings: Sequence[Finding], baseline: Set[str],
                   ) -> Tuple[List[Finding], Set[str]]:
    """Split into (new findings, stale baseline fingerprints)."""
    fps = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    stale = baseline - fps
    return new, stale

"""AST lint for the port: host syncs on the serving hot path, asserts, the
CUDA kernels' bindings and their plain versions — port of
``repro/analysis/lint.py``.

Pure ``ast``/``re``/stdlib — no torch import — so it runs in milliseconds
anywhere.  Run via ``python -m repro_torch.analysis``.

Rule catalog (ids are what suppressions and the baseline reference):

* ``host-sync`` — a host-device synchronizing call in a function reachable
  from the engine's hot plan/launch/commit path: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.synchronize()`` (on a
  stream, an event or the device) and ``np.asarray`` / ``np.array`` (on a
  tensor, a copy to the host).  Every step gets exactly ONE sync
  (``Engine.sync_tokens``: the step's tokens); anything else serializes
  host against device and kills the async loop's overlap.  Sync callables
  passed by reference (e.g. into an executor) are flagged too.
* ``bare-assert`` — an ``assert`` statement in library code.  Asserts
  vanish under ``python -O``; invariants must raise typed exceptions.
* ``kernel-ref-parity`` — every public ``*_kernel`` in a
  ``kernels/<pkg>/kernel.py`` must have a ``*_ref`` in the sibling
  ``ref.py`` whose parameter names are an ordered subsequence of the
  kernel's: the parity tests assume the two are call-compatible.
* ``telemetry-alloc`` — an allocating argument (container literal,
  comprehension, f-string, or a list/dict/set/tuple/sorted call) passed to
  a telemetry call (a method on a ``tracer`` / ``recorder`` / ``metrics``
  receiver) in a function reachable from the hot path.
* ``ctypes-signature`` — each ``extern "C"`` function of ``csrc/*.cu``
  (definitions and declarations) against the ``argtypes`` the binding
  gives it (``kernels/build.py``'s ``_SIGNATURES``, or a direct
  ``lib.<name>.argtypes = [...]``), by count and by kind (pointer, ``int``,
  ``long long``, ``float``).  A mismatch is a silent ABI fault: ctypes
  passes what it is told.
* ``kernel-fallback`` — in ``kernels/*/ops.py``, a path by which a CUDA
  tensor can reach the plain version (a ``*_ref``, anything imported from
  the package's ``ref.py``, or a local function that calls one): an
  exception handler that calls it (a ``try`` around a kernel), the body of
  a branch taken on a CUDA tensor (``device.type == "cuda"``, ``is_cuda``,
  ``device.type != "cpu"``), or the ``"cuda"`` entry of a dispatch dict.
  A CUDA tensor never falls back (ROADMAP).

JAX's two ``jit-*`` rules have no counterpart (the port has no jit), nor
do its three TPU-tile rules (``pallas-arity``, ``pallas-alias``,
``pallas-align``, ``pallas-grid-div``): ``nvcc`` refuses a malformed
launch's types, and ``chip_smoke.py`` phase 1 reads each kernel's
registers and spills from ptxas and its instructions from the SASS.

Suppression: ``# lint: allow(rule-id)`` (optionally with a reason after
the closing paren) on the offending line or the line directly above.

Baseline: ``analysis/baseline.json`` grandfathers pre-existing violations
by ``(rule, path, symbol)`` count — line-number independent.  New
violations beyond the baselined count fail the gate; regenerate with
``python -m repro_torch.analysis --write-baseline``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Dict, List, Optional, Set, Tuple

RULES: Dict[str, str] = {
    "host-sync": "host-device sync reachable from the hot serving path",
    "bare-assert": "bare assert in library code (vanishes under python -O)",
    "kernel-ref-parity": "kernel.py/ref.py signature mismatch",
    "telemetry-alloc": "allocating argument to a hot-path telemetry call",
    "ctypes-signature": "extern \"C\" function vs its ctypes argtypes",
    "kernel-fallback": "a CUDA tensor can reach a kernel's plain version",
}

# the engine's hot path: one step = plan -> launch -> commit (plan_spec is
# the speculative variant), plus the async loop that drives them
HOT_ROOTS = {("Engine", "step"), ("Engine", "plan_step"),
             ("Engine", "plan_spec"), ("Engine", "launch_step"),
             ("Engine", "commit_step"), ("AsyncEngine", "_loop")}

# packages whose functions participate in hot-path reachability (host-side
# serving code; the model's forward is device work, not host bookkeeping)
HOT_PACKAGES = ("serving", "analysis")

NUMPY_SYNC_FUNCS = {"asarray", "array"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}

# receivers whose method calls count as telemetry, and builtins whose call
# as a telemetry argument allocates a container per event
TELEMETRY_RECEIVERS = {"tracer", "recorder", "metrics"}
ALLOC_BUILTINS = {"list", "dict", "set", "tuple", "sorted"}

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([^)]*)\)")

# ctypes names -> argument kinds of a C signature
_CTYPES_KIND = {"c_void_p": "pointer", "c_char_p": "pointer", "c_int": "int",
                "c_longlong": "long long", "c_int64": "long long",
                "c_float": "float", "POINTER": "pointer"}
_EXTERN_RE = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*([;{])',
                        re.S)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, e.g. src/repro_torch/serving/engine.py
    line: int
    symbol: str        # enclosing Class.func / func / <module>
    message: str

    @property
    def baseline_key(self) -> str:
        return f"{self.rule}::{self.path}::{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.symbol}: " \
               f"{self.message}"


@dataclasses.dataclass
class FuncInfo:
    module: "ModuleInfo"
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    name: str
    cls: Optional[str]

    @property
    def qualname(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name


@dataclasses.dataclass
class ModuleInfo:
    path: pathlib.Path
    rel: str
    tree: ast.Module
    lines: List[str]
    numpy_names: Set[str] = dataclasses.field(default_factory=set)
    functions: List[FuncInfo] = dataclasses.field(default_factory=list)


def _collect_module(path: pathlib.Path, rel: str) -> Optional[ModuleInfo]:
    try:
        src = path.read_text()
        tree = ast.parse(src)
    except (OSError, SyntaxError):
        return None
    mod = ModuleInfo(path=path, rel=rel, tree=tree, lines=src.splitlines())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "numpy":
                    mod.numpy_names.add(a.asname or "numpy")
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] == "numpy":
                for a in node.names:
                    if a.name in NUMPY_SYNC_FUNCS:
                        mod.numpy_names.add("")   # bare-name from-import
    # index top-level functions and class methods (nested defs are scanned
    # as part of their parent's body, not resolved as call targets)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions.append(FuncInfo(mod, node, node.name, None))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    mod.functions.append(
                        FuncInfo(mod, sub, sub.name, node.name))
    return mod


def _names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class Linter:
    """One lint run over a source tree (default: the repro_torch package
    that contains this file)."""

    def __init__(self, src_root: Optional[pathlib.Path] = None):
        if src_root is None:
            src_root = pathlib.Path(__file__).resolve().parents[1]
        self.src_root = pathlib.Path(src_root)
        # repo-relative display prefix: .../repo/src/repro_torch -> src/repro_torch
        try:
            self.rel_base = self.src_root.relative_to(
                self.src_root.parents[1])
        except (IndexError, ValueError):
            self.rel_base = pathlib.Path(self.src_root.name)
        self.modules: List[ModuleInfo] = []
        for p in sorted(self.src_root.rglob("*.py")):
            mod = _collect_module(p, str(self.rel_base /
                                         p.relative_to(self.src_root)))
            if mod is not None:
                self.modules.append(mod)
        self.findings: List[Finding] = []

    # -- shared helpers --------------------------------------------------------

    def _emit(self, rule: str, mod: ModuleInfo, node: ast.AST, symbol: str,
              message: str) -> None:
        self.findings.append(Finding(rule=rule, path=mod.rel,
                                     line=getattr(node, "lineno", 0),
                                     symbol=symbol, message=message))

    @staticmethod
    def _enclosing(mod: ModuleInfo, node: ast.AST) -> str:
        """Qualname of the innermost indexed function containing ``node``
        (by line span), or <module>."""
        line = getattr(node, "lineno", 0)
        best, best_span = "<module>", None
        for fn in mod.functions:
            lo = fn.node.lineno
            hi = getattr(fn.node, "end_lineno", lo)
            if lo <= line <= hi and (best_span is None or hi - lo < best_span):
                best, best_span = fn.qualname, hi - lo
        return best

    def _module(self, suffix: str) -> Optional[ModuleInfo]:
        return next((m for m in self.modules
                     if m.rel.replace("\\", "/").endswith(suffix)), None)

    # -- rule: bare-assert -----------------------------------------------------

    def check_asserts(self) -> None:
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Assert):
                    self._emit(
                        "bare-assert", mod, node, self._enclosing(mod, node),
                        "assert vanishes under python -O; raise a typed "
                        "exception (BlockPoolError / ValueError) instead")

    # -- rule: host-sync (call-graph reachability) -----------------------------

    def _sync_sites(self, mod: ModuleInfo, root: ast.AST
                    ) -> List[Tuple[ast.AST, str]]:
        """Host-sync expressions inside ``root``: sync calls, and sync
        callables passed by reference (e.g. into run_in_executor)."""
        call_funcs = {id(n.func) for n in ast.walk(root)
                      if isinstance(n, ast.Call)}
        sites: List[Tuple[ast.AST, str]] = []
        for node in ast.walk(root):
            if isinstance(node, ast.Attribute):
                base = node.value
                is_np = (isinstance(base, ast.Name)
                         and base.id in mod.numpy_names)
                label = None
                if is_np and node.attr in NUMPY_SYNC_FUNCS:
                    label = f"np.{node.attr}"
                elif node.attr in SYNC_METHODS and id(node) in call_funcs:
                    label = f".{node.attr}()"
                if label is None:
                    continue
                if id(node) in call_funcs:
                    sites.append((node, f"{label} call"))
                else:
                    sites.append((node, f"{label} passed by reference"))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    "" in mod.numpy_names and \
                    node.func.id in NUMPY_SYNC_FUNCS:
                sites.append((node, f"{node.func.id} call"))
        return sites

    def _hot_reachable(self) -> List[FuncInfo]:
        """Functions reachable from HOT_ROOTS by bare-name call resolution
        over the HOT_PACKAGES modules (shared by the host-sync and
        telemetry-alloc rules)."""
        hot = [m for m in self.modules
               if any(f"/{pkg}/" in m.rel.replace("\\", "/")
                      for pkg in HOT_PACKAGES)]
        by_name: Dict[str, List[FuncInfo]] = {}
        for mod in hot:
            for fn in mod.functions:
                by_name.setdefault(fn.name, []).append(fn)

        def edges(fn: FuncInfo) -> List[FuncInfo]:
            out: List[FuncInfo] = []
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Name):
                    out.extend(by_name.get(node.func.id, []))
                elif isinstance(node.func, ast.Attribute):
                    out.extend(by_name.get(node.func.attr, []))
            return out

        roots = [fn for mod in hot for fn in mod.functions
                 if (fn.cls, fn.name) in HOT_ROOTS]
        seen: Set[Tuple[str, str]] = set()
        stack = list(roots)
        reached: List[FuncInfo] = []
        while stack:
            fn = stack.pop()
            key = (fn.module.rel, fn.qualname)
            if key in seen:
                continue
            seen.add(key)
            reached.append(fn)
            stack.extend(edges(fn))
        return reached

    def check_host_sync(self) -> None:
        for fn in self._hot_reachable():
            for node, what in self._sync_sites(fn.module, fn.node):
                self._emit(
                    "host-sync", fn.module, node, fn.qualname,
                    f"{what} is reachable from the hot plan/launch/commit "
                    "path; each step budgets exactly one device sync")

    # -- rule: telemetry-alloc -------------------------------------------------

    @staticmethod
    def _allocating_arg(node: ast.AST) -> Optional[str]:
        """Why ``node`` allocates a container per call, or None."""
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.Tuple)):
            return f"{type(node).__name__.lower()} literal"
        if isinstance(node, (ast.ListComp, ast.DictComp, ast.SetComp,
                             ast.GeneratorExp)):
            return "comprehension"
        if isinstance(node, ast.JoinedStr):
            return "f-string"
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ALLOC_BUILTINS:
            return f"{node.func.id}() call"
        return None

    def check_telemetry_alloc(self) -> None:
        """Telemetry calls on the hot path must pass scalars the caller
        already holds."""
        for fn in self._hot_reachable():
            for node in ast.walk(fn.node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                recv = node.func.value
                recv_name = None
                if isinstance(recv, ast.Name):
                    recv_name = recv.id
                elif isinstance(recv, ast.Attribute):
                    recv_name = recv.attr
                if recv_name not in TELEMETRY_RECEIVERS:
                    continue
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    why = self._allocating_arg(arg)
                    if why is not None:
                        self._emit(
                            "telemetry-alloc", fn.module, arg, fn.qualname,
                            f"{why} passed to {recv_name}.{node.func.attr}() "
                            "on the hot path — telemetry must record "
                            "scalars the caller already holds")

    # -- rule: kernel/ref parity -----------------------------------------------

    def check_kernel_ref_parity(self) -> None:
        kernels: Dict[str, ModuleInfo] = {}
        refs: Dict[str, ModuleInfo] = {}
        for mod in self.modules:
            rel = mod.rel.replace("\\", "/")
            if "/kernels/" not in rel:
                continue
            pkg = rel.rsplit("/", 2)[-2]
            if rel.endswith("/kernel.py"):
                kernels[pkg] = mod
            elif rel.endswith("/ref.py"):
                refs[pkg] = mod
        for pkg, kmod in kernels.items():
            rmod = refs.get(pkg)
            for fn in kmod.functions:
                if fn.cls or fn.name.startswith("_") or \
                        not fn.name.endswith("_kernel"):
                    continue
                ref_name = fn.name[:-len("_kernel")] + "_ref"
                rfn = None
                if rmod is not None:
                    rfn = next((f for f in rmod.functions
                                if f.name == ref_name and f.cls is None),
                               None)
                if rfn is None:
                    self._emit(
                        "kernel-ref-parity", kmod, fn.node, fn.qualname,
                        f"no {ref_name}() in kernels/{pkg}/ref.py — every "
                        "public kernel needs a plain PyTorch version")
                    continue
                kp = [a.arg for a in fn.node.args.args]
                rp = [a.arg for a in rfn.node.args.args]
                it = iter(kp)
                if not all(any(p == q for q in it) for p in rp):
                    self._emit(
                        "kernel-ref-parity", kmod, fn.node, fn.qualname,
                        f"{ref_name}({', '.join(rp)}) is not an ordered "
                        f"subsequence of {fn.name}({', '.join(kp)}) — the "
                        "parity tests assume call compatibility")

    # -- rule: ctypes-signature ------------------------------------------------

    @staticmethod
    def _c_kind(param: str) -> str:
        p = " ".join(param.replace("const", " ").split())
        if "*" in p:
            return "pointer"
        if "long long" in p:
            return "long long"
        if re.match(r"^(unsigned )?int\b", p):
            return "int"
        if p.startswith("float"):
            return "float"
        return f"unknown({p})"

    def c_signatures(self) -> Dict[str, List[Tuple[str, int, List[str]]]]:
        """``{name: [(file, line, kinds), ...]}`` of every ``extern "C"``
        function in ``csrc/*.cu`` and ``*.cuh``."""
        out: Dict[str, List[Tuple[str, int, List[str]]]] = {}
        csrc = self.src_root / "csrc"
        for p in sorted(csrc.glob("*.cu*")) if csrc.is_dir() else []:
            text = p.read_text()
            for m in _EXTERN_RE.finditer(text):
                params = [s.strip() for s in m.group(3).split(",") if s.strip()]
                if params == ["void"]:
                    params = []
                line = text.count("\n", 0, m.start()) + 1
                out.setdefault(m.group(2), []).append(
                    (p.name, line, [self._c_kind(s) for s in params]))
        return out

    @staticmethod
    def _ctypes_aliases(mod: ModuleInfo) -> Dict[str, str]:
        """Module-level names bound to ctypes types (``_vp, _i = ctypes.
        c_void_p, ctypes.c_int``) -> their kinds."""
        out: Dict[str, str] = {}
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt, val = node.targets[0], node.value
            pairs = (list(zip(tgt.elts, val.elts))
                     if isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple)
                     else [(tgt, val)])
            for t, v in pairs:
                if isinstance(t, ast.Name) and isinstance(v, ast.Attribute) \
                        and v.attr in _CTYPES_KIND:
                    out[t.id] = _CTYPES_KIND[v.attr]
        return out

    @classmethod
    def _kinds(cls, node: ast.AST, aliases: Dict[str, str]) -> Optional[List[str]]:
        """The argument kinds an ``argtypes`` expression builds: lists of
        ctypes types joined by ``+`` and repeated by ``*``."""
        if isinstance(node, ast.List):
            out = []
            for e in node.elts:
                k = cls._kind_of(e, aliases)
                if k is None:
                    return None
                out.append(k)
            return out
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            a, b = cls._kinds(node.left, aliases), cls._kinds(node.right, aliases)
            return None if a is None or b is None else a + b
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            lst, n = node.left, node.right
            if isinstance(lst, ast.Constant):
                lst, n = n, lst
            k = cls._kinds(lst, aliases)
            if k is None or not isinstance(n, ast.Constant):
                return None
            return k * int(n.value)
        return None

    @staticmethod
    def _kind_of(e: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
        if isinstance(e, ast.Name):
            return aliases.get(e.id)
        if isinstance(e, ast.Attribute):
            return _CTYPES_KIND.get(e.attr)
        if isinstance(e, ast.Call):
            f = e.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            return "pointer" if name == "POINTER" else None
        return None

    def binding_signatures(self) -> Tuple[Optional[ModuleInfo],
                                          Dict[str, Tuple[ast.AST, Optional[List[str]]]]]:
        """``{name: (node, kinds)}`` of the ctypes bindings in
        ``kernels/build.py``: ``_SIGNATURES``' entries and direct
        ``lib.<name>.argtypes = [...]`` assignments."""
        mod = self._module("kernels/build.py")
        out: Dict[str, Tuple[ast.AST, Optional[List[str]]]] = {}
        if mod is None:
            return None, out
        aliases = self._ctypes_aliases(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "_SIGNATURES" and \
                    isinstance(node.value, ast.Dict):
                for k, v in zip(node.value.keys, node.value.values):
                    if isinstance(k, ast.Constant):
                        out[k.value] = (k, self._kinds(v, aliases))
            elif isinstance(tgt, ast.Attribute) and tgt.attr == "argtypes" and \
                    isinstance(tgt.value, ast.Attribute):
                out[tgt.value.attr] = (tgt, self._kinds(node.value, aliases))
        return mod, out

    def check_ctypes_signatures(self) -> None:
        mod, bound = self.binding_signatures()
        if mod is None:
            return
        c = self.c_signatures()
        for name, (node, kinds) in sorted(bound.items()):
            sym = self._enclosing(mod, node)
            if kinds is None:
                self._emit("ctypes-signature", mod, node, sym,
                           f"{name}: argtypes not a list of ctypes types the "
                           "lint can read")
                continue
            if name not in c:
                self._emit("ctypes-signature", mod, node, sym,
                           f"{name} is bound but no extern \"C\" function of "
                           "csrc/ has that name")
                continue
            for fname, line, ckinds in c[name]:
                if ckinds != kinds:
                    self._emit(
                        "ctypes-signature", mod, node, sym,
                        f"{name}: csrc/{fname}:{line} takes {len(ckinds)} "
                        f"({', '.join(ckinds)}), the binding passes "
                        f"{len(kinds)} ({', '.join(kinds)})")
        for name, sites in sorted(c.items()):
            if name not in bound:
                fname, line, _ = sites[0]
                self._emit("ctypes-signature", mod, mod.tree, "<module>",
                           f"extern \"C\" {name} (csrc/{fname}:{line}) has no "
                           "argtypes in the binding")

    # -- rule: kernel-fallback -------------------------------------------------

    @staticmethod
    def _ref_names(mod: ModuleInfo) -> Set[str]:
        """Names of the plain version in an ops.py: ``*_ref``, what it
        imports from a ``ref`` module, and local functions calling those."""
        refs: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.split(".")[-1] == "ref":
                refs.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.Name) and node.id.endswith("_ref"):
                refs.add(node.id)
        changed = True
        while changed:
            changed = False
            for fn in mod.functions:
                if fn.cls is None and fn.name not in refs and \
                        _names(fn.node) & refs:
                    refs.add(fn.name)
                    changed = True
        return refs

    @staticmethod
    def _cuda_test(test: ast.AST) -> bool:
        """A branch test true for a CUDA tensor: ``== "cuda"``,
        ``.is_cuda``, ``!= "cpu"``."""
        for n in ast.walk(test):
            if isinstance(n, ast.Attribute) and n.attr == "is_cuda":
                return True
            if isinstance(n, ast.Compare) and len(n.ops) == 1:
                consts = [c.value for c in [n.left, *n.comparators]
                          if isinstance(c, ast.Constant)]
                if isinstance(n.ops[0], (ast.Eq, ast.In)) and "cuda" in consts:
                    return True
                if isinstance(n.ops[0], (ast.NotEq, ast.NotIn)) and "cpu" in consts:
                    return True
        return False

    def check_kernel_fallback(self) -> None:
        for mod in self.modules:
            rel = mod.rel.replace("\\", "/")
            if "/kernels/" not in rel or not rel.endswith("/ops.py"):
                continue
            refs = self._ref_names(mod)

            def emit(node, why):
                self._emit("kernel-fallback", mod, node,
                           self._enclosing(mod, node),
                           f"{why} reaches the plain version "
                           f"({', '.join(sorted(_names(node) & refs))}): a "
                           "CUDA tensor must take the kernel or raise")

            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Try):
                    for h in node.handlers:
                        if _names(h) & refs:
                            emit(h, "an exception handler")
                elif isinstance(node, ast.If) and self._cuda_test(node.test):
                    for stmt in node.body:
                        if _names(stmt) & refs:
                            emit(stmt, "a branch taken on a CUDA tensor")
                elif isinstance(node, ast.Dict):
                    for k, v in zip(node.keys, node.values):
                        if isinstance(k, ast.Constant) and k.value == "cuda" \
                                and _names(v) & refs:
                            emit(v, "the \"cuda\" entry of a dispatch dict")

    # -- the run ---------------------------------------------------------------

    def run(self) -> List[Finding]:
        self.findings = []
        self.check_asserts()
        self.check_host_sync()
        self.check_telemetry_alloc()
        self.check_kernel_ref_parity()
        self.check_ctypes_signatures()
        self.check_kernel_fallback()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    # -- suppression / baseline ------------------------------------------------

    def is_suppressed(self, f: Finding) -> bool:
        mod = next((m for m in self.modules if m.rel == f.path), None)
        if mod is None or f.line < 1:
            return False
        for ln in (f.line, f.line - 1):
            if 1 <= ln <= len(mod.lines):
                m = _ALLOW_RE.search(mod.lines[ln - 1])
                if m and f.rule in [s.strip() for s in
                                    m.group(1).split(",")]:
                    return True
        return False


@dataclasses.dataclass
class LintResult:
    active: List[Finding]
    suppressed: List[Finding]
    baselined: List[Finding]

    @property
    def ok(self) -> bool:
        return not self.active


def load_baseline(path: pathlib.Path) -> Dict[str, int]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {str(k): int(v) for k, v in data.get("entries", {}).items()}


def default_baseline_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "baseline.json"


def run_lint(src_root: Optional[pathlib.Path] = None,
             baseline_path: Optional[pathlib.Path] = None) -> LintResult:
    linter = Linter(src_root)
    findings = linter.run()
    baseline = load_baseline(baseline_path or default_baseline_path())
    remaining = dict(baseline)
    active: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        if linter.is_suppressed(f):
            suppressed.append(f)
        elif remaining.get(f.baseline_key, 0) > 0:
            remaining[f.baseline_key] -= 1
            baselined.append(f)
        else:
            active.append(f)
    return LintResult(active=active, suppressed=suppressed,
                      baselined=baselined)


def write_baseline(path: Optional[pathlib.Path] = None,
                   src_root: Optional[pathlib.Path] = None) -> pathlib.Path:
    """Grandfather every current unsuppressed finding: the gate then fails
    only on NEW violations.  Checked in so every run agrees."""
    path = path or default_baseline_path()
    linter = Linter(src_root)
    entries: Dict[str, int] = {}
    for f in linter.run():
        if not linter.is_suppressed(f):
            entries[f.baseline_key] = entries.get(f.baseline_key, 0) + 1
    path.write_text(json.dumps(
        {"comment": "grandfathered lint findings by rule::path::symbol; "
                    "regenerate with python -m repro_torch.analysis "
                    "--write-baseline",
         "entries": dict(sorted(entries.items()))}, indent=1) + "\n")
    return path

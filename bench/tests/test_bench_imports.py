"""Nothing the benchmark runs imports JAX, flax or the JAX package
(``repro``), top-level names compared whole; the plain reference imports
nothing of the program (``repro_torch``) either."""
import ast
import os
import subprocess
import sys

import bench_local

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules():
    for dirpath, _, files in os.walk(bench_local.BENCH):
        if "out" in dirpath.split(os.sep) or "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _modules()}
    assert not {p: b for p, b in bad.items() if b}
    # the port's name begins with the JAX package's: whole names differ
    assert "repro_torch" not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(bench_local.BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(_imports(os.path.join(ref, f)))
            assert not tops & (FORBIDDEN | {"repro_torch", "harness"}), (f, tops)


def test_a_run_loads_none_of_them():
    """A reduced run in a fresh process leaves no JAX module loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import bench_local\n"
        "bench_local.run_tiny('qwen3-0.6b.distill', seconds=0.1)\n"
        "from harness.main import forbidden_modules\n"
        "print(forbidden_modules())\n") % os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

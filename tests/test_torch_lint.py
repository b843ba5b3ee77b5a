"""The port's analysis gate (``repro_torch.analysis``): each lint rule fires
on a seeded violation in a synthetic tree and is quiet under its
suppression comment, the repo is clean apart from the baseline, the CLI
exits 0, and JAX's two retrace-watchdog cases hold on the port's engine
(reduced qwen1.5-0.5b on the CPU), as ``tests/test_analysis.py`` holds them
on JAX's.
"""
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.analysis import lint as L
from repro_torch.analysis.lint import Linter, run_lint
from repro_torch.analysis.retrace import RetraceError, RetraceWatchdog
from repro_torch.models import build_model, get_config
from repro_torch.serving import Engine, SamplingParams, ServeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tree(tmp_path: pathlib.Path, files) -> Linter:
    """Materialize {relpath: source} under tmp_path/src/repro_torch."""
    root = tmp_path / "src" / "repro_torch"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return Linter(root)


def _rules(linter: Linter, suppressed: bool = False):
    return sorted({f.rule for f in linter.run()
                   if linter.is_suppressed(f) == suppressed})


class TestLintRules:
    def test_repo_is_clean_modulo_baseline(self):
        res = run_lint()
        assert res.ok, "\n".join(f.render() for f in res.active)
        # the reasoned host-sync allowances on the hot path, and nothing else
        assert sorted({f.rule for f in res.suppressed}) == ["host-sync"]
        assert {f.symbol for f in res.suppressed} == {
            "Engine.sync_tokens", "Engine._to_device", "Engine._kv_block_digests"}

    def test_the_rules(self):
        assert set(L.RULES) == {"host-sync", "bare-assert", "kernel-ref-parity",
                                "telemetry-alloc", "ctypes-signature",
                                "kernel-fallback"}

    @pytest.mark.parametrize("allow", [False, True])
    def test_bare_assert(self, tmp_path, allow):
        lint = _tree(tmp_path, {"mod.py": f"""
            def f(x):
                {"# lint: allow(bare-assert) a test helper" if allow else ""}
                assert x > 0
                return x
        """})
        assert _rules(lint, suppressed=allow) == ["bare-assert"]
        assert _rules(lint, suppressed=not allow) == []

    def test_host_sync_reachable_from_hot_path(self, tmp_path):
        lint = _tree(tmp_path, {"serving/engine.py": """
            import numpy as np

            def helper(x):
                return np.asarray(x)      # reached via plan_step -> helper

            def cold(x):
                return np.asarray(x)      # NOT reachable: no finding

            class Engine:
                def plan_step(self):
                    return helper(self.tok)
        """})
        fs = [f for f in lint.run() if f.rule == "host-sync"]
        assert [f.symbol for f in fs] == ["helper"]

    def test_host_sync_by_reference_and_item(self, tmp_path):
        lint = _tree(tmp_path, {"serving/async_engine.py": """
            import numpy as np

            class AsyncEngine:
                async def _loop(self, ex, tok):
                    a = await ex.run(np.asarray, tok)   # passed by reference
                    return a.item()                     # sync method call
        """})
        msgs = [f.message for f in lint.run() if f.rule == "host-sync"]
        assert len(msgs) == 2
        assert any("passed by reference" in m for m in msgs)

    def test_host_sync_torch_forms(self, tmp_path):
        lint = _tree(tmp_path, {"serving/engine.py": """
            import torch

            class Engine:
                def launch_step(self, t, ev):
                    a = t.tolist()
                    b = t.cpu()
                    torch.cuda.synchronize()
                    ev.synchronize()
                    return a, b.numpy()

                def warmup(self, t):
                    return t.cpu()            # cold: no finding
        """})
        msgs = sorted(f.message.split(" call")[0] for f in lint.run()
                      if f.rule == "host-sync")
        assert msgs == [".cpu()", ".numpy()", ".synchronize()", ".synchronize()",
                        ".tolist()"]

    def test_host_sync_suppression_comment(self, tmp_path):
        lint = _tree(tmp_path, {"serving/engine.py": """
            class Engine:
                def commit_step(self):
                    # lint: allow(host-sync) the one budgeted sync
                    self.ready.synchronize()
        """})
        assert _rules(lint) == []
        assert _rules(lint, suppressed=True) == ["host-sync"]

    def test_telemetry_alloc_in_hot_path(self, tmp_path):
        lint = _tree(tmp_path, {"serving/engine.py": """
            class Engine:
                def commit_step(self, step):
                    self.tracer.commit_span(0.0, 1.0, step)          # scalars
                    self.recorder.record("commit", uids=[1, 2])
                    self.recorder.record("note", msg=f"step {step}")

                def post_mortem(self):
                    # cold path: same pattern, no finding
                    return self.recorder.dump("done", uids=list(self._u))
        """})
        fs = [f for f in lint.run() if f.rule == "telemetry-alloc"]
        assert len(fs) == 2
        assert all(f.symbol == "Engine.commit_step" for f in fs)
        assert any("list literal" in f.message for f in fs)
        assert any("f-string" in f.message for f in fs)

    def test_telemetry_alloc_suppression(self, tmp_path):
        lint = _tree(tmp_path, {"serving/engine.py": """
            class Engine:
                def plan_step(self):
                    # lint: allow(telemetry-alloc) dumped once per fault
                    self.recorder.record("plan", uids=[1])
        """})
        assert _rules(lint) == []
        assert _rules(lint, suppressed=True) == ["telemetry-alloc"]

    def test_kernel_ref_parity(self, tmp_path):
        files = {"kernels/k/kernel.py": """
            def fused_op_kernel(x, w, route=None):
                return x
        """, "kernels/k/ref.py": """
            def fused_op_ref(x, w):
                return x
        """}
        assert "kernel-ref-parity" not in _rules(_tree(tmp_path / "a", files))
        files["kernels/k/ref.py"] = """
            def fused_op_ref(w, x):      # transposed params: not a subsequence
                return x
        """
        assert "kernel-ref-parity" in _rules(_tree(tmp_path / "b", files))
        files["kernels/k/kernel.py"] = """
            # lint: allow(kernel-ref-parity) the plain version is transposed
            def fused_op_kernel(x, w, route=None):
                return x
        """
        lint = _tree(tmp_path / "c", files)
        assert _rules(lint, suppressed=True) == ["kernel-ref-parity"]

    def test_baseline_grandfathers_by_count(self, tmp_path):
        root = tmp_path / "src" / "repro_torch"
        (root / "pkg").mkdir(parents=True)
        (root / "pkg" / "m.py").write_text(
            "def f(x):\n    assert x\n    assert x > 1\n")
        bl = tmp_path / "baseline.json"
        bl.write_text(json.dumps(
            {"entries": {"bare-assert::src/repro_torch/pkg/m.py::f": 1}}))
        res = L.run_lint(root, bl)
        assert len(res.baselined) == 1    # one grandfathered...
        assert len(res.active) == 1       # ...the second assert still fails


_CU = """
#include <cuda_runtime.h>
extern "C" int k_launch(const void* x, void* y, int n, long long m,
                        float s, void* stream) {
  return 0;
}
extern "C" void k_info(long long* out) { out[0] = 1; }
"""


def _binding(launch: str, allow: str = "") -> str:
    return f"""
        import ctypes

        _vp, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        _SIGNATURES = {{
            {allow}
            "k_launch": {launch},
            "k_info": [ctypes.POINTER(_ll)],
        }}
    """


class TestCtypesSignature:
    def _lint(self, tmp_path, launch, allow=""):
        lint = _tree(tmp_path, {"kernels/build.py": _binding(launch, allow)})
        (tmp_path / "src" / "repro_torch" / "csrc").mkdir()
        (tmp_path / "src" / "repro_torch" / "csrc" / "k.cu").write_text(_CU)
        return lint

    def test_matching_binding_is_clean(self, tmp_path):
        lint = self._lint(tmp_path, "[_vp] * 2 + [_i, _ll, _f, _vp]")
        assert _rules(lint) == []

    @pytest.mark.parametrize("launch, what", [
        ("[_vp] * 2 + [_i, _ll, _f]", "takes 6"),          # one argument short
        ("[_vp] * 2 + [_i, _i, _f, _vp]", "long long"),    # int for long long
    ])
    def test_mismatch_fires(self, tmp_path, launch, what):
        lint = self._lint(tmp_path, launch)
        fs = [f for f in lint.run() if f.rule == "ctypes-signature"]
        assert len(fs) == 1 and "k_launch" in fs[0].message and what in fs[0].message

    def test_unbound_and_unknown_functions_fire(self, tmp_path):
        lint = _tree(tmp_path, {"kernels/build.py": """
            import ctypes
            _SIGNATURES = {"gone_launch": [ctypes.c_int]}
        """})
        (tmp_path / "src" / "repro_torch" / "csrc").mkdir()
        (tmp_path / "src" / "repro_torch" / "csrc" / "k.cu").write_text(_CU)
        msgs = [f.message for f in lint.run() if f.rule == "ctypes-signature"]
        assert any("gone_launch is bound but" in m for m in msgs)
        assert any("k_launch" in m and "no argtypes" in m for m in msgs)
        assert any("k_info" in m and "no argtypes" in m for m in msgs)

    def test_suppressed(self, tmp_path):
        lint = self._lint(tmp_path, "[_vp] * 2 + [_i, _ll, _f]",
                          allow="# lint: allow(ctypes-signature) checked by hand")
        assert _rules(lint) == []
        assert _rules(lint, suppressed=True) == ["ctypes-signature"]

    def test_repo_bindings_are_read(self):
        lint = Linter()
        c = lint.c_signatures()
        _, bound = lint.binding_signatures()
        assert set(c) == set(bound) and len(c) >= 15
        assert all(kinds is not None for _, kinds in bound.values())


_OPS_HEAD = """
import torch
from repro_torch.kernels.k.kernel import k_kernel
from repro_torch.kernels.k.ref import k_ref
"""


def _ops(body: str) -> str:
    return _OPS_HEAD + textwrap.dedent(body)


class TestKernelFallback:
    @pytest.mark.parametrize("body", [
        # a try around the kernel whose handler runs the plain version
        """
        def k(x):
            if x.device.type == "cuda":
                try:
                    return k_kernel(x)
                except RuntimeError:
                    return k_ref(x)
            return k_ref(x)
        """,
        # the plain version on a branch a CUDA tensor takes
        """
        def k(x):
            if x.device.type != "cpu":
                return k_ref(x)
            return k_kernel(x)
        """,
        # a dispatch dict whose "cuda" entry is a local wrapper of the ref
        """
        def _plain(x):
            return k_ref(x)

        _IMPLS = {"cuda": _plain, "cpu": k_ref}
        """,
    ])
    def test_fires(self, tmp_path, body):
        lint = _tree(tmp_path, {"kernels/k/ops.py": _ops(body)})
        assert "kernel-fallback" in _rules(lint)

    def test_clean_dispatch(self, tmp_path):
        lint = _tree(tmp_path, {"kernels/k/ops.py": _ops("""
        _IMPLS = {"cuda": k_kernel, "cpu": k_ref}

        def k(x):
            if x.is_cuda:
                return k_kernel(x)
            if x.device.type == "cpu":
                return k_ref(x)
            raise ValueError(x.device)
        """)})
        assert _rules(lint) == []

    def test_suppressed(self, tmp_path):
        lint = _tree(tmp_path, {"kernels/k/ops.py": _ops("""
        def k(x):
            if x.is_cuda:
                # lint: allow(kernel-fallback) the backward's recompute, by design
                return k_ref(x)
            return k_ref(x)
        """)})
        assert _rules(lint) == []
        assert _rules(lint, suppressed=True) == ["kernel-fallback"]


def test_cli_exits_0():
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--retrace-smoke"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "analysis: ok" in r.stdout
    assert "caught : a new block-table width after freeze" in r.stdout


# -- the step-signature watchdog on the port's engine -----------------------------


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("qwen1.5-0.5b").reduced(layers=2).replace(
        compute_dtype="float32", param_dtype="float32")
    return cfg, build_model(cfg, gen=torch.Generator().manual_seed(0), device="cpu")


def _engine(lm, **kw):
    cfg, model = lm
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 32)
    kw.setdefault("kv_block_size", 4)
    kw.setdefault("paged", True)
    return Engine(cfg, model, ServeConfig(**kw))


class TestRetraceWatchdog:
    def test_steady_state_decode_meets_no_new_signature(self, lm):
        """Run a workload to completion, freeze, run the same-shaped
        workload again: every step impl meets only signatures it has seen,
        and nothing builds (the CPU has no kernels to build)."""
        eng = _engine(lm, prefill_chunk=4)
        wd = RetraceWatchdog.attach(eng)   # before the first step
        try:
            sp = SamplingParams(max_tokens=6, ignore_eos=True)

            def pass_once():
                for p in ([1, 2, 3, 4, 5], [6, 7, 8, 9, 10]):
                    eng.submit(p, sp)
                for _ in eng.stream():
                    pass

            pass_once()                        # warm-up: meets every signature
            wd.check()
            assert wd.calls_per_impl().get("_decode_impl", 0) >= 1
            seen = dict(wd.counts)
            wd.freeze()
            pass_once()                        # steady state: no new signature
            wd.check()
            assert set(wd.counts) == set(seen) and wd.builds == 0
        finally:
            wd.detach()

    def test_new_signature_after_freeze_flagged(self, lm):
        eng = _engine(lm, prefill_chunk=4)
        wd = RetraceWatchdog.attach(eng)
        try:
            sp = SamplingParams(max_tokens=4, ignore_eos=True)
            eng.submit([1, 2, 3], sp)
            for _ in eng.stream():
                pass
            wd.freeze()
            # a much longer prompt needs a wider block table: a new signature
            eng.submit(list(range(1, 25)), sp)
            for _ in eng.stream():
                pass
            with pytest.raises(RetraceError, match="freeze"):
                wd.check()
        finally:
            wd.detach()

    def test_a_build_after_freeze_is_flagged(self, lm, monkeypatch):
        from repro_torch.kernels import build as kb
        eng = _engine(lm, prefill_chunk=4)
        fake = kb.BuildInfo(pathlib.Path("lib.so"), 19.6, "")
        monkeypatch.setattr(kb, "build", lambda: fake)
        monkeypatch.setattr(kb, "_lib", None)
        wd = RetraceWatchdog.attach(eng)
        try:
            wd.freeze()
            kb.build()                         # what a first launch would do
            assert wd.builds == 1
            with pytest.raises(RetraceError, match="built"):
                wd.check()
        finally:
            wd.detach()
        assert kb.build() is fake

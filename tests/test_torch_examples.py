"""The port's examples (``examples_torch/``) against JAX's (``examples/``) on
the CPU, on the same inputs: JAX's parameters and draws carried across by
``bridge.py``, each example's function called with ``device="cpu"`` and,
where the JAX file trains, its steps cut.

* quickstart: JAX's own file run (``runpy``), its PRNGKey(0) init and its
  batch given to the port's step: loss and grad_norm rtol 1e-5, the
  ternary histogram and the boundary mass equal, Δ within 2 ulp (the
  port's absmean sums in float64, JAX's in fp32: ROADMAP "absmean Δ").
* long_context_ssm: the decode state's bytes equal JAX's ``tree_bytes``,
  the logits after the groups at positions 0 and 524,288 rtol 1e-5 (81
  fp32 decode steps of the recurrence), the KV GiB equal.
* serve_batch: ``convert_to_packed`` on the same QAT params packs the same
  bytes (Δ to 2 ulp; the params are a PRNGKey(0) init, where JAX's
  conversion, which returns its init template for repeat-stacked leaves,
  coincides with converting them: ROADMAP Queue C) and the two engines
  serve the 8 cnndm-syn prompts, 4 up front and 4 injected after the first
  step, with greedy tokens equal token for token; the whole example at 2
  steps prints its lines.
* bitdistill_pipeline: at ``--steps 8`` the four-line results table
  prints (stage parity with JAX is tests/test_torch_train.py's).
* No example imports ``jax`` or ``repro``; without a card the default
  device exits non-zero with a message that names it.
"""
import ast
import dataclasses
import importlib.util
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.models import build_model as jbuild, get_config as jget
from repro.nn.module import tree_bytes as jtree_bytes
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import Engine as JEngine, ServeConfig as JServeConfig
from repro.serving.engine import convert_to_packed as jconvert
from repro_torch.bridge import jax_params_from_torch, jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.models import get_config
from repro_torch.nn.module import flatten_with_paths
from test_torch_engine import _drive

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
NAMES = ("quickstart", "long_context_ssm", "serve_batch", "bitdistill_pipeline")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the examples' models are tiny, and beside other
    test workers a thread pool per process spends their steps waiting on
    its own barriers (the pipeline test took 725 s so, ~8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ulps(got, want):
    return abs(float(got) - float(want)) / float(np.spacing(np.float32(want)))


def test_quickstart_matches_jax(capsys):
    g = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    capsys.readouterr()
    ex = _example("quickstart")
    cfg = get_config("qwen2.5-3b").reduced()
    model = jax_params_to_torch(cfg.with_quant(TQ.QAT), _np(g["params"]), device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in g["batch"].items()}
    got = ex.quickstart(cfg, "cpu", model=model, batch=batch)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "arch=qwen2.5-3b  layers=2  d_model=128"
    assert lines[-1] == "quickstart OK" and len(lines) == 5
    np.testing.assert_allclose(got["loss"], float(g["metrics"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(g["metrics"]["grad_norm"]),
                               rtol=1e-5)
    assert got["histogram"] == [int(c) for c in g["hist"]]
    assert _ulps(got["delta"], g["delta"]) <= 2
    assert got["boundary_mass"] == float(JQ.boundary_mass(g["w"]))


def test_long_context_ssm_matches_jax(capsys):
    positions = (0, 1_000, 100_000, 524_288)
    jcfg = jget("mamba2-780m").reduced().with_quant(JQ.QAT)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    cache = jmodel.init_cache(params, 2, 1, jnp.float32)
    state_bytes = jtree_bytes(cache)
    decode = jax.jit(jmodel.decode_step)
    tok = jnp.array([1, 2], jnp.int32)
    logits, cache = decode(params, tok, cache, jnp.int32(0))
    want = {}
    for pos in positions:
        for _ in range(20):
            logits, cache = decode(params, tok, cache, jnp.int32(pos))
        want[pos] = np.asarray(logits)

    ex = _example("long_context_ssm")
    cfg = get_config("mamba2-780m").reduced()
    model = jax_params_to_torch(cfg.with_quant(TQ.QAT), _np(params), device="cpu")
    got = ex.long_context(cfg, "cpu", model=model)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("long-context OK")
    assert got["state_bytes"] == state_bytes
    for pos in (0, 524_288):
        np.testing.assert_allclose(got["logits"][pos].numpy(), want[pos], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want[pos]).max()),
                                   err_msg=f"position {pos}")
    att = jget("qwen2.5-3b")
    kv = att.n_layers * att.n_kv_heads * att.head_dim * 524_288 * 2 * 2
    assert got["kv_gib"] == kv / 2**30
    assert f"would be {kv / 2**30:.1f} GiB per sequence" in out


def _jax_example_cfg(name):
    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"))["CFG"]


@pytest.mark.parametrize("name", ["serve_batch", "bitdistill_pipeline"])
def test_configs_are_the_jax_examples(name):
    want = dataclasses.asdict(_jax_example_cfg(name))
    got = dataclasses.asdict(_example(name).CFG)
    want.pop("quant"), got.pop("quant")
    assert got == want


def test_serve_batch_packs_and_serves_as_jax(capsys):
    ex = _example("serve_batch")
    jcfg = _jax_example_cfg("serve_batch").with_quant(JQ.QAT)
    qat = jbuild(jcfg).init(jax.random.PRNGKey(0))
    jpcfg, jpacked = jconvert(jcfg, qat)
    qcfg = ex.CFG.with_quant(TQ.QAT)
    student = jax_params_to_torch(qcfg, _np(qat), device="cpu")
    prompts = ex.cnndm_prompts()
    got = ex.serve(qcfg, student, prompts)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("weight bytes: qat fp32 ")
    assert lines[1].startswith("served 8 requests / ") and "on the CPU" in lines[1]
    assert got["packed_bytes"] == jtree_bytes(jpacked)
    assert got["qat_bytes"] == jtree_bytes(qat)
    # the packed model: codes bitwise, Δ to 2 ulp, every other leaf equal
    port = flatten_with_paths(jax_params_from_torch(got["packed_cfg"],
                                                    got["packed_model"]))
    want = flatten_with_paths(_np(jpacked))
    assert set(port) == set(want)
    for k, w in want.items():
        if k.endswith("delta"):
            np.testing.assert_allclose(port[k], w, rtol=2.5e-7, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], w, err_msg=k)
    # the same prompts and injection schedule through JAX's engine
    eos = 258
    plen = max(len(p) for p in prompts)
    jeng = JEngine(jpcfg, jpacked, JServeConfig(max_batch=4, max_len=plen + 10,
                                                eos_id=eos))
    jout = _drive(jeng, {0: prompts[:4], 1: prompts[4:]}, JSamplingParams(max_tokens=10))
    assert got["outputs"] == [jout[uid] for uid in sorted(jout)]
    assert got["attn_impl"] == "gather"


def test_serve_batch_example_runs(capsys):
    ex = _example("serve_batch")
    got = ex.main(["--device", "cpu", "--steps", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("training teacher + distilling student")
    assert lines[2].startswith("served 8 requests / ")
    assert len(lines) == 6 and got["requests"] == 8 and got["train_steps"] == 2
    assert all(len(o) == 10 or f == "stop" for o, f in zip(got["outputs"], got["finish"]))


def test_bitdistill_pipeline_prints_the_table(capsys):
    got = _example("bitdistill_pipeline").main(["--device", "cpu", "--steps", "8"])
    out = capsys.readouterr().out.splitlines()
    table = out[out.index("== results ==") + 1:]
    assert [line[:24].rstrip() for line in table[:3]] == [
        "FP16-SFT (teacher)", "BitNet-SFT", "BitDistill (ours)"]
    assert table[3].startswith("gap closed: ") and len(table) == 4
    assert table[2].split()[-1] == f"{got['bitdistill_acc']:.3f}"
    assert np.isfinite([got["ct_loss_first"], got["ct_loss_final"],
                        got["distill_loss_final"]]).all()


@pytest.mark.parametrize("name", ["quickstart", "long_context_ssm"])
def test_examples_run_on_the_cpu(name, capsys):
    _example(name).main(["--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith(
        {"quickstart": "quickstart OK", "long_context_ssm": "long-context OK"}[name])


@pytest.mark.parametrize("name", NAMES)
def test_default_device_needs_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")
    with pytest.raises(SystemExit) as ei:
        _example(name).main([])
    assert "torch.cuda.is_available() is False" in str(ei.value.code)


@pytest.mark.parametrize("name", NAMES)
def test_examples_import_neither_jax_nor_repro(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    top = {m.split(".")[0] for m in mods}
    assert "jax" not in top and "repro" not in top, sorted(mods)
    assert "repro_torch" in top

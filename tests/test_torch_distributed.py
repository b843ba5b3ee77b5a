"""Port vs JAX: the distributed layer over four CPU ranks — the int8
error-feedback all-reduce, GPipe, the CE step under a sharding plan, and
the launcher's ``--dp`` — on gloo.

The ranks are subprocesses (``tests/_torch_dist_worker.py``, one gloo group
over a file store, one thread each), started once for the module, as
tests/test_multidevice.py starts its JAX subprocesses; the launcher's runs
go beside them.  The JAX references run here, on one device.  Tolerances:

* ``compressed_psum``: bitwise against JAX's under ``jax.vmap(axis_name=
  "pod")``, both rounds, mean and residual, on every rank (the same IEEE
  operations in the same order); and JAX's own test's bounds on the
  compression (rel < 0.02 against the exact mean, max|err| < max|x|/50).
* GPipe: rtol/atol 2e-5 against the dense composition (JAX's test); the
  two stages of a reduced qwen3 stack exactly ``Stack.forward`` (the same
  blocks on the same tensors).
* The dp 2 x tp 2 FP step (qwen1.5-0.5b reduced, JAX's params, JAX's
  test's AdamW: no decay, no clip, lr 1e-3): loss rel 1e-5 against JAX's
  single-device step and every leaf within 5e-3 (JAX's test's bound: Adam's
  first step moves an element by ~lr·sign(g)), loss rel 1e-6 against the
  port's unsharded step (each rank's share of the NLL sum over the
  batch's mask count: fp32 summation order only).
* The pods 2 x tp 2 QAT step (qwen3-0.6b reduced, int8 moments, grad_clip
  1.0, two steps) against the port's unsharded step: losses and grad_norm
  rel 1e-6 (the gradients differ by summation order, ~1e-6 relative); the
  moments' block scales and fp32 moments rel 1e-4 (read: 2.3e-5 on a
  2e-6 element); their int8 codes within one step, one in 10^3 of them
  differing (read: at most one of 16,384 to 65,536 a leaf); parameters
  within 2·lr (Adam's step is ~lr·sign(g)), but for one in 10^3 of a leaf
  (read: 2 of 16,384, 5.4·lr apart): where the second step's gradient is
  ~0 and a decoded 8-bit moment is not, the step is ~m/|g| and summation
  order sets it.
* Each rank holds the plan's share of every parameter and moment: its
  local shape is the global shape divided along the plan's spec.
* The launcher: ``--dp 2`` over two ranks prints the losses ``--dp 1``
  prints, its checkpoint's leaves equal --dp 1's within 1e-5; a checkpoint
  written at one mesh and re-saved after resuming at the other is the same
  bytes.
"""
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import compressed_psum as jcompressed_psum
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.training import optimizer as JO, trainer as JTr
from repro_torch import bridge
from repro_torch.checkpoint.ckpt import _read_payload
from repro_torch.core import quant as TQ
from repro_torch.distributed.sharding import ShardingPlan, default_rules
from repro_torch.models import build_model, get_config
from repro_torch.nn.module import flatten_with_paths
from repro_torch.training.optimizer import AdamW, AdamWConfig, Moment8
from repro_torch.training.trainer import (init_train_state, jax_ranks,
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
TIMEOUT = 240


def _inputs():
    rng = np.random.default_rng(24)
    f32 = np.float32
    inp = {
        "psum/x1": (rng.standard_normal((4, 2500)) * 3).astype(f32),
        "psum/x2": (rng.standard_normal((4, 2500)) * 3).astype(f32),
        "gpipe/ws": (rng.standard_normal((4, 16, 16)) * 0.3).astype(f32),
        "gpipe/xs": rng.standard_normal((8, 4, 16)).astype(f32),
        "stack/xs": rng.standard_normal((2, 2, 8, 128)).astype(f32),
    }
    for prefix, vocab in (("fp", 200), ("qat0", 288), ("qat1", 288)):
        inp[f"{prefix}/tokens"] = rng.integers(0, vocab, (8, 16)).astype(np.int32)
        inp[f"{prefix}/labels"] = rng.integers(0, vocab, (8, 16)).astype(np.int32)
        mask = np.ones((8, 16), f32)
        if prefix != "fp":
            mask[:, :3] = 0.0          # a prompt the CE does not count
        inp[f"{prefix}/loss_mask"] = mask
    params = jbuild(jget("qwen1.5-0.5b").reduced()).init(jax.random.PRNGKey(0))
    for k, v in flatten_with_paths(jax.tree_util.tree_map(np.asarray, params)).items():
        inp[f"fp/params/{k}"] = v
    return inp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _launch(ckpt: Path, dp: int, steps: int, log: Path, pipe: bool = False):
    """The train launcher over ``dp`` ranks (the environment
    ``torch.distributed.run`` would give them), or alone at ``dp`` 1;
    ``pipe``: rank 0's output to a pipe, not to ``log``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", str(steps),
           "--batch", "4", "--seq", "32", "--log-every", "1", "--dp", str(dp),
           "--ckpt-dir", str(ckpt)]
    env = [_env()] if dp == 1 else [
        _env(RANK=r, LOCAL_RANK=r, WORLD_SIZE=dp, MASTER_ADDR="127.0.0.1",
             MASTER_PORT=port) for port in [_free_port()] for r in range(dp)]
    return [subprocess.Popen(
        cmd, env=e, cwd=ROOT, text=True,
        stdout=(subprocess.PIPE if pipe else open(log, "w")) if r == 0
        else open(log.with_suffix(f".{r}"), "w"),
        stderr=subprocess.STDOUT) for r, e in enumerate(env)]


def _sigterm_one_rank(io: Path, procs) -> str:
    """``procs``: ``--dp 2`` for 50 steps, rank 0's output piped; SIGTERM to
    rank 1 alone once rank 0 has printed step 1 -> rank 0's output (both
    ranks must exit 0)."""
    lines = []
    try:
        for line in procs[0].stdout:
            lines.append(line)
            if line.startswith("step 1 "):
                procs[1].send_signal(signal.SIGTERM)
                break
        rest, _ = procs[0].communicate(timeout=TIMEOUT)
        lines.append(rest)
        procs[1].wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    (io / "sigterm.log").write_text("".join(lines))
    _wait(procs, [io / "sigterm.log", io / "sigterm.1"])
    return "".join(lines)


def _wait(procs, logs):
    for p in procs:
        try:
            rc = p.wait(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
        assert rc == 0, "\n".join(Path(l).read_text()[-3000:] for l in logs
                                  if Path(l).exists())


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    io = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(io / "inputs.npz", **inp)
    logs = [io / f"rank{r}.log" for r in range(4)]
    ranks = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "4", str(io / "store"), str(io)],
        env=_env(), cwd=ROOT, stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
        for r in range(4)]
    # the launcher at --dp 2 and at --dp 1, and at --dp 2 to be stopped,
    # beside the ranks
    runs = {dp: _launch(io / f"ckpt_dp{dp}", dp, 2, io / f"launch_dp{dp}.log")
            for dp in (2, 1)}
    _sigterm_one_rank(io, _launch(io / "ckpt_sigterm", 2, 50, io / "sigterm.log",
                                  pipe=True))
    _wait(ranks, logs)
    for dp, procs in runs.items():
        _wait(procs, [io / f"launch_dp{dp}.log"])
    # each checkpoint resumed at the other mesh and saved again
    for src, dp in ((2, 1), (1, 2)):
        shutil.copytree(io / f"ckpt_dp{src}", io / f"resume_{src}_at_{dp}")
    resumed = {dp: _launch(io / f"resume_{src}_at_{dp}", dp, 2,
                           io / f"resume_{src}_at_{dp}.log")
               for src, dp in ((2, 1), (1, 2))}
    outs = [torch.load(io / f"out_{r}.pt", weights_only=False) for r in range(4)]
    for dp, procs in resumed.items():
        _wait(procs, [io / f"resume_{3 - dp}_at_{dp}.log"])
    return inp, outs, io


# -- compressed_psum ----------------------------------------------------------------

def test_compressed_psum_matches_jax(job):
    inp, outs, _ = job
    f = jax.vmap(lambda x, e: jcompressed_psum(x, "pod", e), axis_name="pod")
    y1, e1 = f(jnp.asarray(inp["psum/x1"]), jnp.zeros((4, 2500), jnp.float32))
    y2, e2 = f(jnp.asarray(inp["psum/x2"]), e1)
    for r, out in enumerate(outs):
        for name, want in (("y1", y1), ("e1", e1), ("y2", y2), ("e2", e2)):
            np.testing.assert_array_equal(out[f"psum/{name}"], np.asarray(want)[r],
                                          err_msg=f"rank {r} {name}")


def test_compressed_allreduce_over_the_pod_axis_matches_jax(job):
    """``make_compressed_allreduce(mesh, "pod")`` on mesh (pod 2, data 1,
    model 2): ranks {0, 2} and {1, 3} are its pod groups; each leaf of the
    tree is JAX's ``compressed_psum`` over its group, bitwise."""
    inp, outs, _ = job
    f = jax.vmap(lambda x, e: jcompressed_psum(x, "pod", e), axis_name="pod")
    x = inp["psum/x1"]
    for group in ((0, 2), (1, 3)):
        for leaf, cols in (("a", slice(0, 2000)), ("b", slice(2000, 2500))):
            xs = jnp.asarray(x[list(group), cols])
            mean, err = f(xs, jnp.zeros_like(xs))
            for i, r in enumerate(group):
                for name, want in (("means", mean), ("errs", err)):
                    got = outs[r][f"pod/{name}"][leaf]
                    np.testing.assert_array_equal(
                        got.reshape(-1), np.asarray(want)[i], err_msg=f"{r} {leaf}")


def test_compressed_psum_bounds(job):
    """JAX's test's bounds: every rank the same mean, near the exact one;
    the residual is what quantization dropped."""
    inp, outs, _ = job
    x1 = inp["psum/x1"]
    exact = x1.mean(axis=0)
    for out in outs:
        np.testing.assert_array_equal(out["psum/y1"], outs[0]["psum/y1"])
        assert np.linalg.norm(out["psum/y1"] - exact) / np.linalg.norm(exact) < 0.02
    err = np.stack([o["psum/e1"] for o in outs])
    assert np.max(np.abs(err)) < np.max(np.abs(x1)) / 50


# -- GPipe ----------------------------------------------------------------------------

def test_gpipe_matches_dense(job):
    inp, outs, _ = job
    ref = inp["gpipe/xs"]
    for w in inp["gpipe/ws"]:
        ref = np.tanh(ref @ w)
    for out in outs:
        np.testing.assert_allclose(out["gpipe"], ref, rtol=2e-5, atol=2e-5)


def test_two_stage_stack_equals_stack_forward(job):
    _, outs, _ = job
    for out in outs[:2]:
        np.testing.assert_array_equal(out["stack/got"], outs[0]["stack/want"])


# -- the CE step under a plan ------------------------------------------------------------

def _batch(inp, prefix, lib):
    return {k: lib(inp[f"{prefix}/{k}"]) for k in ("tokens", "labels", "loss_mask")}


def _fp_params(inp):
    flat = {k[len("fp/params/"):]: v for k, v in inp.items() if k.startswith("fp/params/")}
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def test_fp_step_matches_jax_single_device(job):
    inp, outs, _ = job
    jm = jbuild(jget("qwen1.5-0.5b").reduced())
    opt = JO.AdamW(JO.AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    params = jax.tree_util.tree_map(jnp.asarray, _fp_params(inp))
    s1, m1 = jax.jit(JTr.make_train_step(jm, opt, lambda s: 1e-3))(
        JTr.init_train_state(params, opt), _batch(inp, "fp", jnp.asarray))
    want = flatten_with_paths(jax.tree_util.tree_map(np.asarray, s1))
    got = outs[0]["fp/state"]
    for out in outs:
        assert out["fp/metrics"] == outs[0]["fp/metrics"]
        np.testing.assert_allclose(out["fp/metrics"]["loss"], float(m1["loss"]),
                                   rtol=1e-5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=5e-3, err_msg=k)


def test_fp_step_matches_the_unsharded_port(job):
    inp, outs, _ = job
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = bridge.jax_params_to_torch(cfg, _fp_params(inp), device="cpu")
    opt = AdamW(AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    _, m = make_train_step(model, opt, lambda s: 1e-3)(
        init_train_state(model, opt), _batch(inp, "fp", torch.from_numpy))
    for k in ("loss", "loss_ce"):
        np.testing.assert_allclose(outs[0]["fp/metrics"][k], float(m[k]), rtol=1e-6)


def test_qat_int8_step_matches_the_unsharded_port(job):
    inp, outs, _ = job
    cfg = get_config("qwen3-0.6b").reduced().with_quant(TQ.QAT)
    model = build_model(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW(AdamWConfig(state_dtype="int8_blockwise"))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, lambda s: 1e-3)
    for i in range(2):
        state, m = step(state, _batch(inp, f"qat{i}", torch.from_numpy))
        for out in outs:
            for k in ("loss", "loss_ce", "grad_norm"):
                np.testing.assert_allclose(out["qat/metrics"][i][k], float(m[k]),
                                           rtol=1e-6, err_msg=f"step {i} {k}")
    want = {k: v.numpy() for k, v in
            flatten_with_paths(bridge.train_state_to_jax(cfg, state)).items()}
    got = outs[0]["qat/state"]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k.endswith("/code"):
            diff = np.abs(g.astype(int) - w.astype(int))
            assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3, k
        elif k.startswith("params/"):
            far = np.abs(g - w) > 2e-3
            assert np.mean(far) <= 1e-3, (k, far.sum())
        elif k.startswith("opt_state/"):       # scales and fp32 moments
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", ["fp", "qat"])
def test_each_rank_holds_the_plans_share(job, case):
    _, outs, _ = job
    if case == "fp":
        cfg, mesh, opt_cfg = (get_config("qwen1.5-0.5b").reduced(),
                              {"data": 2, "model": 2}, AdamWConfig())
    else:
        cfg, mesh, opt_cfg = (get_config("qwen3-0.6b").reduced().with_quant(TQ.QAT),
                              {"pod": 2, "data": 1, "model": 2},
                              AdamWConfig(state_dtype="int8_blockwise"))
    plan = ShardingPlan(mesh, default_rules("pod" in mesh))
    model = build_model(cfg, device="meta")
    params = dict(model.named_parameters())
    axes = model.param_axes()
    st_axes = AdamW(opt_cfg).state_axes(axes, jax_ranks(params))
    state = AdamW(opt_cfg).init(params, jax_ranks(params))

    def local(shape, logical):
        spec = plan.spec(logical, shape)
        return tuple(d // int(np.prod([mesh[a] for a in ax] or [1]))
                     for d, ax in zip(shape, spec))

    want = {f"params/{k}": local(p.shape, axes[k]) for k, p in params.items()}
    for part in ("m", "v"):
        for k, t in getattr(state, part).items():
            ax = getattr(st_axes, part)[k]
            if isinstance(t, Moment8):
                want[f"{part}/{k}/code"] = local(t.code.shape, ax.code)
                want[f"{part}/{k}/scale"] = local(t.scale.shape, ax.scale)
            else:
                want[f"{part}/{k}"] = local(t.shape, ax)
    for out in outs:
        assert out[f"{case}/local_shapes"] == want
    # some leaves are split, on both mesh axes
    assert any(w != tuple(getattr(model.get_parameter(k[len("params/"):]), "shape"))
               for k, w in want.items() if k.startswith("params/"))


# -- the launcher -----------------------------------------------------------------------

def _losses(log: Path):
    return [line.split("loss ")[1].split()[0] for line in log.read_text().splitlines()
            if line.startswith("step ")]


def _leaves(ckpt: Path, step: int):
    _, payload = _read_payload(ckpt / f"step_{step:08d}")
    manifest = json.loads((ckpt / f"step_{step:08d}" / "manifest.json").read_text())
    return manifest, {k: bytes(v) for k, v in payload.items()}


def test_launcher_dp2_matches_dp1(job):
    _, _, io = job
    assert len(_losses(io / "launch_dp2.log")) == 2
    assert _losses(io / "launch_dp2.log") == _losses(io / "launch_dp1.log")
    m2, a2 = _leaves(io / "ckpt_dp2", 2)
    m1, a1 = _leaves(io / "ckpt_dp1", 2)
    assert m2["leaves"] == m1["leaves"] and m2["extra"] == m1["extra"]
    for k, meta in m1["leaves"].items():
        dt = np.dtype(meta["dtype"]) if meta["dtype"] != "bfloat16" else np.uint16
        x, y = np.frombuffer(a2[k], dt), np.frombuffer(a1[k], dt)
        if dt.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("src,dp", [(2, 1), (1, 2)])
def test_launcher_checkpoint_resumes_at_another_mesh(job, src, dp):
    _, _, io = job
    log = (io / f"resume_{src}_at_{dp}.log").read_text()
    assert "[resume] from step 2" in log and log.strip().endswith("done")
    m0, a0 = _leaves(io / f"ckpt_dp{src}", 2)
    m1, a1 = _leaves(io / f"resume_{src}_at_{dp}", 2)
    assert m0["leaves"] == m1["leaves"] and m0["extra"] == m1["extra"]
    assert a0 == a1


def test_launcher_sigterm_on_one_rank_stops_every_rank(job):
    """SIGTERM reaches rank 1 alone: the ranks agree on the step to stop
    after, gather the state, rank 0 saves it, and both exit 0."""
    _, _, io = job
    out = (io / "sigterm.log").read_text()
    lines = _losses(io / "sigterm.log")
    assert "[sigterm] emergency checkpoint" in out and not out.strip().endswith("done")
    step = int(((io / "ckpt_sigterm") / "LATEST").read_text().split("_")[1])
    assert step == len(lines) and 2 <= step < 50

"""The split route (``distributed/tensor_parallel.py``): the dense
families' CE and distill steps computed along ``"model"``, on gloo ranks
on the CPU (``tests/_torch_tp_worker.py``: a job of two ranks and one of
four, started once for the module), against the port's unsharded layers
and steps and JAX's single-device steps.  Tolerances:

* BitLinear on the kernel route (its CPU version) and the plain QAT route
  in fp32 with a dense decoder's exact product: a column-parallel shard's outputs and a row-parallel shard's
  summed integer accumulators, scaled once, bitwise the whole layer's; on
  the fp route rtol 1e-6 (a row shard's partial outputs are floats summed
  over the ranks).  Gradients rtol 1e-5 with an absolute floor of 1e-6 of the
  largest entry (dx of a column shard is summed over the ranks by *f*).
* SubLN over shards of its width: rtol 1e-6 (its sum of squares summed
  over the shards, ~1 ulp from one mean's); gradients rtol 1e-5.
* The vocabulary-parallel CE, NLL sum and logits KD: rtol 1e-6 of the
  whole vocabulary's, the pad columns at -1e30 on the last rank's shard;
  the logits' gradient rtol 1e-5, atol 1e-8.
* The QAT CE step (qwen3-0.6b reduced at dp 1 x tp 2 and dp 2 x tp 2, on
  the kernel route and at dp 2 x tp 2 on the plain route; qwen2.5-3b
  reduced, one kv head, at tp 4) against the port's unsharded
  step, two steps: losses and grad_norm rtol 1e-6, parameters within 2·lr
  (tests/test_torch_distributed.py's bounds); against JAX's single-device
  step (the bitlinear kernel in interpret mode): loss rtol 1e-5 and every
  leaf within 5e-3 after the first step (that file's FP case).
* The distill step at dp 2 x tp 2 likewise against the port's unsharded
  distill step and JAX's (``make_distill_step``, same params via
  ``bridge.py``): metrics rtol 1e-6 / 1e-5 (atol 2e-7), parameters within
  2·lr / 5e-3.  The logits KL (8.6e-4 here) is a sum of differences of two
  log-softmaxes whose normalizers (~5.7) carry an fp32 ulp of 4.8e-7, so
  against the port's unsharded step it also takes test_torch_train.py's
  absolute floor of 2e-7 (read: 6.4e-8 apart).
* The split is real: no compute copy of a heads-, mlp- or vocab-split
  weight is whole, the logits are [rows, S, V/tp], and a rank's counted
  FLOPs are at most the unsharded step's over dp·tp (its rows and its
  heads; qwen3-0.6b reduced's two kv heads divide over tp 2).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.core.distill import DistillConfig as JDistillConfig
from repro.core.pipeline import _copy_matching
from repro.models import build_model as jbuild, get_config as jget
from repro.training import optimizer as JO, trainer as JTr
from repro_torch import bridge
from repro_torch.core import distill as TD
from repro_torch.core import quant as TQ
from repro_torch.core.bitlinear import BitLinear, SubLN
from repro_torch.launch.op_analysis import count
from repro_torch.models import get_config
from repro_torch.nn.module import DTypePolicy, flatten_with_paths
from repro_torch.training.optimizer import AdamW, AdamWConfig
from repro_torch.training.trainer import (init_train_state, make_distill_step,
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_tp_worker.py"
TIMEOUT = 240
LR = 1e-3
F32 = DTypePolicy(torch.float32, torch.float32)
QAT_KERNEL = TQ.QuantConfig(mode="qat", use_kernel=True)
# (job size, case in the worker's output, config, batches' prefix, route)
STEPS = {"1x2": (2, "ce_1x2", "qwen3-0.6b", "qwen3_", "kernel"),
         "2x2": (4, "ce_2x2", "qwen3-0.6b", "qwen3_", "kernel"),
         "2x2-plain": (4, "ce_2x2_plain", "qwen3-0.6b", "qwen3_", "plain"),
         "1x4": (4, "ce_1x4", "qwen2.5-3b", "qwen25_", "kernel")}
QUANT = {"kernel": (QAT_KERNEL, JQ.QuantConfig(mode="qat", use_kernel=True)),
         "plain": (TQ.QAT, JQ.QAT)}
PARAMS = (("qwen3-0.6b", "qwen3"), ("qwen2.5-3b", "qwen25"))


def _jax_params(name):
    jt = jget(name).reduced()
    js = jt.with_quant(JQ.QuantConfig(mode="qat", use_kernel=True))
    tparams = jbuild(jt).init(jax.random.PRNGKey(0))
    sparams = _copy_matching(tparams, jbuild(js).init(jax.random.PRNGKey(1)))
    return jax.tree_util.tree_map(np.asarray, tparams), \
        jax.tree_util.tree_map(np.asarray, sparams)


def _inputs():
    rng = np.random.default_rng(26)
    f32 = np.float32
    inp = {"layer/x": rng.standard_normal((24, 256)).astype(f32),
           "layer/w": (rng.standard_normal((256, 128)) / 16).astype(f32),
           "layer/r": rng.standard_normal((24, 128)).astype(f32),
           "subln/x": (rng.standard_normal((4, 8, 256)) * 3).astype(f32),
           "subln/scale": (1 + 0.1 * rng.standard_normal(256)).astype(f32),
           "subln/r": rng.standard_normal((4, 8, 256)).astype(f32)}
    s = (rng.standard_normal((2, 8, 288)) * 3).astype(f32)
    t = (rng.standard_normal((2, 8, 288)) * 3).astype(f32)
    s[..., 280:] = t[..., 280:] = -1e30          # pad columns (vocab 280)
    inp.update({"loss/s": s, "loss/t": t,
                "loss/labels": rng.integers(0, 280, (2, 8)).astype(np.int32),
                "loss/mask": (rng.uniform(size=(2, 8)) < 0.7).astype(f32)})
    # a batch with image embeddings, unused: drawn so that the rng stream,
    # and with it every batch, stays the one this file's bounds were read on
    inp["vision_0/image_embeds"] = rng.standard_normal((8, 8, 128)).astype(f32)
    for prefix in ("qwen3_0", "qwen3_1", "qwen25_0", "qwen25_1", "vision_0"):
        inp[f"{prefix}/tokens"] = rng.integers(0, 268, (8, 16)).astype(np.int32)
        inp[f"{prefix}/labels"] = rng.integers(0, 268, (8, 16)).astype(np.int32)
        mask = np.ones((8, 16), f32)
        mask[:, :3] = 0.0
        inp[f"{prefix}/loss_mask"] = mask
    for name, key in PARAMS:
        tparams, sparams = _jax_params(name)
        for role, tree in (("teacher", tparams), ("student", sparams)):
            for k, v in flatten_with_paths(tree).items():
                inp[f"{key}/{role}/{k}"] = v
    return inp


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    io = tmp_path_factory.mktemp("tp")
    inp = _inputs()
    np.savez(io / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for world in (2, 4):
        for r in range(world):
            log = open(io / f"rank{world}_{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(world),
                 str(io / f"store{world}"), str(io)],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT),
                io / f"rank{world}_{r}.log"))
    for p, log in procs:
        try:
            rc = p.wait(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
        assert rc == 0, log.read_text()[-3000:]
    outs = {w: [torch.load(io / f"out{w}_{r}.pt", weights_only=False)
                for r in range(w)] for w in (2, 4)}
    return inp, outs


def _t(inp, k):
    return torch.from_numpy(inp[k])


def _batch(inp, prefix, lib=torch.from_numpy):
    return {k: lib(inp[f"{prefix}/{k}"])
            for k in ("tokens", "labels", "loss_mask", "image_embeds")
            if f"{prefix}/{k}" in inp}


def _tree(inp, prefix):
    tree = {}
    for path, v in inp.items():
        if path.startswith(prefix):
            node = tree
            *head, last = path[len(prefix):].split("/")
            for p in head:
                node = node.setdefault(p, {})
            node[last] = v
    return tree


def _close(got, want, rtol, floor=1e-6, err=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=floor * float(np.abs(np.asarray(want)).max()),
                               err_msg=err)


# -- the layers ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("route", ["kernel", "plain", "fp"])
def test_bitlinear_shards_match_the_whole_layer(jobs, route, n):
    inp, outs = jobs
    x, w, r = (_t(inp, f"layer/{k}") for k in ("x", "w", "r"))
    quant = {"kernel": QAT_KERNEL, "plain": TQ.QAT, "fp": TQ.FP}[route]
    for kind, axes in (("col", ("embed", "mlp")), ("row", ("mlp", "embed"))):
        lin = BitLinear(256, 128, quant=quant, policy=F32, axes=axes)
        lin.exact_product = True                # as a dense decoder's
        lin.w = torch.nn.Parameter(w.clone())
        xw = x.clone().requires_grad_(True)
        y = lin(xw)
        (y * r).sum().backward()
        for rank, out in enumerate(outs[n]):
            ys, dx, dw = out[f"layer/{route}/{kind}"]
            if kind == "col":
                want = (y.chunk(n, 1)[rank], xw.grad, lin.w.grad.chunk(n, 1)[rank])
            else:
                want = (y, xw.grad.chunk(n, 1)[rank], lin.w.grad.chunk(n, 0)[rank])
            msg = f"{route} {kind} rank {rank}"
            if route != "fp":
                assert torch.equal(ys, want[0].detach()), msg
            else:
                _close(ys, want[0].detach(), 1e-6, err=msg)
            _close(dx, want[1], 1e-5, err=msg + " dx")
            _close(dw, want[2], 1e-5, err=msg + " dw")


@pytest.mark.parametrize("n", [2, 4])
def test_subln_across_shards(jobs, n):
    inp, outs = jobs
    ln = SubLN(256, policy=F32, axis_name="mlp")
    ln.scale = torch.nn.Parameter(_t(inp, "subln/scale").clone())
    h = _t(inp, "subln/x").clone().requires_grad_(True)
    y = ln(h)
    (y * _t(inp, "subln/r")).sum().backward()
    for rank, out in enumerate(outs[n]):
        ys, dh, ds = out["subln"]
        _close(ys, y.detach().chunk(n, -1)[rank], 1e-6, floor=0.0)
        _close(dh, h.grad.chunk(n, -1)[rank], 1e-5)
        _close(ds, ln.scale.grad.chunk(n)[rank], 1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_ce_and_kd(jobs, n):
    inp, outs = jobs
    s = _t(inp, "loss/s").clone().requires_grad_(True)
    t, labels, mask = (_t(inp, f"loss/{k}") for k in ("t", "labels", "mask"))
    ce = TD.softmax_cross_entropy(s, labels, mask)
    nll = TD.nll_sum(s, labels, mask)
    ld = TD.logits_distill_loss(s, t, 5.0, mask)
    (ce + 10.0 * ld).backward()
    for rank, out in enumerate(outs[n]):
        got_ce, got_nll, got_ld, ds = out["loss"]
        np.testing.assert_allclose([got_ce, got_nll, got_ld],
                                   [ce.item(), nll.item(), ld.item()], rtol=1e-6)
        np.testing.assert_allclose(ds.numpy(), s.grad.chunk(n, -1)[rank].numpy(),
                                   rtol=1e-5, atol=1e-8)
        # the last rank's shard holds the pad columns: no probability there
        if rank == n - 1:
            assert float(ds[..., -8:].abs().max()) == 0.0


# -- the steps -------------------------------------------------------------------------

def _unsharded(name, inp, prefix, route, steps=2):
    cfg = get_config(name).reduced().with_quant(QUANT[route][0])
    key = dict(PARAMS)[name]
    model = bridge.jax_params_to_torch(cfg, _tree(inp, f"{key}/student/"), device="cpu")
    opt = AdamW(AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, lambda s: LR)
    ms, ps = [], []
    for i in range(steps):
        state, m = step(state, _batch(inp, f"{prefix}{i}"))
        ms.append({k: float(v) for k, v in m.items()})
        ps.append({k: v.numpy() for k, v in flatten_with_paths(
            bridge.train_state_to_jax(cfg, state)).items() if k.startswith("params/")})
    return ms, ps


def _jax_step(name, inp, prefix, route):
    key = dict(PARAMS)[name]
    js = jget(name).reduced().with_quant(QUANT[route][1])
    opt = JO.AdamW(JO.AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    params = jax.tree_util.tree_map(jnp.asarray, _tree(inp, f"{key}/student/"))
    s1, m1 = jax.jit(JTr.make_train_step(jbuild(js), opt, lambda s: LR))(
        JTr.init_train_state(params, opt), _batch(inp, f"{prefix}0", jnp.asarray))
    flat = flatten_with_paths(jax.tree_util.tree_map(np.asarray, s1))
    return float(m1["loss"]), {k: v for k, v in flat.items() if k.startswith("params/")}


@pytest.mark.parametrize("mesh", sorted(STEPS))
def test_qat_ce_step_matches_the_unsharded_port(jobs, mesh):
    inp, outs = jobs
    world, case, name, prefix, route = STEPS[mesh]
    want_m, want_p = _unsharded(name, inp, prefix, route)
    for out in outs[world]:
        ms, ps = out[case]
        for i in range(2):
            for k in ("loss", "loss_ce", "grad_norm"):
                np.testing.assert_allclose(ms[i][k], want_m[i][k], rtol=1e-6,
                                           err_msg=f"{mesh} step {i} {k}")
    got = outs[world][0][case][1][-1]
    assert set(got) == set(want_p[-1])
    for k, w in want_p[-1].items():
        assert np.abs(got[k] - w).max() <= 2 * LR, (mesh, k)


@pytest.mark.parametrize("mesh", sorted(STEPS))
def test_qat_ce_step_matches_jax_single_device(jobs, mesh):
    inp, outs = jobs
    world, case, name, prefix, route = STEPS[mesh]
    loss, want = _jax_step(name, inp, prefix, route)
    ms, ps = outs[world][0][case]
    np.testing.assert_allclose(ms[0]["loss"], loss, rtol=1e-5)
    assert set(ps[0]) == set(want)
    for k in want:
        np.testing.assert_allclose(ps[0][k], want[k], rtol=5e-3, atol=5e-3, err_msg=k)


def test_distill_step_matches_the_unsharded_port_and_jax(jobs):
    inp, outs = jobs
    cfg = get_config("qwen3-0.6b").reduced().with_quant(QAT_KERNEL)
    tcfg = get_config("qwen3-0.6b").reduced()
    student = bridge.jax_params_to_torch(cfg, _tree(inp, "qwen3/student/"), device="cpu")
    teacher = bridge.jax_params_to_torch(tcfg, _tree(inp, "qwen3/teacher/"), device="cpu")
    opt = AdamW(AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    dcfg = TD.DistillConfig(distill_layer=1, use_kernel=True)
    _, m = make_distill_step(student, teacher, opt, lambda s: LR, dcfg)(
        init_train_state(student, opt), _batch(inp, "qwen3_0"))
    want_p = {k: np.asarray(v) for k, v in flatten_with_paths(
        bridge.jax_params_from_torch(cfg, student)).items()}
    # JAX's single-device distill step from the same params
    js = jget("qwen3-0.6b").reduced().with_quant(JQ.QuantConfig(mode="qat",
                                                                use_kernel=True))
    jopt = JO.AdamW(JO.AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    sparams = jax.tree_util.tree_map(jnp.asarray, _tree(inp, "qwen3/student/"))
    tparams = jax.tree_util.tree_map(jnp.asarray, _tree(inp, "qwen3/teacher/"))
    jstep = jax.jit(JTr.make_distill_step(
        jbuild(js), jbuild(jget("qwen3-0.6b").reduced()), jopt, lambda s: LR,
        JDistillConfig(distill_layer=1, use_kernel=True)))
    js1, jm = jstep(JTr.init_train_state(sparams, jopt),
                    _batch(inp, "qwen3_0", jnp.asarray), tparams)
    jflat = flatten_with_paths(jax.tree_util.tree_map(np.asarray, js1.params))
    for out in outs[4]:
        got_route, got_m, got_p = out["distill_2x2"]
        assert got_route == "split"
        assert set(got_m) == set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(got_m[k], float(m[k]), rtol=1e-6,
                                       atol=2e-7 if k == "loss_ld" else 0.0,
                                       err_msg=k)
            np.testing.assert_allclose(got_m[k], float(jm[k]), rtol=1e-5, atol=2e-7,
                                       err_msg=k)
    got_p = {k[len("params/"):]: v for k, v in outs[4][0]["distill_2x2"][2].items()}
    assert set(got_p) == set(want_p) == set(jflat)
    for k, w in want_p.items():
        assert np.abs(got_p[k] - w).max() <= 2 * LR, k
        np.testing.assert_allclose(got_p[k], jflat[k], rtol=5e-3, atol=5e-3, err_msg=k)


def test_the_split_is_real(jobs):
    """No rank holds a whole heads-, mlp- or vocab-split weight or the
    whole vocabulary's logits during the dp 2 x tp 2 step, and its counted
    FLOPs are the unsharded step's over dp·tp."""
    inp, outs = jobs
    cfg = get_config("qwen3-0.6b").reduced().with_quant(QAT_KERNEL)
    model = bridge.jax_params_to_torch(cfg, _tree(inp, "qwen3/student/"), device="cpu")
    opt = AdamW(AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    whole = count(make_train_step(model, opt, lambda s: LR),
                  init_train_state(model, opt), _batch(inp, "qwen3_0")).flops
    n_split = sum(1 for k, a in model.param_axes().items()
                  if any(x in ("heads", "mlp", "vocab") for x in a))
    for out in outs[4]:
        seen, logits, flops = out["watch"]
        # every use of a "model"-split weight (the kv projections divide
        # here): the rank's shard, its other axes gathered
        split = [(w, c) for spec, w, used_whole, c in seen
                 if any("model" in s for s in spec)]
        assert not any(used_whole for _, _, used_whole, _ in seen)
        assert len(split) >= n_split
        assert all(c[d] * 2 == w[d] for w, c in split for d in range(len(w))
                   if c[d] != w[d]) and all(c != w for w, c in split)
        assert logits and all(s == (4, 16, cfg.padded_vocab // 2) for s in logits)
        assert 0 < flops <= whole / 4

"""The split route (``distributed/tensor_parallel.py``) for the MoE, SSM and
hybrid families: granite-moe-1b-a400m, grok-1-314b, mamba2-780m and
jamba-1.5-large-398b, reduced, on gloo ranks on the CPU
(``tests/_torch_tp_families_worker.py``: jobs of one, two and four ranks,
started once for the module), against the port's unsharded layers and steps
and JAX's single-device steps, from the port's seeded params carried into
JAX's tree by ``bridge.py``.  The cases: granite (4 experts: split by
experts at tp 2 and 4), granite with 2 experts at tp 4 (the ``d_ff``
fallback), grok at dp 2 x tp 2 (one kv head), mamba2 on the kernel route
at tp 2 and 4 (16 heads; ``in_proj``'s 560 columns and the conv's 288
channels split mid-group at tp 4), jamba at tp 4 (its pattern's first four
layers: attention + dense, mamba + MoE, mamba + dense, mamba + MoE; the
plain QAT route).  Over more than one rank the split takes the exact QAT
product and sums SubLN's squares and the MoE combine in float64
(``distributed/tensor_parallel.py::exact``); the unsharded steps and
layers they are held to take the same forms (``models/lm.py::set_exact``),
so the split's forward is the unsharded one's bit for bit but for the
``d_ff`` fallback's float sums.  Tolerances:

* The MoE layer split by experts (four at tp 2 and 4) and by ``d_ff`` (two
  experts at tp 4), and the Mamba2 block split by heads (tp 2 and 4),
  against the whole layer: outputs rtol 1e-6 with an absolute floor of
  1e-6 of the largest entry, gradients rtol 1e-5 with that floor (``dx``
  and the whole-used tensors' gradients are float sums over the ranks),
  each rank's gradient its plan shard of the whole layer's.
* The CE steps (two) and the distill step against the port's unsharded
  steps on the same batches: losses and grad_norm rtol 1e-6, the logits
  KL with test_torch_train.py's absolute floor of 2e-7 (read, relative,
  the largest over the ranks and metrics: equal on the first steps but
  for jamba's distill grad_norm, 1.2e-7, and grok's loss_moe, 7.4e-8; the
  second: granite's grad_norm 1.2e-7, grok's loss_moe 7.1e-8, mamba2's
  grad_norm 9.3e-8).  Two cases have bounds of their own.  The ``d_ff``
  fallback rtol 1e-5 on both CE steps and the distill step: its experts'
  ``down`` outputs are float partial sums over the ranks, as JAX's GSPMD
  sums them (read: equal on the first step, 4.5e-6 the second's
  grad_norm).  jamba's second CE step rtol 3e-5: it starts from weights
  Adam's first update set apart where a gradient is ~0 and its summation
  order gives its sign (up to 8.3e-4 apart), and int8 codes round apart
  (read: 1.0e-5 its grad_norm, 8.3e-6 its loss).  Parameters within 2·lr.
* The same steps against JAX's single-device step: each family's JAX
  bounds, the MoE's rtol 1e-4 on loss and grad_norm
  (tests/test_torch_moe_configs.py), the SSM's rtol 1e-5 with an absolute
  floor of 2e-7 (tests/test_torch_mamba_train.py), every leaf within 5e-3
  after the distill step (JAX's lr-1e-3 bound).  jamba's split takes the
  exact QAT product, which its family's plain step does not (it moved
  jamba's reduced QAT loss 1.12e-4 from JAX's block-by-block evaluation,
  past that test's 1e-4; ROADMAP Queue C): against JAX's jitted step it
  is held at rtol 2e-3 (read: grad_norm
  7.1e-4, loss 2.2e-5 on the CE step; XLA's compiled block rounds apart
  from the op-by-op one, test_torch_moe_configs.py's ``_BlockByBlock``).
* One rank: the split step under the (1, 1) plan bitwise the plain step.
* The split is real: a rank's compute copies of the experts hold its
  experts (or their ``d_ff`` columns), the SSD runs its heads, and its
  counted FLOPs are at most 1.25 of the unsharded step's over tp (the
  router and the routing run whole on every rank), 2 of it for the ``d_ff``
  fallback (the dispatch and combine too).
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
from repro.models import build_model as jbuild, get_config as jget
from repro.training import optimizer as JO, trainer as JTr
from repro_torch import bridge
from repro_torch.core.pipeline import _copy_matching
from repro_torch.distributed.sharding import ShardingPlan, default_rules
from repro_torch.launch.op_analysis import count
from repro_torch.models import build_model, get_config, lm
from repro_torch.nn.module import flatten_with_paths
from repro_torch.training.trainer import (init_train_state, make_distill_step,
                                          make_split, make_train_step)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_tp_families_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(W.__file__)
TIMEOUT = 300
LR = W.LR
WORLDS = (1, 2, 4)
# (case, world): the steps each job runs
STEPS = [(c, dp * n) for c, (*_, meshes) in W.CASES.items() for dp, n in meshes]
# the cases' bounds against the unsharded port step, (the first step, the
# second CE step), 1e-6 but where given; and against JAX's step
PORT_RTOL = {"granite_e2": (1e-5, 1e-5), "jamba": (1e-6, 3e-5)}
JAX_RTOL = {"mamba2": (1e-5, 2e-7), "jamba": (2e-3, 0.0)}


def _jax_cfgs(case):
    name, cut, over, route, _ = W.CASES[case]
    jt = W.reduced(jget(name), cut, over)
    return jt.with_quant(JQ.QuantConfig(mode="qat", use_kernel=route == "kernel")), jt


def _inputs():
    rng = np.random.default_rng(27)
    f32 = np.float32
    inp = {}
    for key in ("moe", "ssm"):
        inp[f"{key}/x"] = rng.standard_normal((2, 32, 128)).astype(f32)
        inp[f"{key}/r"] = rng.standard_normal((2, 32, 128)).astype(f32)
    for case in W.CASES:
        for i in range(2):
            inp[f"{case}_{i}/tokens"] = rng.integers(0, 268, (8, 16)).astype(np.int32)
            inp[f"{case}_{i}/labels"] = rng.integers(0, 268, (8, 16)).astype(np.int32)
            mask = np.ones((8, 16), f32)
            mask[:, :3] = 0.0
            inp[f"{case}_{i}/loss_mask"] = mask
        # the port's seeded init (JAX's init of these five configs takes
        # ~20 s on the CPU), the student refined from the teacher; both
        # through bridge.py as JAX param trees
        scfg, tcfg = W.config(case)
        teacher = build_model(tcfg, gen=torch.Generator().manual_seed(0),
                              device="cpu")
        student = _copy_matching(teacher, build_model(
            scfg, gen=torch.Generator().manual_seed(1), device="cpu"))
        for role, cfg, model in (("teacher", tcfg, teacher),
                                 ("student", scfg, student)):
            tree = bridge.jax_params_from_torch(cfg, model)
            for k, v in flatten_with_paths(tree).items():
                inp[f"{case}/{role}/{k}"] = v
    return inp


def _batch(inp, case, i, lib=torch.from_numpy):
    return {k: lib(inp[f"{case}_{i}/{k}"]) for k in ("tokens", "labels", "loss_mask")}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The ranks' outputs, and while they run each step's references: the
    port's unsharded step and JAX's single-device step."""
    io = tmp_path_factory.mktemp("tpf")
    inp = _inputs()
    np.savez(io / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for world in WORLDS:
        for r in range(world):
            log = open(io / f"rank{world}_{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(world),
                 str(io / f"store{world}"), str(io)],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT),
                io / f"rank{world}_{r}.log"))
    try:
        refs = {(c, k): (_unsharded(inp, c, k, 2 if k == "ce" else 1),
                         _jax_step(inp, c, k))
                for c in W.CASES for k in ("ce", "distill")}
    except BaseException:
        for p, _ in procs:
            p.kill()
        raise
    for p, log in procs:
        try:
            rc = p.wait(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
        assert rc == 0, log.read_text()[-3000:]
    outs = {w: [torch.load(io / f"out{w}_{r}.pt", weights_only=False)
                for r in range(w)] for w in WORLDS}
    return inp, outs, refs


def _close(got, want, rtol, floor=1e-6, err=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=floor * float(np.abs(np.asarray(want)).max()),
                               err_msg=err)


# -- the layers ----------------------------------------------------------------------

def _whole_layer(inp, key, build, call):
    mod = build()
    lm.set_exact(mod)
    x = torch.from_numpy(inp[f"{key}/x"]).clone().requires_grad_(True)
    y = call(mod, x)
    (y * torch.from_numpy(inp[f"{key}/r"])).sum().backward()
    return y.detach(), x.grad, {n: p.grad for n, p in mod.named_parameters()}


LAYERS = {"moe/4": ("moe", lambda: W.moe_layer(4), lambda m, x: m(x)[0], "layer/moe"),
          "moe/2": ("moe", lambda: W.moe_layer(2), lambda m, x: m(x)[0], "layer/moe_e2"),
          "ssm": ("ssm", W.mamba_layer, lambda m, x: m(x), "layer/ssm")}


@pytest.mark.parametrize("layer,n", [("moe/4", 2), ("moe/4", 4), ("moe/2", 4),
                                     ("ssm", 2), ("ssm", 4)])
def test_layer_shards_match_the_whole_layer(jobs, layer, n):
    inp, outs, _ = jobs
    key, build, call, case = LAYERS[layer]
    y, dx, grads = _whole_layer(inp, key, build, call)
    for rank, out in enumerate(outs[n]):
        ys, dxs, gs = out[case]
        msg = f"{layer} tp {n} rank {rank}"
        _close(ys, y, 1e-6, err=msg + " y")
        _close(dxs, dx, 1e-5, err=msg + " dx")
        assert set(gs) == set(grads)
        for name, (spec, g) in gs.items():
            dims = [d for d, a in enumerate(spec) if "model" in a]
            want = grads[name].chunk(n, dims[0])[rank] if dims else grads[name]
            assert g.shape == want.shape, (msg, name)
            _close(g, want, 1e-5, err=f"{msg} d{name}")


# -- the steps -------------------------------------------------------------------------

def _unsharded(inp, case, kind, steps):
    """The port's unsharded step of ``case`` (the worker's configs)."""
    scfg, tcfg = W.config(case)
    student = bridge.jax_params_to_torch(scfg, W.tree(inp, f"{case}/student/"),
                                         device="cpu")
    lm.set_exact(student)
    opt = W.optimizer()
    state = init_train_state(student, opt)
    if kind == "distill":
        teacher = bridge.jax_params_to_torch(tcfg, W.tree(inp, f"{case}/teacher/"),
                                             device="cpu")
        lm.set_exact(teacher)
        step = make_distill_step(student, teacher, opt, lambda s: LR,
                                 W.distill_config(scfg))
    else:
        step = make_train_step(student, opt, lambda s: LR)
    ms = []
    for i in range(steps):
        state, m = step(state, _batch(inp, case, i))
        ms.append({k: float(v) for k, v in m.items()})
    return ms, W.state_np(scfg, state)


@pytest.mark.parametrize("kind", ["ce", "distill"])
@pytest.mark.parametrize("case,world", STEPS)
def test_split_step_matches_the_unsharded_port(jobs, case, world, kind):
    _, outs, refs = jobs
    steps = 2 if kind == "ce" else 1
    want_m, want_p = refs[case, kind][0]
    for out in outs[world]:
        route, ms, _ = out[f"{case}/{kind}"]
        assert route == "split"
        for i in range(steps):
            rtol = PORT_RTOL.get(case, (1e-6, 1e-6))[i]
            assert set(ms[i]) == set(want_m[i])
            for k in ms[i]:
                np.testing.assert_allclose(
                    ms[i][k], want_m[i][k], rtol=rtol,
                    atol=2e-7 if k == "loss_ld" else 0.0,
                    err_msg=f"{case} {kind} world {world} step {i} {k}")
    got = outs[world][0][f"{case}/{kind}"][2]
    assert set(got) == set(want_p)
    for k, w in want_p.items():
        assert np.abs(got[k] - w).max() <= 2 * LR, (case, kind, k)


def _jax_step(inp, case, kind):
    js, jt = _jax_cfgs(case)
    opt = JO.AdamW(JO.AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    params = jax.tree_util.tree_map(jnp.asarray, W.tree(inp, f"{case}/student/"))
    b = _batch(inp, case, 0, jnp.asarray)
    if kind == "ce":
        s1, m = jax.jit(JTr.make_train_step(jbuild(js), opt, lambda s: LR))(
            JTr.init_train_state(params, opt), b)
    else:
        dc = W.distill_config(W.config(case)[0])
        jdc = JDistillConfig(distill_layer=dc.distill_layer, use_ad=dc.use_ad,
                             use_kernel=True)
        tparams = jax.tree_util.tree_map(jnp.asarray, W.tree(inp, f"{case}/teacher/"))
        s1, m = jax.jit(JTr.make_distill_step(jbuild(js), jbuild(jt), opt,
                                              lambda s: LR, jdc))(
            JTr.init_train_state(params, opt), b, tparams)
    flat = flatten_with_paths(jax.tree_util.tree_map(np.asarray, s1.params))
    return {k: float(v) for k, v in m.items()}, flat


@pytest.mark.parametrize("kind", ["ce", "distill"])
@pytest.mark.parametrize("case", sorted(W.CASES))
def test_split_step_matches_jax_single_device(jobs, case, kind):
    _, outs, refs = jobs
    world = max(dp * n for dp, n in W.CASES[case][4])
    jm, jp = refs[case, kind][1]
    route, ms, _ = outs[world][0][f"{case}/{kind}"]
    rtol, atol = JAX_RTOL.get(case, (1e-4, 0.0))
    assert route == "split" and set(ms[0]) == set(jm)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(ms[0][k], jm[k], rtol=rtol, atol=atol,
                                   err_msg=f"{case} {kind} {k}")
    if kind == "distill":                 # one step: the leaves after it
        got = {k[len("params/"):]: v
               for k, v in outs[world][0][f"{case}/{kind}"][2].items()}
        assert set(got) == set(jp)
        for k in jp:
            np.testing.assert_allclose(got[k], jp[k], rtol=5e-3, atol=5e-3,
                                       err_msg=f"{case} {kind} {k}")


@pytest.mark.parametrize("kind", ["ce", "distill"])
@pytest.mark.parametrize("case", sorted(W.CASES))
def test_one_rank_split_is_the_plain_step_bitwise(jobs, case, kind):
    _, outs, _ = jobs
    (r0, m0, p0), (r1, m1, p1) = outs[1][0][f"{case}/{kind}"]
    assert (r0, r1) == ("plain", "split")
    assert m0 == m1
    assert set(p0) == set(p1) and all(np.array_equal(p0[k], p1[k]) for k in p0)


@pytest.mark.parametrize("case", W.WATCHED)
def test_the_split_is_real(jobs, case):
    """At tp 4 a rank's compute copies of the experts hold its experts or
    their d_ff columns, the SSD runs its heads, and its FLOPs are the
    unsharded step's over tp or less (plus the replicated router)."""
    inp, outs, _ = jobs
    scfg, _ = W.config(case)
    model = bridge.jax_params_to_torch(scfg, W.tree(inp, f"{case}/student/"),
                                       device="cpu")
    lm.set_exact(model)
    opt = W.optimizer()
    whole = count(make_train_step(model, opt, lambda s: LR),
                  init_train_state(model, opt), _batch(inp, case, 0)).flops
    for out in outs[4]:
        seen, ssd, flops = out[f"{case}/watch"]
        experts = [(w, c) for spec, w, _, c in seen if len(w) == 3]
        if scfg.n_experts:
            assert experts
            e_split = scfg.n_experts % 4 == 0
            for w, c in experts:
                f_dim = 1 if w[1] == scfg.d_ff else 2     # down [e, f, d]
                want = list(w)
                want[0 if e_split else f_dim] //= 4
                assert list(c) == want, (w, c)
        heads = scfg.d_model * 2 // scfg.ssm_head_dim
        # the d_ff fallback runs the dispatch and combine whole on every rank
        share = 2 if scfg.n_experts and scfg.n_experts % 4 else 1.25
        if any(s.mixer == "mamba" for s in scfg.resolved_pattern()):
            assert ssd and all(s[2] * 4 == heads for s in ssd)
            # in_proj, conv_w and conv_b whole at use, gathered mid-group
            assert sum(1 for _, _, used_whole, _ in seen if used_whole) >= 3
        assert 0 < flops <= whole / 4 * share, (flops, whole)


def test_step_route_per_family():
    """Every family's step under a plan takes the split route: its model
    registers in the split (``training/trainer.py::make_split``), each
    parameter with the spec the plan gives it."""
    plan = ShardingPlan({"data": 2, "model": 4}, default_rules(False))
    for name in ("granite-moe-1b-a400m", "grok-1-314b", "mamba2-780m",
                 "jamba-1.5-large-398b", "qwen3-0.6b", "whisper-medium",
                 "llama-3.2-vision-11b"):
        model = build_model(get_config(name).reduced(), device=torch.device("meta"))
        split = make_split(plan, model)
        axes, named = model.param_axes(), dict(model.named_parameters())
        assert len(split.params) == len(named), name
        for k, p in named.items():
            assert split.params[id(p)][1].spec == plan.spec(
                axes[k], tuple(p.shape), record=False), (name, k)

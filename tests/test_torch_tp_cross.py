"""The split route (``distributed/tensor_parallel.py``) for the
cross-attention families: whisper-medium (``models/encdec.py``) and
llama-3.2-vision-11b cut to one repeat, reduced, on the kernel route (the
plain versions of the bitlinear and relation_kd kernels), on gloo ranks on
the CPU (``tests/_torch_tp_cross_worker.py``: jobs of one, two and four
ranks, started once for the module), against the port's unsharded steps and
JAX's single-device steps, from the port's seeded params carried into JAX's
tree by ``bridge.py``.  Under the split a cross layer's q is column-parallel
by heads, its K/V are projected from the memory by kv heads (whisper's four
divide over 2 and 4 ranks) or used whole (llama-vision's one kv head), its
``wo`` row-parallel; the memory enters through *f*; whisper's encoder and
``enc_norm`` split and gather as a decoder's blocks and final norm do.
Tolerances:

* Two CE steps and a distill step at tp 2 and tp 4 against the port's
  unsharded steps on the same batches: the first step's losses and
  grad_norm rtol 1e-6 (the logits KL with test_torch_train.py's absolute
  floor of 2e-7), the parameters within 2·lr.  Over more than one rank the
  split takes the exact QAT product and SubLN's float64 sums; the
  unsharded steps take the same forms (``models/lm.py::set_exact``).  The
  second CE step rtol 3e-5, as test_torch_tp_families.py holds jamba's: it
  starts from weights Adam's first update set apart where a gradient is ~0
  and its summation order gives its sign (the memory's gradient is summed
  over the ranks by *f* at every cross layer, and llama-vision's kv
  projections, used whole, sum theirs), and int8 codes round apart (read:
  loss_ce 9.3e-6 for llama-vision at tp 2 and 4, 2.6e-6 for whisper at tp
  2).
* The same steps against JAX's single-device step: Queue C's bound for the
  cross families (tests/test_torch_encdec.py's QAT bound), loss and
  grad_norm rtol 2e-3, every leaf within 2·lr after the distill step.
* One rank: the split step under the (1, 1) plan bitwise the plain step.
* The split is real: at tp 4 every compute copy of a heads-, mlp- or
  vocab-split weight is the rank's shard (the kv projections used whole
  where their heads do not divide), and the decoder's logits are [rows, S,
  V/tp].
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
from repro_torch.models import build_model, get_config, lm
from repro_torch.nn.module import flatten_with_paths
from repro_torch.launch import specs
from repro_torch.training.trainer import (init_train_state, make_distill_step,
                                          make_split, make_train_step)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_tp_cross_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(W.__file__)
TIMEOUT = 300
LR = W.LR


def _inputs():
    rng = np.random.default_rng(29)
    f32 = np.float32
    inp = {}
    for case, (_, _, key) in W.CASES.items():
        scfg, tcfg = W.config(case)
        t = tcfg.encoder_seq if key == "frames" else tcfg.num_image_tokens
        for i in range(2):
            inp[f"{case}_{i}/tokens"] = rng.integers(0, 268, (8, 16)).astype(np.int32)
            inp[f"{case}_{i}/labels"] = rng.integers(0, 268, (8, 16)).astype(np.int32)
            mask = np.ones((8, 16), f32)
            mask[:, :3] = 0.0
            inp[f"{case}_{i}/loss_mask"] = mask
            inp[f"{case}_{i}/{key}"] = rng.standard_normal(
                (8, t, tcfg.d_model)).astype(f32)
        teacher = build_model(tcfg, gen=torch.Generator().manual_seed(0),
                              device="cpu")
        student = _copy_matching(teacher, build_model(
            scfg, gen=torch.Generator().manual_seed(1), device="cpu"))
        for role, cfg, model in (("teacher", tcfg, teacher),
                                 ("student", scfg, student)):
            for k, v in flatten_with_paths(bridge.jax_params_from_torch(
                    cfg, model)).items():
                inp[f"{case}/{role}/{k}"] = v
    return inp


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The ranks' outputs, and while they run each step's references: the
    port's unsharded step and JAX's single-device step."""
    io = tmp_path_factory.mktemp("tpc")
    inp = _inputs()
    np.savez(io / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for world in W.WORLDS:
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
                for r in range(w)] for w in W.WORLDS}
    return inp, outs, refs


def _unsharded(inp, case, kind, steps):
    """The port's unsharded step of ``case`` in the split's exact forms."""
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
        state, m = step(state, W.batch(inp, case, i))
        ms.append({k: float(v) for k, v in m.items()})
    return ms, W.state_np(scfg, state)


def _jax_step(inp, case, kind):
    name, layers, _ = W.CASES[case]
    jt = jget(name).reduced(layers=layers)
    js = jt.with_quant(JQ.QuantConfig(mode="qat", use_kernel=True))
    opt = JO.AdamW(JO.AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    params = jax.tree_util.tree_map(jnp.asarray, W.tree(inp, f"{case}/student/"))
    b = {k: jnp.asarray(v.numpy()) for k, v in W.batch(inp, case, 0).items()}
    if kind == "ce":
        s1, m = jax.jit(JTr.make_train_step(jbuild(js), opt, lambda s: LR))(
            JTr.init_train_state(params, opt), b)
    else:
        dc = W.distill_config(W.config(case)[0])
        jdc = JDistillConfig(distill_layer=dc.distill_layer, use_kernel=True)
        tparams = jax.tree_util.tree_map(jnp.asarray, W.tree(inp, f"{case}/teacher/"))
        s1, m = jax.jit(JTr.make_distill_step(jbuild(js), jbuild(jt), opt,
                                              lambda s: LR, jdc))(
            JTr.init_train_state(params, opt), b, tparams)
    flat = flatten_with_paths(jax.tree_util.tree_map(np.asarray, s1.params))
    return {k: float(v) for k, v in m.items()}, flat


@pytest.mark.parametrize("kind", ["ce", "distill"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(W.CASES))
def test_split_step_matches_the_unsharded_port(jobs, case, world, kind):
    _, outs, refs = jobs
    steps = 2 if kind == "ce" else 1
    want_m, want_p = refs[case, kind][0]
    for out in outs[world]:
        route, ms, _ = out[f"{case}/{kind}"]
        assert route == "split"
        for i in range(steps):
            assert set(ms[i]) == set(want_m[i])
            for k in ms[i]:
                np.testing.assert_allclose(
                    ms[i][k], want_m[i][k], rtol=(1e-6, 3e-5)[i],
                    atol=2e-7 if k == "loss_ld" else 0.0,
                    err_msg=f"{case} {kind} world {world} step {i} {k}")
    got = outs[world][0][f"{case}/{kind}"][2]
    assert set(got) == set(want_p)
    for k, w in want_p.items():
        assert np.abs(got[k] - w).max() <= 2 * LR, (case, kind, k)


@pytest.mark.parametrize("kind", ["ce", "distill"])
@pytest.mark.parametrize("case", sorted(W.CASES))
def test_split_step_matches_jax_single_device(jobs, case, kind):
    _, outs, refs = jobs
    jm, jp = refs[case, kind][1]
    route, ms, _ = outs[4][0][f"{case}/{kind}"]
    assert route == "split" and set(jm) <= set(ms[0])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(ms[0][k], jm[k], rtol=2e-3,
                                   err_msg=f"{case} {kind} {k}")
    if kind == "distill":                 # one step: the leaves after it
        got = {k[len("params/"):]: v
               for k, v in outs[4][0][f"{case}/{kind}"][2].items()}
        assert set(got) == set(jp)
        for k in jp:
            assert np.abs(got[k] - jp[k]).max() <= 2 * LR + 1e-6, (case, k)


@pytest.mark.parametrize("kind", ["ce", "distill"])
@pytest.mark.parametrize("case", sorted(W.CASES))
def test_one_rank_split_is_the_plain_step_bitwise(jobs, case, kind):
    _, outs, _ = jobs
    (r0, m0, p0), (r1, m1, p1) = outs[1][0][f"{case}/{kind}"]
    assert (r0, r1) == ("plain", "split")
    assert m0 == m1
    assert set(p0) == set(p1) and all(np.array_equal(p0[k], p1[k]) for k in p0)


@pytest.mark.parametrize("case", sorted(W.CASES))
def test_the_split_is_real(jobs, case):
    """At tp 4 every compute copy of a weight the plan splits over "model"
    is the rank's shard (a quarter along that dim; the kv projections are
    used whole where one kv head does not divide), and the logits are the
    rank's quarter of the padded vocabulary."""
    _, outs, _ = jobs
    scfg, _ = W.config(case)
    for out in outs[4]:
        seen, logits = out[f"{case}/watch"]
        split = [(spec, w, c) for spec, w, c in seen
                 if any("model" in s for s in spec)]
        assert split
        heads = 0
        for spec, w, c in split:
            for d, s in enumerate(spec):
                if "model" in s and c[d] != w[d]:
                    assert c[d] * 4 == w[d], (spec, w, c)
            whole = c == w
            # used whole: only a kv projection of heads that do not divide
            assert not whole or scfg.n_kv_heads % 4, (spec, w, c)
            heads += any(w[d] == scfg.n_heads * scfg.head_dim and c[d] * 4 == w[d]
                         for d in range(len(w)))
        assert heads > 0
        assert logits and all(s == (8, 16, scfg.padded_vocab // 4) for s in logits)


def test_step_route_takes_the_cross_families():
    """Under a plan the cross families' steps take the split route (their
    models register in the split); the dry run's cells keep the gathered
    route for comparison, and name no other."""
    plan = ShardingPlan({"data": 2, "model": 4}, default_rules(False))
    for name in ("whisper-medium", "llama-3.2-vision-11b"):
        model = build_model(get_config(name).reduced(), device=torch.device("meta"))
        split = make_split(plan, model)
        assert len(split.params) == len(dict(model.named_parameters())), name
    with pytest.raises(ValueError, match="'split' or 'gathered'"):
        specs.build_cell("whisper-medium", "train_4k", {"data": 16, "model": 16},
                         route="whole")

"""Port vs JAX: the training path — data, schedules, AdamW, the train and
distill steps, evaluation and the three-stage pipeline — on reduced configs
in fp32, on the CPU (the kernel ops take their plain versions there).

Parameters come from the JAX ``init`` and go through ``repro_torch.bridge``;
batches come from numpy seeds.  Tolerances:

* data, tokenizer: bitwise.  Schedules: rtol 1e-7 (the same fp32 ops).
* AdamW: rtol 1e-6 on parameters and moments (fp32, the same op order; the
  global norm sums in another order).  8-bit codes equal, scales rtol 1e-6.
* train/distill steps: loss, its parts and grad_norm rtol 1e-5, with an
  absolute floor of 2e-7 for the logits-KD part: a KL of ~1e-3 is a sum of
  differences of log-softmax values of ~6, each rounded at ~5e-7.  Every
  updated parameter rtol 1e-4, atol 1e-5.  The learning rate is the
  pipeline's SFT rate, 1e-4.  Adam's first update of an element is
  lr·g/(|g|+1e-8), so an element whose clipped gradient is near 1e-8 (where
  the two packages' gradients differ by summation order, ~1e-9) moves by a
  visible fraction of lr: ~1e-6 at this rate.
* pipeline stages: losses rtol 1e-4, grad_norm rtol 1e-2.

Through the QAT quantizers an fp32 difference upstream can flip an int8
activation code at a .5 boundary and move later logits by ~1e-2 (see
tests/test_torch_distill.py).  The pipeline below flips one: on the 2nd
continued-pretraining batch, from the same weights on both sides,
x·127/γ = -69.499985 rounds to -69 on one side and -70 on the other; that
moves the step's loss by 1.1e-5 and its grad_norm by 2.0e-4 (relative), and
through Adam's sign-like first updates the next step's grad_norm by 1.5e-3,
hence the pipeline's bounds.  Run end to end, the stages would also carry
such differences into the next (the distillation grad_norm then differed by
1.6e-3), so each port stage starts from the JAX stage's own input, carried
over by the bridge.  The single steps above see no flip.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core import quant as JQ
from repro.core.distill import DistillConfig as JDistillConfig
from repro.data import loader as JL, synth as JS, tokenizer as JT
from repro.models import build_model as jbuild, get_config as jget
from repro.training import optimizer as JO, schedule as JSch, trainer as JTr
from repro_torch.bridge import jax_params_from_torch, jax_params_to_torch
from repro_torch.core import pipeline as TP
from repro_torch.core import quant as TQ
from repro_torch.core.distill import DistillConfig
from repro_torch.data import loader as TL, synth as TS, tokenizer as TT
from repro_torch.launch import train as launch_train
from repro_torch.models import get_config
from repro_torch.training import optimizer as TO, schedule as TSch, trainer as TTr

TASKS = ["corpus", "mnli-syn", "qnli-syn", "sst2-syn", "cnndm-syn"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_loader_batches_equal_jax_bit_for_bit(task):
    jl = JL.DataLoader(JS.get_task(task, seed=3), 4, 48, seed=5, host_id=1,
                       num_hosts=2)
    tl = TL.DataLoader(TS.get_task(task, seed=3), 4, 48, seed=5, host_id=1,
                       num_hosts=2)
    for _ in range(2):
        jb, tb = jl.next(), tl.next()
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    assert tl.state_dict() == jl.state_dict()


def test_tokenizer_and_task_specs_equal_jax():
    assert dataclasses.asdict(TT.ByteTokenizer()) == dataclasses.asdict(JT.ByteTokenizer())
    tok = TT.ByteTokenizer()
    assert tok.decode(tok.encode("bitnet")) == "bitnet"
    assert {k: dataclasses.asdict(v) for k, v in TS.TASKS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JS.TASKS.items()}


# -- schedules and AdamW -------------------------------------------------------------

def test_schedules_match_jax():
    for s in (0, 1, 5, 10, 11, 57, 100, 130):
        for tf, jf, args in ((TSch.warmup_cosine, JSch.warmup_cosine, (3e-4, 10, 100)),
                             (TSch.warmup_cosine, JSch.warmup_cosine, (1e-4, 0, 1, 0.2)),
                             (TSch.warmup_constant, JSch.warmup_constant, (1e-3, 20)),
                             (TSch.constant, JSch.constant, (2e-5,))):
            got, want = tf(s, *args), jf(s, *args)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 300), "t": (2, 3, 260), "b": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("state_dtype", ["float32", "int8_blockwise"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_jax(state_dtype, clip):
    params, grads = _opt_case(0)
    cfg = dict(state_dtype=state_dtype, grad_clip=clip, weight_decay=0.1)
    jopt, topt = JO.AdamW(JO.AdamWConfig(**cfg)), TO.AdamW(TO.AdamWConfig(**cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads):
        lr = JSch.warmup_cosine(i + 1, 1e-2, 2, 10)
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr)
        tp, ts, tm = topt.update({k: _t(v) for k, v in g.items()}, ts, tp,
                                 TSch.warmup_cosine(i + 1, 1e-2, 2, 10))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            for tmom, jmom in ((ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
                if isinstance(jmom, JO.Moment8):
                    assert isinstance(tmom, TO.Moment8)
                    np.testing.assert_array_equal(tmom.code.numpy(),
                                                  np.asarray(jmom.code))
                    np.testing.assert_allclose(tmom.scale.numpy(),
                                               np.asarray(jmom.scale), rtol=1e-6)
                else:
                    np.testing.assert_allclose(tmom.numpy(), np.asarray(jmom),
                                               rtol=1e-6, atol=1e-12)
    assert ts.step == int(js.step) == 3
    assert topt.state_bytes_per_param() == jopt.state_bytes_per_param()


def test_adamw_decays_what_jax_decays():
    """Weight decay and 8-bit moments follow the JAX tree's ranks: the
    blocks' norm scales are stacked over repeats there (rank 2)."""
    model = get_config("qwen3-0.6b").reduced().with_quant(TQ.QAT)
    from repro_torch.models import build_model
    m = build_model(model, gen=torch.Generator().manual_seed(0), device="cpu")
    params = dict(m.named_parameters())
    ranks = TTr.jax_ranks(params)
    jranks = {k.replace("/", "."): v.ndim for k, v in _flat(
        jbuild(jget("qwen3-0.6b").reduced().with_quant(JQ.QAT)).init(
            jax.random.PRNGKey(0))).items()}
    for name, r in ranks.items():
        if name.startswith("stack.layers."):
            parts = name.split(".")
            name = ".".join(["stack", "pos0", *parts[3:]])
        assert jranks[name] == r, name


# -- the train and distill steps --------------------------------------------------

def _models(name, use_kernel):
    jt = jget(name).reduced()
    js = jt.with_quant(JQ.QuantConfig(mode="qat", use_kernel=use_kernel))
    tparams = jbuild(jt).init(jax.random.PRNGKey(0))
    sparams = JP._copy_matching(tparams, jbuild(js).init(jax.random.PRNGKey(1)))
    tt = get_config(name).reduced()
    ts = tt.with_quant(TQ.QuantConfig(mode="qat", use_kernel=use_kernel))
    teacher = jax_params_to_torch(tt, jax.tree_util.tree_map(np.asarray, tparams),
                                  device="cpu")
    student = jax_params_to_torch(ts, jax.tree_util.tree_map(np.asarray, sparams),
                                  device="cpu")
    return (jt, js, tparams, sparams), (tt, ts, teacher, student)


@pytest.mark.parametrize("name,use_kernel", [("qwen3-0.6b", True),
                                             ("qwen3-0.6b", False),
                                             ("qwen1.5-0.5b", True)])
def test_train_then_distill_steps_match_jax(name, use_kernel):
    """One CE step, then a distill step with accum 1 and one with accum 2,
    on one optimizer state; metrics and every updated parameter vs JAX."""
    (jt, js, tparams, sparams), (tt, ts, teacher, student) = _models(name, use_kernel)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 268, (4, 16)).astype(np.int32),
                "labels": rng.integers(0, 268, (4, 16)).astype(np.int32),
                "loss_mask": (rng.uniform(size=(4, 16)) < 0.7).astype(np.float32)}
               for _ in range(3)]
    dl = JTr.default_distill_layer(js)
    assert dl == TTr.default_distill_layer(ts) == 1
    jd = JDistillConfig(use_kernel=use_kernel, distill_layer=dl)
    td = DistillConfig(use_kernel=use_kernel, distill_layer=dl)
    jopt, topt = JO.AdamW(JO.AdamWConfig()), TO.AdamW(TO.AdamWConfig())
    jlr, tlr = (lambda s: JSch.constant(s, 1e-4)), (lambda s: TSch.constant(s, 1e-4))
    jsm, jtm = jbuild(js), jbuild(jt)
    jsteps = [jax.jit(JTr.make_train_step(jsm, jopt, jlr)),
              jax.jit(JTr.make_distill_step(jsm, jtm, jopt, jlr, jd)),
              jax.jit(JTr.make_distill_step(jsm, jtm, jopt, jlr, jd, accum=2))]
    tsteps = [TTr.make_train_step(student, topt, tlr),
              TTr.make_distill_step(student, teacher, topt, tlr, td),
              TTr.make_distill_step(student, teacher, topt, tlr, td, accum=2)]
    jstate, tstate = JTr.init_train_state(sparams, jopt), TTr.init_train_state(student, topt)
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        extra = () if i == 0 else (tparams,)
        jstate, jm = jsteps[i](jstate, jb, *extra)
        tstate, tm = tsteps[i](tstate, {k: _t(v) for k, v in b.items()})
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=2e-7, err_msg=f"step {i} {k}")
        want, got = _flat(jstate.params), _flat(jax_params_from_torch(ts, student))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert tstate.step == int(jstate.step) == 3
    # the teacher is never updated
    for k, v in _flat(jax_params_from_torch(tt, teacher)).items():
        np.testing.assert_array_equal(v, _flat(tparams)[k])


def test_eval_steps_match_jax():
    (jt, js, tparams, sparams), (tt, ts, teacher, student) = _models("qwen3-0.6b", False)
    b = TL.DataLoader(TS.get_task("mnli-syn"), 4, 32, seed=9).next()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    np.testing.assert_allclose(float(TTr.make_eval_loss(teacher)(tb)),
                               float(JTr.make_eval_loss(jbuild(jt))(tparams, jb)),
                               rtol=1e-5)
    tok = TT.ByteTokenizer()
    acc_t = TTr.make_eval_classify(teacher, tok.label_base, 3)(tb)
    acc_j = JTr.make_eval_classify(jbuild(jt), tok.label_base, 3)(tparams, jb)
    assert float(acc_t) == float(acc_j)


# -- the pipeline -----------------------------------------------------------------

def test_pipeline_stages_match_jax():
    """Teacher SFT, refine, continued pre-training, distillation and the
    BitNet-SFT baseline, three steps each.  Each port stage starts from the
    JAX stage's own input, carried over by the bridge, so that what one
    stage leaves a few ulp apart does not reach the next."""
    kw = dict(task="mnli-syn", seq_len=32, batch_size=4, ct_steps=3, sft_steps=3,
              warmup=1, log_every=1, eval_batches=2)
    jpipe = JP.BitDistillPipeline(jget("qwen3-0.6b").reduced(), JP.PipelineConfig(**kw))
    tpipe = TP.BitDistillPipeline(get_config("qwen3-0.6b").reduced(),
                                  TP.PipelineConfig(**kw), device="cpu")
    tcfg, scfg = tpipe.teacher_config(), tpipe.student_config()
    port = lambda cfg, tree: jax_params_to_torch(
        cfg, jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    key = jax.random.PRNGKey(0)
    init = jbuild(jpipe.teacher_config()).init(key)
    jts, _ = jpipe.train_teacher(key)
    tpipe.train_teacher(model=port(tcfg, init))
    teacher = port(tcfg, jts.params)
    jsp = jpipe.refine(jts.params)
    student = tpipe.refine(teacher)
    for k, v in _flat(jax_params_from_torch(scfg, student)).items():
        np.testing.assert_array_equal(v, _flat(jsp)[k], err_msg=k)
    jct, _ = jpipe.continue_pretrain(jsp)
    tpipe.continue_pretrain(port(scfg, jsp))
    jdist, _ = jpipe.distill_finetune(jct, jts.params)
    student, _ = tpipe.distill_finetune(port(scfg, jct), teacher)
    jpipe.bitnet_sft(jsp)
    tpipe.bitnet_sft(port(scfg, jsp))
    assert set(tpipe.results) == set(jpipe.results) == {"fp16_sft", "ct", "distill",
                                                        "bitnet_sft"}
    for stage, jr in jpipe.results.items():
        tr = tpipe.results[stage]
        assert (tr.name, tr.steps) == (jr.name, jr.steps)
        assert len(tr.metrics_history) == len(jr.metrics_history) == 3
        for th, jh in zip(tr.metrics_history, jr.metrics_history):
            assert set(th) == set(jh)
            for k in jh:
                np.testing.assert_allclose(th[k], jh[k],
                                           rtol=1e-2 if k == "grad_norm" else 1e-4,
                                           atol=2e-7, err_msg=f"{stage} {k}")
        np.testing.assert_allclose(tr.final_loss, jr.final_loss, rtol=1e-4)
    assert tpipe.eval_accuracy(port(scfg, jdist), quantized=True) == \
        jpipe.eval_accuracy(jdist, quantized=True)
    assert tpipe.eval_accuracy(teacher, quantized=False) == \
        jpipe.eval_accuracy(jts.params, quantized=False)
    with pytest.raises(ValueError, match="quantized"):
        tpipe.eval_accuracy(student, quantized=False)


# -- the launcher -------------------------------------------------------------------

def test_launch_train_runs_on_cpu_and_refuses_unported_flags(capsys, tmp_path):
    """Checkpoints are ported (each run gets its own ``--ckpt-dir``: the
    default directory is shared and resumed from); a mesh of more ranks
    than the process (one, not under ``torch.distributed.run``) is refused
    by ``make_mesh`` (the sharded runs: tests/test_torch_distributed.py)."""
    launch_train.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--log-every", "1", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and out.strip().endswith("done")
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["LATEST", "step_00000001", "step_00000002"]
    for flag, mesh in ((["--dp", "2"], "1x2x1=2"), (["--tp", "2"], "1x1x2=2"),
                       (["--pods", "2"], "2x1x1=2")):
        with pytest.raises(ValueError, match=f"mesh {mesh} needs 2 ranks; the "
                                             "process group has 1"):
            launch_train.main(["--arch", "qwen3-0.6b", "--reduced", "--device",
                               "cpu", "--ckpt-dir", str(tmp_path), *flag])

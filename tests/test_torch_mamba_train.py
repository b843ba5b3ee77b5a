"""Port vs JAX: BitDistill training of ``mamba2-780m`` (reduced: d_model
128, 2 layers, state 16, head_dim 16, chunk 16, fp32) on the CPU.

Parameters come from the JAX ``init`` through ``repro_torch.bridge``;
batches from numpy seeds or the pipeline's loaders.  The family is
attention-free, so the distillation loss is CE + logits KD (the pipeline
turns relation KD off for ``ssm``).  Tolerances as
``tests/test_torch_train.py``: metrics rtol 1e-5 (logits-KD part with an
absolute floor of 2e-7); every updated parameter rtol 1e-4, atol 1e-5, at
the pipeline's SFT rate 1e-4 (Adam's first update amplifies
summation-order noise on near-zero gradients at larger rates).  The
pipeline's distillation stage (two steps, the second after an Adam update):
metrics rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core import quant as JQ
from repro.core.distill import DistillConfig as JDistillConfig
from repro.models import build_model as jbuild, get_config as jget
from repro.training import optimizer as JO, schedule as JSch, trainer as JTr
from repro_torch.bridge import jax_params_from_torch, jax_params_to_torch
from repro_torch.core import pipeline as TP
from repro_torch.core import quant as TQ
from repro_torch.core.distill import DistillConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, get_config
from repro_torch.training import optimizer as TO, schedule as TSch, trainer as TTr

NAME = "mamba2-780m"


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(cfg, tree):
    return jax_params_to_torch(cfg, jax.tree_util.tree_map(np.asarray, tree),
                               device="cpu")


def _models(use_kernel):
    jt = jget(NAME).reduced()
    js = jt.with_quant(JQ.QuantConfig(mode="qat", use_kernel=use_kernel))
    tparams = jbuild(jt).init(jax.random.PRNGKey(0))
    sparams = JP._copy_matching(tparams, jbuild(js).init(jax.random.PRNGKey(1)))
    tt = get_config(NAME).reduced()
    ts = tt.with_quant(TQ.QuantConfig(mode="qat", use_kernel=use_kernel))
    return (jt, js, tparams, sparams), (tt, ts, _port(tt, tparams), _port(ts, sparams))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_train_then_distill_steps_match_jax(use_kernel):
    """One CE step, then one distill step (CE + logits KD), on one
    optimizer state; metrics and every updated parameter vs JAX."""
    (jt, js, tparams, sparams), (tt, ts, teacher, student) = _models(use_kernel)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 268, (4, 40)).astype(np.int32),
                "labels": rng.integers(0, 268, (4, 40)).astype(np.int32),
                "loss_mask": (rng.uniform(size=(4, 40)) < 0.7).astype(np.float32)}
               for _ in range(2)]
    jd = JDistillConfig(use_kernel=use_kernel, use_ad=False)
    td = DistillConfig(use_kernel=use_kernel, use_ad=False)
    jopt, topt = JO.AdamW(JO.AdamWConfig()), TO.AdamW(TO.AdamWConfig())
    jlr, tlr = (lambda s: JSch.constant(s, 1e-4)), (lambda s: TSch.constant(s, 1e-4))
    jsm, jtm = jbuild(js), jbuild(jt)
    jsteps = [jax.jit(JTr.make_train_step(jsm, jopt, jlr)),
              jax.jit(JTr.make_distill_step(jsm, jtm, jopt, jlr, jd))]
    tsteps = [TTr.make_train_step(student, topt, tlr),
              TTr.make_distill_step(student, teacher, topt, tlr, td)]
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
    assert tstate.step == int(jstate.step) == 2
    for k, v in _flat(jax_params_from_torch(tt, teacher)).items():
        np.testing.assert_array_equal(v, _flat(tparams)[k])


def test_weight_decay_ranks_match_jax():
    """The stacked rank-2 A_log / D / dt_bias / conv_b leaves (rank 1 per
    layer here) are weight-decayed as in JAX; the final norm is not."""
    cfg = get_config(NAME).reduced().with_quant(TQ.QAT)
    m = build_model(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
    ranks = TTr.jax_ranks(dict(m.named_parameters()))
    jranks = {k.replace("/", "."): v.ndim for k, v in _flat(
        jbuild(jget(NAME).reduced().with_quant(JQ.QAT)).init(
            jax.random.PRNGKey(0))).items()}
    for name, r in ranks.items():
        if name.startswith("stack.layers."):
            name = ".".join(["stack", "pos0", *name.split(".")[3:]])
        assert jranks[name] == r, name
    for leaf in ("A_log", "D", "dt_bias", "conv_b"):
        assert ranks[f"stack.layers.1.mamba.{leaf}"] == 2
    assert ranks["final_norm.scale"] == 1


def test_pipeline_distill_stage_drops_relation_kd_and_matches_jax():
    """``distill_finetune`` on the ssm family turns ``use_ad`` off (no
    attention layer to distill) and runs the stage as JAX's does, from the
    same student and teacher weights."""
    kw = dict(task="mnli-syn", seq_len=32, batch_size=4, sft_steps=2, warmup=1,
              log_every=1)
    jpipe = JP.BitDistillPipeline(jget(NAME).reduced(), JP.PipelineConfig(**kw))
    tpipe = TP.BitDistillPipeline(get_config(NAME).reduced(),
                                  TP.PipelineConfig(**kw), device="cpu")
    assert tpipe.pcfg.distill.use_ad            # the default asks for it
    tparams = jbuild(jpipe.teacher_config()).init(jax.random.PRNGKey(0))
    sparams = jpipe.refine(tparams)
    teacher = _port(tpipe.teacher_config(), tparams)
    student = tpipe.refine(teacher)
    for k, v in _flat(jax_params_from_torch(tpipe.student_config(), student)).items():
        np.testing.assert_array_equal(v, _flat(sparams)[k], err_msg=k)
    jpipe.distill_finetune(sparams, tparams)
    tpipe.distill_finetune(student, teacher)
    jr, tr = jpipe.results["distill"], tpipe.results["distill"]
    assert len(tr.metrics_history) == len(jr.metrics_history) == 2
    for th, jh in zip(tr.metrics_history, jr.metrics_history):
        assert set(th) == set(jh)
        assert "loss_ad" not in th and "loss_ad" not in jh
        for k in jh:
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, atol=2e-7,
                                       err_msg=k)


def test_launch_train_runs_mamba_on_cpu(capsys, tmp_path):
    launch_train.main(["--arch", NAME, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "32",
                       "--log-every", "1", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and out.strip().endswith("done")
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert all(np.isfinite(losses))

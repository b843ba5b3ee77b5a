"""Port vs JAX: the registered configs, ``configs/shapes.py``, and the dense
configs the port builds (gemma-7b, qwen2.5-3b, mistral-large-123b) on
reduced fp32 configs, on the CPU (the MoE and hybrid ones:
tests/test_torch_moe_configs.py).

Params come from the JAX ``init`` (PRNGKey(0)) through ``repro_torch.bridge``
and inputs from numpy seeds.  Tolerances: FP logits rtol/atol 1e-4 as in
tests/test_torch_model.py (fp32 summation order only); greedy tokens
exactly; the QAT step's loss and grad_norm rtol 1e-4, as the pipeline's
losses in tests/test_torch_train.py, and for its reason: an fp32 difference
upstream can flip an int8 activation code at a .5 boundary.  Here one token
of 64 flips in qwen2.5-3b's and mistral-large-123b's QAT forward (its logits
move by 3e-3 and 1.2e-2) and moves mistral's loss by 1.4e-5 and grad_norm by
1.2e-5 (relative); gemma-7b's agree to 1e-7.  The plain paged versions at head_dim 256 1e-5 absolute against
JAX's oracles and Pallas kernels in interpret mode, pools bitwise outside
the trash block (tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.configs import shapes as jshapes
from repro.core import quant as JQ
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import convert_to_packed as jconvert
from repro.training import optimizer as JO, schedule as JSch, trainer as JTr
from repro_torch.bridge import jax_params_to_torch
from repro_torch.configs import shapes as tshapes
from repro_torch.core import quant as TQ
from repro_torch.models import build_model, get_config
from repro_torch.serving import Engine, SamplingParams, ServeConfig
from repro_torch.training import optimizer as TO, schedule as TSch, trainer as TTr
from test_chunked_prefill import make_schedule
from test_torch_kernels import (_assert_paged, _assert_prefill, _paged_case,
                                _prefill_case)

NAMES = sorted({c.name for c in jconfigs.ASSIGNED + jconfigs.PAPER_BACKBONES})
DENSE = ["gemma-7b", "qwen2.5-3b", "mistral-large-123b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fields(cfg):
    d = dict(cfg.__dict__)
    d["quant"] = dict(d["quant"].__dict__)
    d["pattern"] = tuple((s.mixer, s.ffn) for s in d["pattern"])
    return d


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_jax_field_for_field(name):
    for reduce in (False, True):
        jc, tc = jget(name), get_config(name)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert _fields(tc) == _fields(jc), (name, reduce)
        assert (tc.repeats, tc.padded_vocab) == (jc.repeats, jc.padded_vocab)
        assert [(s.mixer, s.ffn) for s in tc.resolved_pattern()] == \
            [(s.mixer, s.ffn) for s in jc.resolved_pattern()]


def test_assigned_shapes_and_cells_match_jax():
    assert [c.name for c in tconfigs.ASSIGNED] == [c.name for c in jconfigs.ASSIGNED]
    assert [c.name for c in tconfigs.PAPER_BACKBONES] == \
        [c.name for c in jconfigs.PAPER_BACKBONES]
    assert tconfigs.shapes is tshapes and tshapes.__name__.startswith("repro_torch")
    assert {k: v.__dict__ for k, v in tshapes.SHAPES.items()} == \
        {k: v.__dict__ for k, v in jshapes.SHAPES.items()}
    assert tshapes.LONG_CONTEXT_FAMILIES == jshapes.LONG_CONTEXT_FAMILIES
    cells = tshapes.all_cells(tconfigs.ASSIGNED)
    assert len(cells) == 40
    assert cells == jshapes.all_cells(jconfigs.ASSIGNED)
    assert tshapes.all_cells(tconfigs.ASSIGNED, ["long_500k"]) == \
        jshapes.all_cells(jconfigs.ASSIGNED, ["long_500k"])


@pytest.mark.parametrize("name", DENSE)
def test_forward_and_qat_step_match_jax(name):
    """FP logits, then one CE train step of the QAT student (the plain
    bitlinear route on the CPU): loss and grad_norm."""
    jcfg, tcfg = jget(name).reduced(), get_config(name).reduced()
    params = jbuild(jcfg).init(jax.random.PRNGKey(0))
    model = jax_params_to_torch(tcfg, _np_tree(params), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    want = np.asarray(jbuild(jcfg).apply(params, jnp.asarray(toks))[0])
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))

    js, ts = jcfg.with_quant(JQ.QAT), tcfg.with_quant(TQ.QAT)
    sparams = jbuild(js).init(jax.random.PRNGKey(1))
    student = jax_params_to_torch(ts, _np_tree(sparams), device="cpu")
    batch = {"tokens": rng.integers(0, 268, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, 268, (4, 16)).astype(np.int32),
             "loss_mask": (rng.uniform(size=(4, 16)) < 0.7).astype(np.float32)}
    jopt, topt = JO.AdamW(JO.AdamWConfig()), TO.AdamW(TO.AdamWConfig())
    jstep = jax.jit(JTr.make_train_step(jbuild(js), jopt,
                                        lambda s: JSch.constant(s, 1e-4)))
    tstep = TTr.make_train_step(student, topt, lambda s: TSch.constant(s, 1e-4))
    _, jm = jstep(JTr.init_train_state(sparams, jopt),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tstep(TTr.init_train_state(student, topt),
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=f"{name} {k}")


def test_gemma_engine_greedy_matches_jax():
    """gemma-7b reduced (GeGLU, embed_scale, MHA, head_dim 32 reduced):
    the port's engine on both attention routes against the JAX engine
    (gather), token for token, over a seeded arrival schedule.  The params
    come from the JAX ``convert_to_packed`` of a PRNGKey(0) init, which is
    where that function's output is right (tests/test_torch_engine.py)."""
    jcfg = jget("gemma-7b").reduced().with_quant(JQ.QAT)
    pcfg, pparams = jconvert(jcfg, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = get_config("gemma-7b").reduced().with_quant(TQ.PACKED)
    model = jax_params_to_torch(tcfg, _np_tree(pparams), device="cpu")
    schedule = make_schedule(0)
    base = dict(max_batch=3, max_len=24, kv_block_size=4, prefill_chunk=32,
                prefix_cache=True)

    def drive(eng, sp):
        reqs, step = {}, 0
        while eng.has_pending() or step <= max(schedule):
            for prompt in schedule.get(step, []):
                r = eng.submit(prompt, sp)
                reqs[r.uid] = r
            eng.step()
            step += 1
            assert step < 3000
        return {uid: r.output_tokens for uid, r in reqs.items()}

    want = drive(JEngine(pcfg, pparams, JServeConfig(paged=True, **base)),
                 JSamplingParams(max_tokens=6, ignore_eos=True))
    for impl in ("gather", "fused"):
        got = drive(Engine(tcfg, model, ServeConfig(attn_impl=impl, **base)),
                    SamplingParams(max_tokens=6, ignore_eos=True))
        assert got == want, impl


@pytest.mark.parametrize("args", [
    # gemma's MHA (g = 1) and a GQA ratio, mixed depths, at head_dim 256
    (2, 2, 2, 256, 4, 3, [5, 9]),
    (2, 4, 2, 256, 4, 3, [0, 11]),
])
def test_plain_paged_decode_at_head_dim_256_matches_jax(args):
    got, ref, pal, live = _paged_case(*args, softcap=0.0, seed=256)
    _assert_paged(got, ref, live)
    _assert_paged(got, pal, live)


def test_plain_paged_prefill_at_head_dim_256_matches_jax():
    lens = [4, 1]
    got, ref, pal, live = _prefill_case(2, 2, 2, 256, 4, 4, 4, [3, 9], lens,
                                        seed=256)
    _assert_prefill(got, ref, live, lens)
    _assert_prefill(got, pal, live, lens)

"""Port vs JAX: the MoE and hybrid configs (granite-moe-1b-a400m, grok-1-314b
with its attention logit softcap of 30, jamba-1.5-large-398b's hybrid
stack) on reduced fp32 configs, on the CPU; jamba at ``reduced(layers=8)``,
one repeat of its eight-layer pattern.

Params come from the JAX ``init`` through ``repro_torch.bridge``, inputs
from numpy seeds.  Tolerances are those of tests/test_torch_dense_configs.py:
FP logits rtol/atol 1e-4 with argmax equal, the auxiliary MoE loss rtol
1e-5, the QAT step's loss and grad_norm rtol 1e-4.  Parameters and a
trained granite train state round-trip exactly, through the bridge and the
checkpoint format.  Serving: tests/test_torch_moe_serving.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.ckpt as jckpt
from repro.core import quant as JQ
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.training import optimizer as JO, schedule as JSch, trainer as JTr
from repro_torch import bridge
from repro_torch.bridge import jax_params_from_torch, jax_params_to_torch
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import quant as TQ
from repro_torch.models import build_model, get_config
from repro_torch.nn.module import flatten_with_paths
from repro_torch.training import optimizer as TO, schedule as TSch, trainer as TTr

# name -> layers of the reduced config (None: JAX's reduced() depth)
LAYERS = {"granite-moe-1b-a400m": None, "grok-1-314b": None,
          "jamba-1.5-large-398b": 8}
NAMES = sorted(LAYERS)
# the configs whose QAT step is held to JAX's op-by-op evaluation
# (``_BlockByBlock``)
BLOCK_BY_BLOCK = ("jamba-1.5-large-398b",)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(name, **kw):
    return (jget(name).reduced(layers=LAYERS[name]).replace(**kw),
            get_config(name).reduced(layers=LAYERS[name]).replace(**kw))


@pytest.mark.parametrize("name", NAMES)
def test_param_counts_match_jax(name):
    jc, tc = jget(name), get_config(name)
    assert (tc.param_count(), tc.active_param_count()) == \
        (jc.param_count(), jc.active_param_count())
    assert tc.active_param_count() < tc.param_count()


class _BlockByBlock:
    """JAX's ``CausalLM.apply`` with the stack's blocks applied one by one
    (each repeat's params sliced out), outside ``lax.scan`` and not jitted:
    the port's order of operations.  XLA compiles a block (scanned, or
    jitted alone) with other fp32 roundings than the same operations run
    one by one; at jamba's eight layers that flips one int8 activation code
    of the QAT forward (layer 4, row 1, token 6, the mamba + dense block:
    JAX's compiled and op-by-op evaluations then differ by 1.8e-3 there and
    0.038 in the logits), which moves JAX's own grad_norm by 1.2e-4 between
    them.  The port agrees with the op-by-op evaluation to ~2e-6 in every
    hidden state."""

    def __init__(self, cfg):
        self.model = jbuild(cfg)

    def apply(self, p, tokens, memory=None, distill_layer=None):
        m = self.model
        stack = m._stack()
        x = m._embed().apply(p["embed"], tokens)
        moe = jnp.zeros((), jnp.float32)
        for r in range(stack.repeats):
            for i, blk in enumerate(stack.blocks()):
                x, _, ml = blk.apply(jax.tree_util.tree_map(
                    lambda a: a[r], p["stack"][f"pos{i}"]), x)
                moe = moe + ml
        x = m._final_norm().apply(p["final_norm"], x)
        return m._logits(p, x), None, moe


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_qat_step_match_jax(name):
    """FP logits and the summed auxiliary MoE loss (capacity-limited, as
    ``CausalLM.apply`` runs it), then one CE train step of the QAT student
    (loss = CE + MoE loss): loss, grad_norm and the MoE loss, against JAX's
    jitted step, or for jamba its step run block by block, op by op
    (``_BlockByBlock``; ~45 s on the CPU where the jitted step takes ~5)."""
    jcfg, tcfg = _cfgs(name)
    params = jbuild(jcfg).init(jax.random.PRNGKey(0))
    model = jax_params_to_torch(tcfg, _np_tree(params), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    jl, _, jmoe = jbuild(jcfg).apply(params, jnp.asarray(toks))
    with torch.no_grad():
        tl, _, tmoe = model.apply(torch.from_numpy(toks).long())
    want, got = np.asarray(jl), tl.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert float(jmoe) > 0
    np.testing.assert_allclose(float(tmoe), float(jmoe), rtol=1e-5)

    js, ts = jcfg.with_quant(JQ.QAT), tcfg.with_quant(TQ.QAT)
    sparams = jbuild(js).init(jax.random.PRNGKey(1))
    student = jax_params_to_torch(ts, _np_tree(sparams), device="cpu")
    batch = {"tokens": rng.integers(0, 268, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, 268, (4, 16)).astype(np.int32),
             "loss_mask": (rng.uniform(size=(4, 16)) < 0.7).astype(np.float32)}
    jopt, topt = JO.AdamW(JO.AdamWConfig()), TO.AdamW(TO.AdamWConfig())
    lr = lambda s: JSch.constant(s, 1e-4)
    if name in BLOCK_BY_BLOCK:
        jstep = JTr.make_train_step(_BlockByBlock(js), jopt, lr)
    else:
        jstep = jax.jit(JTr.make_train_step(jbuild(js), jopt, lr))
    tstep = TTr.make_train_step(student, topt, lambda s: TSch.constant(s, 1e-4))
    _, jm = jstep(JTr.init_train_state(sparams, jopt),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tstep(TTr.init_train_state(student, topt),
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "loss_moe"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_params_round_trip_through_the_bridge(name):
    """JAX params -> port -> JAX params is the identity, leaf for leaf and
    dtype for dtype (bf16 leaves come back as their fp32 values); with bf16
    parameters (grok's and jamba's full configs) the router stays fp32."""
    jcfg, tcfg = _cfgs(name, param_dtype="bfloat16")
    params = _np_tree(jbuild(jcfg).init(jax.random.PRNGKey(5)))
    model = jax_params_to_torch(tcfg, params, device="cpu")
    moe = [blk.mlp for blk in model.stack.layers if blk.spec.ffn == "moe"]
    assert moe and {(m.router.w.dtype, m.up.w.dtype) for m in moe} == \
        {(torch.float32, torch.bfloat16)}
    back = jax_params_from_torch(tcfg, model)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = flatten_with_paths(back)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w.dtype == jnp.bfloat16:    # back as its exact fp32 values
            w = w.astype(np.float32)
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_granite_train_state_round_trips_through_the_jax_format(tmp_path):
    """A trained port state saved in the checkpoint format loads in JAX leaf
    for leaf (the experts rank 4 and the router rank 3 in JAX's tree, so
    AdamW decays them as JAX does); JAX saves it again and the port loads
    it into a fresh state equal to the first."""
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    cfg = tcfg.with_quant(TQ.QAT)
    model = build_model(cfg, gen=torch.Generator().manual_seed(3), device="cpu")
    opt = TO.AdamW(TO.AdamWConfig())
    state = TTr.init_train_state(model, opt)
    ranks = TTr.jax_ranks(state.params)
    assert ranks["stack.layers.1.mlp.up.w"] == 4
    assert ranks["stack.layers.1.mlp.router.w"] == 3
    step = TTr.make_train_step(model, opt, lambda s: TSch.constant(s, 1e-3))
    rng = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(rng.integers(0, 268, (2, 16)).astype(np.int32)),
         "labels": torch.from_numpy(rng.integers(0, 268, (2, 16)).astype(np.int32))}
    state, m = step(state, b)
    assert float(m["loss_moe"]) > 0
    mine = bridge.train_state_to_jax(cfg, state)
    save_checkpoint(tmp_path / "a", 1, mine, extra={"loader": {"step": 1}})
    jcfg = jget("granite-moe-1b-a400m").reduced().with_quant(JQ.QAT)
    jopt = JO.AdamW(JO.AdamWConfig())
    tmpl = jax.eval_shape(lambda: JTr.init_train_state(
        jbuild(jcfg).init(jax.random.PRNGKey(0)), jopt))
    jstate, extra, s = jckpt.load_checkpoint(str(tmp_path / "a"), tmpl)
    want = flatten_with_paths(mine)
    got = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert sorted(got) == sorted(want) and (s, int(jstate.step)) == (1, 1)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy(), err_msg=k)
    jckpt.save_checkpoint(str(tmp_path / "b"), 1, jstate, extra=extra)

    fresh = build_model(cfg, gen=torch.Generator().manual_seed(9), device="cpu")
    state2 = TTr.init_train_state(fresh, opt)
    loaded, _, _ = load_checkpoint(tmp_path / "b",
                                   bridge.train_state_to_jax(cfg, state2, device="meta"))
    bridge.load_train_state(cfg, loaded, state2)
    again = flatten_with_paths(bridge.train_state_to_jax(cfg, state2))
    assert list(again) == list(want)
    for k in want:
        assert torch.equal(again[k], want[k]), k

"""Port vs JAX: serving the MoE and hybrid configs on the CPU: granite-moe-1b-
a400m on the paged cache, jamba-1.5-large-398b's hybrid stack (one repeat
of its eight layers) on the contiguous cache, and the packed experts.

The engines are held to the JAX ``Engine`` token for token (greedy,
reduced fp32 configs) with params from JAX's ``convert_to_packed`` of a
PRNGKey(0) init (where that function's output is right; ROADMAP Queue C),
which copies the experts latent.  The port's own ``convert_to_packed``
stores them quantized: a packed MoE block then equals the QAT block bit for
bit, where JAX's serves other weights than it trained (the last two
tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.models import build_model as jbuild
from repro.nn import moe as JM
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import convert_to_packed as jconvert
from repro_torch.bridge import jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.models import build_model
from repro_torch.nn import moe as TM
from repro_torch.nn.moe import MoEMLP
from repro_torch.serving import Engine, SamplingParams, ServeConfig
from repro_torch.serving.engine import convert_to_packed
from test_chunked_prefill import make_schedule
from test_torch_moe_configs import _cfgs, _np_tree


def _drive(eng, schedule, sp):
    reqs, step = {}, 0
    while eng.has_pending() or step <= max(schedule):
        for prompt in schedule.get(step, []):
            r = eng.submit(prompt, sp)
            reqs[r.uid] = r
        eng.step()
        step += 1
        assert step < 3000
    return {uid: r.output_tokens for uid, r in reqs.items()}


def _packed(name):
    """(JAX packed cfg, params, port packed cfg, model): JAX's
    ``convert_to_packed`` of a PRNGKey(0) QAT init, through the bridge."""
    jcfg, tcfg = _cfgs(name)
    jcfg = jcfg.with_quant(JQ.QAT)
    pcfg, pparams = jconvert(jcfg, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = tcfg.with_quant(TQ.PACKED)
    return pcfg, pparams, tcfg, jax_params_to_torch(tcfg, _np_tree(pparams),
                                                    device="cpu")


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_granite_engine_greedy_matches_jax(prefix_cache):
    """granite on the paged cache (MoE FFN at full capacity in every decode
    and chunk step), both attention routes, against the JAX engine token
    for token over a seeded arrival schedule."""
    pcfg, pparams, tcfg, model = _packed("granite-moe-1b-a400m")
    schedule = make_schedule(0)
    base = dict(max_batch=3, max_len=24, kv_block_size=4, prefill_chunk=32,
                prefix_cache=prefix_cache)
    want = _drive(JEngine(pcfg, pparams, JServeConfig(paged=True, **base)),
                  schedule, JSamplingParams(max_tokens=6, ignore_eos=True))
    for impl in ("gather", "fused"):
        eng = Engine(tcfg, model, ServeConfig(attn_impl=impl, **base))
        assert eng.paged
        got = _drive(eng, schedule, SamplingParams(max_tokens=6, ignore_eos=True))
        assert got == want, impl


@pytest.mark.parametrize("prefill_chunk", [0, 4])
def test_jamba_engine_greedy_matches_jax(prefill_chunk):
    """jamba's hybrid stack (attention K/V beside the mamba state and conv
    tail) on the contiguous cache, against the JAX engine on a fresh-slot,
    fault-free schedule (tests/test_torch_ssm_serving.py says why)."""
    pcfg, pparams, tcfg, model = _packed("jamba-1.5-large-398b")
    prompts = [[5, 9, 3, 7, 11, 2, 8, 4, 1], [13, 1, 6, 2, 7], [3, 4, 5]]
    kw = dict(max_batch=3, max_len=24, prefill_chunk=prefill_chunk)

    def serve(eng, sp):
        reqs = [eng.submit(p, sp) for p in prompts]
        for _ in eng.stream():
            pass
        return [list(r.output_tokens) for r in reqs]

    want = serve(JEngine(pcfg, pparams, JServeConfig(**kw)),
                 JSamplingParams(max_tokens=6, ignore_eos=True))
    eng = Engine(tcfg, model, ServeConfig(**kw))
    got = serve(eng, SamplingParams(max_tokens=6, ignore_eos=True))
    assert not eng.paged and eng._ring is not None
    assert got == want


def test_jamba_cache_and_ring_hold_attention_beside_mamba():
    """Layer 0 of jamba's pattern is attention: the contiguous cache holds
    its K/V, the seven mamba layers their state and tail, and the
    recurrent ring takes the mamba layers only, at the mamba shapes."""
    _, tcfg = _cfgs("jamba-1.5-large-398b")
    model = build_model(tcfg.with_quant(TQ.QAT), gen=torch.Generator().manual_seed(0),
                        device="cpu")
    _, packed = convert_to_packed(tcfg.with_quant(TQ.QAT), model)
    eng = Engine(tcfg.with_quant(TQ.PACKED), packed,
                 ServeConfig(max_batch=2, max_len=16))
    eng._ensure_state()
    cache = eng._cache
    assert [set(layer) for layer in cache] == [{"attn"}] + [{"mamba"}] * 7
    ring = eng._ring
    assert ring.state.shape[:2] == (3, 7)
    assert tuple(ring.state.shape[2:]) == tuple(cache[1]["mamba"]["state"].shape)
    for view in ring.views:
        assert view[0] is cache[0]
        assert [set(layer) for layer in view] == [set(layer) for layer in cache]


def test_full_capacity_moe_rows_do_not_see_each_other():
    """At full capacity (every decode and chunk step) what a chunk step's pad
    rows hold changes no other row's routing: every pick is kept, so a pad
    row takes expert slots but never a real row's place.  The real rows'
    outputs then differ only by the expert matmuls' rounding at other row
    positions (within 1e-6 of max|y|; the engine tests hold the tokens).
    Capacity-limited, the same pad rows drop real rows' picks."""
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    model = build_model(tcfg, gen=torch.Generator().manual_seed(0), device="cpu")
    moe = model.stack.layers[0].mlp
    x = torch.randn((3, 7, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    real = torch.tensor([0, 1, 2, 3, 4, 5, 6, 14, 15, 16, 17, 18, 19, 20])
    outs, dropped = [], []
    for pad in (x[1], torch.zeros_like(x[1]), x[0], -3 * x[2], x[2].flip(0)):
        xp = x.clone()
        xp[1] = pad
        with torch.no_grad():
            outs.append(moe(xp, full_capacity=True)[0][[0, 2]])
            for full in (True, False):
                logits = torch.einsum("gsd,de->gse", xp.reshape(1, 21, -1),
                                      moe.router.w)
                cap = TM.capacity(21, moe.top_k, moe.n_experts,
                                  moe.capacity_factor, full)
                _, _, top_e, onehot, _, in_cap = TM.route(logits, moe.top_k, cap)
                lost = int(((onehot > 0) & ~in_cap)[0, real].sum())
                if full:
                    assert lost == 0
                else:
                    dropped.append(lost)
    for o in outs[1:]:
        assert float((o - outs[0]).abs().max()) <= 1e-6 * float(outs[0].abs().max())
    assert len(set(dropped)) > 1


def test_packed_moe_runs_the_qat_experts():
    """The port's ``convert_to_packed`` stores each expert quantized on its
    own (the router and norms copied), so every packed MoE block's output
    equals the QAT block's at full capacity, and so do the logits of a
    decode step."""
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    qcfg = tcfg.with_quant(TQ.QAT)
    qat = build_model(qcfg, gen=torch.Generator().manual_seed(2), device="cpu")
    pcfg, packed = convert_to_packed(qcfg, qat)
    x = torch.randn((2, 5, tcfg.d_model), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for lq, lp in zip(qat.stack.layers, packed.stack.layers):
            assert isinstance(lp.mlp, MoEMLP)
            assert torch.equal(lp.mlp.router.w, lq.mlp.router.w)
            assert not torch.equal(lp.mlp.up.w, lq.mlp.up.w)
            assert torch.equal(lp.mlp.up.w, lq.mlp.quantized(lq.mlp.up.w))
            want, _ = lq.mlp(x, full_capacity=True)
            got, _ = lp.mlp(x, full_capacity=True)
            assert torch.equal(got, want)


def test_jax_packed_moe_serves_the_latent_experts():
    """The reference fault the port repairs (ROADMAP Queue C): JAX's
    ``convert_to_packed`` copies the latent expert weights, and a packed
    ``MoEMLP`` uses them as they are, so JAX's served MoE output is not its
    QAT forward's."""
    jcfg, _ = _cfgs("granite-moe-1b-a400m")
    qcfg = jcfg.with_quant(JQ.QAT)
    qparams = jbuild(qcfg).init(jax.random.PRNGKey(3))
    pcfg, pparams = jconvert(qcfg, qparams)
    for leaf in ("up", "gate", "down"):
        np.testing.assert_array_equal(
            np.asarray(pparams["stack"]["pos0"]["mlp"][leaf]["w"]),
            np.asarray(qparams["stack"]["pos0"]["mlp"][leaf]["w"]))
    bc = qcfg.block_config()
    mk = lambda quant: JM.MoEMLP(bc.d_model, bc.d_ff, bc.n_experts, bc.top_k,
                                 subln=bc.subln, quant=quant, policy=bc.policy)
    layer = lambda p: jax.tree_util.tree_map(lambda a: a[0],
                                             p["stack"]["pos0"]["mlp"])
    x = jnp.asarray(np.random.default_rng(4).standard_normal(
        (2, 5, bc.d_model)).astype(np.float32))
    yq, _ = mk(qcfg.quant).apply(layer(qparams), x, full_capacity=True)
    yp, _ = mk(pcfg.quant).apply(layer(pparams), x, full_capacity=True)
    yq, yp = np.asarray(yq), np.asarray(yp)
    assert np.abs(yp - yq).max() > 0.1 * np.abs(yq).max()

"""Port vs JAX: the attention variants — the blocked (flash-style) forward,
bf16 scores, and the config values that select them — on the causal cases
of tests/test_attention_variants.py (the non-causal and cross-attention
ones: tests/test_torch_cross_attention.py).

Inputs are seeded numpy; both sides run fp32 compute with the same params
(the JAX ``init`` copied into the port's module).  Tolerances:

* blocked vs JAX blocked, bf16 scores vs JAX bf16 scores: 1e-5 absolute on
  outputs of O(1).  The two sides round the same values to bf16 at the same
  places; what remains is fp32 summation order (~1e-7 here).
* blocked gradients vs JAX's: rtol 1e-5, atol 1e-5 (autograd through the
  block loop against JAX's through its scan; fp32 order only).
* blocked vs dense within 2e-3 and bf16 vs fp32 scores within 5e-2, JAX's
  own bounds for the variants (tests/test_attention_variants.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.nn.attention import Attention as JAttention
from repro.nn.module import DTypePolicy as JPolicy
from repro_torch.bridge import _flatten, jax_params_to_torch
from repro_torch.models import build_model, get_config
from repro_torch.nn.attention import Attention
from repro_torch.nn.module import DTypePolicy

JPOL = JPolicy(jnp.float32, jnp.float32)
TPOL = DTypePolicy(torch.float32, torch.float32)
ATOL = 1e-5


def _pair(hq=4, hkv=4, softcap=0.0, seed=0, **kw):
    """(JAX module, its params, the port's module holding the same params),
    d_model 64 and head_dim 16 as in the JAX tests."""
    ja = JAttention(64, hq, hkv, 16, logit_softcap=softcap, policy=JPOL, **kw)
    p = ja.init(jax.random.PRNGKey(seed))
    ta = Attention(64, hq, hkv, 16, logit_softcap=softcap, policy=TPOL,
                   device="cpu", **kw)
    ta.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(v))
                        for k, v in _flatten(p).items()})
    return ja, p, ta


def _x(seed=1, s=24):
    return np.random.default_rng(seed).standard_normal((2, s, 64)).astype(np.float32)


def _fwd(ta, x):
    with torch.no_grad():
        return ta(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("hq,hkv,softcap", [(4, 4, 0.0), (8, 2, 30.0)])
def test_blocked_matches_jax_blocked_and_dense(hq, hkv, softcap):
    """block_kv = 7 over 24 keys: three whole blocks and a ragged fourth."""
    ja, p, ta = _pair(hq, hkv, softcap, impl="blocked", block_kv=7)
    x = _x()
    got = _fwd(ta, x)
    want = np.asarray(ja.apply(p, jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _, _, dense = _pair(hq, hkv, softcap)
    np.testing.assert_allclose(got, _fwd(dense, x), rtol=2e-3, atol=2e-3)


def test_blocked_gradients_match_jax():
    ja, p, ta = _pair(impl="blocked", block_kv=8)
    x = _x()
    want = np.asarray(jax.grad(lambda x: jnp.sum(ja.apply(p, x)[0] ** 2))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (ta(xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    # the parameters' gradients flow through the loop too
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (ta.wq.w, ta.wk.w, ta.wv.w))


def test_bf16_scores_forward_match_jax():
    ja, p, ta = _pair(scores_dtype="bfloat16")
    x = _x()
    got = _fwd(ta, x)
    want = np.asarray(ja.apply(p, jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _, _, fp32 = _pair()
    ref = _fwd(fp32, x)
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-2)
    assert np.abs(got - ref).max() > 1e-4          # the scores were bf16


def test_blocked_ignores_bf16_scores_as_jax_does():
    ja, p, ta = _pair(impl="blocked", block_kv=7, scores_dtype="bfloat16")
    _, _, fp32 = _pair(impl="blocked", block_kv=7)
    x = _x()
    got = _fwd(ta, x)
    np.testing.assert_allclose(got, np.asarray(ja.apply(p, jnp.asarray(x))[0]),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got, _fwd(fp32, x))


def test_bf16_scores_contiguous_decode_match_jax():
    """Ten decode steps into the contiguous cache [B, Hkv, Smax, Dh], one
    row a step behind the other."""
    ja, p, ta = _pair(8, 2, 0.0, seed=2, scores_dtype="bfloat16")
    x = _x(3, 10)
    jc = ja.init_cache(2, 12, jnp.float32)
    tc = ta.init_cache(2, 12, torch.float32)
    for t in range(10):
        idx = np.array([t, max(t - 1, 0)], np.int32)
        yj, jc = ja.decode(p, jnp.asarray(x[:, t:t + 1]), jc, jnp.asarray(idx))
        with torch.no_grad():
            yt, _ = ta.decode(torch.from_numpy(x[:, t:t + 1]), tc,
                              torch.from_numpy(idx))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=0,
                               atol=ATOL)


def _paged(seed, hkv, b=3, bs=4, nlog=4):
    """Random pools (the resident K/V) and exclusively owned blocks; row 2
    is idle (its table all trash block 0)."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + b * nlog
    pools = {k: rng.standard_normal((n_blocks, hkv, bs, 16)).astype(np.float32)
             for k in ("k", "v")}
    bt = np.arange(1, n_blocks, dtype=np.int32).reshape(b, nlog)
    bt[2] = 0
    return rng, pools, bt


def _both_caches(pools):
    return ({k: jnp.asarray(v) for k, v in pools.items()},
            {k: torch.from_numpy(v.copy()) for k, v in pools.items()})


def _compare_pools(tc, jc):
    for k in ("k", "v"):                      # the trash block aside
        np.testing.assert_allclose(tc[k].numpy()[1:], np.asarray(jc[k])[1:],
                                   rtol=0, atol=ATOL)


def test_bf16_scores_gather_decode_match_jax():
    """The paged "gather" decode honours bf16 scores (JAX runs ``_attend``
    over the gathered window); the "fused" route stays fp32, as JAX's kernel
    does: it equals the fp32-scores module's output bitwise."""
    ja, p, ta = _pair(8, 2, 30.0, seed=3, scores_dtype="bfloat16")
    _, _, fp32 = _pair(8, 2, 30.0, seed=3)
    rng, pools, bt = _paged(4, 2)
    jc, tc = _both_caches(pools)
    _, tf = _both_caches(pools)
    _, tf32 = _both_caches(pools)
    idx = np.array([5, 12, 15], np.int32)
    for _ in range(3):
        x = rng.standard_normal((3, 1, 64)).astype(np.float32)
        yj, jc = ja.decode(p, jnp.asarray(x), jc, jnp.asarray(idx),
                           block_tables=jnp.asarray(bt), attn_impl="gather")
        args = (torch.from_numpy(x), None, torch.from_numpy(idx),
                torch.from_numpy(bt))
        with torch.no_grad():
            yt, _ = ta.decode(args[0], tc, *args[2:], attn_impl="gather")
            yf, _ = ta.decode(args[0], tf, *args[2:], attn_impl="fused")
            y32, _ = fp32.decode(args[0], tf32, *args[2:], attn_impl="fused")
        np.testing.assert_allclose(yt.numpy()[:2], np.asarray(yj)[:2], rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(yf.numpy(), y32.numpy())
        assert np.abs(yf.numpy()[:2] - yt.numpy()[:2]).max() > 1e-5
        idx = idx + 1
    _compare_pools(tc, jc)


def test_bf16_scores_gather_decode_chunk_match_jax():
    """A chunk step of T = 5 (a cold start, a mid-prompt chunk straddling a
    block, and an idle row), then a decode-rows chunk, on the "gather"
    route under bf16 scores; the "fused" route equals fp32 scores'."""
    ja, p, ta = _pair(4, 4, 0.0, seed=5, scores_dtype="bfloat16")
    _, _, fp32 = _pair(4, 4, 0.0, seed=5)
    rng, pools, bt = _paged(6, 4)
    jc, tc = _both_caches(pools)
    _, tf = _both_caches(pools)
    _, tf32 = _both_caches(pools)
    for start, lens in (([0, 6, 15], [5, 4, 1]), ([5, 10, 15], [1, 1, 1])):
        x = rng.standard_normal((3, 5, 64)).astype(np.float32)
        st, ln = np.asarray(start, np.int32), np.asarray(lens, np.int32)
        yj, jc = ja.decode_chunk(p, jnp.asarray(x), jc, jnp.asarray(st),
                                 jnp.asarray(ln), jnp.asarray(bt),
                                 attn_impl="gather")
        args = (torch.from_numpy(st), torch.from_numpy(ln), torch.from_numpy(bt))
        xt = torch.from_numpy(x)
        with torch.no_grad():
            yt, _ = ta.decode_chunk(xt, tc, *args, attn_impl="gather")
            yf, _ = ta.decode_chunk(xt, tf, *args, attn_impl="fused")
            y32, _ = fp32.decode_chunk(xt, tf32, *args, attn_impl="fused")
        for r in range(2):                    # valid tokens of the live rows
            np.testing.assert_allclose(yt.numpy()[r, :lens[r]],
                                       np.asarray(yj)[r, :lens[r]], rtol=0,
                                       atol=ATOL)
            np.testing.assert_array_equal(yf.numpy()[r, :lens[r]],
                                          y32.numpy()[r, :lens[r]])
    _compare_pools(tc, jc)


@pytest.mark.parametrize("field,value,match", [
    ("attn_impl", "nonsense", "attn_impl='nonsense'"),
    ("attn_scores_dtype", "float16", "scores_dtype='float16'"),
    ("block_kv", 0, "block_kv=0"),
])
def test_config_values_not_taken_raise(field, value, match):
    cfg = get_config("qwen3-0.6b").reduced().replace(**{field: value})
    with pytest.raises(ValueError, match=match):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "jamba-1.5-large-398b"])
def test_block_config_carries_the_moe_fields(name):
    """n_experts, top_k, moe_group_size and capacity_factor reach the port's
    ``BlockConfig`` as JAX's ``block_config`` passes them, and each MoE
    block's ``MoEMLP``."""
    fields = ("n_experts", "top_k", "moe_group_size", "capacity_factor")
    cfg = get_config(name).reduced(layers=8).replace(moe_group_size=48,
                                                     capacity_factor=1.5)
    jbc = jget(name).reduced(layers=8).replace(
        moe_group_size=48, capacity_factor=1.5).block_config()
    bc = cfg.block_config()
    assert {f: getattr(bc, f) for f in fields} == {f: getattr(jbc, f) for f in fields}
    assert (bc.n_experts, bc.top_k, bc.moe_group_size, bc.capacity_factor) == \
        (min(get_config(name).n_experts, 4), 2, 48, 1.5)
    model = build_model(cfg, device="cpu")
    moe = [blk.mlp for blk in model.stack.layers if blk.spec.ffn == "moe"]
    assert moe and {(m.n_experts, m.top_k, m.group_size, m.capacity_factor)
                    for m in moe} == {(bc.n_experts, 2, 48, 1.5)}


def test_seq_shard_activations_forward_matches_jax():
    """``seq_shard_activations=True`` (Megatron-SP: the residual between
    repeats hinted ``("batch", "seq_sp", "act_embed")``) is taken: under
    the default rules ``"seq_sp"`` is replicated, in JAX too, so the logits
    are JAX's with the flag set, with or without an active plan."""
    from repro_torch.distributed.sharding import (ShardingPlan, default_rules,
                                                  set_plan)
    jcfg = jget("qwen3-0.6b").reduced().replace(seq_shard_activations=True)
    params = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tcfg = get_config("qwen3-0.6b").reduced().replace(seq_shard_activations=True)
    model = jax_params_to_torch(tcfg, jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    assert model.stack.seq_shard_activations
    toks = np.random.default_rng(8).integers(0, 288, (2, 13)).astype(np.int32)
    want = np.asarray(jbuild(jcfg).apply(params, jnp.asarray(toks))[0])
    for plan in (None, ShardingPlan({"data": 2, "model": 2}, default_rules(False))):
        set_plan(plan)
        try:
            with torch.no_grad():
                got = model(torch.from_numpy(toks).long()).numpy()
        finally:
            set_plan(None)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_attn_impl_and_block_kv_reach_attention():
    cfg = get_config("qwen3-0.6b").reduced().replace(attn_impl="blocked",
                                                     block_kv=5)
    model = build_model(cfg, device="cpu")
    assert {(blk.attn.impl, blk.attn.block_kv) for blk in model.stack.layers} \
        == {("blocked", 5)}


def test_qwen3_blocked_causal_lm_matches_jax():
    """A reduced qwen3-0.6b with ``attn_impl="blocked"``, block_kv 5 over 13
    positions, logits against JAX's from the same params, and against the
    port's dense forward."""
    jcfg = jget("qwen3-0.6b").reduced().replace(attn_impl="blocked", block_kv=5)
    params = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tcfg = get_config("qwen3-0.6b").reduced().replace(attn_impl="blocked",
                                                      block_kv=5)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = jax_params_to_torch(tcfg, tree, device="cpu")
    toks = np.random.default_rng(7).integers(0, 288, (2, 13)).astype(np.int32)
    want = np.asarray(jbuild(jcfg).apply(params, jnp.asarray(toks))[0])
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    dense = jax_params_to_torch(tcfg.replace(attn_impl="dense"), tree, device="cpu")
    with torch.no_grad():
        ref = dense(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)

"""Port vs JAX: cross-attention and the non-causal encoder attention
(``nn/attention.py``), and the ``attn_cross`` and ``cross`` blocks of
``nn/transformer.py``, on the CPU.

Inputs are seeded numpy; both sides run fp32 compute with the same params
(the JAX ``init`` copied into the port's module).  Tolerances, as in
tests/test_torch_attention_variants.py: 1e-5 absolute on outputs of O(1)
(fp32 summation order; bf16 scores round the same values at the same places
on both sides); gradients rtol 1e-5, atol 1e-5; the port's remat policies
against no remat bitwise in the forward and within 1e-6 in the gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.base import ModelConfig as JModelConfig
from repro.nn.attention import Attention as JAttention
from repro.nn.module import DTypePolicy as JPolicy
from repro.nn.transformer import Block as JBlock
from repro.nn.transformer import BlockConfig as JBlockConfig
from repro.nn.transformer import LayerSpec as JLayerSpec
from repro.nn.transformer import Stack as JStack
from repro_torch.bridge import _flatten, _port_leaves
from repro_torch.models.base import ModelConfig
from repro_torch.nn.attention import Attention
from repro_torch.nn.module import DTypePolicy
from repro_torch.nn.transformer import Block, BlockConfig, LayerSpec, Stack

JPOL = JPolicy(jnp.float32, jnp.float32)
TPOL = DTypePolicy(torch.float32, torch.float32)
ATOL = 1e-5
T_MEM = 11          # memory positions: not a multiple of the block lengths


def _load(module, params):
    module.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(v))
                            for k, v in _flatten(params).items()})
    return module


def _pair(hq=4, hkv=4, seed=0, **kw):
    """(JAX module, its params, the port's module holding the same params),
    d_model 64 and head_dim 16."""
    ja = JAttention(64, hq, hkv, 16, policy=JPOL, **kw)
    p = ja.init(jax.random.PRNGKey(seed))
    return ja, p, _load(Attention(64, hq, hkv, 16, policy=TPOL, device="cpu", **kw), p)


def _arr(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask(seed=7):
    """Memory mask [2, T_MEM]: row 0 keeps all, row 1 drops four positions."""
    m = np.ones((2, T_MEM), bool)
    m[1, np.random.default_rng(seed).choice(T_MEM, 4, replace=False)] = False
    return m


VARIANTS = [dict(), dict(scores_dtype="bfloat16"),
            dict(impl="blocked", block_kv=4), dict(impl="blocked", block_kv=64)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kw", VARIANTS, ids=["dense", "bf16", "blocked4",
                                              "blocked64"])
def test_cross_forward_matches_jax(kw, masked):
    """K/V from the memory without RoPE or a causal mask, GQA 8:2, with and
    without a memory mask; dense, bf16 scores and the blocked forward (a
    ragged last block of 3 at block_kv 4)."""
    ja, p, ta = _pair(8, 2, use_rope=False, causal=False, cross=True, **kw)
    x, mem = _arr(1, 2, 9, 64), _arr(2, 2, T_MEM, 64)
    mask = _mask() if masked else None
    want = np.asarray(ja.apply(p, jnp.asarray(x), memory=jnp.asarray(mem),
                               memory_mask=None if mask is None
                               else jnp.asarray(mask))[0])
    with torch.no_grad():
        got = ta(torch.from_numpy(x), memory=torch.from_numpy(mem),
                 memory_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if masked:      # the mask changed row 1 and only row 1
        with torch.no_grad():
            free = ta(torch.from_numpy(x), memory=torch.from_numpy(mem)).numpy()
        np.testing.assert_array_equal(got[0], free[0])
        assert np.abs(got[1] - free[1]).max() > 1e-3


def test_cross_ignores_positions_and_rope():
    """A cross layer's output does not move with the query positions (no
    RoPE on q or k), where a self-attention layer's does."""
    _, _, ta = _pair(4, 4, use_rope=False, causal=False, cross=True)
    x, mem = torch.from_numpy(_arr(1, 2, 5, 64)), torch.from_numpy(_arr(2, 2, T_MEM, 64))
    with torch.no_grad():
        a = ta(x, memory=mem)
        b = ta(x, torch.arange(5)[None].expand(2, 5) + 17, memory=mem)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kw", VARIANTS, ids=["dense", "bf16", "blocked4",
                                              "blocked64"])
def test_noncausal_self_attention_matches_jax(kw):
    """The encoder's attention (``causal=False``, RoPE kept): every position
    attends every other; it differs from the causal layer on the same
    params except at the last position."""
    ja, p, ta = _pair(8, 2, causal=False, **kw)
    x = _arr(3, 2, 10, 64)
    want = np.asarray(ja.apply(p, jnp.asarray(x))[0])
    with torch.no_grad():
        got = ta(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _, _, causal = _pair(8, 2, **kw)
    with torch.no_grad():
        c = causal(torch.from_numpy(x)).numpy()
    assert np.abs(got[:, 0] - c[:, 0]).max() > 1e-3
    np.testing.assert_allclose(got[:, -1], c[:, -1], rtol=0, atol=ATOL)


@pytest.mark.parametrize("cross", [False, True])
def test_gradients_match_jax(cross):
    """Gradients of the input (and of the memory for a cross layer) against
    JAX's, under a memory mask; the projections get theirs."""
    kw = (dict(use_rope=False, causal=False, cross=True) if cross
          else dict(causal=False))
    ja, p, ta = _pair(8, 2, seed=4, **kw)
    x, mem, mask = _arr(5, 2, 7, 64), _arr(6, 2, T_MEM, 64), _mask()
    w = _arr(8, 2, 7, 64)

    def jloss(x, mem):
        y = ja.apply(p, x, memory=mem if cross else None,
                     memory_mask=jnp.asarray(mask) if cross else None)[0]
        return jnp.sum(y * w)

    gx, gm = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(mem))
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = torch.from_numpy(mem).requires_grad_(True)
    y = ta(xt, memory=mt if cross else None,
           memory_mask=torch.from_numpy(mask) if cross else None)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    if cross:
        np.testing.assert_allclose(mt.grad.numpy(), np.asarray(gm), rtol=1e-5,
                                   atol=1e-5)
        # masked-out memory positions get no gradient in row 1
        assert not mt.grad.numpy()[1][~mask[1]].any()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (ta.wq.w, ta.wk.w, ta.wv.w, ta.wo.w))


@pytest.mark.parametrize("scores", ["float32", "bfloat16"])
def test_cross_decode_matches_jax(scores):
    """Decode over the static cache [B, Hkv, T, Dh] holding the projected
    memory: q alone is projected, the whole cache attended unmasked, and
    nothing written; the steps equal the full forward's rows."""
    ja, p, ta = _pair(8, 2, seed=9, use_rope=False, causal=False, cross=True,
                      scores_dtype=scores)
    x, mem = _arr(10, 2, 4, 64), _arr(11, 2, T_MEM, 64)
    k, v = ja._project_kv(p, jnp.asarray(mem), None)
    jc = {"k": k.transpose(0, 2, 1, 3), "v": v.transpose(0, 2, 1, 3)}
    with torch.no_grad():
        tc = ta.project_memory(torch.from_numpy(mem))
        full = ta(torch.from_numpy(x), memory=torch.from_numpy(mem)).numpy()
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), rtol=0,
                                   atol=ATOL)
    before = {key: t.clone() for key, t in tc.items()}
    for t in range(4):
        idx = np.array([t, t + 3], np.int32)
        yj, _ = ja.decode(p, jnp.asarray(x[:, t:t + 1]), jc, jnp.asarray(idx))
        with torch.no_grad():
            yt, out = ta.decode(torch.from_numpy(x[:, t:t + 1]), tc,
                                torch.from_numpy(idx))
        assert out is tc
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        np.testing.assert_allclose(yt.numpy()[:, 0], full[:, t], rtol=0, atol=ATOL)
    for key in ("k", "v"):
        assert torch.equal(tc[key], before[key])


def test_cross_decode_chunk_and_missing_memory_raise():
    _, _, ta = _pair(use_rope=False, causal=False, cross=True)
    cache = ta.init_cache(2, 3, torch.float32)
    with pytest.raises(ValueError, match="self-attention only"):
        ta.decode_chunk(torch.zeros(2, 4, 64), cache, torch.zeros(2),
                        torch.ones(2), torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="needs memory"):
        ta(torch.zeros(2, 4, 64))


# -- blocks and stacks ------------------------------------------------------------

def _block_cfgs(**kw):
    base = dict(d_model=64, n_heads=8, n_kv_heads=2, head_dim=16, d_ff=128,
                subln=True, **kw)
    return (JBlockConfig(policy=JPOL, **base), BlockConfig(policy=TPOL, **base))


@pytest.mark.parametrize("mixer", ["attn_cross", "cross"])
def test_block_forward_matches_jax(mixer):
    """One block with SubLN, under a memory mask: ``attn_cross`` (self-
    attention on norm1, cross on norm_x; its self-attention's qkv states
    collected) and ``cross`` (cross on norm1 alone).  The module names are
    JAX's param names."""
    jc, tc = _block_cfgs()
    jb = JBlock(jc, JLayerSpec(mixer, "dense"))
    p = jb.init(jax.random.PRNGKey(3))
    tb = _load(Block(tc, LayerSpec(mixer, "dense"), device="cpu"), p)
    names = {n.split(".")[0] for n in tb.state_dict()}
    assert names == ({"norm1", "attn", "norm_x", "xattn", "norm2", "mlp"}
                     if mixer == "attn_cross" else {"norm1", "xattn", "norm2", "mlp"})
    x, mem, mask = _arr(1, 2, 9, 64), _arr(2, 2, T_MEM, 64), _mask()
    collect = mixer == "attn_cross"
    yj, sj, _ = jb.apply(p, jnp.asarray(x), memory=jnp.asarray(mem),
                         memory_mask=jnp.asarray(mask), collect_states=collect)
    with torch.no_grad():
        yt, st, moe = tb(torch.from_numpy(x), None, torch.from_numpy(mem),
                         torch.from_numpy(mask), collect)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    assert float(moe) == 0.0
    if collect:
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=ATOL)
    else:
        with pytest.raises(ValueError, match="no self-attention qkv"):
            tb(torch.from_numpy(x), None, torch.from_numpy(mem), None, True)


def _stacks(policy="nothing", remat=True, **kw):
    """A stack of pattern (attn, dense), (cross, dense), two repeats: JAX's
    scanned one and its params, and the port's holding them."""
    jc, tc = _block_cfgs(**kw)
    pat = (JLayerSpec("attn", "dense"), JLayerSpec("cross", "dense"))
    js = JStack(jc, pat, 2, remat=False)
    p = js.init(jax.random.PRNGKey(5))
    cfg = ModelConfig(name="t", family="vlm", vocab=8, d_model=64, n_layers=4,
                      pattern=tuple(LayerSpec(s.mixer, s.ffn) for s in pat))
    leaves = _port_leaves(cfg, {"stack": jax.tree_util.tree_map(np.asarray, p)})
    ts = Stack(tc, cfg.pattern, 2, remat=remat, remat_policy=policy, device="cpu")
    ts.load_state_dict({k[len("stack."):]: torch.from_numpy(np.array(v))
                        for k, v in leaves.items()})
    return js, p, ts


def test_stack_forward_and_gradients_match_jax():
    """The port's stack against JAX's scan: output, the memory's and the
    input's gradients, and the distill layer's states (layer 2, attn)."""
    js, p, ts = _stacks(remat=False)
    x, mem, w = _arr(1, 2, 9, 64), _arr(2, 2, T_MEM, 64), _arr(3, 2, 9, 64)

    def jloss(x, mem):
        y, _, _ = js.apply(p, x, memory=mem)
        return jnp.sum(y * w)

    gx, gm = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(mem))
    yj, sj, _ = js.apply(p, jnp.asarray(x), memory=jnp.asarray(mem), distill_layer=2)
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = torch.from_numpy(mem).requires_grad_(True)
    yt, st, _ = ts(xt, None, mt, distill_layer=2)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), rtol=0, atol=ATOL)
    (yt * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(gm), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ["nothing", "dots", "none"])
def test_remat_covers_cross_layers(policy):
    """Each remat policy gives no remat's output bitwise, and its gradients
    of the input, the memory (an input of each block's checkpoint) and
    every parameter within 1e-6."""
    _, _, plain = _stacks(remat=False)
    _, _, ts = _stacks(policy)
    x, mem, w = _arr(1, 2, 9, 64), _arr(2, 2, T_MEM, 64), _arr(3, 2, 9, 64)
    grads = []
    for s in (plain, ts):
        xt = torch.from_numpy(x).requires_grad_(True)
        mt = torch.from_numpy(mem).requires_grad_(True)
        y, _, _ = s(xt, None, mt)
        (y * torch.from_numpy(w)).sum().backward()
        grads.append((y.detach(), xt.grad, mt.grad,
                      {k: t.grad for k, t in s.named_parameters()}))
    (y0, gx0, gm0, gp0), (y1, gx1, gm1, gp1) = grads
    assert torch.equal(y0, y1)
    for a, b in [(gx0, gx1), (gm0, gm1)] + [(gp0[k], gp1[k]) for k in gp0]:
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
    assert float(gm1.abs().sum()) > 0


def test_missing_memory_names_the_layer():
    """JAX fails inside its scan with an opaque error; the port names the
    first cross layer."""
    _, _, ts = _stacks(remat=False)
    with pytest.raises(ValueError, match="layer 1 is a 'cross' layer"):
        ts(torch.zeros(2, 3, 64))
    with pytest.raises(ValueError, match="distill layer 1 is a 'cross' layer"):
        ts(torch.zeros(2, 3, 64), memory=torch.zeros(2, 3, 64), distill_layer=1)


def test_block_caches_and_decode_match_jax():
    """``init_cache`` gives a cross layer ``T = memory.shape[1]`` positions
    (one without memory), zero until seeded; ``decode`` of an
    ``attn_cross`` block over the seeded cache equals JAX's step by step;
    ``keep`` passes the cross layer untouched; ``decode_chunk`` refuses
    the mixer."""
    jc, tc = _block_cfgs()
    jb = JBlock(jc, JLayerSpec("attn_cross", "dense"))
    p = jb.init(jax.random.PRNGKey(6))
    tb = _load(Block(tc, LayerSpec("attn_cross", "dense"), device="cpu"), p)
    mem = _arr(2, 2, T_MEM, 64)
    empty = tb.init_cache(2, 6, torch.float32)
    assert empty["xattn"]["k"].shape == (2, 2, 1, 16) and not empty["xattn"]["k"].any()
    tcache = tb.init_cache(2, 6, torch.float32, memory=torch.from_numpy(mem))
    assert tcache["xattn"]["k"].shape == (2, 2, T_MEM, 16)
    jcache = jb.init_cache(2, 6, jnp.float32, memory=jnp.asarray(mem))
    k, v = jb.xattn._project_kv(p["xattn"], jnp.asarray(mem), None)
    jcache["xattn"] = {"k": k.transpose(0, 2, 1, 3), "v": v.transpose(0, 2, 1, 3)}
    with torch.no_grad():
        tcache["xattn"] = tb.xattn.project_memory(torch.from_numpy(mem))
    x = _arr(4, 2, 5, 64)
    for t in range(5):
        idx = np.array([t, t], np.int32)
        yj, jcache = jb.decode(p, jnp.asarray(x[:, t:t + 1]), jcache, jnp.asarray(idx))
        with torch.no_grad():
            yt = tb.decode(torch.from_numpy(x[:, t:t + 1]), tcache,
                           torch.from_numpy(idx), keep=torch.tensor([True, False]))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tcache["attn"]["k"].numpy(),
                               np.asarray(jcache["attn"]["k"]), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="'attn_cross' has no chunked paged path"):
        tb.decode_chunk(torch.zeros(2, 2, 64), tcache, torch.zeros(2),
                        torch.ones(2), torch.zeros((2, 1), dtype=torch.int32))


def test_block_config_carries_causal():
    """``BlockConfig.causal`` (JAX's field) reaches the self-attention."""
    _, tc = _block_cfgs()
    assert tc.causal and [f.name for f in dataclasses.fields(BlockConfig)] == \
        [f.name for f in dataclasses.fields(JBlockConfig)]
    blk = Block(dataclasses.replace(tc, causal=False), LayerSpec("attn", "dense"),
                device="cpu")
    assert not blk.attn.causal
    assert ModelConfig(name="t", family="dense", vocab=8, d_model=64,
                       n_layers=1).block_config().causal
    assert JModelConfig(name="t", family="dense", vocab=8, d_model=64,
                        n_layers=1).block_config().causal

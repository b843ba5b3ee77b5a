"""The Table-4 weight schemes (blockwise / AWQ-like / GPTQ-like), the
low-precision absmean path and the Fig. 2 helpers of ``repro_torch/core/
quant.py`` against ``repro/core/quant.py``, on weights drawn from a seed.

Tolerances: ternary codes equal JAX's except where a scale differs by an ulp
or two (the port sums every mean in float64, JAX in fp32 in XLA's order) and
a weight sits on the 0.5·Δ boundary: at most 0.1% of the codes may differ
(measured: none at these sizes, one code in 3.1 M at [1024, 3072] for
absmean and awq), and every dequantized weight with equal codes to rtol
5e-7 (two fp32 ulps of the scale).  A QAT CE step of the reduced qwen3-0.6b
for each scheme is held to JAX's step with phase 6's tolerances for steps
whose int8 activation codes may round either way (``chip_smoke.py``): loss
rtol 1e-4, grad_norm rtol 1e-3 (gptq: a scale 2 ulps off JAX's moves every
dequantized weight by that much and the loss by 1.8e-5 relative);
parameters rtol 1e-4, atol 1e-5, except that such a flip moves the
gradients a little, and AdamW's first step moves a parameter by ~lr·sign(g),
so where a gradient near 0 changes sign the two steps differ by up to 2·lr:
at most 1% of a tensor's elements may, by no more than 2·lr + 1e-5
(measured: 47 of the 36,864 embedding elements at lr 1e-3 for gptq, 16 for
lp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core import quant as JQ
from repro.models import build_model as jbuild, get_config as jget
from repro.training import optimizer as JO, schedule as JSch, trainer as JTr
from repro_torch.bridge import jax_params_from_torch, jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.core.bitlinear import BitLinear
from repro_torch.models import get_config
from repro_torch.training import optimizer as TO, schedule as TSch, trainer as TTr

FLIP_SHARE = 1e-3
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _w(shape, seed, scale=0.02):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _act(n, seed):
    return (np.abs(np.random.default_rng(seed).standard_normal(n)) + 0.1
            ).astype(np.float32)


def _codes_match(got, want):
    """Codes equal up to the stated share; -> mask of the equal ones."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    same = got == want
    assert (~same).mean() <= FLIP_SHARE, f"{(~same).sum()} of {same.size} codes differ"
    return same


SHAPES = [(64, 96), (96, 200), (256, 384)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [128, 48, 32])
def test_blockwise_matches_jax(shape, block):
    """``block`` 48 divides no N here; 32 divides all three."""
    w = _w(shape, 1)
    jq, jd = JQ.weight_quant_blockwise(jnp.asarray(w), block=block)
    tq, td = TQ.weight_quant_blockwise(_t(w), block=block)
    _codes_match(tq.numpy(), jq)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=5e-7, atol=0)
    assert td.shape == (shape[0], -(-shape[1] // block))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_act", [False, True])
def test_awq_matches_jax(shape, with_act):
    w, act = _w(shape, 2), _act(shape[0], 3)
    ja = jnp.asarray(act) if with_act else None
    ta = _t(act) if with_act else None
    jq, jd, js = JQ.weight_quant_awq(jnp.asarray(w), ja)
    tq, td, ts = TQ.weight_quant_awq(_t(w), ta)
    _codes_match(tq.numpy(), jq)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=5e-7, atol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=5e-7, atol=0)
    if not with_act:       # no caller passes act_scale: s = 1 exactly
        assert torch.equal(ts, torch.ones(shape[0]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_act", [False, True])
def test_gptq_matches_jax(shape, with_act):
    w, act = _w(shape, 4), _act(shape[0], 5)
    ja = jnp.asarray(act) if with_act else None
    ta = _t(act) if with_act else None
    jq, jd = jax.jit(JQ.weight_quant_gptq)(jnp.asarray(w), ja)
    tq, td = TQ.weight_quant_gptq(_t(w), ta)
    _codes_match(tq.numpy(), jq)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=5e-7, atol=0)


def test_gptq_order_is_stable_with_equal_sensitivities():
    """With ``act_scale=None`` every h is equal: a stable sort keeps the rows
    in order, so the walk goes row 0, 1, 2, ... and row 0 is quantized from
    the weight itself (no error spread into it yet)."""
    w = _w((32, 8), 6)
    q, delta = TQ.weight_quant_gptq(_t(w))
    np.testing.assert_array_equal(
        q[0].numpy(), np.clip(np.round(w[0] / (delta.item() + TQ.EPS)), -1, 1))


@pytest.mark.parametrize("scheme", ["absmean", "blockwise", "awq", "gptq"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_quant_weight_matches_jax_with_ste(scheme, dtype):
    w, act = _w((96, 200), 7), _act(96, 8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wa = np.asarray(jnp.asarray(w).astype(jdt).astype(jnp.float32))
    ja = jnp.asarray(act) if scheme in ("awq", "gptq") else None
    ta = _t(act) if ja is not None else None
    want = np.asarray(JQ.fake_quant_weight(jnp.asarray(wa).astype(jdt), scheme,
                                           ja, block=48).astype(jnp.float32))
    wt = _t(wa).to(dtype).requires_grad_()
    got = TQ.fake_quant_weight(wt, scheme, ta, block=48)
    assert got.dtype == dtype
    same = np.isclose(got.detach().float().numpy(), want, rtol=5e-7, atol=0)
    assert (~same).mean() <= FLIP_SHARE
    torch.sum(got.float() * 3.0).backward()     # STE: the gradient passes through
    assert torch.equal(wt.grad, torch.full_like(wt, 3.0))


@pytest.mark.parametrize("shape", SHAPES)
def test_fake_quant_weight_lp_matches_jax(shape):
    w = _w(shape, 9)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(JQ.fake_quant_weight_lp(wb).astype(jnp.float32))
    wt = _t(w).to(torch.bfloat16).requires_grad_()
    got = TQ.fake_quant_weight_lp(wt)
    assert got.dtype == torch.bfloat16
    _codes_match(got.detach().float().numpy(), want)
    torch.sum(got.float()).backward()
    assert torch.equal(wt.grad, torch.ones_like(wt))


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="'int4'"):
        TQ.fake_quant_weight(_t(_w((8, 8), 0)), scheme="int4")


# -- the cases of tests/test_quant.py that cover these functions ----------------

def test_blockwise_matches_absmean_for_single_block():
    w = _w((8, 64), 1, scale=1.0)
    qb, db = TQ.weight_quant_blockwise(_t(w), block=64)
    for r in range(8):
        np.testing.assert_allclose(db[r, 0].item(), np.mean(np.abs(w[r])), rtol=1e-5)
        qr, _ = TQ.weight_quant_absmean(_t(w[r:r + 1]))
        assert torch.equal(qb[r:r + 1], qr)


def test_gptq_and_awq_are_ternary():
    w = _t(_w((32, 16), 2, scale=0.1))
    act = _t(_act(32, 3))
    qg, _ = TQ.weight_quant_gptq(w, act)
    qa, _, _ = TQ.weight_quant_awq(w, act)
    for q in (qg, qa):
        assert bool(torch.isin(q, torch.tensor([-1.0, 0.0, 1.0])).all())


def test_gptq_compensation_beats_naive_on_weighted_error():
    rng = np.random.default_rng(4)
    w = _t(rng.standard_normal((64, 32)).astype(np.float32) * 0.1)
    act = _t((np.abs(rng.standard_normal(64)) * 3 + 0.1).astype(np.float32))
    x = _t(rng.standard_normal((512, 64)).astype(np.float32)) * act[None, :]
    qn, dn = TQ.weight_quant_absmean(w)
    qg, dg = TQ.weight_quant_gptq(w, act_scale=x.abs().mean(0))
    err_n = torch.linalg.norm(x @ w - x @ (qn * dn))
    err_g = torch.linalg.norm(x @ w - x @ (qg * dg))
    assert float(err_g) <= float(err_n) * 1.10


def test_boundary_mass_and_histogram_match_jax():
    for seed, shape in ((0, (128, 128)), (1, (64, 64)), (2, (96, 200))):
        w = _w(shape, seed, scale=1.0)
        bm = TQ.boundary_mass(_t(w))
        assert 0.0 <= float(bm) <= 1.0
        np.testing.assert_allclose(float(bm), float(JQ.boundary_mass(jnp.asarray(w))),
                                   rtol=1e-6)
        h = TQ.ternary_histogram(_t(w))
        assert int(h.sum()) == w.size
        np.testing.assert_array_equal(h.numpy(), np.asarray(
            JQ.ternary_histogram(jnp.asarray(w))))


# -- BitLinear and a QAT step for each scheme -----------------------------------

def test_kernel_route_refuses_other_schemes():
    """The kernel takes one per-tensor scale: another scheme on the kernel
    route is refused, named (the JAX route quantizes it with absmean)."""
    layer = BitLinear(16, 8, quant=TQ.QuantConfig(mode="qat", scheme="blockwise",
                                                  use_kernel=True),
                      gen=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="'blockwise'"):
        layer(torch.ones(2, 16))


def test_bitlinear_branch_order():
    """JAX's order: the kernel route first, then the lp path (absmean only),
    then ``fake_quant_weight`` of the scheme with ``act_scale`` and
    ``block``."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 96, generator=gen)
    act = _t(_act(96, 1))
    kw = dict(gen=torch.Generator().manual_seed(1), device="cpu")
    lp = BitLinear(96, 40, quant=TQ.QuantConfig(mode="qat", low_precision_quant=True), **kw)
    want = torch.matmul(TQ.fake_quant_act(x.to(torch.bfloat16)),
                        TQ.fake_quant_weight_lp(lp.w.to(torch.bfloat16)))
    assert torch.equal(lp(x), want)
    for scheme in ("blockwise", "awq", "gptq"):
        q = TQ.QuantConfig(mode="qat", scheme=scheme, block=48, low_precision_quant=True)
        layer = BitLinear(96, 40, quant=q, **dict(kw, gen=torch.Generator().manual_seed(1)))
        wq = TQ.fake_quant_weight(layer.w, scheme, act, block=48)
        want = torch.matmul(TQ.fake_quant_act(x.to(torch.bfloat16)),
                            wq.to(torch.bfloat16))
        assert torch.equal(layer(x, act_scale=act), want), scheme


@pytest.mark.parametrize("scheme,lp,block", [("blockwise", False, 48),
                                             ("awq", False, 128),
                                             ("gptq", False, 128),
                                             ("absmean", True, 128)])
def test_qat_step_matches_jax(scheme, lp, block):
    jq = JQ.QuantConfig(mode="qat", scheme=scheme, block=block, low_precision_quant=lp)
    tq = TQ.QuantConfig(mode="qat", scheme=scheme, block=block, low_precision_quant=lp)
    jt = jget("qwen3-0.6b").reduced()
    js, ts = jt.with_quant(jq), get_config("qwen3-0.6b").reduced().with_quant(tq)
    sparams = JP._copy_matching(jbuild(jt).init(jax.random.PRNGKey(0)),
                                jbuild(js).init(jax.random.PRNGKey(1)))
    student = jax_params_to_torch(ts, jax.tree_util.tree_map(np.asarray, sparams),
                                  device="cpu")
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, 268, (4, 16)).astype(np.int32),
         "labels": rng.integers(0, 268, (4, 16)).astype(np.int32),
         "loss_mask": (rng.uniform(size=(4, 16)) < 0.7).astype(np.float32)}
    jopt, topt = JO.AdamW(JO.AdamWConfig()), TO.AdamW(TO.AdamWConfig())
    jstep = jax.jit(JTr.make_train_step(jbuild(js), jopt, lambda s: JSch.constant(s, LR)))
    tstep = TTr.make_train_step(student, topt, lambda s: TSch.constant(s, LR))
    jstate, jm = jstep(JTr.init_train_state(sparams, jopt),
                       {k: jnp.asarray(v) for k, v in b.items()})
    _, tm = tstep(TTr.init_train_state(student, topt), {k: _t(v) for k, v in b.items()})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-7, err_msg=k,
                                   rtol=1e-3 if k == "grad_norm" else 1e-4)
    got = jax_params_from_torch(ts, student)
    for k, want in jax.tree_util.tree_leaves_with_path(jstate.params):
        name = [getattr(p, "key", p) for p in k]
        leaf = got
        for part in name:
            leaf = leaf[part]
        want = np.asarray(want)
        diff = np.abs(leaf - want)
        off = diff > 1e-5 + 1e-4 * np.abs(want)
        assert off.mean() <= 1e-2 and diff.max() <= 2 * LR + 1e-5, \
            (name, int(off.sum()), float(diff.max()))

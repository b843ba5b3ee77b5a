"""Port vs JAX: the distillation losses, the QAT fake-quantizers with their
STE, and the attention states the relation loss distills.

Inputs come from numpy seeds and go to both packages.  Tolerances: losses
rtol 1e-5 (fp32, summation order); gradients rtol 1e-4 with an absolute
floor of 1e-7 (fp32 sums of up to a few hundred terms in another order);
fake-quant forwards bitwise except where the absmean scale (≤ 2 ulp apart,
ROADMAP Queue C) moves a dequantized weight by that much (rtol 5e-7);
model states and logits rtol 1e-4, atol 1e-5 (the port's fp32 forward vs
XLA's, through two layers).

The states and logits of ``apply`` are compared on the FP teacher with
SubLN, the student's architecture without its quantizers.  Through the QAT
quantizers a 1-ulp fp32 difference upstream (norms, softmax, summation
order) can flip an int8 activation code at a .5 boundary, which moves that
token's and every later token's logits by ~1e-2: on qwen1.5-0.5b reduced
that happened for 2 of 9 random token draws (tokens 0..267, 2 x 12).  The
QAT forward is held to JAX through the train and distill steps
(tests/test_torch_train.py) and the fake-quantizers above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as JD
from repro.core import quant as JQ
from repro.core.pipeline import _copy_matching as j_copy_matching
from repro.models import build_model as jbuild, get_config as jget
from repro_torch.bridge import jax_params_from_torch, jax_params_to_torch
from repro_torch.core import distill as TD
from repro_torch.core import quant as TQ
from repro_torch.models import get_config

CONFIGS = ["qwen3-0.6b", "qwen1.5-0.5b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# -- losses ---------------------------------------------------------------------

@pytest.fixture
def logits_case():
    rng = np.random.default_rng(0)
    s = (rng.standard_normal((2, 8, 50)) * 3).astype(np.float32)
    t = (rng.standard_normal((2, 8, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    mask = (rng.uniform(size=(2, 8)) < 0.6).astype(np.float32)
    return s, t, labels, mask


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_logits_kd_match_jax(logits_case, masked):
    s, t, labels, mask = logits_case
    m = mask if masked else None
    jm, tm = (None, None) if m is None else (_j(m), _t(m))
    np.testing.assert_allclose(
        float(TD.softmax_cross_entropy(_t(s), _t(labels), tm)),
        float(JD.softmax_cross_entropy(_j(s), _j(labels), jm)), rtol=1e-5)
    np.testing.assert_allclose(TD.kl_divergence(_t(t), _t(s)).numpy(),
                               np.asarray(JD.kl_divergence(_j(t), _j(s))),
                               rtol=1e-5, atol=1e-7)
    for tau in (1.0, 5.0):
        np.testing.assert_allclose(
            float(TD.logits_distill_loss(_t(s), _t(t), tau, tm)),
            float(JD.logits_distill_loss(_j(s), _j(t), tau, jm)), rtol=1e-5)


def test_logits_kd_gradient_matches_jax_and_spares_the_teacher(logits_case):
    s, t, _, mask = logits_case
    gj = jax.grad(lambda a: JD.logits_distill_loss(a, _j(t), 5.0, _j(mask)))(_j(s))
    st, tt = _t(s).requires_grad_(), _t(t).requires_grad_()
    TD.logits_distill_loss(st, tt, 5.0, _t(mask)).backward()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-7)
    assert tt.grad is None


def _states(seed, B=2, H=4, L=24, Dh=16):
    return np.random.default_rng(seed).standard_normal((3, B, H, L, Dh)).astype(np.float32)


def test_resplit_and_normalize_match_jax():
    x = _states(0)[0]
    for split in (1, 2, 4):
        np.testing.assert_array_equal(TD._resplit_heads(_t(x), split).numpy(),
                                      np.asarray(JD._resplit_heads(_j(x), split)))
    np.testing.assert_allclose(TD._l2_normalize(_t(x)).numpy(),
                               np.asarray(JD._l2_normalize(_j(x))), rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        TD._resplit_heads(_t(x), 3)


@pytest.mark.parametrize("with_mask", [False, True])
def test_relation_kl_matches_jax(with_mask):
    s, t = _states(1)[0], _states(2)[0]
    mask = np.ones((2, 24), np.float32)
    mask[0, 17:] = 0.0
    m = mask if with_mask else None
    got = TD.relation_kl(_t(s), _t(t), 2, 1.3, None if m is None else _t(m))
    want = JD.relation_kl(_j(s), _j(t), 2, 1.3, None if m is None else _j(m))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    gj = jax.grad(lambda a: JD.relation_kl(a, _j(t), 2, 1.3,
                                           None if m is None else _j(m)))(_j(s))
    st = _t(s).requires_grad_()
    TD.relation_kl(st, _t(t), 2, 1.3, None if m is None else _t(m)).backward()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-7)


def test_relation_kl_blocked_matches_jax_and_dense():
    s, t = _states(3, L=50)[0], _states(4, L=50)[0]
    got = TD.relation_kl_blocked(_t(s), _t(t), 2, 1.0, block=16)
    want = JD.relation_kl_blocked(_j(s), _j(t), 2, 1.0, block=16)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(TD.relation_kl(_t(s), _t(t), 2)),
                               rtol=1e-5)


@pytest.mark.parametrize("blocked", [False, True])
def test_attention_relation_loss_matches_jax(blocked):
    s, t = _states(5), _states(6)
    alphas = (1.0, 2.0, 0.5)
    got = TD.attention_relation_loss(_t(s), _t(t), 2, 1.0, alphas=alphas,
                                     blocked=blocked)
    want = JD.attention_relation_loss(_j(s), _j(t), 2, 1.0, alphas=alphas,
                                      blocked=blocked)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(TD.attention_relation_loss(_t(s), _t(s), 2)) < 1e-6


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("parts", [(True, True), (True, False), (False, False)])
def test_bitdistill_loss_matches_jax(logits_case, use_kernel, parts):
    s, t, labels, mask = logits_case
    ss, ts = _states(7, L=8), _states(8, L=8)
    use_ld, use_ad = parts
    kw = dict(lambda_ld=3.0, gamma_ad=50.0, use_ld=use_ld, use_ad=use_ad,
              use_kernel=use_kernel, split_heads=2)
    lt, mt = TD.bitdistill_loss(_t(s), _t(t), _t(ss), _t(ts), _t(labels),
                                _t(mask), TD.DistillConfig(**kw))
    lj, mj = JD.bitdistill_loss(_j(s), _j(t), _j(ss), _j(ts), _j(labels),
                                _j(mask), JD.DistillConfig(**kw))
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    assert TD.DistillConfig().__dict__ == JD.DistillConfig().__dict__


# -- QAT fake-quant and STE ------------------------------------------------------

def test_ste_forward_is_exact_and_gradient_passes_through():
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((4, 33)).astype(np.float32)).requires_grad_()
    qx = torch.round(x.detach() * 7.3) / 7.3
    y = TQ.ste(x, qx)
    assert torch.equal(y, qx)
    (y * torch.arange(33.0)).sum().backward()
    assert torch.equal(x.grad, torch.arange(33.0).expand(4, 33))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_quant_matches_jax_with_ste_gradients(dtype):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 40)) * 0.02).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xa = np.asarray(_j(x).astype(jdt).astype(jnp.float32))
    want_x = np.asarray(JQ.fake_quant_act(_j(xa).astype(jdt)).astype(jnp.float32))
    got_x = TQ.fake_quant_act(_t(xa).to(dtype))
    assert got_x.dtype == dtype
    np.testing.assert_array_equal(got_x.float().numpy(), want_x)
    want_w = np.asarray(JQ.fake_quant_weight(_j(w)))
    np.testing.assert_allclose(TQ.fake_quant_weight(_t(w)).numpy(), want_w,
                               rtol=5e-7, atol=0)
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    torch.sum((TQ.fake_quant_act(xt) @ TQ.fake_quant_weight(wt)) ** 2).backward()
    gj = jax.grad(lambda a, b: jnp.sum((JQ.fake_quant_act(a) @ JQ.fake_quant_weight(b))
                                       ** 2), (0, 1))(_j(x), _j(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[0]), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj[1]), rtol=1e-4, atol=1e-7)
    # the other Table-4 schemes are ported too (tests/test_torch_quant_schemes.py
    # holds each against JAX); an unknown scheme raises, naming it
    np.testing.assert_allclose(
        TQ.fake_quant_weight(_t(w), scheme="blockwise", block=16).numpy(),
        np.asarray(JQ.fake_quant_weight(_j(w), scheme="blockwise", block=16)),
        rtol=5e-7, atol=0)
    with pytest.raises(ValueError, match="'ternary4'"):
        TQ.fake_quant_weight(_t(w), scheme="ternary4")


# -- the states the relation loss distills ----------------------------------------

@pytest.fixture(scope="module", params=CONFIGS)
def qat_pair(request):
    name = request.param
    jt = jget(name).reduced()
    js = jt.with_quant(JQ.QAT)
    tparams = jbuild(jt).init(jax.random.PRNGKey(0))
    sparams = j_copy_matching(tparams, jbuild(js).init(jax.random.PRNGKey(1)))
    tcfg = get_config(name).reduced().with_quant(TQ.QAT)
    model = jax_params_to_torch(tcfg, jax.tree_util.tree_map(np.asarray, sparams),
                                device="cpu")
    return js, sparams, tcfg, model


@pytest.mark.parametrize("layer", [0, 1, None])
def test_apply_states_and_logits_match_jax(qat_pair, layer):
    jcfg, jparams, tcfg, _ = qat_pair
    jcfg, tcfg = jcfg.with_quant(JQ.FP), tcfg.with_quant(TQ.FP)
    assert jcfg.subln and tcfg.subln
    model = jax_params_to_torch(tcfg, jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    toks = np.random.default_rng(11).integers(0, 268, (2, 12)).astype(np.int32)
    lj, sj, mj = jbuild(jcfg).apply(jparams, _j(toks), distill_layer=layer)
    with torch.no_grad():
        lt, st, mt = model.apply(_t(toks).long(), distill_layer=layer)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-5)
    assert float(mt) == float(mj) == 0.0
    if layer is None:
        assert st is None and sj is None
        return
    assert st.dtype == torch.float32
    assert tuple(st.shape) == sj.shape == (3, 2, tcfg.n_heads, 12, tcfg.head_dim)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4, atol=1e-5)


def test_bridge_round_trip_and_remat_gradients(qat_pair):
    """jax_params_from_torch inverts the bridge; with remat the gradients
    equal those without (the recompute runs the same forward)."""
    jcfg, jparams, tcfg, model = qat_pair
    back = jax_params_from_torch(tcfg, model)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf))
    toks = _t(np.random.default_rng(12).integers(0, 268, (2, 10))).long()
    grads = []
    for remat in (False, True):
        m = jax_params_to_torch(tcfg.replace(remat=remat),
                                jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
        logits, states, _ = m.apply(toks, distill_layer=1)
        (logits.square().mean() + states.square().mean()).backward()
        grads.append({k: p.grad.clone() for k, p in m.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0)

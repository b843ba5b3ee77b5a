"""Port vs JAX: ``nn/moe.py``'s ``MoEMLP`` on the CPU.

Parameters come from the JAX ``init`` (the SubLN scale and the router made
non-trivial), inputs from numpy seeds; everything is fp32.  Three regimes:
full capacity, capacity-limited with dropped picks, and a token count that
forces several groups through JAX's divisor walk.  Tolerances: the output
within 1e-5 of max|y| (the router and expert einsums sum in another
order); the picks (``top_e``), their slots (``pos``) and ``in_cap`` equal
as integers; the auxiliary loss rtol 1e-5; gradients rtol 1e-4 with an
absolute floor of 1e-6 of the largest entry (fp32 summation order through
the softmax, the einsums and the z-loss).  The scatter-built combine tensor
equals the literal five-dimensional construction bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import quant as JQ
from repro.nn import moe as JM
from repro.nn.module import DTypePolicy as JPolicy
from repro_torch.core import quant as TQ
from repro_torch.nn import moe as TM
from repro_torch.nn.module import DTypePolicy

D, FF, E, K = 64, 48, 8, 2

# (batch, seq, group_size, capacity_factor, full_capacity): one group at full
# capacity; one group with picks dropped; 28 tokens in groups of 8 -> g
# walks 3 -> 2 (groups of 14), capacity-limited
REGIMES = {
    "full": (2, 9, 64, 1.25, True),
    "drops": (2, 12, 64, 0.5, False),
    "groups": (2, 14, 8, 1.0, False),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(subln, quant, seed=0, group=64, cf=1.25):
    jm = JM.MoEMLP(D, FF, E, K, capacity_factor=cf, group_size=group,
                   subln=subln, quant=quant[0],
                   policy=JPolicy(jnp.float32, jnp.float32))
    tm = TM.MoEMLP(D, FF, E, K, capacity_factor=cf, group_size=group,
                   subln=subln, quant=quant[1],
                   policy=DTypePolicy(torch.float32, torch.float32),
                   device=torch.device("cpu"))
    p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    p["router"]["w"] = (p["router"]["w"] * 4).astype(np.float32)  # sharper routing
    if subln:
        p["subln"]["scale"] = rng.uniform(0.5, 1.5, FF).astype(np.float32)
    with torch.no_grad():
        for name, mod in (("router", tm.router), ("up", tm.up),
                          ("gate", tm.gate), ("down", tm.down)):
            mod.w.copy_(_t(p[name]["w"]))
        if subln:
            tm.subln.scale.copy_(_t(p["subln"]["scale"]))
    return jm, tm, p


def _x(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


def _jax_route(jm, p, x, full):
    """JAX's routing intermediates, as ``repro/nn/moe.py:84-109`` computes
    them."""
    b, s, d = x.shape
    tokens = b * s
    g = max(1, tokens // jm.group_size) if tokens >= jm.group_size else 1
    while tokens % g:
        g -= 1
    gs = tokens // g
    xg = jnp.asarray(x).reshape(g, gs, d)
    logits = jnp.einsum("gsd,de->gse", xg, jnp.asarray(p["router"]["w"]))
    probs = jax.nn.softmax(logits, axis=-1)
    top_w, top_e = jax.lax.top_k(probs, jm.top_k)
    cap = gs if full else min(int(max(1, round(gs * jm.top_k / jm.n_experts
                                               * jm.capacity_factor))), gs)
    onehot = jax.nn.one_hot(top_e, jm.n_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot.reshape(g, gs * jm.top_k, jm.n_experts), axis=1) - 1
    pos = pos.reshape(g, gs, jm.top_k, jm.n_experts)
    in_cap = (pos < cap) & (onehot > 0)
    return (np.asarray(top_e), np.asarray(pos), np.asarray(in_cap), cap, g)


def _close(got, want, frac=1e-5):
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("mode", ["fp", "qat"])
@pytest.mark.parametrize("subln", [False, True])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_moe_forward_routing_and_aux_match_jax(regime, subln, mode):
    b, s, group, cf, full = REGIMES[regime]
    quant = (JQ.QAT, TQ.QAT) if mode == "qat" else (JQ.FP, TQ.FP)
    jm, tm, p = _pair(subln, quant, group=group, cf=cf)
    x = _x(b, s)
    jy, jaux = jm.apply(p, jnp.asarray(x), full_capacity=full)
    with torch.no_grad():
        ty, taux = tm(_t(x), full_capacity=full)
    _close(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), rtol=1e-5)

    top_e, pos, in_cap, cap, g = _jax_route(jm, p, x, full)
    assert g == {"full": 1, "drops": 1, "groups": 2}[regime]
    gs = b * s // g
    logits = torch.einsum("gsd,de->gse", _t(x).reshape(g, gs, D),
                          tm.router.w.detach())
    _, _, t_e, onehot, t_pos, t_in = TM.route(
        logits, K, TM.capacity(gs, K, E, cf, full))
    np.testing.assert_array_equal(t_e.numpy(), top_e)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_in.numpy(), in_cap)
    dropped = int(((onehot > 0) & ~t_in).sum())
    if full:
        assert dropped == 0
    elif regime == "drops":
        assert dropped > 0


@pytest.mark.parametrize("mode", ["fp", "qat"])
@pytest.mark.parametrize("regime", ["drops", "groups"])
def test_moe_gradients_match_jax(regime, mode):
    """d/dx and d/d(every leaf) of sum(y · r) + aux loss."""
    b, s, group, cf, full = REGIMES[regime]
    quant = (JQ.QAT, TQ.QAT) if mode == "qat" else (JQ.FP, TQ.FP)
    jm, tm, p = _pair(True, quant, group=group, cf=cf)
    x = _x(b, s)
    r = np.random.default_rng(7).standard_normal((b, s, D)).astype(np.float32)

    def jloss(params, xx):
        y, aux = jm.apply(params, xx, full_capacity=full)
        return jnp.sum(y * r) + aux["moe_aux_loss"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    y, aux = tm(tx, full_capacity=full)
    ((y * _t(r)).sum() + aux["moe_aux_loss"]).backward()
    pairs = [("x", tx.grad, jgx)] + [
        (f"{m}/w", getattr(tm, m).w.grad, jgp[m]["w"])
        for m in ("router", "up", "gate", "down")] + [
        ("subln/scale", tm.subln.scale.grad, jgp["subln"]["scale"])]
    for name, got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_scatter_combine_equals_literal_construction(regime):
    """The scatter of ``top_w · in_cap`` equals JAX's contraction of the
    [g, gs, k, e, cap] one-hot, bit for bit."""
    b, s, group, cf, full = REGIMES[regime]
    _, tm, _ = _pair(False, (JQ.FP, TQ.FP), group=group, cf=cf)
    x = _t(_x(b, s, seed=3))
    g = TM.group_count(b * s, group)
    gs = b * s // g
    logits = torch.einsum("gsd,de->gse", x.reshape(g, gs, D), tm.router.w.detach())
    cap = TM.capacity(gs, K, E, cf, full)
    _, top_w, top_e, _, pos, in_cap = TM.route(logits, K, cap)
    got = TM.combine_weights(top_w, top_e, pos, in_cap, cap)
    inc = in_cap.to(torch.float32)
    literal = torch.einsum(
        "gske,gskec->gsec", top_w[..., None] * inc,
        F.one_hot(torch.clamp(pos, 0, cap - 1).long(), cap).to(torch.float32)
        * inc[..., None])
    assert torch.equal(got, literal)


def test_equal_probabilities_pick_the_lower_experts_as_jax():
    """A zero router gives every expert the same probability: JAX's
    ``lax.top_k`` and the port pick experts 0..k-1, in that order, so the
    slots and the drops are the same."""
    jm, tm, p = _pair(False, (JQ.FP, TQ.FP), cf=0.5)
    p["router"]["w"] = np.zeros_like(p["router"]["w"])
    with torch.no_grad():
        tm.router.w.zero_()
    x = _x(2, 12)
    top_e, pos, in_cap, cap, _ = _jax_route(jm, p, x, False)
    logits = torch.zeros((1, 24, E))
    _, _, t_e, _, t_pos, t_in = TM.route(logits, K, cap)
    assert (top_e == np.arange(K)).all()
    np.testing.assert_array_equal(t_e.numpy(), top_e)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_in.numpy(), in_cap)
    jy, _ = jm.apply(p, jnp.asarray(x))
    with torch.no_grad():
        ty, _ = tm(_t(x))
    _close(ty.numpy(), np.asarray(jy))


def test_qat_experts_are_quantized_one_by_one():
    """The QAT expert weights are each expert's own absmean ternarization,
    bitwise equal to ``fake_quant_weight`` called on the expert alone."""
    _, tm, _ = _pair(False, (JQ.QAT, TQ.QAT))
    w = tm.up.w.detach()
    got = tm.quantized(w)
    for i in range(E):
        assert torch.equal(got[i], TQ.fake_quant_weight(w[i]))
    deltas = {float(TQ.absmean_scale(w[i])) for i in range(E)}
    assert len(deltas) == E
    fp = dataclasses.replace(TQ.QAT, mode="fp")
    tm.quant = fp
    assert tm.quantized(w) is w

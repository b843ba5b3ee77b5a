"""Port vs JAX: the Mamba2 SSD cores, the ssd_scan wrapper and plain version,
``Mamba2Block``, and the ``mamba2-780m`` model, on the CPU.

Inputs come from numpy seeds; block and model parameters from the JAX
``init`` through ``repro_torch.bridge``.  On the CPU the port's
``ops.ssd_scan`` runs ``ssd_chunked`` (its kernel runs only on the card);
the JAX ``ops.ssd_scan`` runs its Pallas kernel in interpret mode.

Tolerances are the JAX package's own for this kernel (``tests/
test_kernels.py::TestSSDScan``): rtol = atol = 1e-4 on forward values
(fp32; the cumulative log-decay and the chunk products are summed in
another order) and 1e-3 on gradients.  Through the QAT quantizers an fp32
difference upstream can flip an int8 activation code at a .5 boundary;
none does for these seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan import ref as jref
from repro.models import build_model as jbuild, get_config as jget
from repro.nn import ssm as JS
from repro.nn.module import DTypePolicy as JPolicy
from repro_torch.bridge import jax_params_from_torch, jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.kernels.ssd_scan import kernel as tkernel
from repro_torch.kernels.ssd_scan import ops as tops
from repro_torch.kernels.ssd_scan import ref as tref
from repro_torch.models import build_model, get_config
from repro_torch.nn import ssm as TS
from repro_torch.nn.module import DTypePolicy

FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=1e-3, atol=1e-3)
NAME = "mamba2-780m"


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ssd_inputs(seed, b, s, h, p, n, init_state=False):
    """x, a in (0.05, 0.95), dt = softplus(normal), B, C (and h0) as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = (0.9 / (1 + np.exp(-rng.standard_normal((b, s, h)))) + 0.05).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if init_state else None
    return (x, a, dt, B, C), h0


# -- config ---------------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False])
def test_config_matches_jax_field_for_field(full):
    jc, tc = jget(NAME), get_config(NAME)
    if not full:
        jc, tc = jc.reduced(), tc.reduced()
    jd, td = jc.__dict__, tc.__dict__
    assert set(jd) == set(td)
    for k in jd:
        if k == "quant":
            assert jd[k].__dict__ == td[k].__dict__
        elif k == "pattern":
            assert [dataclasses.astuple(x) for x in jd[k]] == \
                [dataclasses.astuple(x) for x in td[k]]
        else:
            assert jd[k] == td[k], k
    jb, tb = jc.block_config(), tc.block_config()
    for k in ("ssm_state", "ssm_head_dim", "ssm_chunk"):
        assert getattr(jb, k) == getattr(tb, k)


# -- the SSD cores ----------------------------------------------------------------

@pytest.mark.parametrize("core", ["ssd_chunked", "ssd_sequential"])
@pytest.mark.parametrize("s,chunk,init_state", [(48, 16, False), (40, 16, True),
                                                (37, 64, True)])
def test_ssd_cores_match_jax(core, s, chunk, init_state):
    """S = 40 with chunk 16 takes chunks of 10 (the largest divisor <= 16),
    S = 37 one chunk of 37; a nonzero initial state enters both."""
    ins, h0 = _ssd_inputs(s, 2, s, 3, 8, 4, init_state)
    jy, jh = getattr(JS, core)(*map(jnp.asarray, ins), chunk=chunk,
                               init_state=None if h0 is None else jnp.asarray(h0))
    ty, th = getattr(TS, core)(*map(_t, ins), chunk=chunk,
                               init_state=None if h0 is None else _t(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD)


def test_chunk_rule_matches_jax():
    for s in (1, 7, 40, 96, 512, 1000):
        for chunk in (1, 16, 64, 256):
            q = min(chunk, s)
            while s % q:
                q -= 1
            assert TS.chunk_len(s, chunk) == q


# -- the kernel's wrapper and plain version ------------------------------------------

@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 3, 16, 8, 16),
                                             (1, 40, 2, 8, 4, 16)])
def test_ssd_scan_matches_jax_interpret(b, s, h, p, n, chunk):
    """y and the gradients of all five operands: the port's CPU route
    (ssd_chunked, backward recomputed through it) against the JAX wrapper
    with its Pallas kernel in interpret mode."""
    ins, _ = _ssd_inputs(b + s, b, s, h, p, n)
    w = np.random.default_rng(1).standard_normal((b, s, h, p)).astype(np.float32)
    jloss = lambda *xs: jnp.sum(jops.ssd_scan(*xs, chunk, True) * w)
    jy = jops.ssd_scan(*map(jnp.asarray, ins), chunk, True)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, ins))
    tins = [_t(v).requires_grad_(True) for v in ins]
    ty = tops.ssd_scan(*tins, chunk=chunk)
    (ty * _t(w)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    for name, tx, g in zip("x a dt B C".split(), tins, jg):
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g), **GRAD,
                                   err_msg=name)


def test_ssd_scan_ref_matches_jax_ref():
    rng = np.random.default_rng(7)
    bh, s, p, n = 4, 33, 8, 6
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    a = rng.uniform(0.05, 0.95, (bh, s)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, (bh, s)).astype(np.float32)
    B = rng.standard_normal((bh, s, n)).astype(np.float32)
    C = rng.standard_normal((bh, s, n)).astype(np.float32)
    jy, jh = jref.ssd_scan_ref(*map(jnp.asarray, (x, a, dt, B, C)))
    ty, th = tref.ssd_scan_ref(*map(_t, (x, a, dt, B, C)))
    assert ty.shape == (bh, s, p) and th.shape == (bh, n, p)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD)


def test_overflowing_chunk_has_finite_gradients():
    """One chunk of 256 steps with dt = 0.1 and A = (-1, -8): the A = -8
    head's summed dt·|A| is 204.8, so exp of the segment sums above the
    diagonal overflows.  JAX's ssd_chunked (exp, then where) gives a NaN
    gradient for that head's a; the port masks before the exponential.
    Forward equal to JAX's; every gradient finite, and equal to JAX's
    wherever JAX's is finite."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 256, 2, 8, 4
    dt = np.full((b, s, h), 0.1, np.float32)
    a = np.exp(dt * np.array([-1.0, -8.0], np.float32)).astype(np.float32)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    w = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ins = (x, a, dt, B, C)
    jloss = lambda *xs: jnp.sum(JS.ssd_chunked(*xs, chunk=256)[0] * w)
    jy, _ = JS.ssd_chunked(*map(jnp.asarray, ins), chunk=256)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, ins))
    assert np.isnan(np.asarray(jg[1])[..., 1]).any()         # the JAX fault
    assert np.isfinite(np.asarray(jg[1])[..., 0]).all()
    tins = [_t(v).requires_grad_(True) for v in ins]
    ty = tops.ssd_scan(*tins, chunk=256)
    (ty * _t(w)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    for name, tx, g in zip("x a dt B C".split(), tins, jg):
        got, want = tx.grad.numpy(), np.asarray(g)
        assert np.isfinite(got).all(), name
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], **GRAD, err_msg=name)


def test_ssd_scan_kernel_refuses_cpu_tensors():
    ins, _ = _ssd_inputs(0, 1, 16, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ssd_scan_kernel(*map(_t, ins), chunk=16)


# -- Mamba2Block -------------------------------------------------------------------

def _block_pair(mode, use_kernel):
    """The JAX block and params (PRNGKey(0)) and the port's block with the
    same weights, at the reduced config's widths, fp32."""
    jq = JQ.QuantConfig(mode=mode, use_kernel=use_kernel)
    tq = TQ.QuantConfig(mode=mode, use_kernel=use_kernel)
    kw = dict(d_model=128, d_state=16, head_dim=16, chunk=16)
    jblk = JS.Mamba2Block(**kw, quant=jq, policy=JPolicy(jnp.float32, jnp.float32))
    params = jblk.init(jax.random.PRNGKey(0))
    tblk = TS.Mamba2Block(**kw, quant=tq,
                          policy=DTypePolicy(torch.float32, torch.float32),
                          device=torch.device("cpu"))
    state = {k.replace("/", "."): _t(v) for k, v in _flat(params).items()}
    assert set(state) == set(tblk.state_dict())
    tblk.load_state_dict(state)
    for k in ("A_log", "D", "dt_bias"):
        assert getattr(tblk, k).dtype == torch.float32
    return jblk, params, tblk


@pytest.mark.parametrize("mode,use_kernel,sequential", [
    ("fp", False, False), ("fp", False, True), ("qat", True, False),
    ("qat", False, False)])
def test_mamba2_block_matches_jax(mode, use_kernel, sequential):
    """Forward and every parameter's gradient of sum(out * w)."""
    jblk, params, tblk = _block_pair(mode, use_kernel)
    rng = np.random.default_rng(11)
    u = rng.standard_normal((2, 48, 128)).astype(np.float32)
    w = rng.standard_normal((2, 48, 128)).astype(np.float32)
    fwd = jax.jit(lambda p: jblk.apply(p, jnp.asarray(u), sequential=sequential))
    jout = fwd(params)
    jgrads = _flat(jax.jit(jax.grad(lambda p: jnp.sum(fwd(p) * w)))(params))
    tout = tblk(_t(u), sequential=sequential)
    (tout * _t(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **FWD)
    tgrads = {k: p.grad.numpy() for k, p in tblk.named_parameters()}
    assert set(tgrads) == {k.replace("/", ".") for k in jgrads}
    for k, g in jgrads.items():
        np.testing.assert_allclose(tgrads[k.replace("/", ".")], g, **GRAD,
                                   err_msg=k)


# -- the model --------------------------------------------------------------------

@pytest.fixture(scope="module", params=["fp", "qat"])
def model_pair(request):
    jc, tc = jget(NAME).reduced(), get_config(NAME).reduced()
    if request.param == "qat":
        jc, tc = jc.with_quant(JQ.QAT), tc.with_quant(TQ.QAT)
    params = jbuild(jc).init(jax.random.PRNGKey(0))
    model = jax_params_to_torch(tc, jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return jc, params, tc, model


def test_causal_lm_logits_match_jax(model_pair):
    jc, params, tc, model = model_pair
    toks = np.random.default_rng(2).integers(0, tc.vocab, (2, 40)).astype(np.int32)
    jl, jst, jmoe = jbuild(jc).apply(params, jnp.asarray(toks))
    with torch.no_grad():
        tl, tst, tmoe = model.apply(_t(toks))
    assert jst is None and tst is None and float(tmoe) == float(jmoe) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)


def test_bridge_round_trip(model_pair):
    jc, params, tc, model = model_pair
    want, got = _flat(params), _flat(jax_params_from_torch(tc, model))
    assert set(got) == set(want)
    assert want["stack/pos0/mamba/A_log"].shape == (tc.repeats, 128 * 2 // 16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_distill_layer_on_a_mamba_layer_raises(model_pair):
    jc, params, tc, model = model_pair
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="mamba"):
        model.apply(toks, distill_layer=1)
    with pytest.raises(ValueError, match="mamba"):
        jbuild(jc).apply(params, jnp.zeros((1, 8), jnp.int32), distill_layer=1)


def test_seeded_init_has_the_jax_ranges():
    """The port's own seeded init (no JAX): A = -exp(A_log) in [-8, -1],
    softplus(dt_bias) in [1e-3, 0.1], D = 1, conv bias 0."""
    m = build_model(get_config(NAME).reduced(), gen=torch.Generator().manual_seed(0),
                    device="cpu")
    for blk in m.stack.layers:
        mb = blk.mamba
        A = -torch.exp(mb.A_log)
        dt = torch.nn.functional.softplus(mb.dt_bias)
        assert bool(((A >= -8.0) & (A <= -1.0)).all())
        assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())
        assert bool((mb.D == 1).all()) and bool((mb.conv_b == 0).all())
        assert blk.mlp is None and blk.attn is None
    cache = m.init_cache(1, 16, torch.float32)
    assert [set(layer) for layer in cache] == [{"mamba"}] * len(m.stack.layers)
    assert all(bool((t == 0).all()) for layer in cache
               for t in layer["mamba"].values())

"""Port vs JAX: quantizers, 2-bit packing and the packed matmul.

Codes are held bitwise (torch.round and jnp.round both round half to even);
the per-tensor absmean scale is held to 2 ulp, because XLA and the port sum
|W| in different orders (the port sums in float64 and rounds once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitlinear as JB
from repro.core import quant as JQ
from repro_torch.core import bitlinear as TB
from repro_torch.core import quant as TQ


def test_round_clip_rounds_half_to_even():
    x = np.array([-130.5, -128.5, -127.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5,
                  3.5, 126.5, 127.5, 128.5, 0.49999997, 1.5000001],
                 np.float32)
    for a, b in ((-128.0, 127.0), (-1.0, 1.0)):
        want = np.asarray(JQ.round_clip(jnp.asarray(x), a, b))
        got = TQ.round_clip(torch.from_numpy(x), a, b).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,seed", [((128, 128), 0), ((256, 64), 1),
                                        ((64, 48), 2), ((1024, 96), 3)])
def test_weight_quant_codes_match_jax(shape, seed):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)
    qj, dj = JQ.weight_quant_absmean(jnp.asarray(w))
    qt, dt = TQ.weight_quant_absmean(torch.from_numpy(w))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant_codes_match_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 512)).astype(np.float32)
    x[0, :8] = [1.0, -1.0, 0.5, -0.5, 1 / 127, 2.5 / 127, -0.5 / 127, 0.0]
    x[1] = np.linspace(-3, 3, 512, dtype=np.float32)     # dense codes
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, gj = JQ.act_quant_absmax_int8(xj)
    qt, gt = TQ.act_quant_absmax_int8(xt)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(qt.to(torch.float32).numpy(),
                                  np.asarray(qj.astype(jnp.float32)))


@pytest.mark.parametrize("k,n", [(128, 64), (1024, 96), (4, 3)])
def test_pack_and_unpack_match_jax(k, n):
    q = np.random.default_rng(k).integers(-1, 2, (k, n)).astype(np.int8)
    pj = np.asarray(JQ.pack_ternary(jnp.asarray(q)))
    pt = TQ.pack_ternary(torch.from_numpy(q))
    assert pt.dtype == torch.uint8
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(TQ.unpack_ternary(pt, k).numpy(), q)
    np.testing.assert_array_equal(
        TQ.unpack_ternary(pt, k).numpy(),
        np.asarray(JQ.unpack_ternary(jnp.asarray(pj), k)))


def test_pack_rejects_ragged_k():
    with pytest.raises(ValueError, match="divisible by 4"):
        TQ.pack_ternary(torch.zeros((6, 3), dtype=torch.int8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_matmul_matches_jax(dtype):
    """The plain packed matmul (unpack, exact integer product, rescale) of
    the port against the JAX jnp path on the same packed weights: the
    integer products agree exactly, so only the final fp32 scale can round
    differently (<= 1 ulp of the output dtype)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 96)) * 0.02).astype(np.float32)
    p = JB.convert_linear_params_fp_to_packed(jnp.asarray(w))
    wp, delta = np.array(p["w_packed"]), np.array(p["delta"])
    yj = np.asarray(JB.packed_matmul(jnp.asarray(x).astype(dtype),
                                     jnp.asarray(wp), jnp.asarray(delta), 256)
                    .astype(jnp.float32))
    yt = TB.packed_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(wp), torch.tensor(delta), 256)
    tol = 2e-7 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(yt.to(torch.float32).numpy(), yj, rtol=tol,
                               atol=1e-7)


def test_convert_linear_packs_like_jax():
    w = (np.random.default_rng(6).standard_normal((128, 40)) * 0.02).astype(np.float32)
    pj = JB.convert_linear_params_fp_to_packed(jnp.asarray(w))
    pt = TB.convert_linear_params_fp_to_packed(torch.from_numpy(w))
    np.testing.assert_array_equal(pt["w_packed"].numpy(), np.asarray(pj["w_packed"]))
    np.testing.assert_allclose(pt["delta"].numpy(), np.asarray(pj["delta"]),
                               rtol=2.5e-7, atol=0)


def test_div_is_the_true_quotient():
    """scalar/tensor in PyTorch multiplies by a reciprocal; the quantizers
    divide through ``div`` so their scales are the IEEE quotient."""
    g = torch.from_numpy(np.random.default_rng(7).random(4096).astype(np.float32) * 10)
    want = (np.float32(127.0) / g.numpy()).astype(np.float32)
    np.testing.assert_array_equal(TQ.div(127.0, g).numpy(), want)
    np.testing.assert_array_equal(TQ.div(g, 127.0).numpy(),
                                  (g.numpy() / np.float32(127.0)).astype(np.float32))

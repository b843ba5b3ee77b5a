"""The SSD scan cut into the card kernel's stages, on the CPU.

The card's ssd_scan (``csrc/ssd_scan.cu``) runs the stages of
``kernels/ssd_scan/ref.py::ssd_stages`` (la and the per-step factors; C·Bᵀ
once per batch row and chunk; the chunk states; their carry; the output)
with every product in 3xTF32 on the tensor cores.  Held here:

* the five stages composed, with exact fp32 products, against the port's
  ``ssd_chunked``, the JAX ``nn/ssm.py::ssd_chunked`` and the JAX wrapper
  with its Pallas kernel in interpret mode, at the JAX package's own
  tolerance for this kernel (rtol = atol = 1e-4; sums in another order),
  ragged chunks (Q not a multiple of 8) and several chunks included;
* the TF32 rounding (``cvt.rna``: 10 mantissa bits, ties away from zero)
  and the card's cut (the low 13 bits cleared);
* on the phase-2 input recipe (A in [-8, -1] per head, dt = softplus(N(-2,
  1)), x, B, C standard normal; a chunk's summed dt·|A| far past 88), the
  stages with an emulated 3xTF32 product (the card's split by bit masks, and
  a split to nearest) within 1e-4 of ``ssd_chunked`` where a single TF32
  product is not: why the card pays three products.

The CUDA kernels themselves are held to ``ssd_chunked`` and the sequential
oracle on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jops
from repro.nn import ssm as JS
from repro_torch.kernels.ssd_scan import ref as R

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _recipe(b, s, h, p, n, seed):
    """The phase-2 inputs, as Mamba2Block feeds the core, from numpy."""
    rng = np.random.default_rng(seed)
    A = -(1.0 + 7.0 * rng.random(h)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0)).astype(np.float32)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, np.exp(dt * A).astype(np.float32), dt, B, C


def _within(got, want, rtol=1e-4, atol=1e-4):
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 16, 8, 16), (1, 40, 2, 8, 4, 16), (1, 130, 2, 16, 16, 64),
    (2, 96, 3, 8, 16, 32)])
def test_stages_match_ssd_chunked_and_jax(b, s, h, p, n, chunk):
    ins = _recipe(b, s, h, p, n, seed=b + s + h)
    y, final = R.ssd_stages(*map(_t, ins), chunk=chunk)
    yc, hc = R.ssd_chunked(*map(_t, ins), chunk=chunk)
    torch.testing.assert_close(y, yc, **TOL)
    torch.testing.assert_close(final, hc, **TOL)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jh), **TOL)
    py = jops.ssd_scan(*map(jnp.asarray, ins), chunk, True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **TOL)


def test_each_stage_shape_and_carry():
    """The stages' intermediates in the model layout, the carry from zero,
    and C·Bᵀ's causal half (all the output stage reads) equal to the
    product's."""
    b, s, h, p, n, q = 2, 48, 3, 8, 16, 16
    x, a, dt, B, C = map(_t, _recipe(b, s, h, p, n, seed=7))
    la, ela, wst, dec = R.ssd_stage_la(a, dt, q)
    assert la.shape == ela.shape == wst.shape == (b, s // q, q, h)
    assert dec.shape == (b, s // q, h)
    torch.testing.assert_close(dec, ela[:, :, -1], rtol=0, atol=0)
    cb = R.ssd_stage_cb(B, C, q)
    want = torch.einsum("bcqn,bckn->bcqk", C.reshape(b, 3, q, n), B.reshape(b, 3, q, n))
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    torch.testing.assert_close(cb[..., causal], want[..., causal], rtol=1e-6, atol=1e-5)
    states = R.ssd_stage_states(x, B, wst)
    h_in, final = R.ssd_stage_carry(states, dec)
    assert states.shape == h_in.shape == (b, s // q, h, n, p)
    assert bool((h_in[:, 0] == 0).all())
    torch.testing.assert_close(h_in[:, 1], states[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(final, h_in[:, 2] * dec[:, 2, :, None, None] + states[:, 2],
                               rtol=0, atol=0)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                    # TF32's spacing at 1
    v = torch.tensor([one + 0.49 * ulp, one + 0.5 * ulp, one + 0.51 * ulp,
                      -(one + 0.5 * ulp), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp), 3.0, 0.0])
    assert torch.equal(R.tf32_round(v), want)
    r = R.tf32_round(torch.randn(1000))
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(R.tf32_trunc(v), torch.tensor([one, one, one, -one, 3.0, 0.0]))


@pytest.mark.parametrize("s,chunk", [(256, 128), (192, 64)])
def test_3xtf32_holds_the_tolerance_where_tf32_does_not(s, chunk):
    """The phase-2 recipe at the full state and head widths (N = 128, P =
    64), cut in batch, heads and length."""
    ins = tuple(map(_t, _recipe(1, s, 2, 64, 128, seed=s)))
    yc, hc = R.ssd_chunked(*ins, chunk=chunk)
    for part in (R.tf32_trunc, R.tf32_round):   # the card's split, and to nearest
        y3, h3 = R.ssd_stages(*ins, chunk=chunk,
                              mm=lambda a, b: R.matmul_3xtf32(a, b, part))
        assert _within(y3, yc) and _within(h3, hc)
    y1, h1 = R.ssd_stages(*ins, chunk=chunk, mm=R.matmul_tf32)
    assert not (_within(y1, yc) and _within(h1, hc))

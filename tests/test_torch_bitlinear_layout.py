"""The plain versions of the bitlinear kernel's parts against the JAX package,
on the CPU.

The card's bitlinear call is three kernels (``csrc/bitlinear.cu``): a
quantizing pass into int8 codes ``[M, Kp]`` with K padded to the GEMM's K
tile, the weight as K-major codes ``[N, Kp]``, and the product of the two.
Their plain versions (``kernels/bitlinear/ref.py``) are held here:

* the codes and γ bitwise to the activation quantizer of both packages, the
  pad all zeros;
* the K-major weight bitwise to ``wq.t()`` and, from the master weight, to
  ``weight_quant_absmean``'s codes;
* the product of the padded codes and the padded weight bitwise to
  ``bitlinear_ref`` on the unpadded operands (the zero pad adds nothing to
  the exact integer sum), and to the JAX ``ref.py::bitlinear_ref`` and the
  Pallas kernel in interpret mode at the tolerances of
  ``tests/test_torch_train_kernels.py`` (fp32 rtol 1e-5: the scale rounds in
  another order; bf16 one bf16 ulp), ragged K included;
* ``bitlinear_matmul``'s gradients, now from the forward's saved codes,
  bitwise to the backward that recomputes them from x and γ, and to
  ``jax.grad`` at rtol 1e-4 (fp32 matmuls in another summation order).

The CUDA kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.kernels.bitlinear import ops as jbl_ops, ref as jbl_ref
from repro.kernels.bitlinear.kernel import bitlinear_kernel as j_bitlinear_kernel
from repro_torch.core import quant as TQ
from repro_torch.kernels.bitlinear import ops as bl_ops, ref as bl_ref


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    return x, w


class TestPaddedCodes:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("m,k", [(8, 64), (5, 130), (30, 520), (3, 128)])
    def test_codes_and_gamma_match_both_quantizers(self, dtype, m, k):
        x, _ = _operands(m, k, 1, seed=m * k)
        xt = _t(x).to(dtype)
        codes, gamma = bl_ref.quantize_rows_ref(xt)
        kp = codes.shape[1]
        assert codes.dtype == torch.int8 and kp % bl_ref.K_TILE == 0
        assert k <= kp < k + bl_ref.K_TILE and kp == bl_ref.padded_k(k)
        assert bool((codes[:, k:] == 0).all())
        tq, tgamma = TQ.act_quant_absmax_int8(xt)
        assert torch.equal(gamma, tgamma)
        assert torch.equal(codes[:, :k], tq.to(torch.int8))
        jq, jgamma = JQ.act_quant_absmax_int8(jnp.asarray(xt.float().numpy()))
        np.testing.assert_array_equal(gamma.numpy(), np.asarray(jgamma))
        np.testing.assert_array_equal(codes[:, :k].numpy(),
                                      np.asarray(jq).astype(np.int8))

    def test_given_gamma_gives_the_same_codes(self):
        x, _ = _operands(6, 200, 1, seed=3)
        codes, gamma = bl_ref.quantize_rows_ref(_t(x))
        codes2, gamma2 = bl_ref.quantize_rows_ref(_t(x), gamma)
        assert gamma2 is gamma and torch.equal(codes2, codes)


class TestKMajorWeight:
    @pytest.mark.parametrize("k,n", [(64, 32), (520, 200), (130, 36)])
    def test_is_the_transpose_with_a_zero_pad(self, k, n):
        _, w = _operands(1, k, n, seed=k + n)
        q, _ = TQ.weight_quant_absmean(_t(w))
        wq = q.to(torch.int8)
        wt, same = bl_ref.weight_kmajor_ref(wq)
        assert same is wq and wt.shape == (n, bl_ref.padded_k(k))
        assert torch.equal(wt[:, :k], wq.t()) and bool((wt[:, k:] == 0).all())

    @pytest.mark.parametrize("k,n", [(64, 32), (520, 200)])
    def test_ternarizes_as_both_packages(self, k, n):
        _, w = _operands(1, k, n, seed=2 * k + n)
        q, delta = TQ.weight_quant_absmean(_t(w))
        wt, wq = bl_ref.weight_kmajor_ref(_t(w), TQ.absmean_scale(_t(w)))
        assert torch.equal(wq, q.to(torch.int8))
        assert torch.equal(wt[:, :k], wq.t())
        # the JAX package's Δ differs by ≤ 2 ulp (ROADMAP Queue C); with its
        # own Δ its codes are the same
        jq, jdelta = JQ.weight_quant_absmean(jnp.asarray(w))
        _, wq_j = bl_ref.weight_kmajor_ref(_t(w), _t(np.asarray(jdelta)))
        np.testing.assert_array_equal(wq_j.numpy(), np.asarray(jq).astype(np.int8))


class TestCodesProduct:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("m,k,n", [(8, 64, 32), (100, 300, 200), (5, 130, 36),
                                       (64, 520, 96)])
    def test_padded_parts_equal_bitlinear_ref(self, dtype, m, k, n):
        x, w = _operands(m, k, n, seed=m + k + n)
        xt = _t(x).to(dtype)
        q, delta = TQ.weight_quant_absmean(_t(w))
        wq = q.to(torch.int8)
        codes, gamma = bl_ref.quantize_rows_ref(xt)
        wt, _ = bl_ref.weight_kmajor_ref(wq)
        got = bl_ref.bitlinear_codes_ref(codes, wt, gamma, delta, dtype)
        assert got.dtype == dtype
        assert torch.equal(got, bl_ref.bitlinear_ref(xt, wq, gamma, delta))

    @pytest.mark.parametrize("m,k,n", [(8, 64, 32), (5, 130, 36), (64, 520, 96)])
    def test_padded_parts_match_jax_ref_and_pallas(self, m, k, n):
        x, w = _operands(m, k, n, seed=7 * m + k)
        jq, jdelta = JQ.weight_quant_absmean(jnp.asarray(w))
        wq = np.asarray(jq, np.int8)
        codes, gamma = bl_ref.quantize_rows_ref(_t(x))
        wt, _ = bl_ref.weight_kmajor_ref(_t(wq))
        got = bl_ref.bitlinear_codes_ref(codes, wt, gamma, _t(np.asarray(jdelta)),
                                         torch.float32).numpy()
        args = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(gamma.numpy()),
                jnp.asarray(jdelta))
        want_ref = np.asarray(jbl_ref.bitlinear_ref(*args))
        want_pallas = np.asarray(j_bitlinear_kernel(*args, bm=64, bn=128, bk=128,
                                                    interpret=True))
        np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-6)

    def test_padded_parts_bf16_within_one_ulp_of_pallas(self):
        x, w = _operands(16, 520, 64, seed=11)
        jq, jdelta = JQ.weight_quant_absmean(jnp.asarray(w))
        wq = np.asarray(jq, np.int8)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        gamma = jnp.max(jnp.abs(xb.astype(jnp.float32)), -1, keepdims=True)
        want = np.asarray(j_bitlinear_kernel(xb, jnp.asarray(wq), gamma, jdelta,
                                             bm=16, bn=64, bk=128, interpret=True)
                          .astype(jnp.float32))
        xt = _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
        codes, tgamma = bl_ref.quantize_rows_ref(xt)
        wt, _ = bl_ref.weight_kmajor_ref(_t(wq))
        got = bl_ref.bitlinear_codes_ref(codes, wt, tgamma, _t(np.asarray(jdelta)),
                                         torch.bfloat16)
        ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
        assert np.all(np.abs(got.float().numpy() - want) <= ulp + 1e-30)


class TestSavedCodesGradients:
    def test_the_op_saves_int8_codes_not_x(self):
        x, w = _operands(6, 130, 24, seed=1)
        y = bl_ops.bitlinear_matmul(_t(x).requires_grad_(), _t(w).requires_grad_())
        node = y.grad_fn
        while not hasattr(node, "saved_tensors"):      # past the reshape
            node = node.next_functions[0][0]
        codes, gamma, wq, delta = node.saved_tensors
        # on the CPU the codes carry no K pad (the card's carry the GEMM's)
        assert codes.dtype == torch.int8 and codes.shape == (6, 130)
        assert torch.equal(codes, bl_ref.quantize_rows_ref(_t(x))[0][:, :130])
        assert gamma.shape == (6, 1) and wq.dtype == torch.int8 and delta.numel() == 1

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("m,k,n", [(12, 130, 24), (8, 64, 32)])
    def test_gradients_equal_the_recomputing_backward(self, dtype, m, k, n):
        """Bit for bit the backward of the parent design, which recomputed
        the codes from the saved x and γ (the JAX ``_vjp_bwd``)."""
        x, w = _operands(m, k, n, seed=5 * m + n)
        r = np.random.default_rng(9).standard_normal((m, n)).astype(np.float32)
        xt, wt, rt = _t(x).to(dtype), _t(w), _t(r).to(dtype)
        x1, w1 = xt.clone().requires_grad_(), wt.clone().requires_grad_()
        (bl_ops.bitlinear_matmul(x1, w1) * rt).sum().backward()
        q, delta = TQ.weight_quant_absmean(wt)
        gamma = xt.float().abs().amax(-1, keepdim=True)
        xq = TQ.round_clip(xt.float() * TQ.div(127.0, gamma + 1e-5), -128.0, 127.0)
        x_deq = xq * TQ.div(gamma, 127.0)
        g2d = rt.float()
        dx = torch.matmul(g2d, (q.to(torch.int8).float() * delta).t())
        dw = torch.matmul(x_deq.t(), g2d)
        assert torch.equal(x1.grad, dx.to(dtype))
        assert torch.equal(w1.grad, dw)

    @pytest.mark.parametrize("k", [130, 520])
    def test_gradients_match_jax_grad_at_a_ragged_k(self, k):
        rng = np.random.default_rng(k)
        x = rng.standard_normal((2, 8, k)).astype(np.float32)
        w = (rng.standard_normal((k, 40)) * 0.02).astype(np.float32)
        gj = jax.grad(lambda x, w: jnp.sum(jbl_ops.bitlinear_matmul(
            x, w, interpret=True) ** 2), (0, 1))(jnp.asarray(x), jnp.asarray(w))
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        torch.sum(bl_ops.bitlinear_matmul(xt, wt) ** 2).backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[0]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj[1]),
                                   rtol=1e-4, atol=1e-6)

"""The port's two training kernels against the JAX package, on the CPU.

On the CPU each port wrapper takes its kernel's plain PyTorch version; the
plain versions are held to the JAX oracles (``bitlinear_ref``,
``relation_kl_rows_ref``) and to the Pallas kernels run in interpret mode,
as tests/test_kernels.py runs them, over the cases of its
``TestBitLinearKernel`` and ``TestRelationKD``.  Tolerances:

* bitlinear forward, fp32: rtol 1e-5 — the integer products are exact on
  both sides, the scale differs in its last bit (the port scales as the
  kernel does, ``acc·((γ/127)·Δ)``; the JAX oracle ``(acc·γ/127)·Δ``) and the
  absmean Δ is summed in another order (≤ 2 ulp).  bf16: one bf16 ulp.
* STE gradients: rtol 1e-4 (fp32 matmuls in another summation order).
* relation rows: rtol 1e-4, atol 1e-5 (the JAX ``TestRelationKD`` bounds);
  the loss rtol 1e-5 and its gradient rtol 1e-4, atol 1e-7 against the
  Pallas path, and the JAX test's rtol 1e-3, atol 1e-6 against the jnp path
  (which clamps probabilities at 1e-8; the kernel path does not).

The CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.core.distill import attention_relation_loss as j_attention_relation_loss
from repro.kernels.bitlinear import ops as jbl_ops, ref as jbl_ref
from repro.kernels.bitlinear.kernel import bitlinear_kernel as j_bitlinear_kernel
from repro.kernels.relation_kd import ops as jrk_ops, ref as jrk_ref
from repro.kernels.relation_kd.kernel import relation_kl_rows_kernel as j_rows_kernel
from repro_torch.core import quant as TQ
from repro_torch.core.distill import attention_relation_loss
from repro_torch.kernels.bitlinear import kernel as bl_kernel, ops as bl_ops, ref as bl_ref
from repro_torch.kernels.relation_kd import kernel as rk_kernel, ops as rk_ops
from repro_torch.kernels.relation_kd import ref as rk_ref


def _t(a):
    return torch.from_numpy(np.array(a))


# -- bitlinear ----------------------------------------------------------------

def _bitlinear_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    qw, delta = JQ.weight_quant_absmean(jnp.asarray(w))
    gamma = np.abs(x).max(-1, keepdims=True)
    return x, w, np.asarray(qw, np.int8), np.asarray(delta), gamma


class TestBitLinear:
    @pytest.mark.parametrize("m,k,n", [(8, 64, 32), (256, 512, 256),
                                       (100, 300, 200), (1, 128, 128)])
    def test_plain_matches_jax_ref_and_pallas(self, m, k, n):
        x, _, wq, delta, gamma = _bitlinear_case(m, k, n, seed=m + k)
        got = bl_ref.bitlinear_ref(_t(x), _t(wq), _t(gamma), _t(delta)).numpy()
        args = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(gamma),
                jnp.asarray(delta))
        want_ref = np.asarray(jbl_ref.bitlinear_ref(*args))
        want_pallas = np.asarray(j_bitlinear_kernel(*args, bm=128, bn=128,
                                                    bk=128, interpret=True))
        np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-6)

    def test_plain_bf16_within_one_ulp_of_pallas(self):
        x, _, wq, delta, _ = _bitlinear_case(64, 256, 96, seed=7)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        gamma = jnp.max(jnp.abs(xb.astype(jnp.float32)), -1, keepdims=True)
        want = np.asarray(j_bitlinear_kernel(xb, jnp.asarray(wq), gamma,
                                             jnp.asarray(delta), bm=64, bn=96,
                                             bk=128, interpret=True)
                          .astype(jnp.float32))
        xt = _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
        got = bl_ref.bitlinear_ref(xt, _t(wq), _t(np.asarray(gamma)), _t(delta))
        assert got.dtype == torch.bfloat16
        ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
        assert np.all(np.abs(got.float().numpy() - want) <= ulp + 1e-30)

    def test_ops_forward_matches_jax_ops(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((4, 32, 64)).astype(np.float32)
        w = (rng.standard_normal((64, 48)) * 0.02).astype(np.float32)
        got = bl_ops.bitlinear_matmul(_t(x), _t(w)).numpy()
        want = np.asarray(jbl_ops.bitlinear_matmul(jnp.asarray(x), jnp.asarray(w),
                                                   interpret=True))
        full = bl_ref.bitlinear_full_ref(_t(x).reshape(-1, 64), _t(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.reshape(-1, 48), full, rtol=1e-5, atol=1e-5)

    def test_ste_gradients_match_jax(self):
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 8, 64)).astype(np.float32)
        w = (rng.standard_normal((64, 32)) * 0.02).astype(np.float32)
        gj = jax.grad(lambda x, w: jnp.sum(jbl_ops.bitlinear_matmul(
            x, w, interpret=True) ** 2), (0, 1))(jnp.asarray(x), jnp.asarray(w))
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        torch.sum(bl_ops.bitlinear_matmul(xt, wt) ** 2).backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[0]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj[1]),
                                   rtol=1e-4, atol=1e-6)

    def test_ste_gradients_equal_fake_quant_path(self):
        """The kernel's custom backward is the STE of the fake-quant path."""
        rng = np.random.default_rng(5)
        x = _t(rng.standard_normal((8, 64)).astype(np.float32))
        w = _t((rng.standard_normal((64, 32)) * 0.02).astype(np.float32))
        x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.sum(bl_ops.bitlinear_matmul(x1, w1) ** 2).backward()
        x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.sum((TQ.fake_quant_act(x2) @ TQ.fake_quant_weight(w2)) ** 2).backward()
        torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-4, atol=1e-6)

    def test_kernel_rejects_cpu_tensors(self):
        """No fallback: the kernel entry takes CUDA tensors or raises."""
        x, _, wq, delta, gamma = _bitlinear_case(4, 64, 32, seed=1)
        with pytest.raises(ValueError, match="CUDA"):
            bl_kernel.bitlinear_kernel(_t(x), _t(wq), _t(gamma), _t(delta))
        # a scheme the kernel does not take is refused, named, on either
        # device (the JAX route silently quantizes it with absmean)
        with pytest.raises(ValueError, match="'gptq'"):
            bl_ops.bitlinear_matmul(_t(x), _t(wq).float(), scheme="gptq")


# -- relation KD ----------------------------------------------------------------

def _unit(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


class TestRelationKD:
    @pytest.mark.parametrize("bh,l,d", [(2, 64, 32), (4, 100, 16), (3, 256, 64)])
    def test_rows_match_jax_ref_and_pallas(self, bh, l, d):
        rng = np.random.default_rng(bh * l)
        s, t = _unit(rng, (bh, l, d)), _unit(rng, (bh, l, d))
        got = rk_ops.relation_kl_rows(_t(s), _t(t), 1.0).numpy()
        want_pallas = np.asarray(j_rows_kernel(jnp.asarray(s), jnp.asarray(t),
                                               temp=1.0, bl=32, bj=32,
                                               interpret=True))
        want_ref = np.asarray(jrk_ref.relation_kl_rows_ref(jnp.asarray(s),
                                                           jnp.asarray(t), 1.0))
        np.testing.assert_allclose(got, want_pallas, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, want_ref, rtol=1e-4, atol=1e-5)

    def test_zero_when_identical_and_temperature(self):
        rng = np.random.default_rng(2)
        s = _unit(rng, (2, 32, 16))
        np.testing.assert_allclose(rk_ops.relation_kl_rows(_t(s), _t(s)).numpy(),
                                   0.0, atol=1e-5)
        t = _unit(rng, (2, 32, 16))
        got = rk_ops.relation_kl_rows(_t(s), _t(t), 0.5).numpy()
        want = np.asarray(j_rows_kernel(jnp.asarray(s), jnp.asarray(t), temp=0.5,
                                        interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_loss_and_grad_match_jax(self):
        rng = np.random.default_rng(3)
        ss = rng.standard_normal((3, 2, 4, 64, 16)).astype(np.float32)
        ts = rng.standard_normal((3, 2, 4, 64, 16)).astype(np.float32)
        alphas = (1.0, 0.5, 2.0)
        jl = lambda s: jrk_ops.relation_kd_loss(s, jnp.asarray(ts), split_heads=2,
                                                alphas=alphas, interpret=True)
        jp = lambda s: j_attention_relation_loss(s, jnp.asarray(ts), split_heads=2,
                                                 alphas=alphas)
        want_l, want_g = jax.value_and_grad(jl)(jnp.asarray(ss))
        plain_l, plain_g = jax.value_and_grad(jp)(jnp.asarray(ss))
        st = _t(ss).requires_grad_()
        loss = rk_ops.relation_kd_loss(st, _t(ts), split_heads=2, alphas=alphas)
        loss.backward()
        loss = loss.detach()
        np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(float(loss), float(plain_l), rtol=1e-4)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(plain_g),
                                   rtol=1e-3, atol=1e-6)

    def test_blocked_backward_matches_autograd_of_plain_rows(self):
        """The recompute backward (row blocks smaller than L) equals autograd
        through the materialized rows; a ragged last block included."""
        rng = np.random.default_rng(6)
        s, t = _unit(rng, (3, 70, 8)), _unit(rng, (3, 70, 8))
        s1 = _t(s).requires_grad_()
        rk_ops._RelationMeanKL.apply(s1, _t(t), 0.7, 32).backward()
        s2 = _t(s).requires_grad_()
        torch.mean(rk_ref.relation_kl_rows_ref(s2, _t(t), 0.7)).backward()
        torch.testing.assert_close(s1.grad, s2.grad, rtol=1e-4, atol=1e-8)

    def test_use_kernel_route_and_kernel_rejects_cpu(self):
        rng = np.random.default_rng(8)
        ss = _t(rng.standard_normal((3, 1, 4, 32, 8)).astype(np.float32))
        ts = _t(rng.standard_normal((3, 1, 4, 32, 8)).astype(np.float32))
        a = attention_relation_loss(ss, ts, split_heads=2, use_kernel=True)
        b = rk_ops.relation_kd_loss(ss, ts, split_heads=2)
        assert float(a) == float(b)
        with pytest.raises(ValueError, match="CUDA"):
            rk_kernel.relation_kl_rows_kernel(ss[0, 0], ts[0, 0])

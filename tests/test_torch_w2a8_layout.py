"""The plain models of the w2a8 kernel's two routes against the JAX package,
on the CPU.

The card's w2a8 (``csrc/w2a8_gemv.cu``) takes one of two routes by M; their
plain models (``kernels/w2a8_gemv/ref.py``) are held here:

* the unpack of one packed byte into the word of its four int8 codes,
  bitwise to ``unpack_ternary`` of both packages for all 256 bytes;
* the wgmma route's shared-memory layout: the packed tile read with TMA's
  128-byte swizzle, each byte expanded by the unpacking warpgroup into its
  word at the swizzled K-major address, de-swizzles bitwise to
  ``unpack(wp).t()`` (padded to the 128-byte K tile with the codes of the
  zero bytes TMA fills in), and the unpackers' loads and stores each hit
  distinct banks;
* the wgmma route's product (bitlinear's quantizing pass, the codes against
  that K-major weight) bitwise to ``w2a8_ref``, and to the JAX
  ``w2a8_gemv/ref.py`` and the Pallas kernel in interpret mode at the
  tolerances of ``tests/test_torch_kernels.py::TestW2A8`` (fp32 rtol 1e-6,
  atol 1e-5: the scale rounds in another order; bf16 rtol 2**-8);
* the split-K route's int32 sums of K slices added in a shuffled order (the
  atomics' order is the hardware's) bitwise to ``w2a8_ref``, and to JAX at
  the same tolerances.

The CUDA kernels themselves are held to ``w2a8_ref`` on the card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.kernels.w2a8_gemv import ops as jw_ops, ref as jw_ref
from repro_torch.core import quant as TQ
from repro_torch.kernels.w2a8_gemv import ref as w2_ref

FP32 = dict(rtol=1e-6, atol=1e-5)
BF16 = dict(rtol=2 ** -8, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    q, delta = TQ.weight_quant_absmean(_t(w))
    return x, TQ.pack_ternary(q.to(torch.int8)), delta


def _jax(x, wp, delta, dtype):
    """The JAX oracle and the Pallas kernel in interpret mode, as fp32 numpy."""
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jwp, jd = jnp.asarray(wp.numpy()), jnp.asarray(delta.numpy())
    ref = jw_ref.w2a8_ref(jx, jwp, jd)
    pallas = jw_ops.w2a8_matmul(jx, jwp, jd, interpret=True)
    return (np.asarray(ref.astype(jnp.float32)), np.asarray(pallas.astype(jnp.float32)))


class TestUnpack:
    def test_every_byte_matches_both_packages(self):
        b = torch.arange(256, dtype=torch.int64)
        codes = w2_ref.word_codes(w2_ref.unpack4_ref(b))          # [256, 4]
        want = TQ.unpack_ternary(b.to(torch.uint8)[None, :], 4).t()
        assert torch.equal(codes, want)
        jwant = np.asarray(JQ.unpack_ternary(jnp.arange(256, dtype=jnp.uint8)[None, :], 4)).T
        np.testing.assert_array_equal(codes.numpy(), jwant)


class TestWgmmaLayout:
    def test_swizzle_is_its_own_inverse_and_moves_whole_chunks(self):
        tile = torch.arange(32 * 128, dtype=torch.int64).remainder(251).to(torch.uint8)
        tile = tile.reshape(32, 128)
        sw = w2_ref.swizzle128(tile)
        assert torch.equal(w2_ref.swizzle128(sw), tile)
        for r in (0, 5, 13):
            for c in (0, 3, 7):
                at = (c ^ (r % 8)) * 16
                assert torch.equal(sw[r, at:at + 16], tile[r, 16 * c:16 * c + 16])

    @pytest.mark.parametrize("k,n", [(128, 128), (520, 256), (1024, 384), (4, 16)])
    def test_stage_images_deswizzle_to_the_kmajor_weight(self, k, n):
        _, wp, _ = _case(1, k, n, seed=k + n)
        km = w2_ref.kmajor_weight_ref(wp)
        kp = km.shape[1]
        assert kp % w2_ref.TILE == 0 and k <= kp < k + w2_ref.TILE
        assert torch.equal(km[:, :k], TQ.unpack_ternary(wp, k).t())
        assert bool((km[:, k:] == -1).all())      # zero bytes past K/4
        for kt in range(kp // 128):
            for nt in range(-(-n // 128)):
                # the packed tile as TMA reads it: zeros past the edges
                pt = torch.zeros((32, 128), dtype=torch.uint8)
                src = wp[32 * kt:32 * kt + 32, 128 * nt:128 * nt + 128]
                pt[:src.shape[0], :src.shape[1]] = src
                img = w2_ref.unpack_tile_ref(w2_ref.swizzle128(pt))
                got = w2_ref.swizzle128(img.view(torch.uint8)).view(torch.int8)
                cols = km[128 * nt:128 * nt + 128, 128 * kt:128 * kt + 128]
                assert torch.equal(got[:cols.shape[0]], cols)

    def test_unpackers_access_distinct_banks(self):
        """Lane = packed row kp.  A 16-byte load is served 8 lanes at a
        time: lanes 8i..8i+7 read chunk c at c ^ (kp % 8), 8 distinct
        chunks.  A 4-byte store of byte j goes to row n = 16c + j, chunk
        (kp >> 2) ^ (n % 8), word kp % 4: 32 distinct banks."""
        kp = np.arange(32)
        for c in range(8):
            for i in range(4):
                lanes = kp[8 * i:8 * i + 8]
                assert len({(c ^ (lane % 8)) for lane in lanes}) == 8
            for j in range(16):
                n = 16 * c + j
                at = n * 128 + ((((kp >> 2) ^ (n % 8)) << 4) | ((kp % 4) << 2))
                assert len(set((at // 4) % 32)) == 32


class TestRoutes:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("m,k,n", [(1, 256, 64), (9, 520, 48), (33, 1024, 128)])
    def test_wgmma_route_matches_plain_and_jax(self, dtype, m, k, n):
        x, wp, delta = _case(m, k, n, seed=m + k)
        xt = _t(x).to(dtype)
        got = w2_ref.w2a8_wgmma_ref(xt, wp, delta)
        assert got.dtype == dtype
        assert torch.equal(got, w2_ref.w2a8_ref(xt, wp, delta))
        ref, pallas = _jax(x, wp, delta, dtype)
        tol = FP32 if dtype == torch.float32 else BF16
        np.testing.assert_allclose(got.float().numpy(), ref, **tol)
        np.testing.assert_allclose(got.float().numpy(), pallas, **tol)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("m,k,n,kps", [(8, 1024, 96, 16), (3, 520, 40, 32),
                                           (5, 3072, 64, 48), (12, 256, 32, 16)])
    def test_splitk_sums_in_any_order_match_plain_and_jax(self, dtype, m, k, n, kps):
        x, wp, delta = _case(m, k, n, seed=m * k + n)
        xt = _t(x).to(dtype)
        splits = -(-(k // 4) // kps)
        order = np.random.default_rng(kps).permutation(splits).tolist()
        got = w2_ref.w2a8_splitk_ref(xt, wp, delta, kps, order)
        assert torch.equal(got, w2_ref.w2a8_ref(xt, wp, delta))
        assert torch.equal(got, w2_ref.w2a8_splitk_ref(xt, wp, delta, kps))
        ref, pallas = _jax(x, wp, delta, dtype)
        tol = FP32 if dtype == torch.float32 else BF16
        np.testing.assert_allclose(got.float().numpy(), ref, **tol)
        np.testing.assert_allclose(got.float().numpy(), pallas, **tol)

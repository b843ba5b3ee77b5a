"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card (this file
imports neither JAX nor the JAX package, so it also runs on a machine with
only PyTorch).  On the card, where ``tests/conftest.py`` cannot import JAX,
the marker is registered on the command line:
``PYTHONPATH=src python -m pytest --noconftest -o markers=cuda tests/test_torch_cuda.py``.
w2a8 must equal its plain version exactly (integer products, same op order);
the attention kernels sum in another order than the plain versions, so fp32
outputs are held to 1e-5 and bf16 outputs to one bf16 ulp at |x| < 2; the
pools after the call equal bitwise outside the trash block.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import quant as Q
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.paged_prefill import kernel as pp_kernel
from repro_torch.kernels.paged_prefill import ref as pp_ref
from repro_torch.kernels.w2a8_gemv import kernel as w2_kernel
from repro_torch.kernels.w2a8_gemv import ops as w2_ops
from repro_torch.kernels.w2a8_gemv import ref as w2_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _atol(dtype):
    return 1e-5 if dtype == torch.float32 else 2 ** -7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 1024, 3072), (256, 3072, 1024),
                                   (3, 128, 40)])
def test_w2a8_kernel_matches_plain(cuda, dtype, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.02
    q, delta = Q.weight_quant_absmean(w)
    wp = Q.pack_ternary(q.to(torch.int8))
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    before = w2_kernel.launches.count
    y = w2_ops.w2a8_matmul(x, wp, delta)
    assert w2_kernel.launches.count == before + 1
    torch.testing.assert_close(y, w2_ref.w2a8_ref(x, wp, delta), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_decode_kernel_matches_plain(cuda, dtype, softcap):
    rng = np.random.default_rng(3)
    B, Hkv, g, Dh, bs, L = 4, 2, 2, 64, 16, 6
    idx = np.array([95, 16, 0, L * bs - 1], np.int32)       # row 3 idle
    bt = np.zeros((B, L), np.int32)
    bt[:3] = np.arange(1, 1 + 3 * L).reshape(3, L)
    kp = rng.standard_normal((1 + 3 * L, Hkv, bs, Dh)).astype(np.float32)
    q = rng.standard_normal((B, Hkv, g, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, Dh)).astype(np.float32)
    dev = lambda a: torch.from_numpy(a).to(cuda, dtype)
    k1, v1 = dev(kp), dev(kp * 0.5)
    k2, v2 = k1.clone(), v1.clone()
    bt_d, idx_d = torch.from_numpy(bt).to(cuda), torch.from_numpy(idx).to(cuda)
    out, _, _ = pa_kernel.paged_attention_decode_kernel(
        dev(q), dev(kn), dev(kn * 2), k1, v1, bt_d, idx_d, Dh ** -0.5, softcap)
    ref, _, _ = pa_ref.paged_attention_decode_ref(
        dev(q), dev(kn), dev(kn * 2), k2, v2, bt_d, idx_d, Dh ** -0.5, softcap)
    torch.testing.assert_close(out[:3].float(), ref[:3].float(), rtol=0,
                               atol=_atol(dtype))
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(4)
    B, Hkv, g, Dh, bs, L, T = 3, 2, 2, 64, 16, 8, 32
    starts = np.array([0, 70, 100], np.int32)
    lens = np.array([32, 20, 1], np.int32)
    bt = np.arange(1, 1 + B * L, dtype=np.int32).reshape(B, L)
    kp = rng.standard_normal((1 + B * L, Hkv, bs, Dh)).astype(np.float32)
    q = rng.standard_normal((B, Hkv, T * g, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, T, Dh)).astype(np.float32)
    dev = lambda a: torch.from_numpy(a).to(cuda, dtype)
    k1, v1 = dev(kp), dev(-kp)
    k2, v2 = k1.clone(), v1.clone()
    args = (torch.from_numpy(bt).to(cuda), torch.from_numpy(starts).to(cuda),
            torch.from_numpy(lens).to(cuda), Dh ** -0.5, 0.0)
    out, _, _ = pp_kernel.paged_prefill_chunk_kernel(
        dev(q), dev(kc), dev(kc * 0.5), k1, v1, *args)
    ref, _, _ = pp_ref.paged_prefill_chunk_ref(
        dev(q), dev(kc), dev(kc * 0.5), k2, v2, *args)
    for b in range(B):
        torch.testing.assert_close(out[b, :, :lens[b] * g].float(),
                                   ref[b, :, :lens[b] * g].float(),
                                   rtol=0, atol=_atol(dtype))
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])


def test_kernels_raise_on_a_bad_operand(cuda):
    """The wrappers check what the kernels take and raise, never fall back."""
    x = torch.zeros((2, 128), device=cuda)
    wp = torch.zeros((32, 16), dtype=torch.uint8, device=cuda)
    delta = torch.ones((), device=cuda)
    with pytest.raises(ValueError, match="packed rows"):
        w2_kernel.w2a8_kernel(x[:, :64].contiguous(), wp, delta)
    with pytest.raises(TypeError, match="not supported"):
        w2_kernel.w2a8_kernel(x.half(), wp, delta)
    with pytest.raises(ValueError, match="contiguous"):
        w2_kernel.w2a8_kernel(torch.zeros((128, 2), device=cuda).t(), wp, delta)

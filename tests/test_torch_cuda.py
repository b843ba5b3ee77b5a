"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card (this file
imports neither JAX nor the JAX package, so it also runs on a machine with
only PyTorch).  On the card, where ``tests/conftest.py`` cannot import JAX,
the marker is registered on the command line:
``PYTHONPATH=src python -m pytest --noconftest -o markers=cuda tests/test_torch_cuda.py``.
w2a8 and bitlinear (and its quantizing pass, K-major weight and STE
gradients) must equal their plain versions exactly (integer
products, same op order); the attention kernels sum in another order than
the plain versions, so fp32 outputs are held to 1e-5 and bf16 outputs to one
bf16 ulp at |x| < 2, over the valid query rows of live rows only (pad rows
must be zeros, idle rows finite); the pools after the call equal bitwise
outside the trash block.  The relation-KD rows are held to rtol 1e-5, atol 1e-6 (fp32
dot products and an online softmax against the materialized log-softmax).
The SSD scan's y and final state are held to rtol 1e-4, atol 1e-4 against
``ssd_chunked`` and the sequential ``ssd_scan_ref`` (fp32 sums in another
order; the JAX package's own tolerance for this kernel), its gradient to
1e-3 (the backward recomputes through ``ssd_chunked``, so that case shows
the ``autograd.Function`` is wired up).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import quant as Q
from repro_torch.kernels.bitlinear import kernel as bl_kernel
from repro_torch.kernels.bitlinear import ops as bl_ops
from repro_torch.kernels.bitlinear import ref as bl_ref
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.paged_prefill import kernel as pp_kernel
from repro_torch.kernels.paged_prefill import ref as pp_ref
from repro_torch.kernels.relation_kd import kernel as rk_kernel
from repro_torch.kernels.relation_kd import ops as rk_ops
from repro_torch.kernels.relation_kd import ref as rk_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
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


# the serving path's five projection shapes (qwen3-0.6b: q/o, k/v, down's
# input, gate/up, down), granite's k/v, and M on both sides of the route
# threshold
W2A8_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024),
               (1024, 512)]   # granite-moe-1b-a400m's k/v (q/o: (1024, 1024))
SPLIT_K_MAX_M = 8     # held to the .cu's by test_w2a8_route_threshold


def _w2a8_operands(dev, m, k, n, dtype):
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    q, delta = Q.weight_quant_absmean(w)
    wp = Q.pack_ternary(q.to(torch.int8))
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    return x, wp, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 1024, 3072), (256, 3072, 1024),
                                   (3, 128, 40)] + [
    (m, k, n) for m in (1, SPLIT_K_MAX_M, SPLIT_K_MAX_M + 1, 64, 256, 2048)
    for k, n in W2A8_SHAPES])
def test_w2a8_kernel_matches_plain(cuda, dtype, m, k, n):
    x, wp, delta = _w2a8_operands(cuda, m, k, n, dtype)
    before = w2_kernel.launches.count
    y = w2_ops.w2a8_matmul(x, wp, delta)
    assert w2_kernel.launches.count == before + 1
    torch.testing.assert_close(y, w2_ref.w2a8_ref(x, wp, delta), rtol=0, atol=0)


def test_w2a8_route_threshold(cuda):
    """The route by M: split-K up to the .cu's threshold, wgmma above it,
    and split-K wherever TMA cannot read the packed weight (N % 16, or a
    weight not 16-byte aligned)."""
    assert w2_kernel.split_k_max_m() == SPLIT_K_MAX_M
    wp = torch.zeros((256, 3072), dtype=torch.uint8, device=cuda).data_ptr()
    assert w2_kernel.route_for(SPLIT_K_MAX_M, 3072, wp) == "splitk"
    assert w2_kernel.route_for(SPLIT_K_MAX_M + 1, 3072, wp) == "wgmma"
    assert w2_kernel.route_for(256, 40, wp) == "splitk"
    assert w2_kernel.route_for(256, 3072, wp + 4) == "splitk"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["splitk", "wgmma"])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 3072), (8, 3072, 1024), (9, 520, 48),
                                   (17, 1024, 2048), (300, 2048, 1024)])
def test_w2a8_each_route_matches_plain(cuda, dtype, route, m, k, n):
    """Either route at any M (split-K in row groups of 8; the wgmma route's
    ragged M, N and K tiles masked or zero-padded), bitwise, twice in a row
    (the split-K workspace and counters are left zero for the next call)."""
    x, wp, delta = _w2a8_operands(cuda, m, k, n, dtype)
    want = w2_ref.w2a8_ref(x, wp, delta)
    for _ in range(2):
        y = w2_kernel.w2a8_kernel(x, wp, delta, route=route)
        torch.testing.assert_close(y, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["splitk", "wgmma"])
@pytest.mark.parametrize("m,k,n,parts", [(8, 2048, 1024, 16), (256, 3072, 1024, 16),
                                         (3, 520, 48, 2), (17, 1024, 2048, 4)])
def test_w2a8_forward_acc_row_shards(cuda, dtype, route, m, k, n, parts):
    """A row shard's accumulators (γ the whole rows') equal the plain
    version's exactly on either route, and the shards' sum scaled once is
    the whole launch bit for bit (qwen3-0.6b's o_proj and down_proj at tp
    16 among the shapes)."""
    x, wp, delta = _w2a8_operands(cuda, m, k, n, dtype)
    gamma = x.float().abs().amax(dim=-1, keepdim=True)
    kk = k // parts
    total = torch.zeros((m, n), dtype=torch.float32, device=cuda)
    before = w2_kernel.acc_launches.count
    for r in range(parts):
        xs = x[:, r * kk:(r + 1) * kk].contiguous()
        ws = wp[r * kk // 4:(r + 1) * kk // 4]
        acc = w2_kernel.w2a8_forward_acc(xs, ws, gamma, route=route)
        torch.testing.assert_close(acc, w2_ref.w2a8_forward_acc_ref(xs, ws, gamma),
                                   rtol=0, atol=0)
        total += acc
    assert w2_kernel.acc_launches.count == before + parts
    y = (total * (Q.div(gamma, 127.0) * delta)).to(dtype)
    torch.testing.assert_close(y, w2_kernel.w2a8_kernel(x, wp, delta), rtol=0, atol=0)


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


def _paged_pools(rng, hkv, dh, bs, L, depths, shared=None):
    """Pools and tables with owned blocks covering each row's ``depth``
    positions; rows whose depth is None are idle (table all trash) and
    ``shared = (a, b, n)`` maps row b's first n blocks to row a's (a prefix
    both only read)."""
    B = len(depths)
    bt = np.zeros((B, L), np.int32)
    nxt = 1
    for r, d in enumerate(depths):
        if d is None:
            continue
        for j in range(min((d - 1) // bs, L - 1) + 1):
            bt[r, j] = nxt
            nxt += 1
    if shared is not None:
        a, b, n = shared
        bt[b, :n] = bt[a, :n]
    kp = rng.standard_normal((nxt, hkv, bs, dh)).astype(np.float32)
    vp = rng.standard_normal((nxt, hkv, bs, dh)).astype(np.float32)
    return bt, kp, vp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_prefill_split_walk(cuda, dtype, dh, softcap):
    """A T = 32 launch over a 1024-position table (four 256-key splits): a
    full chunk starting on a split boundary, a short chunk (lens < T), and
    mostly decode rows (lens 1) at depths 990 and 0, one sharing the first
    row's prefix blocks, one idle with an all-trash table.  Only the valid
    query rows are compared; pools bitwise outside the trash block."""
    rng = np.random.default_rng(dh + int(softcap))
    Hkv, g, bs, L, T = 2, 2, 16, 64, 32
    starts = [256, 700, 990, 300, L * bs - 1, 0]
    lens = [32, 20, 1, 1, 1, 1]
    depths = [s + n for s, n in zip(starts, lens)]
    depths[4] = None
    bt, kp, vp = _paged_pools(rng, Hkv, dh, bs, L, depths, shared=(0, 3, 16))
    B = len(starts)
    assert pa_kernel.plan(B, Hkv, T * g, T, dh, bs, L)["splits"] == 4
    q = rng.standard_normal((B, Hkv, T * g, dh)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, T, dh)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, T, dh)).astype(np.float32)
    dev = lambda a: torch.from_numpy(a).to(cuda, dtype)
    k1, v1 = dev(kp), dev(vp)
    k2, v2 = k1.clone(), v1.clone()
    args = (torch.from_numpy(bt).to(cuda),
            torch.tensor(starts, dtype=torch.int32, device=cuda),
            torch.tensor(lens, dtype=torch.int32, device=cuda), dh ** -0.5, softcap)
    before = pp_kernel.launches.count
    out, _, _ = pp_kernel.paged_prefill_chunk_kernel(dev(q), dev(kc), dev(vc),
                                                     k1, v1, *args)
    assert pp_kernel.launches.count == before + 1
    ref, _, _ = pp_ref.paged_prefill_chunk_ref(dev(q), dev(kc), dev(vc), k2, v2,
                                               *args)
    for b in range(B):
        if depths[b] is None:
            assert bool(torch.isfinite(out[b, :, :g].float()).all())
            continue
        torch.testing.assert_close(out[b, :, :lens[b] * g].float(),
                                   ref[b, :, :lens[b] * g].float(),
                                   rtol=0, atol=_atol(dtype))
        assert not bool(out[b, :, lens[b] * g:].float().any())   # pad rows zero
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="head_dim 96"):
        pp_kernel.paged_prefill_chunk_kernel(
            z(B, Hkv, T * g, 96), z(B, Hkv, T, 96), z(B, Hkv, T, 96),
            z(2, Hkv, bs, 96), z(2, Hkv, bs, 96), *args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_decode_split_walk(cuda, dtype, dh, softcap):
    """Decode over a 1024-position table (eight 128-key splits): depths
    1023 and 700, idx 256 and 128 on split boundaries, a row sharing the
    first row's prefix blocks, idx 0, and an idle row."""
    rng = np.random.default_rng(10 + dh + int(softcap))
    Hkv, g, bs, L = 2, 4, 16, 64
    idx = [1023, 700, 256, 300, 0, L * bs - 1, 128]
    depths = [i + 1 for i in idx]
    depths[5] = None
    bt, kp, vp = _paged_pools(rng, Hkv, dh, bs, L, depths, shared=(1, 3, 18))
    B = len(idx)
    assert pa_kernel.plan(B, Hkv, g, 1, dh, bs, L)["splits"] == 8
    q = rng.standard_normal((B, Hkv, g, dh)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, dh)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, dh)).astype(np.float32)
    dev = lambda a: torch.from_numpy(a).to(cuda, dtype)
    k1, v1 = dev(kp), dev(vp)
    k2, v2 = k1.clone(), v1.clone()
    args = (torch.from_numpy(bt).to(cuda),
            torch.tensor(idx, dtype=torch.int32, device=cuda), dh ** -0.5, softcap)
    before = pa_kernel.launches.count
    out, _, _ = pa_kernel.paged_attention_decode_kernel(dev(q), dev(kn), dev(vn),
                                                        k1, v1, *args)
    assert pa_kernel.launches.count == before + 1
    ref, _, _ = pa_ref.paged_attention_decode_ref(dev(q), dev(kn), dev(vn), k2, v2,
                                                  *args)
    live = [b for b in range(B) if depths[b] is not None]
    torch.testing.assert_close(out[live].float(), ref[live].float(), rtol=0,
                               atol=_atol(dtype))
    assert bool(torch.isfinite(out.float()).all())
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="head_dim 96"):
        pa_kernel.paged_attention_decode_kernel(
            z(B, Hkv, g, 96), z(B, Hkv, 96), z(B, Hkv, 96), z(2, Hkv, bs, 96),
            z(2, Hkv, bs, 96), *args)
    with pytest.raises(ValueError, match="float16"):
        pa_kernel.paged_attention_decode_kernel(
            dev(q).half(), dev(kn).half(), dev(vn).half(), k1.half(), v1.half(),
            *args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_at_gemma_heads(cuda, dtype):
    """gemma-7b's attention (16 kv heads of 256, g = 1: one query row per
    (row, head)); a head dim of 96 raises naming it."""
    _paged_kernels_at_heads(cuda, dtype, 16, 1, 256)
    with pytest.raises(ValueError, match="head_dim 96"):
        pa_kernel.plan(5, 16, 1, 1, 96, 16, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_at_granite_heads(cuda, dtype):
    """granite-moe-1b-a400m's attention: 8 kv heads of 64, g = 2."""
    _paged_kernels_at_heads(cuda, dtype, 8, 2, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hkv,g,dh", [(4, 1, 32), (2, 2, 32), (4, 1, 16)])
def test_paged_kernels_at_reduced_heads(cuda, dtype, Hkv, g, dh):
    """The reduced configs' head dims: the examples' serving model
    (examples_torch/serve_batch.py: 4 kv heads of 32, g = 1), qwen3-0.6b
    reduced (2 of 32, g = 2) and tests/test_system.py's (4 of 16)."""
    _paged_kernels_at_heads(cuda, dtype, Hkv, g, dh)


def _paged_kernels_at_heads(cuda, dtype, Hkv, g, dh):
    """A decode step and a T = 32 chunk step of one prefilling row among
    decode rows, over mixed depths with an idle row, against the plain
    versions."""
    rng = np.random.default_rng(dh)
    bs, L, T = 16, 64, 32
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda, dtype)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda)
    idx = [1023, 512, 17, 0, L * bs - 1]
    depths = [i + 1 for i in idx]
    depths[4] = None
    bt, kp, vp = _paged_pools(rng, Hkv, dh, bs, L, depths)
    B = len(idx)
    q = rng.standard_normal((B, Hkv, g, dh)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, dh)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, dh)).astype(np.float32)
    k1, v1 = dev(kp), dev(vp)
    k2, v2 = k1.clone(), v1.clone()
    args = (torch.from_numpy(bt).to(cuda), i32(idx), dh ** -0.5, 0.0)
    out, _, _ = pa_kernel.paged_attention_decode_kernel(dev(q), dev(kn), dev(vn),
                                                        k1, v1, *args)
    ref, _, _ = pa_ref.paged_attention_decode_ref(dev(q), dev(kn), dev(vn), k2, v2,
                                                  *args)
    torch.testing.assert_close(out[:4].float(), ref[:4].float(), rtol=0,
                               atol=_atol(dtype))
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    starts, lens = [256, 17, 130, 990, L * bs - 1], [32, 1, 1, 1, 1]
    depths = [s + n for s, n in zip(starts, lens)]
    depths[4] = None
    bt, kp, vp = _paged_pools(rng, Hkv, dh, bs, L, depths)
    q = rng.standard_normal((B, Hkv, T * g, dh)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, T, dh)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, T, dh)).astype(np.float32)
    k1, v1 = dev(kp), dev(vp)
    k2, v2 = k1.clone(), v1.clone()
    args = (torch.from_numpy(bt).to(cuda), i32(starts), i32(lens), dh ** -0.5, 0.0)
    out, _, _ = pp_kernel.paged_prefill_chunk_kernel(dev(q), dev(kc), dev(vc),
                                                     k1, v1, *args)
    ref, _, _ = pp_ref.paged_prefill_chunk_ref(dev(q), dev(kc), dev(vc), k2, v2,
                                               *args)
    for b in range(4):
        torch.testing.assert_close(out[b, :, :lens[b] * g].float(),
                                   ref[b, :, :lens[b] * g].float(),
                                   rtol=0, atol=_atol(dtype))
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])


def test_paged_plan_caps_the_splits(cuda):
    """The launch plan is the .cu's (``paged_core.cuh::paged_plan``): 128-key
    splits for decode, 256 for a chunk, grown so there are at most 16, a
    workspace of 64 rows x (Dh + 2) floats per split and row group, none
    with one split, and merge CTAs of 8 query rows (16 at Dh 16); a launcher given a
    smaller workspace refuses."""
    from repro_torch.kernels import build
    assert pa_kernel.plan(8, 8, 2, 1, 128, 16, 64) == dict(
        split_keys=128, splits=8, row_groups=1,
        workspace_floats=8 * 8 * 8 * 64 * 130, ctas=512, merge_ctas=512)
    p = pa_kernel.plan(8, 8, 64, 32, 128, 16, 64)
    assert (p["split_keys"], p["splits"], p["ctas"], p["merge_ctas"]) == (256, 4, 256, 512)
    p = pa_kernel.plan(1, 1, 2, 1, 64, 16, 4096)
    assert p["split_keys"] % 64 == 0 and p["splits"] <= 16
    assert p["split_keys"] * p["splits"] >= 4096 * 16
    p = pa_kernel.plan(2, 2, 2, 1, 64, 16, 8)
    assert (p["splits"], p["workspace_floats"], p["merge_ctas"]) == (1, 0, 0)
    assert pa_kernel.plan(8, 16, 1, 1, 256, 16, 64)["workspace_floats"] == \
        8 * 16 * 8 * 64 * 258
    # head dims 32 and 16: 8 and 16 query rows a merge CTA (one whole warp)
    assert pa_kernel.plan(4, 4, 1, 1, 32, 16, 64)["merge_ctas"] == 4 * 4 * 8
    p = pa_kernel.plan(4, 4, 1, 1, 16, 16, 64)
    assert (p["merge_ctas"], p["workspace_floats"]) == (4 * 4 * 4, 4 * 4 * 8 * 64 * 18)
    with pytest.raises(ValueError, match="head_dim 96"):
        pa_kernel.plan(2, 2, 2, 1, 96, 16, 8)
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device=cuda)
    q, kv, pool = z(1, 1, 2, 64), z(1, 1, 64), z(2, 1, 16, 64)
    bt, idx = z(1, 64, dt=torch.int32), z(1, dt=torch.int32)
    ws, out = z(16), z(1, 1, 2, 64)
    err = build.library().paged_attention_decode_launch(
        q.data_ptr(), kv.data_ptr(), kv.data_ptr(), pool.data_ptr(),
        pool.data_ptr(), bt.data_ptr(), idx.data_ptr(), out.data_ptr(),
        ws.data_ptr(), ws.numel(), 1, 1, 2, 64, 16, 64, 0.125, 0.0, 0, 0,
        build.stream_ptr(cuda))
    assert err != 0


def _bitlinear_operands(dev, m, k, n, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    return x, w


# K = 520 is no multiple of 16 (and pads to 640), K = 130 no multiple of 8
# (the quantizing pass's scalar path); N = 6448 and 36 leave ragged column
# tiles, M = 1 and 300 ragged row tiles; (4096, 1536, 6448) and (4096, 3072,
# 1536) are mamba2-780m's in_proj and out_proj at 8 x 512 tokens
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(2048, 1024, 3072), (300, 520, 200),
                                   (1, 128, 36), (130, 3072, 1024),
                                   (1, 520, 6448), (4096, 1536, 6448),
                                   (4096, 3072, 1536), (5, 130, 40)])
def test_bitlinear_kernel_matches_plain(cuda, dtype, m, k, n):
    x, w = _bitlinear_operands(cuda, m, k, n, dtype, m + k + n)
    q, delta = Q.weight_quant_absmean(w)
    wq = q.to(torch.int8)
    gamma = x.float().abs().amax(-1, keepdim=True)
    before = bl_kernel.launches.count
    y = bl_kernel.bitlinear_kernel(x, wq, gamma, delta)
    assert bl_kernel.launches.count == before + 1
    torch.testing.assert_close(y, bl_ref.bitlinear_ref(x, wq, gamma, delta),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(2048, 1024, 3072), (300, 520, 200),
                                   (1, 520, 6448), (4096, 1536, 6448),
                                   (4096, 3072, 1536), (5, 130, 40)])
def test_bitlinear_forward_matches_plain(cuda, dtype, m, k, n):
    """The training op's forward (what ``bitlinear_matmul`` runs): y, the
    codes and γ it computes and the ternary codes it makes from the master
    weight, each bitwise its plain version; one launch count per call."""
    x, w = _bitlinear_operands(cuda, m, k, n, dtype, 3 * m + k + n)
    delta = Q.absmean_scale(w)
    codes_r, gamma_r = bl_ref.quantize_rows_ref(x)
    _, wq_r = bl_ref.weight_kmajor_ref(w, delta)
    before = bl_kernel.launches.count
    y, codes, gamma, wq = bl_kernel.bitlinear_forward(x, w, delta)
    assert bl_kernel.launches.count == before + 1
    assert torch.equal(codes, codes_r) and torch.equal(gamma, gamma_r)
    assert torch.equal(wq, wq_r)
    assert torch.equal(wq, Q.weight_quant_absmean(w)[0].to(torch.int8))
    torch.testing.assert_close(y, bl_ref.bitlinear_ref(x, wq_r, gamma_r, delta),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bitlinear_empty_batch(cuda, dtype):
    """M = 0 gives an empty y and gradients of the right shapes, launching
    nothing, as the plain version does."""
    x, w = _bitlinear_operands(cuda, 0, 520, 200, dtype, 4)
    before = bl_kernel.launches.count
    y, codes, gamma, wq = bl_kernel.bitlinear_forward(x, w, Q.absmean_scale(w))
    assert y.shape == (0, 200) and y.dtype == dtype
    assert codes.shape == (0, bl_ref.padded_k(520)) and gamma.shape == (0, 1)
    assert wq.shape == (520, 200)
    xr = x.reshape(0, 1, 520).clone().requires_grad_()
    wr = w.clone().requires_grad_()
    out = bl_ops.bitlinear_matmul(xr, wr)
    assert out.shape == (0, 1, 200)
    out.float().sum().backward()
    assert xr.grad.shape == xr.shape and torch.equal(wr.grad, torch.zeros_like(w))
    assert bl_kernel.launches.count == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(300, 520), (4, 1024), (3, 130)])
def test_bitlinear_quantize_rows_matches_plain(cuda, dtype, m, k):
    """The quantizing pass: γ bitwise the row absmax, the codes bitwise
    ``Q.round_clip``'s, the pad up to the K tile all zeros; with γ given, the
    same codes."""
    x, _ = _bitlinear_operands(cuda, m, k, 8, dtype, 7 * k + m)
    x[0, 3] = 0.0
    codes, gamma = bl_kernel.quantize_rows(x)
    want_gamma = torch.amax(x.float().abs(), dim=-1, keepdim=True)
    assert torch.equal(gamma, want_gamma)
    kp = bl_ref.padded_k(k)
    assert codes.shape == (m, kp) and codes.dtype == torch.int8
    want = Q.round_clip(x.float() * Q.div(127.0, want_gamma + 1e-5), -128.0, 127.0)
    assert torch.equal(codes[:, :k], want.to(torch.int8))
    assert bool((codes[:, k:] == 0).all())
    codes2, gamma2 = bl_kernel.quantize_rows(x, want_gamma)
    assert gamma2 is want_gamma and torch.equal(codes2, codes)
    assert torch.equal(codes, bl_ref.quantize_rows_ref(x)[0])


@pytest.mark.parametrize("k,n", [(1024, 3072), (520, 6448), (130, 40)])
def test_bitlinear_weight_kmajor_matches_plain(cuda, k, n):
    """The K-major weight: from the int8 codes it is ``wq.t()`` with a zero
    pad; from the master weight and Δ its codes are
    ``Q.weight_quant_absmean``'s."""
    _, w = _bitlinear_operands(cuda, 1, k, n, torch.float32, k + n)
    q, delta = Q.weight_quant_absmean(w)
    wq = q.to(torch.int8)
    wt, same = bl_kernel.weight_kmajor(wq)
    assert same is wq and wt.shape == (n, bl_ref.padded_k(k))
    assert torch.equal(wt[:, :k], wq.t()) and bool((wt[:, k:] == 0).all())
    wt2, wq2 = bl_kernel.weight_kmajor(w, Q.absmean_scale(w))
    assert torch.equal(wq2, wq) and torch.equal(wt2, wt)


def test_bitlinear_raises_on_what_it_does_not_take(cuda):
    x, w = _bitlinear_operands(cuda, 4, 64, 32, torch.float32, 1)
    q, delta = Q.weight_quant_absmean(w)
    wq = q.to(torch.int8)
    gamma = x.abs().amax(-1, keepdim=True)
    with pytest.raises(TypeError, match="not supported"):
        bl_kernel.bitlinear_kernel(x.half(), wq, gamma, delta)
    with pytest.raises(TypeError, match="int8"):
        bl_kernel.bitlinear_kernel(x, w, gamma, delta)
    with pytest.raises(ValueError, match="rows"):
        bl_kernel.bitlinear_kernel(x[:, :32].contiguous(), wq, gamma, delta)
    with pytest.raises(ValueError, match="contiguous"):
        bl_kernel.bitlinear_kernel(x.t().contiguous().t(), wq, gamma, delta)
    with pytest.raises(ValueError, match="non-empty"):
        bl_kernel.quantize_rows(x[:, :0].contiguous())
    with pytest.raises(TypeError, match="fp32 with a delta"):
        bl_kernel.weight_kmajor(w.double(), delta)
    codes, _ = bl_kernel.quantize_rows(x)
    wt, _ = bl_kernel.weight_kmajor(wq)
    # ref.K_TILE is the CPU's copy of the .cu's K tile
    assert bl_kernel.gemm_info()["k_tile"] == bl_ref.K_TILE == codes.shape[1]
    assert bl_kernel.padded_k(520) == bl_ref.padded_k(520)
    with pytest.raises(ValueError, match="K pitch"):
        bl_kernel.gemm(codes[:, :64].contiguous(), wt[:, :64].contiguous(), gamma,
                       delta, torch.float32)


def test_bitlinear_counts_one_launch_per_call(cuda):
    """One count per bitlinear call, though it runs three device kernels;
    the backward counts none."""
    x, w = _bitlinear_operands(cuda, 16, 256, 96, torch.bfloat16, 2)
    q, delta = Q.weight_quant_absmean(w)
    gamma = x.float().abs().amax(-1, keepdim=True)
    before = bl_kernel.launches.count
    bl_kernel.bitlinear_kernel(x, q.to(torch.int8), gamma, delta)
    assert bl_kernel.launches.count == before + 1
    xr = x.clone().requires_grad_()
    y = bl_ops.bitlinear_matmul(xr, w.clone().requires_grad_())
    assert bl_kernel.launches.count == before + 2
    y.float().sum().backward()
    assert bl_kernel.launches.count == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bitlinear_ste_gradients_from_saved_codes(cuda, dtype):
    """The backward from the forward's saved codes equals, bit for bit, the
    one that recomputes the codes from x and γ (the JAX ``_vjp_bwd``)."""
    x, w = _bitlinear_operands(cuda, 300, 520, 200, dtype, 9)
    r = torch.randn((300, 200), generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda).to(dtype)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    (bl_ops.bitlinear_matmul(xr, wr) * r).sum().backward()
    q, delta = Q.weight_quant_absmean(w)
    gamma = x.float().abs().amax(-1, keepdim=True)
    xq = Q.round_clip(x.float() * Q.div(127.0, gamma + 1e-5), -128.0, 127.0)
    x_deq = xq * Q.div(gamma, 127.0)
    g2d = r.float()
    dx = torch.matmul(g2d, (q.to(torch.int8).float() * delta).t())
    dw = torch.matmul(x_deq.t(), g2d)
    torch.testing.assert_close(xr.grad, dx.to(dtype), rtol=0, atol=0)
    torch.testing.assert_close(wr.grad, dw, rtol=0, atol=0)


def test_bitlinear_ste_gradients_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((4, 64, 256), generator=gen, device=cuda)
    w = torch.randn((256, 96), generator=gen, device=cuda) * 0.02
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    (bl_ops.bitlinear_matmul(x1, w1) ** 2).sum().backward()
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    ((Q.fake_quant_act(x2) @ Q.fake_quant_weight(w2)) ** 2).sum().backward()
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-4, atol=1e-5)


def _relation_states(dev, bh, l, d, recipe, seed):
    """Unit rows: ``independent`` s and t (the first cases' recipe), or
    ``clustered`` around 8 centres (s = centre + 0.6·noise, t = s +
    0.3·noise), whose relation rows are far from uniform."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    unit = lambda x: torch.nn.functional.normalize(x, dim=-1)
    if recipe == "independent":
        s = unit(r(bh, l, d))
        return s, unit(r(bh, l, d))
    centres = r(bh, 8, d)
    pick = torch.randint(0, 8, (l,), generator=gen, device=dev)
    s = unit(centres[:, pick] + 0.6 * r(bh, l, d))
    return s, unit(s + 0.3 * r(bh, l, d))


# (bh, l, d, recipe, temp): the distillation shape (qwen3-0.6b, 8 x 256,
# split_heads 4), ragged L, tiny D; clustered rows at temperatures below 1;
# the JAX kernel's design point L = 4096 (BH cut to 8); D = 5 (4-byte
# copies); shapes whose j walk the plan splits (asserted below)
RELATION_CASES = [
    pytest.param(32, 256, 512, "independent", 1.0, id="32-256-512"),
    pytest.param(3, 300, 40, "independent", 1.0, id="3-300-40"),
    pytest.param(2, 17, 8, "independent", 1.0, id="2-17-8"),
    pytest.param(32, 256, 512, "clustered", 1.0, id="clustered-32-256-512-temp1"),
    pytest.param(32, 256, 512, "clustered", 0.25, id="clustered-32-256-512-temp0.25"),
    pytest.param(32, 256, 512, "clustered", 0.1, id="clustered-32-256-512-temp0.1"),
    pytest.param(3, 300, 40, "clustered", 0.25, id="clustered-3-300-40-temp0.25"),
    pytest.param(8, 4096, 512, "clustered", 0.25, id="clustered-8-4096-512-temp0.25"),
    pytest.param(3, 300, 5, "clustered", 0.5, id="clustered-3-300-5-temp0.5"),
    pytest.param(2, 1000, 64, "clustered", 0.1, id="clustered-2-1000-64-temp0.1"),
    pytest.param(1, 200, 512, "independent", 1.0, id="1-200-512"),
]
SPLIT_CASES = {(2, 1000, 64), (1, 200, 512), (3, 300, 40), (3, 300, 5)}


@pytest.mark.parametrize("bh,l,d,recipe,temp", RELATION_CASES)
def test_relation_kd_kernel_matches_plain(cuda, bh, l, d, recipe, temp):
    s, t = _relation_states(cuda, bh, l, d, recipe, bh + l + d)
    torch.backends.cuda.matmul.allow_tf32 = False
    if (bh, l, d) in SPLIT_CASES:
        assert rk_kernel.plan(bh, l, d)["splits"] > 1
    before = rk_kernel.launches.count
    rows = rk_kernel.relation_kl_rows_kernel(s, t, temp)
    assert rk_kernel.launches.count == before + 1
    again = rk_kernel.relation_kl_rows_kernel(s, t, temp)
    assert rk_kernel.launches.count == before + 2
    assert torch.equal(rows, again)          # bitwise from run to run
    torch.testing.assert_close(rows, rk_ref.relation_kl_rows_ref(s, t, temp),
                               rtol=1e-5, atol=1e-6)
    if recipe != "independent":
        return
    s1 = s.clone().requires_grad_()
    rk_ops._RelationMeanKL.apply(s1, t, 1.0, 128).backward()
    s2 = s.clone().requires_grad_()
    rk_ref.relation_kl_rows_ref(s2, t, 1.0).mean().backward()
    torch.testing.assert_close(s1.grad, s2.grad, rtol=1e-4, atol=1e-9)


def test_relation_kd_workspace_serves_shapes_in_turn(cuda):
    """The per-stream partials and counters kept across calls: a shape with
    a large workspace, then smaller split shapes, then the first again,
    each within the gate (a counter left non-zero, or one read from the
    wrong place, would merge too early or never)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for bh, l, d in ((32, 300, 512), (3, 300, 40), (1, 200, 512), (32, 300, 512),
                     (2, 1000, 64), (3, 300, 40)):
        s, t = _relation_states(cuda, bh, l, d, "clustered", bh + l)
        torch.testing.assert_close(rk_kernel.relation_kl_rows_kernel(s, t, 0.5),
                                   rk_ref.relation_kl_rows_ref(s, t, 0.5),
                                   rtol=1e-5, atol=1e-6)


def test_relation_plan_splits_only_short_walks(cuda):
    """The .cu's plan: 64-row CTAs over 64-column j tiles, the j walk split
    until there are about two CTAs per SM (at most 16 splits, never more
    than the j tiles), the workspace sized for the splits' five values per
    row, one counter per row tile, none with one split."""
    p = rk_kernel.plan(32, 256, 512)
    assert (p["block_rows"], p["block_cols"], p["splits"], p["ctas"]) == (64, 64, 2, 256)
    assert (p["workspace_floats"], p["counters"]) == (32 * 4 * 2 * 5 * 64, 32 * 4)
    p = rk_kernel.plan(32, 4096, 512)
    assert (p["splits"], p["tiles_per_split"], p["ctas"]) == (1, 64, 2048)
    assert p["workspace_floats"] == p["counters"] == 0
    p = rk_kernel.plan(1, 4096, 8)
    assert p["splits"] * p["tiles_per_split"] >= 64 and p["splits"] <= 16
    assert rk_kernel.plan(2, 17, 8)["splits"] == 1
    with pytest.raises(ValueError, match="not taken"):
        rk_kernel.plan(70000, 16, 8)


def _ssd_problem(dev, b, s, h, p, n, seed):
    """As Mamba2Block feeds the core: A = -exp(A_log) in [-8, -1] per head,
    dt = softplus(N(-2, 1)), a = exp(dt·A); x, B, C standard normal.  A
    chunk of 256 then sums dt·|A| far past 88, where exp of an unmasked
    segment sum overflows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    A = -(1.0 + 7.0 * torch.rand((h,), generator=gen, device=dev))
    dt = torch.nn.functional.softplus(r(b, s, h) - 2.0)
    return r(b, s, h, p), torch.exp(dt * A), dt, r(b, s, n), r(b, s, n)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 512, 48, 64, 128, 256), (1, 100, 3, 16, 16, 64),
    (2, 96, 2, 64, 128, 32), (1, 37, 2, 64, 128, 256),
    (1, 320, 5, 64, 128, 128), (3, 130, 7, 16, 16, 64)])
def test_ssd_scan_kernel_matches_plain(cuda, b, s, h, p, n, chunk):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, a, dt, B, C = _ssd_problem(cuda, b, s, h, p, n, b + s + h)
    before = ssd_kernel.launches.count
    y, hT = ssd_kernel.ssd_scan_kernel(x, a, dt, B, C, chunk)
    assert ssd_kernel.launches.count == before + 1
    yc, hc = ssd_chunked(x, a, dt, B, C, chunk=chunk)
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, yc, **tol)
    torch.testing.assert_close(hT, hc.transpose(-1, -2).reshape(b * h, n, p), **tol)
    # the sequential oracle in the TPU kernel's [BH, ...] layout
    flat = lambda t: t.transpose(1, 2).reshape(b * h, s, *t.shape[3:])
    rep = lambda t: t.repeat_interleave(h, dim=0)
    yr, hr = ssd_ref.ssd_scan_ref(flat(x), flat(a), flat(dt), rep(B), rep(C))
    torch.testing.assert_close(flat(y), yr, **tol)
    torch.testing.assert_close(hT, hr, **tol)
    # the autograd.Function against autograd through ssd_chunked
    g = torch.randn_like(y)
    ins1 = [t.clone().requires_grad_() for t in (x, a, dt, B, C)]
    (ssd_ops.ssd_scan(*ins1, chunk=chunk) * g).sum().backward()
    ins2 = [t.clone().requires_grad_() for t in (x, a, dt, B, C)]
    (ssd_chunked(*ins2, chunk=chunk)[0] * g).sum().backward()
    for t1, t2 in zip(ins1, ins2):
        assert bool(torch.isfinite(t1.grad).all())
        torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("b,s,h,chunk", [(2, 512, 128, 256), (1, 37, 2, 256),
                                         (1, 320, 5, 128)])
def test_ssd_scan_kernel_at_jamba_heads_matches_chunked(cuda, b, s, h, chunk):
    """jamba-1.5-large-398b's (N, P) = (128, 128) instance (its 128 heads at
    batch 2, a short ragged chunk, several chunks) against ``ssd_chunked``,
    the plain version of the same chunked algorithm: y and the final state
    rtol 1e-4 atol 1e-4, the five gradients 1e-3.  The sequential oracle is
    left out here: at this size the chunked algorithm in fp32 (the in-chunk
    cumsum of the log-decays reaches ~-500), ``ssd_chunked`` and the kernel
    alike, sits near that tolerance of the exact result, where the
    sequential oracle sits far inside it (chip_smoke.py phase 2 prints all
    three against a float64 evaluation and holds the kernel to both)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    p = n = 128
    x, a, dt, B, C = _ssd_problem(cuda, b, s, h, p, n, b + s + h)
    before = ssd_kernel.launches.count
    y, hT = ssd_kernel.ssd_scan_kernel(x, a, dt, B, C, chunk)
    assert ssd_kernel.launches.count == before + 1
    yc, hc = ssd_chunked(x, a, dt, B, C, chunk=chunk)
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, yc, **tol)
    torch.testing.assert_close(hT, hc.transpose(-1, -2).reshape(b * h, n, p), **tol)
    g = torch.randn_like(y)
    ins1 = [t.clone().requires_grad_() for t in (x, a, dt, B, C)]
    (ssd_ops.ssd_scan(*ins1, chunk=chunk) * g).sum().backward()
    ins2 = [t.clone().requires_grad_() for t in (x, a, dt, B, C)]
    (ssd_chunked(*ins2, chunk=chunk)[0] * g).sum().backward()
    for t1, t2 in zip(ins1, ins2):
        assert bool(torch.isfinite(t1.grad).all())
        torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-3, atol=1e-3)


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
    wq = torch.zeros((128, 16), dtype=torch.int8, device=cuda)
    gamma = torch.ones((2, 1), device=cuda)
    with pytest.raises(ValueError, match="rows"):
        bl_kernel.bitlinear_kernel(x, wq[:64], gamma, delta)
    with pytest.raises(TypeError, match="int8"):
        bl_kernel.bitlinear_kernel(x, wq.float(), gamma, delta)
    with pytest.raises(TypeError, match="fp32"):
        rk_kernel.relation_kl_rows_kernel(x[None].double(), x[None].double())
    xs = torch.zeros((1, 16, 2, 32), device=cuda)
    ab = torch.zeros((1, 16, 2), device=cuda)
    bc = torch.zeros((1, 16, 128), device=cuda)
    with pytest.raises(ValueError, match="not built"):
        ssd_kernel.ssd_scan_kernel(xs, ab, ab, bc, bc)
    with pytest.raises(TypeError, match="fp32"):
        ssd_kernel.ssd_scan_kernel(xs.double(), ab, ab, bc, bc)
    # a chunk whose shared memory exceeds a CTA's: the launcher refuses it,
    # and the refusal is not left behind for the next launch
    s = 20000
    big = (torch.zeros((1, s, 1, 64), device=cuda), torch.ones((1, s, 1), device=cuda),
           torch.zeros((1, s, 1), device=cuda), torch.zeros((1, s, 128), device=cuda),
           torch.zeros((1, s, 128), device=cuda))
    with pytest.raises(ValueError, match="does not fit"):
        ssd_kernel.ssd_scan_kernel(*big, chunk=s)
    y, _ = ssd_kernel.ssd_scan_kernel(*big, chunk=256)
    torch.cuda.synchronize()
    assert bool((y == 0).all())


# -- the serving engine's device boundary ---------------------------------------

def _small_engine(cuda, **kw):
    """A two-layer packed qwen3 on the card (head_dim 64, which the paged
    kernels take), bf16 compute and cache, kernels on."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import Engine, ServeConfig
    cfg = get_config("qwen3-0.6b").reduced().replace(
        head_dim=64, compute_dtype="bfloat16").with_quant(
        Q.QuantConfig(mode="packed", use_kernel=True))
    model = build_model(cfg, gen=torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    return Engine(cfg, model, ServeConfig(
        max_batch=4, max_len=64, kv_block_size=16, prefill_chunk=8,
        cache_dtype="bfloat16", **kw))


def test_step_sync_waits_on_its_own_event(cuda):
    """Step N's tokens are read while step N+1, launched speculatively on
    N's device tokens, is still queued behind a ~0.1 s device spin."""
    from repro_torch.serving import SamplingParams
    eng = _small_engine(cuda)
    for i in range(4):
        eng.submit([3 + i, 5, 7, 11], SamplingParams(max_tokens=16,
                                                     ignore_eos=True))
    eng.step()
    eng.step()
    step_n = eng.launch_step(eng.plan_step())
    assert not step_n.plan.chunks and step_n.ready is not None
    torch.cuda._sleep(200_000_000)
    step_n1 = eng.launch_step(eng.plan_spec(step_n), feed=step_n)
    after = torch.cuda.Event()
    after.record()
    tok = eng.sync_tokens(step_n)
    assert not after.query(), "the sync of step N waited for step N+1"
    eng.commit_step(step_n, tok)
    eng.commit_step(step_n1)
    assert eng.stats().steps_committed == 4


@pytest.mark.parametrize("mode", ["bitflip", "garbage"])
def test_kv_block_digests_and_corruption_on_bf16_pools(cuda, mode):
    """``corrupt_kv_block`` changes the one block it is given, in place on
    the bf16 pools; ``_kv_block_digests`` sees exactly that block change,
    and with ``kv_checksums`` ``check_kv_integrity`` reports it."""
    from repro_torch.serving import SamplingParams
    eng = _small_engine(cuda, sanitize=True, kv_checksums=True)
    eng.submit(list(range(1, 30)), SamplingParams(max_tokens=4))
    eng.step()
    eng.step()
    assert eng._cache[0]["attn"]["k"].dtype == torch.bfloat16
    blocks = eng.shadow.checksummed()
    assert blocks
    all_blocks = range(eng.allocator.num_blocks)
    before = eng._kv_block_digests(all_blocks)
    assert eng._kv_block_digests(all_blocks) == before
    eng.corrupt_kv_block(blocks[0], seed=3, mode=mode)
    after = eng._kv_block_digests(all_blocks)
    assert [b for b in all_blocks if before[b] != after[b]] == [blocks[0]]
    assert eng.check_kv_integrity() == [blocks[0]]


def test_checkpoint_from_the_card_to_the_cpu_and_back(cuda, tmp_path):
    """A checkpoint saved from CUDA tensors (fp32, bf16, an int8 moment and
    an int32 step) loads onto the CPU and back onto the card, bitwise; and
    ``save_async`` copies a CUDA tensor in stream order, so an in-place
    update queued after it is not in the save."""
    from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                        save_checkpoint)
    from repro_torch.nn.module import flatten_with_paths
    from repro_torch.training.optimizer import Moment8
    g = torch.Generator(device=cuda).manual_seed(0)
    t = {"w": torch.randn(64, 48, device=cuda, generator=g),
         "h": torch.randn(7, device=cuda, generator=g).to(torch.bfloat16),
         "m": Moment8(torch.randint(-127, 128, (4, 300), device=cuda,
                                    generator=g).to(torch.int8),
                      torch.rand(4, 2, device=cuda, generator=g)),
         "step": torch.tensor(3, dtype=torch.int32, device=cuda)}
    save_checkpoint(tmp_path / "a", 1, t)
    host, _, _ = load_checkpoint(tmp_path / "a", t, device="cpu")
    for k, v in flatten_with_paths(t).items():
        got = flatten_with_paths(host)[k]
        assert got.device.type == "cpu" and torch.equal(got, v.cpu()), k
    save_checkpoint(tmp_path / "b", 2, host)
    back, _, _ = load_checkpoint(tmp_path / "b", t)
    for k, v in flatten_with_paths(t).items():
        got = flatten_with_paths(back)[k]
        assert got.device.type == "cuda" and torch.equal(got, v), k
    w = t["w"].clone()
    want = w.cpu()
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save_async(1, {"w": w})
    w.mul_(-1)
    mgr.wait()
    saved, _, _ = load_checkpoint(tmp_path / "c", {"w": w}, device="cpu")
    assert torch.equal(saved["w"], want)


def test_table4_schemes_on_the_card_equal_the_cpu(cuda):
    """Every mean that sets a scale sums in float64, so the card's codes
    equal the CPU's (chip_smoke.py phase 10d measures the same at the
    full-width shapes)."""
    from repro_torch.core import quant as Q
    w = torch.randn(256, 384, generator=torch.Generator().manual_seed(0)) * 0.02
    act = torch.rand(256, generator=torch.Generator().manual_seed(1)) + 0.1
    for scheme in ("absmean", "blockwise", "awq", "gptq"):
        for a in (None, act):
            cpu = Q.fake_quant_weight(w, scheme, a, block=48)
            card = Q.fake_quant_weight(w.to(cuda), scheme,
                                       None if a is None else a.to(cuda), block=48)
            assert torch.equal(card.cpu(), cpu), scheme
    wb = w.to(torch.bfloat16)
    assert torch.equal(Q.fake_quant_weight_lp(wb.to(cuda)).cpu(),
                       Q.fake_quant_weight_lp(wb))


def test_packed_moe_runs_the_qat_experts_on_the_card(cuda):
    """convert_to_packed stores the experts quantized, so a packed MoE
    block's output equals the QAT block's at full capacity, on the card
    as on the CPU (tests/test_torch_moe_configs.py)."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving.engine import convert_to_packed
    cfg = get_config("granite-moe-1b-a400m").reduced().with_quant(Q.QAT)
    qat = build_model(cfg, gen=torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    _, packed = convert_to_packed(cfg, qat)
    x = torch.randn((3, 5, cfg.d_model), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    with torch.no_grad():
        want, _ = qat.stack.layers[0].mlp(x, full_capacity=True)
        got, _ = packed.stack.layers[0].mlp(x, full_capacity=True)
    assert torch.equal(got, want)


# -- the cross-attention families (whisper-medium, llama-3.2-vision-11b) ----------

# the memory projections' row counts: 4 x 1500 audio frames and 4 x 1601
# image tokens, neither a multiple of the wgmma route's 64-row tiles or
# bitlinear's 128-row ones, at whisper's (1024, 1024) and llama-vision's
# k/v (4096, 1024)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(6000, 1024, 1024), (6404, 4096, 1024),
                                   (6404, 1024, 1024)])
def test_w2a8_and_bitlinear_at_memory_rows(cuda, dtype, m, k, n):
    x, wp, delta = _w2a8_operands(cuda, m, k, n, dtype)
    torch.testing.assert_close(w2_kernel.w2a8_kernel(x, wp, delta),
                               w2_ref.w2a8_ref(x, wp, delta), rtol=0, atol=0)
    x, w = _bitlinear_operands(cuda, m, k, n, dtype, m + k)
    q, delta = Q.weight_quant_absmean(w)
    wq = q.to(torch.int8)
    gamma = x.float().abs().amax(-1, keepdim=True)
    torch.testing.assert_close(bl_kernel.bitlinear_kernel(x, wq, gamma, delta),
                               bl_ref.bitlinear_ref(x, wq, gamma, delta),
                               rtol=0, atol=0)


@pytest.mark.parametrize("route", ["splitk", "wgmma"])
@pytest.mark.parametrize("m", [8, 256])
def test_w2a8_all_zero_rows_give_zeros(cuda, route, m):
    """The engine's cross layers feed ``wo`` all-zero rows (their cache is
    one zero position): γ is 0 there, and the kernel gives exact zeros, as
    its plain version does, never NaN."""
    x, wp, delta = _w2a8_operands(cuda, m, 1024, 1024, torch.bfloat16)
    x[::2] = 0
    y = w2_kernel.w2a8_kernel(x, wp, delta, route=route)
    assert torch.equal(y, w2_ref.w2a8_ref(x, wp, delta))
    assert bool(torch.isfinite(y).all()) and not y[::2].any()
    assert not w2_kernel.w2a8_kernel(torch.zeros_like(x), wp, delta, route=route).any()


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "whisper-medium"])
def test_cross_caches_and_decode_on_the_card_match_the_cpu(cuda, name):
    """The reduced packed model on the card (w2a8 kernel) and on the CPU
    (its plain version), same weights: the cross caches seeded from the
    same memory are bitwise equal; whisper's encoder output within 1e-4 (its
    attention sums in another order); decode logits over the seeded caches
    within 1e-4."""
    from repro_torch.models import EncDecLM, build_model, get_config
    from repro_torch.serving.engine import convert_to_packed
    base = get_config(name).reduced(layers=5 if "vision" in name else None)
    qcfg = base.with_quant(Q.QuantConfig(mode="qat", use_kernel=True))
    qat = build_model(qcfg, gen=torch.Generator().manual_seed(0), device="cpu")
    _, cpu = convert_to_packed(qcfg, qat)
    pcfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=True))
    card = build_model(pcfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    t = base.encoder_seq if base.n_encoder_layers else base.num_image_tokens
    mem = torch.randn((2, t, base.d_model), generator=torch.Generator().manual_seed(1))
    dec_cpu = cpu.decoder if isinstance(cpu, EncDecLM) else cpu
    dec_card = card.decoder if isinstance(card, EncDecLM) else card
    with torch.no_grad():
        if isinstance(cpu, EncDecLM):
            enc = cpu.encode(mem)
            torch.testing.assert_close(card.encode(mem.to(cuda)).cpu(), enc,
                                       rtol=1e-4, atol=1e-4)
            mem = enc
        c_cpu = dec_cpu.init_cache(2, 8, torch.float32, "cpu", memory=mem)
        before = w2_kernel.launches.count
        c_card = dec_card.init_cache(2, 8, torch.float32, cuda, memory=mem.to(cuda))
        assert w2_kernel.launches.count > before
        for a, b in zip(c_cpu, c_card):
            if "xattn" in a:
                for k in ("k", "v"):
                    assert torch.equal(b["xattn"][k].cpu(), a["xattn"][k]), k
        for step, tok in enumerate([3, 7, 1]):
            idx = torch.full((2,), step, dtype=torch.int32)
            la, _ = dec_cpu.decode_step(torch.tensor([tok, tok + 1]), c_cpu, idx)
            lb, _ = dec_card.decode_step(torch.tensor([tok, tok + 1], device=cuda),
                                         c_card, idx.to(cuda))
            torch.testing.assert_close(lb.cpu(), la, rtol=1e-4, atol=1e-4)

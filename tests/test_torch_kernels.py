"""The port's three serving kernels against the JAX package.

On the CPU each port wrapper takes its plain PyTorch version; those are held
to the JAX ``*_ref`` oracles and to the Pallas kernels run in interpret mode
(as tests/test_kernels.py runs them), over the cases of ``TestW2A8``,
``TestPagedAttentionDecode`` and ``TestPagedPrefillChunk``.  Tolerance: 1e-5
absolute (fp32; the two sides sum in different orders), and the pools after
the call equal bitwise on every block but the trash block 0, which idle and
pad rows may write in any order and nothing attends.

The CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.kernels.paged_attention import ops as jpa_ops, ref as jpa_ref
from repro.kernels.paged_prefill import ops as jpp_ops, ref as jpp_ref
from repro.kernels.w2a8_gemv import ops as jw_ops, ref as jw_ref
from repro_torch.kernels.paged_attention import kernel as pa_kernel, ops as pa_ops
from repro_torch.kernels.paged_prefill import ops as pp_ops, ref as pp_ref
from repro_torch.kernels.w2a8_gemv import kernel as w2_kernel, ops as w2_ops

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# -- w2a8 ---------------------------------------------------------------------

def _w2a8_case(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    q, delta = JQ.weight_quant_absmean(jnp.asarray(w))
    wp = np.asarray(JQ.pack_ternary(q.astype(jnp.int8)))
    return x, wp, np.asarray(delta)


class TestW2A8:
    @pytest.mark.parametrize("m,k,n", [(4, 128, 64), (16, 512, 256),
                                       (2, 256, 100), (1, 1024, 128)])
    def test_plain_matches_jax_ref_and_pallas(self, m, k, n):
        x, wp, delta = _w2a8_case(m, k, n)
        got = w2_ops.w2a8_matmul(_t(x), _t(wp), _t(delta)).numpy()
        want_ref = np.asarray(jw_ref.w2a8_ref(jnp.asarray(x), jnp.asarray(wp),
                                              jnp.asarray(delta)))
        want_pallas = np.asarray(jw_ops.w2a8_matmul(
            jnp.asarray(x), jnp.asarray(wp), jnp.asarray(delta), interpret=True))
        np.testing.assert_allclose(got, want_ref, rtol=1e-6, atol=ATOL)
        np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=ATOL)

    def test_lead_dims_and_bf16(self):
        x, wp, delta = _w2a8_case(6, 256, 48, seed=1)
        xb = _t(x).reshape(2, 3, 256).to(torch.bfloat16)
        got = w2_ops.w2a8_matmul(xb, _t(wp), _t(delta))
        assert got.shape == (2, 3, 48) and got.dtype == torch.bfloat16
        want = np.asarray(jw_ops.w2a8_matmul(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wp),
            jnp.asarray(delta), interpret=True).astype(jnp.float32))
        np.testing.assert_allclose(got.reshape(6, 48).float().numpy(), want,
                                   rtol=2 ** -8, atol=ATOL)

    def test_kernel_rejects_cpu_tensors(self):
        """No fallback: the kernel entry takes CUDA tensors or raises."""
        x, wp, delta = _w2a8_case(2, 128, 32)
        with pytest.raises(ValueError, match="CUDA"):
            w2_kernel.w2a8_kernel(_t(x), _t(wp), _t(delta))


# -- paged decode -------------------------------------------------------------

def _paged_case(B, Hq, Hkv, Dh, bs, L, idxs, softcap=0.0, trash_rows=(),
                seed=0):
    """Exclusively owned blocks per live row (the allocator's invariant);
    returns (port outs, JAX ref outs, Pallas outs, live rows)."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * L
    kp = rng.standard_normal((n_blocks, Hkv, bs, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, Hkv, bs, Dh)).astype(np.float32)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, Dh)).astype(np.float32)
    bt = np.zeros((B, L), np.int32)
    nxt = 1
    for b in range(B):
        if b in trash_rows:
            continue
        for j in range(min(idxs[b] // bs, L - 1) + 1):
            bt[b, j] = nxt
            nxt += 1
    idx = np.asarray(idxs, np.int32)
    kt, vt = _t(kp), _t(vp)
    out, kt2, vt2 = pa_ops.paged_attention_decode(
        _t(q), _t(kn), _t(vn), kt, vt, _t(bt), _t(idx), softcap=softcap)
    assert kt2 is kt and vt2 is vt          # written in place
    got = (out.numpy(), kt.numpy(), vt.numpy())
    g = Hq // Hkv
    ref = jpa_ref.paged_attention_decode_ref(
        jnp.asarray(q).reshape(B, Hkv, g, Dh), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(idx),
        1.0 / (Dh ** 0.5), softcap)
    ref = (np.asarray(ref[0]).reshape(B, Hq, Dh), np.asarray(ref[1]),
           np.asarray(ref[2]))
    pal = jpa_ops.paged_attention_decode(
        *map(jnp.asarray, (q, kn, vn, kp, vp, bt, idx)), softcap=softcap,
        interpret=True)
    pal = tuple(np.asarray(a) for a in pal)
    live = [b for b in range(B) if b not in trash_rows]
    return got, ref, pal, live


def _assert_paged(got, want, live):
    np.testing.assert_allclose(got[0][live], want[0][live], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[1][1:], want[1][1:])
    np.testing.assert_array_equal(got[2][1:], want[2][1:])


class TestPagedAttentionDecode:
    @pytest.mark.parametrize("args", [
        # GQA ratios over mixed depths
        (3, 4, 4, 32, 4, 4, [0, 5, 13]),
        (3, 4, 2, 32, 4, 4, [0, 5, 13]),
        (3, 4, 1, 32, 4, 4, [0, 5, 13]),
        # idx on / off block boundaries
        (2, 4, 2, 32, 4, 3, [4, 7]),
        (2, 4, 2, 32, 4, 3, [3, 8]),
        (2, 4, 2, 32, 4, 3, [0, 1]),
        # single-block tables
        (2, 2, 2, 32, 8, 1, [0, 6]),
        # head dim 16 (tests/test_system.py's heads: 4 of 4) and GQA at 16
        (3, 4, 4, 16, 4, 4, [0, 5, 13]),
        (3, 4, 2, 16, 4, 4, [4, 7, 13]),
        # the examples' serving model: 4 kv heads of 32, 16-token blocks
        (4, 4, 4, 32, 16, 6, [83, 40, 16, 0]),
    ])
    def test_plain_matches_jax(self, args):
        got, ref, pal, live = _paged_case(*args)
        _assert_paged(got, ref, live)
        _assert_paged(got, pal, live)

    def test_idle_trash_rows_are_finite(self):
        got, ref, pal, live = _paged_case(3, 4, 2, 32, 4, 3, [2, 11, 11],
                                          trash_rows=(2,))
        _assert_paged(got, ref, live)
        _assert_paged(got, pal, live)
        assert np.isfinite(got[0]).all()

    def test_logit_softcap(self):
        got, ref, pal, live = _paged_case(2, 4, 2, 32, 4, 3, [5, 9],
                                          softcap=30.0)
        _assert_paged(got, ref, live)
        _assert_paged(got, pal, live)

    def test_kernel_rejects_cpu_tensors(self):
        q = torch.zeros((1, 2, 1, 32))
        z = torch.zeros((1, 2, 32))
        pool = torch.zeros((2, 2, 4, 32))
        with pytest.raises(ValueError, match="CUDA"):
            pa_kernel.paged_attention_decode_kernel(
                q, z, z, pool, pool.clone(), torch.zeros((1, 1), dtype=torch.int32),
                torch.zeros((1,), dtype=torch.int32), 1.0)


# -- paged prefill ------------------------------------------------------------

def _prefill_case(B, Hq, Hkv, Dh, bs, L, T, starts, lens, softcap=0.0,
                  trash_rows=(), seed=0):
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * L
    kp = rng.standard_normal((n_blocks, Hkv, bs, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, Hkv, bs, Dh)).astype(np.float32)
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, T, Hkv, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, T, Hkv, Dh)).astype(np.float32)
    bt = np.zeros((B, L), np.int32)
    nxt = 1
    for b in range(B):
        if b in trash_rows:
            continue
        for j in range(min((starts[b] + lens[b] - 1) // bs, L - 1) + 1):
            bt[b, j] = nxt
            nxt += 1
    st, ln = np.asarray(starts, np.int32), np.asarray(lens, np.int32)
    kt, vt = _t(kp), _t(vp)
    out, _, _ = pp_ops.paged_prefill_chunk(_t(q), _t(kc), _t(vc), kt, vt,
                                           _t(bt), _t(st), _t(ln), softcap=softcap)
    got = (out.numpy(), kt.numpy(), vt.numpy())
    g = Hq // Hkv
    qg = (jnp.asarray(q).reshape(B, T, Hkv, g, Dh).transpose(0, 2, 1, 3, 4)
          .reshape(B, Hkv, T * g, Dh))
    ref = jpp_ref.paged_prefill_chunk_ref(
        qg, jnp.asarray(kc).transpose(0, 2, 1, 3),
        jnp.asarray(vc).transpose(0, 2, 1, 3), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(st), jnp.asarray(ln), 1.0 / (Dh ** 0.5),
        softcap)
    ref = (np.asarray(ref[0]).reshape(B, Hkv, T, g, Dh).transpose(0, 2, 1, 3, 4)
           .reshape(B, T, Hq, Dh), np.asarray(ref[1]), np.asarray(ref[2]))
    pal = jpp_ops.paged_prefill_chunk(
        *map(jnp.asarray, (q, kc, vc, kp, vp, bt, st, ln)), softcap=softcap,
        interpret=True)
    pal = tuple(np.asarray(a) for a in pal)
    live = [b for b in range(B) if b not in trash_rows]
    return got, ref, pal, live


def _assert_prefill(got, want, live, lens):
    for b in live:    # pad rows j >= lens are garbage both sides discard
        np.testing.assert_allclose(got[0][b, :lens[b]], want[0][b, :lens[b]],
                                   rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[1][1:], want[1][1:])
    np.testing.assert_array_equal(got[2][1:], want[2][1:])


class TestPagedPrefillChunk:
    @pytest.mark.parametrize("args", [
        # GQA ratios: cold start, mid-prompt and a decode row in one grid
        (3, 4, 4, 32, 4, 6, 8, [0, 9, 13], [8, 5, 1]),
        (3, 4, 2, 32, 4, 6, 8, [0, 9, 13], [8, 5, 1]),
        (3, 4, 1, 32, 4, 6, 8, [0, 9, 13], [8, 5, 1]),
        # chunks straddling block boundaries
        (2, 4, 2, 32, 4, 4, 4, [3, 4], [4, 4]),
        (2, 4, 2, 32, 4, 4, 4, [7, 2], [2, 3]),
        (2, 4, 2, 32, 4, 4, 4, [0, 5], [4, 2]),
        # pad rows (lens < T) never written
        (2, 4, 2, 32, 4, 4, 8, [0, 6], [3, 5]),
        # T = 1: decode rows through the chunk kernel
        (2, 4, 2, 32, 4, 3, 1, [5, 8], [1, 1]),
        # head dim 16, MHA and GQA
        (3, 4, 4, 16, 4, 6, 8, [0, 9, 13], [8, 5, 1]),
        (2, 4, 2, 16, 4, 4, 4, [7, 2], [2, 3]),
        # the examples' serving model: a chunk step of prefill and decode rows
        (4, 4, 4, 32, 16, 6, 32, [0, 32, 64, 17], [32, 32, 10, 1]),
    ])
    def test_plain_matches_jax(self, args):
        got, ref, pal, live = _prefill_case(*args)
        _assert_prefill(got, ref, live, args[-1])
        _assert_prefill(got, pal, live, args[-1])

    def test_idle_trash_rows_are_finite(self):
        got, ref, pal, live = _prefill_case(3, 4, 2, 32, 4, 4, 4, [2, 11, 11],
                                            [4, 1, 1], trash_rows=(2,))
        _assert_prefill(got, ref, live, [4, 1, 1])
        _assert_prefill(got, pal, live, [4, 1, 1])
        assert np.isfinite(got[0][live]).all()

    def test_logit_softcap(self):
        got, ref, pal, live = _prefill_case(2, 4, 2, 32, 4, 4, 4, [5, 0],
                                            [4, 4], softcap=30.0)
        _assert_prefill(got, ref, live, [4, 4])
        _assert_prefill(got, pal, live, [4, 4])


# -- the split KV walk of the paged kernels, modelled on the CPU ----------------

def _split_case(B, Hkv, g, Dh, bs, L, T, starts, lens, split_keys, softcap=0.0,
                trash_rows=(), shared=False, seed=0):
    """Kernel-layout operands (q [B, Hkv, T*g, Dh]) through the split model,
    the port's plain version and the JAX ref.  ``shared`` maps the first two
    rows' leading blocks to the same pool blocks (a trie-shared prefix that
    both rows only read)."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * L
    kp = rng.standard_normal((n_blocks, Hkv, bs, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, Hkv, bs, Dh)).astype(np.float32)
    q = rng.standard_normal((B, Hkv, T * g, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, T, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, T, Dh)).astype(np.float32)
    bt = np.zeros((B, L), np.int32)
    nxt = 1
    for b in range(B):
        if b in trash_rows:
            continue
        for j in range(min((starts[b] + lens[b] - 1) // bs, L - 1) + 1):
            bt[b, j] = nxt
            nxt += 1
    if shared:
        n_pre = min(starts[0], starts[1]) // bs
        bt[1, :n_pre] = bt[0, :n_pre]
    st, ln = np.asarray(starts, np.int32), np.asarray(lens, np.int32)
    scale = 1.0 / (Dh ** 0.5)
    ops = (_t(q), _t(kc), _t(vc))
    idx = (_t(bt), _t(st), _t(ln))
    k1, v1 = _t(kp), _t(vp)
    got = pp_ref.paged_prefill_chunk_split_ref(*ops, k1, v1, *idx, scale,
                                               softcap, split_keys)[0]
    k2, v2 = _t(kp), _t(vp)
    plain = pp_ref.paged_prefill_chunk_ref(*ops, k2, v2, *idx, scale, softcap)[0]
    jref = jpp_ref.paged_prefill_chunk_ref(
        *map(jnp.asarray, (q, kc, vc, kp, vp, bt, st, ln)), scale, softcap)
    live = [b for b in range(B) if b not in trash_rows]
    return (got.numpy(), k1.numpy(), v1.numpy()), \
        (plain.numpy(), k2.numpy(), v2.numpy()), \
        tuple(np.asarray(a) for a in jref), live


def _assert_split(got, want, live, lens, g):
    for b in live:    # only the valid query rows r < lens*g
        np.testing.assert_allclose(got[0][b, :, :lens[b] * g],
                                   want[0][b, :, :lens[b] * g],
                                   rtol=SPLIT_RTOL, atol=SPLIT_ATOL)
    np.testing.assert_array_equal(got[1][1:], want[1][1:])
    np.testing.assert_array_equal(got[2][1:], want[2][1:])


# fp32 on both sides, summed in another order (per split, then merged)
SPLIT_RTOL, SPLIT_ATOL = 1e-5, 1e-6


class TestPagedSplitWalkModel:
    """``paged_prefill_chunk_split_ref`` (the kernels' split walk and merge)
    against the plain version and JAX's ref, rtol 1e-5 with atol 1e-6."""

    @pytest.mark.parametrize("args", [
        # splits of 6 positions cut inside blocks of 4
        (3, 2, 2, 32, 4, 8, 4, [13, 22, 5], [4, 2, 1], 6),
        # splits of 8 on block boundaries; row 1 starts exactly on one
        (3, 2, 2, 32, 4, 8, 4, [13, 16, 5], [4, 3, 1], 8),
        # the chunk crosses a split boundary (start 14, 6 tokens, splits of 16)
        (2, 2, 2, 32, 4, 8, 8, [14, 3], [6, 8], 16),
        # GQA 4, a T = 8 launch of mostly decode rows
        (4, 1, 4, 32, 4, 8, 8, [20, 9, 21, 2], [1, 1, 8, 1], 8),
        # T = 1: decode rows
        (3, 2, 2, 32, 4, 8, 1, [0, 17, 31], [1, 1, 1], 8),
        # sixteen splits of 4 positions, the most the kernels take
        (2, 2, 2, 32, 4, 16, 4, [50, 59], [4, 2], 4),
    ])
    def test_split_model_matches_plain_and_jax(self, args):
        got, plain, jref, live = _split_case(*args)
        g, lens = args[2], args[-2]
        _assert_split(got, plain, live, lens, g)
        _assert_split(got, jref, live, lens, g)
        for b in live:    # pad rows are zeros
            assert not got[0][b, :, lens[b] * g:].any()

    def test_kernel_split_plan_three_splits(self):
        """The kernels' own plan for a chunk (``paged_core.cuh::paged_plan``,
        held on the card by ``tests/test_torch_cuda.py``): 256-key splits over
        a 768-position table (three splits), one start on a split boundary,
        one in the last."""
        sk = 256
        got, plain, jref, live = _split_case(
            3, 1, 2, 64, 16, 48, 32, [256, 700, 0], [32, 5, 32], sk, seed=1)
        _assert_split(got, plain, live, [32, 5, 32], 2)
        _assert_split(got, jref, live, [32, 5, 32], 2)

    def test_idle_rows_and_shared_prefix(self):
        """An idle row (table all trash) skips its resident walk; two rows
        read the same prefix blocks in one launch."""
        got, plain, jref, live = _split_case(
            3, 2, 2, 32, 4, 8, 4, [12, 16, 30], [4, 2, 1], 8, trash_rows=(2,),
            shared=True)
        _assert_split(got, plain, live, [4, 2, 1], 2)
        _assert_split(got, jref, live, [4, 2, 1], 2)
        assert np.isfinite(got[0]).all()

    def test_logit_softcap(self):
        got, plain, jref, live = _split_case(
            2, 2, 2, 32, 4, 8, 4, [13, 6], [4, 4], 8, softcap=30.0)
        _assert_split(got, plain, live, [4, 4], 2)
        _assert_split(got, jref, live, [4, 4], 2)

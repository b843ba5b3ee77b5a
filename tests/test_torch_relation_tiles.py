"""The relation-KL kernel's walk and products, modelled on the CPU.

The card's relation_kd (``csrc/relation_kd.cu``) takes both relation tiles
on the tensor cores (wgmma) in 3xTF32, updates the five running values per row
(m_t, z_t, m_s, z_s, u) at the end of each 64-column j tile, and, where
there are too few row tiles to fill the card, splits the j walk across CTAs
and merges the splits' values in split order.  Held here:

* the plain model of that walk and merge
  (``ref.py::relation_kl_rows_split_ref``) against the port's
  materialized ``relation_kl_rows_ref``, the JAX ``relation_kd/ref.py`` and
  the JAX Pallas kernel in interpret mode, at the card kernel's own gate
  (rtol 1e-5, atol 1e-6): one split, many splits, a split that ends inside a
  tile, ragged L, D not a multiple of 4, temperatures other than 1;
* the split pass that stages the operands for wgmma: each float split
  once into its TF32 parts, stored in the 128-byte swizzle of the int8
  wgmma kernels, each phase of its 16-byte accesses on 32 distinct banks;
  and the accumulator map the online update reads;
* on clustered rows at temperatures below 1 (where relation rows are far
  from uniform), the model with an emulated 3xTF32 product (the card's split
  by bit masks) within the gate where a single TF32 product is not: why the
  card pays three products;
* with a model of the tensor cores' summation (an mma's terms aligned to
  the largest and cut toward zero), one accumulator carried over all of D
  drifting past the gate where the kernel's chains of six products from
  zero, every 16 floats of D, added in fp32, hold it.

The CUDA kernel itself is held to ``relation_kl_rows_ref`` on the card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.relation_kd import ref as jref
from repro.kernels.relation_kd.kernel import relation_kl_rows_kernel as j_rows_kernel
from repro_torch.kernels.relation_kd import ref as R
from repro_torch.kernels.ssd_scan.ref import matmul_3xtf32, matmul_tf32, tf32_trunc

TOL = dict(rtol=1e-5, atol=1e-6)


def _norm(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _independent(bh, l, d, seed):
    """The card test's recipe: s and t independent unit rows."""
    rng = np.random.default_rng(seed)
    return (_norm(rng.standard_normal((bh, l, d))),
            _norm(rng.standard_normal((bh, l, d))))


def _clustered(bh, l, d, seed):
    """Rows drawn around 8 centres (s = centre + 0.6·noise, t = s +
    0.3·noise, both normalized): relations far from 0 and softmax rows far
    from uniform, which is where a TF32 product's rounding shows."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((bh, 8, d))
    s = _norm(centres[:, rng.integers(0, 8, l)] + 0.6 * rng.standard_normal((bh, l, d)))
    return s, _norm(s + 0.3 * rng.standard_normal((bh, l, d)))


def _within(got, want):
    return bool(((got - want).abs() <= TOL["atol"] + TOL["rtol"] * want.abs()).all())


# (bh, l, d, temp, split_cols, block): one split; many splits; splits that end
# inside a tile; ragged L; D not a multiple of 4; temp != 1
WALKS = [
    (2, 64, 32, 1.0, 0, 64),
    (2, 96, 16, 1.0, 16, 16),
    (3, 70, 12, 0.7, 24, 16),
    (2, 100, 20, 1.0, 40, 32),
    (2, 37, 5, 0.5, 10, 8),
    (1, 130, 6, 0.25, 64, 64),
]


@pytest.mark.parametrize("bh,l,d,temp,split_cols,block", WALKS)
def test_split_walk_matches_plain_and_jax(bh, l, d, temp, split_cols, block):
    s, t = _clustered(bh, l, d, seed=bh * l + d)
    got = R.relation_kl_rows_split_ref(torch.from_numpy(s), torch.from_numpy(t),
                                       temp, split_cols, block)
    want = R.relation_kl_rows_ref(torch.from_numpy(s), torch.from_numpy(t), temp)
    torch.testing.assert_close(got, want, **TOL)
    jwant = np.asarray(jref.relation_kl_rows_ref(jnp.asarray(s), jnp.asarray(t), temp))
    np.testing.assert_allclose(got.numpy(), jwant, **TOL)
    pallas = np.asarray(j_rows_kernel(jnp.asarray(s), jnp.asarray(t), temp=temp,
                                      bl=32, bj=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("split_cols", [0, 64, 30, 1])
def test_split_walk_on_independent_rows(split_cols):
    """The recipe of the card test's first cases (near-uniform rows), and a
    split of one column, where every split's row holds one relation."""
    s, t = map(torch.from_numpy, _independent(2, 128, 24, seed=split_cols))
    got = R.relation_kl_rows_split_ref(s, t, 1.0, split_cols)
    torch.testing.assert_close(got, R.relation_kl_rows_ref(s, t, 1.0), **TOL)


def test_identical_states_give_zero_rows():
    s, _ = map(torch.from_numpy, _clustered(2, 90, 16, seed=3))
    got = R.relation_kl_rows_split_ref(s, s, 0.5, 32)
    torch.testing.assert_close(got, torch.zeros_like(got), rtol=0, atol=1e-6)


# -- the kernel's split tiles and accumulator map ------------------------------------

def _cut(v):
    """fp32 to its top 10 mantissa bits (the card's TF32 split)."""
    return (v.view(np.int32) & ~0x1FFF).view(np.float32)


DK, BI, ROWS = 32, 64, 128   # floats of D a stage row holds; rows i; i + j rows


def _split_pass(raw):
    """The kernel's split pass (``relation_kd.cu::split_stage``) on the CPU:
    a raw stage [2 tensors, 128 rows (64 i, then 64 j), 32 floats] -> the
    byte images of its eight K-major tiles [t, s][A_hi, A_lo, B_hi, B_lo],
    each [64 rows, 128 bytes], thread c taking 16-byte chunk k = c % 8 of row
    r = (c / 8) % 128 of tensor c / 1024 and storing its parts at chunk
    k ^ (r % 64 & 7) of the row."""
    tiles = np.zeros((8, 64 * 128), np.uint8)
    for c in range(2 * ROWS * (DK // 4)):
        x, r, k = c // (ROWS * 8), (c // 8) % ROWS, c % 8
        v = raw[x, r, 4 * k:4 * k + 4].astype(np.float32)
        hi = _cut(v)
        lo = _cut((v - hi).astype(np.float32))
        rr = r % 64
        at = rr * 128 + 16 * (k ^ (rr & 7))
        tiles[x * 4 + 2 * (r // 64), at:at + 16] = hi.view(np.uint8)
        tiles[x * 4 + 2 * (r // 64) + 1, at:at + 16] = lo.view(np.uint8)
    return tiles


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tiles_are_the_swizzled_parts(seed):
    """Each tile, unswizzled by the 128-byte swizzle wgmma reads
    (``w2a8_gemv/ref.py::swizzle128``, the convention of the int8 wgmma
    kernels), holds its rows' TF32 parts in order of D, and hi + lo is the
    float to within 2^-20 of it."""
    from repro_torch.kernels.w2a8_gemv.ref import swizzle128
    raw = np.random.default_rng(seed).standard_normal((2, ROWS, DK)).astype(np.float32)
    tiles = _split_pass(raw)
    for x in range(2):
        for ab in range(2):
            rows = raw[x, 64 * ab:64 * ab + 64]
            parts = []
            for part in range(2):
                img = torch.from_numpy(tiles[4 * x + 2 * ab + part].reshape(64, 128))
                parts.append(swizzle128(img).numpy().reshape(-1).view(np.float32)
                             .reshape(64, DK))
            np.testing.assert_array_equal(parts[0], _cut(rows))
            np.testing.assert_array_equal(parts[1], _cut((rows - parts[0]).astype(np.float32)))
            err = np.abs(parts[0].astype(np.float64) + parts[1] - rows)
            assert bool((err <= 2.0 ** -20 * np.abs(rows)).all())


@pytest.mark.parametrize("first", [0, 8, 504, 1016, 1024, 2040])
def test_split_pass_phases_hit_32_banks(first):
    """A 16-byte access is served 8 lanes at a time; lanes c..c+7 (c a
    multiple of 8) take the 8 chunks of one raw row (read: 128 contiguous
    bytes) and store them at 8 distinct chunks of one tile row."""
    rows = {(c // 8) % ROWS for c in range(first, first + 8)}
    assert len(rows) == 1
    rr = rows.pop() % 64
    banks = sorted((4 * (k ^ (rr & 7)) + w) % 32 for k in range(8) for w in range(4))
    assert banks == list(range(32))


def test_accumulator_map_covers_the_tile_once():
    """The online update reads sum[4n + 2h + c] of lane (g, q) of warp w as
    D[16w + g + 8h][8n + 2q + c] (wgmma's m64nNk8 fp32 accumulator layout):
    every entry of the 64 x 64 relation tile exactly once, a row's 64
    columns in the four lanes of one quad."""
    seen = {}
    for w in range(4):
        for lane in range(32):
            g, q = lane // 4, lane % 4
            for i in range(32):
                n, h, c = i // 4, (i // 2) % 2, i % 2
                key = (16 * w + g + 8 * h, 8 * n + 2 * q + c)
                assert key not in seen
                seen[key] = (w, g)
    assert len(seen) == 64 * 64
    for row in range(64):
        assert len({seen[(row, col)] for col in range(64)}) == 1


# -- why three TF32 products ---------------------------------------------------------

@pytest.mark.parametrize("temp", [1.0, 0.25, 0.1])
def test_3xtf32_holds_the_gate_where_tf32_does_not(temp):
    """Clustered rows at the distillation width (D = 512), cut in BH and L:
    the walk with the card's 3xTF32 product within rtol 1e-5 / atol 1e-6 of
    the materialized fp32 rows, with one TF32 product outside it."""
    s, t = map(torch.from_numpy, _clustered(2, 128, 512, seed=7))
    want = R.relation_kl_rows_ref(s, t, temp)
    three = R.relation_kl_rows_split_ref(
        s, t, temp, 64, mm=lambda a, b: matmul_3xtf32(a, b, tf32_trunc))
    assert _within(three, want)
    one = R.relation_kl_rows_split_ref(s, t, temp, 64, mm=matmul_tf32)
    assert not _within(one, want)


def _toward_zero(x):
    """float64 to fp32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma(acc, a, b):
    """acc + a·bᵀ over the 8 columns of one k step, as the model takes an
    mma's sum: the products exact, every term aligned to the largest and cut
    toward zero to fp32's 24 bits below it, the sum cut to fp32."""
    terms = np.concatenate([acc.astype(np.float64)[..., None],
                            np.einsum("bld,bmd->blmd", a, b)], axis=-1)
    _, e = np.frexp(np.abs(terms).max(-1))
    q = np.ldexp(1.0, e - 24)[..., None]
    return _toward_zero((np.trunc(terms / q) * q).sum(-1))


def _relations_on_tensor_cores(x, one_chain):
    """x·xᵀ [BH, L, L] from modelled 3xTF32 tensor-core products, k steps
    of 8 floats.  ``one_chain``: one accumulator over all of D, each k
    step's lo·hi, hi·lo, hi·hi in turn; else the kernel's: per 16 floats,
    from zero, both k steps' lo·hi, then hi·lo, then hi·hi, added into an
    fp32 sum rounded to nearest."""
    hi = _cut(x)
    lo = _cut((x - hi).astype(np.float32))
    hi, lo = hi.astype(np.float64), lo.astype(np.float64)
    shape = x.shape[:2] + (x.shape[1],)
    total, acc = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for h in range(x.shape[2] // 16):
        ks = [list(range(16 * h + 8 * half, 16 * h + 8 * half + 8)) for half in range(2)]
        if one_chain:
            for k in ks:
                for a, b in ((lo, hi), (hi, lo), (hi, hi)):
                    acc = _mma(acc, a[..., k], b[..., k])
            continue
        acc[:] = 0
        for a, b in ((lo, hi), (hi, lo), (hi, hi)):
            for k in ks:
                acc = _mma(acc, a[..., k], b[..., k])
        total = total + acc
    return total + acc if one_chain else total


@pytest.mark.parametrize("temp", [0.25, 0.1])
def test_fresh_accumulators_hold_the_gate_where_one_chain_drifts(temp):
    """Clustered rows at D = 512, cut to BH = 1, L = 64."""
    s, t = map(torch.from_numpy, _clustered(1, 64, 512, seed=1))
    want = R.relation_kl_rows_ref(s, t, temp)
    for one_chain, holds in ((False, True), (True, False)):
        mm = lambda a, b: torch.from_numpy(
            _relations_on_tensor_cores(a.numpy(), one_chain))
        got = R.relation_kl_rows_split_ref(s, t, temp, mm=mm)
        assert _within(got, want) == holds

"""Port vs JAX: ``launch/roofline.py`` and ``launch/memest.py``.

The H100 constants give the roofline's terms and bottleneck; ``model_flops``,
``mfu`` and both paged rooflines equal JAX's on a grid of arguments (the
formulas are carried over verbatim); ``kernel_work`` gives the bound column
of PERF.md's kernel table at phase 2's shapes of ``chip_smoke.py`` (the
bounds it printed before the move: 0.00025 ms for w2a8 at M=8, 0.00086 at
M=256, 0.00651 for bitlinear, 0.0260 for relation_kd at L=256, 0.0595 for
ssd_scan, 0.00336 for paged decode, 0.00366 for paged prefill); ``memest``
equals JAX's ``estimate`` on every shared term for the ten assigned configs
x four shapes x both production meshes, and each term the port adds is
checked by hand.
"""
import itertools

import pytest
import torch

import repro.configs as jconfigs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import memest as jmemest
from repro.launch import roofline as jroof
from repro.models import get_config as jget
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import memest, roofline as R
from repro_torch.models import get_config

META = torch.device("meta")


class TestRoofline:
    def test_terms_and_bottleneck(self):
        r = R.Roofline(flops=989e12 * 256, bytes_accessed=3.35e12,
                       wire_bytes=0.0, n_devices=256)
        assert r.t_compute == pytest.approx(1.0)
        assert r.bottleneck == "compute"
        r2 = R.Roofline(flops=1.0, bytes_accessed=3.35e12 * 256 * 2,
                        wire_bytes=0.0, n_devices=256)
        assert r2.t_memory == pytest.approx(2.0)
        assert r2.bottleneck == "memory"
        # a group of 8 ranks stays on NVLink, a wider one crosses hosts
        r3 = R.Roofline(flops=1.0, bytes_accessed=1.0, wire_bytes=450e9 * 3,
                        n_devices=8, group_size=8)
        assert r3.bottleneck == "collective"
        assert r3.step_time == pytest.approx(3.0)
        r4 = R.Roofline(flops=1.0, bytes_accessed=1.0, wire_bytes=50e9 * 3,
                        n_devices=256, group_size=16)
        assert r4.t_collective == pytest.approx(3.0)
        assert R.link_bw(8) == R.NVLINK_BW and R.link_bw(9) == R.IB_BW

    def test_constants_are_the_data_sheets(self):
        assert (R.PEAK_FLOPS_BF16, R.PEAK_FLOPS_INT8, R.PEAK_FLOPS_TF32,
                R.PEAK_FLOPS_FP32) == (989e12, 1979e12, 494.7e12, 67e12)
        assert (R.HBM_BW, R.HBM_PER_CHIP, R.NVLINK_BW, R.IB_BW) == \
            (3.35e12, 80e9, 450e9, 50e9)

    @pytest.mark.parametrize("kind", ["train", "distill", "prefill", "decode"])
    def test_model_flops_and_mfu_equal_jax(self, kind):
        for p, a, tok in itertools.product((1e9, 3e9), (5e8, 1e9), (128, 1 << 20)):
            assert R.model_flops(p, a, tok, kind) == jroof.model_flops(p, a, tok, kind)
            roof = R.Roofline(1e15, 1e12, 1e9, 256)
            jr = jroof.Roofline(1e15, 1e12, 1e9, 256)
            mf = R.model_flops(p, a, tok, kind)
            # the same formula over each package's peaks and step time
            assert R.mfu(mf, roof) == pytest.approx(
                mf / (roof.step_time * 256 * 989e12), rel=1e-12)
            assert jroof.mfu(mf, jr) == pytest.approx(
                mf / (jr.step_time * 256 * 197e12), rel=1e-12)

    @pytest.mark.parametrize("fused", [True, False])
    def test_paged_rooflines_equal_jax(self, fused):
        grid = itertools.product((1, 8), (0, 17, 4000), (4, 64), (16,), (1, 28),
                                 ((16, 8), (32, 8), (8, 8)), (64, 128, 256), (2, 4))
        for b, res, width, bs, layers, (hq, hkv), dh, kvb in grid:
            kw = dict(batch=b, resident_tokens=res, table_width=width,
                      block_size=bs, n_layers=layers, n_q_heads=hq,
                      n_kv_heads=hkv, head_dim=dh, kv_bytes=kvb, fused=fused)
            a = R.paged_decode_attention_roofline(**kw)
            j = jroof.paged_decode_attention_roofline(**kw)
            assert (a.flops, a.bytes_accessed) == (j.flops, j.bytes_accessed)
            for chunk in (1, 32):
                a = R.paged_prefill_attention_roofline(chunk=chunk, **kw)
                j = jroof.paged_prefill_attention_roofline(chunk=chunk, **kw)
                assert (a.flops, a.bytes_accessed) == (j.flops, j.bytes_accessed)


def _paged_tables(depths, bs, t):
    """chip_smoke.py::_paged_problem's block tables and positions: rows of
    depth None idle (table all trash, parked)."""
    L = max(-(-(d + t) // bs) for d in depths if d is not None)
    bt = torch.zeros((len(depths), L), dtype=torch.int32)
    nxt, pos = 1, []
    for r, d in enumerate(depths):
        if d is None:
            pos.append(L * bs - 1)
            continue
        for j in range(min((d + t - 1) // bs, L - 1) + 1):
            bt[r, j] = nxt
            nxt += 1
        pos.append(d)
    return bt, torch.tensor(pos, dtype=torch.int32), L


def _e(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


class TestKernelWork:
    """PERF.md's bound column, as ``chip_smoke.py`` phase 2 prints it."""

    def _ms(self, name, *args):
        ms, by = R.bound_ms(R.kernel_work(name, *args))
        return round(ms, 5), by

    def test_w2a8(self):
        for m, want in ((8, (0.00025, "bytes")), (256, (0.00086, "bytes"))):
            x, wp = _e((m, 1024)), _e((256, 3072), torch.uint8)
            assert self._ms("w2a8_gemv", x, wp, _e((), torch.float32)) == want
        # gemma-7b's gate/up at M=256: operations
        x, wp = _e((256, 3072)), _e((768, 24576), torch.uint8)
        assert self._ms("w2a8_gemv", x, wp, _e((), torch.float32)) == \
            (0.01953, "operations")

    def test_bitlinear(self):
        m, k, n = 2048, 1024, 3072
        args = (_e((m, k)), _e((k, n), torch.int8), _e((m, 1), torch.float32),
                _e((), torch.float32))
        assert self._ms("bitlinear", *args) == (0.00651, "operations")
        args = (_e((6000, 1024)), _e((1024, 1024), torch.int8),
                _e((6000, 1), torch.float32), _e((), torch.float32))
        assert round(R.bound_ms(R.kernel_work("bitlinear", *args))[0], 4) == 0.0077
        # the training op's form (the master weight in) does the same operations
        ops, nbytes, kind = R.kernel_work("bitlinear", _e((m, k)),
                                          _e((k, n), torch.float32),
                                          _e((), torch.float32))
        assert (ops, kind) == (2.0 * m * k * n, "int8")
        assert nbytes == m * k * 2 + k * n * 4 + 4 + m * n * 2 + m * k + 4 * m + k * n

    def test_relation_kd(self):
        s = _e((32, 256, 512), torch.float32)
        ms, by = R.bound_ms(R.kernel_work("relation_kd", s, s, 1.0))
        assert (round(ms, 4), by) == (0.0260, "operations")
        s = _e((32, 4096, 512), torch.float32)
        assert round(R.bound_ms(R.kernel_work("relation_kd", s, s, 1.0))[0], 3) == 6.668

    def test_ssd_scan(self):
        b, s, h, p, n = 8, 512, 48, 64, 128
        args = (_e((b, s, h, p), torch.float32), _e((b, s, h), torch.float32),
                _e((b, s, h), torch.float32), _e((b, s, n), torch.float32),
                _e((b, s, n), torch.float32), 256)
        ms, by = R.bound_ms(R.kernel_work("ssd_scan", *args))
        assert (round(ms, 4), by) == (0.0595, "operations")
        args = (_e((2, 512, 128, 128), torch.float32), _e((2, 512, 128), torch.float32),
                _e((2, 512, 128), torch.float32), _e((2, 512, 128), torch.float32),
                _e((2, 512, 128), torch.float32), 256)
        assert round(R.bound_ms(R.kernel_work("ssd_scan", *args))[0], 4) == 0.0784

    def test_paged_decode(self):
        depths = [1023, 512, 17, 0, 300, 800, 64, None]
        bt, idx, L = _paged_tables(depths, 16, 1)
        b, hkv, g, dh = 8, 8, 2, 128
        pool = _e((1 + b * L, hkv, 16, dh))
        args = (_e((b, hkv, g, dh)), _e((b, hkv, dh)), _e((b, hkv, dh)), pool,
                pool, bt, idx, dh ** -0.5, 0.0)
        assert self._ms("paged_attention_decode", *args) == (0.00336, "bytes")
        work = R.kernel_work("paged_attention_decode", *args)
        # the fused roofline over the live rows, less the whole-block rewrite
        live = [d for d in depths if d is not None]
        roof = R.paged_decode_attention_roofline(
            batch=7, resident_tokens=sum(live) + 7, table_width=L, block_size=16,
            n_layers=1, n_q_heads=16, n_kv_heads=8, head_dim=128)
        assert work.ops == roof.flops
        assert work.nbytes == roof.bytes_accessed - 7 * 16 * 2 * 8 * 128 * 2
        assert work.note == ""
        # on meta: every row live at the table's full width, and it says so
        meta = R.kernel_work("paged_attention_decode", *args[:5], bt.to(META),
                             idx.to(META))
        assert meta.nbytes > work.nbytes and "meta" in meta.note

    def test_paged_prefill(self):
        starts = [0, 256, 700, 31, 990, 16, 500, None]
        lens = [32, 32, 20, 1, 1, 7, 32, 1]
        bt, start, L = _paged_tables(starts, 16, 32)
        b, hkv, g, dh, t = 8, 8, 2, 128, 32
        pool = _e((1 + b * L, hkv, 16, dh))
        args = (_e((b, hkv, t * g, dh)), _e((b, hkv, t, dh)), _e((b, hkv, t, dh)),
                pool, pool, bt, start, torch.tensor(lens, dtype=torch.int32),
                dh ** -0.5, 0.0)
        assert self._ms("paged_prefill_chunk", *args) == (0.00366, "bytes")
        ops = R.kernel_work("paged_prefill_chunk", *args).ops
        keys = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts, lens)
                   if s is not None)
        assert ops == 4.0 * g * dh * hkv * keys

    def test_unknown_kernel(self):
        with pytest.raises(KeyError, match="no work model"):
            R.kernel_work("nope")


JAX_TERMS = ("params", "teacher_params", "grads", "opt_states", "residual_stack",
             "logits", "layer_transient", "caches")


@pytest.mark.parametrize("name", [c.name for c in jconfigs.ASSIGNED])
def test_memest_equals_jax_on_every_shared_term(name):
    from repro.launch.specs import student_config as jstudent
    from repro_torch.launch.specs import student_config
    jc, tc = jstudent(jget(name)), student_config(get_config(name))
    p = tc.param_count()
    assert p == jc.param_count()
    checked = 0
    for shape, (n_dev, tp) in itertools.product(SHAPES, ((256, 16), (512, 16))):
        kinds = [SHAPES[shape].kind] + (["distill"] if shape == "train_4k" else [])
        for kind in kinds:
            for opt8 in (False, True):
                teacher = kind == "distill"
                j = jmemest.estimate(jc, JSHAPES[shape], n_dev, tp, opt8, kind, teacher)
                for route in ("split", "gathered"):
                    t = memest.estimate(tc, SHAPES[shape], n_dev, tp, opt8, kind,
                                        teacher, route=route)
                    for k in JAX_TERMS:
                        assert (k in t) == (k in j), (name, shape, kind, k)
                        if k in j:
                            assert t[k] == j[k], (name, shape, kind, k)
                            checked += 1
                    # the port's own terms, by hand: on the split route JAX's
                    # params and caches (the cache placed by the plan) with
                    # the weights at use; on the gathered route the whole
                    # model and every head's cache
                    bp = 2 if tc.param_dtype == "bfloat16" else 4
                    assert t["gathered_params"] == p * bp
                    train = kind in ("train", "distill")
                    held = "at_use_params" if route == "split" else "gathered_params"
                    if train:
                        per = 2.0 + 8.0 / 256 if opt8 else 8.0
                        assert t["moments"] == p * per / n_dev
                        want = sum(t[k] for k in ("params", held, "grads",
                                                  "moments", "residual_stack",
                                                  "logits", "layer_transient")) + \
                            t.get("teacher_params", 0.0)
                    else:
                        assert "moments" not in t
                        want = t[held] + t["layer_transient"]
                        if route == "split":
                            want += t["params"]
                    if kind == "decode":
                        assert t["caches_whole"] == t["caches"] * tp
                        want += t["caches" if route == "split" else "caches_whole"]
                    assert t["total"] == pytest.approx(want, rel=1e-12)
                    assert t["fits_hbm"] == (t["total"] < 80e9)
    assert checked > 0

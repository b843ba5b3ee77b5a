"""Port vs JAX: ``launch/op_analysis.py``, the counterpart of
``repro/launch/hlo_analysis.py``.

JAX's three analyzer cases on the port (an exact matmul, a loop of 10, the
bytes of one matmul bounded); reduced qwen3-0.6b's FP forward counted by
the port and by JAX's ``hlo_analysis.analyze`` over the compiled forward,
equal within 1e-6 relative (XLA rewrote no dot of this forward into
another op, so nothing is subtracted); a QAT forward with the kernels on:
the CPU route and the meta route give the same ``OpCost``, bitlinear
counted by ``roofline.kernel_work`` at its boundary and none of its plain
version's ops; the byte rules (views free, in-place once, indexed reads by
their rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro_torch.bridge import jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.kernels import boundary
from repro_torch.launch.op_analysis import count
from repro_torch.launch.roofline import kernel_work
from repro_torch.models import build_model, get_config

META = torch.device("meta")


class TestAnalyzer:
    def test_plain_matmul_flops_exact(self):
        m, k, n = 128, 256, 64
        c = count(lambda a, b: a @ b, torch.randn(m, k), torch.randn(k, n))
        assert c.flops == pytest.approx(2 * m * k * n, rel=1e-6)

    def test_loop_counts_each_iteration(self):
        def f(x, ws):
            for w in ws:
                x = torch.tanh(x @ w)
            return x
        c = count(f, torch.randn(64, 64), torch.randn(10, 64, 64))
        assert c.flops == pytest.approx(10 * 2 * 64 ** 3, rel=0.05)
        assert c.op_calls["aten.mm"] == 10

    def test_bytes_positive_and_bounded(self):
        a = torch.randn(64, 64)
        c = count(lambda a, b: a @ b, a, a)
        # the matmul reads two 16 KB operands and writes one
        assert 3 * 64 * 64 * 4 <= c.hbm_bytes <= 10 * 64 * 64 * 4

    def test_byte_rules(self):
        x = torch.randn(64, 64)
        assert count(lambda t: t.view(-1), x).hbm_bytes == 0
        assert count(lambda t: t.add_(1.0), x).hbm_bytes == 64 * 64 * 4
        assert count(lambda t: t + 1.0, x).hbm_bytes == 2 * 64 * 64 * 4
        table, idx = torch.randn(1000, 32), torch.tensor([1, 5, 7])
        c = count(torch.nn.functional.embedding, idx, table)
        assert c.hbm_bytes == 2 * 3 * 32 * 4 + 3 * 8      # rows, not the table

    def test_peak_live_bytes(self):
        x = torch.randn(256, 256)                          # 256 KB, resident

        def f(t):
            a = t * 2.0                                    # +256 KB
            b = a * 2.0                                    # +256 KB
            del a
            return b * 2.0                                 # a freed first
        c = count(f, x)
        assert c.peak_live_bytes == 3 * 256 * 256 * 4

    def test_boundary_is_a_plain_call_outside_a_count(self):
        assert boundary.observer() is None
        assert boundary.call("w2a8_gemv", lambda a: a + 1, 1) == 2
        with pytest.raises(RuntimeError, match="nest"):
            count(lambda: count(lambda: None))
        assert boundary.observer() is None


def test_fp_forward_flops_equal_jax_hlo_analysis():
    jc = jget("qwen3-0.6b").reduced()
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jc.vocab, (2, 16)).astype(np.int32)
    hlo = jax.jit(lambda p, t: jm.apply(p, t)).lower(
        params, jnp.asarray(tokens)).compile().as_text()
    want = analyze(hlo, 1).flops
    model = jax_params_to_torch(get_config("qwen3-0.6b").reduced(),
                                jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    got = count(lambda t: model.apply(t), torch.from_numpy(tokens))
    assert got.flops == pytest.approx(want, rel=1e-6)
    assert set(got.op_flops) == {"aten.mm", "aten.bmm"}
    logits = got.result[0]
    assert tuple(logits.shape) == (2, 16, jc.padded_vocab)


def _qat_forward(device):
    cfg = get_config("qwen3-0.6b").reduced().with_quant(
        TQ.QuantConfig(mode="qat", use_kernel=True))
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    model = build_model(cfg, gen=gen, device=device)
    tokens = torch.zeros((2, 16), dtype=torch.int32, device=device)
    return cfg, model, count(lambda t: model.apply(t)[0], tokens, resident=model)


def test_qat_forward_with_kernels_cpu_and_meta_routes_agree():
    cfg, _, cpu = _qat_forward("cpu")
    _, _, meta = _qat_forward("meta")
    assert cpu.to_dict() == meta.to_dict()
    calls = 7 * cfg.n_layers
    bl = cpu.kernel_calls["bitlinear"]
    assert bl["calls"] == calls and bl["op_type"] == "int8"
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    m = 2 * 16
    per_layer = 2.0 * m * (d * (hq + 2 * hkv) + hq * d + 3 * d * f)
    assert bl["flops"] == pytest.approx(cfg.n_layers * per_layer, rel=1e-12)
    one = kernel_work("bitlinear", torch.empty((m, d), device=META),
                      torch.empty((d, hq), device=META),
                      torch.empty((), device=META))
    assert one.ops == 2.0 * m * d * hq
    # none of the plain version's ops: the one matmul left is the LM head
    assert cpu.op_calls["aten.mm"] == 1
    assert cpu.flops == pytest.approx(bl["flops"] + cpu.op_flops["aten.mm"]
                                      + cpu.op_flops.get("aten.bmm", 0.0), rel=1e-12)

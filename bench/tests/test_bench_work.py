"""The frozen arithmetic (``harness/work.py``) against counts worked out by
hand."""

import bench_local  # noqa: F401  (puts bench/ on the path)
import pytest

from harness import work
from harness.work import Arg


def test_w2a8_work_by_hand():
    # M=8, K=1024, N=3072, bf16 x, packed weight [256, 3072], fp32 scalar delta
    w = work.kernel_work("w2a8_gemv", [Arg((8, 1024), "bfloat16"),
                                       Arg((256, 3072), "uint8"), Arg((), "float32")])
    assert w[0] == 2 * 8 * 1024 * 3072
    assert w[1] == 8 * 1024 * 2 + 256 * 3072 + 4 + 8 * 3072 * 2
    assert w[2] == "int8"
    t, by = w.seconds()
    assert by == "bytes" and t == pytest.approx(w[1] / 3.35e12)


def test_paged_decode_work_by_hand():
    # two rows, the second idle (its table's first block is the trash block 0)
    q = Arg((2, 8, 2, 128), "bfloat16")
    kv = Arg((2, 8, 128), "bfloat16")
    pool = Arg((100, 8, 16, 128), "bfloat16")
    bt = Arg((2, 4), "int32", [5, 0])
    idx = Arg((2,), "int32", [40, 7])
    w = work.kernel_work("paged_attention_decode", [q, kv, kv, pool, pool, bt, idx])
    per_tok = 2 * 8 * 128 * 2
    assert w[0] == 4.0 * 16 * 128 * 41
    assert w[1] == 2 * 16 * 128 * 2 + 2 * 8 * 128 * 2 + 41 * per_tok
    assert w[2] == "bfloat16"


def test_paged_prefill_work_by_hand():
    q = Arg((1, 8, 32 * 2, 128), "bfloat16")
    kc = Arg((1, 8, 32, 128), "bfloat16")
    pool = Arg((100, 8, 16, 128), "bfloat16")
    w = work.kernel_work("paged_prefill_chunk",
                         [q, kc, kc, pool, pool, Arg((1, 4), "int32", [3]),
                          Arg((1,), "int32", [48]), Arg((1,), "int32", [20])])
    per_tok = 2 * 8 * 128 * 2
    assert w[0] == 4.0 * 16 * 128 * (20 * 48 + 20 * 21 // 2)
    assert w[1] == (2 * 20 * 16 * 128 * 2 + 20 * per_tok + (20 + 16) * per_tok
                    + 48 * per_tok - 16 * per_tok)


def test_bitlinear_relation_ssd_work_by_hand():
    b = work.kernel_work("bitlinear", [Arg((64, 256), "bfloat16"),
                                       Arg((256, 128), "float32"), Arg((), "float32")])
    assert b[0] == 2 * 64 * 256 * 128
    assert b[1] == 64 * 256 * 2 + 256 * 128 * 4 + 4 + 64 * 128 * 2 + 64 * 256 + 4 * 64 + 256 * 128
    r = work.kernel_work("relation_kd", [Arg((32, 256, 512), "float32"),
                                         Arg((32, 256, 512), "float32"), 1.0])
    assert r[0] == 3 * 2 * 2.0 * 32 * 256 * 256 * 512 and r[2] == "tf32"
    s = work.kernel_work("ssd_scan", [Arg((2, 512, 4, 64), "float32"),
                                      Arg((2, 512, 4), "float32"),
                                      Arg((2, 512, 4), "float32"),
                                      Arg((2, 512, 128), "float32"),
                                      Arg((2, 512, 128), "float32"), 256])
    q, nc = 256, 2
    ops = 2 * 4 * nc * (q * (q + 1) * 64 + 4.0 * q * 128 * 64) + 2 * nc * q * (q + 1) * 128
    assert s[0] == 3 * ops


def test_serve_step_by_hand():
    shape = work.DenseShape(layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=128, vocab=1000)
    proj = 2 * (64 * (4 + 4) * 16 + 4 * 16 * 64 + 3 * 64 * 128)
    assert shape.proj_params == proj
    # one decode row at depth 10, one 4-token chunk from 0 that is not sampled
    rows = [(1, 10, True), (4, 0, False)]
    int8 = 2.0 * proj * 5
    bf16 = 2 * 4.0 * 4 * 16 * (11 + 10) + 2.0 * 64 * 1000 * 1
    nbytes = proj / 4 + 1000 * 64 * 2 + 2 * 2 * 2 * 16 * 2 * (10 + 5)
    want = max(int8 / 1979e12 + bf16 / 989e12, nbytes / 3.35e12)
    assert work.serve_step_seconds(shape, rows) == pytest.approx(want)
    assert work.serve_step_seconds(shape, []) == 0.0


def test_ssm_serve_step_by_hand():
    cfg = {"family": "ssm", "n_layer": 2, "d_model": 8, "d_state": 4, "headdim": 4,
           "expand": 2, "d_conv": 4, "chunk_size": 8, "vocab_size": 10}
    shape = work.shape_of(cfg)
    # d_inner 16, 4 heads; in_proj 8 x (32 + 8 + 4), out_proj 16 x 8
    proj = 2 * (8 * 44 + 16 * 8)
    assert shape.proj_params == proj
    state = 2 * (4 * 4 * 4 + (16 + 8) * 3) * 4
    assert shape.state_bytes == state
    rows = [(1, 50, True), (3, 0, False)]
    int8 = 2.0 * proj * 4
    bf16 = 2.0 * 8 * 10 * 1
    fp32 = 2 * 4.0 * 4 * 4 * 4 * 4
    nbytes = proj / 4 + 10 * 8 * 2 + 2 * state * 2
    want = max(int8 / 1979e12 + bf16 / 989e12 + fp32 / 67e12, nbytes / 3.35e12)
    assert work.serve_step_seconds(shape, rows) == pytest.approx(want)


def test_distill_step_by_hand():
    cfg = {"family": "dense", "num_hidden_layers": 1, "hidden_size": 8,
           "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4,
           "intermediate_size": 16, "vocab_size": 10}
    proj = 8 * (2 + 2) * 4 + 2 * 4 * 8 + 3 * 8 * 16
    t = 2 * 3
    head = 2.0 * 8 * 10 * t
    attn = 4.0 * 2 * 4 * 2 * 3 * 4 / 2
    int8 = 2.0 * proj * t
    bf16 = 2.0 * proj * t + head + head + 2 * (2.0 * proj * t + head) + 4 * attn
    rel = 3 * 2.0 * 2 * 2 * 9 * 4
    tf32 = 4 * rel
    want_ops = int8 / 1979e12 + bf16 / 989e12 + tf32 / 494.7e12
    want_bytes = (proj + 80) * 34 / 3.35e12
    got = work.distill_step_seconds(cfg, 2, 3, (2, 4))
    assert got == pytest.approx(max(want_ops, want_bytes))


def test_a_roofline_counts_its_own_kernel_and_knows_no_other():
    """A window holding a kernel the frozen arithmetic does not know still
    reads the known kernel's share; a reader may bring its own arithmetic
    for a new kernel."""
    from harness.record import Run
    run = Run("x", {}, {}, 1.0, t_open=0.0, t_close=1.0, trace=True)
    args = [Arg((8, 1024), "bfloat16"), Arg((256, 3072), "uint8"), Arg((), "float32")]
    new = [Arg((1 << 20,), "float32")]
    run.kernels.calls = [("w2a8_gemv", args), ("a_new_kernel", new)]
    run.device.window = (0.0, 1.0)
    run.device.events = [("w2a8_kernel_gemm", 0.1, 0.1 + 1e-5),
                         ("a_new_kernel_main", 0.2, 0.2 + 1e-5)]
    least = work.kernel_work("w2a8_gemv", args).seconds()[0]
    assert run.kernel_roofline_pct("w2a8_gemv", ["w2a8_kernel"]) == \
        pytest.approx(100 * least / 1e-5)
    own = lambda name, a: work.Work(0.0, 2 * work.size(a[0]), "float32")  # noqa: E731
    assert run.kernel_roofline_pct("a_new_kernel", ["a_new_kernel"], own) == \
        pytest.approx(100 * 8 * (1 << 20) / 3.35e12 / 1e-5)

"""Prefill and decode under a sharding plan: the decode cache's logical
axes and placement, and ``decode_step`` on the split route
(``distributed/tensor_parallel.py``) over gloo ranks on the CPU
(``tests/_torch_tp_decode_worker.py``: jobs of two and four ranks, started
once for the module), against the port's unsharded step and JAX's.

* ``cache_axes()`` of every registered config equals JAX's, layer for
  layer (JAX stacks a pattern position's layers under a leading
  ``"layers"`` axis, never sharded), and under the production plan (16 x 16,
  decode_32k's 128 rows of 32768 positions) each cache tensor's spec equals
  JAX's ``tree_specs`` (what ``tree_shardings`` wraps) spec for spec: kv
  heads over ``"model"`` where they divide, else the positions.
* Four reduced models decode a seeded prompt (a token a step, each row at
  its own depth) and six greedy steps over 2 and 4 ranks, in fp32:
  qwen1.5-0.5b (4 kv heads: the cache split by heads), qwen2.5-3b (one kv
  head: split by positions, the ranks' attention merged by log-sum-exp;
  at tp 4 the last rank holds no written position), mamba2-780m (the state
  by heads, the conv tail by channels), granite-moe-1b-a400m (its experts
  by rank at full capacity; 2 kv heads: by heads at tp 2, by positions at
  tp 4) and a packed qwen1.5-0.5b (column shards, and row shards through
  ``w2a8_forward_acc``'s plain version).
  Each step's logits within 1e-5 of the unsharded port's (read: 1.2e-7 to
  8.6e-7), the greedy tokens equal; the fp models' tokens equal JAX's
  ``decode_step`` on the same params, their logits within 1e-4 (the
  decode-config tests' fp32 bound).
* The same in bf16 (bf16 scores, a bf16 cache, QAT on the kernel route),
  qwen1.5-0.5b by heads and qwen2.5-3b by positions: the split's logits
  within 1e-5 of the unsharded bf16 step's (read: equal), and within 8
  bf16 ulps of JAX's, the greedy tokens JAX's but at bf16 ties.
* The packed decode over 2 and 4 ranks equals the unsharded step in the
  split's exact forms (``models/lm.py::set_exact``; its cache split by
  heads, the attention the unsharded step's) bit for bit.
* Each rank's cache is its share under the plan, and a packed layer whose
  row shard would split a packed byte (K/tp not divisible by 4) is refused
  by name.  The plain row-shard entry's accumulators, summed over the
  shards and scaled once, are the whole product bit for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import quant as JQ
from repro.distributed.sharding import ShardingPlan as JPlan
from repro.distributed.sharding import default_rules as jrules
from repro.models import build_model as jbuild
from repro.models import get_config as jget
import repro_torch.configs  # noqa: F401  (registers every config)
from repro_torch import bridge
from repro_torch.core import quant as Q
from repro_torch.core.bitlinear import BitLinear
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import ShardingPlan, default_rules, local_shape
from repro_torch.kernels.w2a8_gemv.ref import w2a8_forward_acc_ref, w2a8_ref
from repro_torch.models import build_model, get_config, lm
from repro_torch.models.encdec import EncDecLM
from repro_torch.nn.attention import Attention

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_tp_decode_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(W.__file__)
TIMEOUT = 300
WORLDS = (2, 4)
NAMES = sorted({c.name for c in jconfigs.ASSIGNED + jconfigs.PAPER_BACKBONES})
PRODUCTION = {"data": 16, "model": 16}
ROWS, SEQ = 128, 32768                     # decode_32k


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _inputs():
    rng = np.random.default_rng(28)
    return {f"{c}/prompt": rng.integers(0, 288, (3, 4)).astype(np.int32)
            for c in W.CASES}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The ranks' outputs, and while they run each case's references: the
    unsharded port's decode and JAX's."""
    io = tmp_path_factory.mktemp("tpd")
    inp = _inputs()
    np.savez(io / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for world in WORLDS:
        for r in range(world):
            log = open(io / f"rank{world}_{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(world),
                 str(io / f"store{world}"), str(io)],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT),
                io / f"rank{world}_{r}.log"))
    try:
        refs = {c: (_unsharded(inp, c), _jax_decode(inp, c) if c != "packed" else None)
                for c in W.CASES}
        refs["packed/exact"] = _unsharded(inp, "packed", exact=True)
    except BaseException:
        for p, _ in procs:
            p.kill()
        raise
    for p, log in procs:
        try:
            rc = p.wait(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
        assert rc == 0, log.read_text()[-3000:]
    outs = {w: [torch.load(io / f"out{w}_{r}.pt", weights_only=False)
                for r in range(w)] for w in WORLDS}
    return inp, outs, refs


def _unsharded(inp, case, exact=False):
    """The unsharded port's decode; with ``exact`` in the forms a split
    over more than one rank takes: the packed products' and SubLN's sums
    (``set_exact``), but the attention, which over a cache split by heads
    attends the rank's own heads as the unsharded step does."""
    _, model = W.model_of(case)
    if exact:
        lm.set_exact(model)
        for m in model.modules():
            if isinstance(m, Attention):
                m.exact_sum = False
    logits, toks, _ = W.decode(model, W.prompt_of(inp, case), dtype=W.cache_dtype(case))
    return logits, toks


def _jax_decode(inp, case):
    """JAX's ``decode_step`` on the case's params (through the bridge), the
    same schedule as :func:`W.decode` -> (logits, greedy tokens)."""
    cfg, model = W.model_of(case)
    jcfg = jget(cfg.name).reduced()
    if W.CASES[case][1] == "bf16":
        jcfg = jcfg.with_quant(JQ.QuantConfig(mode="qat", use_kernel=True)).replace(
            compute_dtype="bfloat16", attn_scores_dtype="bfloat16")
    jm = jbuild(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, bridge.jax_params_from_torch(cfg, model))
    prompt = inp[f"{case}/prompt"]
    b, p = prompt.shape
    cache = jm.init_cache(params, b, W.MAX_LEN,
                          jnp.bfloat16 if W.CASES[case][1] == "bf16" else jnp.float32)
    step = jax.jit(jm.decode_step)
    start = np.arange(b, dtype=np.int32)
    tok, logits, toks = prompt[:, 0], [], []
    for i in range(p - 1 + W.STEPS):
        out, cache = step(params, jnp.asarray(tok), cache, jnp.asarray(start + i))
        out = np.asarray(out)
        logits.append(out)
        if i + 1 < p:
            tok = prompt[:, i + 1]
        else:
            tok = out.argmax(-1).astype(np.int32)
            toks.append(tok)
    return np.stack(logits), np.stack(toks)


# -- the cache's axes and placement --------------------------------------------------

def _port_cache(name, rows=ROWS, seq=SEQ):
    cfg = get_config(name)
    model = build_model(cfg, device=torch.device("meta"))
    dec = model.decoder if isinstance(model, EncDecLM) else model
    t = {"audio": cfg.encoder_seq, "vlm": cfg.num_image_tokens}.get(cfg.family)
    mem = None if t is None else torch.empty((rows, t, cfg.d_model), device="meta")
    return model, dec.stack.init_cache(rows, seq, torch.bfloat16, "meta", mem)


def _jax_cache(name, rows=ROWS, seq=SEQ):
    cfg = jget(name)
    jm = jbuild(cfg)
    stack = (jm._decoder() if cfg.family == "audio" else jm)._stack()
    t = {"audio": cfg.encoder_seq, "vlm": cfg.num_image_tokens}.get(cfg.family)
    mem = None if t is None else jnp.zeros((rows, t, cfg.d_model), jnp.bfloat16)
    return jm, jax.eval_shape(lambda: stack.init_cache(rows, seq, jnp.bfloat16, mem))


def _layers(cfg, port_tree, jax_tree):
    """(port layer's leaf, JAX's leaf of that layer, its key) pairs: the
    port's layer l is JAX's pattern position l % P, repeat l // P."""
    period = len(cfg.resolved_pattern())
    for li, layer in enumerate(port_tree):
        for part, leaves in layer.items():
            for k, leaf in leaves.items():
                yield leaf, jax_tree[f"pos{li % period}"][part][k], (li, part, k)


@pytest.mark.parametrize("name", NAMES)
def test_cache_axes_match_jax(name):
    model, _ = _port_cache(name, 2, 8)
    jm, _ = _jax_cache(name, 2, 8)
    port, ref = model.cache_axes(), jm.cache_axes()
    assert len(port) == model.cfg.n_layers
    for got, want, where in _layers(model.cfg, port, ref):
        assert want[0] == "layers" and got == want[1:], (name, where)


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_match_jax_under_the_production_plan(name):
    model, cache = _port_cache(name)
    jm, jcache = _jax_cache(name)
    plan = ShardingPlan(dict(PRODUCTION), default_rules(False))
    jplan = JPlan(FakeMesh(PRODUCTION), jrules(False))
    jspecs = jplan.tree_specs(jm.cache_axes(), jcache)
    axes = model.cache_axes()
    seen = set()
    for (leaf, jspec, where), (ax, _, _) in zip(
            _layers(model.cfg, cache, jspecs), _layers(model.cfg, axes, jspecs)):
        got = plan.spec(ax, tuple(leaf.shape))
        want = tuple(tuple(a) if isinstance(a, tuple) else ((a,) if a else ())
                     for a in tuple(jspec) + (None,) * (5 - len(tuple(jspec))))[1:]
        assert got == want[:len(got)], (name, where, got, jspec)
        if where[1] in ("attn", "xattn") and where[2] == "k":
            seen.add("heads" if "model" in got[1] else
                     "kv_seq" if "model" in got[2] else "whole")
    cfg = get_config(name)
    if any(s.mixer in ("attn", "attn_cross") for s in cfg.resolved_pattern()):
        assert ("heads" if cfg.n_kv_heads % 16 == 0 else "kv_seq") in seen


# -- decode over gloo ranks ------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(W.CASES))
def test_split_decode_matches_the_unsharded_port(jobs, case, world):
    _, outs, refs = jobs
    logits, toks = refs[case][0]
    for rank, out in enumerate(outs[world]):
        got_logits, got_toks, _, _ = out[case]
        assert got_logits.shape == logits.shape
        err = float((got_logits - logits).abs().max())
        assert err <= 1e-5, (case, world, rank, err)
        assert torch.equal(got_toks, toks), (case, world, rank)


@pytest.mark.parametrize("world", WORLDS)
def test_packed_split_decode_is_the_exact_step_bitwise(jobs, world):
    """Over more than one rank every reduction of a packed decode takes
    its exact form (the packed products' integer sums, SubLN's float64
    sums; its cache split by heads, a rank attends its own heads); the
    unsharded step in those forms gives the same logits bit for bit."""
    _, outs, refs = jobs
    logits, toks = refs["packed/exact"]
    for out in outs[world]:
        assert torch.equal(out["packed"][0], logits)
        assert torch.equal(out["packed"][1], toks)


@pytest.mark.parametrize("case", ["kv_seq", "mamba2", "mha", "moe"])
def test_split_decode_matches_jax(jobs, case):
    _, outs, refs = jobs
    jlogits, jtoks = refs[case][1]
    for world in WORLDS:
        got_logits, got_toks, _, _ = outs[world][0][case]
        np.testing.assert_allclose(got_logits.numpy(), jlogits, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{case} world {world}")
        np.testing.assert_array_equal(got_toks.numpy(), jtoks)


# the bf16 cases against JAX: the two sides round the same bf16 values at
# different places (read: the unsharded port 0.0215 from JAX on logits of
# at most 0.77), bounded by 8 bf16 ulps of logits below 1 (8 * 2^-8)
BF16_JAX_BOUND = 8 * 2.0 ** -8


@pytest.mark.parametrize("case", ["bf16_heads", "bf16_kv_seq"])
def test_bf16_split_decode_matches_jax(jobs, case):
    """In bf16 (bf16 scores, a bf16 cache) the split decode's logits stay
    within ``BF16_JAX_BOUND`` of JAX's ``decode_step`` while both are fed
    the same tokens, and each greedy token is JAX's unless JAX's top two
    logits are within twice the bound of each other (bf16 ties: a row
    whose token differs there is fed another token, and is compared no
    further)."""
    _, outs, refs = jobs
    jlogits, jtoks = refs[case][1]
    jlogits = np.asarray(jlogits, np.float32)
    top = np.sort(jlogits, axis=-1)[..., -2:]
    gap = top[..., 1] - top[..., 0]
    p = W.prompt_of(_inputs(), case).shape[1]
    for world in WORLDS:
        got_logits, got_toks, _, _ = outs[world][0][case]
        got = got_logits.float().numpy()
        same = np.ones(got.shape[1], bool)          # rows fed JAX's tokens so far
        for i in range(got.shape[0]):
            err = np.abs(got[i] - jlogits[i]).max(axis=-1)
            assert (err[same] <= BF16_JAX_BOUND).all(), (case, world, i, err)
            if i >= p - 1:
                agree = got_toks[i - p + 1].numpy() == np.asarray(jtoks[i - p + 1])
                assert (agree | ~same | (gap[i] <= 2 * BF16_JAX_BOUND)).all(), \
                    (case, world, i, gap[i])
                same &= agree


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(W.CASES))
def test_each_rank_holds_its_share_of_the_cache(jobs, case, world):
    _, outs, _ = jobs
    cfg, model = W.model_of(case)
    plan = ShardingPlan({"data": 1, "model": world}, default_rules(False))
    whole = model.init_cache(3, W.MAX_LEN, torch.float32, torch.device("meta"))
    want = [{k: {n: local_shape(t.shape, plan.spec(model.cache_axes()[li][k][n],
                                                   tuple(t.shape)), plan.shape)
                 for n, t in part.items()} for k, part in layer.items()}
            for li, layer in enumerate(whole)]
    for out in outs[world]:
        assert out[case][2] == want
    split_dim = {"mha": (0, "attn", "k", 1), "packed": (0, "attn", "k", 1),
                 "bf16_heads": (0, "attn", "k", 1), "bf16_kv_seq": (0, "attn", "k", 2),
                 "kv_seq": (0, "attn", "k", 2), "mamba2": (0, "mamba", "state", 1),
                 "moe": (0, "attn", "k", 1 if world == 2 else 2)}
    li, part, name, d = split_dim[case]
    assert want[li][part][name][d] * world == whole[li][part][name].shape[d]


@pytest.mark.parametrize("world", WORLDS)
def test_packed_decode_runs_column_and_row_shards(jobs, world):
    """A packed layer a step: q, k, v, gate and up on column shards (w2a8),
    wo and down on row shards (w2a8_forward_acc), every layer every step;
    the fp cases call neither."""
    inp, outs, _ = jobs
    cfg, _ = W.model_of("packed")
    steps = inp["packed/prompt"].shape[1] - 1 + W.STEPS
    for out in outs[world]:
        assert out["packed"][3] == {"w2a8_gemv": 5 * cfg.n_layers * steps,
                                    "w2a8_forward_acc": 2 * cfg.n_layers * steps}
        assert all(out[c][3] == {} for c in ("mha", "kv_seq", "moe"))


def test_packed_row_shard_refuses_a_split_byte():
    """K = 24 over 4 ranks: 6 input rows a rank, a packed byte split."""
    lin = BitLinear(24, 8, quant=Q.QuantConfig(mode="packed"),
                    gen=torch.Generator().manual_seed(0), axes=("mlp", "embed"))
    plan = ShardingPlan({"data": 1, "model": 4}, default_rules(False))
    with pytest.raises(ValueError, match="K/tp must be divisible by 4"):
        tp.Split(plan).register(lin)


@pytest.mark.parametrize("m,k,n,parts", [(3, 64, 40, 4), (8, 128, 16, 2),
                                         (256, 96, 24, 3)])
def test_row_shard_accumulators_sum_to_the_whole_product(m, k, n, parts):
    g = torch.Generator().manual_seed(m + k)
    x = torch.randn((m, k), generator=g)
    w = torch.randint(-1, 2, (k, n), generator=g).to(torch.int8)
    wp = Q.pack_ternary(w)
    delta = torch.tensor(0.037, dtype=torch.float32)
    gamma = x.abs().amax(dim=-1, keepdim=True)
    kk = k // parts
    acc = sum(w2a8_forward_acc_ref(x[:, r * kk:(r + 1) * kk],
                                   wp[r * kk // 4:(r + 1) * kk // 4], gamma)
              for r in range(parts))
    y = (acc * (Q.div(gamma, 127.0) * delta)).to(x.dtype)
    assert torch.equal(y, w2a8_ref(x, wp, delta))

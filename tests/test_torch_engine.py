"""Port vs JAX: the serving Engine end to end on reduced configs.

Greedy rows are held to exact token parity with the JAX ``Engine`` on the
same params (JAX init -> JAX ``convert_to_packed`` -> ``repro_torch.bridge``)
over the seeded arrival schedules of tests/test_chunked_prefill.py, with
``prefill_chunk`` 32 and 0, the prefix cache on and off, and pools tight
enough to preempt.  The port runs both its attention paths ("gather", and
"fused", which takes the kernels' plain versions on the CPU).

Sampled rows cannot match JAX's threefry streams; they are held to their own
contract instead: the same seed gives the same tokens whether the prompt was
chunked or whole, and the nucleus (top-p) mask is JAX's on fixed logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.serving import sampling as jsampling
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import convert_to_packed as jconvert
from repro_torch.bridge import jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.models import get_config
from repro_torch.serving import Engine, SamplingParams, ServeConfig
from repro_torch.serving import sampling as tsampling
from test_chunked_prefill import make_schedule


@pytest.fixture(scope="module", params=["qwen3-0.6b", "qwen1.5-0.5b"])
def pair(request):
    name = request.param
    jcfg = jget(name).reduced().with_quant(JQ.QAT)
    pcfg, pparams = jconvert(jcfg, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = get_config(name).reduced().with_quant(TQ.PACKED)
    model = jax_params_to_torch(
        tcfg, jax.tree_util.tree_map(np.asarray, pparams), device="cpu")
    return pcfg, pparams, tcfg, model


def _drive(eng, schedule, sp):
    """Submit each burst at its scheduled step; returns per-uid outputs."""
    reqs = {}
    step, last = 0, max(schedule)
    while eng.has_pending() or step <= last:
        for prompt in schedule.get(step, []):
            r = eng.submit(prompt, sp)
            reqs[r.uid] = r
        eng.step()
        step += 1
        assert step < 3000, "serving loop made no progress"
    return {uid: r.output_tokens for uid, r in reqs.items()}


CASES = [
    # (schedule seed, ServeConfig overrides): chunked vs whole-prompt, prefix
    # cache off / on, and pools tight enough to preempt
    (0, dict(prefill_chunk=32)),
    (1, dict(prefill_chunk=0, prefix_cache=True)),
    (3, dict(prefill_chunk=32, prefix_cache=True, num_kv_blocks=7)),
]


@pytest.mark.parametrize("seed,kw", CASES)
def test_greedy_tokens_match_jax_engine(pair, seed, kw):
    pcfg, pparams, tcfg, model = pair
    schedule = make_schedule(seed)
    base = dict(max_batch=3, max_len=24, kv_block_size=4, **kw)
    jeng = JEngine(pcfg, pparams, JServeConfig(paged=True, **base))
    want = _drive(jeng, schedule, JSamplingParams(max_tokens=6, ignore_eos=True))
    for impl in ("gather", "fused"):
        eng = Engine(tcfg, model, ServeConfig(attn_impl=impl, **base))
        got = _drive(eng, schedule, SamplingParams(max_tokens=6, ignore_eos=True))
        assert got == want, (seed, kw, impl)
        s, js = eng.stats(), jeng.stats()
        assert (s.preemptions, s.admissions, s.prefill_positions) == \
            (js.preemptions, js.admissions, js.prefill_positions)
        if "num_kv_blocks" in kw:
            assert s.preemptions > 0, "pool not tight enough to preempt"
        if kw.get("prefix_cache"):
            assert s.prefix_cache == js.prefix_cache
        assert eng.allocator.blocks_in_use() == (
            0 if eng.prefix_cache is None
            else eng.prefix_cache.cached_unreferenced())


def test_sampled_stream_same_chunked_or_whole(pair):
    """A stochastic row's generator advances only when the row consumes a
    sample, so its tokens do not depend on how the prompt was chunked."""
    _, _, tcfg, model = pair
    prompt = list(range(3, 22))
    outs = []
    for chunk in (4, 0, 32):
        eng = Engine(tcfg, model, ServeConfig(max_batch=2, max_len=40,
                                              kv_block_size=4,
                                              prefill_chunk=chunk))
        sp = SamplingParams(max_tokens=8, temperature=1.0, top_p=0.9, seed=7,
                            ignore_eos=True)
        r = eng.submit(prompt, sp)
        eng.submit([5, 6, 7], SamplingParams(max_tokens=8, ignore_eos=True))
        for _ in eng.stream():
            pass
        outs.append(r.output_tokens)
    assert outs[0] == outs[1] == outs[2]
    assert len(set(outs[0])) > 1


def test_top_p_mask_matches_jax_on_fixed_logits():
    """The port's nucleus distribution keeps exactly the tokens JAX's
    ``sample_batch`` can draw, and both sample it with the same law."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 12)).astype(np.float32) * 2
    temps = np.array([0.7, 1.0, 1.3], np.float32)
    tops = np.array([0.5, 0.9, 1.0], np.float32)
    probs = tsampling.top_p_probs(torch.from_numpy(logits),
                                  torch.from_numpy(temps),
                                  torch.from_numpy(tops)).numpy()
    n = 4000
    keys = jax.random.split(jax.random.PRNGKey(0), 3 * n)
    tiled = jnp.repeat(jnp.asarray(logits), n, axis=0)
    drawn = np.asarray(jsampling.sample_batch(
        keys, tiled, jnp.repeat(jnp.asarray(temps), n),
        jnp.repeat(jnp.asarray(tops), n))).reshape(3, n)
    for row in range(3):
        support = set(np.flatnonzero(probs[row] > 0).tolist())
        assert set(np.unique(drawn[row]).tolist()) == support
        freq = np.bincount(drawn[row], minlength=12) / n
        np.testing.assert_allclose(freq, probs[row], atol=0.03)
    # and the port's own draws follow the same law
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    got = np.array([tsampling.sample_batch(torch.from_numpy(logits), temps,
                                           tops, gens, [0, 1, 2]).numpy()
                    for _ in range(1500)])
    for row in range(3):
        freq = np.bincount(got[:, row], minlength=12) / len(got)
        np.testing.assert_allclose(freq, probs[row], atol=0.05)


def test_greedy_and_nonfinite_guard_match_jax():
    logits = np.random.default_rng(9).standard_normal((4, 10)).astype(np.float32)
    logits[1, 3] = logits[1, 7] = logits[1].max() + 1     # tie: first index
    logits[2, 5] = np.nan
    tj = np.asarray(jsampling.guard_nonfinite(jsampling.greedy(jnp.asarray(logits)),
                                              jnp.asarray(logits)))
    tt = tsampling.guard_nonfinite(tsampling.greedy(torch.from_numpy(logits)),
                                   torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(tt, tj)
    assert tt[2] == tsampling.NONFINITE_TOKEN == jsampling.NONFINITE_TOKEN

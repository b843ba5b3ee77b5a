"""Port vs JAX: the contiguous KV cache (``ServeConfig(paged=False)``) for
attention stacks, and the cache-layout refusals, on the CPU.

The contiguous ``Attention.decode`` is held to JAX's step by step (output
and the K/V it writes), and the ``Engine`` on ``qwen3-0.6b`` and
``qwen1.5-0.5b`` (reduced, fp32, packed weights from JAX
``convert_to_packed`` through the bridge) to the JAX contiguous engine and
to the port's own paged engine token for token, over the seeded arrival
schedules of tests/test_chunked_prefill.py (slots are reused: attention K/V
is rewritten before it is read, so neither side carries anything over).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import convert_to_packed as jconvert
from repro_torch.bridge import jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.models import build_model, get_config
from repro_torch.serving import Engine, SamplingParams, ServeConfig
from test_chunked_prefill import make_schedule
from test_torch_engine import _drive


@pytest.fixture(scope="module", params=["qwen3-0.6b", "qwen1.5-0.5b"])
def pair(request):
    name = request.param
    jcfg = jget(name).reduced().with_quant(JQ.QAT)
    pcfg, pparams = jconvert(jcfg, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = get_config(name).reduced().with_quant(TQ.PACKED)
    model = jax_params_to_torch(
        tcfg, jax.tree_util.tree_map(np.asarray, pparams), device="cpu")
    return pcfg, pparams, tcfg, model


def test_contiguous_attention_decode_matches_jax(pair):
    """Layer 0's attention: six decode steps of three rows at different
    depths (per-row ``cache_index``) into a [B, Hkv, 16, Dh] cache; each
    step's output and the cache within 1e-5."""
    pcfg, pparams, tcfg, model = pair
    jattn = jbuild(pcfg)._stack().blocks()[0].attn
    p0 = jax.tree_util.tree_map(lambda a: a[0], pparams["stack"]["pos0"]["attn"])
    tattn = model.stack.layers[0].attn
    b, smax = 3, 16
    jc = jattn.init_cache(b, smax, jnp.float32)
    tc = tattn.init_cache(b, smax, torch.float32)
    rng = np.random.default_rng(2)
    base = np.array([0, 2, 5], np.int32)
    jdecode = jax.jit(jattn.decode)
    with torch.no_grad():
        for t in range(6):
            x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
            idx = base + t
            jy, jc = jdecode(p0, jnp.asarray(x), jc, jnp.asarray(idx))
            ty, _ = tattn.decode(torch.from_numpy(x), tc, torch.from_numpy(idx))
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                       atol=1e-5)
            for k in ("k", "v"):
                np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                           rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("seed,chunk", [(0, 32), (1, 0), (2, 4)])
def test_greedy_tokens_match_jax_and_paged(pair, seed, chunk):
    pcfg, pparams, tcfg, model = pair
    schedule = make_schedule(seed)
    base = dict(max_batch=3, max_len=24, prefill_chunk=chunk)
    sp = dict(max_tokens=6, ignore_eos=True)
    want = _drive(JEngine(pcfg, pparams, JServeConfig(paged=False, **base)),
                  schedule, JSamplingParams(**sp))
    eng = Engine(tcfg, model, ServeConfig(paged=False, **base))
    assert eng.paged is False and eng.attn_impl == "gather"
    assert _drive(eng, schedule, SamplingParams(**sp)) == want
    paged = Engine(tcfg, model, ServeConfig(attn_impl="gather", kv_block_size=4,
                                            **base))
    assert paged.paged is True
    assert _drive(paged, schedule, SamplingParams(**sp)) == want


def _refusal(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


def test_refusals_match_jax():
    """The same ``ValueError``, message for message, from ServeConfig and
    Engine: the prefix cache and the sanitizer need the paged cache, a
    mamba stack has no paged layout, the fused kernels need the paged
    pools; and the layout each stack resolves to."""
    for kw in (dict(paged=False, prefix_cache=True), dict(paged=False, sanitize=True),
               dict(paged=False, sanitize=True, kv_checksums=True)):
        assert _refusal(lambda: ServeConfig(**kw)) == \
            _refusal(lambda: JServeConfig(**kw))
    engines = {}
    for name in ("mamba2-780m", "qwen3-0.6b"):
        jcfg = jget(name).reduced()
        engines[name] = (jcfg, jbuild(jcfg).init(jax.random.PRNGKey(0)),
                         get_config(name).reduced(),
                         build_model(get_config(name).reduced(), device="cpu"))
    cases = [("mamba2-780m", dict(paged=True)),
             ("mamba2-780m", dict(prefix_cache=True)),
             ("mamba2-780m", dict(sanitize=True)),
             ("qwen3-0.6b", dict(paged=False, attn_impl="fused"))]
    for name, kw in cases:
        jcfg, params, tcfg, model = engines[name]
        want = _refusal(lambda: JEngine(jcfg, params, JServeConfig(**kw)))
        assert _refusal(lambda: Engine(tcfg, model, ServeConfig(**kw))) == want
    for name, kw, paged in (("mamba2-780m", {}, False),
                            ("mamba2-780m", dict(paged=False), False),
                            ("qwen3-0.6b", {}, True),
                            ("qwen3-0.6b", dict(paged=False), False)):
        jcfg, params, tcfg, model = engines[name]
        assert JEngine(jcfg, params, JServeConfig(**kw)).paged is paged
        assert Engine(tcfg, model, ServeConfig(**kw)).paged is paged

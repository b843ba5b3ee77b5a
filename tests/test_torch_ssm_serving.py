"""Port vs JAX: serving ``mamba2-780m`` on the contiguous cache, on the CPU.

``Mamba2Block.decode`` is held to JAX's step by step (output, recurrent
state and conv tail), a token-by-token decode to the port's own forward,
and the ``Engine`` to the JAX ``Engine`` token for token (greedy, reduced
config, fp32, QAT and packed weights; packed through JAX
``convert_to_packed`` and the bridge), with ``prefill_chunk`` 0 and 4.

The JAX engine has three faults on this path (ROADMAP Queue C): a slot's
recurrent state carries over to the next request that takes the slot, a
relaunched step advances it a second time, and a budget-stalled row
advances it with pad tokens.  The parity schedules therefore admit every
request at once into its own slot, fire no fault and set no budget; the
port's repairs are held to the port's own contract instead (a request's
tokens do not depend on what the slot served before, on transient faults,
or on the prefill budget), and the tests assert that JAX's differ.
"""
import asyncio

import jax
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
from repro.serving.faults import Fault as JFault
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.supervisor import ServingSupervisor as JSupervisor
from repro_torch.bridge import jax_params_to_torch
from repro_torch.core import quant as TQ
from repro_torch.models import build_model, get_config
from repro_torch.serving import AsyncEngine, Engine, SamplingParams, ServeConfig
from repro_torch.serving.faults import Fault, FaultPlan
from repro_torch.serving.supervisor import ServingSupervisor
from test_torch_ssm import _block_pair

NAME = "mamba2-780m"
# the decode step's tolerance: one fp32 step, the einsums and the conv taps
# summed in another order
STEP = dict(rtol=1e-5, atol=1e-5)
# every request admitted at t=0, each into its own slot: lengths 9, 5 and 3
# make prefill_chunk=4 run decode rows inside chunk steps
PROMPTS = [[5, 9, 3, 7, 11, 2, 8, 4, 1], [13, 1, 6, 2, 7], [3, 4, 5]]
BASE = dict(max_batch=3, max_len=24)


def _pair(mode):
    """(JAX cfg, JAX params, port cfg, port model) from PRNGKey(0) at the
    reduced widths, fp32.  Packed: the QAT init through JAX
    ``convert_to_packed``, then the bridge."""
    jcfg = jget(NAME).reduced()
    tcfg = get_config(NAME).reduced()
    if mode == "fp":
        params = jbuild(jcfg).init(jax.random.PRNGKey(0))
    else:
        jcfg = jcfg.with_quant(JQ.QAT)
        params = jbuild(jcfg).init(jax.random.PRNGKey(0))
        if mode == "packed":
            jcfg, params = jconvert(jcfg, params)
        tcfg = tcfg.with_quant(TQ.QAT if mode == "qat" else TQ.PACKED)
    model = jax_params_to_torch(tcfg, jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module", params=["qat", "packed"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def fp_pair():
    return _pair("fp")


def _serve(eng, prompts, max_tokens=6, sp_cls=SamplingParams):
    """Every prompt submitted at once; the engine drained; tokens per
    prompt."""
    sp = sp_cls(max_tokens=max_tokens, ignore_eos=True)
    reqs = [eng.submit(p, sp) for p in prompts]
    for _ in eng.stream():
        pass
    return [list(r.output_tokens) for r in reqs]


def _jserve(pair_, prompts, **kw):
    jcfg, params = pair_[:2]
    return _serve(JEngine(jcfg, params, JServeConfig(**kw)), prompts,
                  sp_cls=JSamplingParams)


def _tserve(pair_, prompts, **kw):
    return _serve(Engine(pair_[2], pair_[3], ServeConfig(**kw)), prompts)


# -- Mamba2Block.decode ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fp", "qat"])
def test_mamba_decode_matches_jax(mode):
    """Five decode steps from a zero cache: each step's output, the state
    and the conv tail, and a masked step (``keep``) leaving the rows it
    masks exactly as they were."""
    jblk, params, tblk = _block_pair(mode, False)
    b = 3
    rng = np.random.default_rng(4)
    jc = jblk.init_cache(b)
    jdecode = jax.jit(jblk.decode)
    tc = tblk.init_cache(b, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert tc["state"].dtype == torch.float32
    with torch.no_grad():
        for _ in range(5):
            u = rng.standard_normal((b, 1, 128)).astype(np.float32)
            jy, jc = jdecode(params, jax.numpy.asarray(u), jc)
            ty = tblk.decode(torch.from_numpy(u), tc)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **STEP)
            for k in ("state", "conv"):
                np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                           **STEP, err_msg=k)
        before = {k: v.clone() for k, v in tc.items()}
        u = torch.from_numpy(rng.standard_normal((b, 1, 128)).astype(np.float32))
        keep = torch.tensor([True, False, True])
        tblk.decode(u, tc, keep=keep)
        full = {k: v.clone() for k, v in before.items()}
        tblk.decode(u, full)
    for k in ("state", "conv"):
        assert torch.equal(tc[k][1], before[k][1]), k
        assert torch.equal(tc[k][keep], full[k][keep]), k


def test_token_by_token_decode_reproduces_forward():
    """The port's own seeded model: decode from an empty contiguous cache,
    one token per step, gives the full forward's logits (as the JAX
    package's ``test_arch_smoke.py`` holds its decode)."""
    cfg = get_config(NAME).reduced()
    model = build_model(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (b, s)))
    with torch.no_grad():
        full = model(toks)
        cache = model.init_cache(b, s + 2, torch.float32)
        assert all(set(layer) == {"mamba"} for layer in cache)
        outs = [model.decode_step(toks[:, t], cache,
                                  torch.full((b,), t, dtype=torch.int32))[0]
                for t in range(s)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


# -- Engine ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 4])
def test_greedy_tokens_match_jax_engine(pair, chunk):
    kw = dict(BASE, prefill_chunk=chunk)
    want = _jserve(pair, PROMPTS, **kw)
    eng = Engine(pair[2], pair[3], ServeConfig(**kw))
    assert eng.paged is False and eng.allocator is None
    assert _serve(eng, PROMPTS) == want
    st = eng.stats()
    assert st.blocks_in_use is None and st.prefill_positions == sum(map(len, PROMPTS))
    # three ring buffers of the recurrent leaves: state fp32 [3, L, B, H, P, N]
    c = pair[2]
    per_slot = c.n_layers * (2 * c.d_model // c.ssm_head_dim) * c.ssm_head_dim \
        * c.ssm_state * 4
    assert eng.kv_cache_bytes() > 3 * BASE["max_batch"] * per_slot


def test_slot_reuse_starts_from_zero_state(fp_pair):
    """One slot: B served after A gives B's tokens alone.  JAX carries A's
    state into B (ROADMAP Queue C)."""
    a, b = [5, 9, 3, 7, 11, 2, 8, 4], [13, 1, 6]
    kw = dict(max_batch=1, max_len=24, prefill_chunk=4)
    alone = _tserve(fp_pair, [b], **kw)[0]
    assert _tserve(fp_pair, [a, b], **kw)[1] == alone
    assert _jserve(fp_pair, [b], **kw)[0] == alone
    assert _jserve(fp_pair, [a, b], **kw)[1] != alone     # the JAX fault


def test_budget_stalled_rows_keep_their_state(fp_pair):
    """A prefill budget only reorders the work: the tokens are those of
    the unbudgeted run, also for a row stalled mid-prompt (the long prompt
    in slot 1 once the third request takes slot 0 and the budget).  JAX
    advances a stalled row's state with pad tokens, so its third request of
    PROMPTS, stalled before its first chunk, differs (ROADMAP Queue C)."""
    long = [13, 1, 6, 2, 7, 9, 9, 4, 2, 6, 5, 9, 3, 7, 11, 2, 8, 4]
    prompts = [[3, 4, 5], long, [7, 7, 1]]
    kw = dict(max_batch=2, max_len=24, prefill_chunk=4)
    assert _tserve(fp_pair, prompts, prefill_budget=3, **kw) == \
        _tserve(fp_pair, prompts, **kw)
    kw = dict(BASE, prefill_chunk=4)
    want = _tserve(fp_pair, PROMPTS, **kw)
    assert _tserve(fp_pair, PROMPTS, prefill_budget=4, **kw) == want
    assert _jserve(fp_pair, PROMPTS, prefill_budget=4, **kw) != want


FAULTS = [("plan", 1), ("launch", 3), ("commit", 3)]


def _faults(cls_fault, cls_plan):
    return cls_plan([cls_fault(site, "raise", at=at) for site, at in FAULTS])


def test_transient_faults_leave_tokens_unchanged(fp_pair):
    """One transient fault at each of plan, launch and commit, under the
    supervisor, on the synchronous engine and on the ``AsyncEngine`` with
    speculative launches: the fault-free tokens.  JAX's retried commit
    advances the recurrent state twice."""
    jcfg, params, tcfg, model = fp_pair
    kw = dict(max_batch=2, max_len=24, prefill_chunk=4)
    prompts = PROMPTS[1:]
    want = _tserve(fp_pair, prompts, **kw)
    assert _jserve(fp_pair, prompts, **kw) == want
    sp = SamplingParams(max_tokens=6, ignore_eos=True)

    plan = _faults(Fault, FaultPlan)

    def factory():
        e = Engine(tcfg, model, ServeConfig(**kw))
        e.fault_hook = plan.engine_hook
        return e

    sup = ServingSupervisor(factory)
    eng = factory()
    sup.attach(eng)
    reqs = [eng.submit(p, sp) for p in prompts]
    sup.drive()
    assert not plan.unfired()
    assert [list(r.output_tokens) for r in reqs] == want
    assert sup.engine.stats().step_retries == len(FAULTS)

    plan = _faults(Fault, FaultPlan)
    eng = factory()

    async def run():
        async with AsyncEngine(eng, supervisor=ServingSupervisor(factory)) as aeng:
            rs = [aeng.submit(p, sp) for p in prompts]
            await aeng.shutdown()
            return [list(r.output_tokens) for r in rs]

    assert asyncio.run(run()) == want
    assert not plan.unfired()
    assert eng.stats().steps_overlapped > 0

    jplan = _faults(JFault, JFaultPlan)

    def jfactory():
        e = JEngine(jcfg, params, JServeConfig(**kw))
        e.fault_hook = jplan.engine_hook
        return e

    jsup = JSupervisor(jfactory)
    jeng = jfactory()
    jsup.attach(jeng)
    jsp = JSamplingParams(max_tokens=6, ignore_eos=True)
    jreqs = [jeng.submit(p, jsp) for p in prompts]
    jsup.drive()
    assert [list(r.output_tokens) for r in jreqs] != want  # the JAX fault


def test_launcher_serves_mamba_contiguous(capsys):
    from repro_torch.launch import serve

    argv = ["--arch", NAME, "--reduced", "--packed", "--device", "cpu",
            "--requests", "3", "--max-tokens", "4", "--prompt-len", "6",
            "--max-batch", "2"]
    with pytest.raises(SystemExit) as ei:
        serve.main(argv)
    assert ei.value.code == 0
    out = capsys.readouterr().out
    assert "[kv-cache] contiguous" in out and "[attn]" not in out

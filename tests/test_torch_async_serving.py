"""The port's async serving loop and TCP front end (``repro_torch.serving.
async_engine`` / ``frontend``), held to the same contract as the JAX
package's in tests/test_async_serving.py, whose cases are repeated here on
the port's engine at the same sizes: token parity with the port's
synchronous ``Engine`` under fuzzed arrivals (stochastic rows included),
overlap actually happening, backpressure, deadlines, cancellation, drain
and the TCP protocol.  The last class runs the JAX ``AsyncEngine`` and the
port's on the same bridged params and arrival schedule: greedy tokens must
be identical."""
import asyncio

import torch
import numpy as np
import pytest

from repro_torch.models import build_model, get_config
from repro_torch.serving.api import FinishReason, SamplingParams
from repro_torch.serving.async_engine import (AsyncEngine, EngineOverloaded,
                                        drive_requests)
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.frontend import FrontendServer, ServeClient


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("qwen1.5-0.5b").reduced(layers=2).replace(
        compute_dtype="float32", param_dtype="float32")
    return cfg, build_model(cfg, gen=torch.Generator().manual_seed(0),
                            device="cpu")


def fuzz_schedule(seed: int, n: int):
    """Seeded arrival schedule: (delay_s, prompt, model, deadline) tuples
    with bursty sub-10ms gaps and mixed sampling model."""
    rng = np.random.default_rng(seed)
    sched = []
    for i in range(n):
        prompt = rng.integers(0, 64, int(rng.integers(3, 18))).tolist()
        sp = SamplingParams(
            max_tokens=int(rng.integers(3, 9)),
            temperature=float(rng.choice([0.0, 0.0, 0.8])),
            top_p=0.9, seed=int(rng.integers(1 << 16)), ignore_eos=True)
        sched.append((float(rng.choice([0.0, 0.0, 0.004])), prompt, sp, None))
    return sched


def run_async(cfg, model, scfg, sched):
    eng = Engine(cfg, model, scfg)

    async def main():
        async with AsyncEngine(eng) as aeng:
            return await drive_requests(aeng, sched)

    res = asyncio.run(main())
    return eng, {uid: [o.token for o in outs if o.token >= 0]
                 for uid, outs in res.items()}


def run_sync(cfg, model, scfg, sched):
    eng = Engine(cfg, model, scfg)
    reqs = [eng.submit(p, sp) for (_, p, sp, _) in sched]
    for _ in eng.stream():
        pass
    return eng, {r.uid: list(r.output_tokens) for r in reqs}


class TestAsyncParity:
    """The acceptance criterion: token-identical outputs vs the sync Engine
    under fuzzed arrival schedules, with overlap actually happening."""

    @pytest.mark.parametrize("seed,scfg_kw", [
        (0, dict(prefill_chunk=8)),
        (1, dict(prefill_chunk=4, prefill_budget=6, prefix_cache=True)),
        # the same fuzzed loop under the shadow block-pool sanitizer: every
        # alloc/share/free/publish transition and write-set validated live
        (2, dict(prefill_chunk=4, prefix_cache=True, sanitize=True)),
    ])
    def test_fuzzed_arrivals_token_parity(self, lm, seed, scfg_kw):
        cfg, model = lm
        scfg = ServeConfig(max_batch=3, max_len=48, kv_block_size=4, **scfg_kw)
        sched = fuzz_schedule(seed, n=7)
        eng_a, got = run_async(cfg, model, scfg, sched)
        _, want = run_sync(cfg, model, scfg, sched)
        assert got == want
        # the loop must actually double-buffer: some steps dispatched
        # before the previous step's sync came back
        assert eng_a.stats().steps_overlapped > 0
        # nothing leaked: every slot free, blocks back (prefix cache keeps
        # published blocks resident but unreferenced)
        assert eng_a.sched.active_slots() == []
        assert eng_a.allocator.blocks_in_use() == (
            0 if eng_a.prefix_cache is None
            else eng_a.prefix_cache.stats()["cached_unreferenced_blocks"])
        if eng_a.shadow is not None:
            # zero leaked blocks at drain, per the shadow's own census
            eng_a.shadow.assert_drained()
            assert eng_a.shadow.stats()["write_checks"] > 0

    def test_step_gap_zero_on_overlapped_steps(self, lm):
        cfg, model = lm
        scfg = ServeConfig(max_batch=2, max_len=48, kv_block_size=4)
        sched = [(0.0, list(range(1, 9)),
                  SamplingParams(max_tokens=12, ignore_eos=True), None)
                 for _ in range(2)]
        eng, _ = run_async(cfg, model, scfg, sched)
        s = eng.stats()
        # overlapped steps have dispatch gap 0 by construction, so with a
        # majority of steady-state decode steps the p50 collapses to 0
        assert s.steps_overlapped > 0
        assert s.step_gap_ms is not None
        assert s.step_gap_ms["p50"] == 0.0


class TestBackpressure:
    def test_submit_past_max_queue_raises(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(max_batch=1, max_len=32))
        aeng = AsyncEngine(eng, max_queue=2)
        # loop not started: submissions pile up in the waiting queue
        aeng.submit([1, 2, 3])
        aeng.submit([1, 2, 3])
        with pytest.raises(EngineOverloaded):
            aeng.submit([1, 2, 3])
        assert aeng.rejected_overload == 1

    def test_submit_while_draining_raises(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(max_batch=1, max_len=32))

        async def main():
            aeng = AsyncEngine(eng)
            async with aeng:
                pass                       # drained on exit
            with pytest.raises(EngineOverloaded):
                aeng.submit([1, 2, 3])

        asyncio.run(main())


class TestDeadlinesAndCancel:
    def test_deadline_expires_while_queued(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model,
                     ServeConfig(max_batch=2, max_len=48, kv_block_size=4))
        sp = SamplingParams(max_tokens=4, ignore_eos=True)
        # deadline 0: expired before the loop ever plans it
        sched = [(0.0, [1, 2, 3, 4], sp, 0.0)]
        eng2 = eng

        async def main():
            async with AsyncEngine(eng2) as aeng:
                return await drive_requests(aeng, sched)

        res = asyncio.run(main())
        (outs,) = res.values()
        assert len(outs) == 1 and outs[0].token == -1
        assert outs[0].finish_reason == FinishReason.DEADLINE
        assert eng2.stats().deadline_expirations == 1

    def test_deadline_expires_mid_flight(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model,
                     ServeConfig(max_batch=1, max_len=64, kv_block_size=4))
        sp = SamplingParams(max_tokens=40, ignore_eos=True)

        async def main():
            async with AsyncEngine(eng) as aeng:
                req = aeng.submit([1, 2, 3, 4], sp, deadline_s=3600.0)
                outs = []
                async for out in aeng.stream(req.uid):
                    outs.append(out)
                    if len(outs) == 2:
                        # force determinism: expire the deadline *now*
                        req.deadline = 0.0
                return req, outs

        req, outs = asyncio.run(main())
        assert outs[-1].finish_reason == FinishReason.DEADLINE
        assert outs[-1].token == -1
        # the tokens streamed before expiry are kept
        assert req.output_tokens == [o.token for o in outs[:-1]]
        assert 2 <= len(outs) - 1 < 40
        assert eng.sched.active_slots() == []
        assert eng.allocator.blocks_in_use() == 0

    def test_cancel_through_stream(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model,
                     ServeConfig(max_batch=1, max_len=64, kv_block_size=4))
        sp = SamplingParams(max_tokens=40, ignore_eos=True)

        async def main():
            async with AsyncEngine(eng) as aeng:
                req = aeng.submit([5, 6, 7], sp)
                outs = []
                async for out in aeng.stream(req.uid):
                    outs.append(out)
                    if len(outs) == 3:
                        aeng.cancel(req.uid)
                return req, outs

        req, outs = asyncio.run(main())
        assert outs[-1].finish_reason == FinishReason.CANCELLED
        assert req.done and req.finish_reason == FinishReason.CANCELLED
        assert eng.stats().cancellations == 1

    def test_graceful_drain_finishes_in_flight(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model,
                     ServeConfig(max_batch=2, max_len=48, kv_block_size=4))
        sp = SamplingParams(max_tokens=5, ignore_eos=True)

        async def main():
            aeng = AsyncEngine(eng)
            async with aeng:
                reqs = [aeng.submit([1, 2, 3], sp), aeng.submit([4, 5], sp)]
                # exit immediately: __aexit__ drains
            return reqs

        reqs = asyncio.run(main())
        for r in reqs:
            assert r.done and r.num_generated == 5


class TestFrontend:
    def test_tcp_roundtrip_stream_and_overload(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model,
                     ServeConfig(max_batch=1, max_len=48, kv_block_size=4))

        async def main():
            async with AsyncEngine(eng, max_queue=1) as aeng:
                async with FrontendServer(aeng) as srv:
                    async with ServeClient(port=srv.port) as c:
                        evs = await c.request([1, 2, 3, 4], max_tokens=4,
                                              temperature=0.0,
                                              ignore_eos=True)
                    return evs

        evs = asyncio.run(main())
        assert [e["index"] for e in evs] == [0, 1, 2, 3]
        assert evs[-1]["finished"] and evs[-1]["finish_reason"] == "length"

    def test_resume_on_actively_streamed_uid_rejected(self, lm):
        """A resume on a uid another connection is pumping must be a typed
        protocol error — adopting the queue would drop events the original
        consumer owns and leave two pumps racing on one asyncio.Queue."""
        cfg, model = lm
        eng = Engine(cfg, model,
                     ServeConfig(max_batch=1, max_len=512, kv_block_size=4))

        async def main():
            async with AsyncEngine(eng) as aeng:
                async with FrontendServer(aeng) as srv:
                    c1 = await ServeClient(port=srv.port).connect()
                    await c1._send({"prompt": [1, 2, 3], "max_tokens": 1000,
                                    "ignore_eos": True})
                    ack = await c1._recv()
                    uid = ack["uid"]
                    first = await c1._recv()       # stream is live
                    async with ServeClient(port=srv.port) as c2:
                        evs = await c2.resume(uid, offset=0)
                    # the original stream is unharmed: cancel through it
                    # and drain to its terminal marker
                    await c1._send({"cancel": uid})
                    seen = [first]
                    while not seen[-1].get("finished"):
                        seen.append(await c1._recv())
                    await c1.close()
                    return evs, seen

        evs, seen = asyncio.run(main())
        assert evs == [{"error": "resume uid busy"}]
        assert seen[-1]["finish_reason"] == "cancelled"
        # no token was diverted to the rejected connection: indices on the
        # original connection are gapless from 0
        idx = [e["index"] for e in seen if e["token"] >= 0]
        assert idx == list(range(len(idx)))

    def test_disconnect_mid_stream_cancels(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model,
                     ServeConfig(max_batch=1, max_len=512, kv_block_size=4))

        async def main():
            async with AsyncEngine(eng) as aeng:
                async with FrontendServer(aeng) as srv:
                    c = await ServeClient(port=srv.port).connect()
                    # enough runway (~500 tokens to the max_len cap) that the
                    # request cannot finish normally before the EOF lands,
                    # even on a loaded box
                    await c._send({"prompt": [1, 2, 3], "max_tokens": 1000,
                                   "ignore_eos": True})
                    await c._recv()               # ack
                    await c._recv()               # one streamed token
                    await c.close()               # vanish mid-stream
                    for _ in range(1500):
                        await asyncio.sleep(0.02)
                        if not eng._requests:
                            break
            return eng.stats()

        st = asyncio.run(main())
        assert not eng._requests, "disconnect never tore down the request"
        assert st.cancellations == 1
        assert eng.sched.active_slots() == []
        assert eng.allocator.blocks_in_use() == 0


class TestAgainstJaxAsyncEngine:
    def test_same_greedy_tokens_as_the_jax_async_engine(self):
        """The JAX ``AsyncEngine`` and the port's, on the same params (JAX
        init bridged into the port) and the same arrival schedule: greedy
        tokens identical request for request."""
        import jax
        from repro.models import build_model as jbuild
        from repro.models import get_config as jget
        from repro.serving.api import SamplingParams as JSamplingParams
        from repro.serving.async_engine import AsyncEngine as JAsyncEngine
        from repro.serving.async_engine import drive_requests as jdrive
        from repro.serving.engine import Engine as JEngine
        from repro.serving.engine import ServeConfig as JServeConfig
        from repro_torch.bridge import jax_params_to_torch

        jcfg = jget("qwen1.5-0.5b").reduced(layers=2).replace(
            compute_dtype="float32", param_dtype="float32")
        jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
        tcfg = get_config("qwen1.5-0.5b").reduced(layers=2).replace(
            compute_dtype="float32", param_dtype="float32")
        tmodel = jax_params_to_torch(
            tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        kw = dict(max_batch=3, max_len=48, kv_block_size=4, prefill_chunk=4,
                  prefix_cache=True)
        sched = [(d, p, SamplingParams(max_tokens=sp.max_tokens,
                                       ignore_eos=True), None)
                 for d, p, sp, _ in fuzz_schedule(4, n=6)]
        jsched = [(d, p, JSamplingParams(max_tokens=sp.max_tokens,
                                         ignore_eos=True), None)
                  for d, p, sp, _ in sched]

        async def jmain(eng):
            async with JAsyncEngine(eng) as aeng:
                return await jdrive(aeng, jsched)

        jres = asyncio.run(jmain(JEngine(jcfg, jparams,
                                         JServeConfig(paged=True, **kw))))
        want = {uid: [o.token for o in outs if o.token >= 0]
                for uid, outs in jres.items()}
        eng, got = run_async(tcfg, tmodel, ServeConfig(**kw), sched)
        assert got == want
        assert eng.stats().steps_overlapped > 0


class TestServeLauncher:
    ARGV = ["--arch", "qwen1.5-0.5b", "--reduced", "--packed", "--device",
            "cpu", "--requests", "3", "--max-tokens", "6", "--prompt-len",
            "8", "--max-batch", "2"]

    def test_cli_load_run_matches_the_synchronous_engine(self):
        """``python -m repro_torch.launch.serve`` in process: the load
        generator's greedy tokens (TCP front end, async loop) equal the
        port's synchronous ``Engine`` on the same seeded model and prompts,
        and ``main`` exits 0."""
        from repro_torch.launch import serve

        args = serve.parse_args(self.ARGV)
        results = asyncio.run(serve.run_load(serve.build_engine(args), args))
        got = [[e["token"] for e in evs if e.get("token", -1) >= 0]
               for evs in results]
        eng = serve.build_engine(args)
        draw = serve.make_prompt_source(args)
        reqs = [eng.submit(draw(), SamplingParams(max_tokens=6))
                for _ in range(3)]
        for _ in eng.stream():
            pass
        assert got == [list(r.output_tokens) for r in reqs]
        assert all(len(t) >= 1 for t in got)
        with pytest.raises(SystemExit) as ei:
            serve.main(self.ARGV)
        assert ei.value.code == 0

    def test_contiguous_kv_and_non_attention_stacks_raise(self):
        """``--contiguous-kv`` and a mamba stack resolve to the contiguous
        cache, as in the JAX launcher; each raises where it asks for what
        only the paged pools have (the prefix cache, the sanitizer)."""
        from repro_torch.launch import serve

        mamba = ["--arch", "mamba2-780m", "--reduced", "--device", "cpu"]
        for argv in (self.ARGV + ["--contiguous-kv"], mamba):
            assert serve.build_engine(serve.parse_args(argv)).paged is False
            for extra in (["--prefix-cache"], ["--sanitize"]):
                with pytest.raises(ValueError, match="paged"):
                    serve.build_engine(serve.parse_args(argv + extra))

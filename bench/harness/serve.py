"""Serving cells: the packed ternary student served by the port's
``AsyncEngine`` over its ``Engine`` (paged KV cache, chunked prefill, the
``fused`` kernel route, greedy sampling), in-process, under closed-loop
clients (asyncio tasks) or an open-loop arrival schedule.  Every streamed
token is timestamped on the benchmark's clock.

Set-up: master weights from the seed on the device, loaded into a QAT model
and packed by ``serving/engine.py::convert_to_packed``; the engine built;
the warm-up wave (``traffic["warmup"]``: one request a client, outputs
spread so the loop is staggered) served until every one of its requests
has its first token.  Then the window opens; requests submitted inside it
are the window's.  When it closes the clients stop submitting, the window's
requests are waited for until each has its first token (a minute at most),
and the rest is cancelled.  ``correct``: the reference over a seeded
sample of finished requests, the longest among them (``reference/
serve_check.py``), and no failed request."""
from __future__ import annotations

import asyncio
import gc
import time
from typing import List

import torch

from harness import traffic as gen
from harness.context import Context, port_config
from harness.record import Request, Run
from harness.weights import model_weights

FINISHED = ("LENGTH", "STOP")


def build(ctx: Context):
    """(engine, packed model, student master weights)."""
    from repro_torch.core import quant as Q
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.engine import convert_to_packed
    dev = torch.device(ctx.device)
    base = port_config(ctx.config)
    _, student = model_weights(ctx.config, ctx.seed, dev)
    qcfg = base.with_quant(Q.QuantConfig(mode="qat", use_kernel=True))
    qat = build_model(qcfg, device=dev)
    qat.load_state_dict(student, strict=True)
    _, model = convert_to_packed(qcfg, qat)
    del qat
    if dev.type == "cuda":
        from repro_torch.kernels.build import build as build_kernels
        build_kernels()                 # a checkout's first run compiles here
    eng_cfg = dict(ctx.traffic["engine"])
    scfg = ServeConfig(attn_impl="fused", cache_dtype=base.compute_dtype,
                       seed=ctx.seed & 0x7FFFFFFF, **eng_cfg)
    eng = Engine(model.cfg, model, scfg)
    if eng.attn_impl != "fused" or not eng.paged:
        raise RuntimeError(f"engine resolved attn_impl={eng.attn_impl!r}, "
                           f"paged={eng.paged}")
    return eng, model, student


def _count_decode_steps(eng, run: Run) -> None:
    """Count, by request, the decode steps it had a row in: a step with no
    prefill chunk, whose attention is ``paged_attention``'s (a chunk step
    runs every row through ``paged_prefill``).  The check reads it."""
    decode = eng._launch_decode
    counts = run.extra.setdefault("decode_steps", {})

    def wrapped(plan, feed=None):
        for slot in plan.active:
            uid = plan.owners[slot]
            counts[uid] = counts.get(uid, 0) + 1
        return decode(plan, feed)
    eng._launch_decode = wrapped


def _record_steps(eng, run: Run) -> None:
    """Each launched step's useful rows: (tokens run, resident positions
    before them, sampled), for ``step_mfu.serve``."""
    launch = eng.launch_step
    sched = eng.sched

    def wrapped(plan, feed=None):
        t = time.perf_counter()
        rows = []
        for slot in plan.active:
            pos = int(plan.positions[slot])
            n = plan.chunks.get(slot)
            if n is not None:
                rows.append((n, pos, n == len(sched.pending[slot])))
            elif slot not in plan.stalled:
                rows.append((1, pos, True))
        run.steps.append({"t": t, "rows": rows})
        return launch(plan, feed)
    eng.launch_step = wrapped


async def _serve(ctx: Context, eng, run: Run) -> None:
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.async_engine import AsyncEngine
    from repro_torch.kernels import boundary
    tr = ctx.traffic
    loop_spec = tr["loop"]
    vocab = ctx.config["vocab_size"]
    warm, pool = gen.serve_requests(tr, vocab, ctx.seed)
    aeng = AsyncEngine(eng)
    aeng.start()
    state = {"next": 0, "stop": False}
    consumers: List[asyncio.Task] = []

    def submit(prompt, max_tokens) -> Request:
        r = Request(uid=-1, prompt=prompt, max_tokens=max_tokens)
        r.submit = time.perf_counter()
        g = aeng.submit(prompt, SamplingParams(max_tokens=max_tokens, ignore_eos=True))
        r.uid = g.uid
        run.requests.append(r)
        return r

    async def consume(r: Request) -> None:
        async for out in aeng.stream(r.uid):
            if out.token >= 0:
                r.times.append(time.perf_counter())
                r.tokens.append(out.token)
            if out.finished:
                r.reason = out.finish_reason.name if out.finish_reason else "STOP"

    def take():
        item = pool[state["next"] % len(pool)]
        state["next"] += 1
        return item

    async def client(r: Request):
        await consume(r)
        while not state["stop"]:
            r = submit(*take())
            await consume(r)

    async def open_loop(gaps):
        due = time.perf_counter()
        limit = asyncio.Semaphore(int(loop_spec.get("clients", 1 << 30)))
        for g in gaps:
            due += g
            await asyncio.sleep(max(0.0, due - time.perf_counter()))
            if state["stop"]:
                return
            await limit.acquire()
            r = submit(*take())
            r.submit = due            # latency counts from when it was due
            t = asyncio.ensure_future(consume(r))
            t.add_done_callback(lambda _: limit.release())
            consumers.append(t)

    closed = loop_spec["type"] == "closed"
    first_wave = [submit(*w) for w in warm]
    tasks = [asyncio.ensure_future(client(r) if closed else consume(r))
             for r in first_wave]
    while not all(r.times or r.reason for r in first_wave):
        await asyncio.sleep(0.005)
    ctx.sync()
    obs = run.kernels
    if run.trace:
        from repro_torch.serving.tracing import Tracer
        eng.tracer = Tracer(clock=eng.clock)
        run.tracer = eng.tracer
        boundary.set_observer(obs)
        run.device.start(ctx.device)
        obs.recording = True
    run.t_open = time.perf_counter()
    run.setup_s = run.t_open - ctx.t_start
    if not closed:
        gaps = gen.arrival_gaps(loop_spec, len(pool), ctx.seed)
        tasks.append(asyncio.ensure_future(open_loop(gaps)))
    await asyncio.sleep(max(0.0, run.t_open + ctx.seconds - time.perf_counter()))
    state["stop"] = True
    run.t_close = time.perf_counter()
    if run.trace:
        obs.recording = False
        run.device.stop(run.t_open, run.t_close, ctx.device)
        boundary.set_observer(None)
    mine = [r for r in run.requests if run.inside(r.submit)]
    deadline = time.perf_counter() + 60.0
    while time.perf_counter() < deadline and \
            not all(r.times or r.reason for r in mine):
        await asyncio.sleep(0.005)
    await aeng.shutdown(drain=False)
    done = await asyncio.gather(*tasks, *consumers, return_exceptions=True)
    errors = [e for e in done if isinstance(e, Exception)]
    if errors:                          # a client that broke is no result
        raise errors[0]


def run(ctx: Context) -> None:
    dev = ctx.device
    torch.manual_seed(ctx.seed & 0x7FFFFFFF)
    eng, model, student = build(ctx)
    run = Run(ctx.cell.name, ctx.config, ctx.traffic, ctx.seconds, trace=ctx.trace)
    ctx.run = run
    _count_decode_steps(eng, run)
    if ctx.trace:
        for attr, name in (("plan_step", "engine.plan"), ("plan_spec", "engine.plan"),
                           ("commit_step", "engine.commit"),
                           ("sync_tokens", "engine.sync")):
            run.spans.wrap(eng, attr, name)
        _record_steps(eng, run)
        run.spans.wrap(eng, "launch_step", "engine.launch")
    asyncio.run(_serve(ctx, eng, run))
    st = eng.stats()
    ctx.readings["engine"] = dict(
        steps=st.steps_committed, overlapped=st.steps_overlapped,
        tokens=st.tokens_generated, prefill_chunks=st.prefill_chunks,
        preemptions=st.preemptions, prefix_cache=st.prefix_cache,
        window_tokens=sum(1 for r in run.requests for t in r.times if run.inside(t)),
        window_requests=sum(1 for r in run.requests if run.inside(r.submit)))
    mine = [r for r in run.requests if run.inside(r.submit)]
    ctx.attempted = len(mine)
    ctx.failed = sum(1 for r in mine if not r.times or
                     (r.reason is not None and r.reason not in FINISHED + ("CANCELLED",)))
    if dev == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del eng, model
    gc.collect()                        # the engine's reference cycles too
    if dev == "cuda":
        torch.cuda.empty_cache()
    judge(ctx, run, student)


def sample(run: Run, seed: int, tokens: int) -> List[Request]:
    """A seeded sample of the finished requests, the longest among them and
    the one with the most decode steps (``paged_attention``'s), until it
    holds ``tokens`` served tokens."""
    done = [r for r in run.requests if r.reason in FINISHED and r.tokens]
    if not done:
        return []
    decode = run.extra.get("decode_steps", {})
    longest = max(done, key=lambda r: len(r.prompt) + len(r.tokens))
    most = max(done, key=lambda r: decode.get(r.uid, 0))
    first = [longest] + ([most] if most is not longest and decode.get(most.uid) else [])
    rest = [r for r in done if all(r is not f for f in first)]
    order = gen.rng_of(seed, 3).permutation(len(rest))
    out, n = first, sum(len(r.tokens) for r in first)
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def judge(ctx: Context, run: Run, student) -> None:
    from reference import serve_check
    picked = sample(run, ctx.seed, int(ctx.traffic["check"]["tokens"]))
    if not picked:
        ctx.check("widest_gap", float("nan"))
        return
    got = serve_check.gaps(student, ctx.config,
                           [(r.prompt, r.tokens) for r in picked], ctx.device)
    widest = max(max(g) for g in got)
    decode = run.extra["decode_steps"]
    ctx.readings.update(checked_requests=len(picked),
                        checked_tokens=sum(len(g) for g in got),
                        checked_decode_tokens=sum(min(decode.get(r.uid, 0), len(r.tokens))
                                                  for r in picked))
    ctx.check("widest_gap", widest)
    ctx.check("failed_requests", ctx.failed)

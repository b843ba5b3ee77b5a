"""Serving launcher: the async engine behind a JSON-lines TCP endpoint, plus
a many-client load generator that drives it.  Port of
``repro/launch/serve.py`` with the same flags and exit codes, and
``--device`` (default ``cuda``; the CPU must be asked for).

Standing server on the card (graceful drain on Ctrl-C or SIGTERM; protocol
in serving/frontend.py):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --packed --serve --port 8471

Load generator, one TCP client per request; closed loop (every arrival at
t=0, drain), here on the CPU at the small config:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --reduced --packed --device cpu --requests 3 --max-tokens 6 \
        --prompt-len 8 --max-batch 2

``--arrival-rate R`` makes it open loop (Poisson arrivals at R req/s).
The student is the QAT model from a ``torch.Generator`` seeded with 0;
``--packed`` converts it with the port's per-layer
``convert_to_packed``, so every projection runs the w2a8 kernel on the card.
Compute and KV cache take the config's compute dtype (bf16 at full width,
fp32 for ``--reduced``).  The port serves attention-only stacks through the
paged cache: ``--contiguous-kv``, or an arch with another mixer, raises a
``ValueError`` (the contiguous cache is ROADMAP Queue A 21b).

``--prefix-cache`` / ``--shared-prefixes``, ``--prefill-chunk`` /
``--prefill-budget``, ``--max-queue``, ``--deadline-ms``, ``--supervise``
(retry, quarantine, snapshot-restore, load shedding), ``--sanitize`` /
``--kv-checksums``, ``--trace`` (Chrome trace events), ``--metrics-interval``,
``--flight-dir`` and ``--journal-dir`` (write-ahead journal with replay and
the front end's ``resume``) behave as in the JAX launcher.  Exit codes: 0 =
clean drain (SIGTERM is treated as Ctrl-C), 17 = the supervisor's restart
budget was exhausted (``EngineCrash``).
"""
from __future__ import annotations

import argparse
import asyncio
import signal
import sys
import time
from collections import Counter

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.kernels.paged_attention import kernel as paged_decode_k
from repro_torch.kernels.paged_prefill import kernel as paged_prefill_k
from repro_torch.kernels.w2a8_gemv import kernel as w2a8_k
from repro_torch.models import build_model
from repro_torch.models.base import get_config
from repro_torch.nn.module import resolve_device
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.async_engine import AsyncEngine
from repro_torch.serving.engine import Engine, ServeConfig, convert_to_packed
from repro_torch.serving.frontend import FrontendServer, ServeClient
from repro_torch.serving.supervisor import (EngineCrash, ServingSupervisor,
                                      SupervisorConfig)
from repro_torch.serving.tracing import Tracer

# Distinct exit codes so process supervisors (systemd, the crash soak) can
# tell a clean drain from a give-up: 0 = graceful shutdown (Ctrl-C/SIGTERM
# drain, journal clean-shutdown record written), 17 = the supervisor's
# restart budget was exhausted (EngineCrash) — restartable with backoff.
EXIT_CLEAN_DRAIN = 0
EXIT_RESTART_EXHAUSTED = 17

# the kernels a packed attention-only student serves through; main() zeroes
# their launch counters once the engine is built, print_stats() reports them
SERVING_KERNELS = (w2a8_k.launches, paged_decode_k.launches,
                   paged_prefill_k.launches)


def build_engine(args) -> Engine:
    if args.contiguous_kv:
        raise ValueError(
            "--contiguous-kv: the port serves through the paged KV cache "
            "only; the contiguous cache is not ported yet (ROADMAP Queue A "
            "21b)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.block_kv is not None:
        cfg = cfg.replace(block_kv=args.block_kv)
    cfg = cfg.with_quant(Q.QuantConfig(mode="qat", use_kernel=True))
    if any(s.mixer != "attn" for s in cfg.resolved_pattern()):
        raise ValueError(
            f"--arch {args.arch}: the port serves attention-only stacks "
            "through the paged KV cache; the contiguous cache its mixers "
            "need is not ported yet (ROADMAP Queue A 21b)")
    model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    if args.packed:
        cfg, model = convert_to_packed(cfg, model)
        print("[packed] ternary 2-bit weights")
    prompt_len = args.prompt_len
    if args.shared_prefixes > 0:
        prompt_len = args.shared_prefix_len + args.tail_len
    scfg = ServeConfig(max_batch=args.max_batch,
                       max_len=prompt_len + args.max_tokens,
                       temperature=args.temperature, top_p=args.top_p,
                       cache_dtype=cfg.compute_dtype,
                       prefill_chunk=args.prefill_chunk,
                       prefill_budget=args.prefill_budget,
                       kv_block_size=args.kv_block_size,
                       num_kv_blocks=args.num_kv_blocks,
                       attn_impl=args.attn_impl,
                       prefix_cache=args.prefix_cache,
                       prefix_cache_blocks=args.prefix_cache_blocks,
                       sanitize=args.sanitize,
                       kv_checksums=args.kv_checksums,
                       journal_dir=args.journal_dir)
    eng = Engine(cfg, model, scfg)
    mode = f"paged bs={scfg.kv_block_size} blocks={scfg.pool_blocks()}"
    if eng.prefix_cache is not None:
        mode += ", radix prefix cache"
    if eng.shadow is not None:
        mode += ", sanitized"
    print(f"[kv-cache] {mode}, {scfg.cache_dtype}, "
          f"{eng.kv_cache_bytes() / 2**20:.2f} MiB")
    print(f"[attn] decode impl = {eng.attn_impl} on {dev}"
          + (" (the kernels' plain versions)" if eng.attn_impl == "fused"
             and dev.type == "cpu" else ""))
    if getattr(args, "trace", None):
        eng.tracer = Tracer(clock=eng.clock)
        print(f"[trace] recording spans -> {args.trace}")
    if eng.journal is not None:
        print(f"[journal] write-ahead request journal -> {args.journal_dir}")
    return eng


def make_prompt_source(args):
    """Prompt generator for the load modes.  With --shared-prefixes N, every
    prompt is one of N fixed system prefixes plus a random tail — the
    workload the radix prefix cache collapses (each admission re-prefills
    only the tail once its prefix is resident)."""
    rng = np.random.default_rng(0)
    if args.shared_prefixes > 0:
        systems = [rng.integers(0, 64, args.shared_prefix_len).tolist()
                   for _ in range(args.shared_prefixes)]

        def draw():
            sys_p = systems[int(rng.integers(len(systems)))]
            return sys_p + rng.integers(0, 64, args.tail_len).tolist()
        return draw
    return lambda: rng.integers(0, 64, args.prompt_len).tolist()


def _pct_line(tag: str, d) -> str:
    return (f"[{tag}] mean {d['mean']:.0f} ms  p50 {d['p50']:.0f} ms  "
            f"p95 {d['p95']:.0f} ms  p99 {d['p99']:.0f} ms")


def print_stats(eng: Engine) -> None:
    s = eng.stats()
    line = (f"[stats] admissions={s.admissions} preemptions={s.preemptions} "
            f"prefill_positions={s.prefill_positions} "
            f"prefill_chunks={s.prefill_chunks} "
            f"skipped_via_prefix={s.prefill_positions_skipped} "
            f"tokens={s.tokens_generated} queue_depth={s.queue_depth}")
    if s.cancellations or s.deadline_expirations:
        line += (f" cancellations={s.cancellations} "
                 f"deadline_expirations={s.deadline_expirations}")
    if s.blocks_in_use is not None:
        line += f" blocks_in_use={s.blocks_in_use} blocks_free={s.blocks_free}"
    print(line)
    if eng.device.type == "cuda":
        print("[kernels] launches " + " ".join(
            f"{c.name}={c.count}" for c in SERVING_KERNELS))
    if s.steps_committed:
        print(f"[steps] committed={s.steps_committed} "
              f"overlapped={s.steps_overlapped} "
              f"({100.0 * s.steps_overlapped / s.steps_committed:.0f}% "
              "dispatched before the previous sync)")
    for tag, d in (("ttft", s.ttft_ms), ("queue-wait", s.queue_wait_ms),
                   ("e2e", s.e2e_latency_ms), ("step-gap", s.step_gap_ms)):
        if d is not None:
            print(_pct_line(tag, d))
    if s.prefix_cache is not None:
        pc = s.prefix_cache
        print(f"[prefix-cache] hits={pc['hits']} misses={pc['misses']} "
              f"evictions={pc['evictions']} "
              f"tokens_matched={pc['tokens_matched']} "
              f"cached_blocks={pc['cached_blocks']} "
              f"(unreferenced {pc['cached_unreferenced_blocks']})")
    if (s.step_failures or s.step_retries or s.quarantines
            or s.engine_restarts or s.load_sheds or s.hung_steps
            or s.degrade_tier):
        print(f"[robustness] step_failures={s.step_failures} "
              f"retries={s.step_retries} quarantines={s.quarantines} "
              f"restarts={s.engine_restarts} load_sheds={s.load_sheds} "
              f"hung_steps={s.hung_steps} degrade_tier={s.degrade_tier}")
        if s.recovery_ms is not None:
            print(_pct_line("recovery", s.recovery_ms))


def metrics_line(eng: Engine) -> str:
    """One compact live-metrics log line (the --metrics-interval output),
    read straight off the engine's registry snapshot."""
    m = eng.metrics.snapshot()
    ttft = m["serving_ttft_ms"]
    e2e = m["serving_e2e_latency_ms"]
    return (f"[metrics] requests={m['serving_requests_submitted_total']} "
            f"steps={m['serving_steps_committed_total']} "
            f"tokens={m['serving_tokens_generated_total']} "
            f"queue={m['serving_queue_depth']} "
            f"active={m['serving_active_slots']} "
            f"ttft_p50={ttft['p50']:.0f}ms "
            f"e2e_p95={e2e['p95']:.0f}ms")


async def _metrics_logger(aeng: AsyncEngine, interval: float) -> None:
    """Periodic live-metrics line while serving (``--metrics-interval``)."""
    while True:
        await asyncio.sleep(interval)
        print(metrics_line(aeng.engine))


def _start_metrics_logger(aeng: AsyncEngine, args):
    iv = getattr(args, "metrics_interval", None)
    if not iv or iv <= 0:
        return None
    return asyncio.ensure_future(_metrics_logger(aeng, iv))


async def _stop_metrics_logger(task) -> None:
    if task is None:
        return
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)


def export_trace(eng: Engine, args) -> None:
    """Write the Chrome trace-event file at end of run (``--trace``)."""
    path = getattr(args, "trace", None)
    if not path or eng.tracer is None:
        return
    doc = eng.tracer.export(path)
    counts = doc["otherData"]["counts"]
    print(f"[trace] wrote {len(doc['traceEvents'])} events -> {path} "
          f"(requests={counts['request']} steps={counts['step']} "
          f"prefill_chunks={counts['prefill_chunk']}) — load in "
          "https://ui.perfetto.dev or chrome://tracing")


async def run_load(eng: Engine, args) -> list:
    """Many-client load generator through the TCP front-end: one connection
    per request, arrivals on a schedule.  ``--arrival-rate 0`` is the closed
    loop (every arrival at t=0, drain); ``> 0`` draws Poisson inter-arrival
    gaps (open loop).  Arrival sleeps are exact asyncio timers — the event
    loop idles precisely until the next arrival instead of busy-polling.
    Returns each request's event lines, in prompt order."""
    draw = make_prompt_source(args)
    rng = np.random.default_rng(0)
    if args.arrival_rate > 0:
        arrivals = np.cumsum(
            rng.exponential(1.0 / args.arrival_rate, args.requests))
    else:
        arrivals = np.zeros(args.requests)
    prompts = [draw() for _ in range(args.requests)]
    results = [None] * args.requests
    # client-side arrival time of every token event, per request
    arrived = [[] for _ in range(args.requests)]

    sup = _make_supervisor(eng, args)
    async with AsyncEngine(eng, max_queue=args.max_queue,
                           supervisor=sup) as aeng:
        metrics_task = _start_metrics_logger(aeng, args)
        async with FrontendServer(aeng) as srv:
            t0 = time.perf_counter()

            async def one_client(i: int) -> None:
                delay = arrivals[i] - (time.perf_counter() - t0)
                if delay > 0:
                    await asyncio.sleep(delay)
                def on_event(e, i=i):
                    if e.get("token", -1) < 0:
                        return
                    arrived[i].append(time.perf_counter())
                    if args.stream:
                        print(f"  [uid {e['uid']} #{e['index']}] "
                              f"{e['token']}"
                              + (f"  <{e['finish_reason']}>"
                                 if e.get("finished") else ""))
                async with ServeClient(port=srv.port) as c:
                    results[i] = await c.request(
                        prompts[i], max_tokens=args.max_tokens,
                        temperature=args.temperature, top_p=args.top_p,
                        deadline_ms=args.deadline_ms, on_event=on_event)

            await asyncio.gather(*(one_client(i)
                                   for i in range(args.requests)))
            dt = time.perf_counter() - t0
        await _stop_metrics_logger(metrics_task)
        eng = aeng.engine        # a supervisor restart swaps the engine

    n_tok = sum(sum(1 for e in evs if e.get("token", -1) >= 0)
                for evs in results if evs)
    reasons = Counter(evs[-1].get("finish_reason") for evs in results if evs)
    mode = (f"open loop at {args.arrival_rate:.1f} req/s"
            if args.arrival_rate > 0 else "closed loop")
    print(f"{mode}: {args.requests} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s)")
    gaps = sorted(1e3 * (b - a) for ts in arrived for a, b in zip(ts, ts[1:]))
    if gaps:
        def q(f):
            return gaps[min(len(gaps) - 1, int(f * len(gaps)))]
        print(f"[inter-token] client side: p50 {q(0.5):.1f} ms  "
              f"p99 {q(0.99):.1f} ms over {len(gaps)} gaps")
    print("finish reasons: "
          + "  ".join(f"{k}={v}" for k, v in sorted(reasons.items())))
    if args.deadline_ms is not None:
        met = sum(v for k, v in reasons.items() if k in ("stop", "length"))
        print(f"goodput: {met}/{args.requests} met the "
              f"{args.deadline_ms:.0f} ms deadline "
              f"({met / max(dt, 1e-9):.2f} good req/s)")
    print_stats(eng)
    export_trace(eng, args)
    return results


def _make_supervisor(eng: Engine, args):
    """--supervise: a ServingSupervisor whose factory rebuilds an identical
    engine (same config and weights) for snapshot-restore after a crash."""
    if not getattr(args, "supervise", False):
        return None
    cfg, model, scfg = eng.cfg, eng.model, eng.scfg
    sup_cfg = None
    if getattr(args, "flight_dir", None):
        sup_cfg = SupervisorConfig(flight_dir=args.flight_dir)
    # the factory shares the model module: a restart copies no weights
    return ServingSupervisor(lambda: Engine(cfg, model, scfg), sup_cfg)


async def run_server(eng: Engine, args) -> None:
    """Standing endpoint: serve until interrupted, then drain gracefully
    (stop admitting, finish in-flight requests, report stats).

    SIGTERM is handled exactly like Ctrl-C: the server stops accepting,
    in-flight requests run to completion, and — when a journal is armed —
    the clean-shutdown record is written so the next launch knows no replay
    is needed.  With ``--journal-dir``, unfinished requests from a previous
    (crashed) process are replayed into this engine before the listener
    opens, and the front-end serves ``resume`` lines against that recovery
    report (exactly-once reconnect streams)."""
    recovery = None
    if eng.journal is not None:
        from repro_torch.serving.recovery import reconcile, replay_journal
        recovery = replay_journal(eng)
        if recovery.resumed:
            print(f"[journal] replayed {len(recovery.resumed)} unfinished "
                  f"request(s), {recovery.forced_tokens} committed tokens "
                  f"forced as prefix ({recovery.replay_ms:.1f} ms)")
            reconcile(recovery, eng, flight_dir=getattr(args, "flight_dir",
                                                        None))
    aeng = AsyncEngine(eng, max_queue=args.max_queue,
                       supervisor=_make_supervisor(eng, args))
    async with aeng:
        if recovery is not None:
            for uid in recovery.resumed:
                aeng.adopt_stream(uid)
        metrics_task = _start_metrics_logger(aeng, args)
        async with FrontendServer(
                aeng, host=args.host, port=args.port,
                defaults=SamplingParams(max_tokens=args.max_tokens,
                                        temperature=args.temperature,
                                        top_p=args.top_p),
                default_deadline_ms=args.deadline_ms,
                recovery=recovery) as srv:
            print(f"[serve] listening on {args.host}:{srv.port} "
                  f"(max_queue={args.max_queue}) — SIGTERM or Ctrl-C to "
                  "drain and exit")
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            try:
                loop.add_signal_handler(signal.SIGTERM, stop.set)
            except (NotImplementedError, RuntimeError):
                pass  # non-POSIX loop: Ctrl-C still drains
            try:
                await stop.wait()
                print("[serve] SIGTERM: draining...")
            except (KeyboardInterrupt, asyncio.CancelledError):
                print("[serve] draining...")
            finally:
                try:
                    loop.remove_signal_handler(signal.SIGTERM)
                except (NotImplementedError, RuntimeError, ValueError):
                    pass
        await _stop_metrics_logger(metrics_task)
    print_stats(aeng.engine)
    export_trace(aeng.engine, args)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrivals (req/s); 0 = closed loop")
    ap.add_argument("--serve", action="store_true",
                    help="run the standing TCP endpoint instead of the "
                         "load generator (JSON lines; serving/frontend.py)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="--serve bind address")
    ap.add_argument("--port", type=int, default=8471,
                    help="--serve TCP port (0 = ephemeral)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound on the waiting queue; submits past it are "
                         "rejected immediately (backpressure, default "
                         "unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: requests not finished within "
                         "this many ms end with finish_reason=deadline")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens a prefilling slot advances per "
                         "engine step, interleaved with decode (0 = whole-"
                         "prompt stop-the-world admission prefill)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="cap on total chunk tokens per engine step across "
                         "all slots (default: per-slot --prefill-chunk only)")
    ap.add_argument("--contiguous-kv", action="store_true",
                    help="per-slot contiguous KV regions instead of the "
                         "paged block pool (not ported: raises)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per paged-KV block")
    ap.add_argument("--num-kv-blocks", type=int, default=None,
                    help="paged-KV pool size incl. trash block "
                         "(default: full capacity)")
    ap.add_argument("--attn-impl", choices=("auto", "fused", "gather"),
                    default="auto",
                    help="paged attention: the fused CUDA kernels vs the "
                         "dense block-table gather (auto = fused on the "
                         "card)")
    ap.add_argument("--block-kv", type=int, default=None,
                    help="override Attention.block_kv (KV block length of "
                         "the blocked/flash prefill impl)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache: share KV blocks of repeated "
                         "prompt prefixes across requests (paged only)")
    ap.add_argument("--prefix-cache-blocks", type=int, default=None,
                    help="cap on blocks the prefix cache may keep resident "
                         "(default: unbounded, evict only on pool pressure)")
    ap.add_argument("--supervise", action="store_true",
                    help="wrap the async loop in a ServingSupervisor: step "
                         "retry with backoff, quarantine of poisoned "
                         "requests, snapshot-restore of the engine on host-"
                         "loop crashes, and graceful load shedding under "
                         "sustained pressure (serving/supervisor.py)")
    ap.add_argument("--sanitize", action="store_true",
                    help="shadow the paged block pool (repro_torch.analysis): "
                         "validate every alloc/share/free/publish transition "
                         "and each step's KV write-set; violations raise "
                         "SanitizerError (debug/CI knob, paged only)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-request and per-step spans and write "
                         "a Chrome trace-event JSON file at end of run "
                         "(load in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-interval", type=float, default=None,
                    metavar="SEC",
                    help="print a live metrics line from the engine's "
                         "registry every SEC seconds while serving")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="with --supervise: write a flight-recorder dump "
                         "(flight-<seq>-<reason>.json) to DIR on every "
                         "recovery action")
    ap.add_argument("--journal-dir", default=None, metavar="DIR",
                    help="write-ahead request journal: accepted requests "
                         "and committed tokens are fsync'd to DIR before "
                         "delivery; a relaunch on the same DIR replays "
                         "unfinished requests and serves client 'resume' "
                         "lines (serving/journal.py, serving/recovery.py)")
    ap.add_argument("--kv-checksums", action="store_true",
                    help="with --sanitize: per-block KV checksums in the "
                         "shadow pool — device-memory corruption is "
                         "detected at step boundaries and recovered by "
                         "recompute-preemption")
    ap.add_argument("--shared-prefixes", type=int, default=0,
                    help="load-gen: draw every prompt from N shared system "
                         "prefixes plus a random tail (0 = fully random "
                         "prompts of --prompt-len)")
    ap.add_argument("--shared-prefix-len", type=int, default=32,
                    help="tokens per shared system prefix")
    ap.add_argument("--tail-len", type=int, default=8,
                    help="random per-request tail tokens after a shared "
                         "prefix")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu must be asked for)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    eng = build_engine(args)
    for c in SERVING_KERNELS:
        c.reset()
    try:
        if args.serve:
            try:
                asyncio.run(run_server(eng, args))
            except KeyboardInterrupt:
                print_stats(eng)
        else:
            asyncio.run(run_load(eng, args))
    except EngineCrash as e:
        print(f"[serve] restart budget exhausted: {e}", file=sys.stderr)
        sys.exit(EXIT_RESTART_EXHAUSTED)
    sys.exit(EXIT_CLEAN_DRAIN)


if __name__ == "__main__":
    main()

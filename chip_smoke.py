"""Smoke test of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. card name and power limit; build the CUDA kernels from ``src/repro_torch/
     csrc`` and report the build time;
  2. every kernel against its plain PyTorch version at the serving path's
     shapes (bf16 and fp32), with its time, the plain version's time, a
     library yardstick where one PyTorch call computes the same function,
     and the card's lower bound for the work;
  3. the port's ``Engine`` serving ``qwen3-0.6b`` at full width (packed
     ternary weights from a seeded init, w2a8 + paged kernels), with every
     launch counter read around that run;
  4. on-card parity: the kernel path and the plain path (``attn_impl=
     "gather"``, ``use_kernel=False``) give identical greedy tokens;
  5. summary lines: card, kernels (JSON), and the result line last.

It imports nothing of JAX or of the JAX package.  Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s and
# the per-type operation rates used for each kernel's lower bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stdout.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of ``fn`` over ``iters`` launches, CUDA events
    around each one; ``flush`` (a 64 MB write) runs between launches so every
    call meets a cold L2, as the serving loop's layer-by-layer weights do."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, op_type: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp(t):
    """Spacing of ``t``'s dtype at |t| (the dtype's unit in the last place)."""
    import torch
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


# -- phase 2: kernels against their plain versions ------------------------------

def check_w2a8(dev, flush, results):
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.w2a8_gemv.kernel import w2a8_kernel
    from repro_torch.kernels.w2a8_gemv.ref import w2a8_ref
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
    worst = 0.0
    rows = []
    for (k, n) in shapes:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        qw, delta = Q.weight_quant_absmean(w)
        wp = Q.pack_ternary(qw.to(torch.int8))
        for m in (8, 256):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((m, k), generator=gen, device=dev).to(dt)
                y = w2a8_kernel(x, wp, delta)
                torch.cuda.synchronize()
                r = w2a8_ref(x, wp, delta)
                err = (y.float() - r.float()).abs()
                if not bool((err <= ulp(r).float()).all()):
                    fail(f"w2a8 M={m} K={k} N={n} {dt}: max err "
                         f"{err.max().item()} exceeds 1 ulp")
                worst = max(worst, err.max().item())
                if dt == torch.bfloat16:
                    ms = time_ms(lambda: w2a8_kernel(x, wp, delta), flush=flush)
                    plain = time_ms(lambda: w2a8_ref(x, wp, delta), flush=flush)
                    nbytes = x.numel() * 2 + wp.numel() + 4 + m * n * 2
                    b, by = bound_ms(nbytes, 2.0 * m * k * n, "int8")
                    rows.append(dict(m=m, k=k, n=n, ms=ms, plain_ms=plain,
                                     bound_ms=b, bound_by=by))
                    print(f"  w2a8 M={m:4d} K={k} N={n} bf16: {ms:.4f} ms "
                          f"(plain {plain:.4f}, bound {b:.4f} by {by})", flush=True)
    # the headline row: the decode step's largest projection (gate/up) at M=8
    head = next(r for r in rows if r["m"] == 8 and (r["k"], r["n"]) == (1024, 3072))
    results["w2a8_gemv"] = dict(
        name="w2a8_gemv", route="cuda", source="src/repro_torch/csrc/w2a8_gemv.cu",
        replaces="src/repro/kernels/w2a8_gemv/kernel.py:58", max_abs_err=worst,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
        shape="M=8 K=1024 N=3072 bf16", rows=rows)


def _paged_problem(dev, dt, b, hkv, g, dh, bs, depths, t, gen):
    """Pools with exclusively owned blocks per live row; rows with depth None
    are idle (table all trash, parked position).  Returns the operands."""
    import torch
    L = max(-(-(d + t) // bs) for d in depths if d is not None)
    n_blocks = 1 + b * L
    kp = torch.randn((n_blocks, hkv, bs, dh), generator=gen, device=dev).to(dt)
    vp = torch.randn((n_blocks, hkv, bs, dh), generator=gen, device=dev).to(dt)
    bt = torch.zeros((b, L), dtype=torch.int32)
    nxt = 1
    pos = []
    for r, d in enumerate(depths):
        if d is None:
            pos.append(L * bs - 1)
            continue
        for j in range(min((d + t - 1) // bs, L - 1) + 1):
            bt[r, j] = nxt
            nxt += 1
        pos.append(d)
    return kp, vp, bt.to(dev), torch.tensor(pos, dtype=torch.int32, device=dev), L


def _compare_paged(name, out, kp, vp, ro, rkp, rvp, live, dt, rows_valid=None):
    import torch
    o, r = out.float(), ro.float()
    if rows_valid is not None:
        o, r = o[rows_valid], r[rows_valid]
    else:
        o, r = o[live], r[live]
    err = (o - r).abs()
    # fp32: summation order only; bf16: the output rounds to bf16 once, so a
    # different fp32 order may move it by one bf16 ulp
    tol = 2e-5 + (ulp(r.to(dt)).float() if dt == torch.bfloat16 else 2e-5 * r.abs())
    if not bool((err <= tol).all()):
        fail(f"{name} {dt}: output max err {err.max().item()}")
    if not (torch.equal(kp[1:], rkp[1:]) and torch.equal(vp[1:], rvp[1:])):
        fail(f"{name} {dt}: pools differ from the plain version's")
    return err.max().item()


def check_paged_decode(dev, flush, results):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.kernel import paged_attention_decode_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_decode_ref
    gen = torch.Generator(device=dev).manual_seed(1)
    b, hkv, g, dh, bs = 8, 8, 2, 128, 16
    # mixed depths up to 1024, one idx on a block boundary, one idle row
    depths = [1023, 512, 17, 0, 300, 800, 64, None]
    live = [i for i, d in enumerate(depths) if d is not None]
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        kp, vp, bt, idx, L = _paged_problem(dev, dt, b, hkv, g, dh, bs, depths, 1, gen)
        q = torch.randn((b, hkv, g, dh), generator=gen, device=dev).to(dt)
        kn = torch.randn((b, hkv, dh), generator=gen, device=dev).to(dt)
        vn = torch.randn((b, hkv, dh), generator=gen, device=dev).to(dt)
        scale = dh ** -0.5
        for softcap in (0.0, 30.0):
            k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            out, _, _ = paged_attention_decode_kernel(q, kn, vn, k1, v1, bt, idx,
                                                      scale, softcap)
            torch.cuda.synchronize()
            ro, _, _ = paged_attention_decode_ref(q, kn, vn, k2, v2, bt, idx,
                                                  scale, softcap)
            worst = max(worst, _compare_paged("paged decode", out, k1, v1, ro, k2,
                                              v2, live, dt))
        if dt == torch.bfloat16:
            ms = time_ms(lambda: paged_attention_decode_kernel(
                q, kn, vn, k1, v1, bt, idx, scale, 0.0), flush=flush)
            plain = time_ms(lambda: paged_attention_decode_ref(
                q, kn, vn, k2, v2, bt, idx, scale, 0.0), flush=flush)
            # yardstick: SDPA over the dense window gathered beforehand
            kw = k2[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, L * bs, dh)
            vw = v2[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, L * bs, dh)
            kw = kw.repeat_interleave(g, dim=1)
            vw = vw.repeat_interleave(g, dim=1)
            qs = q.reshape(b, hkv * g, 1, dh)
            mask = (torch.arange(L * bs, device=dev)[None] <= idx[:, None].long())
            mask = mask[:, None, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, kw, vw, attn_mask=mask), flush=flush)
            # the least work: the live rows only (the idle row's output is
            # don't-care); each reads its stored positions < idx once
            positions = sum(depths[r] for r in live)
            n, item = len(live), 2
            nbytes = (2 * positions * hkv * dh * item             # resident K, V
                      + n * hkv * (g + 2) * dh * item             # q, new K/V in
                      + n * hkv * (g + 2) * dh * item)            # out, K/V write
            ops = 4.0 * g * dh * hkv * (positions + n)
            bd, by = bound_ms(nbytes, ops, "bfloat16")
            print(f"  paged decode B={b} Hkv={hkv} g={g} Dh={dh} bs={bs} bf16: "
                  f"{ms:.4f} ms (plain {plain:.4f}, sdpa {lib:.4f}, bound "
                  f"{bd:.4f} by {by})", flush=True)
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bd,
                       bound_by=by)
    results["paged_attention_decode"] = dict(
        name="paged_attention_decode", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:114",
        max_abs_err=worst, shape="B=8 Hkv=8 g=2 Dh=128 bs=16 depth<=1023 bf16",
        **row)


def check_paged_prefill(dev, flush, results):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_prefill.kernel import paged_prefill_chunk_kernel
    from repro_torch.kernels.paged_prefill.ref import paged_prefill_chunk_ref
    gen = torch.Generator(device=dev).manual_seed(2)
    b, hkv, g, dh, bs, t = 8, 8, 2, 128, 16, 32
    # chunk starts (resident depth) and valid lengths: cold starts, mid-prompt
    # chunks straddling blocks, decode rows (lens 1), pad rows, one idle row
    starts = [0, 256, 700, 31, 990, 16, 500, None]
    lens = [32, 32, 20, 1, 1, 7, 32, 1]
    live = [i for i, s in enumerate(starts) if s is not None]
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        kp, vp, bt, start, L = _paged_problem(dev, dt, b, hkv, g, dh, bs, starts, t, gen)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, hkv, t * g, dh), generator=gen, device=dev).to(dt)
        kc = torch.randn((b, hkv, t, dh), generator=gen, device=dev).to(dt)
        vc = torch.randn((b, hkv, t, dh), generator=gen, device=dev).to(dt)
        scale = dh ** -0.5
        valid = torch.zeros((b, hkv, t * g), dtype=torch.bool, device=dev)
        for r in live:
            valid[r, :, :lens[r] * g] = True
        for softcap in (0.0, 30.0):
            k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            out, _, _ = paged_prefill_chunk_kernel(q, kc, vc, k1, v1, bt, start,
                                                   ln, scale, softcap)
            torch.cuda.synchronize()
            ro, _, _ = paged_prefill_chunk_ref(q, kc, vc, k2, v2, bt, start, ln,
                                               scale, softcap)
            worst = max(worst, _compare_paged("paged prefill", out, k1, v1, ro, k2,
                                              v2, live, dt, rows_valid=valid))
        if dt == torch.bfloat16:
            ms = time_ms(lambda: paged_prefill_chunk_kernel(
                q, kc, vc, k1, v1, bt, start, ln, scale, 0.0), flush=flush)
            plain = time_ms(lambda: paged_prefill_chunk_ref(
                q, kc, vc, k2, v2, bt, start, ln, scale, 0.0), flush=flush)
            kw = k2[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, L * bs, dh)
            vw = v2[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, L * bs, dh)
            kw = kw.repeat_interleave(g, dim=1)
            vw = vw.repeat_interleave(g, dim=1)
            qs = (q.reshape(b, hkv, t, g, dh).permute(0, 1, 3, 2, 4)
                  .reshape(b, hkv * g, t, dh))
            pos = start.long()[:, None] + torch.arange(t, device=dev)[None]
            mask = (torch.arange(L * bs, device=dev)[None, None] <= pos[:, :, None])
            mask = mask[:, None]
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, kw, vw, attn_mask=mask), flush=flush)
            # the least work: the valid tokens of the live rows only (pad
            # tokens and the idle row are don't-care); each row reads its
            # resident positions < start once, token j attends start + j + 1
            item = 2
            resident = sum(starts[r] for r in live)
            tokens = sum(lens[r] for r in live)
            nbytes = (2 * resident * hkv * dh * item              # resident K, V
                      + tokens * hkv * (g + 2) * dh * item        # q, chunk K/V in
                      + tokens * hkv * (g + 2) * dh * item)       # out, K/V write
            keys = sum(lens[r] * starts[r] + lens[r] * (lens[r] + 1) // 2
                       for r in live)
            ops = 4.0 * g * dh * hkv * keys
            bd, by = bound_ms(nbytes, ops, "bfloat16")
            print(f"  paged prefill B={b} Hkv={hkv} g={g} Dh={dh} bs={bs} T={t} "
                  f"bf16: {ms:.4f} ms (plain {plain:.4f}, sdpa {lib:.4f}, bound "
                  f"{bd:.4f} by {by})", flush=True)
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bd,
                       bound_by=by)
    results["paged_prefill_chunk"] = dict(
        name="paged_prefill_chunk", route="cuda",
        source="src/repro_torch/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/paged_prefill/kernel.py:136",
        max_abs_err=worst,
        shape="B=8 Hkv=8 g=2 Dh=128 bs=16 T=32 start<=990 bf16", **row)


# -- phases 3 and 4: the port's Engine ----------------------------------------

def _engine_prompts(vocab: int, seed: int):
    """Ten prompts of 17..700 tokens; prompts 0 and 9 share a 256-token
    prefix (9 is submitted late so 0 has published it)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [300, 17, 700, 64, 129, 450, 33, 512, 90, 280]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    prompts[9] = prompts[0][:256] + prompts[9][256:]
    return prompts


def serve_full_width(dev, out_dir):
    """Phase 3: qwen3-0.6b at full width and depth, packed ternary weights
    from the port's seeded init, bf16 compute and cache, every projection
    through w2a8 and every attention through the paged kernels."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.paged_attention import kernel as pa_k
    from repro_torch.kernels.paged_prefill import kernel as pp_k
    from repro_torch.kernels.w2a8_gemv import kernel as w2_k
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import Engine, SamplingParams, ServeConfig

    cfg = get_config("qwen3-0.6b").with_quant(
        Q.QuantConfig(mode="packed", use_kernel=True)).replace(
        compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    print(f"  init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {time.perf_counter() - t0:.1f} s", flush=True)
    scfg = ServeConfig(max_batch=8, max_len=1024, prefill_chunk=32,
                       prefix_cache=True, cache_dtype="bfloat16")
    eng = Engine(cfg, model, scfg)
    if eng.attn_impl != "fused":
        fail(f"engine resolved attn_impl={eng.attn_impl!r} on the card")
    prompts = _engine_prompts(cfg.vocab, seed=3)
    greedy = SamplingParams(max_tokens=32, ignore_eos=True)
    counters = (w2_k.launches, pa_k.launches, pp_k.launches)
    for c in counters:
        c.reset()
    reqs = [eng.submit(p, greedy) for p in prompts[:9]]
    step_ms = []
    t_run = time.perf_counter()

    def timed_step():
        ts = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - ts) * 1e3)

    for _ in range(12):
        timed_step()
    reqs.append(eng.submit(prompts[9], greedy))
    reqs.append(eng.submit(prompts[3][:40], SamplingParams(
        max_tokens=32, temperature=0.8, top_p=0.95, seed=11, ignore_eos=True)))
    while eng.has_pending():
        timed_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = {c.name: c.count for c in counters}
    n_steps = len(step_ms)
    st = eng.stats()
    for r in reqs:
        if not r.done or r.finish_reason is None or r.finish_reason.name == "ABORTED":
            fail(f"request {r.uid} did not finish ({r.finish_reason})")
        if len(r.output_tokens) != 32:
            fail(f"request {r.uid} produced {len(r.output_tokens)} tokens")
        if not all(0 <= t < cfg.vocab for t in r.output_tokens):
            fail(f"request {r.uid} produced an out-of-range token")
    hits = (st.prefix_cache or {}).get("hits", 0)
    if hits < 1:
        fail(f"no prefix-cache hit ({st.prefix_cache})")
    for layer in eng._cache:
        for t in layer.values():
            if not bool(torch.isfinite(t).all()):
                fail("a KV pool holds non-finite values")
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was never launched on the main path")
    toks = sum(len(r.output_tokens) for r in reqs)
    ordered = sorted(step_ms)
    pct = {q: ordered[min(len(ordered) - 1, int(q / 100 * len(ordered)))]
           for q in (50, 90, 99)}
    summary = dict(model=cfg.name, layers=cfg.n_layers, requests=len(reqs),
                   tokens=toks, wall_s=wall, tok_per_s=toks / wall,
                   steps=n_steps, step_ms_p50=pct[50], step_ms_p90=pct[90],
                   step_ms_p99=pct[99],
                   ttft_ms_p50=(st.ttft_ms or {}).get("p50"),
                   prefix_hits=hits, preemptions=st.preemptions,
                   prefill_chunks=st.prefill_chunks, launches=launches,
                   launches_per_step={k: v / n_steps for k, v in launches.items()})
    print(f"  served {len(reqs)} requests, {toks} tokens in {wall:.2f} s: "
          f"{toks / wall:.1f} tok/s; {n_steps} steps, step ms p50 {pct[50]:.2f} "
          f"p90 {pct[90]:.2f} p99 {pct[99]:.2f}; TTFT p50 "
          f"{summary['ttft_ms_p50']:.1f} ms; prefix hits {hits}; launches "
          f"{launches}", flush=True)
    summary["profile"] = profile_steps(dev, cfg, model, scfg, prompts, out_dir)
    (out_dir / "smoke_engine.json").write_text(json.dumps(summary, indent=1))
    del eng, model
    torch.cuda.empty_cache()
    return launches


def profile_steps(dev, cfg, model, scfg, prompts, out_dir):
    """Where the device time of the phase-3 workload goes: fresh engines on
    the same model serve four of its prompts twice, once timed on the host
    clock and once under ``torch.profiler`` (both after the counted run, so
    the counts and step times above carry no profiler cost).  Device time is
    summed per kernel name from the trace's CUDA events; the idle share is
    1 - busy / wall, with the wall of the unprofiled pass (the profiler's
    own host cost would inflate it) over the same deterministic work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Engine, SamplingParams

    def serve():
        eng = Engine(cfg, model, scfg)
        for p in (prompts[2], prompts[3], prompts[6], prompts[8]):
            eng.submit(p, SamplingParams(max_tokens=8, ignore_eos=True))
        steps = 0
        while eng.has_pending():
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        return steps

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps = serve()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if busy == 0:
        print("  profile: the trace holds no device time (not measured)", flush=True)
        return None

    def group(name):
        for key in ("w2a8_kernel", "paged_decode_kernel", "paged_prefill_kernel"):
            if key in name:
                return key
        return "other (PyTorch ops)"

    groups = {}
    for n, us in by_name.items():
        groups[group(n)] = groups.get(group(n), 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    lines = [f"{us / 1e3:10.3f} ms  {us / busy:6.1%}  {n[:110]}" for n, us in top]
    (out_dir / "profile_engine.txt").write_text(
        f"steps {steps}, wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms\n" + "\n".join(lines) + "\n")
    shares = {k: v / busy for k, v in groups.items()}
    print(f"  profile: {steps} steps, wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (idle share {1 - busy / wall_us:.1%}); "
          + ", ".join(f"{k} {v:.1%}" for k, v in sorted(shares.items())),
          flush=True)
    return dict(steps=steps, wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                idle_share=1 - busy / wall_us, device_time_share=shares)


def kernel_vs_plain_parity(dev):
    """Phase 4: qwen3-0.6b at full width, depth 2, fp32 — the engine with the
    kernels and with the plain paths (attn_impl="gather", use_kernel=False,
    the JAX package's own non-kernel knobs) must give the same greedy
    tokens."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import Engine, SamplingParams, ServeConfig

    base = get_config("qwen3-0.6b").replace(n_layers=2, compute_dtype="float32")
    outs = {}
    state = None
    prompts = _engine_prompts(base.vocab, seed=5)[:5]
    for tag, use_kernel, impl in (("kernels", True, "fused"),
                                  ("plain", False, "gather")):
        cfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=use_kernel))
        if state is None:
            model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(1),
                                device=dev)
            state = model.state_dict()
        else:
            model = build_model(cfg, device=dev)
            model.load_state_dict(state)
            model.embed.refresh()
        eng = Engine(cfg, model, ServeConfig(
            max_batch=4, max_len=1024, prefill_chunk=32, attn_impl=impl,
            cache_dtype="float32"))
        reqs = [eng.submit(p, SamplingParams(max_tokens=16, ignore_eos=True))
                for p in prompts]
        for _ in eng.stream():
            pass
        outs[tag] = [r.output_tokens for r in reqs]
        del eng, model
    if outs["kernels"] != outs["plain"]:
        fail(f"greedy tokens differ between the kernel and plain paths: "
             f"{outs['kernels']} vs {outs['plain']}")
    print(f"  greedy tokens identical over {len(prompts)} requests x 16 tokens",
          flush=True)


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. card and build
    card = card_info()
    print(f"card: {card}", flush=True)
    from repro_torch.kernels import build
    info = build.build(verbose=True)
    print(f"build: {info.seconds:.1f} s -> {info.path}", flush=True)
    out_dir = ROOT / "smoke_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ptxas.txt").write_text(info.log)

    # 2. kernels against their plain versions
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    results = {}
    print("phase 2: kernels vs plain versions", flush=True)
    check_w2a8(dev, flush, results)
    check_paged_decode(dev, flush, results)
    check_paged_prefill(dev, flush, results)
    del scratch
    # 3. the main path, launch counters reset just before it
    print("phase 3: engine, qwen3-0.6b full width", flush=True)
    launches = serve_full_width(dev, out_dir)
    # 4. kernels vs plain paths through the engine
    print("phase 4: on-card parity, kernel vs plain paths", flush=True)
    kernel_vs_plain_parity(dev)

    # 5. summary
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # every parity check above is fatal, so reaching here means "ok"
    line = {"kernels": [dict({k: dict(v, launches=launches[name])[k] for k in keys},
                             parity="ok")
                        for name, v in results.items()]}
    (out_dir / "smoke_kernels.json").write_text(json.dumps(results, indent=1))
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Smoke test of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. card name and power limit; build the CUDA kernels from ``src/repro_torch/
     csrc`` and report the build time, the tensor-core kernels' registers,
     spills and shared memory (and the paged kernels' at head_dim 256), and
     their SASS: bitlinear's GEMM and w2a8's
     wgmma route must hold the int8 ``wgmma`` (IGMMA) and the TMA loads
     (UTMALDG), ssd_scan's three product stages TF32 ``mma`` (HMMA) and
     relation_kd TF32 ``wgmma`` (HGMMA);
  2. every kernel against its plain PyTorch version at its path's shapes
     (the serving kernels and bitlinear in bf16 and fp32, relation_kd and
     ssd_scan in fp32), with its time, the plain version's time, a library
     yardstick where one PyTorch call computes the same function, and the
     card's lower bound for the work; the paged kernels at qwen3-0.6b's
     heads (8 kv heads of 128, g = 2) and gemma-7b's (16 kv heads of 256,
     g = 1), the prefill kernel at two shapes (the original one, and a
     mixed step of one prefilling and seven decode rows), each paged launch with its split and CTA counts,
     its device time alone beside the time a caller sees, and its host
     time per call; bitlinear bitwise in both dtypes at eight shapes, timed
     the same way, with its three device kernels (quantizing pass, K-major
     weight, GEMM) alone; w2a8 bitwise at the five projection shapes of
     qwen3-0.6b, mamba2-780m's two (in_proj N=6448 with its ragged last
     column tile, out_proj) and gemma-7b's and qwen2.5-3b's eight (K up to
     24576) on both sides of its route threshold (each route forced at the
     mamba shapes, M = 8, 16, 256, and at the dense ones, M = 8, 256), timed the
     same way at the decode rows (M=8) and a chunk step's (M=256) beside
     ``torch._int_mm``, then whisper-medium's and llama-3.2-vision-11b's
     projection shapes, the image memory's 6,404 rows at (4096, 1024), and
     all-zero rows on both routes (exact zeros);
     relation_kd within rtol 1e-5 at L = 256, 300 and 4096 on two input
     recipes and three temperatures, bitwise from run to run, with its
     split plan, timed on both timers with its host time at L = 256 and
     4096; ssd_scan within 1e-4, timed on both timers;
  3. the port's ``Engine`` serving ``qwen3-0.6b`` at full width (packed
     ternary weights from a seeded init, w2a8 + paged kernels), with the
     serving kernels' launch counters read around that run;
  4. on-card parity: the kernel path and the plain path (``attn_impl=
     "gather"``, ``use_kernel=False``) give identical greedy tokens (the
     smallest top-2 logit gaps of those tokens printed beside);
  5. the BitDistill training path on ``qwen3-0.6b`` at full width and depth
     (bf16 compute, fp32 master weights, remat): an FP teacher from a seeded
     init, stage-1 refine, 3 CE steps and 5 distillation steps with both
     kernel knobs on, the training kernels' launch counters read around
     them, and a profile of one distillation step;
  6. on-card parity: the first distillation step with the kernels and with
     the plain paths, from the same weights (full width, depth 2, fp32);
  7. the BitDistill training path on ``mamba2-780m`` at full width and depth
     (48 layers, the same recipe at batch 8 x seq 512, CE + logits KD since
     the family has no attention): every SSD through the ssd_scan kernel,
     every projection through bitlinear, launch counters read around the
     steps, and a profile of one distillation step;
  8. on-card parity: one full-width ``Mamba2Block`` forward and backward
     through the ssd_scan kernel and through the sequential oracle;
  9. serving through the entry point: ``python -m repro_torch.launch.serve``
     at full width (qwen3-0.6b, packed, bf16, 11 requests x 32 tokens,
     prefix cache, supervised, traced) must exit 0; phase 3's model and
     prompts through ``FrontendServer`` + ``AsyncEngine`` +
     ``ServingSupervisor`` + ``Tracer`` with the journal armed must give the
     synchronous engine's greedy tokens, overlap steps, a valid trace whose
     counts equal the stats and a journal all terminal with its clean
     shutdown, the serving kernels' counters read around that run; the sync
     of step N must return while step N+1 is still queued behind a device
     spin; one transient fault at each of plan, launch and commit and one
     bit flipped in a resident bf16 KV block must leave the tokens as they
     were; the async loop's tok/s and step gap beside the synchronous
     loop's, and its device idle share from a profile;
 10. the training launcher and the rest of the training path: (a) ``python
     -m repro_torch.launch.train`` at full width (qwen3-0.6b cut to 2 of
     its 28 layers, 6 CE steps at 8 x 256) uninterrupted, then sent SIGTERM after its first
     step lines (it must save and exit 0), then restarted in that
     directory (it must resume and reach step 6): the resumed run's final
     checkpoint held leaf by leaf to the uninterrupted run's, with the
     checkpoint's size and the card's load, ``save_async`` stall and
     synchronous save times (the free disk checked first); (b), at the end
     of phase 5, its student saved through ``save_async``, loaded into a
     fresh student (every leaf equal) and stepped beside the live one
     (equal losses); (c) a distillation step under remat nothing, dots and
     none on the kernel and the plain route (equal losses and gradients,
     peak memory, step time); (d) the Table-4 weight schemes at the
     full-width projection shapes on the card against the CPU, and a
     blockwise CE step;
 11. serving ``mamba2-780m`` at full width and depth (packed, bf16) on the
     contiguous cache through the port's ``Engine``: 16 requests of 8–64
     prompt tokens x 16 tokens at ``max_batch=16``, w2a8 counted at 96
     launches a decode pass and the paged kernels at 0, the plain route's
     greedy tokens identical, step times, tok/s, the state's bytes and a
     profile's idle share; a request after another in the same slot gives
     its tokens alone; one transient fault at each of plan, launch and
     commit (async loop, speculation, supervisor) leaves the tokens; and
     ``python -m repro_torch.launch.serve --arch mamba2-780m`` exits 0 on
     the contiguous cache;
 12. the dense configs: (a) ``gemma-7b`` at full width and 14 of its 28
     layers (16 kv heads of 256, d_ff 24576, vocab 256000; packed, bf16)
     served through the port's ``Engine`` with the paged kernels at
     head_dim 256, phase 3's prompts x 32 greedy tokens, w2a8 counted at
     98 launches a step and the paged kernels at 14, step times, tok/s,
     KV bytes, peak memory, a profile's idle share and the tokens the plain
     route gives alike (printed); (b) its widths at depth 2 in fp32, the
     kernel route against the plain one, teacher-forced: each layer's
     attention context, given the plain route's block input, within the
     fp32 tolerance and the pools bitwise (the logits and the int8 codes
     rounded apart printed), and free-running greedy tokens; (c) ``python -m
     repro_torch.launch.serve --arch gemma-7b --packed`` exits 0 with both
     paged kernels launched; (d) one ``Attention`` at qwen3-0.6b's widths
     over 4096 positions: the blocked forward (block_kv 1024 and 1000)
     against the dense one, outputs and input gradients, bf16 scores
     against fp32, and each forward's peak memory;
 13. the MoE and hybrid families: granite-moe-1b-a400m served (a) and
     distilled (b), each at full width and 12 of its 24 layers, one full-width jamba
     (mamba, dense) block on both routes (c), jamba reduced served and
     stepped on both routes (d), and ``--arch granite-moe-1b-a400m``
     through the launcher (e);
 14. the cross-attention families: (a) ``whisper-medium`` at full width
     (24 + 24 layers, packed, bf16) served through the port's ``Engine`` on
     the contiguous cache, 8 prompts of 8–32 tokens x 16 greedy tokens, 192
     w2a8 launches a decode pass, the plain route alike but at bf16 ties;
     (b) its cross caches seeded from frames [4, 1500, 1024] through
     ``encode`` (w2a8 at M = 6,000), bitwise on both routes, 8 forced and
     8 greedy tokens; (c) it distilled (fp32 master weights, remat, 4 x
     256 with those frames), 768 bitlinear and 3 relation_kd launches a
     step, both routes within phase 6's bound; (d)
     ``llama-3.2-vision-11b`` at full width and depth served as (a), 264
     w2a8 a pass, then image embeddings [4, 1601, 4096] as (b); (e) one
     full-width (cross, dense) block, bf16 QAT, both routes; (f) its reduced
     stack (one repeat) served and stepped with ``image_embeds`` on both
     routes;
 15. the distributed layer on a one-rank NCCL group: (a) ``qwen3-0.6b`` at
     full width and 4 layers, QAT on the kernel route, 3 CE steps under a
     sharding plan (parameters and moments DTensors) against the same
     steps without one: losses and parameters bitwise, 56 bitlinear
     launches a step on both; (b) ``python -m torch.distributed.run
     --standalone --nproc-per-node 1 -m repro_torch.launch.train ... --dp 1
     --tp 1`` exits 0 with its step lines and checkpoint; (c)
     ``compressed_psum`` over 16 M values, two rounds, card bitwise its CPU
     evaluation, timed; (d) GPipe at one stage, a toy stage within 2e-5 of
     tanh(x @ w) and qwen3-0.6b's 4-layer stack bitwise ``Stack.forward``;
 16. the tooling: (a) the lint and self-tests, (b) phase 15a's CE step
     counted on the card and on meta, (c) a decode pass counted under the
     step-signature watchdog, (d) the dry run of two cells and its report;
 17. tensor-parallel compute: (a) every projection of a full-width
     mistral-large-123b block at tp 8 and a qwen3-0.6b block at tp 2, 4 and
     16 as each rank's shard through the split route's bitlinear functions:
     column pieces concatenated and row accumulators summed and scaled
     once bitwise the whole layer, every piece bitwise its plain version,
     one piece timed beside the whole layer; (b) phase 15a's model as a
     distill step (FP teacher, both kernels) under a plan on a one-rank
     NCCL group against the same steps without one: the split route taken
     (f/g calls counted), metrics and parameters bitwise, 56 bitlinear and
     3 relation_kd launches a step;
 18. the split route for the MoE, SSM and hybrid families: (a) full-width
     layers over emulated ranks (phase 19a's lockstep threads, each rank's
     shard cut by the plan), against the whole layer: granite-moe-1b-a400m's
     MoE layer over 8 ranks of 4 experts, grok-1-314b's over 16 ranks by d_ff
     (the fallback where the experts do not divide) and mamba2-780m's
     Mamba2Block over 16 ranks of 3 heads on the kernel route; (b) ssd_scan on
     a rank's heads at tp 16 (mamba2-780m's 3 of 48, jamba's 8 of 128 at (128,
     128)) against the whole launch's slice and ``ssd_chunked``, timed beside
     the whole launch; (c) granite at two layers and mamba2-780m at four, full
     width, CE and distill steps under the one-rank plan on the split route,
     bitwise the steps without one, their (bitlinear, relation_kd, ssd_scan)
     launches a step asserted;
 19. the split route for the cross-attention families and for decode:
     (a) whisper-medium's encoder block and decoder attn_cross block and
     llama-3.2-vision-11b's cross block, full width, QAT on the bitlinear
     kernel route, fp32, over 16 emulated ranks in lockstep threads (the
     port's Split at each rank's coordinate) against the whole block;
     (b) ``w2a8_forward_acc`` on qwen3-0.6b's o_proj and down_proj row
     shards at tp 16, M = 8 and 256: each shard exactly its plain version,
     the shards' scaled sum bitwise the whole launch, timed; (c) a packed
     decode step, fp32, over 16 emulated ranks: qwen3-0.6b at full width and
     depth on the cache split by positions and one layer of qwen1.5-0.5b on
     the cache split by heads, logits within a stated bound of the whole
     step and the greedy tokens equal but at ties, the packed kernels'
     launches asserted; (d) whisper-medium at two encoder and two decoder
     layers, CE and distill steps under the one-rank plan on the split
     route, bitwise the steps without one;
  then summary lines: card, kernels (JSON), and the result line last.

``python3 chip_smoke.py --phases 2,17`` runs phase 1, the named phases and
what they need (phase 2 always, for the kernels line; phase 10 brings
phase 5), and drops the check that every kernel was counted on a path.

It imports nothing of JAX or of the JAX package.  Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero.

``python3 chip_smoke.py --kernels-of DIR`` runs only phase 2's checks and
timings of w2a8, the paged kernels, bitlinear, relation_kd and ssd_scan, and
``--serving-of DIR`` only phase 3, against the package of the checkout at
DIR (to measure two versions in turns in one call), and prints their
numbers, not a result line.
"""
from __future__ import annotations

import collections
import gc
import json
import math
import statistics
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_ROOFLINE = []


def roofline():
    """This checkout's ``launch/roofline.py`` (the H100 data sheet's peaks and
    each kernel's work, ``kernel_work``), loaded by its path: it imports
    nothing of the package, so ``--kernels-of DIR`` bounds another
    checkout's kernels by this one's models."""
    if not _ROOFLINE:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_roofline", ROOT / "src" / "repro_torch" / "launch" / "roofline.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod          # dataclasses look their module up
        spec.loader.exec_module(mod)
        _ROOFLINE.append(mod)
    return _ROOFLINE[0]


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


# ~0.5 ms of device spin (SM clock ~1.98 GHz), queued before a timed call
# when the device time alone is wanted
HEAD_START_CYCLES = 1_000_000


def time_ms(fn, iters: int = 20, warmup: int = 3, flush=None,
            head_start: bool = False) -> float:
    """Median time of ``fn`` over ``iters`` launches, CUDA events around each
    one; ``flush`` (a 64 MB write) runs between launches so every call meets
    a cold L2, as the serving loop's layer-by-layer weights do.  The events
    bracket the call as a caller sees it: a call whose host enqueue outlasts
    the flush shows that time too (the kernel table's yardstick).
    ``head_start`` queues a ~0.5 ms device spin before the first event, so
    that the events bracket the device work alone (``host_us`` measures the
    enqueue)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        if head_start:
            torch.cuda._sleep(HEAD_START_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def both_ms(fn, flush):
    """(time as a caller sees it, device time alone) of ``fn``: ``time_ms``
    without and with the head start."""
    return time_ms(fn, flush=flush), time_ms(fn, flush=flush, head_start=True)


def host_us(fn, iters: int = 100) -> float:
    """Median host time of one call of ``fn`` (its enqueue: checks,
    allocations, launches), the device drained before each; 100 calls, since
    the shared host moves single calls by ~10 us."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound_ms(name: str, *args):
    """(least time in ms, "bytes" or "operations") of one call of kernel
    ``name`` on ``args``, its wrapper's arguments: the larger of the bytes
    over the HBM rate and the operations over their peak
    (``roofline.kernel_work``)."""
    return roofline().bound_ms(roofline().kernel_work(name, *args))


def ulp(t):
    """Spacing of ``t``'s dtype at |t| (the dtype's unit in the last place)."""
    import torch
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


# -- phase 2: kernels against their plain versions ------------------------------

W2A8_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
# mamba2-780m's in_proj (N = 2*3072 + 2*128 + 48: the last 128-column tile
# of the wgmma route holds 48 columns) and out_proj (phase 11)
W2A8_MAMBA_SHAPES = [(1536, 6448), (3072, 1536)]
# gemma-7b's q/k/v, o, gate/up and down (K up to 24576), and qwen2.5-3b's
# q/o, k/v (N = 256), gate/up and down (phase 12)
W2A8_DENSE_SHAPES = [(3072, 4096), (4096, 3072), (3072, 24576), (24576, 3072),
                     (2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]
# granite-moe-1b-a400m's q/o and k/v (phase 13; its experts are einsums)
W2A8_MOE_SHAPES = [(1024, 1024), (1024, 512)]
# whisper-medium's up and down (its q/k/v/o are (1024, 1024)) and
# llama-3.2-vision-11b's q/o, k/v, gate/up and down (phase 14)
W2A8_CROSS_SHAPES = [(1024, 4096), (4096, 1024), (4096, 4096), (4096, 14336),
                     (14336, 4096)]
# the memory projections' rows: llama-vision's image embeddings, 4 x 1601
# (phase 14d), at its k/v shape; neither a multiple of 64
W2A8_MEMORY = (6404, 4096, 1024)


def _int_mm_ms(xq, wq, scale, dt, flush):
    """The yardstick of the int8 products: ``torch._int_mm`` on the int8
    codes and the int8 weight (either layout it takes), then the scale, as
    a caller sees it and device alone; (None, None) and the reason where it
    refuses the shape (it wants more than 16 rows)."""
    import torch
    why = None
    for b in (wq, wq.t().contiguous().t()):
        try:
            torch._int_mm(xq, b)
        except RuntimeError as e:
            why = str(e).splitlines()[0][:120]
            continue
        return both_ms(lambda: (torch._int_mm(xq, b).float() * scale).to(dt),
                       flush), None
    return (None, None), why


def _fmt(v):
    return "refused" if v is None else f"{v:.4f}"


def check_w2a8(dev, flush, results):
    """w2a8 at the serving path's five projection shapes (qwen3-0.6b: q/o,
    k/v, gate/up, down), mamba2-780m's two (in_proj, out_proj), the eight
    of gemma-7b and qwen2.5-3b and granite-moe-1b-a400m's k/v (its q/o is
    qwen3's (1024, 1024)) at the decode rows (M=8) and a chunk step's
    rows (M = max_batch 8 x chunk 32 = 256), and, where the package routes
    by M, on both sides of its threshold, and at the mamba shapes each route
    forced at M = 8, 16 (phase 11's slots) and 256, at the dense shapes at
    M = 8 and 256; fp32 and bf16 bitwise to ``w2a8_ref``
    (integer sums, the same scale in the same order).  In bf16 at M=8 and
    M=256 each shape is timed as a caller sees it and device alone, with
    the wrapper's host time per call, beside the plain version and the
    ``torch._int_mm`` yardstick (the int8 codes and the unpacked int8
    weight given); and both routes device alone at the threshold M and at
    twice it, the evidence for where the threshold sits."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.w2a8_gemv import kernel as wk
    from repro_torch.kernels.w2a8_gemv.ref import w2a8_ref
    # the route threshold, where the package routes by M (not a parent's
    # checkout timed with --kernels-of)
    thr = wk.split_k_max_m() if hasattr(wk, "split_k_max_m") else None
    ms_checked = sorted({1, 8, 64, 256} | (set() if thr is None else {thr, thr + 1}))
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    shapes = W2A8_SHAPES + W2A8_MAMBA_SHAPES + W2A8_DENSE_SHAPES + [
        kn for kn in W2A8_MOE_SHAPES if kn not in W2A8_SHAPES] + [
        kn for kn in W2A8_CROSS_SHAPES if kn not in W2A8_DENSE_SHAPES]
    for (k, n) in shapes:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        qw, delta = Q.weight_quant_absmean(w)
        wq = qw.to(torch.int8)
        wp = Q.pack_ternary(wq)
        forced = [(m, r) for m in (8, 16, 256) for r in ("splitk", "wgmma")
                  if thr is not None and ((k, n) in W2A8_MAMBA_SHAPES
                                          or (m != 16 and (k, n) in W2A8_DENSE_SHAPES))]
        for m, route in [(m, None) for m in ms_checked] + forced:
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((m, k), generator=gen, device=dev).to(dt)
                y = (wk.w2a8_kernel(x, wp, delta) if route is None
                     else wk.w2a8_kernel(x, wp, delta, route=route))
                torch.cuda.synchronize()
                r = w2a8_ref(x, wp, delta)
                if not torch.equal(y, r):
                    err = (y.float() - r.float()).abs().max().item()
                    fail(f"w2a8 M={m} K={k} N={n} {dt} route {route or 'by M'}: "
                         f"max err {err} (must be bitwise)")
                if dt != torch.bfloat16 or m not in (8, 256) or route:
                    continue
                ms = both_ms(lambda: wk.w2a8_kernel(x, wp, delta), flush)
                host = host_us(lambda: wk.w2a8_kernel(x, wp, delta))
                plain = both_ms(lambda: w2a8_ref(x, wp, delta), flush)
                xq, gamma = Q.act_quant_absmax_int8(x.float())
                scale = Q.div(gamma, 127.0) * delta
                lib, why = _int_mm_ms(xq.to(torch.int8), wq, scale, dt, flush)
                b, by = bound_ms("w2a8_gemv", x, wp, delta)
                rows.append(dict(m=m, k=k, n=n, ms=ms[0], device_ms=ms[1],
                                 host_us=host, plain_ms=plain[0],
                                 plain_device_ms=plain[1], library_ms=lib[0],
                                 library_device_ms=lib[1], library_refused=why,
                                 bound_ms=b, bound_by=by))
                print(f"  w2a8 M={m:3d} K={k} N={n} bf16: {ms[0]:.4f} ms, device "
                      f"alone {ms[1]:.4f}, host {host:.1f} us per call (plain "
                      f"{plain[0]:.4f} / {plain[1]:.4f}, _int_mm {_fmt(lib[0])} / "
                      f"{_fmt(lib[1])}, bound {b:.5f} by {by})"
                      + ("" if why is None else f"; _int_mm refused: {why}"),
                      flush=True)
    routes = []
    if thr is not None:
        # the threshold's evidence: both routes device alone at M = thr and
        # at the next chunk-step M (2 * thr), in bf16
        for (k, n) in shapes:
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            qw, delta = Q.weight_quant_absmean(w)
            wp = Q.pack_ternary(qw.to(torch.int8))
            for m in (thr, 2 * thr):
                x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
                t = {r: both_ms(lambda: wk.w2a8_kernel(x, wp, delta, route=r), flush)[1]
                     for r in ("splitk", "wgmma")}
                routes.append(dict(m=m, k=k, n=n, **t))
                print(f"  w2a8 routes M={m} K={k} N={n} bf16, device alone: split-K "
                      f"{t['splitk']:.4f} ms, wgmma {t['wgmma']:.4f} ms", flush=True)
    # the memory projection at its ragged row count, and all-zero rows (the
    # engine's cross layers feed wo zero rows: γ = 0 there) on both routes
    m, k, n = W2A8_MEMORY
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    qw, delta = Q.weight_quant_absmean(w)
    wq = qw.to(torch.int8)
    wp = Q.pack_ternary(wq)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((m, k), generator=gen, device=dev).to(dt)
        y, r = wk.w2a8_kernel(x, wp, delta), w2a8_ref(x, wp, delta)
        if not torch.equal(y, r):
            fail(f"w2a8 M={m} K={k} N={n} {dt}: max err "
                 f"{(y.float() - r.float()).abs().max().item()} (must be bitwise)")
    ms = both_ms(lambda: wk.w2a8_kernel(x, wp, delta), flush)
    plain = both_ms(lambda: w2a8_ref(x, wp, delta), flush)
    xq, gamma = Q.act_quant_absmax_int8(x.float())
    lib, why = _int_mm_ms(xq.to(torch.int8), wq, Q.div(gamma, 127.0) * delta,
                          torch.bfloat16, flush)
    b, by = bound_ms("w2a8_gemv", x, wp, delta)
    memory_row = dict(m=m, k=k, n=n, ms=ms[0], device_ms=ms[1], plain_ms=plain[0],
                      plain_device_ms=plain[1], library_ms=lib[0],
                      library_device_ms=lib[1], bound_ms=b, bound_by=by)
    print(f"  w2a8 M={m} K={k} N={n} bf16 (the image memory's rows): {ms[0]:.4f} ms, "
          f"device alone {ms[1]:.4f} (plain {plain[0]:.4f} / {plain[1]:.4f}, _int_mm "
          f"{_fmt(lib[0])} / {_fmt(lib[1])}, bound {b:.5f} by {by}); bitwise in "
          "fp32 and bf16", flush=True)
    zero_rows = 0
    for m in (8, 256):
        x = torch.randn((m, 1024), generator=gen, device=dev).to(torch.bfloat16)
        x[::2] = 0
        w = torch.randn((1024, 1024), generator=gen, device=dev) * 0.02
        qw, delta = Q.weight_quant_absmean(w)
        wp = Q.pack_ternary(qw.to(torch.int8))
        for route in ((None,) if thr is None else ("splitk", "wgmma")):
            y = (wk.w2a8_kernel(x, wp, delta) if route is None
                 else wk.w2a8_kernel(x, wp, delta, route=route))
            if not (torch.equal(y, w2a8_ref(x, wp, delta))
                    and bool(torch.isfinite(y).all()) and not y[::2].any()):
                fail(f"w2a8 M={m} route {route}: all-zero rows do not give exact "
                     "zeros equal to the plain version's")
            zero_rows += m // 2
    print(f"  w2a8 all-zero rows: {zero_rows} rows on both routes give exact zeros, "
          "bitwise the plain version's", flush=True)
    # the headline row: the decode step's largest projection (gate/up) at
    # M=8, with the chunk step's (M=256) beside it
    head = next(r for r in rows if r["m"] == 8 and (r["k"], r["n"]) == (1024, 3072))
    chunk = next(r for r in rows if r["m"] == 256 and (r["k"], r["n"]) == (1024, 3072))
    results["w2a8_gemv"] = dict(
        name="w2a8_gemv", route="cuda", source="src/repro_torch/csrc/w2a8_gemv.cu",
        replaces="src/repro/kernels/w2a8_gemv/kernel.py:58", max_abs_err=0.0,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        device_ms=head["device_ms"], host_us=head["host_us"],
        shape="M=8 K=1024 N=3072 bf16", split_k_max_m=thr, chunk_step=chunk,
        mamba_rows=[r for r in rows if (r["k"], r["n"]) in W2A8_MAMBA_SHAPES],
        dense_rows=[r for r in rows if (r["k"], r["n"]) in W2A8_DENSE_SHAPES],
        moe_rows=[r for r in rows if (r["k"], r["n"]) in W2A8_MOE_SHAPES],
        cross_rows=[r for r in rows if (r["k"], r["n"]) in W2A8_CROSS_SHAPES
                    or (r["k"], r["n"]) == (1024, 1024)],
        memory_row=memory_row, rows=rows, routes=routes)


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


def _launch_plan(*shape):
    """The paged kernels' launch plan (``kernels/paged_attention/kernel.py::
    plan``), or None for a checkout whose kernels have none (one CTA per
    row and kv-head, timed with ``--kernels-of``)."""
    from repro_torch.kernels.paged_attention import kernel
    return kernel.plan(*shape) if hasattr(kernel, "plan") else None


def _paged_row(what, ms, plain, lib, bd, by, grid, host):
    """Print one paged timing line and return its numbers: ``ms``, ``plain``
    and ``lib`` are (as a caller sees it, device alone) pairs."""
    launch = ("one CTA per (row, kv-head)" if grid is None else
              f"{grid['splits']} splits of {grid['split_keys']} keys, "
              f"{grid['ctas']} CTAs + {grid['merge_ctas']} merge CTAs")
    print(f"  {what}: {ms[0]:.4f} ms (plain {plain[0]:.4f}, sdpa {lib[0]:.4f}, "
          f"bound {bd:.4f} by {by}); device alone {ms[1]:.4f} ms (plain "
          f"{plain[1]:.4f}, sdpa {lib[1]:.4f}); host {host:.1f} us per call; "
          f"{launch}", flush=True)
    return dict(ms=ms[0], plain_ms=plain[0], library_ms=lib[0], bound_ms=bd,
                bound_by=by, device_ms=ms[1], plain_device_ms=plain[1],
                library_device_ms=lib[1], host_us=host, launch=grid)


# (kv heads, g, head_dim) of the paged rows: qwen3-0.6b's (the headline
# rows), gemma-7b's (phase 12: MHA, head_dim 256) and granite-moe-1b-a400m's
# (phase 13: head_dim 64)
PAGED_HEADS = {"qwen3-0.6b": (8, 2, 128), "gemma-7b": (16, 1, 256),
               "granite-moe-1b-a400m": (8, 2, 64)}


def check_paged_decode(dev, flush, results):
    """The decode kernel at qwen3-0.6b's heads (the headline row), at
    gemma-7b's (``gemma_row``) and at granite-moe-1b-a400m's
    (``granite_row``)."""
    row, worst = _paged_decode_shape(dev, flush, *PAGED_HEADS["qwen3-0.6b"])
    gemma, worst_g = _paged_decode_shape(dev, flush, *PAGED_HEADS["gemma-7b"])
    granite, worst_m = _paged_decode_shape(dev, flush,
                                           *PAGED_HEADS["granite-moe-1b-a400m"])
    results["paged_attention_decode"] = dict(
        name="paged_attention_decode", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:114",
        max_abs_err=max(worst, worst_g, worst_m),
        shape="B=8 Hkv=8 g=2 Dh=128 bs=16 depth<=1023 bf16", **row,
        gemma_row=dict(gemma, max_abs_err=worst_g,
                       shape="B=8 Hkv=16 g=1 Dh=256 bs=16 depth<=1023 bf16"),
        granite_row=dict(granite, max_abs_err=worst_m,
                         shape="B=8 Hkv=8 g=2 Dh=64 bs=16 depth<=1023 bf16"))


def _paged_decode_shape(dev, flush, hkv, g, dh):
    """One decode launch shape: the kernel against its plain version in bf16
    and fp32 with and without softcap, then in bf16 its times beside the
    plain version's, SDPA's and the bound.  Returns (numbers, max error)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.kernel import paged_attention_decode_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_decode_ref
    gen = torch.Generator(device=dev).manual_seed(1)
    b, bs = 8, 16
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
            ms = both_ms(lambda: paged_attention_decode_kernel(
                q, kn, vn, k1, v1, bt, idx, scale, 0.0), flush)
            plain = both_ms(lambda: paged_attention_decode_ref(
                q, kn, vn, k2, v2, bt, idx, scale, 0.0), flush)
            # yardstick: SDPA over the dense window gathered beforehand
            kw = k2[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, L * bs, dh)
            vw = v2[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, L * bs, dh)
            kw = kw.repeat_interleave(g, dim=1)
            vw = vw.repeat_interleave(g, dim=1)
            qs = q.reshape(b, hkv * g, 1, dh)
            mask = (torch.arange(L * bs, device=dev)[None] <= idx[:, None].long())
            mask = mask[:, None, None, :]
            lib = both_ms(lambda: F.scaled_dot_product_attention(
                qs, kw, vw, attn_mask=mask), flush)
            # the least work: the live rows only (the idle row's output is
            # don't-care); each reads its stored positions < idx once
            bd, by = bound_ms("paged_attention_decode", q, kn, vn, k1, v1, bt, idx)
            grid = _launch_plan(b, hkv, g, 1, dh, bs, L)
            host = host_us(lambda: paged_attention_decode_kernel(
                q, kn, vn, k1, v1, bt, idx, scale, 0.0))
            row = _paged_row(f"paged decode B={b} Hkv={hkv} g={g} Dh={dh} bs={bs} "
                             f"L={L} bf16", ms, plain, lib, bd, by, grid, host)
    return row, worst


def check_paged_prefill(dev, flush, results):
    """Two T = 32 launches: the original shape (cold starts, mid-prompt chunks
    straddling blocks, decode rows, pad rows, an idle row) and a mixed step
    as the engine launches it (one row prefilling 32 tokens at start 256,
    seven decode rows at depths 17..990).  The first is the headline row."""
    starts = [0, 256, 700, 31, 990, 16, 500, None]
    lens = [32, 32, 20, 1, 1, 7, 32, 1]
    mixed_starts = [256, 17, 130, 300, 511, 640, 800, 990]
    mixed_lens = [32, 1, 1, 1, 1, 1, 1, 1]
    rows = {}
    for model, heads in PAGED_HEADS.items():
        rows[model] = (
            _paged_prefill_shape(dev, flush, starts, lens, 2, "paged prefill", heads),
            _paged_prefill_shape(dev, flush, mixed_starts, mixed_lens, 6,
                                 "paged prefill mixed step", heads))
    (row, mixed), (gemma, gemma_mixed) = rows["qwen3-0.6b"], rows["gemma-7b"]
    granite, granite_mixed = rows["granite-moe-1b-a400m"]
    mixed_shape = ("B=8 T=32: one row 32 tokens at 256, seven decode rows at "
                   "depths 17..990, bf16")
    worst = max(r["max_abs_err"] for pair in rows.values() for r in pair)
    results["paged_prefill_chunk"] = dict(
        row, name="paged_prefill_chunk", route="cuda",
        source="src/repro_torch/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/paged_prefill/kernel.py:136",
        max_abs_err=worst,
        shape="B=8 Hkv=8 g=2 Dh=128 bs=16 T=32 start<=990 bf16",
        mixed_step=dict(mixed, shape=mixed_shape),
        gemma_row=dict(gemma, shape="B=8 Hkv=16 g=1 Dh=256 bs=16 T=32 start<=990 "
                       "bf16", mixed_step=dict(gemma_mixed, shape=mixed_shape)),
        granite_row=dict(granite, shape="B=8 Hkv=8 g=2 Dh=64 bs=16 T=32 "
                         "start<=990 bf16",
                         mixed_step=dict(granite_mixed, shape=mixed_shape)))


def _paged_prefill_shape(dev, flush, starts, lens, seed, tag, heads):
    """One prefill launch shape at ``heads`` = (kv heads, g, head_dim), rows
    with start None idle: the kernel
    against its plain version in bf16 and fp32 with and without softcap
    (valid rows of live rows; pools bitwise outside the trash block), then
    in bf16 its time, the plain version's, SDPA's over the pre-gathered
    window, and the bound.  Returns the numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_prefill.kernel import paged_prefill_chunk_kernel
    from repro_torch.kernels.paged_prefill.ref import paged_prefill_chunk_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    (hkv, g, dh), b, bs, t = heads, 8, 16, 32
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
            worst = max(worst, _compare_paged(tag, out, k1, v1, ro, k2, v2, live,
                                              dt, rows_valid=valid))
        if dt == torch.bfloat16:
            ms = both_ms(lambda: paged_prefill_chunk_kernel(
                q, kc, vc, k1, v1, bt, start, ln, scale, 0.0), flush)
            plain = both_ms(lambda: paged_prefill_chunk_ref(
                q, kc, vc, k2, v2, bt, start, ln, scale, 0.0), flush)
            kw = k2[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, L * bs, dh)
            vw = v2[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, L * bs, dh)
            kw = kw.repeat_interleave(g, dim=1)
            vw = vw.repeat_interleave(g, dim=1)
            qs = (q.reshape(b, hkv, t, g, dh).permute(0, 1, 3, 2, 4)
                  .reshape(b, hkv * g, t, dh))
            pos = start.long()[:, None] + torch.arange(t, device=dev)[None]
            mask = (torch.arange(L * bs, device=dev)[None, None] <= pos[:, :, None])
            mask = mask[:, None]
            lib = both_ms(lambda: F.scaled_dot_product_attention(
                qs, kw, vw, attn_mask=mask), flush)
            # the least work: the valid tokens of the live rows only (pad
            # tokens and the idle row are don't-care); each row reads its
            # resident positions < start once, token j attends start + j + 1
            bd, by = bound_ms("paged_prefill_chunk", q, kc, vc, k1, v1, bt, start, ln)
            grid = _launch_plan(b, hkv, t * g, t, dh, bs, L)
            host = host_us(lambda: paged_prefill_chunk_kernel(
                q, kc, vc, k1, v1, bt, start, ln, scale, 0.0))
            row = _paged_row(f"{tag} B={b} Hkv={hkv} g={g} Dh={dh} bs={bs} T={t} "
                             f"L={L} bf16", ms, plain, lib, bd, by, grid, host)
    return dict(row, max_abs_err=worst)


def check_bitlinear(dev, flush, results):
    """bitlinear at the training paths' shapes: M = 8 x 256 tokens and every
    projection's (K, N) of qwen3-0.6b; M = 8 x 512 and mamba2-780m's in_proj
    (1536, 6448) and out_proj (3072, 1536).  fp32 and bf16 must equal the
    plain version bitwise (integer sums, the same scale in the same order).
    In bf16 each shape is timed as a caller sees it and device alone, with
    the wrapper's host time per call, beside the plain version, the
    ``_int_mm`` yardstick and, where the package has them (not a parent's
    checkout timed with ``--kernels-of``), the call's three device kernels
    alone: the quantizing pass, the int8 weight's K-major copy and the GEMM,
    and the training op's weight step (ternarize + K-major copy from the
    fp32 master weight).  Where it has them, at every shape and dtype the
    training op's forward (``bitlinear_forward``, what phases 5 and 7 run)
    and each part must equal its plain version bitwise: y, the codes and γ
    it computes, and the ternary codes it makes from the master weight."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.bitlinear import kernel as bk
    from repro_torch.kernels.bitlinear.ref import bitlinear_ref
    parts = hasattr(bk, "quantize_rows")
    if parts:
        from repro_torch.kernels.bitlinear.ref import (
            bitlinear_codes_ref, quantize_rows_ref, weight_kmajor_ref)

    def same(what, got, want, m, k, n, dt):
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            fail(f"bitlinear {what} M={m} K={k} N={n} {dt}: max err {err} "
                 "(must be bitwise)")
    gen = torch.Generator(device=dev).manual_seed(3)
    # the last: whisper-medium's encoder projections (1024, 1024) at its 4 x
    # 1500 audio frames (phase 14): the last 128-row tile holds 112 rows
    shapes = [(2048, 1024, 2048), (2048, 1024, 1024), (2048, 2048, 1024),
              (2048, 1024, 3072), (2048, 3072, 1024),
              (4096, 1536, 6448), (4096, 3072, 1536), (6000, 1024, 1024)]
    worst = 0.0
    rows = []
    for (m, k, n) in shapes:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        qw, delta = Q.weight_quant_absmean(w)
        wq = qw.to(torch.int8)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=dev).to(dt)
            gamma = x.float().abs().amax(-1, keepdim=True)
            y = bk.bitlinear_kernel(x, wq, gamma, delta)
            torch.cuda.synchronize()
            r = bitlinear_ref(x, wq, gamma, delta)
            err = (y.float() - r.float()).abs()
            same("bitlinear_kernel", y, r, m, k, n, dt)
            worst = max(worst, err.max().item())
            if parts:
                d = Q.absmean_scale(w)
                codes_r, gamma_r = quantize_rows_ref(x)
                wt_r, wq_r = weight_kmajor_ref(w, d)
                fwd = bk.bitlinear_forward(x, w, d)
                quant = bk.quantize_rows(x)
                ternary = bk.weight_kmajor(w, d)
                for what, got, want in (
                        ("forward y", fwd[0], bitlinear_ref(x, wq_r, gamma_r, d)),
                        ("forward codes", fwd[1], codes_r),
                        ("forward gamma", fwd[2], gamma_r),
                        ("forward wq", fwd[3], wq_r), ("forward wq", fwd[3], wq),
                        ("quantize_rows codes", quant[0], codes_r),
                        ("quantize_rows gamma", quant[1], gamma_r),
                        ("quantize_rows(gamma) codes", bk.quantize_rows(x, gamma)[0],
                         quantize_rows_ref(x, gamma)[0]),
                        ("weight_kmajor(wq)", bk.weight_kmajor(wq)[0],
                         weight_kmajor_ref(wq)[0]),
                        ("weight_kmajor(w, d) wt", ternary[0], wt_r),
                        ("weight_kmajor(w, d) wq", ternary[1], wq_r),
                        ("gemm", bk.gemm(codes_r, wt_r, gamma_r, d, dt),
                         bitlinear_codes_ref(codes_r, wt_r, gamma_r, d, dt))):
                    same(what, got, want, m, k, n, dt)
            if dt != torch.bfloat16:
                continue
            ms = both_ms(lambda: bk.bitlinear_kernel(x, wq, gamma, delta), flush)
            host = host_us(lambda: bk.bitlinear_kernel(x, wq, gamma, delta))
            plain = both_ms(lambda: bitlinear_ref(x, wq, gamma, delta), flush)
            # yardstick: cuBLAS int8 GEMM on the int8 codes, plus the scale
            xq = Q.round_clip(x.float() * Q.div(127.0, gamma + 1e-5),
                              -128.0, 127.0).to(torch.int8)
            scale = Q.div(gamma, 127.0) * delta
            lib, why = _int_mm_ms(xq, wq, scale, dt, flush)
            if why is not None:
                print(f"  torch._int_mm refused: {why}", flush=True)
            bd, by = bound_ms("bitlinear", x, wq, gamma, delta)
            row = dict(m=m, k=k, n=n, ms=ms[0], device_ms=ms[1], host_us=host,
                       plain_ms=plain[0], plain_device_ms=plain[1],
                       library_ms=lib[0], library_device_ms=lib[1], bound_ms=bd,
                       bound_by=by)
            line = (f"  bitlinear M={m} K={k} N={n} bf16: {ms[0]:.4f} ms, device "
                    f"alone {ms[1]:.4f}, host {host:.1f} us per call (plain "
                    f"{plain[0]:.4f} / {plain[1]:.4f}, _int_mm "
                    f"{lib[0] if lib[0] is None else round(lib[0], 4)} / "
                    f"{lib[1] if lib[1] is None else round(lib[1], 4)}, bound "
                    f"{bd:.4f} by {by})")
            if parts:
                codes, _ = bk.quantize_rows(x, gamma)
                wt, _ = bk.weight_kmajor(wq)
                row.update(
                    quant_ms=both_ms(lambda: bk.quantize_rows(x, gamma), flush),
                    quant_gamma_ms=both_ms(lambda: bk.quantize_rows(x), flush),
                    weight_copy_ms=both_ms(lambda: bk.weight_kmajor(wq), flush),
                    weight_ternarize_ms=both_ms(lambda: bk.weight_kmajor(w, d), flush),
                    gemm_ms=both_ms(lambda: bk.gemm(codes, wt, gamma, delta, dt),
                                    flush))
                line += "; device alone: " + ", ".join(
                    f"{key[:-3]} {row[key][1]:.4f}" for key in
                    ("quant_ms", "quant_gamma_ms", "weight_copy_ms",
                     "weight_ternarize_ms", "gemm_ms"))
            rows.append(row)
            print(line, flush=True)
    head = next(r for r in rows if (r["m"], r["k"], r["n"]) == (2048, 1024, 3072))
    extra = {}
    if parts:
        # the timer's floor: one launch of a one-element kernel, both timers
        one = torch.zeros(1, device=dev)
        extra.update(timer_floor_ms=both_ms(one.zero_, flush))
        print("  bitlinear: the timers' floor (a one-element "
              f"zero_): {extra['timer_floor_ms'][0]:.4f} ms, device alone "
              f"{extra['timer_floor_ms'][1]:.4f}", flush=True)
    results["bitlinear"] = dict(
        name="bitlinear", route="cuda", source="src/repro_torch/csrc/bitlinear.cu",
        replaces="src/repro/kernels/bitlinear/kernel.py:57", max_abs_err=worst,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        device_ms=head["device_ms"], host_us=head["host_us"],
        shape="M=2048 K=1024 N=3072 bf16", rows=rows, **extra)


# The kernels whose SASS phase 1 inspects: (name in the SASS, the
# instructions each instance must hold).  bitlinear's GEMM and w2a8's
# tensor-core route run int8 wgmma (IGMMA) fed by TMA loads (UTMALDG);
# ssd_scan's three kernels with products (C.B^T in the first) run mma.sync
# on TF32 (HMMA ... TF32); relation_kd's two instances (16-byte and 4-byte
# copies) run wgmma on TF32 (HGMMA ... TF32).
SASS_CHECKS = {
    "bitlinear_kernel_gemm": ("IGMMA", "UTMALDG"),
    "w2a8_kernel_gemm": ("IGMMA", "UTMALDG"),
    "ssd_kernel_prep": ("HMMA", "TF32"),
    "ssd_kernel_state": ("HMMA", "TF32"),
    "ssd_kernel_out": ("HMMA", "TF32"),
    "relation_kl_tiles": ("GMMA", "TF32"),
}


def _instance(fn: str):
    """The SASS_CHECKS kernel a mangled function name instantiates, and a
    short name for it (its output type or its (N, P)), or (None, None)."""
    for kern in SASS_CHECKS:
        if kern in fn:
            if "gemm" in kern:
                return kern, f"{kern}<{'bf16' if 'bfloat16' in fn else 'fp32'}>"
            if kern == "relation_kl_tiles":
                return kern, kern + ("<vec>" if "ILb1E" in fn else "<scalar>")
            return kern, kern + "<" + ",".join(re.findall(r"Li(\d+)E", fn)) + ">"
    return None, None


# the paged kernels' template arguments (TQ, TC) as they are mangled
_PAGED_TYPES = {"13__nv_bfloat16S0_": "bf16,bf16", "ff": "fp32,fp32",
                "f13__nv_bfloat16": "fp32,bf16", "13__nv_bfloat16f": "bf16,fp32"}


def _paged_instance(line: str, dh: int = 256):
    """``paged_decode_kernel<bf16,bf16,256>`` for an attention instance of
    the paged kernels at head dim ``dh`` named in ``line``, else None."""
    import re
    m = re.search(r"(paged_(?:decode|prefill)_kernel)I(\w+?)Li(\d+)E", line)
    if m is None or int(m.group(3)) != dh or m.group(2) not in _PAGED_TYPES:
        return None
    return f"{m.group(1)}<{_PAGED_TYPES[m.group(2)]},{dh}>"


def _kernel_ptxas(log: str, name_of=lambda line: _instance(line)[1]):
    """(instance, ptxas's spill and register lines) of each kernel in the
    build log that ``name_of`` names (by default the SASS_CHECKS kernels)."""
    fn, out, spill = None, [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = name_of(line)
            spill = ""
        elif fn and "spill" in line:
            spill = line.strip()
        elif fn and "Used" in line:
            out.append((fn, f"{spill}; {line.split(':', 1)[1].strip()}"))
            fn = None
    return out


def kernel_sass(lib_path, out_dir):
    """The SASS of the SASS_CHECKS kernels (``cuobjdump -sass``, written to
    ``kernel_sass.txt``): every instance must hold each of its kernel's
    instructions.  Returns the counts per instance and one example line of
    each instruction."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stdout[-2000:]}")
    fn, found, kept = None, {}, []
    for line in out.stdout.splitlines():
        if "Function : " in line:
            kern, fn = _instance(line.split("Function : ")[1].strip())
            if kern is not None:
                found[fn] = {op: [] for op in SASS_CHECKS[kern]}
                kept.append(line)
            continue
        if fn in found:
            kept.append(line)
            for op in found[fn]:
                if op in line:
                    found[fn][op].append(line.split("*/", 1)[1].split(";")[0].strip())
    (out_dir / "kernel_sass.txt").write_text("\n".join(kept) + "\n")
    counts = {f: {op: len(v) for op, v in d.items()} for f, d in found.items()}
    kinds = {_instance(f)[0] for f in found}
    if kinds != set(SASS_CHECKS) or not all(all(c.values()) for c in counts.values()):
        fail(f"the tensor-core kernels' SASS lacks an instruction: {counts}")
    examples = {}
    for d in found.values():
        for op, lines in d.items():
            examples.setdefault(op, lines[0])
    return dict(counts=counts, examples=examples)


def _relation_states(dev, bh, l, d, recipe, gen):
    """Unit rows s, t [BH, L, D]: ``phase2`` t = normalize(s + 0.5·noise), or
    ``clustered`` around 8 centres (s = centre + 0.6·noise, t = s +
    0.3·noise), whose relation rows are far from uniform: the recipe on
    which one TF32 product misses the gate (tests/test_torch_relation_tiles.py)."""
    import torch
    unit = lambda x: torch.nn.functional.normalize(x, dim=-1)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    if recipe == "phase2":
        s = unit(r(bh, l, d))
        return s, unit(s + 0.5 * r(bh, l, d))
    centres = r(bh, 8, d)
    pick = torch.randint(0, 8, (l,), generator=gen, device=dev)
    s = unit(centres[:, pick] + 0.6 * r(bh, l, d))
    return s, unit(s + 0.3 * r(bh, l, d))


def check_relation_kd(dev, flush, results):
    """relation_kd at the distillation shape (qwen3-0.6b, split_heads=4,
    batch 8 x 256: BH=32, L=256, D=512), at a ragged L=300 and at the JAX
    kernel's design point L=4096 (BH=32, D=512); the phase-2 recipe at
    temp 1 and clustered rows at temp 1, 0.25 and 0.1; rtol 1e-5, atol 1e-6
    against the materialized plain version (fp32 both), and bitwise from
    run to run.  L=256 and L=4096 are timed as a caller sees them and device
    alone, beside the plain version, with the wrapper's host time per call;
    the bound is 3 x the relation products at the TF32 rate (3xTF32).  The
    split plan is the package's (an older checkout timed with
    ``--kernels-of`` may have none)."""
    import torch
    from repro_torch.kernels.relation_kd import kernel as rk
    from repro_torch.kernels.relation_kd.ref import relation_kl_rows_ref
    gen = torch.Generator(device=dev).manual_seed(4)
    bh, d = 32, 512
    worst = 0.0
    rows = []
    cases = [(256, "phase2", 1.0), (300, "phase2", 1.0), (256, "clustered", 1.0),
             (256, "clustered", 0.25), (256, "clustered", 0.1),
             (300, "clustered", 0.25), (4096, "clustered", 0.25)]
    for l, recipe, temp in cases:
        s, t = _relation_states(dev, bh, l, d, recipe, gen)
        got = rk.relation_kl_rows_kernel(s, t, temp)
        again = rk.relation_kl_rows_kernel(s, t, temp)
        torch.cuda.synchronize()
        ref = relation_kl_rows_ref(s, t, temp)
        err = (got - ref).abs()
        if not bool((err <= 1e-6 + 1e-5 * ref.abs()).all()) or not bool(
                torch.isfinite(got).all()):
            fail(f"relation_kd BH={bh} L={l} D={d} {recipe} temp {temp}: max err "
                 f"{err.max().item()}")
        if not torch.equal(got, again):
            fail(f"relation_kd BH={bh} L={l} D={d} {recipe} temp {temp}: two runs "
                 "differ")
        worst = max(worst, err.max().item())
        plan = rk.plan(bh, l, d) if hasattr(rk, "plan") else None
        line = (f"  relation_kd BH={bh} L={l} D={d} fp32 {recipe} temp {temp}: "
                f"max err {err.max().item():.3g}; plan {plan}")
        if recipe == "phase2" and l == 256 or l == 4096:
            del ref
            fn = lambda: rk.relation_kl_rows_kernel(s, t, temp)
            ms = both_ms(fn, flush)
            plain = both_ms(lambda: relation_kl_rows_ref(s, t, temp), flush)
            host = host_us(fn)
            # the two relation products, as 3xTF32
            ops = roofline().kernel_work("relation_kd", s, t, temp).ops / 3
            bd, by = bound_ms("relation_kd", s, t, temp)
            rows.append(dict(l=l, ms=ms[0], device_ms=ms[1], plain_ms=plain[0],
                             plain_device_ms=plain[1], host_us=host,
                             library_ms=None, bound_ms=bd, bound_by=by, plan=plan))
            line += (f"; {ms[0]:.4f} ms, device alone {ms[1]:.4f}, host "
                     f"{host:.1f} us (plain {plain[0]:.4f} / {plain[1]:.4f}; bound "
                     f"{bd:.4f} by {by}: 3 x {ops / 1e9:.2f} GFLOP at the TF32 "
                     "rate)")
        print(line, flush=True)
    head = rows[0]
    results["relation_kd"] = dict(
        name="relation_kd", route="cuda", source="src/repro_torch/csrc/relation_kd.cu",
        replaces="src/repro/kernels/relation_kd/kernel.py:96", max_abs_err=worst,
        shape="BH=32 L=256 D=512 fp32", rows=rows,
        **{k: head[k] for k in ("ms", "device_ms", "plain_ms", "plain_device_ms",
                                "host_us", "library_ms", "bound_ms", "bound_by",
                                "plan")})


def check_ssd_scan(dev, flush, results):
    """ssd_scan at the mamba2-780m training shape (the headline row): batch
    8 x seq 512, 48 heads of 64, state 128, chunk 256 (BH = 384, two
    chunks); and at jamba-1.5-large-398b's (``jamba_row``, the (128, 128)
    instance): batch 2 x seq 512, 128 heads of 128, state 128, chunk 256
    (BH = 256).  Each as ``_ssd_scan_shape`` checks and times it."""
    row = _ssd_scan_shape(dev, flush, 8, 512, 48, 64, 128, 256, seed=5)
    jamba = _ssd_scan_shape(dev, flush, 2, 512, 128, 128, 128, 256, seed=6,
                            truth=True)
    results["ssd_scan"] = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:74",
        max_abs_err=max(row["max_abs_err"], jamba["max_abs_err"]), **{
            k: v for k, v in row.items() if k != "max_abs_err"},
        jamba_row=jamba)


def _ssd_scan_shape(dev, flush, b, s, h, p, n, chunk, seed, truth=False):
    """One ssd_scan shape, fp32, inputs as Mamba2Block feeds them (A in
    [-8, -1] per head, dt = softplus(N(-2, 1)), so a chunk's summed dt·|A|
    passes the ~88 where an unmasked exponential overflows).  y and the
    final state against ssd_chunked and the sequential ssd_scan_ref ([BH]
    layout, B and C per head), rtol 1e-4 atol 1e-4; the gradient of all
    five operands through the autograd.Function against autograd through
    ssd_chunked, rtol 1e-3 atol 1e-3.  That backward is itself a recompute
    through ssd_chunked, so the gradient check shows the Function is wired
    up; phase 8 holds the kernel path's gradients against the sequential
    oracle.  With ``truth``, the kernel's y and ssd_chunked's are also
    measured against ssd_chunked in float64: the largest error over the
    tolerance (1e-4 + 1e-4·|y|), printed, not gated.  Then the times
    beside the plain version's and the bound.  Returns the numbers."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ref import chunk_len, ssd_chunked, ssd_scan_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    A = -(1.0 + 7.0 * torch.rand((h,), generator=gen, device=dev))
    dt = torch.nn.functional.softplus(r(b, s, h) - 2.0)
    x, a, B, C = r(b, s, h, p), torch.exp(dt * A), r(b, s, n), r(b, s, n)
    ins = (x, a, dt, B, C)
    y, hT = ssd_scan_kernel(*ins, chunk)
    torch.cuda.synchronize()
    yc, hc = ssd_chunked(*ins, chunk=chunk)
    hc = hc.transpose(-1, -2).reshape(b * h, n, p)
    flat = lambda t: t.transpose(1, 2).reshape(b * h, s, *t.shape[3:])
    yr, hr = ssd_scan_ref(flat(x), flat(a), flat(dt), B.repeat_interleave(h, 0),
                          C.repeat_interleave(h, 0))
    over = {}
    if truth:
        y64, _ = ssd_chunked(*(t.double() for t in ins), chunk=chunk)
        for what, got in (("kernel", y), ("ssd_chunked", yc),
                          ("ssd_scan_ref", yr.reshape(b, h, s, p).transpose(1, 2))):
            e = (got.double() - y64).abs() / (1e-4 + 1e-4 * y64.abs())
            over[what] = e.max().item()
        del y64
    worst = 0.0
    for what, got, want in (("y vs ssd_chunked", y, yc), ("h vs ssd_chunked", hT, hc),
                            ("y vs ssd_scan_ref", flat(y), yr),
                            ("h vs ssd_scan_ref", hT, hr)):
        err = (got - want).abs()
        if not (bool(torch.isfinite(got).all())
                and bool((err <= 1e-4 + 1e-4 * want.abs()).all())):
            fail(f"ssd_scan (N, P) = ({n}, {p}) {what}: max err "
                 f"{err.max().item()}; largest error over the tolerance against a "
                 f"float64 ssd_chunked: {over or 'not measured'}")
        worst = max(worst, err.max().item())
    g = r(b, s, h, p)
    ins1 = [t.clone().requires_grad_() for t in ins]
    (ssd_ops.ssd_scan(*ins1, chunk=chunk) * g).sum().backward()
    ins2 = [t.clone().requires_grad_() for t in ins]
    (ssd_chunked(*ins2, chunk=chunk)[0] * g).sum().backward()
    for name, t1, t2 in zip("x a dt B C".split(), ins1, ins2):
        err = (t1.grad - t2.grad).abs()
        if not (bool(torch.isfinite(t1.grad).all())
                and bool((err <= 1e-3 + 1e-3 * t2.grad.abs()).all())):
            fail(f"ssd_scan (N, P) = ({n}, {p}) gradient of {name}: max err "
                 f"{err.max().item()}")
    del ins1, ins2, yr, hr
    ms = both_ms(lambda: ssd_scan_kernel(*ins, chunk), flush)
    plain = both_ms(lambda: ssd_chunked(*ins, chunk=chunk), flush)
    # the work the function needs: per (bh, chunk) the causal half of M·x,
    # Q(Q+1)·P, and C·h and the state update, 2·Q·N·P each; per (b, chunk)
    # the causal half of C·Bᵀ, Q(Q+1)·N, which the heads share.  The
    # products run on the tensor cores as 3xTF32 (three TF32 products for
    # each fp32 one), so the operations are three times those at the TF32
    # rate.  Bytes: the operands read once (B and C once per batch row), y
    # and the state written once
    q = chunk_len(s, chunk)
    ops = roofline().kernel_work("ssd_scan", *ins, chunk).ops / 3
    bd, by = bound_ms("ssd_scan", *ins, chunk)
    print(f"  ssd_scan b={b} S={s} H={h} P={p} N={n} Q={q} fp32: {ms[0]:.4f} ms, "
          f"device alone {ms[1]:.4f} (plain ssd_chunked {plain[0]:.4f} / "
          f"{plain[1]:.4f}; bound {bd:.4f} by {by}: 3 x {ops / 1e9:.2f} GFLOP "
          f"at the TF32 rate); max err {worst:.3g}"
          + (f"; largest error over the tolerance against a float64 ssd_chunked: "
             + ", ".join(f"{k} {v:.3f}" for k, v in over.items()) if over else ""),
          flush=True)
    return dict(max_abs_err=worst, ms=ms[0], plain_ms=plain[0], bound_ms=bd,
                bound_by=by, library_ms=None, device_ms=ms[1],
                plain_device_ms=plain[1], gflop=ops / 1e9,
                over_tolerance_vs_float64=over or None,
                shape=f"BH={b * h} S={s} P={p} N={n} Q={q} fp32")


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
        for t in layer["attn"].values():
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


# each kernel of the serving path: the names its CUDA functions carry in a
# profiler trace (w2a8's wgmma route quantizes with bitlinear's pass, which
# serving runs for nothing else)
SERVE_KERNELS = {"w2a8_kernel": ("w2a8_kernel", "bitlinear_kernel_quant_rows"),
                 "paged_decode_kernel": ("paged_decode_kernel",),
                 "paged_prefill_kernel": ("paged_prefill_kernel",)}


def profile_steps(dev, cfg, model, scfg, prompts, out_dir, picks=(2, 3, 6, 8),
                  name="profile_engine.txt"):
    """Where the device time of a serving workload goes: fresh engines on
    the same model serve some of its prompts (``picks``) twice, 8 tokens
    each, once timed on the host clock and once under ``torch.profiler``
    (both after the counted run, so the counts and step times above carry
    no profiler cost).  Device time is summed per kernel name from the
    trace's CUDA events; the idle share is 1 - busy / wall, with the wall of
    the unprofiled pass (the profiler's own host cost would inflate it) over
    the same deterministic work.  The top kernels go to ``out_dir/name``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Engine, SamplingParams

    def serve():
        eng = Engine(cfg, model, scfg)
        for i in picks:
            eng.submit(prompts[i], SamplingParams(max_tokens=8, ignore_eos=True))
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
        for key, marks in SERVE_KERNELS.items():
            if any(m in name for m in marks):
                return key
        return "other (PyTorch ops)"

    groups = {}
    for n, us in by_name.items():
        groups[group(n)] = groups.get(group(n), 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    lines = [f"{us / 1e3:10.3f} ms  {us / busy:6.1%}  {n[:110]}" for n, us in top]
    (out_dir / name).write_text(
        f"steps {steps}, wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms\n" + "\n".join(lines) + "\n")
    shares = {k: v / busy for k, v in groups.items()}
    print(f"  profile: {steps} steps, wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (idle share {1 - busy / wall_us:.1%}); "
          + ", ".join(f"{k} {v:.1%}" for k, v in sorted(shares.items()))
          + "; top device operations: "
          + "; ".join(f"{n[:60]} {us / busy:.1%}" for n, us in top[:5]),
          flush=True)
    return dict(steps=steps, wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                idle_share=1 - busy / wall_us, device_time_share=shares,
                top=[(n, us / 1e3) for n, us in top])


def kernel_vs_plain_parity(dev, out_dir):
    """Phase 4: qwen3-0.6b at full width, depth 2, fp32 — the engine with the
    kernels and with the plain paths (attn_impl="gather", use_kernel=False,
    the JAX package's own non-kernel knobs) must give the same greedy
    tokens.  Both paths' tokens and the plain path's top-2 logit gap at each
    token go to ``parity_gaps.json``: how near each choice was to a tie."""
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
        eng = Engine(cfg, model, ServeConfig(
            max_batch=4, max_len=1024, prefill_chunk=32, attn_impl=impl,
            cache_dtype="float32"))
        reqs = [eng.submit(p, SamplingParams(max_tokens=16, ignore_eos=True))
                for p in prompts]
        for _ in eng.stream():
            pass
        outs[tag] = [r.output_tokens for r in reqs]
        if tag == "plain":
            gaps = [_top2_gaps(model, p, o, dev) for p, o in zip(prompts, outs[tag])]
        del eng, model
    (out_dir / "parity_gaps.json").write_text(json.dumps(dict(outs, gaps=gaps)))
    near = sorted((g, r, j) for r, row in enumerate(gaps) for j, g in enumerate(row))
    print("  smallest top-2 logit gaps of the plain path's greedy tokens: "
          + ", ".join(f"request {r} token {j}: {g:.4g}" for g, r, j in near[:3]),
          flush=True)
    if outs["kernels"] != outs["plain"]:
        first = [(r, next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                          min(len(a), len(b))))
                 for r, (a, b) in enumerate(zip(outs["kernels"], outs["plain"]))
                 if a != b]
        fail(f"greedy tokens differ between the kernel and plain paths: "
             f"{outs['kernels']} vs {outs['plain']}; first differences (request, "
             f"token, top-2 logit gap of the plain path there): "
             f"{[(r, j, gaps[r][j] if j < len(gaps[r]) else None) for r, j in first]}")
    print(f"  greedy tokens identical over {len(prompts)} requests x 16 tokens",
          flush=True)


def _top2_gaps(model, prompt, tokens, dev):
    """The top-2 logit gap at each greedy token of ``tokens`` (the
    continuation of ``prompt``), from one forward of ``model`` over both:
    how far each choice was from a tie."""
    return _top2(model, prompt, tokens, dev)[1]


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _top2(model, prompt, tokens, dev):
    """(the top logit, the top-2 gap) at each greedy token of ``tokens``,
    from one forward of ``model`` over the prompt and them.  An MoE FFN runs
    at full capacity, as the engine runs it (a capacity factor of experts /
    top-k makes the capacity the group size)."""
    import torch
    from repro_torch.nn.moe import MoEMLP
    moe = [m for m in model.modules() if isinstance(m, MoEMLP)]
    kept = [m.capacity_factor for m in moe]
    for m in moe:
        m.capacity_factor = m.n_experts / m.top_k
    seq = torch.tensor([list(prompt) + list(tokens[:-1])], device=dev)
    try:
        with torch.no_grad():
            top = model(seq)[0, len(prompt) - 1:].float().topk(2, dim=-1).values
    finally:
        for m, cf in zip(moe, kept):
            m.capacity_factor = cf
    return top[:, 0].tolist(), (top[:, 0] - top[:, 1]).tolist()


# -- phases 5 to 8: the BitDistill training path -------------------------------

TRAIN_BATCH = 8
QWEN_SEQ, MAMBA_SEQ = 256, 512     # MAMBA_SEQ: two chunks of 256 per row
# each kernel of the training paths, by counter name: its package and the
# name its CUDA functions carry in a profiler trace
TRAIN_KERNELS = {"bitlinear": ("bitlinear", "bitlinear_kernel"),
                 "relation_kd": ("relation_kd", "relation_kl_tiles"),
                 "ssd_scan": ("ssd_scan", "ssd_kernel")}


def _train_batches(task: str, seed: int, n: int, dev, seq: int):
    """``n`` batches of the port's synthetic ``task`` from the port's loader,
    on the card (the pipeline's loader seeds: task data seed 0, loader seed
    0 for the task, 17 for the corpus)."""
    import torch
    from repro_torch.data.loader import DataLoader
    from repro_torch.data.synth import get_task
    loader = DataLoader(get_task(task, seed=0), TRAIN_BATCH, seq, seed=seed)
    keys = ("tokens", "labels", "loss_mask")
    return [{k: torch.from_numpy(v).to(dev) for k, v in loader.next().items()
             if k in keys} for _ in range(n)]


def _student_from(teacher, cfg, use_kernel: bool, dev):
    """Stage 1 (refine): the QAT student with SubLN, every tensor the
    teacher has copied from it (``core/pipeline.py::_copy_matching``)."""
    from repro_torch.core import quant as Q
    from repro_torch.core.pipeline import _copy_matching
    from repro_torch.models import build_model
    scfg = cfg.with_quant(Q.QuantConfig(mode="qat", use_kernel=use_kernel))
    return scfg, _copy_matching(teacher, build_model(scfg, device=dev))


def train_full_width(dev, out_dir, name, layers, seq, expect, tag, after=None):
    """Phases 5, 7 and 13b: ``name`` at full width and ``layers`` deep (its
    depth, or cut to that), bf16
    compute with fp32 master weights and remat; an FP teacher from a seeded
    init (no teacher training: the path is what is checked), refine, 3 CE
    steps on the corpus and 5 distillation steps on mnli-syn at batch 8 x
    ``seq``, DistillConfig defaults with every kernel knob on (relation KD
    off for the attention-free ssm family, as the pipeline does).
    ``expect[kind]`` is each counted kernel's launches per step of that
    kind; a step that launches another number fails.  Each step also
    reports its host costs (cudaMalloc / cudaFree calls, allocator retries,
    garbage-collector time), the heap the collector walks is counted and
    fully collected once before the steps, and the card's clock and power
    are sampled into ``clocks_<tag>.csv``.  ``after``, if given, is called
    last with the trained student, its state, teacher and step factory (phase
    10b).  Returns the launch counts of the steps."""
    import importlib
    import torch
    from repro_torch.core.distill import DistillConfig
    from repro_torch.models import build_model, get_config
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import warmup_cosine
    from repro_torch.training.trainer import (default_distill_layer, init_train_state,
                                              make_distill_step, make_train_step)

    cfg = get_config(name).replace(compute_dtype="bfloat16")
    if not (cfg.remat and cfg.param_dtype == "float32" and layers <= cfg.n_layers):
        fail(f"unexpected {name} training config: {cfg}")
    cfg = cfg.replace(n_layers=layers)
    t0 = time.perf_counter()
    teacher = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    scfg, student = _student_from(teacher, cfg, True, dev)
    torch.cuda.synchronize()
    print(f"  teacher + refined student {cfg.name}: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if cfg.family == "ssm":
        dcfg = DistillConfig(use_kernel=True, use_ad=False)
    else:
        dcfg = DistillConfig(use_kernel=True,
                             distill_layer=default_distill_layer(scfg))
    corpus = _train_batches("corpus", 17, 3, dev, seq)
    task = _train_batches("mnli-syn", 0, 6, dev, seq)
    # an MoE student's auxiliary loss of each step: the CE step's metrics
    # carry it (``loss_moe``), the distill step's (as JAX's) do not, so the
    # student's stack output is read in the step's forward
    moe_losses = []
    if any(sp.ffn == "moe" for sp in cfg.resolved_pattern()):
        stack_forward = student.stack.forward

        def tapped(*a, **kw):
            out = stack_forward(*a, **kw)
            if torch.is_grad_enabled():
                moe_losses.append(out[2].detach())
            return out
        student.stack.forward = tapped
    opt = AdamW(AdamWConfig(weight_decay=0.01))
    ct_step = make_train_step(student, opt, lambda s: warmup_cosine(s, 3e-4, 1, 3))
    state = init_train_state(student, opt)
    counters = {k: importlib.import_module(
        f"repro_torch.kernels.{TRAIN_KERNELS[k][0]}.kernel").launches
        for k in expect["train"]}
    log = []
    torch.cuda.reset_peak_memory_stats()
    # what each step costs besides its device work: the caching allocator's
    # cudaMalloc / cudaFree calls and retries, the host's garbage collector,
    # and (sampled every 200 ms into a file) the card's clock and power
    gc_ms = [0.0, 0.0]

    def gc_timer(phase, info):
        if phase == "start":
            gc_ms[1] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_ms[1]) * 1e3

    def census():
        heap = gc.get_objects()
        return len(heap), collections.Counter(
            type(o).__name__ for o in heap).most_common(5)

    # the earlier phases' profiler events hold reference cycles (parent and
    # child events) that only a full collection frees; that collection,
    # seconds long over millions of objects, is taken here and not inside
    # a counted step
    n_heap, kinds = census()
    tc = time.perf_counter()
    gc.collect()
    gc_full_ms = (time.perf_counter() - tc) * 1e3
    n_left, kinds_left = census()
    print(f"  host heap: {n_heap} objects tracked by the garbage collector, "
          f"most common {kinds}; a full collection took {gc_full_ms:.1f} ms "
          f"and left {n_left}, most common {kinds_left}", flush=True)
    gc.callbacks.append(gc_timer)
    clocks = open(out_dir / f"clocks_{tag}.csv", "w")
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active", "--format=csv,noheader",
         "-lms", "200"], stdout=clocks, stderr=subprocess.STDOUT)
    for c in counters.values():
        c.reset()

    def run(kind, step_fn, batch):
        nonlocal state
        before = {k: c.count for k, c in counters.items()}
        torch.cuda.synchronize()
        mem0, gc_ms[0], t_wall = torch.cuda.memory_stats(), 0.0, time.time()
        ts = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - ts) * 1e3
        mem1 = torch.cuda.memory_stats()
        host = {k: mem1.get(k, 0) - mem0.get(k, 0) for k in
                ("num_device_alloc", "num_device_free", "num_alloc_retries")}
        host.update(gc_ms=gc_ms[0], reserved_gib=mem1["reserved_bytes.all.current"]
                    / 2 ** 30, start_unix=t_wall)
        vals = {k: float(v) for k, v in m.items()}
        if moe_losses:
            vals.setdefault("loss_moe", float(moe_losses[-1]))
            moe_losses.clear()
            if vals["loss_moe"] == 0.0:
                fail(f"{name} {kind} step {len(log)}: the MoE auxiliary loss is 0")
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            fail(f"{name} {kind} step {len(log)}: non-finite {bad}: {vals}")
        got = {k: c.count - before[k] for k, c in counters.items()}
        if got != expect[kind]:
            fail(f"{name} {kind} step {len(log)}: launches {got}, expected "
                 f"{expect[kind]} (remat recomputes each student forward)")
        log.append(dict(kind=kind, ms=ms, host=host, **vals))
        parts = " ".join(f"{k} {vals[k]:.5g}" for k in
                         ("loss", "loss_ce", "loss_ld", "loss_ad", "loss_moe",
                          "grad_norm", "lr")
                         if k in vals)
        print(f"  {kind} step {len(log) - 1}: {parts}; {ms:.1f} ms (cudaMalloc "
              f"{host['num_device_alloc']}, cudaFree {host['num_device_free']}, "
              f"alloc retries {host['num_alloc_retries']}, gc {host['gc_ms']:.1f} "
              f"ms, reserved {host['reserved_gib']:.2f} GiB)", flush=True)

    try:
        for b in corpus:
            run("train", ct_step, b)
        state = init_train_state(student, opt)
        kd_step = make_distill_step(student, teacher, opt,
                                    lambda s: warmup_cosine(s, 1e-4, 1, 5), dcfg)
        for b in task[:5]:
            run("distill", kd_step, b)
    finally:
        gc.callbacks.remove(gc_timer)
        smi.terminate()
        smi.wait()
        clocks.close()
    launches = {k: c.count for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for pname, p in student.named_parameters():
        if not bool(torch.isfinite(p).all()):
            fail(f"student parameter {pname} holds non-finite values")
    tok = TRAIN_BATCH * seq
    kd = [r["ms"] for r in log if r["kind"] == "distill"]
    ct = [r["ms"] for r in log if r["kind"] == "train"]
    kd_ms, ct_ms = statistics.median(kd), statistics.median(ct)
    summary = dict(model=cfg.name, layers=cfg.n_layers, batch=TRAIN_BATCH,
                   seq=seq, steps=log, launches=launches,
                   distill_step_ms_median=kd_ms, train_step_ms_median=ct_ms,
                   distill_step_ms_mean=statistics.mean(kd),
                   train_step_ms_mean=statistics.mean(ct),
                   distill_tok_per_s=tok / kd_ms * 1e3,
                   train_tok_per_s=tok / ct_ms * 1e3, peak_mem_gib=peak,
                   heap_objects=n_heap, heap_most_common=kinds,
                   full_gc_ms=gc_full_ms, heap_objects_after_gc=n_left)
    print(f"  median step: CE {ct_ms:.1f} ms ({tok / ct_ms * 1e3:.0f} tok/s; "
          f"mean {statistics.mean(ct):.1f} ms), distill {kd_ms:.1f} ms "
          f"({tok / kd_ms * 1e3:.0f} tok/s; mean {statistics.mean(kd):.1f} ms); "
          f"peak memory {peak:.2f} GiB; launches {launches}", flush=True)
    summary["profile"] = profile_distill_step(kd_step, state, task[5], kd_ms,
                                              cfg.padded_vocab, list(counters),
                                              out_dir / f"profile_{tag}.txt")
    if after is not None:
        summary["after"] = after(dict(
            cfg=scfg, student=student, teacher=teacher, state=state, opt=opt,
            batch=task[5], counters=counters,
            make_step=lambda model: make_distill_step(
                model, teacher, opt, lambda s: warmup_cosine(s, 1e-4, 1, 5), dcfg)))
    (out_dir / f"smoke_{tag}.json").write_text(json.dumps(summary, indent=1))
    del teacher, student, state, kd_step, ct_step
    torch.cuda.empty_cache()
    return launches


def profile_distill_step(step_fn, state, batch, wall_ms, vocab, kernels, path):
    """Where the device time of one distillation step goes, from
    ``torch.profiler`` (after the counted steps, so they carry no profiler
    cost): the path's ``kernels`` by name; the matmuls by the PyTorch op
    that launched them: the tied LM head (an operand with the vocabulary's
    width, forward and backward), the backward's (ops under an autograd
    engine node, the remat recompute and the SSD's recomputed backward
    included) and the forward's (teacher and student projections,
    attention); everything else is glue.  The idle share is 1 - busy / wall,
    with the wall the unprofiled median distillation step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device)
    if busy == 0:
        print("  profile: the trace holds no device time (not measured)", flush=True)
        return None
    kern = {k: 0.0 for k in kernels}
    by_name = {}
    for e in device:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        for k in kernels:
            if TRAIN_KERNELS[k][1] in e.name:
                kern[k] += us
    mm_ops = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
    head = bwd_mm = fwd_mm = 0.0
    for e in events:
        if e.device_type == DeviceType.CUDA or e.name not in mm_ops:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        shapes = e.input_shapes or []
        p, backward = e.cpu_parent, False
        while p is not None and not backward:
            backward = p.name.startswith("autograd::engine::evaluate_function")
            p = p.cpu_parent
        if any(vocab in sh for sh in shapes if isinstance(sh, (list, tuple))):
            head += us
        elif backward:
            bwd_mm += us
        else:
            fwd_mm += us
    glue = busy - sum(kern.values()) - head - bwd_mm - fwd_mm
    shares = {k: v / busy for k, v in kern.items()}
    shares.update(lm_head_matmuls=head / busy, backward_matmuls=bwd_mm / busy,
                  forward_matmuls=fwd_mm / busy, glue=glue / busy)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    path.write_text(
        f"one distill step: wall (unprofiled median) {wall_ms:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms\n" + "\n".join(
            f"{us / 1e3:10.3f} ms  {us / busy:6.1%}  {n[:110]}" for n, us in top)
        + "\n")
    idle = 1 - busy / 1e3 / wall_ms
    print(f"  profile: distill step wall {wall_ms:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (idle share {idle:.1%}) in {len(device)} device "
          "operations; " + ", ".join(f"{k} {v:.1%}" for k, v in shares.items()),
          flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy / 1e3, idle_share=idle,
                device_ops=len(device), device_time_share=shares)


def _activation_codes(student, batch):
    """The int8 code of every activation each BitLinear quantizes, in one
    forward of ``batch`` (no gradient)."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.core.bitlinear import BitLinear
    codes = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: codes.append(
        Q.act_quant_absmax_int8(inp[0])[0].to(torch.int8)))
        for m in student.modules() if isinstance(m, BitLinear)]
    with torch.no_grad():
        student.apply(batch["tokens"])
    for h in hooks:
        h.remove()
    return codes


def train_kernel_vs_plain_parity(dev):
    """Phase 6: qwen3-0.6b at full width, depth 2, fp32: the first
    distillation step from the same weights with both kernel knobs on and
    with both off.  They differ only in summation order and in the relation
    probability clamp (plain path only): loss rtol 1e-4, grad_norm 1e-3,
    the loss's parts 1e-3.  Where the two paths' fp32 results round an int8
    activation code differently, that token's later activations differ and
    flip more codes; the share of codes that differ is printed."""
    import torch
    from repro_torch.core.distill import DistillConfig
    from repro_torch.models import build_model, get_config
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import constant
    from repro_torch.training.trainer import init_train_state, make_distill_step

    cfg = get_config("qwen3-0.6b").replace(n_layers=2, compute_dtype="float32")
    teacher = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    batch = _train_batches("mnli-syn", 0, 1, dev, QWEN_SEQ)[0]
    out, codes = {}, {}
    for tag, use_kernel in (("kernels", True), ("plain", False)):
        _, student = _student_from(teacher, cfg, use_kernel, dev)
        codes[tag] = _activation_codes(student, batch)
        opt = AdamW(AdamWConfig(weight_decay=0.01))
        step = make_distill_step(student, teacher, opt, lambda s: constant(s, 1e-4),
                                 DistillConfig(use_kernel=use_kernel, distill_layer=1))
        _, m = step(init_train_state(student, opt), batch)
        out[tag] = {k: float(v) for k, v in m.items()}
        del student, step, opt
    a, b = out["kernels"], out["plain"]
    rel = {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "loss_ce", "loss_ld",
                                                     "loss_ad", "grad_norm")}
    print("  first distill step, kernels / plain (relative difference): " + ", ".join(
        f"{k} {a[k]:.7g} / {b[k]:.7g} ({rel[k]:.2g})" for k in rel), flush=True)
    n = sum(c.numel() for c in codes["kernels"])
    d = sum(int((x != y).sum()) for x, y in zip(codes["kernels"], codes["plain"]))
    print(f"  int8 activation codes differing between the paths: {d} of {n} "
          f"({d / n:.3g})", flush=True)
    out["codes_differing"] = d / n
    # loss and grad_norm as specified; the parts to 1e-3: int8 activation
    # codes at a .5 boundary round either way under the two paths' fp32
    # differences, which moves the CE part by ~2e-4 at this width
    for k, rtol in (("loss", 1e-4), ("grad_norm", 1e-3), ("loss_ce", 1e-3),
                    ("loss_ld", 1e-3), ("loss_ad", 1e-3)):
        if not (math.isfinite(a[k]) and rel[k] <= rtol):
            fail(f"distill step {k}: kernels {a[k]!r} vs plain {b[k]!r} "
                 f"(rtol {rtol})")
    del teacher
    torch.cuda.empty_cache()
    return out


def mamba_block_parity(dev):
    """Phase 8: one Mamba2Block of mamba2-780m at full width (d_model 1536,
    48 heads of 64, state 128, chunk 256; FP projections, fp32, seeded init)
    on batch 2 x seq 512, forward and backward through the ssd_scan kernel
    (``sequential=False``) and through the sequential oracle
    (``sequential=True``, JAX's other core).  The two sum in another order:
    output rtol 1e-4 atol 1e-4, every parameter's gradient rtol 1e-3 with
    atol 1e-3 of its largest entry."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.nn.module import DTypePolicy
    from repro_torch.nn.ssm import Mamba2Block

    cfg = get_config("mamba2-780m")
    f32 = torch.float32
    blk = Mamba2Block(cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                      chunk=cfg.ssm_chunk, policy=DTypePolicy(f32, f32),
                      gen=torch.Generator(device=dev).manual_seed(2), device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    u = torch.randn((2, MAMBA_SEQ, cfg.d_model), generator=gen, device=dev)
    w = torch.randn((2, MAMBA_SEQ, cfg.d_model), generator=gen, device=dev)
    out, grads = {}, {}
    for sequential in (False, True):
        blk.zero_grad(set_to_none=True)
        y = blk(u, sequential=sequential)
        (y * w).sum().backward()
        out[sequential] = y.detach()
        grads[sequential] = {k: p.grad.detach().clone()
                             for k, p in blk.named_parameters()}
    err = (out[False] - out[True]).abs()
    if not (bool(torch.isfinite(out[False]).all())
            and bool((err <= 1e-4 + 1e-4 * out[True].abs()).all())):
        fail(f"Mamba2Block kernel vs sequential: output max err {err.max().item()}")
    worst = {}
    for k, g in grads[True].items():
        e = (grads[False][k] - g).abs()
        scale = g.abs().max().item()
        if not (bool(torch.isfinite(grads[False][k]).all())
                and bool((e <= 1e-3 * scale + 1e-3 * g.abs()).all())):
            fail(f"Mamba2Block kernel vs sequential: gradient of {k} max err "
                 f"{e.max().item()} (largest entry {scale})")
        worst[k] = e.max().item() / max(scale, 1e-30)
    print(f"  Mamba2Block full width, 2 x {MAMBA_SEQ}: output max err "
          f"{err.max().item():.3g} (max |y| {out[True].abs().max().item():.3g}); "
          "gradient max err / largest entry: "
          + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()), flush=True)
    del blk
    torch.cuda.empty_cache()


# -- phase 9: serving through the entry point -----------------------------------

# the launcher's run: full width, 28 layers, bf16, packed, the async loop
# behind the TCP front end under the supervisor, spans traced
SERVE_CLI = ["--arch", "qwen3-0.6b", "--packed", "--requests", "11",
             "--max-tokens", "32", "--prefix-cache", "--supervise"]
# the device spin queued between step N and step N+1 in 9c (~0.2 s at the
# SM clock of ~1.98 GHz): far longer than step N's device time
SYNC_PROOF_SPIN_CYCLES = 400_000_000


def serve_cli(out_dir):
    """9a: ``python -m repro_torch.launch.serve`` as a user starts it, in a
    subprocess; exit code 0, the fused kernels on the card, its trace
    valid with one request span per request.  Returns the serving kernels'
    launches that the launcher counted over its run (its ``[kernels]``
    line; it zeroes the counters once its engine is built) and its
    committed steps."""
    import os
    from repro_torch.analysis.tracecheck import validate_trace
    trace = out_dir / "serve_trace.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *SERVE_CLI,
           "--trace", str(trace)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=600)
    (out_dir / "serve_cli.txt").write_text(out.stdout)
    if out.returncode != 0:
        fail(f"the serve launcher exited {out.returncode}: "
             f"{out.stdout[-2000:]}")
    lines = out.stdout.splitlines()
    shown = []
    for head in ("[attn] decode impl = fused on cuda", "closed loop:",
                 "finish reasons:", "[kernels] launches", "[steps]", "[ttft]",
                 "[inter-token]", "[step-gap]", "[trace] wrote"):
        hit = [ln for ln in lines if ln.startswith(head)]
        if not hit:
            fail(f"the serve launcher printed no {head!r} line: "
                 f"{out.stdout[-2000:]}")
        shown.append(hit[0])
    doc = json.loads(trace.read_text())
    validate_trace(doc)
    if doc["otherData"]["counts"]["request"] != 11:
        fail(f"the launcher's trace counts {doc['otherData']['counts']}")
    print(f"  launcher: exit 0 in {time.perf_counter() - t0:.1f} s "
          "(process start, init, kernel load, serve)", flush=True)
    for ln in shown:
        print(f"    {ln}", flush=True)
    launches = {k: int(v) for k, v in (
        kv.split("=") for kv in shown[3].split()[2:])}
    steps = int(shown[4].split()[1].split("=")[1])
    return launches, steps


def _serve_tcp(cfg, model, scfg, prompts, plan=None, trace=False):
    """Serve ``prompts`` (greedy, 32 tokens each) through ``FrontendServer``
    + ``AsyncEngine`` + ``ServingSupervisor``, one TCP client per request.
    Every request is acked before the loop starts, so uids, admission and
    each step's batch are the synchronous run's (the paged kernels' split
    plan depends on the batch's depth, and greedy parity on the card is
    held for the same batches).  Returns (tokens per request, wall seconds
    from loop start to the last event, the engine)."""
    import asyncio
    import torch
    from repro_torch.serving import (AsyncEngine, Engine, FrontendServer,
                                     ServeClient)
    from repro_torch.serving.supervisor import ServingSupervisor
    from repro_torch.serving.tracing import Tracer

    def factory():
        e = Engine(cfg, model, scfg)
        if plan is not None:
            e.fault_hook = plan.engine_hook
        return e

    eng = factory()
    if trace:
        eng.tracer = Tracer(clock=eng.clock)
    sup = ServingSupervisor(factory)

    async def main():
        aeng = AsyncEngine(eng, supervisor=sup)
        srv = FrontendServer(aeng)
        await srv.start()
        clients = []
        for p in prompts:
            c = await ServeClient(port=srv.port).connect()
            await c._send({"prompt": p, "max_tokens": 32, "temperature": 0.0,
                           "ignore_eos": True})
            ack = await c._recv()
            if ack.get("finished"):
                fail(f"the front end rejected a request: {ack}")
            clients.append(c)

        async def pump(c):
            evs = []
            while not (evs and evs[-1].get("finished")):
                evs.append(await c._recv())
            return evs

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aeng.start()
        results = await asyncio.gather(*(pump(c) for c in clients))
        wall = time.perf_counter() - t0
        for c in clients:
            await c.close()
        await srv.aclose()
        await aeng.shutdown()
        return results, wall, aeng.engine

    results, wall, eng = asyncio.run(main())
    toks = [[e["token"] for e in evs if e.get("token", -1) >= 0]
            for evs in results]
    return toks, wall, eng


def _gap(st):
    g = st.step_gap_ms or {}
    return f"step gap p50 {g.get('p50', 0):.2f} ms p99 {g.get('p99', 0):.2f} ms"


def serve_entry_point(dev, out_dir):
    """Phase 9: qwen3-0.6b at full width through the serving entry point
    (9a), then phase 3's model and prompts in process through the front
    end, the async loop, the supervisor, the tracer and the journal (9b),
    the off-thread sync's wait (9c), transient faults (9d) and one
    corrupted bf16 KV block (9e).  Returns the serving kernels' launches
    in 9a (the launcher's own count) and in 9b."""
    import tempfile
    import torch
    from repro_torch.analysis.tracecheck import validate_trace
    from repro_torch.core import quant as Q
    from repro_torch.kernels.paged_attention import kernel as pa_k
    from repro_torch.kernels.paged_prefill import kernel as pp_k
    from repro_torch.kernels.w2a8_gemv import kernel as w2_k
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import Engine, SamplingParams, ServeConfig
    from repro_torch.serving.faults import Fault, FaultPlan
    from repro_torch.serving.journal import load_state

    print("  9a: the launcher", flush=True)
    cli_launches, cli_steps = serve_cli(out_dir)

    cfg = get_config("qwen3-0.6b").with_quant(
        Q.QuantConfig(mode="packed", use_kernel=True)).replace(
        compute_dtype="bfloat16")
    model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    prompts = _engine_prompts(cfg.vocab, seed=3)
    prompts.append(prompts[3][:40])
    base = dict(max_batch=8, max_len=1024, prefill_chunk=32,
                prefix_cache=True, cache_dtype="bfloat16")
    greedy = SamplingParams(max_tokens=32, ignore_eos=True)
    n_tok = 32 * len(prompts)

    # the synchronous reference: the same requests, all at t=0
    eng = Engine(cfg, model, ServeConfig(**base))
    reqs = [eng.submit(p, greedy) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in eng.stream():
        pass
    torch.cuda.synchronize()
    sync_wall = time.perf_counter() - t0
    want = [list(r.output_tokens) for r in reqs]
    sync_st = eng.stats()
    del eng

    print("  9b: front end + async loop + supervisor + tracer + journal",
          flush=True)
    counters = (w2_k.launches, pa_k.launches, pp_k.launches)
    with tempfile.TemporaryDirectory(dir=out_dir) as jdir:
        scfg = ServeConfig(**base, journal_dir=jdir)
        for c in counters:
            c.reset()
        got, wall, eng = _serve_tcp(cfg, model, scfg, prompts, trace=True)
        launches = {c.name: c.count for c in counters}
        jstate = load_state(jdir)
    if got != want:
        first = [(i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
                 for i, (x, y) in enumerate(zip(got, want)) if x != y]
        fail(f"the async loop's tokens differ from the synchronous engine's "
             f"(request, first token): {first}")
    st = eng.stats()
    if st.steps_overlapped < 1:
        fail("the async loop overlapped no step (steps_overlapped == 0)")
    doc = eng.tracer.export(str(out_dir / "serve_async_trace.json"))
    validate_trace(doc)
    counts = doc["otherData"]["counts"]
    if (counts["request"], counts["step"], counts["prefill_chunk"]) != (
            st.requests_submitted, st.steps_committed, st.prefill_chunks):
        fail(f"trace counts {counts} disagree with the engine's stats "
             f"({st.requests_submitted} requests, {st.steps_committed} steps, "
             f"{st.prefill_chunks} chunks)")
    live = [e["uid"] for e in jstate.reqs.values() if not e["done"]]
    if live or not jstate.clean_shutdown or len(jstate.reqs) != len(prompts):
        fail(f"journal after drain: live {live}, clean shutdown "
             f"{jstate.clean_shutdown}, {len(jstate.reqs)} requests")
    # every step runs each packed projection once and one attention kernel
    # (decode or chunk) a layer: 9b's launches per step, which must divide
    # evenly, hold for the launcher's run too
    attn = ("paged_attention_decode", "paged_prefill_chunk")
    per_step = launches["w2a8_gemv"] // st.steps_committed
    for path, got_l, steps in (("9a", cli_launches, cli_steps),
                               ("9b", launches, st.steps_committed)):
        for name, n in got_l.items():
            if n < 1:
                fail(f"{path}: kernel {name} was never launched")
        if (got_l["w2a8_gemv"] != per_step * steps
                or sum(got_l[a] for a in attn) != cfg.n_layers * steps):
            fail(f"{path}: launches {got_l} over {steps} steps; want "
                 f"w2a8_gemv = {per_step} x steps and the attention kernels "
                 f"{cfg.n_layers} x steps")
    print(f"    the launcher's run (9a): launches {cli_launches} in "
          f"{cli_steps} steps", flush=True)
    print(f"    tokens identical to the synchronous engine ({len(prompts)} "
          f"requests x 32); steps {st.steps_committed}, overlapped "
          f"{st.steps_overlapped}; trace {counts}; journal {len(jstate.reqs)} "
          f"requests terminal, clean shutdown; launches {launches}", flush=True)
    print(f"    async loop: {n_tok / wall:.1f} tok/s ({wall:.2f} s), "
          f"{_gap(st)}; synchronous loop: {n_tok / sync_wall:.1f} tok/s "
          f"({sync_wall:.2f} s), {sync_st.steps_committed} steps, "
          f"{_gap(sync_st)}", flush=True)
    summary = dict(async_tok_per_s=n_tok / wall, async_wall_s=wall,
                   sync_tok_per_s=n_tok / sync_wall, sync_wall_s=sync_wall,
                   async_step_gap_ms=st.step_gap_ms,
                   sync_step_gap_ms=sync_st.step_gap_ms,
                   steps=st.steps_committed, steps_overlapped=st.steps_overlapped,
                   ttft_ms=st.ttft_ms, launches=launches,
                   cli_launches=cli_launches, cli_steps=cli_steps)
    del eng
    summary["profile"] = _profile_async(cfg, model, ServeConfig(**base),
                                        prompts, out_dir)

    print("  9c: the sync of step N waits on step N's event alone", flush=True)
    summary["sync_proof"] = _sync_proof(cfg, model, ServeConfig(**base),
                                        prompts)

    print("  9d: one transient fault at each of plan, launch, commit",
          flush=True)
    plan = FaultPlan([Fault("plan", "raise", at=1),
                      Fault("launch", "raise", at=3),
                      Fault("commit", "raise", at=5)])
    got, _, eng = _serve_tcp(cfg, model, ServeConfig(**base), prompts, plan=plan)
    st = eng.stats()
    if plan.unfired() or got != want or st.step_retries != 3:
        fail(f"under transient faults: unfired {plan.unfired()}, tokens "
             f"{'equal' if got == want else 'differ'}, retries "
             f"{st.step_retries}")
    print(f"    tokens identical, step_retries {st.step_retries}, failures "
          f"{st.step_failures}, restarts {st.engine_restarts}", flush=True)
    del eng

    print("  9e: one bit flipped in a resident bf16 KV block", flush=True)
    summary["kv_corruption"] = _kv_corruption(cfg, model, base, prompts, want)
    (out_dir / "smoke_serve_entry.json").write_text(json.dumps(summary, indent=1))
    del model
    torch.cuda.empty_cache()
    return cli_launches, launches


def _profile_async(cfg, model, scfg, prompts, out_dir):
    """The device idle share of the async loop: four of the prompts served
    through the front end twice, once timed and once under
    ``torch.profiler`` (idle = 1 - busy / the unprofiled wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    four = [prompts[2], prompts[3], prompts[6], prompts[8]]
    _, wall, _ = _serve_tcp(cfg, model, scfg, four)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, eng = _serve_tcp(cfg, model, scfg, four)
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    wall_ms = wall * 1e3
    if busy == 0:
        print("    profile: the trace holds no device time (not measured)",
              flush=True)
        return None
    print(f"    profile (4 requests x 32 through the front end): wall "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
          f"{1 - busy / wall_ms:.1%}, {eng.stats().steps_committed} steps",
          flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms)


def _sync_proof(cfg, model, scfg, prompts):
    """Launch decode step N, queue a ~0.2 s device spin, then read N's
    tokens on a second thread (as the async loop's executor does) while
    this thread launches step N+1 speculatively on N's device tokens.  The
    read must return before the spin ends (an event recorded after the spin
    still pending, so N+1, queued behind it, has not run) and take less
    than the spin.  A sync of the whole stream (``.cpu()``) would wait for
    the spin.  The read runs beside the launch because a full-width step's
    ~1,000 launches fill the CUDA launch queue behind the spin: a launch
    made first would block until the spin drained."""
    import threading
    import torch
    from repro_torch.serving import Engine, SamplingParams
    eng = Engine(cfg, model, scfg)
    for p in prompts[:8]:
        eng.submit(p[:24], SamplingParams(max_tokens=32, ignore_eos=True))
    while any(eng.sched.pending[s] for s in eng.sched.active_slots()) \
            or eng.sched.waiting:
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    step_n = eng.launch_step(eng.plan_step())
    s0.record()
    torch.cuda._sleep(SYNC_PROOF_SPIN_CYCLES)
    s1.record()
    seen = {}

    def read():
        t0 = time.perf_counter()
        seen["tok"] = eng.sync_tokens(step_n)
        seen["spin_done"] = s1.query()
        seen["wait_ms"] = (time.perf_counter() - t0) * 1e3

    reader = threading.Thread(target=read)
    reader.start()
    spec = eng.plan_spec(step_n)
    if spec is None:
        fail("plan_spec declined a pure-decode step")
    step_n1 = eng.launch_step(spec, feed=step_n)
    reader.join()
    eng.commit_step(step_n, seen["tok"])
    eng.commit_step(step_n1)
    torch.cuda.synchronize()
    spin_ms = s0.elapsed_time(s1)
    print(f"    N's tokens read in {seen['wait_ms']:.3f} ms, the {spin_ms:.1f} ms "
          f"spin ahead of N+1 {'done' if seen['spin_done'] else 'still running'}",
          flush=True)
    if seen["spin_done"] or seen["wait_ms"] >= spin_ms:
        fail(f"the sync of step N waited {seen['wait_ms']:.2f} ms (spin "
             f"{spin_ms:.2f} ms, spin done: {seen['spin_done']})")
    return dict(wait_ms=seen["wait_ms"], spin_ms=spin_ms)


def _kv_corruption(cfg, model, base, prompts, want):
    """9e: the sanitizer with KV checksums; at the third step boundary with
    a checksummed block resident, one bit of one resident bf16 block is
    flipped through the ``device_mem`` site; ``check_kv_integrity`` must
    find exactly that block, its readers are recompute-preempted, and the
    greedy tokens must equal 9b's."""
    from repro_torch.serving import Engine, SamplingParams, ServeConfig
    from repro_torch.serving.faults import Fault, FaultPlan
    plan = FaultPlan([Fault("device_mem", "bitflip", at=2)], seed=7)
    eng = Engine(cfg, model, ServeConfig(**base, sanitize=True,
                                         kv_checksums=True))
    reqs = [eng.submit(p, SamplingParams(max_tokens=32, ignore_eos=True))
            for p in prompts]
    victims, found, preempted = [], [], []
    while eng.has_pending():
        eng.step()
        v = plan.device_mem_hook(eng)
        if v is not None:
            victims.append(v)
            bad = eng.check_kv_integrity()
            found.extend(bad)
            preempted.extend(eng.recover_corrupt_blocks(bad))
    got = [list(r.output_tokens) for r in reqs]
    if victims != found or len(victims) != 1 or not preempted:
        fail(f"KV corruption: flipped {victims}, found {found}, preempted "
             f"{preempted}")
    if eng.check_kv_integrity():
        fail("KV blocks still corrupt after recovery")
    if got != want:
        first = [(i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
                 for i, (x, y) in enumerate(zip(got, want)) if x != y]
        fail(f"greedy tokens after KV recovery differ (request, first "
             f"token): {first}")
    st = eng.stats()
    print(f"    block {victims[0]} flipped, found by check_kv_integrity, "
          f"{len(preempted)} reader(s) preempted and recomputed; tokens "
          f"identical; kv_corruptions {st.kv_corruptions}, preemptions "
          f"{st.preemptions}", flush=True)
    return dict(block=victims[0], preempted=preempted,
                preemptions=st.preemptions)


# -- phase 10: the training launcher, checkpoints, remat policies, Table 4 -------

# the launcher as a user starts it: full width, 6 CE steps; the depth cut
# to 2 of qwen3-0.6b's 28 layers (``--layers``), which cuts the checkpoints
# the phase writes and reads (~7 of them) from 7.15 GB to ~2.25 GB each (the
# tied embedding and its moments are 1.87 GB of it), to keep the run inside
# its time limit
LAUNCH_LAYERS = 2
LAUNCH_CLI = ["--arch", "qwen3-0.6b", "--layers", str(LAUNCH_LAYERS), "--steps", "6",
              "--batch", "8", "--seq", "256",
              "--task", "corpus", "--log-every", "1"]
# a resumed run must end where the uninterrupted run ended: the same leaves,
# steps and loader state, and every float leaf within this relative
# difference of run 1's (0: bitwise, as the CPU test holds and as the card
# has shown; PERF.md §6)
RESUME_RTOL = 0.0
# share of ternary codes that may differ between the card and the CPU per
# scheme (every scale is a float64 mean rounded once on both)
SCHEME_FLIP_SHARE = 1e-4


def _qwen_qat_template(cfg):
    """A shape-only (``meta``) JAX-layout train state of ``cfg``: the
    template ``load_checkpoint`` restores onto."""
    from repro_torch import bridge
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.trainer import init_train_state
    state = init_train_state(build_model(cfg, device="meta"), AdamW())
    return bridge.train_state_to_jax(cfg, state, device="meta")


def _launcher(ckpt_dir, log, sigterm_after=None):
    """One ``python -m repro_torch.launch.train`` run in a subprocess; with
    ``sigterm_after`` (a step index) SIGTERM is sent once that step's line
    is printed.  -> (exit code, output, seconds)."""
    import os
    import signal
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_CLI,
         "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "100"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if sigterm_after is not None and line.startswith(f"step {sigterm_after} "):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=900)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    log.write_text(out)
    return proc.returncode, out, time.perf_counter() - t0


def _step_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("step ")]


def _leaf_groups(a, b):
    """Largest absolute and relative difference of two flat checkpoints per
    leaf group (params, m, v); non-float leaves must be equal."""
    import torch
    groups = {}
    for k, x in a.items():
        y = b[k]
        if not x.is_floating_point():
            if not torch.equal(x, y):
                fail(f"leaf {k}: {x.tolist() if x.numel() < 8 else x.shape} vs "
                     f"{y.tolist() if y.numel() < 8 else y.shape}")
            continue
        g = ("params" if k.startswith("params/") else
             "m" if k.startswith("opt_state/m/") else "v")
        d = (x.float() - y.float()).abs()
        rel = d / y.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
        cur = groups.setdefault(g, [0.0, 0.0, 0, 0])
        cur[0] = max(cur[0], float(d.max()))
        cur[1] = max(cur[1], float(rel.max()))
        cur[2] += int((d != 0).sum())
        cur[3] += d.numel()
    return {g: dict(max_abs=v[0], max_rel=v[1], differing=v[2], elements=v[3])
            for g, v in groups.items()}


def launcher_checkpoints(dev, out_dir):
    """10a: the training launcher as a user starts it, at full width
    (qwen3-0.6b cut to ``LAUNCH_LAYERS`` layers, 6 CE steps at 8 x 256): run 1
    uninterrupted; run 2 sent SIGTERM after its ``step 1`` line (it must
    save and exit 0); run 3 restarting run 2's directory (it must resume
    and reach step 6).  Run 3's final checkpoint is held to run 1's leaf by
    leaf.  Then, in this process, the load time of that checkpoint into a
    fresh full-width state, ``save_async``'s host stall and the write behind
    it, and a synchronous ``emergency_save``.  Checks the free disk first;
    keeps at most three checkpoints and removes them."""
    import importlib.util
    import shutil
    import torch
    from repro_torch import bridge
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.checkpoint.ckpt import latest_step
    from repro_torch.core import quant as Q
    from repro_torch.models import build_model, get_config
    from repro_torch.nn.module import flatten_with_paths, tree_bytes
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.trainer import init_train_state

    cfg = get_config("qwen3-0.6b").replace(n_layers=LAUNCH_LAYERS).with_quant(Q.QAT)
    tmpl = _qwen_qat_template(cfg)
    ckpt_bytes = tree_bytes(tmpl)
    base = out_dir / "launcher_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir()
    need = 3 * ckpt_bytes + (1 << 30)
    free = shutil.disk_usage(base).free
    print(f"  checkpoint {ckpt_bytes / 1e9:.3f} GB ({len(flatten_with_paths(tmpl))} "
          f"leaves); free disk {free / 1e9:.1f} GB, need {need / 1e9:.1f} GB; "
          f"msgpack importable: {importlib.util.find_spec('msgpack') is not None}, "
          f"zstandard importable: {importlib.util.find_spec('zstandard') is not None}",
          flush=True)
    if free < need:
        fail(f"phase 10a needs {need / 1e9:.1f} GB of free disk under {base} for "
             f"three checkpoints; {free / 1e9:.1f} GB free, "
             f"{(need - free) / 1e9:.1f} GB short")
    torch.cuda.empty_cache()
    out = {}
    try:
        rc, o1, s1 = _launcher(base / "run1", out_dir / "launcher_run1.log")
        if rc != 0 or not o1.strip().endswith("done") or len(_step_lines(o1)) != 6:
            fail(f"launcher run 1: exit {rc}, output tail {o1[-2000:]}")
        rc, o2, s2 = _launcher(base / "run2", out_dir / "launcher_run2.log",
                               sigterm_after=1)
        k = latest_step(base / "run2")
        if rc != 0 or "[sigterm] emergency checkpoint" not in o2 or k is None \
                or not 2 <= k < 6:
            fail(f"launcher run 2 (SIGTERM after step 1): exit {rc}, latest step "
                 f"{k}, output tail {o2[-2000:]}")
        rc, o3, s3 = _launcher(base / "run2", out_dir / "launcher_run3.log")
        steps3 = [ln.split()[1] for ln in _step_lines(o3)]
        if rc != 0 or f"[resume] from step {k}" not in o3 or \
                steps3 != [str(i) for i in range(k, 6)] or not o3.strip().endswith("done"):
            fail(f"launcher run 3 (resume): exit {rc}, steps {steps3}, output tail "
                 f"{o3[-2000:]}")
        for tag, o, s in (("run 1", o1, s1), ("run 2", o2, s2), ("run 3", o3, s3)):
            print(f"  launcher {tag}: {s:.1f} s; " + "; ".join(_step_lines(o)), flush=True)
        print(f"  run 2 saved at step {k} on SIGTERM; run 3 resumed there", flush=True)
        a, ea, sa = load_checkpoint(base / "run1", tmpl, device=dev)
        b, eb, sb = load_checkpoint(base / "run2", tmpl, device=dev)
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        if (sa, ea) != (sb, eb) or sa != 6 or list(fa) != list(fb):
            fail(f"final checkpoints differ in step/loader/leaves: {sa} {ea} vs "
                 f"{sb} {eb}")
        groups = _leaf_groups(fb, fa)
        del a, b, fa, fb
        torch.cuda.empty_cache()
        print("  resumed vs uninterrupted, final checkpoint: " + "; ".join(
            f"{g} max abs {v['max_abs']:.3g}, max rel {v['max_rel']:.3g}, "
            f"{v['differing']} of {v['elements']} differ" for g, v in groups.items())
            + f"; loader {ea}", flush=True)
        worst = max(v["max_rel"] for v in groups.values())
        if worst > RESUME_RTOL:
            fail(f"the resumed run's final state is {worst:.3g} (relative) from the "
                 f"uninterrupted run's; tolerance {RESUME_RTOL}")
        shutil.rmtree(base / "run1")
        # the card's times: load into a fresh full-width state, then save
        model = build_model(cfg, device=dev)
        state = init_train_state(model, AdamW(AdamWConfig()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, extra, step = load_checkpoint(base / "run2", tmpl, device=dev)
        bridge.load_train_state(cfg, tree, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del tree
        shutil.rmtree(base / "run2")
        mgr = CheckpointManager(base / "timed")
        t0 = time.perf_counter()
        mgr.save_async(step, bridge.train_state_to_jax(cfg, state), extra=extra)
        stall_s = time.perf_counter() - t0
        mgr.wait()
        async_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr.emergency_save(step + 1, bridge.train_state_to_jax(cfg, state), extra=extra)
        sync_s = time.perf_counter() - t0
        files = sorted((base / "timed" / f"step_{step + 1:08d}").iterdir())
        size = {f.name: f.stat().st_size for f in files}
        out = dict(ckpt_bytes=ckpt_bytes, files=size, resumed_at=k, groups=groups,
                   load_s=load_s, save_async_stall_s=stall_s, save_async_total_s=async_s,
                   emergency_save_s=sync_s, run_s=[s1, s2, s3])
        print(f"  checkpoint files {size}; load into a fresh state {load_s:.2f} s; "
              f"save_async host stall {stall_s:.2f} s (written {async_s:.2f} s after "
              f"the call); synchronous emergency_save {sync_s:.2f} s", flush=True)
        del model, state
        gc.collect()
    finally:
        shutil.rmtree(base, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def checkpoint_round_trip(ctx, out_dir):
    """10b: phase 5's student after its distillation steps (both kernel knobs
    on) saved through ``CheckpointManager.save_async``, loaded into a freshly
    built student: every leaf ``torch.equal`` to the live state; then one
    more distillation step from each, whose losses must be equal (bitwise,
    or else within phase 6's rtol 1e-4, said which).  Returns the kernels'
    launches in those two steps."""
    import shutil
    import torch
    from repro_torch import bridge
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.models import build_model
    from repro_torch.nn.module import flatten_with_paths
    from repro_torch.training.trainer import init_train_state

    cfg, state = ctx["cfg"], ctx["state"]
    d = out_dir / "ckpt_10b"
    shutil.rmtree(d, ignore_errors=True)
    try:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save_async(state.step, bridge.train_state_to_jax(cfg, state))
        stall = time.perf_counter() - t0
        mgr.wait()
        written = time.perf_counter() - t0
        fresh = build_model(cfg, device=ctx["student"].embed.table.device)
        fresh_state = init_train_state(fresh, ctx["opt"])
        t0 = time.perf_counter()
        tree, _, step = load_checkpoint(d, bridge.train_state_to_jax(
            cfg, fresh_state, device="meta"), device=fresh.embed.table.device)
        bridge.load_train_state(cfg, tree, fresh_state)
        torch.cuda.synchronize()
        loaded = time.perf_counter() - t0
        del tree
    finally:
        shutil.rmtree(d, ignore_errors=True)
    live = flatten_with_paths(bridge.train_state_to_jax(cfg, state))
    back = flatten_with_paths(bridge.train_state_to_jax(cfg, fresh_state))
    if list(live) != list(back) or step != state.step:
        fail(f"10b: reloaded leaves/step differ: {step} vs {state.step}")
    bad = [k for k in live if not torch.equal(live[k], back[k])]
    if bad:
        fail(f"10b: reloaded leaves not equal to the live state: {bad[:5]}")
    n = len(live)
    del live, back
    counters = ctx["counters"]
    for c in counters.values():
        c.reset()
    m_live = ctx["make_step"](ctx["student"])(state, ctx["batch"])[1]
    m_back = ctx["make_step"](fresh)(fresh_state, ctx["batch"])[1]
    launches = {k: c.count for k, c in counters.items()}
    a, b = float(m_live["loss"]), float(m_back["loss"])
    bitwise = a == b
    print(f"  10b: save_async of the live state (step {state.step}): host stall "
          f"{stall:.2f} s, written {written:.2f} s; loaded into a fresh student in "
          f"{loaded:.2f} s; {n} leaves torch.equal; next distill step loss live "
          f"{a!r} / reloaded {b!r} ({'bitwise' if bitwise else 'not bitwise'}); "
          f"launches {launches}", flush=True)
    if not (bitwise or abs(a - b) <= 1e-4 * abs(b)):
        fail(f"10b: the distill step from the reloaded state gives loss {b!r}, the "
             f"live state's {a!r} (rtol 1e-4)")
    del fresh, fresh_state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(stall_s=stall, written_s=written, load_s=loaded,
                          leaves=n, loss_live=a, loss_reloaded=b, bitwise=bitwise)


class _GradTap:
    """An AdamW that keeps a copy of the gradients it is given."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, *a, **kw):
        return self.opt.init(*a, **kw)

    def update(self, grads, *a, **kw):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.opt.update(grads, *a, **kw)


def remat_policies(dev):
    """10c: one phase-5 distillation step (qwen3-0.6b, full width and depth,
    8 x 256, bf16 compute) from the same weights under ``remat_policy``
    nothing, dots and none, on the kernel route (both kernel knobs on) and
    on the plain QAT route: loss, gradients, the step's peak memory above
    what was allocated before it (the student, its moments and the
    teacher; the peak statistic reset before each step, the previous run's
    tensors collected) and the wall time of a second step (the first grows
    the allocator).  The losses and gradients of the first step must be
    equal across the policies (bitwise); on the plain route dots's peak
    must lie between nothing's and none's.  Returns the kernels' launches
    and the numbers."""
    import importlib
    import torch
    from repro_torch.core.distill import DistillConfig
    from repro_torch.models import build_model, get_config
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import constant
    from repro_torch.training.trainer import (default_distill_layer, init_train_state,
                                              make_distill_step)

    base = get_config("qwen3-0.6b")
    teacher = build_model(base, gen=torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    batch = _train_batches("mnli-syn", 0, 1, dev, QWEN_SEQ)[0]
    counters = {k: importlib.import_module(
        f"repro_torch.kernels.{TRAIN_KERNELS[k][0]}.kernel").launches
        for k in ("bitlinear", "relation_kd")}
    for c in counters.values():
        c.reset()
    out = {}
    for route, use_kernel in (("kernels", True), ("plain", False)):
        ref = None
        for policy in ("nothing", "dots", "none"):
            cfg = base.replace(remat_policy=policy)
            scfg, student = _student_from(teacher, cfg, use_kernel, dev)
            opt = _GradTap(AdamW(AdamWConfig(weight_decay=0.01)))
            step = make_distill_step(student, teacher, opt, lambda s: constant(s, 1e-4),
                                     DistillConfig(use_kernel=use_kernel,
                                                   distill_layer=default_distill_layer(scfg)))
            state = init_train_state(student, opt)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            m = step(state, batch)[1]
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
            loss = float(m["loss"])
            if ref is None:
                ref, same, worst = (loss, opt.grads), True, 0.0
            else:
                same = loss == ref[0] and all(torch.equal(g, ref[1][k])
                                              for k, g in opt.grads.items())
                worst = max(float((g - ref[1][k]).abs().max())
                            for k, g in opt.grads.items())
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out[f"{route}/{policy}"] = dict(loss=loss, peak_above_state_gib=peak,
                                            state_gib=before / 2 ** 30, ms=ms,
                                            equal_to_nothing=same,
                                            max_abs_grad_diff=worst)
            print(f"  10c {route} route, remat {policy}: loss {loss!r}, peak "
                  f"{peak:.3f} GiB above the {before / 2 ** 30:.3f} GiB allocated "
                  f"before the step, second step {ms:.1f} ms, loss and gradients "
                  f"{'bitwise equal to' if same else 'DIFFER from'} nothing's "
                  f"(max abs gradient difference {worst:.3g})", flush=True)
            del student, step, state, opt, m
            gc.collect()        # the step's closures hold the student in cycles
            torch.cuda.empty_cache()
            if not same:
                fail(f"10c: remat {policy} on the {route} route changes the loss or "
                     "the gradients")
        del ref
    p = {k: out[f"plain/{k}"]["peak_above_state_gib"] for k in ("nothing", "dots", "none")}
    if not p["nothing"] < p["dots"] < p["none"]:
        fail(f"10c: on the plain route dots's peak memory {p['dots']:.3f} GiB is not "
             f"between nothing's {p['nothing']:.3f} and none's {p['none']:.3f}")
    launches = {k: c.count for k, c in counters.items()}
    print(f"  10c launches: {launches}", flush=True)
    del teacher
    torch.cuda.empty_cache()
    return launches, out


def table4_schemes(dev):
    """10d: ``fake_quant_weight`` of each Table-4 scheme and
    ``fake_quant_weight_lp`` at the full-width projection shapes [1024,
    3072] and [3072, 1024], on the card and on the CPU: the share of
    dequantized weights (codes) that differ must stay within
    SCHEME_FLIP_SHARE; the card's time of each.  Then one CE QAT step of
    full-width qwen3-0.6b with the blockwise scheme: a finite loss."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.models import build_model, get_config
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import constant
    from repro_torch.training.trainer import init_train_state, make_train_step

    out = {}
    for shape in ((1024, 3072), (3072, 1024)):
        w = torch.randn(shape, generator=torch.Generator().manual_seed(shape[0])) * 0.02
        wd = w.to(dev)
        cases = [(s, (lambda s=s: Q.fake_quant_weight(wd, s)),
                  (lambda s=s: Q.fake_quant_weight(w, s)))
                 for s in ("absmean", "blockwise", "awq", "gptq")]
        wb, wbd = w.to(torch.bfloat16), wd.to(torch.bfloat16)
        cases.append(("lp", lambda: Q.fake_quant_weight_lp(wbd),
                      lambda: Q.fake_quant_weight_lp(wb)))
        for name, card, cpu in cases:
            t0 = time.perf_counter()
            want = cpu()
            cpu_ms = (time.perf_counter() - t0) * 1e3
            got = card().cpu()
            share = float((got != want).float().mean())
            iters = 3 if name == "gptq" else 20
            ms = time_ms(card, iters=iters, warmup=1)
            out[f"{name} {shape[0]}x{shape[1]}"] = dict(ms=ms, cpu_ms=cpu_ms,
                                                       share_differing=share)
            print(f"  10d {name} [{shape[0]}, {shape[1]}]: card {ms:.4f} ms "
                  f"(median of {iters}), CPU {cpu_ms:.1f} ms, codes differing card "
                  f"vs CPU {share:.3g}", flush=True)
            if share > SCHEME_FLIP_SHARE:
                fail(f"10d: {name} at {shape}: {share:.3g} of the codes differ "
                     f"between the card and the CPU (bound {SCHEME_FLIP_SHARE})")
    cfg = get_config("qwen3-0.6b").with_quant(Q.QuantConfig(mode="qat",
                                                            scheme="blockwise"))
    model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = AdamW(AdamWConfig())
    step = make_train_step(model, opt, lambda s: constant(s, 1e-4))
    batch = _train_batches("corpus", 17, 1, dev, QWEN_SEQ)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step(init_train_state(model, opt), batch)[1]["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    print(f"  10d blockwise CE QAT step, qwen3-0.6b full width 8 x {QWEN_SEQ}: loss "
          f"{loss!r}, {ms:.1f} ms (first step)", flush=True)
    if not math.isfinite(loss):
        fail(f"10d: the blockwise CE step's loss is {loss!r}")
    out["blockwise_step"] = dict(loss=loss, ms=ms)
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 11: serving mamba2-780m on the contiguous cache --------------------------

# 16 slots put every decode and chunk pass of w2a8 on its wgmma route
MAMBA_SERVE = dict(max_batch=16, max_len=128, prefill_chunk=32,
                   cache_dtype="bfloat16")
MAMBA_CLI = ["--arch", "mamba2-780m", "--packed", "--requests", "8",
             "--max-tokens", "16", "--prompt-len", "16"]


def _mamba_prompts(vocab: int, seed: int = 7):
    """Sixteen prompts of 8..64 tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)).tolist()
            for n in rng.integers(8, 65, 16)]


class _PassCounter:
    """Counts a model's decode passes (``CausalLM.decode_step`` calls):
    every pass runs each layer's in_proj and out_proj once."""

    def __init__(self, model):
        self.n, self._model, inner = 0, model, model.decode_step

        def counted(*a, **kw):
            self.n += 1
            return inner(*a, **kw)
        model.decode_step = counted

    def close(self):
        del self._model.decode_step


def _serve_all(cfg, model, scfg, prompts, step_ms=None, tokens=16):
    """The prompts at t=0, ``tokens`` greedy tokens each, on the synchronous
    engine; (tokens per prompt, engine)."""
    import torch
    from repro_torch.serving import Engine, SamplingParams
    eng = Engine(cfg, model, scfg)
    reqs = [eng.submit(p, SamplingParams(max_tokens=tokens, ignore_eos=True))
            for p in prompts]
    while eng.has_pending():
        ts = time.perf_counter()
        eng.step()
        if step_ms is not None:
            step_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    for r in reqs:
        if not r.done or len(r.output_tokens) != tokens or not all(
                0 <= t < cfg.vocab for t in r.output_tokens):
            fail(f"request {r.uid}: done {r.done}, tokens {r.output_tokens}")
    return [list(r.output_tokens) for r in reqs], eng


def serve_mamba(dev, out_dir):
    """Phase 11: mamba2-780m at full width and depth (48 layers, packed
    ternary weights from the port's seeded init, bf16) through the port's
    ``Engine`` on the contiguous cache: (a) 16 requests on the kernel route,
    w2a8 counted at 96 launches a decode pass and the paged kernels at 0,
    then on the plain route (``use_kernel=False``) with identical greedy
    tokens, and a profile of a few steps; (b) a request served after
    another in the same slot gives its tokens alone; (c) one transient
    fault at each of plan, launch and commit under the supervisor, through
    the async loop with speculative launches, leaves (a)'s tokens; (d) the
    serve launcher with ``--arch mamba2-780m`` exits 0 on the contiguous
    cache.  Returns the serving kernels' launches in (a) and in (d)."""
    import asyncio
    import os
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.paged_attention import kernel as pa_k
    from repro_torch.kernels.paged_prefill import kernel as pp_k
    from repro_torch.kernels.w2a8_gemv import kernel as w2_k
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import AsyncEngine, Engine, SamplingParams, ServeConfig
    from repro_torch.serving.faults import Fault, FaultPlan
    from repro_torch.serving.supervisor import ServingSupervisor

    base = get_config("mamba2-780m").replace(compute_dtype="bfloat16")
    cfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=True))
    t0 = time.perf_counter()
    model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    print(f"  init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {time.perf_counter() - t0:.1f} s", flush=True)
    prompts = _mamba_prompts(cfg.vocab)
    scfg = ServeConfig(**MAMBA_SERVE)
    per_pass = 2 * cfg.n_layers

    print("  11a: 16 requests on the kernel route, then the plain route",
          flush=True)
    counters = (w2_k.launches, pa_k.launches, pp_k.launches)
    passes = _PassCounter(model)
    for c in counters:
        c.reset()
    step_ms = []
    t_run = time.perf_counter()
    want, eng = _serve_all(cfg, model, scfg, prompts, step_ms)
    wall = time.perf_counter() - t_run
    launches = {c.name: c.count for c in counters}
    n_pass = passes.n
    passes.close()
    st = eng.stats()
    if eng.paged or eng._ring is None:
        fail(f"mamba2-780m resolved to paged={eng.paged}, ring {eng._ring}")
    at = eng._ring.committed
    for t in (eng._ring.state[at], eng._ring.conv[at]):
        if not bool(torch.isfinite(t).all()):
            fail("the committed recurrent state holds non-finite values")
    if launches["w2a8_gemv"] != per_pass * n_pass:
        fail(f"w2a8 launched {launches['w2a8_gemv']} times over {n_pass} decode "
             f"passes; want {per_pass} a pass")
    if launches["paged_attention_decode"] or launches["paged_prefill_chunk"]:
        fail(f"a paged kernel ran on the contiguous cache: {launches}")
    state_bytes = eng.kv_cache_bytes()
    del eng
    plain_cfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=False))
    plain = build_model(plain_cfg, device=dev)
    plain.load_state_dict(model.state_dict())
    t_plain = time.perf_counter()
    got, eng = _serve_all(plain_cfg, plain, scfg, prompts)
    plain_wall = time.perf_counter() - t_plain
    del eng, plain
    if got != want:
        first = [(i, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y))
                 for i, (a, b) in enumerate(zip(got, want)) if a != b]
        fail(f"plain-route greedy tokens differ from the kernel route's "
             f"(request, first token): {first}")
    toks = 16 * len(prompts)
    ordered = sorted(step_ms)
    pct = {q: ordered[min(len(ordered) - 1, int(q / 100 * len(ordered)))]
           for q in (50, 90, 99)}
    summary = dict(model=cfg.name, layers=cfg.n_layers, requests=len(prompts),
                   prompt_lens=[len(p) for p in prompts], tokens=toks,
                   wall_s=wall, tok_per_s=toks / wall, steps=len(step_ms),
                   passes=n_pass, ms_per_pass=wall * 1e3 / n_pass,
                   step_ms_p50=pct[50], step_ms_p90=pct[90], step_ms_p99=pct[99],
                   ttft_ms=st.ttft_ms, state_bytes=state_bytes,
                   plain_wall_s=plain_wall, launches=launches)
    print(f"    kernel route: {len(prompts)} requests, {toks} tokens in {wall:.2f} s: "
          f"{toks / wall:.1f} tok/s; {len(step_ms)} steps, {n_pass} decode passes "
          f"({wall * 1e3 / n_pass:.1f} ms a pass); step ms p50 {pct[50]:.1f} p90 "
          f"{pct[90]:.1f} p99 {pct[99]:.1f}; state {state_bytes / 2**20:.1f} MiB "
          f"(3 ring buffers); launches {launches}", flush=True)
    print(f"    plain route: greedy tokens identical ({len(prompts)} requests x 16), "
          f"{plain_wall:.2f} s", flush=True)
    shortest = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:4]
    summary["profile"] = profile_steps(dev, cfg, model, scfg, prompts, out_dir,
                                       picks=shortest, name="profile_mamba.txt")

    print("  11b: a request after another in the same slot", flush=True)
    one = ServeConfig(**dict(MAMBA_SERVE, max_batch=1))
    a, b = prompts[0][:8], prompts[1][:3]
    alone = _serve_all(cfg, model, one, [b])[0][0]
    after = _serve_all(cfg, model, one, [a, b])[0][1]
    if after != alone:
        fail(f"slot reuse: {after} after another request, {alone} alone")
    print("    tokens equal to the request served alone", flush=True)

    print("  11c: one transient fault at each of plan, launch, commit (async "
          "loop, supervised)", flush=True)
    plan = FaultPlan([Fault("plan", "raise", at=1),
                      Fault("launch", "raise", at=3),
                      Fault("commit", "raise", at=5)])

    def factory():
        e = Engine(cfg, model, scfg)
        e.fault_hook = plan.engine_hook
        return e

    async def faulted():
        aeng = AsyncEngine(factory(), supervisor=ServingSupervisor(factory))
        aeng.start()
        rs = [aeng.submit(p, SamplingParams(max_tokens=16, ignore_eos=True))
              for p in prompts]
        await aeng.shutdown()
        return [list(r.output_tokens) for r in rs], aeng.engine.stats()

    got, fst = asyncio.run(faulted())
    # each fault is one failure; a fault on a speculative launch drops the
    # speculation without a retry, the commit's is always retried
    if plan.unfired() or got != want or fst.step_failures != 3 or \
            fst.step_retries < 1:
        fail(f"under transient faults: unfired {plan.unfired()}, tokens "
             f"{'equal' if got == want else 'differ'}, failures "
             f"{fst.step_failures}, retries {fst.step_retries}")
    print(f"    tokens identical, step_failures {fst.step_failures}, "
          f"step_retries {fst.step_retries}, overlapped "
          f"{fst.steps_overlapped} of {fst.steps_committed} steps", flush=True)
    summary["faults"] = dict(failures=fst.step_failures, retries=fst.step_retries,
                             overlapped=fst.steps_overlapped,
                             steps=fst.steps_committed)
    del model
    torch.cuda.empty_cache()

    print("  11d: the launcher, --arch mamba2-780m", flush=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *MAMBA_CLI]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=600)
    (out_dir / "serve_cli_mamba.txt").write_text(out.stdout)
    lines = out.stdout.splitlines()
    kv = [ln for ln in lines if ln.startswith("[kv-cache] contiguous")]
    kl = [ln for ln in lines if ln.startswith("[kernels] launches")]
    if out.returncode != 0 or not kv or not kl:
        fail(f"the mamba serve launcher exited {out.returncode}: "
             f"{out.stdout[-2000:]}")
    cli = {k: int(v) for k, v in (kv_.split("=") for kv_ in kl[0].split()[2:])}
    if cli["w2a8_gemv"] < per_pass or cli["w2a8_gemv"] % per_pass or \
            cli["paged_attention_decode"] or cli["paged_prefill_chunk"]:
        fail(f"the mamba launcher's launches {cli}")
    print(f"    exit 0 in {time.perf_counter() - t0:.1f} s; {kv[0]}; {kl[0]}",
          flush=True)
    summary["cli_launches"] = cli
    (out_dir / "smoke_mamba_serve.json").write_text(json.dumps(summary, indent=1))
    return launches, cli


# -- phase 12: the dense configs, gemma-7b at full width ------------------------------

# phase 3's ServeConfig and tokens a request, for the full-width packed
# models of phases 12a and 13a
PACKED_SERVE = dict(max_batch=8, max_len=1024, prefill_chunk=32, prefix_cache=True,
                    cache_dtype="bfloat16")
GEMMA_CLI = ["--arch", "gemma-7b", "--packed", "--requests", "8",
             "--max-tokens", "16", "--prompt-len", "16"]
PACKED_TOKENS = 32


def _common_prefix(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


# 12a's and 13a's depths: half of gemma-7b's 28 and granite's 24 layers,
# cut to keep the full run inside its time limit (12c serves gemma whole)
GEMMA_SERVE_LAYERS, GRANITE_SERVE_LAYERS = 14, 12


def serve_gemma(dev, out_dir):
    """12a: gemma-7b at full width (d_model 3072, 16 kv heads of 256, d_ff
    24576, a tied 256,000-word vocabulary, GeGLU, embed_scale) and
    ``GEMMA_SERVE_LAYERS`` of its 28 layers, as ``serve_packed`` serves it:
    w2a8 counted at 7 a layer a step.  The plain route's tokens are not a gate: at bf16
    over 28 layers the two routes sum in other orders and a near tie may go
    either way."""
    return serve_packed(dev, out_dir, "gemma-7b", 7, "gemma", gate_plain=False,
                        layers=GEMMA_SERVE_LAYERS)


def serve_packed(dev, out_dir, name, per_layer, tag, gate_plain, layers=None):
    """``name`` at full width and depth (or ``layers`` deep), packed ternary
    weights from the
    port's seeded init, bf16, through the port's ``Engine``: phase 3's
    prompts at t=0 x 32 greedy tokens.  Gates: the engine resolves
    ``"fused"``, every request gets its tokens, w2a8 counts ``per_layer`` a
    layer a step and the paged kernels one a layer a step.  Prints step
    percentiles, tok/s, KV bytes, peak memory and a profile's idle share
    and top device operations (``profile_<tag>.txt``), and the count of
    tokens the plain route (``"gather"``, ``use_kernel=False``) gives alike
    before a request's first difference; with ``gate_plain`` the two routes
    must give identical tokens, and a difference fails with the plain
    route's top-2 logit gap there (phase 4's diagnosis), unless that gap
    is a bf16 tie (at most one bf16 ulp of the top logit: the logits are
    bf16, and the paged kernels' other summation order decides a tie).
    Returns the serving kernels' launches and the summary."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.paged_attention import kernel as pa_k
    from repro_torch.kernels.paged_prefill import kernel as pp_k
    from repro_torch.kernels.w2a8_gemv import kernel as w2_k
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import ServeConfig

    base = get_config(name).replace(compute_dtype="bfloat16")
    if layers is not None:
        base = base.replace(n_layers=layers)
    cfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=True))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    print(f"  init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_kv_heads} kv heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB held", flush=True)
    scfg = ServeConfig(**PACKED_SERVE)
    prompts = _engine_prompts(cfg.vocab, seed=3)
    counters = (w2_k.launches, pa_k.launches, pp_k.launches)
    for c in counters:
        c.reset()
    step_ms = []
    t_run = time.perf_counter()
    want, eng = _serve_all(cfg, model, scfg, prompts, step_ms, tokens=PACKED_TOKENS)
    wall = time.perf_counter() - t_run
    launches = {c.name: c.count for c in counters}
    st = eng.stats()
    steps = st.steps_committed
    if eng.attn_impl != "fused":
        fail(f"{name}: the engine resolved attn_impl={eng.attn_impl!r} on the card")
    paged = launches["paged_attention_decode"] + launches["paged_prefill_chunk"]
    per_step = per_layer * cfg.n_layers
    if (launches["w2a8_gemv"] != per_step * steps or paged != cfg.n_layers * steps
            or not launches["paged_attention_decode"]
            or not launches["paged_prefill_chunk"]):
        fail(f"{name}: launches {launches} over {steps} steps; want w2a8_gemv "
             f"{per_step} a step and the paged kernels {cfg.n_layers} a step, each "
             "launched")
    for layer in eng._cache:
        for t in layer["attn"].values():
            if not bool(torch.isfinite(t).all()):
                fail(f"{name}: a KV pool holds non-finite values")
    kv_bytes = eng.kv_cache_bytes()
    peak = torch.cuda.max_memory_allocated(dev)
    del eng
    toks = PACKED_TOKENS * len(prompts)
    ordered = sorted(step_ms)
    pct = {q: ordered[min(len(ordered) - 1, int(q / 100 * len(ordered)))]
           for q in (50, 90, 99)}
    summary = dict(model=cfg.name, layers=cfg.n_layers, requests=len(prompts),
                   tokens=toks, wall_s=wall, tok_per_s=toks / wall, steps=steps,
                   step_ms_p50=pct[50], step_ms_p90=pct[90], step_ms_p99=pct[99],
                   ttft_ms=st.ttft_ms, prefill_chunks=st.prefill_chunks,
                   kv_bytes=kv_bytes, peak_bytes=peak, launches=launches,
                   launches_per_step={k: v / steps for k, v in launches.items()})
    print(f"    served {len(prompts)} requests x {PACKED_TOKENS} tokens in {wall:.2f} s: "
          f"{toks / wall:.1f} tok/s; {steps} steps, step ms p50 {pct[50]:.2f} p90 "
          f"{pct[90]:.2f} p99 {pct[99]:.2f}; KV pools {kv_bytes / 2**30:.2f} GiB; "
          f"peak {peak / 1e9:.2f} GB; launches {launches} "
          f"({launches['w2a8_gemv'] // steps} w2a8 and {paged // steps} paged a step)",
          flush=True)
    summary["profile"] = profile_steps(dev, cfg, model, scfg, prompts, out_dir,
                                       name=f"profile_{tag}.txt")
    plain_cfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=False))
    plain = build_model(plain_cfg, device=dev)
    plain.load_state_dict(model.state_dict())
    del model
    got, eng = _serve_all(plain_cfg, plain, ServeConfig(**dict(PACKED_SERVE,
                                                                attn_impl="gather")),
                          prompts, tokens=PACKED_TOKENS)
    del eng
    agree = [_common_prefix(a, b) for a, b in zip(want, got)]
    summary["plain_route"] = dict(tokens_before_first_difference=agree,
                                  identical_requests=sum(a == b for a, b in zip(want, got)))
    print(f"    plain route (gather, use_kernel=False): {sum(agree)} of {toks} tokens "
          f"alike before each request's first difference, "
          f"{summary['plain_route']['identical_requests']} of {len(prompts)} "
          f"requests identical" + ("" if gate_plain else " (not a gate)"), flush=True)
    if gate_plain and want != got:
        # where the routes part, the plain route's top two logits must tie
        # in bf16 (a gap of at most one bf16 ulp of the top logit): the
        # kernels' other summation order then decides the pick
        diffs = []
        for r, j in enumerate(agree):
            if j < PACKED_TOKENS:
                top, gaps = _top2(plain, prompts[r], got[r], dev)
                diffs.append((r, j, gaps[j], _bf16_ulp(top[j])))
        summary["plain_route"]["first_differences"] = diffs
        print(f"    (request, first differing token, the plain route's top-2 logit "
              f"gap there, one bf16 ulp of its top logit): {diffs}", flush=True)
        if any(gap > ulp for _, _, gap, ulp in diffs):
            fail(f"{name}: greedy tokens differ between the kernel and plain "
                 f"routes away from a bf16 tie: {diffs}")
    del plain
    torch.cuda.empty_cache()
    return launches, summary


class _LayerTap:
    """Taps each block of ``model``: records the block's input and its
    attention's context (the input of ``Attention._out``, before the output
    projection quantizes it) in call order; with ``feed`` set, block ``i``
    is given ``feed[i]`` instead of its own input.  The blocks' ``decode``
    and ``decode_chunk`` and the attentions' ``_out`` are wrapped as
    instance attributes, which ``close`` removes."""

    def __init__(self, model):
        self.blocks, self.inputs, self.ctx, self.feed = model.stack.layers, [], [], None
        for i, blk in enumerate(self.blocks):
            for name in ("decode", "decode_chunk"):
                setattr(blk, name, self._block(i, getattr(blk, name)))
            blk.attn._out = self._out(blk.attn._out)

    def _block(self, i, inner):
        def run(x, *a, **kw):
            x = x if self.feed is None else self.feed[i]
            self.inputs.append(x)
            return inner(x, *a, **kw)
        return run

    def _out(self, inner):
        def run(ctx):
            self.ctx.append(ctx)
            return inner(ctx)
        return run

    def reset(self, feed=None):
        self.inputs, self.ctx, self.feed = [], [], feed

    def close(self):
        for blk in self.blocks:
            del blk.decode, blk.decode_chunk, blk.attn._out


def gemma_kernel_vs_plain(dev):
    """12b: gemma-7b's widths at depth 2, fp32 compute and pools, the kernel
    route (w2a8; the paged kernels at head_dim 256, fp32 instances) against
    the plain route (``use_kernel=False``, ``"gather"``) from the same
    weights, teacher-forced: four token streams through
    ``CausalLM.decode_chunk`` (chunks of 32, the rows whose prompt is done
    as decode rows) and then ``decode_step``.  The gate: with each block of
    the kernel route given the plain route's input to that block, every
    layer's attention context (the paged kernels' output) is within the
    fp32 tolerance of phase 2 (2e-5 + 2e-5·|x|) over the valid rows, and the
    pools stay bitwise equal outside the trash block (w2a8 is exact).
    Beside it, the kernel route run free: its logits against the plain
    route's, and the int8 codes of the output projection's input that the
    two contexts round differently, printed (a context that differs in its
    last bits flips a code at a .5 boundary, which moves the logits by far
    more than 1e-4 of their range: ROADMAP Queue C).  Then the engine's
    greedy tokens free-running, which should be identical; at a mismatch
    the plain path's top-2 logit gap there is printed, and the phase fails
    only where it is above 1e-3.  Returns the summary."""
    import numpy as np
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import ServeConfig

    base = get_config("gemma-7b").replace(n_layers=2, compute_dtype="float32")
    kcfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=True))
    pcfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=False))
    kmodel = build_model(kcfg, gen=torch.Generator(device=dev).manual_seed(2),
                         device=dev)
    pmodel = build_model(pcfg, device=dev)
    pmodel.load_state_dict(kmodel.state_dict())
    rng = np.random.default_rng(12)
    b, bs, t, n_dec = 4, 16, 32, 4
    plens = [70, 33, 128, 5]
    streams = [rng.integers(0, base.vocab, n + t).tolist() for n in plens]
    n_log = -(-max(len(s) for s in streams) // bs)
    bt = torch.arange(1, 1 + b * n_log, dtype=torch.int32,
                      device=dev).reshape(b, n_log)
    caches = {r: m.init_cache(1 + b * n_log, bs, torch.float32, dev)
              for r, m in (("plain", pmodel), ("free", kmodel), ("fed", kmodel))}
    ptap, ktap = _LayerTap(pmodel), _LayerTap(kmodel)
    pos = [0] * b
    stats = dict(calls=0, ctx_err=0.0, logit_rel_err=0.0, codes=0, codes_flipped=0)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)

    def step(run, valid):
        """One teacher-forced call on the three caches: ``run(model, cache,
        impl)`` -> logits."""
        stats["calls"] += 1
        ptap.reset()
        lp = run(pmodel, caches["plain"], "gather")
        ktap.reset()
        lk = run(kmodel, caches["free"], "fused")
        ref = lp.float()[valid]
        rel = (lk.float()[valid] - ref).abs().max().item() / ref.abs().max().item()
        stats["logit_rel_err"] = max(stats["logit_rel_err"], rel)
        ktap.reset(feed=list(ptap.inputs))
        run(kmodel, caches["fed"], "fused")
        for layer, (ck, cp) in enumerate(zip(ktap.ctx, ptap.ctx)):
            ck, cp = ck[valid].float(), cp[valid].float()
            err = (ck - cp).abs()
            if not bool((err <= 2e-5 + 2e-5 * cp.abs()).all()):
                fail(f"12b: call {stats['calls']} layer {layer}: the paged "
                     f"kernel's context differs from the plain route's by "
                     f"{err.max().item():.3g} (fp32 tolerance 2e-5 + 2e-5|x|)")
            stats["ctx_err"] = max(stats["ctx_err"], err.max().item())
            # the codes the output projection takes: SubLN's output (a
            # quantized stack has SubLN before W_out), rounded to int8
            subln = kmodel.stack.layers[layer].attn.subln or (lambda v: v)
            qk = Q.act_quant_absmax_int8(subln(ck.flatten(1)))[0]
            qp = Q.act_quant_absmax_int8(subln(cp.flatten(1)))[0]
            stats["codes"] += qp.numel()
            stats["codes_flipped"] += int((qk != qp).sum().item())

    with torch.no_grad():
        while any(p < n for p, n in zip(pos, plens)):
            lens = [min(t, n - p) if p < n else 1 for p, n in zip(pos, plens)]
            tok = torch.tensor([s[p:p + t] + [0] * (t - len(s[p:p + t]))
                                for s, p in zip(streams, pos)], device=dev)
            start, ln = i32(pos), i32(lens)
            step(lambda m, c, impl: m.decode_chunk(tok, c, start, ln, bt,
                                                   attn_impl=impl)[0],
                 torch.arange(t, device=dev)[None] < ln[:, None])
            pos = [p + n for p, n in zip(pos, lens)]
        for _ in range(n_dec):
            tok = torch.tensor([s[p] for s, p in zip(streams, pos)], device=dev)
            idx = i32(pos)
            step(lambda m, c, impl: m.decode_step(tok, c, idx, bt,
                                                  attn_impl=impl)[0],
                 slice(None))
            pos = [p + 1 for p in pos]
    ptap.close()
    ktap.close()
    for layer, (cf, cp) in enumerate(zip(caches["fed"], caches["plain"])):
        for k in ("k", "v"):
            if not torch.equal(cf["attn"][k][1:], cp["attn"][k][1:]):
                fail(f"12b: layer {layer} pool {k} of the kernel route fed the "
                     "plain inputs differs from the plain route's")
    del caches
    print(f"    teacher-forced, {stats['calls']} calls (decode_chunk then "
          f"decode_step): each layer's attention context within "
          f"{stats['ctx_err']:.3g} of the plain route's given the same block "
          f"input, pools bitwise; the two contexts round "
          f"{stats['codes_flipped']} of {stats['codes']} int8 codes of the "
          f"output projection's input differently, and the free kernel "
          f"route's logits are within {stats['logit_rel_err']:.3g} of "
          f"max|logit| (printed, not gated)", flush=True)

    prompts = _engine_prompts(base.vocab, seed=5)[:5]
    outs = {}
    for tag, cfg, model, impl in (("kernel", kcfg, kmodel, "fused"),
                                  ("plain", pcfg, pmodel, "gather")):
        outs[tag], _ = _serve_all(cfg, model, ServeConfig(
            max_batch=4, max_len=1024, prefill_chunk=32, attn_impl=impl,
            cache_dtype="float32"), prompts)
    diffs = []
    for r, (a, p) in enumerate(zip(outs["kernel"], outs["plain"])):
        if a != p:
            j = _common_prefix(a, p)
            gap = _top2_gaps(pmodel, prompts[r], p, dev)[j]
            diffs.append(dict(request=r, token=j, top2_gap=gap))
    del kmodel, pmodel
    torch.cuda.empty_cache()
    wide = [d for d in diffs if d["top2_gap"] > 1e-3]
    print(f"    free-running greedy: {len(prompts) - len(diffs)} of {len(prompts)} "
          f"requests identical x 16 tokens; first differences (request, token, "
          f"plain top-2 gap): {[tuple(d.values()) for d in diffs]}", flush=True)
    if wide:
        fail(f"12b: greedy tokens differ where the plain path's top-2 gap is "
             f"above 1e-3: {wide}")
    return dict(stats, greedy_differences=diffs)


def gemma_launcher(out_dir):
    """12c: ``python -m repro_torch.launch.serve --arch gemma-7b --packed``."""
    return serve_launcher(out_dir, GEMMA_CLI, "gemma")


def serve_launcher(out_dir, cli_args, tag):
    """``python -m repro_torch.launch.serve <cli_args>`` (the QAT model built
    whole on the card, then packed) must exit 0 with both paged kernels and
    w2a8 launched.  Returns its launches and peak line."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *cli_args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=600)
    (out_dir / f"serve_cli_{tag}.txt").write_text(out.stdout)
    lines = out.stdout.splitlines()
    kl = [ln for ln in lines if ln.startswith("[kernels] launches")]
    mem = [ln for ln in lines if ln.startswith("[memory]")]
    if out.returncode != 0 or not kl:
        fail(f"the serve launcher {cli_args} exited {out.returncode}: "
             f"{out.stdout[-2000:]}")
    cli = {k: int(v) for k, v in (kv.split("=") for kv in kl[0].split()[2:])}
    if not (cli["paged_attention_decode"] and cli["paged_prefill_chunk"]
            and cli["w2a8_gemv"]):
        fail(f"the serve launcher {cli_args}: launches {cli}")
    print(f"    exit 0 in {time.perf_counter() - t0:.1f} s; {kl[0]}; "
          f"{mem[0] if mem else '(no [memory] line)'}", flush=True)
    return cli, (mem[0] if mem else None)


def attention_variants_full_width(dev):
    """12d: one ``Attention`` at qwen3-0.6b's widths (d_model 1024, 16 heads,
    8 kv heads of 128, qk_norm, RoPE 1e6) over S = 4096, fp32: the blocked
    forward at block_kv 1024 and 1000 (a ragged last block of 96) against
    the dense one, outputs within 2e-3 and input gradients (of sum y²)
    within 5e-3, and bf16 scores against fp32 within 5e-2: JAX's bounds for
    these variants (tests/test_attention_variants.py).  The forward's peak
    memory above its input is printed for each, not gated."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.nn.attention import Attention
    from repro_torch.nn.module import DTypePolicy
    c = get_config("qwen3-0.6b")
    pol = DTypePolicy(torch.float32, torch.float32)
    x = torch.randn((1, 4096, c.d_model), generator=torch.Generator(
        device=dev).manual_seed(13), device=dev)

    def run(**kw):
        mod = Attention(c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                        qk_norm=c.qk_norm, rope_theta=c.rope_theta, policy=pol,
                        gen=torch.Generator(device=dev).manual_seed(12),
                        device=dev, **kw)
        gc.collect()                  # the last run's graph, freed before the count
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        with torch.no_grad():
            y = mod(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - held
        xg = x.clone().requires_grad_(True)
        (mod(xg) ** 2).sum().backward()
        return y, xg.grad, peak

    y0, g0, p0 = run()
    out = dict(dense_peak_bytes=p0)
    for blk in (1024, 1000):
        y, g, p = run(impl="blocked", block_kv=blk)
        ey, eg = (y - y0).abs().max().item(), (g - g0).abs().max().item()
        if not (torch.allclose(y, y0, rtol=2e-3, atol=2e-3)
                and torch.allclose(g, g0, rtol=5e-3, atol=5e-3)):
            fail(f"12d: blocked (block_kv {blk}) vs dense: output err {ey:.3g}, "
                 f"input-gradient err {eg:.3g} (max |grad| {g0.abs().max().item():.3g})")
        out[f"blocked_{blk}"] = dict(out_err=ey, grad_err=eg, peak_bytes=p)
        print(f"    blocked, block_kv {blk}: output within {ey:.3g}, input "
              f"gradient within {eg:.3g} of dense; forward peak {p / 2**20:.0f} "
              f"MiB (dense {p0 / 2**20:.0f} MiB)", flush=True)
    y, _, p = run(scores_dtype="bfloat16")
    e = (y - y0).abs().max().item()
    if not torch.allclose(y, y0, rtol=5e-2, atol=5e-2):
        fail(f"12d: bf16 scores vs fp32: output err {e:.3g}")
    out["bf16_scores"] = dict(out_err=e, peak_bytes=p)
    print(f"    bf16 scores: output within {e:.3g} of fp32 scores (bound 5e-2); "
          f"forward peak {p / 2**20:.0f} MiB", flush=True)
    return out


# -- phase 13: the MoE and hybrid families -----------------------------------------

GRANITE, JAMBA = "granite-moe-1b-a400m", "jamba-1.5-large-398b"
GRANITE_CLI = ["--arch", GRANITE, "--packed", "--requests", "8",
               "--max-tokens", "16", "--prompt-len", "16"]
# the whole jamba block's kernel route against its plain route, in bf16: the
# plain route rounds its dequantized operands to bf16 where the kernels sum
# int8 products exactly, so the two agree to bf16's scale, not to phase 8's
# 1e-4 (which the block's SSD is held to, fed the same operands)
BLOCK_BF16_OUT, BLOCK_BF16_GRAD = 2.0 ** -4, 2.0 ** -3
# 13d's QAT step, kernel vs plain route: grad_norm and loss_moe move with
# the int8 codes and expert picks the routes' fp32 differences round either
# way (first set at phase 6's 1e-3 for grad_norm; the first card run read
# 1.1e-3 with codes and picks flipped); the kernels themselves are held on
# their own operands
STEP_FLIP_RTOL = 1e-2


class _Route:
    """The kernel or the plain route of a QAT forward and backward inside a
    ``with``: on the kernel route every bitlinear launch's operands and
    output (``kernels/bitlinear/ops.py::_fwd_2d``) and every SSD call's
    operands (``nn/ssm.py``'s ``ssd_scan``) are recorded for ``check``; on
    the plain route the SSD runs the plain version (``ssd_chunked``, what a
    CPU tensor runs) instead of the kernel."""

    def __init__(self, kernel: bool):
        self.kernel, self.bitlinear, self.ssd = kernel, [], []

    def __enter__(self):
        import repro_torch.nn.ssm as ssm_mod
        from repro_torch.kernels.bitlinear import ops as bl_ops
        from repro_torch.kernels.ssd_scan.ref import ssd_chunked
        self._ssd, self._fwd = ssm_mod.ssd_scan, bl_ops._fwd_2d
        ssd_inner, fwd_inner = self._ssd, self._fwd

        def ssd_tap(x, a, dt, B, C, chunk):
            self.ssd.append(([t.detach() for t in (x, a, dt, B, C)], chunk))
            return ssd_inner(x, a, dt, B, C, chunk)

        def fwd_tap(x2d, wt, scheme, shard=None, delta=None):
            out = fwd_inner(x2d, wt, scheme, shard, delta)
            # a copy of the weight: an fp32 master weight reaches the kernel
            # as the parameter itself, which the optimizer then updates
            self.bitlinear.append((x2d.detach(), wt.detach().clone(),
                                   out[0].detach()))
            return out

        if self.kernel:
            ssm_mod.ssd_scan, bl_ops._fwd_2d = ssd_tap, fwd_tap
        else:
            ssm_mod.ssd_scan = lambda x, a, dt, B, C, chunk: ssd_chunked(
                x, a, dt, B, C, chunk=chunk)[0]
        return self

    def __exit__(self, *exc):
        import repro_torch.nn.ssm as ssm_mod
        from repro_torch.kernels.bitlinear import ops as bl_ops
        ssm_mod.ssd_scan, bl_ops._fwd_2d = self._ssd, self._fwd

    def check(self, what):
        """Each recorded bitlinear launch equals, bit for bit, its plain
        version on its operands (int8 codes and absmean Δ as the CPU route
        computes them, ``bitlinear_ref``); each recorded SSD call's operands
        through the kernel are within phase 8's tolerances of
        ``ssd_chunked``: y and the final state rtol 1e-4 atol 1e-4, the
        five gradients under a random upstream gradient 1e-3 of their
        largest entries.  Returns (the bitlinear shapes, the SSD's largest
        errors: y and state absolute, gradients over the largest entry)."""
        import torch
        from repro_torch.core import quant as Q
        from repro_torch.kernels.bitlinear.ref import bitlinear_ref
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
        from repro_torch.kernels.ssd_scan.ref import ssd_chunked
        shapes = []
        for x2d, wt, y in self.bitlinear:
            xq, gamma = Q.act_quant_absmax_int8(x2d)
            qw, delta = Q.weight_quant_absmean(wt)
            if not torch.equal(y, bitlinear_ref(x2d, qw.to(torch.int8), gamma, delta)):
                fail(f"{what}: the bitlinear launch at K={wt.shape[0]} "
                     f"N={wt.shape[1]} differs from its plain version")
            shapes.append(tuple(wt.shape))
        self.bitlinear = []
        worst = {}
        for ins, chunk in self.ssd:
            ins = [t.contiguous() for t in ins]
            yk, hk = ssd_scan_kernel(*ins, chunk)
            yc, hc = ssd_chunked(*ins, chunk=chunk)
            b, s, h, p = ins[0].shape
            n = ins[3].shape[-1]
            hc = hc.transpose(-1, -2).reshape(b * h, n, p)
            errs = {}
            for name, got, want in (("y", yk, yc), ("state", hk, hc)):
                e = (got - want).abs()
                if not (bool(torch.isfinite(got).all())
                        and bool((e <= 1e-4 + 1e-4 * want.abs()).all())):
                    fail(f"{what}: SSD ({n}, {p}) {name} vs ssd_chunked on the "
                         f"step's operands: max err {e.max().item()}")
                errs[name] = e.max().item()
            g = torch.randn_like(yk)
            ins1 = [t.clone().requires_grad_() for t in ins]
            (ssd_ops.ssd_scan(*ins1, chunk=chunk) * g).sum().backward()
            ins2 = [t.clone().requires_grad_() for t in ins]
            (ssd_chunked(*ins2, chunk=chunk)[0] * g).sum().backward()
            for name, t1, t2 in zip("x a dt B C".split(), ins1, ins2):
                e = (t1.grad - t2.grad).abs()
                scale = t2.grad.abs().max().item()
                if not (bool(torch.isfinite(t1.grad).all())
                        and bool((e <= 1e-3 * scale + 1e-3 * t2.grad.abs()).all())):
                    fail(f"{what}: SSD ({n}, {p}) gradient of {name}: max err "
                         f"{e.max().item()} (largest entry {scale})")
                errs[f"d{name}"] = e.max().item() / max(scale, 1e-30)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
        self.ssd = []
        return shapes, worst


def jamba_block_parity(dev):
    """13c: one ``LayerSpec("mamba", "dense")`` block of jamba-1.5-large-398b
    at full width (d_model 8192, 128 SSD heads of 128, state 128, chunk
    256, d_ff 24576; SubLN; bf16 parameters and compute, its config's) as a
    QAT student, batch 2 x 512, forward and backward on the kernel route
    (bitlinear for its five projections, ssd_scan at (N, P) = (128, 128))
    and on the plain route (``use_kernel=False``, the SSD through
    ``ssd_chunked``) from the same weights and input.  Gates: the kernel
    route launches bitlinear 5 times and ssd_scan once; each launch holds
    to its plain version on the operands the block gave it
    (``_Route.check``: bitlinear bitwise, the SSD at phase 8's
    tolerances); and the whole block's two routes within bf16's scale
    (``BLOCK_BF16_*`` of the largest entry, output and every parameter's
    gradient), all finite.  Prints the peak memory.  Returns the kernel
    route's launches and the numbers."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.bitlinear import kernel as bl_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    from repro_torch.models import get_config
    from repro_torch.nn.transformer import Block, LayerSpec

    spec = LayerSpec("mamba", "dense")
    base = get_config(JAMBA).replace(compute_dtype="bfloat16")
    if spec not in base.resolved_pattern():
        fail(f"{JAMBA} has no {spec} layer")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    u = torch.randn((2, MAMBA_SEQ, base.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = torch.randn((2, MAMBA_SEQ, base.d_model), generator=gen, device=dev)
    out, grads, state = {}, {}, None
    counters = (bl_k.launches, ssd_k.launches)
    for tag, use_kernel in (("kernels", True), ("plain", False)):
        cfg = base.with_quant(Q.QuantConfig(mode="qat", use_kernel=use_kernel))
        blk = Block(cfg.block_config(), spec, device=dev,
                    gen=torch.Generator(device=dev).manual_seed(2) if state is None
                    else None)
        if state is None:
            state = blk.state_dict()
        else:
            blk.load_state_dict(state)
        for c in counters:
            c.reset()
        with _Route(use_kernel) as route:
            y, _, _ = blk(u)
            (y.float() * w).sum().backward()
        torch.cuda.synchronize()
        if use_kernel:
            launches = {c.name: c.count for c in counters}
            kernel_route = route
        out[tag] = y.detach().float()
        grads[tag] = {k: p.grad.detach().float() for k, p in blk.named_parameters()}
        del blk, y
    n_params = sum(t.numel() for t in state.values())
    del state
    if launches != {"bitlinear": 5, "ssd_scan": 1}:
        fail(f"jamba block, kernel route: launches {launches}; want bitlinear 5 "
             "(in_proj, out_proj, up, gate, down) and ssd_scan 1")
    shapes, ssd_err = kernel_route.check("jamba block")
    rel_out = ((out["kernels"] - out["plain"]).abs().max()
               / out["plain"].abs().max()).item()
    rel_grad = {}
    for k, gp in grads["plain"].items():
        gk = grads["kernels"][k]
        if not bool(torch.isfinite(gk).all()):
            fail(f"jamba block, kernel route: gradient of {k} is not finite")
        rel_grad[k] = ((gk - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  jamba (mamba, dense) block, {n_params / 1e9:.3f} B parameters, bf16 "
          f"QAT, 2 x {MAMBA_SEQ}: launches {launches}; bitlinear bitwise at "
          f"{shapes}; SSD (128, 128) vs ssd_chunked on the block's operands: "
          + ", ".join(f"{k} {v:.3g}" for k, v in ssd_err.items())
          + f"; kernel vs plain route: output max err / max|y| {rel_out:.3g}, "
          "gradients max err / largest entry: "
          + ", ".join(f"{k} {v:.2g}" for k, v in rel_grad.items())
          + f"; peak memory {peak / 1e9:.2f} GB", flush=True)
    bad = {k: v for k, v in rel_grad.items() if not v <= BLOCK_BF16_GRAD}
    if not (math.isfinite(rel_out) and rel_out <= BLOCK_BF16_OUT) or bad:
        fail(f"jamba block: kernel vs plain route beyond bf16's scale: output "
             f"{rel_out} (limit {BLOCK_BF16_OUT}), gradients {bad} (limit "
             f"{BLOCK_BF16_GRAD})")
    del out, grads, kernel_route
    torch.cuda.empty_cache()
    return launches, dict(params=n_params, bitlinear_shapes=shapes, ssd=ssd_err,
                          output_rel_err=rel_out, grad_rel_err=rel_grad,
                          peak_bytes=peak)


def jamba_reduced(dev):
    """13d: jamba-1.5-large-398b reduced to one repeat of its eight-layer
    pattern (attention + dense, then seven mamba layers alternating MoE and
    dense; the reduced widths, fp32) on the card.  (a) Served packed on the
    contiguous cache (attention K/V beside the mamba state), 4 prompts of
    9..40 tokens x 12 greedy tokens, on the kernel route (w2a8 counted at
    30 launches a decode pass: 4 + 3 for the attention + dense layer, 2 for
    each mamba mixer, 3 for each dense FFN) and on the plain route: the
    tokens must be identical.  (b) One QAT CE step on the kernel route
    (bitlinear 30 launches, ssd_scan 7) and on the plain route (the SSD
    through ``ssd_chunked``) from the same weights and batch.  Each launch
    holds to its plain version on the operands the step gave it
    (``_Route.check``), the step's loss to phase 6's rtol 1e-4, its
    grad_norm and loss_moe to ``STEP_FLIP_RTOL``: the two routes' fp32
    differences round int8 activation codes and the capacity-limited
    expert picks either way (both counts printed), and a flipped pick moves
    a token's FFN output as a whole.  Returns the launches of (a) and (b)
    and the numbers."""
    import numpy as np
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.bitlinear import kernel as bl_k
    from repro_torch.kernels.paged_attention import kernel as pa_k
    from repro_torch.kernels.paged_prefill import kernel as pp_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    from repro_torch.kernels.w2a8_gemv import kernel as w2_k
    from repro_torch.models import build_model, get_config
    from repro_torch.nn import moe as moe_mod
    from repro_torch.serving import ServeConfig
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import constant
    from repro_torch.training.trainer import init_train_state, make_train_step

    base = get_config(JAMBA).reduced(layers=8)
    per_pass = 30
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, base.vocab, int(k)).tolist() for k in (9, 40, 17, 23)]
    scfg = ServeConfig(max_batch=4, max_len=64, prefill_chunk=8)
    toks, state = {}, None
    for tag, use_kernel in (("kernels", True), ("plain", False)):
        cfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=use_kernel))
        model = build_model(cfg, device=dev, gen=None if state else
                            torch.Generator(device=dev).manual_seed(0))
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        if use_kernel:
            counters = (w2_k.launches, pa_k.launches, pp_k.launches)
            passes = _PassCounter(model)
            for c in counters:
                c.reset()
        toks[tag], eng = _serve_all(cfg, model, scfg, prompts, tokens=12)
        if use_kernel:
            serve_launches = {c.name: c.count for c in counters}
            n_pass = passes.n
            passes.close()
            if eng.paged or eng._ring is None:
                fail(f"jamba reduced resolved to paged={eng.paged}, ring {eng._ring}")
        del eng, model
    if serve_launches["w2a8_gemv"] != per_pass * n_pass or \
            serve_launches["paged_attention_decode"] or \
            serve_launches["paged_prefill_chunk"]:
        fail(f"jamba reduced serving: launches {serve_launches} over {n_pass} "
             f"decode passes; want w2a8 {per_pass} a pass and no paged kernel")
    if toks["kernels"] != toks["plain"]:
        fail(f"jamba reduced: greedy tokens differ between the routes: "
             f"{toks['kernels']} vs {toks['plain']}")
    print(f"  (a) served {len(prompts)} requests x 12 tokens on the contiguous "
          f"cache: {n_pass} decode passes, launches {serve_launches}; plain route's "
          "tokens identical", flush=True)

    batch = _train_batches("corpus", 17, 1, dev, base.max_seq)[0]
    metrics, codes, picks, state = {}, {}, {}, None
    route_fn = moe_mod.route
    for tag, use_kernel in (("kernels", True), ("plain", False)):
        cfg = base.with_quant(Q.QuantConfig(mode="qat", use_kernel=use_kernel))
        model = build_model(cfg, device=dev, gen=None if state else
                            torch.Generator(device=dev).manual_seed(1))
        if state is None:   # a copy: the step updates the parameters in place
            state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        opt = AdamW(AdamWConfig(weight_decay=0.01))
        step = make_train_step(model, opt, lambda s: constant(s, 1e-4))
        picks[tag] = []

        def record(logits, k, cap):
            out = route_fn(logits, k, cap)
            picks[tag].append(out[2].detach())
            return out

        for c in (bl_k.launches, ssd_k.launches):
            c.reset()
        moe_mod.route = record
        try:
            with _Route(use_kernel) as route:
                _, m = step(init_train_state(model, opt), batch)
                torch.cuda.synchronize()
        finally:
            moe_mod.route = route_fn
        if use_kernel:
            train_launches = {c.name: c.count for c in (bl_k.launches, ssd_k.launches)}
            kernel_route = route
        metrics[tag] = {k: float(v) for k, v in m.items()}
        model.load_state_dict(state)
        with _Route(use_kernel):
            codes[tag] = _activation_codes(model, batch)
        del model, opt, step
    if train_launches != {"bitlinear": per_pass, "ssd_scan": 7}:
        fail(f"jamba reduced QAT step: launches {train_launches}; want bitlinear "
             f"{per_pass} and ssd_scan 7")
    shapes, ssd_err = kernel_route.check("jamba reduced QAT step")
    n_codes = sum(c.numel() for c in codes["kernels"])
    d_codes = sum(int((x != y).sum()) for x, y in zip(codes["kernels"], codes["plain"]))
    n_picks = sum(t.numel() for t in picks["kernels"])
    d_picks = sum(int((x != y).sum()) for x, y in zip(picks["kernels"], picks["plain"]))
    a, b = metrics["kernels"], metrics["plain"]
    rel = {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "loss_moe", "grad_norm")}
    print("  (b) QAT CE step, kernels / plain (relative difference): " + ", ".join(
        f"{k} {a[k]:.7g} / {b[k]:.7g} ({rel[k]:.2g})" for k in rel)
        + f"; launches {train_launches}, each held to its plain version on its "
        f"operands ({len(shapes)} bitlinear bitwise; SSD "
        + ", ".join(f"{k} {v:.3g}" for k, v in ssd_err.items())
        + f"); int8 activation codes differing {d_codes} of {n_codes}, expert "
        f"picks differing {d_picks} of {n_picks}", flush=True)
    for k, rtol in (("loss", 1e-4), ("loss_moe", STEP_FLIP_RTOL),
                    ("grad_norm", STEP_FLIP_RTOL)):
        if not (math.isfinite(a[k]) and rel[k] <= rtol):
            fail(f"jamba reduced QAT step {k}: kernels {a[k]!r} vs plain "
                 f"{b[k]!r} (rtol {rtol})")
    torch.cuda.empty_cache()
    return (serve_launches, train_launches), dict(
        passes=n_pass, serve_launches=serve_launches, train=metrics,
        train_launches=train_launches, ssd=ssd_err, codes_differing=d_codes / n_codes,
        picks_differing=d_picks / n_picks)


# -- phase 14: the cross-attention families -----------------------------------------

WHISPER, VISION = "whisper-medium", "llama-3.2-vision-11b"
# 14a and 14d: the engine's config, 8 prompts of 8..32 tokens x 16 greedy
# tokens (a decode pass per prompt and greedy token on the contiguous cache:
# the lengths set the plain route's time, ~1 s a pass for llama-vision)
CROSS_SERVE = dict(max_batch=8, max_len=128, prefill_chunk=16, cache_dtype="bfloat16")
CROSS_TOKENS = 16
# 14b and 14d at the model level: rows of audio or image memory, and the
# prompt tokens teacher-forced before as many greedy ones
MEMORY_ROWS, FORCED = 4, 8
# 14c: the distillation steps' batch and decoder length
CROSS_TRAIN_BATCH, CROSS_TRAIN_SEQ = 4, 256


def _cross_prompts(vocab: int, seed: int = 14):
    """Eight prompts of 8..32 tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)).tolist() for n in rng.integers(8, 33, 8)]


def _w2a8_per_pass(cfg) -> int:
    """w2a8 launches of one decode pass, from the config: a self-attention
    projects q, k, v and o; a cross layer q and o alone (its K/V are the
    static cache); a dense FFN gate, up and down (up and down ungated)."""
    from repro_torch.models.encdec import decoder_config
    dec = decoder_config(cfg) if cfg.n_encoder_layers else cfg
    ffn = 3 if cfg.mlp_gated else 2
    per = [(4 if s.mixer in ("attn", "attn_cross") else 0)
           + (2 if s.mixer in ("cross", "attn_cross") else 0) + ffn
           for s in dec.resolved_pattern()]
    return sum(per) * dec.repeats


def _decode_top2(model, prompt, tokens, dev):
    """(the top logit, the top-2 gap) at each greedy token of ``tokens``
    (the continuation of ``prompt``), from decode steps over a cache built
    without memory: what the engine runs (its prefill is a scan of decode
    steps on the contiguous cache)."""
    import torch
    seq = list(prompt) + list(tokens[:-1])
    cache = model.init_cache(1, len(seq), torch.bfloat16, dev)
    tops, gaps = [], []
    with torch.no_grad():
        for t, tok in enumerate(seq):
            logits, _ = model.decode_step(
                torch.tensor([tok], device=dev), cache,
                torch.tensor([t], dtype=torch.int32, device=dev))
            if t >= len(prompt) - 1:
                v = logits[0].float().topk(2).values
                tops.append(v[0].item())
                gaps.append((v[0] - v[1]).item())
    return tops, gaps


def _ties_only(what, want, got, gaps_at):
    """Where two routes' greedy tokens part, the plain route's top two
    logits there must tie in bf16 (a gap of at most one bf16 ulp of the top
    logit; phase 13a's rule).  ``gaps_at(r, j)`` gives the plain route's
    (top, gap) at row r's token j.  Returns the differences."""
    diffs = []
    for r, (a, b) in enumerate(zip(want, got)):
        j = _common_prefix(a, b)
        if j < min(len(a), len(b)):
            top, gap = gaps_at(r, j)
            diffs.append((r, j, gap, _bf16_ulp(top)))
    if any(gap > ulp for _, _, gap, ulp in diffs):
        fail(f"{what}: greedy tokens differ between the kernel and plain routes "
             f"away from a bf16 tie (row, token, gap, ulp): {diffs}")
    return diffs


def serve_cross(dev, out_dir, name, per_pass, tag):
    """14a / 14d: ``name`` at full width and depth, packed ternary weights
    from the port's seeded init, bf16, through the port's ``Engine``: 8
    prompts of 8..32 tokens x 16 greedy tokens at ``CROSS_SERVE``.  Gates:
    the engine picks the contiguous cache (the decoder's pattern has cross
    layers), w2a8 counts ``per_pass`` launches a decode pass (reckoned from
    the config by ``_w2a8_per_pass`` too) and the paged kernels none, every
    request gets its tokens, the self-attention caches stay finite; the
    plain route (``use_kernel=False``) gives the same tokens but where its
    top two logits tie in bf16.  Prints step percentiles, ms a decode pass,
    tok/s, the memory held and the idle share of a profile.  Returns the
    launches, the summary, and the two models (kernel and plain route)."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.paged_attention import kernel as pa_k
    from repro_torch.kernels.paged_prefill import kernel as pp_k
    from repro_torch.kernels.w2a8_gemv import kernel as w2_k
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import ServeConfig

    base = get_config(name).replace(compute_dtype="bfloat16")
    if _w2a8_per_pass(base) != per_pass:
        fail(f"{name}: the config gives {_w2a8_per_pass(base)} w2a8 launches a "
             f"pass, not {per_pass}")
    cfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=True))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    n_params = sum(t.numel() for t in model.state_dict().values())
    print(f"  init {cfg.name}: {cfg.n_layers} decoder layers"
          + (f" + {cfg.n_encoder_layers} encoder layers" if cfg.n_encoder_layers else "")
          + f", d_model {cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} kv) of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{time.perf_counter() - t0:.1f} s; {held / 1e9:.2f} GB held packed "
          f"({n_params / 1e9:.3f} B stored elements)", flush=True)
    scfg = ServeConfig(**CROSS_SERVE)
    prompts = _cross_prompts(cfg.vocab)
    counters = (w2_k.launches, pa_k.launches, pp_k.launches)
    passes = _PassCounter(model)
    for c in counters:
        c.reset()
    step_ms = []
    t_run = time.perf_counter()
    want, eng = _serve_all(cfg, model, scfg, prompts, step_ms, tokens=CROSS_TOKENS)
    wall = time.perf_counter() - t_run
    launches = {c.name: c.count for c in counters}
    n_pass = passes.n
    passes.close()
    st = eng.stats()
    if eng.paged or eng._ring is not None:
        fail(f"{name}: the engine resolved paged={eng.paged}, ring {eng._ring}")
    if launches["w2a8_gemv"] != per_pass * n_pass or \
            launches["paged_attention_decode"] or launches["paged_prefill_chunk"]:
        fail(f"{name}: launches {launches} over {n_pass} decode passes; want "
             f"w2a8 {per_pass} a pass and no paged kernel")
    for layer in eng._cache:
        for t in layer.get("attn", {}).values():
            if not bool(torch.isfinite(t).all()):
                fail(f"{name}: a self-attention cache holds non-finite values")
    kv_bytes = eng.kv_cache_bytes()
    del eng
    toks = CROSS_TOKENS * len(prompts)
    ordered = sorted(step_ms)
    pct = {q: ordered[min(len(ordered) - 1, int(q / 100 * len(ordered)))]
           for q in (50, 90, 99)}
    peak = torch.cuda.max_memory_allocated(dev)
    summary = dict(model=cfg.name, requests=len(prompts),
                   prompt_lens=[len(p) for p in prompts], tokens=toks, wall_s=wall,
                   tok_per_s=toks / wall, steps=len(step_ms), passes=n_pass,
                   ms_per_pass=wall * 1e3 / n_pass, step_ms_p50=pct[50],
                   step_ms_p90=pct[90], step_ms_p99=pct[99], ttft_ms=st.ttft_ms,
                   kv_bytes=kv_bytes, held_bytes=held, peak_bytes=peak,
                   launches=launches, w2a8_per_pass=launches["w2a8_gemv"] / n_pass)
    print(f"    served {len(prompts)} requests x {CROSS_TOKENS} tokens in {wall:.2f} s: "
          f"{toks / wall:.1f} tok/s; {len(step_ms)} steps, {n_pass} decode passes "
          f"({wall * 1e3 / n_pass:.2f} ms a pass); step ms p50 {pct[50]:.2f} p90 "
          f"{pct[90]:.2f} p99 {pct[99]:.2f}; contiguous KV {kv_bytes / 2**20:.1f} MiB; "
          f"peak {peak / 1e9:.2f} GB; launches {launches} "
          f"({launches['w2a8_gemv'] // n_pass} w2a8 a pass)", flush=True)
    # the profile serves the shortest prompt alone: the trace's events are
    # what the profiler costs to read, ~1 s for every ~2 decode passes here
    shortest = min(range(len(prompts)), key=lambda i: len(prompts[i]))
    summary["profile"] = profile_steps(dev, cfg, model, scfg, prompts, out_dir,
                                       picks=(shortest,), name=f"profile_{tag}.txt")
    plain_cfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=False))
    plain = build_model(plain_cfg, device=dev)
    plain.load_state_dict(model.state_dict())
    got, eng = _serve_all(plain_cfg, plain, scfg, prompts, tokens=CROSS_TOKENS)
    del eng
    diffs = _ties_only(f"{name} served", want, got, lambda r, j: tuple(
        v[j] for v in _decode_top2(plain, prompts[r], got[r], dev)))
    agree = [_common_prefix(a, b) for a, b in zip(want, got)]
    summary["plain_route"] = dict(tokens_before_first_difference=agree,
                                  first_differences=diffs)
    print(f"    plain route: {sum(agree)} of {toks} tokens alike before each "
          f"request's first difference; differences at bf16 ties (row, token, "
          f"gap, ulp): {diffs}", flush=True)
    return launches, summary, (cfg, model), (plain_cfg, plain)


def cross_memory(dev, kernel, plain, seed_launches):
    """14b / 14d at the model level: ``MEMORY_ROWS`` rows of seeded memory
    (whisper: audio frames [4, 1500, 1024] through ``encode``; llama-vision:
    image embeddings [4, 1601, 4096]) seed every cross cache through
    ``init_cache`` on the kernel route (w2a8 counted at ``seed_launches``,
    each at M = 4 x T rows) and on the plain route; then ``FORCED`` prompt
    tokens are teacher-forced and as many greedy tokens decoded, each route
    on its own caches.  Gates: the two routes' seeded cross caches are
    bitwise equal (the same w2a8 launch and plain version, the encoder's
    attention the same PyTorch ops), finite; the greedy tokens alike but
    where the plain route's top two logits tie in bf16.  Returns the
    launches and the numbers."""
    import torch
    from repro_torch.kernels.w2a8_gemv import kernel as w2_k
    from repro_torch.models import EncDecLM
    (cfg, model), (_, plain_model) = kernel, plain
    enc = isinstance(model, EncDecLM)
    t = cfg.encoder_seq if enc else cfg.num_image_tokens
    gen = torch.Generator(device=dev).manual_seed(15)
    mem = torch.randn((MEMORY_ROWS, t, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab, (MEMORY_ROWS, FORCED), generator=gen,
                           device=dev)
    key = "frames" if enc else "memory"
    n = 2 * FORCED
    out = {}
    for tag, m in (("kernels", model), ("plain", plain_model)):
        w2_k.launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            cache = m.init_cache(MEMORY_ROWS, n, torch.bfloat16, dev, **{key: mem})
        torch.cuda.synchronize()
        seed_ms = (time.perf_counter() - t0) * 1e3
        seeded = w2_k.launches.count
        xc = [layer["xattn"] for layer in cache if "xattn" in layer]
        tok, toks, tops, gaps = prompt[:, 0], [], [], []
        t0 = time.perf_counter()
        with torch.no_grad():
            for j in range(n - 1):
                logits, _ = m.decode_step(tok, cache, torch.full(
                    (MEMORY_ROWS,), j, dtype=torch.int32, device=dev))
                if j + 1 < FORCED:
                    tok = prompt[:, j + 1]
                    continue
                v = logits.float().topk(2, dim=-1).values
                tops.append(v[:, 0].tolist())
                gaps.append((v[:, 0] - v[:, 1]).tolist())
                tok = logits.argmax(-1)
                toks.append(tok.tolist())
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
        out[tag] = dict(caches=xc, tokens=[list(r) for r in zip(*toks)],
                        tops=[list(r) for r in zip(*tops)],
                        gaps=[list(r) for r in zip(*gaps)], seed_ms=seed_ms,
                        decode_ms=decode_ms, launches=seeded)
    k, p = out["kernels"], out["plain"]
    if k["launches"] != seed_launches:
        fail(f"{cfg.name}: seeding the cross caches launched w2a8 {k['launches']} "
             f"times; want {seed_launches}")
    nbytes = 0
    for i, (a, b) in enumerate(zip(k["caches"], p["caches"])):
        for part in ("k", "v"):
            if a[part].shape[2] != t or not bool(torch.isfinite(a[part]).all()):
                fail(f"{cfg.name}: cross cache {i} {part} has shape "
                     f"{tuple(a[part].shape)} or non-finite values")
            if not torch.equal(a[part], b[part]):
                err = (a[part].float() - b[part].float()).abs().max().item()
                fail(f"{cfg.name}: cross cache {i} {part} differs between the "
                     f"kernel and plain routes (max err {err}; must be bitwise)")
            nbytes += a[part].numel() * a[part].element_size()
    diffs = _ties_only(f"{cfg.name} with memory", k["tokens"], p["tokens"],
                       lambda r, j: (p["tops"][r][j], p["gaps"][r][j]))
    agree = [_common_prefix(a, b) for a, b in zip(k["tokens"], p["tokens"])]
    print(f"    memory {tuple(mem.shape)} bf16 -> {len(k['caches'])} cross caches "
          f"({nbytes / 1e9:.3f} GB), bitwise equal on both routes; w2a8 "
          f"{k['launches']} launches at M = {MEMORY_ROWS * t} rows; seeding "
          f"{k['seed_ms']:.1f} ms (plain {p['seed_ms']:.1f}); {FORCED} tokens "
          f"forced + {FORCED} greedy, {k['decode_ms']:.2f} ms a step (plain "
          f"{p['decode_ms']:.2f}); {sum(agree)} of {MEMORY_ROWS * FORCED} greedy "
          f"tokens alike before each row's first difference; differences at bf16 "
          f"ties (row, token, gap, ulp): {diffs}", flush=True)
    launches = {"w2a8_gemv": k["launches"]}
    return launches, dict(memory=list(mem.shape), cache_bytes=nbytes,
                          seed_ms=k["seed_ms"], plain_seed_ms=p["seed_ms"],
                          decode_ms=k["decode_ms"], plain_decode_ms=p["decode_ms"],
                          tokens_before_first_difference=agree,
                          first_differences=diffs, launches=launches)


def train_whisper(dev, out_dir):
    """14c: whisper-medium at full width and depth distilled: an FP teacher
    from a seeded init, the refined QAT student (fp32 master weights, bf16
    compute, remat), one CE step on the corpus and two distillation steps on
    mnli-syn (logits KD and relation KD at the decoder's last
    ``attn_cross`` layer) at batch 4 x decoder length 256, with frames
    [4, 1500, 1024] from a seed, on the kernel route (bitlinear counted at
    2 x 384 a step: the encoder's 24 x 6 projections and the decoder's
    24 x 10, each forward recomputed once under remat; relation_kd 3 a
    distill step) and on the plain route.  The CE step and the first
    distillation step each start from the refined weights with a fresh
    optimizer state, on both routes.  Gates: the counts, finite metrics and
    parameters, and those two steps within phase 6's bound: the CE step's
    loss rtol 1e-4; the distill step's parts and grad_norm 1e-3, and its
    loss, ~97% γ·loss_ad, as its parts.  Prints each
    step's time and the peak memory.  Returns the kernel route's launches
    and the numbers."""
    import torch
    from repro_torch.core.distill import DistillConfig
    from repro_torch.kernels.bitlinear import kernel as bl_k
    from repro_torch.kernels.relation_kd import kernel as rk_k
    from repro_torch.models import build_model, get_config
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import constant
    from repro_torch.training.trainer import (default_distill_layer, init_train_state,
                                              make_distill_step, make_train_step)

    cfg = get_config(WHISPER).replace(compute_dtype="bfloat16")
    if not (cfg.remat and cfg.param_dtype == "float32"):
        fail(f"unexpected {WHISPER} training config: {cfg}")
    torch.cuda.empty_cache()
    teacher = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    b = CROSS_TRAIN_BATCH

    def with_frames(batch):
        batch = {k: v[:b] for k, v in batch.items()}
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=dev)
        return batch

    batches = [("train", with_frames(_train_batches("corpus", 17, 1, dev,
                                                    CROSS_TRAIN_SEQ)[0]))]
    batches += [("distill", with_frames(x)) for x in
                _train_batches("mnli-syn", 0, 2, dev, CROSS_TRAIN_SEQ)]
    per_fwd = cfg.n_encoder_layers * 6 + cfg.n_layers * 10
    expect = {"train": {"bitlinear": 2 * per_fwd, "relation_kd": 0},
              "distill": {"bitlinear": 2 * per_fwd, "relation_kd": 3}}
    counters = (bl_k.launches, rk_k.launches)
    runs = {}
    for tag, use_kernel in (("kernels", True), ("plain", False)):
        scfg, student = _student_from(teacher, cfg, use_kernel, dev)
        dl = default_distill_layer(scfg)
        opt = AdamW(AdamWConfig(weight_decay=0.01))
        lr = lambda s: constant(s, 1e-4)
        steps = {"train": make_train_step(student, opt, lr),
                 "distill": make_distill_step(student, teacher, opt, lr, DistillConfig(
                     use_kernel=use_kernel, distill_layer=dl))}
        refined = {k: v.clone() for k, v in student.state_dict().items()}
        torch.cuda.reset_peak_memory_stats(dev)
        log = []
        for kind, batch in batches:
            if not log or kind != log[-1]["kind"]:
                # each kind's first step from the refined weights and a
                # fresh optimizer state, on both routes alike
                student.load_state_dict(refined)
                state = init_train_state(student, opt)
            for c in counters:
                c.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps[kind](state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = {c.name: c.count for c in counters}
            vals = {k: float(v) for k, v in m.items()}
            if not all(math.isfinite(v) for v in vals.values()):
                fail(f"whisper {tag} {kind} step {len(log)}: non-finite {vals}")
            if got != (expect[kind] if use_kernel else {"bitlinear": 0, "relation_kd": 0}):
                fail(f"whisper {tag} {kind} step {len(log)}: launches {got}, expected "
                     f"{expect[kind] if use_kernel else 'none'}")
            log.append(dict(kind=kind, ms=ms, launches=got, **vals))
            print(f"    {tag} {kind} step {len(log) - 1}: " + " ".join(
                f"{k} {vals[k]:.6g}" for k in ("loss", "loss_ce", "loss_ld", "loss_ad",
                                               "grad_norm") if k in vals)
                  + f"; {ms:.1f} ms; launches {got}", flush=True)
        peak = torch.cuda.max_memory_allocated(dev)
        for pname, p in student.named_parameters():
            if not bool(torch.isfinite(p).all()):
                fail(f"whisper {tag}: parameter {pname} holds non-finite values")
        runs[tag] = dict(steps=log, peak_bytes=peak, distill_layer=dl)
        print(f"    {tag} route: peak memory {peak / 1e9:.2f} GB", flush=True)
        del student, steps, state, opt
        torch.cuda.empty_cache()
    rel = []
    for a, p in zip(runs["kernels"]["steps"], runs["plain"]["steps"]):
        rel.append({k: abs(a[k] - p[k]) / abs(p[k]) for k in
                    ("loss", "loss_ce", "loss_ld", "loss_ad", "grad_norm") if k in p})
    print("    kernels vs plain route, relative differences by step: " + "; ".join(
        ", ".join(f"{k} {v:.2g}" for k, v in r.items()) for r in rel), flush=True)
    # the first step of each kind starts from the same weights on both
    # routes (the second distill step from weights the first moved apart:
    # printed only).  Phase 6's bound: the CE step's loss (CE alone) rtol
    # 1e-4; the distill step's parts and grad_norm 1e-3, and its loss too,
    # since γ·loss_ad is ~97% of it here, so it moves as that part does
    firsts = [i for i, (kind, _) in enumerate(batches)
              if i == 0 or kind != batches[i - 1][0]]
    bad = []
    for i in firsts:
        bounds = ({"loss": 1e-4} if batches[i][0] == "train" else
                  dict.fromkeys(("loss", "loss_ce", "loss_ld", "loss_ad",
                                 "grad_norm"), 1e-3))
        bad += [(i, k, rel[i][k]) for k, rtol in bounds.items()
                if not rel[i][k] <= rtol]
    if bad:
        fail(f"whisper distillation: the routes differ beyond phase 6's bound at "
             f"(step, metric, relative difference) {bad}")
    del teacher
    torch.cuda.empty_cache()
    launches = {c: sum(s["launches"][c] for s in runs["kernels"]["steps"])
                for c in ("bitlinear", "relation_kd")}
    (out_dir / "smoke_train_whisper.json").write_text(json.dumps(dict(
        runs=runs, relative=rel), indent=1))
    return launches, dict(runs=runs, relative=rel, bitlinear_per_step=2 * per_fwd)


def vision_block_parity(dev):
    """14e: one ``LayerSpec("cross", "dense")`` block of llama-3.2-vision-11b
    at full width (d_model 4096, 32 heads with 8 kv heads of 128, d_ff
    14336; SubLN; bf16 parameters and compute, its config's) as a QAT
    student: x [2, 512, 4096] over memory [2, 1601, 4096], forward and
    backward (input, memory and parameters) on the kernel route (bitlinear
    for the cross-attention's q, k, v, o, k and v at the memory's M = 3,202
    rows, and the FFN's gate, up, down) and on the plain route from the
    same weights and inputs.  Gates as 13c's: 7 bitlinear launches, each
    bitwise to its plain version on its operands, and the two routes within
    bf16's scale (``BLOCK_BF16_*``), all finite.  Returns the launches and
    the numbers."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.bitlinear import kernel as bl_k
    from repro_torch.models import get_config
    from repro_torch.nn.transformer import Block, LayerSpec

    spec = LayerSpec("cross", "dense")
    base = get_config(VISION).replace(compute_dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    x0 = torch.randn((2, 512, base.d_model), generator=gen, device=dev).to(torch.bfloat16)
    m0 = torch.randn((2, base.num_image_tokens, base.d_model), generator=gen,
                     device=dev).to(torch.bfloat16)
    w = torch.randn((2, 512, base.d_model), generator=gen, device=dev)
    out, grads, state = {}, {}, None
    for tag, use_kernel in (("kernels", True), ("plain", False)):
        cfg = base.with_quant(Q.QuantConfig(mode="qat", use_kernel=use_kernel))
        blk = Block(cfg.block_config(), spec, device=dev,
                    gen=torch.Generator(device=dev).manual_seed(2) if state is None
                    else None)
        if state is None:
            state = blk.state_dict()
        else:
            blk.load_state_dict(state)
        x, mem = x0.clone().requires_grad_(), m0.clone().requires_grad_()
        bl_k.launches.reset()
        with _Route(use_kernel) as route:
            y, _, _ = blk(x, None, mem)
            (y.float() * w).sum().backward()
        torch.cuda.synchronize()
        if use_kernel:
            launches = {"bitlinear": bl_k.launches.count}
            kernel_route = route
        out[tag] = y.detach().float()
        grads[tag] = dict({k: p.grad.detach().float() for k, p in blk.named_parameters()},
                          x=x.grad.float(), memory=mem.grad.float())
        del blk, y, x, mem
    n_params = sum(t.numel() for t in state.values())
    del state
    if launches != {"bitlinear": 7}:
        fail(f"llama-vision cross block, kernel route: launches {launches}; want "
             "bitlinear 7 (q, k, v, o, gate, up, down)")
    shapes, _ = kernel_route.check("llama-vision cross block")
    rel_out = ((out["kernels"] - out["plain"]).abs().max()
               / out["plain"].abs().max()).item()
    rel_grad = {}
    for k, gp in grads["plain"].items():
        gk = grads["kernels"][k]
        if not bool(torch.isfinite(gk).all()):
            fail(f"llama-vision cross block, kernel route: gradient of {k} is not finite")
        rel_grad[k] = ((gk - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  llama-vision (cross, dense) block, {n_params / 1e9:.3f} B parameters, "
          f"bf16 QAT, x 2 x 512 over memory 2 x {base.num_image_tokens}: launches "
          f"{launches}; bitlinear bitwise at {shapes}; kernel vs plain route: output "
          f"max err / max|y| {rel_out:.3g}, gradients max err / largest entry: "
          + ", ".join(f"{k} {v:.2g}" for k, v in rel_grad.items())
          + f"; peak memory {peak / 1e9:.2f} GB", flush=True)
    bad = {k: v for k, v in rel_grad.items() if not v <= BLOCK_BF16_GRAD}
    if not (math.isfinite(rel_out) and rel_out <= BLOCK_BF16_OUT) or bad:
        fail(f"llama-vision cross block: kernel vs plain route beyond bf16's scale: "
             f"output {rel_out} (limit {BLOCK_BF16_OUT}), gradients {bad} (limit "
             f"{BLOCK_BF16_GRAD})")
    del out, grads, kernel_route
    torch.cuda.empty_cache()
    return launches, dict(params=n_params, bitlinear_shapes=shapes,
                          output_rel_err=rel_out, grad_rel_err=rel_grad,
                          peak_bytes=peak)


def vision_reduced(dev):
    """14f: llama-3.2-vision-11b reduced to one repeat of its five-layer
    pattern (four attention layers, then a cross one; the reduced widths,
    fp32) on the card.  (a) Served packed on the contiguous cache, 4
    prompts of 9..40 tokens x 12 greedy tokens, on the kernel route (w2a8
    counted at 33 launches a decode pass: 7 for each attention + dense
    layer, 5 for the cross + dense one) and on the plain route: the tokens
    must be identical.  (b) One QAT CE step with ``image_embeds`` [8, 8,
    128] on the kernel route (bitlinear 35 launches: no remat in the
    reduced config) and on the plain route from the same weights and batch:
    each launch bitwise to its plain version on its operands, the loss
    within phase 6's rtol 1e-4, grad_norm within ``STEP_FLIP_RTOL``.
    Returns the launches of (a) and (b) and the numbers."""
    import numpy as np
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.bitlinear import kernel as bl_k
    from repro_torch.kernels.paged_attention import kernel as pa_k
    from repro_torch.kernels.paged_prefill import kernel as pp_k
    from repro_torch.kernels.w2a8_gemv import kernel as w2_k
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import ServeConfig
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import constant
    from repro_torch.training.trainer import init_train_state, make_train_step

    base = get_config(VISION).reduced(layers=5)
    per_pass = _w2a8_per_pass(base)
    if per_pass != 33:
        fail(f"llama-vision reduced: {per_pass} w2a8 launches a pass, not 33")
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, base.vocab, int(k)).tolist() for k in (9, 40, 17, 23)]
    scfg = ServeConfig(max_batch=4, max_len=64, prefill_chunk=8)
    toks, state = {}, None
    for tag, use_kernel in (("kernels", True), ("plain", False)):
        cfg = base.with_quant(Q.QuantConfig(mode="packed", use_kernel=use_kernel))
        model = build_model(cfg, device=dev, gen=None if state else
                            torch.Generator(device=dev).manual_seed(0))
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        if use_kernel:
            counters = (w2_k.launches, pa_k.launches, pp_k.launches)
            passes = _PassCounter(model)
            for c in counters:
                c.reset()
        toks[tag], eng = _serve_all(cfg, model, scfg, prompts, tokens=12)
        if use_kernel:
            serve_launches = {c.name: c.count for c in counters}
            n_pass = passes.n
            passes.close()
            if eng.paged:
                fail("llama-vision reduced resolved to the paged cache")
        del eng, model
    if serve_launches["w2a8_gemv"] != per_pass * n_pass or \
            serve_launches["paged_attention_decode"] or \
            serve_launches["paged_prefill_chunk"]:
        fail(f"llama-vision reduced serving: launches {serve_launches} over {n_pass} "
             f"decode passes; want w2a8 {per_pass} a pass and no paged kernel")
    if toks["kernels"] != toks["plain"]:
        fail(f"llama-vision reduced: greedy tokens differ between the routes: "
             f"{toks['kernels']} vs {toks['plain']}")
    print(f"  (a) served {len(prompts)} requests x 12 tokens on the contiguous "
          f"cache: {n_pass} decode passes, launches {serve_launches}; plain route's "
          "tokens identical", flush=True)

    batch = _train_batches("corpus", 17, 1, dev, base.max_seq)[0]
    batch["image_embeds"] = torch.randn(
        (TRAIN_BATCH, base.num_image_tokens, base.d_model),
        generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    metrics, state = {}, None
    for tag, use_kernel in (("kernels", True), ("plain", False)):
        cfg = base.with_quant(Q.QuantConfig(mode="qat", use_kernel=use_kernel))
        model = build_model(cfg, device=dev, gen=None if state else
                            torch.Generator(device=dev).manual_seed(1))
        if state is None:   # a copy: the step updates the parameters in place
            state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        opt = AdamW(AdamWConfig(weight_decay=0.01))
        step = make_train_step(model, opt, lambda s: constant(s, 1e-4))
        bl_k.launches.reset()
        with _Route(use_kernel) as route:
            _, m = step(init_train_state(model, opt), batch)
            torch.cuda.synchronize()
        if use_kernel:
            train_launches = {"bitlinear": bl_k.launches.count}
            kernel_route = route
        metrics[tag] = {k: float(v) for k, v in m.items()}
        del model, opt, step
    if train_launches != {"bitlinear": 35}:
        fail(f"llama-vision reduced QAT step: launches {train_launches}; want "
             "bitlinear 35")
    shapes, _ = kernel_route.check("llama-vision reduced QAT step")
    a, b = metrics["kernels"], metrics["plain"]
    rel = {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
    print("  (b) QAT CE step with image_embeds, kernels / plain (relative "
          "difference): " + ", ".join(f"{k} {a[k]:.7g} / {b[k]:.7g} ({rel[k]:.2g})"
                                      for k in rel)
          + f"; launches {train_launches}, {len(shapes)} bitlinear bitwise on "
          "their operands", flush=True)
    for k, rtol in (("loss", 1e-4), ("grad_norm", STEP_FLIP_RTOL)):
        if not (math.isfinite(a[k]) and rel[k] <= rtol):
            fail(f"llama-vision reduced QAT step {k}: kernels {a[k]!r} vs plain "
                 f"{b[k]!r} (rtol {rtol})")
    torch.cuda.empty_cache()
    return (serve_launches, train_launches), dict(
        passes=n_pass, serve_launches=serve_launches, train=metrics,
        train_launches=train_launches)


def cross_families(dev, out_dir, by_path):
    """Phase 14: whisper-medium served (a), over its audio memory (b) and
    distilled (c) at full width; llama-3.2-vision-11b served at full width
    and over its image memory (d), one full-width cross block (e) and its
    reduced stack (f).  Each path's launches go into ``by_path``."""
    import torch
    phase14, t0 = {}, time.perf_counter()

    def part(title):
        print(f"  {title} [+{time.perf_counter() - t0:.1f} s]", flush=True)

    part("14a: whisper-medium served through the Engine (packed, full width)")
    by_path["serve whisper-medium (14a)"], phase14["14a"], kernel, plain = \
        serve_cross(dev, out_dir, WHISPER, 24 * 8, "whisper")
    part("14b: whisper-medium over audio frames [4, 1500, 1024] at the model "
         "level")
    # the encoder's 24 x 6 projections and the decoder's 24 cross k and v
    by_path["whisper audio memory (14b)"], phase14["14b"] = cross_memory(
        dev, kernel, plain, 24 * 6 + 24 * 2)
    del kernel, plain
    torch.cuda.empty_cache()
    part("14c: whisper-medium distilled (full width, B = 4, S = 256, frames "
         "[4, 1500, 1024])")
    by_path["train whisper-medium (14c)"], phase14["14c"] = train_whisper(dev, out_dir)
    part("14d: llama-3.2-vision-11b served through the Engine (packed, full "
         "width and depth)")
    by_path["serve llama-3.2-vision-11b (14d)"], phase14["14d"], kernel, plain = \
        serve_cross(dev, out_dir, VISION, 32 * 7 + 8 * 5, "vision")
    part("14d: llama-3.2-vision-11b over image memory [4, 1601, 4096] at the "
         "model level")
    by_path["llama-vision image memory (14d)"], phase14["14d_memory"] = cross_memory(
        dev, kernel, plain, 8 * 2)
    del kernel, plain
    torch.cuda.empty_cache()
    part("14e: one full-width llama-vision (cross, dense) block, kernel vs plain "
         "route")
    by_path["llama-vision cross block (14e)"], phase14["14e"] = vision_block_parity(dev)
    part("14f: llama-vision reduced (one repeat, 5 layers): contiguous serving, "
         "a QAT step with image_embeds, kernel vs plain route")
    ((by_path["serve llama-vision reduced (14f)"],
      by_path["train llama-vision reduced (14f)"]), phase14["14f"]) = vision_reduced(dev)
    part("phase 14 done")
    (out_dir / "smoke_cross.json").write_text(json.dumps(phase14, indent=1, default=str))
    return phase14


# -- phase 15: the distributed layer at world size 1 ------------------------------

# 15a: qwen3-0.6b's width at 10a's depth, 3 CE steps with and without a plan
DIST_LAYERS, DIST_STEPS = 4, 3
# 15b: the launcher under torch.distributed.run, at two layers (its final
# checkpoint, ~2 GB, is written and removed)
DIST_CLI = ["--arch", "qwen3-0.6b", "--layers", "2", "--steps", "2", "--batch", "8",
            "--seq", "256", "--log-every", "1", "--dp", "1", "--tp", "1",
            "--ckpt-every", "100"]
# 15c: compressed_psum's length; 15d: GPipe's micro-batches at qwen3's width
PSUM_N = 16 << 20
GPIPE_MICRO, GPIPE_ROWS = 4, 2


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plan_vs_plain(dev, plan):
    """15a: the same seeded model, batches and AdamW, ``DIST_STEPS`` CE
    steps without a plan and under ``plan``, on the kernel route; ->
    ({route: (losses, grad norms, bitlinear launches a step)}, the
    parameters' largest difference, the bitlinear launches under the plan)."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.distributed.sharding import set_plan
    from repro_torch.kernels.bitlinear import kernel as bl_k
    from repro_torch.models import build_model, get_config
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import constant
    from repro_torch.training.trainer import init_train_state, make_train_step
    cfg = get_config("qwen3-0.6b").replace(n_layers=DIST_LAYERS).with_quant(
        Q.QuantConfig(mode="qat", use_kernel=True))
    batches = _train_batches("corpus", 17, DIST_STEPS, dev, QWEN_SEQ)
    runs, params = {}, {}
    for tag, p in (("plain", None), ("plan", plan)):
        model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        opt = AdamW(AdamWConfig())
        state = init_train_state(model, opt, p)
        step = make_train_step(model, opt, lambda s: constant(s, 1e-4), plan=p)
        set_plan(p)
        losses, norms, per_step = [], [], []
        try:
            bl_k.launches.reset()
            for b in batches:
                before = bl_k.launches.count
                state, m = step(state, b)
                torch.cuda.synchronize()
                per_step.append(bl_k.launches.count - before)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            launches = bl_k.launches.count
        finally:
            set_plan(None)
        if tag == "plan":
            plan_launches = launches
            local = {k: v.to_local().shape for k, v in state.params.items()}
            if any(tuple(s) != tuple(v.shape) for s, v in zip(local.values(),
                                                             state.params.values())):
                fail("15a: at world size 1 a rank must hold every leaf whole")
        params[tag] = {k: (v.full_tensor() if tag == "plan" else v).detach().clone()
                       for k, v in state.params.items()}
        runs[tag] = (losses, norms, per_step)
        del model, opt, state, step
        torch.cuda.empty_cache()
    diff = max(float((params["plan"][k].float() - v.float()).abs().max())
               for k, v in params["plain"].items())
    bitwise = all(torch.equal(params["plan"][k], v) for k, v in params["plain"].items())
    return runs, diff, bitwise, plan_launches


def distributed_layer(dev, out_dir, card):
    """Phase 15: the distributed layer on a one-rank NCCL group: (a) the CE
    step under a sharding plan against the same steps without one, at full
    width, bitlinear on the kernel route; (b) the launcher under
    ``torch.distributed.run`` with ``--dp 1 --tp 1``; (c) ``compressed_psum``
    over 16 M values, card against CPU; (d) GPipe at one stage against the
    dense composition.  -> (the plan run's launches, a summary)."""
    import os
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.pipeline_parallel import (
        gpipe_forward, pipeline_stage_from_stack)
    from repro_torch.distributed.sharding import ShardingPlan, default_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, get_config
    out, t0 = {}, time.perf_counter()

    def part(title):
        print(f"  {title} [+{time.perf_counter() - t0:.1f} s]", flush=True)

    torch.cuda.set_device(dev.index or 0)    # the rank's card, before its mesh
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        part(f"15a: qwen3-0.6b (full width, {DIST_LAYERS} layers, QAT, kernel route), "
             f"{DIST_STEPS} CE steps without and under a plan on mesh (data 1, model 1)")
        plan = ShardingPlan(make_mesh(1, 1), default_rules(False))
        runs, diff, bitwise, plan_launches = _plan_vs_plain(dev, plan)
        want = 2 * 7 * DIST_LAYERS               # forward + the remat recompute
        for tag, (losses, norms, per_step) in runs.items():
            print(f"  (a) {tag}: losses {losses}, grad_norm {norms}, bitlinear "
                  f"launches a step {per_step}", flush=True)
            if per_step != [want] * DIST_STEPS or not all(map(math.isfinite, losses)):
                fail(f"15a {tag}: bitlinear launches a step {per_step} (want {want}) "
                     f"or losses {losses} not finite")
        print(f"  (a) parameters after step {DIST_STEPS}: largest difference "
              f"{diff!r}, bitwise {bitwise} (bound 0: at one rank the plan's step "
              f"runs the same operations)", flush=True)
        if runs["plan"][0] != runs["plain"][0] or not bitwise:
            fail(f"15a: the plan's losses {runs['plan'][0]} vs {runs['plain'][0]}, "
                 f"parameters {diff!r} apart: want them equal")
        out["15a"] = dict(runs=runs, param_diff=diff, bitwise=bitwise,
                          launches=plan_launches)

        part("15b: the launcher under torch.distributed.run --nproc-per-node 1, "
             "--dp 1 --tp 1, 2 steps")
        ckpt = out_dir / "dist_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t1 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "repro_torch.launch.train", *DIST_CLI,
             "--ckpt-dir", str(ckpt)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=600)
        secs = time.perf_counter() - t1
        (out_dir / "dist_launcher.log").write_text(r.stdout)
        lines = _step_lines(r.stdout)
        saved = (ckpt / "step_00000002").is_dir()
        shutil.rmtree(ckpt, ignore_errors=True)
        if r.returncode != 0 or len(lines) != 2 or not saved or \
                not r.stdout.strip().endswith("done"):
            fail(f"15b: launcher exit {r.returncode}, step lines {lines}, checkpoint "
                 f"saved {saved}:\n{r.stdout[-3000:]}")
        print(f"  (b) exit 0 in {secs:.1f} s ({card}): " + " | ".join(lines),
              flush=True)
        out["15b"] = dict(seconds=secs, lines=lines)

        part(f"15c: compressed_psum over {PSUM_N} values, card vs CPU, two rounds")
        gen = torch.Generator(device=dev).manual_seed(15)
        group = dist.group.WORLD
        x = [torch.randn(PSUM_N, generator=gen, device=dev) * 3 for _ in range(2)]
        e_card = torch.zeros(PSUM_N, device=dev)
        e_cpu = e_card.cpu()
        for rnd in range(2):
            y_card, e_card = compressed_psum(x[rnd], group, e_card)
            y_cpu, e_cpu = compressed_psum(x[rnd].cpu(), group, e_cpu)
            if rnd == 0:
                rel = float(torch.linalg.norm(y_card - x[0]) / torch.linalg.norm(x[0]))
            if not (torch.equal(y_card.cpu(), y_cpu) and torch.equal(e_card.cpu(), e_cpu)):
                fail(f"15c round {rnd}: card and CPU differ by "
                     f"{float((y_card.cpu() - y_cpu).abs().max())!r} (mean), "
                     f"{float((e_card.cpu() - e_cpu).abs().max())!r} (residual)")
        ms = time_ms(lambda: compressed_psum(x[0], group, e_card), iters=10)
        print(f"  (c) both rounds bitwise card vs CPU; {ms:.3f} ms a call on the card "
              f"({card}); relative error of the one-rank mean {rel:.3g}", flush=True)
        out["15c"] = dict(ms=ms, rel_err=rel)

        part("15d: GPipe at one stage: toy tanh stage and qwen3-0.6b's 4-layer "
             f"stack over {GPIPE_MICRO} micro-batches of {GPIPE_ROWS} x {QWEN_SEQ}")
        w = torch.randn((16, 16), generator=gen, device=dev) * 0.3
        xs = torch.randn((8, 4, 16), generator=gen, device=dev)
        toy = gpipe_forward(lambda p, h: torch.tanh(h @ p), group, 1)(w, xs)
        if not torch.allclose(toy, torch.tanh(xs @ w), rtol=2e-5, atol=2e-5):
            fail("15d: one-stage GPipe differs from tanh(x @ w)")
        cfg = get_config("qwen3-0.6b").replace(n_layers=DIST_LAYERS)
        model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        hs = torch.randn((GPIPE_MICRO, GPIPE_ROWS, QWEN_SEQ, cfg.d_model),
                         generator=gen, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            got = gpipe_forward(pipeline_stage_from_stack(model.stack, DIST_LAYERS),
                                group, 1)(0, hs)
            dense = torch.stack([model.stack(h)[0] for h in hs])
        if not torch.equal(got, dense):
            fail(f"15d: GPipe's stack differs from Stack.forward by "
                 f"{float((got.float() - dense.float()).abs().max())!r}")
        print("  (d) toy stage within 2e-5 of the dense composition; the stack's "
              "stage bitwise Stack.forward", flush=True)
        del model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    part("phase 15 done")
    (out_dir / "smoke_distributed.json").write_text(json.dumps(out, indent=1, default=str))
    return {"bitlinear": plan_launches}, out


# -- phase 16: the analysis and dry-run tooling on the card -------------------------

# 16b: meta's peak live bytes against the card's max_memory_allocated
PEAK_TOLERANCE = 0.25
# 16c: the engine's workload: prompts of 24 tokens (one chunk step) x 8 tokens
TOOL_PROMPTS, TOOL_PROMPT_LEN, TOOL_TOKENS = 8, 24, 8
# 16d: the dry-run cells, and the device count of the 1-pod mesh
DRYRUN_CELLS = (("qwen1.5-0.5b", "decode_32k"), ("qwen2.5-3b", "train_4k"))


def _device_ms(fn) -> float:
    """Device time of ``fn``'s kernels from a profile (their self device
    times summed), or 0.0 where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3


def _op_count_train_step(dev):
    """16b: phase 15a's CE step (qwen3-0.6b full width, DIST_LAYERS layers,
    QAT, bitlinear on the kernel route, 8 x 256) counted by op_analysis on
    the card and on meta at the same shapes."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import quant as Q
    from repro_torch.kernels.bitlinear import kernel as bl_k
    from repro_torch.launch.memest import estimate
    from repro_torch.launch.op_analysis import count
    from repro_torch.models import build_model, get_config
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import constant
    from repro_torch.training.trainer import init_train_state, make_train_step
    R = roofline()
    cfg = get_config("qwen3-0.6b").replace(n_layers=DIST_LAYERS).with_quant(
        Q.QuantConfig(mode="qat", use_kernel=True))
    batches = _train_batches("corpus", 17, 2, dev, QWEN_SEQ)
    lr = lambda s: constant(s, 1e-4)

    def setup(device, gen=None):
        model = build_model(cfg, gen=gen, device=device)
        opt = AdamW(AdamWConfig())
        return model, init_train_state(model, opt), make_train_step(model, opt, lr)

    model, state, step = setup(dev, torch.Generator(device=dev).manual_seed(0))
    state, _ = step(state, batches[0])          # warm: the kernels' buffers
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bl_k.launches.reset()
    card = count(step, state, batches[1], resident=model)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated()
    launches = bl_k.launches.count
    step_ms = []
    for b in (batches[0], batches[1], batches[0]):
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    mmodel, mstate, mstep = setup(torch.device("meta"))
    meta = count(mstep, mstate, {k: torch.empty_like(v, device="meta")
                                 for k, v in batches[1].items()}, resident=mmodel)
    want = 2 * 7 * DIST_LAYERS                 # forward + the remat recompute
    calls = card.kernel_calls.get("bitlinear", {}).get("calls")
    print(f"  (b) card: {card.flops:.6e} FLOPs, {card.hbm_bytes:.6e} bytes, "
          f"kernel calls {card.kernel_calls}; meta: {meta.flops:.6e} FLOPs, "
          f"{meta.hbm_bytes:.6e} bytes; bitlinear launches {launches}", flush=True)
    if (card.flops, card.hbm_bytes) != (meta.flops, meta.hbm_bytes):
        fail(f"16b: card and meta counts differ: flops {card.flops!r} vs "
             f"{meta.flops!r}, bytes {card.hbm_bytes!r} vs {meta.hbm_bytes!r}; ops "
             + str({k: (card.op_calls.get(k), meta.op_calls.get(k))
                    for k in set(card.op_calls) | set(meta.op_calls)
                    if card.op_calls.get(k) != meta.op_calls.get(k)}))
    if calls != want or launches != want or \
            meta.kernel_calls.get("bitlinear", {}).get("calls") != want:
        fail(f"16b: bitlinear kernel calls {calls} (meta "
             f"{meta.kernel_calls.get('bitlinear')}), launches {launches}; want {want}")
    ratio = meta.peak_live_bytes / card_peak
    print(f"  (b) peak: meta {meta.peak_live_bytes / 2**30:.3f} GiB, card "
          f"max_memory_allocated {card_peak / 2**30:.3f} GiB (ratio {ratio:.3f}; "
          f"the card's count {card.peak_live_bytes / 2**30:.3f} GiB)", flush=True)
    if abs(ratio - 1.0) > PEAK_TOLERANCE:
        fail(f"16b: meta's peak live bytes {meta.peak_live_bytes} are not within "
             f"{PEAK_TOLERANCE:.0%} of the card's peak {card_peak}")
    est = estimate(cfg, ShapeSpec("smoke", QWEN_SEQ, TRAIN_BATCH, "train"), 1, 1,
                   opt_8bit=False, step_kind="train")
    roof = R.Roofline(card.flops, card.hbm_bytes, 0.0, 1)
    measured = statistics.median(step_ms)
    print(f"  (b) memest total {est['total'] / 2**30:.3f} GiB; roofline step "
          f"{roof.step_time * 1e3:.3f} ms ({roof.bottleneck}: compute "
          f"{roof.t_compute * 1e3:.3f}, memory {roof.t_memory * 1e3:.3f}) against "
          f"the measured step {measured:.1f} ms (median of {step_ms}), ratio "
          f"{measured / (roof.step_time * 1e3):.1f}", flush=True)
    return {"bitlinear": launches}, dict(
        card=card.to_dict(), meta=meta.to_dict(), card_peak=card_peak,
        peak_ratio=ratio, memest_total=est["total"], roofline=roof.to_dict(),
        step_ms=step_ms)


def _op_count_decode_pass(dev):
    """16c: phase 3's engine (qwen3-0.6b packed, full depth) under the
    step-signature watchdog: a warm pass, freeze(), the same-shaped pass
    (no new signature, no build); one decode pass of it counted on the
    card."""
    import numpy as np
    import torch
    from repro_torch.analysis.retrace import RetraceWatchdog
    from repro_torch.core import quant as Q
    from repro_torch.kernels.paged_attention import kernel as pa_k
    from repro_torch.kernels.paged_prefill import kernel as pp_k
    from repro_torch.kernels.w2a8_gemv import kernel as w2_k
    from repro_torch.launch.op_analysis import count
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import Engine, SamplingParams, ServeConfig
    R = roofline()
    cfg = get_config("qwen3-0.6b").with_quant(
        Q.QuantConfig(mode="packed", use_kernel=True)).replace(
        compute_dtype="bfloat16")
    model = build_model(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    eng = Engine(cfg, model, ServeConfig(max_batch=TOOL_PROMPTS, max_len=1024,
                                         prefill_chunk=32, cache_dtype="bfloat16"))
    wd = RetraceWatchdog.attach(eng)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab, TOOL_PROMPT_LEN).tolist()
               for _ in range(TOOL_PROMPTS)]
    greedy = SamplingParams(max_tokens=TOOL_TOKENS, ignore_eos=True)
    counters = (w2_k.launches, pa_k.launches, pp_k.launches)
    out = {}
    try:
        def workload(counted):
            reqs = [eng.submit(p, greedy) for p in prompts]
            eng.step()                        # the prompts' one chunk step
            if counted:
                for c in counters:
                    c.reset()
                cost = count(eng.step)        # a decode pass
                torch.cuda.synchronize()
                out["launches"] = {c.name: c.count for c in counters}
                out["cost"] = cost
                out["device_ms"] = _device_ms(eng.step)
            while eng.has_pending():
                eng.step()
            return [r.output_tokens for r in reqs]

        warm = workload(False)
        wd.freeze()
        again = workload(True)
        wd.check()
    finally:
        wd.detach()
    if warm != again:
        fail("16c: the same-shaped pass gave other tokens than the warm pass")
    cost, launches = out["cost"], out["launches"]
    calls = {k: v["calls"] for k, v in cost.kernel_calls.items()}
    want = {"w2a8_gemv": 7 * cfg.n_layers, "paged_attention_decode": cfg.n_layers,
            "paged_prefill_chunk": 0}
    print(f"  (c) watchdog: {wd.signatures_per_impl()} signatures, "
          f"{wd.calls_per_impl()} calls, {wd.builds} builds, no violation after "
          f"freeze()", flush=True)
    if wd.builds:
        fail(f"16c: the kernels were built {wd.builds} times after attach")
    if launches != want or {k: calls.get(k, 0) for k in want} != want:
        fail(f"16c: a decode pass counted {calls}, launched {launches}; want {want}")
    floor = cost.hbm_bytes / R.HBM_BW * 1e3
    print(f"  (c) one decode pass: kernel calls {calls} (launches {launches}); "
          f"modelled {cost.hbm_bytes:.6e} bytes ({cost.kernel_bytes:.6e} in the "
          f"kernels), {cost.flops:.6e} FLOPs: {floor:.4f} ms at the HBM rate; "
          f"measured device time "
          f"{format(out['device_ms'], '.4f') + ' ms' if out['device_ms'] else 'not measured'}"
          f" (profile of the next decode pass)", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if v}, dict(
        cost=cost.to_dict(), launches=launches, device_ms=out["device_ms"],
        floor_ms=floor, signatures=wd.signatures_per_impl())


def tooling(dev, out_dir, card):
    """Phase 16: (a) ``python -m repro_torch.analysis --retrace-smoke``;
    (b) op counting of a training step on the card and on meta; (c) one
    decode pass counted on the card, under the step-signature watchdog; (d)
    the dry run of two cells on the production mesh and their report.
    -> ({path: launches}, a summary)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0, res, by_path = time.perf_counter(), {}, {}

    def part(title):
        print(f"  {title} [+{time.perf_counter() - t0:.1f} s]", flush=True)

    part("16d (started first, on the CPU): python -m repro_torch.launch.dryrun "
         + ", ".join(f"{a} x {s}" for a, s in DRYRUN_CELLS))
    dry_dir = out_dir / "dryrun"
    dry = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape",
         s, "--force", "--out", str(dry_dir)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a, s in DRYRUN_CELLS]
    try:
        part("16a: python -m repro_torch.analysis --retrace-smoke")
        r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                            "--retrace-smoke"], cwd=ROOT, env=env, timeout=300,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        (out_dir / "analysis.log").write_text(r.stdout)
        if r.returncode != 0:
            fail(f"16a: python -m repro_torch.analysis exited {r.returncode}:\n"
                 f"{r.stdout[-3000:]}")
        print("  (a) " + " | ".join(l.strip() for l in r.stdout.splitlines()
                                    if l.startswith(("lint:", "  0 active",
                                                     "analysis:"))), flush=True)
        part(f"16b: qwen3-0.6b (full width, {DIST_LAYERS} layers, QAT, kernel "
             f"route), a CE step at {TRAIN_BATCH} x {QWEN_SEQ} counted on the "
             "card and on meta")
        by_path["op count, CE step qwen3-0.6b 4 layers (16b)"], res["16b"] = \
            _op_count_train_step(dev)
        part("16c: qwen3-0.6b packed (full depth): a decode pass counted on the "
             "card, the step-signature watchdog over two same-shaped passes")
        by_path["op count, decode pass qwen3-0.6b (16c)"], res["16c"] = \
            _op_count_decode_pass(dev)
        part("16d: the dry run's cells and their report")
        for (a, s), proc in zip(DRYRUN_CELLS, dry):
            text, _ = proc.communicate(timeout=600)
            (out_dir / f"dryrun_{a}_{s}.log").write_text(text)
            path = dry_dir / f"{a}__{s}__1pod.json"
            d = json.loads(path.read_text()) if path.exists() else {}
            if proc.returncode != 0 or d.get("status") != "ok" or \
                    d.get("n_devices") != 256:
                fail(f"16d: dryrun {a} x {s} exited {proc.returncode}, status "
                     f"{d.get('status')} {d.get('error', '')}, n_devices "
                     f"{d.get('n_devices')}:\n{text[-2000:]}")
            r_ = d["roofline"]
            print(f"  (d) {a} x {s}: {d['step']}, {d['n_devices']} devices, "
                  f"{d['op_cost']['flops']:.4e} FLOPs/chip, bottleneck "
                  f"{r_['bottleneck']}, memest {d['memest_per_chip']['total'] / 2**30:.2f}"
                  f" GiB, peak live {d['peak_live_bytes_per_chip'] / 2**30:.2f} GiB, "
                  f"counted in {d['count_s']} s", flush=True)
            res[f"16d {a} {s}"] = dict(roofline=r_, count_s=d["count_s"])
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                            "--results", str(dry_dir)], cwd=ROOT, env=env,
                           timeout=120, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        rows = [l for l in r.stdout.splitlines() if l.startswith("| ") and
                any(l.startswith(f"| {a} | {s} |") for a, s in DRYRUN_CELLS)]
        if r.returncode != 0 or len(rows) != len(DRYRUN_CELLS) or \
                any("ERROR" in l for l in rows):
            fail(f"16d: report exited {r.returncode}:\n{r.stdout[-2000:]}")
        for l in rows:
            print(f"  (d) {l}", flush=True)
    finally:
        for proc in dry:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res["seconds"] = time.perf_counter() - t0
    print(f"  phase 16: {res['seconds']:.1f} s ({card})", flush=True)
    (out_dir / "smoke_tooling.json").write_text(json.dumps(res, indent=1, default=str))
    return by_path, res


# -- phase 17: tensor-parallel compute (the split route) ----------------------------

# 17a: full-width dense blocks at their tensor-parallel degrees: (config,
# d_model, heads, kv heads, head_dim, d_ff, rows of x, the degrees)
TP_BLOCKS = (("mistral-large-123b", 12288, 96, 8, 128, 28672, 512, (8,)),
             ("qwen3-0.6b", 1024, 16, 8, 128, 3072, TRAIN_BATCH * QWEN_SEQ,
              (2, 4, 16)))
# 17b: phase 15a's model and batches, the distill step's steps
TP_DISTILL_STEPS = 3


class _ShardSim:
    """One rank of a ``size``-way split, simulated in one process for the
    split route's bitlinear functions: its collectives return the values
    the ranks would reduce to (``total``: the float64 sum of |W| over the
    shards in rank order; ``gamma``: the whole rows' absmax), and the
    row-parallel accumulators are kept for the caller to sum."""

    def __init__(self, size, total, gamma, keep=True):
        self.size, self.total, self.gamma, self.keep = size, total, gamma, keep
        self.acc = []

    def sum64(self, t):
        return self.total

    def all_max(self, t):
        return self.gamma

    def acc_sum(self, t):
        if self.keep:
            self.acc.append(t)
        return t


def _projections(d, heads, kv, dh, dff):
    """(name, K, N, part) of a dense block's seven projections."""
    return (("q", d, heads * dh, "col"), ("k", d, kv * dh, "col"),
            ("v", d, kv * dh, "col"), ("o", heads * dh, d, "row"),
            ("gate", d, dff, "col"), ("up", d, dff, "col"), ("down", dff, d, "row"))


def tp_kernel_shards(dev, flush, card):
    """17a: each projection of a full-width block, whole (one launch of
    ``bitlinear_matmul``'s forward) and as each rank's shard at each
    degree through the split route's functions (``kernels/bitlinear/
    ops.py::_fwd_2d`` with the shard's part): column outputs concatenated,
    and row accumulators summed in fp32 and scaled once, bitwise the whole
    layer's; every piece bitwise its plain version on the same card
    tensors.  The kv projections are used whole where their heads do not
    divide over the ranks (qwen3-0.6b at 16).  -> a summary."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.bitlinear import kernel as bl_k, ops as bl_ops
    res, t0 = {}, time.perf_counter()
    before = bl_k.launches.count
    for name, d, heads, kv, dh, dff, m, tps in TP_BLOCKS:
        gen = torch.Generator(device=dev).manual_seed(17)
        xs, rows = {}, []
        for proj, k, n, part in _projections(d, heads, kv, dh, dff):
            x = xs.setdefault(k, torch.randn((m, k), generator=gen, device=dev)
                              .to(torch.bfloat16))
            w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            y, _, gamma_whole, _, delta = bl_ops._fwd_2d(x, w, "absmean")
            gamma = x.float().abs().amax(dim=-1, keepdim=True)
            if not torch.equal(gamma, gamma_whole):
                fail(f"17a {name} {proj}: the kernel's γ differs from the rows' absmax")
            for t in tps:
                if proj in ("k", "v") and kv % t:
                    continue                     # used whole on every rank
                dim = 1 if part == "col" else 0
                shards = [s.contiguous() for s in w.chunk(t, dim=dim)]
                total = torch.zeros((), dtype=torch.float64, device=dev)
                for s_ in shards:
                    total = total + s_.to(torch.float64).abs().sum()
                sim = _ShardSim(t, total, gamma)
                pieces = []
                for r, wr in enumerate(shards):
                    xr = x if part == "col" else x.chunk(t, dim=1)[r].contiguous()
                    yr, codes, g_r, wq, d_r = bl_ops._fwd_2d(xr, wr, "absmean",
                                                            (part, sim))
                    if not torch.equal(d_r, delta):
                        fail(f"17a {name} {proj} tp {t}: the shards' Δ {float(d_r)!r}"
                             f" is not the whole weight's {float(delta)!r}")
                    kr = xr.shape[1]
                    if part == "col":
                        py, pc, pg, pw = bl_ops.bitlinear_forward_ref(xr, wr, d_r)
                        same = (torch.equal(yr, py) and torch.equal(codes[:, :kr], pc)
                                and torch.equal(g_r, pg) and torch.equal(wq, pw))
                        pieces.append(yr)
                    else:
                        acc = sim.acc[-1]
                        pa, pc, pw = bl_ops.bitlinear_forward_acc_ref(xr, wr, d_r, gamma)
                        same = (torch.equal(acc, pa) and torch.equal(codes[:, :kr], pc)
                                and torch.equal(wq, pw))
                        pieces.append(acc)
                    if not same:
                        fail(f"17a {name} {proj} tp {t} rank {r}: the {part}-parallel "
                             "piece differs from its plain version")
                if part == "col":
                    got = torch.cat(pieces, dim=1)
                else:
                    acc = pieces[0]
                    for p_ in pieces[1:]:
                        acc = acc + p_
                    got = (acc * (Q.div(gamma, 127.0) * delta)).to(x.dtype)
                if not torch.equal(got, y):
                    fail(f"17a {name} {proj} tp {t}: the shards' {part}-parallel "
                         f"output differs from the whole layer's by "
                         f"{float((got.float() - y.float()).abs().max())!r}")
            split_at = [tp_ for tp_ in tps if not (proj in ("k", "v") and kv % tp_)]
            t = max(split_at) if split_at else None
            whole_ms = time_ms(lambda: bl_ops._fwd_2d(x, w, "absmean"), iters=10,
                               flush=flush)
            piece_ms = None
            if t is not None:
                dim = 1 if part == "col" else 0
                w0 = w.chunk(t, dim=dim)[0].contiguous()
                x0 = x if part == "col" else x.chunk(t, dim=1)[0].contiguous()
                sim = _ShardSim(t, w.to(torch.float64).abs().sum(), gamma, keep=False)
                piece_ms = time_ms(lambda: bl_ops._fwd_2d(x0, w0, "absmean",
                                                          (part, sim)),
                                   iters=10, flush=flush)
            rows.append(dict(proj=proj, k=k, n=n, part=part, tp=t,
                             whole_ms=whole_ms, piece_ms=piece_ms))
            del w, y
        torch.cuda.empty_cache()
        print(f"  (a) {name} (M = {m}, bf16): every shard bitwise the whole layer "
              f"and its plain version at tp {', '.join(map(str, tps))}; one launch "
              f"of the whole layer vs one rank's piece at the largest degree, ms "
              f"({card}): " + "; ".join(
                  f"{r_['proj']} [{r_['k']}x{r_['n']}, {r_['part']}] "
                  f"{r_['whole_ms']:.4f} vs "
                  + (f"{r_['piece_ms']:.4f} (tp {r_['tp']})" if r_['piece_ms']
                     is not None else "whole on every rank") for r_ in rows),
              flush=True)
        res[name] = rows
    res["launches"] = bl_k.launches.count - before
    res["seconds"] = time.perf_counter() - t0
    print(f"  (a) bitlinear launches in 17a (comparisons, not a path): "
          f"{res['launches']}; {res['seconds']:.1f} s", flush=True)
    return res


PLAN_KERNELS = ("bitlinear", "relation_kd", "ssd_scan")


def _plan_runs(dev, plan, name, layers, kind, seq=None):
    """17b, 18c and 19d: the same seeded teacher, student, batches and
    AdamW, ``TP_DISTILL_STEPS`` steps of ``kind`` ("ce" or "distill")
    without a plan and under ``plan``, the kernels on.  An encoder-decoder's
    batches carry seeded frames; an attention-free student distills without
    relation KD.  -> ({tag: (metrics, the launches of each of PLAN_KERNELS a
    step, f/g calls, launches)}, the parameters' largest difference,
    bitwise)."""
    import torch
    from repro_torch.core.distill import DistillConfig
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels.bitlinear import kernel as bl_k
    from repro_torch.kernels.relation_kd import kernel as rk_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    from repro_torch.models import build_model, get_config
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import constant
    from repro_torch.training.trainer import (default_distill_layer, init_train_state,
                                              make_distill_step, make_train_step,
                                              place_model)
    counters = (bl_k.launches, rk_k.launches, ssd_k.launches)
    tcfg = get_config(name).replace(n_layers=layers)
    batches = _train_batches("corpus", 17, TP_DISTILL_STEPS, dev, seq or QWEN_SEQ)
    if tcfg.family == "audio":
        tcfg = tcfg.replace(n_encoder_layers=layers, compute_dtype="bfloat16")
        gen = torch.Generator(device=dev).manual_seed(17)
        batches = [dict({k: v[:CROSS_TRAIN_BATCH] for k, v in b_.items()},
                        frames=torch.randn((CROSS_TRAIN_BATCH, tcfg.encoder_seq,
                                            tcfg.d_model), generator=gen, device=dev))
                   for b_ in batches]
    lr = lambda s: constant(s, 1e-4)
    runs, params = {}, {}
    for tag, p in (("plain", None), ("plan", plan)):
        teacher = build_model(tcfg, gen=torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        scfg, student = _student_from(teacher, tcfg, True, dev)
        opt = AdamW(AdamWConfig())
        state = init_train_state(student, opt, p)
        if kind == "distill":
            if p is not None:
                place_model(teacher, p)
            dcfg = (DistillConfig(use_ad=False, use_kernel=True)
                    if scfg.family == "ssm" else
                    DistillConfig(distill_layer=default_distill_layer(scfg),
                                  use_kernel=True))
            step = make_distill_step(student, teacher, opt, lr, dcfg, plan=p)
        else:
            del teacher
            step = make_train_step(student, opt, lr, plan=p)
        metrics, per_step = [], []
        for c in counters:
            c.reset()
        tp.counter.reset()
        for b in batches:
            before = [c.count for c in counters]
            state, m = step(state, b)
            torch.cuda.synchronize()
            per_step.append(tuple(c.count - b0 for c, b0 in zip(counters, before)))
            metrics.append({k: float(v) for k, v in m.items()})
        runs[tag] = (metrics, per_step, (tp.counter.f, tp.counter.g),
                     {c.name: c.count for c in counters})
        params[tag] = {k: (v.full_tensor() if p is not None else v).detach().clone()
                       for k, v in state.params.items()}
        del student, opt, state, step
        torch.cuda.empty_cache()
    diff = max(float((params["plan"][k].float() - v.float()).abs().max())
               for k, v in params["plain"].items())
    bitwise = all(torch.equal(params["plan"][k], v) for k, v in params["plain"].items())
    return runs, diff, bitwise


def _check_plan_runs(what, runs, diff, bitwise, want=None):
    """17b, 18c and 19d's fatal checks: finite losses, the launches a step
    (each ``want``, else the plain step's), and the plan's metrics and
    parameters bitwise the plain step's."""
    for tag, (metrics, per_step, fg, _) in runs.items():
        print(f"  ({what}) {tag}: losses {[m['loss'] for m in metrics]}, grad_norm "
              f"{[m['grad_norm'] for m in metrics]}, ({', '.join(PLAN_KERNELS)}) "
              f"launches a step {per_step}, f/g calls {fg}", flush=True)
        expect = [want] * TP_DISTILL_STEPS if want else runs["plain"][1]
        if per_step != expect or not all(math.isfinite(m["loss"]) for m in metrics):
            fail(f"{what} {tag}: launches a step {per_step} (want {expect}) or "
                 "losses not finite")
    print(f"  ({what}) parameters after step {TP_DISTILL_STEPS}: largest difference "
          f"{diff!r}, bitwise {bitwise} (bound 0: at one rank the plan's "
          "collectives are the identity and its reductions the unsharded ones)",
          flush=True)
    if runs["plan"][0] != runs["plain"][0] or not bitwise:
        fail(f"{what}: the plan's metrics {runs['plan'][0]} vs {runs['plain'][0]}, "
             f"parameters {diff!r} apart: want them equal")


def tensor_parallel(dev, out_dir, card):
    """Phase 17: (a) the bitlinear kernel at the split's shard shapes, full
    width; on a one-rank NCCL group, (b) the distill step under a plan on
    the split route against the plain step.  -> ({path: launches}, a
    summary)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import ShardingPlan, default_rules
    from repro_torch.launch.mesh import make_mesh
    out, t0 = {}, time.perf_counter()

    def part(title):
        print(f"  {title} [+{time.perf_counter() - t0:.1f} s]", flush=True)

    part("17a: the bitlinear kernel at the split's shard shapes: "
         + "; ".join(f"{b[0]} at tp {', '.join(map(str, b[-1]))}" for b in TP_BLOCKS))
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out["17a"] = tp_kernel_shards(dev, scratch.zero_, card)
    del scratch
    part(f"17b: qwen3-0.6b (full width, {DIST_LAYERS} layers), {TP_DISTILL_STEPS} "
         f"distill steps at {TRAIN_BATCH} x {QWEN_SEQ}, both kernels, without and "
         "under a plan on mesh (data 1, model 1)")
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        plan = ShardingPlan(make_mesh(1, 1), default_rules(False))
        runs, diff, bitwise = _plan_runs(dev, plan, "qwen3-0.6b", DIST_LAYERS,
                                         "distill")
        _check_plan_runs("17b", runs, diff, bitwise,   # forward + remat; q, k, v
                         want=(2 * 7 * DIST_LAYERS, 3, 0))
        if min(runs["plan"][2]) <= 0:
            fail(f"17b: f/g calls {runs['plan'][2]} under the plan: the step did "
                 "not take the split route")
        out["17b"] = dict(runs=runs, param_diff=diff, bitwise=bitwise)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    part(f"phase 17 done ({card})")
    (out_dir / "smoke_tensor_parallel.json").write_text(
        json.dumps(out, indent=1, default=str))
    return {"distill qwen3-0.6b under a plan, split route (17b)":
            out["17b"]["runs"]["plan"][3]}, out


# -- phase 18: the split route for the MoE, SSM and hybrid families -----------------

# 18a: granite's MoE layer split by experts over this many emulated ranks
# (4 experts each), grok's (8 experts) by d_ff and mamba2-780m's block by
# heads over SPLIT_TP; 18b: ssd_scan on a rank's heads at SPLIT_TP: (label,
# b, S, H, P, N); 18c: the depths of the one-rank runs
MOE_SPLIT_RANKS, SPLIT_TP = 8, 16
SSD_SPLIT_SHAPES = (("mamba2-780m", TRAIN_BATCH, MAMBA_SEQ, 48, 64, 128),
                    ("jamba-1.5-large-398b", 2, MAMBA_SEQ, 128, 128, 128))
SPLIT_RUNS = ((GRANITE, 2, QWEN_SEQ), ("mamba2-780m", 4, MAMBA_SEQ))
GROK = "grok-1-314b"


def _emulated_rank(plan, rank, meet):
    """The port's ``tensor_parallel.Split`` at ``rank`` of ``plan``'s
    ``"model"`` axis, in one process: each collective over more than one
    rank is ``meet(kind, t)``, which returns the value the ranks reduce
    ``t`` to (kind ``("reduce", op)`` or ``("gather", dim)``)."""
    from repro_torch.distributed import tensor_parallel as tp

    class Rank(tp.Split):
        def __init__(self):
            super().__init__(plan)
            self.rank = rank
            self.coord = dict(self.coord, model=rank)

        def all_reduce(self, t, axis=tp.MODEL, op="sum"):
            if self.axis_size(axis) == 1:
                return t
            self._note("all-reduce", axis, t)
            return meet(("reduce", op), t)

        def all_gather(self, t, axis, dim):
            if self.axis_size(axis) == 1:
                return t
            out = meet(("gather", dim % t.dim()), t)
            self._note("all-gather", axis, out)
            return out

        def reduce_scatter(self, t, axis, dim, op="sum"):
            raise NotImplementedError("the emulated ranks run without gradients")

    return Rank()


def _lockstep(plan, ranks, rank_fn, keep=None):
    """``rank_fn(rank, split)`` on each of ``ranks`` emulated ranks of
    ``plan``'s ``"model"`` axis (``_emulated_rank``), in lockstep threads,
    without gradients: the ranks' collectives meet at a barrier and reduce
    there once, in rank order (sums in the operands' dtype, maxima, gathers
    joined), as the group reduces them.  One rank computes at a time (a
    baton passed at each collective), so the kernels' launches never
    interleave.  ``keep``, a list, gains each collective's reduced value in
    turn (for ``_replay``).  -> (each rank's result, the collectives one
    rank made)."""
    import threading
    import torch
    from repro_torch.distributed import tensor_parallel as tp

    baton = threading.Lock()
    slots, kinds, result, calls, errors = [None] * ranks, [None] * ranks, [None], [0], []

    def reduce():
        kind = kinds[0]
        if any(k != kind for k in kinds):
            raise RuntimeError(f"the emulated ranks reached different collectives: "
                               f"{kinds}")
        calls[0] += 1
        if kind[0] == "gather":
            result[0] = torch.cat(slots, dim=kind[1])
        else:
            out = slots[0]
            for t in slots[1:]:
                out = torch.maximum(out, t) if kind[1] == "max" else out + t
            result[0] = out / ranks if kind[1] == "avg" else out
        if keep is not None:
            keep.append(result[0])

    barrier = threading.Barrier(ranks, action=reduce)

    def meet_at(rank):
        def meet(kind, t):
            slots[rank], kinds[rank] = t.contiguous(), kind
            baton.release()
            try:
                barrier.wait(timeout=600)
                out = result[0]
            finally:
                baton.acquire()
            return out.clone()
        return meet

    local = threading.local()

    class Active:
        """The calling thread's rank (``tensor_parallel`` keeps one active
        split for the process)."""

        def __getattr__(self, name):
            return getattr(local.split, name)

    splits = [_emulated_rank(plan, r, meet_at(r)) for r in range(ranks)]
    outs = [None] * ranks

    def run(r):
        local.split = splits[r]
        with baton:
            try:
                with torch.no_grad():
                    outs[r] = rank_fn(r, splits[r])
            except BaseException as e:        # noqa: BLE001 (re-raised below)
                errors.append(e)
                barrier.abort()

    with tp.activated(Active()):
        threads = [threading.Thread(target=run, args=(r,)) for r in range(ranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return outs, calls[0]


def _replay(plan, rank, kept):
    """One emulated rank alone (``_emulated_rank``): its collectives return
    ``kept``, the values the ranks reduced to (``_lockstep(..., keep=)``),
    in turn and from the start again after the last, so that each forward
    of the rank takes them all once."""
    at = [0]

    def meet(kind, t):
        out = kept[at[0]]
        at[0] = (at[0] + 1) % len(kept)
        return out

    return _emulated_rank(plan, rank, meet)


def _rank_models(model, plan, ranks):
    """Each emulated rank's copy of ``model``: the module tree copied, its
    parameters and packed buffers cut to the rank's share under ``plan``
    (``tensor_parallel.shard_model``)."""
    import copy
    import itertools
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.nn.layers import Embedding
    keep = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    for m in model.modules():
        if isinstance(m, Embedding):
            keep[id(m._table_cd)] = m._table_cd
    out = []
    for r in range(ranks):
        local = copy.deepcopy(model, dict(keep))
        tp.shard_model(local, plan, coord={"data": 0, "model": r})
        out.append(local)
    return out


def _split_plan(ranks):
    from repro_torch.distributed.sharding import ShardingPlan, default_rules
    return ShardingPlan({"data": 1, "model": ranks}, default_rules(False))


def _split_check(what, layer, x, n, flush, card, bound_rel, call=lambda m, x: m(x)):
    """``layer`` (switched to the exact forms a split takes,
    ``models/lm.py::set_exact``) whole on ``x`` against ``n`` emulated ranks
    (``_lockstep``), each on its shard of ``layer`` under the ``n``-rank
    plan (``_rank_models``), taking its parameters' compute copies at use
    as a block does (``tensor_parallel.using``): each rank's output within
    ``bound_rel`` of the whole output's largest entry (bitwise printed);
    then the whole forward and one rank's (its collectives' results
    replayed, ``_replay``) timed.  -> a summary."""
    import torch
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import lm
    lm.set_exact(layer)
    with torch.no_grad():
        y = call(layer, x)
    plan = _split_plan(n)
    models = _rank_models(layer, plan, n)

    def rank_fn(r, split):
        split.register(models[r], local=True)
        with tp.using(models[r]):
            return call(models[r], x)

    kept = []
    outs, collectives = _lockstep(plan, n, rank_fn, keep=kept)
    bound = bound_rel * float(y.abs().max())
    err = max(float((o - y).abs().max()) for o in outs)
    bitwise = all(bool(torch.equal(o, y)) for o in outs)
    if not (all(bool(torch.isfinite(o).all()) for o in outs) and err <= bound):
        fail(f"18a {what}: {n} emulated ranks differ from the whole layer by "
             f"{err!r} (bound {bound!r})")

    def whole_forward():
        with torch.no_grad():
            call(layer, x)

    replay = _replay(plan, 0, kept)
    replay.register(models[0], local=True)

    def one_rank():
        with torch.no_grad(), tp.activated(replay), tp.using(models[0]):
            call(models[0], x)

    whole_ms = time_ms(whole_forward, iters=5, flush=flush)
    rank_ms = time_ms(one_rank, iters=5, flush=flush)
    print(f"  (a) {what}: x {list(x.shape)} over {n} ranks, {collectives} collectives "
          f"a rank: largest difference {err!r} (bound {bound:.3g}), bitwise {bitwise}; "
          f"forward ms ({card}): whole {whole_ms:.4f}, one rank {rank_ms:.4f}",
          flush=True)
    return dict(ranks=n, collectives=collectives, max_abs_err=err, bound=bound,
                bitwise=bitwise, whole_ms=whole_ms, rank_ms=rank_ms)


def moe_split_layer(dev, flush, card):
    """18a: the split route's layers at full width in fp32, each whole and
    on each of its emulated ranks (``_split_check``): granite-moe-1b-a400m's
    MoE layer (32 experts of d_ff 512, top 8, SubLN, QAT) over
    ``MOE_SPLIT_RANKS`` ranks of 4 experts (the replicated router, the
    rank's slice of the dispatch, its experts, its partial combine in
    float64: bound 1e-6); grok-1-314b's (8 experts of d_ff 32768, top 2)
    over ``SPLIT_TP`` ranks by d_ff, the fallback where the experts do not
    divide (each expert's Δ and SubLN over the shards; its ``down``
    outputs fp32 partial sums over 2048 of the 32768 rows, summed in
    float64: bound an fp32 ulp's random walk over the 32768 rows,
    2^-23·sqrt(32768) = 2.2e-5); mamba2-780m's Mamba2Block on the kernel route
    over ``SPLIT_TP`` ranks of 3 heads (in_proj and the conv gathered whole
    at use, in_proj's columns picked by ``BitLinear.forward_cols`` with the
    whole weight's Δ, the conv's channels, ssd_scan on the heads, SubLN
    over the shards, out_proj row-parallel through
    ``bitlinear_forward_acc``: bound 1e-6).  -> {label: summary}."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.models import get_config
    from repro_torch.nn.module import DTypePolicy
    from repro_torch.nn.moe import MoEMLP
    from repro_torch.nn.ssm import Mamba2Block
    f32 = DTypePolicy(torch.float32, torch.float32)
    out = {}

    def moe(name, seed):
        cfg = get_config(name)
        return cfg, MoEMLP(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                           cfg.activation, capacity_factor=cfg.capacity_factor,
                           group_size=cfg.moe_group_size, subln=True, quant=Q.QAT,
                           policy=f32, gen=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)

    def tokens(shape, seed):
        return torch.randn(shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))

    call = lambda m, x: m(x)[0]            # noqa: E731
    cfg, layer = moe(GRANITE, 18)
    x = tokens((TRAIN_BATCH, QWEN_SEQ, cfg.d_model), 19)
    n, per = MOE_SPLIT_RANKS, cfg.n_experts // MOE_SPLIT_RANKS
    out[GRANITE] = _split_check(f"{GRANITE} MoE layer, {per} experts a rank", layer,
                                x, n, flush, card, 1e-6, call=call)
    del layer, x
    torch.cuda.empty_cache()

    cfg, layer = moe(GROK, 20)
    x = tokens((2, QWEN_SEQ, cfg.d_model), 21)
    n, f = SPLIT_TP, cfg.d_ff // SPLIT_TP
    out[GROK] = _split_check(
        f"{GROK} MoE layer, d_ff {f} of {cfg.d_ff} a rank ({cfg.n_experts} experts)",
        layer, x, n, flush, card, 2.0 ** -23 * cfg.d_ff ** 0.5, call=call)
    del layer, x
    torch.cuda.empty_cache()

    cfg = get_config("mamba2-780m")
    gen = torch.Generator(device=dev).manual_seed(22)
    blk = Mamba2Block(cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                      chunk=cfg.ssm_chunk, policy=f32, gen=gen,
                      quant=Q.QuantConfig(mode="qat", use_kernel=True),
                      device=dev)
    with torch.no_grad():
        blk.D.uniform_(0.5, 1.5, generator=gen)
        blk.conv_b.uniform_(-0.1, 0.1, generator=gen)
        blk.norm.scale.uniform_(0.8, 1.2, generator=gen)
    x = tokens((TRAIN_BATCH, MAMBA_SEQ, cfg.d_model), 23)
    n = SPLIT_TP
    out["mamba2-780m"] = _split_check(
        f"mamba2-780m Mamba2Block, {blk.n_heads // n} of {blk.n_heads} heads a rank",
        blk, x, n, flush, card, 1e-6)
    del blk, x
    torch.cuda.empty_cache()
    return out


def ssd_split_heads(dev, flush, card):
    """18b: the ssd_scan kernel on a rank's heads at tp ``SPLIT_TP``
    (mamba2-780m: 3 of 48 heads of 64; jamba's block: 8 of 128 heads of
    128; N = 128, fp32, inputs as ``_ssd_scan_shape`` makes them), for the
    first and the last rank: y and the final state against the whole
    launch's slice of those heads and against ``ssd_chunked`` on them
    (phase 2's tolerance 1e-4 + 1e-4·|y|; bitwise against the whole launch
    printed), then the whole launch and one rank's, timed.  -> a
    summary."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    out = {}
    for label, b, s_, h, p, n in SSD_SPLIT_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(18)
        r = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
        A = -(1.0 + 7.0 * torch.rand((h,), generator=gen, device=dev))
        dt = torch.nn.functional.softplus(r(b, s_, h) - 2.0)
        x, a, B, C = r(b, s_, h, p), torch.exp(dt * A), r(b, s_, n), r(b, s_, n)
        y, hT = ssd_scan_kernel(x, a, dt, B, C, 256)
        hT = hT.reshape(b, h, n, p)
        per = h // SPLIT_TP
        worst, bitwise = 0.0, True
        for rank in (0, SPLIT_TP - 1):
            sl = slice(rank * per, (rank + 1) * per)
            ins = (x[:, :, sl].contiguous(), a[:, :, sl].contiguous(),
                   dt[:, :, sl].contiguous(), B, C)
            yr, hr = ssd_scan_kernel(*ins, 256)
            hr = hr.reshape(b, per, n, p)
            yc, hc = ssd_chunked(*ins, chunk=256)
            hc = hc.transpose(-1, -2)
            for what, got, want in (("y vs the whole launch", yr, y[:, :, sl]),
                                    ("h vs the whole launch", hr, hT[:, sl]),
                                    ("y vs ssd_chunked", yr, yc),
                                    ("h vs ssd_chunked", hr, hc)):
                e = (got - want).abs()
                if not (bool(torch.isfinite(got).all())
                        and bool((e <= 1e-4 + 1e-4 * want.abs()).all())):
                    fail(f"18b {label} tp {SPLIT_TP} rank {rank} {what}: max err "
                         f"{float(e.max())!r}")
                worst = max(worst, float(e.max()))
            bitwise &= bool(torch.equal(yr, y[:, :, sl]) and torch.equal(hr, hT[:, sl]))
        ins0 = (x[:, :, :per].contiguous(), a[:, :, :per].contiguous(),
                dt[:, :, :per].contiguous(), B, C)
        whole_ms = both_ms(lambda: ssd_scan_kernel(x, a, dt, B, C, 256), flush)
        rank_ms = both_ms(lambda: ssd_scan_kernel(*ins0, 256), flush)
        bd, by = bound_ms("ssd_scan", *ins0, 256)
        print(f"  (b) ssd_scan {label} b={b} S={s_} P={p} N={n}: a rank's {per} of {h} "
              f"heads (BH {b * per} of {b * h}) vs the whole launch's slice and "
              f"ssd_chunked: max err {worst:.3g}, bitwise the whole launch {bitwise}; "
              f"ms ({card}) whole {whole_ms[0]:.4f} (device alone {whole_ms[1]:.4f}), "
              f"one rank {rank_ms[0]:.4f} ({rank_ms[1]:.4f}; bound {bd:.5f} by {by})",
              flush=True)
        out[label] = dict(heads=per, of=h, bh=b * per, max_abs_err=worst,
                          bitwise=bitwise, whole_ms=whole_ms, rank_ms=rank_ms,
                          rank_bound_ms=bd, rank_bound_by=by)
        del x, a, dt, B, C, y, hT
        torch.cuda.empty_cache()
    return out


def split_families(dev, out_dir, card):
    """Phase 18: (a) granite's and grok's MoE layers and mamba2's block
    split over emulated ranks and (b) ssd_scan on a rank's heads, all full
    width; on a one-rank NCCL group,
    (c) granite-moe-1b-a400m (2 layers) and mamba2-780m (4 layers) at full
    width, ``TP_DISTILL_STEPS`` CE and distill steps under the (1, 1) plan
    on the split route, each bitwise the plain step, with its launches a
    step.  -> ({path: launches}, a summary)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import ShardingPlan, default_rules
    from repro_torch.launch.mesh import make_mesh
    out, t0 = {}, time.perf_counter()

    def part(title):
        print(f"  {title} [+{time.perf_counter() - t0:.1f} s]", flush=True)

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    part(f"18a: {GRANITE}'s and {GROK}'s MoE layers and mamba2-780m's block over "
         "emulated ranks")
    out["18a"] = moe_split_layer(dev, scratch.zero_, card)
    part(f"18b: ssd_scan on a rank's heads at tp {SPLIT_TP}")
    out["18b"] = ssd_split_heads(dev, scratch.zero_, card)
    del scratch
    # per step (bitlinear, relation_kd, ssd_scan): the student's projections
    # (granite's q, k, v, o; mamba2's in_proj and out_proj) and SSDs, each
    # forward recomputed once under remat; relation_kd's q, k, v; the FP
    # teacher's SSDs (no remat without a gradient)
    want = {(GRANITE, "ce"): (2 * 4 * 2, 0, 0), (GRANITE, "distill"): (2 * 4 * 2, 3, 0),
            ("mamba2-780m", "ce"): (2 * 2 * 4, 0, 2 * 4),
            ("mamba2-780m", "distill"): (2 * 2 * 4, 0, 3 * 4)}
    paths = {}
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        plan = ShardingPlan(make_mesh(1, 1), default_rules(False))
        for name, layers, seq in SPLIT_RUNS:
            for kind in ("ce", "distill"):
                part(f"18c: {name} (full width, {layers} layers), {TP_DISTILL_STEPS} "
                     f"{kind} steps at {TRAIN_BATCH} x {seq}, the kernels on, without "
                     "and under the (1, 1) plan: the split route")
                runs, diff, bitwise = _plan_runs(dev, plan, name, layers, kind, seq)
                _check_plan_runs(f"18c {name} {kind}", runs, diff, bitwise,
                                 want=want[name, kind])
                if min(runs["plan"][2]) <= 0:
                    fail(f"18c {name} {kind}: f/g calls {runs['plan'][2]} under the "
                         "plan: the step did not take the split route")
                out[f"18c {name} {kind}"] = dict(runs=runs, param_diff=diff,
                                                 bitwise=bitwise)
                paths[f"{kind} {name} under a plan, split route (18c)"] = \
                    runs["plan"][3]
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    part(f"phase 18 done ({card})")
    (out_dir / "smoke_split_families.json").write_text(
        json.dumps(out, indent=1, default=str))
    return paths, out


# -- phase 19: the split route for the cross families, prefill and decode -----------

# 19a: full-width blocks over SPLIT_TP emulated ranks: (label, config, mixer,
# rows x positions of x, positions of the memory or 0); 19b: qwen3-0.6b's
# row-parallel projections (label, K, N) at SPLIT_TP and the rows of a
# decode pass and of a chunk step; 19c: the decode step's rows, each at its
# own depth, against a cache of DECODE_MAX_LEN seeded positions
SPLIT_BLOCKS = (("whisper-medium encoder block", WHISPER, "encoder", (2, 1500), 0),
                ("whisper-medium decoder attn_cross block", WHISPER, "attn_cross",
                 (2, 256), 1500),
                ("llama-3.2-vision-11b cross block", VISION, "cross", (2, 256), 1601))
ACC_SHAPES = (("o_proj", 2048, 1024), ("down_proj", 3072, 1024))
ACC_ROWS = (8, 256)
DECODE_DEPTHS = (100, 257, 700, 1500)
DECODE_MAX_LEN = 2048
# 19d: whisper-medium's depth (its encoder's and its decoder's layers)
CROSS_LAYERS = 2
# 19c's bound on the logits, relative to the whole step's largest: over 16
# ranks every reduction of the decode takes its exact form (the packed
# products' integer sums, SubLN's and the attention's float64 sums, each
# rounded once), as the whole step does under ``set_exact``; what remains
# is the tied head's fp32 product over the rank's vocabulary columns
# against the whole table's (another matmul shape, ~1e-7 relative) and a
# float64 sum rounding the other way at an fp32 boundary (~1e-6 of an
# element's chance), which could round one int8 code of a later layer apart
DECODE_BOUND_REL = 1e-5


def cross_split_blocks(dev, flush, card):
    """19a: whisper-medium's encoder block and decoder ``attn_cross`` block
    and llama-3.2-vision-11b's ``cross`` block at full width, QAT on the
    bitlinear kernel route, fp32, each whole (in the split's exact forms,
    ``models/lm.py::set_exact``) and over ``SPLIT_TP`` emulated ranks
    (``_lockstep``): q column-parallel by heads, K/V from the memory by kv
    heads (whisper's 16 divide over 16 ranks; llama-vision's 8 do not, so
    each rank projects them whole), ``wo`` row-parallel through
    ``bitlinear_forward_acc``, the MLP split by d_ff.  Each rank's output
    within 1e-6 of the whole block's largest entry (bitwise printed).  ->
    {label: summary}."""
    import dataclasses
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.models import get_config, lm
    from repro_torch.nn.transformer import Block, LayerSpec
    plan, n = _split_plan(SPLIT_TP), SPLIT_TP
    out = {}
    for label, name, mixer, (b, s_), t in SPLIT_BLOCKS:
        cfg = get_config(name).with_quant(Q.QuantConfig(mode="qat", use_kernel=True))
        cfg = cfg.replace(compute_dtype="float32")
        bc = cfg.block_config()
        spec = LayerSpec("attn" if mixer == "encoder" else mixer, "dense")
        if mixer == "encoder":
            bc = dataclasses.replace(bc, causal=False)
        gen = torch.Generator(device=dev).manual_seed(19)
        blk = Block(bc, spec, gen=gen, device=dev)
        with torch.no_grad():
            for m in blk.modules():
                if hasattr(m, "scale") and isinstance(m.scale, torch.nn.Parameter):
                    m.scale.uniform_(0.8, 1.2, generator=gen)
        lm.set_exact(blk)
        x = torch.randn((b, s_, cfg.d_model), generator=gen, device=dev)
        mem = (torch.randn((b, t, cfg.d_model), generator=gen, device=dev)
               if t else None)

        def call(m):
            return m(x, None, mem)[0]

        with torch.no_grad():
            y = call(blk)
        models = _rank_models(blk, plan, n)

        def rank_fn(r, split):
            split.register(models[r], local=True)
            return call(models[r])

        t0 = time.perf_counter()
        outs, collectives = _lockstep(plan, n, rank_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bound = 1e-6 * float(y.abs().max())
        err = max(float((o - y).abs().max()) for o in outs)
        bitwise = all(bool(torch.equal(o, y)) for o in outs)
        if not (all(bool(torch.isfinite(o).all()) for o in outs) and err <= bound):
            fail(f"19a {label}: {n} emulated ranks differ from the whole block by "
                 f"{err!r} (bound {bound!r})")
        with torch.no_grad():
            whole_ms = time_ms(lambda: call(blk), iters=5, flush=flush)
        print(f"  (a) {label}: x {list(x.shape)}"
              f"{f', memory {list(mem.shape)}' if mem is not None else ''} over {n} "
              f"ranks, {collectives} collectives a rank: largest difference {err!r} "
              f"(bound {bound:.3g}), bitwise {bitwise}; whole forward {whole_ms:.4f} "
              f"ms ({card}); the {n} ranks in lockstep {wall:.2f} s of host time",
              flush=True)
        out[label] = dict(ranks=n, collectives=collectives, max_abs_err=err,
                          bound=bound, bitwise=bitwise, whole_ms=whole_ms,
                          lockstep_s=wall)
        del blk, models, outs, x, mem
        torch.cuda.empty_cache()
    return out


def w2a8_row_shards(dev, flush, card, results):
    """19b: ``w2a8_forward_acc`` on qwen3-0.6b's row-parallel projections
    (o_proj K 2048, down_proj K 3072; N 1024) at tp ``SPLIT_TP``, M = 8 and
    256, bf16 and fp32, on every rank's shard: each rank's accumulators
    equal the plain version's exactly, and the ranks' sum (in rank order)
    scaled once by (γ/127)·Δ equals the whole ``w2a8_kernel`` launch bit for
    bit.  Each shard's time (as a caller sees it and device alone) beside
    the whole launch's, the plain version's, ``torch._int_mm``'s on the
    shard's codes and the bound.  -> summary (the kernel's row in
    ``results``)."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.w2a8_gemv import kernel as wk
    from repro_torch.kernels.w2a8_gemv.ref import w2a8_forward_acc_ref
    rows = []
    n_ranks = SPLIT_TP
    for label, k, n in ACC_SHAPES:
        kk = k // n_ranks
        for m in ACC_ROWS:
            gen = torch.Generator(device=dev).manual_seed(k + m)
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            q, delta = Q.weight_quant_absmean(w)
            wp = Q.pack_ternary(q.to(torch.int8))
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((m, k), generator=gen, device=dev).to(dt)
                gamma = x.float().abs().amax(dim=-1, keepdim=True)
                shards = [(x[:, r * kk:(r + 1) * kk].contiguous(),
                           wp[r * kk // 4:(r + 1) * kk // 4]) for r in range(n_ranks)]
                total = None
                for r, (xs, ws) in enumerate(shards):
                    acc = wk.w2a8_forward_acc(xs, ws, gamma)
                    if not torch.equal(acc, w2a8_forward_acc_ref(xs, ws, gamma)):
                        fail(f"19b {label} M={m} {dt} rank {r}: the accumulators "
                             "differ from the plain version's")
                    total = acc if total is None else total + acc
                y = (total * (Q.div(gamma, 127.0) * delta)).to(dt)
                if not torch.equal(y, wk.w2a8_kernel(x, wp, delta)):
                    fail(f"19b {label} M={m} {dt}: the ranks' scaled sum differs "
                         "from the whole launch")
            xs, ws = shards[0]
            shard = both_ms(lambda: wk.w2a8_forward_acc(xs, ws, gamma), flush)
            whole = both_ms(lambda: wk.w2a8_kernel(x, wp, delta), flush)
            plain = both_ms(lambda: w2a8_forward_acc_ref(xs, ws, gamma), flush)
            codes = Q.round_clip(xs.float() * Q.div(127.0, gamma + 1e-5), -128.0,
                                 127.0).to(torch.int8)
            lib, why = _int_mm_ms(codes, Q.unpack_ternary(ws, kk), 1.0,
                                  torch.float32, flush)
            bd, by = bound_ms("w2a8_forward_acc", xs, ws, gamma)
            row = dict(proj=label, m=m, k=k, k_shard=kk, n=n, ms=shard[0],
                       device_ms=shard[1], whole_ms=whole[0], whole_device_ms=whole[1],
                       plain_ms=plain[0], plain_device_ms=plain[1],
                       library_ms=lib[0], library_device_ms=lib[1], library_why=why,
                       bound_ms=bd, bound_by=by)
            rows.append(row)
            print(f"  (b) w2a8_forward_acc {label} M={m} K {kk} of {k} N={n} fp32 x: "
                  f"{n_ranks} shards exact, their scaled sum bitwise the whole launch "
                  f"(bf16 and fp32); ms ({card}) a shard {shard[0]:.4f} (device alone "
                  f"{shard[1]:.4f}), whole launch {whole[0]:.4f} ({whole[1]:.4f}), "
                  f"plain {plain[0]:.4f} ({plain[1]:.4f}), _int_mm {_fmt(lib[0])} "
                  f"({_fmt(lib[1])}), bound {bd:.5f} by {by}", flush=True)
    head = rows[0]                       # o_proj's shard at the decode rows
    results["w2a8_forward_acc"] = dict(
        name="w2a8_forward_acc", route="cuda", source="src/repro_torch/csrc/w2a8_gemv.cu",
        replaces="src/repro/kernels/w2a8_gemv/kernel.py:58", max_abs_err=0.0,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        device_ms=head["device_ms"],
        shape=f"M=8 K={head['k_shard']} of {head['k']} N={head['n']} fp32 (o_proj, tp "
              f"{SPLIT_TP})", rows=rows)
    return rows


def _top2_gap(logits):
    top = logits.float().topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def split_decode(dev, flush, card):
    """19c: a packed decode step at full width in fp32 over ``SPLIT_TP``
    emulated ranks against the whole ``decode_step`` on the same cache:
    qwen3-0.6b (28 layers, 8 kv heads: the cache split by positions, the
    ranks' attention merged by log-sum-exp) and one layer of qwen1.5-0.5b
    (16 kv heads: split by heads).  Rows at depths ``DECODE_DEPTHS`` of a
    cache of seeded K/V; each rank's share of it cut from the whole
    (``Split.local_of``); the whole step in the exact forms the split takes
    (``models/lm.py::set_exact``).  Logits within ``DECODE_BOUND_REL`` of
    the whole step's largest, the greedy token equal wherever the whole
    step's top-2 gap is more than twice the difference (a tie otherwise,
    printed).  The
    packed kernels' counters are reset just before the ranks' run and read
    after: every projection of every rank a launch, ``w2a8_forward_acc``
    for ``wo`` and ``down``.  -> ({path: launches}, summary)."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.w2a8_gemv import kernel as wk
    from repro_torch.models import build_model, get_config, lm
    plan, n = _split_plan(SPLIT_TP), SPLIT_TP
    paths, out = {}, {}
    for name, layers, placement in (("qwen3-0.6b", None, "positions"),
                                    ("qwen1.5-0.5b", 1, "heads")):
        cfg = get_config(name).with_quant(Q.QuantConfig(mode="packed", use_kernel=True))
        cfg = cfg.replace(compute_dtype="float32", vocab_pad_multiple=512)
        if layers:
            cfg = cfg.replace(n_layers=layers)
        gen = torch.Generator(device=dev).manual_seed(19)
        model = build_model(cfg, gen=gen, device=dev)
        rows = len(DECODE_DEPTHS)
        idx = torch.tensor(DECODE_DEPTHS, dtype=torch.int32, device=dev)
        tok = torch.randint(0, cfg.vocab, (rows,), generator=gen, device=dev)
        whole = model.init_cache(rows, DECODE_MAX_LEN, torch.float32, dev)
        for layer in whole:
            for t in layer["attn"].values():
                t.normal_(generator=gen)
        keep = [{k: t.clone() for k, t in layer["attn"].items()} for layer in whole]
        lm.set_exact(model)
        with torch.no_grad():
            want, _ = model.decode_step(tok, whole, idx)
        models = _rank_models(model, plan, n)

        def rank_fn(r, split):
            split.register(models[r], local=True)
            cache = models[r].init_cache(rows, DECODE_MAX_LEN, torch.float32, dev)
            for layer, src in zip(cache, keep):
                for k, t in layer["attn"].items():
                    t.copy_(split.local_of(src[k], split.cache_spec(t), t._tp_whole))
            if r == 0:
                out.setdefault(name, {})["cache"] = list(cache[0]["attn"]["k"].shape)
            logits = models[r].decode_step(tok, cache, idx)[0]
            if logits.shape != (rows, cfg.padded_vocab):
                raise ValueError(f"rank {r}: logits {tuple(logits.shape)}, not the "
                                 f"whole vocabulary's ({rows}, {cfg.padded_vocab})")
            return logits

        wk.launches.reset()
        wk.acc_launches.reset()
        t0 = time.perf_counter()
        outs, collectives = _lockstep(plan, n, rank_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"w2a8_gemv": wk.launches.count,
                  "w2a8_forward_acc": wk.acc_launches.count}
        want_counts = {"w2a8_gemv": n * cfg.n_layers * 5,
                       "w2a8_forward_acc": n * cfg.n_layers * 2}
        if counts != want_counts:
            fail(f"19c {name}: launches {counts}, want {want_counts} (q, k, v, gate, "
                 "up on column shards; wo, down on row shards; every rank)")
        # the vocabulary's columns (the pad's are -1e30 on both sides)
        want = want[:, :cfg.vocab]
        outs = [o[:, :cfg.vocab] for o in outs]
        bound = DECODE_BOUND_REL * float(want.abs().max())
        err = max(float((o - want).abs().max()) for o in outs)
        gap = _top2_gap(want)
        ties = [b for b in range(rows) if float(gap[b]) <= 2 * err]
        wrong = [(r, b) for r, o in enumerate(outs) for b in range(rows)
                 if b not in ties and int(o[b].argmax()) != int(want[b].argmax())]
        if not all(bool(torch.isfinite(o).all()) for o in outs) or err > bound \
                or wrong:
            fail(f"19c {name}: logits {err!r} from the whole step (bound {bound!r}), "
                 f"greedy tokens differ at (rank, row) {wrong[:8]}")
        with torch.no_grad():
            step_ms = time_ms(lambda: model.decode_step(tok, whole, idx), iters=5,
                              flush=flush)
        print(f"  (c) {name} packed{f', {layers} layer' if layers else ''}, fp32, "
              f"{rows} rows at depths {list(DECODE_DEPTHS)} of {DECODE_MAX_LEN}: the "
              f"cache split by {placement} (a rank's k {out[name]['cache']}), {n} "
              f"ranks, {collectives} collectives a rank; logits {err!r} from the "
              f"whole step (bound {bound:.3g}), greedy tokens equal (ties "
              f"{ties}: top-2 gaps {[round(float(g), 6) for g in gap]}); launches "
              f"{counts}; whole step {step_ms:.4f} ms ({card}), the ranks in lockstep "
              f"{wall:.2f} s of host time", flush=True)
        out[name].update(ranks=n, placement=placement, collectives=collectives,
                         max_abs_err=err, bound=bound, ties=ties,
                         gaps=[float(g) for g in gap], launches=counts,
                         step_ms=step_ms, lockstep_s=wall)
        paths[f"decode {name} packed over {n} emulated ranks, cache split by "
              f"{placement} (19c)"] = counts
        del model, models, outs, whole, keep
        torch.cuda.empty_cache()
    return paths, out


def cross_split(dev, out_dir, card, results):
    """Phase 19: the split route for the cross-attention families and for
    prefill and decode.  (a) whisper-medium's and llama-3.2-vision-11b's
    blocks over emulated ranks, (b) ``w2a8_forward_acc`` on qwen3-0.6b's row
    shards, (c) a packed decode step over emulated ranks on both cache
    placements, all full width; on a one-rank NCCL group, (d) whisper-medium
    at two encoder and two decoder layers, CE and distill steps under the
    (1, 1) plan on the split route, each bitwise the plain step.  -> ({path:
    launches}, a summary); ``results`` gains ``w2a8_forward_acc``'s row."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import ShardingPlan, default_rules
    from repro_torch.launch.mesh import make_mesh
    out, paths, t0 = {}, {}, time.perf_counter()

    def part(title):
        print(f"  {title} [+{time.perf_counter() - t0:.1f} s]", flush=True)

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    part(f"19a: the cross families' blocks over {SPLIT_TP} emulated ranks")
    out["19a"] = cross_split_blocks(dev, scratch.zero_, card)
    part(f"19b: w2a8_forward_acc on qwen3-0.6b's row shards at tp {SPLIT_TP}")
    out["19b"] = w2a8_row_shards(dev, scratch.zero_, card, results)
    part(f"19c: a packed decode step over {SPLIT_TP} emulated ranks")
    paths19c, out["19c"] = split_decode(dev, scratch.zero_, card)
    paths.update(paths19c)
    del scratch
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        plan = ShardingPlan(make_mesh(1, 1), default_rules(False))
        for kind in ("ce", "distill"):
            part(f"19d: {WHISPER} (full width, {CROSS_LAYERS} encoder and "
                 f"{CROSS_LAYERS} decoder layers), {TP_DISTILL_STEPS} {kind} "
                 f"steps at {CROSS_TRAIN_BATCH} x {QWEN_SEQ}, both kernels, without "
                 "and under the (1, 1) plan: the split route")
            runs, diff, bitwise = _plan_runs(dev, plan, WHISPER, CROSS_LAYERS, kind)
            _check_plan_runs(f"19d {kind}", runs, diff, bitwise)
            if min(runs["plan"][2]) <= 0 or runs["plan"][3]["bitlinear"] <= 0 \
                    or (kind == "distill") != (runs["plan"][3]["relation_kd"] > 0):
                fail(f"19d {kind}: f/g calls {runs['plan'][2]} (the split route "
                     f"makes them), launches {runs['plan'][3]}")
            out[f"19d {kind}"] = dict(runs=runs, param_diff=diff, bitwise=bitwise)
            paths[f"{kind} {WHISPER} under a plan, split route (19d)"] = \
                runs["plan"][3]
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    part(f"phase 19 done ({card})")
    (out_dir / "smoke_cross_split.json").write_text(
        json.dumps(out, indent=1, default=str))
    return paths, out


def kernels_of(root: Path) -> None:
    """``python3 chip_smoke.py --kernels-of DIR``: phase 2's w2a8, paged,
    bitlinear, relation_kd and ssd_scan checks and timings against the package of the
    checkout at DIR (e.g. an older commit unpacked from ``git archive``, so
    that two versions are timed in one call on one card), then their
    numbers as one JSON line.  Prints no result line: it is not the smoke
    test."""
    import torch
    card = card_info()
    print(f"card: {card}", flush=True)
    from repro_torch.kernels import build
    info = build.build()
    print(f"build: {info.seconds:.1f} s -> {info.path}", flush=True)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    dev = torch.device("cuda")
    for check in (check_w2a8, check_paged_decode, check_paged_prefill,
                  check_bitlinear, check_relation_kd, check_ssd_scan):
        check(dev, scratch.zero_, results)
    print(json.dumps({"kernels_of": str(root), "card": card,
                      "kernels": results}), flush=True)


def serving_of(root: Path) -> None:
    """``python3 chip_smoke.py --serving-of DIR``: phase 3 alone (the
    engine's run, its counters and its profile) with the package of the
    checkout at DIR, then its summary as one JSON line: two versions served
    in turns in one call.  Prints no result line."""
    import torch
    card = card_info()
    print(f"card: {card}", flush=True)
    out_dir = ROOT / "smoke_out" / "serving_of"
    out_dir.mkdir(parents=True, exist_ok=True)
    launches = serve_full_width(torch.device("cuda"), out_dir)
    summary = json.loads((out_dir / "smoke_engine.json").read_text())
    print(json.dumps({"serving_of": str(root), "card": card, "launches": launches,
                      "summary": summary}), flush=True)


# phases --phases may name (1, the card and the build, always runs), and
# what each needs run before it: 10b runs at the end of phase 5, and the
# kernels line reads phase 2's checks
PHASES = tuple(range(2, 20))
NEEDS = {10: (5,)}


def selected_phases(spec: str):
    """``--phases 2,17`` -> the phases to run, with their prerequisites."""
    try:
        want = {int(p) for p in spec.split(",") if p.strip()}
    except ValueError:
        want = set()
    if not want or not want <= set(PHASES):
        fail(f"--phases {spec!r}: give phase numbers from {PHASES[0]} to "
             f"{PHASES[-1]}, comma-separated")
    for p in sorted(want):
        want.update(NEEDS.get(p, ()))
    return want | {2}


def main() -> None:
    args = sys.argv[1:]
    root = ROOT
    modes = {"--kernels-of": kernels_of, "--serving-of": serving_of}
    only = None
    if args[:1] == ["--phases"] and len(args) == 2:
        only = selected_phases(args[1])
        args = []
    if args:
        if len(args) != 2 or args[0] not in modes:
            fail(f"unknown arguments {args}: run with none, with --phases LIST, "
                 "or with --kernels-of DIR or --serving-of DIR")
        root = Path(args[1]).resolve()
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a card")
    if args:
        return modes[args[0]](root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def phase(title):
        # each phase's heading with the seconds since the start, so that a
        # run's log shows what each phase costs of the time limit
        print(f"{title} [at {time.perf_counter() - t_start:.1f} s]", flush=True)

    def run(n):
        return only is None or n in only

    if only is not None:
        print(f"phases: 1, {', '.join(map(str, sorted(only)))} (--phases)", flush=True)

    # 1. card and build
    card = card_info()
    print(f"card: {card}", flush=True)
    from repro_torch.kernels import build
    info = build.build()
    print(f"build: {info.seconds:.1f} s -> {info.path}", flush=True)
    out_dir = ROOT / "smoke_out"
    out_dir.mkdir(exist_ok=True)
    from repro_torch.kernels.bitlinear.kernel import gemm_info
    from repro_torch.kernels.w2a8_gemv.kernel import gemm_info as w2a8_info
    gemm_line = (f"bitlinear GEMM: {gemm_info()}; w2a8: {w2a8_info()} (smem_bytes: "
                 "dynamic shared memory per CTA); ptxas: " + "; ".join(
                     f"{fn}: {use}" for fn, use in _kernel_ptxas(info.log)))
    paged_line = ("paged kernels at head_dim 256 (gemma-7b), ptxas: " + "; ".join(
        f"{fn}: {use}" for fn, use in _kernel_ptxas(info.log, _paged_instance)))
    (out_dir / "ptxas.txt").write_text(info.log + gemm_line + "\n" + paged_line + "\n")
    print(gemm_line, flush=True)
    print(paged_line, flush=True)
    sass = kernel_sass(info.path, out_dir)
    print(f"tensor-core SASS: {sass['counts']}; e.g. " + "; ".join(
        sass["examples"].values()), flush=True)

    # 2. kernels against their plain versions
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    results = {}
    phase("phase 2: kernels vs plain versions")
    check_w2a8(dev, flush, results)
    check_paged_decode(dev, flush, results)
    check_paged_prefill(dev, flush, results)
    check_bitlinear(dev, flush, results)
    check_relation_kd(dev, flush, results)
    check_ssd_scan(dev, flush, results)
    del scratch
    # 3. the main path, launch counters reset just before it
    by_path = {}
    if run(3):
        phase("phase 3: engine, qwen3-0.6b full width")
        by_path["serve qwen3-0.6b"] = serve_full_width(dev, out_dir)
    # 4. kernels vs plain paths through the engine
    if run(4):
        phase("phase 4: on-card parity, kernel vs plain paths")
        kernel_vs_plain_parity(dev, out_dir)
    # 5. the training path, its launch counters reset just before it
    if run(5):
        phase("phase 5: BitDistill training, qwen3-0.6b full width")
        per_fwd = 7 * 28                       # BitLinear projections, 28 layers
        # 10b runs last in this phase: a checkpoint round trip of the student,
        # its two distill steps counted on their own
        round_trip = {}
        by_path["train qwen3-0.6b"] = train_full_width(
            dev, out_dir, "qwen3-0.6b", 28, QWEN_SEQ,
            {"train": {"bitlinear": 2 * per_fwd, "relation_kd": 0},
             "distill": {"bitlinear": 2 * per_fwd, "relation_kd": 3}}, "train",
            after=lambda ctx: round_trip.setdefault(
                "10b", checkpoint_round_trip(ctx, out_dir)))
        by_path["checkpoint round trip qwen3-0.6b (10b)"] = round_trip["10b"][0]
    # 6. kernels vs plain paths through the distillation step
    if run(6):
        phase("phase 6: on-card parity, distill step kernel vs plain paths")
        train_kernel_vs_plain_parity(dev)
    # 7. the mamba2-780m training path, its counters reset just before it:
    # the student's in_proj + out_proj per layer and one SSD per layer, each
    # forward recomputed once under remat; the FP teacher adds 48 SSDs
    if run(7):
        phase("phase 7: BitDistill training, mamba2-780m full width")
        by_path["train mamba2-780m"] = train_full_width(
            dev, out_dir, "mamba2-780m", 48, MAMBA_SEQ,
            {"train": {"bitlinear": 2 * 2 * 48, "ssd_scan": 2 * 48},
             "distill": {"bitlinear": 2 * 2 * 48, "ssd_scan": 3 * 48}}, "train_mamba")
    # 8. the SSD kernel vs the sequential oracle through a full-width block
    if run(8):
        phase("phase 8: on-card parity, Mamba2Block kernel vs sequential")
        mamba_block_parity(dev)
    # 9. serving through the entry point, the serving kernels' counters reset
    # just before the in-process run through the front end and async loop
    if run(9):
        phase("phase 9: serving through the entry point, qwen3-0.6b full width")
        (by_path["serve entry point qwen3-0.6b"],
         by_path["serve async stack qwen3-0.6b"]) = serve_entry_point(dev, out_dir)
    # 10. the training launcher with checkpoints (a), the remat policies (c)
    # and the Table-4 schemes (d); 10b ran at the end of phase 5
    if run(10):
        phase("phase 10a: the training launcher at full width: checkpoint, SIGTERM, "
              "resume")
        phase10 = {"10a": launcher_checkpoints(dev, out_dir),
                   "10b": round_trip["10b"][1]}
        phase("phase 10c: remat policies nothing / dots / none, qwen3-0.6b full width")
        by_path["remat policies qwen3-0.6b (10c)"], phase10["10c"] = remat_policies(dev)
        phase("phase 10d: the Table-4 weight schemes, card vs CPU")
        phase10["10d"] = table4_schemes(dev)
        (out_dir / "smoke_phase10.json").write_text(json.dumps(phase10, indent=1))
    # 11. serving mamba2-780m on the contiguous cache, the serving kernels'
    # counters reset just before the kernel-route run
    if run(11):
        phase("phase 11: serving mamba2-780m on the contiguous cache, full width")
        (by_path["serve mamba2-780m"],
         by_path["serve entry point mamba2-780m"]) = serve_mamba(dev, out_dir)
    # 12. the dense configs: gemma-7b served at full width (the serving
    # kernels' counters reset just before 12a's run and read after it), the
    # kernel route vs the plain one at its widths, its launcher, and the
    # blocked forward and bf16 scores at full width
    if run(12):
        phase(f"phase 12a: serving gemma-7b at full width and {GEMMA_SERVE_LAYERS} of "
              "its 28 layers (head_dim 256)")
        by_path["serve gemma-7b (12a)"], phase12 = serve_gemma(dev, out_dir)
        phase("phase 12b: on-card parity, gemma-7b widths at depth 2, kernel vs plain "
              "route")
        phase12["12b"] = gemma_kernel_vs_plain(dev)
        phase("phase 12c: the launcher, --arch gemma-7b --packed")
        by_path["serve entry point gemma-7b (12c)"], phase12["12c_memory"] = \
            gemma_launcher(out_dir)
        phase("phase 12d: blocked forward and bf16 scores, qwen3-0.6b widths, S=4096")
        phase12["12d"] = attention_variants_full_width(dev)
        (out_dir / "smoke_gemma.json").write_text(json.dumps(phase12, indent=1))
    # 13. the MoE and hybrid families: granite served (the serving kernels'
    # counters reset just before 13a's kernel-route run and read after it)
    # and distilled at full width (the training kernels' counters reset
    # before its steps), jamba's mamba + dense block at full width and its
    # reduced stack (each route's counters reset before it), the launcher
    if run(13):
        phase(f"phase 13a: serving granite-moe-1b-a400m at full width and "
              f"{GRANITE_SERVE_LAYERS} of its 24 layers (MoE, head_dim 64)")
        by_path["serve granite-moe-1b-a400m (13a)"], phase13 = serve_packed(
            dev, out_dir, GRANITE, 4, "granite", gate_plain=True,
            layers=GRANITE_SERVE_LAYERS)
        # 13b's depth cut to half of granite's 24 layers to leave room for phase 14
        phase("phase 13b: BitDistill training, granite-moe-1b-a400m full width, 12 "
              "of its 24 layers")
        per_fwd = 4 * 12                       # q, k, v, o; the experts are einsums
        by_path["train granite-moe-1b-a400m (13b)"] = train_full_width(
            dev, out_dir, GRANITE, 12, QWEN_SEQ,
            {"train": {"bitlinear": 2 * per_fwd, "relation_kd": 0},
             "distill": {"bitlinear": 2 * per_fwd, "relation_kd": 3}}, "train_granite")
        phase("phase 13c: jamba's mamba + dense block at full width, kernel vs plain "
              "route (ssd_scan at (128, 128))")
        by_path["jamba mamba + dense block (13c)"], phase13["13c"] = \
            jamba_block_parity(dev)
        phase("phase 13d: jamba reduced (one repeat, 8 layers): contiguous serving, "
              "a QAT step, kernel vs plain route")
        ((by_path["serve jamba reduced (13d)"], by_path["train jamba reduced (13d)"]),
         phase13["13d"]) = jamba_reduced(dev)
        phase("phase 13e: the launcher, --arch granite-moe-1b-a400m --packed")
        by_path["serve entry point granite-moe-1b-a400m (13e)"], phase13["13e_memory"] = \
            serve_launcher(out_dir, GRANITE_CLI, "granite")
        (out_dir / "smoke_moe.json").write_text(json.dumps(phase13, indent=1))
    # 14. the cross-attention families: whisper-medium and llama-3.2-vision-11b
    # (each path's counters reset just before it and read after it)
    if run(14):
        phase("phase 14: the cross-attention families (whisper-medium, "
              "llama-3.2-vision-11b)")
        cross_families(dev, out_dir, by_path)
    # 15. the distributed layer on a one-rank NCCL group (the bitlinear
    # counter reset just before 15a's run under the plan and read after it)
    if run(15):
        phase("phase 15: the distributed layer at world size 1 (a sharded CE step, "
              "the launcher, compressed_psum, GPipe)")
        by_path["train qwen3-0.6b under a plan (15a)"], _ = distributed_layer(
            dev, out_dir, card)
    # 16. the tooling on the card: each counted path's counters reset just
    # before it and read just after (16b's training step, 16c's decode pass)
    if run(16):
        phase("phase 16: the analysis and dry-run tooling (lint, watchdog, op "
              "counting on the card and on meta, the dry run and its report)")
        paths16, _ = tooling(dev, out_dir, card)
        by_path.update(paths16)
    # 17. tensor-parallel compute: the bitlinear kernel at the split's shard
    # shapes (comparisons), then the distill step under a plan (the training
    # kernels' counters reset just before the run under the plan, read after)
    if run(17):
        phase("phase 17: tensor-parallel compute (the kernel at shard shapes, the "
              "distill step under a plan)")
        paths17, _ = tensor_parallel(dev, out_dir, card)
        by_path.update(paths17)
    # 18. the split route for the MoE, SSM and hybrid families: the MoE
    # layers, the Mamba2 block and ssd_scan on a rank's share (comparisons),
    # then granite's
    # and mamba2's steps under a one-rank plan (the training kernels'
    # counters reset just before each run under the plan, read after)
    if run(18):
        phase("phase 18: the split route for the MoE, SSM and hybrid families (the "
              "MoE and Mamba2 layers over emulated ranks, ssd_scan on a rank's "
              "heads, granite's and mamba2's steps under a plan)")
        paths18, _ = split_families(dev, out_dir, card)
        by_path.update(paths18)
    # 19. the split route for the cross families and for decode: the blocks
    # and the accumulator entry on a rank's share (comparisons), a packed
    # decode step over emulated ranks (the packed kernels' counters reset
    # just before the ranks' run, read after), whisper's steps under a
    # one-rank plan (the training kernels' counters likewise)
    if run(19):
        phase("phase 19: the split route for the cross families and for decode "
              "(blocks over emulated ranks, w2a8_forward_acc on row shards, a packed "
              "decode step over emulated ranks, whisper's steps under a plan)")
        paths19, _ = cross_split(dev, out_dir, card, results)
        by_path.update(paths19)

    # summary
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # every parity check above is fatal, so reaching here means "ok";
    # launches: the sum over the paths' counted runs, each path's own beside
    launches, where = {}, {}
    for path, counts in by_path.items():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
            where.setdefault(name, {})[path] = n
    missing = sorted(set(results) - set(launches))
    if missing and only is None:
        fail(f"kernels checked but never counted on a path: {missing}")
    line = {"kernels": [dict({k: dict(v, launches=launches.get(name, 0))[k]
                              for k in keys},
                             launches_by_path=where.get(name, {}), parity="ok")
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

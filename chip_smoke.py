"""Smoke test of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. card name and power limit; build the CUDA kernels from ``src/repro_torch/
     csrc`` and report the build time, the tensor-core kernels' registers,
     spills and shared memory, and their SASS: bitlinear's GEMM and w2a8's
     wgmma route must hold the int8 ``wgmma`` (IGMMA) and the TMA loads
     (UTMALDG), ssd_scan's three product stages TF32 ``mma`` (HMMA);
  2. every kernel against its plain PyTorch version at its path's shapes
     (the serving kernels and bitlinear in bf16 and fp32, relation_kd and
     ssd_scan in fp32), with its time, the plain version's time, a library
     yardstick where one PyTorch call computes the same function, and the
     card's lower bound for the work; the paged prefill kernel at two
     shapes (the original one, and a mixed step of one prefilling and
     seven decode rows), each paged launch with its split and CTA counts,
     its device time alone beside the time a caller sees, and its host
     time per call; bitlinear bitwise in both dtypes at seven shapes, timed
     the same way, with its three device kernels (quantizing pass, K-major
     weight, GEMM) alone; w2a8 bitwise at the five projection shapes on
     both sides of its route threshold, timed the same way at the decode
     rows (M=8) and a chunk step's (M=256) beside ``torch._int_mm``;
     ssd_scan within 1e-4, timed on both timers;
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
  then summary lines: card, kernels (JSON), and the result line last.

It imports nothing of JAX or of the JAX package.  Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero.

``python3 chip_smoke.py --kernels-of DIR`` runs only phase 2's checks and
timings of w2a8, the paged kernels, bitlinear and ssd_scan, and
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
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s and
# the per-type operation rates used for each kernel's lower bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bfloat16": 989e12, "tf32": 494.7e12,
            "float32": 67e12}


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

W2A8_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]


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
    k/v, gate/up, down) at the decode rows (M=8) and a chunk step's rows
    (M = max_batch 8 x chunk 32 = 256), and, where the package routes by M,
    on both sides of its threshold; fp32 and bf16 bitwise to ``w2a8_ref``
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
    for (k, n) in W2A8_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        qw, delta = Q.weight_quant_absmean(w)
        wq = qw.to(torch.int8)
        wp = Q.pack_ternary(wq)
        for m in ms_checked:
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((m, k), generator=gen, device=dev).to(dt)
                y = wk.w2a8_kernel(x, wp, delta)
                torch.cuda.synchronize()
                r = w2a8_ref(x, wp, delta)
                if not torch.equal(y, r):
                    err = (y.float() - r.float()).abs().max().item()
                    fail(f"w2a8 M={m} K={k} N={n} {dt}: max err {err} (must "
                         "be bitwise)")
                if dt != torch.bfloat16 or m not in (8, 256):
                    continue
                ms = both_ms(lambda: wk.w2a8_kernel(x, wp, delta), flush)
                host = host_us(lambda: wk.w2a8_kernel(x, wp, delta))
                plain = both_ms(lambda: w2a8_ref(x, wp, delta), flush)
                xq, gamma = Q.act_quant_absmax_int8(x.float())
                scale = Q.div(gamma, 127.0) * delta
                lib, why = _int_mm_ms(xq.to(torch.int8), wq, scale, dt, flush)
                nbytes = x.numel() * 2 + wp.numel() + 4 + m * n * 2
                b, by = bound_ms(nbytes, 2.0 * m * k * n, "int8")
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
        for (k, n) in W2A8_SHAPES:
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
        rows=rows, routes=routes)


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
            positions = sum(depths[r] for r in live)
            n, item = len(live), 2
            nbytes = (2 * positions * hkv * dh * item             # resident K, V
                      + n * hkv * (g + 2) * dh * item             # q, new K/V in
                      + n * hkv * (g + 2) * dh * item)            # out, K/V write
            ops = 4.0 * g * dh * hkv * (positions + n)
            bd, by = bound_ms(nbytes, ops, "bfloat16")
            grid = _launch_plan(b, hkv, g, 1, dh, bs, L)
            host = host_us(lambda: paged_attention_decode_kernel(
                q, kn, vn, k1, v1, bt, idx, scale, 0.0))
            row = _paged_row(f"paged decode B={b} Hkv={hkv} g={g} Dh={dh} bs={bs} "
                             f"L={L} bf16", ms, plain, lib, bd, by, grid, host)
    results["paged_attention_decode"] = dict(
        name="paged_attention_decode", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:114",
        max_abs_err=worst, shape="B=8 Hkv=8 g=2 Dh=128 bs=16 depth<=1023 bf16",
        **row)


def check_paged_prefill(dev, flush, results):
    """Two T = 32 launches: the original shape (cold starts, mid-prompt chunks
    straddling blocks, decode rows, pad rows, an idle row) and a mixed step
    as the engine launches it (one row prefilling 32 tokens at start 256,
    seven decode rows at depths 17..990).  The first is the headline row."""
    starts = [0, 256, 700, 31, 990, 16, 500, None]
    lens = [32, 32, 20, 1, 1, 7, 32, 1]
    row = _paged_prefill_shape(dev, flush, starts, lens, 2, "paged prefill")
    mixed = _paged_prefill_shape(
        dev, flush, [256, 17, 130, 300, 511, 640, 800, 990],
        [32, 1, 1, 1, 1, 1, 1, 1], 6, "paged prefill mixed step")
    results["paged_prefill_chunk"] = dict(
        name="paged_prefill_chunk", route="cuda",
        source="src/repro_torch/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/paged_prefill/kernel.py:136",
        max_abs_err=max(row.pop("max_abs_err"), mixed["max_abs_err"]),
        shape="B=8 Hkv=8 g=2 Dh=128 bs=16 T=32 start<=990 bf16", **row,
        mixed_step=dict(mixed, shape="B=8 T=32: one row 32 tokens at 256, seven "
                        "decode rows at depths 17..990, bf16"))


def _paged_prefill_shape(dev, flush, starts, lens, seed, tag):
    """One prefill launch shape, rows with start None idle: the kernel
    against its plain version in bf16 and fp32 with and without softcap
    (valid rows of live rows; pools bitwise outside the trash block), then
    in bf16 its time, the plain version's, SDPA's over the pre-gathered
    window, and the bound.  Returns the numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_prefill.kernel import paged_prefill_chunk_kernel
    from repro_torch.kernels.paged_prefill.ref import paged_prefill_chunk_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hkv, g, dh, bs, t = 8, 8, 2, 128, 16, 32
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
    shapes = [(2048, 1024, 2048), (2048, 1024, 1024), (2048, 2048, 1024),
              (2048, 1024, 3072), (2048, 3072, 1024),
              (4096, 1536, 6448), (4096, 3072, 1536)]
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
            nbytes = x.numel() * 2 + wq.numel() + 4 * m + 4 + m * n * 2
            bd, by = bound_ms(nbytes, 2.0 * m * k * n, "int8")
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
# on TF32 (HMMA ... TF32).
SASS_CHECKS = {
    "bitlinear_kernel_gemm": ("IGMMA", "UTMALDG"),
    "w2a8_kernel_gemm": ("IGMMA", "UTMALDG"),
    "ssd_kernel_prep": ("HMMA", "TF32"),
    "ssd_kernel_state": ("HMMA", "TF32"),
    "ssd_kernel_out": ("HMMA", "TF32"),
}


def _instance(fn: str):
    """The SASS_CHECKS kernel a mangled function name instantiates, and a
    short name for it (its output type or its (N, P)), or (None, None)."""
    for kern in SASS_CHECKS:
        if kern in fn:
            if "gemm" in kern:
                return kern, f"{kern}<{'bf16' if 'bfloat16' in fn else 'fp32'}>"
            return kern, kern + ("<128,64>" if "Li128E" in fn else "<16,16>")
    return None, None


def _kernel_ptxas(log: str):
    """(instance, ptxas's spill and register lines) of each SASS_CHECKS
    kernel in the build log."""
    fn, out, spill = None, [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = _instance(line)[1]
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


def check_relation_kd(dev, flush, results):
    """relation_kd at the distillation shape (qwen3-0.6b, split_heads=4,
    batch 8 x 256: BH=32, L=256, D=512) and at a ragged L=300; rtol 1e-5,
    atol 1e-6 against the materialized plain version (fp32 both)."""
    import torch
    from repro_torch.kernels.relation_kd.kernel import relation_kl_rows_kernel
    from repro_torch.kernels.relation_kd.ref import relation_kl_rows_ref
    gen = torch.Generator(device=dev).manual_seed(4)
    bh, d = 32, 512
    worst = 0.0
    for l in (256, 300):
        s = torch.nn.functional.normalize(
            torch.randn((bh, l, d), generator=gen, device=dev), dim=-1)
        t = torch.nn.functional.normalize(
            s + 0.5 * torch.randn((bh, l, d), generator=gen, device=dev), dim=-1)
        rows = relation_kl_rows_kernel(s, t, 1.0)
        torch.cuda.synchronize()
        ref = relation_kl_rows_ref(s, t, 1.0)
        err = (rows - ref).abs()
        if not bool((err <= 1e-6 + 1e-5 * ref.abs()).all()) or not bool(
                torch.isfinite(rows).all()):
            fail(f"relation_kd BH={bh} L={l} D={d}: max err {err.max().item()}")
        worst = max(worst, err.max().item())
        if l != 256:
            continue
        ms = time_ms(lambda: relation_kl_rows_kernel(s, t, 1.0), flush=flush)
        plain = time_ms(lambda: relation_kl_rows_ref(s, t, 1.0), flush=flush)
        nbytes = 2 * s.numel() * 4 + bh * l * 4
        ops = 2 * 2.0 * bh * l * l * d        # the two relation products
        bd, by = bound_ms(nbytes, ops, "float32")
        row = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bd, bound_by=by)
        print(f"  relation_kd BH={bh} L={l} D={d} fp32: {ms:.4f} ms (plain "
              f"{plain:.4f}, bound {bd:.4f} by {by}); max err {worst:.3g}",
              flush=True)
    results["relation_kd"] = dict(
        name="relation_kd", route="cuda", source="src/repro_torch/csrc/relation_kd.cu",
        replaces="src/repro/kernels/relation_kd/kernel.py:96", max_abs_err=worst,
        shape="BH=32 L=256 D=512 fp32", **row)


def check_ssd_scan(dev, flush, results):
    """ssd_scan at the mamba2-780m training shape: batch 8 x seq 512, 48
    heads of 64, state 128, chunk 256 (BH = 384, two chunks), fp32, inputs
    as Mamba2Block feeds them (A in [-8, -1] per head, dt = softplus(N(-2,
    1)), so a chunk's summed dt·|A| passes the ~88 where an unmasked
    exponential overflows).  y and the final state against ssd_chunked and
    the sequential ssd_scan_ref ([BH] layout, B and C per head), rtol 1e-4
    atol 1e-4; the gradient of all five operands through the
    autograd.Function against autograd through ssd_chunked, rtol 1e-3 atol
    1e-3.  That backward is itself a recompute through ssd_chunked, so the
    gradient check shows the Function is wired up; phase 8 holds the
    kernel path's gradients against the sequential oracle."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ref import chunk_len, ssd_chunked, ssd_scan_ref
    gen = torch.Generator(device=dev).manual_seed(5)
    b, s, h, p, n, chunk = 8, 512, 48, 64, 128, 256
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
    worst = 0.0
    for what, got, want in (("y vs ssd_chunked", y, yc), ("h vs ssd_chunked", hT, hc),
                            ("y vs ssd_scan_ref", flat(y), yr),
                            ("h vs ssd_scan_ref", hT, hr)):
        err = (got - want).abs()
        if not (bool(torch.isfinite(got).all())
                and bool((err <= 1e-4 + 1e-4 * want.abs()).all())):
            fail(f"ssd_scan {what}: max err {err.max().item()}")
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
            fail(f"ssd_scan gradient of {name}: max err {err.max().item()}")
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
    nc = s // q
    ops = (b * h * nc * (q * (q + 1) * p + 4.0 * q * n * p)
           + b * nc * q * (q + 1) * n)
    nbytes = 4 * (2 * x.numel() + 2 * a.numel() + 2 * B.numel() + hT.numel())
    bd, by = bound_ms(nbytes, 3 * ops, "tf32")
    print(f"  ssd_scan b={b} S={s} H={h} P={p} N={n} Q={q} fp32: {ms[0]:.4f} ms, "
          f"device alone {ms[1]:.4f} (plain ssd_chunked {plain[0]:.4f} / "
          f"{plain[1]:.4f}; bound {bd:.4f} by {by}: 3 x {ops / 1e9:.2f} GFLOP "
          f"at the TF32 rate); max err {worst:.3g}", flush=True)
    results["ssd_scan"] = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:74", max_abs_err=worst,
        ms=ms[0], plain_ms=plain[0], bound_ms=bd, bound_by=by, library_ms=None,
        device_ms=ms[1], plain_device_ms=plain[1],
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


# each kernel of the serving path: the names its CUDA functions carry in a
# profiler trace (w2a8's wgmma route quantizes with bitlinear's pass, which
# serving runs for nothing else)
SERVE_KERNELS = {"w2a8_kernel": ("w2a8_kernel", "bitlinear_kernel_quant_rows"),
                 "paged_decode_kernel": ("paged_decode_kernel",),
                 "paged_prefill_kernel": ("paged_prefill_kernel",)}


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
        for key, marks in SERVE_KERNELS.items():
            if any(m in name for m in marks):
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
    import torch
    seq = torch.tensor([list(prompt) + list(tokens[:-1])], device=dev)
    with torch.no_grad():
        top = model(seq)[0, len(prompt) - 1:].float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


# -- phases 5 to 8: the BitDistill training path -------------------------------

TRAIN_BATCH = 8
QWEN_SEQ, MAMBA_SEQ = 256, 512     # MAMBA_SEQ: two chunks of 256 per row
# each kernel of the training paths, by counter name: its package and the
# name its CUDA functions carry in a profiler trace
TRAIN_KERNELS = {"bitlinear": ("bitlinear", "bitlinear_kernel"),
                 "relation_kd": ("relation_kd", "relation_kl_rows_kernel"),
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


def train_full_width(dev, out_dir, name, layers, seq, expect, tag):
    """Phases 5 and 7: ``name`` at full width and depth (``layers``), bf16
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
    are sampled into ``clocks_<tag>.csv``.  Returns the launch counts of
    the steps."""
    import importlib
    import torch
    from repro_torch.core.distill import DistillConfig
    from repro_torch.models import build_model, get_config
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.schedule import warmup_cosine
    from repro_torch.training.trainer import (default_distill_layer, init_train_state,
                                              make_distill_step, make_train_step)

    cfg = get_config(name).replace(compute_dtype="bfloat16")
    if not (cfg.remat and cfg.param_dtype == "float32" and cfg.n_layers == layers):
        fail(f"unexpected {name} training config: {cfg}")
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
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            fail(f"{name} {kind} step {len(log)}: non-finite {bad}: {vals}")
        got = {k: c.count - before[k] for k, c in counters.items()}
        if got != expect[kind]:
            fail(f"{name} {kind} step {len(log)}: launches {got}, expected "
                 f"{expect[kind]} (remat recomputes each student forward)")
        log.append(dict(kind=kind, ms=ms, host=host, **vals))
        parts = " ".join(f"{k} {vals[k]:.5g}" for k in
                         ("loss", "loss_ce", "loss_ld", "loss_ad", "grad_norm", "lr")
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


def kernels_of(root: Path) -> None:
    """``python3 chip_smoke.py --kernels-of DIR``: phase 2's w2a8, paged,
    bitlinear and ssd_scan checks and timings against the package of the
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
                  check_bitlinear, check_ssd_scan):
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


def main() -> None:
    args = sys.argv[1:]
    root = ROOT
    modes = {"--kernels-of": kernels_of, "--serving-of": serving_of}
    if args:
        if len(args) != 2 or args[0] not in modes:
            fail(f"unknown arguments {args}: run with none, or with "
                 "--kernels-of DIR or --serving-of DIR")
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

    # 1. card and build
    card = card_info()
    print(f"card: {card}", flush=True)
    from repro_torch.kernels import build
    info = build.build(verbose=True)
    print(f"build: {info.seconds:.1f} s -> {info.path}", flush=True)
    out_dir = ROOT / "smoke_out"
    out_dir.mkdir(exist_ok=True)
    from repro_torch.kernels.bitlinear.kernel import gemm_info
    from repro_torch.kernels.w2a8_gemv.kernel import gemm_info as w2a8_info
    gemm_line = (f"bitlinear GEMM: {gemm_info()}; w2a8: {w2a8_info()} (smem_bytes: "
                 "dynamic shared memory per CTA); ptxas: " + "; ".join(
                     f"{fn}: {use}" for fn, use in _kernel_ptxas(info.log)))
    (out_dir / "ptxas.txt").write_text(info.log + gemm_line + "\n")
    print(gemm_line, flush=True)
    sass = kernel_sass(info.path, out_dir)
    print(f"tensor-core SASS: {sass['counts']}; e.g. " + "; ".join(
        sass["examples"].values()), flush=True)

    # 2. kernels against their plain versions
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    results = {}
    print("phase 2: kernels vs plain versions", flush=True)
    check_w2a8(dev, flush, results)
    check_paged_decode(dev, flush, results)
    check_paged_prefill(dev, flush, results)
    check_bitlinear(dev, flush, results)
    check_relation_kd(dev, flush, results)
    check_ssd_scan(dev, flush, results)
    del scratch
    # 3. the main path, launch counters reset just before it
    print("phase 3: engine, qwen3-0.6b full width", flush=True)
    by_path = {"serve qwen3-0.6b": serve_full_width(dev, out_dir)}
    # 4. kernels vs plain paths through the engine
    print("phase 4: on-card parity, kernel vs plain paths", flush=True)
    kernel_vs_plain_parity(dev, out_dir)
    # 5. the training path, its launch counters reset just before it
    print("phase 5: BitDistill training, qwen3-0.6b full width", flush=True)
    per_fwd = 7 * 28                       # BitLinear projections, 28 layers
    by_path["train qwen3-0.6b"] = train_full_width(
        dev, out_dir, "qwen3-0.6b", 28, QWEN_SEQ,
        {"train": {"bitlinear": 2 * per_fwd, "relation_kd": 0},
         "distill": {"bitlinear": 2 * per_fwd, "relation_kd": 3}}, "train")
    # 6. kernels vs plain paths through the distillation step
    print("phase 6: on-card parity, distill step kernel vs plain paths", flush=True)
    train_kernel_vs_plain_parity(dev)
    # 7. the mamba2-780m training path, its counters reset just before it:
    # the student's in_proj + out_proj per layer and one SSD per layer, each
    # forward recomputed once under remat; the FP teacher adds 48 SSDs
    print("phase 7: BitDistill training, mamba2-780m full width", flush=True)
    by_path["train mamba2-780m"] = train_full_width(
        dev, out_dir, "mamba2-780m", 48, MAMBA_SEQ,
        {"train": {"bitlinear": 2 * 2 * 48, "ssd_scan": 2 * 48},
         "distill": {"bitlinear": 2 * 2 * 48, "ssd_scan": 3 * 48}}, "train_mamba")
    # 8. the SSD kernel vs the sequential oracle through a full-width block
    print("phase 8: on-card parity, Mamba2Block kernel vs sequential", flush=True)
    mamba_block_parity(dev)

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
    if missing:
        fail(f"kernels checked but never counted on a path: {missing}")
    line = {"kernels": [dict({k: dict(v, launches=launches[name])[k] for k in keys},
                             launches_by_path=where[name], parity="ok")
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

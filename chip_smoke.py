#!/usr/bin/env python3
"""Chip smoke for tpuserve_torch: the quickest proof that the port builds,
is right and serves on one NVIDIA GPU (written for the H100, sm_90a).

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure exits non-zero before the result line):

1. Device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. Build: compile every kernel of the path from the checkout's sources
   (``tpuserve_torch/ops/csrc``) with nvcc; the build time on its own line,
   then ptxas' registers and spills and the dynamic shared memory of each
   instantiation. The bf16 and fp16 tensor-core instantiations at D = 64
   must not spill.
3. Kernels: hold K1 (flash attention) against its plain PyTorch version on
   the card — BERT shapes (B 1 and 32, S 64 and 128, H 12, D 64) in float32,
   bfloat16 and float16 with padded keys, ragged shapes (Sq = Sk = 77,
   Sq != Sk, S = 192), other head dims, strided q/k/v views of one fused
   projection, a fully masked row and one gradient. TF32 is off for the
   plain version. Tolerances: float32 atol 2e-5 (the CUDA-core kernel, full
   float32); bfloat16/float16 atol = rtol = 1.6e-2 against the plain version
   computed in float32 from the same inputs (the tensor-core kernel rounds P
   to the input dtype before P.V, as the reference does on the TPU's MXU).
   Then time the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls) at
   (32, 64) and (32, 128), beside the least time the card could take.
4. K2 (flash attention's stats variant, ring attention's local step): hold
   it against its plain PyTorch version on the card — BERT shapes in
   float32, bfloat16 and float16 with padded keys and a fully masked row,
   ragged Sq/Sk and head dims 40, 80, 128, strided q/k/v views, one
   gradient, and (8, 2048, 12, 64) bf16. K2's outputs are float32 whatever
   its inputs; against the plain version computed in float32 from the same
   inputs: acc/l atol 2e-5 + rtol 1e-5 for float32 inputs and atol = rtol =
   1.6e-2 for 16-bit ones (P rounded, as for K1), m atol 2e-5 + rtol 1e-6,
   l atol 2e-5 + rtol 5e-5 (sums of up to 2048 exponentials in another
   order). Then time K2, its plain version, its bound and its library
   yardstick at (8, 2048, 12, 64) bf16: ``_scaled_dot_product_efficient_attention``
   with ``compute_log_sumexp`` returns (acc/l, m + log l), which is held
   once against K2's. SDPA (normalized output only) and K1 are timed at the
   same shape too (Ulysses launches K1 there).
5. Sequence parallel on one card: ``ring_attention`` (flash and dense local
   steps) and ``ulysses_attention`` over a 4-rank mesh whose ranks share the
   card, at (2, 1024, 12, 64) bf16 with rank 2's key block fully masked and
   lane 1 fully padded, against plain dense attention in float32 (atol =
   rtol = 1.6e-2, as K1's bf16 check).
6. Slice: start ``python -m tpuserve_torch serve`` on a full-width BERT-base
   config (12 layers, d_model 768, 12 heads, d_ff 3072, vocab 30522, bf16,
   attention = "flash", seq buckets [64, 128], batch buckets [1, 8, 32],
   seeded weights), set the kernel launch counts to 0, send a single text,
   an 8-text and a 32-text batch, a malformed body (400) and an unknown
   model (404), and read the counts back: K1 must have launched 12 times
   per batch, batches and items must have moved and the warm-up compile
   count must not. Then sanity timings (sequential requests of each shape,
   and concurrent clients sending 32-text batches), printed as the
   ``serve`` line. The served answers must equal an in-process run of the
   same seeded model with the same kernel, and agree with the dense
   attention model in top-5 wherever its logits separate the ranks by more
   than the bf16 logit tolerance. In-process, the forward's stream and
   host-enqueue times per bucket are taken, and a second batch's h2d must
   not wait for the first batch's forward still queued on the card.
7. Long-context slice: serve ``examples/bert_long_ring.toml`` (full-width
   BERT-base, bf16, ``attention = "ring"``, seq bucket 2048, batch buckets
   [1, 8], one-card mesh with sp = 1) through ``python -m tpuserve_torch
   serve``; with the counts at 0 send one long text (the (1, 2048) bucket,
   where the ring's auto local step is dense: 0 K2 launches) and a batch of
   5 texts of 300 to 2040 word pieces (the (8, 2048) bucket, where it is
   K2: 12 launches; its 3 padded lanes are fully masked rows), plus the 400
   and 404 probes; the warm-up compile count must not move. The served
   answers must equal an in-process run of the same seeded model and agree
   in top-5 with dense attention wherever its logits separate the ranks by
   more than the logit tolerance. In-process, the (8, 2048) forward's stream
   and host-enqueue times and K2's share of it are taken.
   Every served model answers from CUDA graphs, one per bucket and
   parameter slot (3 per bucket); on each path the server's graph count and
   ``memory_reserved`` before and after capture are printed, and
   ``graph_phase`` holds, for every bucket of every model, the graph
   replay against the eager forward of the live slot on the same resident
   input (indices identical; logits and probabilities bit-identical, or the
   max abs logit diff printed and held within ``LOGIT_TOL`` /
   ``RESNET_LOGIT_REL`` of the scale) and times, at (32, 128), (8, 2048)
   and (32,), the served h2d stage's host time (pinned copy + replay
   enqueue) against the eager yardstick, and the replay's device time.
8. Vision slice: serve ``examples/resnet50.toml`` — full-width ResNet-50
   (1000 classes, 224 pixels, seeded, bf16, batch buckets [1, 8, 32]) as
   ``resnet50`` (yuv420 wire at 160, int8 weights) and ``resnet50_rgb``
   (rgb8 wire at 256, bf16 weights) — through ``python -m tpuserve_torch
   serve``; with the counts at 0 send framed yuv420 bodies of 1, 8 and 32
   items to the first and an npy (8, 256, 256, 3) batch and an npy
   (256, 256, 3) image to the second, then a malformed frame (400,
   ``frame_errors_total`` + 1) and an unknown model (404). Batches and
   items must move, the warm-up compile count must not, and K1 and K2 must
   not launch. In-process, per model: the served top-5 must equal the same
   seeded model's on the same batches; the bf16 logits must agree with the
   same network in float32 with TF32 off, from the same int8-dequantized
   weights, within ``RESNET_LOGIT_REL`` of the float32 logits' scale, and
   in top-5 wherever the float32 logits separate the ranks by more than
   that; then at the (32,) bucket the forward's device time
   (``time_calls``), its stream and host-enqueue times
   (``forward_timing``), the device preprocessing alone and the int8
   dequantization alone, beside the operations bound (multiply-accumulates
   hooked from the convolutions' shapes, over the bf16 peak) and the bytes
   bound (wire, weights as stored and the top-5 outputs, over HBM's rate).
   ``native_jpeg`` says whether the libjpeg shim built on this machine.
9. Lifecycle: serve ``examples/bert_flash.toml`` and then
   ``examples/resnet50.toml`` with ``bert`` / ``resnet50`` (int8) reading a
   seed-1 ``.npz`` checkpoint written by ``save_npz`` from the port's own
   seeded init, and drive ``:reload`` (seed 2: version 2, other answers),
   ``:rollback`` (version 1, the first answers again), a corrupted
   checkpoint under a stale manifest (409 ``integrity``), one with an inf
   leaf (409 ``nan_scan``; version 1 answers as before after each) and a
   second ``:reload`` (version 3, version 2's answers), with the graph and
   compile counts unchanged across all of it (``lifecycle_drill``); the
   drill must stand in ``/debug/audit`` (reload ok, rollback ok, the two
   rejections with their gates, reload ok) and in ``/debug/events``
   (``published`` twice, ``rolled_back``, ``reload_rejected`` twice).
   Phase 8 also times the first request of each bucket stage by stage
   (``stage_totals``: the server's per-stage histogram sums around one
   request) against eight repeats, and holds each stage but the queue
   within its repeats' range plus 5 ms (``first_request_table``): no
   request pins memory or builds state on the request path.
10. Robustness (``robustness_phase``), on full-width BERT-flash with the
   reference's robustness defaults (no ``[adaptive]`` table): in-process,
   lone texts under the fixed and the adaptive flush (total p50s,
   bit-identical answers, ``adaptive_target_batch``), a 4-client burst,
   per-bucket no-fault baselines, a retry drill (``batch_error`` at 0.1,
   seed 1, 200 requests of 32 texts from 4 clients: availability >= 0.99,
   breaker closed, answers bit-identical to a no-fault one), poison
   bisection of a full 32-batch (31 answers bit-identical, the poison's
   error, ``poison_items_total`` and ``batch_retries_total`` 1), the
   watchdog reviving a killed group loop, and the breaker (``device_error``
   at 1.0 inside the soak window of a reload: 5 x 500, then 503 +
   ``Retry-After`` with nothing reaching the batcher, a ``soak_breaker``
   rollback to version 1, the canary closing it, version 1's answers); K1
   launches = 12 x the batches the runtime dispatched, captures and
   compiles unchanged. Then a serving subprocess with ``[cache]``, two
   ingest loops and a 200 ms ``slow_dispatch``: a repeat hits with the
   same bytes, 8 identical texts are 1 miss + 7 coalesced, a reload misses
   again, both accept loops serve, and SIGTERM with 4 requests in flight
   answers them 200, new ones 503 + ``Retry-After``, ``/healthz``
   ``draining``, exit 0.
11. Observability (``observability_phase``): serve BERT-flash with a 50 ms
   ``[model.slo]`` objective and a 0.25 s sampler; a well-formed
   ``X-Trace-Id`` comes back, a malformed one is replaced; the request's
   span tree (``/debug/trace?trace_id=``) has ``request`` at the root and
   body_read, parse, queue, preproc, h2d, compute, postproc under it, in
   order, summing to no more than it; a 400 leaves a ``request_error``
   event under its trace id; ``/debug/slow`` holds entries. Under 4 clients
   of 32-text batches: ``device_utilization`` in (0, 1], a positive
   ``batches_total`` rate in ``/stats/history``, the objective in
   ``/alerts``, and a 1 s ``POST /debug/profile`` whose merged trace says
   ``device_trace: "ok"`` and holds K1's kernels by name, every one inside
   the capture window and (on the span ring's clock) inside a served
   batch's span, about 12 per batch; a second, concurrent capture answers
   409 and both land in ``/debug/audit``. K1 launches = 12 x the batches
   dispatched; captures and compiles unchanged.
12. Cost of the defaults (``defaults_cost_phase``): BERT-flash with the
   reference's planes on and with them off, both served at once, 32-text
   batches from 1 client and from 4, measured on, off, off, on: p50 and
   p99 and the mean time per stage, printed; nothing is gated on them.
13. MobileNetV3-Large (``mobilenet_phase``): serve
   ``examples/mobilenetv3.toml`` (full width, bf16, yuv420 at 224, batch
   buckets [1, 2, 4, 8]); with the counts at 0 framed bodies of 1, 2, 4 and
   8 items (K1 and K2: 0 launches; batches 4, items 15, compiles 0), each
   bucket's first request within its repeats' range + 5 ms per stage,
   then 21 lone single-item requests under the adaptive flush (server
   total p50). In-process: served top-5 equal to the same seeded model's,
   bf16 logits against the float32 network (TF32 off) within
   ``RESNET_LOGIT_REL`` of their scale with separated ranks equal, each
   bucket's replay device time, the eager stream and enqueue at (1,) and
   (8,), the depthwise convolutions' device time against the rest, one
   profiled eager window by kind; ``graph_phase`` holds every bucket's
   replay bit-identical to the eager forward.
14. Print a ``slice`` line per path, the ``graphs`` line (phase 6-8's and
   13's graph checks and host times), the ``lifecycle`` line, the
   ``robustness`` line (with phase 8's and 13's first-request tables), the
   ``observability`` and ``defaults_cost`` lines, and the ``kernels`` line
   (K1 and K2, each with its launches on its path, counted through graph
   replays; the vision paths run neither), the card line, then the result
   line ``{"ok": true, "device": {...}}``. Every phase's JSON line from 11
   on carries the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import math
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense tensor-core bf16, H100 SXM data sheet
BF16_TOL = 1.6e-2
F32_TOL = 2e-5
# Full-width serving logits, flash vs dense attention, bf16 (the dense path
# rounds P to bf16 before P.V, flash keeps it in f32): agreement required.
LOGIT_TOL = 0.1
TEXTS_8 = [f"request number {i} asks the server to classify this text" for i in range(8)]
TEXT_128 = "the model " * 45          # 90 word pieces: the 128-token bucket
TEXTS_32 = [f"batch item {i}: " + " ".join(["serve", "fast", "text", "model"][: 1 + i % 4])
            for i in range(32)]
# K2's tolerances (atol, rtol) against its plain version in float32. For
# 16-bit inputs the tensor-core kernel rounds P to the input dtype before
# P.V (as the reference's f32 dot_general does on the TPU: one bf16 MXU
# pass), so acc/l is held at K1's bf16 tolerance; m and l stay f32-level.
K2_TOL = {"acc_over_l": (2e-5, 1e-5), "m": (2e-5, 1e-6), "l": (2e-5, 5e-5)}
K2_TOL_16 = dict(K2_TOL, acc_over_l=(BF16_TOL, BF16_TOL))
# Words of the synthetic vocabulary that are one word piece each.
WORDS = ("the of and to in is was for on as with by at from it an be this that are "
         "or time year day man world life hand part child eye woman place work week "
         "case point company number group problem fact model serve image text token "
         "batch size test run fast slow good new old high low").split()


def long_text(n_pieces: int, seed: int) -> str:
    """A seeded text of ``n_pieces`` word pieces."""
    import numpy as np

    return " ".join(np.random.default_rng(seed).choice(WORDS, n_pieces))


LONG_PIECES = 2000                          # one text, the (1, 2048) bucket
LONG_BATCH_PIECES = (300, 700, 1100, 1500, 2040)   # 5 texts, the (8, 2048) bucket


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- phase 1 + 2 ----------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> dict:
    """Build the kernels' library from the checkout's sources and print
    ptxas' report of each instantiation; returns the build time and the
    tensor-core instantiations' spill bytes."""
    from tpuserve_torch.ops import _build
    from tpuserve_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    _build.load("flash_attention")
    build_s = time.perf_counter() - t0
    so = _build.library_path("flash_attention")
    print(f"build: flash_attention {build_s:.1f} s -> {so.relative_to(ROOT)}", flush=True)
    log = so.with_name(so.name + ".log")
    spills = {}
    if log.exists():
        # One line per kernel instantiation: K1/K2, input dtype, then for the
        # tensor-core kernel the padded head dim DP and its dynamic shared
        # memory, for the CUDA-core kernel the threads per row (TPR); then
        # ptxas' spill and register report for it.
        import torch

        dtypes = {"f": ("f32", torch.float32), "13__nv_bfloat16": ("bf16", torch.bfloat16),
                  "6__half": ("f16", torch.float16)}
        name, report = None, []
        for line in log.read_text().splitlines():
            tc = re.search(r"Compiling entry function '\w*flash_fwd_wgmmaI(\w+?)Li(\d+)ELb(\d)E",
                           line)
            f32 = re.search(r"Compiling entry function '\w*flash_fwd_kernelI(\w+?)Li(\d)ELb(\d)E",
                            line)
            if tc:
                label, dtype = dtypes.get(tc.group(1), (tc.group(1), None))
                dp, stats = int(tc.group(2)), tc.group(3) == "1"
                smem = fa.dynamic_smem_bytes(dtype, dp) if dtype else "?"
                name = f"{'K2' if stats else 'K1'} {label} DP={dp} dynamic smem {smem} B"
            elif f32:
                name = (f"{'K2' if f32.group(3) == '1' else 'K1'} "
                        f"{dtypes.get(f32.group(1), (f32.group(1),))[0]} TPR={f32.group(2)}")
            elif name and ("spill" in line or "registers" in line):
                report.append(line.split(":", 1)[-1].strip() if "registers" in line
                              else line.strip())
                if "spill" in line and "DP=" in name:
                    spills[name] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
                if "registers" in line:
                    print(f"  ptxas: {name}: {'; '.join(report)}")
                    name, report = None, []
    # The bf16 and fp16 D = 64 instantiations must not spill.
    bad = {n: b for n, b in spills.items() if "DP=64" in n and b}
    check(not bad, f"tensor-core instantiations spill: {bad}")
    return {"build_s": build_s, "tensor_core_spill_bytes": spills}


# -- phase 3 --------------------------------------------------------------------

def qkv(b, sq, sk, h, d, dtype, seed=0, masked_row=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    q, k, v = mk((b, sq, h, d)), mk((b, sk, h, d)), mk((b, sk, h, d))
    mask = torch.ones(b, sk, device="cuda")
    mask[0, sk // 2:] = 0                     # padded keys
    if b > 1:
        mask[-1, max(1, sk - 5):] = 0
    if masked_row:
        mask[-1, :] = 0                       # a padded batch lane
    return q, k, v, (1.0 - mask) * -1e9


def compare(q, k, v, bias) -> float:
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    out = fa.flash_attention(q, k, v, bias)
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), bias)
    torch.cuda.synchronize()
    check(out.dtype == q.dtype and out.shape == q.shape, f"K1 output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"K1 non-finite output at {tuple(q.shape)}")
    tol = F32_TOL if q.dtype == torch.float32 else BF16_TOL
    rtol = 0.0 if q.dtype == torch.float32 else BF16_TOL
    err = (out.float() - ref).abs()
    bad = err > tol + rtol * ref.abs()
    check(not bool(bad.any()), f"K1 disagrees with its plain version at q {tuple(q.shape)} "
          f"k {tuple(k.shape)} {q.dtype}: max abs err {err.max().item():.3g}")
    return err.max().item()


def kernel_phase() -> dict:
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for b in (1, 32):
            for s in (64, 128):
                compare(*qkv(b, s, s, 12, 64, dtype, seed=n))
                n += 1
        for sq, sk, d in ((77, 77, 64), (64, 100, 64), (100, 64, 64), (192, 192, 64),
                          (77, 77, 16), (64, 64, 40), (64, 96, 80), (128, 128, 128)):
            compare(*qkv(2, sq, sk, 12, d, dtype, seed=n))
            n += 1
        compare(*qkv(4, 64, 64, 12, 64, dtype, seed=n, masked_row=True))
        # q/k/v as strided views of one fused (B, S, 3, H, D) projection.
        fused = torch.randn(2, 128, 3, 12, 64, device="cuda").to(dtype)
        compare(*fused.unbind(dim=2), qkv(2, 128, 128, 12, 64, dtype)[3])
        n += 2
    # One gradient through the autograd.Function (dense-recompute backward).
    q, k, v, bias = qkv(2, 64, 64, 12, 64, torch.float32, seed=99)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ct = torch.randn_like(q)
    (fa.flash_attention(*leaves, bias) * ct).sum().backward()
    twins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (fa.flash_attention_reference(*twins, bias) * ct).sum().backward()
    for a, b_ in zip(leaves, twins):
        check(torch.allclose(a.grad, b_.grad, atol=1e-4), "K1 gradient disagrees")
    print(f"kernels: K1 agrees with its plain version at {n} shapes and one gradient")

    # Times at the main path's shapes; the kernels line reports the largest.
    return {s_: k1_timing(32, s_) for s_ in (64, 128)}


def k1_timing(b: int, s: int, h: int = 12, d: int = 64) -> dict:
    """K1, its plain version and the SDPA yardstick at one bf16 shape with
    padded keys, beside the least time the card could take."""
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    q, k, v, bias = qkv(b, s, s, h, d, torch.bfloat16, seed=7)
    max_err = compare(q, k, v, bias)
    mask4 = bias.to(torch.bfloat16)[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timed = time_calls(lambda: fa.flash_attention(q, k, v, bias))
    ms = timed["device_ms"]
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, bias))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask4))
    nbytes = 4 * b * s * h * d * q.element_size() + b * s * 4   # q, k, v, o + f32 bias
    flops = 4 * b * h * s * s * d                                # q.k^T and p.v
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    line = {"name": "flash_attention", "route": "cuda",
            "source": "tpuserve_torch/ops/csrc/flash_attention.cu",
            "replaces": "tpuserve/ops/flash_attention.py:96",
            "max_abs_err": max_err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    # What bound_ms is computed from (kept off the kernels line).
    inputs = {"shape": [b, s, h, d], "dtype": "bfloat16", "bytes": nbytes,
              "operations": flops}
    return {"line": line, "bound_inputs": inputs, "host_enqueue_ms": timed["host_ms"]}


def time_ms(fn, iters: int = 50) -> float:
    """``fn``'s device time per call, in ms."""
    return time_calls(fn, iters)["device_ms"]


def graph_ms(fn, replays: int = 20, rounds: int = 5) -> float:
    """Device time per call of ``fn``'s kernels, run back to back: ``fn``
    captured once into a CUDA graph, the graph replayed ``replays`` times
    between CUDA events (median of ``rounds``). For work of hundreds of
    kernels, such as a whole forward: ``time_calls`` would overfill the
    launch queue while it holds the card busy. The capture is the
    measurement's own, of any function; ``graph_phase`` times the
    runtime's own graphs."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(rounds):
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / replays)
    del graph
    return sorted(times)[rounds // 2]


KERNEL_KINDS = (("layout", ("nchwToNhwc", "nhwcToNchw", "transpose")),
                ("convolution/gemm", ("conv", "xmma", "gemm", "cutlass", "cudnn", "wgrad",
                                      "fprop")),
                ("pool", ("pool",)), ("reduce", ("reduce", "softmax", "topk", "sort")),
                ("elementwise", ("elementwise", "vectorized", "unrolled")))


def device_breakdown(fn, iters: int = 5) -> dict:
    """Device time per call of ``fn`` by kind of kernel, from
    ``torch.profiler`` (CUDA activity) over ``iters`` calls enqueued back to
    back: each kernel's name sorted into ``KERNEL_KINDS`` (else "other"),
    and the eight costliest kernels. The same window's stream time per call
    (CUDA events around the calls) and the card's idle share of it, 1 -
    busy / stream; the profiler's own host cost is inside that window, so
    the share is an upper bound on the unprofiled one. Empty of kernels,
    and no idle share, when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end) / iters
    kernels = [(e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    kinds: dict[str, float] = {}
    for name, ms, _ in kernels:
        kind = next((k for k, words in KERNEL_KINDS
                     if any(w.lower() in name.lower() for w in words)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    busy_ms = sum(kinds.values())
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"ms_by_kind": kinds, "total_ms": busy_ms, "stream_ms": stream_ms,
            "idle_share_of_stream": 1.0 - busy_ms / stream_ms if kernels else None,
            "kernels_per_call": sum(n for _, _, n in kernels),
            "top": [{"name": n[:90], "ms": ms, "launches": c} for n, ms, c in top]}


def time_calls(fn, iters: int = 50) -> dict:
    """``fn``'s device time per call: CUDA events around ``iters`` calls
    that the host enqueues while the card is held busy
    (``torch.cuda._sleep``), so the calls run back to back on the card and
    the host's time to enqueue them stays out of the window. The hold
    doubles until the last call was enqueued before the window opened.
    Also the host's enqueue time per call (Python, wrapper, launch)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_ms = max(2.0, 2e3 * iters * (time.perf_counter() - t0))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(5):
        torch.cuda._sleep(int(hold_ms * 2e6))    # cycles; >= 1 ms per 2e6 at <= 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        held = not start.query()
        end.record()
        torch.cuda.synchronize()
        if held:
            return {"device_ms": start.elapsed_time(end) / iters, "host_ms": host_ms}
        hold_ms *= 2
    raise SmokeFailure("the card ran dry while the host enqueued the timed calls")


# -- phase 4: K2 ------------------------------------------------------------------

def compare_stats(q, k, v, bias) -> dict:
    """K2 against its plain version in float32 on the same inputs; the max
    abs error of each output (and of acc/l, the normalized output)."""
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    got = fa.flash_attention(q, k, v, bias, return_stats=True)
    want = fa.flash_attention_stats_reference(q.float(), k.float(), v.float(), bias)
    torch.cuda.synchronize()
    b, sq, h, d = q.shape
    check([tuple(t.shape) for t in got] == [(b, sq, h, d), (b, sq, h), (b, sq, h)]
          and all(t.dtype == torch.float32 for t in got),
          f"K2 outputs {[(t.dtype, tuple(t.shape)) for t in got]}")
    check(all(bool(torch.isfinite(t).all()) for t in got), f"K2 non-finite output at {(b, sq, h, d)}")
    pairs = {"acc_over_l": (got[0] / got[2][..., None], want[0] / want[2][..., None]),
             "m": (got[1], want[1]), "l": (got[2], want[2])}
    errs = {"acc": (got[0] - want[0]).abs().max().item()}
    tols = K2_TOL if q.dtype == torch.float32 else K2_TOL_16
    for name, (a, w) in pairs.items():
        atol, rtol = tols[name]
        err = (a - w).abs()
        errs[name] = err.max().item()
        check(not bool((err > atol + rtol * w.abs()).any()),
              f"K2 {name} disagrees with its plain version at q {(b, sq, h, d)} "
              f"k {tuple(k.shape)} {q.dtype}: max abs err {errs[name]:.3g}")
    return errs


def stats_kernel_phase() -> dict:
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for b, s_ in ((4, 128), (8, 512)):          # BERT shapes, a padded lane
            compare_stats(*qkv(b, s_, s_, 12, 64, dtype, seed=100 + n, masked_row=True))
            n += 1
        for sq, sk, d in ((77, 77, 64), (64, 100, 64), (100, 64, 64), (256, 333, 64),
                          (200, 100, 40), (77, 333, 80), (192, 192, 128)):   # ragged
            compare_stats(*qkv(2, sq, sk, 12, d, dtype, seed=100 + n))
            n += 1
        fused = torch.randn(2, 128, 3, 12, 64, device="cuda").to(dtype)
        compare_stats(*fused.unbind(dim=2), qkv(2, 128, 128, 12, 64, dtype)[3])
        n += 1
    # One gradient through the stats Function (dense-recompute backward).
    q, k, v, bias = qkv(2, 64, 64, 12, 64, torch.float32, seed=199)
    cts = [torch.randn(s_, device="cuda") for s_ in ((2, 64, 12, 64), (2, 64, 12), (2, 64, 12))]
    grads = []
    for fn in (lambda *a: fa.flash_attention(*a, return_stats=True),
               fa.flash_attention_stats_reference):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        sum((o * c).sum() for o, c in zip(fn(*leaves, bias), cts)).backward()
        grads.append([t.grad for t in leaves])
    for a, b_ in zip(*grads):
        check(torch.allclose(a, b_, atol=1e-4), "K2 gradient disagrees")
    print(f"kernels: K2 agrees with its plain version at {n} shapes and one gradient "
          f"(tolerances f32 {K2_TOL}, bf16/f16 {K2_TOL_16})", flush=True)
    return k2_timing(8, 2048)


def efficient_attention_lse(qt, kt, vt, bias4):
    """The library yardstick of K2 (never called by the port): PyTorch's
    memory-efficient attention with its log-sum-exp, ``(out, lse)`` with
    out = acc / l and lse = m + log l, in (B, H, S, D) / (B, H, Sq)."""
    import torch

    out, lse = torch.ops.aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, bias4, True)[:2]
    return out, lse


def k2_timing(b: int, s: int, h: int = 12, d: int = 64) -> dict:
    """K2 and its plain version at one bf16 shape with padded keys and a
    padded lane, beside the least time the card could take and the library
    call that returns the same information, ``efficient_attention_lse``
    (its (out, lse) held once against K2's (acc/l, m + log l) on the lanes
    that have a key). SDPA (normalized output only) and K1 at the same shape
    too."""
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    q, k, v, bias = qkv(b, s, s, h, d, torch.bfloat16, seed=17, masked_row=True)
    errs = compare_stats(q, k, v, bias)
    timed = time_calls(lambda: fa.flash_attention(q, k, v, bias, return_stats=True), iters=20)
    ms = timed["device_ms"]
    plain_ms = time_ms(lambda: fa.flash_attention_stats_reference(q, k, v, bias), iters=10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bias4 = bias.to(torch.bfloat16)[:, None, None, :].expand(b, h, s, s)
    sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias.to(torch.bfloat16)[:, None, None, :]), iters=20)
    library_ms = time_ms(lambda: efficient_attention_lse(qt, kt, vt, bias4), iters=20)
    # The yardstick computes K2's function: check it once, lanes 0..b-2
    # (the last lane is all padding, where the bf16-rounded -1e9 differs).
    acc, m, l = fa.flash_attention(q, k, v, bias, return_stats=True)
    out, lse = efficient_attention_lse(qt, kt, vt, bias4)
    torch.cuda.synchronize()
    live = slice(0, b - 1)
    lib_out_err = (out.transpose(1, 2)[live].float() - acc[live] / l[live][..., None]).abs()
    lib_lse_err = (lse[..., :s].transpose(1, 2)[live] - (m + torch.log(l))[live]).abs()
    check(float(lib_out_err.max()) <= BF16_TOL + BF16_TOL * float(out.abs().max())
          and float(lib_lse_err.max()) <= BF16_TOL,
          f"the efficient-attention yardstick disagrees with K2: out {lib_out_err.max():.3g}, "
          f"lse {lib_lse_err.max():.3g}")
    # q, k, v in bf16 and the f32 bias read once; acc, m, l in f32 written once.
    nbytes = 3 * b * s * h * d * q.element_size() + b * s * 4 + b * s * h * d * 4 + 2 * b * s * h * 4
    flops = 4 * b * h * s * s * d                                # q.k^T and p.v
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    line = {"name": "flash_attention_stats", "route": "cuda",
            "source": "tpuserve_torch/ops/csrc/flash_attention.cu",
            "replaces": "tpuserve/ops/flash_attention.py:106",
            "max_abs_err": max(errs["acc"], errs["m"], errs["l"]), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True)",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    k1 = k1_timing(b, s, h, d)
    print(f"kernels: K2 at {(b, s, h, d)} bf16 {ms:.3f} ms (plain {plain_ms:.3f}, library "
          f"{library_ms:.3f}, bound {line['bound_ms']:.4f} {line['bound_by']}); K1 "
          f"{k1['line']['ms']:.3f} ms (SDPA {k1['line']['library_ms']:.3f}); the library's "
          f"(out, lse) vs K2: max abs err {lib_out_err.max():.3g}, {lib_lse_err.max():.3g}",
          flush=True)
    return {"line": line, "errors": errs, "sdpa_normalized_output_only_ms": sdpa_ms,
            "host_enqueue_ms": timed["host_ms"],
            "library_vs_k2_max_abs_err": {"out": float(lib_out_err.max()),
                                          "lse": float(lib_lse_err.max())},
            "bound_inputs": {"shape": [b, s, h, d], "dtype": "bfloat16", "bytes": nbytes,
                             "operations": flops},
            "k1_same_shape": k1}


# -- phase 5: ring and Ulysses on a 4-rank one-card mesh ------------------------

def sequence_parallel_phase() -> dict:
    import torch

    from tpuserve_torch.ops import dense_attention, ring_attention, ulysses_attention
    from tpuserve_torch.ops import flash_attention as fa
    from tpuserve_torch.parallel import MeshPlan, make_mesh

    mesh = make_mesh(MeshPlan(sp=4), devices=[torch.device("cuda")] * 4)
    q, k, v, _ = qkv(2, 1024, 1024, 12, 64, torch.bfloat16, seed=23)
    bias = torch.zeros(2, 1024, device="cuda")
    bias[:, 512:768] = -1e9        # rank 2's whole key block
    bias[1, :] = -1e9              # lane 1 all padding
    ref = dense_attention(q.float(), k.float(), v.float(), bias[:, None, None, :])
    errs = {}
    for fn, kernel in ((ring_attention, "stats_launches"), (ulysses_attention, "launches")):
        for local in ("flash", "dense"):
            before = getattr(fa, kernel)
            out = fn(q, k, v, mesh, key_padding=bias, local_impl=local)
            torch.cuda.synchronize()
            name = f"{fn.__name__}/{local}"
            check(out.dtype == torch.bfloat16 and out.shape == q.shape, f"{name}: {out.dtype}")
            check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
            err = (out.float() - ref).abs()
            errs[name] = err.max().item()
            check(not bool((err > BF16_TOL + BF16_TOL * ref.abs()).any()),
                  f"{name} disagrees with plain dense attention: max abs err {errs[name]:.3g}")
            # The flash local step went through the kernel: ring 4 ranks x 4
            # steps of K2, Ulysses one K1 per rank.
            want = {"ring_attention/flash": 16, "ulysses_attention/flash": 4}.get(name, 0)
            check(getattr(fa, kernel) - before == want,
                  f"{name}: {getattr(fa, kernel) - before} kernel launches, expected {want}")
    print(f"sequence parallel: ring and Ulysses on a 4-rank one-card mesh agree with plain "
          f"dense attention at (2, 1024, 12, 64) bf16: max abs err {errs}", flush=True)
    return errs


# -- phase 6: BERT-base with flash attention -------------------------------------

CONFIG = ROOT / "examples" / "bert_flash.toml"
LONG_CONFIG = ROOT / "examples" / "bert_long_ring.toml"


def model_config(attention: str, config: Path = CONFIG):
    import dataclasses

    from tpuserve_torch.config import load_config

    mcfg = load_config(str(config)).models[0]
    return dataclasses.replace(mcfg, options={**mcfg.options, "attention": attention})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def call(port, method, path, obj=None, raw=None, ctype="application/json"):
    body = raw if raw is not None else (json.dumps(obj).encode() if obj is not None else None)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def metric(text: str, name: str) -> float:
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def wait_healthy(proc, port, log_path: Path, n_buckets: int, timeout_s: float = 600.0) -> None:
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        if proc.poll() is not None:
            raise SmokeFailure(f"server exited with {proc.returncode}:\n"
                               + log_path.read_text()[-4000:])
        try:
            if call(port, "GET", "/healthz")[0] == 200:
                print(f"slice: server healthy after {time.time() - t0:.1f} s "
                      f"(params on the card, {n_buckets} buckets warmed, canary served)",
                      flush=True)
                return
        except OSError:
            pass
        time.sleep(1.0)
    raise SmokeFailure("server not healthy in time:\n" + log_path.read_text()[-4000:])


def drive(port: int) -> dict:
    """The main path's run: counts to 0, requests, counts read back."""
    check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
    before = call(port, "GET", "/metrics")[1].decode()
    t0 = time.perf_counter()
    st, body = call(port, "POST", "/v1/models/bert:classify", {"text": "serve this text please"})
    check(st == 200, f"single text: {st} {body[:300]!r}")
    single = json.loads(body)
    check(len(single["top_k"]) == 5, "single text: top_k must hold 5 entries")
    answers = {}
    for texts in (TEXTS_8, TEXTS_32):
        st, body = call(port, "POST", "/v1/models/bert:classify", {"texts": texts})
        check(st == 200, f"{len(texts)}-text batch: {st} {body[:300]!r}")
        results = json.loads(body)["results"]
        check(len(results) == len(texts), f"{len(texts)}-text batch: {len(results)} results")
        answers.update(zip(texts, results))
    wall_s = time.perf_counter() - t0
    st, _ = call(port, "POST", "/v1/models/bert:classify", raw=b"{not json")
    check(st == 400, f"malformed body answered {st}, expected 400")
    st, _ = call(port, "POST", "/v1/models/nope:classify", {"text": "x"})
    check(st == 404, f"unknown model answered {st}, expected 404")
    stats = json.loads(call(port, "GET", "/stats")[1])
    after = call(port, "GET", "/metrics")[1].decode()
    launches = stats["kernels"]["flash_attention"]["launches"]
    check(stats["kernels"]["flash_attention_stats"]["launches"] == 0,
          "K2 launched on the flash path, which has no ring attention")
    delta = {n: metric(after, f'{n}{{model="bert"}}') - metric(before, f'{n}{{model="bert"}}')
             for n in ("batches_total", "items_total", "runtime_compiles_total")}
    print(f"slice: 3 requests (41 texts) in {wall_s * 1e3:.1f} ms; batches {delta['batches_total']:g}, "
          f"items {delta['items_total']:g}, K1 launches {launches}, compiles after warm-up "
          f"{delta['runtime_compiles_total']:g}; backend {stats['backend']}", flush=True)
    check(delta["batches_total"] >= 3, "batches_total did not move as expected")
    check(delta["items_total"] == 41, f"items_total moved by {delta['items_total']}, expected 41")
    check(delta["runtime_compiles_total"] == 0, "runtime_compiles_total moved after warm-up")
    check(launches > 0 and launches == 12 * delta["batches_total"],
          f"K1 launched {launches} times for {delta['batches_total']:g} batches (12 per batch)")
    return {"launches": launches, "answers": answers}


def serve_timing(port: int, reps: int = 10, clients: int = 4, per_client: int = 25) -> dict:
    """Sanity figures of the served path, not end-to-end metrics (too few
    requests, closed loop): request wall times, sequential from one client,
    for each request shape; then ``clients`` concurrent clients each
    sending ``per_client`` 32-text batches, so batches overlap in the
    server's pipeline; and the server's per-phase p50s over both."""
    import threading

    kinds = {"single_s64": {"text": "serve this text please"},
             "batch8_s64": {"texts": TEXTS_8},
             "batch32_s64": {"texts": TEXTS_32},
             "batch32_s128": {"texts": [TEXT_128] * 32}}
    out = {}
    for kind, obj in kinds.items():
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            st, _ = call(port, "POST", "/v1/models/bert:classify", obj)
            walls.append((time.perf_counter() - t0) * 1e3)
            check(st == 200, f"timing request {kind} answered {st}")
        walls.sort()
        out[kind] = {"n": reps, "p50_ms": walls[reps // 2], "max_ms": walls[-1]}

    walls, statuses = [], []

    def client():
        for _ in range(per_client):
            t0 = time.perf_counter()
            st, _ = call(port, "POST", "/v1/models/bert:classify", {"texts": TEXTS_32})
            walls.append((time.perf_counter() - t0) * 1e3)
            statuses.append(st)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    check(statuses == [200] * clients * per_client,
          f"concurrent batches answered {sorted(set(statuses))}")
    walls.sort()
    out["concurrent_batch32_s64"] = {
        "clients": clients, "n": len(walls), "items_per_s": 32 * len(walls) / wall_s,
        "p50_ms": walls[len(walls) // 2], "max_ms": walls[-1]}
    lat = json.loads(call(port, "GET", "/stats")[1])["latency"]
    out["phase_p50_ms"] = {
        p: lat[f"latency_ms{{model=bert,phase={p}}}"]["p50_ms"]
        for p in ("body_read", "parse", "queue", "preproc", "h2d", "compute",
                  "postproc", "total")}
    return out


def in_process_check(answers: dict) -> None:
    """Served answers == the same seeded model in-process with the same
    kernel; and agree with dense attention where its logits separate."""
    import torch

    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    runs, forward_ms = {}, {}
    for attention in ("flash", "dense"):
        model = build(model_config(attention))
        rt = build_runtime(model, device="cuda")
        items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
                 for t in TEXTS_32]
        check(all(model.group_key(it) == 64 for it in items), "texts must fit seq bucket 64")
        dev = rt.h2d((32, 64), model.assemble(items, (32, 64)))
        with torch.inference_mode():
            logits = rt.module(*dev).float()
        check(bool(torch.isfinite(logits).all()) and logits.shape == (32, 1000),
              f"{attention}: logits {tuple(logits.shape)} not finite")
        runs[attention] = logits
        if attention == "flash":
            forward_ms = {s_: forward_timing(rt, model, (32, s_)) for s_ in (64, 128)}
            h2d_overlap_check(rt, model)
        del rt
    flash, dense = runs["flash"], runs["dense"]
    probs, idx = torch.softmax(flash, -1).topk(5)
    for row, t in enumerate(TEXTS_32):
        served = answers[t]["top_k"]
        check([e["class"] for e in served] == idx[row].tolist(),
              f"served top-5 != in-process flash top-5 for {t!r}")
        check(torch.allclose(torch.tensor([e["prob"] for e in served]), probs[row].cpu(),
                             atol=1e-6), f"served probs != in-process flash probs for {t!r}")
    err = (flash - dense).abs().max().item()
    check(err <= LOGIT_TOL, f"flash vs dense logits differ by {err:.3g} > {LOGIT_TOL}")
    checked = separated_ranks_agree(flash, dense, "flash")
    print(f"slice: served answers equal the in-process flash run; flash vs dense logits "
          f"max abs diff {err:.4g} (tol {LOGIT_TOL}), {checked} separated top-5 ranks agree",
          flush=True)
    return forward_ms


def separated_ranks_agree(logits, dense, label: str, tol: float = LOGIT_TOL) -> int:
    """Top-5 ranks of ``logits`` equal the reference logits' (``dense``)
    wherever those separate that rank from its neighbours by more than
    ``tol``; returns how many ranks were held."""
    sd, si = dense.sort(dim=-1, descending=True)
    fi = logits.argsort(dim=-1, descending=True)
    checked = 0
    for row in range(logits.shape[0]):
        for r in range(5):
            gap_above = sd[row, r - 1] - sd[row, r] if r else float("inf")
            gap_below = sd[row, r] - sd[row, r + 1]
            if min(gap_above, gap_below) > tol:
                check(fi[row, r] == si[row, r],
                      f"{label}: top-5 rank {r} differs from dense, row {row}")
                checked += 1
    return checked


def forward_timing(rt, model, bucket: tuple, rounds: int = 20, iters: int = 5) -> dict:
    """One forward (network + softmax + top-k) at a bucket, inputs resident
    on the card: the stream's time per forward (CUDA events) beside the
    host's time to enqueue it, per round of ``iters`` forwards. A round
    stays under the launch queue's depth, so the host never waits on the
    card while it enqueues; enqueue time close to the stream time means the
    card waits on the host. Medians and ranges over ``rounds`` rounds."""
    import numpy as np
    import torch

    dev = rt.h2d(bucket, tuple(np.zeros(s.shape, s.dtype)
                               for s in model.input_signature(bucket)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    stream, host = [], []
    with torch.inference_mode():
        for _ in range(3):
            model.forward(rt.module, dev)
        for _ in range(rounds):
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            for _ in range(iters):
                model.forward(rt.module, dev)
            host.append((time.perf_counter() - t0) * 1e3 / iters)
            end.record()
            torch.cuda.synchronize()
            stream.append(start.elapsed_time(end) / iters)
    stream.sort()
    host.sort()
    return {"rounds": rounds, "forwards_per_round": iters,
            "stream_ms": stream[rounds // 2], "stream_ms_range": [stream[0], stream[-1]],
            "host_enqueue_ms": host[rounds // 2], "host_enqueue_ms_range": [host[0], host[-1]]}


def h2d_overlap_check(rt, model) -> None:
    """Two batches in flight at full width: with h2d_sync on, the second
    batch's h2d waits for its own copy, not for the first batch's forward
    queued behind about a second of card work."""
    import numpy as np
    import torch

    bucket = (32, 64)
    host = tuple(torch.from_numpy(np.zeros(s.shape, s.dtype)).pin_memory().numpy()
                 for s in model.input_signature(bucket))
    rt.h2d_sync = True
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    busy = torch.cuda.Event()
    busy.record()
    first = rt.run(bucket, host)
    t0 = time.perf_counter()
    rt.h2d(bucket, host)
    h2d_ms = (time.perf_counter() - t0) * 1e3
    check(not busy.query(), "h2d waited for the forward in flight before its copy")
    rt.fetch(first)
    print(f"slice: a second batch's h2d took {h2d_ms:.3f} ms with the first "
          "batch's forward still queued (it waits for its own copy only)", flush=True)


@contextlib.contextmanager
def serving(config: Path, n_buckets: int, overrides: tuple = (), extra_toml: str = "",
            with_proc: bool = False):
    """``python -m tpuserve_torch serve --config <config>`` (plus ``--set``
    ``overrides``, and ``extra_toml`` appended to a copy of the file) on a
    free port, healthy; prints each model's graphs and the memory their
    capture reserved; yields the port (and the process, ``with_proc``) and
    stops the server on the way out."""
    port = free_port()
    sets = [a for o in (f"port={port}", *overrides) for a in ("--set", o)]
    with tempfile.TemporaryDirectory() as tmp:
        log_path = Path(tmp) / "server.log"
        if extra_toml:
            copy = Path(tmp) / config.name
            copy.write_text(config.read_text() + "\n" + extra_toml)
            config = copy
        with open(log_path, "w") as log:
            proc = subprocess.Popen([sys.executable, "-m", "tpuserve_torch", "serve",
                                     "--config", str(config), *sets],
                                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            wait_healthy(proc, port, log_path, n_buckets)
            for name, g in served_graphs(port).items():
                mem = g["capture_memory"]
                print(f"slice: {name} serves from {g['captures_total']} CUDA graphs "
                      f"({g['buckets']} buckets x 3 parameter slots); memory_reserved "
                      f"{mem['reserved_before_bytes'] / 2**20:.0f} MiB before capture, "
                      f"{mem['reserved_after_bytes'] / 2**20:.0f} MiB after", flush=True)
            yield (port, proc) if with_proc else port
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)


def served_graphs(port: int) -> dict:
    """Per served model: its graphs, compiles and capture memory
    (``/v1/models``)."""
    inv = json.loads(call(port, "GET", "/v1/models")[1])
    return {name: {"captures_total": d["captures_total"], "compiles_total": d["compiles_total"],
                   "buckets": len(d["buckets"]), "capture_memory": d["capture_memory"],
                   "version": d["version"]} for name, d in inv.items()}


# -- (a), (c), (d): the runtime's graphs against the eager forward ----------------

def forward_with_logits(model, module, batch) -> dict:
    """The model's forward with its float32 logits kept as a third output
    (what ``ServingModel.forward`` computes and drops)."""
    import torch

    logits = model.logits(module, batch).float()
    probs, idx = torch.topk(torch.softmax(logits, dim=-1), model.top_k, dim=-1)
    return {"probs": probs, "indices": idx, "logits": logits}


def seeded_batch(model, bucket: tuple, seed: int = 0) -> tuple:
    """A host batch for ``bucket``, pinned: BERT token ids with ragged
    padding, or uint8 wire planes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if model.cfg.family == "bert":
        b, s_ = bucket
        ids = rng.integers(5, model.vocab_size, (b, s_), dtype=np.int32)
        lengths = rng.integers(1, s_ + 1, b)
        mask = (np.arange(s_)[None, :] < lengths[:, None]).astype(np.int32)
        host = (ids * mask, mask)
    else:
        host = tuple(rng.integers(0, 256, sp.shape, dtype=np.uint8)
                     for sp in model.input_signature(bucket))
    return tuple(torch.from_numpy(a).pin_memory().numpy() for a in host)


def host_time(rt, model, bucket: tuple, host: tuple, rounds: int = 21) -> dict:
    """Host time per batch of what the served h2d stage does — the pinned
    copy plus the graph replay's enqueue (``rt.run`` with h2d_sync on) —
    beside the eager yardstick on the same runtime (``rt.h2d`` + the eager
    forward on the live slot's module); the card idle before each batch, as
    at low load. Medians and ranges over ``rounds`` batches."""
    import torch

    rt.h2d_sync = True
    graph, eager = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rt.run(bucket, host)
        graph.append((time.perf_counter() - t0) * 1e3)
        rt.fetch(out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            model.forward(rt.module, rt.h2d(bucket, host))
        eager.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    graph.sort()
    eager.sort()
    return {"graph_h2d_host_ms": graph[rounds // 2], "graph_h2d_host_ms_range": [graph[0], graph[-1]],
            "eager_h2d_host_ms": eager[rounds // 2], "eager_h2d_host_ms_range": [eager[0], eager[-1]]}


def replay_timing(rt, bucket: tuple, dev: tuple, replays: int = 20, rounds: int = 5) -> dict:
    """The runtime's dispatch of one bucket — copy into the graph's static
    inputs, replay, clone of the outputs — ``replays`` times back to back
    between CUDA events, inputs resident (median of ``rounds``). The host
    enqueues a dispatch in a fraction of its device time, so the card runs
    them back to back; holding the card busy first (``time_calls``) would
    overfill the launch queue with the graphs' kernels."""
    import torch

    for _ in range(3):
        rt.dispatch(bucket, dev)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(rounds):
        start.record()
        for _ in range(replays):
            rt.dispatch(bucket, dev)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / replays)
    times.sort()
    return {"replay_device_ms": times[rounds // 2], "replay_device_ms_range": [times[0], times[-1]]}


def graph_phase(config: Path, timed: dict, logit_tol) -> dict:
    """Every model of ``config`` on a runtime whose graphs also keep the
    logits: (a) for every bucket, the graph replay against the eager
    forward of the live slot on the same resident input — indices
    identical, logits and probabilities bit-identical, else the max abs
    logit diff printed and held within ``logit_tol(logits)``; (c) at the
    buckets ``timed`` names, the served h2d stage's host time against the
    eager yardstick (``host_time``), and the replay's device time
    (``replay_timing``); (d) memory_reserved before and after capture."""
    import torch

    from tpuserve_torch.config import load_config
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    out = {}
    for mcfg in load_config(str(config)).models:
        model = build(mcfg)
        model.forward = lambda module, batch, m=model: forward_with_logits(m, module, batch)
        rt = build_runtime(model, device="cuda")
        rows = {}
        for bucket in model.buckets():
            dev = rt.h2d(bucket, seeded_batch(model, bucket, seed=len(rows)))
            replay = rt.dispatch(bucket, dev)
            with torch.inference_mode():
                eager = model.forward(rt.module, dev)
            torch.cuda.synchronize()
            label = "x".join(map(str, bucket))
            check(torch.equal(replay["indices"], eager["indices"]),
                  f"{mcfg.name} {label}: graph replay and eager forward disagree on the top-k indices")
            bit = all(torch.equal(replay[k], eager[k]) for k in ("logits", "probs"))
            diff = (replay["logits"] - eager["logits"]).abs().max().item()
            if not bit:
                # Under capture cuBLAS and cuDNN may choose other algorithms
                # (other workspace limits), which sum in another order.
                tol = logit_tol(eager["logits"])
                print(f"graphs: {mcfg.name} {label}: replay vs eager logits differ by {diff:.3g} "
                      f"(tol {tol:.3g}): a kernel chose another algorithm under capture",
                      flush=True)
                check(diff <= tol, f"{mcfg.name} {label}: replay vs eager logits {diff:.3g} > {tol:.3g}")
            rows[label] = {"bit_identical": bit, "max_abs_logit_diff": diff}
        entry = {"buckets": rows, "captures_total": rt.captures_total,
                 "compiles_total": rt.compiles_total, "capture_memory": dict(rt.capture_memory)}
        bucket = timed.get(mcfg.name)
        if bucket is not None:
            host = seeded_batch(model, bucket, seed=99)
            entry["bucket_timed"] = list(bucket)
            entry.update(host_time(rt, model, bucket, host))
            entry.update(replay_timing(rt, bucket, rt.h2d(bucket, host)))
        mem = rt.capture_memory
        print(f"graphs: {mcfg.name}: {rt.captures_total} captures, every bucket's replay "
              f"{'bit-identical to' if all(r['bit_identical'] for r in rows.values()) else 'within tolerance of'}"
              f" the eager forward; memory_reserved {mem['reserved_before_bytes'] / 2**20:.0f} -> "
              f"{mem['reserved_after_bytes'] / 2**20:.0f} MiB over the captures"
              + (f"; at {bucket} the h2d stage's host time {entry['graph_h2d_host_ms']:.3f} ms "
                 f"(eager {entry['eager_h2d_host_ms']:.3f} ms), replay device "
                 f"{entry['replay_device_ms']:.3f} ms" if bucket else ""), flush=True)
        out[mcfg.name] = entry
        del rt, model
        torch.cuda.empty_cache()
    return out


def slice_phase() -> dict:
    with serving(CONFIG, n_buckets=6) as port:
        run = drive(port)
        run["timing"] = serve_timing(port)
        print(json.dumps({"serve": run["timing"]}), flush=True)
    run["forward_ms"] = in_process_check(run["answers"])
    run["graphs"] = graph_phase(CONFIG, {"bert": (32, 128)}, lambda logits: LOGIT_TOL)
    return run


# -- phase 7: long-context BERT-base with ring attention ------------------------

def kernel_counts(port: int) -> tuple[int, int]:
    k = json.loads(call(port, "GET", "/stats")[1])["kernels"]
    return k["flash_attention"]["launches"], k["flash_attention_stats"]["launches"]


def drive_long(port: int) -> dict:
    """The long-context path's run: counts to 0, one long text (the
    (1, 2048) bucket), counts read; a 5-text batch (the (8, 2048) bucket),
    counts read; then the probes."""
    single = long_text(LONG_PIECES, seed=0)
    texts = [long_text(n, seed=1 + i) for i, n in enumerate(LONG_BATCH_PIECES)]
    check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
    before = call(port, "GET", "/metrics")[1].decode()
    walls = {}
    t0 = time.perf_counter()
    st, body = call(port, "POST", "/v1/models/bert:classify", {"text": single})
    walls["single_s2048_ms"] = (time.perf_counter() - t0) * 1e3
    check(st == 200, f"long text: {st} {body[:300]!r}")
    answers = {single: json.loads(body)}
    counts_single = kernel_counts(port)
    t0 = time.perf_counter()
    st, body = call(port, "POST", "/v1/models/bert:classify", {"texts": texts})
    walls["batch5_s2048_ms"] = (time.perf_counter() - t0) * 1e3
    check(st == 200, f"5-text long batch: {st} {body[:300]!r}")
    results = json.loads(body)["results"]
    check(len(results) == 5, f"5-text long batch: {len(results)} results")
    answers.update(zip(texts, results))
    counts_batch = kernel_counts(port)
    after = call(port, "GET", "/metrics")[1].decode()
    delta = {n: metric(after, f'{n}{{model="bert"}}') - metric(before, f'{n}{{model="bert"}}')
             for n in ("batches_total", "items_total", "runtime_compiles_total")}
    print(f"slice (long): K1, K2 launches after the (1, 2048) batch {counts_single}, after the "
          f"(8, 2048) batch {counts_batch}; batches {delta['batches_total']:g}, items "
          f"{delta['items_total']:g}, compiles after warm-up {delta['runtime_compiles_total']:g}; "
          f"request walls {walls}", flush=True)
    check(counts_single == (0, 0), f"the (1, 2048) batch launched K1, K2 {counts_single} "
          "times; the ring's auto local step is dense there (0)")
    check(counts_batch == (0, 12), f"the (8, 2048) batch launched K1, K2 {counts_batch} "
          "times in all; the ring's auto local step is K2 there (12, one per layer)")
    check(delta["batches_total"] == 2 and delta["items_total"] == 6,
          f"batches/items moved by {delta['batches_total']:g}/{delta['items_total']:g}, expected 2/6")
    check(delta["runtime_compiles_total"] == 0, "runtime_compiles_total moved after warm-up")
    st, _ = call(port, "POST", "/v1/models/bert:classify", raw=b"{not json")
    check(st == 400, f"malformed body answered {st}, expected 400")
    st, _ = call(port, "POST", "/v1/models/nope:classify", {"text": "x"})
    check(st == 404, f"unknown model answered {st}, expected 404")
    # Sequential repeats of the batch: the served request's wall time and
    # the server's phase split (decode = WordPiece over ~5,600 pieces).
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        st, _ = call(port, "POST", "/v1/models/bert:classify", {"texts": texts})
        reps.append((time.perf_counter() - t0) * 1e3)
        check(st == 200, f"repeat of the long batch answered {st}")
    lat = json.loads(call(port, "GET", "/stats")[1])["latency"]
    phases = {p: lat[f"latency_ms{{model=bert,phase={p}}}"]["p50_ms"]
              for p in ("body_read", "parse", "queue", "preproc", "h2d", "compute",
                        "postproc", "total")}
    return {"answers": answers, "single": single, "texts": texts,
            "k2_launches": counts_batch[1] - counts_single[1],
            "counts": {"b1_s2048": list(counts_single), "b8_s2048": list(counts_batch)},
            "walls_ms": dict(walls, batch5_repeats=reps), "phase_p50_ms": phases}


def long_in_process_check(run: dict) -> dict:
    """Served answers == the same seeded model in-process; top-5 agreement
    with dense attention where its logits separate; the (8, 2048) forward's
    stream and host-enqueue times."""
    import torch

    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    groups = {(1, 2048): [run["single"]], (8, 2048): run["texts"]}
    logits, forward = {}, None
    for attention in ("ring", "dense"):
        model = build(model_config(attention, LONG_CONFIG))
        rt = build_runtime(model, device="cuda")
        for bucket, texts in groups.items():
            items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
                     for t in texts]
            check(all(model.group_key(it) == 2048 for it in items), "texts must fit seq 2048")
            dev = rt.h2d(bucket, model.assemble(items, bucket))
            with torch.inference_mode():
                out = rt.module(*dev).float()[: len(texts)]
            check(bool(torch.isfinite(out).all()) and out.shape == (len(texts), 1000),
                  f"{attention} {bucket}: logits {tuple(out.shape)} not finite")
            logits[attention, bucket] = out
        if attention == "ring":
            lengths = [len(it) for it in items]
            forward = forward_timing(rt, model, (8, 2048), rounds=5, iters=2)
        del rt, model
        torch.cuda.empty_cache()
    checked, err = 0, 0.0
    for bucket, texts in groups.items():
        ring, dense = logits["ring", bucket], logits["dense", bucket]
        probs, idx = torch.softmax(ring, -1).topk(5)
        for row, t in enumerate(texts):
            served = run["answers"][t]["top_k"]
            check([e["class"] for e in served] == idx[row].tolist(),
                  f"served top-5 != in-process ring top-5 at {bucket}, row {row}")
            check(torch.allclose(torch.tensor([e["prob"] for e in served]), probs[row].cpu(),
                                 atol=1e-6), f"served probs != in-process ring probs, row {row}")
        err = max(err, (ring - dense).abs().max().item())
        checked += separated_ranks_agree(ring, dense, f"ring {bucket}")
    print(f"slice (long): served answers equal the in-process ring run; ring vs dense logits "
          f"max abs diff {err:.4g}, {checked} separated top-5 ranks agree (tol {LOGIT_TOL}); "
          f"batch word pieces {lengths}", flush=True)
    return {"forward_ms_b8_s2048": forward, "ring_vs_dense_max_abs_logit_diff": err,
            "separated_ranks_checked": checked, "batch_ids_per_text": lengths}


def long_slice_phase() -> dict:
    t0 = time.perf_counter()
    with serving(LONG_CONFIG, n_buckets=2) as port:
        run = drive_long(port)
    run.update(long_in_process_check(run))
    run["graphs"] = graph_phase(LONG_CONFIG, {"bert": (8, 2048)}, lambda logits: LOGIT_TOL)
    run["phase_s"] = time.perf_counter() - t0
    return run


# -- phase 8: ResNet-50, the vision path -----------------------------------------

RESNET_CONFIG = ROOT / "examples" / "resnet50.toml"
# bf16 logits against the same network in float32 (TF32 off) from the same
# int8-dequantized weights: atol as a share of the float32 logits' largest
# magnitude (the CPU measured 2.2e-3 and 2.6e-3 of it at 224 pixels, 6.7e-3
# on a cut network at 32).
RESNET_LOGIT_REL = 2e-2


def resnet_requests() -> list:
    """The vision path's seeded bodies, each with its decoded items:
    framed yuv420 bodies of 1, 8 and 32 items for ``resnet50`` (wire 160),
    an npy (8, 256, 256, 3) batch and an npy (256, 256, 3) image for
    ``resnet50_rgb``."""
    import io

    import numpy as np

    from tpuserve_torch import frame, preproc

    rng = np.random.default_rng(11)
    out = []
    for n in (1, 8, 32):
        items = [preproc.rgb_to_yuv420(a)
                 for a in rng.integers(0, 256, (n, 160, 160, 3), dtype=np.uint8)]
        out.append(("resnet50", f"frame{n}", frame.encode_frame(items, frame.KIND_YUV420, 160),
                    frame.CONTENT_TYPE, items))
    batch = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    for label, arr in (("npy8", batch), ("npy1", rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))):
        buf = io.BytesIO()
        np.save(buf, arr)
        out.append(("resnet50_rgb", label, buf.getvalue(), "application/x-npy",
                    list(arr) if arr.ndim == 4 else [arr]))
    return out


def drive_resnet(port: int, requests: list) -> dict:
    """The vision path's run: counts to 0, the five bodies, counts read
    back; then a malformed frame (400) and an unknown model (404)."""
    from tpuserve_torch import frame

    check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
    before = call(port, "GET", "/metrics")[1].decode()
    for name, p in json.loads(call(port, "GET", "/stats")[1])["pipeline"]["models"].items():
        arena = p["arena"]
        check(set(arena["buckets"]) == {"[1]", "[8]", "[32]"} and all(
              b["pooled"] == arena["slots_per_bucket"] for b in arena["buckets"].values()),
              f"{name}: the arena did not make every bucket's buffers at start: {arena}")
    answers, walls, first_stages = {}, {}, {}
    for name, label, body, ctype, items in requests:
        before_stages = stage_totals(port, name)
        t0 = time.perf_counter()
        st, raw = call(port, "POST", f"/v1/models/{name}:classify", raw=body, ctype=ctype)
        walls[label] = (time.perf_counter() - t0) * 1e3
        first_stages[label] = stage_delta(before_stages, stage_totals(port, name))
        check(st == 200, f"{name} {label}: {st} {raw[:300]!r}")
        res = json.loads(raw)
        results = res["results"] if "results" in res else [res]
        check(len(results) == len(items) and all(len(r["top_k"]) == 5 for r in results),
              f"{name} {label}: {len(results)} results for {len(items)} items")
        answers[label] = results
    ingest0 = json.loads(call(port, "GET", "/stats")[1])["ingest"]
    st, raw = call(port, "POST", "/v1/models/resnet50:classify", raw=b"TPUF\x01\x00",
                   ctype=frame.CONTENT_TYPE)
    check(st == 400 and json.loads(raw)["error"].startswith("frame:"),
          f"malformed frame answered {st} {raw[:200]!r}, expected 400 frame: ...")
    st, _ = call(port, "POST", "/v1/models/nope:classify", raw=requests[0][2],
                 ctype=frame.CONTENT_TYPE)
    check(st == 404, f"unknown model answered {st}, expected 404")
    stats = json.loads(call(port, "GET", "/stats")[1])
    after = call(port, "GET", "/metrics")[1].decode()
    counts = (stats["kernels"]["flash_attention"]["launches"],
              stats["kernels"]["flash_attention_stats"]["launches"])
    frame_errors = (stats["ingest"]["frame_errors_total"]["resnet50"]
                    - ingest0["frame_errors_total"]["resnet50"])
    delta = {m: {n: metric(after, f'{n}{{model="{m}"}}') - metric(before, f'{n}{{model="{m}"}}')
                 for n in ("batches_total", "items_total", "runtime_compiles_total")}
             for m in ("resnet50", "resnet50_rgb")}
    print(f"slice (resnet50): 5 requests (50 images) answered; K1, K2 launches {counts}; "
          f"frame errors +{frame_errors:g}; per model {delta}; request walls "
          f"{ {k: round(v, 1) for k, v in walls.items()} } ms", flush=True)
    check(counts == (0, 0), f"K1, K2 launched {counts} times on the vision path (0 expected)")
    check(frame_errors == 1, f"frame_errors_total moved by {frame_errors:g}, expected 1")
    want = {"resnet50": (3, 41), "resnet50_rgb": (2, 9)}
    for m, (batches, items) in want.items():
        check((delta[m]["batches_total"], delta[m]["items_total"]) == (batches, items),
              f"{m}: batches/items moved by {delta[m]['batches_total']:g}/"
              f"{delta[m]['items_total']:g}, expected {batches}/{items}")
        check(delta[m]["runtime_compiles_total"] == 0, f"{m}: runtime_compiles_total moved")
    # Each body REPEATS times more: the first request of a bucket against
    # the ones after it, stage by stage.
    repeats = {label: [] for _, label, _, _, _ in requests}
    repeat_stages = {label: [] for _, label, _, _, _ in requests}
    for _ in range(REPEATS):
        for name, label, body, ctype, _ in requests:
            t0 = time.perf_counter()
            before_stages = stage_totals(port, name)
            st, _ = call(port, "POST", f"/v1/models/{name}:classify", raw=body, ctype=ctype)
            repeats[label].append((time.perf_counter() - t0) * 1e3)
            repeat_stages[label].append(stage_delta(before_stages, stage_totals(port, name)))
            check(st == 200, f"repeat of {name} {label} answered {st}")
    print(f"slice (resnet50): repeat walls {repeats} ms", flush=True)
    first_request = first_request_table(first_stages, repeat_stages)
    lat = json.loads(call(port, "GET", "/stats")[1])["latency"]
    phases = {p: lat[f"latency_ms{{model=resnet50,phase={p}}}"]["p50_ms"]
              for p in ("body_read", "parse", "queue", "preproc", "h2d", "compute",
                        "postproc", "total")}
    return {"answers": answers, "walls_ms": walls, "repeat_walls_ms": repeats,
            "first_request": first_request, "launches_k1_k2": list(counts),
            "deltas": delta, "phase_p50_ms_resnet50": phases,
            "ingest": stats["ingest"]}


STAGES = ("body_read", "parse", "queue", "preproc", "h2d", "compute", "postproc", "total")
REPEATS = 8


def stage_totals(port: int, model: str) -> dict:
    """The summed milliseconds of each stage histogram of ``model`` so far
    (``/stats``: mean times count)."""
    lat = json.loads(call(port, "GET", "/stats")[1])["latency"]
    return {p: (lambda row: row["mean_ms"] * row["n"] if row else 0.0)(
        lat.get(f"latency_ms{{model={model},phase={p}}}")) for p in STAGES}


def stage_delta(before: dict, after: dict) -> dict:
    """One request's time per stage: the histograms' sums after it less
    before it (one request at a time, so the delta is that request's; the
    queue stage sums over the request's items). ``service`` is every stage
    but the queue: the adaptive flush's target moves between a first
    request and its repeats, so their queue waits differ by policy."""
    out = {p: round(after[p] - before[p], 3) for p in STAGES}
    out["service"] = round(sum(v for p, v in out.items() if p not in ("queue", "total")), 3)
    return out


# A first request may exceed its repeats in any one stage by at most this:
# large setup work on the request path (building cuDNN plans in the
# request, 190 ms; pinning a frame8 or frame32 arena buffer in the request,
# 16-21 ms; both on the H100) fails it, while the 0.1-2 ms that first calls
# cost in body read, parse and h2d on the H100 pass. That no bucket pins a buffer at its first request is
# held directly (the arena's per-bucket counts before the first request).
FIRST_STAGE_SLACK_MS = 5.0


def first_request_table(first: dict, repeats: dict, name: str = "resnet50") -> dict:
    """Per request: the first one's stages beside its repeats' ranges. The
    bar for the first-request fault: each stage of the first request but
    the queue (the adaptive flush's target moves between a first request
    and its repeats, so their waits differ by policy) within its repeats'
    range plus FIRST_STAGE_SLACK_MS."""
    table = {}
    for label, rows in repeats.items():
        rng = {p: [min(r[p] for r in rows), max(r[p] for r in rows)] for p in rows[0]}
        excess = {p: round(first[label][p] - rng[p][1], 3) for p in STAGES
                  if p not in ("queue", "total")}
        table[label] = {"first": first[label], "repeats_range": rng,
                        "first_over_repeats_max_ms": excess}
    print(f"slice ({name}): first request vs repeats, service ms: "
          f"{ {k: (v['first']['service'], v['repeats_range']['service']) for k, v in table.items()} }",
          flush=True)
    print(json.dumps({"first_request_stages": {name: table}}), flush=True)
    for label, row in table.items():
        worst = max(row["first_over_repeats_max_ms"].items(), key=lambda kv: kv[1])
        check(worst[1] <= FIRST_STAGE_SLACK_MS,
              f"{name} {label}: the first request's {worst[0]} took {worst[1]:.2f} ms over "
              f"its repeats' range (bar {FIRST_STAGE_SLACK_MS} ms); stages {row['first']}, "
              f"repeats {row['repeats_range']}")
    return table


def resnet_operations(model, module) -> int:
    """Multiply-accumulates of one image's forward: every convolution (from
    its output shape, hooked at batch 1) and the head."""
    import torch

    from tpuserve_torch.models.resnet import Conv

    macs = []

    def hook(m, inp, out):
        w = m.weight
        macs.append(out[0].numel() * w.shape[1] * w.shape[2] * w.shape[3])

    handles = [m.register_forward_hook(hook) for m in module.modules() if isinstance(m, Conv)]
    dev = tuple(torch.zeros(s.shape, dtype=torch.uint8, device=module.head.weight.device)
                for s in model.input_signature((1,)))
    with torch.inference_mode():
        module(model.device_preprocess(dev))
    for h in handles:
        h.remove()
    return sum(macs) + module.head.in_features * module.head.out_features


def resnet_model_check(mcfg, requests: list, answers: dict) -> dict:
    """One model of the vision config in-process: served answers equal the
    same seeded model's on the same assembled batches; bf16 logits agree
    with the float32 network on the same (dequantized) weights; times of
    the (32,) forward, its preprocessing and its dequantization; bounds."""
    import dataclasses

    import numpy as np
    import torch

    from tpuserve_torch import quantize
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    model = build(mcfg)
    rt = build_runtime(model, device="cuda")
    mine = [r for r in requests if r[0] == mcfg.name]
    for _, label, _, _, items in mine:
        bucket = model.bucket_for(len(items))
        ref = rt.fetch(rt.run(bucket, model.assemble(items, bucket)))
        for row, served in enumerate(answers[label]):
            check([e["class"] for e in served["top_k"]] == ref["indices"][row].tolist(),
                  f"{mcfg.name} {label}: served top-5 != in-process top-5, row {row}")
            check(np.allclose([e["prob"] for e in served["top_k"]], ref["probs"][row],
                              rtol=0, atol=1e-6),
                  f"{mcfg.name} {label}: served probs != in-process probs, row {row}")

    # The float32 twin: the same network and weights as the forward sees
    # them (int8 dequantized in bf16), run in float32 with TF32 off.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, label, _, _, items = max(mine, key=lambda r: len(r[4]))
    bucket = model.bucket_for(len(items))
    twin = build(dataclasses.replace(mcfg, dtype="float32", quantize=None))
    module32 = twin.build_module()
    module32.load_state_dict({k: v.float() for k, v in quantize.dequantized_state_dict(rt.module).items()})
    module32.eval().requires_grad_(False).to(memory_format=torch.channels_last).to(rt.device)
    with torch.inference_mode():
        dev = rt.h2d(bucket, model.assemble(items, bucket))
        logits = rt.module(model.device_preprocess(dev)).float()[: len(items)]
        logits32 = module32(twin.device_preprocess(dev))[: len(items)]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()) and logits.shape == (len(items), 1000),
          f"{mcfg.name}: logits {tuple(logits.shape)} not finite")
    err = (logits - logits32).abs().max().item()
    tol = RESNET_LOGIT_REL * logits32.abs().max().item()
    check(err <= tol, f"{mcfg.name}: bf16 vs float32 logits differ by {err:.4g} > {tol:.4g}")
    checked = separated_ranks_agree(logits, logits32, f"{mcfg.name} bf16 vs f32", tol)
    print(f"slice (resnet50): {mcfg.name} served answers equal the in-process run; bf16 vs "
          f"float32 (TF32 off) logits max abs diff {err:.4g} (tol {tol:.4g}), {checked} "
          f"separated top-5 ranks agree", flush=True)

    # Times at the (32,) bucket, inputs resident on the card: device time
    # from a CUDA-graph replay (the forward's kernels back to back), stream
    # and host-enqueue time of the eager forward (``forward_timing``), the
    # card's busy and idle time in one profiled eager window
    # (``device_breakdown``).
    bucket = (32,)
    dev = rt.h2d(bucket, tuple(np.random.default_rng(3).integers(0, 256, s.shape, dtype=np.uint8)
                               for s in model.input_signature(bucket)))
    pairs = [(m, n) for m in rt.module.modules()
             if torch.nn.utils.parametrize.is_parametrized(m) for n in m.parametrizations]

    def dequantize_all():
        return [getattr(m, n) for m, n in pairs]

    forward = forward_timing(rt, model, bucket)
    with torch.inference_mode():
        device_ms = graph_ms(lambda: model.forward(rt.module, dev))
        prep_ms = graph_ms(lambda: model.device_preprocess(dev))
        deq_ms = graph_ms(dequantize_all) if pairs else None
        t0 = time.perf_counter()
        for _ in range(20):
            dequantize_all()
        deq_host_ms = (time.perf_counter() - t0) * 1e3 / 20 if pairs else None
        torch.cuda.synchronize()
        breakdown = device_breakdown(lambda: model.forward(rt.module, dev))
    macs = resnet_operations(model, rt.module)
    flops = 2 * macs * bucket[0]
    wire = sum(int(np.prod(s.shape)) for s in model.input_signature(bucket))
    params = rt.describe()["params"]["bytes"]
    nbytes = wire + params + bucket[0] * 5 * (4 + 8)      # probs f32 + indices int64
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    out = {"forward_b32": forward, "forward_device_ms_b32": device_ms,
           "device_idle_share_of_stream": breakdown["idle_share_of_stream"],
           "preprocess_device_ms_b32": prep_ms,
           "preprocess_share_of_forward": prep_ms / device_ms,
           "dequant_device_ms_b32": deq_ms, "dequant_host_ms_b32": deq_host_ms,
           "dequant_share_of_forward": deq_ms / device_ms if pairs else None,
           "quantized_weights": len(pairs), "device_breakdown_b32": breakdown,
           "bound": {"gmac_per_image": macs / 1e9, "operations": flops, "operations_ms": t_ops,
                     "bytes": nbytes, "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "params_bytes": params, "wire_bytes": wire},
           "logits_bf16_vs_f32": {"max_abs_diff": err, "tol": tol,
                                  "separated_ranks_checked": checked}}
    print(f"slice (resnet50): {mcfg.name} (32,): device {device_ms:.3f} ms (graph replay), "
          f"stream {forward['stream_ms']:.3f} ms, enqueue {forward['host_enqueue_ms']:.3f} ms; "
          f"preprocessing {prep_ms:.4f} ms; dequantization {deq_ms or 0:.4f} ms of device, "
          f"{deq_host_ms or 0:.3f} ms of host; bound {max(t_ops, t_bytes):.4f} ms "
          f"({out['bound']['bound_by']}; {macs / 1e9:.3f} GMAC per image); profiled eager "
          f"window: busy {breakdown['total_ms']:.3f} of {breakdown['stream_ms']:.3f} ms, by "
          f"kind { {k: round(v, 3) for k, v in breakdown['ms_by_kind'].items()} } ms",
          flush=True)
    del rt, module32
    torch.cuda.empty_cache()
    return out


def resnet_phase() -> dict:
    from tpuserve_torch import native
    from tpuserve_torch.config import load_config

    t0 = time.perf_counter()
    requests = resnet_requests()
    with serving(RESNET_CONFIG, n_buckets=6) as port:
        run = drive_resnet(port, requests)
    answers = run.pop("answers")
    run["models"] = {m.name: resnet_model_check(m, requests, answers)
                     for m in load_config(str(RESNET_CONFIG)).models}
    run["graphs"] = graph_phase(
        RESNET_CONFIG, {"resnet50": (32,), "resnet50_rgb": (32,)},
        lambda logits: RESNET_LOGIT_REL * logits.abs().max().item())
    run["native_jpeg"] = native.available()
    run["phase_s"] = time.perf_counter() - t0
    return run


# -- phase 9: the versioned lifecycle over HTTP ------------------------------------

def lifecycle_drill(config: Path, name: str, n_buckets: int, body: bytes, ctype: str) -> dict:
    """Serve ``config`` with model ``name``'s weights read from a seed-1
    checkpoint (``save_npz`` of the port's own seeded init, in a temporary
    directory) and drive its lifecycle over HTTP with one fixed request:
    ``:reload`` of a seed-2 checkpoint gives version 2 and other answers;
    ``:rollback`` gives version 1 and answers equal to the first ones; a
    corrupted .npz under a stale manifest answers 409 at ``integrity``, a
    checkpoint with an inf leaf 409 at ``nan_scan``, and version 1 answers
    as before after each; a second ``:reload`` of the seed-2 checkpoint
    gives version 3 and version 2's answers. ``runtime_compiles_total`` and
    the capture count must not move across all of it."""
    from tpuserve_torch import savedmodel
    from tpuserve_torch.config import load_config
    from tpuserve_torch.models import build
    from tpuserve_torch.utils.trees import flatten_with_paths

    model = build(load_config(str(config)).model(name))
    trees = {seed: model.to_jax_params(model.init_params(seed)) for seed in (1, 2)}
    del model
    leaves = dict(flatten_with_paths(trees[2]))
    bad_path = sorted(leaves)[len(leaves) // 2]
    bad_leaf = leaves[bad_path].copy()
    bad_leaf.reshape(-1)[0] = float("inf")
    poisoned = savedmodel.leaves_to_tree({**leaves, bad_path: bad_leaf})
    seen = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / f"{name}.npz")
        savedmodel.save_npz(ckpt, trees[1])
        with serving(config, n_buckets, overrides=(f"model.{name}.weights={ckpt}",)) as port:
            def answer():
                st, raw = call(port, "POST", f"/v1/models/{name}:classify", raw=body, ctype=ctype)
                check(st == 200, f"lifecycle {name}: request answered {st} {raw[:200]!r}")
                return json.loads(raw)

            def admin(verb: str, want: int) -> dict:
                t0 = time.perf_counter()
                st, raw = call(port, "POST", f"/admin/models/{name}:{verb}")
                out = json.loads(raw)
                check(st == want, f"lifecycle {name}: :{verb} answered {st}, expected {want}: "
                      f"{raw[:300]!r}")
                seen.setdefault("admin_ms", []).append((verb, st, (time.perf_counter() - t0) * 1e3))
                return out

            graphs0 = served_graphs(port)[name]
            v1 = answer()
            savedmodel.save_npz(ckpt, trees[2])
            check(admin("reload", 200)["version"] == 2, f"lifecycle {name}: reload is not version 2")
            v2 = answer()
            check(v2 != v1, f"lifecycle {name}: version 2 answers as version 1")
            info = admin("rollback", 200)
            check((info["version"], info["rolled_back_from"]) == (1, 2),
                  f"lifecycle {name}: rollback answered {info}")
            check(answer() == v1, f"lifecycle {name}: rollback does not answer as version 1")
            stale = Path(savedmodel.manifest_path(ckpt)).read_text()
            savedmodel.save_npz(ckpt, trees[1])                # bytes the manifest does not hold
            Path(savedmodel.manifest_path(ckpt)).write_text(stale)
            rej = admin("reload", 409)
            check((rej["stage"], rej["version"]) == ("integrity", 1),
                  f"lifecycle {name}: corrupted checkpoint answered {rej}")
            check(answer() == v1, f"lifecycle {name}: version 1 changed after the integrity rejection")
            savedmodel.save_npz(ckpt, poisoned)
            rej = admin("reload", 409)
            check((rej["stage"], rej["version"]) == ("nan_scan", 1) and bad_path in rej["error"],
                  f"lifecycle {name}: inf checkpoint answered {rej}")
            check(answer() == v1, f"lifecycle {name}: version 1 changed after the nan_scan rejection")
            savedmodel.save_npz(ckpt, trees[2])
            check(admin("reload", 200)["version"] == 3, f"lifecycle {name}: second reload not version 3")
            check(answer() == v2, f"lifecycle {name}: version 3 does not answer as version 2 did")
            graphs1 = served_graphs(port)[name]
            check((graphs1["captures_total"], graphs1["compiles_total"])
                  == (graphs0["captures_total"], graphs0["compiles_total"]),
                  f"lifecycle {name}: captures/compiles moved {graphs0} -> {graphs1}")
            versions = json.loads(call(port, "GET", f"/admin/models/{name}/versions")[1])
            # The drill in the audit trail (newest first) and in the event
            # plane's lifecycle events.
            audit = json.loads(call(port, "GET", "/debug/audit")[1])["audit"]
            trail = [(a["verb"], a["outcome"], a.get("stage")) for a in reversed(audit)
                     if a["target"] == name]
            check(trail == [("reload", "ok", None), ("rollback", "ok", None),
                            ("reload", "rejected", "integrity"), ("reload", "rejected", "nan_scan"),
                            ("reload", "ok", None)], f"lifecycle {name}: audit trail {trail}")
            evs = json.loads(call(port, "GET", "/debug/events?subsystem=lifecycle")[1])["events"]
            kinds = [e["event"] for e in evs if e.get("model") == name]
            check(kinds.count("published") == 2 and kinds.count("rolled_back") == 1
                  and kinds.count("reload_rejected") == 2,
                  f"lifecycle {name}: lifecycle events {kinds}")
            seen["audit"] = trail
            seen["lifecycle_events"] = kinds
    seen.update({"captures_total": graphs1["captures_total"],
                 "compiles_total": graphs1["compiles_total"],
                 "history": [h["status"] for h in versions["history"]],
                 "live_version": versions["live_version"], "nan_leaf": bad_path})
    print(f"lifecycle: {name}: reload v2, rollback to v1 (answers as before), integrity and "
          f"nan_scan rejected with v1 answering as before, reload v3; captures "
          f"{graphs1['captures_total']} and compiles {graphs1['compiles_total']:g} unchanged; "
          f"admin calls (verb, status, ms) {[(v, s_, round(ms)) for v, s_, ms in seen['admin_ms']]}",
          flush=True)
    return seen


def lifecycle_phase() -> dict:
    """The drill on BERT-flash and on the int8 ResNet-50."""
    texts = json.dumps({"texts": TEXTS_8}).encode()
    _, _, framed, ctype, _ = resnet_requests()[1]                # 8 framed yuv420 items
    return {"bert_flash": lifecycle_drill(CONFIG, "bert", 6, texts, "application/json"),
            "resnet50_int8": lifecycle_drill(RESNET_CONFIG, "resnet50", 6, framed, ctype)}


# -- phase 10: the batcher's robustness layer and the result cache -------------------

# Robustness drill knobs: the periodic canary (the breaker's recovery probe),
# the lone-text sample and the retry drill's load.
CANARY_S = 2.0
RETRY_CLIENTS, RETRY_PER_CLIENT = 4, 50
POISON_TEXT = "a poison marker text the wrapper refuses to assemble"


class _PoisonModel:
    """Delegating wrapper whose assembly raises when the marked item is in
    the batch: the whole-batch failure a single bad request induces."""

    def __init__(self, inner, marked: str) -> None:
        self._inner = inner
        self._marked = marked

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def assemble(self, items, bucket):
        from tpuserve_torch.cache import item_digest

        if any(item_digest(it) == self._marked for it in items):
            raise RuntimeError("poison item in batch: " + POISON_TEXT)
        return self._inner.assemble(items, bucket)


def _post_json(port: int, obj) -> tuple[int, bytes, str | None]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/models/bert:classify", body=json.dumps(obj).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Retry-After")
    finally:
        conn.close()


def _counter(state, name: str) -> float:
    return state.metrics.counter(f"{name}{{model=bert}}").value


def _variant_batches(state) -> float:
    return sum(v for k, v in state.metrics.summary()["counters"].items()
               if k.startswith("runtime_variant_batches_total{model=bert,"))


def _p50(xs: list) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


async def _robust_async(state, port: int) -> dict:
    """The in-process drills on the served BERT-flash (see robustness_phase)."""
    import asyncio

    from tpuserve_torch.batcher import ModelBatcher
    from tpuserve_torch.cache import item_digest
    from tpuserve_torch.config import AdaptiveConfig
    from tpuserve_torch.faults import FaultInjector
    from tpuserve_torch.ops import flash_attention as fa

    loop = asyncio.get_running_loop()
    rt, model, br = state.runtimes["bert"], state.models["bert"], state.breakers["bert"]
    b_adaptive = state.batchers["bert"]
    out: dict = {}

    async def post(obj):
        return await loop.run_in_executor(None, _post_json, port, obj)

    def new_batcher(m=model, adaptive=None):
        return ModelBatcher(m, rt, state.metrics, stages=state.stages,
                            pipeline_cfg=state.cfg.pipeline,
                            adaptive_cfg=adaptive or state.cfg.adaptive, breaker=br,
                            injector=state.injector)

    async def lone_run() -> tuple[list, list, list]:
        """Every text of TEXTS_32 alone, one after the other: bodies, client
        walls and the server's total per request."""
        bodies, walls, totals = [], [], []
        hist = state.metrics.histogram("latency_ms{model=bert,phase=total}")
        for t in TEXTS_32:
            before = hist.total
            t0 = time.perf_counter()
            st, body, _ = await post({"text": t})
            walls.append((time.perf_counter() - t0) * 1e3)
            totals.append(hist.total - before)
            check(st == 200, f"robustness: lone text answered {st} {body[:200]!r}")
            bodies.append(body)
        return bodies, walls, totals

    captures0, compiles0 = rt.captures_total, rt.compiles_total
    fa.reset_launches()
    variants0 = _variant_batches(state)

    # Adaptive flush: the fixed 10 ms deadline first (a batcher with
    # [adaptive] enabled = false on the same graphs), then the reference's
    # default, the same texts in the same order.
    b_fixed = new_batcher(adaptive=AdaptiveConfig(enabled=False))
    await b_fixed.start()
    state.batchers["bert"] = b_fixed
    fixed_bodies, fixed_walls, fixed_totals = await lone_run()
    state.batchers["bert"] = b_adaptive
    await b_fixed.stop()
    target = state.metrics.gauge("adaptive_target_batch{model=bert}")
    bodies1, walls, totals = await lone_run()
    check(bodies1 == fixed_bodies,
          "robustness: lone answers under the adaptive flush differ from the fixed flush's")
    target_lone = target.value

    def burst_client(n):
        return [_post_json(port, {"texts": TEXTS_8})[0] for _ in range(n)]

    burst = await asyncio.gather(*(loop.run_in_executor(None, burst_client, 10) for _ in range(4)))
    check(all(s == 200 for part in burst for s in part), "robustness: burst answered non-200")
    target_burst = target.value
    out["adaptive"] = {
        "lone_total_p50_ms": {"fixed": _p50(fixed_totals), "adaptive": _p50(totals),
                              "adaptive_last20": _p50(totals[-20:])},
        "lone_wall_p50_ms": {"fixed": _p50(fixed_walls), "adaptive": _p50(walls),
                             "adaptive_last20": _p50(walls[-20:])},
        "target_after_lone": target_lone,
        "target_after_burst": target_burst, "bit_identical_to_fixed": True}
    print(f"robustness: lone BERT text total p50 {_p50(fixed_totals):.2f} ms fixed flush, "
          f"{_p50(totals):.2f} ms adaptive ({_p50(totals[-20:]):.2f} over the last 20); "
          f"adaptive_target_batch {target_lone:g} after the lone texts, "
          f"{target_burst:g} after a 4-client burst; answers bit-identical", flush=True)

    # Baselines: each text's answer in each bucket it may be served in
    # (alone: (1, 64); in eights: (8, 64); all 32: (32, 64)), no fault.
    base = {t: {1: json.loads(b)} for t, b in zip(TEXTS_32, bodies1)}
    for i in range(0, 32, 8):
        st, body, _ = await post({"texts": TEXTS_32[i:i + 8]})
        check(st == 200, f"robustness: baseline batch of 8 answered {st}")
        for t, r in zip(TEXTS_32[i:i + 8], json.loads(body)["results"]):
            base[t][8] = r
    st, body, _ = await post({"texts": TEXTS_32})
    check(st == 200, f"robustness: baseline batch of 32 answered {st}")
    for t, r in zip(TEXTS_32, json.loads(body)["results"]):
        base[t][32] = r
    bucket_invariant = all(v[1] == v[8] == v[32] for v in base.values())

    def matches(t, r) -> bool:
        return r in base[t].values()

    # Retry: batch_error at probability 0.1 (seed 1) under 4 clients. The
    # served h2d phase runs from the end of assembly to the end of the h2d
    # stage, so it holds the wait for a staging slot: time that wait apart.
    retries0 = _counter(state, "batch_retries_total")
    h2d_hist = state.metrics.histogram("latency_ms{model=bert,phase=h2d}")
    h2d0 = (h2d_hist.total, h2d_hist.n)
    staging_waits: list[float] = []
    acquire = b_adaptive._acquire_staging

    async def timed_acquire(reqs):
        t0 = time.perf_counter()
        try:
            return await acquire(reqs)
        finally:
            staging_waits.append((time.perf_counter() - t0) * 1e3)

    b_adaptive._acquire_staging = timed_acquire
    state.injector.set_enabled(True)

    def retry_client(n):
        got = []
        for _ in range(n):
            st, body, _ = _post_json(port, {"texts": TEXTS_32})
            got.append((st, body))
        return got

    parts = await asyncio.gather(*(loop.run_in_executor(None, retry_client, RETRY_PER_CLIENT)
                                   for _ in range(RETRY_CLIENTS)))
    state.injector.set_enabled(False)
    b_adaptive._acquire_staging = acquire
    h2d_n = h2d_hist.n - h2d0[1]
    h2d_split = {"batches": h2d_n, "h2d_phase_mean_ms": (h2d_hist.total - h2d0[0]) / h2d_n,
                 "staging_wait_mean_ms": sum(staging_waits) / len(staging_waits)}
    h2d_split["h2d_stage_mean_ms"] = h2d_split["h2d_phase_mean_ms"] - h2d_split["staging_wait_mean_ms"]
    results = [r for part in parts for r in part]
    ok = [json.loads(b)["results"] for st, b in results if st == 200]
    availability = len(ok) / len(results)
    fired = sum(r["fired"] for r in state.injector.snapshot())
    mismatched = sum(not matches(t, r) for res in ok for t, r in zip(TEXTS_32, res))
    out["retry"] = {"requests": len(results), "availability": availability,
                    "statuses": sorted({st for st, _ in results}), "batch_errors_fired": fired,
                    "batch_retries": _counter(state, "batch_retries_total") - retries0,
                    "breaker": br.describe(), "answers_not_bit_identical": mismatched,
                    "answers_bucket_invariant": bucket_invariant, "h2d_under_4_clients": h2d_split}
    print(f"robustness: retry drill {len(results)} requests of 32 texts, availability "
          f"{availability:.4f}, batch_error fired {fired}, retries "
          f"{out['retry']['batch_retries']:g}, breaker {br.state}; answers differing from the "
          f"no-fault ones {mismatched} (bucket-invariant answers: {bucket_invariant}); h2d phase "
          f"{h2d_split['h2d_phase_mean_ms']:.3f} ms mean over {h2d_n:g} batches, of which "
          f"{h2d_split['staging_wait_mean_ms']:.3f} ms waiting for a staging slot", flush=True)
    check(availability >= 0.99, f"robustness: availability {availability:.4f} < 0.99")
    check(fired > 5, f"robustness: batch_error fired only {fired} times")
    check(br.state == "closed" and br.opened_total == 0,
          f"robustness: the breaker left closed in the retry drill: {br.describe()}")
    check(mismatched == 0, f"robustness: {mismatched} retried answers differ from no-fault ones")

    # Poison bisection, in-process: a full 32-batch with one marked text.
    texts = TEXTS_32[:31] + [POISON_TEXT]
    items, _ = model.host_decode_items(json.dumps({"texts": texts}).encode(), "application/json")
    b_poison = new_batcher(m=_PoisonModel(model, item_digest(items[-1])))
    await b_poison.start()
    check(b_poison.arena is None, "robustness: the poison wrapper must take the allocating path")
    poison0, retries0 = _counter(state, "poison_items_total"), _counter(state, "batch_retries_total")
    futs = [b_poison.submit(it, group=model.group_key(it)) for it in items]
    got = await asyncio.gather(*futs, return_exceptions=True)
    await b_poison.stop()
    good = [r for r in got[:31] if isinstance(r, dict)]
    poison_err = got[31]
    out["poison"] = {
        "answered": len(good), "bit_identical": sum(matches(t, r) for t, r in zip(texts, good)),
        "differing_indices": [i for i, (t, r) in enumerate(zip(texts, good)) if not matches(t, r)],
        "error": str(poison_err),
        "poison_items": _counter(state, "poison_items_total") - poison0,
        "batch_retries": _counter(state, "batch_retries_total") - retries0}
    print(f"robustness: poison bisection {out['poison']}", flush=True)
    check(len(good) == 31 and out["poison"]["bit_identical"] == 31,
          f"robustness: poison bisection answered {out['poison']}")
    check(isinstance(poison_err, RuntimeError) and POISON_TEXT in str(poison_err),
          f"robustness: the poison's error does not name it: {poison_err!r}")
    check((out["poison"]["poison_items"], out["poison"]["batch_retries"]) == (1, 1),
          f"robustness: poison/retry counters moved {out['poison']}")

    # Watchdog: kill the group loop once; the sweep revives it.
    b_adaptive.injector = FaultInjector.single("kill_group_loop", model="bert", count=1)
    st, _, _ = await post({"text": TEXTS_32[0]})
    restarts = state.metrics.counter("watchdog_restarts_total{model=bert,component=group_loop}")
    t0 = time.perf_counter()
    while restarts.value < 1 and time.perf_counter() - t0 < 10:
        await asyncio.sleep(0.1)
    b_adaptive.injector = state.injector
    st2, body, _ = await post({"text": TEXTS_32[1]})
    out["watchdog"] = {"restarts": restarts.value, "statuses": [st, st2]}
    print(f"robustness: watchdog restarts {restarts.value:g} after kill_group_loop; "
          f"statuses {[st, st2]}", flush=True)
    check(restarts.value >= 1 and [st, st2] == [200, 200] and json.loads(body) == base[TEXTS_32[1]][1],
          f"robustness: watchdog {out['watchdog']}")

    # Breaker and soak_breaker: reload the seed-1 checkpoint (version 2),
    # then every dispatch fails (device_error at probability 1) inside the
    # soak window.
    st, body = await loop.run_in_executor(None, call, port, "POST", "/admin/models/bert:reload")
    check(st == 200 and json.loads(body)["version"] == 2, f"robustness: reload answered {st} {body[:300]!r}")
    while state._next_canary_at is None or state._next_canary_at - time.monotonic() < 1.0:
        await asyncio.sleep(0.05)  # trip the breaker between two canaries
    transitions = [br.state]
    rt.injector = FaultInjector.single("device_error", model="bert")
    first = []
    while br.state == "closed" and len(first) < 10:
        first.append((await post({"text": TEXTS_32[2]}))[0])
    transitions.append(br.state)
    # While open, no request is decoded or submitted (requests_total counts
    # the ones past the shed checks); only the canaries, the recovery probe,
    # dispatch (batches_total).
    requests0, batches0 = _counter(state, "requests_total"), _counter(state, "batches_total")
    t0 = time.perf_counter()
    sheds = [await post({"text": TEXTS_32[2]}) for _ in range(20)]
    shed_s = time.perf_counter() - t0
    shed_requests = _counter(state, "requests_total") - requests0
    shed_batches = _counter(state, "batches_total") - batches0
    lc = state.lifecycles["bert"]
    t0 = time.perf_counter()
    while rt.version != 1 and time.perf_counter() - t0 < 5:
        await asyncio.sleep(0.05)
    soak = {"version": rt.version,
            "rollbacks_soak_breaker": state.metrics.counter(
                "rollbacks_total{model=bert,reason=soak_breaker}").value,
            "history": [(h["version"], h["status"], h.get("reason")) for h in lc.history]}
    rt.injector = state.injector
    t0 = time.perf_counter()
    seen = set()
    while br.state != "closed" and time.perf_counter() - t0 < 2 * CANARY_S + 2:
        seen.add(br.state)
        await asyncio.sleep(0.01)
    transitions += sorted(seen - {transitions[-1]}) + [br.state]
    recovered_s = time.perf_counter() - t0
    st, body, _ = await post({"text": TEXTS_32[2]})
    out["breaker"] = {
        "failed_before_open": first, "transitions": transitions,
        "shed": sorted({(s_, ra, b"circuit open" in b_) for s_, b_, ra in sheds}),
        "shed_window_s": shed_s, "requests_past_shed_while_open": shed_requests,
        "canary_batches_while_open": shed_batches,
        "recovered_s": recovered_s, "after": st, "describe": br.describe()}
    out["soak"] = soak
    print(f"robustness: breaker {out['breaker']}", flush=True)
    print(f"robustness: soak {soak}", flush=True)
    check(first == [500] * state.cfg.models[0].breaker_threshold,
          f"robustness: requests before the breaker opened answered {first}")
    check(all(s_ == 503 and ra is not None and 1 <= int(ra) <= math.ceil(CANARY_S)
              and b"circuit open" in b_ for s_, b_, ra in sheds),
          f"robustness: sheds while open {out['breaker']['shed']}")
    check(shed_requests == 0, f"robustness: {shed_requests:g} requests reached the batcher "
          "while the breaker was open")
    check(soak["version"] == 1 and soak["rollbacks_soak_breaker"] == 1,
          f"robustness: soak_breaker did not roll back: {soak}")
    check(br.state == "closed" and st == 200 and json.loads(body) == base[TEXTS_32[2]][1],
          f"robustness: recovery {out['breaker']} answered {st} {body[:200]!r}")

    out["k1_launches"], out["variant_batches"] = fa.launches, _variant_batches(state) - variants0
    out["captures_delta"] = rt.captures_total - captures0
    out["compiles_delta"] = rt.compiles_total - compiles0
    check(out["k1_launches"] == 12 * out["variant_batches"] and out["variant_batches"] > 0,
          f"robustness: K1 launched {out['k1_launches']} times for {out['variant_batches']:g} "
          "dispatched batches (12 per batch)")
    check(out["captures_delta"] == 0 and out["compiles_delta"] == 0,
          f"robustness: captures/compiles moved by {out['captures_delta']}/{out['compiles_delta']}")
    return out


def robustness_subprocess(ckpt: str) -> dict:
    """Cache, ingest loops and drain through ``python -m tpuserve_torch
    serve`` on ``examples/bert_flash.toml`` with ``[cache]`` on, two accept
    loops and a 200 ms slow_dispatch (so requests are in flight when SIGTERM
    lands)."""
    import threading

    out: dict = {}
    extra = ('[faults]\nenabled = true\n[[faults.rule]]\nkind = "slow_dispatch"\n'
             'model = "bert"\ndelay_ms = 200.0\n')
    with serving(CONFIG, 6, overrides=(f"model.bert.weights={ckpt}", "cache.enabled=true",
                                       "ingest_loops=2", "drain_timeout_s=30"),
                 extra_toml=extra, with_proc=True) as (port, proc):
        def cache_counts():
            return json.loads(call(port, "GET", "/stats")[1])["cache"]["bert"]

        graphs0 = served_graphs(port)["bert"]
        c0 = cache_counts()
        st1, b1, _ = _post_json(port, {"text": TEXTS_32[3]})
        st2, b2, _ = _post_json(port, {"text": TEXTS_32[3]})
        c1 = cache_counts()
        st3, b3, _ = _post_json(port, {"texts": [TEXTS_32[4]] * 8})
        c2 = cache_counts()
        check(call(port, "POST", "/admin/models/bert:reload")[0] == 200, "robustness: reload refused")
        st4, b4, _ = _post_json(port, {"text": TEXTS_32[3]})
        c3 = cache_counts()
        delta = {k: {ev: c[ev] - c0[ev] for ev in ("hits", "misses", "coalesced", "stale_drops")}
                 for k, c in (("repeat", c1), ("eight_identical", c2), ("after_reload", c3))}
        out["cache"] = {"statuses": [st1, st2, st3, st4], "hit_body_identical": b1 == b2,
                        "counters": delta}
        print(f"robustness: cache {out['cache']}", flush=True)
        check([st1, st2, st3, st4] == [200] * 4 and b1 == b2 and b4 == b1,
              f"robustness: cache answers {out['cache']}")
        check(delta["repeat"] == {"hits": 1, "misses": 1, "coalesced": 0, "stale_drops": 0},
              f"robustness: cache repeat {delta['repeat']}")
        check((delta["eight_identical"]["misses"] - 1, delta["eight_identical"]["coalesced"])
              == (1, 7), f"robustness: 8 identical texts {delta['eight_identical']}")
        check(delta["after_reload"]["misses"] == 3, f"robustness: after reload {delta['after_reload']}")

        # Ingest loops: fresh connections spread over both listeners.
        for _ in range(24):
            call(port, "GET", "/healthz")
            check(_post_json(port, {"text": TEXTS_32[3]})[0] == 200, "robustness: ingest request")
        loops = json.loads(call(port, "GET", "/stats")[1])["ingest"]["loops"]
        out["ingest_loops"] = loops
        print(f"robustness: ingest loops {loops}", flush=True)
        check(set(loops) == {"0", "1"} and all(v["requests"] > 0 for v in loops.values()),
              f"robustness: an ingest loop served nothing: {loops}")
        graphs1 = served_graphs(port)["bert"]
        check((graphs1["captures_total"], graphs1["compiles_total"])
              == (graphs0["captures_total"], graphs0["compiles_total"]),
              f"robustness: captures/compiles moved {graphs0} -> {graphs1}")

        # Drain: SIGTERM with requests in flight.
        inflight: list = []

        def client(i):
            inflight.append(_post_json(port, {"text": TEXTS_32[10 + i]})[:2])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.1)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.05)
        late = [_post_json(port, {"text": TEXTS_32[20 + i]}) for i in range(3)]
        health = call(port, "GET", "/healthz")
        for t in threads:
            t.join(60)
        rc = proc.wait(60)
        exit_s = time.perf_counter() - t_term
        out["drain"] = {
            "accepted": [s_ for s_, _ in inflight],
            "late": sorted({(s_, ra, b"draining" in b_) for s_, b_, ra in late}),
            "healthz": [health[0], json.loads(health[1])["status"]],
            "exit_code": rc, "exit_s": exit_s}
        print(f"robustness: drain {out['drain']}", flush=True)
        check(out["drain"]["accepted"] == [200] * 4, f"robustness: drain {out['drain']}")
        check(out["drain"]["late"] == [(503, "1", True)], f"robustness: drain {out['drain']}")
        check(out["drain"]["healthz"] == [503, "draining"] and rc == 0 and exit_s < 30,
              f"robustness: drain {out['drain']}")
    return out


def robustness_phase() -> dict:
    """The batcher's robustness layer and the result cache on the served
    BERT-flash at full width (``examples/bert_flash.toml``, no ``[adaptive]``
    table: the reference's default, the adaptive flush, applies).

    In-process (a ServerState on the card, HTTP from client threads):
    lone texts under the fixed and the adaptive flush (bit-identical
    answers, the total p50 of each); a 4-client burst; per-bucket no-fault
    baselines; a retry drill (batch_error at probability 0.1, seed 1, 4
    clients x 50 requests of 32 texts: availability >= 0.99, the breaker
    closed, every answer bit-identical to a no-fault one); poison bisection
    of a full 32-batch with one marked text (31 answers bit-identical, one
    error naming the poison, poison_items_total and batch_retries_total 1);
    a killed group loop revived by the watchdog; the breaker (device_error
    at probability 1 inside the soak window of a reload of the seed-1
    checkpoint: 5 failures, fast 503 + Retry-After and no dispatch while
    open, rollback for soak_breaker, then the canary closes it and version
    1 answers as before); K1 launches = 12 x the batches the runtime
    dispatched, and no capture or compile. Then the cache, two ingest loops
    and the SIGTERM drain in a serving subprocess."""
    import asyncio

    from tpuserve_torch import savedmodel
    from tpuserve_torch.config import FaultRuleConfig, FaultsConfig, load_config
    from tpuserve_torch.models import build
    from tpuserve_torch.server import ServerState, start_server, stop_server

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "bert.npz")
        m = build(load_config(str(CONFIG)).model("bert"))
        savedmodel.save_npz(ckpt, m.to_jax_params(m.init_params(1)))
        del m
        cfg = load_config(str(CONFIG), [f"model.bert.weights={ckpt}",
                                        f"canary_interval_s={CANARY_S}",
                                        "lifecycle.soak_s=120", "lifecycle.soak_poll_s=0.05"])
        check(cfg.adaptive.enabled and cfg.model("bert").batch_retry and not cfg.cache.enabled,
              "robustness: bert_flash.toml must take the reference's robustness defaults")
        cfg.faults = FaultsConfig(enabled=True, seed=1, rules=[
            FaultRuleConfig(kind="batch_error", model="bert", probability=0.1)])
        state = ServerState(cfg, device="cuda")
        state.build()
        state.injector.set_enabled(False)

        async def go():
            server = await start_server(state, "127.0.0.1", 0)
            try:
                return await _robust_async(state, state.serving_addresses[0][1])
            finally:
                await stop_server(state, server)

        out = asyncio.run(go())
        del state, go
        out.update(robustness_subprocess(ckpt))
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 11: the observability plane, served ---------------------------------------

# The observability phase's server: bert_flash.toml with a latency objective
# and a sampler fast enough to read rates and utilization within seconds.
OBS_TOML = """
[model.slo]
latency_ms = 50.0
availability = 0.99

[telemetry]
sample_interval_s = 0.25
utilization_window_s = 2.0
burn_windows_s = [5.0, 30.0, 300.0]
"""
# The same file with the planes the reference turns on by default off.
OBS_OFF_TOML = """
[telemetry]
enabled = false

[events]
enabled = false

[trace]
slow_n = 0
error_capacity = 0
"""
TRACE_PHASES = ("body_read", "parse", "queue", "preproc", "h2d", "compute", "postproc")
# Spans are taken from two clocks (wall for starts, perf_counter for
# lengths): neighbours may overlap by this much.
SPAN_SLACK_US = 200.0
# K1 and K2 by their kernels' names (the template's last argument is kStats).
K1_NAME = re.compile(r"flash_fwd_\w+<[^<>]*false>")


def call_h(port, method, path, obj=None, raw=None, ctype="application/json",
           headers=None) -> tuple[int, bytes, dict]:
    """``call`` with request headers, returning the response headers too."""
    body = raw if raw is not None else (json.dumps(obj).encode() if obj is not None else None)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": ctype, **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def trace_tree_check(port: int) -> dict:
    """A well-formed X-Trace-Id comes back and names the request's span tree
    (``request`` at the root, the seven phases under it, in order, summing
    to no more than the root); a malformed one is replaced; a 400 leaves a
    ``request_error`` event under its trace id; /debug/slow holds entries."""
    tid = "5a" * 16
    st, raw, hdr = call_h(port, "POST", "/v1/models/bert:classify",
                          {"text": "trace this text please"}, headers={"X-Trace-Id": tid})
    check(st == 200 and hdr.get("X-Trace-Id") == tid,
          f"a well-formed X-Trace-Id was not adopted: {st} {hdr.get('X-Trace-Id')}")
    st, _, hdr = call_h(port, "POST", "/v1/models/bert:classify", {"text": "and this one"},
                        headers={"X-Trace-Id": "not-a-trace-id"})
    fresh = hdr.get("X-Trace-Id", "")
    check(st == 200 and re.fullmatch(r"[0-9a-f]{32}", fresh) is not None,
          f"a malformed X-Trace-Id was not replaced by a fresh id: {fresh!r}")
    st, raw = call(port, "GET", f"/debug/trace?trace_id={tid}&format=record")
    check(st == 200, f"/debug/trace?trace_id= answered {st}")
    spans = json.loads(raw)["spans"]
    roots = [s for s in spans if s["name"] == "request"]
    check(len(roots) == 1 and roots[0]["parent_id"] is None, f"no single root span: {roots}")
    root = roots[0]
    by = {s["name"]: s for s in spans}
    missing = [p for p in TRACE_PHASES if p not in by]
    check(not missing, f"span tree lacks {missing}: {sorted(by)}")
    check(all(by[p]["parent_id"] == root["span_id"] for p in TRACE_PHASES),
          "a phase span does not hang off the request span")
    for a, b in zip(TRACE_PHASES, TRACE_PHASES[1:]):
        check(by[b]["ts_us"] >= by[a]["ts_us"] + by[a]["dur_us"] - SPAN_SLACK_US,
              f"span {b} starts before {a} ends: {by[a]} {by[b]}")
    phase_us = sum(by[p]["dur_us"] for p in TRACE_PHASES)
    check(phase_us <= root["dur_us"] + SPAN_SLACK_US,
          f"phases sum to {phase_us:.0f} us > the request's {root['dur_us']:.0f} us")
    check(by[TRACE_PHASES[0]]["ts_us"] >= root["ts_us"] - SPAN_SLACK_US
          and by["postproc"]["ts_us"] + by["postproc"]["dur_us"]
          <= root["ts_us"] + root["dur_us"] + SPAN_SLACK_US, "phases outside the request span")
    st, raw, hdr = call_h(port, "POST", "/v1/models/bert:classify", raw=b"{not json")
    bad = hdr.get("X-Trace-Id")
    check(st == 400 and json.loads(raw).get("trace_id") == bad,
          f"the 400's body and X-Trace-Id disagree: {raw[:200]!r} {bad}")
    evs = json.loads(call(port, "GET", f"/debug/events?trace_id={bad}")[1])["events"]
    check(any(e["event"] == "request_error" and e["fields"]["status"] == 400 for e in evs),
          f"no request_error event under the 400's trace id: {evs}")
    slow = json.loads(call(port, "GET", "/debug/slow")[1])
    check(slow["slow"].get("bert") and slow["errors"], "/debug/slow holds no entries")
    tree = {p: round(by[p]["dur_us"] / 1e3, 3) for p in TRACE_PHASES}
    print(f"observability: X-Trace-Id adopted and a malformed one replaced; span tree of one "
          f"text (ms) {tree}, request {root['dur_us'] / 1e3:.3f} ms; the 400 left a "
          f"request_error event; /debug/slow holds {len(slow['slow']['bert'])} slow and "
          f"{len(slow['errors'])} errored trees", flush=True)
    return {"span_ms": tree, "request_ms": root["dur_us"] / 1e3}


def profile_check(data: dict) -> dict:
    """The merged trace of a served window: device events on the ring's
    clock, K1 by name, each K1 inside the capture window and inside a
    served batch's ring span, and K1's count beside 12 per batch."""
    meta = data["tpuserve_profile"]
    check(meta["device_trace"] == "ok", f"profile: device_trace {meta['device_trace']!r}")
    lo, hi = meta["window_us"]
    evs = data["traceEvents"]
    k1 = [e for e in evs if e.get("pid", 0) >= 1000 and e.get("cat") == "kernel"
          and K1_NAME.search(e.get("name", ""))]
    batches = [e for e in evs if e.get("pid") == 0 and e["name"].startswith("batch[")
               and e["tid"] == "bert"]
    check(k1, f"profile: no K1 kernel event among {meta['device_events']} device events")
    outside = [e for e in k1 if not (lo <= e["ts"] and e["ts"] + e["dur"] <= hi)]
    check(not outside, f"profile: {len(outside)} K1 events outside the capture window")
    in_batch = [e for e in k1 if any(b["ts"] <= e["ts"] and e["ts"] + e["dur"] <= b["ts"] + b["dur"]
                                     for b in batches)]
    hit = {b["args"]["batch"] for b in batches
           if any(b["ts"] <= e["ts"] <= b["ts"] + b["dur"] for e in k1)}
    share = len(in_batch) / len(k1)
    out = {"device_events": meta["device_events"], "ring_events": meta["ring_events"],
           "k1_events": len(k1), "k1_inside_a_batch_span": share,
           "batches_with_k1": len(hit), "k1_per_batch": len(k1) / max(1, len(hit)),
           "k1_name": k1[0]["name"][:80], "window_ms": (hi - lo) / 1e3}
    print(f"observability: /debug/profile: {meta['device_events']} device events beside "
          f"{meta['ring_events']} ring spans over {out['window_ms']:.0f} ms; {len(k1)} K1 "
          f"events ({out['k1_name']}), all inside the window, {share:.1%} inside a served "
          f"batch's span; {len(hit)} batches ran them ({out['k1_per_batch']:.2f} per batch, 12 "
          f"expected)", flush=True)
    check(share >= 0.95, f"profile: only {share:.1%} of K1 events fall inside a batch span "
                         "(device lanes off the ring's clock?)")
    check(abs(len(k1) - 12 * len(hit)) <= 24,
          f"profile: {len(k1)} K1 events for {len(hit)} batches (12 per batch)")
    return out


def observability_phase(card: str) -> dict:
    """Serve bert_flash.toml with a latency objective and a fast sampler:
    tracing (``trace_tree_check``), then 4 clients of 32-text batches and,
    under that load, history, utilization, alerts and a device profile
    (with a second, concurrent capture refused), K1 counted through the
    replays; captures and compiles unchanged across it all."""
    import threading

    t0 = time.perf_counter()
    with serving(CONFIG, n_buckets=6, extra_toml=OBS_TOML) as port:
        out = {"card": card, "trace": trace_tree_check(port)}
        graphs0 = served_graphs(port)["bert"]
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
        before = call(port, "GET", "/metrics")[1].decode()
        stop, statuses = threading.Event(), []

        def client():
            while not stop.is_set():
                statuses.append(call(port, "POST", "/v1/models/bert:classify",
                                     {"texts": TEXTS_32})[0])

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            time.sleep(3.0)                          # > the 2 s utilization window
            text = call(port, "GET", "/metrics")[1].decode()
            util = metric(text, 'device_utilization{model="bert",replica="0"}')
            prof = {}
            capture = threading.Thread(target=lambda: prof.update(
                r=call(port, "POST", "/debug/profile?duration_ms=1000")))
            capture.start()
            time.sleep(0.3)
            busy = call(port, "POST", "/debug/profile?duration_ms=50")[0]
            capture.join()
        finally:
            stop.set()
            for t in threads:
                t.join()
        check(set(statuses) == {200}, f"load answered {sorted(set(statuses))}")
        check(busy == 409, f"a second concurrent capture answered {busy}, expected 409")
        st, raw = prof["r"]
        check(st == 200, f"/debug/profile answered {st} {raw[:300]!r}")
        out["profile"] = profile_check(json.loads(raw))
        stats = json.loads(call(port, "GET", "/stats")[1])
        after = call(port, "GET", "/metrics")[1].decode()
        batches = (metric(after, 'batches_total{model="bert"}')
                   - metric(before, 'batches_total{model="bert"}'))
        launches = stats["kernels"]["flash_attention"]["launches"]
        check(launches == 12 * batches, f"K1 launched {launches} times for {batches:g} batches")
        graphs1 = served_graphs(port)["bert"]
        check((graphs1["captures_total"], graphs1["compiles_total"])
              == (graphs0["captures_total"], graphs0["compiles_total"]),
              f"captures/compiles moved across the capture: {graphs0} -> {graphs1}")
        check(0.0 < util <= 1.0, f"device_utilization under load read {util}")
        series = json.loads(call(port, "GET", "/stats/history?metric=batches_total&window_s=5")[1])
        rate = series["series"][0]["window_rate_per_s"]
        check(rate > 0, f"/stats/history gives batches_total a rate of {rate}")
        alerts = json.loads(call(port, "GET", "/alerts")[1])
        check("bert" in alerts["models"], f"/alerts lists no objective for bert: {alerts}")
        missing = [b for b in ("trace", "events", "telemetry", "utilization", "slo") if b not in stats]
        check(not missing, f"/stats lacks the blocks {missing}")
        audit = json.loads(call(port, "GET", "/debug/audit")[1])["audit"]
        outcomes = sorted(a["outcome"] for a in audit if a["verb"] == "profile")
        check(outcomes == ["busy", "ok"], f"the profile audit records: {audit}")
        out.update({"requests_under_load": len(statuses), "batches_under_load": batches,
                    "k1_launches": launches, "device_utilization": util,
                    "batches_rate_per_s": rate, "alert": alerts["models"]["bert"]["state"],
                    "burn": alerts["models"]["bert"]["burn"],
                    "captures_total": graphs1["captures_total"],
                    "compiles_total": graphs1["compiles_total"],
                    "sampler_samples": stats["telemetry"]["samples_total"]})
    print(f"observability: under 4 clients device_utilization {util:.3f}, batches "
          f"{rate:.1f}/s (history), K1 {launches} = 12 x {batches:g} batches, /alerts "
          f"{out['alert']} (burn {out['burn']}), captures and compiles unchanged", flush=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


def latency_cost(port: int, seq: int = 40, clients: int = 4, per_client: int = 25) -> dict:
    """Served BERT-flash latency of 32-text batches: 5 warm-up requests,
    ``seq`` sequential requests from one client, then ``clients``
    concurrent clients of ``per_client`` requests each; p50 and p99
    (nearest rank) of the walls."""
    import threading

    def pcts(walls):
        walls = sorted(walls)
        return {"n": len(walls), "p50_ms": walls[len(walls) // 2],
                "p99_ms": walls[min(len(walls) - 1, math.ceil(0.99 * len(walls)) - 1)]}

    def timed() -> float:
        t0 = time.perf_counter()
        st, _ = call(port, "POST", "/v1/models/bert:classify", {"texts": TEXTS_32})
        check(st == 200, f"latency request answered {st}")
        return (time.perf_counter() - t0) * 1e3

    for _ in range(5):
        timed()
    one = [timed() for _ in range(seq)]
    many: list = []
    threads = [threading.Thread(target=lambda: many.extend(timed() for _ in range(per_client)))
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"one_client": pcts(one), f"{clients}_clients": pcts(many)}


def defaults_cost_phase(card: str) -> dict:
    """Served BERT-flash latency (``latency_cost``) with the reference's
    planes on (bert_flash.toml as it is) and with [telemetry], [events] and
    the flight recorder off, both servers up at once on the card and
    measured on, off, off, on; with each run's mean time per stage."""
    with serving(CONFIG, n_buckets=6) as on, \
            serving(CONFIG, n_buckets=6, extra_toml=OBS_OFF_TOML) as off:
        ports = {"on": on, "off": off}
        for label, port in ports.items():
            stats = json.loads(call(port, "GET", "/stats")[1])
            check(("telemetry" in stats and "events" in stats) == (label == "on"),
                  f"the planes' blocks do not match the {label} server's config")
        out = {"card": card, "on": [], "off": []}
        for label in ("on", "off", "off", "on"):
            s0 = stage_totals(ports[label], "bert")
            run = latency_cost(ports[label])
            s1 = stage_totals(ports[label], "bert")
            n = sum(v["n"] for v in run.values()) + 5
            run["stage_mean_ms"] = {p: round((s1[p] - s0[p]) / n, 3) for p in STAGES}
            out[label].append(run)

    def short(runs):
        return [{k: (round(v["p50_ms"], 2), round(v["p99_ms"], 2))
                 for k, v in r.items() if k != "stage_mean_ms"} for r in runs]

    print(f"defaults cost: 32-text batches, p50/p99 ms, planes on {short(out['on'])}, off "
          f"{short(out['off'])} ({card})", flush=True)
    return out


# -- phase 12: MobileNetV3-Large, the batch-1 vision path -----------------------------

MNV3_CONFIG = ROOT / "examples" / "mobilenetv3.toml"
MNV3_BUCKETS = ("[1]", "[2]", "[4]", "[8]")


def mnv3_requests() -> list:
    """Framed yuv420 bodies of 1, 2, 4 and 8 seeded items at 224 px."""
    import numpy as np

    from tpuserve_torch import frame, preproc

    rng = np.random.default_rng(21)
    out = []
    for n in (1, 2, 4, 8):
        items = [preproc.rgb_to_yuv420(a)
                 for a in rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)]
        out.append(("mobilenetv3", f"frame{n}", frame.encode_frame(items, frame.KIND_YUV420, 224),
                    frame.CONTENT_TYPE, items))
    return out


def drive_mnv3(port: int, requests: list, lone: int = 21) -> dict:
    """The MobileNetV3 path's run: counts to 0, the four bodies (first
    request of each bucket, stage by stage), counts read back (K1 and K2:
    0); the repeats; then ``lone`` single-item requests one at a time under
    the adaptive flush."""
    name = "mobilenetv3"
    check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
    before = call(port, "GET", "/metrics")[1].decode()
    arena = json.loads(call(port, "GET", "/stats")[1])["pipeline"]["models"][name]["arena"]
    check(set(arena["buckets"]) == set(MNV3_BUCKETS) and all(
          b["pooled"] == arena["slots_per_bucket"] for b in arena["buckets"].values()),
          f"{name}: the arena did not make every bucket's buffers at start: {arena}")
    answers, first, repeats = {}, {}, {label: [] for _, label, _, _, _ in requests}
    for _, label, body, ctype, items in requests:
        s0 = stage_totals(port, name)
        st, raw = call(port, "POST", f"/v1/models/{name}:classify", raw=body, ctype=ctype)
        first[label] = stage_delta(s0, stage_totals(port, name))
        check(st == 200, f"{name} {label}: {st} {raw[:300]!r}")
        results = json.loads(raw)["results"]
        check(len(results) == len(items) and all(len(r["top_k"]) == 5 for r in results),
              f"{name} {label}: {len(results)} results for {len(items)} items")
        answers[label] = results
    stats = json.loads(call(port, "GET", "/stats")[1])
    after = call(port, "GET", "/metrics")[1].decode()
    counts = (stats["kernels"]["flash_attention"]["launches"],
              stats["kernels"]["flash_attention_stats"]["launches"])
    delta = {n: metric(after, f'{n}{{model="{name}"}}') - metric(before, f'{n}{{model="{name}"}}')
             for n in ("batches_total", "items_total", "runtime_compiles_total")}
    check(counts == (0, 0), f"K1, K2 launched {counts} times on the MobileNetV3 path")
    check((delta["batches_total"], delta["items_total"], delta["runtime_compiles_total"])
          == (4, 15, 0), f"{name}: batches/items/compiles moved by {delta}")
    for _ in range(REPEATS):
        for _, label, body, ctype, _ in requests:
            s0 = stage_totals(port, name)
            st, _ = call(port, "POST", f"/v1/models/{name}:classify", raw=body, ctype=ctype)
            repeats[label].append(stage_delta(s0, stage_totals(port, name)))
            check(st == 200, f"repeat of {name} {label} answered {st}")
    first_request = first_request_table(first, repeats, name)
    _, _, body, ctype, _ = requests[0]
    totals, walls = [], []
    for _ in range(lone):
        s0 = stage_totals(port, name)
        t0 = time.perf_counter()
        st, _ = call(port, "POST", f"/v1/models/{name}:classify", raw=body, ctype=ctype)
        walls.append((time.perf_counter() - t0) * 1e3)
        totals.append(stage_delta(s0, stage_totals(port, name))["total"])
        check(st == 200, f"lone {name} request answered {st}")
    lat = json.loads(call(port, "GET", "/stats")[1])["latency"]
    out = {"answers": answers, "first_request": first_request, "launches_k1_k2": list(counts),
           "deltas": delta,
           "lone": {"n": lone, "server_total_p50_ms": sorted(totals)[lone // 2],
                    "wall_p50_ms": sorted(walls)[lone // 2],
                    "server_total_ms_range": [min(totals), max(totals)]},
           "phase_p50_ms": {p: lat[f"latency_ms{{model={name},phase={p}}}"]["p50_ms"]
                            for p in STAGES}}
    print(f"slice (mobilenetv3): 4 requests (15 images) answered; K1, K2 launches {counts}; "
          f"{delta}; lone single-item requests: server total p50 "
          f"{out['lone']['server_total_p50_ms']:.3f} ms, wall p50 {out['lone']['wall_p50_ms']:.3f} ms",
          flush=True)
    return out


def depthwise_split(model, rt, bucket: tuple) -> dict:
    """Device time of one forward at ``bucket`` (graph replay) beside that of
    its depthwise convolutions alone (each run on the input it got in the
    forward, all in one captured graph)."""
    import numpy as np
    import torch

    from tpuserve_torch.models.layers import Conv

    dev = rt.h2d(bucket, tuple(np.random.default_rng(5).integers(0, 256, s.shape, dtype=np.uint8)
                               for s in model.input_signature(bucket)))
    taken = []
    hooks = [m.register_forward_hook(lambda m, inp, out: taken.append((m, inp[0])))
             for m in rt.module.modules() if isinstance(m, Conv) and m.groups > 1]
    with torch.inference_mode():
        model.forward(rt.module, dev)
        for h in hooks:
            h.remove()
        total = graph_ms(lambda: model.forward(rt.module, dev))
        dw = graph_ms(lambda: [m(x) for m, x in taken])
    return {"forward_device_ms": total, "depthwise_device_ms": dw, "rest_device_ms": total - dw,
            "depthwise_convs": len(taken)}


def mnv3_model_check(mcfg, requests: list, answers: dict) -> dict:
    """MobileNetV3 in-process: served answers equal the same seeded model's
    on the same assembled batches; bf16 logits agree with the float32
    network (TF32 off) within RESNET_LOGIT_REL of their scale, separated
    ranks equal; per bucket the replay's device time; the eager stream and
    enqueue at (1,) and (8,); the depthwise convolutions' share; the
    card's busy and idle time in one profiled eager window at (8,)."""
    import dataclasses

    import numpy as np
    import torch

    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    model = build(mcfg)
    rt = build_runtime(model, device="cuda")
    for _, label, _, _, items in requests:
        bucket = model.bucket_for(len(items))
        ref = rt.fetch(rt.run(bucket, model.assemble(items, bucket)))
        for row, served in enumerate(answers[label]):
            check([e["class"] for e in served["top_k"]] == ref["indices"][row].tolist(),
                  f"mobilenetv3 {label}: served top-5 != in-process top-5, row {row}")
            check(np.allclose([e["prob"] for e in served["top_k"]], ref["probs"][row],
                              rtol=0, atol=1e-6),
                  f"mobilenetv3 {label}: served probs != in-process probs, row {row}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, label, _, _, items = requests[-1]
    bucket = model.bucket_for(len(items))
    twin = build(dataclasses.replace(mcfg, dtype="float32"))
    module32 = twin.build_module()
    module32.load_state_dict({k: v.float() for k, v in rt.module.state_dict().items()})
    module32.eval().requires_grad_(False).to(memory_format=torch.channels_last).to(rt.device)
    with torch.inference_mode():
        dev = rt.h2d(bucket, model.assemble(items, bucket))
        logits = rt.module(model.device_preprocess(dev)).float()[: len(items)]
        logits32 = module32(twin.device_preprocess(dev))[: len(items)]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()) and logits.shape == (len(items), 1000),
          f"mobilenetv3: logits {tuple(logits.shape)} not finite")
    err = (logits - logits32).abs().max().item()
    tol = RESNET_LOGIT_REL * logits32.abs().max().item()
    check(err <= tol, f"mobilenetv3: bf16 vs float32 logits differ by {err:.4g} > {tol:.4g}")
    checked = separated_ranks_agree(logits, logits32, "mobilenetv3 bf16 vs f32", tol)
    replay = {}
    for b in model.buckets():
        dev_b = rt.h2d(b, seeded_batch(model, b, seed=7))
        replay[str(b[0])] = replay_timing(rt, b, dev_b)
    forward = {str(b[0]): forward_timing(rt, model, b) for b in ((1,), (8,))}
    split = {str(b[0]): depthwise_split(model, rt, b) for b in ((1,), (8,))}
    dev8 = rt.h2d((8,), seeded_batch(model, (8,), seed=8))
    with torch.inference_mode():
        breakdown = device_breakdown(lambda: model.forward(rt.module, dev8))
    out = {"logits_bf16_vs_f32": {"max_abs_diff": err, "tol": tol,
                                  "separated_ranks_checked": checked},
           "replay_device_ms": replay, "eager_forward": forward, "depthwise_split": split,
           "device_breakdown_b8": breakdown, "capture_memory": dict(rt.capture_memory),
           "captures_total": rt.captures_total}
    print(f"slice (mobilenetv3): served answers equal the in-process run; bf16 vs float32 "
          f"(TF32 off) logits max abs diff {err:.4g} (tol {tol:.4g}), {checked} separated "
          f"top-5 ranks agree; replay device ms per bucket "
          f"{ {k: round(v['replay_device_ms'], 4) for k, v in replay.items()} }; eager stream / "
          f"enqueue ms { {k: (round(v['stream_ms'], 3), round(v['host_enqueue_ms'], 3)) for k, v in forward.items()} }; "
          f"depthwise / rest device ms "
          f"{ {k: (round(v['depthwise_device_ms'], 4), round(v['rest_device_ms'], 4)) for k, v in split.items()} }; "
          f"profiled eager (8,): busy {breakdown['total_ms']:.3f} of {breakdown['stream_ms']:.3f} "
          f"ms, by kind { {k: round(v, 3) for k, v in breakdown['ms_by_kind'].items()} }",
          flush=True)
    del rt, module32
    torch.cuda.empty_cache()
    return out


def mobilenet_phase(card: str) -> dict:
    t0 = time.perf_counter()
    from tpuserve_torch.config import load_config

    requests = mnv3_requests()
    with serving(MNV3_CONFIG, n_buckets=4) as port:
        run = drive_mnv3(port, requests)
        run["served_graphs"] = served_graphs(port)["mobilenetv3"]
    answers = run.pop("answers")
    run["model"] = mnv3_model_check(load_config(str(MNV3_CONFIG)).models[0], requests, answers)
    run["graphs"] = graph_phase(MNV3_CONFIG, {"mobilenetv3": (1,)},
                                lambda logits: RESNET_LOGIT_REL * logits.abs().max().item())
    run["card"] = card
    run["phase_s"] = time.perf_counter() - t0
    return run


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "tpuserve_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: FAIL: no tpuserve_torch package beside {Path(__file__).name}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        card = card_line()
        print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
              f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        build = build_kernels()
        k1 = kernel_phase()
        k2 = stats_kernel_phase()
        sp_errs = sequence_parallel_phase()
        run = slice_phase()
        long = long_slice_phase()
        vision = resnet_phase()
        lifecycle = lifecycle_phase()
        robustness = robustness_phase()
        observability = observability_phase(card)
        cost = defaults_cost_phase(card)
        mnv3 = mobilenet_phase(card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    vision_graphs = vision.pop("graphs")
    robustness["first_request_resnet50"] = vision.pop("first_request")
    # Where a (32, S) batch's device time goes: 12 K1 launches of one forward.
    k1_ms = {s_: k1[s_]["line"]["ms"] for s_ in (64, 128)}
    share = {s_: 12 * k1_ms[s_] / run["forward_ms"][s_]["stream_ms"] for s_ in (64, 128)}
    print(json.dumps({"slice": {"path": "bert_flash", "forward_ms_b32": run["forward_ms"],
                                "k1_ms_b32": k1_ms, "k1_share_of_forward_b32": share,
                                "k1_b32_s64": k1[64]["line"],
                                "k1_host_enqueue_ms_b32": {s_: k1[s_]["host_enqueue_ms"]
                                                           for s_ in (64, 128)},
                                "k1_bound_inputs": k1[128]["bound_inputs"], "build": build}}))
    # Where the (8, 2048) batch's device time goes: 12 K2 launches of one forward.
    k2_share = 12 * k2["line"]["ms"] / long["forward_ms_b8_s2048"]["stream_ms"]
    print(json.dumps({"slice": {
        "path": "bert_long_ring", "config": str(LONG_CONFIG.relative_to(ROOT)),
        "launches_k1_k2": long["counts"], "forward_ms_b8_s2048": long["forward_ms_b8_s2048"],
        "k2_ms_b8_s2048": k2["line"]["ms"], "k2_share_of_forward_b8_s2048": k2_share,
        "k2_host_enqueue_ms": k2["host_enqueue_ms"],
        "k2_errors": k2["errors"], "k2_bound_inputs": k2["bound_inputs"],
        "sdpa_normalized_output_only_ms_b8_s2048": k2["sdpa_normalized_output_only_ms"],
        "library_vs_k2_max_abs_err": k2["library_vs_k2_max_abs_err"],
        "k1_b8_s2048": k2["k1_same_shape"]["line"],
        "sequence_parallel_4rank_max_abs_err": sp_errs,
        "ring_vs_dense_max_abs_logit_diff": long["ring_vs_dense_max_abs_logit_diff"],
        "serve_walls_ms": long["walls_ms"], "serve_phase_p50_ms": long["phase_p50_ms"],
        "phase_s": long["phase_s"]}}))
    # The vision path: no hand-written kernel; where its (32,) forward goes.
    print(json.dumps({"slice": dict(vision, path="resnet50",
                                    config=str(RESNET_CONFIG.relative_to(ROOT)))}))
    mnv3_graphs = mnv3.pop("graphs")
    robustness["first_request_mobilenetv3"] = mnv3.pop("first_request")
    print(json.dumps({"slice": dict(mnv3, path="mobilenetv3",
                                    config=str(MNV3_CONFIG.relative_to(ROOT)))}))
    # The runtime's graphs against the eager forward, and the host time of
    # the served h2d stage, per path; then the lifecycle drills.
    print(json.dumps({"graphs": {"bert_flash": run["graphs"], "bert_long_ring": long["graphs"],
                                 "resnet50": vision_graphs, "mobilenetv3": mnv3_graphs}}))
    print(json.dumps({"lifecycle": lifecycle}))
    print(json.dumps({"robustness": robustness}))
    print(json.dumps({"observability": observability}))
    print(json.dumps({"defaults_cost": cost}))
    print(json.dumps({"kernels": [dict(k1[128]["line"], launches=run["launches"]),
                                  dict(k2["line"], launches=long["k2_launches"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

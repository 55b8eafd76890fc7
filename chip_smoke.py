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
5b. Mesh modes on one card (``mesh_phase``, in process, run beside phases
   9 and 12): full-width BERT-flash (``examples/bert_flash.toml``, bucket (32,
   128), one parameter slot) with ``mesh.visible_devices`` patched to four
   ranks on ``cuda:0``, in single mode and as ``sharded`` with a data axis
   of 2, ``replica`` x2, ``tp = 2`` and ``pipeline`` with ``pp = 2``: each
   replica's answer equals single mode's bytes; the sharded, tensor-parallel
   and pipelined logits lie within ``LOGIT_TOL`` of single mode's, with
   top-5 equal where those separate the ranks by more than it; K1's
   launches by shape over one batch per replica are 24 at (16, 128, H 12),
   24 at (32, 128, H 12), 24 at (32, 128, H 6) and 48 at (8, 128, H 12);
   compiles and captures do not move over 64 dispatches; every replica
   serves. Then ``tp = 2`` under ``quantize = "int8"`` against single
   int8 (the logit rule, K1's launches); textgen
   (``examples/textgen_flash.toml`` at ``SHALLOW_LAYERS``) on a replica-2
   ``GenEngineGroup`` gives the single engine's tokens with both replicas
   stepping, and its sharded decode (``tp = 2``, paged KV, float32) the
   single locked batch's tokens under phase 17's ``TG_MARGIN`` rule. K1 is
   timed at the three new shapes once phases 9 and 12 have stopped their
   servers (``mesh_k1_phase``), with the card to itself. Each mode's replay
   device time beside single mode's is printed; nothing is gated on it.
5c. The seq and model axes (``mesh_axes_phase``, ROADMAP items 9b.1-9b.2,
   in a process of its own beside phases 5d, 15, 18, 19 and 26), on four ranks
   on ``cuda:0`` as 5b's: full-width BERT-base (``examples/bert_long_ring.toml``'s
   widths, 12 layers, bf16) at the (16, 4096) bucket, ring on data 2 x seq 2
   (K2's launches by shape over one batch exactly {(8, 2048, 12, 64): 96})
   and Ulysses on model 2 x seq 2 (K1's exactly {(16, 4096, 3, 64): 48}),
   each against the same attention in single mode (K2, resp. K1, 12 times
   at (16, 4096, 12, 64)) by the logit rule, no compile or capture over 64
   dispatches, replay device times beside single mode's; ResNet-50 split
   over "model" (``resnet50``, int8 on the yuv420 wire, and ``resnet50_rgb``,
   bf16, tp = 2, bucket (32,)) within ``RESNET_LOGIT_REL`` of single mode's
   logits' scale with separated top-5 ranks equal; MobileNetV3 and
   EfficientDet-D0 at tp = 2 (parameters replicated over "model") on single
   mode's bytes at (8,). Item 9b.3, textgen's KV context on "seq" (sp = 2
   on dense KV, tp = 2 x sp = 2 on paged KV over an even page count), runs
   in 5b's sharded decode check. K1 at (16, 4096, 3, 64) is timed in
   5b's ``mesh_k1_phase``, with the card to itself.
5d. SD 1.5 on a split mesh (``mesh_sd_phase``, ROADMAP item 9b.4, in a
   process of its own beside phases 5c, 15, 18, 19 and 26), on four ranks
   on ``cuda:0`` as 5c's: full-width SD 1.5 (``examples/sd15_flash.toml``,
   seeded, bf16, flash) in single mode and on data 2 x model 2 (each model
   rank 4 of the 8 heads and its GEGLU block), bucket (2,), one parameter
   slot, the engine's programs (8 slots) captured on each runtime: one
   2-row UNet call on the split view within ``SD_EPS_REL`` of single mode's
   eps scale, K1 by shape exactly 10 at each of (2, 4096, 4, 64) and (2,
   1024, 4, 128); the locked batch's K1 exactly 400 at each shape (20 steps
   x 2 data ranks x 2 model ranks x 5), its replay bit-identical to its
   eager ``mesh_forward`` and the same bytes twice, no compile or capture
   over the replay timing's 9 dispatches; 4 requests through the engine,
   then in reverse order (other slots), the same PNG bytes, K1 exactly 10
   per step at each (16, ...) shape, no compile or capture; every locked
   image (one a data rank) and engine PNG against single mode's: mean abs
   pixel difference within ``SD_MESH_PIXEL_MEAN`` and at least
   ``SD_MESH_PIXEL_EQUAL`` of the pixels equal; the max and mean
   differences, and the locked and engine-step device times beside single
   mode's, printed. K1 at SD's
   four split shapes is timed in 5b's ``mesh_k1_phase``, with the card to
   itself.
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
   not wait for the first batch's forward still queued on the card. Then
   the retrace witness's negative gates, in process on the (32, 128)
   runtime (``witness_gates``): with the barrier declared and the sync
   guard armed (``torch.cuda.set_sync_debug_mode("error")``), a stray
   ``.item()`` on a replay's output raises and ``host_fetch`` of the same
   outputs does not (and equals a plain ``.cpu()`` with the guard off); a
   capture after the barrier outside ``sanctioned_compiles`` raises
   ``RetraceViolation`` before it starts, and inside it captures with no
   further violation; the guard and the witness are restored after.
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
   enqueue) against the eager yardstick, and the replay's device time,
   beside the runtime's ``probe_raw_ms`` (the server's startup probe: 8
   dispatches on the host's clock) right after the captures, on the warm
   card, and over 64 dispatches.
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
9. Lifecycle: serve ``examples/bert_flash.toml`` (at ``SHALLOW_LAYERS`` =
   4 layers, a copy under ``build/smoke/``, as phases 12, 15 and 16 do) and
   then
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
   (``published`` twice, ``rolled_back``, ``reload_rejected`` twice). The
   BERT copy drops its ``parallelism = "single"`` (under
   ``build/smoke/sharded/``) and serves the reference's default,
   ``"sharded"``, on a one-device mesh: ``/stats`` ``parallel`` reads
   ``n_chips`` 1 and ``replicas`` 1, ``topology`` platform ``gpu`` and 1
   local device. ResNet-50 then takes a further ``:reload`` of the seed-1
   tree written int8-quantized (``quantize.quantize_tree``, what
   ``import-model --quantize int8`` applies, on the seed-1 tree as bf16
   holds it): version 4, the first answers' bytes, no new capture (one
   more reload ok in the audit, ``published`` three times). The two
   drills run side by side, and phase 12 runs beside them (all three only
   drive servers over HTTP).
   Phase 8 also times the first request of each bucket stage by stage
   (``stage_totals``: the server's per-stage histogram sums around one
   request) against eight repeats, and holds each stage but the queue
   within its repeats' range plus 5 ms (``first_request_table``; when a
   stage misses, all of it again on a second fresh server, and a stage over
   the bar on both fails: ``drive_fresh``): no request pins memory or
   builds state on the request path.
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
   dispatched; captures and compiles unchanged. The server runs with
   ``TPUSERVE_LOCK_WITNESS=1`` and ``TPUSERVE_RETRACE_WITNESS=1``
   (``witness_check``): ``/stats`` ``robustness.lock_witness`` has nodes
   and no violation; ``retrace_witness`` has its barrier declared, as many
   warm-up compiles as the boot's compile ticks, the sync guard armed and
   no violation; its ``allow_transfers`` windows are printed, with the
   requests' p50 and p99 under the 4 clients.
12. Cost of the defaults (``defaults_cost_phase``): BERT-flash (at
   ``SHALLOW_LAYERS`` layers) with the reference's planes on and with them
   off, both served at once, 32-text
   batches from 1 client and from 4, measured on, off, off, on: p50 and
   p99 and the mean time per stage, printed; nothing is gated on them.
   It runs beside phase 9's drills, whose reloads share the card.
13. MobileNetV3-Large (``mobilenet_phase``): serve
   ``examples/mobilenetv3.toml`` (full width, bf16, yuv420 at 224, batch
   buckets [1, 2, 4, 8]); with the counts at 0 framed bodies of 1, 2, 4 and
   8 items (K1 and K2: 0 launches; batches 4, items 15, compiles 0), each
   bucket's first request within its repeats' range + 5 ms per stage
   (on a second fresh server when a stage misses, as in phase 8),
   then 21 lone single-item requests under the adaptive flush (server
   total p50). In-process: served top-5 equal to the same seeded model's,
   bf16 logits against the float32 network (TF32 off) within
   ``RESNET_LOGIT_REL`` of their scale with separated ranks equal, each
   bucket's replay device time, the eager stream and enqueue at (1,) and
   (8,), the depthwise convolutions' device time against the rest, one
   profiled eager window by kind; ``graph_phase`` holds every bucket's
   replay bit-identical to the eager forward.
14. EfficientDet-D0 (``efficientdet_phase``): serve
   ``examples/efficientdet.toml`` (full width, bf16, 512 px, yuv420 wire,
   batch buckets [4, 8]); with the counts at 0 framed bodies of 1, 4, 5 and
   8 items to ``:detect``, a malformed frame (400) and an unknown model
   (404): K1 and K2 0 launches, batches 4, items 18, compiles 0, captures 6
   before and after; each bucket's first request within its repeats' range
   + 5 ms per stage (when a stage misses, all of it again on a second fresh
   server; a stage over the bar on both fails). In-process: the served detections equal the same
   seeded model's; each bucket's replay bit-identical to its eager forward
   on boxes, scores, classes and n; the bf16 heads against the float32
   network (TF32 off) on the 8-item batch within ``RESNET_LOGIT_REL`` of
   each output's scale, detections equal where the float32 scores
   separate (the seeded D0 scores every anchor near its 0.01 prior, below
   the 0.05 threshold, so both keep none); the detection tail alone on
   seeded logits whose scores spread (100 kept per image) on the card
   against the CPU and the CPU's against a naive greedy NMS; then per
   bucket the replay's device time and the eager stream and enqueue, the
   network alone and the tail alone at (8,), one profiled eager window.
15. int8 compute (``int8c_phase``): ``quantize.int8_matmul`` on the card
   against its plain version at BERT's FFN shape (32 x 128 rows), a
   ResNet-50 (32,) 1x1 convolution and 5 rows (padded to ``_int_mm``'s 17):
   int32 products equal, outputs within one bf16 unit; serve
   ``examples/bert_flash.toml`` (at ``SHALLOW_LAYERS`` = 4 layers) and
   ``examples/resnet50.toml`` with ``--set model.<name>.quantize=int8c``:
   the served answers equal an in-process int8c run (24 and 36
   int8-native weights), K1 4 launches per BERT batch, none on ResNet-50,
   compiles 0; phase 9's lifecycle drill
   on int8c BERT-flash (reload, rollback, both rejections, no new capture);
   int8c logits against the
   weight-only int8 network on the same weights and batch within
   ``INT8C_LOGIT_REL`` of their scale, separated top-5 ranks equal; the
   replay device time of bf16, int8 and int8c at BERT (32, 128) and
   ResNet-50 (32,), printed, nothing gated on speed.
16. The command line (``cli_phase``), through ``python -m tpuserve_torch``
   as a user runs it: ``describe`` reports platform ``gpu`` and the card's
   name; ``warmup --config examples/bert_flash.toml`` (at ``SHALLOW_LAYERS``
   layers, as the BERT-flash server of this phase) exits 0 listing all
   6 buckets; serve BERT-flash with ``roofline_probe_iters=8`` and run
   ``bench`` with a 32-text JSON body (1 s warm-up, 5 s window) closed at 8
   connections, open at half its throughput, and that open loop again with
   ``--procs 2``: each exits 0 with ``n_ok > 0`` and ``n_err == 0``, and K1's
   launches, set to 0 just before each run and read just after, equal 4 x
   ``batches_total`` over the same span; ``device_utilization`` (a 2 s
   window sampled every 0.25 s) is read 3 s after each open loop's first
   batch; ``/stats`` ``roofline.bert`` has a raw forward ms
   for every bucket and a ``compute_split``; ``GET /`` answers 200 HTML.
   Then serve ``examples/resnet50.toml`` (probes on) and run a framed
   yuv420 open loop of 32-item bodies at 160 px to ``resnet50`` at 20
   requests/s (``n_err == 0``, K1 0, every bucket probed on both models);
   then ``chaos`` runs twice, side by side, on a copy of the config holding
   ``resnet50_rgb`` alone (npy at 256) with ``batch_error`` at 0.1 and at
   1.0 and ``reload_corrupt`` at 1.0 under ``--drill reload``, 5 s each at
   ``--min-availability 0.99``: at 0.1 exit 0, availability >= 0.99, the
   rule fired more than 5 times, the breaker closed, version 1 live, no
   reload published; at 1.0 exit 1. The ``cli`` line carries every run's
   summary, the K1 counts, both configs' roofline blocks, the utilization
   samples and the startup probe's raw (32, 128) ms (4 layers) beside phase
   6's replay device time of the same bucket (12 layers). ``lint`` runs
   as a user runs it, on the card's machine: exit 0 against the port's
   checked-in baseline (it imports neither JAX nor torch; whether a
   ``jax`` is importable there is printed). It runs after phase 14,
   beside phase 17 (it only drives subprocesses; phase 17's gates are of
   answers and counts, and its printed device times, its K1 timings
   included, are taken with phase 16's servers on the card).
17. Text generation (``textgen_phase``): K1 against its plain version at
   the prefill's shapes ((1, 256) inserts, (32, 256) locked batches, bf16,
   padded keys, and a one-token prompt), timed with its bound, plain
   version and SDPA; then serve ``examples/textgen_flash.toml`` (GPT-2
   small's widths: 12 layers, d 768, 12 heads, d_ff 3072, vocab 50257;
   prompt 256, max_new 256, 32 slots, bf16, ``attention = "flash"``, seeded
   weights) through ``python -m tpuserve_torch serve``, the generation
   engine's programs captured per parameter slot and state block. With the
   counts at 0, 16 seeded ``:generate`` requests (8-256-word prompts,
   max_new_tokens 1-256, temperatures 0 and 0.7) in two waves: K1 launches
   = 12 x inserts (none per decode step), fold-ins and early exits > 0; a
   mid-generation deadline answers 504 (one eviction); ``?stream=true``
   streams two token events and a done; the same requests again and across ``:reload`` (the engine's
   staged canary) and ``:rollback``: tokens unchanged, compiles and
   captures moved 0; ``bench --synthetic prompt`` (64 prompts, max_new
   1-256, every 8th a 200-word prompt) for 5 s at 32 connections with
   ``n_err`` 0. In-process, on the same seeded weights: each program's
   replay bit-identical to its eager call; the in-process engine's tokens
   equal the served ones; the locked-batch forward (bucket 32) gives the
   same tokens — a lane may differ first only at a step where the locked
   batch's top-two sampling margin is below ``TG_MARGIN`` (1e-3), and such
   lanes are counted; the same for the dense-attention model; flash
   against dense under the same rule in float32 (TF32 off), and in bf16
   under the bf16 rule (the two attention cores round the scores
   differently: a lane may differ first only where the dense batch's
   margin in logit units is below ``BF16_LOGIT_TOL``, 0.0625, the bound
   ``tests/test_torch_textgen_bf16.py`` holds the port to the reference
   with); the staged canary leaves the live state block's bytes
   unchanged; the step's host and device time at 1, 8 and 32 active slots,
   the insert's host and device time, and the step's device time by kind;
   whole-prompt paged KV
   tokens equal the dense engine's. Then a second server with
   ``genserve.kv_paging = true`` and ``prefill_chunk = 64``: chunked tokens
   equal across two runs and batch mixes, and KV exhaustion sheds 503
   ``kv_pressure``.
18. Streamed generation (``streaming_phase``): serve
   ``examples/textgen_flash.toml``; with the counts at 0, the 16 seeded
   requests streamed (``?stream=true``, the port's stdlib client, SSE
   parsed) each beside the same unary request, all at once; the byte
   audit: every stream 200, its token events' indices contiguous, their
   token ids and concatenated text equal to the unary answer's byte for
   byte, exactly one terminal, last, ``done`` with the unary answer's
   finish reason and ``completion_tokens``; K1 = 12 x inserts (32),
   ``gen_streams_total`` and ``done`` 16. Then ``bench --stream`` (32
   connections, the prompt pool, 1 s warm-up, 5 s): ``n_err`` 0, torn 0,
   K1 = 12 x inserts over it, compiles and captures moved 0; streams/s,
   tokens/s, first-token and inter-token gap p50/p99 printed beside phase
   17's unary tokens/s. Then a paged server with ``stream_disconnect`` at
   0.2: every injected stream torn (injections = torn streams > 0), every
   other one whole and equal to the unary text, then ``gen_active_slots``
   0 and ``gen_kv_pages_free`` back to the pool. It runs right after phase
   17, beside phase 15 (it only drives servers; phase 15's gates are of
   answers and counts) and phase 19.
19. Switch-MoE (``moe_phase``): serve ``examples/textgen_moe_flash.toml``
   (phase 17's config with 8 experts per layer, Switch-Base-8): the 16
   seeded requests, K1 = 12 x inserts, compiles and captures moved 0;
   in-process on the same seeded weights: program replays bit-identical to
   eager, the engine's tokens equal to the served ones and to the locked
   batch's (``TG_MARGIN`` rule), the step's and insert's host and device
   time and the step by kind, flash against dense under the bf16 rule and
   in float32 under ``TG_MARGIN``. Then serve ``examples/bert_moe_flash.toml``
   (BERT-base flash with 8 experts, capacity factor 1.25) through phase
   6's drive (K1 12 per batch, 41 items, compiles 0), served top-5 equal
   to in-process, separated top-5 ranks equal to the dense-attention MoE
   model's (its max logit difference printed: a bf16 rounding that moves a
   router's argmax sends a token to another expert), every bucket's replay
   bit-identical to its eager forward, the (32, 128) replay's device time
   and the capture memory. It runs in a process of its own
   (``chip_smoke.py --phases --only moe_phase``, ``Apart``) beside phases
   15 and 18, so its printed device times share the card with theirs.
20. SD 1.5 txt2img (``sd15_phase``): K1 against its plain version at SD's
   padded shapes, (B, 4096, 8, 64 <- 40) and (B, 1024, 8, 128 <- 80) bf16
   with B = 2 (the locked path's UNet rows) and B = 16 (the engine step's
   2 x 8 slots) (phase 3's tolerance, its atol a share of max |plain|; the
   padded tensors pass K1's TMA rule), timed beside its bound at the
   padded dim and at d and SDPA on the UNPADDED heads. Meanwhile, with
   the smoke's own code (the card's machine has neither ``safetensors``
   nor ``transformers``), it writes into a temporary directory a seeded
   CLIP-shaped byte-level BPE (``clip_bpe_files``: ``vocab.json`` of
   49,408 entries, ``merges.txt`` of 48,894 merges) and the seeded tree
   of ``examples/sd15_flash.toml`` with that BPE, drawn on the card as a
   server without weights draws it, in the published LDM layout as a
   float32 ``.safetensors`` of ~4.1 GB (``ldm_state_dict``, the
   importer's inverse; ``write_safetensors``); its size and the times are
   printed. Serve ``examples/sd15_flash.toml`` (full width, 512 px, 20
   steps, CFG 7.5, bf16, ``unet_attention = "flash"``; one graph per
   bucket [1] and slot holds CLIP, the loop and the VAE) with ``--set``
   ``weights`` naming that file and ``bpe_vocab``/``bpe_merges`` the BPE:
   one import logged at boot (read and mapping seconds printed); with the
   counts at 0 a prompt twice (200 ``image/png``, a 512x512 PNG read by
   the smoke's own zlib reader, the same bytes again), ``{"seed": 1}``
   400, K1 200 launches per image, 100 at each (2, ...) shape, compiles
   and captures moved 0; a ``:reload`` (the file imported again, its
   times printed), then the same bytes again. In-process on the seeded
   tree with the same BPE: the PNG served from the imported checkpoint
   equal to the runtime's replay
   and to the eager forward, finite latents, the replay's device time; one
   bf16 UNet call flash against dense, max abs eps difference within
   ``SD_EPS_REL`` (5e-2) of the dense eps's max abs, K1 10 launches; the
   2-row UNet call's device time and by kind; the engine's programs on the
   same runtime: insert (CLIP), step at 1 and 8 active slots and extract
   (VAE) device times. Then the engine variant (``SD_ENGINE_SETS``: 8
   slots, buckets [1, 4], ``preview_every`` 5): eight concurrent requests
   (1-60-word prompts, one negative prompt; the seeded tree and the same
   BPE) and one ``?stream=true``
   (``frame.CONTENT_TYPE``: progress 1..20, 3 previews, one final image
   equal to the unary one, one ``done``, last), the eight again in reverse
   order (other slots) with the same PNG bytes, K1 = 10 x steps, 5 x
   steps at each (16, ...) shape,
   ``gen_iterations_total`` > 0, captures and compiles moved 0 (previews
   included); the engine's image of the locked body beside the locked PNG
   (reported). The tree, the checkpoint and K1's timings come first, with
   the card to itself (``sd15_prepare``); the served part and the
   in-process checks then run beside phases 21 and 25, so its printed
   device times share the card with their servers.
   Phases 17-20 each start their second server (17's paged one, 18's
   tearing one, 19's BERT-MoE one, 20's engine one) as their first boots,
   after the phase's K1 timings (``prestart``), as phase 6 starts phase
   7's and phase 15 its int8c ResNet-50 one; the first ``serving`` waits
   for both (only for the servers its own thread started), so no boot of
   the phase runs under its measurements (the smoke's time limit).
21. The router/worker process tier (``router_phase``), every server and
   drill at ``SHALLOW_LAYERS`` (4): serve ``examples/bert_flash.toml``
   alone and bench it closed at 8 connections (phase 16's 32-text body);
   serve ``examples/bert_flash_router.toml`` (the same model behind the
   router, ``python -m tpuserve_torch serve``) at 1 and 2 worker processes
   on the card (the three servers booted side by side) and bench each the
   same way, one at a time (requests/s, p50, p99, each
   worker's ``device_utilization``, K1 = 4 x the batches summed over the
   workers with the counts set to 0 just before); at 2 workers, with the
   counts at 0, phase 6's three requests byte-identical to the direct
   server's answers, K1 = 4 x batches,
   compiles unchanged in every worker, a ``:reload`` fanned out to both
   (version 2 everywhere, the same bytes after); the router's process
   never initializes CUDA (its ``/stats``); each fleet's worker boot
   times, ``memory_reserved`` per worker and the card's used memory. Then
   ``chaos --drill worker_kill`` on that config and ``--drill
   stream_kill`` on ``examples/textgen_flash_router.toml`` (10 s at 16
   connections, the SIGKILL 2 s in, a respawn budget of the backoff plus
   twice the slowest boot measured here): each exits 0 (availability >=
   0.99, respawn within the budget, 0 torn and 0 duplicate answers; 0
   torn streams, 0 order violations, every done stream equal to the unary
   reference, the survivor's compiles unchanged).
22. Host failure domains and the peer router tier (``hosts_phase``):
   serve ``examples/bert_flash_hosts.toml`` (the same model, 2 host
   domains of 2 workers each, every agent its own process group, 2 routers
   on one SO_REUSEPORT port; at ``SHALLOW_LAYERS``, as the direct server
   and the drill, so that phases 23-24 fit) beside a copy
   with the cache on and 1 worker per host and beside
   ``examples/bert_flash.toml`` alone. On the file: phase 6's three
   requests 4 times over fresh connections byte-identical to the direct
   server's, both routers taking some (their ``router_requests_total``);
   K1 = 4 x the batches summed over the 4 workers with the counts at 0
   just before,
   compiles unchanged; ``/metrics/fleet``'s ``requests_total{model=bert}``
   equal to the workers' sum; no router initializes CUDA (the primary's
   ``/stats`` and the peer's ``/peer/stats``, the primary being the serve
   process); the bench closed at 8 connections as phase 21's; then
   ``/admin/hosts/0:scale?active=1`` and back (200, 200) and a SIGKILL of
   router 1 under load: every request sent after its death answers 200, the
   ring is back at 2 members with ``router_respawns_total{router=1}`` >= 1.
   On the cached copy: 8 identical bodies on 8 fresh connections cost one
   batch in the fleet, with ``cache_peer_hops_total`` >= 1. Meanwhile
   ``chaos --drill host_kill`` on the file (phase 21's arguments: one whole
   domain killed with killpg, a re-absorb budget of the backoff plus twice
   the slowest host boot measured here) exits 0: availability >= 0.99,
   re-absorbed within the budget, 0 torn, 0 duplicate, the survivors'
   compiles unchanged. Phase 23's fleet drill starts right after this
   drill, and phases 23 and 24 run once this phase's servers are stopped,
   while the drill's fleet re-absorbs its killed host (the smoke's time
   limit: with them after phase 22 the smoke took 1,211.9 s on an H100
   80GB HBM3 at 700 W; PERF.md).
23. The fleet scheduler's weight paging (``fleet_phase``): serve
   ``examples/bert_fleet.toml`` (``[scheduler]`` on; full-width 12-layer
   BERT-flash declared ``cold_start`` beside ResNet-50, config 1, and
   MobileNetV3, config 2): bert boots cold (``/stats`` ``scheduler``, no
   slot, compiles 0, captures 0); a bert request answers 503
   ``model_warming`` with a ``Retry-After``; ``:warm`` answers 200 with
   ``warm_ms``; with the counts at 0 phase 6's three requests answer the
   bytes of phase 6's server and K1 = 12 x bert's batches; ``:demote``
   frees the slots: the server's ``memory_reserved`` falls by at least
   the three slots' parameter bytes (``nvidia-smi``'s figure for the
   process gated too when it lists the process); then ``:warm`` again
   while closed-loop clients load resnet50 and mobilenetv3 (every answer
   200): the same bytes, K1 = 12 x batches through the recaptured graphs,
   ``runtime_compiles_total`` unchanged and ``captures_total`` doubled
   (slots x buckets more); ``/debug/audit`` holds warm, demote, warm.
   Beside these checks (started first, read last) ``chaos --drill fleet``
   on the file with mobilenetv3 the victim (``device_error`` at 100 %):
   exit 0, the victim's breaker open, both
   survivors at availability >= 0.99 with p99 within
   ``FLEET_P99_BUDGET_MS``, K1 = 12 x bert's batches over the load.
   Memory in each state, ``warm_ms`` and the survivors' p50/p99 are
   printed (the ``fleet`` line). The fleet server runs under
   ``TPUSERVE_RETRACE_WITNESS=1``: both warms' captures and the first
   warm's compiles are sanctioned (as many as bert's ``captures_total`` and
   ``compiles_total``), the sync guard stays armed, 0 violations.
24. Tenants and the autopilot (``autopilot_phase``), started with phase 23
   and read after it: ``chaos --drill autopilot`` on a copy of
   ``examples/bert_flash_tenants.toml`` (2 host domains x 2 worker slots,
   1 active, ``[tenants]`` and ``[autopilot]`` on) at ``SHALLOW_LAYERS``
   and with one router, as the reference's drill runs it (the controller
   reads the pressure of the primary router's relays only; with the file's
   2 routers the kernel splits the victim's connections between them by
   chance), with the reference drill's mid-load ``worker_slow``
   fault on host 1's active worker: exit 0 with the victim tenant's
   availability >= 0.97 and every gate of the reference's
   ``scripts/autopilot_drill.sh`` (the hostile tenant 429'd with
   ``tenant_*`` reasons, the victim never, ``scale_up`` or ``shed_on``
   acted within 18 s with no actuation error, every decision in
   ``/debug/audit`` as ``autopilot:*``, ``/tenants`` 200); the
   ``autopilot`` line carries ``first_action_s``, the actions and the
   victim's availability.
25. Deferred (recycle) mode (``deferred_phase``), run beside phase 21
   and phase 20's served part:
   serve ``examples/bert_flash_recycle.toml`` (full-width 12-layer
   BERT-flash, ``session_mode = "recycle"``, the reference's relay
   defaults: 2 workers, 4,096-row or 2 s epochs, 4 slots) through ``python
   -m tpuserve_torch serve``; the server's process never initializes CUDA
   (its ``/stats``), the workers are spawned. With the counts at 0, phase
   6's three requests, 0.2 s apart (three batches in one epoch), answer
   the bytes of phase 6's direct server, and K1 = 12 x batches summed over
   the workers' epochs after their readback; ``:reload``, ``:rollback``
   and ``/versions`` answer 409 with the reference's words. Then 384
   32-text bodies over 128 connections, closed loop (every answer waits
   for its epoch, so an epoch holds the requests in flight: 128 x 32 texts
   fill its 4,096 rows and stay under ``max_queue``): every answer 200, >= 3
   epochs, K1 = 12 x batches; the rotations, dry acquires, each worker's
   boot and ``memory_reserved``, the one read per epoch, p50 and p99
   beside ``relay_epoch_ms`` and requests/s beside phase 21's direct
   server are printed. SIGTERM 0.3 s after a 32-text batch lands on a warm worker:
   the batch answers 200 before the 2 s epoch ends and the process exits
   0. Beside it, ``chaos`` on a copy with one ``worker_death`` rule (armed
   45 s after the drill's server is born; single texts offered at 20/s for
   30 s): exit 0, availability >= 0.99, the one death absorbed by
   ``batch_retries_total`` >= 1, a watchdog restart or a respawn counted.
26. Training (``training_phase``), in a process of its own (``Apart``)
   started with phase 19's, beside phases 19, 15 and 18, never beside a
   phase with gates on time: (1) ``python -m tpuserve_torch finetune-det
   --out <tmp>/det_cli.npz --steps 2 --batch 8 --opt image_size=512 --opt
   wire_size=512 --opt det_classes=90`` (D0 widths, bf16), started first
   and read last (it runs beside gates 2-4), exits 0 and prints its
   ``{"final_loss", "checkpoint"}`` line; (2) ``finetune_detector``
   in process at 512 px, batch 8, bf16, for 20 steps on the synthetic
   rectangles: the mean loss of the last 5 steps below that of the first 5;
   each step's time (synchronised), images/s and the peak memory printed;
   (3) the ``.npz`` it wrote passes its manifest, loads through the port's
   loader (``weights = <det.npz>``) into a runtime with bucket (8,), and a
   replayed graph of its heads equals the trainer's final parameters run
   eagerly in the same dtype within ``RESNET_LOGIT_REL`` of the scale, the
   runtime's replayed detections with the same count and classes as the
   trainer's; (4) one ``tpuserve_torch.train`` step with ``seq_attention``
   "ring", then one with "ulysses", at BERT-base widths (``LM_TRAIN``:
   d_model 768, 12 heads of 64, d_ff 3072, vocab 30522, 2 layers,
   ``max_seq`` 8192, batch 2, float32, TF32 off) on a mesh of sp = 2 ranks
   on ``cuda:0``: ``auto_local_impl`` picks "flash"; K2 launches layers x
   sp x ring steps = 8 (ring), K1 layers x sp = 4 (Ulysses); the loss and
   every gradient leaf equal the same step through the kernels' plain
   versions (``plain_kernels``) within ``LM_LOSS_REL`` / ``LM_GRAD_REL``
   (phase 4's float32 atol summed over the layers); each step's time and
   its peak memory (the dense-recompute backward) printed. Then, with the
   card to itself, K2 and K1 at those shapes in float32 against their plain
   versions, timed beside their plain versions, their bounds and library
   yardsticks (``train_kernel_rows``); the ``training`` line.
27. Every process the phases started, and every one those started (the
   smoke is their subreaper, so an orphan is re-parented to it), must end
   within ``ORPHAN_GRACE_S`` of the last phase; one still running then is
   killed, named, and fails the smoke. Nothing outlives the smoke: the
   phases run in a child process (``--phases``) under a supervisor,
   itself the subreaper, that kills the child and every process below it
   and fails when the phases run past ``SMOKE_DEADLINE_S`` (1,150 s; the
   command's limit is 1,200 s), on SIGTERM, SIGINT or SIGHUP, or when the
   child dies and leaves a process behind. Each phase prints its wall time
   and when it ended (``smoke: phase N took ...``).
   Print a ``slice`` line per path, the ``graphs`` line (phase 6-8's,
   13's and 14's graph checks and host times), the ``mesh`` line, the
   ``lifecycle`` line, the
   ``robustness`` line (with phase 8's, 13's and 14's first-request
   tables), the ``observability``, ``defaults_cost``, ``cli``, ``router``,
   ``hosts``, ``fleet``, ``autopilot``, ``deferred`` and ``training`` lines, and
   the ``kernels`` line (K1 and K2, each with its launches on its path,
   counted through graph replays, K1's on the int8c path, in each of
   phase 16's ``bench`` runs, on phase 17's textgen path, phase 18's
   streams and ``bench --stream``, phase 19's MoE paths and phase 20's
   locked and engine SD paths, phase 21's router path and phase 22's host
   path and their benches beside, phase 23's first warm, re-warm and fleet
   drill, phase 25's recycle path and its load, phase 26's LM train steps
   (K1 through Ulysses, K2 through the ring), then K2's and K1's rows at
   the train step's float32 shapes (phase 26), K1's three mesh rows
   (phase 5b's shapes, with their launches there), K1's four SD rows, each with the
   launches counted at its shape on the locked (B = 2) or engine (B = 16)
   path; the vision paths run neither),
   the whole smoke's seconds, the card line, then the result line ``{"ok": true,
   "device": {...}}``. Every phase's JSON line from 11 on carries the
   card's name and power limit.
"""

from __future__ import annotations

import collections
import contextlib
import http.client
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
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


# -- the smoke's own processes -----------------------------------------------------

PR_SET_CHILD_SUBREAPER = 36     # linux/prctl.h
# How long the processes below the smoke may take to end on their own after
# the last phase stopped what it started (a server's multiprocessing resource
# tracker outlives it by a moment): what runs longer was left running.
ORPHAN_GRACE_S = 30.0
# The phases run in a child process (this flag) under a supervisor that
# outlives it. Past SMOKE_DEADLINE_S seconds (the command's limit is 1,200 s),
# or on SIGTERM, SIGINT or SIGHUP, the supervisor kills the child and every
# process below it and fails: a smoke cut by its time limit or a crash of the
# phases' process leaves no server behind.
PHASES_FLAG = "--phases"
SMOKE_DEADLINE_S = 1150.0


def adopt_orphans() -> None:
    """Make this process the subreaper of every process it starts: one that
    outlives its parent (a server's worker or resource tracker, a host agent
    in its own session) is re-parented here, not to the machine's init, so
    ``stop_descendants`` sees it and waits for it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        print(f"chip_smoke: prctl(PR_SET_CHILD_SUBREAPER) failed: "
              f"{os.strerror(ctypes.get_errno())}", file=sys.stderr, flush=True)


def descendants() -> dict[int, str]:
    """Every live process below this one (from /proc): pid -> command line.
    Zombies are left out (``reap`` collects this process's)."""
    parents: dict[int, int] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
        except OSError:
            continue  # ended meanwhile
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if state != "Z":
            parents[int(entry)] = int(ppid)
    found, frontier = {}, [os.getpid()]
    while frontier:
        below = [pid for pid, ppid in parents.items() if ppid in frontier]
        for pid in below:
            try:
                found[pid] = Path(f"/proc/{pid}/cmdline").read_bytes() \
                    .replace(b"\0", b" ").decode(errors="replace").strip()[:200]
            except OSError:
                found[pid] = "?"
        frontier = below
    return found


def reap() -> None:
    """Collect every child of this process that has ended (the orphans
    re-parented here included)."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_descendants(grace_s: float = ORPHAN_GRACE_S) -> dict[int, str]:
    """After the last phase: wait up to ``grace_s`` for every process below
    this one to end, then SIGKILL what still runs and reap it all. Returns
    the processes that had to be killed (pid -> command line)."""
    deadline = time.monotonic() + grace_s
    while True:
        reap()
        left = descendants()
        if not left or time.monotonic() >= deadline:
            break
        time.sleep(0.2)
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 10.0
    while descendants() and time.monotonic() < deadline:
        reap()
        time.sleep(0.1)
    reap()
    return left


def supervise() -> int:
    """The smoke's outer process: the subreaper of everything the phases
    start. It runs the phases in a child (``PHASES_FLAG``) that inherits its
    output, relays the child's exit code, and once the child has ended (on
    its own, by a crash, or killed past ``SMOKE_DEADLINE_S`` or on a signal)
    stops every process still below it; one left running fails the smoke."""
    adopt_orphans()
    t0 = time.monotonic()
    stop: list[int] = []
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(sig, lambda signum, _frame: stop.append(signum))
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), PHASES_FLAG])
    cut, rc = None, None
    while cut is None and rc is None:
        with contextlib.suppress(subprocess.TimeoutExpired):
            rc = child.wait(timeout=0.5)
        if stop:
            cut = f"signal {signal.Signals(stop[0]).name}"
        elif rc is None and time.monotonic() - t0 > SMOKE_DEADLINE_S:
            cut = f"the smoke's deadline of {SMOKE_DEADLINE_S:g} s"
    if cut is not None:
        child.kill()
        child.wait()
    left = stop_descendants(grace_s=0.0 if cut else ORPHAN_GRACE_S)
    if cut is not None:
        print(f"chip_smoke: FAIL: the phases were stopped by {cut} after "
              f"{time.monotonic() - t0:.1f} s; {len(left)} processes below them killed: "
              + "; ".join(f"{pid} {cmd}" for pid, cmd in left.items()),
              file=sys.stderr, flush=True)
        return 1
    if left:
        print("chip_smoke: FAIL: processes still running after the phases' process "
              "ended (killed): " + "; ".join(f"{pid} {cmd}" for pid, cmd in left.items()),
              file=sys.stderr, flush=True)
        return 1
    if rc < 0:
        print(f"chip_smoke: FAIL: the phases' process died of signal "
              f"{signal.Signals(-rc).name}", file=sys.stderr, flush=True)
        return 1
    return rc


class Apart:
    """One phase run in a process of its own (``--only``) beside the phases
    this process runs. Two phases that work on the card in process cannot
    share a process (a graph capture in one thread and work on the card in
    another), but two processes can share the card. ``result()`` waits for
    it and returns what the phase function returned."""

    def __init__(self, label: str, fn, *args) -> None:
        import pickle

        self.label = label
        self.tmp = Path(tempfile.mkdtemp(prefix="smoke-apart-"))
        (self.tmp / "args.pkl").write_bytes(pickle.dumps(args))
        self.proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                      PHASES_FLAG, "--only", fn.__name__, label,
                                      str(self.tmp), repr(_T_START)])

    def result(self):
        import pickle

        try:
            rc = self.proc.wait()
            check(rc == 0, f"phase {self.label}, in a process of its own, exited {rc}")
            return pickle.loads((self.tmp / "result.pkl").read_bytes())
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


def run_apart(name: str, label: str, tmp: Path, t_start: float) -> int:
    """The process ``Apart`` starts: run phase function ``name`` on the
    pickled arguments in ``tmp`` and pickle what it returns there. Its
    ``timed`` line counts from ``t_start``, the starting process's start
    (``time.perf_counter`` reads the machine's monotonic clock)."""
    import faulthandler
    import pickle

    global _T_START
    _T_START = t_start
    faulthandler.enable()
    sys.path.insert(0, str(ROOT))
    args = pickle.loads((tmp / "args.pkl").read_bytes())
    try:
        out = timed(label, globals()[name], *args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        stop_prestarted()
    (tmp / "result.pkl").write_bytes(pickle.dumps(out))
    return 0


_T_START = time.perf_counter()


def timed(label: str, fn, *args, **kwargs):
    """Run one phase and print its wall time and when it ended, from the
    start of the phases' process."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        end = time.perf_counter()
        print(f"smoke: phase {label} took {end - t0:.1f} s, ended at "
              f"{end - _T_START:.1f} s", flush=True)


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


def plain_k1(q, k, v, bias, rows: int | None = None):
    """K1's plain version, ``rows`` batch rows at a time (all at once by
    default), so a large batch's float32 scores fit beside the rest."""
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    rows = rows or q.shape[0]
    return torch.cat([fa.flash_attention_reference(q[i:i + rows], k[i:i + rows], v[i:i + rows],
                                                   bias[i:i + rows])
                      for i in range(0, q.shape[0], rows)])


def compare(q, k, v, bias, scaled: bool = False, rows: int | None = None) -> float:
    """K1 against its plain version in float32: |err| <= atol + rtol |plain|.
    With ``scaled`` the bf16 atol is that share of max |plain| (outputs far
    below 1, where an absolute 1.6e-2 would hide a dropped key tile)."""
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    out = fa.flash_attention(q, k, v, bias)
    ref = plain_k1(q.float(), k.float(), v.float(), bias, rows)
    torch.cuda.synchronize()
    check(out.dtype == q.dtype and out.shape == q.shape, f"K1 output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"K1 non-finite output at {tuple(q.shape)}")
    tol = F32_TOL if q.dtype == torch.float32 else BF16_TOL
    rtol = 0.0 if q.dtype == torch.float32 else BF16_TOL
    if scaled:
        tol *= ref.abs().max().item()
    err = (out.float() - ref).abs()
    bad = err > tol + rtol * ref.abs()
    check(not bool(bad.any()), f"K1 disagrees with its plain version at q {tuple(q.shape)} "
          f"k {tuple(k.shape)} {q.dtype}: max abs err {err.max().item():.3g} (atol {tol:.3g})")
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


def k1_timing(b: int, s: int, h: int = 12, d: int = 64, plain_iters: int = 50) -> dict:
    """K1, its plain version (over ``plain_iters`` calls: fewer where its
    float32 scores take gigabytes) and the SDPA yardstick at one bf16 shape
    with padded keys, beside the least time the card could take."""
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    q, k, v, bias = qkv(b, s, s, h, d, torch.bfloat16, seed=7)
    max_err = compare(q, k, v, bias)
    mask4 = bias.to(torch.bfloat16)[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timed = time_calls(lambda: fa.flash_attention(q, k, v, bias))
    ms = timed["device_ms"]
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, bias), iters=plain_iters)
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


# -- phase 5b: the mesh modes on one card ----------------------------------------

# The mesh phase's modes: (name, ModelConfig fields, [parallel] n_chips), and
# the K1 shapes (B, S, H, D) each launches at the (32, 128) bucket with its
# launches over one batch dispatched on each replica (12 per batch: two in
# replica mode).
MESH_MODES = (
    ("sharded_d2", {"parallelism": "sharded"}, 2, {(16, 128, 12, 64): 24}),
    ("replica_2", {"parallelism": "replica"}, 2, {(32, 128, 12, 64): 24}),
    ("tp_2", {"parallelism": "sharded", "tp": 2}, 2, {(32, 128, 6, 64): 24}),
    # pp = 2: _pp_micro gives 4 microbatches of 8 rows, 12 layers each.
    ("pipeline_2", {"parallelism": "pipeline", "pp": 2}, 0, {(8, 128, 12, 64): 48}),
)
MESH_DISPATCHES = 64


def mesh_runtime(fields: dict, n_chips: int):
    """Full-width BERT-flash (examples/bert_flash.toml, one (32, 128)
    bucket, the run's shared seeded parameters) on a runtime of the mode
    ``fields`` names, its ranks on cuda:0: one parameter slot, so one graph
    per replica (phase 9's default-layout server holds the lifecycle's
    three)."""
    import dataclasses

    from tpuserve_torch.config import ParallelConfig
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    mcfg = dataclasses.replace(model_config("flash"), batch_buckets=[32],
                               seq_buckets=[128], **fields)
    model = share_params(build(mcfg), CONFIG)
    return model, build_runtime(model, device="cuda", n_slots=1,
                                parallel=ParallelConfig(n_chips=n_chips))


def mesh_logits(model, rt, dev):
    """The live slot's eager logits (float32) on ``dev``."""
    import torch

    from tpuserve_torch.models.base import MeshModule

    with torch.inference_mode():
        if isinstance(rt.module, MeshModule):
            return model.mesh_logits(rt.module, dev).float()
        return model.logits(rt.module, dev).float()


def mesh_launches(rt, bucket, devs) -> dict:
    """K1's launches by shape over one dispatch per replica."""
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    fa.reset_launches()
    outs = [rt.dispatch(bucket, dev, replica=i) for i, dev in enumerate(devs)]
    torch.cuda.synchronize()
    return outs, dict(fa.shape_launches)


def mesh_phase(card: str) -> dict:
    """Full-width BERT-flash in every mesh mode, the ranks sharing cuda:0
    (``visible_devices`` patched to four ranks on it): answers against
    single mode's, K1's launches by shape, no compile or capture over
    ``MESH_DISPATCHES`` dispatches, the replay device time beside single
    mode's (what smaller launches cost; nothing gated on it); int8 under
    tp = 2; textgen on a replica-2 GenEngineGroup."""
    import gc
    from unittest import mock

    import torch

    from tpuserve_torch.parallel import mesh as meshlib

    t0 = time.perf_counter()
    bucket = (32, 128)
    out: dict = {"card": card, "modes": {}}
    with mock.patch.object(meshlib, "visible_devices",
                           lambda *a: [torch.device("cuda", 0)] * 4):
        model, rt = mesh_runtime({"parallelism": "single"}, 0)
        host = seeded_batch(model, bucket, seed=5)
        dev = rt.h2d(bucket, host)
        (base_out,), base_k1 = mesh_launches(rt, bucket, [dev])
        check(base_k1 == {(32, 128, 12, 64): 12}, f"mesh: single mode's K1 launches {base_k1}")
        base_logits = mesh_logits(model, rt, dev)
        out["single"] = dict(replay_timing(rt, bucket, dev), k1_by_shape=by_shape(base_k1))
        del rt
        for name, fields, n_chips, want_k1 in MESH_MODES:
            mt0 = time.perf_counter()
            model, rt = mesh_runtime(fields, n_chips)
            devs = [rt.h2d(bucket, host, replica=i) for i in range(rt.n_replicas)]
            outs, k1 = mesh_launches(rt, bucket, devs)
            check(k1 == want_k1, f"mesh {name}: K1 launches by shape {k1}, expected {want_k1}")
            row = {"signature": rt.parallel_signature, "n_chips": rt.n_chips,
                   "replicas": rt.n_replicas,
                   "k1_by_shape": by_shape(k1)}
            if rt.n_replicas > 1:
                for i, o in enumerate(outs):
                    check(all(torch.equal(o[k], base_out[k]) for k in ("probs", "indices")),
                          f"mesh {name}: replica {i} does not answer single mode's bytes")
                row["answers"] = "single mode's bytes on every replica"
            else:
                logits = mesh_logits(model, rt, devs[0])
                diff = (logits - base_logits).abs().max().item()
                check(diff <= LOGIT_TOL, f"mesh {name}: logits {diff:.3g} from single mode's "
                      f"> {LOGIT_TOL}")
                row["max_abs_logit_diff"] = diff
                row["separated_ranks_held"] = separated_ranks_agree(
                    logits, base_logits, f"mesh {name}")
                # The graph replay's top-1 against the eager logits' wherever
                # those separate it by more than the tolerance.
                top2 = logits.topk(2, dim=-1).values
                sep = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
                check(bool((outs[0]["indices"][:, 0] == logits.argmax(-1))[sep].all()),
                      f"mesh {name}: the graph replay's top-1 differs from the eager logits'")
            graphs_hold(rt, bucket, devs, f"mesh {name}")
            check(all(v > 0 for v in rt.replica_batches()),
                  f"mesh {name}: a replica served no batch {rt.replica_batches()}")
            row.update(replay_timing(rt, bucket, devs[0]), compiles_total=rt.compiles_total,
                       captures_total=rt.captures_total,
                       replica_batches=rt.replica_batches(),
                       build_and_checks_s=time.perf_counter() - mt0)
            out["modes"][name] = row
            del rt
            gc.collect()
            torch.cuda.empty_cache()
        out["int8_tp_2"] = mesh_int8_check(bucket, host)
        out["modes_s"] = time.perf_counter() - t0
        out["textgen_replica_2"] = mesh_textgen_check()
    out["phase_s"] = time.perf_counter() - t0
    sigs = ", ".join(f"{n} {r['signature']}" for n, r in out["modes"].items())
    print(f"mesh: {sigs} "
          f"on one card: answers held, K1 by shape as expected, compiles/captures 0 over "
          f"{MESH_DISPATCHES} dispatches; replay device ms single "
          f"{out['single']['replay_device_ms']:.3f}, "
          + ", ".join(f"{n} {r['replay_device_ms']:.3f}" for n, r in out["modes"].items())
          + f"; {out['phase_s']:.1f} s", flush=True)
    return out


def graphs_hold(rt, bucket: tuple, devs: list, label: str) -> None:
    """No compile or capture over ``MESH_DISPATCHES`` dispatches, spread
    over the replicas."""
    import torch

    graphs0 = (rt.compiles_total, rt.captures_total)
    for i in range(MESH_DISPATCHES):
        rt.dispatch(bucket, devs[i % len(devs)], replica=i % len(devs))
    torch.cuda.synchronize()
    check((rt.compiles_total, rt.captures_total) == graphs0,
          f"{label}: compiles/captures moved {graphs0} -> "
          f"{(rt.compiles_total, rt.captures_total)} over {MESH_DISPATCHES} dispatches")


# -- phase 5c: the seq and model axes (ROADMAP items 9b.1-9b.2) --------------------

# Full-width BERT-base at a bucket where the per-rank score tile passes the
# 2 GiB that makes ring and Ulysses take a kernel as their local step: each
# mode (name, attention, ModelConfig fields, [parallel] n_chips, the kernel,
# its launches by shape over one batch) and single mode's launches of the
# same attention at sp 1. Ring on data 2 x seq 2: K2 at each rank's (8,
# 2048) block, 2 data x 2 seq ranks x 2 ring steps x 12 layers; Ulysses on
# model 2 x seq 2: K1 at each seq rank's 3 heads of all 4096 rows, 2 model x
# 2 seq ranks x 12 layers.
AXES_BUCKET = (16, 4096)
AXES_BERT = (
    ("ring_data2_seq2", "ring", {"parallelism": "sharded", "sp": 2}, 4,
     "k2", {(8, 2048, 12, 64): 96}, {(16, 4096, 12, 64): 12}),
    ("ulysses_model2_seq2", "ulysses", {"parallelism": "sharded", "tp": 2, "sp": 2}, 4,
     "k1", {(16, 4096, 3, 64): 48}, {(16, 4096, 12, 64): 12}),
)
# Replays per round and rounds of the long bucket's replay timing (a
# replay is tens of ms there).
AXES_REPLAYS = (4, 3)


def axes_runtime(mcfg, n_chips: int, key: str):
    """``mcfg``'s model on the run's shared seeded tree of ``key`` and a
    runtime of one parameter slot with its ranks on cuda:0."""
    from tpuserve_torch.config import ParallelConfig
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    model = share_params(build(mcfg), key)
    return model, build_runtime(model, device="cuda", n_slots=1,
                                parallel=ParallelConfig(n_chips=n_chips))


def kernel_launches(rt, bucket: tuple, dev: tuple) -> tuple:
    """One dispatch's output and K1's and K2's launches by shape in it."""
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    fa.reset_launches()
    out = rt.dispatch(bucket, dev)
    torch.cuda.synchronize()
    return out, {"k1": dict(fa.shape_launches), "k2": dict(fa.stats_shape_launches)}


def by_shape(counts: dict) -> dict:
    return {"x".join(map(str, k)): n for k, n in counts.items()}


def free_runtime() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def mesh_axes_bert() -> dict:
    """Ring on data 2 x seq 2 and Ulysses on model 2 x seq 2 at the long
    bucket, each against its attention in single mode."""
    import dataclasses

    import torch

    from tpuserve_torch.config import load_config

    base_cfg = load_config(str(LONG_CONFIG)).models[0]
    key = f"{LONG_CONFIG.relative_to(ROOT)} at seq {AXES_BUCKET[1]}"
    out, host = {}, None
    for name, attention, fields, n_chips, kernel, want, want_single in AXES_BERT:
        t0 = time.perf_counter()
        other = "k1" if kernel == "k2" else "k2"
        mcfg = dataclasses.replace(base_cfg, batch_buckets=[AXES_BUCKET[0]],
                                   seq_buckets=[AXES_BUCKET[1]],
                                   options={**base_cfg.options, "attention": attention})
        model, single = axes_runtime(dataclasses.replace(mcfg, parallelism="single"), 0, key)
        host = host if host is not None else seeded_batch(model, AXES_BUCKET, seed=9)
        dev = single.h2d(AXES_BUCKET, host)
        _, got = kernel_launches(single, AXES_BUCKET, dev)
        check(got == {kernel: want_single, other: {}},
              f"mesh {name}: single mode's launches by shape {got}")
        base = mesh_logits(model, single, dev)
        row = {"single": dict(replay_timing(single, AXES_BUCKET, dev, *AXES_REPLAYS),
                              **{f"{kernel}_by_shape": by_shape(got[kernel])})}
        del single
        free_runtime()
        model, rt = axes_runtime(dataclasses.replace(mcfg, **fields), n_chips, key)
        dev = rt.h2d(AXES_BUCKET, host)
        served, got = kernel_launches(rt, AXES_BUCKET, dev)
        check(got == {kernel: want, other: {}},
              f"mesh {name}: launches by shape {got}, expected {kernel} {want}")
        logits = mesh_logits(model, rt, dev)
        diff = (logits - base).abs().max().item()
        check(bool(torch.isfinite(logits).all()) and diff <= LOGIT_TOL,
              f"mesh {name}: logits {diff:.3g} from single mode's > {LOGIT_TOL}")
        top2 = logits.topk(2, dim=-1).values
        sep = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
        check(bool((served["indices"][:, 0] == logits.argmax(-1))[sep].all()),
              f"mesh {name}: the graph replay's top-1 differs from the eager logits'")
        graphs_hold(rt, AXES_BUCKET, [dev], f"mesh {name}")
        row.update(signature=rt.parallel_signature, mesh_shape=dict(rt.mesh.shape),
                   max_abs_logit_diff=diff,
                   separated_ranks_held=separated_ranks_agree(logits, base, f"mesh {name}"),
                   compiles_total=rt.compiles_total, captures_total=rt.captures_total,
                   **{f"{kernel}_by_shape": by_shape(got[kernel])},
                   **replay_timing(rt, AXES_BUCKET, dev, *AXES_REPLAYS),
                   build_and_checks_s=time.perf_counter() - t0)
        out[name] = row
        del rt
        free_runtime()
    return out


def mesh_axes_vision() -> dict:
    """ResNet-50 split over "model" against single mode by the logit rule;
    MobileNetV3 and EfficientDet-D0 (replicated over "model") on single
    mode's bytes."""
    import dataclasses

    from tpuserve_torch.config import load_config

    out = {}
    cases = [(RESNET_CONFIG, m, (32,)) for m in ("resnet50", "resnet50_rgb")]
    cases += [(MNV3_CONFIG, "mobilenetv3", (8,)), (DET_CONFIG, "efficientdet", (8,))]
    for config, name, bucket in cases:
        t0 = time.perf_counter()
        mcfg = dataclasses.replace(
            next(m for m in load_config(str(config)).models if m.name == name),
            batch_buckets=[bucket[0]])
        key = str(config)
        model, single = axes_runtime(dataclasses.replace(mcfg, parallelism="single"), 0, key)
        host = seeded_batch(model, bucket, seed=13)
        dev = single.h2d(bucket, host)
        base_out = single.fetch(single.dispatch(bucket, dev))
        base = mesh_logits(model, single, dev) if name.startswith("resnet") else None
        row = {"single": replay_timing(single, bucket, dev)}
        del single
        free_runtime()
        model, rt = axes_runtime(dataclasses.replace(mcfg, parallelism="sharded", tp=2), 2, key)
        dev = rt.h2d(bucket, host)
        got = rt.fetch(rt.dispatch(bucket, dev))
        if base is None:
            check(sorted(got) == sorted(base_out)
                  and all(got[k].tobytes() == base_out[k].tobytes() for k in base_out),
                  f"mesh {name} tp_2: the answers differ from single mode's bytes")
            row["answers"] = "single mode's bytes"
        else:
            logits = mesh_logits(model, rt, dev)
            scale = base.abs().max().item()
            diff = (logits - base).abs().max().item()
            check(diff <= RESNET_LOGIT_REL * scale,
                  f"mesh {name} tp_2: logits {diff:.3g} from single mode's, > "
                  f"{RESNET_LOGIT_REL} x {scale:.3g}")
            row.update(max_abs_logit_diff=diff, logit_scale=scale,
                       separated_ranks_held=separated_ranks_agree(
                           logits, base, f"mesh {name} tp_2", RESNET_LOGIT_REL * scale))
        graphs_hold(rt, bucket, [dev], f"mesh {name} tp_2")
        row.update(signature=rt.parallel_signature, mesh_shape=dict(rt.mesh.shape),
                   rank_modules=len(rt.module.ranks), compiles_total=rt.compiles_total,
                   captures_total=rt.captures_total, **replay_timing(rt, bucket, dev),
                   build_and_checks_s=time.perf_counter() - t0)
        out[f"{name}_tp_2"] = row
        del rt
        free_runtime()
    return out


# SD 1.5 on data 2 x model 2 (item 9b.4, phase 5d): examples/sd15_flash.toml
# at the (2,) bucket, one parameter slot, the engine's programs (8 slots)
# captured on the same runtime; 4 requests through the engine, then the
# same in reverse order (other slots). The locked batch's replay timing's
# dispatches (a replay is ~0.8 s) are the compile and capture gate's.
SD_MESH_FIELDS = {"parallelism": "sharded", "tp": 2}
SD_MESH_CHIPS = 4
SD_MESH_SLOTS = 8
SD_MESH_REQUESTS = 4
SD_MESH_REPLAYS = (2, 3)
# The split images against single mode's: the model ranks' partial sums in
# bf16 drift a 20-step image by a pixel or two (on an H100: mean abs 0.98-1.70,
# 25-32 % of the pixels equal); a rank that computes the wrong thing moves
# the image far past these limits.
SD_MESH_PIXEL_MEAN = 4.0
SD_MESH_PIXEL_EQUAL = 0.15
# K1's shapes per padded level: (latent tokens, head dim, padded head dim).
SD_LEVELS = ((4096, 40, 64), (1024, 80, 128))


def sd_k1_want(rows: int, tp: int, calls: int) -> dict:
    """K1's launches by shape over ``calls`` UNet calls of ``rows`` rows on
    ``tp`` model ranks: each rank's 5 flash attentions a level at its 8 /
    tp heads."""
    return {(rows, s_, 8 // tp, dp): 5 * tp * calls for s_, _, dp in SD_LEVELS}


def engine_results(eng, waves: list) -> list:
    """The results of each list of items in ``waves`` through an
    in-process engine, one wave after the other (started and stopped
    once)."""
    import asyncio

    async def go():
        await eng.start()
        out = [await asyncio.gather(*[eng.submit(it) for it in items]) for items in waves]
        await eng.stop()
        return out

    return asyncio.run(go())


def sd_mesh_side(fields: dict, n_chips: int, params: dict, items: list, unet_in: tuple) -> dict:
    """SD 1.5 (``SD_CONFIG``'s model on ``params``) on a runtime of the
    mode ``fields`` names, ranks on cuda:0, bucket (2,), one parameter
    slot, its engine's programs captured on it: one 2-row UNet call on its
    first data rank's module (the model ranks' ``TPView`` when split), the
    locked batch of ``items[:2]`` (replay against the eager forward, the
    same bytes twice, no compile or capture over the replay timing's
    dispatches), the engine on ``items`` and on them reversed (the same
    PNG bytes, no compile or capture), K1's launches by shape in each, and
    the replay and engine device times."""
    import dataclasses

    import torch

    from tpuserve_torch.config import ParallelConfig, load_config
    from tpuserve_torch.genserve import GenEngine
    from tpuserve_torch.models import build
    from tpuserve_torch.models.base import MeshModule
    from tpuserve_torch.obs import Metrics
    from tpuserve_torch.ops import flash_attention as fa
    from tpuserve_torch.runtime import build_runtime

    t0 = time.perf_counter()
    cfg = load_config(str(SD_CONFIG))
    model = build(dataclasses.replace(cfg.models[0], batch_buckets=[2], **fields))
    model.load_params = lambda: params
    rt = build_runtime(model, device="cuda", n_slots=1, parallel=ParallelConfig(n_chips=n_chips))
    eng = GenEngine(model, rt, Metrics(), dataclasses.replace(cfg.genserve, slots=SD_MESH_SLOTS))
    eng.compile()
    dp, tp = rt.mesh.shape["data"], rt.mesh.shape["model"]
    label = f"mesh sd15 {rt.parallel_signature} tp {tp}"
    split = isinstance(rt.module, MeshModule)
    out = {"signature": rt.parallel_signature, "mesh_shape": dict(rt.mesh.shape),
           "rank_modules": len(rt.module.ranks) if split else 1,
           "startup_s": time.perf_counter() - t0}
    unet = model.data_ranks(rt.module)[0] if split else rt.module
    fa.reset_launches()
    with torch.inference_mode():
        out["eps"] = unet.unet(*unet_in).float()
    torch.cuda.synchronize()
    got = dict(fa.shape_launches)
    check(got == sd_k1_want(2, tp, 1), f"{label}: one 2-row UNet call launched K1 {got}")
    out["unet_k1_by_shape"] = by_shape(got)
    bucket = (2,)
    dev = rt.h2d(bucket, model.assemble(items[:2], bucket))
    fa.reset_launches()
    first = rt.dispatch(bucket, dev)
    torch.cuda.synchronize()
    got = dict(fa.shape_launches)
    want = sd_k1_want(2 * (2 // dp), tp, SD_STEPS * dp)
    check(got == want, f"{label}: the locked batch launched K1 {got}, expected {want}")
    out["locked_k1_by_shape"] = by_shape(got)
    graphs0 = (rt.compiles_total, rt.captures_total)
    out.update(replay_timing(rt, bucket, dev, *SD_MESH_REPLAYS))
    check((rt.compiles_total, rt.captures_total) == graphs0,
          f"{label}: compiles/captures moved {graphs0} over the replays")
    second = rt.dispatch(bucket, dev)
    with torch.inference_mode():
        eager = (model.mesh_forward if split else model.forward)(rt.module, dev)
    check(torch.equal(first["image"], second["image"]),
          f"{label}: the same locked batch twice gave other bytes")
    check(torch.equal(first["image"], eager["image"]),
          f"{label}: the locked replay differs from the eager forward")
    out["images"] = first["image"].cpu().numpy()
    steps0 = eng.pipeline_stats()["iterations_total"]
    fa.reset_launches()
    pngs, again = engine_results(eng, [items, items[::-1]])
    steps = eng.pipeline_stats()["iterations_total"] - steps0
    got = dict(fa.shape_launches)
    want = sd_k1_want(2 * SD_MESH_SLOTS, tp, steps)
    check(again[::-1] == pngs, f"{label}: the same requests in other slots gave other PNG "
          f"bytes ({sum(a != b for a, b in zip(again[::-1], pngs))} of {len(pngs)})")
    check(steps > 0 and got == want, f"{label}: the engine launched K1 {got} in {steps} steps, "
          f"expected {want}")
    check((rt.compiles_total, rt.captures_total) == graphs0,
          f"{label}: the engine moved compiles/captures {graphs0}")
    out.update(pngs=pngs, engine_steps=steps, engine_k1_by_shape=by_shape(got),
               compiles_total=rt.compiles_total, captures_total=rt.captures_total,
               engine=sd_engine_timing(rt, eng, items[0], label=label),
               build_and_checks_s=time.perf_counter() - t0)
    del eng, rt
    free_runtime()
    return out


def mesh_axes_sd() -> dict:
    """SD 1.5 at full width on data 2 x model 2 (item 9b.4) against single
    mode on the same seeded weights: one bf16 2-row UNet call's eps within
    ``SD_EPS_REL`` of single mode's scale, every locked and engine image
    within ``SD_MESH_PIXEL_MEAN`` mean abs pixel difference of single
    mode's with at least ``SD_MESH_PIXEL_EQUAL`` of its pixels equal, each
    side's gates (``sd_mesh_side``) and device times."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    model = sd_model()
    params = model.init_params(0, "cuda")
    items = [model.host_decode(json.dumps(b).encode(), "application/json")
             for b in sd_bodies()[:SD_MESH_REQUESTS]]
    g = torch.Generator(device="cuda").manual_seed(3)
    unet_in = (torch.randn(2, 64, 64, 4, generator=g, device="cuda"),
               torch.tensor([500, 500], dtype=torch.int32, device="cuda"),
               torch.randn(2, 77, 768, generator=g, device="cuda").to(torch.bfloat16))
    single = sd_mesh_side({"parallelism": "single"}, 0, params, items, unet_in)
    split = sd_mesh_side(SD_MESH_FIELDS, SD_MESH_CHIPS, params, items, unet_in)
    del params
    free_runtime()
    scale = float(single["eps"].abs().max())
    diff = float((split.pop("eps") - single.pop("eps")).abs().max())
    check(diff <= SD_EPS_REL * scale, f"mesh sd15: the split UNet call's eps differ from "
          f"single mode's by {diff:.4g}, over {SD_EPS_REL} of its scale {scale:.4g}")

    def pixels(a, b) -> dict:
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        return {"max_abs": int(d.max()), "mean_abs": float(d.mean()),
                "equal_share": float((d == 0).mean())}

    locked = [pixels(a, b) for a, b in zip(split.pop("images"), single.pop("images"))]
    engine = [pixels(read_png(a), read_png(b))
              for a, b in zip(split.pop("pngs"), single.pop("pngs"))]
    out = {"single": single, "data2_model2": split,
           "unet_eps": {"max_abs_diff": diff, "single_max_abs": scale,
                        "share_of_scale": diff / scale, "bound_share": SD_EPS_REL},
           "locked_vs_single": locked, "engine_vs_single": engine,
           "k1_launches": {f"sd_{k}": n for k, n in {**split["locked_k1_by_shape"],
                                                     **split["engine_k1_by_shape"]}.items()},
           "phase_s": time.perf_counter() - t0}
    print(f"mesh sd15: data 2 x model 2 against single: UNet eps {diff:.4g} = "
          f"{diff / scale:.4f} of the scale (bound {SD_EPS_REL}); locked PNGs max/mean abs pixel "
          + ", ".join(f"{p['max_abs']}/{p['mean_abs']:.3f}" for p in locked)
          + "; engine PNGs " + ", ".join(f"{p['max_abs']}/{p['mean_abs']:.3f}" for p in engine)
          + f"; locked replay {split['replay_device_ms']:.1f} vs {single['replay_device_ms']:.1f} "
          f"ms, engine step at 8 slots {split['engine'][8]['step_device_ms']:.1f} vs "
          f"{single['engine'][8]['step_device_ms']:.1f} ms; K1 locked "
          f"{split['locked_k1_by_shape']}, engine {split['engine_k1_by_shape']} in "
          f"{split['engine_steps']} steps; {out['phase_s']:.1f} s", flush=True)
    for what, rows in (("locked image", locked), ("engine PNG", engine)):
        for i, p in enumerate(rows):
            check(p["mean_abs"] <= SD_MESH_PIXEL_MEAN and p["equal_share"] >= SD_MESH_PIXEL_EQUAL,
                  f"mesh sd15: {what} {i} differs from single mode's by {p['mean_abs']:.3f} "
                  f"mean abs pixel with {p['equal_share']:.3f} of its pixels equal (limits "
                  f"{SD_MESH_PIXEL_MEAN}, {SD_MESH_PIXEL_EQUAL})")
    return out


def mesh_sd_phase(card: str) -> dict:
    """Phase 5d: item 9b.4 on the card (``mesh_axes_sd``), the ranks on
    cuda:0 as phase 5c's, in a process of its own beside 5c, 15, 18, 19
    and 26."""
    from unittest import mock

    import torch

    from tpuserve_torch.parallel import mesh as meshlib

    with mock.patch.object(meshlib, "visible_devices",
                           lambda *a: [torch.device("cuda", 0)] * 4):
        return dict(mesh_axes_sd(), card=card)


def mesh_axes_phase(card: str) -> dict:
    """Phase 5c: items 9b.1 and 9b.2 on the card, the ranks on cuda:0
    (``visible_devices`` patched to four ranks on it, as phase 5b's; 9b.3's
    textgen cases run in 5b's ``mesh_sharded_decode_check``); each new
    mode's replay device time beside single mode's is printed."""
    from unittest import mock

    import torch

    from tpuserve_torch.parallel import mesh as meshlib

    t0 = time.perf_counter()
    with mock.patch.object(meshlib, "visible_devices",
                           lambda *a: [torch.device("cuda", 0)] * 4):
        out = {"card": card, "bert": mesh_axes_bert(), "vision": mesh_axes_vision()}
    out["phase_s"] = time.perf_counter() - t0
    rows = {**out["bert"], **out["vision"]}
    print("mesh axes: replay device ms (mode vs single) "
          + ", ".join(f"{n} {r['replay_device_ms']:.3f} vs {r['single']['replay_device_ms']:.3f}"
                      for n, r in rows.items())
          + f"; launches {[r.get('k1_by_shape', r.get('k2_by_shape')) for r in out['bert'].values()]}"
          f"; {out['phase_s']:.1f} s", flush=True)
    return out


def mesh_k1_phase() -> dict:
    """K1 at each of phase 5b's new shapes, timed as phase 3 times the main
    path's, with the launches one (32, 128) batch makes there on its mode's
    path, and at phases 5c's and 5d's (Ulysses' local step; SD 1.5's
    model ranks, ``sd_k1_row`` at 4 heads, whose launches ``main`` takes
    from 5d's counts). Run once no other phase uses the card: phase 5b itself runs
    beside phase 9's and 12's servers, whose work would stretch the
    kernel's device time."""
    out = {}
    for name, _, _, want_k1 in MESH_MODES:
        for (b, s_, h, d), n in want_k1.items():
            if (b, s_, h) != (32, 128, 12):
                row = k1_timing(b, s_, h=h, d=d)
                row["line"]["launches"] = n
                row["line"]["launches_path"] = f"mesh {name}, one (32, 128) batch"
                out[f"{b}x{s_}x{h}x{d}"] = row
    # Ulysses' local step on model 2 x seq 2 at the long bucket (the plain
    # version's float32 scores take 3.2 GB there: 3 calls, as phase 26's).
    for name, _, _, _, kernel, want, _ in AXES_BERT:
        for (b, s_, h, d), n in want.items():
            if kernel == "k1":
                row = k1_timing(b, s_, h=h, d=d, plain_iters=3)
                row["line"]["launches"] = n
                row["line"]["launches_path"] = f"mesh {name}, one {AXES_BUCKET} batch"
                out[f"{b}x{s_}x{h}x{d}"] = row
    # SD 1.5's model ranks on data 2 x model 2 (phase 5d): 4 of 8 heads at
    # each padded level, 2 rows on the locked path, 2 x 8 slots in the
    # engine's step; their launches are phase 5d's counts (main).
    for b in (2, 2 * SD_MESH_SLOTS):
        for s_, d, dp in SD_LEVELS:
            row = sd_k1_row(b, s_, d, heads=4)
            row["line"]["launches_path"] = (
                "mesh sd15 data 2 x model 2, one (2,) locked batch" if b == 2 else
                f"mesh sd15 data 2 x model 2, the engine's steps at {SD_MESH_SLOTS} slots")
            out[f"sd_{b}x{s_}x4x{dp}"] = row
    return out


def mesh_int8_check(bucket: tuple, host: tuple) -> dict:
    """tp = 2 under quantize = "int8" against single mode's int8: the same
    logit rule and K1 launches as tp = 2."""
    import gc

    import torch

    model, rt = mesh_runtime({"parallelism": "single", "quantize": "int8"}, 0)
    base = mesh_logits(model, rt, rt.h2d(bucket, host))
    base_out = rt.fetch(rt.dispatch(bucket, rt.h2d(bucket, host)))
    del rt
    model, rt = mesh_runtime({"parallelism": "sharded", "tp": 2, "quantize": "int8"}, 2)
    dev = rt.h2d(bucket, host)
    outs, k1 = mesh_launches(rt, bucket, [dev])
    check(k1 == {(32, 128, 6, 64): 24}, f"mesh int8 tp_2: K1 launches {k1}")
    logits = mesh_logits(model, rt, dev)
    diff = (logits - base).abs().max().item()
    check(diff <= LOGIT_TOL, f"mesh int8 tp_2: logits {diff:.3g} from single int8's")
    held = separated_ranks_agree(logits, base, "mesh int8 tp_2")
    n_int8 = sum(t.dtype == torch.int8 for t in rt.slots[0].tensors.values())
    check(n_int8 >= 2 * 12 * 6, f"mesh int8 tp_2: {n_int8} int8 tensors in a slot")
    same_top1 = bool((rt.fetch(outs[0])["indices"][:, 0] == base_out["indices"][:, 0]).all())
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_logit_diff": diff, "separated_ranks_held": held,
            "int8_tensors_per_slot": n_int8, "top1_equal_to_single_int8": same_top1}


def mesh_textgen_check() -> dict:
    """examples/textgen_flash.toml at SHALLOW_LAYERS layers: a replica-2
    GenEngineGroup's tokens equal a single engine's on the same seeded
    weights, and both replicas step."""
    import dataclasses
    import gc

    import torch

    from tpuserve_torch.config import ParallelConfig, load_config
    from tpuserve_torch.genserve import GenEngine, GenEngineGroup
    from tpuserve_torch.models import build
    from tpuserve_torch.obs import Metrics
    from tpuserve_torch.runtime import build_runtime

    cfg = load_config(str(TEXTGEN_CONFIG))
    mcfg = cfg.models[0]
    shallow = {**mcfg.options, "layers": SHALLOW_LAYERS}
    gcfg = dataclasses.replace(cfg.genserve, slots=8)
    params = None
    tokens = {}
    for mode in ("single", "replica"):
        model = build(dataclasses.replace(mcfg, options=shallow, parallelism=mode))
        params = params if params is not None else model.load_params()
        model.load_params = lambda p=params: p
        rt = build_runtime(model, device="cuda", compile_forward=False, n_slots=1,
                           parallel=ParallelConfig(n_chips=2))
        eng = (GenEngineGroup if mode == "replica" else GenEngine)(model, rt, Metrics(), gcfg)
        eng.compile()
        items = [model.host_decode(json.dumps(b).encode(), "application/json")
                 for b in textgen_bodies(8, seed=3)]
        tokens[mode] = [list(map(int, t)) for t in engine_tokens(eng, items)]
        if mode == "replica":
            rows = eng.pipeline_stats()["per_replica"]
            check(all(r["steps_total"] > 0 for r in rows),
                  f"mesh textgen: a replica did not step {rows}")
            compiles = rt.compiles_total
        del eng, rt
        gc.collect()
        torch.cuda.empty_cache()
    check(tokens["replica"] == tokens["single"],
          "mesh textgen: the replica group's tokens differ from the single engine's")
    return {"layers": SHALLOW_LAYERS, "requests": len(tokens["single"]),
            "tokens": sum(map(len, tokens["single"])), "compiles_total": compiles,
            "per_replica_steps": [r["steps_total"] for r in rows],
            "sharded_decode_tp_2_float32": mesh_sharded_decode_check(mcfg, shallow, gcfg)}


def mesh_sharded_decode_check(mcfg, options: dict, gcfg) -> dict:
    """The sharded decode (tp = 2, paged KV over the default, odd, page
    count: the pages replicate over "seq") and the KV context on "seq"
    (sp = 2 on dense KV; tp = 2 x sp = 2 on paged KV over an even page
    count) against single mode, float32 (TF32 off): each engine's tokens
    against the single locked batch's,
    a lane allowed to differ first only where that batch's top-two margin
    is below ``TG_MARGIN`` (the partial sums add in another order), as
    phase 17 holds the engine to the locked batch."""
    import dataclasses
    import gc

    import torch

    from tpuserve_torch.config import ParallelConfig
    from tpuserve_torch.genserve import GenEngine
    from tpuserve_torch.models import build
    from tpuserve_torch.obs import Metrics
    from tpuserve_torch.runtime import build_runtime

    paged = dataclasses.replace(gcfg, kv_paging=True, prefill_chunk=0)
    # An even page count splits over the seq axis; the default (slots x
    # pages per slot + the sentinel) is odd, and replicates (tp_2 above).
    pps = -(-(int(options["prompt_len"]) + int(options["max_new_tokens"]))
            // paged.kv_page_tokens)
    even = dataclasses.replace(paged, kv_pages=gcfg.slots * pps + 2)
    dense = dataclasses.replace(gcfg, kv_paging=False)
    out, params = {}, None
    for mode, fields, n_chips, gen in (
            ("single", {"parallelism": "single"}, 2, paged),
            ("tp_2", {"parallelism": "sharded", "tp": 2}, 2, paged),
            ("sp_2_dense", {"parallelism": "sharded", "sp": 2}, 2, dense),
            ("tp_2_sp_2_paged_even", {"parallelism": "sharded", "tp": 2, "sp": 2}, 4, even)):
        model = build(dataclasses.replace(mcfg, options=options, dtype="float32", **fields))
        params = params if params is not None else model.load_params()
        model.load_params = lambda p=params: p
        rt = build_runtime(model, device="cuda", compile_forward=False, n_slots=1,
                           parallel=ParallelConfig(n_chips=n_chips))
        items = [model.host_decode(json.dumps(b).encode(), "application/json")
                 for b in textgen_bodies(8, seed=3)]
        if mode == "single":
            want, margins, _ = locked_tokens(model, rt.module, items)
        eng = GenEngine(model, rt, Metrics(), gen)
        eng.compile()
        got = [list(map(int, t)) for t in engine_tokens(eng, items)]
        out[mode] = compare_tokens(got, [list(map(int, w)) for w in want], margins,
                                   f"mesh textgen {mode} engine vs single locked (float32)")
        blocks = model._seq_blocks({k: v for k, v in rt.state_blocks[0].items()
                                    if k in ("k", "kp")})
        check(blocks == fields.get("sp", 1),
              f"mesh textgen {mode}: the KV context splits over {blocks} seq ranks")
        pool = rt.state_blocks[0].get("kp")
        out[mode].update(mesh_shape=dict(rt.mesh.shape), kv_seq_blocks=blocks,
                         kv_pages=None if pool is None else pool.shape[0])
        if mode == "tp_2":
            out["signature"] = rt.parallel_signature
        del eng, rt
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phase 6: BERT-base with flash attention -------------------------------------

CONFIG = ROOT / "examples" / "bert_flash.toml"
LONG_CONFIG = ROOT / "examples" / "bert_long_ring.toml"
# The witnesses as a user arms them (tpuserve_torch.analysis.witness): phase
# 11's server runs under both, phase 23's fleet under the retrace witness.
RETRACE_ENV = (("TPUSERVE_RETRACE_WITNESS", "1"),)
WITNESS_ENV = (("TPUSERVE_LOCK_WITNESS", "1"),) + RETRACE_ENV


def model_config(attention: str, config: Path = CONFIG):
    import dataclasses

    from tpuserve_torch.config import load_config

    mcfg = load_config(str(config)).models[0]
    return dataclasses.replace(mcfg, options={**mcfg.options, "attention": attention})


# Phases 9 (BERT's lifecycle drill), 12, 15 (int8c BERT) and 16 serve
# examples/bert_flash.toml at this depth, every width as published: at 12
# layers the smoke with phase 21 ran past its time limit (1,272.2 s on an
# H100 80GB HBM3 at 700 W; PERF.md). Their checks are of structure
# (versions, answers equal or not, exit codes, counts) and of time, and
# phase 15's int8c-against-int8 logits keep their tolerance, a share of the
# logits' scale. The main path (phase 6), the MoE paths (a router flip is
# not bounded by their bf16 rule at another depth) and every other numeric
# comparison keep the 12 layers.
SHALLOW_LAYERS = 4


def shallow_config(config: Path = CONFIG) -> Path:
    """A copy of ``config`` (examples/bert_flash.toml by default) under
    build/ at SHALLOW_LAYERS layers (nothing else changed)."""
    text = config.read_text()
    cut = re.sub(r"(?m)^layers = 12$", f"layers = {SHALLOW_LAYERS}", text)
    check(cut != text, f"{config.name} does not set layers = 12")
    out = ROOT / "build" / "smoke" / config.name
    out.parent.mkdir(parents=True, exist_ok=True)
    write_atomic(out, cut)
    return out


def write_atomic(path: Path, text: str) -> None:
    """Write ``path`` through a temporary file and a rename: phases that run
    side by side write the same config copies, and a server started by one
    must never read a half-written file."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


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
        time.sleep(0.2)
    raise SmokeFailure("server not healthy in time:\n" + log_path.read_text()[-4000:])


def drive(port: int, layers: int = 12) -> dict:
    """The main path's run: counts to 0, requests, counts read back (K1 once
    per layer of each batch)."""
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
    check(launches > 0 and launches == layers * delta["batches_total"],
          f"K1 launched {launches} times for {delta['batches_total']:g} batches "
          f"({layers} per batch)")
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


def in_process_check(answers: dict, config: Path = CONFIG, moe: bool = False) -> dict:
    """Served answers == the same seeded model in-process with the same
    kernel; and agree with dense attention where its logits separate. With
    ``moe`` (the Switch-MoE config) the max flash-vs-dense logit difference
    is printed, not held: a bf16 rounding that moves a router's argmax
    sends a token to another expert; the separated ranks are held."""
    import torch

    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    runs, forward_ms = {}, {}
    for attention in ("flash", "dense"):
        model = build(model_config(attention, config))
        if moe:
            share_params(model, config)
        # The check runs the eager forward; graph_phase holds the replays.
        rt = build_runtime(model, device="cuda", compile_forward=not moe)
        items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
                 for t in TEXTS_32]
        check(all(model.group_key(it) == 64 for it in items), "texts must fit seq bucket 64")
        dev = rt.h2d((32, 64), model.assemble(items, (32, 64)))
        with torch.inference_mode():
            logits = rt.module(*dev).float()
        check(bool(torch.isfinite(logits).all()) and logits.shape == (32, 1000),
              f"{attention}: logits {tuple(logits.shape)} not finite")
        runs[attention] = logits
        if attention == "flash" and not moe:
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
    check(moe or err <= LOGIT_TOL, f"flash vs dense logits differ by {err:.3g} > {LOGIT_TOL}")
    checked = separated_ranks_agree(flash, dense, "flash")
    print(f"slice: {config.name}: served answers equal the in-process flash run; flash vs "
          f"dense logits max abs diff {err:.4g} ({'printed' if moe else 'tol'} {LOGIT_TOL}), "
          f"{checked} separated top-5 ranks agree", flush=True)
    if moe:
        return {"flash_vs_dense_max_abs_logit_diff": err, "separated_ranks_held": checked}
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


# A served port taken before the server bound it: new ports tried at most.
PORT_TAKEN_RETRIES = 2

# Servers started ahead of their use (``prestart``), by ``serving``'s
# arguments: ``serving`` takes its server from here when one is waiting.
_PRESTARTED: dict[tuple, dict] = {}


def _start_server(config: Path, overrides: tuple, extra_toml: str,
                  env: tuple = ()) -> dict:
    """``python -m tpuserve_torch serve`` on a free port, started at once,
    with ``env``'s (name, value) pairs added to its environment."""
    port = free_port()
    sets = [a for o in (f"port={port}", *overrides) for a in ("--set", o)]
    tmp = Path(tempfile.mkdtemp(prefix="smoke-serve-"))
    log_path = tmp / "server.log"
    if extra_toml:
        copy = tmp / config.name
        copy.write_text(config.read_text() + "\n" + extra_toml)
        config = copy
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "tpuserve_torch", "serve",
                                 "--config", str(config), *sets],
                                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                env={**os.environ, **dict(env)} if env else None)
    return {"port": port, "proc": proc, "log": log_path, "tmp": tmp}


def _wait_bound(srv: dict, n_buckets: int, restart) -> None:
    """``wait_healthy`` for the server ``srv``. One that exited because its
    port was taken before it bound it (``free_port`` releases the port, and
    any process may listen on it in the seconds the server boots) is
    started again on a new port (``restart()``, ``srv`` updated in place),
    up to ``PORT_TAKEN_RETRIES`` times; any other failure stands."""
    for attempt in range(PORT_TAKEN_RETRIES + 1):
        try:
            return wait_healthy(srv["proc"], srv["port"], srv["log"], n_buckets)
        except SmokeFailure:
            if (attempt == PORT_TAKEN_RETRIES or srv["proc"].poll() is None
                    or "address already in use" not in srv["log"].read_text()):
                raise
        print(f"slice: port {srv['port']} was taken before the server bound it; "
              "starting the server again on another", flush=True)
        _stop_server(srv)
        srv.update(restart())


def _stop_server(srv: dict) -> None:
    proc = srv["proc"]
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
    shutil.rmtree(srv["tmp"], ignore_errors=True)


def prestart(config: Path, n_buckets: int, overrides: tuple = (), extra_toml: str = "",
             env: tuple = ()) -> None:
    """Start now the server that a later ``serving`` with the same
    arguments will use, so that it boots beside the server a phase starts
    next; that ``serving`` waits for both before it yields, so no boot runs
    under the phase's measurements and the later server is ready when its
    turn comes (the smoke's time limit)."""
    _PRESTARTED[(str(config), tuple(overrides), extra_toml, tuple(env))] = dict(
        _start_server(config, tuple(overrides), extra_toml, tuple(env)), n_buckets=n_buckets,
        thread=threading.get_ident())


def stop_prestarted() -> None:
    """Stop every prestarted server no ``serving`` took (a failed phase)."""
    while _PRESTARTED:
        _stop_server(_PRESTARTED.popitem()[1])


@contextlib.contextmanager
def serving(config: Path, n_buckets: int, overrides: tuple = (), extra_toml: str = "",
            with_proc: bool = False, with_log: bool = False, env: tuple = ()):
    """``python -m tpuserve_torch serve --config <config>`` (plus ``--set``
    ``overrides``, and ``extra_toml`` appended to a copy of the file) on a
    free port, with ``env``'s (name, value) pairs added to its environment,
    healthy (the prestarted one, if any, and every other server this thread
    prestarted healthy too: phases that run side by side do not wait on
    each other's); prints each model's graphs and the memory their capture
    reserved; yields the port (and the process, ``with_proc``, or the path of
    its log, ``with_log``) and stops the server on the way out."""
    def start() -> dict:
        return _start_server(config, tuple(overrides), extra_toml, tuple(env))

    srv = _PRESTARTED.pop((str(config), tuple(overrides), extra_toml, tuple(env)), None) \
        or start()
    try:
        _wait_bound(srv, n_buckets, start)
        port, proc, log_path = srv["port"], srv["proc"], srv["log"]
        for other in list(_PRESTARTED.values()):  # booting beside this one
            if other["thread"] != threading.get_ident():
                continue
            # Booted, or failed: the phase that takes it reports a failure.
            with contextlib.suppress(SmokeFailure):
                wait_healthy(other["proc"], other["port"], other["log"], other["n_buckets"])
        for name, g in served_graphs(port).items():
            mem = g["capture_memory"]
            if not mem:
                print(f"slice: {name} boots cold: no parameter slot, no graph", flush=True)
                continue
            print(f"slice: {name} serves from {g['captures_total']} CUDA graphs "
                  f"({g['buckets']} buckets or programs x "
                  f"{g['captures_total'] // max(1, g['buckets'])} each); parameters "
                  f"{g['param_bytes_per_slot'] / 2**20:.0f} MiB per slot; memory_reserved "
                  f"{mem['reserved_before_bytes'] / 2**20:.0f} MiB before capture, "
                  f"{mem['reserved_after_bytes'] / 2**20:.0f} MiB after", flush=True)
        yield (port, proc) if with_proc else (port, log_path) if with_log else port
    finally:
        _stop_server(srv)


def served_graphs(port: int) -> dict:
    """Per served model: its graphs, compiles and capture memory
    (``/v1/models``)."""
    inv = json.loads(call(port, "GET", "/v1/models")[1])
    return {name: {"captures_total": d["captures_total"], "compiles_total": d["compiles_total"],
                   "buckets": len(d["buckets"]), "capture_memory": d["capture_memory"],
                   "param_bytes_per_slot": d["params"]["bytes"],
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


def graph_phase(config: Path, timed: dict, logit_tol, share: bool = False,
                witnessed: bool = False) -> dict:
    """Every model of ``config`` on a runtime whose graphs also keep the
    logits: (a) for every bucket, the graph replay against the eager
    forward of the live slot on the same resident input — indices
    identical, logits and probabilities bit-identical, else the max abs
    logit diff printed and held within ``logit_tol(logits)``; (c) at the
    buckets ``timed`` names, the served h2d stage's host time against the
    eager yardstick (``host_time``), and the replay's device time
    (``replay_timing``); (d) memory_reserved before and after capture.
    ``share``: the models take the run's shared seeded parameters
    (``share_params``). ``witnessed``: then the retrace witness's negative
    gates on the timed bucket (``witness_gates``)."""
    import torch

    from tpuserve_torch.config import load_config
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    out = {}
    for mcfg in load_config(str(config)).models:
        model = build(mcfg)
        if share:
            share_params(model, config)
        model.forward = lambda module, batch, m=model: forward_with_logits(m, module, batch)
        rt = build_runtime(model, device="cuda")
        bucket = timed.get(mcfg.name)
        # The server's startup probe, as it runs there: right after the
        # captures, 8 back-to-back dispatches on the host's clock.
        probe_cold = rt.probe_raw_ms(bucket, iters=8) if bucket is not None else None
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
        if bucket is not None:
            host = seeded_batch(model, bucket, seed=99)
            entry["bucket_timed"] = list(bucket)
            entry.update(host_time(rt, model, bucket, host))
            entry.update(replay_timing(rt, bucket, rt.h2d(bucket, host)))
            # The same probe on a warm card, and over 64 dispatches: beside
            # the replay's device time, what the startup probe measures.
            entry["probe_raw_ms"] = {"after_capture_8": probe_cold,
                                     "warm_8": rt.probe_raw_ms(bucket, iters=8),
                                     "warm_64": rt.probe_raw_ms(bucket, iters=64)}
            if witnessed:
                entry["witness"] = witness_gates(rt, model, bucket)
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


def witness_gates(rt, model, bucket: tuple) -> dict:
    """Phase 6's negative gates of the retrace witness, in process on the
    card, on ``rt`` (BERT-flash's runtime) at ``bucket``: with the witness
    forced on, the warmup barrier declared and the sync guard armed, a
    stray ``.item()`` on a replay's CUDA output raises, and ``host_fetch`` of
    the same outputs does not (and equals a plain ``.cpu()`` with the guard
    off); a
    capture after the barrier (one slot's graph dropped, ``ensure_compiled``)
    raises ``RetraceViolation`` before it starts outside a sanctioned
    window, and inside one captures with 0 violations more. The guard, the
    witness and the registry are restored after."""
    from tpuserve_torch.analysis import witness
    from tpuserve_torch.utils import retrace

    out = {}
    witness.force_retrace(True)
    witness.reset_retrace()
    witness.declare_warmup_complete()
    try:
        check(retrace.arm_sync_guard(), "witness: the sync guard did not arm on the card")
        outputs = rt.dispatch(bucket, rt.h2d(bucket, seeded_batch(model, bucket, seed=7)))
        try:
            outputs["indices"].sum().item()
            stray = None
        except RuntimeError as e:
            stray = str(e)
        check(stray is not None, "witness: a stray .item() passed the armed sync guard")
        host = retrace.host_fetch(outputs)
        out["stray_item_raised"] = stray.splitlines()[0][:120]
        slot = rt.slots[0]
        del slot.graphs[bucket]
        try:
            rt.ensure_compiled()
            unsanctioned = None
        except witness.RetraceViolation as e:
            unsanctioned = str(e)
        check(unsanctioned is not None and bucket not in slot.graphs,
              "witness: a capture after the barrier outside a sanctioned window passed")
        with witness.sanctioned_compiles():
            rt.ensure_compiled()
        snap = witness.retrace_snapshot()
        check(bucket in slot.graphs and snap["sanctioned_captures"] == 1
              and len(snap["violations"]) == 1 and snap["violations"][0]["kind"] == "recapture",
              f"witness: the sanctioned re-capture: {snap}")
        out.update(capture_violation=unsanctioned.split(" [at ")[0],
                   sanctioned_captures=snap["sanctioned_captures"],
                   transfer_windows=snap["transfer_windows"])
    finally:
        retrace.disarm_sync_guard()
        witness.force_retrace(None)
        witness.reset_retrace()
    plain = {k: v.cpu().numpy() for k, v in outputs.items()}
    check(all((host[k] == plain[k]).all() for k in plain),
          "witness: host_fetch and a plain .cpu() disagree on the same outputs")
    print(f"witness: armed sync guard: a stray .item() raised ({out['stray_item_raised']}), "
          f"host_fetch passed; a capture after the barrier raised ({out['capture_violation']}), "
          f"inside sanctioned_compiles it captured with 0 more violations; "
          f"{out['transfer_windows']} transfer windows", flush=True)
    return out


def slice_phase() -> dict:
    prestart(LONG_CONFIG, 2)  # phase 7's server boots beside this one
    with serving(CONFIG, n_buckets=6) as port:
        run = drive(port)
        # Phase 23's fleet server answers these bytes.
        run["direct_bodies"] = router_answers(port)
        run["timing"] = serve_timing(port)
        print(json.dumps({"serve": run["timing"]}), flush=True)
    run["forward_ms"] = in_process_check(run["answers"])
    run["graphs"] = graph_phase(CONFIG, {"bert": (32, 128)}, lambda logits: LOGIT_TOL,
                                witnessed=True)
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
    range plus FIRST_STAGE_SLACK_MS; ``drive_fresh`` holds it through
    ``first_request_misses``."""
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
    return table


def first_request_misses(table: dict) -> dict:
    """The (request, stage) pairs of a ``first_request_table`` over the bar,
    with their excess in ms."""
    return {f"{label}.{stage}": ms for label, row in table.items()
            for stage, ms in row["first_over_repeats_max_ms"].items()
            if ms > FIRST_STAGE_SLACK_MS}


def drive_fresh(config: Path, n_buckets: int, name: str, drive) -> dict:
    """Serve ``config`` and run ``drive(port)`` (whose result holds a
    ``first_request_table`` under ``first_request``), holding the
    first-request bar: when a stage misses it, all of it again on a second
    fresh server. A first-request cost recurs on every fresh server and
    fails; a one-off stall of the host does not (a 2-3 MB body's read stalled
    19 ms once in 8 fresh servers, and every stage of one ResNet-50 request
    ran 3-10x its repeats once, both on the H100 machine). The run kept is
    the last one, with ``first_request_misses`` per server."""
    misses = []
    for _ in range(2):
        with serving(config, n_buckets=n_buckets) as port:
            run = drive(port)
            run["served_graphs"] = served_graphs(port)[name]
        misses.append(first_request_misses(run["first_request"]))
        if not misses[-1]:
            break
        print(f"slice ({name}): first requests over the bar: {misses[-1]}; "
              "once more on a fresh server", flush=True)
    recurring = sorted(set(misses[0]) & set(misses[-1])) if len(misses) == 2 else list(misses[0])
    check(not recurring, f"{name}: the first request's {recurring} over its repeats' "
                         f"range + {FIRST_STAGE_SLACK_MS} ms on two fresh servers: {misses}")
    run["first_request_misses"] = misses
    return run


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
    run = drive_fresh(RESNET_CONFIG, 6, "resnet50", lambda port: drive_resnet(port, requests))
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

def lifecycle_drill(config: Path, name: str, n_buckets: int, body: bytes, ctype: str,
                    overrides: tuple = (), prequantized: bool = False,
                    mesh_stats: bool = False) -> dict:
    """Serve ``config`` (plus ``--set overrides``) with model ``name``'s weights read from a seed-1
    checkpoint (``save_npz`` of the port's own seeded init, in a temporary
    directory) and drive its lifecycle over HTTP with one fixed request:
    ``:reload`` of a seed-2 checkpoint gives version 2 and other answers;
    ``:rollback`` gives version 1 and answers equal to the first ones; a
    corrupted .npz under a stale manifest answers 409 at ``integrity``, a
    checkpoint with an inf leaf 409 at ``nan_scan``, and version 1 answers
    as before after each; a second ``:reload`` of the seed-2 checkpoint
    gives version 3 and version 2's answers. ``prequantized``: then a
    ``:reload`` of the seed-1 tree written int8-quantized (the function
    ``import-model --quantize int8`` applies after its import,
    ``quantize.quantize_tree`` at the model's ``quantize_min_size``, on the
    seed-1 tree as the compute dtype holds it: the reference quantizes the
    cast weights at stage time and the float32 ones at import) gives
    version 4 and the first answers' bytes. ``mesh_stats``: ``/stats``'
    ``parallel`` block reads one chip and one replica and its ``topology``
    platform gpu and one local device. ``runtime_compiles_total`` and
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
        with serving(config, n_buckets,
                     overrides=(f"model.{name}.weights={ckpt}", *overrides)) as port:
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
            if prequantized:
                from tpuserve_torch import quantize
                from tpuserve_torch.models.base import DTYPES

                mcfg = load_config(str(config)).model(name)
                q8 = quantize.quantize_tree(quantize.cast_tree(trees[1], DTYPES[mcfg.dtype]),
                                            mcfg.quantize_min_size)
                check(quantize.has_quantized_leaves(q8), f"lifecycle {name}: nothing quantized")
                savedmodel.save_npz(ckpt, q8)
                check(admin("reload", 200)["version"] == 4,
                      f"lifecycle {name}: the pre-quantized reload is not version 4")
                check(answer() == v1, f"lifecycle {name}: the pre-quantized seed-1 tree does "
                      "not answer the float seed-1 tree's bytes")
                seen["prequantized_int8_leaves"] = sum(
                    1 for p, _ in flatten_with_paths(q8) if p.endswith("['q8']"))
            if mesh_stats:
                st = json.loads(call(port, "GET", "/stats")[1])
                par, topo = st["parallel"][name], st["topology"]
                check((par["mode"], par["n_chips"], par["replicas"]) == ("sharded", 1, 1),
                      f"lifecycle {name}: /stats parallel {par}")
                check((topo["platform"], topo["local_devices"]) == ("gpu", 1),
                      f"lifecycle {name}: /stats topology {topo}")
                seen["parallel"], seen["topology"] = par, topo
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
                            ("reload", "ok", None)] + [("reload", "ok", None)] * prequantized,
                  f"lifecycle {name}: audit trail {trail}")
            evs = json.loads(call(port, "GET", "/debug/events?subsystem=lifecycle")[1])["events"]
            kinds = [e["event"] for e in evs if e.get("model") == name]
            check(kinds.count("published") == 2 + prequantized and kinds.count("rolled_back") == 1
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
    """The drill on BERT-flash, served in the reference's default layout
    (``parallelism`` unset: "sharded", on a one-device mesh), and on the
    int8 ResNet-50 with its pre-quantized reload."""
    import concurrent.futures as cf

    texts = json.dumps({"texts": TEXTS_8}).encode()
    _, _, framed, ctype, _ = resnet_requests()[1]                # 8 framed yuv420 items
    # The two drills side by side: each drives its own server over HTTP.
    with cf.ThreadPoolExecutor(1) as beside:
        resnet = beside.submit(lifecycle_drill, RESNET_CONFIG, "resnet50", 6, framed, ctype,
                               prequantized=True)
        try:
            bert = lifecycle_drill(default_layout_config(), "bert", 6, texts,
                                   "application/json", mesh_stats=True)
        finally:
            resnet_int8 = resnet.result()
    return {"bert_flash": bert, "resnet50_int8": resnet_int8}


def default_layout_config() -> Path:
    """``shallow_config()`` without its ``parallelism = "single"`` line (a
    copy under build/smoke/sharded/): the reference's default layout."""
    text = shallow_config().read_text()
    cut = re.sub(r'(?m)^parallelism = "single"\n', "", text)
    check(cut != text, "bert_flash.toml does not set parallelism = \"single\"")
    out = ROOT / "build" / "smoke" / "sharded" / CONFIG.name
    out.parent.mkdir(parents=True, exist_ok=True)
    write_atomic(out, cut)
    return out


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
    # The periodic canary rides this batcher: one that fires as the loop
    # revives (the canary's and the watchdog's ticks align) folds the next
    # text into its batch, another bucket than its lone baseline's. Post on
    # an idle batcher, between two canaries, as the breaker drill does.
    while not (await b_adaptive.drain(loop.time() + 5) and state._next_canary_at is not None
               and state._next_canary_at - time.monotonic() > 0.5):
        await asyncio.sleep(0.05)
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
    served batch's ring span, and 12 K1 per replay (the first and the last
    replay may be cut by the profiler's start and stop). A batch is one graph
    replay, and a replay's kernels share its ``cudaGraphLaunch``'s
    correlation id, so K1 is counted per replay by that id. Batch spans
    overlap (several batches are in flight), so a span is never credited
    with the K1 events it happens to contain: instead every batch whose
    span lies wholly inside the traced device extent must have its replay
    in the trace, and no more whole replays than batches touching that
    extent; and no graph launch between the first and the last replay lacks
    its K1 events."""
    meta = data["tpuserve_profile"]
    check(meta["device_trace"] == "ok", f"profile: device_trace {meta['device_trace']!r}")
    lo, hi = meta["window_us"]
    evs = data["traceEvents"]
    dev = [e for e in evs if e.get("pid", 0) >= 1000 and e.get("cat") in ("kernel", "gpu_memcpy",
                                                                          "gpu_memset")]
    k1 = [e for e in dev if e["cat"] == "kernel" and K1_NAME.search(e.get("name", ""))]
    launches = {e["args"]["correlation"]: e for e in evs
                if e.get("pid", 0) >= 1000
                and e.get("name", "").startswith("cudaGraphLaunch")
                and "correlation" in e.get("args", {})}
    batches = [e for e in evs if e.get("pid") == 0 and e["name"].startswith("batch[")
               and e["tid"] == "bert"]
    check(k1, f"profile: no K1 kernel event among {meta['device_events']} device events")
    outside = [e for e in k1 if not (lo <= e["ts"] and e["ts"] + e["dur"] <= hi)]
    check(not outside, f"profile: {len(outside)} K1 events outside the capture window")
    in_batch = [e for e in k1 if any(b["ts"] <= e["ts"] and e["ts"] + e["dur"] <= b["ts"] + b["dur"]
                                     for b in batches)]
    share = len(in_batch) / len(k1)
    replays = collections.Counter(e.get("args", {}).get("correlation") for e in k1)
    unlaunched = [c for c in replays if c not in launches]
    per_replay = collections.Counter(replays.values())
    first, last = min(e["ts"] for e in dev), max(e["ts"] + e["dur"] for e in dev)
    inside = [b for b in batches if first <= b["ts"] and b["ts"] + b["dur"] <= last]
    touching = [b for b in batches if b["ts"] < last and b["ts"] + b["dur"] > first]
    out = {"device_events": meta["device_events"], "ring_events": meta["ring_events"],
           "k1_events": len(k1), "k1_inside_a_batch_span": share, "replays_with_k1": len(replays),
           "k1_per_replay": {str(k): v for k, v in sorted(per_replay.items())},
           "batches_inside_device_extent": len(inside), "batches_touching_it": len(touching),
           "k1_name": k1[0]["name"][:80], "window_ms": (hi - lo) / 1e3,
           "device_extent_ms": (last - first) / 1e3}
    print(f"observability: /debug/profile: {meta['device_events']} device events beside "
          f"{meta['ring_events']} ring spans over {out['window_ms']:.0f} ms (device events over "
          f"the last {out['device_extent_ms']:.0f} ms); {len(k1)} K1 events ({out['k1_name']}), "
          f"all inside the window, {share:.1%} inside a served batch's span; {len(replays)} "
          f"replays ran them (K1 per replay: {out['k1_per_replay']}, 12 expected) against "
          f"{len(inside)} batches wholly inside the device extent and {len(touching)} touching it",
          flush=True)
    check(share >= 0.95, f"profile: only {share:.1%} of K1 events fall inside a batch span "
                         "(device lanes off the ring's clock?)")
    check(not unlaunched, f"profile: K1 events of {len(unlaunched)} correlation ids with no "
                          "cudaGraphLaunch (K1 launched outside a replay?)")
    # The first and the last replay may straddle the profiler's start or
    # stop; every other one is whole.
    order = sorted(replays, key=lambda c: launches[c]["ts"])
    check(all(replays[c] == 12 for c in order[1:-1]) and all(replays[c] <= 12 for c in order),
          f"profile: K1 per replay {dict(per_replay)} (12 expected)")
    t_first, t_last = launches[order[0]]["ts"], launches[order[-1]]["ts"]
    bare = [c for c, e in launches.items() if t_first <= e["ts"] <= t_last and c not in replays]
    check(not bare, f"profile: {len(bare)} graph launches between the first and the last replay "
                    "that ran K1 left no K1 event in the trace")
    # A replay cut by the profiler's start or stop has its kernels at the
    # extent's edge while its batch span, on the ring's clock, may end just
    # before the re-based extent begins: only whole replays are bounded by
    # the batches touching the extent.
    whole = sum(1 for c in order if replays[c] == 12)
    check(len(inside) <= len(replays) and whole <= len(touching),
          f"profile: {len(replays)} replays ran K1 ({whole} whole), but {len(inside)} batches "
          f"lie wholly inside the device extent and {len(touching)} touch it (a replay "
          "dropped from the trace?)")
    return out


def witness_check(stats: dict, compiles: float) -> dict:
    """Phase 11's witness gates on its server's ``/stats``: the lock
    witness saw locks and no violation; the retrace witness declared its
    barrier, counted the boot's ``compiles`` as warm-up compiles, armed the
    sync guard and saw no violation."""
    rob = stats["robustness"]
    lock, rt = rob.get("lock_witness"), rob.get("retrace_witness")
    check(lock is not None and rt is not None, f"/stats robustness lacks a witness: {rob}")
    check(len(lock["locks"]) > 0 and lock["acquisitions"] > 0 and lock["violations"] == [],
          f"lock witness: {len(lock['locks'])} nodes, violations {lock['violations'][:3]}")
    check(rt["barrier_declared"] and rt["warmup_compiles"] == compiles
          and rt["sync_guard_armed"] and rt["violations"] == [],
          f"retrace witness: {rt} (the boot ticked {compiles:g} compiles)")
    out = {"lock_nodes": len(lock["locks"]), "lock_edges": len(lock["edges"]),
           "lock_acquisitions": lock["acquisitions"], "lock_violations": 0,
           **{k: rt[k] for k in ("warmup_compiles", "sanctioned_compiles", "warmup_captures",
                                 "sanctioned_captures", "transfer_windows")},
           "retrace_violations": 0}
    print(f"observability: witnessed: lock witness {out['lock_nodes']} nodes, "
          f"{out['lock_edges']} edges, {out['lock_acquisitions']} acquisitions, 0 violations; "
          f"retrace witness barrier declared, {out['warmup_compiles']} warm-up compiles = the "
          f"boot's, {out['warmup_captures']} warm-up captures, sync guard armed, "
          f"{out['transfer_windows']} transfer windows, 0 violations", flush=True)
    return out


def observability_phase(card: str) -> dict:
    """Serve bert_flash.toml with a latency objective and a fast sampler,
    under the lock and retrace witnesses: tracing (``trace_tree_check``),
    then 4 clients of 32-text batches (each request's wall time kept) and,
    under that load, history, utilization, alerts and a device profile
    (with a second, concurrent capture refused), K1 counted through the
    replays; captures and compiles unchanged across it all; the witnesses'
    blocks clean (``witness_check``)."""
    import threading

    t0 = time.perf_counter()
    with serving(CONFIG, n_buckets=6, extra_toml=OBS_TOML, env=WITNESS_ENV) as port:
        out = {"card": card, "trace": trace_tree_check(port)}
        graphs0 = served_graphs(port)["bert"]
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
        before = call(port, "GET", "/metrics")[1].decode()
        stop, statuses, walls = threading.Event(), [], []

        def client():
            while not stop.is_set():
                t = time.perf_counter()
                statuses.append(call(port, "POST", "/v1/models/bert:classify",
                                     {"texts": TEXTS_32})[0])
                walls.append((time.perf_counter() - t) * 1e3)

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
        out["witness"] = witness_check(stats, graphs0["compiles_total"])
        walls.sort()
        out.update({"requests_under_load": len(statuses), "batches_under_load": batches,
                    "request_ms_p50": walls[len(walls) // 2],
                    "request_ms_p99": walls[min(len(walls) - 1, int(0.99 * len(walls)))],
                    "k1_launches": launches, "device_utilization": util,
                    "batches_rate_per_s": rate, "alert": alerts["models"]["bert"]["state"],
                    "burn": alerts["models"]["bert"]["burn"],
                    "captures_total": graphs1["captures_total"],
                    "compiles_total": graphs1["compiles_total"],
                    "sampler_samples": stats["telemetry"]["samples_total"]})
    print(f"observability: under 4 clients request p50 {out['request_ms_p50']:.2f} ms, p99 "
          f"{out['request_ms_p99']:.2f} ms, device_utilization {util:.3f}, batches "
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
    shallow = shallow_config()
    with serving(shallow, n_buckets=6) as on, \
            serving(shallow, n_buckets=6, extra_toml=OBS_OFF_TOML) as off:
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
    run = drive_fresh(MNV3_CONFIG, 4, "mobilenetv3", lambda port: drive_mnv3(port, requests))
    answers = run.pop("answers")
    run["model"] = mnv3_model_check(load_config(str(MNV3_CONFIG)).models[0], requests, answers)
    run["graphs"] = graph_phase(MNV3_CONFIG, {"mobilenetv3": (1,)},
                                lambda logits: RESNET_LOGIT_REL * logits.abs().max().item())
    run["card"] = card
    run["phase_s"] = time.perf_counter() - t0
    return run


# -- phase 14: EfficientDet-D0 --------------------------------------------------

DET_CONFIG = ROOT / "examples" / "efficientdet.toml"
DET_BUCKETS = ("[4]", "[8]")
DET_SIZES = (1, 4, 5, 8)
# bf16 heads against the float32 network (TF32 off) on the same batch: atol
# as a share of each float32 output's largest magnitude, as for the
# classifiers (RESNET_LOGIT_REL). Detections are held equal where the
# float32 scores of the kept slots separate by more than twice the largest
# score difference the two networks show on that batch; boxes within
# DET_BOX_TOL (normalized corners).
DET_BOX_TOL = 1e-2
# The tail on seeded logits, card against the CPU: float32 on both, sums of
# the same few terms in another order (the IoU, the decode's exp).
DET_TAIL_TOL = 1e-5


def det_requests() -> list:
    """Framed yuv420 bodies of 1, 4, 5 and 8 seeded items at 512 px."""
    import numpy as np

    from tpuserve_torch import frame, preproc

    rng = np.random.default_rng(31)
    out = []
    for n in DET_SIZES:
        items = [preproc.rgb_to_yuv420(a)
                 for a in rng.integers(0, 256, (n, 512, 512, 3), dtype=np.uint8)]
        out.append(("efficientdet", f"frame{n}", frame.encode_frame(items, frame.KIND_YUV420, 512),
                    frame.CONTENT_TYPE, items))
    return out


def drive_det(port: int, requests: list) -> dict:
    """The EfficientDet path's run: counts to 0, the four bodies to
    ``:detect`` (first request of each bucket, stage by stage), a malformed
    frame (400) and an unknown model (404), counts read back (K1 and K2: 0;
    batches 4, items 18, compiles 0, captures unchanged); the repeats."""
    from tpuserve_torch import frame

    name = "efficientdet"
    graphs0 = served_graphs(port)[name]
    check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
    before = call(port, "GET", "/metrics")[1].decode()
    arena = json.loads(call(port, "GET", "/stats")[1])["pipeline"]["models"][name]["arena"]
    check(set(arena["buckets"]) == set(DET_BUCKETS) and all(
          b["pooled"] == arena["slots_per_bucket"] for b in arena["buckets"].values()),
          f"{name}: the arena did not make every bucket's buffers at start: {arena}")
    answers, first, walls = {}, {}, {}
    repeats = {label: [] for _, label, _, _, _ in requests}
    for _, label, body, ctype, items in requests:
        s0 = stage_totals(port, name)
        t0 = time.perf_counter()
        st, raw = call(port, "POST", f"/v1/models/{name}:detect", raw=body, ctype=ctype)
        walls[label] = (time.perf_counter() - t0) * 1e3
        first[label] = stage_delta(s0, stage_totals(port, name))
        check(st == 200, f"{name} {label}: {st} {raw[:300]!r}")
        res = json.loads(raw)
        results = res["results"] if "results" in res else [res]
        check(len(results) == len(items) and all(
              set(r) == {"detections", "num_detections"}
              and r["num_detections"] == len(r["detections"]) for r in results),
              f"{name} {label}: {len(results)} results for {len(items)} items: {results[:2]}")
        answers[label] = results
    ingest0 = json.loads(call(port, "GET", "/stats")[1])["ingest"]
    st, raw = call(port, "POST", f"/v1/models/{name}:detect", raw=b"TPUF\x01\x00",
                   ctype=frame.CONTENT_TYPE)
    check(st == 400 and json.loads(raw)["error"].startswith("frame:"),
          f"malformed frame answered {st} {raw[:200]!r}, expected 400 frame: ...")
    st, _ = call(port, "POST", "/v1/models/nope:detect", raw=requests[0][2],
                 ctype=frame.CONTENT_TYPE)
    check(st == 404, f"unknown model answered {st}, expected 404")
    stats = json.loads(call(port, "GET", "/stats")[1])
    after = call(port, "GET", "/metrics")[1].decode()
    counts = (stats["kernels"]["flash_attention"]["launches"],
              stats["kernels"]["flash_attention_stats"]["launches"])
    frame_errors = (stats["ingest"]["frame_errors_total"][name]
                    - ingest0["frame_errors_total"][name])
    delta = {n: metric(after, f'{n}{{model="{name}"}}') - metric(before, f'{n}{{model="{name}"}}')
             for n in ("batches_total", "items_total", "runtime_compiles_total")}
    graphs1 = served_graphs(port)[name]
    print(f"slice (efficientdet): 4 requests ({sum(DET_SIZES)} images) answered; K1, K2 "
          f"launches {counts}; {delta}; frame errors +{frame_errors:g}; captures "
          f"{graphs0['captures_total']} -> {graphs1['captures_total']}; request walls "
          f"{ {k: round(v, 1) for k, v in walls.items()} } ms", flush=True)
    check(counts == (0, 0), f"K1, K2 launched {counts} times on the EfficientDet path")
    check(frame_errors == 1, f"frame_errors_total moved by {frame_errors:g}, expected 1")
    check((delta["batches_total"], delta["items_total"], delta["runtime_compiles_total"])
          == (4, sum(DET_SIZES), 0), f"{name}: batches/items/compiles moved by {delta}")
    check(graphs1["captures_total"] == graphs0["captures_total"] == 6,
          f"{name}: captures {graphs0['captures_total']} -> {graphs1['captures_total']}, "
          "expected 6 (2 buckets x 3 slots) throughout")
    for _ in range(REPEATS):
        for _, label, body, ctype, _ in requests:
            s0 = stage_totals(port, name)
            st, _ = call(port, "POST", f"/v1/models/{name}:detect", raw=body, ctype=ctype)
            repeats[label].append(stage_delta(s0, stage_totals(port, name)))
            check(st == 200, f"repeat of {name} {label} answered {st}")
    first_request = first_request_table(first, repeats, name)
    lat = json.loads(call(port, "GET", "/stats")[1])["latency"]
    return {"answers": answers, "first_request": first_request, "launches_k1_k2": list(counts),
            "deltas": delta, "walls_ms": walls,
            "phase_p50_ms": {p: lat[f"latency_ms{{model={name},phase={p}}}"]["p50_ms"]
                             for p in STAGES}}


def det_equal_where_separated(got: dict, ref: dict, score_tol: float, box_tol: float,
                              label: str) -> int:
    """Detections ``got`` equal ``ref`` (numpy outputs of the tail) in
    classes and boxes (within ``box_tol``) over every slot up to the first
    pair of kept reference scores closer than ``score_tol``, and in count
    and every class where no such pair exists. Returns the slots held."""
    import numpy as np

    held = 0
    for r in range(ref["n"].shape[0]):
        n = int(ref["n"][r])
        gaps = np.abs(np.diff(ref["scores"][r][:n]))
        close = np.nonzero(gaps <= score_tol)[0]
        m = int(close[0]) + 1 if len(close) else n
        check(np.array_equal(got["classes"][r][:m], ref["classes"][r][:m]),
              f"{label}: classes differ in the first {m} slots of row {r}")
        check(bool(np.all(np.abs(got["boxes"][r][:m] - ref["boxes"][r][:m]) <= box_tol)),
              f"{label}: boxes differ by more than {box_tol} in the first {m} slots of row {r}")
        if m == n:
            check(int(got["n"][r]) == n, f"{label}: count {int(got['n'][r])} != {n}, row {r}")
            check(np.array_equal(got["classes"][r], ref["classes"][r]),
                  f"{label}: classes differ in row {r}")
        held += m
    return held


def naive_nms(boxes, scores, classes, max_dets: int, iou_t: float, score_t: float) -> list:
    """Greedy per-class NMS in plain numpy (the reference test's semantic
    yardstick): kept candidate indices in score order."""
    import numpy as np

    def iou(a, b):
        inter = (max(min(a[2], b[2]) - max(a[0], b[0]), 0)
                 * max(min(a[3], b[3]) - max(a[1], b[1]), 0))
        u = (max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
             + max(b[2] - b[0], 0) * max(b[3] - b[1], 0) - inter)
        return inter / u if u > 0 else 0.0

    kept = []
    for i in np.argsort(-scores, kind="stable"):
        if scores[i] <= score_t or len(kept) == max_dets:
            break
        if not any(classes[i] == classes[j] and iou(boxes[i], boxes[j]) > iou_t for j in kept):
            kept.append(int(i))
    return kept


def det_tail_check(model, bucket: tuple) -> dict:
    """The detection tail alone on seeded logits whose scores spread over
    the threshold (class logits N(-2, 1.5), box regression N(0, 0.5)): on
    the card against the same tail on the CPU (count and classes equal,
    boxes within DET_TAIL_TOL where the kept scores separate by more than
    that), and the CPU's against the naive greedy NMS in numpy on the same
    top ``pre_nms`` candidates."""
    import numpy as np
    import torch

    from tpuserve_torch.models import efficientdet as det

    rng = np.random.default_rng(41)
    a = model.anchors.shape[0]
    cls = rng.normal(-2.0, 1.5, (bucket[0], a, model.det_classes)).astype(np.float32)
    box = rng.normal(0.0, 0.5, (bucket[0], a, 4)).astype(np.float32)
    with torch.inference_mode():
        gpu = {k: v.cpu().numpy() for k, v in
               model.detect(torch.from_numpy(cls).cuda(), torch.from_numpy(box).cuda()).items()}
        cpu = {k: v.numpy() for k, v in
               model.detect(torch.from_numpy(cls), torch.from_numpy(box)).items()}
    held = det_equal_where_separated(gpu, cpu, DET_TAIL_TOL, DET_TAIL_TOL, "tail, card vs CPU")
    # The naive NMS over the CPU tail's candidates: the top pre_nms anchors by
    # the best class's float32 score (a stable sort), decoded.
    probs = torch.sigmoid(torch.from_numpy(cls))
    best, best_cls = probs.amax(-1), probs.argmax(-1)
    top = torch.sort(best, dim=-1, descending=True, stable=True).indices[:, : model.pre_nms]
    naive_rows = 0
    for r in range(bucket[0]):
        t = top[r]
        boxes = det.decode_boxes(torch.from_numpy(box[r])[t], torch.from_numpy(model.anchors)[t],
                                 model.cfg.image_size).numpy()
        scores, classes = best[r][t].numpy(), best_cls[r][t].numpy()
        kept = naive_nms(boxes, scores, classes, model.max_dets, model.iou_thresh,
                         model.score_thresh)
        n = int(cpu["n"][r])
        check(n == len(kept) and np.array_equal(cpu["classes"][r][:n], classes[kept])
              and np.allclose(cpu["boxes"][r][:n], boxes[kept], rtol=0, atol=1e-6),
              f"the tail vs naive NMS: row {r}: {n} vs {len(kept)} kept")
        naive_rows += 1
    out = {"slots_held_card_vs_cpu": held, "rows_held_vs_naive": naive_rows,
           "kept_per_row": gpu["n"].tolist()}
    print(f"slice (efficientdet): the tail on seeded logits: card == CPU over {held} slots, "
          f"CPU == naive NMS on {naive_rows} rows; kept per row {out['kept_per_row']}", flush=True)
    return out


def det_model_check(mcfg, requests: list, answers: dict) -> dict:
    """EfficientDet in-process: served detections equal the same seeded
    model's on the same assembled batches; every bucket's replay
    bit-identical to its eager forward on all four outputs; bf16 heads
    against the float32 network (TF32 off) on the same batch, detections
    equal where the float32 scores separate; the tail alone on seeded
    logits (``det_tail_check``); per bucket the replay's device time and the
    eager stream and enqueue; the network alone and the tail alone at
    (8,); capture memory."""
    import dataclasses

    import torch

    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    model = build(mcfg)
    rt = build_runtime(model, device="cuda")
    for _, label, _, _, items in requests:
        bucket = model.bucket_for(len(items))
        ref = model.host_postprocess(rt.fetch(rt.run(bucket, model.assemble(items, bucket))),
                                     len(items))
        check(answers[label] == ref, f"efficientdet {label}: served detections != in-process "
                                     f"{answers[label][:1]} vs {ref[:1]}")
    # Each bucket's replay against the eager forward of the live slot.
    graphs = {}
    for b in model.buckets():
        dev = rt.h2d(b, seeded_batch(model, b, seed=b[0]))
        replay = rt.dispatch(b, dev)
        with torch.inference_mode():
            eager = model.forward(rt.module, dev)
        torch.cuda.synchronize()
        same = {k: torch.equal(replay[k], eager[k]) for k in ("boxes", "scores", "classes", "n")}
        check(all(same.values()), f"efficientdet {b}: replay vs eager outputs differ: {same}")
        graphs[str(b[0])] = {"bit_identical": True, "outputs": sorted(same)}
    # bf16 against float32 with TF32 off, on the 8-item batch.
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
        cls16, box16 = model.logits(rt.module, dev)
        cls32, box32 = twin.logits(module32, dev)
        det16 = {k: v.cpu().numpy() for k, v in model.detect(cls16, box16).items()}
        det32 = {k: v.cpu().numpy() for k, v in twin.detect(cls32, box32).items()}
        s16, s32 = torch.sigmoid(cls16).amax(-1), torch.sigmoid(cls32).amax(-1)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in (("class_logits", cls16, cls32), ("box_regression", box16, box32)):
        check(bool(torch.isfinite(a).all()) and a.dtype == torch.float32
              and a.shape[:2] == (bucket[0], model.anchors.shape[0]),
              f"efficientdet {name}: {tuple(a.shape)} {a.dtype} not finite")
        err = (a - b).abs().max().item()
        tol = RESNET_LOGIT_REL * b.abs().max().item()
        check(err <= tol, f"efficientdet: bf16 vs float32 {name} differ by {err:.4g} > {tol:.4g}")
        errs[name] = {"max_abs_diff": err, "tol": tol, "scale": b.abs().max().item()}
    score_err = (s16 - s32).abs().max().item()
    held = det_equal_where_separated(det16, det32, 2 * score_err, DET_BOX_TOL, "bf16 vs f32")
    errs["detections"] = {"max_abs_score_diff": score_err, "slots_held": held,
                          "kept_f32": det32["n"].tolist(), "kept_bf16": det16["n"].tolist(),
                          "max_score_f32": s32.max().item()}
    tail = det_tail_check(model, (8,))
    # Times per bucket, inputs resident.
    replay, forward = {}, {}
    for b in model.buckets():
        dev_b = rt.h2d(b, seeded_batch(model, b, seed=7))
        replay[str(b[0])] = replay_timing(rt, b, dev_b)
        forward[str(b[0])] = forward_timing(rt, model, b)
    dev8 = rt.h2d((8,), seeded_batch(model, (8,), seed=8))
    with torch.inference_mode():
        heads = model.logits(rt.module, dev8)
        network_ms = graph_ms(lambda: model.logits(rt.module, dev8))
        tail_ms = graph_ms(lambda: model.detect(*heads))
        breakdown = device_breakdown(lambda: model.forward(rt.module, dev8))
    out = {"graphs": graphs, "bf16_vs_f32": errs, "tail_on_seeded_logits": tail,
           "replay_device_ms": replay, "eager_forward": forward,
           "network_device_ms_b8": network_ms, "tail_device_ms_b8": tail_ms,
           "tail_share_of_forward_b8": tail_ms / (network_ms + tail_ms),
           "device_breakdown_b8": breakdown, "capture_memory": dict(rt.capture_memory),
           "captures_total": rt.captures_total}
    print(f"slice (efficientdet): served detections equal the in-process run; every bucket's "
          f"replay bit-identical to the eager forward on boxes, scores, classes and n; bf16 vs "
          f"float32 (TF32 off): class logits {errs['class_logits']['max_abs_diff']:.4g} (tol "
          f"{errs['class_logits']['tol']:.4g}), boxes {errs['box_regression']['max_abs_diff']:.4g} "
          f"(tol {errs['box_regression']['tol']:.4g}), {held} detection slots held (kept "
          f"{det32['n'].tolist()}; best float32 score {errs['detections']['max_score_f32']:.4g}); "
          f"replay device ms per bucket { {k: round(v['replay_device_ms'], 4) for k, v in replay.items()} }; "
          f"eager stream / enqueue ms { {k: (round(v['stream_ms'], 3), round(v['host_enqueue_ms'], 3)) for k, v in forward.items()} }; "
          f"(8,): network {network_ms:.4f} ms, tail {tail_ms:.4f} ms; profiled eager (8,): busy "
          f"{breakdown['total_ms']:.3f} of {breakdown['stream_ms']:.3f} ms, by kind "
          f"{ {k: round(v, 3) for k, v in breakdown['ms_by_kind'].items()} }", flush=True)
    del rt, module32
    torch.cuda.empty_cache()
    return out


def efficientdet_phase(card: str) -> dict:
    t0 = time.perf_counter()
    from tpuserve_torch.config import load_config

    requests = det_requests()
    run = drive_fresh(DET_CONFIG, 2, "efficientdet", lambda port: drive_det(port, requests))
    answers = run.pop("answers")
    run["kept_per_served_item"] = {k: [r["num_detections"] for r in v] for k, v in answers.items()}
    run["model"] = det_model_check(load_config(str(DET_CONFIG)).models[0], requests, answers)
    run["card"] = card
    run["phase_s"] = time.perf_counter() - t0
    return run


# -- phase 15: int8 compute (quantize = "int8c") -------------------------------------

# int8c against weight-only int8 on the same weights and batch: the int8c
# logits add the activations' per-row int8 rounding in every int8-native
# product. atol as a share of the int8 logits' largest magnitude.
INT8C_LOGIT_REL = 5e-2


def int8_matmul_check() -> dict:
    """``quantize.int8_matmul`` on the card against its plain version at the
    int8c path's shapes (BERT's FFN at (32, 128) and a ResNet-50 (32,) 1x1
    convolution, bf16, and 5 rows, under ``_int_mm``'s 17): the int32
    products equal a float64 product of the same int8 values, the outputs
    within one unit of bf16's last place of the plain epilogue's."""
    import torch

    from tpuserve_torch import quantize as qz

    out = {}
    g = torch.Generator(device="cuda").manual_seed(5)
    for label, (m, k, n) in {"bert_mlp_up_32x128": (32 * 128, 768, 3072),
                             "resnet_conv_b32": (32 * 56 * 56, 64, 256),
                             "rows_5": (5, 768, 768)}.items():
        x = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(n, k, device="cuda", generator=g) * 0.05
        q, scale = qz.quantize_leaf(w)
        with torch.inference_mode():
            xq, s_x = qz.quantize_activations(x)
            y = qz.int_mm(xq, q.t())
            plain = (xq.double() @ q.t().double()).to(torch.int32)
            got = qz.int8_matmul(x, q.t(), scale, torch.bfloat16)
            want = (plain.float() * s_x * scale.reshape(-1)).to(torch.bfloat16)
        torch.cuda.synchronize()
        check(torch.equal(y, plain), f"int8_matmul {label}: int32 products differ from the plain")
        ulp = torch.finfo(torch.bfloat16).eps * want.float().abs().clamp_min(
            torch.finfo(torch.bfloat16).tiny)
        err = (got.float() - want.float()).abs()
        check(bool((err <= ulp).all()), f"int8_matmul {label}: outputs differ by more than one "
                                        f"bf16 unit (max {err.max().item():.4g})")
        with torch.inference_mode():
            ms = time_ms(lambda: qz.int8_matmul(x, q.t(), scale, torch.bfloat16))
            mm_ms = time_ms(lambda: qz.int_mm(xq, q.t()))
            bf16_ms = time_ms(lambda: x @ w.to(torch.bfloat16).t())
        out[label] = {"shape_mkn": [m, k, n], "int32_equal": True, "max_abs_err": err.max().item(),
                      "int8_matmul_ms": ms, "int_mm_ms": mm_ms, "bf16_matmul_ms": bf16_ms}
    print(f"slice (int8c): int8_matmul on the card == its plain version (int32 exact, "
          f"outputs within one bf16 unit) at {list(out)}; ms "
          f"{ {k: (round(v['int8_matmul_ms'], 4), round(v['int_mm_ms'], 4), round(v['bf16_matmul_ms'], 4)) for k, v in out.items()} } "
          f"(int8_matmul, _int_mm alone, a bf16 matmul)", flush=True)
    return out


def int8c_served(config: Path, name: str, n_buckets: int, drive_fn) -> dict:
    """Serve ``config`` with ``model.<name>.quantize=int8c``; ``drive_fn(port)``
    sends the requests; the server's counts come back with the answers."""
    with serving(config, n_buckets=n_buckets, overrides=(f"model.{name}.quantize=int8c",)) as port:
        inv = json.loads(call(port, "GET", "/v1/models")[1])[name]
        check(inv["quantize"] == "int8c", f"{name} serves quantize={inv['quantize']!r}")
        run = drive_fn(port)
        run["captures_total"] = inv["captures_total"]
    return run


def int8c_compare(mcfg, bucket: tuple, host: tuple, label: str) -> dict:
    """int8c against weight-only int8 (and bf16) on the same seeded weights
    and batch at ``bucket``: logits within INT8C_LOGIT_REL of the int8
    logits' scale, top-5 equal where they separate by more; each variant's
    replay device time at that bucket (a runtime of that one bucket)."""
    import dataclasses

    import torch

    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    over = ({"batch_buckets": [bucket[0]], "seq_buckets": [bucket[1]]} if len(bucket) == 2
            else {"batch_buckets": [bucket[0]]})
    logits, replay = {}, {}
    for quantize in (None, "int8", "int8c"):
        model = build(dataclasses.replace(mcfg, quantize=quantize, **over))
        rt = build_runtime(model, device="cuda")
        dev = rt.h2d(bucket, host)
        with torch.inference_mode():
            logits[quantize or "bf16"] = model.logits(rt.module, dev).float()
        replay[quantize or "bf16"] = replay_timing(rt, bucket, dev)
        del rt, model
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    c, w = logits["int8c"], logits["int8"]
    check(bool(torch.isfinite(c).all()), f"{label}: int8c logits not finite")
    err = (c - w).abs().max().item()
    tol = INT8C_LOGIT_REL * w.abs().max().item()
    check(err <= tol, f"{label}: int8c vs int8 logits differ by {err:.4g} > {tol:.4g}")
    checked = separated_ranks_agree(c, w, f"{label} int8c vs int8", tol)
    out = {"bucket": list(bucket), "int8c_vs_int8": {"max_abs_diff": err, "tol": tol,
                                                     "separated_ranks_checked": checked},
           "int8_vs_bf16_max_abs_diff": (w - logits["bf16"]).abs().max().item(),
           "replay_device_ms": replay}
    print(f"slice (int8c): {label} {bucket}: int8c vs int8 logits max abs diff {err:.4g} (tol "
          f"{tol:.4g}), {checked} separated top-5 ranks agree; replay device ms "
          f"{ {k: round(v['replay_device_ms'], 4) for k, v in replay.items()} }", flush=True)
    return out


def int8c_phase(card: str) -> dict:
    """Phase 15: BERT-flash and ResNet-50 served with ``quantize = "int8c"``."""
    import dataclasses

    import numpy as np
    import torch

    from tpuserve_torch.config import load_config
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    t0 = time.perf_counter()
    run = {"int8_matmul": int8_matmul_check(), "bert_layers": SHALLOW_LAYERS}
    shallow = shallow_config()
    # The int8c ResNet-50 server boots beside the BERT one (after the
    # int8_matmul timings).
    prestart(RESNET_CONFIG, 6, ("model.resnet50.quantize=int8c",))
    bert = int8c_served(shallow, "bert", 6, lambda port: drive(port, layers=SHALLOW_LAYERS))
    run["bert_launches_k1"] = bert["launches"]
    # The lifecycle under int8c: staged checkpoints quantize the same way and
    # the graphs survive publish and rollback.
    run["lifecycle_bert_int8c"] = lifecycle_drill(
        shallow, "bert", 6, json.dumps({"texts": TEXTS_8}).encode(), "application/json",
        overrides=("model.bert.quantize=int8c",))
    # Served answers == an in-process int8c run of the same seeded model.
    mcfg = dataclasses.replace(load_config(str(shallow)).models[0], quantize="int8c")
    model = build(mcfg)
    rt = build_runtime(model, device="cuda")
    items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
             for t in TEXTS_32]
    ref = rt.fetch(rt.run((32, 64), model.assemble(items, (32, 64))))
    for row, t in enumerate(TEXTS_32):
        served = bert["answers"][t]["top_k"]
        check([e["class"] for e in served] == ref["indices"][row].tolist(),
              f"int8c: served top-5 != in-process top-5 for {t!r}")
        check(np.allclose([e["prob"] for e in served], ref["probs"][row], rtol=0, atol=1e-6),
              f"int8c: served probs != in-process probs for {t!r}")
    native = sum(1 for m in rt.module.modules() if getattr(m, "weight_scale", None) is not None)
    check(native == 6 * model.layers, f"int8c BERT holds {native} int8-native weights, "
                                      f"expected {6 * model.layers}")
    del rt
    torch.cuda.empty_cache()
    run["bert_compare"] = int8c_compare(mcfg, (32, 128), seeded_batch(model, (32, 128), seed=3),
                                        "bert_flash")
    print(f"slice (int8c): bert served answers equal the in-process int8c run; K1 launches "
          f"{bert['launches']} ({SHALLOW_LAYERS} per batch); {native} int8-native weights",
          flush=True)

    requests = [r for r in resnet_requests() if r[0] == "resnet50"]

    def drive_rn(port: int) -> dict:
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
        before = call(port, "GET", "/metrics")[1].decode()
        answers = {}
        for name, label, body, ctype, items in requests:
            st, raw = call(port, "POST", f"/v1/models/{name}:classify", raw=body, ctype=ctype)
            check(st == 200, f"int8c {name} {label}: {st} {raw[:300]!r}")
            res = json.loads(raw)
            answers[label] = res["results"] if "results" in res else [res]
        after = call(port, "GET", "/metrics")[1].decode()
        stats = json.loads(call(port, "GET", "/stats")[1])
        counts = (stats["kernels"]["flash_attention"]["launches"],
                  stats["kernels"]["flash_attention_stats"]["launches"])
        delta = {n: metric(after, f'{n}{{model="resnet50"}}') - metric(before, f'{n}{{model="resnet50"}}')
                 for n in ("batches_total", "items_total", "runtime_compiles_total")}
        check(counts == (0, 0), f"K1, K2 launched {counts} times on the int8c ResNet path")
        check((delta["batches_total"], delta["items_total"], delta["runtime_compiles_total"])
              == (3, 41, 0), f"int8c resnet50: batches/items/compiles moved by {delta}")
        return {"answers": answers, "deltas": delta}

    rn = int8c_served(RESNET_CONFIG, "resnet50", 6, drive_rn)
    rcfg = dataclasses.replace(load_config(str(RESNET_CONFIG)).model("resnet50"), quantize="int8c")
    model = build(rcfg)
    rt = build_runtime(model, device="cuda")
    for _, label, _, _, items in requests:
        bucket = model.bucket_for(len(items))
        ref = rt.fetch(rt.run(bucket, model.assemble(items, bucket)))
        for row, served in enumerate(rn["answers"][label]):
            check([e["class"] for e in served["top_k"]] == ref["indices"][row].tolist(),
                  f"int8c resnet50 {label}: served top-5 != in-process top-5, row {row}")
    native = sum(1 for m in rt.module.modules() if getattr(m, "weight_scale", None) is not None)
    check(native == 36, f"int8c ResNet-50 holds {native} int8-native 1x1 weights, expected 36")
    del rt
    torch.cuda.empty_cache()
    run["resnet_compare"] = int8c_compare(rcfg, (32,), seeded_batch(model, (32,), seed=3),
                                          "resnet50")
    run["resnet_deltas"] = rn["deltas"]
    print(f"slice (int8c): resnet50 served answers equal the in-process int8c run; "
          f"{native} int8-native weights; {rn['deltas']}", flush=True)
    run["card"] = card
    run["phase_s"] = time.perf_counter() - t0
    return run


# -- phase 16: the command line and the load generator ---------------------------------

CLI_BENCH_S = ("--duration", "5", "--warmup", "1")
CLI_TIMEOUT_S = 240.0
RESNET_RATE = 20.0   # framed 32-item requests per second to resnet50 (640 images/s)
# Probes on; device_utilization over a 2 s window sampled every 0.25 s, so a
# reading 3 s after a bench run's first batch (1 s warm-up) covers that run
# alone.
CLI_SERVE_SETS = ("roofline_probe_iters=8", "telemetry.sample_interval_s=0.25",
                  "telemetry.utilization_window_s=2")


class Cli:
    """``python -m tpuserve_torch <args>`` from the checkout, started at
    once; its stdout and stderr go to files under ``tmp`` (a pipe nobody
    reads while the process runs could fill and stall it)."""

    def __init__(self, tmp: Path, label: str, *args: str) -> None:
        self.label = label
        self.out_path, self.err_path = tmp / f"{label}.out", tmp / f"{label}.err"
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.proc = subprocess.Popen([sys.executable, "-m", "tpuserve_torch", *args],
                                         cwd=ROOT, stdout=out, stderr=err)

    def finish(self, timeout_s: float = CLI_TIMEOUT_S) -> tuple[int, str]:
        """Wait: (exit code 0 or 1, stdout); any other end fails the phase
        with the tail of stderr."""
        try:
            self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.kill()
            raise SmokeFailure(f"{self.label} did not end in {timeout_s:.0f} s:\n"
                               + self.err_path.read_text()[-3000:])
        if self.proc.returncode not in (0, 1):
            raise SmokeFailure(f"{self.label} exited {self.proc.returncode}:\n"
                               + self.err_path.read_text()[-3000:])
        return self.proc.returncode, self.out_path.read_text()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


def batches_now(port: int) -> float:
    """``batches_total`` summed over the served models."""
    text = call(port, "GET", "/metrics")[1].decode()
    return sum(float(v) for v in re.findall(r'^batches_total\{model="[^"]+"\} (\S+)$', text, re.M))


def bench_run(tmp: Path, port: int, label: str, *args: str,
              sample_at_s: float | None = None) -> dict:
    """One ``python -m tpuserve_torch bench`` against the server on ``port``,
    K1 counted over it: the counts set to 0 just before, read just after,
    against ``batches_total`` over the same span. With ``sample_at_s``,
    ``device_utilization`` is read that long after the load's first batch
    (a bench process that builds framed bodies imports torch first, so its
    load starts seconds after the process)."""
    check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
    before = call(port, "GET", "/metrics")[1].decode()
    bench = Cli(tmp, "bench_" + re.sub(r"\W+", "_", label), "bench", "--url",
                f"http://127.0.0.1:{port}", *CLI_BENCH_S, *args)
    util = None
    try:
        if sample_at_s is not None:
            first = batches_now(port)
            deadline = time.monotonic() + 60.0
            while batches_now(port) == first and bench.proc.poll() is None:
                check(time.monotonic() < deadline, f"bench {label}: no batch in 60 s")
                time.sleep(0.05)
            time.sleep(sample_at_s)
            text = call(port, "GET", "/metrics")[1].decode()
            util = {m.group(1): float(m.group(2)) for m in re.finditer(
                r'^device_utilization\{model="([^"]+)",replica="0"\} (\S+)$', text, re.M)}
        rc, out = bench.finish()
    finally:
        bench.kill()
    summary = json.loads(out.strip().splitlines()[-1])
    after = call(port, "GET", "/metrics")[1].decode()
    stats = json.loads(call(port, "GET", "/stats")[1])
    batches = {n: metric(after, f'batches_total{{model="{n}"}}')
               - metric(before, f'batches_total{{model="{n}"}}') for n in stats["roofline"]}
    k1 = stats["kernels"]["flash_attention"]["launches"]
    check(rc == 0, f"bench {label} exited {rc}: {summary}")
    check(summary["n_ok"] > 0 and summary["n_err"] == 0, f"bench {label}: {summary}")
    print(f"cli: bench {label}: {summary['throughput_per_s']}/s, p50 {summary['p50_ms']} ms, "
          f"p99 {summary['p99_ms']} ms, n_ok {summary['n_ok']}, n_err {summary['n_err']}; "
          f"K1 {k1} over {batches} batches; device_utilization {util}", flush=True)
    return {"summary": summary, "k1_launches": k1, "batches": batches,
            "device_utilization": util}


def chaos_config(tmp: Path, probability: float) -> Path:
    """A copy of examples/resnet50.toml holding its ``resnet50_rgb`` model (npy
    at 256) alone, with a ``[faults]`` table: ``batch_error`` at
    ``probability`` and ``reload_corrupt`` at 1.0, so every drilled reload is
    refused at the integrity gate and version 1 keeps serving."""
    head, *blocks = RESNET_CONFIG.read_text().split("[[model]]")
    rgb = [b for b in blocks if 'name = "resnet50_rgb"' in b]
    check(len(rgb) == 1, "examples/resnet50.toml names no resnet50_rgb model")
    path = tmp / f"chaos_{probability}.toml"
    path.write_text(head + "[[model]]" + rgb[0] + f"""
[faults]
enabled = true
seed = 1

[[faults.rule]]
kind = "batch_error"
model = "resnet50_rgb"
probability = {probability}

[[faults.rule]]
kind = "reload_corrupt"
model = "resnet50_rgb"
""")
    return path


def cli_phase(card: str) -> dict:
    """Phase 16: ``describe``, ``warmup``, ``bench``, ``chaos`` and ``lint``
    through ``python -m tpuserve_torch``, as a user runs them (``lint`` must
    exit 0 against the port's checked-in baseline on this machine)."""
    import importlib.util

    import torch

    t0 = time.perf_counter()
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        payload = tmp / "texts32.json"
        payload.write_text(json.dumps({"texts": TEXTS_32}))
        describe = Cli(tmp, "describe", "describe")
        lint = Cli(tmp, "lint", "lint")
        shallow = shallow_config()
        warmup = Cli(tmp, "warmup", "warmup", "--config", str(shallow))
        with serving(shallow, n_buckets=6, overrides=CLI_SERVE_SETS) as port:
            rc, text = describe.finish()
            desc = json.loads(text)
            name = torch.cuda.get_device_name(0)
            check(rc == 0 and desc["platform"] == "gpu" and any(name in d for d in desc["devices"]),
                  f"describe: {desc}")
            rc, _ = lint.finish()
            lint_err = lint.err_path.read_text().strip().splitlines()
            check(rc == 0, "lint exited 1 against the baseline:\n" + lint.out_path.read_text()[-3000:])
            out["lint"] = {"exit": rc, "summary": lint_err[-1] if lint_err else "",
                           "jax_importable": importlib.util.find_spec("jax") is not None}
            print(f"cli: lint exit {rc}: {out['lint']['summary']} (jax importable here: "
                  f"{out['lint']['jax_importable']})", flush=True)
            rc, text = warmup.finish()
            check(rc == 0, f"warmup exited {rc}")
            warm = json.loads(text)["bert"]
            want = [[b, s] for b in (1, 8, 32) for s in (64, 128)]
            check(sorted(warm["buckets"]) == sorted(want), f"warmup buckets {warm['buckets']}")
            out["describe"], out["warmup_buckets"] = desc, warm["buckets"]
            st, body = call(port, "GET", "/")
            check(st == 200 and body.startswith(b"<!doctype html>"), f"GET / answered {st}")
            common = ("--model", "bert", "--verb", "classify", "--payload", str(payload),
                      "--content-type", "application/json")
            runs = {"closed_c8": bench_run(tmp, port, "closed c8", *common, "--concurrency", "8")}
            rate = runs["closed_c8"]["summary"]["throughput_per_s"] / 2
            runs["open"] = bench_run(tmp, port, f"open {rate:g}/s", *common, "--rate", f"{rate:g}",
                                     sample_at_s=3.0)
            runs["open_procs2"] = bench_run(tmp, port, f"open {rate:g}/s procs 2", *common,
                                            "--rate", f"{rate:g}", "--procs", "2",
                                            sample_at_s=3.0)
            for label, r in runs.items():
                check(r["k1_launches"] > 0
                      and r["k1_launches"] == SHALLOW_LAYERS * r["batches"]["bert"],
                      f"bench {label}: K1 launched {r['k1_launches']} times for "
                      f"{r['batches']['bert']:g} batches ({SHALLOW_LAYERS} per batch)")
            bert_roof = json.loads(call(port, "GET", "/stats")[1])["roofline"]["bert"]
            check(sorted(bert_roof["raw_ms_per_batch"]) == sorted(str(b) for b in want)
                  and all(v for v in bert_roof["raw_ms_per_batch"].values())
                  and "compute_split" in bert_roof, f"/stats roofline.bert: {bert_roof}")
        out["bert"] = {"open_rate_per_s": rate, "runs": runs, "roofline": bert_roof}
        # ResNet-50: the framed wire in the open loop, the card to itself (a
        # chaos server beside it would share the card and skew the startup
        # probes and the latencies); then both chaos runs side by side.
        with serving(RESNET_CONFIG, n_buckets=6, overrides=CLI_SERVE_SETS) as port:
            run = bench_run(tmp, port, f"resnet50 frame open {RESNET_RATE:g}/s",
                            "--model", "resnet50", "--wire", "frame", "--frame-kind", "yuv420",
                            "--edge", "160", "--batch", "32", "--rate", f"{RESNET_RATE:g}",
                            sample_at_s=3.0)
            check(run["k1_launches"] == 0,
                  f"K1 launched {run['k1_launches']} times on ResNet-50")
            roof = json.loads(call(port, "GET", "/stats")[1])["roofline"]
            check(all(sorted(roof[n]["raw_ms_per_batch"]) == ["[1]", "[32]", "[8]"]
                      for n in ("resnet50", "resnet50_rgb"))
                  and "compute_split" in roof["resnet50"], f"/stats roofline: {roof}")
        out["resnet50"] = {"rate_per_s": RESNET_RATE, "run": run, "roofline": roof}
        chaos = {p: Cli(tmp, f"chaos_{p}", "chaos", "--config", str(chaos_config(tmp, p)),
                        "--model", "resnet50_rgb", "--duration", "5",
                        "--min-availability", "0.99", "--drill", "reload")
                 for p in (0.1, 1.0)}
        try:
            results = {p: c.finish() for p, c in chaos.items()}
        finally:
            for c in chaos.values():
                c.kill()
    for p, (rc, text) in results.items():
        summary = json.loads(text)
        fired = {r["kind"]: r["fired"] for r in summary["faults"]}
        lc = summary["lifecycle"]["resnet50_rgb"]
        print(f"cli: chaos at batch_error {p}: exit {rc}, availability {summary['availability']}, "
              f"n_ok {summary['n_ok']}, n_err {summary['n_err']}, fired {fired}, breaker "
              f"{summary['breakers']['resnet50_rgb']['state']}, live_version {lc['live_version']}, "
              f"reload drill {summary['reload_drill']}", flush=True)
        if p < 1.0:
            check(rc == 0 and summary["availability"] >= 0.99 and fired["batch_error"] > 5
                  and summary["breakers"]["resnet50_rgb"]["state"] == "closed"
                  and lc["live_version"] == 1 and summary["reload_drill"]["ok"] == 0,
                  f"chaos at batch_error {p}: exit {rc}, {summary}")
        else:
            check(rc == 1 and summary["availability"] < 0.99,
                  f"chaos at batch_error {p} must exit 1 below 0.99: exit {rc}, {summary}")
        out[f"chaos_{p}"] = dict(summary, exit_code=rc)
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 17: text generation through the iteration-level engine -----------------------

TEXTGEN_CONFIG = ROOT / "examples" / "textgen_flash.toml"
# A token may differ between two computations of one request only at a step
# where the reference computation's top-two margin of its sampling scores
# (logits, or logits / T + Gumbel noise) is below this.
TG_MARGIN = 1e-3
TG_LAYERS = 12
# Two bf16 computations of one request (flash against dense prefill): a
# token may differ first only where the reference's top-two margin in logit
# units (the sampling scores' margin times T; the logits' when greedy) is
# below this — two bf16 spacings at the logits' scale, the bound
# tests/test_torch_textgen_bf16.py holds the port to the reference with.
BF16_LOGIT_TOL = 0.0625
TEXTGEN_MOE_CONFIG = ROOT / "examples" / "textgen_moe_flash.toml"
BERT_MOE_CONFIG = ROOT / "examples" / "bert_moe_flash.toml"
# The seeded host parameters of a config's model, made once per run and
# shared by every in-process runtime built from it (the Switch-MoE configs'
# 453 M expert parameters take seconds to draw).
HOST_PARAMS: dict = {}


def share_params(model, config: "Path | str"):
    """Point ``model.load_params`` at the run's one copy of ``config``'s
    seeded parameters (every model of these configs serves seed 0); a
    string names a variant of a config whose tree has other shapes."""
    key = str(config)
    if key not in HOST_PARAMS:
        HOST_PARAMS[key] = model.load_params()
    model.load_params = lambda: HOST_PARAMS[key]
    return model


def textgen_bodies(n: int = 16, seed: int = 0) -> list[dict]:
    """``n`` seeded :generate bodies: prompts of 8-256 words, max_new_tokens
    1-256 (the extremes included), temperatures 0 and 0.7 alternating."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = 256 if i == 2 else 8 if i == 3 else int(rng.integers(8, 257))
        out.append({"prompt": " ".join(rng.choice(WORDS, words)),
                    "seed": int(rng.integers(0, 2**31 - 1)),
                    "max_new_tokens": 256 if i == 0 else 1 if i == 1 else int(rng.integers(1, 257)),
                    "temperature": 0.7 if i % 2 else 0.0})
    return out


def textgen_model(attention: str = "flash", dtype: str = "bfloat16",
                  config: Path = TEXTGEN_CONFIG):
    import dataclasses

    from tpuserve_torch.config import load_config
    from tpuserve_torch.models import build

    cfg = load_config(str(config))
    mcfg = cfg.models[0]
    model = build(dataclasses.replace(mcfg, dtype=dtype,
                                      options={**mcfg.options, "attention": attention}))
    return share_params(model, config), cfg


def textgen_engine(attention: str = "flash", dtype: str = "bfloat16",
                   config: Path = TEXTGEN_CONFIG, **genserve):
    """An in-process engine on the card over ``config``'s model (seed-0
    weights, as the server's), programs captured."""
    import dataclasses

    from tpuserve_torch.genserve import GenEngine
    from tpuserve_torch.obs import Metrics
    from tpuserve_torch.runtime import build_runtime

    model, cfg = textgen_model(attention, dtype, config)
    rt = build_runtime(model, device="cuda", compile_forward=False)
    eng = GenEngine(model, rt, Metrics(), dataclasses.replace(cfg.genserve, **genserve))
    eng.compile()
    return model, rt, eng


def engine_tokens(eng, items: list, waves: int = 1) -> list:
    """Tokens of ``items`` through an in-process engine, submitted in
    ``waves`` (later waves fold into a generating block)."""
    import asyncio

    async def go():
        await eng.start()
        futs, per = [], -(-len(items) // waves)
        for w in range(waves):
            futs += [eng.submit(it) for it in items[w * per:(w + 1) * per]]
            await asyncio.sleep(0.05)
        res = await asyncio.gather(*futs)
        await eng.stop()
        return [r["tokens"] for r in res]

    return asyncio.run(go())


def locked_tokens(model, module, items: list) -> tuple[list, object, object]:
    """The locked-batch forward (``model.forward``, prefill + max_new - 1
    steps) over ``items`` padded to bucket 32, on ``module``: each lane's
    tokens, and per sampling call the top-two margin of every lane's
    sampling scores, and the same margin in logit units (times T)."""
    import torch

    from tpuserve_torch.ops import threefry

    margins, logit_margins = [], []
    orig = model._sample

    def recording(logits, seed, position, temp):
        lg = logits.float()
        k0, k1 = threefry.key(torch.zeros_like(seed))
        k0, k1 = threefry.fold_in(*threefry.fold_in(k0, k1, seed), position)
        g = threefry.gumbel(threefry.bits32(k0, k1, lg.shape[-1]))
        t = torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
        scores = torch.where(temp[:, None] > 0, lg / t + g, lg)
        top = scores.topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        logit_margins.append(margins[-1] * t[:, 0])
        return orig(logits, seed, position, temp)

    batch = model.assemble(items, (32,))
    model._sample = recording
    try:
        with torch.inference_mode():
            out = model.forward(module, tuple(torch.from_numpy(a).cuda() for a in batch))
    finally:
        model._sample = orig
    res = model.host_postprocess({k: v.cpu().numpy() for k, v in out.items()}, len(items))
    return ([r["tokens"] for r in res], torch.stack(margins, dim=1).cpu().numpy(),
            torch.stack(logit_margins, dim=1).cpu().numpy())


def compare_tokens(got: list, want: list, margins, label: str, gate: bool = True,
                   bound: float = TG_MARGIN) -> dict:
    """Lane by lane: ``got`` equals ``want`` up to the first differing step,
    which is allowed only where ``want``'s top-two margin is below
    ``bound`` (the lane is not compared past it: both continue from
    different tokens). Returns the lanes that differ, each as (lane, step,
    margin). ``gate=False`` reports them without holding the rule."""
    diff = []
    for lane, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        step = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        margin = float(margins[lane, step])
        check(margin < bound or not gate,
              f"{label}: lane {lane} differs at step {step} ({g[step:step + 3]} vs "
              f"{w[step:step + 3]}) where the margin is {margin:.3g} >= {bound}")
        diff.append((lane, step, margin))
    print(f"textgen: {label}: {len(got) - len(diff)} of {len(got)} lanes identical, "
          f"{len(diff)} differ, first at (lane, step, margin) {diff}"
          + (f" (rule: margin < {bound})" if gate else " (reported, not held to the rule)"),
          flush=True)
    return {"identical_lanes": len(got) - len(diff), "differing_lanes": diff, "bound": bound}


def textgen_kernel_checks() -> dict:
    """K1 against its plain version at the textgen prefill's shapes: the
    insert (1, 256), the locked batch (32, 256), a one-token prompt; timed at
    both."""
    import torch

    compare(*qkv(1, 256, 256, 12, 64, torch.bfloat16, seed=31))
    compare(*qkv(32, 256, 256, 12, 64, torch.bfloat16, seed=32))
    q, k, v, _ = qkv(1, 256, 256, 12, 64, torch.bfloat16, seed=33)
    bias = torch.full((1, 256), -1e9, device="cuda")
    bias[0, 0] = 0.0
    err_one = compare(q, k, v, bias)
    out = {b: k1_timing(b, 256) for b in (1, 32)}
    print(f"textgen: K1 agrees with its plain version at (1, 256), (32, 256) and a one-token "
          f"prompt (max abs err {err_one:.3g}); (1, 256) {out[1]['line']['ms'] * 1e3:.2f} us, "
          f"(32, 256) {out[32]['line']['ms'] * 1e3:.2f} us", flush=True)
    return out


def program_graphs_check(rt, item) -> dict:
    """Every program's graph replay against its eager call on a copy of the
    same state block and arguments: bit-identical state and outputs."""
    import numpy as np
    import torch

    from tpuserve_torch.runtime import LIVE_BLOCK

    block = rt.state_blocks[LIVE_BLOCK]
    fold_in = "prefill" if "prefill" in rt.gen_programs else "insert"
    pps = block["bt"].shape[1] if fold_in == "prefill" else 0
    args = {"insert": (np.array([3]), item), "step": (), "extract": (np.array([3]),),
            "prefill": (np.array([3]), item, np.int32(0),
                        np.arange(1, pps + 1, dtype=np.int32))}
    rows = {}
    rt.zero_state(LIVE_BLOCK)
    for tag in (fold_in, "step", "step", "extract"):
        prog = rt.gen_programs[tag]
        copy = {k: t.clone() for k, t in block.items()}
        flat = [a for x in args[tag] for a in (x if isinstance(x, tuple) else (x,))]
        tensors = [torch.from_numpy(np.asarray(a, dtype=s.dtype)).cuda()
                   for a, s in zip(flat, [s for x in prog.arg_specs
                                          for s in (x if isinstance(x, tuple) else (x,))])]
        it = iter(tensors)
        eager_args = tuple(tuple(next(it) for _ in s) if isinstance(s, tuple) else next(it)
                           for s in prog.arg_specs)
        replay = rt.run_program(tag, *args[tag], block=LIVE_BLOCK)
        with torch.inference_mode():
            eager = prog.fn(rt.module, copy, *eager_args)
        torch.cuda.synchronize()
        outs = ({} if replay is None else
                {"out": (replay, eager)} if torch.is_tensor(replay) else
                {k: (replay[k], eager[k]) for k in replay})
        pairs = {**{k: (block[k], copy[k]) for k in block}, **outs}
        bad = [k for k, (a, b) in pairs.items() if not torch.equal(a, b)]
        check(not bad, f"textgen: program {tag}'s replay differs from its eager call in {bad}")
        rows[tag] = "bit-identical"
    rt.zero_state(LIVE_BLOCK)
    print(f"textgen: every program's replay is bit-identical to its eager call "
          f"({sorted(rows)}), state block and outputs", flush=True)
    return rows


def step_timing(rt, eng, item, actives=(1, 8, 32), steps: int = 24) -> dict:
    """The live block's step (replay + the pinned copy of its out-block, the
    engine's per-step call) at 1, 8 and 32 active slots: host p50 per step
    and the replay's device time (CUDA events); the insert's host time and
    device time (CUDA events around each insert); the step's device time by
    kind of kernel."""
    import numpy as np
    import torch

    from tpuserve_torch.runtime import LIVE_BLOCK

    out = {}
    for n in actives:
        rt.zero_state(LIVE_BLOCK)
        inserts, insert_dev = [], []
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for slot in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            rt.run_program("insert", np.array([slot]), item, block=LIVE_BLOCK)
            ev1.record()
            torch.cuda.synchronize()
            inserts.append((time.perf_counter() - t0) * 1e3)
            insert_dev.append(ev0.elapsed_time(ev1))
        host = []
        for _ in range(steps):
            t0 = time.perf_counter()
            eng._step_sync()
            host.append((time.perf_counter() - t0) * 1e3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            rt.run_program("step", block=LIVE_BLOCK)
        end.record()
        torch.cuda.synchronize()
        out[n] = {"step_host_p50_ms": sorted(host)[steps // 2],
                  "step_device_ms": start.elapsed_time(end) / steps,
                  "insert_host_p50_ms": sorted(inserts)[len(inserts) // 2],
                  "insert_device_p50_ms": sorted(insert_dev)[len(insert_dev) // 2]}
    out["device_breakdown_step_32"] = device_breakdown(
        lambda: rt.run_program("step", block=LIVE_BLOCK))
    rt.zero_state(LIVE_BLOCK)
    print("textgen: step host p50 / device ms at 1, 8, 32 active slots: "
          + ", ".join(f"{n}: {out[n]['step_host_p50_ms']:.3f} / {out[n]['step_device_ms']:.3f}"
                      for n in actives)
          + f"; insert host / device p50 {out[32]['insert_host_p50_ms']:.3f} / "
          f"{out[32]['insert_device_p50_ms']:.3f} ms; step by kind "
          f"{ {k: round(v, 4) for k, v in out['device_breakdown_step_32']['ms_by_kind'].items()} }",
          flush=True)
    return out


def canary_keeps_live_block(rt, eng, item) -> None:
    """The staged canary runs on the scratch block: a live block holding a
    request mid-generation keeps every byte."""
    import numpy as np
    import torch

    from tpuserve_torch.runtime import LIVE_BLOCK

    rt.zero_state(LIVE_BLOCK)
    rt.run_program("insert", np.array([5]), item, block=LIVE_BLOCK)
    rt.run_program("step", block=LIVE_BLOCK)
    before = {k: t.clone() for k, t in rt.state_blocks[LIVE_BLOCK].items()}
    eng.staged_canary_sync(rt.stage_params())
    torch.cuda.synchronize()
    bad = [k for k, t in rt.state_blocks[LIVE_BLOCK].items() if not torch.equal(t, before[k])]
    check(not bad, f"textgen: the staged canary changed the live block's {bad}")
    rt.zero_state(LIVE_BLOCK)
    print("textgen: the staged canary (scratch block) left the live block's bytes unchanged",
          flush=True)


def textgen_in_process(bodies: list, served: list) -> dict:
    """In-process half: graphs, the locked batch against the served engine's
    tokens, flash against dense, the canary's block, timings, and paged
    whole-prompt KV against dense."""
    import torch

    t0 = time.perf_counter()
    model, rt, eng = textgen_engine()
    items = [model.host_decode(json.dumps(b).encode(), "application/json") for b in bodies]
    out = {"prompt_tokens": [int(it[1]) for it in items],
           "captures_total": rt.captures_total, "compiles_total": rt.compiles_total,
           "capture_memory": dict(rt.capture_memory)}
    out["graphs"] = program_graphs_check(rt, items[2])
    mine = engine_tokens(eng, items, waves=2)
    check(mine == served, "textgen: the in-process engine's tokens differ from the served "
          "engine's (same weights, same programs)")
    locked, margins, _ = locked_tokens(model, rt.module, items)
    out["engine_vs_locked"] = compare_tokens(served, locked, margins, "engine vs locked batch")
    canary_keeps_live_block(rt, eng, items[2])
    out["timing"] = step_timing(rt, eng, items[2])
    del model, rt, eng
    torch.cuda.empty_cache()
    model_d, rt_d, eng_d = textgen_engine("dense")
    dense = engine_tokens(eng_d, items, waves=2)
    dense_locked, dense_margins, dense_logit_margins = locked_tokens(model_d, rt_d.module, items)
    out["dense_engine_vs_dense_locked"] = compare_tokens(dense, dense_locked, dense_margins,
                                                         "dense engine vs dense locked batch")
    # In bf16 the two attention cores round differently (K1 keeps the
    # scores in f32, the dense twin rounds them to bf16 as the reference's
    # does), which moves logits by more than TG_MARGIN: held to the bf16
    # rule (BF16_LOGIT_TOL, in logit units).
    out["flash_vs_dense_bf16"] = compare_tokens(served, dense, dense_logit_margins,
                                                "flash engine vs dense engine, bf16",
                                                bound=BF16_LOGIT_TOL)
    del model_d, rt_d, eng_d
    torch.cuda.empty_cache()
    # Held to the rule in float32 (TF32 off; K1's CUDA-core kernel): the
    # flash engine against the dense locked batch.
    model_f, rt_f, eng_f = textgen_engine("flash", dtype="float32")
    flash32 = engine_tokens(eng_f, items, waves=2)
    del model_f, rt_f, eng_f
    torch.cuda.empty_cache()
    from tpuserve_torch.runtime import build_runtime

    model_d = textgen_model("dense", "float32")[0]
    rt_d = build_runtime(model_d, device="cuda", compile_forward=False)
    dense32, margins32, _ = locked_tokens(model_d, rt_d.module, items)
    out["flash_vs_dense_f32"] = compare_tokens(flash32, dense32, margins32,
                                               "flash engine vs dense locked batch, float32")
    del model_d, rt_d
    torch.cuda.empty_cache()
    model_p, rt_p, eng_p = textgen_engine(kv_paging=True, prefill_chunk=0)
    out["graphs_paged"] = program_graphs_check(rt_p, items[2])
    paged = engine_tokens(eng_p, items, waves=2)
    check(paged == served, "textgen: whole-prompt paged KV tokens differ from the dense "
          "engine's")
    print("textgen: whole-prompt paged KV tokens equal the dense engine's for all "
          f"{len(items)} requests", flush=True)
    del model_p, rt_p, eng_p
    torch.cuda.empty_cache()
    out["in_process_s"] = time.perf_counter() - t0
    return out


def generate(port: int, bodies: list, waves: int = 2, timeout_s: float = 300.0) -> list:
    """POST each body to :generate from its own thread, in ``waves``; the
    answers in body order."""
    import threading

    answers: list = [None] * len(bodies)

    def one(i: int) -> None:
        answers[i] = call(port, "POST", "/v1/models/textgen:generate", bodies[i])

    per = -(-len(bodies) // waves)
    threads = []
    for w in range(waves):
        for i in range(w * per, min(len(bodies), (w + 1) * per)):
            threads.append(threading.Thread(target=one, args=(i,)))
            threads[-1].start()
        time.sleep(0.3)
    for t in threads:
        t.join(timeout_s)
    out = []
    for i, a in enumerate(answers):
        check(a is not None and a[0] == 200, f"textgen request {i}: {a and a[0]} "
              f"{a and a[1][:300]!r}")
        res = json.loads(a[1])
        check(res["n_tokens"] == len(res["tokens"]) <= bodies[i]["max_new_tokens"],
              f"textgen request {i}: {res['n_tokens']} tokens for max_new_tokens "
              f"{bodies[i]['max_new_tokens']}")
        out.append(res["tokens"])
    return out


def gen_counters(port: int) -> dict:
    text = call(port, "GET", "/metrics")[1].decode()
    names = ("gen_admitted_total", "gen_iterations_total", "gen_fold_ins_total",
             "gen_early_exits_total", "gen_evictions_total", "gen_units_total",
             "runtime_compiles_total")
    out = {n: metric(text, f'{n}{{model="textgen"}}') for n in names}
    inv = json.loads(call(port, "GET", "/v1/models")[1])["textgen"]
    out["captures_total"] = inv["captures_total"]
    return out


def textgen_served(tmp: Path, bodies: list) -> dict:
    """The main path: examples/textgen_flash.toml through ``python -m
    tpuserve_torch serve``."""
    out: dict = {}
    with serving(TEXTGEN_CONFIG, n_buckets=3) as port:
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
        c0 = gen_counters(port)
        t0 = time.perf_counter()
        tokens = generate(port, bodies)
        wall_s = time.perf_counter() - t0
        stats = json.loads(call(port, "GET", "/stats")[1])
        k1 = stats["kernels"]["flash_attention"]["launches"]
        c1 = gen_counters(port)
        d = {n: c1[n] - c0[n] for n in c0}
        print(f"textgen: {len(bodies)} requests, {d['gen_units_total']:g} tokens in "
              f"{wall_s:.2f} s; inserts {d['gen_admitted_total']:g}, steps "
              f"{d['gen_iterations_total']:g}, K1 launches {k1}, fold-ins "
              f"{d['gen_fold_ins_total']:g}, early exits {d['gen_early_exits_total']:g}",
              flush=True)
        check(d["gen_admitted_total"] == len(bodies) and k1 == TG_LAYERS * len(bodies),
              f"textgen: K1 launched {k1} times for {d['gen_admitted_total']:g} inserts "
              f"({TG_LAYERS} per insert, none per decode step)")
        check(d["gen_iterations_total"] > 0 and stats["kernels"]["flash_attention_stats"][
            "launches"] == 0, "textgen: no decode step ran, or K2 launched")
        check(d["gen_fold_ins_total"] > 0 and d["gen_early_exits_total"] > 0,
              f"textgen: fold-ins {d['gen_fold_ins_total']:g}, early exits "
              f"{d['gen_early_exits_total']:g}: both must exceed 0")
        out.update(tokens=tokens, wall_s=wall_s, k1_launches=k1, deltas=d)
        # A request whose deadline lands mid-generation: evicted, fast 504.
        st, body = call(port, "POST", "/v1/models/textgen:generate?timeout_ms=60",
                        {"prompt": "a deadline inside the generation", "seed": 3,
                         "max_new_tokens": 256})
        ev = gen_counters(port)["gen_evictions_total"] - c1["gen_evictions_total"]
        check(st == 504 and ev == 1, f"textgen: past-deadline request answered {st} "
              f"{body[:200]!r}, evictions {ev:g}")
        st, body = call(port, "POST", "/v1/models/textgen:generate?stream=true",
                        {"prompt": "x", "max_new_tokens": 2})
        events = [line for line in body.split(b"\n") if line.startswith(b"event: ")]
        check(st == 200 and events == [b"event: token"] * 2 + [b"event: done"],
              f"textgen: ?stream=true answered {st} {body[:300]!r}")
        # Churn, reload and rollback: no new compile, no new capture.
        c2 = gen_counters(port)
        again = generate(port, bodies[:8], waves=1)
        check(again == tokens[:8], "textgen: a second run of the same requests changed tokens")
        st, body = call(port, "POST", "/admin/models/textgen:reload")
        check(st == 200, f"textgen: :reload answered {st} {body[:300]!r}")
        again = generate(port, bodies[8:], waves=1)
        st, body = call(port, "POST", "/admin/models/textgen:rollback")
        check(st == 200, f"textgen: :rollback answered {st} {body[:300]!r}")
        again += generate(port, bodies[:4], waves=1)
        c3 = gen_counters(port)
        moved = {n: c3[n] - c2[n] for n in ("runtime_compiles_total", "captures_total")}
        check(moved == {"runtime_compiles_total": 0, "captures_total": 0},
              f"textgen: churn, :reload and :rollback moved {moved}")
        print(f"textgen: deadline eviction answered 504; ?stream=true streamed; churn, :reload "
              f"(staged canary) and :rollback: compiles and captures moved {moved}", flush=True)
        out["graphs_served"] = served_graphs(port)["textgen"]
        # The generative load: bench with the prompt pool.
        before = gen_counters(port)
        bench = Cli(tmp, "bench_textgen", "bench", "--url", f"http://127.0.0.1:{port}",
                    "--model", "textgen", "--verb", "generate", *CLI_BENCH_S,
                    "--concurrency", "32", "--content-type", "application/json",
                    "--synthetic", "prompt", "--distinct", "64", "--max-new", "1,256",
                    "--long-every", "8", "--long-words", "200")
        try:
            # Tokens/s inside the load: gen_units_total over 4 s from the
            # first retirement the load causes.
            deadline = time.monotonic() + 60.0
            while gen_counters(port)["gen_units_total"] == before["gen_units_total"]:
                check(time.monotonic() < deadline and bench.proc.poll() is None,
                      "textgen: bench retired no token in 60 s")
                time.sleep(0.05)
            u0, t_0 = gen_counters(port), time.perf_counter()
            time.sleep(4.0)
            u1, t_1 = gen_counters(port), time.perf_counter()
            rc, text = bench.finish()
        finally:
            bench.kill()
        summary = json.loads(text.strip().splitlines()[-1])
        after = gen_counters(port)
        check(rc == 0 and summary["n_ok"] > 0 and summary["n_err"] == 0,
              f"textgen: bench exited {rc}: {summary}")
        units = after["gen_units_total"] - before["gen_units_total"]
        window = {k: u1[k] - u0[k] for k in ("gen_units_total", "gen_iterations_total",
                                                "gen_admitted_total")}
        out["bench"] = {"summary": summary, "tokens": units,
                        "steps": after["gen_iterations_total"] - before["gen_iterations_total"],
                        "window_s": t_1 - t_0, "window": window,
                        "tokens_per_s": window["gen_units_total"] / (t_1 - t_0),
                        "steps_per_s": window["gen_iterations_total"] / (t_1 - t_0)}
        print(f"textgen: bench (32 connections, prompt pool, max_new 1-256): "
              f"{summary['throughput_per_s']} requests/s, p50 {summary['p50_ms']} ms, "
              f"n_err {summary['n_err']}; {units:g} tokens over the run, "
              f"{out['bench']['tokens_per_s']:.0f} tokens/s and "
              f"{out['bench']['steps_per_s']:.1f} steps/s over {t_1 - t_0:.2f} s inside it",
              flush=True)
    return out


def textgen_paged_served(bodies: list) -> dict:
    """Paged KV with chunked prefill (64-token chunks) served: tokens
    deterministic across two runs and batch mixes; KV exhaustion sheds 503
    kv_pressure."""
    import threading

    out: dict = {}
    with serving(TEXTGEN_CONFIG, n_buckets=3, overrides=TG_PAGED_SETS) as port:
        c0 = gen_counters(port)
        first = generate(port, bodies, waves=2)
        mix = generate(port, bodies[::-1], waves=4)[::-1]
        check(first == mix, "textgen paged: chunked-prefill tokens changed with the batch mix")
        # 256 usable pages; a (256 + 256)-token request reserves 32: eight
        # held, eight queued, and the backlog bound (2 x 256) sheds the next.
        long_body = {"prompt": " ".join(["token"] * 256), "seed": 1, "max_new_tokens": 256}
        answers = []
        threads = [threading.Thread(target=lambda s=s: answers.append(
            call(port, "POST", "/v1/models/textgen:generate", dict(long_body, seed=s))))
            for s in range(16)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        st, body = call(port, "POST", "/v1/models/textgen:generate", dict(long_body, seed=99))
        for t in threads:
            t.join(300)
        reason = json.loads(body).get("reason") if st == 503 else None
        check(st == 503 and reason == "kv_pressure",
              f"textgen paged: KV exhaustion answered {st} {body[:200]!r}")
        check(sorted(a[0] for a in answers) == [200] * 16,
              "textgen paged: a held or queued request failed")
        kv = json.loads(call(port, "GET", "/stats")[1])["genserve"]["textgen"]["kv"]
        check(kv["reserved"] == 0, f"textgen paged: pages still reserved after the drain: {kv}")
        c1 = gen_counters(port)
        moved = {n: c1[n] - c0[n] for n in ("runtime_compiles_total", "captures_total")}
        check(moved == {"runtime_compiles_total": 0, "captures_total": 0},
              f"textgen paged: page churn and chunked prefill moved {moved}")
        out.update(chunked_deterministic=True, shed_status=st, shed_reason=reason, kv=kv,
                   chunks_total=kv["prefill_chunks_total"])
        print(f"textgen paged (64-token chunks): tokens equal across two runs and batch "
              f"mixes; KV exhaustion shed {st} {reason}; {kv['prefill_chunks_total']} prefill "
              f"chunks; compiles and captures moved {moved}", flush=True)
    return out


# Phase 17's paged server: 64-token chunks over 257 pages.
TG_PAGED_SETS = ("genserve.kv_paging=true", "genserve.prefill_chunk=64", "genserve.kv_pages=257")


def textgen_phase(card: str) -> dict:
    """Phase 17: examples/textgen_flash.toml (GPT-2 small widths, 12 layers)
    served through the generation engine, K1 in the prefill."""
    import torch

    t0 = time.perf_counter()
    out: dict = {"card": card, "config": str(TEXTGEN_CONFIG.relative_to(ROOT))}
    out["kernels"] = textgen_kernel_checks()
    bodies = textgen_bodies()
    # The paged server boots beside the first one (after K1's timings).
    prestart(TEXTGEN_CONFIG, 3, TG_PAGED_SETS)
    with tempfile.TemporaryDirectory() as tmp_name:
        out["served"] = textgen_served(Path(tmp_name), bodies)
    out["in_process"] = textgen_in_process(bodies, out["served"]["tokens"])
    out["paged"] = textgen_paged_served(bodies)
    out["served"].pop("tokens")
    out["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


# -- phase 18: streamed generation ----------------------------------------------

# Chance a started stream is torn after each unit, in phase 18's fault drill.
STREAM_TEAR_P = 0.2
# Phase 18's tearing server: paged KV, stream_disconnect at STREAM_TEAR_P.
TORN_SETS = ("genserve.kv_paging=true",)
TORN_FAULTS = ("[faults]\nenabled = true\nseed = 1\n\n[[faults.rule]]\n"
               f'kind = "stream_disconnect"\nmodel = "textgen"\nprobability = {STREAM_TEAR_P}\n')


def stream_events(bodies: list, port: int) -> tuple[list, list]:
    """Each body streamed with ``?stream=true`` (the port's client, SSE
    parsed) beside the same unary request, all at once: per body (status,
    SSE events as (event, data)) and (status, unary answer)."""
    import asyncio

    from tpuserve_torch.bench.client import ClientSession
    from tpuserve_torch.bench.loadgen import SseParser

    url = f"http://127.0.0.1:{port}/v1/models/textgen:generate"
    hdr = {"Content-Type": "application/json"}

    async def one_stream(session, body):
        async with session.stream("POST", url + "?stream=true", json.dumps(body).encode(),
                                  hdr, 300.0) as r:
            raw = b""
            async for chunk in r.iter_any():
                raw += chunk
        return r.status, SseParser().feed(raw)

    async def go():
        async with ClientSession(limit=0) as session:
            streams = [one_stream(session, b) for b in bodies]
            plain = [session.post(url, json.dumps(b).encode(), hdr, 300.0) for b in bodies]
            res = await asyncio.gather(*streams, *plain)
        return res[:len(bodies)], [(r.status, json.loads(r.body)) for r in res[len(bodies):]]

    return asyncio.run(go())


def stream_audit(bodies: list, streams: list, unary: list, eos: int) -> dict:
    """The byte audit, stream by stream: 200, token events with contiguous
    indices whose ids are the unary answer's tokens and whose concatenated
    text is its text byte for byte, and exactly one terminal, last: done,
    its finish reason and completion_tokens the unary answer's."""
    n_tokens = 0
    for i, ((st, events), (ust, ans)) in enumerate(zip(streams, unary)):
        check(st == 200 and ust == 200, f"stream {i}: statuses {st} / {ust}")
        toks = [json.loads(d) for e, d in events if e == "token"]
        terms = [(e, json.loads(d)) for e, d in events if e in ("done", "error")]
        check(len(terms) == 1 and events[-1][0] == "done",
              f"stream {i}: terminals {terms} (exactly one done, last)")
        want_reason = "stop" if ans["tokens"] and ans["tokens"][-1] == eos else "length"
        check(terms[0][1] == {"finish_reason": want_reason,
                              "usage": {"completion_tokens": ans["n_tokens"]}},
              f"stream {i}: done {terms[0][1]}, unary n_tokens {ans['n_tokens']}")
        check([t["index"] for t in toks] == list(range(ans["n_tokens"]))
              and [t["token"] for t in toks] == ans["tokens"],
              f"stream {i}: token events differ from the unary tokens")
        check("".join(t["text"] for t in toks) == ans["text"],
              f"stream {i}: streamed text differs from the unary text")
        check(len(toks) <= bodies[i]["max_new_tokens"], f"stream {i}: too many tokens")
        n_tokens += len(toks)
    return {"streams": len(streams), "tokens": n_tokens, "torn": 0}


def stream_counters(port: int) -> dict:
    text = call(port, "GET", "/metrics")[1].decode()
    out = {n: metric(text, f'{n}{{model="textgen"}}') for n in (
        "gen_admitted_total", "gen_streams_total", "gen_client_disconnects_total",
        "runtime_compiles_total", "gen_active_slots", "gen_kv_pages_free",
        "gen_kv_pages_total")}
    out["done"] = metric(text, 'gen_stream_terminated_total{model="textgen",reason="done"}')
    out["disconnect"] = metric(
        text, 'gen_stream_terminated_total{model="textgen",reason="disconnect"}')
    out["injected"] = metric(
        text, 'faults_injected_total{model="textgen",kind="stream_disconnect"}')
    out["captures_total"] = json.loads(call(port, "GET", "/v1/models")[1])["textgen"][
        "captures_total"]
    return out


def streaming_served(tmp: Path, bodies: list, eos: int) -> dict:
    """The clean server: the byte audit with K1 counted, then ``bench
    --stream``."""
    out: dict = {}
    with serving(TEXTGEN_CONFIG, n_buckets=3) as port:
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
        c0 = stream_counters(port)
        t0 = time.perf_counter()
        streams, unary = stream_events(bodies, port)
        wall_s = time.perf_counter() - t0
        k1 = json.loads(call(port, "GET", "/stats")[1])["kernels"]["flash_attention"]["launches"]
        c1 = stream_counters(port)
        d = {n: c1[n] - c0[n] for n in c0}
        out["audit"] = stream_audit(bodies, streams, unary, eos)
        check(d["gen_admitted_total"] == 2 * len(bodies)
              and k1 == TG_LAYERS * d["gen_admitted_total"],
              f"stream: K1 launched {k1} times for {d['gen_admitted_total']:g} inserts")
        check(d["gen_streams_total"] == len(bodies) and d["done"] == len(bodies),
              f"stream: streams {d['gen_streams_total']:g}, done {d['done']:g}")
        print(f"stream: {len(bodies)} streams beside their unary twins in {wall_s:.2f} s: "
              f"{out['audit']['tokens']} tokens, byte audit equal, one done each, torn 0; "
              f"inserts {d['gen_admitted_total']:g}, K1 launches {k1}", flush=True)
        out.update(wall_s=wall_s, k1_launches=k1, inserts=d["gen_admitted_total"],
                   unary=[a for _, a in unary])
        # bench --stream: 32 connections, the prompt pool, K1 counted.
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
        b0 = stream_counters(port)
        bench = Cli(tmp, "bench_stream", "bench", "--url", f"http://127.0.0.1:{port}",
                    "--model", "textgen", "--verb", "generate", *CLI_BENCH_S, "--stream",
                    "--concurrency", "32", "--content-type", "application/json",
                    "--synthetic", "prompt", "--distinct", "64", "--max-new", "1,256",
                    "--long-every", "8", "--long-words", "200")
        try:
            rc, text = bench.finish()
        finally:
            bench.kill()
        summary = json.loads(text.strip().splitlines()[-1])
        k1b = json.loads(call(port, "GET", "/stats")[1])["kernels"]["flash_attention"][
            "launches"]
        b1 = stream_counters(port)
        inserts = b1["gen_admitted_total"] - b0["gen_admitted_total"]
        check(rc == 0 and summary["n_ok"] > 0 and summary["n_err"] == 0
              and summary["torn_streams"] == 0, f"stream: bench --stream exited {rc}: {summary}")
        check(k1b == TG_LAYERS * inserts, f"stream: bench: K1 {k1b} for {inserts:g} inserts")
        moved = {n: b1[n] - c0[n] for n in ("runtime_compiles_total", "captures_total")}
        check(moved == {"runtime_compiles_total": 0, "captures_total": 0},
              f"stream: streaming moved {moved}")
        out["bench"] = {"summary": {k: v for k, v in summary.items()
                                    if k != "inter_token_gap_hist_ms"},
                        "k1_launches": k1b, "inserts": inserts}
        print(f"stream: bench --stream (32 connections, 5 s): {summary['streams_per_s']} "
              f"streams/s, {summary['tokens_per_s']} tokens/s, first token p50/p99 "
              f"{summary['first_token_p50_ms']} / {summary['first_token_p99_ms']} ms, "
              f"inter-token gap p50/p99 {summary['inter_token_gap_p50_ms']} / "
              f"{summary['inter_token_gap_p99_ms']} ms, n_err {summary['n_err']}, torn "
              f"{summary['torn_streams']}; K1 {k1b} = 12 x {inserts:g} inserts; compiles and "
              f"captures moved {moved}", flush=True)
    return out


def streaming_torn(bodies: list, unary: list) -> dict:
    """A paged server tearing started streams (``stream_disconnect`` at
    STREAM_TEAR_P): every injected stream torn, the rest whole and equal to
    the unary text; then no active slot and every KV page free."""
    import asyncio

    from tpuserve_torch.bench.client import ClientSession
    from tpuserve_torch.bench.loadgen import stream_generate

    with serving(TEXTGEN_CONFIG, n_buckets=3, overrides=TORN_SETS,
                 extra_toml=TORN_FAULTS) as port:
        c0 = stream_counters(port)
        url = f"http://127.0.0.1:{port}/v1/models/textgen:generate"

        async def go():
            async with ClientSession(limit=0) as session:
                return await asyncio.gather(*(stream_generate(
                    session, url, json.dumps(b).encode(),
                    {"Content-Type": "application/json"}, 300.0) for b in bodies))

        recs = asyncio.run(go())
        torn = [i for i, r in enumerate(recs) if r["torn"]]
        for i, r in enumerate(recs):
            check(r["status"] == 200 and (r["torn"] or r["terminal"] == "done"),
                  f"stream drill {i}: {r['status']} terminal {r['terminal']}")
            if not r["torn"]:
                check(r["text"] == unary[i]["text"], f"stream drill {i}: whole stream's text "
                      "differs from the unary text")
        deadline = time.monotonic() + 60.0
        while True:
            c1 = stream_counters(port)
            if c1["gen_active_slots"] == 0 and c1["gen_kv_pages_free"] == c1["gen_kv_pages_total"]:
                break
            check(time.monotonic() < deadline, f"stream drill: slots or pages not back: {c1}")
            time.sleep(0.05)
        injected = c1["injected"] - c0["injected"]
        # A tear can land after the engine already retired the stream's slot
        # (its done unit queued, not yet written): then no disconnect is
        # counted, as in the reference.
        disconnects = c1["disconnect"] - c0["disconnect"]
        check(injected == len(torn) > 0 and disconnects <= len(torn),
              f"stream drill: {injected:g} injected tears, {len(torn)} torn streams, "
              f"{disconnects:g} disconnects counted")
        out = {"streams": len(bodies), "torn": len(torn), "injected": injected,
               "disconnects": disconnects, "kv_pages_free": c1["gen_kv_pages_free"],
               "kv_pages_total": c1["gen_kv_pages_total"]}
        print(f"stream: stream_disconnect at {STREAM_TEAR_P}: {len(torn)} of {len(bodies)} "
              f"streams torn = {injected:g} injected, {disconnects:g} disconnects; then active "
              f"slots 0, KV pages free {c1['gen_kv_pages_free']:g} of "
              f"{c1['gen_kv_pages_total']:g}", flush=True)
    return out


def streaming_phase(card: str, unary_tokens_per_s: float) -> dict:
    """Phase 18: examples/textgen_flash.toml's generation streamed over SSE
    through ``python -m tpuserve_torch serve``."""
    t0 = time.perf_counter()
    out: dict = {"card": card, "config": str(TEXTGEN_CONFIG.relative_to(ROOT))}
    bodies = textgen_bodies()
    eos = textgen_model()[0].eos_id
    prestart(TEXTGEN_CONFIG, 3, TORN_SETS, TORN_FAULTS)  # boots beside the clean one
    with tempfile.TemporaryDirectory() as tmp_name:
        out.update(streaming_served(Path(tmp_name), bodies, eos))
    out["torn_drill"] = streaming_torn(bodies, out.pop("unary"))
    out["bench"]["unary_tokens_per_s_phase17"] = unary_tokens_per_s
    print(f"stream: tokens/s under bench --stream {out['bench']['summary']['tokens_per_s']} "
          f"beside phase 17's unary {unary_tokens_per_s:.0f}", flush=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 19: the Switch-MoE FFN ------------------------------------------------

def textgen_moe_served(bodies: list) -> dict:
    """examples/textgen_moe_flash.toml through ``python -m tpuserve_torch
    serve``: the seeded requests, K1 counted, no compile or capture."""
    with serving(TEXTGEN_MOE_CONFIG, n_buckets=3) as port:
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
        c0 = gen_counters(port)
        t0 = time.perf_counter()
        tokens = generate(port, bodies)
        wall_s = time.perf_counter() - t0
        k1 = json.loads(call(port, "GET", "/stats")[1])["kernels"]["flash_attention"]["launches"]
        c1 = gen_counters(port)
        d = {n: c1[n] - c0[n] for n in c0}
        check(d["gen_admitted_total"] == len(bodies) and k1 == TG_LAYERS * len(bodies),
              f"moe textgen: K1 launched {k1} times for {d['gen_admitted_total']:g} inserts")
        moved = {n: d[n] for n in ("runtime_compiles_total", "captures_total")}
        check(moved == {"runtime_compiles_total": 0, "captures_total": 0},
              f"moe textgen: serving moved {moved}")
        graphs = served_graphs(port)["textgen"]
        print(f"moe textgen: {len(bodies)} requests, {d['gen_units_total']:g} tokens in "
              f"{wall_s:.2f} s; inserts {d['gen_admitted_total']:g}, steps "
              f"{d['gen_iterations_total']:g}, K1 launches {k1}; compiles and captures moved "
              f"{moved}", flush=True)
    return {"tokens": tokens, "wall_s": wall_s, "k1_launches": k1, "deltas": d,
            "graphs_served": graphs}


def textgen_moe_in_process(bodies: list, served: list) -> dict:
    """The MoE engine in-process: program replays bit-identical to eager,
    tokens equal to the served ones and to the locked batch's (TG_MARGIN
    rule), step and insert timing; flash against dense, the engine against
    the dense locked batch in bf16 under the bf16 rule, the two locked
    batches in float32 under TG_MARGIN."""
    import torch

    from tpuserve_torch.runtime import build_runtime

    model, rt, eng = textgen_engine(config=TEXTGEN_MOE_CONFIG)
    items = [model.host_decode(json.dumps(b).encode(), "application/json") for b in bodies]
    out = {"captures_total": rt.captures_total, "capture_memory": dict(rt.capture_memory)}
    out["graphs"] = program_graphs_check(rt, items[2])
    mine = engine_tokens(eng, items, waves=2)
    check(mine == served, "moe textgen: the in-process engine's tokens differ from the served "
          "engine's")
    locked, margins, _ = locked_tokens(model, rt.module, items)
    out["engine_vs_locked"] = compare_tokens(served, locked, margins,
                                             "MoE engine vs MoE locked batch")
    out["timing"] = step_timing(rt, eng, items[2])
    del model, rt, eng
    torch.cuda.empty_cache()

    def locked(attention: str, dtype: str):
        model_l = textgen_model(attention, dtype, TEXTGEN_MOE_CONFIG)[0]
        rt_l = build_runtime(model_l, device="cuda", compile_forward=False)
        res = locked_tokens(model_l, rt_l.module, items)
        del model_l, rt_l
        torch.cuda.empty_cache()
        return res

    dense, _, dense_logit_margins = locked("dense", "bfloat16")
    out["flash_vs_dense_bf16"] = compare_tokens(served, dense, dense_logit_margins,
                                                "MoE flash engine vs MoE dense locked batch, "
                                                "bf16", bound=BF16_LOGIT_TOL)
    # Float32 (TF32 off): the flash locked batch against the dense one (the
    # engine's tokens equal the locked batch's, held above in bf16).
    flash32 = locked("flash", "float32")[0]
    dense32, margins32, _ = locked("dense", "float32")
    out["flash_vs_dense_f32"] = compare_tokens(flash32, dense32, margins32,
                                               "MoE flash locked batch vs MoE dense locked "
                                               "batch, float32")
    return out


def bert_moe_phase() -> dict:
    """examples/bert_moe_flash.toml served: phase 6's drive (K1 12 per
    batch), answers against in-process and dense attention, every bucket's
    replay against its eager forward, the (32, 128) replay's device time."""
    with serving(BERT_MOE_CONFIG, n_buckets=6) as port:
        run = drive(port)
        run["graphs_served"] = served_graphs(port)["bert"]
    run["flash_vs_dense"] = in_process_check(run.pop("answers"), BERT_MOE_CONFIG, moe=True)
    run["graphs"] = graph_phase(BERT_MOE_CONFIG, {"bert": (32, 128)},
                                lambda logits: LOGIT_TOL, share=True)
    check(all(r["bit_identical"] for r in run["graphs"]["bert"]["buckets"].values()),
          "moe bert: a bucket's replay is not bit-identical to its eager forward")
    return run


def moe_phase(card: str) -> dict:
    """Phase 19: the Switch-MoE FFN, served on textgen and on BERT-flash."""
    import torch

    t0 = time.perf_counter()
    out: dict = {"card": card, "configs": [str(c.relative_to(ROOT)) for c in
                                           (TEXTGEN_MOE_CONFIG, BERT_MOE_CONFIG)]}
    bodies = textgen_bodies()
    prestart(BERT_MOE_CONFIG, 6)  # boots beside the MoE textgen server
    out["textgen"] = textgen_moe_served(bodies)
    out["textgen"]["in_process"] = textgen_moe_in_process(bodies, out["textgen"].pop("tokens"))
    out["bert"] = bert_moe_phase()
    HOST_PARAMS.clear()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 20: SD 1.5 txt2img -----------------------------------------------------

SD_CONFIG = ROOT / "examples" / "sd15_flash.toml"
SD_STEPS = 20
SD_EDGE = 512
SD_K1_PER_UNET = 10            # down0/1_attn0/1 and up0/1_attn0/1/2
# The engine variant: examples/genserve.toml's buckets and slots, previews
# every 5 steps.
SD_ENGINE_SETS = ("genserve.enabled=true", "genserve.slots=8",
                  "model.sd15.batch_buckets=[1, 4]", "model.sd15.options.preview_every=5")
# One bf16 UNet call, flash against dense spatial self-attention: the max
# abs difference of eps may be at most this share of the dense eps's max
# abs. The dense path rounds its scores to bf16 before the softmax (the
# reference's flax attention does), K1 keeps them in float32: about 2e-2 of
# the scale is expected; the bound leaves 2.5x that.
SD_EPS_REL = 5e-2
SD_BODY = {"prompt": "a lighthouse on a cliff at dusk, oil painting", "seed": 1234}
# Phase 20's seconds before it imported a checkpoint: the phase alone on
# the tree before the import, four runs on three NVIDIA H100 80GB HBM3
# machines at 700 W (PERF.md section 6; the machine moves it by ~40 %).
SD_PHASE_S_PARENT = (73.0, 116.1)


# CLIP's vocabulary: 256 byte symbols, the same with "</w>", 48,894 merges,
# then <|startoftext|> and <|endoftext|>.
CLIP_MERGES = 48894
CLIP_VOCAB = 2 * 256 + CLIP_MERGES + 2


def clip_bpe_files(tmp: Path, seed: int = 17) -> tuple[Path, Path]:
    """Write a seeded CLIP-shaped byte-level BPE to ``tmp``: ``vocab.json``
    of CLIP_VOCAB (49,408) entries — the 256 byte symbols in
    ``bytes_to_unicode`` order, the same 256 ending in ``</w>``, one token
    per merge, ``<|startoftext|>`` 49406 and ``<|endoftext|>`` 49407 — and
    ``merges.txt`` (a ``#version`` line, then CLIP_MERGES merges). Each merge
    joins two tokens that exist before it (the first without ``</w>``) into
    a new one; nine in ten draw both parts from tokens of lower-case ASCII
    letters, older (shorter) ones more often, so words merge in several
    steps, the rest from any token
    (digits, punctuation, the bytes of accents, CJK and emoji). Returns
    (vocab, merges)."""
    import numpy as np

    from tpuserve_torch.text import bytes_to_unicode

    rng = np.random.default_rng(seed)
    syms = list(bytes_to_unicode().values())
    toks = syms + [c + "</w>" for c in syms]
    seen = set(toks)

    def lower_ascii(t: str) -> bool:
        return all("a" <= c <= "z" for c in t.removesuffix("</w>"))

    heads = [t for t in toks if not t.endswith("</w>")]
    letters = [t for t in toks if lower_ascii(t)]
    letter_heads = [t for t in heads if lower_ascii(t)]
    merges = []
    while len(merges) < CLIP_MERGES:
        if rng.random() < 0.9:
            # Older (shorter) tokens first: u**2 favours the list's head.
            a = letter_heads[int(len(letter_heads) * rng.random() ** 2)]
            b = letters[int(len(letters) * rng.random() ** 2)]
        else:
            a = heads[int(rng.integers(len(heads)))]
            b = toks[int(rng.integers(len(toks)))]
        t = a + b
        if t in seen:
            continue
        seen.add(t)
        toks.append(t)
        merges.append(f"{a} {b}")
        if not t.endswith("</w>"):
            heads.append(t)
        if lower_ascii(t):
            letters.append(t)
            if not t.endswith("</w>"):
                letter_heads.append(t)
    toks += ["<|startoftext|>", "<|endoftext|>"]
    vocab, merges_txt = tmp / "vocab.json", tmp / "merges.txt"
    vocab.write_text(json.dumps({t: i for i, t in enumerate(toks)}, ensure_ascii=False),
                     encoding="utf-8")
    merges_txt.write_text("#version: 0.2\n" + "\n".join(merges) + "\n", encoding="utf-8")
    return vocab, merges_txt


def ldm_state_dict(tree: dict, model) -> dict:
    """The reference's SD tree (``to_jax_params``) written back in the
    published single-file LDM layout: ``tpuserve_torch/models/sd15_import.py``
    inverted, mapper for mapper, with the same derived block numbering.
    Kernels HWIO -> OIHW and (in, out) -> (out, in), attention kernels
    (d, heads, hd) / (heads, hd, d) -> (heads*hd, d) / (d, heads*hd), the
    GEGLU halves swapped back, the VAE's Dense attention as 1x1 convs, norm
    ``scale`` -> ``weight``. The UNet attention's q/k/v biases have no LDM
    tensor: they must be zero (the seeded init's), or the import would not
    give the tree back. Values are numpy views of ``tree``."""
    import numpy as np

    out: dict = {}

    def conv(p: dict, dst: str) -> None:
        out[f"{dst}.weight"] = p["kernel"].transpose(3, 2, 0, 1)
        out[f"{dst}.bias"] = p["bias"]

    def lin(p: dict, dst: str) -> None:
        out[f"{dst}.weight"] = p["kernel"].T
        out[f"{dst}.bias"] = p["bias"]

    def norm(p: dict, dst: str) -> None:
        out[f"{dst}.weight"] = p["scale"]
        out[f"{dst}.bias"] = p["bias"]

    def mha(p: dict, q: str, k: str, v: str, o: str, qkv_bias: bool) -> None:
        for name, dst in (("query", q), ("key", k), ("value", v)):
            kern = p[name]["kernel"]
            out[f"{dst}.weight"] = kern.reshape(kern.shape[0], -1).T
            if qkv_bias:
                out[f"{dst}.bias"] = p[name]["bias"].reshape(-1)
            else:
                check(not p[name]["bias"].any(), f"LDM write: {dst} has a non-zero bias")
        kern = p["out"]["kernel"]
        out[f"{o}.weight"] = kern.reshape(-1, kern.shape[-1]).T
        out[f"{o}.bias"] = p["out"]["bias"]

    def unet_res(p: dict, dst: str) -> None:
        norm(p["norm1"], f"{dst}.in_layers.0")
        conv(p["conv1"], f"{dst}.in_layers.2")
        lin(p["temb_proj"], f"{dst}.emb_layers.1")
        norm(p["norm2"], f"{dst}.out_layers.0")
        conv(p["conv2"], f"{dst}.out_layers.3")
        if "skip" in p:
            conv(p["skip"], f"{dst}.skip_connection")

    def spatial(p: dict, dst: str) -> None:
        tb, b = f"{dst}.transformer_blocks.0", p["block"]
        norm(p["norm"], f"{dst}.norm")
        conv(p["proj_in"], f"{dst}.proj_in")
        norm(b["ln1"], f"{tb}.norm1")
        mha(b["self_attn"], f"{tb}.attn1.to_q", f"{tb}.attn1.to_k", f"{tb}.attn1.to_v",
            f"{tb}.attn1.to_out.0", qkv_bias=False)
        norm(b["ln2"], f"{tb}.norm2")
        mha(b["cross_attn"], f"{tb}.attn2.to_q", f"{tb}.attn2.to_k", f"{tb}.attn2.to_v",
            f"{tb}.attn2.to_out.0", qkv_bias=False)
        norm(b["ln3"], f"{tb}.norm3")
        w, bias = b["ff_up"]["kernel"].T, b["ff_up"]["bias"]      # gate half first
        inner = w.shape[0] // 2
        out[f"{tb}.ff.net.0.proj.weight"] = np.concatenate([w[inner:], w[:inner]])
        out[f"{tb}.ff.net.0.proj.bias"] = np.concatenate([bias[inner:], bias[:inner]])
        lin(b["ff_down"], f"{tb}.ff.net.2")
        conv(p["proj_out"], f"{dst}.proj_out")

    t = tree["text"]["params"]
    pre = "cond_stage_model.transformer.text_model."
    out[f"{pre}embeddings.token_embedding.weight"] = t["token_embed"]["embedding"]
    out[f"{pre}embeddings.position_embedding.weight"] = t["pos_embed"]
    norm(t["ln_final"], f"{pre}final_layer_norm")
    for i in range(model.text_layers):
        lp, q = f"{pre}encoder.layers.{i}.", t[f"layer{i}"]
        norm(q["ln1"], f"{lp}layer_norm1")
        mha(q["attn"], f"{lp}self_attn.q_proj", f"{lp}self_attn.k_proj",
            f"{lp}self_attn.v_proj", f"{lp}self_attn.out_proj", qkv_bias=True)
        norm(q["ln2"], f"{lp}layer_norm2")
        lin(q["mlp_up"], f"{lp}mlp.fc1")
        lin(q["mlp_down"], f"{lp}mlp.fc2")

    u, pre = tree["unet"]["params"], "model.diffusion_model."
    mults, levels = tuple(model.unet_mults), tuple(model.unet_attn_levels)
    lin(u["time1"], f"{pre}time_embed.0")
    lin(u["time2"], f"{pre}time_embed.2")
    conv(u["conv_in"], f"{pre}input_blocks.0.0")
    norm(u["norm_out"], f"{pre}out.0")
    conv(u["conv_out"], f"{pre}out.2")
    k = 1
    for i in range(len(mults)):
        for j in range(model.unet_res):
            unet_res(u[f"down{i}_res{j}"], f"{pre}input_blocks.{k}.0")
            if i in levels:
                spatial(u[f"down{i}_attn{j}"], f"{pre}input_blocks.{k}.1")
            k += 1
        if i != len(mults) - 1:
            conv(u[f"down{i}_ds"], f"{pre}input_blocks.{k}.0.op")
            k += 1
    unet_res(u["mid_res1"], f"{pre}middle_block.0")
    spatial(u["mid_attn"], f"{pre}middle_block.1")
    unet_res(u["mid_res2"], f"{pre}middle_block.2")
    k = 0
    for i in reversed(range(len(mults))):
        for j in range(model.unet_res + 1):
            unet_res(u[f"up{i}_res{j}"], f"{pre}output_blocks.{k}.0")
            idx = 1
            if i in levels:
                spatial(u[f"up{i}_attn{j}"], f"{pre}output_blocks.{k}.1")
                idx = 2
            if i != 0 and j == model.unet_res:
                conv(u[f"up{i}_us"], f"{pre}output_blocks.{k}.{idx}.conv")
            k += 1

    v, pre = tree["vae"]["params"], "first_stage_model."
    d = f"{pre}decoder."

    def vae_res(p: dict, dst: str) -> None:
        norm(p["norm1"], f"{dst}.norm1")
        conv(p["conv1"], f"{dst}.conv1")
        norm(p["norm2"], f"{dst}.norm2")
        conv(p["conv2"], f"{dst}.conv2")
        if "skip" in p:
            conv(p["skip"], f"{dst}.nin_shortcut")

    conv(v["post_quant"], f"{pre}post_quant_conv")
    conv(v["conv_in"], f"{d}conv_in")
    vae_res(v["mid_res1"], f"{d}mid.block_1")
    norm(v["mid_attn"]["norm"], f"{d}mid.attn_1.norm")
    for name, dst in (("q", "q"), ("k", "k"), ("v", "v"), ("proj", "proj_out")):
        a = v["mid_attn"][name]
        out[f"{d}mid.attn_1.{dst}.weight"] = a["kernel"].T[:, :, None, None]
        out[f"{d}mid.attn_1.{dst}.bias"] = a["bias"]
    vae_res(v["mid_res2"], f"{d}mid.block_2")
    norm(v["norm_out"], f"{d}norm_out")
    conv(v["conv_out"], f"{d}conv_out")
    for i in reversed(range(len(model.vae_mults))):
        for j in range(3):
            vae_res(v[f"up{i}_res{j}"], f"{d}up.{i}.block.{j}")
        if i != 0:
            conv(v[f"up{i}_us"], f"{d}up.{i}.upsample.conv")
    return out


def write_safetensors(path: Path, tensors: dict) -> int:
    """``tensors`` ({name: float32 numpy array}) as a ``.safetensors`` file:
    an 8-byte little-endian header length, the JSON header (``dtype``,
    ``shape``, ``data_offsets``), the bytes in header order. Each tensor is
    made contiguous just ahead of its write, by a pool of threads (numpy
    copies outside the GIL) at most 16 tensors ahead of the file. Returns
    the file's size."""
    import collections
    import concurrent.futures as cf
    import struct

    import numpy as np

    header, offset = {}, 0
    for name, a in tensors.items():
        check(a.dtype == np.float32, f"LDM write: {name} is {a.dtype}, not float32")
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f, cf.ThreadPoolExecutor(8) as pool:
        f.write(struct.pack("<Q", len(head)) + head)
        ahead: collections.deque = collections.deque()
        for a in tensors.values():
            ahead.append(pool.submit(np.ascontiguousarray, a))
            if len(ahead) > 16:
                f.write(memoryview(ahead.popleft().result()).cast("B"))
        while ahead:
            f.write(memoryview(ahead.popleft().result()).cast("B"))
    return path.stat().st_size


def sd_bodies() -> list[dict]:
    """Eight :generate bodies: ``SD_BODY`` (the locked path's), then prompts
    of 1 to 60 words, one with a negative prompt."""
    import numpy as np

    rng = np.random.default_rng(20)
    out = [dict(SD_BODY)]
    for i, n in enumerate((1, 3, 7, 12, 20, 47, 60)):
        body = {"prompt": " ".join(rng.choice(WORDS, n)), "seed": int(rng.integers(0, 2**31 - 1))}
        if i == 3:
            body["negative_prompt"] = "blurry low quality"
        out.append(body)
    return out


def read_png(data: bytes):
    """An 8-bit RGB PNG of filter-0 scanlines (what the port writes) ->
    (H, W, 3) uint8, its chunks' CRCs checked."""
    import struct
    import zlib

    import numpy as np

    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"not a PNG: {data[:16]!r}")
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        check(crc == zlib.crc32(kind + body) & 0xFFFFFFFF, f"PNG chunk {kind!r}: bad CRC")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    check((depth, ctype) == (8, 2), f"PNG depth {depth}, color type {ctype}: expected 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "PNG rows use a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def sd_bound(b: int, s: int, d: int, bias: bool, heads: int = 8) -> tuple[float, str, dict]:
    """The least time for attention over (b, s, heads, d) bf16 q/k/v: q,
    k, v and o moved once (and a float32 (b, s) bias), q.k^T and p.v at d."""
    nbytes = 4 * b * s * heads * d * 2 + (b * s * 4 if bias else 0)
    flops = 4 * b * heads * s * s * d
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "operations": flops})


def sd_k1_row(b: int, s: int, d: int, heads: int = 8) -> dict:
    """K1 at an SD shape: (b, s, heads, d) bf16 q/k/v padded to the next
    multiple of 64 in the head dim (zero lanes) and q pre-scaled, as the
    UNet hands them over (b = 2 on the locked path, 2 x 8 slots in the
    engine's step; 8 heads, 4 on a model rank at tp = 2), against its
    plain version in float32 (phase 3's bf16
    tolerance, its atol a share of the output's scale), K1's TMA layout
    rule on the padded tensors; timed with its plain version (two rows at a
    time), its bound at the padded dim and at d, and SDPA on the UNPADDED
    heads."""
    import torch

    from tpuserve_torch.models import sd15
    from tpuserve_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(b + s + d)
    q, k, v = (torch.randn(b, s, heads, d, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    qp, kp, vp = (sd15.pad_head_dim(t) for t in (q, k, v))
    dp = qp.shape[-1]
    qp = qp * sd15._rounded((dp / d) ** 0.5, torch.bfloat16)
    check(fa.tma_layout_problem(qp, kp, vp) is None,
          f"sd15: padded ({b}, {s}, {heads}, {dp}) tensors break K1's TMA rule: "
          f"{fa.tma_layout_problem(qp, kp, vp)}")
    bias = torch.zeros(b, s, device="cuda")
    max_err = compare(qp, kp, vp, bias, scaled=True, rows=2)
    # The UNet's call (no bias argument: K1 gets zeros) equals the check's.
    out = sd15.flash_unet_attention(q, k, v)
    check(torch.equal(out, fa.flash_attention(qp, kp, vp, bias)[..., :d]),
          "sd15: flash_unet_attention differs from K1 on the padded tensors")
    ms = time_ms(lambda: fa.flash_attention(qp, kp, vp, bias))
    # Few calls: at 16 rows each call is ~80 launches, and time_calls must
    # enqueue them all inside the launch queue while the card is held.
    plain_ms = time_ms(lambda: plain_k1(qp, kp, vp, bias, rows=2), iters=max(2, 20 // b))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
    bound, bound_by, bound_inputs = sd_bound(b, s, dp, bias=True, heads=heads)
    bound_d, bound_by_d, _ = sd_bound(b, s, d, bias=False, heads=heads)
    line = {"name": "flash_attention", "route": "cuda",
            "source": "tpuserve_torch/ops/csrc/flash_attention.cu",
            "replaces": "tpuserve/ops/flash_attention.py:96", "shape": [b, s, heads, dp],
            "from_head_dim": d, "max_abs_err": max_err,
            "tolerance": "atol 1.6e-2 x max|plain|, rtol 1.6e-2", "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": f"SDPA on the unpadded ({b}, {heads}, {s}, {d}) heads",
            "bound_ms": bound, "bound_by": bound_by,
            "bound_ms_unpadded": bound_d, "bound_by_unpadded": bound_by_d}
    print(f"sd15: K1 at ({b}, {s}, {heads}, {dp} <- {d}) bf16 agrees with its plain version (max abs "
          f"err {max_err:.3g}); {ms * 1e3:.2f} us against a {bound * 1e3:.2f} us {bound_by} "
          f"bound ({bound_d * 1e3:.2f} us at d = {d}), plain {plain_ms * 1e3:.1f} us, SDPA "
          f"unpadded {library_ms * 1e3:.2f} us", flush=True)
    return {"line": line, "bound_inputs": bound_inputs}


def sd_counters(port: int) -> dict:
    text = call(port, "GET", "/metrics")[1].decode()
    names = ("gen_iterations_total", "gen_admitted_total", "batches_total", "items_total",
             "runtime_compiles_total", "gen_streams_total")
    out = {n: metric(text, f'{n}{{model="sd15"}}') for n in names}
    inv = json.loads(call(port, "GET", "/v1/models")[1])["sd15"]
    out["captures_total"] = inv["captures_total"]
    k1 = json.loads(call(port, "GET", "/stats")[1])["kernels"]["flash_attention"]
    out["k1"] = k1["launches"]
    out["k1_by_shape"] = k1["by_shape"]
    return out


def sd_shape_key(b: int, s: int) -> str:
    """/stats' key for K1 at an SD level's padded shape."""
    return f"{b}x{s}x8x{64 if s == 4096 else 128}"


def sd_shape_launches(c0: dict, c1: dict) -> dict:
    """K1's launches by shape between two ``sd_counters`` readings."""
    return {s: n - c0["k1_by_shape"].get(s, 0) for s, n in c1["k1_by_shape"].items()
            if n != c0["k1_by_shape"].get(s, 0)}


def sd_generate(port: int, body: dict, stream: bool = False) -> tuple[int, bytes, dict]:
    path = "/v1/models/sd15:generate" + ("?stream=true" if stream else "")
    return call_h(port, "POST", path, body)


SD_IMPORT_LOG = re.compile(r"imported torch checkpoint \S+ \((\d+) tensors\): read "
                           r"([0-9.]+) s, mapping ([0-9.]+) s")


def sd_import_times(log_path: Path) -> list[dict]:
    """The server's import lines (``ServingModel.load_tree``): per import,
    the tensors, the read (header and memory map) and the mapping onto the
    tree, in seconds."""
    return [{"tensors": int(m[1]), "read_s": float(m[2]), "mapping_s": float(m[3])}
            for m in SD_IMPORT_LOG.finditer(log_path.read_text(errors="replace"))]


def sd_locked_served(ckpt: dict) -> dict:
    """examples/sd15_flash.toml served from the seeded tree's LDM
    ``.safetensors`` with the CLIP-shaped BPE: one image, the same again
    (same bytes), a 400 without a prompt; K1 200 launches per image, 100 at
    each level's shape; compiles and captures unchanged after startup; a
    ``:reload`` (the file imported again), then the same bytes again; one
    import at boot and one at the reload, their read and mapping times."""
    out: dict = {}
    sets = ckpt["sets"] + (f"model.sd15.weights={json.dumps(str(ckpt['path']))}",)
    with serving(SD_CONFIG, n_buckets=1, overrides=sets, with_log=True) as (port, log_path):
        boot_imports = sd_import_times(log_path)
        check(len(boot_imports) == 1 and boot_imports[0]["tensors"] == ckpt["tensors"],
              f"sd15 locked: the server's boot logged imports {boot_imports}, expected one "
              f"of {ckpt['tensors']} tensors")
        g = served_graphs(port)["sd15"]
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
        c0 = sd_counters(port)
        walls, pngs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            st, png, hdrs = sd_generate(port, SD_BODY)
            walls.append((time.perf_counter() - t0) * 1e3)
            check(st == 200 and hdrs.get("Content-Type") == "image/png",
                  f"sd15 locked: {st} {hdrs.get('Content-Type')} {png[:200]!r}")
            pngs.append(png)
        img = read_png(pngs[0])
        check(img.shape == (SD_EDGE, SD_EDGE, 3),
              f"sd15 locked: PNG of {img.shape}, expected {SD_EDGE} px")
        check(pngs[1] == pngs[0], "sd15 locked: the same (prompt, seed) gave other PNG bytes")
        st, body = call(port, "POST", "/v1/models/sd15:generate", {"seed": 1})
        check(st == 400, f"sd15 locked: a body without a prompt answered {st}, expected 400")
        c1 = sd_counters(port)
        d = {n: c1[n] - c0[n] for n in c0 if n != "k1_by_shape"}
        by_shape = sd_shape_launches(c0, c1)
        per_level = 2 * SD_STEPS * (SD_K1_PER_UNET // 2)     # 2 images, 5 per UNet call
        check(d["batches_total"] == 2 and d["k1"] == 2 * SD_STEPS * SD_K1_PER_UNET
              and by_shape == {sd_shape_key(2, s): per_level for s in (4096, 1024)},
              f"sd15 locked: K1 launched {d['k1']} times {by_shape} for "
              f"{d['batches_total']:g} batches ({SD_STEPS * SD_K1_PER_UNET} per image, half "
              f"at each level)")
        check(d["runtime_compiles_total"] == 0 and d["captures_total"] == 0,
              f"sd15 locked: compiles / captures moved {d['runtime_compiles_total']:g} / "
              f"{d['captures_total']} after startup")
        # A :reload imports the file again and stages a slot (beside the
        # three live slots) behind a staged canary; the same request then
        # gives the same bytes.
        t0 = time.perf_counter()
        st, body = call(port, "POST", "/admin/models/sd15:reload")
        reload_s = time.perf_counter() - t0
        check(st == 200, f"sd15 locked: :reload answered {st} {body[:300]!r}")
        st, png, _ = sd_generate(port, SD_BODY)
        check(st == 200 and png == pngs[0], "sd15 locked: after :reload the same request gave "
              f"{st} and {'other' if st == 200 else 'no'} PNG bytes")
        c2 = sd_counters(port)
        check(c2["captures_total"] == c0["captures_total"]
              and c2["runtime_compiles_total"] == c0["runtime_compiles_total"],
              "sd15 locked: :reload moved compiles or captures")
        imports = sd_import_times(log_path)
        check(len(imports) == 2, f"sd15 locked: {len(imports)} imports logged after the "
              ":reload, expected 2 (boot, reload)")
        out.update(png=pngs[0], walls_ms=walls, k1_launches=d["k1"], k1_by_shape=by_shape,
                   deltas=d, graphs_served=g, image_std=float(img.std()), reload_s=reload_s,
                   import_boot=imports[0], import_reload=imports[1])
        print(f"sd15 locked: 2 images of {SD_EDGE} px from the imported checkpoint, walls "
              f"{walls[0]:.1f} / {walls[1]:.1f} ms, byte-identical PNGs; K1 {d['k1']} launches "
              f"{by_shape}; compiles and captures moved 0; 400 without a prompt; import at "
              f"boot: read {imports[0]['read_s']:.3f} s, mapping {imports[0]['mapping_s']:.3f} "
              f"s; :reload in {reload_s:.1f} s (read {imports[1]['read_s']:.3f} s, mapping "
              f"{imports[1]['mapping_s']:.3f} s), same bytes after", flush=True)
    return out


def sd_model(sets: tuple = ()):
    from tpuserve_torch.config import load_config
    from tpuserve_torch.models import build

    return build(load_config(str(SD_CONFIG), list(sets)).models[0])


def sd_seeded_tree(tmp: Path) -> dict:
    """Phase 20's BPE and seeded tree: the CLIP-shaped BPE written into
    ``tmp`` (``clip_bpe_files``), and the seeded tree of
    ``examples/sd15_flash.toml`` with that BPE, drawn on the card as a
    server without weights draws it and read back to the host. Returns the
    tree, the model, the ``--set`` flags that name the BPE, and the times."""
    import torch

    t0 = time.perf_counter()
    vocab, merges = clip_bpe_files(tmp)
    sets = (f"model.sd15.options.bpe_vocab={json.dumps(str(vocab))}",
            f"model.sd15.options.bpe_merges={json.dumps(str(merges))}")
    t1 = time.perf_counter()
    model = sd_model(sets)
    check(model.vocab_size == CLIP_VOCAB, f"sd15: the BPE gives a vocabulary of "
          f"{model.vocab_size}, expected {CLIP_VOCAB}")
    tree = model.to_jax_params(model.init_params(0, "cuda"))
    torch.cuda.empty_cache()  # the float32 draws go back to the card
    return {"tree": tree, "model": model, "sets": sets, "bpe_s": t1 - t0,
            "tree_s": time.perf_counter() - t1}


def sd_checkpoint(seeded: dict, tmp: Path) -> dict:
    """The seeded tree written into ``tmp`` in the published LDM layout as a
    float32 ``.safetensors`` with the smoke's own code (the card's machine
    has neither ``safetensors`` nor ``transformers``): ``ldm_state_dict``,
    the importer's inverse, then ``write_safetensors``. Host work only: it
    runs beside K1's timings. Returns the file, its size and tensors, the
    BPE's ``--set`` flags, and the times."""
    t0 = time.perf_counter()
    path = tmp / "sd15-seeded-ldm.safetensors"
    tensors = ldm_state_dict(seeded["tree"], seeded["model"])
    size = write_safetensors(path, tensors)
    out = {"path": path, "sets": seeded["sets"], "bytes": size, "tensors": len(tensors),
           "bpe_s": seeded["bpe_s"], "tree_s": seeded["tree_s"],
           "write_s": time.perf_counter() - t0}
    print(f"sd15: wrote the CLIP-shaped BPE ({CLIP_VOCAB} entries) in {out['bpe_s']:.1f} s and "
          f"the seeded tree in LDM layout, {size:,} bytes in {len(tensors)} float32 tensors, "
          f"in {out['write_s']:.1f} s (the tree drawn and read back in {out['tree_s']:.1f} s)",
          flush=True)
    return out


def sd_in_process(served_png: bytes, sets: tuple) -> dict:
    """The same model on its seeded tree in this process (with the BPE
    ``sets``): the runtime's locked graph against the eager forward and the
    served PNG — which the locked server made from the imported checkpoint
    —, finite latents, the replay's device time; one UNet call flash against
    dense; the engine's programs registered on the same runtime, timed."""
    import numpy as np
    import torch

    from tpuserve_torch.config import load_config
    from tpuserve_torch.genserve import GenEngine
    from tpuserve_torch.models import sd15
    from tpuserve_torch.obs import Metrics
    from tpuserve_torch.ops import flash_attention as fa
    from tpuserve_torch.runtime import build_runtime

    out: dict = {}
    model = sd_model(sets)
    t0 = time.perf_counter()
    rt = build_runtime(model, device="cuda")
    out["startup_s"] = time.perf_counter() - t0
    item = model.host_decode(json.dumps(SD_BODY).encode(), "application/json")
    host = model.assemble([item], (1,))
    dev = rt.h2d((1,), host)
    replay = rt.fetch(rt.dispatch((1,), dev))["image"]
    lats = []
    decode = model._decode
    model._decode = lambda module, lat: lats.append(lat) or decode(module, lat)
    try:
        with torch.inference_mode():
            eager = model.forward(rt.module, dev)["image"].cpu().numpy()
    finally:
        model._decode = decode
    served = read_png(served_png)
    check(np.array_equal(replay[0], served), "sd15: the PNG served from the imported "
          "checkpoint differs from the in-process graph replay on the seeded tree")
    check(np.array_equal(eager, replay), "sd15: the locked graph's replay differs from the "
          f"eager forward (max diff {np.abs(eager.astype(int) - replay.astype(int)).max()})")
    lat = lats[0]
    check(bool(torch.isfinite(lat).all()), "sd15: non-finite latents after the loop")
    noise = model.latents(torch.tensor([SD_BODY["seed"]], dtype=torch.int32, device="cuda"))
    check(bool(torch.isfinite(noise).all()), "sd15: non-finite initial latents")
    out["latents"] = {"initial_std": float(noise.std()), "final_std": float(lat.std()),
                      "finite": True}
    # The locked request's device time: the runtime's graph replayed.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        start.record()
        rt.dispatch((1,), dev)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    out["locked_replay_device_ms"] = sorted(times)[1]
    print(f"sd15: served PNG == in-process replay == eager forward; latents finite (std "
          f"{out['latents']['initial_std']:.3f} -> {out['latents']['final_std']:.3f}); locked "
          f"image replay {out['locked_replay_device_ms']:.1f} ms of device time", flush=True)
    # UNet flash against dense, one call on the same module.
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 64, 64, 4, generator=g, device="cuda")
    t = torch.tensor([500, 500], dtype=torch.int32, device="cuda")
    ctx = torch.randn(2, 77, 768, generator=g, device="cuda").to(torch.bfloat16)
    blocks = [m for m in rt.module.modules() if isinstance(m, sd15.TransformerBlock)]
    with torch.inference_mode():
        k0 = fa.launches
        flash = rt.module.unet(x, t, ctx)
        k1_per_call = fa.launches - k0
        for b in blocks:
            b.flash = False
        try:
            dense = rt.module.unet(x, t, ctx)
        finally:
            for b in blocks:
                b.flash = True
    diff = float((flash - dense).abs().max())
    scale = float(dense.abs().max())
    check(k1_per_call == SD_K1_PER_UNET, f"sd15: one UNet call launched K1 {k1_per_call} times")
    check(diff <= SD_EPS_REL * scale, f"sd15: flash vs dense eps differ by {diff:.4g}, over "
          f"{SD_EPS_REL} of their scale {scale:.4g}")
    out["unet_flash_vs_dense"] = {"max_abs_diff": diff, "dense_max_abs": scale,
                                  "share_of_scale": diff / scale, "bound_share": SD_EPS_REL,
                                  "k1_launches_per_call": k1_per_call}
    print(f"sd15: one bf16 UNet call, flash vs dense: max abs diff {diff:.4g} = "
          f"{diff / scale:.4f} of the eps scale {scale:.4g} (bound {SD_EPS_REL}); K1 "
          f"{k1_per_call} launches per call", flush=True)
    # Where a 2-row UNet call's device time goes.
    with torch.inference_mode():
        out["unet_2rows_device_ms"] = graph_ms(lambda: rt.module.unet(x, t, ctx),
                                               replays=5, rounds=3)
        out["unet_2rows_by_kind"] = device_breakdown(lambda: rt.module.unet(x, t, ctx),
                                                     iters=3)
    print(f"sd15: one 2-row UNet call {out['unet_2rows_device_ms']:.2f} ms of device time; "
          f"by kind { {k: round(v, 3) for k, v in out['unet_2rows_by_kind']['ms_by_kind'].items()} }"
          f", {out['unet_2rows_by_kind']['kernels_per_call']:.0f} kernels", flush=True)
    # The engine's programs on the same runtime: insert, step, extract.
    eng = GenEngine(model, rt, Metrics(),
                    load_config(str(SD_CONFIG), list(SD_ENGINE_SETS + sets)).genserve)
    t0 = time.perf_counter()
    eng.compile()
    out["engine_compile_s"] = time.perf_counter() - t0
    out["engine"] = sd_engine_timing(rt, eng, item)
    out["capture_memory"] = dict(rt.capture_memory)
    del eng, rt
    torch.cuda.empty_cache()
    return out


def sd_engine_timing(rt, eng, item, label: str = "sd15 engine") -> dict:
    """Device times (CUDA events) of the insert (CLIP + the latent draw), of
    the step at 1 and 8 active slots, and of the extract (VAE decode)."""
    import numpy as np
    import torch

    from tpuserve_torch.runtime import LIVE_BLOCK

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn) -> float:
        torch.cuda.synchronize()
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1])

    out: dict = {}
    for n in (1, 8):
        rt.zero_state(LIVE_BLOCK)
        inserts = [timed(lambda s=s: rt.run_program("insert", np.array([s]), item,
                                                     block=LIVE_BLOCK)) for s in range(n)]
        steps = [timed(lambda: rt.run_program("step", block=LIVE_BLOCK)) for _ in range(6)]
        out[n] = {"insert_device_ms": sorted(inserts)[len(inserts) // 2],
                  "step_device_ms": sorted(steps)[3]}
    extracts = [timed(lambda: rt.run_program("extract", np.array([0]), block=LIVE_BLOCK))
                for _ in range(5)]
    out["extract_device_ms"] = sorted(extracts)[2]
    rt.zero_state(LIVE_BLOCK)
    print(f"{label}: insert (CLIP) {out[1]['insert_device_ms']:.2f} ms, step at 1 / 8 "
          f"active slots {out[1]['step_device_ms']:.1f} / {out[8]['step_device_ms']:.1f} ms, "
          f"extract (VAE) {out['extract_device_ms']:.1f} ms of device time", flush=True)
    return out


def sd_stream(port: int, body: dict) -> dict:
    """One ``?stream=true`` request read to its end: the frames by kind."""
    import numpy as np

    from tpuserve_torch import frame

    st, raw, hdrs = sd_generate(port, body, stream=True)
    check(st == 200 and hdrs.get("Content-Type") == frame.CONTENT_TYPE,
          f"sd15 stream: {st} {hdrs.get('Content-Type')} {raw[:200]!r}")
    reader = frame.StreamFrameReader()
    frames = reader.feed(raw)
    check(reader.pending == 0, f"sd15 stream: {reader.pending} bytes of a torn frame")
    events = [json.loads(p) for k, p in frames if k == frame.KIND_EVENT]
    images = [frame.parse_frame(p, kind=frame.KIND_RGB8, edge=SD_EDGE, max_items=1)[0]
              for k, p in frames if k == frame.KIND_RGB8]
    progress = [e["step"] for e in events if e["type"] == "progress"]
    terminals = [e for e in events if e["type"] in ("done", "error")]
    check(len(terminals) == 1 and terminals[0]["type"] == "done"
          and json.loads(frames[-1][1]) == terminals[0],
          f"sd15 stream: terminals {terminals} (exactly one done, last)")
    check(progress == list(range(1, SD_STEPS + 1)),
          f"sd15 stream: progress events {progress}, expected 1..{SD_STEPS}")
    # Previews after steps 5, 10 and 15; the final image right before done.
    check(len(images) == 4 and frames[-2][0] == frame.KIND_RGB8,
          f"sd15 stream: {len(images)} image frames (3 previews + the final image expected)")
    return {"final": np.array(images[-1]), "previews": len(images) - 1,
            "progress_events": len(progress), "frames": len(frames)}


def sd_concurrent(port: int, bodies: list, stream_body: dict | None = None) -> tuple:
    """Every body at once from its own thread (and one streamed request):
    the answers in body order, the stream's frames, the wall time."""
    import threading

    answers: list = [None] * len(bodies)
    stream: dict = {}

    def one(i: int) -> None:
        answers[i] = sd_generate(port, bodies[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    if stream_body is not None:
        threads.append(threading.Thread(target=lambda: stream.update(sd_stream(port, stream_body))))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall_s = time.perf_counter() - t0
    for i, a in enumerate(answers):
        check(a is not None and a[0] == 200 and a[2].get("Content-Type") == "image/png",
              f"sd15 engine request {i}: {a and a[0]} {a and a[1][:200]!r}")
        check(read_png(a[1]).shape == (SD_EDGE, SD_EDGE, 3),
              f"sd15 engine request {i}: not {SD_EDGE} px")
    check(stream_body is None or "final" in stream, "sd15 engine: the stream did not finish")
    return [a[1] for a in answers], stream, wall_s


def sd_engine_served(bodies: list, locked_png: bytes, sets: tuple) -> dict:
    """The engine variant served: eight concurrent requests and a stream,
    then the eight again in reverse order (other slots: the same bytes);
    previews add no capture; K1 10 launches per engine step;
    gen_iterations_total > 0. The engine's image of the locked path's body
    beside the locked PNG (reported)."""
    import numpy as np

    out: dict = {}
    with serving(SD_CONFIG, n_buckets=3, overrides=SD_ENGINE_SETS + sets) as port:
        g = served_graphs(port)["sd15"]
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
        c0 = sd_counters(port)
        pngs, stream, wall_s = sd_concurrent(port, bodies, stream_body=bodies[0])
        check((stream["final"] == read_png(pngs[0])).all(),
              "sd15 engine: the streamed image differs from the unary one")
        c1 = sd_counters(port)
        again, _, _ = sd_concurrent(port, bodies[::-1])
        check(again[::-1] == pngs, "sd15 engine: the same requests in other slots gave other "
              f"PNG bytes ({sum(a != b for a, b in zip(again[::-1], pngs))} of {len(pngs)})")
        c2 = sd_counters(port)
        d = {n: c2[n] - c0[n] for n in c0 if n != "k1_by_shape"}
        by_shape = sd_shape_launches(c0, c2)
        # Every step runs all 8 slots' rows: 2 x 8 = 16 UNet rows.
        check(d["gen_iterations_total"] > 0 and d["k1"] == SD_K1_PER_UNET
              * d["gen_iterations_total"] and by_shape == {
                  sd_shape_key(16, s): SD_K1_PER_UNET // 2 * d["gen_iterations_total"]
                  for s in (4096, 1024)},
              f"sd15 engine: K1 launched {d['k1']} times {by_shape} in "
              f"{d['gen_iterations_total']:g} steps ({SD_K1_PER_UNET} per step, half at each "
              f"level, 16 rows)")
        check(d["captures_total"] == 0 and d["runtime_compiles_total"] == 0,
              f"sd15 engine: captures / compiles moved {d['captures_total']} / "
              f"{d['runtime_compiles_total']:g} (previews included)")
        check(d["gen_admitted_total"] == 2 * len(bodies) + 1,
              f"sd15 engine: {d['gen_admitted_total']:g} admitted")
        diff = np.abs(read_png(pngs[0]).astype(int) - read_png(locked_png).astype(int))
        out.update(wall_s_8_plus_stream=wall_s, deltas=d, k1_launches=d["k1"],
                   k1_by_shape=by_shape,
                   stream={k: v for k, v in stream.items() if k != "final"},
                   graphs_served=g, first_wave_steps=c1["gen_iterations_total"]
                   - c0["gen_iterations_total"],
                   vs_locked={"max_pixel_diff": int(diff.max()),
                              "equal_share": float((diff == 0).mean())})
        print(f"sd15 engine: 8 requests + 1 stream in {wall_s:.2f} s over "
              f"{out['first_wave_steps']:g} steps; stream: {stream['progress_events']} progress "
              f"events, {stream['previews']} previews, one image, one done; the 8 again in "
              f"other slots byte-identical; K1 {d['k1']} = {SD_K1_PER_UNET} x "
              f"{d['gen_iterations_total']:g} steps; captures and compiles moved 0; against "
              f"the locked image max pixel diff {int(diff.max())}, "
              f"{(diff == 0).mean():.4f} equal", flush=True)
    return out


def sd15_prepare(card: str) -> tuple[dict, dict, Path]:
    """Phase 20's first part, with the card to itself: the seeded tree and
    its LDM checkpoint, and K1 at SD's padded head dims. Returns the phase's
    record so far, the checkpoint and the temporary directory holding it
    (``sd15_phase`` removes it)."""
    import concurrent.futures as cf

    t0 = time.perf_counter()
    out: dict = {"card": card, "config": str(SD_CONFIG.relative_to(ROOT))}
    tmp = Path(tempfile.mkdtemp(prefix="smoke-sd15-"))
    try:
        # The seeded tree is drawn and read back before K1's timings (its
        # copies would share the card with them); the file is written while
        # they run.
        seeded = sd_seeded_tree(tmp)
        with cf.ThreadPoolExecutor(1) as beside:
            writing = beside.submit(sd_checkpoint, seeded, tmp)
            # The locked path's 2 UNet rows and the engine step's 2 x 8 slots.
            out["kernels"] = {(b, s): sd_k1_row(b, s, d) for b in (2, 16)
                              for s, d in ((4096, 40), (1024, 80))}
            ckpt = writing.result()
        del seeded
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    out["checkpoint"] = {k: v for k, v in ckpt.items() if k not in ("path", "sets")}
    out["prepare_s"] = time.perf_counter() - t0
    return out, ckpt, tmp


def sd15_phase(prepared: tuple[dict, dict, Path]) -> dict:
    """Phase 20: SD 1.5 txt2img (examples/sd15_flash.toml) with CLIP's BPE,
    locked from the seeded tree's LDM checkpoint and, on the seeded tree,
    through the engine and in this process (after ``sd15_prepare``; the
    smoke runs this part beside phases 21 and 25)."""
    import torch

    t0 = time.perf_counter()
    out, ckpt, tmp = prepared
    card = out["card"]
    try:
        # The engine's server boots beside the locked one.
        prestart(SD_CONFIG, 3, SD_ENGINE_SETS + ckpt["sets"])
        locked = sd_locked_served(ckpt)
        png = locked.pop("png")
        out["in_process"] = sd_in_process(png, ckpt["sets"])
        out["locked"] = locked
        out["engine"] = sd_engine_served(sd_bodies(), png, ckpt["sets"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # K1's share of a 2-row UNet call: its ten launches at the timed shapes.
    k1_ms = 5 * sum(out["kernels"][(2, n)]["line"]["ms"] for n in (4096, 1024))
    out["k1_share_of_unet_2rows"] = k1_ms / out["in_process"]["unet_2rows_device_ms"]
    torch.cuda.empty_cache()
    out["phase_s"] = out["prepare_s"] + time.perf_counter() - t0
    out["phase_s_parent"] = SD_PHASE_S_PARENT
    print(f"sd15: phase 20 took {out['phase_s']:.1f} s, {out['prepare_s']:.1f} s of it "
          "with the card to itself, the rest beside phases 21 and 25 (alone, before the "
          f"import: {SD_PHASE_S_PARENT[0]:.1f}-{SD_PHASE_S_PARENT[1]:.1f} s on an H100 at "
          f"700 W); {card}", flush=True)
    return out


# -- phase 21: the router/worker process tier -------------------------------------

ROUTER_CONFIG = ROOT / "examples" / "bert_flash_router.toml"
TG_ROUTER_CONFIG = ROOT / "examples" / "textgen_flash_router.toml"
ROUTER_WORKERS = (1, 2, 4)
# Each drill: 10 s of closed-loop load at 16 connections after 1 s of
# warm-up, the SIGKILL 2 s in.
ROUTER_DRILL_ARGS = ("--duration", "10", "--warmup", "1", "--concurrency", "16",
                     "--kill-after", "2", "--min-availability", "0.99")
# The drills' respawn budget: the configured backoff plus this many times the
# slowest worker boot measured in this run (a respawn boots beside a worker
# serving the drill's load).
ROUTER_BOOT_MARGIN = 2.0
# Phase 21's bench window; device_utilization (a 2 s window) is read 2.5 s
# after the load's first batch.
ROUTER_BENCH_S = ("--duration", "4", "--warmup", "1")


@contextlib.contextmanager
def serving_together(*specs: tuple):
    """``serving(config, **kwargs)`` for each ``(config, kwargs)`` spec, the
    servers booting side by side; yields their values in order and stops
    every one that started."""
    import concurrent.futures as cf

    cms = [serving(config, **kwargs) for config, kwargs in specs]
    with contextlib.ExitStack() as stack, cf.ThreadPoolExecutor(len(cms)) as pool:
        futures = [pool.submit(cm.__enter__) for cm in cms]
        values, errors = [], []
        for cm, fut in zip(cms, futures):
            try:
                values.append(fut.result())
                stack.push(cm)
            except Exception as e:  # noqa: BLE001 — re-raised below, the rest stopped
                errors.append(e)
        if errors:
            raise errors[0]
        yield values


def router_answers(port: int) -> list[bytes]:
    """The bodies of phase 6's three requests (a text, 8 texts, 32 texts)."""
    out = []
    for obj in ({"text": "serve this text please"}, {"texts": TEXTS_8}, {"texts": TEXTS_32}):
        st, body = call(port, "POST", "/v1/models/bert:classify", obj)
        check(st == 200, f"router: {st} {body[:300]!r}")
        out.append(body)
    return out


def worker_metrics(port: int, n: int) -> list[str]:
    """Each worker's own /metrics, through the router's worker proxy."""
    texts = []
    for i in range(n):
        st, body = call(port, "GET", f"/workers/{i}/metrics")
        check(st == 200, f"router: /workers/{i}/metrics answered {st}")
        texts.append(body.decode())
    return texts


def gpu_memory_used_mib() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def router_memory(port: int, n: int) -> dict:
    """memory_reserved of each worker process (its /stats backend) and the
    card's used memory."""
    reserved = []
    for i in range(n):
        st, body = call(port, "GET", f"/workers/{i}/stats")
        check(st == 200, f"router: /workers/{i}/stats answered {st}")
        reserved.append(json.loads(body)["backend"]["memory_reserved_bytes"] / 2**20)
    return {"memory_reserved_mib_per_worker": reserved, "nvidia_smi_used_mib": gpu_memory_used_mib()}


def router_bench(tmp: Path, port: int, label: str, n: int, payload: Path,
                 layers: int = 12) -> dict:
    """``bench`` closed at 8 connections through the router on ``port`` (``n``
    workers), K1 counted over it (the counts set to 0 in every worker just
    before, summed just after, against the workers' summed batches: once
    per layer of each), each worker's ``device_utilization`` read 2.5 s
    after the load's first batch."""
    check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "router: kernel count reset refused")
    before = worker_metrics(port, n)

    def batches() -> float:
        return sum(metric(t, 'batches_total{model="bert"}') for t in worker_metrics(port, n))

    first = batches()
    bench = Cli(tmp, "bench_" + re.sub(r"\W+", "_", label), "bench", "--url",
                f"http://127.0.0.1:{port}", *ROUTER_BENCH_S, "--model", "bert", "--verb",
                "classify", "--payload", str(payload), "--content-type", "application/json",
                "--concurrency", "8")
    try:
        deadline = time.monotonic() + 60.0
        while batches() == first and bench.proc.poll() is None:
            check(time.monotonic() < deadline, f"bench {label}: no batch in 60 s")
            time.sleep(0.05)
        time.sleep(2.5)
        util = [metric(t, 'device_utilization{model="bert",replica="0"}')
                for t in worker_metrics(port, n)]
        rc, out = bench.finish()
    finally:
        bench.kill()
    summary = json.loads(out.strip().splitlines()[-1])
    after = worker_metrics(port, n)
    n_batches = sum(metric(a, 'batches_total{model="bert"}') - metric(b, 'batches_total{model="bert"}')
                    for a, b in zip(after, before))
    k1 = json.loads(call(port, "GET", "/stats")[1])["kernels"]["flash_attention"]["launches"]
    check(rc == 0 and summary["n_ok"] > 0 and summary["n_err"] == 0, f"bench {label}: {summary}")
    check(k1 > 0 and k1 == layers * n_batches,
          f"bench {label}: K1 launched {k1} times for {n_batches:g} batches ({layers} per batch)")
    print(f"router: bench {label}: {summary['throughput_per_s']}/s, p50 {summary['p50_ms']} ms, "
          f"p99 {summary['p99_ms']} ms, n_ok {summary['n_ok']}; K1 {k1} over {n_batches:g} "
          f"batches; device_utilization per worker {util}", flush=True)
    return {"summary": summary, "k1_launches": k1, "batches": n_batches,
            "device_utilization": util}


def router_fleet(tmp: Path, payload: Path, served: tuple, n: int,
                 direct: list | None = None, layers: int = 12) -> dict:
    """examples/bert_flash_router.toml served (``served``: its port and
    process) with ``n`` workers: their boot times and memory, then with
    ``direct`` (the single-process server's answers): the answers through
    the router byte-identical to them, K1 = 12 x batches summed over the
    workers with the counts set to 0 just before, every worker's compile
    count unchanged, a ``:reload`` fanned out to every worker (one version,
    the same bytes after); then the bench; the router's process free of
    CUDA throughout."""
    port, proc = served
    out: dict = {"workers": n}
    stats = json.loads(call(port, "GET", "/stats")[1])
    check(stats["router"]["pid"] == proc.pid and stats["router"]["cuda_initialized"] is False,
          f"router: the router process initialized CUDA: {stats['router']}")
    rows = stats["workers"]["workers"]
    check(len(rows) == n and all(r["state"] == "ready" for r in rows),
          f"router: workers {rows}")
    out["boot_s"] = [r["boot_s"] for r in rows]
    out["memory"] = router_memory(port, n)
    if direct is not None:
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200,
              "router: kernel count reset refused")
        before = worker_metrics(port, n)
        answers = router_answers(port)
        after = worker_metrics(port, n)
        k1 = json.loads(call(port, "GET", "/stats")[1])["kernels"]
        deltas = {name: [metric(a, f'{name}{{model="bert"}}') - metric(b, f'{name}{{model="bert"}}')
                         for a, b in zip(after, before)]
                  for name in ("batches_total", "items_total", "runtime_compiles_total")}
        n_batches = sum(deltas["batches_total"])
        check(answers == direct, "router: answers differ from the single-process server's")
        check(sum(deltas["items_total"]) == 41, f"router: items {deltas['items_total']}")
        check(deltas["runtime_compiles_total"] == [0.0] * n,
              f"router: compiles moved {deltas['runtime_compiles_total']}")
        launches = k1["flash_attention"]["launches"]
        check(launches > 0 and launches == layers * n_batches,
              f"router: K1 launched {launches} times for {n_batches:g} batches, summed over "
              f"the workers {k1['workers']}")
        t0 = time.perf_counter()
        st, body = call(port, "POST", "/admin/models/bert:reload")
        reload_s = time.perf_counter() - t0
        info = json.loads(body)
        check(st == 200 and info["fleet_consistent"] and len(info["workers"]) == n
              and {w["version"] for w in info["workers"].values()} == {2},
              f"router: reload fan-out {st} {info}")
        check(router_answers(port) == direct, "router: answers changed across :reload")
        compiles = [metric(t, 'runtime_compiles_total{model="bert"}')
                    for t in worker_metrics(port, n)]
        check(compiles == [metric(t, 'runtime_compiles_total{model="bert"}') for t in after],
              f"router: compiles moved across :reload: {compiles}")
        out.update(launches=launches, batches_per_worker=deltas["batches_total"],
                   reload_s=reload_s, answers_equal_direct=True)
        print(f"router: {n} workers: the 3 requests byte-identical to the direct server's, "
              f"K1 {launches} = {layers} x {n_batches:g} batches {deltas['batches_total']}, "
              f"compiles moved 0; :reload fanned out in {reload_s:.2f} s (version 2 on "
              f"every worker, the same bytes after)", flush=True)
    out["bench"] = router_bench(tmp, port, f"router {n} workers closed c8", n, payload, layers)
    check(json.loads(call(port, "GET", "/stats")[1])["router"]["cuda_initialized"] is False,
          "router: the router process initialized CUDA under load")
    print(f"router: {n} workers booted in {out['boot_s']} s; memory_reserved per worker "
          f"{out['memory']['memory_reserved_mib_per_worker']} MiB, card used "
          f"{out['memory']['nvidia_smi_used_mib']:g} MiB (with the other server of the pair "
          "up)", flush=True)
    return out


def router_drills(tmp: Path, budget_s: float, configs: tuple[Path, Path]) -> dict:
    """``python -m tpuserve_torch chaos --drill worker_kill`` on the first of
    ``configs`` (BERT-flash behind the router) and ``--drill stream_kill`` on
    the second (textgen behind it), side by side on the card (as phase 16
    runs its two chaos runs): each exits 0 (availability >= 0.99 and every
    gate)."""
    t0 = time.perf_counter()
    runs = {drill: Cli(tmp, drill, "chaos", "--config", str(config), "--drill", drill,
                       *ROUTER_DRILL_ARGS, "--respawn-budget", f"{budget_s:.1f}")
            for drill, config in zip(("worker_kill", "stream_kill"), configs)}
    try:
        results = {drill: run.finish(timeout_s=420.0) for drill, run in runs.items()}
    finally:
        for run in runs.values():
            run.kill()
    return {drill: router_drill_summary(drill, rc, text, time.perf_counter() - t0)
            for drill, (rc, text) in results.items()}


def router_drill_summary(drill: str, rc: int, text: str, wall_s: float) -> dict:
    summary = json.loads(text)
    summary.pop("postmortems", None)
    check(rc == 0 and summary["availability"] >= 0.99 and all(summary["gates"].values()),
          f"{drill}: exit {rc}, {json.dumps(summary)[:3000]}")
    audit = summary.get("stream_audit") or summary.get("integrity")
    print(f"router: {drill}: exit 0, availability {summary['availability']}, n_ok "
          f"{summary['n_ok']}, kill {summary['kill']}, gates {summary['gates']}, {audit}",
          flush=True)
    return dict(summary, wall_s=wall_s)


def router_phase(card: str) -> dict:
    """Phase 21: BERT-flash through the router over worker processes on the
    card (answers, K1, compiles, :reload, no CUDA in the router; bench at 1
    and 2 workers beside the direct server), then the worker_kill and
    stream_kill drills; every server and drill at SHALLOW_LAYERS (the
    direct server too: the answers compared are of one depth)."""
    t0 = time.perf_counter()
    out: dict = {"card": card, "layers": SHALLOW_LAYERS,
                 "configs": [str(c.relative_to(ROOT)) for c in (ROUTER_CONFIG, TG_ROUTER_CONFIG)]}
    direct_cfg, router_cfg, tg_cfg = (shallow_config(c) for c in
                                      (CONFIG, ROUTER_CONFIG, TG_ROUTER_CONFIG))
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        payload = tmp / "texts32.json"
        payload.write_text(json.dumps({"texts": TEXTS_32}))
        # The three servers boot side by side and are benched one at a time
        # while the others idle. Phase 22 benches 4 workers (over 2 host
        # domains); the 2-worker fleet here is the last of this phase.
        fleet = (router_cfg, {"n_buckets": 6, "with_proc": True})
        fleets = {}
        with serving_together((direct_cfg, {"n_buckets": 6, "overrides": CLI_SERVE_SETS}),
                              *((fleet[0], dict(fleet[1], overrides=(*CLI_SERVE_SETS,
                                                                     f"router.workers={n}")))
                                for n in (1, 2))) as (port, served1, served2):
            direct = router_answers(port)
            # ROUTER_BENCH_S after bench_run's own window: the later flags win.
            run = bench_run(tmp, port, "direct closed c8", *ROUTER_BENCH_S, "--model", "bert",
                            "--verb", "classify", "--payload", str(payload), "--content-type",
                            "application/json", "--concurrency", "8", sample_at_s=2.5)
            check(run["k1_launches"] == SHALLOW_LAYERS * run["batches"]["bert"],
                  f"direct bench: K1 {run['k1_launches']} for {run['batches']} batches")
            out["direct"] = {"bench": run}
            fleets[1] = router_fleet(tmp, payload, served1, 1, layers=SHALLOW_LAYERS)
            fleets[2] = router_fleet(tmp, payload, served2, 2, direct, SHALLOW_LAYERS)
        out["fleets"] = fleets
        from tpuserve_torch.config import load_config

        backoff = load_config(str(ROUTER_CONFIG)).router.respawn_initial_s
        boot = max(b for f in fleets.values() for b in f["boot_s"])
        budget = backoff + ROUTER_BOOT_MARGIN * boot
        out["respawn_budget_s"] = {"budget_s": budget, "backoff_s": backoff,
                                   "slowest_boot_s": boot, "margin": ROUTER_BOOT_MARGIN}
        out.update(router_drills(tmp, budget, (router_cfg, tg_cfg)))
    out["k1_launches"] = fleets[2]["launches"]
    out["phase_s"] = time.perf_counter() - t0
    print(f"router: phase 21 took {out['phase_s']:.1f} s", flush=True)
    return out


# -- phase 22: host failure domains and the peer router tier -----------------------

HOSTS_CONFIG = ROOT / "examples" / "bert_flash_hosts.toml"
HOSTS_WORKERS = 4
# The host_kill drill: phase 21's arguments (10 s at 16 connections after 1 s
# of warm-up, the killpg 2 s in).
HOSTS_DRILL_ARGS = ROUTER_DRILL_ARGS
# The drill's re-absorb budget: the backoff plus this many times the slowest
# host boot (an agent and its workers, booted one after another) measured
# in this phase.
HOSTS_BOOT_MARGIN = ROUTER_BOOT_MARGIN
# Phase 6's three requests are sent this many times over fresh connections.
HOSTS_ROUNDS = 4


def router_urls(port: int) -> dict[int, str]:
    """Each router's peer-listener URL by router id, from the ring its
    ``/stats`` shows (the shared public port cannot address one router)."""
    ring = json.loads(call(port, "GET", "/stats")[1])["router"].get("ring", {})
    return {int(rid): url for rid, url in ring.get("members", {}).items()}


def peer_call(url: str, path: str) -> tuple[int, bytes]:
    """GET ``path`` on one router's loopback peer listener."""
    host, port = url.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def routers_settled(port: int, n: int = 2, timeout_s: float = 60.0) -> dict[int, str]:
    """Wait until ``n`` routers are in the ring and a fresh connection on the
    shared port has reached each; their peer URLs."""
    deadline = time.monotonic() + timeout_s
    seen: set[int] = set()
    while time.monotonic() < deadline:
        urls = router_urls(port)
        seen.add(json.loads(call(port, "GET", "/healthz")[1])["router_id"])
        if len(urls) == n and seen == set(range(n)):
            return urls
        time.sleep(0.05)
    raise SmokeFailure(f"hosts: {n} routers never all served the port (ring {urls}, seen {seen})")


def routers_cuda_free(urls: dict[int, str], pid: int) -> list[bool]:
    """Each router's ``cuda_initialized`` off its own ``/peer/stats``; the
    primary is the ``serve`` process."""
    flags = []
    for rid, url in sorted(urls.items()):
        st, body = peer_call(url, "/peer/stats")
        check(st == 200, f"hosts: router {rid} /peer/stats answered {st}")
        r = json.loads(body)["router"]
        check(r["router_id"] == rid and r["is_primary"] is (rid == 0),
              f"hosts: router {rid}'s /peer/stats: {r}")
        check(rid != 0 or r["pid"] == pid, f"hosts: the primary is pid {r['pid']}, not {pid}")
        flags.append(r["cuda_initialized"])
    check(flags == [False] * len(urls), f"hosts: a router initialized CUDA: {flags}")
    return flags


def router_counter(urls: dict[int, str], name: str) -> dict[int, float]:
    return {rid: metric(peer_call(url, "/peer/metrics")[1].decode(), name)
            for rid, url in urls.items()}


def hosts_fleet(tmp: Path, payload: Path, served: tuple, direct: list) -> dict:
    """examples/bert_flash_hosts.toml as written (2 host domains x 2
    workers, 2 routers, no cache): the roster, the routers free of CUDA,
    phase 6's three requests over fresh connections byte-identical to the
    direct server's with both routers taking some, K1 = SHALLOW_LAYERS x
    batches over the 4 workers, compiles unchanged, the fleet scrape's sum
    exact, the bench; then host scaling and a SIGKILL of router 1 under
    load."""
    from tpuserve_torch.telemetry.fleet import sum_counter

    port, proc = served
    out: dict = {}
    urls = routers_settled(port)
    routers_cuda_free(urls, proc.pid)
    primary = json.loads(peer_call(urls[0], "/peer/stats")[1])
    w = primary["workers"]
    check(w["hosts_up"] == 2 and w["healthy"] == HOSTS_WORKERS
          and len({h["pgid"] for h in w["hosts"]}) == 2,
          f"hosts: roster {json.dumps(w)[:2000]}")
    out["host_boot_s"] = [h["boot_s"] for h in w["hosts"]]
    out["worker_boot_s"] = [r["boot_s"] for h in w["hosts"] for r in h["workers"]]
    out["memory"] = router_memory(port, HOSTS_WORKERS)

    check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "hosts: kernel count reset refused")
    before = worker_metrics(port, HOSTS_WORKERS)
    taken0 = router_counter(urls, 'router_requests_total{model="bert"}')
    for _ in range(HOSTS_ROUNDS):
        check(router_answers(port) == direct,
              "hosts: answers through the routers differ from the direct server's")
    taken = {rid: n - taken0[rid] for rid, n in
             router_counter(urls, 'router_requests_total{model="bert"}').items()}
    check(sum(taken.values()) == 3 * HOSTS_ROUNDS and all(n > 0 for n in taken.values()),
          f"hosts: requests taken per router {taken}")
    after = worker_metrics(port, HOSTS_WORKERS)
    deltas = {name: [metric(a, f'{name}{{model="bert"}}') - metric(b, f'{name}{{model="bert"}}')
                     for a, b in zip(after, before)]
              for name in ("batches_total", "items_total", "runtime_compiles_total")}
    n_batches = sum(deltas["batches_total"])
    launches = json.loads(call(port, "GET", "/stats")[1])["kernels"]["flash_attention"]["launches"]
    check(sum(deltas["items_total"]) == 41 * HOSTS_ROUNDS, f"hosts: items {deltas['items_total']}")
    check(deltas["runtime_compiles_total"] == [0.0] * HOSTS_WORKERS,
          f"hosts: compiles moved {deltas['runtime_compiles_total']}")
    check(launches > 0 and launches == SHALLOW_LAYERS * n_batches,
          f"hosts: K1 launched {launches} times for {n_batches:g} batches over 4 workers")
    out.update(launches=launches, batches_per_worker=deltas["batches_total"],
               requests_per_router=taken, answers_equal_direct=True)
    # The fleet scrape: requests_total summed over every process, exactly.
    st, fleet = call(port, "GET", "/metrics/fleet")
    check(st == 200, f"hosts: /metrics/fleet answered {st}")
    fleet_sum = sum_counter(fleet.decode(), "requests_total", 'model="bert"')
    procs_sum = sum(sum_counter(t, "requests_total", 'model="bert"')
                    for t in worker_metrics(port, HOSTS_WORKERS))
    check(fleet_sum == procs_sum > 0, f"hosts: fleet requests_total {fleet_sum} != {procs_sum}")
    out["fleet_requests_total"] = fleet_sum
    print(f"hosts: 2 hosts x 2 workers, 2 routers: {3 * HOSTS_ROUNDS} requests over fresh "
          f"connections byte-identical to the direct server's, taken per router {taken}; "
          f"K1 {launches} = {SHALLOW_LAYERS} x {n_batches:g} batches {deltas['batches_total']}, compiles "
          f"moved 0; /metrics/fleet requests_total {fleet_sum:g} = the workers' sum; host "
          f"boots {out['host_boot_s']} s, worker boots {out['worker_boot_s']} s", flush=True)
    out["bench"] = router_bench(tmp, port, "2 hosts x 2 workers, 2 routers closed c8",
                                HOSTS_WORKERS, payload, layers=SHALLOW_LAYERS)
    return out


def hosts_scale_and_peer_kill(port: int, proc) -> dict:
    """``/admin/hosts/0:scale?active=1`` and back (both 200), then a
    SIGKILL of router 1 (its pid from the primary's roster) under load:
    every request sent after its death answers 200, and the primary
    respawns it into a 2-member ring."""
    import threading

    urls = router_urls(port)
    out: dict = {}
    for active in (1, 2):
        st, body = call(port, "POST", f"/admin/hosts/0:scale?active={active}")
        check(st == 200 and json.loads(body)["active"] == active,
              f"hosts: scale host 0 to {active}: {st} {body[:300]!r}")
    out["scale"] = "host 0 to 1 and back to 2: 200, 200"
    primary = json.loads(peer_call(urls[0], "/peer/stats")[1])
    peer_pid = primary["routers"]["peers"][0]["pid"]
    stop = threading.Event()
    sent: list[tuple[float, int, str]] = []

    def load(i: int) -> None:
        n = 0
        while not stop.is_set():
            t = time.monotonic()
            try:
                st, body = call(port, "POST", "/v1/models/bert:classify",
                                {"text": f"load {i} request {n}"})
                what = body[:200].decode("utf-8", "replace") if st != 200 else ""
            except OSError as e:
                st, what = 0, repr(e)
            sent.append((t, st, what))
            n += 1

    threads = [threading.Thread(target=load, args=(i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(1.0)
        os.kill(peer_pid, signal.SIGKILL)
        # Dead once reaped (the primary's liveness sweep): a zombie leader
        # may still have threads, and with them its listening socket.
        deadline = time.monotonic() + 30.0
        while Path(f"/proc/{peer_pid}").exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        check(not Path(f"/proc/{peer_pid}").exists(), f"hosts: router 1 (pid {peer_pid}) "
              "was not reaped in 30 s")
        dead_at = time.monotonic()
        time.sleep(3.0)
    finally:
        stop.set()
        for t in threads:
            t.join(60.0)
    after = [st for t, st, _ in sent if t > dead_at]
    failed = [(round(t - dead_at, 3), st, what) for t, st, what in sent
              if t > dead_at and st != 200]
    check(after and not failed,
          f"hosts: after router 1's SIGKILL {len(failed)} of {len(after)} requests failed "
          f"(seconds after its death, status, answer): {failed[:5]}")
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        urls = router_urls(port)
        respawns = metric(peer_call(urls[0], "/peer/metrics")[1].decode(),
                          'router_respawns_total{router="1"}')
        if len(urls) == 2 and respawns >= 1:
            break
        time.sleep(0.1)
    check(len(urls) == 2 and respawns >= 1,
          f"hosts: ring {urls}, router_respawns_total{{router=1}} {respawns}")
    out.update(peer_killed_pid=peer_pid, requests_after_kill=len(after),
               non_200_after_kill=0, ring_members=len(urls), router_respawns=respawns)
    # Before teardown: host 0's second worker back, so no boot is cut.
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        w = json.loads(peer_call(urls[0], "/peer/stats")[1])["workers"]
        if w["healthy"] == HOSTS_WORKERS:
            break
        time.sleep(0.2)
    check(w["healthy"] == HOSTS_WORKERS, f"hosts: {w['healthy']} workers healthy after the scale")
    print(f"hosts: scaled host 0 to 1 and back (200, 200); router 1 (pid {peer_pid}) SIGKILLed "
          f"under load: {len(after)} requests sent after its death, all 200; ring back at 2, "
          f"router_respawns_total{{router=1}} {respawns:g}", flush=True)
    return out


def hosts_cached(port: int) -> dict:
    """The same file with the cache on: 8 identical bodies on 8 fresh
    connections cost one batch in the fleet, at least one of them through a
    peer hop to the key's owning router."""
    urls = routers_settled(port)
    n = len(json.loads(peer_call(urls[0], "/peer/stats")[1])["workers"]["workers"])
    body = {"text": "one execution for the whole router tier"}
    batches0 = sum(metric(t, 'batches_total{model="bert"}') for t in worker_metrics(port, n))
    hops0 = sum(router_counter(urls, 'cache_peer_hops_total{model="bert"}').values())
    answers = set()
    for _ in range(8):
        st, got = call(port, "POST", "/v1/models/bert:classify", body)
        check(st == 200, f"hosts: cached request answered {st}")
        answers.add(got)
    batches = sum(metric(t, 'batches_total{model="bert"}')
                  for t in worker_metrics(port, n)) - batches0
    hops = sum(router_counter(urls, 'cache_peer_hops_total{model="bert"}').values()) - hops0
    check(len(answers) == 1 and batches == 1 and hops >= 1,
          f"hosts: 8 identical bodies: {len(answers)} answers, {batches:g} batches, {hops:g} hops")
    print(f"hosts: cache on: 8 identical bodies on fresh connections, 1 batch in the fleet, "
          f"{hops:g} peer hops", flush=True)
    return {"identical_bodies": 8, "batches": batches, "peer_hops": hops}


def hosts_phase(card: str, start=None, meanwhile=None) -> tuple[dict, object]:
    """Phase 22: examples/bert_flash_hosts.toml (full-width BERT-flash, 2
    host domains x 2 workers, 2 routers on one port) served beside a copy
    with the cache on (1 worker per host) and beside examples/bert_flash.toml
    alone (the direct server whose answers the routers' must equal), then
    ``chaos --drill host_kill`` on the file, started once the bench is
    done; every server and the drill at SHALLOW_LAYERS. ``start()`` runs
    right after the drill starts (the smoke starts phase 23's fleet drill
    there) and ``meanwhile()`` (phases 23-24) once this phase's servers are
    stopped, while the drill's fleet re-absorbs its killed host: the smoke
    fits its time limit only so. Returns (this phase's summary, what
    ``meanwhile`` returned)."""
    t0 = time.perf_counter()
    out: dict = {"card": card, "config": str(HOSTS_CONFIG.relative_to(ROOT)),
                 "layers": SHALLOW_LAYERS}
    hosts_cfg, direct_cfg = shallow_config(HOSTS_CONFIG), shallow_config(CONFIG)
    from tpuserve_torch.config import load_config

    backoff = load_config(str(HOSTS_CONFIG)).router.respawn_initial_s
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        payload = tmp / "texts32.json"
        payload.write_text(json.dumps({"texts": TEXTS_32}))
        drill = None
        try:
            with serving_together(
                    (hosts_cfg, {"n_buckets": 6, "with_proc": True,
                                 "overrides": CLI_SERVE_SETS}),
                    (hosts_cfg, {"n_buckets": 6, "with_proc": True,
                                 "overrides": ("cache.enabled=true", "router.workers=1")}),
                    (direct_cfg, {"n_buckets": 6, "with_proc": True})
            ) as (served, cached, alone):
                direct = router_answers(alone[0])
                alone[1].send_signal(signal.SIGTERM)  # its card memory is not the fleet's
                alone[1].wait(60)
                out["fleet"] = hosts_fleet(tmp, payload, served, direct)
                # The drill boots its own fleet while the checks below run.
                boot = max(out["fleet"]["host_boot_s"])
                budget = backoff + HOSTS_BOOT_MARGIN * boot
                out["reabsorb_budget_s"] = {"budget_s": budget, "backoff_s": backoff,
                                            "slowest_host_boot_s": boot,
                                            "margin": HOSTS_BOOT_MARGIN}
                drill = Cli(tmp, "host_kill", "chaos", "--config", str(hosts_cfg), "--drill",
                            "host_kill", *HOSTS_DRILL_ARGS, "--respawn-budget", f"{budget:.1f}")
                if start is not None:
                    start()
                out["cache"] = hosts_cached(cached[0])
                routers_cuda_free(router_urls(cached[0]), cached[1].pid)
                out["peer_kill"] = hosts_scale_and_peer_kill(*served)
                routers_cuda_free(router_urls(served[0]), served[1].pid)
            t_meanwhile = time.perf_counter()
            beside = meanwhile() if meanwhile is not None else None
            out["meanwhile_s"] = time.perf_counter() - t_meanwhile
            rc, text = drill.finish(timeout_s=420.0)
        finally:
            if drill is not None:
                drill.kill()
    summary = router_drill_summary("host_kill", rc, text, time.perf_counter() - t0)
    check(summary["gates"]["survivor_compiles_zero"] and summary["kill"]["workers_killed"] == 2,
          f"host_kill: {summary['gates']} {summary['kill']}")
    out["host_kill"] = summary
    out["k1_launches"] = out["fleet"]["launches"]
    out["phase_s"] = time.perf_counter() - t0
    print(f"hosts: phase 22 took {out['phase_s']:.1f} s ({out['meanwhile_s']:.1f} s of it "
          "beside the next phases)", flush=True)
    return out, beside


# -- phase 23: the fleet scheduler's weight paging ---------------------------------

FLEET_CONFIG = ROOT / "examples" / "bert_fleet.toml"
# Warmed at boot: resnet50's 3 buckets and mobilenetv3's 4 (bert boots cold).
FLEET_BUCKETS = 7
FLEET_LAYERS = 12
FLEET_DRILL_ARGS = ("--drill", "fleet", "--model", "mobilenetv3", "--duration", "10",
                    "--warmup", "1", "--concurrency", "8", "--min-availability", "0.99")
# The fleet drill's p99 budget for each survivor (ms).
FLEET_P99_BUDGET_MS = 2000.0


def process_card_mib(pid: int) -> float | None:
    """The card memory ``nvidia-smi`` lists for process ``pid`` (None when
    it lists none: a container may show other process ids)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    for line in out.stdout.strip().splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) == 2 and fields[0].isdigit() and int(fields[0]) == pid:
            return float(fields[1])
    return None


def fleet_memory(port: int, pid: int) -> dict:
    """The server process's card memory: PyTorch's reserved and allocated
    bytes (its /stats backend), nvidia-smi's figure for the process and the
    card's used memory, in MiB."""
    backend = json.loads(call(port, "GET", "/stats")[1])["backend"]
    return {"memory_reserved_mib": backend["memory_reserved_bytes"] / 2**20,
            "memory_allocated_mib": backend["memory_allocated_bytes"] / 2**20,
            "nvidia_smi_process_mib": process_card_mib(pid),
            "nvidia_smi_card_used_mib": gpu_memory_used_mib()}


def fleet_bert(port: int) -> dict:
    """bert's paging state (``/stats`` ``scheduler``) and graph counts
    (``/v1/models``)."""
    state = json.loads(call(port, "GET", "/stats")[1])["scheduler"]["models"]["bert"]["state"]
    d = json.loads(call(port, "GET", "/v1/models")[1])["bert"]
    return {"state": state, "compiles_total": d["compiles_total"],
            "captures_total": d["captures_total"], "param_bytes_per_slot": d["params"]["bytes"],
            "slots": d["slots"]["count"], "params_resident": d["params_resident"],
            "version": d["version"]}


def fleet_bert_round(port: int, direct: list[bytes], label: str) -> dict:
    """Phase 6's three requests to bert with the counts at 0 just before:
    the bytes equal to the direct server's and K1 = FLEET_LAYERS x bert's
    batches."""
    check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "kernel count reset refused")
    before = metric(call(port, "GET", "/metrics")[1].decode(), 'batches_total{model="bert"}')
    bodies = router_answers(port)
    after = metric(call(port, "GET", "/metrics")[1].decode(), 'batches_total{model="bert"}')
    launches, stats_launches = kernel_counts(port)
    batches = after - before
    check(bodies == direct, f"fleet {label}: bert's answers differ from the direct server's")
    check(stats_launches == 0 and batches >= 3 and launches == FLEET_LAYERS * batches,
          f"fleet {label}: K1 {launches} (K2 {stats_launches}) for {batches:g} bert batches")
    return {"k1_launches": launches, "batches": batches}


class NeighbourLoad:
    """Closed-loop clients sending framed bodies to resnet50 and
    mobilenetv3 until stopped, every answer's status counted."""

    def __init__(self, port: int, clients: int = 2) -> None:
        import threading

        bodies = [(f"/v1/models/{name}:predict", body, ctype)
                  for name, label, body, ctype, _ in resnet_requests() + mnv3_requests()
                  if label in ("frame8", "frame4")]
        self.statuses: dict[str, dict[int, int]] = {path: {} for path, _, _ in bodies}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._loop, args=(port, *b), daemon=True)
                         for b in bodies for _ in range(clients)]
        for t in self._threads:
            t.start()

    def _loop(self, port: int, path: str, body: bytes, ctype: str) -> None:
        while not self._stop.is_set():
            try:
                st = call(port, "POST", path, raw=body, ctype=ctype)[0]
            except OSError:
                st = -1
            with self._lock:
                row = self.statuses[path]
                row[st] = row.get(st, 0) + 1

    def stop(self) -> dict:
        self._stop.set()
        for t in self._threads:
            t.join(60)
        return {path: dict(row) for path, row in self.statuses.items()}


def _fleet_checks(specs: list, direct: list[bytes] | None, out: dict) -> None:
    """Phase 23's checks on examples/bert_fleet.toml's server (and the
    direct server in ``specs`` when ``direct`` is None): cold boot, the
    warming shed, :warm, the answers and K1, :demote and the memory it
    returns, the re-warm under the neighbours' load; under the retrace
    witness, every capture and compile of both warms sanctioned, with 0
    violations."""
    with serving_together(*specs) as served:
        port, proc = served[0]
        if direct is None:
            direct = router_answers(served[1][0])
            served[1][1].send_signal(signal.SIGTERM)  # its memory is not the fleet's
            served[1][1].wait(60)
        memory, warm_ms = {}, {}
        cold = fleet_bert(port)
        check(cold["state"] == "cold" and cold["compiles_total"] == 0
              and cold["captures_total"] == 0 and not cold["params_resident"],
              f"fleet: bert did not boot cold: {cold}")
        memory["cold"] = fleet_memory(port, proc.pid)
        st, body, headers = call_h(port, "POST", "/v1/models/bert:classify",
                                   {"text": "serve this text please"})
        check(st == 503 and json.loads(body).get("reason") == "model_warming"
              and int(headers.get("Retry-After", "0")) >= 1,
              f"fleet: a cold bert answered {st} {body[:200]!r} {headers}")
        st, body = call(port, "POST", "/admin/models/bert:warm")
        check(st == 200, f"fleet: :warm answered {st} {body[:300]!r}")
        warm_ms["first"] = json.loads(body).get("warm_ms")
        warm = fleet_bert(port)
        check(warm["state"] == "warm" and warm["params_resident"] and warm["compiles_total"] > 0,
              f"fleet: bert not warm after :warm: {warm}")
        memory["warm"] = fleet_memory(port, proc.pid)
        out["first_warm"] = fleet_bert_round(port, direct, "first warm")
        st, body = call(port, "POST", "/admin/models/bert:demote")
        check(st == 200 and json.loads(body).get("demoted") is True,
              f"fleet: :demote answered {st} {body[:300]!r}")
        demoted = fleet_bert(port)
        check(demoted["state"] == "cold" and not demoted["params_resident"]
              and demoted["slots"] == 0, f"fleet: bert not cold after :demote: {demoted}")
        memory["demoted"] = fleet_memory(port, proc.pid)
        slots_mib = warm["slots"] * warm["param_bytes_per_slot"] / 2**20
        freed = {k: memory["warm"][k] - memory["demoted"][k]
                 for k in ("memory_reserved_mib", "nvidia_smi_process_mib")
                 if memory["warm"][k] is not None and memory["demoted"][k] is not None}
        check(freed["memory_reserved_mib"] >= slots_mib,
              f"fleet: demote returned {freed} MiB, the slots hold {slots_mib:.0f} MiB")
        if "nvidia_smi_process_mib" in freed:
            check(freed["nvidia_smi_process_mib"] >= slots_mib,
                  f"fleet: demote returned {freed} MiB to the card, the slots hold "
                  f"{slots_mib:.0f} MiB")
        out["freed_mib"] = dict(freed, slots_param_mib=slots_mib)
        load = NeighbourLoad(port)
        try:
            time.sleep(1.0)
            st, body = call(port, "POST", "/admin/models/bert:warm")
            check(st == 200, f"fleet: re-warm answered {st} {body[:300]!r}")
            warm_ms["rewarm"] = json.loads(body).get("warm_ms")
            out["rewarm"] = fleet_bert_round(port, direct, "re-warm")
        finally:
            neighbours = load.stop()
        out["neighbours_during_rewarm"] = neighbours
        check(all(set(row) == {200} and row[200] > 0 for row in neighbours.values()),
              f"fleet: a neighbour answered other than 200 during the re-warm: {neighbours}")
        rewarm = fleet_bert(port)
        check(rewarm["compiles_total"] == warm["compiles_total"]
              and rewarm["captures_total"] == warm["captures_total"] * 2,
              f"fleet: re-warm compiles/captures {rewarm} against the first warm's {warm}")
        memory["rewarmed"] = fleet_memory(port, proc.pid)
        rw = json.loads(call(port, "GET", "/stats")[1])["robustness"].get("retrace_witness")
        check(rw is not None and rw["barrier_declared"] and rw["sync_guard_armed"]
              and rw["violations"] == []
              and rw["sanctioned_captures"] == rewarm["captures_total"]
              and rw["sanctioned_compiles"] == rewarm["compiles_total"],
              f"fleet: retrace witness {rw} against bert's {rewarm}")
        out["retrace_witness"] = {k: rw[k] for k in (
            "warmup_compiles", "sanctioned_compiles", "warmup_captures", "sanctioned_captures",
            "transfer_windows")}
        print(f"fleet: retrace witness: both warms' {rw['sanctioned_captures']} captures and "
              f"{rw['sanctioned_compiles']} compiles sanctioned, {rw['transfer_windows']} "
              "transfer windows, 0 violations", flush=True)
        audit = [(r["verb"], r["outcome"])
                 for r in json.loads(call(port, "GET", "/debug/audit")[1])["audit"]]
        check(audit == [("warm", "ok"), ("demote", "ok"), ("warm", "ok")],
              f"fleet: audit trail {audit}")
        out["bert"] = {"cold": cold, "warm": warm, "demoted": demoted, "rewarmed": rewarm}
        out["memory"] = memory
        out["warm_ms"] = warm_ms


def start_fleet_drill(tmp: Path) -> Cli:
    """``chaos --drill fleet`` on examples/bert_fleet.toml, mobilenetv3 the
    victim, started at once (it serves its own fleet)."""
    return Cli(tmp, "fleet", "chaos", "--config", str(FLEET_CONFIG), *FLEET_DRILL_ARGS)


def fleet_phase(card: str, direct: list[bytes] | None = None,
                drill: Cli | None = None) -> dict:
    """Phase 23: examples/bert_fleet.toml (cold_start BERT-flash at 12
    layers beside ResNet-50 and MobileNetV3, the fleet scheduler on): cold
    boot, the warming shed, :warm, the answers and K1, :demote and the
    memory it returns, the re-warm under the neighbours' load, beside
    ``chaos --drill fleet`` with mobilenetv3 as the victim (its own server,
    started first, by ``start_fleet_drill`` when ``drill`` is None, and
    read last). ``direct``: phase 6's answer bytes (a direct server is
    booted beside the fleet without them)."""
    t0 = time.perf_counter()
    out: dict = {"card": card, "config": str(FLEET_CONFIG.relative_to(ROOT)),
                 "layers": FLEET_LAYERS}
    with tempfile.TemporaryDirectory() as tmp_name:
        drill = drill or start_fleet_drill(Path(tmp_name))
        specs = [(FLEET_CONFIG, {"n_buckets": FLEET_BUCKETS, "with_proc": True,
                                 "env": RETRACE_ENV})]
        if direct is None:
            specs.append((CONFIG, {"n_buckets": 6, "with_proc": True}))
        try:
            _fleet_checks(specs, direct, out)
            rc, text = drill.finish(timeout_s=420.0)
        finally:
            drill.kill()
    summary = json.loads(text)
    survivors = {n: row for n, row in summary["models"].items() if row["role"] == "survivor"}
    check(rc == 0 and summary["victim_breaker_open"]
          and all(r["availability"] >= 0.99 and r["p99_ms"] <= FLEET_P99_BUDGET_MS
                  for r in survivors.values()),
          f"fleet drill: exit {rc}, {json.dumps(summary)[:3000]}")
    drill_k = summary["kernels"]
    check(drill_k["k1_launches"] == FLEET_LAYERS * drill_k["batches"]["bert"] > 0,
          f"fleet drill: K1 {drill_k['k1_launches']} for {drill_k['batches']} batches")
    out["drill"] = {"exit": rc, "victim": summary["victim"], "kernels": drill_k,
                    "victim_breaker": summary["victim_breaker"],
                    "p99_budget_ms": FLEET_P99_BUDGET_MS,
                    "models": {n: {k: r[k] for k in ("role", "availability", "n_ok", "n_err",
                                                     "p50_ms", "p99_ms")}
                               for n, r in summary["models"].items()},
                    "bert_state": summary["scheduler"]["models"]["bert"]["state"]}
    out["k1_launches"] = {"first_warm": out["first_warm"]["k1_launches"],
                          "rewarm": out["rewarm"]["k1_launches"],
                          "drill": drill_k["k1_launches"]}
    out["phase_s"] = time.perf_counter() - t0
    print(f"fleet: warm {out['warm_ms']} ms, freed {out['freed_mib']} MiB, drill survivors "
          f"{out['drill']['models']}; phase 23 took {out['phase_s']:.1f} s", flush=True)
    return out


# -- phase 24: tenants and the autopilot ---------------------------------------------

TENANTS_CONFIG = ROOT / "examples" / "bert_flash_tenants.toml"
AUTOPILOT_DRILL_ARGS = ("--drill", "autopilot", "--duration", "18", "--warmup", "1",
                        "--concurrency", "12", "--min-availability", "0.97")
# The reference's autopilot drill arms a single-host latency fault mid-load:
# worker 2 is host 1's boot-active slot (wid = host x workers + i).
AUTOPILOT_FAULT_TOML = """
[faults]
enabled = true
seed = 7

[[faults.rule]]
kind = "worker_slow"
model = "*"
probability = 1.0
delay_ms = 250.0
after_s = 6.0
worker = 2
"""


def start_autopilot_drill() -> Cli:
    """``chaos --drill autopilot`` on a copy of examples/bert_flash_tenants.toml
    at SHALLOW_LAYERS and one router (the reference drill's topology) with
    the reference drill's fault rule, started at once (it serves its own
    fleet)."""
    tmp = ROOT / "build" / "smoke" / "autopilot"
    tmp.mkdir(parents=True, exist_ok=True)
    config = tmp / TENANTS_CONFIG.name
    text = shallow_config(TENANTS_CONFIG).read_text()
    one = re.sub(r"(?m)^routers = 2$", "routers = 1", text)
    check(one != text, f"{TENANTS_CONFIG.name} does not set routers = 2")
    config.write_text(one + AUTOPILOT_FAULT_TOML)
    return Cli(tmp, "autopilot", "chaos", "--config", str(config), *AUTOPILOT_DRILL_ARGS)


def autopilot_phase(card: str, drill: Cli | None = None) -> dict:
    """Phase 24: the autopilot drill (started by ``start_autopilot_drill``
    when ``drill`` is None) must exit 0 with every gate of the reference's
    scripts/autopilot_drill.sh."""
    t0 = time.perf_counter()
    drill = drill or start_autopilot_drill()
    try:
        rc, text = drill.finish(timeout_s=420.0)
    finally:
        drill.kill()
    summary = json.loads(text)
    ap = summary["autopilot"]
    check(rc == 0 and summary["availability"] >= 0.97 and all(summary["gates"].values()),
          f"autopilot drill: exit {rc}, {json.dumps(summary)[:3000]}")
    hostile, victim = summary["tenants"]["hostile"], summary["tenants"]["victim"]
    out = {"card": card, "config": str(TENANTS_CONFIG.relative_to(ROOT)),
           "layers": SHALLOW_LAYERS, "exit": rc, "gates": summary["gates"],
           "victim_availability": summary["availability"], "hostile": hostile, "victim": victim,
           "first_action_s": ap["first_action_s"], "action_kinds": ap["action_kinds"],
           "actions": [{k: d.get(k) for k in ("kind", "target", "reason", "outcome")}
                       for d in ap["decisions"]],
           "rollbacks_total": ap["rollbacks_total"], "audit": summary["audit"],
           "usage": summary["usage"], "scale_state": summary["scale_state"],
           "wait_s": time.perf_counter() - t0}
    print(f"autopilot: victim availability {summary['availability']}, hostile 429 "
          f"{hostile['n_429']} {hostile['reasons']}, actions {ap['action_kinds']}, first at "
          f"{ap['first_action_s']} s", flush=True)
    return out


# -- phase 25: deferred (recycle) mode ------------------------------------------------

RECYCLE_CONFIG = ROOT / "examples" / "bert_flash_recycle.toml"
# 384 bodies of 32 texts: three epochs filled to their 4,096 rows. Every
# answer waits for its epoch's readback, so a closed loop holds its
# connections' requests in one epoch: 8 connections would carry 256 rows an
# epoch (and need 48 epochs); 128 carry 4,096, one epoch a round, and the
# queue of a stalled rotation (a dry acquire) stays under max_queue's 4,096
# texts (two of the 128 batches are admitted).
RECYCLE_REQUESTS = 384
RECYCLE_CONNS = 128
# The worker_death drill: single texts offered at 20/s for 30 s, measured
# from the first request (no warm-up), on a copy with one rule, its workers
# at SHALLOW_LAYERS. Open loop: the pool fires the rule only at an enqueue
# onto a worker that already holds a batch, and a closed loop's few texts
# per epoch can all ride one.
RECYCLE_CHAOS_ARGS = ("--model", "bert", "--duration", "30", "--warmup", "0",
                      "--rate", "20", "--min-availability", "0.99")
# Seconds from the chaos server's birth to the rule's arming: past its boot
# (two workers one after the other), so the death lands in the load's first
# seconds; at once when the boot takes longer.
RECYCLE_DEATH_AFTER_S = 35.0
# The chaos copy's breaker_threshold. One death fails every batch of its
# epoch at once, and each counts against the breaker, as in the reference;
# at the drill's 20 texts/s an epoch holds about 40 batches (2 s), a few
# more after a dry acquire's backlog, so the default of 5 would open the
# breaker on the one death the drill is there to show absorbed.
RECYCLE_CHAOS_BREAKER = 100
RECYCLE_409 = {"reload": "weight reload is not supported in recycle mode",
               "rollback": "versioned lifecycle is not supported in recycle mode",
               "versions": "versioned lifecycle is not supported in recycle mode"}


def recycle_chaos_config(tmp: Path, after_s: float) -> Path:
    """A copy of examples/bert_flash_recycle.toml at SHALLOW_LAYERS, with
    ``breaker_threshold = RECYCLE_CHAOS_BREAKER`` and one ``worker_death``
    rule: the pool's enqueue kills its active worker once, ``after_s`` after
    the server's injector is born."""
    path = tmp / "recycle_chaos.toml"
    text = shallow_config(RECYCLE_CONFIG).read_text()
    copy = text.replace('session_mode = "recycle"\n',
                        f'session_mode = "recycle"\nbreaker_threshold = {RECYCLE_CHAOS_BREAKER}\n')
    check(copy != text, f"{RECYCLE_CONFIG.name} does not set session_mode")
    path.write_text(copy + f"""
[faults]
enabled = true
seed = 1

[[faults.rule]]
kind = "worker_death"
model = "bert"
count = 1
after_s = {after_s:.1f}
""")
    return path


def recycle_pool(port: int) -> dict:
    return json.loads(call(port, "GET", "/v1/models")[1])["bert"]


def recycle_load(port: int, n: int, conns: int) -> dict:
    """``n`` 32-text bodies over ``conns`` keep-alive connections, closed
    loop: statuses, request walls, and requests/s over the run."""
    import concurrent.futures as cf
    import threading

    body = json.dumps({"texts": TEXTS_32}).encode()
    lock = threading.Lock()
    left = [n]
    statuses: list[int] = []
    walls: list[float] = []

    def client() -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            while True:
                with lock:
                    if left[0] == 0:
                        return
                    left[0] -= 1
                t = time.perf_counter()
                conn.request("POST", "/v1/models/bert:classify", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                with lock:
                    statuses.append(resp.status)
                    walls.append((time.perf_counter() - t) * 1e3)
        finally:
            conn.close()

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(conns) as pool:
        for f in [pool.submit(client) for _ in range(conns)]:
            f.result()
    wall_s = time.perf_counter() - t0
    walls.sort()
    return {"requests": n, "connections": conns, "wall_s": wall_s,
            "requests_per_s": n / wall_s, "rows_per_s": 32 * n / wall_s,
            "non_200": sum(1 for s in statuses if s != 200),
            "p50_ms": walls[len(walls) // 2], "p99_ms": walls[min(len(walls) - 1,
                                                                int(0.99 * len(walls)))]}


def recycle_drain(port: int, server: Cli, epoch_ms: float) -> dict:
    """SIGTERM with one 32-text batch far inside its epoch (sent to a warm
    worker, 0.3 s before the signal): it must answer 200 before the epoch's
    deadline (the drain retires the epoch at once), and the process exit 0."""
    import concurrent.futures as cf

    deadline = time.monotonic() + 120.0
    while recycle_pool(port)["warm"] < 1:  # a rotation's successor, booted
        check(time.monotonic() < deadline, "recycle: no warm worker within 120 s")
        time.sleep(0.2)
    with cf.ThreadPoolExecutor(1) as pool:
        t = time.perf_counter()
        fut = pool.submit(call, port, "POST", "/v1/models/bert:classify", {"texts": TEXTS_32})
        time.sleep(0.3)
        server.proc.send_signal(signal.SIGTERM)
        st, body = fut.result(timeout=120)
        wall_ms = (time.perf_counter() - t) * 1e3
    try:
        rc = server.proc.wait(120)
    except subprocess.TimeoutExpired:
        server.kill()
        raise SmokeFailure("recycle: the server did not exit within 120 s of SIGTERM")
    print(f"recycle: drain: the pending batch answered {st} in {wall_ms:.1f} ms "
          f"(epoch {epoch_ms:g} ms), exit {rc}", flush=True)
    check(st == 200 and wall_ms < epoch_ms and rc == 0,
          f"recycle drain: status {st} in {wall_ms:.1f} ms (epoch {epoch_ms:g}), exit {rc}: "
          f"{body[:300]!r}")
    return {"status": st, "wall_ms": wall_ms, "exit_code": rc}


def deferred_phase(card: str, direct: list[bytes]) -> dict:
    """Phase 25: deferred (recycle) mode, run beside phase 21 (it waits on
    worker boots, CPU work, far more than it uses the card). Serve
    examples/bert_flash_recycle.toml (full-width 12-layer BERT-flash; 2
    spawned workers, 4,096-row or 2 s epochs) and, beside it, the
    ``worker_death`` chaos drill on a copy; then: phase 6's three requests
    byte-identical to phase 6's direct server's (``direct``), K1 = 12 x
    batches summed over the workers' epochs, the server's process without
    CUDA, the 409s; 384 32-text bodies (every answer 200, >= 3 epochs), the
    rotations, dry acquires, boots, the one read per epoch and the
    latencies beside ``relay_epoch_ms``; the drain; the drill's gates."""
    t0 = time.perf_counter()
    from tpuserve_torch.config import load_config

    mcfg = load_config(str(RECYCLE_CONFIG)).model("bert")
    epoch_ms = mcfg.relay_epoch_ms
    out: dict = {"card": card, "config": str(RECYCLE_CONFIG.relative_to(ROOT)), "layers": 12,
                 "relay": {"workers": mcfg.relay_workers, "epoch_images": mcfg.relay_epoch_images,
                           "epoch_ms": epoch_ms, "slots": mcfg.relay_slots}}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    port = free_port()
    server = Cli(tmp, "recycle_serve", "serve", "--config", str(RECYCLE_CONFIG),
                 "--set", f"port={port}")
    chaos = Cli(tmp, "recycle_chaos", "chaos", "--config",
                str(recycle_chaos_config(tmp, RECYCLE_DEATH_AFTER_S)), *RECYCLE_CHAOS_ARGS)
    try:
        wait_healthy(server.proc, port, server.err_path, 6)
        out["healthy_s"] = time.perf_counter() - t0
        pool = recycle_pool(port)
        out["boot"] = pool["worker_boots"]
        # Phase 6's three requests, sent 0.2 s apart: three batches (one per
        # request, as phase 6 batches them) in one epoch.
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "recycle: reset refused")
        before = call(port, "GET", "/metrics")[1].decode()
        import concurrent.futures as cf

        objs = ({"text": "serve this text please"}, {"texts": TEXTS_8}, {"texts": TEXTS_32})
        with cf.ThreadPoolExecutor(3) as ex:
            futs = []
            for obj in objs:
                futs.append(ex.submit(call, port, "POST", "/v1/models/bert:classify", obj))
                time.sleep(0.2)
            answers = [f.result() for f in futs]
        check(all(st == 200 for st, _ in answers), f"recycle: {[(s, b[:200]) for s, b in answers]}")
        same = [body == want for (_, body), want in zip(answers, direct)]
        after = call(port, "GET", "/metrics")[1].decode()
        stats = json.loads(call(port, "GET", "/stats")[1])
        batches = metric(after, 'batches_total{model="bert"}') - metric(before, 'batches_total{model="bert"}')
        k1 = stats["kernels"]["flash_attention"]["launches"]
        print(f"recycle: healthy after {out['healthy_s']:.1f} s (workers' boots {out['boot']}); "
              f"phase 6's requests equal to the direct server's {same}; K1 {k1} over {batches:g} "
              f"batches; the server's process initialized CUDA: {stats['cuda_initialized']}",
              flush=True)
        check(all(same), f"recycle: answers differ from phase 6's direct server: {same}")
        check(batches == 3 and k1 == 12 * batches,
              f"recycle: K1 launched {k1} times for {batches:g} batches (12 per batch)")
        check(stats["kernels"]["flash_attention_stats"]["launches"] == 0, "recycle: K2 launched")
        check(stats["cuda_initialized"] is False, "recycle: the server's process initialized CUDA")
        out.update(k1_launches=k1, batches=batches, bytes_equal=same)
        for verb, (method, path) in {"reload": ("POST", "/admin/models/bert:reload"),
                                     "rollback": ("POST", "/admin/models/bert:rollback"),
                                     "versions": ("GET", "/admin/models/bert/versions")}.items():
            st, body = call(port, method, path)
            check(st == 409 and json.loads(body) == {"error": RECYCLE_409[verb]},
                  f"recycle: {path} answered {st} {body[:200]!r}")
        # Rotation under load.
        check(call(port, "POST", "/debug/kernels:reset")[0] == 200, "recycle: reset refused")
        s0 = recycle_pool(port)["stats"]
        before = call(port, "GET", "/metrics")[1].decode()
        load = recycle_load(port, RECYCLE_REQUESTS, RECYCLE_CONNS)
        after = call(port, "GET", "/metrics")[1].decode()
        pool = recycle_pool(port)
        s1 = pool["stats"]
        stats = json.loads(call(port, "GET", "/stats")[1])
        lb = metric(after, 'batches_total{model="bert"}') - metric(before, 'batches_total{model="bert"}')
        lk1 = stats["kernels"]["flash_attention"]["launches"]
        epochs = s1["epochs"] - s0["epochs"]
        rot = {"epochs": epochs, "rows": s1["rows_total"] - s0["rows_total"],
               "dry_acquires": s1["worker_respawns"] - s0["worker_respawns"],
               "prespawned": s1["workers_prespawned"] - s0["workers_prespawned"],
               "read_ms_per_epoch": 1e3 * (s1["read_s_total"] - s0["read_s_total"]) / max(1, epochs),
               "batches": lb, "k1_launches": lk1}
        out["boot"] = pool["worker_boots"]
        out["load"] = dict(load, **rot, epoch_ms=epoch_ms)
        print(f"recycle: {RECYCLE_REQUESTS} x 32 texts over {RECYCLE_CONNS} connections: "
              f"{load['requests_per_s']:.1f} requests/s, p50 {load['p50_ms']:.0f} ms, "
              f"p99 {load['p99_ms']:.0f} ms "
              f"(epoch {epoch_ms:g} ms), non-200 {load['non_200']}; {rot}; boots {out['boot']}",
              flush=True)
        check(load["non_200"] == 0, f"recycle: {load['non_200']} answers were not 200")
        check(epochs >= 3, f"recycle: {epochs} epochs under the load, expected >= 3")
        check(lk1 == 12 * lb and lb > 0, f"recycle: K1 {lk1} for {lb:g} batches under load")
        out["drain"] = recycle_drain(port, server, epoch_ms)
        rc, text = chaos.finish(timeout_s=420.0)
        summary = json.loads(text)
        deaths = sum(r["fired"] for r in summary["faults"] if r["kind"] == "worker_death")
        dstats = summary["deferred"]["bert"]
        # Held to every completion: an answer that waits out an epoch's
        # readback or a dry acquire lands after the load's window, where the
        # CLI's own availability does not look (availability_all does).
        out["chaos"] = {"exit": rc, "availability": summary["availability"],
                        "availability_all": dstats["availability_all"],
                        "n_ok": summary["n_ok"], "n_err": summary["n_err"],
                        "n_late": summary["n_late"], "n_late_err": dstats["n_late_err"],
                        "p50_ms": summary.get("p50_ms"), "p99_ms": summary.get("p99_ms"),
                        "worker_deaths": deaths, "breaker": summary["breakers"]["bert"],
                        "pool": dstats}
        print(f"recycle: worker_death drill {out['chaos']}", flush=True)
        check(rc == 0 and summary["availability"] >= 0.99 and dstats["availability_all"] >= 0.99
              and deaths == 1 and dstats["batch_retries_total"] >= 1
              and dstats["batch_retry_failures_total"] == 0
              and dstats["watchdog_restarts_total"] + dstats["worker_respawns"]
              + dstats["workers_prespawned"] >= 1,
              f"recycle: worker_death drill: exit {rc}, {json.dumps(summary)[:3000]}")
    finally:
        chaos.kill()
        server.kill()
        tmp_dir.cleanup()
    out["phase_s"] = time.perf_counter() - t0
    print(f"recycle: phase 25 took {out['phase_s']:.1f} s", flush=True)
    return out


# -- phase 26: training (finetune-det, and K1/K2 inside the LM train step) -----------

# Full-width EfficientDet-D0 fine-tuning (BASELINE.json config 4: 512 px, 90
# classes, D0 widths, bf16) on the synthetic rectangles.
DET_TRAIN_OPTS = ("image_size=512", "wire_size=512", "det_classes=90")
DET_TRAIN_STEPS = 20
DET_TRAIN_BATCH = 8
# The LM train step at BERT-base widths over a seq axis of 2 ranks on the
# card, float32: the ring's local step is K2 and Ulysses' K1 once
# auto_local_impl picks "flash" (the dense score tile 2 x 4 x b x h x s^2
# passes DENSE_SCORE_BYTES_MAX: 3.2 GB for the ring's (2, 12, 4096) tile,
# 6.4 GB for Ulysses' (2, 6, 8192)).
LM_TRAIN = dict(vocab=30522, d_model=768, n_heads=12, n_layers=2, d_ff=3072, max_seq=8192)
LM_SP = 2
LM_BATCH = 2
# The step through the kernels against the same step through their plain
# versions, both float32 (TF32 off), both with the same dense-recompute
# backward: phase 4's float32 atol (F32_TOL, on attention outputs of unit
# scale) summed over the layers, as a share of each leaf's largest gradient,
# plus 1e-3 of that share of the largest gradient of any leaf (for a leaf
# whose gradient is zero in exact arithmetic: the attention key bias).
LM_GRAD_REL = LM_TRAIN["n_layers"] * F32_TOL
LM_LOSS_REL = LM_TRAIN["n_layers"] * F32_TOL
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores, H100 SXM data sheet


@contextlib.contextmanager
def plain_kernels():
    """K1 and K2's wrapper runs the kernels' plain PyTorch versions on the
    card (counting no launch) inside the block."""
    from tpuserve_torch.ops import flash_attention as fa

    real = fa._launch

    def plain(q, k, v, bias, stats):  # noqa: ANN001, ANN202
        ref = fa.flash_attention_stats_reference if stats else fa.flash_attention_reference
        return ref(q, k, v, bias)

    fa._launch = plain
    try:
        yield
    finally:
        fa._launch = real


def det_train_cli(tmp: Path):
    """Gate 1: ``python -m tpuserve_torch finetune-det`` as a user runs it,
    at full width for 2 steps of 8 images. Starts it and returns it with a
    callable that waits for it and checks it, so the CLI runs while the
    caller works."""
    out = tmp / "det_cli.npz"
    t0 = time.perf_counter()
    cli = Cli(tmp, "finetune-det", "finetune-det", "--out", str(out), "--steps", "2",
              "--batch", str(DET_TRAIN_BATCH), *(a for o in DET_TRAIN_OPTS for a in ("--opt", o)))
    return cli, lambda: det_train_cli_finish(cli, out, t0)


def det_train_cli_finish(cli, out: Path, t0: float) -> dict:  # noqa: ANN001
    rc, text = cli.finish(timeout_s=300.0)
    wall = time.perf_counter() - t0
    check(rc == 0, f"finetune-det exited {rc}: {cli.err_path.read_text()[-2000:]}")
    line = json.loads(text.strip().splitlines()[-1])
    check(line.get("checkpoint") == str(out) and math.isfinite(line["final_loss"])
          and out.exists(), f"finetune-det printed {line}")
    return {"wall_s": wall, "final_loss": line["final_loss"]}


def det_train_in_process(tmp: Path) -> dict:
    """Gate 2: ``finetune_detector`` in process for ``DET_TRAIN_STEPS`` steps;
    each step timed (synchronised) and its loss read. Returns the numbers,
    the trainer's final state and the checkpoint it wrote."""
    import torch

    from tpuserve_torch import train_det as td
    from tpuserve_torch.config import ModelConfig

    cfg = ModelConfig(name="efficientdet", family="efficientdet", image_size=512,
                      wire_size=512, options={"det_classes": 90})
    records, held = [], {}
    real = td.make_det_train_step

    def timed_step(serving, state, tcfg):  # noqa: ANN001, ANN202
        step = real(serving, state, tcfg)
        held.update(serving=serving, state=state)

        def run(batch):  # noqa: ANN001, ANN202
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(batch)
            value = float(loss)            # waits for the step
            records.append((time.perf_counter() - t0, value))
            return loss

        return run

    out = tmp / "det.npz"
    torch.cuda.reset_peak_memory_stats()
    td.make_det_train_step = timed_step
    try:
        final = td.finetune_detector(cfg, str(out), steps=DET_TRAIN_STEPS,
                                     batch_size=DET_TRAIN_BATCH, log_every=5)
    finally:
        td.make_det_train_step = real
    peak = torch.cuda.max_memory_allocated()
    losses = [v for _, v in records]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(len(losses) == DET_TRAIN_STEPS and all(map(math.isfinite, losses)) and last < first,
          f"finetune_detector: the loss did not fall over {DET_TRAIN_STEPS} steps: {losses}")
    steady = sorted(t for t, _ in records[2:])
    step_ms = 1e3 * steady[len(steady) // 2]
    return {"out": out, "cfg": cfg, **held, "numbers": {
        "steps": DET_TRAIN_STEPS, "batch": DET_TRAIN_BATCH, "losses": losses,
        "final_loss": final, "mean_first5": first, "mean_last5": last,
        "first_step_ms": 1e3 * records[0][0], "step_ms_median": step_ms,
        "images_per_s": DET_TRAIN_BATCH / step_ms * 1e3, "peak_allocated_mib": peak / 2**20}}


def det_train_serves(run: dict) -> dict:
    """Gate 3: the written ``.npz`` passes its manifest, loads through the
    port's loader into a runtime with bucket (8,), and its replayed heads
    and detections match the trainer's final parameters run eagerly in the
    same dtype (phase 14's logit rule, RESNET_LOGIT_REL of the scale)."""
    import dataclasses

    import torch

    from tpuserve_torch import savedmodel
    from tpuserve_torch import train_det as td
    from tpuserve_torch.models import build
    from tpuserve_torch.runtime import build_runtime

    out, serving, state = run["out"], run["serving"], run["state"]
    tree = savedmodel.load_npz(str(out))
    check(savedmodel.verify_manifest_if_present(str(out), tree, require=True),
          "finetune_detector's checkpoint has no manifest")
    # score_thresh 0: every slot NMS keeps is a detection, so the count and
    # classes compared are max_dets' worth, not the few that pass 0.05.
    model = build(dataclasses.replace(run["cfg"], name="det_ft", weights=str(out),
                                      batch_buckets=[8],
                                      options=dict(run["cfg"].options, score_thresh=0.0)))
    rt = build_runtime(model, device="cuda")
    batch = td.synthetic_det_batch(8, 512, 512, 90, 16, seed=1000)
    dev = rt.h2d((8,), (batch["images"],))
    with torch.inference_mode():
        served = rt.dispatch((8,), dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):                     # warm-up before the capture
                model.logits(rt.module, dev)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            heads = model.logits(rt.module, dev)
        graph.replay()
        cls_t, box_t = td.det_logits(serving, state, batch["images"])
        eager = model.detect(cls_t, box_t)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in (("class_logits", heads[0], cls_t), ("box_regression", heads[1], box_t)):
        err = (a - b).abs().max().item()
        tol = RESNET_LOGIT_REL * b.abs().max().item()
        check(bool(torch.isfinite(a).all()) and err <= tol,
              f"finetune-det checkpoint: replayed {name} vs the trainer's eager differ by "
              f"{err:.4g} > {tol:.4g}")
        errs[name] = {"max_abs_diff": err, "tol": tol}
    n_served, n_eager = served["n"].tolist(), eager["n"].tolist()
    same_classes = all(served["classes"][i, :n].tolist() == eager["classes"][i, :n].tolist()
                       for i, n in enumerate(n_served))
    check(n_served == n_eager and same_classes,
          f"finetune-det checkpoint: served detections {n_served} vs the trainer's {n_eager}")
    errs["detections_per_image"] = n_served
    del rt
    torch.cuda.empty_cache()
    return errs


def lm_train_step(kind: str) -> dict:
    """Gate 4: one ``make_train_step`` step with ``seq_attention=kind`` on a
    sp = 2 mesh whose ranks share the card: the kernels' launches, and the
    loss and every gradient leaf against the same step through the plain
    versions (``plain_kernels``)."""
    import torch

    from tpuserve_torch import train as pt
    from tpuserve_torch.ops import flash_attention as fa
    from tpuserve_torch.ops.ring_attention import auto_local_impl
    from tpuserve_torch.parallel.mesh import MeshPlan, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = pt.TrainConfig(**LM_TRAIN, seq_attention=kind)
    h, s = cfg.n_heads, cfg.max_seq
    local = (auto_local_impl(LM_BATCH, h, s // LM_SP, 64) if kind == "ring"
             else auto_local_impl(LM_BATCH, h // LM_SP, s, 64))
    check(local == "flash", f"train step {kind}: auto_local_impl picked {local!r}")
    mesh = make_mesh(MeshPlan(sp=LM_SP), devices=["cuda:0"] * LM_SP)
    state = pt.make_train_state(mesh, cfg, seed=0)
    step = pt.make_train_step(state)
    batch = pt.synthetic_batch(cfg, LM_BATCH, seed=0)

    def timed(fn):  # noqa: ANN001, ANN202
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0), torch.cuda.max_memory_allocated() / 2**20

    with plain_kernels():
        (loss_p, grads_p), plain_ms, plain_peak = timed(lambda: pt.loss_and_grads(state, batch))
    fa.reset_launches()
    (loss_k, grads_k), step_ms, peak = timed(lambda: step(batch, with_grads=True))
    launches = {"k1": fa.launches, "k2": fa.stats_launches}
    want = ({"k1": 0, "k2": cfg.n_layers * LM_SP * LM_SP} if kind == "ring"
            else {"k1": cfg.n_layers * LM_SP, "k2": 0})
    check(launches == want, f"train step {kind}: launches {launches}, predicted {want}")
    _, step2_ms, _ = timed(lambda: step(pt.synthetic_batch(cfg, LM_BATCH, seed=1)))
    loss_err = abs(float(loss_k) - float(loss_p))
    check(math.isfinite(float(loss_k)) and loss_err <= LM_LOSS_REL * abs(float(loss_p)),
          f"train step {kind}: loss {float(loss_k)} vs plain {float(loss_p)}")
    top = max(g.abs().max().item() for g in grads_p.values())
    worst = {"share_of_tol": 0.0}
    for name, gp in grads_p.items():
        gk = grads_k[name]
        err, scale = (gk - gp).abs().max().item(), gp.abs().max().item()
        tol = LM_GRAD_REL * scale + LM_GRAD_REL * 1e-3 * top
        check(bool(torch.isfinite(gk).all()) and err <= tol,
              f"train step {kind}: gradient {name} differs by {err:.3g} > {tol:.3g}")
        if err / tol > worst["share_of_tol"]:
            worst = {"leaf": name, "max_abs_diff": err, "scale": scale, "tol": tol,
                     "share_of_tol": err / tol}
    out = {"kind": kind, "local_step": local, "launches": launches, "loss": float(loss_k),
           "loss_plain": float(loss_p), "loss_abs_diff": loss_err, "worst_grad": worst,
           "grad_tol_rel": LM_GRAD_REL, "step_ms_first": step_ms, "step_ms_second": step2_ms,
           "plain_loss_and_grads_ms": plain_ms, "peak_allocated_mib": peak,
           "plain_peak_allocated_mib": plain_peak}
    del state, step, grads_k, grads_p
    torch.cuda.empty_cache()
    return out


def training_phase(card: str) -> dict:
    """Phase 26: training, in a process of its own beside phases 19, 15 and
    18 (gates 1-4 of ``det_train_cli``, ``det_train_in_process``,
    ``det_train_serves`` and ``lm_train_step``; the CLI's process runs
    beside the in-process gates)."""
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="smoke-train-"))
    cli, cli_done = det_train_cli(tmp)      # the CLI's process runs beside the rest
    try:
        out = {"card": card}
        run = det_train_in_process(tmp)
        out["det"] = run["numbers"]
        out["det"]["checkpoint_serves"] = det_train_serves(run)
        del run
        out["lm"] = {kind: lm_train_step(kind) for kind in ("ring", "ulysses")}
        out["cli"] = cli_done()
    finally:
        cli.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    det, lm = out["det"], out["lm"]
    print(f"training: finetune-det CLI {out['cli']['wall_s']:.1f} s; {det['steps']} full-width "
          f"bf16 steps of {det['batch']} at 512 px: loss {det['mean_first5']:.4f} -> "
          f"{det['mean_last5']:.4f} (means of the first and last 5), step {det['step_ms_median']:.1f} ms "
          f"({det['images_per_s']:.1f} images/s), peak {det['peak_allocated_mib']:.0f} MiB; the "
          f".npz serves (heads {det['checkpoint_serves']['class_logits']['max_abs_diff']:.3g}, "
          f"{det['checkpoint_serves']['box_regression']['max_abs_diff']:.3g}); LM step ring "
          f"{lm['ring']['step_ms_second']:.1f} ms (K2 x{lm['ring']['launches']['k2']}, peak "
          f"{lm['ring']['peak_allocated_mib']:.0f} MiB), ulysses {lm['ulysses']['step_ms_second']:.1f} ms "
          f"(K1 x{lm['ulysses']['launches']['k1']}, peak {lm['ulysses']['peak_allocated_mib']:.0f} MiB); "
          f"phase 26 took {out['phase_s']:.1f} s beside phases 19, 15 and 18; {card}", flush=True)
    return out


def train_kernel_rows() -> dict:
    """K2 and K1 at the LM train step's shapes (float32: K2 at the ring's
    (2, 4096, 12, 64) local block, K1 at Ulysses' (2, 8192, 6, 64)), with
    the card to itself: each against its plain version, timed beside its
    plain version, its bound and its library yardstick."""
    import torch

    from tpuserve_torch.ops import flash_attention as fa

    rows = {}
    for name, (b, s, h, d) in (("k2", (LM_BATCH, LM_TRAIN["max_seq"] // LM_SP, 12, 64)),
                               ("k1", (LM_BATCH, LM_TRAIN["max_seq"], 12 // LM_SP, 64))):
        q, k, v, _ = qkv(b, s, s, h, d, torch.float32, seed=26)
        bias = torch.zeros(b, s, device="cuda")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if name == "k2":
            errs = compare_stats(q, k, v, bias)
            err = max(errs["acc"], errs["m"], errs["l"])
            fn = lambda: fa.flash_attention(q, k, v, bias, return_stats=True)  # noqa: E731
            plain = lambda: fa.flash_attention_stats_reference(q, k, v, bias)  # noqa: E731
            bias4 = bias[:, None, None, :].expand(b, h, s, s)
            library = lambda: efficient_attention_lse(qt, kt, vt, bias4)  # noqa: E731
            out_bytes = b * s * h * d * 4 + 2 * b * s * h * 4          # acc, m, l
        else:
            err = compare(q, k, v, bias)
            fn = lambda: fa.flash_attention(q, k, v, bias)  # noqa: E731
            plain = lambda: fa.flash_attention_reference(q, k, v, bias)  # noqa: E731
            library = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
            out_bytes = b * s * h * d * 4
        ms = time_calls(fn, iters=10)["device_ms"]
        plain_ms = time_ms(plain, iters=3)
        library_ms = time_ms(library, iters=10)
        nbytes = 3 * b * s * h * d * 4 + b * s * 4 + out_bytes
        flops = 4 * b * h * s * s * d
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
        rows[name] = {"name": "flash_attention_stats" if name == "k2" else "flash_attention",
                      "route": "cuda", "source": "tpuserve_torch/ops/csrc/flash_attention.cu",
                      "replaces": "tpuserve/ops/flash_attention.py:"
                                  + ("106" if name == "k2" else "96"),
                      "shape": [b, s, h, d], "dtype": "float32", "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"kernels: {name.upper()} at the train step's {(b, s, h, d)} float32: "
              f"{ms:.3f} ms (plain {plain_ms:.3f}, library {library_ms:.3f}, bound "
              f"{rows[name]['bound_ms']:.4f} {rows[name]['bound_by']}), max abs err {err:.3g}",
              flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if PHASES_FLAG not in sys.argv[1:]:
        return supervise()
    if "--only" in sys.argv:
        name, label, tmp, t_start = sys.argv[sys.argv.index("--only") + 1:][:4]
        return run_apart(name, label, Path(tmp), float(t_start))
    import concurrent.futures as cf
    import faulthandler

    import torch

    faulthandler.enable()  # a crash of the phases' process prints its stacks
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "tpuserve_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: FAIL: no tpuserve_torch package beside {Path(__file__).name}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    adopt_orphans()
    left: dict[int, str] = {}
    try:
        card = card_line()
        print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
              f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        build = timed("2 (build)", build_kernels)
        k1 = timed("3", kernel_phase)
        k2 = timed("4", stats_kernel_phase)
        sp_errs = timed("5", sequence_parallel_phase)
        run = timed("6", slice_phase)
        long = timed("7", long_slice_phase)
        vision = timed("8", resnet_phase)
        # Side by side (the smoke's time limit): a phase that only drives
        # servers and subprocesses (9, 12, 16, 18, 21, 25) runs beside one
        # that works on the card in this process (5b, 15, 17, 20's served
        # part), never two of the latter in one process (phases 19, 26, 5c
        # and 5d run in processes of their own beside 15), and never beside a phase whose
        # gates are on time (8, 10, 11, 13, 14) or whose kernel timings the
        # kernels line reports (3, 4, 5b's and 20's K1 rows, timed alone).
        # Phase 9's two drills run side by side too.
        with cf.ThreadPoolExecutor(2) as beside:
            cost_run = beside.submit(timed, "12", defaults_cost_phase, card)
            mesh_run = beside.submit(timed, "5b", mesh_phase, card)
            try:
                lifecycle = timed("9", lifecycle_phase)
            finally:
                cost = cost_run.result()
                mesh = mesh_run.result()
        mesh["k1"] = timed("5b (K1 timings)", mesh_k1_phase)
        robustness = timed("10", robustness_phase)
        observability = timed("11", observability_phase, card)
        mnv3 = timed("13", mobilenet_phase, card)
        det = timed("14", efficientdet_phase, card)
        with cf.ThreadPoolExecutor(1) as beside:
            cli_future = beside.submit(timed, "16", cli_phase, card)
            try:
                textgen = timed("17", textgen_phase, card)
            finally:
                cli_run = cli_future.result()
        # Phases 19, 26, 5c and 5d train or serve on the card in processes
        # of their own; 15 and 18 run here meanwhile, and 26, 5c and 5d end
        # before 19 does.
        moe_run = Apart("19", moe_phase, card)
        train_run = Apart("26", training_phase, card)
        axes_run = Apart("5c", mesh_axes_phase, card)
        sd_mesh_run = Apart("5d", mesh_sd_phase, card)
        try:
            with cf.ThreadPoolExecutor(1) as beside:
                stream_run = beside.submit(timed, "18", streaming_phase, card,
                                           textgen["served"]["bench"]["tokens_per_s"])
                try:
                    int8c = timed("15", int8c_phase, card)
                finally:
                    stream = stream_run.result()
        finally:
            try:
                moe = moe_run.result()
            finally:
                try:
                    training = train_run.result()
                finally:
                    try:
                        mesh["axes"] = axes_run.result()
                    finally:
                        mesh["sd"] = sd_mesh_run.result()
        sd_prepared = timed("20 (K1 timings, checkpoint)", sd15_prepare, card)
        with cf.ThreadPoolExecutor(2) as beside:
            deferred_run = beside.submit(timed, "25", deferred_phase, card,
                                         run["direct_bodies"])
            router_run = beside.submit(timed, "21", router_phase, card)
            try:
                sd = timed("20", sd15_phase, sd_prepared)
            finally:
                deferred = deferred_run.result()
                router = router_run.result()
        training["kernels"] = timed("26 (K1/K2 timings)", train_kernel_rows)
        drills: dict = {}
        drill_tmp = ROOT / "build" / "smoke" / "fleet"
        drill_tmp.mkdir(parents=True, exist_ok=True)

        def start_fleet() -> None:
            drills["fleet"] = start_fleet_drill(drill_tmp)

        def fleet_and_tenants() -> dict:
            # Phase 24's drill serves its own fleet beside phase 23's.
            drills["autopilot"] = start_autopilot_drill()
            return fleet_phase(card, run["direct_bodies"], drills["fleet"])

        try:
            hosts, fleet = timed("22-23", hosts_phase, card, start=start_fleet,
                                 meanwhile=fleet_and_tenants)
            autopilot = timed("24", autopilot_phase, card, drills["autopilot"])
        finally:
            for drill in drills.values():
                drill.kill()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        stop_prestarted()
        t_sweep, running = time.perf_counter(), len(descendants())
        left = stop_descendants()
        print(f"smoke: {running} processes below the smoke after the last phase; "
              f"{running - len(left)} ended on their own within "
              f"{time.perf_counter() - t_sweep:.1f} s, {len(left)} killed", flush=True)
    if left:
        print("chip_smoke: FAIL: processes still running "
              f"{ORPHAN_GRACE_S:g} s after the last phase (killed): "
              + "; ".join(f"{pid} {cmd}" for pid, cmd in left.items()), file=sys.stderr)
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
    det_graphs = det["model"].pop("graphs")
    robustness["first_request_efficientdet"] = det.pop("first_request")
    print(json.dumps({"slice": dict(det, path="efficientdet",
                                    config=str(DET_CONFIG.relative_to(ROOT)))}))
    tg_k1 = textgen.pop("kernels")
    tg_kernels = {f"k1_b{b}_s256": tg_k1[b]["line"] for b in (1, 32)}
    print(json.dumps({"slice": dict(textgen, path="textgen", **tg_kernels)}))
    print(json.dumps({"slice": dict(stream, path="textgen_stream")}))
    print(json.dumps({"slice": dict(moe["textgen"], path="textgen_moe", card=card,
                                    config=moe["configs"][0])}))
    print(json.dumps({"slice": dict(moe["bert"], path="bert_moe", card=card,
                                    config=moe["configs"][1], phase_s=moe["phase_s"])}))
    sd_k1 = sd.pop("kernels")
    print(json.dumps({"slice": dict(sd, path="sd15", **{
        f"k1_b{b}_s{n}": row["line"] for (b, n), row in sd_k1.items()})}))
    print(json.dumps({"slice": dict(int8c, path="int8c", configs=[
        str(CONFIG.relative_to(ROOT)), str(RESNET_CONFIG.relative_to(ROOT))])}))
    # The runtime's graphs against the eager forward, and the host time of
    # the served h2d stage, per path; then the lifecycle drills.
    print(json.dumps({"graphs": {"bert_flash": run["graphs"], "bert_long_ring": long["graphs"],
                                 "resnet50": vision_graphs, "mobilenetv3": mnv3_graphs,
                                 "efficientdet": det_graphs}}))
    # Phase 5d's K1 launches at SD's split shapes, on the rows 5b timed.
    for key, n in mesh["sd"]["k1_launches"].items():
        mesh["k1"][key]["line"]["launches"] = n
    print(json.dumps({"mesh": mesh}, default=str))
    print(json.dumps({"lifecycle": lifecycle}))
    print(json.dumps({"robustness": robustness}))
    print(json.dumps({"observability": observability}))
    print(json.dumps({"defaults_cost": cost}))
    # The CLI's runs; the startup probe's raw (32, 128) forward (at
    # SHALLOW_LAYERS layers) beside the replay device time graph_phase took of
    # the same bucket at 12.
    probe = cli_run["bert"]["roofline"]["raw_ms_per_batch"]["[32, 128]"]
    replay = run["graphs"]["bert"]["replay_device_ms"]
    cli_run["probe_vs_replay_b32_s128"] = {f"probe_raw_ms_{SHALLOW_LAYERS}_layers": probe,
                                           "replay_device_ms_12_layers": replay}
    print(json.dumps({"cli": cli_run}))
    print(json.dumps({"router": router}))
    print(json.dumps({"hosts": hosts}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"autopilot": autopilot}))
    deferred["load"]["direct_requests_per_s_4_layers"] = \
        router["direct"]["bench"]["summary"]["throughput_per_s"]
    print(json.dumps({"deferred": deferred}))
    print(json.dumps({"training": {k: v for k, v in training.items() if k != "kernels"}}))
    # K1's launches on the main path (BERT-flash), on the int8c one, on
    # textgen's (12 per insert, none per decode step), streamed and unary,
    # and on the Switch-MoE paths (textgen's inserts, BERT-flash's batches).
    print(json.dumps({"kernels": [dict(k1[128]["line"], launches=run["launches"],
                                       launches_int8c_4_layers=int8c["bert_launches_k1"],
                                       launches_cli_bench_4_layers={
                                           k: r["k1_launches"]
                                           for k, r in cli_run["bert"]["runs"].items()},
                                       launches_textgen=textgen["served"]["k1_launches"],
                                       launches_textgen_stream=stream["k1_launches"],
                                       launches_textgen_stream_bench=stream["bench"][
                                           "k1_launches"],
                                       launches_textgen_moe=moe["textgen"]["k1_launches"],
                                       launches_bert_moe=moe["bert"]["launches"],
                                       launches_sd15=sd["locked"]["k1_launches"],
                                       launches_sd15_engine=sd["engine"]["k1_launches"],
                                       launches_router_4_layers=router["k1_launches"],
                                       launches_router_bench_4_layers={
                                           n: f["bench"]["k1_launches"]
                                           for n, f in router["fleets"].items()},
                                       launches_hosts_4_layers=hosts["k1_launches"],
                                       launches_hosts_bench_4_layers=hosts["fleet"]["bench"][
                                           "k1_launches"],
                                       launches_fleet_first_warm=fleet["k1_launches"][
                                           "first_warm"],
                                       launches_fleet_rewarm=fleet["k1_launches"]["rewarm"],
                                       launches_fleet_drill=fleet["k1_launches"]["drill"],
                                       launches_recycle=deferred["k1_launches"],
                                       launches_recycle_load=deferred["load"]["k1_launches"],
                                       launches_train_ulysses=training["lm"]["ulysses"][
                                           "launches"]["k1"]),
                                  dict(k2["line"], launches=long["k2_launches"],
                                       launches_train_ring=training["lm"]["ring"]["launches"][
                                           "k2"],
                                       launches_mesh_ring_data2_seq2_b16_s4096=mesh["axes"][
                                           "bert"]["ring_data2_seq2"]["k2_by_shape"]),
                                  # K2 and K1 at the LM train step's shapes (phase 26),
                                  # with their launches in one step.
                                  dict(training["kernels"]["k2"],
                                       launches=training["lm"]["ring"]["launches"]["k2"]),
                                  dict(training["kernels"]["k1"],
                                       launches=training["lm"]["ulysses"]["launches"]["k1"]),
                                  # K1 at the mesh modes' shapes (phase 5b): sharded
                                  # rows, tensor-parallel heads, pipeline microbatches,
                                  # Ulysses' local step on model 2 x seq 2.
                                  *(row["line"] for row in mesh["k1"].values()),
                                  # K1 at SD 1.5's padded shapes, with the launches counted
                                  # at each shape: 2 rows on the locked path, 16 in the
                                  # engine's step.
                                  *(dict(row["line"], launches=sd[
                                      "locked" if b == 2 else "engine"]["k1_by_shape"][
                                      sd_shape_key(b, n)]) for (b, n), row in sd_k1.items())]}))
    print(f"smoke: the whole smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

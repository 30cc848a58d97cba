#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device, ``nvcc`` (``/usr/local/cuda`` or ``CUDA_HOME``) and no
network.  Nine LM serving paths, each a registered configuration at
full width with seeded random weights, the micro models of the real
plane, full-width gemma3-1b training, and the kernels each one runs:

* gemma3-1b — ``flash_attention`` (prefill), ``decode_attention`` (decode);
* mamba2-130m — ``ssd_scan`` (prefill);
* recurrentgemma-9b — ``rglru_scan`` (prefill) and, in its local
  attention layers, ``flash_attention`` and ``decode_attention``;
* deepseek-v2-236b — no kernel: multi-head latent attention (blocked
  prefill attention, absorbed latent decode) and the capacity-tile MoE
  are plain PyTorch, as the reference has no Pallas kernel there.  Depth
  is cut to the dense MLA prefix layer and 2 of 59 MLA_MOE repeats
  (:data:`CUT`): ~9.3B parameters, 18.7 GB in bf16 and 37 GB in fp32,
  where 59 repeats would be ~470 GB;
* seamless-m4t-medium — an encoder-decoder over precomputed audio
  frames: ``flash_attention`` and ``decode_attention`` in its 12
  decoder layers' self-attention (16 heads on 16, head dim 64); its 12
  encoder layers and the decoder's cross-attention run blocked
  attention, as in the reference;
* internvl2-1b — 256 precomputed patch embeddings in front of the text,
  24 attention layers through ``flash_attention`` and
  ``decode_attention`` at head dim 64 and a GQA group of 7 (14 heads on
  2);
* stablelm-12b, llama3-8b and minitron-8b — dense decoders of 32 query
  heads on 8 KV heads, whole (40, 32 and 32 layers; ~12.1B, ~8.0B and
  ~7.7B parameters), through ``flash_attention`` and
  ``decode_attention`` on the tensor cores: stablelm-12b at head dim
  160 (LayerNorm, 25% partial rotary, per-head qk-norm), the other two
  at 128 (llama3-8b: RMSNorm, SwiGLU; minitron-8b: LayerNorm, 50%
  partial rotary, a squared-ReLU MLP);
* attn-tiny — ``flash_attention`` on its short route (fp32, head dim
  16, S = 16, 8 and 4, unpadded on the card); mlp-tiny and mlp run no
  kernel of the port;
* lm-tiny, the launcher's LM model (reduced gemma3-1b in fp32: 6
  attention layers, 2 query heads on 1 KV head of 16) —
  ``flash_attention`` on its short route (prefill at bucket 16) and
  ``decode_attention`` on the CUDA cores (64-slot caches).

Phases, each printing JSON lines (each ``model``, ``trace`` and
``serve`` line with its ``seconds``); any failure raises and the script
exits non-zero:

1. **build** — compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) into ``build/kernels``.
2. **kernels** — each kernel against its plain PyTorch version on the
   card, fp32 and bf16: the shape grids of ``tests/test_kernels.py``,
   head dim 8, GQA groups 1-16, windows, partial tiles, a single chunk,
   attn-tiny's shapes (fp32, 2 heads of 16, S = 16, 8 and 4 at B = 1,
   16 and 256, which the wrapper passes unpadded to the short route;
   there the unpadded call must equal the call padded to 16 bit for
   bit), and the serving shapes of the LM paths at B = 1
   and 4 (head dim 64 at 16 heads on 16 and 14 on 2 for seamless-m4t-
   medium and internvl2-1b; 32 heads on 8 at head dim 160 for
   stablelm-12b, causal and windowed, and 128 for llama3-8b and
   minitron-8b, and at both the pair kernel's edges (129, 257 and 1000
   positions at B = 1 and 3, causal and windowed, and the model checks'
   1024); decode at head dim 160 with each cluster size forced,
   over 1024 and 4096 slots, and over stablelm-12b's model check's 2048;
   flash in fp32 at its 1024-position prompt; decode also at B = 8 and
   at the serve phase's cache lengths; decode lengths of 0, 1, one
   split, one split + 1 and S, where a row of length 0 must be 0 as
   from the TPU kernel; lm-tiny's decode at B = 1, 2, 4, 8 over 64
   slots at head dim 16 and 8; GQA groups 17 and 32; the tensor-core
   decode's cluster kernel at lengths 0, 1, 5, 100 and S at every head
   dim and over 4096 slots,
   where its ranks loop over tiles; flash in fp32 at the model checks'
   prompts (1000 positions at head dim 64, 2100 at recurrentgemma-9b's
   window); an SSD chunk of 40, which the CUDA-core scan pads to 16-row
   pieces; RG-LRU partial chunks and column tiles).  ``decode_attention``
   and ``ssd_scan`` have two routes each (CUDA cores, tensor cores for
   bf16), ``flash_attention`` three (and the short route for fp32 with
   Sq, Sk <= 16): every case runs through the public wrapper and through
   each route that takes it, forced, and the wrapper's choice by shape
   must match the Python route rule bit for bit; ``rglru_scan`` has one
   kernel, the chunked scan.  Tolerances are ``tests/test_kernels.py``'s (atol = rtol =
   2e-5 fp32, 2e-2 bf16); the scans' final states are compared too, and
   the fp32 SSD kernel is held against the sequential recurrence in fp64
   (in fp32 it strays past 2e-5 from that at B = 4).  Times
   at the serving shapes: the wrapper and each route, its plain version,
   one PyTorch library call computing the same function where there is
   one (``scaled_dot_product_attention``, a yardstick the port never
   calls; no single call computes either scan) and the card's bound for
   the work.  ``time_ms`` times the device alone: a sleep kernel holds
   the device while the host queues the whole batch, so ``ms`` is not the
   host's cadence, which ``host_ms`` reports beside it.  The same timing
   of an empty kernel (``torch.cuda._sleep(0)``) is the per-launch floor
   of ``ms``; each route's kernel duration from ``torch.profiler`` is
   printed beside its ``ms`` at the timed shapes.  For each SSD route at
   the serving shapes the profiler's kernel records per call must equal
   the launches the wrapper counted, and ``kernels_per_call`` (one
   cluster launch on the tensor cores, three passes on the CUDA cores);
   the tensor cores' cluster size and the clusters of that size the card
   holds at once (``ssd_scan_tc_cluster``,
   ``ssd_scan_max_active_clusters``) are printed per timed shape; for
   each decode route the launches counted
   must be one a call on the tensor cores (the cluster merges on chip)
   and two past one split on the CUDA cores, and the profiler's records
   per call, rounded, the same.  The clusters of each size the card
   holds at once (``decode_attention_max_active_clusters``) are
   printed.  The bf16 SSD also runs at 16 chunks over 6144
   blocks.  The blocks a SM that the footprint of the SSD's
   CUDA-core chunk scan allows (the occupancy calculator) are printed,
   and must be two.  ptxas must report no spill in any instance of
   flash's tensor-core kernels.
3. **model** — per path, one prompt and 8 decode steps through the
   kernels against the same weights through the plain path: gemma3-1b
   1024 tokens (past its 512-token window, so the ring cache rolls),
   mamba2-130m 1000 tokens (not a chunk multiple, so the dt = 0 padding
   runs), recurrentgemma-9b 2100 tokens (past its 2048-token window)
   into a 4096-slot cache, seamless-m4t-medium a 1000-token decoder
   prompt over 2048 encoder frames (the encoder on blocked attention's
   tiled path; 1000 is no multiple of the flash wrapper's 512-row block,
   so its padding runs) and internvl2-1b 256 patches + 744 tokens, both
   into 2048 slots; stablelm-12b, llama3-8b and minitron-8b 1024 tokens
   into 2048 slots (fp32 ~48.6, ~32 and ~31 GB, one dtype on the card at
   a time; ``param_count`` on each line).  Each prompt batch carries the
   inputs
   ``input_specs`` names, seeded.  fp32 logits must agree to 1e-3 of
   their largest magnitude (summation order only); in bf16 the kernel path
   must stay within twice the plain bf16 path's distance from the fp32
   logits (floor 2e-2).  deepseek-v2-236b has no kernel, so its check
   holds a 512-token prefill (1024 slots) and 8 absorbed decode steps
   against a full-sequence ``forward`` over the same tokens (expanded
   attention): fp32 within 1e-3, bf16 within twice the bf16 forward's
   distance from the fp32 forward (floor 2e-2).  Its MoE is made
   dropless for the check (capacity factor :data:`DROPLESS_CF` ≥ E /
   top_k): a forward over S + 8 tokens and a prefill over S would
   otherwise drop different assignments.
   **moe** — deepseek-v2-236b's MoE at full width and the published
   capacity factor 1.25: ``moe_dispatch_indices`` on the card equals
   its CPU result bit for bit for the same router output (T = 2048, the
   serve prefill; the same tokens pushed toward one expert, which must
   drop; T = 4), and prints the drops; two ``apply_moe`` calls on one
   input are bit-identical (the combine uses no atomics), and each is
   timed at the serve prefill (4 × 512 tokens) and a B = 4 decode step.
   **distributed** — the port's distribution layer (no kernel: the
   reference's sharded steps, EP and compression are plain jnp):
   * full-width gemma3-1b's bf16 prefill (a 64-token prompt) with its
     parameters and prompt laid out by ``params_pspecs`` and
     ``batch_pspecs`` as DTensors on a (1, 1) ("data", "model") mesh of
     a one-rank NCCL group, its cache built laid out by
     ``cache_pspecs``, then 4 decode steps from that DTensor cache:
     logits and every cache leaf bit for bit the plain steps';
   * two full-width gemma3-1b train steps (B = 2, S = 512) on that mesh
     with the moments laid out by ``optimizer_pspecs`` (ZeRO): loss,
     parameters and moments bit for bit the plain steps', every layout
     kept; the peak device memory;
   * ``compressed_psum`` over that group on a fp32 tree of gemma3-1b's
     parameter shapes (999,885,952 values, 4 GB): bit for bit the card's
     own quantize → dequantize, whose quantization is the CPU's on a
     2^20-value slice; its device time beside the bound (8 bytes a
     value at the HBM rate);
   * expert parallelism: :data:`EP_RANKS` processes with a gloo group
     (NCCL refuses two ranks on one device), each holding 40 of
     deepseek-v2-236b's 160 routed experts at full width in fp32 (3.8
     GB), run ``apply_moe_ep`` on B = 4 × S = 512 tokens over a mesh of
     4 "model" ranks: dropless (:data:`DROPLESS_CF`) within 1e-5 of
     the largest |y| of one process's ``apply_moe`` on the whole layer
     (15.1 GB); at the published 1.25, on tokens pushed toward expert 0,
     some assignments drop and each rank's dispatch (kept set, slots,
     gates) equals the CPU's for the same router output.  gloo carries
     the tensors through the host, so the times say nothing about EP
     over NVLink.
   **profile** — the analytic profiler (``launch/profile_gpu.py``) on
   full-width gemma3-1b's decode step at t = 1 (the plain step, kernels
   off) and b = 1, 4 and 16 over 8192 cache slots: ``program_cost`` on
   meta tensors equals the same count on the card's tensors (FLOPs,
   HBM bytes, device ops, argument, temporary, output and aliased
   bytes; an op that dispatches otherwise is named); the counted device
   ops beside the profiler's launch calls and kernel records of the same
   step; the argument bytes equal to the bytes of the parameters and
   cache resident on the card; the predicted peak beside
   ``max_memory_allocated``; ``GPUPackratProfiler``'s L(1, b) beside the
   step's wall and device-busy time.
4. **trace** — per path, where a full-width bf16 step spends its time:
   one 512-token prefill and 4 decode steps at batch 1, traced with
   ``torch.profiler``: wall time, host time to enqueue, device busy time,
   the device's idle share, CUDA launches and the top device kernels.
5. **serve** — the main path, per configuration: the full-width bf16
   ``LmEngine`` behind ``RealPlane`` (its prompts carry the inputs
   ``input_specs`` names: 512 frames and 512 tokens for
   seamless-m4t-medium, 256 patches and 256 tokens for internvl2-1b),
   per-phase profiles, then ``run_lm_policy`` for ``static`` and
   ``packrat`` over a seeded steady-poisson trace.  Every prompt must complete, every kernel of the
   path must launch, each only on the route ``PATHS`` requires for it
   (the tensor cores for the attention kernels and ``ssd_scan``, the
   chunked RG-LRU scan), no other kernel may launch, and no wrapper may
   take its CPU route.  The launch counts (by route) are reset just
   before each path and read just after it; so are the SSD's and
   decode's and flash's calls by shape, and after the last path each is
   timed at every shape the paths called it with (the ``ssd_shapes``,
   ``decode_shapes`` and ``flash_shapes`` phases; decode on both routes
   with :data:`DECODE_VALID` valid rows, and each route's total over the
   calls; decode and flash beside one SDPA call at each shape, and the
   totals of both over the calls by head dim; ``calls_by_shape`` in the
   ``ssd_scan``, ``decode_attention`` and ``flash_attention`` rows).
6. **micro** — per micro model: the card's step against the CPU plain
   step on the same weights (fp32, 2e-5), a trace of one runner step at
   b = 1 and 256 (attn-tiny also at its rungs S = 8 and 4), then the
   launcher's ``run_real_scenario`` on steady-poisson (4 s, 4 units,
   max batch 256, capped at 300 req/s) under both policies and both
   dispatches.  Every request must complete; the counts, reset just
   before the scenario and read just after, must show attn-tiny's flash
   calls on the short route only, no kernel for the MLPs, and no
   CPU-route call.
7. **launcher** — ``repro_torch.launch.bench_serving`` on the fast
   simulated plane (step-up, 20 s), twice: the reports must be identical.
   **launcher_lm** — the launcher's own LM mode on the card,
   ``bench_serving.main`` with :data:`LM_LAUNCHER_ARGS` (lm-tiny,
   steady-poisson, 8 s, 4 units, max batch 8): every prompt and decode
   step completes under every policy and dispatch, with TTFT and TPOT
   p50/p95; the counts, reset just before and read just after, must show
   only flash's short route and decode's CUDA-core route
   (:data:`LM_LAUNCHER_PATHS`) and no CPU-route call.
8. **serve_online** — ``repro_torch.launch.serve`` with
   ``examples/serve_online.py``'s arguments over 8 s (rate step at 4 s)
   on the card: every request must complete; the reduced model runs no
   kernel of the port, as in the reference.
9. **train** — training, with ``use_pallas_kernels`` off as the
   reference must (the kernels have no backward):
   * reduced gemma3-1b (8 layers, d_model 64, vocab 1024) in fp32, two
     steps on the card against the CPU from the same weights and batch:
     each loss within 1e-5 relative and each gradient leaf within 1e-4
     of its largest |g|, the card's ``make_train_step`` repeating its
     own ``value_and_grad`` loss bit for bit, and the parameters and
     moments after two steps within 1e-6 of the CPU's AdamW fed the
     card's gradients;
   * full-width gemma3-1b (26 layers, vocab 262,144, bf16, no cut) at
     B = 4, S = 512 on the synthetic corpus with the launcher's AdamW
     (lr 1e-3, warmup 20, fp32 moments): 3 steps through
     ``repro_torch.launch.train.main``, then the launcher's whole
     schedule (100 steps: warmup to the peak, cosine decay to a tenth of
     it) through ``train`` with the same settings (the launcher's
     printed losses must be ``train``'s first three); each step's loss,
     grad norm, lr, wall ms and tokens/s, a held-out batch's loss every
     10 steps (the same corpus, the stream of a second host), the peak
     device memory; every loss and grad norm finite, the last loss
     below the first by :data:`TRAIN_MARGIN`, and so the held-out loss
     under the trained weights below its loss under the initial ones;
   * an async checkpoint at step 50 (written while steps 51-100 run),
     restored into a fresh tree bit for bit, and a resume to step 100
     whose losses equal the uninterrupted run's;
   * from the trained state, on a held-out batch: a ``remat=True`` and
     a ``grad_accum=2`` step beside the plain one (loss and grad norm
     within bf16's 2e-2); the loss and logits through the flash kernel
     (every layer's attention, under ``torch.no_grad()``) against the
     plain path, within the model phase's bf16 bound (twice the plain
     path's distance from fp32, floor 2e-2), its launches counted as the
     ``train-eval`` path; a train step with the kernels on raises the
     wrappers' ``RuntimeError`` before any launch;
   * one full-width step traced: forward + backward, the AdamW update
     and the whole step (wall, device busy, idle share, launches, top
     kernels).

Each phase prints one JSON line (the model, trace and serve lines with
the ``seconds`` they took), each with ``elapsed_s``, the seconds since the
script started.  Then the card's name and power limit, the
``{"kernels": [...]}`` line
(one row per route of each kernel, and the CUDA-core decode again at
lm-tiny's shape; ``launches_by_path`` includes ``lm-tiny`` and
``train-eval``) and,
last, ``{"ok": true, "device": {...}}``.  ``--kernels-only`` stops after
phase 2 (a quick check after editing a kernel).
"""

from __future__ import annotations

import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BW = 3.35e12                       # H100 SXM HBM3 bytes/s
# fp32 and fp64 on the CUDA cores (fp64 outside the tensor cores), fp64
# and bf16 dense on the tensor cores: NVIDIA's H100 SXM data sheet
PEAK = {"float32": 67e12, "float64": 34e12, "float64_tc": 67e12,
        "bfloat16": 989e12}
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
SERVE_SECONDS = 8.0
# valid cache rows of a decode call timed at a serving shape (at most S):
# a 512-token prompt and up to 8 decode steps
DECODE_VALID = 520
# trace phase: one prefill of TRACE_PROMPT tokens, then TRACE_DECODE steps
TRACE_PROMPT, TRACE_DECODE, TRACE_MAX_LEN, TRACE_TOP = 512, 4, 1024, 8
# path -> {kernel its serve block must launch: the one route every bf16
# serving call of that kernel must take}; any other launch fails the path
PATHS = {"gemma3-1b": {"flash_attention": "tensor_core",
                       "decode_attention": "tensor_core"},
         "mamba2-130m": {"ssd_scan": "tensor_core"},
         "recurrentgemma-9b": {"rglru_scan": "chunked",
                               "flash_attention": "tensor_core",
                               "decode_attention": "tensor_core"},
         "deepseek-v2-236b": {},
         "seamless-m4t-medium": {"flash_attention": "tensor_core",
                                 "decode_attention": "tensor_core"},
         "internvl2-1b": {"flash_attention": "tensor_core",
                          "decode_attention": "tensor_core"},
         "stablelm-12b": {"flash_attention": "tensor_core",
                          "decode_attention": "tensor_core"},
         "llama3-8b": {"flash_attention": "tensor_core",
                       "decode_attention": "tensor_core"},
         "minitron-8b": {"flash_attention": "tensor_core",
                         "decode_attention": "tensor_core"}}
# path -> overrides that cut a configuration to one card: deepseek-v2-236b
# keeps its full width and its dense MLA prefix layer, and 2 of its 59
# MLA_MOE repeats (each ~3.97B parameters, 7.9 GB in bf16): 59 repeats
# are ~470 GB in bf16, and the fp32 model check needs ~37 GB for 2
CUT = {"deepseek-v2-236b": {"n_repeats": 2}}
# the model check's MoE capacity factor: >= n_experts / top_k (160 / 6),
# so no assignment is dropped and prefill + decode equals the forward
DROPLESS_CF = 32.0
# distributed phase: gemma3-1b's prompt, decode steps and cache slots on
# the (1, 1) NCCL mesh; the values of its full fp32 parameter tree;
# expert parallelism of deepseek-v2-236b's MoE layer over EP_RANKS gloo
# processes on the card (40 of 160 experts each), B x S tokens, the
# skewed input's push toward expert 0, the weights' seed
DIST_PROMPT, DIST_DECODE, DIST_MAX_LEN = 64, 4, 128
# the ZeRO train steps' batch: both states (parameters and fp32 moments,
# 10 GB each) and one step's activations fit the card
DIST_TRAIN_BATCH, DIST_TRAIN_SEQ = 2, 512
# profile phase: gemma3-1b's decode at t = 1 and these batches, over the
# analytic profiler's default cache length
PROFILE_BATCHES, PROFILE_SEQ = (1, 4, 16), 8192
DIST_PSUM_VALUES = 999_885_952
EP_RANKS, EP_BATCH, EP_SEQ, EP_PUSH, EP_SEED = 4, 4, 512, 10.0, 11
EP_TIMEOUT_S = 600.0
ROUTES = ("cuda_core", "tensor_core", "short", "chunked")
# the host calls that put a kernel on the device, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# profiler sessions taken again, a second apart, where one holds no kernel
# record at all (_profile)
PROFILE_EMPTY_TRIES = 4
# path -> (prompt positions, cache slots) of the model check; a vision
# prompt's positions include its patches
MODEL_CHECK = {"gemma3-1b": (1024, 2048), "mamba2-130m": (1000, 2048),
               "recurrentgemma-9b": (2100, 4096),
               "deepseek-v2-236b": (512, 1024),
               "seamless-m4t-medium": (1000, 2048),
               "internvl2-1b": (1000, 2048),
               "stablelm-12b": (1024, 2048), "llama3-8b": (1024, 2048),
               "minitron-8b": (1024, 2048)}
# path -> encoder frames of the model check, where input_specs' count
# (min(prompt, n_frames)) is not the one wanted
MODEL_FRAMES = {"seamless-m4t-medium": 2048}
# the head-dim-64 serving shapes (H, Hkv): seamless-m4t-medium's decoder
# and internvl2-1b's group of 7
D64_SERVING = ((16, 16), (14, 2))
# the dense paths' attention (H, Hkv): 32 heads on 8 at head dim 160
# (stablelm-12b) and 128 (llama3-8b, minitron-8b)
DENSE_HEADS = (32, 8)
# micro models of the real plane: model -> {kernel: the route its serving
# run must launch}; any other launch fails the path.  attn-tiny runs the
# fp32 flash kernel's short route (2 heads of head dim 16), the MLPs no
# kernel
MICRO_PATHS = {"mlp-tiny": {}, "mlp": {},
               "attn-tiny": {"flash_attention": "short"}}
# the launcher's LM path: lm-tiny's prefill at bucket 16 on flash's short
# route, its fp32 decode on the CUDA-core route
LM_LAUNCHER_PATHS = {"lm-tiny": {"flash_attention": "short",
                                 "decode_attention": "cuda_core"}}
ATTN_TINY_HD = (2, 16)            # attn-tiny's (heads, head dim)
# lm-tiny (the launcher's LM model): reduced gemma3-1b in fp32, 6
# attention layers of 2 query heads on 1 KV head, head dim 16 (8 on its
# fidelity rungs 1-2), a 64-slot cache; its decode calls take the
# CUDA-core route, its prefill at bucket 16 flash's short route
LM_TINY_HEADS, LM_TINY_DIMS, LM_TINY_SLOTS = (2, 1), (16, 8), 64
LM_TINY_BATCHES = (1, 2, 4, 8)
ATTN_TINY_SEQS = (16, 8, 4)       # its fidelity rungs' sequence lengths
MICRO_MLP = {"mlp-tiny": (32, 2), "mlp": (128, 4)}   # width, depth
MICRO_SECONDS, MICRO_UNITS, MICRO_BATCHES = 4.0, 4, (1, 256)
# serve_online: examples/serve_online.py's arguments, a shorter run
SERVE_ONLINE_ARGS = ["--arch", "gemma3-1b", "--duration", "8",
                     "--rate-step", "4", "--initial-batch", "8",
                     "--max-batch", "32"]
# launcher_lm: the launcher's own LM serving mode, lm-tiny on the card
LM_LAUNCHER_ARGS = ["--execution", "real", "--real-model", "lm-tiny",
                    "--scenario", "steady-poisson", "--duration", "8",
                    "--units", "4", "--max-batch", "8", "--device", "cuda"]
# train phase: full-width gemma3-1b by the launcher's flags over the
# launcher's whole schedule (AdamW lr 1e-3, warmup 20, cosine decay to step
# 100, fp32 moments), an async checkpoint at step 50, resumed to 100; the
# last of the 100 losses must be below the first by TRAIN_MARGIN nats, and
# so must a held-out batch's loss under the trained weights below its loss
# under the initial ones (printed every TRAIN_EVAL_EVERY steps); the
# launcher itself runs the first TRAIN_LAUNCHER_STEPS of them
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SAVE_AT = "gemma3-1b", 100, 50
TRAIN_EVAL_EVERY, TRAIN_LAUNCHER_STEPS = 10, 3
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--batch", "4", "--seq", "512",
              "--lr", "1e-3", "--seed", "0", "--device", "cuda"]
TRAIN_MARGIN = 0.02
# the card-against-CPU check: gemma3-1b reduced to 8 layers, d_model 64
TRAIN_REDUCED = {"n_repeats": 1, "vocab_size": 1024}
# (row, headline, route, source, the TPU kernel it replaces): one row per
# route of each kernel, timed forced at its headline's shape: flash's
# tensor cores at gemma3-1b's prefill, its short route at attn-tiny's,
# its CUDA-core kernel (flash_fwd_kernel) in fp32 at the tensor cores'
# shape (the fp32 model checks run it), the CUDA-core decode and SSD
# kernels in fp32 at their bf16 rows' shapes, the CUDA-core decode
# again at lm-tiny's largest decode cell, and both tensor-core attention
# kernels again at stablelm-12b's head dim 160 (32 heads on 8), flash's
# also at llama3-8b's and minitron-8b's 128; each row's launches are
# those of its route
_CSRC = "src/repro_torch/kernels/csrc/"
KERNEL_ROWS = (
    ("flash_attention", "flash_attention", "tensor_core",
     _CSRC + "flash_attention.cu", "src/repro/kernels/flash_attention.py:89"),
    ("flash_attention/short", "flash_attention/attn-tiny", "short",
     _CSRC + "flash_attention.cu", "src/repro/kernels/flash_attention.py:89"),
    ("flash_attention/cuda_core", "flash_attention/fp32", "cuda_core",
     _CSRC + "flash_attention.cu", "src/repro/kernels/flash_attention.py:89"),
    ("flash_attention/stablelm-12b", "flash_attention/stablelm-12b",
     "tensor_core", _CSRC + "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:89"),
    ("flash_attention/llama3-8b", "flash_attention/llama3-8b",
     "tensor_core", _CSRC + "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:89"),
    ("decode_attention", "decode_attention", "tensor_core",
     _CSRC + "decode_attention.cu",
     "src/repro/kernels/decode_attention.py:125"),
    ("decode_attention/cuda_core", "decode_attention/fp32", "cuda_core",
     _CSRC + "decode_attention.cu",
     "src/repro/kernels/decode_attention.py:125"),
    ("decode_attention/cuda_core/lm-tiny", "decode_attention/lm-tiny",
     "cuda_core", _CSRC + "decode_attention.cu",
     "src/repro/kernels/decode_attention.py:125"),
    ("decode_attention/stablelm-12b", "decode_attention/stablelm-12b",
     "tensor_core", _CSRC + "decode_attention.cu",
     "src/repro/kernels/decode_attention.py:125"),
    ("ssd_scan", "ssd_scan", "tensor_core", _CSRC + "ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:72"),
    ("ssd_scan/cuda_core", "ssd_scan/fp32", "cuda_core", _CSRC + "ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:72"),
    ("rglru_scan", "rglru_scan", "chunked", _CSRC + "rglru_scan.cu",
     "src/repro/kernels/rglru_scan.py:51"),
)


_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also carries the seconds since
    the script started (``elapsed_s``), so the run's time splits by
    phase."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and run the kernels phase "
                         "only (a quick check after editing a kernel); "
                         "prints no final ok line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # kernel and plain versions are compared in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import KERNEL_STATS, build

    t0 = time.perf_counter()
    build_s = build.build_kernels()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Function properties for" in ln]
             for name, log in build.build_log.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "flash_tc_pair_kernel": ptxas_of(build.build_log.get(
              "flash_attention", ""), "flash_tc_pair_kernel")})

    kernels_rep = phase_kernels(torch)
    emit({"phase": "kernels", **kernels_rep})
    if args.kernels_only:
        return 0
    for name in PATHS:
        emit({"phase": "model", **phase_model(torch, name)})
    emit({"phase": "moe", **phase_moe(torch)})
    emit({"phase": "distributed", **phase_distributed(torch)})
    emit({"phase": "profile", **phase_profile(torch)})
    for name in PATHS:
        emit({"phase": "trace", **phase_trace(torch, name)})

    launches = {n: {} for n in KERNEL_STATS}
    by_path = {n: {} for n in KERNEL_STATS}
    calls = {"ssd_scan": {}, "decode_attention": {}, "flash_attention": {}}
    for path, needed in PATHS.items():
        _reset_counts()
        serve_rep = phase_serve(torch, path)
        counts, cpu_calls = _counts()
        shapes = {n: dict(KERNEL_STATS[n].calls_by_shape) for n in calls}
        _free(torch)                  # the engine went with phase_serve
        serve_rep["launches_by_route"] = counts
        serve_rep["cpu_calls"] = cpu_calls
        for n, by_shape in shapes.items():
            serve_rep[f"{n}_calls_by_shape"] = [[*k, c] for k, c in
                                                by_shape.items()]
            for k, c in by_shape.items():
                calls[n][k] = calls[n].get(k, 0) + c
        emit({"phase": "serve", **serve_rep})
        _check_launches(path, counts, cpu_calls, needed)
        _tally(counts, path, launches, by_path)
    ssd_shapes = ssd_calls_by_shape(torch, calls["ssd_scan"])
    emit({"phase": "ssd_shapes", "rows": ssd_shapes})
    decode_shapes = decode_calls_by_shape(torch, calls["decode_attention"])
    emit({"phase": "decode_shapes", **decode_shapes})
    flash_shapes = flash_calls_by_shape(torch, calls["flash_attention"])
    emit({"phase": "flash_shapes", **flash_shapes})
    for name in MICRO_PATHS:
        micro_rep = phase_micro(torch, name)
        _tally(micro_rep["launches_by_route"], name, launches, by_path)
        emit({"phase": "micro", **micro_rep})
    emit({"phase": "launcher", **phase_launcher()})
    lm_rep = phase_launcher_lm(torch)
    _tally(lm_rep["launches_by_route"], "lm-tiny", launches, by_path)
    emit({"phase": "launcher_lm", **lm_rep})
    emit({"phase": "serve_online", **phase_serve_online(torch)})
    train_rep = phase_train(torch)
    _tally(train_rep["eval"]["launches_by_route"], "train-eval", launches,
           by_path)
    emit({"phase": "train", **train_rep})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    rows = kernel_rows(kernels_rep, launches, by_path)
    for row in rows:
        if row["name"] == "ssd_scan":
            row["calls_by_shape"] = ssd_shapes
        for name, shapes in (("decode_attention", decode_shapes),
                             ("flash_attention", flash_shapes)):
            if row["name"] == name:
                row["calls_by_shape"] = shapes["rows"]
                row["calls_weighted_ms"] = shapes["weighted_ms"]
                row["calls_library_weighted_ms"] = \
                    shapes["library_weighted_ms"]
                row["calls_by_head_dim"] = shapes["by_head_dim"]
    emit({"kernels": rows})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def ptxas_of(log: str, kernel: str) -> list:
    """ptxas's lines (``-v``) about each entry whose name holds
    ``kernel``: its name, stack frame and spills, registers."""
    lines, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = kernel in ln
        if inside and ("Compiling entry function" in ln or "spill" in ln
                       or "registers" in ln):
            lines.append(ln.strip())
    return lines


def kernel_rows(kernels_rep, launches, by_path):
    """The ``kernels`` line: one row per :data:`KERNEL_ROWS` entry, its
    route forced at its headline's shape (``ms``; the wrapper's time by
    shape beside it, and every route's), with the launches of that route
    on the main paths and the per-launch floor of ``ms``."""
    rows = []
    for name, key, route, source, replaces in KERNEL_ROWS:
        h = kernels_rep["headline"][key]
        kernel = name.split("/")[0]
        r = h.get("routes", {}).get(route, h)   # rglru_scan: one kernel
        err = r["max_abs_err"]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[kernel].get(route, 0),
            "launches_by_path": {p: c[route]
                                 for p, c in by_path[kernel].items()
                                 if route in c},
            "kernel_route": route, "dtype": h["dtype"],
            "max_abs_err": max(err.values()) if isinstance(err, dict)
            else err,
            "ms": r["ms"], "host_ms": r["host_ms"],
            "launch_floor_ms": kernels_rep["launch_floor"]["ms"],
            "profiler_ms": r.get("device_kernels_ms"),
            "wrapper_ms": h["ms"], "wrapper_host_ms": h["host_ms"],
            "routes_ms": {n: x["ms"] for n, x in h.get("routes", {}).items()},
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "shape": h["shape"]})
    return rows


# --------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------- #
def _compare(torch, got, want, dtype_name):
    """Max abs error, and whether every element is finite and within
    ``atol + rtol * |want|`` (numpy's allclose rule)."""
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


@functools.lru_cache(maxsize=None)
def _cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card, timed
    once with CUDA events."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> dict:
    """Device time of one call (``ms``) and the host's time to issue one
    (``host_ms``).

    The host time is ``iters`` calls issued back to back on the host
    clock.  Then a sleep kernel at least twice that long is enqueued
    before the start event, and the same calls are issued again between
    two CUDA events: the whole batch is queued while the device sleeps,
    so the events time the device alone, not the host's cadence.  If the
    host still took longer than the sleep, the sleep doubles and the
    batch repeats (at most 3 times; ``covered`` says whether it held).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_ms = max(2.0 * host_ms, 1.0)
    for _ in range(3):
        torch.cuda._sleep(int(sleep_ms * _cycles_per_ms(torch)))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        issued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        covered = issued_ms < sleep_ms
        if covered:
            break
        sleep_ms = 2.0 * max(sleep_ms, issued_ms)
    return {"ms": start.elapsed_time(end) / iters, "host_ms": host_ms / iters,
            "covered": covered}


def _device_events(prof):
    """The device records of a profile: kernels, copies and fills, without
    the device side of :func:`_profile`'s step annotation."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]


def _profile(torch, fn, tries: int = 3):
    """``fn`` under ``torch.profiler`` (CPU and CUDA activity), after a
    warm-up cycle of a few empty kernels whose events the profiler drops,
    and again (at most ``tries`` sessions) while the session holds fewer
    kernel records than launch calls.  Once a process has run many
    sessions (the kernels phase), a session without the warm-up lost its
    first two kernel records to the tracer's start-up, on any stream, and
    with it now and then more, so attn-tiny's one-kernel step read as no
    device time at all.  A session that holds no kernel record at all is
    taken again a second later (at most :data:`PROFILE_EMPTY_TRIES`
    times, each noted on standard error): late in the kernels phase the
    sessions of a decode call of two kernels once held no record in three
    tries back to back, and both records in a try a second later."""
    from torch.profiler import ProfilerActivity, profile, schedule
    empty = 0
    for _ in range(tries):
        while True:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _ in range(4):
                    torch.cuda._sleep(0)
                torch.cuda.synchronize()
                prof.step()
                fn()
                torch.cuda.synchronize()
            kernels = sum(not e.name.startswith(("Memcpy", "Memset"))
                          for e in _device_events(prof))
            if kernels or empty == PROFILE_EMPTY_TRIES:
                break
            empty += 1
            print(f"chip_smoke: profiler session with no kernel record "
                  f"({empty}); again in a second", file=sys.stderr,
                  flush=True)
            time.sleep(1.0)
        if kernels >= sum(e.name in LAUNCH_CALLS for e in prof.events()):
            break
    return prof


def _kernel_records(torch, fn, stats=None, iters: int = 20) -> dict:
    """``fn`` ``iters`` times under ``torch.profiler``: the device ms per
    call of each kernel, the device kernel records per call (copies and
    fills apart) and, given a wrapper's ``stats``, the launches it
    counted meanwhile."""
    import collections
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    counted = []

    def calls():
        before = stats.launches if stats else 0
        for _ in range(iters):
            fn()
        counted.append((stats.launches if stats else 0) - before)
    by_name = collections.Counter()
    records = 0
    for e in _device_events(_profile(torch, calls)):
        name = e.name.replace("(anonymous namespace)::", "")
        by_name[name.split("(")[0][:60]] += e.device_time_total / 1e3
        records += not e.name.startswith(("Memcpy", "Memset"))
    return {"records_per_call": records / iters,
            "launches_per_call": counted[-1] / iters,
            "kernels_ms": {n: ms / iters for n, ms in by_name.most_common()}}


def _ssd_bound(dt: str, B, S, H, G, P, N, Q):
    """(least ms, what bounds it) of one SSD call at this shape."""
    elem = 2 if dt == "bfloat16" else 4
    nbytes = (elem * (2 * B * S * H * P + 2 * B * S * G * N)
              + 4 * (B * S * H + H + B * H * P * N))
    # the work the function needs: per chunk the causal triangle of the
    # scores C B^T (Q(Q+1)/2 dot products of N) and of M x (of Q(Q+1)/2
    # columns of P), the chunk's state (x o w)^T B (Q N P), and C h_in^T
    # (Q N P) on every chunk but the first, whose h_in is zero
    chunks = B * H * (S // Q)
    tri = Q * (Q + 1) / 2
    scores = 2.0 * tri * N * chunks
    rest = 2.0 * (tri * P * chunks + Q * N * P * chunks
                  + Q * N * P * (chunks - B * H))
    flops = scores + rest
    if dt == "float32":
        # the CUDA-core passes form the scores in fp64 on the FP64 tensor
        # cores, the rest in fp32
        flops = {"float64_tc": scores, "float32": rest}
    return _bound(nbytes, flops, dt)


def _ssd_cluster(torch, dt: str, B, S, H, P, N, Q) -> dict:
    """The tensor-core cluster kernel's size at this shape and the
    clusters of that size the card holds at once (empty off that
    kernel)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ssd_mod
    if ssd_mod.kernels_per_call(dt, P, N, Q) != ssd_mod.CLUSTER_KERNELS:
        return {}
    lib = build.library("ssd_scan")
    c = lib.ssd_scan_tc_cluster(B, S, H, P, N, Q)
    return {"cluster": c, "tiles": ssd_mod.cluster_tiles(P, N, Q),
            "clusters": B * H, "max_active_clusters":
            lib.ssd_scan_max_active_clusters(P, N, Q, c,
                                             int(S // Q > c))}


def ssd_calls_by_shape(torch, calls) -> list:
    """The SSD timed at each shape the serving paths called it with
    (``calls``: the wrapper's shape key -> calls), on fresh inputs
    through the wrapper, so on the route each shape takes: device ms,
    host ms, the bound, and the calls times the excess over the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    rows = []
    for (dt, B, S, H, G, P, N, Q), n in sorted(calls.items()):
        dtype = getattr(torch, dt)
        args = (randn((B, S, H, P), dtype),
                F.softplus(randn((B, S, H), torch.float32)),
                torch.log(torch.linspace(1.0, 4.0, H, device=dev)),
                randn((B, S, G, N), dtype), randn((B, S, G, N), dtype))
        t = time_ms(torch, lambda: ops.ssd_scan(*args, chunk=Q), iters=50)
        bound_ms, bound_by = _ssd_bound(dt, B, S, H, G, P, N, Q)
        rows.append({"shape": {"B": B, "S": S, "H": H, "P": P, "G": G,
                               "N": N, "chunk": Q},
                     "dtype": dt, "route": ssd_mod.route(dt, P, N, Q),
                     "calls": n, "ms": t["ms"], "host_ms": t["host_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "calls_x_excess_ms": n * (t["ms"] - bound_ms),
                     **_ssd_cluster(torch, dt, B, S, H, P, N, Q)})
        del args
    return rows


def _sdpa(torch, q, k, v, causal: bool, window: int = 0):
    """One ``scaled_dot_product_attention`` call computing what the
    kernels compute on q (B, Sq, H, D) and k/v (B, Sk, Hkv, D), positions
    from 0 on both: the library yardstick (``library_ms``), never called
    by the port.  The layouts and the heads repeated for GQA are made here,
    outside the call."""
    import torch.nn.functional as F
    H, Hkv = q.shape[2], k.shape[2]
    qt = q.transpose(1, 2)
    kt = torch.repeat_interleave(k, H // Hkv, 2).transpose(1, 2)
    vt = torch.repeat_interleave(v, H // Hkv, 2).transpose(1, 2)
    if window:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (j <= i) & (j > i - window)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)


def _by_head_dim(rows) -> dict:
    """Calls-weighted totals of the kernel's and the library's ms by head
    dim, and their ratio."""
    by_dim = {}
    for x in rows:
        d = by_dim.setdefault(str(x["shape"]["D"]),
                              {"calls": 0, "weighted_ms": 0.0,
                               "library_weighted_ms": 0.0,
                               "calls_x_excess_ms": 0.0})
        d["calls"] += x["calls"]
        d["weighted_ms"] += x["calls"] * x["ms"]
        d["library_weighted_ms"] += x["calls"] * x["library_ms"]
        d["calls_x_excess_ms"] += x["calls_x_excess_ms"]
    for d in by_dim.values():
        d["over_library"] = d["weighted_ms"] / d["library_weighted_ms"]
    return by_dim


def decode_calls_by_shape(torch, calls) -> dict:
    """Decode timed at each shape the serving paths called it with
    (``calls``: the wrapper's (dtype, B, S, H, Hkv, D) -> calls), with
    :data:`DECODE_VALID` valid rows (at most S) as the serve phase leaves
    them: each route forced (device ms, host ms), the bound, one SDPA call
    over the valid rows (``library_ms``), and the calls times the excess
    of the route the shape takes; then each route's total over the calls
    (``weighted_ms``), and the totals and SDPA's by head dim
    (``library_s``: the seconds the SDPA timings took)."""
    from repro_torch.kernels import decode_attention as decode_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, library_s = [], 0.0
    for (dt, B, S, H, Hkv, D), n in sorted(calls.items()):
        dtype = getattr(torch, dt)
        q, kc, vc = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((B, 1, H, D), (B, S, Hkv, D),
                                   (B, S, Hkv, D)))
        valid = min(DECODE_VALID, S)
        lengths = torch.full((B,), valid, dtype=torch.int32, device=dev)
        rule = decode_mod.route(dt, D, H // Hkv)
        routes = {}
        for r in ("tensor_core", "cuda_core"):
            if r == "tensor_core" and rule != r:
                continue
            t = time_ms(torch, lambda r=r: decode_mod.launch(
                q, kc, vc, lengths, force=r), iters=50)
            routes[r] = {"ms": t["ms"], "host_ms": t["host_ms"],
                         "covered": t["covered"]}
        elem = q.element_size()
        bound_ms, bound_by = _bound(
            elem * (2 * B * H * D + 2 * Hkv * D * B * valid) + 4 * B,
            4.0 * D * H * B * valid, dt)
        t0 = time.perf_counter()
        library = time_ms(torch, _sdpa(torch, q, kc[:, :valid],
                                       vc[:, :valid], causal=False),
                          iters=50)
        library_s += time.perf_counter() - t0
        rows.append({"shape": {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                               "valid": valid},
                     "dtype": dt, "route": rule, "calls": n,
                     "cluster": (decode_mod._cluster_for(B * Hkv, S, D)
                                 if rule == "tensor_core" else None),
                     "routes": routes, "ms": routes[rule]["ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library["ms"],
                     "calls_x_excess_ms": n * (routes[rule]["ms"]
                                               - bound_ms)})
        del q, kc, vc
    weighted = {r: sum(x["calls"] * x["routes"][r]["ms"] for x in rows
                       if r in x["routes"])
                for r in ("tensor_core", "cuda_core")}
    return {"rows": rows, "weighted_ms": weighted,
            "library_weighted_ms": sum(x["calls"] * x["library_ms"]
                                       for x in rows),
            "by_head_dim": _by_head_dim(rows), "library_s": library_s,
            "calls": sum(x["calls"] for x in rows)}


def flash_calls_by_shape(torch, calls) -> dict:
    """Flash timed at each shape the serving paths called it with
    (``calls``: the wrapper's (dtype, B, Sq, Sk, H, Hkv, D, window) ->
    calls; every serving call is causal), on fresh inputs, on the route
    each shape takes (forced, so the time is the kernel's alone): device
    ms, host ms, the bound, one SDPA call (``library_ms``) and the calls
    times the excess over the bound; then the total over the calls
    (``weighted_ms``) and SDPA's, and those totals and the excess by head
    dim (``library_s``: the seconds the SDPA timings took)."""
    from repro_torch.kernels import flash_attention as flash_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, library_s = [], 0.0
    for (dt, B, Sq, Sk, H, Hkv, D, window), n in sorted(calls.items()):
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, Sq, H, D), (B, Sk, Hkv, D),
                                 (B, Sk, Hkv, D)))
        rule = flash_mod.route(dt, D, Sq, Sk)
        t = time_ms(torch, lambda: flash_mod.launch(
            q, k, v, causal=True, window=window, force=rule), iters=20)
        bound_ms, bound_by = _bound(
            q.element_size() * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D),
            4.0 * D * B * H * _visible_pairs(Sq, window, Sk), dt)
        t0 = time.perf_counter()
        library = time_ms(torch, _sdpa(torch, q, k, v, causal=True,
                                       window=window), iters=20)
        library_s += time.perf_counter() - t0
        rows.append({"shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H,
                               "Hkv": Hkv, "D": D, "window": window},
                     "dtype": dt, "route": rule, "calls": n,
                     "ms": t["ms"], "host_ms": t["host_ms"],
                     "covered": t["covered"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library["ms"],
                     "calls_x_excess_ms": n * (t["ms"] - bound_ms)})
        del q, k, v
    return {"rows": rows,
            "weighted_ms": sum(x["calls"] * x["ms"] for x in rows),
            "library_weighted_ms": sum(x["calls"] * x["library_ms"]
                                       for x in rows),
            "calls_x_excess_ms": sum(x["calls_x_excess_ms"] for x in rows),
            "calls": sum(x["calls"] for x in rows),
            "by_head_dim": _by_head_dim(rows), "library_s": library_s}


def _bound(bytes_moved: float, flops, dtype_name: str):
    """(least ms, what bounds it): the bytes over the HBM rate, or the
    operations over the peak of their type.  ``flops`` is a count at
    ``dtype_name``'s peak, or {dtype name: count} for a kernel that
    computes in several precisions on separate units (the slowest sets
    the bound)."""
    t_bytes = bytes_moved / MEM_BW
    by_type = flops if isinstance(flops, dict) else {dtype_name: flops}
    t_ops = max(n / PEAK[t] for t, n in by_type.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _visible_pairs(S: int, window: int, sk: int = 0) -> int:
    """Causal (optionally windowed) query-key pairs of one head: S query
    rows against ``sk`` keys (S by default), positions from 0."""
    sk = sk or S
    return sum(max(0, min(i + 1, sk) - (max(0, i - window + 1) if window
                                        else 0)) for i in range(S))


def _config(name: str):
    """The registered configuration of a path, cut to one card (CUT)."""
    from repro_torch.configs import get_config
    return get_config(name).with_overrides(**CUT.get(name, {}))


def _prompt(torch, cfg, S: int, n_dec: int, gen, frames: int = 0):
    """A seeded batch-1 prompt of S positions on the card, with the inputs
    ``input_specs`` names (embeddings in the model dtype; ``frames``, if
    given, sets the encoder's frame count), and n_dec tokens to decode
    after it.  Tokens are drawn first, as one (1, text + n_dec) draw."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import input_specs
    dev = torch.device("cuda")
    specs = input_specs(cfg, ShapeConfig("smoke", seq_len=S, global_batch=1,
                                         kind="prefill"))
    n_text = specs["tokens"].shape[1]
    tokens = torch.randint(0, cfg.vocab_size, (1, n_text + n_dec),
                           generator=gen).to(dev)
    batch = {"tokens": tokens[:, :n_text]}
    for name, spec in specs.items():
        if name != "tokens":
            shape = ((1, frames, cfg.d_model) if name == "frames" and frames
                     else spec.shape)
            batch[name] = torch.randn(shape, generator=gen).to(dev,
                                                               spec.dtype)
    return batch, tokens[:, n_text:]


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _tally(counts, path, launches, by_path) -> None:
    """Add one path's launch counts (kernel -> route -> n) to the run's."""
    for name, by_route in counts.items():
        for r, n in by_route.items():
            launches[name][r] = launches[name].get(r, 0) + n
        if by_route:
            by_path[name][path] = by_route


def _check_launches(path, counts, cpu_calls, needed) -> None:
    """Every kernel of the path launched, each only on the route ``needed``
    names; no other kernel launched; no wrapper took its CPU route."""
    for name, by_route in counts.items():
        want = needed.get(name)
        if want is None and by_route:
            raise AssertionError(f"{path}: {name} launched, but the "
                                 f"path has no call of it: {by_route}")
        if want is not None and (by_route.get(want, 0) <= 0
                                 or set(by_route) != {want}):
            raise AssertionError(f"{path}: every {name} call must take "
                                 f"the {want} route, got {by_route}")
    for name, n in cpu_calls.items():
        if n != 0:
            raise AssertionError(f"{path}: {name} took its CPU route "
                                 "on the card")


def _counts():
    """The launch counts by route and the CPU-route calls of every kernel
    wrapper since the last reset."""
    from repro_torch.kernels import KERNEL_STATS
    return ({n: dict(s.launches_by_route) for n, s in KERNEL_STATS.items()},
            {n: s.cpu_calls for n, s in KERNEL_STATS.items()})


def _reset_counts() -> None:
    from repro_torch.kernels import KERNEL_STATS
    for stats in KERNEL_STATS.values():
        stats.reset()


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #
def phase_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import KERNEL_STATS, build
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = []
    oracle = []        # the fp32 plain versions' own distance from fp64

    def check(kind, shape, dtype_name, got, want, **extra):
        err, ok = _compare(torch, got, want, dtype_name)
        cases.append({"kernel": kind, "shape": shape, "dtype": dtype_name,
                      "max_abs_err": err, "ok": ok, **extra})
        return err

    def same_route(kind, shape, dtype_name, rule, auto, forced):
        """The C entry's choice by shape launches the same kernel as the
        Python rule: the outputs agree bit for bit."""
        ok = all(torch.equal(a, f) for a, f in zip(auto, forced))
        cases.append({"kernel": kind, "shape": shape, "dtype": dtype_name,
                      "check": f"by shape == forced {rule}", "ok": ok})

    def routes_for(rule):
        """Every route that takes a case: the CUDA-core kernels take every
        shape the wrapper accepts, the tensor cores (and flash's short
        route) those of the rule."""
        return ("cuda_core",) if rule == "cuda_core" else ("cuda_core", rule)

    # flash: tests/test_kernels.py grids, head dim 8, GQA groups 1, 2, 4,
    # 8 and 16, windows 16/48/100, one partial 64-row tile (S = 16, 32,
    # 48 after padding), and the serving shapes of gemma3-1b (4 heads on
    # 1), recurrentgemma-9b (16 heads on 1, window 2048), seamless-m4t-
    # medium (16 on 16, head dim 64) and internvl2-1b (14 on 2, a group
    # of 7, head dim 64) at B = 1, 4
    flash = []
    for dt in TOL:
        for B, S, H, Hkv, D in ((1, 64, 4, 4, 32), (2, 128, 4, 2, 32),
                                (1, 96, 8, 1, 16), (2, 256, 2, 2, 64),
                                (2, 64, 2, 1, 8), (1, 80, 4, 2, 8),
                                (2, 128, 4, 1, 64), (1, 128, 16, 1, 64)):
            flash.append((dt, B, S, H, Hkv, D, 0, 32))
        for window in (16, 48, 100):
            flash.append((dt, 2, 128, 4, 1, 32, window, 32))
        for S in (16, 32, 48):
            flash.append((dt, 2, S, 4, 2, 32, 0, 16))
        for B in (1, 4):
            for S in (512, 1024):
                for window in (0, 512):
                    flash.append((dt, B, S, 4, 1, 256, window, 512))
            flash.append((dt, B, 512, 16, 1, 256, 2048, 512))
            for H, Hkv in D64_SERVING:
                flash.append((dt, B, 512, H, Hkv, 64, 0, 512))
        # the head-dim-64 model checks' prompts (1000 positions, not a
        # multiple of the tiles) and, in fp32, recurrentgemma-9b's (2100
        # positions, window 2048): where the CUDA-core route runs
        for H, Hkv in D64_SERVING:
            flash.append((dt, 1, 1000, H, Hkv, 64, 0, 512))
        if dt == "float32":
            flash.append((dt, 1, 2100, 16, 1, 256, 2048, 512))
        # the dense paths' prefill (32 heads on 8) at head dim 160
        # (stablelm-12b), causal and windowed, and 128 (llama3-8b,
        # minitron-8b), at B = 1, 4; partial tiles at 160 (S = 100: a
        # 64-row query tile and a 36-row one); in fp32 the model check's
        # prompt (1024 positions)
        for B in (1, 4):
            for window in (0, 100):
                flash.append((dt, B, 512, *DENSE_HEADS, 160, window, 512))
            flash.append((dt, B, 512, *DENSE_HEADS, 128, 0, 512))
        flash.append((dt, 2, 100, *DENSE_HEADS, 160, 48, 32))
        if dt == "float32":
            flash.append((dt, 1, 1024, *DENSE_HEADS, 160, 0, 512))
        if dt == "bfloat16":
            # the tensor-core kernel's other head dims, at GQA groups 7
            # (windowed) and 16 over a partial tile
            for D in (16, 32, 128, 160):
                flash.append((dt, 2, 100, 14, 2, D, 48, 32))
                flash.append((dt, 2, 100, 16, 1, D, 0, 32))
            # the pair kernel's 128-row blocks (a 64-row tile a
            # warpgroup) at head dims 128 and 160: one row into a block
            # (129), one row past two (257), inside a group's tile (1000),
            # causal and windowed, at B = 1 and 3; and the dense paths'
            # model check prompt (1024 positions)
            for D in (128, 160):
                for B in (1, 3):
                    for S in (129, 257, 1000):
                        for window in (0, 100):
                            flash.append((dt, B, S, *DENSE_HEADS, D, window,
                                          512))
                flash.append((dt, 1, 1024, *DENSE_HEADS, D, 0, 512))
    # attn-tiny (the micro path): fp32, 2 heads of 16, its rungs' S = 16,
    # 8 and 4 (on the card unpadded: the short route), at B = 1, 16, 256
    heads, hd = ATTN_TINY_HD
    for B in (1, 16, 256):
        for S in ATTN_TINY_SEQS:
            flash.append(("float32", B, S, heads, heads, hd, 0, 512))
    timings = {"flash_attention": [], "decode_attention": [],
               "ssd_scan": [], "rglru_scan": []}
    for dt, B, S, H, Hkv, D, window, blk in flash:
        dtype = getattr(torch, dt)
        q = randn((B, S, H, D), dtype)
        k = randn((B, S, Hkv, D), dtype)
        v = randn((B, S, Hkv, D), dtype)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        got = ops.flash_attention(q, k, v, causal=True, window=window,
                                  block_q=blk, block_kv=blk)
        torch.cuda.synchronize()
        shape = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                 "window": window}
        rule = flash_mod.route(dt, D, S, S)
        err = check("flash_attention", shape, dt, got, want, route=rule,
                    via="ops.flash_attention")
        tiny = dt == "float32" and (H, D) == ATTN_TINY_HD
        if tiny and S < max(ATTN_TINY_SEQS):
            # the wrapper's unpadded call against the call padded to 16
            def pad(x):
                return torch.cat([x, x.new_zeros(
                    (B, max(ATTN_TINY_SEQS) - S, *x.shape[2:]))], 1)
            padded = flash_mod.launch(pad(q), pad(k), pad(v), causal=True,
                                      window=window)[:, :S]
            cases.append({"kernel": "flash_attention", "shape": shape,
                          "dtype": dt, "check": "unpadded == padded",
                          "ok": torch.equal(got, padded)})
        forced, errs = {}, {}
        for r in routes_for(rule):
            forced[r] = flash_mod.launch(q, k, v, causal=True,
                                         window=window, force=r)
            torch.cuda.synchronize()
            errs[r] = check("flash_attention", shape, dt, forced[r], want,
                            route=r)
        same_route("flash_attention", shape, dt, rule,
                   [flash_mod.launch(q, k, v, causal=True, window=window)],
                   [forced[rule]])
        if D == 256 or tiny or (D == 64 and (H, Hkv) in D64_SERVING) or (
                D == 160 and S == 512 and not window) or (
                D == 128 and S == 512 and dt == "bfloat16"):
            lib = _sdpa(torch, q, k, v, causal=True, window=window)
            elem = q.element_size()
            flops = 4.0 * D * B * H * _visible_pairs(S, window)
            nbytes = elem * (2 * B * S * H * D + 2 * B * S * Hkv * D)
            bound_ms, bound_by = _bound(nbytes, flops, dt)
            # attn-tiny's kernels take a few microseconds: more calls, and
            # each route's kernel duration from the profiler beside
            iters = 100 if tiny else 20

            def wrapper_call():
                return ops.flash_attention(q, k, v, causal=True,
                                           window=window, block_q=blk,
                                           block_kv=blk)
            wrapper = time_ms(torch, wrapper_call, iters=iters)
            plain = time_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=window))
            library = time_ms(torch, lib, iters=iters)
            routes = {}
            for r in routes_for(rule):
                def call(r=r):
                    return flash_mod.launch(q, k, v, causal=True,
                                            window=window, force=r)
                routes[r] = {"max_abs_err": errs[r],
                             **time_ms(torch, call, iters=iters)}
                routes[r]["device_kernels_ms"] = _kernel_records(
                    torch, call, iters=iters)["kernels_ms"]
            extra = {}
            if tiny:
                extra["wrapper_kernels_ms"] = _kernel_records(
                    torch, wrapper_call, iters=iters)["kernels_ms"]
            if tiny and S < max(ATTN_TINY_SEQS):
                # what the wrapper did before it skipped the padding:
                # zero-pad q/k/v to 16, launch by shape, slice
                def padded_call():
                    return flash_mod.launch(pad(q), pad(k), pad(v),
                                            causal=True,
                                            window=window)[:, :S]
                extra["padded_wrapper"] = time_ms(torch, padded_call,
                                                  iters=iters)
            timings["flash_attention"].append({
                "shape": shape, "dtype": dt, "route": rule,
                "max_abs_err": err, "ms": wrapper["ms"],
                "host_ms": wrapper["host_ms"], "covered": wrapper["covered"],
                "routes": routes, **extra,
                "library_kernels_ms": _kernel_records(
                    torch, lib)["kernels_ms"],
                "plain_ms": plain["ms"], "library_ms": library["ms"],
                "library_host_ms": library["host_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by})

    # decode: tests/test_kernels.py grid (random lengths), lengths of 1,
    # one split, one split + 1 and S at GQA groups 1, 2, 4, 8 and 16, and
    # the serving shapes: gemma3-1b's global cache (S = 1024, 520 valid
    # rows, as the serve phase's decode steps leave it) and its ring
    # cache (S = 512, full) at B = 1, 4; recurrentgemma-9b (16 heads on
    # 1) at S = 1024, 520 valid, B = 1, 4; B = 8 with random lengths;
    # the head-dim-64 paths (16 heads on 16, 14 on 2) at S = 1024 with
    # lengths 1, 64, 65 and 1024, and 520 valid at B = 1, 4
    # lm-tiny's decode (fp32, 2 heads on 1, D = 16 and its rungs' 8, a
    # 64-slot cache, full) at B = 1, 2, 4, 8; lengths 0, 1, one split, one
    # split + 1 and S there and at D = 256; GQA groups 17 and 32 (the
    # CUDA-core route's row blocks, also at lm-tiny's head dims), 24 (a
    # partial row block past 16), 17 across 16 splits and 10 on 2 KV heads
    split = decode_mod.SPLIT_ROWS
    decode = []
    for dt in TOL:
        for B, S, H, Hkv, D in ((2, 128, 4, 2, 32), (1, 256, 8, 8, 64),
                                (3, 96, 4, 1, 16), (2, 64, 2, 1, 8)):
            decode.append((dt, B, S, H, Hkv, D, 32, None))
        edges = (1, split, split + 1)
        for H in (1, 2, 4, 8, 16):
            decode.append((dt, 4, 256, H, 1, 64, 256, edges + (256,)))
        decode.append((dt, 5, 1024, 16, 1, 256, 1024, (0,) + edges + (1024,)))
        decode.append((dt, 4, 128, 8, 2, 16, 128, edges + (128,)))
        for B in LM_TINY_BATCHES:
            for D in LM_TINY_DIMS:
                decode.append((dt, B, LM_TINY_SLOTS, *LM_TINY_HEADS, D,
                               LM_TINY_SLOTS, (LM_TINY_SLOTS,) * B))
        for D in LM_TINY_DIMS:
            decode.append((dt, 5, LM_TINY_SLOTS, *LM_TINY_HEADS, D,
                           LM_TINY_SLOTS, (0, 1, 2, split + 1, LM_TINY_SLOTS)))
            decode.append((dt, 5, 256, *LM_TINY_HEADS, D, 256,
                           (0,) + edges + (256,)))
        for H in (17, 32):
            decode.append((dt, 3, 256, H, 1, 64, 256, (0, split + 1, 256)))
            for D in LM_TINY_DIMS:
                decode.append((dt, 3, LM_TINY_SLOTS, H, 1, D, LM_TINY_SLOTS,
                               (0, 1, LM_TINY_SLOTS)))
        decode.append((dt, 3, 256, 32, 1, 256, 256, (1, 130, 256)))
        decode.append((dt, 3, 256, 24, 1, 64, 256, (1, split + 1, 256)))
        decode.append((dt, 3, 256, 24, 1, 256, 256, (0, split, 256)))
        decode.append((dt, 3, 1024, 17, 1, 256, 1024, (1, 520, 1024)))
        # the tensor-core cluster kernel: lengths 0, 1, below the cluster
        # size, mid-tile and S at every head dim in a group of 7; 4096 slots
        # (several tiles a rank) at groups 16 and 7
        for D in build.TENSOR_CORE_HEAD_DIMS:
            decode.append((dt, 5, 1024, 7, 1, D, 1024, (0, 1, 5, 100, 1024)))
        decode.append((dt, 3, 4096, 16, 1, 256, 4096, (2100, 4096, 9)))
        decode.append((dt, 3, 4096, 7, 1, 16, 4096, (4096, 1, 3000)))
        decode.append((dt, 2, 512, 20, 2, 128, 512, (split + 1, 512)))
        for B in (1, 8):
            for S in (512, 1024):
                decode.append((dt, B, S, 4, 1, 256, 1024, None))
        decode.append((dt, 4, 1024, 16, 1, 256, 1024, None))
        for B in (1, 4):
            decode.append((dt, B, 1024, 4, 1, 256, 1024, (520,) * B))
            decode.append((dt, B, 512, 4, 1, 256, 512, (512,) * B))
            decode.append((dt, B, 1024, 16, 1, 256, 1024, (520,) * B))
        for H, Hkv in D64_SERVING:
            decode.append((dt, 4, 1024, H, Hkv, 64, 1024, edges + (1024,)))
            for B in (1, 4):
                decode.append((dt, B, 1024, H, Hkv, 64, 1024, (520,) * B))
        # the dense paths' decode (32 heads on 8) at head dim 160
        # (stablelm-12b) and 128 (llama3-8b, minitron-8b): the serve
        # phase's 1024 slots with 520 valid at B = 1, 4; at 160 also
        # lengths 0, 1, one split, one split + 1 and S, and the model
        # check's 2048 slots (its last decode step's 1032 valid rows)
        for D in (160, 128):
            for B in (1, 4):
                decode.append((dt, B, 1024, *DENSE_HEADS, D, 1024,
                               (520,) * B))
        decode.append((dt, 5, 1024, *DENSE_HEADS, 160, 1024,
                       (0,) + edges + (1024,)))
        decode.append((dt, 2, 2048, *DENSE_HEADS, 160, 2048, (1032, 2048)))
    for dt, B, S, H, Hkv, D, blk, lens in decode:
        dtype = getattr(torch, dt)
        q = randn((B, 1, H, D), dtype)
        kc = randn((B, S, Hkv, D), dtype)
        vc = randn((B, S, Hkv, D), dtype)
        if lens is None:
            lengths = torch.randint(1, S + 1, (B,), generator=gen,
                                    device=dev, dtype=torch.int32)
        else:
            lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
        got = ops.decode_attention(q, kc, vc, lengths, block_kv=blk)
        want = ref.decode_attention_ref(q, kc, vc, lengths)
        # a row with no valid position is 0, as from the TPU kernel (the
        # plain version averages V there)
        want[lengths == 0] = 0
        torch.cuda.synchronize()
        shape = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                 "lengths": lengths.tolist()}
        rule = decode_mod.route(dt, D, H // Hkv)
        err = check("decode_attention", shape, dt, got, want, route=rule,
                    via="ops.decode_attention")
        forced, errs = {}, {}
        for r in routes_for(rule):
            forced[r] = decode_mod.launch(q, kc, vc, lengths, force=r)
            torch.cuda.synchronize()
            errs[r] = check("decode_attention", shape, dt, forced[r], want,
                            route=r)
        same_route("decode_attention", shape, dt, rule,
                   [decode_mod.launch(q, kc, vc, lengths)], [forced[rule]])
        lm_tiny = (dt == "float32" and (H, Hkv) == LM_TINY_HEADS
                   and S == LM_TINY_SLOTS and lens == (S,) * B)
        if D == 256 or lm_tiny or (D == 64 and (H, Hkv) in D64_SERVING) or (
                D == 160 and lens == (520,) * B):
            qt = q.transpose(1, 2)
            kt = torch.repeat_interleave(kc, H // Hkv, 2).transpose(1, 2)
            vt = torch.repeat_interleave(vc, H // Hkv, 2).transpose(1, 2)
            mask = (torch.arange(S, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            elem = q.element_size()
            total = int(lengths.sum())
            flops = 4.0 * D * H * total
            nbytes = elem * (2 * B * H * D + 2 * Hkv * D * total) + 4 * B
            bound_ms, bound_by = _bound(nbytes, flops, dt)
            wrapper = time_ms(torch, lambda: ops.decode_attention(
                q, kc, vc, lengths, block_kv=blk), iters=50)
            library = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), iters=50)
            profiled = {}
            for r in routes_for(rule):
                profiled[r] = _kernel_records(
                    torch, lambda r=r: decode_mod.launch(q, kc, vc, lengths,
                                                         force=r),
                    KERNEL_STATS["decode_attention"])
                # one kernel a call on the tensor cores (the cluster
                # merges on chip); split + combine past one split on the
                # CUDA cores.  The profiler can drop a record late in a
                # process, so its count per call is rounded
                want_n = (1 if r == "tensor_core" or decode_mod.num_splits(S)
                          == 1 else 2)
                cases.append({
                    "kernel": "decode_attention", "shape": shape,
                    "dtype": dt, "route": r,
                    "check": "launches counted == profiler kernel records "
                             f"(rounded) == {want_n} a call",
                    "records_per_call": profiled[r]["records_per_call"],
                    "launches_per_call": profiled[r]["launches_per_call"],
                    "ok": profiled[r]["launches_per_call"] == want_n
                    and round(profiled[r]["records_per_call"]) == want_n})
            timings["decode_attention"].append({
                "shape": shape, "dtype": dt, "route": rule,
                "max_abs_err": err, "ms": wrapper["ms"],
                "host_ms": wrapper["host_ms"], "covered": wrapper["covered"],
                "routes": {r: {"max_abs_err": errs[r], **time_ms(
                    torch, lambda r=r: decode_mod.launch(
                        q, kc, vc, lengths, force=r), iters=50),
                    "device_kernels_ms": profiled[r]["kernels_ms"]}
                    for r in routes_for(rule)},
                "plain_ms": time_ms(torch, lambda: ref.decode_attention_ref(
                    q, kc, vc, lengths), iters=50)["ms"],
                "library_ms": library["ms"],
                "library_host_ms": library["host_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by})

    # the tensor-core decode at head dim 160 (32 heads on 8) with each
    # cluster size forced: lengths 0, 1, 5, 100 and S over 1024 and 4096
    # slots (several tiles a rank)
    for S in (1024, 4096):
        B, (H, Hkv), D = 5, DENSE_HEADS, 160
        q = randn((B, 1, H, D), torch.bfloat16)
        kc = randn((B, S, Hkv, D), torch.bfloat16)
        vc = randn((B, S, Hkv, D), torch.bfloat16)
        lengths = torch.tensor((0, 1, 5, 100, S), device=dev,
                               dtype=torch.int32)
        want = ref.decode_attention_ref(q, kc, vc, lengths)
        want[lengths == 0] = 0
        shape = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                 "lengths": lengths.tolist()}
        for c in decode_mod.CLUSTERS:
            got = decode_mod.launch(q, kc, vc, lengths, force="tensor_core",
                                    cluster=c)
            torch.cuda.synchronize()
            check("decode_attention", shape, "bfloat16", got, want,
                  route="tensor_core", cluster=c)
        del q, kc, vc

    # SSD: tests/test_kernels.py grid, a grouped case with P = 16 (the
    # tensor cores take it), one chunk (S = chunk), a chunk of 40 (not a
    # multiple of 16: the CUDA-core scan pads its 16-row pieces) with P =
    # 12 and N = 20, and mamba2-130m's serving shape at B = 1, 2, 4 (the
    # batches its prefill runner rounds to); in bf16 also 16 chunks over
    # 6144 blocks (far more than the card holds at once), a chunk of 128,
    # P = 80, and N = 256 at a chunk of 128 and N = 272 (the largest
    # blocks of one tile), P = 128 (two row tiles) and N = 512 (two column
    # tiles); the plain version is the sequential
    # recurrence, y and the final state (evaluated in fp64 for fp32)
    ssd_wide = ((8, 1024, 48, 64, 1, 128, 64), (2, 2048, 24, 64, 2, 64, 128),
                (2, 256, 4, 80, 1, 64, 64), (1, 256, 4, 64, 1, 256, 128),
                (1, 256, 4, 64, 1, 272, 64), (2, 256, 4, 128, 1, 64, 64),
                (1, 256, 4, 64, 1, 512, 32))
    for dt in TOL:
        for B, S, H, P, G, N, Q in ((1, 64, 2, 8, 1, 16, 16),
                                    (2, 128, 4, 16, 1, 32, 32),
                                    (1, 64, 4, 8, 2, 16, 16),
                                    (1, 64, 4, 16, 2, 16, 16),
                                    (2, 64, 4, 16, 1, 32, 64),
                                    (2, 120, 4, 12, 2, 20, 40),
                                    (1, 512, 24, 64, 1, 128, 64),
                                    (2, 512, 24, 64, 1, 128, 64),
                                    (4, 512, 24, 64, 1, 128, 64)) + (
                                        ssd_wide if dt == "bfloat16"
                                        else ()):
            dtype = getattr(torch, dt)
            x = randn((B, S, H, P), dtype)
            dts = F.softplus(randn((B, S, H), torch.float32))
            a_log = torch.log(torch.linspace(1.0, 4.0, H, device=dev))
            B_in = randn((B, S, G, N), dtype)
            C_in = randn((B, S, G, N), dtype)
            args = (x, dts, a_log, B_in, C_in)
            shape = {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N,
                     "chunk": Q}
            want_y, want_h = ref.ssd_scan_ref(*args)
            if dt == "float32":
                # fp32 is held against the recurrence in fp64: at B = 4,
                # S = 512 the recurrence in fp32 strays up to ~1e-4 from
                # it (its distance is reported beside), past what 2e-5
                # allows
                plain_y, plain_h = want_y, want_h
                want_y, want_h = ref.ssd_scan_ref(
                    *(t.double() for t in args))
                oracle.append({"kernel": "ssd_scan", "shape": shape,
                               "plain_fp32_vs_fp64": {
                                   "y": _compare(torch, plain_y, want_y,
                                                 dt),
                                   "state": _compare(torch, plain_h,
                                                     want_h, dt)}})
            y, h = ops.ssd_scan(*args, chunk=Q)
            torch.cuda.synchronize()
            rule = ssd_mod.route(dt, P, N, Q)
            # the CUDA cores take a shape whose blocks fit an SM
            ssd_routes = tuple(
                r for r in routes_for(rule) if r != "cuda_core"
                or build.library("ssd_scan").ssd_scan_smem_bytes(P, N, Q)
                <= build.MAX_SMEM_BYTES)
            err = check("ssd_scan", shape, dt, y, want_y, output="y",
                        route=rule, via="ops.ssd_scan")
            err_h = check("ssd_scan", shape, dt, h, want_h, output="state",
                          route=rule, via="ops.ssd_scan")
            forced, errs = {}, {}
            for r in ssd_routes:
                forced[r] = ssd_mod.launch(*args, chunk=Q, force=r)
                torch.cuda.synchronize()
                errs[r] = {
                    "y": check("ssd_scan", shape, dt, forced[r][0], want_y,
                               output="y", route=r),
                    "state": check("ssd_scan", shape, dt, forced[r][1],
                                   want_h, output="state", route=r)}
            same_route("ssd_scan", shape, dt, rule,
                       ssd_mod.launch(*args, chunk=Q), forced[rule])
            if S == 512:
                bound_ms, bound_by = _ssd_bound(dt, B, S, H, G, P, N, Q)
                wrapper = time_ms(torch, lambda: ops.ssd_scan(
                    *args, chunk=Q), iters=50)
                profiled = {}
                for r in ssd_routes:
                    profiled[r] = _kernel_records(
                        torch, lambda r=r: ssd_mod.launch(*args, chunk=Q,
                                                          force=r),
                        KERNEL_STATS["ssd_scan"])
                    cases.append({
                        "kernel": "ssd_scan", "shape": shape, "dtype": dt,
                        "route": r,
                        "check": "profiler kernel records == launches "
                                 "counted == kernels_per_call",
                        **profiled[r],
                        "ok": profiled[r]["records_per_call"]
                        == profiled[r]["launches_per_call"]
                        == ssd_mod.kernels_per_call(dt, P, N, Q, r)})
                timings["ssd_scan"].append({
                    "shape": shape, "dtype": dt, "route": rule,
                    "max_abs_err": max(err, err_h), "max_abs_err_y": err,
                    "max_abs_err_state": err_h, "ms": wrapper["ms"],
                    "host_ms": wrapper["host_ms"],
                    "covered": wrapper["covered"],
                    "routes": {r: {"max_abs_err": errs[r], **time_ms(
                        torch, lambda r=r: ssd_mod.launch(
                            *args, chunk=Q, force=r), iters=50),
                        "device_kernels_ms": profiled[r]["kernels_ms"]}
                        for r in ssd_routes},
                    "device_kernels_ms": _kernel_records(
                        torch, lambda: ops.ssd_scan(
                            *args, chunk=Q))["kernels_ms"],
                    "plain_ms": time_ms(torch, lambda: ref.ssd_scan_ref(
                        *args), iters=3, warmup=1)["ms"],
                    "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    **_ssd_cluster(torch, dt, B, S, H, P, N, Q)})

    # RG-LRU: tests/test_kernels.py grid, S of 1 and 7 (inside one
    # chunk), a partial last chunk (S = 97) and group (S = 520), partial
    # 32-column tiles (W = 48, 100), and recurrentgemma-9b's serving shape
    # at B = 1, 4.  a in (0, 1), mostly 0.8-1 as Griffin's gates make it
    # (a^c in [0.9, 0.999] at init), so carries across chunks matter.  The
    # main path's dtype is fp32
    for dt in TOL:
        for B, S, W in ((1, 64, 16), (2, 128, 48), (1, 96, 32),
                        (1, 1, 48), (2, 7, 100), (2, 97, 48), (1, 97, 100),
                        (2, 520, 100), (1, 520, 48),
                        (1, 512, 4096), (4, 512, 4096)):
            dtype = getattr(torch, dt)
            a = torch.sigmoid(randn((B, S, W), torch.float32) + 3.0).to(
                dtype)
            b = randn((B, S, W), dtype)
            h = ops.rglru_scan(a, b)
            want, want_final = ref.rglru_scan_ref(a, b)
            torch.cuda.synchronize()
            shape = {"B": B, "S": S, "W": W}
            err = check("rglru_scan", shape, dt, h, want, route="chunked",
                        via="ops.rglru_scan")
            check("rglru_scan", shape, dt, h[:, -1], want_final,
                  output="final state", route="chunked", via="ops.rglru_scan")
            if W == 4096:
                elem = a.element_size()
                nbytes = 2 * elem * B * S * W + 4 * B * S * W
                bound_ms, bound_by = _bound(nbytes, 2.0 * B * S * W, dt)
                wrapper = time_ms(torch, lambda: ops.rglru_scan(a, b),
                                  iters=50)
                timings["rglru_scan"].append({
                    "shape": shape, "dtype": dt, "route": "chunked",
                    "max_abs_err": err, "ms": wrapper["ms"],
                    "host_ms": wrapper["host_ms"],
                    "covered": wrapper["covered"],
                    "plain_ms": time_ms(torch, lambda: ref.rglru_scan_ref(
                        a, b), iters=5, warmup=1)["ms"],
                    "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": bound_by})

    # the per-launch floor of ``ms``: an empty kernel timed the same way
    launch_floor = {**time_ms(torch, lambda: torch.cuda._sleep(0),
                              iters=100),
                    "device_kernels_ms": _kernel_records(
                        torch, lambda: torch.cuda._sleep(0),
                        iters=100)["kernels_ms"]}

    # blocks a SM the footprint of the SSD's CUDA-core chunk scan allows
    # at mamba2-130m's widths (the occupancy calculator): it must hold two
    occupancy = {
        "ssd_scan/cuda_core": {
            dt: build.library("ssd_scan").ssd_scan_blocks_per_sm(
                64, 128, 64, build.DTYPE_CODES[dt]) for dt in TOL}}
    for dt, n in occupancy["ssd_scan/cuda_core"].items():
        cases.append({"kernel": "ssd_scan", "dtype": dt,
                      "shape": {"P": 64, "N": 128, "chunk": 64},
                      "check": "two chunk-scan blocks a SM",
                      "blocks_per_sm": n, "ok": n >= 2})

    # clusters of the tensor-core decode the card holds at once at the
    # serving head dims and cache lengths (and the model checks' 4096
    # slots), for every cluster size the kernel is built for
    occupancy["decode_attention/tensor_core"] = {
        f"D{D}/S{S}/cluster{c}":
            build.library("decode_attention")
            .decode_attention_max_active_clusters(D, S, c)
        for D in (64, 128, 160, 256) for S in (512, 1024, 4096)
        for c in decode_mod.CLUSTERS}

    # the tensor-core kernels hold O (up to 128 registers a thread at
    # D = 256; the pair kernel 64 at D = 128 and 80 at 160 under its cap
    # of 168), S and P at once: ptxas must fit each instance without a
    # spill (where this process built the library, so that ptxas's lines
    # are at hand)
    if "flash_attention" in build.build_log:
        for entry in ("flash_tc_pair_kernelILi128E",
                      "flash_tc_pair_kernelILi160E", "flash_tc_kernel"):
            lines = ptxas_of(build.build_log["flash_attention"], entry)
            cases.append({
                "kernel": "flash_attention", "dtype": "bfloat16",
                "check": f"{entry} compiled, no spill", "ptxas": lines,
                "ok": bool(lines) and all(
                    " 0 bytes spill stores, 0 bytes spill loads" in ln
                    for ln in lines if "spill" in ln)})

    failed = [c for c in cases if not c["ok"]]
    # headline: the serving phase's largest cells in the dtype its calls
    # pass — a 512-token bf16 prefill at b=4, a bf16 decode step at b=4
    # against gemma3-1b's 1024-slot global cache with 520 valid rows, the
    # bf16 SSD scan and the fp32 RG-LRU scan (the gates' output) at b=4
    # over a 512-token prompt
    headline = {
        "flash_attention": next(
            t for t in timings["flash_attention"]
            if t["dtype"] == "bfloat16" and t["shape"]["B"] == 4
            and t["shape"]["S"] == 512 and t["shape"]["H"] == 4
            and t["shape"]["window"] == 0),
        # the CUDA-core kernel where it runs: fp32 at row 1a's shape
        "flash_attention/fp32": next(
            t for t in timings["flash_attention"]
            if t["dtype"] == "float32" and t["shape"]["B"] == 4
            and t["shape"]["S"] == 512 and t["shape"]["H"] == 4
            and t["shape"]["window"] == 0),
        # stablelm-12b's prefill at head dim 160 (32 heads on 8)
        "flash_attention/stablelm-12b": next(
            t for t in timings["flash_attention"]
            if t["dtype"] == "bfloat16" and t["shape"]["B"] == 4
            and t["shape"]["S"] == 512 and t["shape"]["D"] == 160
            and t["shape"]["window"] == 0),
        # llama3-8b's and minitron-8b's prefill at head dim 128 (32 heads
        # on 8)
        "flash_attention/llama3-8b": next(
            t for t in timings["flash_attention"]
            if t["dtype"] == "bfloat16" and t["shape"]["B"] == 4
            and t["shape"]["S"] == 512 and t["shape"]["D"] == 128
            and (t["shape"]["H"], t["shape"]["Hkv"]) == DENSE_HEADS
            and t["shape"]["window"] == 0),
        # attn-tiny's largest serving cell: the short route's path
        "flash_attention/attn-tiny": next(
            t for t in timings["flash_attention"]
            if t["dtype"] == "float32" and t["shape"]["B"] == 256
            and t["shape"]["S"] == max(ATTN_TINY_SEQS)
            and (t["shape"]["H"], t["shape"]["D"]) == ATTN_TINY_HD),
        **{f"decode_attention{sfx}": next(
            t for t in timings["decode_attention"]
            if t["dtype"] == dt and t["shape"]["B"] == 4
            and t["shape"]["S"] == 1024 and t["shape"]["H"] == 4
            and t["shape"]["lengths"] == [520] * 4)
           for dt, sfx in (("bfloat16", ""), ("float32", "/fp32"))},
        # stablelm-12b's decode step at head dim 160 (32 heads on 8)
        "decode_attention/stablelm-12b": next(
            t for t in timings["decode_attention"]
            if t["dtype"] == "bfloat16" and t["shape"]["B"] == 4
            and t["shape"]["S"] == 1024 and t["shape"]["D"] == 160
            and t["shape"]["lengths"] == [520] * 4),
        # lm-tiny's largest decode cell: B = 8 over its 64-slot cache
        "decode_attention/lm-tiny": next(
            t for t in timings["decode_attention"]
            if t["dtype"] == "float32" and t["shape"]["B"] == 8
            and t["shape"]["S"] == LM_TINY_SLOTS
            and (t["shape"]["H"], t["shape"]["Hkv"]) == LM_TINY_HEADS
            and t["shape"]["D"] == max(LM_TINY_DIMS)),
        **{f"ssd_scan{sfx}": next(t for t in timings["ssd_scan"]
                                  if t["dtype"] == dt
                                  and t["shape"]["B"] == 4)
           for dt, sfx in (("bfloat16", ""), ("float32", "/fp32"))},
        "rglru_scan": next(t for t in timings["rglru_scan"]
                           if t["dtype"] == "float32"
                           and t["shape"]["B"] == 4),
    }
    rep = {"cases": len(cases), "failed": failed, "oracle": oracle,
           "max_abs_err": {f"{k}/{dt}/{r}": max(
               c["max_abs_err"] for c in cases if c["kernel"] == k
               and c["dtype"] == dt and c.get("route") == r
               and "max_abs_err" in c)
               for k in timings for dt in TOL
               for r in ROUTES
               if any(c["kernel"] == k and c["dtype"] == dt
                      and c.get("route") == r for c in cases)},
           "tolerance": {dt: {"atol": a, "rtol": r}
                         for dt, (a, r) in TOL.items()},
           "sleep_cycles_per_ms": _cycles_per_ms(torch),
           "launch_floor": launch_floor, "blocks_per_sm": occupancy,
           "timings": timings, "headline": headline}
    if failed:
        emit({"phase": "kernels", **rep})
        raise AssertionError(f"{len(failed)} kernel cases out of tolerance")
    return rep


# --------------------------------------------------------------------- #
# phase 3: full-width models, kernels vs the plain path
# --------------------------------------------------------------------- #
def phase_model(torch, name: str):
    t_start = time.perf_counter()
    rep = (_model_check_incremental(torch, name) if not PATHS[name]
           else _model_check(torch, name))
    rep["seconds"] = time.perf_counter() - t_start
    return rep


def _model_check(torch, name: str):
    """One prompt and 8 decode steps through the kernels against the same
    weights through the plain path, in fp32 and in bf16."""
    from repro_torch.models.lm import (decode_step, init_params,
                                       param_count, prefill)
    dev = torch.device("cuda")
    base = _config(name)
    S, max_len = MODEL_CHECK[name]
    n_dec = 8
    gen = torch.Generator().manual_seed(1)
    batch, dec = _prompt(torch, base, S, n_dec, gen,
                         MODEL_FRAMES.get(name, 0))

    def run(cfg, params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, cfg, max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs = [logits[:, 0]]
        t0 = time.perf_counter()
        for i in range(n_dec):
            logits, cache = decode_step(params, cache, dec[:, i:i + 1],
                                        S + i, cfg)
            outs.append(logits[:, 0])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / n_dec
        return torch.stack(outs), prefill_ms, decode_ms

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rep = {"config": name, "layers": base.n_layers, "prompt": S,
           "inputs": {k: list(v.shape) for k, v in batch.items()},
           "decode_steps": n_dec, "max_len": max_len}
    with torch.no_grad():
        cfg = base.with_overrides(dtype="float32", use_pallas_kernels=True)
        params = init_params(cfg, 0, device=dev)
        rep["param_count"] = param_count(params)
        k32, _, _ = run(cfg, params)
        p32, _, _ = run(cfg.with_overrides(use_pallas_kernels=False), params)
        del params
        _free(torch)
        err32 = rel(k32, p32)
        rep["fp32"] = {"rel_err": err32, "tolerance": 1e-3,
                       "finite": bool(torch.isfinite(k32).all())}

        cfg = base.with_overrides(use_pallas_kernels=True)       # bf16
        params = init_params(cfg, 0, device=dev)
        k16, _, _ = run(cfg, params)
        plain = cfg.with_overrides(use_pallas_kernels=False)
        p16, _, _ = run(plain, params)
        # second runs are the timed ones (the first pays cuBLAS set-up)
        _, k_pre, k_dec = run(cfg, params)
        _, p_pre, p_dec = run(plain, params)
        del params
        _free(torch)
    err_k, err_p = rel(k16, p32), rel(p16, p32)
    tol16 = max(2.0 * err_p, 2e-2)
    rep["bf16"] = {"rel_err_kernels_vs_fp32": err_k,
                   "rel_err_plain_vs_fp32": err_p,
                   "rel_err_kernels_vs_plain": rel(k16, p16),
                   "tolerance": tol16,
                   "finite": bool(torch.isfinite(k16).all()),
                   "prefill_ms": {"kernels": k_pre, "plain": p_pre},
                   "decode_step_ms": {"kernels": k_dec, "plain": p_dec}}
    if not (rep["fp32"]["finite"] and err32 <= 1e-3):
        emit({"phase": "model", **rep})
        raise AssertionError(f"{name}: fp32 logits differ: {err32}")
    if not (rep["bf16"]["finite"] and err_k <= tol16):
        emit({"phase": "model", **rep})
        raise AssertionError(f"{name}: bf16 logits differ: {err_k} > "
                             f"{tol16}")
    return rep


def _model_check_incremental(torch, name: str):
    """A path with no kernel: prefill + decode steps (the absorbed latent
    decode) against a full-sequence forward (expanded attention) over the
    same tokens, in fp32 and in bf16, on a dropless MoE."""
    import dataclasses
    from repro_torch.models.lm import (apply_head, decode_step, forward,
                                       init_params, param_count, prefill)
    dev = torch.device("cuda")
    published = _config(name)
    base = published.with_overrides(moe=dataclasses.replace(
        published.moe, capacity_factor=DROPLESS_CF))
    S, max_len = MODEL_CHECK[name]
    n_dec = 8
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, base.vocab_size, (1, S + n_dec),
                           generator=gen).to(dev)

    def run(cfg, params):
        """(forward logits, incremental logits) at positions S-1..S+7,
        and the incremental path's prefill ms and ms per decode step."""
        hidden = forward(params, {"tokens": tokens}, cfg)
        full = apply_head(params, hidden[:, S - 1:], cfg)[0]
        del hidden
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens[:, :S]}, cfg,
                                max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs = [logits[0, 0]]
        t0 = time.perf_counter()
        for i in range(S, S + n_dec):
            logits, cache = decode_step(params, cache, tokens[:, i:i + 1],
                                        i, cfg)
            outs.append(logits[0, 0])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / n_dec
        return full, torch.stack(outs), prefill_ms, decode_ms

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rep = {"config": name, "cut": CUT.get(name, {}), "layers": base.n_layers,
           "check": "prefill + decode vs forward",
           "capacity_factor_override": DROPLESS_CF, "prompt": S,
           "decode_steps": n_dec, "max_len": max_len}
    print(f"chip_smoke: {name} model check: MoE capacity_factor "
          f"{published.moe.capacity_factor} -> {DROPLESS_CF} (dropless)",
          flush=True)
    with torch.no_grad():
        cfg = base.with_overrides(dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, 0, device=dev)
        rep["param_count"] = param_count(params)
        f32, i32, _, _ = run(cfg, params)
        rep["fp32_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params
        _free(torch)
        err32 = rel(i32, f32)
        rep["fp32"] = {"rel_err": err32, "tolerance": 1e-3,
                       "finite": bool(torch.isfinite(i32).all())}

        cfg = base                                               # bf16
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, 0, device=dev)
        f16, i16, _, _ = run(cfg, params)
        # the second run is the timed one (the first pays cuBLAS set-up)
        _, _, pre_ms, dec_ms = run(cfg, params)
        rep["bf16_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params
        _free(torch)
    err_i, err_f = rel(i16, f32), rel(f16, f32)
    tol16 = max(2.0 * err_f, 2e-2)
    rep["bf16"] = {"rel_err_incremental_vs_fp32": err_i,
                   "rel_err_forward_vs_fp32": err_f,
                   "rel_err_incremental_vs_forward": rel(i16, f16),
                   "tolerance": tol16,
                   "finite": bool(torch.isfinite(i16).all()),
                   "prefill_ms": pre_ms, "decode_step_ms": dec_ms}
    if not (rep["fp32"]["finite"] and err32 <= 1e-3):
        emit({"phase": "model", **rep})
        raise AssertionError(f"{name}: fp32 prefill + decode differs from "
                             f"the forward: {err32}")
    if not (rep["bf16"]["finite"] and err_i <= tol16):
        emit({"phase": "model", **rep})
        raise AssertionError(f"{name}: bf16 prefill + decode differs: "
                             f"{err_i} > {tol16}")
    return rep


def phase_moe(torch, name: str = "deepseek-v2-236b"):
    """The MoE layer at full width and its published capacity factor:
    dispatch on the card equals the CPU's, ``apply_moe`` repeats bit for
    bit, and its device time beside the card's bound."""
    from repro_torch.models.moe import (apply_moe, capacity, init_moe,
                                        moe_dispatch_indices, router_probs)
    dev = torch.device("cuda")
    cfg = _config(name)                                          # bf16
    moe, d, ff = cfg.moe, cfg.d_model, cfg.moe.expert_ff
    E, k = moe.n_experts, moe.top_k
    gen = torch.Generator().manual_seed(4)
    rep = {"config": name, "capacity_factor": moe.capacity_factor,
           "dispatch": {}, "apply": {}}
    failures = []
    with torch.no_grad():
        params = init_moe(torch.Generator(device=dev).manual_seed(3), cfg,
                          torch.bfloat16)
        # the serve prefill's token count; the same tokens pushed toward
        # expert 0, which then takes every token and drops all but its
        # capacity; a B = 4 decode step
        router_0 = params["router"][:, 0] / params["router"][:, 0].norm()
        for case, T, push in (("2048", 2048, 0.0),
                              ("2048-skewed", 2048, 10.0), ("4", 4, 0.0)):
            x = torch.randn((T, d), generator=gen).to(dev)
            x = (x + push * router_0).to(torch.bfloat16)
            gates, experts = router_probs(params, x, moe)
            cap = capacity(T, moe)
            idx, slot_gate = moe_dispatch_indices(experts, gates, E, cap)
            idx_c, gate_c = moe_dispatch_indices(experts.cpu(), gates.cpu(),
                                                 E, cap)
            equal = bool(torch.equal(idx.cpu(), idx_c)
                         and torch.equal(slot_gate.cpu(), gate_c))
            dropped = T * k - int((idx_c < T).sum())
            rep["dispatch"][case] = {"tokens": T, "capacity": cap,
                                       "assignments": T * k,
                                       "dropped": dropped, "equal": equal}
            print(f"chip_smoke: moe dispatch {case} capacity={cap}: "
                  f"{dropped} of {T * k} assignments dropped", flush=True)
            if not equal:
                failures.append(f"dispatch {case} differs from the CPU's")
        if rep["dispatch"]["2048-skewed"]["dropped"] <= 0:
            failures.append("the skewed tokens dropped nothing")
        expert_bytes = 3 * d * ff * 2                  # one expert, bf16
        shared_bytes = 3 * d * ff * moe.n_shared * 2 + d * E * 4
        for label, (B, S) in (("prefill", (4, 512)), ("decode", (4, 1))):
            T = B * S
            x = torch.randn((B, S, d), generator=gen).to(dev, torch.bfloat16)
            a, b = apply_moe(params, x, cfg), apply_moe(params, x, cfg)
            identical = bool(torch.equal(a, b))
            if not (identical and torch.isfinite(a).all()):
                failures.append(f"apply_moe at {label} is not repeatable "
                                "or not finite")
            t = time_ms(torch, lambda: apply_moe(params, x, cfg), iters=10)
            _, experts = router_probs(params, x.reshape(T, d), moe)
            cap = capacity(T, moe)
            idx, _ = moe_dispatch_indices(experts, torch.ones_like(
                experts, dtype=torch.float32), E, cap)
            kept = int((idx < T).sum())
            hit = int(((idx < T).sum(1) > 0).sum())
            # the least work for these tokens: the experts they reach,
            # read once, and their kept assignments' GLUs
            bytes_moved = (hit * expert_bytes + shared_bytes
                           + 2 * T * d * 2)
            flops = 6 * d * ff * (kept + T * moe.n_shared) + 2 * T * d * E
            bound_ms, bound_by = _bound(bytes_moved, flops, "bfloat16")
            rep["apply"][label] = {
                "tokens": T, "capacity": cap, "experts_hit": hit,
                "bit_identical": identical, **t, "bound_ms": bound_ms,
                "bound_by": bound_by,
                # capacity tiles run every expert: their weights alone
                "all_experts_read_ms": E * expert_bytes / MEM_BW * 1e3}
        del params
        _free(torch)
    if failures:
        emit({"phase": "moe", **rep})
        raise AssertionError(f"{name}: " + "; ".join(failures))
    return rep


# --------------------------------------------------------------------- #
# phase 3c: distribution — a one-rank NCCL mesh, compression, 4-rank EP
# --------------------------------------------------------------------- #
def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_distributed(torch):
    """gemma3-1b's bf16 decode with DTensor parameters and cache on a
    (1, 1) mesh of a one-rank NCCL group, bit for bit the plain step's;
    ``compressed_psum`` over that group on a full-size fp32 tree of
    gemma3-1b's parameter shapes, bit for bit quantize → dequantize (and
    the card's quantization the CPU's); then deepseek-v2-236b's MoE layer
    at full width over :data:`EP_RANKS` gloo processes on the card."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    rep = {}
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
        world_size=1)
    try:
        rep["decode"] = _dist_decode(torch)
        _free(torch)
        rep["train"] = _dist_train(torch)
        _free(torch)
        rep["compressed_psum"] = _dist_psum(torch, dist.group.WORLD)
        _free(torch)
    finally:
        dist.destroy_process_group()
    rep["expert_parallel"] = _dist_ep(torch)
    _free(torch)
    failures = [f"{k}: {v['failure']}" for k, v in rep.items()
                if v.get("failure")]
    rep["seconds"] = time.perf_counter() - t0
    if failures:
        emit({"phase": "distributed", **rep})
        raise AssertionError("distributed: " + "; ".join(failures))
    return rep


def _dist_decode(torch):
    """gemma3-1b's prefill with DTensor parameters and prompt on the (1, 1)
    mesh (its cache built laid out by ``cache_pspecs``) against the plain
    prefill, then decode steps from that DTensor cache against the plain
    steps from the plain cache: logits and every cache leaf bit for bit."""
    from repro_torch.distributed import (batch_pspecs, cache_pspecs,
                                         distribute_tree, params_pspecs,
                                         to_placements)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import decode_step, init_params, prefill
    from repro_torch.training.tree import leaves_with_path
    dev = torch.device("cuda")
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = _config("gemma3-1b").with_overrides(use_pallas_kernels=False)
    gen = torch.Generator().manual_seed(5)
    S, n_dec = DIST_PROMPT, DIST_DECODE
    batch, dec = _prompt(torch, cfg, S, n_dec, gen)
    rep = {"config": cfg.name, "mesh": [1, 1], "backend": "nccl",
           "prompt": S, "max_len": DIST_MAX_LEN, "decode_steps": n_dec}

    def caches_equal(d_cache, cache):
        return all(_bits_equal(torch, g.full_tensor(), w)
                   for (_, g), (_, w) in zip(leaves_with_path(d_cache),
                                             leaves_with_path(cache)))

    with torch.no_grad():
        params = init_params(cfg, 0, device=dev)
        want, cache = prefill(params, batch, cfg, max_len=DIST_MAX_LEN)
        d_params = distribute_tree(params, params_pspecs(cfg, params, mesh),
                                   mesh)
        d_batch = distribute_tree(batch, batch_pspecs(batch, mesh), mesh)
        got, d_cache = prefill(d_params, d_batch, cfg, max_len=DIST_MAX_LEN)
        specs = cache_pspecs(cfg, d_cache, mesh)
        rep["prefill"] = {
            "logits_bit_equal": _bits_equal(torch, got.full_tensor(), want),
            "cache_bit_equal": caches_equal(d_cache, cache),
            "cache_laid_out": all(
                tuple(g.placements) == tuple(to_placements(mesh, sp))
                for (_, g), (_, sp) in zip(leaves_with_path(d_cache),
                                           leaves_with_path(specs)))}
        equal, ms = [], {"plain": [], "dtensor": []}
        for i in range(n_dec):
            tok = dec[:, i:i + 1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, cache = decode_step(params, cache, tok, S + i, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got, d_cache = decode_step(d_params, d_cache, tok, S + i, cfg)
            got = got.full_tensor()
            torch.cuda.synchronize()
            ms["plain"].append((t1 - t0) * 1e3)
            ms["dtensor"].append((time.perf_counter() - t1) * 1e3)
            equal.append(_bits_equal(torch, got, want))
        cache_equal = caches_equal(d_cache, cache)
    rep.update({"logits_bit_equal": equal, "cache_bit_equal": cache_equal,
                "finite": bool(torch.isfinite(want).all()),
                "step_ms": ms})
    print(f"chip_smoke: distributed prefill on a (1, 1) NCCL mesh: "
          f"{rep['prefill']}; decode from its cache: logits bit-equal "
          f"{equal}, cache {cache_equal}", flush=True)
    if not (all(rep["prefill"].values()) and all(equal) and cache_equal
            and rep["finite"]):
        rep["failure"] = ("the DTensor prefill or decode differs from the "
                          "plain step")
    return rep


def _dist_train(torch):
    """Two full-width gemma3-1b train steps with DTensor parameters and
    batch and the moments laid out by ``optimizer_pspecs`` (ZeRO) on the
    (1, 1) mesh, each against the plain step from the same state: loss,
    every parameter and moment bit for bit, every layout kept."""
    from repro_torch.data import batches_for_model
    from repro_torch.distributed import (batch_pspecs, distribute_tree,
                                         optimizer_pspecs, params_pspecs)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import init_params
    from repro_torch.training import (AdamWConfig, TrainConfig, init_adamw,
                                      make_train_step)
    from repro_torch.training.tree import leaves_with_path
    from repro_torch.configs.base import ShapeConfig
    dev = torch.device("cuda")
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = _config(TRAIN_ARCH).with_overrides(use_pallas_kernels=False)
    tcfg = TrainConfig(adamw=AdamWConfig(learning_rate=1e-3,
                                         warmup_steps=20))
    B, S = DIST_TRAIN_BATCH, DIST_TRAIN_SEQ
    data = batches_for_model(cfg, ShapeConfig("dist", S, B, "train"))
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device=dev)
    state = init_adamw(tcfg.adamw, params)
    p_spec = params_pspecs(cfg, params, mesh)
    o_spec = optimizer_pspecs(p_spec, params, mesh)
    d_params = distribute_tree(params, p_spec, mesh)
    d_state = state._replace(mu=distribute_tree(state.mu, o_spec, mesh),
                             nu=distribute_tree(state.nu, o_spec, mesh))
    layout = [tuple(t.placements) for t in
              (x for tree in (d_params, d_state.mu, d_state.nu)
               for _, x in leaves_with_path(tree))]
    step = make_train_step(cfg, tcfg)
    rep = {"config": cfg.name, "batch": B, "seq": S, "steps": []}
    for _ in range(2):
        batch = {k: v.to(dev) for k, v in next(data).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d_batch = distribute_tree(batch, batch_pspecs(batch, mesh), mesh)
        d_params, d_state, d_m = step(d_params, d_state, d_batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pairs = [(g, w) for got, want in ((d_params, params),
                                          (d_state.mu, state.mu),
                                          (d_state.nu, state.nu))
                 for (_, g), (_, w) in zip(leaves_with_path(got),
                                           leaves_with_path(want))]
        rep["steps"].append({
            "loss": float(m["loss"]),
            "loss_bit_equal": _bits_equal(torch, d_m["loss"].full_tensor(),
                                          m["loss"]),
            "state_bit_equal": all(_bits_equal(torch, g.full_tensor(), w)
                                   for g, w in pairs),
            "layout_kept": [tuple(g.placements) for g, _ in pairs] == layout,
            "plain_ms": (t1 - t0) * 1e3, "dtensor_ms": (t2 - t1) * 1e3})
    rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, state, d_params, d_state
    print(f"chip_smoke: ZeRO train steps on a (1, 1) NCCL mesh, B = {B}: "
          f"{rep['steps']}, peak {rep['peak_gib']:.2f} GiB", flush=True)
    if not all(s["loss_bit_equal"] and s["state_bit_equal"]
               and s["layout_kept"] for s in rep["steps"]):
        rep["failure"] = "the ZeRO train steps differ from the plain steps"
    return rep


def _dist_psum(torch, group):
    from repro_torch.distributed import (compressed_psum, compressed_psum_tree,
                                         dequantize_blockwise,
                                         psum_bytes_saved,
                                         quantize_blockwise)
    from repro_torch.models.lm import param_specs
    from repro_torch.training.tree import leaves_with_path, tree_map
    dev = torch.device("cuda")
    cfg = _config("gemma3-1b")
    gen = torch.Generator(device=dev).manual_seed(6)
    tree = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                          device=dev), param_specs(cfg))
    n = sum(t.numel() for _, t in leaves_with_path(tree))
    rep = {"config": cfg.name, "values": n, "dtype": "float32",
           "leaves": len(leaves_with_path(tree))}
    failures = []
    if n != DIST_PSUM_VALUES:
        failures.append(f"{n} values, not {DIST_PSUM_VALUES}")
    # the card's compressed_psum = its own quantize → dequantize, per leaf
    equal = True
    for _, x in leaves_with_path(tree):
        got = compressed_psum(x, group)
        want = dequantize_blockwise(*quantize_blockwise(x), x.shape)
        equal &= _bits_equal(torch, got, want)
        del got, want
    rep["bit_equal_to_quantize_dequantize"] = equal
    if not equal:
        failures.append("compressed_psum differs from quantize → dequantize")
    # the card's quantization = the CPU's on a 2^20-value slice
    x = tree["embed"].reshape(-1)[:1 << 20]
    q, sc, pad = quantize_blockwise(x)
    q_c, sc_c, pad_c = quantize_blockwise(x.cpu())
    rep["slice_bit_equal_to_cpu"] = bool(
        pad == pad_c and _bits_equal(torch, q.cpu(), q_c)
        and _bits_equal(torch, sc.cpu(), sc_c))
    if not rep["slice_bit_equal_to_cpu"]:
        failures.append("the card's quantization differs from the CPU's")
    t = time_ms(torch, lambda: compressed_psum_tree(tree, group), iters=3,
                warmup=1)
    full, comp = psum_bytes_saved(tree)
    # the least work: read each value once, write each result once
    bound_ms, bound_by = _bound(2 * full, 0.0, "float32")
    rep.update({**t, "bound_ms": bound_ms, "bound_by": bound_by,
                "fp32_bytes": full, "compressed_bytes": comp})
    print(f"chip_smoke: compressed_psum of {n} fp32 values on one rank: "
          f"{t['ms']:.3f} ms (bound {bound_ms:.3f} ms)", flush=True)
    if failures:
        rep["failure"] = "; ".join(failures)
    return rep


def _ep_layer(torch, cfg, experts, dev):
    """deepseek-v2-236b's MoE layer in fp32 with seeded weights: the
    router and shared experts (one seed), and routed experts ``experts``
    stacked, expert e from seed EP_SEED + e whichever process makes it."""
    moe, d = cfg.moe, cfg.d_model
    ff, sff = moe.expert_ff, moe.expert_ff * moe.n_shared

    def draw(seed, shape, fan_in):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev) / fan_in ** 0.5

    params = {"router": draw(EP_SEED, (d, moe.n_experts), d),
              "shared": {"gate": draw(EP_SEED + 1, (d, sff), d),
                         "up": draw(EP_SEED + 2, (d, sff), d),
                         "down": draw(EP_SEED + 3, (sff, d), sff)}}
    for name in ("gate", "up", "down"):
        params[name] = torch.empty(
            (len(experts), ff, d) if name == "down" else
            (len(experts), d, ff), device=dev)
    for i, e in enumerate(experts):
        base = EP_SEED + 16 + 3 * e
        params["gate"][i] = draw(base, (d, ff), d)
        params["up"][i] = draw(base + 1, (d, ff), d)
        params["down"][i] = draw(base + 2, (ff, d), ff)
    return params


def _ep_inputs(torch, cfg, params, dev):
    """The layer's input (EP_BATCH, EP_SEQ, d), and the same tokens pushed
    toward expert 0 (as the moe phase's), which must drop at 1.25."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((EP_BATCH, EP_SEQ, cfg.d_model), generator=gen).to(dev)
    r0 = params["router"][:, 0]
    return {"dropless": x, "1.25": x + EP_PUSH * r0 / r0.norm()}


def _ep_rank(rank: int, port: int, out: str, device: str) -> None:
    """One of :data:`EP_RANKS` processes: its share of the experts, the
    dispatch on its device against the CPU's, and ``apply_moe_ep``."""
    import dataclasses
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=EP_RANKS)
    try:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor.experimental import \
            implicit_replication
        from repro_torch.distributed.expert_parallel import (apply_moe_ep,
                                                             ep_dispatch)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.moe import router_probs
        dev = torch.device(device)
        mesh = make_mesh((EP_RANKS,), ("model",), device_type=device)
        cfg = _config("deepseek-v2-236b").with_overrides(dtype="float32")
        moe = cfg.moe
        e_local = moe.n_experts // EP_RANKS
        params = _ep_layer(torch, cfg, range(rank * e_local,
                                             (rank + 1) * e_local), dev)
        for name in ("gate", "up", "down"):
            params[name] = DTensor.from_local(params[name], mesh, [Shard(0)])
        s_local = EP_SEQ // EP_RANKS
        res = {}
        with torch.no_grad():
            for label, x in _ep_inputs(torch, cfg, params, dev).items():
                cf = DROPLESS_CF if label == "dropless" else \
                    moe.capacity_factor
                c = cfg.with_overrides(moe=dataclasses.replace(
                    moe, capacity_factor=cf))
                # this rank's tokens, their dispatch here and on the CPU
                # from the same router output
                xs = x[:, rank * s_local:(rank + 1) * s_local].reshape(
                    -1, cfg.d_model)
                gates, experts = router_probs(params, xs, moe)
                T = xs.shape[0]
                cap = max(4, math.ceil(T * moe.top_k * cf / EP_RANKS))
                here = ep_dispatch(experts, gates, EP_RANKS, e_local, cap)
                cpu = ep_dispatch(experts.cpu(), gates.cpu(), EP_RANKS,
                                  e_local, cap)
                equal = all(torch.equal(a.cpu(), b)
                            for a, b in zip(here, cpu))
                kept = int((cpu[3] < EP_RANKS * cap).sum())
                x_d = DTensor.from_local(x, mesh, [Replicate()])
                dist.barrier()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                with implicit_replication():
                    y = apply_moe_ep(params, x_d, c, mesh=mesh)
                    y = y.redistribute(mesh, [Shard(1)]).to_local()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                res[label] = {"y": y.cpu(), "dispatch_equal": equal,
                              "capacity": cap, "kept": kept,
                              "assignments": T * moe.top_k,
                              "ms": (time.perf_counter() - t0) * 1e3}
        torch.save(res, f"{out}/ep_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dist_ep(torch, device: str = "cuda"):
    """:func:`_ep_rank` on :data:`EP_RANKS` spawned processes, then one
    process's ``apply_moe`` on the whole layer (dropless) against their
    gathered output."""
    import dataclasses
    import multiprocessing as mp
    import shutil
    from repro_torch.models.moe import apply_moe
    out = ROOT / "build" / "distributed"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_ep_rank, args=(r, port, str(out), device))
             for r in range(EP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + EP_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall_s = time.perf_counter() - t0
    cfg = _config("deepseek-v2-236b").with_overrides(dtype="float32")
    moe = cfg.moe
    rep = {"config": cfg.name, "ranks": EP_RANKS, "backend": "gloo",
           "tensors": device, "mesh": {"model": EP_RANKS},
           "experts_per_rank": moe.n_experts // EP_RANKS,
           "tokens": [EP_BATCH, EP_SEQ], "d_model": cfg.d_model,
           "expert_ff": moe.expert_ff, "top_k": moe.top_k,
           "n_shared": moe.n_shared, "dtype": "float32",
           "exitcodes": [p.exitcode for p in procs], "wall_s": wall_s,
           "note": "gloo carries the all-to-alls through the host: these "
                   "times say nothing about EP over NVLink"}
    if any(code != 0 for code in rep["exitcodes"]):
        rep["failure"] = f"EP ranks exited with {rep['exitcodes']}"
        return rep
    ranks = [torch.load(out / f"ep_{r}.pt") for r in range(EP_RANKS)]
    shutil.rmtree(out, ignore_errors=True)
    failures = []
    for label in ("dropless", "1.25"):
        rows = [r[label] for r in ranks]
        rep[label] = {
            "capacity_factor": DROPLESS_CF if label == "dropless"
            else moe.capacity_factor,
            "capacity": rows[0]["capacity"],
            "dispatch_equal_to_cpu": all(r["dispatch_equal"] for r in rows),
            "dropped": sum(r["assignments"] - r["kept"] for r in rows),
            "rank_ms": [r["ms"] for r in rows]}
        if not rep[label]["dispatch_equal_to_cpu"]:
            failures.append(f"{label}: the kept set differs from the CPU's")
    if rep["dropless"]["dropped"] != 0 or rep["1.25"]["dropped"] <= 0:
        failures.append("the dropless run dropped, or the skewed run at "
                        "1.25 did not")
    dev = torch.device("cuda")
    with torch.no_grad():
        params = _ep_layer(torch, cfg, range(moe.n_experts), dev)
        x = _ep_inputs(torch, cfg, params, dev)["dropless"]
        c = cfg.with_overrides(moe=dataclasses.replace(
            moe, capacity_factor=DROPLESS_CF))
        want = apply_moe(params, x, c).cpu()
        del params
    got = torch.cat([r["dropless"]["y"] for r in ranks], dim=1)
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    rep["dropless"].update({"rel_err_vs_apply_moe": err, "tolerance": 1e-5,
                            "finite": bool(torch.isfinite(got).all())})
    print(f"chip_smoke: EP over {EP_RANKS} gloo ranks ({device} tensors): "
          f"dropless {err:.3g} of max |y| from apply_moe; "
          f"{rep['1.25']['dropped']} of "
          f"{EP_BATCH * EP_SEQ * moe.top_k} assignments dropped at 1.25; "
          f"rank ms {rep['dropless']['rank_ms']} (gloo through the host)",
          flush=True)
    if not (err <= 1e-5 and rep["dropless"]["finite"]):
        failures.append(f"dropless EP is {err} from apply_moe")
    if failures:
        rep["failure"] = "; ".join(failures)
    return rep


# --------------------------------------------------------------------- #
# the analytic profiler's count against the card
# --------------------------------------------------------------------- #
def phase_profile(torch):
    """gemma3-1b's decode step (t = 1: the plain step, kernels off, as the
    analytic profiler counts it) at b in :data:`PROFILE_BATCHES` and
    :data:`PROFILE_SEQ` cache slots: ``program_cost`` on meta against the
    same count on the card's tensors (FLOPs, bytes, launches, residency:
    equal); the counted launches beside the profiler's launch calls and
    kernel records of the same step; the argument bytes against the
    bytes of the parameters and cache resident on the card; the
    predicted peak beside ``max_memory_allocated``; and
    ``GPUPackratProfiler``'s L(1, b) beside the step's wall and
    device-busy time."""
    from repro_torch.launch.profile_gpu import (GPUPackratProfiler,
                                                decode_args, decode_cost)
    from repro_torch.launch.step_cost import program_cost
    from repro_torch.training.tree import leaves_with_path
    t0 = time.perf_counter()
    cfg = _config("gemma3-1b")
    prof_file = ROOT / "build" / "profile_gpu_gemma3-1b.json"
    prof_file.unlink(missing_ok=True)
    prof = GPUPackratProfiler("gemma3-1b", seq_len=PROFILE_SEQ,
                              cache_file=str(prof_file))
    rows, failures = [], []
    for b in PROFILE_BATCHES:
        meta = decode_cost(cfg, 1, b, PROFILE_SEQ)
        _free(torch)
        base = torch.cuda.memory_allocated()
        step, args = decode_args(cfg, b, PROFILE_SEQ, device="cuda")
        resident = sum({t.untyped_storage().data_ptr():
                        t.untyped_storage().nbytes()
                        for _, t in leaves_with_path(list(args))}.values())
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        card = program_cost(step, *args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        for _ in range(2):                   # warm-up: cuBLAS, allocator
            step(*args)
        trace = _traced(torch, lambda: step(*args), 1)
        terms = prof.terms(1, b)

        def fields(c):
            return {"flops": c.cost.flops, "hbm_bytes": c.cost.hbm_bytes,
                    "launches": c.launches,
                    "argument_bytes": c.cost.argument_bytes,
                    "temp_bytes": c.cost.temp_bytes,
                    "output_bytes": c.cost.output_bytes,
                    "alias_bytes": c.alias_bytes}
        ops_diff = {k: card.ops.get(k, 0) - meta.ops.get(k, 0)
                    for k in set(card.ops) | set(meta.ops)
                    if card.ops.get(k, 0) != meta.ops.get(k, 0)}
        wall_s = trace["wall_ms_per_step"] / 1e3
        row = {"batch": b, "meta": fields(meta), "card": fields(card),
               "ops_dispatched_differently": ops_diff,
               "profiler_launch_calls": trace["launches_per_step"],
               "profiler_kernel_records": trace["kernel_records_per_step"],
               "resident_bytes": resident, "allocated_bytes": allocated,
               "predicted_peak_bytes": card.peak_bytes,
               "max_memory_allocated_bytes": peak,
               "L_s": terms.latency, "L_dispatch_s":
                   terms.hw.dispatch_overhead,
               "L_terms_s": {"compute": terms.compute_s,
                             "memory": terms.memory_s,
                             "collective": terms.collective_s},
               "wall_s": wall_s,
               "busy_s": trace["device_busy_ms_per_step"] / 1e3,
               "wall_over_L": wall_s / terms.latency,
               "busy_over_L": trace["device_busy_ms_per_step"] / 1e3
               / terms.latency,
               "host_s_per_launch": wall_s / card.launches}
        rows.append(row)
        print(f"chip_smoke: profile b={b}: launches counted "
              f"{card.launches} (meta {meta.launches}), profiler launch "
              f"calls {trace['launches_per_step']:.0f}, kernel records "
              f"{trace['kernel_records_per_step']:.0f}; L(1, b) "
              f"{terms.latency * 1e3:.3f} ms, wall {wall_s * 1e3:.3f} ms, "
              f"busy {row['busy_s'] * 1e3:.3f} ms; peak predicted "
              f"{card.peak_bytes} / measured {peak}", flush=True)
        if fields(meta) != fields(card) or ops_diff:
            failures.append(f"b={b}: the meta count differs from the card's")
        if card.cost.argument_bytes != resident:
            failures.append(f"b={b}: argument bytes "
                            f"{card.cost.argument_bytes} != resident "
                            f"{resident}")
        del step, args
        _free(torch)
    rep = {"config": cfg.name, "t": 1, "seq_len": PROFILE_SEQ,
           "rows": rows, "seconds": time.perf_counter() - t0}
    if failures:
        rep["failure"] = "; ".join(failures)
        emit({"phase": "profile", **rep})
        raise AssertionError("profile: " + rep["failure"])
    return rep


# --------------------------------------------------------------------- #
# phase 4: host vs device time of a full-width step
# --------------------------------------------------------------------- #
def _trace_report(prof, wall_ms, enqueue_ms, steps):
    """``wall_ms``/``enqueue_ms`` come from an untraced run of the same
    steps; device time, launches and the host's time inside PyTorch
    operators (self time, so nested operators count once; the rest of
    the enqueue time is Python between them) from the traced one."""
    import collections
    from torch.autograd import DeviceType
    by_name = collections.Counter()
    host_ops = collections.Counter()
    kernels = 0              # device kernel records, against the launches
    for e in _device_events(prof):
        by_name[e.name[:80]] += e.device_time_total / 1e3
        kernels += not e.name.startswith(("Memcpy", "Memset"))
    for e in prof.events():
        if e.device_type != DeviceType.CUDA and \
                not e.name.startswith("ProfilerStep"):   # _profile's cycle
            host_ops[e.name[:80]] += e.self_cpu_time_total / 1e3
    busy_ms = sum(by_name.values())
    # cuBLAS launches its GEMMs through cudaLaunchKernelExC
    launches = sum(1 for e in prof.events() if e.name in LAUNCH_CALLS)
    return {"wall_ms_per_step": wall_ms / steps,
            "host_enqueue_ms_per_step": enqueue_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "launches_per_step": launches / steps,
            "kernel_records_per_step": kernels / steps,
            "top_kernels_ms_per_step": {
                name: ms / steps
                for name, ms in by_name.most_common(TRACE_TOP)},
            "host_op_self_ms_per_step": sum(host_ops.values()) / steps,
            "top_host_ops_ms_per_step": {
                name: ms / steps
                for name, ms in host_ops.most_common(TRACE_TOP)}}


def _traced(torch, fn, steps):
    """One untraced run of ``fn`` (``steps`` steps) on the host clock,
    then one under ``torch.profiler`` (:func:`_trace_report`)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = _profile(torch, fn)
    return _trace_report(prof, wall * 1e3, enqueue * 1e3, steps)


def phase_trace(torch, name: str):
    from repro_torch.models.lm import decode_step, init_params, prefill
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    cfg = _config(name).with_overrides(use_pallas_kernels=True)  # bf16
    gen = torch.Generator().manual_seed(2)
    batch, dec = _prompt(torch, cfg, TRACE_PROMPT, TRACE_DECODE, gen)

    def run_prefill():
        return prefill(params, batch, cfg, max_len=TRACE_MAX_LEN)

    def run_decode(cache):
        for i in range(TRACE_DECODE):
            decode_step(params, cache, dec[:, i:i + 1], TRACE_PROMPT + i,
                        cfg)

    def traced(fn, steps):
        return _traced(torch, fn, steps)

    with torch.no_grad():
        params = init_params(cfg, 0, device=dev)
        for _ in range(2):                      # warm-up: cuBLAS, allocator
            _, cache = run_prefill()
            run_decode(cache)
        rep_prefill = traced(run_prefill, 1)
        # decode positions repeat across the two runs: the caches are
        # rewritten in place at the same slots (a recurrent state moves
        # on, which changes no shape and no launch)
        _, cache = run_prefill()
        rep_decode = traced(lambda: run_decode(cache), TRACE_DECODE)
        del params, cache
        _free(torch)
    if rep_prefill["device_busy_ms_per_step"] <= 0 or \
            rep_decode["device_busy_ms_per_step"] <= 0:
        raise AssertionError(f"{name}: the trace saw no device time")
    return {"config": name, "dtype": cfg.dtype, "batch": 1,
            "prompt": TRACE_PROMPT,
            "inputs": {k: list(v.shape) for k, v in batch.items()},
            "decode_steps": TRACE_DECODE,
            "prefill": rep_prefill, "decode": rep_decode,
            "seconds": time.perf_counter() - t_start}


# --------------------------------------------------------------------- #
# phase 5: the main path — serve through RealPlane
# --------------------------------------------------------------------- #
def phase_serve(torch, name: str):
    from repro_torch.core.knapsack import PackratOptimizer
    from repro_torch.core.profiler import ProfileSpec, phase_profiles
    from repro_torch.launch.bench_serving import (REAL_DRAIN_FACTOR,
                                                  _cap_rate, run_lm_policy)
    from repro_torch.models.serve_lm import (PHASE_DECODE, PHASE_PREFILL,
                                             PHASES, LmEngine)
    from repro_torch.serving import RealPlane
    from repro_torch.serving.scenarios import ScenarioContext, get_scenario
    units, max_batch, decode_steps, seed = 4, 4, 8, 0
    cfg = _config(name).with_overrides(use_pallas_kernels=True)   # bf16
    t0 = time.perf_counter()
    engine = LmEngine(cfg, seed=seed, max_seq=1024, default_seq_bucket=512)
    engine_s = time.perf_counter() - t0
    factory = engine.factory()
    prof_plane = RealPlane(factory, units)
    profiles = phase_profiles(
        prof_plane, ProfileSpec(units, max_batch, thread_values=(1, 2, 4)),
        PHASES, warmup=1, iters=3)
    profile_cells = prof_plane.runner_report()
    prof_plane.close()
    # the drain (REAL_DRAIN_FACTOR of the trace) must outlast a prompt's
    # whole chain: a prefill and its decode steps, each waiting up to the
    # dispatcher's coalesce window of four step times
    step_s = max(profiles[p][(units, 1)] for p in PHASES)
    chain_s = (1 + decode_steps) * 5.0 * step_s
    duration = max(SERVE_SECONDS, 1.25 * chain_s / REAL_DRAIN_FACTOR)
    opt = PackratOptimizer(profiles[PHASE_PREFILL])
    ctx = ScenarioContext(threads=units, optimizer=opt, duration=duration,
                          seed=seed, max_total_batch=units * max_batch)
    arrivals = get_scenario("steady-poisson").build(ctx).arrivals(
        duration, seed=seed)
    serial = (profiles[PHASE_PREFILL][(units, 1)]
              + decode_steps * profiles[PHASE_DECODE][(units, 1)])
    arrivals, capped = _cap_rate(arrivals, duration,
                                 min(300.0, 0.5 / max(serial, 1e-9)))
    b0 = max_batch
    slo = {p: 4.0 * profiles[p][(units, b0)] for p in PHASES}
    rep = {"config": name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "units": units, "max_batch": max_batch,
           "decode_steps": decode_steps, "duration_s": duration,
           "offered_prompts": len(arrivals), "rate_capped": capped,
           "engine_build_s": engine_s,
           "kernel_build_s": engine.kernel_build_s,
           "measured_profile_ms": {
               p: {f"{t},{b}": lat * 1e3
                   for (t, b), lat in sorted(profiles[p].items())}
               for p in PHASES},
           "profile_cells_compile_ms": profile_cells["compile_ms"],
           "policies": {}}
    for policy in ("static", "packrat"):
        r = run_lm_policy(policy, arrivals, factory=factory,
                          profiles=profiles, units=units, duration=duration,
                          initial_batch=b0, max_batch=max_batch,
                          decode_steps=decode_steps, slo_by_phase=slo,
                          reconfigure_timeout=2.0, dispatch="continuous",
                          real_model=name)
        done = r["phases"]
        rep["policies"][policy] = {
            "completed_prompts": done[PHASE_PREFILL]["completed"],
            "completed_decode_steps": done[PHASE_DECODE]["completed"],
            "incomplete": r["incomplete"],
            "ttft_ms": {q: r["ttft_ms"][q] for q in ("p50", "p95")},
            "tpot_ms": {q: r["tpot_ms"][q] for q in ("p50", "p95")},
            "unit_split": r["unit_split"],
            "reconfigurations": {p: r["servers"][p]["reconfigurations"]
                                 for p in PHASES},
            "compile_ms": r["runner_cache"]["compile_ms"]}
        if (done[PHASE_PREFILL]["completed"] != len(arrivals)
                or done[PHASE_DECODE]["completed"]
                != len(arrivals) * decode_steps or r["incomplete"]):
            emit({"phase": "serve", **rep})
            raise AssertionError(f"{name}, {policy}: not every prompt "
                                 "completed")
    rep["seconds"] = time.perf_counter() - t0
    return rep


# --------------------------------------------------------------------- #
# phase 6: the micro models through the launcher's real path
# --------------------------------------------------------------------- #
def phase_micro(torch, name: str):
    from repro_torch.launch.bench_serving import (DISPATCHES, POLICIES,
                                                  policy_key,
                                                  run_real_scenario)
    from repro_torch.models import micro
    from repro_torch.serving.scenarios import get_scenario
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    # the card's step against the CPU plain step, same weights and inputs
    # (attn-tiny: at each rung's S, the outputs flattened end to end)
    b = max(MICRO_BATCHES)
    if name == "attn-tiny":
        cpu_in = [[torch.randn((b, seq, *ATTN_TINY_HD), generator=gen)
                   for _ in range(3)] for seq in ATTN_TINY_SEQS]
        want = torch.cat([micro.attn_step(*x).flatten() for x in cpu_in])
        card_in = [[t.to(dev) for t in x] for x in cpu_in]

        def card_step():
            return torch.cat([micro.attn_step(*x).flatten()
                              for x in card_in]).cpu()
    else:
        dim, depth = MICRO_MLP[name]
        params = micro.init_mlp_params(dim, depth, 0, "cpu")
        x = torch.randn((b, dim), generator=gen)
        want = micro.mlp_step(x, params)
        card_x = x.to(dev)
        card_params = [(w.to(dev), c.to(dev)) for w, c in params]

        def card_step():
            return micro.mlp_step(card_x, card_params).cpu()
    got = card_step()
    err, ok = _compare(torch, got, want, "float32")
    rep = {"model": name, "step_check": {
        "batch": b, "max_abs_err": err, "ok": ok,
        "tolerance": dict(zip(("atol", "rtol"), TOL["float32"]))}}
    if not ok:
        # what a failure needs to be told apart: the worst element, and
        # whether the same step on the same card tensors repeats it; for
        # the MLPs which side drifted (each against the step in fp64) and
        # the fp32 matmul settings in force
        i = int((got - want).abs().argmax())
        rep["step_check"]["worst"] = {
            "index": i, "card": float(got.flatten()[i]),
            "cpu": float(want.flatten()[i]),
            "again_max_abs_err": _compare(torch, card_step(), want,
                                          "float32")[0]}
        if name != "attn-tiny":
            exact = micro.mlp_step(x.double(), [(w.double(), c.double())
                                                for w, c in params])
            rep["step_check"]["vs_fp64"] = {
                "card": float((got.double() - exact).abs().max()),
                "cpu": float((want.double() - exact).abs().max())}
        rep["step_check"]["matmul"] = {
            "cuda_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision":
                torch.get_float32_matmul_precision()}
        emit({"phase": "micro", **rep})
        raise AssertionError(f"{name}: the card's step differs from the "
                             f"CPU's: {err}")

    # one step through the runner, traced: wall per step (the runner
    # waits for its stream), the host's time to enqueue the bare step,
    # device busy time, idle share and launches, at b = 1 and 256; for
    # attn-tiny at each fidelity rung (rung 0 under "trace", the shorter
    # rungs under "trace_rungs" by S)
    rungs = ATTN_TINY_SEQS if name == "attn-tiny" else (None,)
    make_runner = micro.make_fidelity_micro_runner(name, n_rungs=len(rungs)) \
        if name == "attn-tiny" else micro.make_micro_runner(name)
    steps = 50
    rep["trace"] = {}
    if name == "attn-tiny":
        rep["trace_rungs"] = {}
    for rung, seq in enumerate(rungs):
        out = rep["trace"] if rung == 0 else \
            rep["trace_rungs"].setdefault(f"S={seq}", {})
        for bt in MICRO_BATCHES:
            if name == "attn-tiny":
                xs = [torch.randn((bt, seq, *ATTN_TINY_HD),
                                  generator=gen).to(dev) for _ in range(3)]

                def step():
                    micro.attn_step(*xs)
                run = make_runner(MICRO_UNITS, bt, fidelity=rung)
            else:
                w_dev = [(w.to(dev), c.to(dev)) for w, c in params]
                x_dev = torch.ones((bt, MICRO_MLP[name][0]), device=dev)

                def step():
                    micro.mlp_step(x_dev, w_dev)
                run = make_runner(MICRO_UNITS, bt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            enqueue = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                run()
            wall = (time.perf_counter() - t0) * 1e3

            def runs():
                for _ in range(steps):
                    run()
            out[str(bt)] = _trace_report(_profile(torch, runs), wall,
                                         enqueue, steps)
            if out[str(bt)]["device_busy_ms_per_step"] <= 0:
                raise AssertionError(f"{name}: the trace saw no device time")
    del make_runner, run

    # the main path: the launcher's real micro scenario, both policies x
    # both dispatches, counts reset just before and read just after
    _reset_counts()
    t0 = time.perf_counter()
    sc = run_real_scenario(
        get_scenario("steady-poisson"), real_model=name, units=MICRO_UNITS,
        duration=MICRO_SECONDS, seed=0, initial_batch=8, max_batch=256,
        slo_factor=4.0, reconfigure_timeout=1.0, dispatches=DISPATCHES,
        rate_cap=300.0, device="cuda")
    counts, cpu_calls = _counts()
    rep["serve_s"] = time.perf_counter() - t0
    rep["launches_by_route"] = counts
    rep["cpu_calls"] = cpu_calls
    profile_ms = sc["measured_profile_ms"]
    rep.update({"offered": sc["offered"], "rate_capped": sc["rate_capped"],
                "duration_s": MICRO_SECONDS, "units": MICRO_UNITS,
                "max_batch": 256, "slo_deadline_ms": sc["slo_deadline_ms"],
                "measured_profile_ms": {
                    cell: profile_ms[cell] for cell in
                    ("1,1", "4,1", "1,16", "4,16", "1,256", "4,256")},
                "profile_cells": len(profile_ms), "policies": {}})
    failed = []
    for policy in POLICIES:
        for dispatch in DISPATCHES:
            key = policy_key(policy, dispatch)
            r = sc[key]
            rep["policies"][key] = {
                "completed": r["completed"], "incomplete": r["incomplete"],
                "latency_ms": {q: r["latency_ms"][q]
                               for q in ("p50", "p95", "p99")},
                "reconfigurations": r["reconfigurations"],
                "final_config": r["final_config"],
                "calibration_ratio": r["calibration"]["global_ratio"],
                "optimizer_refreshes":
                    r["calibration"]["optimizer_refreshes"]}
            if r["completed"] != sc["offered"] or r["incomplete"]:
                failed.append(key)
    if failed:
        emit({"phase": "micro", **rep})
        raise AssertionError(f"{name}: not every request completed under "
                             f"{failed}")
    _check_launches(name, counts, cpu_calls, MICRO_PATHS[name])
    return rep


# --------------------------------------------------------------------- #
# phase 7: the launcher's simulated plane runs here, deterministically
# --------------------------------------------------------------------- #
def phase_launcher():
    import contextlib
    import io
    from repro_torch.launch import bench_serving
    argv = ["--execution", "fast", "--scenario", "step-up",
            "--duration", "20"]
    reports = []
    t0 = time.perf_counter()
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if bench_serving.main(argv) != 0:
                raise AssertionError("launcher: bench_serving failed")
        reports.append(out.getvalue())
    if reports[0] != reports[1]:
        raise AssertionError("launcher: two runs gave different reports")
    sc = json.loads(reports[0])["scenarios"]["step-up"]
    return {"argv": argv, "identical": True, "bytes": len(reports[0]),
            "seconds": time.perf_counter() - t0, "offered": sc["offered"],
            "p95_ms": {k: sc[k]["latency_ms"]["p95"]
                       for k in sc["policies"]}}


# --------------------------------------------------------------------- #
# phase 7b: the launcher's LM serving mode, lm-tiny on the card
# --------------------------------------------------------------------- #
def phase_launcher_lm(torch):
    """``bench_serving.main`` with :data:`LM_LAUNCHER_ARGS`: every prompt
    and decode step completes under every policy, TTFT and TPOT p50/p95
    are reported, and the counts, reset just before and read just after,
    show lm-tiny's flash calls on the short route and its decode calls on
    the CUDA cores only, with no CPU-route call."""
    import contextlib
    import io
    from repro_torch.launch import bench_serving
    out = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench_serving.main(LM_LAUNCHER_ARGS)
    seconds = time.perf_counter() - t0
    counts, cpu_calls = _counts()
    rep = {"argv": LM_LAUNCHER_ARGS, "seconds": seconds,
           "launches_by_route": counts, "cpu_calls": cpu_calls}
    if rc != 0:
        emit({"phase": "launcher_lm", **rep})
        raise AssertionError(f"launcher_lm: bench_serving exited {rc}")
    report = json.loads(out.getvalue())
    sc = report["scenarios"]["steady-poisson"]
    prompts, steps = sc["offered_prompts"], sc["decode_steps"]
    rep.update({"offered_prompts": prompts, "decode_steps": steps,
                "offered_rate_rps": sc["offered_rate_rps"],
                "rate_capped": sc["rate_capped"],
                "slo_deadline_ms": sc["slo_deadline_ms"],
                "measured_profile_ms": sc["measured_profile_ms"],
                "policies": {}})
    failed = []
    for key in sc["policies"]:
        r = sc[key]
        phases = r["phases"]
        entry = {
            "prompts_completed": phases["prefill"]["completed"],
            "decode_steps_completed": phases["decode"]["completed"],
            "incomplete": r["incomplete"],
            "ttft_ms": {q: r["ttft_ms"].get(q) for q in ("p50", "p95", "p99")},
            "tpot_ms": {q: r["tpot_ms"].get(q) for q in ("p50", "p95", "p99")},
            "unit_split": r["unit_split"]}
        rep["policies"][key] = entry
        if (entry["prompts_completed"] != prompts
                or entry["decode_steps_completed"] != prompts * steps
                or entry["incomplete"]
                or any(entry[m][q] is None for m in ("ttft_ms", "tpot_ms")
                       for q in ("p50", "p95"))):
            failed.append(key)
    if failed or prompts <= 0 or not all(
            any(k.split("+")[0] == p for k in sc["policies"])
            for p in ("static", "packrat")):
        emit({"phase": "launcher_lm", **rep})
        raise AssertionError("launcher_lm: not every prompt and decode step "
                             f"completed with TTFT and TPOT under {failed}")
    _check_launches("lm-tiny", counts, cpu_calls, LM_LAUNCHER_PATHS["lm-tiny"])
    return rep


# --------------------------------------------------------------------- #
# phase 8: the serving launcher (examples/serve_online.py) on the card
# --------------------------------------------------------------------- #
def phase_serve_online(torch):
    import contextlib
    import io
    import re
    from repro_torch.launch import serve
    out = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve.main(SERVE_ONLINE_ARGS)
    seconds = time.perf_counter() - t0
    counts, cpu_calls = _counts()
    lines = out.getvalue().strip().splitlines()
    for ln in lines:
        print(ln, flush=True)
    m = re.match(r"\[serve\] arch=\S+ requests=(\d+) completed=(\d+)",
                 lines[0] if lines else "")
    rep = {"argv": SERVE_ONLINE_ARGS, "seconds": seconds,
           "requests": int(m.group(1)) if m else None,
           "completed": int(m.group(2)) if m else None,
           "latency": next((ln for ln in lines if "latency" in ln), None),
           "reconfigurations": sum("reconfig" in ln for ln in lines) - 1,
           "launches_by_route": counts, "cpu_calls": cpu_calls}
    if rc != 0 or m is None or rep["requests"] != rep["completed"]:
        emit({"phase": "serve_online", **rep})
        raise AssertionError("serve_online: not every request completed")
    # reduced configs keep use_pallas_kernels off, as in the reference
    _check_launches("serve_online", counts, cpu_calls, {})
    return rep


# --------------------------------------------------------------------- #
# phase 9: training — gemma3-1b at full width through the launcher
# --------------------------------------------------------------------- #
def _bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bits (bf16 and fp32 compared as integers)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(view), b.view(view)
    return bool(torch.equal(a, b))


def _leaf_errors(torch, got, want):
    """Leaf name -> max |got - want| over max |want|, for two trees of
    one structure (compared on ``got``'s device)."""
    from repro_torch.training.tree import leaves_with_path
    out = {}
    for (name, g), (_, w) in zip(leaves_with_path(got),
                                 leaves_with_path(want)):
        w = w.to(g.device).float()
        out[name] = float((g.float() - w).abs().max()
                          / w.abs().max().clamp_min(1e-30))
    return out


def _train_card_vs_cpu(torch):
    """Reduced gemma3-1b in fp32, the same weights and batch on the card
    and the CPU, two steps: each step's loss (1e-5 relative) and gradient
    leaves (1e-4 of each leaf's largest |g|) against the CPU's at the same
    point; the card's ``make_train_step`` against its own
    ``value_and_grad`` (the same loss, bit for bit); and the parameters
    and moments after the two steps against the CPU's AdamW fed the
    card's gradients (1e-6 of each leaf's largest value: rounding only,
    since AdamW turns a gradient within rounding of 0 into a step of
    either sign, the two sides' own gradients are not fed to it)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import batches_for_model
    from repro_torch.models.lm import init_params, param_count
    from repro_torch.training import (AdamWConfig, TrainConfig, adamw_update,
                                      init_adamw, make_train_step)
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.training.tree import tree_map
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH).reduced(dtype="float32", **TRAIN_REDUCED)
    shape = ShapeConfig("t", seq_len=128, global_batch=2, kind="train")
    tcfg = TrainConfig(adamw=AdamWConfig(learning_rate=1e-3, warmup_steps=1))
    batch_h = next(batches_for_model(cfg, shape, seed=5))
    batch_c = {k: v.to(dev) for k, v in batch_h.items()}
    ph = init_params(cfg, 0, device="cpu")
    pc = tree_map(lambda t: t.to(dev), ph)
    sh, sc = init_adamw(tcfg.adamw, ph), init_adamw(tcfg.adamw, pc)
    step = make_train_step(cfg, tcfg)
    rep = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": param_count(ph),
           "batch": [2, 128], "steps": []}
    ok = True
    for _ in range(2):
        lc, gc = value_and_grad(pc, batch_c, cfg)
        lh, gh = value_and_grad(ph, batch_h, cfg)
        loss_err = abs(float(lc) - float(lh)) / abs(float(lh))
        grad_errs = _leaf_errors(torch, gc, gh)
        worst = max(grad_errs, key=grad_errs.get)
        pc, sc, mc = step(pc, sc, batch_c)
        ph, sh, _ = adamw_update(tcfg.adamw, tree_map(lambda t: t.cpu(), gc),
                                 sh, ph)
        same = float(mc["loss"]) == float(lc)
        rep["steps"].append({"loss_card": float(lc), "loss_cpu": float(lh),
                             "loss_rel_err": loss_err,
                             "grad_worst": [worst, grad_errs[worst]],
                             "step_loss_equals_value_and_grad": same})
        ok &= loss_err <= 1e-5 and grad_errs[worst] <= 1e-4 and same
    errs = {**_leaf_errors(torch, pc, ph),
            **{"mu" + k: v for k, v in _leaf_errors(torch, sc.mu,
                                                     sh.mu).items()},
            **{"nu" + k: v for k, v in _leaf_errors(torch, sc.nu,
                                                     sh.nu).items()}}
    worst = max(errs, key=errs.get)
    rep["after_two_steps_worst"] = [worst, errs[worst]]
    rep["tolerance"] = {"loss": 1e-5, "grad": 1e-4, "params": 1e-6}
    rep["ok"] = bool(ok and errs[worst] <= 1e-6)
    return rep


def phase_train(torch):
    """gemma3-1b at full width (26 layers, vocab 262,144, bf16) trained by
    the launcher's settings; see the module docstring, phase 9."""
    import contextlib
    import dataclasses
    import io
    import shutil
    from repro_torch.data import DataConfig, batches_for_model, token_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.models.common import cross_entropy_loss
    from repro_torch.models.lm import (apply_head, forward, head_weights,
                                       param_count)
    from repro_torch.training import (Checkpointer, init_adamw,
                                      make_train_step, train)
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_loop import loss_fn, value_and_grad
    from repro_torch.training.tree import leaves_with_path, tree_map
    dev = torch.device("cuda")
    failures = []
    rep = {"config": TRAIN_ARCH,
           "argv": TRAIN_ARGV + ["--steps", str(TRAIN_STEPS)]}

    # 1. card against CPU, reduced, fp32
    t0 = time.perf_counter()
    rep["card_vs_cpu"] = _train_card_vs_cpu(torch)
    rep["card_vs_cpu"]["seconds"] = time.perf_counter() - t0
    if not rep["card_vs_cpu"]["ok"]:
        failures.append("the card's reduced fp32 steps differ from the CPU's")

    # 2. the launcher, as a user runs it, for the first steps of the
    # schedule (decay_steps is max(steps, 100): the same schedule)
    argv = TRAIN_ARGV + ["--steps", str(TRAIN_LAUNCHER_STEPS)]
    args = launch_train.parse_args(rep["argv"])
    cfg, shape, tcfg = launch_train.configure(args)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(argv + ["--log-every", "1"])
    rep["launcher_seconds"] = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    for ln in lines:
        print(ln, flush=True)
    launcher_losses = [ln.split("loss=")[1].split()[0] for ln in lines
                       if "step=" in ln]
    if rc != 0 or len(launcher_losses) != TRAIN_LAUNCHER_STEPS:
        failures.append(f"the launcher ran {len(launcher_losses)} steps")
    if launch_train.configure(launch_train.parse_args(argv))[2] != tcfg:
        failures.append("the launcher's short run has another schedule")
    _free(torch)

    # 3. the whole schedule through train(), a held-out loss every
    # TRAIN_EVAL_EVERY steps, an async checkpoint at TRAIN_SAVE_AT written
    # while the steps after it run
    model = build_model(cfg)
    tokens = shape.global_batch * shape.seq_len
    log = []
    clock = [0.0]

    def on_step(step, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        row = {"step": step + 1, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
               "wall_ms": (now - clock[0]) * 1e3}
        row["tokens_per_s"] = tokens / (row["wall_ms"] / 1e3)
        log.append(row)
        print(f"chip_smoke: train step={row['step']} loss={row['loss']:.6f}"
              f" grad_norm={row['grad_norm']:.4f} lr={row['lr']:.3e} "
              f"wall_ms={row['wall_ms']:.2f} "
              f"tok/s={row['tokens_per_s']:.0f}", flush=True)
        clock[0] = time.perf_counter()

    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = Checkpointer(str(ckdir), async_save=True, keep=1)
    data = batches_for_model(cfg, shape, seed=args.seed)
    # held out: the same corpus (its seed), the stream of a second host
    held = {k: v.to(dev) for k, v in next(token_batches(DataConfig(
        cfg.vocab_size, shape.seq_len, shape.global_batch, args.seed,
        host_id=1, host_count=2))).items()}
    p_end = model.init(args.seed, device=dev)     # what train() makes
    o_end = None
    held_losses = []

    def held_out(step):
        with torch.no_grad():
            held_losses.append({"step": step,
                                "loss": float(loss_fn(p_end, held, cfg))})
        print(f"chip_smoke: train held-out step={step} "
              f"loss={held_losses[-1]['loss']:.6f}", flush=True)

    held_out(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    assert TRAIN_SAVE_AT % TRAIN_EVAL_EVERY == 0
    for stop in range(TRAIN_EVAL_EVERY, TRAIN_STEPS + 1, TRAIN_EVAL_EVERY):
        clock[0] = time.perf_counter()
        p_end, o_end, _ = train(model, tcfg, data, steps=stop, device=dev,
                                params=p_end, opt_state=o_end,
                                on_step=on_step)
        if stop == TRAIN_SAVE_AT:
            p_save, o_save = p_end, o_end
            t0 = time.perf_counter()
            ck.save(stop, p_save, o_save)
            rep["checkpoint_save_call_ms"] = (time.perf_counter() - t0) * 1e3
        held_out(stop)
    t0 = time.perf_counter()
    ck.wait()
    rep["checkpoint_wait_after_ms"] = (time.perf_counter() - t0) * 1e3
    rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rep["params"] = param_count(p_end)
    rep["layers"] = cfg.n_layers
    rep["steps"] = log
    rep["checkpoint_gib"] = sum(f.stat().st_size for f in ckdir.rglob("*")
                                if f.is_file()) / 2**30
    losses = [r["loss"] for r in log]
    finite = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                 for r in log)
    rep["loss_drop"] = losses[0] - losses[-1]
    rep["loss_margin"] = TRAIN_MARGIN
    if not (finite and len(losses) == TRAIN_STEPS
            and rep["loss_drop"] >= TRAIN_MARGIN):
        failures.append(f"losses {losses[0]} -> {losses[-1]}: not finite "
                        f"or fell by less than {TRAIN_MARGIN}")
    rep["launcher_matches_train"] = launcher_losses == [
        f"{x:.4f}" for x in losses[:TRAIN_LAUNCHER_STEPS]]
    if not rep["launcher_matches_train"]:
        failures.append("the launcher's losses are not train()'s")

    rep["held_out_loss"] = held_losses
    held_drop = held_losses[0]["loss"] - held_losses[-1]["loss"]
    if not held_drop >= TRAIN_MARGIN:
        failures.append(f"the held-out loss went {held_losses[0]['loss']} "
                        f"-> {held_losses[-1]['loss']}: it fell by less "
                        f"than {TRAIN_MARGIN}")

    # 4. the held-out batch: remat and grad_accum=2 steps beside the
    # plain step, from the trained state
    variants = {"plain": (cfg, tcfg),
                "remat": (cfg.with_overrides(remat=True), tcfg),
                "grad_accum=2": (cfg, dataclasses.replace(tcfg,
                                                          grad_accum=2))}
    rep["variants"] = {}
    base = None
    for label, (vcfg, vtcfg) in variants.items():
        step_fn = make_train_step(vcfg, vtcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p1, _, m = step_fn(p_end, o_end, held)
        torch.cuda.synchronize()
        row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "wall_ms": (time.perf_counter() - t0) * 1e3,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if base is None:
            base = (row, p1)
        else:
            row["loss_rel_err"] = abs(row["loss"] - base[0]["loss"]) / abs(
                base[0]["loss"])
            row["grad_norm_rel_err"] = abs(
                row["grad_norm"] - base[0]["grad_norm"]) / base[0][
                    "grad_norm"]
            row["params_bit_identical"] = all(
                _bits_equal(torch, a, b) for (_, a), (_, b) in zip(
                    leaves_with_path(p1), leaves_with_path(base[1])))
            if not (row["loss_rel_err"] <= TOL["bfloat16"][0]
                    and row["grad_norm_rel_err"] <= TOL["bfloat16"][0]):
                failures.append(f"the {label} step differs from the plain "
                                f"step: {row}")
        rep["variants"][label] = row
        del p1
    base = None
    _free(torch)

    # 5. the trained weights evaluated through the flash kernel, under
    # no_grad, against the plain path; and a step through it raises
    kcfg = cfg.with_overrides(use_pallas_kernels=True)
    labels = held["labels"]

    def evaluate(c, params):
        hidden = forward(params, held, c)
        logits = apply_head(params, hidden, c)
        loss = cross_entropy_loss(hidden, head_weights(params, c), labels,
                                  softcap=c.logit_softcap)
        return logits, float(loss)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    with torch.no_grad():
        _reset_counts()
        k16, loss_k = evaluate(kcfg, p_end)
        torch.cuda.synchronize()
        counts, cpu_calls = _counts()
        p16, loss_p = evaluate(cfg, p_end)
        f32, loss_f = evaluate(cfg.with_overrides(dtype="float32"),
                               tree_map(lambda t: t.float(), p_end))
        err_k, err_p, err_kp = rel(k16, f32), rel(p16, f32), rel(k16, p16)
        del k16, p16, f32
    _free(torch)
    tol16 = max(2.0 * err_p, TOL["bfloat16"][0])
    rep["eval"] = {"batch": [shape.global_batch, shape.seq_len],
                   "loss": {"kernels": loss_k, "plain": loss_p,
                            "fp32": loss_f},
                   "rel_err_kernels_vs_fp32": err_k,
                   "rel_err_plain_vs_fp32": err_p,
                   "rel_err_kernels_vs_plain": err_kp, "tolerance": tol16,
                   "launches_by_route": counts, "cpu_calls": cpu_calls}
    if not err_k <= tol16:
        failures.append(f"train-eval logits through the kernel differ: "
                        f"{err_k} > {tol16}")
    _check_launches("train-eval", counts, cpu_calls,
                    {"flash_attention": "tensor_core"})
    _reset_counts()
    try:
        make_train_step(kcfg, tcfg)(p_end, o_end, held)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    launched = sum(n for by_route in _counts()[0].values()
                   for n in by_route.values())
    rep["kernel_step_raises"] = raised
    if raised is None or "no backward" not in raised or launched:
        failures.append("a train step through the kernels did not raise "
                        f"before launching ({raised!r}, {launched})")
    _free(torch)

    # 6. one full-width step traced: forward + backward, the AdamW
    # update, the whole step
    grads = value_and_grad(p_end, held, cfg)[1]
    step_fn = make_train_step(cfg, tcfg)
    rep["trace"] = {
        "forward_backward": _traced(
            torch, lambda: value_and_grad(p_end, held, cfg), 1),
        "adamw_update": _traced(
            torch, lambda: adamw_update(tcfg.adamw, grads, o_end, p_end), 1),
        "step": _traced(torch, lambda: step_fn(p_end, o_end, held), 1)}
    del grads, p_end, o_end
    _free(torch)

    # 7. restore step TRAIN_SAVE_AT into a fresh tree, bit for bit, and
    # resume to TRAIN_STEPS
    fresh = model.init(1, device=dev)
    t0 = time.perf_counter()
    restored = ck.restore(like={"params": fresh,
                                "opt_state": init_adamw(tcfg.adamw, fresh)})
    rep["restore_ms"] = (time.perf_counter() - t0) * 1e3
    del fresh
    want = leaves_with_path({"params": p_save, "opt_state": o_save})
    got = leaves_with_path(restored["tree"])
    rep["restore_bit_exact"] = restored["step"] == TRAIN_SAVE_AT and [
        n for n, _ in got] == [n for n, _ in want] and all(
        _bits_equal(torch, a, b) for (_, a), (_, b) in zip(got, want))
    del p_save, o_save, want, got
    _free(torch)
    if not rep["restore_bit_exact"]:
        failures.append("the restored checkpoint differs from step "
                        f"{TRAIN_SAVE_AT}")
    data = batches_for_model(cfg, shape, seed=args.seed)
    for _ in range(TRAIN_SAVE_AT):
        next(data)                  # the batches the steps before it took
    resumed = []
    train(model, tcfg, data, steps=TRAIN_STEPS, device=dev,
          params=restored["tree"]["params"],
          opt_state=restored["tree"]["opt_state"],
          on_step=lambda s, m: resumed.append(float(m["loss"])))
    del restored
    shutil.rmtree(ckdir, ignore_errors=True)
    _free(torch)
    rep["resume_losses"] = resumed
    rep["resume_repeats_steps"] = resumed == losses[TRAIN_SAVE_AT:]
    if not rep["resume_repeats_steps"]:
        failures.append(f"the resumed steps {TRAIN_SAVE_AT + 1}-"
                        f"{TRAIN_STEPS} differ from the uninterrupted run's")
    if failures:
        emit({"phase": "train", **rep})
        raise AssertionError("train: " + "; ".join(failures))
    return rep


if __name__ == "__main__":
    sys.exit(main())

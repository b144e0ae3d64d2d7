#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as a JSON line; any failure raises and exits non-zero:

1. device   — the card's name; then the raw ``nvidia-smi`` name and power
              limit line.
2. build    — ``nvcc`` builds every kernel of ``src/repro_torch/kernels/csrc``
              into ``build/repro_torch_kernels/`` (one process per source);
              then one ``ptxas`` line per compiled kernel (registers, shared
              memory, spills).
3. kernels  — each hand-written kernel against its plain PyTorch version on
              the card: at the main path's shapes (float64), at ragged
              shapes (h = 1000 and odd h = 999) and in float32, with times of
              the kernel, the plain version and one library call (CUDA
              events); the Cholesky's time split by its three kernels from
              one profiled call, with the diagonal step per tile column;
              the three cluster solves (the dense trsm, ``interp_solve``
              and the packed trsm, ``csrc/tri_solve.cuh``) split by one
              profiled call into their kernel's device time and the time
              outside it, with their launch plan (cluster size,
              ``cudaOccupancyMaxActiveClusters``, rows per block, where the
              diagonal inverses live) and their ``ptxas`` lines at B = 128.
4. main     — ``cv_picholesky`` and ``cv_exact_cholesky`` at the repo's
              configuration (h=1024, n=4096, k=5, q=31 over [1e-3, 1], g=4,
              r=2, block=128, float64) on the ``cuda`` backend, held against
              the ``reference`` backend on the card.  The launch counts are
              set to 0 just before each sweep and read just after it: each
              kernel of that sweep must have launched, and no other; wall
              times of both (in turns, repeated).
5. trace    — one profiled run of each sweep, each host driver and each
              factor route of phase 7: device busy time, its share of the
              wall time, the kernels that take the most time, the
              Cholesky's three kernels, the cluster solves' device time,
              the library (cuBLAS) trsm kernels that ran and the PyTorch
              triangular-solve calls (none may run on the two sweeps of the
              main path or on the factor routes: the kernels invert their
              diagonal tiles themselves).
6. host     — the host-loop drivers (``host_cv_picholesky``,
              ``host_cv_exact_cholesky``, ``host_cv_pinrmse``: folds one at
              a time, dense interpolated factors) at the main configuration
              on ``cuda``, against ``reference`` and against the engine;
              launch counts as predicted from the loop structure; wall
              medians of host vs engine.
7. packed   — the factor routes.  Float64: the packed anchors unpacked
              (== the dense anchors exactly), and per fold the interpolated
              factors kept packed and solved by the packed trsm (one launch
              a fold), against the fused ``interp_solve`` and ``reference``
              (1e-10).  Under ``bf16_store``: ``picholesky.fit`` then the
              packed route of its bf16 factors (the mixed packed trsm), and
              ``eval_factor`` of every fold at the whole grid (bf16 dense
              factors, 325 MB) then ``solve_from_factor`` (the mixed dense
              trsm), each counted and held against ``reference`` under the
              same policy on the same Θ (5e-2 of the norm, the JAX
              package's bound for a bf16 solve); wall times.
8. gauss_newton — the damped Gauss–Newton head on the full Hessian: steps
              inside the fitted damping range and one outside it (clipped),
              against ``reference`` and a dense solve.
9. table4   — the λ* indices on ``tests/data/torch_table4.npz`` (made by the
              JAX package) must be reproduced on the ``cuda`` backend, and
              its curves within 1e-9 relative.
10. precision — the bf16 policies on the main path at full width:
              ``cv_picholesky`` under ``fp32``, ``bf16_store`` and
              ``bf16_refined`` and ``cv_exact_cholesky`` under
              ``bf16_store`` on the ``cuda`` backend, launches counted
              (the mixed-precision variants of the Cholesky, the dense trsm
              and ``interp_solve``, and no other); ``bf16_refined`` must
              select fp32's λ* with its curve within rtol 2e-2, atol 2e-3
              of fp32's and closer to it than ``bf16_store``'s; wall
              medians of 5 in turns; one profiled run of each bf16 sweep
              (no library trsm or Cholesky may run); the Table-4 fixture
              under ``bf16_refined`` against ``fp32`` (printed, not held).
11. baselines — the paper's other CV algorithms at the main configuration
              (Table 3 and §7), each counted (the kernels of its path and
              no other, as many launches as predicted):
              ``cv_picholesky_warmstart`` (g_first 4, g_rest 2) and
              ``cv_pinrmse`` on ``cuda`` against ``reference`` (1e-9 and
              1e-8, the same λ*); MChol (c −1.5, s 1.5, s0 0.0025) visiting
              the same λs as ``reference`` (the first divergence printed);
              ``cv_svd`` full within 1e-8 of the exact engine, truncated
              and randomized (rank h/4, a seeded test matrix) printed; low
              rank on ``make_low_rank_dataset(512, 1024, 64)``, rank None
              within 1e-8 of exact on the same folds, rank 64 printed;
              ``select_interpolant`` on the card's packed anchors
              (k, g, P), the same choice as ``reference``; ``RidgeCV``
              (``fit`` λ* = ``cv_picholesky``'s, ``fit_theta`` θ within
              1e-8 of ``reference``); ``CountingBackend`` stage counts; one
              profiled run each of warm-start, PINRMSE, MChol and
              ``fit_theta`` (no library Cholesky or triangular solve may
              run); wall medians of 3 in turns of every algorithm.
12. mamba_fixture — the reduced Falcon-Mamba model (weights, tokens and
              answers of ``tests/data/torch_mamba.npz``, made by the JAX
              package) on the kernel: forward, prefill and two decode steps
              within 1e-4 relative.
13. mamba   — Falcon-Mamba-7B at its published widths in float32, 4 layers,
              seeded weights: forward, prefill (logits and cache) and 8
              decode steps with the mixer's two kernels (the causal
              convolution and the fused scan) against their plain versions
              (``scan="reference"``), and decode-after-prefill against
              forward, all within 1e-4 relative; each kernel launched once
              a layer and step.
14. serve   — Falcon-Mamba-7B as published (bf16, 64 layers): prefill of 4
              prompts of 2048 tokens, 32 greedy decode steps, and a forward
              over the extended sequences; finite logits, decode consistent
              with forward; prefill and decode walls (median of 3 after a
              warm run), peak memory, launch counts per path (``ssm_scan``
              and ``causal_conv1d`` once a layer and step); then one
              profiled prefill and one profiled decode step (a second
              ``trace`` line: device time of the convolution, the scan, the
              GEMMs and the rest; no library convolution may run).

15. cache   — the warm-replay factor cache at the main configuration: a
              cold run with ``cache_anchors``, an exact hit, a covering hit
              on a sub-grid, a refit at degree 3 from the cached anchors,
              save → load → replay; ``CountingBackend`` factorizations per
              route (0 on every warm one), hit against cold and loaded
              against in memory bit for bit; times of the fingerprint
              (device → host copy and sha256), the cold sweep with and
              without a cache, the hit, the refit, save and load.
16. staged  — ``sweep_async`` pipelined against serial, cold and warm, bit
              for bit; ``run_async`` against ``run``; early stopping;
              the exact strategy staged and searched; ``search`` at the
              default wave and at wave 8 (λ* against the dense argmin's
              bracket); ``select_interpolant``; ``advise_anchor``; wall
              medians and the device's idle share of the pipelined and
              the serial sweep.
17. cv_serve — the CV sweep server on ``make_traffic`` at the main
              configuration (8 problems, 48 requests, 6 tenants, Zipf 1.2)
              with ``ServerConfig`` defaults: p50/p99 latency, throughput,
              hit rate, tenants sharing, the fingerprint's share; every
              response against a solo cold run bit for bit; a second pass
              with room for three cache entries (no stale entry served).
18. sketch  — sketched anchors at a tall configuration (n = 131,072):
              SRHT and Gaussian at m = 8192, count sketch at the smallest
              m in 16,384 / 32,768 / 65,536 whose IHS contracts; each
              method's contraction factor, its curve on ``cuda`` against
              ``reference`` (1e-8, the same λ*), the count sketch twice bit
              for bit, the curves against the dense sweep and the regret of
              each pick on it, and the sketched anchor build against the
              dense Hessian formation.

19. tune    — ``tune='auto'`` at the main configuration, uncut: the
              chosen ``TunedConfig``, the lattice (blocks 32/64/128 × the
              chunk ladder) with every candidate's priced step, measured
              wall (median of 3 in turns after a warm run), launches
              against the plan's, and curve against ``reference`` (1e-8,
              the same λ*; at block 128 every chunk bit for bit the untuned
              run); the predicted against the measured rank (Spearman), the
              choice no slower than the untuned default and its distance
              from the measured best (reported); the exact strategy
              pinned at blocks 32, 64 and 128 through ``tune=`` (the
              dense trsm and the Cholesky at the tuner's blocks: curve
              against ``reference``, launches against the plan, the
              ``'auto'`` choice bit for bit its pinned run); 0
              factorizations and 0 launches while tuning, a cache hit on
              the second tune, save → load of the tuning cache;
              ``launch_s`` (a dependent chain of the Cholesky's launches)
              beside the card's ``nvidia-smi`` line; ``mesh='auto'`` and
              ``donate`` bit for bit; ``sweep_temp_bytes`` with and without
              ``donate``, the reference's memory contract at its test's
              shape (≤ 64 B per extra λ from q 64 to 1024 at chunk 16,
              held; unchunked over chunked, reported) and the main
              configuration at q 64 and 256;
              ``ServerConfig(tune='auto')`` over the cv_serve traffic (one
              tuning per geometry, every response the same bits as its
              solo run under the same config); ``RidgeCV(cv_mesh='auto')``
              against ``RidgeCV()``.  Its paths join ``launches_by_path``
              as ``tune_*``.  When the tuner picks another block than the
              main configuration's, the ``kernels`` phase also times rows
              1, 3, 6 and 8 at that block (``tuned_block``).

20. train  — training the Mamba family, after ``serve`` (its model freed):
              the reduced model of ``tests/data/torch_mamba_train.npz`` on
              the kernels (loss and every gradient within 1e-4 of JAX's,
              one AdamW update on JAX's gradients within 1e-6 of JAX's
              parameters); Falcon-Mamba-7B as published (64 layers, bf16,
              remat) with Adafactor, 5 steps of 4 × 2048 tokens of
              ``token_stream`` through ``TrainLoop`` (step ms as the median
              of the last 4, tokens/s, peak memory, losses and gradient
              norms finite, launches: each of the four mixer kernels
              2 × 64 a step, kernel A on the segment states the remat
              recompute's forward kept, ``mamba_scan_bwd_ckpt``), 3
              steps on one repeated batch (its loss must
              fall) and one profiled step (device time of the GEMMs, the
              forward scan, kernel A, the forward convolution, kernel B
              and the rest; the idle share; no library convolution);
              AdamW at 32 of the 64 layers (its float32 moments do not fit
              one card at 64), 3 steps; one full-width float32 layer at
              batch 1 × 2048 on the kernels against their plain versions
              (loss and every gradient within 1e-4); the reduced model
              resumed from a checkpoint after 6 steps, its parameters and
              AdamW state bit for bit.  One ``train`` line per part.

21. dense_fixture — the reduced Qwen2 and H2O-Danube3 models of
              ``tests/data/torch_dense.npz`` (JAX's weights, inputs and
              logits) on the card in float32: forward, prefill and decode
              within 1e-4 relative, H2O-Danube3 also past its window (a
              48-token prompt, its ring buffer wrapping).
22. dense_serve — each dense configuration (SmolLM-360M, Qwen2-1.5B,
              MiniCPM-2B, H2O-Danube3-4B) as published (bf16, seeded
              weights) served as ``serve`` serves Falcon-Mamba-7B: 4
              prompts of 2048 tokens, 32 greedy decodes, a forward over
              the extended sequences, decode against forward at the last
              position within ``SERVE_TOL``; walls (median of 3), tokens/s,
              peak memory, weight and cache bytes (each decode step copies
              the cache); one profiled prefill (device time of the port's
              attention, its float32 chunk products and the rest of it,
              the other GEMMs and the rest), one profiled decode step
              (busy time, idle share) and one layer's attention
              against ``scaled_dot_product_attention`` at the same shapes
              (a yardstick only: the path runs the port's
              ``flash_attention``).  Then H2O-Danube3 with one prompt of
              6144 tokens, beyond its window of 4096.
23. dense_train — Qwen2-1.5B as published (bf16, remat), AdamW (the
              launcher's rule), 5 steps of 4 × 2048 tokens through
              ``TrainLoop``: finite losses and gradient norms, the
              parameters moving, step ms, tokens/s, peak memory, one
              profiled step split as ``dense_serve``'s prefill.
Every dense path launches none of the port's kernels: each counter 0.

Last, the LM under a mesh (meshes of the one card repeated: what as many
cards would compute, computed on one): ``mesh_dryrun`` (the dry run of
every configuration × shape cell at both production meshes on the meta
device: status, the fullest device's argument bytes, whether they fit the
card), ``mesh_serve`` (Qwen2-1.5B and SmolLM-360M under (1, 16), their
query heads padded to 16: decode against forward; with the padded heads'
``wo`` rows zeroed, against the unsharded model on the real heads' weights
in bf16 and float32; walls and peak memory beside the unsharded model's),
``mesh_moe`` (Mixtral-8x7B at 2 layers under (1, 8), (2, 4) and (1, 16):
dropped choices per data shard, aux and logits against the unsharded model
at capacity 1.25, then drop-free in bf16 and float32), ``mesh_ssm``
(Falcon-Mamba-7B under (1, 16): its prefill the unsharded bits; the path
``mesh_ssm`` of ``launches_by_path``) and ``mesh_train`` (the launcher
``--mesh 1x1``, a second run resumed from its step-2 checkpoint through
``TrainLoop(shardings=)`` ending on its loss bit for bit;
``compressed_psum_tree`` against float64).

Phases 15–19 run after ``baselines`` and before ``mamba_fixture`` (19
before ``cv_serve``); each adds its paths to ``launches_by_path``, and
their failures are collected and raised after the ``kernels`` line.
Phases 21–23 run after ``train``; their failures too.

The ``kernels`` phase also holds the mixed-precision variants (bf16
products on the tensor cores, float32 sums and state, Θ and packed factors
read in bf16: the Cholesky, the dense trsm, ``interp_solve`` and the
packed trsm, the last also on float32 factors) and ``interp_factors`` on
a bf16 Θ (bit for bit) against their plain versions at the main path's
bf16 shapes and at h = 1000 and 999, with the variant's time beside its
bound, its plain version's, its one-dtype float32 kernel's and the float32
library call's.  The mixed Cholesky's row also gives the design that ran
(``variant``: ``wgmma`` at B = 64, 128, ``mma_sync`` at 16, 32, read from
the profiled kernels' names; the main shape must run ``wgmma``) and the
``by_kernel`` split of its three kernels, and the Cholesky is held at
every block at h = 1000, batch 1 and 20 (the same bits twice too).  The
three mixed cluster solves' rows give theirs (``design``:
``stored_bf16``, from the profiled kernels' names: the operands rounded
to bf16 once where they are stored, ``tri_solve_mixed_kernel``; any other
fails the row) with their plan and ``ptxas`` lines.
It also holds ``ssm_scan`` against its plain version at
the serve prefill's shape (B=4, S=2048, d_inner=8192, N=16) and at a ragged
one, its fused entry ``mamba_scan`` (softplus, scan and gate, bf16) at both
and at one decode step from a state (both dtypes), with its segment states
(``states=True``, the backward's checkpoints; timed with and without them
at the serve shape), and the fused causal
convolution with bias and silu bit for bit and the same bits twice
(serve shape, timed against ``F.conv1d``; ragged, decode, short and the
tile edges of ``CONV_EDGES`` from a state), with the variant that ran
(the main shapes must run ``staged``), bytes over time and registers.  And
the two
backward kernels of training against their plain backward passes: kernel
A (``mamba_scan_bwd``) at the training shape in bf16 (timed) and float32,
ragged (S 999, d_inner 8100) and small from a state, every gradient within
its stated tolerance, in both modes (on the forward's segment states, as
training runs it, timed as the row; on its own walk, ``walk_ms``), the
two modes the same bits; kernel B (``causal_conv1d_bwd``) with dx bit for
bit, timed against autograd of ``F.conv1d``, at the convolution's shapes
and tile edges too; both the same bits on two
calls; and ``ssm_scan``'s refusal of a gradient on the card.  Then one
``{"kernels": [...]}`` line (kernel A's row sums both modes' launches,
``launches_ckpt`` and ``launches_walk`` apart), and last the device line
``{"ok": true, "device": {...}}``.  Needs the repo checkout beside it and
one CUDA card; imports nothing of JAX.  The ``kernels`` line carries, for
the three cluster solves also ``kernel_ms`` (device time of the cluster
kernel per launch), ``outside_kernel_ms`` (wrapper time less the
kernel's), ``other_device_ms``, ``plan`` and ``ptxas``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.picholesky import CONFIG  # noqa: E402
from repro_torch.core.engine import LAM_CHUNK_BUDGET_BYTES  # noqa: E402
from repro_torch.distributed.roofline import peaks_for  # noqa: E402
from repro_torch.distributed.sharding import auto_lam_chunk  # noqa: E402

# the main configuration: the port's configs/picholesky.py
H, N_TRAIN, K_FOLDS = CONFIG.h, CONFIG.n_train, CONFIG.k_folds
N_LAMBDAS, G_SAMPLES, DEGREE = CONFIG.n_lambdas, CONFIG.g_samples, \
    CONFIG.degree
LAM_LO, LAM_HI, BLOCK = CONFIG.lam_lo, CONFIG.lam_hi, CONFIG.block
SEED = 0
# what lam_chunk='auto' gives at the main configuration (float64)
LAM_CHUNK = auto_lam_chunk(H, BLOCK, torch.float64, LAM_CHUNK_BUDGET_BYTES)

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}   # max |Δ| / max |plain|
MAIN_TOL = 1e-8            # curve of the cuda backend vs the reference one
TABLE4_TOL = 1e-9          # curve on the card vs the JAX fixture, as the
                           # CPU test tests/test_torch_table4.py holds it
WALL_REPEATS = 5           # timed sweeps per (strategy, backend)
HOST_REPEATS = 3           # timed runs per host driver / engine sweep
PACKED_TOL = 1e-10         # packed route vs fused interp_solve / reference
# the bf16_store factor routes vs the reference backend under the same
# policy on the same Θ, max over systems of ‖Δ‖ / ‖reference‖: the JAX
# package's bound for a bf16 solve against the float32 one
# (tests/test_precision.py:126-136; the reference backend solves the bf16
# factors at float32, the kernels round their products' operands to bf16)
BF16_ROUTE_TOL = 5e-2
GN_TOL = 1e-2              # Gauss–Newton step vs a dense solve, as
                           # tests/test_optim.py holds the reference

# the LM path: configs/falcon_mamba_7b.py (published widths)
MAMBA_ARCH = "falcon-mamba-7b"
SCAN_SHAPE = (4, 2048, 8192, 16)      # (B, S, d_inner, N) of a serve prefill
SCAN_RAGGED = (3, 999, 8100, 16)      # S % 16 ≠ 0, d_inner % 32 ≠ 0
SCAN_DECODE = (4, 1, 8192, 16)        # one decode step, from a state
DT_RANK = 256                         # falcon-mamba-7b's x_proj: r + 2N
# The fused scan (mamba_scan) in bf16 against its plain version, per
# element: |Δ| ≤ 2^-6·|plain| + MAMBA_TOL·max|plain|.  The two float32 y
# differ by up to MAMBA_TOL of max |y| (the float32 check; summation order
# and ex2.approx), which near y = 0 (cancellation between D·x and h·C) is
# no small share of |y| and can flip its sign: the absolute term.  Then y
# and silu(z) are each rounded to bf16, and either rounding can land on
# the other neighbouring value (one step, at most 2^-7 of the value); the
# two products are then up to 2^-7 of their value apart before their own
# rounding and up to one more step after it: 2^-6 of |plain|.  On the card
# the serve shape holds one element of 6.7e7 beyond 2^-7·|plain| + the
# absolute term (``y_worst`` reads it; PERF.md §6).  The share of
# elements over 2^-7·|plain| alone is printed beside it.  h_last and every
# float32 output: MAMBA_TOL.
MIXER_BF16_REL = 2.0 ** -6
MIXER_BF16_ONE_STEP = 2.0 ** -7
# MUFU operations the fused scan issues per (t, d) besides the N decays: an
# ex2 and a reciprocal for softplus, the same for silu
# (csrc/ssm_scan.cu softplus_fast, silu_fast)
MIXER_EXTRA_MUFU = 4
CONV_WIDTH = 4                        # falcon-mamba-7b's d_conv
MAMBA_TOL = 1e-4           # max |Δ| / max |ref|, float32: kernel vs plain
                           # scan, decode vs forward, card vs JAX fixture
MAMBA_DEPTH, MAMBA_BATCH, MAMBA_SEQ, MAMBA_DECODE = 4, 2, 250, 8
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 4, 2048, 32
# training (phase train): falcon-mamba-7b as published, Adafactor, batch
# TRAIN_BATCH × TRAIN_SEQ tokens of token_stream, TRAIN_STEPS through
# TrainLoop, then TRAIN_REPEAT steps on one batch (its loss must fall);
# AdamW (the launcher's rule for 7B) at ADAMW_DEPTH of the 64 layers, whose
# float32 moments would not fit one card at full depth; one full-width
# layer at batch 1 × TRAIN_SEQ, kernels against plain versions; the reduced
# model resumed from a checkpoint after RESUME_STEPS
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_REPEAT = 4, 2048, 5, 3
ADAMW_DEPTH, ADAMW_STEPS = 32, 3
RESUME_STEPS, RESUME_TOTAL = 6, 8
# the train fixture (tests/data/torch_mamba_train.npz): loss and gradients
# within MAMBA_TOL of JAX's (as tests/test_torch_train.py holds the CPU),
# one AdamW update on JAX's gradients within ADAMW_TOL of JAX's parameters
# (the same float32 operations, rounded alike but for a last bit)
ADAMW_TOL = 1e-6
# The backward kernels against their plain versions.  Kernel A forms
# exp(dt·A), softplus and silu with the MUFU approximations and sums over
# d_inner, batch and time in another order than the plain version: float32,
# each gradient within MAMBA_BWD_TOL of its max |plain|, the forward's
# tolerance (measured ≤ 1.5e-6 on the card).  In bf16 the gate's two
# roundings (y and silu(z) to bf16) can land on the other neighbouring
# value, as in the forward (MIXER_BF16_REL per element for dxc and dz); one
# such step of dy' moves a float32 gradient that carries it by 2^-8 of its
# term: MAMBA_BWD_BF16_TOL = 2^-8 of max |plain| for those (measured
# ≤ 2e-6).
MAMBA_BWD_TOL = 1e-4
MAMBA_BWD_BF16_TOL = 2.0 ** -8
# Kernel B: dx bit for bit; dw and db are float32 sums over (B, S) in
# another order than torch's sum.
CONV_BWD_TOL = 1e-5
# the convolution's tile edges (csrc/causal_conv1d.cu), each from a state,
# in both directions and dtypes: (case, (B, S, C), offset of every base in
# elements).  tile_edges: S not a multiple of a slot's rows, a segment
# boundary inside a batch row, C a multiple of 8 but not of a channel tile
# (staged); short: S < K-1 (staged); misaligned: a base off by one element
# (generic)
CONV_EDGES = (("tile_edges", (1, 300, 8200), 0), ("short", (2, 2, 8192), 0),
              ("misaligned", (2, 530, 520), 1))
SERVE_TOL = 5e-2           # bf16, 64 layers: decode vs forward logits at the
                           # last position, max |Δ| / max |forward|
SERVE_REPEATS = 3
# the dense family (phases dense_fixture, dense_serve, dense_train): the
# port's four dense configurations at their published widths, each served
# as phase serve serves Falcon-Mamba-7B (same batch, prompt, decode steps
# and SERVE_TOL), H2O-Danube3 also with one prompt beyond its window;
# Qwen2-1.5B trained as phase train trains Falcon-Mamba-7B
DENSE_ARCHS = ("smollm-360m", "qwen2-1.5b", "minicpm-2b", "h2o-danube-3-4b")
DENSE_FIXTURE = ROOT / "tests" / "data" / "torch_dense.npz"
DENSE_FIXTURE_ARCHS = ("qwen2-1.5b", "h2o-danube-3-4b")
DENSE_TOL = 1e-4           # max |Δ| / max |JAX|, float32: card vs fixture
WINDOWED_ARCH, LONG_PROMPT = "h2o-danube-3-4b", 6144   # window 4096
DENSE_TRAIN_ARCH, DENSE_TRAIN_STEPS = "qwen2-1.5b", 5
YARDSTICK_REPEATS = 5
# the port's attention in a profile: layers.flash_attention's range and
# its backward's autograd node
ATTENTION_RANGE, ATTENTION_BWD = "flash_attention", "_FlashCoreBackward"
# the MoE and hybrid families (phases moe_fixture, moe_serve,
# moe_consistency, moe_train, hybrid_fixture, hybrid_serve, hybrid_train):
# the fixtures' configurations (reduced, at these depths) and tolerance
MOE_FIXTURE = ROOT / "tests" / "data" / "torch_moe.npz"
MOE_FIXTURE_LAYERS = {"mixtral-8x7b": 1, "kimi-k2-1t-a32b": 1}
HYBRID_FIXTURE = ROOT / "tests" / "data" / "torch_hybrid.npz"
HYBRID_ARCH, HYBRID_FIXTURE_LAYERS = "recurrentgemma-2b", 5
FIXTURE_TOL = 1e-4         # max |Δ| / max |JAX|, float32: card vs fixture
# served at the published widths, bf16, cut in depth to fit one card (the
# weights: Mixtral 70.2 GB of 93.4, Kimi-K2 38.8 GB of 2.08 TB)
MOE_SERVE = (("mixtral-8x7b", 24), ("kimi-k2-1t-a32b", 1))
# decode against forward at drop-free capacity (capacity_factor = E): a
# prompt short enough that the (E, C, D) buffers fit beside the weights
MOE_CONSISTENCY_PROMPT = {"mixtral-8x7b": 512, "kimi-k2-1t-a32b": 64}
CONSISTENCY_DECODE = 8
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = "mixtral-8x7b", 2, 3
HYBRID_TRAIN_BATCH, HYBRID_TRAIN_STEPS = 2, 5
RGLRU_RANGE = "linear_recurrence"      # layers.chunked_linear_recurrence
# the audio and VLM families (phases audio_fixture, vlm_fixture,
# audio_serve, vlm_serve, audio_train, vlm_train)
CROSS_ARCHS = {"audio": "whisper-base", "vlm": "llama-3.2-vision-11b"}
CROSS_FIXTURES = {f: ROOT / "tests" / "data" / f"torch_{f}.npz"
                  for f in CROSS_ARCHS}
# Whisper's own window: 1500 encoder frames (30 s of audio) and a decoder
# context of 448, a prompt of 416 tokens and SERVE_DECODE decodes
WHISPER_WINDOW = (1500, 416)
# another source must move the prefill's logits by more than this share of
# their largest (max |Δ| / max |logits|)
CROSS_RESPONSE = 1e-3
# bf16 decode against forward at the last position, max |Δ| / max
# |forward|, held per family: Whisper-base to SERVE_TOL (7.5e-3 measured);
# Llama-3.2-Vision-11B's 40 layers of width 4096 amplify one-ulp
# differences of a decode step's products and attention past SERVE_TOL
# (scripts/probe_cross_consistency.py, PERF.md): 5.61e-2 at the last
# position and 7.54e-2 at the worst, 4.62e-2 with every gate closed, so
# its bound is 1e-1; the probe's faulty cross caches (another prompt's,
# or one rounded through float8) are what it must still catch.  Both
# families' weights are also served in float32 and held to F32_SERVE_TOL
# at every position
BF16_SERVE_TOL = {"audio": SERVE_TOL, "vlm": 1e-1}
F32_SERVE_TOL = 1e-3       # max |Δ| / max |forward|, float32 (the bound of
                           # tests/test_models.py:80 for decode vs forward)
# the VLM trains cut to 2 groups (two cross layers run their backward):
# AdamW's float32 moments of all 10.1 B parameters (81 GB) do not fit
VLM_TRAIN_GROUPS, CROSS_TRAIN_STEPS = 2, 4
CROSS_TRAIN_BATCH = {"audio": TRAIN_BATCH, "vlm": 2}
# the profile's split: the encoder, the cross-attention (with its norm),
# the self-attention, each kernel under the outermost range it runs in
CROSS_RANGES = {"encoder": "encoder", "cross": "cross_attention",
                "self_attention": ATTENTION_RANGE}
CROSS_TRAIN_RANGES = dict(CROSS_RANGES, attention_bwd=ATTENTION_BWD)
# the LM under a mesh (phases mesh_dryrun, mesh_serve, mesh_moe, mesh_ssm,
# mesh_train).  The port runs one card: a mesh over [cuda:0] * n computes
# what n cards would (padded heads, the MoE per shard), on one.
MESH_TP = 16                     # the production meshes' "model" axis
# 12 → 16 and 15 → 16 query heads under a "model" axis of 16
MESH_SERVE_ARCHS = ("qwen2-1.5b", "smollm-360m")
MESH_SERVE_DECODE, MESH_REPEATS = 8, 2
# Mixtral-8x7B cut to 2 layers (FSDP on, as above 2e9 parameters) under
# (1, 8): one expert a shard; (2, 4): EP with two data shards; (1, 16):
# 8 experts do not divide 16, so each shard takes a slice of every
# expert's width
MESH_MOE_ARCH, MESH_MOE_LAYERS = "mixtral-8x7b", 2
MESH_MOE_SHAPES = ((1, 8), (2, 4), (1, 16))
# the launcher on Qwen2-1.5B as published: a checkpoint (bf16 weights,
# float32 AdamW moments) is 17.8 GB, and the phase writes two
MESH_TRAIN_ARCH, MESH_TRAIN_STEPS, MESH_TRAIN_EVERY = "qwen2-1.5b", 4, 2
PSUM_TOL = 1e-6    # compressed_psum_tree against a float64 evaluation of
                   # the reference's formula on its codes: of max |g|

# The card's published peaks (bytes/s, FP64 on tensor cores, FP64 and
# FP32 outside them, bf16 on tensor cores, ``sfu`` exponentials/s) are
# ``repro_torch.distributed.roofline.PEAKS``, chosen by the card's name
# (``peaks_for``): one source for this script and the tuner's roofline.

REPLACES = {
    "pack_tril": "src/repro/kernels/tri_pack.py:73",
    "cholesky_blocked": "src/repro/kernels/chol_blocked.py:115",
    "solve_lower_blocked": "src/repro/kernels/trsm.py:102",
    "interp_solve": "src/repro/kernels/poly_interp.py:195",
    "unpack_tril": "src/repro/kernels/tri_pack.py:104",
    "interp_factors": "src/repro/kernels/poly_interp.py:97",
    "solve_lower_packed": "src/repro/kernels/packed_trsm.py:166",
    "ssm_scan": "src/repro/kernels/ssm_scan.py:83",
    # no Pallas kernel: XLA's convolution, + conv_b and silu
    # (src/repro/models/blocks.py:387-388), fused by the port
    "causal_conv1d": "src/repro/models/layers.py:300",
    # the backward kernels of training: no Pallas kernel; the reference's
    # custom_vjp of the recurrence (_clr_bwd) and XLA's autodiff of the conv
    "mamba_scan_bwd": "src/repro/models/layers.py:388",
    "causal_conv1d_bwd": "src/repro/models/layers.py:300",
    # the mixed-precision variants (bf16 products, float32 sums and state)
    "cholesky_blocked_bf16": "src/repro/kernels/chol_blocked.py:115",
    "solve_lower_blocked_bf16": "src/repro/kernels/trsm.py:102",
    "interp_solve_bf16": "src/repro/kernels/poly_interp.py:195",
    "interp_factors_bf16": "src/repro/kernels/poly_interp.py:97",
    "solve_lower_packed_bf16": "src/repro/kernels/packed_trsm.py:166",
}
# Mixed variant against its plain version in float32, max |Δ| / max |plain|.
# Their operands are rounded to bf16, and a value whose fp32 sum (or, for
# the in-kernel diagonal inverses, whose fp32 inversion) ends a few bits
# apart in another order rounds to the other neighbouring bf16 value
# (2^-8 relative) now and then.  So kernel and plain are two roundings of
# one bf16 algorithm, and they differ by about that algorithm's own error:
# MIXED_TOL sits above it.  What a missing or extra rounding would change
# is that error against the float64 result, so each variant's error
# (max |Δ| / max |float64|) must also lie within ERROR_RATIO of its plain
# version's.
MIXED_TOL = {"cholesky_blocked_bf16": 2e-3, "solve_lower_blocked_bf16": 2e-2,
             "interp_solve_bf16": 2e-2, "solve_lower_packed_bf16": 2e-2,
             "solve_lower_packed_bf16_f32_factor": 2e-2,
             # the same bf16 operation after bf16 operation on both sides
             "interp_factors_bf16": 0.0}
ERROR_RATIO = (0.5, 2.0)
# the precision phase: the reference test's bound on bf16_refined against
# fp32 (tests/test_precision.py:203)
PRECISION_RTOL, PRECISION_ATOL = 2e-2, 2e-3
POLICY_RUNS = (("picholesky", "fp32"), ("picholesky", "bf16_store"),
               ("picholesky", "bf16_refined"), ("exact", "bf16_store"))
# what the kernels line adds for the three cluster solves (tri_solve.cuh)
CLUSTER_KEYS = ("kernel_ms", "outside_kernel_ms", "other_device_ms", "plan",
                "ptxas")
# what the kernels line adds for the mixed variants (``design``: the
# mixed cluster solves' design that ran)
MIXED_KEYS = ("fp32_kernel_ms", "error_ratio", "shape", "design")
# what the kernels line adds for the Cholesky's rows: device ms and
# launches of its three kernels in one profiled call (and, for the mixed
# variant, the design that ran: CONV_KEYS' ``variant``)
CHOL_KEYS = ("by_kernel", "diag_ms_per_tile_column")
# what the kernels line adds for ssm_scan's fused entry (mamba_scan), with
# and without its segment states (the backward's checkpoints)
FUSED_KEYS = ("fused_ms", "fused_bound_ms", "fused_bound_by",
              "fused_plain_ms", "fused_err", "fused_states_ms",
              "fused_states_bound_ms")
# what the kernels line adds for kernel A: its self-walk mode's time, the
# checkpoint mode against the self-walk bit for bit, launches by mode
BWD_KEYS = ("walk_ms", "walk_plain_err", "ckpt_equals_walk",
            "launches_ckpt", "launches_walk")
# what the kernels line adds for the convolution's two kernels: the variant
# the main shape ran, bytes moved over time, the kernel's ptxas line
CONV_KEYS = ("variant", "tb_s", "registers")
# kernels that only move values: they must equal their plain versions
EXACT_KERNELS = ("pack_tril", "unpack_tril")
# The kernels each sweep of the main path launches; it launches no other.
PATH_KERNELS = {
    "picholesky": ("cholesky_blocked", "pack_tril", "interp_solve"),
    "exact": ("cholesky_blocked", "solve_lower_blocked"),
}
SOURCES = {
    "pack_tril": "src/repro_torch/kernels/csrc/tri_pack.cu",
    "cholesky_blocked": "src/repro_torch/kernels/csrc/chol_blocked.cu",
    "solve_lower_blocked": "src/repro_torch/kernels/csrc/trsm.cu",
    "interp_solve": "src/repro_torch/kernels/csrc/poly_interp.cu",
    "unpack_tril": "src/repro_torch/kernels/csrc/tri_pack.cu",
    "interp_factors": "src/repro_torch/kernels/csrc/poly_interp.cu",
    "solve_lower_packed": "src/repro_torch/kernels/csrc/packed_trsm.cu",
    "ssm_scan": "src/repro_torch/kernels/csrc/ssm_scan.cu",
    "causal_conv1d": "src/repro_torch/kernels/csrc/causal_conv1d.cu",
    "mamba_scan_bwd": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
    "causal_conv1d_bwd": "src/repro_torch/kernels/csrc/causal_conv1d.cu",
    "cholesky_blocked_bf16": "src/repro_torch/kernels/csrc/chol_blocked.cu",
    "solve_lower_blocked_bf16": "src/repro_torch/kernels/csrc/trsm.cu",
    "interp_solve_bf16": "src/repro_torch/kernels/csrc/poly_interp.cu",
    "interp_factors_bf16": "src/repro_torch/kernels/csrc/poly_interp.cu",
    "solve_lower_packed_bf16": "src/repro_torch/kernels/csrc/packed_trsm.cu",
}


#: checks that failed in a phase that goes on measuring; main() raises
#: on them after the kernels line, before the ok line
FAILED: list = []


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after one warm-up,
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def errors(out: torch.Tensor, plain: torch.Tensor) -> tuple[float, float]:
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    if not out.numel():
        return 0.0, 0.0
    diff = float((out - plain).abs().max())
    return diff, diff / max(float(plain.abs().max()), 1e-300)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", kind=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         peaks=peaks_for(name))
    print(smi, flush=True)
    return dict(name=name, smi=smi, peaks=peaks_for(name))


def ptxas_lines(log: str) -> list:
    """``-Xptxas -v`` of one library: per compiled kernel its (mangled)
    name, its registers and shared memory, and its stack and spills."""
    out, cur = [], None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            cur = dict(kernel=line.split("'")[1])
            out.append(cur)
        elif cur is not None and "spill" in line:
            cur["spills"] = line
        elif cur is not None and "registers" in line:
            cur["used"] = line.split("info    : ")[-1]
    return out


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per_source = _build.build_all()
    regs = {}
    for name in _build.SOURCES:
        log = _build._target(name).with_suffix(".log")
        regs[name] = ptxas_lines(log.read_text()) if log.exists() else []
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source,
         ptxas={k: [r.get("used", "") for r in v] for k, v in regs.items()})
    for name in _build.SOURCES:
        for r in regs[name]:
            print(f"ptxas {name}: {r['kernel']}: {r.get('used', '')}; "
                  f"{r.get('spills', '')}", flush=True)


def main_inputs(dev):
    from repro_torch.core import cv
    from repro_torch.data import make_regression_dataset
    x, y = make_regression_dataset(N_TRAIN, H, seed=SEED,
                                   dtype=torch.float64, device=dev)
    folds = cv.make_folds(x, y, K_FOLDS, device=dev)
    lams = torch.logspace(np.log10(LAM_LO), np.log10(LAM_HI), N_LAMBDAS,
                          dtype=torch.float64, device=dev)
    return folds, lams


def check_kernels(dev, h: int, block: int, n_anchor: int, n_exact: int,
                  dtype, folds=None, lams=None, timing=None) -> dict:
    """Every kernel against its plain version on one set of inputs; with
    ``timing`` (a peaks dict), also times and bounds."""
    from repro_torch.core import packing, picholesky
    from repro_torch.kernels import (chol_blocked, packed_trsm, poly_interp,
                                     ref, trsm, tri_pack)
    gen = torch.Generator(device=dev).manual_seed(1)
    if folds is not None:
        h_tr = folds.hess[None] - folds.fold_hess
        g_tr = folds.grad[None] - folds.fold_grad
        sample = picholesky.choose_sample_lambdas(
            float(lams[0]), float(lams[-1]), G_SAMPLES, device=dev)
        eye = torch.eye(h, dtype=dtype, device=dev)
        anchors = (h_tr[:, None] + sample[:, None, None] * eye
                   ).reshape(-1, h, h)
        exact = (h_tr[:, None] + lams[:LAM_CHUNK, None, None] * eye
                 ).reshape(-1, h, h)
        rhs = g_tr[:, None].expand(-1, LAM_CHUNK, -1).reshape(-1, h, 1)
    else:
        x = torch.randn(n_anchor, 2 * h, h, generator=gen, device=dev,
                        dtype=torch.float64)
        anchors = (x.mT @ x / h + torch.eye(h, device=dev,
                                            dtype=torch.float64)).to(dtype)
        exact = anchors[:n_exact].contiguous()
        h_tr = anchors[:n_exact]
        g_tr = torch.randn(n_exact, h, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)
        rhs = g_tr[:, :, None].contiguous()
        sample = torch.logspace(-3, 0, G_SAMPLES, dtype=torch.float64,
                                device=dev)
    tol = TOL[dtype]
    res = {}

    # cholesky_blocked
    l_k = chol_blocked.cholesky_blocked(anchors, block)
    l_p = ref.cholesky_blocked(anchors, block)
    res["cholesky_blocked"] = dict(zip(("max_abs_err", "max_rel_err"),
                                       errors(l_k, l_p)))
    # pack_tril (on the anchor factors, as fit packs them)
    v_k = tri_pack.pack_tril(l_p, block)
    v_p = packing.pack_tril(l_p, block)
    res["pack_tril"] = dict(zip(("max_abs_err", "max_rel_err"),
                                errors(v_k, v_p)))
    # solve_lower_blocked: forward then transposed solve of one exact chunk,
    # as the exact sweep runs it (the kernel inverts the diagonal tiles)
    l_e = torch.linalg.cholesky(exact).contiguous()

    def trsm_kernel():
        w = trsm.solve_lower_blocked(l_e, rhs, block)
        return trsm.solve_lower_blocked(l_e, w, block, transpose=True)

    def trsm_plain():
        w = ref.solve_lower_blocked(l_e, rhs, block)
        return ref.solve_lower_blocked(l_e, w, block, transpose=True)

    want = trsm_plain()
    res["solve_lower_blocked"] = dict(zip(("max_abs_err", "max_rel_err"),
                                          errors(trsm_kernel(), want)))
    # interp_solve: Θ fitted on the anchors, one λ chunk, every fold
    n_fold = h_tr.shape[0]
    targets = v_p.reshape(-1, G_SAMPLES, v_p.shape[-1])[:n_fold] \
        if folds is not None else v_p[:n_fold, None].expand(
            -1, G_SAMPLES, -1)
    v = picholesky.vandermonde(sample, DEGREE).to(dtype)
    theta = torch.linalg.solve(v.T @ v, v.T @ targets.to(dtype)).contiguous()
    lam_c = lams[:LAM_CHUNK] if lams is not None else sample[:LAM_CHUNK]
    hp = packing.num_tiles(h, block) * block
    x_c = lam_c.to(dtype)

    def interp_kernel():
        return poly_interp.interp_solve(theta, lam_c, g_tr, h, block)

    def interp_plain():
        inv_d = ref.interp_diag_inverses(theta, x_c, h, block)
        gp = torch.nn.functional.pad(g_tr[..., None], (0, 0, 0, hp - h))
        return ref.interp_solve(theta, x_c, inv_d, gp, h, block)[:, :, :h, 0]

    res["interp_solve"] = dict(zip(("max_abs_err", "max_rel_err"),
                                   errors(interp_kernel(), interp_plain())))
    # unpack_tril: the packed anchor factors back to dense
    res["unpack_tril"] = dict(zip(("max_abs_err", "max_rel_err"),
                                  errors(tri_pack.unpack_tril(v_p, h, block),
                                         packing.unpack_tril(v_p, h, block))))
    # interp_factors: Θ of every fold at the whole λ grid
    lam_f = lams if lams is not None else torch.logspace(
        np.log10(LAM_LO), np.log10(LAM_HI), N_LAMBDAS, dtype=torch.float64,
        device=dev)
    x_f = lam_f.to(dtype)

    def factors_kernel():
        return poly_interp.interp_factors(theta, lam_f, h, block)

    def factors_plain():
        return ref.interp_factors(theta, x_f, h, block)

    res["interp_factors"] = dict(zip(("max_abs_err", "max_rel_err"),
                                     errors(factors_kernel(),
                                            factors_plain())))
    # packed solve: fold 0's interpolated packed factors at the whole grid,
    # one shared right-hand side, both sweeps (one launch)
    vecs = picholesky.PiCholesky(theta=theta[0], center=x_f.new_zeros(()),
                                 h=h, block=block).eval_packed(x_f)
    g_0 = g_tr[0].expand(vecs.shape[0], h)

    def psolve_kernel():
        return packed_trsm.solve_packed(vecs, g_0, h, block)

    def psolve_plain():
        return ref.solve_packed(vecs, g_0[..., None], h, block)[..., 0]

    res["solve_lower_packed"] = dict(zip(("max_abs_err", "max_rel_err"),
                                         errors(psolve_kernel(),
                                                psolve_plain())))
    for name, r in res.items():
        r["tol_rel"] = 0.0 if name in EXACT_KERNELS else tol
        r["ok"] = r["max_rel_err"] <= r["tol_rel"]
    if timing is None:
        return res

    # times at these shapes, and the least time the card could take
    isz = torch.finfo(dtype).bits // 8
    bw = timing["bw"]
    p_size = packing.packed_size(h, block)
    nb_a, nb_e = anchors.shape[0], exact.shape[0]
    tri = h * (h + 1) // 2
    ii, jj = packing.tile_index_pairs(h, block)
    rows = (ii[:, None, None] * block + np.arange(block)[None, :, None])
    cols = (jj[:, None, None] * block + np.arange(block)[None, None, :])
    gather_idx = torch.as_tensor((rows * h + cols).reshape(-1), device=dev)
    flat = l_p.reshape(nb_a, -1)
    work = dict(
        cholesky_blocked=dict(
            kernel=lambda: chol_blocked.cholesky_blocked(anchors, block),
            plain=lambda: ref.cholesky_blocked(anchors, block),
            library=lambda: torch.linalg.cholesky(anchors),
            bytes=nb_a * (tri + h * h) * isz, flops=nb_a * h ** 3 / 3,
            peak=timing["fp64_tc"]),
        pack_tril=dict(
            kernel=lambda: tri_pack.pack_tril(l_p, block),
            plain=lambda: packing.pack_tril(l_p, block),
            library=(lambda: flat.index_select(1, gather_idx))
            if h % block == 0 else None,
            bytes=nb_a * (tri + p_size) * isz, flops=0.0,
            peak=timing["fp64"]),
        solve_lower_blocked=dict(
            kernel=trsm_kernel, plain=trsm_plain,
            library=lambda: torch.cholesky_solve(rhs, l_e),
            bytes=nb_e * (tri + 2 * h) * isz, flops=nb_e * 2.0 * h * h,
            peak=timing["fp64"]),
        interp_solve=dict(
            kernel=interp_kernel, plain=interp_plain, library=None,
            bytes=(theta.numel() + g_tr.numel()
                   + n_fold * LAM_CHUNK * h) * isz,
            flops=n_fold * LAM_CHUNK * 2.0 * p_size * (2 * DEGREE + 2),
            peak=timing["fp64"]),
        unpack_tril=dict(
            kernel=lambda: tri_pack.unpack_tril(v_p, h, block),
            plain=lambda: packing.unpack_tril(v_p, h, block),
            library=(lambda: torch.zeros(nb_a, h * h, dtype=dtype, device=dev)
                     .index_copy_(1, gather_idx, v_p))
            if h % block == 0 else None,
            bytes=nb_a * (p_size + h * h) * isz, flops=0.0,
            peak=timing["fp64"]),
        interp_factors=dict(
            kernel=factors_kernel, plain=factors_plain, library=None,
            bytes=(theta.numel() + n_fold * lam_f.numel() * h * h) * isz,
            flops=n_fold * lam_f.numel() * tri * 2.0 * DEGREE,
            peak=timing["fp64"]),
        solve_lower_packed=dict(
            kernel=psolve_kernel, plain=psolve_plain, library=None,
            bytes=(vecs.numel() + h + vecs.shape[0] * h) * isz,
            flops=vecs.shape[0] * 2 * 2.0 * tri, peak=timing["fp64"]),
    )
    for name, w in work.items():
        t_bytes = w["bytes"] / bw * 1e3
        t_ops = w["flops"] / w["peak"] * 1e3
        res[name].update(
            ms=timed_ms(w["kernel"], 5), plain_ms=timed_ms(w["plain"], 2),
            library_ms=None if w["library"] is None
            else timed_ms(w["library"], 5),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            work_bytes=w["bytes"], work_flops=w["flops"])
    for name, fn in (("solve_lower_blocked", trsm_kernel),
                     ("interp_solve", interp_kernel),
                     ("solve_lower_packed", psolve_kernel)):
        res[name].update(cluster_split(name, fn, res[name]["ms"]))
    # the Cholesky's three kernels at this shape, from one profiled call
    _, by_name = profiled(lambda: chol_blocked.cholesky_blocked(anchors,
                                                                block))
    split = chol_split(by_name)
    res["cholesky_blocked"].update(
        by_kernel=split,
        diag_ms_per_tile_column=split["diag_kernel"]["ms_per_launch"])
    return res


#: the main path's rows (1, 3, 6, 8) timed again at the tuner's block
TUNED_ROWS = ("cholesky_blocked", "pack_tril", "interp_solve",
              "solve_lower_blocked")


def tuned_config(dev, folds, lams):
    """What ``tune='auto'`` chooses at the main configuration (pricing
    only: nothing runs)."""
    from repro_torch.core import engine
    from repro_torch.distributed import autotune
    eng = engine.CVEngine(_pi_strategy(), backend="cuda", device=dev,
                          tune="auto")
    return autotune.tune(eng, folds, lams)


def bf16_chunk() -> int:
    """The λ chunk the engine's ``'auto'`` takes under a bf16 store at the
    main configuration (its 16 MiB budget over the bf16 packed factor)."""
    from repro_torch.core import engine
    return engine.auto_lam_chunk(H, BLOCK, torch.bfloat16,
                                 engine.LAM_CHUNK_BUDGET_BYTES)


def check_mixed(dev, h: int, block: int, n_anchor: int, n_exact: int,
                n_lam: int, folds=None, lams=None, timing=None) -> dict:
    """The mixed-precision variants (bf16 products, float32 sums and state)
    against their plain versions on the card, in float32, on one set of
    inputs: the Cholesky of ``n_anchor`` matrices, the trsm pair of
    ``n_exact`` factors, ``interp_solve`` with a bf16 Θ at ``n_lam`` λs;
    ``interp_factors`` of that bf16 Θ and the packed solve (both sweeps)
    of fold 0's bf16 packed factors, both at the whole grid (``lams``, or
    the ``n_lam`` λs), and the packed solve of float32 factors under bf16
    products.  With ``timing`` (a peaks dict), also the times of the
    variant, its plain version, its one-dtype float32 kernel on the same
    inputs and the float32 library call, and the bound at the bf16
    tensor-core peak (``interp_factors``: at the float32 peak, its Horner
    runs on the CUDA cores)."""
    from repro_torch.core import packing, picholesky
    from repro_torch.kernels import (chol_blocked, packed_trsm, poly_interp,
                                     ref, trsm)
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(3)
    eye = torch.eye(h, dtype=torch.float64, device=dev)
    if folds is not None:
        h_tr = folds.hess[None] - folds.fold_hess
        g_tr = (folds.grad[None] - folds.fold_grad).to(f32)
        sample = picholesky.choose_sample_lambdas(
            float(lams[0]), float(lams[-1]), G_SAMPLES, device=dev)
        anchors = (h_tr[:, None] + sample[:, None, None] * eye
                   ).reshape(-1, h, h).to(f32)
        lam_c = lams[:n_lam]
        n_rep = -(-n_exact // h_tr.shape[0])
        exact = (h_tr[:, None] + lams[:n_rep, None, None] * eye
                 ).reshape(-1, h, h)[:n_exact].to(f32)
    else:
        x = torch.randn(n_anchor, 2 * h, h, generator=gen, device=dev,
                        dtype=torch.float64)
        anchors = (x.mT @ x / h + eye).to(f32)
        exact = anchors[:n_exact].contiguous()
        g_tr = torch.randn(n_exact, h, generator=gen, device=dev, dtype=f32)
        sample = torch.logspace(-3, 0, G_SAMPLES, dtype=torch.float64,
                                device=dev)
        lam_c = torch.logspace(-3, 0, n_lam, dtype=torch.float64, device=dev)
    rhs = torch.randn(exact.shape[0], h, 1, generator=gen, device=dev,
                      dtype=f32)
    res = {}

    def held(name, out, plain, exact):
        """kernel vs plain, and each against the float64 result"""
        res[name] = dict(zip(("max_abs_err", "max_rel_err"),
                             errors(out, plain)))
        e_k = errors(out.double(), exact)[1]
        e_p = errors(plain.double(), exact)[1]
        res[name].update(error_vs_float64=e_k,
                         error_vs_float64_plain=e_p, error_ratio=e_k / e_p)

    # cholesky_blocked, mixed
    l_k = chol_blocked.cholesky_blocked(anchors, block, compute_dtype=bf)
    l_p = ref.cholesky_blocked(anchors, block, bf)
    held("cholesky_blocked_bf16", l_k, l_p,
         torch.linalg.cholesky(anchors.double()))
    res["cholesky_blocked_bf16"]["variant"] = chol_blocked.mixed_variant(block)
    # solve_lower_blocked, mixed: forward then transposed solve
    l_e = torch.linalg.cholesky(exact).contiguous()

    def trsm_pair(**kw):
        w = trsm.solve_lower_blocked(l_e, rhs, block, **kw)
        return trsm.solve_lower_blocked(l_e, w, block, transpose=True, **kw)

    def trsm_plain():
        w = ref.solve_lower_blocked(l_e, rhs, block, compute_dtype=bf)
        return ref.solve_lower_blocked(l_e, w, block, transpose=True,
                                       compute_dtype=bf)

    held("solve_lower_blocked_bf16", trsm_pair(compute_dtype=bf),
         trsm_plain(), torch.cholesky_solve(rhs.double(), l_e.double()))
    # interp_solve, mixed: Θ fitted at float32 on the packed anchors, kept
    # in bf16 as the bf16 policies store it
    n_fold = g_tr.shape[0]
    v_p = packing.pack_tril(l_p, block)
    targets = v_p.reshape(-1, G_SAMPLES, v_p.shape[-1])[:n_fold] \
        if folds is not None else v_p[:n_fold, None].expand(-1, G_SAMPLES,
                                                              -1)
    v = picholesky.vandermonde(sample, DEGREE).to(f32)
    theta32 = torch.linalg.solve(v.T @ v, v.T @ targets).contiguous()
    theta = theta32.to(bf)
    hp = packing.num_tiles(h, block) * block
    x_c = lam_c.to(f32)

    def interp_kernel():
        return poly_interp.interp_solve(theta, lam_c, g_tr, h, block,
                                        compute_dtype=bf, accum_dtype=f32)

    def interp_plain():
        inv_d = ref.interp_diag_inverses(theta, x_c, h, block, f32)
        gp = torch.nn.functional.pad(g_tr[..., None], (0, 0, 0, hp - h))
        return ref.interp_solve(theta, x_c, inv_d, gp, h, block,
                                bf)[:, :, :h, 0]

    # float64 of the same bf16 Θ (the one-dtype kernel)
    held("interp_solve_bf16", interp_kernel(), interp_plain(),
         poly_interp.interp_solve(theta.double(), lam_c, g_tr.double(), h,
                                  block))
    # interp_factors on the bf16 Θ at the whole grid: every Horner step
    # rounded to bf16 on both sides (torch rounds each bf16 operation)
    lam_f = lams if lams is not None else lam_c
    x_f = lam_f.to(bf)

    def factors_kernel():
        return poly_interp.interp_factors(theta, lam_f, h, block)

    def factors_plain():
        return ref.interp_factors(theta, x_f, h, block)

    held("interp_factors_bf16", factors_kernel(), factors_plain(),
         poly_interp.interp_factors(theta.double(), lam_f, h, block))
    # the packed solve of fold 0's bf16 packed factors at the whole grid, as
    # the packed route evaluates them (Horner in bf16), one shared g
    vecs = picholesky.PiCholesky(theta=theta[0], center=x_f.new_zeros(()),
                                 h=h, block=block).eval_packed(lam_f)
    g_0 = g_tr[0].expand(vecs.shape[0], h)

    def psolve_kernel(v=vecs, **kw):
        return packed_trsm.solve_packed(v, g_0, h, block, **kw)

    def psolve_plain(v=vecs):
        return ref.solve_packed(v, g_0[..., None], h, block, bf)[..., 0]

    def psolve_f64(v):
        return packed_trsm.solve_packed(v.double(), g_0.double(), h, block)

    held("solve_lower_packed_bf16", psolve_kernel(), psolve_plain(),
         psolve_f64(vecs))
    # float32 factors (fold 0's at float32) under bf16 products: rounded
    # as the fragments are formed
    vecs32 = picholesky.PiCholesky(theta=theta32[0], center=x_c.new_zeros(()),
                                   h=h, block=block).eval_packed(lam_f.to(f32))
    held("solve_lower_packed_bf16_f32_factor",
         psolve_kernel(vecs32, compute_dtype=bf), psolve_plain(vecs32),
         psolve_f64(vecs32))
    for name, r in res.items():
        r["tol_rel"] = MIXED_TOL[name]
        r["ok"] = (r["max_rel_err"] <= r["tol_rel"]
                   and ERROR_RATIO[0] <= r["error_ratio"] <= ERROR_RATIO[1])
    if timing is None:
        return res

    # times at these shapes, and the least time the card could take
    bw = timing["bw"]
    p_size = packing.packed_size(h, block)
    nb_a, nb_e = anchors.shape[0], exact.shape[0]
    tri = h * (h + 1) // 2
    work = dict(
        cholesky_blocked_bf16=dict(
            kernel=lambda: chol_blocked.cholesky_blocked(anchors, block,
                                                         compute_dtype=bf),
            plain=lambda: ref.cholesky_blocked(anchors, block, bf),
            fp32=lambda: chol_blocked.cholesky_blocked(anchors, block),
            library=lambda: torch.linalg.cholesky(anchors),
            bytes=nb_a * (tri + h * h) * 4, flops=nb_a * h ** 3 / 3),
        solve_lower_blocked_bf16=dict(
            kernel=lambda: trsm_pair(compute_dtype=bf), plain=trsm_plain,
            fp32=trsm_pair,
            library=lambda: torch.cholesky_solve(rhs, l_e),
            bytes=nb_e * (tri + 2 * h) * 4, flops=nb_e * 2.0 * h * h),
        interp_solve_bf16=dict(
            kernel=interp_kernel, plain=interp_plain,
            fp32=lambda: poly_interp.interp_solve(theta32, lam_c, g_tr, h,
                                                  block),
            library=None,
            bytes=theta.numel() * 2 + (g_tr.numel()
                                       + n_fold * lam_c.numel() * h) * 4,
            flops=n_fold * lam_c.numel() * 2.0 * p_size * (2 * DEGREE + 2)),
        interp_factors_bf16=dict(
            kernel=factors_kernel, plain=factors_plain,
            fp32=lambda: poly_interp.interp_factors(theta32, lam_f, h, block),
            library=None,
            bytes=(theta.numel() + n_fold * lam_f.numel() * h * h) * 2,
            flops=n_fold * lam_f.numel() * tri * 2.0 * DEGREE,
            peak="fp32"),
        solve_lower_packed_bf16=dict(
            kernel=psolve_kernel, plain=psolve_plain,
            fp32=lambda: psolve_kernel(vecs.float()), library=None,
            bytes=vecs.numel() * 2 + (h + vecs.shape[0] * h) * 4,
            flops=vecs.shape[0] * 2 * 2.0 * tri),
    )
    for name, w in work.items():
        peak = w.get("peak", "bf16_tc")
        t_bytes = w["bytes"] / bw * 1e3
        t_ops = w["flops"] / timing[peak] * 1e3
        res[name].update(
            ms=timed_ms(w["kernel"], 5), plain_ms=timed_ms(w["plain"], 2),
            fp32_kernel_ms=timed_ms(w["fp32"], 5),
            library_ms=None if w["library"] is None
            else timed_ms(w["library"], 5),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            work_bytes=w["bytes"], work_flops=w["flops"],
            peak=peak, shape=dict(h=h, block=block, anchors=nb_a,
                                  exact=nb_e, folds=n_fold,
                                  lams=lam_c.numel(),
                                  grid=lam_f.numel()))
    for name, fn in (("solve_lower_blocked_bf16",
                      lambda: trsm_pair(compute_dtype=bf)),
                     ("interp_solve_bf16", interp_kernel),
                     ("solve_lower_packed_bf16", psolve_kernel)):
        res[name].update(cluster_split(name, fn, res[name]["ms"]))
        if res[name]["design"] != MIXED_SOLVE_DESIGN:
            res[name]["ok"] = False
    _, by_name = profiled(lambda: chol_blocked.cholesky_blocked(
        anchors, block, compute_dtype=bf))
    row = res["cholesky_blocked_bf16"]
    row["by_kernel"] = chol_split(by_name)
    row["diag_ms_per_tile_column"] = \
        row["by_kernel"]["diag_kernel"]["ms_per_launch"]
    # the design that ran, from the kernels' names (the wgmma design's
    # panel and trailing update are panel_kernel_tc and syrk_kernel_tc)
    ran = "wgmma" if any("_kernel_tc" in n for n in by_name) else "mma_sync"
    if ran != row["variant"]:
        row["ok"] = False
    row["variant"] = ran
    return res


def check_chol_designs(dev, h: int, block: int, batch: int) -> dict:
    """The mixed Cholesky at ``block`` (the design ``mixed_variant`` names)
    against its plain version on ``batch`` SPD float32 matrices of ``h``:
    max |Δ| / max |plain| within MIXED_TOL, the error against float64
    within ERROR_RATIO of the plain version's, the same bits on two
    calls."""
    from repro_torch.kernels import chol_blocked, ref
    gen = torch.Generator(device=dev).manual_seed(h + batch)
    x = torch.randn(batch, 2 * h, h, generator=gen, device=dev,
                    dtype=torch.float64)
    a = (x.mT @ x / h + torch.eye(h, dtype=torch.float64, device=dev)
         ).float().contiguous()
    del x
    bf = torch.bfloat16
    got = chol_blocked.cholesky_blocked(a, block, compute_dtype=bf)
    again = chol_blocked.cholesky_blocked(a, block, compute_dtype=bf)
    plain = ref.cholesky_blocked(a, block, bf)
    exact = torch.linalg.cholesky(a.double())
    e_k = errors(got.double(), exact)[1]
    e_p = errors(plain.double(), exact)[1]
    out = dict(zip(("max_abs_err", "max_rel_err"), errors(got, plain)),
               error_ratio=e_k / e_p, same_bits=torch.equal(got, again),
               variant=chol_blocked.mixed_variant(block), h=h, block=block,
               batch=batch, tol_rel=MIXED_TOL["cholesky_blocked_bf16"])
    out["ok"] = (out["max_rel_err"] <= out["tol_rel"] and out["same_bits"]
                 and ERROR_RATIO[0] <= out["error_ratio"] <= ERROR_RATIO[1])
    return out


def scan_inputs(dev, b: int, s: int, di: int, n: int, seed: int = 2):
    """Selective-scan inputs as the model makes them: dt = softplus(·) of
    order 0.05, A = -(1..N) (the ``mamba_a`` init), normal x, B, C, D."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xc = torch.randn(b, s, di, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, di, generator=gen, device=dev) - 3.0)
    bm, cm = (torch.randn(b, s, n, generator=gen, device=dev)
              for _ in range(2))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(
        di, n).contiguous()
    d = torch.randn(di, generator=gen, device=dev)
    return xc, dt, bm, cm, a, d


def check_ssm_scan(dev, shape, timing=None) -> dict:
    """``ssm_scan`` against its plain version on the card (y and h_last),
    then its fused entry ``mamba_scan`` in bf16 at the same shape; with
    ``timing`` (a peaks dict), also times and the bounds of both."""
    from repro_torch.kernels import ref, ssm_scan
    ins = scan_inputs(dev, *shape)

    def kernel():
        return ssm_scan.ssm_scan(*ins)

    def plain():
        return ref.ssm_scan(*ins)

    (y, h), (y_p, h_p) = kernel(), plain()
    ey, eh = errors(y, y_p), errors(h, h_p)
    res = dict(max_abs_err=max(ey[0], eh[0]), max_rel_err=max(ey[1], eh[1]),
               tol_rel=TOL[torch.float32])
    res["ok"] = res["max_rel_err"] <= res["tol_rel"]
    del ins, y, h, y_p, h_p
    fused = check_mamba_scan(dev, shape, torch.bfloat16, timing=timing)
    res["fused_err"] = fused["err"]
    res["ok"] = res["ok"] and fused["ok"]
    if timing is None:
        return res
    ins = scan_inputs(dev, *shape)
    b, s, di, n = shape
    # read x, dt, B, C, A, D once; write y and h_last once (float32)
    work_bytes = (3 * b * s * di + 2 * b * s * n + di * n + di
                  + b * di * n) * 4
    exps = b * s * di * n
    flops = 4.0 * b * s * di * n       # dt·A, dx·B, the h and y FMAs
    t_bytes = work_bytes / timing["bw"] * 1e3
    t_ops = max(exps / timing["sfu"], flops / timing["fp32"]) * 1e3
    res.update(ms=timed_ms(kernel, 10), plain_ms=timed_ms(plain, 1),
               library_ms=None, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes_ms=t_bytes, exp_ms=exps / timing["sfu"] * 1e3,
               fp32_ms=flops / timing["fp32"] * 1e3, work_bytes=work_bytes,
               work_exps=exps, work_flops=flops,
               **{k: fused[k] for k in FUSED_KEYS if k in fused},
               fused_work=fused["fused_work"])
    return res


def mixer_inputs(dev, b: int, s: int, di: int, n: int, dtype,
                 h0: bool = False, seed: int = 3):
    """``mamba_scan``'s inputs as the model makes them: dt_lin and dt_bias
    whose softplus is of order 0.05, B and C the slices of one (B, S,
    DT_RANK + 2N) ``x_proj`` output (strided views), A = -(1..N), normal
    x, z, D and (with ``h0``) an initial state."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*size):
        return torch.randn(*size, generator=gen, device=dev)

    xc, z = randn(b, s, di).to(dtype), randn(b, s, di).to(dtype)
    dt_lin = 0.5 * randn(b, s, di)
    dt_bias = randn(di) - 3.0
    proj = randn(b, s, DT_RANK + 2 * n).to(dtype)
    bm, cm = proj[..., DT_RANK:DT_RANK + n], proj[..., DT_RANK + n:]
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(
        di, n).contiguous()
    d = randn(di)
    state = randn(b, di, n) if h0 else None
    return xc, dt_lin, dt_bias, bm, cm, a, d, z, state


def _bf16_ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in the order of the values."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def bf16_ulps(out: torch.Tensor, plain: torch.Tensor) -> int:
    """The most bf16 values between an element of out and of plain."""
    return int((_bf16_ordered(out) - _bf16_ordered(plain)).abs().max()) \
        if out.numel() else 0


def check_mamba_scan(dev, shape, dtype, h0: bool = False,
                     timing=None) -> dict:
    """``mamba_scan`` against its plain version on the card: y (float32:
    MAMBA_TOL of max |plain|; bf16: per element, MIXER_BF16_REL of |plain|
    plus MAMBA_TOL of max |plain|), h_last and the segment states
    (``states=True``, MAMBA_TOL; y and h_last then the same bits as
    without); with ``timing``, its time and bound without and with the
    states."""
    from repro_torch.kernels import ref, ssm_scan
    ins = mixer_inputs(dev, *shape, dtype, h0=h0)
    (y, h, st), (y_p, h_p, st_p) = (ssm_scan.mamba_scan(*ins, states=True),
                                    ref.mamba_scan(*ins, states=True))
    y0, h0_ = ssm_scan.mamba_scan(*ins)
    same = torch.equal(y, y0) and torch.equal(h, h0_)
    del y0, h0_
    eh, est = errors(h, h_p)[1], errors(st, st_p)[1]
    del st, st_p
    err = dict(h_last_rel=eh, tol_h_last=MAMBA_TOL, states_rel=est,
               with_states_same_bits=same)
    if not torch.isfinite(y).all():
        raise AssertionError("mamba_scan: y is not finite")
    d, p = (y.float() - y_p.float()).abs(), y_p.float().abs()
    scale = float(p.max()) if y.numel() else 0.0
    y_rel = float(d.max()) / max(scale, 1e-300) if y.numel() else 0.0
    if dtype == torch.float32:
        err.update(y_rel=y_rel, tol_y=MAMBA_TOL)
        ok = y_rel <= MAMBA_TOL
    else:
        limit = MIXER_BF16_REL * p + MAMBA_TOL * scale
        one_step = torch.where(d == 0, torch.zeros_like(d), d / p)
        if y.numel():
            # the element furthest beyond one step + the absolute term
            ratio = d / (MIXER_BF16_ONE_STEP * p + MAMBA_TOL * scale)
            i = int(ratio.argmax())
            yf, pf = y.reshape(-1)[i:i + 1], y_p.reshape(-1)[i:i + 1]
            err["y_worst"] = dict(
                plain=float(pf), got=float(yf), of_max=float(pf.abs()) / scale,
                steps=bf16_ulps(yf, pf),
                of_one_step_limit=float(ratio.reshape(-1)[i]))
        err.update(y_rel=y_rel,
                   y_over_limit=float((d > limit).float().sum()),
                   y_one_step_rel=float(one_step.max()) if y.numel() else 0.0,
                   y_over_one_step_share=float(
                       (one_step > MIXER_BF16_ONE_STEP).float().mean())
                   if y.numel() else 0.0,
                   y_differ_share=float((d > 0).float().mean())
                   if y.numel() else 0.0,
                   y_max_ulps=bf16_ulps(y, y_p), tol_y_elem_rel=MIXER_BF16_REL,
                   tol_y_abs_of_max=MAMBA_TOL)
        ok = err["y_over_limit"] == 0
    ok = ok and eh <= MAMBA_TOL and est <= MAMBA_TOL and same
    res = dict(err=dict(err, shape=list(shape), dtype=str(dtype), h0=h0,
                        ok=ok), ok=ok)
    if timing is None:
        return res
    b, s, di, n = shape
    es = torch.empty((), dtype=dtype).element_size()
    # read x, z, dt_lin, B, C, A, D, dt_bias once; write y and h_last once;
    # with the states, write them once too
    work_bytes = (3 * b * s * di * es + b * s * di * 4 + 2 * b * s * n * es
                  + (di * n + 2 * di + b * di * n) * 4)
    states_bytes = b * -(-s // ssm_scan.BWD_SEGMENT) * di * n * 4
    mufu = b * s * di * (n + MIXER_EXTRA_MUFU)
    t_bytes = work_bytes / timing["bw"] * 1e3
    t_ops = mufu / timing["sfu"] * 1e3
    res.update(fused_ms=timed_ms(lambda: ssm_scan.mamba_scan(*ins), 10),
               fused_states_ms=timed_ms(
                   lambda: ssm_scan.mamba_scan(*ins, states=True), 10),
               fused_plain_ms=timed_ms(lambda: ref.mamba_scan(*ins), 1),
               fused_bound_ms=max(t_bytes, t_ops),
               fused_states_bound_ms=max(
                   t_bytes + states_bytes / timing["bw"] * 1e3, t_ops),
               fused_bound_by="bytes" if t_bytes >= t_ops else "operations",
               fused_work=dict(bytes=work_bytes, mufu=mufu,
                               bytes_ms=t_bytes, mufu_ms=t_ops,
                               states_bytes=states_bytes))
    return res


def offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t``'s values in a tensor whose base lies ``offset`` elements past
    an allocation's (a base the bulk copies cannot take when ``offset``
    is not a multiple of 16 bytes)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def conv_registers(bwd: bool, dtype, variant: str) -> list:
    """``-Xptxas -v`` of the convolution's kernels that ``variant`` runs
    in ``dtype`` (one line; the generic variant's vector and element
    kernels: two): registers, shared memory."""
    from repro_torch.kernels import _build
    log = _build._target("causal_conv1d").with_suffix(".log")
    name = ("causal_conv1d_silu_bwd_kernel" if bwd
            else "causal_conv1d_silu_kernel")
    name += "I13__nv_bfloat16" if dtype == torch.bfloat16 else "If"
    rows = "RingRows" if variant == "staged" else "DirectRows"
    return [r.get("used", "") for r in
            (ptxas_lines(log.read_text()) if log.exists() else [])
            if name in r["kernel"] and rows in r["kernel"]]


def check_conv(dev, shape, dtype, state: bool, timing=None,
               offset: int = 0) -> dict:
    """``causal_conv1d_silu`` against its plain version on the card, bit
    for bit (output and new state), the same bits on two calls, the
    variant that ran (``offset``: every input's base that many elements
    past an allocation's); with ``timing``, its time, bound, bytes over
    time, registers and ``F.conv1d`` (cuDNN, TF32 off: conv and bias, no
    silu) on the same input."""
    from repro_torch.kernels import causal_conv1d, ref
    b, s, c = shape
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(b, s, c, generator=gen, device=dev).to(dtype)
    w = (0.5 * torch.randn(c, CONV_WIDTH, generator=gen, device=dev)
         ).to(dtype)
    bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(dtype)
    st = torch.randn(b, CONV_WIDTH - 1, c, generator=gen,
                     device=dev).to(dtype) if state else None
    x = offset_view(x, offset)
    st = None if st is None else offset_view(st, offset)

    def kernel():
        return causal_conv1d.causal_conv1d_silu(x, w, bias, st)

    def plain():
        return ref.causal_conv1d_silu(x, w, bias, st)

    causal_conv1d.LAST_VARIANT.pop("causal_conv1d", None)
    (y, ns), (y_p, ns_p) = kernel(), plain()
    ran = causal_conv1d.LAST_VARIANT.get("causal_conv1d")
    twice = _bitwise((y, ns), kernel())
    if not torch.isfinite(y).all():
        raise AssertionError("causal_conv1d: output is not finite")
    diff = max(float((y.float() - y_p.float()).abs().max()) if y.numel()
               else 0.0, float((ns.float() - ns_p.float()).abs().max()))
    exact = torch.equal(y, y_p) and torch.equal(ns, ns_p)
    res = dict(max_abs_err=diff, max_ulps=bf16_ulps(y, y_p)
               if dtype == torch.bfloat16 else None,
               bit_exact=exact, bitwise_twice=twice, ok=exact and twice,
               variant=ran, shape=list(shape), dtype=str(dtype),
               state=state, offset=offset)
    if timing is None:
        return res
    es = torch.empty((), dtype=dtype).element_size()
    # read x, w, b, the state once; write xc and the new state once
    work_bytes = (2 * b * s * c + c * CONV_WIDTH + c
                  + 2 * b * (CONV_WIDTH - 1) * c) * es
    flops = (2.0 * CONV_WIDTH + 4) * b * s * c   # the taps, bias, silu
    t_bytes = work_bytes / timing["bw"] * 1e3
    t_ops = flops / timing["fp32"] * 1e3
    x_ncw = x.transpose(1, 2)
    w_lib = w[:, None, :]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        library_ms = timed_ms(lambda: torch.nn.functional.conv1d(
            x_ncw, w_lib, bias=bias, padding=CONV_WIDTH - 1, groups=c), 10)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ms = timed_ms(kernel, 10)
    res.update(ms=ms, plain_ms=timed_ms(plain, 2),
               library_ms=library_ms, library="F.conv1d(groups=C, bias), "
               "cudnn.allow_tf32=False", bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               work_bytes=work_bytes, work_flops=flops,
               tb_s=work_bytes / ms / 1e9,
               registers=conv_registers(False, dtype, ran))
    return res


def _bitwise(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


SCAN_BWD_NAMES = ("dxc", "ddt_lin", "ddt_bias", "db_mat", "dc_mat", "da",
                  "dd_skip", "dz", "dh0")


def _bwd_errors(got, want, dtype) -> tuple[dict, bool]:
    """Kernel A's gradients against the plain ones, with their limits
    (see ``check_mamba_scan_bwd``)."""
    err, ok = {}, True
    for name, g, w in zip(SCAN_BWD_NAMES, got, want):
        if g is None:
            continue
        if not torch.isfinite(g).all():
            raise AssertionError(f"mamba_scan_bwd: {name} is not finite")
        d = (g.float() - w.float()).abs()
        scale = float(w.float().abs().max()) if w.numel() else 0.0
        rel = float(d.max()) / max(scale, 1e-300) if w.numel() else 0.0
        rec = dict(rel=rel)
        if dtype == torch.bfloat16 and name in ("dxc", "dz"):
            limit = MIXER_BF16_REL * w.float().abs() + MAMBA_BWD_TOL * scale
            rec.update(over_limit=float((d > limit).sum()),
                       max_ulps=bf16_ulps(g, w))
            good = rec["over_limit"] == 0
        else:
            tol = MAMBA_BWD_TOL if dtype == torch.float32 \
                else MAMBA_BWD_BF16_TOL
            rec["tol"] = tol
            good = rel <= tol
        rec["ok"] = good
        err[name] = rec
        ok = ok and good
    return err, ok


def check_mamba_scan_bwd(dev, shape, dtype, h0: bool = False,
                         timing=None) -> dict:
    """``mamba_scan_bwd`` (kernel A) against its plain version on the card
    in both modes: on the forward kernel's segment states
    (``mamba_scan(states=True)``; the checkpoint mode, which training runs)
    and on its own walk.  Every gradient: float32, max |Δ| ≤ MAMBA_BWD_TOL
    of max |plain| each; bf16, dxc and dz per element within MIXER_BF16_REL
    of |plain| plus MAMBA_BWD_TOL of max |plain|, the float32 gradients
    MAMBA_BWD_BF16_TOL of max |plain| (see their comment); each mode the
    same bits on two calls, and the two modes the same bits; with
    ``timing``, the time of each mode, the bound and the plain time."""
    from repro_torch.kernels import ref, ssm_scan
    ins = mixer_inputs(dev, *shape, dtype, h0=h0)
    gen = torch.Generator(device=dev).manual_seed(5)
    dy = torch.randn(*shape[:3], generator=gen, device=dev).to(dtype)
    dh_last = torch.randn(shape[0], shape[2], shape[3], generator=gen,
                          device=dev) if h0 else None
    args = (*ins[:8], dy, ins[8], dh_last)
    states = ssm_scan.mamba_scan(*ins, states=True)[2]

    def kernel():
        return ssm_scan.mamba_scan_bwd(*args, states=states)

    def walk():
        return ssm_scan.mamba_scan_bwd(*args)

    def plain():
        return ref.mamba_scan_bwd(*args)

    got, want = kernel(), plain()
    twice = _bitwise(got, kernel())
    got_walk = walk()
    walk_twice = _bitwise(got_walk, walk())
    same = _bitwise(got, got_walk)
    torch.cuda.synchronize()
    err, ok = _bwd_errors(got, want, dtype)
    err_walk, ok_walk = _bwd_errors(got_walk, want, dtype)
    del got_walk
    ok = ok and ok_walk and twice and walk_twice and same
    res = dict(err=err, walk_plain_err=err_walk, bitwise_twice=twice,
               walk_bitwise_twice=walk_twice, ckpt_equals_walk=same,
               shape=list(shape), dtype=str(dtype), h0=h0, ok=ok,
               max_abs_err=max(float((g.float() - w.float()).abs().max())
                               for g, w in zip(got, want)
                               if g is not None and g.numel()))
    if timing is None:
        return res
    b, s, di, n = shape
    es = torch.empty((), dtype=dtype).element_size()
    # read x, z, dy (T), dt_lin (f32), B, C (T), A, D, dt_bias once; write
    # dx, dz (T), d dt_lin (f32), dB, dC (f32), dA, dD, d dt_bias once
    work_bytes = (3 * b * s * di * es + b * s * di * 4 + 2 * b * s * n * es
                  + (di * n + 2 * di) * 4
                  + 2 * b * s * di * es + b * s * di * 4 + 2 * b * s * n * 4
                  + (di * n + 2 * di) * 4)
    # the decays once per (b, t, d, n), softplus, its derivative and the
    # gate's two sigmoids per (b, t, d)
    mufu = b * s * di * (n + MIXER_EXTRA_MUFU)
    t_bytes = work_bytes / timing["bw"] * 1e3
    t_ops = mufu / timing["sfu"] * 1e3
    res.update(ms=timed_ms(kernel, 5), walk_ms=timed_ms(walk, 5),
               plain_ms=timed_ms(plain, 1),
               library_ms=None, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               work=dict(bytes=work_bytes, mufu=mufu, bytes_ms=t_bytes,
                         mufu_ms=t_ops,
                         states_bytes=states.numel() * 4,
                         mufu_issued=b * s * di * n))
    return res


def check_conv_bwd(dev, shape, dtype, state: bool, timing=None,
                   offset: int = 0) -> dict:
    """``causal_conv1d_silu_bwd`` (kernel B) against its plain version on
    the card: dx (and dstate) bit for bit, dw and db within CONV_BWD_TOL of
    max |plain| (float32 sums in another order); the same bits on two
    calls; the variant that ran (``offset`` as for :func:`check_conv`);
    with ``timing``, its time, bound, bytes over time, registers, plain
    time and the backward of ``F.conv1d`` (groups = C, cuDNN, TF32 off) on
    the same input."""
    from repro_torch.kernels import causal_conv1d, ref
    b, s, c = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(b, s, c, generator=gen, device=dev).to(dtype)
    w = (0.5 * torch.randn(c, CONV_WIDTH, generator=gen, device=dev)
         ).to(dtype)
    bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(dtype)
    dout = torch.randn(b, s, c, generator=gen, device=dev).to(dtype)
    st = torch.randn(b, CONV_WIDTH - 1, c, generator=gen,
                     device=dev).to(dtype) if state else None
    x, dout = offset_view(x, offset), offset_view(dout, offset)
    st = None if st is None else offset_view(st, offset)

    def kernel():
        return causal_conv1d.causal_conv1d_silu_bwd(x, w, bias, dout, st)

    def plain():
        return ref.causal_conv1d_silu_bwd(x, w, bias, dout, st)

    causal_conv1d.LAST_VARIANT.pop("causal_conv1d_bwd", None)
    got, want = kernel(), plain()
    ran = causal_conv1d.LAST_VARIANT.get("causal_conv1d_bwd")
    twice = _bitwise(got, kernel())
    torch.cuda.synchronize()
    err = {}
    for name, g, v in zip(("dx", "dw", "db", "dstate"), got, want):
        if g is None:
            continue
        if not torch.isfinite(g).all():
            raise AssertionError(f"causal_conv1d_bwd: {name} is not finite")
        d = float((g.float() - v.float()).abs().max()) if g.numel() else 0.0
        scale = float(v.float().abs().max()) if v.numel() else 0.0
        err[name] = dict(max_abs=d, rel=d / max(scale, 1e-300))
    exact = all(err[k]["max_abs"] == 0.0 for k in ("dx", "dstate")
                if k in err)
    sums_ok = all(err[k]["rel"] <= CONV_BWD_TOL for k in ("dw", "db"))
    res = dict(err=err, dx_bit_exact=exact, bitwise_twice=twice,
               ok=exact and sums_ok and twice, variant=ran,
               shape=list(shape), dtype=str(dtype), state=state,
               offset=offset, tol_sums=CONV_BWD_TOL,
               max_abs_err=max(e["max_abs"] for e in err.values()))
    if timing is None:
        return res
    es = torch.empty((), dtype=dtype).element_size()
    # read x, dout, w, b, the state once; write dx, dstate (T), dw, db (f32)
    k = CONV_WIDTH
    work_bytes = ((3 * b * s * c + c * k + c + 2 * b * (k - 1) * c) * es
                  + c * (k + 1) * 4)
    # the recompute (K products and sums, bias), silu's gradient, K
    # products and sums each for dx and dw, one sum for db
    flops = (6.0 * k + 10) * b * s * c
    t_bytes = work_bytes / timing["bw"] * 1e3
    t_ops = flops / timing["fp32"] * 1e3
    xl = x.transpose(1, 2).detach().requires_grad_()
    wl = w[:, None, :].detach().requires_grad_()
    bl = bias.detach().requires_grad_()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yl = torch.nn.functional.conv1d(xl, wl, bias=bl, padding=k - 1,
                                        groups=c)
        gl = torch.randn_like(yl)
        library_ms = timed_ms(lambda: torch.autograd.grad(
            yl, (xl, wl, bl), gl, retain_graph=True), 5)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ms = timed_ms(kernel, 10)
    res.update(ms=ms, plain_ms=timed_ms(plain, 2),
               library_ms=library_ms,
               library="autograd of F.conv1d(groups=C, bias), "
               "cudnn.allow_tf32=False", bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               work_bytes=work_bytes, work_flops=flops,
               tb_s=work_bytes / ms / 1e9,
               registers=conv_registers(True, dtype, ran))
    return res


def phase_kernels_bwd(dev, peaks) -> tuple[dict, dict]:
    """Rows 11 and 12, the backward kernels of training, against their
    plain versions: at the training shape in bf16 (timed) and float32, at a
    ragged shape (odd S, d_inner not a multiple of a block) from a state,
    and small from a state, kernel A in both its modes; then
    ``ssm_scan``'s refusal of a gradient on the card."""
    from repro_torch.kernels import ssm_scan
    rows = {"mamba_scan_bwd": check_mamba_scan_bwd(
                dev, SCAN_SHAPE, torch.bfloat16, timing=peaks),
            "causal_conv1d_bwd": check_conv_bwd(
                dev, SCAN_SHAPE[:3], torch.bfloat16, False, timing=peaks)}
    cases = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dtype == torch.float32:
            cases["mamba_scan_bwd_train_f32"] = check_mamba_scan_bwd(
                dev, SCAN_SHAPE, dtype)
            cases["causal_conv1d_bwd_train_f32"] = check_conv_bwd(
                dev, SCAN_SHAPE[:3], dtype, False)
        cases[f"mamba_scan_bwd_ragged_{tag}"] = check_mamba_scan_bwd(
            dev, SCAN_RAGGED, dtype, h0=True)
        cases[f"mamba_scan_bwd_small_{tag}"] = check_mamba_scan_bwd(
            dev, (2, 37, 130, 8), dtype, h0=True)
        cases[f"causal_conv1d_bwd_ragged_{tag}"] = check_conv_bwd(
            dev, SCAN_RAGGED[:3], dtype, True)
        cases[f"causal_conv1d_bwd_small_{tag}"] = check_conv_bwd(
            dev, (2, 37, 130), dtype, True)
        for case, shape, offset in CONV_EDGES:
            cases[f"causal_conv1d_bwd_{case}_{tag}"] = check_conv_bwd(
                dev, shape, dtype, True, offset=offset)
    ins = [t.requires_grad_() for t in scan_inputs(dev, 1, 4, 64, 16)]
    try:
        ssm_scan.ssm_scan(*ins)
        refused = False
    except NotImplementedError:
        refused = True
    cases["ssm_scan_refuses_grad"] = dict(ok=refused, refused=refused)
    emit("kernels", shape="backward", train_shape=list(SCAN_SHAPE),
         results=dict(rows, **cases))
    return rows, cases


def phase_kernels(dev, folds, lams, peaks) -> dict:
    main = check_kernels(dev, H, BLOCK, K_FOLDS * G_SAMPLES,
                         K_FOLDS * LAM_CHUNK, torch.float64, folds, lams,
                         timing=peaks)
    emit("kernels", shape="main", h=H, block=BLOCK, dtype="float64",
         anchor_batch=K_FOLDS * G_SAMPLES, exact_batch=K_FOLDS * LAM_CHUNK,
         results=main)
    # the rows of the main path again at the tuner's block, when it picks
    # another than the main configuration's
    tuned = tuned_config(dev, folds, lams)
    if tuned.block != BLOCK:
        at_tuned = check_kernels(dev, H, tuned.block, K_FOLDS * G_SAMPLES,
                                 K_FOLDS * LAM_CHUNK, torch.float64, folds,
                                 lams, timing=peaks)
        emit("kernels", shape="tuned_block", h=H, block=tuned.block,
             dtype="float64", results=at_tuned)
        for name in TUNED_ROWS:
            main[name]["tuned_block"] = dict(
                block=tuned.block, **{key: at_tuned[name][key] for key in (
                    "ms", "bound_ms", "plain_ms", "library_ms",
                    "max_abs_err", "ok")})
        if not all(at_tuned[name]["ok"] for name in TUNED_ROWS):
            raise AssertionError(f"kernels at the tuned block {tuned.block} "
                                 "disagree with their plain versions")
    ragged = check_kernels(dev, 1000, BLOCK, 4, 3, torch.float64)
    emit("kernels", shape="ragged", h=1000, block=BLOCK, dtype="float64",
         results=ragged)
    odd = check_kernels(dev, 999, BLOCK, 4, 3, torch.float64)
    emit("kernels", shape="ragged_odd", h=999, block=BLOCK, dtype="float64",
         results=odd)
    f32 = check_kernels(dev, H, BLOCK, 4, 3, torch.float32)
    emit("kernels", shape="float32", h=H, block=BLOCK, dtype="float32",
         results=f32)
    chunk = bf16_chunk()
    mixed = check_mixed(dev, H, BLOCK, K_FOLDS * G_SAMPLES, K_FOLDS * chunk,
                        chunk, folds, lams, timing=peaks)
    emit("kernels", shape="mixed", h=H, block=BLOCK, dtype="float32",
         compute="bfloat16", anchor_batch=K_FOLDS * G_SAMPLES,
         exact_batch=K_FOLDS * chunk, lam_chunk=chunk, results=mixed)
    mixed_ragged = check_mixed(dev, 1000, BLOCK, 4, 3, 3)
    emit("kernels", shape="mixed_ragged", h=1000, block=BLOCK,
         dtype="float32", compute="bfloat16", results=mixed_ragged)
    mixed_odd = check_mixed(dev, 999, BLOCK, 4, 3, 3)
    emit("kernels", shape="mixed_ragged_odd", h=999, block=BLOCK,
         dtype="float32", compute="bfloat16", results=mixed_odd)
    # the mixed Cholesky's two designs at every block (ragged h)
    from repro_torch.kernels import _build
    designs = {f"cholesky_blocked_bf16_b{block}_n{batch}":
               check_chol_designs(dev, 1000, block, batch)
               for block in _build.BLOCKS for batch in (1, 20)}
    emit("kernels", shape="mixed_cholesky_blocks", h=1000,
         dtype="float32", compute="bfloat16", results=designs)
    scan = {"ssm_scan": check_ssm_scan(dev, SCAN_SHAPE, timing=peaks)}
    scan_ragged = {"ssm_scan": check_ssm_scan(dev, SCAN_RAGGED)}
    for tag, shape, res in (("ssm_scan", SCAN_SHAPE, scan),
                            ("ssm_scan_ragged", SCAN_RAGGED, scan_ragged)):
        emit("kernels", shape=tag, dtype="float32", fused_dtype="bfloat16",
             **dict(zip(("batch", "seq", "d_inner", "state"), shape)),
             results=res)
    # the decode step (S = 1 from a state), in the fused entry's both dtypes
    scan_decode = {f"mamba_scan_{tag}": check_mamba_scan(
        dev, SCAN_DECODE, dtype, h0=True)
        for tag, dtype in (("bf16", torch.bfloat16),
                           ("f32", torch.float32))}
    scan["ssm_scan"]["fused_err"] = dict(
        serve=scan["ssm_scan"]["fused_err"],
        ragged=scan_ragged["ssm_scan"]["fused_err"],
        decode=scan_decode["mamba_scan_bf16"]["err"])
    emit("kernels", shape="mamba_scan_decode", results=scan_decode)
    conv = {"causal_conv1d": check_conv(dev, SCAN_SHAPE[:3], torch.bfloat16,
                                        False, timing=peaks)}
    conv_cases = {f"causal_conv1d_{tag}": check_conv(dev, shape, dtype, state)
                  for tag, shape, dtype, state in (
                      ("ragged", SCAN_RAGGED[:3], torch.bfloat16, True),
                      ("decode", SCAN_DECODE[:3], torch.bfloat16, True),
                      ("short", (2, 2, 8192), torch.bfloat16, True),
                      ("ragged_f32", (2, 37, 130), torch.float32, True),
                      ("decode_f32", (2, 1, 8100), torch.float32, True))}
    for case, shape, offset in CONV_EDGES:
        for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            conv_cases[f"causal_conv1d_{case}_{tag}"] = check_conv(
                dev, shape, dtype, True, offset=offset)
    emit("kernels", shape="causal_conv1d", width=CONV_WIDTH,
         results=dict(conv, **conv_cases))
    bwd, bwd_cases = phase_kernels_bwd(dev, peaks)
    main.update(scan)
    main.update(conv)
    main.update(bwd)
    # the main path's shapes run the staged design
    bad = [("not_staged", name) for name, r in (
        ("causal_conv1d", conv["causal_conv1d"]),
        ("causal_conv1d_bwd", bwd["causal_conv1d_bwd"]),
        ("causal_conv1d_bwd_train_f32",
         bwd_cases["causal_conv1d_bwd_train_f32"]))
        if r["variant"] != "staged"]
    if mixed["cholesky_blocked_bf16"]["variant"] != "wgmma":
        bad.append(("not_wgmma", "cholesky_blocked_bf16"))
    bad += [(case, name) for case, res in
            (("main", main), ("ragged", ragged), ("ragged_odd", odd),
             ("float32", f32), ("mixed", mixed),
             ("mixed_ragged", mixed_ragged), ("mixed_ragged_odd", mixed_odd),
             ("mixed_cholesky_blocks", designs),
             ("ssm_scan_ragged", scan_ragged), ("mamba_scan", scan_decode),
             ("causal_conv1d", conv_cases), ("backward", bwd),
             ("backward_cases", bwd_cases))
            for name, r in res.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    main.update(mixed)
    return main


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def runners(dev, folds, lams) -> dict:
    """The two sweeps of the main path on one backend each."""
    from repro_torch.core import cv
    return {
        "picholesky": lambda backend: cv.cv_picholesky(
            folds, lams, g=G_SAMPLES, degree=DEGREE, block=BLOCK,
            backend=backend, device=dev),
        "exact": lambda backend: cv.cv_exact_cholesky(
            folds, lams, backend=backend, device=dev),
    }


def counted(run):
    """``run("cuda")`` with the launch counts set to 0 just before it;
    returns its result and the counts read just after it."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    res = run("cuda")
    torch.cuda.synchronize()
    return res, dict(LAUNCHES)


def phase_main(dev, folds, lams) -> dict:
    run = runners(dev, folds, lams)
    pi, exact = run["picholesky"], run["exact"]
    r_pi, n_pi = counted(pi)
    r_ex, n_ex = counted(exact)
    launches = dict(picholesky=n_pi, exact=n_ex)
    ref_pi, ref_ex = pi("reference"), exact("reference")
    out = dict(launches=launches, n_exact_chol=dict(
        picholesky=r_pi.n_exact_chol, exact=r_ex.n_exact_chol))
    for tag, r, rr in (("picholesky", r_pi, ref_pi), ("exact", r_ex, ref_ex)):
        if r.errors.shape != (N_LAMBDAS,) or not np.isfinite(r.errors).all():
            raise AssertionError(f"{tag}: curve is not {N_LAMBDAS} finite "
                                 "values")
        rel = float(np.max(np.abs(r.errors - rr.errors) / np.abs(rr.errors)))
        out[tag] = dict(argmin=int(np.argmin(r.errors)),
                        argmin_reference=int(np.argmin(rr.errors)),
                        best_lam=r.best_lam, curve_rel_err=rel,
                        tol=MAIN_TOL)
        if out[tag]["argmin"] != out[tag]["argmin_reference"] or rel > MAIN_TOL:
            raise AssertionError(f"{tag}: cuda backend disagrees with the "
                                 f"reference backend: {out[tag]}")
    if out["n_exact_chol"] != dict(picholesky=K_FOLDS * G_SAMPLES,
                                   exact=K_FOLDS * N_LAMBDAS):
        raise AssertionError(f"factorization budget {out['n_exact_chol']}")
    for tag, counts in launches.items():
        missing = [k for k in PATH_KERNELS[tag] if counts[k] == 0]
        stray = [k for k, n in counts.items()
                 if n and k not in PATH_KERNELS[tag]]
        if missing or stray:
            raise AssertionError(f"{tag} sweep: never launched {missing}, "
                                 f"launched {stray} it should not: {counts}")
    walls = {f"{tag}_{bk}": [] for tag in run for bk in ("cuda", "reference")}
    for _ in range(WALL_REPEATS):           # in turns, after the warm runs
        for key in walls:
            tag, bk = key.rsplit("_", 1)
            walls[key].append(_wall(lambda: run[tag](bk)))
    out["wall_s"] = walls
    med = {k: float(np.median(v)) for k, v in walls.items()}
    out["wall_s_median"] = med
    out["exact_over_picholesky_cuda"] = med["exact_cuda"] / \
        med["picholesky_cuda"]
    emit("main", h=H, n=N_TRAIN, k=K_FOLDS, q=N_LAMBDAS, g=G_SAMPLES,
         r=DEGREE, block=BLOCK, dtype="float64", **out)
    return launches


def host_drivers(folds, lams) -> dict:
    """The host-loop drivers at the main configuration, one backend each."""
    from repro_torch.core import cv_host
    return {
        "host_picholesky": lambda bk: cv_host.host_cv_picholesky(
            folds, lams, g=G_SAMPLES, degree=DEGREE, block=BLOCK, backend=bk),
        "host_exact": lambda bk: cv_host.host_cv_exact_cholesky(
            folds, lams, backend=bk),
        "host_pinrmse": lambda bk: cv_host.host_cv_pinrmse(
            folds, lams, g=G_SAMPLES, degree=DEGREE, backend=bk),
    }


def range_kernels(events, names: tuple) -> dict:
    """Device ms by kernel name of the kernels launched inside the CPU
    events named in ``names`` (a ``record_function`` range, an autograd
    node) and their children, one dict per name: each kernel counted once,
    under the outermost of those events it runs in (an event matching
    several names goes to the first)."""
    from torch.autograd import DeviceType
    out: dict = {n: {} for n in names}

    def match(e):
        return next((n for n in names if n in e.name), None)

    def walk(e, into: dict) -> None:
        for k in e.kernels:
            into[k.name[:80]] = into.get(k.name[:80], 0.0) + k.duration / 1e3
        for c in e.cpu_children:
            walk(c, into)

    for e in events:
        name = match(e) if e.device_type == DeviceType.CPU else None
        if name is None:
            continue
        parent = e.cpu_parent
        while parent is not None and match(parent) is None:
            parent = parent.cpu_parent
        if parent is None:
            walk(e, out[name])
    return out


def profiled(fn, ranges: tuple = (), split: bool = False
             ) -> tuple[dict, dict]:
    """One profiled call of ``fn`` (after a warm call): device busy time
    (union of kernel intervals), its share of the host wall time, and the
    kernels that take the most device time; also the device ms by kernel
    name.  With ``ranges``, the trace's ``ranges`` holds the device ms by
    kernel name of what ran inside them (:func:`range_kernels`); with
    ``split``, one such dict per range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    by_name: dict = {}
    for e in kern:
        rec = by_name.setdefault(e.name[:80], [0.0, 0])
        rec[0] += e.time_range.elapsed_us() / 1e3
        rec[1] += 1
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kern):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    tri_ops = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
                  and e.name in TRIANGULAR_SOLVE_OPS)
    conv_ops = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name in CONVOLUTION_OPS)
    trace = dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                 device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
                 n_kernels=len(kern), triangular_solve_ops=tri_ops,
                 convolution_ops=conv_ops,
                 top=[dict(name=n, ms=ms, count=c) for n, (ms, c) in top])
    if ranges:
        inside = range_kernels(prof.events(), ranges)
        merged: dict = {}
        for by_kernel in inside.values():
            for k, ms in by_kernel.items():
                merged[k] = merged.get(k, 0.0) + ms
        trace["ranges"] = inside if split else merged
    return trace, by_name


CHOL_KERNELS = ("diag_kernel", "panel_kernel", "syrk_kernel")


def chol_split(by_name: dict) -> dict:
    """Device ms and launches of the Cholesky's three kernels in a
    profile's by-name table (the diagonal step launches once per tile
    column)."""
    out = {}
    for k in CHOL_KERNELS:
        rows = [v for n, v in by_name.items() if k in n]
        ms, n = sum(r[0] for r in rows), sum(r[1] for r in rows)
        out[k] = dict(ms=ms, launches=n, ms_per_launch=ms / n if n else None)
    return out


SOLVE_KERNEL = "tri_solve_kernel"      # the one-dtype cluster solves' kernel
MIXED_SOLVE_KERNEL = "tri_solve_mixed_kernel"   # and the mixed variants'
# their Source template argument (csrc/tri_solve.cuh: kDense, kInterp,
# kPacked) → the wrapper
SOLVE_SOURCES = {"0": "solve_lower_blocked", "1": "interp_solve",
                 "2": "solve_lower_packed"}
# the library of each cluster-solve wrapper
SOLVE_LIBS = {"solve_lower_blocked": "trsm", "interp_solve": "poly_interp",
              "solve_lower_packed": "packed_trsm"}
# the design of the mixed cluster solves: each operand rounded to
# bf16 once where it is stored, A fragments by ldmatrix, a ring fed by the
# bulk-copy engine, two blocks an SM where the shared memory allows
MIXED_SOLVE_DESIGN = "stored_bf16"


def solve_kind(name: str) -> str | None:
    """Which wrapper a profiled kernel name belongs to: the cluster solve
    ``tri_solve_kernel<T, B, Source>`` instantiated for the dense trsm,
    ``interp_solve`` or the packed trsm (Source 0, 1, 2), or its mixed
    variant ``tri_solve_mixed_kernel<B, Source, Src>`` (with ``_bf16``)."""
    for kern, pos, suffix in ((MIXED_SOLVE_KERNEL, 1, "_bf16"),
                              (SOLVE_KERNEL, 2, "")):
        if kern in name:
            args = name.split(kern, 1)[1].split(">", 1)[0].lstrip("<")
            parts = [a.strip() for a in args.split(",")]
            return SOLVE_SOURCES[parts[pos]] + suffix
    return None


# the PyTorch calls that inverted diagonal tiles outside the kernels
# (``packing.invert_diag_tiles``)
CONVOLUTION_OPS = ("aten::convolution", "aten::_convolution",
                   "aten::cudnn_convolution", "aten::conv1d")
TRIANGULAR_SOLVE_OPS = ("aten::linalg_solve_triangular",
                        "aten::triangular_solve")


def is_library_trsm(name: str) -> bool:
    """A cuBLAS/cuSOLVER triangular solve (of a ``torch.linalg`` call), not
    one of the port's kernels."""
    return "trsm" in name.lower() and solve_kind(name) is None


def cluster_split(name: str, fn, ms: float) -> dict:
    """One profiled call of a cluster-solve wrapper: its kernel's device
    time, the rest of the call's device time, the time outside the kernel
    (wrapper ms − kernel ms), the launch plan and the kernel's ptxas
    lines at B = 128."""
    from repro_torch.kernels import _build
    _, by_name = profiled(fn)
    kern = sum(v[0] for n, v in by_name.items() if solve_kind(n) == name)
    n_kern = sum(v[1] for n, v in by_name.items() if solve_kind(n) == name)
    other = sum(v[0] for n, v in by_name.items() if solve_kind(n) != name)
    mixed = name.endswith("_bf16")
    lib = SOLVE_LIBS[name[:-len("_bf16")] if mixed else name]
    log = _build._target(lib).with_suffix(".log")
    kernel = MIXED_SOLVE_KERNEL if mixed else SOLVE_KERNEL
    ptx = [f"{r['kernel']}: {r.get('used', '')}; {r.get('spills', '')}"
           for r in (ptxas_lines(log.read_text()) if log.exists() else [])
           if kernel in r["kernel"] and "Li128E" in r["kernel"]]
    out = dict(kernel_ms=kern / max(n_kern, 1), kernel_launches=n_kern,
               other_device_ms=other, outside_kernel_ms=ms - kern,
               plan=dict(_build.PLANS.get(name, {})), ptxas=ptx)
    if mixed:       # the design that ran, from the profiled kernels' names
        out["design"] = MIXED_SOLVE_DESIGN if any(
            MIXED_SOLVE_KERNEL in n for n in by_name) else "unknown"
    return out


# the factor routes the trace phase profiles (and holds to no library trsm)
TRACED_ROUTES = ("packed", "packed_bf16_store", "eval_factor_bf16_store")


def phase_trace(dev, folds, lams) -> None:
    """One profiled run of each sweep, each host driver and each factor
    route on the cuda backend (after a warm run), with the Cholesky's
    kernels and the cluster solves split out."""
    routes = factor_routes(dev, folds, lams)
    paths = {**runners(dev, folds, lams), **host_drivers(folds, lams),
             **{tag: routes[tag] for tag in TRACED_ROUTES}}
    del routes
    out = {}
    for tag, run in paths.items():
        trace, by_name = profiled(lambda: run("cuda"))
        solves = {}
        for n, (ms, c) in by_name.items():
            k = solve_kind(n)
            if k:
                rec = solves.setdefault(k, dict(ms=0.0, launches=0))
                rec["ms"] += ms
                rec["launches"] += c
        lib_trsm = {n: v for n, v in by_name.items() if is_library_trsm(n)}
        out[tag] = dict(trace, cholesky=chol_split(by_name),
                        cluster_solves=solves, library_trsm=lib_trsm)
    emit("trace", **out)
    bad = {tag: dict(calls=out[tag]["triangular_solve_ops"],
                     kernels=out[tag]["library_trsm"])
           for tag in (*runners(dev, folds, lams), *TRACED_ROUTES)
           if out[tag]["triangular_solve_ops"] or out[tag]["library_trsm"]}
    if bad:
        raise AssertionError(f"a library triangular solve ran on the main "
                             f"path or a factor route: {bad}")


def chol_launches(h: int, block: int) -> int:
    """CUDA launches of one ``cholesky_blocked`` call: 3·nt − 2."""
    from repro_torch.core import packing
    return 3 * packing.num_tiles(h, block) - 2


def check_counts(tag: str, counts: dict, expected: dict) -> None:
    """Every kernel launched exactly as predicted, and no other."""
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, predicted {want}")


def curve_check(tag: str, got, want, other: str) -> dict:
    """Same λ* index and curves within MAIN_TOL relative."""
    if got.errors.shape != (N_LAMBDAS,) or not np.isfinite(got.errors).all():
        raise AssertionError(f"{tag}: curve is not {N_LAMBDAS} finite values")
    rel = float(np.max(np.abs(got.errors - want.errors)
                       / np.abs(want.errors)))
    out = dict(argmin=int(np.argmin(got.errors)),
               argmin_other=int(np.argmin(want.errors)), other=other,
               curve_rel_err=rel, tol=MAIN_TOL)
    if out["argmin"] != out["argmin_other"] or rel > MAIN_TOL:
        raise AssertionError(f"{tag} disagrees with {other}: {out}")
    return out


def phase_host(dev, folds, lams) -> dict:
    """The host-loop drivers (one fold at a time, dense interpolated
    factors) on the cuda backend, each against itself on the reference
    backend and, for picholesky and exact, against the engine on cuda."""
    from repro_torch.core import backends
    chol = chol_launches(H, backends.CudaBackend().chol_block)
    drivers = host_drivers(folds, lams)
    # predicted from the loop structure: per fold one Cholesky call (the g
    # anchors, or the q shifts), one pack, one interp_factors, two trsm
    exact_counts = dict(cholesky_blocked=K_FOLDS * chol,
                        solve_lower_blocked=2 * K_FOLDS)
    expected = {
        "host_picholesky": dict(exact_counts, pack_tril=K_FOLDS,
                                interp_factors=K_FOLDS),
        "host_exact": exact_counts,
        "host_pinrmse": exact_counts,
    }
    engine = runners(dev, folds, lams)
    engine_of = {"host_picholesky": "picholesky", "host_exact": "exact"}
    launches, out = {}, {}
    for tag, run in drivers.items():
        res, counts = counted(run)
        check_counts(tag, counts, expected[tag])
        launches[tag] = counts
        out[tag] = dict(best_lam=res.best_lam,
                        reference=curve_check(tag, res, run("reference"),
                                              "reference backend"))
        if tag in engine_of:
            out[tag]["engine"] = curve_check(
                tag, res, engine[engine_of[tag]]("cuda"), "engine on cuda")
    walls = {key: [] for key in ("host_picholesky", "engine_picholesky",
                                 "host_exact", "engine_exact")}
    for _ in range(HOST_REPEATS):               # in turns
        for key in walls:
            kind, tag = key.split("_", 1)
            fn = drivers[key] if kind == "host" else engine[tag]
            walls[key].append(_wall(lambda: fn("cuda")))
    emit("host", h=H, k=K_FOLDS, q=N_LAMBDAS, g=G_SAMPLES, r=DEGREE,
         block=BLOCK, dtype="float64", launches=launches,
         launches_predicted=expected, **out, wall_s=walls,
         wall_s_median={k: float(np.median(v)) for k, v in walls.items()})
    return launches


def factor_routes(dev, folds, lams) -> dict:
    """The factor routes beside the engine at the main configuration, each
    a function of a backend name (and, for the bf16 ones, optionally a
    fitted model).  ``packed`` (float64): the packed anchors (factored and
    packed on the cuda backend, Θ fitted from them once) brought back dense
    by unpack, and per fold the interpolated factors at the whole grid kept
    packed and solved by ``solvers.solve_packed``.  Under ``bf16_store``:
    ``packed_bf16_store``, ``picholesky.fit`` under the policy (the mixed
    Cholesky, pack, Θ stored in bf16), then the packed route of its bf16
    factors; ``eval_factor_bf16_store``, the dense route of such a Θ:
    ``eval_factor`` of every fold at the whole grid (bf16 factors), then
    ``solvers.solve_from_factor``.  Also the float64 model and the bf16
    model fitted on the cuda backend, for the comparisons."""
    import dataclasses
    from repro_torch.core import backends, packing, picholesky, solvers
    bk = backends.CudaBackend()
    h_tr = folds.hess[None] - folds.fold_hess
    g_tr = folds.grad[None] - folds.fold_grad
    sample = picholesky.choose_sample_lambdas(
        float(lams[0]), float(lams[-1]), G_SAMPLES, device=dev)
    eye = torch.eye(H, dtype=torch.float64, device=dev)
    anchors = bk.cholesky(h_tr[:, None] + sample[:, None, None] * eye)
    packed_anchors = bk.pack_tril(anchors, BLOCK)
    model = picholesky.fit(None, sample, DEGREE, block=BLOCK, backend=bk,
                           factors=packing.PackedFactor(packed_anchors, H,
                                                        BLOCK))

    def policy(backend, name):
        return backends.resolve_backend(backend, precision=name)

    def solve_packed(m, backend):
        return torch.stack([
            solvers.solve_packed(dataclasses.replace(
                m, theta=m.theta[f]).eval_packed_factor(lams), g_tr[f],
                backend=backend) for f in range(K_FOLDS)])

    def packed(backend):
        dense = backends.resolve_backend(backend).unpack_tril(
            packed_anchors, H, BLOCK)
        return dense, solve_packed(model, backend)

    def fit16(backend):
        return picholesky.fit(h_tr, sample, DEGREE, block=BLOCK,
                              backend=policy(backend, "bf16_store"))

    def packed16(backend, m=None):
        m = fit16(backend) if m is None else m
        return m, solve_packed(m, policy(backend, "bf16_store"))

    model16 = fit16("cuda")

    def dense16(backend, m=model16):
        bk16 = policy(backend, "bf16_store")
        l = m.eval_factor(lams, backend=bk16)            # (k, q, h, h) bf16
        return solvers.solve_from_factor(
            l, g_tr[:, None].expand(-1, lams.numel(), -1), bk16)

    return dict(packed=packed, packed_bf16_store=packed16,
                eval_factor_bf16_store=dense16, model=model, model16=model16,
                anchors=anchors, g_tr=g_tr)


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over systems of ‖got − want‖ / ‖want‖ (the last dim a system),
    failing on a non-finite value."""
    if not torch.isfinite(got).all():
        raise AssertionError("output is not finite")
    return float(((got.double() - want.double()).norm(dim=-1)
                  / want.double().norm(dim=-1)).max())


def phase_packed(dev, folds, lams) -> dict:
    """The factor routes (``factor_routes``): the float64 packed route
    (unpack exact; the packed solves against the fused interp_solve and
    the reference backend), and under ``bf16_store`` the packed route (the
    fit included) and the dense route of the fitted bf16 Θ, each counted
    and held against the reference backend under the same policy on the
    same Θ; wall times of each route on the cuda backend."""
    from repro_torch.core import backends
    routes = factor_routes(dev, folds, lams)
    model, model16, g_tr = routes["model"], routes["model16"], routes["g_tr"]
    chol = chol_launches(H, backends.CudaBackend().chol_block)
    (dense, got), counts = counted(routes["packed"])
    check_counts("packed", counts, dict(unpack_tril=1,
                                        solve_lower_packed=K_FOLDS))
    if not torch.equal(dense, routes["anchors"]):
        raise AssertionError("packed: unpack(pack(L)) differs from L")
    fused = model.solve(lams, g_tr, backend="cuda")
    plain = routes["packed"]("reference")[1]
    out = {}
    for other, want in (("interp_solve", fused), ("reference", plain)):
        err = errors(got, want)
        out[other] = dict(max_abs_err=err[0], max_rel_err=err[1],
                          tol=PACKED_TOL)
        if err[1] > PACKED_TOL:
            raise AssertionError(f"packed route vs {other}: {out[other]}")
    launches = {"packed": counts}
    # bf16_store: the packed route with its fit, then the dense route of
    # the cuda-fitted Θ; each against the reference backend on the same Θ
    (m16, got16), launches["packed_bf16_store"] = counted(
        routes["packed_bf16_store"])
    check_counts("packed_bf16_store", launches["packed_bf16_store"], dict(
        cholesky_blocked_bf16=chol, pack_tril=1,
        solve_lower_packed_bf16=K_FOLDS))
    dense16, launches["eval_factor_bf16_store"] = counted(
        routes["eval_factor_bf16_store"])
    check_counts("eval_factor_bf16_store",
                 launches["eval_factor_bf16_store"],
                 dict(interp_factors_bf16=1, solve_lower_blocked_bf16=2))
    if m16.theta.dtype != torch.bfloat16 or got16.dtype != torch.float32:
        raise AssertionError(f"packed_bf16_store: Θ {m16.theta.dtype}, "
                             f"solutions {got16.dtype}")
    same16 = routes["packed_bf16_store"]("cuda", model16)[1]
    bf16 = dict(
        packed_vs_reference=norm_err(
            got16, routes["packed_bf16_store"]("reference", m16)[1]),
        eval_factor_vs_reference=norm_err(
            dense16, routes["eval_factor_bf16_store"]("reference")),
        eval_factor_vs_packed=norm_err(dense16, same16),
        fused_vs_packed=norm_err(
            model16.solve(lams, g_tr, backend=backends.resolve_backend(
                "cuda", precision="bf16_store")), same16),
        fit_on_reference_vs_cuda=norm_err(
            routes["packed_bf16_store"]("reference")[1], got16),
        packed_vs_float64=norm_err(got16, got), tol=BF16_ROUTE_TOL,
        held=("packed_vs_reference", "eval_factor_vs_reference"))
    out["bf16_store"] = bf16
    bad = {k: bf16[k] for k in bf16["held"] if not bf16[k] <= BF16_ROUTE_TOL}
    bk16 = backends.resolve_backend("cuda", precision="bf16_store")
    ms = dict(packed=timed_ms(lambda: routes["packed"]("cuda"), 3),
              interp_solve=timed_ms(
                  lambda: model.solve(lams, g_tr, backend="cuda"), 3),
              packed_bf16_store_solves=timed_ms(
                  lambda: routes["packed_bf16_store"]("cuda", model16), 3),
              eval_factor_bf16_store=timed_ms(
                  lambda: routes["eval_factor_bf16_store"]("cuda"), 3),
              interp_solve_bf16_store=timed_ms(
                  lambda: model16.solve(lams, g_tr, backend=bk16), 3))
    emit("packed", h=H, k=K_FOLDS, q=N_LAMBDAS, block=BLOCK,
         dtype="float64", launches=launches, unpack_roundtrip_exact=True,
         **out, ms=ms)
    if bad:
        raise AssertionError(f"packed bf16_store routes disagree with the "
                             f"reference backend: {bad}")
    return launches


def phase_gauss_newton(dev, folds) -> dict:
    """The damped Gauss–Newton head on the full Hessian: steps at λs inside
    the fitted range and one far outside, on cuda against reference and
    against a dense solve of (H + λI) δ = grad."""
    from repro_torch.core import backends
    from repro_torch.optim import damped_gauss_newton_head
    lam_range, g_samples = (1e-4, 10.0), 6
    steps = [*np.logspace(-3.5, 0.5, 5), 1e3]

    def run(backend):
        state, step = damped_gauss_newton_head(
            folds.hess, lam_range, g_samples=g_samples, degree=DEGREE,
            block=BLOCK, backend=backend)
        deltas, used = [], []
        for lam in steps:
            delta, state = step(state, folds.grad, float(lam))
            deltas.append(delta)
            used.append(float(state.lam))
        return deltas, used

    (deltas, used), counts = counted(run)
    check_counts("gauss_newton", counts, dict(
        cholesky_blocked=chol_launches(H, backends.CudaBackend().chol_block),
        pack_tril=1, interp_factors=len(steps),
        solve_lower_blocked=2 * len(steps)))
    ref_deltas, ref_used = run("reference")
    eye = torch.eye(H, dtype=torch.float64, device=dev)
    rows = []
    for lam, d, r, lam_used in zip(steps, deltas, ref_deltas, used):
        exact = torch.linalg.solve(folds.hess + lam_used * eye, folds.grad)
        rows.append(dict(
            lam=float(lam), lam_used=lam_used,
            rel_vs_reference=float((d - r).norm() / r.norm()),
            rel_vs_dense_solve=float((d - exact).norm() / exact.norm())))
    bad = [r for r in rows if r["rel_vs_reference"] > MAIN_TOL
           or r["rel_vs_dense_solve"] > GN_TOL
           or not lam_range[0] <= r["lam_used"] <= lam_range[1]]
    if bad or used != ref_used or used[-1] != lam_range[1]:
        raise AssertionError(f"gauss_newton: {bad or used}")
    emit("gauss_newton", h=H, lam_range=lam_range, g_samples=g_samples,
         r=DEGREE, block=BLOCK, dtype="float64", launches=counts,
         steps=rows, tol=dict(vs_reference=MAIN_TOL, vs_dense_solve=GN_TOL))
    return counts


def phase_table4(dev) -> None:
    from repro_torch.core import cv
    data = np.load(ROOT / "tests" / "data" / "torch_table4.npz")
    folds = cv.make_folds(data["x"], data["y"], int(data["k"]), device=dev)
    lams = torch.as_tensor(data["lams"], device=dev)
    r_pi = cv.cv_picholesky(folds, lams, g=int(data["g"]),
                            block=int(data["block"]), backend="cuda",
                            device=dev)
    r_ex = cv.cv_exact_cholesky(folds, lams, backend="cuda", device=dev)
    out = {}
    for tag, r in (("picholesky", r_pi), ("exact", r_ex)):
        ref_err = data[f"errors_{tag}"]
        out[tag] = dict(
            argmin=int(np.argmin(r.errors)), argmin_jax=int(data[f"i_{tag}"]),
            curve_rel_err=float(np.max(np.abs(r.errors - ref_err)
                                       / np.abs(ref_err))), tol=TABLE4_TOL)
        if out[tag]["argmin"] != out[tag]["argmin_jax"]:
            raise AssertionError(f"table4 {tag}: λ* index differs from the "
                                 f"JAX reference: {out[tag]}")
        if out[tag]["curve_rel_err"] > TABLE4_TOL:
            raise AssertionError(f"table4 {tag}: curve differs from the JAX "
                                 f"reference by more than {TABLE4_TOL}: "
                                 f"{out[tag]}")
    emit("table4", **out)


def is_library_factorization(name: str) -> bool:
    """A cuSOLVER Cholesky kernel (of a ``torch.linalg.cholesky`` call)."""
    return "potrf" in name.lower()


def phase_precision(dev, folds, lams) -> dict:
    """The bf16 policies on the main path at full width (the main
    configuration, float64 data): the sweeps of POLICY_RUNS on the cuda
    backend, each counted, held to ``fp32``, timed in turns and traced;
    then the Table-4 fixture under ``bf16_refined`` against ``fp32``."""
    from repro_torch.core import cv, engine, packing
    from repro_torch.core.precision import resolve_precision
    from repro_torch.kernels import MIXED_NAMES

    def sweep(strategy, policy, folds=folds, lams=lams, g=G_SAMPLES,
              block=BLOCK):
        if strategy == "exact":
            return lambda bk: cv.cv_exact_cholesky(
                folds, lams, backend=bk, precision=policy, device=dev)
        return lambda bk: cv.cv_picholesky(
            folds, lams, g=g, degree=DEGREE, block=block, backend=bk,
            precision=policy, device=dev)

    def predicted(strategy, policy) -> dict:
        """Launches from the engine's chunking: one Cholesky call per
        chunk (exact) or one for the anchors (picholesky), one pack, one
        interp_solve per chunk and refinement, two trsm per chunk."""
        pol = resolve_precision(policy)
        mixed = pol.compute_dtype(torch.float64) != pol.accum_dtype(
            torch.float64)
        name = {k: MIXED_NAMES[k] if mixed else k for k in MIXED_NAMES}
        chunk = engine.auto_lam_chunk(H, BLOCK, pol.store_dtype(
            torch.float64), engine.LAM_CHUNK_BUDGET_BYTES)
        n_chunks = -(-N_LAMBDAS // chunk)
        chol = chol_launches(H, BLOCK)
        if strategy == "exact":
            return {name["cholesky_blocked"]: n_chunks * chol,
                    name["solve_lower_blocked"]: 2 * n_chunks}
        return {name["cholesky_blocked"]: chol, "pack_tril": 1,
                name["interp_solve"]: n_chunks * (1 + pol.refine_iters)}

    runs = {f"{st}_{pol}": sweep(st, pol) for st, pol in POLICY_RUNS}
    results, launches, out = {}, {}, {}
    for (st, pol), (tag, run) in zip(POLICY_RUNS, runs.items()):
        results[tag], launches[tag] = counted(run)
        check_counts(f"precision {tag}", launches[tag], predicted(st, pol))
        r = results[tag]
        if r.errors.shape != (N_LAMBDAS,) or not np.isfinite(r.errors).all():
            raise AssertionError(f"precision {tag}: curve is not {N_LAMBDAS} "
                                 "finite values")
        if r.extras["engine"]["precision"] != pol:
            raise AssertionError(f"precision {tag}: engine reports "
                                 f"{r.extras['engine']['precision']}")
    base = results["picholesky_fp32"].errors
    for tag, r in results.items():
        d = np.abs(r.errors - base)
        out[tag] = dict(argmin=int(np.argmin(r.errors)),
                        best_lam=r.best_lam, max_abs_dev_vs_fp32=float(d.max()),
                        within_fp32_bound=bool(np.all(
                            d <= PRECISION_ATOL + PRECISION_RTOL
                            * np.abs(base))))
    ref, store = out["picholesky_bf16_refined"], out["picholesky_bf16_store"]
    checks = dict(
        refined_argmin_is_fp32=ref["argmin"] == out["picholesky_fp32"][
            "argmin"],
        refined_within_bound=ref["within_fp32_bound"],
        refined_closer_than_store=ref["max_abs_dev_vs_fp32"]
        < store["max_abs_dev_vs_fp32"])
    walls = {tag: [] for tag in runs}
    for _ in range(WALL_REPEATS):           # in turns, after the warm runs
        for tag, run in runs.items():
            walls[tag].append(_wall(lambda: run("cuda")))
    traces = {}
    for tag in ("picholesky_bf16_store", "picholesky_bf16_refined",
                "exact_bf16_store"):
        trace, by_name = profiled(lambda: runs[tag]("cuda"))
        solves = {}
        for n, (ms, c) in by_name.items():
            k = solve_kind(n)
            if k:
                rec = solves.setdefault(k, dict(ms=0.0, launches=0))
                rec["ms"] += ms
                rec["launches"] += c
        traces[tag] = dict(
            trace, cholesky=chol_split(by_name), cluster_solves=solves,
            gemm={n: v for n, v in by_name.items() if gemm_like(n)},
            library_trsm={n: v for n, v in by_name.items()
                          if is_library_trsm(n)},
            library_cholesky={n: v for n, v in by_name.items()
                              if is_library_factorization(n)})
    # the Table-4 fixture (h=144, block=32) under bf16_refined against fp32
    data = np.load(ROOT / "tests" / "data" / "torch_table4.npz")
    t4_folds = cv.make_folds(data["x"], data["y"], int(data["k"]), device=dev)
    t4_lams = torch.as_tensor(data["lams"], device=dev)
    t4 = {pol: sweep("picholesky", pol, t4_folds, t4_lams, int(data["g"]),
                     int(data["block"]))("cuda")
          for pol in ("fp32", "bf16_refined")}
    table4 = dict(argmin_fp32=int(np.argmin(t4["fp32"].errors)),
                  argmin_bf16_refined=int(np.argmin(
                      t4["bf16_refined"].errors)),
                  max_abs_dev=float(np.max(np.abs(
                      t4["bf16_refined"].errors - t4["fp32"].errors))))
    table4["same_lam_star"] = table4["argmin_fp32"] == table4[
        "argmin_bf16_refined"]
    emit("precision", h=H, n=N_TRAIN, k=K_FOLDS, q=N_LAMBDAS, g=G_SAMPLES,
         r=DEGREE, block=BLOCK, data_dtype="float64",
         lam_chunk={tag: engine.auto_lam_chunk(
             H, BLOCK, resolve_precision(pol).store_dtype(
                 torch.float64), engine.LAM_CHUNK_BUDGET_BYTES)
             for (_, pol), tag in zip(POLICY_RUNS, runs)},
         theta_bytes={pol: packing.packed_nbytes(
                          H, BLOCK, resolve_precision(pol).store_dtype(
                              torch.float64))
                      * (DEGREE + 1) * K_FOLDS
                      for pol in ("fp32", "bf16_store")},
         launches=launches, curves=out, checks=checks,
         bound=dict(rtol=PRECISION_RTOL, atol=PRECISION_ATOL),
         wall_s=walls, wall_s_median={k: float(np.median(v))
                                      for k, v in walls.items()},
         trace=traces, table4_bf16_refined=table4)
    if not all(checks.values()):
        raise AssertionError(f"precision: {checks}: {out}")
    lib = {tag: (t["library_trsm"], t["library_cholesky"])
           for tag, t in traces.items()
           if t["library_trsm"] or t["library_cholesky"]}
    if lib:
        raise AssertionError(f"precision: a library trsm or Cholesky ran on "
                             f"a bf16 sweep: {lib}")
    return launches


# the baselines phase: the paper's other CV algorithms (Table 3)
WARM_G_REST = 2            # picholesky_warmstart: g_first = G_SAMPLES
# warm-start curve on cuda vs reference: the CPU test's bound for g_rest 2
# (tests/test_torch_strategies.py WARM_RTOL, where the reason is given)
WARM_TOL = 1e-9
# MChol: the log10 midpoint of [LAM_LO, LAM_HI], and configs/picholesky.py
# mchol_s, mchol_s0 of the JAX package
MCHOL_C, MCHOL_S, MCHOL_S0 = -1.5, 1.5, 0.0025
K_TRUNC = H // 4           # t-SVD and r-SVD rank
LOW_RANK = (512, 1024, 64)  # make_low_rank_dataset (n, h, rank)
SELECT_TOL = 1e-9          # select_interpolant scores, relative
BASELINE_REPEATS = 3       # timed runs per algorithm, in turns
# the kernels each new path launches (and no other)
BASELINE_KERNELS = {
    "picholesky_warmstart": ("cholesky_blocked", "pack_tril",
                             "interp_solve"),
    "pinrmse": ("cholesky_blocked", "solve_lower_blocked"),
    "mchol": ("cholesky_blocked", "solve_lower_blocked"),
    "svd": (), "tsvd": (), "rsvd": (), "low_rank": (),
    "select_interpolant": ("cholesky_blocked", "pack_tril"),
    "ridge_cv": ("cholesky_blocked", "pack_tril", "interp_solve",
                 "solve_lower_blocked"),
}


def first_divergence(a: list, b: list):
    """(index, a_i, b_i) of the first place two visit lists part, or
    None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    return None if len(a) == len(b) else (min(len(a), len(b)), None, None)


def phase_baselines(dev, folds, lams) -> dict:
    """The paper's other CV algorithms at the main configuration (Table 3
    and §7): warm-start, PINRMSE and MChol on the cuda backend against the
    reference backend, each counted; the SVD family against the exact
    engine; low rank on a planted low-rank dataset; ``select_interpolant``
    on the card's packed anchors; ``RidgeCV``; ``CountingBackend`` stage
    counts; one profiled run each of warm-start, PINRMSE, MChol and
    ``RidgeCV.fit_theta`` (no library Cholesky or triangular solve may
    run); wall medians of every algorithm, in turns.  Failures go into
    FAILED."""
    from repro_torch.core import backends, cv, engine, picholesky
    from repro_torch.core.ridge_cv import RidgeCV
    from repro_torch.data import make_low_rank_dataset, \
        make_regression_dataset

    def fail(msg: str) -> None:
        FAILED.append(f"baselines: {msg}")

    chol = chol_launches(H, BLOCK)
    n_chunks = -(-N_LAMBDAS // engine.auto_lam_chunk(
        H, BLOCK, torch.float64, engine.LAM_CHUNK_BUDGET_BYTES))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    omega = torch.randn(H, K_TRUNC + 10, generator=gen, dtype=torch.float64,
                        device=dev)
    x_lr, y_lr = make_low_rank_dataset(*LOW_RANK, seed=SEED,
                                       dtype=torch.float64, device=dev)
    lr_folds = cv.make_folds(x_lr, y_lr, K_FOLDS, device=dev)
    runs = {
        "chol": lambda bk: cv.cv_exact_cholesky(folds, lams, backend=bk,
                                                device=dev),
        "pichol": lambda bk: cv.cv_picholesky(
            folds, lams, g=G_SAMPLES, degree=DEGREE, block=BLOCK,
            backend=bk, device=dev),
        "picholesky_warmstart": lambda bk: cv.cv_picholesky_warmstart(
            folds, lams, g_first=G_SAMPLES, g_rest=WARM_G_REST,
            degree=DEGREE, block=BLOCK, backend=bk, device=dev),
        "pinrmse": lambda bk: cv.cv_pinrmse(
            folds, lams, g=G_SAMPLES, degree=DEGREE, backend=bk,
            device=dev),
        "mchol": lambda bk: cv.cv_multilevel_cholesky(
            folds, MCHOL_C, MCHOL_S, MCHOL_S0, backend=bk, device=dev),
        "svd": lambda bk: cv.cv_svd(folds, lams, "full", backend=bk,
                                    device=dev),
        "tsvd": lambda bk: cv.cv_svd(folds, lams, "truncated", K_TRUNC,
                                     backend=bk, device=dev),
        "rsvd": lambda bk: cv.cv_svd(folds, lams, "randomized", K_TRUNC,
                                     omega, backend=bk, device=dev),
        "low_rank": lambda bk: engine.CVEngine(
            "low_rank", backend=bk, device=dev).run(lr_folds, lams),
        "low_rank_exact": lambda bk: cv.cv_exact_cholesky(
            lr_folds, lams, backend=bk, device=dev),
    }
    out, launches, results = {}, {}, {}
    first_s = {}
    for tag in ("picholesky_warmstart", "pinrmse", "mchol", "svd", "tsvd",
                "rsvd", "low_rank"):
        t0 = time.perf_counter()
        results[tag], launches[tag] = counted(runs[tag])
        first_s[tag] = time.perf_counter() - t0
        stray = [k for k, n in launches[tag].items()
                 if n and k not in BASELINE_KERNELS[tag]]
        missing = [k for k in BASELINE_KERNELS[tag]
                   if launches[tag][k] == 0]
        if stray or missing:
            fail(f"{tag}: never launched {missing}, launched {stray} it "
                 f"should not: {launches[tag]}")
    out["first_run_s"] = first_s
    exact = runs["chol"]("cuda")

    def curve(tag, got, want, tol, other):
        rel = float(np.max(np.abs(got.errors - want.errors)
                           / np.abs(want.errors)))
        rec = dict(best_lam=got.best_lam, best_lam_other=want.best_lam,
                   argmin=int(np.argmin(got.errors)), other=other,
                   curve_rel_err=rel, tol=tol,
                   n_exact_chol=got.n_exact_chol)
        if not np.isfinite(got.errors).all() or rel > tol \
                or got.best_lam != want.best_lam:
            fail(f"{tag} disagrees with {other}: {rec}")
        return rec

    # warm-start and PINRMSE: cuda against reference on the card
    warm = results["picholesky_warmstart"]
    out["picholesky_warmstart"] = curve(
        "picholesky_warmstart", warm, runs["picholesky_warmstart"](
            "reference"), WARM_TOL, "reference backend")
    want_warm = dict(cholesky_blocked=2 * chol, pack_tril=2,
                     interp_solve=n_chunks)
    if warm.n_exact_chol != G_SAMPLES + K_FOLDS * WARM_G_REST:
        fail(f"picholesky_warmstart n_exact_chol {warm.n_exact_chol}")
    out["pinrmse"] = curve("pinrmse", results["pinrmse"],
                           runs["pinrmse"]("reference"), MAIN_TOL,
                           "reference backend")
    # MChol: the same search as the reference backend's
    mc, mc_ref = results["mchol"], runs["mchol"]("reference")
    visited, visited_ref = (r.extras["visited_lams"] for r in (mc, mc_ref))
    levels = int(np.ceil(np.log2(MCHOL_S / MCHOL_S0)))
    out["mchol"] = dict(
        c=MCHOL_C, s=MCHOL_S, s0=MCHOL_S0, levels=levels,
        evaluations=len(visited), n_chol=mc.n_exact_chol,
        n_chol_reference=mc_ref.n_exact_chol, best_lam=mc.best_lam,
        best_lam_reference=mc_ref.best_lam, visited_lams=visited,
        first_divergence=first_divergence(visited, visited_ref),
        max_rel_err=float(np.max(np.abs(mc.errors - mc_ref.errors)
                                 / np.abs(mc_ref.errors)))
        if mc.errors.shape == mc_ref.errors.shape else None)
    if visited != visited_ref or mc.best_lam != mc_ref.best_lam \
            or mc.n_exact_chol != mc_ref.n_exact_chol:
        fail(f"mchol: the search on cuda parts from the reference "
             f"backend's: {out['mchol']}")
    if not 3 + 2 * (levels - 1) <= len(visited) <= 3 * levels:
        fail(f"mchol: {len(visited)} evaluations over {levels} levels")
    expected = {
        "picholesky_warmstart": want_warm,
        "pinrmse": dict(cholesky_blocked=chol, solve_lower_blocked=2),
        "mchol": dict(cholesky_blocked=len(visited) * chol,
                      solve_lower_blocked=2 * len(visited)),
        "svd": {}, "tsvd": {}, "rsvd": {}, "low_rank": {},
    }
    for tag, want in expected.items():
        if launches[tag] != {k: want.get(k, 0) for k in launches[tag]}:
            fail(f"{tag}: launches {launches[tag]}, predicted {want}")
    # the SVD family: full is the exact ridge path by another route
    out["svd"] = curve("svd", results["svd"], exact, MAIN_TOL,
                       "exact engine on cuda")
    full = results["svd"].errors
    for tag in ("tsvd", "rsvd"):
        r = results[tag]
        out[tag] = dict(k_trunc=K_TRUNC, best_lam=r.best_lam,
                        argmin=int(np.argmin(r.errors)),
                        max_rel_gap_to_full=float(np.max(
                            np.abs(r.errors - full) / np.abs(full))))
        if not np.isfinite(r.errors).all():
            fail(f"{tag}: curve is not finite")
    # low rank: rank None is the exact path on its dataset; rank 64 printed
    lr_exact = runs["low_rank_exact"]("cuda")
    out["low_rank"] = curve("low_rank", results["low_rank"], lr_exact,
                            MAIN_TOL, "exact engine on cuda, same folds")
    lr64 = engine.CVEngine(engine.make_strategy("low_rank",
                                                rank=LOW_RANK[2]),
                           device=dev).run(lr_folds, lams)
    out["low_rank_r64"] = dict(
        best_lam=lr64.best_lam, argmin=int(np.argmin(lr64.errors)),
        max_rel_gap_to_exact=float(np.max(np.abs(lr64.errors
                                                 - lr_exact.errors)
                                          / np.abs(lr_exact.errors))))
    out["low_rank_dataset"] = dict(zip(("n", "h", "rank"), LOW_RANK))
    # select_interpolant on the main configuration's packed anchors
    sample = picholesky.choose_sample_lambdas(lams[0], lams[-1], G_SAMPLES,
                                              device=dev)

    def anchors(bk_name):
        bk = backends.resolve_backend(bk_name, block=BLOCK, device=dev)
        eye = torch.eye(H, dtype=torch.float64, device=dev)
        h_tr = folds.hess[None] - folds.fold_hess
        return bk.pack_tril(bk.cholesky(h_tr[:, None] + sample[:, None, None]
                                        * eye), BLOCK)

    def select(bk_name, targets=None):
        t = anchors(bk_name) if targets is None else targets
        return picholesky.select_interpolant(t, sample, backend=bk_name), t

    (sel, targets), launches["select_interpolant"] = counted(select)
    sel_ref, _ = select("reference", targets)
    sel_cpu = picholesky.select_interpolant(targets.cpu(), sample.cpu())
    sel_ref_targets, _ = select("reference")
    del targets

    def score_gap(a, b):
        return max(abs(a["scores"][k] - b["scores"][k]) / abs(b["scores"][k])
                   for k in b["scores"])

    out["select_interpolant"] = dict(
        degree=sel["degree"], basis=sel["basis"], scores=sel["scores"],
        reference=(sel_ref["degree"], sel_ref["basis"]),
        score_rel_gap=score_gap(sel, sel_ref), tol=SELECT_TOL,
        cpu=(sel_cpu["degree"], sel_cpu["basis"]),
        cpu_score_rel_gap=score_gap(sel, sel_cpu),
        reference_targets=(sel_ref_targets["degree"],
                           sel_ref_targets["basis"]),
        reference_targets_score_rel_gap=score_gap(sel, sel_ref_targets))
    if (sel["degree"], sel["basis"]) != (sel_ref["degree"],
                                         sel_ref["basis"]) \
            or score_gap(sel, sel_ref) > SELECT_TOL:
        fail(f"select_interpolant: {out['select_interpolant']}")
    # RidgeCV at the main configuration, on the data the folds came from
    x, y = make_regression_dataset(N_TRAIN, H, seed=SEED,
                                   dtype=torch.float64, device=dev)
    ridge = {bk: RidgeCV(k_folds=K_FOLDS, n_lambdas=N_LAMBDAS, lam_lo=LAM_LO,
                         lam_hi=LAM_HI, g_samples=G_SAMPLES, degree=DEGREE,
                         block=BLOCK, backend=bk, device=dev)
             for bk in ("cuda", "reference")}
    (theta, res), launches["ridge_cv"] = counted(
        lambda bk: ridge[bk].fit_theta(x, y))
    pi = cv.cv_picholesky(folds, ridge["cuda"].lambdas(), g=G_SAMPLES,
                          degree=DEGREE, block=BLOCK, backend="cuda",
                          device=dev)
    theta_ref, _ = ridge["reference"].fit_theta(x, y)
    out["ridge_cv"] = dict(best_lam=res.best_lam,
                           cv_picholesky_best_lam=pi.best_lam,
                           theta_rel_err=rel_err(theta, theta_ref),
                           tol=MAIN_TOL)
    if res.best_lam != pi.best_lam or out["ridge_cv"]["theta_rel_err"] \
            > MAIN_TOL:
        fail(f"ridge_cv: {out['ridge_cv']}")
    want_ridge = dict(cholesky_blocked=2 * chol, pack_tril=1,
                      interp_solve=n_chunks, solve_lower_blocked=2)
    want_select = dict(cholesky_blocked=chol, pack_tril=1)
    for tag, want in (("ridge_cv", want_ridge),
                      ("select_interpolant", want_select)):
        if launches[tag] != {k: want.get(k, 0) for k in launches[tag]}:
            fail(f"{tag}: launches {launches[tag]}, predicted {want}")
    expected.update(ridge_cv=want_ridge, select_interpolant=want_select)
    out["launches_predicted"] = expected
    # CountingBackend around each new strategy (and MChol)
    stages = {}
    for tag, run in (("picholesky_warmstart", runs["picholesky_warmstart"]),
                     ("pinrmse", runs["pinrmse"]), ("svd", runs["svd"]),
                     ("low_rank", runs["low_rank"]), ("mchol", runs["mchol"])):
        bk = backends.CountingBackend(backends.CudaBackend())
        run(bk)
        stages[tag] = {k: dict(v) for k, v in bk.by_stage.items()}
    out["counting_backend"] = stages
    ok = (stages["picholesky_warmstart"].get("prepare", {}).get("cholesky")
          and stages["picholesky_warmstart"].get("fold_state", {}).get(
              "cholesky")
          and stages["picholesky_warmstart"].get("fold_errors", {}).get(
              "interp_solve")
          and stages["pinrmse"].get("prepare", {}).get("cholesky")
          and not stages["svd"] and not stages["low_rank"]
          and stages["mchol"] == {"unstaged": {"cholesky": len(visited)}})
    if not ok:
        fail(f"CountingBackend stage counts: {stages}")
    # no library factorization or triangular solve on the Cholesky paths
    traces = {}
    for tag, fn in (("picholesky_warmstart",
                     lambda: runs["picholesky_warmstart"]("cuda")),
                    ("pinrmse", lambda: runs["pinrmse"]("cuda")),
                    ("mchol", lambda: runs["mchol"]("cuda")),
                    ("ridge_cv", lambda: ridge["cuda"].fit_theta(x, y))):
        trace, by_name = profiled(fn)
        traces[tag] = dict(
            trace, cholesky=chol_split(by_name),
            library_trsm={n: v for n, v in by_name.items()
                          if is_library_trsm(n)},
            library_cholesky={n: v for n, v in by_name.items()
                              if is_library_factorization(n)})
        if trace["triangular_solve_ops"] or traces[tag]["library_trsm"] \
                or traces[tag]["library_cholesky"]:
            fail(f"{tag}: a library Cholesky or triangular solve ran: "
                 f"{traces[tag]}")
    out["trace"] = traces
    # walls: the paper's Table 3 on the card, in turns
    walls = {tag: [] for tag in runs}
    for _ in range(BASELINE_REPEATS):
        for tag, run in runs.items():
            walls[tag].append(_wall(lambda: run("cuda")))
    out["wall_s"] = walls
    out["wall_s_median"] = {k: float(np.median(v)) for k, v in walls.items()}
    emit("baselines", h=H, n=N_TRAIN, k=K_FOLDS, q=N_LAMBDAS, g=G_SAMPLES,
         r=DEGREE, block=BLOCK, dtype="float64", launches=launches, **out)
    return launches


# ------------------------------------------- the engine's reuse and staging
# surface: sketched anchors, the factor cache, the staged sweep and search,
# the CV sweep server

SKETCH_N = 131072          # the tall configuration: n ≫ h (n_tr = 104,856)
SKETCH_M = 8192            # SRHT and Gaussian: m ≈ 8·h (README, sketched
                           # anchors)
COUNTSKETCH_MS = (16384, 32768, 65536)   # the smallest that contracts
IHS_ITERS = 2
ASYNC_TOL = 1e-12          # run_async against run, relative
STAGED_REPEATS = 3         # timed sweeps per order / cache route, in turns
# make_traffic at the main configuration (benchmarks/bench_serving.py's mix)
SERVE_TRAFFIC = dict(h=H, n=N_TRAIN, k=K_FOLDS, n_problems=8, n_requests=48,
                     n_tenants=6, zipf_a=1.2, grid_sizes=(17, 25, 33),
                     shifted_grid_every=8)


def _pi_strategy(degree=DEGREE):
    from repro_torch.core import engine
    return engine.make_strategy("picholesky", g=G_SAMPLES, degree=degree,
                                block=BLOCK)


def _counted(fn):
    """``counted`` for a call that takes no backend argument."""
    return counted(lambda _: fn())


def ihs_contraction(plan, folds, lams, bk) -> dict:
    """Fold 0's interpolated sketched solve refined by 0..IHS_ITERS sweeps
    against the exact solve at every λ: the relative error after each sweep
    (largest over the grid) and the contraction factor, the largest ratio
    e_{i+1} / e_i over the grid and the sweeps (below 1: every sweep
    contracts the error at every λ)."""
    from repro_torch.core import engine, picholesky, sketch, solvers
    k, _, h = folds.x_folds.shape
    x_tr = folds.x_folds[[(1 + j) % k for j in range(k - 1)]].reshape(-1, h)
    h_tr = folds.hess - folds.fold_hess[0]
    g_tr = folds.grad - folds.fold_grad[0]
    model = picholesky.fit(sketch.sketched_gram(plan, x_tr, 0),
                           engine._sample_grid(lams, G_SAMPLES), DEGREE,
                           block=BLOCK, backend=bk)
    exact = solvers.solve_cholesky_sweep(h_tr, g_tr, lams, backend=bk)
    th0 = model.solve(lams, g_tr, backend=bk)
    errs = []
    for it in range(IHS_ITERS + 1):
        th = picholesky.refine_solutions(model, h_tr, g_tr, lams, th0,
                                         backend=bk, iters=it)
        errs.append((torch.linalg.vector_norm(th - exact, dim=-1)
                     / torch.linalg.vector_norm(exact, dim=-1)).cpu().numpy())
    steps = np.stack([b / a for a, b in zip(errs, errs[1:])])  # (iters, q)
    return dict(rel_err_by_iter=[float(e.max()) for e in errs],
                contraction=float(steps.max()),
                contraction_by_iter=[float(r.max()) for r in steps])


def phase_sketch(dev) -> dict:
    """Sketched anchors at the tall configuration (h=1024, n=131,072, k=5,
    q=31, g=4, r=2, block 128, float64): SRHT and Gaussian at m = 8192,
    count sketch at the smallest m of COUNTSKETCH_MS whose IHS contracts;
    each method's IHS contraction, its curve on cuda against reference
    (MAIN_TOL, same λ*), the count sketch twice bit for bit, the curves
    against the dense picholesky sweep with the regret of each pick on
    the dense curve, and the sketched anchor build against the dense
    Hessian formation (CUDA events)."""
    from repro_torch.core import backends, cv, engine, sketch
    from repro_torch.data import make_regression_dataset

    def fail(msg: str) -> None:
        FAILED.append(f"sketch: {msg}")

    t0 = time.perf_counter()
    x, y = make_regression_dataset(SKETCH_N, H, seed=SEED,
                                   dtype=torch.float64, device=dev)
    folds = cv.make_folds(x, y, K_FOLDS, device=dev)
    del x, y
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    lams = torch.logspace(np.log10(LAM_LO), np.log10(LAM_HI), N_LAMBDAS,
                          dtype=torch.float64, device=dev)
    xf = folds.x_folds
    k, n_f, _ = xf.shape
    out = dict(n=SKETCH_N, n_tr=(k - 1) * n_f, data_s=data_s,
               x_bytes=xf.numel() * xf.element_size())
    out["dense_hessians_ms"] = timed_ms(
        lambda: torch.einsum("kni,knj->kij", xf, xf), 3)
    dense = cv.cv_picholesky(folds, lams, g=G_SAMPLES, degree=DEGREE,
                             block=BLOCK, backend="cuda", device=dev)
    ed = dense.errors
    out["dense_best_lam"] = dense.best_lam
    out["dense_curve"] = ed.tolist()
    cuda = backends.CudaBackend()
    contraction = {}
    chosen = None
    for m in COUNTSKETCH_MS:
        plan = sketch.SketchPlan("countsketch", m, SEED, IHS_ITERS)
        contraction[m] = ihs_contraction(plan, folds, lams, cuda)
        if contraction[m]["contraction"] < 1.0:
            chosen = m
            break
    out["countsketch_search"] = {str(m): v for m, v in contraction.items()}
    if chosen is None:
        fail(f"no count sketch m in {COUNTSKETCH_MS} contracts: "
             f"{contraction}")
        chosen = COUNTSKETCH_MS[-1]
    plans = {"srht": sketch.SketchPlan("srht", SKETCH_M, SEED, IHS_ITERS),
             "gaussian": sketch.SketchPlan("gaussian", SKETCH_M, SEED,
                                           IHS_ITERS),
             "countsketch": sketch.SketchPlan("countsketch", chosen, SEED,
                                              IHS_ITERS)}
    launches = {}
    for name, plan in plans.items():
        rec = dict(descriptor=plan.descriptor())
        rec["ihs"] = (contraction[plan.m] if name == "countsketch"
                      else ihs_contraction(plan, folds, lams, cuda))
        rec["contracts"] = rec["ihs"]["contraction"] < 1.0

        def run(bk, plan=plan):
            return engine.CVEngine(_pi_strategy(), backend=bk, sketch=plan,
                                   device=dev).run(folds, lams)

        res, launches[f"sketch_{name}"] = counted(run)
        try:
            rec["vs_reference"] = curve_check(f"sketch {name}", res,
                                              run("reference"),
                                              "reference backend")
        except AssertionError as e:
            fail(str(e))
        if name == "countsketch":
            rec["bitwise_twice"] = bool(np.array_equal(res.errors,
                                                       run("cuda").errors))
            if not rec["bitwise_twice"]:
                fail("two count-sketch runs differ")
        i = int(np.argmin(res.errors))
        rec.update(best_lam=res.best_lam, curve=res.errors.tolist(),
                   max_rel_gap_to_dense=float(np.max(np.abs(res.errors - ed)
                                                     / ed)),
                   regret_on_dense=float((ed[i] - ed.min()) / ed.min()))
        strat = engine.CVEngine(_pi_strategy(), sketch=plan,
                                device=dev).strategy
        rec["anchor_hessians_ms"] = timed_ms(
            lambda: strat.anchor_hessian(None, xf, cuda), 2)
        rec["sweep_wall_s"] = _wall(lambda: run("cuda"))
        out[name] = rec
    out["dense_sweep_wall_s"] = _wall(lambda: cv.cv_picholesky(
        folds, lams, g=G_SAMPLES, degree=DEGREE, block=BLOCK,
        backend="cuda", device=dev))
    emit("sketch", h=H, k=K_FOLDS, q=N_LAMBDAS, g=G_SAMPLES, r=DEGREE,
         block=BLOCK, dtype="float64", ihs_iters=IHS_ITERS,
         launches=launches, **out)
    del folds, xf
    torch.cuda.empty_cache()
    return launches


def phase_cache(dev, folds, lams) -> dict:
    """The warm-replay cache at the main configuration: a cold run with
    cache_anchors, an exact hit, a covering hit on a sub-grid, a refit at
    degree 3 from the cached anchors, save → load → replay; CountingBackend
    factorizations per route (0 on every warm one), the hit against the
    cold curve and the loaded against the in-memory one bit for bit; times
    of the fingerprint, the cold sweep (with and without a cache), the hit,
    the refit, save and load."""
    import tempfile
    from repro_torch.core import backends, engine, factor_cache as fc

    def fail(msg: str) -> None:
        FAILED.append(f"cache: {msg}")

    bk = backends.CountingBackend(backends.CudaBackend())
    cache = fc.FactorCache()

    def eng(c=cache, reuse="exact", degree=DEGREE, **kw):
        return engine.CVEngine(_pi_strategy(degree), backend=bk, device=dev,
                               cache=c, reuse=reuse, cache_anchors=True, **kw)

    launches, n_chol, status, res = {}, {}, {}, {}

    def route(tag, fn):
        bk.reset()
        res[tag], launches[f"cache_{tag}"] = _counted(fn)
        n_chol[tag] = bk.n_cholesky
        status[tag] = res[tag].extras["engine"]["cache"]["status"]

    sub = lams[4:27]
    route("cold", lambda: eng().run(folds, lams))
    route("hit", lambda: eng().run(folds, lams))
    route("covering", lambda: eng(reuse="covering").run(folds, sub))
    route("refit", lambda: eng(degree=3).run(folds, lams))
    (entry,) = [e for e in cache.entries.values() if e.state.degree == DEGREE]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        cache.save(d)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = fc.FactorCache.load(d, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        route("loaded", lambda: eng(c=loaded).run(folds, lams))
    want = dict(cold="miss", hit="hit", covering="hit", refit="refit",
                loaded="hit")
    if status != want:
        fail(f"routes {status}, expected {want}")
    if n_chol["cold"] == 0 or any(n_chol[t] for t in want if t != "cold"):
        fail(f"factorizations by route {n_chol}")
    bitwise = dict(
        hit_vs_cold=bool(np.array_equal(res["hit"].errors,
                                        res["cold"].errors)),
        loaded_vs_memory=bool(np.array_equal(res["loaded"].errors,
                                             res["hit"].errors)))
    if not all(bitwise.values()):
        fail(f"bit equality {bitwise}")
    cover_gap = float(np.max(np.abs(res["covering"].errors
                                    - res["cold"].errors[4:27])
                             / res["cold"].errors[4:27]))
    refit_gap = float(np.max(np.abs(res["refit"].errors - res["cold"].errors)
                             / res["cold"].errors))
    h_tr = folds.hess[None] - folds.fold_hess

    def refit_once():
        c = fc.FactorCache()
        c.put(entry.key, entry.state, entry.anchors)
        return eng(c=c, degree=3).run(folds, lams)

    timed = {
        "fingerprint": lambda: fc.hessian_fingerprint(h_tr),
        "cold_no_cache": lambda: engine.CVEngine(
            _pi_strategy(), backend="cuda", device=dev).run(folds, lams),
        "cold_populate": lambda: eng(c=fc.FactorCache()).run(folds, lams),
        "hit": lambda: eng().run(folds, lams),
        "refit": refit_once,
    }
    walls = {t: [] for t in timed}
    for _ in range(STAGED_REPEATS):
        for t, fn in timed.items():
            walls[t].append(_wall(fn) * 1e3)
    med = {t: float(np.median(v)) for t, v in walls.items()}
    emit("cache", h=H, k=K_FOLDS, q=N_LAMBDAS, g=G_SAMPLES, r=DEGREE,
         block=BLOCK, dtype="float64", status=status, n_cholesky=n_chol,
         bitwise=bitwise, covering_grid=[4, 27],
         covering_rel_gap_to_cold=cover_gap,
         refit_degree3_rel_gap_to_degree2=refit_gap,
         entry_bytes=entry.nbytes, save_s=save_s, load_s=load_s,
         wall_ms=walls, wall_ms_median=med,
         replay_ms_median=med["hit"] - med["fingerprint"],
         fingerprint_bytes=h_tr.numel() * h_tr.element_size(),
         launches=launches)
    return launches


def phase_staged(dev, folds, lams) -> dict:
    """The staged sweep and the λ search at the main configuration:
    sweep_async pipelined against serial (cold, and warm on a cache) bit
    for bit, run_async against run (ASYNC_TOL), early stopping at stop_tol
    0, the exact strategy's staged sweep and search, search at the default
    wave and at wave 8 (evaluated λs, λ* against the dense argmin's
    bracket), select_interpolant and advise_anchor; wall medians of the
    pipelined and the serial sweep, and one profiled run of each (the
    device's idle share)."""
    from repro_torch.core import engine, factor_cache as fc

    def fail(msg: str) -> None:
        FAILED.append(f"staged: {msg}")

    def pi(**kw):
        return engine.CVEngine(_pi_strategy(), backend="cuda", device=dev,
                               **kw)

    def exact(**kw):
        return engine.CVEngine("exact", backend="cuda", device=dev, **kw)

    def curve(parts):
        return np.concatenate([p.fold_errors for p in parts], axis=1)

    launches, out = {}, {}
    e = pi()
    pipe, launches["staged_pipelined"] = _counted(
        lambda: list(e.sweep_async(folds, lams)))
    serial = list(e.sweep_async(folds, lams, pipelined=False))
    cache = fc.FactorCache()
    ec = pi(cache=cache)
    ec.run(folds, lams)
    warm_pipe, launches["staged_warm"] = _counted(
        lambda: list(ec.sweep_async(folds, lams)))
    warm_serial = list(ec.sweep_async(folds, lams, pipelined=False))
    out["bitwise"] = dict(
        cold=bool(np.array_equal(curve(pipe), curve(serial))),
        warm=bool(np.array_equal(curve(warm_pipe), curve(warm_serial))),
        warm_vs_cold=bool(np.array_equal(curve(warm_pipe), curve(pipe))))
    if not all(out["bitwise"].values()):
        fail(f"pipelined against serial: {out['bitwise']}")
    out["chunks"] = len(pipe)
    run = e.run(folds, lams)
    ra = e.run_async(folds, lams)
    out["run_async_rel_err"] = float(np.max(np.abs(ra.errors - run.errors)
                                            / run.errors))
    if out["run_async_rel_err"] > ASYNC_TOL or ra.best_lam != run.best_lam:
        fail(f"run_async against run: {out['run_async_rel_err']}")
    early = list(e.sweep_async(folds, lams, stop_tol=0.0))
    prefix = np.concatenate([p.errors for p in early])
    out["early_stop"] = dict(
        chunks=len(early), lams=int(prefix.shape[0]),
        stopped=early[-1].stopped, best_lam=early[-1].best_lam,
        full_best_lam=run.best_lam,
        prefix_bitwise=bool(np.array_equal(prefix,
                                           run.errors[:prefix.shape[0]])))
    if not out["early_stop"]["prefix_bitwise"] \
            or early[-1].best_lam != run.best_lam:
        fail(f"early stop: {out['early_stop']}")
    ex_parts, launches["staged_exact"] = _counted(
        lambda: list(exact().sweep_async(folds, lams)))
    ex_run = exact().run(folds, lams)
    out["exact_staged_rel_err"] = float(np.max(np.abs(
        curve(ex_parts).mean(0) - ex_run.errors) / ex_run.errors))
    q = N_LAMBDAS
    i = int(np.argmin(run.errors))
    lo, hi = float(lams[max(i - 1, 0)]), float(lams[min(i + 1, q - 1)])
    searches = {}
    for tag, mk, wave in (("search", pi, None), ("search_wave8", pi, 8),
                          ("search_exact", exact, None)):
        s, launches[tag] = _counted(lambda: mk().search(folds, lams,
                                                        wave=wave))
        info = s.extras["engine"]["search"]
        searches[tag] = dict(
            wave=info["wave"], waves=info["waves"],
            lams_evaluated=info["lams_evaluated"], lams=s.lams.tolist(),
            stopped_on=info["stopped_on"], best_lam=s.best_lam,
            dense_bracket=[lo, hi], in_bracket=lo <= s.best_lam <= hi,
            n_exact_chol=s.n_exact_chol)
    warm_search = pi(cache=cache).search(folds, lams)
    searches["search_warm_n_exact_chol"] = warm_search.n_exact_chol
    out["search"] = searches
    sel, launches["engine_select_interpolant"] = _counted(
        lambda: pi().select_interpolant(folds, lams))
    out["select_interpolant"] = dict(degree=sel["degree"],
                                     basis=sel["basis"],
                                     anchor_status=sel["anchor_status"],
                                     scores=sel["scores"])
    t0 = time.perf_counter()
    adv = pi().advise_anchor(folds, lams)
    out["advise_anchor"] = dict(adv, seconds=time.perf_counter() - t0)
    walls = {"pipelined": [], "serial": []}
    for _ in range(STAGED_REPEATS):
        for tag in walls:
            walls[tag].append(_wall(lambda: list(e.sweep_async(
                folds, lams, pipelined=tag == "pipelined"))))
    out["wall_s"] = walls
    out["wall_s_median"] = {t: float(np.median(v)) for t, v in walls.items()}
    out["trace"] = {tag: profiled(lambda: list(e.sweep_async(
        folds, lams, pipelined=tag == "pipelined")))[0]
        for tag in ("pipelined", "serial")}
    emit("staged", h=H, k=K_FOLDS, q=N_LAMBDAS, g=G_SAMPLES, r=DEGREE,
         block=BLOCK, dtype="float64", launches=launches, **out)
    return launches


TUNE_REPEATS = 3           # timed sweeps per lattice candidate, in turns
# The tuner's choice must not be slower than the configuration it replaces
# (median walls): tuning refines the default, never regresses it.  How far
# it is from the measured best is reported (chosen_over_best), not held:
# the launch-plan model does not see the cluster solve's per-block latency
# and misses the best by 5-15 % (PERF.md §6, ROADMAP.md queue 3).
# the reference's memory contract (tests/test_packed_pipeline.py:279-293):
# h 64, n 400, k 4, g 4, block 16, lam_chunk 16; q 64 against q 1024
MEM_SHAPE = dict(h=64, n=400, k=4, block=16, chunk=16)
MEM_BYTES_PER_LAM = 64
LAUNCH_PROBE = (512, 16, 20)   # h, block, calls: 94 dependent launches a call


def measure_launch_s(dev) -> dict:
    """Host seconds per launch of a dependent chain of the port's kernels:
    ``cholesky_blocked`` of one small matrix at block 16 (3·nt − 2 = 94
    launches a call, each tile step waiting on the last), a burst of calls
    with one synchronization at the end, wall over launches (median of 5
    bursts after a warm one)."""
    from repro_torch.kernels import LAUNCHES, chol_blocked, reset_launches
    h, block, calls = LAUNCH_PROBE
    a = torch.eye(h, dtype=torch.float64, device=dev) * 2.0
    chol_blocked.cholesky_blocked(a, block)
    per = []
    for _ in range(5):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(calls):
            chol_blocked.cholesky_blocked(a, block)
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / LAUNCHES["cholesky_blocked"])
    return dict(launch_s=float(np.median(per)), bursts=per, h=h,
                block=block, calls=calls,
                launches_per_call=chol_launches(h, block))


def phase_tune(dev, folds, lams, dev_info) -> dict:
    """``tune='auto'`` at the main configuration, uncut: the lattice and
    every candidate's priced step, its measured wall (median of
    TUNE_REPEATS in turns, after a warm run) and its curve against the
    reference backend; the predicted against the measured rank; zero
    factorizations while tuning, a cache hit on the second tune, a
    save → load of the tuning cache; ``launch_s``; ``mesh='auto'`` and
    ``donate`` bit for bit; the sweep's measured peak memory (the
    reference's O(chunk · P) contract at its test's shape, then the main
    configuration); the server with ``tune='auto'`` over the cv_serve
    traffic; ``RidgeCV(cv_mesh='auto')``."""
    import shutil
    from repro_torch.core import backends, engine, factor_cache as fc, cv
    from repro_torch.core.ridge_cv import RidgeCV
    from repro_torch.data import make_regression_dataset
    from repro_torch.distributed import autotune, plan_cost, roofline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import CVSweepServer, ServerConfig, \
        SweepRequest, TrafficConfig, make_traffic

    def fail(msg: str) -> None:
        FAILED.append(f"tune: {msg}")

    launches, out = {}, {}
    out["smi"] = dev_info["smi"]
    out["launch"] = measure_launch_s(dev)
    out["launch_s_preset"] = roofline.detect_hw(torch.float64).launch_s
    hw = roofline.detect_hw(torch.float64)
    out["hw"] = dataclasses.asdict(hw)

    # -- the tuner: zero executions, the lattice, the cache ---------------
    counting = backends.CountingBackend(backends.CudaBackend())
    eng = engine.CVEngine(_pi_strategy(), backend=counting, device=dev,
                          tune="auto")
    cache = autotune.TuningCache()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cfg = autotune.tune(eng, folds, lams, cache=cache)
    out["tune_seconds"] = time.perf_counter() - t0
    out["tune_factorizations"] = counting.n_cholesky
    out["tune_launches"] = sum(LAUNCHES.values())
    if counting.n_cholesky or out["tune_launches"]:
        fail(f"tune() ran {counting.n_cholesky} factorizations and "
             f"{out['tune_launches']} launches")
    lowered = cache.lowerings
    again = autotune.tune(eng, folds, lams, cache=cache)
    out["second_tune"] = dict(source=again.source, stats=cache.stats)
    if again.source != "cache" or cache.lowerings != lowered \
            or again.key() != cfg.key():
        fail(f"second tune is no cache hit: {out['second_tune']}")
    cache_dir = ROOT / "build" / "tune_cache_smoke"
    shutil.rmtree(cache_dir, ignore_errors=True)
    cache.save(str(cache_dir))
    loaded = autotune.TuningCache.load(str(cache_dir))
    shutil.rmtree(cache_dir, ignore_errors=True)
    out["save_load_same"] = loaded.configs == cache.configs
    if not out["save_load_same"]:
        fail("the tuning cache's save → load changed its verdicts")
    out["chosen"] = cfg.to_json()

    k, _, h = folds.x_folds.shape
    default = autotune.default_config(eng, k, h, N_LAMBDAS, torch.float64)
    cands = autotune.candidate_lattice(
        h=h, k=k, q=N_LAMBDAS, n_devices=1, default=default,
        blocks=autotune.DEFAULT_BLOCKS,
        store_dtype=torch.float64, budget=engine.LAM_CHUNK_BUDGET_BYTES)
    scored = autotune.score_candidates(eng, folds, lams, cands, hw=hw)
    out["lattice_size"] = len(scored)
    plain = engine.CVEngine(_pi_strategy(), backend="cuda", device=dev)
    untuned = plain.run(folds, lams)
    ref = engine.CVEngine(_pi_strategy(), backend="reference",
                          device=dev).run(folds, lams)
    runs = {}
    rows = []
    launches["tune_lattice"] = dict.fromkeys(LAUNCHES, 0)
    for cand in scored:
        derived = eng._apply_tuned(cand)
        r, n = _counted(lambda: derived.run(folds, lams))
        for name, c in n.items():
            launches["tune_lattice"][name] += c
        cost, _ = plan_cost.engine_cost(derived, k, h, N_LAMBDAS,
                                        torch.float64)
        rel = float(np.max(np.abs(r.errors - ref.errors) / ref.errors))
        row = dict(block=cand.block, lam_chunk=cand.lam_chunk,
                   predicted_s=cand.predicted_s, launches=dict(n),
                   plan_launches=cost.launches,
                   plan_calls=cost.calls, curve_rel_err=rel,
                   argmin=int(np.argmin(r.errors)),
                   argmin_reference=int(np.argmin(ref.errors)),
                   bitwise_untuned=bool(np.array_equal(r.errors,
                                                       untuned.errors)))
        if rel > MAIN_TOL or row["argmin"] != row["argmin_reference"]:
            fail(f"candidate {cand.key()}: curve {rel} from the reference, "
                 f"argmin {row['argmin']} vs {row['argmin_reference']}")
        if cand.block == BLOCK and not row["bitwise_untuned"]:
            fail(f"candidate {cand.key()} at the default block differs "
                 "from the untuned run")
        kernel_launches = sum(n.values())
        if kernel_launches != cost.launches:
            fail(f"candidate {cand.key()}: {kernel_launches} launches, "
                 f"the plan prices {cost.launches}")
        runs[cand.key()] = lambda d=derived: d.run(folds, lams)
        rows.append(row)
    walls = {key: [] for key in runs}
    for _ in range(TUNE_REPEATS):           # in turns, after the warm runs
        for key, fn in runs.items():
            walls[key].append(_wall(fn))
    for row, cand in zip(rows, scored):
        row["wall_s"] = walls[cand.key()]
        row["wall_s_median"] = float(np.median(walls[cand.key()]))
    pred = np.array([r["predicted_s"] for r in rows])
    meas = np.array([r["wall_s_median"] for r in rows])
    rank_p = np.argsort(np.argsort(pred, kind="stable"), kind="stable")
    rank_m = np.argsort(np.argsort(meas, kind="stable"), kind="stable")
    spearman = float(np.corrcoef(rank_p, rank_m)[0, 1])
    chosen_wall = walls[cfg.key()]
    best = int(np.argmin(meas))
    out["candidates"] = rows
    out["rank"] = dict(
        spearman=spearman, predicted_order=[
            [rows[i]["block"], rows[i]["lam_chunk"]] for i in np.argsort(
                pred, kind="stable")],
        measured_order=[[rows[i]["block"], rows[i]["lam_chunk"]]
                        for i in np.argsort(meas, kind="stable")],
        chosen_wall_s_median=float(np.median(chosen_wall)),
        best=[rows[best]["block"], rows[best]["lam_chunk"]],
        best_wall_s_median=float(meas[best]),
        default_wall_s_median=float(np.median(walls[default.key()])),
        chosen_over_best=float(np.median(chosen_wall) / meas[best]),
        chosen_over_default=float(np.median(chosen_wall)
                                  / np.median(walls[default.key()])))
    if out["rank"]["chosen_over_default"] > 1.0:
        fail(f"the tuner's choice {cfg.key()} is "
             f"{out['rank']['chosen_over_default']:.3f}× the untuned "
             f"default {default.key()}")

    # -- the exact strategy at the lattice's blocks: the dense trsm --------
    # (row 8) and the Cholesky at blocks 32, 64 and 128 through tune=, at
    # the chunk the tuner chooses for it
    def exact_engine(tune):
        return engine.CVEngine(engine.make_strategy("exact"), backend="cuda",
                               device=dev, tune=tune)

    eng_x = exact_engine("auto")
    cfg_x = autotune.tune(eng_x, folds, lams)
    ref_x = engine.CVEngine(engine.make_strategy("exact"),
                            backend="reference", device=dev).run(folds, lams)
    r_auto, launches["tune_exact_auto"] = _counted(
        lambda: eng_x.run(folds, lams))
    launches["tune_exact"] = dict.fromkeys(LAUNCHES, 0)
    xrows, xruns = [], {}
    for blk in autotune.DEFAULT_BLOCKS:
        pin = autotune.TunedConfig(block=blk, lam_chunk=cfg_x.lam_chunk)
        pinned = exact_engine(pin)
        r, n = _counted(lambda: pinned.run(folds, lams))
        for name, c in n.items():
            launches["tune_exact"][name] += c
        cost, _ = plan_cost.engine_cost(pinned._apply_tuned(pin), k, h,
                                        N_LAMBDAS, torch.float64)
        rel = float(np.max(np.abs(r.errors - ref_x.errors) / ref_x.errors))
        row = dict(block=blk, lam_chunk=pin.lam_chunk, launches=dict(n),
                   plan_launches=cost.launches, curve_rel_err=rel,
                   argmin=int(np.argmin(r.errors)),
                   argmin_reference=int(np.argmin(ref_x.errors)),
                   bitwise_auto=bool(np.array_equal(r.errors,
                                                    r_auto.errors)))
        if rel > MAIN_TOL or row["argmin"] != row["argmin_reference"]:
            fail(f"exact at block {blk}: curve {rel} from the reference, "
                 f"argmin {row['argmin']} vs {row['argmin_reference']}")
        missing = [k_ for k_ in PATH_KERNELS["exact"] if n[k_] == 0]
        stray = [k_ for k_, c in n.items()
                 if c and k_ not in PATH_KERNELS["exact"]]
        if missing or stray or sum(n.values()) != cost.launches:
            fail(f"exact at block {blk}: launches {n}, the plan prices "
                 f"{cost.launches}")
        if blk == cfg_x.block and not row["bitwise_auto"]:
            fail(f"exact: tune='auto' ({cfg_x.key()}) differs from its "
                 "pinned configuration")
        xruns[blk] = lambda e=pinned: e.run(folds, lams)
        xrows.append(row)
    xwalls = {blk: [] for blk in xruns}
    for _ in range(TUNE_REPEATS):
        for blk, fn in xruns.items():
            xwalls[blk].append(_wall(fn))
    for row in xrows:
        row["wall_s"] = xwalls[row["block"]]
        row["wall_s_median"] = float(np.median(xwalls[row["block"]]))
    out["exact"] = dict(chosen=cfg_x.to_json(), rows=xrows)
    del eng_x, r_auto, xruns

    # -- the tuned engine end to end: counted, profiled -------------------
    tuned = engine.CVEngine(_pi_strategy(), backend="cuda", device=dev,
                            tune="auto")
    r_t, launches["tune_auto"] = _counted(lambda: tuned.run(folds, lams))
    out["tuned_run"] = dict(tune=r_t.extras["engine"]["tune"],
                            bitwise_chosen=bool(np.array_equal(
                                r_t.errors, eng._apply_tuned(cfg).run(
                                    folds, lams).errors)))
    out["trace"] = dict(tuned=profiled(lambda: tuned.run(folds, lams))[0],
                        untuned=profiled(lambda: plain.run(folds,
                                                           lams))[0])

    # -- the mesh and donate on one card ---------------------------------
    meshed = engine.CVEngine(_pi_strategy(), backend="cuda", device=dev,
                             mesh="auto")
    r_m, launches["tune_mesh"] = _counted(lambda: meshed.run(folds, lams))
    r_nd = engine.CVEngine(_pi_strategy(), backend="cuda", device=dev,
                           donate=False).run(folds, lams)
    out["mesh"] = dict(extras=r_m.extras["engine"]["mesh"],
                       bitwise=bool(np.array_equal(r_m.errors,
                                                   untuned.errors)))
    out["donate"] = dict(default=untuned.extras["engine"]["donated"],
                         bitwise=bool(np.array_equal(r_nd.errors,
                                                     untuned.errors)))
    if not out["mesh"]["bitwise"] or not out["donate"]["bitwise"]:
        fail(f"mesh / donate change the curve: {out['mesh']} "
             f"{out['donate']}")

    # -- the sweep's measured peak memory ---------------------------------
    mem = {}
    mem["main_donate"] = {
        str(d): engine.CVEngine(_pi_strategy(), backend="cuda", device=dev,
                                donate=d).sweep_temp_bytes(folds, lams)
        for d in (True, False)}
    ms = MEM_SHAPE
    xm, ym = make_regression_dataset(ms["n"], ms["h"], seed=SEED,
                                     dtype=torch.float64, device=dev)
    f4 = cv.make_folds(xm, ym, ms["k"], device=dev)

    def strat4():
        return engine.make_strategy("picholesky", g=G_SAMPLES,
                                    block=ms["block"])

    def grid(q):
        return torch.logspace(-3, 2, q, dtype=torch.float64, device=dev)

    chunked = engine.CVEngine(strat4(), backend="cuda", block=ms["block"],
                              lam_chunk=ms["chunk"], donate=False,
                              device=dev)
    dense = engine.CVEngine(strat4(), backend="cuda", block=ms["block"],
                            lam_chunk=None, donate=False, device=dev)
    (t64, t1024, t_dense), launches["tune_memory"] = _counted(lambda: (
        chunked.sweep_temp_bytes(f4, grid(64)),
        chunked.sweep_temp_bytes(f4, grid(1024)),
        dense.sweep_temp_bytes(f4, grid(1024))))
    per_lam = (t1024 - t64) / (1024 - 64)
    r_chunked = chunked.replay_temp_bytes(f4, grid(1024))
    r_dense = dense.replay_temp_bytes(f4, grid(1024))
    mem["contract"] = dict(
        shape=ms, q64=t64, q1024=t1024, dense_q1024=t_dense,
        bytes_per_extra_lam=per_lam, bound_per_lam=MEM_BYTES_PER_LAM,
        dense_over_chunked=t_dense / t1024 if t1024 else float("inf"),
        dense_over_chunked_holds=t_dense > 10 * t1024,
        replay_q1024=r_chunked, dense_replay_q1024=r_dense,
        dense_over_chunked_replay=r_dense / r_chunked if r_chunked
        else float("inf"))
    if abs(t1024 - t64) > MEM_BYTES_PER_LAM * (1024 - 64):
        fail(f"chunked peak grows {per_lam:.1f} B per extra λ "
             f"(> {MEM_BYTES_PER_LAM}): {mem['contract']}")
    # The reference's second clause (unchunked > 10× chunked) is reported,
    # not held: the chunked sweep's peak is the state stage's anchors,
    # which XLA's temp accounting and the card's allocator see alike,
    # while the unchunked λ stream's working set is what the scoring
    # materializes (PERF.md §6).
    main_lams = {q: torch.logspace(np.log10(LAM_LO), np.log10(LAM_HI), q,
                                   dtype=torch.float64, device=dev)
                 for q in (64, 256)}
    mem["main"] = {
        f"q{q}": dict(sweep=plain.sweep_temp_bytes(folds, lq),
                      replay=plain.replay_temp_bytes(folds, lq))
        for q, lq in main_lams.items()}
    out["memory"] = mem
    del f4, xm, ym

    # -- the server with tune='auto' over the cv_serve traffic -----------
    tcfg = TrafficConfig(**SERVE_TRAFFIC)
    reqs = make_traffic(tcfg, device=dev)

    def serve():
        srv = CVSweepServer(_pi_strategy(), backend="cuda", device=dev,
                            config=ServerConfig(tune="auto"))
        for r in reqs:
            srv.submit(SweepRequest(r.tenant, r.folds, r.lams))
        return srv, srv.drain()

    (srv, resps), launches["tune_serve"] = _counted(serve)
    geometries = {int(r.lams.shape[0]) for r in reqs}
    solo: dict = {}
    stale = []
    first = min(r.request_id for r in resps)
    by_id = {r.request_id: r for r in resps}
    for j, r in enumerate(reqs):
        got = by_id[first + j].result
        tj = autotune.TunedConfig.from_json(got.extras["engine"]["tune"])
        key = (id(r.folds), id(r.lams), tj.key())
        if key not in solo:
            solo[key] = engine.CVEngine(
                _pi_strategy(), backend="cuda", device=dev,
                cache=fc.FactorCache(), reuse="covering",
                cache_anchors=True, tune=tj).run(r.folds, r.lams)
        want = solo[key]
        if not (np.array_equal(got.errors, want.errors)
                and got.best_lam == want.best_lam):
            stale.append(j)
    st = srv.stats["tuning"]
    out["serve"] = dict(tuning=st, geometries=len(geometries),
                        requests=len(reqs), mismatched_requests=stale,
                        chosen={str(q): None for q in sorted(geometries)})
    for r in resps:
        out["serve"]["chosen"][str(int(r.result.lams.shape[0]))] = \
            r.result.extras["engine"]["tune"]
    if st["entries"] != len(geometries) or st["misses"] != len(geometries):
        fail(f"server tuned {st} for {len(geometries)} geometries")
    if stale:
        fail(f"server responses {stale} differ from their solo runs")
    del srv, resps, reqs, solo

    # -- RidgeCV over the mesh -------------------------------------------
    x, y = make_regression_dataset(N_TRAIN, H, seed=SEED,
                                   dtype=torch.float64, device=dev)
    r_plain = RidgeCV(device=dev).fit(x, y)
    r_mesh, launches["tune_ridge_cv"] = _counted(
        lambda: RidgeCV(cv_mesh="auto", device=dev).fit(x, y))
    out["ridge_cv"] = dict(best_lam=r_mesh.best_lam,
                           best_lam_plain=r_plain.best_lam,
                           mesh=r_mesh.extras["engine"]["mesh"])
    if r_mesh.best_lam != r_plain.best_lam:
        fail(f"RidgeCV(cv_mesh='auto') selects {r_mesh.best_lam}, "
             f"RidgeCV() {r_plain.best_lam}")
    emit("tune", h=H, n=N_TRAIN, k=K_FOLDS, q=N_LAMBDAS, g=G_SAMPLES,
         r=DEGREE, dtype="float64", launches=launches, **out)
    return launches


def phase_cv_serve(dev) -> dict:
    """The CV sweep server on make_traffic at the main configuration (8
    problems, 48 requests, 6 tenants, Zipf 1.2, grids of 17/25/33 λs and
    every 8th on a shifted range) with ServerConfig's defaults, after one
    warm-up round, as benchmarks/bench_serving.py runs it: p50/p99
    latency, throughput, hit rate, tenants sharing, the fingerprint's
    share of the wall; every response against a solo cold run bit for
    bit; then a second server whose cache holds three entries, which must
    serve no stale entry."""
    from repro_torch.core import engine, factor_cache as fc
    from repro_torch.serving import CVSweepServer, ServerConfig, \
        SweepRequest, TrafficConfig, make_traffic
    from repro_torch.serving.traffic import log_grid

    def fail(msg: str) -> None:
        FAILED.append(f"cv_serve: {msg}")

    cfg = TrafficConfig(**SERVE_TRAFFIC)
    reqs = make_traffic(cfg, device=dev)
    warm = make_traffic(dataclasses.replace(
        cfg, n_requests=1, n_tenants=1, n_problems=1, seed=cfg.seed + 777),
        device=dev)[0].folds
    solo: dict = {}
    for r in reqs:
        key = (id(r.folds), id(r.lams))
        if key not in solo:
            solo[key] = engine.CVEngine(
                _pi_strategy(), backend="cuda", device=dev,
                cache=fc.FactorCache(), reuse="covering",
                cache_anchors=True).run(r.folds, r.lams)
    spent = [0.0]
    fingerprint = fc.hessian_fingerprint

    def timed_fingerprint(h_tr):
        t0 = time.perf_counter()
        try:
            return fingerprint(h_tr)
        finally:
            spent[0] += time.perf_counter() - t0

    def serve(config):
        srv = CVSweepServer(_pi_strategy(), backend="cuda", device=dev,
                            config=config)
        for q in cfg.grid_sizes:
            srv.submit(SweepRequest("_warmup", warm, log_grid(q, device=dev)))
        srv.drain()
        warm_stats = dict(srv.cache.stats)
        spent[0] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            srv.submit(SweepRequest(r.tenant, r.folds, r.lams))
        resps = srv.drain()
        wall = time.perf_counter() - t0
        by_id = {r.request_id: r for r in resps}
        first = min(by_id)
        stale = []
        for j, r in enumerate(reqs):
            got = by_id[first + j].result
            want = solo[(id(r.folds), id(r.lams))]
            if not (np.array_equal(got.errors, want.errors)
                    and got.best_lam == want.best_lam):
                stale.append(j)
        lat = np.array([r.latency_s for r in resps])
        st = srv.stats
        hits = st["cache"]["hits"] - warm_stats["hits"]
        misses = st["cache"]["misses"] - warm_stats["misses"]
        tenants = {t: rec for t, rec in st["tenants"].items()
                   if t.startswith("tenant-")}
        rec = dict(
            p50_s=float(np.percentile(lat, 50)),
            p99_s=float(np.percentile(lat, 99)),
            mean_s=float(lat.mean()), wall_s=wall,
            throughput_rps=len(resps) / wall,
            hit_rate=hits / (hits + misses) if hits + misses else 0.0,
            hits=hits, misses=misses,
            anchor_hits=st["cache"]["anchor_hits"],
            evictions=st["cache"]["evictions"],
            entries=st["cache"]["entries"], bytes=st["cache"]["bytes"],
            tenants_sharing=sum(1 for t in tenants.values() if t["hits"]),
            dispatches=st["dispatches"], batch_mean=st["batch_mean"],
            statuses={s: sum(1 for r in resps if r.status == s)
                      for s in ("hit", "refit", "miss")},
            fingerprint_s=spent[0], fingerprint_share=spent[0] / wall,
            mismatched_requests=stale)
        return srv, rec

    fc.hessian_fingerprint = timed_fingerprint
    try:
        (srv, first_pass), counts = _counted(lambda: serve(ServerConfig()))
        entry = max(e.nbytes for e in srv.cache.entries.values())
        del srv
        _, budget_pass = serve(ServerConfig(cache_bytes=3 * entry))
    finally:
        fc.hessian_fingerprint = fingerprint
    for tag, rec in (("unbounded", first_pass), ("three_entries",
                                                   budget_pass)):
        if rec["mismatched_requests"]:
            fail(f"{tag}: requests {rec['mismatched_requests']} differ from "
                 "their solo cold runs")
    if budget_pass["evictions"] == 0:
        fail("the three-entry cache evicted nothing")
    emit("cv_serve", traffic=SERVE_TRAFFIC, g=G_SAMPLES, r=DEGREE,
         block=BLOCK, unique_problems=len(solo), entry_bytes=entry,
         unbounded=first_pass, three_entries=budget_pass,
         launches=dict(cv_serve=counts))
    return dict(cv_serve=counts)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |Δ| / max |want|, failing on a non-finite value."""
    return errors(got.float(), want.float())[1]


def fixture_params(data) -> dict:
    """The nested parameter tree of the JAX ``Model.init`` from the flat
    ``param/<dotted name>`` entries of a fixture."""
    return _tree(data, "param/")


@torch.no_grad()
def phase_mamba_fixture(dev) -> dict:
    """The reduced Falcon-Mamba model of ``tests/data/torch_mamba.npz`` (JAX
    weights and answers) on the kernel: forward, prefill (logits, conv
    tail, scan state) and two decode steps within MAMBA_TOL."""
    from repro_torch import configs, convert
    data = np.load(ROOT / "tests" / "data" / "torch_mamba.npz")
    cfg = configs.get(MAMBA_ARCH).reduced()
    model = convert.model_from_numpy(cfg, fixture_params(data), device=dev,
                                     scan="cuda")
    tokens = torch.as_tensor(data["tokens"], device=dev)
    got = {"forward": model(tokens)[0]}
    got["prefill"], cache = model.prefill(tokens)
    got["prefill_conv"] = torch.stack([c["conv"] for c in cache["groups"]])
    got["prefill_h"] = torch.stack([c["h"] for c in cache["groups"]])
    steps = []
    for tok in data["steps"]:
        logits, cache = model.decode(cache, torch.as_tensor(tok, device=dev))
        steps.append(logits)
    got["decode"] = torch.stack(steps)
    out = {}
    for key, t in got.items():
        rel = rel_err(t, torch.as_tensor(data[key], device=dev))
        out[key] = dict(rel_err=rel, tol=MAMBA_TOL, ok=rel <= MAMBA_TOL)
    emit("mamba_fixture", layers=cfg.n_layers, d_model=cfg.d_model,
         d_inner=cfg.d_inner, state=cfg.ssm_state, results=out)
    bad = [k for k, r in out.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"mamba_fixture: {bad} differ from the JAX "
                             f"fixture: {out}")
    return out


def mamba_config(depth: int, dtype: str):
    """configs/falcon_mamba_7b.py at its published widths, ``depth``
    layers, activations and parameters in ``dtype``."""
    from repro_torch import configs
    return dataclasses.replace(configs.get(MAMBA_ARCH), n_layers=depth,
                               dtype=dtype, param_dtype=dtype)


def counted_call(fn):
    """``fn()`` with the launch counts set to 0 just before it; returns its
    result and the counts read just after it."""
    return counted(lambda _: fn())


@torch.no_grad()
def phase_mamba(dev) -> dict:
    """Full width, 4 layers, float32: the model on the mixer's kernels (the
    causal convolution and the fused scan, ``scan="auto"``) against the
    same weights on their plain versions (``scan="reference"``), and
    decode-after-prefill against forward."""
    from repro_torch.models import Model
    cfg = mamba_config(MAMBA_DEPTH, "float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Model(cfg, device=dev, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (MAMBA_BATCH, MAMBA_SEQ),
                           generator=gen, device=dev)
    steps = torch.randint(0, cfg.vocab_size, (MAMBA_DECODE, MAMBA_BATCH, 1),
                          generator=gen, device=dev)

    def run(scan):
        model.scan = scan
        out, counts = {}, {}
        (out["forward"], _), counts["forward"] = counted_call(
            lambda: model(tokens))
        (out["prefill"], cache), counts["prefill"] = counted_call(
            lambda: model.prefill(tokens))
        out["conv"] = torch.stack([c["conv"] for c in cache["groups"]])
        out["h"] = torch.stack([c["h"] for c in cache["groups"]])

        def decode_all():
            c, logits = cache, []
            for tok in steps:
                step, c = model.decode(c, tok)
                logits.append(step)
            return torch.cat(logits, 1)

        out["decode"], counts["decode"] = counted_call(decode_all)
        return out, counts

    got, counts = run("auto")
    want, counts_ref = run("reference")
    for tag, n in (("forward", MAMBA_DEPTH), ("prefill", MAMBA_DEPTH),
                   ("decode", MAMBA_DEPTH * MAMBA_DECODE)):
        check_counts(f"mamba {tag}", counts[tag],
                     dict(ssm_scan=n, causal_conv1d=n))
        check_counts(f"mamba {tag} (reference)", counts_ref[tag], {})
    rels = {k: rel_err(got[k], want[k]) for k in got}
    model.scan = "auto"
    ext = torch.cat([tokens, steps[:, :, 0].T], 1)
    rels["decode_vs_forward"] = rel_err(
        got["decode"], model(ext)[0][:, MAMBA_SEQ:])
    rels["prefill_vs_forward"] = rel_err(got["prefill"][:, 0],
                                         got["forward"][:, -1])
    bad = {k: v for k, v in rels.items() if not v <= MAMBA_TOL}
    emit("mamba", layers=MAMBA_DEPTH, d_model=cfg.d_model,
         d_inner=cfg.d_inner, state=cfg.ssm_state, batch=MAMBA_BATCH,
         seq=MAMBA_SEQ, decode_steps=MAMBA_DECODE, dtype="float32",
         rel_err=rels, tol=MAMBA_TOL, launches=counts)
    if bad:
        raise AssertionError(f"mamba: kernel path disagrees: {bad}")
    return counts


def gemm_like(name: str) -> bool:
    return any(k in name.lower() for k in ("gemm", "nvjet", "xmma",
                                            "cutlass", "splitk"))


def greedy(model, cache, first, steps: int):
    """``steps`` greedy decode steps from ``cache``, the first fed
    ``first``: (their logits (B, steps, V), the tokens fed (B, steps))."""
    toks, logits = [first], []
    for _ in range(steps):
        step, cache = model.decode(cache, toks[-1])
        logits.append(step)
        toks.append(step[:, -1].argmax(-1, keepdim=True))
    return torch.cat(logits, 1), torch.cat(toks[:-1], 1)


def serve_run(model, prompts, steps: int, prefix: str,
              each: bool = False, extra: dict | None = None) -> tuple:
    """A serve run: the prompts prefilled, ``steps`` greedy decodes, a
    forward over the extended sequences, each path counted
    (``<prefix>_prefill``, ``_decode``, ``_forward``); ``extra`` the
    prefill's and the forward's cross-attention source.  Returns (finite
    logits, decode against forward at each position from the prefill's
    last: max |Δ| / max |forward|, with ``each`` also every position's as
    ``decode_vs_forward_each``, the counts, the prefill's cache, the first
    decoded token)."""
    counts = {}
    (logits_p, cache), counts[f"{prefix}_prefill"] = counted_call(
        lambda: model.prefill(prompts, extra))
    first = logits_p[:, -1].argmax(-1, keepdim=True)
    (logits_d, gen_toks), counts[f"{prefix}_decode"] = counted_call(
        lambda: greedy(model, cache, first, steps))
    ext = torch.cat([prompts, gen_toks], 1)
    (logits_f, _), counts[f"{prefix}_forward"] = counted_call(
        lambda: model(ext, extra))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (logits_p, logits_d, logits_f))
    pos = logits_f[:, prompts.shape[1] - 1:]          # prefill, then decodes
    mine = torch.cat([logits_p, logits_d], 1)
    per_pos = [float((mine[:, j] - pos[:, j]).abs().max()
                     / pos[:, j].abs().max()) for j in range(pos.shape[1])]
    agree = float((mine.argmax(-1) == pos.argmax(-1)).float().mean())
    del logits_f, pos, mine
    stats = dict(finite=finite, decode_vs_forward_last=per_pos[-1],
                 decode_vs_forward_max=max(per_pos),
                 decode_vs_forward_median=float(np.median(per_pos)),
                 bit_equal_positions=sum(v == 0.0 for v in per_pos),
                 prefill_vs_forward=per_pos[0], greedy_agreement=agree)
    if each:
        stats["decode_vs_forward_each"] = per_pos
    return stats, counts, cache, first


def serve_walls(model, prompts, first, steps: int, repeats: int,
                extra: dict | None = None) -> tuple:
    """Prefill and decode walls, ``repeats`` times after the warm run:
    (the walls, their medians)."""
    walls = dict(prefill_ms=[], decode_ms_per_step=[])
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, c = model.prefill(prompts, extra)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        greedy(model, c, first, steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        walls["prefill_ms"].append((t1 - t0) * 1e3)
        walls["decode_ms_per_step"].append((t2 - t1) * 1e3 / steps)
        del c
    return walls, {k: float(np.median(v)) for k, v in walls.items()}


@torch.no_grad()
def phase_serve(dev) -> dict:
    """Falcon-Mamba-7B as published (bf16, 64 layers): 4 prompts of 2048
    tokens prefilled, 32 greedy decode steps, a forward over the extended
    sequences; launch counts per path, walls, memory; then one profiled
    prefill."""
    from repro_torch import configs
    from repro_torch.models import Model
    cfg = configs.get(MAMBA_ARCH)
    n_layers = cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    stats, counts, cache, first = serve_run(model, prompts, SERVE_DECODE,
                                            "mamba")
    for tag, n in (("mamba_prefill", n_layers), ("mamba_forward", n_layers),
                   ("mamba_decode", n_layers * SERVE_DECODE)):
        check_counts(f"serve {tag}", counts[tag],
                     dict(ssm_scan=n, causal_conv1d=n))
    walls, med = serve_walls(model, prompts, first, SERVE_DECODE,
                             SERVE_REPEATS)
    out = dict(
        layers=n_layers, d_model=cfg.d_model, d_inner=cfg.d_inner,
        state=cfg.ssm_state, vocab=cfg.vocab_size, dtype=cfg.dtype,
        batch=SERVE_BATCH, prompt=SERVE_PROMPT, decode_steps=SERVE_DECODE,
        init_s=init_s, weight_bytes=weight_bytes, **stats,
        tol=SERVE_TOL, walls=walls, median=med,
        prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT
        / (med["prefill_ms"] / 1e3),
        decode_tokens_per_s=SERVE_BATCH / (med["decode_ms_per_step"] / 1e3),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts)
    emit("serve", **out)
    finite, last = stats["finite"], stats["decode_vs_forward_last"]
    if not finite or last > SERVE_TOL:
        # the run fails at its end, after the trace and the kernels line
        FAILED.append(f"serve: finite={finite}, decode vs forward at the "
                      f"last position {last} > {SERVE_TOL}")

    traces = {}
    for tag, fn in (("mamba_prefill", lambda: model.prefill(prompts)),
                    ("mamba_decode", lambda: model.decode(cache, first))):
        trace, by_name = profiled(fn)
        busy = trace["device_busy_ms"]
        split = dict(conv_ms=0.0, ssm_scan_ms=0.0, gemm_ms=0.0,
                     rest_ms=0.0)
        for n, (ms, _) in by_name.items():
            key = ("conv_ms" if "causal_conv1d" in n else
                   "ssm_scan_ms" if "ssm_scan" in n else
                   "gemm_ms" if gemm_like(n) else "rest_ms")
            split[key] += ms
        traces[tag] = dict(trace, **split, **{
            k.replace("_ms", "_share"): v / busy for k, v in split.items()})
        # the port calls no library convolution: cuDNN is a yardstick only
        library_conv = [n for n in by_name if "conv" in n.lower()
                        and "causal_conv1d" not in n]
        if trace["convolution_ops"] or library_conv:
            raise AssertionError(f"serve {tag}: a library convolution ran: "
                                 f"{trace['convolution_ops']} ops, "
                                 f"kernels {library_conv}")
    emit("trace", **traces)
    return counts


def train_fixture(dev, scan: str) -> dict:
    """The reduced model of ``tests/data/torch_mamba_train.npz`` (JAX's
    weights, batch, loss and gradients) on ``dev``: the loss and every
    gradient leaf within MAMBA_TOL of JAX's, and one AdamW update (the
    launcher's defaults) on JAX's gradients within ADAMW_TOL of JAX's
    parameters.  The CPU test runs it too (``scan="auto"``)."""
    from repro_torch import configs, convert
    from repro_torch.optim import adamw
    data = np.load(ROOT / "tests" / "data" / "torch_mamba_train.npz")
    cfg = configs.get(MAMBA_ARCH).reduced()

    model = convert.model_from_numpy(cfg, _tree(data, "param/"), device=dev,
                                     scan=scan)
    batch = {k: torch.as_tensor(data[k], device=dev)
             for k in ("tokens", "labels")}
    loss, _ = model.loss(batch)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    out = {"loss": dict(rel_err=abs(float(loss.detach()) - float(data["loss"]))
                        / abs(float(data["loss"])), tol=MAMBA_TOL)}
    for key in data.files:
        if not key.startswith("grad/"):
            continue
        name = key[len("grad/"):]
        head, _, rest = name.partition(".")
        got = grads[name] if head != "groups" else torch.stack(
            [grads[f"groups.{i}.{rest}"] for i in range(cfg.n_layers)])
        out[key] = dict(rel_err=rel_err(got, torch.as_tensor(data[key],
                                                             device=dev)),
                        tol=MAMBA_TOL)
    # one AdamW update on JAX's gradients, from JAX's weights
    jgrads = convert.params_from_numpy(cfg, _tree(data, "grad/"), dev)
    init, update = adamw()
    update(jgrads, init(model), model)
    new = dict(model.named_parameters())
    for key in data.files:
        if not key.startswith("adamw/"):
            continue
        name = key[len("adamw/"):]
        head, _, rest = name.partition(".")
        got = new[name] if head != "groups" else torch.stack(
            [new[f"groups.{i}.{rest}"] for i in range(cfg.n_layers)])
        out[key] = dict(rel_err=rel_err(got.detach(), torch.as_tensor(
            data[key], device=dev)), tol=ADAMW_TOL)
    ok = all(r["rel_err"] <= r["tol"] for r in out.values())
    return dict(results=out, ok=ok, layers=cfg.n_layers, d_model=cfg.d_model,
                worst=max(out.items(), key=lambda kv: kv[1]["rel_err"]
                          / kv[1]["tol"])[0])


def _tree(data, prefix: str, decode=None) -> dict:
    """The nested tree of a fixture's ``<prefix><dotted name>`` entries,
    each passed through ``decode`` when given."""
    tree: dict = {}
    for key in data.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = data[key] if decode is None else decode(data[key])
    return tree


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _expect(layers: int, steps: int, remat: bool) -> dict:
    """Launches of a training run: per layer and step the two forward
    kernels (twice under remat: the backward runs each layer again) and
    the two backward kernels (two launches a call each); under remat
    kernel A runs on the segment states of the recompute's forward
    (``mamba_scan_bwd_ckpt``), without it on its own walk."""
    fwd = layers * steps * (2 if remat else 1)
    scan_bwd = "mamba_scan_bwd_ckpt" if remat else "mamba_scan_bwd"
    return {"ssm_scan": fwd, "causal_conv1d": fwd,
            scan_bwd: 2 * layers * steps,
            "causal_conv1d_bwd": 2 * layers * steps}


def _train_split(by_name: dict) -> dict:
    """Device ms of one training step by kernel group."""
    split = dict(gemm_ms=0.0, scan_fwd_ms=0.0, mamba_scan_bwd_ms=0.0,
                 conv_fwd_ms=0.0, conv_bwd_ms=0.0, rest_ms=0.0)
    for n, (ms, _) in by_name.items():
        key = ("mamba_scan_bwd_ms" if "mamba_scan_bwd" in n else
               "conv_bwd_ms" if ("causal_conv1d_silu_bwd" in n
                                 or "causal_conv1d_bwd" in n) else
               "conv_fwd_ms" if "causal_conv1d" in n else
               "scan_fwd_ms" if "ssm_scan" in n else
               "gemm_ms" if gemm_like(n) else "rest_ms")
        split[key] += ms
    return split


def _run_loop(model, opt, steps: int, data, ckpt_dir=None, every=None,
              record: list | None = None, extra: dict | None = None):
    """``steps`` of TrainLoop over ``data`` (with ``extra``, the
    cross-attention source, in every step); returns (the loop's result,
    per-step losses and gradient norms, the loop).  ``record`` receives
    each step's metrics as floats."""
    from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step
    step = make_train_step(model, opt)
    norms = []

    def recorded(params, state, batch, extra=None):
        out = step(params, state, batch, extra)
        norms.append(float(out[2]["grad_norm"]))
        if record is not None:
            record.append({k: float(v) for k, v in out[2].items()})
        return out

    loop = TrainLoop(TrainLoopConfig(
        total_steps=steps, log_every=1, ckpt_dir=ckpt_dir,
        ckpt_every=every or steps), recorded, model, opt[0](model))
    res = loop.run(data, extra)
    return res, [e["loss"] for e in res["log"]], norms, loop


def phase_train(dev) -> dict:
    """Training the Mamba family on the card: the JAX fixture; the full
    model (64 layers, bf16, remat) with Adafactor; AdamW at 32 layers; one
    full-width layer with the kernels against their plain versions; resume
    from a checkpoint.  Launches per path; failures are collected."""
    import itertools
    import shutil
    from repro_torch import configs
    from repro_torch.data import token_stream
    from repro_torch.models import Model
    from repro_torch.optim import adafactor, adamw
    from repro_torch.optim._tree import named_tensors
    from repro_torch.train import make_train_step
    launches, out = {}, {}
    torch.cuda.empty_cache()

    # 1. the JAX fixture on the kernels
    fx, launches["train_fixture"] = counted_call(
        lambda: train_fixture(dev, "cuda"))
    check_counts("train fixture", launches["train_fixture"],
                 _expect(4, 1, False))
    out["fixture"] = fx
    emit("train", part="fixture", launches=_nonzero(
        launches["train_fixture"]), **fx)
    if not fx["ok"]:
        FAILED.append(f"train fixture: {fx['worst']} off JAX's: "
                      f"{fx['results'][fx['worst']]}")

    # 2. the full model, Adafactor, through TrainLoop
    cfg = configs.get(MAMBA_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    data = token_stream(torch.Generator(device=dev).manual_seed(1),
                        cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    opt = adafactor()
    (res, losses, norms, loop), launches["train_adafactor"] = counted_call(
        lambda: _run_loop(model, opt, TRAIN_STEPS,
                          itertools.islice(data, TRAIN_STEPS)))
    check_counts("train adafactor", launches["train_adafactor"],
                 _expect(cfg.n_layers, TRAIN_STEPS, cfg.remat))
    secs = [e["sec_per_step"] for e in res["log"]]
    step_ms = float(np.median(secs[1:])) * 1e3
    full = dict(layers=cfg.n_layers, dtype=cfg.dtype, remat=cfg.remat,
                params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                optimizer="adafactor", steps=TRAIN_STEPS, losses=losses,
                grad_norms=norms, step_ms_each=[x * 1e3 for x in secs],
                step_ms=step_ms,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                stragglers=res["straggler_steps"])
    finite = all(np.isfinite(losses)) and all(np.isfinite(norms))
    # one batch, repeated: its loss must fall
    state = loop.opt_state
    step = make_train_step(model, opt)
    batch = next(data)
    repeat = []
    for _ in range(TRAIN_REPEAT):
        _, state, m = step(model, state, batch)
        repeat.append(float(m["loss"]))
    full["repeated_batch_losses"] = repeat
    falls = repeat[-1] < repeat[0]
    # one profiled step
    holder = {"state": state}

    def one_step():
        _, holder["state"], m = step(model, holder["state"], batch)
        return m

    trace, by_name = profiled(one_step)
    split = _train_split(by_name)
    busy = trace["device_busy_ms"]
    full["trace"] = dict(trace, **split, **{
        k.replace("_ms", "_share"): v / busy for k, v in split.items()})
    library_conv = [n for n in by_name if "conv" in n.lower()
                    and "causal_conv1d" not in n]
    out["adafactor"] = full
    emit("train", part="adafactor", launches=_nonzero(
        launches["train_adafactor"]), **full)
    if not finite or not falls:
        FAILED.append(f"train adafactor: finite={finite}, repeated-batch "
                      f"losses {repeat} do not fall")
    if trace["convolution_ops"] or library_conv:
        FAILED.append(f"train: a library convolution ran: {library_conv}")
    del model, loop, state, holder, step, opt
    torch.cuda.empty_cache()

    # 3. AdamW, the launcher's rule for 7B, at ADAMW_DEPTH layers
    cfg32 = dataclasses.replace(cfg, n_layers=ADAMW_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg32, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    opt = adamw()
    (res, losses, norms, _), launches["train_adamw"] = counted_call(
        lambda: _run_loop(model, opt, ADAMW_STEPS,
                          itertools.islice(data, ADAMW_STEPS)))
    check_counts("train adamw", launches["train_adamw"],
                 _expect(ADAMW_DEPTH, ADAMW_STEPS, cfg32.remat))
    secs = [e["sec_per_step"] for e in res["log"]]
    aw = dict(layers=ADAMW_DEPTH, of_layers=cfg.n_layers,
              params=sum(p.numel() for p in model.parameters()),
              optimizer="adamw", steps=ADAMW_STEPS, losses=losses,
              grad_norms=norms, step_ms_each=[x * 1e3 for x in secs],
              step_ms=float(np.median(secs[1:])) * 1e3,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              cut="32 of 64 layers: AdamW's float32 moments, bf16 weights "
              "and gradients at 64 layers need ~87 GB")
    out["adamw"] = aw
    emit("train", part="adamw", launches=_nonzero(launches["train_adamw"]),
         **aw)
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))):
        FAILED.append(f"train adamw: not finite: {losses}, {norms}")
    del model, opt
    torch.cuda.empty_cache()

    # 4. one full-width layer, float32: kernels against plain versions
    cfg1 = dataclasses.replace(cfg, n_layers=1, dtype="float32",
                               param_dtype="float32")
    m1 = Model(cfg1, device=dev,
               generator=torch.Generator(device=dev).manual_seed(SEED))
    tok = torch.Generator(device=dev).manual_seed(2)
    one = {k: torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), generator=tok,
                            device=dev) for k in ("tokens", "labels")}
    got = {}
    for scan in ("cuda", "reference"):
        m1.scan = scan

        def grads_of():
            loss, _ = m1.loss(one)
            named = dict(m1.named_parameters())
            return loss.detach(), dict(zip(named, torch.autograd.grad(
                loss, list(named.values()))))

        got[scan], launches[f"train_layer_{scan}"] = counted_call(grads_of)
    check_counts("train layer (cuda)", launches["train_layer_cuda"],
                 _expect(1, 1, cfg1.remat))
    check_counts("train layer (reference)", launches["train_layer_reference"],
                 {})
    rels = {"loss": rel_err(got["cuda"][0], got["reference"][0])}
    rels.update({name: rel_err(g, got["reference"][1][name])
                 for name, g in got["cuda"][1].items()})
    worst = max(rels, key=rels.get)
    out["layer"] = dict(rel_err=rels, worst=worst, tol=MAMBA_TOL)
    emit("train", part="layer_vs_plain", layers=1, batch=1, seq=TRAIN_SEQ,
         dtype="float32", tol=MAMBA_TOL, worst=worst,
         worst_rel_err=rels[worst], rel_err=rels)
    if rels[worst] > MAMBA_TOL:
        FAILED.append(f"train layer: {worst} kernel vs plain {rels[worst]} "
                      f"> {MAMBA_TOL}")
    del m1, got
    torch.cuda.empty_cache()

    # 5. resume: the reduced model, a checkpoint every 3 steps
    ckpt = ROOT / "build" / "train_resume_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    rcfg = configs.get(MAMBA_ARCH).reduced()

    def fresh():
        return Model(rcfg, device=dev, scan="cuda",
                     generator=torch.Generator(device=dev).manual_seed(SEED))

    def stream():
        return token_stream(torch.Generator(device=dev).manual_seed(3),
                            rcfg.vocab_size, 2, 64)

    m_a, opt = fresh(), adamw(lr=1e-3)
    _, _, _, loop_a = _run_loop(m_a, opt, RESUME_STEPS,
                                itertools.islice(stream(), RESUME_STEPS),
                                ckpt_dir=str(ckpt), every=3)
    m_b = fresh()
    from repro_torch.train import TrainLoop, TrainLoopConfig
    loop_b = TrainLoop(TrainLoopConfig(total_steps=RESUME_TOTAL,
                                       ckpt_dir=str(ckpt), ckpt_every=3),
                       make_train_step(m_b, opt), m_b, opt[0](m_b))
    same_params = all(torch.equal(a, b) for a, b in zip(
        named_tensors(m_a).values(), named_tensors(m_b).values()))
    from repro_torch.checkpoint import tree_leaves
    sa, sb = tree_leaves(loop_a.opt_state), tree_leaves(loop_b.opt_state)
    same_opt = len(sa) == len(sb) and all(torch.equal(a, b)
                                          for a, b in zip(sa, sb))
    after = loop_b.run(itertools.islice(stream(), RESUME_TOTAL))
    shutil.rmtree(ckpt, ignore_errors=True)
    res_ok = (loop_b.start_step == RESUME_STEPS and same_params and same_opt
              and type(loop_b.opt_state).__name__ == "AdamWState"
              and after["final_step"] == RESUME_TOTAL)
    out["resume"] = dict(start_step=loop_b.start_step, params_bitwise=same_params,
                         opt_state_bitwise=same_opt,
                         final_step=after["final_step"], ok=res_ok)
    emit("train", part="resume", **out["resume"])
    if not res_ok:
        FAILED.append(f"train resume: {out['resume']}")
    return launches


# ---------------------------------------------------------------- dense


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """The float32 values of bfloat16 bit patterns (uint16)."""
    return (a.astype(np.uint32) << 16).view(np.float32)


@torch.no_grad()
def dense_fixture(dev) -> dict:
    """The reduced Qwen2 and H2O-Danube3 of ``tests/data/torch_dense.npz``
    (JAX's weights, inputs and logits) on ``dev``: forward, prefill and
    decode logits within DENSE_TOL of JAX's, and H2O-Danube3's prompt
    beyond its window (its ring buffer wrapping) too.  The CPU test runs
    it as well."""
    from repro_torch import configs, convert
    data = np.load(DENSE_FIXTURE)
    results = {}
    for arch in DENSE_FIXTURE_ARCHS:
        cfg = configs.get(arch).reduced()
        model = convert.model_from_numpy(
            cfg, _tree(data, f"{arch}/param/", bf16_bits), device=dev)

        def arr(key):
            return torch.as_tensor(data[f"{arch}/{key}"], device=dev)

        got = {"forward": model(arr("tokens"))[0]}
        for run in ("", "long_"):
            if f"{arch}/{run}tokens" not in data.files:
                continue
            got[f"{run}prefill"], cache = model.prefill(arr(f"{run}tokens"))
            steps = []
            for tok in arr(f"{run}steps"):
                logits, cache = model.decode(cache, tok)
                steps.append(logits)
            got[f"{run}decode"] = torch.stack(steps)
        for key, t in got.items():
            rel = rel_err(t, arr(key))
            results[f"{arch}/{key}"] = dict(rel_err=rel, tol=DENSE_TOL,
                                            ok=rel <= DENSE_TOL)
    return dict(results=results, ok=all(r["ok"] for r in results.values()))


@torch.no_grad()
def fixture_run(dev, data, prefix: str, cfg,
                weights: str | None = None) -> dict:
    """A reduced model of a fixture (JAX's weights under ``<weights>param/``,
    ``weights`` the ``prefix`` unless given) on ``dev``: its forward
    (logits and aux) and, for each prompt the fixture has decode steps for
    (``tokens`` with ``steps``, ``long_tokens`` with ``long_steps``),
    prefill and decode logits, each against the fixture's within
    FIXTURE_TOL."""
    from repro_torch import convert
    model = convert.model_from_numpy(
        cfg, _tree(data, f"{prefix if weights is None else weights}param/",
                   bf16_bits), device=dev)

    def arr(key):
        return torch.as_tensor(data[f"{prefix}{key}"], device=dev)

    extra = {k: arr(k) for k in ("enc_frames", "image_embeds")
             if f"{prefix}{k}" in data.files}
    got = dict(zip(("forward", "aux"), model(arr("tokens"), extra)))
    for run in ("", "long_"):
        if f"{prefix}{run}steps" not in data.files:
            continue
        got[f"{run}prefill"], cache = model.prefill(arr(f"{run}tokens"),
                                                    extra)
        steps = []
        for tok in arr(f"{run}steps"):
            logits, cache = model.decode(cache, tok)
            steps.append(logits)
        got[f"{run}decode"] = torch.stack(steps)
    out = {}
    for key, t in got.items():
        if f"{prefix}{key}" in data.files:
            rel = rel_err(t, arr(key))
            out[key] = dict(rel_err=rel, tol=FIXTURE_TOL,
                            ok=rel <= FIXTURE_TOL)
    return out


def moe_fixture(dev) -> dict:
    """The reduced Mixtral (1 layer: drop-free, and at capacity_factor 0.5
    with choices dropped) and Kimi-K2 (1 layer, its shared expert) of
    ``tests/data/torch_moe.npz`` on ``dev``: logits and aux within
    FIXTURE_TOL of JAX's.  The CPU test runs it as well."""
    from repro_torch import configs
    data = np.load(MOE_FIXTURE)
    results = {}
    for arch, layers in MOE_FIXTURE_LAYERS.items():
        cfg = dataclasses.replace(configs.get(arch).reduced(),
                                  n_layers=layers)
        for key, r in fixture_run(dev, data, f"{arch}/", cfg).items():
            results[f"{arch}/{key}"] = r
    arch = "mixtral-8x7b"
    tight = dataclasses.replace(configs.get(arch).reduced(),
                                n_layers=MOE_FIXTURE_LAYERS[arch],
                                capacity_factor=0.5)
    for key, r in fixture_run(dev, data, f"{arch}/tight_", tight,
                              weights=f"{arch}/").items():
        results[f"{arch}/tight_{key}"] = r
    return dict(results=results, ok=all(r["ok"] for r in results.values()))


def hybrid_fixture(dev) -> dict:
    """The reduced RecurrentGemma-2B at 5 layers (one group and a tail of
    two RG-LRU sublayers) of ``tests/data/torch_hybrid.npz`` on ``dev``:
    forward, prefill and decode logits within FIXTURE_TOL of JAX's, also
    for a prompt beyond its local window of 32.  The CPU test runs it as
    well."""
    from repro_torch import configs
    data = np.load(HYBRID_FIXTURE)
    cfg = dataclasses.replace(configs.get(HYBRID_ARCH).reduced(),
                              n_layers=HYBRID_FIXTURE_LAYERS)
    results = fixture_run(dev, data, "", cfg)
    return dict(results=results, ok=all(r["ok"] for r in results.values()))


def cross_fixture(dev, family: str) -> dict:
    """The reduced Whisper-base (2 encoder, 4 decoder layers, 40 frames) or
    Llama-3.2-Vision (2 groups, 16 image tokens) of
    ``tests/data/torch_<family>.npz`` on ``dev``, gates and norm scales
    drawn: forward, prefill and decode logits within FIXTURE_TOL of JAX's.
    The CPU test runs it as well."""
    from repro_torch import configs
    data = np.load(CROSS_FIXTURES[family])
    cfg = configs.get(CROSS_ARCHS[family]).reduced()
    results = fixture_run(dev, data, "", cfg)
    return dict(results=results, ok=all(r["ok"] for r in results.values()))


def fixture_phase(name: str, fn, dev) -> None:
    res, counts = counted_call(lambda: fn(dev))
    emit(name, launches=_nonzero(counts), **res)
    check_counts(name, counts, {})
    if not res["ok"]:
        FAILED.append(f"{name}: off JAX's: {res['results']}")


def phase_dense_fixture(dev) -> None:
    res, counts = counted_call(lambda: dense_fixture(dev))
    emit("dense_fixture", launches=_nonzero(counts), **res)
    check_counts("dense_fixture", counts, {})
    if not res["ok"]:
        FAILED.append(f"dense_fixture: off JAX's: {res['results']}")


def attention_split(trace: dict, by_name: dict) -> dict:
    """Device ms of a profiled dense run: the port's attention
    (``flash_attention``'s range and its backward's node: its float32
    chunk products, and the rest of it: masks, softmax, casts, layout
    copies), the other GEMMs and the rest; each also as a share of the
    busy time."""
    inside = trace.pop("ranges")
    att_gemm = sum(ms for n, ms in inside.items() if gemm_like(n))
    split = dict(attention_ms=sum(inside.values()),
                 attention_products_ms=att_gemm,
                 attention_other_ms=sum(inside.values()) - att_gemm,
                 gemm_ms=sum(ms for n, (ms, _) in by_name.items()
                             if gemm_like(n)) - att_gemm)
    split["rest_ms"] = (sum(ms for ms, _ in by_name.values())
                        - split["attention_ms"] - split["gemm_ms"])
    busy = trace["device_busy_ms"]
    return dict(split, **{k.replace("_ms", "_share"): split[k] / busy
                          for k in ("attention_ms", "gemm_ms", "rest_ms")})


def attention_yardstick(dev, cfg, batch: int, seq: int) -> dict:
    """One layer's attention at a prefill's shapes (bf16, causal): the
    port's ``flash_attention`` against ``scaled_dot_product_attention``
    (the library's, timed here only as the yardstick for later work; it
    never runs on the path), CUDA events, mean of YARDSTICK_REPEATS;
    max |Δ| / max |port| between them."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = (torch.randn((batch, seq, n, hd), generator=gen, device=dev,
                           dtype=torch.bfloat16) for n in (h, kv, kv))
    if cfg.sliding_window and cfg.sliding_window < seq:
        raise ValueError("the yardstick times attention the window does "
                         "not bind on")

    def port():
        return layers.flash_attention(q, k, v, causal=True,
                                      window=cfg.sliding_window,
                                      chunk=cfg.attn_chunk)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    ms = timed_ms(port, YARDSTICK_REPEATS)
    lib_ms = timed_ms(library, YARDSTICK_REPEATS)
    # causal: half of the QKᵀ and PV products' 4 · B · H · S² · hd
    flops = 2 * batch * h * seq * seq * hd
    return dict(port_ms=ms, library_ms=lib_ms, library_over_port=lib_ms / ms,
                causal_flops=flops, port_tflop_s=flops / ms / 1e9,
                library_tflop_s=flops / lib_ms / 1e9,
                library_vs_port=rel_err(library(), port()),
                shape=[batch, seq, h, kv, hd], chunk=cfg.attn_chunk)


@torch.no_grad()
def dense_serve(dev, arch: str, batch: int, prompt: int, repeats: int,
                profile: bool) -> dict:
    """One dense configuration as published (bf16, seeded weights):
    ``batch`` prompts of ``prompt`` tokens, SERVE_DECODE greedy decodes, a
    forward over the extended sequences (:func:`serve_run`); every path
    launching none of the port's kernels; walls, memory, the bytes each
    decode step copies (decode keeps the cache it is given: every layer's
    k and v cloned, one slot replaced); with ``profile``, one profiled
    prefill (:func:`attention_split`), one profiled decode step (its
    device busy time and idle share) and the attention's yardstick."""
    from repro_torch import configs
    from repro_torch.models import Model
    cfg = configs.get(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Model(cfg, device=dev, generator=gen)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=dev)
    stats, counts, cache, first = serve_run(model, prompts, SERVE_DECODE,
                                            "dense")
    cache_bytes = sum(t.numel() * t.element_size()
                      for c in cache["groups"] for t in c.values())
    walls, med = serve_walls(model, prompts, first, SERVE_DECODE, repeats)
    out = dict(
        arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, window=cfg.sliding_window,
        qkv_bias=cfg.qkv_bias, dtype=cfg.dtype, batch=batch, prompt=prompt,
        decode_steps=SERVE_DECODE, weight_bytes=weight_bytes,
        cache_slots=cache["groups"][0]["k"].shape[1], cache_bytes=cache_bytes,
        decode_cache_copy_bytes_per_step=cache_bytes, **stats,
        tol=SERVE_TOL, walls=walls, median=med,
        prefill_tokens_per_s=batch * prompt / (med["prefill_ms"] / 1e3),
        decode_tokens_per_s=batch / (med["decode_ms_per_step"] / 1e3),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches={k: _nonzero(v) for k, v in counts.items()})
    for tag, n in counts.items():
        check_counts(f"{arch} {tag}", n, {})
    if profile:
        trace, by_name = profiled(lambda: model.prefill(prompts),
                                  ranges=(ATTENTION_RANGE,))
        out["trace"] = dict(trace, **attention_split(trace, by_name))
        out["trace_decode"] = profiled(lambda: model.decode(cache, first))[0]
        out["yardstick"] = attention_yardstick(dev, cfg, batch, prompt)
        out["yardstick"]["port_ms_all_layers"] = \
            out["yardstick"]["port_ms"] * cfg.n_layers
    del model, cache, first
    torch.cuda.empty_cache()
    if not stats["finite"] or stats["decode_vs_forward_last"] > SERVE_TOL:
        FAILED.append(f"dense_serve {arch} ({batch} × {prompt}): finite="
                      f"{stats['finite']}, decode vs forward at the last "
                      f"position {stats['decode_vs_forward_last']} > "
                      f"{SERVE_TOL}")
    return out


def phase_dense_serve(dev) -> None:
    """Each dense configuration as published, SERVE_BATCH prompts of
    SERVE_PROMPT tokens, profiled; then H2O-Danube3 with one prompt of
    LONG_PROMPT tokens, beyond its window."""
    for arch in DENSE_ARCHS:
        emit("dense_serve", **dense_serve(dev, arch, SERVE_BATCH,
                                          SERVE_PROMPT, SERVE_REPEATS, True))
    emit("dense_serve", part="beyond_window", **dense_serve(
        dev, WINDOWED_ARCH, 1, LONG_PROMPT, 1, False))


def phase_dense_train(dev) -> None:
    """Qwen2-1.5B as published (bf16, remat) with the launcher's optimizer
    (AdamW below 3e11 parameters), TRAIN_BATCH × TRAIN_SEQ tokens of
    ``token_stream``, DENSE_TRAIN_STEPS through ``TrainLoop``: losses and
    gradient norms finite, the parameters moving, step ms (median of all
    but the first), tokens/s, peak memory, no launch of the port's
    kernels; one profiled step (:func:`attention_split`)."""
    import itertools
    from repro_torch import configs
    from repro_torch.data import token_stream
    from repro_torch.models import Model
    from repro_torch.optim import adafactor, adamw
    from repro_torch.train import make_train_step
    cfg = configs.get(DENSE_TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    named = dict(model.named_parameters())
    watched = ("embed", "groups.0.attn.wq", "groups.0.attn.bq",
               f"groups.{cfg.n_layers - 1}.mlp.wo", "lm_head")
    before = {n: named[n].detach().clone() for n in watched}
    opt = adafactor() if cfg.n_params() > 3e11 else adamw()
    data = token_stream(torch.Generator(device=dev).manual_seed(1),
                        cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    (res, losses, norms, loop), counts = counted_call(
        lambda: _run_loop(model, opt, DENSE_TRAIN_STEPS,
                          itertools.islice(data, DENSE_TRAIN_STEPS)))
    moved = {n: float((named[n].detach() - before[n]).abs().max())
             for n in watched}
    secs = [e["sec_per_step"] for e in res["log"]]
    step_ms = float(np.median(secs[1:])) * 1e3
    out = dict(arch=DENSE_TRAIN_ARCH, layers=cfg.n_layers, dtype=cfg.dtype,
               remat=cfg.remat, params=sum(p.numel() for p in
                                           model.parameters()),
               optimizer=type(loop.opt_state).__name__, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, steps=DENSE_TRAIN_STEPS, losses=losses,
               grad_norms=norms, moved=moved,
               step_ms_each=[x * 1e3 for x in secs], step_ms=step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=_nonzero(counts))
    check_counts("dense_train", counts, {})
    step = make_train_step(model, opt)
    batch = next(data)
    holder = {"state": loop.opt_state}

    def one_step():
        _, holder["state"], m = step(model, holder["state"], batch)
        return m

    trace, by_name = profiled(one_step, ranges=(ATTENTION_RANGE,
                                                ATTENTION_BWD))
    out["trace"] = dict(trace, **attention_split(trace, by_name))
    emit("dense_train", **out)
    finite = all(np.isfinite(losses)) and all(np.isfinite(norms))
    if not finite or not all(v > 0 for v in moved.values()):
        FAILED.append(f"dense_train: finite={finite}, moved={moved}")
    del model, loop, holder, step, opt, named, before
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- MoE, hybrid


def range_split(trace: dict, by_name: dict, ranges: dict) -> dict:
    """Device ms of a profiled run split by profiler range (``ranges``:
    key → range name, as :func:`profiled` with ``split`` gives them), the
    GEMMs outside every range and the rest; each also as a share of the
    busy time."""
    inside = trace.pop("ranges")
    split = {f"{key}_ms": sum(inside[name].values())
             for key, name in ranges.items()}
    in_gemm = sum(ms for r in inside.values() for n, ms in r.items()
                  if gemm_like(n))
    split["gemm_ms"] = sum(ms for n, (ms, _) in by_name.items()
                           if gemm_like(n)) - in_gemm
    split["rest_ms"] = sum(ms for ms, _ in by_name.values()) - sum(
        split.values())
    busy = trace["device_busy_ms"]
    return dict(split, **{k.replace("_ms", "_share"): v / busy
                          for k, v in list(split.items())})


MOE_RANGES = {"attention": ATTENTION_RANGE, "experts": "moe_experts",
              "route": "moe_route"}
HYBRID_RANGES = {"attention": ATTENTION_RANGE, "recurrence": RGLRU_RANGE,
                 "conv": "rglru_conv"}
# a training step's: the backward nodes of attention and the recurrence too
HYBRID_TRAIN_RANGES = dict(HYBRID_RANGES, attention_bwd=ATTENTION_BWD,
                           recurrence_bwd="_LinearRecurrenceBackward")


def per_call(stats: list, layers: int) -> list:
    """Routing records (``blocks.routing_stats``, one per MoE layer and
    call) summed per call of ``layers`` layers: [(dropped (token, choice)
    pairs, experts used, each summed over the layers)]."""
    rows = [(int(r["dropped"]), int(r["used"])) for r in stats]
    return [tuple(sum(v) for v in zip(*rows[i:i + layers]))
            for i in range(0, len(rows), layers)]


def routing_flips(stats: list, layers: int, prompt: int, k: int) -> list:
    """For one sequence served as :func:`serve_run` serves it (records of
    the prefill, each decode step, the forward): per position from the
    prefill's last, the layers whose serving call chose other experts than
    the forward at that position, each with the forward's router margin
    there (its k-th largest logit minus its (k+1)-th) and ``drift``, the
    largest change of any router logit between the two.  Two experts'
    ranks can swap only when their gap is at most twice that drift."""
    calls = [stats[i:i + layers] for i in range(0, len(stats), layers)]
    fwd = calls[-1]
    served = [(calls[0], prompt - 1)] + [(c, 0) for c in calls[1:-1]]
    out = []
    for j, (call, row) in enumerate(served):
        flips = []
        for layer, (mine, ref) in enumerate(zip(call, fwd)):
            q = prompt - 1 + j
            if set(mine["topi"][row].tolist()) == set(ref["topi"][q]
                                                       .tolist()):
                continue
            top = ref["logits"][q].topk(k + 1).values
            flips.append(dict(layer=layer, margin=float(top[k - 1] - top[k]),
                              drift=float((mine["logits"][row]
                                           - ref["logits"][q]).abs().max())))
        out.append(flips)
    return out


@torch.no_grad()
def moe_serve(dev, arch: str, layers: int) -> None:
    """One MoE configuration at its published widths, ``layers`` deep (bf16,
    seeded, published capacity): SERVE_BATCH prompts of SERVE_PROMPT
    tokens, SERVE_DECODE greedy decodes and the forward (:func:`serve_run`;
    decode against forward reported, not held: at capacity_factor 1.25 a
    decode step of 4 tokens drops choices the forward keeps); dropped pairs
    per prefill, decode step and forward; walls, memory; the expert bytes a
    decode step reads (every expert: the reference's einsum over all E)
    against its time and against the active experts' bytes; a profiled
    prefill (:func:`range_split`) and a profiled decode step.  Then
    ``moe_consistency``: the same weights at drop-free capacity
    (capacity_factor = E), one prompt of MOE_CONSISTENCY_PROMPT tokens,
    CONSISTENCY_DECODE decodes, nothing dropped, and every position whose
    experts are the forward's in every layer within SERVE_TOL of the
    forward.  A position where a layer chose other experts than the
    forward is reported, not held to SERVE_TOL (one swapped expert changes
    the layer's output wholesale); each such swap must be one the router
    logits' drift between the two can make (:func:`routing_flips`)."""
    from repro_torch import configs
    from repro_torch.models import Model, blocks
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Model(cfg, device=dev, generator=gen)
    named = dict(model.named_parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in named.values())
    expert_bytes = sum(p.numel() * p.element_size() for n, p in named.items()
                       if n.endswith((".moe.wi", ".moe.wg", ".moe.wo")))
    expert_one = expert_bytes / (layers * cfg.n_experts)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    with blocks.routing_stats() as st:
        stats, counts, cache, first = serve_run(model, prompts, SERVE_DECODE,
                                                "moe")
    calls = per_call(st, layers)       # prefill, the decodes, the forward
    del st
    dec = calls[1:-1]
    walls, med = serve_walls(model, prompts, first, SERVE_DECODE,
                             SERVE_REPEATS)
    peaks = peaks_for(torch.cuda.get_device_name(0))
    step_ms = med["decode_ms_per_step"]
    active_bytes = float(np.mean([used for _, used in dec])) * expert_one
    out = dict(
        arch=arch, layers=layers, published_layers=configs.get(arch).n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        experts=cfg.n_experts, top_k=cfg.top_k, moe_d_ff=cfg.moe_d_ff,
        shared_experts=cfg.n_shared_experts, window=cfg.sliding_window,
        capacity_factor=cfg.capacity_factor, dtype=cfg.dtype,
        batch=SERVE_BATCH, prompt=SERVE_PROMPT, decode_steps=SERVE_DECODE,
        capacity_prefill=int(SERVE_BATCH * SERVE_PROMPT * cfg.top_k
                             / cfg.n_experts * cfg.capacity_factor) + 1,
        capacity_decode=int(SERVE_BATCH * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor) + 1,
        weight_bytes=weight_bytes, expert_bytes=expert_bytes,
        dropped_prefill=calls[0][0], dropped_forward=calls[-1][0],
        dropped_decode_per_step=[d for d, _ in dec],
        choices_prefill=SERVE_BATCH * SERVE_PROMPT * cfg.top_k * layers,
        choices_decode_step=SERVE_BATCH * cfg.top_k * layers,
        experts_used_decode_mean=float(np.mean([u for _, u in dec])) / layers,
        **stats, walls=walls, median=med,
        prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT
        / (med["prefill_ms"] / 1e3),
        decode_tokens_per_s=SERVE_BATCH / (step_ms / 1e3),
        decode_expert_bound_ms=expert_bytes / peaks["bw"] * 1e3,
        decode_active_bound_ms=active_bytes / peaks["bw"] * 1e3,
        decode_expert_bytes_per_s=expert_bytes / (step_ms / 1e3),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches={k: _nonzero(v) for k, v in counts.items()})
    for tag, n in counts.items():
        check_counts(f"{arch} {tag}", n, {})
    trace, by_name = profiled(lambda: model.prefill(prompts),
                              ranges=tuple(MOE_RANGES.values()), split=True)
    out["trace"] = dict(trace, **range_split(trace, by_name, MOE_RANGES))
    out["trace_decode"] = profiled(lambda: model.decode(cache, first))[0]
    emit("moe_serve", **out)
    if not stats["finite"]:
        FAILED.append(f"moe_serve {arch}: logits not finite")
    del cache, first, prompts
    torch.cuda.empty_cache()

    # drop-free: the same weights, capacity_factor = E
    free = Model(dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts)), device=dev, params={n: p.detach() for n, p in
                                             named.items()})
    del model, named
    prompt = torch.randint(0, cfg.vocab_size,
                           (1, MOE_CONSISTENCY_PROMPT[arch]), generator=gen,
                           device=dev)
    with blocks.routing_stats() as st:
        stats, counts, _, _ = serve_run(free, prompt, CONSISTENCY_DECODE,
                                        "moe_consistency", each=True)
    dropped = sum(d for d, _ in per_call(st, layers))
    flips = routing_flips(st, layers, prompt.shape[1], cfg.top_k)
    del st
    each = stats["decode_vs_forward_each"]
    same = [e for e, f in zip(each, flips) if not f]
    unexplained = [f for fl in flips for f in fl
                   if f["margin"] > 2 * f["drift"]]
    ok = (stats["finite"] and dropped == 0 and not unexplained
          and max(same, default=0.0) <= SERVE_TOL)
    emit("moe_consistency", arch=arch, layers=layers,
         capacity_factor=float(cfg.n_experts), prompt=prompt.shape[1],
         decode_steps=CONSISTENCY_DECODE, dropped=dropped, tol=SERVE_TOL,
         **stats, flips=flips, positions_flipped=len(each) - len(same),
         same_routing_max=max(same, default=None),
         flipped_max=max((e for e, f in zip(each, flips) if f),
                         default=None),
         unexplained_flips=unexplained,
         launches={k: _nonzero(v) for k, v in counts.items()}, ok=ok)
    for tag, n in counts.items():
        check_counts(f"{arch} {tag}", n, {})
    if not ok:
        FAILED.append(f"moe_consistency {arch}: dropped {dropped}, decode "
                      f"vs forward at same-routed positions {same} (tol "
                      f"{SERVE_TOL}), flips not explained by the router's "
                      f"drift {unexplained}, finite {stats['finite']}")
    del free
    torch.cuda.empty_cache()


def lm_train(dev, cfg, batch: int, steps: int, watched: tuple,
             ranges: dict | None = None, reported: tuple = ()) -> dict:
    """``cfg`` as given (bf16, remat, seeded; cross-attention gates
    opened, :func:`open_gates`) with the launcher's optimizer (AdamW below
    3e11 parameters), ``batch`` × TRAIN_SEQ tokens of ``token_stream`` and,
    for the audio and VLM families, the launcher's ``cross_source`` as
    ``extra``, ``steps`` through ``TrainLoop``: every step's
    metrics, the ``watched`` parameters' largest change (``params_moved``:
    all of them moved) and the ``reported`` ones', step ms (median of all
    but the first), tokens/s, peak memory, no launch of the port's
    kernels; with ``ranges`` one profiled step (:func:`range_split`)."""
    import itertools
    from repro_torch.data import cross_source, token_stream
    from repro_torch.models import Model
    from repro_torch.optim import adafactor, adamw
    from repro_torch.train import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    open_gates(model)
    named = dict(model.named_parameters())
    before = {n: named[n].detach().clone() for n in watched + reported}
    opt = adafactor() if cfg.n_params() > 3e11 else adamw()
    data = token_stream(torch.Generator(device=dev).manual_seed(1),
                        cfg.vocab_size, batch, TRAIN_SEQ)
    extra = cross_source(cfg, torch.Generator(device=dev).manual_seed(2),
                         batch, TRAIN_SEQ)
    metrics: list = []
    (res, losses, norms, loop), counts = counted_call(
        lambda: _run_loop(model, opt, steps, itertools.islice(data, steps),
                          record=metrics, extra=extra))
    moved = {n: float((named[n].detach() - before[n]).abs().max())
             for n in watched + reported}
    secs = [e["sec_per_step"] for e in res["log"]]
    step_ms = float(np.median(secs[1:])) * 1e3
    out = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
               remat=cfg.remat, params=sum(p.numel() for p in
                                           model.parameters()),
               optimizer=type(loop.opt_state).__name__, batch=batch,
               seq=TRAIN_SEQ, steps=steps, losses=losses, grad_norms=norms,
               aux=[m["aux"] for m in metrics], moved=moved,
               step_ms_each=[x * 1e3 for x in secs], step_ms=step_ms,
               tokens_per_s=batch * TRAIN_SEQ / (step_ms / 1e3),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               source={k: list(v.shape) for k, v in (extra or {}).items()},
               launches=_nonzero(counts))
    check_counts(f"{cfg.name} train", counts, {})
    if ranges:
        step = make_train_step(model, opt)
        nxt = next(data)
        holder = {"state": loop.opt_state}

        def one_step():
            _, holder["state"], m = step(model, holder["state"], nxt, extra)
            return m

        trace, by_name = profiled(one_step, ranges=tuple(ranges.values()),
                                  split=True)
        out["trace"] = dict(trace, **range_split(trace, by_name, ranges))
        del step, holder
    out["finite"] = bool(all(np.isfinite(losses)) and all(np.isfinite(norms))
                         and all(np.isfinite(out["aux"])))
    out["params_moved"] = all(moved[n] > 0 for n in watched)
    del model, loop, opt, named, before
    torch.cuda.empty_cache()
    return out


def phase_moe_train(dev) -> None:
    """Mixtral-8x7B at its published widths cut to MOE_TRAIN_LAYERS layers
    (6.3 GB of bf16 weights), MOE_TRAIN_STEPS steps of TRAIN_BATCH ×
    TRAIN_SEQ: losses, aux (finite and > 0) and gradient norms finite, the
    router and every expert leaf moving."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(MOE_TRAIN_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    watched = ("embed", "lm_head", "groups.0.attn.wq") + tuple(
        f"groups.{i}.moe.{leaf}" for i in range(MOE_TRAIN_LAYERS)
        for leaf in ("router", "wi", "wg", "wo"))
    out = lm_train(dev, cfg, TRAIN_BATCH, MOE_TRAIN_STEPS, watched)
    emit("moe_train", published_layers=configs.get(MOE_TRAIN_ARCH).n_layers,
         **out)
    if not (out["finite"] and out["params_moved"]
            and all(a > 0 for a in out["aux"])):
        FAILED.append(f"moe_train: finite={out['finite']}, aux={out['aux']}, "
                      f"moved={out['moved']}")


@torch.no_grad()
def hybrid_serve(dev, batch: int, prompt: int, repeats: int,
                 profile: bool) -> dict:
    """RecurrentGemma-2B as published (26 layers: 8 groups of two RG-LRU
    sublayers and a local-attention layer, a tail of two; bf16, seeded):
    ``batch`` prompts of ``prompt`` tokens, SERVE_DECODE greedy decodes
    and the forward (:func:`serve_run`), decode against forward at the last
    position within SERVE_TOL; walls, memory; with ``profile`` a profiled
    prefill (:func:`range_split`) and a profiled decode step."""
    from repro_torch import configs
    from repro_torch.models import Model
    cfg = configs.get(HYBRID_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Model(cfg, device=dev, generator=gen)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=dev)
    stats, counts, cache, first = serve_run(model, prompts, SERVE_DECODE,
                                            "hybrid")
    walls, med = serve_walls(model, prompts, first, SERVE_DECODE, repeats)
    out = dict(
        arch=HYBRID_ARCH, layers=cfg.n_layers, groups=len(cache["groups"]),
        tail=len(cache.get("tail", ())), d_model=cfg.d_model,
        lru_width=cfg.lru_width_, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, local_window=cfg.local_window,
        vocab=cfg.vocab_size, dtype=cfg.dtype, batch=batch, prompt=prompt,
        decode_steps=SERVE_DECODE, weight_bytes=weight_bytes,
        ring_slots=cache["groups"][0]["attn"]["k"].shape[1], **stats,
        tol=SERVE_TOL, walls=walls, median=med,
        prefill_tokens_per_s=batch * prompt / (med["prefill_ms"] / 1e3),
        decode_tokens_per_s=batch / (med["decode_ms_per_step"] / 1e3),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches={k: _nonzero(v) for k, v in counts.items()})
    for tag, n in counts.items():
        check_counts(f"{HYBRID_ARCH} {tag}", n, {})
    if profile:
        trace, by_name = profiled(lambda: model.prefill(prompts),
                                  ranges=tuple(HYBRID_RANGES.values()),
                                  split=True)
        out["trace"] = dict(trace, **range_split(trace, by_name,
                                                 HYBRID_RANGES))
        out["trace_decode"] = profiled(lambda: model.decode(cache, first))[0]
    del model, cache, first
    torch.cuda.empty_cache()
    if not stats["finite"] or stats["decode_vs_forward_last"] > SERVE_TOL:
        FAILED.append(f"hybrid_serve ({batch} × {prompt}): finite="
                      f"{stats['finite']}, decode vs forward at the last "
                      f"position {stats['decode_vs_forward_last']} > "
                      f"{SERVE_TOL}")
    return out


def phase_hybrid_serve(dev) -> None:
    """SERVE_BATCH prompts of SERVE_PROMPT tokens (they fill the 2048-slot
    ring buffer, so the first decode wraps it), profiled; then one prompt
    of LONG_PROMPT tokens, beyond the window."""
    emit("hybrid_serve", **hybrid_serve(dev, SERVE_BATCH, SERVE_PROMPT,
                                        SERVE_REPEATS, True))
    emit("hybrid_serve", part="beyond_window",
         **hybrid_serve(dev, 1, LONG_PROMPT, 1, False))


def phase_hybrid_train(dev) -> None:
    """RecurrentGemma-2B as published, HYBRID_TRAIN_STEPS steps of
    HYBRID_TRAIN_BATCH × TRAIN_SEQ, one profiled step."""
    from repro_torch import configs
    from repro_torch.models.model import stack_sizes
    cfg = configs.get(HYBRID_ARCH)
    sizes = stack_sizes(cfg)
    watched = ("embed", "lm_head", "groups.0.rnn.0.mix.w_rec",
               "groups.0.rnn.0.mix.w_input", "groups.0.rnn.1.mix.conv_w",
               "groups.0.attn.wq", f"groups.{sizes['groups'] - 1}.amlp.wo"
               ) + tuple(f"tail.{i}.mix.wx" for i in range(sizes.get("tail",
                                                                     0)))
    # λ (about -4 to -8) is reported, not required to move: an AdamW step
    # of ~lr = 3e-4 is below half a bf16 ulp there (2⁻⁶ to 2⁻⁵)
    out = lm_train(dev, cfg, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_STEPS, watched,
                   HYBRID_TRAIN_RANGES, reported=("groups.0.rnn.0.mix.lam",))
    emit("hybrid_train", **out)
    if not (out["finite"] and out["params_moved"]):
        FAILED.append(f"hybrid_train: finite={out['finite']}, "
                      f"moved={out['moved']}")


# ---------------------------------------------------------------- audio, VLM


def open_gates(model) -> None:
    """Each cross-attention gate drawn from U(0.5, 1) (seeded): the
    reference initialises them to 0, where tanh(gate) = 0 and the logits
    ignore the source.  No-op for the families without gates."""
    gen = torch.Generator(device=model.device).manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gate"):
                p.copy_(0.5 + 0.5 * torch.rand((), generator=gen,
                                               device=p.device))


def cross_cache_check(model, cache, first) -> dict:
    """One decode step from ``cache``: the cross k and v it returns are the
    given tensors (same ``data_ptr``), unchanged bit for bit, and no
    operation of the step made a tensor of their shape and dtype (a clone
    or a copy).  Tensors of their shape in another dtype (decode_attention
    reads the cache through a float32 cast, written once a step) are
    counted apart, with their bytes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    given = [t for g in cache["groups"] for t in (g["cross"]["k"],
                                                  g["cross"]["v"])]
    kept = [t.clone() for t in given]
    shape, dtype = given[0].shape, given[0].dtype
    made = dict(copies=0, casts=0, cast_bytes=0)

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.shape == shape:
                    if t.dtype == dtype:
                        made["copies"] += 1
                    else:
                        made["casts"] += 1
                        made["cast_bytes"] += t.numel() * t.element_size()
            return out

    with Watch():
        _, nxt = model.decode(cache, first)
    got = [t for g in nxt["groups"] for t in (g["cross"]["k"],
                                              g["cross"]["v"])]
    same = all(a.data_ptr() == b.data_ptr() for a, b in zip(got, given))
    unchanged = all(torch.equal(a, b) for a, b in zip(given, kept))
    return dict(tensors=len(given), bytes=sum(t.numel() * t.element_size()
                                              for t in given),
                same_data_ptr=same, unchanged=unchanged, **made,
                ok=same and unchanged and made["copies"] == 0)


@torch.no_grad()
def float32_consistency(dev, cfg, params: dict, prompts, extra,
                        tag: str) -> dict:
    """``cfg`` in float32 (activations and parameters) on ``params`` (the
    served weights cast to float32; the dict is emptied, so that the
    weights go with the model), the same prompts and source:
    CONSISTENCY_DECODE greedy decodes and the forward (:func:`serve_run`),
    decode against forward at every position within F32_SERVE_TOL."""
    from repro_torch.models import Model
    wide = Model(dataclasses.replace(cfg, dtype="float32",
                                     param_dtype="float32"),
                 device=dev, params=params)
    params.clear()
    stats, counts, cache, _ = serve_run(
        wide, prompts, CONSISTENCY_DECODE, tag, each=True,
        extra={k: v.float() for k, v in extra.items()})
    for name, n in counts.items():
        check_counts(name, n, {})
    del wide, cache
    torch.cuda.empty_cache()
    worst = stats["decode_vs_forward_max"]
    return dict(stats, decode_steps=CONSISTENCY_DECODE, tol=F32_SERVE_TOL,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches={k: _nonzero(v) for k, v in counts.items()},
                ok=stats["finite"] and worst <= F32_SERVE_TOL)


@torch.no_grad()
def cross_serve(dev, family: str, batch: int, prompt: int, n_src: int,
                repeats: int) -> dict:
    """Whisper-base or Llama-3.2-Vision-11B as published (bf16, seeded,
    gates opened): ``batch`` prompts of ``prompt`` tokens over ``n_src``
    encoder frames or image embeddings (seeded normal), SERVE_DECODE greedy
    decodes and the forward (:func:`serve_run`), decode against forward at
    the last position held within the family's BF16_SERVE_TOL; every path
    launching none of
    the port's kernels; walls, memory; the logits' response to another
    source (max |Δ| / max |logits| of the prefill's); the cross cache
    through a decode step (:func:`cross_cache_check`); a profiled prefill
    and decode step split into the encoder, the cross-attention, the
    self-attention, the other GEMMs and the rest (:func:`range_split`,
    each kernel under its outermost range); last the same weights in
    float32 (:func:`float32_consistency`; for Llama-3.2-Vision-11B 40.4 GB,
    beside the bf16 copy while it is cast)."""
    from repro_torch import configs
    from repro_torch.models import Model
    arch = CROSS_ARCHS[family]
    cfg = configs.get(arch)
    key = "enc_frames" if family == "audio" else "image_embeds"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Model(cfg, device=dev, generator=gen)
    open_gates(model)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=dev)

    def source():
        return {key: torch.randn((batch, n_src, cfg.d_model), generator=gen,
                                 device=dev).to(cfg.activation_dtype)}

    extra, other = source(), source()
    stats, counts, cache, first = serve_run(model, prompts, SERVE_DECODE,
                                            family, extra=extra)
    walls, med = serve_walls(model, prompts, first, SERVE_DECODE, repeats,
                             extra)
    (mine, theirs), counts[f"{family}_other_source"] = counted_call(
        lambda: (model.prefill(prompts, extra)[0],
                 model.prefill(prompts, other)[0]))
    response = float((mine - theirs).abs().max() / mine.abs().max())
    check = cross_cache_check(model, cache, first)
    tol = BF16_SERVE_TOL[family]
    out = dict(
        arch=arch, layers=cfg.n_layers, enc_layers=cfg.n_enc_layers,
        groups=len(cache["groups"]), d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, dtype=cfg.dtype, batch=batch,
        prompt=prompt, source=key, source_len=n_src,
        decode_steps=SERVE_DECODE, weight_bytes=weight_bytes,
        gates=[float(p) for n, p in model.named_parameters()
               if n.endswith(".gate")], **stats, tol=tol,
        source_response=response,
        cross_cache=check, walls=walls, median=med,
        prefill_tokens_per_s=batch * prompt / (med["prefill_ms"] / 1e3),
        decode_tokens_per_s=batch / (med["decode_ms_per_step"] / 1e3),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches={k: _nonzero(v) for k, v in counts.items()})
    for tag, n in counts.items():
        check_counts(f"{arch} {tag}", n, {})
    ranges = tuple(CROSS_RANGES.values())
    for tag, fn in (("trace", lambda: model.prefill(prompts, extra)),
                    ("trace_decode", lambda: model.decode(cache, first))):
        trace, by_name = profiled(fn, ranges=ranges, split=True)
        out[tag] = dict(trace, **range_split(trace, by_name, CROSS_RANGES))
    params = {n: p.detach().float() for n, p in model.named_parameters()}
    del model, cache, first, mine, theirs
    torch.cuda.empty_cache()
    out["float32"] = float32_consistency(dev, cfg, params, prompts, extra,
                                         f"{family}_float32")
    bad = []
    if not stats["finite"] or not stats["decode_vs_forward_last"] <= tol:
        bad.append(f"finite={stats['finite']}, decode vs forward at the "
                   f"last position {stats['decode_vs_forward_last']} > "
                   f"{tol}")
    if not out["float32"]["ok"]:
        bad.append(f"float32 decode vs forward: {out['float32']}")
    if not response > CROSS_RESPONSE:
        bad.append(f"another {key} moved the logits by {response}")
    if not check["ok"]:
        bad.append(f"the decode step touched the cross cache: {check}")
    if bad:
        FAILED.append(f"{family}_serve ({batch} × {prompt}, {n_src} "
                      f"{key}): " + "; ".join(bad))
    return out


def phase_audio_serve(dev) -> None:
    """Whisper-base at SERVE_BATCH × SERVE_PROMPT over SERVE_PROMPT //
    enc_seq_ratio frames (the reference's ``extra_specs``), then at
    Whisper's own window (WHISPER_WINDOW)."""
    from repro_torch import configs
    ratio = configs.get(CROSS_ARCHS["audio"]).enc_seq_ratio
    emit("audio_serve", **cross_serve(dev, "audio", SERVE_BATCH, SERVE_PROMPT,
                                      SERVE_PROMPT // ratio, SERVE_REPEATS))
    frames, prompt = WHISPER_WINDOW
    emit("audio_serve", part="whisper_window", **cross_serve(
        dev, "audio", SERVE_BATCH, prompt, frames, SERVE_REPEATS))


def phase_vlm_serve(dev) -> None:
    """Llama-3.2-Vision-11B as published, SERVE_BATCH × SERVE_PROMPT over
    its n_image_tokens image embeddings."""
    from repro_torch import configs
    n_img = configs.get(CROSS_ARCHS["vlm"]).n_image_tokens
    emit("vlm_serve", **cross_serve(dev, "vlm", SERVE_BATCH, SERVE_PROMPT,
                                    n_img, SERVE_REPEATS))


def phase_cross_train(dev, family: str) -> None:
    """Whisper-base as published, or Llama-3.2-Vision-11B at its published
    widths cut to VLM_TRAIN_GROUPS groups (AdamW's float32 moments of the
    whole model do not fit the card), CROSS_TRAIN_STEPS steps with the
    launcher's source: losses and gradient norms finite, the encoder's
    (audio) or the cross layers' leaves, the embedding and the head
    moving; the gates reported (an AdamW step of ~lr is below half a bf16
    ulp at 0.5-1); one profiled step."""
    from repro_torch import configs
    cfg = configs.get(CROSS_ARCHS[family])
    if family == "audio":
        last = cfg.n_enc_layers - 1
        watched = ("embed", "lm_head", "enc_norm.scale",
                   "enc_groups.0.attn.wq", f"enc_groups.{last}.mlp.wo",
                   "groups.0.xattn.wk", f"groups.{cfg.n_layers - 1}.xattn.wv",
                   "groups.0.attn.wq", "groups.0.lnx.scale")
        reported = ("groups.0.xattn.gate",)
    else:
        cfg = dataclasses.replace(
            cfg, n_layers=VLM_TRAIN_GROUPS * cfg.cross_attn_every)
        last = VLM_TRAIN_GROUPS - 1
        watched = ("embed", "lm_head", "groups.0.cross.xattn.wk",
                   f"groups.{last}.cross.xattn.wv", "groups.0.cross.xattn.wq",
                   "groups.0.cross.lnx.scale",
                   f"groups.{last}.self.{cfg.cross_attn_every - 2}.mlp.wo")
        reported = ("groups.0.cross.xattn.gate",)
    out = lm_train(dev, cfg, CROSS_TRAIN_BATCH[family], CROSS_TRAIN_STEPS,
                   watched, CROSS_TRAIN_RANGES, reported=reported)
    emit(f"{family}_train", published_layers=configs.get(
        CROSS_ARCHS[family]).n_layers, **out)
    if not (out["finite"] and out["params_moved"]):
        FAILED.append(f"{family}_train: finite={out['finite']}, "
                      f"moved={out['moved']}")


# ---------------------------------------------------------------- mesh


def _mesh_ctx(dev, shape, fsdp: bool = False):
    """A MeshCtx over a (data, model) mesh of ``dev`` repeated."""
    from repro_torch.distributed.context import MeshCtx
    from repro_torch.launch.mesh import make_debug_mesh
    n = shape[0] * shape[1]
    return MeshCtx.from_mesh(make_debug_mesh(*shape, devices=[dev] * n),
                             fsdp=fsdp)


def phase_mesh_dryrun() -> None:
    """The port's dry run (``repro_torch.launch.dryrun``) of every cell at
    both production meshes, on the meta device: one line per mesh with
    each cell's status and the fullest device's argument bytes, and which
    cells' arguments fit the card's memory."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    for multi_pod in (False, True):
        t0 = time.perf_counter()
        res = [dryrun.run_cell(a, s, multi_pod=multi_pod, verbose=False)
               for a, s, _, _ in configs.cells()]
        cells = {r["cell"].rsplit("×", 1)[0]: dict(
            status=r["status"],
            argument_bytes=r.get("memory", {}).get("argument_size_in_bytes"),
            fits=r.get("fits")) for r in res}
        emit("mesh_dryrun", mesh="2x16x16" if multi_pod else "16x16",
             seconds=time.perf_counter() - t0,
             card_bytes=dryrun.card_memory(), cells=cells,
             fit=[c for c, v in cells.items() if v["fits"]],
             do_not_fit=[c for c, v in cells.items() if v["fits"] is False])
        bad = [r["cell"] for r in res if r["status"] not in ("ok", "skip")
               or (r["status"] == "ok" and r["fits"] is None)]
        if bad:
            FAILED.append(f"mesh_dryrun: {bad}")


def _real_heads(name: str, t: torch.Tensor, h: int) -> torch.Tensor:
    """The real query heads' part of a parameter of a padded model."""
    if name.endswith("attn.wq"):
        return t[:, :h].contiguous()
    if name.endswith(("attn.wo", "attn.bq")):
        return t[:h].contiguous()
    return t


@torch.no_grad()
def _unpadded_logits(model, h: int, prompts, first) -> dict:
    """The padded heads' ``wo`` rows of ``model`` zeroed; its prefill and
    first decode against the unsharded model carrying the real heads'
    weights (max |Δ| / max |unsharded|)."""
    from repro_torch.models import Model
    named = dict(model.named_parameters())
    for n, t in named.items():
        if n.endswith("attn.wo"):
            t[h:] = 0
    plain = Model(model.cfg, device=model.device, params={
        n: _real_heads(n, t, h) for n, t in named.items()})
    out = {}
    for key, m in (("mesh", model), ("plain", plain)):
        logits, cache = m.prefill(prompts)
        out[key] = (logits, m.decode(cache, first)[0])
        del cache
    del plain
    return dict(prefill=rel_err(out["mesh"][0], out["plain"][0]),
                decode=rel_err(out["mesh"][1], out["plain"][1]))


@torch.no_grad()
def mesh_serve(dev, arch: str) -> None:
    """``arch`` as published (bf16, seeded) under a (1, MESH_TP) mesh: its
    query heads padded to a multiple of MESH_TP.  Prefill of SERVE_BATCH ×
    SERVE_PROMPT, MESH_SERVE_DECODE greedy decodes, a forward over the
    extended sequences (decode against forward at the last position
    within SERVE_TOL); walls (median of MESH_REPEATS) and the peak memory
    of those prefills and decodes, beside the unsharded model's.  Then,
    the padded heads' ``wo`` rows zeroed, the prefill and first decode
    against the unsharded model on the real heads' weights: within SERVE_TOL in bf16 and F32_SERVE_TOL
    with the same weights in float32."""
    from repro_torch import configs
    from repro_torch.models import Model, blocks
    cfg = configs.get(arch)
    ctx = _mesh_ctx(dev, (1, MESH_TP), fsdp=cfg.n_params() > 2e9)
    h, hp = cfg.n_heads, blocks._padded_heads(cfg, ctx)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Model(cfg, ctx, generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    stats, counts, cache, first = serve_run(model, prompts,
                                            MESH_SERVE_DECODE, "mesh_serve")
    del cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls, med = serve_walls(model, prompts, first, MESH_SERVE_DECODE,
                             MESH_REPEATS)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    named = dict(model.named_parameters())
    plain = Model(cfg, device=dev, params={n: _real_heads(n, t, h)
                                            for n, t in named.items()})
    walls_p, med_p = serve_walls(plain, prompts, first, MESH_SERVE_DECODE,
                                 MESH_REPEATS)
    peak_p = torch.cuda.max_memory_allocated()
    del plain, named
    bf16 = _unpadded_logits(model, h, prompts, first)
    f32_params = {n: t.float() for n, t in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    f32 = _unpadded_logits(Model(cfg32, ctx, params=f32_params), h, prompts,
                           first)
    del f32_params
    torch.cuda.empty_cache()
    for tag, n in counts.items():
        check_counts(f"mesh_serve {arch} {tag}", n, {})
    ok = (stats["finite"] and stats["decode_vs_forward_last"] <= SERVE_TOL
          and max(bf16.values()) <= SERVE_TOL
          and max(f32.values()) <= F32_SERVE_TOL)
    emit("mesh_serve", arch=arch, mesh=[1, MESH_TP], heads=h,
         padded_heads=hp, kv_heads=cfg.n_kv_heads,
         kv_index=blocks._kv_index(cfg, ctx), layers=cfg.n_layers,
         batch=SERVE_BATCH, prompt=SERVE_PROMPT,
         decode_steps=MESH_SERVE_DECODE, **stats, tol=SERVE_TOL,
         zero_rows_vs_unsharded_bf16=bf16, zero_rows_vs_unsharded_f32=f32,
         f32_tol=F32_SERVE_TOL, walls=walls, median=med,
         unsharded_walls=walls_p, unsharded_median=med_p,
         max_memory_allocated=peak, unsharded_max_memory_allocated=peak_p,
         launches={k: _nonzero(v) for k, v in counts.items()}, ok=ok)
    if not ok:
        FAILED.append(f"mesh_serve {arch}: finite={stats['finite']}, "
                      f"decode vs forward {stats['decode_vs_forward_last']}"
                      f", zero rows vs unsharded bf16 {bf16}, f32 {f32}")


def _routing(stats: list, layers: int) -> list:
    """Per layer (topi (T, k), router logits (T, E)) of one forward's
    records: under a mesh each data shard's, in order, from its model
    shard 0 (every model shard routes alike)."""
    per = len(stats) // layers
    out = []
    for i in range(layers):
        recs = [r for r in stats[i * per:(i + 1) * per]
                if r.get("model_shard", 0) == 0]
        out.append((torch.cat([r["topi"] for r in recs]),
                    torch.cat([r["logits"] for r in recs])))
    return out


def _dropped_per_data_shard(stats: list, layers: int) -> list:
    """Dropped (token, choice) pairs per data shard, over the layers: each
    record counts its own experts' drops, so each (layer, data shard,
    experts) once (without expert parallelism every model shard holds
    every expert)."""
    per, seen = {}, set()
    n = len(stats) // layers
    for i, r in enumerate(stats):
        key = (i // n, r.get("data_shard", 0), r.get("experts"))
        if key not in seen:
            seen.add(key)
            per[key[1]] = per.get(key[1], 0) + int(r["dropped"])
    return [per[k] for k in sorted(per)]


def _routed_alike(mine: list, ref: list, k: int) -> tuple:
    """(tokens routed to the same experts in every layer, the swaps: per
    token and layer that differ, the unsharded router's margin between its
    k-th and (k+1)-th logit and ``drift``, the largest change of that
    token's router logits; a swap is explained when margin ≤ 2 · drift)."""
    alike = None
    swaps = []
    for layer, ((ti, lo), (tr, lr)) in enumerate(zip(mine, ref)):
        same = (ti.sort(-1).values == tr.sort(-1).values).all(-1)
        alike = same if alike is None else alike & same
        for t in (~same).nonzero().flatten().tolist():
            top = lr[t].topk(k + 1).values
            swaps.append(dict(layer=layer, token=t,
                              margin=float(top[k - 1] - top[k]),
                              drift=float((lo[t] - lr[t]).abs().max())))
    return alike, swaps


@torch.no_grad()
def phase_mesh_moe(dev) -> None:
    """Mixtral-8x7B at its published widths, MESH_MOE_LAYERS layers (bf16,
    seeded), a forward over SERVE_BATCH × SERVE_PROMPT under each mesh of
    MESH_MOE_SHAPES (FSDP on) against the unsharded model on the same
    weights.  At the published capacity: each mesh's dropped choices per
    data shard, aux and logits against the unsharded (reported: each data
    shard has a capacity of its own).  Drop-free (capacity factor E): no
    drop anywhere.  In float32 every token routes as unsharded and every
    logit lies within F32_SERVE_TOL of the unsharded.  In bf16 the tokens
    routed to the same experts in every layer hold their logits within
    SERVE_TOL, and every token routed otherwise lies on a tie within twice
    the drift of its router logits (the sharded partial sums round
    otherwise in bf16)."""
    from repro_torch import configs
    from repro_torch.models import Model, blocks
    cfg = dataclasses.replace(configs.get(MESH_MOE_ARCH),
                              n_layers=MESH_MOE_LAYERS)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = dict(Model(cfg, device=dev, generator=gen).named_parameters())
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    k, e = cfg.top_k, cfg.n_experts

    def forward(model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with blocks.routing_stats() as st:
            logits, aux = model(prompts)
        torch.cuda.synchronize()
        return logits, float(aux), st, (time.perf_counter() - t0) * 1e3

    out, ok = {}, True
    for label, dtype, cf in (("published", "bfloat16", cfg.capacity_factor),
                             ("drop_free", "bfloat16", float(e)),
                             ("drop_free_f32", "float32", float(e))):
        c = dataclasses.replace(cfg, capacity_factor=cf, dtype=dtype,
                                param_dtype=dtype)
        ps = params if dtype == "bfloat16" else {
            n: t.float() for n, t in params.items()}
        ref_logits, ref_aux, ref_st, ref_ms = forward(
            Model(c, device=dev, params=ps))
        ref_route = _routing(ref_st, c.n_layers)
        rows = {"unsharded": dict(aux=ref_aux, ms=ref_ms,
                                  dropped=_dropped_per_data_shard(
                                      ref_st, c.n_layers))}
        tol = F32_SERVE_TOL if dtype == "float32" else SERVE_TOL
        for shape in MESH_MOE_SHAPES:
            model = Model(c, _mesh_ctx(dev, shape, fsdp=True), params=ps)
            logits, aux, st, ms = forward(model)
            del model
            alike, swaps = _routed_alike(_routing(st, c.n_layers),
                                         ref_route, k)
            flat, ref_flat = (t.view(-1, t.shape[-1])
                              for t in (logits, ref_logits))
            row = dict(aux=aux, ms=ms,
                       dropped=_dropped_per_data_shard(st, c.n_layers),
                       vs_unsharded=rel_err(logits, ref_logits),
                       tokens_routed_otherwise=int((~alike).sum()),
                       swaps_explained=all(w["margin"] <= 2 * w["drift"]
                                           for w in swaps),
                       largest_swap_margin=max(
                           (w["margin"] for w in swaps), default=None))
            if label != "published":
                row["vs_unsharded_routed_alike"] = errors(
                    flat[alike].float(), ref_flat[alike].float())[1]
                row["tol"] = tol
                # float32 holds every token: no swap, all logits in tol;
                # bf16 the tokens routed alike, the others explained ties
                held = (row["vs_unsharded"] <= tol
                        and row["tokens_routed_otherwise"] == 0
                        if dtype == "float32" else
                        row["vs_unsharded_routed_alike"] <= tol
                        and row["swaps_explained"])
                row["ok"] = (sum(row["dropped"]) == 0 and held
                             and bool(torch.isfinite(logits).all()))
                ok = ok and row["ok"]
            rows[f"{shape[0]}x{shape[1]}"] = row
            del logits, flat, st
        if label != "published" and sum(rows["unsharded"]["dropped"]):
            ok = False
        out[label] = dict(capacity_factor=cf, dtype=dtype, **rows)
        del ref_logits, ref_st, ref_route, ps
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    emit("mesh_moe", arch=MESH_MOE_ARCH, layers=MESH_MOE_LAYERS,
         experts=e, top_k=k, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
         meshes=[list(m) for m in MESH_MOE_SHAPES], fsdp=True, runs=out,
         ok=ok)
    if not ok:
        FAILED.append(f"mesh_moe: {out}")


@torch.no_grad()
def phase_mesh_ssm(dev) -> dict:
    """Falcon-Mamba-7B as published (bf16, 64 layers, seeded) under a (1,
    MESH_TP) mesh (d_inner 8192 over "model", FSDP on): a prefill of 1 ×
    SERVE_PROMPT, its logits and cache bit for bit the unsharded model's
    on the same weights; the path counted (``mesh_ssm``: the scan and the
    causal convolution once a layer)."""
    from repro_torch import configs
    from repro_torch.models import Model
    cfg = configs.get(MAMBA_ARCH)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    plain = Model(cfg, device=dev, generator=gen)
    model = Model(cfg, _mesh_ctx(dev, (1, MESH_TP), fsdp=True),
                  params=dict(plain.named_parameters()))
    prompts = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT),
                            generator=gen, device=dev)
    want, want_cache = plain.prefill(prompts)
    (got, cache), counts = counted_call(lambda: model.prefill(prompts))
    same = torch.equal(got, want) and all(
        torch.equal(a[key], b[key]) for a, b in zip(
            cache["groups"], want_cache["groups"]) for key in ("conv", "h"))
    del plain, model, cache, want_cache
    torch.cuda.empty_cache()
    check_counts("mesh_ssm", counts, dict(ssm_scan=cfg.n_layers,
                                          causal_conv1d=cfg.n_layers))
    emit("mesh_ssm", arch=MAMBA_ARCH, layers=cfg.n_layers,
         mesh=[1, MESH_TP], prompt=SERVE_PROMPT, bit_for_bit=same,
         launches=_nonzero(counts))
    if not same:
        FAILED.append("mesh_ssm: the prefill under the mesh is not the "
                      "unsharded prefill bit for bit")
    return {"mesh_ssm": counts}


def _launch_quiet(argv: list) -> tuple:
    """``repro_torch.launch.train.main(argv)`` with its printout captured:
    (its result, the printout's lines)."""
    import contextlib
    import io
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = launch_train.main(argv)
    return res, buf.getvalue().splitlines()


def phase_mesh_train(dev) -> None:
    """``repro_torch.launch.train.main`` for MESH_TRAIN_ARCH as published,
    ``--mesh 1x1``, TRAIN_BATCH × TRAIN_SEQ: (a) MESH_TRAIN_STEPS steps
    with no checkpoint; (b) MESH_TRAIN_EVERY steps, checkpointed at the
    last; (c) MESH_TRAIN_STEPS steps resumed from (b)'s checkpoint
    (restored through ``TrainLoop(shardings=)``), whose last loss must be
    (a)'s bit for bit.  Then ``compressed_psum_tree`` over a data axis of
    2 positions on the float32 gradients of two batches of the seeded
    model, leaf by leaf: within PSUM_TOL of max |g| of a float64
    evaluation of the reference's formula on the same int8 codes and
    scales, and its error against the exact mean."""
    import os
    import tempfile
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import token_stream
    from repro_torch.distributed import compression
    from repro_torch.models import Model
    argv = ["--arch", MESH_TRAIN_ARCH, "--mesh", "1x1",
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt-every", str(MESH_TRAIN_EVERY)]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        first, lines = _launch_quiet(argv + ["--steps",
                                             str(MESH_TRAIN_STEPS)])
        t1 = time.perf_counter()
        part, lines_b = _launch_quiet(argv + [
            "--steps", str(MESH_TRAIN_EVERY), "--ckpt-dir", d])
        mgr = CheckpointManager(d)
        saved = mgr.all_steps()
        # (c) resumed only if it left (b)'s checkpoint unwritten: a run
        # from step 0 writes its own at MESH_TRAIN_EVERY
        manifest = os.path.join(mgr.step_dir(MESH_TRAIN_EVERY),
                                "manifest.json")
        stamp = os.stat(manifest).st_mtime_ns
        t2 = time.perf_counter()
        second, lines_c = _launch_quiet(argv + [
            "--steps", str(MESH_TRAIN_STEPS), "--ckpt-dir", d])
        t3 = time.perf_counter()
        saved_after = mgr.all_steps()
        kept = os.stat(manifest).st_mtime_ns == stamp
    torch.cuda.empty_cache()
    resumed = (saved == [MESH_TRAIN_EVERY] and kept
               and saved_after == [MESH_TRAIN_EVERY, MESH_TRAIN_STEPS]
               and part["final_step"] == MESH_TRAIN_EVERY
               and second["final_step"] == first["final_step"]
               == MESH_TRAIN_STEPS
               and second["log"][-1]["loss"] == first["log"][-1]["loss"])
    cfg = configs.get(MESH_TRAIN_ARCH)
    model = Model(cfg, _mesh_ctx(dev, (1, 1)),
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    data = token_stream(torch.Generator(device=dev).manual_seed(3),
                        cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    named = dict(model.named_parameters())
    grads = []
    for _ in range(2):
        loss, _ = model.loss(next(data))
        grads.append({n: g.float() for n, g in zip(
            named, torch.autograd.grad(loss, list(named.values())))})
    del model, named
    torch.cuda.empty_cache()
    mesh2 = _mesh_ctx(dev, (2, 1)).mesh
    worst = worst_mean = 0.0
    for name in list(grads[0]):
        g = [grads[0].pop(name), grads[1].pop(name)]
        zero = torch.zeros_like(g[0])
        out, res = compression.compressed_psum_tree(
            [{name: g[0]}, {name: g[1]}], [{name: zero}, {name: zero}],
            "data", mesh2)
        codes = [compression.quantize_int8(x) for x in g]
        want = ((codes[0][0].double() + codes[1][0].double())
                * ((codes[0][1].double() + codes[1][1].double()) / 2) / 2)
        scale = max(float(x.abs().max()) for x in g) or 1.0
        for i in range(2):
            worst = max(worst, float((out[i][name].double() - want).abs()
                                     .max()) / scale)
        worst_mean = max(worst_mean, float(
            (out[0][name].double() - (g[0].double() + g[1].double()) / 2)
            .abs().max()) / scale)
        del g, zero, out, res, codes, want
    del grads
    torch.cuda.empty_cache()
    ok = resumed and worst <= PSUM_TOL
    emit("mesh_train", arch=MESH_TRAIN_ARCH, mesh="1x1",
         layers=cfg.n_layers, steps=MESH_TRAIN_STEPS,
         ckpt_every=MESH_TRAIN_EVERY, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         checkpoints=saved_after, first_loss=first["log"][-1]["loss"],
         resumed_loss=second["log"][-1]["loss"], resumed_bit_for_bit=resumed,
         first_s=t1 - t0, checkpointed_s=t2 - t1, resumed_s=t3 - t2,
         printout=lines + lines_b + lines_c, psum_positions=2,
         psum_vs_float64=worst, psum_tol=PSUM_TOL,
         psum_vs_exact_mean=worst_mean, ok=ok)
    if not ok:
        FAILED.append(f"mesh_train: resumed bit for bit {resumed}, psum "
                      f"against float64 {worst} (tol {PSUM_TOL})")


def main() -> None:
    dev_info = phase_device()
    dev = torch.device("cuda")
    import repro_torch  # noqa: F401  (fails outside a checkout)
    phase_build()
    folds, lams = main_inputs(dev)
    kern = phase_kernels(dev, folds, lams, dev_info["peaks"])
    launches = phase_main(dev, folds, lams)
    phase_trace(dev, folds, lams)
    launches.update(phase_host(dev, folds, lams))
    launches.update(phase_packed(dev, folds, lams))
    launches["gauss_newton"] = phase_gauss_newton(dev, folds)
    phase_table4(dev)
    launches.update(phase_precision(dev, folds, lams))
    launches.update(phase_baselines(dev, folds, lams))
    launches.update(phase_cache(dev, folds, lams))
    launches.update(phase_staged(dev, folds, lams))
    launches.update(phase_tune(dev, folds, lams, dev_info))
    del folds, lams
    launches.update(phase_cv_serve(dev))
    launches.update(phase_sketch(dev))
    phase_mamba_fixture(dev)
    phase_mamba(dev)
    launches.update(phase_serve(dev))
    launches.update(phase_train(dev))
    phase_dense_fixture(dev)
    phase_dense_serve(dev)
    phase_dense_train(dev)
    fixture_phase("moe_fixture", moe_fixture, dev)
    for arch, layers in MOE_SERVE:
        moe_serve(dev, arch, layers)
    phase_moe_train(dev)
    fixture_phase("hybrid_fixture", hybrid_fixture, dev)
    phase_hybrid_serve(dev)
    phase_hybrid_train(dev)
    for family in CROSS_ARCHS:
        fixture_phase(f"{family}_fixture",
                      lambda d, f=family: cross_fixture(d, f), dev)
    phase_audio_serve(dev)
    phase_vlm_serve(dev)
    for family in CROSS_ARCHS:
        phase_cross_train(dev, family)
    phase_mesh_dryrun()
    for arch in MESH_SERVE_ARCHS:
        mesh_serve(dev, arch)
    phase_mesh_moe(dev)
    launches.update(phase_mesh_ssm(dev))
    phase_mesh_train(dev)
    rows = []
    for name in REPLACES:
        r = kern[name]
        # kernel A counts its two modes apart (the checkpoint mode under
        # its own name); its row sums them
        names = (name, f"{name}_ckpt") if name == "mamba_scan_bwd" else (name,)
        by_path = {tag: sum(n.get(m, 0) for m in names)
                   for tag, n in launches.items()}
        if name == "mamba_scan_bwd":
            r = dict(r, **{f"launches_{mode}": sum(n.get(m, 0) for n in
                                                   launches.values())
                           for mode, m in (("walk", name),
                                           ("ckpt", names[1]))})
        rows.append(dict(name=name, route="cuda", source=SOURCES[name],
                         replaces=REPLACES[name],
                         launches=sum(by_path.values()),
                         launches_by_path=by_path,
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"],
                         library_ms=r["library_ms"],
                         **{k: r[k] for k in CLUSTER_KEYS + MIXED_KEYS
                            + FUSED_KEYS + BWD_KEYS + CONV_KEYS + CHOL_KEYS
                            + ("tuned_block",) if k in r}))
    idle = [r["name"] for r in rows if r["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels launched on no path: {idle}")
    print(json.dumps({"kernels": rows}), flush=True)
    if FAILED:
        raise AssertionError("; ".join(FAILED))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["name"],
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels of ``src/repro_torch/csrc`` with nvcc;
2. print the card's name and power limit;
3. hold each kernel (K1 ``qap_delta``, K4 ``qap_sa_step``, K2
   ``qap_objective``, K5 ``qap_ga_step``, K6 ``qap_objective_sparse``,
   K7 ``qap_delta_sparse``) against its plain PyTorch version on the
   card, at the shapes the engine gives it (bitwise: the instances are
   integer-valued), and time both, by CUDA events and (the kernel) in a
   CUDA graph; K1, K4, K2 and K5 on both branches, the shared-memory
   one at the 128 bucket and the L2 one at order 256, K4 also as a round
   of 100 temperature steps in one launch at the 128 bucket (the fused
   PSA's mode there; temperatures compared too); K1 and K2's L2
   branches also at the service's exact-size shapes of an order-193
   instance padded into 200 (K1 16 x 25 and the polish's 1 x 256, K2 2
   islands), K1's unstaged L2 kernel at order 11618 (the first its rows do
   not fit shared memory), K2 at sparse_scale's dense baseline (8
   permutations of one order-4096 instance of 0/1 entries) and, on
   real-valued flows at order 200, the same bits twice and for each
   permutation alone; K6 at every level
   of the 4096 torus (orders 4096 ... 128, ELL widths 6 ... 46) at the
   route's 1 x 1 and 1 x 4 and at 64 x 4 on the finest, shared and
   batched, then on real-valued flows: the same bits on two calls and for
   a permutation alone, within 1e-5 of the plain version; then K8
   ``selective_scan`` at the Jamba prefill's full-width shape (4 x 512 x
   8192, d_state 16) and a ragged one (2 x 49 x 200, d_state 4), ``y`` and the final state
   within 2e-4 of their largest magnitude;
4. drive the port's ``MappingEngine`` on the card through one full wave
   of the 128 bucket (32 requests of order 125) plus waves of the 64 and
   32 buckets, on five routes: PSA with ``loop="event"`` (kernel K1) and
   ``loop="fused"`` (K4), PGA with ``eval="wide"`` (K2) and
   ``eval="fused"`` (K5), and PCA (K1, then K2); then a sixth route,
   ``multilevel``: requests of orders 512, 1024 and 4096 (known-optimum
   tori) through the large buckets (K1 for the coarse solve, K6 and K7
   on the refinement levels and in the final polish); the launch counts
   are set to 0 just before each wave or request and read just after,
   and every K1, K2, K4 and K5 launch there must have taken the
   shared-memory branch; then the exact-size route: a 200-process job on
   a 10 x 20 torus allocation (``exact.make_torus``, known optimum),
   which no dense bucket holds and which lies below the multilevel
   route, through the psa-event and pga-wide engines (every K1 and K2
   launch on the L2 branch; psa card == CPU at the default tier);
   then a seventh route, ``rm-replay``, the control plane: a 12-job
   ``synthetic_trace`` on the 512-node 8 x 8 x 8 torus through
   ``ResourceManager``'s defaults (3 candidates, EASY backfilling, psa)
   over ``MappingEngine(warm_start=False)`` (K1, every launch on the
   shared-memory branch, one batch a wave); the same trace through a
   subprocess ``EngineFleet`` of two workers on the card whose worker 0
   SIGKILLs itself after 4 requests (the same decisions job for job, one
   death, no failure, free device memory down by at least one CUDA
   context per child while both live); its first 6 jobs through one
   engine and a thread fleet under a kill on the card and one engine on
   the CPU (all three equal); and ``PlacementService.solve_batch`` of the
   first job's candidates, card == CPU;
   then an eighth route, ``lm-serve``: Jamba-v0.1-52B at full width, 8 of
   its 32 layers (one ``mMmMaMmM`` super-block), bf16 weights drawn on the
   card from a seeded generator, dropless MoE, served through the port's
   ``Engine.generate``: 4 prompts of 512 tokens, 16 greedy tokens (K8
   once per Mamba layer of the prefill: 7 launches);
   then a ninth route, ``paper``: the port's harness (``benchmarks_torch``)
   on the card -- Table 1 at all seven taiXe orders 27-729
   (``PAPER_SCALE``, one run a cell; orders 175/343/729 run K1 and K2 on
   their L2 branches, which must launch), Figs 1-7 at the harness's
   default scale, the dry runs of ``scheduler_sim``, ``mapper_throughput``
   (both also with ``--mesh-shape 1``), ``sparse_scale`` and
   ``solver_hotloop`` (both loops), and ``kernel_micro``; before it, K1
   and K2 on Table 1's tai343 and tai729 against their plain versions;
   then a tenth route, ``mesh``: each dense route's 128-bucket wave
   (but pga-wide's and pca's) and one of its three-request waves (64 and
   32 buckets in turn) through a
   ``MappingEngine`` whose instance mesh names cuda:0 twice (each wave
   split over two shards that share the card; the three-request waves
   pad to four and trim back), every response equal to phase 4's
   unsharded one; then the paper's parallel algorithms on
   ``torch.distributed`` worlds spawned on one order-125 instance at the
   routes' budgets -- ``run_psa_mesh`` (event and fused loops),
   ``run_pga_mesh`` (wide and fused), ``run_pca_mesh`` and
   ``find_mapping(mesh=)`` at world size 4 on cuda:0 (gloo) and 1
   (NCCL), and three of them at world size 4 on the CPU: every rank the
   same answer, f = F(perm), card == CPU;
   then a twelfth route, ``lm-families``, run right after ``lm-serve``:
   the repo's other model families at full width with bf16 weights
   drawn on the card from a seeded generator -- RWKV6-7B at full depth
   (32 ``R`` layers, 7,534,546,944 parameters) served through
   ``Engine.generate`` on 4 prompts of 512 tokens, 16 greedy tokens;
   MusicGen-medium at full depth (48 layers, 1,818,576,384 parameters)
   and InternVL2-76B at 4 of its 80 layers (5,550,186,496 parameters),
   each prefilled from 4 x 512 ``embeds`` (audio frames of 128, vision
   patches of 3200) and decoded 16 steps from ``embeds`` (B, 1, fd);
   a 64-position prefill and a decode step of each profiled; no
   hand-written kernel is on this path, so every launch count stays 0,
   each model's serving and the whole route read once each (the counts
   set to 0 once, at the route's start);
   then an eleventh route, ``train``: Qwen3-4B at full width (d_model
   2560, 32 heads / 8 KV, head_dim 128, d_ff 9728, vocab 151936,
   qk_norm), 4 of its 36 layers, trained through ``train.step`` for 6
   AdamW steps on 4 x 4096 tokens of the data pipeline (bf16 compute, f32
   master weights and moments, remat ``full``, ``loss_chunk`` 512, lr
   3e-4 after 2 warmup steps, seed 0): every loss finite, the last below
   the first, the first step's loss within 1e-2 and its grad norm within
   5e-2 of the same step in f32 compute, and one more step under
   ``torch.profiler`` (the device's busy share and its time by kernel
   class); then Qwen3-4B, Mixtral-8x22B,
   Jamba, RWKV6-7B, MusicGen-medium and InternVL2-76B (the last two on
   ``embeds``) at ``SMOKE`` width in f32, 3 AdamW steps on the card
   against the CPU (losses within 1e-4 relative, first-step gradients
   within 1e-4 of each leaf's largest magnitude; Jamba's training forward
   launches K8 and every Mamba weight gets a gradient; every RWKV weight
   of both layers gets a gradient; RWKV's gradients, ill-conditioned at
   its own init, within 1e-4 plus the CPU's own f32 distance from the
   CPU's f64 gradients); then
   ``launch.train.train`` on examples/train_lm.py's ``CFG_QUICK``: 6 steps
   against 3 steps, a checkpoint, and a fresh run resuming to 6 (losses
   within 1e-5 relative);
   then a thirteenth route, ``placement``, the paper's placement of a
   training job: Qwen3-4B's ``train_4k`` cell (4096 x 256) at full width
   and all 36 layers lowered on meshes (64, 1) and (256, 1) without
   devices (``launch.lowering``: the card's allocation unchanged), each
   C solved on a fresh default ``PlacementService`` against the mesh's
   torus and the resource manager's ``scatter`` candidate of as many
   nodes on the rm-replay 8 x 8 x 8 torus (F of the identity, F, gain,
   seconds, launches by kernel and branch; K1, K2, K6 and K7 launched):
   at 64 ranks psa on C, and psa, pga and pca on C scaled to a unit
   maximum (the byte counts put F near 1e12, past f32's exact integers,
   where the engines' differences are rounding); at 256 ranks psa, pga
   and pca on C, all three the multilevel route's one answer, and psa on
   C / max(C); every unit solve card == CPU bit for bit (the CPU's in a
   pool of processes beside the card's solves, whose walls are printed
   as such); then
   ``launch.train.train`` on a (4, 1) mesh of gloo ranks on cuda:0 with
   ``placement="psa"`` -- Qwen3-4B at full width cut to 2 layers, 4 x
   4096 tokens (one sequence a rank), 2 steps -- gain 1/3 with a
   permutation other than the identity, every rank's live collectives
   equal to the lowered cell's, losses within 1e-3 relative of one
   device's on the same batches (3 steps, run first and freed; its first
   two steps' learning rates do not depend on the step count), each
   rank's peak printed;
   then a fourteenth route, ``tensor-parallel``: Qwen3-4B's ``train_4k``
   cell at full width and all 36 layers lowered on the production
   (16, 16) ("data", "model") mesh without devices (seconds, ops by kind
   and by axis, ``total_collective_bytes``; the card's allocation
   unchanged) and placed with ``place_job`` (psa, a fresh default
   service) on the 16 x 16 torus: the multilevel route, K1, K6 and K7
   launched; psa on C / max(C) card == CPU bit for bit (the CPU's in a
   pool process beside the card's solves); then ``launch.train.train`` on
   a (2, 2) mesh of 4 gloo ranks on cuda:0 with ``placement="psa"`` --
   Qwen3-4B at full width cut to 2 layers, bf16 compute, remat ``full``,
   4 x 4096 tokens, 3 steps -- losses within 1e-3 relative of the one
   device of the ``placement`` route, every rank's live collectives the
   lowered cell's, each rank's peak and step walls printed; then Jamba's
   ``SMOKE`` config in f32 on a (2, 2) world of gloo ranks on cuda:0, the
   first step's loss and gradients within 1e-4 of one CPU device's (of
   each leaf's largest magnitude), every rank launching K8 on its
   ``d_inner / 2`` channels;
   then a fifteenth route, ``expert-parallel``, the model axis for every
   architecture: Jamba-v0.1-52B (1 of 16 experts and ``d_inner / 16``
   Mamba channels a model rank), Qwen3-MoE-235B-A22B (8 of 128 experts,
   4 of 64 heads) and RWKV6-7B (4 of 64 heads) at full width and depth,
   ``train_4k`` lowered on the production (16, 16) mesh
   without devices (seconds, ops by kind and by axis,
   ``total_collective_bytes``; the card's allocation unchanged), each
   placed with ``place_job`` (psa, a fresh default service) on the
   16 x 16 torus -- the multilevel route, K1, K6 and K7 launched -- and
   psa on C / max(C) card == CPU bit for bit (the CPU's in a pool
   process beside the card's solves); then one world of 4 gloo ranks on
   cuda:0 as a (2, 2) mesh running Jamba's ``SMOKE`` config with 16
   experts (4 a model rank, over ep) and RWKV6's ``SMOKE`` config, both
   in f32: each first step's loss and gradients within 1e-4 of one CPU
   device's (of each leaf's largest magnitude), every rank launching K8
   in Jamba's Mamba layers;
   then a sixteenth route, ``serve-parallel``, serving over the (data,
   model) mesh: Granite-34B's ``decode_32k`` and ``prefill_32k`` and
   Qwen3-MoE-235B-A22B's ``decode_32k`` at full width and depth lowered
   on the production (16, 16) mesh without devices
   (``lowering.lower_cell``: seconds, ops by kind and by axis,
   ``total_collective_bytes`` and ``cache_bytes_per_device``, a device's
   bf16 KV caches required to the byte: 738,197,504 and 3,154,116,608
   for the decode cells), each placed with ``place_job`` (psa, a fresh
   default service) on the 16 x 16 torus -- K1, K6 and K7 launched --
   and psa on C / max(C) card == CPU; then Granite-34B at full width cut
   to 2 layers, bf16, served through ``data_parallel.make_serve_steps`` on
   a (2, 2) world of 4 gloo ranks on cuda:0 (4 prompts of 2048 tokens, a
   cache of 2048 + 8 positions sharded over ``seq``, 8 greedy steps with
   the flash-decoding combine and a vocab-parallel argmax) against one
   device fed the same tokens: every step's logits within 1e-2 of their
   largest magnitude, each greedy token the one device's argmax where
   its top two lie more than that bar apart and within the bar of its
   top on the other rows (near ties: counted), two planted faults read
   above the bar (a combine without its rescale; a model rank's argmax
   over its own columns), every rank's live collectives the lowered
   cells', prefill wall, decode ms a step and rank peaks printed; then
   Qwen3, Granite, Gemma3, Jamba (16 experts, dropless and at a capped
   capacity) and RWKV6 at ``SMOKE`` width in f32 served on a (2, 2)
   world of gloo ranks on cuda:0 (``tests/_torch_serve_world.py``'s rank
   body) against one CPU device: the same greedy tokens, logits within
   1e-4, K8 launched on every Jamba rank;
   then a seventeenth route, ``launchers``, the launchers that lower
   production cells: ``launch.dryrun`` of Qwen3-4B ``train_4k``,
   Granite-34B ``decode_32k`` and Qwen3-MoE-235B-A22B ``prefill_32k`` at
   full width and depth on the (16, 16) mesh (the step's work counted on
   ``meta`` by ``topology.opcost``; the card's allocation unchanged) and
   Qwen3-4B ``long_500k`` (skipped: full attention), read by
   ``launch.roofline`` at the H100 datasheet's rates (every term above
   0, model / counted FLOPs in (0.2, 1]), ``launch.inspect_cell``'s top
   12 of Granite's decode; ``launch.placement_bench.bench`` of Gemma3-4B
   ``train_4k`` on the (2, 16, 16) mesh, its six solves on the card (no
   F above F(identity); the fragmented allocation's F(identity) above
   the pristine slice's; the multilevel route's own answer on it
   printed; K1, K6 and K7 launched), psa on C / max(C) card == CPU (the
   CPU's in a pool process beside the route), ``placement_gain.run()``'s
   six rows; psa-event engines with ``SAConfig.event_width`` None,
   ``"auto"`` (its warmup fills the width cache at both buckets), 1 and
   6 on the 64 and 32 buckets' 3-request waves, the same responses bit
   for bit, K1 launches and the chosen widths printed;
5. check every response (a feasible permutation, an objective equal to
   F(perm), no worse than the identity and no better than the instance's
   known optimum) and check one request per bucket (the 1024 and 4096
   requests on the multilevel route) against the same engine on the
   CPU, bit for bit (the CPU's solves, and rm-replay's, in a pool of
   processes started with the script, beside the card's routes); on
   ``lm-serve``, every token in the vocabulary,
   finite logits, decode against teacher forcing at full width on the
   same bf16 weights in f32 compute (argmax agreement >= 0.95, logits
   within 1e-3 of their largest magnitude; the served bf16 arithmetic's
   agreement over 16 prompts is printed), and Jamba's ``SMOKE`` width
   in f32 on the card against the CPU (the same greedy tokens, prefill
   logits within 1e-4 of their largest magnitude); on ``lm-families``,
   every token in the vocabulary and every logit finite, RWKV6-7B's
   decode against teacher forcing in f32 compute on the same bf16
   weights (prefill 448 tokens, decode tokens 448-511 one at a time,
   against prefill(512): the same argmax on every row, logits within
   1e-3 of their largest magnitude), MusicGen-medium's as ``lm-serve``'s
   (prefill(512) then one decode step against prefill(513), argmax
   agreement >= 0.95, within 1e-3), the served bf16 agreement of both
   printed, and the three at ``SMOKE`` width in f32 card against CPU
   (the same greedy tokens, prefill logits -- from ``embeds`` for the
   frontend models -- within 1e-4 of their largest magnitude); on
   ``paper``, every
   Table 1 and figure row's permutation scoring its reported F in numpy
   float64 (exactly while F < 2^24, else within n * 2^-24 of F, f32's
   rounding) and no better than F0, and Table 1's rows at orders 27 and
   45 and ``scheduler_sim``'s dry-run replay card == CPU.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  It exits non-zero, printing
no result, when there is no CUDA device or no ``src/repro_torch`` beside
it.  It imports nothing of JAX or of the reference package.
"""
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12           # f32 outside the tensor cores

ORDER, BUCKET, WAVE = 125, 128, 32
L2_ORDER = 256       # K1, K2, K4, K5 past their shared-memory thresholds
# The service's exact-size range (orders 129-255: no dense bucket, below
# the multilevel route): the kernel checks' order-193 instance padded
# into 200, and the exact-size route's 200-process job on a 10 x 20
# torus allocation (exact.make_torus, known optimum).
EXACT_ORDER, EXACT_NV, EXACT_TORUS = 200, 193, (10, 20)
EXACT_ALGOS = ("psa", "pga")
# The smallest order K1's L2 branch cannot stage (qap_delta.l2_plan):
# its unstaged kernel, counted as "qap_delta/l2_unstaged".
L2_UNSTAGED_ORDER = 11618
# K2's dense baseline of sparse_scale: 8 permutations of one order-4096
# instance, 0/1 entries (F <= 2^24, exact in f32).
K2_WIDE_ORDER, K2_WIDE_PERMS = 4096, 8
SA_KW = dict(max_neighbors=25, iters_per_exchange=30, num_exchanges=20,
             solvers=8)
GA_KW = dict(generations=80, pop_size=32)     # the engine's default GA
NUM_PROCESSES = 2
POLISH_K = 256
ISLANDS = WAVE * NUM_PROCESSES
N_OFF = GA_KW["pop_size"] // 2

# The multilevel route: known-optimum tori of orders 512, 1024 and 4096,
# served at the engine's default MultilevelConfig.  Refinement scores 4
# chains (2 processes x 2 solvers) x 16 candidates per K7 launch, the
# polish 1 x 256; the chain start scores 4 permutations per K6 launch.
ML_TORI = ((8, 8, 8), (32, 32), (16, 16, 16))
ML_CHAINS, ML_K = 4, 16

# The rm-replay route: the resource manager's defaults (3 candidates from
# compact/slab/scatter, EASY backfilling, psa) over the engine's default
# budgets, replaying a synthetic trace on the 512-node 8 x 8 x 8 torus.
# Offered load about 0.5 x 60 x 41.6 / 512 = 2.4 machines, so a queue
# builds and backfilling has work; flows are default_flows (integers).
RM_TORUS = (8, 8, 8)
RM_TRACE = dict(sizes=(16, 32, 64, 128), weights=(4, 3, 2, 1),
                arrival_rate=0.5, mean_run_s=60.0, seed=0)
RM_JOBS, RM_CPU_JOBS = 12, 6
RM_TIMEOUT_S = 120.0     # children dying in a loop fail the route
RM_MAX_RESPAWNS = 2

# The lm-serve route: 4 prompts of 512 tokens, 16 new tokens, greedy.
LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 16
LM_TF_ROWS = 16          # prompts in the bf16 teacher-forcing measurement

# The lm-families route: the repo's other model families at full width,
# bf16 weights, LM_BATCH x LM_PROMPT inputs and LM_NEW greedy tokens.
# RWKV6-7B whole (32 layers); MusicGen-medium whole (48 layers, audio
# frames as embeds); InternVL2-76B at 4 of its 80 layers (vision patches
# as embeds).  RWKV's teacher forcing prefills 448 tokens and decodes 64.
FAMILY_ARCHS = ("rwkv6_7b", "musicgen_medium", "internvl2_76b")
FAMILY_VISION_LAYERS = 4
FAMILY_PARAMS = {"rwkv6_7b": 7_534_546_944, "musicgen_medium": 1_818_576_384,
                 "internvl2_76b": 5_550_186_496}
FAMILY_TF_PREFIX = 448
FAMILY_PROFILE_PREFILL = 64   # positions of the profiled prefills (one RWKV chunk)

# The paper route: the port's harness (benchmarks_torch/) -- Table 1 at
# all seven taiXe orders at PAPER_SCALE with one run a cell, Figs 1-7 at
# the harness's default scale, the service benchmarks' dry runs and the
# kernel microbenchmarks.  Table 1's orders 175/343/729 run K1 and K2 on
# their L2 branches.  Card == CPU on Table 1's orders 27 and 45 at
# PAPER_CPU_SCALE and on scheduler_sim's dry-run replay.
PAPER_SCALE = 0.05
PAPER_FIG_SCALE = 0.02
PAPER_CPU_SCALE, PAPER_CPU_ORDERS = 0.02, (27, 45)
F32_EXACT = 2 ** 24      # integers above it are not all f32 numbers
PAPER_KERNEL_ORDERS = (343, 729)

# The mesh route: the five dense routes' waves (MESH_ENGINE_ORDERS)
# through an engine whose instance mesh names cuda:0 MESH_SHARDS times
# (each wave split over its shards, which share the card; run in turn,
# they take about MESH_SHARDS times the unsharded wave), then the paper's
# parallel algorithms over
# spawned torch.distributed worlds on one order-125 instance at the
# routes' budgets: world size 4 on cuda:0 (gloo: NCCL refuses several
# ranks on one GPU), world size 1 (NCCL), and world size 4 on the CPU
# (gloo) on the MESH_CPU_CASES.
MESH_SHARDS = 2
# route -> the orders of its sharded waves: the 128-bucket wave and one
# three-request wave (padded to 4), the 64 and 32 buckets in turn; the
# host-bound pga-wide and pca the three-request wave alone (their 128
# waves took 17.6 and 25.7 s sharded, PR 30's chip run)
MESH_ENGINE_ORDERS = {"psa-event": (ORDER, 45), "psa-fused": (ORDER, 27),
                      "pga-wide": (45,), "pga-fused": (ORDER, 27),
                      "pca": (45,)}
MESH_SEED = 7
MESH_TIMEOUT_S = 600.0
MESH_RANK_THREADS = 1    # up to 5 ranks share the host's 8 cores
# case -> (algorithm, SAConfig or GAConfig changes)
MESH_CASES = {
    "psa-event": ("psa", dict(loop="event")),
    "psa-fused": ("psa", dict(loop="fused")),
    "pga-wide": ("pga", dict(eval="wide")),
    "pga-fused": ("pga", dict(eval="fused")),
    "pca": ("pca", {}),
    "find_mapping": ("find", {}),
}
MESH_CPU_CASES = ("psa-event", "pga-wide", "pca")
# (label, world size, backend, device type, cases), in stages: card x4
# alone, then card x1 beside cpu x4 (five processes on the host's cores)
MESH_WORLDS = ((("card x4", 4, "gloo", "cuda", tuple(MESH_CASES)),),
               (("card x1", 1, "nccl", "cuda", tuple(MESH_CASES)),
                ("cpu x4", 4, "gloo", "cpu", MESH_CPU_CASES)))
# the kernels each case must launch on the card (a rank's GA generation
# is genetic.breed, as in the reference: K2 whatever eval says)
MESH_KERNELS = {"psa-event": ("qap_delta",), "psa-fused": ("qap_sa_step",),
                "pga-wide": ("qap_objective",),
                "pga-fused": ("qap_objective",),
                "pca": ("qap_delta", "qap_objective"),
                "find_mapping": ("qap_delta",)}

# The train route: Qwen3-4B at full width (configs/qwen3_4b.py), depth 36
# -> 4, global batch 256 -> 4 at train_4k's 4096 tokens; bf16 compute,
# f32 master weights and AdamW moments, remat "full", loss_chunk 512;
# lr 3e-4, 2 warmup steps, 6 steps, seed 0.  Then SMOKE widths card
# against CPU in f32 (TRAIN_CPU_ARCHS, 3 AdamW steps) and a resume of
# examples/train_lm.py's CFG_QUICK (copied: the port cannot import
# examples/).
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH = 4, 4096, 4
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 6, 2, 3e-4
TRAIN_CPU_ARCHS = ("qwen3_4b", "mixtral_8x22b", "jamba_v0_1_52b",
                   "rwkv6_7b", "musicgen_medium", "internvl2_76b")
TRAIN_CPU_STEPS, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH = 3, 48, 2
# Archs whose SMOKE gradients are also computed in f64 on the CPU: at
# RWKV's own init (bonus u = 0, zero state and token shift) the first
# token's time-mix output is 0 and its group norm divides by sqrt(eps),
# so f32 alone fixes some gradients only to ~1e-4 of their largest
# magnitude; the card's bar against the CPU there is 1e-4 plus that
# distance, read from an f64 run on the CPU (check_train_against_cpu).
TRAIN_F64_ARCHS = ("rwkv6_7b",)
TRAIN_QUICK = dict(name="lm-quick", num_layers=4, d_model=128, num_heads=4,
                   num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
                   layer_pattern="T" * 4, attn_q_chunk=32, attn_kv_chunk=64,
                   loss_chunk=32)
TRAIN_QUICK_KW = dict(global_batch=4, seq_len=64, lr=1e-3, warmup=2,
                      log_every=1)

# The placement route: Qwen3-4B's train_4k cell (4096 x 256) at full
# width and depth lowered on meshes (n, 1) without devices; its C solved
# on the default PlacementService against the mesh's torus and the
# resource manager's scatter candidate of n nodes on the rm-replay torus,
# card against CPU (the CPU in a pool of processes beside the card's
# solves); then launch.train on a (4, 1) mesh of gloo ranks on cuda:0
# with placement psa, alone on the host: depth 36 -> 2, 4 x 4096 tokens
# (one sequence a rank), 3 steps, against one device on the same batches.
PLACE_RANKS = (64, 256)
PLACE_ALGOS = ("psa", "pga", "pca")
# ranks -> the algorithms run on C of bytes.  At 64 its F is near 1e12,
# where the engines' differences are f32 rounding: pga and pca run on C /
# max(C) alone.  At 256 all three take the multilevel route (one answer).
PLACE_RAW = {64: ("psa",), 256: PLACE_ALGOS}
# ranks -> the algorithms run on C / max(C) (every F an exact small
# integer), each held card == CPU bit for bit
PLACE_UNIT = {64: PLACE_ALGOS, 256: ("psa",)}
PLACE_CPU_WORKERS = 3
PLACE_LAYERS, PLACE_STEPS, PLACE_WORLD = 2, 2, 4
PLACE_LOSS_RTOL = 1e-3

# The tensor-parallel route: Qwen3-4B's train_4k cell lowered on the
# production (16, 16) mesh and placed on its torus; launch.train on a
# (2, 2) mesh of gloo ranks on cuda:0 (the placement route's job, 3
# steps); Jamba SMOKE in f32 on a (2, 2) world against one CPU device.
TP_STEPS = 3
TP_WORLD_SHAPE = (2, 2)
TP_SMOKE_ARCH, TP_SMOKE_SEQ, TP_SMOKE_BATCH = "jamba_v0_1_52b", 32, 8
TP_SMOKE_TOL = 1e-4

# The expert-parallel route: three architectures at full width and depth
# lowered on the production (16, 16) mesh and placed on its torus; SMOKE
# configs in f32 on one (2, 2) world of gloo ranks on cuda:0 against one
# CPU device (16 experts, so that they shard over ep).
EP_ARCHS = ("jamba_v0_1_52b", "qwen3_moe_235b_a22b", "rwkv6_7b")
EP_SMOKE = (("jamba_v0_1_52b", dict(num_experts=16)), ("rwkv6_7b", {}))
# depth cut for the script's time: Qwen3-MoE's train cell 94 -> 24 layers
# (the serve-parallel route lowers its decode cell at full depth)
EP_CUT = {"qwen3_moe_235b_a22b": dict(num_layers=24, layer_pattern="E" * 24)}

# The serve-parallel route: serving over the (data, model) mesh.  Granite-
# 34B's decode_32k and prefill_32k and Qwen3-MoE-235B's decode_32k at full
# width and depth lowered on the production (16, 16) mesh (a device's
# bf16 KV caches required to the byte) and placed on its torus; Granite-
# 34B at full width, depth 88 -> 2, bf16, served on a (2, 2) world of
# gloo ranks on cuda:0 (4 x 2048 prompts, a cache of 2048 + 8 positions,
# 8 greedy steps) against one device; the SMOKE configs of every block
# kind in f32 on a (2, 2) world against one CPU device.
SERVE_CELLS = (("granite_34b", "decode_32k"), ("granite_34b", "prefill_32k"),
               ("qwen3_moe_235b_a22b", "decode_32k"))
# (arch, cell) -> a device's cache bytes: layers x (k, v) x B / 16 x
# S / 16 x kv heads x head_dim x 2 bytes
SERVE_CACHE_BYTES = {("granite_34b", "decode_32k"): 738_197_504,
                     ("granite_34b", "prefill_32k"): 184_549_376,
                     ("qwen3_moe_235b_a22b", "decode_32k"): 3_154_116_608}
SERVE_LAYERS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 2, 4, 2048, 8
SERVE_TOL = 1e-2         # bf16: of the logits' largest magnitude
# The SMOKE world: tests/_torch_serve_world.py's cases (4 x 44 prompts, a
# cache of 52, 5 greedy steps; Gemma3's 32-token ring wraps across two
# ranks' slices), Jamba also at a capped expert capacity, whose decode
# routes the global batch over the data axis
SERVE_SMOKE = (("qwen3_4b", {}), ("granite_34b", {}), ("gemma3_4b", {}),
               ("jamba_v0_1_52b", dict(num_experts=16)),
               ("jamba_v0_1_52b", dict(num_experts=16,
                                       moe_capacity_factor=1.25)),
               ("rwkv6_7b", {}))

# The launchers route: the dry run of production cells at full width and
# depth on the (16, 16) mesh (their work counted on meta, roofline terms
# at the H100's datasheet rates), inspect_cell's top contributors, the
# placement benchmark's six solves on 512 ranks, and SAConfig.event_width
# on the card (psa-event engines at the default width, "auto", 1 and 6 on
# the 64 and 32 buckets' 3-request waves).
LAUNCH_DRYRUN = (("qwen3_4b", "train_4k"), ("granite_34b", "decode_32k"),
                 ("qwen3_moe_235b_a22b", "prefill_32k"),
                 ("qwen3_4b", "long_500k"))
LAUNCH_INSPECT = ("granite_34b", "decode_32k")
LAUNCH_PLACE = ("gemma3_4b", "train_4k")
LAUNCH_WIDTHS = (None, "auto", 1, 6)
LAUNCH_ORDERS = (45, 27)                 # the 64 and 32 buckets
LAUNCH_USEFUL = (0.2, 1.0)               # model FLOPs / counted FLOPs

# The CPU sides of the card == CPU checks of the dense routes, multilevel,
# exact-size and rm-replay (cpu_check), run from the script's start in a
# pool of spawned processes beside the card's routes: a route's check
# then costs the card's host no wall of its own.
CPU_CHECK_WORKERS, CPU_CHECK_THREADS = 3, 2

# route -> (algorithm, SAConfig changes, GAConfig changes)
ROUTES = {
    "psa-event": ("psa", dict(loop="event"), {}),
    "psa-fused": ("psa", dict(loop="fused"), {}),
    "pga-wide": ("pga", {}, dict(eval="wide")),
    "pga-fused": ("pga", {}, dict(eval="fused")),
    "pca": ("pca", {}, {}),
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launches_since(before):
    """Launches by kernel since ``before`` was read from
    ``ops.launch_counts()``."""
    from repro_torch.kernels import ops
    return {k: v - before[k] for k, v in ops.launch_counts().items()}


def graph_ms(fn, reps):
    """Mean device milliseconds per call: ``reps`` calls captured in one
    CUDA graph and replayed, so no host work sits between the launches
    (``cuda_ms`` of a small kernel measures how fast the host issues it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wave_instances(device):
    """32 padded order-125 instances (make_taie versions 1..32)."""
    import numpy as np
    import torch
    from repro_torch.core import instances
    Cs = np.zeros((WAVE, BUCKET, BUCKET), np.float32)
    Ms = np.zeros((WAVE, BUCKET, BUCKET), np.float32)
    for v in range(WAVE):
        inst = instances.make_taie(ORDER, version=v + 1)
        Cs[v, :ORDER, :ORDER] = inst.C
        Ms[v, :ORDER, :ORDER] = inst.M
    return torch.as_tensor(Cs, device=device), torch.as_tensor(Ms, device=device)


def integer_instances(n, count, seed, device):
    """``count`` symmetric integer-valued instances of order ``n`` (C in
    [0, 18], M in [2, 18]) from a seeded numpy generator."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    C = rng.integers(0, 10, (count, n, n)).astype(np.float32)
    M = rng.integers(1, 10, (count, n, n)).astype(np.float32)
    C, M = C + C.transpose(0, 2, 1), M + M.transpose(0, 2, 1)
    return torch.as_tensor(C, device=device), torch.as_tensor(M, device=device)


def branch_launched(kernel, branch, fn):
    """Run ``fn`` and require that it launched ``kernel`` once, on
    ``branch`` ("smem" or "l2")."""
    from repro_torch.kernels import ops
    before = ops.branch_counts()
    out = fn()
    after = ops.branch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    require(moved == {f"{kernel}/{branch}": 1},
            f"{kernel}: expected one launch on its {branch} branch, got "
            f"{moved}")
    return out


def padded_integer_instances(n, nv, count, seed, device):
    """``integer_instances`` of order ``nv`` zero-padded into order ``n``
    (the ragged edge and padded tail of an engine wave)."""
    import torch
    C, M = integer_instances(nv, count, seed, device)
    Cp = torch.zeros((count, n, n), device=device)
    Mp = torch.zeros((count, n, n), device=device)
    Cp[:, :nv, :nv], Mp[:, :nv, :nv] = C, M
    return Cp, Mp


def delta_bound_words(C, p, pairs):
    """Words K1 must move for these candidates: of each instance's C and
    M, the entries of the rows and columns its candidates read (C's a
    and b, M's u = p[a] and v = p[b]), each once; and p and the pairs
    in, the deltas out.  Returns ``(matrix words, other words)``."""
    import torch
    B, n = p.shape
    k = pairs.shape[1]
    b0 = C.shape[0] if C.dim() == 3 else 1
    inst = torch.arange(B, device=p.device) // (B // b0)
    ab = pairs.long()
    uv = torch.gather(p.long(), 1, ab.reshape(B, -1)).reshape(ab.shape)
    words = 0
    for i in range(b0):
        for idx in (ab[inst == i], uv[inst == i]):
            s = torch.unique(idx).numel()
            words += min(n * n, 2 * s * n - s * s)
    return words, B * n + B * k * 3


def check_qap_delta(device):
    """K1 against its plain version, each launch on the branch its order
    selects: the shared-memory branch at the 128 bucket's event-loop shape
    (512 chains x 25 candidates) and polish shape (32 x 256), shared and
    per instance; the L2 branch at order 256 (8 integer instances, 128
    chains x 25), one order class above the threshold, and at the
    service's exact-size shapes of an order-193 request padded into 200
    (16 chains x 25 candidates, the polish's 1 x 256); the L2 branch's
    unstaged kernel at ``L2_UNSTAGED_ORDER`` (2 chains x 16)."""
    import torch
    from repro_torch.core import keys, qap
    from repro_torch.kernels.qap_delta import qap_delta_cuda, qap_delta_plain
    Cs, Ms = wave_instances(device)
    nv = torch.full((WAVE,), ORDER, dtype=torch.int64, device=device)
    Cs = qap.mask_flows(Cs, nv)
    C2, M2 = integer_instances(L2_ORDER, 8, 256, device)
    Ce, Me = padded_integer_instances(EXACT_ORDER, EXACT_NV, 1, 200, device)
    g = torch.Generator(device=device).manual_seed(L2_UNSTAGED_ORDER)
    shape = (1, L2_UNSTAGED_ORDER, L2_UNSTAGED_ORDER)
    Cu = torch.randint(0, 10, shape, generator=g, device=device).float()
    Mu = torch.randint(1, 10, shape, generator=g, device=device).float()
    base = keys.prng_key(2024, device)
    chains_e = NUM_PROCESSES * SA_KW["solvers"]
    out = {}
    for label, branch, (Cb, Mb, order, n), chains, k in (
            ("event", "smem", (Cs, Ms, ORDER, BUCKET),
             WAVE * NUM_PROCESSES * SA_KW["solvers"], SA_KW["max_neighbors"]),
            ("polish", "smem", (Cs, Ms, ORDER, BUCKET), WAVE, POLISH_K),
            ("l2", "l2", (C2, M2, L2_ORDER, L2_ORDER), 8 * 16,
             SA_KW["max_neighbors"]),
            ("exact", "l2", (Ce, Me, EXACT_NV, EXACT_ORDER), chains_e,
             SA_KW["max_neighbors"]),
            ("exact-polish", "l2", (Ce, Me, EXACT_NV, EXACT_ORDER), 1,
             POLISH_K),
            ("unstaged", "l2_unstaged",
             (Cu, Mu, L2_UNSTAGED_ORDER, L2_UNSTAGED_ORDER), 2, 16)):
        CT = Cb.transpose(1, 2).contiguous()
        MT = Mb.transpose(1, 2).contiguous()
        ck = keys.split(keys.fold_in(base, k), chains)
        p = qap.masked_random_permutation(ck, n, order)
        nv = torch.full((chains,), order, device=device)
        pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), k, n, nv)
        cases = [("batched", (Cb, Mb, CT, MT))]
        if Cb.shape[0] > 1:
            cases.append(("shared", (Cb[0].contiguous(), Mb[0].contiguous(),
                                     CT[0].contiguous(), MT[0].contiguous())))
        for mats, (C, M, Ct, Mt) in cases:
            launch = lambda: qap_delta_cuda(C, M, p, pairs, Ct, Mt)
            got = branch_launched("qap_delta", branch, launch)
            want = qap_delta_plain(C, M, p, pairs)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.equal(got, want), f"qap_delta {label}/{mats}: "
                    f"kernel != plain, max err {err}")
            ms, dev_ms = cuda_ms(launch, 200), graph_ms(launch, 200)
            plain = cuda_ms(lambda: qap_delta_plain(C, M, p, pairs), 20)
            words, io = delta_bound_words(C, p, pairs)
            bound, by = bound_ms(4 * (words + io), 8 * n * chains * k)
            bound4, _ = bound_ms(4 * (2 * words + io), 8 * n * chains * k)
            out[(label, mats)] = dict(err=err, ms=ms, graph_ms=dev_ms,
                                      plain_ms=plain, bound_ms=bound,
                                      bound_by=by)
            print(f"qap_delta {label:12s} {mats:7s} N={n} B={chains} K={k} "
                  f"({branch} branch): kernel {ms:.4f} ms ({dev_ms:.4f} ms in "
                  f"a graph), plain {plain:.4f} ms, bound {bound:.4f} ms "
                  f"({by}; {bound4:.4f} counting C^T and M^T as well), max "
                  f"err {err}", flush=True)
    return out


def scan_evaluated(C, M, p, f, temp, keys_w, nv, k, max_success):
    """Candidates the sequential scan scores before the acceptance cap
    stops it: the work K4's data needs in this step."""
    import torch
    from repro_torch.core import qap
    from repro_torch.kernels import prng
    from repro_torch.kernels.qap_delta import qap_delta_plain
    pairs, us = prng.sa_step_draws(keys_w, k, nv)
    tsafe = temp.clamp_min(1e-9)
    succ = torch.zeros_like(nv, dtype=torch.long)
    evaluated = 0
    for t in range(k):
        active = succ < max_success
        evaluated += int(active.sum())
        d = qap_delta_plain(C, M, p, pairs[:, t:t + 1])[:, 0]
        acc = ((d < 0) | (us[:, t] < torch.exp(-d / tsafe))) & active
        p = torch.where(acc[:, None],
                        qap.swap_positions(p, pairs[:, t, 0], pairs[:, t, 1]), p)
        succ += acc.long()
    return evaluated


def check_qap_sa_step(device):
    """K4 against its plain version, starting at T0, 25 candidates, at
    most 10 acceptances: the shared-memory branch at the 128 bucket (512
    chains, order 125, one warp per chain), the L2 branch at order 256 (8
    integer instances x 16 chains).  Returns the 128 bucket's numbers."""
    import torch
    from repro_torch.core import annealing, keys, qap
    from repro_torch.kernels.qap_sa_step import (qap_sa_step_cuda,
                                                 qap_sa_step_plain)
    Cs, Ms = wave_instances(device)
    nv_i = torch.full((WAVE,), ORDER, dtype=torch.int64, device=device)
    Cs = qap.mask_flows(Cs, nv_i)
    C2, M2 = integer_instances(L2_ORDER, 8, 257, device)
    rpt = NUM_PROCESSES * SA_KW["solvers"]
    k, cap = SA_KW["max_neighbors"], 10
    out = {}
    for label, Cb, Mb, order, n in (("smem", Cs, Ms, ORDER, BUCKET),
                                    ("l2", C2, M2, L2_ORDER, L2_ORDER)):
        b0 = Cb.shape[0]
        chains = b0 * rpt
        CT = Cb.transpose(1, 2).contiguous()
        MT = Mb.transpose(1, 2).contiguous()
        ck = keys.split(keys.prng_key(7, device), chains)
        p = qap.masked_random_permutation(ck, n, order)
        f = qap.objective(Cb, Mb, p.view(b0, rpt, n)).reshape(-1)
        temp = annealing.initial_temperature(f, 0.3, 0.3)
        nv = torch.full((chains,), order, dtype=torch.int32, device=device)
        step_keys = keys.fold_in(ck, 3)
        args = (Cb, Mb, p, f, p.clone(), f.clone(), temp, step_keys, nv)
        launch = lambda: qap_sa_step_cuda(*args, max_neighbors=k,
                                          max_success=cap, CT=CT, MT=MT)
        got = branch_launched("qap_sa_step", label, launch)
        want = qap_sa_step_plain(*args, max_neighbors=k, max_success=cap)
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        for name, g, w in zip(("p", "f", "best_p", "best_f"), got, want):
            require(torch.equal(g, w), f"qap_sa_step {label} {name}: kernel "
                    f"!= plain (max err {err})")
        ms, dev_ms = cuda_ms(launch, 100), graph_ms(launch, 100)
        plain = cuda_ms(lambda: qap_sa_step_plain(*args, max_neighbors=k,
                                                  max_success=cap), 10)
        evaluated = scan_evaluated(Cb, Mb, p, f, temp, step_keys, nv, k, cap)
        io = (4 * 4 * chains * n              # p, best_p in and out
              + chains * (4 * 4 + 16 + 4 * 2))  # f, bf, temp, nv, keys; out
        bound, by = bound_ms(4 * 2 * b0 * n * n + io, 8 * n * evaluated)
        bound4, _ = bound_ms(4 * 4 * b0 * n * n + io, 8 * n * evaluated)
        out[label] = dict(err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain,
                          bound_ms=bound, bound_by=by)
        print(f"qap_sa_step B={chains} N={n} K={k} cap={cap} ({label} "
              f"branch): kernel {ms:.4f} ms ({dev_ms:.4f} ms in a graph), "
              f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{bound4:.4f} counting C^T and M^T as well), {evaluated} of "
              f"{chains * k} "
              f"candidates scored, max err {err}", flush=True)
    return out["smem"]


def check_qap_sa_round(device, steps=100):
    """K4's round, the mode the fused PSA runs on the shared-memory
    branch, against the plain round: ``steps`` temperature steps in one
    launch from round keys at the 128 bucket (512 chains, order 125), 25
    candidates and at most 10 acceptances a step, Cauchy cooling from T0
    with a beta that reaches t_final halfway, so the clamp acts too.
    Temperatures are compared with the state.  The bound is the round's
    work: C, M and the chains' state read once, 8 N operations for each
    candidate the sequential scan scores in each of the steps."""
    import torch
    from repro_torch.core import annealing, keys, qap
    from repro_torch.kernels.qap_sa_step import (cooled, qap_sa_step_cuda,
                                                 qap_sa_step_plain)
    Cs, Ms = wave_instances(device)
    nv_i = torch.full((WAVE,), ORDER, dtype=torch.int64, device=device)
    Cs = qap.mask_flows(Cs, nv_i)
    rpt = NUM_PROCESSES * SA_KW["solvers"]
    k, cap, n, chains = SA_KW["max_neighbors"], 10, BUCKET, WAVE * rpt
    cfg = annealing.SAConfig(max_neighbors=k, max_success=cap,
                             iters_per_exchange=steps // 2, num_exchanges=1)
    key = keys.split(keys.prng_key(35, device), 3)
    beta = annealing.make_beta(Cs, Ms, keys.split(key[0], WAVE), cfg, nv_i)
    cooling = annealing._cooling(cfg, beta.repeat_interleave(rpt))
    ck = keys.split(key[1], chains)
    p = qap.masked_random_permutation(ck, n, ORDER)
    f = qap.objective(Cs, Ms, p.view(WAVE, rpt, n)).reshape(-1)
    temp = annealing.initial_temperature(f, cfg.mu, cfg.phi)
    nv = torch.full((chains,), ORDER, dtype=torch.int32, device=device)
    round_keys = keys.split(key[2], chains)
    args = (Cs, Ms, p, f, p.clone(), f.clone(), temp, round_keys, nv)
    kw = dict(max_neighbors=k, max_success=cap, steps=steps, cooling=cooling)
    t_kernel, t_plain = torch.empty_like(temp), torch.empty_like(temp)
    launch = lambda: qap_sa_step_cuda(*args, temp_out=t_kernel, **kw)
    plain = lambda: qap_sa_step_plain(*args, temp_out=t_plain, **kw)
    got = branch_launched("qap_sa_step", "smem_round", launch) + (t_kernel,)
    want = plain() + (t_plain,)
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    for name, g, w in zip(("p", "f", "best_p", "best_f", "temp"), got, want):
        require(torch.equal(g, w), f"qap_sa_step round {name}: kernel != "
                f"plain (max err {err})")
    require(bool((t_kernel == cooling.t_final).all()),
            "qap_sa_step round: t_final not reached")
    # the scan's scored candidates, step by step along the plain round
    evaluated, state = 0, args[2:7]
    step_keys = keys.split(round_keys, steps)
    for t in range(steps):
        sp, sf, sbp, sbf, st = state
        evaluated += scan_evaluated(Cs, Ms, sp, sf, st, step_keys[:, t], nv,
                                    k, cap)
        state = qap_sa_step_plain(Cs, Ms, sp, sf, sbp, sbf, st,
                                  step_keys[:, t], nv, max_neighbors=k,
                                  max_success=cap) + (cooled(st, cooling),)
    ms, dev_ms = cuda_ms(launch, 20), graph_ms(launch, 20)
    plain_ms = cuda_ms(plain, 2)
    io = (4 * 4 * chains * n                 # p, best_p in and out
          + chains * (4 * 4 + 4 * 2 + 4 + 16 + 4))  # f, bf, T, nv, keys, beta
    bound, by = bound_ms(4 * 2 * WAVE * n * n + io, 8 * n * evaluated)
    print(f"qap_sa_step round B={chains} N={n} K={k} cap={cap} steps={steps} "
          f"(smem_round branch): kernel {ms:.4f} ms ({dev_ms:.4f} ms in a "
          f"graph), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
          f"{evaluated} of {chains * k * steps} candidates scored, max err "
          f"{err}", flush=True)
    return dict(err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


def island_populations(device, pop):
    """``ISLANDS`` populations of ``pop`` random order-125 permutations in
    the 128 bucket (identity tail), over the wave's masked instances."""
    import torch
    from repro_torch.core import keys, qap
    Cs, Ms = wave_instances(device)
    Cs = qap.mask_flows(Cs, torch.full((WAVE,), ORDER, device=device))
    ck = keys.split(keys.prng_key(pop, device), ISLANDS)
    pops = qap.masked_random_permutations(ck, pop, BUCKET, ORDER).contiguous()
    return Cs, Ms, pops


# K2 and K5 at order L2_ORDER, past their shared-memory thresholds: 8
# integer instances of NUM_PROCESSES islands each.
L2_INSTANCES = 8


def ga_shapes(device, pop):
    """``(branch, C, M, pops, order)`` of each branch K2 and K5 take on the
    GA's path: the 128 bucket's wave (shared memory) and ``L2_INSTANCES``
    integer instances of order ``L2_ORDER`` (L2), ``pop`` members an
    island."""
    from repro_torch.core import keys, qap
    Cs, Ms, pops = island_populations(device, pop)
    C2, M2 = integer_instances(L2_ORDER, L2_INSTANCES, 258, device)
    ck = keys.split(keys.prng_key(pop + 1, device),
                    L2_INSTANCES * NUM_PROCESSES)
    pops2 = qap.masked_random_permutations(ck, pop, L2_ORDER,
                                           L2_ORDER).contiguous()
    return (("smem", Cs, Ms, pops, ORDER), ("l2", C2, M2, pops2, L2_ORDER))


def exact_populations(device, pop):
    """``NUM_PROCESSES`` islands of ``pop`` random order-193 permutations
    in order 200 (identity tail) over the padded integer instance: the GA
    of one exact-size request."""
    from repro_torch.core import keys, qap
    Ce, Me = padded_integer_instances(EXACT_ORDER, EXACT_NV, 1, 200, device)
    ck = keys.split(keys.prng_key(pop + 2, device), NUM_PROCESSES)
    pops = qap.masked_random_permutations(ck, pop, EXACT_ORDER,
                                          EXACT_NV).contiguous()
    return Ce, Me, pops


def check_qap_objective(device):
    """K2 against its plain version at the GA's shapes, each launch on the
    branch its order selects: one generation's children (16 an island)
    and the initial populations (32 an island), per instance and shared,
    on the shared-memory branch at the 128 bucket (64 islands) and on the
    L2 branch at order 256 (16 islands) and at one exact-size request of
    order 193 padded into 200 (2 islands); then the L2 branch at
    sparse_scale's dense baseline, 8 permutations of one order-4096
    instance of 0/1 entries, bitwise; then on real-valued flows at order
    200: the same bits on a second call and for each permutation alone
    (the L2 branch's tiling depends on the order alone)."""
    import torch
    from repro_torch.core import keys, qap
    from repro_torch.kernels.qap_objective import (qap_objective_cuda,
                                                   qap_objective_plain)
    out = {}
    for label, pop in (("generation", N_OFF), ("init", GA_KW["pop_size"])):
        shapes = ga_shapes(device, pop) + (
            ("l2", *exact_populations(device, pop), EXACT_NV),)
        for branch, Cs, Ms, pops, order in shapes:
            n = pops.shape[-1]
            cases = [("batched", (Cs, Ms))]
            if Cs.shape[0] > 1:
                cases.append(("shared", (Cs[0].contiguous(),
                                         Ms[0].contiguous())))
            for mats, (C, M) in cases:
                launch = lambda: qap_objective_cuda(C, M, pops)
                got = branch_launched("qap_objective", branch, launch)
                want = qap_objective_plain(C, M, pops)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                require(torch.equal(got, want), f"qap_objective {label}/"
                        f"{branch}/{mats} N={n}: kernel != plain, max err "
                        f"{err}")
                ms, dev_ms = cuda_ms(launch, 200), graph_ms(launch, 200)
                plain = cuda_ms(lambda: qap_objective_plain(C, M, pops), 20)
                b0 = C.shape[0] if C.dim() == 3 else 1
                count = pops.shape[0] * pop
                nbytes = 4 * (2 * b0 * n * n + count * n + count)
                bound, by = bound_ms(nbytes, 2 * n * n * count)
                out[(label, branch, mats, n)] = dict(
                    err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by)
                print(f"qap_objective {label:10s} {mats:7s} N={n} "
                      f"{pops.shape[0]}x{pop} ({branch} branch): kernel "
                      f"{ms:.4f} ms ({dev_ms:.4f} ms in a graph), plain "
                      f"{plain:.4f} ms, bound {bound:.4f} ms ({by}), max err "
                      f"{err}", flush=True)

    n, count = K2_WIDE_ORDER, K2_WIDE_PERMS
    g = torch.Generator(device=device).manual_seed(4096)
    C = torch.randint(0, 2, (n, n), generator=g, device=device).float()
    M = torch.randint(0, 2, (n, n), generator=g, device=device).float()
    perms = qap.random_permutations(keys.prng_key(n, device), count,
                                    n)[None].contiguous()
    launch = lambda: qap_objective_cuda(C, M, perms)
    got = branch_launched("qap_objective", "l2", launch)
    want = qap_objective_plain(C, M, perms)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(float(want.max()) <= F32_EXACT and torch.equal(got, want),
            f"qap_objective N={n} 1x{count}: kernel != plain, max err {err} "
            f"(max F {float(want.max())})")
    ms, dev_ms = cuda_ms(launch, 20), graph_ms(launch, 20)
    plain = cuda_ms(lambda: qap_objective_plain(C, M, perms), 3)
    bound, by = bound_ms(4 * (2 * n * n + count * n + count),
                         2 * n * n * count)
    out[("wide", "l2", "shared", n)] = dict(
        err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain, bound_ms=bound,
        bound_by=by)
    print(f"qap_objective wide       shared  N={n} 1x{count} (l2 branch): "
          f"kernel {ms:.4f} ms ({dev_ms:.4f} ms in a graph), plain "
          f"{plain:.4f} ms, bound {bound:.4f} ms ({by}), max err {err}, max "
          f"F {float(want.max()):.0f}", flush=True)
    del C, M

    Ce, Me, pops = exact_populations(device, GA_KW["pop_size"])
    g = torch.Generator(device=device).manual_seed(200)
    C = Ce * torch.rand(Ce.shape, generator=g, device=device)
    M = Me * torch.rand(Me.shape, generator=g, device=device)
    got = qap_objective_cuda(C, M, pops)
    again = qap_objective_cuda(C, M, pops)
    alone = torch.stack([qap_objective_cuda(C, M, q[None, None].contiguous())
                         .reshape(()) for q in pops.reshape(-1, EXACT_ORDER)])
    want = qap_objective_plain(C, M, pops)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    require(torch.equal(got, again) and torch.equal(got.reshape(-1), alone),
            f"qap_objective N={EXACT_ORDER}: real-valued flows gave other "
            f"bits on another call or alone")
    require(err <= 1e-5 * scale, f"qap_objective N={EXACT_ORDER}: real-"
            f"valued max err {err} > 1e-5 * {scale}")
    print(f"qap_objective N={EXACT_ORDER} {tuple(pops.shape[:2])} real-valued "
          f"(l2 branch): the same bits on two calls and alone, max err "
          f"{err:.3e} against the plain version (max |F| {scale:.4e})",
          flush=True)
    return out


def check_qap_ga_step(device):
    """K5 against its plain version on both branches: the shared-memory
    one with 64 islands of 32, order 125 in the 128 bucket, the L2 one
    with 16 islands of 32 at order 256; each at the engine's GA settings
    (16 children, binary tournaments, OX, p_mutation 0.001) and at a wider
    setting (32 children, more than the kernel's 16 warps: every member
    replaced, the elitism guard; OXS, p_mutation 0.3); then the L2 one at
    Table 1's fused PGA on tai343 (``check_ga_step_table1``).  Returns the
    128 bucket's numbers at the engine's settings, the largest error of
    all."""
    import torch
    from repro_torch.core import keys
    from repro_torch.kernels.qap_ga_step import (qap_ga_step_cuda,
                                                 qap_ga_step_plain)
    from repro_torch.kernels.qap_objective import qap_objective_plain
    pop = GA_KW["pop_size"]
    engine_kw = dict(n_off=N_OFF, tournament=2, p_crossover=1.0,
                     p_mutation=0.001, crossover="ox")
    wide_kw = dict(n_off=pop, tournament=3, p_crossover=0.7, p_mutation=0.3,
                   crossover="oxs")
    out = {}
    for branch, Cs, Ms, pops, order in ga_shapes(device, pop):
        islands, _, n = pops.shape
        fits = qap_objective_plain(Cs, Ms, pops)
        step_keys = keys.split(keys.prng_key(5, device), islands)
        nv = torch.full((islands,), order, dtype=torch.int32, device=device)
        args = (Cs, Ms, pops, fits, step_keys, nv)
        err = 0.0
        for kw in (engine_kw, wide_kw):
            got = branch_launched("qap_ga_step", branch,
                                  lambda: qap_ga_step_cuda(*args, **kw))
            want = qap_ga_step_plain(*args, **kw)
            torch.cuda.synchronize()
            for name, g, w in zip(("pop", "fit"), got, want):
                e = float((g.float() - w.float()).abs().max())
                err = max(err, e)
                require(torch.equal(g, w), f"qap_ga_step {branch} {name} "
                        f"{kw}: kernel != plain (max err {e})")
        launch = lambda: qap_ga_step_cuda(*args, **engine_kw)
        ms, dev_ms = cuda_ms(launch, 100), graph_ms(launch, 100)
        plain = cuda_ms(lambda: qap_ga_step_plain(*args, **engine_kw), 10)
        nbytes = (4 * 2 * Cs.shape[0] * n * n        # C, M
                  + 2 * 4 * islands * pop * n        # populations in and out
                  + 2 * 4 * islands * pop            # fitness in and out
                  + islands * (8 + 4))               # key words, n_valid
        bound, by = bound_ms(nbytes, 2 * n * n * islands * N_OFF)
        out[branch] = dict(err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by)
        print(f"qap_ga_step {islands} islands x {pop}, {N_OFF} children, "
              f"N={n} ({branch} branch): kernel {ms:.4f} ms ({dev_ms:.4f} ms "
              f"in a graph), plain {plain:.4f} ms, bound {bound:.4f} ms "
              f"({by}), max err {err}", flush=True)
    out["table1"] = dict(err=check_ga_step_table1(device))
    out["smem"]["err"] = max(v["err"] for v in out.values())
    return out["smem"]


def check_ga_step_table1(device):
    """K5 at Table 1's fused PGA on tai343e01s (4 islands of min(n, 128)
    members, 64 children, the GA's default operators): one launch on the
    L2 branch, equal to the plain version bit for bit (F < 2^24)."""
    import torch
    from repro_torch.core import instances, keys, qap
    from repro_torch.kernels.qap_ga_step import (qap_ga_step_cuda,
                                                 qap_ga_step_plain)
    from repro_torch.kernels.qap_objective import qap_objective_plain
    n = PAPER_KERNEL_ORDERS[0]
    inst = instances.get_instance(n)
    C = torch.as_tensor(inst.C, device=device)
    M = torch.as_tensor(inst.M, device=device)
    pops = qap.random_permutations(keys.split(keys.prng_key(n, device), 4),
                                   128, n)
    fits = qap_objective_plain(C, M, pops)
    step_keys = keys.split(keys.prng_key(n + 1, device), 4)
    nv = torch.full((4,), n, dtype=torch.int32, device=device)
    args = (C, M, pops, fits, step_keys, nv)
    kw = dict(n_off=64, tournament=2, p_crossover=1.0, p_mutation=0.001,
              crossover="ox")
    got = branch_launched("qap_ga_step", "l2",
                          lambda: qap_ga_step_cuda(*args, **kw))
    want = qap_ga_step_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    require(float(want[1].max()) < F32_EXACT, f"qap_ga_step tai{n}: F "
            f"{float(want[1].max())} passes f32's exact range")
    for name, g, w in zip(("pop", "fit"), got, want):
        require(torch.equal(g, w), f"qap_ga_step tai{n} 4x128 {name}: kernel "
                f"!= plain (max err {err})")
    print(f"qap_ga_step tai{n}e01s 4 islands x 128, 64 children (l2 branch): "
          f"equal to the plain version bit for bit", flush=True)
    return err


@functools.lru_cache(maxsize=None)
def torus(dims):
    from repro_torch.core import exact
    return exact.make_torus(dims)


@functools.lru_cache(maxsize=None)
def torus_levels():
    """The 4096 torus's level stack at the default MultilevelConfig:
    ``[(C, M, flow_pairs, sys_pairs), ...]``, finest first."""
    from repro_torch.core import multilevel
    inst = torus(ML_TORI[-1])
    stack, _ = multilevel.coarsen_levels(inst.C, inst.M,
                                         multilevel.MultilevelConfig())
    return stack


def second_instance(C, M, seed):
    """Another instance of the same order and ELL width: C and M
    relabelled by two random permutations."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s, t = rng.permutation(C.shape[0]), rng.permutation(C.shape[0])
    return C[np.ix_(s, s)], M[np.ix_(t, t)]


def flows_pair(C, M, b0, device):
    """Shared ``(S, M)`` for ``b0 == 0``, else ``b0`` instances (the level
    and relabelled copies) with batched leaves."""
    import numpy as np
    import torch
    from repro_torch.core import sparse
    if b0 == 0:
        return (sparse.from_dense(C, device=device),
                torch.as_tensor(M, device=device))
    mats = [(C, M)] + [second_instance(C, M, i) for i in range(1, b0)]
    Cs = np.stack([c for c, _ in mats])
    Ms = np.stack([m for _, m in mats])
    return (sparse.from_dense(Cs, device=device),
            torch.as_tensor(Ms, device=device))


def _unique(idx):
    import torch
    return int(torch.unique(torch.cat([i.reshape(-1) for i in idx])).numel())


def objective_sparse_work(S, M, perms):
    """(bytes, f32 ops) that K6's inputs need: each stored nonzero of the
    flows (column id and value) once per instance, every permutation,
    each distinct M entry the nonzeros select, the outputs."""
    import torch
    B, P, n = perms.shape
    b0 = M.shape[0] if M.dim() == 3 else 1
    d = S.max_degree
    cols = S.cols.long().reshape(b0, n, d)
    nz = S.vals.reshape(b0, n, d) != 0
    q = B * P // b0
    pl = perms.long().reshape(b0, q, n)
    pc = torch.gather(pl, 2, cols.reshape(b0, 1, n * d).expand(b0, q, n * d))
    inst = torch.arange(b0, device=perms.device).view(b0, 1, 1, 1)
    lin = inst * n * n + pl[..., None] * n + pc.reshape(b0, q, n, d)
    m_entries = _unique([lin[nz[:, None].expand_as(lin)]])
    nnz = int(nz.sum())
    return (8 * nnz + 4 * B * P * n + 4 * m_entries + 4 * B * P,
            2 * nnz * q)


def delta_sparse_work(S, M, p, pairs):
    """(bytes, f32 ops) that K7's inputs need: the ELL rows a and b of C
    and C^T (their stored nonzeros), each distinct entry of p and of M
    the unmasked nonzeros and the corners select, the pairs, the
    outputs."""
    import torch
    B, n = p.shape
    K = pairs.shape[1]
    b0 = M.shape[0] if M.dim() == 3 else 1
    d = S.max_degree
    inst = (torch.arange(B, device=p.device) // (B // b0))[:, None].expand(B, K)
    pl = p.long()
    a, b = pairs[..., 0].long(), pairs[..., 1].long()
    u, v = torch.gather(pl, 1, a), torch.gather(pl, 1, b)
    row = torch.arange(B, device=p.device)[:, None].expand(B, K)
    m_idx = [inst * n * n + x * n + y for x, y in ((u, u), (v, v), (u, v),
                                                   (v, u))]
    p_idx = [row * n + a, row * n + b]
    ops = 13 * B * K
    ell_rows = [inst * n + a, inst * n + b]
    for cols, vals, transposed in ((S.cols, S.vals, False),
                                   (S.cols_t, S.vals_t, True)):
        cols = cols.long().reshape(b0, n, d)
        vals = vals.reshape(b0, n, d)
        for r in (a, b):
            ks, ws = cols[inst, r], vals[inst, r]               # (B, K, D)
            keep = (ws != 0) & (ks != a[..., None]) & (ks != b[..., None])
            pk = torch.gather(pl, 1, ks.reshape(B, -1)).reshape(ks.shape)
            base = inst[..., None] * n * n
            for x in (u, v):
                xi = x[..., None]
                lin = base + (pk * n + xi if transposed else xi * n + pk)
                m_idx.append(lin[keep])
            p_idx.append((row[..., None] * n + ks)[keep])
            ops += 3 * int(keep.sum())
    deg = torch.stack([S.deg.reshape(b0, n), S.deg_t.reshape(b0, n)])
    rows = torch.unique(torch.cat([r.reshape(-1) for r in ell_rows]))
    ell_bytes = 8 * int(deg.reshape(2, -1)[:, rows].sum())
    return (ell_bytes + 4 * _unique(m_idx) + 4 * _unique(p_idx)
            + 12 * B * K, ops)


def check_qap_delta_sparse(device):
    """K7 against its plain version on the 4096 torus's finest (n=4096,
    D=6) and coarsest (n=128, D=46) refinement levels, at the refinement
    shape (4 chains x 16 candidates, shared leaves and two instances)
    and the polish shape (1 x 256, shared and the engine's one-instance
    batch)."""
    import torch
    from repro_torch.core import keys, qap
    from repro_torch.kernels.qap_sparse import (qap_delta_sparse_cuda,
                                                qap_delta_sparse_plain)
    stack = torus_levels()
    out = {}
    for level, (C, M, _, _) in (("finest", stack[0]), ("coarsest", stack[-1])):
        n = C.shape[0]
        for label, chains, k in (("refine", ML_CHAINS, ML_K),
                                 ("polish", 1, POLISH_K)):
            ck = keys.split(keys.prng_key(n + k, device), chains)
            p = qap.random_permutation(ck, n)
            pairs = qap.random_swap_pairs(keys.fold_in(ck, 1), k, n)
            for mats, b0 in (("shared", 0), ("batched", min(2, chains))):
                S, Mt = flows_pair(C, M, b0, device)
                launch = lambda: qap_delta_sparse_cuda(S, Mt, p, pairs)
                got = launch()
                want = qap_delta_sparse_plain(S, Mt, p, pairs)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                require(torch.equal(got, want), f"qap_delta_sparse {level}/"
                        f"{label}/{mats}: kernel != plain, max err {err}")
                ms, dev_ms = cuda_ms(launch, 200), graph_ms(launch, 200)
                plain = cuda_ms(lambda: qap_delta_sparse_plain(S, Mt, p,
                                                               pairs), 20)
                bound, by = bound_ms(*delta_sparse_work(S, Mt, p, pairs))
                out[(level, label, mats)] = dict(
                    err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by)
                print(f"qap_delta_sparse {level:8s} N={n} D={S.max_degree} "
                      f"{label:6s} {mats:7s} B={chains} K={k}: kernel "
                      f"{ms:.4f} ms ({dev_ms:.4f} ms in a graph), plain "
                      f"{plain:.4f} ms, bound {bound:.6f} ms ({by}), max err "
                      f"{err}", flush=True)
    return out


def check_qap_objective_sparse(device):
    """K6 against its plain version, bit for bit: at every level of the
    4096 torus (n 4096 ... 128, D 6 ... 46) at the route's two shapes, 1
    x 1 (``make_beta``, ``_seed_chain0``) and 1 x 4 (the chain start), and
    at a wider 64 x 4 batch on the finest level; shared leaves and
    batched ones (the engine's one instance; two at 64 x 4).  Then on
    real-valued flows at the finest and coarsest levels: two calls give
    the same bits, a permutation alone the same bits as in the batch,
    within 1e-5 of the plain version's largest |F|."""
    import torch
    from repro_torch.core import keys, qap, sparse
    from repro_torch.kernels.qap_sparse import (qap_objective_sparse_cuda,
                                                qap_objective_sparse_plain)
    stack = torus_levels()
    out = {}
    cases = [(level, 1, per) for level in stack for per in (1, ML_CHAINS)]
    for level, rows, per in cases + [(stack[0], 64, ML_CHAINS)]:
        C, M = level[0], level[1]
        n = C.shape[0]
        pk = keys.split(keys.prng_key(rows + per + n, device), rows * per)
        perms = qap.random_permutation(pk, n).reshape(rows, per, n)
        for mats, b0 in (("shared", 0), ("batched", min(2, rows))):
            S, Mt = flows_pair(C, M, b0, device)
            got = qap_objective_sparse_cuda(S, Mt, perms)
            want = qap_objective_sparse_plain(S, Mt, perms)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.equal(got, want), f"qap_objective_sparse N={n} "
                    f"{rows}x{per}/{mats}: kernel != plain, max err {err}")
            launch = lambda: qap_objective_sparse_cuda(S, Mt, perms)
            ms, dev_ms = cuda_ms(launch, 200), graph_ms(launch, 200)
            plain = cuda_ms(lambda: qap_objective_sparse_plain(S, Mt, perms),
                            20)
            bound, by = bound_ms(*objective_sparse_work(S, Mt, perms))
            out[(n, rows, per, mats)] = dict(err=err, ms=ms, plain_ms=plain,
                                             bound_ms=bound, bound_by=by)
            print(f"qap_objective_sparse N={n} D={S.max_degree} {rows}x{per} "
                  f"{mats:7s}: kernel {ms:.4f} ms ({dev_ms:.5f} ms in a "
                  f"graph), plain {plain:.4f} ms, bound {bound:.6f} ms "
                  f"({by}), max err {err}", flush=True)
    g = torch.Generator().manual_seed(19)
    for level in (stack[0], stack[-1]):
        C, M = level[0], level[1]
        n = C.shape[0]
        S = sparse.from_dense(C * torch.rand(C.shape, generator=g).numpy(),
                              device=device)
        Mr = torch.as_tensor(M, device=device) * torch.rand(
            M.shape, generator=g).to(device)
        pk = keys.split(keys.prng_key(n, device), ML_CHAINS)
        perms = qap.random_permutation(pk, n).reshape(1, ML_CHAINS, n)
        got = qap_objective_sparse_cuda(S, Mr, perms)
        again = qap_objective_sparse_cuda(S, Mr, perms)
        alone = qap_objective_sparse_cuda(S, Mr, perms[:, :1].contiguous())
        want = qap_objective_sparse_plain(S, Mr, perms)
        torch.cuda.synchronize()
        err, scale = (float((got - want).abs().max()),
                      float(want.abs().max()))
        require(torch.equal(got, again) and torch.equal(alone[0, 0],
                                                        got[0, 0]),
                f"qap_objective_sparse N={n}: real-valued flows gave other "
                f"bits on another call or alone")
        require(err <= 1e-5 * scale, f"qap_objective_sparse N={n}: real-"
                f"valued max err {err} > 1e-5 * {scale}")
        print(f"qap_objective_sparse N={n} D={S.max_degree} real-valued "
              f"1x{ML_CHAINS}: the same bits on two calls and alone, max err "
              f"{err:.3e} against the plain version (max |F| {scale:.4e})",
              flush=True)
    return out


def requests():
    """A full 128-bucket wave of order-125 requests, three each of orders
    45 and 27; returns the requests and each instance's known optimum."""
    from repro_torch.core import instances
    from repro_torch.serve import MapRequest
    reqs, optima = [], {}
    for order, count in ((ORDER, WAVE), (45, 3), (27, 3)):
        for v in range(1, count + 1):
            inst = instances.make_taie(order, version=v)
            job = f"n{order}-v{v}"
            reqs.append(MapRequest(job_id=job, C=inst.C, M=inst.M,
                                   seed=1000 * order + v))
            optima[job] = inst.optimum
    return reqs, optima


def check_response(req, resp, optimum):
    import numpy as np
    n = req.C.shape[0]
    perm = np.asarray(resp.perm)
    require(perm.shape == (n,) and (np.sort(perm) == np.arange(n)).all(),
            f"{req.job_id}: infeasible permutation")
    f = float((np.asarray(req.C, np.float64)
               * np.asarray(req.M, np.float64)[np.ix_(perm, perm)]).sum())
    require(f == resp.objective, f"{req.job_id}: objective {resp.objective} "
            f"!= F(perm) {f}")
    require(optimum <= resp.objective <= resp.baseline,
            f"{req.job_id}: objective {resp.objective} outside [F0 {optimum}, "
            f"F(identity) {resp.baseline}]")


def engine_for(route, device, mesh=None):
    from repro_torch.core.annealing import SAConfig
    from repro_torch.core.genetic import GAConfig
    from repro_torch.serve import MappingEngine
    _, sa, ga = ROUTES[route]
    return MappingEngine(sa_cfg=SAConfig(**SA_KW, **sa),
                         ga_cfg=GAConfig(**GA_KW, **ga),
                         num_processes=NUM_PROCESSES, mesh=mesh,
                         device=device)


def route_requests(route):
    import dataclasses
    reqs, optima = requests()
    algorithm = ROUTES[route][0]
    return [dataclasses.replace(r, algorithm=algorithm) for r in reqs], optima


def require_smem_branch(route, counts, branches):
    """Every K1, K2, K4 and K5 launch of a dense bucket (orders up to 128)
    or a multilevel coarse solve (order 64) took the shared-memory
    branch (K4's a step or a whole exchange round a launch)."""
    for kernel in ("qap_delta", "qap_sa_step", "qap_objective",
                   "qap_ga_step"):
        smem = branches[f"{kernel}/smem"] + branches.get(
            f"{kernel}/smem_round", 0)
        require(smem == counts[kernel] and branches[f"{kernel}/l2"] == 0,
                f"[{route}] {kernel} launches {counts[kernel]}, by branch "
                f"{branches}: not all on the shared-memory branch")


def drive_engine(route):
    """After one warmup wave at the smallest bucket, submit and flush each
    bucket's wave on the card, the launch counts set to 0 just before
    each wave and read just after; returns the
    requests, the responses, the launch counts summed over the waves and
    each wave's wall by order."""
    import torch
    from repro_torch.kernels import ops
    reqs, optima = route_requests(route)
    engine = engine_for(route, "cuda")
    t = time.perf_counter()
    engine.warmup(buckets=(min(engine.buckets),),
                  algorithms=(ROUTES[route][0],))
    torch.cuda.synchronize()
    print(f"[{route}] warmup {time.perf_counter() - t:.3f} s", flush=True)
    resps, total, walls = {}, {}, {}
    for order in (ORDER, 45, 27):
        wave = [r for r in reqs if r.C.shape[0] == order]
        ops.reset_launch_counts()
        t = time.perf_counter()
        futs = [engine.submit(r) for r in wave]
        engine.flush()
        torch.cuda.synchronize()
        wall = walls[order] = time.perf_counter() - t
        counts = ops.launch_counts()
        branches = ops.branch_counts()
        for r, fut in zip(wave, futs):
            resps[r.job_id] = fut.result()
            check_response(r, resps[r.job_id], optima[r.job_id])
        require_smem_branch(route, counts, branches)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        ratio = sum(resps[r.job_id].objective / optima[r.job_id]
                    for r in wave) / len(wave)
        print(f"[{route}] bucket {resps[wave[0].job_id].bucket}: {len(wave)} "
              f"requests of order {order}, wave wall {wall:.4f} s, launches "
              f"{counts}, branches {branches}, mean F/F0 {ratio:.4f}",
              flush=True)
    return reqs, resps, total, walls


def check_against_cpu(tag, resps, cpu):
    """The card's responses against the same engine's on the CPU
    (``cpu_check``'s result for the route: ``({job_id: (perm,
    objective)}, wall)``), bit for bit."""
    import numpy as np
    got, wall = cpu
    for job, (perm, objective) in got.items():
        gpu = resps[job]
        require((np.asarray(perm) == gpu.perm).all()
                and objective == gpu.objective,
                f"[{tag}] {job}: card F={gpu.objective} != cpu F={objective}")
    print(f"[{tag}] card == cpu on {sorted(got)} ({wall:.1f} s on the cpu, "
          f"in a pool process beside the card's routes)", flush=True)


def solve_all(engine, reqs):
    """Submit ``reqs``, flush, and return ``{job_id: (perm, objective)}``."""
    futs = [engine.submit(r) for r in reqs]
    engine.flush()
    return {r.job_id: (f.result().perm.tolist(), f.result().objective)
            for r, f in zip(reqs, futs)}


CPU_CHECKS = tuple(ROUTES) + ("multilevel", "exact-size", "rm-replay",
                              "rm-placement")


def cpu_check(src, name):
    """The CPU side of one route's card == CPU check, run in a pool
    process beside the card's routes (``CPU_CHECKS``): a dense route's
    engine on one request per bucket, the multilevel engine on the 1024
    and 4096 tori, the exact-size route's psa request, the rm-replay
    route's first RM_CPU_JOBS jobs and its placement of the first job's
    candidates.  Returns ``(result, wall)``; never touches the card."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    torch.set_num_threads(CPU_CHECK_THREADS)
    from repro_torch.serve import MappingEngine
    t = time.perf_counter()
    if name in ROUTES:
        reqs, _ = route_requests(name)
        out = solve_all(engine_for(name, "cpu"),
                        [reqs[0], reqs[WAVE], reqs[WAVE + 3]])
    elif name == "multilevel":
        out = solve_all(ml_engine("cpu"), [r for r, _ in ml_requests()][1:])
    elif name == "exact-size":
        out = solve_all(engine_for("psa-event", "cpu"),
                        [exact_request("psa")[0]])
    elif name == "rm-replay":
        rm, *_ = rm_replay(MappingEngine(warm_start=False, device="cpu"),
                           RM_CPU_JOBS)
        out = rm_decisions(rm)
    else:
        out = rm_placements("cpu")
    return out, time.perf_counter() - t


def start_cpu_checks():
    """A spawned pool running every ``cpu_check`` from the script's start;
    returns the pool and the futures by check."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(CPU_CHECK_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    src = os.path.join(ROOT, "src")
    return pool, {name: pool.submit(cpu_check, src, name)
                  for name in CPU_CHECKS}


def ml_requests():
    from repro_torch.serve import MapRequest
    out = []
    for i, dims in enumerate(ML_TORI):
        inst = torus(dims)
        out.append((MapRequest(job_id=f"torus{inst.C.shape[0]}", C=inst.C,
                               M=inst.M, seed=50 + i), inst.optimum))
    return out


def ml_engine(device):
    from repro_torch.core.multilevel import MultilevelConfig
    from repro_torch.serve import MappingEngine
    return MappingEngine(multilevel_min_n=256,
                         multilevel_cfg=MultilevelConfig(), device=device)


def drive_multilevel():
    """Serve the three tori on the card through the large buckets, one
    request at a time: the launch counts set to 0 just before each and
    read just after.  The level trace of each solve is read from
    ``solve_multilevel``'s result as the engine calls it."""
    import torch
    from repro_torch.core import multilevel
    from repro_torch.kernels import ops
    results = []
    solve = multilevel.solve_multilevel

    def traced(*args, **kw):
        res = solve(*args, **kw)
        results.append(res)
        return res

    multilevel.solve_multilevel = traced
    engine = ml_engine("cuda")
    resps, total = {}, {}
    try:
        for req, optimum in ml_requests():
            ops.reset_launch_counts()
            t = time.perf_counter()
            fut = engine.submit(req)
            engine.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = ops.launch_counts()
            branches = ops.branch_counts()
            resp = resps[req.job_id] = fut.result()
            check_response(req, resp, optimum)
            require_smem_branch("multilevel", counts, branches)
            for kernel in ("qap_delta", "qap_objective_sparse",
                           "qap_delta_sparse"):
                require(counts[kernel] > 0,
                        f"[multilevel] {req.job_id} launched no {kernel}")
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            res = results[-1]
            levels = [dict(n=lv.n, nnz=lv.nnz, f_prolonged=lv.f_prolonged,
                           f_refined=lv.f_refined) for lv in res.levels]
            print(f"[multilevel] bucket {resp.bucket}: order "
                  f"{req.C.shape[0]}, wall {wall:.4f} s (solve "
                  f"{res.seconds:.4f} s), launches {counts}, F/F0 "
                  f"{resp.objective / optimum:.4f}, coarse F "
                  f"{res.coarse_objective}, levels {levels}", flush=True)
    finally:
        multilevel.solve_multilevel = solve
    return resps, total


def exact_request(algorithm):
    """The exact-size route's request: a 200-process job whose flows are a
    2-D stencil on a 10 x 20 torus allocation (``exact.make_torus``: F0 =
    sum(C) known), and its optimum."""
    from repro_torch.serve import MapRequest
    inst = torus(EXACT_TORUS)
    return MapRequest(job_id=f"torus{EXACT_ORDER}-{algorithm}", C=inst.C,
                      M=inst.M, seed=60, algorithm=algorithm), inst.optimum


def drive_exact_size(cpu):
    """The service's exact-size route (orders 129-255 have no dense bucket
    and lie below the multilevel route, so ``MappingEngine`` solves them
    one at a time at their own size): the order-200 request through the
    engine on the card for psa (the psa-event route's engine: K1) and pga
    (pga-wide's: K2, K1 in the polish), the launch counts set to 0 just
    before each and read just after; every K1 and K2 launch on the L2
    branch; each response checked; psa card == CPU at the engine's
    default tier (``cpu``: ``cpu_check``'s result for "exact-size").
    Returns the launch counts summed over both."""
    import torch
    from repro_torch.kernels import ops
    t_route = time.perf_counter()
    total, resps = {}, {}
    for algorithm in EXACT_ALGOS:
        route = {"psa": "psa-event", "pga": "pga-wide"}[algorithm]
        req, optimum = exact_request(algorithm)
        engine = engine_for(route, "cuda")
        ops.reset_launch_counts()
        t = time.perf_counter()
        fut = engine.submit(req)
        engine.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts, branches = ops.launch_counts(), ops.branch_counts()
        resp = resps[algorithm] = fut.result()
        check_response(req, resp, optimum)
        require(resp.bucket is None, f"[exact-size] {req.job_id}: bucket "
                f"{resp.bucket}, not solved at its own size")
        for kernel in ("qap_delta", "qap_objective"):
            require(branches[f"{kernel}/l2"] == counts[kernel],
                    f"[exact-size] {req.job_id}: {kernel} launches "
                    f"{counts[kernel]}, by branch {branches}: not all on "
                    f"the L2 branch")
        for kernel in ("qap_delta",) + (("qap_objective",)
                                        if algorithm == "pga" else ()):
            require(counts[kernel] > 0,
                    f"[exact-size] {req.job_id} launched no {kernel}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        print(f"[exact-size] {algorithm} ({route}): order {EXACT_ORDER}, "
              f"wall {wall:.4f} s, launches {counts}, branches {branches}, "
              f"F {resp.objective:.0f}, F/F0 {resp.objective / optimum:.4f}, "
              f"F(identity) {resp.baseline:.0f}", flush=True)
    check_against_cpu("exact-size", {r.job_id: r for r in resps.values()},
                      cpu)
    print(f"[exact-size] route wall {time.perf_counter() - t_route:.1f} s",
          flush=True)
    return total


def device_memory_used_mib():
    """The card's used memory by ``nvidia-smi`` (MiB): readable before
    this process has a CUDA context, unlike ``torch.cuda.mem_get_info``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0])


def context_bytes():
    """Device memory one CUDA context takes: the card's used memory
    before and after this process creates its own (one 4-byte tensor)."""
    import torch
    before = device_memory_used_mib()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    ctx = (device_memory_used_mib() - before) * 2 ** 20
    require(ctx > 0, f"[rm-replay] a CUDA context measured {ctx} bytes")
    return ctx


def rm_trace(num_jobs):
    from repro_torch.serve import synthetic_trace
    return synthetic_trace(num_jobs, **RM_TRACE)


def rm_replay(engine, num_jobs):
    """Replay the trace through ``ResourceManager`` over ``engine``, the
    launch counts set to 0 just before ``run`` and read just after;
    returns the manager, its report, the run's wall and the counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ResourceManager
    rm = ResourceManager(torus(RM_TORUS).M, engine,
                         map_timeout_s=RM_TIMEOUT_S)
    for spec in rm_trace(num_jobs):
        rm.submit_job(spec)
    ops.reset_launch_counts()
    t = time.perf_counter()
    rep = rm.run()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return rm, rep, wall, (ops.launch_counts(), ops.branch_counts())


def rm_decisions(rm):
    """Each job's decisions: start and finish, candidate policy, backfill,
    nodes, permutation and objective."""
    return {h.job_id: (h.start_s, h.finish_s, h.candidate_policy,
                       h.backfilled, h.allocation.nodes.tolist(),
                       h.response.perm.tolist(), h.response.objective)
            for h in rm.handles}


def check_rm_replay(label, rm, rep, wall, counts, num_jobs):
    """Every job finished with a permutation of its size whose objective
    is F(perm) recomputed in numpy and no worse than the identity; jobs
    whose run intervals overlap hold disjoint nodes.  Prints the
    replay's metrics."""
    import numpy as np
    require(rep.jobs == num_jobs and all(h.done() for h in rm.handles),
            f"[rm-replay] {label}: {rep.jobs} of {num_jobs} jobs finished")
    for h in rm.handles:
        n, perm = h.spec.size, np.asarray(h.response.perm)
        require(perm.shape == (n,) and (np.sort(perm) == np.arange(n)).all(),
                f"[rm-replay] {label} {h.job_id}: infeasible permutation")
        M_sub = np.asarray(h.allocation.M_sub, np.float64)
        f = float((np.asarray(h.C, np.float64)
                   * M_sub[np.ix_(perm, perm)]).sum())
        require(f == h.response.objective <= h.response.baseline,
                f"[rm-replay] {label} {h.job_id}: objective "
                f"{h.response.objective}, F(perm) {f}, baseline "
                f"{h.response.baseline}")
    for i, a in enumerate(rm.handles):
        for b in rm.handles[i + 1:]:
            if a.start_s < b.finish_s and b.start_s < a.finish_s:
                require(not set(a.allocation.nodes.tolist())
                        & set(b.allocation.nodes.tolist()),
                        f"[rm-replay] {label}: {a.job_id} and {b.job_id} "
                        f"overlap in time and share nodes")
    print(f"[rm-replay] {label}: {rep.jobs} jobs, makespan "
          f"{rep.makespan_s:.4f} s (virtual), utilization "
          f"{rep.utilization:.4f}, wait mean / p50 / p99 "
          f"{rep.mean_wait_s:.4f} / {rep.wait_p50_s:.4f} / "
          f"{rep.wait_p99_s:.4f} s, backfilled {rep.backfilled}, mean "
          f"objective {rep.mean_objective:.4f}, mean improvement "
          f"{rep.mean_improvement:.4f}, candidate waves "
          f"{rep.candidate_waves}, max batches per wave "
          f"{rep.max_batches_per_wave}", flush=True)
    print(f"[rm-replay] {label}: map wall per wave p50 "
          f"{rep.map_wall_p50_ms:.4f} ms, p99 {rep.map_wall_p99_ms:.4f} ms "
          f"(host clock; each wave ends in a copy to the host); replay wall "
          f"{wall:.4f} s; launches {counts[0]}, branches {counts[1]}",
          flush=True)


class MemoryProbe:
    """A fleet as the manager calls it, reading the card's free memory
    just before the third wave is submitted: both workers alive, each
    past its first wave (worker 0 dies in its second, the third overall)."""

    def __init__(self, fleet):
        self.fleet, self.free, self.apps = fleet, None, None

    def __getattr__(self, name):
        return getattr(self.fleet, name)

    def submit(self, req):
        import torch
        f = self.fleet
        if (self.free is None and f.stats.dispatched_waves >= 2
                and all(w.alive and w.completed > 0 for w in f.workers)):
            self.free = torch.cuda.mem_get_info()[0]
            self.apps = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip()
        return f.submit(req)


def fleet_line(label, stats):
    print(f"[rm-replay] {label} fleet: deaths {stats.worker_deaths}, "
          f"respawns {stats.respawns}, requeued {stats.requeued}, failed "
          f"{stats.failed}, first_recovery_s {stats.first_recovery_s}, "
          f"dispatched waves {stats.dispatched_waves}, solver batches "
          f"{stats.solver_batches}", flush=True)


def rm_placements(device):
    """``PlacementService.solve_batch`` on ``device`` of the trace's first
    job's candidates: ``[(perm, F(identity), F)]``."""
    import torch
    from repro_torch.launch.placement import PlacementService
    from repro_torch.serve import ClusterState, default_flows
    spec = rm_trace(1)[0]
    cands = ClusterState(torus(RM_TORUS).M).candidate_subsets(spec.size)
    insts = [(default_flows(spec.size, spec.seed), c.M_sub) for c in cands]
    svc = PlacementService(device=device)
    t = time.perf_counter()
    placed = [(r.perm.tolist(), r.cost_before, r.cost_after)
              for r in svc.solve_batch(insts)]
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"[rm-replay] placement of {spec.job_id}'s {len(insts)} "
          f"candidates (order {spec.size}) on {device}: "
          f"{time.perf_counter() - t:.3f} s, F {[p[2] for p in placed]} of "
          f"identity {[p[1] for p in placed]}", flush=True)
    svc.close()
    return placed


def drive_rm_replay(ctx_bytes, cpu_decisions, cpu_placed):
    """The resource manager on the card: (1) the RM_JOBS trace through one
    engine; (2) through a subprocess fleet of two workers on the card,
    worker 0 SIGKILLing itself after 4 requests: per job equal to (1),
    one death, no failure, free device memory down by at least one CUDA
    context per child while both live; (3) its first RM_CPU_JOBS through one
    engine on the card, a thread fleet under a kill on the card and one
    engine on the CPU (``cpu_decisions``: ``cpu_check``'s "rm-replay"):
    all three equal; (4) ``PlacementService`` on the first job's three
    candidates, card == CPU (``cpu_placed``: its "rm-placement").
    Returns replay 1's launch counts."""
    import torch
    from repro_torch.serve import EngineFleet, FaultPlan, MappingEngine
    t_route = time.perf_counter()
    print(f"[rm-replay] {RM_JOBS}-job synthetic_trace({RM_TRACE}) on the "
          f"{'x'.join(map(str, RM_TORUS))} torus, ResourceManager defaults, "
          f"MappingEngine(warm_start=False) at the default budgets",
          flush=True)

    engine = MappingEngine(warm_start=False)
    t = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    print(f"[rm-replay] single engine warmup {time.perf_counter() - t:.3f} "
          f"s", flush=True)
    rm1, rep1, wall, counts = rm_replay(engine, RM_JOBS)
    check_rm_replay("single engine", rm1, rep1, wall, counts, RM_JOBS)
    require(rep1.max_batches_per_wave == 1,
            f"[rm-replay] {rep1.max_batches_per_wave} batches in a wave")
    require(counts[0]["qap_delta"] > 0, "[rm-replay] launched no qap_delta")
    require_smem_branch("rm-replay", *counts)
    first = rm_decisions(rm1)

    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    fleet = EngineFleet(workers=2, transport="subprocess",
                        fault_plan=FaultPlan(sigkill_worker_at={0: 4}),
                        warm_start=False).start()
    probe = MemoryProbe(fleet)
    try:
        rm2, rep2, wall, counts2 = rm_replay(probe, RM_JOBS)
    finally:
        fleet.stop()
    free_after = torch.cuda.mem_get_info()[0]
    check_rm_replay("subprocess fleet, SIGKILL", rm2, rep2, wall, counts2,
                    RM_JOBS)
    print("[rm-replay] (the subprocess fleet's launches are counted in its "
          "children, not here)", flush=True)
    fleet_line("subprocess", fleet.stats)
    require(probe.free is not None, "[rm-replay] memory probe never ran")
    drop = free0 - probe.free
    print(f"[rm-replay] free device memory {free0 / 2 ** 30:.3f} GiB before "
          f"the fleet, {probe.free / 2 ** 30:.3f} GiB with both children "
          f"alive (down {drop / 2 ** 20:.1f} MiB; one CUDA context "
          f"{ctx_bytes / 2 ** 20:.1f} MiB), {free_after / 2 ** 30:.3f} GiB "
          f"after stop; nvidia-smi compute apps: {probe.apps!r}", flush=True)
    require(drop >= 2 * ctx_bytes, f"[rm-replay] free memory down "
            f"{drop} bytes with two children alive, less than two CUDA "
            f"contexts ({ctx_bytes} bytes each): the children are not on "
            f"the card")
    st = fleet.stats
    require(st.worker_deaths == 1 and st.failed == 0
            and st.respawns <= RM_MAX_RESPAWNS,
            f"[rm-replay] subprocess fleet: deaths {st.worker_deaths}, "
            f"failed {st.failed}, respawns {st.respawns}")
    require(rm_decisions(rm2) == first,
            "[rm-replay] subprocess fleet decisions != single engine's")
    skip = ("map_wall_p50_ms", "map_wall_p99_ms", "max_batches_per_wave")
    require({k: v for k, v in rep2.asdict().items() if k not in skip}
            == {k: v for k, v in rep1.asdict().items() if k not in skip},
            "[rm-replay] subprocess fleet report != single engine's")

    short = {}
    rm3, rep3, wall, counts3 = rm_replay(MappingEngine(warm_start=False),
                                         RM_CPU_JOBS)
    check_rm_replay(f"{RM_CPU_JOBS} jobs, single engine", rm3, rep3, wall,
                    counts3, RM_CPU_JOBS)
    short["card"] = rm_decisions(rm3)
    fleet = EngineFleet(workers=2, fault_plan=FaultPlan(kill_worker_at={1: 2}),
                        warm_start=False)
    try:
        rm4, rep4, wall, counts4 = rm_replay(fleet, RM_CPU_JOBS)
    finally:
        fleet.stop()
    check_rm_replay(f"{RM_CPU_JOBS} jobs, thread fleet, kill", rm4, rep4,
                    wall, counts4, RM_CPU_JOBS)
    fleet_line("thread", fleet.stats)
    require(fleet.stats.worker_deaths == 1 and fleet.stats.failed == 0,
            "[rm-replay] thread fleet: deaths or failures off the plan")
    require(counts4[0]["qap_delta"] > 0,
            "[rm-replay] thread fleet launched no qap_delta")
    short["thread fleet"] = rm_decisions(rm4)
    short["cpu"], wall = cpu_decisions
    print(f"[rm-replay] {RM_CPU_JOBS} jobs on the cpu: {wall:.1f} s (in a "
          f"pool process beside the card's routes)", flush=True)
    require(short["card"] == short["thread fleet"] == short["cpu"],
            f"[rm-replay] {RM_CPU_JOBS}-job trace: card, thread fleet and "
            "cpu disagree")
    print(f"[rm-replay] {RM_CPU_JOBS}-job trace: card == thread fleet == cpu",
          flush=True)
    placed = {"cuda": rm_placements("cuda")}
    placed["cpu"], wall = cpu_placed
    print(f"[rm-replay] placement on the cpu: {wall:.3f} s (in a pool "
          f"process)", flush=True)
    require(placed["cuda"] == placed["cpu"],
            "[rm-replay] placement: card != cpu")
    print(f"[rm-replay] route wall {time.perf_counter() - t_route:.1f} s",
          flush=True)
    return counts[0]


def scan_inputs(shape, device, seed):
    """u, dt, a, b, c for K8 in the ranges of the reference's kernel test
    (dt in [0.001, 0.1], a in [-1, -0.1]), drawn on the card."""
    import torch
    bsz, s, d, n = shape
    g = torch.Generator(device=device).manual_seed(seed)
    rand = functools.partial(torch.rand, generator=g, device=device)
    randn = functools.partial(torch.randn, generator=g, device=device)
    return (randn(bsz, s, d), rand(bsz, s, d) * 0.099 + 0.001,
            -(rand(d, n) * 0.9 + 0.1), randn(bsz, s, n), randn(bsz, s, n))


def sfu_floor_ms(count):
    """Least milliseconds for ``count`` special-function operations (one
    ``ex2`` in each accurate ``expf``) at 16 a clock per SM, at the card's
    SM count and its largest SM clock (``nvidia-smi clocks.max.sm``)."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return count / (16 * sms * mhz * 1e6) * 1e3, sms, mhz


def check_selective_scan(device):
    """K8 against its plain version at the Jamba prefill's full-width
    shape and at a ragged one: ``y`` and ``h_last`` within 2e-4 of their
    largest magnitude (the reference's kernel-test bar); whether they are
    bitwise equal is printed, and beside the byte bound the floor of its
    ``expf`` count on the special-function units."""
    import torch
    from repro_torch.kernels.selective_scan import (selective_scan_cuda,
                                                    selective_scan_plain)
    out = {}
    for label, shape in (("full", (LM_BATCH, LM_PROMPT, 8192, 16)),
                         ("ragged", (2, 49, 200, 4))):
        args = scan_inputs(shape, device, sum(shape))
        y, h = selective_scan_cuda(*args)
        want_y, want_h = selective_scan_plain(*args)
        torch.cuda.synchronize()
        err = float((y - want_y).abs().max())
        err_h = float((h - want_h).abs().max())
        for name, e, w in (("y", err, want_y), ("h_last", err_h, want_h)):
            require(e <= 2e-4 * float(w.abs().max()), f"selective_scan "
                    f"{label}: {name} max err {e} > 2e-4 * max")
        launch = lambda: selective_scan_cuda(*args)
        ms, dev_ms = cuda_ms(launch, 50), graph_ms(launch, 50)
        plain = cuda_ms(lambda: selective_scan_plain(*args), 2)
        bsz, s, d, n = shape
        nbytes = 4 * (3 * bsz * s * d + d * n + 2 * bsz * s * n + bsz * d * n)
        bound, by = bound_ms(nbytes, 7 * bsz * s * d * n + bsz * s * d)
        sfu, sms, mhz = sfu_floor_ms(bsz * s * d * n)
        out[label] = dict(err=err, err_h=err_h, ms=ms, graph_ms=dev_ms,
                          plain_ms=plain, bound_ms=bound, bound_by=by)
        print(f"selective_scan {label:6s} B={bsz} S={s} D={d} N={n}: kernel "
              f"{ms:.4f} ms ({dev_ms:.4f} ms in a graph), plain {plain:.4f} "
              f"ms, bound {bound:.4f} ms ({by}); expf floor {sfu:.4f} ms ("
              f"{bsz * s * d * n} special-function ops at 16 a clock on "
              f"{sms} SMs at {mhz:.0f} MHz), max err y {err} h_last "
              f"{err_h}, bitwise y {torch.equal(y, want_y)} h_last "
              f"{torch.equal(h, want_h)}", flush=True)
    return out


class TimedModel:
    """The port's ``Model`` with every prefill and decode step timed on
    the host clock around a ``torch.cuda.synchronize()``, and the logits
    they return kept."""

    def __init__(self, model):
        self.model, self.device = model, model.device
        self.times = {"prefill": [], "decode": []}
        self.logits = []

    def _timed(self, name, fn, *args, **kw):
        import torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = fn(*args, **kw)
        torch.cuda.synchronize()
        self.times[name].append(time.perf_counter() - t)
        self.logits.append(logits)
        return logits, cache

    def prefill(self, *args, **kw):
        return self._timed("prefill", self.model.prefill, *args, **kw)

    def decode_step(self, *args, **kw):
        return self._timed("decode", self.model.decode_step, *args, **kw)


def lm_config():
    """Jamba-v0.1-52B at full width, cut to one super-block of 8 layers,
    served with bf16 weights and dropless MoE."""
    from repro_torch import configs
    return configs.get_config("jamba_v0_1_52b").with_overrides(
        num_layers=8, layer_pattern="mMmMaMmM", param_dtype="bf16",
        moe_capacity_factor=0.0)


def drive_lm_serve():
    """Serve 4 prompts of 512 tokens, 16 greedy tokens each, through the
    port's ``Engine`` on the card, the launch counts set to 0 just before
    ``generate`` and read just after; then decode against teacher
    forcing at full width.  Returns the launch counts of ``generate``."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    from repro_torch.serve import Engine, ServeConfig
    cfg = lm_config()
    mamba_layers = sum(ch in "mM" for ch in cfg.layer_pattern)
    model = Model(cfg, device="cuda")
    t = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[lm-serve] {cfg.name} cut to {cfg.num_layers} layers "
          f"({cfg.layer_pattern}), {model.num_params()} parameters in "
          f"{cfg.param_dtype}, drawn on the card in "
          f"{time.perf_counter() - t:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    timed = TimedModel(model)
    engine = Engine(timed, params, ServeConfig(max_new_tokens=LM_NEW))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    out = engine.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    require(out.shape == (LM_BATCH, LM_NEW), f"[lm-serve] output {out.shape}")
    require(((out >= 0) & (out < cfg.vocab_size)).all(),
            "[lm-serve] a token outside the vocabulary")
    require(all(bool(torch.isfinite(x).all()) for x in timed.logits),
            "[lm-serve] non-finite logits")
    require(counts["selective_scan"] == mamba_layers,
            f"[lm-serve] {counts['selective_scan']} selective_scan launches "
            f"for one prefill of {mamba_layers} Mamba layers")
    prefill_s = timed.times["prefill"][0]
    decode_s = sum(timed.times["decode"]) / len(timed.times["decode"])
    print(f"[lm-serve] {LM_BATCH} x {LM_PROMPT} prompts, {LM_NEW} greedy "
          f"tokens: generate wall {wall:.4f} s, prefill {prefill_s:.4f} s, "
          f"decode {decode_s * 1e3:.3f} ms per step "
          f"({len(timed.times['decode'])} steps), "
          f"{out.size / wall:.2f} generated tokens/s, peak "
          f"{peak / 2 ** 30:.2f} GiB, launches {counts}", flush=True)
    print(f"[lm-serve] tokens {out[:, :8].tolist()}", flush=True)
    # dropless MoE runs all experts: a decode step reads every weight
    step_bytes, bound = decode_bound_ms(params)
    print(f"[lm-serve] a decode step reads {step_bytes / 1e9:.3f} GB of "
          f"weights: bound {bound:.3f} ms (bytes), measured "
          f"{decode_s * 1e3:.3f} ms", flush=True)

    # decode against teacher forcing at full width: the gate in f32
    # compute on the same bf16 weights, then the served bf16 arithmetic
    gate = teacher_forcing(
        Model(cfg.with_overrides(compute_dtype=torch.float32), device="cuda"),
        params, LM_BATCH, "f32 compute")
    require(gate["agree"] >= 0.95,
            f"[lm-serve] f32 argmax agreement {gate['agree']} < 0.95")
    require(gate["diff"] <= 1e-3 * gate["scale"],
            f"[lm-serve] f32 teacher forcing: max diff {gate['diff']} > "
            f"1e-3 * {gate['scale']}")
    # The served bf16 arithmetic, measured: its logits come out of a bf16
    # product (the reference's logits_fn), so a row's top two often tie
    # within one bf16 step, and decode and prefill round differently
    # (other GEMM shapes); its argmax agreement is printed, not gated.
    teacher_forcing(model, params, LM_TF_ROWS, "bf16 compute")
    del params
    torch.cuda.empty_cache()
    return counts


def teacher_forcing(model, params, rows, label, inputs=None,
                    tag="lm-serve"):
    """Logits of [prefill(S) -> decode position S] against the last
    logits of prefill(S + 1) for ``rows`` sequences of ``LM_PROMPT``
    positions: ``inputs``, a dict of (rows, LM_PROMPT + 1, ...) tensors on
    the card (default: token ids from ``default_rng(1)``; K8 once per
    Mamba layer and prefill, counted without resetting the launch
    counts).  Returns :func:`compare_logits`'s dict."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    cfg = model.cfg
    if inputs is None:
        inputs = {"tokens": torch.as_tensor(
            np.random.default_rng(1).integers(2, cfg.vocab_size,
                                              (rows, LM_PROMPT + 1)),
            dtype=torch.int32, device="cuda")}
    before = ops.launch_counts()
    _, cache = model.prefill(params,
                             {k: v[:, :LM_PROMPT] for k, v in inputs.items()},
                             cache_len=LM_PROMPT + 8)
    a, _ = model.decode_step(params, cache,
                             {k: v[:, LM_PROMPT:] for k, v in inputs.items()},
                             LM_PROMPT)
    del cache
    b, _ = model.prefill(params, inputs)
    torch.cuda.synchronize()
    launched = launches_since(before)["selective_scan"]
    mamba_layers = sum(ch in "mM" for ch in cfg.layer_pattern)
    require(launched == 2 * mamba_layers, f"[{tag}] {launched} "
            f"selective_scan launches for two prefills")
    return compare_logits(a, b, f"decode vs teacher forcing at full width, "
                          f"{label}", tag)


def compare_logits(a, b, what, tag):
    """Decode's logits ``a`` against prefill's ``b`` (rows x vocab): the
    agreement of the argmaxes, the max abs difference and the largest
    logit; prints each row's max difference and top-2 gap, and for each
    row whose argmaxes differ the gap between the two tokens' prefill
    logits."""
    import torch
    require(bool(torch.isfinite(a).all() & torch.isfinite(b).all()),
            f"[{tag}] non-finite logits ({what})")
    rows = b.shape[0]
    ia, ib = a.argmax(-1), b.argmax(-1)
    top2 = b.topk(2, dim=-1).values
    rows_idx = torch.arange(rows, device=b.device)
    out = dict(agree=float((ia == ib).float().mean()),
               diff=float((a - b).abs().max()), scale=float(b.abs().max()))
    row_diff = (a - b).abs().amax(-1).tolist()
    top2_gap = (top2[:, 0] - top2[:, 1]).tolist()
    ties = (b[rows_idx, ib] - b[rows_idx, ia])[ia != ib].tolist()
    print(f"[{tag}] {what}, {rows} rows: max abs diff {out['diff']:.6f} "
          f"(logits max {out['scale']:.4f}), argmax agreement "
          f"{out['agree']}; per row max diff "
          f"{[round(x, 4) for x in row_diff]}, top-2 gap "
          f"{[round(x, 4) for x in top2_gap]}, prefill-logit gap of each "
          f"disagreement {ties}", flush=True)
    return out


def check_lm_against_cpu(arch="jamba_v0_1_52b", tag="lm-serve"):
    """``arch``'s SMOKE width in f32, weights drawn once on the CPU from
    one seed: the card's greedy tokens (``Engine.generate`` on token
    prompts) equal the CPU's, and its prefill logits (from ``embeds``
    for a model with a frontend) agree to 1e-4 of their largest
    magnitude; the card's prefill launches K8 once per Mamba layer
    (counted without resetting the launch counts)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    from repro_torch.models.transformer import FRONTEND_DIMS
    from repro_torch.serve import Engine, ServeConfig
    cfg = configs.smoke_config(arch).with_overrides(
        compute_dtype=torch.float32)
    prompts = np.random.default_rng(2).integers(
        2, cfg.vocab_size, (4, 49)).astype(np.int32)
    batch = {"tokens": prompts}
    if cfg.frontend is not None:
        batch = {"embeds": np.random.default_rng(3).standard_normal(
            (4, 49, FRONTEND_DIMS[cfg.frontend])).astype(np.float32)}
    mamba_layers = sum(ch in "mM" for ch in cfg.layer_pattern)
    out, logits = {}, {}
    t = time.perf_counter()
    for device in ("cuda", "cpu"):
        model = Model(cfg, device=device)
        params = model.init(torch.Generator().manual_seed(0))
        before = ops.launch_counts()
        logits[device], _ = model.prefill(
            params, {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()})
        launched = launches_since(before)["selective_scan"]
        require(launched == (mamba_layers if device == "cuda" else 0),
                f"[{tag}] {arch} smoke prefill on {device}: {launched} "
                f"launches")
        out[device] = Engine(model, params,
                             ServeConfig(max_new_tokens=8)).generate(prompts)
    err = float((logits["cuda"].cpu() - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    require((out["cuda"] == out["cpu"]).all(),
            f"[{tag}] {arch} smoke tokens: card {out['cuda'].tolist()} != "
            f"cpu {out['cpu'].tolist()}")
    require(err <= 1e-4 * scale, f"[{tag}] {arch} smoke prefill logits: max "
            f"err {err} > 1e-4 * {scale}")
    print(f"[{tag}] {arch} smoke width f32 (prefill from {sorted(batch)}): "
          f"card == cpu tokens {out['cuda'][0]}, prefill logits max err "
          f"{err} (max {scale:.4f}) ({time.perf_counter() - t:.1f} s)",
          flush=True)


def family_config(arch):
    """The lm-families route's configuration of ``arch``: its published
    width in bf16 weights; InternVL2-76B cut to FAMILY_VISION_LAYERS of
    its 80 layers."""
    from repro_torch import configs
    cfg = configs.get_config(arch).with_overrides(param_dtype="bf16")
    if arch == "internvl2_76b":
        cfg = cfg.with_overrides(num_layers=FAMILY_VISION_LAYERS,
                                 layer_pattern="T" * FAMILY_VISION_LAYERS)
    return cfg


def family_model(arch, tag):
    """(cfg, model, params) of ``arch`` on the card, weights drawn there
    from a seeded generator; checks the parameter count."""
    import torch
    from repro_torch.models.api import Model
    cfg = family_config(arch)
    model = Model(cfg, device="cuda")
    t = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = model.num_params()
    require(n == FAMILY_PARAMS[arch], f"[{tag}] {n} parameters, expected "
            f"{FAMILY_PARAMS[arch]}")
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers "
          f"({cfg.layer_pattern[:8]}...), d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, frontend {cfg.frontend}: "
          f"{n} parameters in {cfg.param_dtype}, drawn on the card in "
          f"{time.perf_counter() - t:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    return cfg, model, params


def decode_bound_ms(params):
    """The least time of a decode step at the card's memory rate: every
    weight but the embedding table read once."""
    from repro_torch.models.param import tree_leaves
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                 if t is not params["embed"]["embedding"])
    return nbytes, nbytes / H100_BYTES_PER_S * 1e3


def host_launch_us(reps=2000):
    """Host microseconds per launch of a small elementwise kernel, on the
    host clock: the rate at which this host issues the small kernels a
    decode step is made of."""
    import torch
    x = torch.zeros(1024, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e6


def family_inputs(cfg, length, seed):
    """LM_BATCH sequences of ``length`` inputs on the card: token ids
    (``tokens``) for a model without a frontend, else standard normal
    frontend inputs (``embeds``: EnCodec frames or InternViT patches of
    fd), drawn with numpy."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import FRONTEND_DIMS
    rng = np.random.default_rng(seed)
    if cfg.frontend is None:
        return {"tokens": torch.as_tensor(
            rng.integers(2, cfg.vocab_size, (LM_BATCH, length)),
            dtype=torch.int32, device="cuda")}
    x = rng.standard_normal((LM_BATCH, length, FRONTEND_DIMS[cfg.frontend]))
    return {"embeds": torch.as_tensor(x, dtype=torch.float32, device="cuda")}


def serve_tokens(model, params, inputs):
    """LM_NEW greedy tokens after LM_PROMPT-token prompts through
    ``Engine.generate``."""
    import torch
    from repro_torch.serve import Engine, ServeConfig
    engine = Engine(model, params, ServeConfig(max_new_tokens=LM_NEW))
    prompts = inputs["tokens"][:, :LM_PROMPT].cpu().numpy()
    return torch.as_tensor(engine.generate(prompts))


def serve_embeds(model, params, inputs):
    """Prefill LM_PROMPT frontend inputs, then LM_NEW decode steps each fed
    the next one; the greedy tokens of their logits."""
    import torch
    emb = inputs["embeds"]
    logits, cache = model.prefill(params, {"embeds": emb[:, :LM_PROMPT]},
                                  cache_len=LM_PROMPT + LM_NEW)
    tokens = []
    for pos in range(LM_PROMPT, LM_PROMPT + LM_NEW):
        logits, cache = model.decode_step(
            params, cache, {"embeds": emb[:, pos:pos + 1]}, pos)
        tokens.append(logits.argmax(-1))
    return torch.stack(tokens, 1)


def rwkv_teacher_forcing(model, params, label, tag):
    """Prefill FAMILY_TF_PREFIX tokens of LM_BATCH prompts, decode tokens
    FAMILY_TF_PREFIX ... LM_PROMPT - 1 one at a time (the state carried
    LM_PROMPT - FAMILY_TF_PREFIX times), and hold the last step's logits
    against prefill(LM_PROMPT)'s.  (LM_PROMPT + 1 tokens is no legal RWKV
    prefill: not a whole number of 64-token chunks.)"""
    import torch
    toks = family_inputs(model.cfg, LM_PROMPT, 1)["tokens"]
    t = time.perf_counter()
    _, cache = model.prefill(params, {"tokens": toks[:, :FAMILY_TF_PREFIX]})
    for pos in range(FAMILY_TF_PREFIX, LM_PROMPT):
        a, cache = model.decode_step(params, cache,
                                     {"tokens": toks[:, pos:pos + 1]}, pos)
    del cache
    b, _ = model.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    return compare_logits(
        a, b, f"{FAMILY_TF_PREFIX} + {LM_PROMPT - FAMILY_TF_PREFIX} decode "
        f"steps vs prefill({LM_PROMPT}), {label} "
        f"({time.perf_counter() - t:.1f} s)", tag)


def frontend_teacher_forcing(model, params, label, tag):
    """``lm-serve``'s teacher forcing on LM_BATCH sequences of
    LM_PROMPT + 1 frontend inputs."""
    return teacher_forcing(model, params, LM_BATCH, label,
                           family_inputs(model.cfg, LM_PROMPT + 1, 1), tag)


def drive_family(arch, tf=None, min_agree=None):
    """``arch`` served on the card: LM_BATCH x LM_PROMPT inputs (token
    prompts through ``Engine.generate``, or ``embeds`` prefilled and
    decoded LM_NEW steps), every token in the vocabulary and every logit
    finite, no kernel launched while it serves (counted without
    resetting the launch counts); a FAMILY_PROFILE_PREFILL-position
    prefill and a decode step profiled; with ``tf`` (``(model, params,
    label, tag)`` -> :func:`compare_logits`'s dict), decode against
    teacher forcing in f32 compute on the same bf16 weights (argmax
    agreement >= ``min_agree``, logits within 1e-3 of their largest
    magnitude) and in the served bf16 (printed)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    tag = f"lm-families {arch.split('_')[0]}"
    cfg, model, params = family_model(arch, tag)
    inputs = family_inputs(cfg, LM_PROMPT + LM_NEW, 0)
    (key, x), = inputs.items()
    serve = serve_tokens if key == "tokens" else serve_embeds
    timed = TimedModel(model)
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    t = time.perf_counter()
    out = serve(timed, params, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launches_since(before)
    peak = torch.cuda.max_memory_allocated()
    require(not any(counts.values()), f"[{tag}] launches {counts}")
    require(tuple(out.shape) == (LM_BATCH, LM_NEW),
            f"[{tag}] output {tuple(out.shape)}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            f"[{tag}] a token outside the vocabulary")
    require(all(bool(torch.isfinite(y).all()) for y in timed.logits),
            f"[{tag}] non-finite logits")
    prefill_s = timed.times["prefill"][0]
    decode_s = sum(timed.times["decode"]) / len(timed.times["decode"])
    nbytes, bound = decode_bound_ms(params)
    print(f"[{tag}] {LM_BATCH} x {LM_PROMPT} {key} "
          f"{tuple(x.shape[2:])}, {LM_NEW} greedy tokens: wall "
          f"{wall:.4f} s, prefill {prefill_s:.4f} s, decode "
          f"{decode_s * 1e3:.3f} ms per step "
          f"({len(timed.times['decode'])} steps), peak "
          f"{peak / 2 ** 30:.2f} GiB; a decode step reads "
          f"{nbytes / 1e9:.3f} GB of weights: bound {bound:.3f} ms (bytes); "
          f"launches {counts}; tokens {out[:, :8].tolist()}", flush=True)
    if "R" in cfg.layer_pattern:
        state = 4 * LM_BATCH * cfg.d_model * cfg.rwkv_head_size
        print(f"[{tag}] state {state / 2 ** 20:.1f} MiB a layer", flush=True)
    # one chunk: the profiler's own cost grows with the 85k kernels of
    # RWKV's whole-prompt recurrence
    profile_step(tag, lambda: model.prefill(
        params, {key: x[:, :FAMILY_PROFILE_PREFILL]}),
        f"prefill of {LM_BATCH} x {FAMILY_PROFILE_PREFILL}")
    cache = model.make_cache(LM_BATCH, LM_PROMPT + 1)
    profile_step(tag, lambda: model.decode_step(
        params, cache, {key: x[:, :1]}, LM_PROMPT), "decode step")
    del cache
    if tf is not None:
        gate = tf(Model(cfg.with_overrides(compute_dtype=torch.float32),
                        device="cuda"), params, "f32 compute", tag)
        require(gate["agree"] >= min_agree,
                f"[{tag}] f32 argmax agreement {gate['agree']} < {min_agree}")
        require(gate["diff"] <= 1e-3 * gate["scale"],
                f"[{tag}] f32 teacher forcing: max diff {gate['diff']} > "
                f"1e-3 * {gate['scale']}")
        tf(model, params, "bf16 compute", tag)
    del params, timed
    torch.cuda.empty_cache()


def drive_lm_families():
    """The twelfth route: RWKV6-7B (its teacher forcing: every row's
    argmax equal), MusicGen-medium (``lm-serve``'s teacher forcing) and
    InternVL2-76B on the card, then their SMOKE widths card against CPU.
    The launch counts are set to 0 once, just before, and read just
    after; no helper resets them in between.  The path runs no
    hand-written kernel (the WKV recurrence and the frontends are plain
    PyTorch), so every count must stay 0.  The host's launch rate is
    printed before and after (decode is bound by it)."""
    from repro_torch.kernels import ops
    t = time.perf_counter()
    ops.reset_launch_counts()
    print(f"[lm-families] host launch {host_launch_us():.2f} us per small "
          f"kernel", flush=True)
    drive_family("rwkv6_7b", rwkv_teacher_forcing, 1.0)
    drive_family("musicgen_medium", frontend_teacher_forcing, 0.95)
    drive_family("internvl2_76b")
    for arch in FAMILY_ARCHS:
        check_lm_against_cpu(arch, "lm-families")
    counts = ops.launch_counts()
    require(not any(counts.values()), f"[lm-families] launches {counts}")
    print(f"[lm-families] host launch {host_launch_us():.2f} us per small "
          f"kernel; route wall {time.perf_counter() - t:.1f} s; launches "
          f"{counts}", flush=True)
    return counts


def paper_modules():
    """The port's harness, imported from the checkout's root."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import importlib
    names = ("common", "table1_accuracy", "fig1_2_maxneighbors",
             "fig3_temperature", "fig4_exchange_period", "fig5_solvers",
             "fig6_7_processes", "scheduler_sim", "mapper_throughput",
             "sparse_scale", "kernel_micro", "solver_hotloop")
    return {n: importlib.import_module(f"benchmarks_torch.{n}") for n in names}


@contextlib.contextmanager
def bench_budget(common, scale, runs):
    """``common.SCALE``/``RUNS`` set for a block, restored after it."""
    old = common.SCALE, common.RUNS
    common.SCALE, common.RUNS = scale, runs
    try:
        yield
    finally:
        common.SCALE, common.RUNS = old


def f_rtol(n, f):
    """How far a reported f32 objective may lie from the exact F: none
    while F is below 2^24 (every partial sum an exact f32 integer), else
    n * 2^-24 of F (the roundings of summing n exact row sums, or of a
    chain's running F plus exact deltas)."""
    return 0.0 if f < F32_EXACT else n * 2.0 ** -24 * f


def check_paper_row(row):
    """A harness row's permutation is feasible, its exact F(perm) (numpy
    float64) is the reported F (see ``f_rtol``) and no better than the
    instance's known optimum."""
    import numpy as np
    from repro_torch.core import instances
    inst = instances.get_instance(row.order)
    n = row.order
    perm = np.asarray(row.perm)
    require(perm.shape == (n,) and (np.sort(perm) == np.arange(n)).all(),
            f"[paper] {row.name}: infeasible permutation")
    f = float((inst.C.astype(np.float64)
               * inst.M.astype(np.float64)[np.ix_(perm, perm)]).sum())
    require(abs(f - row.f) <= f_rtol(n, f),
            f"[paper] {row.name}: reported F {row.f} != F(perm) {f}")
    require(inst.optimum <= f and inst.optimum <= row.f,
            f"[paper] {row.name}: F {row.f} (F(perm) {f}) below F0 "
            f"{inst.optimum}")
    print(f"[paper] {row.name}: T {row.seconds:.4f} s, {row.derived}, "
          f"F(perm) {f:.0f}", flush=True)


def check_paper_kernels(device):
    """K1 and K2 against their plain versions on Table 1's real taiXe
    instances at orders 343 and 729 (the L2 branches), at the shapes
    Table 1 gives them: PSA's 4 x 8 chains x 50 candidates and PGA's 4
    islands x 64 children (pop 128); K1 bitwise, K2 within ``f_rtol``;
    timed by CUDA events and in a CUDA graph, beside their bounds."""
    import torch
    from repro_torch.core import instances, keys, qap
    from repro_torch.kernels.qap_delta import qap_delta_cuda, qap_delta_plain
    from repro_torch.kernels.qap_objective import (qap_objective_cuda,
                                                   qap_objective_plain)
    out = {}
    for n in PAPER_KERNEL_ORDERS:
        inst = instances.get_instance(n)
        C = torch.as_tensor(inst.C, device=device)
        M = torch.as_tensor(inst.M, device=device)
        CT, MT = C.t().contiguous(), M.t().contiguous()
        base = keys.prng_key(n, device)
        p = qap.random_permutations(base, 32, n)
        pairs = qap.random_swap_pairs(keys.split(keys.fold_in(base, 1), 32),
                                      50, n)
        pops = qap.random_permutations(keys.split(keys.fold_in(base, 2), 4),
                                       64, n)
        io = 32 * n + 32 * 50 * 3                # p; pairs in, deltas out
        for kernel, launch, plain, (nbytes, flops) in (
                ("qap_delta", lambda: qap_delta_cuda(C, M, p, pairs, CT, MT),
                 lambda: qap_delta_plain(C, M, p, pairs),
                 (4 * (2 * n * n + io), 8 * n * 32 * 50)),
                ("qap_objective", lambda: qap_objective_cuda(C, M, pops),
                 lambda: qap_objective_plain(C, M, pops),
                 (4 * (2 * n * n + 256 * n + 256), 2 * n * n * 256))):
            got = branch_launched(kernel, "l2", launch)
            want = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = 0.0 if kernel == "qap_delta" else f_rtol(
                n, float(want.abs().max()))
            require(err <= tol, f"[paper] {kernel} at tai{n}: kernel != "
                    f"plain, max err {err} (allowed {tol})")
            ms, dev_ms = cuda_ms(launch, 50), graph_ms(launch, 50)
            bound, by = bound_ms(nbytes, flops)
            out[(kernel, n)] = dict(err=err, ms=ms, graph_ms=dev_ms,
                                    bound_ms=bound, bound_by=by)
            print(f"[paper] {kernel} on tai{n}e01s {tuple(got.shape)} (l2 "
                  f"branch): kernel {ms:.4f} ms ({dev_ms:.4f} ms in a "
                  f"graph), bound {bound:.4f} ms ({by}), max err {err} "
                  f"(allowed {tol})", flush=True)
    return out


def drive_paper():
    """The port's harness on the card: Table 1 at all seven orders
    (PAPER_SCALE, one run a cell), Figs 1-7 (PAPER_FIG_SCALE), the dry
    runs of scheduler_sim and mapper_throughput (also with --mesh-shape
    1), sparse_scale and solver_hotloop (both loops), and kernel_micro,
    with the launch counts set to 0 just before and read
    just after; every Table 1 and figure row checked against F(perm) and
    F0; then Table 1 at orders 27 and 45 and scheduler_sim's dry-run
    replay on the card and on the CPU, equal.  Returns the launch
    counts."""
    import torch
    from repro_torch.kernels import ops
    mods = paper_modules()
    common = mods["common"]
    t_route = time.perf_counter()
    walls = {}

    def timed(part, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[part] = time.perf_counter() - t
        return out

    ops.reset_launch_counts()
    with bench_budget(common, PAPER_SCALE, 1):
        table = timed("table1", lambda: mods["table1_accuracy"].rows("cuda"))
    figs = []
    with bench_budget(common, PAPER_FIG_SCALE, 1):
        for name in ("fig1_2_maxneighbors", "fig3_temperature",
                     "fig4_exchange_period", "fig5_solvers",
                     "fig6_7_processes"):
            figs += timed(name, lambda: mods[name].rows("cuda"))
    dry = ["--dry-run", "--device", "cuda", "--json", ""]
    sched = timed("scheduler_sim", lambda: mods["scheduler_sim"].main(dry))
    timed("mapper_throughput", lambda: mods["mapper_throughput"].main(dry))
    mesh_dry = dry + ["--mesh-shape", "1"]
    timed("mapper_throughput mesh", lambda: mods["mapper_throughput"].main(
        mesh_dry))
    timed("scheduler_sim mesh", lambda: mods["scheduler_sim"].main(mesh_dry))
    timed("sparse_scale", lambda: mods["sparse_scale"].main(dry))
    for loop in ("default", "fused"):
        timed(f"solver_hotloop {loop}", lambda: mods["solver_hotloop"].main(
            dry + ["--loop", loop]))
    micro = timed("kernel_micro", lambda: mods["kernel_micro"].run(None, "cuda"))
    counts, branches = ops.launch_counts(), ops.branch_counts()
    for kernel in ("qap_delta", "qap_objective"):
        require(counts[kernel] > 0, f"[paper] launched no {kernel}")
        require(branches[f"{kernel}/l2"] > 0,
                f"[paper] no {kernel} launch on the L2 branch")

    print(f"[paper] Table 1 at REPRO_BENCH_SCALE={PAPER_SCALE}, "
          f"REPRO_BENCH_RUNS=1:", flush=True)
    for row in table:
        check_paper_row(row)
    require([r.order for r in table][::3] == list(
        mods["table1_accuracy"].ORDERS), "[paper] Table 1 lacks an order")
    print(f"[paper] Figs 1-7 at REPRO_BENCH_SCALE={PAPER_FIG_SCALE}:",
          flush=True)
    for row in figs:
        check_paper_row(row)
    for line in micro:
        print(f"[paper] {line}", flush=True)

    with bench_budget(common, PAPER_CPU_SCALE, 1):
        t1 = mods["table1_accuracy"]
        orders, t1.ORDERS = t1.ORDERS, PAPER_CPU_ORDERS
        try:
            small = {dev: timed(f"table1 {PAPER_CPU_ORDERS} {dev}",
                                lambda: t1.rows(dev))
                     for dev in ("cuda", "cpu")}
        finally:
            t1.ORDERS = orders
    require(len(small["cuda"]) == len(small["cpu"]) == 3 * len(
        PAPER_CPU_ORDERS), "[paper] card or cpu Table 1 lacks a row")
    for a, b in zip(small["cuda"], small["cpu"]):
        require(a.name == b.name and (a.perm == b.perm).all() and a.f == b.f,
                f"[paper] {a.name}: card F={a.f} != cpu F={b.f}")
    cpu_dry = ["--dry-run", "--device", "cpu", "--json", ""]
    sched_cpu = timed("scheduler_sim cpu",
                      lambda: mods["scheduler_sim"].main(cpu_dry))
    wall_keys = ("wall_s", "map_wall_p50_ms", "map_wall_p99_ms")

    def decisions(payload):
        rm = payload["scheduler_rm"]
        return {k: ({f: v for f, v in rm[k].items() if f not in wall_keys}
                    if isinstance(rm[k], dict) else rm[k])
                for k in ("first_fit", "co_opt", "objective_improvement",
                          "makespan_ratio")}

    require(decisions(sched) == decisions(sched_cpu),
            "[paper] scheduler_sim dry run: card != cpu")
    print(f"[paper] card == cpu: Table 1 at orders {PAPER_CPU_ORDERS} "
          f"(scale {PAPER_CPU_SCALE}, perm and F), scheduler_sim dry-run "
          f"replay (objective_improvement "
          f"{sched['scheduler_rm']['objective_improvement']})", flush=True)
    print(f"[paper] launches {counts}, branches {branches}; walls (s) "
          f"{ {k: f'{v:.4f}' for k, v in walls.items()} }, route wall "
          f"{time.perf_counter() - t_route:.1f} s", flush=True)
    return counts


def drive_mesh_engine(dense):
    """Each dense route's MESH_ENGINE_ORDERS waves through
    ``MappingEngine(mesh=)`` with cuda:0 named MESH_SHARDS times, the
    launch counts set to 0 just before each wave and read just after;
    every response equal to the unsharded engine's from phase 4
    (``dense``: route -> (responses, walls)).  The kernels were built and
    first used in phase 4, so no warmup."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_with_devices
    mesh = make_mesh_with_devices([torch.device("cuda", 0)] * MESH_SHARDS,
                                  (MESH_SHARDS,), ("instances",))
    total = {}
    for route in ROUTES:
        reqs, optima = route_requests(route)
        plain, plain_walls = dense[route]
        engine = engine_for(route, None, mesh=mesh)
        require(engine.device == torch.device("cuda", 0),
                f"[mesh] {route}: engine device {engine.device}")
        for order in MESH_ENGINE_ORDERS[route]:
            wave = [r for r in reqs if r.C.shape[0] == order]
            ops.reset_launch_counts()
            t = time.perf_counter()
            futs = [engine.submit(r) for r in wave]
            engine.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts, branches = ops.launch_counts(), ops.branch_counts()
            for r, fut in zip(wave, futs):
                resp, want = fut.result(), plain[r.job_id]
                check_response(r, resp, optima[r.job_id])
                require(resp.batch_size == len(wave)
                        and (resp.perm == want.perm).all()
                        and resp.objective == want.objective,
                        f"[mesh] {route} {r.job_id}: sharded F="
                        f"{resp.objective} != unsharded F={want.objective}")
            require_smem_branch(f"mesh {route}", counts, branches)
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            print(f"[mesh] {route} bucket {resp.bucket}, {len(wave)} "
                  f"requests over {MESH_SHARDS} shards on cuda:0: wave wall "
                  f"{wall:.4f} s (unsharded {plain_walls[order]:.4f} s), "
                  f"launches {counts}, branches {branches}; == unsharded",
                  flush=True)
    return total


def mesh_case(name, mesh, inst):
    """One distributed case on this rank: ``(perm, f, history)``."""
    from repro_torch.core import (annealing, composite, distributed,
                                  genetic, keys, mapping)
    kind, changes = MESH_CASES[name]
    key = keys.prng_key(MESH_SEED)
    sa = annealing.SAConfig(**SA_KW, **(changes if kind == "psa" else {}))
    ga = genetic.GAConfig(**GA_KW, **(changes if kind == "pga" else {}))
    if kind == "find":
        res = mapping.find_mapping(inst.C, inst.M, "psa", key=key,
                                   sa_cfg=sa, mesh=mesh)
        return res.perm, res.objective, res.history
    if kind == "psa":
        out = distributed.run_psa_mesh(inst.C, inst.M, key, sa, mesh)
    elif kind == "pga":
        out = distributed.run_pga_mesh(inst.C, inst.M, key, ga, mesh)
    else:
        out = distributed.run_pca_mesh(inst.C, inst.M, key,
                                       composite.CompositeConfig(sa=sa, ga=ga),
                                       mesh)
    p, f, h = out
    return p.cpu().numpy(), f.item(), h.cpu().numpy()


def mesh_rank(mesh, names):
    """One rank of a spawned world: each case on the order-125 instance,
    the launch counts set to 0 just before it and read just after."""
    import numpy as np
    import torch
    from repro_torch.core import instances
    from repro_torch.kernels import ops
    torch.set_num_threads(MESH_RANK_THREADS)
    inst = instances.make_taie(ORDER)
    out = {}
    for name in names:
        ops.reset_launch_counts()
        t = time.perf_counter()
        perm, f, hist = mesh_case(name, mesh, inst)
        if mesh.device_type == "cuda":
            torch.cuda.synchronize()
        out[name] = dict(perm=np.asarray(perm, np.int32), f=float(f),
                         hist=np.asarray(hist, np.float32),
                         wall=time.perf_counter() - t,
                         launches=ops.launch_counts(),
                         branches=ops.branch_counts())
    return out


def check_mesh_world(label, ranks, on_card):
    """Every rank's answer the same, a feasible permutation with f =
    F(perm) exactly, F0 <= f <= F(identity), a history that does not
    increase; on the card each case launched its kernels, every launch
    on the shared-memory branch (order 125)."""
    import numpy as np
    from repro_torch.core import instances
    inst = instances.make_taie(ORDER)
    C, M = inst.C.astype(np.float64), inst.M.astype(np.float64)
    ident = float((C * M).sum())
    for name, r0 in ranks[0].items():
        for rank, rr in enumerate(ranks[1:], 1):
            require(rr[name]["perm"].tobytes() == r0["perm"].tobytes()
                    and rr[name]["f"] == r0["f"]
                    and rr[name]["hist"].tobytes() == r0["hist"].tobytes(),
                    f"[mesh] {label} {name}: rank {rank} != rank 0")
        perm = r0["perm"]
        require((np.sort(perm) == np.arange(ORDER)).all(),
                f"[mesh] {label} {name}: infeasible permutation")
        f = float((C * M[np.ix_(perm, perm)]).sum())
        require(f == r0["f"], f"[mesh] {label} {name}: f {r0['f']} != "
                f"F(perm) {f}")
        require(inst.optimum <= f <= ident, f"[mesh] {label} {name}: F {f}"
                f" outside [F0 {inst.optimum}, F(identity) {ident}]")
        require((np.diff(r0["hist"]) <= 0).all(),
                f"[mesh] {label} {name}: history increases")
        for rank, rr in enumerate(ranks):
            counts = rr[name]["launches"]
            if on_card:
                for kernel in MESH_KERNELS[name]:
                    require(counts[kernel] > 0, f"[mesh] {label} {name}: "
                            f"rank {rank} launched no {kernel}")
                require_smem_branch(f"mesh {label} {name}", counts,
                                    rr[name]["branches"])
            else:
                require(not any(counts.values()),
                        f"[mesh] {label} {name}: launches on the cpu")
        print(f"[mesh] {label} {name}: F {f:.0f} (F/F0 "
              f"{f / inst.optimum:.4f}), wall max over ranks "
              f"{max(rr[name]['wall'] for rr in ranks):.4f} s, launches "
              f"per rank {[{k: v for k, v in rr[name]['launches'].items() if v} for rr in ranks]}; "
              f"every rank agrees", flush=True)


def drive_mesh_worlds():
    """The MESH_WORLDS, stage after stage, the worlds of a stage side by
    side, each given MESH_TIMEOUT_S; a rank's failure fails the route.
    Then card x4 == cpu x4 on the cpu cases, and pga-fused == pga-wide in
    every world.  Returns each world's rank-0 results."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch.world import default_backend, run_world

    def world(label, size, backend, device_type, names):
        require(default_backend(device_type, size) == backend,
                f"[mesh] {label}: default backend "
                f"{default_backend(device_type, size)} != {backend}")
        t = time.perf_counter()
        ranks = run_world(mesh_rank, size, backend=backend,
                          device_type=device_type, args=(names,),
                          timeout_s=MESH_TIMEOUT_S)
        return ranks, time.perf_counter() - t

    out = {}
    for stage in MESH_WORLDS:
        with ThreadPoolExecutor(len(stage)) as pool:
            futures = [pool.submit(world, *w) for w in stage]
            done = [f.result() for f in futures]
        for (label, _, backend, device_type, _), (ranks, wall) in zip(
                stage, done):
            print(f"[mesh] {label} ({backend}, {device_type}): world wall "
                  f"{wall:.1f} s (spawn, import and first use included; "
                  f"beside {[w[0] for w in stage if w[0] != label]})",
                  flush=True)
            out[label] = (ranks, device_type)
    first = {}
    for label, (ranks, device_type) in out.items():
        check_mesh_world(label, ranks, device_type == "cuda")
        first[label] = r0 = ranks[0]
        if "pga-fused" in r0:
            a, b = r0["pga-fused"], r0["pga-wide"]
            require(a["perm"].tobytes() == b["perm"].tobytes()
                    and a["f"] == b["f"],
                    f"[mesh] {label}: pga-fused != pga-wide")
    for name in MESH_CPU_CASES:
        a, b = first["card x4"][name], first["cpu x4"][name]
        require(a["perm"].tobytes() == b["perm"].tobytes()
                and a["f"] == b["f"]
                and a["hist"].tobytes() == b["hist"].tobytes(),
                f"[mesh] {name}: card x4 F={a['f']} != cpu x4 F={b['f']}")
    print(f"[mesh] card x4 == cpu x4 on {MESH_CPU_CASES}", flush=True)
    return first


def drive_mesh(dense):
    """The tenth route: the sharded engine, then the distributed worlds.
    Returns the sharded engine's launch counts."""
    t = time.perf_counter()
    counts = drive_mesh_engine(dense)
    print(f"[mesh] sharded engine {time.perf_counter() - t:.1f} s",
          flush=True)
    drive_mesh_worlds()
    print(f"[mesh] route wall {time.perf_counter() - t:.1f} s", flush=True)
    return counts


def train_config():
    """Qwen3-4B at full width cut to TRAIN_LAYERS layers, trained in bf16
    compute on f32 master weights and moments, remat "full"."""
    from repro_torch import configs
    return configs.get_config("qwen3_4b").with_overrides(
        num_layers=TRAIN_LAYERS, layer_pattern="T" * TRAIN_LAYERS,
        remat="full", loss_chunk=512)


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def loss_and_grad_norm(model, params, batch):
    """The loss of ``batch`` and the global norm of its gradients (no
    update); the gradients are freed."""
    import torch
    from repro_torch.models.param import tree_flatten, tree_unflatten
    from repro_torch.train import optimizer as opt
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = model.loss(tree_unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), float(opt.global_norm(list(grads)))


KERNEL_CLASSES = (("matmul", ("gemm", "cutlass", "xmma", "sm90_", "cublas")),
                  ("reduction", ("reduce", "softmax", "norm")),
                  ("elementwise", ("elementwise", "vectorized", "unrolled")),
                  ("index / copy", ("index", "scatter", "gather", "copy",
                                    "cat", "fill")))


def kernel_class(name):
    low = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def profile_step(tag, fn, what="step"):
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA): its
    wall, the device's busy time (the sum of its kernels' durations) and
    that time by kernel class and by the largest kernels, and the host's
    waits on the card (``cudaStreamSynchronize``/``cudaDeviceSynchronize``
    calls, the last one the profiler's own)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_class, by_name, n, waits, wait_us = {}, {}, 0, 0, 0.0
    for evt in prof.events():
        if evt.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            waits += 1
            wait_us += evt.time_range.elapsed_us()
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        n += 1
        by_class[kernel_class(evt.name)] = by_class.get(
            kernel_class(evt.name), 0.0) + us
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us
    busy = sum(by_class.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[{tag}] profiled {what}: wall {wall:.4f} s (profiler on), "
          f"{n} device kernels, device busy {busy:.4f} s "
          f"({busy / wall:.3f} of the wall); by class (s) "
          f"{ {k: round(v / 1e6, 4) for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])} }; "
          f"largest {[(name[:60], round(us / 1e6, 4)) for name, us in top]}; "
          f"host waits on the card {waits}, {wait_us / 1e6:.4f} s",
          flush=True)


def drive_train_full_width(card, device="cuda"):
    """(a) TRAIN_STEPS AdamW steps of Qwen3-4B at full width on the card
    through ``train.step.make_train_step``, each timed on the host clock
    around a ``torch.cuda.synchronize()``; (b) the first step's loss and
    grad norm in f32 compute on the same weights and batch, before it.
    Returns the launch counts of the training loop."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    from repro_torch.train import data, optimizer as opt
    from repro_torch.train.step import make_train_step
    cfg = train_config()
    model = Model(cfg, device=device)
    t = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sync(device)
    print(f"[train] {cfg.name} at full width cut to {cfg.num_layers} layers: "
          f"{model.num_params()} parameters ({cfg.param_dtype} master, "
          f"{cfg.compute_dtype} compute, {cfg.opt_dtype} moments, remat "
          f"{cfg.remat}, loss_chunk {cfg.loss_chunk}) drawn on the card in "
          f"{time.perf_counter() - t:.2f} s; batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}; card {card}", flush=True)
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0)
    batches = [data.to_device(data.batch_at(dcfg, s), device)
               for s in range(TRAIN_STEPS)]

    # (b) the first step in f32 compute on the same weights and batch
    t = time.perf_counter()
    f32_loss, f32_norm = loss_and_grad_norm(
        Model(cfg.with_overrides(compute_dtype=torch.float32), device=device),
        params, batches[0])
    sync(device)
    print(f"[train] f32-compute first step: loss {f32_loss:.6f}, grad norm "
          f"{f32_norm:.6f} ({time.perf_counter() - t:.2f} s)", flush=True)
    ocfg = opt.OptConfig(lr=TRAIN_LR, moment_dtype=cfg.opt_dtype)
    state = opt.init(ocfg, params)
    step_fn = make_train_step(model, ocfg, opt.warmup_cosine(
        TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    sync(device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, walls = [], []
    for s, batch in enumerate(batches):
        t = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        sync(device)
        walls.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        print(f"[train] step {s + 1}: loss {losses[-1]:.6f}, grad norm "
              f"{float(m['grad_norm']):.6f}, lr {float(m['lr']):.3e}, step "
              f"wall {walls[-1]:.4f} s, "
              f"{TRAIN_BATCH * TRAIN_SEQ / walls[-1]:.1f} tokens/s",
              flush=True)
        if s == 0:
            norm0 = float(m["grad_norm"])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"[train] non-finite loss {losses}")
    require(losses[-1] < losses[0], f"[train] loss did not descend {losses}")
    loss_gap = abs(losses[0] - f32_loss) / abs(f32_loss)
    norm_gap = abs(norm0 - f32_norm) / abs(f32_norm)
    require(loss_gap <= 1e-2, f"[train] bf16 first loss {losses[0]} vs f32 "
            f"{f32_loss}: {loss_gap} > 1e-2")
    require(norm_gap <= 5e-2, f"[train] bf16 first grad norm {norm0} vs f32 "
            f"{f32_norm}: {norm_gap} > 5e-2")
    if on_card:
        profile_step("train",
                     lambda: step_fn(params, state, batches[0]))
    steady = walls[1:]
    print(f"[train] {TRAIN_STEPS} steps: first step wall {walls[0]:.4f} s, "
          f"then mean {sum(steady) / len(steady):.4f} s (min {min(steady):.4f},"
          f" max {max(steady):.4f}), "
          f"{TRAIN_BATCH * TRAIN_SEQ * len(steady) / sum(steady):.1f} "
          f"tokens/s; peak {peak / 2 ** 30:.2f} GiB; bf16 vs f32 first "
          f"step: loss gap {loss_gap:.3e}, grad norm gap {norm_gap:.3e}; "
          f"launches {counts}; card {card}", flush=True)
    del params, state, batches
    if on_card:
        torch.cuda.empty_cache()
    return counts


def smoke_grads(arch, device, dtype=None):
    """``arch`` at SMOKE width in f32 compute on ``device``, weights drawn
    from a CPU generator (seed 0) -- or, with ``dtype``, weights and
    compute cast to it: the model, its weights, TRAIN_CPU_STEPS batches of numpy draws
    (``embeds`` for a frontend model), and the first batch's loss and
    gradient leaves (on the CPU) with the K8 launches of that forward
    and backward."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    from repro_torch.models.param import tree_flatten, tree_unflatten
    from repro_torch.models.transformer import FRONTEND_DIMS
    cfg = configs.smoke_config(arch).with_overrides(
        compute_dtype=dtype or torch.float32)
    model = Model(cfg, device=device)
    leaves, treedef = tree_flatten(
        model.init(torch.Generator().manual_seed(0)))
    leaves = [(p if dtype is None else p.to(dtype)).detach()
              .requires_grad_(True) for p in leaves]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_CPU_STEPS, TRAIN_CPU_BATCH,
                                            TRAIN_CPU_SEQ + 1))
    batches = [{"tokens": torch.as_tensor(t[:, :-1], dtype=torch.int32,
                                          device=device),
                "labels": torch.as_tensor(t[:, 1:], dtype=torch.int32,
                                          device=device)} for t in toks]
    if cfg.frontend is not None:      # frames or patches in place of tokens
        fd = FRONTEND_DIMS[cfg.frontend]
        emb = rng.standard_normal(toks.shape[:2] + (TRAIN_CPU_SEQ, fd))
        for batch, e in zip(batches, emb):
            batch["embeds"] = torch.as_tensor(
                e, dtype=cfg.compute_dtype, device=device)
            del batch["tokens"]
    before = ops.launch_counts()
    loss = model.loss(tree_unflatten(treedef, leaves), batches[0])
    # a frontend model's embedding table is unused on embeds: zero
    grads = [torch.zeros_like(p).cpu() if g is None else g.detach().cpu()
             for p, g in zip(leaves, torch.autograd.grad(
                 loss, leaves, allow_unused=True))]
    return dict(model=model, params=tree_unflatten(
        treedef, [p.detach() for p in leaves]), batches=batches,
        grads=grads, treedef=treedef, first=float(loss.detach()),
        launched=launches_since(before)["selective_scan"],
        pattern=cfg.layer_pattern)


def smoke_train(arch, device):
    """:func:`smoke_grads` in f32, then TRAIN_CPU_STEPS AdamW steps'
    losses."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    run = smoke_grads(arch, device)
    ocfg = opt.OptConfig(lr=1e-3)
    step_fn = make_train_step(run["model"], ocfg,
                              opt.warmup_cosine(1e-3, 1, 10))
    params, losses = run["params"], []
    state = opt.init(ocfg, params)
    for batch in run["batches"]:
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
    return dict(run, losses=losses)


def grad_gaps(got, want):
    """Each leaf's max abs difference over the largest magnitude of
    ``want``'s leaf (where that leaf is 0: 0 if ``got``'s is too, else
    infinite)."""
    out = []
    for a, b in zip(got, want):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        out.append(err / scale if scale else 0.0 if err == 0 else math.inf)
    return out


def check_train_against_cpu(device="cuda"):
    """(c) TRAIN_CPU_ARCHS at SMOKE width in f32 (the frontend models on
    ``embeds``): losses within 1e-4 relative of the CPU's, first-step
    gradients per leaf within 1e-4 of the leaf's largest magnitude of the
    CPU's -- for TRAIN_F64_ARCHS within 1e-4 plus the CPU's own f32
    distance from its f64 gradient (relative to the same maximum);
    Jamba launches K8 in its
    training forward and every Mamba weight gets a nonzero gradient;
    every RWKV weight of every layer gets a nonzero gradient
    (``decay_a``, ``decay_b`` and ``bonus_u`` included)."""
    import torch
    from repro_torch.models.param import tree_unflatten
    t = time.perf_counter()
    launched = {}
    for arch in TRAIN_CPU_ARCHS:
        card, cpu = smoke_train(arch, device), smoke_train(arch, "cpu")
        require(cpu["launched"] == 0, f"[train] {arch}: launches on the cpu")
        for a, b in zip(card["losses"] + [card["first"]],
                        cpu["losses"] + [cpu["first"]]):
            require(abs(a - b) <= 1e-4 * abs(b), f"[train] {arch}: card loss "
                    f"{a} != cpu {b}")
        gaps = grad_gaps(card["grads"], cpu["grads"])
        bars = [1e-4] * len(gaps)
        if arch in TRAIN_F64_ARCHS:
            exact = smoke_grads(arch, "cpu", torch.float64)["grads"]
            card_gaps = grad_gaps(card["grads"], exact)
            cpu_gaps = grad_gaps(cpu["grads"], exact)
            bars = [1e-4 + e for e in cpu_gaps]
            i = max(range(len(gaps)), key=cpu_gaps.__getitem__)
            print(f"[train] {arch} first-step grads against f64 on the cpu: "
                  f"card within {max(card_gaps):.3e}, cpu f32 within "
                  f"{max(cpu_gaps):.3e} of each leaf's max; the cpu's worst "
                  f"leaf {i}: card {card_gaps[i]:.3e}, cpu {cpu_gaps[i]:.3e} "
                  f"from f64, card vs cpu {gaps[i]:.3e} (bar {bars[i]:.3e})",
                  flush=True)
        for i, (gap, bar) in enumerate(zip(gaps, bars)):
            require(gap <= bar, f"[train] {arch} grad leaf {i}: card vs cpu "
                    f"{gap} of the leaf's max > {bar}")
        if arch == "jamba_v0_1_52b":
            require(card["launched"] > 0 or device == "cpu",
                    "[train] jamba: no selective_scan launch in the "
                    "training forward")
            tree = tree_unflatten(card["treedef"], card["grads"])
            for ch, p in zip(card["pattern"], tree["unit"]):
                if ch in "mM":
                    require(all(bool(g.abs().max() > 0)
                                for g in p["mixer"].values()),
                            "[train] jamba: a Mamba weight has no gradient")
        if arch == "rwkv6_7b":
            tm = tree_unflatten(card["treedef"], card["grads"])["unit"][0]["tm"]
            silent = [(name, layer) for name, g in sorted(tm.items())
                      for layer in range(g.shape[0])
                      if not bool(g[layer].abs().max() > 0)]
            require(len(tm) == 20 and not silent,
                    f"[train] rwkv: weights without a gradient {silent}")
        launched[arch] = card["launched"]
        print(f"[train] {arch} smoke f32, card == cpu: losses "
              f"{[round(x, 6) for x in card['losses']]}, first-step grads "
              f"within {max(gaps):.2e} of each leaf's max, K8 launches in "
              f"the first forward and backward {card['launched']}",
              flush=True)
    print(f"[train] card vs cpu {time.perf_counter() - t:.1f} s", flush=True)
    return launched


def check_train_resume(device="cuda"):
    """(d) CFG_QUICK on the card: 6 steps uninterrupted, then 3 steps
    with a checkpoint every 3 and a fresh ``train()`` resuming to 6; the
    two histories within 1e-5 relative."""
    import shutil
    import tempfile
    from repro_torch.launch.train import train
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(**TRAIN_QUICK)
    t = time.perf_counter()
    whole = train(cfg, steps=6, device=device, **TRAIN_QUICK_KW)["history"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_",
                                dir=os.path.join(ROOT, "build"))
    try:
        first = train(cfg, steps=3, checkpoint_dir=ckpt_dir,
                      checkpoint_every=3, device=device,
                      **TRAIN_QUICK_KW)["history"]
        rest = train(cfg, steps=6, checkpoint_dir=ckpt_dir,
                     checkpoint_every=3, device=device,
                     **TRAIN_QUICK_KW)["history"]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    resumed = first + rest
    require([h["step"] for h in resumed] == [h["step"] for h in whole]
            == list(range(1, 7)), f"[train] resume steps {resumed}")
    for a, b in zip(resumed, whole):
        require(abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]),
                f"[train] resumed {a} != uninterrupted {b}")
    print(f"[train] CFG_QUICK resume 3 + 3 == 6 uninterrupted: losses "
          f"{[round(h['loss'], 6) for h in whole]} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)


def drive_train(card):
    """The eleventh route: full-width training, card against CPU, resume.
    Returns the full-width loop's launch counts and the K8 launches of
    the SMOKE forwards."""
    t = time.perf_counter()
    counts = drive_train_full_width(card)
    launched = check_train_against_cpu()
    check_train_resume()
    print(f"[train] route wall {time.perf_counter() - t:.1f} s", flush=True)
    return counts, launched


def placement_config():
    """Qwen3-4B at full width cut to PLACE_LAYERS layers (the placement
    route's training job), as ``train_config``'s."""
    from repro_torch import configs
    return configs.get_config("qwen3_4b").with_overrides(
        num_layers=PLACE_LAYERS, layer_pattern="T" * PLACE_LAYERS,
        remat="full", loss_chunk=512)


def place_cpu_solve(src, c, m, algorithm):
    """One placement on the CPU's default-budget PlacementService, in a
    pool process: ``(perm, F(identity), F)``."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import placement as pl
    res = pl.PlacementService(device="cpu").solve(c, m, algorithm)
    return res.perm.tolist(), res.cost_before, res.cost_after


def scatter_graph(n):
    """M of the resource manager's ``scatter`` candidate of ``n`` nodes on
    the empty rm-replay torus."""
    from repro_torch.serve.cluster import ClusterState
    cluster = ClusterState(torus(RM_TORUS).M)
    cand, = cluster.candidate_subsets(n, k=1, policies=("scatter",))
    return cluster.induced(cand.nodes)


def lower_job_cells(device):
    """Lower the train_4k cell of Qwen3-4B (full width and depth) on
    meshes (n, 1) of logical devices: ``{n: (mesh, LoweredCell)}``, the
    card's allocation unchanged."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.config import shape_cell
    from repro_torch.topology import traffic
    cfg, cell = configs.get_config("qwen3_4b"), shape_cell("train_4k")
    on_card = torch.device(device).type == "cuda"
    out = {}
    for n in PLACE_RANKS:
        mesh = Mesh(np.arange(n, dtype=object).reshape(n, 1),
                    ("data", "model"))
        sync(device)
        before = torch.cuda.memory_allocated() if on_card else 0
        lowered = lowering.lower_train_cell(cfg, cell, mesh)
        sync(device)
        after = torch.cuda.memory_allocated() if on_card else 0
        require(after == before, f"[placement] lowering on {n} allocated "
                f"{after - before} bytes of card memory")
        kinds = {}
        for op in lowered.collectives:
            k = kinds.setdefault(op.kind, [0, 0])
            k[0] += 1
            k[1] += op.bytes
        require(all(op.groups == [list(range(n))]
                    for op in lowered.collectives),
                f"[placement] a collective off the data group on {n}")
        print(f"[placement] lowered {cfg.name} ({cfg.num_layers} layers, "
              f"train_4k {cell.global_batch} x {cell.seq_len}, "
              f"{cell.global_batch // n} sequence(s) a rank) on ({n}, 1) in "
              f"{lowered.seconds:.2f} s: ops by kind (count, result bytes) "
              f"{ {k: tuple(v) for k, v in sorted(kinds.items())} }, "
              f"total_collective_bytes "
              f"{traffic.total_collective_bytes(lowered.collectives)}; card "
              f"allocation {before} -> {after} bytes", flush=True)
        out[n] = (mesh, lowered)
    return out


def solve_job_placement(service, c, m, algorithm, device, label,
                        tag="placement"):
    """One solve, printed with its launches: ``(perm, F(identity), F)``."""
    from repro_torch.kernels import ops
    n = c.shape[0]
    before, branches = ops.launch_counts(), ops.branch_counts()
    t = time.perf_counter()
    res = service.solve(c, m, algorithm)
    sync(device)
    wall = time.perf_counter() - t
    launched = {k: v for k, v in launches_since(before).items() if v}
    by_branch = {k: v - branches.get(k, 0)
                 for k, v in ops.branch_counts().items()
                 if v - branches.get(k, 0)}
    perm = res.perm.tolist()
    require(sorted(perm) == list(range(n)),
            f"[{tag}] {label}: not a permutation")
    require(res.cost_after <= res.cost_before,
            f"[{tag}] {label}: F above F(identity)")
    print(f"[{tag}] {label}: F(identity) {res.cost_before!r}, F "
          f"{res.cost_after!r}, gain {res.gain:.6f}, {wall:.3f} s beside "
          f"the CPU pool; launches {launched}, by branch {by_branch}",
          flush=True)
    return perm, res.cost_before, res.cost_after


def job_instances(cells):
    """Each cell's C against its mesh's torus and the scatter candidate:
    ``{(n, graph): (C, M)}``."""
    from repro_torch.launch import placement as pl
    return {(n, graph): (pl.traffic_from_compiled(lowered, n), m)
            for n, (mesh, lowered) in cells.items()
            for graph, m in (("torus", pl.system_graph_for_mesh(mesh)),
                             ("scatter", scatter_graph(n)))}


def solve_job_placements(instances, device):
    """The PLACE_RAW solves of each C and the PLACE_UNIT solves of C /
    max(C), each on a fresh default PlacementService: ``{(n, graph,
    algorithm): (perm, F(identity), F)}`` of each."""
    from repro_torch.launch import placement as pl

    def fresh():
        pl.reset_default_service()
        return pl.default_service() if device == "cuda" else \
            pl.PlacementService(device=device)

    raw, unit = {}, {}
    for (n, graph), (c, m) in instances.items():
        for algorithm in PLACE_RAW[n]:
            raw[n, graph, algorithm] = solve_job_placement(
                fresh(), c, m, algorithm, device,
                f"{n} ranks, {graph}, {algorithm}")
        for algorithm in PLACE_UNIT[n]:
            unit[n, graph, algorithm] = solve_job_placement(
                fresh(), c / c.max(), m, algorithm, device,
                f"{n} ranks, {graph}, {algorithm}, C / max(C)")
    pl.reset_default_service()
    for (n, graph, algorithm), got in raw.items():
        require(got == raw[n, graph, PLACE_RAW[n][0]],
                f"[placement] {n} ranks, {graph}: {algorithm} {got[1:]} != "
                f"{PLACE_RAW[n][0]} {raw[n, graph, PLACE_RAW[n][0]][1:]}")
    return raw, unit


def train_placed_job(card, device):
    """``launch.train.train`` on a (4, 1) mesh with placement psa against
    one device on the same batches: the world's losses, its placement
    and every rank's live trace against the lowered cell.  Returns one
    device's TP_STEPS losses (the tensor-parallel route's baseline)."""
    import torch
    from repro_torch.launch import lowering, train as launch_train
    from repro_torch.launch.mesh import make_mesh_with_devices
    from repro_torch.models.api import Model
    from repro_torch.models.config import ShapeCell
    cfg = placement_config()
    on_card = torch.device(device).type == "cuda"
    kw = dict(global_batch=PLACE_WORLD, seq_len=TRAIN_SEQ, lr=TRAIN_LR,
              warmup=TRAIN_WARMUP, log_every=1, seed=0)
    print(f"[placement] {cfg.name} at full width cut to {cfg.num_layers} "
          f"layers ({Model(cfg, device='meta').num_params()} parameters), "
          f"{PLACE_WORLD} x {TRAIN_SEQ} tokens, {PLACE_STEPS} steps: one "
          f"device first ({TP_STEPS} steps)", flush=True)
    t = time.perf_counter()
    one = launch_train.train(cfg, device=device, steps=TP_STEPS, **kw)
    sync(device)
    one_wall = time.perf_counter() - t
    every = [h["loss"] for h in one["history"]]
    want = every[:PLACE_STEPS]
    del one
    if on_card:
        torch.cuda.empty_cache()
        print(f"[placement] one device {one_wall:.2f} s, losses {want}; "
              f"card allocation before the world "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    mesh = make_mesh_with_devices([device] * PLACE_WORLD, (PLACE_WORLD, 1),
                                  ("data", "model"))
    t = time.perf_counter()
    world = launch_train.train(cfg, mesh=mesh, placement="psa",
                               steps=PLACE_STEPS, **kw)
    world_wall = time.perf_counter() - t
    got = [h["loss"] for h in world["history"]]
    info = world["placement"]
    lowered = lowering.lower_train_cell(
        cfg, ShapeCell("train", TRAIN_SEQ, PLACE_WORLD, "train"), mesh)
    require(abs(info["gain"] - 1 / 3) <= 1e-6,
            f"[placement] 4-rank gain {info['gain']} != 1/3")
    require(info["perm"] != list(range(PLACE_WORLD)),
            "[placement] 4-rank placement is the identity")
    for r, rank in enumerate(world["ranks"]):
        require(rank["trace"] == lowered.collectives,
                f"[placement] rank {r}'s live trace != the lowered trace")
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    require(len(got) == len(want) == PLACE_STEPS and
            max(gaps) <= PLACE_LOSS_RTOL,
            f"[placement] world losses {got} vs one device {want}")
    peaks = [rank["peak_bytes"] / 2 ** 30 if rank["peak_bytes"] else 0.0
             for rank in world["ranks"]]
    print(f"[placement] world of {PLACE_WORLD} gloo ranks on {device}, "
          f"alone on the host: "
          f"placement {info}, losses {got} (one device {want}, max "
          f"relative gap {max(gaps):.3e}), {len(lowered.collectives)} "
          f"collectives a step on every rank == lowered; rank walls "
          f"{[round(rank['seconds'], 2) for rank in world['ranks']]} s, "
          f"peaks {[round(p, 2) for p in peaks]} GiB; world wall "
          f"{world_wall:.2f} s; card {card}", flush=True)
    del world
    return every


def drive_placement(card, device="cuda"):
    """The thirteenth route: the paper's placement of a training job.
    Returns the route's launch counts and one device's TP_STEPS losses
    of its training job."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.kernels import ops
    t_route = time.perf_counter()
    start = ops.launch_counts()
    instances = job_instances(lower_job_cells(device))
    keys = [(n, graph, a) for n, graph in instances for a in PLACE_UNIT[n]]
    src = os.path.join(ROOT, "src")
    t_cpu = time.perf_counter()
    with ProcessPoolExecutor(PLACE_CPU_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        futures = {(n, graph, a): pool.submit(
            place_cpu_solve, src, c / c.max(), m, a)
            for (n, graph), (c, m) in instances.items()
            for a in PLACE_UNIT[n]}
        _, card_results = solve_job_placements(instances, device)
        cpu = {k: f.result() for k, f in futures.items()}
    cpu_wall = time.perf_counter() - t_cpu
    counts = launches_since(start)
    for kernel in ("qap_delta", "qap_objective", "qap_objective_sparse",
                   "qap_delta_sparse"):
        require(counts[kernel] > 0, f"[placement] the solves launched no "
                f"{kernel}")
    for k in keys:
        require(cpu[k] == card_results[k],
                f"[placement] {k}: card {card_results[k][1:]} != cpu "
                f"{cpu[k][1:]}")
    print(f"[placement] card == cpu on {len(keys)} solves of C / max(C) "
          f"{sorted(keys)} (the CPU pool's wall {cpu_wall:.1f} s, beside "
          f"the card's solves)", flush=True)
    want = train_placed_job(card, device)
    print(f"[placement] route wall {time.perf_counter() - t_route:.1f} s",
          flush=True)
    return counts, want


def by_axis(lowered, mesh_shape, tag="tensor-parallel"):
    """A lowered cell's ops by (axis, kind): ``{(axis, kind): [count,
    result bytes]}``, each op's groups those of the mesh's ``model`` or
    data axis (``[d, m]`` logical ids)."""
    import numpy as np
    ids = np.arange(math.prod(mesh_shape)).reshape(mesh_shape)
    groups = {"model": ids.tolist(), "data": ids.T.tolist()}
    out = {}
    for op in lowered.collectives:
        axis = next((a for a, g in groups.items() if op.groups == g), None)
        require(axis is not None, f"[{tag}] {op.kind} on groups "
                f"{op.groups[:2]}... of neither axis")
        k = out.setdefault((axis, op.kind), [0, 0])
        k[0] += 1
        k[1] += op.bytes
    return out


def lower_tp_cell(device):
    """Qwen3-4B's train_4k cell (full width and depth) lowered on the
    production (16, 16) mesh of logical devices: ``(mesh, LoweredCell)``,
    the card's allocation unchanged."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import shape_cell
    from repro_torch.topology import traffic
    cfg, cell = configs.get_config("qwen3_4b"), shape_cell("train_4k")
    mesh = make_production_mesh()
    shape = tuple(mesh.shape.values())
    on_card = torch.device(device).type == "cuda"
    sync(device)
    before = torch.cuda.memory_allocated() if on_card else 0
    lowered = lowering.lower_train_cell(cfg, cell, mesh)
    sync(device)
    after = torch.cuda.memory_allocated() if on_card else 0
    require(after == before, f"[tensor-parallel] lowering allocated "
            f"{after - before} bytes of card memory")
    ops_ = by_axis(lowered, shape)
    for axis in ("model", "data"):
        require({k for a, k in ops_ if a == axis} ==
                {"all-gather", "all-reduce", "reduce-scatter"},
                f"[tensor-parallel] {axis} ops {sorted(ops_)}")
    print(f"[tensor-parallel] lowered {cfg.name} ({cfg.num_layers} layers, "
          f"train_4k {cell.global_batch} x {cell.seq_len}) on {shape} "
          f"{tuple(mesh.axis_names)} in {lowered.seconds:.2f} s: "
          f"{len(lowered.collectives)} ops; by (axis, kind): (count, result "
          f"bytes) { {k: tuple(v) for k, v in sorted(ops_.items())} }, "
          f"total_collective_bytes "
          f"{traffic.total_collective_bytes(lowered.collectives)}; card "
          f"allocation {before} -> {after} bytes", flush=True)
    return mesh, lowered


def place_cells(cells, device, tag):
    """For each of ``cells`` (``{name: (mesh, LoweredCell)}`` on the
    production mesh): ``place_job`` (psa, a fresh default service) on the
    mesh's 16 x 16 torus, then psa on C / max(C) on the card beside the
    CPU's in a pool process, bit for bit.  Returns the launches of all
    the card's solves."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.kernels import ops
    from repro_torch.launch import placement as pl

    def fresh():
        pl.reset_default_service()
        return pl.default_service() if device == "cuda" else \
            pl.PlacementService(device=device)

    inst = {name: (pl.traffic_from_compiled(lowered, lowered.num_devices),
                   pl.system_graph_for_mesh(mesh))
            for name, (mesh, lowered) in cells.items()}
    workers = min(len(cells), PLACE_CPU_WORKERS)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        t_cpu = time.perf_counter()
        cpu = {name: pool.submit(place_cpu_solve, os.path.join(ROOT, "src"),
                                 c / c.max(), m, "psa")
               for name, (c, m) in inst.items()}
        before = ops.launch_counts()
        card = {}
        for name, (mesh, lowered) in cells.items():
            n = lowered.num_devices
            c, m = inst[name]
            start = ops.launch_counts()
            t = time.perf_counter()
            placed, res = pl.place_job(lowered, mesh, "psa", service=fresh())
            sync(device)
            wall = time.perf_counter() - t
            perm = res.perm.tolist()
            require(sorted(perm) == list(range(n))
                    and placed.devices.reshape(-1).tolist() == perm,
                    f"[{tag}] {name} place_job: not the placed mesh")
            require(res.cost_after <= res.cost_before,
                    f"[{tag}] {name} place_job: F above F(identity)")
            launched = {k: v for k, v in launches_since(start).items() if v}
            print(f"[{tag}] {name}: place_job on the 16 x 16 torus: "
                  f"F(identity) {res.cost_before!r}, F {res.cost_after!r}, "
                  f"gain {res.gain:.6f}, {wall:.3f} s; launches {launched}",
                  flush=True)
            card[name] = solve_job_placement(
                fresh(), c / c.max(), m, "psa", device,
                f"{name}, 256 ranks, torus, psa, C / max(C)", tag=tag)
        pl.reset_default_service()
        got = {name: f.result() for name, f in cpu.items()}
        cpu_wall = time.perf_counter() - t_cpu
    counts = launches_since(before)
    for kernel in ("qap_delta", "qap_objective_sparse", "qap_delta_sparse"):
        require(counts[kernel] > 0 or device == "cpu", f"[{tag}] the "
                f"placements launched no {kernel}")
    for name in cells:
        require(got[name] == card[name], f"[{tag}] {name} C / max(C): card "
                f"{card[name][1:]} != cpu {got[name][1:]}")
    print(f"[{tag}] C / max(C): card == cpu on {sorted(cells)} (the CPU's "
          f"solves {cpu_wall:.1f} s in {workers} pool process(es), beside "
          f"the card's)", flush=True)
    return counts


def train_tp_world(card, device, want):
    """``launch.train.train`` on a (2, 2) mesh with placement psa against
    one device's losses ``want`` on the same batches: the world's losses,
    placement, live traces against the lowered cell, peaks and walls."""
    import torch
    from repro_torch.launch import lowering, train as launch_train
    from repro_torch.launch.mesh import make_mesh_with_devices
    from repro_torch.models.config import ShapeCell
    cfg = placement_config()
    size = math.prod(TP_WORLD_SHAPE)
    mesh = make_mesh_with_devices([device] * size, TP_WORLD_SHAPE,
                                  ("data", "model"))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    world = launch_train.train(
        cfg, mesh=mesh, placement="psa", steps=TP_STEPS,
        global_batch=PLACE_WORLD, seq_len=TRAIN_SEQ, lr=TRAIN_LR,
        warmup=TRAIN_WARMUP, log_every=1, seed=0)
    world_wall = time.perf_counter() - t
    got = [h["loss"] for h in world["history"]]
    info = world["placement"]
    lowered = lowering.lower_train_cell(
        cfg, ShapeCell("train", TRAIN_SEQ, PLACE_WORLD, "train"), mesh)
    for r, rank in enumerate(world["ranks"]):
        require(rank["trace"] == lowered.collectives,
                f"[tensor-parallel] rank {r}'s live trace != the lowered "
                f"trace")
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    require(len(got) == len(want) == TP_STEPS and
            max(gaps) <= PLACE_LOSS_RTOL,
            f"[tensor-parallel] world losses {got} vs one device {want}")
    peaks = [rank["peak_bytes"] / 2 ** 30 if rank["peak_bytes"] else 0.0
             for rank in world["ranks"]]
    ops_ = by_axis(lowered, TP_WORLD_SHAPE)
    print(f"[tensor-parallel] world of {size} gloo ranks on {device}, mesh "
          f"{TP_WORLD_SHAPE}: placement {info}, losses {got} (one device "
          f"{want}, max relative gap {max(gaps):.3e}), "
          f"{len(lowered.collectives)} collectives a step on every rank == "
          f"lowered, by (axis, kind) "
          f"{ {k: tuple(v) for k, v in sorted(ops_.items())} }; step walls "
          f"{[[round(x, 2) for x in rank['step_seconds']] for rank in world['ranks']]} "
          f"s, rank setups "
          f"{[round(rank['setup_seconds'], 2) for rank in world['ranks']]} s, "
          f"peaks {[round(p, 2) for p in peaks]} GiB; world wall "
          f"{world_wall:.2f} s; card {card}", flush=True)


def smoke_world_config(arch, overrides):
    """``arch``'s SMOKE config in f32 compute with ``overrides``."""
    from repro_torch import configs
    import torch
    return configs.smoke_config(arch).with_overrides(
        compute_dtype=torch.float32, **overrides)


def smoke_rank(world_mesh, cases):
    """One rank of a SMOKE world: for each of ``cases`` (``(arch,
    overrides)``), the first step's loss and whole gradients on the
    (2, 2) mesh of the world's ranks, and this rank's K8 launches."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model
    from repro_torch.models.param import tree_flatten
    from repro_torch.parallel import data_parallel as dp
    from repro_torch.train import data as data_lib
    torch.set_num_threads(1)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if world_mesh.device_type == "cuda" else torch.device("cpu")
    out = []
    for arch, overrides in cases:
        cfg = smoke_world_config(arch, overrides)
        model = Model(cfg, device=dev)
        mesh = DeviceMesh(dev.type, torch.arange(
            dist.get_world_size()).reshape(TP_WORLD_SHAPE),
            mesh_dim_names=("data", "model"))
        axis, model_axis = dp.data_axis(mesh), dp.model_axis(mesh)
        layout = dp.param_layout(model, axis, model_axis)
        params = layout.shard(model.init(torch.Generator().manual_seed(0)))
        batch = dp.shard_batch(cfg, tp_smoke_cell(), data_lib.to_device(
            data_lib.batch_at(tp_smoke_data(cfg), 0), dev), axis)
        ops.reset_launch_counts()
        loss, grads = dp.make_loss_and_grads(
            model, axis, model_axis=model_axis)(params, batch)
        out.append({"loss": float(loss),
                    "k8": ops.launch_counts()["selective_scan"],
                    "grads": [g.cpu().numpy() for g in
                              tree_flatten(layout.gather(grads))[0]]})
    return out


def tp_smoke_cell():
    from repro_torch.models.config import ShapeCell
    return ShapeCell("train", TP_SMOKE_SEQ, TP_SMOKE_BATCH, "train")


def tp_smoke_data(cfg):
    from repro_torch.train import data as data_lib
    return data_lib.DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=TP_SMOKE_SEQ,
                               global_batch=TP_SMOKE_BATCH, seed=0)


def check_smoke_world(device, cases, tag):
    """``cases`` (``(arch, overrides)``: SMOKE configs in f32) in one
    (2, 2) world of gloo ranks on ``device`` against one CPU device: each
    first step's loss and gradients, and K8 launched on every rank of a
    model with Mamba layers.  Returns the world's K8 launches."""
    import numpy as np
    import torch
    from repro_torch.launch.world import run_world
    from repro_torch.models.api import Model
    from repro_torch.models.param import tree_flatten, tree_unflatten
    from repro_torch.train import data as data_lib
    wants = []
    for arch, overrides in cases:
        cfg = smoke_world_config(arch, overrides)
        model = Model(cfg, device="cpu")
        leaves, treedef = tree_flatten(
            model.init(torch.Generator().manual_seed(0)))
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = model.loss(tree_unflatten(treedef, leaves), data_lib.to_device(
            data_lib.batch_at(tp_smoke_data(cfg), 0), "cpu"))
        wants.append((cfg, float(loss.detach()), [
            g.numpy() for g in torch.autograd.grad(loss, leaves)]))
    t = time.perf_counter()
    ranks = run_world(smoke_rank, math.prod(TP_WORLD_SHAPE),
                      device_type=torch.device(device).type, backend="gloo",
                      args=(tuple(cases),), timeout_s=600)
    wall = time.perf_counter() - t
    for i, (cfg, loss, want) in enumerate(wants):
        worst = 0.0
        for r, rank in enumerate(ranks):
            got = rank[i]
            require(abs(got["loss"] - loss) <= TP_SMOKE_TOL * abs(loss),
                    f"[{tag}] {cfg.name} rank {r} loss {got['loss']} != "
                    f"cpu {loss}")
            require(len(got["grads"]) == len(want),
                    f"[{tag}] {cfg.name} rank {r}: leaf count")
            for j, (g, w) in enumerate(zip(got["grads"], want)):
                err = float(np.abs(g - w).max()) / max(
                    float(np.abs(w).max()), 1e-30)
                worst = max(worst, err)
                require(err <= TP_SMOKE_TOL, f"[{tag}] {cfg.name} rank {r} "
                        f"leaf {j}: {err:.3e} of its largest magnitude")
            if torch.device(device).type == "cuda" and \
                    "m" in cfg.layer_pattern:
                require(got["k8"] > 0, f"[{tag}] {cfg.name} rank {r} "
                        f"launched no selective_scan")
        print(f"[{tag}] {cfg.name} f32 on a {TP_WORLD_SHAPE} world of gloo "
              f"ranks on {device} == one CPU device: loss {loss!r}, worst "
              f"leaf {worst:.3e} of its largest magnitude; K8 launches by "
              f"rank {[rank[i]['k8'] for rank in ranks]}; world wall "
              f"{wall:.1f} s ({len(cases)} model(s))", flush=True)
    return sum(c["k8"] for rank in ranks for c in rank)


def drive_tensor_parallel(card, want, device="cuda"):
    """The fourteenth route: the tensor-parallel model axis.  ``want``:
    one device's TP_STEPS losses of the placement route's job.  Returns
    the route's launch counts (the placement's; each SMOKE rank's K8
    launches, counted in its own process, are added)."""
    t_route = time.perf_counter()
    mesh, lowered = lower_tp_cell(device)
    counts = place_cells({"qwen3-4b": (mesh, lowered)}, device,
                         "tensor-parallel")
    train_tp_world(card, device, want)
    counts["selective_scan"] += check_smoke_world(
        device, ((TP_SMOKE_ARCH, {}),), "tensor-parallel")
    print(f"[tensor-parallel] route wall {time.perf_counter() - t_route:.1f} "
          f"s", flush=True)
    return counts


def lower_ep_cells(device):
    """EP_ARCHS' train_4k cells at full width and depth lowered on the
    production (16, 16) mesh of logical devices: ``{name: (mesh,
    LoweredCell)}``, the card's allocation unchanged."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import shape_cell
    from repro_torch.models.moe import experts_on_ep
    from repro_torch.topology import traffic
    cell, mesh = shape_cell("train_4k"), make_production_mesh()
    shape = tuple(mesh.shape.values())
    m = mesh.shape["model"]
    on_card = torch.device(device).type == "cuda"
    out = {}
    for arch in EP_ARCHS:
        cfg = configs.get_config(arch).with_overrides(**EP_CUT.get(arch, {}))
        sync(device)
        before = torch.cuda.memory_allocated() if on_card else 0
        lowered = lowering.lower_train_cell(cfg, cell, mesh)
        sync(device)
        after = torch.cuda.memory_allocated() if on_card else 0
        require(after == before, f"[expert-parallel] lowering {cfg.name} "
                f"allocated {after - before} bytes of card memory")
        ops_ = by_axis(lowered, shape, "expert-parallel")
        require({k for a, k in ops_ if a == "data"} ==
                {"all-gather", "all-reduce", "reduce-scatter"} and
                {"all-gather", "all-reduce"} <=
                {k for a, k in ops_ if a == "model"},
                f"[expert-parallel] {cfg.name} ops {sorted(ops_)}")
        split = []
        if experts_on_ep(cfg):
            split.append(f"{cfg.num_experts // m} of {cfg.num_experts} "
                         f"experts")
        if "R" in cfg.layer_pattern:
            h = cfg.d_model // cfg.rwkv_head_size
            split.append(f"{h // m} of {h} RWKV heads")
        elif any(ch in "mM" for ch in cfg.layer_pattern):
            di = cfg.mamba_expand * cfg.d_model
            split.append(f"{di // m} of {di} Mamba channels")
        if "R" not in cfg.layer_pattern:
            split.append(f"{cfg.num_heads * cfg.head_dim // m} of "
                         f"{cfg.num_heads * cfg.head_dim} q columns "
                         f"({cfg.num_heads} heads)")
        print(f"[expert-parallel] lowered {cfg.name} ({cfg.num_layers} "
              f"layers, train_4k "
              f"{cell.global_batch} x {cell.seq_len}; a model rank "
              f"{', '.join(split)}) on {shape} {tuple(mesh.axis_names)} in "
              f"{lowered.seconds:.2f} s: {len(lowered.collectives)} ops; by "
              f"(axis, kind): (count, result bytes) "
              f"{ {k: tuple(v) for k, v in sorted(ops_.items())} }, "
              f"total_collective_bytes "
              f"{traffic.total_collective_bytes(lowered.collectives)}; card "
              f"allocation {before} -> {after} bytes", flush=True)
        out[cfg.name] = (mesh, lowered)
    return out


def drive_expert_parallel(device="cuda"):
    """The fifteenth route: the model axis for every architecture.
    Returns the route's launch counts (the placements'; each SMOKE rank's
    K8 launches, counted in its own process, are added)."""
    t_route = time.perf_counter()
    cells = lower_ep_cells(device)
    counts = place_cells(cells, device, "expert-parallel")
    k8 = check_smoke_world(device, EP_SMOKE, "expert-parallel")
    require(k8 > 0 or device == "cpu", "[expert-parallel] the Jamba world "
            "launched no selective_scan")
    counts["selective_scan"] += k8
    print(f"[expert-parallel] route wall {time.perf_counter() - t_route:.1f} "
          f"s", flush=True)
    return counts


def lower_serve_cells(device):
    """SERVE_CELLS at full width and depth lowered on the production
    (16, 16) mesh of logical devices: ``{name: (mesh, LoweredCell)}``,
    each device's cache bytes required, the card's allocation
    unchanged."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import shape_cell
    from repro_torch.topology import traffic
    mesh = make_production_mesh()
    shape = tuple(mesh.shape.values())
    on_card = torch.device(device).type == "cuda"
    out = {}
    for arch, name in SERVE_CELLS:
        cfg, cell = configs.get_config(arch), shape_cell(name)
        sync(device)
        before = torch.cuda.memory_allocated() if on_card else 0
        lowered = lowering.lower_cell(cfg, cell, mesh)
        sync(device)
        after = torch.cuda.memory_allocated() if on_card else 0
        require(after == before, f"[serve-parallel] lowering {cfg.name} "
                f"{name} allocated {after - before} bytes of card memory")
        want = SERVE_CACHE_BYTES[arch, name]
        require(lowered.kind == cell.kind and
                lowered.cache_bytes_per_device == want,
                f"[serve-parallel] {cfg.name} {name}: cache "
                f"{lowered.cache_bytes_per_device} bytes a device, not {want}")
        ops_ = by_axis(lowered, shape, "serve-parallel")
        require({k for a, k in ops_ if a == "data"} == {"all-gather"} and
                {"all-gather", "all-reduce"} ==
                {k for a, k in ops_ if a == "model"},
                f"[serve-parallel] {cfg.name} {name} ops {sorted(ops_)}")
        print(f"[serve-parallel] lowered {cfg.name} ({cfg.num_layers} "
              f"layers, {name} {cell.global_batch} x {cell.seq_len}; a "
              f"device {cell.global_batch // shape[0]} sequences, "
              f"{cell.seq_len // shape[1]} cache positions) on {shape} "
              f"{tuple(mesh.axis_names)} in {lowered.seconds:.2f} s: "
              f"{len(lowered.collectives)} ops; by (axis, kind): (count, "
              f"result bytes) "
              f"{ {k: tuple(v) for k, v in sorted(ops_.items())} }, "
              f"total_collective_bytes "
              f"{traffic.total_collective_bytes(lowered.collectives)}, "
              f"cache_bytes_per_device {lowered.cache_bytes_per_device}; "
              f"card allocation {before} -> {after} bytes", flush=True)
        out[f"{cfg.name} {name}"] = (mesh, lowered)
    return out


def serve_config():
    """Granite-34B at full width cut to SERVE_LAYERS layers, bf16 weights
    and compute."""
    from repro_torch import configs
    return configs.get_config("granite_34b").with_overrides(
        num_layers=SERVE_LAYERS, layer_pattern="T" * SERVE_LAYERS,
        param_dtype="bf16")


def serve_cells(batch, prompt, cache_len):
    from repro_torch.models.config import ShapeCell
    return (ShapeCell("prefill", prompt, batch, "prefill"),
            ShapeCell("decode", cache_len, batch, "decode"))


def combine_without_rescale(m, l, o):
    """A planted fault for the full-width world: the flash-decoding
    combine summing the ranks' (o, l) without rescaling each by
    ``exp(m_r - M)``."""
    import torch
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import tensor_parallel as tp
    sums = coll.all_reduce(torch.cat([o, l[..., None]], dim=-1),
                           tp.current_axis())
    return sums[..., :-1] / sums[..., -1:]


def serve_world(model, params, prompts, cache_len, steps):
    """A rank's serving on a (2, 2) mesh of the world's ranks, ``params``
    whole: the prefill of ``prompts`` (B, S) into a ``cache_len`` cache,
    then ``steps`` greedy decode steps.  Returns the whole logits of
    each step, the greedy tokens (B, steps + 1) (numpy), the collectives
    of each step, their walls, this rank's peak, the parameters'
    all-gather over data timed alone and, as a planted fault's reading,
    the first decode step's logits with :func:`combine_without_rescale`
    in place of the combine."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from unittest import mock
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import data_parallel as dp
    from repro_torch.parallel import tensor_parallel as tp
    cfg, dev = model.cfg, model.device
    mesh = DeviceMesh(dev.type, torch.arange(
        dist.get_world_size()).reshape(TP_WORLD_SHAPE),
        mesh_dim_names=("data", "model"))
    axis, model_axis = dp.data_axis(mesh), dp.model_axis(mesh)
    shards = dp.param_layout(model, axis, model_axis).shard(params)
    del params
    pcell = serve_cells(prompts.shape[0], prompts.shape[1], cache_len)[0]
    batch = dp.shard_batch(cfg, pcell, {"tokens": torch.as_tensor(
        prompts, device=dev)}, axis)
    prefill, decode = dp.make_serve_steps(model, axis, model_axis)

    def whole(x):
        x = coll.all_gather(coll.all_gather(x, model_axis, x.dim() - 1),
                            axis, 0)
        return x.float().cpu().numpy()

    out = {"logits": [], "tokens": [], "traces": [], "walls": []}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tok = cache = first = None
    for t in range(steps + 1):
        sync(dev)
        start = time.perf_counter()
        with coll.record_collectives() as ops_:
            if t == 0:
                logits, cache = prefill(shards, batch, cache_len)
            else:
                logits, cache = decode(shards, cache, {"tokens": tok[:, None]},
                                       prompts.shape[1] + t - 1)
        sync(dev)
        out["walls"].append(time.perf_counter() - start)
        out["traces"].append(list(ops_))
        out["logits"].append(whole(logits))
        tok = dp.greedy_tokens(logits, model_axis)
        first = tok if t == 0 else first
        out["tokens"].append(coll.all_gather(tok, axis, 0).cpu().numpy())
    out["tokens"] = np.stack(out["tokens"], axis=1)
    out["peak"] = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0
    del cache
    # the parameters' all-gather over data that opens every step, alone
    sync(dev)
    start = time.perf_counter()
    dp.gather_params(shards, dp.shard_dims(model, axis), axis)
    sync(dev)
    out["gather"] = time.perf_counter() - start
    # the planted fault: prefill (it runs no combine), then the first
    # decode step on the same token
    with mock.patch.object(tp, "combine_softmax", combine_without_rescale):
        _, cache = prefill(shards, batch, cache_len)
        logits, _ = decode(shards, cache, {"tokens": first[:, None]},
                           prompts.shape[1])
    out["fault"] = whole(logits)
    return out


def serve_full_rank(world_mesh, cfg, prompts, cache_len, steps):
    """One rank of the full-width world: ``cfg``'s weights drawn on the
    rank's device from a seeded generator (the same on every rank), then
    :func:`serve_world`."""
    import torch
    from repro_torch.models.api import Model
    torch.set_num_threads(1)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if world_mesh.device_type == "cuda" else torch.device("cpu")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    return serve_world(model, params, prompts, cache_len, steps)


def serve_one_device(model, params, prompts, cache_len, steps,
                     tokens=None):
    """One device's logits (numpy f32) of the prefill of ``prompts`` and
    of ``steps`` decode steps, and the tokens fed: its own greedy tokens,
    or ``tokens`` (B, steps + 1) a world chose (teacher forcing)."""
    import numpy as np
    import torch
    out, fed = [], []
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.as_tensor(
            prompts, device=model.device)}, cache_len=cache_len)
        for t in range(steps + 1):
            if t:
                logits, cache = model.decode_step(
                    params, cache, {"tokens": tok[:, None]},
                    prompts.shape[1] + t - 1)
            out.append(logits.float().cpu().numpy())
            tok = torch.argmax(logits, dim=-1) if tokens is None else \
                torch.as_tensor(tokens[:, t], device=model.device)
            fed.append(tok.cpu().numpy())
    return out, np.stack(fed, axis=1)


def serve_full_width(card, device="cuda"):
    """serve_config on a (2, 2) world of gloo ranks on ``device`` against
    one device on the same weights, fed the world's tokens: every step's
    logits within SERVE_TOL of their largest magnitude; each greedy token
    the one device's argmax where the one device's top two lie more than
    that bar apart, and within the bar of its top on the other rows (near
    ties, counted); every rank's live collectives the lowered cells'.
    Two planted faults' readings are required above the bar: the first
    decode step with the combine's rescale left out, and the greedy
    tokens a model rank's argmax over its own columns would give."""
    import numpy as np
    import torch
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.world import run_world
    from repro_torch.models.api import Model
    cfg = serve_config()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    cache_len = SERVE_PROMPT + SERVE_NEW
    t = time.perf_counter()
    ranks = run_world(serve_full_rank, math.prod(TP_WORLD_SHAPE),
                      device_type=torch.device(device).type, backend="gloo",
                      args=(cfg, prompts, cache_len, SERVE_NEW),
                      timeout_s=600)
    world_wall = time.perf_counter() - t
    tokens = ranks[0]["tokens"]
    for r, rank in enumerate(ranks):
        require((rank["tokens"] == tokens).all(),
                f"[serve-parallel] rank {r}'s tokens differ from rank 0's")
    mesh = Mesh(np.arange(4, dtype=object).reshape(TP_WORLD_SHAPE),
                ("data", "model"))
    pcell, dcell = serve_cells(SERVE_BATCH, SERVE_PROMPT, cache_len)
    lowered = [lowering.lower_cell(cfg, c, mesh) for c in (pcell, dcell)]
    for r, rank in enumerate(ranks):
        require(rank["traces"][0] == lowered[0].collectives and all(
            tr == lowered[1].collectives for tr in rank["traces"][1:]),
            f"[serve-parallel] rank {r}'s live trace != the lowered trace")

    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    want, _ = serve_one_device(model, params, prompts, cache_len,
                               SERVE_NEW, tokens)
    del params
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rel = lambda got, w: float(np.abs(got - w).max()) / float(
        np.abs(w).max())
    rows = np.arange(SERVE_BATCH)
    cols = cfg.vocab_size // TP_WORLD_SHAPE[1]
    worst, near, local_caught = 0.0, 0, 0
    for t, w in enumerate(want):
        bar = SERVE_TOL * float(np.abs(w).max())
        err = rel(ranks[0]["logits"][t], w)
        worst = max(worst, err)
        require(err <= SERVE_TOL, f"[serve-parallel] step {t} logits "
                f"{err:.3e} of their largest magnitude from one device")
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > bar
        require((tokens[clear, t] == np.argmax(w, axis=-1)[clear]).all(),
                f"[serve-parallel] step {t}: a greedy token differs from "
                f"one device's argmax on a row whose top two lie more than "
                f"{SERVE_TOL} of the logits' largest magnitude apart")
        require((top2[:, 1] - w[rows, tokens[:, t]] <= bar).all(),
                f"[serve-parallel] step {t}: a near tie's token lies more "
                f"than {SERVE_TOL} of the logits' largest magnitude below "
                f"one device's top")
        near += int((~clear).sum())
        local = np.argmax(w[:, :cols], axis=-1)
        local_caught += int((top2[:, 1] - w[rows, local] > bar).sum())
    fault = rel(ranks[0]["fault"], want[1])
    require(fault > SERVE_TOL, f"[serve-parallel] a combine without its "
            f"rescale reads {fault:.3e}, within the bar {SERVE_TOL}")
    require(local_caught > 0, "[serve-parallel] a rank-local argmax passes "
            "the token check on every row")
    walls = [rank["walls"] for rank in ranks]
    print(f"[serve-parallel] {cfg.name} at full width, {cfg.num_layers} "
          f"layers, bf16, on a {TP_WORLD_SHAPE} world of gloo ranks on "
          f"{device}: {SERVE_BATCH} x {SERVE_PROMPT} prompts, a cache of "
          f"{cache_len} positions ({cache_len // TP_WORLD_SHAPE[1]} a "
          f"rank), {SERVE_NEW} greedy steps; tokens {tokens.tolist()}; "
          f"one device's argmax on all {tokens.size - near} rows whose top "
          f"two lie more than {SERVE_TOL} of the largest magnitude apart, "
          f"within that bar of its top on the other {near} (near ties); "
          f"logits within {worst:.3e} of their largest magnitude; planted "
          f"faults: a combine without its exp(m_r - M) rescale reads "
          f"{fault:.3e}, model rank 0's argmax over its own columns "
          f"fails the token check on {local_caught} of {tokens.size} rows; "
          f"{len(lowered[0].collectives)} / {len(lowered[1].collectives)} "
          f"collectives a prefill / decode step on every rank == lowered; "
          f"prefill walls {[round(w[0], 3) for w in walls]} s, decode "
          f"{[round(1e3 * sum(w[1:]) / SERVE_NEW, 1) for w in walls]} ms a "
          f"step; the parameters' all-gather over data that opens each "
          f"step, timed alone: "
          f"{[round(1e3 * rank['gather'], 1) for rank in ranks]} ms; peaks "
          f"{[round(rank['peak'] / 2 ** 30, 2) for rank in ranks]} GiB; "
          f"world wall {world_wall:.1f} s; card {card}", flush=True)


def serve_smoke_worlds(device="cuda"):
    """SERVE_SMOKE in f32 on one (2, 2) world of gloo ranks on ``device``
    (``tests/_torch_serve_world.serve_rank``, the CPU tests' rank body)
    against one CPU device: the same greedy tokens, every step's logits
    within TP_SMOKE_TOL of their largest magnitude, K8 launched on every
    rank of Jamba.  Returns the world's K8 launches."""
    import numpy as np
    import torch
    from repro_torch.launch.world import run_world
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_serve_world as sw
    cases = [(arch, overrides, TP_WORLD_SHAPE)
             for arch, overrides in SERVE_SMOKE]
    t = time.perf_counter()
    ranks = run_world(sw.serve_rank, math.prod(TP_WORLD_SHAPE),
                      device_type=torch.device(device).type, backend="gloo",
                      args=(cases, torch.device(device).type),
                      timeout_s=600)
    wall = time.perf_counter() - t
    for i, (arch, overrides) in enumerate(SERVE_SMOKE):
        want = sw.one_device(arch, overrides, groups=TP_WORLD_SHAPE[0])
        name = f"{arch} {overrides}"
        worst = 0.0
        for r, rank in enumerate(ranks):
            got = rank[i]
            require((got["tokens"] == want["tokens"]).all(),
                    f"[serve-parallel] {name} rank {r} tokens "
                    f"{got['tokens']} != one CPU device's {want['tokens']}")
            for t, (g, w) in enumerate(zip(got["logits"], want["logits"])):
                err = float(np.abs(g - w).max()) / float(np.abs(w).max())
                worst = max(worst, err)
                require(err <= TP_SMOKE_TOL, f"[serve-parallel] {name} "
                        f"rank {r} step {t}: {err:.3e}")
            if torch.device(device).type == "cuda" and \
                    arch == "jamba_v0_1_52b":
                require(got["k8"] > 0, f"[serve-parallel] {name} rank {r} "
                        "launched no selective_scan")
        print(f"[serve-parallel] {name} f32 served on a {TP_WORLD_SHAPE} "
              f"world of gloo ranks on {device} == one CPU device: tokens "
              f"{want['tokens'].tolist()}, logits within {worst:.3e} of "
              f"their largest magnitude; K8 launches by rank "
              f"{[rank[i]['k8'] for rank in ranks]}", flush=True)
    print(f"[serve-parallel] SMOKE world wall {wall:.1f} s "
          f"({len(SERVE_SMOKE)} models)", flush=True)
    return sum(rank[i]["k8"] for rank in ranks
               for i in range(len(SERVE_SMOKE)))


def drive_serve_parallel(card, device="cuda"):
    """The sixteenth route: serving over the (data, model) mesh.  Returns
    the route's launch counts (the placements'; each SMOKE rank's K8
    launches, counted in its own process, are added)."""
    t_route = time.perf_counter()
    cells = lower_serve_cells(device)
    counts = place_cells(cells, device, "serve-parallel")
    serve_full_width(card, device)
    k8 = serve_smoke_worlds(device)
    require(k8 > 0 or device == "cpu", "[serve-parallel] the Jamba world "
            "launched no selective_scan")
    counts["selective_scan"] += k8
    print(f"[serve-parallel] route wall {time.perf_counter() - t_route:.1f} "
          f"s", flush=True)
    return counts


def launch_dryrun(card, device="cuda"):
    """LAUNCH_DRYRUN through ``dryrun.lower_cell`` on the single-pod
    (16, 16) mesh (the card's allocation unchanged), written to a
    temporary directory that ``roofline.load_all`` reads: every term
    above 0 and the useful ratio within LAUNCH_USEFUL on each ``ok``
    cell, ``long_500k`` skipped on full attention; then
    ``inspect_cell``'s top 12 of LAUNCH_INSPECT."""
    import tempfile
    import torch
    from repro_torch.launch import (dryrun, inspect_cell, placement_bench,
                                    roofline)
    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as art:
        for arch, shape in LAUNCH_DRYRUN:
            sync(device)
            before = torch.cuda.memory_allocated() if on_card else 0
            t = time.perf_counter()
            rec = dryrun.lower_cell(arch, shape, False)
            wall = time.perf_counter() - t
            after = torch.cuda.memory_allocated() if on_card else 0
            require(after == before, f"[launchers] dryrun {arch} {shape} "
                    f"allocated {after - before} bytes of card memory")
            rec["tag"] = ""
            with open(os.path.join(art, dryrun.cell_tag(rec) + ".json"),
                      "w") as f:
                json.dump(rec, f)
            if rec["status"] != "ok":
                print(f"[launchers] dryrun {arch} {shape}: {rec['status']} "
                      f"({rec.get('reason')})", flush=True)
                continue
            held = {k: rec[k] for k in ("weight_bytes_per_device",
                                        "opt_bytes_per_device",
                                        "cache_bytes_per_device") if k in rec}
            print(f"[launchers] dryrun {arch} {shape} on (16, 16): "
                  f"{wall:.2f} s of host time ({rec['lower_s']} s "
                  f"lowering); a device's counted FLOPs "
                  f"{rec['flops_by_dtype']}, HBM bytes {rec['hbm_bytes']!r}, "
                  f"collective bytes {rec['collective_bytes']}, "
                  f"collectives {rec['collectives']}, {held}; card "
                  f"{card}", flush=True)
        skipped = json.load(open(os.path.join(
            art, "qwen3_4b.long_500k.single.json")))
        require(skipped["status"] == "skipped", "[launchers] long_500k on "
                f"full attention: {skipped['status']}, not skipped")
        saved, roofline.ART = roofline.ART, art
        try:
            rows = roofline.load_all("single")
        finally:
            roofline.ART = saved
    require(len(rows) == len(LAUNCH_DRYRUN) - 1, f"[launchers] roofline "
            f"rows {len(rows)}")
    lo, hi = LAUNCH_USEFUL
    for r in rows:
        terms = (r["compute_s"], r["memory_s"], r["collective_s"])
        require(min(terms) > 0, f"[launchers] {r['arch']} {r['shape']}: "
                f"a roofline term is 0: {terms}")
        require(lo < r["useful_ratio"] <= hi, f"[launchers] {r['arch']} "
                f"{r['shape']}: model / counted FLOPs {r['useful_ratio']:.4f}"
                f" outside ({lo}, {hi}]")
    print("[launchers] roofline of the dry run (terms are a device's counted "
          "FLOPs, HBM bytes and collective bytes divided by the H100 SXM "
          "datasheet's rates, topology/h100.py: not times measured on the "
          "card):", flush=True)
    print(roofline.markdown_table(rows), flush=True)
    for r in rows:
        print(f"[launchers] {r['arch']} {r['shape']}: compute "
              f"{r['compute_s']!r} s, memory {r['memory_s']!r} s, collective "
              f"{r['collective_s']!r} s, model / counted FLOPs "
              f"{r['useful_ratio']!r}, roofline fraction "
              f"{r['roofline_fraction']!r}", flush=True)
    t = time.perf_counter()
    lowered, _ = placement_bench.compile_cell(*LAUNCH_INSPECT, False)
    print(f"[launchers] inspect_cell {' '.join(LAUNCH_INSPECT)} (lowered "
          f"with costs in {time.perf_counter() - t:.2f} s):", flush=True)
    inspect_cell.top_contributors(lowered.cost, lowered.collectives, 12)
    return rows


def launch_event_width(card, device="cuda"):
    """psa-event engines at each of LAUNCH_WIDTHS: the default width and
    ``"auto"`` on LAUNCH_ORDERS' waves (the ``"auto"`` engine's warmup
    fills the width cache at each bucket it warms; warmup changes no
    result, so the others skip it), widths 1 and 6 on the last of them;
    every response equal to the default width's bit for bit.  Returns
    the widths the autotune chose."""
    import torch
    from repro_torch.core import annealing
    from repro_torch.core.annealing import SAConfig
    from repro_torch.core.genetic import GAConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import MappingEngine
    reqs, optima = route_requests("psa-event")
    waves = [[r for r in reqs if r.C.shape[0] == order]
             for order in LAUNCH_ORDERS]
    annealing._EVENT_WIDTH_CACHE.clear()
    got, chosen = {}, {}
    for width in LAUNCH_WIDTHS:
        engine = MappingEngine(
            sa_cfg=SAConfig(**SA_KW, loop="event", event_width=width),
            ga_cfg=GAConfig(**GA_KW), num_processes=NUM_PROCESSES,
            device=device)
        lines = []
        if width == "auto":
            buckets = tuple(sorted({engine.bucket_for(w[0].C.shape[0])
                                    for w in waves}))
            t = time.perf_counter()
            engine.warmup(buckets=buckets, algorithms=("psa",))
            sync(device)
            lines.append(f"warmup {time.perf_counter() - t:.3f} s")
            chosen = dict(annealing._EVENT_WIDTH_CACHE)
            require(set(chosen) == {(torch.device(device).type, b)
                                    for b in buckets},
                    f"[launchers] event_width auto: warmup cached {chosen} "
                    f"for buckets {buckets}")
        for wave in (waves if width in (None, "auto") else waves[-1:]):
            before = ops.launch_counts()
            t = time.perf_counter()
            futs = [engine.submit(r) for r in wave]
            engine.flush()
            sync(device)
            wall = time.perf_counter() - t
            k1 = launches_since(before)["qap_delta"]
            for r, fut in zip(wave, futs):
                resp = got[width, r.job_id] = fut.result()
                check_response(r, resp, optima[r.job_id])
            used = annealing.resolved_event_width(engine.sa_cfg,
                                                  resp.bucket, device)
            lines.append(f"order {wave[0].C.shape[0]} (bucket {resp.bucket},"
                         f" width {used}): {wall:.4f} s, {k1} K1")
        engine.stop()
        print(f"[launchers] event_width {width!r}: {'; '.join(lines)}; "
              f"card {card}", flush=True)
    for (width, job), resp in got.items():
        want = got[None, job]
        require((want.perm == resp.perm).all()
                and want.objective == resp.objective,
                f"[launchers] event_width {width!r} {job}: F "
                f"{resp.objective} != the default width's {want.objective}")
    print(f"[launchers] event_width: the autotune chose {chosen}; every "
          f"width's responses == the default width's ({len(got)} "
          f"responses)", flush=True)
    return chosen


def launch_placement(card, device):
    """``placement_bench.bench`` of LAUNCH_PLACE on 512 ranks with its six
    solves on ``device``: no F above F(identity), the fragmented
    allocation's F(identity) above the pristine slice's, the multilevel
    route's own answer on it printed; ``placement_gain.run()`` on the
    written artifact; psa on C / max(C) on a fresh default service
    against the CPU's, bit for bit, the CPU's in a pool process started
    with the bench (beside the event-width engines' host work a CPU
    solve of 512 ranks took minutes)."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from benchmarks_torch import placement_gain
    from repro_torch.core import keys, multilevel
    from repro_torch.kernels import ops
    from repro_torch.launch import placement as pl, placement_bench
    lowered, mesh = placement_bench.compile_cell(*LAUNCH_PLACE, True)
    c = pl.traffic_from_compiled(lowered, lowered.num_devices)
    m = pl.system_graph_for_mesh(mesh)
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))
    t_cpu = time.perf_counter()
    cpu = pool.submit(place_cpu_solve, os.path.join(ROOT, "src"),
                      c / c.max(), m, "psa")
    try:
        before = ops.launch_counts()
        t = time.perf_counter()
        rec = placement_bench.bench(*LAUNCH_PLACE, multi_pod=True,
                                    device=None if device == "cuda" else device)
        wall = time.perf_counter() - t
        launched = {k: v for k, v in launches_since(before).items() if v}
        for scen in ("algorithms", "fragmented"):
            for algo, a in rec[scen].items():
                require(a["cost_after"] <= a["cost_before"], f"[launchers] "
                        f"{scen} {algo}: F {a['cost_after']} above F(identity) "
                        f"{a['cost_before']}")
        pristine, frag = (rec[k]["psa"]["cost_before"]
                          for k in ("algorithms", "fragmented"))
        require(frag > pristine, f"[launchers] the fragmented allocation's "
                f"F(identity) {frag!r} is not above the pristine slice's "
                f"{pristine!r}")
        print(f"[launchers] placement_bench {' '.join(LAUNCH_PLACE)} on "
              f"{rec['num_devices']} ranks: lowering {rec['lower_s']} s, C "
              f"{rec['traffic_nonzero']} nonzeros, "
              f"{rec['traffic_total_bytes']!r} bytes; "
              + "; ".join(f"{scen} {algo}: F(identity) {a['cost_before']!r}, F "
                          f"{a['cost_after']!r}, gain {a['gain']:.6f}, "
                          f"{a['seconds']} s"
                          for scen in ("algorithms", "fragmented")
                          for algo, a in rec[scen].items())
              + f"; bench wall {wall:.1f} s, launches {launched}; card {card}",
              flush=True)
        with tempfile.TemporaryDirectory() as art:
            with open(os.path.join(art, "{}.{}.multi.json".format(
                    *LAUNCH_PLACE)), "w") as f:
                json.dump(rec, f)
            saved, placement_gain.ART = placement_gain.ART, art
            try:
                rows = placement_gain.run()
            finally:
                placement_gain.ART = saved
        want = [f"placement.{LAUNCH_PLACE[0]}.{LAUNCH_PLACE[1]}.{label}.{algo}"
                for label in ("pristine", "frag") for algo in ("psa", "pga", "pca")]
        require([r.split(",")[0] for r in rows] == want,
                f"[launchers] placement_gain rows {rows}")
        print(f"[launchers] placement_gain.run(): {rows}", flush=True)

        # the engine's own multilevel solve of the fragmented instance (order
        # 512 takes the multilevel route, seed 0), before its rule that an
        # answer worse than the as-allocated order returns that order
        t = time.perf_counter()
        ml = multilevel.solve_multilevel(
            c, placement_bench._fragmented_system_graph(lowered.num_devices),
            keys.prng_key(0, device), multilevel.MultilevelConfig(),
            device=device)
        print(f"[launchers] the multilevel route on the fragmented allocation "
              f"alone: F {ml.objective!r} against F(identity) {frag!r} "
              f"({time.perf_counter() - t:.2f} s)", flush=True)
        pl.reset_default_service()
        service = pl.default_service() if device == "cuda" else \
            pl.PlacementService(device=device)
        unit = solve_job_placement(service, c / c.max(), m, "psa", device,
                                   "512 ranks, torus, psa, C / max(C)",
                                   tag="launchers")
        pl.reset_default_service()
        got = cpu.result()
        cpu_wall = time.perf_counter() - t_cpu
    finally:
        pool.shutdown()
    require(unit == got, f"[launchers] 512 ranks C / max(C): card "
            f"{unit[1:]} != cpu {got[1:]}")
    print(f"[launchers] 512 ranks C / max(C): card == cpu (the CPU's solve "
          f"{cpu_wall:.1f} s in a pool process, beside the card's)",
          flush=True)


def drive_launchers(card, device="cuda"):
    """The seventeenth route: the launchers that lower production cells,
    and ``event_width``.  Returns the route's launch counts."""
    from repro_torch.kernels import ops
    t_route = time.perf_counter()
    before = ops.launch_counts()
    launch_dryrun(card, device)
    launch_event_width(card, device)
    launch_placement(card, device)
    counts = launches_since(before)
    for kernel in ("qap_delta", "qap_objective_sparse", "qap_delta_sparse"):
        require(counts[kernel] > 0 or device == "cpu", f"[launchers] the "
                f"route launched no {kernel}")
    print(f"[launchers] route launches "
          f"{({k: v for k, v in counts.items() if v})}; route wall "
          f"{time.perf_counter() - t_route:.1f} s; card {card}", flush=True)
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import build

    t = t_script = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t:.2f} s", flush=True)
    for name, log in build.build_log().items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"nvcc {name}: {line.strip()}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    t_start = time.perf_counter()

    def phase_done(name):
        print(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    ctx_bytes = context_bytes()
    pool, cpu = start_cpu_checks()
    device = torch.device("cuda")
    delta = check_qap_delta(device)
    sa = check_qap_sa_step(device)
    sa_round = check_qap_sa_round(device)
    obj = check_qap_objective(device)
    ga = check_qap_ga_step(device)
    dsp = check_qap_delta_sparse(device)
    osp = check_qap_objective_sparse(device)
    scan = check_selective_scan(device)
    check_paper_kernels(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_done("kernel checks")

    runs, dense = {}, {}
    for route in ROUTES:
        reqs, resps, counts, walls = drive_engine(route)
        runs[route], dense[route] = counts, (resps, walls)
        check_against_cpu(route, resps, cpu[route].result())
    for route, kernel in (("psa-event", "qap_delta"), ("psa-fused", "qap_sa_step"),
                          ("psa-fused", "qap_delta"), ("pga-wide", "qap_objective"),
                          ("pga-wide", "qap_delta"), ("pga-fused", "qap_ga_step"),
                          ("pca", "qap_objective"), ("pca", "qap_delta")):
        require(runs[route][kernel] > 0, f"{route} launched no {kernel}")
    phase_done("dense routes")
    ml_resps, runs["multilevel"] = drive_multilevel()
    check_against_cpu("multilevel", ml_resps, cpu["multilevel"].result())
    phase_done("multilevel")
    runs["exact-size"] = drive_exact_size(cpu["exact-size"].result())
    phase_done("exact-size")
    runs["rm-replay"] = drive_rm_replay(ctx_bytes, cpu["rm-replay"].result(),
                                        cpu["rm-placement"].result())
    pool.shutdown()
    phase_done("rm-replay")
    runs["lm-serve"] = drive_lm_serve()
    check_lm_against_cpu()
    phase_done("lm-serve")
    runs["lm-families"] = drive_lm_families()
    phase_done("lm-families")
    runs["paper"] = drive_paper()
    phase_done("paper")
    runs["mesh"] = drive_mesh(dense)
    phase_done("mesh")
    runs["train"] = drive_train(card)
    phase_done("train")
    runs["placement"], one_device_losses = drive_placement(card)
    phase_done("placement")
    runs["tensor-parallel"] = drive_tensor_parallel(card, one_device_losses)
    phase_done("tensor-parallel")
    runs["expert-parallel"] = drive_expert_parallel()
    phase_done("expert-parallel")
    runs["serve-parallel"] = drive_serve_parallel(card)
    phase_done("serve-parallel")
    runs["launchers"] = drive_launchers(card)
    phase_done("launchers")
    print(f"[time] script wall {time.perf_counter() - t_script:.1f} s, the "
          f"build included", flush=True)

    d = delta[("event", "batched")]
    o = obj[("generation", "smem", "batched", BUCKET)]
    kernels = [
        dict(name="qap_delta", route="cuda",
             source="src/repro_torch/csrc/qap_delta.cu",
             replaces="src/repro/kernels/qap_delta.py:95",
             launches=runs["psa-event"]["qap_delta"], max_abs_err=max(
                 v["err"] for v in delta.values()),
             ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
             bound_by=d["bound_by"], library_ms=None),
        dict(name="qap_sa_step", route="cuda",
             source="src/repro_torch/csrc/qap_sa_step.cu",
             replaces="src/repro/kernels/qap_sa_step.py:122",
             # the route's launches are rounds: a round's numbers beside them
             launches=runs["psa-fused"]["qap_sa_step"],
             max_abs_err=max(sa["err"], sa_round["err"]),
             **{k: sa_round[k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
        dict(name="qap_objective", route="cuda",
             source="src/repro_torch/csrc/qap_objective.cu",
             replaces="src/repro/kernels/qap_objective.py:65",
             launches=runs["pga-wide"]["qap_objective"], max_abs_err=max(
                 v["err"] for v in obj.values()),
             ms=o["ms"], plain_ms=o["plain_ms"], bound_ms=o["bound_ms"],
             bound_by=o["bound_by"], library_ms=None),
        dict(name="qap_ga_step", route="cuda",
             source="src/repro_torch/csrc/qap_ga_step.cu",
             replaces="src/repro/kernels/qap_ga_step.py:134",
             launches=runs["pga-fused"]["qap_ga_step"], max_abs_err=ga["err"],
             ms=ga["ms"], plain_ms=ga["plain_ms"], bound_ms=ga["bound_ms"],
             bound_by=ga["bound_by"], library_ms=None),
        dict(name="qap_objective_sparse", route="cuda",
             source="src/repro_torch/csrc/qap_objective_sparse.cu",
             replaces="src/repro/kernels/qap_sparse.py:78",
             launches=runs["multilevel"]["qap_objective_sparse"],
             max_abs_err=max(v["err"] for v in osp.values()),
             **{k: osp[(4096, 1, ML_CHAINS, "batched")][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
        dict(name="qap_delta_sparse", route="cuda",
             source="src/repro_torch/csrc/qap_delta_sparse.cu",
             replaces="src/repro/kernels/qap_sparse.py:192",
             launches=runs["multilevel"]["qap_delta_sparse"],
             max_abs_err=max(v["err"] for v in dsp.values()),
             **{k: dsp[("finest", "refine", "batched")][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
        dict(name="selective_scan", route="cuda",
             source="src/repro_torch/csrc/selective_scan.cu",
             replaces="src/repro/kernels/selective_scan.py:73",
             launches=runs["lm-serve"]["selective_scan"],
             max_abs_err=max(v["err"] for v in scan.values()),
             **{k: scan["full"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) if it fails:

1. build every kernel of the serving path from the checkout: the four
   CUDA sources in ``src/repro_torch/csrc`` (one ``nvcc`` each, all at
   once, linked into one library under ``build/kernels/``);
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (tolerances below), and the attention kernels also
   at smollm's context (prefill S=1024 and 2048, decode Smax=2048); time
   kernel, plain version and the nearest single PyTorch call; print each
   attention launch's geometry (flash: the instance, its M tiles, work
   items, persistent blocks and sample groups; decode's blocks per (kv
   head, sample), grid, CUDA launches a call, ring stages) and, at the
   headline shapes, each attention kernel's time over the library call's;
   print each ssd_scan case's geometry (the instance; state columns a
   block, grid, blocks per SM, waves; the chunked instance's launches and
   workspace) and its time over its bound, and hold it at hymba's rung
   2048 and exact prompt also on planted inputs (``_scan_planted``: slow
   gates and a v column planted per chunk, so that every chunk shows in
   the final state and the later chunks' y), where each of the scan
   probe's emulated faults must fail the check; time decode attention at
   every split it takes at smollm's, hymba's ring, dbrx's, seamless's,
   decode_32k and long_500k shapes (``decode_sweep``); hold every decode
   case and sweep launch also on planted keys (``_planted_check``: a key
   every head scores far above the rest at each slice's first and last
   position, so each block's share moves the output by several
   tolerances, where N(0, 1) inputs give outputs below the tolerance at
   long caches), and there require each of ``probe.faults``'s outputs (a
   lost slice, a lost first or last tile, zeros) to fail the check; the
   same for the
   scenario model's shapes (head_dim 16: flash at S up to 64, ragged; decode at
   Smax=64; RMSNorm at d=64) and for hymba's (RMSNorm at d=1600; decode
   at G=5 on a 2048-slot ring and a 3200-slot cache; flash at 25 / 5
   heads on a ragged rung-2048 batch and on a 3072-token prompt with
   window 2048; ssd_scan at dk=16 dv=64 H=25) and for the full-width LM
   cascade's (decode at Smax=64, one block per (kv head, sample); flash
   at rung 8 with 2 and 4 prompts), and for phases 10-12's
   (``FAMILY_CASES``: flash non-causal and at G = 7 and G = 6 with D =
   128, decode at G = 1, 7 and 6, RMSNorm at d = 1024, 896 and 6144),
   appended to each kernel's cases; RMSNorm also on its scalar path (d =
   1001, and rows not 16-byte aligned), each case's launch geometry
   printed; the launch floor (an empty kernel of one block, with and
   without programmatic dependent launch, PDL) beside the RMSNorm cases;
   RMSNorm through its C entry point at every rows-a-block choice, with
   and without PDL, and after a GEMM (``rmsnorm_sweep``); 20 PDL launches
   after a ``torch.matmul`` captured in one CUDA graph, its programmatic
   edges counted and its replay equal to the eager run bit for bit; the
   host's split of one eager RMSNorm call (wrapper Python, allocation,
   stream lookup, the launch call) and of one eager flash call on its
   wgmma instance (the same, and the two TMA tensor maps' encode inside
   the launch call); decode and flash at phase 16e-j's
   tensor-parallel rank shapes (``TP_CASES``: smollm's 4 / 1 and 8 / 1
   heads of 64, hymba's 7 / 1 and 13 / 1 (G = 13, in one block),
   seamless's 4 / 4), ``ssd_scan`` at hymba's ranks' 7 and 13 heads;
2b. the Clipper frontend stack: every named scenario with its selection
   state on the card and on the CPU, reports equal byte for byte (wall ms
   of each, policy-state device-to-host copies per query); a 1,048,576 x 4
   fp32 contextual store on the card against one on the CPU under the same
   batched Exp4 and Exp3 feedback (4,096 users a batch, with repeats),
   within 1e-6 (ms per batch); the poisson scenario's lmserver stack
   through ``ScenarioRunner`` on the card (counts set to 0 just before, each
   rising; the decode step replayed from its CUDA graph), its report equal
   to the CPU run's but ``engine.attention_backend``,
   ``engine.decode.graph`` and ``engine.prefill.graph`` (true where a
   ladder prefill replayed from its graph); then full-width smollm-360m through the same
   runner (``build_lmserver(cfg=)``), the fields of its report that differ
   from the reduced run's listed;
2c. model composition and the control plane: the ``cascade`` and
   ``fanout`` pipelines with their Exp4 state on the card and on the CPU,
   reports and span logs equal byte for byte (wall ms, state copies per
   pipeline query); ``repro_torch.cluster.run``'s ``main`` on the
   flash-crowd scenario (seed 0), card against CPU: the frontend and
   pipeline stacks and a crash fault with and without recovery write the
   same report, span log, time series and audit doc, and the lmserver stack
   with shedding admission runs the kernels (counts set to 0 just before,
   each rising), its report equal to the CPU's but the engine fields; the
   reduced ``lmcascade`` (two ``LMServer`` tiers on one card, each with its
   own captured decode graph) against the CPU: the same comparison for
   both tiers' sections, each request's tier, each tier's greedy streams
   (equal up to the first step whose two best CPU logits lie within one
   bf16 ulp, where the card may pick the other token), and the launches
   adding up across both tiers' graphs; then the cascade at full width (smollm-360m,
   seeded random weights, bf16, in both tiers): both tiers replay their own
   graphs, the three counts set to 0 just before rise, every token lies in
   the vocabulary; per tier the requests served, escalations, ms per
   graphed decode step and tokens/s;
3. serve full-width smollm-360m (32 layers, seeded random weights, bf16)
   through ``LMServer``: 16 requests, slots=8, max_len=256, prompts of 8-200
   tokens, 32 new tokens each, greedy; the fused decode step runs eagerly
   once and then replays from its CUDA graph (checked); the launch counts
   are set to 0 just before and read just after, and each of its kernels'
   counts must rise;
4. with every slot busy: the host's split of one eager decode step
   (``torch.profiler``'s CPU events: Python and wrapper checks, aten
   dispatch, launch calls), then a B=8 prefill and four decode steps, eager
   and replayed from the graph, traced: device operations and device busy
   time per prefill and per decode step; ms per decode step, eager against
   graph, in turns over the same steps (whose tokens must agree);
5. streams in calibrated-simulation mode: the graphed step against the
   eager one, greedy and at temperature 0.8 (seed 0), equal bit for bit;
   ``fused=False`` (the reference per-slot loop) against the fused step,
   equal, with 1 + active slots host syncs per step;
6. compare the card's prefill logits and 8 teacher-forced decode steps with
   the same model on the CPU's plain path;
7. run ``examples/quickstart_torch.py``'s ``main()`` on the card (full-width
   smollm-360m, temperature 0.8): counts set to 0 before, and rising;
8. phases 3-6 for full-width xlstm-125m (6 mLSTM/sLSTM pairs, d_model 768,
   4 heads of 384, fp32 gates): 16 requests, slots=8, max_len=512, prompts
   of 8-480 tokens, 32 new tokens, greedy, with the ssd_scan and rmsnorm
   counts rising; prefill time per rung; the profile and timings; graph
   against eager streams; logits and every decode-state leaf against the
   CPU's plain path;
9. phases 3-6 for full-width hymba-1.5b (32 layers: 3 global, 29 with a
   2048-token window and ring caches; parallel attention and SSD heads,
   25 / 5 heads of 64, ssm_state 16): 16 requests of 8-2040 tokens plus
   one of 2035 (its rings wrap while it decodes) and one of 3072 (the
   exact path: the window binds in flash, the rings are laid out by roll),
   slots=8, max_len=3200, 32 new tokens, greedy, all four counts rising;
   prefill time at rungs 8, 256, 2048 (B=8) and the exact 3072 (B=1); the
   profile and timings; graph against eager streams and ``fused=False``
   against fused; logits and every conv and SSD state leaf against the
   CPU's plain path, at full width on a short batch and, cut to 2 layers
   (one global, one sliding-window), on the exact 3072-token prompt;
10. the encoder-decoder path, full-width seamless-m4t-medium (12 + 12
   layers, 16 / 16 heads of 64): ``model.prefill`` over seeded fp32 frames
   [8, 1024, 1024] and decoder prompts of 8-128 tokens on the ladder ->
   ``batched_scatter`` into 8 slots of max_len 1024 -> the fused decode
   step, eager once, then captured and replayed (32 steps; the counts set
   to 0 just before the prefill, each rising); the same steps eager, the
   streams equal; again with frames of 512 rows (the memory padded into
   the 1024-row slot cache, its zero rows checked); the profile, eager
   against graphed ms per step in turns, prefill ms per decoder rung; card
   against the CPU's plain path on 64 frames;
11. the vision-prefixed path, full-width internvl2-1b (24 layers, 14 / 2
   heads of 64): phases 3-6 on text through ``LMServer`` (as the
   reference serves it; max_len 256), then 1024 seeded prefix rows + 1024
   text tokens, B=4 (S=2048) -> slots of max_len 2112 -> the graphed fused
   step as in 10; card against the CPU on text and with 64 prefix rows;
12. the mixture-of-experts path, dbrx-132b at full width (d_model 6144,
   48 / 8 heads of 128, 16 experts top-4) cut to 4 of its 40 layers:
   phases 3-6 through ``LMServer`` with prompts of 32-256 tokens in
   same-length groups (no ladder), max_len 512, with ``fused=False``
   against fused; card against the CPU cut to 1 layer (2 prompts of 16
   tokens, 4 decode steps; the card routes by its own router, whose
   expert choices may differ from the CPU's only at a router near-tie,
   ``ROUTER_NEAR``, where it then takes the CPU's; on the CPU's input its
   router weights agree within ``ROUTER_P_TOL``); the attention kernels and RMSNorm
   are also held against their plain versions at these three families'
   shapes in phase 2;
13. training (every serving phase above runs under ``torch.no_grad()``,
   this one with autograd on): full-width smollm-360m (32 layers, random
   weights from a seed) through ``repro_torch.launch.train``'s code path at
   the reference launcher's defaults (batch 32, seq 256, 2 microbatches,
   AdamW, lr 1e-3, remat ``"full"``) for 12 steps: ms per step (median of
   steps 5-12 and its spread), tokens/s, model FLOP/s (6 N tokens / time)
   against 989 TFLOP/s with the remat recompute apart, peak memory, the
   loss at steps 1, 6 and 12 (it must fall), one traced step's device
   busy time; then 6 steps with a checkpoint at 6 and a fresh ``train``
   resumed from it to 12, equal bit for bit to the uninterrupted run (all
   under deterministic algorithms); no kernel launches in any training
   step. ``python -m repro_torch.launch.train --reduced`` for 20 steps.
   One training step (``loss_fn``, backward, AdamW) per family, card
   against the CPU's plain path on the same weights and batch: smollm-360m
   cut to 2 layers, xlstm-125m, hymba-1.5b cut to 2 layers (one global,
   one windowed), seamless-m4t-medium cut to 2 + 2 layers, internvl2-1b
   cut to 2 layers with its 1024 prefix rows, all at full width, and
   dbrx-132b at ``reduced_config`` width (``LOSS_TOL``, ``GRAD_ROUNDINGS``,
   ``OPT_RTOL``);
14. the launch tooling (``repro_torch.launch``): the dry run of the
   reference's 32 arch x shape cells at full width on the meta device,
   three sweeps of ``python -m repro_torch.launch.dryrun`` started side
   by side in the background at the top of the run, the card hidden from
   them: ``--mesh one`` (one device), ``--mesh single`` (one counting
   rank of 16 x 16) and ``--mesh multi`` (of 2 x 16 x 16), 96 records,
   failing unless all three exit 0 with every record ``ok``; one table
   row per cell on one device (arguments and peak GB, fits one 80 GB
   card, dot TFLOP, the roofline terms), a second table with one row per
   (cell, mesh) for a rank (arguments and arguments + temp GB, fits one
   80 GB card, collective wire GB by op, T_compute, T_memory and T_coll
   ms, the dominant term, the fraction) and a line naming the cells
   whose rank does not fit one card; flash at S=32,768 against
   SDPA (the plain version would need a 64 GB score tensor), on N(0, 1)
   inputs and on planted keys whose emulated lost tiles must fail the
   check; then four of
   the reference's cells through ``launch.steps.build_step`` at full width
   (``LAUNCH_CELLS``: hymba-1.5b x long_500k at its full shape, smollm-360m
   x decode_32k cut to 32 slots, x prefill_32k at 32 prompts if they fit,
   x train_4k cut to 16 sequences): ms per step and tokens/s, peak memory
   within ``PEAK_SLACK`` of the dry run's estimate of the same shape, the
   card's ``hlo_stats`` count equal to the meta count, the roofline
   fraction at most ``FRACTION_LIMIT``, the kernels' launches rising in
   the serving cells and none in training; phase 2 holds decode attention
   at Smax 32,768 and 524,288 and flash at S=8,192 against their plain
   versions first (``LONG_CASES``; flash also on planted keys,
   ``_flash_planted``);
15. the four example twins, ``examples/*_torch.py``, each through its
   ``main(["--device", "cuda"])`` (the kernels' counts set to 0 just before
   and read just after: this path runs none of them) and again on the CPU;
   each card run allocates on the card, each CPU run does not: the cascade
   pipeline and the flash crowd print the CPU's output byte for byte; the
   ensemble's error counts agree within ``ENSEMBLE_ERR_QUERIES`` of 400,
   its Exp4 weights within ``ENSEMBLE_WEIGHT_RTOL`` of themselves, its
   other lines byte for byte, and its five trained predictors answer on
   the card; the adaptive batching demo's three AIMD lines as measured on
   the card; then the Fig 3 spectrum's latency profile on the card (the
   five predictors of ``examples/common_torch.py``, ``time_batch`` at
   ``PROFILE_SIZES``, ``fit_linear_latency``'s base and per-item time and
   the batch its fit puts at the 20 ms SLO), beside the card's name and
   power limit;
16. the sharded paths on ``torch.distributed`` (``sharded_phases``): 16a
   an NCCL world of one rank (mesh (1, 1)) serving dbrx-132b cut to 4
   layers through the sharded code path and ``LMServer`` (calibrated
   simulation, greedy), its decode step captured with the collectives
   inside, the streams equal to the unsharded server's bit for bit; then
   ``SHARD_RANKS`` gloo ranks sharing the card (``launch.mesh.run_ranks``,
   spawned after phase 1 built the kernels; the one-device weights handed
   over as CUDA handles, each rank taking views of its experts): 16b the
   same dbrx ``ep`` over (1, 4), 4 experts a rank, routed as the
   one-device card run's recorded router calls route (other expert sets
   only at a router near-tie, as in 12), prefill logits within
   ``SHARDED_LOGIT_TOL`` of the one-device card run's (and with the
   expert sum broken, as a negative control, ``FAULT_MARGIN`` times
   beyond it) and greedy streams
   equal across ranks and to the one device's but where the ranks' own
   logits row at the parting step lies within ``SHARDED_LOGIT_TOL`` of
   the one device's, an eager ms a step and the collective bytes a step
   (host-staged collectives on one card, not a multi-card figure); 16c
   smollm-360m (heads padded for 4 ranks) prefilling a 2048-token prompt
   context-parallel, 512 rows a rank, logits and cache bit-equal to the
   one-device prefill; 16d the pod-compressed training step of
   smollm-360m cut to ``POD_LAYERS`` layers on (pod 2, data 2), its
   gradients within ``POD_QUANTA`` of the one-device step's and only int8
   payloads and fp32 scalars crossing ``pod``, a step timed; 16e
   full-width smollm-360m at ``padded(4)`` dense tensor parallel over (1,
   4) (attention, FFN, embedding and head split over ``model``): prefill
   logits within ``TP_ROUNDINGS`` of the one device's or, past that, at
   most ``ANCHOR_RATIO`` times as far from an fp32 prefill on the CPU,
   a rank's weights a quarter of the split leaves and the norms, greedy
   streams and engine report the one device's (a stream may part only at
   a one-ulp tie of its logits), eager ms a step and the collectives a
   step by op, axes and dtype; 16f the same server at ``padded(2)`` over
   (data 2, model 2), 4 slots a data row, against the one device's; 16g
   smollm-360m cut to ``POD_LAYERS`` layers on (data 2, model 2) under
   ``train_rules`` (dense TP, ``fsdp`` over data): gradients within
   ``SHARD_GRAD_ROUNDINGS``, AdamW and Adafactor on the one device's
   gradients within ``OPT_RTOL`` of its update, a step of each timed;
   16h full-width hymba-1.5b (32 layers) at ``padded(4)`` head parallel
   over (1, 4) (x_r ‖ z_r and B_r ‖ C_r a rank) served through
   ``LMServer``, 8 requests of 32-128 tokens: prefill logits within
   ``LOGIT_TOL`` of the one device's and at most ``ANCHOR_RATIO`` times
   as far from an fp32 CPU prefill, a rank's bytes its share, greedy
   streams and report the one device's (partings only where the ranks'
   row explains them); 16i hymba cut to 4 layers at ``padded(2)`` (G =
   13) over (data 2, model 2) with ``fsdp`` over data, the data rows
   prefilling together; 16j seamless-m4t-medium (12 + 12 layers) at
   ``padded(4)`` over (1, 4), a prefill of 8 x 128 tokens over 8 x 1024
   frames and 8 decode steps fed the one device's tokens, each step's
   logits within ``LOGIT_TOL``; 16k one ``train_rules`` step of
   xlstm-125m and of the hymba cut on (data 2, model 2), gradients under
   16g's rule; 16l smollm-360m at ``padded(2)`` on (data 2, model 2)
   through ``launch.steps.build_step``, a decode step at full width (B 8,
   Smax 1024, the kernels on) and a ``train_rules`` step cut to
   ``POD_LAYERS`` layers (B 8 x 256), each counted by ``hlo_stats.count``
   as it runs on every rank and as the counting rank at the rank's
   coordinates counts it on meta (``launch.mesh.make_rank_mesh``): equal
   dot FLOPs by dtype, kernel work by kernel, and collective calls and
   payload bytes by op, axes and dtype (memory is not compared: gloo's
   host staging copies are ops of their own), decode attention and
   RMSNorm launched, seconds a rank; the kernels' launches (counts set to 0 before each path,
   read after, the ranks' summed) are the ``"sharded"`` path; phase 2
   holds flash at the context-parallel shapes first (``CP_CASES``);
17. print the figures, the card's name and power limit, one ``kernels`` JSON
   line, and as the last line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits nonzero before printing anything. It imports
``torch`` and ``repro_torch`` only."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BF16_ULP = 2.0 ** -7
SMS = 132                        # H100 SXM streaming multiprocessors

# tolerances, kernel vs plain version on the same card inputs: the kernels
# sum in other orders (rmsnorm); decode attention rounds the unnormalised p
# to bf16 for P V where the plain version rounds the normalised p, flash
# attention rescales per 64-key tile and sums P V in fp32 across tiles where
# the plain version rounds each key block's P V to bf16: one bf16 rounding
# of the value for rmsnorm and three bf16 roundings of 1 for attention
# outputs (averages of N(0, 1) values)
TOL = {"rmsnorm": (BF16_ULP, 1e-5),
       "decode_attention": (BF16_ULP, 3 * BF16_ULP),
       "flash_attention": (BF16_ULP, 3 * BF16_ULP)}
# ssd_scan: kernel and plain version sum fp32 products of up to dk (q . k,
# q . S) or a chunk (P v, k^T v) terms in other orders, so y (bf16) to one
# bf16 rounding plus SCAN_ATOL of its largest magnitude, the fp32 state to
# rtol 2e-5 plus SCAN_ATOL of its largest magnitude
SCAN_ATOL = 2e-5
# card vs CPU plain path, full model: 32 layers (smollm, hymba) or 6 pairs
# (xlstm) of bf16 rounding in other orders (cuBLAS and the kernels vs CPU
# GEMMs and the plain versions); the logits, and each recurrent-state leaf,
# may differ by this share of their largest magnitude: about twice the
# largest difference seen on an H100 (smollm logits 2.2 %; xlstm logits
# 0.63 %, state leaves 0.73 %). hymba's gap is bf16 rounding that the
# model amplifies layer by layer on both devices alike: the card and the
# CPU's bf16 path each sit up to 5.8 % (logits) and 5.6 % (state leaves)
# from an fp32 run of the same weights, and turning off cuBLAS's bf16
# reduction changes no bit (scripts/hymba_drift.py); so its limits are the
# sum of the two distances, rounded up (seen: logits 5.6 %, leaves 7.0 %;
# "hymba-1.5b long", the 2-layer cut that takes the exact 3072-token
# prompt: logits 0.67 %, leaves 1.2 %, about twice these)
LOGIT_TOL = {"smollm-360m": 0.05, "xlstm-125m": 0.015,
             "hymba-1.5b": 0.12, "hymba-1.5b long": 0.015}
STATE_TOL = {"xlstm-125m": 0.015, "hymba-1.5b": 0.12,
             "hymba-1.5b long": 0.025}
# so for hymba an fp32 run anchors the check as well: the card may be at
# most this many times as far from it as the CPU's bf16 path, logits and
# each state leaf (seen: 1.21 at full width, 1.11 on the 2-layer cut)
ANCHOR_RATIO = 2.0
# card vs CPU plain path, the encdec, vlm and moe families, about twice
# the largest difference seen on an H100: seamless-m4t-medium (12 + 12
# layers, 64 frames) 1.88 %, internvl2-1b (24 layers) 1.99 % on text and
# 2.12 % with 64 prefix rows, dbrx-132b cut to one layer 0.64 % (decode
# steps)
LOGIT_TOL.update({"seamless-m4t-medium": 0.04, "internvl2-1b": 0.04,
                  "internvl2-1b prefixed": 0.045, "dbrx-132b 1 layer": 0.015})
# a moe token may be routed otherwise on the card than on the CPU only
# where the CPU's k-th and (k+1)-th router probabilities lie closer than
# this: the router's bf16 input differs between the devices by a rounding
# here and there, which moves a probability by far less
ROUTER_NEAR = 2.0 ** -8
# the router on the card against the CPU's on the same input: each top-k
# weight within this share of the row's largest sum_i |x_i w_ie|. Summing a
# d-long fp32 product in another order moves a logit by about 2**-25 of
# that sum; TF32 inputs (10-bit mantissas) would move it by about 2**-17
ROUTER_P_TOL = 2.0 ** -20
# card vs CPU plain path, the LM cascade's reduced smollm (2 layers,
# d_model 64, head_dim 16, bf16) at the steps whose inputs the two devices
# share: logits within this share of the CPU row's largest |logit|, about
# twice the largest difference seen on an H100 (1.35 %); a greedy stream
# may part from the CPU's where its two best logits lie closer than that
# (seen: 2 of 43 streams, each at a gap of 2 bf16 ulps)
CASCADE_LOGIT_TOL = 0.03

REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:24",
    "decode_attention": "src/repro/kernels/decode_attention/decode_attention.py:71",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:76",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:58",
}
SOURCES = {
    "rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu"),
    "ssd_scan": ("cuda", "src/repro_torch/csrc/ssd_scan.cu"),
}
# the case of each kernel that stands in the kernels line (its serving shape)
HEADLINE = {"rmsnorm": 2, "decode_attention": 0, "flash_attention": 5,
            "ssd_scan": 4}


def log(*a):
    print(*a, flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device):
    """A nested dict of tensors, each moved by ``.to(device)`` (a device,
    or a dtype)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _rel_err(got, want):
    """max |got - want| / max |want|, fp32."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _hymba_state(cache):
    """The recurrent-state leaves of a hymba cache (conv inputs and SSD
    states of the global and the sliding-window layers), named."""
    return {k: cache[k] for k in ("conv_g", "ssd_g", "conv_w", "ssd_w")}


def _xlstm_state(cache):
    """The decode-state leaves of an xlstm cache, named."""
    names = ("mlstm_S", "mlstm_n", "slstm_c", "slstm_n", "slstm_h", "slstm_m")
    return dict(zip(names, [cache["m"][0], cache["m"][1], *cache["s"]],
                    strict=True))


def cuda_ms(fn, reps=50, warmup=5):
    """Mean time of ``fn()`` over ``reps`` back-to-back eager calls (CUDA
    events): the device time, or the host's launch time where the host
    cannot keep the device busy."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, replays=5):
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so host launch
    cost drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def check(name, got, want, case):
    import torch
    rtol, atol = TOL[name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name} {case}: non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bad.any():
        raise AssertionError(
            f"{name} {case}: {int(bad.sum())} elements beyond rtol={rtol} "
            f"atol={atol}; max_abs_err={float(err.max())}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def timings(kernel, plain, library=None):
    """Device times (CUDA graph replay) of the kernel's wrapper, its plain
    version and the library call, plus the kernel's eager time."""
    return dict(ms=graph_ms(kernel), eager_ms=cuda_ms(kernel),
                plain_ms=graph_ms(plain, reps=5),
                library_ms=None if library is None else graph_ms(library))


def sdpa(q, k, v, mask):
    """The one PyTorch call computing masked GQA attention (model layout
    in, heads-major views to SDPA), or None where this torch lacks
    ``enable_gqa``."""
    import torch.nn.functional as F
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    try:
        call()
    except TypeError:
        return None
    return call


def _rmsnorm_case(dev, randn, n, d, residual, offset=0):
    """RMSNorm at N rows of d against its plain version, timed; with
    ``offset`` the rows (x and the residual) start that many bf16 values
    into a buffer, so they are not 16-byte aligned."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_op, rmsnorm_work
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import geometry
    from repro_torch.launch.roofline import kernel_bound

    def rows():
        return randn((n * d + offset,))[offset:].view(n, d)
    x, w = rows(), randn((d,), 0.25) + 1
    r = rows() if residual else None
    got = rmsnorm_op(x, w, residual=r)
    want = rmsnorm_ref(x, w, residual=r)
    pairs = zip(got, want) if residual else [(got, want)]
    case = (f"N={n} d={d} residual={residual}"
            + (f" rows offset by {offset} values" if offset else ""))
    err = max(check("rmsnorm", g, e, case) for g, e in pairs)
    lib = None
    if not residual and hasattr(F, "rms_norm"):
        lib = lambda: F.rms_norm(x, (d,), w, 1e-5)  # noqa: E731
    return dict(case=case, max_abs_err=err,
                geometry=geometry(n, d, offset % 8 == 0)._asdict(),
                bound=kernel_bound(rmsnorm_work(n, d, residual=residual)),
                **timings(lambda: rmsnorm_op(x, w, residual=r),
                          lambda: rmsnorm_ref(x, w, residual=r), lib))


def _decode_case(dev, randn, B, Hq, Hkv, D, Smax, window, lengths):
    import torch
    from repro_torch.kernels.decode_attention.decode_attention import (
        geometry)
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_op, decode_attention_work)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.launch.roofline import kernel_bound

    q = randn((B, 1, Hq, D))
    k, v = randn((B, Smax, Hkv, D)), randn((B, Smax, Hkv, D))
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = decode_attention_op(q, k, v, ln, window=window)
    want = decode_attention_ref(q, k, v, ln, window=window)
    case = f"B={B} Hq={Hq} Hkv={Hkv} D={D} Smax={Smax} window={window}"
    err = check("decode_attention", got, want, case)
    planted = _planted_check(
        dev, B, Hq, Hkv, D, Smax, window, lengths, case,
        lambda q, k, v, ln: decode_attention_op(q, k, v, ln, window=window))
    pos = torch.arange(Smax, device=dev)
    lo = (ln - window).clamp_min(0) if window else torch.zeros_like(ln)
    mask = ((pos[None] < ln[:, None])
            & (pos[None] >= lo[:, None]))[:, None, None, :]
    return dict(
        case=case, max_abs_err=err, planted=planted,
        geometry=_decode_geometry(geometry(B, Hkv, Hq // Hkv, D, Smax,
                                           window)),
        bound=kernel_bound(decode_attention_work(
            B, Hq, Hkv, D, Smax, window=window, lengths=lengths)),
        **timings(lambda: decode_attention_op(q, k, v, ln, window=window),
                  lambda: decode_attention_ref(q, k, v, ln, window=window),
                  sdpa(q, k, v, mask)))


def _planted_check(dev, B, Hq, Hkv, D, Smax, window, lengths, case, launch,
                   p=None):
    """decode attention on ``probe.planted`` inputs (a key every head
    scores far above the rest at the first and last position of each of the
    ``p`` slices, None: the wrapper's split), where each slice moves the
    output by several tolerances, held against the plain version; then
    every ``probe.faults`` output (a lost slice, a lost first or last tile,
    zeros) must fail that same check. ``launch(q, k, v, lengths)`` returns
    [B, 1, Hq, D]."""
    import torch
    from repro_torch.kernels.decode_attention import probe
    from repro_torch.kernels.decode_attention.decode_attention import splits
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    p = splits(B, Hkv, D, Smax, window) if p is None else p
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v, ln = probe.planted(gen, B, Hq, Hkv, D, Smax, window, lengths,
                                p, dev)
    want = decode_attention_ref(q, k, v, ln, window=window)
    err = check("decode_attention", launch(q, k, v, ln), want,
                f"{case} P={p}, planted keys")
    caught = []
    for name, bad in probe.faults(q, k, v, ln, window, p):
        try:
            check("decode_attention", bad, want, name)
        except AssertionError:
            caught.append(name)
            continue
        raise AssertionError(f"decode_attention {case} P={p}, planted keys: "
                             f"the fault '{name}' passes the check")
    return dict(max_abs_err=err, largest=float(want.float().abs().max()),
                faults_caught=len(caught))


def _decode_geometry(g):
    merge = ("one cluster, merged in distributed shared memory" if g.cluster
             else f"workspace of {g.workspace_floats} fp32, merged by a "
                  f"second launch")
    return (f"P={g.splits} blocks per (kv head, sample), grid {g.grid} = "
            f"{g.blocks} blocks of 4 warps, {merge}; "
            f"{g.launches} CUDA launch(es) a call; ring {g.stages} x "
            f"{g.tile_bytes} B, {g.smem_bytes} B shared a block")


def _flash_geometry(g):
    if g.instance == "mma":
        return (f"mma.sync instance: {g.m_tiles} M tiles of {g.m_tile} (row, "
                f"head) pairs a (kv head, sample), {g.blocks} blocks of "
                f"{g.threads} threads, {g.k_tile}-key tiles double-buffered, "
                f"{g.smem_bytes} B shared memory")
    return (f"wgmma instance: {g.m_tiles} M tiles of {g.m_tile} (row, head) "
            f"pairs a (kv head, sample), {g.items} work items longest first "
            f"in groups of {g.group} sample(s) over {g.blocks} persistent "
            f"blocks of {g.threads} threads, a "
            f"{g.stages}-stage TMA ring of {g.k_tile}-key K and V tiles, "
            f"{g.smem_bytes} B shared memory")


def _flash_case(dev, randn, B, S, Hq, Hkv, D, lens, window=0, causal=True,
                Sk=None, q_offset=None):
    """``lens`` None: an exact prompt (no kv_valid); ``window`` > 0: each
    row attends to its last ``window`` keys; ``causal`` False: every row
    attends every key below kv_valid (an encoder; with ``Sk`` keys, a
    cross-attention of S query rows over a memory of Sk rows); ``q_offset``
    (causal, with ``Sk`` keys): the S query rows sit at absolute positions
    ``q_offset`` on, one rank's slice of a context-parallel prefill."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import geometry
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_op, flash_attention_work)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.roofline import kernel_bound

    Sk = Sk or S
    q = randn((B, S, Hq, D))
    k, v = randn((B, Sk, Hkv, D)), randn((B, Sk, Hkv, D))
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    kw = dict(window=window, kv_valid=kv, causal=causal, q_offset=q_offset)
    got = flash_attention_op(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    case = (f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} kv_valid={lens}"
            + (f" window={window}" if window else "")
            + ("" if causal else f" non-causal Sk={Sk}")
            + ("" if q_offset is None
               else f" context-parallel Sk={Sk} q_offset={q_offset}"))
    err = check("flash_attention", got, want, case)
    work = flash_attention_work(B, S, Hq, Hkv, D, Sk=Sk, causal=causal,
                                window=window, q_offset=q_offset,
                                lengths=lens, kv_valid=lens is not None)
    lens = [Sk] * B if lens is None else lens
    off = Sk - S if q_offset is None else q_offset
    pos, kpos = torch.arange(S, device=dev), torch.arange(Sk, device=dev)
    mask = torch.ones((S, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = kpos[None, :] <= pos[:, None] + off
    if window:
        mask = mask & (kpos[None, :] > pos[:, None] + off - window)
    mask = (mask[None] & (kpos[None, None, :] < torch.tensor(
        lens, device=dev)[:, None, None]))[:, None]
    return dict(
        case=case, max_abs_err=err,
        geometry=_flash_geometry(geometry(B, S, Sk, Hq, Hkv, D, causal)),
        bound=kernel_bound(work),
        **timings(lambda: flash_attention_op(q, k, v, **kw),
                  lambda: flash_attention_ref(q, k, v, **kw),
                  sdpa(q, k, v, mask)))


def _flash_planted(dev, B, S, Hq, Hkv, D, lens, window=0, causal=True,
                   Sk=None, q_offset=None, want_fn=None):
    """flash attention on ``probe.planted`` inputs (a key every head scores
    far above the rest at every 64th position, so that each key tile a
    block loads moves its rows' outputs by several tolerances), held
    against the plain version (``want_fn(q, k, v)``: another reference,
    where the plain version does not fit); then every ``probe.faults``
    output (zeros; a lost first, middle, last-before-diagonal or diagonal
    key tile of one block's rows) must fail that same check."""
    import torch
    from repro_torch.kernels.flash_attention import probe
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    Sk = Sk or S
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = probe.planted(gen, B, S, Sk, Hq, Hkv, D, dev)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    kw = dict(window=window, kv_valid=kv, causal=causal, q_offset=q_offset)
    want = (flash_attention_ref(q, k, v, **kw) if want_fn is None
            else want_fn(q, k, v))
    case = f"B={B} S={S} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D}, planted keys"
    err = check("flash_attention", flash_attention_op(q, k, v, **kw), want,
                case)
    caught = 0
    for name, bad in probe.faults(q, k, v, want, **kw):
        try:
            check("flash_attention", bad, want, name)
        except AssertionError:
            caught += 1
            continue
        raise AssertionError(f"flash_attention {case}: the fault '{name}' "
                             f"passes the check")
    if caught < 5:
        raise AssertionError(f"flash_attention {case}: {caught} faults")
    return dict(max_abs_err=err, largest=float(want.float().abs().max()),
                faults_caught=caught)


# the scenario model's shapes (reduced smollm-360m: 4 / 2 heads of 16,
# d_model 64; slots 4, max_len 64, prompts of 8): appended to each
# kernel's cases after the full-width ones
SCENARIO_CASES = {
    "rmsnorm": [(4, 64, False), (16, 64, True)],
    "decode_attention": [(4, 4, 2, 16, 64, 0, [0, 9, 33, 64])],
    "flash_attention": [(1, 8, 4, 2, 16, [8]), (2, 8, 4, 2, 16, [8, 5]),
                        (4, 64, 4, 2, 16, [64, 33, 0, 17])],
}


# the LM cascade's shapes at full width (smollm-360m in both tiers: 15 / 5
# heads of 64; slots 4, max_len 64, prompts of 8): decode at Smax 64, one
# block per (kv head, sample), at the lengths
# the cascade reaches (8-16) and at 0 and Smax; flash on the 1- and
# 2-prompt batches it prefills and on a full batch of 4
CASCADE_CASES = {
    "decode_attention": [(4, 15, 5, 64, 64, 0, [0, 9, 33, 64]),
                         (4, 15, 5, 64, 64, 0, [8, 11, 15, 16])],
    "flash_attention": [(2, 8, 15, 5, 64, [8, 8]),
                        (4, 8, 15, 5, 64, [8, 8, 8, 8])],
}


# full-width hymba-1.5b's shapes (25 / 5 heads of 64, d_model 1600, window
# 2048, slots 8, max_len 3200): RMSNorm on decode rows and on a rung-2048
# prefill batch with the residual in front; decode against a 2048-slot
# ring (counts min(len + 1, 2048), lengths past the window) and against a
# 3200-slot global cache; flash on a ragged B=8 rung-2048 batch and on the
# exact 3072-token prompt, where the window binds
HYMBA_CASES = {
    "rmsnorm": [(8, 1600, False), (8 * 2048, 1600, True)],
    "decode_attention": [
        (8, 25, 5, 64, 2048, 0, [1, 300, 2048, 2048, 1500, 2048, 37, 2048]),
        (8, 25, 5, 64, 3200, 0, [1, 2049, 3100, 3073, 500, 2048, 3200,
                                 1000])],
    "flash_attention": [
        (8, 2048, 25, 5, 64, [2048, 1600, 1030, 2048, 600, 1280, 2040,
                              2035]),
        (1, 3072, 25, 5, 64, None, 2048)],
}


# the encdec, vlm and moe families at full width. seamless-m4t-medium (16
# / 16 heads of 64, d_model 1024; 8 slots, max_len 1024, frames of 1024 and 512
# rows, decoder prompts of 8-128 on the ladder): the encoder's non-causal
# flash (B 8, S 1024), the decoder's cross-attention over the memory (Sq
# 128 against 1024, no kv_valid) and its causal self-attention at rung
# 128; decode at G = 1 against the self cache and against the 1024-row
# memory (every row counts, padding included). internvl2-1b (14 / 2 heads
# of 64, d_model 896): text served at max_len 256 (flash on a ragged rung
# 256, decode at Smax 256) and the prefixed batch (B 4, 1024 prefix rows +
# 1024 text tokens: flash at S 2048, decode at Smax 2112 in the 8-slot
# server that holds the 4 rows, at lengths 2049-2080 and 1 in the 4 free
# slots, as the fused step gives them, lengths + 1). dbrx-132b (48 / 8 heads of 128, d_model 6144; same-length groups
# of 32-256 tokens, max_len 512): flash on an exact B 8 x 256 group,
# decode at Smax 512. RMSNorm at each width on decode rows (8) and a
# prefill batch, with the residual in front
FAMILY_CASES = {
    "rmsnorm": [(8, 1024, False), (8 * 1024, 1024, True), (8, 896, False),
                (4 * 2048, 896, True), (8, 6144, False),
                (8 * 256, 6144, True)],
    "decode_attention": [
        (8, 16, 16, 64, 1024, 0, [9, 40, 128, 1, 77, 100, 64, 30]),
        (8, 16, 16, 64, 1024, 0, [1024] * 8),
        (8, 14, 2, 64, 256, 0, [0, 9, 200, 256, 37, 128, 64, 241]),
        (8, 14, 2, 64, 2112, 0, [2049, 2060, 2080, 2112, 1, 1, 1, 1]),
        (8, 48, 8, 128, 512, 0, [33, 64, 200, 287, 0, 512, 129, 260])],
    "flash_attention": [
        dict(B=8, S=1024, Hq=16, Hkv=16, D=64, lens=None, causal=False),
        dict(B=8, S=128, Hq=16, Hkv=16, D=64, lens=None, causal=False,
             Sk=1024),
        dict(B=8, S=128, Hq=16, Hkv=16, D=64,
             lens=[128, 100, 65, 128, 70, 90, 127, 128]),
        dict(B=8, S=256, Hq=14, Hkv=2, D=64,
             lens=[256, 200, 129, 256, 131, 140, 250, 180]),
        dict(B=4, S=2048, Hq=14, Hkv=2, D=64, lens=None),
        dict(B=8, S=256, Hq=48, Hkv=8, D=128, lens=None)],
}


# RMSNorm's scalar path: d not a multiple of 8 (decode rows, and with the
# residual), and rows whose start is not 16-byte aligned (one bf16 value
# off: decode rows, and a prefill batch with the residual)
RMSNORM_EDGE_CASES = [(8, 1001, False), (37, 1001, True),
                      (8, 960, False, 1), (2048, 960, True, 1)]


# phase 16's context-parallel prefill: one rank's 512 query rows of a
# 2048-token prompt at each rank's offset (smollm's 15 / 5 heads of 64)
CP_CASES = [dict(B=2, S=512, Hq=15, Hkv=5, D=64, lens=None, Sk=2048,
                 q_offset=off) for off in (0, 512, 1024, 1536)]

# phase 16e-g's tensor-parallel ranks: smollm-360m at padded(4) on 4 ranks
# holds 4 q heads and 1 kv head a rank (G = 4, D = 64), at padded(2) on
# (data 2, model 2) 8 q heads and 1 kv head (G = 8) and 4 slots a data row;
# decode over 8 slots at lengths 0-256, flash over an 8 x 256 prefill,
# ragged.
# Phase 16h-j's ranks: hymba-1.5b at padded(4) holds 7 q heads and 1 kv
# head a rank (G = 7), at padded(2) on (data 2, model 2) 13 and 1 (G = 13,
# all in one block); decode on the 2048-slot ring (counts min(len + 1,
# 2048)) and on the 512-slot global cache of 16h-i's servers, over 8 slots
# (16h) and a data row's 4 (16i); flash on the rung-128 prefill (window
# 2048, ragged), 8 rows (16i's data rows prefill the whole rung together).
# seamless-m4t-medium at padded(4): 4 / 4 heads a rank, the encoder's
# non-causal flash over 8 x 1024 frames, the decoder's self (rung 128)
# and cross-attention (128 rows over 1024), decode against the self cache
# and the 1024-row memory
TP_CASES = {
    "decode_attention": [
        (8, 4, 1, 64, 256, 0, [0, 1, 37, 128, 200, 255, 256, 64]),
        (4, 8, 1, 64, 256, 0, [0, 100, 256, 31]),
        (8, 7, 1, 64, 2048, 0, [33, 65, 97, 129, 33, 65, 97, 129]),
        (8, 7, 1, 64, 512, 0, [33, 64, 100, 129, 40, 80, 140, 60]),
        (4, 13, 1, 64, 2048, 0, [33, 65, 97, 129]),
        (4, 13, 1, 64, 512, 0, [33, 64, 100, 129]),
        (8, 4, 4, 64, 256, 0, [129, 130, 131, 132, 133, 134, 135, 136]),
        (8, 4, 4, 64, 1024, 0, [1024] * 8)],
    "flash_attention": [
        dict(B=8, S=256, Hq=4, Hkv=1, D=64,
             lens=[256, 200, 129, 256, 131, 140, 250, 180]),
        dict(B=4, S=256, Hq=8, Hkv=1, D=64, lens=[256, 200, 129, 31]),
        dict(B=8, S=128, Hq=7, Hkv=1, D=64, window=2048,
             lens=[32, 64, 128, 32, 64, 128, 32, 64]),
        dict(B=8, S=128, Hq=13, Hkv=1, D=64, window=2048,
             lens=[32, 64, 128, 128, 32, 64, 128, 128]),
        dict(B=8, S=1024, Hq=4, Hkv=4, D=64, lens=None, causal=False),
        dict(B=8, S=128, Hq=4, Hkv=4, D=64, lens=None, causal=False,
             Sk=1024),
        dict(B=8, S=128, Hq=4, Hkv=4, D=64, lens=None)],
}

# the launch cells' new lengths (phase 14), held against the plain versions
# before anything is timed at them: decode at smollm's decode_32k (Smax
# 32,768, G = 3, the cut batch of 32 at full and at spread lengths) and at
# hymba's long_500k (its global caches: Smax 524,288, G = 5, B = 1); flash
# at the longest prompt whose plain version fits the card (B = 1, S =
# 8,192). Both kernels compute flat offsets in size_t
# (decode_attention.cu:225, :236, :460; flash_attention.cu's copy_q,
# store_row and the mma instance's load_tile; its wgmma instance's K and V
# go through a TMA tensor map's coordinates) and positions in int, which
# these lengths keep far below 2**31
LONG_CASES = {
    "decode_attention": [
        (32, 15, 5, 64, 32768, 0, [32768] * 16 + [
            1, 100, 4096, 8191, 16384, 20000, 32767, 32768, 30000, 2, 77,
            12345, 31000, 5000, 25000, 32000]),
        (1, 25, 5, 64, 524288, 0, [524288])],
    "flash_attention": [dict(B=1, S=8192, Hq=15, Hkv=5, D=64, lens=None)],
}


def flash_vs_sdpa(dev, B=1, S=32768, Hq=15, Hkv=5, D=64):
    """Flash at prefill_32k's length against SDPA (causal, exact prompt):
    the plain version would need a [1, 15, 32768, 32768] fp32 score tensor
    (64 GB), so SDPA is the cross-check here, held to the plain version's
    tolerance, on N(0, 1) inputs and on planted keys (``_flash_planted``),
    where each emulated lost tile must fail the check."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_op, flash_attention_work)
    from repro_torch.launch.roofline import kernel_bound

    gen = torch.Generator(device=dev).manual_seed(4242)
    q, k, v = ((torch.randn(shape, generator=gen, device=dev)
                .to(torch.bfloat16))
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    got = flash_attention_op(q, k, v)
    case = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal, vs SDPA"
    err = check("flash_attention", got, lib().transpose(1, 2), case)
    timed = dict(ms=graph_ms(lambda: flash_attention_op(q, k, v), reps=5),
                 library_ms=graph_ms(lib, reps=5))
    del got, q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    def sdpa_of(q2, k2, v2):
        return F.scaled_dot_product_attention(
            q2.transpose(1, 2), k2.transpose(1, 2), v2.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)
    planted = _flash_planted(dev, B, S, Hq, Hkv, D, None, want_fn=sdpa_of)
    return dict(case=case, max_abs_err=err, planted=planted,
                bound=kernel_bound(flash_attention_work(B, S, Hq, Hkv, D)),
                **timed)


def kernel_cases(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    out = {"rmsnorm": [], "decode_attention": [], "flash_attention": []}

    # rmsnorm: decode rows (8) and a full prefill batch (8 x 256), d = 960,
    # plain and with the residual add in front
    for n in (8, 2048):
        for residual in (False, True):
            out["rmsnorm"].append(_rmsnorm_case(dev, randn, n, 960,
                                                residual))

    # decode: B=8 slots, 15/5 heads, D=64, Smax=256, mixed lengths incl. 0
    # and Smax, full attention and a window; then Smax=2048 (smollm's
    # context), lengths spread over 0-2048
    for Smax, window, lengths in (
            (256, 0, [0, 1, 37, 128, 200, 255, 256, 64]),
            (256, 32, [0, 1, 37, 128, 200, 255, 256, 64]),
            (2048, 0, [0, 1, 300, 1024, 2047, 2048, 1500, 700])):
        out["decode_attention"].append(_decode_case(
            dev, randn, 8, 15, 5, 64, Smax, window, lengths))

    # flash prefill: B in {1, 8}, Sq = Sk in {8, 24 (ragged, one empty
    # prompt), 256}, kv_valid as the ladder-padded prefill passes it; then
    # B=8 at 1024 and 2048 (smollm's context), ragged
    flash_lens = {8: [8, 5, 8, 3, 7, 8, 1, 6],
                  24: [24, 17, 3, 0, 24, 9, 20, 12],
                  256: [256, 200, 129, 256, 131, 140, 250, 180],
                  1024: [1024, 800, 517, 1024, 300, 640, 900, 1000],
                  2048: [2048, 1600, 1030, 2048, 600, 1280, 1800, 2000]}
    for S, B in ((8, 1), (8, 8), (24, 1), (24, 8), (256, 1), (256, 8),
                 (1024, 8), (2048, 8)):
        out["flash_attention"].append(_flash_case(
            dev, randn, B, S, 15, 5, 64, flash_lens[S][:B]))

    out["rmsnorm"] += [_rmsnorm_case(dev, randn, *c)
                       for c in SCENARIO_CASES["rmsnorm"]]
    out["decode_attention"] += [_decode_case(dev, randn, *c)
                                for c in SCENARIO_CASES["decode_attention"]]
    out["flash_attention"] += [_flash_case(dev, randn, *c)
                               for c in SCENARIO_CASES["flash_attention"]]
    out["decode_attention"] += [_decode_case(dev, randn, *c)
                                for c in CASCADE_CASES["decode_attention"]]
    out["flash_attention"] += [_flash_case(dev, randn, *c)
                               for c in CASCADE_CASES["flash_attention"]]
    out["rmsnorm"] += [_rmsnorm_case(dev, randn, *c)
                       for c in HYMBA_CASES["rmsnorm"]]
    out["decode_attention"] += [_decode_case(dev, randn, *c)
                                for c in HYMBA_CASES["decode_attention"]]
    out["flash_attention"] += [_flash_case(dev, randn, *c)
                               for c in HYMBA_CASES["flash_attention"]]
    out["rmsnorm"] += [_rmsnorm_case(dev, randn, *c)
                       for c in FAMILY_CASES["rmsnorm"]]
    out["decode_attention"] += [_decode_case(dev, randn, *c)
                                for c in FAMILY_CASES["decode_attention"]]
    out["flash_attention"] += [_flash_case(dev, randn, **c)
                               for c in FAMILY_CASES["flash_attention"]]
    out["rmsnorm"] += [_rmsnorm_case(dev, randn, *c)
                       for c in RMSNORM_EDGE_CASES]
    out["decode_attention"] += [_decode_case(dev, randn, *c)
                                for c in LONG_CASES["decode_attention"]]
    for c in LONG_CASES["flash_attention"]:
        r = _flash_case(dev, randn, **c)
        r["planted"] = _flash_planted(dev, **c)
        out["flash_attention"].append(r)
    out["flash_attention"] += [_flash_case(dev, randn, **c)
                               for c in CP_CASES]
    out["decode_attention"] += [_decode_case(dev, randn, *c)
                                for c in TP_CASES["decode_attention"]]
    out["flash_attention"] += [_flash_case(dev, randn, **c)
                               for c in TP_CASES["flash_attention"]]
    return out


def decode_sweep(dev):
    """decode_attention through its C entry point at every split it takes
    (not the wrapper's choice), each launch's geometry beside its time:
    smollm's decode shape with lengths 0-256, the same with every length 0
    (the launch's fixed cost: no position is read), smollm at Smax 2048,
    hymba's 2048-slot ring (25 / 5 heads), dbrx's (48 / 8 heads of 128,
    Smax 512), seamless's cross-attention (16 / 16 heads over 1024 rows),
    smollm's decode_32k (B 32, Smax 32,768, the lengths of ``LONG_CASES``)
    and hymba's long_500k (B 1, Smax 524,288). Each launch is held against
    the plain version, on N(0, 1) inputs and on planted keys that make each
    slice show (``_planted_check``), and above ``MAX_CLUSTER`` blocks two
    launches must agree bit for bit. What ``splits`` is chosen from; these
    launches bypass the wrapper and its count."""
    import torch
    from repro_torch.kernels import softmax_scale
    from repro_torch.kernels.decode_attention import decode_attention as bind
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(99)
    long32k = LONG_CASES["decode_attention"][0]
    rows = []
    for B, Hq, Hkv, D, Smax, lengths, ps in (
            (8, 15, 5, 64, 256, [0, 1, 37, 128, 200, 255, 256, 64],
             (1, 2, 4, 8)),
            (8, 15, 5, 64, 256, [0] * 8, (1, 2, 8)),
            (8, 15, 5, 64, 2048, [0, 1, 300, 1024, 2047, 2048, 1500, 700],
             (2, 4, 8)),
            # hymba's ring (G = 5): counts min(len + 1, 2048)
            (8, 25, 5, 64, 2048, [1, 300, 2048, 2048, 1500, 2048, 37, 2048],
             (2, 4, 8, 16)),
            (8, 48, 8, 128, 512, [33, 64, 200, 287, 0, 512, 129, 260],
             (1, 2, 4, 8)),
            (8, 16, 16, 64, 1024, [1024] * 8, (1, 2, 4, 8)),
            (long32k[0], 15, 5, 64, 32768, long32k[-1], (4, 8, 16, 32)),
            (1, 25, 5, 64, 524288, [524288], (32, 64, 128, 256))):
        q = torch.randn((B, Hq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Smax, Hkv, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        want = decode_attention_ref(q.view(B, 1, Hq, D), k, v, ln)
        out = torch.empty_like(q)
        for p in ps:
            def call():
                bind.decode_attention(q, k, v, ln, out, window=0,
                                      scale=softmax_scale(None, D), p=p)
            call()
            case = (f"B={B} Hq={Hq} Hkv={Hkv} D={D} Smax={Smax} lengths="
                    f"{min(lengths)}-{max(lengths)} P={p}")
            check("decode_attention", out.view(B, 1, Hq, D), want, case)

            def at_p(q2, k2, v2, ln2):
                o = torch.empty_like(q)
                bind.decode_attention(q2.view(B, Hq, D), k2, v2, ln2, o,
                                      window=0, scale=softmax_scale(None, D),
                                      p=p)
                return o.view(B, 1, Hq, D)
            pl = _planted_check(dev, B, Hq, Hkv, D, Smax, 0, lengths, case,
                                at_p, p=p)
            if p > bind.MAX_CLUSTER:
                first = out.clone()
                call()
                if not torch.equal(first, out):
                    raise AssertionError(f"decode_attention {case}: two "
                                         f"launches differ")
            g = bind.geometry(B, Hkv, Hq // Hkv, D, Smax, 0, p)
            rows.append((case, f"{_decode_geometry(g)}; planted keys: "
                               f"max_abs_err={pl['max_abs_err']} (largest "
                               f"|output| {pl['largest']}), "
                               f"{pl['faults_caught']} faults fail the check",
                         graph_ms(call, reps=5 if Smax > 2048 else 20)))
    return rows


# RMSNorm's shapes for the rows-a-block sweep: decode rows at three widths
# (one warp a row at 960 and 1600, four at 6144), a mid-size batch, and
# the prefill rows of PERF.md's table
RMSNORM_SWEEP = [(8, 960, False), (8, 1600, False), (8, 6144, False),
                 (256, 960, False), (2048, 960, False), (8192, 1024, True),
                 (16384, 1600, True), (2048, 6144, True)]


def _rmsnorm_raw(lib, x, w, y, r, s, g, pdl):
    """One launch of geometry ``g`` through the C entry point (no wrapper,
    no count)."""
    import torch
    from repro_torch.kernels import _build
    n, d = x.shape
    _build.check(lib.rmsnorm_bf16(
        x.data_ptr(), 0 if r is None else r.data_ptr(), w.data_ptr(),
        y.data_ptr(), 0 if s is None else s.data_ptr(), n, d, 1e-5, g.vec,
        g.per_thread, g.row_warps, g.rows_per_block, pdl,
        torch.cuda.current_stream().cuda_stream), "rmsnorm")


def _rmsnorm_geometries(n, d):
    """Every 16-byte geometry the kernel takes for N rows of d: 1, 2, 4 or
    8 warps a row (up to 8 loads a thread), 1-8 rows a block (up to 256
    threads)."""
    from repro_torch.kernels.rmsnorm.rmsnorm import (
        MAX_PER_THREAD, MAX_THREADS, Geometry)
    units = d // 8
    for warps in (1, 2, 4, 8):
        per = -(-units // (32 * warps))
        if per > MAX_PER_THREAD[8]:
            continue
        for rows in (1, 2, 4, 8):
            if 32 * warps * rows <= MAX_THREADS:
                yield Geometry(8, per, warps, rows, 32 * warps * rows,
                               -(-n // rows))


def rmsnorm_sweep(dev):
    """RMSNorm through its C entry point at every geometry it takes (warps
    a row, rows a block; ``_rmsnorm_geometries``) with PDL, and the chosen
    one without as well: what ``rmsnorm.py::geometry`` is chosen from. Then
    a GEMM ([8,
    960] x [960, 960], smollm's attention output projection at decode)
    alone, and followed by the norm of its output with and without PDL: the
    norm's marginal time after the kernel it waits on. Every output is held
    against the plain version."""
    import torch
    from repro_torch.kernels.rmsnorm import rmsnorm as K
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=dev).manual_seed(99)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    lib = K._bound()
    rows = []
    for n, d, residual in RMSNORM_SWEEP:
        x, w = randn((n, d)), randn((d,), 0.25) + 1
        r = randn((n, d)) if residual else None
        y = torch.empty_like(x)
        s = torch.empty_like(x) if residual else None
        want = rmsnorm_ref(x, w, residual=r)
        chosen = K.geometry(n, d)
        for g in _rmsnorm_geometries(n, d):
            for pdl in (0, 1) if g == chosen else (1,):
                def call(g=g, pdl=pdl):
                    _rmsnorm_raw(lib, x, w, y, r, s, g, pdl)
                call()
                case = (f"N={n} d={d} residual={residual} row_warps="
                        f"{g.row_warps} per_thread={g.per_thread} "
                        f"rows_per_block={g.rows_per_block} pdl={pdl}"
                        + (" (chosen)" if g == chosen else ""))
                check("rmsnorm", y, want[1] if residual else want, case)
                if residual:
                    check("rmsnorm", s, want[0], case)
                rows.append((case, graph_ms(call)))
    a, b = randn((8, 960)), randn((960, 960), 960 ** -0.5)
    w = randn((960,), 0.25) + 1
    h = torch.empty((8, 960), dtype=torch.bfloat16, device=dev)
    y = torch.empty_like(h)
    g = K.geometry(8, 960)

    def gemm():
        torch.matmul(a, b, out=h)
    rows.append(("GEMM [8, 960] x [960, 960] alone", graph_ms(gemm)))
    for pdl in (0, 1):
        def pair(pdl=pdl):
            gemm()
            _rmsnorm_raw(lib, h, w, y, None, None, g, pdl)
        pair()
        check("rmsnorm", y, rmsnorm_ref(h, w), f"after the GEMM pdl={pdl}")
        rows.append((f"GEMM then N=8 d=960 pdl={pdl}", graph_ms(pair)))
    return rows


def rmsnorm_floor(dev):
    """The launch floor: the empty kernel of one block (it waits on its
    predecessor and releases its dependents, nothing else), 20 launches in
    one CUDA graph and back to back from Python, with and without PDL."""
    import torch
    from repro_torch.kernels.rmsnorm.rmsnorm import empty

    out = {}
    for pdl in (False, True):
        def call(pdl=pdl):
            empty(pdl, torch.cuda.current_stream().cuda_stream)
        out[pdl] = dict(ms=graph_ms(call), eager_ms=cuda_ms(call))
    return out


def rmsnorm_pdl_graph(dev, links=20):
    """``links`` RMSNorm launches chained after a ``torch.matmul`` (each
    norm reads the one before; every other one with the residual), captured
    in one CUDA graph: the graph's programmatic edges, which must be one
    into each norm, and its replay, which must equal the eager run bit for
    bit. The capture's counts are taken back (it launches nothing)."""
    import torch
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
    from repro_torch.kernels.rmsnorm.rmsnorm import programmatic_edges

    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    a, b = randn((8, 960)), randn((960, 960), 960 ** -0.5)
    ws = [randn((960,), 0.25) + 1 for _ in range(links)]

    def chain():
        x = s = torch.matmul(a, b)
        outs = []
        for i, w in enumerate(ws):
            if i % 2:
                s, x = rmsnorm_op(x, w, residual=s)
            else:
                x = rmsnorm_op(x, w)
            outs += [x, s]
        return outs
    eager = [t.clone() for t in chain()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = rmsnorm_op.launches
    with torch.cuda.graph(graph):
        captured = chain()
    rmsnorm_op.launches = before
    edges = programmatic_edges(graph.raw_cuda_graph())
    graph.replay()
    torch.cuda.synchronize()
    equal = all(torch.equal(g, e) for g, e in zip(captured, eager))
    if edges != links or not equal:
        raise AssertionError(f"rmsnorm PDL graph: {edges} programmatic "
                             f"edges for {links} launches; replay == eager: "
                             f"{equal}")
    return dict(links=links, edges=edges, equal=equal)


def rmsnorm_host_split(dev, reps=2000):
    """Where the host's time goes in one eager ``rmsnorm_op`` call (N=8,
    d=960, without and with the residual): host ms a call of the whole
    wrapper, of its output allocations (``torch.empty_like``, one or two),
    of the current stream's lookup, and of the ``ctypes`` launch call with
    its arguments ready; the rest is the wrapper's Python (checks, views,
    the geometry lookup, the count). Host clock over ``reps`` calls, the
    device kept ahead of the host (a call's device time is ~1/5 of it)."""
    import torch
    from repro_torch.kernels.rmsnorm import rmsnorm as K
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_op

    def host_ms(fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (t1 - t0) / reps

    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for residual in (False, True):
        x, r = (torch.randn((8, 960), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        r = r if residual else None
        w = torch.ones(960, dtype=torch.bfloat16, device=dev)
        y, s = torch.empty_like(x), torch.empty_like(x)
        g = K.geometry(8, 960)
        lib = K._bound()
        args = (x.data_ptr(), 0 if r is None else r.data_ptr(), w.data_ptr(),
                y.data_ptr(), 0 if r is None else s.data_ptr(), 8, 960, 1e-5,
                g.vec, g.per_thread, g.row_warps, g.rows_per_block, K.PDL,
                K.current_stream(x))
        before = rmsnorm_op.launches
        total = host_ms(lambda: rmsnorm_op(x, w, residual=r))
        rmsnorm_op.launches = before
        alloc = host_ms((lambda: (torch.empty_like(x), torch.empty_like(x)))
                        if residual else (lambda: torch.empty_like(x)))
        stream = host_ms(lambda: K.current_stream(x))
        launch = host_ms(lambda: lib.rmsnorm_bf16(*args))
        out.append(dict(residual=residual, call_ms=total, alloc_ms=alloc,
                        stream_ms=stream, launch_ms=launch,
                        python_ms=total - alloc - stream - launch))
    return out


def flash_host_split(dev, reps=500):
    """Where the host's time goes in one eager ``flash_attention_op`` call
    on the wgmma instance (the last context-parallel rank's shape: B 2, 512
    rows of 2,048 keys, 15 / 5 heads of 64): host ms a call of the whole
    wrapper, of its output allocation, of the current stream's lookup, of
    the ``ctypes`` launch call with its arguments ready, and, inside that
    call, of encoding the two TMA tensor maps (``cuTensorMapEncodeTiled``
    twice, timed alone through ``flash_attention_encode``); the rest is the
    wrapper's Python (checks, the geometry, the count). Host clock over
    ``reps`` calls, the device kept ahead of the host."""
    import torch
    from repro_torch.kernels import softmax_scale
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention.ops import flash_attention_op

    def host_ms(fn, n=reps):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (t1 - t0) / n

    B, Sq, Sk, Hq, Hkv, D, off = 2, 512, 2048, 15, 5, 64, 1536
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((B, Sk, Hkv, D), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    out = torch.empty_like(q)
    g = K.geometry(B, Sq, Sk, Hq, Hkv, D, True)
    lib = K._lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            B, Sq, Sk, Hq, Hkv, D, 1, 0, off, 512, 1024,
            softmax_scale(None, D), K.INSTANCES.index(g.instance), g.m_tiles,
            g.blocks, g.group, g.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    before = flash_attention_op.launches
    total = host_ms(lambda: flash_attention_op(q, k, v, q_offset=off))
    flash_attention_op.launches = before
    alloc = host_ms(lambda: torch.empty_like(q))
    stream = host_ms(lambda: torch.cuda.current_stream(q.device).cuda_stream)
    launch = host_ms(lambda: lib.flash_attention_bf16(*args))
    t0 = time.perf_counter()
    K.encode_maps(k, v, reps)
    encode = 1e3 * (time.perf_counter() - t0) / reps
    return dict(instance=g.instance, call_ms=total, alloc_ms=alloc,
                stream_ms=stream, launch_ms=launch, encode_ms=encode,
                python_ms=total - alloc - stream - launch)


def _scan_check(case, y, st, yr, sr):
    """ssd_scan's outputs against the plain version's: y to one bf16
    rounding, the fp32 state to rtol 2e-5, each plus SCAN_ATOL of its
    largest magnitude; raises on the first that fails, else returns both
    max |difference|."""
    import torch
    errs = []
    for name, got, want, rtol in (("y", y, yr, BF16_ULP),
                                  ("state", st, sr, 2e-5)):
        g, w = got.float(), want.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"ssd_scan {case}: non-finite {name}")
        err = (g - w).abs()
        atol = SCAN_ATOL * float(w.abs().max())
        bad = err > atol + rtol * w.abs()
        if bad.any():
            raise AssertionError(
                f"ssd_scan {case}: {int(bad.sum())} {name} elements "
                f"beyond rtol={rtol} atol={atol}; max_abs_err="
                f"{float(err.max())}")
        errs.append(float(err.max()))
    return errs


def _scan_geometry(g):
    if g.instance == "chunked":
        return (f"chunked instance: {g.chunks} chunk(s) of {g.row_groups} "
                f"16-row group(s), {g.launches} launches: {g.blocks} "
                f"local-state blocks ({g.local_smem} B shared), "
                f"{g.carry_blocks} scan blocks, y grid {g.grid} = "
                f"{g.blocks} blocks of {g.threads} threads, "
                f"{g.smem_bytes} B shared memory, {g.blocks_per_sm} "
                f"block(s) per SM, {g.waves:.3f} waves on {SMS} SMs; "
                f"workspace {g.workspace_floats * 4} B")
    return (f"serial instance: {g.cols} state columns a block, grid "
            f"{g.grid} = {g.blocks} blocks of {g.threads} threads, "
            f"{g.smem_bytes} B shared memory, {g.blocks_per_sm} block(s) "
            f"per SM, {g.waves:.3f} waves on {SMS} SMs")


def _scan_planted(dev, B, S, H, lens, state):
    """ssd_scan on ``probe.planted`` inputs at hymba's width (dk 16, dv 64,
    chunks of 256: slow gates, q and k of a (b, h) sharing a direction, v
    planted in column c over chunk c, so that every chunk's share of the
    final state and of the later chunks' y is several tolerances), held
    against the plain version; then every ``probe.faults`` output (a lost
    local state of the first or last chunk, the carry into the last chunk
    from two chunks back or without its exp(tot), a lost 16-row group's
    state read, zeros) must fail that same check."""
    import torch
    from repro_torch.kernels.ssd_scan import probe
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.linear_core import pad_mask_gates

    gen = torch.Generator(device=dev).manual_seed(37)
    q, k, v, lf, li = probe.planted(gen, B, S, H, 16, 64, 256, dev)
    if lens is not None:
        lf, li = pad_mask_gates(lf, li, torch.tensor(lens, dtype=torch.int32,
                                                     device=dev))
    s0 = (torch.randn((B, H, 16, 64), generator=gen, device=dev) if state
          else None)
    case = (f"B={B} S={S} H={H} dk=16 dv=64 chunk=256 lengths={lens} "
            f"{'random' if state else 'zero'} state, planted")
    yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=256, initial_state=s0)
    errs = _scan_check(case, *ssd_scan_op(q, k, v, lf, li, chunk=256,
                                          initial_state=s0), yr, sr)
    caught = 0
    for name, y, st in probe.faults(q, k, v, lf, li, chunk=256,
                                    initial_state=s0):
        try:
            _scan_check(name, y, st, yr, sr)
        except AssertionError:
            caught += 1
            continue
        raise AssertionError(f"ssd_scan {case}: the fault '{name}' passes "
                             f"the check")
    if caught < 6:
        raise AssertionError(f"ssd_scan {case}: {caught} faults")
    return dict(case=case, max_abs_err=errs[0], state_max_abs_err=errs[1],
                largest=float(yr.float().abs().max()),
                state_largest=float(sr.abs().max()), faults_caught=caught)


def scan_cases(dev):
    """ssd_scan against its plain version at the xlstm prefill's shapes:
    (a) B=8 S=256 H=4 dk=dv=384 with padded gates and a zero state, (b) the
    normalizer alone (dv=1), (c) S=512 in two chunks from a nonzero state,
    (d) B=1 S=8, (e) the launch the mLSTM makes: (a) with v augmented by
    the normalizer's ones column (dv=385); and at hymba's (25 heads,
    dk = ssm_state = 16, dv = head_dim = 64, softplus dt gates): (f) a
    padded B=8 rung-2048 prefill in 8 chunks from a nonzero state, (g) the
    exact 3072-token prompt, B=1, 12 chunks; at its tensor-parallel ranks'
    (phase 16h-i): (h) 7 heads (padded(4) over 4 ranks) and (i) 13 heads
    (padded(2) over 2), a padded B=8 rung-128 prefill from a zero state.
    (f) and (g) also on planted inputs (``_scan_planted``), under which
    every chunk shows in the outputs and each emulated fault must fail."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_op, ssd_scan_work
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import geometry
    from repro_torch.launch.roofline import kernel_bound
    from repro_torch.models.linear_core import pad_mask_gates

    gen = torch.Generator(device=dev).manual_seed(4321)
    chunk = 256
    lens = {8: [8], 256: [256, 200, 129, 256, 131, 140, 250, 180],
            512: [512, 300, 257, 480, 90, 512, 400, 333],
            2048: [2048, 1600, 1030, 2048, 600, 1280, 2040, 2035],
            3072: [3072], 128: [32, 64, 128, 32, 64, 128, 32, 64]}
    rows = []
    for tag, B, S, H, hd, dv, state in (
            ("a", 8, 256, 4, 384, 384, "zero"),
            ("b", 8, 256, 4, 384, 1, "zero"),
            ("c", 8, 512, 4, 384, 384, "random"),
            ("d", 1, 8, 4, 384, 384, "zero"),
            ("e", 8, 256, 4, 384, 385, "zero"),
            ("f", 8, 2048, 25, 16, 64, "random"),
            ("g", 1, 3072, 25, 16, 64, "zero"),
            ("h", 8, 128, 7, 16, 64, "zero"),
            ("i", 8, 128, 13, 16, 64, "zero")):
        def randn(shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        raw = randn((2, B, S, H))
        vl = torch.tensor(lens[S][:B], dtype=torch.int32, device=dev)
        if H == 4:
            # q, k scaled by hd**-0.5 and sigmoid gates, as the mLSTM makes
            # them
            q = randn((B, S, H, hd), hd ** -0.5).to(torch.bfloat16)
            k = randn((B, S, H, hd), hd ** -0.5).to(torch.bfloat16)
            lf, li = F.logsigmoid(raw[0] + 4.0), F.logsigmoid(raw[1])
        else:
            # c, b and the softplus dt gates, as hymba's SSD makes them
            q = randn((B, S, H, hd)).to(torch.bfloat16)
            k = randn((B, S, H, hd)).to(torch.bfloat16)
            dt = F.softplus(raw[0]).clamp(1e-4, 8.0)
            lf, li = -dt, torch.log(dt)
        v = randn((B, S, H, dv)).to(torch.bfloat16)
        if dv == hd + 1:
            v[..., -1] = 1
        if tag != "g":            # the exact prompt has no padding
            lf, li = pad_mask_gates(lf, li, vl)
        s0 = (torch.zeros((B, H, hd, dv), device=dev) if state == "zero"
              else randn((B, H, hd, dv)))
        args = (q, k, v, lf, li)
        y, st = ssd_scan_op(*args, chunk=chunk, initial_state=s0)
        yr, sr = ssd_scan_ref(*args, chunk=chunk, initial_state=s0)
        case = (f"({tag}) B={B} S={S} H={H} dk={hd} dv={dv} chunk="
                f"{min(chunk, S)} lengths={lens[S][:B]} {state} state")
        errs = _scan_check(case, y, st, yr, sr)
        geo = geometry(B, H, hd, dv, min(chunk, S), S // min(chunk, S))
        row = dict(
            case=case, max_abs_err=errs[0], state_max_abs_err=errs[1],
            geometry=_scan_geometry(geo),
            bound=kernel_bound(ssd_scan_work(B, S, H, hd, dv, chunk=chunk,
                                      state_in=True)),
            **timings(lambda: ssd_scan_op(*args, chunk=chunk,
                                          initial_state=s0),
                      lambda: ssd_scan_ref(*args, chunk=chunk,
                                           initial_state=s0)))
        if tag in ("f", "g"):
            row["planted"] = _scan_planted(
                dev, B, S, H, None if tag == "g" else lens[S][:B],
                state == "random")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phases 3-6: the serving paths at full width, and parity with the CPU
# ---------------------------------------------------------------------------

def kernel_ops():
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
    return {"rmsnorm": rmsnorm_op, "decode_attention": decode_attention_op,
            "flash_attention": flash_attention_op, "ssd_scan": ssd_scan_op}


def _zero_counts():
    """Set every kernel wrapper's launch count to 0, and decode attention's
    count of CUDA launches."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    for op in kernel_ops().values():
        op.launches = 0
    decode_attention_op.cuda_launches = 0


def _counts():
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: op.launches for name, op in kernel_ops().items()}


def serve(model, params, dev, *, kernels, max_len, max_prompt, slo=0.5,
          extra=(), lengths=None):
    """16 requests (prompts of 8..max_prompt tokens, or of lengths drawn
    from ``lengths``; 32 new tokens each, greedy), then one request per
    length in ``extra``, through
    ``LMServer`` with 8 slots; every count of ``kernels`` is set to 0 just
    before the run and must have risen just after. Then the same requests
    with the fused step eager every step, for its tokens/s."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import LMServer

    ops = {name: kernel_ops()[name] for name in kernels}
    rng = np.random.default_rng(0)
    vocab = model.cfg.vocab_size

    def make_server():
        return LMServer(model, device=dev, slots=8, max_len=max_len,
                        slo=slo, temperature=0.0, seed=0)

    # warm-up: cuBLAS handles, allocator; not measured
    warm = make_server()
    for n in (8, 100):
        warm.submit(rng.integers(0, vocab, size=n), max_new_tokens=4)
    warm.run(params)
    torch.cuda.synchronize()

    srv = make_server()
    drawn = (rng.integers(8, max_prompt + 1, size=16) if lengths is None
             else rng.choice(lengths, size=16))
    prompts = [rng.integers(0, vocab, size=int(n))
               for n in [*drawn, *extra]]
    rids = [srv.submit(p, max_new_tokens=32) for p in prompts]
    decode_s = []
    inner = srv._decode_once

    def timed_decode(params):
        t0 = time.perf_counter()
        inner(params)                 # ends in the packed host copy
        if srv.decode_steps > len(decode_s):
            decode_s.append(time.perf_counter() - t0)

    srv._decode_once = timed_decode
    _zero_counts()
    t0 = time.perf_counter()
    srv.run(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    for name in ops:
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no kernel launch on the main path")
    done = [srv.completed[r] for r in rids if r in srv.completed]
    if (len(done) != len(prompts)
            or any(len(r.tokens) != 32 for r in done)):
        raise AssertionError("not every request completed with 32 tokens")
    # the head's width: the vocabulary padded to a multiple of 256 (xlstm:
    # 50304 -> 50432), whose padding ids a model with random weights can
    # emit, as the reference's can
    width = model.cfg.padded(1).vocab_size
    if any(not 0 <= t < width for r in done for t in r.tokens):
        raise AssertionError(f"token out of the head's {width} ids")
    st = srv.stats
    if st["host_syncs_per_decode_step"] != 1.0:
        raise AssertionError(f"host syncs per decode step: {st}")
    # the first step with these weights runs eagerly, every later one is a
    # replay of the captured graph
    if srv.graph_replays != st["decode_steps"] - 1:
        raise AssertionError(f"{srv.graph_replays} graph replays in "
                             f"{st['decode_steps']} decode steps")
    tokens = sum(len(r.tokens) for r in done)
    # the same requests with the fused step run eagerly every step (the
    # step as it ran before it was captured): tokens/s in the same call
    eager = make_server()
    _eager(eager)
    for p in prompts:
        eager.submit(p, max_new_tokens=32)
    t0 = time.perf_counter()
    eager.run(params)
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    if sum(len(r.tokens) for r in eager.completed.values()) != tokens:
        raise AssertionError("the eager run did not complete every request")
    return dict(launches=launches, wall_s=wall, tokens=tokens,
                eager_tokens_per_s=tokens / eager_wall,
                decode_steps=st["decode_steps"],
                graph_replays=srv.graph_replays,
                decode_ms_per_step=1e3 * sum(decode_s) / len(decode_s),
                tokens_per_s=tokens / wall,
                prefill_dispatches=st["prefill_dispatches"],
                rung_dispatches=dict(srv.rung_dispatches),
                prompt_lengths=[len(p) for p in prompts],
                prefill_shapes=sorted(srv._prefill_shapes))


def prefill_rungs(model, params, dev, *, max_len, rungs=None, exact=(),
                  padded=True, extra=None):
    """Host-clock ms of one B=8 ladder-padded prefill per rung (median of 3,
    ending in a synchronise); every rung of the ladder unless ``rungs``;
    then one B=1 exact prompt per length in ``exact`` (keyed
    ``"exact <n>"``). ``padded`` False: each rung a B=8 batch of exact
    prompts of its length (moe's same-length groups); ``extra(B)``: more
    inputs of the batch (encdec frames)."""
    import numpy as np
    import torch
    from repro_torch.core.batching import prompt_length_ladder

    rng = np.random.default_rng(1)
    out = {}
    for rung in [*(rungs or prompt_length_ladder(max_len)), *exact]:
        B = 1 if rung in exact else 8
        toks = torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, size=(B, rung)).astype(np.int32)).to(dev)
        batch = {"tokens": toks, **({} if extra is None else extra(B))}
        if rung not in exact and padded:
            lens = torch.full((8,), rung, dtype=torch.int32, device=dev)
            lens[1::2] = max(1, rung - rung // 3)
            batch["lengths"] = lens
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, batch, max_len=max_len)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not torch.isfinite(logits.float()).all():
            raise AssertionError(f"prefill rung {rung}: non-finite logits")
        out[f"exact {rung}" if rung in exact else rung] = (
            1e3 * sorted(times)[1])
    return out


def _union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _busy_server(model, params, dev, *, max_len, max_prompt, slo, seed=3):
    """A server with all 8 slots busy (64 new tokens each to come)."""
    import numpy as np
    from repro_torch.serving.engine import LMServer

    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab_size
    srv = LMServer(model, device=dev, slots=8, max_len=max_len, slo=slo,
                   temperature=0.0, seed=0)
    for n in rng.integers(8, max_prompt + 1, size=8):
        srv.submit(rng.integers(0, vocab, size=int(n)), max_new_tokens=64)
    for _ in range(8):                 # AIMD may admit fewer at a time
        if len(srv._active) < 8:
            srv._admit(params)
    if len(srv._active) != 8:
        raise AssertionError(f"server holds {len(srv._active)} requests, "
                             f"not 8")
    return srv


def _eager(srv):
    """Make ``srv`` run its fused step eagerly (the step its graph
    captures); ``_graphed`` undoes it."""
    srv._decode_device = lambda params: srv._decode_fused(
        params, *srv._slot_state())


def _graphed(srv):
    srv.__dict__.pop("_decode_device", None)


def host_split(srv, params):
    """Where the host's time goes in one eager fused decode step, from
    ``torch.profiler``'s CPU-side events: the step's wall time under the
    profiler; the CUDA API calls (kernel launches apart);
    aten operators outside those calls (PyTorch dispatch and its CPU work);
    and the rest: Python, the model code and the kernel wrappers' checks.
    The profiler's own per-event cost lands in each part."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    _eager(srv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("decode_step"):
            packed = srv._decode_device(params)
        torch.cuda.synchronize()
    packed.cpu()
    _graphed(srv)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    step = next(e for e in events if e.name == "decode_step")
    lo, hi = step.time_range.start, step.time_range.end
    inside = [e for e in events if e is not step
              and lo <= e.time_range.start and e.time_range.end <= hi]

    def spans(pred):
        return [(e.time_range.start, e.time_range.end) for e in inside
                if pred(e.name)]

    def runtime(n):
        return n.startswith("cuda") or n.startswith("cu") and n[2:3].isupper()

    def launch(n):
        return runtime(n) and "Launch" in n

    aten, calls = spans(lambda n: n.startswith("aten::")), spans(runtime)
    wall = hi - lo
    both = _union_us(aten + calls)
    return dict(
        wall_ms=wall / 1e3,
        launch_calls=len(spans(launch)),
        launch_ms=_union_us(spans(launch)) / 1e3,
        other_runtime_ms=(_union_us(calls) - _union_us(spans(launch))) / 1e3,
        aten_ms=(both - _union_us(calls)) / 1e3,
        python_ms=(wall - both) / 1e3,
        aten_ops=sum(1 for e in inside if e.name.startswith("aten::")
                     and not (e.cpu_parent and e.cpu_parent.name.startswith(
                         "aten::"))))


def device_profile(model, params, dev, *, max_len, max_prompt, steps=4,
                   slo=0.5):
    """A B=8 ladder-padded prefill at rung 256, and ``steps`` decode steps
    of a server with all 8 slots busy, eager and then replayed from the
    CUDA graph, each under ``torch.profiler``: device operations (kernels,
    copies) per prefill and per decode step, and the device's busy time in
    each (the union of their intervals); before the capture, the host's
    split of one eager step (``host_split``). A trace with no device
    events gives None."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    vocab = model.cfg.vocab_size
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, vocab, size=(8, 256)).astype(np.int32)).to(dev),
             "lengths": torch.from_numpy(rng.integers(
                 129, 257, size=8).astype(np.int32)).to(dev)}
    srv = _busy_server(model, params, dev, max_len=max_len,
                       max_prompt=max_prompt, slo=slo)
    split = host_split(srv, params)
    _eager(srv)
    eager = _traced(srv._decode_once, params, steps)
    _graphed(srv)
    for _ in range(2):                 # the eager step, then the capture
        srv._decode_once(params)
    if srv.graph_replays != 1:
        raise AssertionError("the profiled server did not capture its step")
    return dict(prefill=_traced(lambda p: model.prefill(p, batch,
                                                        max_len=max_len),
                                params, 1),
                decode=_traced(srv._decode_once, params, steps),
                decode_eager=eager, host_split=split)


def _traced(fn, params, n):
    """``fn(params)`` ``n`` times under ``torch.profiler``: device
    operations (kernels, copies) and the device's busy time (the union of
    their intervals) per call; None where the trace has no device
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(params)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        return None
    busy_us = _union_us([(o.time_range.start, o.time_range.end)
                         for o in ops])
    kernels = [o for o in ops if not o.name.startswith("Mem")]
    return dict(device_ops=len(ops) / n, kernels=len(kernels) / n,
                busy_ms=busy_us / 1e3 / n)


def eager_vs_graph(model, params, dev, *, max_len, max_prompt, steps=16,
                   slo=0.5):
    """ms per decode step (host clock, each step ending in its packed host
    copy) of one server with all 8 slots busy, its fused step eager and
    replayed from the graph, in turns (eager, graph, graph, eager), each
    turn from the same slot state; the greedy tokens of every turn must be
    equal."""
    srv = _busy_server(model, params, dev, max_len=max_len,
                       max_prompt=max_prompt, slo=slo, seed=4)
    for _ in range(2):                 # the eager step, then the capture
        srv._decode_once(params)
    return _turns(srv, params, steps)


def _turns(srv, params, steps=16):
    """ms per decode step of ``srv`` (its step captured; all of its slots
    busy), eager and replayed from the graph in turns (eager, graph, graph,
    eager), each turn from the same slot state; the greedy tokens of every
    turn must be equal."""
    import torch

    n_active = len(srv._active)
    state = list(_leaves(srv._slot_state()))
    snap = [t.clone() for t in state]
    ms, toks = {"eager": [], "graph": []}, []
    for mode in ("eager", "graph", "graph", "eager"):
        for t, s in zip(state, snap):
            t.copy_(s)
        (_eager if mode == "eager" else _graphed)(srv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            srv._decode_once(params)
        ms[mode].append(1e3 * (time.perf_counter() - t0) / steps)
        toks.append([r.tokens[-steps:] for _, r in sorted(
            srv._active.items())])
    _graphed(srv)
    if len(srv._active) != n_active or any(t != toks[0] for t in toks):
        raise AssertionError("eager and graphed steps disagree")
    return ms


def token_parity(model, params, dev, *, max_len, max_prompt,
                 reference=False):
    """8 requests (prompts of 8..max_prompt tokens, 16 new tokens each)
    through servers in calibrated-simulation mode (admission does not
    depend on wall time): the graphed fused step against the eager one at
    temperature 0 and at 0.8 (seed 0), streams equal bit for bit; with
    ``reference``, also ``fused=False`` against the graphed fused step
    (both with the reference loop's same-length prompt groups), streams
    equal and 1 + active slots host syncs per step."""
    import numpy as np
    from repro_torch.core.metrics import VirtualClock
    from repro_torch.serving.engine import LMServer

    rng = np.random.default_rng(5)
    vocab = model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, size=int(n))
               for n in rng.integers(8, max_prompt + 1, size=8)]

    def run(graph=True, **kw):
        srv = LMServer(model, device=dev, slots=8, max_len=max_len, seed=0,
                       clock=VirtualClock(),
                       service_model=lambda kind, b, t: 1e-5 * (1 + b * t),
                       **kw)
        if not graph:
            _eager(srv)
        rids = [srv.submit(p, max_new_tokens=16) for p in prompts]
        t0 = time.perf_counter()
        srv.run(params)
        wall = time.perf_counter() - t0
        toks = [srv.completed[r].tokens for r in rids]
        if any(len(t) != 16 for t in toks):
            raise AssertionError("a request did not complete its 16 tokens")
        if graph and kw.get("fused", True) and srv.graph_replays == 0:
            raise AssertionError("the fused step never replayed its graph")
        return toks, srv, wall

    out = {}
    for temp in (0.0, 0.8):
        graphed, eager = (run(graph=g, temperature=temp)[0]
                          for g in (True, False))
        if graphed != eager:
            raise AssertionError(f"graphed and eager streams differ at "
                                 f"temperature {temp}")
        out[f"graph_eq_eager_T{temp}"] = True
    if reference:
        fused, fsrv, fwall = run(temperature=0.0, pad_prompts=False)
        ref, rsrv, rwall = run(temperature=0.0, fused=False)
        if ref != fused:
            raise AssertionError("fused=False streams differ from the fused "
                                 "run's")
        want = rsrv.decode_steps + sum(len(t) - 1 for t in ref)
        if rsrv.decode_host_syncs != want:
            raise AssertionError(f"fused=False: {rsrv.decode_host_syncs} "
                                 f"host syncs, not 1 + active slots ({want})")
        out.update(reference_eq_fused=True,
                   reference_syncs_per_step=rsrv.stats[
                       "host_syncs_per_decode_step"],
                   reference_ms_per_step=1e3 * rwall / rsrv.decode_steps,
                   fused_ms_per_step=1e3 * fwall / fsrv.decode_steps)
    return out


def run_quickstart(dev):
    """``examples/quickstart_torch.py``'s ``main()`` on the card (full-width
    smollm-360m, temperature 0.8); the launch counts are set to 0 just
    before and read just after."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _zero_counts()
    t0 = time.perf_counter()
    srv = mod.main(["--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = _counts()
    for name in ("rmsnorm", "decode_attention", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"quickstart: no {name} launch")
    if (len(srv.completed) != 24
            or any(len(r.tokens) != 24 for r in srv.completed.values())):
        raise AssertionError("quickstart: not every request completed")
    if (srv.stats["host_syncs_per_decode_step"] != 1.0
            or srv.graph_replays != srv.decode_steps - 1):
        raise AssertionError(f"quickstart: {srv.stats}, "
                             f"{srv.graph_replays} graph replays")
    return dict(launches=launches, wall_s=wall,
                decode_steps=srv.decode_steps)


def _recording_route(route, calls):
    """``moe._route`` that appends each call's output, the gap between its
    rows' k-th and (k+1)-th router probabilities, its input and each row's
    largest sum_i |x_i w_ie| to ``calls``."""
    import torch

    def recording_route(x2d, router, k):
        out = route(x2d, router, k)
        srt = torch.softmax(x2d.float() @ router, -1).sort(
            -1, descending=True).values
        scale = (x2d.float().abs() @ router.abs()).amax(-1)
        calls.append((out, (srt[:, k - 1] - srt[:, k]).clone(),
                      x2d.clone(), scale))
        return out
    return recording_route


def _steered_route(route, calls, rerouted, p_errs, what, free=None):
    """``moe._route`` held to the recorded reference ``calls`` (in call
    order): on the reference's own input the same expert sets (near-ties
    aside) and weights within ``ROUTER_P_TOL``; on its own input a row may
    pick another expert set only at a router near-tie (``ROUTER_NEAR``),
    and then takes the reference's choices and weights, so that a near-tie
    routed otherwise does not hide the rest of the comparison. ``free()``
    (a set of row indices) names rows that are not compared and take the
    reference's routing outright (rows whose input has parted from the
    reference's). Appends (call, rows rerouted, widest gap) to
    ``rerouted`` and the weights' error to ``p_errs``."""
    import torch

    def differing(e, ref_e, gap, where, skip):
        """Rows whose expert set differs from the reference's; each not in
        ``skip`` must sit at a router near-tie."""
        differs = (e.sort(-1).values.to(ref_e.device)
                   != ref_e.sort(-1).values).any(-1)
        held = differs & ~skip
        worst = float(gap[held].max()) if held.any() else 0.0
        if worst > ROUTER_NEAR:
            raise AssertionError(
                f"{what} routing, {where}: {int(held.sum())} token(s) routed "
                f"otherwise where the reference's k-th and (k+1)-th router "
                f"probabilities are {worst} apart > {ROUTER_NEAR}")
        return differs, worst

    def steered_route(x2d, router, k):
        j = len(rerouted)
        (ref_p, ref_e, _), gap, ref_x, scale = calls[j]
        skip = torch.zeros(ref_e.shape[0], dtype=torch.bool,
                           device=ref_e.device)
        if free is not None:
            skip[sorted(free())] = True
        same_p, same_e, _ = route(ref_x.to(x2d.device), router, k)
        differs, _ = differing(same_e, ref_e, gap,
                               f"router call {j} on the reference's input",
                               torch.zeros_like(skip))
        err = (same_p.to(ref_p.device) - ref_p).abs().amax(-1) / scale
        p_errs.append(float(err[~differs].max()) if (~differs).any()
                      else 0.0)
        if p_errs[-1] > ROUTER_P_TOL:
            raise AssertionError(
                f"{what} router weights on the same input, router call "
                f"{j}: max |diff| / sum |x w| = {p_errs[-1]} > {ROUTER_P_TOL}")
        own_p, own_e, aux = route(x2d, router, k)
        differs, worst = differing(own_e, ref_e, gap, f"router call {j}",
                                   skip)
        rerouted.append((j, int((differs & ~skip).sum()), worst))
        d = (differs | skip).to(x2d.device)[:, None]
        return (torch.where(d, ref_p.to(x2d.device), own_p),
                torch.where(d, ref_e.to(x2d.device), own_e), aux)
    return steered_route


def cpu_parity(cfg, params, dev, *, state=None, exact=0, tol_key=None,
               anchor=False, lens=(64, 37), steps=8, extra=None,
               routing=False):
    """Prefill + ``steps`` (8) teacher-forced decode steps on the card and
    on the CPU's plain path, same weights and tokens (two prompts of 64 and
    37 tokens, padded to 64, or of ``lens``, padded where they differ; or
    with ``exact``, one exact prompt of that length); max |logit
    difference| over the largest |logit|, within ``LOGIT_TOL[tol_key or
    cfg.name]``. ``extra(rng, B)``: more inputs of the prefill batch, numpy
    arrays (encdec frames, vlm prefix embeddings, whose rows the cache
    holds ahead of the text). With ``state`` (cache -> named leaves), every
    leaf after the prefill and after the last step too, each over its own
    largest magnitude.

    With ``anchor``, a third run in fp32 on the CPU (the same weights
    upcast) anchors both: the card's distance to it, logits and each leaf,
    may be at most ``ANCHOR_RATIO`` times the CPU bf16 path's.

    With ``routing`` (a moe model), the CPU runs first and records each
    router call's input, expert choices and weights. The card's run keeps
    its own choices and weights; on a token whose expert set differs from
    the CPU's, which is allowed only where the CPU's k-th and (k+1)-th
    router probabilities lie within ``ROUTER_NEAR``, it takes the CPU's, so
    that a near-tie routed otherwise does not hide the rest of the
    comparison. Each card call also runs the router on the CPU's own input:
    the same expert sets (near-ties aside) and weights within
    ``ROUTER_P_TOL`` of the row's fp32 product scale, which holds the
    router's fp32 arithmetic on the card apart from the bf16 drift of its
    input."""
    import numpy as np
    import torch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.api import build_model

    tol_key = tol_key or cfg.name
    cpu_model = build_model(cfg, device="cpu")
    gpu_model = build_model(cfg, device=dev)
    cpu_params = _tree_to(params, "cpu")
    runs = [(gpu_model, params, dev), (cpu_model, cpu_params, "cpu")]
    if anchor:
        runs.append((build_model(cfg, device="cpu", dtype=torch.float32),
                     _tree_to(cpu_params, torch.float32), "cpu"))
    rng = np.random.default_rng(2)
    B = 1 if exact else len(lens)
    S = exact or max(lens)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([exact] if exact else lens, np.int32)
    feeds = rng.integers(0, cfg.vocab_size,
                         size=(steps, B, 1)).astype(np.int32)
    more = {} if extra is None else extra(rng, B)
    pre = (more["prefix_embeddings"].shape[1]
           if "prefix_embeddings" in more else 0)
    results, states = [None] * len(runs), [None] * len(runs)
    route, cpu_calls, rerouted, p_errs = moe_lib._route, [], [], []
    recording_route = _recording_route(route, cpu_calls)
    steered_route = _steered_route(route, cpu_calls, rerouted, p_errs,
                                   "card vs CPU")

    for i in ((1, 0, *range(2, len(runs))) if routing
              else range(len(runs))):
        model, p, d = runs[i]
        if routing and i < 2:
            moe_lib._route = (steered_route, recording_route)[i]
        batch = {"tokens": torch.from_numpy(toks).to(d),
                 **{k: torch.from_numpy(v).to(d) for k, v in more.items()}}
        if not exact and (lens != S).any():
            batch["lengths"] = torch.from_numpy(lens).to(d)
        try:
            logits, cache = model.prefill(p, batch,
                                          max_len=pre + S + steps + 8)
            # clone: on the CPU .float().cpu() of an fp32 leaf is the leaf
            # itself, which the decode steps below update in place
            snaps = [] if state is None else [
                {k: t.float().cpu().clone() for k, t in state(cache).items()}]
            seq = [logits.float().cpu()]
            ln = torch.from_numpy(lens + pre).to(d)
            for t in feeds:
                logits, cache = model.decode_step(
                    p, cache, torch.from_numpy(t).to(d), ln)
                ln = ln + 1
                seq.append(logits.float().cpu())
        finally:
            moe_lib._route = route
        if state is not None:
            snaps.append({k: t.float().cpu().clone()
                          for k, t in state(cache).items()})
        results[i] = torch.stack(seq)
        states[i] = snaps
    gpu, cpu = results[:2]
    if not torch.isfinite(gpu).all():
        raise AssertionError("non-finite logits on the card")
    scale = float(cpu.abs().max())
    err = (gpu - cpu).abs().amax(dim=(1, 2))
    rel = [float(e) / scale for e in err]
    if max(rel) > LOGIT_TOL[tol_key]:
        raise AssertionError(f"card vs CPU logits: max |diff| / max |logit| "
                             f"= {max(rel)} > {LOGIT_TOL[tol_key]} ({rel})")
    agree = float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())
    out = dict(prefill_rel_err=rel[0], decode_rel_err=rel[1:],
               logit_scale=scale, argmax_agreement=agree)
    if routing:
        out.update(router_calls=len(cpu_calls),
                   rerouted=[r for r in rerouted if r[1]],
                   router_p_err=max(p_errs),
                   min_router_gap=min(float(c[1].min()) for c in cpu_calls))
    for when, g, c in zip(("prefill", "decode"), *states[:2]):
        for name in c:
            if not torch.isfinite(g[name]).all():
                raise AssertionError(f"non-finite {name} on the card")
            e = _rel_err(g[name], c[name])
            if e > STATE_TOL[tol_key]:
                raise AssertionError(
                    f"card vs CPU state {name} after {when}: max |diff| / "
                    f"max |leaf| = {e} > {STATE_TOL[tol_key]}")
            out[f"{name}_{when}_rel_err"] = e
    if anchor:
        # each bf16 run's distance to the fp32 run: logits over all steps,
        # each leaf after the prefill and after the last step
        f32 = results[2]
        dist = {"logits": (_rel_err(gpu, f32), _rel_err(cpu, f32))}
        for when, g, c, f in zip(("prefill", "decode"), *states):
            for name in f:
                dist[f"{name}_{when}"] = (_rel_err(g[name], f[name]),
                                          _rel_err(c[name], f[name]))
        ratios = {k: a / max(b, 1e-30) for k, (a, b) in dist.items()}
        out["fp32_dist_card_cpu"] = dist
        out["fp32_dist_ratio_max"] = max(ratios.values())
        worst = max(ratios, key=ratios.get)
        if ratios[worst] > ANCHOR_RATIO:
            raise AssertionError(
                f"the card is {ratios[worst]}x as far as the CPU's bf16 "
                f"path from the fp32 run ({worst}: {dist[worst]}) > "
                f"{ANCHOR_RATIO}")
    return out


# ---------------------------------------------------------------------------
# phase 2b: the Clipper frontend stack, the contextual store and the
# scenario runner on the card
# ---------------------------------------------------------------------------

def frontend_scenarios(dev):
    """Every named scenario's frontend stack with its selection state on the
    card and on the CPU: the two reports must be equal byte for byte. Wall
    ms of each run (host clock; the frontend's models are numpy by the
    scenario's definition, so the card holds only the Exp4 state) and the
    state's device-to-host copies per query on the card."""
    from repro_torch.workloads import scenario as S

    made = []
    real = S.make_clipper

    def keep(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    rows = []
    S.make_clipper = keep
    try:
        for name in sorted(S.SCENARIOS):
            text, wall = {}, {}
            for tag, d in (("cpu", "cpu"), ("cuda", dev)):
                t0 = time.perf_counter()
                text[tag] = S.ScenarioRunner(S.SCENARIOS[name],
                                             device=d).run_json("frontend")
                wall[tag] = 1e3 * (time.perf_counter() - t0)
            if text["cuda"] != text["cpu"]:
                raise AssertionError(f"frontend {name}: the card's report "
                                     f"differs from the CPU's")
            clip = made[-1]
            if clip.policy_state.device.type != "cuda":
                raise AssertionError(f"frontend {name}: the policy state is "
                                     f"not on the card")
            queries = len(clip.results)
            rows.append(dict(name=name, queries=queries,
                             card_ms=wall["cuda"], cpu_ms=wall["cpu"],
                             host_copies=clip.policy.host_copies,
                             copies_per_query=clip.policy.host_copies
                             / max(queries, 1)))
    finally:
        S.make_clipper = real
    return rows


def contextual_store(dev, users=1 << 20, k=4, batch=4096, batches=8):
    """A ``[users, k]`` fp32 ``ContextualStore`` on the card and one on the
    CPU take the same batched Exp4, then Exp3, feedback: ``batches`` batches
    of ``batch`` users, a quarter of each batch repeating earlier entries
    of the batch (the last occurrence lands). Host-clock ms per batch (each
    ending in a synchronise on the card; the first batch of each kind is a
    warm-up) and max |card - CPU| over the whole store, within 1e-6."""
    import numpy as np
    import torch
    from repro_torch.core.context import ContextualStore

    rng = np.random.default_rng(7)
    out = {}
    for kind in ("exp4", "exp3"):
        card = ContextualStore(users, k, kind=kind, device=dev)
        cpu = ContextualStore(users, k, kind=kind, device="cpu")
        ms = {"card": [], "cpu": []}
        distinct = []
        for b in range(batches + 1):
            u = rng.integers(0, users, size=batch)
            u[3 * batch // 4:] = u[:batch // 4]
            distinct.append(len(np.unique(u)))
            if kind == "exp4":
                args = (u, rng.random((batch, k)).astype(np.float32),
                        rng.random((batch, k)) < 0.9)
            else:
                args = (u, rng.integers(0, k, size=batch),
                        rng.random(batch).astype(np.float32))
            for tag, store in (("card", card), ("cpu", cpu)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                getattr(store, f"observe_{kind}")(*args)
                torch.cuda.synchronize()
                if b:
                    ms[tag].append(1e3 * (time.perf_counter() - t0))
        err = float((card.states.cpu() - cpu.states).abs().max())
        if not torch.isfinite(card.states).all() or err > 1e-6:
            raise AssertionError(f"contextual store {kind}: max |card - "
                                 f"CPU| = {err} > 1e-6")
        out[kind] = dict(card_ms=sum(ms["card"]) / batches,
                         cpu_ms=sum(ms["cpu"]) / batches, max_abs_err=err,
                         distinct_per_batch=min(distinct),
                         max_abs_state=float(cpu.states.abs().max()))
    out["bytes"] = users * k * 4
    return out


def _diff_fields(a, b, path=""):
    """The dotted paths at which two report dicts differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [f for key in sorted(set(a) | set(b))
                for f in _diff_fields(a.get(key), b.get(key),
                                      f"{path}.{key}" if path else key)]
    return [] if a == b else [path]


def scenario_lmserver(dev):
    """The poisson scenario's lmserver stack through ``ScenarioRunner``: the
    reduced model on the card (its decode step replayed from the CUDA graph;
    each kernel's count set to 0 just before and rising) and on the CPU,
    reports equal but ``engine.attention_backend``, ``engine.decode.graph``
    and ``engine.prefill.graph`` (:func:`_engine_diff`); then full-width
    smollm-360m through the same runner (``build_lmserver(cfg=)``), its
    fields that differ from the reduced run's report listed."""
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.workloads.scenario import SCENARIOS, ScenarioRunner

    sc = SCENARIOS["poisson"]
    runs = {}
    for tag, cfg in (("reduced", None),
                     ("full", ARCHITECTURES["smollm-360m"])):
        runner = ScenarioRunner(sc, device=dev)
        _zero_counts()
        t0 = time.perf_counter()
        built = runner.build_lmserver(cfg=cfg)
        rep = runner.drive_lmserver(*built)
        wall = time.perf_counter() - t0
        srv = built[0]
        launches = _counts()
        for name in ("rmsnorm", "decode_attention", "flash_attention"):
            if launches[name] <= 0:
                raise AssertionError(f"scenario lmserver ({tag}): no {name} "
                                     f"launch")
        if (srv.graph_replays != srv.decode_steps - 1
                or not rep["engine"]["decode"]["graph"]):
            raise AssertionError(f"scenario lmserver ({tag}): "
                                 f"{srv.graph_replays} graph replays in "
                                 f"{srv.decode_steps} decode steps")
        done = srv.completed.values()
        if (len(srv.completed) != sc.lm_requests
                or any(len(r.tokens) != sc.max_new_tokens for r in done)
                or any(not 0 <= t < srv.model.cfg.vocab_size
                       for r in done for t in r.tokens)):
            raise AssertionError(f"scenario lmserver ({tag}): not every "
                                 f"request completed in vocabulary")
        runs[tag] = dict(report=rep, wall_s=wall, launches=launches,
                         decode_steps=srv.decode_steps,
                         graph_replays=srv.graph_replays,
                         prefill_dispatches=srv.prefill_dispatches,
                         prefill_graph_replays=srv.prefill_graph_replays)
    cpu_runner = ScenarioRunner(sc, device="cpu")
    t0 = time.perf_counter()
    cpu = cpu_runner.drive_lmserver(*cpu_runner.build_lmserver())
    cpu_wall = time.perf_counter() - t0
    card = json.loads(json.dumps(runs["reduced"]["report"]))
    differ = _engine_diff(card, cpu)
    if differ != ["engine.attention_backend", "engine.decode.graph"]:
        raise AssertionError(f"scenario lmserver: the card's report differs "
                             f"from the CPU's at {differ}")
    runs["cpu_wall_s"] = cpu_wall
    runs["full_vs_reduced"] = _diff_fields(runs["full"]["report"],
                                           runs["reduced"]["report"])
    return runs


# ---------------------------------------------------------------------------
# phase 2c: model composition and the control plane on the card
# ---------------------------------------------------------------------------

CRASH = "crash:m0:0@0.25:0.9"
ENGINE_FIELDS = ("engine.attention_backend", "engine.decode.graph")


def _engine_diff(card, cpu):
    """The sorted paths at which the card's report differs from the CPU's
    but each ``engine.prefill.graph``, which differs only where the card
    replayed a ladder prefill from its graph (true there; the CPU has
    none), as it must."""
    differ = []
    for f in sorted(_diff_fields(card, cpu)):
        if not f.endswith("engine.prefill.graph"):
            differ.append(f)
            continue
        sec_card, sec_cpu = card, cpu
        for key in f.split("."):
            sec_card, sec_cpu = sec_card[key], sec_cpu[key]
        if (sec_card, sec_cpu) != (True, False):
            raise AssertionError(f"{f}: {sec_card} on the card, {sec_cpu} "
                                 f"on the CPU")
    return differ



def _expect_engine_diff(label, card, cpu, prefixes=("",)):
    """The card's report equals the CPU's but each tier's engine fields;
    those say the kernels ran and the decode step replayed from its
    graph."""
    card = json.loads(json.dumps(card))
    cpu = json.loads(json.dumps(cpu))
    want = sorted(p + f for p in prefixes for f in ENGINE_FIELDS)
    differ = _engine_diff(card, cpu)
    if differ != want:
        raise AssertionError(f"{label}: the card's report differs from the "
                             f"CPU's at {differ}, not only at {want}")
    for p in prefixes:
        sec = card
        for key in p.split(".")[:-1]:
            sec = sec[key]
        if (sec["engine"]["attention_backend"] != "kernels"
                or sec["engine"]["decode"]["graph"] is not True):
            raise AssertionError(f"{label}: {p}engine says "
                                 f"{sec['engine']} on the card")


def pipelines_on_card(dev):
    """(a) The ``cascade`` and ``fanout`` pipelines of the pipeline scenario
    with their Exp4 state on the card and on the CPU, traced: reports and
    span logs equal byte for byte. Wall ms of each run (host clock; the
    zoo's models are numpy by the scenario's definition) and the policy
    state's device-to-host copies per pipeline query on the card."""
    from repro_torch.obs import Tracer
    from repro_torch.pipeline import scenario as P

    made = []
    real = P.build_executor

    def keep(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    rows = []
    P.build_executor = keep
    try:
        for kind in ("cascade", "fanout"):
            sc = P.pipeline_scenario()
            docs, wall = {}, {}
            for tag, d in (("cpu", "cpu"), ("cuda", dev)):
                tr = Tracer(sample_rate=1.0, seed=sc.seed)
                t0 = time.perf_counter()
                rep = P.run_pipeline(sc, kind, tracer=tr, device=d)
                wall[tag] = 1e3 * (time.perf_counter() - t0)
                docs[tag] = (json.dumps(rep, sort_keys=True, indent=2),
                             tr.to_json())
            if docs["cuda"] != docs["cpu"]:
                raise AssertionError(f"pipeline {kind}: the card's report or "
                                     f"span log differs from the CPU's")
            ex = made[-1]
            if ex.clip.policy_state.device.type != "cuda":
                raise AssertionError(f"pipeline {kind}: the policy state is "
                                     f"not on the card")
            queries = len(ex.results)
            rows.append(dict(name=kind, queries=queries,
                             card_ms=wall["cuda"], cpu_ms=wall["cpu"],
                             host_copies=ex.clip.policy.host_copies,
                             copies_per_query=ex.clip.policy.host_copies
                             / max(queries, 1)))
    finally:
        P.build_executor = real
    return rows


def cluster_on_card(dev, tmp):
    """(b) and (c): ``python -m repro_torch.cluster.run``'s ``main`` on the
    flash-crowd scenario (seed 0), on the card and on the CPU, every
    document written (report, span log, time series, audit doc). The
    frontend and pipeline stacks and the crash fault with and without
    recovery: the four documents equal byte for byte. The lmserver stack
    with shedding admission: the kernels ran (counts set to 0 just before,
    each rising), and the report equals the CPU's but the engine fields,
    the other documents equal."""
    from repro_torch.cluster.run import main

    runs = (("frontend", []), ("pipeline", ["--stack", "pipeline"]),
            ("crash", ["--fault", CRASH]),
            ("crash, no recovery", ["--fault", CRASH, "--no-recovery"]),
            ("lmserver, admission shed", ["--stack", "lmserver",
                                          "--admission", "shed"]))
    rows = []
    for label, args in runs:
        docs, wall = {}, {}
        for tag, d in (("cpu", "cpu"), ("cuda", str(dev))):
            files = {k: tmp / f"{tag}.{k}.json"
                     for k in ("report", "trace", "series", "audit")}
            argv = ["--scenario", "flash_crowd", "--seed", "0",
                    "--report-out", str(files["report"]),
                    "--trace-out", str(files["trace"]),
                    "--timeseries-out", str(files["series"]),
                    "--audit-out", str(files["audit"]),
                    "--device", d] + args
            if tag == "cuda":
                _zero_counts()
            t0 = time.perf_counter()
            if main(argv) != 0:
                raise AssertionError(f"cluster {label} ({tag}): exit code")
            wall[tag] = 1e3 * (time.perf_counter() - t0)
            if tag == "cuda":
                launches = _counts()
            docs[tag] = {k: f.read_text() for k, f in files.items()}
        rep = json.loads(docs["cuda"]["report"])
        if "lmserver" in args:
            for name in ("rmsnorm", "decode_attention", "flash_attention"):
                if launches[name] <= 0:
                    raise AssertionError(f"cluster {label}: no {name} launch")
            _expect_engine_diff(f"cluster {label}", rep,
                                json.loads(docs["cpu"]["report"]))
            same = ("trace", "series", "audit")
        else:
            same = ("report", "trace", "series", "audit")
        for k in same:
            if docs["cuda"][k] != docs["cpu"][k]:
                raise AssertionError(f"cluster {label}: the card's {k} "
                                     f"document differs from the CPU's")
        rows.append(dict(name=label, card_ms=wall["cuda"],
                         cpu_ms=wall["cpu"],
                         completed=rep["queries"]["completed"],
                         submitted=rep["queries"]["submitted"],
                         faults=rep["faults"], launches=launches
                         if "lmserver" in args else None))
    return rows


def _timed_tiers(casc):
    """Wrap each tier's ``step`` and ``_decode_once``: wall seconds of its
    steps, and ms of each decode step that replayed the graph (the packed
    tokens' host copy ends each step, so the host clock spans the device
    work)."""
    out = {}
    for tier in ("draft", "verify"):
        srv = getattr(casc, tier)
        rec = out[tier] = {"step_s": 0.0, "graph_ms": []}

        def step(params, srv=srv, rec=rec, real=srv.step):
            t0 = time.perf_counter()
            real(params)
            rec["step_s"] += time.perf_counter() - t0

        def decode(params, srv=srv, rec=rec, real=srv._decode_once):
            n, t0 = srv.graph_replays, time.perf_counter()
            real(params)
            if srv.graph_replays > n:
                rec["graph_ms"].append(1e3 * (time.perf_counter() - t0))

        srv.step, srv._decode_once = step, decode
    return out


def _check_cascade_launches(label, casc, launches, layers):
    """Both tiers replayed their own graphs, and the counts credited per
    replay add up across the tiers: per prefill ``layers`` flash launches
    and ``2 layers + 1`` RMSNorms, per decode step (eager or replayed)
    ``layers`` decode-attention launches and ``2 layers + 1`` RMSNorms."""
    tiers = (casc.draft, casc.verify)
    if casc.draft._graph is casc.verify._graph:
        raise AssertionError(f"{label}: the tiers share one graph")
    for srv in tiers:
        if srv.graph_replays != srv.decode_steps - 1 or not srv.graph_replays:
            raise AssertionError(f"{label}: tier {srv.model_id} replayed "
                                 f"{srv.graph_replays} of "
                                 f"{srv.decode_steps} decode steps")
    steps = sum(s.decode_steps for s in tiers)
    prefills = sum(s.prefill_dispatches for s in tiers)
    want = {"decode_attention": layers * steps,
            "flash_attention": layers * prefills,
            "rmsnorm": (2 * layers + 1) * (steps + prefills)}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want} "
                             f"({steps} decode steps, {prefills} prefills)")


def _bf16_ulp(x):
    """Spacing of bf16 values (8 significant bits) at magnitude ``x``."""
    import math
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 2.0 ** -133


def _wrap_logits(srv, per_req, calls):
    """Make ``srv`` file each sampled logits row (appended to ``calls`` by
    the wrapped ``sample``) under its request: a prefill's row i belongs
    to the i-th admitted slot in slot order, a decode step's row s to the
    request in slot s. A server over a data axis samples its data row's
    slots only (``LMServer.layout``), so it files theirs."""
    admit, decode = srv._admit, srv._decode_once
    layout = getattr(srv, "layout", None)
    lo, n_rows = ((0, srv.slots) if layout is None
                  else (layout.lo, layout.per_row))

    def mine(s):
        return lo <= s < lo + n_rows

    def rec_admit(params):
        before, n = set(srv._active), len(calls)
        admit(params)
        if len(calls) > n:
            new = sorted(s for s in srv._active
                         if s not in before and mine(s))
            for i, s in enumerate(new):
                per_req.setdefault(srv._active[s].request_id,
                                   []).append(calls[-1][i])

    def rec_decode(params):
        slots = {s: r.request_id for s, r in srv._active.items()
                 if mine(s)}
        n = len(calls)
        decode(params)
        if len(calls) > n:
            for s, rid in slots.items():
                per_req[rid].append(calls[-1][s - lo])

    srv._admit, srv._decode_once = rec_admit, rec_decode


def _record_logits(casc):
    """Per tier, the logits row each request's tokens were sampled from (a
    run whose step is eager: on the CPU, or on the card under ``_eager``):
    wraps the engine's ``sample`` and each tier's ``_admit`` and
    ``_decode_once`` (``_wrap_logits``). Returns ``(rows, undo)``."""
    from repro_torch.serving import engine as E

    calls, rows = [], {"draft": {}, "verify": {}}
    real_sample = E.sample

    def sample(logits, gen, **kw):
        calls.append(logits.float().cpu().numpy())
        return real_sample(logits, gen, **kw)

    E.sample = sample
    for tier in rows:
        _wrap_logits(getattr(casc, tier), rows[tier], calls)

    def undo():
        E.sample = real_sample
        for tier in rows:
            srv = getattr(casc, tier)
            del srv._admit, srv._decode_once
    return rows, undo


def _streams(casc):
    return {tier: {rid: list(r.tokens) for rid, r in
                   getattr(casc, tier).completed.items()}
            for tier in ("draft", "verify")}


def _stream_divergence(label, card, cpu, rows):
    """``card``, ``cpu``: per tier, request id -> greedy tokens; ``rows``:
    per device the logits rows they were sampled from. Each device's
    tokens are its own rows' argmax, and each card stream equals the CPU's
    up to the first step where they part (or to its end). Returns the
    largest card-vs-CPU logit difference over the CPU row's largest
    |logit| across every step up to and including that one (the steps
    whose inputs the two devices share), and each parting: tier, request,
    step and the CPU's gap between the two tokens in bf16 ulps."""
    worst, parts = 0.0, []
    for tier in ("draft", "verify"):
        if sorted(card[tier]) != sorted(cpu[tier]):
            raise AssertionError(f"{label}: the {tier} tier served other "
                                 f"requests on the card")
        for rid, wt in cpu[tier].items():
            gt, rc, rg = card[tier][rid], rows["cpu"][tier][rid], \
                rows["card"][tier][rid]
            for who, toks, rr in (("CPU", wt, rc), ("card", gt, rg)):
                if [int(r.argmax()) for r in rr] != toks:
                    raise AssertionError(f"{label}: the {who}'s recorded "
                                         f"logits do not give {tier} "
                                         f"request {rid}'s tokens")
            if len(gt) != len(wt):
                raise AssertionError(f"{label}: {tier} request {rid} has "
                                     f"{len(gt)} tokens on the card, "
                                     f"{len(wt)} on the CPU")
            k = next((i for i, (a, b) in enumerate(zip(wt, gt)) if a != b),
                     len(wt) - 1)
            for i in range(k + 1):
                worst = max(worst, float(abs(rg[i] - rc[i]).max()
                                         / abs(rc[i]).max()))
            if wt[k] != gt[k]:
                a, b = wt[k], gt[k]
                gap = float(rc[k][a] - rc[k][b])
                parts.append(dict(tier=tier, request=rid, step=k,
                                  gap_ulps=gap / _bf16_ulp(float(
                                      max(abs(rc[k][a]), abs(rc[k][b]))))))
    return worst, parts


def lmcascade_on_card(dev):
    """(d) The pipeline scenario's ``lmcascade`` (the reduced smollm in both
    tiers, threshold 0.9) on the card and on the CPU, traced, sampled and
    audited, through ``build_lmcascade`` / ``drive_lmcascade``: the
    reports equal but each tier's engine fields, the other documents and
    each request's tier equal; counts set to 0 just before, and the
    launches add up across both tiers' graphs. Then once more on the card
    with both tiers' steps eager, recording the logits (as on the CPU run):
    its streams equal the graphed run's, and each stream equals the CPU's
    up to the first step where they part, where the two devices' logits
    still agree within ``CASCADE_LOGIT_TOL`` (each device picks its own
    best logit; the partings are printed). (e) The same cascade at full
    width: smollm-360m (seeded random weights, bf16) in both tiers."""
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.obs import AuditLog, BurnRateMonitor, FleetSampler, Tracer
    from repro_torch.pipeline.scenario import (build_lmcascade,
                                               drive_lmcascade,
                                               pipeline_scenario)

    sc = pipeline_scenario()
    tiers = ("cascade.draft.", "cascade.verify.")
    out, docs, streams, rows = {}, {}, {}, {}
    # "card": the card once more with both tiers' steps eager, so that its
    # logits can be read (a graph's cannot)
    for tag, d in (("cpu", "cpu"), ("cuda", dev), ("card", dev)):
        # no step spans: their decode modes differ between the devices
        tr = Tracer(sample_rate=1.0, seed=sc.seed, engine=False)
        sa = FleetSampler(interval=0.05, monitor=BurnRateMonitor())
        au = AuditLog()
        casc, clock, params, pending = build_lmcascade(
            sc, tracer=tr, audit=au, device=d)
        if tag == "card":
            _eager(casc.draft)
            _eager(casc.verify)
        if tag == "cuda":
            _zero_counts()
        else:
            rows[tag], undo = _record_logits(casc)
        t0 = time.perf_counter()
        rep = drive_lmcascade(sc, casc, clock, params, pending, sampler=sa)
        wall = time.perf_counter() - t0
        streams[tag] = _streams(casc)
        if tag == "cuda":
            launches = _counts()
            _check_cascade_launches("lmcascade (reduced)", casc, launches,
                                    casc.draft.model.cfg.num_layers)
            out["reduced"] = dict(wall_s=wall, launches=launches,
                                  escalated=casc.escalated)
        else:
            undo()
        if tag == "cpu":
            out["cpu_wall_s"] = wall
        if tag != "card":
            docs[tag] = (rep, tr.to_json(), sa.to_json(), au.to_json(),
                         {c: r["tier"] for c, r in casc.results.items()})
    _expect_engine_diff("lmcascade (reduced)", docs["cuda"][0],
                        docs["cpu"][0], tiers)
    for k, what in enumerate(("span log", "time series", "audit doc",
                              "tiers"), 1):
        if docs["cuda"][k] != docs["cpu"][k]:
            raise AssertionError(f"lmcascade (reduced): the card's {what} "
                                 f"differs from the CPU's")
    if streams["card"] != streams["cuda"]:
        raise AssertionError("lmcascade (reduced): the eager steps' streams "
                             "differ from the graphed steps'")
    worst, parts = _stream_divergence("lmcascade (reduced)", streams["cuda"],
                                      streams["cpu"], rows)
    if worst > CASCADE_LOGIT_TOL:
        raise AssertionError(f"lmcascade (reduced): card vs CPU logits: max "
                             f"|diff| / max |logit| = {worst} > "
                             f"{CASCADE_LOGIT_TOL} before the streams part "
                             f"({parts})")
    out["reduced"].update(logit_rel_diff=worst, partings=parts)

    cfg = ARCHITECTURES["smollm-360m"]
    t0 = time.perf_counter()
    casc, clock, params, pending = build_lmcascade(sc, device=dev, cfg=cfg)
    build_s = time.perf_counter() - t0
    timed = _timed_tiers(casc)
    _zero_counts()
    t0 = time.perf_counter()
    rep = drive_lmcascade(sc, casc, clock, params, pending)
    wall = time.perf_counter() - t0
    launches = _counts()
    for name in ("rmsnorm", "decode_attention", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"lmcascade (full width): no {name} launch")
    _check_cascade_launches("lmcascade (full width)", casc, launches,
                            cfg.num_layers)
    for p in tiers:
        sec = rep["cascade"][p.split(".")[1]]
        if sec["engine"]["decode"]["graph"] is not True:
            raise AssertionError(f"lmcascade (full width): {p}engine."
                                 f"decode.graph is not true")
    if rep["queries"]["completed"] != sc.lm_requests or len(
            casc.results) != sc.lm_requests:
        raise AssertionError("lmcascade (full width): not every request "
                             "completed")
    per_tier = {}
    for tier in ("draft", "verify"):
        srv = getattr(casc, tier)
        toks = [t for r in srv.completed.values() for t in r.tokens]
        if any(not 0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"lmcascade (full width): a {tier} token "
                                 f"outside the vocabulary")
        g = timed[tier]["graph_ms"]
        per_tier[tier] = dict(
            served=len(srv.completed), tokens=len(toks),
            decode_steps=srv.decode_steps, graph_replays=srv.graph_replays,
            prefills=srv.prefill_dispatches,
            graph_ms_per_step=sum(g) / len(g), step_s=timed[tier]["step_s"],
            tokens_per_s=len(toks) / timed[tier]["step_s"])
    out["full"] = dict(build_s=build_s, wall_s=wall, launches=launches,
                       escalated=casc.escalated,
                       escalation_rate=rep["cascade"]["escalation_rate"],
                       requests=sc.lm_requests, tiers=per_tier)
    return out


def report_path(label, run, rungs, prof, parity, per_prefill, per_step,
                timing, tokens):
    log(f"{label} serve: {run['tokens']} tokens in {run['wall_s']:.3f} s "
        f"({run['tokens_per_s']:.1f} tok/s; the same requests with every "
        f"step eager {run['eager_tokens_per_s']:.1f} tok/s), "
        f"{run['decode_steps']} decode "
        f"steps ({run['graph_replays']} replayed from the CUDA graph) at "
        f"{run['decode_ms_per_step']:.3f} ms/step; "
        f"{run['prefill_dispatches']} prefill dispatches, per rung "
        f"{run['rung_dispatches']}")
    launches = run["launches"]
    steps, prefills = run["decode_steps"], run["prefill_dispatches"]
    log(f"{label} launches on its main path: {launches}; per decode step: "
        + ", ".join(f"{k} {launches[k] / steps}" for k in per_step)
        + "; per prefill: "
        + ", ".join(f"{k} {launches[k] / prefills}" for k in per_prefill)
        + f"; per decode step or prefill: rmsnorm "
        f"{launches['rmsnorm'] / (steps + prefills)}")
    log(f"{label} prefill ms per rung (B=8): "
        + ", ".join(f"{k}: {v:.3f}" for k, v in rungs.items()))
    e, g = timing["eager"], timing["graph"]
    eager_ms, graph_ms_ = sum(e) / len(e), sum(g) / len(g)
    log(f"{label} decode ms per step, 8 slots busy, same steps in turns "
        f"(eager, graph, graph, eager): eager {e}, graph {g}; mean eager "
        f"{eager_ms} ms, graph {graph_ms_} ms, eager / graph "
        f"{eager_ms / graph_ms_}")
    h = prof["host_split"]
    log(f"{label} host split of one eager decode step under the profiler: "
        f"wall {h['wall_ms']} ms; Python, model code and wrapper checks "
        f"{h['python_ms']} ms; aten dispatch outside runtime calls "
        f"{h['aten_ms']} ms ({h['aten_ops']} top-level aten ops); kernel "
        f"launch calls {h['launch_ms']} ms ({h['launch_calls']} calls); "
        f"other CUDA runtime calls {h['other_runtime_ms']} ms")
    for what, where in (("prefill", "B=8 prefill at rung 256"),
                        ("decode_eager", "eager decode step, 8 slots"),
                        ("decode", "graphed decode step, 8 slots")):
        p = prof[what]
        if p is None:
            log(f"{label} profiler, {where}: no device events in the trace "
                f"(not measured)")
            continue
        log(f"{label} profiler, {where}: {p['device_ops']} device ops "
            f"({p['kernels']} kernels), device busy {p['busy_ms']} ms")
    for what, wall in (("decode", run["decode_ms_per_step"]),
                       ("decode", graph_ms_), ("decode_eager", eager_ms),
                       ("prefill", rungs[256])):
        if prof[what] is not None:
            busy = prof[what]["busy_ms"]
            log(f"{label} {what}: device busy {busy} ms of {wall} ms "
                f"unprofiled, idle share {1 - busy / wall}")
    log(f"{label} streams, calibrated mode: {tokens}")
    log(f"{label} card vs CPU plain path: {parity}")


def phases(dev):
    """Every phase on ``dev``; returns the ``kernels`` list. Any failed check
    raises."""
    import torch
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.kernels import _build
    from repro_torch.models.api import build_model

    t0 = time.perf_counter()
    _build.build()
    log(f"build: CUDA kernels in {time.perf_counter() - t0:.1f} s")
    for src, text in sorted(_build.ptxas_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    t0 = time.perf_counter()
    cases = kernel_cases(dev)
    cases["ssd_scan"] = scan_cases(dev)
    floor = rmsnorm_floor(dev)
    log(f"kernels vs plain: {time.perf_counter() - t0:.1f} s")
    for kname, rows in cases.items():
        for r in rows:
            extra = (f" state_max_abs_err={r['state_max_abs_err']}"
                     if "state_max_abs_err" in r else "")
            log(f"  {kname} {r['case']}: max_abs_err={r['max_abs_err']}"
                f"{extra} ms={r['ms']} eager_ms={r['eager_ms']} "
                f"plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
                f"bound_ms={r['bound'][0]} ({r['bound'][1]})")
            if "geometry" in r:
                log(f"    launch: {r['geometry']}")
            if "planted" in r and kname == "ssd_scan":
                pl = r["planted"]
                log(f"    planted inputs: max_abs_err={pl['max_abs_err']} "
                    f"(largest |y| {pl['largest']}) state_max_abs_err="
                    f"{pl['state_max_abs_err']} (largest |state| "
                    f"{pl['state_largest']}), {pl['faults_caught']} emulated "
                    f"faults fail the check")
            elif "planted" in r:
                pl = r["planted"]
                log(f"    planted keys: max_abs_err={pl['max_abs_err']} "
                    f"(largest |output| {pl['largest']}), "
                    f"{pl['faults_caught']} planted faults fail the check")
            if kname == "ssd_scan":
                log(f"    kernel / bound = {r['ms'] / r['bound'][0]}")
        if kname == "rmsnorm":
            for pdl, f in floor.items():
                log(f"  rmsnorm launch floor, empty kernel of one block, "
                    f"pdl={pdl}: ms={f['ms']} eager_ms={f['eager_ms']}")
    for case, geo, ms in decode_sweep(dev):
        log(f"  decode_attention geometry sweep {case}: ms={ms}; {geo}")
    for case, ms in rmsnorm_sweep(dev):
        log(f"  rmsnorm geometry sweep {case}: ms={ms}")
    pg = rmsnorm_pdl_graph(dev)
    log(f"rmsnorm PDL under capture: {pg['links']} launches after a "
        f"torch.matmul in one CUDA graph, {pg['edges']} programmatic edges; "
        f"replay == eager bit for bit: {pg['equal']}")
    r = flash_host_split(dev)
    log(f"flash_attention eager call, host ms (B=2 Sq=512 Sk=2048 15/5 heads "
        f"D=64, {r['instance']} instance): call {r['call_ms']}, of it "
        f"allocation {r['alloc_ms']}, stream lookup {r['stream_ms']}, ctypes "
        f"launch {r['launch_ms']} (of it the two TMA tensor maps' encode "
        f"{r['encode_ms']}), wrapper Python {r['python_ms']}")
    for r in rmsnorm_host_split(dev):
        log(f"rmsnorm eager call, host ms (N=8 d=960 residual="
            f"{r['residual']}): call {r['call_ms']}, of it allocation "
            f"{r['alloc_ms']}, stream lookup {r['stream_ms']}, ctypes launch "
            f"{r['launch_ms']}, wrapper Python {r['python_ms']}")
    for kname in ("flash_attention", "decode_attention"):
        r = cases[kname][HEADLINE[kname]]
        ratio = (None if r["library_ms"] is None
                 else r["ms"] / r["library_ms"])
        log(f"{kname} at its headline shape ({r['case']}): kernel "
            f"{r['ms']} ms / library {r['library_ms']} ms = {ratio}")

    # the Clipper frontend stack, the contextual store, the scenario runner
    t0 = time.perf_counter()
    for r in frontend_scenarios(dev):
        log(f"frontend {r['name']}: card report == CPU report; "
            f"{r['queries']} queries, wall {r['card_ms']:.3f} ms on the "
            f"card, {r['cpu_ms']:.3f} ms on the CPU; policy-state "
            f"device-to-host copies {r['host_copies']} "
            f"({r['copies_per_query']} per query)")
    store = contextual_store(dev)
    for kind in ("exp4", "exp3"):
        r = store[kind]
        log(f"contextual store {1 << 20} x 4 fp32 ({store['bytes']} B) "
            f"{kind}: batch of 4096 users ({r['distinct_per_batch']}+ "
            f"distinct) {r['card_ms']:.4f} ms on the card, "
            f"{r['cpu_ms']:.4f} ms on the CPU; max |card - CPU| "
            f"{r['max_abs_err']} (largest |log-weight| "
            f"{r['max_abs_state']})")
    lm = scenario_lmserver(dev)
    for tag in ("reduced", "full"):
        r = lm[tag]
        log(f"scenario poisson lmserver ({tag}) on the card: "
            f"{r['wall_s']:.3f} s, {r['decode_steps']} decode steps "
            f"({r['graph_replays']} replayed from the graph), launches "
            f"{r['launches']}")
    log(f"scenario poisson lmserver on the CPU: {lm['cpu_wall_s']:.3f} s; "
        f"the card's report equals it but engine.attention_backend and "
        f"engine.decode.graph")
    log(f"scenario poisson lmserver, full width vs reduced: fields that "
        f"differ {lm['full_vs_reduced']}")
    log(f"frontend, store and scenario phases: "
        f"{time.perf_counter() - t0:.1f} s")

    # model composition and the control plane
    t0 = time.perf_counter()
    for r in pipelines_on_card(dev):
        log(f"pipeline {r['name']}: card report and span log == CPU's; "
            f"{r['queries']} pipeline queries, wall {r['card_ms']:.3f} ms "
            f"on the card, {r['cpu_ms']:.3f} ms on the CPU; policy-state "
            f"device-to-host copies {r['host_copies']} "
            f"({r['copies_per_query']} per pipeline query)")
    with tempfile.TemporaryDirectory() as tmp:
        crows = cluster_on_card(dev, Path(tmp))
    for r in crows:
        log(f"cluster.run flash_crowd {r['name']}: card documents == CPU's"
            f"{' but the engine fields' if r['launches'] else ''}; "
            f"{r['completed']} of {r['submitted']} completed, faults "
            f"{r['faults']}; wall {r['card_ms']:.3f} ms on the card, "
            f"{r['cpu_ms']:.3f} ms on the CPU"
            + (f"; launches {r['launches']}" if r["launches"] else ""))
    casc = lmcascade_on_card(dev)
    r = casc["reduced"]
    log(f"lmcascade (reduced) on the card: {r['wall_s']:.3f} s "
        f"(CPU {casc['cpu_wall_s']:.3f} s), {r['escalated']} escalated; "
        f"report == CPU's but each tier's engine fields, span log, time "
        f"series, audit doc and tiers == CPU's; streams == CPU's up to "
        f"the partings {r['partings']}, logits within "
        f"{r['logit_rel_diff']} of the largest until there; launches "
        f"{r['launches']}")
    f = casc["full"]
    log(f"lmcascade (full width smollm-360m, both tiers): build "
        f"{f['build_s']:.3f} s, drive {f['wall_s']:.3f} s; "
        f"{f['escalated']} of {f['requests']} escalated (rate "
        f"{f['escalation_rate']}); launches {f['launches']}")
    for tier, r in f["tiers"].items():
        log(f"lmcascade (full width) {tier}: {r['served']} served, "
            f"{r['tokens']} tokens, {r['prefills']} prefills, "
            f"{r['decode_steps']} decode steps ({r['graph_replays']} "
            f"replayed from its graph) at {r['graph_ms_per_step']:.3f} ms "
            f"per graphed step; {r['tokens_per_s']:.1f} tokens/s over "
            f"{r['step_s']:.3f} s of its steps")
    log(f"model composition and control plane phases: "
        f"{time.perf_counter() - t0:.1f} s")

    # the dense path: full-width smollm-360m
    t0 = time.perf_counter()
    cfg = ARCHITECTURES["smollm-360m"]
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    log(f"model: {cfg.name} full width, {cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e6:.1f} M params bf16")
    dense_kernels = ("rmsnorm", "decode_attention", "flash_attention")
    run = serve(model, params, dev, kernels=dense_kernels, max_len=256,
                max_prompt=200)
    rungs = prefill_rungs(model, params, dev, max_len=256)
    prof = device_profile(model, params, dev, max_len=256, max_prompt=200)
    timing = eager_vs_graph(model, params, dev, max_len=256, max_prompt=200)
    tokens = token_parity(model, params, dev, max_len=256, max_prompt=100,
                          reference=True)
    parity = cpu_parity(cfg, params, dev)
    report_path(cfg.name, run, rungs, prof, parity,
                per_prefill=("flash_attention",),
                per_step=("decode_attention",), timing=timing, tokens=tokens)
    log(f"{cfg.name} phases: {time.perf_counter() - t0:.1f} s")
    del model, params

    # the port's quickstart, as a user runs it on the card
    qrun = run_quickstart(dev)
    log(f"quickstart: {qrun['decode_steps']} decode steps in "
        f"{qrun['wall_s']:.3f} s; launches {qrun['launches']}")

    # the ssm path: full-width xlstm-125m; prefill runs an eager sLSTM time
    # loop (seconds at rung 512), so the prefill budget of AIMD admission
    # (slo * 0.5) is set above it
    t0 = time.perf_counter()
    xcfg = ARCHITECTURES["xlstm-125m"]
    xmodel = build_model(xcfg, device=dev)
    xparams = xmodel.init(torch.Generator(device=dev).manual_seed(0))
    log(f"model: {xcfg.name} full width, {xcfg.num_layers} layers "
        f"({xcfg.num_layers // 2} mLSTM/sLSTM pairs), "
        f"{sum(t.numel() for t in _leaves(xparams)) / 1e6:.1f} M params "
        f"(bf16, fp32 gates)")
    xrun = serve(xmodel, xparams, dev, kernels=("rmsnorm", "ssd_scan"),
                 max_len=512, max_prompt=480, slo=60.0)
    xrungs = prefill_rungs(xmodel, xparams, dev, max_len=512,
                           rungs=(8, 64, 256, 512))
    xprof = device_profile(xmodel, xparams, dev, max_len=512, max_prompt=480,
                           slo=60.0)
    xtiming = eager_vs_graph(xmodel, xparams, dev, max_len=512,
                             max_prompt=480, slo=60.0)
    xtokens = token_parity(xmodel, xparams, dev, max_len=512, max_prompt=100)
    xparity = cpu_parity(xcfg, xparams, dev, state=_xlstm_state)
    report_path(xcfg.name, xrun, xrungs, xprof, xparity,
                per_prefill=("ssd_scan",), per_step=(), timing=xtiming,
                tokens=xtokens)
    log(f"{xcfg.name} phases: {time.perf_counter() - t0:.1f} s")

    hcfg, hrun = hymba_phases(dev)
    ecfg, eruns = encdec_phases(dev)
    vcfg, vrun, vpre = vlm_phases(dev)
    mcfg, mrun = moe_phases(dev)

    kernels = []
    for kname, rows in cases.items():
        r = rows[HEADLINE[kname]]
        route, source = SOURCES[kname]
        by_path = {cfg.name: run["launches"][kname],
                   xcfg.name: xrun["launches"][kname],
                   hcfg.name: hrun["launches"][kname],
                   "quickstart": qrun["launches"][kname],
                   "scenario poisson lmserver":
                       lm["reduced"]["launches"][kname],
                   "scenario poisson lmserver, full width":
                       lm["full"]["launches"][kname],
                   "cluster lmserver, admission shed":
                       crows[-1]["launches"][kname],
                   "pipeline lmcascade": casc["reduced"]["launches"][kname],
                   "pipeline lmcascade, full width":
                       casc["full"]["launches"][kname],
                   f"{ecfg.name} S_enc 1024": eruns[1024]["launches"][kname],
                   f"{ecfg.name} S_enc 512": eruns[512]["launches"][kname],
                   f"{vcfg.name} text": vrun["launches"][kname],
                   f"{vcfg.name} prefixed": vpre["launches"][kname],
                   f"{mcfg.name} 4 layers": mrun["launches"][kname]}
        kernels.append(dict(
            name=kname, route=route, source=source, replaces=REPLACES[kname],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
            eager_ms=r["eager_ms"], case=r["case"],
            **({"launch_floor_ms": {("pdl" if p else "no_pdl"): f["ms"]
                                    for p, f in floor.items()}}
               if kname == "rmsnorm" else {}),
            cases=[dict(case=c["case"], max_abs_err=c["max_abs_err"],
                        **{k: c[k] for k in ("state_max_abs_err", "geometry")
                           if k in c},
                        ms=c["ms"], eager_ms=c["eager_ms"],
                        plain_ms=c["plain_ms"],
                        bound_ms=c["bound"][0], bound_by=c["bound"][1],
                        library_ms=c["library_ms"]) for c in rows]))
    return kernels


def hymba_phases(dev):
    """The hybrid path: full-width hymba-1.5b (32 layers: 3 global, 29
    sliding-window of 2048 with ring caches; parallel attention and SSD
    heads), every kernel on its path; returns (config, serve result)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.models.api import build_model

    t0 = time.perf_counter()
    cfg = ARCHITECTURES["hymba-1.5b"]
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    log(f"model: {cfg.name} full width, {cfg.num_layers} layers (global "
        f"{cfg.global_layers}, the rest a {cfg.window}-token window), "
        f"{sum(t.numel() for t in _leaves(params)) / 1e6:.1f} M params "
        f"(bf16, fp32 dt / decay / skip)")
    kernels = tuple(kernel_ops())
    # 16 prompts of 8-2040 tokens take the ladder (capped at the window's
    # rung); a 2035-token prompt wraps its rings while it decodes; the
    # 3072-token prompt takes the exact path, where the window binds
    run = serve(model, params, dev, kernels=kernels, max_len=3200,
                max_prompt=2040, slo=10.0, extra=(2035, 3072))
    if (1, 3072, False) not in run["prefill_shapes"]:
        raise AssertionError(f"the 3072-token prompt did not take the exact "
                             f"path: {run['prefill_shapes']}")
    if max(n for _, n, padded in run["prefill_shapes"]
           if padded) != cfg.window:
        raise AssertionError(f"the ladder does not end at the window's "
                             f"rung: {run['prefill_shapes']}")
    rungs = prefill_rungs(model, params, dev, max_len=3200,
                          rungs=(8, 256, 2048), exact=(3072,))
    prof = device_profile(model, params, dev, max_len=3200, max_prompt=2040,
                          slo=10.0)
    timing = eager_vs_graph(model, params, dev, max_len=3200,
                            max_prompt=2040, slo=10.0)
    tokens = token_parity(model, params, dev, max_len=3200, max_prompt=100,
                          reference=True)
    parity = cpu_parity(cfg, params, dev, state=_hymba_state, anchor=True)
    report_path(cfg.name, run, rungs, prof, parity,
                per_prefill=("flash_attention", "ssd_scan"),
                per_step=("decode_attention",), timing=timing, tokens=tokens)
    del model, params
    # the exact path past the window, card against CPU: 2 layers (one
    # global, one sliding-window) at full width, one 3072-token prompt
    lcfg = dataclasses.replace(cfg, num_layers=2, global_layers=(0,))
    lparams = build_model(lcfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(1))
    long = cpu_parity(lcfg, lparams, dev, state=_hymba_state, exact=3072,
                      tol_key=f"{cfg.name} long", anchor=True)
    log(f"{cfg.name} long path (2 layers, one exact 3072-token prompt and 8 "
        f"decode steps) card vs CPU plain path: {long}")
    log(f"{cfg.name} phases: {time.perf_counter() - t0:.1f} s")
    return cfg, run


# ---------------------------------------------------------------------------
# phases 10-12: the encdec, vlm and moe families at full width
# ---------------------------------------------------------------------------

def _park(model, params, dev, batch, *, max_len):
    """``model.prefill`` of ``batch`` (B <= 8 rows) moved into slots 0..B-1
    of an 8-slot ``LMServer`` by admission's own placement (``_place``:
    the first token sampled greedily, ``batched_scatter``, the slot
    state); the requests never finish on their own. The path the JAX
    package serves the encoder-decoder and the vision prefix by: prefill,
    scatter, the fused decode step."""
    import numpy as np
    from repro_torch.serving.engine import LMServer, Request

    srv = LMServer(model, device=dev, slots=8, max_len=max_len,
                   temperature=0.0, seed=0)
    logits, pcache = model.prefill(params, batch, max_len=max_len)
    B = logits.shape[0]
    srv._place([Request(i, np.zeros(0, np.int32), 1 << 30, 0.0)
                for i in range(B)], logits, pcache, list(range(B)),
               pcache["lengths"].cpu().numpy(), None)
    return srv


def slot_decode(model, params, dev, batch, *, max_len, kernels, steps=32):
    """The main path of a family the JAX package serves without
    ``LMServer``: prefill of ``batch`` -> ``batched_scatter`` into 8 slots
    -> the fused decode step, eager once, then captured in a CUDA graph
    and replayed, ``steps`` steps. Every count of ``kernels`` is set to 0
    just before the prefill and must have risen just after the last step.
    The same with the step eager every time: the streams must be equal.
    Returns the counts, ms per step (host clock, each step ending in its
    host copy), the streams' tokens and the graphed server (step
    captured)."""
    import torch

    def run(graph):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv = _park(model, params, dev, batch, max_len=max_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if not graph:
            _eager(srv)
        t0 = time.perf_counter()
        for _ in range(steps):
            srv._decode_once(params)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        return srv, prefill_s, step_s

    run(True)                          # warm-up: cuBLAS, allocator
    _zero_counts()
    srv, prefill_s, step_s = run(True)
    launches = _counts()
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no kernel launch on the main path")
    if srv.graph_replays != steps - 1:
        raise AssertionError(f"{srv.graph_replays} graph replays in {steps} "
                             f"decode steps")
    eager, _, eager_s = run(False)
    streams = [r.tokens for _, r in sorted(srv._active.items())]
    if streams != [r.tokens for _, r in sorted(eager._active.items())]:
        raise AssertionError("graphed and eager streams differ")
    width = model.cfg.padded(1).vocab_size
    if any(len(t) != steps + 1 or not all(0 <= x < width for x in t)
           for t in streams):
        raise AssertionError("a stream is short or leaves the head's ids")
    return dict(launches=launches, prefill_ms=1e3 * prefill_s,
                graph_ms_per_step=1e3 * step_s / steps,
                eager_ms_per_step=1e3 * eager_s / steps,
                graph_replays=srv.graph_replays, srv=srv,
                slots=len(streams))


def report_slots(label, run, prof, timing):
    """Log a ``slot_decode`` run with its profile and timing turns."""
    log(f"{label} prefill -> scatter -> fused decode: {run['slots']} slots, "
        f"prefill {run['prefill_ms']:.3f} ms (with the scatter), "
        f"{run['graph_replays']} replays at {run['graph_ms_per_step']:.3f} "
        f"ms/step (eager every step {run['eager_ms_per_step']:.3f} ms/step);"
        f" graphed and eager streams equal; launches {run['launches']}")
    e, g = timing["eager"], timing["graph"]
    eager_ms, graph_ms_ = sum(e) / len(e), sum(g) / len(g)
    log(f"{label} decode ms per step, same steps in turns (eager, graph, "
        f"graph, eager): eager {e}, graph {g}; mean eager {eager_ms} ms, "
        f"graph {graph_ms_} ms, eager / graph {eager_ms / graph_ms_}")
    for what, wall in (("prefill", run["prefill_ms"]),
                       ("decode_eager", eager_ms), ("decode", graph_ms_)):
        p = prof[what]
        if p is None:
            log(f"{label} profiler {what}: no device events in the trace "
                f"(not measured)")
            continue
        log(f"{label} profiler {what}: {p['device_ops']} device ops "
            f"({p['kernels']} kernels), device busy {p['busy_ms']} ms of "
            f"{wall} ms unprofiled, idle share {1 - p['busy_ms'] / wall}")


def slot_profile(model, params, dev, batch, srv, *, max_len, steps=4):
    """The prefill of ``batch`` and ``steps`` decode steps of ``srv`` (its
    step captured), eager and graphed, under ``torch.profiler``."""
    _eager(srv)
    eager = _traced(srv._decode_once, params, steps)
    _graphed(srv)
    return dict(prefill=_traced(lambda p: model.prefill(p, batch,
                                                        max_len=max_len),
                                params, 1),
                decode_eager=eager,
                decode=_traced(srv._decode_once, params, steps))


def encdec_phases(dev):
    """The encoder-decoder path: full-width seamless-m4t-medium (12 + 12
    layers, 16 / 16 heads of 64). ``model.prefill`` over seeded fp32
    frames [8, 1024, 1024] and decoder prompts of 8-128 tokens on the
    ladder -> 8 slots of max_len 1024 -> the fused decode step, graphed;
    again with frames of 512 rows (the memory padded into the 1024-row
    slot cache: its zero rows are attended, as in the reference); prefill
    ms per decoder rung; the profile; eager against graphed ms per step;
    card against the CPU on 64 frames."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.core.batching import bucket, prompt_length_ladder
    from repro_torch.models.api import build_model

    t0 = time.perf_counter()
    cfg = ARCHITECTURES["seamless-m4t-medium"]
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    d, max_len = cfg.d_model, 1024
    log(f"model: {cfg.name} full width, {cfg.num_layers} + "
        f"{cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e6:.1f} M params bf16")
    gen = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(0)

    def frames(B, S):
        return torch.randn((B, S, d), generator=gen, device=dev)

    lens = rng.integers(8, 129, size=8)
    rung = bucket(int(lens.max()), ladder=prompt_length_ladder(max_len))
    toks = np.zeros((8, rung), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
    text = {"tokens": torch.from_numpy(toks).to(dev),
            "lengths": torch.from_numpy(lens.astype(np.int32)).to(dev)}
    kernels = ("rmsnorm", "decode_attention", "flash_attention")
    out = {}
    for S_enc in (1024, 512):
        batch = dict(text, frames=frames(8, S_enc))
        run = slot_decode(model, params, dev, batch, max_len=max_len,
                          kernels=kernels)
        srv = run.pop("srv")
        if tuple(srv.cache["ck"].shape)[2] != max_len:
            raise AssertionError("the memory is not in a max_len slot cache")
        if S_enc < max_len and srv.cache["ck"][:, :, S_enc:].any():
            raise AssertionError("the padded memory rows are not zero")
        prof = slot_profile(model, params, dev, batch, srv, max_len=max_len)
        timing = _turns(srv, params)
        report_slots(f"{cfg.name} S_enc={S_enc} decoder rung {rung}", run,
                     prof, timing)
        out[S_enc] = run
        del srv
    rungs = prefill_rungs(model, params, dev, max_len=max_len,
                          rungs=(8, 32, 128),
                          extra=lambda B: {"frames": frames(B, 1024)})
    log(f"{cfg.name} prefill ms per decoder rung (B=8, frames of 1024): "
        + ", ".join(f"{k}: {v:.3f}" for k, v in rungs.items()))
    parity = cpu_parity(cfg, params, dev, extra=lambda r, B: {
        "frames": r.normal(size=(B, 64, d)).astype(np.float32)})
    log(f"{cfg.name} card vs CPU plain path (64 frames, prompts of 64 and "
        f"37, 8 decode steps): {parity}")
    log(f"{cfg.name} phases: {time.perf_counter() - t0:.1f} s")
    return cfg, out


def vlm_phases(dev):
    """The vision-prefixed path: full-width internvl2-1b (24 layers, 14 / 2
    heads of 64). (a) Text through ``LMServer``, as the reference serves
    the family (phases 3-6 at max_len 256); (b) prefixed: 1024 seeded
    prefix rows + 1024 text tokens, B = 4 (S = 2048) -> slots of max_len
    2112 -> the fused decode step, graphed; card against the CPU with 64
    prefix rows."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.models.api import build_model

    t0 = time.perf_counter()
    cfg = ARCHITECTURES["internvl2-1b"]
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    d, P = cfg.d_model, cfg.num_prefix_embeddings
    log(f"model: {cfg.name} full width, {cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e6:.1f} M params bf16")
    kernels = ("rmsnorm", "decode_attention", "flash_attention")
    run = serve(model, params, dev, kernels=kernels, max_len=256,
                max_prompt=200)
    rungs = prefill_rungs(model, params, dev, max_len=256)
    prof = device_profile(model, params, dev, max_len=256, max_prompt=200)
    timing = eager_vs_graph(model, params, dev, max_len=256, max_prompt=200)
    tokens = token_parity(model, params, dev, max_len=256, max_prompt=100)
    parity = cpu_parity(cfg, params, dev)
    report_path(f"{cfg.name} text", run, rungs, prof, parity,
                per_prefill=("flash_attention",),
                per_step=("decode_attention",), timing=timing, tokens=tokens)
    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, size=(4, 1024)).astype(np.int32)).to(dev),
             "prefix_embeddings": torch.randn((4, P, d), generator=gen,
                                              device=dev)}
    pre = slot_decode(model, params, dev, batch, max_len=2112,
                      kernels=kernels)
    srv = pre.pop("srv")
    if srv.lengths.tolist()[:4] != [P + 1024 + 32] * 4:
        raise AssertionError(f"prefixed slot lengths {srv.lengths.tolist()}")
    pprof = slot_profile(model, params, dev, batch, srv, max_len=2112)
    ptiming = _turns(srv, params)
    report_slots(f"{cfg.name} prefixed ({P} prefix rows + 1024 tokens, B=4)",
                 pre, pprof, ptiming)
    del srv
    pparity = cpu_parity(cfg, params, dev, lens=(64, 64),
                         tol_key=f"{cfg.name} prefixed",
                         extra=lambda r, B: {"prefix_embeddings": r.normal(
                             size=(B, 64, d)).astype(np.float32)})
    log(f"{cfg.name} prefixed card vs CPU plain path (64 prefix rows + 64 "
        f"tokens, B=2, 8 decode steps): {pparity}")
    log(f"{cfg.name} phases: {time.perf_counter() - t0:.1f} s")
    return cfg, run, pre


def moe_phases(dev):
    """The mixture-of-experts path: dbrx-132b at full width (d_model 6144,
    48 / 8 heads of 128, 16 experts top-4, d_ff 10752), depth cut from 40
    to 4 layers (the 40 do not fit in 80 GB). 16 requests of 32-256 tokens
    through ``LMServer`` in same-length groups (no ladder: padding would
    compete for capacity), phases 3-6 at max_len 512; card against the CPU
    cut to 1 layer (2 prompts of 16 tokens, 4 decode steps, the routing
    held to the router near-tie rule, ``cpu_parity(routing=True)``)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.models.api import build_model

    t0 = time.perf_counter()
    full = ARCHITECTURES["dbrx-132b"]
    cfg = dataclasses.replace(full, num_layers=4)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    log(f"model: {cfg.name} full width, {cfg.num_layers} of "
        f"{full.num_layers} layers, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok}, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B params "
        f"(bf16, fp32 router); init {time.perf_counter() - t0:.1f} s")
    kernels = ("rmsnorm", "decode_attention", "flash_attention")
    if model.extras["prompt_pad"]:
        raise AssertionError("moe prompts must not take the ladder")
    run = serve(model, params, dev, kernels=kernels, max_len=512,
                max_prompt=256, lengths=(32, 64, 128, 256), slo=5.0)
    if any(padded for _, _, padded in run["prefill_shapes"]):
        raise AssertionError(f"a moe prefill was padded: "
                             f"{run['prefill_shapes']}")
    rungs = prefill_rungs(model, params, dev, max_len=512,
                          rungs=(32, 64, 128, 256), padded=False)
    prof = device_profile(model, params, dev, max_len=512, max_prompt=256,
                          slo=5.0)
    timing = eager_vs_graph(model, params, dev, max_len=512, max_prompt=256,
                            slo=5.0)
    tokens = token_parity(model, params, dev, max_len=512, max_prompt=64,
                          reference=True)
    del params
    torch.cuda.empty_cache()
    one = dataclasses.replace(full, num_layers=1)
    oparams = build_model(one, device=dev).init(
        torch.Generator(device=dev).manual_seed(1))
    parity = cpu_parity(one, oparams, dev, lens=(16, 16), steps=4,
                        tol_key=f"{cfg.name} 1 layer", routing=True)
    del oparams
    report_path(f"{cfg.name} 4 layers", run, rungs, prof, parity,
                per_prefill=("flash_attention",),
                per_step=("decode_attention",), timing=timing, tokens=tokens)
    log(f"{cfg.name} phases: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return cfg, run


# ---------------------------------------------------------------------------
# phase 13: training on the card
# ---------------------------------------------------------------------------

# card vs CPU plain path, one training step on the same weights and batch:
# the loss within LOSS_TOL; each gradient leaf within GRAD_ROUNDINGS bf16
# roundings (2**-8) of the CPU leaf's largest |g| (cuBLAS and the CPU's
# GEMMs sum in other orders, so cotangents round apart, as the port's and
# the reference's do on the CPU: tests/test_torch_train_parity.py, up to 3.9
# roundings at narrow widths; seen on an H100: smollm-360m cut to 2 layers
# 3.1). A leaf past that is held to an fp32 run on the CPU (the same
# weights upcast): the card may be at most ANCHOR_RATIO times as far from it
# as the CPU's bf16 path, which is where a recurrence amplifies rounding on
# both devices alike (seen: xlstm-125m's sLSTM input weights, 13.1
# roundings apart after 128 steps of the time loop, at 0.99 times the CPU's
# distance from fp32). One AdamW step on the
# same fp32 gradients: master, m, v within OPT_RTOL of each leaf's largest
# magnitude (the global grad norm sums in another order), bf16 params also
# within one bf16 rounding of the value
LOSS_TOL = 0.01
GRAD_ROUNDINGS = 8
OPT_RTOL = 5e-6


def _grad_gaps(card, cpu):
    """{path: max |card - cpu| in bf16 roundings of the CPU leaf's largest
    |g|} over two trees of gradients; raises on a non-finite card leaf."""
    import torch
    from repro_torch.tree import flatten_with_paths

    want = dict(flatten_with_paths(cpu))
    out = {}
    for path, g in flatten_with_paths(card):
        if not torch.isfinite(g).all():
            raise AssertionError(f"gradient {path}: non-finite on the card")
        w = want[path].float()
        out[path] = float((g.float().cpu() - w).abs().max()
                          / (w.abs().max().clamp_min(1e-30) * 2.0 ** -8))
    return out


def _opt_gap(card, cpu):
    """The worst leaf of an optimizer result on the card against the CPU's
    (16g: the ranks' blocks against the one device's, on the host), over
    its largest magnitude; bf16 leaves may also differ by one bf16
    rounding of the value."""
    import torch
    from repro_torch.tree import flatten_with_paths

    want = dict(flatten_with_paths(cpu))
    worst = 0.0
    for path, v in flatten_with_paths(card):
        w = want[path].float()
        err = (v.float().cpu() - w).abs()
        scale = w.abs().max().clamp_min(1e-30)
        if v.dtype == torch.bfloat16:
            err = (err - 2.0 ** -7 * w.abs()).clamp_min(0)
        r = float(err.max() / scale)
        if r > OPT_RTOL:
            raise AssertionError(f"optimizer {path}: {r} of its largest "
                                 f"magnitude off (limit {OPT_RTOL})")
        worst = max(worst, r)
    return worst


def train_parity(cfg, dev, *, seq, batch, label, seed=0):
    """One ``loss_fn`` + backward (``_accumulate``, 1 microbatch) and one
    AdamW step, on the card and on the CPU's plain path, the same weights
    (initialised on the CPU, copied bit for bit) and the same
    ``SyntheticLMData`` batch. The card launches no kernel; loss, each
    gradient leaf and the AdamW state are held to LOSS_TOL, GRAD_ROUNDINGS
    (a leaf past it to ANCHOR_RATIO against an fp32 run) and OPT_RTOL."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.grad_compress import _accumulate

    t0 = time.perf_counter()
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(seed))
    n_params = sum(t.numel() for t in _leaves(params))
    data = SyntheticLMData(cfg, ShapeSpec("t", seq, batch, "train"),
                           seed=seed).batch_at(0)
    cpu_batch = {k: torch.from_numpy(v) for k, v in data.items()}
    card_params = _tree_to(params, dev)
    card_batch = _tree_to(cpu_batch, dev)
    _zero_counts()
    loss, grads = _accumulate(build_model(cfg, device=dev).loss_fn,
                              card_params, card_batch, 1)
    torch.cuda.synchronize()
    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"{label}: a training step launched kernels: "
                             f"{launches}")
    cpu_loss, cpu_grads = _accumulate(cpu_model.loss_fn, params, cpu_batch,
                                      1)
    rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    if not rel <= LOSS_TOL:
        raise AssertionError(f"{label}: loss {float(loss)} on the card, "
                             f"{float(cpu_loss)} on the CPU")
    gaps = _grad_gaps(grads, cpu_grads)
    over = sorted(p for p, r in gaps.items() if r > GRAD_ROUNDINGS)
    anchored = {}
    if over:
        from repro_torch.tree import flatten_with_paths
        f32_model = build_model(cfg, device="cpu", dtype=torch.float32)
        _, f32_grads = _accumulate(f32_model.loss_fn,
                                   _tree_to(params, torch.float32),
                                   cpu_batch, 1)
        trees = [dict(flatten_with_paths(t))
                 for t in (grads, cpu_grads, f32_grads)]
        for path in over:
            card_g, cpu_g, f32_g = (t[path].float().cpu() for t in trees)
            ratio = float((card_g - f32_g).abs().max()
                          / (cpu_g - f32_g).abs().max().clamp_min(1e-30))
            if ratio > ANCHOR_RATIO:
                raise AssertionError(
                    f"{label} gradient {path}: card vs CPU {gaps[path]} "
                    f"bf16 roundings (limit {GRAD_ROUNDINGS}), and {ratio} "
                    f"times as far from the fp32 run as the CPU's bf16 path "
                    f"(limit {ANCHOR_RATIO})")
            anchored[path] = (gaps[path], ratio)
        del f32_grads
    del grads
    worst = max(gaps, key=gaps.get)
    cpu_new = opt_lib.adamw_update(cpu_grads, opt_lib.adamw_init(params),
                                   params, lr=1e-3)
    card_new = opt_lib.adamw_update(_tree_to(cpu_grads, dev),
                                    opt_lib.adamw_init(card_params),
                                    card_params, lr=1e-3)
    opt_gap = max(_opt_gap(card_new[0], cpu_new[0]),
                  _opt_gap(card_new[1][1:], cpu_new[1][1:]))
    out = dict(params=n_params, loss_card=float(loss),
               loss_cpu=float(cpu_loss), loss_rel=rel,
               grad_roundings=gaps[worst], grad_leaf=worst,
               anchored=anchored, adamw_rel=opt_gap, launches=launches,
               s=time.perf_counter() - t0)
    del card_params, card_new
    torch.cuda.empty_cache()
    return out


def train_smollm(dev, tmp):
    """Full-width smollm-360m through ``repro_torch.launch.train``'s code
    path at the reference launcher's defaults (batch 32, seq 256, 2
    microbatches, AdamW, lr 1e-3, warmup max(5, steps // 20), remat
    ``"full"``) for 12 steps, timed per step; then 6 steps with a
    checkpoint at 6 and a fresh ``train`` that resumes from it to 12. All
    of it under ``torch.use_deterministic_algorithms(True)`` (the embedding
    and gather backward otherwise add with atomics, in any order): the
    resumed run's loss, params and optimizer state must equal the
    uninterrupted run's bit for bit. One more step is traced; the launch
    counts stay 0 throughout."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.data.pipeline import data_iter
    from repro_torch.launch.roofline import PEAK_FLOPS
    from repro_torch.models.api import build_model
    from repro_torch.training.train_loop import (
        TrainConfig, make_train_step, train,
    )
    from repro_torch.tree import leaves

    cfg = ARCHITECTURES["smollm-360m"]
    steps, B, S = 12, 32, 256
    half = steps // 2
    shape = ShapeSpec("cli", S, B, "train")
    model = build_model(cfg, device=dev)
    tc = TrainConfig(lr=1e-3, warmup_steps=max(5, steps // 20),
                     total_steps=steps, num_microbatches=2)
    stamps, losses = [], {}

    def on_log(m):
        stamps.append(time.perf_counter())
        losses[m["step"]] = m["loss"]

    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        stamps.append(time.perf_counter())
        straight = train(model, tc, data_iter(cfg, shape), num_steps=steps,
                         log_every=1, hooks={"on_log": on_log})
        peak = torch.cuda.max_memory_allocated()
        ms = np.diff(stamps) * 1e3                 # ms of step 1 .. steps
        t_ckpt = time.perf_counter()
        first = train(model, tc, data_iter(cfg, shape), num_steps=half,
                      checkpoint_dir=str(tmp), checkpoint_every=half,
                      log_every=half)
        resumed = train(model, tc, data_iter(cfg, shape, start_step=half),
                        num_steps=steps, checkpoint_dir=str(tmp),
                        log_every=half)
        t_ckpt = time.perf_counter() - t_ckpt
        launches = _counts()
    finally:
        torch.use_deterministic_algorithms(False)
    if any(launches.values()):
        raise AssertionError(f"training launched kernels: {launches}")
    if not losses[steps] < losses[1]:
        raise AssertionError(f"loss did not fall: {losses[1]} -> "
                             f"{losses[steps]}")
    if (Checkpointer(str(tmp)).steps() != [half, steps]
            or [h["step"] for h in first["history"]] != [half]
            or [h["step"] for h in resumed["history"]] != [steps]
            or resumed["history"][0]["loss"] != losses[steps]):
        raise AssertionError(f"checkpoint/resume: {first['history']}, "
                             f"{resumed['history']}")
    mismatched = [i for i, (a, b) in enumerate(zip(
        leaves((straight["params"], straight["opt_state"])),
        leaves((resumed["params"], resumed["opt_state"]))))
        if not torch.equal(a, b)]
    if mismatched:
        raise AssertionError(f"resumed run differs from the uninterrupted "
                             f"one in {len(mismatched)} leaves")
    n_params = sum(t.numel() for t in leaves(straight["params"]))
    # the same step without deterministic algorithms (which fill every new
    # buffer and take the sort-based index backward), timed and traced
    step_fn, _ = make_train_step(model, tc)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(data_iter(cfg, shape)).items()}
    p, o = straight["params"], straight["opt_state"]
    free_ms = []
    for _ in range(8):
        t1 = time.perf_counter()
        p, o, m = step_fn(p, o, batch)
        float(m["loss"])
        free_ms.append((time.perf_counter() - t1) * 1e3)
    prof = _traced(lambda q: step_fn(q, o, batch), p, 1)
    if any(_counts().values()):
        raise AssertionError(f"training launched kernels: {_counts()}")
    del p, o
    steady = ms[4:]                                # steps 5 .. steps
    med = float(np.median(steady))
    tokens = B * S
    resumed_losses = [h["loss"] for h in resumed["history"]]
    del straight, resumed, first
    torch.cuda.empty_cache()
    return dict(cfg=cfg, n_params=n_params, ms=ms.tolist(), median_ms=med,
                spread_ms=(float(np.percentile(steady, 25)),
                           float(np.percentile(steady, 75)),
                           float(steady.min()), float(steady.max())),
                tokens_per_s=tokens / med * 1e3,
                model_tflops=6 * n_params * tokens / med / 1e9,
                remat_tflops=2 * n_params * tokens / med / 1e9,
                mfu=6 * n_params * tokens / med * 1e3 / PEAK_FLOPS,
                mfu_remat=8 * n_params * tokens / med * 1e3
                / PEAK_FLOPS,
                peak_bytes=peak, losses=(losses[1], losses[half],
                                         losses[steps]),
                resumed_losses=resumed_losses,
                profile=prof, launches=launches,
                ckpt_s=t_ckpt, free_ms=float(np.median(free_ms[2:])),
                free_mfu=6 * n_params * tokens / float(np.median(
                    free_ms[2:])) * 1e3 / PEAK_FLOPS,
                free_spread_ms=(min(free_ms[2:]), max(free_ms[2:])))


def training_phases(dev):
    """Phase 13: full-width smollm-360m trained 12 steps with a checkpoint
    and a resume, the launcher, and every family's training step on the
    card against the CPU."""
    import dataclasses

    from repro_torch.configs.registry import ARCHITECTURES, reduced_config
    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = train_smollm(dev, Path(tmp))
    log(f"train smollm-360m runs: {time.perf_counter() - t0:.1f} s")
    sp = r["spread_ms"]
    log(f"train {r['cfg'].name} full width ({r['n_params'] / 1e6:.1f} M "
        f"params, untied head), batch 32 x seq 256, 2 microbatches, AdamW, "
        f"remat full, deterministic algorithms: ms per step (steps 5-12) "
        f"median {r['median_ms']:.2f}, quartiles {sp[0]:.2f}-{sp[1]:.2f}, "
        f"range {sp[2]:.2f}-{sp[3]:.2f}; {r['tokens_per_s']:.0f} tokens/s")
    log(f"train {r['cfg'].name}: model FLOP/s 6*N*tokens/time "
        f"{r['model_tflops']:.1f} TFLOP/s = MFU {r['mfu']:.4f} of 989; the "
        f"remat recompute adds 2*N*tokens/time {r['remat_tflops']:.1f} "
        f"TFLOP/s ({r['mfu_remat']:.4f} with it)")
    log(f"train {r['cfg'].name}: peak memory "
        f"{r['peak_bytes'] / 2**30:.2f} GiB (max_memory_allocated); loss "
        f"step 1 {r['losses'][0]:.4f}, step 6 {r['losses'][1]:.4f}, step 12 "
        f"{r['losses'][2]:.4f}; resumed from the step-6 checkpoint: losses "
        f"{r['resumed_losses']}, params and AdamW state == the "
        f"uninterrupted run's bit for bit (6 steps, 2 checkpoint writes "
        f"and a restore: {r['ckpt_s']:.1f} s); launches {r['launches']}")
    fm = r["free_ms"]
    log(f"train {r['cfg'].name} without deterministic algorithms: ms per "
        f"step (6 steps) median {fm:.2f}, range "
        f"{r['free_spread_ms'][0]:.2f}-{r['free_spread_ms'][1]:.2f}; "
        f"{32 * 256 / fm * 1e3:.0f} tokens/s; MFU (6N) {r['free_mfu']:.4f}")
    p = r["profile"]
    if p is None:
        log(f"train {r['cfg'].name} profiler: no device events in the trace "
            f"(not measured)")
    else:
        log(f"train {r['cfg'].name} profiler, one step without "
            f"deterministic algorithms: {p['device_ops']} device ops "
            f"({p['kernels']} kernels), device busy {p['busy_ms']:.2f} ms of "
            f"{fm:.2f} ms unprofiled, idle share "
            f"{1 - p['busy_ms'] / fm:.4f}")
    log(f"train per-step ms (steps 1-12): {[round(x, 2) for x in r['ms']]}")
    # the launcher itself, as a user runs it, reduced
    t1 = time.perf_counter()
    _zero_counts()
    out = launch_train.main(["--arch", "smollm-360m", "--reduced",
                             "--steps", "20", "--device", str(dev)])
    h = out["history"]
    if not h[-1]["loss"] < h[0]["loss"] or any(_counts().values()):
        raise AssertionError(f"launch.train: {h}, launches {_counts()}")
    log(f"python -m repro_torch.launch.train --reduced --steps 20: "
        f"{time.perf_counter() - t1:.1f} s, loss {h[0]['loss']:.4f} -> "
        f"{h[-1]['loss']:.4f}")
    del out
    # every family's training step, card against the CPU
    smollm = ARCHITECTURES["smollm-360m"]
    hymba = ARCHITECTURES["hymba-1.5b"]
    cases = [
        ("smollm-360m 2 layers", dataclasses.replace(smollm, num_layers=2),
         64, 2),
        ("xlstm-125m", ARCHITECTURES["xlstm-125m"], 64, 2),
        ("hymba-1.5b 2 layers (one global, one windowed)",
         dataclasses.replace(hymba, num_layers=2, global_layers=(0,)),
         256, 2),
        ("seamless-m4t-medium 2 + 2 layers",
         dataclasses.replace(ARCHITECTURES["seamless-m4t-medium"],
                             num_layers=2), 128, 2),
        ("internvl2-1b 2 layers, 1024 prefix rows",
         dataclasses.replace(ARCHITECTURES["internvl2-1b"], num_layers=2),
         1024 + 32, 2),
        ("dbrx-132b reduced_config", reduced_config(
            ARCHITECTURES["dbrx-132b"]), 64, 4),
    ]
    log("dbrx-132b trains at reduced_config width here: one full-width "
        "layer with AdamW state is about 4.5 B parameters x 18 bytes, more "
        "than the card's 80 GB")
    for label, cfg, seq, batch in cases:
        q = train_parity(cfg, dev, seq=seq, batch=batch, label=label)
        log(f"train step card vs CPU, {label} ({q['params'] / 1e6:.1f} M "
            f"params, batch {batch} x seq {seq}): loss {q['loss_card']:.6f} "
            f"card, {q['loss_cpu']:.6f} CPU (rel {q['loss_rel']:.2e}); worst "
            f"gradient leaf {q['grad_leaf']} at {q['grad_roundings']:.2f} "
            f"bf16 roundings of its largest |g| (limit {GRAD_ROUNDINGS}; "
            f"held to the fp32 run instead, (roundings, distance ratio): "
            f"{q['anchored']}); AdamW on the same grads within "
            f"{q['adamw_rel']:.2e}; launches "
            f"{q['launches']}; {q['s']:.1f} s")
    log(f"training phases: {time.perf_counter() - t0:.1f} s")
    return r


# ---------------------------------------------------------------------------
# phase 14: the launch tooling: the dry run of every cell, and four of the
# reference's own cells through launch.steps on the card
# ---------------------------------------------------------------------------

# the dry run's estimate (arguments + peak of live bytes beyond them) may be
# below the card's max_memory_allocated by at most this share: an estimate
# that says "fits" and then runs out of memory is the failure that matters
PEAK_SLACK = 1.25
# a measured step may not beat its ideal time by more than this (that would
# mean a count or a clock is wrong)
FRACTION_LIMIT = 1.05
# (arch, registry shape, cut batch or None, steps timed, kernels that must
# launch). hymba x long_500k runs its full shape; smollm's decode_32k is cut
# from 128 to 32 slots (its cache alone would need 172 GB); prefill_32k runs
# 32 prompts if the dry run says that fits the card's free memory, else the
# largest power of two that does; train_4k is cut from 256 to 16 sequences
LAUNCH_CELLS = (
    ("hymba-1.5b", "long_500k", None, 8, ("rmsnorm", "decode_attention")),
    ("smollm-360m", "decode_32k", 32, 8, ("rmsnorm", "decode_attention")),
    ("smollm-360m", "prefill_32k", None, 1, ("rmsnorm", "flash_attention")),
    ("smollm-360m", "train_4k", 16, 2, ()),
)


# the dry run's sweeps, each in a process of its own: one device, and a
# counting rank of each production mesh (--mesh single, multi)
DRYRUN_MESHES = ("one", "single", "multi")


def start_dryrun(out_dir):
    """``python -m repro_torch.launch.dryrun`` over all 32 cells, on meta, in
    the background (its CPU time overlaps the card's phases), three sweeps
    side by side: ``--mesh one``, ``single`` and ``multi``; the card is
    hidden from them, so they take the 80 GB default capacity. -> {mesh:
    process}."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = {}
    try:
        for mesh in DRYRUN_MESHES:
            with open(Path(out_dir) / f"dryrun_{mesh}.log", "w") as log_file:
                procs[mesh] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--mesh", mesh, "--out", str(out_dir), "--force"],
                    cwd=ROOT, env=env, stdout=log_file,
                    stderr=subprocess.STDOUT)
    except BaseException:
        stop_dryrun(procs)
        raise
    return procs


def stop_dryrun(procs):
    """Kill whichever sweeps still run."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def collect_dryrun(procs, out_dir, timeout=900):
    """The 96 records of the background sweeps, by mesh; fails unless all
    three exited 0 with every record ``ok``."""
    from repro_torch.configs.registry import all_cells
    deadline = time.monotonic() + timeout
    cells = {(c.name, s.name) for c, s in all_cells()}
    out, bad = {}, []
    for mesh, proc in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            stop_dryrun(procs)
            raise AssertionError(f"the dry run (--mesh {mesh}) did not end "
                                 f"in {timeout} s")
        recs = [json.loads(p.read_text()) for p in sorted(
            (Path(out_dir) / "baseline").glob(f"*__{mesh}.json"))]
        failed = [(r["arch"], r["shape"]) for r in recs if not r.get("ok")]
        if rc or failed or {(r["arch"], r["shape"]) for r in recs} != cells:
            text = (Path(out_dir) / f"dryrun_{mesh}.log").read_text()
            bad.append(f"--mesh {mesh}: exit {rc}, {len(recs)} records, "
                       f"failed {failed}\n{text[-3000:]}")
        out[mesh] = recs
    if bad:
        raise AssertionError("dry run: " + "\n".join(bad))
    return out


def dryrun_table(recs):
    """One row per cell: the fit for one 80 GB card and the roofline terms."""
    from repro_torch.launch import roofline
    log("dry run, 32 cells at full width on meta (1 device, capacity 80 GB): "
        "arch | shape | args GB | peak GB (args + temp) | fits | dot TFLOP "
        "(bf16, f32) | kernel TFLOP | T_compute ms | T_memory ms | dominant "
        "| model TFLOP | ideal GB | ideal ms | fraction (ideal / bound) | "
        "extrapolated | trace s")
    for r in recs:
        c = roofline.cell_from_record(r)
        ma, hlo = r["memory_analysis"], r["hlo"]
        by = hlo["dot_flops_by_dtype"]
        kern = sum(n for w in hlo["kernel_work"].values()
                   for n in w["flops"].values())
        log(f"  {r['arch']} | {r['shape']} | {ma['argument_bytes'] / 1e9:.3f}"
            f" | {(ma['argument_bytes'] + ma['temp_bytes']) / 1e9:.3f} | "
            f"{r['fits']} | {hlo['dot_flops'] / 1e12:.2f} ("
            f"{by.get('bf16', 0) / 1e12:.2f}, {by.get('f32', 0) / 1e12:.2f}) "
            f"| {kern / 1e12:.4f} | {c.t_compute * 1e3:.4f} | "
            f"{c.t_memory * 1e3:.4f} | {c.dominant} | "
            f"{c.model_flops_chip / 1e12:.2f} | {c.ideal_bytes_chip / 1e9:.3f}"
            f" | {c.ideal_time * 1e3:.4f} | {c.fraction:.4f} | "
            f"{r['extrapolated']} | {r['trace_s']}")
    fit = [f"{r['arch']} x {r['shape']}" for r in recs if r["fits"]]
    log(f"dry run: {len(fit)} of {len(recs)} cells fit one 80 GB card: "
        f"{fit}")


def rank_table(by_mesh):
    """One row per (cell, production mesh): one rank's footprint against
    one 80 GB card, its collectives' wire bytes by op, and the roofline
    terms with T_coll priced by ``roofline.link_bw``; then the cells that
    do not fit a rank."""
    from repro_torch.launch import roofline
    log("dry run, one counting rank of each production mesh (meta, a CPU "
        "count; capacity 80 GB a rank): arch | shape | mesh | rank | args "
        "GB | args + temp GB | fits | collective GB by op (ring wire bytes "
        "a rank) | T_compute ms | T_memory ms | T_coll ms | dominant | "
        "fraction (ideal / bound) | extrapolated | trace s")
    unfit = []
    for mesh in ("single", "multi"):
        for r in by_mesh[mesh]:
            c = roofline.cell_from_record(r)
            ma = r["memory_analysis"]
            coll = {k: round(v / 1e9, 4)
                    for k, v in r["hlo"]["collective_bytes"].items()}
            log(f"  {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{r['rank_coords']} | {ma['argument_bytes'] / 1e9:.3f} | "
                f"{(ma['argument_bytes'] + ma['temp_bytes']) / 1e9:.3f} | "
                f"{r['fits']} | {coll} | {c.t_compute * 1e3:.4f} | "
                f"{c.t_memory * 1e3:.4f} | {c.t_coll * 1e3:.4f} | "
                f"{c.dominant} | {c.fraction:.4f} | {r['extrapolated']} | "
                f"{r['trace_s']}")
            if not r["fits"]:
                unfit.append(f"{r['arch']} x {r['shape']} x {r['mesh']}")
    log(f"dry run: cells whose rank does not fit one 80 GB card: {unfit}")


def card_cell(dev, arch, shape_name, batch, steps, kernels):
    """One of the reference's cells through ``launch.steps.build_step`` on
    the card (seeded random weights, ``make_concrete`` inputs; decode from a
    full cache, lengths S - 1, every step the same position): ms per step
    (CUDA events), tokens/s, peak memory against the dry run's estimate of
    the same shape, the card's count against the meta count, the roofline
    fraction, and the kernels' launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch import dryrun, hlo_stats, roofline
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_step

    cfg = ARCHITECTURES[arch]
    reg = SHAPES_BY_NAME[shape_name]
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    B = batch or reg.global_batch
    while True:
        shape = dataclasses.replace(reg, global_batch=B)
        est = dryrun.run_cell(arch, shape_name, cfg=cfg, shape=shape,
                              verbose=False, capacity=free)
        if not est["ok"]:
            raise AssertionError(f"{arch} x {shape_name}: dry run "
                                 f"{est['error']}")
        if est["fits"] or batch or B == 1:
            break
        B //= 2
    if not est["fits"]:
        raise AssertionError(f"{arch} x {shape_name} at B={B} does not fit "
                             f"the card's {free} free bytes")
    ma = est["memory_analysis"]
    est_bytes = ma["argument_bytes"] + ma["temp_bytes"]
    base = torch.cuda.memory_allocated()
    bundle = build_step(cfg, shape, make_local_mesh())
    args = list(bundle.make_args(0))
    # the steps' peak over what was live before the arguments: seeded init
    # draws each weight in fp32 first, a transient that is not the step's
    torch.cuda.reset_peak_memory_stats()
    kind = shape.kind
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    _zero_counts()
    ev[0].record()
    for i in range(steps):
        out = bundle.fn(*args)
        if kind == "train":
            args[0], args[1] = out[0], out[1]
        elif kind == "decode":
            args[2] = out[0].argmax(-1, keepdim=True).to(torch.int32)
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = _counts()
    cuda_launches = decode_attention_op.cuda_launches
    peak = torch.cuda.max_memory_allocated() - base
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    probe = out[2]["loss"] if kind == "train" else out[0]
    if not torch.isfinite(probe.float()).all():
        raise AssertionError(f"{arch} x {shape_name}: non-finite output")
    del out, probe
    missing = [k for k in kernels if not launches[k]]
    if missing or (not kernels and any(launches.values())):
        raise AssertionError(f"{arch} x {shape_name}: launches {launches}")
    torch.cuda.empty_cache()
    card = hlo_stats.count(bundle.fn, *args)          # untimed
    if card.to_dict() != est["hlo"]:
        raise AssertionError(f"{arch} x {shape_name}: the card's count "
                             f"{card.to_dict()} != meta {est['hlo']}")
    step_s = float(np.median(ms)) / 1e3
    ideal = roofline.ideal_time(arch, shape)
    frac = ideal / step_s
    if peak > PEAK_SLACK * est_bytes:
        raise AssertionError(f"{arch} x {shape_name}: peak {peak} B > "
                             f"{PEAK_SLACK} x the estimate {est_bytes} B")
    if frac > FRACTION_LIMIT:
        raise AssertionError(f"{arch} x {shape_name}: roofline fraction "
                             f"{frac} > {FRACTION_LIMIT}")
    tokens = B * (1 if kind == "decode" else shape.seq_len)
    del args, bundle
    torch.cuda.empty_cache()
    return dict(arch=arch, shape=shape_name, batch=B, seq=shape.seq_len,
                cut=B != reg.global_batch, steps=steps, ms=ms,
                step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                peak=peak, est=est_bytes, est_args=ma["argument_bytes"],
                est_temp=ma["temp_bytes"], ideal_ms=ideal * 1e3,
                fraction=frac, launches=launches,
                decode_cuda_launches=cuda_launches,
                card_memory=card.memory,
                dot_tflop=card.dot_flops / 1e12,
                kernel_work=card.to_dict()["kernel_work"])


def launch_phases(dev, procs, out_dir):
    """Phase 14: new kernel shapes' cross-check, the dry run's tables (one
    device, a rank of each production mesh), the four cells on the card;
    returns each serving cell's launches."""
    t0 = time.perf_counter()
    r = flash_vs_sdpa(dev)
    pl = r["planted"]
    log(f"flash_attention {r['case']}: max_abs_err={r['max_abs_err']} "
        f"ms={r['ms']} library_ms={r['library_ms']} bound_ms="
        f"{r['bound'][0]} ({r['bound'][1]}); on planted keys against SDPA: "
        f"max_abs_err={pl['max_abs_err']} (largest |output| {pl['largest']})"
        f", {pl['faults_caught']} planted faults fail the check")
    by_mesh = collect_dryrun(procs, out_dir)
    log(f"dry run: {sum(len(v) for v in by_mesh.values())} records "
        f"collected at {time.perf_counter() - t0:.1f} s into the phase")
    dryrun_table(by_mesh["one"])
    rank_table(by_mesh)
    by_path = {}
    for arch, shape, batch, steps, kernels in LAUNCH_CELLS:
        t1 = time.perf_counter()
        c = card_cell(dev, arch, shape, batch, steps, kernels)
        label = f"{arch} x {shape}"
        if kernels:
            by_path[f"launch cell {label}"] = c["launches"]
        log(f"launch cell {label}: B={c['batch']} S={c['seq']}"
            f"{' (batch cut)' if c['cut'] else ''}; {c['steps']} step(s), "
            f"ms per step median {c['step_ms']:.3f} (each "
            f"{[round(x, 3) for x in c['ms']]}), {c['tokens_per_s']:.1f} "
            f"tokens/s; peak {c['peak'] / 1e9:.3f} GB "
            f"(max_memory_allocated) vs the dry run's {c['est'] / 1e9:.3f} GB"
            f" (args {c['est_args'] / 1e9:.3f} + temp {c['est_temp'] / 1e9:.3f})"
            f" = {c['peak'] / c['est']:.4f} of it (limit {PEAK_SLACK}); "
            f"ideal {c['ideal_ms']:.4f} ms, fraction {c['fraction']:.4f}; "
            f"card count == meta count (dot {c['dot_tflop']:.3f} TFLOP, "
            f"kernels {c['kernel_work']}; live bytes on the card "
            f"{c['card_memory']}); launches {c['launches']} (decode_"
            f"attention's calls made {c['decode_cuda_launches']} CUDA "
            f"launches); "
            f"{time.perf_counter() - t1:.1f} s")
    log(f"launch phase: {time.perf_counter() - t0:.1f} s")
    return by_path


# the ensemble twin, card against CPU: tests/test_torch_examples.py's
# tolerances, twin against reference (a phase's error count within this
# many of its 400 queries, each Exp4 weight within this share of itself)
ENSEMBLE_ERR_QUERIES = 1
ENSEMBLE_WEIGHT_RTOL = 1e-4
# the Fig 3 latency profile's batch sizes (the kernel SVM's broadcast
# difference is b x 4096 x 64 fp32, 4 GiB at the largest, twice over)
PROFILE_SIZES = (1, 4, 16, 64, 256, 1024, 4096)
EXAMPLE_SLO = 0.020


def _load_example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(mod, device):
    """``mod.main(["--device", device])`` with its standard output caught:
    (its result, the output, wall seconds, the card's allocations during
    the run)."""
    import contextlib
    import io

    import torch

    def allocations():       # the key appears with the first allocation
        return torch.cuda.memory_stats().get("allocation.all.allocated", 0)

    before = allocations()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = mod.main(["--device", str(device)])
    wall = time.perf_counter() - t0
    return res, out.getvalue(), wall, allocations() - before


def _example_on_both(name, dev):
    """The twin on the CPU and on the card: the card allocates, the CPU
    run does not; returns both runs."""
    mod = _load_example(f"{name}_torch")
    cpu = _run_example(mod, "cpu")
    card = _run_example(mod, dev)
    if cpu[3] != 0 or card[3] <= 0:
        raise AssertionError(f"{name}: {cpu[3]} card allocations on the "
                             f"CPU run, {card[3]} on the card's")
    return cpu, card


_PHASE_LINE = "] err="


def _ensemble_lines(out):
    """The ensemble's phase lines apart from the rest of its output."""
    lines = out.splitlines()
    return ([x for x in lines if _PHASE_LINE in x],
            [x for x in lines if _PHASE_LINE not in x])


def fig3_profile(dev, smi):
    """The Fig 3 spectrum's latency profile on the card: ``time_batch``
    (median of 5) at ``PROFILE_SIZES``, ``fit_linear_latency``'s (base,
    per-item), the batch that fit puts at the 20 ms SLO and the largest
    measured batch within it."""
    import numpy as np
    import torch

    common = _load_example("common_torch")
    rng = np.random.default_rng(0)
    fns = common.make_containers(rng, dev)
    for name, fn in fns.items():
        y = fn(torch.zeros((2, common.D_FEAT), device=dev))
        if y.device.type != "cuda" or y.shape != (2, common.N_CLASSES):
            raise AssertionError(f"fig3 {name}: output {y.device} {y.shape}")
        ms = {}
        for b in PROFILE_SIZES:
            x = rng.normal(size=(b, common.D_FEAT)).astype(np.float32)
            ms[b] = 1e3 * common.time_batch(fn, x, iters=5, device=dev)
        base, per_item = common.fit_linear_latency(fn, rng, device=dev)
        within = [b for b in PROFILE_SIZES if ms[b] <= 1e3 * EXAMPLE_SLO]
        log(f"fig3 profile {name} on {smi}: ms per batch "
            + ", ".join(f"b={b} {t:.4f}" for b, t in ms.items())
            + f"; fit_linear_latency base {1e3 * base:.4f} ms, per item "
            f"{1e6 * per_item:.5f} us, so {(EXAMPLE_SLO - base) / per_item:.0f}"
            f" rows at {1e3 * EXAMPLE_SLO:.0f} ms; largest measured batch "
            f"within it: {max(within, default=0)}")


def examples_phase(dev, smi):
    """Phase 15: the four example twins' ``main()`` on the card (counts set
    to 0 just before, read just after: the path runs none of the four
    kernels). The virtual-clock examples print the CPU's output byte for
    byte; the ensemble's error counts, Exp4 weights and other lines agree
    with the CPU's, and its predictors answer on the card; the adaptive
    batching demo's AIMD lines and the Fig 3 profile are measured on the
    card; returns the kernels' launches on the path."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    _zero_counts()
    for name in ("cascade_pipeline", "flash_crowd_autoscale"):
        cpu, card = _example_on_both(name, dev)
        if card[1] != cpu[1]:
            raise AssertionError(f"{name}: the card's output differs from "
                                 f"the CPU's")
        log(f"example {name}: card output == CPU output "
            f"({len(card[1].splitlines())} lines, {len(card[1])} bytes); "
            f"card {card[2]:.3f} s, CPU {cpu[2]:.3f} s; "
            f"{card[3]} card allocations")

    cpu, card = _example_on_both("ensemble_serving", dev)
    (card_lines, card_rest), (cpu_lines, cpu_rest) = (
        _ensemble_lines(card[1]), _ensemble_lines(cpu[1]))
    if card_rest != cpu_rest or len(card_lines) != 3:
        raise AssertionError("ensemble_serving: the card's lines differ "
                             "from the CPU's")
    for phase, (e, ce, w, cw) in enumerate(zip(
            card[0]["errors"], cpu[0]["errors"], card[0]["weights"],
            cpu[0]["weights"])):
        if abs(round(400 * e) - round(400 * ce)) > ENSEMBLE_ERR_QUERIES:
            raise AssertionError(f"ensemble_serving phase {phase}: error "
                                 f"{e} on the card, {ce} on the CPU")
        if not (np.abs(w - cw) <= ENSEMBLE_WEIGHT_RTOL * cw).all():
            raise AssertionError(f"ensemble_serving phase {phase}: weights "
                                 f"{w} on the card, {cw} on the CPU")
    x = torch.zeros((1, 64), device=dev)
    for i, predict in enumerate(card[0]["predictors"]):
        if predict(x).device.type != "cuda":
            raise AssertionError(f"ensemble_serving: m{i} ran off the card")
    gap = max(float(np.max(np.abs(w - cw) / cw)) for w, cw in zip(
        card[0]["weights"], cpu[0]["weights"]))
    for line in card_lines + card_rest[-1:]:
        log(f"example ensemble_serving (card): {line.strip()}")
    log(f"example ensemble_serving: card vs CPU error counts "
        f"{[round(400 * e) for e in card[0]['errors']]} vs "
        f"{[round(400 * e) for e in cpu[0]['errors']]} of 400, weights "
        f"within {gap:.3e} of themselves (limit {ENSEMBLE_WEIGHT_RTOL}), "
        f"other lines equal; card {card[2]:.3f} s, CPU {cpu[2]:.3f} s; "
        f"{card[3]} card allocations")

    mod = _load_example("adaptive_batching_demo_torch")
    paths, out, wall, allocs = _run_example(mod, dev)
    if allocs <= 0 or sorted(paths) != ["big_mlp", "kernel_svm",
                                        "linear_svm"]:
        raise AssertionError(f"adaptive_batching_demo: {allocs} card "
                             f"allocations, paths {sorted(paths)}")
    for name, hist in paths.items():
        if not all(np.isfinite(t) and t > 0 for _, t in hist):
            raise AssertionError(f"adaptive_batching_demo {name}: a batch "
                                 f"time is not positive")
    for line in out.splitlines()[:3]:
        log(f"example adaptive_batching_demo (card, {smi}): {line}")
    log(f"example adaptive_batching_demo: {wall:.3f} s; largest batch "
        + ", ".join(f"{n} {max(b for b, _ in h)}" for n, h in paths.items()))
    launches = _counts()
    fig3_profile(dev, smi)
    log(f"examples phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 16: the sharded paths on torch.distributed, on the one card
# ---------------------------------------------------------------------------

# ep over (1, 4), ranks sharing the card, against the one-device card run
# of the same weights, the ranks routed as the one device's recorded
# router calls route (phase 12's rule: another expert set only at a
# near-tie, which then takes the one device's choice; a near-tie taken
# otherwise moves a whole row, 0.0815 of the largest |logit| unsteered):
# logits within 3 bf16 roundings of the largest |logit|, the ranks'
# partial expert sums meeting in bf16 in another order (steered prefill
# measured 0.0084 of the largest, 2.2 roundings). A greedy stream may part
# from the one device's only at a step where the ranks' logits row lies
# within this of the one device's (measured 0.0068-0.0079) and the one
# device's two tokens lie within twice that row's difference. The same
# prefill with the expert sum broken (measured 0.52) must miss the limit
# FAULT_MARGIN times over. The context-parallel prefill is held bit for
# bit (the kernel's tiles keep each row's key order, and the ranks' GEMMs
# gave the one device's bits)
SHARDED_LOGIT_TOL = 3 * 2.0 ** -8
FAULT_MARGIN = 10
# the pod-compressed step's gradients against the one-device step's, in
# quanta of each leaf (max |g| over the pods / 127 / npods): the int8
# rounding, and the ranks' own bf16 gradient roundings
POD_QUANTA = 3.0
SHARD_RANKS = 4
SHARD_PROMPTS = (32, 64, 128, 32, 64, 128, 32, 64)   # dbrx's requests
SHARD_NEW = 16
CP_PROMPT = 2048
POD_LAYERS, POD_BATCH, POD_SEQ, POD_STEPS = 8, 8, 256, 1
# 16e: dense tensor-parallel prefill logits against the one device's, in
# bf16 roundings (2**-8) of the largest, as SHARDED_LOGIT_TOL (each rank's
# fp32 partial sums over model rounded once where one device rounds the
# product once). Over 32 layers the two bf16 runs drift apart as each
# drifts from the exact answer (full width on the CPU: 4.77 roundings
# apart, the ranks 4.11 from an fp32 run and one device 4.35), so past the
# limit the ranks' logits are anchored as hymba's are: at most
# ANCHOR_RATIO times as far from the fp32 prefill as the one device's.
# 16g: the gradients in bf16 ulps (BF16_ULP, 2**-7) of each leaf's
# largest, the bound the CPU tests hold the sharded step to
# (tests/test_torch_distributed.py GRAD_ROUNDINGS)
TP_ROUNDINGS = 3.0
SHARD_GRAD_ROUNDINGS = 2.0
# 16e-f: a greedy stream may part from the one device's only where the
# ranks' logits row lies within this of the one device's (the card-vs-CPU
# bound for smollm's 32 layers, LOGIT_TOL) and the one device's two
# tokens within twice that row's difference (16b's rule)
TP_ROW_TOL = LOGIT_TOL["smollm-360m"]


def _sim_server(model, params, prompts, *, eager=False, rows=None,
                setup=None):
    """A greedy ``LMServer`` (8 slots, max_len 512) over ``prompts`` in
    calibrated simulation, so that admission decides the same on every run
    and every rank: -> (streams, engine report without ``prefill.graph``,
    server). ``eager``: the
    fused step runs eagerly; ``rows``: filled with each request's sampled
    logits rows (an eager run); ``setup(server)`` runs before it serves."""
    from repro_torch.core.metrics import VirtualClock
    from repro_torch.serving import engine as E

    srv = E.LMServer(model, device=model.device, slots=8, max_len=512,
                     temperature=0.0, slo=5.0, clock=VirtualClock(),
                     service_model=lambda kind, b, t: 1e-3 * b + 1e-5 * t)
    if eager:
        _eager(srv)
    real, calls = E.sample, []
    if rows is not None:
        def sample(logits, gen, **kw):
            calls.append(logits.float().cpu().numpy())
            return real(logits, gen, **kw)
        E.sample = sample
        _wrap_logits(srv, rows, calls)
    if setup is not None:
        setup(srv)
    try:
        rids = [srv.submit(p, max_new_tokens=SHARD_NEW) for p in prompts]
        srv.run(params)
    finally:
        E.sample = real
    report = srv.engine_report()
    # one device replays its ladder prefills from graphs, a mesh's ranks
    # prefill eagerly: the reports the two compare leave the flag out
    report["prefill"].pop("graph")
    return {r: srv.completed[r].tokens for r in rids}, report, srv


def _nccl_one_rank(cfg, params, prompts):
    """Phase 16a: an NCCL world of one rank, the (1, 1) mesh, the model's
    sharded code path through ``LMServer`` with its decode step captured
    (the collectives inside the graph)."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import serve_rules
    from repro_torch.launch.mesh import init_world, make_local_mesh
    from repro_torch.models.api import build_model

    with tempfile.TemporaryDirectory() as d:
        init_world(0, 1, Path(d, "rendezvous").as_uri(), device="cuda")
        try:
            mesh = make_local_mesh(1, 1, device="cuda")
            if mesh.world.backend != "nccl":
                raise AssertionError(f"one rank a card: {mesh.world.backend}")
            model = build_model(cfg, mesh=mesh, rules=serve_rules(False))
            _zero_counts()
            streams, report, srv = _sim_server(model, params, prompts)
            counts = _counts()
            return dict(streams=streams, report=report, counts=counts,
                        replays=srv.graph_replays,
                        record=mesh.world.record.summary())
        finally:
            dist.destroy_process_group()


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _parting(want, got):
    """``{request: first step where the streams differ}``."""
    out = {}
    for rid, w in want.items():
        k = next((i for i, (x, y) in enumerate(zip(w, got[rid])) if x != y),
                 None)
        if k is not None:
            out[rid] = k
    return out


def _sharded_rank(rank, p):
    """Phases 16b-d on one of ``SHARD_RANKS`` gloo ranks sharing the card;
    the one-device weights and results arrive as CUDA handles in ``p``."""
    import torch
    from repro_torch.bridge import params_for_rank
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.training.grad_compress import (
        _accumulate, _pod_local_mean, loss_and_grads)
    from repro_torch.tree import flatten_with_paths

    from repro_torch.models import moe as moe_lib

    dev = torch.device(p["device"])
    out = {"seconds": {}}
    clock = [time.perf_counter()]

    def lap(name):                     # seconds this rank spent in a phase
        now = time.perf_counter()
        out["seconds"][name] = now - clock[0]
        clock[0] = now
    route = moe_lib._route
    mesh = make_local_mesh(1, SHARD_RANKS, device=dev, share=True)
    rec = mesh.world.record
    with torch.no_grad():
        # b: ep, 4 experts a rank
        model = build_model(p["dbrx_cfg"], mesh=mesh,
                            rules=sh.serve_rules(False))
        local = params_for_rank(p["dbrx_params"], model)
        out["experts"] = int(local["layers"]["moe"]["wi"].shape[1])
        # routed as the one device routed, near-ties aside (phase 12's rule)
        rerouted, p_errs = [], []
        moe_lib._route = _steered_route(route, p["route_prefill"], rerouted,
                                        p_errs, "16b ranks vs one device")
        try:
            out["ep_logits_err"] = _rel(_full_logits(model, model.prefill(
                local, {"tokens": p["toks"]})[0]), p["ref_logits"])
        finally:
            moe_lib._route = route
        # the negative control: the expert sum broken (each rank keeps its
        # own experts' part, the psum left out) must miss the limit widely
        psum, sh.psum = sh.psum, lambda x, axes, mesh=None: x
        try:
            out["ep_fault_err"] = _rel(_full_logits(model, model.prefill(
                local, {"tokens": p["toks"]})[0]), p["ref_logits"])
        finally:
            sh.psum = psum
        # the server, routed as the one device's eager server routed; the
        # decode rows of idle slots and of streams that have parted from
        # the one device's are not compared and take its routing outright
        free = set()

        def track(srv):
            decode = srv._decode_once

            def tracked(params):
                free.update(range(srv.slots))
                free.difference_update(
                    s for s, r in srv._active.items() if r.tokens
                    == p["streams"][r.request_id][:len(r.tokens)])
                try:
                    decode(params)
                finally:
                    free.clear()
            srv._decode_once = tracked

        n_prefill = len(rerouted)
        calls = p["route_prefill"] + p["route_server"]
        moe_lib._route = _steered_route(route, calls, rerouted, p_errs,
                                        "16b ranks vs one device",
                                        free=lambda: free)
        _zero_counts()
        rec.clear()
        rows, steps = {}, []
        try:
            out["ep_streams"], out["ep_report"], _ = _sim_server(
                model, local, p["prompts"], rows=rows,
                setup=lambda srv: (track(srv), _step_timer(srv, rec, steps)))
        finally:
            moe_lib._route = route
        out["ep_counts"] = _counts()
        if len(rerouted) != len(calls):
            raise AssertionError(f"16b: {len(rerouted) - n_prefill} router "
                                 f"calls against the one device's "
                                 f"{len(p['route_server'])}")
        out["ep_rerouted"] = [r for r in rerouted if r[1]]
        out["ep_router_p_err"] = max(p_errs)
        out["ep_record"] = rec.summary()
        out["ep_part_rows"] = {rid: rows[rid][k] for rid, k in _parting(
            p["streams"], out["ep_streams"]).items()}
        del rows
        # eager ms a step with the most slots busy, and the bytes it moves
        step = _busy_steps(steps)
        out["ep_step_ms"], out["ep_step_bytes"], out["ep_step_staged"] = (
            step["ms"], step["bytes"], step["staged"])
        del model, local
        torch.cuda.empty_cache()
        lap("16b")
        # c: context-parallel prefill, S / 4 rows a rank, the layers
        # gathering their weights over model
        model = build_model(p["sm_cfg"], mesh=mesh,
                            rules=dict(sh.serve_rules(False), seq="model"))
        local = params_for_rank(p["sm_params"], model)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(local, {"tokens": p["prompt"]})
        torch.cuda.synchronize()
        out["cp_ms"] = (time.perf_counter() - t0) * 1e3
        out["cp_counts"] = _counts()
        out["cp_logits_err"] = _rel(logits, p["sm_logits"])
        out["cp_cache_err"] = max(_rel(cache[k], p["sm_cache"][k])
                                  for k in ("k", "v"))
        out["cp_equal"] = bool(torch.equal(logits, p["sm_logits"])) and all(
            torch.equal(cache[k], p["sm_cache"][k]) for k in ("k", "v"))
        del model, local, logits, cache
        torch.cuda.empty_cache()
        lap("16c")
        out.update(_tp_serve_rank(p, mesh, lap))
    # d: the pod-compressed step, (pod 2, data 2)
    mesh3 = make_mesh((2, 2, 1), ("pod", "data", "model"), device=dev,
                      share=True)
    rec3 = mesh3.world.record
    bundle = build_train_step(p["tr_cfg"], ShapeSpec(
        "pod", POD_SEQ, POD_BATCH, "train"), mesh3, num_microbatches=1)
    m = bundle.model
    specs = m.extras["param_specs"]
    params = params_for_rank(p["tr_params"], m)      # fsdp over data
    one_grads = dict(flatten_with_paths(params_for_rank(p["one_grads"], m)))
    batch = sh.rank_rows(p["batch"], mesh3, bundle.rules["batch"])
    _zero_counts()
    rec3.clear()
    _, grads = loss_and_grads(m.loss_fn, params, batch, mesh=mesh3,
                              param_specs=specs)
    out["pod_record"] = rec3.summary()
    pod = _pod_local_mean(_accumulate(m.loss_fn, params, batch, 1)[1],
                          specs, mesh3)
    amax = sh.pmax(torch.stack([g.abs().max() for _, g in
                                flatten_with_paths(pod)]), mesh3.axis_names,
                   mesh=mesh3)
    quanta = 0.0
    for i, (path, g) in enumerate(flatten_with_paths(grads)):
        quantum = float(amax[i].clamp_min(1e-20)) / 127.0 / 2
        quanta = max(quanta, float((g - one_grads[path]).abs().max())
                     / quantum)
    out["pod_quanta"] = quanta
    opt = bundle.make_args(0)[1]
    out["pod_step_ms"], out["pod_loss"] = [], []
    for _ in range(POD_STEPS):
        rec3.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = bundle.fn(params, opt, batch)
        torch.cuda.synchronize()
        out["pod_step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["pod_loss"].append(float(metrics["loss"]))
    out["pod_step_record"] = rec3.summary()
    out["pod_step_staged"] = rec3.staged_bytes
    out["train_counts"] = _counts()
    del bundle, m, params, opt, grads, pod, one_grads
    lap("16d")
    out.update(_tp_train_rank(p, dev))
    lap("16g")
    out.update(_family_rank(p, mesh, lap))
    out.update(_count_rank(dev))
    lap("16l")
    return out


# 16l: smollm-360m's decode step at full width (B slots, Smax) and its
# train_rules step cut to POD_LAYERS layers (B x S), on (data 2, model 2)
COUNT_DECODE = (8, 1024)
COUNT_TRAIN = (8, 256)


def _count_rank(dev):
    """Phase 16l on one rank: smollm-360m through ``launch.steps.build_step``
    on (data 2, model 2) at ``padded(2)``, a decode step at full width and
    a ``train_rules`` step cut to ``POD_LAYERS`` layers, each counted
    (``hlo_stats.count``) as it runs on this rank's world and as the
    counting rank at the same coordinates counts it on meta."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.mesh import make_mesh, make_rank_mesh
    from repro_torch.launch.steps import build_step

    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), device=dev, share=True)
    counting = make_rank_mesh((2, 2), ("data", "model"), mesh.world.coords)
    full = ARCHITECTURES["smollm-360m"]
    for cell, cfg, shape in (
            ("decode", full, ShapeSpec("decode", COUNT_DECODE[1],
                                       COUNT_DECODE[0], "decode")),
            ("train", dataclasses.replace(full, num_layers=POD_LAYERS),
             ShapeSpec("train", COUNT_TRAIN[1], COUNT_TRAIN[0], "train"))):
        t0 = time.perf_counter()
        real = build_step(cfg, shape, mesh)
        args = real.make_args(0)
        torch.cuda.synchronize()
        _zero_counts()
        got = hlo_stats.count(real.fn, *args, mesh=mesh).to_dict()
        torch.cuda.synchronize()
        launches = _counts()
        del real, args
        torch.cuda.empty_cache()
        meta = build_step(cfg, shape, counting)
        want = hlo_stats.count(meta.fn, *meta.arg_specs,
                               mesh=counting).to_dict()
        out[f"cnt_{cell}"] = dict(
            got=got, want=want, launches=launches,
            seconds=time.perf_counter() - t0,
            slots=meta.arg_specs[2].shape[0] if cell == "decode" else None)
    return out


def _check_count_ranks(ranks, counts):
    """Phase 16l's checks on every rank, then its log line; adds the decode
    cell's launches to ``counts``."""
    for r, out in enumerate(ranks):
        for cell in ("decode", "train"):
            c = out[f"cnt_{cell}"]
            diff = sorted(k for k in set(c["got"]) | set(c["want"])
                          if c["got"].get(k) != c["want"].get(k))
            if diff:
                raise AssertionError(
                    f"16l rank {r} {cell}: the real count differs from the "
                    f"counting rank's in {diff}: "
                    f"{ {k: (c['got'].get(k), c['want'].get(k)) for k in diff} }")
            if not c["got"].get("collective_payload"):
                raise AssertionError(f"16l rank {r} {cell}: no collective")
        dec, tr = out["cnt_decode"], out["cnt_train"]
        for k in ("rmsnorm", "decode_attention"):
            if not dec["launches"][k]:
                raise AssertionError(f"16l rank {r}: {k} never launched "
                                     f"({dec['launches']})")
        if any(tr["launches"].values()):
            raise AssertionError(f"16l rank {r}: training launched kernels "
                                 f"{tr['launches']}")
        for k, n in dec["launches"].items():
            counts[k] += n
    r0 = ranks[0]
    for cell, what in (("decode", f"decode B={COUNT_DECODE[0]} (slots "
                                  f"{r0['cnt_decode']['slots']} a rank) "
                                  f"Smax={COUNT_DECODE[1]}, 32 layers"),
                       ("train", f"train_rules B={COUNT_TRAIN[0]} x "
                                 f"S={COUNT_TRAIN[1]}, {POD_LAYERS} "
                                 f"layers")):
        c = r0[f"cnt_{cell}"]
        log(f"16l smollm-360m at padded(2) on (data 2, model 2), {what}: "
            f"on every rank the real count equals the counting rank's on "
            f"meta (dot FLOPs {c['got']['dot_flops_by_dtype']}; kernel work "
            f"{ {k: w['calls'] for k, w in c['got']['kernel_work'].items()} } "
            f"calls; collectives (calls, payload bytes) by op/axes/dtype "
            f"{ {k: (v['calls'], v['bytes']) for k, v in c['got']['collective_payload'].items()} }"
            f", wire bytes by op {c['got']['collective_bytes']}); launches a "
            f"rank {c['launches']}; seconds a rank "
            f"{[round(o[f'cnt_{cell}']['seconds'], 1) for o in ranks]}")


def _full_logits(model, logits):
    """A rank's logits over the whole vocab: its block gathered over the
    axes that split the vocab (``extras["vocab_axes"]``)."""
    from repro_torch.distributed import sharding as sh
    axes = model.extras.get("vocab_axes")
    if not axes:
        return logits
    return sh.all_gather(logits, axes, 1, mesh=model.extras["mesh"])


def _step_timer(srv, rec, steps):
    """Wrap ``srv``'s decode step: each eager step's active slots, wall
    seconds (the host clock around a synchronised step) and collectives
    (calls and payload bytes by op, axes and dtype, and the bytes staged
    through host memory, from the rank's record) go to ``steps``."""
    import torch
    decode = srv._decode_once

    def step(params):
        torch.cuda.synchronize()
        calls, nbytes, staged = (dict(rec.calls), dict(rec.bytes),
                                 rec.staged_bytes)
        t0 = time.perf_counter()
        decode(params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved = {f"{op} {'+'.join(axes)} {dt_}": (
            n - calls.get((op, axes, dt_), 0),
            rec.bytes[(op, axes, dt_)] - nbytes.get((op, axes, dt_), 0))
            for (op, axes, dt_), n in rec.calls.items()
            if n != calls.get((op, axes, dt_), 0)}
        steps.append((len(srv._active), dt, moved,
                      rec.staged_bytes - staged))
    srv._decode_once = step


def _busy_steps(steps):
    """The median eager ms of the steps with the most slots busy, their
    count, and the last such step's collectives and staged bytes."""
    busy = max(n for n, *_ in steps)
    full = [st for st in steps if st[0] == busy]
    ms = sorted(t for _, t, _, _ in full)
    return dict(ms=ms[len(ms) // 2] * 1e3, busy=busy, n=len(ms),
                calls=full[-1][2], staged=full[-1][3],
                bytes=sum(b for _, b in full[-1][2].values()))


def _weight_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _tp_serve_rank(p, mesh, lap):
    """Phases 16e-f on one rank: smollm-360m at full width, dense tensor
    parallel over (1, 4) (16e), and served over (data 2, model 2) (16f)."""
    import torch
    from repro_torch.bridge import params_for_rank
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model

    out = {}
    rec = mesh.world.record
    with torch.no_grad():
        model = build_model(p["sm_cfg"], mesh=mesh,
                            rules=sh.serve_rules(False))
        local = params_for_rank(p["sm_params"], model)
        out["tp_bytes"] = _weight_bytes(local)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = _full_logits(model, model.prefill(
            local, {"tokens": p["tp_toks"]})[0])
        torch.cuda.synchronize()
        out["tp_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["tp_logits_rounds"] = _rel(logits, p["tp_logits"]) / 2.0 ** -8
        out["tp_logits"] = logits.float().cpu().numpy()    # by value
        out.update(_tp_served("tp", model, local, p, rec))
        del model, local, logits
        lap("16e")
        # f: the same server over (data 2, model 2), 4 slots a data row
        mesh22 = make_mesh((2, 2), ("data", "model"),
                           device=mesh.world.device, share=True)
        model = build_model(p["sm2_cfg"], mesh=mesh22,
                            rules=sh.serve_rules(False))
        local = params_for_rank(p["sm2_params"], model)
        out.update(_tp_served("dp", model, local, p, mesh22.world.record))
        del model, local
    torch.cuda.empty_cache()
    lap("16f")
    return out


def _tp_served(key, model, params, p, rec, prompts=None):
    """16e-f's server on a rank (and 16h-i's, over ``prompts``): the
    streams, the engine report, the kernels' launches, the rank's logits
    rows where its streams part from the one device's (``p[key +
    "_want"]``), its slots, and each eager decode step's ms and
    collectives, timed in the same run (the host clock around a
    synchronised step)."""
    steps, rows = [], {}
    _zero_counts()
    streams, report, srv = _sim_server(
        model, params, p["tp_prompts"] if prompts is None else prompts,
        rows=rows,
        setup=lambda srv: _step_timer(srv, rec, steps))
    out = {f"{key}_streams": streams, f"{key}_report": report,
           f"{key}_counts": _counts(),
           f"{key}_slots": (srv.layout.lo, srv.layout.per_row),
           f"{key}_part_rows": {rid: rows[rid][k] for rid, k in _parting(
               p[key + "_want"], streams).items() if rid in rows}}
    out[f"{key}_step"] = _busy_steps(steps)
    return out


def _tp_train_rank(p, dev):
    """Phase 16g on one rank: smollm-360m cut to ``POD_LAYERS`` layers on
    (data 2, model 2) under ``train_rules`` (dense TP, ``fsdp`` over
    data): the gradients against the one device's; AdamW and Adafactor on
    the one device's gradients cut to this rank's blocks against the one
    device's update of the same; then one step of each through
    ``make_train_step``, timed."""
    import torch
    from repro_torch.bridge import params_for_rank
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.grad_compress import loss_and_grads
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.tree import flatten_with_paths, tree_map

    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), device=dev, share=True)
    rec = mesh.world.record
    rules = sh.train_rules(False)
    model = build_model(p["tr2_cfg"], mesh=mesh, rules=rules)
    specs = model.extras["param_specs"]
    out["tg_specs"] = {k: tuple(v) for k, v in specs.items()}
    params = params_for_rank(p["tr2_params"], model)
    batch = sh.rank_rows(p["batch"], mesh, rules["batch"])
    _zero_counts()
    rec.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(model.loss_fn, params, batch, mesh=mesh,
                                 param_specs=specs)
    torch.cuda.synchronize()
    out["tg_grad_ms"] = (time.perf_counter() - t0) * 1e3
    out["tg_record"] = rec.summary()
    out["tg_loss"] = float(loss)
    def block(tree):                   # this rank's block, on the host
        return _tree_to(params_for_rank(tree, model), torch.device("cpu"))

    one = params_for_rank(p["tr2_grads"], model)
    want = dict(flatten_with_paths(one))
    out["tg_grad_rounds"] = {
        path: float((g - want[path]).abs().max()
                    / (p["tr2_gmax"][path] * BF16_ULP))
        for path, g in flatten_with_paths(grads)}
    # a leaf past the limit: its distance from the fp32 step's gradient
    # over the one device's (train_parity's anchor)
    exact = dict(flatten_with_paths(params_for_rank(p["tr2_grads32"],
                                                    model)))
    out["tg_anchor"] = {
        path: float((g - exact[path]).abs().max()
                    / (want[path] - exact[path]).abs().max().clamp_min(
                        1e-30))
        for path, g in flatten_with_paths(grads)
        if out["tg_grad_rounds"][path] > SHARD_GRAD_ROUNDINGS}
    del grads, exact
    # the optimizers alone, on the one device's gradients
    new = opt.adamw_update(one, opt.adamw_init(params), params, lr=1e-3,
                           specs=specs, mesh=mesh)
    ref = p["tr2_adamw"]
    out["tg_adamw_rel"] = max(
        _opt_gap(new[0], block(ref[0])),
        *(_opt_gap(a, block(b)) for a, b in zip(new[1][1:], ref[1][1:])))
    p32 = tree_map(lambda t: t.float(), params)
    new = opt.adafactor_update(one, opt.adafactor_init(p32), p32, lr=1e-3,
                               specs=specs, mesh=mesh)
    out["tg_adafactor_rel"] = _opt_gap(new[0], block(p["tr2_adafactor"]))
    del new, one, p32
    # one step of each optimizer through the training step
    out["tg_steps"] = {}
    for name in ("adamw", "adafactor"):
        step, opt_init = make_train_step(model, TrainConfig(optimizer=name))
        state = opt_init(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, _, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        out["tg_steps"][name] = ((time.perf_counter() - t0) * 1e3,
                                 float(metrics["loss"]))
        del new, state
    out["tg_counts"] = _counts()
    torch.cuda.empty_cache()
    return out


# 16h-k: hymba, the encoder-decoder and xlstm placed as the decoder-only
# families are (dense TP over model, fsdp over data in training)
FAM_PROMPTS = SHARD_PROMPTS           # 16h-i's requests: 32-128 tokens
FAM_FRAMES, FAM_TEXT, FAM_STEPS = 1024, 128, 8   # 16j's prefill and decode
FAM_LAYERS = 4                        # 16i and 16k's hymba cut (one global)


def _hymba_cut():
    """hymba-1.5b cut to ``FAM_LAYERS`` layers, the first global and the
    rest one sliding-window segment: every layer kind at full width."""
    import dataclasses
    from repro_torch.configs.registry import ARCHITECTURES
    return dataclasses.replace(ARCHITECTURES["hymba-1.5b"],
                               num_layers=FAM_LAYERS, global_layers=(0,))


def _rank_weight_bytes(model, whole):
    """The bytes a rank of ``model`` should hold of the one-device params
    ``whole``: each leaf ``model`` splits (``param_specs``) divided by the
    ranks its spec names, the rest whole."""
    from repro_torch.tree import flatten_with_paths
    mesh = model.extras["mesh"]
    specs = model.extras["param_specs"]
    total = 0
    for path, t in flatten_with_paths(whole):
        n = t.numel() * t.element_size()
        ways = mesh.size([a for e in specs.get(path, ()) for a in
                          ((e,) if isinstance(e, str) else e or ())])
        total += n // ways
    return total


def _grad_rounds(grads, one, exact, gmax):
    """{path: max |g - one| in bf16 ulps (2**-7) of the one device's
    largest |g|} of a rank's gradient blocks against the one device's
    (``one``, cut to the rank's blocks), and for each leaf past
    ``SHARD_GRAD_ROUNDINGS`` its distance from the fp32 step's (``exact``)
    over the one device's (16g's rule), the distances taken over the whole
    block (L2): hymba's gate leaves hold 3-78 values a rank, where the
    ratio of two largest elements is mostly noise."""
    from repro_torch.tree import flatten_with_paths
    one, exact = dict(flatten_with_paths(one)), dict(flatten_with_paths(exact))
    rounds, anchor = {}, {}
    for path, g in flatten_with_paths(grads):
        if not bool(g.float().isfinite().all()):
            raise AssertionError(f"gradient {path}: non-finite on a rank")
        rounds[path] = float((g.float() - one[path].float()).abs().max()
                             / max(gmax[path] * BF16_ULP, 1e-30))
        if rounds[path] > SHARD_GRAD_ROUNDINGS:
            anchor[path] = float(
                (g.float() - exact[path].float()).norm()
                / (one[path].float() - exact[path].float()).norm()
                .clamp_min(1e-30))
    return rounds, anchor


def _family_references(dev, rng):
    """16h-k's one-device sides, on the card: the weights (seeded), the
    inputs, and what the ranks are held to. -> (payload entries for the
    ranks, what the checks read)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.models.api import build_model
    from repro_torch.serving.sampler import sample
    from repro_torch.training.grad_compress import loss_and_grads
    from repro_torch.tree import flatten_with_paths

    t0 = time.perf_counter()
    pay, ref = {}, {}
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    with torch.no_grad():
        # 16h: full-width hymba-1.5b at padded(4), served eagerly
        cfg = ARCHITECTURES["hymba-1.5b"].padded_config(SHARD_RANKS)
        one = build_model(cfg, device=dev)
        params = one.init(gen())
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in FAM_PROMPTS]
        toks = torch.from_numpy(np.stack([q[:32] for q in prompts])).to(dev)
        logits = one.prefill(params, {"tokens": toks})[0]
        rows = {}
        want, report, _ = _sim_server(one, params, prompts, eager=True,
                                      rows=rows)
        pay.update(h_cfg=cfg, h_params=params, h_prompts=prompts,
                   h_toks=toks, h_logits=logits, h_want=want)
        ref.update(h_cfg=cfg, h_params=params, h_toks=toks, h_logits=logits,
                   h_want=want, h_rows=rows, h_report=report)
        # 16i: the cut at padded(2), served eagerly
        cfg = _hymba_cut().padded_config(2)
        one = build_model(cfg, device=dev)
        params = one.init(gen())
        logits = one.prefill(params, {"tokens": toks})[0]
        rows = {}
        want, report, _ = _sim_server(one, params, prompts, eager=True,
                                      rows=rows)
        pay.update(i_cfg=cfg, i_params=params, i_logits=logits, i_want=want)
        ref.update(i_cfg=cfg, i_want=want, i_rows=rows, i_report=report)
        # 16j: seamless-m4t-medium at padded(4): a prefill of 8 x 128
        # tokens over 8 x 1024 frames and 8 greedy decode steps, the
        # logits of each
        cfg = ARCHITECTURES["seamless-m4t-medium"].padded_config(SHARD_RANKS)
        one = build_model(cfg, device=dev)
        params = one.init(gen())
        frames = (torch.randn((8, FAM_FRAMES, cfg.d_model), generator=gen(),
                              device=dev) * 0.02)
        text = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (8, FAM_TEXT)).astype(np.int32)).to(dev)
        steps, fed = _encdec_steps(one, params, frames, text, None, sample)
        pay.update(j_cfg=cfg, j_params=params, j_frames=frames, j_text=text,
                   j_fed=fed, j_steps=steps)
        ref.update(j_cfg=cfg, j_params=params, j_steps=steps, j_fed=fed)
    # 16k: one train_rules step of xlstm-125m and of the hymba cut at
    # padded(2): the one device's gradients, in bf16 and in fp32
    batch = {k: torch.from_numpy(rng.integers(
        0, 50304, (POD_BATCH, POD_SEQ)).astype(np.int32)).to(dev)
        for k in ("tokens", "labels")}
    pay["k_batch"] = batch
    for key, cfg, params in (
            ("kx", ARCHITECTURES["xlstm-125m"].padded_config(2), None),
            ("kh", pay["i_cfg"], pay["i_params"])):
        one = build_model(cfg, device=dev)
        if params is None:
            params = one.init(gen())
        b = {k: v % cfg.vocab_size for k, v in batch.items()}
        _, grads = loss_and_grads(one.loss_fn, params, b)
        _, exact = loss_and_grads(
            build_model(cfg, device=dev, dtype=torch.float32).loss_fn,
            _tree_to(params, torch.float32), b)
        pay.update({f"{key}_cfg": cfg, f"{key}_params": params,
                    f"{key}_grads": grads, f"{key}_exact": exact,
                    f"{key}_gmax": {k: float(g.abs().max()) for k, g in
                                    flatten_with_paths(grads)}})
        ref[f"{key}_cfg"] = cfg
    log(f"16h-k one-device references: {time.perf_counter() - t0:.1f} s")
    return pay, ref


def _encdec_steps(model, params, frames, text, fed, sample):
    """The encoder-decoder's prefill of ``text`` over ``frames`` and
    ``FAM_STEPS`` decode steps -> (the full-vocab logits of each, on the
    card, fp32; the tokens fed). ``fed`` None: each step feeds the greedy tokens
    of the logits before it (the one device); else those tokens (the ranks,
    so that every step's logits answer the same inputs)."""
    import torch
    logits, cache = model.prefill(params, {"frames": frames, "tokens": text},
                                  max_len=FAM_TEXT + FAM_STEPS + 1)
    logits = _full_logits(model, logits)
    lengths = cache["lengths"].clone()
    out, feed = [logits.float()], []
    for i in range(FAM_STEPS):
        tok = (sample(logits, None, temperature=0.0) if fed is None
               else fed[i])
        feed.append(tok)
        logits, cache = model.decode_step(params, cache, tok[:, None],
                                          lengths)
        logits = _full_logits(model, logits)
        lengths = lengths + 1
        out.append(logits.float())
    torch.cuda.synchronize()
    return out, feed


def _family_rank(p, mesh, lap):
    """Phases 16h-k on one rank: hymba-1.5b served over (1, 4) (16h), the
    hymba cut served over (data 2, model 2) with fsdp over data (16i),
    seamless-m4t-medium's prefill and decode steps over (1, 4) (16j), and
    a train_rules step of xlstm-125m and the hymba cut on (data 2, model 2)
    (16k)."""
    import torch
    from repro_torch.bridge import params_for_rank
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.serving.sampler import sample
    from repro_torch.training.grad_compress import loss_and_grads
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    out = {}
    mesh22 = make_mesh((2, 2), ("data", "model"), device=mesh.world.device,
                       share=True)
    with torch.no_grad():
        # h: hymba-1.5b, 32 layers at padded(4), over (1, 4)
        model = build_model(p["h_cfg"], mesh=mesh,
                            rules=sh.serve_rules(False))
        local = params_for_rank(p["h_params"], model)
        out["h_bytes"] = (_weight_bytes(local),
                          _rank_weight_bytes(model, p["h_params"]))
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = _full_logits(model, model.prefill(
            local, {"tokens": p["h_toks"]})[0])
        torch.cuda.synchronize()
        out["h_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["h_logits_rel"] = _rel(logits, p["h_logits"])
        out["h_logits"] = logits.float().cpu().numpy()
        out.update(_tp_served("h", model, local, p, mesh.world.record,
                              prompts=p["h_prompts"]))
        del model, local, logits
        torch.cuda.empty_cache()
        lap("16h")
        # i: the hymba cut at padded(2) over (data 2, model 2), its leaves
        # stored over data as well (the data rows prefill together)
        rules = dict(sh.serve_rules(False), fsdp="data")
        model = build_model(p["i_cfg"], mesh=mesh22, rules=rules)
        local = params_for_rank(p["i_params"], model)
        out["i_bytes"] = (_weight_bytes(local),
                          _rank_weight_bytes(model, p["i_params"]))
        rows = sh.rank_rows({"tokens": p["h_toks"]}, mesh22, rules["batch"])
        logits = _full_logits(model, model.prefill(local, rows)[0])
        d = mesh22.world.coords["data"]
        half = p["h_toks"].shape[0] // 2
        out["i_logits_rel"] = _rel(logits,
                                   p["i_logits"][d * half:(d + 1) * half])
        out.update(_tp_served("i", model, local, p, mesh22.world.record,
                              prompts=p["h_prompts"]))
        out["i_joint"] = _server_joint(model)
        del model, local, logits
        torch.cuda.empty_cache()
        lap("16i")
        # j: seamless-m4t-medium, 12 + 12 layers at padded(4), over (1, 4)
        model = build_model(p["j_cfg"], mesh=mesh,
                            rules=sh.serve_rules(False))
        local = params_for_rank(p["j_params"], model)
        out["j_bytes"] = (_weight_bytes(local),
                          _rank_weight_bytes(model, p["j_params"]))
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps, _ = _encdec_steps(model, local, p["j_frames"], p["j_text"],
                                 p["j_fed"], sample)
        out["j_ms"] = (time.perf_counter() - t0) * 1e3
        out["j_counts"] = _counts()
        out["j_steps"] = [t.cpu().numpy() for t in steps] if \
            mesh.world.rank == 0 else None
        out["j_rel"] = [_rel(g, w) for g, w in zip(steps, p["j_steps"])]
        del model, local, steps
        torch.cuda.empty_cache()
        lap("16j")
    # k: one train_rules step each, on (data 2, model 2)
    rules = sh.train_rules(False)
    for key in ("kx", "kh"):
        cfg = p[f"{key}_cfg"]
        model = build_model(cfg, mesh=mesh22, rules=rules)
        specs = model.extras["param_specs"]
        params = params_for_rank(p[f"{key}_params"], model)
        batch = sh.rank_rows({k: v % cfg.vocab_size
                              for k, v in p["k_batch"].items()},
                             mesh22, rules["batch"])
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model.loss_fn, params, batch,
                                     mesh=mesh22, param_specs=specs)
        torch.cuda.synchronize()
        out[f"{key}_grad_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{key}_rounds"], out[f"{key}_anchor"] = _grad_rounds(
            grads, params_for_rank(p[f"{key}_grads"], model),
            params_for_rank(p[f"{key}_exact"], model), p[f"{key}_gmax"])
        out[f"{key}_split"] = sorted(specs)
        del grads
        step, opt_init = make_train_step(model, TrainConfig())
        state = opt_init(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        out[f"{key}_step"] = ((time.perf_counter() - t0) * 1e3,
                              float(loss), float(metrics["loss"]))
        out[f"{key}_counts"] = _counts()
        del model, params, state
        torch.cuda.empty_cache()
    lap("16k")
    return out


def _server_joint(model):
    """Whether a server of ``model`` over its mesh makes the data rows
    prefill together (``SlotLayout.joint``)."""
    from repro_torch.serving.engine import SlotLayout
    return SlotLayout(model, model.extras["mesh"], 8).joint


def _check_family_ranks(ranks, ref, counts):
    """Phases 16h-k's checks on every rank, then their log lines; adds the
    serving sub-phases' launches to ``counts``."""
    import numpy as np
    r0 = ranks[0]
    tol_h = LOGIT_TOL["hymba-1.5b"]
    anchor = _fp32_anchor(ref["h_cfg"], ref["h_params"], ref["h_toks"],
                          ref["h_logits"])
    h_anchor = max(anchor(o["h_logits"]) for o in ranks)
    for r, out in enumerate(ranks):
        for key, label in (("h", "16h"), ("i", "16i"), ("j", "16j")):
            got, want = out[f"{key}_bytes"]
            if got != want:
                raise AssertionError(f"{label} rank {r}: {got} B of weights, "
                                     f"not its share ({want} B)")
        if out["h_logits_rel"] > tol_h or h_anchor > ANCHOR_RATIO:
            raise AssertionError(f"16h rank {r}: prefill logits "
                                 f"{out['h_logits_rel']} of the largest off "
                                 f"the one device's (limit {tol_h}), "
                                 f"{h_anchor} times as far from the fp32 "
                                 f"prefill (limit {ANCHOR_RATIO})")
        if out["i_logits_rel"] > tol_h:
            raise AssertionError(f"16i rank {r}: prefill logits "
                                 f"{out['i_logits_rel']} off (limit {tol_h})")
        if not out["i_joint"]:
            raise AssertionError(f"16i rank {r}: the data rows did not "
                                 f"prefill together")
        for key, label in (("h", "16h"), ("i", "16i")):
            if out[f"{key}_streams"] != r0[f"{key}_streams"]:
                raise AssertionError(f"{label} rank {r}: streams differ from "
                                     f"rank 0's")
            mine = out[f"{key}_part_rows"]
            _tp_partings(f"{label} rank {r}",
                         {rid: ref[f"{key}_want"][rid] for rid in mine},
                         {rid: out[f"{key}_streams"][rid] for rid in mine},
                         ref[f"{key}_rows"], mine, tol=tol_h)
            rep = dict(out[f"{key}_report"])
            rep.pop("mesh")
            if rep != ref[f"{key}_report"]:
                raise AssertionError(f"{label} rank {r}: engine report {rep} "
                                     f"vs the one device's "
                                     f"{ref[key + '_report']}")
            for k in ("rmsnorm", "decode_attention", "flash_attention",
                      "ssd_scan"):
                if not out[f"{key}_counts"][k]:
                    raise AssertionError(f"{label} rank {r}: {k} never "
                                         f"launched")
        if max(out["j_rel"]) > LOGIT_TOL["seamless-m4t-medium"]:
            raise AssertionError(f"16j rank {r}: logits of the prefill and "
                                 f"decode steps {out['j_rel']} of the "
                                 f"largest off the one device's (limit "
                                 f"{LOGIT_TOL['seamless-m4t-medium']})")
        for k in ("rmsnorm", "decode_attention", "flash_attention"):
            if not out["j_counts"][k]:
                raise AssertionError(f"16j rank {r}: {k} never launched")
        for key, label in (("kx", "xlstm-125m"), ("kh", "hymba cut")):
            for path, ratio in out[f"{key}_anchor"].items():
                if ratio > ANCHOR_RATIO:
                    raise AssertionError(
                        f"16k {label} rank {r}: gradient {path} "
                        f"{out[f'{key}_rounds'][path]} bf16 ulps off the "
                        f"one device's (limit {SHARD_GRAD_ROUNDINGS}), "
                        f"{ratio} times as far from the fp32 step's (limit "
                        f"{ANCHOR_RATIO})")
            if any(out[f"{key}_counts"].values()):
                raise AssertionError(f"16k rank {r}: training launched "
                                     f"kernels {out[key + '_counts']}")
        for key in ("h_counts", "i_counts", "j_counts"):
            for k, n in out[key].items():
                counts[k] += n
    # 16j's streams: where a rank's greedy choice parts from the one
    # device's token, the one device's two logits lie within twice the
    # rows' difference (16b's rule)
    j_part = []
    for i, (g, w) in enumerate(zip(r0["j_steps"], ref["j_steps"])):
        w = w.cpu().numpy()
        top = np.abs(w).max(-1)
        for b in np.nonzero(g.argmax(-1) != w.argmax(-1))[0]:
            a, c = int(w[b].argmax()), int(g[b].argmax())
            gap = float((w[b, a] - w[b, c]) / top[b])
            diff = float(np.abs(g[b] - w[b]).max() / top[b])
            j_part.append((i, int(b), gap, diff))
            if gap > 2 * diff:
                raise AssertionError(f"16j step {i} row {b}: the ranks' "
                                     f"token parts from the one device's "
                                     f"not at a near-tie ({gap}, {diff})")
    h_part = _tp_partings("16h", ref["h_want"], r0["h_streams"],
                          ref["h_rows"], r0["h_part_rows"], check=False,
                          tol=tol_h)
    i_rows = {}
    for o in ranks:
        i_rows.update(o["i_part_rows"])
    i_part = _tp_partings("16i", ref["i_want"], r0["i_streams"],
                          ref["i_rows"], i_rows, check=False, tol=tol_h)
    hc, ic, jc = ref["h_cfg"], ref["i_cfg"], ref["j_cfg"]
    log(f"16h hymba-1.5b, {hc.num_layers} layers at padded({SHARD_RANKS}) "
        f"({hc.num_heads} / {hc.num_kv_heads} heads, "
        f"{hc.num_heads // SHARD_RANKS} / {hc.num_kv_heads // SHARD_RANKS} a "
        f"rank, G = {hc.num_heads // hc.num_kv_heads}), dense TP over (1, "
        f"{SHARD_RANKS}): prefill logits within "
        f"{max(o['h_logits_rel'] for o in ranks):.4g} of the largest (limit "
        f"{tol_h}), {h_anchor:.3f} times as far from an fp32 CPU prefill as "
        f"the one device (limit {ANCHOR_RATIO}), {r0['h_prefill_ms']:.1f} ms "
        f"(8 x 32 tokens, rank 0); {r0['h_bytes'][0]} B of weights a rank; "
        f"{len(ref['h_want']) - len(h_part)} of {len(ref['h_want'])} greedy "
        f"streams equal to the one device's (the rest (request, step, gap, "
        f"row difference) / largest |logit| {h_part}), the engine report its "
        f"own but the mesh; launches a rank {r0['h_counts']}; eager ms a "
        f"step with {r0['h_step']['busy']} slots busy "
        f"{r0['h_step']['ms']:.3f} (median of {r0['h_step']['n']}; "
        f"host-staged gloo collectives on one card, not a multi-card "
        f"figure), collectives a step {r0['h_step']['calls']}, staged "
        f"{r0['h_step']['staged']:.0f} B")
    log(f"16i hymba cut to {ic.num_layers} layers (global {ic.global_layers}) "
        f"at padded(2) ({ic.num_heads} / {ic.num_kv_heads} heads, G = "
        f"{ic.num_heads // ic.num_kv_heads}) over (data 2, model 2), "
        f"serve_rules with fsdp over data (the data rows prefill together): "
        f"prefill logits within {max(o['i_logits_rel'] for o in ranks):.4g} "
        f"of the largest; {r0['i_bytes'][0]} B of weights a rank; "
        f"{len(ref['i_want']) - len(i_part)} of {len(ref['i_want'])} greedy "
        f"streams equal to the one device's (the rest {i_part}), the engine "
        f"report its own but the mesh; launches a rank {r0['i_counts']}; "
        f"eager ms a step with {r0['i_step']['busy']} slots busy "
        f"{r0['i_step']['ms']:.3f}, collectives a step "
        f"{r0['i_step']['calls']}")
    log(f"16j seamless-m4t-medium {jc.num_layers} + {jc.num_layers} layers "
        f"at padded({SHARD_RANKS}) ({jc.num_heads // SHARD_RANKS} / "
        f"{jc.num_kv_heads // SHARD_RANKS} heads a rank) over (1, "
        f"{SHARD_RANKS}): prefill of 8 x {FAM_TEXT} tokens over 8 x "
        f"{FAM_FRAMES} frames and {FAM_STEPS} decode steps, logits within "
        f"{max(max(o['j_rel']) for o in ranks):.4g} of the largest (limit "
        f"{LOGIT_TOL['seamless-m4t-medium']}; by step "
        f"{[round(x, 5) for x in r0['j_rel']]}), greedy choices parting "
        f"from the one device's at (step, row, gap, row difference) "
        f"{j_part}; {r0['j_ms']:.1f} ms on rank 0; {r0['j_bytes'][0]} B of "
        f"weights a rank; launches a rank {r0['j_counts']}")
    for key, cfg in (("kx", ref["kx_cfg"]), ("kh", ref["kh_cfg"])):
        log(f"16k {cfg.name} {cfg.num_layers} layers at padded(2) on (data "
            f"2, model 2), train_rules, batch {POD_BATCH} x {POD_SEQ}: "
            f"gradients within "
            f"{max(max(o[key + '_rounds'].values()) for o in ranks):.3f} "
            f"bf16 ulps of each leaf's largest one-device value (limit "
            f"{SHARD_GRAD_ROUNDINGS}; past it the ratio of L2 distances "
            f"from the fp32 step's, limit {ANCHOR_RATIO}: "
            f"{[o[key + '_anchor'] for o in ranks]}); loss and grads "
            f"{r0[key + '_grad_ms']:.1f} ms, an AdamW step (ms, loss, step "
            f"loss) {r0[key + '_step']}; {len(r0[key + '_split'])} leaves "
            f"split")


def sharded_phases(dev):
    """Phase 16: 16a an NCCL world of one rank (the production transport)
    serving 4-layer dbrx-132b through the sharded code path, its decode
    graph captured with the collectives inside, streams equal to the
    unsharded server's bit for bit; then ``SHARD_RANKS`` gloo ranks sharing
    the card (spawned once, after the kernels are built, the weights handed
    over as CUDA handles): 16b dbrx ``ep`` over (1, 4), 16c smollm-360m's
    context-parallel prefill of a 2048-token prompt, 16d the pod-compressed
    training step of smollm-360m on (pod 2, data 2), 16e-k (see the module
    docstring), 16l each rank's count of smollm-360m's steps against its
    counting rank's on meta. The ranks' collectives
    copy through host memory: their times and bytes are those of ranks on
    one card, not of four cards. -> the kernels' launches on these paths."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.grad_compress import loss_and_grads
    from repro_torch.tree import flatten_with_paths

    t0 = time.perf_counter()
    full = ARCHITECTURES["dbrx-132b"]
    cfg = dataclasses.replace(full, num_layers=4)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SHARD_PROMPTS]
    with torch.no_grad():
        one = build_model(cfg, device=dev)
        params = one.init(torch.Generator(device=dev).manual_seed(0))
        streams, report, srv = _sim_server(one, params, prompts)
        if not srv.graph_replays:
            raise AssertionError("16a: the unsharded step never replayed")
        a = _nccl_one_rank(cfg, params, prompts)
        if a["streams"] != streams:
            raise AssertionError("16a: the NCCL rank's streams differ from "
                                 "the unsharded server's")
        if not (a["report"]["decode"]["graph"] and a["replays"]):
            raise AssertionError("16a: the sharded decode step was not "
                                 "captured")
        rep = dict(a["report"])
        if rep.pop("mesh")["backend"] != "nccl" or rep != report:
            raise AssertionError(f"16a: engine reports differ: {rep} vs "
                                 f"{report}")
        for k in ("rmsnorm", "decode_attention", "flash_attention"):
            if not a["counts"][k]:
                raise AssertionError(f"16a: {k} never launched")
        log(f"16a dbrx-132b {cfg.num_layers} layers, NCCL world of one rank "
            f"on mesh (1, 1): {len(streams)} streams equal to the unsharded "
            f"server's bit for bit; decode graph captured with its "
            f"collectives, {a['replays']} replays; launches {a['counts']}; "
            f"collectives issued (eager steps and the capture) "
            f"{a['record']}")
        rows, route_server, route_prefill = {}, [], []
        toks = torch.from_numpy(np.stack([q[:32] for q in prompts])).to(dev)
        route = moe_lib._route
        try:
            moe_lib._route = _recording_route(route, route_server)
            eager_streams, _, _ = _sim_server(one, params, prompts,
                                              eager=True, rows=rows)
            moe_lib._route = _recording_route(route, route_prefill)
            ref_logits = one.prefill(params, {"tokens": toks})[0]
        finally:
            moe_lib._route = route
        if eager_streams != streams:
            raise AssertionError("16b: the eager one-device streams differ "
                                 "from the graphed ones")
        sm_cfg = ARCHITECTURES["smollm-360m"].padded_config(SHARD_RANKS)
        sm = build_model(sm_cfg, device=dev)
        sm_params = sm.init(torch.Generator(device=dev).manual_seed(0))
        prompt = torch.from_numpy(rng.integers(
            0, sm_cfg.vocab_size, (1, CP_PROMPT)).astype(np.int32)).to(dev)
        sm_logits, sm_cache = sm.prefill(sm_params, {"tokens": prompt})
        # 16e-f: smollm-360m's one-device servers (eager, its logits rows
        # recorded) at padded(4) and padded(2), over 8 prompts of 32-128
        tp_prompts = [rng.integers(0, sm_cfg.vocab_size, n).astype(np.int32)
                      for n in SHARD_PROMPTS]
        tp_toks = torch.from_numpy(np.stack([q[:32] for q in tp_prompts])
                                   ).to(dev)
        tp_logits = sm.prefill(sm_params, {"tokens": tp_toks})[0]
        tp_rows, dp_rows = {}, {}
        tp_want, tp_report, _ = _sim_server(sm, sm_params, tp_prompts,
                                            eager=True, rows=tp_rows)
        sm2_cfg = ARCHITECTURES["smollm-360m"].padded_config(2)
        sm2 = build_model(sm2_cfg, device=dev)
        sm2_params = sm2.init(torch.Generator(device=dev).manual_seed(0))
        dp_want, dp_report, _ = _sim_server(sm2, sm2_params, tp_prompts,
                                            eager=True, rows=dp_rows)
    tr_cfg = dataclasses.replace(ARCHITECTURES["smollm-360m"],
                                 num_layers=POD_LAYERS)
    tr = build_model(tr_cfg, device=dev)
    tr_params = tr.init(torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.from_numpy(rng.integers(
        0, tr_cfg.vocab_size, (POD_BATCH, POD_SEQ)).astype(np.int32)).to(dev)
        for k in ("tokens", "labels")}
    _, one_grads = loss_and_grads(tr.loss_fn, tr_params, batch)
    # 16g: the same cut at padded(2), its gradients and both optimizers'
    # updates of them
    tr2_cfg = tr_cfg.padded_config(2)
    tr2 = build_model(tr2_cfg, device=dev)
    tr2_params = tr2.init(torch.Generator(device=dev).manual_seed(0))
    _, tr2_grads = loss_and_grads(tr2.loss_fn, tr2_params, batch)
    _, tr2_grads32 = loss_and_grads(
        build_model(tr2_cfg, device=dev, dtype=torch.float32).loss_fn,
        _tree_to(tr2_params, torch.float32), batch)
    tr2_adamw = opt_lib.adamw_update(tr2_grads, opt_lib.adamw_init(tr2_params),
                                     tr2_params, lr=1e-3)
    p32 = _tree_to(tr2_params, torch.float32)
    tr2_adafactor = opt_lib.adafactor_update(
        tr2_grads, opt_lib.adafactor_init(p32), p32, lr=1e-3)[0]
    del p32
    log(f"16 one-device references: {time.perf_counter() - t0:.1f} s")
    fam_pay, fam_ref = _family_references(dev, rng)
    payload = dict(**fam_pay,
                   device="cuda", dbrx_cfg=cfg, dbrx_params=params,
                   toks=toks, streams=streams, route_prefill=route_prefill,
                   route_server=route_server,
                   ref_logits=ref_logits, prompts=prompts, sm_cfg=sm_cfg,
                   sm_params=sm_params, prompt=prompt, sm_logits=sm_logits,
                   sm_cache={k: sm_cache[k] for k in ("k", "v")},
                   tr_cfg=tr_cfg, tr_params=tr_params, batch=batch,
                   one_grads=dict(flatten_with_paths(one_grads)),
                   tp_prompts=tp_prompts, tp_toks=tp_toks,
                   tp_logits=tp_logits, tp_want=tp_want, dp_want=dp_want,
                   sm2_cfg=sm2_cfg,
                   sm2_params=sm2_params, tr2_cfg=tr2_cfg,
                   tr2_params=tr2_params, tr2_grads=tr2_grads,
                   tr2_grads32=tr2_grads32,
                   tr2_gmax={k: float(g.abs().max()) for k, g in
                             flatten_with_paths(tr2_grads)},
                   tr2_adamw=(tr2_adamw[0], tr2_adamw[1]),
                   tr2_adafactor=tr2_adafactor)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = run_ranks(_sharded_rank, SHARD_RANKS, payload, device="cuda",
                      share=True, timeout=600)
    log(f"16b-l {SHARD_RANKS} gloo ranks sharing the card: "
        f"{time.perf_counter() - t1:.1f} s; seconds on each rank by phase "
        f"{[{k: round(v, 1) for k, v in o['seconds'].items()} for o in ranks]}")
    del payload
    counts = dict(a["counts"])
    anchor = None
    for out in ranks:
        if out["tp_logits_rounds"] > TP_ROUNDINGS:
            if anchor is None:
                anchor = _fp32_anchor(sm_cfg, sm_params, tp_toks, tp_logits)
            out["tp_anchor"] = anchor(out["tp_logits"])
    _log_tp(ranks, sm_cfg, sm2_cfg, tr2_cfg, tp_want, dp_want, tp_rows,
            dp_rows)
    _check_family_ranks(ranks, fam_ref, counts)
    del fam_ref
    _check_count_ranks(ranks, counts)
    for r, out in enumerate(ranks):
        if out["experts"] != cfg.num_experts // SHARD_RANKS:
            raise AssertionError(f"16b rank {r}: {out['experts']} experts")
        if out["ep_streams"] != ranks[0]["ep_streams"]:
            raise AssertionError(f"16b rank {r}: streams differ from rank 0")
        if out["ep_logits_err"] > SHARDED_LOGIT_TOL:
            raise AssertionError(f"16b rank {r}: prefill logits "
                                 f"{out['ep_logits_err']} of the largest")
        if out["ep_fault_err"] < FAULT_MARGIN * SHARDED_LOGIT_TOL:
            raise AssertionError(f"16b rank {r}: a broken expert sum gives "
                                 f"only {out['ep_fault_err']} of the largest")
        if not out["cp_equal"]:
            raise AssertionError(f"16c rank {r}: not bit-equal to the one "
                                 f"device: logits {out['cp_logits_err']}, "
                                 f"cache {out['cp_cache_err']} of the "
                                 f"largest")
        if out["pod_quanta"] > POD_QUANTA:
            raise AssertionError(f"16d rank {r}: gradients "
                                 f"{out['pod_quanta']} quanta off")
        if any(out["train_counts"].values()):
            raise AssertionError(f"16d rank {r}: training launched kernels "
                                 f"{out['train_counts']}")
        for key, names in (("ep_counts", ("rmsnorm", "decode_attention",
                                          "flash_attention")),
                           ("cp_counts", ("rmsnorm", "flash_attention"))):
            for k in names:
                if not out[key][k]:
                    raise AssertionError(f"16 rank {r}: {k} never launched "
                                         f"({key})")
            for k, n in out[key].items():
                counts[k] += n
        over_pod = {(e["op"], e["dtype"]) for e in out["pod_record"]
                    if "pod" in e["axes"]}
        if over_pod != {("all_gather", "int8"), ("pmax", "float32"),
                        ("psum", "float32")}:
            raise AssertionError(f"16d rank {r}: over pod {over_pod}")
        _check_tp_rank(r, out, ranks[0], sm_params, tp_want, tp_rows,
                       tp_report, dp_want, dp_rows, dp_report)
        for key in ("tp_counts", "dp_counts"):
            for k in ("rmsnorm", "decode_attention", "flash_attention"):
                if not out[key][k]:
                    raise AssertionError(f"16 rank {r}: {k} never launched "
                                         f"({key})")
            for k, n in out[key].items():
                counts[k] += n
    # (request, step, the one device's gap between the two tokens, the
    # ranks' logits row's difference from it), each / its largest |logit|
    gaps = []
    for rid, k in _parting(streams, ranks[0]["ep_streams"]).items():
        want, got = streams[rid][k], ranks[0]["ep_streams"][rid][k]
        one_row, rank_row = rows[rid][k], ranks[0]["ep_part_rows"][rid]
        top = abs(one_row).max()
        gaps.append((rid, k, float((one_row[want] - one_row[got]) / top),
                     float(abs(rank_row - one_row).max() / top)))
        if gaps[-1][3] > SHARDED_LOGIT_TOL or gaps[-1][2] > 2 * gaps[-1][3]:
            raise AssertionError(f"16b request {rid} parts at step {k}, not "
                                 f"at a near-tie: {gaps[-1]}")
    parted = len(gaps)
    r0 = ranks[0]
    log(f"16b dbrx-132b {cfg.num_layers} layers, ep over (1, "
        f"{SHARD_RANKS}), {r0['experts']} experts a rank: prefill logits "
        f"within {max(o['ep_logits_err'] for o in ranks)} of the largest "
        f"(limit {SHARDED_LOGIT_TOL}; with the expert sum broken "
        f"{min(o['ep_fault_err'] for o in ranks)}, at least {FAULT_MARGIN} "
        f"times the limit); routed as the one device, but at near-ties "
        f"(call, rows, gap) {r0['ep_rerouted']}, router weights on its "
        f"input within {max(o['ep_router_p_err'] for o in ranks)} (limit "
        f"{ROUTER_P_TOL}); streams equal on every rank, "
        f"{len(streams) - parted} of {len(streams)} equal to one device's "
        f"(the rest part where the ranks' logits row lies within the limit "
        f"of the one device's and its two tokens within twice that: "
        f"(request, step, gap, row difference) / largest |logit| {gaps}); "
        f"launches a rank {r0['ep_counts']}; "
        f"eager ms a step with the most slots busy (median) "
        f"{r0['ep_step_ms']:.3f} "
        f"(host-staged gloo collectives on one card, not a multi-card "
        f"figure), collective payload {r0['ep_step_bytes']:.0f} B and "
        f"staged through host memory {r0['ep_step_staged']:.0f} B a step "
        f"a rank; collectives {r0['ep_record']}")
    log(f"16c smollm-360m ({sm_cfg.num_heads} / {sm_cfg.num_kv_heads} heads "
        f"at padded({SHARD_RANKS})), context-parallel prefill of "
        f"{CP_PROMPT} tokens, {CP_PROMPT // SHARD_RANKS} a rank: logits "
        f"and cache bit-equal to the one-device prefill on every rank; "
        f"{r0['cp_ms']:.1f} ms on rank 0 (ranks sharing the card); "
        f"launches a rank {r0['cp_counts']}")
    log(f"16d smollm-360m cut to {POD_LAYERS} of 32 layers (to keep the "
        f"phase near a minute) on (pod 2, data 2), batch {POD_BATCH} x "
        f"{POD_SEQ}: gradients within {max(o['pod_quanta'] for o in ranks)} "
        f"quanta of the one-device step's (limit {POD_QUANTA}); "
        f"{POD_STEPS} steps {r0['pod_step_ms']} ms, loss {r0['pod_loss']}; "
        f"collectives a step {r0['pod_step_record']} (staged "
        f"{r0['pod_step_staged']} B)")
    log(f"sharded phases: {time.perf_counter() - t0:.1f} s")
    return counts


def _tp_partings(label, want, got, one_rows, rank_rows, check=True,
                 tol=TP_ROW_TOL):
    """(request, step, gap, row difference) where a rank's stream ``got``
    parts from the one device's ``want``, each / the largest |logit| of
    the one device's row there (``one_rows``, its eager run's): the ranks'
    row (``rank_rows``) may lie at most ``tol`` from the one device's, and
    the one device's two tokens at most twice that apart (16b's rule)."""
    out = []
    for rid, k in _parting(want, got).items():
        one = one_rows[rid][k]
        top = abs(one).max()
        a, b = want[rid][k], got[rid][k]
        gap = float((one[a] - one[b]) / top)
        diff = float(abs(rank_rows[rid] - one).max() / top)
        out.append((rid, k, gap, diff))
        if check and (diff > tol or gap > 2 * diff):
            raise AssertionError(f"{label} request {rid} parts at step {k}, "
                                 f"not where the ranks' logits explain it: "
                                 f"gap {gap}, row difference {diff}")
    return out


def _fp32_anchor(cfg, params, toks, logits):
    """The prefill of ``toks`` in fp32 on the CPU's plain path (the
    kernels take bf16): -> a function of the ranks' logits giving their
    distance from it over the one device's bf16 ``logits``'."""
    import torch
    from repro_torch.models.api import build_model
    m = build_model(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        exact = m.prefill(_tree_to(_tree_to(params, torch.device("cpu")),
                                   torch.float32),
                          {"tokens": toks.cpu()})[0]
    exact = exact.numpy()
    gap = float(abs(logits.float().cpu().numpy() - exact).max())
    return lambda got: float(abs(got - exact).max()) / gap


def _check_tp_rank(r, out, r0, sm_params, tp_want, tp_rows, tp_report,
                   dp_want, dp_rows, dp_report):
    """Phases 16e-g's checks on rank ``r``'s results."""
    if (out["tp_logits_rounds"] > TP_ROUNDINGS
            and out.get("tp_anchor", 0.0) > ANCHOR_RATIO):
        raise AssertionError(f"16e rank {r}: prefill logits "
                             f"{out['tp_logits_rounds']} bf16 roundings of "
                             f"the largest off the one device's, and "
                             f"{out['tp_anchor']} times as far from the fp32 "
                             f"prefill as the one device's bf16 logits")
    from repro_torch.tree import flatten_with_paths
    kept = sum(t.numel() * t.element_size() for k, t in
               flatten_with_paths(sm_params)
               if k.endswith(("norm", "ln1", "ln2")))
    want = (_weight_bytes(sm_params) - kept) // SHARD_RANKS + kept
    if out["tp_bytes"] != want:
        raise AssertionError(f"16e rank {r}: {out['tp_bytes']} B of weights, "
                             f"not a quarter of the split ones and the norms "
                             f"({want} B)")
    for key, want_streams, rows, report, label in (
            ("tp", tp_want, tp_rows, tp_report, "16e"),
            ("dp", dp_want, dp_rows, dp_report, "16f")):
        if out[f"{key}_streams"] != r0[f"{key}_streams"]:
            raise AssertionError(f"{label} rank {r}: streams differ from "
                                 f"rank 0's")
        mine = {rid: row for rid, row in out[f"{key}_part_rows"].items()}
        parted = _parting(want_streams, out[f"{key}_streams"])
        _tp_partings(f"{label} rank {r}",
                     {rid: want_streams[rid] for rid in mine},
                     {rid: out[f"{key}_streams"][rid] for rid in mine},
                     rows, mine)
        if key == "tp" and set(mine) != set(parted):
            raise AssertionError(f"16e rank {r}: rows of {sorted(mine)}, "
                                 f"partings {sorted(parted)}")
        rep = dict(out[f"{key}_report"])
        rep.pop("mesh")
        if rep != report:
            raise AssertionError(f"{label} rank {r}: engine report {rep} vs "
                                 f"the one device's {report}")
    if out["dp_slots"] != (4 * (r // 2), 4):
        raise AssertionError(f"16f rank {r}: slots {out['dp_slots']}")
    for path, ratio in out["tg_anchor"].items():
        if ratio > ANCHOR_RATIO:
            raise AssertionError(
                f"16g rank {r}: gradient {path} "
                f"{out['tg_grad_rounds'][path]} bf16 ulps off the one "
                f"device's (limit {SHARD_GRAD_ROUNDINGS}), and {ratio} "
                f"times as far from the fp32 step's as the one device's "
                f"(limit {ANCHOR_RATIO})")
    for name in ("adamw", "adafactor"):
        if out[f"tg_{name}_rel"] > OPT_RTOL:
            raise AssertionError(f"16g rank {r}: {name} {out[f'tg_{name}_rel']}"
                                 f" of the largest off the one device's")
    if any(out["tg_counts"].values()):
        raise AssertionError(f"16g rank {r}: training launched kernels "
                             f"{out['tg_counts']}")


def _log_tp(ranks, sm_cfg, sm2_cfg, tr2_cfg, tp_want, dp_want, tp_rows,
            dp_rows):
    r0 = ranks[0]
    tp_part = _tp_partings("16e", tp_want, r0["tp_streams"], tp_rows,
                           r0["tp_part_rows"], check=False)
    dp_rank_rows = {}
    for o in ranks:
        dp_rank_rows.update(o["dp_part_rows"])
    dp_part = _tp_partings("16f", dp_want, r0["dp_streams"], dp_rows,
                           dp_rank_rows, check=False)
    log(f"16e smollm-360m, {sm_cfg.num_layers} layers at padded("
        f"{SHARD_RANKS}) ({sm_cfg.num_heads} / {sm_cfg.num_kv_heads} heads, "
        f"{sm_cfg.num_heads // SHARD_RANKS} / "
        f"{sm_cfg.num_kv_heads // SHARD_RANKS} a rank), dense tensor "
        f"parallel over (1, {SHARD_RANKS}): prefill logits within "
        f"{max(o['tp_logits_rounds'] for o in ranks)} bf16 roundings of the "
        f"largest (limit {TP_ROUNDINGS}, or past it at most {ANCHOR_RATIO} "
        f"times as far from an fp32 prefill as the one device: "
        f"{max(o.get('tp_anchor', 0.0) for o in ranks)}), "
        f"{r0['tp_prefill_ms']:.1f} ms "
        f"(8 x 32 tokens, rank 0); {r0['tp_bytes']} B of weights a rank; "
        f"{len(tp_want) - len(tp_part)} of {len(tp_want)} greedy streams "
        f"equal to the one device's (the rest part where the ranks' row "
        f"lies within {TP_ROW_TOL} of the one device's and its two tokens "
        f"within twice that: (request, step, gap, row difference) / "
        f"largest |logit| {tp_part}), the engine report its own but the "
        f"mesh; launches a rank {r0['tp_counts']}; eager ms a step with "
        f"{r0['tp_step']['busy']} slots busy {r0['tp_step']['ms']:.3f} "
        f"(median of {r0['tp_step']['n']}; host-staged gloo collectives on "
        f"one card, not a multi-card figure), collectives a step (calls, "
        f"payload B) {r0['tp_step']['calls']}, staged "
        f"{r0['tp_step']['staged']:.0f} B")
    log(f"16f smollm-360m at padded(2) ({sm2_cfg.num_heads} / "
        f"{sm2_cfg.num_kv_heads} heads) served over (data 2, model 2), 4 "
        f"slots a data row: {len(dp_want) - len(dp_part)} of {len(dp_want)} "
        f"greedy streams equal to the one device's (the rest part as in "
        f"16e: {dp_part}), the engine report its own but the mesh; "
        f"launches a rank {r0['dp_counts']}; eager ms a step with "
        f"{r0['dp_step']['busy']} slots busy {r0['dp_step']['ms']:.3f} "
        f"(median of {r0['dp_step']['n']}), collectives a step "
        f"{r0['dp_step']['calls']}, staged {r0['dp_step']['staged']:.0f} B")
    steps = {k: (f"{v[0]:.1f} ms", v[1]) for k, v in r0["tg_steps"].items()}
    log(f"16g smollm-360m cut to {tr2_cfg.num_layers} layers at padded(2) on "
        f"(data 2, model 2), train_rules (dense TP, fsdp over data; e.g. "
        f"layers/attn/wq {r0['tg_specs']['layers/attn/wq']}), batch "
        f"{POD_BATCH} x {POD_SEQ}: gradients within "
        f"{max(max(o['tg_grad_rounds'].values()) for o in ranks):.3f} bf16 "
        f"ulps of each leaf's largest one-device value (limit "
        f"{SHARD_GRAD_ROUNDINGS}; past it, ratio of the distances from the "
        f"fp32 step's, limit {ANCHOR_RATIO}: "
        f"{[o['tg_anchor'] for o in ranks]}); on the one device's gradients AdamW "
        f"within {max(o['tg_adamw_rel'] for o in ranks):.3g} and Adafactor "
        f"within {max(o['tg_adafactor_rel'] for o in ranks):.3g} of its "
        f"update (limit {OPT_RTOL}); loss and grads {r0['tg_grad_ms']:.1f} "
        f"ms, a step (ms, loss) {steps}; collectives of the loss and grads "
        f"{r0['tg_record']}")


def main() -> int:
    # phase 13 runs under deterministic algorithms, which need a fixed
    # cuBLAS workspace; on an H100 this is PyTorch's default size (32 MiB),
    # so the earlier phases run as before
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = start_dryrun(out_dir)
        try:
            with torch.no_grad():      # serving: no kernel takes a gradient
                kernels = phases(dev)
            training_phases(dev)
            by_path = launch_phases(dev, procs, out_dir)
            by_path["examples"] = examples_phase(dev, smi)
            by_path["sharded"] = sharded_phases(dev)
        finally:
            stop_dryrun(procs)
    for k in kernels:
        for path, counts in by_path.items():
            k["launches_by_path"][path] = counts[k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

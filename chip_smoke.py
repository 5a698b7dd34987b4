#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (raytracer_tpu_torch) on one
NVIDIA card: builds every kernel from csrc/, checks each against its
plain PyTorch version, and drives the port's three paths:

  * K2 (phase 3): Threefry blocks bit for bit, the kernel alone and
    through its wrapper; the draw kernels (a trace's camera draws, a
    bounce's draws, both RNG families) at the training path's 1,048,576
    lanes against the plain chain on the card bit for bit, timed against
    it and against the chain through K2 that they replace, and the
    training chunk's draw sites as torch.profiler sees them;
  * serving (phases 4-7): the reference scene (Cornell box + bunny, BVH8
    with the brute split) through the fused path-loop kernel K3 at
    2560x1440, spp 8, 20 bounces;
  * the differentiable path and inverse-rendering training (phases
    8-10): K4 and its coherence-sort route (the key kernel, the argsort,
    K4 through the permutation) on the bunny scene's second-bounce
    wavefront and on the two 1,048,576-ray wavefronts the training path
    traces (bounces 1 and 3 of INVERSE_r05's first trace): sorted ==
    unsorted == plain bit for bit, the keys and the permutation == plain,
    the times in turns, the kernels each call launches; the megakernel
    renderer against K3, and three Adam steps of the INVERSE_r05
    configuration (cornell_materials, 128x128, spp 32, 6 bounces, 16
    key/target pairs in chunks of 8), with the K2 route's launches held
    to their formula and one chunk's kernels counted by torch.profiler;
  * the interleaved path loop K5 (phase 11): two lanes per thread that
    refill from the lane list, culled like K3, bitwise equal to K3 on the
    preflight frame, on 1,023 lanes and on the 2K frame, within the image
    tolerance of the plain version on the preflight lanes, timed against
    K3 in turns, the kernels' registers and local memory, and the CLI
    under RAYTRACER_TPU_INTERLEAVE=2; and the witness of the brute cull on
    whole frames: K3 against the plain version (exhaustive pre-pass) bit
    for bit on every lane of the 2K frame; then the lane list's corners
    (four block and chunk cases at 1, 37 and 1,000 lanes), 200 times each
    at tree widths 8 and 4 through K3 and K5 against K3's whole list, with
    every kernel output NaN-filled before its launch (a lost lane shows
    as NaN);
  * K3-profile and the profile-guided schedule (phase 12): profile rgb
    bitwise equal to K3 and its cost / aux equal to the plain version's
    at the preflight size; build_schedule at the main configuration,
    whose frame equals the tiled- and blocked-grid frames bitwise, and
    its 2K spp2 profile checked (rgb == K3 on every lane; cost, aux and
    lane counts == plain exactly on 16 seeded 1024-lane packets); the
    instrumentation's overhead, the warps' divergence and the three
    layouts timed in turns at 2K;
  * the traversal-iteration probes (phase 13): the entry points of
    probes/ablate_v8.py (at the script's 64 packets and at 1,056, 8 per
    SM), probes/ablate.py, load_probe.py, floor_probe.py and
    base_probe.py (the reference scene's 4-wide tree, 128 packets),
    interleave_probe.py (128 and 1,056 packets), scalar_cost.py (256
    packets x 403 iterations) and vstack.py (p1, p2, p3 in this process)
    time every variant with the launch counts from 0; each variant equals
    its plain version bit for bit at a check size over all packets, the
    full bodies also at the scripts' sizes; every interleave G equals the
    v5 full body; scalar_cost's witness (sc, sorted codes) equals the
    plain version's at every W, and its smem16 pre-pass equals the in-order
    chain at five sizes; vstack's p1 and p3 equal the push/pop model, every
    case equals its plain version. The
    entry points of ktf_probe.py (five [8, 128] cases, each against the
    script's host expectation and its plain version on the card bit for
    bit) and v6.py (the dual-unit traversal on the reference scene's 4-wide
    tree, 128 and 1,056 packets: at every chain width W equal to its plain
    version bit for bit at a check size and at full length, at two limit
    sets and at stack_cap 12, against K4 on the same tree by the script's
    rule, timed against it in turns, every W timed with both bounds, and
    its two widths in turns at 264 and 528 packets, between the sizes);
    morph.py (the 13 variants of the v5 body
    morphed toward K4, at the script's 8 packets and at 1,056, each at
    every chain width W equal to its plain version bit for bit, the
    packets' loop counts included, with the chains' live share of the
    packet loop and both bounds at the picked W);
    mosaic.py, bitcast.py and feature.py (single-tile cases, each against
    the script's own check and its plain version bit for bit; bitcast's
    p1, p3 and p4 say BAD as the script does, the ids being float-encoded;
    feature's s7 is one K4 launch on the box-only scene); then the
    single-tile probes redesigned for the card (P-mosaic, P-bitcast,
    P-feature s1-s6): each case with a library call (mosaic colbcast,
    concat, bitcast, bitcast p3 and p4, feature s2) equal to it bit for
    bit and timed per call against it in
    alternating rounds (also against the library call on views made
    once), every case's device time per launch from a CUDA graph of 100
    launches (P-ktf's too), P-floor's empty kernel as the launch floor both ways, and
    the host microseconds of each part of a call; then P-v8 and the v5
    body at every chain width W (1, 2, 4) at the scripts' packets and at
    1,056: ms, registers, local bytes, the roofline and the issue bound
    (static SASS x warps x iterations over the schedulers at the SM clock
    read under load), each case also held to its plain version at every
    W, P-v8 also on NaN inputs; every interleave G at every W it admits
    equal to the v5 full body, G = 1 beside the v5 full body at the same
    W, both bounds at the picked W; P-scalar at every W and every P-vstack
    case, timed, with the roofline and a dependence bound (chains of
    dependent instructions at latencies csrc/probe_latency.cu measures),
    the P-scalar pre-pass per call and per launch in a CUDA graph beside
    both; every probe's rank against the larger of its bounds, and a
    check that no time reads over 100% of any bound;
  * old against new (phase 15, only with --parent DIR, the parent
    commit's tree): the parent's K3, K3-profile, K5 and K4 built from DIR
    against this tree's, each equal to the parent's bit for bit, timed in
    turns at the main path's sizes with K3's chunk sizes; the parent's K4
    route (this tree's wrappers over the parent's library) against this
    tree's at 262,144 and 1,048,576 rays; the parent's draws (the chain
    through its K2) against the draw kernels; the parent's P-mosaic,
    P-bitcast and P-feature through its own wrappers and cudalib (parent_launch_path)
    against this tree's, bit for bit (lanesum, which sums in another order
    since the redesign, by the script's check) and in alternating rounds,
    per call and per launch in a CUDA graph, P-ktf the same way (every
    case bit for bit), and K2's Threefry through the parent's wrapper
    against this tree's; the parent's P-v6 (128 and 1,056 packets, the six
    outputs bit for bit, in alternating rounds); the parent's P-v8 and v5 body
    through its own wrappers (every variant and mode at the scripts'
    packets and at 1,056) bit for bit and in alternating rounds; the
    parent's P-morph (8 and 1,056 packets, the loop counts included) and
    P-interleave (128 and 1,056 packets) the same way, P-scalar (every
    variant and the smem16 pre-pass) and P-vstack (every case) at the
    scripts' sizes; and DIR's own
    `chip_smoke.py --phases 10` against this tree's,
    three each in alternation; phases 4, 7, 8 and 12 count the brute MT records
    the cull leaves per traced ray (brute_may_hit) and give K1, K3 and K4
    a culled bound beside the exhaustive one;
  * the 4-wide tree (phase 14): the reference scene built with
    RAYTRACER_TPU_BVH_WIDTH=4 through K4, K3, K5 and K3-profile built for
    width 4: K4 equal to its plain version bit for bit and to K4 on the
    BVH8 in t, K3 on the preflight frame equal to its plain version bit
    for bit at the known answer, K5 and K3-profile equal to K3 (K5 also
    on the 2K frame), the 2K kernels at width 4 against width 8 in turns,
    and the CLI (fused, fused
    with RAYTRACER_TPU_INTERLEAVE=2, megakernel) on the 4-wide tree with
    the launch counts from 0.

  * the wavefront integrator (phase 16, models/wavefront.py: K4 once
    per iteration, K2's Threefry for the per-lane draws): the preflight
    frame's known answers in both draw families (within 2%), the 2K frame
    against K3 under the image tolerance, the drain cascade on and off bit
    for bit, the jax family against the megakernel renderer, K4 on one of
    the 2K frame's own first-stage calls (per-ray limits, -1 for dead
    lanes) against its plain version bit for bit, the frame's seconds
    (median of 3), iterations per cascade stage, host reads, launches,
    peak memory, kernels and busy share (torch.profiler over one 2K
    frame), and the CLI without --integrator plus a --checkpoint resume
    that equals the uninterrupted render bit for bit.

  * the multi-device layer (phase 17, parallel/: the card listed once
    per shard): the fused render sharded 1, 2 and 4 ways and 2 ways
    through K5 at 2560x1440, each bit for bit render_image_fused, K3 or
    K5 launched once per shard; the wavefront sharded 2 ways and
    rebalanced (div 8) at the same frame, bit for bit the unsharded
    wavefront, with the rebalance's per-shard iterations; the
    differentiable render sharded 2 ways at INVERSE_r05's frame and the
    CLI's 640x360, bit for bit render_image; the 2x2 (rays x spp) mesh
    for both integrators within atol 2e-6 / rtol 1e-5; three mesh-sharded
    train steps (2 shards, INVERSE_r05's scene, frame and seven fields,
    one target) against the unsharded steps (loss rtol 1e-5, params atol
    1e-6); two processes on the card (gloo,
    parallel/multihost_demo, each with its own timeout) whose gathered
    render and rebalanced render equal the single-process ones bit for
    bit and whose train step equals the in-process two-shard step; and
    the CLI's --sharded. Each render's launches are counted from 0 just
    before it and its seconds timed (median of 3 frames). Phase 18
    (opt-in, four cards) runs the same checks over distinct cards: 1, 2
    and 4 shards of the fused frame, the wavefront, the differentiable
    render and the train step 4 ways, and four processes on nccl, one
    per card.

  * the LBVH fallback and the LBVH-only route (phase 19, ops/bvh,
    ops/traverse, scene/assets): the procedural assets written again equal
    the committed files byte for byte; with the native builder made to
    raise NativeUnavailable (monkeypatched in the phase), the LBVH of the
    reference scene's 81,920-triangle tree half built on the card equals
    the CPU's build bit for bit and its collapsed, widened BVH8 equals the
    builder's fallback tree; that tree through K3 gives the preflight
    known answer (2%) and equals K3's plain version there bit for bit,
    gives a 2K spp8 mb20 frame within the image tolerance of the native
    tree's (both K3 times in turns), and through K4 on the wavefront a
    frame within the tolerance of its K3 frame, K4 equal to its plain
    version bit for bit on 4,096 of phase 8's bounce rays; a scene that
    holds only the LBVH of all 81,952 triangles goes through
    ops/traverse.intersect_bvh (plain PyTorch on the card, one host read
    per step) against the K4 route on 65,536 of phase 8's bounce rays
    (hits, types and ids equal, t within rtol 1e-4) and through the megakernel renderer's preflight frame against
    the bvh4 scene's; the CLI's --profile writes a trace with the card's
    kernels.

  * the BASELINE configs and the flagship (phase 20,
    raytracer_tpu_torch.milestones and .flagship): configs 1-4 at their
    presets and config 5 with --quick (2K, spp 8), each with its launches
    counted from 0 (every pixel finite, config 4's loss falling); the
    flagship 2560x1440 at 2000 spp through K3 in 16-spp resumable batches,
    its mean within 2% of FLAGSHIP_r05.json's (the JAX package's render
    of the same frame).
  * the lane grid LG (phase 21, ops/cuda_lane_grid, csrc/lane_grid.cu):
    the main path's 2560x1440 frame in the blocked layout (the fused
    path) and the tiled layout (the wavefront), one launch each, px, py
    and inv bit for bit against the plain closed form on the card and
    against the numpy builders, the kernel timed against its bound, the
    plain form on the card and the numpy grid with its pageable copy that
    it replaced. Phases 7 and 16 read one LG launch a frame.
  * the sphere tree (phase 22, scene/builder.build_sphere_tree, csrc/path.cuh
    sphere_search): the "Ray Tracing in One Weekend" final scene (487
    spheres, no triangle) built with its tree (its node count, sweep set
    and build time), K3's registers and local memory with and without the
    tree, and one 64-spp pass of its 1200x675 frame through K3 with the
    tree against K3 sweeping all 487 spheres (taken past the 16-sphere
    budget here alone): bit for bit, timed in turns.
  * the training step's CUDA graph (phase 23, diff/inverse.ChunkGraph) at
    the benchmark cell's size (256x256, 16 pairs in chunks of 8, 32 spp,
    6 bounces, ktf draws): three steps through the graph against the same
    steps run eagerly (twice, for their own run-to-run gap) from the same
    params and Adam state, the losses bit for bit, the gradients and
    params within that gap; one capture, two replays a step; the
    capture's seconds, the peak memory, and both routes' steps in turns.

Every kernel row carries its bound: the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its operations
over the peak rate of their type, counted from this run's inputs. fp32:
the SM's 128 fp32 lanes, one add, multiply or compare each per clock, on
every SM at the card's maximum SM clock (33.4 TFLOP/s at 1,980 MHz on 132
SMs; the probes' rows at the SM clock read under load). The datasheet's
67 TFLOP/s counts a fused multiply-add as two operations, and every kernel
here is built -fmad=false. int32: the SM's 64 INT32 units at that clock.

    python3 chip_smoke.py              # phases 1-14, 16, 17 and 19-23 (what CI runs)
    python3 chip_smoke.py --phases 16  # the wavefront alone
    python3 chip_smoke.py --phases 17  # the sharded paths and two processes
    python3 chip_smoke.py --phases 1,2,19,20   # the LBVH, the milestones and the flagship
    python3 chip_smoke.py --phases 1,2,18   # the same over four distinct cards (nccl)
    python3 chip_smoke.py --phases 1,2,3   # a subset, while debugging
    python3 chip_smoke.py --phases 15 --parent renders/parent   # old against new
                                     # (renders/parent: `git archive` of the parent commit)

Every phase raises on failure, so the script exits non-zero. The last
lines are a `train` JSON line (phase 10), a `train_graph` JSON line (phase
23), a `probes` JSON line (phase 13),
a `wavefront` JSON line (phase 16), an `lbvh` JSON line (phase 19), a
`milestones` JSON line (phase 20: each config's record and launches, the
flagship's wall clock and mean), a `sharding` JSON line (phase 17:
per check the shards, whether bitwise, the seconds, the rebalance's
balance, beside the card's name and power limit),
a JSON object with one entry per kernel and {"ok": true, "device": {...}}. It needs a CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(ROOT, "assets", "expected_preflight.json")
PREFLIGHT = dict(width=128, height=40, spp=2, max_bounces=12)
PREFLIGHT_RTOL = 0.02      # kernel mean vs the committed CPU-exact mean
MAIN = dict(width=2560, height=1440, spp=8, max_bounces=20)
MAIN_BAND = 0.15           # 2K mean vs the preflight mean (resolution shift)
MAIN_SAMPLE = 16384        # 2K pixels (seeded) re-rendered by the plain version
# Kernel vs plain image ("cross-compiler" tolerance, tests/test_fused_megakernel.py:70-73):
# at most 0.5% of elements beyond 5e-4 + 2e-4|x|, means within 1e-3.
IMG_ATOL, IMG_RTOL, IMG_BAD_FRAC, MEAN_TOL = 5e-4, 2e-4, 0.005, 1e-3
T_RTOL = 1e-4              # traversal t vs plain / brute force
NEAR_TIE_MAX = 1 / 5000    # id flips at equal t allowed per hit ray
# Phase 8: the second-bounce wavefront of a 512x512 spp1 megakernel frame.
P8 = dict(width=512, height=512, spp=1, max_bounces=2)
P8_SUBSET = 16384          # seeded rays re-traced by the plain version
# Phase 8 also takes the training path's wavefronts (training_wavefronts):
# bounces 1 and 3 of INVERSE_r05's first trace, 1,048,576 rays each.
P8_TRAIN_BOUNCES = (1, 3)
# Phase 9: the differentiable renderer's forward pass against K3.
P9 = dict(width=256, height=144, spp=4, max_bounces=8)
# Phase 10: INVERSE_r05 (scripts/inverse_tpu_r05.py:116-162, INVERSE_r05.json).
P10 = dict(width=128, height=128, spp=32, max_bounces=6)
P10_PAIRS, P10_CHUNK, P10_STEPS, P10_SCHEDULE_STEPS, P10_LR = 16, 8, 3, 500, 0.03
P10_FIELDS = ("albedo", "roughness", "emission", "ior")
P10_CAM_PERTURB = {"cam_position": (0.015, -0.01, 0.02), "cam_yaw": 1.0, "cam_pitch": -0.75}
P10_LR_SCALES = {"cam_position": 0.3, "cam_yaw": 2.0, "cam_pitch": 2.0}
P10_SMALL = dict(width=32, height=32, spp=2, max_bounces=3)
P10_SMALL_PAIRS = 2
# Kernel step vs plain step (CPU): transcendentals and reductions round
# differently on the card, so a rare path can flip; the loss must agree
# to 1e-4 relative and every gradient entry to 1% of its field's scale.
STEP_LOSS_RTOL, STEP_GRAD_FRAC = 1e-4, 0.01
FD_RTOL, FD_ATOL = 0.08, 1e-5  # tests/test_grad.py:76
# The first losses of the JAX package's INVERSE_r05 run (same scene,
# keys, init and schedule), committed with six digits: the port's must
# agree within 2e-3 relative (a fault moves them by far more).
INVERSE_REF = os.path.join(ROOT, "INVERSE_r05.json")
LOSS_REF_RTOL = 2e-3
# Phase 12: seeded whole 1024-lane packets of the 2K profile re-rendered
# by the plain version (cost, aux and lane counts must match exactly).
P12_PACKETS = 16
# Phase 13: the probes' plain versions are slow on the card; every variant
# is held to its plain version at this many iterations over all packets.
P13_CHECK_ITERS = 16
P13_FILL_PACKETS = 1056    # 8 blocks of 8 warps per SM on 132 SMs
# Phase 13's single-tile probes redesigned for the card (P-mosaic,
# P-feature): each timed per call against its library call in this many
# alternating pairs (kernel, library, library, kernel, ...), each turn
# time_launches' median of 10; and its device time per launch from a CUDA
# graph of this many launches, captured once and replayed between one
# event pair.
P13_TURN_PAIRS = 6
# Packets between P-v6's two sizes, 16 and 32 chains an SM on 132 SMs, where
# v6.chosen_w's threshold lies: its two widths there in turns.
P13_V6_BETWEEN = (264, 528)
# (packets, iterations) at which phase 13 holds the P-scalar pre-pass to
# smem16_chain: one packet, fewer and more than 64 iterations, the script's
# size and twice its iterations.
P13_TABLES_SIZES = ((1, 1), (9, 150), (65, 5), (256, 403), (256, 806))
P13_GRAPH_LAUNCHES = 100
# After this many seconds every thread's traceback is printed and the run
# exits non-zero: a launch that never ends then names its place, inside
# the 1,200 s a smoke run may take.
WATCHDOG_S = 1150
# Phase 11's lane-list repeats: each (block, chunk) corner of the card
# tests' lane-list cases, at these lane counts, at tree widths 8 and 4,
# through K3 and K5, against K3's whole list (itself re-rendered each time).
LANE_CASES = ((32, 1), (32, 96), (256, 1), (64, 5))
LANE_COUNTS = (1, 37, 1000)
LANE_REPEATS = 200
LANE_CHUNK1_REPEATS = 1000  # then the largest count at chunk 1, per block of 32 and 256
# Phase 16: the wavefront integrator (models/wavefront.py).
P16_SMALL = dict(width=256, height=144, spp=4, max_bounces=8)
P16_CLI = dict(width=640, height=360, spp=4, max_bounces=8)
P16_FRAMES = 3             # timed 2K frames (median)
P16_CAPTURE_CALL = 8       # the 2K frame's K4 call whose rays are held to the plain version
# The first K2 Threefry call from this one on with a per-lane sample and
# bounce (ktf family, one key) or per-lane keys and fold data (jax family,
# the keyed entry) is held to the plain version bit for bit.
P16_K2_CAPTURE_FROM = 40
# Phase 17: the multi-device layer (parallel/) on one card. Tolerances:
# tests/test_sharding.py (the 2D mesh's sums, the train step's psum).
P17_FRAMES = 3             # timed frames per sharded render (median)
P17_REBALANCE_DIV = 8
P17_CLI = dict(width=640, height=360, spp=4, max_bounces=8)
P17_2D_ATOL, P17_2D_RTOL = 2e-6, 1e-5
P17_LOSS_RTOL, P17_PARAM_ATOL = 1e-5, 1e-6
P17_RANK_TIMEOUT_S = 300   # per worker process of the two-process run
# Phase 19: the LBVH fallback and the LBVH-only route (ops/bvh, ops/traverse).
P19_RAYS = 65536           # seeded bounce rays of phase 8's wavefront
P19_PLAIN_RAYS = 4096      # of them, re-traced by K4's plain version on the fallback tree
ASSET_FILES = ("CornellBox-Original.obj", "CornellBox-Original.mtl", "bunny.obj")
# Phase 20: the BASELINE milestone configs (raytracer_tpu_torch.milestones)
# and the flagship (raytracer_tpu_torch.flagship) against FLAGSHIP_r05.json,
# the JAX package's 2000 spp render of the same frame (fused, ktf, key 0).
P20_FULL = (1, 2, 3, 4)    # at their presets; config 5 runs --quick (2K, spp 8)
P20_QUICK = (5,)
FLAGSHIP_REF = os.path.join(ROOT, "FLAGSHIP_r05.json")
FLAGSHIP_SPP = 2000
FLAGSHIP_RTOL = 0.02
# Peaks for the bounds: H100 SXM memory (NVIDIA H100 datasheet), the Hopper
# SM's 128 fp32 lanes and 64 INT32 units (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper), each one operation per clock. The kernels are
# built -fmad=false, so no multiply-add fuses: the fp32 peak is 128 x SMs x
# the SM clock, half the datasheet's 67 TFLOP/s (which counts an FMA as
# two). FP32_OPS_PER_S is an H100 SXM's at its 1,980 MHz maximum until
# main() reads the card's SMs and maximum SM clock.
HBM_BYTES_PER_S, FP32_LANES_PER_SM, INT32_UNITS_PER_SM = 3.35e12, 128, 64
FP32_OPS_PER_S = 132 * FP32_LANES_PER_SM * 1980e6
# Threefry-2x32 per block: 2 adds, 20 rounds of add / rotate / xor, 5 key
# injections of 2 adds (the key sums folded): 72 int32 operations.
THREEFRY_OPS = 72
# K1's cull of one brute triangle (csrc/traverse.cuh brute_skip): the box
# slab (25, as a node slab) plus the guard's dot product and compare (6).
CULL_OPS = 31
# Normals of the draw kernels against the plain chain: the bound that
# tests/test_torch_rng.py states for the port's normals against JAX.
NORMAL_ULP = 3


def log(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over `reps` calls after a
    warm-up (CUDA events; the plain versions' host work is inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fp32_ops_per_s(n_sm: int, mhz: float) -> float:
    """The fp32 peak of -fmad=false code: 128 lanes x SMs x the SM clock."""
    return n_sm * FP32_LANES_PER_SM * mhz * 1e6


def roofline(nbytes: int, ops: int, ops_per_s: float | None = None) -> dict:
    """The least time the card could take: bytes over the memory rate
    against operations over their peak rate (fp32 by default:
    FP32_OPS_PER_S), whichever is larger."""
    ops_per_s = ops_per_s or FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(nbytes), bound_ops=int(ops))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bvh_bytes(b) -> int:
    return _nbytes(b.bounds, b.children, b.tri, b.prim_index, b.face_mat, b.brute_tri,
                   b.brute_prim, b.brute_mat)


def trace_bound(bvh, n_rays: int, k1_steps: int) -> dict:
    """K1 / K4 on n_rays live rays whose walks took k1_steps steps (the
    plain version's count): the tables, o, d, t_lim in and the record
    (t, id, mat, normal) out; per step at least one MT record (a leaf of
    one triangle; a node expansion is 8 slab tests), plus the brute
    pre-pass of every ray."""
    from raytracer_tpu_torch.probes.common import MT_OPS

    n_brute = 0 if bvh.brute_tri is None else bvh.brute_tri.shape[0]
    return roofline(bvh_bytes(bvh) + n_rays * (24 + 4 + 24),
                    MT_OPS * (k1_steps + n_brute * n_rays))


def trace_bound_cull(bvh, n_rays: int, k1_steps: int, brute_mts: int) -> dict:
    """trace_bound for the work K1 does since it culls its brute pre-pass:
    every live ray's cull of each brute triangle, and MT records for the
    brute_mts triangles the cull left (brute_may_hit's count)."""
    from raytracer_tpu_torch.probes.common import MT_OPS

    n_brute = 0 if bvh.brute_tri is None else bvh.brute_tri.shape[0]
    return roofline(bvh_bytes(bvh) + n_rays * (24 + 4 + 24),
                    MT_OPS * (k1_steps + brute_mts) + CULL_OPS * n_brute * n_rays)


def brute_mts(bvh, o, d, t_lim, t_min: float = 1e-3):
    """(MT records the culled pre-pass runs, traced rays) for rays o/d with
    limits t_lim: ops/cuda_traverse.brute_may_hit's rule, triangle by
    triangle against the running best, as K1 takes it."""
    from raytracer_tpu_torch.ops import cuda_traverse as ct

    tests, traced = 0, 0
    for lo in range(0, o.shape[0], 1 << 18):
        sl = slice(lo, lo + (1 << 18))
        tests += int(ct.brute_prepass_plain(o[sl], d[sl], bvh, t_lim[sl], t_min)[4].sum())
        traced += int((t_lim[sl] > t_min).sum())
    return tests, traced


def recorded_rays(fn):
    """fn() with the plain path loop's traversal calls recorded: (fn's
    result, the traced rays o, d and their limits t_lim)."""
    import torch

    from raytracer_tpu_torch.ops import cuda_megakernel as cm

    calls, plain = [], cm._traverse_plain

    def record(o, d, bvh, t_lim, t_min, count=False):
        calls.append((o, d, t_lim))
        return plain(o, d, bvh, t_lim, t_min, count=count)

    cm._traverse_plain = record
    try:
        out = fn()
    finally:
        cm._traverse_plain = plain
    return out, *(torch.cat(x) for x in zip(*calls))


def path_bound_cull(bvh, n_lanes: int, spp: int, k1_steps: int, path_iters: int,
                    mts_per_traced: float) -> dict:
    """path_bound for the culled pre-pass: each traced ray culls every
    brute triangle and runs mts_per_traced MT records (the culled count on
    a sample of the same frame's rays)."""
    from raytracer_tpu_torch.probes.common import MT_OPS

    n_brute = 0 if bvh.brute_tri is None else bvh.brute_tri.shape[0]
    traced = max(path_iters - spp * n_lanes, 0)
    return roofline(bvh_bytes(bvh) + n_lanes * (12 + 12),
                    MT_OPS * (k1_steps + mts_per_traced * traced) + CULL_OPS * n_brute * traced)


def path_bound(bvh, n_lanes: int, spp: int, k1_steps: int, path_iters: int) -> dict:
    """K3 / K5 / K3-profile on n_lanes lanes, from K3-profile's lane
    counts: the tables and the lanes' pixel ids in, rgb out; K1's steps as
    in trace_bound, and the brute pre-pass of every traced ray (each path
    iteration traces one, except a sample's last when roulette ends it)."""
    from raytracer_tpu_torch.probes.common import MT_OPS

    n_brute = 0 if bvh.brute_tri is None else bvh.brute_tri.shape[0]
    traced = max(path_iters - spp * n_lanes, 0)
    return roofline(bvh_bytes(bvh) + n_lanes * (12 + 12),
                    MT_OPS * (k1_steps + n_brute * traced))


def image_agreement(a, b):
    """(bad element fraction, |mean difference| per channel max, max abs err)."""
    import torch

    diff = (a - b).abs()
    bad = diff > (IMG_ATOL + IMG_RTOL * b.abs())
    mean_diff = (a.mean(dim=(0, 1)) - b.mean(dim=(0, 1))).abs().max().item()
    return bad.float().mean().item(), mean_diff, diff.max().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,16,17,19,20,21,22,23",
                    help="comma-separated phases to run (default: 1-14, 16, 17 and 19-23; "
                         "phase 15 needs --parent, phase 18 four cards)")
    ap.add_argument("--parent", default=None,
                    help="phase 15: a directory holding the parent commit's tree "
                         "(e.g. from git archive)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.fused import _fused_pixel_grid, render_image_fused
    from raytracer_tpu_torch.ops import cuda_lane_grid, cuda_megakernel, cuda_traverse
    from raytracer_tpu_torch.ops.bvh4 import BIG
    from raytracer_tpu_torch.ops.tonemap import to_rgba8
    from raytracer_tpu_torch.ops.triangle import intersect_tris_brute
    from raytracer_tpu_torch.scene.builder import reference_scene
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid, blocked_pixel_grid
    from raytracer_tpu_torch.utils import cudalib, ktf
    from raytracer_tpu_torch.utils.image import write_png
    from raytracer_tpu_torch.utils.profiling import device_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    kernels = {}
    global FP32_OPS_PER_S
    FP32_OPS_PER_S = fp32_ops_per_s(torch.cuda.get_device_properties(0).multi_processor_count,
                                    _int32_ops_per_s()[1])

    # ---- 1. device
    smi = device_line(dev)
    print(smi, flush=True)
    nvcc_v = subprocess.run([cudalib._nvcc(), "--version"], capture_output=True, text=True,
                            timeout=60).stdout.strip().splitlines()[-1]
    log(1, f"device: {card} | nvidia-smi: {smi} | torch {torch.__version__} "
           f"(CUDA {torch.version.cuda}) | nvcc: {nvcc_v} | count {torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    cudalib.lib()
    build_s = time.perf_counter() - t0
    info = cudalib.BUILD_INFO
    ptxas = [ln.strip() for ln in info.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(2, f"built {os.path.relpath(info['path'], ROOT)} in {build_s:.2f} s "
           f"(cached={info['cached']})")
    for ln in ptxas:
        log(2, f"  ptxas: {ln}")
    from raytracer_tpu_torch.ops import cuda_megakernel, cuda_traverse

    res = {**cuda_megakernel.kernel_resources(), **cuda_traverse.kernel_resources()}
    log(2, "numRegs / localSizeBytes: " + ", ".join(f"{k} {r} / {b}" for k, (r, b) in res.items())
        + " (K5 128 / 2080, width 4 122 / 2080, before its cull, lane list and register cap; "
        "K4 51 / "
        "1024, width 4 49, before its record-finishing, permuting design; before the culled "
        "pre-pass and the refilling lanes: K3 64 / 1024, K3-profile 67 / 1024, K4 54 / 1024; "
        "width 4 K3 62 / 1056, K3-profile 64, K4 50)")

    scene = None
    if 15 in phases and not args.parent:
        raise SystemExit("chip_smoke: phase 15 needs --parent DIR (the parent commit's tree)")
    if phases & {4, 5, 6, 7, 8, 9, 11, 12, 14, 15, 16, 17, 18, 19}:
        t0 = time.perf_counter()
        scene_cpu = reference_scene()
        scene = scene_cpu.to(dev)
        b = scene_cpu.bvh4
        log(0, f"reference_scene: {scene_cpu.mesh.num_tris} tris, BVH{b.children.shape[1]} "
               f"built by '{b.builder}', "
               f"{b.children.shape[0]} nodes, {b.tri.shape[0]} padded tris, "
               f"{b.brute_tri.shape[0]} brute rows, stack_depth {b.stack_depth}, "
               f"built in {time.perf_counter() - t0:.2f} s")

    # ---- 3. K2: Threefry bit for bit
    if 3 in phases:
        gen = torch.Generator().manual_seed(3)
        n = 1 << 20
        c0 = torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int64).to(torch.int32)
        c1 = torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int64).to(torch.int32)
        c0d, c1d = c0.to(dev), c1.to(dev)
        err = 0
        for seed in (0, 12345, (7 << 32) | 0xDEADBEEF):
            k0, k1 = ktf.key_words(seed)
            x0, x1 = ktf.threefry2x32_kernel(k0, k1, c0d, c1d)
            p0, p1 = ktf.threefry2x32(k0, k1, c0d, c1d)       # plain, on the card
            h0, h1 = ktf.threefry2x32(k0, k1, c0, c1)         # plain, on the host
            for x, ref in ((x0, p0), (x1, p1), (x0.cpu(), h0), (x1.cpu(), h1)):
                err = max(err, int((x.long() - ref.to(x.device).long()).abs().max()))
            if err:
                raise AssertionError(f"K2 threefry differs from utils.ktf under seed {seed}: "
                                     f"max |word difference| {err}")
        k0, k1 = ktf.key_words(0)
        ms = cuda_ms(lambda: ktf.threefry2x32_kernel(k0, k1, c0d, c1d), 50)
        plain_ms = cuda_ms(lambda: ktf.threefry2x32(k0, k1, c0d, c1d), 10)
        int32_rate, mhz = _int32_ops_per_s()
        kernels["K2"] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                             **roofline(16 * n, THREEFRY_OPS * n, int32_rate),
                             int32_ops_per_s=int32_rate, max_sm_clock_mhz=mhz)
        raw = k2_raw_ms(dev)
        kernels["K2"].update(ms_raw=raw["one_key_ms"], ms_raw_keyed=raw["keyed_ms"],
                             bound_keyed_ms=roofline_mixed(24 * n, 0, THREEFRY_OPS * n,
                                                           int32_rate)["bound_ms"])
        log(3, f"K2 threefry2x32: bitwise equal to utils.ktf (card and host) on 2^20 "
               f"counters x 3 keys; per 2^20 blocks: the wrapper {ms:.4f} ms, the kernel alone "
               f"(ctypes, buffers made once) {raw['one_key_ms']:.4f} ms with one key, "
               f"{raw['keyed_ms']:.4f} ms with a key per block; bound "
               f"{kernels['K2']['bound_ms']:.4f} / {kernels['K2']['bound_keyed_ms']:.4f} ms; "
               f"plain {plain_ms:.4f} ms on {smi}")
        r3 = phase3_draws(dev, smi, int32_rate)
        kernels.update(r3["rows"])
        log(3, r3["msg"])

    # ---- 4. K1/K4: traversal vs plain and brute force
    if 4 in phases:
        o, d = phase4_rays(scene, dev)
        m = o.shape[0] // 2
        before = cuda_traverse.LAUNCHES["trace_closest"]
        rk = cuda_traverse.trace_closest(o, d, scene.bvh4, BIG, sort=False)
        torch.cuda.synchronize()
        if cuda_traverse.LAUNCHES["trace_closest"] != before + 1:
            raise AssertionError("K4 did not launch")
        rp = cuda_traverse.trace_closest_plain(o, d, scene.bvh4, BIG)
        steps = cuda_traverse._traverse_plain(o, d, scene.bvh4,
                                              torch.full_like(o[:, 0], float(BIG)), 1e-3,
                                              count=True)[4]

        def compare(ref_t, ref_id, ref_hit, k, what):
            hit_ok = torch.equal(k["hit"], ref_hit)
            both = k["hit"] & ref_hit
            t_ok = bool(((k["t"][both] - ref_t[both]).abs()
                         <= T_RTOL * ref_t[both].abs()).all())
            flips = int((k["tri_id"][both] != ref_id[both]).sum())
            n_hit = int(both.sum())
            if not (hit_ok and t_ok):
                raise AssertionError(f"K4 vs {what}: hit mask equal {hit_ok}, t within "
                                     f"rtol {T_RTOL} {t_ok}")
            if flips > NEAR_TIE_MAX * max(n_hit, 1):
                raise AssertionError(f"K4 vs {what}: {flips} id flips at equal t in {n_hit} hits")
            return flips, n_hit

        f1, h1 = compare(rp["t"], rp["tri_id"], rp["hit"], rk, "plain")
        nb = 8192
        sel = torch.cat([torch.arange(0, nb // 2), torch.arange(m, m + nb // 2)]).to(dev)
        tb, ib = intersect_tris_brute(o[sel], d[sel], scene.mesh.vertices, scene.mesh.faces,
                                      1e-3, BIG, chunk=128)
        sub = {k2: v2[sel] for k2, v2 in rk.items()}
        f2, h2 = compare(tb, ib, tb < BIG, sub, "brute force")
        max_err = float((rk["t"] - rp["t"]).abs()[rk["hit"]].max()) if h1 else 0.0
        mts, traced = brute_mts(scene.bvh4, o, d, torch.full_like(o[:, 0], float(BIG)))
        n_brute = scene.bvh4.brute_tri.shape[0]
        cull = trace_bound_cull(scene.bvh4, o.shape[0], int(steps.sum()), mts)
        ms = cuda_ms(lambda: cuda_traverse.trace_closest(o, d, scene.bvh4, BIG, sort=False), 20)
        plain_ms = cuda_ms(lambda: cuda_traverse.trace_closest_plain(o, d, scene.bvh4, BIG), 3)
        kernels["K1"] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                             **trace_bound(scene.bvh4, o.shape[0], int(steps.sum())),
                             k1_steps=int(steps.sum()), bound_cull_ms=cull["bound_ms"],
                             bound_cull_by=cull["bound_by"], bound_cull_ops=cull["bound_ops"],
                             brute_mts_per_ray=mts / max(traced, 1))
        log(4, f"K4/K1 trace_closest on {2 * m} rays ({m} showcase-camera + {m} in-box): "
               f"{h1} hits; vs plain: hit masks equal, t within rtol {T_RTOL} "
               f"(max |dt| {max_err:.3g}), {f1} near-tie id flips; vs brute force on {nb} "
               f"rays x {scene.mesh.num_tris} tris: {h2} hits, {f2} near-tie id flips "
               f"(limit 1 in 5000); the culled brute pre-pass runs {mts / max(traced, 1):.4f} of "
               f"{n_brute} MT records per ray (brute_may_hit); bound exhaustive "
               f"{kernels['K1']['bound_ms']:.5f} ms, culled {cull['bound_ms']:.5f} ms "
               f"({cull['bound_by']}); kernel {ms:.3f} ms vs plain {plain_ms:.1f} ms on {smi}")

    # ---- 5. preflight known answer, kernel vs plain
    if 5 in phases:
        with open(EXPECTED) as f:
            expected = json.load(f)["mean_rgb_ktf"]
        cfg = RenderConfig(**PREFLIGHT)
        cam = showcase_camera(cfg)
        img_k = render_image_fused(scene, cam, cfg, 0)
        img_p = render_image_fused(scene, cam, cfg, 0, plain=True)
        torch.cuda.synchronize()
        mean_k = img_k.mean().item()
        rel = abs(mean_k - expected) / expected
        bad, mean_diff, max_err = image_agreement(img_k, img_p)
        if not (torch.isfinite(img_k).all() and rel <= PREFLIGHT_RTOL):
            raise AssertionError(f"preflight mean {mean_k} vs {expected}: rel {rel}")
        if not (bad <= IMG_BAD_FRAC and mean_diff <= MEAN_TOL):
            raise AssertionError(f"K3 vs plain: {bad:.4%} elements beyond tolerance, "
                                 f"mean diff {mean_diff}")
        ms = cuda_ms(lambda: render_image_fused(scene, cam, cfg, 0), 20)
        plain_ms = cuda_ms(lambda: render_image_fused(scene, cam, cfg, 0, plain=True), 2)
        kernels["K3"] = dict(max_abs_err=max_err, preflight_max_abs_err=max_err, ms=ms,
                             plain_ms=plain_ms)
        log(5, f"preflight 128x40 spp2 mb12: kernel mean {mean_k:.6f} vs {expected:.6f} "
               f"(rel {rel:.2e}, gate {PREFLIGHT_RTOL}); plain mean {img_p.mean().item():.6f}; "
               f"kernel vs plain: {bad:.4%} elements beyond 5e-4+2e-4|x| (limit 0.5%), "
               f"mean diff {mean_diff:.2e}, max abs {max_err:.3g}; "
               f"kernel {ms:.3f} ms vs plain {plain_ms:.1f} ms per frame on {smi}")

    # ---- 6. bitwise invariants of the kernel
    if 6 in phases:
        cfg = RenderConfig(width=128, height=64, spp=2, max_bounces=8)
        cam = showcase_camera(cfg)
        px, py, inv = (t.to(dev) for t in _tiled_pixel_grid(cfg))
        whole = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py)
        chunked = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py,
                                                     host_chunk_packets=3)
        shape64 = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py, block=64)
        shape256 = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py, block=256)
        px2, py2, inv2 = (t.to(dev) for t in blocked_pixel_grid(cfg, 32, 32, 8, 16))
        blk = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px2, py2)
        checks = {
            "host-chunked == whole": torch.equal(whole, chunked),
            "block 64 == block 128 == block 256": (torch.equal(whole, shape64)
                                                   and torch.equal(whole, shape256)),
            "blocked grid == tiled grid": torch.equal(whole[inv], blk[inv2]),
        }
        cfg4 = RenderConfig(width=128, height=64, spp=4, max_bounces=8, spp_per_pass=4)
        a = render_image_fused(scene, cam, cfg4, 9)
        b2 = render_image_fused(scene, cam, cfg4.replace(spp_per_pass=2), 9)
        checks["spp split by sample_offset (atol 2e-5, rtol 1e-5)"] = bool(
            torch.allclose(a, b2, atol=2e-5, rtol=1e-5))
        for k, ok in checks.items():
            if not ok:
                raise AssertionError(f"kernel invariant failed: {k}")
        log(6, "kernel invariants hold: " + "; ".join(checks))

    # ---- 7. the main path
    if 7 in phases:
        cfg = RenderConfig(**MAIN)
        cam = showcase_camera(cfg)
        render_image_fused(scene, cam, cfg, 0)   # warm-up (same shapes)
        torch.cuda.synchronize()
        cuda_megakernel.LAUNCHES["render_fused"] = 0
        cuda_megakernel.PLAIN_CALLS["render_plain"] = 0
        cuda_lane_grid.LAUNCHES["lane_grid"] = 0
        cuda_lane_grid.PLAIN_CALLS["lane_grid"] = 0
        t0 = time.perf_counter()
        img = render_image_fused(scene, cam, cfg, 0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n3 = cuda_megakernel.LAUNCHES["render_fused"]
        plain_calls = cuda_megakernel.PLAIN_CALLS["render_plain"]
        lg_launches = cuda_lane_grid.LAUNCHES["lane_grid"]
        if lg_launches != 1 or cuda_lane_grid.PLAIN_CALLS["lane_grid"]:
            raise AssertionError(f"main path: lane-grid launches {lg_launches}, plain lane grids "
                                 f"{cuda_lane_grid.PLAIN_CALLS['lane_grid']} (one launch a frame)")
        with open(EXPECTED) as f:
            expected = json.load(f)["mean_rgb_ktf"]
        mean = img.mean().item()
        if not bool(torch.isfinite(img).all()):
            raise AssertionError("2K image has non-finite pixels")
        if abs(mean - expected) / expected > MAIN_BAND:
            raise AssertionError(f"2K mean {mean} outside {MAIN_BAND} of {expected}")
        if n3 < 1 or plain_calls != 0:
            raise AssertionError(f"main path: K3 launches {n3}, plain path-loop calls "
                                 f"{plain_calls}")
        # The main-path frame against the plain version: a seeded sample of
        # pixels, each re-rendered from its lane of the frame's blocked grid
        # at the main config (spp 8, 20 bounces, seed 0). A pixel's radiance
        # depends on its own lane only, so the sample must agree with the
        # same pixels of the kernel's frame under the image tolerance.
        px, py, inv = (t.to(dev) for t in _fused_pixel_grid(cfg))
        pick = torch.from_numpy(np.random.default_rng(7).choice(
            cfg.width * cfg.height, MAIN_SAMPLE, replace=False)).to(dev)
        lane = inv[pick]
        t0 = time.perf_counter()
        ref, ro, rd, rt = recorded_rays(lambda: cuda_megakernel.render_tiles_fused_plain(
            scene, cam, cfg, 0, px[lane], py[lane]))
        torch.cuda.synchronize()
        sample_plain_s = time.perf_counter() - t0
        mts7, traced7 = brute_mts(scene.bvh4, ro, rd, rt, cfg.t_min)
        got = img.reshape(-1, 3)[pick]
        bad_s, mean_diff_s, max_err_s = image_agreement(got[None], ref[None])
        if not (bad_s <= IMG_BAD_FRAC and mean_diff_s <= MEAN_TOL):
            raise AssertionError(f"2K frame vs plain on {MAIN_SAMPLE} pixels: {bad_s:.4%} "
                                 f"elements beyond tolerance, mean diff {mean_diff_s}")
        log(7, f"2K frame vs plain version on {MAIN_SAMPLE} seeded pixels (blocked-grid lanes, "
               f"spp {cfg.spp}, mb {cfg.max_bounces}): {bad_s:.4%} elements beyond "
               f"5e-4+2e-4|x| (limit 0.5%), mean diff {mean_diff_s:.2e}, max abs "
               f"{max_err_s:.3g}, bitwise equal {torch.equal(got, ref)}; plain took "
               f"{sample_plain_s:.2f} s for them; their {traced7} traced rays run "
               f"{mts7 / max(traced7, 1):.4f} brute MT records each after the cull "
               f"(brute_may_hit)")
        rays = cfg.width * cfg.height * cfg.spp
        # Spread: ten more frames, timed the same way (host clock around a
        # synchronized frame; one K3 launch each). CUDA events around the
        # same calls give the frame's stream time, which includes the host's
        # gaps between the frame's launches (the events are queued before
        # them), so their share of the host time is host-inclusive, not the
        # card's busy share (phase 11 times the kernel alone).
        repeats, dev_s = [], []
        for _ in range(10):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev0.record()
            render_image_fused(scene, cam, cfg, 0)
            ev1.record()
            torch.cuda.synchronize()
            repeats.append(time.perf_counter() - t0)
            dev_s.append(ev0.elapsed_time(ev1) / 1e3)
        stream_share = sum(dev_s) / sum(repeats)
        os.makedirs(os.path.join(ROOT, "renders"), exist_ok=True)
        png = os.path.join(ROOT, "renders", "chip_smoke_2k.png")
        write_png(png, to_rgba8(img).cpu().numpy())
        med = float(np.median(repeats))
        kernels.setdefault("K3", {}).update(main_s=secs, main_median_s=med,
                                            max_abs_err=max_err_s,
                                            brute_mts_per_traced_ray=mts7 / max(traced7, 1),
                                            traced_rays_sampled=traced7)
        log(7, f"main path 2560x1440 spp8 mb20 (reference_scene, showcase camera): "
               f"{secs:.4f} s, {rays / secs / 1e6:.2f} M camera rays/s on {smi}; median of "
               f"{len(repeats)} repeats {med:.4f} s ({rays / med / 1e6:.2f} M camera rays/s); "
               f"mean {mean:.6f} "
               f"(band {MAIN_BAND} of {expected:.6f}); K3 launches {n3}, plain path-loop "
               f"calls {plain_calls}, LG launches {lg_launches}; wrote "
               f"{os.path.relpath(png, ROOT)}; "
               f"repeat frames (s, host clock): {', '.join(f'{r:.4f}' for r in repeats)}; "
               f"stream time (s, CUDA events): {', '.join(f'{r:.4f}' for r in dev_s)}; "
               f"host-inclusive stream share {stream_share:.3f}")
        launches = n3
    else:
        launches = lg_launches = 0

    if 21 in phases:
        r21 = phase21(dev, smi)
        kernels["LG"] = r21["row"]
        log(21, r21["msg"])

    if 22 in phases:
        r22 = phase22(dev, smi)
        kernels["K3-tree"] = r22["row"]
        log(22, r22["msg"])

    if 23 in phases:
        r23 = phase23(dev, smi)
        log(23, r23["msg"])
        print(json.dumps({"train_graph": r23["summary"]}), flush=True)

    if 8 in phases:
        r8, scaling = phase8(scene, dev)
        p8, t1 = r8["phase 8"], r8[f"training bounce {P8_TRAIN_BOUNCES[0]}"]
        kernels["K4"] = dict(
            max_abs_err=max(v["max_abs_err"] for v in r8.values()), ms=p8["ms"]["unsorted"][0],
            ms_kernel=p8["ms"]["kernel"][0], ms_1m=t1["ms"]["unsorted"][0],
            ms_kernel_1m=t1["ms"]["kernel"][0], ms_kernel_perm=p8["ms"]["kernel_perm"][0],
            ms_kernel_perm_1m=t1["ms"]["kernel_perm"][0],
            plain_ms=p8["plain_ms_subset"]["unsorted"], plain_ms_is=f"{P8_SUBSET} rays",
            k1_steps=p8["k1_steps"], **p8["bound"], bound_1m_ms=t1["bound"]["bound_ms"],
            bound_1m_by=t1["bound"]["bound_by"], bound_cull_ms=p8["bound_cull"]["bound_ms"],
            bound_cull_by=p8["bound_cull"]["bound_by"],
            bound_cull_ops=p8["bound_cull"]["bound_ops"],
            brute_mts_per_ray=p8["brute_mts"] / p8["rays"],
            launches_per_call=p8["launches"]["unsorted"])
        kernels["K4-sort"] = dict(
            max_abs_err=kernels["K4"]["max_abs_err"], ms=p8["ms"]["sorted"][0],
            ms_1m=t1["ms"]["sorted"][0], ms_keys=p8["ms"]["keys"][0],
            ms_keys_1m=t1["ms"]["keys"][0], argsort_ms=p8["ms"]["argsort"][0],
            argsort_ms_1m=t1["ms"]["argsort"][0],
            ms_intersect_bvh4_1m=t1["ms"]["intersect_bvh4"][0],
            plain_ms=p8["plain_ms_subset"]["sorted"], plain_ms_is=f"{P8_SUBSET} rays",
            library_ms=p8["ms"]["argsort"][0],
            library_is="torch.argsort(stable=True) of the int32 keys (the route's sort)",
            **p8["bound"], bound_1m_ms=t1["bound"]["bound_ms"],
            bound_1m_by=t1["bound"]["bound_by"], launches_per_call=p8["launches"]["sorted"])
        for name, v in r8.items():
            log(8, f"{name}: {v['rays']} rays ({v['hits']} hits, {v['dead']} dead, "
                   f"{v['limit_big']} at the limit BIG); {'; '.join(v['checks'])}: all hold "
                   f"(plain on {v['subset']} seeded rays, max |dt| {v['max_abs_err']:.3g}); in "
                   f"turns, median of 10 [min-max] ms per call: "
                   + "; ".join(f"{k} {m[0]:.4f} [{m[1]:.4f}-{m[2]:.4f}]"
                               for k, m in v["ms"].items())
                   + "; kernels (+ copies, memsets) per call: "
                   + "; ".join(f"{k} {c[0]} ({c[1]})" for k, c in v["launches"].items())
                   + f"; plain on the subset: unsorted {v['plain_ms_subset']['unsorted']:.1f} ms, "
                   f"sorted {v['plain_ms_subset']['sorted']:.1f} ms; {v['k1_steps']} K1 steps, "
                   f"{v['brute_mts']} brute MT records (plain count"
                   + (", subset scaled" if v["rays"] > v["subset"] else "") + f"); bound "
                   f"{v['bound']['bound_ms']:.5f} ms ({v['bound']['bound_by']}), culled "
                   f"{v['bound_cull']['bound_ms']:.5f} ms ({v['bound_cull']['bound_by']}) on {smi}")
        kernels["K4"].update(ms_kernel_x4=scaling["1,048,576 (x4)"][0])
        log(8, "K4 alone on phase 8's rays and on four copies of them, in turns, median of 10 "
               "[min-max] ms per call: " + "; ".join(
                   f"{k} {m[0]:.4f} [{m[1]:.4f}-{m[2]:.4f}]" for k, m in scaling.items())
            + f"; ratio {scaling['1,048,576 (x4)'][0] / scaling['262,144'][0]:.3f} on {smi}")
        print(json.dumps({"phase8": {k: {x: y for x, y in v.items() if x != "profile"}
                                     for k, v in r8.items()}, "scaling": scaling}), flush=True)

    if 9 in phases:
        r9 = phase9(scene, dev)
        if r9["k4"] < 1 or r9["k2"] < 1 or r9["plain"]:
            raise AssertionError(f"megakernel render: K4 launches {r9['k4']}, K2 launches "
                                 f"{r9['k2']}, plain calls {r9['plain']}")
        log(9, f"megakernel render_image_chunked {P9['width']}x{P9['height']} spp{P9['spp']} "
               f"mb{P9['max_bounces']} (ktf) in {r9['seconds']:.3f} s (mean of 5: "
               f"{r9['ms']:.2f} ms; K3 on the same frame {r9['ms_k3']:.3f} ms): mean "
               f"{r9['mean']:.6f} vs K3 {r9['mean_k3']:.6f}; {r9['bad']:.4%} elements beyond 5e-4+2e-4|x| (limit "
               f"0.5%), mean diff {r9['mean_diff']:.2e}, max abs {r9['max_abs']:.3g}; K4 "
               f"launches {r9['k4']} (sorted {r9['k4_sorted']}), K2 launches {r9['k2']}, plain "
               f"calls {r9['plain']}; jax family mean {r9['mean_jax']:.6f} (finite); CLI "
               f"--integrator megakernel wrote {r9['png']} in {r9['cli_s']:.1f} s")

    train = None
    if 10 in phases:
        train = phase10(dev)
        exp, exp2 = train["k4_expected"], train["k2_expected"]
        if (train["k4"] != exp or train["k4_sorted"] != exp or train["keys"] != exp
                or any(train[k] != v for k, v in exp2.items()) or train["plain"]):
            raise AssertionError(f"training path: K4 launches {train['k4']} (sorted "
                                 f"{train['k4_sorted']}, expected {exp}), key kernel launches "
                                 f"{train['keys']}, K2 route "
                                 f"{ {k: train[k] for k in exp2} } (expected {exp2}), plain "
                                 f"calls {train['plain']}")
        with open(INVERSE_REF) as f:
            ref = json.load(f)["loss_curve"][:P10_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(train["losses"], ref)]
        train["reference_losses"], train["loss_rel_err"] = ref, rel
        if max(rel) > LOSS_REF_RTOL:
            raise AssertionError(f"training losses {train['losses']} vs the JAX package's "
                                 f"{ref}: relative errors {rel} (limit {LOSS_REF_RTOL})")
        log(10, f"INVERSE_r05 config ({P10['width']}x{P10['height']} spp{P10['spp']} "
                f"mb{P10['max_bounces']}, {P10_PAIRS} pairs in chunks of {P10_CHUNK}): "
                f"{P10_STEPS} Adam steps, losses {train['losses']} (JAX package "
                f"{train['reference_losses']}, max rel err {max(train['loss_rel_err']):.2e}), "
                f"s/step {train['step_s']} (median of steps 2-3 {train['s_per_step']:.3f}), peak "
                f"memory {train['max_memory_allocated'] / 2**30:.2f} GiB; graph counters "
                f"{train['graphs']}; K4 launches the host enqueued {train['k4']} "
                f"({train['k4_formula']}), all sorted, key kernel launches {train['keys']}; K2 "
                f"route launches {train['k2']} ({train['k2_formula']}: Threefry "
                f"{train['k2_threefry']}, camera draws "
                f"{train['k2_camera']}, bounce draws {train['k2_bounce']}); one chunk's "
                f"forward and backward (torch.profiler): {train['chunk_kernels']['kernels']} "
                f"kernels, {train['chunk_kernels']['activities']} with memsets and copies, the "
                f"card busy {train['chunk_kernels']['busy_us'] / 1e3:.1f} ms of a "
                f"{train['chunk_kernels']['span_us'] / 1e3:.1f} ms span; "
                f"plain calls {train['plain']}; "
                f"at {P10_SMALL['width']}x{P10_SMALL['height']} spp{P10_SMALL['spp']} "
                f"mb{P10_SMALL['max_bounces']} K={P10_SMALL_PAIRS}: kernel vs plain loss "
                f"{train['small_loss']:.8g} vs {train['small_loss_plain']:.8g}, grad max |diff| "
                f"/ scale {train['grad_frac']:.3g} (limit {STEP_GRAD_FRAC}); FD vs autograd: "
                f"{train['fd']} on {smi}")
        print(json.dumps({"train": train}), flush=True)

    if 11 in phases:
        r11 = phase11(scene, dev, smi)
        kernels["K5"] = r11["row"]
        log(11, r11["msg"])
        lanes = lane_list_repeats(dev)
        kernels["K5"].update(lane_list_repeat_launches=lanes["launches"]["K5"],
                             lane_list_repeat_lanes=lanes["lanes"]["K5"])
        kernels.setdefault("K3", {}).update(lane_list_repeat_launches=lanes["launches"]["K3"],
                                            lane_list_repeat_lanes=lanes["lanes"]["K3"])
        log(11, lanes["msg"])

    if 12 in phases:
        r12 = phase12(scene, dev, smi)
        kernels["K3-profile"] = r12["row"]
        b = r12["bounds"]
        for key in ("K3", "K5"):
            if key in kernels:
                kernels[key].update(**b["preflight"], bound_2k_ms=b["2k"]["bound_ms"],
                                    bound_2k_by=b["2k"]["bound_by"])
        for key in ("K3", "K5"):   # both cull the brute pre-pass
            if key in kernels:
                kernels[key].update(bound_cull_2k_ms=b["2k_cull"]["bound_ms"],
                                    bound_cull_2k_by=b["2k_cull"]["bound_by"])
        log(12, r12["msg"])

    probes = None
    if 13 in phases:
        probes = phase13(dev, smi)
        kernels.update(probes.pop("rows"))
        print(json.dumps({"probes": probes}), flush=True)

    if 14 in phases:
        r14 = phase14(scene, dev, smi)
        kernels.update(r14["rows"])
        log(14, r14["msg"])

    wave = None
    if 16 in phases:
        r16 = phase16(scene, dev, smi)
        wave = r16["counts"]
        k4w = r16["k4"]
        kernels.setdefault("K4", {}).update(
            wavefront_ms=k4w["ms"]["unsorted"][0], wavefront_ms_kernel=k4w["ms"]["kernel"][0],
            wavefront_rays=k4w["rays"], wavefront_bound_ms=k4w["bound"]["bound_ms"],
            wavefront_bound_by=k4w["bound"]["bound_by"],
            wavefront_plain_ms=k4w["plain_ms_subset"]["unsorted"],
            wavefront_max_abs_err=k4w["max_abs_err"])
        kernels.setdefault("K2", {}).update(
            {f"wavefront_{k}_{f}": v[f] for k, v in r16["k2"].items()
             for f in ("lanes", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
        print(json.dumps({"wavefront": r16["summary"]}), flush=True)

    sharded = {}
    if 17 in phases:
        r17 = phase17(scene, dev, smi)
        log(17, r17["msg"])
        print(json.dumps({"sharding": dict(card=smi, checks=r17["checks"])}), flush=True)
        sharded = sharded_launches(r17["counts"])
    if 18 in phases:
        n_cards = torch.cuda.device_count()
        if n_cards < 4:
            raise SystemExit(f"chip_smoke: phase 18 needs 4 cards, {n_cards} visible")
        r18 = phase17(scene, dev, smi, cards=n_cards)
        log(18, r18["msg"])
        cards = [device_line(f"cuda:{i}") for i in range(n_cards)]
        print(json.dumps({"sharding_cards": dict(cards=cards, checks=r18["checks"])}), flush=True)

    if 19 in phases:
        r19 = phase19(scene, dev, smi)
        log(19, r19["msg"])
        print(json.dumps({"lbvh": r19["summary"]}), flush=True)
    if 20 in phases:
        r20 = phase20(dev, smi)
        log(20, r20["msg"])
        print(json.dumps({"milestones": r20["summary"]}), flush=True)

    if 15 in phases:
        r15 = phase15(scene, dev, smi, args.parent)
        print(json.dumps({"old_vs_new": r15["json"]}), flush=True)
        log(15, r15["msg"])

    # Kernel rows. `launches` counts the launches of the path each kernel
    # serves, with the counters set to 0 just before that path ran: K3 in
    # phase 7 (serving); K4, K4-sort and the standalone K2 in phase 10
    # (training; the K2 rows split the K2 route's launches into Threefry,
    # camera and bounce draws); K5 in phase 11 (the 2K frame with interleave 2);
    # K3-profile in phase 12 (build_schedule at 2K); the probes in phase 13
    # (their entry points); the width-4 kernels in phase 14 (the CLI on
    # the 4-wide tree); LG in phase 7 (one a frame; phase 16 adds the
    # wavefront frame's, and phase 21 times it alone). K1 is __device__
    # code inside K3 and K4, and K2 runs inline in K3 too: those rows add
    # the serving path's K3 launches.
    # The wavefront path (phase 16) adds its own counts, from 0 just before
    # one 2K frame: K4's and K1's (one per iteration) and K2's Threefry
    # launches, as wavefront_path_launches fields.
    # The sharded paths (phase 17) add theirs, each from 0 just before one
    # frame or render, as sharded_path_launches fields (sharded_launches).
    # ms / plain_ms / max_abs_err / the bound come from the phase that
    # times each kernel alone (3, 4, 5/7, 8, 11, 12, 13, 14, 21, 22).
    src = "raytracer_tpu_torch/csrc/"
    t_k4 = train["k4"] if train else 0
    table = [
        ("fused_path_loop (K3)", "megakernel.cu", "raytracer_tpu/ops/pallas_megakernel.py:623",
         "K3", launches, {}),
        ("bvh8_traverse (K1, inline in K3 and K4; timed alone through K4 trace_closest.cu)",
         "traverse.cuh", "raytracer_tpu/ops/pallas_traverse.py:319", "K1", t_k4,
         {"launches_are": "K4 launches of the training path, which runs this code inline",
          "serving_path_launches_via_K3": launches,
          "wavefront_path_launches_via_K4": wave["k4"] if wave else 0}),
        ("threefry2x32 (K2: standalone in the differentiable path's key folds and the "
         "wavefront's draws, inline in K3)",
         "ktf.cu", "raytracer_tpu/utils/ktf.py:65", "K2", train["k2_threefry"] if train else 0,
         {"serving_path_launches_via_K3": launches,
          "wavefront_path_launches": wave["k2_threefry"] if wave else 0}),
        ("camera draws (K2: a trace's jitter and lens draws, and the jax family's lane keys, "
         "in one launch)", "ktf.cu", "raytracer_tpu/utils/rng.py:41-120 (the jax.random draws "
         "XLA fuses; Threefry raytracer_tpu/utils/ktf.py:65)", "K2-camera",
         train["k2_camera"] if train else 0, {}),
        ("bounce draws (K2: a bounce's roulette, scatter and dielectric draws in one launch)",
         "ktf.cu", "raytracer_tpu/utils/rng.py:41-120 (the jax.random draws XLA fuses; "
         "Threefry raytracer_tpu/utils/ktf.py:65)", "K2-bounce",
         train["k2_bounce"] if train else 0, {}),
        ("trace_closest (K4)", "trace_closest.cu", "raytracer_tpu/ops/pallas_traverse.py:907",
         "K4", t_k4, {"wavefront_path_launches": wave["k4"] if wave else 0}),
        ("trace_closest coherence-sorted (K4-sort: the key kernel, the argsort, K4 through the "
         "permutation)", "trace_closest.cu", "raytracer_tpu/ops/pallas_traverse.py:961", "K4-sort",
         train["k4_sorted"] if train else 0,
         {"key_kernel_launches": train["keys"] if train else 0}),
        ("fused_path_loop G=2 (K5: two lanes per thread refilling from the lane list, "
         "traversals merged in traverse.cuh traverse2)", "interleave.cuh",
         "raytracer_tpu/ops/pallas_megakernel.py:538 (per_pair) "
         "-> raytracer_tpu/ops/pallas_interleave.py:22", "K5",
         kernels.get("K5", {}).get("launches", 0), {}),
        ("fused_path_loop profile (K3-profile)", "megakernel.cu",
         "raytracer_tpu/ops/pallas_megakernel.py:493 (profile=True) with "
         "raytracer_tpu/ops/pallas_traverse.py:333", "K3-profile",
         kernels.get("K3-profile", {}).get("launches", 0), {}),
        ("traversal-iteration ablation of the round-5 BVH8 body (P-v8, 7 variants)",
         "probe_v8.cu", "scripts/kernel_ablate_v8.py:49", "P-v8",
         kernels.get("P-v8", {}).get("launches", 0), {}),
        ("v5-body phase ablation (P-ablate, 5 variants)", "probe_v5.cu",
         "scripts/kernel_ablate.py:33", "P-ablate",
         kernels.get("P-ablate", {}).get("launches", 0), {}),
        ("v5-body row-load probe (P-load, 3 modes)", "probe_v5.cu",
         "scripts/kernel_load_probe.py:43", "P-load",
         kernels.get("P-load", {}).get("launches", 0), {}),
        ("v5-body loop-floor probe (P-floor, 5 modes)", "probe_v5.cu",
         "scripts/kernel_floor_probe.py:48", "P-floor",
         kernels.get("P-floor", {}).get("launches", 0), {}),
        ("v5-body base-cost probe without loads (P-base, 4 modes)", "probe_v5_part3.cu",
         "scripts/kernel_base_probe.py:40", "P-base",
         kernels.get("P-base", {}).get("launches", 0), {}),
        ("v5 full body, G packets per block (P-interleave, G = 1, 2, 4, 8)",
         "probe_interleave.cu", "scripts/kernel_interleave_probe.py:37", "P-interleave",
         kernels.get("P-interleave", {}).get("launches", 0), {}),
        ("scalar unit costs beside vector work (P-scalar, 6 variants + smem16 tables pre-pass)",
         "probe_scalar.cu", "scripts/scalar_cost_probe.py:37", "P-scalar",
         kernels.get("P-scalar", {}).get("launches", 0), {}),
        ("stack disciplines: shift register, shared memory, pointer (P-vstack, 5 cases)",
         "probe_vstack.cu", "scripts/vstack_probe.py:68 (p1), :130 (p2), :244 and :292 (p3)",
         "P-vstack", kernels.get("P-vstack", {}).get("launches", 0), {}),
        ("the path loop's random-number operations in a kernel (P-ktf, 5 cases)", "probe_ktf.cu",
         "scripts/ktf_kernel_probe.py:21 (run_case; calls :34, :141)", "P-ktf",
         kernels.get("P-ktf", {}).get("launches", 0), {}),
        ("dual-unit traversal on the row-per-node v6 tables (P-v6)", "probe_v6.cu",
         "scripts/kernel_v6_probe.py:94 (_make_kernel_v6; call :358)", "P-v6",
         kernels.get("P-v6", {}).get("launches", 0), {}),
        ("the v5 body morphed toward K4 one delta at a time (P-morph, 13 variants)",
         "probe_morph.cuh", "scripts/kernel_morph.py:52 (run_variant; call :324)", "P-morph",
         kernels.get("P-morph", {}).get("launches", 0), {}),
        ("Mosaic primitives of the sub-warp kernel (P-mosaic, 7 cases)", "probe_mosaic.cu",
         "scripts/mosaic_probe.py:21 (run; call :22)", "P-mosaic",
         kernels.get("P-mosaic", {}).get("launches", 0), {}),
        ("id bitcasts and int broadcast-selects on the v5 tables (P-bitcast, p1-p4)",
         "probe_bitcast.cu", "scripts/bitcast_probe.py:48 (p1), :83 (p2), :116 (p3), :149 (p4); "
         "calls :69, :101, :136, :173", "P-bitcast",
         kernels.get("P-bitcast", {}).get("launches", 0), {}),
        ("one kernel construct per stage (P-feature, s1-s6; s7 is K4)", "probe_feature.cu",
         "scripts/kernel_feature_probe.py:36 (s1) .. :196 (s6); calls :46, :72, :103, :142, "
         ":186, :232", "P-feature", kernels.get("P-feature", {}).get("launches", 0), {}),
        ("fused_path_loop (K3) on a 4-wide tree", "megakernel_w4.cu",
         "raytracer_tpu/ops/pallas_megakernel.py:623 (n_children 4, :146)", "K3/w4",
         kernels.get("K3/w4", {}).get("launches", 0), {"width": 4}),
        ("trace_closest (K4, K1 inline) on a 4-wide tree", "trace_closest.cu",
         "raytracer_tpu/ops/pallas_traverse.py:907 (n_children 4, :909)", "K4/w4",
         kernels.get("K4/w4", {}).get("launches", 0), {"width": 4}),
        ("fused_path_loop profile (K3-profile) on a 4-wide tree", "megakernel_w4.cu",
         "raytracer_tpu/ops/pallas_megakernel.py:493 (profile=True, n_children 4)",
         "K3-profile/w4", 0, {"width": 4}),
        ("fused_path_loop G=2 (K5) on a 4-wide tree", "interleave_w4.cu",
         "raytracer_tpu/ops/pallas_megakernel.py:538 (per_pair, n_children 4) -> "
         "raytracer_tpu/ops/pallas_interleave.py:22", "K5/w4",
         kernels.get("K5/w4", {}).get("launches", 0), {"width": 4}),
        ("fused_path_loop with the sphere tree (K3-tree: the spheres found through the tree's "
         "walk in traverse.cuh, the RTIOW scene)", "megakernel_tree.cu",
         "raytracer_tpu/ops/pallas_megakernel.py:623 (the JAX package sweeps every sphere)",
         "K3-tree", kernels.get("K3-tree", {}).get("launches", 0), {}),
        ("lane grid (LG: the lanes' px, py and every pixel's lane, blocked or tiled layout, in "
         "one launch)", "lane_grid.cu", "none: the JAX package builds the grid in numpy on the "
         "host (raytracer_tpu/schedule.py:116, raytracer_tpu/models/wavefront.py:416)", "LG",
         lg_launches, {"wavefront_path_launches": wave["lg"] if wave else 0}),
    ]
    rows = []
    for name, source, replaces, key, n_launch, extra in table:
        extra = {**extra, **({"sharded_path_launches": sharded[key]} if key in sharded else {})}
        r = kernels.get(key, {})
        row = {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
               "launches": n_launch, "max_abs_err": r.get("max_abs_err"),
               "ms": r.get("ms"), "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
               "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"), **extra}
        if "main_s" in r:
            row["main_path_s"] = r["main_s"]
            row["main_path_median_s"] = r["main_median_s"]
            row["max_abs_err_is"] = f"2K frame vs plain on {MAIN_SAMPLE} seeded pixels"
        for k, v in r.items():
            if k not in row and k not in ("main_s", "main_median_s", "launches"):
                row[k] = v
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# Per lane of a draw kernel (csrc/ktf.cu): Threefry blocks (each
# THREEFRY_OPS int32 operations) and fp32 operations, counted from the
# source. jax family: a uniform 1 (the subtraction), a normal 31 (its
# uniform, scale, shift and clamp, ErfInv's 26 with log1p as one, the
# sqrt(2) product), a unit vector 3 normals + 10 (norm, clamp, divides), a
# disk 8 (2 uniforms, sqrt, scale, cos, sin, 2 products). ktf family: a
# uniform 2, a unit vector 15, a disk 10.
DRAW_WORK = {  # (family, site): (blocks, blocks of the roulette draw, fp32, fp32 of roulette)
    ("jax", "camera"): (8, 0, 10, 0), ("jax", "bounce"): (7, 2, 104, 1),
    ("ktf", "camera"): (2, 0, 14, 0), ("ktf", "bounce"): (2, 1, 17, 2)}


def draw_bound(family: str, site: str, n_px: int, lanes: int, rr: bool, int32_rate) -> dict:
    """The bound of one draw kernel launch over `lanes` lanes of `n_px`
    pixels: its inputs read once (jax: the pixel keys at a camera, the lane
    keys at a bounce; ktf: a key pair and an id per pixel) and its outputs
    written once (4 floats at a camera, with the jax family's lane keys;
    the dielectric, the unit vector and the roulette draw at a bounce),
    and DRAW_WORK's operations."""
    blocks, rr_blocks, fp, rr_fp = DRAW_WORK[(family, site)]
    if rr:
        blocks, fp = blocks + rr_blocks, fp + rr_fp
    if site == "camera":
        nbytes = (8 if family == "jax" else 12) * n_px + (24 if family == "jax" else 16) * lanes
    else:
        nbytes = (8 * lanes if family == "jax" else 12 * n_px) + (20 if rr else 16) * lanes
    return roofline_mixed(nbytes, fp * lanes, THREEFRY_OPS * blocks * lanes, int32_rate)


def _max_ulp(a, b) -> int:
    import torch

    return int((a.contiguous().view(torch.int32).long()
                - b.contiguous().view(torch.int32).long()).abs().max())


def new_draw_sites(dev) -> dict:
    """chain_draw_sites' sites through the draw kernels (utils/rng
    TraceDraws: one launch per camera and per bounce)."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.utils import rng

    cfg = RenderConfig(**P10)
    pair, pix, m = training_keys(dev)
    pkeys = rng.lane_keys(pair, pix)
    skeys = rng.camera_draws(pkeys, m, 0)["keys"]
    sites = {"lane keys": lambda: rng.lane_keys(pair, pix),
             "camera": lambda: rng.TraceDraws(pkeys, m, 0).camera().numbers()}
    sites.update({f"bounce {b}": (lambda b=b: rng.bounce_draws(skeys, b, b >= cfg.min_bounces))
                  for b in range(cfg.max_bounces)})
    return sites


def phase3_draws(dev, smi, int32_rate):
    """The draw kernels at the training path's size (training_keys:
    1,048,576 lanes of 131,072 pixels): in both families the camera draws
    and a bounce's draws with and without the roulette draw, against the
    plain chain on the card (kernel=False) bit for bit (normals: also
    their ulp count), timed against the plain chain and against the chain
    through K2 (the route before them), with their bound; and the
    training chunk's draw sites as torch.profiler sees them, chain against
    kernels."""
    import torch

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.utils import ktf, rng

    cfg = RenderConfig(**P10)
    pair, pix, m = training_keys(dev)
    pkeys = rng.lane_keys(pair, pix)
    n, total = pix.shape[0], pix.shape[0] * m
    skeys = rng.camera_draws_plain(pkeys, m, 0)["keys"]
    tr = ktf.TraceDraws(pair[0], pair[1], pix, m, 0)
    b_rr = cfg.min_bounces
    cases = {  # name: (kernel, plain on the card, chain through K2, family, site, rr)
        "jax camera": (lambda: rng.camera_draws(pkeys, m, 0),
                       lambda: rng.camera_draws_plain(pkeys, m, 0),
                       lambda: rng.camera_draws_plain(pkeys, m, 0, kernel=True),
                       "jax", "camera", False),
        f"jax bounce {b_rr}": (lambda: rng.bounce_draws(skeys, b_rr, True),
                               lambda: rng.bounce_draws_plain(skeys, b_rr, True),
                               lambda: rng.bounce_draws_plain(skeys, b_rr, True, kernel=True),
                               "jax", "bounce", True),
        "jax bounce 0": (lambda: rng.bounce_draws(skeys, 0, False),
                         lambda: rng.bounce_draws_plain(skeys, 0, False),
                         lambda: rng.bounce_draws_plain(skeys, 0, False, kernel=True),
                         "jax", "bounce", False),
        "ktf camera": (lambda: ktf.camera_draws(tr), lambda: ktf.camera_draws_plain(tr),
                       lambda: ktf.camera_draws_plain(tr, kernel=True), "ktf", "camera", False),
        f"ktf bounce {b_rr}": (lambda: ktf.bounce_draws(tr, b_rr, True),
                               lambda: ktf.bounce_draws_plain(tr, b_rr, True),
                               lambda: ktf.bounce_draws_plain(tr, b_rr, True, kernel=True),
                               "ktf", "bounce", True),
    }
    res = {}
    for name, (kern, plain, chain, family, site, rr) in cases.items():
        got, want, old = kern(), plain(), chain()
        torch.cuda.synchronize()
        differ, ulps = [], {}
        for k, v in want.items():
            if k == "keys":
                same = all(torch.equal(a, b) for a, b in zip(got[k], v))
                same_old = all(torch.equal(a, b) for a, b in zip(old[k], v))
            else:
                same, same_old = _bitwise(got[k], v), _bitwise(old[k], v)
                ulps[k] = _max_ulp(got[k], v)
            if not (same and same_old):
                differ.append(k)
        bits_fields = [k for k in want if k not in ("scatter", "lens_x", "lens_y")]
        if any(k in differ for k in bits_fields) or any(u > NORMAL_ULP for u in ulps.values()):
            raise AssertionError(f"{name} draws vs the plain chain: fields {differ} differ, "
                                 f"max ulp {ulps}")
        res[name] = dict(differ=differ, max_ulp=max(ulps.values()),
                         max_abs_err=max(_max_abs(got[k], want[k]) for k in ulps),
                         ms=cuda_ms(kern, 50), plain_ms=cuda_ms(plain, 5),
                         chain_ms=cuda_ms(chain, 10),
                         **draw_bound(family, site, n, total, rr, int32_rate),
                         kernels=kernels_launched(kern).get("kernels"),
                         chain_kernels=kernels_launched(chain).get("kernels"))
    chain_sites = site_census(chain_draw_sites(dev))
    new_sites = site_census(new_draw_sites(dev))
    per_chunk = {"chain": draws_per_chunk(chain_sites), "kernels": draws_per_chunk(new_sites)}

    def row(name, other):
        r = res[name]
        return dict(max_abs_err=max(r["max_abs_err"], res[other]["max_abs_err"]), ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    bound_ops=r["bound_ops"], bound_int32_ops=r["bound_int32_ops"],
                    bound_bytes=r["bound_bytes"], chain_ms=r["chain_ms"],
                    lanes=total, cases={k: res[k] for k in (name, other)},
                    max_abs_err_is="kernel vs the plain chain on the card, both families (0: "
                                   "bit for bit)")

    rows = {"K2-camera": row("jax camera", "ktf camera"),
            "K2-bounce": row(f"jax bounce {b_rr}", f"ktf bounce {b_rr}")}
    rows["K2-bounce"]["cases"]["jax bounce 0"] = res["jax bounce 0"]
    rows["K2-camera"].update(draw_kernels_per_chunk=per_chunk, sites_chain=chain_sites,
                             sites_kernels=new_sites)
    msg = (f"draw kernels at {total} lanes ({n} pixels x {m} samples, the training path's "
           f"first trace): against the plain chain on the card, "
           + "; ".join(f"{k}: fields not bitwise {v['differ']} (max ulp {v['max_ulp']}), kernel "
                       f"{v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']}), plain "
                       f"chain {v['plain_ms']:.3f} ms, chain through K2 {v['chain_ms']:.3f} ms, "
                       f"kernels per call {v['kernels']} (chain {v['chain_kernels']})"
                       for k, v in res.items())
           + f"; a training chunk's draws launch {per_chunk['kernels']} kernels (chain "
           f"{per_chunk['chain']}); per site (torch.profiler; kernels, busy share, ms): "
           + "; ".join(f"{k} {chain_sites[k]['kernels']} / {new_sites[k]['kernels']}, "
                       f"{chain_sites[k]['busy_share'] or 0:.3f} / "
                       f"{new_sites[k]['busy_share'] or 0:.3f}, {chain_sites[k]['ms']:.3f} / "
                       f"{new_sites[k]['ms']:.4f}" for k in chain_sites)
           + f" (chain / kernels) on {smi}")
    return dict(rows=rows, msg=msg)


def phase4_rays(scene, dev):
    """131,072 rays: 65,536 showcase-camera rays of the 2K frame at seeded
    pixels and 65,536 from seeded points inside the mesh's box in seeded
    directions (default_rng(4))."""
    import torch

    from raytracer_tpu_torch.camera import generate_rays, showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.utils import ktf

    gen = np.random.default_rng(4)
    cfg = RenderConfig(**MAIN)
    cam = showcase_camera(cfg)
    m = 65536
    pxs = torch.from_numpy(gen.integers(0, cfg.width, m).astype(np.int32)).to(dev)
    pys = torch.from_numpy(gen.integers(0, cfg.height, m).astype(np.int32)).to(dev)
    o_cam, d_cam = generate_rays(cam, pxs, pys, cfg.width, cfg.height,
                                 ktf.sampler(0, pys * cfg.width + pxs))
    v = scene.mesh.vertices
    lo, hi = v.min(dim=0).values, v.max(dim=0).values
    span = hi - lo
    o_box = lo + span * (0.02 + 0.96 * torch.from_numpy(
        gen.uniform(size=(m, 3)).astype(np.float32)).to(dev))
    d_box = torch.from_numpy(gen.normal(size=(m, 3)).astype(np.float32)).to(dev)
    return torch.cat([o_cam, o_box]).contiguous(), torch.cat([d_cam, d_box]).contiguous()


def _reset_fused_counts():
    from raytracer_tpu_torch.ops import cuda_megakernel

    for d in (cuda_megakernel.LAUNCHES, cuda_megakernel.PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _frames_in_turns(renders: dict, turns: int):
    """Each render of `renders` (name -> fn) `turns` times in alternating
    order (a, b, ..., b, a, ...): host seconds around a synchronized frame
    and CUDA-event seconds. Returns {name: (host list, device list)}."""
    import torch

    times = {k: ([], []) for k in renders}
    names = list(renders)
    for t in range(turns):
        for name in (names if t % 2 == 0 else names[::-1]):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            renders[name]()
            ev1.record()
            torch.cuda.synchronize()
            times[name][0].append(time.perf_counter() - t0)
            times[name][1].append(ev0.elapsed_time(ev1) / 1e3)
    return times


def _fmt(xs):
    return ", ".join(f"{x:.4f}" for x in xs)


def phase11(scene, dev, smi):
    """K5: bitwise against K3, timed against it in turns, the three
    fused kernels' resources, and the CLI with RAYTRACER_TPU_INTERLEAVE=2."""
    import torch

    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.fused import render_image_fused
    from raytracer_tpu_torch.ops import cuda_megakernel as cm
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid, blocked_pixel_grid

    # Preflight frame and an odd lane count.
    cfg = RenderConfig(**PREFLIGHT)
    cam = showcase_camera(cfg)
    g1 = render_image_fused(scene, cam, cfg, 0, interleave=1)
    g2 = render_image_fused(scene, cam, cfg, 0, interleave=2)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    odd1 = cm.render_tiles_fused(scene, cam, cfg, 0, px[:1023], py[:1023], interleave=1)
    odd2 = cm.render_tiles_fused(scene, cam, cfg, 0, px[:1023], py[:1023], interleave=2)
    if not (torch.equal(g1, g2) and torch.equal(odd1, odd2)):
        raise AssertionError(f"K5 vs K3: preflight equal {torch.equal(g1, g2)}, 1,023 lanes "
                             f"equal {torch.equal(odd1, odd2)}")
    # K5 against its plain version (K3's: G = 2 equals G = 1 per lane) on
    # the preflight lanes, under phase 5's image tolerance; that one call
    # is also the plain time.
    k5 = cm.render_tiles_fused(scene, cam, cfg, 0, px, py, interleave=2)
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    plain = cm.render_tiles_fused_plain(scene, cam, cfg, 0, px, py)
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    bad, mean_diff, max_err = image_agreement(k5[None], plain[None])
    if not (bad <= IMG_BAD_FRAC and mean_diff <= MEAN_TOL):
        raise AssertionError(f"K5 vs plain on the preflight lanes: {bad:.4%} elements beyond "
                             f"tolerance, mean diff {mean_diff}")
    # Kernel times on a lane grid made once (render_image_fused builds
    # the grid anew, on the card, for every frame).
    ms = cuda_ms(lambda: cm.render_tiles_fused(scene, cam, cfg, 0, px, py, interleave=2), 20)
    ms_k3 = cuda_ms(lambda: cm.render_tiles_fused(scene, cam, cfg, 0, px, py, interleave=1), 20)

    # The main configuration: the K5 path with the counts from 0, then
    # G=1 against G=2 bitwise and in turns, as whole frames and as kernels
    # alone on the frame's blocked grid.
    cfg = RenderConfig(**MAIN)
    cam = showcase_camera(cfg)
    bx, by, _ = (t.to(dev) for t in blocked_pixel_grid(cfg, 32, 32, 8, 16))
    render_image_fused(scene, cam, cfg, 0, interleave=2)   # warm-up (same shapes)
    torch.cuda.synchronize()
    _reset_fused_counts()
    img2 = render_image_fused(scene, cam, cfg, 0, interleave=2)
    torch.cuda.synchronize()
    counts = dict(cm.LAUNCHES, **cm.PLAIN_CALLS)
    if counts["render_fused_g2"] < 1 or counts["render_plain"] or counts["render_fused"]:
        raise AssertionError(f"K5 path: counts {counts}")
    img1 = render_image_fused(scene, cam, cfg, 0, interleave=1)
    if not torch.equal(img1, img2):
        raise AssertionError("K5 vs K3 on the 2K frame: not bitwise equal")
    times = _frames_in_turns(
        {"K3 frame": lambda: render_image_fused(scene, cam, cfg, 0, interleave=1),
         "K5 frame": lambda: render_image_fused(scene, cam, cfg, 0, interleave=2),
         "K3": lambda: cm.render_tiles_fused(scene, cam, cfg, 0, bx, by, interleave=1),
         "K5": lambda: cm.render_tiles_fused(scene, cam, cfg, 0, bx, by, interleave=2)}, 10)
    med = {k: float(np.median(v[0])) for k, v in times.items()}
    med_dev = {k: float(np.median(v[1])) for k, v in times.items()}
    res = cm.kernel_resources()

    k3_blocked = cm.render_tiles_fused(scene, cam, cfg, 0, bx, by, interleave=1)

    # The cull's witness on whole frames: K3 (culled) against the plain
    # version (exhaustive pre-pass) on every lane of the 2K frame's
    # blocked grid, bit for bit.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain2k = cm.render_tiles_fused_plain(scene, cam, cfg, 0, bx, by)
    torch.cuda.synchronize()
    plain2k_s = time.perf_counter() - t0
    if not torch.equal(k3_blocked, plain2k):
        bad_l = int((k3_blocked != plain2k).any(dim=1).sum())
        raise AssertionError(f"K3 vs plain on the whole 2K frame: {bad_l} lanes differ")

    # The CLI under RAYTRACER_TPU_INTERLEAVE=2, in this process so that
    # the counts can be read.
    png = os.path.join("renders", "chip_smoke_k5_cli.png")
    os.makedirs(os.path.join(ROOT, "renders"), exist_ok=True)
    cli_counts, head = _cli_counts(["--integrator", "fused", "--scene", "cornell_bunny",
                                    "--width", "256", "--height", "144", "--spp", "4",
                                    "--max-bounces", "8", "--out", png],
                                   {"RAYTRACER_TPU_INTERLEAVE": "2"})
    if (head != b"\x89PNG\r\n\x1a\n" or cli_counts["render_fused_g2"] < 1
            or cli_counts["render_plain"] or cli_counts["render_fused"]):
        raise AssertionError(f"CLI with RAYTRACER_TPU_INTERLEAVE=2: PNG {head!r}, counts "
                             f"{cli_counts}")
    row = dict(launches=counts["render_fused_g2"], max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               ms_k3_same_lanes=ms_k3, main_path_median_s=med["K5 frame"],
               main_path_median_s_k3=med["K3 frame"], kernel_2k_median_s=med["K5"],
               kernel_2k_median_s_k3=med["K3"], kernel_2k_median_device_s=med_dev["K5"],
               kernel_2k_median_device_s_k3=med_dev["K3"],
               num_regs=res["K5"][0], local_bytes=res["K5"][1],
               k3_vs_plain_2k_lanes=int(bx.shape[0]), plain_2k_s=plain2k_s,
               max_abs_err_is="K5 vs plain on the preflight lanes (K5 == K3 bitwise on the "
                              "preflight frame, 1,023 lanes and the 2K frame; K3 == plain "
                              "bitwise on the whole 2K frame)")
    msg = (f"K5 == K3 bitwise on the preflight frame, on 1,023 lanes and on the 2K spp8 mb20 "
           f"frame; K5 vs plain on the {px.shape[0]} preflight lanes: {bad:.4%} elements beyond "
           f"5e-4+2e-4|x| (limit 0.5%), mean diff {mean_diff:.2e}, max abs {max_err:.3g}, bitwise "
           f"equal {torch.equal(k5, plain)}; K5 path counts {counts}; preflight lanes K5 "
           f"{ms:.3f} ms vs K3 {ms_k3:.3f} ms vs plain {plain_ms:.1f} ms (one call); 2K in "
           f"turns, median of 10 (host s / CUDA events s): "
           + ", ".join(f"{k} {med[k]:.4f} / {med_dev[k]:.4f}" for k in times)
           + f"; K5/K3 kernels {med['K5'] / med['K3']:.3f}, frames "
           f"{med['K5 frame'] / med['K3 frame']:.3f}; the card idles "
           f"{1 - med['K3'] / med['K3 frame']:.3f} of a K3 frame (the host's work around K3); "
           f"K3 kernel host s {_fmt(times['K3'][0])}; K5 kernel host s {_fmt(times['K5'][0])}; "
           f"numRegs / localSizeBytes: "
           + ", ".join(f"{k} {r} / {b}" for k, (r, b) in res.items())
           + f"; K3 == plain (exhaustive pre-pass) bit for bit on every one of the 2K frame's "
           f"{bx.shape[0]} lanes (plain {plain2k_s:.1f} s)"
           + f"; CLI RAYTRACER_TPU_INTERLEAVE=2 wrote {png}, counts {cli_counts} on {smi}")
    return dict(row=row, msg=msg)


def phase12(scene, dev, smi):
    """K3-profile against K3 and its plain version, its overhead and the
    warps' divergence at 2K, and the profile-guided schedule."""
    import torch

    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import cuda_megakernel as cm
    from raytracer_tpu_torch.schedule import (_tiled_pixel_grid, blocked_pixel_grid,
                                              build_schedule, order_by_cost)

    cfg = RenderConfig(**PREFLIGHT)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    k3 = cm.render_tiles_fused(scene, cam, cfg, 0, px, py)
    rgb, cost, aux = cm.render_tiles_fused(scene, cam, cfg, 0, px, py, profile=True)
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    _, p_cost, p_aux = cm.render_tiles_fused_plain(scene, cam, cfg, 0, px, py, profile=True)
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)   # that one call
    checks = {"rgb == K3": torch.equal(rgb, k3), "cost == plain": torch.equal(cost, p_cost),
              "aux == plain": torch.equal(aux, p_aux)}
    if not all(checks.values()):
        raise AssertionError(f"K3-profile at the preflight size: {checks}")
    ms = cuda_ms(lambda: cm.render_tiles_fused(scene, cam, cfg, 0, px, py, profile=True), 20)
    ms_k3 = cuda_ms(lambda: cm.render_tiles_fused(scene, cam, cfg, 0, px, py), 20)
    # The work of a preflight frame, from its lane counts: the bound of
    # K3, K5 and K3-profile at the size their `ms` is timed at (the
    # exhaustive brute pre-pass, the work of the JAX kernel).
    _, _, _, pk1, pit = cm.render_tiles_fused(scene, cam, cfg, 0, px, py, profile=True,
                                              lane_counts=True)
    bounds = {"preflight": path_bound(scene.bvh4, px.shape[0], cfg.spp, int(pk1.sum()),
                                      int(pit.sum()))}

    cfg = RenderConfig(**MAIN)
    cam = showcase_camera(cfg)
    grids = {"tiled": _tiled_pixel_grid(cfg), "blocked": blocked_pixel_grid(cfg, 32, 32, 8, 16)}
    grids = {k: tuple(t.to(dev) for t in v) for k, v in grids.items()}
    # The schedule path: the profile at spp 2, then the scheduled frame.
    build_schedule(scene, cam, cfg, 0, profile_spp=2)       # warm-up (same shapes)
    torch.cuda.synchronize()
    _reset_fused_counts()
    t0 = time.perf_counter()
    grids["scheduled"] = build_schedule(scene, cam, cfg, 0, profile_spp=2)
    torch.cuda.synchronize()
    schedule_s = time.perf_counter() - t0
    px2, py2, inv2 = grids["scheduled"]
    sched = cm.render_tiles_fused(scene, cam, cfg, 0, px2, py2)[inv2]
    torch.cuda.synchronize()
    counts = dict(cm.LAUNCHES, **cm.PLAIN_CALLS)
    if (counts["render_fused_profile"] != 1 or counts["render_fused"] != 1
            or counts["render_plain"]):
        raise AssertionError(f"schedule path: counts {counts}")
    frames = {k: cm.render_tiles_fused(scene, cam, cfg, 0, g[0], g[1])[g[2]]
              for k, g in grids.items() if k != "scheduled"}
    if not all(torch.equal(sched, f) for f in frames.values()):
        raise AssertionError("2K scheduled frame differs from the tiled or blocked frame")

    # The main path's profile, checked: build_schedule's render again (2K
    # tiled grid, spp 2; the kernel is deterministic), its rgb against K3
    # on every lane, the order its cost gives against build_schedule's,
    # and its cost, aux and lane counts against the plain version's on
    # seeded whole packets, exactly as at the preflight size.
    tpx, tpy, _ = grids["tiled"]
    m_rgb, m_cost, m_aux, m_k1, m_it = cm.render_tiles_fused(
        scene, cam, cfg, 0, tpx, tpy, spp=2, profile=True, lane_counts=True)
    m_k3 = cm.render_tiles_fused(scene, cam, cfg, 0, tpx, tpy, spp=2)
    again = order_by_cost(tpx, tpy, m_cost, cfg)
    pk = np.sort(np.random.default_rng(12).choice(tpx.shape[0] // cm.PACKET, P12_PACKETS,
                                                  replace=False))
    lanes = torch.from_numpy((pk[:, None] * cm.PACKET + np.arange(cm.PACKET)).reshape(-1)).to(dev)
    t0 = time.perf_counter()
    (p_rgb, p_cost2, p_aux2, p_k1, p_it), ro, rd, rt = recorded_rays(
        lambda: cm.render_tiles_fused_plain(scene, cam, cfg, 0, tpx[lanes], tpy[lanes], spp=2,
                                            profile=True, lane_counts=True))
    torch.cuda.synchronize()
    main_plain_s = time.perf_counter() - t0
    mts12, traced12 = brute_mts(scene.bvh4, ro, rd, rt, cfg.t_min)
    mts_per_traced = mts12 / max(traced12, 1)
    bad_m, mean_diff_m, max_err_m = image_agreement(m_rgb[lanes][None], p_rgb[None])
    main_checks = {
        "rgb == K3 on every lane": torch.equal(m_rgb, m_k3),
        "order from this cost == build_schedule's": all(
            torch.equal(a, b) for a, b in zip(again, grids["scheduled"])),
        "cost == plain": torch.equal(m_cost[lanes], p_cost2),
        "aux == plain": torch.equal(m_aux[lanes], p_aux2),
        "lane K1 steps == plain": torch.equal(m_k1[lanes], p_k1),
        "lane path iterations == plain": torch.equal(m_it[lanes], p_it),
        "rgb vs plain within the image tolerance": (bad_m <= IMG_BAD_FRAC
                                                    and mean_diff_m <= MEAN_TOL),
    }
    if not all(main_checks.values()):
        raise AssertionError(f"K3-profile on the main path ({P12_PACKETS} packets): {main_checks}")

    # Overhead of the instrumentation at 2K (tiled grid) and the lanes'
    # K1 steps on each layout: divergence = mean over warps of
    # (warp max / warp mean) of the lane K1 totals.
    times = _frames_in_turns(
        {"K3": lambda: cm.render_tiles_fused(scene, cam, cfg, 0, tpx, tpy),
         "K3-profile": lambda: cm.render_tiles_fused(scene, cam, cfg, 0, tpx, tpy, profile=True)},
        10)
    over = {k: float(np.median(v[0])) for k, v in times.items()}
    stats = {}
    for name, (gx, gy, _) in grids.items():
        _, c, a, k1, it = cm.render_tiles_fused(scene, cam, cfg, 0, gx, gy, profile=True,
                                                lane_counts=True)
        if name == "tiled":   # the same paths on every layout
            bounds["2k"] = path_bound(scene.bvh4, gx.shape[0], cfg.spp, int(k1.sum()),
                                      int(it.sum()))
            bounds["2k_cull"] = path_bound_cull(scene.bvh4, gx.shape[0], cfg.spp, int(k1.sum()),
                                                int(it.sum()), mts_per_traced)
        w = k1.reshape(-1, 32).float()
        wi = it.reshape(-1, 32).float()
        stats[name] = dict(cost_mean=c.mean().item(), cost_max=c.max().item(),
                           k1_mean=w.mean().item(),
                           divergence=(w.amax(dim=1) / w.mean(dim=1).clamp_min(1e-9)).mean().item(),
                           iter_mean=wi.mean().item(),
                           iter_divergence=(wi.amax(dim=1)
                                            / wi.mean(dim=1).clamp_min(1e-9)).mean().item(),
                           lockstep_sum=float(a.reshape(-1, 8, 128)[:, 0, 0].sum().item()))
    layouts = {name: (lambda g=g: cm.render_tiles_fused(scene, cam, cfg, 0, g[0], g[1]))
               for name, g in grids.items()}
    lt = _frames_in_turns(layouts, 10)
    lay = {k: float(np.median(v[0])) for k, v in lt.items()}
    lay_dev = {k: float(np.median(v[1])) for k, v in lt.items()}
    row = dict(launches=counts["render_fused_profile"], max_abs_err=0.0, ms=ms,
               plain_ms=plain_ms, ms_k3_same_lanes=ms_k3,
               profile_2k_median_s=over["K3-profile"], k3_2k_median_s=over["K3"],
               build_schedule_s=schedule_s, layout_median_s=lay, layout_median_device_s=lay_dev,
               lane_stats=stats, main_packets_checked=P12_PACKETS,
               **bounds["preflight"], bound_2k_ms=bounds["2k"]["bound_ms"],
               bound_2k_by=bounds["2k"]["bound_by"],
               bound_cull_2k_ms=bounds["2k_cull"]["bound_ms"],
               bound_cull_2k_by=bounds["2k_cull"]["bound_by"],
               brute_mts_per_traced_ray=mts_per_traced, main_max_abs_err_vs_plain=max_err_m,
               max_abs_err_is="rgb vs K3 at the preflight size and on the 2K spp2 profile; cost, "
                              "aux and lane counts equal plain there and on "
                              f"{P12_PACKETS} 2K packets")
    msg = (f"K3-profile at the preflight size: {checks} (cost and aux exact); {ms:.3f} ms vs "
           f"K3 {ms_k3:.3f} ms vs plain {plain_ms:.1f} ms (one call); main path (2K tiled grid, "
           f"spp 2): {main_checks} on {P12_PACKETS} seeded packets {pk.tolist()} (cost, aux, "
           f"counts exact; rgb vs plain {bad_m:.4%} beyond tolerance, max abs {max_err_m:.3g}, "
           f"bitwise {torch.equal(m_rgb[lanes], p_rgb)}; plain took {main_plain_s:.2f} s); "
           f"2K spp8 mb20 tiled grid in turns, "
           f"median of 10: K3 {over['K3']:.4f} s, K3-profile {over['K3-profile']:.4f} s "
           f"(overhead {over['K3-profile'] / over['K3'] - 1:+.4f}); K3-profile host s "
           f"{_fmt(times['K3-profile'][0])}; lane statistics (cost mean/max, K1 mean, "
           f"K1 divergence, path-iteration mean, path-iteration divergence, lockstep sum; a "
           f"divergence is the mean over warps of the warp max / warp mean): "
           + "; ".join(f"{k} {v['cost_mean']:.2f}/{v['cost_max']:.0f}, {v['k1_mean']:.2f}, "
                       f"{v['divergence']:.4f}, {v['iter_mean']:.2f}, {v['iter_divergence']:.4f}, "
                       f"{v['lockstep_sum']:.0f}" for k, v in stats.items())
           + f"; the {traced12} traced rays of the {P12_PACKETS} packets' plain render run "
           f"{mts_per_traced:.4f} brute MT records each after the cull"
           + f"; build_schedule(profile_spp=2) {schedule_s:.3f} s, path counts {counts}; the "
           f"scheduled frame == tiled == blocked bitwise; frames in turns, median of 10: "
           + ", ".join(f"{k} {v:.4f} s (events {lay_dev[k]:.4f})" for k, v in lay.items())
           + "; bounds (K3, K5, K3-profile): "
           + ", ".join(f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']}: {v['bound_bytes']} B, "
                       f"{v['bound_ops']} fp32 ops)" for k, v in bounds.items())
           + f" on {smi}")
    return dict(row=row, msg=msg, bounds=bounds)


def _bitwise(a, b) -> bool:
    """Equal bit for bit, a NaN equal to any NaN (the card's NaN and the
    CPU's differ in sign bit)."""
    import torch

    both_nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | both_nan).all())


def _max_abs(a, b) -> float:
    fin = a.isfinite() & b.isfinite()
    return float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0


def _int32_ops_per_s():
    """Int32 peak: the Hopper SM's 64 INT32 units at the card's maximum SM
    clock (nvidia-smi clocks.max.sm), on every SM; (rate, MHz)."""
    import torch

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=60).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * \
        INT32_UNITS_PER_SM * mhz * 1e6, mhz


def roofline_mixed(nbytes: int, fp32_ops: int, int32_ops: int, int32_rate: float,
                   fp32_rate: float | None = None) -> dict:
    """roofline() for work of both types: the larger of the bytes' time,
    the fp32 operations' and the int32 operations' (separate pipes)."""
    r = roofline(nbytes, fp32_ops, fp32_rate)
    t_int = int32_ops / int32_rate * 1e3
    if t_int > r["bound_ms"]:
        r.update(bound_ms=t_int, bound_by="operations")
    return dict(r, bound_ops=int(fp32_ops), bound_int32_ops=int(int32_ops))


BOUND_KEYS = ("bound_ms", "issue_bound_ms", "dep_bound_ms", "bound_sms_ms", "rank_bound_ms")


def over_bounds(tree, path: str = "") -> list:
    """Every reading over 100% in phase 13's results: a dict's time ("ms",
    and "graph_ms" where timed in a graph; the P-scalar pre-pass's
    "tables_ms" and "tables_graph_ms") under one of its bounds, as
    "<where>: <time> ms under <bound> <value> ms"."""
    out = []
    if isinstance(tree, dict):
        for t_key, b_keys in (("ms", BOUND_KEYS), ("graph_ms", BOUND_KEYS),
                              ("tables_ms", ("tables_bound_ms", "tables_dep_bound_ms")),
                              ("tables_graph_ms", ("tables_bound_ms", "tables_dep_bound_ms"))):
            t = tree.get(t_key)
            if not isinstance(t, float):
                continue
            for b in b_keys:
                v = tree.get(b)
                if isinstance(v, float) and v > t:
                    out.append(f"{path}: {t_key} {t:.6f} ms under {b} {v:.6f} ms")
        for k, v in tree.items():
            out += over_bounds(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += over_bounds(v, f"{path}[{i}]")
    return out


def graph_ms(fn, launches: int = P13_GRAPH_LAUNCHES, replays: int = 5) -> float:
    """Device milliseconds per launch of fn: `launches` calls captured once
    in a CUDA graph (after a warm-up on a side stream), the graph replayed
    between one event pair; the median of `replays` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / launches)
    return float(np.median(ms))


def alternate(measures: dict, pairs: int = P13_TURN_PAIRS) -> dict:
    """Measurements (name -> a function returning ms) taken in `pairs`
    alternating pairs of rounds, each name once a round, forward then
    backward (a b b a a b ...; a b c c b a ...): {name: [ms per round]}."""
    names, out = list(measures), {k: [] for k in measures}
    for r in range(2 * pairs):
        for name in (names if r % 2 == 0 else names[::-1]):
            out[name].append(measures[name]())
    return out


def bitcast_library(case: str, tab, r0: int) -> tuple:
    """(the library call, the library call on views made beforehand) of a
    P-bitcast case on its table, each returning a tuple of i32[8, 128];
    (None, None) where one PyTorch call does not compute it. p3: nodes 0-7
    are records 0-3 of rows 0 and 1, their child codes fields 24-27, padded
    to the tile by torch.nn.functional.pad; p4: record k's ids (fields 9
    and 10 of row r0) repeated to lanes c with c % 8 = k, one [2, 8, 128]
    repeat unbound into (best, mat). p1 needs a copy before its pad (the
    reshape of a strided [8, 2]) and p2 a bucketize and a lookup: no single
    call."""
    import torch

    pad, i32 = torch.nn.functional.pad, torch.int32
    if case == "p3":
        codes = tab[0:2].view(8, 32)[:, 24:28].view(i32)
        return ((lambda: (pad(tab[0:2].view(8, 32)[:, 24:28].view(i32), (0, 124)),)),
                (lambda: (pad(codes, (0, 124)),)))
    if case == "p4":
        ids = tab[r0].view(8, 16)[:, 9:11].view(i32).t().unsqueeze(1)
        return ((lambda: tab[r0].view(8, 16)[:, 9:11].view(i32).t().unsqueeze(1)
                 .repeat(1, 8, 16).unbind(0)),
                (lambda: ids.repeat(1, 8, 16).unbind(0)))
    return None, None


def tile_calls(dev) -> dict:
    """{"<probe> <case>": (the kernel's call, its library call, the library
    call on views made beforehand)} of every P-mosaic case, P-bitcast case
    (on the reference scene's v5 tables), P-feature stage and P-ktf case on
    its script's inputs on the card, each call returning a tuple;
    None where one PyTorch call does not compute the case. A library call
    is one PyTorch call computing the case from its input x, the views it
    needs taken inside the call (as the probe rows have timed it): mosaic colbcast
    torch.mul(x, x[:, 3:4]), concat torch.mul(x[0:1] expanded, x[0, 5]),
    bitcast .contiguous() of the int32 view of lane 25 expanded; bitcast p3
    and p4 as bitcast_library gives them (p1 and p2 none); feature
    s2 x * 2.0 (no view: no second form)."""
    import torch

    from raytracer_tpu_torch.probes import bitcast, feature, ktf_probe, mosaic

    tile, i32 = mosaic.TILE, torch.int32
    calls = {}
    for case in mosaic.CASES:
        ins = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in mosaic.inputs(case))
        x = ins[0]
        lib = once = None
        if case == "colbcast":
            col = x[:, 3:4]
            lib = lambda x=x: (torch.mul(x, x[:, 3:4]),)   # noqa: E731
            once = lambda x=x, col=col: (torch.mul(x, col),)   # noqa: E731
        elif case == "concat":
            row, c5 = x[0:1].expand(tile), x[0, 5]
            lib = lambda x=x: (torch.mul(x[0:1].expand(tile), x[0, 5]),)   # noqa: E731
            once = lambda row=row, c5=c5: (torch.mul(row, c5),)   # noqa: E731
        elif case == "bitcast":
            ids = x.view(i32)[:, 25:26].expand(tile)
            lib = lambda x=x: (x.view(i32)[:, 25:26].expand(tile).contiguous(),)   # noqa: E731
            once = lambda ids=ids: (ids.contiguous(),)   # noqa: E731
        calls[f"mosaic {case}"] = (lambda c=case, i=ins: (mosaic.probe_mosaic(c, *i),), lib, once)
    tabs = bitcast.reference_tables()
    for case in bitcast.CASES:
        tab, r0 = bitcast.case_input(case, tabs, dev)
        calls[f"bitcast {case}"] = (lambda c=case, t=tab, r=r0: bitcast.probe_bitcast(c, t, r),
                                    *bitcast_library(case, tab, r0))
    for case in feature.CASES:
        ins = tuple(torch.from_numpy(a).to(dev) for a in feature.inputs(case))
        calls[f"feature {case}"] = (lambda c=case, i=ins: feature.probe_feature(c, *i),
                                    (lambda x=ins[0]: (x * 2.0,)) if case == "s2" else None, None)
    for case in ktf_probe.CASES:   # no PyTorch call computes Threefry, u01 or the unit vectors
        ins = tuple(torch.from_numpy(a).to(dev) for a in ktf_probe.inputs(case))
        calls[f"ktf {case}"] = (lambda c=case, i=ins: ktf_probe.probe_ktf(c, *i), None, None)
    return calls


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds per call of fn: the host clock over `calls` calls
    after a warm-up, synchronized at the end (a launch's host work, as long
    as the card keeps up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def tile_host_parts(dev) -> dict:
    """Where the host time of a call of the redesigned wrappers goes (host_us
    of each part alone, mosaic colbcast, feature s2, ktf sampler_tile and
    bitcast p4 on their script's inputs): the wrapper, its library call, the
    bare ctypes launch on buffers made once, each step of the wrapper's own
    work (bitcast p4's two outputs both ways: two new_empty, or one
    [2, 8, 128] new_empty unbound into views), and the stream handle as
    torch.cuda.current_stream() gives it."""
    import torch

    from raytracer_tpu_torch.probes import bitcast, feature, ktf_probe, mosaic
    from raytracer_tpu_torch.utils import cudalib

    x = torch.from_numpy(mosaic.inputs("colbcast")[0]).to(dev)
    x2 = torch.from_numpy(feature.inputs("s2")[0]).to(dev)
    col, out, out2 = x[:, 3:4], torch.empty_like(x), torch.empty_like(x2)
    L, stream = cudalib.lib(), cudalib.stream_handle()
    xp, op, x2p, o2p = x.data_ptr(), out.data_ptr(), x2.data_ptr(), out2.data_ptr()
    parts = {
        "mosaic colbcast wrapper": lambda: mosaic.probe_mosaic("colbcast", x),
        "torch.mul(x, x[:, 3:4])": lambda: torch.mul(x, x[:, 3:4]),
        "torch.mul(x, x[:, 3:4]) on the view made once": lambda: torch.mul(x, col),
        "mosaic colbcast ctypes launch alone": lambda: L.rt_probe_mosaic(0, xp, None, 1, op,
                                                                         stream),
        "feature s2 wrapper": lambda: feature.probe_feature("s2", x2),
        "x * 2.0": lambda: x2 * 2.0,
        "feature s2 ctypes launch alone": lambda: L.rt_probe_feature(1, x2p, None, 4, o2p,
                                                                     stream),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "cudalib.stream_handle()": cudalib.stream_handle,
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "cudalib.signature(x) == the fast path's": lambda: cudalib.signature(x) == mosaic._X,
    }
    px = torch.from_numpy(ktf_probe.inputs("sampler_tile")[0]).to(dev)
    kout = torch.empty((4, *ktf_probe.TILE), device=dev)
    kp, kop, (k0, k1) = px.data_ptr(), kout.data_ptr(), ktf_probe._KEYS["sampler_tile"]
    sid = ktf_probe.CASES.index("sampler_tile")
    parts.update({
        "ktf sampler_tile wrapper": lambda: ktf_probe.probe_ktf("sampler_tile", px),
        "ktf sampler_tile ctypes launch alone": lambda: L.rt_probe_ktf(sid, kp, None, k0, k1, kop,
                                                                       stream),
        "ktf x.new_empty((4, 8, 128))": lambda: px.new_empty((4, *ktf_probe.TILE),
                                                             dtype=torch.float32),
        "ktf out.unbind(0)": lambda: kout.unbind(0),
    })
    tab, r0 = bitcast.case_input("p4", bitcast.reference_tables(), dev)
    library, _ = bitcast_library("p4", tab, r0)
    b0, b1 = (torch.empty(bitcast.TILE, dtype=torch.int32, device=dev) for _ in range(2))
    tp, b0p, b1p = tab.data_ptr(), b0.data_ptr(), b1.data_ptr()
    parts.update({
        "bitcast p4 wrapper": lambda: bitcast.probe_bitcast("p4", tab, r0),
        "bitcast p4 library call": library,
        "bitcast p4 ctypes launch alone": lambda: L.rt_probe_bitcast(bitcast.P4, tp, r0, b0p, b1p,
                                                                     stream),
        "bitcast p4 two tab.new_empty((8, 128))": lambda: (
            tab.new_empty(bitcast.TILE, dtype=torch.int32),
            tab.new_empty(bitcast.TILE, dtype=torch.int32)),
        "bitcast p4 tab.new_empty((2, 8, 128)).unbind(0)": lambda: tab.new_empty(
            (2, *bitcast.TILE), dtype=torch.int32).unbind(0),
    })
    return {k: host_us(f) for k, f in parts.items()}


def tile_times(dev, floor_fn) -> dict:
    """The redesigned single-tile probes against their library calls: each
    case's kernel and library call equal bit for bit, timed per call in
    alternating pairs (time_launches' event pairs) and per launch in a CUDA
    graph (graph_ms); every other case's graph time; the launch floor
    (floor_fn, P-floor's empty kernel) timed both ways. Returns {"cases":
    {name: fields}, "floor": fields, "lines": [...]}."""
    from raytracer_tpu_torch.probes import common

    per_call = lambda f: lambda: common.median(common.time_launches(f))   # noqa: E731
    floor_turns = [per_call(floor_fn)() for _ in range(2 * P13_TURN_PAIRS)]
    floor = dict(ms=float(np.median(floor_turns)), turns_ms=floor_turns,
                 graph_ms=graph_ms(floor_fn))
    cases, lines = {}, []
    for name, (kernel, library, once) in tile_calls(dev).items():
        r = dict(graph_ms=graph_ms(kernel))
        if library is not None:
            got = kernel()
            for lib in (library, once) if once else (library,):
                if not all(_bitwise(a, b) if a.is_floating_point() else bool((a == b).all())
                           for a, b in zip(got, lib())):
                    raise AssertionError(f"{name}: the kernel != its library call")
            fns = {"kernel": kernel, "library": library, **({"views once": once} if once else {})}
            t = alternate({k: per_call(f) for k, f in fns.items()})
            r.update(ms_turns=float(np.median(t["kernel"])), turns_ms=t["kernel"],
                     library_ms=float(np.median(t["library"])), library_turns_ms=t["library"],
                     library_graph_ms=graph_ms(library))
            if once:
                r.update(library_views_once_ms=float(np.median(t["views once"])),
                         library_views_once_turns_ms=t["views once"])
            lines.append(
                f"{name}: per call, in {P13_TURN_PAIRS} alternating pairs of rounds (median of 10 "
                f"each): kernel {r['ms_turns']:.5f} ms [{_fmt(t['kernel'])}], library call "
                f"{r['library_ms']:.5f} ms [{_fmt(t['library'])}] (kernel / library "
                f"{r['ms_turns'] / r['library_ms']:.3f})"
                + (f", the library call on views made once {r['library_views_once_ms']:.5f} ms "
                   f"[{_fmt(t['views once'])}] (kernel / it "
                   f"{r['ms_turns'] / r['library_views_once_ms']:.3f})" if once else "")
                + f"; device time per launch, CUDA graph of {P13_GRAPH_LAUNCHES}: kernel "
                f"{r['graph_ms']:.5f} ms, library {r['library_graph_ms']:.5f} ms; host share of "
                f"the kernel's call {1 - r['graph_ms'] / r['ms_turns']:.3f}")
        cases[name] = r
    lines.append(
        f"launch floor (P-floor's empty kernel through v5_body.v5): per call "
        f"{floor['ms']:.5f} ms [{_fmt(floor_turns)}], device {floor['graph_ms']:.5f} ms per "
        f"launch; the redesigned "
        f"cases' device times (CUDA graph of {P13_GRAPH_LAUNCHES}): " + ", ".join(
            f"{k} {v['graph_ms']:.5f} ({v['graph_ms'] / floor['graph_ms']:.2f}x the floor)"
            for k, v in cases.items()))
    for key, what in (("library_ms", "the library call"),
                      ("library_views_once_ms", "the library call on views made once")):
        slower = [k for k, v in cases.items() if key in v and v["ms_turns"] > v[key]]
        lines.append(f"per call no slower than {what}: "
                     + ("every case" if not slower else f"all but {', '.join(slower)}"))
    host = tile_host_parts(dev)
    lines.append("host us per call (host clock over 2,000 calls): "
                 + "; ".join(f"{k} {v:.2f}" for k, v in host.items()))
    return dict(cases=cases, floor=floor, host_us=host, lines=lines)


SCHEDULERS_PER_SM = 4      # warp schedulers of a Hopper SM: 4 instructions issued per clock


def sm_clock_under_load(fn, seconds: float = 1.5) -> dict:
    """The card's SM clock (nvidia-smi clocks.sm, MHz) read every ~0.1 s
    while launches of fn keep it busy for `seconds`: the median and the
    readings."""
    import threading

    import torch

    readings, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            got = subprocess.run(["nvidia-smi", f"--id={torch.cuda.current_device()}",
                                  "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=60).stdout.split()
            if got and got[0].replace(".", "", 1).isdigit():
                readings.append(float(got[0]))
            time.sleep(0.1)

    fn()
    torch.cuda.synchronize()
    poller = threading.Thread(target=poll, daemon=True)
    t0 = time.perf_counter()
    poller.start()
    while time.perf_counter() - t0 < seconds or not readings:
        for _ in range(8):
            fn()
        torch.cuda.synchronize()
    stop.set()
    poller.join()
    return dict(mhz=float(np.median(readings)), readings=readings)


def issue_bound_ms(insns: int, warps: int, iters: int, n_sm: int, mhz: float) -> float:
    """The least time for the instructions a probe issues: `insns` a warp
    issues per iteration x warps x iterations over the SMs' schedulers, one
    instruction each per clock."""
    return insns * warps * iters / (SCHEDULERS_PER_SM * n_sm * mhz * 1e6) * 1e3


# Outermost loops in the SASS of P-v8's, the v5 body's and P-interleave's
# kernels (sass.loops, sm_90a): one, the loop over iterations (every other
# loop in their sources has a fixed trip and is unrolled), except in the
# v5 modes whose iteration is a few instructions, where nvcc unrolls the
# iteration loop itself and leaves copies of it beside the main one.
UNROLLED_LOOPS = {"v5 smem8": 2, "v5 minimal": 2, "v5 empty": 3, "v5 carry8": 3}


def iter_insns(counts: dict, kernel: str):
    """The fewest SASS instructions a warp issues per iteration of the loop
    over iterations of `kernel` ("v8 <variant>", "v5 <mode>" or
    "interleave"): the shortest path through it (sass.loop_min; the
    kernel's whole static count read over 100% for the v5 body's small
    modes: set-up, code outside the loop, branches not taken). None where
    nvcc unrolled the loop (UNROLLED_LOOPS): a trip then holds an unknown
    number of iterations. Raises if the kernel has another number of
    outermost loops than expected, so that no other loop's trip is taken
    for an iteration."""
    want = UNROLLED_LOOPS.get(kernel, 1)
    if len(counts["loop_min"]) != want:
        raise AssertionError(f"{kernel}: {len(counts['loop_min'])} outermost loops in its SASS "
                             f"({counts['loops']}), expected {want}")
    return counts["loop_min"][0] if want == 1 else None


def chain_widths(dev, v8_in: dict, v5_in: dict, out) -> dict:
    """P-v8 and the v5 body at every chain width their kernels admit: ms
    (median of time_launches), registers and local bytes, at the scripts'
    packets and at P13_FILL_PACKETS, beside the W the entry point picks.
    {"v8 <variant> P<packets>" / "v5 <mode> P<packets>": {"picked": W,
    W: {...}}}."""
    from raytracer_tpu_torch.probes import ablate_v8, common, v5_body

    res8 = {w: ablate_v8.kernel_resources(w) for w in ablate_v8.ADMITTED_W}
    res5 = {m: {w: v5_body.kernel_resources((m,), w)[m] for w in v5_body.ADMITTED_W[m]}
            for m in v5_body.MODES}
    table = {}
    for packets, ins in v8_in.items():
        for v in ablate_v8.VARIANTS:
            row = {"picked": ablate_v8.chosen_w(packets, v)}
            for w in ablate_v8.ADMITTED_W:
                ms = common.median(common.time_launches(
                    lambda: ablate_v8.ablate_v8(*ins, v, ablate_v8.ITERS, w=w)))
                row[w] = dict(ms=ms, num_regs=res8[w][v][0], local_bytes=res8[w][v][1])
            table[f"v8 {v} P{packets}"] = row
    for packets, (args, zero_row) in v5_in.items():
        for m in v5_body.MODES:
            row = {"picked": v5_body.chosen_w(packets, m)}
            for w in v5_body.ADMITTED_W[m]:
                ms = common.median(common.time_launches(
                    lambda: v5_body.v5(*args, zero_row, m, v5_body.ITERS, w=w)))
                row[w] = dict(ms=ms, num_regs=res5[m][w][0], local_bytes=res5[m][w][1])
            table[f"v5 {m} P{packets}"] = row
    for name, row in table.items():
        out(f"{name}: " + ", ".join(
            f"W{w} {r['ms']:.4f} ms ({r['num_regs']} regs / {r['local_bytes']} B)"
            for w, r in row.items() if w != "picked") + f"; the entry point picks W{row['picked']}")
    return table


def phase13(dev, smi):
    """The traversal-iteration probes: each probe's entry point with the
    launch counts from 0 (the timings), then every variant against its
    plain version, and the bounds."""
    import torch

    from raytracer_tpu_torch.ops.bvh4 import BIG
    from raytracer_tpu_torch.ops.cuda_traverse import trace_closest_plain
    from raytracer_tpu_torch.ops import cuda_traverse
    from raytracer_tpu_torch.probes import (ablate, ablate_v8, base_probe, bitcast, common,
                                            feature, floor_probe, interleave_probe, ktf_probe,
                                            load_probe, morph, mosaic, sass, scalar_cost, v5_body,
                                            v6, vstack)

    t_phase = time.perf_counter()
    res_v8, res_v5 = ablate_v8.kernel_resources(), v5_body.kernel_resources()
    t0 = time.perf_counter()
    node5, tri5, zero_row = v5_body.reference_tables()
    o5, d5, tl5 = (torch.from_numpy(a) for a in v5_body.make_rays(v5_body.N_PACKETS))
    v6_128 = v6.reference_inputs(v6.N_PACKETS)
    v6_in = {v6.N_PACKETS: v6_128,
             P13_FILL_PACKETS: (*v6_128[:5], *(torch.from_numpy(a) for a in v5_body.make_rays(
                 P13_FILL_PACKETS, seed=0)))}
    morph_in = {p: morph.reference_inputs(p) for p in (morph.N_PACKETS, P13_FILL_PACKETS)}
    bc_tabs = bitcast.reference_tables()
    setup_s = time.perf_counter() - t0
    counters = (ablate_v8, v5_body, interleave_probe, scalar_cost, vstack, ktf_probe, v6, morph,
                mosaic, bitcast, feature)

    def out(line):
        log(13, "  " + line)

    # ---- the path: each entry point as its script's main() runs it
    for mod in counters:
        for d in (mod.LAUNCHES, mod.PLAIN_CALLS):
            for k in d:
                d[k] = 0
    runs, launches = {}, {}
    log(13, f"ablate_v8.run({ablate_v8.ITERS}, {ablate_v8.N_PACKETS}) (the script's sizes):")
    runs["P-v8"] = ablate_v8.run(ablate_v8.ITERS, ablate_v8.N_PACKETS, out=out)
    log(13, f"ablate_v8.run({ablate_v8.ITERS}, {P13_FILL_PACKETS}) (8 blocks per SM):")
    runs["P-v8 fill"] = ablate_v8.run(ablate_v8.ITERS, P13_FILL_PACKETS, out=out)
    launches["P-v8"] = ablate_v8.LAUNCHES["probe_v8"]
    v5_probes = {"P-ablate": ("ablate", ablate.VARIANTS),
                 "P-load": ("load_probe", load_probe.MODES),
                 "P-floor": ("floor_probe", floor_probe.MODES),
                 "P-base": ("base_probe", base_probe.MODES)}
    for key, (script, modes) in v5_probes.items():
        before = v5_body.LAUNCHES["probe_v5"]
        log(13, f"{script} ({v5_body.ITERS} iterations, {v5_body.N_PACKETS} packets, the "
                f"reference scene's 4-wide tree):")
        runs[key] = v5_body.run(script, modes, inputs=(node5, tri5, o5, d5, tl5, zero_row),
                                out=out)
        launches[key] = v5_body.LAUNCHES["probe_v5"] - before
    for packets in (interleave_probe.N_PACKETS, P13_FILL_PACKETS):
        log(13, f"interleave_probe.run({interleave_probe.ITERS}, {packets}) (the v5 full body, G "
                f"packets per block):")
        runs[f"P-interleave {packets}"] = interleave_probe.run(
            interleave_probe.ITERS, packets, tables=(node5, tri5, zero_row), out=out)
    launches["P-interleave"] = interleave_probe.LAUNCHES["probe_interleave"]
    log(13, f"scalar_cost.run({scalar_cost.ITERS}, {scalar_cost.N_PACKETS}) (the script's sizes):")
    runs["P-scalar"] = scalar_cost.run(out=out)
    launches["P-scalar"] = scalar_cost.LAUNCHES["probe_scalar"]
    launches["P-scalar tables"] = scalar_cost.LAUNCHES["probe_scalar_tables"]
    log(13, "vstack p1, p2, p3 (in this process; each chain a block of one warp):")
    runs["P-vstack"] = {**vstack.p1(out=out), **vstack.p2(out=out), **vstack.p3(out=out)}
    if not vstack.ok(runs["P-vstack"]):
        raise AssertionError(f"vstack: a case disagrees with the push/pop model: "
                             f"{runs['P-vstack']}")
    launches["P-vstack"] = vstack.LAUNCHES["probe_vstack"]
    log(13, "ktf_probe cases (in this process; one [8, 128] tile each, against the script's "
            "host expectation):")
    runs["P-ktf"] = {case: ktf_probe.run_case(case, dev, out=out) for case in ktf_probe.CASES}
    if not all(r["ok"] for r in runs["P-ktf"].values()):
        raise AssertionError(f"ktf probe: a case fails its check: {runs['P-ktf']}")
    launches["P-ktf"] = ktf_probe.LAUNCHES["probe_ktf"]
    for packets in v6_in:
        log(13, f"v6.run({packets}) (the reference scene's 4-wide tree; v6 at the W it picks "
                f"against K4 on it, in turns):")
        runs[f"P-v6 {packets}"] = v6.run(packets, dev, inputs=v6_in[packets], out=out)
    launches["P-v6"] = v6.LAUNCHES["probe_v6"]
    for packets in morph_in:
        log(13, f"morph.run({packets}) (every variant in this process; the reference scene's "
                f"4-wide tree, stack bound {morph_in[packets][3]}):")
        runs[f"P-morph {packets}"] = morph.run(packets, dev, inputs=morph_in[packets], out=out)
    launches["P-morph"] = morph.LAUNCHES["probe_morph"]
    log(13, "mosaic cases (in this process; one [8, 128] tile each, against the script's NumPy "
            "expectation):")
    runs["P-mosaic"] = {case: mosaic.run_case(case, dev, out=out) for case in mosaic.CASES}
    if not all(r["ok"] for r in runs["P-mosaic"].values()):
        raise AssertionError(f"mosaic probe: a case fails the script's check: {runs['P-mosaic']}")
    launches["P-mosaic"] = mosaic.LAUNCHES["probe_mosaic"]
    log(13, "bitcast p1-p4 (in this process; the reference scene's v5 tables; p1, p3 and p4 "
            "bitcast float-encoded ids and say BAD, as the script does):")
    runs["P-bitcast"] = {case: bitcast.run_case(case, dev, bc_tabs, out=out)
                         for case in bitcast.CASES}
    launches["P-bitcast"] = bitcast.LAUNCHES["probe_bitcast"]
    log(13, "feature s1-s7 (in this process; s7 is K4 on the box-only scene):")
    k4_before = cuda_traverse.LAUNCHES["trace_closest"]
    runs["P-feature"] = {case: feature.run_case(case, dev, out=out) for case in feature.STAGES}
    if not all(r["ok"] for r in runs["P-feature"].values()):
        raise AssertionError(f"feature probe: a stage fails the script's check: "
                             f"{runs['P-feature']}")
    launches["P-feature"] = feature.LAUNCHES["probe_feature"]
    launches["P-feature s7 (K4)"] = cuda_traverse.LAUNCHES["trace_closest"] - k4_before
    plain_calls = sum(n for mod in counters for n in mod.PLAIN_CALLS.values())
    want = {"P-v8": 2 * 11 * len(ablate_v8.VARIANTS),
            **{k: 11 * len(m) for k, (_, m) in v5_probes.items()},
            "P-interleave": 2 * 11 * len(interleave_probe.GS),
            "P-scalar": 11 * len(scalar_cost.VARIANTS), "P-scalar tables": 11,
            "P-vstack": 11 * len(vstack.CASES), "P-ktf": 11 * len(ktf_probe.CASES),
            "P-v6": 2 * 12, "P-morph": 2 * 11 * len(morph.VARIANTS),
            "P-mosaic": 11 * len(mosaic.CASES), "P-bitcast": 11 * len(bitcast.CASES),
            "P-feature": 11 * len(feature.CASES), "P-feature s7 (K4)": 1}
    if launches != want or plain_calls:
        raise AssertionError(f"probe paths: launches {launches} (expected {want}), plain calls "
                             f"{plain_calls}")

    # ---- P-v8 and the v5 body at every chain width (not the path: its
    # counts are read above)
    v8_in = {p: tuple(torch.from_numpy(a).to(dev) for a in ablate_v8.make_inputs(p))
             for p in (ablate_v8.N_PACKETS, P13_FILL_PACKETS)}
    v5_in = tuple(t.to(dev) for t in (node5, tri5, o5, d5, tl5))
    v5_fill = v5_in[:2] + tuple(torch.from_numpy(a).to(dev)
                                for a in v5_body.make_rays(P13_FILL_PACKETS))
    v5_sizes = {v5_body.N_PACKETS: (v5_in, zero_row), P13_FILL_PACKETS: (v5_fill, zero_row)}
    log(13, f"P-v8 ({ablate_v8.ITERS} iterations) and the v5 body ({v5_body.ITERS}) at every "
            f"chain width W, at the scripts' packets and at {P13_FILL_PACKETS} (median of "
            f"{common.TIMED_LAUNCHES} launches):")
    widths = chain_widths(dev, v8_in, v5_sizes, out)
    clock = sm_clock_under_load(lambda: ablate_v8.ablate_v8(*v8_in[P13_FILL_PACKETS], "full",
                                                            ablate_v8.ITERS))
    log(13, f"SM clock under P-v8 full at {P13_FILL_PACKETS} packets (nvidia-smi clocks.sm): "
            f"median {clock['mhz']:.0f} MHz of {len(clock['readings'])} readings "
            f"{clock['readings']}")

    # ---- every variant against its plain version, bit for bit
    checked, max_err, plain_ms, last_plain = [], {}, {}, {}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def same(key, name, k, p):
        """k ≡ p bit for bit (tuples element by element); max_err[key] takes
        their largest |difference|."""
        ks, ps = (k, p) if isinstance(k, tuple) else ((k,), (p,))
        for a, b in zip(ks, ps):
            if a is None and b is None:
                continue
            if (a is None or b is None or a.dtype != b.dtype or a.shape != b.shape
                    or not _bitwise(a, b)):
                raise AssertionError(f"{name}: kernel != plain")
            err = _max_abs(a, b) if a.is_floating_point() else float((a - b).abs().max())
            max_err[key] = max(max_err.get(key, 0.0), err)
        checked.append(name)

    def held(key, name, kernel_fn, plain_fn, timed=None):
        """kernel_fn() ≡ plain_fn() bit for bit (same); plain_ms[timed] the
        plain call's device ms."""
        k = kernel_fn()
        torch.cuda.synchronize()
        ev0.record()
        p = plain_fn()
        ev1.record()
        torch.cuda.synchronize()
        last_plain[key] = p
        same(key, name, k, p)
        if timed:
            plain_ms[timed] = ev0.elapsed_time(ev1)
        return k

    def also(key, name, kernel_fn):
        """kernel_fn() ≡ the plain result `held` kept last under key."""
        same(key, name, kernel_fn(), last_plain[key])

    # P-v8 at the picked W and at every W: P13_CHECK_ITERS iterations of
    # every variant at both sizes, full also at the script's iterations,
    # and the NaN inputs of the card tests at the script's packets.
    nan_in = [t.clone() for t in v8_in[ablate_v8.N_PACKETS]]
    nan_in[0][::7, 0:48:5] = float("nan")
    nan_in[0][::11, 3] = float("inf")
    nan_in[3][:, 0, :, ::9] = 0.0
    v8_sets = {f"P{p}": ins for p, ins in v8_in.items()}
    v8_sets[f"P{ablate_v8.N_PACKETS} NaN"] = tuple(nan_in)
    for tag, ins in v8_sets.items():
        for v in ablate_v8.VARIANTS:
            sizes = [P13_CHECK_ITERS] + ([ablate_v8.ITERS] if (
                v == "full" and tag == f"P{ablate_v8.N_PACKETS}") else [])
            for iters in sizes:
                held("P-v8", f"v8 {v} {tag} i{iters}",
                     lambda: ablate_v8.ablate_v8(*ins, v, iters),
                     lambda: ablate_v8.ablate_v8_plain(*ins, v, iters),
                     "P-v8" if iters == ablate_v8.ITERS else None)
                for w in ablate_v8.ADMITTED_W:
                    also("P-v8", f"v8 {v} {tag} i{iters} W{w}",
                         lambda: ablate_v8.ablate_v8(*ins, v, iters, w=w))
    # The base modes make their rows from t_best: with tlim = 3e38 every row
    # is 3e38, so they are also held at limits seeded in ±50, where chains
    # take different tasks and noconcat's cross-warp read matters.
    tl_var = torch.from_numpy(np.random.default_rng(5).uniform(
        -50, 50, tuple(tl5.shape)).astype(np.float32)).to(dev)
    body = {}
    for mode in v5_body.MODES:
        body_mode = mode in ("full", "full16", "prod_smem", "prod_carry", "base", "noconcat")
        key = next(kk for kk, (_, m) in v5_probes.items() if mode in m)
        limits = [("", v5_in)] + ([(" tlim±50", v5_in[:4] + (tl_var,))]
                                  if mode in base_probe.MODES else [])
        limits.append((f" P{P13_FILL_PACKETS}", v5_fill))
        for tag, args in limits:
            for iters in [P13_CHECK_ITERS] + ([v5_body.ITERS] if body_mode and "P" not in tag
                                              else []):
                k = held(key, f"v5 {mode}{tag} i{iters}",
                         lambda: v5_body.v5(*args, zero_row, mode, iters),
                         lambda: v5_body.v5_plain(*args, zero_row, mode, iters),
                         mode if (iters == v5_body.ITERS and not tag) else None)
                for w in v5_body.ADMITTED_W[mode]:
                    also(key, f"v5 {mode}{tag} i{iters} W{w}",
                         lambda: v5_body.v5(*args, zero_row, mode, iters, w=w))
                if iters == v5_body.ITERS and not tag:
                    body[mode] = k
    if not all(torch.equal(body["full"], body[m]) for m in ("full16", "prod_smem", "prod_carry")):
        raise AssertionError("v5 body: full, full16, prod_smem and prod_carry differ")
    minimal = v5_body.v5(*v5_in, zero_row, "minimal", v5_body.ITERS)
    if not torch.equal(minimal, v5_body.v5(*v5_in, zero_row, "smem8", v5_body.ITERS)):
        raise AssertionError("v5 body: minimal != smem8")

    # P-interleave: every G at every chain width it admits ≡ the v5 full
    # body (its plain version) over all packets at P13_CHECK_ITERS, and ≡
    # the v5 full kernel at the script's iterations, at 128 and at 1,056
    # packets.
    il_fill = {}
    il_res = {G: {w: interleave_probe.kernel_resources((G,), {G: w})[G]
                  for w in interleave_probe.ADMITTED_W[G]} for G in interleave_probe.GS}
    for packets in (interleave_probe.N_PACKETS, P13_FILL_PACKETS):
        o, d, tl = (torch.from_numpy(a).to(dev) for a in v5_body.make_rays(packets))
        args = (v5_in[0], v5_in[1], o, d, tl, zero_row)
        plain16 = v5_body.v5_plain(*args, "full", P13_CHECK_ITERS)
        full = v5_body.v5(*args, "full", interleave_probe.ITERS)
        for G in interleave_probe.GS:
            for w in (None, *interleave_probe.ADMITTED_W[G]):
                for iters, want_t in ((P13_CHECK_ITERS, plain16), (interleave_probe.ITERS, full)):
                    if not _bitwise(interleave_probe.interleave(*args, G, iters, w=w), want_t):
                        raise AssertionError(f"interleave G={G} W {w or 'picked'}, {packets} "
                                             f"packets, {iters} iterations != the v5 full body")
                    checked.append(f"interleave G{G} W{w or 'picked'} P{packets} i{iters}")
        il_fill[packets] = args
    held("P-interleave", "interleave plain (timed)",
         lambda: interleave_probe.interleave(*il_fill[interleave_probe.N_PACKETS], 1,
                                             interleave_probe.ITERS),
         lambda: interleave_probe.interleave_plain(*il_fill[interleave_probe.N_PACKETS], 1,
                                                   interleave_probe.ITERS), "P-interleave")
    for packets in (interleave_probe.N_PACKETS, P13_FILL_PACKETS):
        g1 = runs[f"P-interleave {packets}"]["gs"][1]
        g1["v5_full_same_w_ms"] = widths[f"v5 full P{packets}"][g1["w"]]["ms"]
    log(13, "P-interleave: numRegs / localSizeBytes per G and chain width: " + "; ".join(
        f"G={G} " + ", ".join(f"W{w} {r} / {b}" for w, (r, b) in il_res[G].items())
        for G in interleave_probe.GS) + "; G=1 beside the v5 full body at the same W: " + "; ".join(
        f"{p} packets W{r['w']} {r['ms']:.4f} against {r['v5_full_same_w_ms']:.4f} ms "
        f"({r['ms'] / r['v5_full_same_w_ms']:.3f}x)"
        for p, r in ((p, runs[f"P-interleave {p}"]["gs"][1])
                     for p in (interleave_probe.N_PACKETS, P13_FILL_PACKETS))))

    # P-scalar: the pre-pass ≡ smem16_chain at P13_TABLES_SIZES; every
    # variant at the script's sizes at the picked W and at every other, acc
    # and the witness.
    for packets, iters in P13_TABLES_SIZES:
        got = scalar_cost.smem16_tables(packets, iters, dev)
        if not torch.equal(got.cpu(), scalar_cost.smem16_tables(packets, iters, "cpu")):
            raise AssertionError(f"scalar cost: the pre-pass tables != smem16_chain's at "
                                 f"{packets} packets x {iters} iterations")
        checked.append(f"scalar tables P{packets} i{iters}")
    x = torch.from_numpy(scalar_cost.make_input()).to(dev)
    tables = scalar_cost.smem16_tables(scalar_cost.N_PACKETS, scalar_cost.ITERS, dev)
    for name in scalar_cost.VARIANTS:
        mode, iters = scalar_cost.variant(name)
        tab = tables if mode == "smem16" else None
        held("P-scalar", f"scalar {name}", lambda: scalar_cost.scalar_cost(x, mode, iters, tab),
             lambda: scalar_cost.scalar_plain(x, mode, iters), f"scalar {name}")
        for w in scalar_cost.ADMITTED_W:
            also("P-scalar", f"scalar {name} W{w}",
                 lambda: scalar_cost.scalar_cost(x, mode, iters, tab, w=w))

    # P-vstack: every case at a small count, p1 / p3 also beyond the row's
    # 128 entries, the timing cases at 2,000 iterations (p2_smem at its
    # 92-entry clamp), p2_vreg (the row's case) at the script's 20,000 (its
    # plain version takes ~5 s there).
    for case in vstack.CASES:
        sizes = ((vstack.CHECK_ITERS, 150) if case in vstack.RECORD else
                 (300, vstack.TIMING_ITERS if case == "p2_vreg" else 2000))
        for iters in sizes:
            held("P-vstack", f"vstack {case} i{iters}", lambda: vstack.vstack(case, iters, dev),
                 lambda: vstack.vstack_plain(case, iters, dev),
                 f"vstack {case} i{iters}" if iters == sizes[-1] else None)
    # ... and P-scalar timed at every W (not the path: its counts are read
    # above), with the pre-pass per launch in a CUDA graph.
    chain_res = {w: scalar_cost.kernel_resources(scalar_cost.MODES, w)
                 for w in scalar_cost.ADMITTED_W}
    sv_widths = {}
    for name in scalar_cost.VARIANTS:
        mode, iters = scalar_cost.variant(name)
        tab = tables if mode == "smem16" else None
        sv_widths[name] = {"picked": scalar_cost.chosen_w(mode), **{
            w: dict(ms=common.median(common.time_launches(
                lambda: scalar_cost.scalar_cost(x, mode, iters, tab, w=w))), iters=iters,
                    num_regs=chain_res[w][mode][0], local_bytes=chain_res[w][mode][1])
            for w in scalar_cost.ADMITTED_W}}
    runs["P-scalar"]["tables_graph_ms"] = graph_ms(
        lambda: scalar_cost.smem16_tables(scalar_cost.N_PACKETS, scalar_cost.ITERS, dev))
    lat = common.latency_clocks()

    # P-ktf: each case's kernel (the wrapper's fast path) against its plain
    # version on the card, bit for bit, the unit vectors too (the entry
    # point's run held each case to the script's host expectation by its
    # rules).
    for case in ktf_probe.CASES:
        ins = tuple(torch.from_numpy(x).to(dev) for x in ktf_probe.inputs(case))
        held("P-ktf", f"ktf {case}", lambda: ktf_probe.probe_ktf(case, *ins),
             lambda: ktf_probe.ktf_plain(case, *ins), f"ktf {case}")

    # P-v6 ≡ its plain version bit for bit (the six outputs and the chains'
    # iteration counts) at 128 and 1,056 packets: P13_CHECK_ITERS iterations
    # and the script's bound, each at tlim = BIG and at limits seeded in
    # (0.05, 0.6), and the bound at stack_cap 12, where the stall guard and
    # the clamps fire; the plain version once a set, the kernel at the W it
    # picks and at every W. Then the script's rule against K4 on the same
    # tree, for the kernel (both sizes) and for the plain version (128
    # packets): t and hit mismatches none, id and material flips (near-ties)
    # at most NEAR_TIE_MAX of the hits.
    v6_res = {w: v6.kernel_resources(w) for w in v6.ADMITTED_W}
    if any(local for _, local in v6_res.values()):
        raise AssertionError(f"v6: local memory in a chain width's kernel: {v6_res}")
    v6_dev, v6_full = {}, {}
    for packets, (_, node6, tri6, nb6, cap6, o6, d6, tl6) in v6_in.items():
        args6 = tuple(t.to(dev) for t in (node6, tri6, o6, d6))
        tl_big = tl6.to(dev)
        tl_var = torch.from_numpy(np.random.default_rng(6).uniform(
            0.05, 0.6, tuple(tl6.shape)).astype(np.float32)).to(dev)
        v6_dev[packets] = (*args6, tl_big)
        for tag, lim, cap, iters in (("", tl_big, cap6, P13_CHECK_ITERS),
                                     (" tlim(0.05,0.6)", tl_var, cap6, P13_CHECK_ITERS),
                                     ("", tl_big, cap6, None),
                                     (" tlim(0.05,0.6)", tl_var, cap6, None),
                                     (" stack_cap 12", tl_big, 12, None)):
            name = f"v6 P{packets}{tag} {'full' if iters is None else f'i{iters}'}"
            main_set = iters is None and not tag
            held("P-v6", name, lambda: v6.v6(*args6, lim, nb6, cap, iters, count=True),
                 lambda: v6.v6_plain(*args6, lim, nb6, cap, iters, count=True),
                 "P-v6" if main_set and packets == v6.N_PACKETS else None)
            if main_set:
                v6_full[packets] = last_plain["P-v6"]
            for w in v6.ADMITTED_W:
                also("P-v6", f"{name} W{w}",
                     lambda: v6.v6(*args6, lim, nb6, cap, iters, count=True, w=w))
    p6 = v6_full[v6.N_PACKETS]
    bvh6_dev = v6_in[v6.N_PACKETS][0].to(dev)
    o6f, d6f = v6.unpack(v6_dev[v6.N_PACKETS][2]), v6.unpack(v6_dev[v6.N_PACKETS][3])
    ref6 = trace_closest_plain(o6f, d6f, bvh6_dev, float(BIG))
    mis_plain = v6.against_k4(p6[:6], ref6)
    mis_kernel = runs[f"P-v6 {v6.N_PACKETS}"]["mismatches"]
    for who, mis in (("kernel", mis_kernel), ("plain", mis_plain),
                     (f"kernel, {P13_FILL_PACKETS} packets",
                      runs[f"P-v6 {P13_FILL_PACKETS}"]["mismatches"])):
        if mis["t"] or mis["hit"] or max(mis["tri"], mis["mat"]) > NEAR_TIE_MAX * mis["hits"]:
            raise AssertionError(f"v6 ({who}) against K4 on the 4-wide tree: {mis}")
    if mis_kernel != mis_plain:
        raise AssertionError(f"v6 against K4: kernel {mis_kernel}, plain {mis_plain}")
    chain_iters = {p: int(v6_full[p][6].sum()) for p in v6_in}
    if any(chain_iters[p] != runs[f"P-v6 {p}"]["chain_iters"] for p in v6_in):
        raise AssertionError("v6: the chains' iteration counts differ between runs")
    # ... and P-v6 timed at every chain width at both sizes (not the path:
    # its counts are read above), beside the W the wrapper picks.
    v6_widths = {}
    for packets, a6 in v6_dev.items():
        nb6, cap6 = v6_in[packets][3], v6_in[packets][4]
        v6_widths[f"v6 P{packets}"] = {"picked": runs[f"P-v6 {packets}"]["w"], **{
            w: dict(ms=common.median(common.time_launches(
                lambda: v6.v6(*a6, nb6, cap6, w=w))), num_regs=v6_res[w][0],
                    local_bytes=v6_res[w][1]) for w in v6.ADMITTED_W}}
    log(13, f"P-v6 at every chain width (median of {common.TIMED_LAUNCHES} launches; numRegs / "
            f"localSizeBytes): " + "; ".join(
                f"{name}: " + ", ".join(f"W{w} {r['ms']:.4f} ms ({r['num_regs']} / "
                                        f"{r['local_bytes']} B)" for w, r in row.items()
                                        if w != "picked") + f" (picks W{row['picked']})"
                for name, row in v6_widths.items()))
    # ... and between the two sizes, W = 2 against W = 4 in turns, their
    # outputs equal bit for bit: where the wrapper's threshold lies.
    v6_between, sms = {}, common.sm_count(dev)
    node6, tri6, nb6, cap6 = v6_in[v6.N_PACKETS][1:5]
    for packets in P13_V6_BETWEEN:
        a6 = tuple(t.to(dev) for t in (node6, tri6, *(
            torch.from_numpy(a) for a in v5_body.make_rays(packets, seed=0))))
        outs = [v6.v6(*a6, nb6, cap6, count=True, w=w) for w in v6.ADMITTED_W]
        if not all(_bitwise(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"v6 P{packets}: the chain widths' outputs differ")
        t = alternate({w: (lambda w=w: common.median(common.time_launches(
            lambda: v6.v6(*a6, nb6, cap6, w=w)))) for w in v6.ADMITTED_W})
        v6_between[f"v6 P{packets}"] = {"picked": v6.chosen_w(packets), **{
            w: dict(ms=float(np.median(v)), turns_ms=v) for w, v in t.items()}}
    log(13, f"P-v6 between the sizes, chain widths in {P13_TURN_PAIRS} pairs of rounds "
            f"(median of the rounds' medians): " + "; ".join(
                f"{name} ({int(name.split('P')[-1]) * v6.P_SUB / sms:.1f} chains an SM): "
                + ", ".join(f"W{w} {r['ms']:.4f} ms" for w, r in row.items() if w != "picked")
                + f" (picks W{row['picked']})" for name, row in v6_between.items()))

    # P-morph: every variant at every chain width ≡ its plain version bit
    # for bit, the packets' loop counts included, at the script's 8 packets
    # and at 1,056, and the same loop counts as the entry point's run; the
    # plain version's live chain-iterations (begun at a task) for the
    # bounds.
    morph_dev = {p: [t.to(dev) for t in (node, tri, o, d, tl)]
                 for p, (node, tri, _, _, o, d, tl) in morph_in.items()}
    morph_res = {v: {w: morph.kernel_resources((v,), w)[v] for w in morph.ADMITTED_W[v]}
                 for v in morph.VARIANTS}
    for packets, (node, tri, nb, cap, *_) in morph_in.items():
        for v in morph.VARIANTS:
            args = (*morph_dev[packets], nb, cap, v)
            live = {}

            def plain(args=args, live=live):
                *outs, live["chains"] = morph.morph_plain(*args, live=True)
                return tuple(outs)

            k = held("P-morph", f"morph {v} P{packets}", lambda: morph.morph(*args), plain,
                     f"morph {v} P{packets}")
            for w in morph.ADMITTED_W[v]:
                kw, p = morph.morph(*args, w=w), last_plain["P-morph"]
                if not all(a.dtype == b.dtype and a.shape == b.shape and _bitwise(a, b)
                           for a, b in zip(kw, p)):
                    raise AssertionError(f"morph {v} P{packets} W{w}: kernel != plain")
                checked.append(f"morph {v} P{packets} W{w}")
            r = runs[f"P-morph {packets}"][v]
            if k[-1].cpu().tolist() != r["iters"]:
                raise AssertionError(f"morph {v}: the loop counts differ between runs")
            it = r.pop("iters")   # kept short for the JSON lines
            r["loop_iters"] = dict(min=min(it), max=max(it), total=sum(it))
            r["live_chain_iters"] = int(live["chains"].sum())
            r["live_share"] = r["live_chain_iters"] / max(r["chain_iters"], 1)
    log(13, "P-morph: numRegs / localSizeBytes per variant and chain width: " + "; ".join(
        f"{v} " + ", ".join(f"W{w} {r} / {b}" for w, (r, b) in morph_res[v].items())
        for v in morph.VARIANTS))
    # P-morph and P-interleave timed at every chain width they admit (not the
    # path: its counts are read above), beside the W the wrapper picks.
    mi_widths = {}
    for packets, (node, tri, nb, cap, *_) in morph_in.items():
        for v in morph.VARIANTS:
            args = (*morph_dev[packets], nb, cap, v)
            mi_widths[f"morph {v} P{packets}"] = {"picked": runs[f"P-morph {packets}"][v]["w"], **{
                w: dict(ms=common.median(common.time_launches(
                    lambda: morph.morph(*args, w=w))), num_regs=morph_res[v][w][0],
                    local_bytes=morph_res[v][w][1]) for w in morph.ADMITTED_W[v]}}
    for packets, args in il_fill.items():
        for G in interleave_probe.GS:
            mi_widths[f"interleave G={G} P{packets}"] = {
                "picked": runs[f"P-interleave {packets}"]["gs"][G]["w"], **{
                    w: dict(ms=common.median(common.time_launches(
                        lambda: interleave_probe.interleave(*args, G, interleave_probe.ITERS,
                                                            w=w))),
                            num_regs=il_res[G][w][0], local_bytes=il_res[G][w][1])
                    for w in interleave_probe.ADMITTED_W[G]}}
    log(13, "P-morph and P-interleave at every chain width (median of "
            f"{common.TIMED_LAUNCHES} launches): " + "; ".join(
                f"{name}: " + ", ".join(f"W{w} {r['ms']:.4f} ms" for w, r in row.items()
                                        if w != "picked") + f" (picks W{row['picked']})"
                for name, row in mi_widths.items()))

    # P-mosaic, P-bitcast, P-feature: every case's kernel ≡ its plain version
    # on the card bit for bit; a bitcast verdict as the plain version's.
    for case in mosaic.CASES:
        ins = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in mosaic.inputs(case))
        held("P-mosaic", f"mosaic {case}", lambda: mosaic.probe_mosaic(case, *ins),
             lambda: mosaic.mosaic_plain(case, *ins), f"mosaic {case}")
    for case in bitcast.CASES:
        tab, r0 = bitcast.case_input(case, bc_tabs, dev)
        held("P-bitcast", f"bitcast {case}", lambda: bitcast.probe_bitcast(case, tab, r0),
             lambda: bitcast.bitcast_plain(case, tab, r0), f"bitcast {case}")
        plain_ok = bitcast.verdict(case, [t.cpu().numpy() for t in last_plain["P-bitcast"]],
                                   bc_tabs)[0]
        if plain_ok != runs["P-bitcast"][case]["verdict"]:
            raise AssertionError(f"bitcast {case}: the kernel's verdict differs from the plain "
                                 f"version's")
    for case in feature.CASES:
        ins = tuple(torch.from_numpy(a).to(dev) for a in feature.inputs(case))
        held("P-feature", f"feature {case}", lambda: feature.probe_feature(case, *ins),
             lambda: feature.feature_plain(case, *ins), f"feature {case}")
    # ---- the redesigned single-tile probes: per call in turns against the
    # library call, device time from a CUDA graph, and the launch floor
    floor = lambda: v5_body.v5(*v5_in, zero_row, "empty", v5_body.ITERS)   # noqa: E731
    tiles = tile_times(dev, floor)
    for line in tiles["lines"]:
        log(13, line)

    # ---- what each knockout left of the kernel: static SASS counts
    if os.path.exists(sass.cuobjdump()):
        sc = sass.by_name()
        for run_ in (runs["P-v8"], runs["P-v8 fill"]):
            for v, r in run_["variants"].items():
                r["sass"] = sc[f"v8 {v} W{r['w']}"]
        for key in v5_probes:
            for mode, r in runs[key]["modes"].items():
                r["sass"] = sc[f"v5 {mode} W{r['w']}"]
        for name, row in widths.items():
            for w, r in row.items():
                if w != "picked":
                    r["sass"] = sc[f"{name.rsplit(' ', 1)[0]} W{w}"]
        for packets in (interleave_probe.N_PACKETS, P13_FILL_PACKETS):
            for G, r in runs[f"P-interleave {packets}"]["gs"].items():
                r["sass"] = sc[f"interleave G{G} W{r['w']}"]
        for name, r in runs["P-scalar"]["variants"].items():
            r["sass"] = sc[f"scalar {scalar_cost.variant(name)[0]} W{r['w']}"]
        for name, row in sv_widths.items():
            for w, r in row.items():
                if w != "picked":
                    r["sass"] = sc[f"scalar {scalar_cost.variant(name)[0]} W{w}"]
        runs["P-scalar"]["tables_sass"] = sc["scalar tables"]
        for case, r in runs["P-vstack"].items():
            r["sass"] = sc[f"vstack {case}"]
        for case, r in runs["P-ktf"].items():
            r["sass"] = sc[f"ktf {case}"]
        for packets in v6_in:
            r = runs[f"P-v6 {packets}"]
            r["sass"] = sc[f"v6 W{r['w']}"]
        for row in v6_widths.values():
            for w, r in row.items():
                if w != "picked":
                    r["sass"] = sc[f"v6 W{w}"]
        for packets in morph_in:
            for v, r in runs[f"P-morph {packets}"].items():
                r["sass"] = sc[f"morph {v} W{r['w']}"]
        for key, mod in (("P-mosaic", "mosaic"), ("P-bitcast", "bitcast"),
                         ("P-feature", "feature")):
            for case, r in runs[key].items():
                if case != "s7":
                    r["sass"] = sc[f"{mod} {case}"]
        log(13, "static SASS instructions per kernel (cuobjdump -sass): " + "; ".join(
            f"{k} {c['total']} (fp32 {c['fp32']}, int {c['int']}, shfl {c['shfl']}, shared "
            f"{c['shared']}, global {c['global']}, local {c['local']}, sync {c['sync']})"
            for k, c in sc.items()))
    else:
        log(13, "static SASS counts: not measured (no cuobjdump beside nvcc)")

    # ---- rows, with the bound of each variant at its size
    int32_rate, mhz = _int32_ops_per_s()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # fp32 at the SM clock read under load (fp32_ops_per_s: -fmad=false)
    f32 = fp32_ops_per_s(n_sm, clock["mhz"])
    rows = {}
    for run_ in (runs["P-v8"], runs["P-v8 fill"]):
        node, tri, o, _ = v8_in[run_["packets"]]
        for v, r in run_["variants"].items():
            w = ablate_v8.work(node, tri, o, v, run_["iters"])
            r.update(roofline(w["bytes"], w["ops"], f32))
    for key in v5_probes:
        for mode, r in runs[key]["modes"].items():
            w = v5_body.work(v5_in[0], v5_in[1], v5_in[2], mode, v5_body.ITERS)
            r.update(roofline(w["bytes"], w["ops"], f32))
    # Both bounds of every (variant or mode, packets, W), and the share of
    # each that the kernel reaches (bound / ms); the issue bound at the SM
    # clock read under load.
    for name, row in widths.items():
        body_, case, pk = name.split()
        packets = int(pk[1:])
        if body_ == "v8":
            node, tri, o, _ = v8_in[packets]
            wk, iters = ablate_v8.work(node, tri, o, case, ablate_v8.ITERS), ablate_v8.ITERS
        else:
            args = v5_sizes[packets][0]
            wk, iters = v5_body.work(args[0], args[1], args[2], case, v5_body.ITERS), v5_body.ITERS
        for w, r in row.items():
            if w == "picked":
                continue
            r.update(roofline(wk["bytes"], wk["ops"], f32))
            r["roofline_share"] = r["bound_ms"] / r["ms"]
            n = iter_insns(r["sass"], f"{body_} {case}") if "sass" in r else None
            if n is not None:
                r["issue_insns"] = n
                r["issue_bound_ms"] = issue_bound_ms(n, packets * 8 * w, iters, n_sm,
                                                     clock["mhz"])
                r["issue_share"] = r["issue_bound_ms"] / r["ms"]
    bounds_are = (f"roofline: bytes / 3.35 TB/s against fp32 operations / {f32 / 1e12:.1f} "
                  f"TFLOP/s ({FP32_LANES_PER_SM} lanes x {n_sm} SMs x {clock['mhz']:.0f} MHz); "
                  f"issue: the fewest SASS instructions on a path through the loop x "
                  f"warp-iterations / ({SCHEDULERS_PER_SM} x {n_sm} SMs x {clock['mhz']:.0f} MHz)")
    log(13, f"P-v8 and the v5 body, bounds per chain width ({bounds_are}), each with the share "
            "of it reached: " + "; ".join(
                f"{name} " + ", ".join(
                    f"W{w} {r['ms']:.4f} ms, roofline {r['bound_ms']:.4f} "
                    f"({100 * r['roofline_share']:.1f}%)"
                    + (f", issue {r['issue_bound_ms']:.4f} ({100 * r['issue_share']:.1f}%; "
                       f"SASS {r['sass']['total']}, {r['issue_insns']} an iteration)"
                       if "issue_bound_ms" in r else ", issue not measured")
                    for w, r in row.items() if w != "picked")
                for name, row in widths.items()))
    # P-interleave and P-morph: both bounds at the picked W, with the share
    # reached. A morph `while` chain runs its live iterations alone (each
    # on W warps); the other loops run every chain of the packet loop.
    for packets in (interleave_probe.N_PACKETS, P13_FILL_PACKETS):
        w = interleave_probe.work(v5_in[0], v5_in[1], il_fill[packets][2], interleave_probe.ITERS)
        for G, r in runs[f"P-interleave {packets}"]["gs"].items():
            r.update(roofline(w["bytes"], w["ops"], f32))
            r["roofline_share"] = r["bound_ms"] / r["ms"]
            if "sass" in r:
                r["issue_bound_ms"] = issue_bound_ms(iter_insns(r["sass"], "interleave"),
                                                     r["warps"], interleave_probe.ITERS, n_sm,
                                                     clock["mhz"])
                r["issue_share"] = r["issue_bound_ms"] / r["ms"]
    # P-morph's issue bound counts its SASS by loop (sass.loops): the walk's
    # body per warp-iteration, the brute pre-pass's loop per brute row and
    # the code outside both once, each per warp of every chain.
    for packets, (node, tri, nb, *_) in morph_in.items():
        for v, r in runs[f"P-morph {packets}"].items():
            w = morph.work(node, tri, morph_in[packets][4], v, r["live_chain_iters"], nb)
            r.update(roofline(w["bytes"], w["ops"], f32))
            r["roofline_share"] = r["bound_ms"] / r["ms"]
            r["warp_iters"] = r["w"] * (r["live_chain_iters"] if morph.VARIANTS[v][0] == "while"
                                        else r["chain_iters"])
            if "sass" not in r:
                continue
            *pre, body = r["sass"]["loops"]
            if len(pre) != int(morph.VARIANTS[v][3]):
                raise AssertionError(f"morph {v} W{r['w']}: {len(pre) + 1} loops in its SASS, "
                                     f"expected {int(morph.VARIANTS[v][3]) + 1}")
            warps = packets * morph.P_SUB * r["w"]
            r["issue_insns"] = (body * r["warp_iters"]
                                + warps * (r["sass"]["straight"] + sum(pre) * nb))
            r["issue_bound_ms"] = issue_bound_ms(r["issue_insns"], 1, 1, n_sm, clock["mhz"])
            r["issue_share"] = r["issue_bound_ms"] / r["ms"]

    def shares(r):
        return (f"roofline {r['bound_ms']:.4f} ({100 * r['roofline_share']:.1f}%)"
                + (f", issue {r['issue_bound_ms']:.4f} ({100 * r['issue_share']:.1f}%; SASS "
                   f"{r['sass']['total']})" if "issue_bound_ms" in r else ", issue not measured"))

    log(13, f"P-interleave, bounds at the picked W ({bounds_are}): " + "; ".join(
        f"{p} packets G={G} W{r['w']} {r['ms']:.4f} ms, {shares(r)}"
        for p in (interleave_probe.N_PACKETS, P13_FILL_PACKETS)
        for G, r in runs[f"P-interleave {p}"]["gs"].items()))
    log(13, f"P-morph, bounds at the picked W ({bounds_are}, with P-morph's SASS by loop: "
            f"the walk's body x warp-iterations + (the brute loop x brute rows + the rest) x "
            f"warps; the roofline counts the chains' live iterations, those begun at a task), "
            f"with the chains' live share of the packet loop's chain-iterations: " + "; ".join(
                f"{p} packets {v} W{r['w']} {r['ms']:.4f} ms, live {r['live_chain_iters']} of "
                f"{r['chain_iters']} ({100 * r['live_share']:.1f}%), {shares(r)}"
                + (f", loops {r['sass']['loops']} + {r['sass']['straight']}" if "sass" in r
                   else "")
                for p in morph_in for v, r in runs[f"P-morph {p}"].items()))
    for name, r in runs["P-scalar"]["variants"].items():
        mode, iters = scalar_cost.variant(name)
        w = scalar_cost.work(mode, scalar_cost.N_PACKETS, iters)
        r.update(roofline_mixed(w["bytes"], w["fp32_ops"], w["int32_ops"], int32_rate, f32))
        for wd, rw in sv_widths[name].items():
            if wd != "picked":
                rw.update(roofline_mixed(w["bytes"], w["fp32_ops"], w["int32_ops"], int32_rate,
                                         f32))
                rw["roofline_share"] = rw["bound_ms"] / rw["ms"]
                rw["ns_per_iter"] = rw["ms"] * 1e6 / iters
    # Dependence bounds: a chain's dependent instructions at the latencies
    # phase 13 measured (csrc/probe_latency.cu, SM clocks) over the card's
    # maximum SM clock. The smem16 tables pre-pass: the roofline and its
    # longest chain (a packet's iterations, then the scan of C_p).
    def dep_ms(alu, shfl):
        return (alu * lat["alu"] + shfl * lat["shfl"]) / (mhz * 1e3)

    tw = scalar_cost.tables_work(scalar_cost.N_PACKETS, scalar_cost.ITERS)
    tb = roofline_mixed(tw["bytes"], 0, tw["int32_ops"], int32_rate, f32)
    runs["P-scalar"].update(tables_bound_ms=tb["bound_ms"], tables_bound_by=tb["bound_by"],
                            tables_dep_bound_ms=dep_ms(tw["dep_alu"], tw["dep_shfl"]))
    pre = runs["P-scalar"]
    pre["tables_rank_bound_ms"] = max(pre["tables_bound_ms"], pre["tables_dep_bound_ms"])
    log(13, f"P-scalar smem16 tables pre-pass ({scalar_cost.N_PACKETS} x {scalar_cost.ITERS}): "
            f"{pre['tables_ms']:.5f} ms per call, {pre['tables_graph_ms']:.5f} ms per launch in a "
            f"CUDA graph of {P13_GRAPH_LAUNCHES}; roofline {tb['bound_ms']:.6f} ms "
            f"({tb['bound_by']}; {tw['int32_ops']} int32 operations, {tw['bytes']} bytes), "
            f"dependence {pre['tables_dep_bound_ms']:.5f} ms ({tw['dep_alu']} ALU and "
            f"{tw['dep_shfl']} shuffle steps at {lat['alu']:.2f} / {lat['shfl']:.2f} clocks, "
            f"{mhz:.0f} MHz; {100 * pre['tables_rank_bound_ms'] / pre['tables_ms']:.1f}% of the "
            f"call, {100 * pre['tables_rank_bound_ms'] / pre['tables_graph_ms']:.1f}% of the "
            f"launch)")
    log(13, "P-scalar at every W (median of 10 launches; roofline share; the picked W marked *): "
            + "; ".join(f"{name} " + ", ".join(
                f"W{w}{'*' if w == row['picked'] else ''} {r['ms']:.4f} ms "
                f"{r['ns_per_iter']:.1f} ns/iter {100 * r['roofline_share']:.1f}% "
                f"({r['num_regs']} regs / {r['local_bytes']} B)"
                for w, r in row.items() if w != "picked") for name, row in sv_widths.items()))
    for case, r in runs["P-vstack"].items():
        w = vstack.work(case, r["iters"])
        steps = vstack.dependence_steps(case, r["iters"])
        r.update(roofline_mixed(w["bytes"], 0, w["int32_ops"], int32_rate, f32))
        # the 8 SMs the chains run on: their share of the peaks
        r["bound_sms_ms"] = r["bound_ms"] * n_sm / vstack.P_SUB
        r["dep_bound_ms"] = dep_ms(steps["alu"], steps["shfl"])
        r["rank_bound_ms"] = max(r["bound_ms"], r["dep_bound_ms"])
    log(13, f"P-vstack (median of 10 launches; latencies {lat['alu']:.2f} ALU / "
            f"{lat['shfl']:.2f} shuffle clocks at {mhz:.0f} MHz): " + "; ".join(
                f"{case} {r['ms']:.4f} ms {r['ns_per_iter']:.2f} ns/iter, roofline "
                f"{r['bound_ms']:.5f} (its SMs {r['bound_sms_ms']:.4f}), dependence "
                f"{r['dep_bound_ms']:.4f} ({100 * r['dep_bound_ms'] / r['ms']:.1f}%) "
                f"({r['num_regs']} regs / {r['local_bytes']} B)"
                for case, r in runs["P-vstack"].items()))
    for case, r in runs["P-ktf"].items():
        w = ktf_probe.work(case)
        r.update(roofline_mixed(w["bytes"], w["fp32_ops"], w["int32_ops"], int32_rate, f32))
    # P-v6: the roofline on the chains' iterations, and the issue bound by
    # loop (sass.loop_min): the walk's shortest path per warp-iteration (W
    # warps a chain-iteration) and the brute pre-pass's per brute row and
    # warp of every chain.
    def v6_bounds(r, w, packets):
        _, node6, tri6, nb6, _, o6, *_ = v6_in[packets]
        wk = v6.work(node6, tri6, o6, chain_iters[packets], nb6)
        r.update(roofline(wk["bytes"], wk["ops"], f32))
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        if "sass" not in r:
            return
        lm = r["sass"]["loop_min"]
        if len(lm) != 2:
            raise AssertionError(f"v6 W{w}: {len(lm)} outermost loops in its SASS "
                                 f"({r['sass']['loops']}), expected 2 (the brute pre-pass, the "
                                 f"walk)")
        r["issue_insns"] = lm[1] * w * chain_iters[packets] + lm[0] * nb6 * packets * v6.P_SUB * w
        r["issue_bound_ms"] = issue_bound_ms(r["issue_insns"], 1, 1, n_sm, clock["mhz"])
        r["issue_share"] = r["issue_bound_ms"] / r["ms"]

    for packets in v6_in:
        r = runs[f"P-v6 {packets}"]
        v6_bounds(r, r["w"], packets)
        for w, rw in v6_widths[f"v6 P{packets}"].items():
            if w != "picked":
                v6_bounds(rw, w, packets)
    log(13, f"P-v6, bounds per chain width ({bounds_are}; the issue bound by loop: the walk's "
            f"shortest path x warp-iterations + the brute loop's x brute rows x warps): "
            + "; ".join(
                f"{name} " + ", ".join(
                    f"W{w} {r['ms']:.4f} ms, {shares(r)}"
                    + (f", loops {r['sass']['loop_min']} shortest" if "sass" in r else "")
                    for w, r in row.items() if w != "picked")
                for name, row in v6_widths.items()))
    for key, mod in (("P-mosaic", mosaic), ("P-bitcast", bitcast), ("P-feature", feature)):
        for case, r in runs[key].items():
            if case != "s7":
                w = mod.work(case)
                r.update(roofline_mixed(w["bytes"], w["fp32_ops"], w["int32_ops"], int32_rate, f32))
    fill = runs["P-v8 fill"]["variants"]
    def picked(name):
        row = widths[name]
        r = row[row["picked"]]
        return {k: r[k] for k in ("issue_bound_ms", "issue_share", "roofline_share") if k in r}

    rows["P-v8"] = dict(launches=launches["P-v8"], max_abs_err=max_err["P-v8"],
                        plain_ms=plain_ms["P-v8"], **runs["P-v8"]["variants"]["full"],
                        **picked(f"v8 full P{ablate_v8.N_PACKETS}"),
                        ms_1056=fill["full"]["ms"], bound_1056_ms=fill["full"]["bound_ms"],
                        w_1056=fill["full"]["w"],
                        issue_bound_1056_ms=picked(f"v8 full P{P13_FILL_PACKETS}").get(
                            "issue_bound_ms"),
                        variants=runs["P-v8"]["variants"], variants_1056=fill,
                        widths={k: v for k, v in widths.items() if k.startswith("v8")},
                        sm_clock_mhz=clock["mhz"])
    for key, first in (("P-ablate", "full"), ("P-load", "full16"), ("P-floor", "prod_smem"),
                       ("P-base", "base")):
        m = runs[key]["modes"]
        rows[key] = dict(launches=launches[key], max_abs_err=max_err[key],
                         plain_ms=plain_ms[first], ms_is=first, **m[first],
                         **picked(f"v5 {first} P{v5_body.N_PACKETS}"), modes=m,
                         widths={k: v for k, v in widths.items()
                                 if k.split()[0] == "v5" and k.split()[1] in m},
                         sm_clock_mhz=clock["mhz"])
    il, il_f = runs[f"P-interleave {interleave_probe.N_PACKETS}"], \
        runs[f"P-interleave {P13_FILL_PACKETS}"]
    rows["P-interleave"] = dict(launches=launches["P-interleave"],
                                max_abs_err=max_err["P-interleave"],
                                plain_ms=plain_ms["P-interleave"],
                                ms_is=f"G=1, 128 packets, W {il['gs'][1]['w']}",
                                **il["gs"][1], ms_1056=il_f["gs"][1]["ms"],
                                bound_1056_ms=il_f["gs"][1]["bound_ms"], gs=il["gs"],
                                gs_1056=il_f["gs"], resources=il_res, sm_clock_mhz=clock["mhz"],
                                widths={k: v for k, v in mi_widths.items()
                                        if k.startswith("interleave")})
    sv = runs["P-scalar"]["variants"]
    rows["P-scalar"] = dict(launches=launches["P-scalar"], max_abs_err=max_err["P-scalar"],
                            plain_ms=plain_ms["scalar baseline"], ms_is="baseline",
                            **sv["baseline"], tables_ms=runs["P-scalar"]["tables_ms"],
                            **{k: runs["P-scalar"][k] for k in (
                                "tables_graph_ms", "tables_bound_ms", "tables_bound_by",
                                "tables_dep_bound_ms", "tables_rank_bound_ms")},
                            tables_launches=launches["P-scalar tables"], variants=sv,
                            widths=sv_widths, latency_clocks=lat,
                            plain_ms_variants={k: v for k, v in plain_ms.items()
                                               if k.startswith("scalar")},
                            int32_ops_per_s=int32_rate, max_sm_clock_mhz=mhz)
    vs = runs["P-vstack"]
    rows["P-vstack"] = dict(launches=launches["P-vstack"], max_abs_err=max_err["P-vstack"],
                            plain_ms=plain_ms[f"vstack p2_vreg i{vstack.TIMING_ITERS}"],
                            ms_is="p2_vreg, 20,000 iterations",
                            **vs["p2_vreg"], cases=vs, latency_clocks=lat,
                            plain_ms_cases={k: v for k, v in plain_ms.items()
                                            if k.startswith("vstack")},
                            int32_ops_per_s=int32_rate)
    kt = runs["P-ktf"]
    for case, r in kt.items():
        r.update(tiles["cases"][f"ktf {case}"])
    rows["P-ktf"] = dict(launches=launches["P-ktf"], max_abs_err=max_err["P-ktf"],
                         plain_ms=plain_ms["ktf sampler_tile"], ms_is="sampler_tile",
                         **kt["sampler_tile"], cases=kt,
                         plain_ms_cases={k: v for k, v in plain_ms.items() if k.startswith("ktf")},
                         int32_ops_per_s=int32_rate, floor_ms=tiles["floor"]["ms"],
                         floor_graph_ms=tiles["floor"]["graph_ms"],
                         host_us={k: v for k, v in tiles["host_us"].items()
                                  if k.startswith("ktf ")})
    r6, r6f = runs[f"P-v6 {v6.N_PACKETS}"], runs[f"P-v6 {P13_FILL_PACKETS}"]
    rows["P-v6"] = dict(launches=launches["P-v6"], max_abs_err=max_err["P-v6"],
                        plain_ms=plain_ms["P-v6"],
                        ms_is=f"{v6.N_PACKETS} packets, full length, W {r6['w']}",
                        **{k: v for k, v in r6.items() if k != "times_ms"},
                        mismatches_plain=mis_plain, ms_1056=r6f["ms"], w_1056=r6f["w"],
                        ms_k4_1056=r6f["ms_k4"], bound_1056_ms=r6f["bound_ms"],
                        issue_bound_1056_ms=r6f.get("issue_bound_ms"),
                        chain_iters_1056=r6f["chain_iters"], mismatches_1056=r6f["mismatches"],
                        widths=v6_widths, widths_between=v6_between, resources=v6_res,
                        sm_clock_mhz=clock["mhz"])
    m8, mf = runs[f"P-morph {morph.N_PACKETS}"], runs[f"P-morph {P13_FILL_PACKETS}"]
    rows["P-morph"] = dict(launches=launches["P-morph"], max_abs_err=max_err["P-morph"],
                           plain_ms=plain_ms[f"morph v0_ablate P{morph.N_PACKETS}"],
                           ms_is=f"v0_ablate, {morph.N_PACKETS} packets, W {m8['v0_ablate']['w']}",
                           **m8["v0_ablate"], ms_1056=mf["v0_ablate"]["ms"],
                           bound_1056_ms=mf["v0_ablate"]["bound_ms"], variants=m8,
                           variants_1056=mf, resources=morph_res,
                           widths={k: v for k, v in mi_widths.items() if k.startswith("morph")},
                           plain_ms_variants={k: v for k, v in plain_ms.items()
                                              if k.startswith("morph")},
                           sm_clock_mhz=clock["mhz"])
    for key, first, mod in (("P-mosaic", "colbcast", "mosaic"), ("P-bitcast", "p4", "bitcast"),
                            ("P-feature", "s2", "feature")):
        cases = runs[key]
        for case, r in cases.items():
            r.update(tiles["cases"].get(f"{mod} {case}", {}))
        rows[key] = dict(launches=launches[key], max_abs_err=max_err[key],
                         plain_ms=plain_ms[f"{mod} {first}"], ms_is=first, **cases[first],
                         cases=cases,
                         plain_ms_cases={k: v for k, v in plain_ms.items()
                                         if k.startswith(mod)},
                         int32_ops_per_s=int32_rate)
        others = tuple(f"{m} " for m in ("mosaic", "bitcast", "feature", "ktf") if m != mod)
        rows[key].update(floor_ms=tiles["floor"]["ms"], floor_graph_ms=tiles["floor"]["graph_ms"],
                         host_us={k: v for k, v in tiles["host_us"].items()
                                  if not k.startswith(others)})
    rows["P-floor"].update(empty_ms_turns=tiles["floor"]["ms"],
                           empty_graph_ms=tiles["floor"]["graph_ms"])
    rows["P-feature"]["s7_k4_launches"] = launches["P-feature s7 (K4)"]
    # The order of redesign: each probe's launches x (time - bound), summed
    # over every case at every size (11 launches a case: a warm-up and 10
    # timed; P-v6 12 in all), at the picked W, against the larger of a
    # case's bounds: the roofline and, where counted, the issue bound
    # (P-v8, the v5 body, P-interleave, P-morph) or the dependence bound
    # (P-vstack, the P-scalar pre-pass).
    for run_ in (runs["P-v8"], runs["P-v8 fill"]):
        for v, r in run_["variants"].items():
            r["issue_bound_ms"] = widths[f"v8 {v} P{run_['packets']}"][r["w"]].get(
                "issue_bound_ms")
    for key in v5_probes:
        for mode, r in runs[key]["modes"].items():
            r["issue_bound_ms"] = widths[f"v5 {mode} P{v5_body.N_PACKETS}"][r["w"]].get(
                "issue_bound_ms")

    def larger_bound(r):
        return max([r["bound_ms"]] + [r[k] for k in ("issue_bound_ms", "rank_bound_ms")
                                      if r.get(k) is not None])

    cases = {"P-v8": [*runs["P-v8"]["variants"].values(), *runs["P-v8 fill"]["variants"].values()],
             **{k: list(runs[k]["modes"].values()) for k in v5_probes},
             "P-interleave": [r for p in (interleave_probe.N_PACKETS, P13_FILL_PACKETS)
                              for r in runs[f"P-interleave {p}"]["gs"].values()],
             "P-scalar": list(runs["P-scalar"]["variants"].values()),
             "P-vstack": list(runs["P-vstack"].values()), "P-ktf": list(runs["P-ktf"].values()),
             "P-morph": [r for p in morph_in for r in runs[f"P-morph {p}"].values()],
             **{k: [r for c, r in runs[k].items() if c != "s7"]
                for k in ("P-mosaic", "P-bitcast", "P-feature")}}
    rank = {k: 11 * sum(r["ms"] - larger_bound(r) for r in rs) for k, rs in cases.items()}
    rank["P-v6"] = 12 * sum(r["ms"] - larger_bound(r) for r in (r6, r6f))
    rank["P-scalar pre-pass"] = 11 * (pre["tables_ms"] - pre["tables_rank_bound_ms"])
    for k, v in rank.items():
        rows[k if k in rows else "P-scalar"].setdefault("rank", {})[k] = v
    log(13, "rank, launches x (time - bound) summed over every case and size (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(rank.items(), key=lambda kv: -kv[1])))
    over = over_bounds({**runs, "P-v8/v5 widths": widths, "P-morph/interleave widths": mi_widths,
                        "P-scalar widths": sv_widths, "P-v6 widths": v6_widths})
    if over:
        raise AssertionError("phase 13: a measured time under its bound (a reading over 100%): "
                             + "; ".join(over))
    secs = time.perf_counter() - t_phase
    log(13, f"every variant == its plain version bit for bit ({len(checked)} checks: "
            f"{P13_CHECK_ITERS} iterations over all packets, the full bodies also at the "
            f"scripts' iterations, the base modes also at limits in ±50, P-v8 also on NaN "
            f"inputs and the v5 body also at {P13_FILL_PACKETS} packets, each case at the "
            f"picked chain width and at every other; interleave every G "
            f"== v5 full at 128 and {P13_FILL_PACKETS} packets; scalar acc, sc and codes at "
            f"the script's sizes at every W, the pre-pass at {P13_TABLES_SIZES}; vstack at "
            f"64/150 and 300/2,000 iterations, p2_vreg also at 20,000; ktf "
            f"every case bit for bit; v6 at every W at {P13_CHECK_ITERS} iterations and at full "
            f"length (tlim BIG and in (0.05, 0.6)) and at stack_cap 12 on all {v6.N_PACKETS} and "
            f"{P13_FILL_PACKETS} packets, chain iterations {chain_iters}; v6 against K4 on the "
            f"4-wide tree: kernel {mis_kernel}, plain {mis_plain}; morph every variant at "
            f"{morph.N_PACKETS} and "
            f"{P13_FILL_PACKETS} packets, loop counts included; mosaic, bitcast and feature "
            f"every case); full == "
            f"full16 == prod_smem == prod_carry, minimal == smem8; launches {launches} (11 per "
            f"variant: a warm-up and 10 timed), plain calls {plain_calls}; plain "
            f"{', '.join(f'{k} {v:.1f} ms' for k, v in plain_ms.items())}; numRegs / "
            f"localSizeBytes v8 {res_v8}, v5 {res_v5}; v5 tables built in {setup_s:.2f} s; "
            f"phase {secs:.1f} s on {smi}")
    return dict(seconds=secs, checks=len(checked), launches=launches, card=smi, runs=runs,
                rows=rows)


def _cli_counts(argv, env):
    """The CLI in this process with `env` set, the launch counts from 0:
    (counts of the fused and the differentiable paths, the PNG's head)."""
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.ops import cuda_megakernel as cm

    out = argv.index("--out") + 1
    argv = argv[:out] + [os.path.join(ROOT, argv[out])] + argv[out + 1:]
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    _reset_fused_counts()
    _reset_counts()
    try:
        cli.main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    with open(argv[out], "rb") as f:
        head = f.read(8)
    return dict(cm.LAUNCHES, **cm.PLAIN_CALLS, **_counts()), head


def phase14(scene8, dev, smi):
    """K4, K3, K5 and K3-profile on the reference scene's 4-wide tree,
    against their plain versions and the width-8 kernels, and the CLI on
    that tree."""
    import torch

    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.fused import render_image_fused
    from raytracer_tpu_torch.ops import cuda_megakernel as cm
    from raytracer_tpu_torch.ops import cuda_traverse as ct
    from raytracer_tpu_torch.ops.bvh4 import BIG
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid, blocked_pixel_grid
    from raytracer_tpu_torch.scene.builder import reference_scene, tree_width

    t0 = time.perf_counter()
    with tree_width(4):
        scene4 = reference_scene().to(dev)
    build_s = time.perf_counter() - t0
    b4, b8 = scene4.bvh4, scene8.bvh4
    if b4.children.shape[1] != 4 or not torch.equal(b4.tri, b8.tri):
        raise AssertionError("the 4-wide tree is not the BVH8's native tree unwidened")
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def plain_ms_of(fn):
        torch.cuda.synchronize()
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        return out, ev0.elapsed_time(ev1)

    # ---- K4<4>: phase 4's 131,072 rays, against its plain version (bit for
    # bit) and against K4<8> (t bit for bit; ids equal but at equal t).
    o, d = phase4_rays(scene8, dev)
    n = o.shape[0]
    tl = torch.full((n,), float(BIG), device=dev)
    k4 = ct.trace_closest(o, d, b4, BIG, sort=False)
    k8 = ct.trace_closest(o, d, b8, BIG, sort=False)
    plain, plain_ms_k4 = plain_ms_of(lambda: ct._traverse_plain(o, d, b4, tl, 1e-3, count=True))
    p4, steps4 = ct._finish(*plain[:4]), plain[4]
    steps8 = ct._traverse_plain(o, d, b8, tl, 1e-3, count=True)[4]
    differ = [k for k in k4 if not (_bitwise(k4[k], p4[k]) if k4[k].is_floating_point()
                                    else torch.equal(k4[k], p4[k]))]
    if differ:
        raise AssertionError(f"K4<4> vs plain: fields {differ} differ")
    hit = k4["hit"]
    flips = int((k4["tri_id"] != k8["tri_id"])[hit].sum())
    n_hit = int(hit.sum())
    if not (_bitwise(k4["t"], k8["t"]) and torch.equal(hit, k8["hit"])):
        raise AssertionError("K4<4> vs K4<8>: t or the hit mask differ")
    if flips > NEAR_TIE_MAX * max(n_hit, 1):
        raise AssertionError(f"K4<4> vs K4<8>: {flips} id flips in {n_hit} hits")
    rs = ct.trace_closest(o, d, b4, BIG, sort=True)
    if [k for k in rs if not torch.equal(rs[k], k4[k])]:
        raise AssertionError("K4-sort on the 4-wide tree differs from K4 unsorted")
    t4 = _frames_in_turns({"K4<4>": lambda: ct.trace_closest(o, d, b4, BIG, sort=False),
                           "K4<8>": lambda: ct.trace_closest(o, d, b8, BIG, sort=False)}, 10)
    ms4 = {k: float(np.median(v[1])) * 1e3 for k, v in t4.items()}
    res = {**cm.kernel_resources(), **ct.kernel_resources()}

    # ---- the preflight frame through K3<4>, K5<4> and K3-profile<4>
    with open(EXPECTED) as f:
        expected = json.load(f)["mean_rgb_ktf"]
    cfg = RenderConfig(**PREFLIGHT)
    cam = showcase_camera(cfg)
    img4 = render_image_fused(scene4, cam, cfg, 0)
    img8 = render_image_fused(scene8, cam, cfg, 0)
    img_p, plain_ms_k3 = plain_ms_of(lambda: render_image_fused(scene4, cam, cfg, 0, plain=True))
    mean4 = img4.mean().item()
    rel = abs(mean4 - expected) / expected
    if not (bool(torch.isfinite(img4).all()) and rel <= PREFLIGHT_RTOL):
        raise AssertionError(f"preflight mean at width 4 {mean4} vs {expected}: rel {rel}")
    if not torch.equal(img4, img_p):
        raise AssertionError("K3<4> vs plain on the preflight frame: not bitwise equal")
    bad8, mean_diff8, max_err8 = image_agreement(img4, img8)
    if not (bad8 <= IMG_BAD_FRAC and mean_diff8 <= MEAN_TOL):
        raise AssertionError(f"preflight K3<4> vs K3<8>: {bad8:.4%} elements beyond tolerance, "
                             f"mean diff {mean_diff8}")
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    k3 = cm.render_tiles_fused(scene4, cam, cfg, 0, px, py, interleave=1)
    k5 = cm.render_tiles_fused(scene4, cam, cfg, 0, px, py, interleave=2)
    rgb, cost, aux, pk1, pit = cm.render_tiles_fused(scene4, cam, cfg, 0, px, py, profile=True,
                                                     lane_counts=True)
    p_rgb, p_cost, p_aux = cm.render_tiles_fused_plain(scene4, cam, cfg, 0, px, py, profile=True)
    checks = {"K5 == K3": torch.equal(k5, k3), "profile rgb == K3": torch.equal(rgb, k3),
              "profile cost == plain": torch.equal(cost, p_cost),
              "profile aux == plain": torch.equal(aux, p_aux),
              "K3 lanes == plain": torch.equal(k3, p_rgb)}
    if not all(checks.values()):
        raise AssertionError(f"width 4 at the preflight size: {checks}")
    ms_k3 = cuda_ms(lambda: cm.render_tiles_fused(scene4, cam, cfg, 0, px, py, interleave=1), 20)
    ms_k5 = cuda_ms(lambda: cm.render_tiles_fused(scene4, cam, cfg, 0, px, py, interleave=2), 20)
    ms_prof = cuda_ms(lambda: cm.render_tiles_fused(scene4, cam, cfg, 0, px, py, profile=True), 20)
    ms_k3_8 = cuda_ms(lambda: cm.render_tiles_fused(scene8, cam, cfg, 0, px, py, interleave=1), 20)
    bound_pre = path_bound(b4, px.shape[0], cfg.spp, int(pk1.sum()), int(pit.sum()))

    # ---- 2K spp8 mb20 on the blocked grid: width 4 against width 8
    cfg = RenderConfig(**MAIN)
    cam = showcase_camera(cfg)
    bx, by, _ = (t.to(dev) for t in blocked_pixel_grid(cfg, 32, 32, 8, 16))
    f4 = cm.render_tiles_fused(scene4, cam, cfg, 0, bx, by)
    f8 = cm.render_tiles_fused(scene8, cam, cfg, 0, bx, by)
    if not torch.equal(cm.render_tiles_fused(scene4, cam, cfg, 0, bx, by, interleave=2), f4):
        raise AssertionError("K5<4> vs K3<4> on the 2K frame: not bitwise equal")
    bad2k, mean_diff2k, max_err2k = image_agreement(f4[None], f8[None])
    if not (bool(torch.isfinite(f4).all()) and bad2k <= IMG_BAD_FRAC
            and mean_diff2k <= MEAN_TOL):
        raise AssertionError(f"2K K3<4> vs K3<8>: {bad2k:.4%} elements beyond tolerance, mean "
                             f"diff {mean_diff2k}")
    t2k = _frames_in_turns({"K3<4>": lambda: cm.render_tiles_fused(scene4, cam, cfg, 0, bx, by),
                            "K3<8>": lambda: cm.render_tiles_fused(scene8, cam, cfg, 0, bx, by),
                            "K3-profile<4>": lambda: cm.render_tiles_fused(
                                scene4, cam, cfg, 0, bx, by, profile=True),
                            "K5<4>": lambda: cm.render_tiles_fused(scene4, cam, cfg, 0, bx, by,
                                                                   interleave=2)},
                           10)
    med = {k: float(np.median(v[0])) for k, v in t2k.items()}
    med_dev = {k: float(np.median(v[1])) for k, v in t2k.items()}
    lanes2k = {}
    for w, sc in ((4, scene4), (8, scene8)):
        _, _, _, k1, it = cm.render_tiles_fused(sc, cam, cfg, 0, bx, by, profile=True,
                                                lane_counts=True)
        wk = k1.reshape(-1, 32).float()
        lanes2k[w] = dict(k1_steps=int(k1.sum()), path_iters=int(it.sum()),
                          k1_mean=wk.mean().item(),
                          divergence=(wk.amax(dim=1) / wk.mean(dim=1).clamp_min(1e-9)).mean().item())
    bound_2k = path_bound(b4, bx.shape[0], cfg.spp, lanes2k[4]["k1_steps"],
                          lanes2k[4]["path_iters"])

    # ---- the CLI on the 4-wide tree, each path with its counts from 0
    os.makedirs(os.path.join(ROOT, "renders"), exist_ok=True)
    size = ["--scene", "cornell_bunny", "--width", "256", "--height", "144", "--spp", "4",
            "--max-bounces", "8"]
    clis = {}
    for name, tag, argv, env in (
            ("fused", "fused", ["--integrator", "fused"], {}),
            ("fused G=2", "fused_g2", ["--integrator", "fused"], {"RAYTRACER_TPU_INTERLEAVE": "2"}),
            ("megakernel", "megakernel", ["--integrator", "megakernel"], {})):
        png = os.path.join("renders", f"chip_smoke_w4_{tag}.png")
        counts, head = _cli_counts(argv + size + ["--out", png],
                                   {"RAYTRACER_TPU_BVH_WIDTH": "4", **env})
        if head != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"CLI {name} on the 4-wide tree wrote no PNG ({head!r})")
        clis[name] = dict(png=png, **counts)
    c = clis["fused"]
    if c["render_fused"] != 1 or c["render_plain"] or c["render_fused_g2"]:
        raise AssertionError(f"CLI fused on the 4-wide tree: counts {c}")
    c = clis["fused G=2"]
    if c["render_fused_g2"] < 1 or c["render_plain"] or c["render_fused"]:
        raise AssertionError(f"CLI fused G=2 on the 4-wide tree: counts {c}")
    c = clis["megakernel"]
    if c["k4"] < 1 or c["k4_sorted"] != c["k4"] or c["k2"] < 1 or c["plain"]:
        raise AssertionError(f"CLI megakernel on the 4-wide tree: counts {c}")

    tree = dict(nodes=int(b4.children.shape[0]), nodes_w8=int(b8.children.shape[0]),
                stack_depth=b4.stack_depth, stack_depth_w8=b8.stack_depth, build_s=build_s)
    rows = {
        "K3/w4": dict(launches=clis["fused"]["render_fused"], max_abs_err=_max_abs(k3, p_rgb),
                      ms=ms_k3, plain_ms=plain_ms_k3, ms_w8_same_lanes=ms_k3_8,
                      **bound_pre, bound_2k_ms=bound_2k["bound_ms"],
                      bound_2k_by=bound_2k["bound_by"], kernel_2k_median_s=med["K3<4>"],
                      kernel_2k_median_s_w8=med["K3<8>"],
                      kernel_2k_median_device_s=med_dev["K3<4>"],
                      kernel_2k_median_device_s_w8=med_dev["K3<8>"],
                      preflight_mean=mean4, lanes_2k=lanes2k,
                      num_regs=res["K3/w4"][0], local_bytes=res["K3/w4"][1],
                      profile_num_regs=res["K3-profile/w4"][0], tree=tree,
                      max_abs_err_is="K3<4> lanes vs plain at the preflight size"),
        "K4/w4": dict(launches=clis["megakernel"]["k4"], max_abs_err=_max_abs(k4["t"], p4["t"]),
                      ms=ms4["K4<4>"], plain_ms=plain_ms_k4, ms_w8=ms4["K4<8>"],
                      **trace_bound(b4, n, int(steps4.sum())), k1_steps=int(steps4.sum()),
                      k1_steps_w8=int(steps8.sum()), id_flips_vs_w8=flips, hits=n_hit,
                      sorted_launches=clis["megakernel"]["k4_sorted"],
                      num_regs=res["K4/w4"][0], local_bytes=res["K4/w4"][1],
                      num_regs_w8=res["K4"][0]),
        "K3-profile/w4": dict(launches=0, max_abs_err=_max_abs(rgb, k3), ms=ms_prof,
                              plain_ms=plain_ms_k3, **bound_pre,
                              bound_2k_ms=bound_2k["bound_ms"], bound_2k_by=bound_2k["bound_by"],
                              kernel_2k_median_s=med["K3-profile<4>"],
                              kernel_2k_median_device_s=med_dev["K3-profile<4>"],
                              num_regs=res["K3-profile/w4"][0],
                              local_bytes=res["K3-profile/w4"][1],
                              launches_are="no path builds a schedule on a 4-wide tree",
                              max_abs_err_is="profile rgb vs K3<4> at the preflight size; cost "
                                             "and aux == plain"),
        "K5/w4": dict(launches=clis["fused G=2"]["render_fused_g2"],
                      max_abs_err=_max_abs(k5, p_rgb), ms=ms_k5, plain_ms=plain_ms_k3,
                      **bound_pre, bound_2k_ms=bound_2k["bound_ms"],
                      bound_2k_by=bound_2k["bound_by"], kernel_2k_median_s=med["K5<4>"],
                      kernel_2k_median_device_s=med_dev["K5<4>"],
                      num_regs=res["K5/w4"][0], local_bytes=res["K5/w4"][1],
                      max_abs_err_is="K5<4> lanes vs plain at the preflight size (== K3<4> there "
                                     "and on the 2K frame)"),
    }
    msg = (f"reference scene built 4-wide in {build_s:.2f} s: {tree['nodes']} nodes (BVH8 "
           f"{tree['nodes_w8']}), stack_depth {tree['stack_depth']} (BVH8 "
           f"{tree['stack_depth_w8']}); K4<4> on {n} rays (phase 4's): == plain bitwise, {n_hit} "
           f"hits, t == K4<8> bitwise, {flips} id flips at equal t (limit 1 in 5000), K4-sort == "
           f"K4; K1 steps {int(steps4.sum())} vs {int(steps8.sum())} at width 8; in turns, median "
           f"of 10 (CUDA events): K4<4> {ms4['K4<4>']:.4f} ms, K4<8> {ms4['K4<8>']:.4f} ms "
           f"(ratio {ms4['K4<4>'] / ms4['K4<8>']:.3f}); plain {plain_ms_k4:.1f} ms; preflight "
           f"128x40 spp2 mb12 through K3<4>: mean {mean4:.6f} vs {expected:.6f} (rel {rel:.2e}), "
           f"== plain bitwise, vs K3<8> {bad8:.4%} elements beyond tolerance (max abs "
           f"{max_err8:.3g}); {checks}; preflight lanes K3<4> {ms_k3:.3f} ms, K5<4> "
           f"{ms_k5:.3f} ms, K3-profile<4> {ms_prof:.3f} ms, K3<8> {ms_k3_8:.3f} ms, plain "
           f"{plain_ms_k3:.1f} ms; 2K spp8 mb20 "
           f"blocked grid in turns, median of 10 (host s / CUDA events s): K3<4> "
           f"{med['K3<4>']:.4f} / {med_dev['K3<4>']:.4f}, K3<8> {med['K3<8>']:.4f} / "
           f"{med_dev['K3<8>']:.4f} (ratio {med['K3<4>'] / med['K3<8>']:.3f}), K3-profile<4> "
           f"{med['K3-profile<4>']:.4f} / {med_dev['K3-profile<4>']:.4f}, K5<4> "
           f"{med['K5<4>']:.4f} / {med_dev['K5<4>']:.4f} (== K3<4> bitwise); K3<4> host s "
           f"{_fmt(t2k['K3<4>'][0])}; K3<8> host s {_fmt(t2k['K3<8>'][0])}; 2K frames K3<4> vs "
           f"K3<8>: {bad2k:.4%} elements beyond tolerance, mean diff {mean_diff2k:.2e}; 2K lane "
           f"counts (K1 steps, path iterations, K1 mean, warp divergence): "
           + "; ".join(f"width {w} {v['k1_steps']}, {v['path_iters']}, {v['k1_mean']:.2f}, "
                       f"{v['divergence']:.4f}" for w, v in lanes2k.items())
           + f"; bounds: preflight {bound_pre['bound_ms']:.5f} ms ({bound_pre['bound_by']}), 2K "
           f"{bound_2k['bound_ms']:.4f} ms ({bound_2k['bound_by']}); numRegs / localSizeBytes: "
           + ", ".join(f"{k} {r} / {b}" for k, (r, b) in res.items())
           + "; CLI with RAYTRACER_TPU_BVH_WIDTH=4: "
           + "; ".join(f"{k} wrote {v['png']}, counts {dict((c, n) for c, n in v.items() if c != 'png')}"
                       for k, v in clis.items())
           + f" on {smi}")
    return dict(rows=rows, msg=msg)


class _ParentLib:
    """The parent commit's kernel library behind this tree's wrappers: its
    K3, K3-profile, K5, K4, key kernel and K2 take this tree's signatures.
    Translate here any signature a later tree changes."""

    def __init__(self, path):
        import ctypes

        from raytracer_tpu_torch.utils import cudalib

        L = ctypes.CDLL(path)
        vp, ci, cf, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        pv, ip = ctypes.POINTER(cudalib.BvhView), ctypes.POINTER(ctypes.c_int)
        fused = [ctypes.POINTER(cudalib.FusedParams), pv] + [vp] * 7 + [ci]
        L.rt_render_fused.argtypes = fused + [vp, ci, ci, vp, vp]
        L.rt_render_fused_g2.argtypes = fused + [vp, ci, ci, vp, vp]
        L.rt_render_fused_profile.argtypes = fused + [vp] * 5 + [ci, ci, vp, vp]
        L.rt_render_fused_attrs.argtypes = [ci, ci, ip, ip]
        L.rt_render_fused_g2_attrs.argtypes = [ci, ip, ip]
        L.rt_trace_closest.argtypes = [pv, vp, vp, vp, cf, cf, ci, vp, vp, vp, vp, vp, vp, ci, vp]
        L.rt_coherence_keys.argtypes = [vp, vp, vp, ci, vp, vp]
        L.rt_trace_closest_attrs.argtypes = [ci, ip, ip]
        L.rt_ktf_threefry.argtypes = [cu, cu, vp, vp, ci, vp, vp, ci, vp]
        L.rt_ktf_threefry_keyed.argtypes = [vp, vp, vp, vp, ci, vp, vp, ci, vp]
        L.rt_error_string.argtypes = [ci]
        L.rt_error_string.restype = ctypes.c_char_p
        self.L = L
        for name in ("rt_render_fused", "rt_render_fused_g2", "rt_render_fused_profile",
                     "rt_render_fused_attrs", "rt_render_fused_g2_attrs", "rt_trace_closest",
                     "rt_coherence_keys",
                     "rt_trace_closest_attrs", "rt_ktf_threefry", "rt_ktf_threefry_keyed"):
            getattr(L, name).restype = ci
            setattr(self, name, getattr(L, name))
        self.rt_error_string = L.rt_error_string


def _load_module(path: str, name: str):
    """The module at `path` under its own name `name` (so a parent tree's
    file loads beside this tree's module of the same package path)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def cudalib_as(mod):
    """raytracer_tpu_torch.utils.cudalib is `mod` inside: a wrapper that
    imports it then, at module level or inside a function, gets `mod`."""
    import raytracer_tpu_torch.utils as utils

    mine = utils.cudalib
    utils.cudalib = mod
    try:
        yield
    finally:
        utils.cudalib = mine


def parent_launch_path(parent_dir: str, build_dir: str):
    """The parent tree's own launch path: its utils/cudalib.py (its library
    the one phase 15 built from its csrc into build_dir), and its
    probes/mosaic.py, probes/bitcast.py, probes/feature.py, probes/ablate_v8.py,
    probes/v5_body.py, probes/morph.py, probes/interleave_probe.py,
    probes/scalar_cost.py, probes/vstack.py, probes/v6.py, probes/ktf_probe.py
    and utils/ktf.py bound to that cudalib. (parent cudalib, {"mosaic": ..,
    "bitcast": .., "feature": .., "ablate_v8": .., "v5_body": .., "morph": ..,
    "interleave_probe": .., "scalar_cost": .., "vstack": .., "v6": ..,
    "ktf_probe": .., "ktf": ..})."""
    pkg = os.path.join(parent_dir, "raytracer_tpu_torch")
    pc = _load_module(os.path.join(pkg, "utils", "cudalib.py"), "parent_cudalib")
    pc.BUILD_DIR = build_dir
    with cudalib_as(pc):
        mods = {name: _load_module(os.path.join(pkg, *rel), f"parent_{name}") for name, rel in (
            ("mosaic", ("probes", "mosaic.py")), ("bitcast", ("probes", "bitcast.py")),
            ("feature", ("probes", "feature.py")),
            ("ablate_v8", ("probes", "ablate_v8.py")), ("v5_body", ("probes", "v5_body.py")),
            ("morph", ("probes", "morph.py")),
            ("interleave_probe", ("probes", "interleave_probe.py")),
            ("scalar_cost", ("probes", "scalar_cost.py")), ("vstack", ("probes", "vstack.py")),
            ("v6", ("probes", "v6.py")), ("ktf_probe", ("probes", "ktf_probe.py")),
            ("ktf", ("utils", "ktf.py")))}
    return pc, mods


def probes_old_new(dev, pmods) -> dict:
    """The parent's P-v8, v5 body, P-morph, P-interleave, P-scalar (every
    variant and the smem16 pre-pass), P-vstack (every case) and P-v6 (its
    wrappers, its cudalib, its kernels) against this tree's on the same
    inputs, at the scripts' iterations and packets and, for the chain
    probes, at P13_FILL_PACKETS: outputs equal bit for bit
    (P-morph's loop counts too, P-v6's six outputs), each per call
    (time_launches' median) in P13_TURN_PAIRS alternating pairs of rounds,
    with the W this tree picks."""
    import torch

    from raytracer_tpu_torch.probes import (ablate_v8, common, interleave_probe, morph,
                                            scalar_cost, v5_body, v6, vstack)

    checks, out = {}, {}
    per_call = lambda f: lambda: common.median(common.time_launches(f))   # noqa: E731

    def in_turns(name, fns, w):
        old, new = fns["parent"](), fns["new"]()
        old, new = (old, new) if isinstance(old, tuple) else ((old,), (new,))
        checks[f"{name} new == parent"] = len(old) == len(new) and all(
            (a is None and b is None) or (a is not None and b is not None and a.dtype == b.dtype
                                          and a.shape == b.shape and _bitwise(a, b))
            for a, b in zip(old, new))
        t = alternate({k: per_call(f) for k, f in fns.items()})
        out[name] = {"w": w, **{k: dict(ms=float(np.median(v)), turns_ms=v)
                                for k, v in t.items()}}

    for packets in (ablate_v8.N_PACKETS, P13_FILL_PACKETS):
        ins = tuple(torch.from_numpy(a).to(dev) for a in ablate_v8.make_inputs(packets))
        for v in ablate_v8.VARIANTS:
            in_turns(f"v8 {v} P{packets}",
                     {who: (lambda m=m, v=v: m.ablate_v8(*ins, v, ablate_v8.ITERS))
                      for who, m in (("parent", pmods["ablate_v8"]), ("new", ablate_v8))},
                     ablate_v8.chosen_w(packets, v))
    node, tri, zero_row = v5_body.reference_tables()
    for packets in (v5_body.N_PACKETS, P13_FILL_PACKETS):
        args = tuple(t.to(dev) for t in (node, tri, *(torch.from_numpy(a)
                                                      for a in v5_body.make_rays(packets))))
        for mode in v5_body.MODES:
            in_turns(f"v5 {mode} P{packets}",
                     {who: (lambda m=m, mode=mode: m.v5(*args, zero_row, mode, v5_body.ITERS))
                      for who, m in (("parent", pmods["v5_body"]), ("new", v5_body))},
                     v5_body.chosen_w(packets, mode))
    for packets in (interleave_probe.N_PACKETS, P13_FILL_PACKETS):
        args = tuple(t.to(dev) for t in (node, tri, *(torch.from_numpy(a)
                                                      for a in v5_body.make_rays(packets))))
        for G in interleave_probe.GS:
            in_turns(f"interleave G={G} P{packets}",
                     {who: (lambda m=m, G=G: m.interleave(*args, zero_row, G,
                                                          interleave_probe.ITERS))
                      for who, m in (("parent", pmods["interleave_probe"]),
                                     ("new", interleave_probe))},
                     interleave_probe.chosen_w(G))
    for packets in (morph.N_PACKETS, P13_FILL_PACKETS):
        mnode, mtri, nb, cap, *rays = morph.reference_inputs(packets)
        margs = tuple(t.to(dev) for t in (mnode, mtri, *rays))
        for v in morph.VARIANTS:
            in_turns(f"morph {v} P{packets}",
                     {who: (lambda m=m, v=v: m.morph(*margs, nb, cap, v))
                      for who, m in (("parent", pmods["morph"]), ("new", morph))},
                     morph.chosen_w(packets, v))
    sc_n, sc_i = scalar_cost.N_PACKETS, scalar_cost.ITERS
    in_turns(f"scalar tables pre-pass P{sc_n} i{sc_i}",
             {who: (lambda m=m: m.smem16_tables(sc_n, sc_i, dev))
              for who, m in (("parent", pmods["scalar_cost"]), ("new", scalar_cost))}, None)
    x = torch.from_numpy(scalar_cost.make_input()).to(dev)
    tables = scalar_cost.smem16_tables(sc_n, sc_i, dev)
    for name in scalar_cost.VARIANTS:
        mode, iters = scalar_cost.variant(name)
        tab = tables if mode == "smem16" else None
        in_turns(f"scalar {name}",
                 {who: (lambda m=m, mode=mode, iters=iters, tab=tab: m.scalar_cost(x, mode, iters,
                                                                                   tab))
                  for who, m in (("parent", pmods["scalar_cost"]), ("new", scalar_cost))},
                 scalar_cost.chosen_w(mode))
    for case in vstack.CASES:
        iters = vstack.CHECK_ITERS if case in vstack.RECORD else vstack.TIMING_ITERS
        in_turns(f"vstack {case} i{iters}",
                 {who: (lambda m=m, case=case, iters=iters: m.vstack(case, iters, dev))
                  for who, m in (("parent", pmods["vstack"]), ("new", vstack))}, None)
    _, vnode, vtri, vnb, vcap, *vrays = v6.reference_inputs(v6.N_PACKETS)
    for packets in (v6.N_PACKETS, P13_FILL_PACKETS):
        rays = vrays if packets == v6.N_PACKETS else (
            torch.from_numpy(a) for a in v5_body.make_rays(packets, seed=0))
        vargs = tuple(t.to(dev) for t in (vnode, vtri, *rays))
        in_turns(f"v6 P{packets}",
                 {who: (lambda m=m, vargs=vargs: m.v6(*vargs, vnb, vcap))
                  for who, m in (("parent", pmods["v6"]), ("new", v6))}, v6.chosen_w(packets))
    return dict(checks=checks, ms=out)


def _at(w) -> str:
    """" W<w>" for a chain width, "" for none."""
    return "" if w is None else f" W{w}"


def sass_old_new(parent_lib: str) -> dict:
    """Static SASS instructions of the parent's P-interleave and P-morph
    kernels (one per G or variant) and of this tree's (one per G or
    variant and W), by name (probes/sass.name); {} without cuobjdump."""
    from raytracer_tpu_torch.probes import sass

    if not os.path.exists(sass.cuobjdump()):
        return {}
    def pick(counts):
        return {sass.name(*k): v["total"] for k, v in sorted(counts.items(), key=str)
                if k[0] in ("interleave", "morph")}

    return dict(parent=pick(sass.counts(parent_lib)), new=pick(sass.counts()))


def tiles_old_new(dev, pc, pmods) -> dict:
    """The parent's P-mosaic, P-bitcast (on the reference scene's v5
    tables), P-feature and P-ktf (its wrappers, its
    cudalib, its kernels) against this tree's on the same inputs: outputs
    equal bit for bit (mosaic lanesum, which sums in another order since the redesign:
    both pass the script's check, the largest difference kept), each case
    per call in alternating pairs (time_launches' event
    pairs) and per launch in a CUDA graph; and K2's Threefry through the
    parent's wrapper (its stream_handle) against this tree's at phase 3's
    2^20 counters, cuda_ms of 50 calls per turn, in alternating pairs."""
    import torch

    from raytracer_tpu_torch.probes import bitcast, common, feature, ktf_probe, mosaic
    from raytracer_tpu_torch.utils import ktf

    checks, out = {}, {}
    per_call = lambda f: lambda: common.median(common.time_launches(f))   # noqa: E731
    tabs = bitcast.reference_tables()
    for probe, mod, call in (("mosaic", mosaic, "probe_mosaic"),
                             ("bitcast", bitcast, "probe_bitcast"),
                             ("feature", feature, "probe_feature"),
                             ("ktf", ktf_probe, "probe_ktf")):
        pmod = pmods["ktf_probe" if probe == "ktf" else probe]
        for case in mod.CASES:
            ins = bitcast.case_input(case, tabs, dev) if probe == "bitcast" else tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in mod.inputs(case))
            fns = {who: (lambda f=getattr(m, call), c=case, i=ins: f(c, *i))
                   for who, m in (("parent", pmod), ("new", mod))}
            old, new = (fns[k]() for k in ("parent", "new"))
            old, new = ((old,), (new,)) if probe == "mosaic" else (old, new)
            row = {}
            if (probe, case) == ("mosaic", "lanesum"):
                # The new kernel sums a row in another order (each thread's
                # adjacent lanes): both trees pass the script's check.
                row["max_abs_diff"] = _max_abs(old[0], new[0])
                checks["mosaic lanesum: parent and new pass the script's check"] = all(
                    mosaic.check(case, o.cpu().numpy())[0] for o in (old[0], new[0]))
            else:
                checks[f"{probe} {case} new == parent"] = len(old) == len(new) and all(
                    a.dtype == b.dtype and _bitwise(a, b) for a, b in zip(old, new))
            t = alternate({k: per_call(f) for k, f in fns.items()})
            out[f"{probe} {case}"] = {**row, **{k: dict(ms=float(np.median(v)), turns_ms=v,
                                                        graph_ms=graph_ms(fns[k]))
                                                 for k, v in t.items()}}
    gen = np.random.default_rng(3)
    c0, c1 = (torch.from_numpy(gen.integers(-2**31, 2**31, 1 << 20).astype(np.int32)).to(dev)
              for _ in range(2))
    k0, k1 = ktf.key_words(0)
    new_k2 = lambda: ktf.threefry2x32_kernel(k0, k1, c0, c1)   # noqa: E731
    old_k2 = lambda: pmods["ktf"].threefry2x32_kernel(k0, k1, c0, c1)   # noqa: E731
    with cudalib_as(pc):
        old = old_k2()
    checks["K2 threefry through the wrapper new == parent"] = all(
        torch.equal(a, b) for a, b in zip(old, new_k2()))

    def old_ms():
        with cudalib_as(pc):
            return cuda_ms(old_k2, 50)

    t = alternate({"parent": old_ms, "new": lambda: cuda_ms(new_k2, 50)})
    out["K2 threefry wrapper 2^20"] = {k: dict(ms=float(np.median(v)), turns_ms=v)
                                       for k, v in t.items()}
    return dict(checks=checks, ms=out)


def _draw_fields(out) -> dict:
    """A draw site's numbers by name, from the draw kernels' dict or the
    chain's tuples (chain_draw_sites: camera (lens, jitter), bounce (rr or
    None, scatter, dielectric)); the jax family's lane keys left out."""
    if isinstance(out, dict):
        return {k: v for k, v in out.items() if k != "keys"}
    if len(out) == 2:
        (lx, ly), (ju, jv) = out
        return dict(lens_x=lx, lens_y=ly, jitter_u=ju, jitter_v=jv)
    rr, scatter, dielectric = out
    return dict(scatter=scatter, dielectric=dielectric, **({} if rr is None else {"rr": rr}))


P15_CHUNKS = (16, 512)   # K3's lanes per take, beside the default
P15_TURNS = 3            # each tree's own phase 10, in alternation


def _phase10_s_per_step(tree: str) -> dict:
    """`chip_smoke.py --phases 10` of the tree at `tree` in a process of
    its own: its train line's s/step (median of steps 2-3) and step times."""
    out = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "10"], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"phase 10 of {tree} failed ({out.returncode}): "
                             f"{out.stdout[-1500:]} {out.stderr[-1500:]}")
    train = next(json.loads(ln)["train"] for ln in out.stdout.splitlines()
                 if ln.startswith('{"train"'))
    return dict(s_per_step=train["s_per_step"], step_s=train["step_s"], losses=train["losses"])


def phase15(scene, dev, smi, parent_dir):
    """Old against new on one card: the parent commit's K3, K3-profile, K5
    and K4 (built from parent_dir's raytracer_tpu_torch/csrc) against this
    tree's, bitwise and in turns, median of 10, with K3's chunk sizes; the
    parent's K4 route against this tree's at 262,144 and 1,048,576 rays;
    the parent's draws (the per-method chain through its K2) against the
    draw kernels; and each tree's own phase 10 in alternation."""
    import torch

    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import cuda_megakernel as cm
    from raytracer_tpu_torch.ops import cuda_traverse as ct
    from raytracer_tpu_torch.ops.bvh4 import BIG
    from raytracer_tpu_torch.schedule import blocked_pixel_grid
    from raytracer_tpu_torch.utils import cudalib

    default = cudalib.lib()
    t0 = time.perf_counter()
    parent_dir = os.path.abspath(parent_dir)
    build_dir = os.path.join(ROOT, "renders", "phase15_build")
    parent = _ParentLib(cudalib.build(csrc=os.path.join(parent_dir, "raytracer_tpu_torch", "csrc"),
                                      build_dir=build_dir))
    libs = {"parent": parent, "new": default}
    build_s = time.perf_counter() - t0

    def on(name, fn):
        def run():
            cudalib._LIB = libs[name]
            try:
                return fn()
            finally:
                cudalib._LIB = default
        return run

    cfg = RenderConfig(**MAIN)
    cam = showcase_camera(cfg)
    bx, by, _ = (t.to(dev) for t in blocked_pixel_grid(cfg, 32, 32, 8, 16))
    k3 = {k: on(k, lambda: cm.render_tiles_fused(scene, cam, cfg, 0, bx, by, interleave=1))
          for k in libs}
    out = {k: f() for k, f in k3.items()}
    prof = {k: on(k, lambda: cm.render_tiles_fused(scene, cam, cfg, 0, bx, by, profile=True))()
            for k in libs}
    k5 = {k: on(k, lambda: cm.render_tiles_fused(scene, cam, cfg, 0, bx, by, interleave=2))()
          for k in libs}
    checks = {"K3 new == parent": torch.equal(out["new"], out["parent"])}
    checks["K3-profile new == parent (rgb, cost, aux)"] = all(
        torch.equal(a, b) for a, b in zip(prof["new"], prof["parent"]))
    checks["K5 new == parent"] = torch.equal(k5["new"], k5["parent"])
    checks.update({f"K3 chunk {c} == parent": torch.equal(cm.render_tiles_fused(
        scene, cam, cfg, 0, bx, by, chunk=c), out["parent"]) for c in P15_CHUNKS})
    tscene, t_min, waves = training_wavefronts(dev)
    o1, d1, cap1 = waves[P8_TRAIN_BOUNCES[0]]
    rays = {"phase 4": (*phase4_rays(scene, dev), scene.bvh4, float(BIG), 1e-3),
            "phase 8": (*bounce_rays(scene, dev), scene.bvh4, float(BIG), 1e-3),
            "training": (o1, d1, tscene.bvh4, cap1, t_min)}
    turns = {}
    for rname, (o, d, bvh, lim, tm) in rays.items():
        recs = {k: on(k, lambda: ct.trace_closest(o, d, bvh, lim, tm, sort=False))()
                for k in libs}
        checks[f"K4 on {rname} rays new == parent"] = not _equal_records(recs["new"],
                                                                         recs["parent"])
        if rname == "phase 4":
            continue
        routes = {f"{k} {s}": on(k, lambda o=o, d=d, b=bvh, lim=lim, tm=tm, s=s:
                                 ct.trace_closest(o, d, b, lim, tm, sort=s == "sorted"))
                  for k in libs for s in ("unsorted", "sorted")}
        got = {k: f() for k, f in routes.items()}
        routes.update({f"{k} K4 alone": on(k, lambda o=o, d=d, b=bvh, lim=lim, tm=tm:
                                           k4_alone(o, d, b, lim, t_min=tm))() for k in libs})
        checks[f"K4 route on {rname} rays: new sorted == new unsorted == parent's route"] = not (
            _equal_records(got["new sorted"], got["parent sorted"])
            or _equal_records(got["new unsorted"], got["parent unsorted"])
            or _equal_records(got["new sorted"], got["new unsorted"]))
        turns.update({f"K4 route {rname} {k}": f for k, f in routes.items()})
    # The draws: the parent's route (the per-method chain through its K2)
    # against the draw kernels on the training path's sites, bit for bit
    # and in turns.
    chain, new = chain_draw_sites(dev), new_draw_sites(dev)
    draw_sites = ("camera", "bounce 0", f"bounce {RenderConfig(**P10).min_bounces}")
    for site in draw_sites:
        old_f, new_f = _draw_fields(on("parent", chain[site])()), _draw_fields(new[site]())
        checks[f"draws {site}: new == parent"] = (old_f.keys() == new_f.keys() and all(
            _bitwise(old_f[k], new_f[k]) for k in old_f))
        turns.update({f"draws {site} parent": on("parent", chain[site]),
                      f"draws {site} new": new[site]})
    pc, pmods = parent_launch_path(parent_dir, build_dir)
    tiles = tiles_old_new(dev, pc, pmods)
    checks.update(tiles["checks"])
    probes = probes_old_new(dev, pmods)
    checks.update(probes["checks"])
    sass_pn = sass_old_new(cudalib.build(
        csrc=os.path.join(parent_dir, "raytracer_tpu_torch", "csrc"), build_dir=build_dir))
    if not all(checks.values()):
        raise AssertionError(f"phase 15: {checks}")
    res = {}
    for k in libs:
        cudalib._LIB = libs[k]
        try:
            res[k] = {**cm.kernel_resources(), **ct.kernel_resources()}
        finally:
            cudalib._LIB = default
    res = {k: {n: v[n] for n in ("K3", "K3-profile", "K5", "K4")} for k, v in res.items()}
    torch.cuda.synchronize()
    ms = {k: dict(zip(("median_ms", "min_ms", "max_ms"), v))
          for k, v in _ms_in_turns(turns, 20).items()}
    frames = {"K3 2K " + k: f for k, f in k3.items()}
    frames.update({"K3-profile 2K parent": on("parent", lambda: cm.render_tiles_fused(
        scene, cam, cfg, 0, bx, by, profile=True)),
        "K3-profile 2K new": lambda: cm.render_tiles_fused(scene, cam, cfg, 0, bx, by,
                                                           profile=True),
        "K5 2K parent": on("parent", lambda: cm.render_tiles_fused(
            scene, cam, cfg, 0, bx, by, interleave=2)),
        "K5 2K new": lambda: cm.render_tiles_fused(scene, cam, cfg, 0, bx, by, interleave=2)})
    for c in P15_CHUNKS:
        frames[f"K3 2K new, chunk {c}"] = lambda c=c: cm.render_tiles_fused(
            scene, cam, cfg, 0, bx, by, chunk=c)
    ms.update({k: dict(median_ms=float(np.median(v[1])) * 1e3, min_ms=float(np.min(v[1])) * 1e3,
                       max_ms=float(np.max(v[1])) * 1e3)
               for k, v in _frames_in_turns(frames, 10).items()})
    k3p, k3n = ms["K3 2K parent"], ms["K3 2K new"]
    checks["K3 2K new within the parent's spread"] = (k3p["min_ms"] <= k3n["median_ms"]
                                                     <= k3p["max_ms"])
    # Each tree's own training phase in turns: parent, new, new, parent, ...
    steps = {"parent": [], "new": []}
    for t in range(P15_TURNS * 2):
        name = ("parent", "new")[(t + t // 2) % 2]
        steps[name].append(_phase10_s_per_step(parent_dir if name == "parent" else ROOT))
    s_step = {k: dict(median_s_per_step=float(np.median([r["s_per_step"] for r in v])),
                      runs=v) for k, v in steps.items()}
    msg = (f"parent's build in {build_s:.1f} s; {checks}; the parent's launch path and "
           f"kernels against this tree's, per call in {P13_TURN_PAIRS} alternating pairs of rounds "
           f"(median; K2: cuda_ms of 50 per turn) and per launch in a CUDA graph of "
           f"{P13_GRAPH_LAUNCHES}: " + "; ".join(
               f"{k} " + ", ".join(f"{w} {v['ms']:.5f} ms [{_fmt(v['turns_ms'])}]"
                                   + (f" graph {v['graph_ms']:.5f}" if "graph_ms" in v else "")
                                   for w, v in r.items() if w in ("parent", "new"))
               + (f" (max |diff| {r['max_abs_diff']:.3g})" if "max_abs_diff" in r else "")
               for k, r in tiles["ms"].items())
           + "; P-v8, the v5 body, P-interleave, P-morph, P-scalar (and its pre-pass) and "
           + "P-vstack, the parent's against this tree's (picked W) per call in "
           + f"{P13_TURN_PAIRS} alternating pairs of rounds (median; new / parent): " + "; ".join(
               f"{k}{_at(r['w'])} {r['parent']['ms']:.4f} -> {r['new']['ms']:.4f} ms "
               f"({r['new']['ms'] / r['parent']['ms']:.3f}x; new [{_fmt(r['new']['turns_ms'])}], "
               f"parent [{_fmt(r['parent']['turns_ms'])}])" for k, r in probes["ms"].items())
           + "; static SASS instructions of P-interleave and P-morph, the parent's: "
           + (", ".join(f"{k} {v}" for k, v in sass_pn["parent"].items()) + "; this tree's: "
              + ", ".join(f"{k} {v}" for k, v in sass_pn["new"].items()) if sass_pn
              else "not measured (no cuobjdump)")
           + "; in turns, median of 10 (CUDA events; K4 routes per call of 20; min-max): "
           + "; ".join(f"{k} {v['median_ms']:.4f} ms ({v['min_ms']:.4f}-{v['max_ms']:.4f})"
                       for k, v in ms.items())
           + "; numRegs / localSizeBytes: "
           + "; ".join(f"{k}: " + ", ".join(f"{n} {r} / {b}" for n, (r, b) in v.items())
                       for k, v in res.items())
           + "; each tree's phase 10 in alternation, s/step (median of steps 2-3) per run: "
           + "; ".join(f"{k} {[r['s_per_step'] for r in v['runs']]} (median "
                       f"{v['median_s_per_step']:.4f})" for k, v in s_step.items())
           + f" on {smi}")
    if not checks["K3 2K new within the parent's spread"]:
        log(15, msg)
        raise AssertionError(f"phase 15: K3 at 2K {k3n} outside the parent's {k3p}")
    return dict(json=dict(card=smi, checks=checks, ms=ms, resources=res, build_s=build_s,
                          phase10=s_step, tiles=tiles["ms"], probes=probes["ms"],
                          probes_sass=sass_pn), msg=msg)


def _counts():
    """Launch and plain-call counters of the differentiable path's kernels:
    k2 is the K2 route's launches, Threefry blocks (k2_threefry) and the
    camera and bounce draw kernels (k2_camera, k2_bounce) together."""
    from raytracer_tpu_torch.ops import cuda_traverse
    from raytracer_tpu_torch.utils import ktf

    return {"k4": cuda_traverse.LAUNCHES["trace_closest"],
            "k4_sorted": cuda_traverse.LAUNCHES["trace_closest_sorted"],
            "keys": cuda_traverse.LAUNCHES["coherence_keys"],
            "k2": sum(ktf.LAUNCHES.values()),
            "k2_threefry": ktf.LAUNCHES["threefry2x32"],
            "k2_camera": ktf.LAUNCHES["camera_draws"],
            "k2_bounce": ktf.LAUNCHES["bounce_draws"],
            "plain": cuda_traverse.PLAIN_CALLS["traverse_plain"]
            + ktf.PLAIN_CALLS["threefry2x32"]}


def _reset_counts():
    from raytracer_tpu_torch.ops import cuda_traverse
    from raytracer_tpu_torch.utils import ktf

    for d in (cuda_traverse.LAUNCHES, cuda_traverse.PLAIN_CALLS, ktf.LAUNCHES, ktf.PLAIN_CALLS):
        for k in d:
            d[k] = 0


def bounce_rays(scene, dev):
    """Phase 8's rays: the second-bounce wavefront of a 512x512 spp1
    megakernel frame (showcase camera), 262,144 rays."""
    import torch

    from raytracer_tpu_torch.camera import generate_rays, showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models import megakernel
    from raytracer_tpu_torch.render import pixel_grid
    from raytracer_tpu_torch.utils import ktf

    cfg = RenderConfig(**P8, rng_impl="ktf")
    cam = showcase_camera(cfg)
    px, py = pixel_grid(cfg, dev)
    smp = ktf.sampler(0, py * cfg.width + px)
    with torch.no_grad():
        o, d = generate_rays(cam, px, py, cfg.width, cfg.height, smp)
        state = megakernel.bounce_step(scene, cfg, 0, smp, megakernel.initial_state(o, d))
    return state[0].contiguous(), state[1].contiguous()


class _Captured(Exception):
    """Ends training_wavefronts' forward pass once its wavefronts are in."""


def training_wavefronts(dev):
    """The wavefronts that ops/intersect.intersect_bvh4 receives on the
    training path: INVERSE_r05 (inverse_setup at P10 with P10_PAIRS pairs),
    its first chunk of P10_CHUNK pairs, the first trace (samples_per_trace
    samples of every pixel: 8 x 128 x 128 x 8 = 1,048,576 rays), one
    no-grad forward, at the bounces P8_TRAIN_BOUNCES. The call is wrapped
    here, not in the package. Returns (scene, t_min, {bounce: (o, d,
    t_cap)})."""
    import torch

    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.ops import intersect as isect
    from raytracer_tpu_torch.render import pixel_grid

    scene, cfg, cam, keys, targets, params = inverse_setup(dev, P10, P10_PAIRS)
    px, py = pixel_grid(cfg, dev)
    k, real, calls, got = P10_CHUNK, isect.intersect_bvh4, [], {}

    def record(o, d, bvh, t_min, t_max, sort=True):
        bounce = len(calls)
        calls.append(bounce)
        if bounce in P8_TRAIN_BOUNCES:
            got[bounce] = (o.clone(), d.clone(), t_max.clone())
            if bounce == max(P8_TRAIN_BOUNCES):
                raise _Captured
        return real(o, d, bvh, t_min, t_max, sort=sort)

    isect.intersect_bvh4 = record
    try:
        with torch.no_grad():
            inverse.pairs_loss(scene, cam, cfg, params, (keys[0][:k], keys[1][:k]),
                               targets[:k].reshape(k, -1, 3), px, py)
    except _Captured:
        pass
    finally:
        isect.intersect_bvh4 = real
    return scene, cfg.t_min, got


def kernels_launched(fn, tries: int = 3) -> dict:
    """What one call of fn (after a warm-up call) puts on the card, from a
    torch.profiler trace: kernels (by name), memsets and copies, the card's
    busy microseconds, the span from the first start to the last end, and
    the idle microseconds between them (host dispatch, when the card waits
    for it), and the busy microseconds of each name. A trace that holds no
    device activity is taken again, up to `tries` times in all (empty if
    none holds any). The program's spans (`rt.*`, utils/profiling) sit on
    the card's timeline too, as user annotations: they are no device
    activity and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        acts = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not (getattr(e, "is_user_annotation", False)
                                or e.name.startswith("rt."))),
                      key=lambda e: e.time_range.start)
        if acts:
            break
    else:
        return {}
    names: dict = {}
    busy_by_name: dict = {}
    for e in acts:
        names[e.name] = names.get(e.name, 0) + 1
        busy_by_name[e.name] = busy_by_name.get(e.name, 0) + e.time_range.end - e.time_range.start
    kernels = [e for e in acts if not e.name.startswith(("Memset", "Memcpy"))]
    busy = sum(e.time_range.end - e.time_range.start for e in acts)
    span = max(e.time_range.end for e in acts) - acts[0].time_range.start
    return dict(kernels=len(kernels), activities=len(acts), names=names, busy_us=busy,
                span_us=span, idle_us=span - busy, busy_by_name=busy_by_name)


def _ms_in_turns(fns: dict, reps: int, turns: int = 10) -> dict:
    """Each fn of `fns` (name -> fn) run `reps` times per turn, in
    alternating turns: {name: (median, min, max) device ms per call}."""
    times = _frames_in_turns({k: (lambda f=f: [f() for _ in range(reps)])
                              for k, f in fns.items()}, turns)
    return {k: tuple(float(g(v[1])) * 1e3 / reps for g in (np.median, np.min, np.max))
            for k, v in times.items()}


def k4_alone(o, d, bvh, t_lim, perm=None, t_min: float = 1e-3):
    """fn launching K4 alone through its ctypes entry point: the tree's
    view, the limit and the full record's outputs made once. t_lim is a
    float (the scalar limit) or f32[N] on the card."""
    import torch

    from raytracer_tpu_torch.ops import cuda_traverse as ct
    from raytracer_tpu_torch.utils import cudalib

    n, view = o.shape[0], ct._view(bvh)
    rec = [torch.empty((n, 3) if k == "normal" else (n,), dtype=ct._DTYPES[k], device=o.device)
           for k in ct.RECORD]
    per_ray = torch.is_tensor(t_lim)
    args = (view, o.data_ptr(), d.data_ptr(), t_lim.data_ptr() if per_ray else None,
            0.0 if per_ray else float(t_lim), t_min, n, None if perm is None else perm.data_ptr(),
            *(r.data_ptr() for r in rec), ct.KERNEL_BLOCK, cudalib.stream_handle())
    fn = cudalib.lib().rt_trace_closest
    cudalib.check(fn(*args), "K4 alone")
    return lambda: (fn(*args), rec)   # rec stays alive as long as the fn


def keys_alone(o, d, bvh):
    """fn launching the key kernel alone (keys made once)."""
    import torch

    from raytracer_tpu_torch.utils import cudalib

    keys = torch.empty((o.shape[0],), dtype=torch.int32, device=o.device)
    args = (o.data_ptr(), d.data_ptr(), bvh.sort_box.data_ptr(), o.shape[0], keys.data_ptr(),
            cudalib.stream_handle())
    fn = cudalib.lib().rt_coherence_keys
    return lambda: (fn(*args), keys)   # keys stays alive as long as the fn


def _equal_records(a: dict, b: dict) -> list:
    """The fields of record a that differ from b's, bit for bit."""
    import torch

    return [k for k in a if not (_bitwise(a[k], b[k]) if a[k].is_floating_point()
                                 else torch.equal(a[k], b[k]))]


def phase8_set(name, o, d, bvh, t_lim, t_min, subset_seed):
    """K4 and K4-sort on one wavefront (t_lim a float or f32[N]): sorted ==
    unsorted == plain bit for bit (plain on a seeded subset of P8_SUBSET
    rays, also through the sort's permutation and a random one), the key
    kernel == coherence_keys32 and its argsort == the plain stable
    argsort's (and the int64 keys') on every ray, 0 plain calls on the
    card path, the times in turns (median of 10 turns), the kernels each
    call launches (torch.profiler) and the bound."""
    import torch

    from raytracer_tpu_torch.ops import cuda_traverse as ct
    from raytracer_tpu_torch.ops.bvh4 import BIG
    from raytracer_tpu_torch.ops.packets import coherence_keys, coherence_keys32

    n = o.shape[0]
    lim = t_lim if torch.is_tensor(t_lim) else torch.full((n,), float(t_lim), device=o.device)
    plain0 = ct.PLAIN_CALLS["traverse_plain"]
    rs = ct.trace_closest(o, d, bvh, t_lim, t_min, sort=True)
    ru = ct.trace_closest(o, d, bvh, t_lim, t_min, sort=False)
    t2, id2 = ct.intersect_bvh4(o, d, bvh, t_min, t_lim)
    keys = ct.coherence_keys_cuda(o, d, bvh)
    plain_on_card = ct.PLAIN_CALLS["traverse_plain"] - plain0
    torch.cuda.synchronize()
    box = bvh.sort_box
    perm = torch.argsort(keys, stable=True)
    checks = {
        "sorted == unsorted": not _equal_records(rs, ru),
        "intersect_bvh4 == sorted (t, tri_id)": (_bitwise(t2, rs["t"])
                                                 and torch.equal(id2, rs["tri_id"])),
        "keys == coherence_keys32": torch.equal(keys, coherence_keys32(o, d, box[0:3], box[3:6])),
        "perm == plain stable argsort": torch.equal(perm, ct.sort_perm(o, d, bvh)),
        "perm == int64 keys' stable argsort": torch.equal(
            perm, torch.argsort(coherence_keys(o, d, box[0:3], box[3:6]), stable=True)),
        "0 plain calls on the card path": plain_on_card == 0,
    }
    pick = torch.from_numpy(np.random.default_rng(subset_seed).choice(
        n, min(P8_SUBSET, n), replace=False)).to(o.device)
    os_, ds_, ls_ = o[pick].contiguous(), d[pick].contiguous(), lim[pick].contiguous()
    rp = ct.trace_closest_plain(os_, ds_, bvh, ls_, t_min, sort=True)
    checks["sorted == plain (subset)"] = not _equal_records({k: v[pick] for k, v in rs.items()},
                                                           rp)
    sub_perm = ct.sort_perm(os_, ds_, bvh)
    rand = torch.from_numpy(np.random.default_rng(subset_seed + 1).permutation(
        os_.shape[0])).to(o.device)
    for pname, p in (("sort", sub_perm), ("random", rand)):
        k = ct._trace_closest_cuda(os_, ds_, bvh, ls_, t_min, perm=p)
        checks[f"K4 through the {pname} permutation == plain (subset)"] = not _equal_records(
            k, ct.trace_closest_plain(os_, ds_, bvh, ls_, t_min, perm=p))
    if not all(checks.values()):
        raise AssertionError(f"phase 8 {name}: {checks}")
    hit = rp["hit"]
    max_err = float((rs["t"][pick] - rp["t"])[hit].abs().max()) if bool(hit.any()) else 0.0
    # The bound: K1 steps and culled brute MT records of the plain version,
    # on every ray up to 262,144, else on the subset, scaled to n.
    if n <= 1 << 18:
        steps = int(ct._traverse_plain(o, d, bvh, lim, t_min, count=True)[4].sum())
        mts = brute_mts(bvh, o, d, lim, t_min)[0]
    else:
        scale = n / os_.shape[0]
        steps = round(int(ct._traverse_plain(os_, ds_, bvh, ls_, t_min, count=True)[4].sum())
                      * scale)
        mts = round(brute_mts(bvh, os_, ds_, ls_, t_min)[0] * scale)
    fns = {"kernel": k4_alone(o, d, bvh, t_lim),
           "kernel_perm": k4_alone(o, d, bvh, t_lim, perm=perm),
           "keys": keys_alone(o, d, bvh),
           "argsort": lambda: torch.argsort(keys, stable=True),
           "unsorted": lambda: ct.trace_closest(o, d, bvh, t_lim, t_min, sort=False),
           "sorted": lambda: ct.trace_closest(o, d, bvh, t_lim, t_min, sort=True),
           "intersect_bvh4": lambda: ct.intersect_bvh4(o, d, bvh, t_min, t_lim)}
    ms = _ms_in_turns(fns, 20)
    prof = {k: kernels_launched(fns[k]) for k in ("sorted", "unsorted", "argsort")}
    plain_ms = {"unsorted": cuda_ms(lambda: ct.trace_closest_plain(os_, ds_, bvh, ls_, t_min), 1),
                "sorted": cuda_ms(lambda: ct.trace_closest_plain(os_, ds_, bvh, ls_, t_min,
                                                                 sort=True), 1)}
    return dict(rays=n, subset=os_.shape[0], hits=int(rs["hit"].sum()),
                dead=int((lim <= t_min).sum()), limit_big=int((lim >= float(BIG)).sum()),
                max_abs_err=max_err, checks=list(checks), k1_steps=steps, brute_mts=mts,
                bound=trace_bound(bvh, n, steps), bound_cull=trace_bound_cull(bvh, n, steps, mts),
                ms=ms, plain_ms_subset=plain_ms,
                launches={k: (v.get("kernels"), v.get("activities")) for k, v in prof.items()},
                profile=prof)


def phase8(scene, dev):
    """K4 and K4-sort on phase 8's 262,144 second-bounce rays (scalar
    limit) and on the training path's two 1,048,576-ray wavefronts
    (per-ray limits), each through phase8_set; and K4 alone at 262,144
    and 1,048,576 of phase 8's rays. Returns ({set: result}, {size:
    (median, min, max) ms})."""
    from raytracer_tpu_torch.ops.bvh4 import BIG

    o1, d1 = bounce_rays(scene, dev)
    out = {"phase 8": phase8_set("phase 8", o1, d1, scene.bvh4, float(BIG), 1e-3, 8)}
    tscene, t_min, waves = training_wavefronts(dev)
    for b, (o, d, t_cap) in waves.items():
        out[f"training bounce {b}"] = phase8_set(f"training bounce {b}", o, d, tscene.bvh4, t_cap,
                                                 t_min, 80 + b)
    # Latency or throughput: K4 alone on phase 8's rays and on four copies
    # of them (1,048,576 rays, ~7 waves of the card), in turns.
    o4, d4 = o1.repeat(4, 1), d1.repeat(4, 1)
    scaling = _ms_in_turns({"262,144": k4_alone(o1, d1, scene.bvh4, float(BIG)),
                            "1,048,576 (x4)": k4_alone(o4, d4, scene.bvh4, float(BIG))}, 20)
    return out, scaling


def phase9(scene, dev):
    """The differentiable renderer's forward pass: megakernel (ktf) vs
    K3, the jax family once, and the CLI."""
    import torch

    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.fused import render_image_fused
    from raytracer_tpu_torch.render import render_image_chunked

    cfg = RenderConfig(**P9, rng_impl="ktf")
    cam = showcase_camera(cfg)
    with torch.no_grad():
        render_image_chunked(scene, cam, cfg, 0)   # warm-up (same shapes)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        img = render_image_chunked(scene, cam, cfg, 0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        img_k3 = render_image_fused(scene, cam, cfg, 0)
        img_jax = render_image_chunked(scene, cam, cfg.replace(rng_impl="jax"), 0)
        ms = cuda_ms(lambda: render_image_chunked(scene, cam, cfg, 0), 5)
        ms_k3 = cuda_ms(lambda: render_image_fused(scene, cam, cfg, 0), 5)
    bad, mean_diff, max_abs = image_agreement(img, img_k3)
    if not (bool(torch.isfinite(img).all()) and bad <= IMG_BAD_FRAC and mean_diff <= MEAN_TOL):
        raise AssertionError(f"megakernel (ktf) vs K3: {bad:.4%} elements beyond tolerance, "
                             f"mean diff {mean_diff}")
    mean_jax = img_jax.mean().item()
    if not np.isfinite(mean_jax):
        raise AssertionError(f"jax-family megakernel mean {mean_jax}")
    png = os.path.join("renders", "chip_smoke_megakernel.png")
    os.makedirs(os.path.join(ROOT, "renders"), exist_ok=True)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "raytracer_tpu_torch.cli", "--integrator",
                          "megakernel", "--scene", "cornell_bunny", "--width", str(P9["width"]),
                          "--height", str(P9["height"]), "--spp", str(P9["spp"]),
                          "--max-bounces", str(P9["max_bounces"]), "--out", png],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, png), "rb") as f:
        head = f.read(8)
    if out.returncode != 0 or head != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"CLI --integrator megakernel failed ({out.returncode}): "
                             f"{out.stderr[-2000:]}")
    return dict(seconds=secs, ms=ms, ms_k3=ms_k3, mean=img.mean().item(),
                mean_k3=img_k3.mean().item(), bad=bad,
                mean_diff=mean_diff, max_abs=max_abs, mean_jax=mean_jax, png=png, cli_s=cli_s,
                **counts)


def inverse_setup(dev, size: dict, pairs: int):
    """The INVERSE_r05 problem at `size`: scene, cfg, true camera, pair
    keys, targets and the noised, pose-perturbed initial params."""
    import torch

    from raytracer_tpu_torch.camera import make_camera
    from raytracer_tpu_torch.config import PRESETS
    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.render import render_image
    from raytracer_tpu_torch.scene.builder import build_scene_bvh4, cornell_materials_scene
    from raytracer_tpu_torch.utils import rng

    scene = cornell_materials_scene(build_bvh=False)
    centers = scene.spheres.center.clone()
    centers[3] = torch.tensor([0.14, -0.16, 0.12])  # un-occlude the rough metal
    scene = scene.replace(spheres=dataclasses.replace(scene.spheres, center=centers))
    scene = scene.replace(bvh4=build_scene_bvh4(scene.mesh)).to(dev)
    cfg = PRESETS["inverse_render"].replace(reference_emission_quirk=False,
                                            edge_aware_lights=True, fov_degrees=110.0, **size)
    cam = make_camera(aspect_ratio=cfg.aspect_ratio, fov_degrees=cfg.fov_degrees,
                      aperture=cfg.aperture, position=(0.0, -0.05, 0.29), yaw=-90.0,
                      pitch=-10.0).to(dev)
    keys = rng.split(rng.key(40, dev), pairs)
    with torch.no_grad():
        targets = torch.stack([render_image(scene, cam, cfg, (keys[0][j], keys[1][j]))
                               for j in range(pairs)])
    params = inverse.init_params(scene, P10_FIELDS, key=rng.key(41, dev), noise=0.15)
    params["cam_position"] = cam.position + torch.tensor(P10_CAM_PERTURB["cam_position"],
                                                         device=dev)
    params["cam_yaw"] = cam.yaw + P10_CAM_PERTURB["cam_yaw"]
    params["cam_pitch"] = cam.pitch + P10_CAM_PERTURB["cam_pitch"]
    return scene, cfg, cam, keys, targets, params


def k2_raw_ms(dev, n: int = 1 << 20, reps: int = 200) -> dict:
    """K2 alone through its two ctypes entry points on buffers of n
    counter pairs made once (CUDA events, mean of reps launches): one key
    per element (the jax family's form) and one key for all (the ktf
    family's)."""
    import torch

    from raytracer_tpu_torch.utils import cudalib

    gen = np.random.default_rng(3)
    c0, c1, k0, k1 = (torch.from_numpy(gen.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
                      for _ in range(4))
    x0, x1 = torch.empty_like(c0), torch.empty_like(c0)
    L, s = cudalib.lib(), cudalib.stream_handle()
    ptrs = (c0.data_ptr(), c1.data_ptr(), n, x0.data_ptr(), x1.data_ptr(), 256, s)
    keyed = cuda_ms(lambda: L.rt_ktf_threefry_keyed(k0.data_ptr(), k1.data_ptr(), *ptrs), reps)
    one = cuda_ms(lambda: L.rt_ktf_threefry(0, 12345, *ptrs), reps)
    return {"keyed_ms": keyed, "one_key_ms": one}


def training_keys(dev):
    """What render_pixels starts from on INVERSE_r05's first chunk
    (P10_CHUNK pairs x 128 x 128 pixels), as pairs_loss makes it: the pair
    keys repeated per pixel and the pixel ids. Returns ((k0, k1) [n],
    pixel ids [n], samples per trace)."""
    import torch

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render import pixel_grid, samples_per_trace
    from raytracer_tpu_torch.utils import rng

    cfg = RenderConfig(**P10)
    px, py = pixel_grid(cfg, dev)
    keys = rng.split(rng.key(40, dev), P10_PAIRS)
    p = px.shape[0]
    pair = (keys[0][:P10_CHUNK].repeat_interleave(p), keys[1][:P10_CHUNK].repeat_interleave(p))
    pix = (py * cfg.width + px).repeat(P10_CHUNK)
    torch.cuda.synchronize()
    return pair, pix, samples_per_trace(cfg, pix.shape[0], cfg.spp)


def chain_draw_sites(dev) -> dict:
    """The jax family's draw sites of one trace of the training path
    (training_keys; 1,048,576 lanes) through the per-method chain of
    utils/rng (KeySampler, K2 launched for every fold and every draw: the
    route before the draw kernels): {site: fn}. 'lane keys' folds the
    pixel ids into the pair keys (once per chunk); 'camera' tiles those
    keys over the trace's samples, folds the samples in and draws jitter
    and lens, as render_pixels and generate_rays do; 'bounce b' folds the
    bounce and draws what bounce_step draws (roulette from min_bounces on,
    scatter, dielectric)."""
    import torch

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.utils import rng

    cfg = RenderConfig(**P10)
    pair, pix, m = training_keys(dev)
    pkeys = rng.lane_keys(pair, pix)
    n = pix.shape[0]

    def sample_keys():
        samples = torch.arange(m, dtype=torch.int32, device=dev).repeat_interleave(n)
        return rng.fold((pkeys[0].repeat(m), pkeys[1].repeat(m)), samples)

    skeys = sample_keys()

    def camera():
        smp = rng.KeySampler(sample_keys())
        return smp.lens_disk(), smp.jitter_uv()

    def bounce(b):
        smp = rng.KeySampler(rng.fold(skeys, b))
        rr = smp.rr_uniform() if b >= cfg.min_bounces else None
        return rr, smp.scatter_unit_vector(), smp.dielectric_uniform()

    sites = {"lane keys": lambda: rng.lane_keys(pair, pix), "camera": camera}
    sites.update({f"bounce {b}": (lambda b=b: bounce(b)) for b in range(cfg.max_bounces)})
    return sites


def site_census(sites: dict, reps: int = 20) -> dict:
    """Each draw site's kernels (torch.profiler: kernels, kernels +
    memsets and copies, busy share of the span) and its ms (CUDA events)."""
    out = {}
    for name, fn in sites.items():
        ms = cuda_ms(fn, reps)
        k = kernels_launched(fn)
        out[name] = dict(kernels=k.get("kernels"), activities=k.get("activities"),
                         busy_us=k.get("busy_us"), span_us=k.get("span_us"),
                         busy_share=(k["busy_us"] / k["span_us"]) if k.get("span_us") else None,
                         ms=ms)
    return out


def chunk_census(scene, cfg, cam, keys, targets, params) -> dict:
    """One chunk of the INVERSE_r05 training step (forward and backward of
    pairs_loss on the first P10_CHUNK pairs of inverse_setup's problem),
    as torch.profiler sees it: kernels, memsets and copies, busy and span
    microseconds."""
    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.render import pixel_grid

    px, py = pixel_grid(cfg, scene.materials.type.device)
    k = P10_CHUNK
    kc, tc = (keys[0][:k], keys[1][:k]), targets[:k].reshape(k, -1, 3)
    got = kernels_launched(lambda: inverse.value_and_grad(
        lambda p: inverse.pairs_loss(scene, cam, cfg, p, kc, tc, px, py), params))
    return {x: got.get(x) for x in ("kernels", "activities", "busy_us", "span_us", "idle_us")}


def draws_per_chunk(sites: dict) -> int:
    """Kernels a training chunk's draws launch, from site_census's counts:
    the lane keys once, the camera and every bounce once per trace."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render import samples_per_trace

    cfg = RenderConfig(**P10)
    n_px = P10_CHUNK * cfg.width * cfg.height
    traces = -(-cfg.spp // samples_per_trace(cfg, n_px, cfg.spp))
    return sites["lane keys"]["kernels"] + traces * sum(
        v["kernels"] for k, v in sites.items() if k != "lane keys")


def phase10(dev):
    """Three Adam steps of INVERSE_r05 on the card, then kernel vs plain
    and finite differences at a reduced size."""
    import torch

    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.render import pixel_grid, samples_per_trace

    scene, cfg, cam, keys, targets, params = inverse_setup(dev, P10, P10_PAIRS)
    step = inverse.make_train_step_accum(
        scene, cam, cfg, targets, keys, chunk=P10_CHUNK, lr=P10_LR,
        lr_fn=inverse.cosine_lr(P10_LR, P10_SCHEDULE_STEPS, 0.05), lr_scales=P10_LR_SCALES)
    state = inverse.adam_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    graphs = dict(inverse.GRAPHS)
    losses, times = [], []
    for _ in range(P10_STEPS):
        t0 = time.perf_counter()
        params, state, loss = step(params, state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = _counts()
    graphs = {k: inverse.GRAPHS[k] - graphs[k] for k in graphs}
    peak = torch.cuda.max_memory_allocated()
    bad = [k for k, v in params.items() if not bool(torch.isfinite(v).all())]
    if bad or not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training state: losses {losses}, params {bad}")
    # K4 launches once per bounce of each trace; a chunk of pairs renders
    # its chunk x H x W pixels in traces of samples_per_trace samples. The
    # host launches a chunk's kernels when it captures it, and before that
    # those of the warm-up's WARM_UP_PIXELS pixels; every chunk replays.
    n_px = P10_CHUNK * cfg.width * cfg.height
    per = samples_per_trace(cfg, n_px, cfg.spp)
    traces = -(-cfg.spp // per)
    warm = -(-cfg.spp // samples_per_trace(cfg, inverse.WARM_UP_PIXELS, cfg.spp))
    n_chunks = P10_PAIRS // P10_CHUNK
    if graphs != dict(graph_captures=1, graph_replays=P10_STEPS * n_chunks):
        raise AssertionError(f"training path: graph counters {graphs}")
    runs = traces + warm   # traces the host enqueued: the captured chunk's and the warm-up's
    k4_expected = runs * cfg.max_bounces
    # The K2 route per chunk: one Threefry launch (render_pixels folds the
    # pixel ids into the pair keys), then per trace one camera and one
    # bounce draw kernel per bounce.
    k2_expected = dict(k2_threefry=2, k2_camera=runs, k2_bounce=runs * cfg.max_bounces)
    k2_expected["k2"] = sum(k2_expected.values())
    chunk = chunk_census(scene, cfg, cam, keys, targets, params)

    # Reduced size: the kernel step against the plain step (CPU), and
    # central finite differences against autograd on the card.
    s_scene, s_cfg, s_cam, s_keys, s_tg, s_params = inverse_setup(dev, P10_SMALL,
                                                                  P10_SMALL_PAIRS)
    px, py = pixel_grid(s_cfg, dev)
    tg = s_tg.reshape(P10_SMALL_PAIRS, -1, 3)

    def loss_on(device):
        sc, cm = s_scene.to(device), s_cam.to(device)
        ks, t = (s_keys[0].to(device), s_keys[1].to(device)), tg.to(device)
        qx, qy = px.to(device), py.to(device)
        return lambda p: inverse.pairs_loss(sc, cm, s_cfg, p, ks, t, qx, qy)

    loss_k, grads_k = inverse.value_and_grad(loss_on(dev), s_params)
    cpu_params = {k: v.cpu() for k, v in s_params.items()}
    loss_p, grads_p = inverse.value_and_grad(loss_on(torch.device("cpu")), cpu_params)
    grad_frac = max(float((grads_k[k].cpu() - grads_p[k]).abs().max())
                    / max(float(grads_p[k].abs().max()), 1e-12) for k in grads_p)
    if (abs(float(loss_k) - float(loss_p)) > STEP_LOSS_RTOL * abs(float(loss_p))
            or grad_frac > STEP_GRAD_FRAC):
        raise AssertionError(f"kernel step vs plain step: loss {float(loss_k)} vs "
                             f"{float(loss_p)}, grad max |diff| / scale {grad_frac}")
    fd = {}
    f_k = loss_on(dev)
    types = s_scene.materials.type.cpu()
    for field, eps, mtype in (("emission", 1e-2, 3), ("albedo", 1e-3, 0)):
        g = grads_k[field].cpu()
        mask = (types == mtype)[:, None].expand_as(g)
        idx = np.unravel_index(int(torch.where(mask, g.abs(), torch.zeros_like(g)).argmax()),
                               tuple(g.shape))
        with torch.no_grad():
            up, dn = dict(s_params), dict(s_params)
            up[field] = s_params[field].clone()
            up[field][idx] += eps
            dn[field] = s_params[field].clone()
            dn[field][idx] -= eps
            g_fd = (float(f_k(up)) - float(f_k(dn))) / (2 * eps)
        g_ad = float(g[idx])
        if not np.isclose(g_ad, g_fd, rtol=FD_RTOL, atol=FD_ATOL):
            raise AssertionError(f"FD check {field}{list(idx)}: autograd {g_ad} vs FD {g_fd}")
        fd[f"{field}{[int(i) for i in idx]}"] = {"autograd": g_ad, "fd": g_fd}
    return dict(losses=losses, step_s=[round(t, 4) for t in times],
                s_per_step=float(np.median(times[1:])), max_memory_allocated=peak,
                k4_expected=k4_expected, host_traces=runs, graphs=graphs,
                k4_formula=f"the captured chunk's {traces} traces of {per} samples and the "
                           f"warm-up's {warm}, x {cfg.max_bounces} bounces",
                k2_expected=k2_expected,
                k2_formula=f"{runs} traces x (1 camera + {cfg.max_bounces} bounces) + 2 "
                           f"lane-key folds",
                chunk_kernels=chunk,
                small_loss=float(loss_k), small_loss_plain=float(loss_p), grad_frac=grad_frac,
                fd=fd, **counts)


def lane_list_repeats(dev, widths=(8, 4), interleaves=(1, 2)) -> dict:
    """ROADMAP queue 3's K5 fault, repeated: at each tree width, each
    (block, chunk) case of LANE_CASES at each lane count of LANE_COUNTS,
    LANE_REPEATS times, through K3 (interleave 1) and K5 (interleave 2),
    held bit for bit to K3's render of the whole lane list, which is
    itself re-rendered and held to its first render each time; then the
    largest lane count at chunk 1, LANE_CHUNK1_REPEATS times per block of
    32 and 256. The wrappers fill every output with NaN before a launch,
    so a lane the lane list loses shows as NaN; a wrong finite radiance
    points at the walk or the slot state. Launches are the wrappers' own
    counts.
    tests/test_torch_cuda.py::test_lane_list_corners_repeated runs this
    one width and interleave at a time."""
    import torch

    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import cuda_megakernel as cm
    from raytracer_tpu_torch.scene.builder import cornell_materials_scene, tree_width
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid

    cfg = RenderConfig(width=128, height=32, spp=2, max_bounces=8)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    counter = {"K3": "render_fused", "K5": "render_fused_g2"}
    before = {k: cm.LAUNCHES[v] for k, v in counter.items()}
    lanes, failures = {"K3": 0, "K5": 0}, []
    t0 = time.perf_counter()

    def check(what, got, want):
        if torch.equal(got, want):
            return
        bad = torch.nonzero((got != want).any(dim=1)).squeeze(1)
        nan = torch.isnan(got[bad]).any(dim=1)
        failures.append(dict(case=what, lanes=int(bad.numel()), nan_lanes=int(nan.sum()),
                             first=bad[:4].tolist(), got=got[bad[:2]].tolist(),
                             want=want[bad[:2]].tolist()))

    for width in widths:
        with tree_width(width):
            scene = cornell_materials_scene().to(dev)
        whole = cm.render_tiles_fused(scene, cam, cfg, 3, px, py, interleave=1)
        if not bool(torch.isfinite(whole).all()):
            raise AssertionError(f"lane-list repeats: K3's whole list at width {width} is not "
                                 "finite")
        picks = {n: torch.from_numpy(np.random.default_rng(n).choice(
            px.shape[0], n, replace=False)).to(dev) for n in LANE_COUNTS}

        def run(lane, block, chunk, g, what):
            got = cm.render_tiles_fused(scene, cam, cfg, 3, px[lane], py[lane], block=block,
                                        chunk=chunk, interleave=g)
            check(what, got, whole[lane])
            lanes["K5" if g == 2 else "K3"] += lane.shape[0]

        for rep in range(LANE_REPEATS):
            if rep % 50 == 0:
                log(11, f"lane-list repeats: width {width}, repeat {rep}, "
                        f"{time.perf_counter() - t0:.1f} s")
            check(f"w{width} K3 whole rep {rep}",
                  cm.render_tiles_fused(scene, cam, cfg, 3, px, py, interleave=1), whole)
            lanes["K3"] += px.shape[0]
            for n, lane in picks.items():
                for g in interleaves:
                    for block, chunk in LANE_CASES:
                        run(lane, block, chunk, g,
                            f"w{width} G={g} n={n} block={block} chunk={chunk} rep {rep}")
        lane = picks[max(LANE_COUNTS)]
        for rep in range(LANE_CHUNK1_REPEATS):
            for g in interleaves:
                for block in (32, 256):
                    run(lane, block, 1, g, f"w{width} G={g} n={lane.shape[0]} block={block} "
                                           f"chunk=1 rep {rep} (chunk-1 run)")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: cm.LAUNCHES[v] - before[k] for k, v in counter.items()}
    msg = (f"lane-list repeats: {len(LANE_CASES)} (block, chunk) cases x lane counts "
           f"{LANE_COUNTS} x {LANE_REPEATS} repeats, then {max(LANE_COUNTS)} lanes at chunk "
           f"1 x {LANE_CHUNK1_REPEATS} repeats x blocks 32 and 256, widths {widths}, interleaves "
           f"{interleaves}, outputs NaN-filled before each launch: K3 {launches['K3']} launches / "
           f"{lanes['K3']} lanes (the whole list re-rendered {len(widths) * LANE_REPEATS} times "
           f"among them), K5 {launches['K5']} launches / {lanes['K5']} lanes (the wrappers' counts); "
           f"{len(failures)} launches differed from K3's whole list; {secs:.1f} s")
    if failures:
        print(json.dumps({"lane_list_failures": failures[:20]}), flush=True)
        raise AssertionError(msg + f"; first: {failures[0]}")
    return dict(launches=launches, lanes=lanes, seconds=secs, msg=msg)


def k2_captured(module, start: int, want):
    """Wraps `module.threefry2x32_kernel` (utils/ktf.py for the ktf
    family's samplers, utils/rng.py for the jax family's folds) and keeps
    a copy of the inputs of the first call, from call `start` on, that
    `want(k0, k1, c0, c1)` accepts. Restore with `module.threefry2x32_kernel
    = got["real"]`."""
    import torch

    real = module.threefry2x32_kernel
    got = {"real": real, "calls": 0}

    def record(k0, k1, c0, c1):
        if "args" not in got and got["calls"] >= start and want(k0, k1, c0, c1):
            got["args"] = tuple(x.clone() if torch.is_tensor(x) else x for x in (k0, k1, c0, c1))
            got["call"] = got["calls"]
        got["calls"] += 1
        return real(k0, k1, c0, c1)

    module.threefry2x32_kernel = record
    return got


def _varies(t) -> bool:
    return t.numel() > 1 and bool((t != t.reshape(-1)[0]).any())


def ktf_per_lane_call(k0, k1, c0, c1) -> bool:
    """A ktf-family block with one key and a sample and a bounce that
    differ across lanes (c1 = sample << 9 | bounce << 4 | purpose)."""
    import torch

    return (not torch.is_tensor(k0) and torch.is_tensor(c1) and _varies(c1 >> 9)
            and _varies((c1 >> 4) & 31))


def jax_keyed_call(k0, k1, c0, c1) -> bool:
    """A jax-family fold through K2's keyed entry: a key and a fold word
    (a sample or a bounce) per lane."""
    import torch

    return (torch.is_tensor(k0) and torch.is_tensor(c1) and k0.shape == c1.shape
            and _varies(k0) and _varies(c1))


def k2_held(args, int32_rate) -> dict:
    """K2 on captured inputs against the plain Threefry on the same card
    tensors, bit for bit; times and the bound of the call (each per-lane
    input read once, both words written once; THREEFRY_OPS per block)."""
    import torch

    from raytracer_tpu_torch.utils import ktf

    k0, k1, c0, c1 = args
    x = ktf.threefry2x32_kernel(*args)
    p = ktf.threefry2x32(*args)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(x, p))
    if not all(torch.equal(a, b) for a, b in zip(x, p)):
        raise AssertionError(f"K2 on the wavefront's call differs from the plain Threefry: max "
                             f"|word difference| {err}")
    n = x[0].numel()
    n_in = sum(t.numel() for t in (k0, k1, c0, c1) if torch.is_tensor(t))
    row = dict(lanes=n, keyed=torch.is_tensor(k0), max_abs_err=float(err),
               ms=cuda_ms(lambda: ktf.threefry2x32_kernel(*args), 20),
               plain_ms=cuda_ms(lambda: ktf.threefry2x32(*args), 3),
               **roofline(4 * n_in + 8 * n, THREEFRY_OPS * n, int32_rate))
    if torch.is_tensor(k0):
        row["distinct_keys"] = int(torch.unique(k1).numel())
    else:
        row["distinct_samples"] = int(torch.unique(c1 >> 9).numel())
        row["distinct_bounces"] = int(torch.unique((c1 >> 4) & 31).numel())
    return row


def phase21(dev, smi) -> dict:
    """The lane grid on the card at the main path's 2560x1440 frame: the
    blocked layout (lane_grid, the fused path's) and the tiled one
    (tiled_lane_grid, the wavefront's), one launch each, px, py and inv bit
    for bit against the plain closed form run on the card and against the
    numpy builders; the kernel's time (CUDA events, back to back) against
    its bound, a synchronized call on the host clock, the plain form's
    time on the card, and the numpy grid with its pageable copy (the
    route the kernel replaced) on the host clock."""
    import torch

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.fused import _fused_pixel_grid
    from raytracer_tpu_torch.ops import cuda_lane_grid as lg
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid

    cfg = RenderConfig(**MAIN)
    w, h = cfg.width, cfg.height
    routes = {"blocked": (lg.lane_grid, _fused_pixel_grid, lg.BLOCKED),
              "tiled": (lg.tiled_lane_grid, _tiled_pixel_grid, lg.TILED)}
    if lg.fused_layout(cfg) != lg.BLOCKED:
        raise AssertionError(f"the main frame {w}x{h} does not take the blocked layout")
    lg.LAUNCHES["lane_grid"] = lg.PLAIN_CALLS["lane_grid"] = 0
    grids = {k: kernel(cfg, dev) for k, (kernel, _, _) in routes.items()}
    torch.cuda.synchronize()
    if lg.LAUNCHES["lane_grid"] != 2 or lg.PLAIN_CALLS["lane_grid"]:
        raise AssertionError(f"lane grid: {lg.LAUNCHES['lane_grid']} launches, "
                             f"{lg.PLAIN_CALLS['lane_grid']} plain calls for two grids")
    res = {}
    for k, (_, numpy_grid, layout) in routes.items():
        plain = lg.build(w, h, layout, dev, plain=True)
        t0 = time.perf_counter()
        ref = numpy_grid(cfg)
        numpy_s = time.perf_counter() - t0
        for name, g, p, x in zip(("px", "py", "inv"), grids[k], plain, ref):
            if not (g.is_cuda and g.dtype == p.dtype == x.dtype and torch.equal(g, p)
                    and torch.equal(g.cpu(), x)):
                raise AssertionError(f"lane grid, {k} layout, {name}: the kernel's differs from "
                                     f"the plain form on the card or the numpy builder's")
        copy_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            [t.to(dev) for t in numpy_grid(cfg)]
            torch.cuda.synchronize()
            copy_s.append(time.perf_counter() - t0)
        sync_s = []
        for _ in range(20):
            t0 = time.perf_counter()
            lg.build(w, h, layout, dev)
            torch.cuda.synchronize()
            sync_s.append(time.perf_counter() - t0)
        res[k] = dict(ms=cuda_ms(lambda: lg.build(w, h, layout, dev), 50),
                      plain_ms=cuda_ms(lambda: lg.build(w, h, layout, dev, plain=True), 20),
                      host_ms=float(np.median(sync_s)) * 1e3, numpy_ms=numpy_s * 1e3,
                      numpy_copy_ms=float(np.median(copy_s)) * 1e3, lanes=grids[k][0].numel())
    bound = roofline(_nbytes(*grids["blocked"]), 0)
    b, t = res["blocked"], res["tiled"]
    row = dict(max_abs_err=0.0, ms=b["ms"], plain_ms=b["plain_ms"], **bound,
               roofline_pct=100 * bound["bound_ms"] / b["ms"], host_ms=b["host_ms"],
               numpy_copy_ms=b["numpy_copy_ms"], tiled_ms=t["ms"], tiled_plain_ms=t["plain_ms"],
               tiled_host_ms=t["host_ms"], tiled_numpy_copy_ms=t["numpy_copy_ms"],
               lanes=b["lanes"], tiled_lanes=t["lanes"])
    msg = (f"lane grid at {w}x{h}, one launch a layout, px, py, inv bitwise = the plain form on "
           f"the card = the numpy builders; " + "; ".join(
               f"{k} ({v['lanes']} lanes): kernel {v['ms']:.4f} ms (CUDA events, back to back), "
               f"{v['host_ms']:.4f} ms a synchronized call (host clock), plain form on the card "
               f"{v['plain_ms']:.4f} ms, numpy grid {v['numpy_ms']:.1f} ms and with its pageable "
               f"copy {v['numpy_copy_ms']:.1f} ms (median of 3)" for k, v in res.items())
           + f"; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: {bound['bound_bytes']} "
           f"bytes written), {row['roofline_pct']:.1f}% of it in the blocked layout on {smi}")
    return dict(row=row, msg=msg)


RTIOW_CONFIG = os.path.join(ROOT, "benchmark", "configs", "rtiow_final_1200.json")
RTIOW_ROOFLINE = os.path.join(ROOT, "benchmark", "metrics", "k3_roofline.rtiow.json")
RTIOW_SAMPLE = 4096   # lanes of the frame held to the plain version,
RTIOW_SAMPLE_SPP = 8  # at this many samples each (the plain version takes ~5 min at 64)


def phase22(dev, smi) -> dict:
    """The "Ray Tracing in One Weekend" final scene with its sphere tree,
    built from benchmark/configs/rtiow_final_1200.json as the benchmark
    builds it (benchmark/program.scene, then build_sphere_tree): the
    tree's node count, sweep set and build seconds; K3's registers and
    local memory with and without the tree; one 64-spp pass of the
    1200x675 frame at 50 bounces through K3 with the tree, with the
    launch counters zeroed first (one launch of the tree's K3, none of
    the sweep's); RTIOW_SAMPLE seeded lanes of the frame at
    RTIOW_SAMPLE_SPP samples through K3 with the tree against the plain
    version on the card, held to phase 5's tolerance; the frame bit for
    bit against K3 sweeping all 487 spheres (the sweep route taken past
    the 16-sphere budget, here alone), both timed in turns with CUDA
    events; the bound from the frozen work a
    path (benchmark/metrics/k3_roofline.rtiow.json) at the fp32 peak;
    the frame written to renders/."""
    import json

    import torch

    from benchmark import program
    from raytracer_tpu_torch.models.fused import render_image_fused
    from raytracer_tpu_torch.ops import cuda_megakernel
    from raytracer_tpu_torch.ops.tonemap import to_rgba8
    from raytracer_tpu_torch.scene import builder
    from raytracer_tpu_torch.utils.image import write_png

    with open(RTIOW_CONFIG) as f:
        conf = json.load(f)
    with open(RTIOW_ROOFLINE) as f:
        ops_per_path = json.load(f)["ops_per_path"]
    w, h = conf["resolution"]
    spp = conf["spp_per_pass"]
    cfg = program.render_config(conf).replace(spp=spp, spp_per_pass=spp)
    cam = program.camera(conf, cfg)
    t0 = time.perf_counter()
    scene, _ = program.scene(conf, ROOT, "cpu")
    tree = builder.build_sphere_tree(scene.spheres)
    build_s = time.perf_counter() - t0
    scene = scene.replace(sphere_tree=tree).to(dev)
    sweep = scene.replace(sphere_tree=None)
    res = cuda_megakernel.kernel_resources()
    res_tree = cuda_megakernel.kernel_resources(sphere_tree=True)
    seed = 2024

    render_image_fused(scene, cam, cfg, seed)          # warm-up (same shapes)
    torch.cuda.synchronize()
    for key in cuda_megakernel.LAUNCHES:
        cuda_megakernel.LAUNCHES[key] = 0
    img = render_image_fused(scene, cam, cfg, seed)
    torch.cuda.synchronize()
    launches = dict(cuda_megakernel.LAUNCHES)
    if launches["render_fused_tree"] != 1 or launches["render_fused"] != 0:
        raise AssertionError(f"one pass of the RTIOW frame: launches {launches}, want one "
                             f"render_fused_tree and no render_fused")

    gen = torch.Generator().manual_seed(seed)
    flat = torch.randperm(w * h, generator=gen)[:RTIOW_SAMPLE].to(torch.int32)
    px, py = (flat % w).to(dev), (flat // w).to(dev)
    k3 = cuda_megakernel.render_tiles_fused(scene, cam, cfg, seed, px, py, spp=RTIOW_SAMPLE_SPP)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    p = cuda_megakernel.render_tiles_fused_plain(scene, cam, cfg, seed, px, py,
                                                 spp=RTIOW_SAMPLE_SPP)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    sample_ms = cuda_ms(lambda: cuda_megakernel.render_tiles_fused(scene, cam, cfg, seed, px, py,
                                                                   spp=RTIOW_SAMPLE_SPP), 3)
    bad, mean_diff, max_err = image_agreement(k3, p)
    if not (torch.isfinite(k3).all() and bad <= IMG_BAD_FRAC and mean_diff <= MEAN_TOL):
        raise AssertionError(f"K3 with the sphere tree vs plain on {RTIOW_SAMPLE} lanes of the "
                             f"RTIOW frame at {RTIOW_SAMPLE_SPP} spp: {bad:.4%} elements beyond "
                             f"{IMG_ATOL}+{IMG_RTOL}|x| (limit {IMG_BAD_FRAC:.1%}), mean diff "
                             f"{mean_diff:.3g} (limit {MEAN_TOL}), max abs {max_err:.3g}")

    budget = cuda_megakernel.MAX_SPHERES
    cuda_megakernel.MAX_SPHERES = scene.spheres.count
    try:
        if not torch.equal(img, render_image_fused(sweep, cam, cfg, seed)):
            raise AssertionError("K3 through the sphere tree differs from K3's sweep")
        ms = {"tree": [], "sweep": []}
        for _ in range(2):
            for name, sc in (("tree", scene), ("sweep", sweep), ("sweep", sweep),
                             ("tree", scene)):
                ms[name].append(cuda_ms(lambda: render_image_fused(sc, cam, cfg, seed), 1))
    finally:
        cuda_megakernel.MAX_SPHERES = budget
    os.makedirs(os.path.join(ROOT, "renders"), exist_ok=True)
    png = os.path.join(ROOT, "renders", "chip_smoke_rtiow_64spp.png")
    write_png(png, to_rgba8(img).cpu().numpy())
    tree_ms, sweep_ms = float(np.median(ms["tree"])), float(np.median(ms["sweep"]))
    paths = w * h * spp
    bound = roofline(24 * w * h, int(round(paths * ops_per_path)))
    row = dict(launches=launches["render_fused_tree"], max_abs_err=max_err, ms=tree_ms,
               plain_ms=plain_ms, **bound, roofline_pct=100 * bound["bound_ms"] / tree_ms,
               sample_lanes=RTIOW_SAMPLE, sample_spp=RTIOW_SAMPLE_SPP, sample_ms=sample_ms,
               sample_bad_frac=bad, sample_mean_diff=mean_diff, sweep_ms=sweep_ms, nodes=tree.nodes,
               sweep=tree.sweep.tolist(), build_s=build_s, regs=res_tree["K3"][0],
               local_bytes=res_tree["K3"][1], regs_without_tree=res["K3"][0],
               local_bytes_without_tree=res["K3"][1])
    msg = (f"RTIOW final scene ({scene.spheres.count} spheres, {scene.materials.count} "
           f"materials): tree of {tree.nodes} nodes, sweep set {tree.sweep.tolist()}, stack "
           f"bound {tree.stack_depth}, scene and tree built in {build_s:.3f} s; K3 registers / "
           f"local bytes with the tree {res_tree['K3']}, K3-profile {res_tree['K3-profile']}, "
           f"K5 {res_tree['K5']}; without it {res['K3']}; {w}x{h} at {spp} spp, one pass: "
           f"launches {launches['render_fused_tree']} render_fused_tree, "
           f"{launches['render_fused']} render_fused; {RTIOW_SAMPLE} seeded lanes at "
           f"{RTIOW_SAMPLE_SPP} spp against the plain version on the card: {bad:.4%} elements "
           f"beyond {IMG_ATOL}+{IMG_RTOL}|x| (limit {IMG_BAD_FRAC:.1%}), mean diff "
           f"{mean_diff:.3g} (limit {MEAN_TOL}), max abs {max_err:.3g}, kernel {sample_ms:.2f} ms vs plain {plain_ms:.0f} ms; K3 through "
           f"the tree == K3 sweeping every sphere bit for bit, {tree_ms:.2f} ms against "
           f"{sweep_ms:.2f} ms ({sweep_ms / tree_ms:.2f}x; CUDA events, median of 4 in turns: "
           f"{_fmt(ms['tree'])} / {_fmt(ms['sweep'])}); bound {bound['bound_ms']:.3f} ms "
           f"({bound['bound_by']}: {paths} paths x {ops_per_path} frozen ops at "
           f"{FP32_OPS_PER_S / 1e12:.1f} TFLOP/s), {row['roofline_pct']:.2f}% of it; wrote "
           f"{os.path.relpath(png, ROOT)}; on {smi}")
    return dict(row=row, msg=msg)


P23 = dict(width=256, height=256, spp=32, max_bounces=6, rng_impl="ktf")
P23_PAIRS, P23_CHUNK, P23_STEPS, P23_TURNS = 16, 8, 3, 3


def _train_run(step, params, steps: int) -> dict:
    """`steps` steps of `step` from `params` and a fresh Adam state: the
    losses, the gradients as adam_update receives them, the params after
    each step and each step's seconds (host clock to a synchronize)."""
    import torch

    from raytracer_tpu_torch.diff import inverse

    grads, update = [], inverse.adam_update

    def seen(state, g, p, **kw):
        grads.append({k: v.clone() for k, v in g.items()})
        return update(state, g, p, **kw)

    inverse.adam_update = seen
    try:
        state, out = inverse.adam_init(params), dict(losses=[], params=[], s=[])
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state)
            torch.cuda.synchronize()
            out["s"].append(time.perf_counter() - t0)
            out["losses"].append(loss.clone())
            out["params"].append({k: v.clone() for k, v in params.items()})
    finally:
        inverse.adam_update = update
    out["grads"] = grads
    return out


def _max_gap(a: list, b: list) -> float:
    return max(float((x[k] - y[k]).abs().max()) for x, y in zip(a, b) for k in x)


def phase23(dev, smi) -> dict:
    """The training step at the benchmark cell's size (256x256, 16 pairs
    in chunks of 8, 32 spp, 6 bounces, ktf draws, the edge term on)
    through ChunkGraph against the same step run eagerly, from the same
    params and Adam state: the eager route twice (its own run-to-run
    gap), then the graph route (step 1 warms up, captures and replays,
    the later steps replay); its losses bit for bit the eager route's,
    its gradients and params within the eager run-to-run gap; the
    capture's seconds (the warm-up, the capture and the instantiation,
    and the end of the capture with the instantiation apart); the
    counters; the peak memory of each route; and both routes' steps
    timed in turns."""
    import torch

    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.ops import cuda_traverse

    scene, cfg, cam, keys, targets, params = inverse_setup(dev, P23, P23_PAIRS)
    kw = dict(chunk=P23_CHUNK, lr=P10_LR, lr_fn=inverse.cosine_lr(P10_LR, P10_SCHEDULE_STEPS, 0.05),
              lr_scales=P10_LR_SCALES)
    n_chunks = P23_PAIRS // P23_CHUNK
    graph_cls = inverse.ChunkGraph
    inverse.ChunkGraph = lambda *a: None   # the step without the graph: eager on the card
    try:
        eager_step = inverse.make_train_step_accum(scene, cam, cfg, targets, keys, **kw)
    finally:
        inverse.ChunkGraph = graph_cls
    torch.cuda.reset_peak_memory_stats()
    eager = [_train_run(eager_step, params, P23_STEPS) for _ in range(2)]
    eager_peak = torch.cuda.max_memory_allocated()

    capture_s, end_s = [], []
    capture, capture_end = inverse.ChunkGraph._capture, torch.cuda.CUDAGraph.capture_end

    def timed_capture(self, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        capture(self, *a)
        torch.cuda.synchronize()
        capture_s.append(time.perf_counter() - t0)

    def timed_end(self):   # the end of the capture and the graph's instantiation
        t0 = time.perf_counter()
        capture_end(self)
        end_s.append(time.perf_counter() - t0)

    before = dict(inverse.GRAPHS)
    k4_before = cuda_traverse.LAUNCHES["trace_closest"]
    graph_step = inverse.make_train_step_accum(scene, cam, cfg, targets, keys, **kw)
    inverse.ChunkGraph._capture = timed_capture
    torch.cuda.CUDAGraph.capture_end = timed_end
    try:
        torch.cuda.reset_peak_memory_stats()
        graph = _train_run(graph_step, params, P23_STEPS)
        capture_peak = torch.cuda.max_memory_allocated()
    finally:
        inverse.ChunkGraph._capture = capture
        torch.cuda.CUDAGraph.capture_end = capture_end
    counts = {k: inverse.GRAPHS[k] - before[k] for k in before}
    k4_host = cuda_traverse.LAUNCHES["trace_closest"] - k4_before
    bitwise = all(torch.equal(a, b) for a, b in zip(graph["losses"], eager[0]["losses"]))
    gaps = dict(eager_grads=_max_gap(eager[1]["grads"], eager[0]["grads"]),
                graph_grads=_max_gap(graph["grads"], eager[0]["grads"]),
                eager_params=_max_gap(eager[1]["params"], eager[0]["params"]),
                graph_params=_max_gap(graph["params"], eager[0]["params"]))
    want = dict(graph_captures=1, graph_replays=P23_STEPS * n_chunks)
    if (not bitwise or counts != want or gaps["graph_grads"] > gaps["eager_grads"]
            or gaps["graph_params"] > gaps["eager_params"]):
        raise AssertionError(
            f"graph route: losses {[float(x) for x in graph['losses']]} against the eager "
            f"{[float(x) for x in eager[0]['losses']]} (bitwise {bitwise}), gaps {gaps}, "
            f"counters {counts} (want {want})")
    # Both routes on, in turns, from where each left off.
    turns = dict(eager=[], graph=[])
    state = dict(eager=(eager[0]["params"][-1], inverse.adam_init(params)),
                 graph=(graph["params"][-1], inverse.adam_init(params)))
    steps = dict(eager=eager_step, graph=graph_step)
    torch.cuda.reset_peak_memory_stats()
    for i in range(2 * P23_TURNS):
        for name in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            p, st = state[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, st, loss = steps[name](p, st)
            float(loss)
            turns[name].append(time.perf_counter() - t0)
            state[name] = (p, st)
    reserved = torch.cuda.memory_reserved()
    med = {k: float(np.median(v)) for k, v in turns.items()}
    out = dict(card=smi, size=P23, pairs=P23_PAIRS, chunk=P23_CHUNK,
               losses=[float(x) for x in graph["losses"]], losses_bitwise=bitwise, gaps=gaps,
               counters=counts, k4_host_launches=k4_host,
               eager_step_s=[round(x, 4) for x in eager[0]["s"] + eager[1]["s"]],
               graph_step_s=[round(x, 4) for x in graph["s"]],
               capture_s=[round(x, 4) for x in capture_s],
               capture_end_s=[round(x, 4) for x in end_s],
               turns_s={k: [round(x, 4) for x in v] for k, v in turns.items()},
               median_s=med, speedup=med["eager"] / med["graph"],
               eager_peak_gib=eager_peak / 2**30, capture_step_peak_gib=capture_peak / 2**30,
               reserved_gib=reserved / 2**30)
    msg = (f"training step at {P23['width']}x{P23['height']} spp{P23['spp']} "
           f"mb{P23['max_bounces']}, {P23_PAIRS} pairs in chunks of {P23_CHUNK}: graph route "
           f"losses {out['losses']} bit for bit the eager route's ({bitwise}); gradient gap "
           f"{gaps['graph_grads']:.3g} (eager run to run {gaps['eager_grads']:.3g}), params "
           f"{gaps['graph_params']:.3g} ({gaps['eager_params']:.3g}); warm-up, capture and "
           f"instantiation {out['capture_s']} s (of it the end and instantiation "
           f"{out['capture_end_s']} s); "
           f"steps eager {out['eager_step_s']} s, graph "
           f"{out['graph_step_s']} s; in turns eager {turns['eager']} graph {turns['graph']} "
           f"(medians {med['eager']:.4f} / {med['graph']:.4f} s, {out['speedup']:.2f}x); "
           f"counters {counts}, K4 launches enqueued by the host {k4_host}; peak allocated "
           f"eager {out['eager_peak_gib']:.2f} GiB, over the capture step "
           f"{out['capture_step_peak_gib']:.2f} GiB, reserved with both {out['reserved_gib']:.2f} "
           f"GiB on {smi}")
    return dict(summary=out, msg=msg)


def phase16(scene, dev, smi) -> dict:
    """The wavefront integrator (models/wavefront.py) on the card: the
    known answers in both draw families, the 2K frame against K3, the
    cascade on and off bit for bit, the jax family against the
    megakernel renderer, K4 on the 2K frame's own rays against its plain
    version, the frame's times, iterations, host reads, kernels and busy
    share, and the CLI (the wavefront by default) with a resumed
    checkpoint."""
    import torch

    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.io.checkpoint import _atomic_save, render_image_resumable
    from raytracer_tpu_torch.models import wavefront as wf
    from raytracer_tpu_torch.models.fused import render_image_fused
    from raytracer_tpu_torch.ops import cuda_lane_grid as lg
    from raytracer_tpu_torch.ops import intersect as isect
    from raytracer_tpu_torch.render import iter_spp_accumulation, render_image_chunked
    from raytracer_tpu_torch.utils import ktf, profiling
    from raytracer_tpu_torch.utils import rng as rngu

    t_phase = time.perf_counter()
    with open(EXPECTED) as f:
        expected = json.load(f)

    # 1. Known answers: the preflight frame in both families.
    pre = RenderConfig(**PREFLIGHT)
    known = {}
    for family, field in (("jax", "mean_rgb"), ("ktf", "mean_rgb_ktf")):
        img = wf.render_image_wavefront(scene, showcase_camera(pre),
                                        pre.replace(rng_impl=family), 0)
        mean, want = img.mean().item(), expected[field]
        rel = abs(mean - want) / want
        if not bool(torch.isfinite(img).all()) or rel > PREFLIGHT_RTOL:
            raise AssertionError(f"wavefront preflight ({family}): mean {mean} vs {field} {want} "
                                 f"(rel {rel:.3g}, limit {PREFLIGHT_RTOL}), finite "
                                 f"{bool(torch.isfinite(img).all())}")
        known[family] = dict(mean=mean, expected=want, rel=rel)
    log(16, "known answers (preflight 128x40 spp2 mb12, showcase camera, key 0): " + "; ".join(
        f"{k} mean {v['mean']:.7f} vs {v['expected']:.7f} (rel {v['rel']:.3g}, limit "
        f"{PREFLIGHT_RTOL})" for k, v in known.items()) + f" on {smi}")

    # 2. The 2K frame: counts from 0 just before one frame, read just after.
    cfg = RenderConfig(**MAIN, rng_impl="ktf")
    cam = showcase_camera(cfg)
    wf.render_image_wavefront(scene, cam, cfg, 0)   # warm-up (same shapes)
    torch.cuda.synchronize()
    _reset_counts()
    lg.LAUNCHES["lane_grid"] = lg.PLAIN_CALLS["lane_grid"] = 0
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    before = profiling.totals()
    t0 = time.perf_counter()
    img = wf.render_image_wavefront(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    frame_s = [time.perf_counter() - t0]
    counts = dict(_counts(), lg=lg.LAUNCHES["lane_grid"], lg_plain=lg.PLAIN_CALLS["lane_grid"])
    host_reads, iters = (profiling.totals()[k] - before.get(k, 0)
                         for k in ("host_reads", "wavefront.iterations"))
    peak = torch.cuda.max_memory_allocated()
    for _ in range(P16_FRAMES - 1):
        t0 = time.perf_counter()
        wf.render_image_wavefront(scene, cam, cfg, 0)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    if (counts["k4"] != iters or counts["k2_threefry"] < iters or counts["plain"]
            or counts["lg"] != 1 or counts["lg_plain"]):
        raise AssertionError(f"2K wavefront frame: K4 launches {counts['k4']} (iterations "
                             f"{iters}), K2 launches {counts['k2_threefry']}, plain calls "
                             f"{counts['plain']}, LG launches {counts['lg']}, plain lane grids "
                             f"{counts['lg_plain']}")
    k3 = render_image_fused(scene, cam, cfg, 0)
    bad, mean_diff, max_abs = image_agreement(img, k3)
    n_px = int((img != k3).any(dim=-1).sum())
    if not (bool(torch.isfinite(img).all()) and bad <= IMG_BAD_FRAC and mean_diff <= MEAN_TOL):
        raise AssertionError(f"2K wavefront vs K3: {bad:.4%} elements beyond tolerance, mean "
                             f"diff {mean_diff}, finite {bool(torch.isfinite(img).all())}")
    med = float(np.median(frame_s))
    rays = cfg.width * cfg.height * cfg.spp
    log(16,
        f"2K frame {cfg.width}x{cfg.height} spp{cfg.spp} mb{cfg.max_bounces} (ktf, showcase "
        f"camera, reference scene, key 0) vs K3: "
        f"{bad:.5%} elements beyond 5e-4+2e-4|x| (limit 0.5%), {n_px} of "
        f"{cfg.width * cfg.height} pixels differ, mean diff {mean_diff:.2e}, max abs "
        f"{max_abs:.3g}, means {img.mean().item():.6f} / {k3.mean().item():.6f}; s per frame "
        f"(host clock, synchronized) {_fmt(frame_s)}, median {med:.4f} s "
        f"({rays / med / 1e6:.2f} M camera rays/s); {iters} iterations, host reads "
        f"{host_reads}; K4 launches {counts['k4']}, K2 launches {counts['k2']} (Threefry "
        f"{counts['k2_threefry']}, {counts['k2_threefry'] / max(iters, 1):.2f} per iteration), "
        f"plain calls {counts['plain']}, LG launches {counts['lg']}; peak memory "
        f"{peak / 2**30:.3f} GiB "
        f"({(peak - mem0) / 2**30:.3f} GiB above the scene's {mem0 / 2**30:.3f}) on {smi}")

    # 3. The cascade on and off, bit for bit; 4. the jax family against the
    # megakernel renderer.
    small = RenderConfig(**P16_SMALL)
    scam = showcase_camera(small)
    for family in ("ktf", "jax"):
        c = small.replace(rng_impl=family)
        on = wf.render_image_wavefront(scene, scam, c, 0)
        off = wf.render_image_wavefront(scene, scam, c.replace(drain_cascade=()), 0)
        if not torch.equal(on, off):
            raise AssertionError(f"wavefront cascade on != off ({family}, "
                                 f"{int((on != off).any(-1).sum())} pixels)")
    jax_cfg = small.replace(rng_impl="jax")
    cap_jax = k2_captured(rngu, P16_K2_CAPTURE_FROM, jax_keyed_call)
    try:
        wj = wf.render_image_wavefront(scene, scam, jax_cfg, 0)
    finally:
        rngu.threefry2x32_kernel = cap_jax["real"]
    with torch.no_grad():
        mk = render_image_chunked(scene, scam, jax_cfg, 0)
    bad_j, mean_diff_j, max_abs_j = image_agreement(wj, mk)
    if not (bool(torch.isfinite(wj).all()) and bad_j <= IMG_BAD_FRAC and mean_diff_j <= MEAN_TOL):
        raise AssertionError(f"wavefront (jax) vs megakernel: {bad_j:.4%} elements beyond "
                             f"tolerance, mean diff {mean_diff_j}")
    log(16,
        f"{small.width}x{small.height} spp{small.spp} mb{small.max_bounces}: cascade on == off "
        f"bitwise in both families; jax family vs render_image_chunked {bad_j:.4%} elements "
        f"beyond tolerance, mean diff {mean_diff_j:.2e}, max abs {max_abs_j:.3g} on {smi}")

    # 5. K4 on the 2K frame's own rays: one bounce of the first stage.
    calls, got = [], {}
    real = isect.trace_closest

    def record(o, d, bvh, t_lim, t_min, **kw):
        if len(calls) == P16_CAPTURE_CALL:
            got["rays"] = (o.clone(), d.clone(), t_lim.clone(), t_min)
        calls.append(o.shape[0])
        return real(o, d, bvh, t_lim, t_min, **kw)

    isect.trace_closest = record
    cap_ktf = k2_captured(ktf, P16_K2_CAPTURE_FROM, ktf_per_lane_call)
    try:
        wf.render_image_wavefront(scene, cam, cfg, 0)
    finally:
        isect.trace_closest = real
        ktf.threefry2x32_kernel = cap_ktf["real"]
    o, d, t_lim, t_min = got["rays"]
    n_lanes = calls[0]
    if o.shape[0] != n_lanes or not bool((t_lim < 0).any()):
        raise AssertionError(f"phase 16: K4 call {P16_CAPTURE_CALL} has {o.shape[0]} rays (the "
                             f"first stage {n_lanes}), {int((t_lim < 0).sum())} at limit -1")
    k4 = phase8_set("wavefront 2K", o, d, scene.bvh4, t_lim, t_min, 16)
    log(16,
        f"K4 on the 2K frame's call {P16_CAPTURE_CALL} ({k4['rays']} rays, {k4['dead']} at the "
        f"limit -1, {k4['hits']} hits): {'; '.join(k4['checks'])}: all hold (plain on "
        f"{k4['subset']} seeded rays); in turns, median ms per call: "
        + "; ".join(f"{k} {m[0]:.4f}" for k, m in k4["ms"].items())
        + f"; bound {k4['bound']['bound_ms']:.5f} ms ({k4['bound']['bound_by']}), culled "
        f"{k4['bound_cull']['bound_ms']:.5f} ms; the frame's K4 calls by size: "
        + ", ".join(f"{size} x{calls.count(size)}" for size in sorted(set(calls), reverse=True))
        + f" on {smi}")

    # K2 on the frames' own counters: a ktf block of the 2K frame (one key,
    # per-lane sample and bounce) and a jax-family fold of the 256x144
    # frame (the keyed entry: per-lane keys and data).
    int32_rate, _ = _int32_ops_per_s()
    k2 = {}
    for name, cap, frame in (("ktf", cap_ktf, "2K"), ("jax_keyed", cap_jax, "256x144")):
        if "args" not in cap:
            raise AssertionError(f"phase 16: no K2 call of the {frame} frame ({name}) from call "
                                 f"{P16_K2_CAPTURE_FROM} on had per-lane counters "
                                 f"({cap['calls']} calls)")
        k2[name] = dict(k2_held(cap["args"], int32_rate), frame=frame, call=cap["call"],
                        calls=cap["calls"])
    log(16, "K2 on the wavefront's own counters, bit for bit against the plain Threefry on the "
            "same card tensors: " + "; ".join(
                f"{k} (the {v['frame']} frame's call {v['call']} of {v['calls']}, {v['lanes']} "
                f"lanes, " + (f"{v['distinct_keys']} distinct keys, keyed entry"
                              if v["keyed"] else f"{v['distinct_samples']} samples and "
                              f"{v['distinct_bounces']} bounces, one key")
                + f"): equal; kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound "
                f"{v['bound_ms']:.5f} ms ({v['bound_by']})" for k, v in k2.items())
        + f" on {smi}")

    # 6. One 2K frame under torch.profiler.
    prof = kernels_launched(lambda: wf.render_image_wavefront(scene, cam, cfg, 0))
    if not prof:
        raise AssertionError("phase 16: torch.profiler recorded no device activity")
    by_name = prof["busy_by_name"]
    k4_us = sum(v for k, v in by_name.items() if "trace_closest_kernel" in k)
    k4_n = sum(v for k, v in prof["names"].items() if "trace_closest_kernel" in k)
    k2_us = sum(v for k, v in by_name.items() if "ktf_threefry" in k)
    k2_n = sum(v for k, v in prof["names"].items() if "ktf_threefry" in k)
    busy_share = prof["busy_us"] / prof["span_us"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(16,
        f"one 2K frame under torch.profiler: {prof['kernels']} kernels ({prof['activities']} "
        f"with memsets and copies), the card busy {prof['busy_us'] / 1e3:.1f} ms of a "
        f"{prof['span_us'] / 1e3:.1f} ms span (busy share {busy_share:.3f}, idle share "
        f"{1 - busy_share:.3f}); K4 {k4_n} launches, {k4_us / 1e3:.1f} ms "
        f"({k4_us / prof['busy_us']:.3f} of the busy time); K2 Threefry {k2_n} launches, "
        f"{k2_us / 1e3:.1f} ms ({k2_us / prof['busy_us']:.3f}); the busiest: "
        + "; ".join(f"{k[:60]} {v / 1e3:.1f} ms" for k, v in top) + f" on {smi}")

    # 7. The CLI (no --integrator: the wavefront) and a resumed checkpoint.
    os.makedirs(os.path.join(ROOT, "renders"), exist_ok=True)
    paths = {k: os.path.join("renders", f"chip_smoke_wavefront_{k}")
             for k in ("cli.png", "cli.npy", "resumed.png", "resumed.npy", "half.npz",
                       "whole.npz")}
    for k in ("half.npz", "whole.npz"):
        if os.path.exists(os.path.join(ROOT, paths[k])):
            os.remove(os.path.join(ROOT, paths[k]))
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.cli", "--scene", "cornell_bunny",
           "--width", str(P16_CLI["width"]), "--height", str(P16_CLI["height"]),
           "--spp", str(P16_CLI["spp"]), "--max-bounces", str(P16_CLI["max_bounces"])]
    t0 = time.perf_counter()
    out = subprocess.run(cmd + ["--out", paths["cli.png"], "--npy", paths["cli.npy"]], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, paths["cli.png"]), "rb") as f:
        head = f.read(8)
    if out.returncode != 0 or head != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"CLI (default integrator) failed ({out.returncode}): "
                             f"{out.stderr[-2000:]}")
    ccfg = RenderConfig(**P16_CLI)
    ccam = showcase_camera(ccfg)
    done, first = next(iter_spp_accumulation(scene, ccam, ccfg, 0,
                                             spp_per_batch=ccfg.spp // 2))
    _atomic_save(os.path.join(ROOT, paths["half.npz"]), acc=first.cpu().numpy(),
                 spp_done=np.int64(done), spp_total=np.int64(ccfg.spp), seed_hash=np.int64(0),
                 rng_stream=np.str_("jax"))
    out = subprocess.run(cmd + ["--checkpoint", paths["half.npz"], "--out", paths["resumed.png"],
                                "--npy", paths["resumed.npy"]], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"CLI --checkpoint failed ({out.returncode}): {out.stderr[-2000:]}")
    whole = render_image_resumable(scene, ccam, ccfg, 0, os.path.join(ROOT, paths["whole.npz"]),
                                   spp_per_batch=ccfg.spp // 2).cpu().numpy()
    resumed = np.load(os.path.join(ROOT, paths["resumed.npy"]))
    direct = torch.from_numpy(np.load(os.path.join(ROOT, paths["cli.npy"])))
    with np.load(os.path.join(ROOT, paths["half.npz"])) as z:
        finished = int(z["spp_done"])
    bad_c, mean_diff_c, _ = image_agreement(torch.from_numpy(resumed), direct)
    if not (np.array_equal(resumed, whole) and finished == ccfg.spp
            and bad_c <= IMG_BAD_FRAC and mean_diff_c <= MEAN_TOL):
        raise AssertionError(f"CLI resume: resumed == uninterrupted "
                             f"{np.array_equal(resumed, whole)}, spp_done {finished}, vs the "
                             f"direct render {bad_c:.4%} beyond tolerance, mean diff "
                             f"{mean_diff_c}")
    log(16,
        f"CLI without --integrator (the wavefront) cornell_bunny {ccfg.width}x{ccfg.height} "
        f"spp{ccfg.spp} mb{ccfg.max_bounces} wrote {paths['cli.png']} in {cli_s:.1f} s; "
        f"--checkpoint from a checkpoint of {done} of {ccfg.spp} samples == the uninterrupted "
        f"resumable render bitwise (and within the image tolerance of the direct render: "
        f"{bad_c:.4%} beyond, mean diff {mean_diff_c:.2e}); phase "
        f"{time.perf_counter() - t_phase:.1f} s on {smi}")

    summary = dict(
        known=known, frame_s=frame_s, median_s=med, mrays_per_s=rays / med / 1e6,
        iterations=iters, host_reads=host_reads, launches=counts, vs_k3=dict(
            bad=bad, mean_diff=mean_diff, max_abs=max_abs, pixels_differing=n_px),
        peak_bytes=peak, scene_bytes=mem0, kernels=prof["kernels"],
        activities=prof["activities"], busy_us=prof["busy_us"], span_us=prof["span_us"],
        busy_share=busy_share, k4_share=k4_us / prof["busy_us"], k4_profiled=k4_n,
        k2_share=k2_us / prof["busy_us"], k2_profiled=k2_n,
        k4_calls_by_size={str(k): calls.count(k) for k in sorted(set(calls), reverse=True)},
        k4_on_wavefront_rays={k: v for k, v in k4.items() if k != "profile"},
        k2_on_wavefront_counters=k2)
    return dict(summary=summary, k4=k4, k2=k2, counts=counts)


def sharded_launches(counts: dict) -> dict:
    """{kernel row: {sharded path: launches}} from phase 17's counts (each
    path's counters from 0 just before its one frame or render)."""
    fused = {k: v for k, v in counts.items() if k.startswith("fused")}
    k3 = {k: v["k3"] for k, v in fused.items() if not k.endswith("k5")}
    rest = {k: v for k, v in counts.items() if k not in fused}
    return {
        "K3": k3, "K5": {k: v["k5"] for k, v in fused.items() if k.endswith("k5")},
        "K1": {**{f"{k} (K3)": v for k, v in k3.items()},
               **{f"{k} (K4)": v["k4"] for k, v in rest.items()}},
        "K2": {**{f"{k} (inline in K3)": v for k, v in k3.items()},
               **{k: v["k2_threefry"] for k, v in rest.items()}},
        "K2-camera": {k: v["k2_camera"] for k, v in rest.items()},
        "K2-bounce": {k: v["k2_bounce"] for k, v in rest.items()},
        "K4": {k: v["k4"] for k, v in rest.items()},
        "K4-sort": {k: v["k4_sorted"] for k, v in rest.items()},
    }


def _cards(k: int) -> list:
    """The first k cards, one device each."""
    import torch

    return [torch.device("cuda", i) for i in range(k)]


def _balance(iters: list):
    """max/mean of the shards' post-rebalance iterations (None when no
    shard had any)."""
    return max(iters) / (sum(iters) / len(iters)) if sum(iters) else None


def _counted(fn):
    """fn() with every launch counter from 0 just before it → (result,
    launches of K3, K5, K4 (unsorted and sorted), the key kernel and K2,
    plain calls)."""
    import torch

    from raytracer_tpu_torch.ops import cuda_megakernel

    _reset_counts()
    _reset_fused_counts()
    out = fn()
    torch.cuda.synchronize()
    c = _counts()
    c.update(k3=cuda_megakernel.LAUNCHES["render_fused"],
             k5=cuda_megakernel.LAUNCHES["render_fused_g2"],
             plain=c["plain"] + cuda_megakernel.PLAIN_CALLS["render_plain"])
    return out, c


def _spawn_ranks(n: int, outdir: str, size: str, timeout: int, device: str = "cuda") -> list:
    """`n` processes of parallel/multihost_demo on this card (gloo), each
    with its own timeout; raises if any fails, hangs or exits non-zero."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-m", "raytracer_tpu_torch.parallel.multihost_demo",
                               addr, str(n), str(r), outdir, "--device", device, "--size", size],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    logs, failed = [], []
    t_end = time.perf_counter() + timeout
    for r, p in enumerate(procs):
        try:
            log_r, _ = p.communicate(timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log_r, _ = p.communicate()
            failed.append(f"rank {r} hung past {timeout} s")
        logs.append(log_r)
        if p.returncode != 0:
            failed.append(f"rank {r} exited {p.returncode}: {log_r[-2000:]}")
    if failed:
        raise AssertionError("two processes on the card: " + "; ".join(failed))
    return logs


def phase17(scene, dev, smi, cards: int = 0) -> dict:
    """The multi-device layer (parallel/): the fused render sharded 1, 2
    and 4 ways and 2 ways with K5, the sharded and the rebalanced
    wavefront, the differentiable render sharded, the 2D mesh, the
    mesh-sharded train step, processes through torch.distributed, and
    the CLI's --sharded. With cards=0 (phase 17) on one card listed once
    per shard, two processes on gloo; with cards=N (phase 18) over N
    distinct cards (1, 2 and N shards; the wavefront, the train step and
    the processes N-wide, one process per card on nccl)."""
    import torch

    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.models.fused import render_image_fused
    from raytracer_tpu_torch.models.wavefront import render_image_wavefront
    from raytracer_tpu_torch.parallel import multihost_demo
    from raytracer_tpu_torch.parallel import sharding as sh
    from raytracer_tpu_torch.render import render_image

    t_phase = time.perf_counter()
    checks, counts, msgs = {}, {}, []
    wide = cards or 2

    def mesh_of(k):
        return sh.make_mesh(_cards(k) if cards else [dev] * k)

    def record(name, shards, bitwise, seconds, **extra):
        checks[name] = dict(shards=shards, bitwise=bitwise, seconds=seconds, **extra)

    # 1. The fused path loop at full width: 1, 2 and 4 shards, and K5.
    # Each checked once with its counts from 0, then all timed in turns
    # with the unsharded frame.
    cfg = RenderConfig(**MAIN, rng_impl="ktf")
    cam = showcase_camera(cfg)
    want = render_image_fused(scene, cam, cfg, 0, interleave=1)
    frames = {"unsharded": lambda: render_image_fused(scene, cam, cfg, 0, interleave=1)}
    for shards, g in ((1, 1), (2, 1), (cards or 4, 1), (2, 2)):
        mesh = mesh_of(shards)
        name = f"fused_{shards}" + ("_k5" if g == 2 else "")
        frames[name] = (lambda m, k: lambda: sh.render_image_fused_sharded(
            scene, cam, cfg, 0, mesh=m, kernel_interleave=k))(mesh, g)
        frames[name]()   # warm-up
        got, c = _counted(frames[name])
        key = "k3" if g == 1 else "k5"
        if not torch.equal(got, want) or c[key] != shards or c["plain"]:
            raise AssertionError(f"fused sharded {shards} ways (interleave {g}): bitwise "
                                 f"{torch.equal(got, want)} "
                                 f"({int((got != want).any(-1).sum())} pixels differ), "
                                 f"{key.upper()} launches {c[key]}, plain calls {c['plain']}")
        record(name, shards, True, None, **{f"{key}_launches_per_frame": c[key]})
        counts[name] = c
    turns = _frames_in_turns(frames, P17_FRAMES)
    for name in checks:
        host, stream = turns[name]
        checks[name].update(seconds=float(np.median(host)), frames_s=host, stream_s=stream,
                            unsharded_frames_s=turns["unsharded"][0])
    msgs.append("fused 2K, in turns, s per frame (host clock): unsharded "
                f"{_fmt(turns['unsharded'][0])}; " + "; ".join(
                    f"{k}: {_fmt(v['frames_s'])}, "
                    f"{v.get('k3_launches_per_frame', v.get('k5_launches_per_frame'))} launches"
                    for k, v in checks.items()) + "; each == render_image_fused bitwise")

    # 2. The wavefront at the same frame: sharded (packets interleaved), and
    # rebalanced.
    want = render_image_wavefront(scene, cam, cfg, 0)
    mesh2 = mesh_of(wide)
    wf_name, rb_name = f"wavefront_{wide}", f"rebalanced_{wide}"
    frames = {"unsharded": lambda: render_image_wavefront(scene, cam, cfg, 0),
              wf_name: lambda: sh.render_image_wavefront_sharded(scene, cam, cfg, 0, mesh=mesh2),
              rb_name: lambda: sh.render_image_wavefront_rebalanced(
                  scene, cam, cfg, 0, mesh=mesh2, rebalance_div=P17_REBALANCE_DIV,
                  report_iters=True)}
    for name in (wf_name, rb_name):
        got, c = _counted(frames[name])
        if name == rb_name:
            got, iters = got
        if not torch.equal(got, want) or c["plain"] or not (c["k4"] and c["k2_threefry"]):
            raise AssertionError(f"{name}: bitwise {torch.equal(got, want)} "
                                 f"({int((got != want).any(-1).sum())} pixels differ), launches "
                                 f"{c}")
        counts[name] = c
        record(name, wide, True, None, k4_launches=c["k4"], k2_launches=c["k2"])
    it = iters.tolist()
    checks[rb_name].update(rebalance_div=P17_REBALANCE_DIV, iterations=it,
                           max_over_mean=_balance(it))
    turns = _frames_in_turns(frames, P17_FRAMES)
    for name in (wf_name, rb_name):
        checks[name].update(seconds=float(np.median(turns[name][0])), frames_s=turns[name][0],
                            unsharded_frames_s=turns["unsharded"][0])
    msgs.append(f"wavefront 2K, in turns, s per frame: unsharded {_fmt(turns['unsharded'][0])}; "
                + "; ".join(f"{k} {_fmt(checks[k]['frames_s'])} (K4 {checks[k]['k4_launches']}, "
                            f"K2 {checks[k]['k2_launches']} launches)"
                            for k in (wf_name, rb_name))
                + f"; post-rebalance iterations {it} (max/mean {_balance(it)}); both == "
                f"render_image_wavefront bitwise")

    # 3. The differentiable renderer sharded: INVERSE_r05's frame and the CLI's.
    inv_scene, inv_cfg, inv_cam, inv_keys, inv_targets, inv_params = inverse_setup(dev, P10, 1)
    cli_cfg = RenderConfig(**P17_CLI)
    cli_cam = showcase_camera(cli_cfg)
    for name, (sc, c_, cm) in (("differentiable_inverse_r05", (inv_scene, inv_cfg, inv_cam)),
                               ("differentiable_cli", (scene, cli_cfg, cli_cam))):
        with torch.no_grad():
            want_d = render_image(sc, cm, c_, 0)
        t0 = time.perf_counter()
        got, c = _counted(lambda: sh.render_image_sharded(sc, cm, c_, 0, mesh=mesh2))
        secs = time.perf_counter() - t0
        if not torch.equal(got, want_d) or c["plain"] or not (
                c["k4_sorted"] and c["k2_camera"] and c["k2_bounce"]):
            raise AssertionError(f"{name}: render_image_sharded {wide} ways bitwise "
                                 f"{torch.equal(got, want_d)} "
                                 f"({int((got != want_d).any(-1).sum())} pixels differ), "
                                 f"launches {c}")
        counts[name] = c
        record(name, wide, True, secs,
               size=f"{c_.width}x{c_.height} spp{c_.spp} mb{c_.max_bounces}",
               k4_launches=c["k4"], k4_sorted_launches=c["k4_sorted"], k2_launches=c["k2"])

    # 4. The 2D mesh, 2 x 2, both integrators.
    mesh2d = sh.make_mesh_2d(2, 2, mesh_of(4).devices)
    for integ, single in (("megakernel", render_image), ("wavefront", render_image_wavefront)):
        with torch.no_grad():
            want_2 = single(scene, cli_cam, cli_cfg, 0)
        t0 = time.perf_counter()
        got = sh.render_image_sharded_2d(scene, cli_cam, cli_cfg, 0, mesh=mesh2d,
                                         integrator=integ)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        err = (got - want_2).abs()
        if not bool((err <= P17_2D_ATOL + P17_2D_RTOL * want_2.abs()).all()):
            raise AssertionError(f"2D mesh ({integ}): max abs diff {err.max().item()}")
        record(f"mesh_2d_{integ}", 4, torch.equal(got, want_2), secs,
               max_abs_diff=err.max().item())

    # 5. The mesh-sharded train step: 3 steps of the unsharded trajectory,
    # each step also taken by the sharded step from the same params and
    # Adam state. (Two free-running trajectories part: a step's output
    # is a discontinuous function of the camera pose, so the shards'
    # summation order, ~1e-7 in the loss, grew to 4.5e-5 in the loss and
    # 9e-4 in the params by step 3 on an NVIDIA H100 80GB HBM3 at 700 W;
    # they are run and recorded too.)
    target = inv_targets[0]
    key = (inv_keys[0][0], inv_keys[1][0])
    kw = dict(lr=P10_LR, lr_scales=P10_LR_SCALES)
    step1 = inverse.make_train_step(inv_scene, inv_cam, inv_cfg, target, **kw)
    step2 = inverse.make_train_step(inv_scene, inv_cam, inv_cfg, target, mesh=mesh2, **kw)
    params, state = dict(inv_params), inverse.adam_init(inv_params)
    free_p, free_s = dict(inv_params), inverse.adam_init(inv_params)
    rows = []
    for i in range(P10_STEPS):
        times = {}
        for name, step in (("unsharded", step1), ("sharded", step2)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, state, key)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0, out)
        (s1, (p1, st1, l1)), (s2, (p2, _, l2)) = times["unsharded"], times["sharded"]
        free_p, free_s, free_l = step2(free_p, free_s, key)
        rows.append(dict(
            loss=l1.item(), sharded_loss=l2.item(),
            loss_rel=abs(l2.item() - l1.item()) / abs(l1.item()),
            params_max_abs_diff={k: (p1[k] - p2[k]).abs().max().item() for k in p1},
            s=s1, sharded_s=s2, free_running_loss=free_l.item(),
            free_running_params_max_abs_diff=max((p1[k] - free_p[k]).abs().max().item()
                                                 for k in p1)))
        params, state = p1, st1
    loss_rel = max(r["loss_rel"] for r in rows)
    p_err = max(max(r["params_max_abs_diff"].values()) for r in rows)
    if loss_rel > P17_LOSS_RTOL or p_err > P17_PARAM_ATOL:
        raise AssertionError(f"mesh-sharded train step against the unsharded step from the same "
                             f"inputs: {rows}")
    record(f"train_step_{wide}", wide, loss_rel == 0 and p_err == 0,
           float(np.median([r["sharded_s"] for r in rows[1:]])),
           unsharded_s=float(np.median([r["s"] for r in rows[1:]])), steps=rows,
           loss_max_rel=loss_rel, params_max_abs_diff=p_err, fields=sorted(inv_params))

    # 6. Processes through torch.distributed, after this process built the
    # kernels: two on the one card (gloo), or one per card (nccl).
    backend = "nccl" if cards else "gloo"
    outdir = os.path.join(ROOT, "renders", "chip_smoke_ranks")
    os.makedirs(outdir, exist_ok=True)
    for f in os.listdir(outdir):
        os.remove(os.path.join(outdir, f))
    t0 = time.perf_counter()
    _spawn_ranks(wide, outdir, "card", P17_RANK_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    ranks = [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(wide)]
    prob = multihost_demo.problem("card", dev)
    ref = multihost_demo.run(mesh2, prob)
    rcfg, rcam = prob["render"]
    with torch.no_grad():
        single_img = render_image(prob["scene"], rcam, rcfg, multihost_demo.SEED).cpu().numpy()
    bcfg, bcam = prob["rebalance"]
    single_wf = render_image_wavefront(prob["scene"], bcam, bcfg, multihost_demo.SEED).cpu().numpy()
    r0 = ranks[0]
    ranks_same = all(np.array_equal(r0[k], r[k]) for r in ranks[1:] for k in r0
                     if k not in ("seconds", "device"))
    p_err2 = max(float(np.abs(r0[k] - ref[k]).max()) for k in ref if k.startswith("param_"))
    loss_rel2 = abs(float(r0["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
    ok = dict(ranks_equal=ranks_same, render=np.array_equal(r0["img"], single_img),
              rebalanced=np.array_equal(r0["rebalanced"], single_wf),
              train=loss_rel2 <= P17_LOSS_RTOL and p_err2 <= P17_PARAM_ATOL,
              backend=str(r0["backend"]) == backend)
    if not all(ok.values()):
        raise AssertionError(f"{wide} processes: {ok} (backend {r0['backend']}, train loss rel "
                             f"{loss_rel2:.3g}, params max |diff| {p_err2:.3g})")
    it2 = r0["iters"].tolist()
    record(f"processes_{wide}", wide, ok["render"] and ok["rebalanced"], ranks_s, backend=backend,
           rank_seconds=r0["seconds"].tolist(), in_process_seconds=ref["seconds"].tolist(),
           rebalance_iterations=it2, max_over_mean=_balance(it2), train_loss_rel=loss_rel2,
           train_params_max_abs_diff=p_err2)

    # 7. The CLI's --sharded (over every visible card).
    png, npy = (os.path.join("renders", f"chip_smoke_sharded.{x}") for x in ("png", "npy"))
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.cli", "--sharded", "--scene", "cornell_bunny",
           "--width", str(cli_cfg.width), "--height", str(cli_cfg.height), "--spp",
           str(cli_cfg.spp), "--max-bounces", str(cli_cfg.max_bounces), "--out", png, "--npy", npy]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, png), "rb") as f:
        head = f.read(8)
    with torch.no_grad():
        want_c = render_image(scene, cli_cam, cli_cfg, 0).cpu().numpy()
    if out.returncode != 0 or head != b"\x89PNG\r\n\x1a\n" or not np.array_equal(
            np.load(os.path.join(ROOT, npy)), want_c):
        raise AssertionError(f"CLI --sharded failed ({out.returncode}): {out.stderr[-2000:]}")
    record("cli_sharded", torch.cuda.device_count(), True, cli_s, png=png)

    msgs.append("; ".join(f"{k}: {v['shards']} shards, bitwise {v['bitwise']}, {v['seconds']:.4f} s"
                          for k, v in checks.items()
                          if not k.startswith(("fused", "wavefront", "rebalanced"))))
    msgs.append(f"phase {time.perf_counter() - t_phase:.1f} s on {smi}")
    return dict(checks=checks, counts=counts, msg=" | ".join(msgs), cards=cards or 1)


def _bitwise_tree(a, b, fields) -> dict:
    """{field: equal bit for bit} of two trees' tensors (on any devices)."""
    import torch

    out = {}
    for f in fields:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        out[f] = bool(x.shape == y.shape and torch.equal(x, y))
    return out


def phase19(scene, dev, smi) -> dict:
    """The LBVH fallback and the LBVH-only route on the card: the assets
    written again equal the committed files; with the native builder made
    to raise NativeUnavailable, the LBVH of the reference scene's tree half
    built on the card equals the CPU's build bit for bit, the collapsed and
    widened BVH8 equals the builder's (CPU), and the fallback tree through
    K3 gives the preflight known answer, equal to K3's plain version bit
    for bit, and a 2K frame within the image tolerance of the native
    tree's (then through K4 on the wavefront, with K4 equal to its plain
    version bit for bit on P19_PLAIN_RAYS bounce rays); a scene that holds
    only the LBVH of all 81,952 triangles goes through
    ops/traverse.intersect_bvh against the K4 route on the native scene
    (65,536 bounce rays: hits, types and ids equal) and through the megakernel renderer (preflight
    frame) against the bvh4 scene; the CLI's --profile writes a trace."""
    import shutil
    import tempfile
    import warnings

    import torch

    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.fused import _fused_pixel_grid, render_image_fused
    from raytracer_tpu_torch.models.wavefront import render_image_wavefront
    from raytracer_tpu_torch.ops import cuda_megakernel
    from raytracer_tpu_torch.ops import cuda_traverse as ct
    from raytracer_tpu_torch.ops import intersect as isect
    from raytracer_tpu_torch.ops.bvh import build_lbvh
    from raytracer_tpu_torch.ops.bvh4 import BIG, build_bvh4, widen_bvh
    from raytracer_tpu_torch.render import render_image_chunked
    from raytracer_tpu_torch.scene import assets, builder, native
    from raytracer_tpu_torch.scene.types import TriMesh
    from raytracer_tpu_torch.utils import profiling

    def lbvh_counts(before: dict) -> dict:
        """The LBVH route's lockstep steps, host reads and traversals since
        `before` (a traversal reads once per step and once more to end)."""
        now = profiling.totals()
        c = {k: now.get(n, 0) - before.get(n, 0) for k, n in (
            ("steps", "lbvh.steps"), ("host_reads", "host_reads"))}
        return dict(c, calls=c["host_reads"] - c["steps"])

    t_phase = time.perf_counter()
    msgs, res = [], {"card": smi}

    # 1. The procedural assets, written again, equal the committed files.
    with tempfile.TemporaryDirectory() as tmp:
        assets.ensure_assets(tmp)
        same = {}
        for name in ASSET_FILES:
            with open(os.path.join(tmp, name), "rb") as f, \
                    open(os.path.join(builder.ASSETS_DIR, name), "rb") as g:
                same[name] = f.read() == g.read()
    if not all(same.values()):
        raise AssertionError(f"ensure_assets into an empty directory differs from the committed "
                             f"files: {same}")
    msgs.append("ensure_assets into an empty directory: " + ", ".join(same)
                + " byte for byte the committed files")

    # 2. The native builder forced to raise NativeUnavailable.
    native_scene = builder.reference_scene()
    mesh = native_scene.mesh
    brute_ids, tree_ids = builder.partition_brute_faces(mesh)
    keep = torch.from_numpy(tree_ids)
    sub = TriMesh(vertices=mesh.vertices, faces=mesh.faces[keep], face_mat=mesh.face_mat[keep])
    t0 = time.perf_counter()
    lb_cpu = build_lbvh(sub)
    cpu_s = time.perf_counter() - t0
    sub_d = sub.to(dev)
    build_lbvh(sub_d)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lb_dev = build_lbvh(sub_d)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    eq_lbvh = _bitwise_tree(lb_dev, lb_cpu, ("left", "right", "node_min", "node_max",
                                              "prim_index"))
    if not all(eq_lbvh.values()):
        raise AssertionError(f"build_lbvh on the card vs the CPU: {eq_lbvh}")

    real = native.build_bvh4_native

    def unavailable(*a, **k):
        raise native.NativeUnavailable("forced by chip_smoke phase 19")

    native.build_bvh4_native = unavailable
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            fb_cpu = builder.reference_scene()
            fb_s = time.perf_counter() - t0
    finally:
        native.build_bvh4_native = real
    said = [str(w.message) for w in caught if "native builder is unavailable" in str(w.message)]
    b8 = fb_cpu.bvh4
    t0 = time.perf_counter()
    b4_dev = build_bvh4(sub, lb_dev)
    collapse_s = time.perf_counter() - t0
    b8_dev = widen_bvh(b4_dev, 8)
    eq_b8 = _bitwise_tree(b8_dev, b8, ("bounds", "children", "tri", "face_mat"))
    pi = b8_dev.prim_index.numpy()
    eq_b8["prim_index (remapped)"] = bool(np.array_equal(
        np.where(pi >= 0, tree_ids[np.maximum(pi, 0)], -1), b8.prim_index.numpy()))
    eq_b8["stack_depth"] = b8_dev.stack_depth == b8.stack_depth
    if not (said and b8.builder == "lbvh" and native_scene.bvh4.builder == "native"
            and all(eq_b8.values())):
        raise AssertionError(f"fallback: warned {said}, builders {native_scene.bvh4.builder} / "
                             f"{b8.builder}, the card's collapse vs the builder's: {eq_b8}")
    res.update(lbvh_tris=int(sub.num_tris), lbvh_internal_nodes=int(lb_dev.left.shape[0]),
               lbvh_build_card_s=dev_s, lbvh_build_cpu_s=cpu_s, collapse_s=collapse_s,
               bvh4_nodes=int(b4_dev.children.shape[0]), bvh8_nodes=int(b8.children.shape[0]),
               stack_depth=b8.stack_depth,
               native_bvh8_nodes=int(native_scene.bvh4.children.shape[0]),
               native_stack_depth=native_scene.bvh4.stack_depth, fallback_scene_build_s=fb_s)
    msgs.append(f"native builder forced to raise NativeUnavailable (monkeypatched in this phase; "
                f"the builder warned: {said[0]!r}); trees: the native scene's by "
                f"'{native_scene.bvh4.builder}' (BVH8 {res['native_bvh8_nodes']} nodes, stack "
                f"{res['native_stack_depth']}), the fallback scene's by '{b8.builder}' (LBVH of "
                f"{res['lbvh_tris']} tris, {res['lbvh_internal_nodes']} internal nodes -> BVH4 "
                f"{res['bvh4_nodes']} nodes -> BVH8 {res['bvh8_nodes']} nodes, stack "
                f"{res['stack_depth']}); build_lbvh on the card {dev_s:.4f} s, on the CPU "
                f"{cpu_s:.4f} s, bitwise equal ({', '.join(eq_lbvh)}); collapse "
                f"{collapse_s:.3f} s; "
                f"the card's collapsed and widened BVH8 == the builder's ({', '.join(eq_b8)}); "
                f"the whole fallback scene build {fb_s:.2f} s")
    fb = fb_cpu.to(dev)

    # 3. The fallback tree through K3: the preflight known answer.
    with open(EXPECTED) as f:
        expected = json.load(f)["mean_rgb_ktf"]
    pre = RenderConfig(**PREFLIGHT)
    _reset_fused_counts()
    img = render_image_fused(fb, showcase_camera(pre), pre, 0)
    torch.cuda.synchronize()
    mean = img.mean().item()
    rel = abs(mean - expected) / expected
    k3 = cuda_megakernel.LAUNCHES["render_fused"]
    if not bool(torch.isfinite(img).all()) or rel > PREFLIGHT_RTOL or k3 < 1 or \
            cuda_megakernel.PLAIN_CALLS["render_plain"]:
        raise AssertionError(f"fallback tree preflight: mean {mean} vs {expected} (rel {rel:.3g}), "
                             f"K3 launches {k3}, plain {cuda_megakernel.PLAIN_CALLS}")
    # K3 against its plain version on the same lanes of the fallback tree.
    cam_pre = showcase_camera(pre)
    ppx, ppy, _ = (t.to(dev) for t in _fused_pixel_grid(pre))
    k3_lanes = cuda_megakernel.render_tiles_fused(fb, cam_pre, pre, 0, ppx, ppy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_lanes = cuda_megakernel.render_tiles_fused_plain(fb, cam_pre, pre, 0, ppx, ppy)
    torch.cuda.synchronize()
    k3_plain_s = time.perf_counter() - t0
    if not torch.equal(k3_lanes, plain_lanes):
        lanes_differ = int((k3_lanes != plain_lanes).any(dim=-1).sum())
        raise AssertionError(f"fallback tree, K3 vs plain at the preflight size: {lanes_differ} "
                             f"of {k3_lanes.shape[0]} lanes differ")
    res.update(preflight_mean=mean, preflight_rel=rel, k3_vs_plain_lanes=int(k3_lanes.shape[0]),
               k3_plain_s=k3_plain_s)
    msgs.append(f"fallback tree, preflight 128x40 spp2 mb12 through K3 ({k3} launch): mean "
                f"{mean:.6f} vs {expected:.6f} (rel {rel:.2e}, gate {PREFLIGHT_RTOL}); K3 == its "
                f"plain version bit for bit on all {k3_lanes.shape[0]} lanes (plain "
                f"{k3_plain_s:.2f} s)")

    # 4. Its 2K frame against the native tree's, and both K3 times.
    cfg = RenderConfig(**MAIN)
    cam = showcase_camera(cfg)
    _reset_fused_counts()
    img_fb = render_image_fused(fb, cam, cfg, 0)
    img_nat = render_image_fused(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    k3 = cuda_megakernel.LAUNCHES["render_fused"]
    bad, mean_diff, max_err = image_agreement(img_fb, img_nat)
    differ = int((img_fb != img_nat).any(dim=-1).sum())
    if not (bad <= IMG_BAD_FRAC and mean_diff <= MEAN_TOL and k3 == 2
            and bool(torch.isfinite(img_fb).all())):
        raise AssertionError(f"fallback tree 2K frame vs the native tree's: {bad:.4%} elements "
                             f"beyond tolerance, mean diff {mean_diff}, K3 launches {k3}")
    px, py, _ = (t.to(dev) for t in _fused_pixel_grid(cfg))
    ms = _ms_in_turns({
        "native": lambda: cuda_megakernel.render_tiles_fused(scene, cam, cfg, 0, px, py),
        "lbvh": lambda: cuda_megakernel.render_tiles_fused(fb, cam, cfg, 0, px, py)}, 1, turns=6)
    res.update(frame_2k_bad_frac=bad, frame_2k_mean_diff=mean_diff, frame_2k_max_abs=max_err,
               frame_2k_pixels_differ=differ, k3_2k_ms_native=ms["native"][0],
               k3_2k_ms_lbvh=ms["lbvh"][0])
    msgs.append(f"fallback tree 2K spp8 mb20 K3 frame vs the native tree's: {differ} of "
                f"{cfg.width * cfg.height} pixels differ, {bad:.4%} elements beyond "
                f"5e-4+2e-4|x| (limit 0.5%), mean diff {mean_diff:.2e}, max abs {max_err:.3g}; K3 "
                f"alone in turns, median of 6 [min-max] ms: native tree {ms['native'][0]:.2f} "
                f"[{ms['native'][1]:.2f}-{ms['native'][2]:.2f}], fallback tree "
                f"{ms['lbvh'][0]:.2f} [{ms['lbvh'][1]:.2f}-{ms['lbvh'][2]:.2f}]")

    # 5. The fallback tree through K4 on the wavefront (ktf): against its K3 frame.
    _reset_counts()
    t0 = time.perf_counter()
    img_wf = render_image_wavefront(fb, cam, cfg.replace(rng_impl="ktf"), 0)
    torch.cuda.synchronize()
    wf_s = time.perf_counter() - t0
    c = _counts()
    bad_w, mean_diff_w, _ = image_agreement(img_wf, img_fb)
    if not (bad_w <= IMG_BAD_FRAC and mean_diff_w <= MEAN_TOL and c["k4"] >= 1
            and c["plain"] == 0):
        raise AssertionError(f"fallback tree wavefront vs its K3 frame: {bad_w:.4%} beyond "
                             f"tolerance, mean diff {mean_diff_w}, counts {c}")
    # K4 (through the coherence sort, as the wavefront calls it) against
    # its plain version on the fallback tree, on seeded bounce rays.
    o_all, d_all = bounce_rays(scene, dev)
    pick = torch.from_numpy(np.sort(np.random.default_rng(190).choice(
        o_all.shape[0], P19_PLAIN_RAYS, replace=False))).to(dev)
    op, dp = o_all[pick].contiguous(), d_all[pick].contiguous()
    k4_checks = {}
    for sort in (True, False):
        got_k4 = ct.trace_closest(op, dp, fb.bvh4, float(BIG), 1e-3, sort=sort)
        want_k4 = ct.trace_closest_plain(op, dp, fb.bvh4, float(BIG), 1e-3, sort=sort)
        k4_checks["sorted" if sort else "unsorted"] = _equal_records(got_k4, want_k4)
    k4_hits = int(want_k4["hit"].sum())
    if any(k4_checks.values()):
        raise AssertionError(f"fallback tree, K4 vs plain on {P19_PLAIN_RAYS} bounce rays: "
                             f"differing fields {k4_checks}")
    res.update(wavefront_2k_s=wf_s, wavefront_k4_launches=c["k4"], wavefront_bad_frac=bad_w,
               k4_vs_plain_rays=P19_PLAIN_RAYS, k4_vs_plain_hits=k4_hits)
    msgs.append(f"fallback tree 2K wavefront (ktf) in {wf_s:.3f} s, K4 launches {c['k4']}, K2 "
                f"Threefry {c['k2_threefry']}, plain calls {c['plain']}: vs its K3 frame "
                f"{bad_w:.4%} elements beyond tolerance, mean diff {mean_diff_w:.2e}; K4 sorted "
                f"and unsorted == its plain version bit for bit (every record field) on "
                f"{P19_PLAIN_RAYS} of phase 8's bounce rays ({k4_hits} hits)")

    # 6. The LBVH-only scene of all 81,952 triangles against the K4 route.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lb_all = build_lbvh(scene.mesh)
    torch.cuda.synchronize()
    lb_all_s = time.perf_counter() - t0
    only = dataclasses.replace(scene, bvh4=None, bvh=lb_all)
    if isect.fused_trace_available(only) or cuda_megakernel.fused_megakernel_available(only):
        raise AssertionError("an LBVH-only scene must not take K3 or trace_frame_fused")
    pick = torch.from_numpy(np.sort(np.random.default_rng(19).choice(
        o_all.shape[0], P19_RAYS, replace=False))).to(dev)
    o, d = o_all[pick].contiguous(), d_all[pick].contiguous()
    ref = isect.intersect_scene(scene, o, d, 1e-3)
    torch.cuda.synchronize()
    _reset_counts()
    before = profiling.totals()
    t0 = time.perf_counter()
    got = isect.intersect_scene(only, o, d, 1e-3)
    torch.cuda.synchronize()
    only_s = time.perf_counter() - t0
    stats = lbvh_counts(before)
    c = _counts()
    hit = ref.hit
    both = hit & got.hit
    t_ok = bool(((got.t[both] - ref.t[both]).abs() <= T_RTOL * ref.t[both].abs()).all())
    flips = int((got.prim_id[both] != ref.prim_id[both]).sum())
    n_hit = int(both.sum())
    if not (torch.equal(got.hit, hit) and torch.equal(got.prim_type, ref.prim_type) and t_ok
            and flips == 0 and c["k4"] == 0 and c["plain"] == 0):
        raise AssertionError(f"LBVH-only intersect_scene vs the K4 route: hit equal "
                             f"{torch.equal(got.hit, hit)}, t within rtol {T_RTOL} {t_ok}, "
                             f"{flips} id flips in {n_hit} hits, counts {c}")
    prof = kernels_launched(lambda: isect.intersect_scene(only, o, d, 1e-3))
    res.update(lbvh_all_build_s=lb_all_s, lbvh_only_rays=P19_RAYS, lbvh_only_hits=n_hit,
               lbvh_only_id_flips=flips, lbvh_only_s=only_s, lbvh_only_steps=stats["steps"],
               lbvh_only_host_reads=stats["host_reads"],
               lbvh_only_kernels=prof.get("kernels"), lbvh_only_busy_us=prof.get("busy_us"),
               lbvh_only_span_us=prof.get("span_us"))
    msgs.append(f"LBVH-only scene (Scene.bvh of all {scene.mesh.num_tris} tris, built on the "
                f"card in {lb_all_s:.4f} s): intersect_scene on {P19_RAYS} of phase 8's bounce "
                f"rays in {only_s:.3f} s, {stats['steps']} lockstep steps, {stats['host_reads']} "
                f"host reads, {prof.get('kernels')} kernels (torch.profiler; the card busy "
                f"{(prof.get('busy_us') or 0) / 1e3:.1f} ms of a "
                f"{(prof.get('span_us') or 0) / 1e3:.1f} ms span), K4 launches {c['k4']}; vs the "
                f"K4 route on the native scene: hit masks and primitive types equal, t within rtol "
                f"{T_RTOL}, {flips} id flips in {n_hit} hits (limit 0)")

    # 7. The megakernel renderer's preflight frame on the LBVH-only scene.
    with torch.no_grad():
        want = render_image_chunked(scene, showcase_camera(pre), pre, 0)
        _reset_counts()
        before = profiling.totals()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_o = render_image_chunked(only, showcase_camera(pre), pre, 0)
        torch.cuda.synchronize()
        mk_s = time.perf_counter() - t0
    stats, c = lbvh_counts(before), _counts()
    bad_o, mean_diff_o, max_o = image_agreement(img_o, want)
    if not (bad_o <= IMG_BAD_FRAC and mean_diff_o <= MEAN_TOL and c["k4"] == 0
            and bool(torch.isfinite(img_o).all())):
        raise AssertionError(f"LBVH-only megakernel frame vs the bvh4 scene's: {bad_o:.4%} beyond "
                             f"tolerance, mean diff {mean_diff_o}, counts {c}")
    res.update(megakernel_preflight_s=mk_s, megakernel_steps=stats["steps"],
               megakernel_host_reads=stats["host_reads"], megakernel_traversals=stats["calls"],
               megakernel_bad_frac=bad_o)
    msgs.append(f"megakernel renderer (jax family) preflight frame on the LBVH-only scene in "
                f"{mk_s:.2f} s ({stats['calls']} traversals, {stats['steps']} steps, "
                f"{stats['host_reads']} host reads, K4 launches {c['k4']}, K2 launches {c['k2']}): "
                f"vs the bvh4 scene's frame {bad_o:.4%} elements beyond tolerance, mean diff "
                f"{mean_diff_o:.2e}, max abs {max_o:.3g}")

    # 8. The CLI's --profile DIR.
    prof_dir = os.path.join(ROOT, "renders", "chip_smoke_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    png = os.path.join("renders", "chip_smoke_profile.png")
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.cli", "--scene", "cornell_bunny",
           "--width", "128", "--height", "64", "--spp", "2", "--max-bounces", "4",
           "--profile", prof_dir, "--out", png]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    recs = [json.loads(ln) for ln in out.stderr.splitlines() if ln.startswith('{"tag"')]
    kernel_events = 0
    if traces:
        with open(os.path.join(prof_dir, traces[0])) as f:
            kernel_events = sum(1 for e in json.load(f).get("traceEvents", [])
                                if e.get("cat") == "kernel")
    if out.returncode != 0 or len(traces) != 1 or not recs or kernel_events < 1:
        raise AssertionError(f"CLI --profile: rc {out.returncode}, traces {traces}, records "
                             f"{recs}, kernel events {kernel_events}: {out.stderr[-2000:]}")
    res.update(profile_trace=traces[0], profile_kernel_events=kernel_events,
               profile_record=recs[-1])
    msgs.append(f"CLI --profile wrote {traces[0]} ({kernel_events} kernel events on the card) "
                f"and logged {recs[-1]}")
    res["phase_s"] = time.perf_counter() - t_phase
    msgs.append(f"phase {res['phase_s']:.1f} s on {smi}")
    return dict(summary=res, msg=" | ".join(msgs))


def phase20(dev, smi) -> dict:
    """The five BASELINE configs through raytracer_tpu_torch.milestones
    (1-4 at their presets, 5 with --quick: 2K, spp 8) and the flagship at
    its full spp through raytracer_tpu_torch.flagship, each with its
    launches counted from 0 just before it: every pixel finite, config
    4's loss falling, the flagship's mean within 2% of FLAGSHIP_r05.json's
    (the JAX package's render of the same frame)."""
    import shutil

    from raytracer_tpu_torch import flagship, milestones
    from raytracer_tpu_torch.ops import cuda_megakernel

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "renders", "chip_smoke_milestones")
    shutil.rmtree(out_dir, ignore_errors=True)
    records, msgs = [], []
    for number in P20_FULL + P20_QUICK:
        _reset_counts()
        _reset_fused_counts()
        argv = ["--out", out_dir, "--only", str(number)] + (["--quick"] if number in P20_QUICK
                                                              else [])
        [rec] = milestones.main(argv)
        c = {**_counts(), "k3": cuda_megakernel.LAUNCHES["render_fused"]}
        rec = milestones.json_record(rec)
        rec.update(launches={k: c[k] for k in ("k4", "k4_sorted", "keys", "k2_threefry",
                                               "k2_camera", "k2_bounce", "plain")},
                   reduced="spp 8 (--quick) of 2000" if number in P20_QUICK else None)
        ok = c["plain"] == 0 and c["k2"] >= 1
        if number == 4:
            ok = ok and rec["loss_last"] < rec["loss_first"]
            what = (f"{rec['steps']} steps in {rec['seconds']:.3f} s, loss {rec['loss_first']:.6f} "
                    f"-> {rec['loss_last']:.6f}")
        else:
            ok = ok and rec["finite"] and (number == 1 or c["k4"] >= 1)
            what = (f"{rec['size'][0]}x{rec['size'][1]} spp {rec['spp']} in {rec['seconds']:.3f} "
                    f"s ({rec['mrays_per_sec']:.2f} M camera rays/s), mean_rgb "
                    + ", ".join(f"{x:.5f}" for x in rec["mean_rgb"]) + f", finite {rec['finite']}")
        if not ok:
            raise AssertionError(f"milestone {number}: {rec}, counts {c}")
        records.append(rec)
        cut = f" (reduced: {rec['reduced']})" if rec["reduced"] else ""
        msgs.append(f"{rec['config']}{cut}: {what}; launches {rec['launches']}")

    with open(FLAGSHIP_REF) as f:
        ref = json.load(f)
    fdir = os.path.join(ROOT, "renders", "chip_smoke_flagship")
    shutil.rmtree(fdir, ignore_errors=True)
    _reset_counts()
    _reset_fused_counts()
    stats = flagship.main([str(FLAGSHIP_SPP), os.path.join(fdir, "flagship_2k.png"),
                           os.path.join(fdir, "flagship_ckpt.npz"), "--stats",
                           os.path.join(fdir, "flagship.json")])
    k3 = cuda_megakernel.LAUNCHES["render_fused"]
    rel = abs(stats["mean_rgb"] - ref["mean_rgb"]) / ref["mean_rgb"]
    want_k3 = -(-FLAGSHIP_SPP // 16)
    if not (stats["finite"] and k3 == want_k3 and cuda_megakernel.PLAIN_CALLS["render_plain"] == 0
            and stats["spp"] == ref["spp"] and rel <= FLAGSHIP_RTOL):
        raise AssertionError(f"flagship: {stats}, K3 launches {k3} (expected {want_k3}), mean vs "
                             f"FLAGSHIP_r05.json {ref['mean_rgb']}: rel {rel:.3g}")
    flag = dict(spp=FLAGSHIP_SPP, wall_s=stats["wall_s_this_run"], mean_rgb=stats["mean_rgb"],
                reference_mean_rgb=ref["mean_rgb"], reference_spp=ref["spp"], rel=rel,
                k3_launches=k3, card=stats["card"])
    msgs.append(f"flagship {stats['width']}x{stats['height']} spp {FLAGSHIP_SPP} mb20 (fused, ktf, "
                f"key 0, 16-spp resumable batches) in {stats['wall_s_this_run']:.2f} s, K3 "
                f"launches {k3}: mean "
                f"{stats['mean_rgb']:.6f} vs FLAGSHIP_r05.json {ref['mean_rgb']} at spp "
                f"{ref['spp']} (rel {rel:.2e}, gate {FLAGSHIP_RTOL})")
    phase_s = time.perf_counter() - t_phase
    msgs.append(f"phase {phase_s:.1f} s on {smi}")
    return dict(summary=dict(card=smi, milestones=records, flagship=flag, phase_s=phase_s),
                msg=" | ".join(msgs))


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (color_neus_torch) on one card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:
  1. device and build: the card's name and power limit; nvcc builds every
     kernel from color_neus_torch/csrc (all at once) while g++ builds the
     repo's csrc/marching_tet.cpp; cuobjdump -sass of rows 3 and 5 must
     show HGMMA (their products on wgmma) and no HMMA.16816.F32.BF16, and a
     bulk copy (UBLKCP: the weight slabs), with 0 bytes of spills in the
     ptxas report, their registers, resident blocks per SM and FCHK / CALL
     counts printed; rows 4 and 6 must show HGMMA and a bulk copy (the
     weight slabs and the weight-grad operands), with 0 bytes of spills,
     their registers printed; rows 3 and 4's save-mode entries
     (ray_march_save_fwd_kernel, ray_march_load_bwd_kernel) are held as
     rows 3 and 4; rows 5 and 6, which the march entries' redesigns left
     as they were, must hold their earlier SASS, instruction for
     instruction (sass_identity_check, under the nvcc release it was
     recorded with); rows 1-2's
     kernel variants (the grid's f32x3 one too) print HMMA, their weight
     ring's bulk copies (UBLKCP), FCHK and every CALL, registers and
     spills, and their resident blocks per SM: the bf16 and f32x3 ones
     must hold HMMA, all a bulk copy, none an FCHK or a CALL (the IEEE
     divide's range check and its slow path), and each variant 16
     resident warps per SM; rows 7-8's bf16 chain kernels (nine
     activations) and deferred kernel must hold HGMMA (wgmma) and no HMMA,
     a bulk copy (UBLKCP), and 0 bytes of spills in the ptxas report,
     their registers printed.
  2. kernels against their plain PyTorch versions, on the card: the SDF
     placement sweep (csrc/sdf_rays.cu), through the sweep function the
     main path uses, at a full-width SDF (8x256, multires 6) taken off its
     geometric init by seeded noise on every leaf (geometric init zeroes
     the PE columns of lin0 and of the skip layer, which would hide a
     misread of them), 1024 rays x 64 sorted z, in all four variants
     (softplus/relu x bf16/f32), plus the up-sample-round shape (S=16)
     and a ragged tail; times kernel and plain version with CUDA events,
     beside the bound (mlp_bound_ms: bytes, products, and the epilogue's
     FP32-pipe and MUFU instructions per element read from a one-element
     SASS probe).
  2b. the evaluation path's kernels against their plain versions, off
     geometric init, timed with CUDA events: the grid SDF (second entry of
     csrc/sdf_rays.cu) in f32 and bf16 on one 2^18-point chunk of the
     512^3 lattice of the synthetic bbox plus a ragged tail; the point
     pipeline (csrc/point_pipeline.cu) for Color-NeuS (no_view_dir +
     relight) and NeuS (idr) on 131,072 points of rays through the sphere
     (one validation chunk, 1024 rays x 128 samples) plus a ragged tail,
     against the plain twin with bf16=True (rows 3-6 compute the TPU
     kernels' bf16 products; RTOL_PIPELINE's note), and beside it the
     distance from the f32 twin, what the precision costs.
  3. the main path: TrainLoop trains Color-NeuS at full width (the MODEL
     section of config/Color_NeuS_dtu.yml: 1024 rays, 64+64 samples, 4
     up-sample rounds) on the synthetic sphere (DATASET, DATA_PRESET and
     TRAIN of config/Color_NeuS_synthetic.yml) for 60 steps, in bundles
     of LOG_INTERVAL = 10 (a warm-up bundle, then replays of the captured
     one). The sweep kernel must launch exactly 4 times per step, every
     loss must be finite, and the mean of the last 5 losses must be below
     half the mean of the first 5. The training phases count executed
     launches: the wrappers' counts, less what a capture recorded, plus
     the captured launches times the replays (launch_counts).
  4. the sweep kernel against its plain version on the trained weights,
     at every sweep of one step: the main path's own rays (sampled pixels
     of the training cameras) and z (coarse, then each up-sample round),
     timed with CUDA events beside the relu variant, the plain version and
     the bound; these are the kernel line's numbers.
  5. where the step's time goes: torch.profiler over a few steps; device
     busy time is the union of the trace's kernel intervals, and the idle
     share is read from the same trace (1 - busy / span).
  2c. the point-pipeline backward (second entry of csrc/point_pipeline.cu)
     against its plain version, off geometric init: Color-NeuS and NeuS
     on the 131,072 points of 1024 rays x 128 samples plus a ragged tail,
     seeded cotangents on all five outputs; pts / dirs grads and every
     weight and bias leaf, against the bf16 twin with the cotangents of
     points near a relu kink zeroed (and, printed without a check, with
     every point's), and the distance from the f32 arithmetic in float64;
     two identical calls bitwise equal; timed with CUDA events beside the
     reduction on its own and the fwd+bwd of the plain autograd core and
     of the autograd Function on the same points.
  6. the evaluation path on phase 3's trained weights: (a) a checkpoint
     recorded to a temporary exp directory and reloaded through the
     evaluate entry (TrainLoop with MODEL.PRETRAINED), every tensor
     bitwise equal; (b) testing_step at res 512, sparse, from the reloaded
     loop: the mesh and coloured PLYs written, both new kernels launched;
     (c) at res 128 the sparse and the dense meshes from the kernel grid
     have bitwise-equal sorted vertex sets, and the kernel grid matches
     the plain grid, and one 2^18-point chunk of the res-512 lattice on
     the trained weights is held and timed in f32 and bf16; (d) the
     vertex colours of (b)'s mesh, kernel against
     plain; (e) the validation render of one training view with fused_core
     auto (kernel) against the same render through the bf16 twin, and
     beside it fused_core off (the f32 plain path), same generator seed;
     (f) phase 3's training launched neither point-pipeline kernel nor the
     grid SDF.
  7. the training path through the point-pipeline kernels: TrainLoop as in
     phase 3 with RENDERER.FUSED_CORE on, 60 steps: every loss finite, the
     loss halves, the sweep launches 4 times, the forward and the backward
     of the pipeline once each per step; steady-state ms/step beside phase
     3's and a 2-step profile; then one step's gradient of every
     parameter leaf on phase 3's trained weights and one batch of the main
     path's pixels, fused_core on (bf16 products) against off (the f32
     plain core), perturb 0: every leaf within RTOL_STEP_GRAD
     (norm-relative) and MIN_COS_STEP_GRAD (cosine).
  2d. the fused march (csrc/ray_march.cu, rows 3 and 4) against its plain
     twins, off geometric init: Color-NeuS and NeuS on 1024 rays x 128
     samples, at the init's inv_s and at one with exact q == 1 ties (their
     count printed); the forward against the bf16 twin per lane group;
     the backward (rays, inv_s, every weight and bias leaf) against the
     composed reference (row 5's outputs, the plain compositing VJP on the
     card, row 6's pullback) and, beside the f32 bf16 twin, against the
     bf16 twin in float64; the distances from the f32 arithmetic printed;
     timed with CUDA events beside the bf16 twins and the composed rows 5
     + 6 + torch compositing. Then the clip's tie rule: 1024 rays x 8
     samples deep inside the surface, every point at q == 1 exactly
     (tie_inputs), the kernel's inv_s gradient against the bf16 twin in
     float64 (a tie gate of 1.0 would double it). The save mode's pair
     (the forward's save entry, which also writes the activation stash,
     and the backward's load entry, which reads it instead of recomputing)
     the same way on the same inputs against the save twins, at the same
     limits, with its stash bytes a point beside the JAX package's, its
     distance from the recompute pair on every leaf, and its times beside
     its bound (no recompute in the backward's MACs, the stash's bytes) and
     its bf16 save twins; and on the tie rays.
  8. the training path through the fused march: as phase 7 with
     RENDERER.FUSED_MARCH on, MARCH_ACTS at its default (auto: the save
     mode at this shape): the save entry and the load entry once each per
     step, the sweep 4 times, no other kernel; ms/step beside phases 3 and
     7, peak memory and a 1-step profile; one step's leaf gradients,
     fused_march on against off (the f32 plain core), at phase 7's limits;
     then a loop with MARCH_ACTS recompute: 20 steps launch the recompute
     pair once each per step, and host ms/step and peak memory of save and
     recompute, interleaved in one process.
  9. the MLP-chain microbenchmark (csrc/mlp_chain.cu, rows 7 and 8): the
     tool's sweep through python -m color_neus_torch.tools.mlp_microbench's
     main at its full shape (1,048,576 rows x 256, 25 layers), launches
     counted; both kernels against their plain versions on the card, every
     variant in bf16 and f32, at L = 1 and at L = 25, the gates at the
     tool's weight 1e-30 and at 1.0, and a ragged 1000 rows; each beside
     its bound (products, bytes, and the epilogue's FP32-pipe and MUFU
     instructions per element, read from the SASS of one-element probes of
     the same device functions), its plain version and the
     same 25 products in cuBLAS without an activation. The f32 chain (six
     bf16 wgmma passes a product) against float64 (f32_chain_gate: layer
     by layer over 25 layers, and every variant at L = 1, beside the plain
     f32 path); the tensor cores' rounding of one m64n128k16 wgmma against
     float64 and the CPU emulator's model (wgmma_truncation); the f32
     chain's weight ring alone, its slabs' rate from L2 (ring_rate).
  10. the dataset path at full width: (a) tools/dataset_replica.py writes
     the blob scene, rendered on the card, as a DTU-format scene (49 views
     at 1600 x 1200, cameras_sphere.npz in a world frame whose scale mats
     map the unit sphere onto the object); the DTU reader reads poses and
     focal back within REPLICA_POSE_ATOL / REPLICA_FOCAL_RTOL and every
     image and mask bitwise, through cv2 where the host has it and through
     the port's own PNG decoder; the seconds to write and to load_all, and
     one decode of a PNG whose rows take filter 3 / 4; (b) TrainLoop on
     config/Color_NeuS_dtu.yml as shipped with FUSED_MARCH on and the
     entry point's default device: 60 steps straight (every loss finite,
     the last 5 below the first 5, 4 sweeps and one march save forward and
     load backward per step, no point-pipeline kernel, peak memory), and 30
     steps stopped by stop_after then resumed by a new TrainLoop from the
     directory's dump_cfg.yaml to 60: every parameter, Adam state, the
     generator and every loss bitwise equal to the straight run's; the
     steady ms/step beside phase 8's; (c) SIGTERM from a timer during run:
     it returns at a step boundary with a checkpoint, and a loop resumed
     from it starts at that step; (d) testing_step at res 512, sparse, on
     the resumed loop: a non-empty mesh inside the replica's world bbox
     (scale_mats[0]), rows 2 and 5 launched; (e) an IHO-format replica (30
     RGBA frames at 960 x 540, a COLMAP model by the port's writers) on
     config/Color_NeuS_iho.yml (focal and poses learnt) with FUSED_MARCH
     on, 20 steps, every loss finite; one step's leaf gradients, the march
     against the f32 plain core, at phase 7's limits, focal.fx / fy and
     pose.r / t included (their gradient comes only through row 4's ray
     cotangents), with per-camera cosines printed.
  11. several steps per dispatch, per training arm (fused_march on in
     the save mode, fused_march on with MARCH_ACTS recompute, fused_core
     on, the save mode in MARCH_BWD_PRECISION bf16 and f32, auto; auto
     with RAY_CHUNK 256 at bench.py's shape only, in a process of its own) at
     phase 3's full width, each fused_march arm's stash GiB printed: one
     uncaptured step
     under torch.cuda.set_sync_debug_mode("error") (nothing in it may wait
     on the card); (a) a replay of the captured bundle against 10
     uncaptured steps from the same state: every parameter, optimizer
     state, the step counter, the generator and the 10 losses bitwise
     (fused_core and auto: bitwise when two uncaptured runs are, else
     within BUNDLE_DISTANCE_FACTOR x their distance, printed beside it);
     (b) two replays under torch.profiler: the sweep 4 times per step and
     the arm's forward and backward kernels once (rows 1, 3, 4 in either
     mode, or 1, 5, 6) by name, busy ms/step and the idle share; (c) host ms/step
     uncaptured / captured / captured / uncaptured, the idle share
     unprofiled (1 - busy / host ms) and peak memory, at the config's
     shape and at bench.py's 2048 x 512 (auto there uncaptured only when
     a captured pool beside its steps would not fit the card); (d) every
     shipped config bundles 10 steps, and phase 10's DTU loop replayed
     its bundle.
  12. MARCH_BWD_PRECISION bf16 and f32 (each mode's rows 3-6 a library of
     their own, built in phase 1 and SASS-checked there, f32's on wgmma
     too, none spilling): (a) phases 2b-2d's checks and times in each
     mode, the kernels against their twins in that mode, the ms beside
     f32stash's of this call and the mode's bound (f32: the SDF products
     as six bf16 passes at the bf16 peak, and beside it their bound at the
     f32 SIMT peak); (b) each mode trained through fused_march (save), fused_march
     recompute and fused_core on, 60 steps: launches by suffixed name, the
     loss halving, one step's leaf gradients against the f32 plain core at
     phase 7's limits on phases 7 / 8's pixels beside the f32stash
     kernels' (f32's worst SDF leaf F32_SDF_GAIN times closer), a replay
     against the steps one by one; (c) the validation
     render in f32 and row 5 on that view's points against the f32 plain
     path, beside f32stash's.
  13. the render core's last JAX keys and row 2's f32x3 arm: (a) the grid
     SDF's f32x3 entry (csrc/sdf_rays.cu: three bf16 products a layer on
     hi / lo parts) on 2^18 points of the res-512 lattice, on the geometric
     init and on phase 3's weights, against its plain twin
     (ATOL_GRID['f32x3']), its distance from the f32 entry, ms beside the
     f32 and bf16 entries, the bound; (b) testing_step at res 512, sparse,
     with EXTRACT_PRECISION f32x3 on phase 3's weights: seconds, counts,
     grid launches, the mesh against the f32 mesh's (chamfer), sparse ==
     dense bitwise at res 128; (c) RAY_CHUNK: one auto step chunked at 256
     against unchunked on the same pixels (the loss and every leaf), and
     phase 11's chunked arm at 2048 x 512 beside the unchunked auto's
     peak and ms/step; (d) COMPUTE_DTYPE bfloat16: auto 60 steps, the loss
     falling, ms/step beside f32 auto's, one step's leaves against f32;
     (e) N_OUTSIDE 32 (NeuS's womask setting) on the NeuS kind at full
     width, 60 steps: the loss falls, every leaf finite, the nerf leaves
     move, the sweep the only kernel; (f) OPTIMIZE.TYPE sgd through the
     fused march in captured bundles: the loss falls, a replay bitwise
     equal to 10 uncaptured steps; (g) write_glb of (b)'s mesh read back.
  14. data-parallel training (color_neus_torch/parallel), in child
     processes that load the kernels phase 1 built, each group's ranks on
     127.0.0.1 in the environment torchrun sets: (a) two ranks on the one
     card over gloo, fused_march on (save, f32stash): one step of 1024
     rays, 512 a rank, perturb 0, against one process on the same pixels
     (the loss within RTOL_DP_LOSS, every clipped leaf within RTOL_DP_LEAF
     norm-relative, the distances printed), the ranks' parameters bitwise
     equal after it; then TrainLoop on the mesh for 60 steps in uncaptured
     bundles (gloo cannot be captured): the loss halves, the losses and
     the replicas equal across the ranks, rows 1, 3 and 4 launched 4 / 1 /
     1 times a step on each rank; (b) `python -m color_neus_torch.train
     --distributed` as the one rank of an NCCL group, 20 steps in bundles
     of 10 and a checkpoint; then in another process of such a group (a)'s
     step and run, the run's bundles captured (the gathers and the
     gradients' all-reduce inside the graph), a replay bitwise equal to 10
     uncaptured steps, and host ms/step of captured bundles on the mesh /
     one process / one process / the mesh.
  15. the evidence tools (color_neus_torch/tools/, the ports of the JAX
     round's tools/): (a) grad_audit's audit at 256 rays x 512 samples on
     the same two ray batches and parameters: fused_march on (rows 3 + 4,
     the save mode) in MARCH_BWD_PRECISION f32stash, bf16 and f32 and
     fused_core on (rows 5 + 6) in f32stash, each against the f32 plain
     core; each report's groups printed, JAX's gate pass_2x_floor required
     in every arm, the arm's kernels launched twice each, and the SDF
     group's systematic ratio of each mode side by side; (b)
     quality_gate on the sphere at 1000 steps and res 128 with QG_FUSED on
     (must pass at JAX's thresholds) and '' (auto: the plain core), and on
     the blob with QG_FUSED on, in turn in this process: each verdict, its
     seconds, steady ms/step and launches; (c) dtu_blob_e2e at 2000 steps
     and res 256 (the train and evaluate CLIs as child processes), then
     eval_views over its 12 views and mesh_compare of its mesh against the
     analytic surface: finite values, a non-empty mesh, 12 views.
  16. the JAX round's step and extraction instruments
     (color_neus_torch/tools/, the ports of JAX's tools/), each through its
     main in this process at INSTRUMENTS' knobs, its JSON parsed and held
     to carry every key JAX's tool prints: bench_ab (march_acts save
     against recompute at 2048 x 512, 3 rounds of 10 steps; each arm
     within RTOL_AB_PHASE11 of phase 11(c)'s captured ms/step),
     profile_step (3 calls a piece), trace_profile (2 captured bundles;
     its top kernels sum to at most its busy time), march_ablate (row 4's
     load entry in five builds, in f32stash and again in f32; full within
     RTOL_ABLATE_FULL of the production entry), mesh_extraction_timing (res 512, f32),
     extract_probe (res 256), merge_bench and eval_fused_check (must
     pass). Each phase's seconds print as it ends, and all of them before
     the kernel line.
The last lines are one JSON object per kernel list, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial

from color_neus_torch.tools._timing import (
    card_line, cuda_ms, kernel_name, profile_steps, profiled, union_us)

SEED = 0
STEPS = 60
SWEEPS_PER_STEP = 4
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
# (f32x6: an f32 product as six bf16 passes on the tensor cores, JAX's
# Precision.HIGHEST, MARCH_BWD_PRECISION f32's arithmetic; the
# least time of exact-f32 products on the card, 3xTF32's rate too)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "f32x6": 989e12 / 6}
# kernel vs plain tolerances, set from the H100's readings (PERF.md) with
# headroom. f32: summation order only (read <= 3e-7). bf16: a layer input
# that rounds to the other neighbouring bf16 value after a different f32
# summation order moves the next layer by one bf16 ulp (2^-8 relative) of
# that input, and such flips propagate (read <= 1.94e-3 in phase 2, and
# <= 3.03e-3 in phase 4 on the trained weights and the main path's rays).
ATOL = {"float32": 2e-6, "bfloat16": 3e-3}
ATOL_MAIN_PATH = 5e-3
# grid SDF (sdf_points) kernel vs plain, set from the H100's readings
# (PERF.md, PR 3) with headroom: f32 summation order only (read <= 4.8e-7);
# bf16 one-ulp flips as in the sweep, at the grid's larger |sdf| (up to
# ~1.6 at the bbox corners; read <= 3.64e-3)
ATOL_GRID = {"f32": 2e-6, "bf16": 6e-3, "f32x3": 4e-5}
# Rows 3-6 (the point pipeline and the fused march) compute the TPU kernels'
# production arithmetic: every product rounds its operands to bf16 and sums
# in f32 (csrc/point_pipeline_tile.cuh). So they are held against their
# plain twins with bf16=True, which round the same operands: max |kernel -
# twin| over an output, lane group or leaf relative to its largest |twin|.
# What separates the two is the f32 summation order of the products: a
# layer input within rounding of a bf16 midpoint rounds to the other
# neighbour, which moves the next layer by one bf16 ulp (2^-8 relative) of
# that input, and such flips propagate (the CPU rehearsal of the sources
# read <= 5.7e-4 on grad, <= 4.2e-4 on the backward; at 131,072 points the
# f32 bf16 twin and the float64 one read 5.3e-3 / 9.6e-3 on grad, 1.1e-3
# norm-relative). Where the compositing or the second-order backward
# amplifies such flips (phases 2c and 2d), the check is relative: the
# kernel may be at most twice as far from the bf16 twin in float64 as the
# f32 bf16 twin is, plus a floor. Beside each check the phases print the
# kernel's distance from the f32 (or float64) plain twin: what the
# precision costs. Limits set from the H100's readings with headroom
# (PERF.md, PR 7).
# point pipeline forward (phases 2b, 6d), per output: max-relative and
# norm-relative (L2) against the bf16 twin (read <= 7.7e-3 / 1.4e-3)
RTOL_PIPELINE = {"max": {"sdf": 3e-2, "grad": 3e-2, "gc": 3e-2, "relit": 3e-2, "delta": 3e-2},
                 "norm": 5e-3}
# the validation image, kernel path vs the bf16 twin's path (same z values):
# the flips above through alpha compositing (read 1.41e-4)
ATOL_IMAGE = 2e-3
# point-pipeline backward (phase 2c), against the bf16 twin in float64:
# pts / dirs and the worst leaf, at most twice the f32 bf16 twin's own
# distance plus RTOL_BWD_FLOOR, max- and norm-relative. A relu unit whose
# pre-activation lies within rounding of 0 flips its mask between two
# paths; at 131,072 points ~16 points do in f32 (PERF.md, PR 4), more in
# bf16. So the cotangents of the points within KINK_MARGIN of a colour or
# relight relu kink (float64 pre-activations) are set to 0 in every run;
# bf16-sized flips remain, and the relative rule absorbs them (the f32 and
# float64 bf16 twins read up to 0.16 (dirs) max-relative, 3.2e-2 on a leaf
# norm-relative; the kernel within 1.3x of the f32 twin).
KINK_MARGIN = 1e-5
RTOL_BWD_FLOOR = {"pts": 2e-3, "dirs": 2e-3, "weights": 5e-3}
# one training step's leaf gradients through the kernels (bf16 products)
# against the f32 plain core, per leaf: the L2 norm of the difference
# relative to the leaf's gradient norm and the cosine of the two, and the
# median over the leaves. The yardstick is the TPU's own audit of this
# arithmetic against its f32 oracle (reports/r5/grad_audit_f32stash.json:
# worst leaf 4.64e-2, min cosine 0.9989): the median leaf reads 2.2e-2 /
# 3.1e-2 (phases 7 / 8), under it. The relight net's last layers read 0.26
# and cosine 0.966 on the trained sphere: their gradient is a small
# difference of large terms there (the relight residual is near 0), so the
# bf16 rounding of their operands moves it by a quarter (the CPU rehearsal
# of the sources read 0.28 between the bf16 and f32 twins for the same
# leaves at init); the per-leaf limits sit ~2x above that, the median's 2x
# above the audit's worst.
RTOL_STEP_GRAD = 0.5
MIN_COS_STEP_GRAD = 0.9
RTOL_STEP_GRAD_MEDIAN = 0.1
# the fused march (rows 3 + 4) against its plain twins with bf16=True, phase
# 2d, at inv_s = exp(10 v) for each v here: the init's ~20, and ~1097, where
# exact q == 1 ties are common. Forward: max |kernel - twin| over a lane
# group relative to its largest |twin|, and norm-relative, against the bf16
# twin in float64, at most twice the f32 bf16 twin's distance plus
# RTOL_MARCH_FWD_FLOOR: alpha amplifies the bf16 flips above by inv_s (the
# two twins read 2.7e-2 apart on the colour at ~1097, 4e-4 at ~20).
# The forward (per lane group) and the backward are held tightly against the
# composed reference: row 5's outputs on the same 64-point tiles, the plain
# compositing and its VJP in torch, row 6's pullback. That is the same tile
# arithmetic and the same relu masks; only the compositing's f32 rounding
# differs (read <= 5.7e-5 on the backward; the G / xv term dropped reads
# 4.7e-3). Against the bf16 twin in float64 (the backward on the rays none
# of whose points is within MARCH_KINK_MARGIN of a colour or relight relu
# kink, the others' cotangents 0; a mask flips between two paths there) the
# kernel may be twice as far as the f32 bf16 twin plus a floor: at inv_s
# ~1097 one flipped sdf moves a sample's alpha wholesale, and the kernel's
# mma summation order flips other roundings than cuBLAS's order, which the
# f32 and float64 twins share (read: forward colour 4.0e-2 max-relative,
# 2.0e-3 norm-relative, against the f32 twin's 1.3e-2 / 6.6e-4; backward
# inv_s 4.0e-2, a leaf 3.0e-2 against 1.0e-2 / 4.5e-3; at ~20 the two read
# alike). f32 also rounds the saturated sigmoid slopes of the sdf and inv_s
# cotangents coarsely there.
MARCH_VARIANCES = (0.3, 0.7)
RTOL_MARCH_FWD_FLOOR = {"max": 5e-2, "norm": 5e-3}
RTOL_MARCH_TIGHT = {"forward": 1e-3, "rays_o": 1e-3, "rays_d": 1e-3, "inv_s": 1e-3,
                    "weights": 1e-3}
RTOL_MARCH_F64_FLOOR = {"rays_o": 1e-2, "rays_d": 1e-2, "inv_s": 0.1, "weights": 0.1}
MARCH_KINK_MARGIN = 1e-6
# the clip's tie rule (0.5 at q == 1) on rays whose every point is a tie
# (tie_inputs): the kernel's inv_s gradient against the bf16 twin in
# float64, relative. alpha_bar of a ray's first sample is the difference
# of two nearby colour weights, so a bf16 flip of a colour layer's input
# between the f32 kernel and the float64 twin shows in it at full size (the
# CPU rehearsal of the source read 6.6e-3; 1.9e-4 with f32 products); a
# gate of 1.0 reads 1.0; the H100 read 8.4e-4.
TIE_SAMPLES = 8
RTOL_MARCH_TIE = 1e-2
# the save mode's stash bytes a point at the Color-NeuS widths of
# config/Color_NeuS_dtu.yml in the JAX package (its march_stash_bytes, read
# on the CPU), printed beside the port's own
JAX_STASH_BYTES_COLOR_NEUS = 13312
# phase 9, the MLP chain (rows 7 + 8) at the tool's main shape: 1,048,576
# rows (T 1024 x G 1024), 25 layers. Kernel against plain on the card, max
# |diff|, set from the H100's readings (PERF.md, the MLP chain) with headroom.
# "Tight", L = 1: one product and one activation, so only the f32
# summation order (bf16 read 3.8e-6 at |x| <= 6; the gates at weight 1.0,
# where sigmoid(100 x) has slope 25, 3.9e-5). f32: the kernel sums JAX's
# six bf16 passes a k16 step, cuBLAS's SIMT sgemm (the plain version's
# product) each output in k order with FMAs, two roundings of one sum
# 4.8e-6 apart at most, and 4.1e-5 through a gate at weight 1.0 (the H100;
# the SIMT kernel before the six passes summed as cuBLAS does and read
# 1.8e-7 under the 2e-6 this limit was then); the f32 arithmetic's own accuracy
# is held against float64 instead (f32_chain_gate: the kernel's RMS error
# ~0.32x the plain path's).
# L = 25 at the tool's gate weight, one limit per variant: bf16, a layer
# input within rounding of a bf16 midpoint rounds to the other neighbour
# after another summation order, and such flips propagate. Read on the
# H100 (PERF.md, the MLP chain): none 2.7e-2 (values to 3.3), relu 1.3e-5
# (values to 1e-3), sigmoid 7.0e-4, the softplus forms and the deferred
# chain 1.04e-4 (values to 0.028); the limits sit 4-10x above. f32 (none)
# read 4.5e-6.
# The gates at weight 1.0 are held at L = 1 only: there a flip moves
# sigmoid(100 x) by 25x its size and the 25-layer chain diverges (read 2.6
# of |x| <= 7.5). The deferred chain's gate shows from L = 2, after one
# bf16 flip of layer 2's input at most (|w| <= 0.27 times an ulp of
# |x| <= 6; read 4.6e-3).
# recip~ takes the card's approximate reciprocal, its plain version the
# exact one: ~1 ulp of the gate, below these.
CHAIN_T, CHAIN_G, CHAIN_L = 1024, 1024, 25
CHAIN_RAGGED = 1000
ATOL_CHAIN_TIGHT = {"bfloat16": 2e-4, "float32": 1e-4}
ATOL_CHAIN_BF16 = {"none": 0.1, "relu": 1e-4, "softplus": 1e-3, "sigmoid": 5e-3,
                   "sp+gate": 1e-3, "shared": 1e-3, "expm1gate": 1e-3, "recip~": 1e-3,
                   "recipNt": 1e-3, "deferred": 1e-3}
ATOL_CHAIN_F32 = 1e-5
ATOL_CHAIN_DEFERRED_L2 = 2e-2
# The f32 chain (chain_f32_kernel: JAX's f32 dot as six bf16 wgmma passes,
# each k16 step's sum nudged half an ulp, unbias_truncated_ffma) against
# float64 (f32_chain_gate): per layer the signed error toward |float64|,
# (y - r) sign(r) over the layer's RMS of r, its mean and RMS, beside the
# plain f32 path's (cuBLAS's f32 products, round to nearest): none layer by
# layer over CHAIN_L layers, each layer on the float64 chain's previous
# output rounded to f32 (so that a layer's own arithmetic is held, not the
# earlier layers' errors it inherits), and every activation at L = 1 (the
# gates at 1.0). Held: a layer's |mean| within F32_BIAS_FACTOR x the plain
# path's largest over the layers (phase 12a's rule, chain_bias_limit), the
# plain path's |mean| floored at CHAIN_SE_FLOOR of its standard errors and
# at CHAIN_RMS_FLOOR of its RMS; a layer's RMS within F32_BIAS_FACTOR x the
# plain path's. The floors: the plain path rounds to nearest, so its mean
# reads its own noise (~1e-11 at 268M elements, 1e-4 of its RMS), and twice
# that would ask for an arithmetic with no bias at all, which the tensor
# cores' truncation does not allow: they keep a few bits below the ulp
# (wgmma_truncation), so a step's truncation costs a little less than the
# half ulp the nudge gives back (a layer read +3.6e-9, 1.3% of the plain
# path's RMS, on the H100; without the nudge ~-3e-8). 2 x 1% of the plain
# path's RMS a layer lets a bias reach a tenth of the random error that path
# accumulates over the tool's 25 layers (sqrt(25) x its RMS).
CHAIN_SE_FLOOR, CHAIN_RMS_FLOOR = 3.0, 0.01
# the tensor cores' rounding: draws of one m64n128k16 wgmma (8192 outputs
# each) per accumulator scale (wgmma_truncation)
WGMMA_PROBE_DRAWS = 16
WGMMA_PROBE_C = (0.0, 1.0, 16.0, 2.0 ** -6)
# the f32 chain's ring alone (ring_rate): slabs (16 KB) a block takes, one
# block an SM, timed over RING_PROBE_REPS launches; the image shared by every
# block, or RING_PROBE_COPIES copies (16 MB, L2-resident)
RING_PROBE_SLABS, RING_PROBE_REPS, RING_PROBE_COPIES = 64 * 400, 5, 32
FP32_LANES_PER_SM, MUFU_PER_SM = 128, 16     # Hopper SM: FP32 lanes, special-function units
STEADY_STEPS = 20
# phase 11: the shipped configs' LOG_INTERVAL, the steps of one captured
# bundle; bench.py's shape (2048 rays x 256 + 4 x 64 samples, 8x the
# points of the config's 1024 x 128); the renderer switches of the three
# training arms; each arm's kernels a step launches (trace names)
BUNDLE = 10
BENCH_MODEL = {"N_RAYS": 2048, "RENDERER": {"N_SAMPLES": 256, "N_IMPORTANCE": 256}}
# (the fused march's save pair in MARCH_BWD_PRECISION bf16 and f32 too)
ARMS = {"fused_march": {"FUSED_MARCH": "on"},
        "fused_march_recompute": {"FUSED_MARCH": "on", "MARCH_ACTS": "recompute"},
        "fused_core": {"FUSED_CORE": "on"},
        "fused_march_bf16": {"FUSED_MARCH": "on", "MARCH_BWD_PRECISION": "bf16"},
        "fused_march_f32": {"FUSED_MARCH": "on", "MARCH_BWD_PRECISION": "f32"}, "auto": {},
        # the plain core in chunks of 256 rays, each recomputed in the backward
        "auto_chunked": {"RAY_CHUNK": 256}}
# arms phase 11 runs at bench.py's shape only: the chunked core is there for
# the memory of that shape (phase 13c holds it against the unchunked one at
# the config's shape, tests/test_torch_cuda.py its replay there)
BENCH_ONLY_ARMS = ("auto_chunked",)
CHILD_TAG = "BENCH_ARM_RECORD "
ARM_KERNELS = {"fused_march": ("ray_march_save_fwd_kernel", "ray_march_load_bwd_kernel"),
               "fused_march_recompute": ("ray_march_fwd_kernel", "ray_march_bwd_kernel"),
               "fused_core": ("point_pipeline_fwd_kernel", "point_pipeline_bwd_kernel"),
               "fused_march_bf16": ("ray_march_save_fwd_kernel_bf16s",
                                    "ray_march_load_bwd_kernel_bf16s"),
               "fused_march_f32": ("ray_march_save_fwd_kernel_f32s",
                                   "ray_march_load_bwd_kernel_f32s"),
               "auto": (), "auto_chunked": ()}
# the two uncaptured runs of an arm whose gradients sum through atomics
# differ from each other; a captured bundle is held to this many times
# their distance (each run's atomics take another order, so a third run
# lands as far from the first as the second does, within a small factor)
BUNDLE_DISTANCE_FACTOR = 4.0
# phase 11: traces of a captured bundle's replays taken at most before its
# kernels' counts must hold (the profiler can lose a device record)
TRACE_ATTEMPTS = 3
# phase 14: data-parallel training (color_neus_torch/parallel) in child
# processes on the one card. (a) Two ranks over gloo (NCCL refuses two
# ranks on one card; gloo moves the CUDA tensors through the host): one
# fused-march step of 1024 rays, 512 a rank, against one process on the
# same pixels at step DP_STEP (lr > 0 past the warm-up's 50). The per-ray
# partials are computed per ray alike, so the loss moves by the order of
# its sums at most; each rank's kernel sums its own rays' weight grads in
# a fixed order and the two sums are added, so a leaf's gradient moves by
# the f32 rounding of that split.
DP_RANKS = 2
DP_STEP = 100
RTOL_DP_LOSS = 1e-5
RTOL_DP_LEAF = 1e-4      # norm-relative, every leaf the one-process step reaches
# (b) one rank of an NCCL group: bundles timed distributed / one process /
# one process / distributed, DP_BUNDLES replays each
DP_BUNDLES = 2
DP_TIMEOUT = 420         # seconds for a child process; then the group is killed
# phase 12: MARCH_BWD_PRECISION's two non-default modes, each trained
# through the three kernel paths (renderer switches) and their kernels'
# launch counts (names without the mode's suffix)
PREC_MODES = ("bf16", "f32")
PREC_PATHS = {"fused_march": {"FUSED_MARCH": "on"},   # MARCH_ACTS auto: the save pair
              "fused_march_recompute": {"FUSED_MARCH": "on", "MARCH_ACTS": "recompute"},
              "fused_core": {"FUSED_CORE": "on"}}
PATH_KERNELS = {"fused_march": ("ray_march_save", "ray_march_bwd_load"),
                "fused_march_recompute": ("ray_march", "ray_march_bwd"),
                "fused_core": ("point_pipeline", "point_pipeline_bwd")}
# the pixels of each path's leaf-gradient check: those phases 7 (fused_core)
# and 8 (fused_march) set RTOL_STEP_GRAD on. A leaf whose gradient is a
# small difference of large terms on other pixels reads far off in every
# mode alike (sdf.lin8.g 1.46 on one draw, for the f32stash kernels too)
PATH_GRAD_SEED = {"fused_march": SEED + 130, "fused_march_recompute": SEED + 130,
                  "fused_core": SEED + 110}
# 'f32' computes the SDF chain in f32 (six bf16 passes): its
# worst SDF leaf against the f32 plain core at least this much closer than
# f32stash's on the same pixels (the SIMT f32 design before read 3.96e-3
# against 6.44e-2, 16x; what is left is the colour / relight chains' bf16)
F32_SDF_GAIN = 10
# 'f32' against float64 on row 3's save entry (phase 12a's march inputs):
# hp_product sums each k16 step's six passes in a fresh accumulator and
# nudges the sum half an ulp (unbias_truncated), because the tensor cores'
# adds truncate (round toward zero; Fasi, Higham, Mikaitis and Pranesh,
# "Numerical behavior of NVIDIA tensor cores", PeerJ Comput. Sci. 7:e330,
# 2021, on V100, T4 and A100). On the H100 a design that summed a slab's
# passes in one accumulator read the activations' mean signed error
# -3.7e-7 at layer 7 (the plain f32 path -1.4e-8) and 28,290 feature
# flips (PERF.md, PR 20). Held here: the features' bf16 flips against
# float64 (the colour net's operand rounded to another bf16 value) at most
# the plain f32 path's on the same card, and every hidden SDF layer's mean
# signed relative error at most F32_BIAS_FACTOR x the largest |mean| of the
# plain path's layers (the emulator rounds to nearest, so only the card
# shows the truncation).
F32_BIAS_FACTOR = 2.0
# the validation render of phase 12c: camera, samples a ray of the points
# row 5 is held on
PREC_EVAL_CAM, PREC_EVAL_SAMPLES = 1, 32
# phase 10: DTU's own view count and image size; the IHO replica's size
# (that phase holds gradients, not speed); the train / stop / resume steps
DTU_VIEWS, DTU_H, DTU_W = 49, 1200, 1600
IHO_VIEWS, IHO_H, IHO_W, IHO_STEPS = 30, 540, 960, 20
STOP_AT = 30
SIGTERM_AFTER_S = 3.0
# the replica's cameras read back: poses through f32 world matrices of a
# ~600 mm frame and load_K_Rt_from_P (the CPU read 3e-7); the focal is
# stored in f32, whose ulp at ~2890 px is 2.4e-4 px, so it is held relative
REPLICA_POSE_ATOL, REPLICA_FOCAL_RTOL = 1e-4, 1e-4
PIPELINE_OUTPUTS = ("sdf", "grad", "gc", "relit", "delta")
EVAL_RES = 512
GRID_CHUNK = 1 << 18
PIPELINE_RAYS, PIPELINE_SAMPLES = 1024, 128     # one validation chunk

# phase 13: RAY_CHUNK's chunk (bench.py's 2048 rays in 8); one auto step
# chunked against unchunked on the same pixels and z: the same f32
# arithmetic, cuBLAS blocking a chunk's rows its own way, so the loss within
# RTOL_CHUNK_LOSS and every leaf within RTOL_CHUNK_GRAD norm-relative (the
# CPU reads <= 2e-5 absolute on small widths, tests/test_torch_render_keys.py)
CHUNK_RAYS = 256
RTOL_CHUNK_LOSS = 1e-5
RTOL_CHUNK_GRAD = 1e-3
# the f32x3 res-512 mesh against the f32 one: symmetric mean squared
# chamfer in float64; an SDF ~1e-5 off (ATOL_GRID's note) moves a vertex by
# about as much, ~1e-10 squared; a lost product (~2^-9 of the SDF) reads
# ~1e-6 and more
MAX_CHAMFER_X3 = 1e-8
CHAMFER_SAMPLES = 32768
# NeuS's own womask setting: 32 background samples, no mask loss; the NeuS
# kind's colour net (config/NeuS_dtu.yml), the NeRF net at its defaults
N_OUTSIDE = 32
NEUS_COLOR = {"D_FEATURE": 256, "MODE": "idr", "D_IN": 9, "D_OUT": 3, "D_HIDDEN": 256,
              "N_LAYERS": 4, "WEIGHT_NORM": True, "MULTIRES_VIEW": 4, "SQUEEZE_OUT": True}
# OPTIMIZE.TYPE sgd: plain SGD needs a larger lr than Adam's 5e-4 to move
# in 60 steps; the per-leaf clip at 1.0 bounds a step to lr per leaf
SGD_OPTIMIZE = {"TYPE": "sgd", "LR": 0.05, "SCHEDULER_TYPE": "NEUS", "WARM_UP": 10,
                "LR_ALPHA": 0.05}

# phase 15: the evidence tools (color_neus_torch/tools/). The audit at the
# shape of JAX's r5 reports (reports/r5/grad_audit*.json: 256 rays x 256 +
# 256 samples), each arm held to JAX's own gate (pass_2x_floor): the fused
# march in every MARCH_BWD_PRECISION mode and the fused core in the
# default one; each arm's pair of kernels launches once a gradient, four
# gradients of which two are the arm's. The quality gate at JAX's 1000
# steps and res 128 (its thresholds unchanged, quality_gate.thresholds);
# the DTU-format blob at 2000 steps and res 256 (JAX's r5 anchor ran 5000)
AUDIT_RAYS = 256
AUDIT_ARMS = (("f32stash", "fused_march"), ("bf16", "fused_march"), ("f32", "fused_march"),
              ("f32stash", "fused_core"))
AUDIT_KERNELS = {"fused_march": ("ray_march_save", "ray_march_bwd_load"),
                 "fused_core": ("point_pipeline", "point_pipeline_bwd")}
QG_STEPS, QG_RES = 1000, 128
QG_ARMS = (("sphere", "on"), ("sphere", ""), ("blob", "on"))
DBE_STEPS, DBE_RES, DBE_VIEWS = 2000, 256, 12

# phase 16: the JAX round's step and extraction instruments
# (color_neus_torch/tools/), each run once in this process through its
# main at these knobs, its printed JSON parsed. JAX_TOOL_KEYS: the keys
# each JAX tool prints (tools/<name>.py; the port's eval_fused_check is
# tpu_eval_fused_check.py), which the port's must print too: its top-level
# keys, and the keys of every entry of its nested report (mesh timing:
# each res*; extract_probe: each arm; eval check: the checks; trace: each
# top op). Gates: the eval check passes; march_ablate's full build within
# RTOL_ABLATE_FULL of the production load entry in the same process (the
# same code, built twice); the trace's top kernels sum to at most its
# busy time (one stream: no kernel overlaps another); bench_ab's arms
# within RTOL_AB_PHASE11 of phase 11(c)'s captured save and recompute at
# 2048 x 512 (another dataset, the same shape and kernels).
INSTRUMENTS = {
    "bench_ab": {"AB_KEY": "march_acts", "AB_A": "save", "AB_B": "recompute", "AB_ROUNDS": "3",
                 "BENCH_N_RAYS": "2048", "BENCH_K_STEPS": "10"},
    "profile_step": {"PROF_N_RAYS": "2048", "PROF_ITERS": "3"},
    "trace_profile": {"PROF_N_RAYS": "2048", "TRACE_BUNDLES": "2", "TRACE_K_STEPS": "10"},
    "march_ablate": {"ABL_N_RAYS": "1024", "ABL_REPS": "5", "ABL_PREC": "f32stash"},
    "mesh_extraction_timing": {"MET_RES": "512", "MET_PREC": "f32"},
    "extract_probe": {"EP_RES": "256", "EP_REPS": "2"},
    "merge_bench": {"MB_R": "2048"},
    "eval_fused_check": {"EFC_RES": "64", "EFC_VERTS": "5000"},
}
# march_ablate runs again in the other mode of ABLATE_MODES (row 4's f32
# load entry split by part)
ABLATE_MODES = ("f32stash", "f32")
# phase 1 (sass_identity_check): the rows 3-6 kernels the redesigns of
# the march's load and save entries left as they were (rows 5 and 6; row
# 4's recompute entry shares the compositing VJP's per-point helper with
# the load entry, and row 3's recompute entry the parallel compositing
# with the save entry, so their SASS moved and their times are compared
# instead, PERF.md §6), and their SASS digests (sass_digests) in each
# mode's build of the sources before those redesigns, read on the H100
# machine under UNCHANGED_SASS_NVCC
UNCHANGED_KERNELS = ("point_pipeline_fwd_kernel", "point_pipeline_bwd_kernel")
UNCHANGED_SASS_NVCC = "release 12.9, V12.9.86"
UNCHANGED_SASS = {
    "point_pipeline_bwd_kernel":
        "f8e5e3ab394ff3188906ea49ca2297e14007c112077480d5ea08edfb076e16ed",
    "point_pipeline_bwd_kernel_bf16s":
        "0466def0289eadaf229ee7c6b88d8f59f5ccd972fd5df849e568f7eb0dea5d91",
    "point_pipeline_bwd_kernel_f32s":
        "d195e6c7ec0c4cd899b08ae8bdeedf9d8915335b8100a6e88ba398092318e9a5",
    "point_pipeline_fwd_kernel":
        "d172bd2c3bcd5c2017d7ca243f62ab377e4fadf5dc6cddc0d2a3db6f7c83ff7c",
    "point_pipeline_fwd_kernel_bf16s":
        "d172bd2c3bcd5c2017d7ca243f62ab377e4fadf5dc6cddc0d2a3db6f7c83ff7c",
    "point_pipeline_fwd_kernel_f32s":
        "065f2b8ab45e032b0156168388b237fe94288f38d5f8311a4cb7fc422ed9083b",
}
JAX_TOOL_KEYS = {
    "bench_ab": (("key", "A", "B", "rounds", "n_rays", "k_steps", "A_rays_per_s_median",
                  "B_rays_per_s_median", "B_over_A_median", "B_over_A_iqr"), None, ()),
    "profile_step": (("train_step_ms", "pipeline_fwd_bwd_ms", "pipeline_fwd_ms", "hierarchy_ms",
                      "render_fwd_ms", "render_loss_bwd_ms", "residual_step_minus_lossgrad_ms",
                      "residual_lossgrad_minus_pieces_ms", "n_rays"), None, ()),
    "trace_profile": (("total_device_ms_per_step", "top_ops_ms_per_step"),
                      "top_ops_ms_per_step", ("name", "ms", "calls", "hlo")),
    "march_ablate": (("fwd_save_ms", "fwd_nosave_ms", "bwd_full_ms", "bwd_no_pullback_ms",
                      "bwd_no_unflatten_ms", "bwd_pullback_only_ms", "fwd_no_composite_ms"),
                     None, ()),
    "mesh_extraction_timing": (("what", "platform"), "res",
                               ("grid_eval_s", "marching_s", "vertex_colors_s",
                                "overlapped_grid_plus_marching_s", "sparse_grid_plus_marching_s",
                                "sparse_steady_s", "n_verts", "n_verts_overlapped",
                                "n_verts_sparse")),
    "extract_probe": (("what", "platform", "res", "arms"), "arms",
                      ("device_only_s", "full_s", "fetch_share_s", "dispatches")),
    "merge_bench": (("counting_ms_per_merge", "sort_ms_per_merge", "z_equal", "sdf_equal"),
                    None, ()),
    "eval_fused_check": (("platform", "checks", "pass"), "checks",
                         ("vertex_colors_no_view_dir_max_abs_err",
                          "vertex_colors_idr_max_abs_err", "sdf_grid_max_abs_err")),
}
RTOL_ABLATE_FULL = 0.05
RTOL_AB_PHASE11 = 0.15

# MODEL of config/Color_NeuS_dtu.yml; DATASET, DATA_PRESET and TRAIN of
# config/Color_NeuS_synthetic.yml (the DTU scan is not in the repo, and
# DTU's WARM_UP of 5000 would keep lr near 0 for all 60 steps). Written
# out so the run needs no PyYAML; tests/test_torch_package.py holds it
# equal to the YAML sections.
SMOKE_CFG = {
    "DATASET": {"TYPE": "Synthetic", "N_IMGS": 8, "H": 64, "W": 64, "SPHERE_RADIUS": 0.5},
    "DATA_PRESET": {"FX_ONLY": False, "INCLUDE_MASK": True, "OPENGL_SYS": False},
    "MODEL": {
        "TYPE": "NeuS_Trainer", "PRETRAINED": None, "N_RAYS": 1024, "EVAL_RAY_SIZE": 1024,
        "NORMALIZE_DIR": True, "FOCAL_ORDER": 2, "LEARN_FOCAL": False, "LEARN_R": False,
        "LEARN_T": False, "MASK_RATE": [0.5, 0.8], "POSE_MODE": "6d",
        "RENDERER": {
            "TYPE": "Color_NeuS", "EXTRACT_SPARSE": True, "N_SAMPLES": 64,
            "N_IMPORTANCE": 64, "UP_SAMPLE_STEPS": 4, "PERTURB": 1.0,
            "SDF": {"D_IN": 3, "D_OUT": 257, "D_HIDDEN": 256, "N_LAYERS": 8, "SKIP_IN": [4],
                    "MULTIRES": 6, "BIAS": 0.5, "SCALE": 3.0, "GEOMETRIC_INIT": True,
                    "WEIGHT_NORM": True, "INSIDE_OUTSIDE": False},
            "COLOR": {"D_FEATURE": 256, "MODE": "no_view_dir", "D_IN": 6, "D_OUT": 3,
                      "D_HIDDEN": 256, "N_LAYERS": 4, "WEIGHT_NORM": True,
                      "MULTIRES_VIEW": 0, "SQUEEZE_OUT": True},
            "RELIGHT": {"D_IN": 6, "D_OUT": 3, "D_HIDDEN": 256, "N_LAYERS": 4,
                        "Y_IN_LAYER": 3, "MULTIRES_VIEW": 4, "INCLUDE_GRAD": True,
                        "INV_SIGMOID": True},
            "DEVIATION": {"INIT_VAL": 0.3},
        },
        "LOSS": {"RGB_LOSS_TYPE": "mse", "LAMBDA_FINE": 1.0, "LAMBDA_EIKONAL": 0.1,
                 "LAMBDA_MASK": 0.1, "LAMBDA_RELIGHT": 1.0},
    },
    "TRAIN": {
        "BATCH_SIZE": 8, "ITERATIONS": 500,
        "OPTIMIZE": {"TYPE": "adam", "LR": 0.0005, "SCHEDULER_TYPE": "NEUS", "WARM_UP": 50,
                     "LR_ALPHA": 0.05},
        "LOG_INTERVAL": 10, "SAVE_INTERVAL": 250, "VIZ_IMAGE_INTERVAL": 250,
        "VIZ_MESH_INTERVAL": 250, "MANUAL_SEED": 1, "CONV_REPEATABLE": True,
        "GRAD_CLIP_ENABLED": True, "GRAD_CLIP": {"TYPE": 2, "NORM": 1.0},
    },
}


class SmokeFailure(RuntimeError):
    pass


class PhaseClock:
    """Seconds of each phase of main, printed as each ends and together
    before the kernel line: the budget of the script's time limit."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.secs = {}

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        self.secs[phase] = now - self.t
        self.t = now
        print(f"[{phase}] phase seconds {self.secs[phase]:.1f} (script {now - self.t0:.1f})",
              flush=True)


def _call_into(errors, fn):
    try:
        fn()
    except Exception as e:  # reported by the caller's check
        errors.append(e)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sweep_inputs(R, S, device, seed):
    """Rays toward the unit sphere and sorted z in [near, far]."""
    import torch
    from color_neus_torch.ops.rays import near_far_from_sphere
    g = torch.Generator(device=device).manual_seed(seed)
    d = torch.randn((R, 3), generator=g, device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = -2.2 * d + 0.1 * torch.randn((R, 3), generator=g, device=device)
    near, far = near_far_from_sphere(o, d)
    t = torch.sort(torch.rand((R, S), generator=g, device=device), dim=-1).values
    z = near[:, None] + (far - near)[:, None] * t
    return o.contiguous(), d.contiguous(), z.contiguous()


def off_geometric_init(params, generator, scale=0.02):
    """Seeded noise on every leaf, so every weight of the net matters."""
    import torch
    with torch.no_grad():
        for p in params.parameters():
            p.add_(scale * torch.randn(p.shape, generator=generator, device=p.device))
    return params


def mlp_bound_ms(sw, n, io_bytes):
    """Least time of the SDF MLP (rows 1 and 2) on n points and what sets
    it: the largest of its bytes (io_bytes of points in and sdf out, the
    packed weights and biases, each read once) over the memory rate, its
    products at the real widths (bf16: the tensor cores' peak), and its
    epilogue's FP32-pipe and MUFU instructions per activated element
    (sweep_epilogue_counts, at the real hidden widths) at those pipes'
    rates; in f32 mode the products' FMAs run on the FP32 pipe beside the
    epilogue, so the two add up there. Without the epilogue counts (no
    cuobjdump) the bound is bytes and products only.
    Returns (ms, "bytes" | "operations", the term that sets it)."""
    macs = sum(w.shape[0] * w.shape[1] for w, _ in sw.layers)
    elems = n * sum(w.shape[1] for w, _ in sw.layers[:-1])
    nbytes = io_bytes + sw.packed.numel() * sw.packed.element_size() + sw.bias.numel() * 4
    f32 = sw.dtype == "float32"
    # f32x3: three bf16 product passes (hi.hi, hi.lo, lo.hi)
    passes, peak = (3, PEAK_FLOPS["bfloat16"]) if sw.dtype == "f32x3" else (1, PEAK_FLOPS[sw.dtype])
    parts = {"bytes": nbytes / PEAK_BYTES_PER_S,
             "products": passes * 2 * macs * n / peak}
    epi = sweep_epilogue_counts()[0]
    if epi is not None:
        sms, clock = pipe_rates()
        fp32, mufu = epi[sw.act]
        parts["FP32 pipe"] = (fp32 * elems + (macs * n if f32 else 0)) \
            / (sms * FP32_LANES_PER_SM * clock * 1e6)
        parts["MUFU"] = mufu * elems / (sms * MUFU_PER_SM * clock * 1e6)
        if f32:   # the products are FP32-pipe FMAs: counted there
            del parts["products"]
    what = max(parts, key=parts.get)
    return parts[what] * 1e3, ("bytes" if what == "bytes" else "operations"), what


def sweep_bound_ms(sw, R, S):
    """mlp_bound_ms of one sweep: rays and z in, sdf out."""
    return mlp_bound_ms(sw, R * S, (2 * R * 3 + 2 * R * S) * 4)


def sweep_sass_check(lib_path):
    """Phase 1 for rows 1 and 2 (csrc/sdf_rays.cu): per kernel variant the
    ptxas-independent SASS counts (HMMA.16816.F32.BF16, the weight ring's
    bulk copies UBLKCP or cp.async LDGSTS, the IEEE divide's FCHK and every
    CALL with its target) and the resident blocks per SM. The bf16 kernels
    must hold HMMA, every kernel a bulk copy, none an FCHK or a CALL (an
    IEEE divide's range check and its out-of-line slow path; cuobjdump
    names a CALL's target by address only), and every variant 16 resident
    warps per SM (two blocks of 8 warps, or one of 16)."""
    from color_neus_torch.ops.kernels import sdf_rays as K
    lib = K._library()
    rep = ptxas_report("sdf_rays")
    for fn, c in sass_counts(lib_path).items():
        if not fn.startswith("sdf_rays_"):
            continue
        r = rep.get(fn, {})
        print(f"[1] SASS sdf_rays {fn}: {c['HMMA']} HMMA.16816.F32.BF16, {c['FFMA']} FFMA, "
              f"{c['UBLKCP']} UBLKCP, {c['LDGSTS']} LDGSTS, {c['FCHK']} FCHK, {len(c['CALL'])} "
              f"CALL {sorted(set(c['CALL']))} | {r.get('registers')} registers, spills "
              f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes", flush=True)
        if fn.startswith("sdf_rays_bf16_kernel"):   # bf16 and f32x3 (<relu,points,x3>)
            check(c["HMMA"] > 0, f"{fn}: no HMMA.16816.F32.BF16 in its SASS")
        check(c["UBLKCP"] + c["LDGSTS"] > 0, f"{fn}: no asynchronous copy in its SASS")
        check(c["FCHK"] == 0 and not c["CALL"],
              f"{fn}: an IEEE divide's range check or slow-path CALL in its SASS: "
              f"{c['FCHK']} FCHK, CALL {c['CALL']}")
    # (mode: 0 f32, 1 bf16, 2 f32x3; points; label; warps a block)
    variants = [(1, 0, "bf16 sweep", 16), (0, 0, "f32 sweep", 8), (1, 1, "bf16 grid", 16),
                (0, 1, "f32 grid", 8), (2, 1, "f32x3 grid", 16)]
    for mode, points, label, warps in variants:
        blocks = lib.sdf_rays_blocks_per_sm(mode, 0, points)
        print(f"[1] sdf_rays {label}: {blocks} blocks of {warps} warps per SM", flush=True)
        check(blocks * warps >= 16, f"sdf_rays {label}: {blocks} blocks of {warps} warps per SM")


def ptxas_report(kernel) -> dict:
    """{kernel variant: {"registers", "spill_stores", "spill_loads"}} from
    the ptxas -v report of the current build of csrc/<kernel>.cu."""
    from color_neus_torch.ops.kernels import build
    rep, cur = {}, None
    for line in build.build_log(kernel).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = kernel_variant(m.group(1))
            rep.setdefault(cur, {})
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                rep[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rep[cur]["registers"] = int(m.group(1))
    return rep


def chain_sass_check(lib_path):
    """Phase 1 for rows 7 and 8 (csrc/mlp_chain.cu): every chain
    instantiation, bf16 and f32 (the six passes), and the deferred kernel
    must run its products on wgmma (HGMMA in the SASS, no mma.sync HMMA),
    fetch W with bulk copies (UBLKCP), and spill nothing (ptxas -v); their
    registers and resident blocks per SM are printed."""
    from color_neus_torch.ops.kernels import mlp_chain as MC
    rep = ptxas_report("mlp_chain")
    seen = 0
    for fn, c in sass_counts(lib_path).items():
        if not fn.startswith(("chain_bf16_kernel", "chain_f32_kernel", "chain_deferred_kernel")):
            continue
        seen += 1
        r = rep.get(fn, {})
        m = re.search(r"<(\d+)>", fn)
        blocks = MC.blocks_per_sm(None if m is None else MC.ACTIVATIONS[int(m.group(1))][0],
                                  not fn.startswith("chain_f32_kernel"))
        print(f"[1] SASS mlp_chain {fn}: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA.16816.F32.BF16, "
              f"{c['UBLKCP']} UBLKCP, {c['FFMA']} FFMA | {r.get('registers')} registers, spill "
              f"stores / loads {r.get('spill_stores')} / {r.get('spill_loads')} bytes | {blocks} "
              f"resident blocks per SM", flush=True)
        check(c["HGMMA"] > 0 and c["HMMA"] == 0,
              f"{fn}: products not on wgmma ({c['HGMMA']} HGMMA, {c['HMMA']} HMMA)")
        check(c["UBLKCP"] > 0, f"{fn}: no bulk copy (UBLKCP) in its SASS")
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"{fn}: spills or no ptxas report: {r}")
        check(blocks >= 1, f"{fn}: {blocks} resident blocks per SM")
    check(seen == 19, f"mlp_chain: {seen} chain kernels in the SASS, want 9 bf16 + 9 f32 + "
                      f"deferred")


def pipeline_sass_check(kernel, lib_path, fwd_blocks_per_sm):
    """Phase 1 for rows 3-6 (csrc/point_pipeline.cu, csrc/ray_march.cu; a
    MARCH_BWD_PRECISION mode's library: `kernel` its build name, the
    kernels carrying its suffix): every kernel runs its products on wgmma
    (HGMMA in the SASS; in 'f32' the SDF chain's six bf16 passes too), feeds its
    weight slabs (and the backward its weight-grad operands) by bulk
    copies (UBLKCP) and spills nothing (ptxas -v); the forward kernels (rows 3, 5) hold no
    mma.sync (HMMA.16816.F32.BF16). Registers and FFMA are printed, and for
    the forward kernels their resident blocks per SM (fwd_blocks_per_sm:
    {forward kernel: blocks}, one backward kernel per forward one:
    ray_march.cu's recompute and save-mode pairs) and FCHK / CALL counts.
    Returns {kernel: its SASS counts and ptxas report}."""
    rep = ptxas_report(kernel)
    seen = {"fwd": 0, "bwd": 0}
    out = {}
    for fn, c in sass_counts(lib_path).items():
        r = rep.get(fn, {})
        base = re.sub(r"_(bf16s|f32s)$", "", fn)
        entry = "fwd" if base.endswith("_fwd_kernel") else "bwd" \
            if base.endswith("_bwd_kernel") else None
        extra = (f" | {fwd_blocks_per_sm.get(fn)} resident blocks per SM | {c['FCHK']} FCHK, "
                 f"{len(c['CALL'])} CALL" if entry == "fwd" else "")
        print(f"[1] SASS {kernel} {fn}: {c['HMMA']} HMMA.16816.F32.BF16, {c['HGMMA']} HGMMA, "
              f"{c['UBLKCP']} UBLKCP, {c['REDG']} REDG, {c['UBLKRED']} UBLKRED, {c['FFMA']} FFMA | "
              f"{r.get('registers')} "
              f"registers, spill stores / loads {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes{extra}", flush=True)
        if entry is None:
            continue
        seen[entry] += 1
        out[fn] = {**c, **r}
        check(c["HGMMA"] > 0, f"{fn}: products not on wgmma (no HGMMA in its SASS)")
        if entry == "fwd":
            check(c["HMMA"] == 0, f"{fn}: {c['HMMA']} HMMA.16816.F32.BF16 left in its SASS")
        check(c["UBLKCP"] > 0, f"{fn}: no bulk copy (UBLKCP) in its SASS")
        if "_load_bwd_" in fn:   # the flush adds into the partial without reading it back
            check(c["REDG"] + c["UBLKRED"] > 0,
                  f"{fn}: no reduction into device memory (REDG, UBLKRED) in its SASS")
        check("registers" in r and r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"{fn}: spills or no ptxas report: {r}")
    n = len(fwd_blocks_per_sm)
    check(seen == {"fwd": n, "bwd": n}, f"{kernel}: kernels in the SASS {seen}, want {n} of each")
    return out


def main_path_sweeps(loop, seed):
    """Phase 4: run the hierarchy of one step on the trained weights and
    the main path's rays, holding each sweep's kernel output against the
    plain version on the same rays and z; returns one record per sweep."""
    import torch
    from color_neus_torch.models import trainer as TR
    from color_neus_torch.models.neus import hierarchical_z_vals
    from color_neus_torch.ops.kernels.sdf_rays import (
        make_fused_sdf_rays_fn, resolve_sdf_sweep_fn, sdf_rays_plain)

    st, tcfg = loop.state, loop.tcfg
    rcfg = tcfg.renderer
    g = torch.Generator(device=loop.device).manual_seed(seed)
    img_ids = torch.arange(min(loop.batch_size, loop.n_imgs), device=loop.device)
    images = loop.images[img_ids]
    masks = loop.masks[img_ids] if loop.masks is not None else None
    sweeps = []
    with torch.no_grad():
        cam_sel, py, px, _ = TR.sample_pixels(tcfg, images, masks, st.step, g)
        rays_o, rays_d, near, far = TR.pixel_rays(st.params, loop.scene, tcfg, images,
                                                  img_ids, cam_sel, py, px)
        renderer = st.params["renderer"]
        fn = resolve_sdf_sweep_fn(renderer["sdf"], rcfg.sdf, rcfg.fused_sdf,
                                  dtype=rcfg.sweep_dtype, act=rcfg.sweep_activation)
        # the relu variant on the same data: its time does not depend on the
        # values, so the difference is what the softplus epilogue costs here
        relu_fn = make_fused_sdf_rays_fn(renderer["sdf"], rcfg.sdf, dtype=rcfg.sweep_dtype,
                                         act="relu")

        def checked(o, d, z):
            got = fn(o, d, z)
            o, d, z = o.contiguous(), d.contiguous(), z.contiguous()
            want = sdf_rays_plain(fn.weights, o, d, z)
            R, S = z.shape
            check(got.shape == (R, S) and bool(torch.isfinite(got).all()),
                  f"main-path sweep S={S}: bad output {tuple(got.shape)}")
            bound, bound_by, what = sweep_bound_ms(fn.weights, R, S)
            sweeps.append({"R": R, "S": S, "err": float((got - want).abs().max()),
                           "ms": cuda_ms(lambda: fn(o, d, z)),
                           "plain_ms": cuda_ms(lambda: sdf_rays_plain(fn.weights, o, d, z)),
                           "relu_ms": cuda_ms(lambda: relu_fn(o, d, z)),
                           "bound_ms": bound, "bound_by": bound_by, "bound_what": what})
            return got

        hierarchical_z_vals(renderer, rcfg, rays_o, rays_d, near, far, generator=g,
                            sdf_rays_fn=checked)
    return fn.weights.dtype, sweeps


def reset_launch_counts(*loops):
    """Every wrapper's count to 0, and the bundle counts of `loops`."""
    from color_neus_torch.ops.kernels import launchers
    for fn in launchers().values():
        fn.launches = 0
    for loop in loops:
        if loop.multi_step is not None:
            loop.multi_step.recorded.clear()
            loop.multi_step.replayed.clear()


def launch_counts(*loops) -> dict:
    """The kernel launches executed since the reset: each wrapper counts
    the launches it makes, eager or recorded into a captured bundle; a
    capture runs none of them, and each replay runs the captured ones. So
    a loop's recorded launches come off and its replayed ones on."""
    from color_neus_torch.ops import kernels
    counts = kernels.launch_counts()
    for loop in loops:
        ms = loop.multi_step
        if ms is not None:
            for k in counts:
                counts[k] += ms.replayed[k] - ms.recorded[k]
    return counts


def lattice_chunk(bmin, bmax, res, start, n, device):
    """n points of the res^3 lattice from flat index `start`, gathered as
    ops/mesh.py gathers them (np.linspace axes, x-major)."""
    import numpy as np
    import torch
    axes = [torch.as_tensor(np.linspace(bmin[i], bmax[i], res, dtype=np.float32),
                            device=device) for i in range(3)]
    flat = torch.arange(start, start + n, device=device)
    return torch.stack([axes[0][flat // (res * res)], axes[1][(flat // res) % res],
                        axes[2][flat % res]], dim=-1).contiguous()


def grid_bound_ms(sw, n):
    """mlp_bound_ms of the grid SDF on n points: pts in, sdf out."""
    return mlp_bound_ms(sw, n, n * (3 + 1) * 4)


def pipeline_macs(pw) -> dict:
    """MACs per point of the point pipeline at the networks' real widths:
    the SDF forward, its reverse sweep (every layer but the last, whose
    pullback is a weight row), the colour and the relight nets."""
    def macs(layers):
        return sum(w.shape[0] * w.shape[1] for w, _ in layers)
    return {"sdf": macs(pw.sdf), "reverse": macs(pw.sdf[:-1]), "color": macs(pw.color),
            "relight": macs(pw.relight)}


def weight_bytes(pw) -> int:
    """The bytes of the weights rows 3-6 read: the f32 buffer (narrow layers,
    biases) and the bf16 slab images (every 256-wide layer's forward and
    reverse image)."""
    from color_neus_torch.ops.kernels import point_pipeline as PP
    return pw.packed.numel() * 4 + PP.weight_images(pw)[0].numel() * 2


def forward_stream_bytes(pw, rows=128) -> tuple:
    """Weight bytes the forward tile (rows 3, 5) streams through L2 per
    point: (every slab its products bulk-copy, once per tile of `rows`
    points: the forward images of the 256-wide layers and the SDF reverse
    sweep's images, K padded to 64; the same products' unpadded bf16 [K,
    256] blocks read once per 64-point tile, as a tile of mma.sync
    fragments from L2 reads them)."""
    from color_neus_torch.ops.kernels import point_pipeline as PP
    _, wide = PP._layout(pw)
    slab, frag = 0, 0
    for w_slot, _, wp in wide:
        K = wp.shape[0]
        kp = -(-K // 64) * 64
        slab += 256 * kp * 2                        # forward image: 256 rows x K
        frag += K * 256 * 2
        if w_slot < PP.W_SDF + PP.MAXL:             # the SDF reverse image: K rows x 256
            slab += K * 256 * 2
            frag += K * 256 * 2
    return slab / rows, frag / 64


def macs_split(pw, bwd, save=False) -> tuple:
    """(SDF-chain MACs, colour / relight MACs) per point of rows 5 / 3 (bwd
    False) or rows 6 / 4 (bwd True; save: the load entry, which recomputes
    nothing): the products march_bwd_precision 'f32' runs in f32, and the
    ones every mode runs in bf16."""
    f = pipeline_macs(pw)
    fwd = (f["sdf"] + f["reverse"], f["color"] + f["relight"])
    if not bwd:
        return fwd
    b = pipeline_bwd_macs(pw)
    sdf, cr = b["tangent"] + b["last"] + b["sdf_reverse"] + b["lin0_lo"], b["relight"] + b["color"]
    return (sdf, cr) if save else (sdf + fwd[0], cr + fwd[1])


def mode_bound_ms(pw, n, bwd, nbytes, dtype=None, save=False, sdf_dtype=None):
    """The larger of one entry's MACs on n points (macs_split) at the peaks
    and its bytes at the memory rate: (ms, "bytes" | "operations"). dtype
    None: the arithmetic of pw's march_bwd_precision (the SDF chain's
    products as six bf16 passes in 'f32', f32x6, or at `sdf_dtype`'s peak:
    "float32", the bound of a design on the FP32 pipe; the rest at the bf16
    peak); else every product at the peak of `dtype`."""
    sdf, cr = macs_split(pw, bwd, save)
    f32 = pw.rcfg.march_bwd_precision == "f32"
    sdf_dt = dtype or sdf_dtype or ("f32x6" if f32 else "bfloat16")
    cr_dt = dtype or "bfloat16"
    t_ops = 2 * n * (sdf / PEAK_FLOPS[sdf_dt] + cr / PEAK_FLOPS[cr_dt])
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def pipeline_bound_ms(pw, n, dtype=None, sdf_dtype=None):
    """pts and dirs in, [n, 16] out, weights once; the products at the
    peaks of pw's mode (mode_bound_ms; float32: the bound of the same work
    in f32)."""
    return mode_bound_ms(pw, n, False, n * (6 + 16) * 4 + weight_bytes(pw), dtype,
                         sdf_dtype=sdf_dtype)


def pipeline_errors(got, want, metric=None) -> dict:
    """{output: metric(got, want)}, by default max |got - want| / max |want|."""
    metric = metric or _rel
    return {k: metric(a, b) for k, a, b in zip(PIPELINE_OUTPUTS, got, want)}


def check_pipeline(got, want, tag, what, outputs=PIPELINE_OUTPUTS):
    """Row 5's outputs against the bf16 twin's: every output of `outputs`
    within RTOL_PIPELINE (max-relative and norm-relative); prints all."""
    errs, norm = pipeline_errors(got, want), pipeline_errors(got, want, _nrel)
    print(f"[{tag}] {what} vs the bf16 twin: max-relative "
          + " ".join(f"{k} {e:.3e}" for k, e in errs.items()) + ", norm-relative "
          + " ".join(f"{k} {e:.3e}" for k, e in norm.items()), flush=True)
    for k in outputs:
        check(errs[k] <= RTOL_PIPELINE["max"][k] and norm[k] <= RTOL_PIPELINE["norm"],
              f"{what}: {k} {errs[k]:.3e} max-relative / {norm[k]:.3e} norm-relative from the "
              f"bf16 twin, above {RTOL_PIPELINE['max'][k]:g} / {RTOL_PIPELINE['norm']:g}")


def eval_kernels_vs_plain(device, mode="f32stash", tag="2b"):
    """Phase 2b: the grid SDF and the point pipeline against their plain
    versions at full width, off geometric init; returns the records the
    kernel line reads (the main path's shapes: one 2^18-point grid chunk
    in f32, one 131,072-point validation chunk of Color-NeuS). mode: the
    point pipeline's march_bwd_precision, held against its twin in the
    same mode (phase 12a: the grid SDF, which has no such mode, skipped)."""
    import torch
    from color_neus_torch.models.configs import ColorConfig, RendererConfig
    from color_neus_torch.models.neus import init_renderer
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import sdf_mlp

    out = {}
    g = torch.Generator(device=device).manual_seed(SEED + 50)
    bmin, bmax = [-1.01] * 3, [1.01] * 3          # the synthetic bbox
    sdf_params = off_geometric_init(init_renderer(RendererConfig(), g, device)["sdf"], g)
    for prec in ("f32", "bf16") if mode == "f32stash" else ():
        fn = sdf_mlp.make_fused_sdf_fn(sdf_params, RendererConfig().sdf, prec)
        for n, start in ((GRID_CHUNK, EVAL_RES ** 3 // 2), (1001, 12345)):
            pts = lattice_chunk(bmin, bmax, EVAL_RES, start, n, device)
            with torch.no_grad():
                before = sdf_mlp.launch_sdf_points.launches
                got = fn(pts)
                torch.cuda.synchronize()
                check(sdf_mlp.launch_sdf_points.launches == before + 1,
                      f"grid sdf {prec}: the sdf function did not launch the kernel")
                want = sdf_mlp.sdf_points_plain(fn.weights, pts)
                check(got.shape == (n,) and bool(torch.isfinite(got).all()),
                      f"grid sdf {prec} n={n}: bad output {tuple(got.shape)}")
                err = float((got - want).abs().max())
                ms = cuda_ms(lambda: fn(pts))
                plain_ms = cuda_ms(lambda: sdf_mlp.sdf_points_plain(fn.weights, pts), reps=5)
            bound, bound_by, what = grid_bound_ms(fn.weights, n)
            print(f"[2b] sdf_points {prec:4s} n={n}: |sdf| max {float(want.abs().max()):.3f} | "
                  f"max|kernel-plain| {err:.3e} (atol {ATOL_GRID[prec]:g}) | kernel {ms:.4f} ms | "
                  f"plain {plain_ms:.4f} ms | bound {bound:.4f} ms ({bound_by}: {what})",
                  flush=True)
            check(err <= ATOL_GRID[prec], f"grid sdf {prec} n={n}: max error {err:.3e} above "
                                          f"{ATOL_GRID[prec]:g}")
            if n == GRID_CHUNK:
                out[f"sdf_points_{prec}"] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                                             "bound_ms": bound, "bound_by": bound_by}

    kinds = {"color_neus": ColorConfig(mode="no_view_dir", d_in=6, multires_view=0),
             "neus": ColorConfig()}
    for kind, color in kinds.items():
        rcfg = RendererConfig(kind=kind, color=color, march_bwd_precision=mode)
        params = off_geometric_init(init_renderer(rcfg, g, device), g)
        pw = PP.resolve_pipeline_weights(params, rcfg)
        if kind == "color_neus":
            stream, mma_tile = forward_stream_bytes(pw)
            print(f"[{tag}] point_pipeline MACs per point: {pipeline_macs(pw)} | weight bytes "
                  f"streamed through L2 per point: {stream:.1f} (128-point tiles of wgmma "
                  f"slabs; a 64-point tile of mma.sync fragments read {mma_tile:.1f})",
                  flush=True)
        for R, S in ((PIPELINE_RAYS, PIPELINE_SAMPLES), (37, 27)):
            o, d, z = sweep_inputs(R, S, device, SEED + 60 + R)
            pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()
            dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3).contiguous()
            n = R * S
            with torch.no_grad():
                counter = PP._counter(PP.launch_point_pipeline, pw)
                before = counter.launches
                got = PP.fused_point_pipeline_fwd(params, rcfg, pts, dirs, weights=pw)
                torch.cuda.synchronize()
                check(counter.launches == before + 1,
                      f"point pipeline {kind}: did not launch the kernel")
                want = PP.point_pipeline_plain(pw, pts, dirs, bf16=True)
                check(all(bool(torch.isfinite(a).all()) for a in got)
                      and tuple(got[1].shape) == (n, 3), f"point pipeline {kind}: bad output")
                cost = pipeline_errors(got, PP.point_pipeline_plain(pw, pts, dirs))
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                ms = cuda_ms(lambda: PP.launch_point_pipeline(pw, pts, dirs))
                plain_ms = cuda_ms(lambda: PP.point_pipeline_plain(pw, pts, dirs, bf16=True),
                                   reps=5)
            bound, bound_by = pipeline_bound_ms(pw, n)
            bound32 = pipeline_bound_ms(pw, n, "float32")[0]
            print(f"[{tag}] point_pipeline {mode} {kind:10s} n={n}: max|kernel-f32 twin| / max|twin| (the "
                  "precision's cost) " + " ".join(f"{k} {e:.3e}" for k, e in cost.items())
                  + f" | |grad| max {float(want[1].abs().max()):.3f} | kernel {ms:.4f} ms | "
                  f"bf16 twin {plain_ms:.4f} ms | bound {bound:.4f} ms ({bound_by}; f32 "
                  f"{bound32:.4f} ms)", flush=True)
            check_pipeline(got, want, tag, f"point_pipeline {mode} {kind} n={n}")
            if (R, S) == (PIPELINE_RAYS, PIPELINE_SAMPLES):
                out[f"point_pipeline_{kind}"] = {
                    "err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by, "bound32_ms": bound32,
                    "simt_bound_ms": pipeline_bound_ms(pw, n, sdf_dtype="float32")[0]}
    return out


def pipeline_bwd_macs(pw) -> dict:
    """MACs per point of the point pipeline's backward at the networks'
    real widths: the recompute (the forward), dW and xbar of every colour
    and relight layer, the SDF tangent stream, dW and xbar of the last SDF
    layer, two dW and two xbar products per hidden SDF layer, and the
    second (lo) pass of layer 0's two weight-grad products (none in
    march_bwd_precision 'f32', whose products are f32)."""
    def macs(layers):
        return sum(w.shape[0] * w.shape[1] for w, _ in layers)
    hidden = macs(pw.sdf[:-1])
    lo = 0 if pw.rcfg.march_bwd_precision == "f32" else 2 * macs(pw.sdf[:1])
    return {"recompute": sum(pipeline_macs(pw).values()), "relight": 2 * macs(pw.relight),
            "color": 2 * macs(pw.color), "tangent": hidden, "last": 2 * macs(pw.sdf[-1:]),
            "sdf_reverse": 4 * hidden, "lin0_lo": lo}


def pipeline_bwd_bound_ms(pw, n, dtype=None, sdf_dtype=None):
    """pts, dirs and the [n, 16] cotangents in, pts / dirs grads out, the
    weights read and their grads written once; the products at the peaks
    of pw's mode (mode_bound_ms)."""
    return mode_bound_ms(pw, n, True, n * (6 + 16 + 6) * 4 + weight_bytes(pw) + pw.n_grad * 4,
                         dtype, sdf_dtype=sdf_dtype)


def _rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _nrel(a, b) -> float:
    """|a - b| / |b|, L2 norms over every element (float64)."""
    import torch
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b)) / max(float(torch.linalg.norm(b)), 1e-300)


def bwd_errors(got, ref, metric=None):
    """({pts, dirs, weights}: metric(got, ref), by default max |got - ref|
    relative to ref's largest magnitude, weights the worst leaf; the
    largest absolute difference of all). got / ref: (pts_hat, dirs_hat,
    {net: [(dW, db)]})."""
    m = metric or _rel
    rel = {"pts": m(got[0].double(), ref[0]), "dirs": m(got[1].double(), ref[1]),
           "weights": 0.0}
    err = max(float((got[0].double() - ref[0]).abs().max()),
              float((got[1].double() - ref[1]).abs().max()))
    for net, layers in ref[2].items():
        for (a, b), (c, d) in zip(got[2][net], layers):
            for x, y in ((a, c), (b, d)):
                check(x.shape == y.shape, f"{net} grad shape {tuple(x.shape)} vs {tuple(y.shape)}")
                rel["weights"] = max(rel["weights"], m(x.double(), y))
                err = max(err, float((x.double() - y).abs().max()))
    return rel, err


def relu_margin(pw64, pts64, dirs64):
    """Per point, the smallest |pre-activation| over the colour and relight
    relu units (float64 forward)."""
    import torch
    from color_neus_torch.ops.kernels import point_pipeline as PP
    with torch.no_grad():
        _, st = PP._forward(pw64, pts64, dirs64)
        m = torch.full((pts64.shape[0],), float("inf"), dtype=torch.float64,
                       device=pts64.device)
        for layers, xs in ((pw64.color, st.cs), (pw64.relight, st.rs)):
            for (w, b), x in zip(layers[:-1], xs[:-1]):
                m = torch.minimum(m, (x @ w.T + b).abs().amin(dim=1))
    return m


def core_fwd_bwd(params, rcfg, pts, dirs, cots):
    """The render core's per-point pipeline forward and backward as the
    training step runs it: every leaf's and pts / dirs gradients of
    sum(output * cotangent)."""
    import torch
    from color_neus_torch.models.neus import eval_point_pipeline
    leaves = [p for p in params.parameters() if p.requires_grad]
    p, d = pts.detach().requires_grad_(True), dirs.detach().requires_grad_(True)
    outs = eval_point_pipeline(params, rcfg, p, d)
    loss = sum(torch.sum(o * c) for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, leaves + [p, d], allow_unused=True)


def pipeline_bwd_vs_plain(device, mode="f32stash", tag="2c"):
    """Phase 2c: the point-pipeline backward against its plain version at
    full width, off geometric init; returns the records the kernel line
    reads (the main path's shape: 131,072 points, Color-NeuS). mode: the
    kernel's march_bwd_precision, held against the twins in the same mode
    by the same rule (phase 12a: the unchecked extras of the default mode
    skipped)."""
    import dataclasses
    import torch
    from color_neus_torch.models.configs import ColorConfig, RendererConfig
    from color_neus_torch.models.neus import init_renderer
    from color_neus_torch.ops.kernels import point_pipeline as PP

    out = {}
    g = torch.Generator(device=device).manual_seed(SEED + 70)
    kinds = {"color_neus": ColorConfig(mode="no_view_dir", d_in=6, multires_view=0),
             "neus": ColorConfig()}
    for kind, color in kinds.items():
        rcfg = RendererConfig(kind=kind, color=color, march_bwd_precision=mode)
        params = off_geometric_init(init_renderer(rcfg, g, device), g)
        pw = PP.resolve_pipeline_weights(params, rcfg)
        if kind == "color_neus":
            print(f"[{tag}] point_pipeline_bwd MACs per point: {pipeline_bwd_macs(pw)}", flush=True)
        for R, S in ((PIPELINE_RAYS, PIPELINE_SAMPLES), (37, 27)):
            o, d, z = sweep_inputs(R, S, device, SEED + 80 + R)
            pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()
            dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3).contiguous()
            n = R * S
            pw64 = PP.PipelineWeights(rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                              for layers in (pw.sdf, pw.color, pw.relight)])
            keep = (relu_margin(pw64, pts.double(), dirs.double()) > KINK_MARGIN).float()
            cots = [torch.randn((n, k), generator=g, device=device) * keep[:, None]
                    for k in (1, 3, 3, 3, 3)]
            gbar = torch.cat(cots + [torch.zeros((n, 3), device=device)], dim=1).contiguous()
            counter = PP._counter(PP.launch_point_pipeline_bwd, pw)
            before = counter.launches
            got = PP.launch_point_pipeline_bwd(pw, pts, dirs, gbar)
            torch.cuda.synchronize()
            check(counter.launches == before + 1,
                  f"point pipeline bwd {kind}: did not launch the kernel")
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"point pipeline bwd {kind}: non-finite output")
            ph, dh, packed = got
            mine = (ph, dh, PP._unpack_grads(pw, packed))
            want = PP.point_pipeline_bwd_plain(pw, pts, dirs, cots, bf16=True)
            ref = PP.point_pipeline_bwd_plain(pw64, pts.double(), dirs.double(),
                                              [c.double() for c in cots], bf16=True)
            rel, err = bwd_errors(mine, ref)
            rel_n = bwd_errors(mine, ref, _nrel)[0]
            twin, twin_n = bwd_errors(want, ref)[0], bwd_errors(want, ref, _nrel)[0]
            # the precision's cost: the kernel against the f32 arithmetic in
            # float64
            ref = PP.point_pipeline_bwd_plain(pw64, pts.double(), dirs.double(),
                                              [c.double() for c in cots])
            cost, cost_n = bwd_errors(mine, ref)[0], bwd_errors(mine, ref, _nrel)[0]
            del ref
            ms = cuda_ms(lambda: PP.launch_point_pipeline_bwd(pw, pts, dirs, gbar), reps=5)
            plain_ms = cuda_ms(lambda: PP.point_pipeline_bwd_plain(pw, pts, dirs, cots, True),
                               reps=3, warmup=1)
            bound, bound_by = pipeline_bwd_bound_ms(pw, n)
            bound32 = pipeline_bwd_bound_ms(pw, n, "float32")[0]
            print(f"[{tag}] point_pipeline_bwd {mode} {kind:10s} n={n} ({int(keep.sum())} points off the "
                  f"relu kinks): from the bf16 twin in float64, max-relative kernel "
                  + " ".join(f"{k} {e:.3e}" for k, e in rel.items())
                  + f" (max abs {err:.3e}), f32 bf16 twin "
                  + " ".join(f"{k} {e:.3e}" for k, e in twin.items()) + "; norm-relative kernel "
                  + " ".join(f"{k} {e:.3e}" for k, e in rel_n.items()) + ", f32 bf16 twin "
                  + " ".join(f"{k} {e:.3e}" for k, e in twin_n.items())
                  + " | kernel from the f32 arithmetic in float64 (the precision's cost): "
                  "max-relative " + " ".join(f"{k} {e:.3e}" for k, e in cost.items())
                  + ", norm-relative " + " ".join(f"{k} {e:.3e}" for k, e in cost_n.items())
                  + f" | |pts grad| max {float(want[0].abs().max()):.3f} | kernel {ms:.4f} ms | "
                  f"bf16 twin {plain_ms:.4f} ms | bound {bound:.4f} ms ({bound_by}; f32 "
                  f"{bound32:.4f} ms)", flush=True)
            for k in rel:
                lim, lim_n = (2.0 * twin[k] + RTOL_BWD_FLOOR[k],
                              2.0 * twin_n[k] + RTOL_BWD_FLOOR[k])
                check(rel[k] <= lim and rel_n[k] <= lim_n,
                      f"point pipeline bwd {mode} {kind} n={n}: {k} {rel[k]:.3e} max-relative / "
                      f"{rel_n[k]:.3e} norm-relative from the bf16 twin in float64, above twice "
                      f"the f32 bf16 twin's plus {RTOL_BWD_FLOOR[k]:g}: {lim:.3e} / {lim_n:.3e}")
            if (R, S) != (PIPELINE_RAYS, PIPELINE_SAMPLES):
                continue
            rec = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by, "bound32_ms": bound32,
                   "simt_bound_ms": pipeline_bwd_bound_ms(pw, n, sdf_dtype="float32")[0]}
            if kind == "color_neus" and mode == "f32stash":
                # the same comparison with every point's cotangents: a relu
                # mask flip between the two f32 paths moves a point's
                # gradients (no check)
                full = [torch.randn((n, k), generator=g, device=device) for k in (1, 3, 3, 3, 3)]
                gfull = torch.cat(full + [torch.zeros((n, 3), device=device)], 1).contiguous()
                ph, dh, packed = PP.launch_point_pipeline_bwd(pw, pts, dirs, gfull)
                mine = (ph, dh, PP._unpack_grads(pw, packed))
                twin = PP.point_pipeline_bwd_plain(pw, pts, dirs, full, True)
                print(f"[2c] with all {n} points' cotangents (no check): max|kernel-bf16 twin| / "
                      "max|twin| " + " ".join(f"{k} {e:.3e}" for k, e in
                                              bwd_errors(mine, twin)[0].items())
                      + ", norm-relative " + " ".join(f"{k} {e:.3e}" for k, e in
                                                      bwd_errors(mine, twin, _nrel)[0].items()),
                      flush=True)
                # determinism: a second identical call, bitwise
                again = PP.launch_point_pipeline_bwd(pw, pts, dirs, gfull)
                same = torch.equal(again[2], packed) and torch.equal(again[0], ph)
                print(f"[2c] a second identical backward call: weight grads and pts grads "
                      f"bitwise equal: {same}", flush=True)
                check(same, "point pipeline bwd: two identical calls differ")
                # the reduction on its own, at this launch's grid
                grid = min(-(-n // 64), PP._max_blocks(PP._library(mode), pts.device, mode,
                                                       "bwd"))
                partial = torch.zeros((grid, pw.n_grad), device=device)
                rec["reduce_ms"] = cuda_ms(lambda: PP.reduce_partials(partial))
                # the render core's fwd+bwd on these points: the plain autograd
                # core (what fused_core auto trains with) and the Function
                core = {m: cuda_ms(lambda: core_fwd_bwd(
                    params, dataclasses.replace(rcfg, fused_core=m), pts, dirs, cots),
                    reps=3, warmup=1) for m in ("off", "on")}
                rec["core_ms"] = core
                print(f"[2c] reduction of {grid} block partials x {pw.n_grad} floats: "
                      f"{rec['reduce_ms']:.4f} ms | fwd+bwd on {n} points: plain autograd core "
                      f"{core['off']:.4f} ms, autograd Function (row 5 + row 6) "
                      f"{core['on']:.4f} ms", flush=True)
            out[kind] = rec
    return out


MARCH_LANES = {"colour": (0, 3), "weight sum": (3, 4), "delta sum": (4, 5), "eikonal": (5, 7)}


def march_inputs(device, kind, variance, seed, mode="f32stash"):
    """Phase 2d's inputs: a full-width net off geometric init (noise 0.005
    keeps the init's surface on the rays, where a large inv_s makes exact
    ties), inv_s = exp(10 variance), the main path's shape of rays through
    the sphere, seeded [R, 16] cotangents on the loss lanes; mode the
    march_bwd_precision."""
    import torch
    from color_neus_torch.models.configs import ColorConfig, RendererConfig
    from color_neus_torch.models.fields import variance_inv_s
    from color_neus_torch.models.neus import init_renderer
    from color_neus_torch.ops.kernels import point_pipeline as PP
    color = ColorConfig(mode="no_view_dir", d_in=6, multires_view=0) \
        if kind == "color_neus" else ColorConfig()
    rcfg = RendererConfig(kind=kind, color=color, march_bwd_precision=mode)
    g = torch.Generator(device=device).manual_seed(seed)
    params = off_geometric_init(init_renderer(rcfg, g, device), g, scale=0.005)
    with torch.no_grad():
        params["variance"]["variance"].fill_(variance)
    pw = PP.resolve_pipeline_weights(params, rcfg)
    o, d, z = sweep_inputs(PIPELINE_RAYS, PIPELINE_SAMPLES, device, seed + 1)
    inv_s = variance_inv_s(params["variance"]).detach().reshape(1).contiguous()
    gbar = torch.randn((PIPELINE_RAYS, 16), generator=g, device=device)
    gbar[:, 7:] = 0.0
    return rcfg, pw, o, d, z, inv_s, gbar.contiguous()


def tie_inputs(device, R, S, seed, mode="f32stash"):
    """Rays on which the clip's tie rule carries the inv_s gradient: R rays
    of S samples within ~0.03 of the centre of the init sphere (radius
    ~0.17, sdf ~-0.05..-0.07), Color-NeuS at inv_s = exp(7) ~1097, so that
    pc < exp(-44) and every point has q == 1 exactly (alpha 1) in float32
    and in float64 alike. Every point of the ray is then a tie, so the inv_s
    cotangent is all tie-born. Only the colour cotangent is set, along
    relit(sample 0) - relit(sample 1), so that alpha_bar of sample 0 (the
    one that carries the ray: the later ones are dark by 1e-7 each) is
    |relit_0 - relit_1| > 0 on every ray: no sign cancels between rays. The
    colour and relight nets get noise 0.05 so that relit moves along the
    ray; the SDF 0.003, so that its surface stays where the init put it.
    mode: the march_bwd_precision."""
    import torch
    from color_neus_torch.models.configs import ColorConfig, RendererConfig
    from color_neus_torch.models.fields import variance_inv_s
    from color_neus_torch.models.neus import init_renderer
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM
    rcfg = RendererConfig(kind="color_neus",
                          color=ColorConfig(mode="no_view_dir", d_in=6, multires_view=0),
                          march_bwd_precision=mode)
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_renderer(rcfg, g, device)
    for net, scale in (("sdf", 0.003), ("color", 0.05), ("relight", 0.05)):
        off_geometric_init(params[net], g, scale)
    with torch.no_grad():
        params["variance"]["variance"].fill_(0.7)
    pw = PP.resolve_pipeline_weights(params, rcfg)
    d = torch.randn((R, 3), generator=g, device=device)
    d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
    o = (0.005 * torch.randn((R, 3), generator=g, device=device)).contiguous()
    z = (0.002 + 0.023 * torch.sort(torch.rand((R, S), generator=g, device=device),
                                    dim=-1).values).contiguous()
    inv_s = variance_inv_s(params["variance"]).detach().reshape(1).contiguous()
    _, _, pts, dirs = RM.march_points(o, d, z, 2.0 / rcfg.n_samples)
    with torch.no_grad():
        relit = PP.point_pipeline_plain(pw, pts, dirs)[3].reshape(R, S, 3)
    gbar = torch.zeros((R, 16), device=device)
    dr = relit[:, 0] - relit[:, 1]
    gbar[:, 0:3] = dr / torch.linalg.norm(dr, dim=-1, keepdim=True)
    return rcfg, pw, o, d, z, inv_s, gbar.contiguous()


def tie_counts(pw, o, d, z, inv_s, sample_dist):
    """(points at q == 1 exactly in float32, the same in float64), the
    bf16 twin's products."""
    import torch
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM
    pw64 = PP.PipelineWeights(pw.rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                         for layers in (pw.sdf, pw.color, pw.relight)])
    out = []
    with torch.no_grad():
        for w, dt in ((pw, torch.float32), (pw64, torch.float64)):
            x = [t.to(dt) for t in (o, d, z, inv_s)]
            dists, _, pts, dirs = RM.march_points(x[0], x[1], x[2], sample_dist)
            c = RM.composite(PP.point_pipeline_plain(w, pts, dirs, True), x[1], dists, pts,
                             x[3])
            out.append(int((c.q == 1.0).sum()))
    return tuple(out)


def march_bound_ms(pw, R, S, bwd, dtype=None, save=False, sdf_dtype=None):
    """Least time of one march entry: its MACs (ray_march.march_macs_per_point,
    split by macs_split; save: the save mode's, whose backward recomputes
    nothing) at the peaks of pw's mode (mode_bound_ms; or of `dtype`), or
    its bytes (rays, z, inv_s, the weights and, for the
    backward, the stash and the cotangents read once; the [R, 16] output
    and the stash, or the ray and weight grads, written once; save: the
    activation stash too, written by the forward, read by the backward)."""
    from color_neus_torch.ops.kernels import ray_march as RM
    check(sum(macs_split(pw, bwd, save)) == RM.march_macs_per_point(pw, save)[1 if bwd else 0],
          "march_bound_ms: the MAC split does not sum to the march's MACs")
    n = R * S
    inputs = R * 6 + n + 1 + (n * RM.STASH + R * 16 if bwd else 0)
    outputs = R * 6 + pw.n_grad + 1 if bwd else R * 16 + n * RM.STASH
    act = RM.act_total_bytes(pw, R, S) if save else 0
    return mode_bound_ms(pw, n, bwd, (inputs + outputs) * 4 + act + weight_bytes(pw), dtype,
                         save, sdf_dtype)


def leaf_distances(got, ref) -> dict:
    """{leaf: max |got - ref| / max |ref|} of two march backwards: rays_o,
    rays_d, inv_s and every weight and bias, named net.layer.W / .b."""
    out = {"rays_o": _rel(got[0].double(), ref[0].double()),
           "rays_d": _rel(got[1].double(), ref[1].double()),
           "inv_s": _rel(got[2].double().reshape(1), ref[2].double().reshape(1))}
    for net, layers in ref[3].items():
        for l, ((a, b), (c, d)) in enumerate(zip(got[3][net], layers)):
            out[f"{net}{l}.W"] = _rel(a.double(), c.double())
            out[f"{net}{l}.b"] = _rel(b.double(), d.double())
    return out


def _composed(pw):
    """The march's VJP composed from rows 5 and 6 and the plain compositing
    VJP in torch (ray_march.march_vjp's forward and pullback)."""
    from color_neus_torch.ops.kernels import point_pipeline as PP
    return (lambda p, d: PP.fused_point_pipeline_fwd(None, pw.rcfg, p, d, weights=pw),
            lambda p, d, cots: PP.fused_point_pipeline_bwd(pw, p, d, cots))


def march_bwd_errors(got, ref, metric=None) -> dict:
    """{rays_o, rays_d, inv_s, weights}: metric(got, ref), by default max
    |got - ref| relative to ref's largest magnitude (weights: the worst
    leaf); got / ref: (rays_o_hat, rays_d_hat, inv_s_hat, {net: [(dW,
    db)]})."""
    m = metric or _rel
    rel = {"rays_o": m(got[0].double(), ref[0].double()),
           "rays_d": m(got[1].double(), ref[1].double()),
           "inv_s": m(got[2].double().reshape(1), ref[2].double().reshape(1)), "weights": 0.0}
    for net, layers in ref[3].items():
        for (a, b), (c, d) in zip(got[3][net], layers):
            for x, y in ((a, c), (b, d)):
                check(x.shape == y.shape, f"{net} grad shape {tuple(x.shape)} vs {tuple(y.shape)}")
                rel["weights"] = max(rel["weights"], m(x.double(), y.double()))
    return rel


def _abs_err(got, ref) -> float:
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got[:3], ref[:3]))
    for net, layers in ref[3].items():
        for (a, b), (c, d) in zip(got[3][net], layers):
            err = max(err, float((a.double() - c.double()).abs().max()),
                      float((b.double() - d.double()).abs().max()))
    return err


def march_vs_plain(device, mode="f32stash", phase="2d"):
    """Phase 2d: the fused march (rows 3 + 4) against its plain twins at full
    width, off geometric init, 1024 rays x 128 samples, Color-NeuS and NeuS,
    at the init's inv_s and at one with exact q == 1 ties. Forward against
    the f32 plain twin; backward against the composed reference on the card
    (the plain compositing VJP in torch feeding row 6's kernel, the
    per-point outputs from row 5's: the same forward_tile arithmetic, so the
    same relu masks) and, with the f32 plain twin, against the plain twin
    in float64. The save mode's pair (row 3's save entry, row 4's load
    entry) the same way on the same inputs, against the save twins
    (ray_march_plain(save=True), ray_march_bwd_plain(stash=...)), at the
    same limits, with its distance from the recompute pair on every leaf.
    Prints every reading, then checks; returns the records the kernel line
    reads. mode: the kernels' march_bwd_precision, held against the twins
    in the same mode by the same rules (phase 12a)."""
    import torch
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM

    out, fails = {"fwd_err": 0.0, "bwd_err": 0.0, "save_err": 0.0, "load_err": 0.0}, []
    R, S = PIPELINE_RAYS, PIPELINE_SAMPLES
    for kind in ("color_neus", "neus"):
        for variance in MARCH_VARIANCES:
            rcfg, pw, o, d, z, inv_s, gbar = march_inputs(device, kind, variance, SEED + 120,
                                                          mode)
            sd = 2.0 / rcfg.n_samples
            tag = f"{mode} {kind} inv_s {float(inv_s):.1f}"
            counters = [PP._counter(fn, pw) for fn in (RM.launch_ray_march,
                                                       RM.launch_ray_march_bwd,
                                                       RM.launch_ray_march_save,
                                                       RM.launch_ray_march_bwd_load)]
            before = [c.launches for c in counters]
            got, stash = RM.launch_ray_march(pw, o, d, z, inv_s, sd)
            kb = RM.launch_ray_march_bwd(pw, o, d, z, inv_s, sd, stash, gbar)
            torch.cuda.synchronize()
            check([c.launches for c in counters[:2]] == [before[0] + 1, before[1] + 1],
                  f"march {tag}: the kernels did not launch")
            kern = (kb[0], kb[1], kb[2], PP._unpack_grads(pw, kb[3]))
            check(got.shape == (R, 16) and bool(torch.isfinite(got).all())
                  and all(bool(torch.isfinite(t).all()) for t in kb), f"march {tag}: bad output")
            pw64 = PP.PipelineWeights(rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                              for layers in (pw.sdf, pw.color, pw.relight)])
            args64 = (o.double(), d.double(), z.double(), inv_s.double(), sd)
            with torch.no_grad():   # the save twins: the plain twins' values, and their stash
                want, stash64 = RM.ray_march_plain(pw64, *args64, bf16=True, save=True)
                twin, stash32 = RM.ray_march_plain(pw, o, d, z, inv_s, sd, bf16=True, save=True)
                want32 = RM.ray_march_plain(pw, o, d, z, inv_s, sd)
                dists, _, pts, dirs = RM.march_points(o, d, z, sd)
                c = RM.composite(PP.point_pipeline_plain(pw, pts, dirs, True), d, dists, pts,
                                 inv_s)
                ties = int((c.q == 1.0).sum())
                del c
            fwd = {k: _rel(got[:, a:b].double(), want[:, a:b]) for k, (a, b) in MARCH_LANES.items()}
            fwd_n = {k: _nrel(got[:, a:b], want[:, a:b]) for k, (a, b) in MARCH_LANES.items()}
            tw = {k: _rel(twin[:, a:b].double(), want[:, a:b]) for k, (a, b) in MARCH_LANES.items()}
            tw_n = {k: _nrel(twin[:, a:b], want[:, a:b]) for k, (a, b) in MARCH_LANES.items()}
            with torch.no_grad():
                outs = _composed(pw)[0](pts, dirs)
                comp = RM.out16(outs, RM.composite(outs, d, dists, pts, inv_s))
                del outs
            fwd_tight = {k: _rel(got[:, a:b], comp[:, a:b]) for k, (a, b) in MARCH_LANES.items()}
            fwd_cost = {k: _rel(got[:, a:b], want32[:, a:b]) for k, (a, b) in MARCH_LANES.items()}
            out["fwd_err"] = max(out["fwd_err"], float((got.double() - want).abs().max()))
            composed = RM.march_vjp(o, d, z, inv_s, sd, gbar, *_composed(pw))
            tight = march_bwd_errors(kern, composed)

            def vs_f64(g):
                """(kernel, f32 bf16 twin) errors from the bf16 twin in
                float64, the kernel's largest absolute error from it, and the
                kernel's errors from the f32 arithmetic in float64 (the
                precision's cost), on the cotangents g."""
                kb = RM.launch_ray_march_bwd(pw, o, d, z, inv_s, sd, stash, g)
                mine = (kb[0], kb[1], kb[2], PP._unpack_grads(pw, kb[3]))
                ref = RM.ray_march_bwd_plain(pw64, *args64, g.double(), bf16=True)
                plain = RM.ray_march_bwd_plain(pw, o, d, z, inv_s, sd, g, bf16=True)
                cost = march_bwd_errors(mine, RM.ray_march_bwd_plain(pw64, *args64, g.double()))
                return march_bwd_errors(mine, ref), march_bwd_errors(plain, ref), \
                    _abs_err(mine, ref), cost

            # a relu mask flips between two f32 paths wherever a colour /
            # relight pre-activation lies within rounding of 0 (PERF.md, the
            # point-pipeline backward): the check keeps the rays none of whose points comes within
            # MARCH_KINK_MARGIN of a kink (float64), the others' cotangents 0
            with torch.no_grad():
                margin = relu_margin(pw64, pts.double(), dirs.double()).reshape(R, S).amin(1)
            clean = margin > MARCH_KINK_MARGIN
            g_clean = (gbar * clean[:, None].float()).contiguous()
            k64, p64, err, cost = vs_f64(g_clean)
            k_all, p_all, _, _ = vs_f64(gbar)
            out["bwd_err"] = max(out["bwd_err"], err)
            print(f"[{phase}] ray_march {tag}: {ties} of {R * S} points at q == 1 exactly | forward "
                  "from the bf16 twin in float64, max-relative kernel "
                  + " ".join(f"{k} {e:.3e}" for k, e in fwd.items()) + ", f32 bf16 twin "
                  + " ".join(f"{k} {e:.3e}" for k, e in tw.items()) + "; norm-relative kernel "
                  + " ".join(f"{k} {e:.3e}" for k, e in fwd_n.items()) + ", f32 bf16 twin "
                  + " ".join(f"{k} {e:.3e}" for k, e in tw_n.items())
                  + ", from the f32 twin (cost) " + " ".join(f"{k} {e:.3e}" for k, e in fwd_cost.items())
                  + "; from the composed rows 5 + torch compositing "
                  + " ".join(f"{k} {e:.3e}" for k, e in fwd_tight.items())
                  + " | backward vs composed (rows 5 + 6) " + " ".join(
                      f"{k} {e:.3e}" for k, e in tight.items())
                  + f" | vs the bf16 twin in float64 on the {int(clean.sum())} rays off the relu "
                  "kinks: kernel " + " ".join(f"{k} {e:.3e}" for k, e in k64.items())
                  + ", f32 bf16 twin " + " ".join(f"{k} {e:.3e}" for k, e in p64.items())
                  + " | on all rays (no check): kernel "
                  + " ".join(f"{k} {e:.3e}" for k, e in k_all.items())
                  + ", f32 bf16 twin " + " ".join(f"{k} {e:.3e}" for k, e in p_all.items())
                  + " | kernel from the f32 arithmetic in float64 (cost) "
                  + " ".join(f"{k} {e:.3e}" for k, e in cost.items()), flush=True)
            for k, e in fwd.items():
                lim = 2.0 * tw[k] + RTOL_MARCH_FWD_FLOOR["max"]
                lim_n = 2.0 * tw_n[k] + RTOL_MARCH_FWD_FLOOR["norm"]
                if fwd_tight[k] > RTOL_MARCH_TIGHT["forward"]:
                    fails.append(f"march {tag}: forward {k} {fwd_tight[k]:.3e} from the composed "
                                 f"reference, above {RTOL_MARCH_TIGHT['forward']:g}")
                if e > lim or fwd_n[k] > lim_n:
                    fails.append(f"march {tag}: forward {k} {e:.3e} max-relative / "
                                 f"{fwd_n[k]:.3e} norm-relative from the bf16 twin in float64, "
                                 f"above {lim:.3e} / {lim_n:.3e}")
            for k, e in tight.items():
                if e > RTOL_MARCH_TIGHT[k]:
                    fails.append(f"march {tag}: backward {k} {e:.3e} from the composed "
                                 f"reference, above {RTOL_MARCH_TIGHT[k]:g}")
            for k, e in k64.items():
                lim = 2.0 * p64[k] + RTOL_MARCH_F64_FLOOR[k]
                if e > lim:
                    fails.append(f"march {tag}: backward {k} {e:.3e} from float64, above "
                                 f"2 x the f32 plain's {p64[k]:.3e} + {RTOL_MARCH_F64_FLOOR[k]:g}")

            # the save mode's pair on the same inputs, against the save twins
            before = [c.launches for c in counters]
            got_s, stash_s, act = RM.launch_ray_march_save(pw, o, d, z, inv_s, sd)
            kb = RM.launch_ray_march_bwd_load(pw, o, d, z, inv_s, sd, stash_s, act, gbar)
            torch.cuda.synchronize()
            check([c.launches for c in counters[2:]] == [before[2] + 1, before[3] + 1],
                  f"march save {tag}: the save and load kernels did not launch")
            kern_s = (kb[0], kb[1], kb[2], PP._unpack_grads(pw, kb[3]))
            check(got_s.shape == (R, 16) and bool(torch.isfinite(got_s).all())
                  and all(bool(torch.isfinite(t).all()) for t in kb)
                  and tuple(act.shape) == (RM.act_total_bytes(pw, R, S),),
                  f"march save {tag}: bad output")
            fwd_s = {k: _rel(got_s[:, a:b].double(), want[:, a:b])
                     for k, (a, b) in MARCH_LANES.items()}
            fwd_s_n = {k: _nrel(got_s[:, a:b], want[:, a:b]) for k, (a, b) in MARCH_LANES.items()}
            fwd_s_tight = {k: _rel(got_s[:, a:b], comp[:, a:b])
                           for k, (a, b) in MARCH_LANES.items()}
            tight_s = march_bwd_errors(kern_s, composed)
            del composed
            kb = RM.launch_ray_march_bwd_load(pw, o, d, z, inv_s, sd, stash_s, act, g_clean)
            mine = (kb[0], kb[1], kb[2], PP._unpack_grads(pw, kb[3]))
            ref = RM.ray_march_bwd_plain(pw64, *args64, g_clean.double(), bf16=True,
                                         stash=stash64)
            plain = RM.ray_march_bwd_plain(pw, o, d, z, inv_s, sd, g_clean, bf16=True,
                                           stash=stash32)
            k64s, p64s = march_bwd_errors(mine, ref), march_bwd_errors(plain, ref)
            out["save_err"] = max(out["save_err"], float((got_s.double() - want).abs().max()))
            out["load_err"] = max(out["load_err"], _abs_err(mine, ref))
            del mine, ref, plain
            vs_rec = leaf_distances(kern_s, kern)
            worst_rec = max(vs_rec, key=vs_rec.get)
            print(f"[{phase}] ray_march save mode {tag}: stash {RM.march_stash_bytes(pw, 1)} bytes a "
                  f"point ({RM.act_bytes(pw)} activations + {RM.STASH * 4} outs; JAX's at the "
                  f"Color-NeuS widths {JAX_STASH_BYTES_COLOR_NEUS}), "
                  f"{RM.march_stash_bytes(pw, R * S) / 2 ** 30:.3f} GiB here | forward from the "
                  "save twin in float64, max-relative "
                  + " ".join(f"{k} {e:.3e}" for k, e in fwd_s.items()) + "; norm-relative "
                  + " ".join(f"{k} {e:.3e}" for k, e in fwd_s_n.items())
                  + "; from the composed rows 5 + torch compositing "
                  + " ".join(f"{k} {e:.3e}" for k, e in fwd_s_tight.items())
                  + " | load backward vs composed (rows 5 + 6) "
                  + " ".join(f"{k} {e:.3e}" for k, e in tight_s.items())
                  + " | vs the save twin in float64 off the relu kinks: kernel "
                  + " ".join(f"{k} {e:.3e}" for k, e in k64s.items()) + ", f32 save twin "
                  + " ".join(f"{k} {e:.3e}" for k, e in p64s.items())
                  + f" | save pair vs recompute pair, max-relative on every leaf (worst "
                  f"{worst_rec} {vs_rec[worst_rec]:.3e}): "
                  + " ".join(f"{k} {e:.2e}" for k, e in vs_rec.items()), flush=True)
            for k, e in fwd_s.items():
                lim = 2.0 * tw[k] + RTOL_MARCH_FWD_FLOOR["max"]
                lim_n = 2.0 * tw_n[k] + RTOL_MARCH_FWD_FLOOR["norm"]
                if fwd_s_tight[k] > RTOL_MARCH_TIGHT["forward"]:
                    fails.append(f"march save {tag}: forward {k} {fwd_s_tight[k]:.3e} from the "
                                 f"composed reference, above {RTOL_MARCH_TIGHT['forward']:g}")
                if e > lim or fwd_s_n[k] > lim_n:
                    fails.append(f"march save {tag}: forward {k} {e:.3e} max-relative / "
                                 f"{fwd_s_n[k]:.3e} norm-relative from the save twin in "
                                 f"float64, above {lim:.3e} / {lim_n:.3e}")
            # (in 'bf16' the load rebuilds the gates from the stash's bf16
            # values, JAX's arithmetic, where the composed reference, row 6,
            # recomputes f32 ones: there the save twin in float64 holds it)
            for k, e in tight_s.items():
                if mode != "bf16" and e > RTOL_MARCH_TIGHT[k]:
                    fails.append(f"march load {tag}: backward {k} {e:.3e} from the composed "
                                 f"reference, above {RTOL_MARCH_TIGHT[k]:g}")
            for k, e in k64s.items():
                lim = 2.0 * p64s[k] + RTOL_MARCH_F64_FLOOR[k]
                if e > lim:
                    fails.append(f"march load {tag}: backward {k} {e:.3e} from float64, above "
                                 f"2 x the f32 save twin's {p64s[k]:.3e} + "
                                 f"{RTOL_MARCH_F64_FLOOR[k]:g}")
            if (kind, variance) != ("color_neus", MARCH_VARIANCES[0]):
                del stash64, stash32, act, stash_s
                continue
            # times of the main path's shape, Color-NeuS at the init's inv_s
            rec = {"ms": cuda_ms(lambda: RM.launch_ray_march(pw, o, d, z, inv_s, sd), reps=10),
                   "bwd_ms": cuda_ms(lambda: RM.launch_ray_march_bwd(pw, o, d, z, inv_s, sd,
                                                                    stash, gbar), reps=5),
                   "plain_ms": cuda_ms(lambda: RM.ray_march_plain(pw, o, d, z, inv_s, sd, True),
                                       reps=5),
                   "plain_bwd_ms": cuda_ms(lambda: RM.ray_march_bwd_plain(
                       pw, o, d, z, inv_s, sd, gbar, True), reps=3, warmup=1),
                   "composed_ms": cuda_ms(lambda: RM.march_vjp(o, d, z, inv_s, sd, gbar,
                                                               *_composed(pw)), reps=3, warmup=1)}
            rec["bound_ms"], rec["bound_by"] = march_bound_ms(pw, R, S, bwd=False)
            rec["bwd_bound_ms"], rec["bwd_bound_by"] = march_bound_ms(pw, R, S, bwd=True)
            rec["bound32_ms"] = march_bound_ms(pw, R, S, False, "float32")[0]
            rec["bwd_bound32_ms"] = march_bound_ms(pw, R, S, True, "float32")[0]
            rec.update({
                "save_ms": cuda_ms(lambda: RM.launch_ray_march_save(pw, o, d, z, inv_s, sd),
                                   reps=10),
                "load_ms": cuda_ms(lambda: RM.launch_ray_march_bwd_load(
                    pw, o, d, z, inv_s, sd, stash_s, act, gbar), reps=5),
                "save_plain_ms": cuda_ms(lambda: RM.ray_march_plain(
                    pw, o, d, z, inv_s, sd, True, save=True), reps=3, warmup=1),
                "load_plain_ms": cuda_ms(lambda: RM.ray_march_bwd_plain(
                    pw, o, d, z, inv_s, sd, gbar, True, stash=stash32), reps=3, warmup=1)})
            rec["save_bound_ms"], rec["save_bound_by"] = march_bound_ms(pw, R, S, False,
                                                                        save=True)
            rec["load_bound_ms"], rec["load_bound_by"] = march_bound_ms(pw, R, S, True,
                                                                        save=True)
            # the SDF chain's products at the f32 SIMT peak (a design on the FP32 pipe)
            for key, bwd_, save_ in (("bound", False, False), ("bwd_bound", True, False),
                                     ("save_bound", False, True), ("load_bound", True, True)):
                rec[f"simt_{key}_ms"] = march_bound_ms(pw, R, S, bwd_, save=save_,
                                                       sdf_dtype="float32")[0]
            del stash64, stash32, act, stash_s
            print(f"[{phase}] ray_march save mode {tag}, {R * S} points: MACs per point bwd "
                  f"{RM.march_macs_per_point(pw, True)[1]} (no recompute) | save forward kernel "
                  f"{rec['save_ms']:.4f} ms, bf16 save twin {rec['save_plain_ms']:.4f} ms, bound "
                  f"{rec['save_bound_ms']:.4f} ms ({rec['save_bound_by']}) | load backward kernel "
                  f"{rec['load_ms']:.4f} ms (with the reduction), bf16 save twin "
                  f"{rec['load_plain_ms']:.4f} ms, bound {rec['load_bound_ms']:.4f} ms "
                  f"({rec['load_bound_by']}) | fwd+bwd: save pair "
                  f"{rec['save_ms'] + rec['load_ms']:.4f} ms", flush=True)
            fwd_macs, bwd_macs = RM.march_macs_per_point(pw)
            print(f"[{phase}] ray_march {tag}, {R * S} points: MACs per point fwd {fwd_macs} bwd "
                  f"{bwd_macs} | forward kernel {rec['ms']:.4f} ms, bf16 twin "
                  f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
                  f"f32 {rec['bound32_ms']:.4f} ms) | backward kernel {rec['bwd_ms']:.4f} ms (with "
                  f"the reduction), bf16 twin {rec['plain_bwd_ms']:.4f} ms, bound "
                  f"{rec['bwd_bound_ms']:.4f} ms ({rec['bwd_bound_by']}; f32 "
                  f"{rec['bwd_bound32_ms']:.4f} ms) | fwd+bwd: "
                  f"kernels {rec['ms'] + rec['bwd_ms']:.4f} ms, composed rows 5 + 6 + torch "
                  f"compositing {rec['composed_ms']:.4f} ms", flush=True)
            out.update(rec)
    # the clip's tie rule: rays deep inside the surface, every point a tie
    rcfg, pw, o, d, z, inv_s, gbar = tie_inputs(device, R, TIE_SAMPLES, SEED + 140, mode)
    sd = 2.0 / rcfg.n_samples
    ties = tie_counts(pw, o, d, z, inv_s, sd)
    _, stash = RM.launch_ray_march(pw, o, d, z, inv_s, sd)
    s_hat = float(RM.launch_ray_march_bwd(pw, o, d, z, inv_s, sd, stash, gbar)[2])
    pw64 = PP.PipelineWeights(rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                      for layers in (pw.sdf, pw.color, pw.relight)])
    want = float(RM.ray_march_bwd_plain(pw64, o.double(), d.double(), z.double(),
                                        inv_s.double(), sd, gbar.double(), bf16=True)[2])
    plain = float(RM.ray_march_bwd_plain(pw, o, d, z, inv_s, sd, gbar, bf16=True)[2])
    err = abs(s_hat - want) / max(abs(want), 1e-300)
    _, stash_t, act_t = RM.launch_ray_march_save(pw, o, d, z, inv_s, sd)
    s_hat_s = float(RM.launch_ray_march_bwd_load(pw, o, d, z, inv_s, sd, stash_t, act_t,
                                                 gbar)[2])
    args64 = (o.double(), d.double(), z.double(), inv_s.double(), sd)
    _, stash64 = RM.ray_march_plain(pw64, *args64, bf16=True, save=True)
    want_s = float(RM.ray_march_bwd_plain(pw64, *args64, gbar.double(), bf16=True,
                                          stash=stash64)[2])
    err_s = abs(s_hat_s - want_s) / max(abs(want_s), 1e-300)
    print(f"[{phase}] ray_march {mode} tie rays ({R} x {TIE_SAMPLES} points deep inside, inv_s "
          f"{float(inv_s):.1f}): q == 1 exactly at {ties[0]} points in float32, {ties[1]} in "
          f"float64 | inv_s grad kernel {s_hat:.6e}, bf16 twin in float64 {want:.6e}, rel "
          f"{err:.3e} (rtol {RTOL_MARCH_TIE:g}; a gate of 1.0 reads 1.0) | f32 bf16 twin "
          f"{plain:.6e} "
          f"(its suffix sum cancels at alpha == 1; no check) | save pair: load kernel "
          f"{s_hat_s:.6e}, save twin in float64 {want_s:.6e}, rel {err_s:.3e}", flush=True)
    if ties != (R * TIE_SAMPLES,) * 2:
        fails.append(f"tie rays: {ties} points at q == 1 (f32, f64), want all {R * TIE_SAMPLES}")
    if not err <= RTOL_MARCH_TIE:
        fails.append(f"tie rays: inv_s grad {err:.3e} from float64, above {RTOL_MARCH_TIE:g}")
    if not err_s <= RTOL_MARCH_TIE:
        fails.append(f"tie rays, save pair: inv_s grad {err_s:.3e} from float64, above "
                     f"{RTOL_MARCH_TIE:g}")
    check(not fails, "; ".join(fails))
    return out


def cuobjdump_path():
    import shutil
    from color_neus_torch.ops.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    return tool if os.path.exists(tool) else shutil.which("cuobjdump")


SASS_OP = re.compile(r"\s*/\*[0-9a-f]+\*/\s+(@!?\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*)")


def kernel_variant(mangled: str) -> str:
    """kernel_name with its template arguments (bool and int literals),
    e.g. sdf_rays_bf16_kernel<0,0,64>."""
    name = kernel_name(mangled)
    i = mangled.find(name)
    rest = mangled[i + len(name):] if i >= 0 else ""
    if not rest.startswith("I"):
        return name
    args = re.findall(r"L[bi](\d+)E", rest[:rest.find("EE") + 2])
    return f"{name}<{','.join(args)}>"


def sass_counts(lib_path) -> dict:
    """{kernel variant: {"HMMA": HMMA.16816.F32.BF16, "HGMMA" (wgmma, any
    shape), "FFMA", "UBLKCP" (TMA bulk copies), "LDGSTS" (16-byte
    cp.async), "FCHK" (the IEEE divide's range check), "REDG" (reductions
    into device memory), "UBLKRED" (TMA bulk reductions), "CALL": [call
    targets]}} of every __global__ function in a built library's SASS
    (cuobjdump -sass)."""
    out = subprocess.run([cuobjdump_path(), "-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib_path} failed: {out.stderr.strip()}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            cur = kernel_variant(line.split("Function :", 1)[1].strip())
            counts[cur] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0, "UBLKCP": 0, "LDGSTS": 0,
                           "FCHK": 0, "REDG": 0, "UBLKRED": 0, "CALL": []}
        elif cur is not None:
            m = SASS_OP.match(line)
            if m:
                op, head = m.group(2), m.group(2).split(".")[0]
                c = counts[cur]
                c["HMMA"] += op == "HMMA.16816.F32.BF16"
                for k in ("HGMMA", "FFMA", "UBLKCP", "LDGSTS", "FCHK", "REDG", "UBLKRED"):
                    c[k] += head == k
                if head == "CALL":
                    c["CALL"].append(m.group(3).strip())
    return counts


def sass_digests(lib_path) -> dict:
    """{kernel variant: sha256 of its SASS} of every __global__ function in
    a built library (cuobjdump -sass): each instruction's predicate, opcode
    and operands in order, without its address and encoding, and with
    every mangled name as one token (the unnamed namespace's name carries
    a hash of the source's path, which differs between two checkouts)."""
    import hashlib
    out = subprocess.run([cuobjdump_path(), "-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib_path} failed: {out.stderr.strip()}")
    digests, cur = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            cur = kernel_variant(line.split("Function :", 1)[1].strip())
            digests[cur] = hashlib.sha256()
        elif cur is not None:
            m = SASS_OP.match(line)
            if m:
                ins = f"{m.group(1) or ''}{m.group(2)} {m.group(3)}"
                digests[cur].update(re.sub(r"_Z[\w.$]+", "SYM", ins).encode() + b"\n")
    return {k: h.hexdigest() for k, h in digests.items()}


def nvcc_release() -> str:
    """The `release x.y, Vx.y.z` part of `nvcc --version`."""
    from color_neus_torch.ops.kernels import build
    out = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                         timeout=60)
    m = re.search(r"release [^\n]*", out.stdout)
    return m.group(0).strip() if m else out.stdout.strip()


def sass_identity_check(libs):
    """Phase 1: the rows 3-6 entries the march entries' redesigns left as
    they were (UNCHANGED_KERNELS, each mode's) hold
    the SASS of the sources before it, instruction for instruction: their
    digests (sass_digests) against UNCHANGED_SASS, recorded from those
    sources' libraries under the nvcc release UNCHANGED_SASS_NVCC. Under
    another release the digests are printed and not compared."""
    from color_neus_torch.ops.kernels import point_pipeline as PP
    release = nvcc_release()
    got = {}
    for mode in PP.MODES:
        name = PP.library_name("point_pipeline", mode)
        got.update({k: v for k, v in sass_digests(libs[name]).items()
                    if re.sub(r"_(bf16s|f32s)$", "", k) in UNCHANGED_KERNELS})
    same = {k: UNCHANGED_SASS.get(k) == v for k, v in got.items()}
    print(f"[1] SASS of the unchanged rows 5-6 entries ({len(got)}; nvcc {release}) against "
          f"their build before the march entries' redesigns: " + ", ".join(f"{k} {'equal' if ok else 'DIFFERS ' + got[k][:12]}"
                                        for k, ok in sorted(same.items())), flush=True)
    if release != UNCHANGED_SASS_NVCC:
        print(f"[1] not compared: UNCHANGED_SASS was recorded under nvcc {UNCHANGED_SASS_NVCC}",
              flush=True)
        return same
    check(len(got) == len(UNCHANGED_KERNELS) * len(PP.MODES),
          f"unchanged rows 5-6 entries in the SASS: {sorted(got)}")
    check(all(same.values()), "an unchanged rows 5-6 entry's SASS differs from its earlier build: "
          + ", ".join(k for k, ok in same.items() if not ok))
    return same


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def _sass_main_path(lines):
    """(FP32-pipe, MUFU) instructions of one function in cuobjdump -sass
    lines, from the entry to its first unpredicated EXIT, in address
    order: the in-line code, without the out-of-line slow-path
    subroutines the compiler places after the EXIT (the IEEE divide's and
    reciprocal's, reached by CALL). Both sides of an in-line branch count,
    and predicated instructions count (they take an issue slot). FP32
    counts FFMA, FADD and FMUL only (a lower count). None if there is no
    EXIT."""
    fp32 = mufu = 0
    for line in lines:
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m is None:
            continue
        op = m.group(2)
        if op == "EXIT" and m.group(1) is None:
            return fp32, mufu
        fp32 += op.split(".")[0] in ("FFMA", "FADD", "FMUL")
        mufu += op.startswith("MUFU")
    return None


def _probe_functions(kernel, define, label):
    """({label: SASS lines} of the probe functions of csrc/<kernel>.cu, built
    alone with nvcc -D<define> -cubin in the library's code generation, for
    every function whose mangled name label(name) maps to a label), or
    (None, the reason)."""
    from color_neus_torch.ops.kernels import build
    tool = cuobjdump_path()
    if tool is None:
        return None, "no cuobjdump"
    cubin = os.path.join(build.BUILD_DIR, f"{kernel}_probe_{os.getpid()}.cubin")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cc = subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                         "-std=c++17", "-O3", f"-D{define}", "-cubin", "-o", cubin,
                         os.path.join(build.CSRC, f"{kernel}.cu")],
                        capture_output=True, text=True, timeout=300)
    check(cc.returncode == 0, f"nvcc of the instruction probes failed:\n{cc.stdout}{cc.stderr}")
    out = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True, timeout=300)
    os.remove(cubin)
    if out.returncode != 0:
        return None, f"cuobjdump failed: {out.stderr.strip()}"
    funcs, cur = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            cur = label(line.split("Function :", 1)[1].strip())
            if cur is not None:
                funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(line)
    return funcs, "read"


@functools.lru_cache(maxsize=None)
def sweep_epilogue_counts():
    """({"softplus" | "relu": (FP32-pipe, MUFU) instructions per activated
    element} of rows 1 and 2's epilogue, "read"), or (None, the reason):
    csrc/sdf_rays.cu's probes (-DSDF_RAYS_PROBE: bias add, activation and
    the skip's scale of one element, the kernels' own device functions),
    each one's in-line code (_sass_main_path) less the copy probe's. The
    softplus's exp takes the one MUFU (log1pf is a polynomial on the FP32
    pipe); every element takes its whole in-line path (no early exit), and
    its form has no divide."""
    def probe(name):
        m = re.search(r"sdf_epilogue_probeILb(\d)E", name)
        return ("relu" if m.group(1) == "1" else "softplus") if m else \
            ("copy" if "sdf_copy_probe" in name else None)
    funcs, how = _probe_functions("sdf_rays", "SDF_RAYS_PROBE", probe)
    if funcs is None:
        return None, how
    reads = {k: _sass_main_path(v) for k, v in funcs.items()}
    if sorted(reads) != ["copy", "relu", "softplus"] or any(v is None for v in reads.values()):
        return None, f"probe read failed: {reads}"
    base = reads["copy"]
    per = {k: (v[0] - base[0], v[1] - base[1]) for k, v in reads.items() if k != "copy"}
    if per["softplus"][1] < 1:   # the exp: a read that misses it went astray
        return None, f"probe read missed the softplus's exp: {per}"
    return per, "read"


@functools.lru_cache(maxsize=None)
def pipe_rates():
    """(SMs, max SM clock in MHz) of card 0, for the pipes' rates."""
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count, max_sm_clock_mhz()


def epilogue_counts():
    """{line name: (FP32-pipe, MUFU) instructions per activated element}
    for the nine chains and the deferred one ('deferred'), or None with
    the reason. csrc/mlp_chain.cu's instruction probes (one element per
    thread, the chains' own device functions) are built alone with nvcc
    -DMLP_CHAIN_PROBE -cubin and read with cuobjdump -sass; each probe's
    in-line code (_sass_main_path) less the none probe's. That counts what
    an element issues: not the chains' unrolled or peeled copies, nor the
    out-of-line slow paths of the IEEE divide. It counts the log1p path
    of the softplus forms, which a warp skips only when all of its 32
    lanes are above 100 x = 30 (the chain's first layers hold that for a
    minority of elements, its later layers for none), and log1pf's
    in-line fixup of special inputs (one predicated FFMA that this run's
    data skips: an overcount of 1 per log1p). The deferred layer must count as the
    expm1gate form, whose sp and gate it computes, or it is not
    counted."""
    from color_neus_torch.ops.kernels import mlp_chain as MC

    def probe(name):
        m = re.search(r"mlp_chain_act_probeILi(\d+)E", name)
        return MC.ACTIVATIONS[int(m.group(1))][0] if m else \
            ("deferred" if "mlp_chain_deferred_probe" in name else None)
    funcs, how = _probe_functions(MC.KERNEL, "MLP_CHAIN_PROBE", probe)
    if funcs is None:
        return None, how
    reads = {k: _sass_main_path(v) for k, v in funcs.items()}
    want = [n for n, _ in MC.ACTIVATIONS] + ["deferred"]
    if sorted(reads) != sorted(want) or any(v is None for v in reads.values()):
        return None, f"probe read failed: {reads}"
    base = reads["none"]
    per = {k: (v[0] - base[0], v[1] - base[1]) for k, v in reads.items()}
    # every form but none and relu takes an exp: a read that misses it went astray
    if any(per[n][1] < 1 for n in want if n not in ("none", "relu")):
        return None, f"probe read missed an exp: {per}"
    d, g = per["deferred"], per["expm1gate"]
    if not (d[1] == g[1] and abs(d[0] - g[0]) <= 2):
        return {k: v for k, v in per.items() if k != "deferred"}, \
            f"deferred layer {d} does not count as expm1gate {g}: deferred not counted"
    return per, "read"


def chain_bound_ms(n, L, bf16, epi, clock_mhz, sms, f32="f32x6"):
    """Least time of one chain call on n rows: the larger of its products at
    the bf16 peak (bf16; f32: as six bf16 passes, f32="f32x6", or at the f32
    SIMT peak, f32="float32"), its bytes (x read once, out written once), and,
    where epilogue_counts read them, its epilogue's FP32-pipe and MUFU
    instructions per element at those pipes' rates (sms x 128 / 16 per
    clock, at clock_mhz).
    Returns (ms, "bytes" | "operations", what sets it)."""
    elems = n * 256 * L
    parts = {"products": 2 * elems * 256 / PEAK_FLOPS["bfloat16" if bf16 else f32],
             "bytes": 2 * n * 256 * 4 / PEAK_BYTES_PER_S}
    if epi is not None:
        parts["FP32 pipe"] = epi[0] * elems / (sms * FP32_LANES_PER_SM * clock_mhz * 1e6)
        parts["MUFU"] = epi[1] * elems / (sms * MUFU_PER_SM * clock_mhz * 1e6)
    what = max(parts, key=parts.get)
    return parts[what] * 1e3, ("bytes" if what == "bytes" else "operations"), what


def cublas_products_ms(x, w, L, bf16):
    """The yardstick: the same L products by torch.matmul in the chain's
    product type, no activation (no single PyTorch call is the chain)."""
    import torch
    dt = torch.bfloat16 if bf16 else torch.float32
    xa, wa = x.to(dt), w.to(dt)

    def products():
        y = xa
        for _ in range(L):
            y = y @ wa
        return y
    return cuda_ms(products, reps=3, warmup=1)


def chain_error_stats(y, ref) -> dict:
    """y's signed error toward |ref| (float64), (y - ref) sign(ref) over
    ref's RMS: its mean, RMS and the mean's standard error."""
    import math
    e = (y.double() - ref) * ref.sign() / ref.square().mean().sqrt()
    return {"mean": float(e.mean()), "rms": float(e.square().mean().sqrt()),
            "se": float(e.std() / math.sqrt(e.numel()))}


def chain_bias_limit(plain) -> float:
    """The limit of the f32 chain's |mean| signed error (CHAIN_SE_FLOOR's
    note): F32_BIAS_FACTOR x the largest over `plain` (the plain f32
    path's chain_error_stats, a layer or a case each) of its |mean|, floored
    at CHAIN_SE_FLOOR standard errors and at CHAIN_RMS_FLOOR of its RMS."""
    return F32_BIAS_FACTOR * max(max(abs(st["mean"]), CHAIN_SE_FLOOR * st["se"],
                                     CHAIN_RMS_FLOOR * st["rms"]) for st in plain)


def f32_chain_gate(x, w) -> dict:
    """Phase 9, the f32 chain against float64 (CHAIN_RMS_FLOOR's note): none
    over CHAIN_L layers, a layer a call on the float64 chain's previous
    output rounded to f32, and every activation at L = 1; besides, the
    L = CHAIN_L call and the plain path's against the float64 chain, and
    that call equal to CHAIN_L L = 1 calls on the kernel's own outputs
    (each layer's input is the f32 activation either way). Prints, checks;
    returns the records."""
    import torch
    from color_neus_torch.ops.kernels import mlp_chain as MC
    x64, w64 = x.double(), w.double()
    layers, acts = [], {}
    r = x64
    for _ in range(CHAIN_L):
        xin = r.float()
        ref = MC.chain_plain(xin.double(), w64, 1, "none", False)
        layers.append({"kernel": chain_error_stats(MC.launch_chain(xin, w, 1, "none", False), ref),
                       "plain": chain_error_stats(MC.chain_plain(xin, w, 1, "none", False), ref)})
        r = MC.chain_plain(r, w64, 1, "none", False)
        del xin, ref
    whole = MC.launch_chain(x, w, CHAIN_L, "none", False)
    chain = {"kernel": chain_error_stats(whole, r),
             "plain": chain_error_stats(MC.chain_plain(x, w, CHAIN_L, "none", False), r)}
    k = x
    for _ in range(CHAIN_L):
        k = MC.launch_chain(k, w, 1, "none", False)
    torch.cuda.synchronize()
    chained = bool(torch.equal(whole, k))
    del k, r, whole
    for name, act in MC.ACTIVATIONS:
        gw = 1.0 if name in MC.GATED else MC.GATE_W
        r = MC.chain_plain(x64, w64, 1, act, False, gw)
        acts[name] = {"kernel": chain_error_stats(MC.launch_chain(x, w, 1, act, False, gw), r),
                      "plain": chain_error_stats(MC.chain_plain(x, w, 1, act, False, gw), r)}
        del r
    bias = chain_bias_limit([rec["plain"] for rec in layers])
    print(f"[9] f32 chain against float64, {x.shape[0]} x 256, signed error toward |float64| "
          f"over its RMS, mean / RMS kernel (plain): none, each of {CHAIN_L} layers on the "
          f"float64 chain's input "
          + " ".join(f"{l}: {rec['kernel']['mean']:.2e} / {rec['kernel']['rms']:.2e} "
                     f"({rec['plain']['mean']:.2e} / {rec['plain']['rms']:.2e})"
                     for l, rec in enumerate(layers))
          + f" | |mean| limit {bias:.2e} (plain se {layers[0]['plain']['se']:.1e}) | the "
          f"L = {CHAIN_L} call against the float64 chain: {chain['kernel']['mean']:.2e} / "
          f"{chain['kernel']['rms']:.2e} ({chain['plain']['mean']:.2e} / "
          f"{chain['plain']['rms']:.2e}) | {CHAIN_L} L = 1 calls chained equal it bitwise: "
          f"{chained}", flush=True)
    check(chained, f"the f32 chain's {CHAIN_L} L = 1 calls differ from its L = {CHAIN_L} call")
    check(chain["kernel"]["rms"] <= F32_BIAS_FACTOR * chain["plain"]["rms"],
          f"[9] f32 chain L = {CHAIN_L}: RMS error {chain['kernel']['rms']:.3e} against the "
          f"float64 chain, above {F32_BIAS_FACTOR:g}x the plain path's")
    for l, rec in enumerate(layers):
        kk, pp = rec["kernel"], rec["plain"]
        check(abs(kk["mean"]) <= bias, f"[9] f32 chain layer {l}: mean signed error "
              f"{kk['mean']:.3e} against float64, above {bias:.3e}")
        check(kk["rms"] <= F32_BIAS_FACTOR * pp["rms"], f"[9] f32 chain layer {l}: RMS error "
              f"{kk['rms']:.3e} against float64, above {F32_BIAS_FACTOR:g}x the plain path's "
              f"{pp['rms']:.3e}")
    for name, rec in acts.items():
        kk, pp = rec["kernel"], rec["plain"]
        lim = chain_bias_limit([pp])
        print(f"[9] f32 chain against float64, {name} L 1: mean {kk['mean']:.3e} (plain "
              f"{pp['mean']:.3e}, se {pp['se']:.1e}; limit {lim:.2e}) | RMS {kk['rms']:.3e} "
              f"(plain {pp['rms']:.3e})", flush=True)
        check(abs(kk["mean"]) <= lim, f"[9] f32 chain {name} L 1: mean signed error "
              f"{kk['mean']:.3e} against float64, above {lim:.3e}")
        check(kk["rms"] <= F32_BIAS_FACTOR * pp["rms"], f"[9] f32 chain {name} L 1: RMS error "
              f"{kk['rms']:.3e} against float64, above {F32_BIAS_FACTOR:g}x the plain path's")
    return {"layers": layers, "acts": acts, "chain": chain, "bias_limit": bias,
            "chained": chained}


def wgmma_truncation(device) -> dict:
    """Phase 9: the tensor cores' rounding. One m64n128k16 bf16 wgmma, d = c
    + a b (csrc/mlp_chain.cu wgmma_probe_kernel), on seeded N(0, 1) a and b
    and c of each scale in WGMMA_PROBE_C, WGMMA_PROBE_DRAWS draws; its error
    against the exact sum (float64) in f32 ulps of that sum, signed toward
    |sum| (negative: toward zero), and how often d equals the sum rounded
    to f32 toward zero (the CPU emulator's model, tests/cuda_emu
    EMU_WGMMA_TRUNCATE) or to nearest. Prints; returns the records."""
    import torch
    from color_neus_torch.ops.kernels import mlp_chain as MC
    g = torch.Generator(device=device).manual_seed(SEED + 210)
    out = {}
    for scale in WGMMA_PROBE_C:
        errs, rz_hits, rn_hits, n = [], 0, 0, 0
        for _ in range(WGMMA_PROBE_DRAWS):
            a = torch.randn((64, 16), generator=g, device=device).to(torch.bfloat16)
            b = torch.randn((128, 16), generator=g, device=device).to(torch.bfloat16)
            c = torch.randn((64, 128), generator=g, device=device) * scale
            d = MC.wgmma_probe(a, b, c)
            exact = c.double() + a.double() @ b.double().T
            _, e = torch.frexp(exact)
            ulp = torch.ldexp(torch.ones_like(exact), (e - 24).to(torch.int32))
            errs.append((d.double() - exact) * exact.sign() / ulp)
            rn = exact.float()
            rz = torch.where(rn.double().abs() > exact.abs(),
                             torch.nextafter(rn, torch.zeros_like(rn)), rn)
            rz_hits += int((d == rz).sum())
            rn_hits += int((d == rn).sum())
            n += d.numel()
        err = torch.cat([t.reshape(-1) for t in errs])
        q = torch.quantile(err, torch.tensor([0.0, 0.01, 0.5, 0.99, 1.0], device=device,
                                             dtype=err.dtype)).tolist()
        inside = err[(err > -1) & (err <= 0)]
        rec = {"n": n, "mean_ulp": float(err.mean()), "quantiles": q,
               "in_rz_range": inside.numel() / n, "mean_in_range": float(inside.mean()),
               "eighths": float((inside * 8 == (inside * 8).round()).double().mean()),
               "quarters": float((inside * 4 == (inside * 4).round()).double().mean()),
               "rz": rz_hits / n, "rn": rn_hits / n}
        out[f"c ~ {scale:g} N(0, 1)"] = rec
        print(f"[9] wgmma m64n128k16 bf16 rounding, c ~ {scale:g} N(0, 1), {n} outputs: error "
              f"toward |exact| in ulps mean {rec['mean_ulp']:+.4f}, quantiles 0 / 1 / 50 / 99 / "
              f"100%: {' / '.join(f'{v:+.3f}' for v in q)} | in (-1, 0]: {rec['in_rz_range']:.4f}"
              f" (their mean {rec['mean_in_range']:+.4f}; multiples of 1/8 ulp "
              f"{rec['eighths']:.4f}, of 1/4 {rec['quarters']:.4f}) | equal to the exact sum "
              f"rounded toward zero (the emulator's model): {rec['rz']:.4f}, to nearest: "
              f"{rec['rn']:.4f}", flush=True)
        check(bool(torch.isfinite(err).all()), f"[9] wgmma probe: non-finite output")
    return out


def ring_rate(w, n_rows) -> dict:
    """Phase 9: the f32 chain's slabs from L2 into shared memory alone
    (csrc/mlp_chain.cu ring_probe_kernel: its ring, no products), one block
    an SM, the image (pack_w3_image of w) shared by every block or in
    RING_PROBE_COPIES copies; GB/s, and the time the chain's slabs need at
    that rate on n_rows rows over CHAIN_L layers (two 64-row tiles a slab)."""
    import torch
    from color_neus_torch.ops.kernels import mlp_chain as MC
    sms = torch.cuda.get_device_properties(w.device).multi_processor_count
    img = MC.pack_w3_image(w).reshape(-1)
    need = -(-n_rows // 128) * CHAIN_L * img.numel() * 2
    out = {}
    for copies in (1, RING_PROBE_COPIES):
        buf = img.repeat(copies)
        moved = MC.ring_probe(buf, copies, RING_PROBE_SLABS, sms)
        ms = cuda_ms(lambda: MC.ring_probe(buf, copies, RING_PROBE_SLABS, sms),
                     reps=RING_PROBE_REPS, warmup=1)
        rate = moved / (ms * 1e-3)
        out[copies] = {"ms": ms, "GBps": rate / 1e9, "chain_ms": need / rate * 1e3}
        print(f"[9] the f32 chain's ring alone ({sms} blocks x {RING_PROBE_SLABS} slabs of "
              f"{moved // (sms * RING_PROBE_SLABS) // 1024} KB, "
              f"{'one image' if copies == 1 else f'{copies} images'}): {ms:.4f} ms, "
              f"{rate / 1e9:.1f} GB/s from L2 | the chain's {need / 1e9:.1f} GB at this rate: "
              f"{need / rate * 1e3:.2f} ms", flush=True)
    return out


def chain_phase(device):
    """Phase 9: the MLP-chain microbenchmark (rows 7 + 8). (a) The tool's
    sweep through its entry point, launches counted; (b) every kernel
    against its plain version on the card at the tool's main shape, at
    L = 1 (tight) and L = 25, the gates at weight 1e-30 and 1.0, a ragged
    row count; (c) the cuBLAS products-only yardstick, the epilogue's
    instructions per element (epilogue_counts) and the bounds. Prints
    every reading, then checks; returns the records the kernel line
    reads."""
    import torch
    from color_neus_torch.ops.kernels import mlp_chain as MC
    from color_neus_torch.tools import mlp_microbench as tool

    fails = []
    # (a) the tool's sweep, the slice's main path
    reset_launch_counts()
    t0 = time.perf_counter()
    lines = tool.main([])
    torch.cuda.synchronize()
    counts = launch_counts()
    n_f32 = sum(1 for name, *_ in lines if name == "none-f32")
    n_chain = sum(1 for name, *_ in lines if name != "deferred") - n_f32
    want = {k: 0 for k in counts}
    want.update(mlp_chain=n_chain * (tool.REPS + 1), mlp_chain_f32=n_f32 * (tool.REPS + 1),
                mlp_chain_deferred=tool.REPS + 1)
    print(f"[9] the tool's sweep: {len(lines)} lines in {time.perf_counter() - t0:.1f} s | "
          f"launches {counts}", flush=True)
    check(counts == want, f"the tool's sweep launched {counts}, want {want}")
    tool_ms = {name: ms for name, T, L, G, ms in lines if (T, G) == (CHAIN_T, CHAIN_G)}

    # (b) kernels against plain, on the card
    x, w = tool.inputs(CHAIN_T, CHAIN_G, device)
    n = x.shape[0]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    rec = {}

    def compare(label, kernel, plain, tol, rows, L):
        got = kernel()
        torch.cuda.synchronize()
        start.record()
        ref = plain()
        end.record()
        torch.cuda.synchronize()
        ok = got.shape == ref.shape and bool(torch.isfinite(got).all())
        d = (got - ref).abs()
        err, rms = float(d.max()), float(d.square().mean().sqrt())
        print(f"[9] {label:28s} rows {rows:7d} L {L:2d}: max|kernel-plain| {err:.3e} "
              f"(atol {tol:g}), rms {rms:.3e}, |plain| max {float(ref.abs().max()):.3f}", flush=True)
        if not ok:
            fails.append(f"{label} L={L} rows={rows}: bad output")
        if not err <= tol:
            fails.append(f"{label} L={L} rows={rows}: {err:.3e} above {tol:g}")
        return err, start.elapsed_time(end)

    # (label, kernel, plain, L, rows, atol); ragged rows start at row 7, so
    # that no output can sit where an earlier plain result of the same rows lay
    ragged = x[7:7 + CHAIN_RAGGED]
    cases = []
    for bf16 in (True, False):
        dt = "bfloat16" if bf16 else "float32"
        for name, act in MC.ACTIVATIONS:
            runs = [(1, x, gw, ATOL_CHAIN_TIGHT[dt])
                    for gw in ((MC.GATE_W, 1.0) if name in MC.GATED else (MC.GATE_W,))]
            if bf16 or name == "none":   # the tool's f32 arm is none-f32
                tol = ATOL_CHAIN_BF16[name] if bf16 else ATOL_CHAIN_F32
                runs += [(CHAIN_L, xs, MC.GATE_W, tol) for xs in (x, ragged)]
            for L, xs, gw, tol in runs:
                cases.append((f"{name} {dt} gate {gw:g}",
                              partial(MC.launch_chain, xs, w, L, act, bf16, gw),
                              partial(MC.chain_plain, xs, w, L, act, bf16, gw), L, xs, tol,
                              (name if bf16 else "none-f32") if L == CHAIN_L and xs is x
                              else None))
    for L, xs, gw, tol in ((2, x, 1.0, ATOL_CHAIN_DEFERRED_L2),
                           (CHAIN_L, x, MC.GATE_W, ATOL_CHAIN_BF16["deferred"]),
                           (CHAIN_L, ragged, MC.GATE_W, ATOL_CHAIN_BF16["deferred"])):
        cases.append((f"deferred bfloat16 gate {gw:g}",
                      partial(MC.launch_chain_deferred, xs, w, L, gw),
                      partial(MC.chain_deferred_plain, xs, w, L, gw), L, xs, tol,
                      "deferred" if L == CHAIN_L and xs is x else None))
    for label, kernel, plain, L, xs, tol, key in cases:
        err, plain_ms = compare(label, kernel, plain, tol, xs.shape[0], L)
        if key is not None:
            rec[key] = {"err": err, "plain_ms": plain_ms}

    # the f32 chain against float64, the tensor cores' rounding, the ring's rate
    gate = f32_chain_gate(x, w)
    trunc = wgmma_truncation(device)
    ring = ring_rate(w, n)

    # (c) yardsticks and bounds
    cublas = {True: cublas_products_ms(x, w, CHAIN_L, True),
              False: cublas_products_ms(x, w, CHAIN_L, False)}
    per, how = epilogue_counts()
    clock = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"[9] bounds at {sms} SMs x {FP32_LANES_PER_SM} FP32 lanes / {MUFU_PER_SM} MUFU at "
          f"{clock:.0f} MHz (nvidia-smi clocks.max.sm); epilogue instructions per element "
          f"from the probes' SASS: {how} | cuBLAS products only "
          f"(torch.matmul x {CHAIN_L}): bf16 {cublas[True]:.4f} ms, f32 {cublas[False]:.4f} ms",
          flush=True)
    for name, r in rec.items():
        bf16 = name != "none-f32"
        epi = None if per is None else per.get(name.replace("-f32", ""))
        r["ms"] = tool_ms[name]
        r["bound_ms"], r["bound_by"], r["set_by"] = chain_bound_ms(n, CHAIN_L, bf16, epi, clock,
                                                                 sms)
        r["cublas_ms"] = cublas[bf16]
        simt = "" if bf16 else (f" (six bf16 passes; f32 SIMT FFMA "
                                f"{chain_bound_ms(n, CHAIN_L, bf16, epi, clock, sms, 'float32')[0]:.4f}"
                                f" ms) | the kernel {r['cublas_ms'] / r['ms']:.2f}x cuBLAS's speed")
        print(f"[9] {name:10s} {n} x 256 x {CHAIN_L}: kernel {r['ms']:.4f} ms | plain "
              f"{r['plain_ms']:.4f} ms | cuBLAS products only {r['cublas_ms']:.4f} ms | bound "
              f"{r['bound_ms']:.4f} ms ({r['set_by']}){simt} | epilogue per element: "
              + ("not counted" if epi is None else f"{epi[0]} FP32, {epi[1]} MUFU"),
              flush=True)
    check(not fails, "; ".join(fails))
    return {"records": rec, "launches": counts, "f32_gate": gate, "wgmma": trunc, "ring": ring}


def step_grads(loop, pixels, with_loss=False, **renderer):
    """Every trainable leaf's gradient of one step's loss on the given
    pixels, with the renderer switches `renderer` and perturb 0 (no
    parameter update); with_loss: (the loss, the gradients)."""
    import dataclasses
    import torch
    from color_neus_torch.models import trainer as TR
    img_ids, images, cam_sel, py, px, sel_mask = pixels
    tcfg = loop.tcfg
    tc = dataclasses.replace(tcfg, renderer=dataclasses.replace(
        tcfg.renderer, perturb=0.0, **renderer))
    names, leaves = zip(*[(k, p) for k, p in loop.state.params.named_parameters()
                          if p.requires_grad])
    render = TR.render_pixels(loop.state.params, loop.scene, tc, images, img_ids, cam_sel, py,
                              px, sel_mask, None)
    loss, _ = TR.compute_loss(tc, render)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {k: (torch.zeros_like(p) if gr is None else gr)
             for k, p, gr in zip(names, leaves, grads)}
    return (float(loss), grads) if with_loss else grads


def grad_errors(a, b):
    """{leaf: |a - b| / |b|} (L2 norms) over the leaves b reaches,
    {leaf: max|a - b| / max|b|} and {leaf: cosine of a and b}."""
    import torch
    used = [k for k in b if float(b[k].abs().max()) > 0]
    return ({k: float(torch.linalg.norm(a[k] - b[k]) / torch.linalg.norm(b[k])) for k in used},
            {k: _rel(a[k], b[k]) for k in used},
            {k: float(torch.sum(a[k].double() * b[k].double())
                      / (torch.linalg.norm(a[k].double()) * torch.linalg.norm(b[k].double())))
             for k in used})


def training_through(device, trained, seed, key, want, tag, profile_n=2, beside=None):
    """Phases 7 and 8: TrainLoop with RENDERER.<key> on, STEPS steps with
    exactly the launch counts `want`, then one step's leaf gradients on
    (the kernels' bf16 products) vs the f32 plain core (the switch off) on
    the trained weights of phase 3 (`trained`), every leaf within
    RTOL_STEP_GRAD (norm-relative) and MIN_COS_STEP_GRAD (cosine), and,
    printed, against the renderer switches `beside` on the same pixels;
    returns what the kernel line and the summary read."""
    import torch
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import config_from_dict

    model = SMOKE_CFG["MODEL"]
    cfg = config_from_dict({**SMOKE_CFG, "MODEL": {
        **model, "RENDERER": {**model["RENDERER"], key: "on"}}})
    loop = TrainLoop(cfg, device=device)
    switch = key.lower()
    check(getattr(loop.tcfg.renderer, switch) == "on", f"{key} on did not reach the renderer")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(loop)
    t0 = time.perf_counter()
    losses = loop.run(STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(loop)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[{tag}] {switch} on, {STEPS} steps in bundles of {loop.k_steps}: "
          f"{wall * 1e3 / STEPS:.2f} ms/step incl. the warm-up bundle and the capture | loss "
          f"{first:.5f} -> {last:.5f} | launches {counts} | peak memory {peak_gb:.2f} GiB",
          flush=True)
    want = {**{k: 0 for k in counts}, **want}   # every kernel the dict does not name: 0
    check(counts == want, f"{switch} on training launched {counts}, want {want}")
    check(all(x == x and abs(x) != float("inf") for x in losses), f"non-finite loss {losses}")
    check(last < 0.5 * first, f"loss did not halve: first-5 mean {first}, last-5 mean {last}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(STEPS + STEADY_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / STEADY_STEPS
    n_rays = loop.tcfg.n_rays
    print(f"[{tag}] steady state (2 replays), {switch} on: {step_ms:.2f} ms/step | "
          f"{n_rays / step_ms * 1e3:.0f} rays/s", flush=True)
    profile_steps(loop, n_steps=profile_n, top=6, tag=tag)

    # one step's gradients on phase 3's trained weights: on against off
    pixels = step_pixels(trained, seed)
    on, off = (step_grads(trained, pixels, **{switch: m}) for m in ("on", "off"))
    errs, errs_max, cos = grad_errors(on, off)
    worst, worst_max = max(errs, key=errs.get), max(errs_max, key=errs_max.get)
    worst_cos = min(cos, key=cos.get)
    if beside:
        other = step_grads(trained, pixels, **beside)
        for name, (a, b) in ((f"{switch} on vs {beside}", (on, other)),
                             (f"{beside} vs {switch} off", (other, off))):
            e = grad_errors(a, b)[0]
            w = max(e, key=e.get)
            print(f"[{tag}] the same pixels, {name}: worst |a-b| / |b| {e[w]:.3e} ({w}), "
                  f"median {sorted(e.values())[len(e) // 2]:.3e}", flush=True)
    print(f"[{tag}] one step's leaf gradients on the trained weights, {switch} on (bf16 "
          f"products) vs off (f32): {len(errs)} leaves, worst |on-off| / |off| "
          f"{errs[worst]:.3e} ({worst}), median {sorted(errs.values())[len(errs) // 2]:.3e} "
          f"(rtol {RTOL_STEP_GRAD:g}, median {RTOL_STEP_GRAD_MEDIAN:g}); min cosine {cos[worst_cos]:.6f} ({worst_cos}; limit "
          f"{MIN_COS_STEP_GRAD:g}); worst max|on-off| / max|off| {errs_max[worst_max]:.3e} "
          f"({worst_max}) | the TPU's audit of this arithmetic: worst 4.64e-2, min cosine "
          f"0.9989", flush=True)
    median = sorted(errs.values())[len(errs) // 2]
    check(errs[worst] <= RTOL_STEP_GRAD, f"step gradient {worst}: on vs off {errs[worst]:.3e}")
    check(median <= RTOL_STEP_GRAD_MEDIAN, f"step gradients: median on vs off {median:.3e}")
    check(cos[worst_cos] >= MIN_COS_STEP_GRAD,
          f"step gradient {worst_cos}: cosine on vs off {cos[worst_cos]:.6f}")
    return {"counts": counts, "step_ms": step_ms, "grad_err": errs[worst], "peak_gb": peak_gb,
            "loop": loop}


def march_modes(device, loop):
    """Phase 8's recompute beside its save mode: a TrainLoop as phase 8's
    with MARCH_ACTS recompute trains 2 bundles, the launch counts set to 0
    just before and read just after (the recompute pair once each a step,
    no save-mode kernel); then host ms/step of 2 captured bundles of each
    loop, save / recompute / save / recompute in this one process (phase
    8's loop first brought to a bundle boundary), and each mode's peak
    memory over one uncaptured step (a captured bundle's memory sits in its
    graph's pool, which the allocated peak does not count)."""
    import torch
    from color_neus_torch.runtime import TrainLoop
    rec = TrainLoop(arm_cfg("fused_march_recompute"), device=device)
    check(rec.tcfg.renderer.march_acts == "recompute" and loop.tcfg.renderer.march_acts
          == "auto", "the two march modes did not reach the renderers")
    steps = 2 * BUNDLE
    torch.cuda.synchronize()
    reset_launch_counts(rec)
    rec.run(steps)
    torch.cuda.synchronize()
    counts = launch_counts(rec)
    want = {k: 0 for k in counts}
    want.update(sdf_rays=SWEEPS_PER_STEP * steps, ray_march=steps, ray_march_bwd=steps)
    check(counts == want, f"the recompute run launched {counts}, want {want}")
    loop.run(-(-loop.state.step // BUNDLE) * BUNDLE)
    ms, peak = {"save": [], "recompute": []}, {}
    for mode, lp in (("save", loop), ("recompute", rec)) * 2:
        ms[mode].append(host_ms(lambda: lp.run(lp.state.step + steps), steps))
    for mode, lp in (("save", loop), ("recompute", rec)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lp.training_step()
        torch.cuda.synchronize()
        peak[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[8] MARCH_ACTS recompute beside auto (save at this shape): {steps} steps launched "
          f"{counts} | host ms/step, captured bundles, save {ms['save'][0]:.2f} / recompute "
          f"{ms['recompute'][0]:.2f} / save {ms['save'][1]:.2f} / recompute "
          f"{ms['recompute'][1]:.2f} | peak memory of an uncaptured step save "
          f"{peak['save']:.2f} GiB, recompute {peak['recompute']:.2f} GiB (both loops "
          f"resident)", flush=True)
    del rec
    torch.cuda.empty_cache()
    return {"counts": counts, "ms": ms, "peak": peak}


@contextlib.contextmanager
def bf16_twin_in_place(on):
    """Within the block (when on), row 5's launch computes the bf16 plain
    twin instead (the same [n, 16] lanes, no launch counted): the kernel
    path's rendering through the twin, for phase 6e."""
    import torch
    from color_neus_torch.ops.kernels import point_pipeline as PP
    launch = PP.launch_point_pipeline

    def twin(pw, pts, dirs):
        outs = PP.point_pipeline_plain(pw, pts, dirs, bf16=True)
        return torch.cat(list(outs) + [outs[1].new_zeros((pts.shape[0], 3))], dim=1)

    twin.launches = launch.launches
    if on:
        PP.launch_point_pipeline = twin
    try:
        yield
    finally:
        PP.launch_point_pipeline = launch


def sorted_rows(v):
    import numpy as np
    return v[np.lexsort(v.T)]


def trained_grid_chunk(sdf_params, sdf_cfg, bmin, bmax, device, tag):
    """The grid SDF on one 2^18-point chunk of the res-512 lattice (the
    plane through the bbox centre, where the surface is) on trained
    weights, f32 and bf16: kernel against plain, timed with CUDA events,
    beside the bound; returns {prec: record}."""
    import torch
    from color_neus_torch.ops.kernels import sdf_mlp
    pts = lattice_chunk(bmin, bmax, EVAL_RES, EVAL_RES ** 3 // 2, GRID_CHUNK, device)
    out = {}
    for prec in ("f32", "bf16"):
        fn = sdf_mlp.make_fused_sdf_fn(sdf_params, sdf_cfg, prec)
        with torch.no_grad():
            got = fn(pts)
            want = sdf_mlp.sdf_points_plain(fn.weights, pts)
            err = float((got - want).abs().max())
            ms = cuda_ms(lambda: fn(pts))
            plain_ms = cuda_ms(lambda: sdf_mlp.sdf_points_plain(fn.weights, pts), reps=5)
        bound, bound_by, what = grid_bound_ms(fn.weights, GRID_CHUNK)
        print(f"[{tag}] sdf_points {prec:4s} on the trained weights, {GRID_CHUNK} points of the "
              f"res-{EVAL_RES} lattice's centre plane: |sdf| max {float(want.abs().max()):.3f} | "
              f"max|kernel-plain| {err:.3e} (atol {ATOL_GRID[prec]:g}) | kernel {ms:.4f} ms | "
              f"plain {plain_ms:.4f} ms | bound {bound:.4f} ms ({bound_by}: {what})", flush=True)
        out[prec] = {"err": err if bool(torch.isfinite(got).all()) else float("inf"), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound}
    return out


def evaluation_path(loop, device, launches_training):
    """Phase 6 on the trained weights of phase 3; returns what the kernel
    line reads (launches of the evaluation run, errors)."""
    import dataclasses
    import numpy as np
    import torch
    from color_neus_torch.models import trainer as TR
    from color_neus_torch.ops import mesh
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import sdf_mlp
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import config_from_dict
    from color_neus_torch.utils.metrics import mse2psnr
    from color_neus_torch.utils.recorder import Recorder

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) checkpoint -> the evaluate entry's loader, bitwise
        rec = Recorder("default", loop.cfg, root=tmp)
        path = rec.record_checkpoint(loop.state, loop.generator)
        cfg = config_from_dict({**SMOKE_CFG, "MODEL": {**SMOKE_CFG["MODEL"],
                                                       "PRETRAINED": path}})
        ev = TrainLoop(cfg, device=device)
        mine = dict(loop.state.params.named_parameters())
        theirs = dict(ev.state.params.named_parameters())
        n_tensors = 0
        for name, p in mine.items():
            check(torch.equal(p, theirs[name]), f"checkpoint: {name} differs after reload")
            st, st2 = loop.state.optimizer.state[p], ev.state.optimizer.state[theirs[name]]
            check(st.keys() == st2.keys(), f"checkpoint: optimizer keys of {name} differ")
            for k in st:
                check(torch.equal(st[k], st2[k]), f"checkpoint: optimizer {k} of {name} differs")
                n_tensors += 1
            n_tensors += 1
        check(ev.state.step == loop.state.step == int(ev.state.step_t),
              "checkpoint: step differs")
        with np.load(path) as data:
            check(torch.equal(torch.from_numpy(data["generator"]), loop.generator.get_state()),
                  "checkpoint: generator state differs")
        print(f"[6a] checkpoint {os.path.getsize(path) / 2 ** 20:.1f} MiB at step "
              f"{ev.state.step}: {n_tensors} tensors, step and generator bitwise equal "
              f"after reload through TrainLoop(MODEL.PRETRAINED)", flush=True)

        # (b) testing_step at res 512, sparse
        ev.recorder = Recorder("eval_smoke", cfg, root=tmp)
        check(ev.tcfg.renderer.extract_sparse, "the smoke config extracts sparse")
        torch.cuda.synchronize()
        reset_launch_counts()
        out = ev.testing_step(ev.state.step, recon_res=EVAL_RES)
        torch.cuda.synchronize()
        counts = launch_counts()
        st = ev.last_mesh_stats
        check(out is not None and st["n_verts"] > 0, f"res {EVAL_RES} mesh is empty")
        verts, tris, colors = out
        for suffix in ("mesh", "color"):
            ply = os.path.join(ev.recorder.mesh_dir, f"{ev.state.step:08d}_{suffix}.ply")
            check(os.path.getsize(ply) > 0, f"{ply} not written")
        check(counts["sdf_points"] > 0 and counts["point_pipeline"] > 0,
              f"testing_step launched {counts}")
        check(bool(np.isfinite(verts).all()) and bool(np.isfinite(colors).all())
              and colors.shape == verts.shape, "mesh or colours not finite")
        radius = np.linalg.norm(verts, axis=-1)
        print(f"[6b] testing_step res {EVAL_RES} sparse: coarse grid {st['coarse_s'] * 1e3:.1f} ms"
              f" | fine grid {st['fine_s'] * 1e3:.1f} ms | active blocks "
              f"{st['active_fraction']:.4f} ({st['heal_rounds']} healing rounds) | host marching "
              f"{st['march_s'] * 1e3:.1f} ms | vertex colours {st['colors_s'] * 1e3:.1f} ms | "
              f"total {st['total_s']:.3f} s | {st['n_verts']} verts {st['n_tris']} tris | "
              f"|v| {radius.min():.3f}..{radius.max():.3f} | launches {counts}", flush=True)
        res["launches_eval"] = counts

        # (c) res 128: sparse == dense bitwise; kernel grid vs plain grid
        params, rcfg = ev.state.params["renderer"], ev.tcfg.renderer
        vs, ts = mesh.extract_geometry(params, rcfg, ev.bbox_min, ev.bbox_max, 128, sparse=True)
        vd, td = mesh.extract_geometry(params, rcfg, ev.bbox_min, ev.bbox_max, 128, sparse=False)
        check(len(vs) > 0 and len(vs) == len(vd) and len(ts) == len(td),
              f"res 128: sparse {len(vs)} / dense {len(vd)} vertices")
        check(np.array_equal(sorted_rows(vs), sorted_rows(vd)),
              "res 128: sparse and dense vertex sets differ")
        fn = sdf_mlp.make_fused_sdf_fn(params["sdf"], rcfg.sdf, rcfg.extract_precision)
        u_k = mesh.evaluate_sdf_grid(params, rcfg, ev.bbox_min, ev.bbox_max, 128)
        u_p = mesh.evaluate_sdf_grid(params, rcfg, ev.bbox_min, ev.bbox_max, 128,
                                     sdf_chunk_fn=lambda p: -sdf_mlp.sdf_points_plain(
                                         fn.weights, p))
        grid_err = float(np.abs(u_k - u_p).max())
        print(f"[6c] res 128: sparse and dense meshes {len(vs)} verts {len(ts)} tris, sorted "
              f"vertex sets bitwise equal | kernel grid vs plain grid max|diff| {grid_err:.3e} "
              f"(atol {ATOL_GRID[rcfg.extract_precision]:g})", flush=True)
        check(grid_err <= ATOL_GRID[rcfg.extract_precision],
              f"res 128 grid: max error {grid_err:.3e}")
        res["grid_err"] = grid_err
        res["grid_chunk"] = trained_grid_chunk(params["sdf"], rcfg.sdf, ev.bbox_min, ev.bbox_max,
                                               device, "6c")
        for prec, r in res["grid_chunk"].items():
            check(r["err"] <= ATOL_GRID[prec], f"trained grid chunk {prec}: max error "
                                               f"{r['err']:.3e} above {ATOL_GRID[prec]:g}")

        # (d) vertex colours of (b)'s mesh: kernel vs plain twin vs fields path
        pts = torch.as_tensor(verts[:1 << 15] - ev.scale_mats[0][:3, 3][None], device=device) \
            / float(ev.scale_mats[0][0, 0])
        dirs = torch.zeros_like(pts)
        with torch.no_grad():
            pw = PP.resolve_pipeline_weights(params, rcfg)
            got = PP.fused_point_pipeline_fwd(params, rcfg, pts, dirs, weights=pw)
            want = PP.point_pipeline_plain(pw, pts, dirs, bf16=True)
            ms = cuda_ms(lambda: PP.launch_point_pipeline(pw, pts, dirs))
            plain_ms = cuda_ms(lambda: PP.point_pipeline_plain(pw, pts, dirs, bf16=True), reps=5)
        off = mesh.extract_vertex_colors(
            params, dataclasses.replace(rcfg, fused_core="off"), pts.cpu().numpy())
        fields_err = float(np.abs(got[2].cpu().numpy() - off).max())
        print(f"[6d] vertex colours of {pts.shape[0]} vertices: max|gc kernel-f32 fields path| "
              f"(the precision's cost) {fields_err:.3e} | kernel {ms:.4f} ms | bf16 twin "
              f"{plain_ms:.4f} ms", flush=True)
        # the vertices lie on the zero level set: |sdf| is at rounding level
        # there, and its relative error means nothing
        check_pipeline(got, want, "6d", "vertex colours", PIPELINE_OUTPUTS[1:])
        res["colour_err"] = max(float((a - b).abs().max()) for a, b in zip(got, want))

        # (e) the validation render: the kernel path, the same path through
        # the bf16 twin, and the plain f32 path (fused_core off), same seed
        cam_id = 1
        images = {}
        for mode, twin in (("auto", False), ("auto", True), ("off", False)):
            tcfg = dataclasses.replace(ev.tcfg, renderer=dataclasses.replace(
                rcfg, fused_core=mode))
            g = torch.Generator(device=device).manual_seed(SEED + 7)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with bf16_twin_in_place(twin):
                rgb, depth = TR.render_image(ev.state.params, ev.scene, tcfg, cam_id, ev.H, ev.W,
                                             g)
            images["twin" if twin else mode] = (rgb, depth, (time.perf_counter() - t0) * 1e3,
                                                launch_counts())
        gt = ev.images[cam_id].cpu().numpy()
        img_err = float(np.abs(images["auto"][0] - images["twin"][0]).max())
        depth_err = float(np.abs(images["auto"][1] - images["twin"][1]).max())
        cost = float(np.abs(images["auto"][0] - images["off"][0]).max())
        n_chunks = -(-ev.H * ev.W // ev.tcfg.eval_ray_size)
        psnr = {m: mse2psnr(np.mean((images[m][0] - gt) ** 2)) for m in images}
        print(f"[6e] validation view {cam_id} ({ev.H}x{ev.W}, {n_chunks} chunks): kernel "
              f"{images['auto'][2]:.1f} ms/image, PSNR {psnr['auto']:.3f} | bf16 twin "
              f"{images['twin'][2]:.1f} ms/image, PSNR {psnr['twin']:.3f} | plain f32 "
              f"{images['off'][2]:.1f} ms/image, PSNR {psnr['off']:.3f} | max|kernel-bf16 twin| "
              f"image {img_err:.3e} (atol {ATOL_IMAGE:g}) depth {depth_err:.3e} | "
              f"max|kernel-plain f32| image {cost:.3e} (the precision's cost) | launches "
              f"kernel path {images['auto'][3]} plain path {images['off'][3]}", flush=True)
        check(images["auto"][3]["point_pipeline"] == n_chunks
              and images["off"][3]["point_pipeline"] == 0,
              "the validation render's kernel launches")
        check(img_err <= ATOL_IMAGE, f"validation image: max error {img_err:.3e}")
        res["launches_eval"]["point_pipeline"] += images["auto"][3]["point_pipeline"]
        ev.validate_image(ev.state.step)
        check(os.path.exists(os.path.join(ev.recorder.viz_image_dir,
                                          f"img_{ev.state.step}.png")), "no validation PNG")

    # (f) the training path does not take the point-pipeline kernel
    print(f"[6f] phase 3's training launched: {launches_training}", flush=True)
    check(all(launches_training[k] == 0 for k in ("point_pipeline", "sdf_points",
                                                  "point_pipeline_bwd", "ray_march",
                                                  "ray_march_bwd", "ray_march_save",
                                                  "ray_march_bwd_load", "mlp_chain",
                                                  "mlp_chain_f32", "mlp_chain_deferred")),
          "the auto training run launched a point-pipeline, grid-SDF, march or chain kernel")
    return res


def state_difference(a, b) -> tuple:
    """(number of differing tensors, largest |a - b|, its name) over two
    loops' parameters, Adam states, step counters and generator states."""
    return tensors_distance(state_tensors(a), state_tensors(b))


def dataset_cfg(name, root, obj_id):
    """config/<name> as shipped, its DATASET pointed at the replica, the
    fused march on (PyYAML reads it)."""
    from color_neus_torch.utils.config import config_from_dict, get_config
    d = get_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config",
                                name)).to_dict()
    d["DATASET"].update(DATA_ROOT=root, OBJ_ID=obj_id)
    d["MODEL"]["RENDERER"]["FUSED_MARCH"] = "on"
    return config_from_dict(d)


def timed_run(loop, *args, **kw):
    """(losses as floats, launch counts, host seconds) of loop.run(...)."""
    import torch
    torch.cuda.synchronize()
    reset_launch_counts(loop)
    t0 = time.perf_counter()
    losses = loop.run(*args, **kw)
    torch.cuda.synchronize()
    return [float(x) for x in losses], launch_counts(loop), time.perf_counter() - t0


def dataset_path(device, march_step_ms):
    """Phase 10: the DTU-format replica at DTU's size through the readers,
    the train / stop / resume / SIGTERM path of config/Color_NeuS_dtu.yml
    with the fused march, the extraction in the world frame, and the
    IHO-format replica whose focal and poses learn through row 4."""
    import numpy as np
    import torch
    from color_neus_torch.data import image_io
    from color_neus_torch.data.base import create_dataset
    from color_neus_torch.data.image_io import read_png, write_png
    from color_neus_torch.models import trainer as TR
    from color_neus_torch.ops import kernels
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.tools import dataset_replica as DR
    from color_neus_torch.utils.config import get_config
    from color_neus_torch.utils.recorder import Recorder

    def want(steps, **kw):   # MARCH_ACTS auto: the save mode at the config's shape
        return {**{k: 0 for k in kernels.launchers()}, "sdf_rays": SWEEPS_PER_STEP * steps,
                "ray_march_save": steps, "ray_march_bwd_load": steps, **kw}

    res = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        root = os.path.join(tmp, "data")
        # (a) the replica at DTU's size, read back exactly
        rep = DR.write_replica(root, "DTU", DTU_VIEWS, DTU_H, DTU_W, "901", device)
        ds = create_dataset({"TYPE": "DTU", "DATA_ROOT": root, "OBJ_ID": "901"},
                            {"INCLUDE_MASK": True})
        t0 = time.perf_counter()
        data = ds.load_all()
        load_s = time.perf_counter() - t0
        init = ds.init_data()
        pose_err = float(np.abs(init["poses"] - rep["poses"]).max())
        focal_err = float(np.abs(init["focal"] / rep["focal"] - 1).max())
        rgb = rep["rgb"].astype(np.float32) / 255.0
        mask = rep["mask"].astype(np.float32) / 255.0
        exact = (np.array_equal(data["images"], rgb * mask[..., None])
                 and np.array_equal(data["masks"], mask))
        reader = "cv2" if image_io._cv2() is not None else "the port's PNG decoder (no cv2)"
        print(f"[10a] DTU replica: {DTU_VIEWS} views at {DTU_W} x {DTU_H} (the blob, rendered "
              f"on the card): render {rep['render_s']:.2f} s, PNG write {rep['write_s']:.2f} s, "
              f"load_all {load_s:.2f} s through {reader} ({data['images'].nbytes / 2 ** 30:.2f} "
              f"GiB of images, {data['masks'].nbytes / 2 ** 30:.2f} GiB of masks) | poses "
              f"max|read-written| {pose_err:.2e} (atol {REPLICA_POSE_ATOL:g}), focal relative "
              f"{focal_err:.2e} (rtol {REPLICA_FOCAL_RTOL:g}) | images and masks bitwise "
              f"equal: {exact}", flush=True)
        check(pose_err <= REPLICA_POSE_ATOL and focal_err <= REPLICA_FOCAL_RTOL,
              f"replica cameras read back {pose_err:.2e} / {focal_err:.2e} off")
        check(exact, "the replica's images or masks did not read back bitwise")
        # the same files through the port's own decoder, as a host without cv2 reads them
        cv2 = image_io._cv2
        image_io._cv2 = lambda: None
        try:
            t0 = time.perf_counter()
            own = ds.load_all()
            own_s = time.perf_counter() - t0
        finally:
            image_io._cv2 = cv2
        same = all(np.array_equal(own[k], data[k]) for k in ("images", "masks"))
        print(f"[10a] load_all through the port's PNG decoder: {own_s:.2f} s | equal to the "
              f"above bitwise: {same}", flush=True)
        check(same, "the port's PNG decoder read the replica differently")
        del data, own
        # one decode of a file whose rows all take filter 3 or 4 (libpng's
        # writers pick them for photos; the replica's writer uses 0)
        for f in (3, 4):
            path = os.path.join(tmp, f"filter{f}.png")
            write_png(path, rep["rgb"][0], f)
            t0 = time.perf_counter()
            ok = np.array_equal(read_png(path), rep["rgb"][0])
            print(f"[10a] one {DTU_W} x {DTU_H} RGB PNG, every row filter {f}: decoded in "
                  f"{time.perf_counter() - t0:.2f} s (numpy + zlib, no cv2), exact: {ok}",
                  flush=True)
            check(ok, f"filter {f} PNG decoded wrong")

        # (b) train 60 steps straight; 30, stop, resume to 60: bitwise equal
        cfg = dataset_cfg("Color_NeuS_dtu.yml", root, "901")
        # the straight loop records nothing: its steady state is timed as
        # phase 8's is, with no checkpoint in the window
        straight = TrainLoop(cfg)
        check(straight.device.type == "cuda" and straight.tcfg.renderer.fused_march == "on",
              "the DTU loop is not on the card with the fused march")
        torch.cuda.reset_peak_memory_stats()
        losses, counts, wall = timed_run(straight, STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        print(f"[10b] Color_NeuS_dtu.yml, fused_march on, {STEPS} steps: {wall * 1e3 / STEPS:.2f} "
              f"ms/step incl. first step | loss {first:.5f} -> {last:.5f} (last-5 / first-5 "
              f"{last / first:.4f}) | launches {counts} | peak memory {peak_gb:.2f} GiB",
              flush=True)
        check(counts == want(STEPS), f"the DTU run launched {counts}, want {want(STEPS)}")
        check(all(np.isfinite(losses)), f"non-finite loss {losses}")
        check(last < first, f"loss did not drop: first-5 mean {first}, last-5 mean {last}")
        stopped = TrainLoop(cfg, exp_id="stopped", require_clean_git=False)
        part1, c1, _ = timed_run(stopped, STEPS, stop_after=STOP_AT)
        exp = stopped.recorder.exp_path
        check(stopped.state.step == STOP_AT and len(part1) == STOP_AT,
              f"stop_after={STOP_AT} stopped at {stopped.state.step}")
        del stopped
        resumed = TrainLoop(get_config(Recorder.find_resume_cfg(exp)), resume=exp)
        check(resumed.state.step == STOP_AT, f"resumed at step {resumed.state.step}")
        part2, c2, _ = timed_run(resumed, STEPS)
        n_diff, worst, name = state_difference(straight, resumed)
        same_losses = part1 + part2 == losses
        print(f"[10b] stopped at {STOP_AT} (launches {c1}), resumed from {exp}/dump_cfg.yaml to "
              f"{STEPS} (launches {c2}): {n_diff} of the parameters, Adam states and the "
              f"generator differ from the straight run's (largest |diff| {worst:.3e}, {name}; "
              f"limit: bitwise) | losses of every step equal: {same_losses}", flush=True)
        check(c1 == want(STOP_AT) and c2 == want(STEPS - STOP_AT),
              f"stop / resume launches {c1} / {c2}")
        check(n_diff == 0 and same_losses,
              f"resumed run differs from the straight one: {n_diff} tensors, {worst:.3e} ({name})")
        _, _, wall = timed_run(straight, STEPS + STEADY_STEPS)
        step_ms = wall * 1e3 / STEADY_STEPS
        print(f"[10b] steady state: {step_ms:.2f} ms/step on the DTU replica "
              f"({DTU_W} x {DTU_H}) | phase 8, the same model on the synthetic 64 x 64 "
              f"sphere: {march_step_ms:.2f} ms/step", flush=True)
        res.update(step_ms=step_ms, peak_gb=peak_gb, load_s=load_s, own_s=own_s,
                   write_s=rep["write_s"], k_steps=straight.k_steps,
                   replays=straight.multi_step.replays if straight.multi_step else 0)
        del straight

        # (c) SIGTERM during run: a checkpoint at a step boundary, then on
        sig = TrainLoop(cfg, exp_id="sigterm", require_clean_git=False)
        timer = threading.Timer(SIGTERM_AFTER_S, os.kill, (os.getpid(), signal.SIGTERM))
        timer.start()
        try:
            sig_losses, c3, wall = timed_run(sig)
        finally:
            timer.cancel()
        step = sig.state.step
        with np.load(sig.recorder.ckpt_path()) as ck:
            ck_step = int(ck["step"])
        again = TrainLoop(get_config(Recorder.find_resume_cfg(sig.recorder.exp_path)),
                          resume=sig.recorder.exp_path)
        print(f"[10c] SIGTERM after {SIGTERM_AFTER_S:g} s: run returned after {wall:.2f} s at "
              f"step {step} (checkpoint at step {ck_step}; launches {c3}); a loop resumed "
              f"from the directory starts at step {again.state.step}", flush=True)
        check(0 < step < cfg["TRAIN"]["ITERATIONS"] and len(sig_losses) == step
              and ck_step == step and again.state.step == step and c3 == want(step),
              "SIGTERM did not stop the run with a checkpoint at a step boundary")
        check(state_difference(sig, again)[0] == 0, "the SIGTERM checkpoint differs")
        del sig, again

        # (d) the extraction from the resumed loop, in the world frame
        reset_launch_counts()
        t0 = time.perf_counter()
        out = resumed.testing_step(resumed.state.step, recon_res=EVAL_RES)
        ext_s = time.perf_counter() - t0
        counts = launch_counts()
        check(out is not None and len(out[0]) > 0, "empty mesh from the DTU loop")
        verts = out[0]
        S = resumed.scale_mats[0]
        lo = S[:3, :3] @ resumed.bbox_min + S[:3, 3]
        hi = S[:3, :3] @ resumed.bbox_max + S[:3, 3]
        inside = bool(((verts >= lo) & (verts <= hi)).all())
        print(f"[10d] res-{EVAL_RES} sparse extraction at step {resumed.state.step}: "
              f"{len(verts)} vertices, {len(out[1])} triangles, {ext_s:.2f} s | world "
              f"frame: vertices in [{verts.min(0).round(2)}, {verts.max(0).round(2)}], the "
              f"replica's world bbox [{lo.round(2)}, {hi.round(2)}]: inside {inside} | "
              f"launches sdf_points {counts['sdf_points']}, point_pipeline "
              f"{counts['point_pipeline']}", flush=True)
        check(inside, "mesh vertices outside the replica's world bbox")
        check(counts["sdf_points"] > 0 and counts["point_pipeline"] > 0,
              f"the extraction's launches {counts}")
        res["extract_s"] = ext_s
        del resumed

        # (e) cameras that learn: the IHO-format replica, row 4's ray grads
        rep = DR.write_replica(root, "IHO_VIDEO", IHO_VIEWS, IHO_H, IHO_W, "blob", device)
        loop = TrainLoop(dataset_cfg("Color_NeuS_iho.yml", root, "blob"))
        cam = loop.tcfg.camera
        check(cam.learn_focal and cam.learn_r and cam.learn_t,
              "Color_NeuS_iho.yml does not learn focal and poses")
        losses, counts, wall = timed_run(loop, IHO_STEPS)
        print(f"[10e] IHO replica ({IHO_VIEWS} frames at {IHO_W} x {IHO_H}, COLMAP model of "
              f"{len(rep['points'])} points), Color_NeuS_iho.yml, fused_march on, {IHO_STEPS} "
              f"steps: {wall * 1e3 / IHO_STEPS:.2f} ms/step | loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f} | launches {counts}", flush=True)
        check(counts == want(IHO_STEPS), f"the IHO run launched {counts}")
        check(all(np.isfinite(losses)), f"non-finite IHO loss {losses}")
        g = torch.Generator(device=device).manual_seed(SEED + 150)
        img_ids = torch.arange(min(loop.batch_size, loop.n_imgs), device=device)
        images, masks = loop.images[img_ids], loop.masks[img_ids]
        with torch.no_grad():
            cam_sel, py, px, sel_mask = TR.sample_pixels(loop.tcfg, images, masks,
                                                         loop.state.step, g)
        pixels = (img_ids, images, cam_sel, py, px, sel_mask)
        on, off = (step_grads(loop, pixels, fused_march=m) for m in ("on", "off"))
        errs, errs_max, cos = grad_errors(on, off)
        cams = ("focal.fx", "focal.fy", "pose.r", "pose.t")
        check(all(k in errs for k in cams), f"camera leaves without a gradient: {sorted(errs)}")
        worst, worst_cos = max(errs, key=errs.get), min(cos, key=cos.get)
        median = sorted(errs.values())[len(errs) // 2]
        print(f"[10e] one step's leaf gradients, fused_march on (row 4) vs off (f32 plain "
              f"core), perturb 0: {len(errs)} leaves, worst |on-off| / |off| {errs[worst]:.3e} "
              f"({worst}), median {median:.3e}, min cosine {cos[worst_cos]:.6f} ({worst_cos}) "
              f"(limits {RTOL_STEP_GRAD:g} / {MIN_COS_STEP_GRAD:g}, median "
              f"{RTOL_STEP_GRAD_MEDIAN:g}) | camera leaves: "
              + ", ".join(f"{k} {errs[k]:.3e} cos {cos[k]:.6f}" for k in cams), flush=True)
        rows = [int(i) for i in img_ids.tolist()]
        for k in ("pose.r", "pose.t"):
            a, b = on[k][rows].double(), off[k][rows].double()
            c = torch.sum(a * b, 1) / (torch.linalg.norm(a, dim=1) * torch.linalg.norm(b, dim=1))
            print(f"[10e] {k} per camera of the batch, cosine on vs off: "
                  + " ".join(f"{x:.4f}" for x in c.tolist()), flush=True)
        check(errs[worst] <= RTOL_STEP_GRAD, f"IHO step gradient {worst}: {errs[worst]:.3e}")
        check(median <= RTOL_STEP_GRAD_MEDIAN, f"IHO step gradients: median {median:.3e}")
        check(cos[worst_cos] >= MIN_COS_STEP_GRAD,
              f"IHO step gradient {worst_cos}: cosine {cos[worst_cos]:.6f}")
        res["iho_cam_err"] = max(errs[k] for k in cams)
    return res


def arm_cfg(arm, bench=False):
    """SMOKE_CFG with the arm's renderer switches, at bench.py's shape when
    `bench`."""
    from color_neus_torch.utils.config import config_from_dict
    model = SMOKE_CFG["MODEL"]
    renderer = {**model["RENDERER"], **ARMS[arm]}
    extra = {}
    if bench:
        renderer.update(BENCH_MODEL["RENDERER"])
        extra = {k: v for k, v in BENCH_MODEL.items() if k != "RENDERER"}
    return config_from_dict({**SMOKE_CFG, "MODEL": {**model, **extra, "RENDERER": renderer}})


def sgd_cfg():
    """SMOKE_CFG through the fused march with OPTIMIZE.TYPE sgd."""
    from color_neus_torch.utils.config import config_from_dict
    model, train = SMOKE_CFG["MODEL"], SMOKE_CFG["TRAIN"]
    return config_from_dict({**SMOKE_CFG, "MODEL": {**model, "RENDERER": {
        **model["RENDERER"], "FUSED_MARCH": "on"}}, "TRAIN": {**train, "OPTIMIZE": SGD_OPTIMIZE}})


def state_tensors(loop) -> dict:
    """Copies of every parameter, optimizer state, the step counter and the
    generator state of a loop."""
    out = {}
    opt = loop.state.optimizer
    for name, p in loop.state.params.named_parameters():
        out[name] = p.detach().clone()
        for k, v in opt.state.get(p, {}).items():
            out[f"{name}/{k}"] = v.clone()
    out["step_t"] = loop.state.step_t.clone()
    out["generator"] = loop.generator.get_state().clone()
    return out


def restore(loop, saved: dict, step: int) -> None:
    """Put state_tensors' copies back in place: a captured bundle reads the
    same storage."""
    import torch
    opt = loop.state.optimizer
    with torch.no_grad():
        for name, p in loop.state.params.named_parameters():
            p.copy_(saved[name])
            for k, v in opt.state.get(p, {}).items():
                v.copy_(saved[f"{name}/{k}"])
    loop.state.set_step(step)
    loop.generator.set_state(saved["generator"])


def tensors_distance(a: dict, b: dict) -> tuple:
    """(tensors that differ, the largest |a - b|, its name)."""
    import torch
    diff = [(float((a[k].double() - b[k].double()).abs().max()), k)
            for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
    worst = max(diff) if diff else (0.0, "-")
    return len(diff), worst[0], worst[1]


def host_ms(fn, steps) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def collect() -> None:
    """Free what the loops deleted so far held (their captured graphs'
    memory pools too: a loop is freed only when the garbage collector
    finds its reference cycles) and return the cached blocks to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def interleaved_ms(loop, bundles):
    """Host clock ms/step of `bundles` bundles uncaptured / captured /
    captured / uncaptured, and the uncaptured runs' peak memory (GiB)."""
    import torch

    def eager():
        for _ in range(bundles * BUNDLE):
            loop.training_step()

    def replay():
        for _ in range(bundles):
            loop.training_bundle()
    out, peak = [], 0.0
    for fn in (eager, replay, replay, eager):
        torch.cuda.reset_peak_memory_stats()
        out.append(host_ms(fn, bundles * BUNDLE))
        if fn is eager:
            peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
    return out, peak


def busy_of_replays(loop, n, arm, tag):
    """Profile n replays: (host ms/step profiled, busy ms/step, idle share
    of the span, {kernel: launches per step}); checks the arm's kernels
    ran inside the graph, by name, at their launches per step.

    The profiler can lose device records: traces of one captured graph's
    replays differ in how many they hold. A trace whose counts fall short
    of the arm's is traced again, up to TRACE_ATTEMPTS traces, and one of
    them must hold the counts exactly; a short trace must also hold fewer
    device records than that one (a record lost, not a kernel replaced),
    and a count above the arm's fails at once."""
    steps = n * BUNDLE
    names = ("sdf_rays_",) + tuple(k for ks in ARM_KERNELS.values() for k in ks)
    want = {k: (SWEEPS_PER_STEP if k == "sdf_rays_" else
                1 if k in ARM_KERNELS[arm] else 0) for k in names}
    short = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        wall_ms, dev = profiled(lambda: [loop.training_bundle() for _ in range(n)])
        check(dev, f"[{tag}] the profiler trace of {n} replays holds no device events")
        per_step = {k: sum(bool(re.search(rf"\b{k}", name)) if k.endswith("_")
                           else bool(re.search(rf"\b{k}\b", name)) for _, _, name in dev) / steps
                    for k in names}
        if per_step == want:
            break
        check(all(per_step[k] <= want[k] for k in names),
              f"[{tag}] {arm}: kernels per step in the replays' trace {per_step}, want {want}")
        short.append(len(dev))
        print(f"[{tag}] {arm}: trace {attempt} of {TRACE_ATTEMPTS} holds {len(dev)} device "
              f"records and is short of the arm's kernels: {per_step}, want {want}"
              + ("; traced again" if attempt < TRACE_ATTEMPTS else ""), flush=True)
    check(per_step == want, f"[{tag}] {arm}: kernels per step in the replays' trace "
                            f"{per_step}, want {want}, in {TRACE_ATTEMPTS} traces")
    if short:
        print(f"[{tag}] {arm}: trace {len(short) + 1} holds the arm's kernels and {len(dev)} "
              f"device records; the short traces held {short}", flush=True)
        check(max(short) < len(dev), f"[{tag}] {arm}: a short trace held as many device "
                                     f"records ({short}) as the full one ({len(dev)})")
    busy = union_us([(a, b) for a, b, _ in dev]) / 1e3
    span = (max(b for _, b, _ in dev) - min(a for a, _, _ in dev)) / 1e3
    return wall_ms / steps, busy / steps, 1 - busy / span, per_step


def stash_gib(loop) -> float:
    """GiB of the save mode's stashes a step of the loop keeps (0 unless
    its march saves: FUSED_MARCH on and MARCH_ACTS resolving to save)."""
    from color_neus_torch.ops.kernels import ray_march as RM
    r = loop.tcfg.renderer
    n = loop.tcfg.n_rays * (r.n_samples + r.n_importance)
    if r.fused_march != "on" or not RM.resolve_save_acts(r.march_acts, r, n,
                                                         r.march_stash_budget_gb):
        return 0.0
    return RM.march_stash_bytes(r, n) / 2 ** 30


def replay_vs_steps(loop, arm, tag):
    """Phase 11(a): a replay of the loop's captured bundle against BUNDLE
    uncaptured steps from the same state (the loop at a bundle boundary,
    its bundle captured): bitwise for the fused march (a fixed summation
    order), else within BUNDLE_DISTANCE_FACTOR x the distance of two
    uncaptured runs when those differ (atomics). Leaves the loop one bundle
    on."""
    import torch
    step, s0 = loop.state.step, state_tensors(loop)
    runs = []
    for _ in range(1 if arm.startswith("fused_march") else 2):
        losses = torch.stack([loop.training_step()["loss"] for _ in range(BUNDLE)])
        runs.append(dict(state_tensors(loop), losses=losses))
        restore(loop, s0, step)
    _, losses = loop.training_bundle()
    captured = dict(state_tensors(loop), losses=losses)
    n_diff, worst, name = tensors_distance(runs[0], captured)
    if len(runs) > 1:
        e_diff, e_worst, e_name = tensors_distance(runs[0], runs[1])
        limit = 0.0 if e_diff == 0 else BUNDLE_DISTANCE_FACTOR * e_worst
        reason = ("bitwise: two uncaptured runs agree bitwise" if e_diff == 0 else
                  f"{BUNDLE_DISTANCE_FACTOR:g} x the distance of two uncaptured runs "
                  f"({e_diff} tensors differ, largest {e_worst:.3e} at {e_name}: a "
                  f"gradient summed through atomics)")
    else:
        limit, reason = 0.0, "bitwise (the fused march sums in a fixed order)"
    print(f"[{tag}] {arm}: a replay of the captured bundle against {BUNDLE} uncaptured "
          f"steps from the same state: {n_diff} of {len(captured)} tensors (parameters, "
          f"optimizer states, step, generator, losses) differ, largest |diff| "
          f"{worst:.3e} ({name}) | limit {limit:.3e}: {reason} | losses "
          f"{float(losses[0]):.6f} .. {float(losses[-1]):.6f}", flush=True)
    check(worst <= limit and (limit > 0 or n_diff == 0),
          f"{arm}: the captured bundle differs from the uncaptured steps: {n_diff} "
          f"tensors, {worst:.3e} ({name}), limit {limit:.3e}")


def bundle_phase(device, dtu):
    """Phase 11: the captured bundle of BUNDLE steps against the steps one
    by one, per training arm; `dtu` holds phase 10's DTU loop's bundling."""
    import torch
    from color_neus_torch.runtime import TrainLoop, bundle_steps
    from color_neus_torch.utils.config import get_config

    # (d) the rule on every shipped config, and the shipped DTU loop on the card
    here = os.path.dirname(os.path.abspath(__file__))
    rule = {os.path.basename(p): bundle_steps(get_config(p)["TRAIN"])
            for p in sorted(glob.glob(os.path.join(here, "config", "*.yml")))}
    print(f"[11d] steps per dispatch by config: {rule} | the shipped Color_NeuS_dtu.yml's "
          f"loop in phase 10: k_steps {dtu['k_steps']}, {dtu['replays']} replays of its "
          f"captured bundle in the straight run", flush=True)
    check(len(rule) >= 10 and set(rule.values()) == {BUNDLE},
          f"a shipped config does not bundle {BUNDLE} steps: {rule}")
    check(dtu["k_steps"] == BUNDLE and dtu["replays"] > 0,
          f"the DTU loop did not replay bundles of {BUNDLE}: {dtu}")

    res = {}
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    for arm in (a for a in ARMS if a not in BENCH_ONLY_ARMS):
        t_arm = time.perf_counter()
        loop = TrainLoop(arm_cfg(arm), device=device)
        check(loop.k_steps == BUNDLE and loop.multi_step is not None,
              f"{arm}: the loop does not bundle")
        # one uncaptured step that must not wait on the card anywhere
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.training_step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        loop.run(BUNDLE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop.run(3 * BUNDLE)                   # warm-up bundle + capture, one replay
        capture_s = time.perf_counter() - t0
        peak_cap = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = loop.multi_step
        check(ms.graph is not None and ms.replays == 1, f"{arm}: no captured bundle replayed")

        # (a) a replay against BUNDLE uncaptured steps from the same state
        replay_vs_steps(loop, arm, "11a")

        # (b) two replays under the profiler: the kernels inside the graph
        prof_ms, busy, idle, per_step = busy_of_replays(loop, 2, arm, "11b")
        print(f"[11b] {arm}: two replays profiled: {prof_ms:.2f} ms/step host clock "
              f"(profiler on) | busy {busy:.2f} ms/step | idle share {idle:.4f} of the span "
              f"| kernels per step by name: {per_step}", flush=True)

        # (c) host clock, uncaptured / captured / captured / uncaptured
        (u1, c1, c2, u2), peak_u = interleaved_ms(loop, 2)
        n_rays = loop.tcfg.n_rays
        print(f"[11c] {arm}, {n_rays} x 128: ms/step uncaptured {u1:.2f} / captured {c1:.2f} "
              f"/ captured {c2:.2f} / uncaptured {u2:.2f} | speed-up "
              f"{(u1 + u2) / (c1 + c2):.3f}x, {2e3 * n_rays / (c1 + c2):.0f} rays/s captured | "
              f"idle share unprofiled (1 - busy / host ms): captured "
              f"{1 - 2 * busy / (c1 + c2):.4f}, uncaptured {1 - 2 * busy / (u1 + u2):.4f} | "
              f"peak memory uncaptured {peak_u:.2f} GiB, warm-up + capture + replay "
              f"{peak_cap:.2f} GiB, reserved with the graph's pool "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB | save-mode stash "
              f"{stash_gib(loop):.2f} GiB | capture call "
              f"{capture_s:.2f} s, arm {time.perf_counter() - t_arm:.1f} s", flush=True)
        res[arm] = {"u": (u1, u2), "c": (c1, c2), "busy": busy, "idle": idle,
                    "peak_u": peak_u, "peak_cap": peak_cap}
        del loop
        torch.cuda.empty_cache()

    # (c) at bench.py's shape: every arm whose uncaptured steps fit beside
    # a captured bundle's pool of their own size; the bench-only arms each
    # in a process of their own (bench_arm_child)
    for arm in ARMS:
        res[f"{arm}_bench"] = (bench_arm_in_child(arm) if arm in BENCH_ONLY_ARMS
                               else bench_arm(device, arm, card_gib))
    return res


def bench_arm(device, arm, card_gib):
    """Phase 11(c) of one arm at bench.py's shape: host ms/step uncaptured /
    captured / captured / uncaptured, busy, idle share, peak memory above
    what the process held before the arm (`base`); auto uncaptured only when
    a captured pool beside its steps would not fit the card."""
    import torch
    from color_neus_torch.runtime import TrainLoop
    t_arm = time.perf_counter()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(arm_cfg(arm, bench=True), device=device)
    rcfg = loop.tcfg.renderer
    check(loop.tcfg.n_rays == 2048 and rcfg.n_samples + rcfg.n_importance == 512,
          f"bench shape not reached: {loop.tcfg.n_rays} x {rcfg.n_samples}"
          f"+{rcfg.n_importance}")
    try:
        if arm == "auto":
            u = host_ms(lambda: [loop.training_step() for _ in range(BUNDLE)], BUNDLE)
            peak_u = torch.cuda.max_memory_allocated() / 2 ** 30
            if 2 * peak_u > 0.9 * card_gib:
                print(f"[11c] auto, 2048 x 512: uncaptured {u:.2f} ms/step, peak memory "
                      f"{peak_u:.2f} GiB ({base:.2f} allocated before the arm); captured not "
                      f"run: a bundle's pool of that size beside the uncaptured steps' needs "
                      f"~{2 * peak_u:.0f} GiB of the card's {card_gib:.0f}", flush=True)
                return {"u": (u, u), "peak_u": peak_u, "base": base}
        loop.run(loop.state.step + 2 * BUNDLE)  # warm-up bundle + capture, one replay
        peak_cap = torch.cuda.max_memory_allocated() / 2 ** 30
        _, busy, idle, _ = busy_of_replays(loop, 1, arm, "11c")
        (u1, c1, c2, u2), peak_u = interleaved_ms(loop, 1)
        print(f"[11c] {arm}, 2048 x 512 (bench.py's shape): ms/step uncaptured {u1:.2f} / "
              f"captured {c1:.2f} / captured {c2:.2f} / uncaptured {u2:.2f} | speed-up "
              f"{(u1 + u2) / (c1 + c2):.3f}x, {2 * 2048e3 / (c1 + c2):.0f} rays/s captured | "
              f"busy {busy:.2f} ms/step, idle share profiled {idle:.4f}, unprofiled captured "
              f"{1 - 2 * busy / (c1 + c2):.4f}, uncaptured {1 - 2 * busy / (u1 + u2):.4f} | "
              f"peak memory uncaptured {peak_u:.2f} GiB, warm-up + capture + replay "
              f"{peak_cap:.2f} GiB ({base:.2f} allocated before the arm) | save-mode stash "
              f"{stash_gib(loop):.2f} GiB | arm {time.perf_counter() - t_arm:.1f} s", flush=True)
        return {"u": (u1, u2), "c": (c1, c2), "busy": busy, "peak_u": peak_u,
                "peak_cap": peak_cap, "base": base}
    finally:
        del loop
        torch.cuda.empty_cache()


def bench_arm_child(arm):
    """bench_arm in a process of its own (run by bench_arm_in_child): prints
    its record as one JSON line after CHILD_TAG."""
    import torch
    from color_neus_torch import pin_precision
    pin_precision()
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    rec = bench_arm(torch.device("cuda"), arm, card_gib)
    print(CHILD_TAG + json.dumps(rec), flush=True)


def bench_arm_in_child(arm):
    """Phase 11(c) of a bench-only arm in a child process on the same card,
    the kernels already built. The chunked core's captured bundle needs a
    graph pool of ~6 GiB at 2048 x 512 in a process of its own, but ~35 GiB
    after the other arms in this one (on the H100; the cause is not found,
    PERF.md §7), which ran the card out of memory: a user's run at that
    shape is a process of its own. Returns the child's record."""
    collect()    # this process's unreferenced loops and their graph pools
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", "import chip_smoke; "
                          f"chip_smoke.bench_arm_child({arm!r})"], cwd=here,
                         capture_output=True, text=True, timeout=600)
    lines = out.stdout.splitlines()
    for line in lines:
        if line.startswith("[11c]"):
            print(line + " (a process of its own)", flush=True)
    recs = [json.loads(l[len(CHILD_TAG):]) for l in lines if l.startswith(CHILD_TAG)]
    check(out.returncode == 0 and len(recs) == 1,
          f"[11c] {arm} in a child process failed (rc {out.returncode}):\n"
          f"{out.stdout[-3000:]}{out.stderr[-3000:]}")
    return recs[0]


def _digest(params) -> str:
    """sha256 of every parameter's name and bytes (replicas compared)."""
    import hashlib
    h = hashlib.sha256()
    for name, p in params.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_step(loop, cfg, pixels):
    """One train step of a copy of the loop's parameters at step DP_STEP
    with config `cfg` on the given pixels: (loss, {leaf: clipped gradient,
    zeros where none}, the parameters after the step, launches)."""
    import torch
    from color_neus_torch.models import trainer as TR
    from color_neus_torch.weights import state_from_numpy, state_to_numpy
    img_ids, images, cam_sel, py, px, sel_mask = pixels
    params = state_from_numpy(state_to_numpy(loop.state.params), loop.device)
    state = TR.TrainState(params, TR.make_optimizer(cfg, params), step=DP_STEP)
    reset_launch_counts()
    aux = TR.train_step_pixels(state, loop.scene, cfg, images, img_ids, cam_sel, py, px,
                               sel_mask, None)
    loss = float(aux["loss"])
    counts = launch_counts()
    grads = {k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
             for k, p in params.named_parameters()}
    return loss, grads, params, counts


def dp_rank(backend, tag):
    """One rank of a phase-14 group: gloo (every rank on the one card) or
    NCCL (a card a rank). One fused-march step sharded against one process
    on the same pixels (rank 0 holds the distances), then STEPS steps of
    TrainLoop on the mesh (uncaptured bundles over gloo, captured over
    NCCL); over NCCL also a replay against BUNDLE uncaptured steps, and
    captured host ms/step on the mesh / rank 0 alone / rank 0 alone / on
    the mesh."""
    import dataclasses
    import torch
    from color_neus_torch import parallel
    from color_neus_torch.runtime import TrainLoop
    device = parallel.init(backend=backend, device="cuda:0" if backend == "gloo" else None)
    mesh = parallel.make_mesh()
    r = mesh.rank
    loop = TrainLoop(arm_cfg("fused_march"), device=device)
    tcfg = dataclasses.replace(loop.tcfg, renderer=dataclasses.replace(loop.tcfg.renderer,
                                                                       perturb=0.0))
    pixels = step_pixels(loop, SEED + 140)
    loss_d, grads_d, params_d, counts = dp_step(loop, parallel.with_mesh(tcfg, mesh), pixels)
    rec = {"rank": r, "world": mesh.world, "backend": mesh.backend, "device": str(device),
           "step_digest": _digest(params_d), "step_counts": {k: v for k, v in counts.items() if v},
           "loss_d": loss_d, "leaf_bytes": 4 * sum(p.numel() for p in params_d.parameters())}
    if r == 0:
        loss_1, grads_1, _, _ = dp_step(loop, tcfg, pixels)
        rel, mx, cos = grad_errors(grads_d, grads_1)
        worst = max(rel, key=rel.get)
        rec.update(loss_1=loss_1, loss_rel=abs(loss_d - loss_1) / abs(loss_1),
                   leaf_worst=rel[worst], leaf_worst_name=worst, leaf_max_rel=max(mx.values()),
                   leaf_min_cos=min(cos.values()), leaves=len(rel),
                   bitwise_leaves=sum(bool(torch.equal(grads_d[k], grads_1[k])) for k in rel))
    del loop
    run = TrainLoop(arm_cfg("fused_march"), device=device, mesh=mesh)
    reset_launch_counts(run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = run.run(STEPS)
    torch.cuda.synchronize()
    ms = run.multi_step
    rec.update(run_ms=(time.perf_counter() - t0) * 1e3 / STEPS,
               losses=[float(x) for x in losses], run_digest=_digest(run.state.params),
               run_counts={k: v for k, v in launch_counts(run).items() if v},
               captured=ms.graph is not None, replays=ms.replays,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if backend == "nccl":
        replay_vs_steps(run, "fused_march", f"{tag} rank {r}")
        rec["ms"] = dp_interleaved(run, r, device)
        rec["replay_digest"] = _digest(run.state.params)
    return rec


def dp_interleaved(loop_d, r, device):
    """Host ms/step of DP_BUNDLES captured bundles on the mesh / of one
    process (rank 0 alone, the others at a barrier) / one process / the
    mesh: rank 0's four readings (the mesh's on every rank)."""
    from color_neus_torch import parallel
    from color_neus_torch.runtime import TrainLoop
    one = None
    if r == 0:
        one = TrainLoop(arm_cfg("fused_march"), device=device)
        one.run(2 * BUNDLE)          # the warm-up bundle and the capture
    parallel.barrier()
    out = []
    for lp in (loop_d, one, one, loop_d):
        if lp is loop_d or r == 0:
            out.append(host_ms(lambda lp=lp: [lp.training_bundle() for _ in range(DP_BUNDLES)],
                               DP_BUNDLES * BUNDLE))
        parallel.barrier()
    return out


def dp_child(backend, tag):
    """A rank of a phase-14 group in a child process (run_group starts it
    with the environment torchrun sets): dp_rank, its record printed as
    one JSON line after CHILD_TAG."""
    from color_neus_torch import parallel, pin_precision
    pin_precision()
    try:
        rec = dp_rank(backend, tag)
    finally:
        parallel.shutdown()
    print(CHILD_TAG + json.dumps(rec), flush=True)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(cmd, world, tag, cwd):
    """`cmd` once per rank of a `world`-rank group on 127.0.0.1, in the
    environment torchrun sets; every rank within DP_TIMEOUT (then all are
    killed) and exiting 0. Each rank's output goes to files (a rank stuck
    on a full pipe would hold the others in a collective). Echoes the
    lines of `tag` and returns each rank's (stdout, stderr)."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    files, procs = [], []
    try:
        for r in range(world):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((out, err))
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
            procs.append(subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out, stderr=err,
                                          text=True))
        t0 = time.perf_counter()
        for p in procs:
            p.wait(timeout=max(1.0, DP_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    for r, (p, (out, err)) in enumerate(zip(procs, texts)):
        for line in out.splitlines():
            if line.startswith(f"[{tag}"):
                print(line, flush=True)
        check(p.returncode == 0, f"[{tag}] rank {r} of {world} exited {p.returncode}:\n"
                                 f"{out[-3000:]}{err[-4000:]}")
    return texts


def child_records(texts, tag):
    recs = []
    for out, _ in texts:
        got = [json.loads(line[len(CHILD_TAG):]) for line in out.splitlines()
               if line.startswith(CHILD_TAG)]
        check(len(got) == 1, f"[{tag}] a child printed {len(got)} records")
        recs.append(got[0])
    return recs


DP_KERNELS = {"sdf_rays": SWEEPS_PER_STEP, "ray_march_save": 1, "ray_march_bwd_load": 1}
DP_CHILD = [sys.executable, "-c",
            "import sys, chip_smoke; chip_smoke.dp_child(sys.argv[1], sys.argv[2])"]


def check_ranks(recs, tag):
    """dp_rank's records of one group: the sharded step within
    RTOL_DP_LOSS / RTOL_DP_LEAF of one process, the replicas bitwise equal
    after it and after the run, the run's losses equal across the ranks and
    halving, rows 1, 3 and 4 launched DP_KERNELS times a step on every
    rank. Prints the readings."""
    a = recs[0]
    world = len(recs)
    print(f"[{tag}] {world} ranks ({', '.join(r['device'] for r in recs)}) over "
          f"{a['backend']}, fused_march on (save, f32stash), 1024 rays x 128 samples, "
          f"{1024 // world} a rank, perturb 0, step {DP_STEP}: loss {a['loss_d']:.8f} against "
          f"one process's {a['loss_1']:.8f}, relative {a['loss_rel']:.3e} (limit "
          f"{RTOL_DP_LOSS:g}) | clipped leaves, norm-relative: worst {a['leaf_worst']:.3e} "
          f"({a['leaf_worst_name']}, limit {RTOL_DP_LEAF:g}), max-relative "
          f"{a['leaf_max_rel']:.3e}, min cosine {a['leaf_min_cos']:.9f}, "
          f"{a['bitwise_leaves']} of {a['leaves']} bitwise | step launches per rank "
          + " / ".join(str(r["step_counts"]) for r in recs), flush=True)
    check(a["loss_rel"] <= RTOL_DP_LOSS, f"[{tag}] sharded loss {a['loss_rel']:.3e} from one "
                                         f"process's, above {RTOL_DP_LOSS:g}")
    check(a["leaf_worst"] <= RTOL_DP_LEAF, f"[{tag}] sharded leaf {a['leaf_worst_name']} "
                                           f"{a['leaf_worst']:.3e} from one process's, above "
                                           f"{RTOL_DP_LEAF:g}")
    check(len({r["step_digest"] for r in recs}) == 1,
          f"[{tag}] the ranks' parameters differ after the sharded step")
    losses = a["losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    capture = a["backend"] == "nccl"
    print(f"[{tag}] TrainLoop on the mesh, {STEPS} steps in "
          f"{'captured' if capture else 'uncaptured'} bundles of {BUNDLE} ({a['replays']} "
          f"replays): " + " / ".join(f"{r['run_ms']:.2f}" for r in recs) + " ms/step incl. "
          f"the first bundle's set-up | loss {first:.5f} -> {last:.5f} | launches per rank "
          + " / ".join(str(r["run_counts"]) for r in recs) + " | peak memory "
          + " / ".join(f"{r['peak_gib']:.2f}" for r in recs) + " GiB", flush=True)
    for r in recs:
        check(r["captured"] == capture and (r["replays"] > 0) == capture,
              f"[{tag}] rank {r['rank']}: captured {r['captured']}, {r['replays']} replays "
              f"over {a['backend']}")
        check(r["losses"] == losses, f"[{tag}] rank {r['rank']}'s losses differ from rank 0's")
        for k, per_step in DP_KERNELS.items():
            check(r["step_counts"].get(k) == per_step and
                  r["run_counts"].get(k) == per_step * STEPS,
                  f"[{tag}] rank {r['rank']}: {k} launched {r['step_counts'].get(k)} times in "
                  f"the step and {r['run_counts'].get(k)} in the run, want {per_step} and "
                  f"{per_step * STEPS}")
    check(len({r["run_digest"] for r in recs}) == 1,
          f"[{tag}] the ranks' parameters differ after the run")
    check(all(x == x and abs(x) != float("inf") for x in losses), f"[{tag}] non-finite loss")
    check(last < 0.5 * first, f"[{tag}] loss did not halve: {first} -> {last}")


def dp_phase():
    """Phase 14: data-parallel training on the card, in child processes that
    load the kernels phase 1 built. (a) DP_RANKS ranks over gloo; (b) the
    entry point `python -m color_neus_torch.train --distributed` as the
    one rank of an NCCL group, then nccl_group at world size 1."""
    import numpy as np
    import yaml
    collect()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    recs = child_records(run_group(DP_CHILD + ["gloo", "14a"], DP_RANKS, "14a", here), "14a")
    check_ranks(recs, "14a")
    t_a = time.perf_counter() - t0

    # (b) the entry point as the one rank of an NCCL group
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "dp.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(arm_cfg("fused_march").to_dict(), f)
        [(out, err)] = run_group([sys.executable, "-m", "color_neus_torch.train",
                                  "--distributed", "--cfg", cfg_path, "--iterations",
                                  str(2 * BUNDLE)], 1, "14b", tmp)
        exp = glob.glob(os.path.join(tmp, "exp", "default_*", "checkpoints", "state.npz"))
        check(len(exp) == 1, f"[14b] train --distributed wrote {len(exp)} checkpoints")
        with np.load(exp[0]) as ck:
            ck_step = int(ck["step"])
    log = out + err
    check("rays sharded over 1 ranks (nccl)" in log and ck_step == 2 * BUNDLE,
          f"[14b] train --distributed: no NCCL mesh in its log or checkpoint step {ck_step}:\n"
          f"{log[-3000:]}")
    print(f"[14b] python -m color_neus_torch.train --distributed (RANK 0, WORLD_SIZE 1, "
          f"NCCL): {2 * BUNDLE} steps in bundles of {BUNDLE}, checkpoint at step {ck_step}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    b = nccl_group(1, "14b")
    return {"a": recs, "b": b, "a_s": t_a, "b_s": time.perf_counter() - t0,
            "counts": {k: sum(r["run_counts"].get(k, 0) for r in recs + b) for k in DP_KERNELS}}


def nccl_group(world, tag):
    """dp_rank on `world` NCCL ranks, a card each (phase 14(b): world 1;
    a host with several cards can run more): check_ranks, the replicas
    bitwise equal after the timed bundles, and the interleaved captured
    ms/step printed beside the card's name and power limit. Returns the
    records."""
    here = os.path.dirname(os.path.abspath(__file__))
    recs = child_records(run_group(DP_CHILD + ["nccl", tag], world, tag, here), tag)
    check_ranks(recs, tag)
    check(len({r["replay_digest"] for r in recs}) == 1, f"[{tag}] the replicas differ")
    d1, o1, o2, d2 = recs[0]["ms"]
    print(f"[{tag}] captured bundles, host ms/step: the mesh of {world} {d1:.2f} / one "
          f"process {o1:.2f} / one process {o2:.2f} / the mesh {d2:.2f} | the mesh's cost "
          f"{(d1 + d2 - o1 - o2) / 2:+.2f} ms/step (the all-reduce of "
          f"{recs[0]['leaf_bytes'] / 1e6:.2f} MB of leaves and the gathers) | {card_line()}",
          flush=True)
    return recs


def mode_sass_summary(sass):
    """Phase 1's per-mode summary of rows 3-6: every kernel's HGMMA, UBLKCP,
    FFMA, registers and spill bytes, one line per MARCH_BWD_PRECISION mode
    (the f32stash entries' HGMMA counts, 86 / 320 / 234 on the H100 with
    the forward, backward and load entries: printed, not checked)."""
    from color_neus_torch.ops.kernels import point_pipeline as PP
    for mode in PP.MODES:
        sfx = PP.SUFFIX[mode]
        rows = {fn: c for fn, c in sass.items() if re.sub(r"_kernel(_bf16s|_f32s)?$", "_kernel",
                                                          fn) + sfx == fn}
        print(f"[1] rows 3-6, MARCH_BWD_PRECISION {mode}: " + " | ".join(
            f"{fn}: {c['HGMMA']} HGMMA, {c['UBLKCP']} UBLKCP, {c['REDG']} REDG, "
            f"{c['UBLKRED']} UBLKRED, "
            f"{c['FFMA']} FFMA, {c.get('registers')} registers, spills {c.get('spill_stores')} / "
            f"{c.get('spill_loads')} bytes" for fn, c in sorted(rows.items())), flush=True)


def step_pixels(trained, seed):
    """One step's pixels of the trained loop (phase 3's), drawn as its
    training step draws them from a generator seeded `seed`."""
    import torch
    from color_neus_torch.models import trainer as TR
    g = torch.Generator(device=trained.device).manual_seed(seed)
    img_ids = torch.arange(min(trained.batch_size, trained.n_imgs), device=trained.device)
    images = trained.images[img_ids]
    masks = trained.masks[img_ids] if trained.masks is not None else None
    with torch.no_grad():
        cam_sel, py, px, sel_mask = TR.sample_pixels(trained.tcfg, images, masks,
                                                     trained.state.step, g)
    return img_ids, images, cam_sel, py, px, sel_mask


def mode_training(device, trained, mode, path, seed):
    """Phase 12b: Color-NeuS at full width (SMOKE_CFG) trained in
    MARCH_BWD_PRECISION `mode` through the kernel path `path` (PREC_PATHS),
    STEPS steps in captured bundles: launches by name (the mode's kernels
    of the path once a step each, the sweeps, nothing else), every loss
    finite, the loss halving (phases 7 / 8); then one step's leaf
    gradients on phase 3's trained weights against the f32 plain core at
    phase 7's limits, on the pixels drawn from `seed` (PATH_GRAD_SEED),
    printed beside the f32stash kernels' on the same pixels (the SDF
    leaves: 'f32' computes that chain in f32); and, but for
    the save pair (phase 11a holds it, arms fused_march_bf16 / _f32), a
    replay of the captured bundle against the steps one by one. Returns
    {"counts", "step_ms", "grad_err", "sdf_leaves"}."""
    import torch
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import config_from_dict
    model = SMOKE_CFG["MODEL"]
    renderer = {**model["RENDERER"], **PREC_PATHS[path], "MARCH_BWD_PRECISION": mode}
    loop = TrainLoop(config_from_dict({**SMOKE_CFG, "MODEL": {**model, "RENDERER": renderer}}),
                     device=device)
    check(loop.tcfg.renderer.march_bwd_precision == mode, f"{mode} did not reach the renderer")
    tag = f"{path} {mode}"
    torch.cuda.synchronize()
    reset_launch_counts(loop)
    t0 = time.perf_counter()
    losses = [float(x) for x in loop.run(STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(loop)
    want = {k: 0 for k in counts}
    want["sdf_rays"] = SWEEPS_PER_STEP * STEPS
    want.update({k + PP.SUFFIX[mode]: STEPS for k in PATH_KERNELS[path]})
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[12b] {tag}, {STEPS} steps in bundles of {loop.k_steps}: {wall * 1e3 / STEPS:.2f} "
          f"ms/step incl. the warm-up bundle and the capture | loss {first:.5f} -> {last:.5f} | "
          f"launches {({k: v for k, v in counts.items() if v})}", flush=True)
    check(counts == want, f"{tag} training launched {counts}, want {want}")
    check(all(x == x and abs(x) != float("inf") for x in losses), f"{tag}: non-finite loss")
    check(last < 0.5 * first, f"{tag}: loss did not halve: {first} -> {last}")
    step_ms = host_ms(lambda: loop.run(loop.state.step + 2 * BUNDLE), 2 * BUNDLE)
    if path != "fused_march":
        replay_vs_steps(loop, path if mode == "f32stash" else f"{path}_{mode}", "12b")
    del loop
    torch.cuda.empty_cache()

    pixels = step_pixels(trained, seed)
    switch = {k.lower(): v for k, v in PREC_PATHS[path].items()}
    off = step_grads(trained, pixels, **{k: "off" for k in switch if k.startswith("fused")})
    grads = {m: step_grads(trained, pixels, **switch, march_bwd_precision=m)
             for m in ("f32stash", mode)}
    errs = {m: grad_errors(g, off) for m, g in grads.items()}
    e, _, cos = errs[mode]
    worst, worst_cos = max(e, key=e.get), min(cos, key=cos.get)
    median = sorted(e.values())[len(e) // 2]
    e0 = errs["f32stash"][0]
    sdf = {m: {k: v for k, v in errs[m][0].items() if "sdf" in k} for m in errs}
    print(f"[12b] {tag}: one step's leaf gradients on the trained weights vs the f32 plain "
          f"core: worst |a-b| / |b| {e[worst]:.3e} ({worst}), median {median:.3e}, min cosine "
          f"{cos[worst_cos]:.6f} ({worst_cos}) (limits {RTOL_STEP_GRAD:g} / "
          f"{RTOL_STEP_GRAD_MEDIAN:g} / {MIN_COS_STEP_GRAD:g}); the f32stash kernels on the "
          f"same pixels: worst {max(e0.values()):.3e}, median "
          f"{sorted(e0.values())[len(e0) // 2]:.3e} | SDF leaves, {mode} / f32stash: "
          + " ".join(f"{k.replace('renderer.sdf.', '')} {sdf[mode][k]:.2e}/"
                     f"{sdf['f32stash'][k]:.2e}" for k in sorted(sdf[mode])), flush=True)
    check(e[worst] <= RTOL_STEP_GRAD, f"{tag}: step gradient {worst} {e[worst]:.3e}")
    check(median <= RTOL_STEP_GRAD_MEDIAN, f"{tag}: step gradients' median {median:.3e}")
    check(cos[worst_cos] >= MIN_COS_STEP_GRAD, f"{tag}: cosine {cos[worst_cos]:.6f}")
    worst_sdf = {m: max(v.values()) for m, v in sdf.items()}
    if mode == "f32":
        check(worst_sdf["f32"] * F32_SDF_GAIN <= worst_sdf["f32stash"],
              f"{tag}: worst SDF leaf {worst_sdf['f32']:.3e} from the f32 plain core, not "
              f"{F32_SDF_GAIN}x closer than f32stash's {worst_sdf['f32stash']:.3e}")
    return {"counts": counts, "step_ms": step_ms, "grad_err": e[worst],
            "sdf_leaves": worst_sdf}


def f32_activations(device) -> dict:
    """Phase 12a, MARCH_BWD_PRECISION f32 against float64: row 3's save
    entry on phase 12a's Color-NeuS march inputs (1024 rays x 128
    samples); every hidden SDF layer's softplus from its activation stash,
    its mean signed and RMS relative error (the scale floored at 1e-3)
    beside the plain f32 path's (PyTorch's f32 products on this card); the
    features as the stash keeps them, in bf16: how many round to another
    bf16 value than float64's, beside the plain path's; the stash's
    gradient lane, max-relative, beside the plain path's."""
    import torch
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM
    rcfg, pw, o, d, z, inv_s, _ = march_inputs(device, "color_neus", MARCH_VARIANCES[0],
                                               SEED + 120, "f32")
    sd = 2.0 / rcfg.n_samples
    _, stash, act = RM.launch_ray_march_save(pw, o, d, z, inv_s, sd)
    torch.cuda.synchronize()
    _, _, pts, dirs = RM.march_points(o, d, z, sd)
    pw64 = PP.PipelineWeights(rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                      for layers in (pw.sdf, pw.color, pw.relight)])
    n_sdf, hid, (R, S) = len(pw.sdf), PP.HID, z.shape
    n = R * S
    rows = act[:n * RM.act_row_bytes(pw)].reshape(n, -1)
    sp = rows[:, :(n_sdf - 1) * hid * 4].contiguous().view(torch.float32).reshape(n, -1, hid)
    feat = RM.act_cr(pw, act, R, S, 0)   # cr slot 0: the features
    with torch.no_grad():
        o32, st32 = PP._forward(pw, pts, dirs, True)
        o64, st64 = PP._forward(pw64, pts.double(), dirs.double(), True)

    def rel(x, ref):   # signed relative error, the scale floored at 1e-3
        return (x.double() - ref) / ref.abs().clamp_min(1e-3)
    layers = []
    for l, ref in enumerate(st64.sps):
        k, p = rel(sp[:, l, :ref.shape[1]], ref), rel(st32.sps[l], ref)
        layers.append({"kernel_mean": float(k.mean()), "kernel_rms": float(k.pow(2).mean().sqrt()),
                       "plain_mean": float(p.mean()), "plain_rms": float(p.pow(2).mean().sqrt())})
    f64 = st64.cs[0][:, -hid:]
    b64 = f64.float().to(torch.bfloat16).float()
    b32 = st32.cs[0][:, -hid:].to(torch.bfloat16).float()
    g64 = o64[1]
    return {"layers": layers,
            "flips": {"kernel": int((feat != b64).sum()), "plain": int((b32 != b64).sum()),
                      "of": int(f64.numel()), "points": n},
            "grad_rel": {"kernel": float((stash[:, 1:4].double() - g64).abs().max()
                                         / g64.abs().max()),
                         "plain": float((o32[1].double() - g64).abs().max() / g64.abs().max())}}


def f32_activation_gate(acc: dict) -> None:
    """Prints f32_activations' record and holds it (F32_BIAS_FACTOR)."""
    fl, gr, layers = acc["flips"], acc["grad_rel"], acc["layers"]
    bias = F32_BIAS_FACTOR * max(abs(r["plain_mean"]) for r in layers)
    print(f"[12a] f32 against float64, row 3's save entry on {fl['points']} points: the "
          f"features' bf16 flips {fl['kernel']} (the plain f32 path {fl['plain']}) of "
          f"{fl['of']} | grad max-relative {gr['kernel']:.3e} (plain {gr['plain']:.3e}) | "
          f"hidden layers' mean signed / RMS relative error, kernel (plain): "
          + " ".join(f"{l}: {r['kernel_mean']:.2e} / {r['kernel_rms']:.2e} "
                     f"({r['plain_mean']:.2e} / {r['plain_rms']:.2e})"
                     for l, r in enumerate(layers)) + f" | |mean| limit {bias:.2e}", flush=True)
    check(fl["kernel"] <= fl["plain"],
          f"[12a] f32: {fl['kernel']} feature bf16 flips against float64, more than the plain "
          f"f32 path's {fl['plain']}")
    for l, r in enumerate(layers):
        check(abs(r["kernel_mean"]) <= bias,
              f"[12a] f32: layer {l}'s mean signed error {r['kernel_mean']:.3e} against float64, "
              f"above {F32_BIAS_FACTOR:g}x the plain path's largest |mean| ({bias:.3e})")


def mode_evaluation(device, trained):
    """Phase 12c: one validation render of the trained loop's camera
    PREC_EVAL_CAM in MARCH_BWD_PRECISION f32 and in f32stash through row 5
    (fused_core auto) against the f32 plain path (fused_core off), same
    seed: the image and depth; and row 5 of each mode on that view's points
    (its rays through the sphere, PREC_EVAL_SAMPLES samples each) against
    the f32 plain twin, max-relative. 'f32' should sit far closer on sdf
    and grad (its SDF chain is f32; the colour chain stays bf16, so the
    image moves less); all are printed, and the sdf and grad of 'f32' are held
    to the f32stash kernel's distance."""
    import dataclasses
    import numpy as np
    import torch
    from color_neus_torch.models import trainer as TR
    from color_neus_torch.models.camera import focal_apply, pose_apply
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.rays import all_rays_for_camera, near_far_from_sphere
    params, scene, tcfg = trained.state.params, trained.scene, trained.tcfg
    H, W = trained.H, trained.W
    images, rows = {}, {}
    with torch.no_grad():
        for mode, core in (("f32", "auto"), ("f32stash", "auto"), ("f32", "off")):
            tc = dataclasses.replace(tcfg, renderer=dataclasses.replace(
                tcfg.renderer, fused_core=core, march_bwd_precision=mode))
            g = torch.Generator(device=device).manual_seed(SEED + 7)
            reset_launch_counts()
            images[mode, core] = TR.render_image(params, scene, tc, PREC_EVAL_CAM, H, W, g)
            counts = launch_counts()
            launched = counts["point_pipeline" + PP.SUFFIX[mode]]
            check((launched > 0) == (core == "auto"), f"the {mode} {core} render launched {counts}")
        dev = scene["init_c2w"].device
        c2w = pose_apply(params["pose"], tcfg.camera, scene["init_c2w"],
                         torch.tensor([PREC_EVAL_CAM], device=dev))[0]
        ro, rd = all_rays_for_camera(c2w, focal_apply(params["focal"], tcfg.camera), H, W,
                                     normalize=tcfg.normalize_dir, opengl=tcfg.opengl)
        ro = (ro.reshape(-1, 3) - scene["origin"]) / scene["radius"]
        rd = rd.reshape(-1, 3)
        near, far = near_far_from_sphere(ro, rd)
        t = torch.linspace(0.0, 1.0, PREC_EVAL_SAMPLES, device=dev)
        z = near[:, None] + (far - near)[:, None] * t
        pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()
        dirs = rd[:, None, :].expand(-1, PREC_EVAL_SAMPLES, 3).reshape(-1, 3).contiguous()
        for mode in ("f32", "f32stash"):
            rc = dataclasses.replace(tcfg.renderer, march_bwd_precision=mode)
            pw = PP.resolve_pipeline_weights(params["renderer"], rc)
            got = PP.fused_point_pipeline_fwd(None, rc, pts, dirs, weights=pw)
            want = PP.point_pipeline_plain(pw, pts, dirs)
            rows[mode] = {k: _rel(a, b) for k, a, b in zip(PIPELINE_OUTPUTS, got, want)}
    ref = images["f32", "off"]
    img = {m: (float(np.abs(images[m, "auto"][0] - ref[0]).max()),
               float(np.abs(images[m, "auto"][1] - ref[1]).max())) for m in ("f32", "f32stash")}
    print(f"[12c] validation view {PREC_EVAL_CAM} ({H}x{W}) against the f32 plain path: "
          f"max|image| / max|depth| difference f32 {img['f32'][0]:.3e} / {img['f32'][1]:.3e}, "
          f"f32stash {img['f32stash'][0]:.3e} / {img['f32stash'][1]:.3e} | row 5 on the view's "
          f"{pts.shape[0]} points vs the f32 plain twin, max-relative: f32 "
          + " ".join(f"{k} {v:.3e}" for k, v in rows["f32"].items()) + "; f32stash "
          + " ".join(f"{k} {v:.3e}" for k, v in rows["f32stash"].items()), flush=True)
    for k in ("sdf", "grad"):
        check(rows["f32"][k] <= rows["f32stash"][k],
              f"f32 row 5 {k} {rows['f32'][k]:.3e} from the f32 twin, not closer than "
              f"f32stash's {rows['f32stash'][k]:.3e}")
    return {"rows": rows, "image": img}


def precision_phase(device, trained, base):
    """Phase 12, MARCH_BWD_PRECISION bf16 and f32: (a) rows 5, 6, 3 and 4
    (with the save and load entries) in each mode held against their twins
    in the same mode by phases 2b-2d's rules, at their shapes (131,072
    points, 1024 x 128 rays, Color-NeuS and NeuS), their CUDA-event times
    and bounds printed beside the f32stash entries' of phases 2b-2d
    (`base`: their records, this call), and f32's activations against
    float64 (f32_activation_gate); (b) mode_training of each mode
    through each path; (c) mode_evaluation. Returns the records the kernel
    line reads."""
    out = {}
    for mode in PREC_MODES:
        t0 = time.perf_counter()
        ev = eval_kernels_vs_plain(device, mode, "12a")["point_pipeline_color_neus"]
        bw = pipeline_bwd_vs_plain(device, mode, "12a")["color_neus"]
        mr = march_vs_plain(device, mode, "12a")
        b_ev, b_bw, b_mr = base["eval"], base["bwd"], base["march"]

        def entry(r, b, key):   # ms / f32stash's ms (bound; f32: and the SIMT bound)
            simt = f"; SIMT {r[f'simt_{key}_ms']:.4f}" if mode == "f32" else ""
            ms = key.replace("bound", "ms")
            return f"{r[ms]:.4f} / {b[ms]:.4f} ({r[f'{key}_ms']:.4f}{simt})"
        print(f"[12a] {mode}, Color-NeuS, ms beside f32stash's in this call (bound"
              + ("; SIMT: the SDF products at the f32 SIMT peak" if mode == "f32"
                 else "") + f"): row 5 {entry(ev, b_ev, 'bound')} | row 6 "
              f"{entry(bw, b_bw, 'bound')} | row 3 {entry(mr, b_mr, 'bound')} | row 4 "
              f"{entry(mr, b_mr, 'bwd_bound')} | save {entry(mr, b_mr, 'save_bound')} | load "
              f"{entry(mr, b_mr, 'load_bound')} | {time.perf_counter() - t0:.1f} s", flush=True)
        out[mode] = {"eval": ev, "bwd": bw, "march": mr, "train": {}}
        if mode == "f32":
            out[mode]["accuracy"] = f32_activations(device)
            f32_activation_gate(out[mode]["accuracy"])
    for mode in PREC_MODES:
        for path in PREC_PATHS:
            out[mode]["train"][path] = mode_training(device, trained, mode, path,
                                                     PATH_GRAD_SEED[path])
    out["eval"] = mode_evaluation(device, trained)
    return out


def falling(losses, tag):
    """(first-5 mean, last-5 mean) of a run's losses, checked finite and
    falling."""
    losses = [float(x) for x in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(all(x == x and abs(x) != float("inf") for x in losses), f"[{tag}] non-finite loss")
    check(last < first, f"[{tag}] the loss did not fall: {first} -> {last}")
    return first, last


def slice16_phase(device, trained, bundles, auto_step_ms):
    """Phase 13: (a) the grid SDF's f32x3 entry (row 2) on 2^18 points of the
    res-512 lattice, on the geometric init and on phase 3's trained
    weights: against its plain twin (ATOL_GRID['f32x3']), its distance from
    the f32 entry, ms beside the f32 and bf16 entries, the bound; (b) a
    res-512 sparse extraction with EXTRACT_PRECISION f32x3 on phase 3's
    weights through testing_step (seconds, counts, launches), its mesh
    against the f32 one's (chamfer), sparse == dense bitwise at res 128;
    (c) RAY_CHUNK: one auto step chunked at CHUNK_RAYS against unchunked on
    the same pixels (loss, every leaf), and phase 11's auto_chunked arm at
    2048 x 512 beside the unchunked auto's peak and ms; (d) COMPUTE_DTYPE
    bfloat16: auto trained 60 steps (the loss falls), ms/step beside f32
    auto's, one step's leaves against f32; (e) N_OUTSIDE 32 on the NeuS
    kind, 60 steps: the loss falls, every leaf finite, the nerf leaves
    move, the sweep the only kernel; (f) OPTIMIZE.TYPE sgd through the
    fused march in captured bundles: the loss falls, a replay bitwise equal
    to 10 uncaptured steps; (g) write_glb of (b)'s mesh read back. Returns
    the f32x3 entry's kernel-line record."""
    import dataclasses
    import numpy as np
    import torch
    from color_neus_torch.models.fields import init_sdf
    from color_neus_torch.ops import mesh
    from color_neus_torch.ops.kernels import sdf_mlp
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import config_from_dict
    from color_neus_torch.utils.metrics import _nn_sq_dists

    # (a) the kernel on two weight sets
    sdf_cfg = trained.tcfg.renderer.sdf
    g = torch.Generator(device=device).manual_seed(SEED + 160)
    weight_sets = {"geometric init": init_sdf(sdf_cfg, g, device),
                   "trained": trained.state.params["renderer"]["sdf"]}
    pts = lattice_chunk(trained.bbox_min, trained.bbox_max, EVAL_RES, EVAL_RES ** 3 // 2,
                        GRID_CHUNK, device)
    rec = {}
    for name, params in weight_sets.items():
        fns = {p: sdf_mlp.make_fused_sdf_fn(params, sdf_cfg, p) for p in ("f32", "bf16", "f32x3")}
        with torch.no_grad():
            before = sdf_mlp.launch_sdf_points.launches
            got = {p: f(pts) for p, f in fns.items()}
            torch.cuda.synchronize()
            check(sdf_mlp.launch_sdf_points.launches == before + 3,
                  "[13a] the grid SDF functions did not launch the kernel")
            want = sdf_mlp.sdf_points_plain(fns["f32x3"].weights, pts)
            err = float((got["f32x3"] - want).abs().max())
            dist = float((got["f32x3"] - got["f32"]).abs().max())
            ms = {p: cuda_ms(lambda f=f: f(pts)) for p, f in fns.items()}
            plain_ms = cuda_ms(lambda: sdf_mlp.sdf_points_plain(fns["f32x3"].weights, pts),
                               reps=5)
        bound, bound_by, what = grid_bound_ms(fns["f32x3"].weights, GRID_CHUNK)
        print(f"[13a] sdf_points f32x3, {name}, {GRID_CHUNK} points of the res-{EVAL_RES} "
              f"lattice's centre plane: |sdf| max {float(want.abs().max()):.3f} | "
              f"max|kernel-plain| {err:.3e} (atol {ATOL_GRID['f32x3']:g}) | from the f32 entry "
              f"{dist:.3e} (bf16 entry {float((got['bf16'] - got['f32']).abs().max()):.3e}) | "
              f"kernel {ms['f32x3']:.4f} ms beside f32 {ms['f32']:.4f} and bf16 {ms['bf16']:.4f} "
              f"| plain {plain_ms:.4f} ms | bound {bound:.4f} ms ({bound_by}: {what})",
              flush=True)
        check(bool(torch.isfinite(got["f32x3"]).all()) and err <= ATOL_GRID["f32x3"],
              f"[13a] f32x3 grid SDF on the {name} weights: {err:.3e} from its twin")
        rec[name] = {"err": err, "ms": ms["f32x3"], "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by}

    # (b) the res-512 extraction in f32x3 through testing_step, and in f32
    tcfg = trained.tcfg
    x3 = dataclasses.replace(tcfg, renderer=dataclasses.replace(tcfg.renderer,
                                                                extract_precision="f32x3"))
    meshes = {}
    for prec, tc in (("f32x3", x3), ("f32", tcfg)):
        trained.tcfg = tc
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = trained.testing_step(trained.state.step, recon_res=EVAL_RES)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            trained.tcfg = tcfg
        check(out is not None and len(out[0]) > 0, f"[13b] {prec}: empty res-{EVAL_RES} mesh")
        check(counts["sdf_points"] > 0 and counts["point_pipeline"] > 0,
              f"[13b] {prec}: testing_step launched {counts}")
        meshes[prec] = out
        print(f"[13b] testing_step res {EVAL_RES} sparse, EXTRACT_PRECISION {prec}: {secs:.3f} s"
              f" | {len(out[0])} verts {len(out[1])} tris | grid launches "
              f"{counts['sdf_points']}, vertex colours {counts['point_pipeline']}", flush=True)
        if prec == "f32x3":
            x3_launches = counts["sdf_points"]
    # chamfer_distance's mean squared nearest-neighbour distances, each
    # mean over CHAMFER_SAMPLES query vertices of one mesh (seeded) against
    # every vertex of the other, in float64 on the card
    a, b = (torch.as_tensor(meshes[p][0], dtype=torch.float64, device=device)
            for p in ("f32x3", "f32"))
    gq = torch.Generator(device=device).manual_seed(SEED + 162)
    qa, qb = (x[torch.randperm(len(x), generator=gq, device=device)[:CHAMFER_SAMPLES]]
              for x in (a, b))
    chamfer = float(_nn_sq_dists(qa, b, tile=256).mean() + _nn_sq_dists(qb, a, tile=256).mean())
    params, r3 = trained.state.params["renderer"], x3.renderer
    vs, ts = mesh.extract_geometry(params, r3, trained.bbox_min, trained.bbox_max, 128, sparse=True)
    vd, td = mesh.extract_geometry(params, r3, trained.bbox_min, trained.bbox_max, 128,
                                   sparse=False)
    print(f"[13b] f32x3 mesh against the f32 mesh: chamfer {chamfer:.3e} ({CHAMFER_SAMPLES} "
          f"query vertices a side; limit "
          f"{MAX_CHAMFER_X3:g}) | res 128 f32x3: sparse {len(vs)} / dense {len(vd)} verts, "
          f"{len(ts)} / {len(td)} tris", flush=True)
    check(chamfer <= MAX_CHAMFER_X3, f"[13b] f32x3 mesh {chamfer:.3e} from the f32 mesh")
    check(len(vs) > 0 and len(vs) == len(vd) and len(ts) == len(td)
          and np.array_equal(sorted_rows(vs), sorted_rows(vd)),
          "[13b] res 128 f32x3: the sparse and dense meshes differ")

    # (g) write_glb of (b)'s mesh, read back
    v3, t3, c3 = meshes["f32x3"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.glb")
        mesh.write_glb(path, v3, t3, c3)
        gltf, binary = mesh.read_glb(path)
        size = os.path.getsize(path)
    acc = gltf["accessors"]
    nv, nt = len(v3), len(t3)
    print(f"[13g] write_glb: {size} bytes, accessors {[x['count'] for x in acc]}, BIN "
          f"{len(binary)} bytes, generator {gltf['asset']['generator']}", flush=True)
    check([x["count"] for x in acc] == [nv, 3 * nt, nv] and len(binary) == 24 * nv + 12 * nt
          and np.array_equal(np.frombuffer(binary[:12 * nv], np.float32).reshape(-1, 3),
                             np.asarray(v3, np.float32)), "[13g] the glb does not read back")

    # (c) RAY_CHUNK: one auto step chunked against unchunked; the bench shape
    pixels = step_pixels(trained, SEED + 161)
    l0, g0 = step_grads(trained, pixels, with_loss=True)
    l1, g1 = step_grads(trained, pixels, with_loss=True, ray_chunk=CHUNK_RAYS)
    e, _, cos = grad_errors(g1, g0)
    worst = max(e, key=e.get)
    print(f"[13c] auto, {trained.tcfg.n_rays} x 128, RAY_CHUNK {CHUNK_RAYS} against unchunked: "
          f"loss {l1:.8f} / {l0:.8f} | worst leaf |a-b| / |b| {e[worst]:.3e} ({worst}), "
          f"min cosine {min(cos.values()):.8f} (limits {RTOL_CHUNK_LOSS:g} / "
          f"{RTOL_CHUNK_GRAD:g})", flush=True)
    check(abs(l1 - l0) <= RTOL_CHUNK_LOSS * abs(l0) and e[worst] <= RTOL_CHUNK_GRAD,
          f"[13c] the chunked step differs: loss {l1} / {l0}, {worst} {e[worst]:.3e}")
    ch, un = bundles["auto_chunked_bench"], bundles["auto_bench"]
    print(f"[13c] 2048 x 512, RAY_CHUNK {CHUNK_RAYS} (phase 11): peak memory above what "
          f"the earlier phases hold, uncaptured {ch['peak_u'] - ch['base']:.2f} GiB (warm-up + "
          f"capture + replay {ch['peak_cap'] - ch['base']:.2f}) against the unchunked auto's "
          f"{un['peak_u'] - un['base']:.2f} | ms/step uncaptured "
          f"{sum(ch['u']) / 2:.2f}, captured {sum(ch['c']) / 2:.2f} against the unchunked "
          f"{sum(un['u']) / 2:.2f} uncaptured" + (f", {sum(un['c']) / 2:.2f} captured"
                                                    if "c" in un else ""), flush=True)
    check(ch["peak_u"] - ch["base"] < un["peak_u"] - un["base"],
          "[13c] chunking did not lower the peak")

    model = SMOKE_CFG["MODEL"]
    # (d) COMPUTE_DTYPE bfloat16 on the plain core
    loop = TrainLoop(config_from_dict({**SMOKE_CFG, "MODEL": {**model, "RENDERER": {
        **model["RENDERER"], "COMPUTE_DTYPE": "bfloat16"}}}), device=device)
    first, last = falling(loop.run(STEPS), "13d")
    step_ms = host_ms(lambda: loop.run(loop.state.step + 2 * BUNDLE), 2 * BUNDLE)
    del loop
    collect()
    l16, g16 = step_grads(trained, pixels, with_loss=True, compute_dtype="bfloat16")
    e, _, cos = grad_errors(g16, g0)
    worst, median = max(e, key=e.get), sorted(e.values())[len(e) // 2]
    print(f"[13d] auto, COMPUTE_DTYPE bfloat16: {STEPS} steps, loss {first:.5f} -> {last:.5f} | "
          f"{step_ms:.2f} ms/step (2 replays) against f32 auto's {auto_step_ms:.2f} | one step "
          f"on the trained weights against f32: loss {l16:.6f} / {l0:.6f}, leaves worst "
          f"|a-b| / |b| {e[worst]:.3e} ({worst}), median {median:.3e}, min cosine "
          f"{min(cos.values()):.6f}", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in g16.values()), "[13d] non-finite leaf")

    # (e) N_OUTSIDE 32, the NeuS kind
    renderer = {k: v for k, v in model["RENDERER"].items() if k != "RELIGHT"}
    renderer.update(TYPE="NeuS", COLOR=NEUS_COLOR, N_OUTSIDE=N_OUTSIDE)
    loop = TrainLoop(config_from_dict({**SMOKE_CFG, "MODEL": {
        **model, "RENDERER": renderer, "LOSS": {**model["LOSS"], "LAMBDA_MASK": 0.0}}}),
        device=device)
    nerf0 = {k: p.detach().clone() for k, p in loop.state.params["renderer"]["nerf"]
             .named_parameters()}
    torch.cuda.synchronize()
    reset_launch_counts(loop)
    t0 = time.perf_counter()
    first, last = falling(loop.run(STEPS), "13e")
    wall = time.perf_counter() - t0
    counts = launch_counts(loop)
    moved = sum(not torch.equal(p, nerf0[k]) for k, p in
                loop.state.params["renderer"]["nerf"].named_parameters())
    finite = all(bool(torch.isfinite(p).all()) for p in loop.state.params.parameters())
    print(f"[13e] NeuS, N_OUTSIDE {N_OUTSIDE} (nerf {loop.tcfg.renderer.nerf.depth} x "
          f"{loop.tcfg.renderer.nerf.width}): {STEPS} steps, {wall * 1e3 / STEPS:.2f} ms/step incl. "
          f"the warm-up bundle and the capture | loss {first:.5f} -> {last:.5f} | nerf leaves "
          f"moved {moved} of {len(nerf0)} | every leaf finite {finite} | launches "
          f"{({k: v for k, v in counts.items() if v})}", flush=True)
    check(finite and moved == len(nerf0), "[13e] a leaf is not finite or a nerf leaf is still")
    check(counts == {k: SWEEPS_PER_STEP * STEPS if k == "sdf_rays" else 0 for k in counts},
          f"[13e] launches {counts}")
    del loop
    collect()

    # (f) SGD in captured bundles
    loop = TrainLoop(sgd_cfg(), device=device)
    first, last = falling(loop.run(STEPS), "13f")
    check(loop.multi_step.replays > 0, "[13f] no captured SGD bundle replayed")
    print(f"[13f] OPTIMIZE.TYPE sgd (lr {SGD_OPTIMIZE['LR']:g}) through the fused march: {STEPS} "
          f"steps, {loop.multi_step.replays} replays of the captured bundle | loss {first:.5f} "
          f"-> {last:.5f}", flush=True)
    replay_vs_steps(loop, "fused_march_sgd", "13f")
    del loop
    collect()
    return dict(rec["trained"], err=max(r["err"] for r in rec.values()), launches=x3_launches)


def audit_phase(device) -> dict:
    """Phase 15a: tools/grad_audit.py's audit on the card, each arm of
    AUDIT_ARMS against the f32 plain core on the same two ray batches and
    parameters: its groups printed, pass_2x_floor required, the arm's
    kernels launched once a fused gradient. Returns {(mode, arm): report}."""
    import torch
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.tools import grad_audit as GA
    batches = [GA.ray_batch(AUDIT_RAYS, s) for s in GA.BATCH_SEEDS]
    params = GA.init_params(GA.audit_config(), device)
    reports = {}
    for mode, arm in AUDIT_ARMS:
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = GA.audit(params, GA.audit_config(mode), batches, {arm: "on"})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        want = {k + PP.SUFFIX[mode]: 2 for k in AUDIT_KERNELS[arm]}
        w = rep["worst_leaf"]
        print(f"[15a] grad audit {arm}=on {mode}, {rep['n_rays']} rays x "
              f"{rep['samples_per_ray']} samples, 2 batches: groups "
              f"{json.dumps(rep['groups'])} | worst leaf {w['name']} rel {w['rel_err']} "
              f"err_batch_cos {w['err_batch_cos']} systematic {w['systematic_err_ratio']} | "
              f"pass_2x_floor {rep['pass_2x_floor']} | launches {counts} | {secs:.1f} s",
              flush=True)
        check(counts == want, f"[15a] {arm} {mode}: launches {counts}, want {want}")
        check(rep["pass_2x_floor"], f"[15a] {arm} {mode}: a group's systematic error is above "
                                    f"twice the oracle's cross-batch floor: {rep['groups']}")
        reports[(mode, arm)] = rep
    sdf = {m: reports[(m, "fused_march")]["groups"]["sdf"] for m in ("f32stash", "bf16", "f32")}
    print("[15a] SDF group, fused_march: max_systematic_err_ratio / max_rel_err / "
          "max_err_batch_cos " + ", ".join(
              f"{m} {g['max_systematic_err_ratio']:.6f} / {g['max_rel_err']:.6f} / "
              f"{g['max_err_batch_cos']:.4f}" for m, g in sdf.items())
          + f" | the oracle's floor (max_xla_cross_batch_rel) "
            f"{sdf['f32']['max_xla_cross_batch_rel']:.6f}", flush=True)
    return reports


def gate_phase(device) -> dict:
    """Phase 15b: tools/quality_gate.py on the card, each arm of QG_ARMS in
    turn in this process (in a temporary directory: its exp/): the sphere
    through the fused kernels must pass at JAX's thresholds; the plain
    core's arm and the blob are printed with their verdicts. Returns
    {(scene, fused): verdict}."""
    import torch
    from color_neus_torch.tools import quality_gate as QG
    from color_neus_torch.utils.config import get_config
    out = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        for scene, fused in QG_ARMS:
            cfg = QG.arm_config(get_config(QG.CONFIGS[scene]), QG_STEPS, fused)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop = QG.train(cfg, fused or "auto", device)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = launch_counts(loop)
            verdict = QG.judge(loop, QG_RES, scene, fused)
            judge_s = time.perf_counter() - t0 - train_s
            # steady state after the gate: two replays of the captured bundle
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loop.run(QG_STEPS + 2 * BUNDLE)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t1) * 1e3 / (2 * BUNDLE)
            print(f"[15b] quality gate {scene} QG_FUSED={fused!r} ({verdict['fused']}): "
                  f"{json.dumps(verdict)}", flush=True)
            n_viz = (QG_STEPS - 1) // cfg["TRAIN"]["VIZ_MESH_INTERVAL"]
            print(f"[15b]   {QG_STEPS} steps in {train_s:.1f} s wall ({train_s * 1e3 / QG_STEPS:.2f} "
                  f"ms/step incl. the warm-up bundle, the capture and {n_viz} validation "
                  f"images + res-{EVAL_RES} meshes), verdict {judge_s:.1f} s, steady "
                  f"{step_ms:.2f} ms/step | training launches "
                  f"{ {k: v for k, v in counts.items() if v} }", flush=True)
            march = (counts["ray_march_save"], counts["ray_march_bwd_load"])
            check(march == ((QG_STEPS,) * 2 if fused == "on" else (0, 0)),
                  f"[15b] {scene} {fused!r}: the march's save / load launched {march} times")
            check(counts["sdf_rays"] >= SWEEPS_PER_STEP * QG_STEPS,
                  f"[15b] {scene} {fused!r}: {counts['sdf_rays']} sweeps")
            check("n_verts" in verdict and verdict["n_verts"] > 0
                  and all(verdict[k] == verdict[k] for k in ("psnr", "ssim", "radial_err_mean")),
                  f"[15b] {scene} {fused!r}: no mesh or a non-finite metric: {verdict}")
            out[(scene, fused)] = dict(verdict, train_s=train_s, step_ms=step_ms)
            del loop
            collect()
    check(out[("sphere", "on")]["pass"],
          f"[15b] the sphere through the fused kernels fails JAX's gate: "
          f"{out[('sphere', 'on')]}")
    return out


def dtu_blob_phase() -> dict:
    """Phase 15c: tools/dtu_blob_e2e.py (the train and evaluate CLIs in
    child processes, on the card), then eval_views over every view of its
    checkpoint and mesh_compare of its mesh against the analytic surface's
    vertices: finite values, a non-empty mesh, DBE_VIEWS views."""
    import math
    import numpy as np
    from color_neus_torch.ops.mesh import write_ply
    from color_neus_torch.tools import dtu_blob_e2e as DBE
    from color_neus_torch.tools import eval_views as EV
    from color_neus_torch.tools import mesh_compare as MC
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rep, files = DBE.run(DBE_STEPS, DBE_RES, tmp)
        run_s = time.perf_counter() - t0
        print(f"[15c] dtu_blob_e2e ({run_s:.1f} s: write, train {DBE_STEPS} steps and evaluate "
              f"-rr {DBE_RES} as child processes, metrics): {json.dumps(rep)}", flush=True)
        check(rep["n_imgs"] == DBE_VIEWS and rep["mesh_n_verts"] > 0
              and all(math.isfinite(rep[k]) for k in ("psnr_view0", "mesh_mean_abs_sdf",
                                                      "chamfer_vs_analytic")),
              f"[15c] dtu_blob_e2e: {rep}")
        t0 = time.perf_counter()
        views = EV.main(["--cfg", files["cfg"], "--reload", files["checkpoint"]])
        ev_s = time.perf_counter() - t0
        check(views["n_views"] == DBE_VIEWS and all(
            math.isfinite(v["psnr"]) and math.isfinite(v["ssim"]) for v in views["views"]),
            f"[15c] eval_views: {views}")
        gt_ply = os.path.join(tmp, "analytic_surface.ply")
        write_ply(gt_ply, DBE.gt_surface_points(), np.zeros((0, 3), np.int32))
        t0 = time.perf_counter()
        chamfer = MC.main([files["mesh"], gt_ply])
        mc_s = time.perf_counter() - t0
        check(math.isfinite(chamfer), f"[15c] mesh_compare: {chamfer}")
    print(f"[15c] eval_views: {views['n_views']} views, PSNR {views['psnr_mean']} dB / SSIM "
          f"{views['ssim_mean']} mean ({ev_s:.1f} s) | mesh_compare against the analytic "
          f"surface: {chamfer:.6e} ({mc_s:.1f} s)", flush=True)
    return dict(rep, run_s=run_s, views=views, chamfer_mc=chamfer)


def evidence_phase(device) -> dict:
    """Phase 15: the evidence tools on the card (audit_phase, gate_phase,
    dtu_blob_phase)."""
    collect()
    t0 = time.perf_counter()
    audit = audit_phase(device)
    t_a = time.perf_counter() - t0
    gate = gate_phase(device)
    t_b = time.perf_counter() - t0 - t_a
    dbe = dtu_blob_phase()
    t_c = time.perf_counter() - t0 - t_a - t_b
    return {"audit": audit, "gate": gate, "dbe": dbe, "secs": (t_a, t_b, t_c)}


def jax_keys_missing(tool: str, rep: dict) -> list:
    """The keys of JAX_TOOL_KEYS[tool] that the report lacks (nested ones
    as 'entry.key')."""
    top, nested, keys = JAX_TOOL_KEYS[tool]
    miss = [k for k in top if k not in rep]
    if nested == "res":       # one entry a resolution
        entries = {k: v for k, v in rep.items() if k.startswith("res") and k != "res"}
    elif nested == "checks":  # one entry
        entries = {"checks": rep.get("checks", {})}
    elif nested is not None:
        v = rep.get(nested, {})
        entries = v if isinstance(v, dict) else dict(enumerate(v))
    else:
        entries = {}
    if nested is not None and not entries:
        miss.append(f"{nested} (no entry)")
    return miss + [f"{e}.{k}" for e, v in entries.items() for k in keys if k not in v]


def last_json(text: str):
    """The last JSON object in a tool's output (one line, or indented)."""
    dec = json.JSONDecoder()
    for i in sorted((m.start() for m in re.finditer(r"^\{", text, re.M)), reverse=True):
        try:
            return dec.raw_decode(text[i:])[0]
        except json.JSONDecodeError:
            continue
    raise SmokeFailure(f"no JSON object in the tool's output: {text[-2000:]}")


def run_tool(name: str, knobs=None) -> tuple:
    """Run color_neus_torch.tools.<name>'s main in this process with its
    INSTRUMENTS knobs (updated by `knobs`) in the environment: (the JSON it
    printed, seconds); the report's JAX keys checked."""
    import importlib
    import io
    mod = importlib.import_module(f"color_neus_torch.tools.{name}")
    env = {**INSTRUMENTS[name], **(knobs or {})}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main([])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t0
    rep = last_json(buf.getvalue())
    miss = jax_keys_missing(name, rep)
    check(not miss, f"[16] {name} printed no {miss} of JAX's keys")
    return rep, secs


def instruments_phase(bundles) -> dict:
    """Phase 16: the JAX round's step and extraction instruments on the card
    (INSTRUMENTS), their JSON reports printed compactly and gated."""
    out, secs = {}, {}
    for name in INSTRUMENTS:
        collect()
        out[name], secs[name] = run_tool(name)
        print(f"[16] {name} ({secs[name]:.1f} s): {json.dumps(out[name])[:3000]}", flush=True)
    for mode in ABLATE_MODES[1:]:
        collect()
        key = f"march_ablate_{mode}"
        out[key], secs[key] = run_tool("march_ablate", {"ABL_PREC": mode})
        print(f"[16] {key} ({secs[key]:.1f} s): {json.dumps(out[key])[:3000]}", flush=True)
    ab, tr = out["bench_ab"], out["trace_profile"]
    efc = out["eval_fused_check"]
    check(efc["pass"], f"[16] eval_fused_check failed: {efc['checks']}")
    for abl in [out["march_ablate"]] + [out[f"march_ablate_{m}"] for m in ABLATE_MODES[1:]]:
        full, prod = abl["bwd_full_ms"], abl["production_load_ms"]
        print(f"[16a] march_ablate {abl['prec']}, row 4's load entry at {abl['n_rays']} x "
              f"{abl['n_samples']}: production {prod:.3f} ms, full {full:.3f} ms "
              f"({full / prod - 1:+.4f}; limit {RTOL_ABLATE_FULL:g}) | less than full: "
              + ", ".join(f"{v} {d:+.3f} ms" for v, d in abl["minus_full_ms"].items())
              + f" | forward save {abl['fwd_save_ms']:.3f}, recompute "
              f"{abl['fwd_nosave_ms']:.3f}, save without the compositing scan "
              f"{abl['fwd_no_composite_ms']:.3f} ms", flush=True)
        check(abs(full / prod - 1) <= RTOL_ABLATE_FULL,
              f"[16] march_ablate {abl['prec']}'s full build {full:.3f} ms against the "
              f"production entry's {prod:.3f} ms: beyond {RTOL_ABLATE_FULL:g}")
    top = sum(o["ms"] for o in tr["top_ops_ms_per_step"])
    print(f"[16b] trace_profile, {tr['n_steps']} steps in captured bundles: device "
          f"{tr['total_device_ms_per_step']:.3f} ms/step, busy {tr['busy_ms_per_step']:.3f}, "
          f"span {tr['span_ms_per_step']:.3f}, idle share {tr['idle_share']:.4f}, top "
          f"{len(tr['top_ops_ms_per_step'])} kernels {top:.3f} ms/step", flush=True)
    check(top <= tr["busy_ms_per_step"] * (1 + 1e-6) + 1e-3,
          f"[16] the trace's top kernels sum to {top:.4f} ms/step, above its busy "
          f"{tr['busy_ms_per_step']:.4f}")
    for arm, key in (("A", "fused_march_bench"), ("B", "fused_march_recompute_bench")):
        ms = sorted(ab[f"{arm}_ms_per_step"])[len(ab[f"{arm}_ms_per_step"]) // 2]
        ref = sum(bundles[key]["c"]) / 2
        print(f"[16c] bench_ab {ab[arm]}: {ms:.2f} ms/step (median of {ab['rounds']} calls of "
              f"{ab['k_steps']} steps) against phase 11(c)'s captured {ref:.2f} "
              f"({ms / ref - 1:+.4f}; limit {RTOL_AB_PHASE11:g}) | B / A "
              f"{ab['B_over_A_median']} (IQR {ab['B_over_A_iqr']})", flush=True)
        check(abs(ms / ref - 1) <= RTOL_AB_PHASE11,
              f"[16] bench_ab's {ab[arm]} arm {ms:.2f} ms/step against phase 11(c)'s "
              f"{ref:.2f}: beyond {RTOL_AB_PHASE11:g}")
    return {"reports": out, "secs": secs}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: needs a CUDA card",
              file=sys.stderr)
        return 2
    from color_neus_torch import pin_precision
    from color_neus_torch.models.configs import SDFConfig
    from color_neus_torch.models.fields import init_sdf
    from color_neus_torch.ops.kernels import build
    from color_neus_torch.ops.kernels.sdf_rays import (
        launch_sdf_rays, make_fused_sdf_rays_fn, sdf_rays_plain)
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils import native
    from color_neus_torch.utils.config import config_from_dict

    pin_precision()
    clock = PhaseClock()
    device = torch.device("cuda")
    card = card_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 1: build every kernel, all at once, and the host marcher ----
    # point_pipeline.cu holds rows 5 and 6, ray_march.cu rows 3 and 4,
    # mlp_chain.cu rows 7 and 8
    # and each MARCH_BWD_PRECISION mode's rows 3-6 (build.VARIANTS), in one
    # nvcc batch; phase 16's march_ablate variants in its two modes
    # (ABLATE_MODES' build.ablation_names), none of them a library the main
    # path loads, build in a second batch beside phases 1-15, whose host
    # work leaves most cores idle, and phase 16 waits for it
    kernels = ("sdf_rays", "point_pipeline", "ray_march", "mlp_chain", *build.VARIANTS)
    ablations = tuple(n for m in ABLATE_MODES for n in build.ablation_names(m).values())
    t0 = time.perf_counter()
    gxx_err = []
    gxx = threading.Thread(target=lambda: _call_into(gxx_err, native.load))
    gxx.start()
    libs = build.build(kernels)
    abl_err = []
    abl_build = threading.Thread(target=lambda: _call_into(abl_err,
                                                           lambda: build.build(ablations)))
    abl_build.start()
    gxx.join()
    check(not gxx_err, f"g++ build of csrc/marching_tet.cpp failed: {gxx_err}")
    print(f"[1] built {', '.join(kernels)} (nvcc) and marching_tet (g++) in "
          f"{time.perf_counter() - t0:.1f} s; building {', '.join(ablations)} beside the "
          f"phases before 16", flush=True)
    for k in kernels:
        fn = ""
        for line in build.build_log(k).splitlines():
            if "Function properties for" in line:
                fn = kernel_name(line.rsplit(" ", 1)[-1])
            elif "registers" in line or "spill" in line:
                print(f"[1] ptxas {k} {fn}: {line.strip()}")
    check(cuobjdump_path() is not None, "no cuobjdump to read the kernels' SASS")
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sass = {}
    for mode in PP.MODES:   # each MARCH_BWD_PRECISION mode's library
        sfx = PP.SUFFIX[mode]
        sass.update(pipeline_sass_check(PP.library_name("point_pipeline", mode),
                                        libs[PP.library_name("point_pipeline", mode)], {
            f"point_pipeline_fwd_kernel{sfx}": PP._max_blocks(PP._library(mode), device, mode,
                                                              "fwd") // sms}))
        sass.update(pipeline_sass_check(PP.library_name("ray_march", mode),
                                        libs[PP.library_name("ray_march", mode)], {
            f"{name}{sfx}": RM._max_blocks(RM._library(mode), device, mode, "fwd", save) // sms
            for name, save in (("ray_march_fwd_kernel", False),
                               ("ray_march_save_fwd_kernel", True))}))
    mode_sass_summary(sass)
    sass_identity_check(libs)
    sweep_sass_check(libs["sdf_rays"])
    chain_sass_check(libs["mlp_chain"])
    clock.done("1")

    # ---- phase 2: kernel vs plain on the card, off geometric init ----
    g = torch.Generator(device=device).manual_seed(SEED)
    sdf_cfg = SDFConfig()
    sdf_params = off_geometric_init(init_sdf(sdf_cfg, g, device), g)
    cases = [(act, dt, 1024, 64) for act in ("softplus", "relu")
             for dt in ("bfloat16", "float32")]
    cases += [("softplus", "bfloat16", 1024, 16), ("softplus", "bfloat16", 1000, 37)]
    for i, (act, dt, R, S) in enumerate(cases):
        fn = make_fused_sdf_rays_fn(sdf_params, sdf_cfg, dtype=dt, act=act)
        o, d, z = sweep_inputs(R, S, device, SEED + 1 + i)
        with torch.no_grad():
            before = launch_sdf_rays.launches
            got = fn(o, d, z)
            torch.cuda.synchronize()
            check(launch_sdf_rays.launches == before + 1,
                  f"sweep {act}/{dt}: the sweep function did not launch the kernel")
            want = sdf_rays_plain(fn.weights, o, d, z)
        check(got.shape == (R, S) and bool(torch.isfinite(got).all()),
              f"sweep {act}/{dt} R={R} S={S}: bad output {tuple(got.shape)}")
        err = float((got - want).abs().max())
        with torch.no_grad():
            ms = cuda_ms(lambda: fn(o, d, z))
            plain_ms = cuda_ms(lambda: sdf_rays_plain(fn.weights, o, d, z))
        bound, _, what = sweep_bound_ms(fn.weights, R, S)
        print(f"[2] sdf_rays {act:8s} {dt:8s} R={R} S={S}: |out| max {float(want.abs().max()):.3f} | "
              f"max|kernel-plain| {err:.3e} (atol {ATOL[dt]:g}) | kernel {ms:.4f} ms | "
              f"plain {plain_ms:.4f} ms | bound {bound:.4f} ms ({what})", flush=True)
        check(err <= ATOL[dt], f"sweep {act}/{dt} R={R} S={S}: max error {err:.3e} "
                               f"above {ATOL[dt]:g}")

    clock.done("2")

    # ---- phase 2b: the evaluation path's kernels vs plain, off geometric init ----
    eval_kernels = eval_kernels_vs_plain(device)
    clock.done("2b")

    # ---- phase 2c: the point-pipeline backward vs plain, off geometric init ----
    bwd = pipeline_bwd_vs_plain(device)
    clock.done("2c")

    # ---- phase 2d: the fused march vs plain, off geometric init ----
    mar = march_vs_plain(device)
    clock.done("2d")

    # ---- phase 3: the main path ----
    cfg = config_from_dict(SMOKE_CFG)
    loop = TrainLoop(cfg, device=device)
    check(loop.k_steps == BUNDLE, f"the loop bundles {loop.k_steps} steps, want {BUNDLE}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(loop)
    t0 = time.perf_counter()
    losses = loop.run(STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_training = launch_counts(loop)
    launches = launches_training["sdf_rays"]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[3] {STEPS} steps in bundles of {loop.k_steps} ({loop.multi_step.replays} "
          f"replays of the captured bundle): {wall * 1e3 / STEPS:.2f} ms/step incl. the "
          f"warm-up bundle and the capture | loss {first:.5f} -> {last:.5f} | sweep launches "
          f"{launches} | peak memory {peak_gb:.2f} GiB", flush=True)
    check(launches == SWEEPS_PER_STEP * STEPS,
          f"sweep kernel launched {launches} times, want {SWEEPS_PER_STEP * STEPS}")
    check(all(x == x and abs(x) != float("inf") for x in losses), f"non-finite loss {losses}")
    check(last < 0.5 * first, f"loss did not halve: first-5 mean {first}, last-5 mean {last}")

    # steady state, after the checked run
    n_rays = loop.tcfg.n_rays
    n_spp = loop.tcfg.renderer.n_samples + loop.tcfg.renderer.n_importance
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(STEPS + 20)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 20
    print(f"[3] steady state (2 replays): {step_ms:.2f} ms/step | "
          f"{n_rays / step_ms * 1e3:.0f} rays/s (fwd+bwd, {n_rays} rays x {n_spp} samples)",
          flush=True)

    clock.done("3")

    # ---- phase 4: kernel vs plain on the trained weights, main-path rays and z ----
    dt, sweeps = main_path_sweeps(loop, SEED + 100)
    check(len(sweeps) == SWEEPS_PER_STEP,
          f"one step's hierarchy ran {len(sweeps)} sweeps, want {SWEEPS_PER_STEP}")
    for sw in sweeps:
        atol = ATOL_MAIN_PATH if dt == "bfloat16" else ATOL[dt]
        print(f"[4] main-path sweep R={sw['R']} S={sw['S']} {dt}: max|kernel-plain| "
              f"{sw['err']:.3e} (atol {atol:g}) | kernel {sw['ms']:.4f} ms "
              f"(relu variant {sw['relu_ms']:.4f} ms) | plain {sw['plain_ms']:.4f} ms | "
              f"bound {sw['bound_ms']:.4f} ms ({sw['bound_what']})", flush=True)
        check(sw["err"] <= atol, f"main-path sweep S={sw['S']}: max error "
                                 f"{sw['err']:.3e} above {atol:g}")
    step_sweep = {k: sum(sw[k] for sw in sweeps) for k in ("ms", "plain_ms", "bound_ms")}
    print(f"[4] one step's {len(sweeps)} sweeps: kernel {step_sweep['ms']:.4f} ms | "
          f"plain {step_sweep['plain_ms']:.4f} ms | bound {step_sweep['bound_ms']:.4f} ms",
          flush=True)

    clock.done("4")

    # ---- phase 5: where the step's time goes ----
    profile_steps(loop)
    clock.done("5")

    # ---- phase 6: the evaluation path on the trained weights ----
    ev = evaluation_path(loop, device, launches_training)
    clock.done("6")

    # ---- phase 7: training through the point-pipeline kernels ----
    on = training_through(device, loop, SEED + 110, "FUSED_CORE", {
        "sdf_rays": SWEEPS_PER_STEP * STEPS, "sdf_points": 0, "point_pipeline": STEPS,
        "point_pipeline_bwd": STEPS, "ray_march": 0, "ray_march_bwd": 0, "ray_march_save": 0,
        "ray_march_bwd_load": 0, "mlp_chain": 0, "mlp_chain_deferred": 0}, "7")
    print(f"[7] steady state: fused_core auto {step_ms:.2f} ms/step, on {on['step_ms']:.2f} "
          f"ms/step", flush=True)

    clock.done("7")

    # ---- phase 8: training through the fused march kernels (MARCH_ACTS auto:
    # the save mode at this shape), then its recompute beside it ----
    del on["loop"]
    march = training_through(device, loop, SEED + 130, "FUSED_MARCH", {
        "sdf_rays": SWEEPS_PER_STEP * STEPS, "sdf_points": 0, "point_pipeline": 0,
        "point_pipeline_bwd": 0, "ray_march": 0, "ray_march_bwd": 0, "ray_march_save": STEPS,
        "ray_march_bwd_load": STEPS, "mlp_chain": 0, "mlp_chain_deferred": 0}, "8", profile_n=1,
        beside={"fused_core": "on"})
    modes = march_modes(device, march.pop("loop"))
    print(f"[8] steady state: auto {step_ms:.2f} ms/step, fused_core on {on['step_ms']:.2f} "
          f"ms/step, fused_march on {march['step_ms']:.2f} ms/step (save; recompute "
          f"{sum(modes['ms']['recompute']) / 2:.2f} against save "
          f"{sum(modes['ms']['save']) / 2:.2f} interleaved)", flush=True)

    clock.done("8")

    # ---- phase 9: the MLP-chain microbenchmark (rows 7 + 8) ----
    chain = chain_phase(device)
    clock.done("9")

    # ---- phase 10: the dataset path: DTU replica, train / stop / resume, extract ----
    data = dataset_path(device, march["step_ms"])
    print(f"[10] summary: DTU replica write {data['write_s']:.2f} s, load_all "
          f"{data['load_s']:.2f} s ({data['own_s']:.2f} s through the port's PNG decoder) | "
          f"{data['step_ms']:.2f} ms/step (phase 8: "
          f"{march['step_ms']:.2f}) | peak memory {data['peak_gb']:.2f} GiB | res-{EVAL_RES} "
          f"extraction {data['extract_s']:.2f} s | IHO camera leaves vs the f32 core: worst "
          f"{data['iho_cam_err']:.3e}", flush=True)

    clock.done("10")

    # ---- phase 11: several steps per dispatch, a captured bundle per arm ----
    t0 = time.perf_counter()
    bundles = bundle_phase(device, data)
    print(f"[11] summary ({time.perf_counter() - t0:.1f} s): host ms/step uncaptured -> "
          f"captured, config shape: " + ", ".join(
              f"{k} {sum(r['u']) / 2:.2f} -> {sum(r['c']) / 2:.2f}" for k, r in bundles.items()
              if "c" in r),
          flush=True)

    clock.done("11")

    # ---- phase 12: MARCH_BWD_PRECISION bf16 and f32 ----
    t0 = time.perf_counter()
    prec = precision_phase(device, loop, {"eval": eval_kernels["point_pipeline_color_neus"],
                                          "bwd": bwd["color_neus"], "march": mar})
    print(f"[12] summary ({time.perf_counter() - t0:.1f} s): " + "; ".join(
        f"{m}: " + ", ".join(f"{p} {r['step_ms']:.2f} ms/step (worst leaf {r['grad_err']:.3e}, "
                             f"SDF {r['sdf_leaves'][m]:.3e} vs f32stash's "
                             f"{r['sdf_leaves']['f32stash']:.3e})"
                             for p, r in prec[m]["train"].items()) for m in PREC_MODES),
        flush=True)

    clock.done("12")

    # ---- phase 13: row 2's f32x3 arm, RAY_CHUNK, COMPUTE_DTYPE, N_OUTSIDE, SGD, glb ----
    t0 = time.perf_counter()
    x3 = slice16_phase(device, loop, bundles, step_ms)
    print(f"[13] summary ({time.perf_counter() - t0:.1f} s): sdf_points f32x3 {x3['ms']:.4f} ms "
          f"per 2^18 points (bound {x3['bound_ms']:.4f}, plain {x3['plain_ms']:.4f}), "
          f"{x3['launches']} launches in the res-{EVAL_RES} extraction", flush=True)

    clock.done("13")

    # ---- phase 14: data-parallel training, in child processes ----
    dp = dp_phase()
    print(f"[14] summary: (a) {dp['a_s']:.1f} s, (b) {dp['b_s']:.1f} s | launches on the "
          f"data-parallel path (the gloo ranks' and the NCCL rank's {STEPS} steps) "
          f"{dp['counts']}", flush=True)

    clock.done("14")

    # ---- phase 15: the evidence tools ----
    ev15 = evidence_phase(device)
    a15, g15, d15 = ev15["audit"], ev15["gate"], ev15["dbe"]
    print(f"[15] summary ({' / '.join(f'{t:.1f}' for t in ev15['secs'])} s): audit "
          f"pass_2x_floor in {sum(r['pass_2x_floor'] for r in a15.values())} of {len(a15)} "
          f"arms, SDF systematic ratio f32stash "
          f"{a15[('f32stash', 'fused_march')]['groups']['sdf']['max_systematic_err_ratio']} / "
          f"f32 {a15[('f32', 'fused_march')]['groups']['sdf']['max_systematic_err_ratio']} | "
          + ", ".join(f"{sc} {fu or 'auto'} {v['psnr']} dB / {v['radial_err_mean']} "
                      f"(pass {v['pass']})" for (sc, fu), v in g15.items())
          + f" | DTU blob {d15['psnr_view0']} dB, chamfer {d15['chamfer_vs_analytic']}",
          flush=True)
    clock.done("15")

    # ---- phase 16: the step and extraction instruments ----
    t0 = time.perf_counter()
    abl_build.join()
    check(not abl_err, f"nvcc build of phase 16's march_ablate variants failed: {abl_err}")
    print(f"[16] the march_ablate builds done ({time.perf_counter() - t0:.1f} s waited)",
          flush=True)
    ins = instruments_phase(bundles)
    print(f"[16] summary: " + ", ".join(f"{k} {v:.1f} s" for k, v in ins["secs"].items()),
          flush=True)
    clock.done("16")
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in clock.secs.items()})
          + f" | script {time.perf_counter() - clock.t0:.1f} s", flush=True)

    # the kernel line. sdf_rays: one step's sweeps (every launch of a
    # step), phase 4, launches from the training run; sdf_points and
    # point_pipeline: phase 2b at the evaluation path's shapes (one f32
    # grid chunk, one Color-NeuS validation chunk), launches from phase 6's
    # evaluation run, errors the largest of phases 2b and 6;
    # point_pipeline_bwd: phase 2c at the training core's shape (131,072
    # points, Color-NeuS), launches from phase 7's training run; ray_march
    # and ray_march_bwd (the recompute pair) and ray_march_save and
    # ray_march_bwd_load (the save mode's): phase 2d at the main path's
    # shape (1024 rays x 128 samples, Color-NeuS, the init's inv_s), errors
    # the largest of its cases (forward vs the bf16 twin in float64,
    # backward vs float64), launches from phase 8's recompute run and its
    # training run (the save mode); mlp_chain and mlp_chain_deferred: phase 9
    # at the tool's main shape (1,048,576 x 256 x 25; mlp_chain the softplus
    # variant in bf16), launches from the tool's sweep. The rows 3-6
    # entries of MARCH_BWD_PRECISION bf16 and f32 (suffixes _bf16s, _f32s):
    # phase 12a at the f32stash entries' shapes, launches from phase 12b's
    # training run of the path that runs them. sdf_points_f32x3: phase 13a
    # on the trained weights (errors the largest of both weight sets),
    # launches from phase 13b's f32x3 extraction
    grid, pipe = eval_kernels["sdf_points_f32"], eval_kernels["point_pipeline_color_neus"]
    kernel_line = [{
        "name": "sdf_rays", "route": "cuda", "source": "color_neus_torch/csrc/sdf_rays.cu",
        "replaces": "color_neus_tpu/ops/pallas/sdf_mlp.py:203", "launches": launches,
        "max_abs_err": max(sw["err"] for sw in sweeps), "ms": step_sweep["ms"],
        "plain_ms": step_sweep["plain_ms"], "bound_ms": step_sweep["bound_ms"],
        "bound_by": sweeps[0]["bound_by"], "library_ms": None,
    }, {
        "name": "sdf_points", "route": "cuda", "source": "color_neus_torch/csrc/sdf_rays.cu",
        "replaces": "color_neus_tpu/ops/pallas/sdf_mlp.py:183",
        "launches": ev["launches_eval"]["sdf_points"],
        "max_abs_err": max(grid["err"], ev["grid_err"]), "ms": grid["ms"],
        "plain_ms": grid["plain_ms"], "bound_ms": grid["bound_ms"], "bound_by": grid["bound_by"],
        "library_ms": None,
    }, {
        "name": "point_pipeline", "route": "cuda",
        "source": "color_neus_torch/csrc/point_pipeline.cu",
        "replaces": "color_neus_tpu/ops/pallas/point_pipeline.py:677",
        "launches": ev["launches_eval"]["point_pipeline"],
        "max_abs_err": max(pipe["err"], eval_kernels["point_pipeline_neus"]["err"],
                           ev["colour_err"]),
        "ms": pipe["ms"], "plain_ms": pipe["plain_ms"], "bound_ms": pipe["bound_ms"],
        "bound_by": pipe["bound_by"], "library_ms": None,
    }, {
        "name": "point_pipeline_bwd", "route": "cuda",
        "source": "color_neus_torch/csrc/point_pipeline.cu",
        "replaces": "color_neus_tpu/ops/pallas/point_pipeline.py:767",
        "launches": on["counts"]["point_pipeline_bwd"],
        "max_abs_err": max(bwd["color_neus"]["err"], bwd["neus"]["err"]),
        "ms": bwd["color_neus"]["ms"], "plain_ms": bwd["color_neus"]["plain_ms"],
        "bound_ms": bwd["color_neus"]["bound_ms"], "bound_by": bwd["color_neus"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "ray_march", "route": "cuda", "source": "color_neus_torch/csrc/ray_march.cu",
        "replaces": "color_neus_tpu/ops/pallas/ray_march.py:185",
        "launches": modes["counts"]["ray_march"], "max_abs_err": mar["fwd_err"],
        "ms": mar["ms"], "plain_ms": mar["plain_ms"], "bound_ms": mar["bound_ms"],
        "bound_by": mar["bound_by"], "library_ms": None,
    }, {
        "name": "ray_march_bwd", "route": "cuda", "source": "color_neus_torch/csrc/ray_march.cu",
        "replaces": "color_neus_tpu/ops/pallas/ray_march.py:249",
        "launches": modes["counts"]["ray_march_bwd"], "max_abs_err": mar["bwd_err"],
        "ms": mar["bwd_ms"], "plain_ms": mar["plain_bwd_ms"], "bound_ms": mar["bwd_bound_ms"],
        "bound_by": mar["bwd_bound_by"], "library_ms": None,
    }, {
        "name": "ray_march_save", "route": "cuda", "source": "color_neus_torch/csrc/ray_march.cu",
        "replaces": "color_neus_tpu/ops/pallas/ray_march.py:185",
        "launches": march["counts"]["ray_march_save"], "max_abs_err": mar["save_err"],
        "ms": mar["save_ms"], "plain_ms": mar["save_plain_ms"], "bound_ms": mar["save_bound_ms"],
        "bound_by": mar["save_bound_by"], "library_ms": None,
    }, {
        "name": "ray_march_bwd_load", "route": "cuda",
        "source": "color_neus_torch/csrc/ray_march.cu",
        "replaces": "color_neus_tpu/ops/pallas/ray_march.py:249",
        "launches": march["counts"]["ray_march_bwd_load"], "max_abs_err": mar["load_err"],
        "ms": mar["load_ms"], "plain_ms": mar["load_plain_ms"],
        "bound_ms": mar["load_bound_ms"], "bound_by": mar["load_bound_by"], "library_ms": None,
    }, {
        "name": "sdf_points_f32x3", "route": "cuda", "source": "color_neus_torch/csrc/sdf_rays.cu",
        "replaces": "color_neus_tpu/ops/pallas/sdf_mlp.py:183", "launches": x3["launches"],
        "max_abs_err": x3["err"], "ms": x3["ms"], "plain_ms": x3["plain_ms"],
        "bound_ms": x3["bound_ms"], "bound_by": x3["bound_by"], "library_ms": None,
    }] + [{
        "name": name, "route": "cuda", "source": "color_neus_torch/csrc/mlp_chain.cu",
        "replaces": f"tools/mlp_microbench.py:{line}", "launches": chain["launches"][name],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
    } for name, line, r in (("mlp_chain", 121, chain["records"]["softplus"]),
                            ("mlp_chain_f32", 121, chain["records"]["none-f32"]),
                            ("mlp_chain_deferred", 103, chain["records"]["deferred"]))]
    for mode in PREC_MODES:
        sfx, p_ = PP.SUFFIX[mode], prec[mode]
        ev_, bw_, mr_, tr_ = p_["eval"], p_["bwd"], p_["march"], p_["train"]
        for name, src, line, path, r in (
                ("point_pipeline", "point_pipeline", "point_pipeline.py:677", "fused_core",
                 (ev_["err"], ev_["ms"], ev_["plain_ms"], ev_["bound_ms"], ev_["bound_by"])),
                ("point_pipeline_bwd", "point_pipeline", "point_pipeline.py:767", "fused_core",
                 (bw_["err"], bw_["ms"], bw_["plain_ms"], bw_["bound_ms"], bw_["bound_by"])),
                ("ray_march", "ray_march", "ray_march.py:185", "fused_march_recompute",
                 (mr_["fwd_err"], mr_["ms"], mr_["plain_ms"], mr_["bound_ms"], mr_["bound_by"])),
                ("ray_march_bwd", "ray_march", "ray_march.py:249", "fused_march_recompute",
                 (mr_["bwd_err"], mr_["bwd_ms"], mr_["plain_bwd_ms"], mr_["bwd_bound_ms"],
                  mr_["bwd_bound_by"])),
                ("ray_march_save", "ray_march", "ray_march.py:185", "fused_march",
                 (mr_["save_err"], mr_["save_ms"], mr_["save_plain_ms"], mr_["save_bound_ms"],
                  mr_["save_bound_by"])),
                ("ray_march_bwd_load", "ray_march", "ray_march.py:249", "fused_march",
                 (mr_["load_err"], mr_["load_ms"], mr_["load_plain_ms"], mr_["load_bound_ms"],
                  mr_["load_bound_by"]))):
            kernel_line.append({
                "name": name + sfx, "route": "cuda", "source": f"color_neus_torch/csrc/{src}.cu",
                "replaces": f"color_neus_tpu/ops/pallas/{line}",
                "launches": tr_[path]["counts"][name + sfx], "max_abs_err": r[0], "ms": r[1],
                "plain_ms": r[2], "bound_ms": r[3], "bound_by": r[4], "library_ms": None})
    print(json.dumps({"kernels": kernel_line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)

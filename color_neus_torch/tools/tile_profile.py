"""Where a tile's time goes, by phase, on the card: a copy of this checkout
whose kernels add clock64() deltas of their phases into a __device__ array
(thread 0 of every block), launched once.

    python -m color_neus_torch.tools.tile_profile DIR          # row 5's forward tile
    python -m color_neus_torch.tools.tile_profile DIR --load   # row 4's load entry
    python -m color_neus_torch.tools.tile_profile DIR --save   # row 3's save entry

on the card, from a checkout's root. DIR (a directory git ignores, e.g.
tree_check/prof) receives the copy and is emptied first.

The forward (PATCHES): forward_tile in the forward kernel of row 5 on its
training shape (131,072 points, Color-NeuS, off geometric init); per phase
(the SDF layers, the last layer, the reverse sweep, colour, relight: the
work before each product, the product, its pass; the closing step; inside
the products the A loads with their barrier, the chunks, the closing
barrier), the cycles per block and the share of the tile loop, then the
kernel's ms with CUDA events.

The load entry (LOAD_PATCHES): march_bwd<true> of csrc/ray_march.cu (the
save mode's backward, ray_march_load_bwd_kernel) in the MARCH_BWD_PRECISION
mode PROF_PREC (default f32stash), at 1024 rays x 128 and x 512 samples
(Color-NeuS, geometric init, inv_s 64, march_ablate's rays); per phase of
the kernel (the group's compositing VJP, the stash's read into the tile,
the cotangents' fill, backward_tile, the ray sums, the weight-grad flush),
inside backward_tile per section (relight, colour, tangent stream, last
layer, the value / tangent reverse, the PE pullback) with its products,
operand stores and the reverse's gate passes, inside its products the A
loads, the chunks with thread 0's waits on the weight ring, the closing
barrier, and inside the flush its waits and the issue of its reductions
into the partial (the adds themselves run in L2, unseen); the cycles per
block and the share of the kernel, then its ms.

The save entry (SAVE_PATCHES): march_fwd<true> of csrc/ray_march.cu
(ray_march_save_fwd_kernel) in mode PROF_PREC at the load entry's shapes
and inputs; per phase of the kernel (per tile the point load,
forward_tile and the compositing, composite_tile, with its parts: the
per-point work with the outs stash's write, the two scans, the stash
tail's write, the out write), inside forward_tile its steps as row 5's
(each step's work before its product, the product, its pass: the SDF
passes write the gates and the stash's softplus, the reverse sweep's read
the gates back) and its products' parts; the cycles per block and the
share of the kernel, then its ms.

The timers cost what they read (a clock read and an atomic per phase and
block), and thread 0's reading of a phase without a barrier at its end is
thread 0's own share of it.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the counters and the macro every patch uses, ahead of the header's namespace
HEADER = ("csrc/point_pipeline_tile.cuh", "namespace {\n\nusing mlp::EMB;",
          "__device__ unsigned long long g_prof[64];\n"
          "#define PROF_ADD(i, c0) atomicAdd(&g_prof[i], (unsigned long long)(clock64() - (c0)))\n"
          "namespace {\n\nusing mlp::EMB;")
# the library's reader and reset (appended to `src`'s C interface after `anchor`)


def _reader(src: str, anchor: str) -> tuple:
    return (src, anchor, anchor + "\n\n"
            'extern "C" int prof_read(unsigned long long* host) {\n'
            "  return int(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));\n}\n\n"
            'extern "C" int prof_reset() {\n  unsigned long long z[64] = {0};\n'
            "  return int(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));\n}")


# (file, anchor, replacement): each anchor must occur once
PATCHES = [
    ("csrc/point_pipeline_tile.cuh", "  for (int i = 0; i <= n_steps; ++i) {\n",
     "  const int PROF = ROWS == 2 * TILE && tid == 0;\n"
     "  for (int i = 0; i <= n_steps; ++i) {\n    const long long c_0 = clock64();\n"),
    ("csrc/point_pipeline_tile.cuh", "    if (kind == END) break;\n",
     "    if (kind == END) {\n      if (PROF) atomicAdd(&g_prof[15], "
     "(unsigned long long)(clock64() - c_0));\n      break;\n    }\n"),
    ("csrc/point_pipeline_tile.cuh",
     "    if (f32_step)\n      layer_product<ROWS, true>(st, X, A, image(p, slot), K, kind == REV, "
     "hp_stage_of(sv));\n    else layer_product<ROWS>(st, X, A, image(p, slot), K, "
     "PREC != PREC_F32 && kind == REV);\n",
     "    const long long c_1 = clock64();\n"
     "    if (f32_step)\n      layer_product<ROWS, true>(st, X, A, image(p, slot), K, kind == REV, "
     "hp_stage_of(sv));\n    else layer_product<ROWS>(st, X, A, image(p, slot), K, "
     "PREC != PREC_F32 && kind == REV);\n"
     "    const long long c_2 = clock64();\n"),
    ("csrc/point_pipeline_tile.cuh", "    }\n  }\n\n  // relit from gc",
     "    }\n    if (PROF) {\n"
     "      atomicAdd(&g_prof[3 * kind], (unsigned long long)(c_1 - c_0));\n"
     "      atomicAdd(&g_prof[3 * kind + 1], (unsigned long long)(c_2 - c_1));\n"
     "      atomicAdd(&g_prof[3 * kind + 2], (unsigned long long)(clock64() - c_2));\n"
     "    }\n  }\n\n  // relit from gc"),
    ("csrc/point_pipeline_tile.cuh", "  const float* A = DUAL && wg ? A1 : A0;\n  unsigned a[KS][4];",
     "  const long long w_0 = clock64();\n"
     "  const float* A = DUAL && wg ? A1 : A0;\n  unsigned a[KS][4];"),
    ("csrc/point_pipeline_tile.cuh", "  const bool second = DUAL && wg;",
     "  const long long w_1 = clock64();\n  const bool second = DUAL && wg;"),
    ("csrc/point_pipeline_tile.cuh", "  st.ws += N_ST;\n  __syncthreads();\n}",
     "  st.ws += N_ST;\n  const long long w_2 = clock64();\n  __syncthreads();\n"
     "  if (STAGES == FWD_STAGES && tid == 0) {\n"
     "    atomicAdd(&g_prof[16], (unsigned long long)(w_1 - w_0));\n"
     "    atomicAdd(&g_prof[17], (unsigned long long)(w_2 - w_1));\n"
     "    atomicAdd(&g_prof[18], (unsigned long long)(clock64() - w_2));\n  }\n}"),
    ("csrc/point_pipeline.cu",
     "    load_points<FWD_ROWS>(p, t, base);\n"
     "    forward_tile<FWD_ROWS, false, false, PP_PREC>(p, t, st, gates, feat, none);",
     "    const long long k_0 = clock64();\n    load_points<FWD_ROWS>(p, t, base);\n"
     "    forward_tile<FWD_ROWS, false, false, PP_PREC>(p, t, st, gates, feat, none);\n"
     "    if (tid == 0) atomicAdd(&g_prof[19], (unsigned long long)(clock64() - k_0));"),
    _reader("csrc/point_pipeline.cu", 'extern "C" int point_pipeline_n_off() { return N_OFF; }'),
]

# row 4's load entry, march_bwd<true> (PROF: thread 0 of a block of the load
# entry; PROF_B: thread 0 in backward_tile, which only the load entry runs in
# the profile)
TP, RMC = "csrc/point_pipeline_tile.cuh", "csrc/ray_march.cu"
LOAD_PATCHES = [
    # the kernel: its total, the group's compositing VJP, the stash's read,
    # the cotangents' fill, backward_tile, the ray sums, the flush
    (RMC, "  int slot = 0;   // the tile's place in the weight-grad batch\n",
     "  int slot = 0;   // the tile's place in the weight-grad batch\n"
     "  const bool PROF = LOAD && tid == 0;\n  const long long c_k = clock64();\n"),
    (RMC, "    if constexpr (LOAD) {   // 3 pullback_only: the cotangents as the scratch holds them\n",
     "    const long long c_g = clock64();\n"
     "    if constexpr (LOAD) {   // 3 pullback_only: the cotangents as the scratch holds them\n"),
    (RMC, "    for (int t0 = 0; t0 < n_pts; t0 += TILE) {\n      const Save sv = bwd_save(p, s, slot);\n",
     "    if (PROF) PROF_ADD(20, c_g);\n"
     "    for (int t0 = 0; t0 < n_pts; t0 += TILE) {\n      const Save sv = bwd_save(p, s, slot);\n"),
    (RMC, "          load_tile<PP_PREC>(m, t, sv, ts, r0 * m.S + t0);\n",
     "        {\n          const long long c_l = clock64();\n"
     "          load_tile<PP_PREC>(m, t, sv, ts, r0 * m.S + t0);\n"
     "          if (PROF) PROF_ADD(21, c_l);\n        }\n"),
    (RMC, "      for (int e = tid; e < TILE * 16; e += THREADS) {\n        const int q = t0 + e / 16, c = e % 16;\n",
     "      const long long c_c = clock64();\n"
     "      for (int e = tid; e < TILE * 16; e += THREADS) {\n        const int q = t0 + e / 16, c = e % 16;\n"),
    (RMC, "      __syncthreads();\n      if constexpr (RM_ABLATE != 1)   // 1 no_pullback\n"
          "        backward_tile<PP_PREC, LOAD>(p, t, st, s.gates, s.zt, sv, P, ts);\n",
     "      __syncthreads();\n      if (PROF) PROF_ADD(22, c_c);\n"
     "      if constexpr (RM_ABLATE != 1) {  // 1 no_pullback\n"
     "        const long long c_b = clock64();\n"
     "        backward_tile<PP_PREC, LOAD>(p, t, st, s.gates, s.zt, sv, P, ts);\n"
     "        if (PROF) PROF_ADD(23, c_b);\n      }\n"),
    (RMC, "      // the tile's share of each ray's cotangents, summed in sample order\n",
     "      const long long c_r = clock64();\n"
     "      // the tile's share of each ray's cotangents, summed in sample order\n"),
    (RMC, "      if constexpr (RM_ABLATE != 1 && RM_ABLATE != 4)   // the flush: not in 1, 4\n"
          "        slot = after_tile<PP_PREC, LOAD>(p, st, s, slot,\n"
          "                                   grp + gridDim.x >= n_groups(m) && t0 + TILE >= n_pts, P,\n"
          "                                   m.crs, n0);\n",
     "      if (PROF) PROF_ADD(24, c_r);\n"
     "      if constexpr (RM_ABLATE != 1 && RM_ABLATE != 4) {  // the flush: not in 1, 4\n"
     "        const long long c_f = clock64();\n"
     "        slot = after_tile<PP_PREC, LOAD>(p, st, s, slot,\n"
     "                                   grp + gridDim.x >= n_groups(m) && t0 + TILE >= n_pts, P,\n"
     "                                   m.crs, n0);\n"
     "        if (PROF) PROF_ADD(25, c_f);\n      }\n"),
    (RMC, "    __syncthreads();\n  }\n}\n\n__global__ void __launch_bounds__(THREADS, 1) "
          "PP_NAME(ray_march_bwd_kernel)",
     "    __syncthreads();\n  }\n  if (PROF) PROF_ADD(26, c_k);\n}\n\n"
     "__global__ void __launch_bounds__(THREADS, 1) PP_NAME(ray_march_bwd_kernel)"),
    # the stash's read, by part: the SDF layers, the colour / relight
    # layers' inputs the stash's cr images lack (the small inputs, gc)
    (RMC, "  float* const PE = X + HID;\n  if (tid < TILE) {\n    const bool in = tid < ts.n;\n",
     "  float* const PE = X + HID;\n  long long c_lt = clock64();\n"
     "  if (tid < TILE) {\n    const bool in = tid < ts.n;\n"),
    (RMC, "  // the colour and relight layers' hidden inputs: the flush bulk-copies\n",
     "  if (tid == 0) PROF_ADD(44, c_lt);\n  c_lt = clock64();\n"
     "  // the colour and relight layers' hidden inputs: the flush bulk-copies\n"),
    (RMC, "    save_t<0>(X + HID, EMB, dw_a(sh, sv.dw, p.n_sdf + p.n_color - 1 + p.y_in, 0) + HID * 128);\n"
          "  }\n  __syncthreads();\n}\n",
     "    save_t<0>(X + HID, EMB, dw_a(sh, sv.dw, p.n_sdf + p.n_color - 1 + p.y_in, 0) + HID * 128);\n"
     "  }\n  __syncthreads();\n  if (tid == 0) PROF_ADD(45, c_lt);\n}\n"),
    # backward_tile's sections
    (TP, "                                              const TileStash& ts = TileStash{}) {\n"
         "  const int tid = threadIdx.x;\n",
     "                                              const TileStash& ts = TileStash{}) {\n"
     "  const int tid = threadIdx.x;\n  const bool PROF_B = tid == 0;\n  long long c_s = clock64();\n"),
    (TP, "  // ---- the colour net ----\n",
     "  if (PROF_B) PROF_ADD(31, c_s);\n  c_s = clock64();\n  // ---- the colour net ----\n"),
    (TP, "  // ---- SDF tangent stream along grad_hat",
     "  if (PROF_B) PROF_ADD(32, c_s);\n  c_s = clock64();\n  // ---- SDF tangent stream along grad_hat"),
    (TP, "  // ---- the last SDF layer: ybar",
     "  if (PROF_B) PROF_ADD(33, c_s);\n  c_s = clock64();\n  // ---- the last SDF layer: ybar"),
    (TP, "  // ---- value and tangent reversed together ----\n",
     "  if (PROF_B) PROF_ADD(34, c_s);\n  c_s = clock64();\n"
     "  // ---- value and tangent reversed together ----\n"),
    (TP, "  // ---- PE pullback, first and second derivative ----\n",
     "  if (PROF_B) PROF_ADD(35, c_s);\n  c_s = clock64();\n"
     "  // ---- PE pullback, first and second derivative ----\n"),
    (TP, "  __syncthreads();\n}\n\n// The backward's shared memory",
     "  __syncthreads();\n  if (PROF_B) PROF_ADD(36, c_s);\n}\n\n// The backward's shared memory"),
    # the value / tangent reverse's gate pass
    (TP, "    const float* z = zt + l * GSLAB;\n    __syncthreads();\n",
     "    const float* z = zt + l * GSLAB;\n    __syncthreads();\n    const long long c_gp = clock64();\n"),
    (TP, "        t.Y[r * LDX + c] = gg * ub;\n      }\n    }\n    __syncthreads();\n",
     "        t.Y[r * LDX + c] = gg * ub;\n      }\n    }\n    __syncthreads();\n"
     "    if (PROF_B) PROF_ADD(41, c_gp);\n"),
    # the load's other stash reads: the colour / relight inputs staged in Y,
    # the tangent stream's gates
    (TP, "  const unsigned char* img = ts.cr + size_t(slot) * CR_SLOT;\n",
     "  const long long c_sp = clock64();\n"
     "  const unsigned char* img = ts.cr + size_t(slot) * CR_SLOT;\n"),
    (TP, "      dst[(e / EMB) * LDX + HID + e % EMB] = e % EMB < 3 ? t.GC[(e / EMB) * 3 + e % EMB] : 0.f;\n"
         "  __syncthreads();\n",
     "      dst[(e / EMB) * LDX + HID + e % EMB] = e % EMB < 3 ? t.GC[(e / EMB) * 3 + e % EMB] : 0.f;\n"
     "  __syncthreads();\n  if (threadIdx.x == 0) PROF_ADD(47, c_sp);\n"),
    (TP, "    if constexpr (LOAD) {\n      stash_rows<16>([&](int r, int c) { return stash_sx4<PREC>(ts, l, r, c); },\n",
     "    if constexpr (LOAD) {\n      const long long c_tg = clock64();\n"
     "      stash_rows<16>([&](int r, int c) { return stash_sx4<PREC>(ts, l, r, c); },\n"),
    (TP, "                       st4(y, pre_skip ? make_float4(v.x * s, v.y * s, v.z * s, v.w * s) : v);\n"
         "                     });\n      __syncthreads();\n",
     "                       st4(y, pre_skip ? make_float4(v.x * s, v.y * s, v.z * s, v.w * s) : v);\n"
     "                     });\n      __syncthreads();\n      if (PROF_B) PROF_ADD(48, c_tg);\n"),
    # backward_tile's products (reverse_product, forward_product)
    (TP, "float* hs = nullptr) {\n  if constexpr (HP) {\n    hp_product<HID / 16, DUAL>",
     "float* hs = nullptr) {\n  const long long c_p = clock64();\n"
     "  if constexpr (HP) {\n    hp_product<HID / 16, DUAL>"),
    (TP, "    else wg_product<HID / 16, HID + EMB, DUAL>(st, A0, A1, img, put0, put1);\n  }\n}\n",
     "    else wg_product<HID / 16, HID + EMB, DUAL>(st, A0, A1, img, put0, put1);\n  }\n"
     "  if (threadIdx.x == 0) PROF_ADD(37, c_p);\n}\n"),
    (TP, "                                                float* hs = nullptr) {\n  if constexpr (HP) {\n"
         "    if (K == EMB) hp_product<EMB / 16, false>",
     "                                                float* hs = nullptr) {\n"
     "  const long long c_p = clock64();\n  if constexpr (HP) {\n"
     "    if (K == EMB) hp_product<EMB / 16, false>"),
    (TP, "    else wg_product<(HID + EMB) / 16, HID, false>(st, A, A, img, put, put);\n  }\n}\n",
     "    else wg_product<(HID + EMB) / 16, HID, false>(st, A, A, img, put, put);\n  }\n"
     "  if (threadIdx.x == 0) PROF_ADD(38, c_p);\n}\n"),
    # inside the backward's products (the WSTAGES ring): A loads + barrier,
    # chunks, closing barrier; thread 0's waits on the ring
    (TP, "  const float* A = DUAL && wg ? A1 : A0;\n  unsigned a[KS][4];",
     "  const long long w_0 = clock64();\n  const float* A = DUAL && wg ? A1 : A0;\n  unsigned a[KS][4];"),
    (TP, "  const bool second = DUAL && wg;",
     "  const long long w_1 = clock64();\n  const bool second = DUAL && wg;"),
    (TP, "  st.ws += N_ST;\n  __syncthreads();\n}",
     "  st.ws += N_ST;\n  const long long w_2 = clock64();\n  __syncthreads();\n"
     "  if (STAGES == WSTAGES && tid == 0) {\n"
     "    atomicAdd(&g_prof[27], (unsigned long long)(w_1 - w_0));\n"
     "    atomicAdd(&g_prof[28], (unsigned long long)(w_2 - w_1));\n    PROF_ADD(29, w_2);\n  }\n}"),
    (TP, "    const unsigned char* stage = ring_acquire<STAGES>(st.w, s, SPS * WSLAB);\n",
     "    const long long w_a = clock64();\n"
     "    const unsigned char* stage = ring_acquire<STAGES>(st.w, s, SPS * WSLAB);\n"
     "    if (STAGES == WSTAGES && tid == 0) PROF_ADD(30, w_a);\n"),
    # the flush: thread 0's waits on its ring, the reductions into the partial
    (TP, "\n          const unsigned char* stage = ring_acquire<DW_STAGES>(st.d, s, DW_STAGE);\n",
     "\n          const long long f_a = clock64();\n"
     "          const unsigned char* stage = ring_acquire<DW_STAGES>(st.d, s, DW_STAGE);\n"
     "          if (tid == 0) PROF_ADD(42, f_a);\n"),
    (TP, "        bulk_rows(P + p.off[blk.slot] + size_t(k0) * HID, acc, st.w.buf, blk.K - k0, d0 == 0);\n",
     "        const long long f_w = clock64();\n"
     "        bulk_rows(P + p.off[blk.slot] + size_t(k0) * HID, acc, st.w.buf, blk.K - k0, d0 == 0);\n"
     "        if (tid == 0) PROF_ADD(43, f_w);\n"),
    # save_t: the operand stores in backward_tile, thread 0's share (the load's are in 44-46)
    (TP, "      save_t<0>(t.X, HID, dw_b(sh, sv.dw, bi_rel + l, 0));\n",
     "      const long long c_w = clock64();\n"
     "      save_t<0>(t.X, HID, dw_b(sh, sv.dw, bi_rel + l, 0));\n      if (PROF_B) PROF_ADD(39, c_w);\n"),
    (TP, "      save_t<0>(t.X, HID, dw_b(sh, sv.dw, bi_col + l, 0));\n",
     "      const long long c_w = clock64();\n"
     "      save_t<0>(t.X, HID, dw_b(sh, sv.dw, bi_col + l, 0));\n      if (PROF_B) PROF_ADD(39, c_w);\n"),
    (TP, "      save_t<0>(t.Y, K, dw_a(sh, sv.dw, l, l == 0 ? 2 : 1));\n"
         "      if (l == 0) save_t<1>(t.Y, K, dw_a(sh, sv.dw, 0, 3));\n",
     "      const long long c_w = clock64();\n"
     "      save_t<0>(t.Y, K, dw_a(sh, sv.dw, l, l == 0 ? 2 : 1));\n"
     "      if (l == 0) save_t<1>(t.Y, K, dw_a(sh, sv.dw, 0, 3));\n      if (PROF_B) PROF_ADD(39, c_w);\n"),
    (TP, "      save_t<0>(t.X, HID, dw_b(sh, sv.dw, L1, 0));\n",
     "    {\n      const long long c_w = clock64();\n"
     "      save_t<0>(t.X, HID, dw_b(sh, sv.dw, L1, 0));\n      if (PROF_B) PROF_ADD(39, c_w);\n    }\n"),
    (TP, "      save_t<0>(t.X, HID, dw_b(sh, sv.dw, l, 0));\n      save_t<0>(t.Y, HID, dw_b(sh, sv.dw, l, 1));\n",
     "      const long long c_w = clock64();\n"
     "      save_t<0>(t.X, HID, dw_b(sh, sv.dw, l, 0));\n      save_t<0>(t.Y, HID, dw_b(sh, sv.dw, l, 1));\n"
     "      if (PROF_B) PROF_ADD(39, c_w);\n"),
    _reader(RMC, 'extern "C" int ray_march_n_off() { return N_OFF; }'),
]

# row 3's save entry, march_fwd<true> (PROF: thread 0 of a block of the
# save entry; PROF_C the same in composite_tile): per tile the point load,
# forward_tile (its steps, products and passes: PATCHES' tile timers,
# counters 0-18) and composite_tile (the per-point compositing with the
# outs stash's write, T's product scan, the stash tail's write, the sums'
# scan, the out write with the carries); the kernel's total
SAVE_PATCHES = [p for p in PATCHES if p[0] == TP] + [
    (RMC, "  const float inv_s = *m.inv_s;\n\n"
          "  for (long long grp = blockIdx.x; grp < n_groups(m); grp += gridDim.x) {\n",
     "  const float inv_s = *m.inv_s;\n  const bool PROF = SAVE && threadIdx.x == 0;\n"
     "  const long long c_k = clock64();\n\n"
     "  for (long long grp = blockIdx.x; grp < n_groups(m); grp += gridDim.x) {\n"),
    (RMC, "      load_march_points<FWD_ROWS>(m, t, r0, t0, n_pts);\n",
     "      long long c_t = clock64();\n      load_march_points<FWD_ROWS>(m, t, r0, t0, n_pts);\n"
     "      if (PROF) PROF_ADD(50, c_t);\n      c_t = clock64();\n"),
    (RMC, "      forward_tile<FWD_ROWS, false, SAVE, PP_PREC>(p, t, st, gates, feat, none, ex);\n",
     "      forward_tile<FWD_ROWS, false, SAVE, PP_PREC>(p, t, st, gates, feat, none, ex);\n"
     "      if (PROF) PROF_ADD(51, c_t);\n      c_t = clock64();\n"),
    (RMC, "      composite_tile<SAVE>(m, t, r0, t0, n_pts, inv_s, ex, al.tail, cT, acc);\n"
          "    }\n  }\n  if (SAVE && threadIdx.x == 0) mlp::bulk_store_wait();",
     "      composite_tile<SAVE>(m, t, r0, t0, n_pts, inv_s, ex, al.tail, cT, acc);\n"
     "      if (PROF) PROF_ADD(54, c_t);\n    }\n  }\n"
     "  if (SAVE && threadIdx.x == 0) mlp::bulk_store_wait();\n  if (PROF) PROF_ADD(56, c_k);"),
    (RMC, "  const int i = threadIdx.x, q = t0 + i;\n",
     "  const bool PROF_C = SAVE && threadIdx.x == 0;\n  long long c_x = clock64();\n"
     "  const int i = threadIdx.x, q = t0 + i;\n"),
    (RMC, "  float T = 1.f;\n  if (RM_ABLATE != 3) {\n",
     "  if (PROF_C) PROF_ADD(52, c_x);\n  c_x = clock64();\n"
     "  float T = 1.f;\n  if (RM_ABLATE != 3) {\n"),
    (RMC, "  if (SAVE && in) {\n    const float* gc = t.GC + 3 * i;\n",
     "  if (PROF_C) PROF_ADD(57, c_x);\n  c_x = clock64();\n"
     "  if (SAVE && in) {\n    const float* gc = t.GC + 3 * i;\n"),
    (RMC, "  if (RM_ABLATE != 3) {\n    if (in) {\n      const float w = alpha * T;\n",
     "  if (PROF_C) PROF_ADD(53, c_x);\n  c_x = clock64();\n"
     "  if (RM_ABLATE != 3) {\n    if (in) {\n      const float w = alpha * T;\n"),
    (RMC, "    if (in && s == m.S - 1) {   // the ray's last sample: its lanes\n",
     "    if (PROF_C) PROF_ADD(58, c_x);\n    c_x = clock64();\n"
     "    if (in && s == m.S - 1) {   // the ray's last sample: its lanes\n"),
    (RMC, "    for (int k = 0; k < 7; ++k) acc[k] = sv[k * FWD_ROWS + last];\n  }\n"
          "  __syncthreads();\n}\n",
     "    for (int k = 0; k < 7; ++k) acc[k] = sv[k * FWD_ROWS + last];\n  }\n"
     "  __syncthreads();\n  if (PROF_C) PROF_ADD(55, c_x);\n}\n"),
    _reader(RMC, 'extern "C" int ray_march_n_off() { return N_OFF; }'),
]

# (counter, name) of the save entry's report; 56 is the kernel's total
SAVE_NAMES = [
    (50, "tile: point load"), (51, "tile: forward_tile"),
    *[(i, "  " + n) for i, n in enumerate(
        [f"{k} {part}" for k in ("sdf", "last", "rev", "col", "rel")
         for part in ("pre", "product", "pass")] + ["end pre"])],
    (16, "  products: A loads + barrier"), (17, "  products: chunks"),
    (18, "  products: closing barrier"),
    (54, "tile: compositing (composite_tile)"),
    (52, "  per point, outs stash write (thread 0's share)"), (57, "  T's product scan"),
    (53, "  stash tail write (thread 0's share)"), (58, "  the sums' scan"),
    (55, "  out write, carries, barrier"), (56, "kernel total")]

# (counter, name) of the load entry's report; 26 is the kernel's total
LOAD_NAMES = [
    (20, "group: compositing VJP"), (21, "tile: the stash's read"),
    (44, "  read: SDF layers"), (45, "  read: colour / relight small inputs"),
    (22, "tile: cotangents' fill"),
    (23, "tile: backward_tile"), (31, "  relight net"), (32, "  colour net"),
    (33, "  tangent stream"), (34, "  last SDF layer"), (35, "  value / tangent reverse"),
    (41, "    its gate passes"), (36, "  PE pullback"),
    (47, "  stage_cr: stash rows staged (also in the read)"),
    (48, "  tangent stream's gates from the stash"),
    (37, "  products: reverse"), (38, "  products: tangent forward"),
    (27, "    A loads + barrier"), (28, "    chunks"), (30, "      ring waits (thread 0)"),
    (29, "    closing barrier"), (39, "  operand stores (thread 0's share)"),
    (24, "tile: ray sums"), (25, "tile: flush"), (42, "  flush ring waits (thread 0)"),
    (43, "  flush reductions into the partial"), (26, "kernel total")]

NAMES = [f"{k} {part}" for k in ("sdf", "last", "rev", "col", "rel")
         for part in ("pre", "product", "pass")]
NAMES += ["end pre", "products: A loads + barrier", "products: chunks",
          "products: closing barrier", "tile loop total"]


def make_copy(out: str, patches=PATCHES) -> None:
    """The instrumented copy of this checkout in `out` (HEADER and `patches`)."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "color_neus_torch"), os.path.join(out, "color_neus_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), out)
    for rel, anchor, new in [HEADER, *patches]:
        path = os.path.join(out, "color_neus_torch", rel)
        with open(path) as f:
            src = f.read()
        if src.count(anchor) != 1:
            raise RuntimeError(f"tile_profile: the anchor in {rel} moved: {anchor!r}")
        with open(path, "w") as f:
            f.write(src.replace(anchor, new))


def profile() -> int:
    """Run in the instrumented copy: one launch of row 5, the split printed."""
    import ctypes

    import torch
    import chip_smoke as cs
    from color_neus_torch import pin_precision
    from color_neus_torch.models.configs import ColorConfig, RendererConfig
    from color_neus_torch.models.neus import init_renderer
    from color_neus_torch.ops.kernels import point_pipeline as PP

    pin_precision()
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(cs.SEED + 70)
    rcfg = RendererConfig(kind="color_neus",
                          color=ColorConfig(mode="no_view_dir", d_in=6, multires_view=0))
    pw = PP.resolve_pipeline_weights(cs.off_geometric_init(init_renderer(rcfg, g, device), g),
                                     rcfg)
    R, S = cs.PIPELINE_RAYS, cs.PIPELINE_SAMPLES
    o, d, z = cs.sweep_inputs(R, S, device, cs.SEED + 80 + R)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()
    dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3).contiguous()
    lib = PP._library()
    lib.prof_read.argtypes = [ctypes.c_void_p]
    for _ in range(3):
        PP.launch_point_pipeline(pw, pts, dirs)
    torch.cuda.synchronize()
    lib.prof_reset()
    PP.launch_point_pipeline(pw, pts, dirs)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    lib.prof_read(ctypes.cast(buf, ctypes.c_void_p))
    blocks = PP._max_blocks(lib, device, "f32stash", "fwd")
    total = buf[19]
    for i, name in enumerate(NAMES):
        print(f"{name:30s} {buf[i] / blocks:12.0f} cycles per block {buf[i] / total * 100:7.2f}%")
    print(f"blocks {blocks} | kernel {cs.cuda_ms(lambda: PP.launch_point_pipeline(pw, pts, dirs)):.4f}"
          f" ms | {cs.card_line()}", flush=True)
    return 0


def profile_load() -> int:
    """Run in the instrumented copy: row 4's load entry at 1024 x 128 and
    1024 x 512 in mode PROF_PREC, one launch each after three, the split
    printed, then one JSON line of every counter's cycles per block."""
    import ctypes
    import json

    import torch
    import chip_smoke as cs
    from color_neus_torch import pin_precision
    from color_neus_torch.ops.kernels import ray_march as RM
    from color_neus_torch.tools import march_ablate as MA

    pin_precision()
    device = torch.device("cuda")
    mode = os.environ.get("PROF_PREC", "f32stash")
    lib = RM._library(mode)
    lib.prof_read.argtypes = [ctypes.c_void_p]
    blocks = RM._max_blocks(lib, device, mode, "bwd", True)
    rec = {"prec": mode, "blocks": blocks, "card": cs.card_line()}
    for S in (128, 512):
        pw, ro, rd, z, inv_s, gbar = MA.inputs(1024, device, mode=mode, n_samples=S)
        sd = 2.0 / pw.rcfg.n_samples
        _, stash, act = RM.launch_ray_march_save(pw, ro, rd, z, inv_s, sd)

        def run():
            return RM.launch_ray_march_bwd_load(pw, ro, rd, z, inv_s, sd, stash, act, gbar)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        lib.prof_reset()
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 64)()
        lib.prof_read(ctypes.cast(buf, ctypes.c_void_p))
        total = buf[26]
        ms = cs.cuda_ms(run)
        print(f"[tile_profile] load entry {mode}, 1024 x {S}: {ms:.4f} ms (instrumented) | "
              f"{blocks} blocks | {rec['card']}", flush=True)
        for i, name in LOAD_NAMES:
            print(f"{name:40s} {buf[i] / blocks:14.0f} cycles per block "
                  f"{buf[i] / total * 100:7.2f}%")
        rec[f"S{S}"] = {"ms": ms, **{name.strip(): buf[i] / blocks for i, name in LOAD_NAMES}}
    print(json.dumps(rec), flush=True)
    return 0


def profile_save() -> int:
    """Run in the instrumented copy: row 3's save entry at 1024 x 128 and
    1024 x 512 in mode PROF_PREC, one launch each after three, the split
    printed, then one JSON line of every counter's cycles per block."""
    import ctypes
    import json

    import torch
    import chip_smoke as cs
    from color_neus_torch import pin_precision
    from color_neus_torch.ops.kernels import ray_march as RM
    from color_neus_torch.tools import march_ablate as MA

    pin_precision()
    device = torch.device("cuda")
    mode = os.environ.get("PROF_PREC", "f32stash")
    lib = RM._library(mode)
    lib.prof_read.argtypes = [ctypes.c_void_p]
    blocks = RM._max_blocks(lib, device, mode, "fwd", True)
    rec = {"prec": mode, "blocks": blocks, "card": cs.card_line()}
    for S in (128, 512):
        pw, ro, rd, z, inv_s, _ = MA.inputs(1024, device, mode=mode, n_samples=S)
        sd = 2.0 / pw.rcfg.n_samples

        def run():
            return RM.launch_ray_march_save(pw, ro, rd, z, inv_s, sd)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        lib.prof_reset()
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 64)()
        lib.prof_read(ctypes.cast(buf, ctypes.c_void_p))
        total = buf[56]
        ms = cs.cuda_ms(run)
        print(f"[tile_profile] save entry {mode}, 1024 x {S}: {ms:.4f} ms (instrumented) | "
              f"{blocks} blocks | {rec['card']}", flush=True)
        for i, name in SAVE_NAMES:
            print(f"{name:44s} {buf[i] / blocks:14.0f} cycles per block "
                  f"{buf[i] / total * 100:7.2f}%")
        rec[f"S{S}"] = {"ms": ms, **{name.strip(): buf[i] / blocks for i, name in SAVE_NAMES}}
    print(json.dumps(rec), flush=True)
    return 0


# the entries: option -> (patches, the copy's run option, its profile)
ENTRIES = {None: (PATCHES, "--run", profile), "--load": (LOAD_PATCHES, "--run-load", profile_load),
           "--save": (SAVE_PATCHES, "--run-save", profile_save)}


def main() -> int:
    runs = {run: fn for _, run, fn in ENTRIES.values()}
    if len(sys.argv) == 2 and sys.argv[1] in runs:
        return runs[sys.argv[1]]()
    opt = sys.argv[2] if len(sys.argv) == 3 else None
    if len(sys.argv) not in (2, 3) or opt not in ENTRIES:
        print(__doc__, file=sys.stderr)
        return 2
    patches, run, _ = ENTRIES[opt]
    out = os.path.abspath(sys.argv[1])
    make_copy(out, patches)
    return subprocess.run([sys.executable, "-m", "color_neus_torch.tools.tile_profile", run],
                          cwd=out).returncode


if __name__ == "__main__":
    sys.exit(main())

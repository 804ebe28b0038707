// The fused ray march, forward and backward: the Hopper counterparts of the
// TPU kernels color_neus_tpu/ops/pallas/ray_march.py::_march_fwd_kernel
// (:185; body _composite_fwd :141-178) and ::_march_bwd_kernel (:249; the
// compositing VJP :322-355, _mlp_pullback :358-361, the ray cotangents
// :363-367, inv_s :369-370; custom_vjp _march_core :502).
//
// What the forward computes, per ray (origin o, direction d, S sorted z):
//   points        dist_s = z_{s+1} - z_s (the last: sample_dist), mid_s =
//                 z_s + dist_s / 2, p_s = o + d mid_s, view dir d;
//   MLP           the point pipeline of point_pipeline.cu on every p_s:
//                 sdf, grad, gc, relit, delta;
//   compositing   tc = <d, grad>, u = 0.5 - tc / 2, ic = -max(u, 0),
//                 pc / nc = sigmoid((sdf -/+ ic dist / 2) inv_s), q = (pc -
//                 nc + 1e-5) / (pc + 1e-5), alpha = clip(q, 0, 1), T_s =
//                 prod_{j<s} (1 - alpha_j + 1e-7), w = alpha T;
//   per ray       [sum w relit (3), sum w, sum of delta, sum over |p| < 1.2
//                 of (|grad| - 1)^2, the count of |p| < 1.2, 0 x 9].
// The backward takes the [R, 16] cotangents and gives the cotangents of the
// rays ([sum pts_bar, 0, sum (dirs_bar + tc_bar grad + pts_bar mid), 0]),
// of inv_s, and of every weight. Per ray, from the end: w_bar = <relit,
// c_bar> + wsum_bar, G = the sum of w_bar w over the later samples, alpha_bar
// = w_bar T - G / (1 - alpha + 1e-7), q_bar = alpha_bar times the clip's
// gate (0.5 at q == 0 and at q == 1, as jax.lax.clamp's VJP), pc_bar = q_bar
// (1 - q) / (pc + 1e-5), nc_bar = -q_bar / (pc + 1e-5), then sdf_hat, the
// strict u > 0 gate, tc_bar = -u_bar / 2 and the eikonal term of grad_hat,
// as ray_march.py:329-354; the point pipeline's pullback of those per-point
// cotangents (backward_tile) gives pts_bar and dirs_bar.
//
// Bound on the H100: the point pipeline's MACs (forward ~1.45 M per point at
// the Color-NeuS widths; backward ~4.8 M: one recompute and the pullback,
// ~3.3 M in the save mode, which loads what the recompute would compute;
// ray_march.march_macs_per_point counts them from the real widths) against
// ~36 bytes of input and output per point each way (z and the stash; the
// save mode's activation stash adds 12,832 bytes a point each way at those
// widths, its bf16 part in 64-point tile images, act_layout): bound by
// operations, bf16 tensor-core MMA at 989 TFLOP/s (the
// products are the TPU kernels' bf16 ones, point_pipeline_tile.cuh). The
// compositing is ~50 flops per point, in f32. Each MARCH_BWD_PRECISION
// mode builds this file once (PP_PREC; kernels suffixed _bf16s / _f32s,
// point_pipeline.cu's note): bf16's save stash keeps the SDF part in bf16
// (8,768 bytes a point with the outs stash, against 12,864), f32 runs the
// SDF chain's products as six bf16 passes on wgmma (hp_product).
//
// Design (built on the tile functions of rows 5 and 6,
// point_pipeline_tile.cuh, with their wgmma products). A block owns a
// group of whole rays, so a ray's samples never straddle two blocks (one
// ray when S >= 128, else max(1, 128 / S) rays, rays_per_group), cut into
// tiles: in the forward 128-point tiles (S = 128 is one tile a ray), in
// the backward 64-point tiles, the halves of the forward's (S = 128 is two
// tiles; a ray may straddle two). A padding point past the group's last
// sample gets zero input and zero cotangent.
//   Forward: per tile, the points are made from the rays and z in shared
//   memory, forward_tile<128, false> runs (its two warpgroups on 64 rows
//   each, sharing every weight slab), then composite_tile composites the
//   tile in parallel from what forward_tile left in shared memory, a
//   thread a point (JAX's _composite_fwd in vector form): sdf, grad, relit
//   and the delta sum go to a stash in device memory ([R S, 8], 32 bytes
//   a point), T before each sample is a segmented exclusive product scan
//   and the ray's sums segmented sums (seg_scan: fixed order), carried
//   from tile to tile where a ray spans several, and a ray's last sample
//   writes its 16 lanes.
//   Backward (recompute): one thread per ray rebuilds the compositing from
//   the stash, scans forward for T and back for G, and writes each point's
//   cotangents
//   (and tc_bar, mid) to the block's scratch; then per tile forward_tile<64, true>
//   recomputes the layer inputs (the one MLP pass of JAX's recompute mode:
//   the stash spares a third one) and backward_tile pulls the cotangents
//   back; the ray cotangents are summed per ray in sample order.
//   Save mode (JAX's march_acts save, its _march_fwd_kernel(save) and
//   _march_bwd_kernel(load)): the forward (ray_march_save_fwd_kernel)
//   also writes each point's row of an activation stash in device memory
//   from forward_tile's passes (point_pipeline_tile.cuh act_layout: every
//   hidden SDF layer's softplus in f32, whose gate 1 - exp(-100 sp) the
//   load rebuilds bit for bit, the features and the colour / relight relu
//   outputs in bf16, which the backward reads only as bf16 operands and
//   relu masks, and gc, delta and, from the compositing scan, T before the
//   sample; the PE and the small inputs are rebuilt from the points; the
//   colour / relight inputs as the flush's operand images of each 64-point
//   backward tile, export_cr, so that the flush bulk-copies them as they
//   are: each forward tile is two backward tiles). The
//   backward (ray_march_load_bwd_kernel) runs the compositing VJP in
//   parallel, a thread a point (composite_vjp_par: T the forward's, the
//   sum over a ray's later samples a segmented suffix sum across the
//   threads, as JAX's load mode loads its compositing scalars and scans
//   them in vector form), and per 64-point tile stages only the
//   weight-grad operands from the stash (load_tile: wide batched reads, no
//   product) where the recompute runs forward_tile; backward_tile<PREC,
//   true> reads the gates and the colour / relight layer inputs from the
//   stash where it uses them (wide reads, a batch in flight at once:
//   PERF.md §5), and its flush adds into the block's partial with TMA bulk
//   reductions (f32: red.global.add.v4.f32; nothing read back) and takes
//   the colour / relight inputs from the stash's tile images. A forward tile's
//   128 rows are two backward tiles, so the rows are the points in order
//   and any tile reads a contiguous block. The
//   block counts its tiles across groups: its weight grads are summed on
//   chip over batches of dw_batch tiles (dw_flush: wgmma on the bf16
//   operands backward_tile stores, point_pipeline.cu's note) and added,
//   with the inv_s grad, to the block's partial ([n_grad + 1]: the packed
//   gradient layout, then inv_s) once a batch, which the reduction kernel of
//   point_pipeline.cu sums over the blocks in index order: no float atomics.

#include "point_pipeline_tile.cuh"

namespace {

constexpr int STASH = 8;   // per point: sdf, grad (3), relit (3), delta sum
constexpr int CTW = 16;    // per point in the backward's scratch: gbar lanes, tc_bar (13), mid (14)
constexpr int TAIL_T = 6;  // save mode: the activation stash's tail slot of T before the sample
static_assert(TAIL_T == 6, "composite_tile writes T as the tail's seventh float");

struct March {
  Params net;              // the networks; net.scratch: per-block scratch
  const float* rays_o;     // [R, 3]
  const float* rays_d;     // [R, 3]
  const float* z;          // [R, S]
  const float* inv_s;      // [1] on the device
  long long n_rays;
  int S;
  int G;                   // rays per group: max(1, FWD_ROWS / S), rays_per_group
  int tpg;                 // 64-point backward tiles a full group
  float sample_dist;
  float* out;              // forward: [R, 16]
  float* stash;            // [R S, STASH]: written by the forward, read by the backward
  unsigned char* act;      // save mode: the activation stash (act_layout): [R S] rows, then
                           // the cr images of n_groups x tpg tiles from act_cr_offset (crs)
  CrSrc crs;
  // backward only
  const float* gbar;       // [R, 16]
  float* rays_hat;         // [R, 8]
  float* partial;          // [gridDim.x][partial_stride(n_grad)], zeroed (the load entry's:
                           // any values, zero_outside_flush)
  long long n_grad;
  long long scratch_floats;   // per block
};

// Sample s of ray r: its section length, mid z and point, the point in the
// plain version's rounding (o + d mid, no fused multiply-add).
__device__ __forceinline__ void sample_point(const March& m, long long r, int s, float* pt,
                                             float* dist, float* mid) {
  const float* zr = m.z + r * m.S;
  const float zs = zr[s];
  *dist = s + 1 < m.S ? zr[s + 1] - zs : m.sample_dist;
  *mid = zs + *dist * 0.5f;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    pt[j] = __fadd_rn(m.rays_o[3 * r + j], __fmul_rn(m.rays_d[3 * r + j], *mid));
}

// t.P3 / t.D3 = the points and view dirs of the group's points t0 .. t0 +
// ROWS (n_pts of them in the group; zeros past it), then a barrier.
template <int ROWS>
__device__ __forceinline__ void load_march_points(const March& m, const Tile& t, long long r0,
                                                  int t0, int n_pts) {
  const int tid = threadIdx.x;
  if (tid < ROWS) {
    const int q = t0 + tid;
    float pt[3] = {0.f, 0.f, 0.f}, dir[3] = {0.f, 0.f, 0.f};
    if (q < n_pts) {
      const long long r = r0 + q / m.S;
      float dist, mid;
      sample_point(m, r, q % m.S, pt, &dist, &mid);
#pragma unroll
      for (int j = 0; j < 3; ++j) dir[j] = m.rays_d[3 * r + j];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      t.P3[tid * 3 + j] = pt[j];
      t.D3[tid * 3 + j] = dir[j];
    }
  }
  __syncthreads();
}

// The compositing quantities of one point (ray_march.py:158-173).
struct Comp {
  float tc, u, ep, en, pc, nc, q, alpha, xv, normg, relaxed;
};

__device__ __forceinline__ Comp composite_point(const float* rd, const float* grad, float sdf,
                                                float dist, float inv_s, const float* pt) {
  Comp c;
  c.tc = rd[0] * grad[0] + rd[1] * grad[1] + rd[2] * grad[2];
  c.u = -c.tc * 0.5f + 0.5f;
  const float ic = -fmaxf(c.u, 0.f);
  c.ep = sdf - ic * dist * 0.5f;
  c.en = sdf + ic * dist * 0.5f;
  c.pc = sigmoidf_(c.ep * inv_s);
  c.nc = sigmoidf_(c.en * inv_s);
  c.q = (c.pc - c.nc + 1e-5f) / (c.pc + 1e-5f);
  c.alpha = fminf(fmaxf(c.q, 0.f), 1.f);
  c.xv = 1.f - c.alpha + 1e-7f;
  c.normg = sqrtf(grad[0] * grad[0] + grad[1] * grad[1] + grad[2] * grad[2]);
  c.relaxed = sqrtf(pt[0] * pt[0] + pt[1] * pt[1] + pt[2] * pt[2]) < 1.2f ? 1.f : 0.f;
  return c;
}

__device__ __forceinline__ long long n_groups(const March& m) {
  return (m.n_rays + m.G - 1) / m.G;
}

// The save mode's cr images of 64-point tile t0 / TILE of group grp.
__device__ __forceinline__ unsigned char* act_cr(const March& m, long long grp, int t0) {
  return m.crs.base + (grp * m.tpg + t0 / TILE) * m.crs.bytes;
}

// m.act = act, the save mode's stash (null: the recompute's), and where its
// cr images are (m.crs).
__host__ __device__ inline void set_act(March& m, void* act) {
  const ActLayout al = act_layout(shape_of(m.net), PP_PREC);
  m.act = static_cast<unsigned char*>(act);
  m.crs = CrSrc{act ? m.act + act_cr_offset(m.n_rays * m.S, al) : nullptr,
                (long long)al.n_cr * CR_SLOT, m.tpg};
}

// ------------------------------------------------------------------------
// Forward
// ------------------------------------------------------------------------

// A block-wide segmented inclusive scan over a forward tile's FWD_ROWS
// points, thread order being point order (the threads past FWD_ROWS only
// meet the barriers): thread i's v combined (MUL: multiplied, else added)
// lane by lane with the v of every earlier thread back to the first j <= i
// with `head` set (its ray's first sample), and with `carry` (the ray's
// value from its earlier tiles) when there is no such j in the tile.
// Hillis-Steele over the threads in shared memory (sv: NV x FWD_ROWS
// floats, sf: FWD_ROWS ints), so the order of the operations is fixed. On
// return sv[k * FWD_ROWS + i] holds lane k of thread i's result for every
// thread to read; the caller meets a barrier before sv is written again.
template <int NV, bool MUL>
__device__ __forceinline__ void seg_scan(float (&v)[NV], bool head, const float (&carry)[NV],
                                         float* sv, int* sf) {
  const int tid = threadIdx.x;
  const bool mine = tid < FWD_ROWS;
  int f = head;
  for (int d = 1; d < FWD_ROWS; d <<= 1) {
    if (mine) {
#pragma unroll
      for (int k = 0; k < NV; ++k) sv[k * FWD_ROWS + tid] = v[k];
      sf[tid] = f;
    }
    __syncthreads();
    if (mine && !f && tid >= d) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
        v[k] = MUL ? sv[k * FWD_ROWS + tid - d] * v[k] : sv[k * FWD_ROWS + tid - d] + v[k];
      f = sf[tid - d];
    }
    __syncthreads();
  }
  if (mine) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!f) v[k] = MUL ? carry[k] * v[k] : carry[k] + v[k];
      sv[k * FWD_ROWS + tid] = v[k];
    }
  }
  __syncthreads();
}

// The compositing of the forward tile t0 of a group (ray_march.py:154-178,
// JAX's _composite_fwd), in parallel, from the tile's outputs forward_tile
// left in shared memory: a thread a point. Each point writes its row of the
// outs stash; T before the sample is a segmented exclusive product scan of
// 1 - alpha + 1e-7 over its ray's earlier samples (JAX's
// _seg_excl_cumprod), the ray's seven sums segmented inclusive sums (JAX's
// _seg_sum), both in a fixed order (seg_scan, in X, which the tile no
// longer needs), and the ray's last sample writes its 16 lanes of out. A
// ray that spans several tiles (S > FWD_ROWS) carries its T and sums from
// tile to tile in cT / acc. SAVE also writes each point's stash tail (gc,
// delta, T: act_layout) in one pass. A barrier after.
template <bool SAVE>
__device__ __forceinline__ void composite_tile(const March& m, const Tile& t, long long r0, int t0,
                                               int n_pts, float inv_s, const Export& ex, int tail,
                                               float& cT, float (&acc)[7]) {
  const int i = threadIdx.x, q = t0 + i;
  const bool in = i < FWD_ROWS && q < n_pts;
  const int s = in ? q % m.S : 0;
  const long long r = r0 + (in ? q / m.S : 0);
  const bool head = !in || s == 0;
  const int last = min(FWD_ROWS, n_pts - t0) - 1;   // the tile's last point
  float* sv = t.X;
  int* sf = reinterpret_cast<int*>(t.X + 7 * FWD_ROWS);
  float xv[1] = {1.f}, alpha = 0.f, v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (in) {
    const float* g = t.G3 + 3 * i;
    const float* dl = t.DL + 3 * i;
    v[4] = dl[0] + dl[1] + dl[2];
    float* o = m.stash + (r0 * m.S + q) * STASH;
    st4(o, make_float4(t.S1[i], g[0], g[1], g[2]));
    st4(o + 4, make_float4(t.RL[3 * i], t.RL[3 * i + 1], t.RL[3 * i + 2], v[4]));
    if (RM_ABLATE != 3) {   // 3 pullback_only: no compositing
      const float* zr = m.z + r * m.S;
      const float dist = s + 1 < m.S ? zr[s + 1] - zr[s] : m.sample_dist;
      const Comp c = composite_point(t.D3 + 3 * i, g, t.S1[i], dist, inv_s, t.P3 + 3 * i);
      xv[0] = c.xv;
      alpha = c.alpha;
      v[5] = c.relaxed * ((c.normg - 1.f) * (c.normg - 1.f));
      v[6] = c.relaxed;
    }
  }
  float T = 1.f;
  if (RM_ABLATE != 3) {
    const float carry_t[1] = {cT};
    seg_scan<1, true>(xv, head, carry_t, sv, sf);
    if (in) T = head ? 1.f : (i > 0 ? sv[i - 1] : cT);
    cT = sv[last];
    __syncthreads();
  }
  if (SAVE && in) {
    const float* gc = t.GC + 3 * i;
    const float* dl = t.DL + 3 * i;
    float* tl = reinterpret_cast<float*>(ex.row0 + size_t(i) * ex.bytes + tail);
    st4(tl, make_float4(gc[0], gc[1], gc[2], dl[0]));
    st4(tl + 4, make_float4(dl[1], dl[2], T, 0.f));   // T in slot TAIL_T
  }
  if (RM_ABLATE != 3) {
    if (in) {
      const float w = alpha * T;
#pragma unroll
      for (int j = 0; j < 3; ++j) v[j] = w * t.RL[3 * i + j];
      v[3] = w;
    }
    seg_scan<7, false>(v, head, acc, sv, sf);
    if (in && s == m.S - 1) {   // the ray's last sample: its lanes
      float* o = m.out + r * 16;
      st4(o, make_float4(v[0], v[1], v[2], v[3]));
      st4(o + 4, make_float4(v[4], v[5], v[6], 0.f));
      st4(o + 8, make_float4(0.f, 0.f, 0.f, 0.f));
      st4(o + 12, make_float4(0.f, 0.f, 0.f, 0.f));
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) acc[k] = sv[k * FWD_ROWS + last];
  }
  __syncthreads();
}

// The forward; SAVE (the save mode) also writes every point's row of the
// activation stash m.act: forward_tile's passes the layer outputs, then
// composite_tile gc, delta and T into the row's tail. In PREC_F32STASH and
// PREC_F32 the save entry's reverse sweep rebuilds the SDF gates from the
// stash's f32 softplus (forward_tile's SG), so its scratch holds the
// features alone (march_fwd_scratch_floats).
template <bool SAVE>
__device__ __forceinline__ void march_fwd(const March& m) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile t;
  Rings st;
  carve_fwd(t, st, smem);
  const Params& p = m.net;
  float* gates = p.scratch + size_t(blockIdx.x) * m.scratch_floats;  // [n_sdf - 1][128][HID]
  float* feat = SAVE && PP_PREC != PREC_BF16 ? gates                 // [128][HID]
                                             : gates + size_t(p.n_sdf - 1) * FWD_ROWS * HID;
  const Save none = fwd_save(feat);
  const ActLayout al = act_layout(shape_of(p), PP_PREC);
  const float inv_s = *m.inv_s;

  for (long long grp = blockIdx.x; grp < n_groups(m); grp += gridDim.x) {
    const long long r0 = grp * m.G;
    const int nr = int(min((long long)m.G, m.n_rays - r0));
    const int n_pts = nr * m.S;
    float cT = 1.f, acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // a ray's carry
    for (int t0 = 0; t0 < n_pts; t0 += FWD_ROWS) {
      load_march_points<FWD_ROWS>(m, t, r0, t0, n_pts);
      const Export ex{SAVE ? m.act + (r0 * m.S + t0) * al.bytes : nullptr, n_pts - t0, al.bytes,
                      SAVE ? act_cr(m, grp, t0) : nullptr};
      forward_tile<FWD_ROWS, false, SAVE, PP_PREC>(p, t, st, gates, feat, none, ex);
      composite_tile<SAVE>(m, t, r0, t0, n_pts, inv_s, ex, al.tail, cT, acc);
    }
  }
  if (SAVE && threadIdx.x == 0) mlp::bulk_store_wait();   // the cr images' bulk stores
}

// The library's MARCH_BWD_PRECISION mode is PP_PREC (point_pipeline_tile.cuh);
// its kernels carry the mode's suffix (PP_NAME).
__global__ void __launch_bounds__(THREADS, 1) PP_NAME(ray_march_fwd_kernel)(March m) {
  march_fwd<false>(m);
}

__global__ void __launch_bounds__(THREADS, 1) PP_NAME(ray_march_save_fwd_kernel)(March m) {
  march_fwd<true>(m);
}

// ------------------------------------------------------------------------
// Backward
// ------------------------------------------------------------------------

// The block's group scratch, after the point pipeline's backward scratch:
// [G S][CTW] per-point cotangents, [G S] transmittance, [G] inv_s sums,
// [G][6] ray cotangents; rounded up to 32 floats, so that every block's
// scratch keeps the bulk copies' 16-byte alignment.
__host__ __device__ long long group_scratch_floats(int G, int S) {
  return ((long long)G * S * (CTW + 1) + 7LL * G + 31) / 32 * 32;
}

// The floats of a block's partial: the weight grads ([n_grad], the packed
// gradient layout, whose slots start at multiples of 4 floats), inv_s's,
// padding to a multiple of 4, so that every row the flush reduces into is
// 16-byte aligned (red_rows, bulk_rows).
__host__ __device__ inline long long partial_stride(long long n_grad) {
  return (n_grad + 4) / 4 * 4;
}

// Rays per group, every entry's: whole rays filling a forward tile of
// FWD_ROWS points (one ray when S >= FWD_ROWS), whose two halves are the
// backward's 64-point tiles (and the save stash's cr image tiles).
__host__ __device__ int rays_per_group(int S) { return S >= FWD_ROWS ? 1 : FWD_ROWS / S; }

// The compositing VJP at one point (ray_march.py:329-354), given its
// compositing quantities c, its weight w = alpha T, w_bar and `later`, the
// sum of w_bar w over the ray's later samples: its cotangents into o
// ([CTW]), its term of the ray's inv_s cotangent added to sinv.
__device__ __forceinline__ void point_vjp(const Comp& c, float w, float w_bar, float T,
                                          float later, float inv_s, float dist, float mid,
                                          const float* rd, const float* grad, const float* gb,
                                          float* o, float& sinv) {
  const float alpha_bar = w_bar * T - later / c.xv;
  const float gate = (c.q < 1.f ? 1.f : (c.q == 1.f ? 0.5f : 0.f)) *
                     (c.q > 0.f ? 1.f : (c.q == 0.f ? 0.5f : 0.f));
  const float q_bar = alpha_bar * gate;
  const float pc_bar = q_bar * (1.f - c.q) / (c.pc + 1e-5f);
  const float nc_bar = -q_bar / (c.pc + 1e-5f);
  const float dpc = c.pc * (1.f - c.pc), dnc = c.nc * (1.f - c.nc);
  const float ep_bar = pc_bar * dpc * inv_s, en_bar = nc_bar * dnc * inv_s;
  sinv += pc_bar * dpc * c.ep + nc_bar * dnc * c.en;
  const float ic_bar = (en_bar - ep_bar) * dist * 0.5f;
  const float u_bar = c.u > 0.f ? -ic_bar : 0.f;
  const float tc_bar = -0.5f * u_bar;
  const float ek = gb[5] * c.relaxed * 2.f * (c.normg - 1.f);
  o[0] = ep_bar + en_bar;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o[1 + j] = tc_bar * rd[j] + ek * grad[j] / c.normg;
    o[4 + j] = 0.f;
    o[7 + j] = w * gb[j];
    o[10 + j] = gb[4];
  }
  o[13] = tc_bar;
  o[14] = mid;
  o[15] = 0.f;
}

// One thread per ray: the compositing VJP of ray r (ray_march.py:322-355)
// into ct[s * CTW + ...] for s < S; returns the ray's inv_s cotangent.
__device__ __forceinline__ float composite_vjp(const March& m, long long r, float inv_s, float* ct,
                                               float* Tr) {
  const float* rd = m.rays_d + 3 * r;
  const float* gb = m.gbar + r * 16;
  float T = 1.f;
  for (int s = 0; s < m.S; ++s) {
    const float* st = m.stash + (r * m.S + s) * STASH;
    float pt[3], dist, mid;
    sample_point(m, r, s, pt, &dist, &mid);
    Tr[s] = T;
    T *= composite_point(rd, st + 1, st[0], dist, inv_s, pt).xv;
  }
  float later = 0.f, sinv = 0.f;   // later: sum of w_bar w over the samples after s
  for (int s = m.S - 1; s >= 0; --s) {
    const float* st = m.stash + (r * m.S + s) * STASH;
    float pt[3], dist, mid;
    sample_point(m, r, s, pt, &dist, &mid);
    const float* grad = st + 1;
    const float* relit = st + 4;
    const Comp c = composite_point(rd, grad, st[0], dist, inv_s, pt);
    const float w = c.alpha * Tr[s];
    const float w_bar = (relit[0] * gb[0] + relit[1] * gb[1] + relit[2] * gb[2]) + gb[3];
    point_vjp(c, w, w_bar, Tr[s], later, inv_s, dist, mid, rd, grad, gb, ct + s * CTW, sinv);
    later += w_bar * w;
  }
  return sinv;
}

// A block-wide segmented sum in reverse, thread order being point order:
// thread i's v plus the v of every later thread up to and including the
// first j >= i with `end` set (its ray's last sample), plus `carry` when
// no such j is in the block. Hillis-Steele over the threads in shared
// memory (sv, sf: THREADS each), so the order of the additions is fixed.
// Barriers inside; every thread calls it.
__device__ __forceinline__ float seg_suffix_sum(float v, bool end, float carry, float* sv,
                                                int* sf) {
  const int tid = threadIdx.x;
  int f = end;
  for (int d = 1; d < THREADS; d <<= 1) {
    sv[tid] = v;
    sf[tid] = f;
    __syncthreads();
    if (!f && tid + d < THREADS) {
      v += sv[tid + d];
      f = sf[tid + d];
    }
    __syncthreads();
  }
  return f ? v : v + carry;
}

// The save mode's compositing VJP of a group's n_pts points (rays r0 ..,
// ray_march.py:322-355), in parallel: a thread a point, THREADS points a
// pass from the group's end, each point's T the forward's (the stash
// tail's TAIL_T) where composite_vjp re-runs the forward's product, the
// sum G of w_bar w over a ray's later samples a segmented suffix sum
// (seg_suffix_sum) carried from pass to pass, and each ray's inv_s
// cotangent, the suffix sum of its points' terms at its first sample, into
// sinv[g]. Writes ct[q * CTW + ...] as composite_vjp does; sv / sf the
// scan's shared memory. Every thread calls it; a barrier after.
__device__ __forceinline__ void composite_vjp_par(const March& m, long long r0, int n_pts,
                                                  float inv_s, float* ct, float* sinv, float* sv,
                                                  int* sf) {
  const int tid = threadIdx.x;
  const ActLayout al = act_layout(shape_of(m.net), PP_PREC);
  float carry_g = 0.f, carry_s = 0.f;   // the sums of the pass above, at its first point
  for (int hi = n_pts; hi > 0; hi -= THREADS) {
    const int q = hi - THREADS + tid;   // this thread's point of the group
    const bool in = q >= 0;
    const int s = in ? q % m.S : 0;
    const long long r = r0 + (in ? q / m.S : 0);
    const float* rd = m.rays_d + 3 * r;
    const float* gb = m.gbar + r * 16;
    const float* st = m.stash + (r * m.S + s) * STASH;
    float pt[3], dist = 0.f, mid = 0.f, T = 0.f, vw = 0.f, w = 0.f, w_bar = 0.f;
    Comp c{};
    if (in) {
      sample_point(m, r, s, pt, &dist, &mid);
      T = reinterpret_cast<const float*>(m.act + (r * m.S + s) * al.bytes + al.tail)[TAIL_T];
      c = composite_point(rd, st + 1, st[0], dist, inv_s, pt);
      w = c.alpha * T;
      w_bar = (st[4] * gb[0] + st[5] * gb[1] + st[6] * gb[2]) + gb[3];
      vw = w_bar * w;
    }
    const bool last = !in || s == m.S - 1;
    // G: the suffix sum of w_bar w from the next point on (0 past the ray's end)
    const float incl = seg_suffix_sum(vw, last, carry_g, sv, sf);
    sv[tid] = incl;
    __syncthreads();
    const float later = last ? 0.f : (tid + 1 < THREADS ? sv[tid + 1] : carry_g);
    const float first_incl = sv[0];
    __syncthreads();
    float e = 0.f;   // the point's term of its ray's inv_s cotangent
    if (in)
      point_vjp(c, w, w_bar, T, later, inv_s, dist, mid, rd, st + 1, gb, ct + size_t(q) * CTW, e);
    const float es = seg_suffix_sum(e, last, carry_s, sv, sf);
    if (in && s == 0) sinv[q / m.S] = es;
    sv[tid] = es;
    __syncthreads();
    carry_g = first_incl;
    carry_s = sv[0];
    __syncthreads();
  }
}

// The load mode's stand-in for forward_tile<TILE, true>, what the backward
// needs of the 64-point tile ts (from point q0 of [R S]) before its
// pullback, from the forward's stashes instead of a recompute: t.S1, G3
// and RL from the outs stash, GC and DL from the activation stash's tail,
// and every SDF layer's input as its bf16 weight-grad operand (sv.dw),
// staged through X (the stash's rows read in wide batches, stash_rows),
// and of the colour / relight layers' inputs only what the stash's cr
// images, which the flush reads as they are, lack (the small inputs, the
// gc block). The gates and the colour / relight layer inputs, which the
// pullback reads again, are not kept: backward_tile<PREC, true> reads them
// from the stash where it uses them. PREC (the MARCH_BWD_PRECISION mode):
// PREC_BF16's stash holds each SDF layer's input in bf16 (act_layout);
// PREC_F32 stores the SDF layer inputs as three bf16 parts (save_t3). A
// barrier after.
template <int PREC>
__device__ __forceinline__ void load_tile(const March& m, const Tile& t, const Save& sv,
                                          const TileStash& ts, long long q0) {
  const Params& p = m.net;
  const Shape sh = shape_of(p);
  const int tid = threadIdx.x;
  float* const X = t.X;
  float* const PE = X + HID;
  if (tid < TILE) {
    const bool in = tid < ts.n;
    const float* o = m.stash + (q0 + tid) * STASH;
    const float* tl = reinterpret_cast<const float*>(ts.row0 + size_t(tid) * ts.bytes + ts.al.tail);
    t.S1[tid] = in ? o[0] : 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      t.G3[tid * 3 + j] = in ? o[1 + j] : 0.f;
      t.RL[tid * 3 + j] = in ? o[4 + j] : 0.f;
      t.GC[tid * 3 + j] = in ? tl[j] : 0.f;
      t.DL[tid * 3 + j] = in ? tl[3 + j] : 0.f;
    }
  }
  // SDF layer 0's input, the PE, as a hi + lo pair (PREC_F32: three parts)
  fill_pe<TILE>(p, t, PE);
  __syncthreads();
  if constexpr (PREC == PREC_F32) {
    save_t3<false>(PE, EMB, dw_a(sh, sv.dw, 0, 0));
  } else {
    save_t<0>(PE, EMB, dw_a(sh, sv.dw, 0, 0));
    save_t<1>(PE, EMB, dw_a(sh, sv.dw, 0, 1));
  }
  // the input of layer l + 1 (the features' layer after the last): hidden
  // layer l's softplus (PREC_BF16: stored as the input), at the skip [h,
  // PE] / sqrt(2)
  for (int l = 0; l < p.n_sdf - 1; ++l) {
    const bool pre_skip = l + 1 == p.skip;
    const float post = pre_skip && PREC != PREC_BF16 ? INV_SQRT2 : 1.f;
    __syncthreads();   // save_t's reads of X are done
    stash_rows<16>([&](int r, int c) { return stash_sx4<PREC>(ts, l, r, c); },
                   [&](int r, int c, float4 x) {
                     st4(X + r * LDX + c, make_float4(x.x * post, x.y * post, x.z * post,
                                                      x.w * post));
                   });
    if (pre_skip)   // the skip input: [h, PE] / sqrt(2)
      for (int e = tid; e < TILE * EMB; e += THREADS) PE[(e / EMB) * LDX + e % EMB] *= INV_SQRT2;
    __syncthreads();
    if constexpr (PREC == PREC_F32)
      save_t3<false>(X, pre_skip ? HID + EMB : HID, dw_a(sh, sv.dw, l + 1, 0));
    else
      save_t<0>(X, pre_skip ? HID + EMB : HID, dw_a(sh, sv.dw, l + 1, 0));
  }
  // the colour and relight layers' hidden inputs: the flush bulk-copies
  // them from the stash's cr images (dw_issue_load); the rest of their inputs
  // here: colour layer 0's [pts, grad, PE(dirs)] (rows 256 .. of its
  // block), relight layer 0's (all of it), the y_in layer's gc block (rows
  // 256 ..)
  __syncthreads();
  small_inputs<TILE>(t, X, HID, p.color_dv, false);
  __syncthreads();
  save_t<0>(X + HID, EMB, dw_a(sh, sv.dw, p.n_sdf, 0) + HID * 128);
  if (p.n_relight > 1) {
    __syncthreads();
    small_inputs<TILE>(t, X, 0, p.rl_dv, false);
    __syncthreads();
    save_t<0>(X, EMB, dw_a(sh, sv.dw, p.n_sdf + p.n_color - 1, 0));
  }
  if (p.y_in >= 1 && p.y_in < p.n_relight - 1) {
    __syncthreads();
    for (int e = tid; e < TILE * EMB; e += THREADS)
      X[(e / EMB) * LDX + HID + e % EMB] = e % EMB < 3 ? t.GC[(e / EMB) * 3 + e % EMB] : 0.f;
    __syncthreads();
    save_t<0>(X + HID, EMB, dw_a(sh, sv.dw, p.n_sdf + p.n_color - 1 + p.y_in, 0) + HID * 128);
  }
  __syncthreads();
}

// The backward; LOAD (the save mode) fills each tile from the forward's
// stashes (load_tile) where the recompute runs forward_tile.
template <bool LOAD>
__device__ __forceinline__ void march_bwd(const March& m) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile t;
  Rings st;
  carve_bwd(t, st, smem);
  const Params& p = m.net;
  const int tid = threadIdx.x;
  float* base = p.scratch + size_t(blockIdx.x) * m.scratch_floats;
  const BwdScratch s = carve_bwd_scratch<PP_PREC, LOAD>(p, base);
  float* ct = base + bwd_scratch_floats(shape_of(p), p.dw_batch, PP_PREC, LOAD);    // [G S][CTW]
  float* Tr = ct + size_t(m.G) * m.S * CTW;                                 // [G S]
  float* sinv = Tr + size_t(m.G) * m.S;                                     // [G]
  float* rh = sinv + m.G;                                                   // [G][6]
  float* P = m.partial + size_t(blockIdx.x) * partial_stride(m.n_grad);
  if constexpr (LOAD) {   // its partial is not zero-filled: the first flush stores
    zero_outside_flush(p, P, partial_stride(m.n_grad), blockIdx.x >= n_groups(m));
    __syncthreads();
  }
  const float inv_s = *m.inv_s;
  const ActLayout al = act_layout(shape_of(p), PP_PREC);
  int slot = 0;   // the tile's place in the weight-grad batch
  int n_tile = 0, n0 = 0;   // the block's tiles so far, the batch's first (LOAD: the flush's cr)

  for (long long grp = blockIdx.x; grp < n_groups(m); grp += gridDim.x) {
    const long long r0 = grp * m.G;
    const int nr = int(min((long long)m.G, m.n_rays - r0));
    const int n_pts = nr * m.S;
    if constexpr (LOAD) {   // 3 pullback_only: the cotangents as the scratch holds them
      if (RM_ABLATE == 3 && tid < nr) sinv[tid] = 0.f;
      if (RM_ABLATE != 3)
        composite_vjp_par(m, r0, n_pts, inv_s, ct, sinv, t.X, reinterpret_cast<int*>(t.Y));
    } else if (tid < nr) {   // 3 pullback_only: the cotangents as the scratch holds them
      sinv[tid] = RM_ABLATE == 3 ? 0.f
                                 : composite_vjp(m, r0 + tid, inv_s, ct + size_t(tid) * m.S * CTW,
                                                 Tr + size_t(tid) * m.S);
    }
    for (int e = tid; e < nr * 6; e += THREADS) rh[e] = 0.f;
    __syncthreads();
    if (tid == 0)
      for (int g = 0; g < nr; ++g) P[m.n_grad] += sinv[g];

    for (int t0 = 0; t0 < n_pts; t0 += TILE) {
      const Save sv = bwd_save(p, s, slot);
      const TileStash ts{m.act + (r0 * m.S + t0) * al.bytes, al.bytes, n_pts - t0, al,
                         LOAD ? act_cr(m, grp, t0) : nullptr};
      load_march_points<TILE>(m, t, r0, t0, n_pts);
      if constexpr (LOAD) {
        if constexpr (RM_ABLATE != 2)   // 2 no_unflatten: the stash not read
          load_tile<PP_PREC>(m, t, sv, ts, r0 * m.S + t0);
      } else {
        forward_tile<TILE, true, false, PP_PREC>(p, t, st, s.gates, s.feat, sv);
      }
      for (int e = tid; e < TILE * 16; e += THREADS) {
        const int q = t0 + e / 16, c = e % 16;
        t.CT[e] = q < n_pts && c < 13 ? ct[size_t(q) * CTW + c] : 0.f;
      }
      __syncthreads();
      if constexpr (RM_ABLATE != 1)   // 1 no_pullback
        backward_tile<PP_PREC, LOAD>(p, t, st, s.gates, s.zt, sv, P, ts);
      // the tile's share of each ray's cotangents, summed in sample order
      const int g_lo = t0 / m.S, g_hi = min(nr - 1, (t0 + TILE - 1) / m.S);
      for (int e = tid; e < (g_hi - g_lo + 1) * 6; e += THREADS) {
        const int g = g_lo + e / 6, k = e % 6, j = k % 3;
        const int lo = max(t0, g * m.S), hi = min(t0 + TILE, (g + 1) * m.S);
        float acc = 0.f;
        for (int q = lo; q < hi; ++q) {
          const int i = q - t0;
          const float* cq = ct + size_t(q) * CTW;
          acc += k < 3 ? t.PH[i * 3 + j]
                       : t.DH[i * 3 + j] + cq[13] * t.G3[i * 3 + j] + t.PH[i * 3 + j] * cq[14];
        }
        rh[g * 6 + k] += acc;
      }
      __syncthreads();
      if constexpr (RM_ABLATE != 1 && RM_ABLATE != 4)   // the flush: not in 1, 4
        slot = after_tile<PP_PREC, LOAD>(p, st, s, slot,
                                   grp + gridDim.x >= n_groups(m) && t0 + TILE >= n_pts, P,
                                   m.crs, n0);
      if (slot == 0) n0 = n_tile + 1;
      ++n_tile;
    }
    for (int e = tid; e < nr * 8; e += THREADS) {
      const int g = e / 8, k = e % 8;
      m.rays_hat[(r0 + g) * 8 + k] = k == 3 || k == 7 ? 0.f : rh[g * 6 + (k < 3 ? k : k - 1)];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 1) PP_NAME(ray_march_bwd_kernel)(March m) {
  march_bwd<false>(m);
}

__global__ void __launch_bounds__(THREADS, 1) PP_NAME(ray_march_load_bwd_kernel)(March m) {
  march_bwd<true>(m);
}

// The march of a kernel: its groups (rays_per_group) fill the kernel's
// tiles.
March make_march(const float* rays_o, const float* rays_d, const float* z, const float* inv_s,
                 const float* w, const void* wimg, long long n_rays, int S, float sample_dist,
                 int n_sdf, int skip, int d0, float scale, int n_color, int color_dv, int squeeze,
                 int n_relight, int rl_dv, int y_in, int inv_sigmoid, const long long* off,
                 const long long* ioff) {
  March m{};
  m.net = make_params(nullptr, nullptr, w, wimg, 0, n_sdf, skip, d0, scale, n_color, color_dv,
                      squeeze, n_relight, rl_dv, y_in, inv_sigmoid, off, ioff);
  m.rays_o = rays_o;
  m.rays_d = rays_d;
  m.z = z;
  m.inv_s = inv_s;
  m.n_rays = n_rays;
  m.S = S;
  m.G = rays_per_group(S);
  m.tpg = (m.G * S + TILE - 1) / TILE;
  m.sample_dist = sample_dist;
  return m;
}

// The per-block scratch of an entry (save: the save mode's), floats: the
// forward's (fwd_scratch_floats; the save entry keeps no gates in
// PREC_F32STASH and PREC_F32: forward_tile's SG) and the backward's
// (bwd_scratch_floats; the load entry keeps the tangent pre-gates alone,
// then the group scratch).
long long march_fwd_scratch_floats(int n_sdf, bool save) {
  return fwd_scratch_floats(n_sdf, !(save && PP_PREC != PREC_BF16));
}

long long march_bwd_scratch_floats(const Shape& sh, int S, int dw_batch, bool save) {
  return bwd_scratch_floats(sh, dw_batch, PP_PREC, save) +
         group_scratch_floats(rays_per_group(S), S);
}

}  // namespace

// Plain C interface for ctypes. The blocks a launch may use at once (SMs x
// resident blocks per SM), and the per-block scratch each entry needs
// (floats): the wrapper sizes the scratch by them.
// `save`: of the save mode's entry (the forward's export, the backward's
// load), else of the recompute's.
extern "C" int ray_march_fwd_max_blocks(int save, int* n_blocks) {
  return int(save ? max_blocks(PP_NAME(ray_march_save_fwd_kernel), SMEM_FWD, n_blocks)
                  : max_blocks(PP_NAME(ray_march_fwd_kernel), SMEM_FWD, n_blocks));
}

extern "C" int ray_march_bwd_max_blocks(int save, int* n_blocks) {
  return int(save ? max_blocks(PP_NAME(ray_march_load_bwd_kernel), SMEM_BWD, n_blocks)
                  : max_blocks(PP_NAME(ray_march_bwd_kernel), SMEM_BWD, n_blocks));
}

// The save mode's activation stash (act_layout): the bytes of a point's
// row, its cr slots, and the bytes of the whole stash for R rays of S
// samples (the rows, then the cr images of every backward tile).
extern "C" int ray_march_act_row_bytes(int n_sdf, int n_color, int n_relight) {
  return act_layout(Shape{n_sdf, -1, n_color, n_relight, -1}, PP_PREC).bytes;
}

extern "C" int ray_march_act_cr_slots(int n_sdf, int n_color, int n_relight) {
  return act_layout(Shape{n_sdf, -1, n_color, n_relight, -1}, PP_PREC).n_cr;
}

extern "C" long long ray_march_act_total_bytes(int n_sdf, int n_color, int n_relight,
                                               long long R, int S) {
  const ActLayout al = act_layout(Shape{n_sdf, -1, n_color, n_relight, -1}, PP_PREC);
  const int G = rays_per_group(S);
  const long long tiles = (R + G - 1) / G * ((G * S + TILE - 1) / TILE);
  return act_cr_offset(R * S, al) + tiles * al.n_cr * CR_SLOT;
}

extern "C" int ray_march_rays_per_group(int S) {
  return rays_per_group(S);
}

extern "C" long long ray_march_partial_stride(long long n_grad) { return partial_stride(n_grad); }

extern "C" long long ray_march_fwd_scratch_floats(int n_sdf, int save) {
  return march_fwd_scratch_floats(n_sdf, save != 0);
}

extern "C" long long ray_march_bwd_scratch_floats(int n_sdf, int skip, int n_color,
                                                  int n_relight, int y_in, int S, int dw_batch,
                                                  int save) {
  return march_bwd_scratch_floats(Shape{n_sdf, skip, n_color, n_relight, y_in}, S, dw_batch,
                                  save != 0);
}

// Each launch returns 0 or the CUDA error code of the attribute call or the
// launch; none synchronises. `w` / `wimg`: the packed f32 weights and the
// wgmma weight slabs (point_pipeline.py _pack_images), `off` / `ioff` host
// arrays of their offset tables, `inv_s` a device pointer to one float.
// `act`: the save mode's activation stash, ray_march_act_total_bytes
// (act_layout); null runs the recompute's kernels.
// Forward: out [R, 16], stash [R S, 8], scratch n_blocks x
// ray_march_fwd_scratch_floats(n_sdf, act != null) floats.
extern "C" int ray_march_fwd_launch(
    const float* rays_o, const float* rays_d, const float* z, const float* inv_s,
    const float* w, const void* wimg, float* out, float* stash, void* act, float* scratch,
    long long n_rays,
    int S, float sample_dist, int n_blocks, int n_sdf, int skip, int d0, float scale,
    int n_color, int color_dv, int squeeze, int n_relight, int rl_dv, int y_in, int inv_sigmoid,
    const long long* off, const long long* ioff, int n_off, void* stream) {
  if (n_rays <= 0) return 0;
  if (S <= 0 || bad_shape(n_off, n_sdf, n_color, n_relight)) return int(cudaErrorInvalidValue);
  March m = make_march(rays_o, rays_d, z, inv_s, w, wimg, n_rays, S, sample_dist, n_sdf, skip, d0,
                       scale, n_color, color_dv, squeeze, n_relight, rl_dv, y_in, inv_sigmoid,
                       off, ioff);
  m.out = out;
  m.stash = stash;
  set_act(m, act);
  m.net.scratch = scratch;
  m.scratch_floats = march_fwd_scratch_floats(n_sdf, act != nullptr);
  auto kernel = act != nullptr ? PP_NAME(ray_march_save_fwd_kernel) : PP_NAME(ray_march_fwd_kernel);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(SMEM_FWD));
  if (e != cudaSuccess) return int(e);
  kernel<<<n_blocks, THREADS, SMEM_FWD, static_cast<cudaStream_t>(stream)>>>(m);
  return int(cudaGetLastError());
}

// Backward: stash from the forward on the same inputs, gbar [R, 16],
// rays_hat [R, 8], partial n_blocks x ray_march_partial_stride(n_grad)
// floats (n_grad a multiple of 4), zeros for the recompute's kernel, any
// values for the load's, scratch n_blocks x
// ray_march_bwd_scratch_floats(..., dw_batch, act != null) floats.
extern "C" int ray_march_bwd_launch(
    const float* rays_o, const float* rays_d, const float* z, const float* inv_s,
    const float* w, const void* wimg, const float* stash, const void* act, const float* gbar,
    float* rays_hat,
    float* partial, float* scratch, long long n_rays, int S, float sample_dist, int n_blocks,
    long long n_grad, int dw_batch, int n_sdf, int skip, int d0, float scale, int n_color,
    int color_dv, int squeeze, int n_relight, int rl_dv, int y_in, int inv_sigmoid,
    const long long* off, const long long* ioff, int n_off, void* stream) {
  if (n_rays <= 0) return 0;
  if (S <= 0 || dw_batch < 1 || n_grad % 4 != 0 || bad_shape(n_off, n_sdf, n_color, n_relight))
    return int(cudaErrorInvalidValue);
  March m = make_march(rays_o, rays_d, z, inv_s, w, wimg, n_rays, S, sample_dist, n_sdf, skip, d0,
                       scale, n_color, color_dv, squeeze, n_relight, rl_dv, y_in, inv_sigmoid,
                       off, ioff);
  m.net.dw_batch = dw_batch;
  m.stash = const_cast<float*>(stash);
  set_act(m, const_cast<void*>(act));
  m.gbar = gbar;
  m.rays_hat = rays_hat;
  m.partial = partial;
  m.n_grad = n_grad;
  m.net.scratch = scratch;
  m.scratch_floats = march_bwd_scratch_floats(shape_of(m.net), S, dw_batch, act != nullptr);
  auto kernel = act != nullptr ? PP_NAME(ray_march_load_bwd_kernel) : PP_NAME(ray_march_bwd_kernel);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(SMEM_BWD));
  if (e != cudaSuccess) return int(e);
  kernel<<<n_blocks, THREADS, SMEM_BWD, static_cast<cudaStream_t>(stream)>>>(m);
  return int(cudaGetLastError());
}

extern "C" int ray_march_n_off() { return N_OFF; }

extern "C" int ray_march_prec() { return PP_PREC; }

extern "C" const char* ray_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

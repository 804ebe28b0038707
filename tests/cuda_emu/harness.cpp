// Appended to csrc/point_pipeline.cu (same translation unit, so it reaches
// the kernels in its unnamed namespace) by
// tests/test_torch_point_pipeline_emulated.py. Usage: emu DIR. Reads from
// DIR: meta.i64 (n, n_sdf, skip, d0, n_color, color_dv, squeeze, n_relight,
// rl_dv, y_in, inv_sigmoid, n_grad, blocks, dw_batch), scale.f32, off.i64, w.f32,
// ioff.i64, img.bf16 (the wgmma weight slabs), pts.f32, dirs.f32, gbar.f32; runs the forward kernel and then the
// backward kernel block after block, the weight-grad partials summed over
// the blocks in index order as the reduction kernel does; writes out.f32,
// pts_hat.f32, dirs_hat.f32 and grad.f32 to DIR, and the forward's
// scratch as it ends (scratch_fwd.f32: each block's last tile's gates and
// features, fwd_scratch_floats a block). The scratch starts as
// garbage, so a read of a slot the kernel did not write shows. Compiled
// with -DPP_PREC=<mode>, it runs that MARCH_BWD_PRECISION mode's kernels
// (PP_NAME; tests/test_torch_bwd_precision_emulated.py).
#include <cstdio>
#include <string>
#include <vector>

namespace {
alignas(1024) unsigned char smem[SMEM_BWD > SMEM_FWD ? SMEM_BWD : SMEM_FWD];
}

static std::vector<char> slurp(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) { perror(path.c_str()); exit(2); }
  fseek(f, 0, SEEK_END);
  const long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> b(n);
  if (fread(b.data(), 1, n, f) != size_t(n)) exit(2);
  fclose(f);
  return b;
}

static void dump(const std::string& path, const std::vector<float>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}

int main(int argc, char** argv) {
  if (argc != 2) return 2;
  const std::string d = argv[1];
  const auto meta = slurp(d + "/meta.i64"), scale = slurp(d + "/scale.f32");
  const auto off = slurp(d + "/off.i64"), w = slurp(d + "/w.f32");
  const auto ioff = slurp(d + "/ioff.i64"), img = slurp(d + "/img.bf16");
  const auto pts = slurp(d + "/pts.f32"), dirs = slurp(d + "/dirs.f32");
  const auto gbar = slurp(d + "/gbar.f32");
  const long long* m = reinterpret_cast<const long long*>(meta.data());
  const long long n = m[0], n_grad = m[11];
  const int blocks = int(m[12]), batch = int(m[13]);
  const Params p = make_params(
      reinterpret_cast<const float*>(pts.data()), reinterpret_cast<const float*>(dirs.data()),
      reinterpret_cast<const float*>(w.data()), img.data(), n, int(m[1]), int(m[2]), int(m[3]),
      *reinterpret_cast<const float*>(scale.data()), int(m[4]), int(m[5]), int(m[6]), int(m[7]),
      int(m[8]), int(m[9]), int(m[10]), reinterpret_cast<const long long*>(off.data()),
      reinterpret_cast<const long long*>(ioff.data()));
  std::vector<float> out(n * 16), pts_hat(n * 3), dirs_hat(n * 3);
  std::vector<float> partial(size_t(blocks) * n_grad, 0.f);
  std::vector<float> scratch_fwd(size_t(blocks) * fwd_scratch_floats(p.n_sdf), 12345.f);
  std::vector<float> scratch_bwd(size_t(blocks) * bwd_scratch_floats(shape_of(p), batch, PP_PREC),
                                  12345.f);
  gridDim.x = blocks;
  emu_smem_base = smem;
  for (int pass = 0; pass < 2; ++pass) {
    Params q = p;
    if (pass == 0) {
      q.out = out.data();
      q.scratch = scratch_fwd.data();
    } else {
      q.scratch = scratch_bwd.data();
      q.gbar = reinterpret_cast<const float*>(gbar.data());
      q.pts_hat = pts_hat.data();
      q.dirs_hat = dirs_hat.data();
      q.partial = partial.data();
      q.n_grad = n_grad;
      q.dw_batch = batch;
    }
    for (int b = 0; b < blocks; ++b) {
      blockIdx.x = b;
      emu_run_block(THREADS, [&q, pass] {
        if (pass == 0) PP_NAME(point_pipeline_fwd_kernel)(q);
        else PP_NAME(point_pipeline_bwd_kernel)(q);
      });
    }
  }
  std::vector<float> grad(n_grad);
  for (long long i = 0; i < n_grad; ++i) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[size_t(b) * n_grad + i];
    grad[i] = s;
  }
  dump(d + "/out.f32", out);
  dump(d + "/pts_hat.f32", pts_hat);
  dump(d + "/dirs_hat.f32", dirs_hat);
  dump(d + "/grad.f32", grad);
  dump(d + "/scratch_fwd.f32", scratch_fwd);
  return 0;
}

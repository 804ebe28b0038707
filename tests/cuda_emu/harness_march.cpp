// Appended to csrc/ray_march.cu (same translation unit, so it reaches the
// kernels in its unnamed namespace) by tests/test_torch_ray_march_emulated.py.
// Usage: emu DIR. Reads from DIR: meta.i64 (R, S, n_sdf, skip, d0, n_color,
// color_dv, squeeze, n_relight, rl_dv, y_in, inv_sigmoid, n_grad, blocks,
// dw_batch, save: 1 runs the save mode's pair, ray_march_save_fwd_kernel
// then ray_march_load_bwd_kernel, on an activation stash that starts as
// garbage, and also writes it as act.bin: ray_march_act_total_bytes),
// f32.f32 (scale, sample_dist, inv_s), off.i64, w.f32, ioff.i64, img.bf16
// (the wgmma weight slabs), rays_o.f32, rays_d.f32, z.f32, gbar.f32; runs the forward kernel and then the
// backward kernel block after block on `blocks` blocks, the partials summed
// over the blocks in index order as the reduction kernel does; writes
// out.f32, stash.f32, rays_hat.f32 and grad.f32 (the packed weight grads,
// then inv_s's) to DIR, and the forward's scratch as it ends
// (scratch_fwd.f32: each block's last tile's gates and features, or its
// features alone where the save entry keeps no gates;
// march_fwd_scratch_floats a block). The scratch starts as garbage, so a
// read of a slot the kernel did not write shows; each entry's scratch is
// sized as the wrapper sizes it (march_fwd_scratch_floats,
// march_bwd_scratch_floats) and followed by a guard of GUARD floats, and a
// write into the guard (an entry writing past its scratch) exits with code
// 3. Compiled with -DPP_PREC=<mode>, it runs
// that MARCH_BWD_PRECISION mode's kernels (PP_NAME;
// tests/test_torch_bwd_precision_emulated.py).
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

static const float* F(const std::vector<char>& b) { return reinterpret_cast<const float*>(b.data()); }

constexpr size_t GUARD = 1 << 16;

int main(int argc, char** argv) {
  if (argc != 2) return 2;
  const std::string d = argv[1];
  const auto meta = slurp(d + "/meta.i64"), fl = slurp(d + "/f32.f32");
  const auto off = slurp(d + "/off.i64"), w = slurp(d + "/w.f32");
  const auto ioff = slurp(d + "/ioff.i64"), img = slurp(d + "/img.bf16");
  const auto ro = slurp(d + "/rays_o.f32"), rd = slurp(d + "/rays_d.f32");
  const auto z = slurp(d + "/z.f32"), gbar = slurp(d + "/gbar.f32");
  const long long* m = reinterpret_cast<const long long*>(meta.data());
  const long long R = m[0], n_grad = m[12];
  const int S = int(m[1]), blocks = int(m[13]), batch = int(m[14]);
  const bool save = m[15] != 0;
  auto march = [&]() {
    return make_march(F(ro), F(rd), F(z), F(fl) + 2, F(w), img.data(), R, S, F(fl)[1], int(m[2]),
                      int(m[3]), int(m[4]), F(fl)[0], int(m[5]), int(m[6]), int(m[7]), int(m[8]),
                      int(m[9]), int(m[10]), int(m[11]),
                      reinterpret_cast<const long long*>(off.data()),
                      reinterpret_cast<const long long*>(ioff.data()));
  };
  const March base = march();
  std::vector<float> out(R * 16), stash(R * S * STASH, 12345.f), rays_hat(R * 8);
  const long long stride = partial_stride(n_grad);   // the wrapper's rows
  // the load entry's as torch.empty leaves it (zero_outside_flush, its first flush's stores)
  std::vector<float> partial(size_t(blocks) * stride, save ? 12345.f : 0.f);
  const long long act_bytes =
      ray_march_act_total_bytes(base.net.n_sdf, base.net.n_color, base.net.n_relight, R, S);
  std::vector<unsigned char> act(save ? size_t(act_bytes) : 0, 0xAB);
  const long long fwd_floats = march_fwd_scratch_floats(base.net.n_sdf, save);
  const long long bwd_floats = march_bwd_scratch_floats(shape_of(base.net), S, batch, save);
  std::vector<float> scratch_fwd(size_t(blocks) * fwd_floats + GUARD, 12345.f);
  std::vector<float> scratch_bwd(size_t(blocks) * bwd_floats + GUARD, 12345.f);
  gridDim.x = blocks;
  emu_smem_base = smem;
  for (int pass = 0; pass < 2; ++pass) {
    March q = march();
    q.stash = stash.data();
    set_act(q, save ? act.data() : nullptr);
    if (pass == 0) {
      q.out = out.data();
      q.net.scratch = scratch_fwd.data();
      q.scratch_floats = fwd_floats;
    } else {
      q.gbar = F(gbar);
      q.rays_hat = rays_hat.data();
      q.partial = partial.data();
      q.n_grad = n_grad;
      q.net.scratch = scratch_bwd.data();
      q.scratch_floats = bwd_floats;
      q.net.dw_batch = batch;
    }
    for (int b = 0; b < blocks; ++b) {
      blockIdx.x = b;
      emu_run_block(THREADS, [&q, pass, save] {
        if (pass == 0) save ? PP_NAME(ray_march_save_fwd_kernel)(q) : PP_NAME(ray_march_fwd_kernel)(q);
        else save ? PP_NAME(ray_march_load_bwd_kernel)(q) : PP_NAME(ray_march_bwd_kernel)(q);
      });
    }
  }
  for (const auto* sc : {&scratch_fwd, &scratch_bwd})
    for (size_t i = sc->size() - GUARD; i < sc->size(); ++i)
      if ((*sc)[i] != 12345.f) {
        fprintf(stderr, "an entry wrote past its scratch\n");
        return 3;
      }
  scratch_fwd.resize(scratch_fwd.size() - GUARD);
  std::vector<float> grad(n_grad + 1);
  for (long long i = 0; i <= n_grad; ++i) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[size_t(b) * stride + i];
    grad[i] = s;
  }
  dump(d + "/out.f32", out);
  dump(d + "/stash.f32", stash);
  dump(d + "/rays_hat.f32", rays_hat);
  dump(d + "/grad.f32", grad);
  dump(d + "/scratch_fwd.f32", scratch_fwd);
  if (save) {
    FILE* f = fopen((d + "/act.bin").c_str(), "wb");
    fwrite(act.data(), 1, act.size(), f);
    fclose(f);
  }
  return 0;
}

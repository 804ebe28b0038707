// Appended to csrc/sdf_rays.cu (same translation unit, so it reaches the
// kernels in its unnamed namespace) by tests/test_torch_sdf_rays_emulated.py.
// Usage: emu DIR. Reads from DIR: meta.i64 (n_pts, S, n_lin, skip, d0, mode
// (0 f32, 1 bf16, 2 f32x3), relu, points), f32.f32 (scale), w.bin (the
// packed weights as the wrapper packs them: bf16 fragment order or f32),
// bias.f32, and either
// rays_o.f32, rays_d.f32 and z.f32 (the sweep) or pts.f32 (the grid SDF);
// runs the kernel the launch would run, block after block, with the launch's
// Params, and writes out.f32 [n_pts]. The output starts as garbage, so a
// point the kernel did not write shows.
#include <cstdio>
#include <string>
#include <vector>

namespace {
constexpr size_t SMEM_MAX = SMEM_F32 > SMEM_BF16 ? (SMEM_F32 > SMEM_X3 ? SMEM_F32 : SMEM_X3)
                                                  : (SMEM_BF16 > SMEM_X3 ? SMEM_BF16 : SMEM_X3);
alignas(128) unsigned char smem[SMEM_MAX];
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

static const float* F(const std::vector<char>& b) {
  return reinterpret_cast<const float*>(b.data());
}

int main(int argc, char** argv) {
  if (argc != 2) return 2;
  const std::string d = argv[1];
  const auto meta = slurp(d + "/meta.i64"), fl = slurp(d + "/f32.f32");
  const auto w = slurp(d + "/w.bin"), bias = slurp(d + "/bias.f32");
  const long long* m = reinterpret_cast<const long long*>(meta.data());
  const int n = int(m[0]), S = int(m[1]), n_lin = int(m[2]), skip = int(m[3]), d0 = int(m[4]);
  const int mode = int(m[5]);
  const bool relu = m[6], points = m[7];
  std::vector<char> ro, rd, z, pts;
  if (points) {
    pts = slurp(d + "/pts.f32");
  } else {
    ro = slurp(d + "/rays_o.f32");
    rd = slurp(d + "/rays_d.f32");
    z = slurp(d + "/z.f32");
  }
  std::vector<float> out(n, 12345.f);
  const float scale = F(fl)[0];
  Params p{points ? nullptr : F(ro), points ? nullptr : F(rd), points ? nullptr : F(z),
           points ? F(pts) : nullptr, w.data(), F(bias), out.data(), n, S, n_lin, skip, d0,
           scale, 1.f / scale};
  const Choice c = choose(mode, relu, points);
  gridDim.x = unsigned((n + c.pts - 1) / c.pts);
  blockDim.x = unsigned(c.threads);
  for (unsigned b = 0; b < gridDim.x; ++b) {
    blockIdx.x = b;
    emu_run_block(c.threads, [&p, &c] { c.kern(p); });
  }
  FILE* f = fopen((d + "/out.f32").c_str(), "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return 0;
}

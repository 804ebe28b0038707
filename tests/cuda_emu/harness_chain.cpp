// Appended to csrc/mlp_chain.cu (same translation unit, so it reaches the
// kernels in its unnamed namespace) by tests/test_torch_mlp_chain_emulated.py.
// Usage: emu DIR. Reads from DIR: meta.i64 (n, L, act, blocks, n_probe,
// kernel), f32.f32 (gate_w), x.f32 [n, 256], wimg.bin (W's packed image:
// bf16 for kernels 1 and 2, three-part for kernel 0), probe.f32
// [n_probe]; runs the chain kernel of
// activation `act` (kernel 0: the f32 chain, 1: the bf16 chain, 2: the
// deferred chain, which ignores act) block after block on `blocks` blocks
// (at most one per unit of rows a block walks, as the launch caps the
// grid; the tiles shared out as the persistent grid shares them) and writes
// out.f32 [n, 256]; evaluates every activation and the
// deferred chain's sp on the probe values and writes act.f32 [N_ACT + 1,
// n_probe]. The output starts as garbage, so a row the kernel did not write
// shows.
#include <cstdio>
#include <string>
#include <vector>

namespace {
constexpr size_t SMEM_MAX = std::max({SMEM_F32, SMEM_CHAIN, SMEM_DEF});
alignas(1024) unsigned char smem[SMEM_MAX];
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

template <int A>
static void run_chain(const Chain& c, int blocks, int kernel) {
  // the launch's grid: at most one block per unit of rows it walks
  const Shape& sh = kernel == 0 ? F32_SHAPE : kernel == 1 ? CHAIN_SHAPE : DEF_SHAPE;
  const int threads_per_block = sh.threads, rows = sh.rows;
  blocks = int(std::min<long long>(blocks, n_tiles(c.n, rows)));
  gridDim.x = blocks;
  emu_smem_base = smem;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    emu_run_block(threads_per_block, [&c, kernel] {
      if (kernel == 0) chain_f32_kernel<A>(c);
      else if (kernel == 1) chain_bf16_kernel<A>(c);
      else chain_deferred_kernel(c);
    });
  }
}

template <int A>
static void probe(const float* p, long long n, float gw, float* o) {
  for (long long i = 0; i < n; ++i) o[i] = activate<A>(p[i], gw);
}

int main(int argc, char** argv) {
  if (argc != 2) return 2;
  const std::string d = argv[1];
  const auto meta = slurp(d + "/meta.i64"), fl = slurp(d + "/f32.f32");
  const auto x = slurp(d + "/x.f32"), pr = slurp(d + "/probe.f32");
  const auto wimg = slurp(d + "/wimg.bin");
  const long long* m = reinterpret_cast<const long long*>(meta.data());
  const long long n = m[0], n_probe = m[4];
  const int L = int(m[1]), act = int(m[2]), blocks = int(m[3]), kernel = int(m[5]);
  const float gw = F(fl)[0];
  std::vector<float> out(size_t(n) * WD, 12345.f);
  const Chain c{F(x), wimg.data(), out.data(), n, L, gw};
  switch (act) {
    case NONE: run_chain<NONE>(c, blocks, kernel); break;
    case RELU: run_chain<RELU>(c, blocks, kernel); break;
    case SOFTPLUS: run_chain<SOFTPLUS>(c, blocks, kernel); break;
    case SIGMOID: run_chain<SIGMOID>(c, blocks, kernel); break;
    case SP_GATE: run_chain<SP_GATE>(c, blocks, kernel); break;
    case SHARED: run_chain<SHARED>(c, blocks, kernel); break;
    case EXPM1_GATE: run_chain<EXPM1_GATE>(c, blocks, kernel); break;
    case RECIP_APPROX: run_chain<RECIP_APPROX>(c, blocks, kernel); break;
    case RECIP_NEWTON: run_chain<RECIP_NEWTON>(c, blocks, kernel); break;
    default: return 3;
  }
  std::vector<float> acts(size_t(N_ACT + 1) * n_probe);
  float* o = acts.data();
  probe<NONE>(F(pr), n_probe, gw, o + 0 * n_probe);
  probe<RELU>(F(pr), n_probe, gw, o + 1 * n_probe);
  probe<SOFTPLUS>(F(pr), n_probe, gw, o + 2 * n_probe);
  probe<SIGMOID>(F(pr), n_probe, gw, o + 3 * n_probe);
  probe<SP_GATE>(F(pr), n_probe, gw, o + 4 * n_probe);
  probe<SHARED>(F(pr), n_probe, gw, o + 5 * n_probe);
  probe<EXPM1_GATE>(F(pr), n_probe, gw, o + 6 * n_probe);
  probe<RECIP_APPROX>(F(pr), n_probe, gw, o + 7 * n_probe);
  probe<RECIP_NEWTON>(F(pr), n_probe, gw, o + 8 * n_probe);
  for (long long i = 0; i < n_probe; ++i) {
    float e;
    o[N_ACT * n_probe + i] = shared_sp(F(pr)[i], &e);
  }
  dump(d + "/out.f32", out);
  dump(d + "/act.f32", acts);
  return 0;
}

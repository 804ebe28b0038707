"""Where the forward tile's time goes, by phase, on the card: a copy of this
checkout whose forward tile (csrc/point_pipeline_tile.cuh, forward_tile in
the forward kernel of row 5) adds clock64() deltas of its phases into a
__device__ array (thread 0 of every block), launched once on row 5's
training shape (131,072 points, Color-NeuS, off geometric init).

    python -m color_neus_torch.tools.tile_profile DIR   # on the card, from a checkout's root

DIR (a directory git ignores, e.g. tree_check/prof) receives the copy and
is emptied first. Prints, per phase (the SDF layers, the last layer, the
reverse sweep, colour, relight: the work before each product, the product,
its pass; the closing step; inside the products the A loads with their
barrier, the chunks, the closing barrier), the cycles per block and the
share of the tile loop, then the kernel's ms with CUDA events. The timers
cost what they read (a clock read and an atomic per phase and block).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (file, anchor, replacement): each anchor must occur once
PATCHES = [
    ("csrc/point_pipeline_tile.cuh", "namespace {\n\nusing mlp::EMB;",
     "__device__ unsigned long long g_prof[32];\nnamespace {\n\nusing mlp::EMB;"),
    ("csrc/point_pipeline_tile.cuh", "  for (int i = 0; i <= n_steps; ++i) {\n",
     "  const int PROF = ROWS == 2 * TILE && tid == 0;\n"
     "  for (int i = 0; i <= n_steps; ++i) {\n    const long long c_0 = clock64();\n"),
    ("csrc/point_pipeline_tile.cuh", "    if (kind == END) break;\n",
     "    if (kind == END) {\n      if (PROF) atomicAdd(&g_prof[15], "
     "(unsigned long long)(clock64() - c_0));\n      break;\n    }\n"),
    ("csrc/point_pipeline_tile.cuh",
     "    layer_product<ROWS>(st, X, A, image(p, slot), K, kind == REV);\n",
     "    const long long c_1 = clock64();\n"
     "    layer_product<ROWS>(st, X, A, image(p, slot), K, kind == REV);\n"
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
     "    forward_tile<FWD_ROWS, false>(p, t, st, gates, feat, none);",
     "    const long long k_0 = clock64();\n    load_points<FWD_ROWS>(p, t, base);\n"
     "    forward_tile<FWD_ROWS, false>(p, t, st, gates, feat, none);\n"
     "    if (tid == 0) atomicAdd(&g_prof[19], (unsigned long long)(clock64() - k_0));"),
    ("csrc/point_pipeline.cu", 'extern "C" int point_pipeline_n_off() { return N_OFF; }',
     'extern "C" int point_pipeline_n_off() { return N_OFF; }\n\n'
     'extern "C" int prof_read(unsigned long long* host) {\n'
     "  return int(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));\n}\n\n"
     'extern "C" int prof_reset() {\n  unsigned long long z[32] = {0};\n'
     "  return int(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));\n}"),
]

NAMES = [f"{k} {part}" for k in ("sdf", "last", "rev", "col", "rel")
         for part in ("pre", "product", "pass")]
NAMES += ["end pre", "products: A loads + barrier", "products: chunks",
          "products: closing barrier", "tile loop total"]


def make_copy(out: str) -> None:
    """The instrumented copy of this checkout in `out`."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "color_neus_torch"), os.path.join(out, "color_neus_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), out)
    for rel, anchor, new in PATCHES:
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
    buf = (ctypes.c_ulonglong * 32)()
    lib.prof_read(ctypes.cast(buf, ctypes.c_void_p))
    blocks = PP._max_blocks(lib, device, "f32stash", "fwd")
    total = buf[19]
    for i, name in enumerate(NAMES):
        print(f"{name:30s} {buf[i] / blocks:12.0f} cycles per block {buf[i] / total * 100:7.2f}%")
    print(f"blocks {blocks} | kernel {cs.cuda_ms(lambda: PP.launch_point_pipeline(pw, pts, dirs)):.4f}"
          f" ms | {cs.card_line()}", flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--run":
        return profile()
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    out = os.path.abspath(sys.argv[1])
    make_copy(out)
    return subprocess.run([sys.executable, "-m", "color_neus_torch.tools.tile_profile", "--run"],
                          cwd=out).returncode


if __name__ == "__main__":
    sys.exit(main())

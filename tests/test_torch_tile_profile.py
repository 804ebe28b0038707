"""color_neus_torch/tools/tile_profile.py on the CPU: the tool patches a
copy of the checkout's kernels with clock64() timers at anchors in their
sources (PATCHES: row 5's forward tile; LOAD_PATCHES: row 4's load entry;
SAVE_PATCHES: row 3's save entry; HEADER: the counters), so an edit of a
kernel that moves an anchor breaks it on the card. Here every anchor of
each list occurs exactly once in the tree, and each instrumented copy
compiles, in every MARCH_BWD_PRECISION
mode, with the host C++ compiler against tests/cuda_emu/cuda_runtime.h
(clock64, the 64-bit atomicAdd and the symbol copies stubbed: only the
syntax is checked). Skips the compile without a C++20 compiler."""

import os
import re
import shutil
import subprocess

import pytest

from color_neus_torch.tools import tile_profile as TP

HERE = os.path.dirname(os.path.abspath(__file__))
LISTS = {"forward": TP.PATCHES, "load": TP.LOAD_PATCHES, "save": TP.SAVE_PATCHES}
# the instrumented source of each list and the harness that drives it
SOURCES = {"forward": ("point_pipeline.cu", "harness.cpp"),
           "load": ("ray_march.cu", "harness_march.cpp"),
           "save": ("ray_march.cu", "harness_march.cpp")}
STUBS = """#include "cuda_runtime.h"
inline long long clock64() { return 0; }
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  const unsigned long long o = *a;
  *a += v;
  return o;
}
template <class A, class B> int cudaMemcpyFromSymbol(A, B&, size_t) { return 0; }
template <class A, class B> int cudaMemcpyToSymbol(A&, B, size_t) { return 0; }
"""


@pytest.mark.parametrize("name", list(LISTS))
def test_every_anchor_occurs_once(name):
    for rel, anchor, new in [TP.HEADER, *LISTS[name]]:
        with open(os.path.join(TP.ROOT, "color_neus_torch", rel)) as f:
            count = f.read().count(anchor)
        assert count == 1, f"{name}: {count} occurrences in {rel} of {anchor!r}"
        assert anchor != new


@pytest.mark.parametrize("prec", [0, 1, 2], ids=["f32stash", "bf16", "f32"])
@pytest.mark.parametrize("name", list(LISTS))
def test_instrumented_copy_compiles(name, prec, tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path / "copy"
    TP.make_copy(str(out), LISTS[name])
    csrc = out / "color_neus_torch" / "csrc"
    src_name, harness = SOURCES[name]
    src = re.sub(r"<<<.*?>>>", "", (csrc / src_name).read_text(), flags=re.S)
    with open(os.path.join(HERE, "cuda_emu", harness)) as f:
        src += f.read()
    (tmp_path / "emu.cpp").write_text(src)
    (tmp_path / "stubs.h").write_text(STUBS)
    proc = subprocess.run([cxx, "-std=c++20", "-fsyntax-only", "-pthread",
                           "-Wno-unknown-pragmas", f"-DPP_PREC={prec}", "-include",
                           str(tmp_path / "stubs.h"), "-I", os.path.join(HERE, "cuda_emu"),
                           "-I", str(csrc), "-x", "c++", str(tmp_path / "emu.cpp")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-4000:]

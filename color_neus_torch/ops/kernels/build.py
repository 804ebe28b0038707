"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each kernel source color_neus_torch/csrc/<name>.cu has a plain C
interface and is compiled at first use for Hopper (sm_90a) into
color_neus_torch/_build/ (git-ignored), keyed by a hash of the source,
the shared headers (csrc/*.cuh) and the flags, so a changed source
rebuilds and an unchanged one loads at once. A name in VARIANTS or
ABLATIONS is a second library of another name's source, built with extra
flags. Nothing
is built when a module is imported, and a failed build raises with nvcc's
output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# the MARCH_BWD_PRECISION modes' builds of rows 3-6 (csrc/point_pipeline_tile.cuh
# PP_PREC): each mode's library suffix and nvcc flags
MODE_BUILDS = {"f32stash": ("", ()), "bf16": ("_bf16s", ("-DPP_PREC=1",)),
               "f32": ("_f32s", ("-DPP_PREC=2",))}
# libraries built from another name's source with extra flags: the
# point-pipeline and march kernels of each non-default mode, named by the
# mode's suffix
VARIANTS = {f"{src}{suffix}": (src, flags)
            for src in ("point_pipeline", "ray_march")
            for suffix, flags in MODE_BUILDS.values() if flags}
# the march's cost probes (csrc/point_pipeline_tile.cuh RM_ABLATE) in each
# mode, built only when tools/march_ablate.py asks: full is the production
# code built again, each other one skips one part of the load backward's
# work; ray_march_abl_<variant> in f32stash, ray_march_abl_<suffix
# without its _>_<variant> in the others (ray_march_abl_f32s_no_wgrad)
ABLATE = {"full": 0, "no_pullback": 1, "no_unflatten": 2, "pullback_only": 3, "no_wgrad": 4}


def ablation_names(mode: str) -> dict[str, str]:
    """{variant: library name} of the march's ablation builds in `mode`."""
    suffix = MODE_BUILDS[mode][0]
    return {v: f"ray_march_abl{suffix}_{v}" for v in ABLATE}


ABLATIONS = {ablation_names(mode)[v]: ("ray_march", flags + (f"-DRM_ABLATE={k}",))
             for mode, (_, flags) in MODE_BUILDS.items() for v, k in ABLATE.items()}
_DERIVED = {**VARIANTS, **ABLATIONS}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + _DERIVED.get(name, (name, ()))[1]


def _paths(name: str):
    src = os.path.join(CSRC, f"{_DERIVED.get(name, (name,))[0]}.cu")
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    # the source and every shared header it may include
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.join(BUILD_DIR, f"lib{name}_{digest}")
    return src, stem + ".so", stem + ".log"


def build(names) -> dict[str, str]:
    """Compile every named kernel that is not built yet, all nvcc
    processes at once; returns {name: path of the shared library}.
    The ptxas report (registers, shared memory, spills) of each build is
    kept beside the library as <lib>.log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, procs = {}, []
    for name in names:
        src, so, log = _paths(name)
        out[name] = so
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *_flags(name), "-o", tmp, src]
        procs.append((name, so, tmp, log, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, so, tmp, log, proc in procs:
        text, _ = proc.communicate()
        with open(log, "w") as f:
            f.write(text)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, so)   # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(name: str) -> str:
    """The ptxas report of the current build of `name` ('' if not built)."""
    log = _paths(name)[2]
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _LIBS[name] = lib
    return lib

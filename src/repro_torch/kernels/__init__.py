"""Hand-written Hopper kernels for the planning path and the model stack,
plus the device probe and the build helper they share.

Each kernel ships, under ``<name>/``:
  csrc/<name>.cu — CUDA C++ for sm_90a with a plain C entry point
  ops.py         — the wrapper: checks, int32 guards, dispatch by device,
                   and a launch counter (``<wrapper>.launches``)
  ref.py         — the plain PyTorch version, which a CPU tensor takes

Kernels (what each one replaces is named in its source note):
  bna_step      — one lock-step BNA iteration over a (B, w, w) demand stack
  coflow_merge  — alpha per merged interval: running per-port counts down
                  the interval axis, maxed over ports, in one pass
  bna_decompose — a whole width bucket's BNA decomposition, step and
                  augmenting-path repair, one block per matrix
  merge_fix     — the fused merge_and_fix tail: binning (a bucket table
                  of the times), a counting sort of the endpoints, the
                  tile scan and the Lemma 6 durations, with no dense
                  interval x port array
  flash_attention — blocked online-softmax GQA attention (prefill and
                  training), float32 accumulators: bfloat16 at d = 64 and
                  128 on wgmma with TMA tiles under mbarriers, at other
                  head dims on mma.sync (a cp.async ring of K/V tiles),
                  float32 as float32 FMAs (``ops.forward_kernel`` states
                  the rule); and its backward (D = rowsum(dO o O), dk and
                  dv a key block, dq a query tile, from the forward's row
                  log-sum-exp; no atomics): bfloat16 on wgmma with TMA
                  tiles under mbarriers, float32 as FMAs
  ssd_scan      — the Mamba2 SSD chunked scan (lm_forward's mamba layers):
                  bfloat16 in one launch that walks the chunks with the
                  state on chip, every product on wgmma (TMA tiles under
                  mbarriers; the operands it computes as high and low bf16
                  parts), float32 chunk-parallel in three launches of
                  float32 FMAs (chunk states, the state pass over the
                  chunks, chunk outputs); and its backward (the chunk state gradients and
                  their reverse pass, then dx, da and the per-head db, dc
                  a chunk, summed over each state group; no atomics):
                  bfloat16 on the tensor cores in
                  ``ssd_scan/csrc/ssd_scan_bwd_mma.cu`` (the state walk,
                  the dx, db and dc role kernels and the finish), float32
                  as float32 FMAs in ``ssd_scan/csrc/ssd_scan_bwd.cu``,
                  which also holds the backward's entry points; both are
                  sources of the one ``ssd_scan`` library
Headers shared between kernels (``*/csrc/*.cuh``) are included by path:
``flash_attention/csrc/tensor_core.cuh`` holds the mma.sync, ldmatrix and
cp.async primitives of K4 and K5, ``flash_attention/csrc/hopper.cuh`` the
wgmma, TMA and mbarrier primitives of K4, its backward and K5's bf16
forward (its tensor maps are
encoded through `cudaGetDriverEntryPoint`, so no library needs
``-lcuda``), ``coflow_merge/csrc/merge_scan.cuh`` the
scan of coflow_merge and merge_fix (the carry between tiles, the row max).
``tma.py`` holds the host side those TMA kernels share: which operands a
tensor map can describe as they lie, and the staged copy of the others.

Dispatch is by device, never by a knob: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.  Nothing here falls
back.

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a``
compiles each kernel's sources (every ``<name>/csrc/*.cu``, each source in
its own process, all at once) and links them into one library a kernel
under ``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``); the library is loaded with ``ctypes``.  The
file name carries a hash of the sources and of every shared header, so an
edited kernel or header rebuilds.
No PyTorch header is compiled, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "PLAIN_DEVICES", "resolve_device", "build_kernels",
           "load_kernel"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# devices whose tensors take the kernels' plain versions: the CPU, and
# ``meta`` (shapes only: the dry run traces a step without running it)
PLAIN_DEVICES = ("cpu", "meta")

_loaded: dict[str, ctypes.CDLL] = {}


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device an entry point runs on.  ``cpu`` takes the plain PyTorch
    versions; ``cuda`` needs a card and raises without one (there is no
    silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def _sources(name: str) -> list[Path]:
    return sorted((_KERNELS_DIR / name / "csrc").glob("*.cu"))


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for source in _sources(name):
        h.update(source.read_bytes())
    for header in sorted(_KERNELS_DIR.glob("*/csrc/*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "on PATH); the CUDA kernels cannot be built")
    return found


def build_kernels(names: "list[str]") -> dict[str, str]:
    """Compile every named kernel that is not built yet: one ``nvcc -c`` per
    source, all started together, then one ``nvcc -shared`` a library to
    link its objects.  Returns name -> the compiler's ``-Xptxas -v`` report
    (registers, shared memory, spills); an empty string for a library that
    was already built.  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    jobs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        objs = [out.with_suffix(f".{i}.{pid}.o")
                for i in range(len(_sources(name)))]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for obj, src in zip(objs, _sources(name))]
        jobs[name] = (procs, objs, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (procs, objs, out) in jobs.items():
        reports[name] = "".join(proc.communicate()[0] for proc in procs)
        rc = next((proc.returncode for proc in procs if proc.returncode), 0)
        if rc == 0:
            tmp = out.with_suffix(f".{pid}.tmp")
            link = subprocess.run(
                [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            reports[name] += link.stdout + link.stderr
            rc = link.returncode
            if rc == 0:
                os.replace(tmp, out)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if rc != 0:
            failed.append(f"{name} (exit {rc}):\n{reports[name]}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load_kernel(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib

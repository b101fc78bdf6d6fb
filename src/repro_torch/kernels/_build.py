"""Builds and loads the port's hand-written CUDA kernels.

Every ``kernels/csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``.  Nothing of PyTorch's headers is included, so a build takes
seconds.  The library lands in ``build/repro_torch/<hash of the sources>/``
under the repository root and is built at the first CUDA launch, so a fresh
checkout builds everything it runs; the hash keys the cache to the sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}  # what the last build or load did (seconds, ptxas report)


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("repro_torch: nvcc not found on PATH or under CUDA_HOME; "
                       "the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.blake2b(digest_size=8)
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    return BUILD_ROOT / source_hash() / "libkernels.so"


def build() -> Path:
    """Compile every source (one ``nvcc`` each, all started together), link
    them into ``libkernels.so`` and return its path.  Reuses a library built
    from identical sources."""
    lib = library_path()
    out_dir = lib.parent
    if lib.is_file():
        build_info.update(cached=True, seconds=0.0)
        return lib
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

        def finish(proc):  # drain one compiler's output; when it ended
            log, _ = proc.communicate()
            return log, time.perf_counter() - t0

        with ThreadPoolExecutor(len(procs)) as pool:
            done = list(pool.map(finish, [p for _, _, p in procs]))
        reports = {src.name: log for (src, _, _), (log, _) in zip(procs, done)}
        source_seconds = {src.name: s for (src, _, _), (_, s) in zip(procs, done)}
        for src, _, p in procs:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{reports[src.name]}")
        tmp_lib = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib)  # atomic: a reader never sees a partial file
    build_info.update(cached=False, seconds=time.perf_counter() - t0,
                      ptxas=reports, source_seconds=source_seconds)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.bank_matmul_simt_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                                ci, ci, vp]
        lib.bank_matmul_simt_launch.restype = ci
        lib.bank_matmul_wgmma_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                                 ci, vp]
        lib.bank_matmul_wgmma_launch.restype = ci
        for name in ("flash_attention_simt_launch", "flash_attention_mma_launch"):
            getattr(lib, name).argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                           ci, cf, vp]
            getattr(lib, name).restype = ci
        lib.page_gather_launch.argtypes = [vp, vp, vp, cl, cl, cl, vp]
        lib.page_gather_launch.restype = ci
        lib.decode_attention_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                                ci, ci, ci, ci, cf, ci, vp]
        lib.decode_attention_launch.restype = ci
        lib.mamba_scan_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                          ci, ci, vp]
        lib.mamba_scan_launch.restype = ci
        lib.rg_lru_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.rg_lru_launch.restype = ci
        _lib = lib
    return _lib


def find_tool(name: str) -> Optional[str]:
    """A CUDA toolkit binary (``cuobjdump``, ``cu++filt``) beside ``nvcc``."""
    found = shutil.which(name)
    if found:
        return found
    try:
        cand = Path(find_nvcc()).parent / name
    except RuntimeError:
        return None
    return str(cand) if cand.is_file() else None


def sass_mma_counts(lib_path: Path) -> dict:
    """{kernel function: {"HGMMA": n, "HMMA": n}} from ``cuobjdump -sass`` of
    the built library: the warpgroup (``HGMMA``) and warp (``HMMA``)
    tensor-core instructions each compiled kernel contains.  Names are
    demangled with ``cu++filt`` where it exists."""
    tool = find_tool("cuobjdump")
    if tool is None:
        raise RuntimeError("repro_torch: cuobjdump not found beside nvcc")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None and line.startswith("/*"):
            words = [w for w in line.split("*/", 1)[-1].split() if not w.startswith("@")]
            op = words[0].split(".")[0] if words else ""  # e.g. HGMMA.64x256x16.F32.BF16
            if op in counts[name]:
                counts[name][op] += 1
    filt = find_tool("cu++filt")
    if filt is not None and counts:
        names = list(counts)
        plain = subprocess.run([filt], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        if len(plain) == len(names):
            counts = {p: counts[n] for p, n in zip(plain, names)}
    return counts


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")

"""Build the port's CUDA kernels (``csrc/*.cu``) into one shared library.

The sources have a plain C interface and are loaded with ``ctypes``
(``kernels/backend.py``), so no PyTorch header is compiled.  Each source
is compiled to an object by its own ``nvcc`` process, all started
together, then one ``nvcc -shared`` links ``build/libgriffin_kernels.so``
at the repository root.  The build runs at first use, only from the
sources in the checkout, and is redone when a source changes (a digest
of the sources and flags is kept beside the library).  A file lock
serializes concurrent first uses.

Target: ``sm_90a`` (Hopper; ``wgmma``/``setmaxnreg`` need the ``a``).
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "libgriffin_kernels.so"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return nvcc


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(extra: List[str]) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS + extra).encode())
    return h.hexdigest()


def build(verbose: bool = False) -> Path:
    """Return the path of the built library, building it if needed.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) and writes the compiler output to ``build/build.log``."""
    extra = ["-Xptxas", "-v"] if verbose else []
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / LIB_NAME
    stamp = BUILD / (LIB_NAME + ".sha256")
    digest = _digest(extra)
    with open(BUILD / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            return lib
        nvcc = find_nvcc()
        objs, procs = [], []
        for src in _sources():
            obj = BUILD / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH, *FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log = []
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc={p.returncode})\n{out}")
            if p.returncode:
                failed.append(src.name)
        tmp = BUILD / (LIB_NAME + f".tmp{os.getpid()}")
        if not failed:
            r = subprocess.run([nvcc, *ARCH, "-shared", *map(str, objs),
                                "-o", str(tmp)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True)
            log.append(f"== link (rc={r.returncode})\n{r.stdout}")
            if r.returncode:
                failed.append("link")
        (BUILD / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)[-8000:]
            )
        os.replace(tmp, lib)
        stamp.write_text(digest)
        return lib

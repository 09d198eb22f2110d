"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the
root of the checkout (``.gitignore`` lists ``build/``) and loaded with
``ctypes``. The library file name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import: the first CUDA launch builds its kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: Flags of one kernel on top of ``NVCC_FLAGS``. route_score builds with
#: --fmad=false: no a*b+c contraction, so it rounds like its plain version
#: bit for bit (it also spells its arithmetic with _rn intrinsics). The
#: LM-plane kernels are held to a tolerance and keep nvcc's FMAs.
#: flash_attention links libcuda for cuTensorMapEncodeTiled (the
#: TMA maps of its bf16 kernel).
KERNEL_FLAGS = {"route_score": ("--fmad=false",),
                "flash_attention": ("-lcuda",)}


def nvcc_flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build on first launch and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(nvcc_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names) -> dict[str, tuple[Path, float]]:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` each, all started together; returns, for each name, the
    library path and the seconds until its compile ended (0.0 when
    reused). The compiler's output (``-Xptxas -v``: registers, shared
    memory and spills of each kernel) is kept beside the library as
    ``<library>.log``. Raises with that output if any build fails."""
    out, running = {}, {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            out[name] = (lib, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        # the source before the flags: a library flag follows what needs it
        cmd = [nvcc_path(), "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *nvcc_flags(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, lib, tmp)
    failed = []
    for name, (proc, cmd, lib, tmp) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name} (exit "
                          f"{proc.returncode}):\n{' '.join(cmd)}\n{log}")
            continue
        # ptxas -v: each kernel's registers, shared memory and spills
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial
        out[name] = (lib, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path and the seconds the compile took (0.0 when reused)."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    lib, _ = build(name)
    cdll = ctypes.CDLL(str(lib))
    err = getattr(cdll, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return cdll


def check_launch(name: str, rc: int) -> None:
    """Raise if the C entry point of ``name`` returned non-zero: a
    negative code is an argument the kernel does not take, a positive one
    the ``cudaGetLastError()`` of the launch."""
    if rc == 0:
        return
    msg = ("arguments the kernel does not take" if rc < 0 else
           getattr(load(name), f"{name}_error_string")(rc).decode())
    raise RuntimeError(f"{name} launch failed ({rc}): {msg}")

"""Build and load the port's CUDA kernels.

Every ``attwarp_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, never at import, and only from the
sources in this checkout. Its output lands in ``build/kernels/`` at the repo
root (listed in ``.gitignore``), named by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from attwarp_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
# C entry points: name -> argtypes (every function returns cudaGetLastError)
_SIGNATURES = {
    # img, map_x, map_y, out, B, H, W, C, H_out, W_out, rows, tile, slots,
    # cap, threads, smem, stream
    "attwarp_warp_resample": [_VOID] * 4 + [_INT] * 12 + [_VOID],
    # g, img, map_x, map_y, grad_img, grad_map_x, grad_map_y, scratch, B, H,
    # W, C, H_out, W_out, stream
    "attwarp_warp_resample_backward": [_VOID] * 8 + [_INT] * 6 + [_VOID],
    # B, H, W, H_out, W_out, need_img, need_map_x, bytes (long long*)
    "attwarp_warp_resample_backward_scratch_bytes": [_INT] * 7 + [_VOID],
    # count (int*): the kernels the backward has launched
    "attwarp_warp_resample_backward_kernels": [_VOID],
    # q, k_q, k_s, v_q, v_s, mask, out, scratch, L, B, S, H, kvH, hd, layer,
    # n_split, chunk, sm_scale, stream
    "attwarp_decode_attn_int8": [_VOID] * 8 + [_INT] * 9
    + [ctypes.c_float, _VOID],
    # q, k, v, mask, out, B, T, H, kvH, hd, sm_scale, stream
    "attwarp_flash_prefill": [_VOID] * 5 + [_INT] * 5 + [ctypes.c_float, _VOID],
    # x, rows, L, elem_bytes, scale, stream
    "attwarp_attn_softmax": [_VOID, ctypes.c_longlong, _INT, _INT, ctypes.c_float, _VOID],
    # q, k, v, cos, sin, q_out, k_q, k_s, v_q, v_s, pos, pos0, L, B, S, H,
    # kvH, hd, layer, elem_bytes, stream
    "attwarp_rope_append_int8": [_VOID] * 11 + [ctypes.c_longlong] + [_INT] * 8 + [_VOID],
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of attwarp_tpu_torch cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libattwarp_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands all at once; raise with the output of any that
    failed. Returns their combined stdout and stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists.
    ``verbose`` adds ``-Xptxas -v`` and prints nvcc's report (registers,
    shared memory and spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    cus = [p for p in _sources() if p.suffix == ".cu"]
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    objs = [os.path.join(work, p.stem + ".o") for p in cus]
    tmp = os.path.join(work, out.name)
    try:
        report = _run([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                        "-c", str(src), "-o", obj] for src, obj in zip(cus, objs)])
        _run([[nvcc, "-shared", "-o", tmp, *objs]])
        if verbose:
            print(report, flush=True)
        os.replace(tmp, out)   # atomic: a reader never sees a partial file
        profiling.count("kernels.library_builds")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes and
    restype declared for every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(rc: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaGetLastError``."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def require_cuda(name: str, *tensors) -> None:
    """Every tensor on one CUDA device, contiguous and 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")

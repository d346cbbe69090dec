"""Binding of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces ``src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm``; the source's
header says what bounds it on the H100 and how its design answers that. The
launch geometry is chosen here, where the CPU tests reach it
(:func:`geometry`): which path (16-byte vectors or one value a load), how
many loads a thread keeps of its row, warps a row and rows a block. Every
launch sets programmatic dependent launch (:data:`PDL`). The launch is one
``ctypes`` call whose ``argtypes`` are set once; nothing is compiled or
loaded when the module is imported."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

PDL = True            # every launch sets programmatic stream serialization
SMS = 132             # streaming multiprocessors of an H100 SXM
MAX_THREADS = 256     # threads a block
MAX_ROW_WARPS = MAX_THREADS // 32
# loads a thread may keep of its row, as the kernel is compiled: 8 vectors
# of 8 values, or 32 single values
MAX_PER_THREAD = {8: 8, 1: 32}
# bytes of its row a thread takes before the row gets more warps: decode
# rows (at most one per SM) wait on each thread's serial work, so they
# spread thinly; prefill rows are bound by bytes, and fewer, fuller
# threads cost fewer instructions
DECODE_BYTES = 32
PREFILL_BYTES = 64


class Geometry(NamedTuple):
    """One launch: ``vec`` bf16 values a load (8: 16 bytes; 1: the scalar
    path), ``per_thread`` loads a thread keeps of its row, ``row_warps``
    warps a row, ``rows_per_block`` rows a block, and the block and grid
    sizes these give."""

    vec: int
    per_thread: int
    row_warps: int
    rows_per_block: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def geometry(n: int, d: int, aligned: bool = True) -> Geometry:
    """The launch for ``n`` rows of ``d``: 16-byte vectors where ``d`` is a
    multiple of 8 and every pointer is 16-byte aligned, else one value a
    load. Decode rows (``n <= SMS``) take ``DECODE_BYTES`` of the row a
    thread, prefill rows ``PREFILL_BYTES``: a row gets the fewest warps (1,
    2, 4 or 8) that hold it so, or 8 warps with up to ``MAX_PER_THREAD``
    loads each. One row a block, but two where a prefill row has one warp.
    Raises ``ValueError`` for a row wider than 8 warps hold (d > 16,384, or
    8,192 on the scalar path). Chosen from ``chip_smoke.py``'s sweep of
    every geometry (PERF.md §6)."""
    vec = 8 if d % 8 == 0 and aligned else 1
    units = d // vec
    decode = n <= SMS
    target = (DECODE_BYTES if decode else PREFILL_BYTES) // (2 * vec)
    warps = 1
    while warps < MAX_ROW_WARPS and warps * 32 * target < units:
        warps *= 2
    per = -(-units // (32 * warps))
    if per > MAX_PER_THREAD[vec]:
        raise ValueError(f"rmsnorm: d={d} is wider than the kernel's rows "
                         f"({MAX_ROW_WARPS * 32 * MAX_PER_THREAD[vec] * vec})")
    if vec == 1:                         # the scalar path: 1, 2, 4, ... 32
        per = 1 << (per - 1).bit_length()
    rows = 1 if decode or warps > 1 else 2
    return Geometry(vec, per, warps, rows, 32 * warps * rows, -(-n // rows))


_lib = None


def _bound() -> ctypes.CDLL:
    """The kernel library with the ``argtypes`` of its three functions."""
    global _lib
    if _lib is None:
        lib = _build.load()
        for name, args in (
                ("rmsnorm_bf16", [_P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                                  ctypes.c_float, _I, _I, _I, _I, _I, _P]),
                ("rmsnorm_empty", [_I, _P]),
                ("rmsnorm_programmatic_edges", [_P])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = _I
        _lib = lib
    return _lib


def rmsnorm(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
            eps: float, residual: Optional[torch.Tensor] = None,
            out_sum: Optional[torch.Tensor] = None) -> None:
    """x, out (and residual, out_sum): [..., d] contiguous bf16 on one CUDA
    device, at least one row; w: [d] bf16. Writes ``out`` (and ``out_sum =
    x + residual``, the norm then reading the fp32 sum). Launches on the
    current stream, read as a raw handle as PyTorch's compiled kernels read
    it (:func:`current_stream`; ``torch.cuda.current_stream()`` builds a
    Stream object, several microseconds a call)."""
    d = x.shape[-1]
    n = x.numel() // d
    px, pw, py = x.data_ptr(), w.data_ptr(), out.data_ptr()
    pr = ps = 0
    if residual is not None:
        pr, ps = residual.data_ptr(), out_sum.data_ptr()
    g = geometry(n, d, (px | pw | py | pr | ps) % 16 == 0)
    err = (_lib or _bound()).rmsnorm_bf16(
        px, pr, pw, py, ps, n, d, eps, g.vec, g.per_thread, g.row_warps,
        g.rows_per_block, PDL, current_stream(x))
    if err:
        _build.check(err, "rmsnorm")


def current_stream(x: torch.Tensor) -> int:
    """The current stream of ``x``'s device as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def empty(pdl: bool, stream: int) -> None:
    """Launch the empty kernel of one block (the launch floor) on
    ``stream``, with programmatic dependent launch or without."""
    _build.check(_bound().rmsnorm_empty(int(pdl), stream), "rmsnorm_empty")


def programmatic_edges(graph: int) -> int:
    """The programmatic edges of a captured ``cudaGraph_t`` (an address, as
    ``torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()`` gives it)."""
    count = _bound().rmsnorm_programmatic_edges(graph)
    if count < 0:
        raise RuntimeError("rmsnorm: the graph's edges could not be read")
    return count

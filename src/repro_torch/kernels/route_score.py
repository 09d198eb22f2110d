"""Fused (B, N) routing-score matrix: the CUDA kernel's wrapper.

The kernel (``csrc/route_score.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/route_score.py``: it prices each (request,
server) pair (eq. 5 transmission, the residency-gated eq. 7 switch, eq. 9
compute, the spill surcharge and the ``+inf`` visibility mask), one score
a thread on small calls and, on large panels, V consecutive servers a
thread written as one 16-byte vector (``plan``). Its
plain version is ``ref.route_score_ref``; the two agree bitwise in
float32 and float64 (the kernel rounds every operation to nearest,
contracts nothing and rounds every quotient correctly).

This wrapper takes CUDA tensors only. It checks devices, shapes and
types, passes every column that is already in the kernel's type and
layout as it is (bool masks as bytes, int32 ids), plans the grid
(``plan``), allocates the output and launches once on PyTorch's current
stream of the tensors' device. ``eta`` and ``beta`` fold into the kernel
when they are in the columns' type (``folds_eta``, ``folds_beta``);
otherwise ``costs.apply_eta_beta`` folds them first, as the plain
version does. The C entry point takes its arguments packed in one int64
array, one ctypes argument. The library is built by
``cuda_build`` on the first launch of the process.
``route_score.launches`` counts launches.
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.kernels import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_BYTES = (torch.bool, torch.uint8)   # read in place as bytes
THREADS = 256        # threads a block at most (kThreads in the source)
MAX_TX = 32          # column groups of a tile at most (kMaxTx)
BLOCKS_PER_SM = 2    # blocks an SM holds (the kernel caps itself at 128 registers)

# the current stream as a raw pointer without building a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class Plan(NamedTuple):
    """The launch of one call: ``blocks`` blocks of ``tx`` x ``ty``
    threads. ``direct``: one score a thread over the b*n outputs in
    row-major order. Else each thread writes ``vec`` servers of a row, a
    block covers a tile of ``tx * vec`` servers, and block j is tile
    j % ``col_tiles`` over the rows [s * strip_rows, (s + 1) * strip_rows)
    of strip s = j // ``col_tiles``."""
    direct: bool
    vec: int
    tx: int
    ty: int
    col_tiles: int
    strip_rows: int
    blocks: int

    @property
    def threads(self) -> int:
        return self.tx * self.ty

    @property
    def strips(self) -> int:
        return self.blocks // self.col_tiles


def direct_plan(b: int, n: int) -> Plan:
    """One score a thread, ``THREADS`` threads a block."""
    return Plan(True, 1, 1, THREADS, 1, 0, max(1, -(-b * n // THREADS)))


def staged_plan(b: int, n: int, out_dtype: torch.dtype, sms: int) -> Plan:
    """Column tiles x row strips for a (b, n) output of ``out_dtype`` on
    ``sms`` SMs: one 16-byte vector a thread (V = 4 float32, 2 float64, 8
    bf16), at most ``MAX_TX`` column groups across a block, and about
    ``BLOCKS_PER_SM`` blocks an SM (fewer when there are fewer than ``ty``
    rows for each), each over an equal strip of rows."""
    vec = 16 // out_dtype.itemsize
    groups = -(-n // vec)
    tx = max(1, min(groups, MAX_TX))
    ty = THREADS // tx
    col_tiles = max(1, -(-groups // tx))
    strips = max(1, min(-(-b // ty), sms * BLOCKS_PER_SM // col_tiles))
    strip_rows = max(1, -(-b // strips))
    return Plan(False, vec, tx, ty, col_tiles, strip_rows,
                col_tiles * -(-max(b, 1) // strip_rows))


@functools.lru_cache(maxsize=256)
def plan(b: int, n: int, out_dtype: torch.dtype, sms: int) -> Plan:
    """The kernel's path for a (b, n) output: the staged one when its
    strips hold more rows than a block has row groups (the rows then
    share each server's reciprocals), else one score a thread (the
    router's (256, 64) chunks)."""
    p = staged_plan(b, n, out_dtype, sms)
    if p.strip_rows <= p.ty and b * n < 2**31:
        return direct_plan(b, n)
    return p


def in_dtype(out_dtype: torch.dtype, dtypes) -> torch.dtype:
    """The type the kernel reads its float columns in, from the output's
    type and the columns' ``dtypes``: bf16 when all are bf16 (math in
    float32), else the plain version's compute type, to which every
    column is converted first."""
    if out_dtype == torch.bfloat16 and all(d == out_dtype for d in dtypes):
        return torch.bfloat16
    return torch.promote_types(out_dtype, torch.float32)


def folds_eta(eta, prompt_bits, work, read_dtype, b: int) -> bool:
    """True when the kernel multiplies by ``eta`` itself and rounds as
    ``costs.apply_eta_beta`` does: eta a (B,) tensor, and eta, prompt and
    work all in the type the kernel reads. Otherwise the product's type
    (the promoted type of column and eta) is not one the kernel rounds
    to, and the wrapper folds on the host."""
    return (isinstance(eta, torch.Tensor) and eta.shape == (b,)
            and eta.dtype == read_dtype and prompt_bits.dtype == read_dtype
            and work.dtype == read_dtype)


def folds_beta(beta, b: int) -> bool:
    """True when the kernel reads ``beta`` as it is: a (B,) bool tensor."""
    return (isinstance(beta, torch.Tensor) and beta.dtype == torch.bool
            and beta.shape == (b,))


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("route_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.route_score_launch.argtypes = [p, p]       # packed args, stream
    lib.route_score_launch.restype = i
    lib.route_score_empty_launch.argtypes = [i, i, i, p]
    lib.route_score_empty_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def route_score(
    prompt_bits, size_bits, flops_tok, work,
    uplink_bps, backhaul_bps, flops_per_s,
    queue_tokens=None, resident=None, model=None,
    req_cell=None, srv_cell=None, spill=None, eta=None, beta=None,
    *, cloud_cell: int = -1,
):
    """Launch the fused eq. 11 kernel; same arguments and result as
    ``ref.route_score_ref`` (``cloud_cell`` keyword-only here, as in the
    reference's kernel wrapper). Raises on CPU tensors, mixed devices,
    wrong shapes, an unsupported type or a refused launch."""
    dev = prompt_bits.device
    if dev.type != "cuda":
        raise ValueError(
            "the route_score kernel takes CUDA tensors; ops.route_score "
            "sends CPU tensors to the plain version"
        )
    out, args, keep = _prepare(
        dev, _sms(dev.index), prompt_bits, size_bits, flops_tok, work,
        uplink_bps, backhaul_bps, flops_per_s, queue_tokens, resident,
        model, req_cell, srv_cell, spill, eta, beta, cloud_cell)
    if out.numel() == 0:
        return out
    packed = array.array("q", args)
    rc = _library().route_score_launch(packed.buffer_info()[0],
                                       _stream(dev.index))
    del keep  # the tensors the kernel reads lived until it was enqueued
    cuda_build.check_launch("route_score", rc)
    route_score.launches += 1
    return out


route_score.launches = 0


def launch_floor(b: int, n: int, out_dtype: torch.dtype, device) -> None:
    """Launch the library's empty kernel on the grid ``route_score`` plans
    for a (b, n) output of ``out_dtype``, the same way: the floor its
    times are read against. Not counted in ``route_score.launches``."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p = plan(b, n, out_dtype, _sms(index))
    rc = _library().route_score_empty_launch(p.blocks, p.threads, index,
                                             _stream(index))
    cuda_build.check_launch("route_score", rc)


def _bytes(x):
    if x is None or (x.dtype in _BYTES and x.is_contiguous()):
        return x
    return x.to(torch.uint8).contiguous()


def _ints(x):
    if x is None or (x.dtype == torch.int32 and x.is_contiguous()):
        return x
    return x.to(torch.int32).contiguous()


def _on(x, dev, what):
    if x.device != dev:
        raise ValueError(f"route_score: {what} on {x.device}, expected {dev}")


def _shaped(x, shape, what):
    if x.shape != shape:
        raise ValueError(f"route_score: {what} of shape {tuple(x.shape)}, "
                         f"expected {shape}")


@functools.lru_cache(maxsize=64)
def _types(prompt: torch.dtype, uplink: torch.dtype, dtypes: tuple):
    """(read type, output type) of a call from the columns' types."""
    out = torch.promote_types(prompt, uplink)
    if out not in _DTYPE_CODES:
        raise TypeError(f"route_score: unsupported type {out}")
    return in_dtype(out, dtypes), out


def _prepare(dev, sms, prompt_bits, size_bits, flops_tok, work, uplink_bps,
             backhaul_bps, flops_per_s, queue_tokens, resident, model,
             req_cell, srv_cell, spill, eta, beta, cloud_cell):
    """Check the arguments, fold what the kernel does not, and return the
    output, the C entry point's packed arguments (the enum ``Arg`` of the
    source) and the tensors they point into. Columns no term reads
    (``flops_tok`` without a queue, ``backhaul_bps`` without a size
    column or spill) are not passed, as the plain version ignores them."""
    b, n = prompt_bits.shape[0], uplink_bps.shape[0]
    index = dev.index
    has_switch = size_bits is not None
    has_cells = req_cell is not None and srv_cell is not None
    if has_switch and resident is not None and model is None:
        raise ValueError("resident gating requires the request model ids")
    if queue_tokens is None:
        flops_tok = None
    if not has_switch and not (has_cells and spill is not None):
        backhaul_bps = None
    if eta is not None or beta is not None:
        prompt_bits, size_bits, work, eta, beta = _knobs(
            dev, b, prompt_bits, size_bits, work, eta, beta,
            (flops_tok, uplink_bps, backhaul_bps, flops_per_s, queue_tokens))
    cols = (prompt_bits, size_bits, flops_tok, work, eta,
            uplink_bps, backhaul_bps, flops_per_s, queue_tokens)
    read, out_dtype = _types(prompt_bits.dtype, uplink_bps.dtype, tuple(
        x.dtype for x in cols if x is not None))
    args = [_DTYPE_CODES[read], _DTYPE_CODES[out_dtype]]
    keep = []
    for i, x in enumerate(cols):
        if x is None:
            args.append(0)
            continue
        shape = (b,) if i < 5 else (n,)
        if x.get_device() != index or x.shape != shape:
            what = "request column" if i < 5 else "server column"
            _on(x, dev, what)
            _shaped(x, shape, what)
        if x.dtype != read or not x.is_contiguous():
            x = x.to(read).contiguous()
        keep.append(x)
        args.append(x.data_ptr())

    k = c = 0
    res_b = model_i = rc_i = sc_i = spill_b = None
    if has_switch and resident is not None:
        if resident.dim() != 2 or resident.shape[0] != n or not resident.shape[1]:
            raise ValueError(f"route_score: resident of shape "
                             f"{tuple(resident.shape)}, expected ({n}, K), K > 0")
        _on(resident, dev, "resident")
        _on(model, dev, "model")
        _shaped(model, (b,), "model")
        k = resident.shape[1]
        res_b, model_i = _bytes(resident), _ints(model)
    if has_cells:
        _on(req_cell, dev, "req_cell")
        _on(srv_cell, dev, "srv_cell")
        _shaped(req_cell, (b,), "req_cell")
        _shaped(srv_cell, (n,), "srv_cell")
        rc_i, sc_i = _ints(req_cell), _ints(srv_cell)
        if spill is not None:
            c = spill.shape[0]
            _on(spill, dev, "spill")
            _shaped(spill, (c, c), "spill")
            spill_b = _bytes(spill)
    beta = _bytes(beta)
    for x in (res_b, beta, spill_b, model_i, rc_i, sc_i):
        args.append(0 if x is None else x.data_ptr())
    keep += [res_b, beta, spill_b, model_i, rc_i, sc_i]
    out = torch.empty(b, n, dtype=out_dtype, device=dev)  # sizes as arguments: parsed faster
    p = plan(b, n, out_dtype, sms)
    args += [out.data_ptr(), k, c, int(cloud_cell), b, n,
             int(p.direct), p.blocks, p.tx, p.ty, p.col_tiles, p.strip_rows,
             -1 if index is None else index]
    return out, args, keep


def _knobs(dev, b, prompt_bits, size_bits, work, eta, beta, others):
    """eta and beta as the kernel takes them: left to the kernel when it
    reads them in their type, else folded here by ``apply_eta_beta``
    (beta without size_bits raises there, as in the plain version).
    ``others`` are the other float columns the kernel is passed."""
    for x, what in ((eta, "eta"), (beta, "beta")):
        if isinstance(x, torch.Tensor):
            _on(x, dev, what)
    if eta is not None:
        out_dtype = torch.promote_types(prompt_bits.dtype, others[1].dtype)
        read = in_dtype(out_dtype, [x.dtype for x in (
            prompt_bits, size_bits, work, *others) if x is not None])
        if not folds_eta(eta, prompt_bits, work, read, b):
            prompt_bits, _, work = costs.apply_eta_beta(
                prompt_bits, None, work, eta, None)
            eta = None
    if beta is not None and (size_bits is None or not folds_beta(beta, b)):
        _, size_bits, _ = costs.apply_eta_beta(
            prompt_bits, size_bits, work, None, beta)
        beta = None
    return prompt_bits, size_bits, work, eta, beta

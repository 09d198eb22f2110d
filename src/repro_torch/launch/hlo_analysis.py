"""Op-level cost analysis for the roofline (counterpart of
``repro.launch.hlo_analysis``; the module keeps its name and its result's
keys so one reader takes the records of both packages).

There is no HLO here. PyTorch runs eagerly, so the analysis counts the
operations a call dispatches, through a ``TorchDispatchMode``, on real
tensors on any device or on fake ones (``FakeTensorMode``, a ``fake``
process group), with no while loops to multiply out: a loop runs its
body as many times as it runs.

* ``flops``: the matrix-product family only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``dot``: what ``matmul``, ``einsum`` and
  ``linear`` lower to), at 2 * prod(out) * contraction each: the
  reference's ``_dot_flops``, which counts ``dot``s only (no
  convolution, no elementwise work).
* ``hbm_bytes``: every dispatched op's tensor operands plus its outputs;
  views, factories that write nothing (``empty``), ``prim`` ops and
  collective waits count nothing. The eager counterpart of the
  reference's per-top-level-instruction model (an eager op is one
  round trip through memory).
* ``collective_bytes``: per-rank link traffic by the reference's ring
  formulas (``collective_bytes``), for the ``_c10d_functional`` ops
  (``DTensor``) and the ``c10d`` ops (``torch.distributed`` calls such
  as ``sharding.all_reduce``); ``collective_counts`` splits it by kind.

The port's kernels are counted at the ``kernels.ops`` boundary, whatever
device runs them: a CUDA kernel is a ctypes launch no dispatch mode sees,
and on the CPU its plain version is aten ops. While an analysis runs,
each ``ops`` entry point reports itself (``ops._observer``): its flops
are ``kernel_flops``, the dots the reference's dry-run counts for the
XLA version its ``ops`` runs on the CPU, its bytes its operands plus its
outputs, and the ops inside the call are not counted. An autograd
Function's backward runs outside the entry point and is counted op by op.

``xla_cost_analysis`` has no counterpart: there is no compiled module to
ask.
"""
from __future__ import annotations

import contextlib
import inspect
import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import ops

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default: "mm", _aten.addmm.default: "addmm",
            _aten.bmm.default: "bmm", _aten.baddbmm.default: "baddbmm",
            _aten.mv.default: "mv", _aten.dot.default: "dot"}
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "wait_tensor",
         "_local_scalar_dense", "set_", "resize_", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset"}
# collective op -> kind; a ``_c10d_functional`` op returns its output, a
# ``c10d`` op writes it into its first argument
_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
}


def collective_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Per-rank link bytes of one collective whose output (this rank's)
    is ``out_bytes``, over a group of ``g``: the reference's ring
    formulas (``HloModule._collective_bytes``), including its
    reduce-scatter factor ``g - 1`` on the scattered output and
    collective-permute at 1x. A group of one moves nothing."""
    if g <= 1:
        return 0.0
    scale = {
        "all-reduce": 2.0 * (g - 1) / g,
        "all-gather": (g - 1) / g,
        "reduce-scatter": float(g - 1),  # output is the scattered shard
        "all-to-all": (g - 1) / g,
        "collective-permute": 1.0,
    }[kind]
    return out_bytes * scale


def _nbytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a ``DTensor``: its local shard)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = getattr(t, "_local_tensor", t)
            total += t.numel() * t.element_size()
    return total


def kernel_flops(name: str, a: dict) -> float:
    """Flops of one ``ops`` entry point's call, its arguments by name: the
    dots of the reference's XLA version (``repro/kernels/ref.py``) as its
    ``analyze`` counts them.

    * ``attention`` (``attention_xla``): QK^T and PV over every (query,
      key) pair, masked or not: 4 B H Sq Sk D.
    * ``decode_attention`` (``decode_attention_naive``): the same over the
      whole cache, whatever ``pos``: 4 B H S D; ``decode_attention_partial``
      the same over the rank's piece of it: 4 B H S_local D.
    * ``ssd`` (``ssd_chunked_xla``): S padded to whole chunks of Q, each
      chunk's four dots (C B^T, the intra-chunk product, the carried
      state's read and its update): nc 2 B Q (Q N + Q H P + 2 H P N).
    * ``ssd_decode`` (``ssd_decode_naive``): the state's read, 2 B H P N
      (XLA makes the outer-product update a multiply).
    * ``rmsnorm``, ``causal_conv``, ``route_score``: no dot."""
    if name == "attention":
        b, sq, h, d = a["q"].shape
        return 4.0 * b * h * sq * a["k"].shape[1] * d
    if name in ("decode_attention", "decode_attention_partial"):
        b, _, h, d = a["q"].shape
        return 4.0 * b * h * a["k"].shape[1] * d
    if name == "ssd":
        b, s, h, p = a["x"].shape
        n, q = a["b"].shape[-1], a["chunk"]
        return -(-s // q) * 2.0 * b * q * (q * n + q * h * p + 2 * h * p * n)
    if name == "ssd_decode":
        b, h, p, n = a["state"].shape
        return 2.0 * b * h * p * n
    return 0.0


class Analysis(TorchDispatchMode):
    """The counts of one analysis (``counting`` opens it). ``result()``
    is ``analyze``'s dict; ``by_op`` splits the flops by op family (an
    ``ops`` entry point as ``ops.<name>``) and ``kernel_calls`` counts the
    ``ops`` calls."""

    def __init__(self):
        super().__init__()
        self.flops = self.hbm = self.coll = 0.0
        self.counts = defaultdict(float)
        self.by_op = defaultdict(float)
        self.kernel_calls = defaultdict(int)
        self._inside = 0

    def result(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm,
                "collective_bytes": self.coll,
                "collective_counts": dict(self.counts),
                "by_op": dict(self.by_op),
                "kernel_calls": dict(self.kernel_calls)}

    def kernel(self, name, fn, args, kwargs):
        """One ``ops`` entry point's call: counted by formula, the ops it
        dispatches not counted."""
        bound = inspect.signature(fn).bind(*args, **kwargs)
        bound.apply_defaults()
        self._inside += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._inside -= 1
        if not self._inside:
            f = kernel_flops(name, bound.arguments)
            self.flops += f
            self.by_op[f"ops.{name}"] += f
            self.hbm += _nbytes((args, kwargs)) + _nbytes(out)
            self.kernel_calls[name] += 1
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._inside:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        ns, name = func.namespace, func._opname
        kind = _COLLECTIVE_OPS.get((ns, name))
        if kind is not None:
            size = _nbytes(out if ns == "_c10d_functional" else args[0])
            b = collective_bytes(kind, size, _group_size(func, args, kwargs))
            self.coll += b
            self.counts[kind] += b
            return
        if ns == "prim" or func.is_view or name in _FREE:
            return
        op = _MATMULS.get(func)
        if op is not None:
            f = _matmul_flops(func, args, out)
            self.flops += f
            self.by_op[op] += f
        self.hbm += _nbytes((args, kwargs)) + _nbytes(out)


def _matmul_flops(func, args, out) -> float:
    """2 * prod(out) * contraction; the contraction is the last dimension
    of the first matrix operand (``addmm``/``baddbmm``: after the bias)."""
    lhs = args[1] if func in (_aten.addmm.default, _aten.baddbmm.default) \
        else args[0]
    return 2.0 * math.prod(out.shape) * lhs.shape[-1]


def _group_size(func, args, kwargs) -> int:
    """The group size of a collective, from its arguments by name: a
    ``c10d`` op carries the process group, a ``_c10d_functional`` op its
    size or its name."""
    from torch.distributed import distributed_c10d as c10d

    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    if "process_group" in named:
        return c10d.ProcessGroup.unbox(named["process_group"]).size()
    if "group_size" in named:
        return named["group_size"]
    return c10d._resolve_process_group(named["group_name"]).size()


@contextlib.contextmanager
def counting():
    """Count every op dispatched in the block (on this thread and in the
    autograd engine's) and every ``ops`` entry point's call; yields the
    ``Analysis``. Analyses do not nest."""
    if ops._observer is not None:
        raise RuntimeError("an analysis is already running")
    mode = Analysis()
    ops._observer = mode.kernel
    try:
        with mode:
            yield mode
    finally:
        ops._observer = None


def analyze(fn, *args, **kwargs) -> dict:
    """``{"flops", "hbm_bytes", "collective_bytes", "collective_counts",
    "by_op", "kernel_calls"}`` of ``fn(*args, **kwargs)``."""
    with counting() as mode:
        fn(*args, **kwargs)
    return mode.result()

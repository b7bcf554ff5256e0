"""Per-device cost analysis of one step, from the torch dispatch trace.

Ports `repro/launch/hlo_analysis.py`.  The reference parses compiled
(post-SPMD) HLO text; torch produces none, so this module reads what the
step dispatches instead: a `TorchDispatchMode` sees every aten op that runs
on a local tensor, including the local ops a DTensor op lowers to and the
functional collectives its redistributions issue (it lets DTensor ops pass,
as ``CommDebugMode`` does, and counts what they lower to).  It produces the
reference's keys:

  * ``coll/<op>``  — per-device bytes moved by all-gather / all-reduce /
    reduce-scatter / all-to-all / collective-permute (each collective's
    local result bytes); ``collective_bytes`` sums them;
  * ``largest_collective_bytes`` — the largest single collective's local
    result: a tensor the step holds on the device at one moment, so a lower
    bound on its temporaries (on a mesh, a gathered vocab or table);
  * ``dot_flops``  — the FLOPs of every product (matmul, bmm, convolution,
    attention: `torch.utils.flop_counter`'s formulas) on LOCAL shapes;
  * ``hbm_bytes``  — HBM-traffic proxy: the local input and output bytes of
    every op that is not a view.  In eager mode every op is a fusion
    boundary: each op reads its inputs from and writes its outputs to
    device memory, so this counts what eager execution moves (a compiler
    that fuses elementwise chains would move less);
  * ``dynamic_trip_warnings`` — always 0: an eager loop runs unrolled, so
    every trip is dispatched and counted.

All counts are PER DEVICE, as in the reference's partitioned HLO: a
replicated product counts its full FLOPs on every device (which is how the
roofline's ``useful_ratio`` catches redundant compute), a column-sharded
one its local share.  Run the step on ``meta`` tensors on a fake process
group (`launch/dryrun.py`) and nothing is computed or moved.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["analyze_step", "HloSummary", "COLLECTIVE_OPS", "tensor_bytes"]

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# collective op name (functional and c10d) -> the reference's kind
_COLLECTIVE_NAMES = (
    ("reduce_scatter", "reduce-scatter"),
    ("all_gather", "all-gather"),
    ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
    ("permute", "collective-permute"),
    ("send", "collective-permute"),
    ("recv", "collective-permute"),
)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                          "_dtensor")
# ops that move nothing: metadata, waits and tensor aliases
_FREE_OPS = {"detach", "alias", "lift_fresh", "_local_scalar_dense", "wait_tensor",
             "set_", "resize_", "empty", "empty_strided", "empty_like", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size"}


class HloSummary(dict):
    @property
    def collective_bytes(self) -> float:
        return sum(v for k, v in self.items() if k.startswith("coll/"))


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a DTensor's local shard; a
    module's parameters)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.nn.Module):
            total += tensor_bytes(list(t.parameters()))
            continue
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    for key, kind in _COLLECTIVE_NAMES:
        if key in name:
            return kind
    return None


class _Counter(TorchDispatchMode):
    def __init__(self, summary: HloSummary):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.summary = summary
        self.flops = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        # let DTensor lower its op and count the local ops
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs ops on fake tensors: not a step's
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        s = self.summary
        kind = _collective_kind(func)
        if kind is not None:
            nbytes = tensor_bytes(out)
            s[f"coll/{kind}"] += nbytes
            s["largest_collective_bytes"] = max(s["largest_collective_bytes"], nbytes)
            return out
        name = func._schema.name.split("::")[-1]
        if func.overloadpacket in self.flops:
            s["dot_flops"] += float(self.flops[func.overloadpacket](*args, **kwargs,
                                                                    out_val=out))
        if not func.is_view and name not in _FREE_OPS:
            s["hbm_bytes"] += tensor_bytes((args, kwargs)) + tensor_bytes(out)
        return out


def analyze_step(fn, *args, **kwargs) -> HloSummary:
    """Run ``fn(*args, **kwargs)`` once and count its per-device work.
    Returns the summary; the step's own result is dropped."""
    summary = HloSummary()
    summary.update({f"coll/{op}": 0.0 for op in COLLECTIVE_OPS})
    summary["dot_flops"] = 0.0
    summary["hbm_bytes"] = 0.0
    summary["dynamic_trip_warnings"] = 0.0
    summary["largest_collective_bytes"] = 0.0
    with _Counter(summary):
        fn(*args, **kwargs)
    return summary

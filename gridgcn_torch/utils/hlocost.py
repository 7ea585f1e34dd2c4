"""Honest per-kernel HBM traffic attribution of a `torch.export` program
(the JAX package's `utils/hlocost.py`, on the exported graph in place of
optimized HLO).

Eager PyTorch launches about one kernel per ATen node of the graph, so a
node plays the part of an HLO ENTRY instruction. Every node that launches
a kernel is charged its operand + output bytes (shapes and dtypes from
each node's `meta["val"]`), with gathers and scatters discounted to what
they actually touch:

  * gather (`index`, `gather`, `index_select`, `embedding`,
    `take_along_dim`) — the table operand charged rows × row bytes,
    capped at the table size; indices + output charged in full.
  * scatter (`index_put`, `scatter`, `scatter_add`, `scatter_reduce`,
    `index_add`) — indices + updates read + the written rows; the base is
    updated in place (its dense init was charged at its producer), and
    neither it nor the full output is charged. Rows are counted in the
    updates' own elements, whatever their width.
  * sort (`sort`, `topk`, `argsort`), dot (`mm`, `bmm`, `addmm`, `linear`,
    `matmul`, `einsum`) and custom-call (the `gridgcn::` kNN and draw
    ops: inputs + outputs; the kernel's internal traffic is not expanded)
    are classified so callers can price them at their own measured rates;
    every other node is a one-op "fusion".

Nodes that launch no kernel are skipped: placeholders, outputs,
`getitem`, ops whose schema returns a view of an input (views, `expand`,
`permute`, `slice`, in-place metadata ops such as `detach_`), and
`reshape` / `contiguous` / `to` where the output can be that view.

On this card a gather or scatter is not priced by a descriptor rate: each
row moves at least one DRAM sector (`hw.SECTOR_BYTES`), so its cost is
already in the sector-rounded touched bytes and `floor_ms`'s row term is
0. Each row also carries the operations the node does on the tensor
cores or CUDA cores (dots: 2·m·n·k; the kNN ops: their per-pair counts),
the port's counterpart of XLA's `cost_analysis()["flops"]`.

    import gridgcn_torch.kernels.knn   # the custom ops, before loading
    import gridgcn_torch.kernels.rng
    rows = attribute(torch.export.load("model.pt2"))
    class_totals(rows), floor_ms(rows)
"""

from __future__ import annotations

import collections
import math
import operator

import torch
from torch.utils._pytree import tree_leaves

from gridgcn_torch.utils.hw import (
    BF16_OPS_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S, SECTOR_BYTES)

_GATHER = ("index", "gather", "index_select", "embedding", "take_along_dim")
_SCATTER = ("index_put", "scatter", "scatter_add", "scatter_reduce",
            "index_add")
_SORT = ("sort", "topk", "argsort")
_DOT = ("mm", "bmm", "addmm", "linear", "matmul", "einsum")
# views by schema that copy when the output cannot be a view of the input
_MAY_COPY = ("to", "contiguous", "reshape")
# operations per (query, support) pair of the kNN custom ops, and the peak
# they run at: split-bf16 distances on the tensor cores (16 bf16 MACs),
# exact fp32 distances on the CUDA cores (3 sub + 3 mul + 2 add)
KNN_OPS = {"knn3_mxu": (32, "bf16"), "knn3_exact": (8, "fp32")}
PEAK_OPS_PER_S = {"bf16": BF16_OPS_PER_S, "fp32": FP32_OPS_PER_S}


def _val(x):
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else None


def _tensors(val) -> list[torch.Tensor]:
    return [t for t in tree_leaves(val) if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    """Bytes at distinct addresses: a broadcast (stride-0) dim is read
    once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _out_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _viewable(t: torch.Tensor, shape) -> bool:
    try:
        torch.empty_strided(t.shape, t.stride(), device="meta").view(shape)
    except RuntimeError:
        return False
    return True


def _out_of_place(name: str) -> str:
    """`add_` -> `add`, `__iand__` -> `__and__`."""
    if name.startswith("__i") and name.endswith("__"):
        return "__" + name[3:]
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _launches(node, base: str, ins, outs) -> bool:
    """Whether the node launches a kernel (module docstring)."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return True
    alias = [r.alias_info for r in schema.returns if r.alias_info]
    if not alias:
        return True
    if any(a.is_write for a in alias):
        # in place: a kernel, unless its out-of-place form is a view
        ns = schema.name.split("::")[0]
        try:
            packet = getattr(getattr(torch.ops, ns), base)
            fn = getattr(packet, schema.overload_name or "default")
        except AttributeError:
            return True
        return fn is node.target or not any(
            r.alias_info for r in fn._schema.returns)
    if base not in _MAY_COPY or not ins:
        return False
    src, out = ins[0], outs[0]
    if src.dtype != out.dtype or src.device != out.device:
        return True
    if base == "contiguous":
        return not src.is_contiguous()
    if base == "reshape":
        return not _viewable(src, out.shape)
    return False


def _last_indexed(indices) -> int:
    return max(i for i, x in enumerate(indices) if x is not None)


def _row_elems(base: str, node, table: torch.Tensor) -> int:
    """Elements of one gathered or scattered row of `table`."""
    args = node.args
    if base in ("index", "index_put"):
        return math.prod(table.shape[_last_indexed(args[1]) + 1:])
    if base in ("index_select", "index_add"):
        return math.prod(table.shape[args[1] % table.dim() + 1:])
    if base == "embedding":
        return math.prod(table.shape[1:])
    return 1          # gather, take_along_dim, scatter*: elements


def _written_elems(base: str, node, table: torch.Tensor) -> int:
    """Elements of the base a scatter writes."""
    args = node.args
    if base == "index_put":
        idx = [_val(x) if x is not None else None for x in args[1]]
        shape = torch.broadcast_shapes(*(t.shape for t in idx
                                         if t is not None))
        rest = [s for i, s in enumerate(table.shape)
                if i >= len(idx) or idx[i] is None]
        return math.prod(shape) * math.prod(rest)
    if base == "index_add":
        return _val(args[3]).numel()
    return _val(args[2]).numel()    # scatter*: one element per index


def _dot_flops(base: str, node, ins, outs) -> int:
    """2 · (output elements) · (contracted length)."""
    if base != "einsum":
        return 2 * outs[0].numel() * (
            ins[1] if base == "addmm" else ins[0]).shape[-1]
    eq = node.args[0].replace(" ", "")
    lhs, out = eq.split("->") if "->" in eq else (eq, None)
    sizes = {}
    for spec, t in zip(lhs.split(","), ins):
        pre, _, post = spec.partition("...")
        sizes.update(zip(pre, t.shape))
        sizes.update(zip(post, t.shape[t.dim() - len(post):]))
    if out is None:      # implicit output: the labels seen once, sorted
        counts = collections.Counter(lhs.replace(",", "").replace(".", ""))
        out = "".join(sorted(c for c, n in counts.items() if n == 1))
    k = math.prod(s for c, s in sizes.items() if c not in out)
    return 2 * outs[0].numel() * k


def attribute(program) -> list[dict]:
    """Honest per-node byte/row attribution of an `ExportedProgram` (or its
    `graph_module`; module docstring).

    Returns rows sorted by touched bytes, each: {name, opcode, class,
    bytes (dense), touched, rows, out_bytes, op_name, flops, peak}, where
    `peak` ("bf16" or "fp32") names the rate `floor_ms` prices the flops
    at."""
    gm = getattr(program, "graph_module", program)
    out = []
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        outs = _tensors(node.meta.get("val"))
        if not outs:
            continue
        schema = getattr(node.target, "_schema", None)
        ns, base = (schema.name.split("::") if schema
                    else ("", str(node.target)))
        base = _out_of_place(base)
        operands = [a for a in tree_leaves((node.args, node.kwargs))
                    if isinstance(a, torch.fx.Node)]
        ins = [t for a in operands for t in _tensors(_val(a))]
        if not _launches(node, base, ins, outs):
            continue
        out_b = sum(_out_bytes(t) for t in outs)
        dense = out_b + sum(_bytes(t) for t in ins)
        touched, rows, flops, peak = dense, 0, 0, "fp32"
        klass = "fusion"
        if ns == "gridgcn":
            klass = "custom-call"
            per_pair, peak = KNN_OPS.get(base, (0, "fp32"))
            if per_pair:
                flops = per_pair * ins[0].shape[0] * ins[2].shape[0]
        elif base in _GATHER:
            klass = "gather"
            table = _val(node.args[0])
            row = _row_elems(base, node, table)
            rows = outs[0].numel() // max(1, row)
            row_b = max(row * table.element_size(), SECTOR_BYTES)
            tbl_b = _bytes(table)
            touched -= tbl_b - min(tbl_b, rows * row_b)
        elif base in _SCATTER:
            klass = "scatter"
            table = _val(node.args[0])
            row = _row_elems(base, node, table)
            rows = _written_elems(base, node, table) // max(1, row)
            row_b = max(row * table.element_size(), SECTOR_BYTES)
            # indices + updates read, rows written (capped at the base);
            # not the base, not the full output
            tbl_b = _bytes(table)
            touched = dense - tbl_b - out_b + min(tbl_b, rows * row_b)
        elif base in _SORT:
            klass = "sort"
        elif base in _DOT:
            klass = "dot"
            flops = _dot_flops(base, node, ins, outs)
            peak = ("bf16" if ins[0].dtype in (torch.bfloat16, torch.float16)
                    else "fp32")
        op_name = ""
        stack = node.meta.get("nn_module_stack")
        if stack:
            op_name = list(stack.values())[-1][0]
        out.append({"name": node.name, "opcode": f"{ns}.{base}" if ns
                    else base, "class": klass, "bytes": dense,
                    "touched": max(touched, 0), "rows": rows,
                    "out_bytes": out_b, "op_name": op_name, "flops": flops,
                    "peak": peak})
    out.sort(key=lambda r: -r["touched"])
    return out


def class_totals(rows: list[dict]) -> dict[str, dict]:
    """Aggregate attribution rows by op class."""
    cls: dict[str, dict] = collections.defaultdict(
        lambda: {"n": 0, "dense": 0, "touched": 0, "rows": 0, "flops": 0})
    for r in rows:
        c = cls[r["class"]]
        c["n"] += 1
        c["dense"] += r["bytes"]
        c["touched"] += r["touched"]
        c["rows"] += r["rows"]
        c["flops"] += r["flops"]
    return dict(cls)


def floor_ms(rows: list[dict]) -> dict:
    """Lower bound of the program's device time: touched bytes at the HBM
    rate (`floor_ms` = `bw_ms`). `row_ms` is 0.0: a gathered or scattered
    row's cost is already in its sector-rounded bytes. `flops_ms` prices
    the flops at their peaks (bf16 tensor cores, fp32 CUDA cores) and is
    kept apart from the floor. Sorts and the kNN custom ops are charged
    bytes only (a sort's passes and a kernel's internal traffic are not
    expanded), so this floor is deliberately OPTIMISTIC: measured busy
    time must sit above it."""
    touched = sum(r["touched"] for r in rows)
    nrows = sum(r["rows"] for r in rows)
    flops = sum(r["flops"] for r in rows)
    bw_ms = touched / HBM_BYTES_PER_S * 1e3
    flops_ms = sum(r["flops"] / PEAK_OPS_PER_S[r["peak"]] for r in rows) * 1e3
    return {"touched_bytes": touched, "rows": nrows,
            "bw_ms": bw_ms, "row_ms": 0.0, "floor_ms": bw_ms,
            "flops": flops, "flops_ms": flops_ms}

"""Per-pass contract verifiers of the staged compiler pipeline (DESIGN.md §8).

One verifier per IR the pipeline produces::

    frontend      verify_frontend(dag)            ComputeDag contract
    partition     verify_partition(pir)           consumer adjacency
    cu_assign     verify_assign(air, cfg)         owner/task-list coherence
    psum_schedule verify_schedule(sir, air, cfg)  hazards + completeness
    stall_elide   verify_emit(eir, sir)           elision + envelopes
    pack_emit     verify_packed_program(prog, eir, cfg)  packed roundtrip

Each returns a list of `Diagnostic`s whose ``pass_name`` blames the stage
that broke the invariant — the point of per-pass verification: a violation
found *after* packing (`core.robust.verify_program`) can only say the
program is corrupt, a violation found here says which pass corrupted it.
`compile_dag(verify_ir=True)` (`core/compiler`) runs these after every
stage and raises `IRValidationError` on the first error.

Cross-IR checks (``air``/``sir``/``eir`` context arguments) are optional:
a verifier called with only its own IR still enforces every invariant
derivable from that IR alone, so the verifiers also work on IRs produced
by third-party scheduler passes.
"""

from __future__ import annotations

import numpy as np

from ..errors import IRValidationError
from ..program import OP_EDGE, OP_FINAL, OP_NOP
from .diagnostics import SEV_ERROR, Diagnostic
from .hazards import envelope_diags, packed_structure, trace_hazards
from .trace import view_emit, view_program, view_schedule

__all__ = [
    "verify_frontend",
    "verify_partition",
    "verify_assign",
    "verify_schedule",
    "verify_emit",
    "verify_packed_program",
    "raise_on_errors",
]


def _err(code, message, pass_name, *, cycle=None, cu=None, node=None,
         hint="", **detail):
    return Diagnostic(code=code, severity=SEV_ERROR, message=message,
                      pass_name=pass_name, cycle=cycle, cu=cu, node=node,
                      hint=hint, detail=detail)


def raise_on_errors(diags, stage: str, name: str) -> None:
    """Raise `IRValidationError` naming ``stage`` on the first error."""
    errs = [d for d in diags if d.severity == SEV_ERROR]
    if errs:
        d = errs[0]
        raise IRValidationError(
            f"IR contract violated after pass {stage!r} compiling "
            f"{name!r}: [{d.code}] {d.message}",
            detail={"pass": stage, "code": d.code, "name": name,
                    "diagnostics": [e.to_dict() for e in errs]})


# ---------------------------------------------------------------------------
# frontend: ComputeDag
# ---------------------------------------------------------------------------
def verify_frontend(dag) -> list[Diagnostic]:
    """The `ComputeDag` frontend contract, as diagnostics (SPT118)."""
    try:
        dag.validate()
    except ValueError as e:
        return [_err("SPT118", str(e), "frontend",
                     hint="fix the workload lowering in core/frontends/")]
    return []


# ---------------------------------------------------------------------------
# partition: PartitionIR
# ---------------------------------------------------------------------------
def verify_partition(pir) -> list[Diagnostic]:
    """Consumer adjacency and in-degrees must mirror the DAG exactly."""
    diags: list[Diagnostic] = []
    dag = pir.dag
    n = dag.n
    if len(pir.consumers) != n:
        diags.append(_err("SPT119", f"consumers has {len(pir.consumers)} "
                          f"entries for {n} nodes", "partition"))
        return diags
    if not np.array_equal(np.asarray(pir.in_degree), np.diff(dag.ptr)):
        j = int(np.argmax(np.asarray(pir.in_degree) != np.diff(dag.ptr)))
        diags.append(_err("SPT119", f"in_degree[{j}] diverges from the "
                          f"DAG's edge slices", "partition", node=j))
    # edge multiset: (consumer i, source j) from the adjacency vs the DAG
    cons_i = np.fromiter((i for j in range(n) for i in pir.consumers[j]),
                         dtype=np.int64)
    cons_j = np.repeat(np.arange(n),
                       [len(pir.consumers[j]) for j in range(n)])
    owner_row = np.repeat(np.arange(n), np.diff(dag.ptr))
    a = np.lexsort((cons_j, cons_i))
    b = np.lexsort((dag.src, owner_row))
    if (cons_i.size != dag.n_edges
            or not np.array_equal(cons_i[a], owner_row[b])
            or not np.array_equal(cons_j[a], dag.src[b])):
        diags.append(_err("SPT119", f"consumer adjacency carries "
                          f"{cons_i.size} edges but the DAG has "
                          f"{dag.n_edges}; the scheduler would wake the "
                          f"wrong nodes", "partition",
                          hint="partition pass dropped or invented an "
                               "edge"))
    return diags


# ---------------------------------------------------------------------------
# cu_assign: AssignIR
# ---------------------------------------------------------------------------
def verify_assign(air, cfg=None) -> list[Diagnostic]:
    """Task lists must partition the nodes; owner must agree with them."""
    diags: list[Diagnostic] = []
    n = air.part.dag.n
    flat = np.fromiter((i for ts in air.task_lists for i in ts),
                       dtype=np.int64, count=sum(map(len, air.task_lists)))
    if not np.array_equal(np.sort(flat), np.arange(n)):
        diags.append(_err("SPT120", f"task lists do not partition the "
                          f"{n} nodes (cover {flat.size} entries)",
                          "cu_assign"))
        return diags
    owner = np.asarray(air.owner)
    for c, ts in enumerate(air.task_lists):
        ta = np.asarray(ts, dtype=np.int64)
        if ta.size and np.any(np.diff(ta) <= 0):
            diags.append(_err("SPT120", f"cu {c} task list is not in "
                              f"ascending (topological) order", "cu_assign",
                              cu=c))
            break
    bad = np.flatnonzero(owner[flat] !=
                         np.repeat(np.arange(len(air.task_lists)),
                                   [len(ts) for ts in air.task_lists]))
    if bad.size:
        i = int(flat[bad[0]])
        diags.append(_err("SPT120", f"owner[{i}] disagrees with the task "
                          f"list that carries node {i}", "cu_assign",
                          node=i))
    if cfg is not None and len(air.task_lists) != cfg.num_cus:
        diags.append(_err("SPT120", f"{len(air.task_lists)} task lists for "
                          f"{cfg.num_cus} CUs", "cu_assign"))
    return diags


# ---------------------------------------------------------------------------
# psum_schedule: ScheduleIR (dense trace)
# ---------------------------------------------------------------------------
def verify_schedule(sir, air=None, cfg=None) -> list[Diagnostic]:
    """Hazard-freedom plus (with ``air``) completeness against the DAG."""
    diags: list[Diagnostic] = []
    shapes = {sir.ops.shape, sir.val_idx.shape, sir.src.shape,
              sir.ctl.shape, sir.slot.shape}
    if len(shapes) != 1 or sir.ops.ndim != 2:
        diags.append(_err("SPT101", f"trace planes disagree on shape: "
                          f"{sorted(map(str, shapes))}", "psum_schedule"))
        return diags

    nop = sir.ops == OP_NOP
    dirty = nop & ((sir.src != 0) | (sir.ctl != 0) | (sir.slot != 0)
                   | (sir.val_idx != 0))
    if dirty.any():
        tt, pp = np.argwhere(dirty)[0]
        diags.append(_err("SPT104", f"NOP lane carries a non-zero field at "
                          f"cycle {tt}, cu {pp}", "psum_schedule",
                          cycle=int(tt), cu=int(pp)))

    # the schedule pass appends one stream value per executed lane, in
    # execution order: active val_idx must be exactly 0..S-1, row-major
    active = ~nop
    vi = sir.val_idx[active]
    if vi.size != sir.stream.size or \
            not np.array_equal(np.sort(vi), np.arange(sir.stream.size)):
        diags.append(_err("SPT117", f"stream has {sir.stream.size} values "
                          f"for {vi.size} executed lanes (val_idx must "
                          f"enumerate the stream exactly once)",
                          "psum_schedule"))

    diags += trace_hazards(view_schedule(sir), cfg,
                           check_values=vi.size == sir.stream.size)

    if air is not None:
        diags += _schedule_completeness(sir, air)
    return diags


def _schedule_completeness(sir, air) -> list[Diagnostic]:
    """Cross-IR: the trace must execute the DAG, whole and on-owner."""
    diags: list[Diagnostic] = []
    dag = air.part.dag
    owner = np.asarray(air.owner)
    # flat integer gathers: ~10x cheaper than boolean-mask fancy indexing
    # over the [T, P] planes, and the lane id falls out of the flat index
    ncu = sir.ops.shape[1]
    ops_flat = np.asarray(sir.ops).ravel()
    src_flat = np.asarray(sir.src).ravel()
    vi_flat = np.asarray(sir.val_idx).ravel()

    # FINAL lanes: node i finalized on its owning CU with scale[i] streamed
    f_idx = np.flatnonzero(ops_flat == OP_FINAL)
    fin_node = src_flat[f_idx]
    fin_cu = f_idx % ncu
    in_range = (fin_node >= 0) & (fin_node < dag.n)
    if in_range.all() and fin_node.size == dag.n:
        off = np.flatnonzero(owner[fin_node] != fin_cu)
        if off.size:
            i = int(fin_node[off[0]])
            diags.append(_err("SPT116", f"node {i} finalized on cu "
                              f"{int(fin_cu[off[0]])} but assigned to cu "
                              f"{int(owner[i])}", "psum_schedule", node=i,
                              cu=int(fin_cu[off[0]])))
        vals = sir.stream[vi_flat[f_idx]]
        want = np.asarray(dag.scale)[fin_node]
        if not np.array_equal(vals, want):
            i = int(fin_node[np.argmax(vals != want)])
            diags.append(_err("SPT117", f"FINAL of node {i} streams a "
                              f"value that is not its scale",
                              "psum_schedule", node=i))

    # EDGE lanes: multiset of (owner cu, source, weight) must equal the DAG's
    e_idx = np.flatnonzero(ops_flat == OP_EDGE)
    e_cu = e_idx % ncu
    e_src = src_flat[e_idx]
    e_val = sir.stream[vi_flat[e_idx]]
    owner_row = np.repeat(np.arange(dag.n), np.diff(dag.ptr))
    d_cu = owner[owner_row]
    d_src = np.asarray(dag.src)
    d_val = np.asarray(dag.weight)
    if e_cu.size != d_cu.size:
        diags.append(_err("SPT117", f"trace executes {e_cu.size} edges but "
                          f"the DAG has {d_cu.size}", "psum_schedule",
                          hint="an edge was dropped or duplicated"))
        return diags
    # (cu, src) packs into one integer key: a stable argsort over it is
    # several times cheaper than a 3-key lexsort with a float plane, and
    # on a well-formed schedule a CU executes its nodes in task-list
    # order, so the within-key value order already matches the DAG's —
    # the value lexsort below only runs when that fast comparison fails.
    key_e = e_cu.astype(np.int64) * np.int64(dag.n) + e_src
    key_d = d_cu.astype(np.int64) * np.int64(dag.n) + d_src
    a = np.argsort(key_e, kind="stable")
    b = np.argsort(key_d, kind="stable")
    ke, kd = key_e[a], key_d[b]
    if not np.array_equal(ke, kd):
        k = int(np.argmax(ke != kd))
        diags.append(_err("SPT117", f"edge multiset diverges from the DAG "
                          f"(first at source row {int(e_src[a[k]])} on cu "
                          f"{int(e_cu[a[k]])})", "psum_schedule",
                          node=int(e_src[a[k]]), cu=int(e_cu[a[k]])))
        return diags
    ve, vd = e_val[a], d_val[b]
    if not np.array_equal(ve, vd):
        # weights inside a duplicated (cu, src) group may legally arrive
        # in a different order (the ICR reorder permutes rows within a
        # CU); canonicalize those groups by value — they are a small
        # fraction of the edges, so the value sort stays cheap
        dup = np.empty(ke.size, dtype=bool)
        dup[0] = False
        dup[1:] = ke[1:] == ke[:-1]
        grp = dup | np.append(dup[1:], False)
        bad = (ve != vd) & ~grp
        if not bad.any():
            sub = np.flatnonzero(grp)
            ks = ke[sub]
            ves = ve[sub][np.lexsort((ve[sub], ks))]
            vds = vd[sub][np.lexsort((vd[sub], ks))]
            if np.array_equal(ves, vds):
                return diags
            k = int(sub[np.argmax(ves != vds)])
        else:
            k = int(np.argmax(bad))
        diags.append(_err("SPT117", f"edge multiset diverges from the "
                          f"DAG (first at source row {int(ke[k] % dag.n)}"
                          f" on cu {int(ke[k] // dag.n)})",
                          "psum_schedule", node=int(ke[k] % dag.n),
                          cu=int(ke[k] // dag.n)))
    return diags


# ---------------------------------------------------------------------------
# stall_elide: EmitIR
# ---------------------------------------------------------------------------
def verify_emit(eir, sir=None) -> list[Diagnostic]:
    """No stall row may survive; envelopes and stats must re-derive."""
    diags: list[Diagnostic] = []
    nop_rows = ~(eir.ops != OP_NOP).any(axis=1)
    if nop_rows.any():
        tt = int(np.argmax(nop_rows))
        diags.append(_err("SPT121", f"all-NOP stall row survived elision "
                          f"at emitted cycle {tt}", "stall_elide",
                          cycle=tt,
                          hint="streaming it is pure instruction traffic"))
    if eir.stats.emitted_cycles != eir.ops.shape[0]:
        diags.append(_err("SPT121", f"stats.emitted_cycles="
                          f"{eir.stats.emitted_cycles} but "
                          f"{eir.ops.shape[0]} rows were emitted",
                          "stall_elide"))
    if eir.row_lo is None or eir.row_hi is None or \
            eir.row_lo.shape != (eir.ops.shape[0],) or \
            eir.row_hi.shape != (eir.ops.shape[0],):
        diags.append(_err("SPT121", "row envelopes missing or mis-shaped",
                          "stall_elide"))
        return diags
    same = False
    if sir is not None:
        keep = (sir.ops != OP_NOP).any(axis=1)
        same = (np.array_equal(sir.ops[keep], eir.ops)
                and np.array_equal(sir.src[keep], eir.src)
                and np.array_equal(sir.ctl[keep], eir.ctl)
                and np.array_equal(sir.slot[keep], eir.slot)
                and np.array_equal(sir.val_idx[keep], eir.val_idx)
                and np.array_equal(sir.stream, eir.stream))
        if not same:
            diags.append(_err("SPT121", "emitted rows are not the dense "
                              "trace's active rows in order", "stall_elide"))
    if same and eir.num_slots == sir.num_slots:
        # the emitted planes ARE the verified dense trace's active rows:
        # every hazard check is order-relative, and dropping all-NOP rows
        # preserves order, so only the field elision *adds* — the row
        # envelopes — needs checking
        diags += envelope_diags(view_emit(eir))
    else:
        diags += trace_hazards(view_emit(eir))
    return diags


# ---------------------------------------------------------------------------
# pack_emit: packed Program
# ---------------------------------------------------------------------------
def verify_packed_program(prog, eir=None, cfg=None) -> list[Diagnostic]:
    """Packed structure + hazards; with ``eir``, the pack must roundtrip."""
    diags, decodable, values_ok = packed_structure(prog)
    if not decodable:
        return _blame(diags, "pack_emit")
    v = view_program(prog)
    roundtrip_ok = False
    if eir is not None:
        same = (np.array_equal(v.op, eir.ops)
                and np.array_equal(v.src, eir.src)
                and np.array_equal(v.ctl, eir.ctl)
                and np.array_equal(v.slot, eir.slot)
                and np.array_equal(np.asarray(prog.val_idx), eir.val_idx))
        if not same:
            diags.append(_err("SPT102", "packed words do not decode back "
                              "to the emitted field planes", "pack_emit"))
        stream_ok = np.allclose(np.asarray(prog.stream, dtype=np.float64),
                                eir.stream.astype(np.float32)
                                .astype(np.float64))
        if not stream_ok:
            diags.append(_err("SPT117", "value stream diverged from the "
                              "emitted schedule's stream", "pack_emit"))
        roundtrip_ok = (
            same and stream_ok and values_ok
            and v.num_slots == eir.num_slots
            and v.row_lo is not None and v.row_hi is not None
            and np.array_equal(np.asarray(v.row_lo),
                               np.asarray(eir.row_lo))
            and np.array_equal(np.asarray(v.row_hi),
                               np.asarray(eir.row_hi)))
    if not roundtrip_ok:
        # standalone program (no eir) or an imperfect roundtrip: run the
        # full hazard detector over the decoded planes.  When the decode
        # matches the already-verified EmitIR field-for-field (envelopes
        # and stream included), the detector would only re-prove what
        # `verify_emit` just proved on identical arrays — skip it.
        diags += trace_hazards(v, cfg if cfg is not None else prog.config,
                               check_values=values_ok)
    return _blame(diags, "pack_emit")


def _blame(diags: list[Diagnostic], stage: str) -> list[Diagnostic]:
    """Rewrite generic ``program`` blame onto a concrete pipeline stage."""
    import dataclasses

    return [dataclasses.replace(d, pass_name=stage)
            if d.pass_name in ("", "program") else d for d in diags]

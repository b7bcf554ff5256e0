"""The port's public surface against the JAX package's.

For every module of `src/repro/` (each has a counterpart under
`src/repro_torch/`), every public function and class defined there, and
every public method of those classes, must exist in the port and take the
reference's parameters: the same names, kinds and order, the same plain
defaults, so that a call written for the reference binds the same way.
The port may add parameters after them (keyword-only ones before a
``**kwargs``), each with a default.  What differs on purpose is listed in
`ALLOWED`, each entry with its reason; ROADMAP.md's "Differences made on
purpose" carries every one.  The launchers' flags are held the same way:
every reference flag of `launch.serve`, `launch.train` and
`launch.dryrun` parses in the port with the same dest, type and default.
"""

import argparse
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
MODULES = sorted(
    ".".join(p.relative_to(REPO / "src" / "repro").with_suffix("").parts)
    .removesuffix("__init__").rstrip(".")
    for p in (REPO / "src" / "repro").rglob("*.py"))

# qualified name -> why the port differs (ROADMAP, "Differences made on purpose")
ALLOWED = {
    "core.executor.make_jax_executor": "jax only: the port's executors are "
    "make_torch_executor and make_cuda_executor",
    "core.executor.make_pallas_executor": "jax only: the Pallas kernels' executor is "
    "make_cuda_executor",
    "core.executor.execute_jax": "jax only: the device path without a kernel is the "
    "torch executor",
    "core.executor.batched_entry": "takes the torch device; no single_core or place "
    "(jax placement hooks)",
    "kernels.common.default_interpret": "Pallas interpret mode; the port picks a "
    "device (resolve_device), CPU tensors run the plain twins",
    "kernels.common.resolve_interpret": "Pallas interpret mode, as above",
    "distributed.sharding.param_shardings": "make NamedShardings; the port's specs "
    "are DTensor placements (param_placements)",
    "distributed.sharding.rhs_sharding": "NamedSharding; the port splits columns with "
    "core.shard.rhs_blocks",
    "distributed.sharding.batch_sharding": "NamedSharding; the port's is "
    "batch_placements",
    "distributed.sharding.cache_shardings": "NamedSharding; the port's is "
    "cache_placements",
    "launch.hlo_analysis.analyze_hlo": "reads XLA's HLO text; the port counts the "
    "torch dispatch trace (analyze_step)",
    "launch.steps.abstract_opt_state": "takes the model (meta tensors), not a tree "
    "of shapes",
    "core.shard.batch_mesh": "a BatchMesh of torch devices (devices=), not a "
    "jax Mesh with a named axis",
    "kernels.sptrsv.ops.resolve_placement": "budgets shared memory per CTA "
    "(smem_limit_bytes, cols_per_cta) in place of VMEM",
    "kernels.sptrsv.ops.instr_buffer_bytes": "the stream ring's size is fixed by the "
    "kernel (stream_ring_cycles), not by the block length",
    "kernels.sptrsv.ops.state_bytes": "bytes of one CTA of cols_per_cta columns, "
    "not of one kernel instance holding all nb",
    "kernels.sptrsv.ops.build_solver_cols": "smem_limit_bytes for vmem_limit_bytes, "
    "device= for interpret=",
    "kernels.sptrsv.ops.solve": "smem_limit_bytes for vmem_limit_bytes, device= for "
    "interpret=",
    "kernels.flash_attention.ops.gqa_attention": "use_kernels for use_pallas and "
    "interpret; the kernel picks its own 64 x 64 tiles (no block_q)",
    "kernels.flash_attention.ops.gqa_attention_folded": "as gqa_attention",
    "models.layers.RuntimeFlags": "use_kernels for use_pallas and interpret; no "
    "attn_block_q or ssm_chunk (the kernels pick their tiles)",
    "models.layers.attention_decode": "updates the cache's k and v in place at an "
    "int position",
    "models.layers.init_linear": "parameters are nn.Modules (Linear), not trees",
    "models.layers.init_embedding": "parameters are nn.Modules (Embedding)",
    "models.layers.init_attention": "parameters are nn.Modules (Attention)",
    "models.layers.init_mlp": "parameters are nn.Modules (MLP)",
    "models.mamba2.init_mamba2": "parameters are nn.Modules (Mamba2)",
    "models.moe.init_moe": "parameters are nn.Modules (MoE)",
    "models.rwkv6.init_rwkv_time_mix": "parameters are nn.Modules",
    "models.rwkv6.init_rwkv_channel_mix": "parameters are nn.Modules",
    "models.model.init_params": "draws from a torch.Generator and returns the LM "
    "module",
    "models.model.train_forward": "takes the LM module for the parameter tree",
    "models.model.prefill": "takes the LM module for the parameter tree",
    "models.model.decode_step": "takes the LM module; updates the cache in place",
    "optim.adamw.adamw_init": "on a model's parameters, not a tree",
    "optim.adamw.adamw_update": "in place on the model's parameters and their .grad",
    "optim.clip.global_norm": "on a sequence of gradient tensors, not a tree",
    "optim.clip.clip_by_global_norm": "in place on gradient tensors, returns the norm",
}
# the default backend names the port's own executor ("torch" for "jax")
BACKEND_DEFAULT = ("jax", "torch")
PLAIN = (type(None), bool, int, float, str, tuple)


def _module(package, name):
    return importlib.import_module(package + ("." + name if name else ""))


def _public(mod):
    return [(name, obj) for name, obj in vars(mod).items()
            if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == mod.__name__]


def _methods(cls):
    """Public functions, static and class methods and properties of ``cls``."""
    out = {}
    for name, attr in vars(cls).items():
        if name.startswith("_"):
            continue
        if isinstance(attr, (staticmethod, classmethod)):
            attr = attr.__func__
        if inspect.isfunction(attr) or isinstance(attr, property):
            out[name] = attr
    return out


def _signature(obj):
    try:
        return inspect.signature(obj)
    except ValueError:  # a class whose constructor is a builtin's (a dict)
        return None


def _same(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float) and a != a and b != b)


def _compare(qual, ref, port):
    """Why a call written for ``ref`` would not bind alike on ``port``."""
    rs, ps = _signature(ref), _signature(port)
    if rs is None or ps is None:
        return [] if rs is ps else [f"{qual}: signature {rs} vs {ps}"]
    var_kw = inspect.Parameter.VAR_KEYWORD
    rp = [p for p in rs.parameters.values() if p.kind != var_kw]
    pp = [p for p in ps.parameters.values() if p.kind != var_kw]
    problems = []
    for r, p in zip(rp, pp):
        if (r.name, r.kind) != (p.name, p.kind):
            problems.append(f"{qual}: {r.name} ({r.kind.name}) is {p.name} "
                            f"({p.kind.name}) in the port")
        elif r.default is not r.empty:
            if p.default is p.empty:
                problems.append(f"{qual}: {r.name} has no default in the port")
            elif isinstance(r.default, PLAIN) and not _same(r.default, p.default) and not (
                    r.name == "backend" and (r.default, p.default) == BACKEND_DEFAULT):
                problems.append(f"{qual}: {r.name}={r.default!r} is {p.default!r}")
    if len(pp) < len(rp):
        problems.append(f"{qual}: the port lacks {[r.name for r in rp[len(pp):]]}")
    problems += [f"{qual}: the port's {p.name} has no default" for p in pp[len(rp):]
                 if p.default is p.empty and p.kind not in (p.VAR_POSITIONAL,)]
    if any(p.kind == var_kw for p in rs.parameters.values()) and not any(
            p.kind == var_kw for p in ps.parameters.values()):
        problems.append(f"{qual}: the port takes no **kwargs")
    return problems


def _differences(name):
    ref, port = _module("repro", name), _module("repro_torch", name)
    prefix = name + "." if name else ""
    problems = []
    for attr, obj in _public(ref):
        qual = prefix + attr
        if qual in ALLOWED:
            continue
        if not hasattr(port, attr):
            problems.append(f"{qual}: missing in the port")
            continue
        theirs = getattr(port, attr)
        problems += _compare(qual, obj, theirs)
        if inspect.isclass(obj):
            mine = _methods(theirs)
            for meth, fn in _methods(obj).items():
                if meth not in mine and not hasattr(theirs, meth):
                    problems.append(f"{qual}.{meth}: missing in the port")
                elif isinstance(fn, property) or isinstance(mine.get(meth), property):
                    if not isinstance(inspect.getattr_static(theirs, meth), property):
                        problems.append(f"{qual}.{meth}: not a property in the port")
                else:
                    problems += _compare(f"{qual}.{meth}", fn, getattr(theirs, meth))
    return problems


def test_every_reference_module_has_a_counterpart():
    assert len(MODULES) == 90
    missing = [m for m in MODULES if not (
        REPO / "src" / "repro_torch" / Path(*m.split("."))).with_suffix(".py").exists()
        and not (REPO / "src" / "repro_torch" / Path(*m.split(".")) / "__init__.py").exists()]
    assert not missing


@pytest.mark.parametrize("name", MODULES, ids=lambda m: m or "repro")
def test_public_surface_matches_reference(name):
    problems = _differences(name)
    assert not problems, "\n".join(problems)


def test_allow_list_names_real_differences():
    """Each allowed name is public in the reference and still differs: the
    port lacks it, or a call to it would bind otherwise."""
    stale = []
    for qual in ALLOWED:
        name, attr = qual.rsplit(".", 1)
        obj = getattr(_module("repro", name), attr)
        port = getattr(_module("repro_torch", name), attr, None)
        if port is not None and not _compare(qual, obj, port):
            stale.append(qual)
    assert not stale


def test_comparison_catches_the_faults_it_is_for():
    """The check itself: reordered, renamed, dropped or re-defaulted
    parameters, and a new parameter without a default, are differences."""
    def ref(directory, step, tree, host_id=0, num_hosts=1, meta=None, **kw):
        pass

    def reordered(directory, step, tree, meta=None, host_id=0, num_hosts=1, **kw):
        pass

    def required_extra(directory, step, tree, host_id=0, num_hosts=1, meta=None,
                       device=None, *, extra, **kw):
        pass

    def fine(directory, step, tree, host_id=0, num_hosts=1, meta=None, *,
             device=None, **kw):
        pass

    def no_kwargs(directory, step, tree, host_id=0, num_hosts=1, meta=None):
        pass

    def other_default(directory, step, tree, host_id=1, num_hosts=1, meta=None, **kw):
        pass

    assert _compare("f", ref, fine) == []
    for port in (reordered, required_extra, no_kwargs, other_default):
        assert _compare("f", ref, port), port.__name__


# ---------------------------------------------------------------- launchers
class _Parsed(Exception):
    pass


def _parser(main, argv, monkeypatch):
    """The parser ``main(argv)`` builds, caught as it parses."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main(*argv)
    return seen[0]


def _flags(parser):
    return {a.option_strings[0]: a for a in parser._actions if a.option_strings
            and a.dest != "help"}


# launcher -> {flag: why the port's differs or exists}
PORT_FLAGS = {
    "serve": {"--device": "the torch device; default the CUDA card"},
    "train": {"--device": "the torch device; default the CUDA card"},
    "dryrun": {"--out": "default build/dryrun (gitignored) for results/dryrun: the "
               "port's records do not overwrite the reference's committed ones"},
}


@pytest.mark.parametrize("launcher", sorted(PORT_FLAGS))
def test_launcher_flags_match_reference(launcher, monkeypatch):
    ref_main = _module("repro", "launch." + launcher).main
    port_main = _module("repro_torch", "launch." + launcher).main
    want = _flags(_parser(ref_main, () if launcher == "dryrun" else ([],), monkeypatch))
    got = _flags(_parser(port_main, ([],), monkeypatch))
    extra = PORT_FLAGS[launcher]
    assert set(got) - set(want) <= set(extra)
    for flag, r in want.items():
        assert flag in got, flag
        p = got[flag]
        assert (p.dest, p.type, type(p), p.choices, p.nargs) == (
            r.dest, r.type, type(r), r.choices, r.nargs), flag
        if flag not in extra:
            assert p.default == r.default, flag


def test_serve_temperature_parses_and_decodes_greedily():
    """``--temperature`` parses as in the reference (float, default 0.0) and
    decoding stays greedy whatever its value: the same tokens."""
    from repro_torch.launch import serve

    argv = ["--reduced", "--device", "cpu", "--requests", "2", "--prefill-len", "8",
            "--decode-steps", "3"]
    assert serve.parse_args(argv).temperature == 0.0
    assert serve.parse_args(argv + ["--temperature", "0"]).temperature == 0.0
    greedy = serve.main(argv)["tokens"]
    assert serve.main(argv + ["--temperature", "0.7"])["tokens"] == greedy
    assert np.asarray(greedy).shape == (2, 3)

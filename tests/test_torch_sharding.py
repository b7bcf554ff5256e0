"""The port's sharding rules against the reference's, with no process group.

`repro_torch.distributed.sharding` turns the reference's PartitionSpec rules
into DTensor placements.  Here meshes are given as shapes (`MeshShape`; the
reference gets ``jax.sharding.AbstractMesh``), every parameter of every
arch is built at full size on the ``meta`` device (the reference's through
its own ``abstract_params``, shapes only), and the port's spec of each
leaf must be the reference's spec of the stacked leaf it belongs to, with
the stacked leading axes dropped; the placements must shard exactly the
dims the reference's spec names, on the mesh axes it names, in mesh order.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.distributed import sharding as jsh
from repro.kernels.flash_attention import ops as jattn
from repro.launch.steps import abstract_params as jabstract_params
from repro.models import init_cache as jinit_cache
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.flash_attention import ops as attn
from repro_torch.models import init_cache, init_params
from repro_torch.models.convert import reference_name

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


def _meshes(key):
    sizes, names = MESHES[key]
    return sh.MeshShape(names, sizes), AbstractMesh(sizes, names)


def _pad(spec, ndim: int) -> tuple:
    """``spec`` with one entry per dim, a one-axis tuple as its axis (the
    same split; NamedSharding writes ``('data',)`` as ``'data'``)."""
    one = lambda e: e[0] if isinstance(e, tuple) and len(e) == 1 else e
    return tuple(one(e) for e in spec) + (None,) * (ndim - len(spec))


def _want_placements(names, spec) -> tuple:
    """The placements the reference's ``spec`` means, built here: Shard(d) on
    each mesh axis that ``spec`` names for dim d."""
    out = []
    for a in names:
        dims = [d for d, e in enumerate(spec)
                if e is not None and a in (e if isinstance(e, tuple) else (e,))]
        assert len(dims) <= 1
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _reference_leaves(arch: str) -> dict:
    shapes = jabstract_params(jget_config(arch))
    return {jsh._path_str(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@functools.lru_cache(maxsize=None)
def _port_model(arch: str):
    return init_params(None, get_config(arch), device="meta", param_dtype=torch.float32)


def test_arch_lists_agree():
    assert list_archs() == jlist_archs()


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_placements_equal_reference(arch, mesh_key):
    mesh, amesh = _meshes(mesh_key)
    model = _port_model(arch)
    ref = _reference_leaves(arch)
    specs = sh.param_specs(mesh, model)
    plc = sh.param_placements(mesh, model)
    seen = set()
    for name, p in model.named_parameters():
        ref_name, lead = reference_name(name)
        path = ref_name.replace(".", "/")
        leaf = ref[path]
        seen.add(path)
        assert tuple(leaf.shape[lead:]) == tuple(p.shape), (name, leaf.shape)
        spec = jsh._spec_for(path, leaf.ndim)
        if not jsh.spec_fits(amesh, leaf.shape, spec):
            spec = P()
        spec = _pad(spec, leaf.ndim)
        assert all(e is None for e in spec[:lead]), (name, spec)
        want = spec[lead:]
        got = _pad(specs[name], p.ndim)
        assert got == want, (name, got, want)
        assert plc[name] == _want_placements(amesh.axis_names, want), (name, plc[name])
    assert seen == set(ref), sorted(set(ref) - seen)


@pytest.mark.parametrize("arch", list_archs())
def test_param_sharding_rules_cover_big_leaves(arch):
    """Mirrors tests/test_substrate.py: every (stacked) leaf of 10M elements
    or more has a rule, so no 100 GB tensor is silently replicated."""
    model = _port_model(arch)
    stacked: dict[str, list] = {}
    for name, p in model.named_parameters():
        ref_name, lead = reference_name(name)
        stacked.setdefault(ref_name.replace(".", "/"), []).append((p, lead))
    for path, parts in stacked.items():
        if sum(p.numel() for p, _ in parts) < 10_000_000:
            continue
        p, lead = parts[0]
        assert sh._spec_for(path, p.ndim + lead) != (), (arch, path)


def _cache_case(arch, batch, seq):
    cfg, jcfg = get_config(arch), jget_config(arch)
    port = init_cache(cfg, batch, seq, device="meta")
    ref = jax.eval_shape(lambda: jinit_cache(jcfg, batch, seq))
    return cfg, jcfg, port, ref


@pytest.mark.parametrize("mesh_key", ["16x16", "2x16x16", "2x4"])
@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m", "rwkv6-1.6b",
                                  "zamba2-2.7b", "whisper-base", "llama-3.2-vision-11b"])
def test_cache_placements_equal_reference(arch, batch, mesh_key):
    mesh, amesh = _meshes(mesh_key)
    cfg, jcfg, port, ref = _cache_case(arch, batch, 1024)
    want = {jsh._path_str(path): s.spec for path, s in
            jax.tree_util.tree_flatten_with_path(
                jsh.cache_shardings(amesh, jcfg, ref, batch))[0]}
    specs = sh.cache_specs(mesh, cfg, port, batch)
    plc = sh.cache_placements(mesh, cfg, port, batch)
    assert set(specs) == set(want) - {"pos"}, (sorted(specs), sorted(want))
    leaves = dict(sh._cache_leaves(port))
    for path, spec in specs.items():
        nd = leaves[path].ndim
        w = _pad(want[path], nd)
        assert _pad(spec, nd) == w, (path, spec, w)
        assert plc[path] == _want_placements(amesh.axis_names, w), (path, plc[path])


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 32, 256])
def test_batch_placements_equal_reference(batch, mesh_key):
    mesh, amesh = _meshes(mesh_key)
    want = _pad(jsh.batch_sharding(amesh, batch).spec, 2)
    assert _pad(sh.batch_spec(mesh, batch), 2) == want
    assert sh.batch_placements(mesh, batch) == _want_placements(amesh.axis_names, want)
    assert sh.dp_axes(mesh) == jsh.dp_axes(amesh)
    assert sh.dp_size(mesh) == jsh.dp_size(amesh)


@pytest.mark.parametrize("ndim,b_ok", [(4, True), (4, False), (5, True), (6, False)])
def test_kv_spec_equals_reference(ndim, b_ok):
    for dp in (("data",), ("pod", "data")):
        assert _pad(sh._kv_spec(ndim, b_ok, dp), ndim) == _pad(jsh._kv_spec(ndim, b_ok, dp),
                                                               ndim)


# (bh, lq, is_kv) on a 2 x 4 mesh: 1. bh divides 8; 2. bh divides the dp
# axis and lq the model axis; 3. bh divides dp only (or a kv tensor); 4. none
FOLD_CASES = {
    "1-merged-bh": (16, 12, False),
    "2-query-sequence": (6, 8, False),
    "3-bh-over-dp": (6, 6, False),
    "3-kv-over-dp": (6, 8, True),
    "4-none": (3, 8, False),
}


@pytest.mark.parametrize("mesh_key", ["2x4", "2x16x16"])
@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_attention_fold_specs_equal_reference(case, mesh_key):
    mesh, amesh = _meshes(mesh_key)
    bh, lq, is_kv = FOLD_CASES[case]
    dp = sh.dp_axes(mesh)
    ref_flags = SimpleNamespace(mesh=SimpleNamespace(shape=dict(amesh.shape),
                                                     axis_names=amesh.axis_names), dp=dp)
    want = jattn.attention_fold_specs(ref_flags, bh, lq, is_kv=is_kv)
    got = attn.attention_fold_specs(SimpleNamespace(mesh=mesh, dp=dp), bh, lq, is_kv=is_kv)
    assert (got is None) == (want is None)
    if got is not None:
        assert _pad(got, 3) == _pad(want, 3)
    if mesh_key == "2x4":
        priority = int(case[0])
        assert (got is None) == (priority == 4)
        if priority == 2:
            assert got[1] == "model"
            # the local kernel call takes whole query rows (priority 3)
            assert attn.row_spec(SimpleNamespace(mesh=mesh, dp=dp), bh, lq) == (dp, None,
                                                                                None)


def test_placements_refuse_axes_out_of_mesh_order():
    mesh = sh.MeshShape(("data", "model"), (2, 4))
    assert sh.placements(mesh, ((("data", "model")), None)) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements(mesh, (("model", "data"), None))
    with pytest.raises(ValueError, match="splits two dims"):
        sh.placements(mesh, ("model", "model"))


def test_placements_are_what_named_sharding_shards():
    """The placements split a tensor as the reference's NamedSharding does:
    each device's local shape (the global one divided, per placement, by
    its mesh axis) equals the shard shape jax computes."""
    sizes, names = MESHES["2x4"]
    amesh = AbstractMesh(sizes, names)
    shape = (8, 12, 16)
    for spec in [(("data", "model"), None, None), ("data", "model", None),
                 (None, None, "model"), ()]:
        want = NamedSharding(amesh, P(*spec)).shard_shape(shape)
        got = list(shape)
        for size, p in zip(sizes, sh.placements(sh.MeshShape(names, sizes), spec)):
            if p.is_shard():
                got[p.dim] //= size
        assert tuple(got) == tuple(want), (spec, got, want)

"""The port's sharding rules (``repro_torch.runtime.sharding``) against the
reference's (``repro.runtime.sharding``), leaf by leaf, at full width.

For all ten ``ASSIGNED`` configs, on the production meshes ``(16, 16)``
and ``(2, 16, 16)`` and on ``(2, 16)``: the training tree
(``fsdp=True``), the serving tree and a cache.  The reference's specs come
from its ``jax.eval_shape`` templates, the port's from ``meta`` trees.  A
port leaf of a period layer must carry the spec of the reference's stacked
leaf with its scan entry dropped (``ref_path``); a prefix layer's leaf and
a top-level leaf the reference's spec as it is.  Then the per-layer rule's
consequences by name, ``logical_batch_spec``'s SP and pod cases, and the
placement of a tensor (every rank's slice, reassembled).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get_config as ref_get_config
from repro.launch import mesh as RMESH
from repro.models import model_zoo as RZ
from repro.runtime import serve_loop as RSL
from repro.runtime import sharding as RSH
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.launch import mesh as MESH
from repro_torch.models import model_zoo as Z
from repro_torch.runtime import serve_loop as SL
from repro_torch.runtime import sharding as SH
from repro_torch.runtime import train_loop as TL
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x16": ((2, 16), ("data", "model"))}
CACHE_BATCH = 32


def _norm(spec) -> tuple:
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(tuple(e) if isinstance(e, (list, tuple)) and len(e) > 1 else
                 (e[0] if isinstance(e, (list, tuple)) else e) for e in entries)


def _key(k):
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "idx"):
        return k.idx
    return str(k)


def _ref_specs(sh_tree) -> dict:
    """{path tuple (dict keys, list indices): spec} of a reference tree of
    NamedSharding."""
    flat = jax.tree_util.tree_flatten_with_path(sh_tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {tuple(_key(k) for k in path): _norm(s.spec) for path, s in flat}


def _port_specs(sh_tree) -> dict:
    out = {}
    for path, sh in tree.leaves_with_paths(sh_tree):
        out[tuple(int(p) if p.isdigit() else p for p in path.split("/")[1:])] = sh.spec
    return out


def _ref_of(path: tuple, cfg) -> tuple:
    """The reference's leaf a port leaf comes from, and whether it is stacked."""
    if path[0] == "layers":
        head, i, rest, n_prefix, period = ("stack",), path[1], path[2:], len(cfg.prefix_layers), len(cfg.pattern_period)
    elif path[:2] == ("encoder", "layers"):
        head, i, rest, n_prefix, period = ("encoder", "stack"), path[2], path[3:], 0, 1
    else:
        return path, False
    if i < n_prefix:
        return head + ("prefix", i) + rest, False
    return head + ("period", (i - n_prefix) % period) + rest, True


def _compare(port: dict, ref: dict, cfg) -> list:
    """Every port leaf's spec against its reference leaf's; returns the
    port leaves where the reference's scan entry was a mesh axis."""
    scan_sharded = []
    for path, spec in port.items():
        rpath, stacked = _ref_of(path, cfg)
        assert rpath in ref, (cfg.name, path, rpath)
        want = ref[rpath]
        if stacked:
            if want and want[0] is not None:
                scan_sharded.append("/".join(map(str, path)))
            want = _norm(want[1:])
        assert spec == want, (cfg.name, path, spec, want)
    return scan_sharded


@functools.lru_cache(maxsize=None)
def _templates(name: str):
    cfg, rcfg = get_config(name), ref_get_config(name)
    rparams = jax.eval_shape(lambda k: RZ.init_params(k, rcfg), jax.random.PRNGKey(0))
    params = Z.init_params(0, cfg, device="meta")
    max_len = min(1024, cfg.max_seq) if cfg.pos_embedding == "learned" else 1024
    rcache = jax.eval_shape(lambda: RZ.init_cache(CACHE_BATCH, max_len, rcfg))
    cache = Z.init_cache(CACHE_BATCH, max_len, cfg, device="meta")
    return cfg, rcfg, rparams, params, rcache, cache


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ASSIGNED)
def test_train_and_cache_specs_equal_the_reference(name, mesh_name):
    """Training tree with FSDP (and the AdamW state, which takes the same
    shardings), and a 32-row cache: every leaf's spec is the reference's
    under the per-layer rule; no reference FSDP shard falls on a scan
    axis at these sizes."""
    shape, axes = MESHES[mesh_name]
    cfg, rcfg, rparams, params, rcache, cache = _templates(name)
    rmesh, mesh = RMESH.abstract_mesh(shape, axes), MESH.abstract_mesh(shape, axes)
    ref = _ref_specs(RSH.params_shardings(rparams, rmesh, fsdp=True))
    port = _port_specs(SH.params_shardings(params, mesh, cfg, fsdp=True))
    assert len(port) == len(tree.leaves(params))
    assert _compare(port, ref, cfg) == []
    ref_c = _ref_specs(RSH.cache_shardings(rcache, rmesh, CACHE_BATCH))
    port_c = _port_specs(SH.cache_shardings(cache, mesh, CACHE_BATCH, cfg))
    assert _compare(port_c, ref_c, cfg) == []


@pytest.mark.parametrize("name", ASSIGNED)
def test_serving_specs_equal_the_reference(name):
    """``serving_params_shardings`` on both meshes: packed words, scales,
    column sums, bf16 tables and float leaves alike."""
    cfg, rcfg = get_config(name), ref_get_config(name)
    (shape, axes), (shape2, axes2) = MESHES["16x16"], MESHES["2x16x16"]
    rsh, rtmpl = RSL.serving_params_shardings(rcfg, RMESH.abstract_mesh(shape, axes))
    psh, tmpl = SL.serving_params_shardings(cfg, MESH.abstract_mesh(shape, axes))
    assert all(t.is_meta for t in tree.leaves(tmpl))
    assert _compare(_port_specs(psh), _ref_specs(rsh), cfg) == []
    # the second mesh on the same templates (each costs a trace of the packing)
    rsh = RSH.params_shardings(rtmpl, RMESH.abstract_mesh(shape2, axes2))
    psh = SH.params_shardings(tmpl, MESH.abstract_mesh(shape2, axes2), cfg)
    assert _compare(_port_specs(psh), _ref_specs(rsh), cfg) == []


def test_stacked_leaves_take_the_reference_fsdp_by_name():
    """The per-layer rule's consequences: a period layer's rank-1 norm gain
    is FSDP-sharded over ``data`` (rank 2 in the reference's stack), a
    prefix layer's is not, nor is the final norm; ``train_shardings`` gives
    the AdamW moments the params' specs and the step counter none."""
    mesh = MESH.abstract_mesh((16, 16), ("data", "model"))
    granite = get_config("granite-8b")
    sh = SH.params_shardings(Z.init_params(0, granite, device="meta"), mesh, granite, fsdp=True)
    assert sh["layers"][3]["ln1"].spec == ("data",)
    assert sh["final_norm"].spec == ()
    assert sh["layers"][0]["attn"]["q"]["w"].spec == ("data", "model")
    assert sh["layers"][0]["attn"]["o"]["w"].spec == ("model", "data")
    assert sh["embedding"].spec == ("model", "data")
    lite = get_config("deepseek-v2-lite-16b")
    sh = SH.params_shardings(Z.init_params(0, lite, device="meta"), mesh, lite, fsdp=True)
    assert lite.prefix_layers
    assert sh["layers"][0]["ln1"].spec == ()  # a prefix layer: rank 1 in both layouts
    assert sh["layers"][5]["attn"]["kv_norm"].spec == ("data",)
    assert "model" not in sh["layers"][5]["moe"]["router"]["w"].spec  # FSDP only, as every rank-2 leaf
    p_sh, o_sh = TL.train_shardings(granite, mesh)
    assert o_sh.mu is p_sh and o_sh.nu is p_sh and o_sh.step.spec == ()
    # serving: no FSDP, the scan entry dropped
    ssh, _ = SL.serving_params_shardings(granite, mesh)
    assert ssh["layers"][3]["ln1"].spec == ()
    assert ssh["layers"][3]["ffn"]["down"]["w_packed"].spec == ("model",)


def test_ref_path_maps_prefix_and_period_layers():
    lite = get_config("deepseek-v2-lite-16b")
    n_prefix = len(lite.prefix_layers)
    names, shape, stacked = SH.ref_path(("layers", "0", "ln1"), (2048,), lite)
    assert (names[:3], shape, stacked) == (("stack", "prefix", "[0]"), (2048,), False)
    names, shape, stacked = SH.ref_path(("layers", str(n_prefix + 3), "ln1"), (2048,), lite)
    assert names[:2] == ("stack", "period") and shape == (lite.n_periods, 2048) and stacked
    whisper = get_config("whisper-tiny")
    names, shape, stacked = SH.ref_path(("encoder", "layers", "2", "ln1"), (384,), whisper)
    assert names[:3] == ("encoder", "stack", "period") and shape == (whisper.encoder.n_layers, 384)
    assert SH.ref_path(("embedding",), (10, 4), lite) == (("embedding",), (10, 4), False)


@pytest.mark.parametrize("batch,seq", [(32, 4096), (1, 524288), (2, 524288), (4, 1000), (512, 128), (3, 7)])
def test_logical_batch_spec_equals_the_reference(batch, seq):
    """Batch over (pod, data) when it divides, else sequence parallelism
    over data (the B=1 long-context cell), and the pod case with B=2."""
    for shape, axes in MESHES.values():
        want = _norm(RSH.logical_batch_spec(batch, seq, RMESH.abstract_mesh(shape, axes)))
        assert _norm(SH.logical_batch_spec(batch, seq, MESH.abstract_mesh(shape, axes))) == want
        rb = RSH.batch_shardings({"tokens": (batch, seq), "frontend": (batch, 16, 8)},
                                 RMESH.abstract_mesh(shape, axes))
        pb = SH.batch_shardings({"tokens": (batch, seq), "frontend": (batch, 16, 8)},
                                MESH.abstract_mesh(shape, axes))
        assert {k: _norm(v.spec) for k, v in rb.items()} == {k: _norm(v.spec) for k, v in pb.items()}
    assert SH.data_axes(MESH.make_production_mesh(multi_pod=True)) == ("pod", "data")
    assert SH.logical_batch_spec(1, 524288, MESH.make_production_mesh()) == (None, "data")


@pytest.mark.parametrize("spec", [("data", "model"), ("model", None, "data"), (None, ("data", "model")), ()])
def test_local_shards_tile_the_global_leaf(spec):
    """Every coordinate's ``local_shard`` of a leaf, put back by its
    ``shard_index``, is the leaf: the pieces are disjoint and cover it."""
    mesh = MESH.abstract_mesh((2, 4), ("data", "model"))
    t = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)
    back = torch.full_like(t, -1.0)
    for d in range(2):
        for m in range(4):
            coords = {"data": d, "model": m}
            piece = SH.local_shard(t, spec, mesh, coords)
            idx = [slice(None)] * t.ndim
            for dim, entry in enumerate(spec):
                n = SH.shard_count(entry, mesh)
                k = t.shape[dim] // n
                j = SH.shard_index(entry, mesh, coords)
                idx[dim] = slice(j * k, (j + 1) * k)
            assert torch.equal(t[tuple(idx)], piece)
            assert torch.all(back[tuple(idx)] == -1.0) or SH.shard_count(spec[0] if spec else None, mesh) < 8
            back[tuple(idx)] = piece
    assert torch.equal(back, t)
    with pytest.raises(ValueError, match="does not split"):
        SH.local_shard(torch.zeros(3, 5), ("data",), mesh, {"data": 0, "model": 0})


def test_meshes_and_their_errors():
    """The abstract production meshes, ``mesh_axes`` on either kind, and
    ``make_host_mesh``'s refusals (no process group; a mesh past the
    world)."""
    pod = MESH.make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert MESH.mesh_axes(MESH.make_production_mesh()) == {"data": 16, "model": 16}
    with pytest.raises(ValueError):
        MESH.abstract_mesh((2, 2), ("data",))
    import torch.distributed as dist
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            MESH.make_host_mesh(2, 1, device="cpu")


def test_shape_only_trees_hold_no_values():
    """``init_params(device="meta")`` is the port's ``eval_shape``: the
    full-width deepseek-v3-671b tree (671 B parameters) with the
    reference's leaf count and every leaf on ``meta``."""
    cfg = get_config("deepseek-v3-671b")
    p = Z.init_params(0, cfg, device="meta")
    leaves = tree.leaves(p)
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in leaves)
    rcfg = ref_get_config("deepseek-v3-671b")
    rp = jax.eval_shape(lambda k: RZ.init_params(k, rcfg), jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(rp))
    assert n > 6.0e11
    smoke = dataclasses.replace(cfg, n_layers=4)
    assert len(Z.init_params(0, smoke, device="meta")["layers"]) == 4

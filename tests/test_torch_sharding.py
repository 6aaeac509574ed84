"""The port's placement rules (``repro_torch.dist.sharding``, the logical
axes of ``models/params.py`` and ``models/model.py:abstract_cache``)
against the reference's ``repro.dist.sharding`` and ``abstract_params`` /
``abstract_cache`` on the CPU.

Meshes are abstract (``dist/mesh.py:AbstractMesh``: axis names and sizes,
which the reference's rules read too, so jax's ``AbstractMesh``, broken
on jax 0.9.0 (ROADMAP R1), is not needed): the production (data 16,
model 16) and (pod 2, data 16, model 16) meshes and a generic (data 4,
fsdp 2, tensor 2).

* For all 11 configs at full size, built on the meta device: every
  parameter's logical axes and spec equal its reference leaf's (found by
  ``convert.reference_path``; a stacked leaf's ``layers`` dim is
  replicated and left out), and ``tree_shard_bytes`` of the port's tree
  equals the reference's.
* Each config's cache in both layouts: ``check_cache_locality`` accepts
  it with the same specs leaf for leaf (the reference's per-layer leaves
  by key; the port keeps one page table where the reference copies it
  into every layer), and refuses a sharded ``window_seq`` on both sides.
* A leaf's DTensor placements on a one-rank gloo ``DeviceMesh`` and on
  the generic mesh, and its bytes a device.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.dist import sharding as ref  # noqa: E402
from repro.models.model import abstract_cache as ref_abstract_cache  # noqa
from repro.models.params import abstract_params as ref_abstract_params  # noqa
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs.base import src_len_for  # noqa: E402
from repro_torch.convert import reference_path  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.mesh import (  # noqa: E402
    AbstractMesh, init_world_of_one, make_abstract_production_mesh,
    make_device_mesh)
from repro_torch.models.model import abstract_cache  # noqa: E402
from repro_torch.models.params import abstract_params  # noqa: E402

MESHES = {"prod": make_abstract_production_mesh(),
          "multipod": make_abstract_production_mesh(multi_pod=True),
          "generic": AbstractMesh(("data", "fsdp", "tensor"), (4, 2, 2))}


def _ref_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_abstract_production_meshes_are_the_reference_s_shapes():
    assert MESHES["prod"].shape == {"data": 16, "model": 16}
    assert MESHES["multipod"].shape == {"pod": 2, "data": 16, "model": 16}
    assert dict(ref.DEFAULT_RULES.rules) == dict(sharding.DEFAULT_RULES.rules)


@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_parameter_specs_and_bytes_equal_the_reference_s(arch):
    rcfg, tcfg = ref_get_config(arch), get_config(arch)
    rtree = ref_abstract_params(rcfg)
    want = {path: ab for path, ab in _ref_leaves(rtree)}
    port = abstract_params(tcfg)
    assert all(p.device.type == "meta" for p in port.values())
    seen = set()
    for mesh in MESHES.values():
        for name, p in port.items():
            path, g = reference_path(tcfg, name)
            ab = want[path]
            seen.add(path)
            axes = p.logical_axes if g is None else \
                ("layers",) + p.logical_axes
            assert axes == tuple(ab.logical_axes), (name, axes)
            spec = sharding.logical_to_spec(p.logical_axes, p.shape, mesh)
            rspec = tuple(ref.logical_to_spec(ab.logical_axes, ab.shape,
                                              mesh))
            assert ((None,) + spec if g is not None and spec else spec) \
                == rspec, (name, spec, rspec)
        assert sharding.tree_shard_bytes(port, mesh) == \
            ref.tree_shard_bytes(rtree, mesh)
    assert seen == set(want)


def _ref_cache_specs(rcfg, layout, mesh, rules=ref.DEFAULT_RULES):
    """{(mixer, leaf): {spec}} of the reference's cache (the stacked
    groups' ``layers`` dim dropped)."""
    tree = ref_abstract_cache(rcfg, 32, 8192, src_len_for(rcfg, 8192),
                              layout=layout)
    out = {}
    for path, spec in ref.check_cache_locality(tree, mesh, rules).items():
        parts = path.split("/")
        spec = tuple(spec)
        if parts[0] == "groups" and spec:
            assert spec[0] is None, (path, spec)
            spec = spec[1:]
        out.setdefault(tuple(parts[-2:]), set()).add(spec)
    return out


#: the port's cache leaves by the reference's (mixer, leaf) key
CACHE_KEYS = {"k_pages": ("attn", "k_pages"), "v_pages": ("attn", "v_pages"),
              "ckv_pages": ("attn", "ckv_pages"),
              "krope_pages": ("attn", "krope_pages"),
              "page_table": ("attn", "page_table"),
              "k_dense": ("attn", "k"), "v_dense": ("attn", "v"),
              "pos_dense": ("attn", "pos"), "ckv": ("attn", "ckv"),
              "krope": ("attn", "krope"), "k": ("attn", "k"),
              "v": ("attn", "v"), "pos": ("attn", "pos"),
              "h": ("rec", "h"), "conv": ("rec", "conv"),
              "s": ("rwkv", "s"), "shift_tm": ("rwkv", "shift_tm"),
              "shift_cm": ("rwkv", "shift_cm"),
              "cross_k": ("cross", "k"), "cross_v": ("cross", "v")}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_cache_locality_specs_equal_the_reference_s(arch, layout):
    rcfg, tcfg = ref_get_config(arch), get_config(arch)
    cache = abstract_cache(tcfg, 32, 8192, src_len=src_len_for(tcfg, 8192),
                           layout=layout)
    for mesh in (MESHES["prod"], MESHES["generic"]):
        got = {}
        for path, spec in sharding.check_cache_locality(cache, mesh).items():
            got.setdefault(CACHE_KEYS[path.split("/")[0]], set()).add(
                tuple(spec))
        want = _ref_cache_specs(rcfg, layout, mesh)
        if "page_table" in cache and ("attn", "page_table") not in want:
            # a stack without global layers: the port keeps its one table
            want[("attn", "page_table")] = got[("attn", "page_table")]
        assert got == want, (arch, layout)
    # a sharded ring is refused on both sides
    if "k" in cache:
        rules = sharding.DEFAULT_RULES.override(window_seq=("model",))
        rrules = ref.DEFAULT_RULES.override(window_seq=("model",))
        with pytest.raises(ValueError, match="ring-buffer"):
            sharding.check_cache_locality(cache, MESHES["prod"], rules)
        with pytest.raises(ValueError, match="ring-buffer"):
            _ref_cache_specs(rcfg, layout, MESHES["prod"], rrules)


def test_run_overrides_remap_the_rules_as_the_reference_s_do():
    from repro.configs import get_run_config as ref_run
    from repro_torch.configs import get_run_config
    run = get_run_config("qwen2.5-32b", "train_4k")
    assert run.sharding_overrides == \
        ref_run("qwen2.5-32b", "train_4k").sharding_overrides
    rules = sharding.DEFAULT_RULES.override(**dict(run.sharding_overrides))
    rrules = ref.DEFAULT_RULES.override(**dict(run.sharding_overrides))
    assert rules.as_dict() == rrules.as_dict()
    assert rules.axes_for("resid_seq") == rules.axes_for("seq") == ("model",)
    with pytest.raises(KeyError, match="no sharding rule"):
        sharding.logical_to_spec(("embedding",), (8,), MESHES["prod"])


def test_placements_of_a_leaf_on_a_one_rank_mesh_and_the_generic_mesh():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    q = abstract_params(dataclasses.replace(get_config("qwen3-0.6b"),
                                            num_layers=1))["blocks.0.attn.q"]
    assert q.logical_axes == ("embed", "heads", "head_dim")
    gen = sharding.make_named_sharding(q.logical_axes, q.shape,
                                       MESHES["generic"])
    assert gen.spec == sharding.PartitionSpec(("fsdp", "data"), "tensor")
    assert gen.placements == (Shard(0), Shard(0), Shard(1))
    assert sharding.tree_shard_bytes({"q": q}, MESHES["generic"]) * 16 \
        == q.numel() * 4
    if dist.is_initialized():
        pytest.fail("a process group is already initialised here")
    init_world_of_one("cpu")
    try:
        mesh = make_device_mesh(device="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1, 1)
        one = sharding.make_named_sharding(q.logical_axes, q.shape, mesh)
        assert one.spec == gen.spec and one.placements == gen.placements
        # the vocabulary table: vocab over tensor, embed over fsdp and data
        prod = sharding.make_named_sharding(("vocab", "embed"), (64, 32),
                                            mesh)
        assert prod.placements == (Shard(1), Shard(1), Shard(0))
        t = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
        d = distribute_tensor(t, mesh, prod.placements)
        assert torch.equal(d.to_local(), t)
        assert torch.equal(d.full_tensor(), t)
        rep = sharding.make_named_sharding((None, "lora"), (4, 8), mesh)
        assert rep.spec == sharding.PartitionSpec() and \
            rep.placements == (Replicate(),) * 3
    finally:
        dist.destroy_process_group()

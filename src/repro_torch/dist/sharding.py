"""Logical-axis sharding (the reference's ``dist/sharding.py``): one rule
table maps model-space axis names to mesh axes; specs, DTensor
placements and per-device bytes follow from it mechanically.

Parameters and caches carry *logical* axis names (``"embed"``,
``"heads"``, ``"cache_batch"`` ...; ``models/params.py`` and
``models/model.py:abstract_cache``); the table decides which mesh axes
each one shards over.  Three rules hold when a spec is built:

* **absent**: a rule may name mesh axes the mesh does not have
  (``"pod"`` on a single-pod mesh, ``"fsdp"`` on the production mesh);
  they are skipped, so one table serves every mesh;
* **indivisible**: a mesh axis whose size does not divide the dimension
  is skipped (``kv_heads=2`` over ``model=16`` replicates);
* **use-once**: a mesh axis already taken by an earlier dimension of the
  same spec is skipped.

A spec is a :class:`PartitionSpec`, one entry per leading dimension
(None, a mesh axis, or a tuple of them), trailing replicated dimensions
trimmed, as the reference's ``jax.sharding.PartitionSpec``.
:func:`make_named_sharding` turns it into DTensor placements, one per
mesh dimension: ``Shard(d)`` where the dimension's entry names that mesh
axis, ``Replicate()`` elsewhere.  Where one tensor dimension takes
several mesh axes, DTensor splits it over them in the mesh's dimension
order, whatever order the spec names them in (the reference's
``("fsdp", "data")`` on a ``("data", "fsdp", "tensor")`` mesh puts fsdp
outermost): the bytes a device holds agree, the positions of its blocks
need not (ROADMAP D16).

A mesh is a ``DeviceMesh`` or anything with ``axis_names`` and
``axis_sizes`` (``dist/mesh.py:AbstractMesh``), so placement arithmetic
needs no ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.dist.mesh import axis_sizes

AxisName = Optional[str]
MeshAxes = Tuple[str, ...]


def _normalize(axes: Union[None, str, Sequence[str]]) -> MeshAxes:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a sharded tensor: ``None``, a mesh axis
    name or a tuple of them a dimension (the reference's
    ``jax.sharding.PartitionSpec``, compared as a tuple)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    """Immutable logical-axis → mesh-axes table, as a tuple of pairs (so
    rule sets are hashable).  Mesh axes are tried in rule order; see the
    module docstring for the drop rules."""

    rules: Tuple[Tuple[str, MeshAxes], ...] = ()

    def as_dict(self) -> Dict[str, MeshAxes]:
        return dict(self.rules)

    def axes_for(self, logical: str) -> MeshAxes:
        table = self.as_dict()
        if logical not in table:
            raise KeyError(
                f"no sharding rule for logical axis {logical!r}; "
                f"known: {sorted(table)}")
        return table[logical]

    def override(self, **kw: Union[None, str, Sequence[str]]
                 ) -> "ShardingRules":
        """New table with the given logical axes remapped (or added).
        ``axis=()`` / ``axis=None`` replicates; ``axis="model"`` or
        ``axis=("model", "pod")`` shards."""
        table = self.as_dict()
        table.update({k: _normalize(v) for k, v in kw.items()})
        return ShardingRules(tuple(sorted(table.items())))


# ---------------------------------------------------------------------------
# The production rule table (the reference's, entry for entry).
#   * ``*_act`` names are activation axes; bare names are parameter axes.
#   * Parameters: FSDP over the data-parallel axis on "embed", tensor
#     parallelism over the model axis on heads, ffn, vocab and experts.
#   * Activations: batch over data, embed replicated, logits
#     vocab-sharded, the residual's sequence replicated unless an
#     override turns ``resid_seq`` on.
#   * Caches: ``kv_seq`` (a global cache's positions) over the tensor
#     axis, dropped by use-once where ``kv_heads`` took it;
#     ``window_seq`` (a ring's slots) never sharded; ``cache_pages`` (the
#     paged pool, which has no batch dim) over the batch-like axes and
#     the tensor axis.
#   * Each rule lists alternatives for both mesh vocabularies; absent
#     names drop out.
# ---------------------------------------------------------------------------
DEFAULT_RULES = ShardingRules().override(
    # activation axes
    batch=("pod", "data"),
    cache_batch=("pod", "data"),
    seq=(),
    resid_seq=(),            # override to ("model",) for Megatron-SP residuals
    kv_seq=("tensor", "model"),
    window_seq=(),
    cache_pages=("pod", "data", "tensor", "model"),
    embed_act=(),
    vocab_act=("tensor", "model"),
    # parameter axes
    embed=("fsdp", "data"),
    vocab=("tensor", "model"),
    heads=("tensor", "model"),
    kv_heads=("tensor", "model"),
    head_dim=(),
    ffn=("tensor", "model"),
    experts=("tensor", "model"),
    expert_ffn=(),
    capacity=(),
    rnn=("tensor", "model"),
    lora=(),
    conv=(),
    layers=(),               # the reference's scan dim is never sharded
)


def logical_to_spec(logical_axes: Sequence[AxisName], shape: Sequence[int],
                    mesh, rules: ShardingRules = DEFAULT_RULES
                    ) -> PartitionSpec:
    """Map per-dimension logical axis names to a valid spec.  ``None``
    entries replicate that dimension; an unknown logical name raises
    ``KeyError`` (a typo must fail loudly, not silently replicate);
    trailing replicated dimensions are trimmed."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    sizes = axis_sizes(mesh)
    used: set = set()
    entries: list = []
    for name, dim in zip(logical_axes, shape):
        if name is None:
            entries.append(None)
            continue
        chosen: list = []
        prod = 1
        for ax in rules.axes_for(name):
            if ax not in sizes or ax in used:
                continue
            if dim % (prod * sizes[ax]) != 0:
                continue
            chosen.append(ax)
            prod *= sizes[ax]
        used.update(chosen)
        if not chosen:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def _entry_axes(entry) -> MeshAxes:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)
    and its DTensor ``placements``."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """One placement per mesh dimension, in the mesh's order:
        ``Shard(d)`` where tensor dimension d's entry names the mesh axis,
        else ``Replicate()`` (``distribute_tensor(t, mesh, placements)``
        takes it)."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {ax: d for d, entry in enumerate(self.spec)
                  for ax in _entry_axes(entry)}
        return tuple(Shard(dim_of[ax]) if ax in dim_of else Replicate()
                     for ax in axis_sizes(self.mesh))


def make_named_sharding(logical_axes: Sequence[AxisName],
                        shape: Sequence[int], mesh,
                        rules: ShardingRules = DEFAULT_RULES
                        ) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical_axes, shape, mesh,
                                               rules))


# ---------------------------------------------------------------------------
# Tree-wide inference over abstract leaves: anything with ``.shape`` and
# ``.logical_axes`` (a parameter of a meta-device model,
# ``models/params.py:ParamAb``, a leaf of ``models/model.py:
# abstract_cache``), in nested dicts and lists.
# ---------------------------------------------------------------------------
def is_abstract_leaf(x) -> bool:
    return hasattr(x, "logical_axes") and hasattr(x, "shape")


def _leaves_with_path(tree, path: Tuple[str, ...] = ()):
    """``(path, leaf)`` of every abstract leaf of ``tree`` (dict keys in
    sorted order, list positions in order)."""
    if is_abstract_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves_with_path(x, path + (str(i),))


def _map(fn, tree):
    if is_abstract_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    raise TypeError(f"not an abstract leaf or a container: {type(tree)}")


def tree_shardings(tree, mesh, rules: ShardingRules = DEFAULT_RULES):
    """A :class:`NamedSharding` for every abstract leaf of ``tree``."""
    return _map(lambda ab: make_named_sharding(ab.logical_axes, ab.shape,
                                               mesh, rules), tree)


def _shard_factor(spec: PartitionSpec, sizes: Dict[str, int]) -> int:
    f = 1
    for entry in spec:
        for ax in _entry_axes(entry):
            f *= sizes[ax]
    return f


def check_cache_locality(tree, mesh, rules: ShardingRules = DEFAULT_RULES
                         ) -> Dict[str, PartitionSpec]:
    """Well-formedness of a KV cache's sharding: decode's gathers and
    scatters must stay shard-local.  Per abstract cache leaf:

    * ``window_seq`` dims are replicated: the ring's ``pos % window``
      scatter wraps, so a sharded ring would cross shards every step;
    * unnamed (``None``) dims (position metadata, a page table's page
      dim, a pool's within-page dim) are replicated: they are read whole
      every step.

    These are spec-level invariants; which physical page a sequence's
    table points at is runtime data, kept shard-local by the serving
    allocator.  Returns ``{leaf path: spec}``; raises ``ValueError`` on
    the first violation."""
    out: Dict[str, PartitionSpec] = {}
    for path, ab in _leaves_with_path(tree):
        name = "/".join(path)
        spec = logical_to_spec(ab.logical_axes, ab.shape, mesh, rules)
        entries = tuple(spec) + (None,) * (len(ab.shape) - len(spec))
        for lax_name, entry in zip(ab.logical_axes, entries):
            axes = _entry_axes(entry)
            if lax_name == "window_seq" and axes:
                raise ValueError(
                    f"cache leaf {name!r}: ring-buffer slot dim is sharded "
                    f"over {axes} — the pos%window scatter would cross "
                    f"shards every decode step; map 'window_seq' to ()")
            if lax_name is None and axes:
                raise ValueError(
                    f"cache leaf {name!r}: metadata dim sharded over {axes} "
                    f"— pos/page-table metadata must be replicated")
        out[name] = spec
    return out


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize


def tree_shard_bytes(tree, mesh, rules: ShardingRules = DEFAULT_RULES,
                     dtype_override=None) -> int:
    """Per-device bytes of the sharded tree (placement planning, nothing
    allocated).  Divisibility is exact: every kept mesh axis divides its
    dimension.  A leaf without a dtype counts as fp32."""
    sizes = axis_sizes(mesh)
    total = 0
    for _, ab in _leaves_with_path(tree):
        spec = logical_to_spec(ab.logical_axes, ab.shape, mesh, rules)
        dt = dtype_override if dtype_override is not None \
            else getattr(ab, "dtype", torch.float32)
        n = 1
        for d in ab.shape:
            n *= int(d)
        total += n * _itemsize(dt) // _shard_factor(spec, sizes)
    return total

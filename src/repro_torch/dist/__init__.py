"""``repro_torch.dist``: the distribution layer (the reference's
``repro.dist``) on ``torch.distributed``.

* :mod:`repro_torch.dist.sharding`    — logical-axis → spec rules (one
  table, overridable per run) and tree-wide placements (DTensor).
* :mod:`repro_torch.dist.compression` — gradient compression with error
  feedback (the paper's efficiency-vs-dependability knob) and the int8
  all-reduce.
* :mod:`repro_torch.dist.mesh`        — device meshes (production pod
  meshes, data/fsdp/tensor meshes, a one-rank host mesh).

The train step takes compression (``RunConfig.grad_compression``);
execution on a mesh of more than one rank comes in a later slice of the
port (``launch/spec.py`` refuses a ``mesh`` other than ``"host"``).
"""
from repro_torch.dist.compression import (  # noqa: F401
    CompressionConfig,
    compress_grads,
    init_error_buffers,
    pack_int8,
    resolve_compression,
    unpack_int8,
    wire_bytes_int8,
)
from repro_torch.dist.mesh import (  # noqa: F401
    axis_sizes,
    make_device_mesh,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.dist.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    logical_to_spec,
    make_named_sharding,
    tree_shard_bytes,
    tree_shardings,
)

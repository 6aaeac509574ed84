"""The int8 all-reduce (``repro_torch.dist.compression.allreduce_int8``,
``sharded_allreduce_int8``) on ``torch.distributed``.

* Four gloo ranks, spawned once as processes on the CPU (a file store in
  the test's temporary directory, no network), run every case in one
  group: per-rank magnitudes 100× apart (as ``tests/test_train.py``'s
  fake-device test: unreconciled scales would be garbage), chunked and
  per-tensor scales, a tensor of zeros, and the sum over the ``data``
  axis of a (data 2, fsdp 2) mesh, whose two groups sum their own pairs.
  Every rank's result equals, bit for bit, the reference's
  ``allreduce_int8`` over the same inputs stacked (ndev, ...), its
  ``pmax`` and ``psum`` run by ``jax.vmap`` over a named axis on one CPU
  device (op by op, as the reference's source divides); and it lies
  within the reference's bound ndev·scale/2 of the dense fp32 sum (scale
  = the chunk's max-abs over the group / 127), and is not exact.
* A world of one: the all-reduce over a one-rank host mesh is the
  pack/unpack round trip, bit for bit (``tests/test_train.py``'s
  one-device case).
* Building a mesh without an initialised process group raises.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dist import compression as ref  # noqa: E402
from repro_torch.dist import compression as comp  # noqa: E402
from repro_torch.dist.mesh import (  # noqa: E402
    init_world_of_one, make_device_mesh, make_host_mesh)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MAGS = (0.03, 0.5, 1.0, 3.0)

# Every rank draws every rank's inputs from one seed, sums its own part
# over the group and writes what it got.
RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist.compression import (CompressionConfig, allreduce_int8,
                                          sharded_allreduce_int8)
from repro_torch.dist.mesh import make_device_mesh

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
mags = json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)
rng = np.random.default_rng(11)
xs = {"chunked": rng.normal(size=(world, 13, 9)),
      "per_tensor": rng.normal(size=(world, 7, 11)),
      "zeros": np.zeros((world, 5, 3))}
xs = {k: (v * np.array(mags)[:, None, None]).astype(np.float32)
      for k, v in xs.items()}
cfgs = {"chunked": CompressionConfig(chunk_size=16),
        "per_tensor": CompressionConfig(), "zeros": CompressionConfig()}
got = {k: allreduce_int8(torch.from_numpy(x[rank]), None, cfgs[k]).numpy()
       for k, x in xs.items()}
mesh = make_device_mesh(data=2, fsdp=2, device="cpu")
got["mesh_data"] = sharded_allreduce_int8(
    torch.from_numpy(xs["chunked"][rank]), mesh, "data",
    cfgs["chunked"]).numpy()
coord = mesh.get_coordinate()
np.savez(out, coord=np.array(coord), **got)
dist.destroy_process_group()
"""


def _reference(xs, chunk):
    """The reference's int8 all-reduce of the rows of ``xs`` (ndev, ...):
    ``allreduce_int8`` under ``jax.vmap`` over the named axis ``data``,
    one result a row."""
    cfg = ref.CompressionConfig(chunk_size=chunk)
    return np.asarray(jax.vmap(lambda r: ref.allreduce_int8(r, "data", cfg),
                               axis_name="data")(jnp.asarray(xs)))


def _bound(xs, chunk):
    """ndev·scale/2 an element, scale the chunk's max-abs over the ranks
    of ``xs`` (ndev, ...) / 127."""
    ndev = xs.shape[0]
    flat = xs.reshape(ndev, -1)
    chunk = chunk or flat.shape[1]
    pad = (-flat.shape[1]) % chunk
    blocks = np.pad(flat, ((0, 0), (0, pad))).reshape(ndev, -1, chunk)
    scales = (np.abs(blocks).max(axis=2) / 127).max(axis=0)
    return np.repeat(scales, chunk)[:flat.shape[1]].reshape(xs.shape[1:]) \
        * ndev / 2


def test_four_gloo_ranks_stay_within_the_bound_and_agree(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(WORLD), str(store),
         str(tmp_path / f"rank{r}.npz"), json.dumps(MAGS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    rng = np.random.default_rng(11)
    xs = {"chunked": rng.normal(size=(WORLD, 13, 9)),
          "per_tensor": rng.normal(size=(WORLD, 7, 11)),
          "zeros": np.zeros((WORLD, 5, 3))}
    xs = {k: (v * np.array(MAGS)[:, None, None]).astype(np.float32)
          for k, v in xs.items()}
    for name, chunk in (("chunked", 16), ("per_tensor", 0), ("zeros", 0)):
        exact = xs[name].sum(axis=0)
        want = _reference(xs[name], chunk)
        for r in range(WORLD):               # the reference's, every rank
            np.testing.assert_array_equal(got[r][name], want[r], name)
        err = np.abs(got[0][name] - exact)
        assert np.all(err <= _bound(xs[name], chunk) + 1e-6), \
            (name, err.max())
        if name == "zeros":
            assert not got[0][name].any()
        else:                                 # a real int8 wire: not exact
            assert err.max() > 0, name
    # the (data 2, fsdp 2) mesh: ranks with the same fsdp coordinate sum
    # over data, each pair its own
    by_fsdp = {}
    for r in range(WORLD):
        by_fsdp.setdefault(int(got[r]["coord"][1]), []).append(r)
    assert sorted(map(len, by_fsdp.values())) == [2, 2]
    for ranks in by_fsdp.values():
        part = xs["chunked"][ranks]
        want = _reference(part, 16)
        for i, r in enumerate(ranks):
            np.testing.assert_array_equal(got[r]["mesh_data"], want[i])
        err = np.abs(got[ranks[0]]["mesh_data"] - part.sum(axis=0))
        assert np.all(err <= _bound(part, 16) + 1e-6), err.max()


@pytest.fixture
def world_of_one():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.fail("a process group is already initialised here")
    init_world_of_one("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_world_of_one_is_the_pack_unpack_round_trip(world_of_one):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(7, 11))
                         .astype(np.float32))
    cfg = comp.CompressionConfig(chunk_size=16)
    mesh = make_host_mesh("cpu")
    assert (mesh.mesh_dim_names, tuple(mesh.mesh.shape)) == \
        (("data", "model"), (1, 1))
    out = comp.sharded_allreduce_int8(x, mesh, axis="data", cfg=cfg)
    payload, scales = comp.pack_int8(x, cfg)
    torch.testing.assert_close(out, comp.unpack_int8(payload, scales,
                                                     (7, 11)),
                               rtol=0, atol=0)
    assert not torch.equal(out, x)


def test_a_mesh_needs_an_initialised_process_group():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.fail("a process group is already initialised here")
    for build in (lambda: make_host_mesh("cpu"),
                  lambda: make_device_mesh(device="cpu")):
        with pytest.raises(RuntimeError, match="no process group"):
            build()
    assert not dist.is_initialized()

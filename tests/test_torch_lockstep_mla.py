"""Lockstep serving of deepseek-v2-236b (MLA) over the dense latent cache
against the JAX reference on the CPU, as ``tests/test_torch_lockstep.py``
does for the GQA configs: the prefill expands the latent and runs the
flash path at qk 24 / v 16 (192 / 128 at full width), the decode scores
the dense latents with the weight absorption, plain as in the
reference."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lockstep import (  # noqa: E402
    ATOL, B, CPU, P, check_against_reference, configs, inputs, run_port,
    weights,
)

from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


ARCH = "deepseek-v2-236b"


def test_dense_lockstep_matches_reference():
    """Logits of the prefill and four decode steps, and every layer's
    ``ckv``, ``krope`` and shared ``pos``, within 1e-4."""
    check_against_reference(ARCH)


def test_dense_cache_layout():
    _, tcfg = configs(ARCH)
    cache = port_model.init_cache(tcfg, 2, 24, device=CPU)
    assert sorted(cache) == ["ckv", "krope", "pos_dense"]
    assert all(tuple(t.shape) == (2, 24, 16) for t in cache["ckv"])
    assert all(tuple(t.shape) == (2, 24, 8) for t in cache["krope"])
    assert all(tuple(t.shape) == (24,) and (t == -1).all()
               for t in cache["pos_dense"])
    assert len(cache["ckv"]) == tcfg.num_layers


def test_dense_matches_paged_identity():
    """The dense latent cache against the paged one with identity tables
    (the reference's ``test_paged_matches_dense_decode`` for MLA)."""
    _, tcfg = configs(ARCH)
    _, tparams, _ = weights(ARCH)
    toks, src = inputs(tcfg)
    dense, _ = run_port(tcfg, tparams, toks, src)
    paged, cache = run_port(dataclasses.replace(tcfg, cache_layout="paged"),
                            tparams, toks, src, layout="paged")
    assert "ckv_pages" in cache
    err = max(float(np.abs(a - b).max()) for a, b in zip(dense, paged))
    assert err < ATOL, err


def test_the_dense_latent_cache_is_lockstep_only():
    """Per-row decode positions and a ragged prefill raise, with the
    reference's reasons."""
    _, tcfg = configs(ARCH)
    _, tparams, _ = weights(ARCH)
    toks, _ = inputs(tcfg)
    ctx = Ctx(device=CPU, dtype=torch.float32)
    cache = port_model.init_cache(tcfg, B, P + 4, device=CPU)
    prompt = {"tokens": torch.from_numpy(toks[:, :P]).long()}
    with pytest.raises(NotImplementedError, match="ragged prefill over MLA"):
        port_model.forward(tcfg, tparams, prompt, ctx, mode="prefill",
                           cache=cache, lengths=torch.tensor([P, 9]))
    port_model.forward(tcfg, tparams, prompt, ctx, mode="prefill",
                       cache=cache)
    with pytest.raises(NotImplementedError,
                       match="per-sequence MLA decode positions"):
        port_model.forward(
            tcfg, tparams, {"tokens": torch.from_numpy(toks[:, P:P + 1])
                            .long()}, ctx, mode="decode", cache=cache,
            pos=torch.tensor([P, P]))

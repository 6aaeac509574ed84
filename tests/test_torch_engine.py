"""The port's continuous-batching engine against the JAX ``ServingEngine``
on the CPU, and its snapshot/restore.

Both engines serve ``qwen3-0.6b`` ``.reduced()`` in fp32 (fp32 KV pools
too) with the same weights (the reference's, converted by tree path) and
the same ``Request`` list, drawn by the port's ``synthesize_requests``.
Greedy decoding must give identical token streams, and the host-side
state (page tables, free lists, refcounts, prefix index, journal) must be
equal, with the prefix cache on and off and under eviction
(``overcommit > 1`` over a small page budget).  The reference runs with
``Ctx(mesh=None, dtype=float32)``; its CLI and ``RealServePayload`` are
never used as oracles.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.jobspec import ServeSpec as RefServeSpec  # noqa: E402
from repro.launch import engine as ref_engine  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import engine  # noqa: E402
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models.params import Model  # noqa: E402

CPU = torch.device("cpu")
OVER = dict(cache_layout="paged", dtype="float32")

# name: ServeSpec fields; a small page budget with overcommit forces evictions
CASES = {
    "prefix-cache": dict(batch=3, prompt_len=20, gen=6, requests=7,
                         prefix_cache=True, shared_prefix_frac=0.5),
    "no-prefix-cache": dict(batch=3, prompt_len=20, gen=6, requests=7,
                            prefix_cache=False),
    "evict-prefix-cache": dict(batch=3, prompt_len=20, gen=6, requests=7,
                               prefix_cache=True, shared_prefix_frac=0.4,
                               page_budget=8, overcommit=2.0),
}

HOST_STATE = ("host_table", "free_lists", "refcount", "page_meta",
              "prefix_index", "reserved", "toks", "pos", "responses",
              "journal", "stats")


@pytest.fixture(scope="module")
def weights():
    rcfg = dataclasses.replace(ref_get_config("qwen3-0.6b").reduced(), **OVER)
    tcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), **OVER)
    rparams = ref_init_params(rcfg, jax.random.key(0))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rcfg, tcfg, rparams, model


def _engines(weights, spec):
    rcfg, tcfg, rparams, model = weights
    rctx = RefCtx(mesh=None, dtype=jnp.float32)
    ref = ref_engine.ServingEngine(rcfg, rctx, rparams, RefServeSpec(**spec))
    port = engine.ServingEngine(tcfg, model, ServeSpec(**spec), device=CPU,
                                dtype=torch.float32)
    requests = engine.synthesize_requests(tcfg, ServeSpec(**spec), seed=3)
    for r in requests:
        ref.submit(ref_engine.Request(req=r.req, tokens=r.tokens.copy(),
                                      gen_len=r.gen_len))
        port.submit(r)
    return ref, port, requests


def _assert_same_host_state(port_snap, ref_snap):
    for key in HOST_STATE:
        a, b = port_snap[key], ref_snap[key]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_token_streams_match_reference(weights, case):
    ref, port, requests = _engines(weights, CASES[case])
    # lockstep: after every admission round and decode step the two
    # engines hold the same host state
    while not port.idle:
        for eng in (ref, port):
            eng.admit()
        if all(s is None for s in port.slots):
            assert all(s is None for s in ref.slots)
            continue
        for eng in (ref, port):
            eng.step()
        _assert_same_host_state(port.snapshot(), ref.snapshot())
    assert ref.idle
    assert port.responses == ref.responses
    assert sorted(port.responses) == [r.req for r in requests]
    for r in requests:
        assert len(port.responses[r.req]) == r.gen_len
    if case.startswith("evict"):
        assert port.evictions > 0
    if CASES[case]["prefix_cache"]:
        assert port.prefix_hits > 0 and port.cached_tokens > 0
    rc = ref.snapshot()["cache"]["groups"]["0"]["attn"]
    for i, (k, v) in enumerate(zip(port.cache["k_pages"],
                                   port.cache["v_pages"])):
        np.testing.assert_allclose(k.numpy(), np.asarray(rc["k_pages"][i]),
                                   atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(rc["v_pages"][i]),
                                   atol=1e-4)


@pytest.mark.parametrize("case", ["prefix-cache", "evict-prefix-cache"])
def test_snapshot_restore_continues_byte_identically(weights, case):
    _, tcfg, _, model = weights
    spec = ServeSpec(**CASES[case])
    requests = engine.synthesize_requests(tcfg, spec, seed=5)
    run = engine.ServingEngine(tcfg, model, spec, device=CPU,
                               dtype=torch.float32)
    for r in requests:
        run.submit(r)
    run.admit()
    run.step()
    run.step()
    snap = run.snapshot()
    run.run()

    fresh = engine.ServingEngine(tcfg, model, spec, device=CPU,
                                 dtype=torch.float32)
    fresh.restore(snap)
    again = fresh.snapshot()
    _assert_same_host_state(again, snap)
    for name in ("k_pages", "v_pages"):
        for a, b in zip(again["cache"][name], snap["cache"][name]):
            assert torch.equal(a, b)
    # the snapshot is a copy: the live engine's later in-place writes did
    # not reach it
    assert not all(torch.equal(a, b) for a, b in
                   zip(snap["cache"]["k_pages"], run.cache["k_pages"]))
    fresh.run()
    assert fresh.responses == run.responses
    assert fresh.journal == run.journal
    for name in ("k_pages", "v_pages"):
        for a, b in zip(fresh.cache[name], run.cache[name]):
            assert torch.equal(a, b)


def test_engine_rejects_bad_specs(weights):
    _, tcfg, _, model = weights
    with pytest.raises(ValueError, match="page budget"):
        engine.ServingEngine(tcfg, model, ServeSpec(page_budget=1),
                             device=CPU)
    with pytest.raises(ValueError, match="overcommit"):
        engine.ServingEngine(tcfg, model, ServeSpec(overcommit=0.5),
                             device=CPU)
    eng = engine.ServingEngine(tcfg, model, ServeSpec(batch=2, prompt_len=8,
                                                      gen=4), device=CPU)
    with pytest.raises(ValueError, match="pages worst-case"):
        eng.submit(engine.Request(req=0, tokens=np.zeros(200, np.int64),
                                  gen_len=4))


def test_synthesized_workload_is_a_function_of_the_seed():
    cfg = get_config("qwen3-0.6b").reduced()
    spec = ServeSpec(prompt_len=32, gen=8, requests=5, shared_prefix_frac=0.5)
    a = engine.synthesize_requests(cfg, spec, seed=1)
    b = engine.synthesize_requests(cfg, spec, seed=1)
    c = engine.synthesize_requests(cfg, spec, seed=2)
    assert [r.tokens.tolist() for r in a] == [r.tokens.tolist() for r in b]
    assert [r.tokens.tolist() for r in a] != [r.tokens.tolist() for r in c]
    assert all(len(r.tokens) == 32 for r in a)         # full length shared
    assert all((r.tokens[:16] == a[0].tokens[:16]).all() for r in a)
    ragged = engine.synthesize_requests(
        cfg, dataclasses.replace(spec, shared_prefix_frac=0.0), seed=1)
    assert all(16 <= len(r.tokens) <= 32 for r in ragged)
    assert all(4 <= r.gen_len <= 8 for r in ragged)

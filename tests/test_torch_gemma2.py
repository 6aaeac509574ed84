"""The port's gemma2 slice against the JAX reference on the CPU: serving.

gemma2-9b mixes sliding-window (local) and global attention layers and
adds the attention-logit and final-logit softcaps, ``query_pre_attn_scalar``
and a norm after each block's attention and FFN (``post_norm``,
``post_ffn_norm``).  At ``.reduced()`` (3 layers: local, global, local;
window 16, H 4 over K 2, hd 16) the reference's own weights, converted by
tree path, go through both packages: prefill logits with prompts longer
than the window (so the local layers see less than the global one),
ragged prefill then decode (the local rings wrap, the global layers'
pages fill), every cache leaf, the engine's token streams and host state,
and snapshot/restore.  The reference runs with ``Ctx(mesh=None,
dtype=float32)`` (its model path takes ``flash_attention_jnp``); both
sides keep fp32 caches (``cfg.dtype="float32"``).

Tolerance: 1e-4 absolute on logits and cached K/V, as in
``test_torch_model.py`` (fp32, sums in another order than XLA's); token
streams and host state equal.
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
from repro.models import model as ref_model  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import count_params as ref_count  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import engine, serve  # noqa: E402
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import Model, cast_params, count_params  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


ATOL = 1e-4
CPU = torch.device("cpu")
ARCH = "gemma2-9b"
RING_LEAVES = ("k", "v", "pos")
PAGE_LEAVES = ("k_pages", "v_pages")


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _configs(**narrow):
    over = dict(cache_layout="paged", dtype="float32", **narrow)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


def _weights(rcfg, tcfg, seed=0):
    rparams = ref_init_params(rcfg, jax.random.key(seed))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rparams, model


@pytest.fixture(scope="module")
def pair():
    rcfg, tcfg = _configs()
    rparams, model = _weights(rcfg, tcfg)
    return rcfg, tcfg, rparams, cast_params(model, torch.float32)


def _rctx():
    return RefCtx(mesh=None, dtype=jnp.float32)


def _tctx():
    return Ctx(device=CPU, dtype=torch.float32)


def test_gemma2_config_is_a_faithful_copy_with_every_gemma2_feature():
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
    assert tcfg.layer_kinds() == ("local", "global") * 21
    assert (tcfg.attn_logit_softcap, tcfg.final_logit_softcap,
            tcfg.query_pre_attn_scalar, tcfg.use_post_block_norm,
            tcfg.tie_embeddings) == (50.0, 30.0, 256.0, True, True)
    small = tcfg.reduced()
    assert small.layer_kinds() == ("local", "global", "local")
    assert small.window_size == 16


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_gemma2_count_params_matches_reference(reduced):
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    if reduced:
        rcfg, tcfg = rcfg.reduced(), tcfg.reduced()
    for embed in (False, True):
        assert count_params(tcfg, include_embed=embed) == \
            ref_count(rcfg, include_embed=embed)


def test_converted_reference_tree_has_the_post_block_norms(pair):
    """Every layer holds ``post_norm`` and ``post_ffn_norm`` (D,) beside
    its pre-norms; the reference's stacked groups and its tail land on
    layers 0..2 by tree path."""
    rcfg, tcfg, rparams, _ = pair
    state = params_from_jax(jax.device_get(rparams), tcfg)
    model = Model(tcfg, device=CPU)
    assert sorted(state) == sorted(n for n, _ in model.named_parameters())
    for i in range(tcfg.num_layers):
        for name in ("pre_norm", "post_norm", "ffn_norm", "post_ffn_norm"):
            assert tuple(state[f"blocks.{i}.{name}"].shape) == (64,)
    tree = jax.device_get(rparams)["decoder"]
    np.testing.assert_array_equal(
        state["blocks.1.post_norm"].numpy(),
        np.asarray(tree["groups"]["1"]["post_norm"][0]))
    np.testing.assert_array_equal(
        state["blocks.2.attn.q"].numpy(),
        np.asarray(tree["tail"]["0"]["attn"]["q"]))


def _ref_leaf(cfg, cache, kind, name):
    """The reference's per-layer leaves of ``kind`` in layer order, stacked
    (groups are stacked on a leading dim, the tail is not)."""
    pat = len(cfg.block_pattern)
    n_body = cfg.num_layers // pat * pat
    out = []
    for i, k in enumerate(cfg.layer_kinds()):
        if k != kind:
            continue
        if i < n_body:
            leaf = cache["groups"][str(i % pat)]["attn"][name][i // pat]
        else:
            leaf = cache["tail"][str(i - n_body)]["attn"][name]
        out.append(_np(leaf))
    return np.stack(out)


def _assert_same_cache(cfg, tc, rc):
    for kind, names in (("local", RING_LEAVES), ("global", PAGE_LEAVES)):
        for name in names:
            port = np.stack([t.float().numpy() for t in tc[name]])
            np.testing.assert_allclose(port, _ref_leaf(cfg, rc, kind, name),
                                       atol=ATOL, err_msg=name)


def test_mixed_cache_layout():
    """The local layers hold rings, the global one pages, every layer its
    own leaves."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              cache_layout="paged")
    cache = port_model.init_cache(cfg, 2, 24, device=CPU)
    assert sorted(cache) == ["k", "k_pages", "page_table", "pos", "v",
                             "v_pages"]
    assert len(cache["k"]) == len(cache["pos"]) == 2
    assert len(cache["k_pages"]) == len(cache["v_pages"]) == 1
    assert tuple(cache["k"][0].shape) == (2, 2, 16, 16)
    assert tuple(cache["k_pages"][0].shape) == (6, 2, 8, 16)
    assert tuple(cache["page_table"].shape) == (2, 3)


def test_prefill_logits_with_both_softcaps_match_reference(pair):
    """A plain prefill of 40 tokens (2.5 windows): the local layers attend
    over 16 keys, the global one over all; the final logits are capped at
    30, so none passes it."""
    rcfg, tcfg, rparams, tparams = pair
    B, S = 2, 40
    tokens = np.random.default_rng(5).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    rc = ref_model.init_cache(rcfg, B, S + 8, layout="paged",
                              page_budget=B * 6, paged_tables="identity")
    tc = port_model.init_cache(tcfg, B, S + 8, page_budget=B * 6,
                               device=CPU)
    tc["page_table"].copy_(torch.arange(B * 6, dtype=torch.int32)
                           .reshape(B, 6))
    rl, rc, _ = ref_model.forward(rcfg, rparams, {"tokens": jnp.asarray(tokens)},
                                  _rctx(), mode="prefill", cache=rc)
    tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(tokens).long()},
                                _tctx(), mode="prefill", cache=tc)
    live = tl[..., :tcfg.vocab_size]
    assert float(live.abs().max()) < tcfg.final_logit_softcap
    np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
    _assert_same_cache(tcfg, tc, rc)


def test_forward_prefill_ragged_decode_match_reference(pair):
    """A plain prefill (prompts longer than the window) fills every row; a
    ragged prefill re-prefills rows 0 and 2 (row 1 has length 0 and keeps
    its rings byte for byte); four decode steps follow, the rings
    wrapping and the global layer reading its pages through the paged
    decode's plain version.  Logits and every cache leaf agree with the
    reference at each stage."""
    rcfg, tcfg, rparams, tparams = pair
    B, max_len = 3, 48
    ps = tcfg.page_size
    pps = -(-max_len // ps)
    table = np.random.default_rng(3).permutation(B * pps).astype(np.int32)
    table = table.reshape(B, pps)
    rng = np.random.default_rng(11)
    first = rng.integers(0, rcfg.vocab_size, (B, 21)).astype(np.int32)
    second = rng.integers(0, rcfg.vocab_size, (B, 30)).astype(np.int32)
    lengths = np.array([30, 0, 9], np.int32)
    rc = ref_model.init_cache(rcfg, B, max_len, layout="paged",
                              page_budget=B * pps, paged_tables="empty")
    rc = ref_engine._set_page_tables(rc, table)
    tc = port_model.init_cache(tcfg, B, max_len, page_budget=B * pps,
                               device=CPU)
    tc["page_table"].copy_(_t(table))

    rl, rc, _ = ref_model.forward(rcfg, rparams,
                                  {"tokens": jnp.asarray(first)}, _rctx(),
                                  mode="prefill", cache=rc)
    tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(first).long()},
                                _tctx(), mode="prefill", cache=tc)
    np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
    _assert_same_cache(tcfg, tc, rc)

    kept = {name: [t[1].clone() for t in tc[name]] for name in RING_LEAVES}
    rl, rc, _ = ref_model.forward(rcfg, rparams,
                                  {"tokens": jnp.asarray(second)}, _rctx(),
                                  mode="prefill", cache=rc,
                                  lengths=jnp.asarray(lengths))
    tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(second).long()},
                                _tctx(), mode="prefill", cache=tc,
                                lengths=_t(lengths))
    live = lengths > 0
    np.testing.assert_allclose(tl.numpy()[live], _np(rl)[live], atol=ATOL)
    _assert_same_cache(tcfg, tc, rc)
    for name in RING_LEAVES:
        for before, after in zip(kept[name], tc[name]):
            assert torch.equal(before, after[1]), name

    pos = np.array([30, 21, 9], np.int32)
    tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
    for _ in range(4):
        rl, rc, _ = ref_model.forward(rcfg, rparams,
                                      {"tokens": jnp.asarray(tok)}, _rctx(),
                                      mode="decode", cache=rc,
                                      pos=jnp.asarray(pos))
        tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(tok).long()},
                                    _tctx(), mode="decode", cache=tc,
                                    pos=_t(pos))
        np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
        tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        pos = pos + 1
    _assert_same_cache(tcfg, tc, rc)


def test_chunked_prefill_and_the_prefix_cache_are_refused_on_the_mix(pair):
    """Prefix caching needs an all-global stack (ROADMAP D12): the engine
    turns it off for gemma2, as the reference's does, and a chunked
    prefill is refused."""
    _, tcfg, _, tparams = pair
    cache = port_model.init_cache(tcfg, 2, 16, device=CPU)
    with pytest.raises(NotImplementedError, match="all-global"):
        port_model.forward(tcfg, tparams, {"tokens": torch.zeros(2, 4).long()},
                           _tctx(), mode="prefill", cache=cache,
                           lengths=torch.tensor([4, 4]),
                           starts=torch.tensor([0, 2]))
    model = Model(tcfg, device=CPU)
    eng = engine.ServingEngine(tcfg, model, ServeSpec(
        prompt_len=24, gen=4, prefix_cache=True), device=CPU,
        dtype=torch.float32)
    assert not eng.prefix_cache


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
ENGINE_CASES = {
    # prompts of 12..24 tokens: the rings wrap in prefill
    "gemma2": dict(batch=3, prompt_len=24, gen=6, requests=7),
    # prompts of 7..14 tokens, up to 8 new ones: rings wrap in decode; 9
    # pages for 3 slots force an eviction
    "gemma2-wrap-in-decode-evict": dict(batch=3, prompt_len=14, gen=8,
                                        requests=6, page_budget=7,
                                        overcommit=2.0),
}
HOST_STATE = ("host_table", "free_lists", "refcount", "reserved", "toks",
              "pos", "responses", "journal", "stats")


@pytest.fixture(scope="module")
def engine_weights():
    rcfg, tcfg = _configs()
    rparams, model = _weights(rcfg, tcfg, seed=1)
    return rcfg, tcfg, rparams, model


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_gemma2_engine_token_streams_match_reference(engine_weights, case):
    rcfg, tcfg, rparams, model = engine_weights
    spec = ENGINE_CASES[case]
    ref = ref_engine.ServingEngine(rcfg, _rctx(), rparams,
                                   RefServeSpec(**spec))
    port = engine.ServingEngine(tcfg, model, ServeSpec(**spec), device=CPU,
                                dtype=torch.float32)
    requests = engine.synthesize_requests(tcfg, ServeSpec(**spec), seed=3)
    for r in requests:
        ref.submit(ref_engine.Request(req=r.req, tokens=r.tokens.copy(),
                                      gen_len=r.gen_len))
        port.submit(r)
    while not port.idle:
        for eng in (ref, port):
            eng.admit()
        if all(s is None for s in port.slots):
            assert all(s is None for s in ref.slots)
            continue
        for eng in (ref, port):
            eng.step()
        ps, rs = port.snapshot(), ref.snapshot()
        for key in HOST_STATE:
            if isinstance(ps[key], np.ndarray):
                np.testing.assert_array_equal(ps[key], rs[key], err_msg=key)
            else:
                assert ps[key] == rs[key], key
    assert ref.idle
    assert port.responses == ref.responses
    for r in requests:
        assert len(port.responses[r.req]) == r.gen_len
    assert any(len(r.tokens) + r.gen_len - 1 > tcfg.window_size
               for r in requests)
    if "evict" in case:
        assert port.evictions > 0
    _assert_same_cache(tcfg, port.cache, ref.cache)


def test_gemma2_snapshot_restore_continues_byte_identically(engine_weights):
    _, tcfg, _, model = engine_weights
    spec = ServeSpec(**ENGINE_CASES["gemma2-wrap-in-decode-evict"])
    requests = engine.synthesize_requests(tcfg, spec, seed=5)
    run = engine.ServingEngine(tcfg, model, spec, device=CPU,
                               dtype=torch.float32)
    for r in requests:
        run.submit(r)
    run.admit()
    run.step()
    run.step()
    snap = run.snapshot()
    names = RING_LEAVES + PAGE_LEAVES
    assert sorted(snap["cache"]) == sorted(names + ("page_table",))
    run.run()

    fresh = engine.ServingEngine(tcfg, model, spec, device=CPU,
                                 dtype=torch.float32)
    fresh.restore(snap)
    again = fresh.snapshot()
    for name in names:
        for a, b in zip(again["cache"][name], snap["cache"][name],
                        strict=True):
            assert torch.equal(a, b), name
    fresh.run()
    assert fresh.responses == run.responses
    assert fresh.journal == run.journal
    for name in names:
        for a, b in zip(fresh.cache[name], run.cache[name], strict=True):
            assert torch.equal(a, b), name


def test_serve_cli_serves_gemma2_on_cpu(capsys):
    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--continuous",
                     "--batch", "3", "--prompt-len", "24", "--gen", "5",
                     "--requests", "5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=gemma2-9b-reduced" in out and "completed 5/5" in out
    assert "prefix cache:" not in out      # off for a mixed stack
    with pytest.raises(SystemExit, match="shorter than the local window"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--continuous", "--prompt-len", "8", "--gen", "4"])

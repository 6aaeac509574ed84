"""The port's internvl2 slice against the JAX reference on the CPU.

internvl2-76b is a dense GQA decoder (H 64 over K 8: G 8, hd 128, an
untied head) under a vision frontend stub: a batch may carry
``frontend_embeds`` (B, F, d_model), precomputed patch embeddings with no
parameters of their own, which the model prepends to the text
embeddings.  Positions run over the F + S rows; a ragged row's length
counts the F rows (a length-0 row stays untouched), so their K/V fill
the row's first pages; training drops the F rows before the head, so the
logits match the (B, S) labels.  A chunked (prefix-cached) prefill is
refused, and the engine turns the prefix cache off and serves the config
text-only, as the reference's engine does.

At ``.reduced()`` narrowed to H 16 over K 2, so the config keeps its G 8
(3 layers, d 64, hd 16, F 4), the reference's own weights and train
states, converted by tree path, go through both packages: prefill logits
and every paged cache leaf with and without the frontend, a ragged
prefill with the frontend and a length-0 row then decode, the engine's
token streams and host state, train logits, the loss and every gradient
with the frontend in the batch, and three AdamW steps at one and two
microbatches with the frontend split across them.  The reference runs
with ``Ctx(mesh=None, dtype=float32)``; its initial states are made once
a module and its gradients and steps run under ``jax.jit``.  Both sides
compute in fp32 and keep fp32 KV pools (``cfg.dtype="float32"``).

Tolerances (fp32, sums in another order than XLA's): logits and cached
K/V 1e-4 absolute (as ``test_torch_model.py``); the loss 1e-5 relative,
each gradient leaf within 1e-4 of its largest magnitude, grad norm 1e-4,
lr 1e-6; over three steps the weights within 1e-4 where the reference's
gradient was not below 1e-4 of its leaf's largest in some step
(elsewhere within 2·lr a step: Adam's sign amplification), the moments
within 1e-3 of each leaf's largest, as ``test_torch_gemma2_train.py``;
token streams and host state equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.configs.base import get_run_config as ref_run_config  # noqa: E402
from repro.core.jobspec import ServeSpec as RefServeSpec  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RefData  # noqa: E402
from repro.launch import engine as ref_engine  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import count_params as ref_count  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    RunConfig, check_trainable, get_config, get_run_config, list_configs)
from repro_torch.configs.base import check_ported  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_jax, params_to_jax, train_state_from_jax, train_state_to_jax)
from repro_torch.launch import engine  # noqa: E402
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    Model, cast_params, compute_params, count_params, make_trainable)
from repro_torch.train import steps  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


ATOL = 1e-4
GRAD_TOL = 1e-4
CPU = torch.device("cpu")
CTX = Ctx(device=CPU, dtype=torch.float32)
RCTX = RefCtx(mesh=None, dtype=jnp.float32)
ARCH = "internvl2-76b"
NARROW = dict(num_heads=16, num_kv_heads=2)      # G 8, as at full width
PAGE_LEAVES = ("k_pages", "v_pages")
B_TRAIN, S_TRAIN = 4, 16          # the gradient test's and the steps' rows


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def _configs(**over):
    over = dict(NARROW, dtype="float32", **over)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


def _frontend(cfg, B, seed):
    """B rows of the config's F patch embeddings, 0.02·N(0, 1) as the
    reference's tests draw them."""
    rng = np.random.default_rng(seed)
    return (0.02 * rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def ref_init():
    """The reference's initial train state at key 0 on the host, made once
    for the module: the serving tests take its weights, the gradient test
    its params.  Nothing writes to it (the port's conversion copies)."""
    rcfg, _ = _configs()
    return jax.device_get(ref_steps.init_train_state(rcfg,
                                                     jax.random.key(0)))


@pytest.fixture(scope="module")
def ref_grad():
    """The reference's loss and gradients under ``jax.jit``, compiled once
    for the module at the train tests' batch shape."""
    rcfg, _ = _configs()
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_steps.loss_fn(rcfg, p, b, RCTX), has_aux=True))


@pytest.fixture(scope="module")
def pair(ref_init):
    rcfg, tcfg = _configs(cache_layout="paged")
    rparams = ref_init["params"]
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(rparams, tcfg))
    return rcfg, tcfg, rparams, model


def test_config_and_runs_are_faithful_copies():
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(rcfg.reduced()) == \
        dataclasses.asdict(tcfg.reduced())
    assert (tcfg.frontend, tcfg.frontend_tokens, tcfg.num_heads
            // tcfg.num_kv_heads, tcfg.head_dim, tcfg.tie_embeddings) == \
        ("vision", 256, 8, 128, False)
    small = _configs()[1]
    assert (small.num_heads // small.num_kv_heads, small.frontend_tokens) \
        == (8, 4)
    for shape in ("train_4k", "decode_32k"):
        run, ref_run = get_run_config(ARCH, shape), ref_run_config(ARCH,
                                                                   shape)
        for field in dataclasses.fields(run):
            assert getattr(run, field.name) == \
                getattr(ref_run, field.name), (shape, field.name)
    assert (get_run_config(ARCH, "train_4k").num_microbatches,
            get_run_config(ARCH, "train_4k").remat_policy) == (16, "full")
    assert ARCH in list_configs() and len(list_configs()) == 11
    check_ported(tcfg)
    check_trainable(tcfg)


def test_full_width_parameter_count_matches_reference():
    """70.55 B: 80 layers of 855.65 M and the untied embedding and head of
    1.0507 B each; the frontend has no parameters."""
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    for embed in (False, True):
        assert count_params(tcfg, include_embed=embed) == \
            ref_count(rcfg, include_embed=embed)
    layer = (count_params(tcfg) - count_params(
        dataclasses.replace(tcfg, num_layers=79))) / 1e6
    embed = tcfg.padded_vocab * tcfg.d_model / 1e9
    assert round(layer, 2) == 855.65 and round(embed, 4) == 1.0507
    assert round(count_params(tcfg, include_embed=True) / 1e9, 2) == 70.55


def test_converted_tree_equals_the_reference_s_by_tree_path(pair):
    """No leaf for the frontend: the converted tree, and back, holds the
    reference's leaves, shapes and values."""
    _, tcfg, rparams, model = pair
    back = params_to_jax(dict(model.named_parameters()), tcfg)
    want, got = dict(_leaves(rparams)), dict(_leaves(back))
    assert sorted(got) == sorted(want)
    assert not any("front" in p for p in want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def _ref_pools(cache, name):
    """(L, P, K, ps, hd) pool of every layer of the reference cache."""
    return _np(cache["groups"]["0"]["attn"][name])


def _assert_same_pools(tc, rc):
    for name in PAGE_LEAVES:
        np.testing.assert_allclose(
            np.stack([t.float().numpy() for t in tc[name]]),
            _ref_pools(rc, name), atol=ATOL, err_msg=name)


def _caches(rcfg, tcfg, B, max_len, table):
    pool = int(table.max()) + 1
    rc = ref_model.init_cache(rcfg, B, max_len, layout="paged",
                              page_budget=pool, paged_tables="empty")
    rc = ref_engine._set_page_tables(rc, table)
    tc = port_model.init_cache(tcfg, B, max_len, page_budget=pool,
                               device=CPU)
    tc["page_table"].copy_(_t(table))
    return rc, tc


def _batches(tokens, fe=None):
    rb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": _t(tokens).long()}
    if fe is not None:
        rb["frontend_embeds"] = jnp.asarray(fe)
        tb["frontend_embeds"] = _t(fe)
    return rb, tb


@pytest.mark.parametrize("frontend", [True, False],
                         ids=["frontend", "text-only"])
def test_prefill_logits_and_caches_match_reference(pair, frontend):
    """A plain prefill of 12 text tokens a row, with the 4 frontend rows
    before them or without: the last position's logits and every layer's
    K/V pool (the frontend's K/V in each row's first page)."""
    rcfg, tcfg, rparams, model = pair
    B, S = 2, 12
    F = tcfg.frontend_tokens if frontend else 0
    max_len = F + S + 4
    pps = -(-max_len // tcfg.page_size)
    table = np.random.default_rng(1).permutation(B * pps).astype(np.int32)
    table = table.reshape(B, pps)
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    rb, tb = _batches(tokens, _frontend(tcfg, B, 3) if frontend else None)
    rc, tc = _caches(rcfg, tcfg, B, max_len, table)
    rl, rc, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="prefill",
                                  cache=rc)
    tl, tc = port_model.forward(tcfg, cast_params(model, torch.float32), tb,
                                CTX, mode="prefill", cache=tc)
    assert tl.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
    _assert_same_pools(tc, rc)


def test_ragged_prefill_with_frontend_then_decode_match_reference(pair):
    """A text-only prefill fills every row; a ragged prefill with the
    frontend re-prefills rows 0 and 2 (their lengths count the 4 frontend
    rows) while row 1, of length 0, keeps its pages byte for byte; three
    decode steps follow at positions shifted by the frontend, row 1 idle.
    Logits and every layer's pools agree with the reference at each
    stage."""
    rcfg, tcfg, rparams, model = pair
    tparams = cast_params(model, torch.float32)
    B, S0, F = 3, 12, tcfg.frontend_tokens
    max_len = F + S0 + 4
    pps = -(-max_len // tcfg.page_size)
    table = np.random.default_rng(3).permutation(B * pps).astype(np.int32)
    table = table.reshape(B, pps)
    rng = np.random.default_rng(11)
    first = rng.integers(0, rcfg.vocab_size, (B, F + S0)).astype(np.int32)
    second = rng.integers(0, rcfg.vocab_size, (B, S0)).astype(np.int32)
    lengths = np.array([S0, 0, 7], np.int32)
    rc, tc = _caches(rcfg, tcfg, B, max_len, table)

    rb, tb = _batches(first)
    rl, rc, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="prefill",
                                  cache=rc)
    tl, tc = port_model.forward(tcfg, tparams, tb, CTX, mode="prefill",
                                cache=tc)
    np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
    kept = {name: [t[table[1]].clone() for t in tc[name]]
            for name in PAGE_LEAVES}

    rb, tb = _batches(second, _frontend(tcfg, B, 4))
    rl, rc, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="prefill",
                                  cache=rc, lengths=jnp.asarray(lengths))
    tl, tc = port_model.forward(tcfg, tparams, tb, CTX, mode="prefill",
                                cache=tc, lengths=_t(lengths))
    live = lengths > 0
    np.testing.assert_allclose(tl.numpy()[live], _np(rl)[live], atol=ATOL)
    _assert_same_pools(tc, rc)
    for name in PAGE_LEAVES:
        for before, pool in zip(kept[name], tc[name]):
            assert torch.equal(before, pool[table[1]]), name

    pos = np.where(live, lengths + F, -1).astype(np.int32)
    tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
    for _ in range(3):
        rb, tb = _batches(tok)
        rl, rc, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="decode",
                                      cache=rc, pos=jnp.asarray(pos))
        tl, tc = port_model.forward(tcfg, tparams, tb, CTX, mode="decode",
                                    cache=tc, pos=_t(pos))
        np.testing.assert_allclose(tl.numpy()[live], _np(rl)[live],
                                   atol=ATOL)
        tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        pos = np.where(live, pos + 1, -1).astype(np.int32)
    _assert_same_pools(tc, rc)


def test_chunked_prefill_with_a_vision_frontend_raises(pair):
    """Prefix caching's chunked prefill opens a row at a position past 0,
    which the frontend's rows precede: both packages refuse it for a
    vision config, with or without embeddings in the batch."""
    rcfg, tcfg, rparams, model = pair
    B, S = 2, 8
    tokens = np.zeros((B, S), np.int32)
    lengths, starts = np.array([4, 4], np.int32), np.array([0, 8], np.int32)
    table = np.arange(B * 4, dtype=np.int32).reshape(B, 4)
    for fe in (None, _frontend(tcfg, B, 5)):
        rb, tb = _batches(tokens, fe)
        rc, tc = _caches(rcfg, tcfg, B, 32, table)
        with pytest.raises(NotImplementedError, match="frontend"):
            ref_model.forward(rcfg, rparams, rb, RCTX, mode="prefill",
                              cache=rc, lengths=jnp.asarray(lengths),
                              starts=jnp.asarray(starts))
        with pytest.raises(NotImplementedError, match="frontend"):
            port_model.forward(tcfg, cast_params(model, torch.float32), tb,
                               CTX, mode="prefill", cache=tc,
                               lengths=_t(lengths), starts=_t(starts))


HOST_STATE = ("host_table", "free_lists", "refcount", "reserved", "toks",
              "pos", "responses", "journal", "stats")


def test_engine_keeps_the_prefix_cache_off_and_streams_equal_reference(
        pair):
    """Asked for the prefix cache, both engines turn it off (the frontend
    precedes position 0) and serve the config text-only: on the same
    ``Request`` list (shared prompt prefixes that the cache would have
    served) the token streams, the host state after every step and the
    pools agree."""
    rcfg, tcfg, rparams, model = pair
    spec = dict(batch=3, prompt_len=16, gen=6, requests=6, prefix_cache=True,
                shared_prefix_frac=0.5)
    ref = ref_engine.ServingEngine(rcfg, RCTX, rparams, RefServeSpec(**spec))
    port = engine.ServingEngine(tcfg, model, ServeSpec(**spec), device=CPU,
                                dtype=torch.float32)
    assert not port.prefix_cache and not ref.prefix_cache
    base = dataclasses.replace(tcfg, frontend="none", frontend_tokens=0)
    assert engine.ServingEngine(base, model, ServeSpec(**spec), device=CPU,
                                dtype=torch.float32).prefix_cache
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
    assert ref.idle and port.responses == ref.responses
    for r in requests:
        assert len(port.responses[r.req]) == r.gen_len
    assert port.prefix_hits == 0 and port.cached_tokens == 0
    _assert_same_pools(port.cache, ref.cache)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
def _train_batch(rcfg, B=B_TRAIN, S=S_TRAIN, step=0, seed=3):
    """The reference's batch at ``step`` with seeded frontend embeddings:
    numpy for the reference, torch for the port."""
    b = {k: np.array(v)
         for k, v in RefData(rcfg.vocab_size, S, B, seed=seed)
         .batch_at(step).items()}
    b["frontend_embeds"] = _frontend(rcfg, B, 1000 * seed + step)
    return b, {k: torch.from_numpy(v) if k == "frontend_embeds"
               else torch.from_numpy(v).long() for k, v in b.items()}


def test_train_logits_drop_the_frontend_rows(pair):
    """Train mode runs the F + S rows and returns logits for the S text
    positions only, equal to the reference's; the frontend moves them."""
    rcfg, tcfg, rparams, model = pair
    rb, tb = _train_batch(rcfg)
    want, _, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="train")
    tparams = cast_params(model, torch.float32)
    with torch.no_grad():
        got, aux = port_model.forward(tcfg, tparams, tb, CTX, mode="train")
        text, _ = port_model.forward(tcfg, tparams, {"tokens": tb["tokens"]},
                                     CTX, mode="train")
    assert got.shape == want.shape == (B_TRAIN, S_TRAIN, tcfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    assert (got - text).abs().max() > 1e-3


def test_loss_and_gradients_with_frontend_match_reference_by_tree_path(
        ref_init, ref_grad):
    """The loss and every gradient leaf with ``frontend_embeds`` in the
    batch and masked labels."""
    rcfg, tcfg = _configs()
    rparams = ref_init["params"]
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(rparams, tcfg))
    model = make_trainable(model)
    rb, tb = _train_batch(rcfg)
    rb["labels"][0, :5] = -1
    tb["labels"][0, :5] = -1
    (rloss, rmet), rgrads = ref_grad(rparams, rb)
    names, leaves = zip(*model.named_parameters())
    loss, met = steps.loss_fn(tcfg, compute_params(model, torch.float32), tb,
                              CTX)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"].detach()), float(rmet["ce"]),
                               rtol=1e-5)
    got = dict(_leaves(params_to_jax(dict(zip(names, grads)), tcfg)))
    want = dict(_leaves(jax.device_get(rgrads)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _close(got[path], w, GRAD_TOL, path)


@pytest.fixture(scope="module")
def ref_init_steps():
    """The reference's initial train state at key 1 on the host, which the
    three-step tests start from at one and at two microbatches."""
    rcfg, _ = _configs()
    return jax.device_get(ref_steps.init_train_state(rcfg,
                                                     jax.random.key(1)))


@pytest.mark.parametrize("n_mb", [1, 2])
def test_three_train_steps_with_frontend_match_reference(
        n_mb, ref_init_steps, ref_grad):
    """Three AdamW steps from the same state on the same batches, each
    with its frontend rows; at two microbatches each half of the batch
    takes its own rows' embeddings in both packages."""
    rcfg, tcfg = _configs()
    lr, n_steps = 1e-3, 3
    run = dict(num_microbatches=n_mb, learning_rate=lr, warmup_steps=2,
               total_steps=n_steps)
    rstate = jax.tree.map(jnp.asarray, ref_init_steps)
    tstate = train_state_from_jax(ref_init_steps, tcfg, device=CPU)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, RCTX,
                                              RefRunConfig(**run)))
    tstep = steps.make_train_step(tcfg, CTX, RunConfig(**run))
    small = []
    for i in range(n_steps):
        rb, tb = _train_batch(rcfg, step=i, seed=5)
        if n_mb == 1:
            rgrads = ref_grad(rstate["params"], rb)[1]
            small.append({p: np.abs(g) < 1e-4 * np.abs(g).max()
                          for p, g in _leaves(jax.device_get(rgrads))})
        rstate, rm = rstep(rstate, rb)
        tstate, tm = tstep(tstate, tb)
        for key, rtol in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-4),
                          ("lr", 1e-6)):
            np.testing.assert_allclose(float(tm[key]), float(rm[key]),
                                       rtol=rtol, err_msg=f"{key}, step {i}")
    rstate = jax.device_get(rstate)
    tstate = train_state_to_jax(tstate, tcfg)
    assert int(tstate["step"]) == int(rstate["step"]) == n_steps
    got = dict(_leaves(tstate["params"]))
    for path, w in _leaves(rstate["params"]):
        w = np.asarray(w, np.float32)
        err = np.abs(got[path] - w)
        assert err.max() <= 2 * lr * n_steps, (path, err.max())
        off = err > 1e-4
        if small:
            noisy = np.any([s[path] for s in small], axis=0)
            assert not np.any(off & ~noisy), (path, err[~noisy].max())
        else:
            assert off.mean() <= 1e-3, (path, off.sum())
    for part in ("m", "v"):
        got = dict(_leaves(tstate["opt"][part]))
        for path, w in _leaves(rstate["opt"][part]):
            _close(got[path], w, 1e-3, f"{part} {path}")


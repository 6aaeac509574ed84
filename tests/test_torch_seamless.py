"""The port's seamless-m4t-medium slice against the JAX reference on the CPU.

seamless-m4t-medium is an encoder-decoder under an audio frontend stub: a
batch carries ``src_embeds`` (B, Ssrc, d_model), precomputed frames with
no parameters of their own, which a stack of encoder layers (global
attention without the causal mask, rope on q and k, a dense FFN) reads;
``encoder_norm`` closes it.  Each decoder layer adds a cross-attention
over the encoder's output between its self-attention and its FFN: q from
the layer, K and V from the frames, neither rotated, every frame live,
through the flash kernel at Sk = Ssrc apart from the S queries.  Prefill
caches each layer's cross K and V (B, K, Ssrc, hd); decode reads them
and rotates its q by the decode position, as the reference's decode does
(ROADMAP R8).  The engine prefills such a stack a slot at a time, its
frames drawn from numpy keyed on the request id (ROADMAP D13; the
reference's engine gets the port's draws here).

At ``.reduced()`` (2 encoder and 3 decoder layers, d 64, H 4 over K 2,
hd 16, V 503) the reference's own weights and train states, converted by
tree path, go through both packages: the plain flash at Sq != Sk (and
the TPU kernel in interpret mode), the encoder's output, prefill logits
and cross caches, decode, R8 on sharpened cross scores, the engine's
token streams with an eviction, snapshot and restore, train logits, the
loss and every gradient, and three AdamW steps at one and two
microbatches.  The reference runs with ``Ctx(mesh=None, dtype=float32)``;
its initial states are made once a module and its gradients and steps
run under ``jax.jit``.

Tolerances (fp32, sums in another order than XLA's): attention outputs,
logits and cached K/V 1e-4 absolute (as ``test_torch_internvl2.py``); the
loss 1e-5 relative, each gradient leaf within 1e-4 of its largest
magnitude, grad norm 1e-4, lr 1e-6; over three steps the weights within
1e-4 where the reference's gradient was not below 1e-4 of its leaf's
largest in some step (elsewhere within 2·lr a step), the moments within
1e-3 of each leaf's largest; token streams and host state equal.
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
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as ref_flash_kernel)
from repro.launch import engine as ref_engine  # noqa: E402
from repro.launch.specs import src_len_for as ref_src_len_for  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import count_params as ref_count  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    RunConfig, check_trainable, get_config, get_run_config, list_configs)
from repro_torch.configs.base import check_ported, src_len_for  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_jax, params_to_jax, train_state_from_jax, train_state_to_jax)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import engine, serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.spec import ServeSpec, TrainSpec  # noqa: E402
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
ARCH = "seamless-m4t-medium"
PAGE_LEAVES = ("k_pages", "v_pages")
B_TRAIN, S_TRAIN = 4, 16          # the gradient test's and the steps' rows
SRC_TRAIN = 16                    # src_len_for(cfg, 16): max(16 // 4, 16)
SHARP = 8.0                       # the R8 case's cross q weights, scaled


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
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


def _frames(cfg, B, S, seed):
    """B rows of S encoder frames, 0.02·N(0, 1) as the engines draw them."""
    rng = np.random.default_rng(seed)
    return (0.02 * rng.normal(size=(B, S, cfg.d_model))).astype(np.float32)


def _sharpened(rparams):
    """The reference's tree with every decoder layer's cross q weights
    scaled by SHARP (a copy): sharper cross scores, so that a rotated
    decode q shows (ROADMAP R8)."""
    out = jax.tree.map(np.array, rparams)
    out["decoder"]["groups"]["0"]["cross"]["q"] *= SHARP
    return out


def _model(tcfg, rparams):
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(rparams, tcfg))
    return model


@pytest.fixture(scope="module")
def ref_init():
    """The reference's initial train state at key 0 on the host, made once
    for the module.  Nothing writes to it (the port's conversion
    copies)."""
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
    return rcfg, tcfg, rparams, _model(tcfg, rparams)


def test_config_and_run_are_faithful_copies():
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(rcfg.reduced()) == \
        dataclasses.asdict(tcfg.reduced())
    small = tcfg.reduced()
    assert (small.num_encoder_layers, small.num_layers, small.d_model,
            small.num_heads // small.num_kv_heads, small.head_dim,
            small.vocab_size) == (2, 3, 64, 2, 16, 503)
    assert (tcfg.frontend, tcfg.is_encoder_decoder, tcfg.num_heads,
            tcfg.num_kv_heads, tcfg.head_dim) == ("audio", True, 16, 16, 64)
    run, ref_run = get_run_config(ARCH, "train_4k"), ref_run_config(
        ARCH, "train_4k")
    for field in dataclasses.fields(run):
        assert getattr(run, field.name) == getattr(ref_run, field.name)
    assert (run.num_microbatches, run.remat_policy) == (2, "full")
    for S in (64, 1024, 1056, 4096):
        assert src_len_for(tcfg, S) == ref_src_len_for(rcfg, S)
    assert src_len_for(tcfg, 1056) == 264
    assert src_len_for(get_config("qwen3-0.6b"), 4096) == 0
    assert ARCH in list_configs() and len(list_configs()) == 11
    check_ported(tcfg)
    check_trainable(tcfg)


def test_full_width_parameter_count_is_977_9m():
    """453.0 M parameters in the 12 encoder and 12 decoder layers and the
    norms, and an untied embedding and head of 262.4 M each: 977.9 M, one
    card's worth at full depth."""
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    for embed in (False, True):
        assert count_params(tcfg, include_embed=embed) == \
            ref_count(rcfg, include_embed=embed)
    assert round(count_params(tcfg) / 1e6, 1) == 453.0
    assert round(tcfg.padded_vocab * tcfg.d_model / 1e6, 1) == 262.4
    assert round(count_params(tcfg, include_embed=True) / 1e6, 1) == 977.9


def test_converted_tree_equals_the_reference_s_by_tree_path(pair):
    """The encoder stack, ``encoder_norm`` and the decoder's cross leaves
    included: the converted tree, and back, holds the reference's leaves,
    shapes and values."""
    _, tcfg, rparams, model = pair
    names = dict(model.named_parameters())
    assert {"encoder_norm", "encoder_blocks.1.attn.q", "blocks.2.cross.q",
            "blocks.0.cross_norm"} <= set(names)
    assert not any("cross" in n for n in names if n.startswith("encoder"))
    back = params_to_jax(names, tcfg)
    want, got = dict(_leaves(rparams)), dict(_leaves(back))
    assert sorted(got) == sorted(want)
    assert any(p.startswith("encoder/groups") for p in want)
    assert any("/cross/" in p for p in want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.mark.parametrize("Sq,Sk", [(32, 16), (16, 48)],
                         ids=["Sq32-Sk16", "Sq16-Sk48"])
def test_plain_flash_at_a_key_length_apart_matches_reference(Sq, Sk):
    """The plain flash forward and backward (the CPU path, the card's
    oracle) at Sq != Sk without a causal mask, G 2: the output against the
    reference's ``flash_attention_jnp`` and its Pallas kernel in interpret
    mode, the log-sum-exp against a direct one, and dq, dk, dv against
    ``jax.grad`` of ``flash_attention_jnp``.  Causal or windowed at Sq !=
    Sk is refused (ROADMAP D9)."""
    B, H, K, hd, scale = 2, 4, 2, 16, 0.25
    rng = np.random.default_rng(Sq * 100 + Sk)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in (
        (B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd)))
    want = _np(flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale=scale,
                                   causal=False))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    got = ops.flash_attention_bshd(tq, tk, tv, scale=scale, causal=False)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    kern = ref_flash_kernel(
        jnp.asarray(q.transpose(0, 2, 1, 3).reshape(B * H, Sq, hd)),
        jnp.asarray(k.transpose(0, 2, 1, 3).reshape(B * K, Sk, hd)),
        jnp.asarray(v.transpose(0, 2, 1, 3).reshape(B * K, Sk, hd)),
        group=H // K, scale=scale, causal=False, interpret=True)
    np.testing.assert_allclose(
        got.detach().numpy(),
        _np(kern).reshape(B, H, Sq, hd).transpose(0, 2, 1, 3), atol=ATOL)
    _, lse = ops._flash_forward(_t(q), _t(k), _t(v), dict(
        scale=scale, causal=False, window=0, logit_cap=0.0),
        return_lse=True)
    s = np.einsum("bqkgd,btkd->bkgqt", q.reshape(B, Sq, K, H // K, hd),
                  k) * scale
    m = s.max(-1)
    direct = (m + np.log(np.exp(s - m[..., None]).sum(-1))).reshape(
        B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), direct, atol=1e-5)
    got.backward(_t(do))
    grads = jax.grad(lambda a, b_, c: jnp.sum(flash_attention_jnp(
        a, b_, c, scale=scale, causal=False) * jnp.asarray(do)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for t, g, name in zip((tq, tk, tv), grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), _np(g), atol=ATOL,
                                   err_msg=f"d{name}")
    for causal, window in ((True, 0), (False, 8)):
        with pytest.raises(ValueError, match="neither a causal"):
            ops.flash_attention_bshd(_t(q), _t(k), _t(v), scale=scale,
                                     causal=causal, window=window)


def _caches(rcfg, tcfg, B, max_len, src_len, table):
    pool = int(table.max()) + 1
    rc = ref_model.init_cache(rcfg, B, max_len, src_len, layout="paged",
                              page_budget=pool, paged_tables="empty")
    rc = ref_engine._set_page_tables(rc, table)
    tc = port_model.init_cache(tcfg, B, max_len, src_len=src_len,
                               page_budget=pool, device=CPU)
    tc["page_table"].copy_(_t(table))
    return rc, tc


def _assert_same_caches(tc, rc, cross_only=False):
    """Every layer's cross K/V and (but with ``cross_only``) paged pools
    of the port's cache against the reference's stacked leaves."""
    group = rc["groups"]["0"]
    pairs = [("cross_k", group["cross"]["k"]), ("cross_v",
                                                group["cross"]["v"])]
    if not cross_only:
        pairs += [(n, group["attn"][n]) for n in PAGE_LEAVES]
    for name, want in pairs:
        np.testing.assert_allclose(
            np.stack([t.float().numpy() for t in tc[name]]), _np(want),
            atol=ATOL, err_msg=name)


def _batches(tokens, src=None):
    rb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": _t(tokens).long()}
    if src is not None:
        rb["src_embeds"] = jnp.asarray(src)
        tb["src_embeds"] = _t(src)
    return rb, tb


def test_encoder_out_prefill_logits_and_cross_caches_match_reference(pair):
    """The encoder's normed output over 20 frames; a prefill of 12 tokens a
    row: the last position's logits, every layer's paged K/V and its
    cross K/V (B, K, Ssrc, hd).  A prefill without frames is refused."""
    rcfg, tcfg, rparams, model = pair
    tparams = cast_params(model, torch.float32)
    B, S, Ssrc = 2, 12, 20
    src = _frames(tcfg, B, Ssrc, 3)
    want = ref_model._encoder_out(rcfg, ref_model.cast_params(
        rparams, jnp.float32), jnp.asarray(src), RCTX, "none")
    got = port_model._encoder_out(tcfg, tparams, _t(src), CTX)
    assert got.shape == (B, Ssrc, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    max_len = S + 4
    pps = -(-max_len // tcfg.page_size)
    table = np.random.default_rng(1).permutation(B * pps).astype(np.int32)
    table = table.reshape(B, pps)
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    rb, tb = _batches(tokens, src)
    rc, tc = _caches(rcfg, tcfg, B, max_len, Ssrc, table)
    rl, rc, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="prefill",
                                  cache=rc)
    tl, tc = port_model.forward(tcfg, tparams, tb, CTX, mode="prefill",
                                cache=tc)
    assert tl.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
    assert [tuple(t.shape) for t in tc["cross_k"]] == \
        [(B, tcfg.num_kv_heads, Ssrc, tcfg.head_dim)] * tcfg.num_layers
    _assert_same_caches(tc, rc)
    with pytest.raises(ValueError, match="src_embeds"):
        port_model.forward(tcfg, tparams, {"tokens": tb["tokens"]}, CTX,
                           mode="prefill", cache=tc)


@pytest.mark.parametrize("sharp", [False, True], ids=["init", "sharp-R8"])
def test_prefill_then_decode_logits_match_reference(pair, sharp):
    """A one-token prefill, then four teacher-forced decode steps of the
    same row: logits and caches agree with the reference's at every step.
    On sharpened cross scores (cross q ×8) this pins R8: the decode steps
    rotate their cross q by the position and the cached K never is, so
    in both packages the decode logits part from the train-mode logits of
    the same sequence past position 0, which the prefill matches."""
    rcfg, tcfg, rparams, model = pair
    if sharp:
        rparams = _sharpened(rparams)
        model = _model(tcfg, rparams)
    tparams = cast_params(model, torch.float32)
    B, n, Ssrc = 2, 5, 16
    max_len = n + 3
    pps = -(-max_len // tcfg.page_size)
    table = np.arange(B * pps, dtype=np.int32)[::-1].copy().reshape(B, pps)
    seq = np.random.default_rng(7).integers(
        0, rcfg.vocab_size, (B, n)).astype(np.int32)
    src = _frames(tcfg, B, Ssrc, 8)
    rc, tc = _caches(rcfg, tcfg, B, max_len, Ssrc, table)
    rb, tb = _batches(seq[:, :1], src)
    rl, rc, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="prefill",
                                  cache=rc)
    tl, tc = port_model.forward(tcfg, tparams, tb, CTX, mode="prefill",
                                cache=tc)
    steps_t, steps_r = [tl[:, 0].numpy()], [_np(rl)[:, 0]]
    for p in range(1, n):
        pos = np.full(B, p, np.int32)
        rb, tb = _batches(seq[:, p:p + 1])
        rl, rc, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="decode",
                                      cache=rc, pos=jnp.asarray(pos))
        tl, tc = port_model.forward(tcfg, tparams, tb, CTX, mode="decode",
                                    cache=tc, pos=_t(pos))
        steps_t.append(tl[:, 0].numpy())
        steps_r.append(_np(rl)[:, 0])
    _assert_same_caches(tc, rc)
    got, want = np.stack(steps_t, 1), np.stack(steps_r, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    rb, tb = _batches(seq, src)
    r_train = _np(ref_model.forward(rcfg, rparams, rb, RCTX,
                                    mode="train")[0])
    with torch.no_grad():
        t_train = port_model.forward(tcfg, tparams, tb, CTX,
                                     mode="train")[0].numpy()
    np.testing.assert_allclose(t_train, r_train, atol=ATOL)
    np.testing.assert_allclose(got[:, 0], t_train[:, 0], atol=ATOL)
    apart_t = np.abs(got - t_train).max(axis=(0, 2))
    apart_r = np.abs(want - r_train).max(axis=(0, 2))
    if sharp:
        assert (apart_t[1:] > 1e-2).all() and (apart_r[1:] > 1e-2).all(), \
            (apart_t, apart_r)


HOST_STATE = ("host_table", "free_lists", "refcount", "reserved", "toks",
              "pos", "responses", "journal", "stats")
ENGINE_SPEC = dict(batch=3, prompt_len=16, gen=6, requests=6, page_budget=7,
                   overcommit=2.0)


def test_engine_streams_match_reference_through_evict_snapshot_restore(
        pair):
    """Both engines prefill a slot at a time (full-length prompts; the
    reference's engine draws the port's frames), an eviction replays a
    request, and the token streams, the host state after every step and
    the caches agree; a snapshot taken mid-run restores into a fresh
    engine that continues byte-identically, cross K/V included."""
    rcfg, tcfg, rparams, model = pair
    ref = ref_engine.ServingEngine(rcfg, RCTX, rparams,
                                   RefServeSpec(**ENGINE_SPEC))
    port = engine.ServingEngine(tcfg, model, ServeSpec(**ENGINE_SPEC),
                                device=CPU, dtype=torch.float32)
    assert not port.ragged and not ref.ragged
    assert not port.prefix_cache and port.src_len == ref.src_len == 16
    ref._src_embeds = lambda req: jnp.asarray(port._src_embeds(req).numpy())
    requests = engine.synthesize_requests(tcfg, ServeSpec(**ENGINE_SPEC),
                                          seed=3, ragged=port.ragged)
    assert all(len(r.tokens) == ENGINE_SPEC["prompt_len"] for r in requests)
    for r in requests:
        ref.submit(ref_engine.Request(req=r.req, tokens=r.tokens.copy(),
                                      gen_len=r.gen_len))
        port.submit(r)
    snap = None
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
        if snap is None and port.decode_steps == 2:
            snap = ps
    assert ref.idle and port.responses == ref.responses
    assert port.evictions > 0
    for r in requests:
        assert len(port.responses[r.req]) == r.gen_len
    _assert_same_caches(port.cache, ref.cache, cross_only=True)
    assert sorted(snap["cache"]) == sorted(
        ("cross_k", "cross_v", "page_table") + PAGE_LEAVES)
    fresh = engine.ServingEngine(tcfg, model, ServeSpec(**ENGINE_SPEC),
                                 device=CPU, dtype=torch.float32)
    fresh.restore(snap)
    again = fresh.snapshot()
    for name in ("cross_k", "cross_v") + PAGE_LEAVES:
        for a, b in zip(again["cache"][name], snap["cache"][name],
                        strict=True):
            assert torch.equal(a, b), name
    fresh.run()
    assert fresh.responses == port.responses
    assert fresh.journal == port.journal


def test_engine_and_spec_refuse_ragged_prefill_on_an_encoder_decoder(pair):
    """``ragged_prefill=True`` is refused with the reference's reason,
    ``None`` and ``False`` serve per slot; a decoder-only stack keeps
    refusing ``False`` (D12).  The model refuses a ragged or chunked
    prefill of an encoder-decoder, as the reference does."""
    rcfg, tcfg, rparams, model = pair
    with pytest.raises(NotImplementedError, match="prefills per slot"):
        engine.ServingEngine(tcfg, model, ServeSpec(ragged_prefill=True),
                             device=CPU, dtype=torch.float32)
    assert not engine.ServingEngine(
        tcfg, model, ServeSpec(ragged_prefill=False), device=CPU,
        dtype=torch.float32).ragged
    qwen = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               cache_layout="paged")
    with pytest.raises(NotImplementedError, match="ragged_prefill=False"):
        engine.ServingEngine(qwen, port_model.build_model(qwen, device=CPU),
                             ServeSpec(ragged_prefill=False), device=CPU,
                             dtype=torch.float32)
    B, S = 2, 8
    tokens = np.zeros((B, S), np.int32)
    lengths, starts = np.array([4, 4], np.int32), np.array([0, 8], np.int32)
    table = np.arange(B * 4, dtype=np.int32).reshape(B, 4)
    rb, tb = _batches(tokens, _frames(tcfg, B, 16, 1))
    for st in (None, starts):
        rc, tc = _caches(rcfg, tcfg, B, 32, 16, table)
        kw_r = dict(lengths=jnp.asarray(lengths))
        kw_t = dict(lengths=_t(lengths))
        if st is not None:
            kw_r["starts"], kw_t["starts"] = jnp.asarray(st), _t(st)
        with pytest.raises(NotImplementedError, match="decoder-only"):
            ref_model.forward(rcfg, rparams, rb, RCTX, mode="prefill",
                              cache=rc, **kw_r)
        with pytest.raises(NotImplementedError, match="decoder-only"):
            port_model.forward(tcfg, cast_params(model, torch.float32), tb,
                               CTX, mode="prefill", cache=tc, **kw_t)


def test_encoder_decoder_is_refused_where_no_config_has_it():
    """An encoder-decoder on a hybrid, MoE or MLA stack, and the audio
    frontend without an encoder, are refused by name; an encoder-decoder
    on a dense all-global stack builds."""
    base = get_config(ARCH).reduced()
    port_model.build_model(base, device=CPU)
    port_model.build_model(dataclasses.replace(
        get_config("qwen3-0.6b").reduced(), is_encoder_decoder=True,
        num_encoder_layers=2), device=CPU)
    for over, what in (
            (dict(block_pattern=("recurrent", "recurrent", "local"),
                  window_size=16, rnn_width=64),
             "an encoder-decoder on a stack that is not all-global"),
            (dict(num_experts=4, num_experts_per_tok=2, moe_d_ff=32),
             "an encoder-decoder on MoE"),
            (dict(use_mla=True, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
             "an encoder-decoder on MLA"),
            (dict(is_encoder_decoder=False, num_encoder_layers=0),
             "the audio frontend without an encoder")):
        cfg = dataclasses.replace(base, **over)
        with pytest.raises(NotImplementedError, match=what):
            check_trainable(cfg)
        with pytest.raises(NotImplementedError, match=what):
            Model(cfg, device="meta")


def test_serve_and_train_entry_points_take_seamless_on_cpu(capsys):
    """The serve CLI serves it (full-length prompts, per slot); the train
    CLI refuses it naming R9, and ``launch.train.train`` trains it on
    batches that carry its frames (B, S/4 but at least 16, d_model) at two
    microbatches under full remat."""
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--continuous",
                       "--batch", "2", "--prompt-len", "12", "--gen", "4",
                       "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert "completed 3/3" in out and "prefix cache:" not in out
    with pytest.raises(SystemExit, match="R9"):
        train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "1"])
    cfg = get_config(ARCH).reduced()
    t = TrainSpec(total_steps=2, global_batch=2, seq_len=64,
                  num_microbatches=2, remat_policy="full", reduced=True,
                  log_every=1)
    batch = train_cli.batches_of(cfg, t, seed=0).batch_at(1)
    assert tuple(batch["src_embeds"].shape) == (2, 16, cfg.d_model)
    assert torch.equal(batch["src_embeds"], train_cli.batches_of(
        cfg, t, seed=0).batch_at(1)["src_embeds"])
    r = train_cli.train(cfg, t, seed=0, device=CPU, log=lambda *_: None)
    assert all(np.isfinite(m["loss"]) for m in r["metrics"])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
def _train_batch(rcfg, B=B_TRAIN, S=S_TRAIN, step=0, seed=3):
    """The reference's batch at ``step`` with seeded encoder frames: numpy
    for the reference, torch for the port."""
    b = {k: np.array(v)
         for k, v in RefData(rcfg.vocab_size, S, B, seed=seed)
         .batch_at(step).items()}
    b["src_embeds"] = _frames(rcfg, B, SRC_TRAIN, 1000 * seed + step)
    return b, {k: torch.from_numpy(v) if k == "src_embeds"
               else torch.from_numpy(v).long() for k, v in b.items()}


def test_loss_and_gradients_match_reference_by_tree_path(ref_init,
                                                         ref_grad):
    """Train logits, the loss and every gradient leaf (the encoder's
    through the decoder's cross-attention) with masked labels, under full
    remat (each decoder layer's remat takes the encoder's output as an
    input) and without."""
    rcfg, tcfg = _configs()
    rparams = ref_init["params"]
    model = make_trainable(_model(tcfg, rparams))
    rb, tb = _train_batch(rcfg)
    rb["labels"][0, :5] = -1
    tb["labels"][0, :5] = -1
    want, _, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="train")
    with torch.no_grad():
        got, aux = port_model.forward(tcfg, cast_params(model, torch.float32),
                                      tb, CTX, mode="train")
    assert got.shape == (B_TRAIN, S_TRAIN, tcfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    (rloss, rmet), rgrads = ref_grad(rparams, rb)
    want = dict(_leaves(jax.device_get(rgrads)))
    names, leaves = zip(*model.named_parameters())
    for remat in ("none", "full"):
        loss, met = steps.loss_fn(tcfg, compute_params(model, torch.float32),
                                  tb, CTX, remat)
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(float(loss.detach()), float(rloss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(met["ce"].detach()),
                                   float(rmet["ce"]), rtol=1e-5)
        got = dict(_leaves(params_to_jax(dict(zip(names, grads)), tcfg)))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            _close(got[path], w, GRAD_TOL, f"{remat} {path}")
        assert np.abs(got["encoder/groups/0/attn/q"]).max() > 0


@pytest.mark.parametrize("n_mb", [1, 2])
def test_three_train_steps_match_reference(n_mb, ref_init, ref_grad):
    """Three AdamW steps from the module's initial state on the same
    batches, each with its frames; at two microbatches each half of the
    batch takes its own rows' frames in both packages."""
    rcfg, tcfg = _configs()
    lr, n_steps = 1e-3, 3
    run = dict(num_microbatches=n_mb, learning_rate=lr, warmup_steps=2,
               total_steps=n_steps)
    rstate = jax.tree.map(jnp.asarray, ref_init)
    tstate = train_state_from_jax(ref_init, tcfg, device=CPU)
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

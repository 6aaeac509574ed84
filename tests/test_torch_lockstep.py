"""Lockstep serving over the dense cache (the reference's default serve
path) against the JAX reference on the CPU: one prefill of the whole
batch, then every row decoded at one scalar position a step.

The reference runs with ``Ctx(mesh=None, dtype=float32)`` on its own
weights, converted into the port by tree path; both sides keep fp32
caches (``cfg.dtype="float32"``), so a cached value is compared, not its
rounding.  Tolerance 1e-4 absolute on logits and cache leaves of
magnitude ~1 (fp32 summation order differs between XLA and torch).

Covered: every registered config's reduced form, dense layout, a prefill
of 2 × 20 tokens and four decode steps, logits and every dense cache leaf
(the reference's own loop in ``tests/test_paged_cache.py:_run_serve``,
teacher-forced on the same tokens); the port's dense layout against its
paged one with identity tables; the dense writers against the reference's
functions; the refusals; the CLI's lockstep mode and ``run_lockstep``'s
tokens against the reference's lockstep loop.  MLA's cases:
``tests/test_torch_lockstep_mla.py``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    GLOBAL_ATTN, LOCAL_ATTN, RECURRENT, RWKV,
)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.executor import (  # noqa: E402
    lockstep_inputs, run_lockstep,
)
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import Model, cast_params  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


ATOL = 1e-4
CPU = torch.device("cpu")
B, P, STEPS = 2, 20, 4
SRC_LEN = 16
GQA_ARCHS = tuple(a for a in list_configs() if a != "deepseek-v2-236b")
SUBTREE = {GLOBAL_ATTN: "attn", LOCAL_ATTN: "attn", RECURRENT: "rec",
           RWKV: "rwkv"}


def configs(arch, layout="dense"):
    over = dict(cache_layout=layout, dtype="float32")
    return (dataclasses.replace(ref_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


@functools.lru_cache(maxsize=None)
def weights(arch):
    """(reference params, the port's fp32 compute tree, the port's model)
    of one reduced config, from the reference's seed-0 draw."""
    rcfg, tcfg = configs(arch)
    rparams = ref_init_params(rcfg, jax.random.key(0))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rparams, cast_params(model, torch.float32), model


def inputs(cfg, seed=1):
    """Teacher-forced tokens (B, P + STEPS) and, for an encoder-decoder,
    frames (B, SRC_LEN, d) of 0.02·N(0, 1), from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, P + STEPS)).astype(np.int32)
    src = (0.02 * rng.standard_normal((B, SRC_LEN, cfg.d_model))
           ).astype(np.float32) if cfg.is_encoder_decoder else None
    return toks, src


def run_ref(rcfg, rparams, toks, src):
    """The reference's lockstep loop over its dense cache: (logits of the
    prefill and of each decode step (B, V) each, the final cache)."""
    ctx = RefCtx(mesh=None, dtype=jnp.float32)
    cache = ref_model.init_cache(rcfg, B, P + STEPS,
                                 SRC_LEN if src is not None else 0,
                                 layout="dense")
    batch = {"tokens": jnp.asarray(toks[:, :P])}
    if src is not None:
        batch["src_embeds"] = jnp.asarray(src)
    logits, cache, _ = ref_model.forward(rcfg, rparams, batch, ctx,
                                         mode="prefill", cache=cache)
    outs = [np.asarray(logits[:, -1])]
    for t in range(P, P + STEPS):
        logits, cache, _ = ref_model.forward(
            rcfg, rparams, {"tokens": jnp.asarray(toks[:, t:t + 1])}, ctx,
            mode="decode", cache=cache, pos=jnp.int32(t))
        outs.append(np.asarray(logits[:, -1]))
    return outs, cache


def run_port(tcfg, tparams, toks, src, layout="dense", tables="identity"):
    """The port's lockstep loop, as :func:`run_ref`, on ``layout``."""
    ctx = Ctx(device=CPU, dtype=torch.float32)
    cache = port_model.init_cache(
        tcfg, B, P + STEPS, src_len=SRC_LEN if src is not None else 0,
        layout=layout, paged_tables=tables, device=CPU)
    batch = {"tokens": torch.from_numpy(toks[:, :P]).long()}
    if src is not None:
        batch["src_embeds"] = torch.from_numpy(src)
    with torch.inference_mode():
        logits, cache = port_model.forward(tcfg, tparams, batch, ctx,
                                           mode="prefill", cache=cache)
        outs = [logits[:, -1].numpy()]
        for t in range(P, P + STEPS):
            logits, cache = port_model.forward(
                tcfg, tparams,
                {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, ctx,
                mode="decode", cache=cache, pos=torch.tensor(t))
            outs.append(logits[:, -1].numpy())
    return outs, cache


def ref_layer(rcfg, rcache, i):
    """Layer ``i``'s cache subtree of the reference's stacked tree
    (``prefix`` unrolled, ``groups`` stacked along a leading axis,
    ``tail``)."""
    n_pre = rcfg.first_k_dense
    if i < n_pre:
        return rcache["prefix"][str(i)]
    pat = rcfg.block_pattern
    g, j = divmod(i - n_pre, len(pat))
    n_groups = (rcfg.num_layers - n_pre) // len(pat)
    if g < n_groups:
        return jax.tree.map(lambda x: x[g], rcache["groups"][str(j)])
    return rcache["tail"][str(j)]


def cache_pairs(rcfg, tcfg, rcache, tcache):
    """(name, port leaf, reference leaf) of every dense cache leaf."""
    seen = {k: 0 for k in SUBTREE}
    for i, kind in enumerate(tcfg.layer_kinds()):
        j = seen[kind]
        seen[kind] += 1
        sub = ref_layer(rcfg, rcache, i)
        for name in port_model.layer_leaves(tcfg, kind, "dense"):
            yield (f"{name}[{j}]", tcache[name][j],
                   sub[SUBTREE[kind]][port_model.ATTN_NAMES.get(name, name)])
        if tcfg.is_encoder_decoder:
            for name in ("k", "v"):
                yield (f"cross_{name}[{i}]", tcache["cross_" + name][i],
                       sub["cross"][name])


def check_against_reference(arch):
    rcfg, tcfg = configs(arch)
    rparams, tparams, _ = weights(arch)
    toks, src = inputs(tcfg)
    ref_logits, rcache = run_ref(rcfg, rparams, toks, src)
    port_logits, tcache = run_port(tcfg, tparams, toks, src)
    assert "page_table" not in tcache
    for step, (a, b) in enumerate(zip(port_logits, ref_logits, strict=True)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0,
                                   err_msg=f"{arch} step {step}")
    n = 0
    for name, tl, rl in cache_pairs(rcfg, tcfg, rcache, tcache):
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(rl, np.float32), atol=ATOL,
                                   rtol=0, err_msg=f"{arch} {name}")
        n += 1
    assert n == sum(len(v) for v in tcache.values())


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_dense_lockstep_matches_reference(arch):
    """Prefill of 2 × 20 tokens and four decode steps at a scalar
    position: every step's logits and every dense cache leaf (K, V, pos;
    rings; RG-LRU and RWKV carries; the cross K/V) within 1e-4."""
    check_against_reference(arch)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b", "qwen2.5-32b"])
def test_dense_matches_paged_identity(arch):
    """The port's dense layout against its paged layout with identity
    tables, the same lockstep run (the reference's
    ``test_paged_matches_dense_decode``)."""
    _, tcfg = configs(arch)
    _, tparams, _ = weights(arch)
    toks, src = inputs(tcfg)
    dense, _ = run_port(tcfg, tparams, toks, src)
    paged, cache = run_port(dataclasses.replace(tcfg, cache_layout="paged"),
                            tparams, toks, src, layout="paged")
    assert "page_table" in cache
    err = max(float(np.abs(a - b).max()) for a, b in zip(dense, paged))
    assert err < ATOL, (arch, err)


# ---------------------------------------------------------------------------
# The writers against the reference's own functions
# ---------------------------------------------------------------------------
def _writer_arrays(seed, S_max, S, Kh=2, hd=4, ring=False):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, Kh, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Kh, hd)).astype(np.float32)
    ck = rng.standard_normal((B, Kh, S_max, hd)).astype(np.float32)
    cv = rng.standard_normal((B, Kh, S_max, hd)).astype(np.float32)
    cp = np.full((B, S_max) if ring else (S_max,), -1, np.int32)
    return k, v, {"k": ck, "v": cv, "pos": cp}


def _both(cache):
    return ({n: jnp.asarray(a) for n, a in cache.items()},
            {n: torch.from_numpy(a.copy()) for n, a in cache.items()})


def _same(tc, rc):
    for n in ("k", "v", "pos"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(rc[n]),
                                      err_msg=n)


@pytest.mark.parametrize("window", [0, 8])
def test_writers_match_the_reference(window):
    """``_write_full_kv`` (a prefill of 11 tokens from position 5 into a
    global buffer of 24 slots, or into a full ring of 8) and
    ``_update_decode_kv`` (a scalar position, then for the ring per-row
    positions) leave the reference's arrays bit for bit."""
    S_max = window or 24
    k, v, cache = _writer_arrays(0, S_max, 11, ring=bool(window))
    rc, tc = _both(cache)
    pos = np.arange(5, 16, dtype=np.int32)
    rc = ref_attn._write_full_kv(rc, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), window)
    port_attn._write_full_kv(tc, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(pos), window)
    _same(tc, rc)
    k1, v1, _ = _writer_arrays(1, S_max, 1)
    rc, _, _, _ = ref_attn._update_decode_kv(
        rc, jnp.asarray(k1), jnp.asarray(v1), jnp.int32(16), window)
    out = port_attn._update_decode_kv(tc, torch.from_numpy(k1),
                                      torch.from_numpy(v1),
                                      torch.tensor(16), window)
    assert out[0] is tc and out[1] is tc["k"] and out[3] is tc["pos"]
    _same(tc, rc)
    if window:
        k2, v2, _ = _writer_arrays(2, S_max, 1)
        rows = np.array([17, -1], np.int32)
        rc, _, _, _ = ref_attn._update_decode_kv(
            rc, jnp.asarray(k2), jnp.asarray(v2), jnp.asarray(rows), window)
        port_attn._update_decode_kv(tc, torch.from_numpy(k2),
                                    torch.from_numpy(v2),
                                    torch.from_numpy(rows), window)
        _same(tc, rc)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------
def _dense_prefilled(arch="qwen3-0.6b"):
    _, tcfg = configs(arch)
    _, tparams, _ = weights(arch)
    toks, src = inputs(tcfg)
    ctx = Ctx(device=CPU, dtype=torch.float32)
    cache = port_model.init_cache(tcfg, B, P + STEPS, device=CPU)
    port_model.forward(tcfg, tparams,
                       {"tokens": torch.from_numpy(toks[:, :P]).long()}, ctx,
                       mode="prefill", cache=cache)
    return tcfg, tparams, ctx, cache, toks


def test_a_dense_global_cache_refuses_per_row_positions_and_ragged_prefill():
    tcfg, tparams, ctx, cache, toks = _dense_prefilled()
    step = {"tokens": torch.from_numpy(toks[:, P:P + 1]).long()}
    with pytest.raises(NotImplementedError,
                       match="per-sequence decode positions.*paged"):
        port_model.forward(tcfg, tparams, step, ctx, mode="decode",
                           cache=cache, pos=torch.tensor([P, P]))
    with pytest.raises(NotImplementedError, match="ragged prefill needs the "
                       "paged layout"):
        port_model.forward(tcfg, tparams,
                           {"tokens": torch.from_numpy(toks[:, :P]).long()},
                           ctx, mode="prefill", cache=cache,
                           lengths=torch.tensor([P, 7]))


def test_identity_tables_need_the_worst_case_pool():
    _, tcfg = configs("qwen3-0.6b", "paged")
    with pytest.raises(ValueError, match="identity"):
        port_model.init_cache(tcfg, 4, 64, page_budget=3,
                              paged_tables="identity", device=CPU)
    # empty tables (the port's default, which its engine takes) take any
    cache = port_model.init_cache(tcfg, 4, 64, page_budget=3, device=CPU)
    assert (cache["page_table"] == -1).all()
    ident = port_model.init_cache(tcfg, 4, 64, paged_tables="identity",
                                  device=CPU)["page_table"]
    assert torch.equal(ident, torch.arange(32, dtype=torch.int32)
                       .reshape(4, 8))


def test_a_ring_shorter_than_the_window_fails_on_both_sides():
    """max_len 12 under gemma2's reduced window of 16 (ROADMAP R10): the
    reference's lockstep prefill cannot write its short ring's (B, W) map
    with the shared (S,) positions; the port refuses the cache up front,
    and its lockstep run and CLI say why."""
    rcfg, tcfg = configs("gemma2-9b")
    rparams, _, model = weights("gemma2-9b")
    toks, _ = inputs(tcfg)
    rcache = ref_model.init_cache(rcfg, B, 12, layout="dense")
    with pytest.raises(TypeError, match="update shape"):
        ref_model.forward(rcfg, rparams, {"tokens": jnp.asarray(toks[:, :8])},
                          RefCtx(mesh=None, dtype=jnp.float32),
                          mode="prefill", cache=rcache)
    with pytest.raises(ValueError, match="max_len >= window_size"):
        port_model.init_cache(tcfg, B, 12, device=CPU)
    with pytest.raises(ValueError, match="shorter than the local window"):
        run_lockstep(tcfg, model, ServeSpec(batch=B, prompt_len=8, gen=4),
                     device=CPU, dtype=torch.float32)
    with pytest.raises(SystemExit, match="shorter than the local window"):
        serve.main(["--arch", "gemma2-9b", "--reduced", "--device", "cpu",
                    "--prompt-len", "8", "--gen", "4"])


# ---------------------------------------------------------------------------
# The CLI and run_lockstep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flags,layout", [([], "dense"),
                                          (["--layout", "paged"], "paged"),
                                          (["--layout", "dense"], "dense")])
def test_serve_cli_runs_lockstep(capsys, flags, layout):
    rc = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "16", "--gen", "6", *flags])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"[serve] arch=qwen3-0.6b-reduced layout={layout} device=cpu" \
        in out
    assert "[serve/continuous]" not in out and "sample continuations" in out


def test_serve_cli_continuous_refuses_the_dense_layout(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--reduced", "--device", "cpu", "--continuous",
                    "--layout", "dense"])
    assert e.value.code not in (0, None)
    rc = serve.main(["--reduced", "--device", "cpu", "--continuous",
                     "--batch", "2", "--prompt-len", "16", "--gen", "6",
                     "--requests", "3"])
    assert rc == 0
    assert "[serve/continuous]" in capsys.readouterr().out


def ref_lockstep_tokens(rcfg, rparams, prompts, src, G):
    """The reference's ``run_lockstep`` loop (prefill, argmax, decode at
    ``jnp.int32(t)``) on given prompts and frames, through its own
    ``make_serve_steps`` under ``Ctx(mesh=None)``."""
    from repro.train.steps import make_serve_steps
    Bp, Pp = prompts.shape
    prefill, decode = make_serve_steps(rcfg, RefCtx(mesh=None,
                                                    dtype=jnp.float32))
    batch = {"tokens": jnp.asarray(prompts, jnp.int32)}
    if src is not None:
        batch["src_embeds"] = jnp.asarray(src)
    cache = ref_model.init_cache(rcfg, Bp, Pp + G,
                                 src_len=0 if src is None else src.shape[1])
    logits, cache = prefill(rparams, batch, cache)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    out = [tok]
    for t in range(Pp, Pp + G - 1):
        logits, cache = decode(rparams, {"tokens": tok}, cache, jnp.int32(t))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "seamless-m4t-medium"])
def test_run_lockstep_tokens_match_the_reference(arch, capsys):
    rcfg, tcfg = configs(arch)
    rparams, _, model = weights(arch)
    sv = ServeSpec(batch=2, prompt_len=16, gen=6)
    prompts, src = lockstep_inputs(tcfg, sv, seed=3)
    assert (src is not None) == tcfg.is_encoder_decoder
    if src is not None:
        assert src.shape == (2, 16, tcfg.d_model)
    out = run_lockstep(tcfg, model, sv, device=CPU, dtype=torch.float32,
                       seed=3)
    assert out["tokens"].shape == (2, 6) and out["layout"] == "dense"
    assert "layout=dense device=cpu" in capsys.readouterr().out
    np.testing.assert_array_equal(
        out["tokens"].numpy(),
        ref_lockstep_tokens(rcfg, rparams, prompts, src, sv.gen))


def test_run_lockstep_needs_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs("qwen3-0.6b")
    _, _, model = weights("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_lockstep(tcfg, model, ServeSpec(batch=2, prompt_len=8, gen=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--layout", "paged"])


def test_dense_cache_is_larger_in_specs():
    """The twin of the reference's ``test_paged_cache_is_smaller_in_specs``
    on the meta device: a paged pool of 64 pages and its table hold less
    than a quarter of qwen3-0.6b's dense worst case at B 8, 4,096."""
    cfg = get_config("qwen3-0.6b")

    def size(cache):
        return sum(t.numel() for v in cache.values()
                   for t in (v if isinstance(v, list) else [v]))
    dense = port_model.init_cache(cfg, 8, 4096, device="meta")
    paged = port_model.init_cache(cfg, 8, 4096, layout="paged",
                                  page_budget=64, device="meta")
    assert sorted(dense) == ["k_dense", "pos_dense", "v_dense"]
    assert all(t.is_meta for t in dense["k_dense"])
    assert size(paged) < size(dense) / 4

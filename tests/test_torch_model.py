"""The port's model against the JAX reference on the CPU, with the
reference's own weights converted by tree path: prefill (plain, ragged,
chunked) and decode logits, the paged cache contents the writers leave,
and the parameter counts of the full-width configs.

The reference runs with ``Ctx(mesh=None, dtype=float32)`` (any mesh
breaks it on this jax).  Both sides compute in fp32 and keep fp32 KV pools
(``cfg.dtype="float32"``): with bf16 pools a 1e-7 difference in a K value
can round to the neighbouring bf16 number, which says nothing about the
port.  Tolerance: 1e-4 absolute on logits and cached K/V of magnitude ~1
(fp32 summation order differs between XLA and torch)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.engine import _set_page_tables as ref_set_tables  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import Model, cast_params, count_params  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


ATOL = 1e-4
CPU = torch.device("cpu")

# the dense configs at .reduced(), and paper-overhead, qwen2.5-32b,
# mistral-large-123b and internvl2-76b narrowed with their own groups kept
# (G 3, 5, 12 and 8; .reduced() makes every group 2); qwen2.5's qkv bias
# comes along; internvl2 serves text-only here (its frontend:
# tests/test_torch_internvl2.py)
CASES = {
    "qwen3": ("qwen3-0.6b", {}),
    "paper": ("paper-overhead-100m", {}),
    "paper-g3": ("paper-overhead-100m", dict(num_heads=6, num_kv_heads=2)),
    "qwen2.5-g5": ("qwen2.5-32b", dict(num_heads=10, num_kv_heads=2)),
    "mistral-g12": ("mistral-large-123b", dict(num_heads=24,
                                               num_kv_heads=2)),
    "internvl2-g8": ("internvl2-76b", dict(num_heads=16, num_kv_heads=2)),
}
DENSE_ARCHS = ("qwen3-0.6b", "paper-overhead-100m", "qwen2.5-32b",
               "mistral-large-123b", "gemma2-9b", "internvl2-76b")


def _configs(arch, narrow):
    over = dict(cache_layout="paged", dtype="float32", **narrow)
    return (dataclasses.replace(ref_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    arch, narrow = CASES[request.param]
    rcfg, tcfg = _configs(arch, narrow)
    rparams = ref_init_params(rcfg, jax.random.key(0))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rcfg, tcfg, rparams, cast_params(model, torch.float32)


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _ref_pools(cache, name):
    """(L, P, K, ps, hd) pool of every layer of the reference cache."""
    return _np(cache["groups"]["0"]["attn"][name])


def _port_pools(cache, name):
    return np.stack([t.float().numpy() for t in cache[name]])


def _caches(rcfg, tcfg, B, max_len, table):
    pool = int(table.max()) + 1
    rc = ref_model.init_cache(rcfg, B, max_len, layout="paged",
                              page_budget=pool, paged_tables="empty")
    rc = ref_set_tables(rc, table)
    tc = port_model.init_cache(tcfg, B, max_len, page_budget=pool,
                               device=CPU)
    tc["page_table"].copy_(torch.from_numpy(table))
    return rc, tc


def _table(B, pps):
    """Rows own distinct, shuffled pages; the last row's table has a -1
    tail (its prompt is short)."""
    perm = np.random.default_rng(3).permutation(B * pps).astype(np.int32)
    table = perm.reshape(B, pps)
    table[-1, 2:] = -1
    return table


def test_configs_are_faithful_copies():
    for arch in DENSE_ARCHS:
        for rcfg, tcfg in ((ref_get_config(arch), get_config(arch)),
                           _configs(arch, {})):
            assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
            assert rcfg.reduced() == rcfg.reduced() and \
                dataclasses.asdict(rcfg.reduced()) == \
                dataclasses.asdict(tcfg.reduced())
            assert rcfg.padded_vocab == tcfg.padded_vocab
            assert rcfg.layer_kinds() == tcfg.layer_kinds()


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_count_params_matches_reference_at_full_width(arch):
    from repro.models.params import count_params as ref_count

    cfg = get_config(arch)
    assert count_params(cfg) == ref_count(ref_get_config(arch))
    assert count_params(cfg, include_embed=True) == \
        ref_count(ref_get_config(arch), include_embed=True)


def test_prefill_ragged_then_decode_match_reference(pair):
    """Ragged prefill (one row of length 0) then three decode steps with
    per-row positions (the idle row at -1): logits and every layer's K/V
    pool agree with the reference."""
    rcfg, tcfg, rparams, tparams = pair
    B, S0, ps = 4, 16, rcfg.page_size
    max_len = S0 + 8
    table = _table(B, -(-max_len // ps))
    lengths = np.array([16, 11, 0, 9], np.int32)
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (B, S0)).astype(np.int32)
    rc, tc = _caches(rcfg, tcfg, B, max_len, table)
    rctx = RefCtx(mesh=None, dtype=jnp.float32)
    tctx = Ctx(device=CPU, dtype=torch.float32)

    rl, rc, _ = ref_model.forward(rcfg, rparams, {"tokens": jnp.asarray(tokens)},
                                  rctx, mode="prefill", cache=rc,
                                  lengths=jnp.asarray(lengths))
    tl, tc = port_model.forward(tcfg, tparams,
                                {"tokens": torch.from_numpy(tokens).long()},
                                tctx, mode="prefill", cache=tc,
                                lengths=torch.from_numpy(lengths))
    live = lengths > 0
    np.testing.assert_allclose(tl.numpy()[live], _np(rl)[live], atol=ATOL)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(_port_pools(tc, name),
                                   _ref_pools(rc, name), atol=ATOL)

    pos = np.where(live, lengths, -1).astype(np.int32)
    tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
    for _ in range(3):
        rl, rc, _ = ref_model.forward(rcfg, rparams, {"tokens": jnp.asarray(tok)},
                                      rctx, mode="decode", cache=rc,
                                      pos=jnp.asarray(pos))
        tl, tc = port_model.forward(tcfg, tparams,
                                    {"tokens": torch.from_numpy(tok).long()},
                                    tctx, mode="decode", cache=tc,
                                    pos=torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy()[live], _np(rl)[live], atol=ATOL)
        tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        pos = np.where(live, pos + 1, -1).astype(np.int32)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(_port_pools(tc, name),
                                   _ref_pools(rc, name), atol=ATOL)


def test_chunked_prefill_matches_reference(pair):
    """Prefix caching: a plain prefill fills the prefix pages, then a
    chunked prefill continues each row at its own start (one row idle).
    Under a vision frontend both packages refuse the chunked prefill
    (its rows would precede position 0)."""
    rcfg, tcfg, rparams, tparams = pair
    B, ps = 3, rcfg.page_size
    max_len = 32
    table = _table(B, -(-max_len // ps))
    table[-1, :] = np.arange(100, 100 + table.shape[1])   # full, distinct
    rng = np.random.default_rng(2)
    first = rng.integers(0, rcfg.vocab_size, (B, 8)).astype(np.int32)
    chunk = rng.integers(0, rcfg.vocab_size, (B, 8)).astype(np.int32)
    starts = np.array([8, 5, 8], np.int32)
    lengths = np.array([8, 3, 0], np.int32)
    rc, tc = _caches(rcfg, tcfg, B, max_len, table)
    rctx = RefCtx(mesh=None, dtype=jnp.float32)
    tctx = Ctx(device=CPU, dtype=torch.float32)

    rl, rc, _ = ref_model.forward(rcfg, rparams, {"tokens": jnp.asarray(first)},
                                  rctx, mode="prefill", cache=rc)
    tl, tc = port_model.forward(tcfg, tparams,
                                {"tokens": torch.from_numpy(first).long()},
                                tctx, mode="prefill", cache=tc)
    np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
    if rcfg.frontend == "vision":
        with pytest.raises(NotImplementedError, match="frontend"):
            ref_model.forward(rcfg, rparams, {"tokens": jnp.asarray(chunk)},
                              rctx, mode="prefill", cache=rc,
                              lengths=jnp.asarray(lengths),
                              starts=jnp.asarray(starts))
        with pytest.raises(NotImplementedError, match="frontend"):
            port_model.forward(tcfg, tparams,
                               {"tokens": torch.from_numpy(chunk).long()},
                               tctx, mode="prefill", cache=tc,
                               lengths=torch.from_numpy(lengths),
                               starts=torch.from_numpy(starts))
        return
    rl, rc, _ = ref_model.forward(rcfg, rparams, {"tokens": jnp.asarray(chunk)},
                                  rctx, mode="prefill", cache=rc,
                                  lengths=jnp.asarray(lengths),
                                  starts=jnp.asarray(starts))
    tl, tc = port_model.forward(tcfg, tparams,
                                {"tokens": torch.from_numpy(chunk).long()},
                                tctx, mode="prefill", cache=tc,
                                lengths=torch.from_numpy(lengths),
                                starts=torch.from_numpy(starts))
    live = lengths > 0
    np.testing.assert_allclose(tl.numpy()[live], _np(rl)[live], atol=ATOL)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(_port_pools(tc, name),
                                   _ref_pools(rc, name), atol=ATOL)


def test_unported_configs_raise():
    base = get_config("qwen3-0.6b").reduced()
    for over in (dict(window_size=8),
                 dict(block_pattern=("recurrent", "global")),
                 dict(num_experts=4, block_pattern=("rwkv",)),
                 dict(block_pattern=("recurrent",)),
                 dict(is_encoder_decoder=True, num_experts=4),
                 dict(frontend="audio"),
                 dict(frontend="vision", window_size=8,
                      block_pattern=("recurrent", "recurrent", "local")),
                 dict(use_mla=True, window_size=8,
                      block_pattern=("recurrent", "recurrent", "local"))):
        with pytest.raises(NotImplementedError, match="later slice"):
            Model(dataclasses.replace(base, **over), device="meta")


def test_weight_draws_are_the_host_s_whatever_the_threads(monkeypatch):
    """A seed's weights are a function of the seed and the leaf names only:
    each DRAW_CHUNK-element chunk of a leaf comes from its own CPU
    generator, so the thread count does not change them, and a leaf larger
    than a chunk is drawn chunk by chunk from those generators (what a
    device build copies up; ``tests/test_torch_cuda.py`` and the card's
    smoke hold a ``cuda`` build equal to the ``cpu`` one)."""
    from repro_torch.models import params as P
    cfg = get_config("qwen3-0.6b").reduced()
    monkeypatch.setattr(P, "DRAW_CHUNK", 1000)     # leaves span chunks
    built = {}
    for threads in (1, 5):
        monkeypatch.setattr(P, "DRAW_THREADS", threads)
        built[threads] = P.init_params(Model(cfg, device=CPU), 7)
    for (n, a), (_, b) in zip(built[1].named_parameters(),
                              built[5].named_parameters()):
        assert torch.equal(a, b), n
    embed = built[1].embed.detach().reshape(-1)
    assert embed.numel() > 3 * 1000
    for i in range(3):
        gen = torch.Generator()
        gen.manual_seed(7 * 1_000_003 + P._stable_hash(f"embed#{i}"))
        want = torch.empty(1000).normal_(0.0, 0.02, generator=gen)
        assert torch.equal(embed[i * 1000:(i + 1) * 1000], want), i


def test_device_draws_use_the_leaf_s_device_and_its_seeds(monkeypatch):
    """``draws="device"`` draws each chunk with a generator on the leaf's
    own device, seeded as the host's: on the CPU that is the host's draw,
    bit for bit, through ``build_model`` and ``init_train_state`` too; any
    other value is refused."""
    from repro_torch.models import params as P
    from repro_torch.models.model import build_model
    from repro_torch.train.steps import init_train_state
    cfg = get_config("qwen3-0.6b").reduced()
    monkeypatch.setattr(P, "DRAW_CHUNK", 1000)     # leaves span chunks
    host = P.init_params(Model(cfg, device=CPU), 3)
    for built in (P.init_params(Model(cfg, device=CPU), 3, draws="device"),
                  build_model(cfg, device=CPU, seed=3, draws="device")):
        for (n, a), (_, b) in zip(host.named_parameters(),
                                  built.named_parameters()):
            assert torch.equal(a, b), n
    state = init_train_state(cfg, seed=3, device=CPU, draws="device")
    for (n, a), (_, b) in zip(host.named_parameters(),
                              state["params"].named_parameters()):
        assert torch.equal(a.float(), b.float()), n
    with pytest.raises(ValueError, match="draws"):
        P.init_params(Model(cfg, device=CPU), 3, draws="card")

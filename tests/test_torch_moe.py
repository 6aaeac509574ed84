"""The port's serving MoE FFN against the reference's
``models/moe.py:moe_ffn(dropless=True)`` on the CPU.

The reference sweeps every token through all experts and weights the
unchosen ones by 0; the port runs only the chosen (token, expert) pairs.
Both compute in fp32 here, with the reference's weights; tolerance 1e-5
absolute on outputs of magnitude ~0.1-1 (only the order of the fp32 sums
differs: the port combines the top-k in probability order, the reference
sums over all experts).  Routing must pick the same experts, ties
included: ``jax.lax.top_k`` breaks a tie toward the lower expert index.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


ATOL = 1e-5
ARCHS = ("deepseek-v2-236b", "granite-moe-1b-a400m")


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _moe_weights(arch, seed=0, **over):
    """The reference's MoE leaves of one layer (its first MoE layer), fp32,
    and the configs they belong to."""
    rcfg, tcfg = (dataclasses.replace(c.reduced(), dtype="float32", **over)
                  for c in (ref_get_config(arch), get_config(arch)))
    tree = ref_init_params(rcfg, jax.random.key(seed))["decoder"]["groups"]
    rp = jax.tree.map(lambda a: a[0], tree["0"]["moe"])
    return rcfg, tcfg, rp


def _both(rcfg, tcfg, rp, x):
    want, _ = ref_moe.moe_ffn(rcfg, rp, jnp.asarray(x),
                              RefCtx(mesh=None, dtype=jnp.float32),
                              dropless=True)
    got = moe.moe_ffn(tcfg, {n: _t(_np(a)) for n, a in rp.items()}, _t(x))
    return _np(want), got.numpy()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 16), (3, 1), (1, 40)],
                         ids=["prefill", "decode", "prefill-long-row"])
def test_moe_ffn_matches_reference(arch, B, S):
    rcfg, tcfg, rp = _moe_weights(arch, seed=B + S)
    x = np.random.default_rng(S).normal(
        size=(B, S, tcfg.d_model)).astype(np.float32)
    want, got = _both(rcfg, tcfg, rp, x)
    assert got.shape == (B, S, tcfg.d_model)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_moe_ffn_with_more_experts_than_tokens_choose():
    """16 experts, top-6 over 5 tokens: most experts get no token and run
    no matmul; the result still equals the dense sweep."""
    rcfg, tcfg, rp = _moe_weights("deepseek-v2-236b", num_experts=16,
                                  num_experts_per_tok=6,
                                  num_shared_experts=2)
    x = np.random.default_rng(9).normal(size=(1, 5, tcfg.d_model)).astype(
        np.float32)
    want, got = _both(rcfg, tcfg, rp, x)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("tie", ["all-equal", "paired-columns"])
def test_router_ties_go_to_the_lower_expert_index(tie):
    """Exactly tied router logits: every column equal (each token's top-k
    must be experts 0..k-1), or columns duplicated in pairs (ties at every
    rank).  The port picks the experts ``lax.top_k`` picks, and the
    outputs agree; an order-free top-k would pick other experts, whose
    weights differ."""
    rcfg, tcfg, rp = _moe_weights("deepseek-v2-236b", seed=4,
                                  num_experts=8, num_experts_per_tok=3)
    router = np.asarray(rp["router"]).copy()
    if tie == "all-equal":
        router[:] = router[:, :1]
    else:
        router[:, 1::2] = router[:, 0::2]
    rp = dict(rp, router=jnp.asarray(router))
    x = np.random.default_rng(5).normal(size=(2, 7, tcfg.d_model)).astype(
        np.float32)
    logits = (x.reshape(-1, tcfg.d_model) @ router).astype(np.float32)
    _, want_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), 3)
    _, got_e = moe.route(_t(logits), 3)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    if tie == "all-equal":
        assert (got_e.numpy() == np.arange(3)).all()
    want, got = _both(rcfg, tcfg, rp, x)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_route_matches_lax_top_k_on_bf16_logits():
    """bf16-rounded logits over 160 experts tie often; the renormalised
    weights and the experts equal the reference's top-k."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(64, 160)).astype(np.float32)
    logits = torch.from_numpy(logits).bfloat16().float().numpy()
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    want_p, want_e = jax.lax.top_k(probs, 6)
    want_p = want_p / jnp.maximum(want_p.sum(-1, keepdims=True), 1e-9)
    got_p, got_e = moe.route(_t(logits), 6)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-7)
    ties = sum(len(np.unique(r)) < len(r) for r in logits)
    assert ties > 0                     # the draw does hold tied rows


def test_moe_ffn_trains_and_refuses_a_row_past_one_group():
    """``mode="train"`` runs (capacity dispatch: ``(out, aux)``; its
    values are held to the reference in ``tests/test_torch_moe_train.py``);
    a row longer than one group must be a whole number of groups in both
    modes, as the reference asserts."""
    rcfg, tcfg, rp = _moe_weights("granite-moe-1b-a400m")
    tp = {n: _t(_np(a)) for n, a in rp.items()}
    out, aux = moe.moe_ffn(tcfg, tp, torch.ones(1, 4, tcfg.d_model),
                           mode="train")
    assert out.shape == (1, 4, tcfg.d_model) and aux.shape == ()
    assert torch.isfinite(out).all() and float(aux) > 0
    with pytest.raises(ValueError, match="mode"):
        moe.moe_ffn(tcfg, tp, torch.ones(1, 4, tcfg.d_model), mode="eval")
    small = dataclasses.replace(tcfg, moe_group_size=8)
    rsmall = dataclasses.replace(rcfg, moe_group_size=8)
    x = np.zeros((1, 12, tcfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="not divisible"):
        ref_moe.moe_ffn(rsmall, rp, jnp.asarray(x),
                        RefCtx(mesh=None, dtype=jnp.float32), dropless=True)
    for mode in ("serve", "train"):
        with pytest.raises(ValueError, match="whole number of MoE dispatch"):
            moe.moe_ffn(small, tp, _t(x), mode=mode)
    # two whole groups, and a row shorter than one group, pass on both sides
    for S in (16, 5):
        x = np.random.default_rng(S).normal(
            size=(1, S, tcfg.d_model)).astype(np.float32)
        want, got = _both(rsmall, small, rp, x)
        np.testing.assert_allclose(got, want, atol=ATOL)

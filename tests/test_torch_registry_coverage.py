"""Every registered config of the port serves through its engine on the
paged layout: admit, two decode steps, a snapshot restored on a fresh
engine byte for byte, and both engines drained to the same responses
(the twin of ``tests/test_registry_coverage.py``, port only)."""
import dataclasses
import pickle

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.launch.engine import (  # noqa: E402
    ServingEngine, synthesize_requests,
)
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

CPU = torch.device("cpu")


def plain(x):
    """A snapshot with every tensor as its dtype, shape and bytes, for
    pickling."""
    if isinstance(x, torch.Tensor):
        return (str(x.dtype), tuple(x.shape),
                x.contiguous().view(torch.uint8).numpy().tobytes())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


@pytest.mark.parametrize("arch", list_configs())
def test_every_config_serves_paged(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              cache_layout="paged")
    sv = ServeSpec(batch=2, prompt_len=12, gen=4, requests=3,
                   continuous=True, cache_layout="paged")
    model = build_model(cfg, device=CPU, seed=0)

    def engine():
        return ServingEngine(cfg, model, sv, device=CPU, dtype=torch.float32)

    eng = engine()
    for r in synthesize_requests(cfg, sv, seed=7, ragged=eng.ragged):
        eng.submit(r)
    assert eng.admit(), arch
    for _ in range(2):
        eng.step()

    # a restore on a fresh engine reproduces the state byte for byte
    snap = eng.snapshot()
    eng2 = engine()
    eng2.restore(snap)
    assert pickle.dumps(plain(eng2.snapshot())) == pickle.dumps(plain(snap))

    # both incarnations drain to the same responses, every one complete
    eng.run()
    eng2.run()
    assert eng.responses == eng2.responses, arch
    assert len(eng.responses) == sv.requests, (arch, eng.responses)
    gen_lens = {r.req: r.gen_len for r in synthesize_requests(
        cfg, sv, seed=7, ragged=eng.ragged)}
    assert {r: len(t) for r, t in eng.responses.items()} == gen_lens

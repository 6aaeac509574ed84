"""What the port may import and where it runs.

The port imports ``torch`` and ``numpy`` and nothing of ``jax`` or of the
JAX package ``repro``; its entry points run on ``cuda`` unless the caller
names another device, and without a card that is an error, never a silent
run on the CPU.  The serve CLI is driven end to end on the CPU here.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import ServingEngine  # noqa: E402
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import build_model, init_cache  # noqa: E402
from repro_torch.models.params import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_serve_cli_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.models.recurrent, repro_torch.kernels.rglru_scan; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_importing_the_platform_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.core, repro_torch.core.learner, "
            "repro_torch.core.server, repro_torch.core.elastic, "
            "repro_torch.launch.engine, repro_torch.launch.train, "
            "repro_torch.dist, repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m in ('jax', 'ml_dtypes') or "
            "m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_platform_payloads_need_an_explicit_cpu(monkeypatch):
    """The platform's stock serve payload runs on ``cuda`` unless it is
    built with another device; without a card that is an error inside
    the pod (a pod failure the Guardian sees), never a run on the CPU."""
    from repro_torch.core import JobSpec, ServeSpec
    from repro_torch.core.jobspec import ArchitectureAdapter
    from repro_torch.launch.engine import RealServePayload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = JobSpec(name="s", kind="serve", framework="qwen3-0.6b",
                   serve=ServeSpec(real_compute=True, requests=2))
    payload = ArchitectureAdapter("qwen3-0.6b").payload(
        SimpleNamespace(payloads={}), "job-1", spec)
    assert isinstance(payload, RealServePayload) and payload.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        payload.build()
    engine, requests = RealServePayload(spec, device="cpu").build()
    assert engine.ctx.device == torch.device("cpu") and len(requests) == 2


def test_entry_points_need_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              cache_layout="paged")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layers.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 2, 16)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, model, ServeSpec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
    assert layers.resolve_device("cpu") == torch.device("cpu")


def test_recurrentgemma_entry_points_need_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              cache_layout="paged")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 2, 16)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, model, ServeSpec(prompt_len=24, gen=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "recurrentgemma-9b", "--reduced"])


@pytest.mark.parametrize("over,what", [
    (dict(block_pattern=("recurrent", "global")), "block kinds"),
    (dict(block_pattern=("recurrent", "local", "global")), "block kinds"),
    (dict(window_size=0), "local layers without a window"),
    (dict(frontend="vision", frontend_tokens=4), "the vision frontend"),
    (dict(is_encoder_decoder=True, num_encoder_layers=2), "encoder-decoder"),
    (dict(num_experts=4, num_experts_per_tok=2, moe_d_ff=32),
     "MoE on a stack that is not all-global"),
], ids=["recurrent+global", "recurrent+local+global", "no-window",
        "frontend", "encoder-decoder", "moe"])
def test_hybrid_stack_refuses_what_the_port_lacks(over, what):
    """The RG-LRU + local-attention mix, the √d embedding scale and
    gemma2's features (softcaps, ``query_pre_attn_scalar``, post-block
    norms) are ported; a global layer beside a recurrent one, a
    window-less local layer, a frontend, an encoder-decoder and an MoE FFN
    on the mix are not, each named in the refusal."""
    base = get_config("recurrentgemma-9b").reduced()
    build_model(base, device="cpu")
    build_model(dataclasses.replace(
        base, attn_logit_softcap=50.0, final_logit_softcap=30.0,
        query_pre_attn_scalar=256.0, use_post_block_norm=True), device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        build_model(dataclasses.replace(base, **over), device="cpu")


def test_engine_refuses_weights_on_another_device():
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              cache_layout="paged")
    model = Model(cfg, device="meta")
    with pytest.raises(ValueError, match="weights on"):
        ServingEngine(cfg, model, ServeSpec(), device="cpu")


@pytest.mark.parametrize("flags", [
    ["--no-prefix-cache"],
    ["--shared-prefix", "0.5"],
    ["--overcommit", "2", "--page-budget", "8"],
])
def test_serve_cli_runs_on_cpu(capsys, flags):
    rc = serve.main(["--reduced", "--device", "cpu", "--batch", "3",
                     "--continuous",
                     "--prompt-len", "24", "--gen", "6", "--requests", "5",
                     *flags])
    assert rc == 0
    out = capsys.readouterr().out
    assert "completed 5/5" in out
    assert "device=cpu" in out


def test_serve_cli_rejects_bad_flags():
    with pytest.raises(SystemExit):
        serve.main(["--continuous", "--reduced", "--device", "cpu",
                    "--page-budget", "1"])


def test_unported_configs_raise_at_build():
    assert list_configs() == ("deepseek-v2-236b", "gemma2-9b",
                              "granite-moe-1b-a400m", "internvl2-76b",
                              "mistral-large-123b", "paper-overhead-100m",
                              "qwen2.5-32b", "qwen3-0.6b",
                              "recurrentgemma-9b", "rwkv6-7b",
                              "seamless-m4t-medium")
    base = get_config("qwen3-0.6b").reduced()
    build_model(dataclasses.replace(base, frontend="vision",
                                    frontend_tokens=4), device="cpu")
    build_model(dataclasses.replace(base, is_encoder_decoder=True,
                                    num_encoder_layers=2), device="cpu")
    for over in (dict(window_size=8),
                 dict(block_pattern=("recurrent", "global")),
                 dict(frontend="vision", num_experts=4, num_experts_per_tok=2,
                      moe_d_ff=32),
                 dict(block_pattern=("recurrent",)),
                 dict(is_encoder_decoder=True, num_encoder_layers=2,
                      num_experts=4, num_experts_per_tok=2, moe_d_ff=32),
                 dict(frontend="audio"),
                 dict(block_pattern=("recurrent", "local", "global"),
                      window_size=8),
                 dict(use_mla=True, kv_lora_rank=16,
                      block_pattern=("global", "local"), window_size=8)):
        cfg = dataclasses.replace(base, **over)
        with pytest.raises(NotImplementedError, match="later slice"):
            build_model(cfg, device="cpu")
    assert base.cache_layout == "dense"
    assert sorted(init_cache(base, 2, 16, device="cpu")) == [
        "k_dense", "pos_dense", "v_dense"]
    assert get_config("seamless-m4t-medium").is_encoder_decoder
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("seamless-m4t-large")

#!/usr/bin/env python3
"""How sensitive rwkv6-7b's training gradient is to WKV6's output, and
where the port's fp32 cuda-vs-cpu gradient gap comes from.

    python3 tools/rwkv_grad_sensitivity.py --device cpu   # reduced, CPU
    python3 tools/rwkv_grad_sensitivity.py                 # on a card

Both modes, fp32 with TF32 off, from one seed:

* the gradient of the loss on one batch, and how far it moves (relative
  to its norm) when WKV6's output o is multiplied by 1 + eps·N(0, 1),
  eps 1e-7 and 1e-6: the model's sensitivity to rounding in o;
* the plain backward against autograd through the step oracle
  (``kernels/ref.py:wkv6_ref``) and through the plain chunked forward, at
  constant decays -3 and -8 and at decays down to -e^4: each gradient's
  largest error over its largest magnitude.

On a card, also rwkv6-7b at full width cut to 2 layers (B 2, S 256): the
largest gradient error over its leaf's largest magnitude, cuda against
cpu, with each of the forward and the backward taken as the kernel or as
the plain version on the card, and the forward kernel's o against the
step oracle at the model's own WKV6 inputs.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    Model, compute_params, init_params, make_trainable)
from repro_torch.train.steps import loss_fn  # noqa: E402

NAMES = ("dr", "dk", "dv", "dlw", "du", "ds0")


def step_oracle(r, k, v, lw, u, s0):
    """``ref.wkv6_ref`` in the model layout."""
    B, S, H, N = r.shape
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, N)  # noqa: E731
    o, s_fin = ref.wkv6_ref(fold(r), fold(k), fold(v), fold(lw),
                            u[None].expand(B, H, N).reshape(B * H, 1, N),
                            s0.reshape(B * H, N, N))
    return o.reshape(B, H, S, N).transpose(1, 2), s_fin.reshape(B, H, N, N)


def gradients(cfg, model, batch, dev, noise=0.0, seed=0):
    """(loss, {leaf: gradient on the host}); with ``noise``, WKV6's o is
    multiplied by 1 + noise·N(0, 1) (a generator seeded ``seed``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    plain = ops.wkv6_bshn

    def noisy(*a, **kw):
        o, s = plain(*a, **kw)
        return o * (1 + noise * torch.randn(o.shape, generator=gen,
                                            device=o.device)), s
    ops.wkv6_bshn = noisy
    try:
        names, leaves = zip(*model.named_parameters())
        loss, _ = loss_fn(cfg, compute_params(model, torch.float32), batch,
                          Ctx(device=dev, dtype=torch.float32))
        grads = torch.autograd.grad(loss, leaves)
    finally:
        ops.wkv6_bshn = plain
    return float(loss), {n: g.cpu() for n, g in zip(names, grads)}


def flat(g):
    return torch.cat([x.flatten() for x in g.values()])


def sensitivity(cfg, dev, S, B):
    model = make_trainable(init_params(Model(cfg, device=dev), 0))
    batch = SyntheticLMData(cfg.vocab_size, S, B, 0).batch_at(0, dev)
    _, g0 = gradients(cfg, model, batch, dev)
    for eps in (1e-7, 1e-6):
        _, g = gradients(cfg, model, batch, dev, noise=eps)
        rel = ((flat(g) - flat(g0)).norm() / flat(g0).norm()).item()
        print(f"  o x (1 + {eps:g}·N(0, 1)): the gradient moves {rel:.3g} "
              "of its norm", flush=True)


def strong_decays(dev):
    for decay in (-3.0, -8.0, "strong"):
        gen = torch.Generator(device=dev).manual_seed(11)
        B, S, H, N = 2, 70, 2, 64
        r, k, v, do = (torch.randn(B, S, H, N, generator=gen, device=dev)
                       for _ in range(4))
        lw = torch.full((B, S, H, N), decay, device=dev) \
            if isinstance(decay, float) else -torch.exp(
                torch.rand(B, S, H, N, generator=gen, device=dev) * 10 - 6)
        u = 0.5 * torch.randn(H, N, generator=gen, device=dev)
        s0, dsf = (0.3 * torch.randn(B, H, N, N, generator=gen, device=dev)
                   for _ in range(2))
        _, _, ck = wkv.wkv6_torch(r, k, v, lw, u, s0, seg=wkv.SEG)
        got = wkv.wkv6_bwd_torch(r, k, v, lw, u, ck, do, dsf)
        for name, forward in (("step oracle", step_oracle),
                              ("chunked forward", wkv.wkv6_torch)):
            leaves = [t.clone().requires_grad_(True)
                      for t in (r, k, v, lw, u, s0)]
            o, s_fin = forward(*leaves)
            want = torch.autograd.grad((o * do).sum() + (s_fin * dsf).sum(),
                                       leaves)
            errs = ", ".join(
                f"{n} {((g - w).abs().max() / w.abs().max()).item():.2g}"
                for n, g, w in zip(NAMES, got, want))
            print(f"  lw {decay}: plain backward vs autograd through the "
                  f"{name}: {errs}", flush=True)


def card_parts(dev):
    """Full width, 2 layers: the cuda-vs-cpu gradient gap by which parts
    run as kernels."""
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=2)
    data = SyntheticLMData(cfg.vocab_size, 256, 2, 0)
    init = make_trainable(init_params(Model(cfg, device=cpu), 0))
    _, g_cpu = gradients(cfg, init, data.batch_at(0, cpu), cpu)
    model = make_trainable(init_params(Model(cfg, device=dev), 0))
    fwd_k, bwd_k = wkv.wkv6_cuda, ops.wkv6_bwd

    def plain_fwd(r, k, v, lw, u, s0, *, seg=0):
        return wkv.wkv6_torch(r, k, v, lw, u, s0, seg=seg)

    def plain_bwd(r, k, v, lw, u, ck, do, ds=None):
        return wkv.wkv6_bwd_torch(r, k, v, lw, u, ck, do, ds)
    for label, f, b in (("kernel forward, kernel backward", fwd_k, bwd_k),
                        ("kernel forward, plain backward", fwd_k, plain_bwd),
                        ("plain forward, kernel backward", plain_fwd, bwd_k),
                        ("plain forward, plain backward", plain_fwd,
                         plain_bwd)):
        wkv.wkv6_cuda, ops.wkv6_bwd = f, b
        try:
            _, g = gradients(cfg, model, data.batch_at(0, dev), dev)
        finally:
            wkv.wkv6_cuda, ops.wkv6_bwd = fwd_k, bwd_k
        worst, leaf = max(
            (((g[n] - g_cpu[n]).abs().max() / g_cpu[n].abs().max()).item(), n)
            for n in g_cpu)
        print(f"  {label}: cuda vs cpu, largest gradient error {worst:.3g} "
              f"of its leaf's largest ({leaf})", flush=True)
    inputs = []
    plain = ops.wkv6_bshn

    def grab(*a, **kw):
        inputs.append([t.detach().clone() for t in a])
        return plain(*a, **kw)
    ops.wkv6_bshn = grab
    try:
        with torch.no_grad():
            loss_fn(cfg, compute_params(model, torch.float32),
                    data.batch_at(0, dev), Ctx(device=dev,
                                               dtype=torch.float32))
    finally:
        ops.wkv6_bshn = plain
    for i, (r, k, v, lw, u, s0) in enumerate(inputs):
        want, _ = step_oracle(r, k, v, lw, u, s0)
        scale = want.abs().max().item()
        for label, fn in (("kernel", fwd_k), ("plain", wkv.wkv6_torch)):
            o, _ = fn(r, k, v, lw, u, s0)
            print(f"  layer {i}: the {label} forward's o vs the step oracle "
                  f"{(o - want).abs().max().item() / scale:.3g} of its "
                  f"largest (lw in [{lw.min().item():.3g}, "
                  f"{lw.max().item():.3g}])", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the reduced model here; default cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
        print("[sensitivity] rwkv6-7b full width, 2 layers, B 2, S 256",
              flush=True)
        sensitivity(dataclasses.replace(get_config("rwkv6-7b"),
                                        num_layers=2), dev, 256, 2)
        print("[cuda vs cpu by part]", flush=True)
        card_parts(dev)
    else:
        print("[sensitivity] rwkv6-7b reduced, B 2, S 40", flush=True)
        sensitivity(get_config("rwkv6-7b").reduced(), dev, 40, 2)
    print("[strong decays]", flush=True)
    strong_decays(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

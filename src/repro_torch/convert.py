"""Reference weights and train states ↔ the port's.

``params_from_jax`` takes the reference's parameter tree as nested dicts of
numpy arrays (``jax.device_get(init_params(cfg, key))``) and returns a
``state_dict`` for :class:`repro_torch.models.params.Model`.  Leaves are
keyed by tree path.  The unrolled ``decoder/prefix/{i}`` (the first
``first_k_dense`` layers) is layer ``i``; the stacked ``decoder/groups``
leaves are unstacked into one block per layer after it (layer
``first_k_dense + g * len(pattern) + j`` for group ``g``, pattern position
``j``); the unrolled ``tail`` follows the groups.  An encoder-decoder's
``encoder/{groups,tail}`` become ``encoder_blocks.{i}`` the same way (an
encoder has no prefix), and its decoder's cross-attention leaves ride in
its blocks.  ``params_to_jax`` is its inverse, restacking ``blocks.{i}``
into ``decoder/{prefix,groups,tail}`` and ``encoder_blocks.{i}`` into
``encoder/{groups,tail}``.

``train_state_from_jax`` / ``train_state_to_jax`` carry a whole train
state across (the reference's ``{params, opt: {m, v, count}, step}`` and,
under gradient compression, ``err``, as numpy trees; the moments and the
error buffers are keyed like the parameters), so a state written by one
package can continue in the other; ``overlay_train_state`` loads such a
tree into an existing state in place (the platform learner's restore,
``core/learner.py``).  ``reference_stacks`` names the port's leaves that
the reference stacks into one leaf.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, check_ported


def _flatten(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, torch.Tensor):  # a bf16 leaf of a port checkpoint
        yield path, tree
    else:
        yield path, np.asarray(tree)


def _tensor(a, copy: bool = True) -> torch.Tensor:
    """A torch leaf of ``a``; without ``copy`` it may share ``a``'s memory
    (a C-contiguous, writable array), for a caller that copies it on."""
    if isinstance(a, torch.Tensor):      # a bf16 leaf of a port checkpoint
        return a.detach().clone() if copy else a.detach()
    if a.dtype.name == "bfloat16":       # ml_dtypes leaf: exact via fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if not copy and a.flags.c_contiguous and a.flags.writeable:
        return torch.from_numpy(a)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


#: The reference's stacks and the port's block lists they become.
STACKS = {"decoder": "blocks", "encoder": "encoder_blocks"}


def _layout(cfg: ModelConfig, stack: str = "decoder") -> Tuple[int, int, int]:
    """(pattern length, prefix layers, groups) of the reference's
    ``stack``: the encoder has no first-k-dense prefix."""
    pat = len(cfg.block_pattern)
    if stack == "encoder":
        return pat, 0, cfg.num_encoder_layers // pat
    first = cfg.first_k_dense
    return pat, first, (cfg.num_layers - first) // pat


def reference_path(cfg: ModelConfig, name: str
                   ) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The reference's tree path of the port's leaf ``name`` and, for a
    leaf of a stacked group (``decoder/groups``, ``encoder/groups``), its
    index in the stack (None elsewhere)."""
    path = name.split(".")
    stack_of = {blocks: stack for stack, blocks in STACKS.items()}
    if path[0] not in stack_of:
        return tuple(path), None
    stack = stack_of[path[0]]
    pat, first, n_groups = _layout(cfg, stack)
    i, rest = int(path[1]), tuple(path[2:])
    if i < first:
        return (stack, "prefix", str(i)) + rest, None
    g, j = divmod(i - first, pat)
    if g < n_groups:
        return (stack, "groups", str(j)) + rest, g
    return (stack, "tail", str(j)) + rest, None


def reference_stacks(cfg: ModelConfig, names=None) -> List[List[str]]:
    """The port's parameter names (``names``, by default every parameter
    of ``cfg``'s model) that the reference stacks into one leaf of
    ``decoder/groups`` or ``encoder/groups``, a list per leaf in the
    stack's order: what a per-tensor reduction over the reference's tree
    (gradient compression's scale or top-k) spans."""
    if names is None:
        from repro_torch.models.params import Model
        names = [n for n, _ in Model(cfg, device="meta").named_parameters()]
    stacks: Dict[Tuple[str, ...], list] = {}
    for name in names:
        path, g = reference_path(cfg, name)
        if g is not None:
            n_groups = _layout(cfg, path[0])[2]
            stacks.setdefault(path, [None] * n_groups)[g] = name
    return list(stacks.values())


def params_from_jax(tree, cfg: ModelConfig, *,
                    copy: bool = True) -> Dict[str, torch.Tensor]:
    """The reference's nested parameter tree (or any tree shaped like it,
    e.g. the AdamW moments) as the port's state dict, a layer a
    ``blocks.{i}`` entry.  Each leaf is a copy; with ``copy`` False a leaf
    may share the tree's memory, for a caller that copies it on (to a
    device, or into the state's own tensors)."""
    check_ported(cfg)
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        if path[0] not in STACKS:
            out[".".join(path)] = _tensor(arr, copy)
            continue
        pat, first, n_groups = _layout(cfg, path[0])
        blocks = STACKS[path[0]]
        part, j, rest = path[1], int(path[2]), ".".join(path[3:])
        if part == "prefix":
            out[f"{blocks}.{j}.{rest}"] = _tensor(arr, copy)
        elif part == "groups":
            for g in range(arr.shape[0]):
                out[f"{blocks}.{first + g * pat + j}.{rest}"] = _tensor(
                    arr[g], copy)
        elif part == "tail":
            out[f"{blocks}.{first + n_groups * pat + j}.{rest}"] = _tensor(
                arr, copy)
        else:
            raise NotImplementedError(
                f"{path[0]}/{part}: the reference's stacks hold prefix, "
                "groups and tail")
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a device tensor's ``cpu()`` is one already)."""
    copied = t.device.type != "cpu"
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                 # numpy's bfloat16, as jax keeps it
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy() if copied else t.numpy().copy()


def _stacked(ts) -> np.ndarray:
    """``np.stack`` of the host copies of ``ts``, each tensor copied once,
    straight into its slice (a bf16 leaf through :func:`_numpy`)."""
    if ts[0].dtype == torch.bfloat16:
        return np.stack([_numpy(t) for t in ts])
    out = torch.empty((len(ts),) + tuple(ts[0].shape), dtype=ts[0].dtype)
    for g, t in enumerate(ts):
        out[g].copy_(t.detach())
    return out.numpy()


def _nest(tree: Dict, path, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def params_to_jax(state: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict:
    """The port's state dict (or any tree keyed like it, e.g. the AdamW
    moments) as the reference's nested tree of numpy arrays: ``blocks.{i}``
    goes back to ``decoder/prefix/{i}``, to slice ``g`` of the stacked
    ``decoder/groups/{j}`` or to ``decoder/tail/{j}``, and
    ``encoder_blocks.{i}`` to ``encoder/groups`` or ``encoder/tail``."""
    check_ported(cfg)
    out: Dict = {}
    stacks: Dict[Tuple[str, ...], list] = {}
    for name, t in state.items():
        path, g = reference_path(cfg, name)
        if g is None:
            _nest(out, list(path), _numpy(t))
        else:
            n_groups = _layout(cfg, path[0])[2]
            stacks.setdefault(path, [None] * n_groups)[g] = t
    for key, ts in stacks.items():
        _nest(out, list(key), _stacked(ts))
    return out


def train_state_from_jax(tree, cfg: ModelConfig, device=None) -> Dict:
    """The reference's train state (numpy tree: ``params``, ``opt.m``,
    ``opt.v``, ``opt.count``, ``step`` and, under compression, ``err``) as
    the port's, on ``device`` (``cuda`` unless the caller names one);
    moments and error buffers keep their dtype."""
    from repro_torch.models.layers import resolve_device
    from repro_torch.models.params import Model, make_trainable
    from repro_torch.train.steps import new_train_state

    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    # a leaf bound for a card is copied there; one that stays on the host
    # is copied once, so the state never shares the tree's memory
    copy = dev.type == "cpu"
    weights = params_from_jax(tree["params"], cfg, copy=copy)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = weights[name].to(dev)
    make_trainable(model)
    state = new_train_state(model)
    for part in ("m", "v"):
        state["opt"][part] = {n: t.to(dev) for n, t in params_from_jax(
            tree["opt"][part], cfg, copy=copy).items()}
    if "err" in tree:
        state["err"] = {n: t.to(dev) for n, t in params_from_jax(
            tree["err"], cfg, copy=copy).items()}
    state["opt"]["count"] = torch.tensor(int(tree["opt"]["count"]),
                                         dtype=torch.int32, device=dev)
    state["step"] = torch.tensor(int(tree["step"]), dtype=torch.int32,
                                 device=dev)
    return state


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"{what}: the tree holds "
                         f"{sorted(set(src) - set(dst))} beyond the state "
                         f"and lacks {sorted(set(dst) - set(src))}")
    for name, t in dst.items():
        if tuple(t.shape) != tuple(src[name].shape):
            raise ValueError(f"{what} {name}: shape {tuple(src[name].shape)}"
                             f", the state's {tuple(t.shape)}")
        t.copy_(src[name])


@torch.no_grad()
def overlay_train_state(state: Dict, tree) -> Dict:
    """Load the reference's train state (numpy tree, as
    :func:`train_state_from_jax` takes it) into the port's ``state`` in
    place: every leaf is copied into the tensor the state holds, on its
    device and in its dtype (the reference's restore casts to the current
    leaf's dtype the same way).  The error buffers come along where the
    state has them; a tree with them and a state without (or the other
    way round) is refused before anything is copied.  Returns
    ``state``."""
    cfg = state["params"].cfg
    if ("err" in tree) != ("err" in state):
        def has(d):
            return "holds" if "err" in d else "lacks"
        raise ValueError(
            f"err: the tree {has(tree)} error buffers and the state "
            f"{has(state)} them (one train step compresses its gradients "
            "and the other does not)")
    _copy_into(dict(state["params"].named_parameters()),
               params_from_jax(tree["params"], cfg, copy=False), "params")
    for part in ("m", "v"):
        _copy_into(state["opt"][part],
                   params_from_jax(tree["opt"][part], cfg, copy=False),
                   f"opt/{part}")
    if "err" in state:
        _copy_into(state["err"], params_from_jax(tree["err"], cfg,
                                                 copy=False), "err")
    state["opt"]["count"].fill_(int(tree["opt"]["count"]))
    state["step"].fill_(int(tree["step"]))
    return state


def train_state_to_jax(state: Dict, cfg: ModelConfig) -> Dict:
    """The port's train state as the reference's numpy tree."""
    params = dict(state["params"].named_parameters())
    out = {
        "params": params_to_jax(params, cfg),
        "opt": {"m": params_to_jax(state["opt"]["m"], cfg),
                "v": params_to_jax(state["opt"]["v"], cfg),
                "count": np.asarray(int(state["opt"]["count"]), np.int32)},
        "step": np.asarray(int(state["step"]), np.int32),
    }
    if "err" in state:
        out["err"] = params_to_jax(state["err"], cfg)
    return out

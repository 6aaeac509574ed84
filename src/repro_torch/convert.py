"""Reference weights → the port's state dict.

``params_from_jax`` takes the reference's parameter tree as nested dicts of
numpy arrays (``jax.device_get(init_params(cfg, key))``) and returns a
``state_dict`` for :class:`repro_torch.models.params.Model`.  Leaves are
keyed by tree path.  The unrolled ``decoder/prefix/{i}`` (the first
``first_k_dense`` layers) is layer ``i``; the stacked ``decoder/groups``
leaves are unstacked into one block per layer after it (layer
``first_k_dense + g * len(pattern) + j`` for group ``g``, pattern position
``j``); the unrolled ``tail`` follows the groups.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, check_ported


def _flatten(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":       # ml_dtypes leaf: exact via fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def params_from_jax(tree, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    check_ported(cfg)
    pat = len(cfg.block_pattern)
    first = cfg.first_k_dense
    n_groups = (cfg.num_layers - first) // pat
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        if path[0] != "decoder":
            out[".".join(path)] = _tensor(arr)
            continue
        part, j, rest = path[1], int(path[2]), ".".join(path[3:])
        if part == "prefix":
            out[f"blocks.{j}.{rest}"] = _tensor(arr)
        elif part == "groups":
            for g in range(arr.shape[0]):
                out[f"blocks.{first + g * pat + j}.{rest}"] = _tensor(arr[g])
        elif part == "tail":
            out[f"blocks.{first + n_groups * pat + j}.{rest}"] = _tensor(arr)
        else:
            raise NotImplementedError(
                f"decoder/{part} comes in a later slice of the port")
    return out

"""Atomic, async-capable checkpoints in the reference's on-disk format
(``repro/training/checkpoint.py``), so a checkpoint written by either
package restores in the other.

One directory per step, ``step_XXXXXXXX/``, holds ``arrays.npz`` (one
array per leaf, keyed by its path with ``/`` written as ``|``) and
``manifest.json`` (``step``, the dict / list ``structure`` and the
``keys``). Writes go to ``step_XXXXXXXX.tmp`` and are renamed into place,
so a killed job never leaves a corrupt latest checkpoint; with
``async_=True`` the device -> host copy is synchronous and the file IO
runs on a background thread.

Leaves are stored as numpy arrays: tensors are copied to the host as
they are, a ``ShardedTensor`` put back together first (numpy has no
bfloat16 here, so a bf16 leaf raises). ``restore(shardings=...)`` lays
every leaf out on the given ``NamedSharding`` (``sharding.shard``),
which may be on another mesh shape than the one that saved it (an
elastic restart).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.training.optimizer import tree_map2

MANIFEST = "manifest.json"


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _structure(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _structure(v) for k, v in sorted(tree.items())}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list", "items": [_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def _unflatten(struct, leaves, prefix=""):
    if struct["__kind__"] == "dict":
        return {k: _unflatten(v, leaves, f"{prefix}/{k}")
                for k, v in struct["items"].items()}
    if struct["__kind__"] == "list":
        return [_unflatten(v, leaves, f"{prefix}/{i}")
                for i, v in enumerate(struct["items"])]
    return leaves[prefix]


def _host(x) -> np.ndarray:
    if isinstance(x, SH.ShardedTensor):
        x = SH.unshard(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(tree: Any, directory: str, step: int, async_: bool = False
         ) -> Optional[threading.Thread]:
    """Atomically write checkpoint ``step``. With async_=True the device->
    host copy happens synchronously (consistency) but file IO runs on a
    background thread; join the returned thread before exit."""
    host = {k: _host(v) for k, v in _flatten(tree)}
    struct = _structure(tree)

    def write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "|"): v for k, v in host.items()})
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump({"step": step, "structure": struct,
                       "keys": list(host)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore(directory: str, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Any:
    """Load checkpoint ``step`` (default: the latest). Leaves are numpy
    arrays, or tensors on ``device`` when one is given, or, with
    ``shardings`` (a tree of ``NamedSharding`` matching the saved
    structure), ``ShardedTensor``s laid out on them: each device gets its
    slice copied from the host, on any mesh shape (elastic restart)."""
    if device is not None and shardings is not None:
        raise ValueError("restore: give device or shardings, not both")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = {k.replace("|", "/"): z[k] for k in z.files}
    if device is not None:
        leaves = {k: torch.from_numpy(v).to(device)
                  for k, v in leaves.items()}
    tree = _unflatten(manifest["structure"], leaves)
    if shardings is not None:
        tree = tree_map2(lambda x, s: SH.shard(torch.from_numpy(x), s),
                         tree, shardings)
    return tree

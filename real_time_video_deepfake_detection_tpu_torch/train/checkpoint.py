"""Training checkpoints: the port's own single-file format, and the JAX
trainer's .npz read without JAX.

Port of real_time_video_deepfake_detection_tpu/train/checkpoint.py
(reference train.py:685-756: every epoch, model / optimizer / EMA state,
best metrics, a config snapshot and every RNG state, written to a temporary
file and renamed so that a kill at any point leaves a loadable file).

The port's format is `torch.save` of a plain dict of tensors, numbers,
strings, lists and dicts (the JAX package's .npz holds a pickled JAX
treedef, which the port cannot build), read back with
torch.load(weights_only=True): no object outside that closed set is ever
constructed, the analogue of the JAX package's closed unpickler.

The JAX trainer's .npz is read too: `leaf_i` arrays plus a pickled
`__meta__` blob, unpickled here with a closed unpickler that admits only
numpy's array and scalar reconstructors; the pickled treedef inside it is
left unopened. The leaves are named by the order in which jax.tree_util
flattens a dict tree (keys sorted, lists in order), over the port module's
state-dict names, which follow the JAX tree (utils/convert.params_from_jax).
A params-only file (best_model.npz, a clip head) maps directly; a resume
TrainState (params, opt_state, ema_params, step, rng) yields its
ema_params, the n_params leaves before the last two.

The sharded-state backend (JAX save_checkpoint_orbax / load_checkpoint_orbax)
writes a state dict with torch.distributed.checkpoint (DCP), each rank of a
process group writing its part, into a directory swapped into place as
JAX's is. The port does not read JAX's orbax directories.
"""

from __future__ import annotations

import io
import os
import pickle
import random
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.convert import params_from_jax

FORMAT = "rtvdd-torch-checkpoint-1"


def save_checkpoint(path: str, payload: dict) -> None:
    """Atomically write `payload` (+ the format tag) to `path`."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({"format": FORMAT, **payload}, f)
        os.replace(tmp, path)   # atomic (train.py:711-715)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> dict:
    """The dict save_checkpoint wrote, on the CPU; anything else raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of the port's trainer")
    return ckpt


def host_rng_state() -> dict:
    """Python's, numpy's legacy, torch's CPU and (when present) CUDA RNG
    states, as weights_only-loadable values."""
    np_state = np.random.get_state(legacy=False)
    out = {"python": random.getstate(),
           "numpy": {**np_state, "state": {"key": np_state["state"]["key"].tolist(),
                                           "pos": int(np_state["state"]["pos"])}},
           "torch": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out["cuda"] = torch.cuda.get_rng_state_all()
    return out


def restore_host_rng_state(s: dict) -> None:
    v, internal, gauss = s["python"]
    random.setstate((v, tuple(internal), gauss))
    st = dict(s["numpy"])
    st["state"] = {"key": np.asarray(st["state"]["key"], np.uint32),
                   "pos": st["state"]["pos"]}
    np.random.set_state(st)
    torch.set_rng_state(s["torch"])
    if "cuda" in s and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(s["cuda"])


# ------------------------------------------------------- the JAX trainer's .npz

_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS or (
                module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint metadata references {module}.{name}, outside numpy's array "
            "reconstructors: refusing to deserialize it")


def read_jax_npz(path: str) -> Tuple[List[np.ndarray], dict]:
    """(leaves in flattening order, the outer metadata dict: 'metadata',
    'n_leaves', the RNG captures; 'treedef' stays pickled bytes)."""
    with np.load(path, allow_pickle=False) as z:
        meta = _NumpyOnlyUnpickler(io.BytesIO(z["__meta__"].tobytes())).load()
        leaves = [np.asarray(z[f"leaf_{i}"]) for i in range(int(meta["n_leaves"]))]
    return leaves, meta


def jax_leaf_order(names) -> List[str]:
    """State-dict names in jax.tree_util's flattening order of the tree
    they name: dict keys sorted as strings, list indices in order."""
    return sorted(names, key=lambda n: tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                                             for p in n.split(".")))


def params_from_jax_npz(path: str, model: nn.Module, part: str = "ema_params"
                        ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(`model`'s state dict, metadata) from a JAX trainer .npz: a params
    tree saved alone, or from a resume TrainState its `part` ("ema_params",
    what serving uses, or "params", what --warm-start uses). Leaves that
    do not map onto the model raise."""
    leaves, meta = read_jax_npz(path)
    names = jax_leaf_order(model.state_dict().keys())
    n = len(names)
    if len(leaves) == n:
        chosen = leaves
    elif len(leaves) > 2 * n + 2:
        # TrainState leaves: params, opt_state, ema_params, step, rng
        ema = leaves[-(n + 2):-2]
        for i, (a, b) in enumerate(zip(leaves[:n], ema)):
            if a.shape != b.shape:
                raise ValueError(f"{path}: leaf {i} of params {a.shape} and of "
                                 f"ema_params {b.shape} differ; not a TrainState of this model")
        chosen = ema if part == "ema_params" else leaves[:n]
    else:
        raise ValueError(f"{path}: {len(leaves)} leaves, the model has {n} "
                         "(neither its params nor a TrainState of them)")
    sd = params_from_jax(dict(zip(names, chosen)), model)
    md = meta.get("metadata")
    return sd, (md if isinstance(md, dict) else {})


# ----------------------------------------------------- the sharded-state backend
#
# JAX's orbax backend (train/checkpoint.py:120-193) writes a sharded train
# state with its shardings and restores it onto the live mesh. Its
# counterpart writes the state dict with DCP: in a process group every rank
# calls save and writes the tensors the planner gives it (a tensor the
# ranks replicate is written once); the metadata dict and a generator
# state go beside it in meta.pt, a torch.save file that
# torch.load(weights_only=True) reads.

_DCP_STATE, _DCP_META = "state", "meta.pt"


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _rank0() -> bool:
    import torch.distributed as dist
    return not _in_group() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if _in_group():
        dist.barrier()


def _complete(d: str) -> bool:
    return (os.path.exists(os.path.join(d, _DCP_STATE, ".metadata"))
            and os.path.exists(os.path.join(d, _DCP_META)))


def template_like(state: Dict[str, Any]) -> Dict[str, Any]:
    """A load template of `state`'s structure (the counterpart of JAX's
    abstract state of ShapeDtypeStructs): every tensor replaced by an empty
    one of its shape, dtype and device, every other value kept."""
    if isinstance(state, dict):
        return {k: template_like(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(template_like(v) for v in state)
    return torch.empty_like(state) if isinstance(state, torch.Tensor) else state


def save_checkpoint_dcp(path: str, state: Dict[str, Any], metadata: Dict[str, Any],
                        rng_state: Any = None) -> None:
    """Write `state` (a state dict: nested dicts of tensors on any device,
    numbers, strings) into the directory `path` with
    torch.distributed.checkpoint, and `metadata` and `rng_state` (a
    generator's state, or None) beside it; the counterpart of JAX's
    save_checkpoint_orbax. In a process group every rank calls it with its
    own state. Crash safety as JAX's: the checkpoint is written into
    path.tmp, and only a complete one is swapped into place (path moved to
    path.old, path.tmp to path, path.old removed), so a kill at any point
    leaves the previous checkpoint or the new one."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if _rank0():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    _barrier()
    dcp.save(state, checkpoint_id=os.path.join(tmp, _DCP_STATE), no_dist=not _in_group())
    if _rank0():
        torch.save({"format": FORMAT, "metadata": metadata, "rng": rng_state},
                   os.path.join(tmp, _DCP_META))
        if os.path.exists(path):
            old = path + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(path, old)
            # a kill between the two renames leaves path.old and a complete
            # path.tmp; load_checkpoint_dcp finishes the swap
            os.rename(tmp, path)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)
    _barrier()


def _recover(path: str) -> None:
    """Finish a swap that a kill interrupted (JAX load_checkpoint_orbax):
    with path gone, a complete path.tmp (the new checkpoint) is preferred,
    else path.old (the previous one) is rolled back."""
    if os.path.exists(path) or not _rank0():
        return
    for cand in (path + ".tmp", path + ".old"):
        if _complete(cand):
            os.rename(cand, path)
            return


def load_checkpoint_dcp(path: str, template: Optional[Dict[str, Any]] = None
                        ) -> Tuple[Dict[str, Any], Dict[str, Any], Any]:
    """(state, metadata, rng_state) from a directory that
    save_checkpoint_dcp wrote; the counterpart of JAX's
    load_checkpoint_orbax. `template` is the abstract_state counterpart: a
    state dict of the saved structure whose tensors are restored in place,
    on their devices (in a process group every rank passes its own), and
    which is returned. Without one the saved state comes back with its
    tensors on the CPU. An interrupted swap is recovered first."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    _recover(path)
    _barrier()
    meta = torch.load(os.path.join(path, _DCP_META), map_location="cpu", weights_only=True)
    if not isinstance(meta, dict) or meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of the port's trainer")
    sd = os.path.join(path, _DCP_STATE)
    if template is not None:
        dcp.load(template, checkpoint_id=sd, no_dist=not _in_group())
        return template, meta["metadata"], meta["rng"]
    # what torch.distributed.checkpoint.format_utils.dcp_to_torch_save reads
    from torch.distributed.checkpoint.default_planner import _EmptyStateDictLoadPlanner
    from torch.distributed.checkpoint.state_dict_loader import _load_state_dict
    state: Dict[str, Any] = {}
    _load_state_dict(state, storage_reader=dcp.FileSystemReader(sd),
                     planner=_EmptyStateDictLoadPlanner(), no_dist=True)
    return state, meta["metadata"], meta["rng"]

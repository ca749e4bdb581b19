"""Device mesh and process-group helpers.

Port of real_time_video_deepfake_detection_tpu/parallel/mesh.py (JAX
:18-49). JAX places one array over a ("data",) mesh and lets XLA split the
work; here the two uses are explicit:

- Serving: a `Mesh` is an ordered list of devices on one "data" axis. The
  sharded ticks (serving/batcher.make_sharded_device_step*) split the
  stream axis into equal contiguous shards, one per entry, run each shard
  on its entry's device with the model replica bound there, and leave
  outputs and states on their shards until `gather`. Entries may repeat a
  device: [cuda:0, cuda:0] runs the sharded code on one card.
- Tensor parallelism: a `GridMesh` is a ("data", "model") grid of
  devices, dp x tp (JAX make_mesh(n, ("data", "model"))). Row i holds data
  shard i, entry (i, j) model shard j of the weights
  (parallel/tensor_parallel.py); entries may repeat a device here too.
- Training: one process per rank of a torch.distributed group (gloo on the
  CPU, nccl on CUDA), each holding the whole model and its shard of the
  global batch (train/steps.make_sharded_train_step). `spawn` starts the
  ranks over a file:// store; `init_process_group` also joins a group that
  torchrun started.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import itertools
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..state.tree import tree_map

DeviceLike = Union[str, torch.device]


def _device(d: DeviceLike) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices on one "data" axis: shard i of a sharded
    tensor lives on devices[i]. A device may appear more than once."""
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_device(d) for d in self.devices))

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices in first-seen order, each once."""
        return tuple(dict.fromkeys(self.devices))


def as_mesh(mesh: Union[Mesh, Sequence[DeviceLike]]) -> Mesh:
    """A Mesh, or one built from an explicit device list (as the JAX
    dryrun builds a mesh by hand)."""
    return mesh if isinstance(mesh, Mesh) else Mesh(tuple(mesh))


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[DeviceLike] = None,
              axis_names: Sequence[str] = ("data",)) -> Union[Mesh, "GridMesh"]:
    """The first n devices (JAX make_mesh). On CUDA (`device` None or a
    CUDA device): cuda:0..n-1, every visible card when n is None. On the
    CPU (device="cpu"): n entries of cpu, 1 when n is None, the
    counterpart of the JAX tests' 8-device virtual CPU mesh. With
    axis_names ("data", "model") the devices form an (n, 1) GridMesh, as
    JAX's default 2-D shape."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        mesh = Mesh((dev,) * (n_devices or 1))
    else:
        visible = torch.cuda.device_count()
        n = n_devices or visible
        if n > visible:
            raise ValueError(f"a mesh of {n} devices needs {n} cards; {visible} are visible")
        mesh = Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    if tuple(axis_names) == ("data",):
        return mesh
    if tuple(axis_names) != ("data", "model"):
        raise ValueError(f"axis_names must be ('data',) or ('data', 'model'), not {axis_names}")
    return grid_mesh(mesh.devices, (len(mesh), 1))


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A ("data", "model") grid of devices: rows[i][j] holds model shard j
    of data shard i. A device may appear more than once."""
    rows: Tuple[Tuple[torch.device, ...], ...]

    def __post_init__(self):
        if not self.rows or not self.rows[0] or len({len(r) for r in self.rows}) != 1:
            raise ValueError("a grid mesh needs equal, non-empty rows")
        object.__setattr__(self, "rows",
                           tuple(tuple(_device(d) for d in r) for r in self.rows))

    @property
    def shape(self) -> Tuple[int, int]:
        """(dp, tp)."""
        return len(self.rows), len(self.rows[0])

    @property
    def data(self) -> Mesh:
        """The "data" axis: row i's first entry, where its inputs and
        outputs live."""
        return Mesh(tuple(r[0] for r in self.rows))


def grid_mesh(devices: Sequence[DeviceLike], shape: Tuple[int, int]) -> GridMesh:
    """dp x tp devices in row-major order as a grid (JAX
    Mesh(np.array(devs).reshape(dp, tp), ("data", "model")))."""
    dp, tp = shape
    if len(devices) != dp * tp:
        raise ValueError(f"a {dp}x{tp} mesh needs {dp * tp} devices, not {len(devices)}")
    return GridMesh(tuple(tuple(devices[i * tp:(i + 1) * tp]) for i in range(dp)))


def _module_device(module) -> Optional[torch.device]:
    t = next(itertools.chain(module.parameters(), module.buffers()), None)
    return None if t is None else t.device


def _replica(module, device: torch.device):
    if module is None:
        return None
    if isinstance(module, dict):
        return {k: _replica(v, device) for k, v in module.items()}
    if _module_device(module) == device:
        return module
    return copy.deepcopy(module).to(device)


def replicated(mesh: Mesh, module) -> Dict[torch.device, object]:
    """One copy of `module` per distinct device of the mesh, {device:
    copy}: an nn.Module or a dict of them (the clip tick's {"backbone",
    "clip_head"}, MTCNN's nets), None passes through. A module already on
    a device serves that device itself; the others are deep copies."""
    return {d: _replica(module, d) for d in mesh.distinct}


def shard_batch(mesh: Mesh, x) -> list:
    """Split the leading (stream or batch) axis of `x` into len(mesh) equal
    contiguous shards, shard i moved to mesh.devices[i]. `x` is a tensor or
    a tree of state dataclasses (StreamStates), every leaf split alike.
    Raises when a leading axis does not divide by the mesh size, as JAX's
    sharding does."""
    k = len(mesh)

    def part(t: torch.Tensor, i: int) -> torch.Tensor:
        n = t.shape[0]
        if n % k:
            raise ValueError(f"a leading axis of {n} does not divide over a mesh of {k}")
        b = n // k
        return t[i * b:(i + 1) * b].to(mesh.devices[i])

    return [tree_map(lambda t, i=i: part(t, i), x) for i in range(k)]


def gather(shards: Sequence, device: Optional[DeviceLike] = None):
    """Concatenate the shards of a tensor, a dict of tensors (a tick's
    outputs) or a state tree along the leading axis, on `device` (the
    first shard's when None)."""
    first = shards[0]
    if isinstance(first, dict):
        return {k: gather([s[k] for s in shards], device) for k in first}
    return tree_map(lambda *ts: torch.cat([t.to(device or ts[0].device) for t in ts]),
                    *shards)


# ------------------------------------------------------------ process group

def world_size() -> int:
    """Ranks of the training group; 1 outside one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the training group; 0 outside one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def torchrun_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) from torchrun's environment, or None
    when the process was not started by torchrun (or alone)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or "RANK" not in os.environ:
        return None
    r = int(os.environ["RANK"])
    return r, int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", r))


def init_process_group(rank_: int, world: int, init_method: str = "env://",
                       device: Optional[DeviceLike] = None, backend: Optional[str] = None,
                       timeout: Optional[float] = None) -> torch.device:
    """Join the training group as rank `rank_` of `world` and return the
    rank's device. `device`: None or "cuda" means cuda:rank_ (made the
    current device), "cpu" the CPU, an indexed device itself. The backend
    is nccl on CUDA and gloo on the CPU unless `backend` names one (gloo
    lets several ranks share one card, which nccl refuses).
    `init_method`: "env://" (torchrun's MASTER_ADDR / MASTER_PORT) or
    "file://<path>", a store file no other group uses."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank_)
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, rank=rank_, world_size=world, **kw)
    return dev


def _rank_entry(fn, rank_, devices, init_method, backend, timeout, num_threads, q, args):
    try:
        if num_threads is not None:
            torch.set_num_threads(num_threads)
        dev = init_process_group(rank_, len(devices), init_method, devices[rank_], backend,
                                 timeout)
        try:
            # by value: a shared-memory tensor would die with this process
            q.put((rank_, True, pickle.dumps(fn(dev, *args))))
        finally:
            dist.destroy_process_group()
    except Exception:   # reported to the parent, which fails the run
        q.put((rank_, False, traceback.format_exc()))


def spawn(fn: Callable, devices: Sequence[DeviceLike], args: tuple = (),
          backend: Optional[str] = None, store_dir: Optional[str] = None,
          timeout: Optional[float] = None, num_threads: Optional[int] = None) -> list:
    """Run fn(device, *args) in one spawned process per entry of `devices`
    (rank i on devices[i]) inside one process group whose file:// store
    lies in a fresh directory under `store_dir` (the temporary directory
    when None); returns the ranks' results in rank order. A rank that
    raises or dies, or a run past `timeout` seconds (also each collective's
    limit), terminates every rank and raises: nothing carries on in fewer
    processes. `num_threads` sets each rank's torch threads. `fn` is a
    module-level function; `args` and the results are pickled."""
    world = len(devices)
    root = tempfile.mkdtemp(prefix="pg_store_", dir=store_dir)
    init_method = "file://" + os.path.join(root, "store")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, [str(d) for d in devices], init_method, backend,
                               timeout, num_threads, q, args))
             for r in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            try:
                # a rank that died may have reported first: wait a second for it
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in results]
                r, ok, payload = q.get(timeout=1.0 if dead else 0.2)
            except queue.Empty:
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}") from None
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(results)} of {world} ranks did not "
                                       f"finish within {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{payload}")
            results[r] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join(5)
        shutil.rmtree(root, ignore_errors=True)
    return [results[r] for r in range(world)]


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the ranks (x itself outside a group)."""
    w = world_size()
    if w == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / w


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' `x` (equal shapes) stacked along the leading axis in rank
    order: the global batch from its shards (x itself outside a group). An
    all-reduce of zero-padded copies, since gloo on CUDA has no
    all-gather; adding zeros leaves every value as it was."""
    w = world_size()
    if w == 1:
        return x
    b = x.shape[0]
    out = torch.zeros((w * b,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    r = rank()
    out[r * b:(r + 1) * b] = x
    dist.all_reduce(out)
    return out

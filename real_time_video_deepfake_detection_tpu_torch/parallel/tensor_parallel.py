"""Tensor-parallel ViT forward over a ("data", "model") grid.

Port of the JAX package's tensor parallelism (models/vit.py:141-165
vit_partition_specs with a jit over a 2-D mesh; the dry run's section 2).
JAX lets XLA place the sharded leaves and insert the collectives; here the
placement and the data movement are explicit, in one process, the way
serving/batcher.make_sharded_device_step binds its replicas:

- the batch is split over the "data" axis (parallel/mesh.shard_batch on
  `mesh.data`); row i's inputs, replicated layers and outputs live on its
  first entry;
- entry (i, j) holds model shard j of the weights on its device
  (models/vit.shard_state_dict): qkv by heads, mlp1 by hidden columns,
  mlp2 by hidden rows; the replicated leaves are bound once per device;
- per block, the per-head attention outputs are gathered across "model"
  (copied to the row's device and concatenated in shard order) before the
  replicated proj, and the mlp2 partial products are summed across "model"
  in shard order, then mlp2's bias is added once. Copies and adds only, no
  collective library.

Entries may repeat a device, so a 2x2 grid of one card runs the sharded
code on that card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..models.vit import ViT, ViTSpec, attend, shard_state_dict, vit_partition_specs
from .mesh import GridMesh, shard_batch


def _bind(state: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in state.items()}


def _row_forward(spec: ViTSpec, rep: Dict[str, torch.Tensor],
                 shards: Sequence[Tuple[torch.device, Dict[str, torch.Tensor]]],
                 x: torch.Tensor) -> torch.Tensor:
    """One data shard: x (b, H, W, 3) on the row's device -> (b, 1)."""
    d0 = x.device
    tp = len(shards)
    heads, hd, eps = spec.heads // tp, spec.dim // spec.heads, spec.ln_eps
    b, hgt, wid, _ = x.shape
    p = spec.patch
    patches = x.reshape(b, hgt // p, p, wid // p, p, 3)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, p * p * 3)
    tok = patches @ rep["patch.w"] + rep["patch.b"]
    if spec.use_cls:
        tok = torch.cat([rep["cls"].expand(b, 1, -1), tok], dim=1)
    tok = tok + rep["pos"]

    def ln(t, name):
        return F.layer_norm(t, t.shape[-1:], rep[name + ".scale"], rep[name + ".bias"], eps)

    for i in range(spec.depth):
        pre = f"blocks.{i}."
        h = ln(tok, pre + "ln1")
        outs = [attend(h.to(dj) @ s[pre + "qkv.w"] + s[pre + "qkv.b"], heads, hd).to(d0)
                for dj, s in shards]
        tok = tok + (torch.cat(outs, dim=-1) @ rep[pre + "proj.w"] + rep[pre + "proj.b"])
        h = ln(tok, pre + "ln2")
        acc = None
        for dj, s in shards:
            part = (F.gelu(h.to(dj) @ s[pre + "mlp1.w"] + s[pre + "mlp1.b"])
                    @ s[pre + "mlp2.w"]).to(d0)
            acc = part if acc is None else acc + part
        tok = tok + (acc + rep[pre + "mlp2.b"])
    tok = ln(tok, "final_ln")
    feats = tok[:, 0] if spec.use_cls else tok.mean(dim=1)
    return feats @ rep["head.w"] + rep["head.b"]


def make_tp_forward(mesh: GridMesh, model: ViT) -> Callable:
    """The ViT's inference forward sharded over `mesh` (dp x tp):

      forward(x) -> [(b_i, 1) logits of data shard i on mesh.data.devices[i]]

    `x` is a whole (B, H, W, 3) batch, split here (B must divide by dp),
    or the list of its shards. mesh.gather joins the outputs. The weights
    are cut and bound when the forward is built; raises when heads or the
    MLP width does not divide by tp."""
    spec = model.spec
    dp, tp = mesh.shape
    state = {k: v.detach() for k, v in model.state_dict().items()}
    specs = vit_partition_specs(spec)
    cut = [shard_state_dict(spec, state, tp, j) for j in range(tp)]
    replicated = {k: v for k, v in state.items() if "model" not in specs[k]}
    sharded = [{k: v for k, v in c.items() if "model" in specs[k]} for c in cut]
    reps: Dict[torch.device, Dict[str, torch.Tensor]] = {}
    parts: Dict[Tuple[torch.device, int], Dict[str, torch.Tensor]] = {}
    for row in mesh.rows:
        if row[0] not in reps:
            reps[row[0]] = _bind(replicated, row[0])
        for j, d in enumerate(row):
            if (d, j) not in parts:
                parts[(d, j)] = _bind(sharded[j], d)
    rows = [(row[0], [(d, parts[(d, j)]) for j, d in enumerate(row)]) for row in mesh.rows]

    @torch.no_grad()
    def forward(x: Union[torch.Tensor, List[torch.Tensor]]) -> List[torch.Tensor]:
        xs = x if isinstance(x, (list, tuple)) else shard_batch(mesh.data, x)
        if len(xs) != dp:
            raise ValueError(f"{len(xs)} data shards for a mesh of {dp} rows")
        return [_row_forward(spec, reps[d0], shards, xi.to(d0))
                for xi, (d0, shards) in zip(xs, rows)]

    return forward

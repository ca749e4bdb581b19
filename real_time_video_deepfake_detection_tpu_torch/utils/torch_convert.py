"""The reference's PyTorch EfficientNet checkpoints -> the port's state dict.

Port of real_time_video_deepfake_detection_tpu/utils/torch_convert.py, the
parts the trainer and `--weights` use. There the keys map onto a JAX
parameter tree; here they map straight onto models/efficientnet.
EfficientNet's state dict: convolutions keep torch's (out, in, kh, kw)
layout, linear weights go to the port's (in, out), batch norms' weight /
bias / running_mean / running_var become scale / bias / mean / var.

Schemas:
  reference       `net._conv_stem.*`, `net._blocks.{i}.*` and the custom
                  head `net._fc.{1,2,5,6,9}.*` (reference best_model.pth:
                  deepfake_detection.py:44-70, model.py:48-61)
  effnet_pytorch  efficientnet_pytorch's ImageNet release file (bare
                  `_conv_stem.*`, one Linear `_fc`)
  timm            timm's `efficientnet_{variant}` (conv_stem.*,
                  blocks.{stage}.{j}.*, classifier.*)

Files are read with torch.load(weights_only=True) and a closed numpy
allowlist (the reference's resume files embed numpy's RNG state), never a
full unpickle: checkpoint paths are operator-supplied.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.efficientnet import _B0_BLOCKS, _SCALING, EfficientNet, EfficientNetSpec, round_repeats

_BN = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var"))
# the reference head's Linear / BatchNorm1d indices in net._fc
_HEAD = (("fc1", "1"), ("bn1", "2"), ("fc2", "5"), ("bn2", "6"), ("fc3", "9"))


def _numpy_safe_globals():
    """The closed set of non-default globals a reference checkpoint needs:
    numpy's array and scalar reconstructors (np.random.get_state() embeds
    an ndarray, reference train.py:699)."""
    import numpy.dtypes as ndt
    allow = [np.ndarray, np.dtype]
    allow += [getattr(ndt, n) for n in dir(ndt) if n.endswith("DType")]
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        try:   # numpy 1.x and 2.x module paths
            m = __import__(mod, fromlist=["_reconstruct", "scalar"])
            allow += [m._reconstruct, m.scalar]
        except (ImportError, AttributeError):
            pass
    return allow


def load_torch_state_dict(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(tensor dict, the whole checkpoint dict for its metadata) from a
    torch file; a `model_state_dict` / `state_dict` wrapper is unwrapped
    and non-tensor entries dropped."""
    with torch.serialization.safe_globals(_numpy_safe_globals()):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt
    if isinstance(ckpt, dict):
        for wrap in ("model_state_dict", "state_dict"):
            if isinstance(ckpt.get(wrap), dict):
                state = ckpt[wrap]
                break
    tensors = {k: v.detach() for k, v in state.items() if isinstance(v, torch.Tensor)}
    if not tensors:
        raise ValueError(f"{path}: checkpoint contains no tensors (keys: {sorted(state)[:5]}); "
                         "expected a state dict or one wrapped in "
                         "'model_state_dict'/'state_dict'")
    return tensors, (ckpt if isinstance(ckpt, dict) else {})


def _bn_keys(port: str, ref: str) -> Iterator[Tuple[str, str]]:
    for a, b in _BN:
        yield f"{port}.{b}", f"{ref}.{a}"


def backbone_key_map(spec: EfficientNetSpec, prefix: str = "net.") -> Dict[str, str]:
    """Port state-dict key -> reference key of the backbone (stem, blocks,
    head conv), with `prefix` before every reference key."""
    m = {"stem.conv": "_conv_stem.weight", **dict(_bn_keys("stem.bn", "_bn0"))}
    for i, b in enumerate(spec.blocks):
        p, q = f"blocks.{i}", f"_blocks.{i}"
        if b.expand != 1:
            m[f"{p}.expand_conv"] = f"{q}._expand_conv.weight"
            m.update(_bn_keys(f"{p}.bn0", f"{q}._bn0"))
        m[f"{p}.depthwise"] = f"{q}._depthwise_conv.weight"
        m.update(_bn_keys(f"{p}.bn1", f"{q}._bn1"))
        for se in ("se_reduce", "se_expand"):
            m[f"{p}.{se}.w"] = f"{q}._{se}.weight"
            m[f"{p}.{se}.b"] = f"{q}._{se}.bias"
        m[f"{p}.project"] = f"{q}._project_conv.weight"
        m.update(_bn_keys(f"{p}.bn2", f"{q}._bn2"))
    m["head.conv"] = "_conv_head.weight"
    m.update(_bn_keys("head.bn", "_bn1"))
    return {k: prefix + v for k, v in m.items()}


def head_key_map() -> Dict[str, str]:
    """Port key -> reference key of the custom head (linear weights are
    transposed on the way)."""
    m = {}
    for port, idx in _HEAD:
        if port.startswith("fc"):
            m[f"fc.{port}.w"] = f"net._fc.{idx}.weight"
            m[f"fc.{port}.b"] = f"net._fc.{idx}.bias"
        else:
            m.update(_bn_keys(f"fc.{port}", f"net._fc.{idx}"))
    return m


def _take(sd: Mapping[str, torch.Tensor], key_map: Dict[str, str]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, ref in key_map.items():
        v = torch.as_tensor(sd[ref]).to(torch.float32)
        out[k] = (v.t() if k.startswith("fc.fc") and k.endswith(".w") else v).contiguous().clone()
    return out


def convert_state_dict(sd: Mapping[str, torch.Tensor], spec: EfficientNetSpec
                       ) -> Dict[str, torch.Tensor]:
    """Reference-schema state dict -> the port's EfficientNet state dict."""
    return _take(sd, {**backbone_key_map(spec), **head_key_map()})


def _stage_indices(spec: EfficientNetSpec):
    """Flat block index -> (stage, index in stage), timm's nesting."""
    depth = _SCALING[spec.variant][1]
    out = [(s, j) for s, (r, *_rest) in enumerate(_B0_BLOCKS)
           for j in range(round_repeats(r, depth))]
    assert len(out) == len(spec.blocks)
    return out


def detect_state_dict_schema(sd: Mapping[str, object]) -> str:
    """'reference', 'effnet_pytorch' or 'timm'."""
    if "net._conv_stem.weight" in sd:
        return "reference"
    if "_conv_stem.weight" in sd:
        return "effnet_pytorch"
    if "conv_stem.weight" in sd:
        return "timm"
    raise ValueError("unrecognized EfficientNet state-dict schema; expected reference "
                     "(net._*), efficientnet_pytorch (_conv_stem.*) or timm (conv_stem.*) "
                     f"keys, got e.g. {sorted(sd)[:3]}")


def _timm_key_map(spec: EfficientNetSpec) -> Dict[str, str]:
    """efficientnet_pytorch backbone key -> timm key."""
    out = {"_conv_stem.weight": "conv_stem.weight"}
    bnmap = ("weight", "bias", "running_mean", "running_var")
    out.update({f"_bn0.{a}": f"bn1.{a}" for a in bnmap})
    for i, ((s, j), b) in enumerate(zip(_stage_indices(spec), spec.blocks)):
        t, p = f"blocks.{s}.{j}", f"_blocks.{i}"
        # timm DepthwiseSeparableConv (expand 1): conv_dw/bn1, se, conv_pw/bn2;
        # InvertedResidual: conv_pw/bn1, conv_dw/bn2, se, conv_pwl/bn3
        names = ((("_depthwise_conv", "conv_dw"), ("_project_conv", "conv_pw")),
                 (("_bn1", "bn1"), ("_bn2", "bn2"))) if b.expand == 1 else \
            ((("_expand_conv", "conv_pw"), ("_depthwise_conv", "conv_dw"),
              ("_project_conv", "conv_pwl")), (("_bn0", "bn1"), ("_bn1", "bn2"), ("_bn2", "bn3")))
        for ours, theirs in names[0]:
            out[f"{p}.{ours}.weight"] = f"{t}.{theirs}.weight"
        for ours, theirs in names[1]:
            out.update({f"{p}.{ours}.{a}": f"{t}.{theirs}.{a}" for a in bnmap})
        for ours, theirs in (("_se_reduce", "conv_reduce"), ("_se_expand", "conv_expand")):
            out[f"{p}.{ours}.weight"] = f"{t}.se.{theirs}.weight"
            out[f"{p}.{ours}.bias"] = f"{t}.se.{theirs}.bias"
    out["_conv_head.weight"] = "conv_head.weight"
    out.update({f"_bn1.{a}": f"bn2.{a}" for a in bnmap})
    return out


def convert_imagenet_state_dict(sd: Mapping[str, torch.Tensor], spec: EfficientNetSpec,
                                generator: Optional[torch.Generator] = None
                                ) -> Dict[str, torch.Tensor]:
    """ImageNet EfficientNet state dict (efficientnet_pytorch or timm) ->
    the port's state dict with the pretrained backbone and a fresh
    head_filters->512->256->1 head drawn from `generator` (the reference's
    model constructor, model.py:40-61, on every run including --fresh). A
    reference-schema dict converts whole."""
    schema = detect_state_dict_schema(sd)
    if schema == "reference":
        return convert_state_dict(sd, spec)
    bare = backbone_key_map(spec, prefix="")
    if schema == "timm":
        tk = _timm_key_map(spec)
        bare = {k: tk[v] for k, v in bare.items()}
    out = _take(sd, bare)
    head = EfficientNet(spec, generator=generator).state_dict()
    out.update({k: v for k, v in head.items() if k.startswith("fc.")})
    return out


def load_imagenet_checkpoint(path: str, spec: Optional[EfficientNetSpec] = None,
                             generator: Optional[torch.Generator] = None):
    """An ImageNet .pth (either schema, or a wrapped checkpoint) -> the
    port's state dict, backbone pretrained, head fresh."""
    sd, _ = load_torch_state_dict(path)
    return convert_imagenet_state_dict(sd, spec or EfficientNetSpec.make("b0"), generator)


def load_checkpoint(path: str, spec: Optional[EfficientNetSpec] = None):
    """The reference checkpoint -> (state dict, metadata with 'epoch',
    'val_acc', 'config' where present, deepfake_detection.py:64-70)."""
    sd, ckpt = load_torch_state_dict(path)
    meta = {k: ckpt[k] for k in ("epoch", "val_acc", "config") if k in ckpt}
    return convert_state_dict(sd, spec or EfficientNetSpec.make("b0")), meta


def export_state_dict(state: Mapping[str, torch.Tensor], spec: EfficientNetSpec
                      ) -> Dict[str, np.ndarray]:
    """The port's EfficientNet state dict -> reference-schema numpy dict."""
    out = {}
    for k, ref in {**backbone_key_map(spec), **head_key_map()}.items():
        v = state[k].detach().cpu()
        out[ref] = (v.t() if k.startswith("fc.fc") and k.endswith(".w") else v).contiguous().numpy()
    return out


def make_reference_shaped_state_dict(spec: EfficientNetSpec, seed: int = 0) -> Dict[str, np.ndarray]:
    """A random state dict with the reference checkpoint's exact keys and
    shapes (the real best_model.pth is not in the repository)."""
    model = EfficientNet(spec, generator=torch.Generator().manual_seed(seed))
    return export_state_dict(model.state_dict(), spec)


def make_imagenet_shaped_state_dict(spec: EfficientNetSpec, seed: int = 0,
                                    schema: str = "effnet_pytorch") -> Dict[str, np.ndarray]:
    """A random state dict with the keys and shapes of efficientnet_pytorch's
    `efficientnet-{variant}-*.pth` or timm's `efficientnet_{variant}`
    (1000-class classifier included), for the --pretrained path."""
    rs = np.random.RandomState(seed)
    bare = {k[len("net."):]: v for k, v in make_reference_shaped_state_dict(spec, seed).items()
            if not k.startswith("net._fc.")}
    cls_w = rs.randn(1000, spec.head_filters).astype(np.float32)
    cls_b = rs.randn(1000).astype(np.float32)
    if schema == "effnet_pytorch":
        return {**bare, "_fc.weight": cls_w, "_fc.bias": cls_b}
    if schema != "timm":
        raise ValueError(f"unknown schema {schema!r}")
    tk = _timm_key_map(spec)
    return {**{tk[k]: v for k, v in bare.items()},
            "classifier.weight": cls_w, "classifier.bias": cls_b}

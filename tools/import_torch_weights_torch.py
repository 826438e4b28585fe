#!/usr/bin/env python3
"""Import torchvision-format ResNet weights for the PyTorch/CUDA port: the
counterpart of tools/import_torch_weights.py, with its own copy of the
mapping onto the JAX package's flax backbone tree:

  torch OIHW conv kernels        -> flax HWIO       (transpose 2,3,1,0)
  torch bnX.{weight,bias}        -> flax BatchNorm {scale,bias}
  torch bnX.{running_mean,var}   -> flax batch_stats {mean,var}
  layer{i}.{j}.conv{k}           -> ResNet_/BottleneckBlock_{idx}/Conv_{k-1}
  layer{i}.{j}.downsample.{0,1}  -> conv_proj / norm_proj

Usage:
  python tools/import_torch_weights_torch.py --pth resnet50.pth --out params.msgpack
  (also importable: ``load_torch_resnet(state_dict, stage_sizes)`` gives the
  flax tree, ``load_into_resnet(model, state_dict)`` fills the port's
  models/resnet.ResNet)

The .pth may be a raw state_dict or a checkpoint dict holding one under
"state_dict"; DataParallel's "module." prefixes are dropped. The msgpack is
the JAX package's ``{"params", "batch_stats"}`` blob, byte for byte as
tools/import_torch_weights.py writes it (utils/checkpoint.msgpack_serialize),
so either package reads it. Torch-lineage weights expect ImageNet-normalised
inputs: run the DMM with ``--set model.input_norm=imagenet``.
"""

import argparse
import os
import sys
from typing import Dict, Mapping, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGE_SIZES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
               "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def _t(w: np.ndarray) -> np.ndarray:
    """torch conv OIHW -> flax HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def load_torch_resnet(state_dict: Mapping[str, np.ndarray],
                      stage_sizes=(3, 4, 6, 3),
                      bottleneck: bool = True) -> Tuple[Dict, Dict]:
    """A torchvision ResNet state_dict (numpy values) -> (params,
    batch_stats) trees in the layout of the JAX package's
    models/resnet.ResNet."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params: Dict = {"conv_init": {"kernel": _t(sd["conv1.weight"])},
                    "bn_init": {"scale": sd["bn1.weight"],
                                "bias": sd["bn1.bias"]}}
    stats: Dict = {"bn_init": {"mean": sd["bn1.running_mean"],
                               "var": sd["bn1.running_var"]}}
    block_cls = "BottleneckBlock" if bottleneck else "BasicBlock"
    n_convs = 3 if bottleneck else 2
    block_idx = 0
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for j in range(n_blocks):
            tp = f"layer{stage}.{j}"
            sub_p: Dict = {}
            sub_s: Dict = {}
            for k in range(n_convs):
                bn = f"{tp}.bn{k + 1}"
                sub_p[f"Conv_{k}"] = {"kernel": _t(sd[f"{tp}.conv{k + 1}.weight"])}
                sub_p[f"BatchNorm_{k}"] = {"scale": sd[f"{bn}.weight"],
                                           "bias": sd[f"{bn}.bias"]}
                sub_s[f"BatchNorm_{k}"] = {"mean": sd[f"{bn}.running_mean"],
                                           "var": sd[f"{bn}.running_var"]}
            if f"{tp}.downsample.0.weight" in sd:
                ds = f"{tp}.downsample.1"
                sub_p["conv_proj"] = {"kernel": _t(sd[f"{tp}.downsample.0.weight"])}
                sub_p["norm_proj"] = {"scale": sd[f"{ds}.weight"],
                                      "bias": sd[f"{ds}.bias"]}
                sub_s["norm_proj"] = {"mean": sd[f"{ds}.running_mean"],
                                      "var": sd[f"{ds}.running_var"]}
            params[f"{block_cls}_{block_idx}"] = sub_p
            stats[f"{block_cls}_{block_idx}"] = sub_s
            block_idx += 1
    return params, stats


def load_into_resnet(model, state_dict: Mapping[str, np.ndarray]) -> None:
    """Fill the port's ``models/resnet.ResNet`` from a torchvision state_dict
    through the weight bridge (strict: every key and shape)."""
    from dmm_net_tpu_torch.models.resnet import BottleneckBlock
    from dmm_net_tpu_torch.weights import load_flax_variables

    ends = [0] + list(model.stage_ends)
    stage_sizes = tuple(b - a for a, b in zip(ends, ends[1:]))
    bottleneck = isinstance(model.blocks[0], BottleneckBlock)
    params, stats = load_torch_resnet(state_dict, stage_sizes, bottleneck)
    load_flax_variables(model, {"params": params, "batch_stats": stats})


def read_pth(path: str) -> Dict[str, np.ndarray]:
    """A .pth state_dict (raw, or under "state_dict") as numpy arrays, with
    DataParallel's "module." prefixes dropped and non-tensor entries
    skipped."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k.replace("module.", ""): v.numpy() for k, v in ckpt.items()
            if isinstance(v, torch.Tensor)}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pth", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--arch", default="resnet50", choices=sorted(STAGE_SIZES))
    args = ap.parse_args(argv)

    from dmm_net_tpu_torch.utils.checkpoint import msgpack_serialize

    params, stats = load_torch_resnet(read_pth(args.pth),
                                      STAGE_SIZES[args.arch],
                                      args.arch in ("resnet50", "resnet101"))
    with open(args.out, "wb") as f:
        f.write(msgpack_serialize({"params": params, "batch_stats": stats}))
    n = sum(x.size for x in _leaves(params))
    print(f"wrote {args.out}: {n / 1e6:.1f} M params")


if __name__ == "__main__":
    main()

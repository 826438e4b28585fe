"""Single frozen-dataclass config tree with named presets.

A copy of the JAX package's config (same fields, defaults, presets,
``config_from_dict`` and ``_LEGACY_DEFAULTS``), kept here because the port
imports nothing of that package. Checkpoints embed a ``Config.to_dict()``;
both packages read the same dict.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class MatchingConfig:
    """Differentiable matching layer. Solves
        min <C, X>  s.t.  X >= 0, sum_j X[i,j] = 1, sum_i X[i,j] <= 1
    over padded (M_max, N_max) matrices with validity masks.
    `solver`: "sinkhorn" or "pgd" (projected gradient with Dykstra
    projections; unfused matcher only).
    `decode`: "soft", "argmax" or "hungarian" (one-to-one, on the host;
    ``InferenceEngine.run_sequence`` only).
    `use_pallas`: run pooling + cost + Sinkhorn as the fused kernel (the
    port's CUDA kernel, kernels/matcher.py)."""

    solver: str = "sinkhorn"
    # Sinkhorn
    epsilon: float = 0.05          # entropic temperature
    epsilon_init: float = 0.0      # >epsilon enables geometric eps-annealing
    sinkhorn_iters: int = 30
    implicit_grad: bool = False    # stop-grad duals, differentiate last recompute
    # PGD + Dykstra
    pgd_iters: int = 20
    pgd_step: float = 0.1
    dykstra_iters: int = 10
    # padding
    max_templates: int = 16        # M_max (pad rows)
    max_proposals: int = 128       # N_max (pad cols)
    use_pallas: bool = False       # fused pool + cost + Sinkhorn kernel
    decode: str = "soft"

    def __post_init__(self):
        if self.solver not in ("sinkhorn", "pgd"):
            raise ValueError(f"matching.solver={self.solver!r}: expected "
                             "'sinkhorn' or 'pgd'")
        if self.decode not in ("soft", "argmax", "hungarian"):
            raise ValueError(f"matching.decode={self.decode!r}: expected "
                             "'soft', 'argmax' or 'hungarian'")
        if self.solver == "pgd" and self.use_pallas:
            raise ValueError(
                "matching.solver='pgd' is incompatible with "
                "matching.use_pallas=True (the fused kernel is "
                "Sinkhorn-only); add matching.use_pallas=false to run the "
                "unrolled PGD+Dykstra path")


@dataclass(frozen=True)
class CostConfig:
    """Pairwise cost: c_ij = lam * (1 - IoU_ij) + (1 - lam) * (1 - cos_ij)."""

    iou_weight: float = 0.3        # lambda
    mask_size: Tuple[int, int] = (64, 64)  # masks downsampled for dense IoU
    feature_dim: int = 256


@dataclass(frozen=True)
class ModelConfig:
    backbone: str = "resnet50"
    backbone_dtype: str = "bfloat16"
    feature_dim: int = 256         # pooled mask-feature dim
    decoder_dim: int = 128
    decoder_dtype: str = "float32"
    # dtype masks travel in (proposal masks, template carry, aggregation)
    mask_dtype: str = "float32"
    # grid masks live on inside the frame step: "full" (H, W) or
    # "stride4" (H/4, W/4)
    mask_res: str = "full"
    # resolution of the per-object logits the frame step returns: "full"
    # (H, W) or "mask" (the decoder's mask grid; the engine then resolves
    # labels with the fused upsample + argmax kernel)
    logits_res: str = "full"
    decoder_fine_level: str = "c2"
    decoder_recurrent: bool = True  # ConvGRU state carried across frames
    # "shared" = SharedFPNDecoder; "legacy" = RefinementDecoder
    decoder_variant: str = "shared"
    decoder_obj_dim: int = 32      # per-object path width ("shared" variant)
    # per-object residual fuse conv: "conv3" | "conv1" | "none"
    decoder_obj_fuse: str = "conv1"
    # 0 = decoder_obj_dim, else the per-object width at the finest level
    decoder_obj_dim_fine: int = 0
    # merge-conv kernel at the finest per-object level
    decoder_obj_merge_fine_k: int = 3
    # "" = fine_level; "c3" stops the per-object loop at stride 8 and adds
    # the shared-basis dynamic-mix detail head
    decoder_obj_fine_level: str = "c3"
    decoder_detail_dim: int = 16
    decoder_detail_basis_k: int = 1
    # shared-path width at the finest level (0 = decoder_dim)
    decoder_dim_fine: int = 0
    # next-frame template masks: "decoder" (refined prediction) or
    # "aggregation" (matcher-aggregated proposals)
    template_update: str = "decoder"
    # frame-input distribution the backbone was trained on: "raw01" ([0,1]
    # RGB) or "imagenet" (ImageNet mean/std on top)
    input_norm: str = "raw01"
    image_size: Tuple[int, int] = (256, 448)  # H, W
    num_skip_levels: int = 4       # backbone taps C2..C5
    # train-mode BN during training; inference always uses running stats
    train_bn: bool = False


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"     # synthetic | davis | ytvos
    root: str = "/root/data"
    proposal_dir: str = ""
    clip_length: int = 4           # frames per training clip
    batch_size: int = 2            # clips per step (global)
    num_workers: int = 4
    prefetch_depth: int = 2
    augment: bool = True


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-5
    warmup_steps: int = 200
    total_steps: int = 20000
    grad_accum: int = 1
    loss_bce_weight: float = 1.0
    loss_iou_weight: float = 0.5   # soft-IoU auxiliary
    checkpoint_every: int = 500
    checkpoint_dir: str = "checkpoints"
    seed: int = 0
    remat: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    data_axis: int = 1
    model_axis: int = 1


@dataclass(frozen=True)
class Config:
    matching: MatchingConfig = field(default_factory=MatchingConfig)
    cost: CostConfig = field(default_factory=CostConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    name: str = "default"

    def override(self, **dotted: Any) -> "Config":
        """New Config with dot-path overrides applied, all overrides of one
        sub-config in a single ``dataclasses.replace`` (validation sees only
        the final state).

        >>> cfg.override(**{"matching.solver": "pgd", "train.lr": 3e-4})
        """
        nested: dict = {}
        for path, value in dotted.items():
            d = nested
            parts = path.split(".")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = value
        return _replace_nested(self, nested)

    def to_dict(self) -> dict:
        """Nested plain-python dict (tuples -> lists)."""
        def detuple(x):
            if isinstance(x, dict):
                return {k: detuple(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [detuple(v) for v in x]
            return x
        return detuple(dataclasses.asdict(self))


# Architecture-affecting fields added after checkpoints existed, with the
# value that reproduces the architecture of blobs saved before the field.
_LEGACY_DEFAULTS = {
    "decoder_obj_merge_fine_k": 3,
    "decoder_obj_fine_level": "",
    "decoder_detail_dim": 16,
    "decoder_detail_basis_k": 3,
}


def config_from_dict(d: dict) -> Config:
    """Inverse of Config.to_dict. Lists become tuples; fields missing from
    ``d`` take their ``_LEGACY_DEFAULTS`` entry when one exists."""
    def build(cls, node):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in node:
                if f.name in _LEGACY_DEFAULTS:
                    kwargs[f.name] = _LEGACY_DEFAULTS[f.name]
                continue
            v = node[f.name]
            if f.default_factory is not dataclasses.MISSING and \
                    dataclasses.is_dataclass(f.default_factory()):
                v = build(type(f.default_factory()), v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
        return cls(**kwargs)
    return build(Config, d)


def _replace_nested(node, changes: dict):
    kwargs = {}
    for key, value in changes.items():
        current = getattr(node, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            kwargs[key] = _replace_nested(current, value)
        else:
            kwargs[key] = value
    return dataclasses.replace(node, **kwargs)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def preset(name: str) -> Config:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(_PRESETS)}")
    return _PRESETS[name]()


def _p1_matcher_only() -> Config:
    return Config(
        name="p1_matcher_only",
        matching=MatchingConfig(solver="sinkhorn", max_templates=8, max_proposals=64),
        data=DataConfig(dataset="synthetic", batch_size=1, clip_length=2),
    )


def _p2_single_object() -> Config:
    return Config(
        name="p2_single_object",
        matching=MatchingConfig(max_templates=1, max_proposals=64,
                                use_pallas=True),
        model=ModelConfig(decoder_dtype="bfloat16", mask_dtype="bfloat16",
                          mask_res="stride4"),
        data=DataConfig(dataset="davis", batch_size=1),
    )


def _p3_multi_object() -> Config:
    # multi-object DAVIS val: variable counts, padded matrices, batched frames
    return Config(
        name="p3_multi_object",
        matching=MatchingConfig(max_templates=16, max_proposals=128,
                                use_pallas=True),
        model=ModelConfig(decoder_dtype="bfloat16", mask_dtype="bfloat16",
                          mask_res="stride4", logits_res="mask",
                          decoder_obj_dim_fine=16),
        data=DataConfig(dataset="davis", batch_size=4),
    )


def _p3_480p() -> Config:
    return Config(
        name="p3_480p",
        matching=MatchingConfig(max_templates=16, max_proposals=128,
                                use_pallas=True),
        model=ModelConfig(decoder_dtype="bfloat16", mask_dtype="bfloat16",
                          mask_res="stride4", logits_res="mask",
                          decoder_obj_dim_fine=16, image_size=(480, 864)),
        data=DataConfig(dataset="davis", batch_size=4),
    )


def _p4_ytvos_stream() -> Config:
    # YouTube-VOS val: longer sequences, more objects (M=32, N=256)
    return Config(
        name="p4_ytvos_stream",
        matching=MatchingConfig(max_templates=32, max_proposals=256,
                                use_pallas=True),
        model=ModelConfig(decoder_dtype="bfloat16", mask_dtype="bfloat16",
                          mask_res="stride4", logits_res="mask",
                          decoder_obj_dim_fine=16),
        data=DataConfig(dataset="ytvos", batch_size=1, clip_length=8, prefetch_depth=3),
    )


def _p5_train() -> Config:
    return Config(
        name="p5_train",
        matching=MatchingConfig(max_templates=8, max_proposals=64),
        data=DataConfig(dataset="davis", batch_size=4, clip_length=4),
    )


_PRESETS = {
    "p1_matcher_only": _p1_matcher_only,
    "p2_single_object": _p2_single_object,
    "p3_multi_object": _p3_multi_object,
    "p3_480p": _p3_480p,
    "p4_ytvos_stream": _p4_ytvos_stream,
    "p5_train": _p5_train,
}

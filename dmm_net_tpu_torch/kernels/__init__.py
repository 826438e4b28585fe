"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. Built at first use from ``csrc/`` (see ``_build``)."""

from dmm_net_tpu_torch.kernels._build import (build_all, launch_counts,
                                              reset_launch_counts)
from dmm_net_tpu_torch.kernels.matcher import (cost_match_plain,
                                               fused_cost_match,
                                               fused_pool_cost_match,
                                               pool_cost_match_plain)
from dmm_net_tpu_torch.kernels.resolve import (fused_resolve_upsample,
                                               resolve_upsample_plain)
from dmm_net_tpu_torch.kernels.roi_align import (multilevel_roi_align,
                                                 multilevel_roi_align_plain,
                                                 roi_align)

__all__ = ["build_all", "launch_counts", "reset_launch_counts",
           "fused_pool_cost_match", "pool_cost_match_plain",
           "fused_cost_match", "cost_match_plain",
           "fused_resolve_upsample", "resolve_upsample_plain", "roi_align",
           "multilevel_roi_align", "multilevel_roi_align_plain"]

"""The proposal detector (Mask R-CNN R-50-FPN, inference) and mask pasting."""

from dmm_net_tpu_torch.models.proposal.maskrcnn import MaskRCNN, paste_masks

__all__ = ["MaskRCNN", "paste_masks"]

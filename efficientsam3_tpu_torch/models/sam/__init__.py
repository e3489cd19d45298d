from efficientsam3_tpu_torch.models.sam.heads import (
    MaskDecoder,
    PromptEncoder,
    TwoWayTransformer,
)

__all__ = ["MaskDecoder", "PromptEncoder", "TwoWayTransformer"]

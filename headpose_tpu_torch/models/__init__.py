from .anchors import AnchorConfig, BACK_CONFIG, FRONT_CONFIG, generate_anchors
from .blazeface import (BLAZEFACE_BACK, BLAZEFACE_FRONT, TURBO_FAST_BLOCKS,
                        BlazeFace, BlazeFaceNet, turbo_fast_blocks)
from .heads import (EnsembleHead, EnsembleHeadNet, MLPHead, MLPHeadNet,
                    ResidualMLPHead, ResidualMLPHeadNet, SEMLPHead,
                    SEMLPHeadNet, SETransformerHead, SETransformerHeadNet,
                    SkipMLPHead, SkipMLPHeadNet, head_net)
from .unified import UnifiedPoseModel, UnifiedPoseNet, join_models

__all__ = ["AnchorConfig", "BACK_CONFIG", "FRONT_CONFIG", "generate_anchors",
           "BLAZEFACE_BACK", "BLAZEFACE_FRONT", "BlazeFace", "BlazeFaceNet",
           "TURBO_FAST_BLOCKS", "turbo_fast_blocks",
           "MLPHead", "MLPHeadNet", "ResidualMLPHead", "ResidualMLPHeadNet",
           "SkipMLPHead", "SkipMLPHeadNet", "SEMLPHead", "SEMLPHeadNet",
           "SETransformerHead", "SETransformerHeadNet", "EnsembleHead",
           "EnsembleHeadNet", "head_net", "UnifiedPoseModel",
           "UnifiedPoseNet", "join_models"]

from .anchors import AnchorConfig, BACK_CONFIG, FRONT_CONFIG, generate_anchors
from .blazeface import (BLAZEFACE_BACK, BLAZEFACE_FRONT, TURBO_FAST_BLOCKS,
                        BlazeFace, BlazeFaceNet, blazeface_from_h5,
                        turbo_fast_blocks)
from .heads import (HEAD_REGISTRY, EnsembleHead, EnsembleHeadNet, MLPHead,
                    MLPHeadNet, ResidualMLPHead, ResidualMLPHeadNet,
                    SEMLPHead, SEMLPHeadNet, SETransformerHead,
                    SETransformerHeadNet, SkipMLPHead, SkipMLPHeadNet,
                    head_from_h5, head_from_keras_json, head_net,
                    mlp_head_from_modeldef, se_transformer_from_h5)
from .unified import (UnifiedPoseModel, UnifiedPoseNet, join_models,
                      unified_from_h5)

__all__ = ["AnchorConfig", "BACK_CONFIG", "FRONT_CONFIG", "generate_anchors",
           "BLAZEFACE_BACK", "BLAZEFACE_FRONT", "BlazeFace", "BlazeFaceNet",
           "TURBO_FAST_BLOCKS", "turbo_fast_blocks",
           "MLPHead", "MLPHeadNet", "ResidualMLPHead", "ResidualMLPHeadNet",
           "SkipMLPHead", "SkipMLPHeadNet", "SEMLPHead", "SEMLPHeadNet",
           "SETransformerHead", "SETransformerHeadNet", "EnsembleHead",
           "EnsembleHeadNet", "head_net", "HEAD_REGISTRY",
           "head_from_h5", "head_from_keras_json", "se_transformer_from_h5",
           "mlp_head_from_modeldef", "blazeface_from_h5",
           "UnifiedPoseModel", "UnifiedPoseNet", "join_models",
           "unified_from_h5"]

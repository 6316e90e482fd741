from .anchors import AnchorConfig, BACK_CONFIG, FRONT_CONFIG, generate_anchors
from .blazeface import BLAZEFACE_BACK, BLAZEFACE_FRONT, BlazeFace, BlazeFaceNet
from .heads import MLPHead, MLPHeadNet
from .unified import UnifiedPoseModel, UnifiedPoseNet

__all__ = ["AnchorConfig", "BACK_CONFIG", "FRONT_CONFIG", "generate_anchors",
           "BLAZEFACE_BACK", "BLAZEFACE_FRONT", "BlazeFace", "BlazeFaceNet",
           "MLPHead", "MLPHeadNet", "UnifiedPoseModel", "UnifiedPoseNet"]

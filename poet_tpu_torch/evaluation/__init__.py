from poet_tpu_torch.evaluation.ply import load_ply  # noqa: F401
from poet_tpu_torch.evaluation.pose_evaluator import (  # noqa: F401
    PoseEvaluator,
    build_pose_evaluator,
)

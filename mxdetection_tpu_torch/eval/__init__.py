from .coco_eval import CocoEvaluator, format_table  # noqa: F401
from .evaluator import Evaluator, build_gt_list, paste_masks  # noqa: F401
from . import rle  # noqa: F401

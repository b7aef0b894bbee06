from .classifier import Classifier
from .evaluator import eval_single_batch, eval_single_dataset, evaluate
from .metrics import macro_f1, per_class_tally, topk_accuracy
from .zeroshot import class_embeddings, get_zeroshot_classifier

__all__ = ["Classifier", "class_embeddings", "eval_single_batch", "eval_single_dataset", "evaluate",
           "get_zeroshot_classifier", "macro_f1", "per_class_tally", "topk_accuracy"]

from .classifier import Classifier
from .metrics import macro_f1, topk_accuracy
from .zeroshot import class_embeddings, get_zeroshot_classifier

__all__ = ["Classifier", "class_embeddings", "get_zeroshot_classifier", "macro_f1", "topk_accuracy"]

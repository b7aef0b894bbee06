from .zeroshot import class_embeddings, get_zeroshot_classifier

__all__ = ["class_embeddings", "get_zeroshot_classifier"]

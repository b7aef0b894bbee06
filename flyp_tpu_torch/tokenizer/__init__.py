from .bpe import ClipTokenizer, get_tokenizer, shrink_context, tokenize

__all__ = ["ClipTokenizer", "get_tokenizer", "shrink_context", "tokenize"]

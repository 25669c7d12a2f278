from .embedding import embedding_bag, embedding_lookup, onehot_lookup

__all__ = ["embedding_bag", "embedding_lookup", "onehot_lookup"]

from .pipeline import GraphEpochStream, MaskedItemStream, TokenStream

__all__ = ["GraphEpochStream", "MaskedItemStream", "TokenStream"]

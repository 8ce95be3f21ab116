from .synthetic import Prefetcher, RequestStream, TokenStream

__all__ = ["TokenStream", "RequestStream", "Prefetcher"]

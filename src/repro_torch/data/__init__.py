from .synthetic import (GaussianClassImages, Prefetcher, RequestStream,
                        TokenStream)

__all__ = ["TokenStream", "RequestStream", "GaussianClassImages",
           "Prefetcher"]

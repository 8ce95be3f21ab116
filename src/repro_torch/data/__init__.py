from .synthetic import (GaussianClassImages, Prefetcher, RequestStream,
                        TokenStream, host_shard)

__all__ = ["TokenStream", "RequestStream", "GaussianClassImages",
           "Prefetcher", "host_shard"]

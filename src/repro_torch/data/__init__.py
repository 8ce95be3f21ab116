from .synthetic import RequestStream, TokenStream

__all__ = ["TokenStream", "RequestStream"]

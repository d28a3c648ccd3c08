"""Serving side of the port: the bucketed decision fast path
(``fastpath``) and the continuous-batching LM edge server (``batching``)."""

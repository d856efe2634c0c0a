from .kernel import wkv6_fill, wkv6_plain  # noqa: F401

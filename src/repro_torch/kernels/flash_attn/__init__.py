from .kernel import flash_attention_plain, flash_fill  # noqa: F401

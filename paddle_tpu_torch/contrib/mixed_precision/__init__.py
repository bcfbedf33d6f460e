from .decorator import AutoMixedPrecisionLists, decorate  # noqa: F401

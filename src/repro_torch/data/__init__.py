from .pipeline import DataConfig, ShardedLoader, make_loader  # noqa: F401

from .pipeline import Prefetcher, ShardedLoader
from .synthetic import SyntheticLM, make_batch_for

__all__ = ["SyntheticLM", "make_batch_for", "ShardedLoader", "Prefetcher"]

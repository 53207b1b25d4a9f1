"""Sharding: the plan that maps parameters, batches and caches onto a
mesh (:mod:`.plan`) and the data-parallel group a mesh step's
quantizers consult (:mod:`.data`)."""

from .data import DataGroup, use_data_group
from .plan import NamedSharding, ShardingPlan, make_plan

__all__ = ["ShardingPlan", "NamedSharding", "make_plan", "DataGroup",
           "use_data_group"]

"""Fault-tolerance runtime: preemption, stragglers, retries, elastic
meshes."""

from .fault_tolerance import (ElasticController, PreemptionHandler,
                              StragglerMonitor, retry)

__all__ = ["PreemptionHandler", "StragglerMonitor", "retry",
           "ElasticController"]

"""Resilience (port of `cpd_tpu.resilience`): the fault-plan grammar
with the ring's wire faults, and the ring -> faithful -> fp32 transport
ladder of the verified reduce.  The guard, sentinel, watchdog, loop,
precision and elastic modules are not ported yet (ROADMAP Queue A,
A10)."""

from .inject import (ELASTIC_KINDS, WIRE_KINDS, FaultPlan, FaultSpec,
                     not_ported_kinds, report_unfired)
from .transport import StepTable, TransportSupervisor, level_reduce_kwargs

__all__ = ["FaultPlan", "FaultSpec", "WIRE_KINDS", "ELASTIC_KINDS",
           "not_ported_kinds", "report_unfired", "StepTable",
           "TransportSupervisor", "level_reduce_kwargs"]

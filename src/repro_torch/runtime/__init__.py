"""Serving runtime: KV pool, scheduler, executors, engine, one-shot server."""
from repro_torch.runtime.engine import (EngineConfig, EngineReport,
                                        EngineRequest, RAPEngine,
                                        RequestResult)
from repro_torch.runtime.executor import (LocalExecutor, ModelExecutor,
                                          PagedExecutor, PagedGroup,
                                          SlotGroup, chunk_widths)
from repro_torch.runtime.kv_pool import (KVPool, PageAllocation,
                                         PoolExhausted, TokenAllocation)
from repro_torch.runtime.scheduler import (SCHEDULERS, FIFOScheduler,
                                           PriorityScheduler, Scheduler,
                                           SchedulerOutput, SJFScheduler,
                                           make_scheduler)
from repro_torch.runtime.server import RAPServer, ServeResult

__all__ = ["RAPEngine", "EngineConfig", "EngineRequest", "EngineReport",
           "RequestResult", "KVPool", "PageAllocation", "TokenAllocation",
           "PoolExhausted", "Scheduler", "SchedulerOutput", "FIFOScheduler",
           "SJFScheduler", "PriorityScheduler", "SCHEDULERS",
           "make_scheduler", "ModelExecutor", "LocalExecutor", "SlotGroup",
           "PagedExecutor", "PagedGroup", "RAPServer", "ServeResult",
           "chunk_widths"]

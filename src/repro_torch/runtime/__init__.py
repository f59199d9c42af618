"""Serving runtime: KV page pool, scheduler, executor, engine."""
from repro_torch.runtime.engine import (EngineConfig, EngineReport,
                                        EngineRequest, RAPEngine,
                                        RequestResult)
from repro_torch.runtime.executor import (ModelExecutor, PagedExecutor,
                                          PagedGroup, chunk_widths)
from repro_torch.runtime.kv_pool import (KVPool, PoolExhausted,
                                         TokenAllocation)
from repro_torch.runtime.scheduler import (SCHEDULERS, FIFOScheduler,
                                           PriorityScheduler, Scheduler,
                                           SchedulerOutput, SJFScheduler,
                                           make_scheduler)

__all__ = ["RAPEngine", "EngineConfig", "EngineRequest", "EngineReport",
           "RequestResult", "KVPool", "TokenAllocation",
           "PoolExhausted", "Scheduler", "SchedulerOutput", "FIFOScheduler",
           "SJFScheduler", "PriorityScheduler", "SCHEDULERS",
           "make_scheduler", "ModelExecutor", "PagedExecutor", "PagedGroup",
           "chunk_widths"]

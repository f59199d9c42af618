"""Serving runtime: KV pool, scheduler, executors (local, paged, sharded on
a mesh), engine, one-shot server, fault-injection scenarios; the step
functions and the trainer."""
from repro_torch.runtime import scenarios, steps
from repro_torch.runtime.engine import (EngineConfig, EngineReport,
                                        EngineRequest, RAPEngine,
                                        RequestResult)
from repro_torch.runtime.executor import (LocalExecutor, ModelExecutor,
                                          PagedExecutor, PagedGroup,
                                          ShardedExecutor, ShardedSlotGroup,
                                          SlotGroup, chunk_widths)
from repro_torch.runtime.kv_pool import (KVPool, PageAllocation,
                                         PoolExhausted, SpilledAllocation,
                                         TokenAllocation)
from repro_torch.runtime.scenarios import (TickStaircase,
                                           heavy_tailed_requests,
                                           run_budget_shock,
                                           run_cancellation_storm,
                                           staircase_trace, token_agreement,
                                           workload_budget_trace)
from repro_torch.runtime.scheduler import (SCHEDULERS, FIFOScheduler,
                                           PriorityScheduler, Scheduler,
                                           SchedulerOutput, SJFScheduler,
                                           VictimCandidate, make_scheduler)
from repro_torch.runtime.server import RAPServer, ServeResult
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["steps", "Trainer", "TrainerConfig", "RAPEngine", "EngineConfig", "EngineRequest", "EngineReport",
           "RequestResult", "KVPool", "PageAllocation", "TokenAllocation",
           "SpilledAllocation", "PoolExhausted", "Scheduler",
           "SchedulerOutput", "FIFOScheduler", "SJFScheduler",
           "PriorityScheduler", "VictimCandidate", "SCHEDULERS",
           "make_scheduler", "ModelExecutor", "LocalExecutor", "SlotGroup",
           "PagedExecutor", "PagedGroup", "ShardedExecutor",
           "ShardedSlotGroup", "RAPServer", "ServeResult",
           "chunk_widths", "scenarios", "TickStaircase", "staircase_trace",
           "workload_budget_trace", "heavy_tailed_requests",
           "run_budget_shock", "run_cancellation_storm", "token_agreement"]

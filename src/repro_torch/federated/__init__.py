"""Federated fine-tuning of the port: the clients' local rounds, the
server, the batched cohort engine, the algorithms, the virtual-clock
scheduler, the experiment runner and the system model."""
from repro_torch.federated.algorithms import FederatedAlgorithm, get_algorithm, register, registered_methods
from repro_torch.federated.engine import CohortEngine
from repro_torch.federated.runner import ExperimentRunner, SimResult, run_replicates
from repro_torch.federated.scheduler import (
    ScheduleConfig,
    VirtualClockScheduler,
    feasible_rate_floor,
    resolve_schedule,
)
from repro_torch.federated.simulator import METHODS, FederatedSimulator, Strategy
from repro_torch.federated.state import CohortResults, RoundPlan, RoundState
from repro_torch.federated.system_model import DEVICE_PROFILES, RoundCost, SystemModel

__all__ = [
    "DEVICE_PROFILES",
    "RoundCost",
    "SystemModel",
    "FederatedAlgorithm",
    "register",
    "get_algorithm",
    "registered_methods",
    "CohortEngine",
    "ExperimentRunner",
    "ScheduleConfig",
    "VirtualClockScheduler",
    "feasible_rate_floor",
    "resolve_schedule",
    "run_replicates",
    "SimResult",
    "RoundState",
    "RoundPlan",
    "CohortResults",
    "FederatedSimulator",
    "Strategy",
    "METHODS",
]
